"""K7: the fused backward of one training residual block, NHWC.

Replaces ``gddim_tpu/ops/resblock_bwd.py:fused_resblock_train_grads``: all 12
gradients of ``resblock_train_reference`` (x, temb_proj, GN1 scale/bias, W1,
b1, GN2 scale/bias, W2, b2, W_skip, b_skip) from the block's inputs, the
dropout mask and the output cotangent, recomputing the interior from x.

The CUDA implementation is ``csrc/resblock_bwd.cu`` (its header lists the
launches and what bounds them on the H100). The wrapper repacks the conv
weights for the dgrads (taps flipped, Cin and Cout swapped) and W_skip
transposed, all in bf16; the gradients come out f32. On a CPU tensor the
wrapper runs the plain version, autograd of the plain block; on a CUDA tensor
it launches the kernels or raises.
"""

from __future__ import annotations

import functools

import torch

from gddim_torch import _build
from gddim_torch.ops.resblock import _BN, _INV_SQRT2, _on_cpu, _operand, resblock_train_reference


def resblock_train_grads_reference(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                                   gn2_bias, w2, b2, w_skip, b_skip, mask, g, **cfg):
    """Plain version: autograd of resblock_train_reference. Returns the 12
    gradients, None for W_skip/b_skip without a skip."""
    primals = [x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip,
               b_skip]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True) for t in primals]
        out = resblock_train_reference(*leaves, mask, **cfg)
        present = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, present, g))
    return tuple(None if t is None else next(grads) for t in leaves)


@functools.lru_cache(maxsize=None)
def _workspace(b: int, h: int, w: int, cin: int, n: int, g1: int, g2: int) -> int:
    return _build.workspace_bytes("gddim_resblock_bwd", b, h, w, cin, n, g1, g2)


def _dgrad_weight(w):
    """(3, 3, Cin, Cout) -> the dgrad conv's (3, 3, Cout, Cin): taps flipped."""
    return w.flip(0, 1).transpose(2, 3)


def _grads_cuda(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip,
                b_skip, mask, g, *, keep_prob, num_groups1, num_groups2, eps, skip_rescale):
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, w, cin = x.shape
    n = w1.shape[-1]
    if cin % _BN or n % _BN or (w_skip is None and cin != n):
        raise ValueError(f"fused_resblock_train_grads: unsupported channels {cin} -> {n}")
    drop = keep_prob < 1.0
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "x", f32, (b, h, w, cin)), _operand(temb_proj, "temb_proj", f32, (b, n)),
        _operand(gn1_scale, "gn1 scale", f32, (cin,)), _operand(gn1_bias, "gn1 bias", f32, (cin,)),
        _operand(w1, "conv1", bf16, (3, 3, cin, n)),
        _operand(_dgrad_weight(w1), "conv1 dgrad", bf16, (3, 3, n, cin)),
        _operand(b1, "b1", f32, (n,)),
        _operand(gn2_scale, "gn2 scale", f32, (n,)), _operand(gn2_bias, "gn2 bias", f32, (n,)),
        _operand(_dgrad_weight(w2), "conv2 dgrad", bf16, (3, 3, n, n)),
        None if w_skip is None else _operand(w_skip.t(), "skip dgrad", bf16, (n, cin)),
        _operand(mask, "mask", torch.int8, (b, h, w, n)) if drop else None,
        _operand(g, "cotangent", f32, (b, h, w, n)),
    ]
    dev = x.device
    dx = torch.empty((b, h, w, cin), device=dev, dtype=f32)
    dtemb = torch.empty((b, n), device=dev, dtype=f32)
    dgn1s, dgn1b = (torch.empty(cin, device=dev, dtype=f32) for _ in range(2))
    dw1 = torch.empty((3, 3, cin, n), device=dev, dtype=f32)
    db1, dgn2s, dgn2b, db2 = (torch.empty(n, device=dev, dtype=f32) for _ in range(4))
    dw2 = torch.empty((3, 3, n, n), device=dev, dtype=f32)
    dws = None if w_skip is None else torch.empty((cin, n), device=dev, dtype=f32)
    dbs = None if w_skip is None else torch.empty(n, device=dev, dtype=f32)
    outs = [dx, dtemb, dgn1s, dgn1b, dw1, db1, dgn2s, dgn2b, dw2, db2, dws, dbs]
    work = torch.empty(_workspace(b, h, w, cin, n, num_groups1, num_groups2), device=dev,
                       dtype=torch.uint8)
    x_, t_, g1s, g1b, w1_, w1t, b1_, g2s, g2b, w2t, wst, m_, g_ = map(_build.ptr, ops)
    _build.launch(
        "gddim_resblock_bwd", dev, x_, t_, g1s, g1b, num_groups1, w1_, w1t, b1_, g2s, g2b,
        num_groups2, w2t, wst, m_, 1.0 / keep_prob if drop else 1.0, g_, b, h, w, cin, n, eps,
        _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(), *map(_build.ptr, outs),
    )
    fused_resblock_train_grads.launches += 1
    return tuple(outs)


def fused_resblock_train_grads(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
                               w2, b2, w_skip, b_skip, mask, g, *, keep_prob: float,
                               num_groups1: int, num_groups2: int, eps: float = 1e-6,
                               skip_rescale: bool = True):
    """K7: (dx, dtemb_proj, dgn1_scale, dgn1_bias, dw1, db1, dgn2_scale,
    dgn2_bias, dw2, db2, dw_skip, db_skip) of resblock_train_reference at
    these inputs for the output cotangent g; dw_skip and db_skip are None
    without a skip. f32 on the card."""
    cfg = dict(keep_prob=keep_prob, num_groups1=num_groups1, num_groups2=num_groups2, eps=eps,
               skip_rescale=skip_rescale)
    args = (x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip,
            b_skip, mask, g)
    if _on_cpu(x, "fused_resblock_train_grads"):
        return resblock_train_grads_reference(*args, **cfg)
    return _grads_cuda(*args, **cfg)


fused_resblock_train_grads.launches = 0  # one gddim_resblock_bwd each
