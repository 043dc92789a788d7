"""K5: the fused spatial-attention block, NHWC.

Replaces ``gddim_tpu/ops/attnblock.py:fused_attnblock`` (``_attnblock_kernel``):

    h = GroupNorm(x)
    q, k, v = NIN_0(h), NIN_1(h), NIN_2(h)
    a = softmax(q k^T / sqrt(C)) v
    out = (x + NIN_3(a)) * 1/sqrt(2)      (the 1/sqrt(2) with skip_rescale)

On the card the block is four hand-written launches: GN statistics and the
q/k/v projection (one N = 3C product with the GN affine as its prologue) from
``csrc/resblock.cu``, the attention core from ``csrc/attnblock.cu``, and the
output projection with the residual and 1/sqrt(2) in its epilogue. See the
two sources for what bounds each on the H100. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernels or raises,
and, having no backward, raises when autograd would need one (the training
path runs its attention through K1 and K8 instead, ``models/blocks.py``).
"""

from __future__ import annotations

import functools

import torch

from gddim_torch import _build
from gddim_torch.ops.attention import attention_xla
from gddim_torch.ops.groupnorm import group_norm_silu_reference
from gddim_torch.ops.resblock import _operand, require_no_grad, split_k

_INV_SQRT2 = 0.7071067811865476


def attnblock_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                        num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """Plain version: the unfused composition (gddim_tpu/ops/attnblock.py:257)."""
    b, h, w, c = x.shape
    hn = group_norm_silu_reference(x, gn_scale, gn_bias, num_groups, eps, apply_silu=False)
    flat = hn.reshape(b, h * w, c)
    dt = flat.dtype
    q = flat @ wq.to(dt) + bq.to(dt)
    k = flat @ wk.to(dt) + bk.to(dt)
    v = flat @ wv.to(dt) + bv.to(dt)
    a = attention_xla(q, k, v)
    o = a @ wo.to(dt) + bo.to(dt)
    out = x + o.reshape(b, h, w, c)
    return out * _INV_SQRT2 if skip_rescale else out


@functools.lru_cache(maxsize=None)
def _plan(b: int, s: int, c: int):
    """(splits, kper) of the q/k/v and output GEMMs, and the workspace bytes."""
    s1, k1 = split_k(b * s, 3 * c, c)
    s2, k2 = split_k(b * s, c, c)
    return s1, k1, s2, k2, _build.workspace_bytes("gddim_attnblock", b, s, c, max(s1, s2))


def fused_attnblock(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                    num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K5. x: (B, H, W, C); NIN weights (C, C) with (C,) biases."""
    if x.device.type == "cpu":
        return attnblock_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                   num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attnblock: unsupported device {x.device}")
    require_no_grad("fused_attnblock", x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    b, h, w, c = x.shape
    s = h * w
    if s % 16 or s > 256 or c > 256 or c % 64:
        raise ValueError(f"fused_attnblock: unsupported shape {tuple(x.shape)}")
    bf16, f32 = torch.bfloat16, torch.float32
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "attnblock input", bf16), _operand(gn_scale, "gn scale", f32, (c,)),
        _operand(gn_bias, "gn bias", f32, (c,)),
        _operand(torch.cat([wq, wk, wv], 1), "wqkv", bf16, (c, 3 * c)),
        _operand(torch.cat([bq, bk, bv]), "bqkv", f32, (3 * c,)),
        _operand(wo, "wo", bf16, (c, c)), _operand(bo, "bo", f32, (c,)),
    ]
    x_, gs, gb, wqkv, bqkv, wo_, bo_ = map(_build.ptr, ops)
    s1, k1, s2, k2, nbytes = _plan(b, s, c)
    work = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    out = torch.empty((b, h, w, c), device=x.device, dtype=bf16)
    _build.launch(
        "gddim_attnblock", x.device, x_, gs, gb, num_groups, wqkv, bqkv, wo_, bo_,
        b, s, c, eps, _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(),
        s1, k1, s2, k2, out.data_ptr(),
    )
    fused_attnblock.launches += 1
    return out


fused_attnblock.launches = 0  # block launches on CUDA tensors (one gddim_attnblock each)
