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

``fused_attnblock_int8`` is K5's int8 mode (``mm_dtype=jnp.int8``): h = GN(x)
in f32 quantized to int8 (static scale s_h, or per sample), the q/k/v and
output projections as int8 products dequantized per output channel, the
attention products in bf16 on the dequantized q, k, v with an f32 softmax,
and the attention output a quantized from f32 (s_a, or per sample). On the
card the q/k/v and output GEMMs are the int8 conv GEMM of ``resblock.cu``
and the attention core writes a in f32 for the output projection's prologue.
"""

from __future__ import annotations

import functools

import torch

from gddim_torch import _build
from gddim_torch.ops.attention import attention_xla
from gddim_torch.ops.groupnorm import group_norm_silu_reference
from gddim_torch.ops.resblock import (
    _operand,
    activation_dtype,
    check_act_scales,
    group_norm_tpu,
    int8_matmul_exact,
    quant_dynamic,
    quant_static,
    require_no_grad,
    split_k,
)

_INV_SQRT2 = 0.7071067811865476


def attnblock_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                        num_groups: int, eps: float = 1e-6, skip_rescale: bool = False,
                        sow=None):
    """Plain version: the unfused composition (gddim_tpu/ops/attnblock.py:257).
    sow(site, tensor), if given, sees the int8 quantization sites "h" (the
    q/k/v input) and "a" (the output projection's input), as the JAX
    package's calibration records them (``gddim_tpu/models/blocks.py:135-143``)."""
    b, h, w, c = x.shape
    hn = group_norm_silu_reference(x, gn_scale, gn_bias, num_groups, eps, apply_silu=False)
    if sow is not None:
        sow("h", hn)
    flat = hn.reshape(b, h * w, c)
    dt = flat.dtype
    q = flat @ wq.to(dt) + bq.to(dt)
    k = flat @ wk.to(dt) + bk.to(dt)
    v = flat @ wv.to(dt) + bv.to(dt)
    a = attention_xla(q, k, v)
    if sow is not None:
        sow("a", a)
    o = a @ wo.to(dt) + bo.to(dt)
    out = x + o.reshape(b, h, w, c)
    return out * _INV_SQRT2 if skip_rescale else out


def attnblock_int8_reference(x, gn_scale, gn_bias, wqkv, bqkv, wo, bo, act_scales=None, *,
                             num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """Plain version of K5's int8 mode (``_attnblock_kernel``, attnblock.py:47-163).
    wqkv: (int8 (C, 3C), scales (3C,)) of [Wq | Wk | Wv], which
    quantize_weight makes column by column, so it equals the three quantized
    apart; bqkv (3C,); wo: (int8 (C, C), scales); act_scales None (per
    sample) or [s_h, s_a]."""
    check_act_scales(act_scales)
    b, h, w, c = x.shape
    (wq, ws), (woq, wos) = wqkv, wo
    hn = group_norm_tpu(x.float(), gn_scale, gn_bias, num_groups, eps, False,
                        fold=act_scales is not None).reshape(b, h * w, c)
    if act_scales is not None:
        s_h, s_a = act_scales.float()
        qh, dq = quant_static(hn, s_h), ws * s_h
    else:
        qh, sb = quant_dynamic(hn)
        dq = sb * ws
    qkv = int8_matmul_exact(qh, wq) * dq + bqkv.float()
    q, k, v = qkv.to(torch.bfloat16).split(c, dim=-1)
    logits = (q.float() @ k.float().transpose(1, 2)) * c ** (-0.5)
    a = torch.softmax(logits, dim=-1).to(torch.bfloat16).float() @ v.float()
    if act_scales is not None:
        qa, dq = quant_static(a, s_a), wos * s_a
    else:
        qa, sb = quant_dynamic(a)
        dq = sb * wos
    out = x.float().reshape(b, h * w, c) + (int8_matmul_exact(qa, woq) * dq + bo.float())
    out = out * _INV_SQRT2 if skip_rescale else out
    return out.reshape(b, h, w, c).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _plan(entry: str, b: int, s: int, c: int):
    """(splits, kper) of the q/k/v and output GEMMs, and the workspace bytes
    of ``entry`` (gddim_attnblock or gddim_attnblock_int8)."""
    s1, k1 = split_k(b * s, 3 * c, c)
    s2, k2 = split_k(b * s, c, c)
    return s1, k1, s2, k2, _build.workspace_bytes(entry, b, s, c, max(s1, s2))


def supported(x_shape) -> bool:
    """The shapes the kernels take: S = H*W a multiple of 16 up to 256 (the
    attention core keeps a tile's scores in shared memory), C a multiple of
    64 up to 256."""
    _, h, w, c = x_shape
    s = h * w
    return s % 16 == 0 and s <= 256 and c % 64 == 0 and c <= 256


def _check(x, what):
    """(B, S, C) of a CUDA input the kernels take."""
    b, h, w, c = x.shape
    if not supported(x.shape):
        raise ValueError(f"{what}: unsupported shape {tuple(x.shape)}")
    return b, h * w, c


def _attnblock_cuda(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *, num_groups, eps,
                    skip_rescale):
    """K5 through gddim_attnblock: x bf16 or f32, out in x's dtype."""
    b, s, c = _check(x, "fused_attnblock")
    act = activation_dtype(x, "fused_attnblock", int8=False)
    bf16, f32 = torch.bfloat16, torch.float32
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "attnblock input", act), _operand(gn_scale, "gn scale", f32, (c,)),
        _operand(gn_bias, "gn bias", f32, (c,)),
        _operand(torch.cat([wq, wk, wv], 1), "wqkv", bf16, (c, 3 * c)),
        _operand(torch.cat([bq, bk, bv]), "bqkv", f32, (3 * c,)),
        _operand(wo, "wo", bf16, (c, c)), _operand(bo, "bo", f32, (c,)),
    ]
    x_, gs, gb, wqkv, bqkv, wo_, bo_ = map(_build.ptr, ops)
    s1, k1, s2, k2, nbytes = _plan("gddim_attnblock", b, s, c)
    work = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    out = torch.empty(x.shape, device=x.device, dtype=act)
    _build.launch(
        "gddim_attnblock", x.device, x_, gs, gb, num_groups, wqkv, bqkv, wo_, bo_,
        b, s, c, eps, _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(),
        s1, k1, s2, k2, out.data_ptr(), int(act == f32),
    )
    return out


def fused_attnblock(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                    num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K5. x: (B, H, W, C) bf16 or f32, out in x's dtype; NIN weights (C, C)
    with (C,) biases."""
    kw = dict(num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    if x.device.type == "cpu":
        return attnblock_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attnblock: unsupported device {x.device}")
    require_no_grad("fused_attnblock", x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    out = _attnblock_cuda(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, **kw)
    fused_attnblock.launches += 1
    return out


def fused_attnblock_int8(x, gn_scale, gn_bias, wqkv, bqkv, wo, bo, act_scales=None, *,
                         num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K5's int8 mode (see attnblock_int8_reference for the arguments)."""
    if x.device.type == "cpu":
        return attnblock_int8_reference(x, gn_scale, gn_bias, wqkv, bqkv, wo, bo, act_scales,
                                        num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attnblock_int8: unsupported device {x.device}")
    require_no_grad("fused_attnblock_int8", x, gn_scale, gn_bias, *wqkv, bqkv, *wo, bo)
    check_act_scales(act_scales)
    b, s, c = _check(x, "fused_attnblock_int8")
    bf16 = activation_dtype(x, "fused_attnblock_int8", int8=True)
    f32 = torch.float32
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "attnblock input", bf16), _operand(gn_scale, "gn scale", f32, (c,)),
        _operand(gn_bias, "gn bias", f32, (c,)),
        _operand(wqkv[0], "wqkv", torch.int8, (c, 3 * c)),
        _operand(wqkv[1], "wqkv scales", f32, (3 * c,)), _operand(bqkv, "bqkv", f32, (3 * c,)),
        _operand(wo[0], "wo", torch.int8, (c, c)), _operand(wo[1], "wo scales", f32, (c,)),
        _operand(bo, "bo", f32, (c,)), _operand(act_scales, "act scales", f32, (2,)),
    ]
    x_, gs, gb, wqkv_, wqkvs, bqkv_, wo_, wos, bo_, qs = map(_build.ptr, ops)
    s1, k1, s2, k2, nbytes = _plan("gddim_attnblock_int8", b, s, c)
    work = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    out = torch.empty(x.shape, device=x.device, dtype=bf16)
    _build.launch(
        "gddim_attnblock_int8", x.device, x_, gs, gb, num_groups, wqkv_, wqkvs, bqkv_, wo_, wos,
        bo_, qs, b, s, c, eps, _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(),
        s1, k1, s2, k2, out.data_ptr(),
    )
    fused_attnblock_int8.launches += 1
    return out


class _AttnblockTrain(torch.autograd.Function):
    """K10: K5's forward (the plain version on a CPU tensor); backward by
    autograd of the plain composition recomputed from the saved inputs
    (``make_fused_attnblock_train``'s custom_vjp), so the gradients are the
    unfused path's and only the forward value carries K5's bf16 rounding."""

    @staticmethod
    def forward(ctx, cfg, *args):
        ctx.save_for_backward(*args)
        ctx.cfg = cfg
        if args[0].device.type == "cpu":
            return attnblock_reference(*args, **cfg)
        out = _attnblock_cuda(*args, **cfg)
        fused_attnblock_train.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(need) for t, need in
                    zip(saved, ctx.needs_input_grad[1:])]
            out = attnblock_reference(*args, **ctx.cfg)
            wanted = [a for a in args if a.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (None, *(next(got) if a.requires_grad else None for a in args))


def fused_attnblock_train(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                          num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K10: one differentiable attention block of a training step
    (``make_fused_attnblock_train``): K5 on the f32 activations in the
    forward, the VJP of ``attnblock_reference`` in the backward; the plain
    version both ways on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attnblock_train: unsupported device {x.device}")
    cfg = dict(num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    return _AttnblockTrain.apply(cfg, x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo)


fused_attnblock.launches = 0  # block launches on CUDA tensors (one gddim_attnblock each)
fused_attnblock_int8.launches = 0  # one gddim_attnblock_int8 each
fused_attnblock_train.launches = 0  # K10 forwards (one gddim_attnblock each)
