"""K5: the fused spatial-attention block, NHWC.

Replaces ``gddim_tpu/ops/attnblock.py:fused_attnblock`` (``_attnblock_kernel``):

    h = GroupNorm(x)
    q, k, v = NIN_0(h), NIN_1(h), NIN_2(h)
    a = softmax(q k^T / sqrt(C)) v
    out = (x + NIN_3(a)) * 1/sqrt(2)      (the 1/sqrt(2) with skip_rescale)

On the card (``csrc/attnblock.cu``, see its header for what bounds each part
on the H100) the bf16 block is five hand-written launches: GN statistics,
the bf16 pre-pass h = bf16(GN(x)), the q/k/v projection as one N = 3C 1x1
GEMM on the block GEMM (``csrc/block_gemm.cu``, wgmma fed by TMA), the
attention core (``attention_core``: wgmma fed by TMA, the score rows and
the softmax on chip in the TPU kernel's order and rounding points), and the
output projection on the block GEMM with + bo, + x and 1/sqrt(2) in its
epilogue. ``attnblock_bf16_reference`` is its plain version with the TPU
kernel's rounding points. Their tile plans are ``block_plan``, their
scratch ``workspace_bytes``. On f32 activations (K10's forward, K5 called
on f32 x) the same launches read f32 x (GN statistics, then the bf16
pre-pass) and write f32 out (the output projection's epilogue adds the f32
residual), under the same plans. On a CPU tensor each wrapper runs its plain version; on
a CUDA tensor it launches the kernels or raises, and, having no backward,
raises when autograd would need one (K10, ``fused_attnblock_train``, is the
differentiable form).

``fused_attnblock`` keeps the JAX signature and packs the weights on each
call; the model packs them once per block (``pack_attn_weights``) and calls
``fused_attnblock_packed``.

``fused_attnblock_int8`` is K5's int8 mode (``mm_dtype=jnp.int8``): h = GN(x)
in f32 quantized to int8 (static scale s_h, or per sample), the q/k/v and
output projections as int8 products dequantized per output channel, the
attention products in bf16 on the dequantized q, k, v with an f32 softmax,
and the attention output a quantized from f32 (s_a, or per sample). On the
card both projections run the int8 block GEMM, which reads the weights
K-major (``pack_projection``); the core writes a in int8 with static
scales, or in f32 with each sample's amax for a quantize pre-pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gddim_torch import _build
from gddim_torch.ops.attention import attention_xla, self_attention_2d
from gddim_torch.ops.groupnorm import group_norm_silu_reference
from gddim_torch.ops.resblock import (
    BF16_SLICE,
    S8_SLICE,
    SMS,
    GemmPlan,
    _bf16r,
    _gemm_takes,
    _on_cpu,
    _operand,
    activation_dtype,
    bf16_tile_plan,
    gn_apply_ctas,
    group_norm_tpu,
    int8_matmul_exact,
    quant_dynamic,
    quant_static,
    require_no_grad,
    s8_tile_plan,
)

_INV_SQRT2 = 0.7071067811865476


class AttnWeights(NamedTuple):
    """K5's operands as its kernels take them: [Wq|Wk|Wv] (C, 3C) and Wo (C,
    C) bf16, [bq|bk|bv] (3C,) and bo (C,) f32."""

    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor


def pack_attn_weights(wq, bq, wk, bk, wv, bv, wo, bo) -> AttnWeights:
    """The NIN weights (C, C) and biases (C,) as ``AttnWeights``."""
    bf16, f32 = torch.bfloat16, torch.float32
    return AttnWeights(torch.cat([wq, wk, wv], 1).to(bf16).contiguous(),
                       torch.cat([bq, bk, bv]).to(f32).contiguous(),
                       wo.to(bf16).contiguous(), bo.to(f32).contiguous())


def unpack_attn_weights(w: AttnWeights):
    """(wq, bq, wk, bk, wv, bv, wo, bo) of ``AttnWeights``."""
    wq, wk, wv = w.wqkv.chunk(3, 1)
    bq, bk, bv = w.bqkv.chunk(3)
    return wq, bq, wk, bk, wv, bv, w.wo, w.bo


class KMajorInt8(NamedTuple):
    """A 1x1 projection's int8 weights packed K-major, (N, C): row n holds
    output channel n's weights, as the int8 block GEMM reads them (8-bit
    wgmma takes its B operand K-major only); and their (N,) scales."""

    q: torch.Tensor
    scale: torch.Tensor


def pack_projection(w) -> KMajorInt8:
    """(int8 (C, N), scale) of ``quantize_weight`` -> ``KMajorInt8`` ((N, C),
    scale); one packed already is returned as it is."""
    if isinstance(w, KMajorInt8):
        return w
    q, scale = w
    return KMajorInt8(q.t().contiguous(), scale)


def unpack_projection(w):
    """(int8 (C, N), scale) of a projection's weights in either layout."""
    return (w.q.t(), w.scale) if isinstance(w, KMajorInt8) else tuple(w)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def attnblock_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                        num_groups: int, eps: float = 1e-6, skip_rescale: bool = False,
                        sow=None, attention_impl: str = "xla"):
    """Plain version: the unfused composition (gddim_tpu/ops/attnblock.py:257).
    sow(site, tensor), if given, sees the int8 quantization sites "h" (the
    q/k/v input) and "a" (the output projection's input), as the JAX
    package's calibration records them (``gddim_tpu/models/blocks.py:135-143``).
    attention_impl: the attention core, as ``self_attention_2d`` takes it
    ('auto' and 'xla': the plain version)."""
    b, h, w, c = x.shape
    hn = group_norm_silu_reference(x, gn_scale, gn_bias, num_groups, eps, apply_silu=False)
    if sow is not None:
        sow("h", hn)
    flat = hn.reshape(b, h * w, c)
    dt = flat.dtype
    q = flat @ wq.to(dt) + bq.to(dt)
    k = flat @ wk.to(dt) + bk.to(dt)
    v = flat @ wv.to(dt) + bv.to(dt)
    a = self_attention_2d(*(t.reshape(b, h, w, c) for t in (q, k, v)), impl=attention_impl,
                          fused=False).reshape(b, h * w, c)
    if sow is not None:
        sow("a", a)
    o = a @ wo.to(dt) + bo.to(dt)
    out = x + o.reshape(b, h, w, c)
    return out * _INV_SQRT2 if skip_rescale else out


def _softmax_v(q, k, v):
    """softmax(q k^T / sqrt(C)) v of f32 (B, S, C) in the TPU kernel's order
    (attnblock.py:123-134): logits * C^-1/2, minus the row max, exp, divided
    by the row sum, then p rounded to bf16; the product's f32 sums."""
    logits = (q @ k.transpose(1, 2)) * q.shape[-1] ** (-0.5)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return _bf16r(p / p.sum(-1, keepdim=True)) @ v


def attnblock_bf16_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                             num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K5's bf16 mode with the TPU kernel's rounding points
    (``_attnblock_kernel``, mm_dtype bf16), in f32 otherwise: GN statistics
    E[x^2] - mean^2 and the folded affine, h rounded to bf16; q, k, v = the
    f32 sums + bias, rounded to bf16; p rounded to bf16 after the
    normalisation; a rounded to bf16; out = x + a @ Wo + bo (f32), in x's
    dtype."""
    b, hh, ww, c = x.shape
    hn = _bf16r(group_norm_tpu(x.float(), gn_scale, gn_bias, num_groups, eps, False, True))
    hn = hn.reshape(b, hh * ww, c)
    q, k, v = (_bf16r(hn @ _bf16r(wt.float()) + bt.float())
               for wt, bt in ((wq, bq), (wk, bk), (wv, bv)))
    a = _bf16r(_softmax_v(q, k, v))
    out = x.float().reshape(b, hh * ww, c) + a @ _bf16r(wo.float()) + bo.float()
    out = out * _INV_SQRT2 if skip_rescale else out
    return out.reshape(x.shape).to(x.dtype)


def check_attn_scales(act_scales) -> None:
    """K5's act_scales: None (per sample) or the two static scales [s_h, s_a]."""
    if act_scales is not None and act_scales.numel() != 2:
        raise ValueError(f"K5 int8 takes 2 static activation scales (s_h, s_a), got "
                         f"{act_scales.numel()}")


def attnblock_int8_reference(x, gn_scale, gn_bias, wqkv, bqkv, wo, bo, act_scales=None, *,
                             num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """Plain version of K5's int8 mode (``_attnblock_kernel``, attnblock.py:47-163).
    wqkv: (int8 (C, 3C), scales (3C,)) of [Wq | Wk | Wv], which
    quantize_weight makes column by column, so it equals the three quantized
    apart; bqkv (3C,); wo: (int8 (C, C), scales); either may be packed
    K-major (``KMajorInt8``); act_scales None (per sample) or [s_h, s_a]."""
    check_attn_scales(act_scales)
    b, h, w, c = x.shape
    (wq, ws), (woq, wos) = unpack_projection(wqkv), unpack_projection(wo)
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


def attention_core_reference(qkv, *, mode: str = "bf16", act_scale=None):
    """Plain version of the attention core on qkv (B, S, 3C) bf16: a (B, S,
    C) of ``_softmax_v`` on its q, k, v, as ``mode`` writes it: "bf16",
    "int8" (clip(round(a * (1/s_a))) by ``act_scale``), or "f32" (a and
    each sample's max |a|, (B,))."""
    q, k, v = qkv.float().chunk(3, -1)
    a = _softmax_v(q, k, v)
    if mode == "bf16":
        return a.to(torch.bfloat16)
    if mode == "int8":
        return quant_static(a, act_scale.float().reshape(())).to(torch.int8)
    return a, a.abs().amax(dim=(1, 2))


# --------------------------------------------------------------------------
# Plans and scratch (pure functions of the shapes)
# --------------------------------------------------------------------------

CORE_MODES = {"bf16": 0, "int8": 1, "f32": 2}


def core_supported(s: int, c: int) -> bool:
    """The shapes the attention core takes: S a multiple of 64 up to 256,
    or 16 or 32 (64 / S samples share a warpgroup's 64 rows); C a multiple
    of 64 up to 256."""
    return (s in (16, 32) or (s % 64 == 0 and 0 < s <= 256)) and c % 64 == 0 and 0 < c <= 256


def core_plan(b: int, s: int) -> int:
    """The depth of the core's ring of 64-key slices (its CTAs take 64
    query rows each): 2, with two CTAs an SM, where the grid makes a wave
    of at least 128 CTAs, so that one CTA's softmax overlaps the other's
    products; else 4, one CTA an SM with a sample's K in flight at once
    (S < 64 always: its CTA holds 64 / S samples). PERF.md gives both
    depths' times at B=64."""
    return 2 if s >= 64 and -(-b * s // 64) >= SMS - 4 else 4


class AttnPlan(NamedTuple):
    """How the card runs one K5 block: the q/k/v projection's and the
    output projection's tile plans on the block GEMM (1x1, ``taps`` 1), and
    the depth of the core's ring."""

    qkv: GemmPlan
    out: GemmPlan
    stages: int


@functools.lru_cache(maxsize=None)
def block_plan(b: int, h: int, w: int, c: int, int8: bool) -> AttnPlan:
    """K5's plan at (b, h, w, c), bf16 or int8: the block GEMM's rules for a
    (c, 3c) and a (c, c) 1x1 (``s8_tile_plan`` / ``bf16_tile_plan``, which
    split K where the grid is small) and ``core_plan``. Raises for shapes
    the kernels do not take: S = H*W other than 16, 32 or a multiple of 64
    up to 256 (the core), C other than 128 or 256 (the block GEMM's
    128-channel tiles of N = C and 3C; int8 also its 128-channel K slice)."""
    if not core_supported(h * w, c):
        raise ValueError(f"attention block: no plan for x {(b, h, w, c)} (S = H*W 16, 32 or a "
                         "multiple of 64 up to 256; C a multiple of 64 up to 256)")
    plan = s8_tile_plan if int8 else bf16_tile_plan
    return AttnPlan(plan(b, h, w, c, 0, 3 * c, taps=1), plan(b, h, w, c, 0, c, taps=1),
                    core_plan(b, h * w))


def _aligned(n: int) -> int:
    return -(-n // 256) * 256


def workspace_bytes(b: int, s: int, c: int, h_bytes: int, a_bytes: int, splits: int) -> int:
    """Scratch of one K5 call (``csrc/attnblock.cu:carve``), each buffer on
    256 bytes: the GN affine (2 B C f32), the per-sample amaxes (2 B f32),
    h = GN(x) (``h_bytes`` an element: 2 bf16, 1 int8), [q|k|v] (M 3C
    bf16), a in a buffer of its own (``a_bytes``
    an element; 0: a takes h's place) and the split-K partials (splits M 3C
    f32, when a projection splits K)."""
    m = b * s
    parts = (4 * b * c, 4 * b * c, 8 * b, h_bytes * m * c, 6 * m * c, a_bytes * m * c,
             12 * splits * m * c if splits > 1 else 0)
    return sum(map(_aligned, parts))


def _tiles(p: GemmPlan):
    return p.mw, p.box_h, p.box_b, p.tiles_h, p.m_tiles, p.splits, p.kper


def supported(x_shape, int8: bool = False) -> bool:
    """Whether the card runs K5 on x (B, H, W, C), the JAX package's
    ``attnblock_ops.supported`` gate (gddim_tpu/models/blocks.py:83-87) with
    the port's plans: in the bf16 mode (bf16 or f32 activations; K10's
    forward) and the ``int8`` mode exactly where ``block_plan`` returns (the
    core's S and C, and the block GEMM's tiles for the (C, 3C) and (C, C) 1x1
    projections: C a multiple of 128)."""
    _, h, w, c = x_shape
    if not core_supported(h * w, c):
        return False
    slice_ = S8_SLICE if int8 else BF16_SLICE
    return _gemm_takes(h, w, c, 0, 3 * c, slice_) and _gemm_takes(h, w, c, 0, c, slice_)


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------


def _attnblock_cuda(x, gn_scale, gn_bias, weights: AttnWeights, *, num_groups, eps,
                    skip_rescale):
    """K5 through gddim_attnblock (bf16 or f32 x; the block GEMM), out in x's
    dtype."""
    b, h, w, c = x.shape
    s = h * w
    act = activation_dtype(x, "fused_attnblock", int8=False)
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "attnblock input", act), _operand(gn_scale, "gn scale", f32, (c,)),
        _operand(gn_bias, "gn bias", f32, (c,)),
        _operand(weights.wqkv, "wqkv", bf16, (c, 3 * c)),
        _operand(weights.bqkv, "bqkv", f32, (3 * c,)), _operand(weights.wo, "wo", bf16, (c, c)),
        _operand(weights.bo, "bo", f32, (c,)),
    ]
    ptrs = list(map(_build.ptr, ops))
    f32_act = act == f32
    plan = block_plan(b, h, w, c, False)
    nbytes = workspace_bytes(b, s, c, 2, 0, max(plan.qkv.splits, plan.out.splits))
    work = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    out = torch.empty(x.shape, device=dev, dtype=act)
    _build.launch("gddim_attnblock", dev, ptrs[0], int(f32_act), *ptrs[1:3], num_groups,
                  *ptrs[3:], b, h, w, c, eps, _INV_SQRT2 if skip_rescale else 1.0,
                  work.data_ptr(), nbytes, *_tiles(plan.qkv), *_tiles(plan.out), plan.stages,
                  gn_apply_ctas(h, w, c, f32_act), out.data_ptr())
    return out


def fused_attnblock(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                    num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K5. x: (B, H, W, C) bf16 or f32, out in x's dtype; NIN weights (C, C)
    with (C,) biases, packed on each call."""
    kw = dict(num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    if _on_cpu(x, "fused_attnblock"):
        return attnblock_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo, **kw)
    require_no_grad("fused_attnblock", x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    out = _attnblock_cuda(x, gn_scale, gn_bias, pack_attn_weights(wq, bq, wk, bk, wv, bv, wo, bo),
                          **kw)
    fused_attnblock.launches += 1
    return out


def fused_attnblock_packed(x, gn_scale, gn_bias, weights: AttnWeights, *, num_groups: int,
                           eps: float = 1e-6, skip_rescale: bool = False):
    """K5 on weights packed once (``pack_attn_weights``, the model's cached
    path); counted as ``fused_attnblock``."""
    kw = dict(num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    if _on_cpu(x, "fused_attnblock"):
        return attnblock_reference(x, gn_scale, gn_bias, *unpack_attn_weights(weights), **kw)
    require_no_grad("fused_attnblock", x, gn_scale, gn_bias, *weights)
    out = _attnblock_cuda(x, gn_scale, gn_bias, weights, **kw)
    fused_attnblock.launches += 1
    return out


def fused_attnblock_int8(x, gn_scale, gn_bias, wqkv, bqkv, wo, bo, act_scales=None, *,
                         num_groups: int, eps: float = 1e-6, skip_rescale: bool = False):
    """K5's int8 mode (see attnblock_int8_reference for the arguments). On
    CUDA the projections' weights are ``KMajorInt8`` (``pack_projection``);
    other layouts raise."""
    if _on_cpu(x, "fused_attnblock_int8"):
        return attnblock_int8_reference(x, gn_scale, gn_bias, wqkv, bqkv, wo, bo, act_scales,
                                        num_groups=num_groups, eps=eps, skip_rescale=skip_rescale)
    require_no_grad("fused_attnblock_int8", x, gn_scale, gn_bias, *wqkv, bqkv, *wo, bo)
    check_attn_scales(act_scales)
    bf16 = activation_dtype(x, "fused_attnblock_int8", int8=True)
    if not (isinstance(wqkv, KMajorInt8) and isinstance(wo, KMajorInt8)):
        raise ValueError("fused_attnblock_int8: the int8 block GEMM takes K-major int8 "
                         "projection weights (pack_projection)")
    b, h, w, c = x.shape
    f32, dev = torch.float32, x.device
    plan = block_plan(b, h, w, c, True)
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "attnblock input", bf16), _operand(gn_scale, "gn scale", f32, (c,)),
        _operand(gn_bias, "gn bias", f32, (c,)),
        _operand(wqkv.q, "wqkv", torch.int8, (3 * c, c)),
        _operand(wqkv.scale, "wqkv scales", f32, (3 * c,)), _operand(bqkv, "bqkv", f32, (3 * c,)),
        _operand(wo.q, "wo", torch.int8, (c, c)), _operand(wo.scale, "wo scales", f32, (c,)),
        _operand(bo, "bo", f32, (c,)), _operand(act_scales, "act scales", f32, (2,)),
    ]
    ptrs = list(map(_build.ptr, ops))
    nbytes = workspace_bytes(b, h * w, c, 1, 0 if act_scales is not None else 4,
                             max(plan.qkv.splits, plan.out.splits))
    work = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    out = torch.empty(x.shape, device=dev, dtype=bf16)
    _build.launch(
        "gddim_attnblock_int8", dev, *ptrs[:3], num_groups, *ptrs[3:], b, h, w, c, eps,
        _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(), nbytes, *_tiles(plan.qkv),
        *_tiles(plan.out), plan.stages, gn_apply_ctas(h, w, c), out.data_ptr(),
    )
    fused_attnblock_int8.launches += 1
    return out


def attention_core(qkv, *, mode: str = "bf16", act_scale=None, stages: int | None = None):
    """The attention core alone (see attention_core_reference for the
    arguments): qkv (B, S, 3C) bf16 -> a (B, S, C) in ``mode``'s type ("f32":
    a and the per-sample amax). stages: the ring's depth (default
    ``core_plan``). Launches are counted in C (``block_launches``)."""
    if _on_cpu(qkv, "attention_core"):
        return attention_core_reference(qkv, mode=mode, act_scale=act_scale)
    require_no_grad("attention_core", qkv)
    b, s, c3 = qkv.shape
    c, dev = c3 // 3, qkv.device
    if c3 % 3 or not core_supported(s, c) or (mode == "int8") != (act_scale is not None):
        raise ValueError(f"attention_core: unsupported qkv {tuple(qkv.shape)}, mode {mode}")
    q = _operand(qkv, "qkv", torch.bfloat16, (b, s, c3))
    qs = _operand(act_scale, "act_scale", torch.float32)
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}[mode]
    out = torch.empty((b, s, c), device=dev, dtype=dtype)
    amax = torch.empty(b, device=dev, dtype=torch.float32) if mode == "f32" else None
    _build.launch("gddim_attention_core", dev, q.data_ptr(), b, s, c, stages or core_plan(b, s),
                  CORE_MODES[mode], _build.ptr(qs), _build.ptr(amax), out.data_ptr())
    return (out, amax) if mode == "f32" else out


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
        out = _attnblock_cuda(*args[:3], pack_attn_weights(*args[3:]), **cfg)
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


fused_attnblock.launches = 0  # block launches on CUDA tensors (packed or not)
fused_attnblock_int8.launches = 0  # one gddim_attnblock_int8 each
fused_attnblock_train.launches = 0  # K10 forwards (one gddim_attnblock each)
