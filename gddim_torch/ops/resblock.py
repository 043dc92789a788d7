"""K2, K3, K4, K6: the fused BigGAN residual block, NHWC.

Replaces four Pallas kernels of ``gddim_tpu/ops/resblock.py``, which are one
computation:

- ``fused_resblock`` (K2, ``_resblock_kernel_v2``): every stride-1 block;
- ``fused_resblock_pair`` (K3, ``_resblock_pair_kernel_v2``): the up-path
  blocks on concat(xa, xb), without building the concat;
- ``fused_resblock_tail`` (K4, ``_resblock_kernel_v2`` with GN1 off): the
  up/down transition blocks after GN1+SiLU and the FIR resample;
- ``fused_resblock_train`` (K6, ``make_fused_resblock_train``): every
  stride-1 block of a training step, f32 activations, with the dropout mask
  applied after GN2+SiLU. An ``autograd.Function`` that saves only x, the
  temb row, the mask and the parameters; its backward is K7
  (``ops/resblock_bwd.py``), which recomputes the interior.

    h = silu(GN1(x))                          (K4: h arrives so)
    h = conv3x3(h, W1) + b1 + (silu(temb) @ Wd + bd)
    h = silu(GN2(h))
    h = conv3x3(h, W2) + b2
    out = (skip(x) + h) * 1/sqrt(2)           skip: identity or 1x1 conv + b_skip

The CUDA implementation is ``csrc/resblock.cu`` (see its header for what
bounds it on the H100 and how the design answers), one C call of a few
hand-written launches per block. On bf16 activations each conv is a bf16
pre-pass (``bf16_conv_input``: a = bf16(silu(GN(x))), written once) and the
block GEMM (``csrc/block_gemm.cu``, ``bf16_conv_gemm``: wgmma fed by TMA,
the HWIO weights read through the transpose bit, the 1x1 skip in the same
accumulators), with h1 in f32 between the convs, as the TPU kernel keeps it
(``resblock_bf16_reference`` and its pair/tail forms are the plain versions
with the TPU kernel's rounding points); its tile plan is ``bf16_tile_plan``.
The GroupNorm statistics are the TPU kernels' (per-channel f32 sums and
sums of squares, folded by group, var = E[x^2] - mean^2): GN1's on bf16
activations with conv1's operand in one launch of ``gn_apply_kernel``
(``csrc/gn_apply.cu``: a cluster of CTAs holds each sample and reads it
once; ``gn_apply``, its route ``gn_apply_ctas``, plain version
``gn_apply_reference``; K9's GN1 and resample likewise, ``gn_resample``),
on f32 activations from ``gn_stats_kernel`` (``gn_stats``; plain version
``gn_stats_reference``); GN2's from conv1's epilogue, which writes each
channel's sums a (tile, sample) (``gn2_partials_reference``), folded in a
fixed order (``gn_fold_reference``) by conv2's pre-pass. The temb row
(silu(temb) @ Wd + bd) is the model's: it passes each block its slice of one
per-eval product (``temb`` a (B, Cout) row with ``dense_w`` None); called
with the Dense weights, a wrapper makes the row itself. ``stride1_supported``,
``pair_supported``, ``tail_supported`` and ``transition_supported`` say
which blocks the card's kernels take; the model runs the plain composition
elsewhere, as the JAX package does.
K6 runs the bf16 block's chain on f32 x and out (``gn_stats`` of x, the
pre-pass writing a1 and, for the 1x1 skip, bf16 x, conv1 with GN2's sums,
GN2's folding pre-pass with the dropout mask, conv2 + skip or the f32
identity residual; plain version ``resblock_train_bf16_reference``), its
tile plan ``bf16_tile_plan``; ``train_supported`` says which training blocks
K6 and K7 take. On f32 activations K2-K4 (and K9) run the same chain as K6
without the mask, and write f32 (x, h1, the identity residual and out f32,
the MMA operands bf16, as the TPU kernels with mm_dtype bf16; plain
versions ``resblock_bf16_reference`` and its forms), gated by the same
plans. On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches the kernels or raises. K2-K4 have no gradient: on CUDA
tensors they raise when autograd would need one.

The int8 mode of K2-K4 (``mm_dtype=jnp.int8``, what ``conv_impl='fused_int8'``
runs): ``fused_resblock_int8``, ``fused_resblock_pair_int8`` and
``fused_resblock_tail_int8`` take each conv's weights as ``quantize_weight``
made them (int8 HWIO and per-output-channel scales) and quantize the conv
inputs a1 = silu(GN1(x)) (K4: h) and a2 = silu(GN2(h1)), both in f32, to int8:
with calibrated static scales ``act_scales = [s1, s2]``
(``act_scales_from_amax``) as clip(round(a * (1/s))), else per sample as
clip(round(a / s_b)), s_b = max(max|a|, 1e-12) / 127 (the pair's a1:
a * (127 / amax), as its TPU kernel writes it). The int32 sums are
dequantized by (weight scale * s), h1 stays f32 between the convs, and the
1x1 skip runs bf16 with f32 sums, as the model runs it. A third static
scale, ``act_scales = [s1, s2, sx]`` (calibration's "x" amax), opts into the
JAX package's ``static_skip``: the skip's input quantized as
clip(round(x * (1/sx))) (K9: the resampled x before any rounding), its 1x1
an exact int8 product by the skip weights as ``quantize_weight`` made them
((int8 (Cin, Cout), scale) pairs, ``pack_skip_int8`` for the card), and
skip = f32(int32 sum) * (w_skip_scale * sx) + b_skip; a block without a 1x1
skip ignores sx. On the card each conv is a quantize pre-pass
(``quantize_conv_input``) and the block GEMM in its int8 mode
(``int8_conv_gemm``): wgmma s8 fed by TMA, which reads the int8 weights
K-major, (Cout, 9 * Cin), as ``pack_int8_weight`` makes them once from
``quantize_weight``'s HWIO; the CUDA wrappers take only that layout, the
plain versions either. Its tile plan is ``s8_tile_plan``. ``block_launches``
reads how often the card ran the block GEMM and the pre-pass, each mode
apart, counted in C where they launch.

Weights are in the JAX package's layout: conv kernels HWIO (3, 3, Cin, Cout),
the skip (Cin, Cout), the temb Dense (K, Cout).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gddim_torch import _build
from gddim_torch.ops.groupnorm import group_norm_silu_reference

_INV_SQRT2 = 0.7071067811865476


# --------------------------------------------------------------------------
# Plain versions (mirror gddim_tpu/ops/resblock.py:1617,1643)
# --------------------------------------------------------------------------


def temb_projection(temb, dense_w, dense_b):
    """silu(temb) @ Wd + bd in f32: the per-sample row conv1 adds; with
    dense_w None, temb is that row already (the model's slice of its per-eval
    product of every block's rows)."""
    if dense_w is None:
        return temb.float()
    return F.silu(temb.float()) @ dense_w.float() + dense_b.float()


def conv3x3_nhwc(h, w, b=None):
    """Stride-1 SAME 3x3 conv, NHWC input, HWIO kernel, in h's dtype."""
    y = F.conv2d(h.permute(0, 3, 1, 2), w.to(h.dtype).permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b.to(h.dtype)


def _tail(h, x_skip, temb_proj, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip, b_skip,
          num_groups2, eps, skip_rescale, sow=None):
    if sow is not None:
        sow("a1", h)
    y = conv3x3_nhwc(h, w1, b1) + temb_proj.to(h.dtype)[:, None, None, :]
    y = group_norm_silu_reference(y, gn2_scale, gn2_bias, num_groups2, eps)
    if sow is not None:
        sow("a2", y)
    y = conv3x3_nhwc(y, w2, b2)
    if w_skip is None:
        skip = x_skip
    else:
        if sow is not None:
            sow("x", x_skip)
        skip = torch.einsum("bhwc,cd->bhwd", x_skip, w_skip.to(x_skip.dtype))
        if b_skip is not None:
            skip = skip + b_skip.to(x_skip.dtype)
    out = skip + y
    return out * _INV_SQRT2 if skip_rescale else out


def resblock_reference(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                       gn2_scale, gn2_bias, w2, b2, w_skip=None, b_skip=None, *,
                       num_groups1: int, num_groups2: int, eps: float = 1e-6,
                       skip_rescale: bool = True, sow=None):
    """Plain version of K2: the unfused composition. sow(site, tensor), if
    given, sees the int8 quantization sites as the JAX package's calibration
    records them (``gddim_tpu/models/blocks.py:562-580``): "a1" (the conv1
    input), "a2" (the conv2 input) and, with a skip projection, "x"."""
    h = group_norm_silu_reference(x, gn1_scale, gn1_bias, num_groups1, eps)
    return _tail(h, x, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                 gn2_bias, w2, b2, w_skip, b_skip, num_groups2, eps, skip_rescale, sow)


def resblock_pair_reference(xa, xb, *args, **kwargs):
    """Plain version of K3: K2's composition on the concat."""
    return resblock_reference(torch.cat([xa, xb], -1), *args, **kwargs)


def resblock_tail_reference(h, x_skip, temb, dense_w, dense_b, w1, b1, gn2_scale,
                            gn2_bias, w2, b2, w_skip, b_skip, *, num_groups2: int,
                            eps: float = 1e-6, skip_rescale: bool = True, sow=None):
    """Plain version of K4: h = silu(GN1(x)) already resampled."""
    return _tail(h, x_skip, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                 gn2_bias, w2, b2, w_skip, b_skip, num_groups2, eps, skip_rescale, sow)


# --------------------------------------------------------------------------
# int8 mode: quantizers and plain versions (gddim_tpu/ops/resblock.py:61-88,
# 177-430, 638-675, 739-982)
# --------------------------------------------------------------------------

# margin on calibrated amaxes (gddim_tpu/ops/resblock.py:79): sampling-time
# activations exceed a calibration sweep's by up to ~1.35x on trained weights
CALIB_MARGIN = 1.5


def _div(a, b: float):
    """a / b in f32 by true division: a CUDA tensor divided by a Python scalar
    is multiplied by its reciprocal instead, one rounding off JAX's."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def act_scales_from_amax(amaxes):
    """(amax...) -> (scale...): max(amax, 1e-12) * (CALIB_MARGIN / 127) in f32,
    None staying None (``act_scales_from_amax``, resblock.py:82)."""
    def scale(a):
        a = torch.as_tensor(a, dtype=torch.float32)
        return a.clamp_min(1e-12) * torch.full((), CALIB_MARGIN / 127.0, device=a.device)

    return tuple(None if a is None else scale(a) for a in amaxes)


def quantize_weight(w):
    """(int8 weights, f32 scale per output channel) of ``prep_w``
    (resblock.py:638-648): sc = max(max|w| over all but the last axis,
    1e-12) / 127, q = clip(round(w / sc), -127, 127), from w in f32."""
    w = w.detach().float()
    sc = _div(w.abs().amax(dim=tuple(range(w.dim() - 1))).clamp_min(1e-12), 127.0)
    return torch.clamp(torch.round(w / sc), -127, 127).to(torch.int8), sc


def pack_int8_weight(w):
    """(int8 HWIO (3, 3, Cin, Cout), scale) -> (int8 K-major (Cout, 9 * Cin),
    scale): row n holds output channel n's weights in the HWIO K order
    (tap-major, then input channel), as the int8 block GEMM's TMA reads them
    (8-bit wgmma takes its B operand K-major only)."""
    wq, sc = w
    return wq.reshape(-1, wq.shape[-1]).t().contiguous(), sc


def hwio_int8_weight(wq, cin: int):
    """The HWIO int8 weights of ``wq`` in either layout: K-major (Cout, 9 *
    Cin) unpacked, HWIO as it is."""
    return wq.t().reshape(3, 3, cin, -1) if wq.dim() == 2 else wq


def check_act_scales(act_scales) -> bool:
    """act_scales: None (per-sample scales), the two static scales [s1, s2]
    (the 1x1 skip bf16) or three, [s1, s2, sx] (also the static int8 skip
    projection, the TPU kernels' ``static_skip``; a block without a 1x1 skip
    ignores sx), e.g. ``torch.stack(act_scales_from_amax((a1, a2, ax)))``.
    Returns whether sx is given; raises for another count."""
    if act_scales is None:
        return False
    if act_scales.numel() not in (2, 3):
        raise ValueError(f"int8 kernels take 2 or 3 static activation scales (s1, s2[, sx]), "
                         f"got {act_scales.numel()}")
    return act_scales.numel() == 3


def pack_skip_int8(w):
    """(int8 (Cin, Cout), scale) of ``quantize_weight`` -> the same pair with
    the int8 weights stored K-major, (Cout, Cin) in memory, as the int8 block
    GEMM reads the static skip's 1x1 (still shaped (Cin, Cout): a transposed
    view), so that the CUDA wrappers copy nothing."""
    wq, sc = w
    return wq.t().contiguous().t(), sc


def skip_int8(w_skip, what: str):
    """The static skip's (int8 (Cin, Cout), scale) pair, checked."""
    if not (isinstance(w_skip, (tuple, list)) and len(w_skip) == 2
            and w_skip[0].dtype == torch.int8):
        raise ValueError(f"{what}: with sx the skip weights are an (int8 (Cin, Cout), scale) "
                         "pair (quantize_weight, pack_skip_int8)")
    return list(w_skip)


def static_skip_product(x_skip, w_skip, b_skip, sx):
    """The static int8 skip of the TPU kernels (``static_skip``): q =
    clip(round(x * (1/sx))) of f32 x_skip (B, H, W, Cin), the exact int32
    sums of q by the int8 (Cin, Cout) weights of ``w_skip = (wq, scale)``,
    then f32(sums) * (scale * sx) + b_skip, the scale product in f32 first."""
    wq, wsc = skip_int8(w_skip, "static skip")
    q = quant_static(x_skip.float(), sx)
    return int8_matmul_exact(q, wq) * (wsc.float() * sx) + b_skip.float()


def _plain_skip_buffers(buffers: dict, x_skip, w_skip, act_scales) -> None:
    """The int8 entries' ``skip_buffers`` on the CPU: "xq" the plain static
    skip's int8 input q(x_skip)."""
    if not check_act_scales(act_scales) or w_skip is None:
        raise ValueError("skip_buffers: needs the static skip (act_scales [s1, s2, sx], a 1x1 skip)")
    buffers["xq"] = quant_static(x_skip.float(), act_scales.float()[2]).to(torch.int8)


def quant_static(a, s):
    """clip(round(a * (1/s)), -127, 127) of an f32 tensor, s a 0-d scale."""
    inv = torch.ones_like(s) / s
    return torch.clamp(torch.round(a * inv), -127, 127)


def quant_dynamic(a, inv_mul: bool = False):
    """Per-sample quantization of (B, ...) f32: (q, s_b with a's rank).
    s_b = max(max|a|, 1e-12) / 127 and q = clip(round(a / s_b)); inv_mul:
    q = clip(round(a * (127 / amax))), the pair kernel's form."""
    amax = a.abs().amax(dim=tuple(range(1, a.dim())), keepdim=True).clamp_min(1e-12)
    s = _div(amax, 127.0)
    q = a * (torch.full_like(amax, 127.0) / amax) if inv_mul else a / s
    return torch.clamp(torch.round(q), -127, 127), s


def group_norm_tpu(x, scale, bias, num_groups: int, eps: float, apply_silu: bool, fold: bool):
    """GroupNorm(+SiLU) of f32 (B, ..., C) as the TPU kernels compute it
    (resblock.py:48-58,345-356, attnblock.py:31-37,86-92): one-pass
    statistics var = E[x^2] - mean^2 scaled by 1/n, then (x - mean) * rstd *
    scale + bias in the per-sample bodies (dynamic scales), or with fold the
    affine x * a + (bias - mean * a), a = rstd * scale, of the vectorized
    bodies (static scales). An int8 rounding hinges on the last bit of these
    values, so the int8 plain versions follow the TPU's arithmetic here."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, c)
    cg = c // num_groups
    inv_n = torch.tensor(1.0 / (xf.shape[1] * cg), dtype=torch.float32, device=x.device)

    def group_mean(t):  # (B, C) channel sums -> each channel's group mean
        return t.reshape(b, num_groups, cg).sum(-1).repeat_interleave(cg, -1)[:, None] * inv_n

    mean, esq = group_mean(xf.sum(1)), group_mean((xf * xf).sum(1))
    rstd = torch.rsqrt(esq - mean * mean + eps)
    if fold:
        a = rstd * scale.float()
        out = xf * a + (bias.float() - mean * a)
    else:
        out = (xf - mean) * rstd * scale.float() + bias.float()
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.reshape(x.shape)


def gn_fold_reference(part, hw: int, num_groups: int, eps: float, gamma, beta):
    """The fold of GN statistics from per-channel partial sums, as the
    kernels fold them: part (2, B, parts, C) f32 ([0] sums, [1] squares over
    the sample's hw pixels) -> (scale, shift) (B, C) of the affine x * scale
    + shift, and mean, rstd (B, groups); var = E[x^2] - mean^2 with the TPU
    kernels' 1/n (``group_norm_tpu``)."""
    s, q = part.float().sum(2)
    b, c = s.shape
    cg = c // num_groups
    inv_n = torch.tensor(1.0 / (hw * cg), dtype=torch.float32, device=s.device)
    mean = s.reshape(b, num_groups, cg).sum(-1) * inv_n
    rstd = torch.rsqrt(q.reshape(b, num_groups, cg).sum(-1) * inv_n - mean * mean + eps)
    scale = rstd.repeat_interleave(cg, -1) * gamma.float()
    return scale, beta.float() - mean.repeat_interleave(cg, -1) * scale, mean, rstd


def gn_stats_reference(x, num_groups: int, eps: float, gamma, beta):
    """Plain version of ``gn_stats``: the TPU kernels' GroupNorm statistics
    (``gn_silu_tile``, gddim_tpu/ops/resblock.py:345-356) of (B, ..., C) x in
    f32 over each whole sample: (scale, shift) (B, C), mean, rstd (B, groups)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, c)
    part = torch.stack([xf.sum(1), (xf * xf).sum(1)])[:, :, None]
    return gn_fold_reference(part, xf.shape[1], num_groups, eps, gamma, beta)


def gn2_partials_reference(h1, plan: "GemmPlan"):
    """The partial sums conv1's epilogue writes for GN2 under ``plan`` (the
    conv's tile plan): (2, B, tiles_h, C) f32, [0] each channel's sum and [1]
    its sum of squares over the pixels of M tile row t of sample b (a tile of
    box_h rows of one sample, or of box_b whole samples; rows past the image
    or the batch are not in any tile). ``gn_fold_reference`` of them is
    ``gn_stats_reference`` of h1."""
    b, h, w, c = h1.shape
    hf = h1.float()
    part = hf.new_zeros((2, b, plan.tiles_h, c))
    for t in range(plan.tiles_h):
        rows = hf[:, t * plan.box_h:(t + 1) * plan.box_h].reshape(b, -1, c)
        part[0, :, t], part[1, :, t] = rows.sum(1), (rows * rows).sum(1)
    return part


def int8_matmul_exact(q, wq):
    """Exact int32 sums of (..., K) int-valued q by (K, N) int8 wq (float64
    products: 127^2 * 9 * 512 exceeds f32's 2^24), rounded once to f32."""
    return (q.double() @ wq.double()).float()


def conv3x3_int8_exact(q, wq):
    """Exact 3x3 SAME conv of NHWC int-valued q by HWIO int8 wq, in f32."""
    return conv3x3_nhwc(q.double(), wq.double()).float()


def _conv_input(x0, x1, scale, shift, silu: bool):
    """A conv input of the block pre-pass in f32: concat(x0, x1), with scale
    and shift (B, C) a * scale[b] + shift[b], then SiLU (silu)."""
    a = (x0 if x1 is None else torch.cat([x0, x1], -1)).float()
    if scale is not None:
        cshape = (a.shape[0],) + (1,) * (a.dim() - 2) + (-1,)
        a = a * scale.float().reshape(cshape) + shift.float().reshape(cshape)
        if silu:
            a = a * torch.sigmoid(a)
    return a


def bf16_conv_input_reference(x0, x1=None, scale=None, shift=None, *, silu: bool = False):
    """Plain version of the bf16 block's pre-pass: the activation of
    ``_conv_input`` rounded once to bf16 (the TPU kernels'
    ``a1.astype(mm_dtype)``), x0's shape but C."""
    return _conv_input(x0, x1, scale, shift, silu).to(torch.bfloat16)


def quantize_conv_input_reference(x0, x1=None, scale=None, shift=None, *, silu: bool = False,
                                  act_scale=None, amax=None, inv_mul: bool = False):
    """Plain version of the int8 block's quantize pre-pass: a = concat(x0,
    x1) in f32; with scale and shift (B, C), a * scale[b] + shift[b], then
    SiLU (silu); quantized with the static act_scale as clip(round(a *
    (1/s))), else per sample by amax (B,) (max|a| of the sample when None):
    clip(round(a / s_b)), s_b = max(amax_b, 1e-12) / 127, or with inv_mul
    clip(round(a * (127 / max(amax_b, 1e-12)))). int8, x0's shape but C."""
    a = _conv_input(x0, x1, scale, shift, silu)
    bshape = (a.shape[0],) + (1,) * (a.dim() - 1)
    if act_scale is not None:
        q = quant_static(a, act_scale.float().reshape(()))
    else:
        am = a.abs().amax(dim=tuple(range(1, a.dim()))) if amax is None else amax.float()
        am = am.reshape(bshape).clamp_min(1e-12)
        q = torch.clamp(torch.round(a * (torch.full_like(am, 127.0) / am) if inv_mul
                                    else a / _div(am, 127.0)), -127, 127)
    return q.to(torch.int8)


def _int8_block(a1, x_skip, temb_proj, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip, b_skip,
                act_scales, num_groups2, eps, skip_rescale, out_dtype, pair: bool,
                fold2: bool | None = None):
    """conv1 .. out of the int8 block from a1 (f32, the conv1 input). fold2:
    GN2's affine folded (default: with static scales, as K2-K4's vectorized
    bodies; K9 never folds)."""
    (w1q, w1s), (w2q, w2s) = w1, w2
    w1q, w2q = hwio_int8_weight(w1q, a1.shape[-1]), hwio_int8_weight(w2q, w1s.shape[-1])
    static, sx = act_scales is not None, check_act_scales(act_scales)
    if static:
        s1, s2 = act_scales.float()[:2]
        q1, dq1 = quant_static(a1, s1), w1s * s1
    else:
        q1, sb = quant_dynamic(a1, inv_mul=pair)
        dq1 = sb * w1s
    h = conv3x3_int8_exact(q1, w1q) * dq1 + b1.float() + temb_proj[:, None, None, :]
    a2 = group_norm_tpu(h, gn2_scale, gn2_bias, num_groups2, eps, True,
                        fold=static if fold2 is None else fold2)
    if static:
        q2, dq2 = quant_static(a2, s2), w2s * s2
    else:
        q2, sb = quant_dynamic(a2)
        dq2 = sb * w2s
    h = conv3x3_int8_exact(q2, w2q) * dq2 + b2.float()
    if w_skip is None:
        skip = x_skip.float()
    elif sx:
        skip = static_skip_product(x_skip, w_skip, b_skip, act_scales.float()[2])
    else:
        skip = x_skip.to(torch.bfloat16).float() @ w_skip.to(torch.bfloat16).float()
        skip = skip + b_skip.float()
    out = skip + h
    return (out * _INV_SQRT2 if skip_rescale else out).to(out_dtype)


def resblock_int8_reference(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                            gn2_scale, gn2_bias, w2, b2, w_skip=None, b_skip=None,
                            act_scales=None, *, num_groups1: int, num_groups2: int,
                            eps: float = 1e-6, skip_rescale: bool = True):
    """Plain version of K2's int8 mode. w1, w2: (int8 HWIO, scale) pairs
    from quantize_weight; act_scales: None (per-sample), [s1, s2] or [s1, s2,
    sx] (check_act_scales; with sx, w_skip an (int8 (Cin, Cout), scale) pair
    and the skip ``static_skip_product``)."""
    check_act_scales(act_scales)
    a1 = group_norm_tpu(x.float(), gn1_scale, gn1_bias, num_groups1, eps, True,
                        fold=act_scales is not None)
    return _int8_block(a1, x, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_skip, b_skip, act_scales, num_groups2, eps,
                       skip_rescale, x.dtype, pair=False)


def resblock_pair_int8_reference(xa, xb, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                                 gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, act_scales=None,
                                 *, num_groups1: int, num_groups2: int, eps: float = 1e-6,
                                 skip_rescale: bool = True):
    """Plain version of K3's int8 mode: K2's on concat(xa, xb) (with sx, both
    halves quantized by it: the TPU kernel's two products sum exactly)."""
    check_act_scales(act_scales)
    x = torch.cat([xa, xb], -1)
    a1 = group_norm_tpu(x.float(), gn1_scale, gn1_bias, num_groups1, eps, True,
                        fold=act_scales is not None)
    return _int8_block(a1, x, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_skip, b_skip, act_scales, num_groups2, eps,
                       skip_rescale, xa.dtype, pair=True)


def resblock_tail_int8_reference(h, x_skip, temb, dense_w, dense_b, w1, b1, gn2_scale,
                                 gn2_bias, w2, b2, w_skip, b_skip, act_scales=None, *,
                                 num_groups2: int, eps: float = 1e-6, skip_rescale: bool = True):
    """Plain version of K4's int8 mode: h = silu(GN1(x)) already resampled."""
    check_act_scales(act_scales)
    return _int8_block(h.float(), x_skip, temb_projection(temb, dense_w, dense_b), w1, b1,
                       gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, act_scales, num_groups2,
                       eps, skip_rescale, h.dtype, pair=False)


# --------------------------------------------------------------------------
# The bf16 mode with the TPU kernels' rounding points (mm_dtype bf16:
# gddim_tpu/ops/resblock.py:345-430, 880-960)
# --------------------------------------------------------------------------


def _bf16r(t):
    """t rounded to bf16, in f32."""
    return t.to(torch.bfloat16).float()


def _bf16_block(a1, x_skip, temb_proj, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip, b_skip,
                num_groups2, eps, skip_rescale, out_dtype, fold2: bool):
    """conv1 .. out of the bf16 block from a1 (f32 holding bf16 values, the
    conv1 operand): bf16 weights with f32 sums, h1 = conv1 + b1 + temb in
    f32, a2 = silu(GN2(h1)) (one-pass statistics; fold2: the folded affine)
    rounded to bf16, the skip bf16 x_skip @ bf16 w_skip with f32 sums (or
    x_skip itself), out in out_dtype."""
    h1 = conv3x3_nhwc(a1, _bf16r(w1.float()), b1.float()) + temb_proj[:, None, None, :]
    a2 = _bf16r(group_norm_tpu(h1, gn2_scale, gn2_bias, num_groups2, eps, True, fold2))
    out = conv3x3_nhwc(a2, _bf16r(w2.float()), b2.float())
    if w_skip is None:
        out = out + x_skip.float()
    else:
        out = out + _bf16r(x_skip.float()) @ _bf16r(w_skip.float())
        out = out if b_skip is None else out + b_skip.float()
    return (out * _INV_SQRT2 if skip_rescale else out).to(out_dtype)


def resblock_bf16_reference(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                            gn2_bias, w2, b2, w_skip=None, b_skip=None, *, num_groups1: int,
                            num_groups2: int, eps: float = 1e-6, skip_rescale: bool = True):
    """K2's bf16 mode with the TPU kernel's rounding points
    (``_resblock_kernel_v2``, mm_dtype bf16), in f32 otherwise: GN
    statistics E[x^2] - mean^2 and the folded affine; a1 = silu(GN1(x))
    rounded to bf16 (the conv's operand); h1 f32; a2 = silu(GN2(h1)) rounded
    to bf16; out in x's dtype."""
    a1 = _bf16r(group_norm_tpu(x.float(), gn1_scale, gn1_bias, num_groups1, eps, True, True))
    return _bf16_block(a1, x, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_skip, b_skip, num_groups2, eps, skip_rescale, x.dtype,
                       True)


def resblock_pair_bf16_reference(xa, xb, *args, **kwargs):
    """K3's bf16 mode with the TPU kernel's rounding points
    (``_resblock_pair_kernel_v2``): K2's on concat(xa, xb)."""
    return resblock_bf16_reference(torch.cat([xa, xb], -1), *args, **kwargs)


def resblock_tail_bf16_reference(h, x_skip, temb, dense_w, dense_b, w1, b1, gn2_scale, gn2_bias,
                                 w2, b2, w_skip, b_skip, *, num_groups2: int, eps: float = 1e-6,
                                 skip_rescale: bool = True):
    """K4's bf16 mode with the TPU kernel's rounding points: h (silu(GN1(x))
    resampled) rounded to bf16 as conv1's operand, then K2's."""
    return _bf16_block(_bf16r(h.float()), x_skip, temb_projection(temb, dense_w, dense_b), w1, b1,
                       gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, num_groups2, eps,
                       skip_rescale, h.dtype, True)


# --------------------------------------------------------------------------
# K9: the whole up/down transition block (gddim_tpu/ops/resblock.py:1235-1301,
# 1304-1420, 1458-1614)
# --------------------------------------------------------------------------


def transition_kerns(up: bool, fir: bool, fir_kernel=(1, 3, 3, 1)) -> tuple:
    """(kern_h, kern_w): the 4 phase coefficients per axis of the factor-2
    resample (``_transition_kerns``): the FIR taps normalized and flipped,
    the H axis carrying the up gain 4; naive up (0, 1, 1, 0) and naive down,
    the 2x2 mean, (0, .5, .5, 0)."""
    if fir:
        k1d = np.asarray(fir_kernel, np.float64)
        k1d = (k1d / k1d.sum())[::-1]
        if k1d.shape[0] != 4:
            raise ValueError("the transition resample takes a 4-tap FIR kernel")
        kw = tuple(float(v) for v in k1d)
        return (tuple(4.0 * v for v in kw) if up else kw), kw
    if up:
        return (0.0, 1.0, 1.0, 0.0), (0.0, 1.0, 1.0, 0.0)
    return (0.0, 0.5, 0.5, 0.0), (0.0, 0.5, 0.5, 0.0)


def resample_transition(a, kerns, up: bool):
    """Factor-2 polyphase resample of NHWC ``a`` in f32 with zero borders
    (``_fir_up_2d`` / ``_fir_down_2d``): up, out[2j] = k0 a[j-1] + k2 a[j] and
    out[2j+1] = k1 a[j] + k3 a[j+1]; down, out[o] = sum_t k_t a[2o+t-1]; H
    first, then W, with the coefficients of ``transition_kerns``."""
    a = a.float()
    for dim, k in ((1, kerns[0]), (2, kerns[1])):
        n = a.shape[dim]
        p = F.pad(a, (0, 0, 1, 1) if dim == 2 else (0, 0, 0, 0, 1, 1))  # zero borders
        if up:  # p.narrow(dim, t, n)[j] = a[j + t - 1]
            t = [p.narrow(dim, i, n) for i in range(3)]
            even, odd = k[0] * t[0] + k[2] * t[1], k[1] * t[1] + k[3] * t[2]
            a = torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)
        else:  # p[..., t : t + n - 1 : 2, ...][o] = a[2o + t - 1]
            t = [p[(slice(None),) * dim + (slice(i, i + n - 1, 2),)] for i in range(4)]
            a = k[0] * t[0] + k[1] * t[1] + k[2] * t[2] + k[3] * t[3]
    return a


def transition_supported(x_shape, cout: int, up: bool, fir: bool, fir_kernel=(1, 3, 3, 1),
                         int8: bool = False) -> bool:
    """The shapes K9 takes on the card (``transition_supported`` without its
    backend and environment tests): a 4-tap FIR kernel, even H and W, and
    the K4 path's convs at the output resolution as ``tail_supported`` takes
    them (the block GEMM's tile plans, bf16 (bf16 or f32 x) or ``int8``)."""
    b, h, w, c = x_shape
    ho, wo = (2 * h, 2 * w) if up else (h // 2, w // 2)
    return ((not fir or len(fir_kernel) == 4) and h % 2 == 0 and w % 2 == 0
            and tail_supported((b, ho, wo, c), cout, int8))


def resblock_transition_reference(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                                  gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, *, up: bool,
                                  fir: bool = True, fir_kernel=(1, 3, 3, 1), num_groups1: int,
                                  num_groups2: int, eps: float = 1e-6, skip_rescale: bool = True):
    """Plain version of K9 (``resblock_transition_reference``, resblock.py:1592):
    the unfused composition in x's dtype, GN1+SiLU, the resample of the
    activation and of x, then K4's plain tail. w_skip (C, Cout) required."""
    kerns = transition_kerns(up, fir, fir_kernel)
    h = group_norm_silu_reference(x, gn1_scale, gn1_bias, num_groups1, eps)
    h = resample_transition(h, kerns, up).to(x.dtype)
    xr = resample_transition(x, kerns, up).to(x.dtype)
    return resblock_tail_reference(h, xr, temb, dense_w, dense_b, w1, b1, gn2_scale, gn2_bias, w2,
                                   b2, w_skip, b_skip, num_groups2=num_groups2, eps=eps,
                                   skip_rescale=skip_rescale)


def resblock_transition_bf16_reference(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                                       gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, *, up: bool,
                                       fir: bool = True, fir_kernel=(1, 3, 3, 1),
                                       num_groups1: int, num_groups2: int, eps: float = 1e-6,
                                       skip_rescale: bool = True):
    """K9's bf16 mode with the TPU kernel's rounding points
    (``_resblock_transition_kernel``, mm_dtype bf16), in f32 otherwise: GN
    statistics E[x^2] - mean^2; silu(GN1(x)) and x rounded to bf16 (the
    resample scratch); the resampled h and x rounded to bf16 (conv1's and the
    skip's operands); bf16 weights with f32 sums; h1 f32; silu(GN2(h1))
    rounded to bf16; out in x's dtype."""
    kerns = transition_kerns(up, fir, fir_kernel)
    a1 = _bf16r(group_norm_tpu(x.float(), gn1_scale, gn1_bias, num_groups1, eps, True, False))
    h = _bf16r(resample_transition(a1, kerns, up))
    xr = _bf16r(resample_transition(_bf16r(x.float()), kerns, up))
    return _bf16_block(h, xr, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_skip, b_skip, num_groups2, eps, skip_rescale, x.dtype,
                       False)


def resblock_transition_int8_reference(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                                       gn2_scale, gn2_bias, w2, b2, w_skip, b_skip,
                                       act_scales=None, *, up: bool, fir: bool = True,
                                       fir_kernel=(1, 3, 3, 1), num_groups1: int,
                                       num_groups2: int, eps: float = 1e-6,
                                       skip_rescale: bool = True):
    """Plain version of K9's int8 mode (``_resblock_transition_kernel``,
    mm_dtype int8): silu(GN1(x)) rounded to bf16 and resampled in f32, then
    quantized unrounded, with the static s1 or per sample (a / s_b); GN2 never
    folded; int8 sums exact (float64); the skip bf16 on the resampled x
    rounded to bf16, or with sx int8 on the resampled x quantized unrounded
    (``static_skip_product``). w1, w2: (int8 HWIO, scale) pairs; act_scales
    None, [s1, s2] or [s1, s2, sx] (w_skip then an (int8, scale) pair)."""
    check_act_scales(act_scales)
    kerns = transition_kerns(up, fir, fir_kernel)
    a1 = _bf16r(group_norm_tpu(x.float(), gn1_scale, gn1_bias, num_groups1, eps, True, False))
    h = resample_transition(a1, kerns, up)
    xr = resample_transition(_bf16r(x.float()), kerns, up)
    return _int8_block(h, xr, temb_projection(temb, dense_w, dense_b), w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_skip, b_skip, act_scales, num_groups2, eps,
                       skip_rescale, x.dtype, pair=False, fold2=False)


def resblock_train_bf16_reference(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                                  gn2_bias, w2, b2, w_skip, b_skip, mask, *, keep_prob: float,
                                  num_groups1: int, num_groups2: int, eps: float = 1e-6,
                                  skip_rescale: bool = True):
    """K6 with the card's rounding points, those of the TPU kernel with
    mm_dtype bf16 (``_resblock_kernel_v2`` with the dropout mask): a1 =
    bf16(silu(GN1 x)); h1 = conv1(a1, bf16 W1) + b1 + temb_proj in f32; d =
    bf16(silu(GN2 h1) * mask / keep_prob); out = (conv2(d, bf16 W2) + b2 +
    skip) * r in f32, the skip bf16 x @ bf16 W_skip + b_skip with f32 sums,
    or x itself in f32. GroupNorm statistics as the kernels take them
    (``gn_stats_reference``). Arguments as ``resblock_train_reference``'s."""
    x = x.float()
    sc1, sh1 = gn_stats_reference(x, num_groups1, eps, gn1_scale, gn1_bias)[:2]
    a1 = _bf16r(_conv_input(x, None, sc1, sh1, True))
    h1 = (conv3x3_nhwc(a1, _bf16r(w1.float()), b1.float())
          + temb_proj.float()[:, None, None, :])
    sc2, sh2 = gn_stats_reference(h1, num_groups2, eps, gn2_scale, gn2_bias)[:2]
    a2 = _conv_input(h1, None, sc2, sh2, True)
    if keep_prob < 1.0:
        a2 = a2 * (mask.float() * (1.0 / keep_prob))
    out = conv3x3_nhwc(_bf16r(a2), _bf16r(w2.float()), b2.float())
    if w_skip is None:
        out = out + x
    else:
        out = out + _bf16r(x) @ _bf16r(w_skip.float()) + b_skip.float()
    return out * _INV_SQRT2 if skip_rescale else out


def resblock_train_reference(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
                             w2, b2, w_skip, b_skip, mask, *, keep_prob: float,
                             num_groups1: int, num_groups2: int, eps: float = 1e-6,
                             skip_rescale: bool = True):
    """Plain version of K6 (gddim_tpu/ops/resblock.py:1673): one training
    block, dropout ``h * mask / keep_prob`` after GN2+SiLU with an explicit
    (B, H, W, Cout) {0, 1} mask (unused when keep_prob == 1). temb_proj is
    the (B, Cout) row silu(temb) @ Wd + bd; w_skip None: identity skip."""
    h = group_norm_silu_reference(x, gn1_scale, gn1_bias, num_groups1, eps)
    h = conv3x3_nhwc(h, w1, b1) + temb_proj.to(h.dtype)[:, None, None, :]
    h = group_norm_silu_reference(h, gn2_scale, gn2_bias, num_groups2, eps)
    if keep_prob < 1.0:
        h = h * (mask.to(h.dtype) * (1.0 / keep_prob))
    h = conv3x3_nhwc(h, w2, b2)
    skip = x if w_skip is None else (
        torch.einsum("bhwc,cd->bhwd", x, w_skip.to(x.dtype)) + b_skip.to(x.dtype))
    out = skip + h
    return out * _INV_SQRT2 if skip_rescale else out


# --------------------------------------------------------------------------
# CUDA path
# --------------------------------------------------------------------------

_VEC = 8  # the pre-passes and GN statistics read 8-channel vectors
SMS = 132  # the H100's streaming multiprocessors


def tile_box(b: int, h: int, w: int, rows: int):
    """(box_h, box_b, tiles_h, m_tiles) of M tiles of ``rows`` output pixels
    cut from (b, h, w) as one TMA box each: whole rows of one sample, or
    whole samples (the wgmma convs, K11 and the block GEMM)."""
    if h * w >= rows:  # whole rows of one sample
        box_b, box_h = 1, min(h, rows // w)
    else:  # whole samples
        box_b, box_h = min(rows // (h * w), 256), h
    tiles_h = -(-h // box_h)
    return box_h, box_b, tiles_h, tiles_h * -(-b // box_b)


# The block GEMM's tiling (csrc/block_gemm.cu): a K slice is 128 bytes a pixel
GEMM_TILE_M = 128  # output pixels of a tile (times mw)
GEMM_TILE_N = 128  # output channels of a tile
S8_SLICE = 128  # int8 channels of one tap in a conv K slice
BF16_SLICE = 64  # bf16 channels of one tap in a conv K slice
GEMM_SKIP_SLICE = 64  # bf16 channels in a skip K slice
GEMM_MIN_SPLIT_SLICES = 4  # K slices per split, at least
# the 256-pixel tiles' ring depth (Tile<2>::STAGES in csrc/block_gemm.cu): a
# GEMM of no more K slices (K5's 1x1 projections: 4 bf16, 2 int8) takes
# 128-pixel tiles, two CTAs an SM, so that one's epilogue overlaps the other's
# loads (chip_smoke.py times K5's projections at both widths)
GEMM_WIDE_STAGES = 4
# GN2's sums in conv1's epilogue reduce a warp's 16 tile rows as one
# sample's: a tile that may hold several samples (H*W <= GEMM_TILE_M) needs
# whole samples of a multiple of 16 pixels
GEMM_SAMPLE_ROWS = 16


def _gemm_takes(h: int, w: int, cin: int, cskip: int, n: int, slice_: int) -> bool:
    """Whether the block GEMM has a tile plan for a conv at (h, w) of cin
    channels in conv K slices of ``slice_`` (S8_SLICE or BF16_SLICE), a
    cskip-channel skip and n output channels: what ``_gemm_tile_plan``
    refuses otherwise."""
    return (cin % slice_ == 0 and cskip % GEMM_SKIP_SLICE == 0 and n % GEMM_TILE_N == 0
            and 0 < w <= GEMM_TILE_M
            and (h * w > GEMM_TILE_M or (h * w) % GEMM_SAMPLE_ROWS == 0))


def _block_takes(x_shape, parts, skip_parts, cout: int, int8: bool) -> bool:
    """Whether the card's block kernels take one residual block: conv1 of the
    parts' logical concat at x_shape's (H, W) -> cout, conv2 cout -> cout with
    the skip parts' 1x1 in its K (no skip parts: the identity residual):
    both convs' tile plans (``bf16_tile_plan``, bf16 or f32 activations, or
    ``s8_tile_plan``), each skip part in whole skip slices. The pre-pass and
    the statistics read 8-channel vectors of each part."""
    _, h, w, _ = x_shape
    cin, cskip = sum(parts), sum(skip_parts)
    if any(c % _VEC for c in parts) or (not skip_parts and cin != cout):
        return False
    slice_ = S8_SLICE if int8 else BF16_SLICE
    return (all(c % GEMM_SKIP_SLICE == 0 for c in skip_parts)
            and _gemm_takes(h, w, cin, 0, cout, slice_)
            and _gemm_takes(h, w, cout, cskip, cout, slice_))


def stride1_supported(x_shape, cout: int, int8: bool) -> bool:
    """Whether the card runs a stride-1 block (K2) on x (B, H, W, Cin) -> cout
    (the 1x1 skip where Cin != cout) in the bf16 mode (bf16 or f32
    activations) or the ``int8`` mode; the JAX package's
    ``resblock_ops.supported`` gate (gddim_tpu/models/blocks.py:351-358)
    with the port's tile plans."""
    c = x_shape[-1]
    return _block_takes(x_shape, (c,), () if c == cout else (c,), cout, int8)


def pair_supported(xa_shape, cb: int, cout: int, int8: bool) -> bool:
    """``stride1_supported`` of the up path's pair (K3): conv1 and the 1x1
    skip on the logical concat of xa (B, H, W, Ca) and a cb-channel xb."""
    ca = xa_shape[-1]
    return _block_takes(xa_shape, (ca, cb), (ca, cb), cout, int8)


def tail_supported(h_shape, cout: int, int8: bool) -> bool:
    """``stride1_supported`` of a transition's tail (K4) on the resampled h
    (B, H, W, C), its 1x1 skip on the resampled x."""
    c = h_shape[-1]
    return _block_takes(h_shape, (c,), (c,), cout, int8)


def train_supported(x_shape, cout: int) -> bool:
    """Whether K6/K7 take a stride-1 training block x (B, H, W, Cin) -> cout
    (``resblock_ops.supported`` at gddim_tpu/models/blocks.py:423, with the
    port's plans): every GEMM of the two has a block-GEMM tile plan (conv1
    Cin -> cout, conv2 cout -> cout with a Cin-channel 1x1 skip, the dgrads
    cout -> cout and cout -> Cin, the skip's 1x1 dgrad cout -> Cin) and both
    3x3 wgrads a ``wgrad_plan``."""
    _, h, w, cin = x_shape
    return (_gemm_takes(h, w, cin, 0, cout, BF16_SLICE)
            and _gemm_takes(h, w, cout, cin, cout, BF16_SLICE)
            and _gemm_takes(h, w, cout, 0, cin, BF16_SLICE)
            and _wgrad_takes(h, w, cin, 9, cout) and _wgrad_takes(h, w, cout, 9, cout))


# GN1 in one launch (csrc/gn_apply.cu, ``gn_apply_kernel``): a cluster of
# GN_APPLY_CTAS CTAs a sample, where an eighth of the sample fits a CTA's
# shared memory (every GN1 site of both configs does)
GN_APPLY_CTAS = 8
GN_APPLY_THREADS = 256  # a CTA: gn_stats_kernel's lanes
GN_APPLY_MAX_C = 2048
SMEM_BYTES = 227 * 1024  # shared memory a block can use on the H100


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def gn_apply_smem(c: int, pixels: int, resample: bool = False) -> int:
    """Shared memory of one ``gn_apply_kernel`` CTA holding ``pixels`` of c
    bf16 channels (``csrc/gn_apply.cu:ga_layout``): the share, in the
    resample variant its activation beside it, the channel sums and
    squares, gamma and beta, the pixel lanes' partial sums (then the
    affine), 256 bytes of maxima."""
    lanes = GN_APPLY_THREADS // (c // _VEC)
    raw = _align128(2 * pixels * c)
    return (raw * (2 if resample else 1) + 2 * _align128(8 * c) + _align128(4 * max(lanes, 2) * c)
            + 256)


def _resample_rows(hin: int, win: int, up: bool, ctas: int) -> int:
    """The most input rows a CTA of the resample variant holds
    (``csrc/gn_apply.cu:rs_rows``): those of its share of the statistics
    (the pixels [r hw / ctas, (r + 1) hw / ctas)) and those its output rows
    read, one halo row on each side."""
    hw, units = hin * win, hin if up else hin // 2
    most = 0
    for r in range(ctas):
        p0, p1 = hw * r // ctas, hw * (r + 1) // ctas
        lo, hi = p0 // win, -(-p1 // win)
        u0, u1 = units * r // ctas, units * (r + 1) // ctas
        if u1 > u0:
            nlo, nhi = (u0 - 1, u1 + 1) if up else (2 * u0 - 1, 2 * u1 + 1)
            lo, hi = min(lo, max(nlo, 0)), max(hi, min(nhi, hin))
        most = max(most, hi - lo)
    return most


def gn_apply_ctas(h: int, w: int, c: int, f32: bool = False) -> int:
    """The route of a GN1 site of an (h, w, c) sample (the logical concat's c
    channels): the cluster size of ``gn_apply_kernel`` (the statistics and
    the conv input, or K5's h, in one launch), or 0 for the two-launch route
    (``gn_stats_kernel``, then the pre-pass): f32 activations, a width the
    statistics do not take, or an eighth of the sample too large for a
    CTA's shared memory. A pure function of the shape, as the kernels'
    gates are."""
    if f32 or c % _VEC or not _VEC <= c <= GN_APPLY_MAX_C:
        return 0
    fits = gn_apply_smem(c, -(-(h * w) // GN_APPLY_CTAS)) <= SMEM_BYTES
    return GN_APPLY_CTAS if fits else 0


def gn_resample_ctas(hin: int, win: int, c: int, up: bool, f32: bool = False) -> int:
    """The route of K9's GN1 on an (hin, win, c) input: the cluster size of
    ``gn_apply_kernel``'s resample variant (8), or 0 for the two launches
    (``gn_stats_kernel``, then ``transition_resample_kernel``): f32
    activations, or rows too wide for shared memory."""
    if f32 or c % _VEC or not _VEC <= c <= GN_APPLY_MAX_C or hin % 2 or win % 2:
        return 0
    rows = _resample_rows(hin, win, up, GN_APPLY_CTAS)
    return GN_APPLY_CTAS if gn_apply_smem(c, rows * win, True) <= SMEM_BYTES else 0


# K1 (csrc/groupnorm.cu, ``gn_silu_kernel``): a cluster of 1-16 CTAs a
# sample holds it in shared memory
GN_SILU_THREADS = 256
GN_SILU_CLUSTERS = (1, 2, 4, 8, 16)
# bytes of the sample a CTA keeps, at least, where more CTAs a sample spread
# a small batch over the SMs
GN_SILU_MIN_SHARE = 16 * 1024


def gn_silu_vec(c: int, itemsize: int) -> int:
    """Channels of one of K1's vectors: 16 bytes (8 of bf16 or f16, 4 of
    f32) where they divide C, else one."""
    v = 16 // itemsize
    return v if c % v == 0 else 1


def gn_silu_smem(c: int, itemsize: int, share: int, hold: bool) -> int:
    """Shared memory of one K1 CTA over ``share`` pixels of c channels
    (``csrc/groupnorm.cu:gs_smem``): the share where held, the pixel lanes'
    per-channel sums, the channel totals, the folded affine and four
    per-group arrays (groups <= C), f32."""
    cv = c // gn_silu_vec(c, itemsize)
    lanes = GN_SILU_THREADS // cv if cv <= GN_SILU_THREADS else 1
    return (_align128(share * c * itemsize) if hold else 0) + 4 * c * (lanes + 7)


def gn_silu_ctas(b: int, h: int, w: int, c: int, itemsize: int) -> int:
    """K1's cluster size on (b, h, w, c) of ``itemsize``-byte values: the
    fewest of GN_SILU_CLUSTERS whose CTAs hold the sample in shared memory,
    doubled while b * ctas leaves half the SMs idle and each CTA keeps
    GN_SILU_MIN_SHARE bytes; 16 where none holds it (``gn_silu_holds``
    then says no and the kernel reads x again). A pure function of the
    shape and the dtype."""
    hw = h * w
    held = [k for k in GN_SILU_CLUSTERS
            if gn_silu_smem(c, itemsize, -(-hw // k), True) <= SMEM_BYTES]
    if not held:
        return GN_SILU_CLUSTERS[-1]
    k = held[0]
    while (k < GN_SILU_CLUSTERS[-1] and b * k < SMS // 2
           and hw * c * itemsize >= 2 * k * GN_SILU_MIN_SHARE):
        k *= 2
    return k


def gn_silu_holds(h: int, w: int, c: int, itemsize: int, ctas: int) -> bool:
    """Whether ``ctas`` K1 CTAs hold an (h, w, c) sample in shared memory."""
    return gn_silu_smem(c, itemsize, -(-(h * w) // ctas), True) <= SMEM_BYTES


class GemmPlan(NamedTuple):
    """How ``block_gemm_kernel`` cuts one conv (+ skip). A tile is mw *
    GEMM_TILE_M output pixels, one A box of W pixels x box_h rows x box_b
    samples; M tile t covers samples [t // tiles_h * box_b, ... + box_b) and
    rows [t % tiles_h * box_h, ... + box_h); the grid's N tiles are Cout /
    GEMM_TILE_N. K runs in conv_slices slices of S8_SLICE int8 or
    BF16_SLICE bf16 channels (taps * Cin in tap order: 9 taps for a 3x3
    conv, 1 for a 1x1 projection), then skip_slices bf16
    slices of GEMM_SKIP_SLICE, ``kper`` to a split, over ``splits`` splits.
    The ring's depth and shared memory follow from mw in the kernel
    (``Tile``)."""

    mw: int
    box_h: int
    box_b: int
    tiles_h: int
    m_tiles: int
    conv_slices: int
    skip_slices: int
    splits: int
    kper: int


@functools.lru_cache(maxsize=None)
def _gemm_tile_plan(b: int, h: int, w: int, cin: int, cskip: int, n: int, slice_: int,
                    taps: int) -> GemmPlan:
    if not _gemm_takes(h, w, cin, cskip, n, slice_) or taps not in (1, 9):
        what = "int8" if slice_ == S8_SLICE else "bf16"
        raise ValueError(f"{what} block GEMM: no tile plan for x {(b, h, w, cin)}, skip "
                         f"{cskip}, Cout {n}, {taps} taps (Cin a multiple of {slice_}, the skip "
                         f"of {GEMM_SKIP_SLICE}, Cout of {GEMM_TILE_N}, W at most {GEMM_TILE_M}, "
                         f"H*W above {GEMM_TILE_M} or a multiple of {GEMM_SAMPLE_ROWS}, taps 1 "
                         "or 9)")
    n_tiles = n // GEMM_TILE_N
    conv_slices, skip_slices = taps * cin // slice_, cskip // GEMM_SKIP_SLICE
    slices = conv_slices + skip_slices
    wide = tile_box(b, h, w, 2 * GEMM_TILE_M)[3] * n_tiles >= SMS - 4
    mw = 2 if wide and slices > GEMM_WIDE_STAGES else 1
    box_h, box_b, tiles_h, m_tiles = tile_box(b, h, w, mw * GEMM_TILE_M)
    splits = max(1, min(SMS // (m_tiles * n_tiles), slices // GEMM_MIN_SPLIT_SLICES))
    kper = -(-slices // splits)
    return GemmPlan(mw, box_h, box_b, tiles_h, m_tiles, conv_slices, skip_slices,
                    -(-slices // kper), kper)


# K7's weight gradients (wgrad_kernel, csrc/resblock_bwd.cu): a K slice is
# WGRAD_PIX pixels, one TMA box of whole rows of a sample or whole samples; a
# CTA holds 2 * mw m64 blocks of dW rows (64 channels of one tap each) by
# GEMM_TILE_N columns
WGRAD_PIX = 64
WGRAD_MIN_SPLIT_SLICES = 4  # pixel slices a split, at least


class WgradPlan(NamedTuple):
    """How ``wgrad_kernel`` cuts one weight gradient: CTAs of 2 * mw m64
    blocks of dW rows (mw 2: a 4-stage ring, one CTA an SM; mw 1: 3 stages,
    two), an A box of W pixels x box_h rows x box_b samples (WGRAD_PIX
    pixels), and the pixel slices in ``splits`` splits of ``per``."""

    mw: int
    box_h: int
    box_b: int
    splits: int
    per: int


def _wgrad_takes(h: int, w: int, c: int, taps: int, n: int) -> bool:
    """Whether ``wgrad_kernel`` has a plan for the (taps * c, n) weight
    gradient at (h, w): channels in 64-channel blocks, an even number of
    them (a CTA's two warpgroups), n in GEMM_TILE_N columns, WGRAD_PIX
    pixels whole rows of a sample or whole samples."""
    hw = h * w
    return (c % 64 == 0 and (taps * c) % 128 == 0 and n % GEMM_TILE_N == 0 and taps in (1, 9)
            and 0 < w and WGRAD_PIX % w == 0 and (hw % WGRAD_PIX == 0 or WGRAD_PIX % hw == 0))


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, h: int, w: int, c: int, taps: int, n: int) -> WgradPlan:
    """The wgrad kernel's plan for dW (taps * c, n) over a (b, h, w, c)
    activation: a pure function of the shapes. 256 dW rows a CTA (mw 2)
    where they divide taps * c, else 128 (mw 1, two CTAs an SM); the pixels
    split while the CTAs leave the card's resident slots idle, at least
    WGRAD_MIN_SPLIT_SLICES slices a split, the CTAs within one wave of
    resident slots. Raises for shapes the kernel does not take
    (``_wgrad_takes``)."""
    if not _wgrad_takes(h, w, c, taps, n):
        raise ValueError(f"wgrad: no plan for a {(b, h, w, c)} activation, {taps} taps, N {n} "
                         f"(C a multiple of 64, taps * C of 128, N of {GEMM_TILE_N}, W dividing "
                         f"{WGRAD_PIX}, H*W a multiple or a divisor of {WGRAD_PIX}, taps 1 or 9)")
    blocks = taps * c // 64
    mw = 2 if blocks % 4 == 0 else 1
    box_h, box_b = tile_box(b, h, w, WGRAD_PIX)[:2]
    ctas = blocks // (2 * mw) * (n // GEMM_TILE_N)
    slices = -(-(b * h * w) // WGRAD_PIX)
    resident = SMS * (3 - mw)
    # one wave: a split more than the slots hold would leave most SMs idle
    # while a second wave of a few CTAs runs
    splits = max(1, min(resident // ctas, slices // WGRAD_MIN_SPLIT_SLICES))
    per = -(-slices // splits)
    return WgradPlan(mw, box_h, box_b, -(-slices // per), per)


# K7's GroupNorm(+SiLU) backward (csrc/resblock_bwd.cu, ``gn_bwd_kernel``):
# a cluster of 1-16 CTAs a sample holds dpre and v (f32) of its pixels in
# shared memory for the backward's two passes
GN_BWD_THREADS = 256
GN_BWD_CLUSTERS = (1, 2, 4, 8, 16)
GN_BWD_PAIR_BYTES = 113 * 1024  # shared memory of a CTA where two share an SM
GN_BWD_MAX_GROUPS = 32
GN_BWD_MIN_SHARE = 8  # pixels a CTA, at least, where the sample has them


class GnBwdPlan(NamedTuple):
    """How ``gn_bwd_kernel`` covers one (h, w, c) sample: a cluster of
    ``ctas`` CTAs, CTA r over the pixels [r hw / ctas, (r + 1) hw / ctas)
    (``share`` at most), each holding the first ``held`` of its pixels in
    ``smem`` bytes of shared memory and reading the rest from device memory
    in both passes."""

    ctas: int
    share: int
    held: int
    smem: int


def gn_bwd_smem(c: int, held: int) -> int:
    """Shared memory of one ``gn_bwd_kernel`` CTA holding ``held`` pixels of
    c channels (``csrc/resblock_bwd.cu:gb_layout``): dpre (then dy) and v in
    f32, the CTA's four per-channel sums, the pixel lanes' buffer, the
    groups' two means (GN_BWD_MAX_GROUPS at most)."""
    lanes = GN_BWD_THREADS // (c // _VEC)
    return (2 * _align128(4 * held * c) + _align128(16 * c) + _align128(4 * max(lanes, 2) * c)
            + _align128(8 * GN_BWD_MAX_GROUPS))


def _gn_bwd_most_held(c: int, budget: int = SMEM_BYTES) -> int:
    """The most pixels a CTA holds within ``budget`` bytes of shared memory."""
    return max(0, ((budget - gn_bwd_smem(c, 0)) // 2 // 128 * 128) // (4 * c))


@functools.lru_cache(maxsize=None)
def gn_bwd_plan(b: int, h: int, w: int, c: int, ctas: int | None = None,
                held: int | None = None) -> GnBwdPlan:
    """The GN backward's cluster plan for a (b, h, w, c) tensor: a pure
    function of the shapes. The smallest cluster that gives the batch a CTA
    for each SM, of GN_BWD_MIN_SHARE pixels a CTA at least (one wave at two
    CTAs an SM: larger clusters and more waves measured slower on the H100,
    chip_smoke.py's gn_bwd_plans phase), each CTA holding what
    GN_BWD_PAIR_BYTES hold of its share and reading the rest from device
    memory in both passes. ``ctas`` (and ``held``) pin another plan, to
    measure it. Raises for shapes the kernel does not take."""
    hw = h * w
    if c % _VEC or not _VEC <= c <= _VEC * GN_BWD_THREADS:
        raise ValueError(f"gn_bwd: no plan for {c} channels (a multiple of {_VEC}, at most "
                         f"{_VEC * GN_BWD_THREADS})")
    takes = [k for k in GN_BWD_CLUSTERS if k <= hw and c % k == 0]
    if ctas is None:
        fit = [k for k in takes if k * GN_BWD_MIN_SHARE <= hw] or takes[:1]
        ctas = next((k for k in fit if b * k >= SMS), fit[-1])
    if ctas not in takes:
        raise ValueError(f"gn_bwd: no cluster of {ctas} CTAs for {hw} pixels of {c} channels")
    share = -(-hw // ctas)
    most = _gn_bwd_most_held(c)
    if held is None:
        held = min(share, max(1, _gn_bwd_most_held(c, GN_BWD_PAIR_BYTES)))
    if not 0 < held <= min(share, most):
        raise ValueError(f"gn_bwd: {held} pixels held of a {share}-pixel share ({most} fit)")
    return GnBwdPlan(ctas, share, held, gn_bwd_smem(c, held))


def s8_tile_plan(b: int, h: int, w: int, cin: int, cskip: int, n: int,
                 taps: int = 9) -> GemmPlan:
    """The int8 block GEMM's plan for a (b, h, w, cin) x (3, 3, cin, n) conv
    (or, taps 1, a (cin, n) 1x1 projection) with a cskip-channel bf16 skip:
    a pure function of the shapes, K11's rules (``ops/conv3x3.py:tile_plan``):
    tiles of 256 pixels where they alone make a wave of at least 128 CTAs
    and K has more slices than their ring has stages, else of 128, with K
    split while the tiles leave half the SMs idle. Raises for shapes the
    kernel does not take (``_gemm_takes``)."""
    return _gemm_tile_plan(b, h, w, cin, cskip, n, S8_SLICE, taps)


def bf16_tile_plan(b: int, h: int, w: int, cin: int, cskip: int, n: int,
                   taps: int = 9) -> GemmPlan:
    """The bf16 block GEMM's plan, by the rules of ``s8_tile_plan``, with
    conv K slices of BF16_SLICE channels (Cin a multiple of 64)."""
    return _gemm_tile_plan(b, h, w, cin, cskip, n, BF16_SLICE, taps)


@functools.lru_cache(maxsize=None)
def _plan_gemm(entry: str, b: int, h: int, w: int, cin: int, cskip: int, n: int, int8: bool,
               f32: bool = False, static_skip: bool = False):
    """(M tiling, (splits1, kper1, splits2, kper2), workspace bytes) of one
    block on the block GEMM through ``entry`` (gddim_resblock, which K6's
    gddim_resblock_train shares, gddim_resblock_int8 or the transition's):
    conv1 (cin -> n) and conv2 (n -> n, + the cskip-channel skip) share the M
    tiling; the workspace holds GN2's partial sums, conv1's tiles_h rows a
    sample, and on ``f32`` activations (gddim_resblock) the skip's bf16
    copy. ``static_skip`` (the int8 entries): conv2's K split is that of its
    conv slices alone, the skip's cskip / 128 int8 slices join its last
    split (``static_skip_slices``), and gddim_resblock_int8's workspace
    holds the skip's int8 input q(x) (the transition's holds q(xr) in place
    of its bf16 xr)."""
    plan = s8_tile_plan if int8 else bf16_tile_plan
    p1, p2 = plan(b, h, w, cin, 0, n), plan(b, h, w, n, 0 if static_skip else cskip, n)
    tiles = (p1.mw, p1.box_h, p1.box_b, p1.tiles_h, p1.m_tiles)
    if entry == "gddim_resblock":
        extra = (cskip if f32 else 0,)
    else:
        extra = (cskip if static_skip else 0,) if entry == "gddim_resblock_int8" else ()
    nbytes = _build.workspace_bytes(entry, b, h, w, cin, n, max(p1.splits, p2.splits),
                                    p1.tiles_h, *extra)
    return tiles, (p1.splits, p1.kper, p2.splits, p2.kper), nbytes


def static_skip_slices(plan: GemmPlan, cskip: int) -> list:
    """(conv slices, int8 skip slices) of each split of conv2 with the static
    skip, as block_gemm_kernel (SK8) runs them: ``plan`` splits the conv
    slices alone, and the skip's cskip / S8_SLICE slices all join the last
    split, so that their int32 sums are converted once and every other
    split's partial is the conv's own."""
    if cskip <= 0 or cskip % S8_SLICE:
        raise ValueError(f"static skip: {cskip} channels (a multiple of {S8_SLICE})")
    conv = [min(plan.kper, plan.conv_slices - z * plan.kper) for z in range(plan.splits)]
    return [(c, cskip // S8_SLICE if z == plan.splits - 1 else 0) for z, c in enumerate(conv)]


def _static_skip_weights(op, w_skip, cskip: int, n: int, what: str):
    """The static skip's C arguments (ws, wss): its int8 weights K-major
    (Cout, cskip) (a copy unless ``pack_skip_int8`` stored them so) and
    their scales."""
    wq, wsc = w_skip
    if tuple(wq.shape) != (cskip, n) or cskip % S8_SLICE:
        raise ValueError(f"{what}: static skip weights {tuple(wq.shape)}, want {(cskip, n)} "
                         f"(Cin a multiple of {S8_SLICE})")
    return [op(wq.t(), "skip int8", torch.int8, (n, cskip)), op(wsc, "skip scales",
                                                                torch.float32, (n,))]


def _skip_views(buffers: dict, entry: str, work, shape, cskip: int, args) -> None:
    """The int8 entries' ``skip_buffers`` on CUDA: "xq", the static skip's
    int8 input (*shape, cskip) as the kernels left it, a view of the
    launch's workspace ``work`` (``args`` its ``_workspace`` arguments)."""
    o = _build.xq_offset(entry, *args)
    buffers["xq"] = work[o:o + math.prod(shape) * cskip].view(torch.int8).view(*shape, cskip)


def require_no_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would hand autograd an output
    with no history: grad mode on and some input requiring grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; call it under "
                           "torch.no_grad() or inference_mode, or use the training path")


def _temb_row(temb, dense_w, dense_b, b: int, n: int):
    """(row, ld): a block's (B, N) f32 temb projection on the card and its
    row stride: temb itself with dense_w None (the model's column slice of
    its per-eval product), else silu(temb) @ dense_w + dense_b."""
    row = temb_projection(temb, dense_w, dense_b)
    if row.stride(-1) != 1:
        row = row.contiguous()
    if row.device.type != "cuda" or tuple(row.shape) != (b, n):
        raise ValueError(f"temb row: needs a CUDA tensor of shape {(b, n)}, got "
                         f"{tuple(row.shape)} on {row.device}")
    return row, row.stride(0)


def _operand(t, what, dtype, shape=None):
    """t as a contiguous CUDA tensor of ``dtype`` (cast if need be), or None."""
    if t is None:
        return None
    t = t.to(dtype).contiguous()
    if t.device.type != "cuda" or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{what}: needs a CUDA tensor of shape {shape}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def activation_dtype(x, what: str, int8: bool):
    """x's dtype where the CUDA kernels take it: bf16 or f32 (the bf16 modes,
    which write x's dtype), bf16 only (the int8 modes); raises otherwise."""
    ok = (torch.bfloat16,) if int8 else (torch.bfloat16, torch.float32)
    if x.dtype not in ok:
        raise ValueError(f"{what}: takes {' or '.join(map(str, ok))} activations on CUDA, "
                         f"got {x.dtype}")
    return x.dtype


def _block_cuda(parts, temb, dense_w, dense_b, gn1, w1, b1, gn2_scale, gn2_bias, w2, b2,
                skip_parts, w_skip, b_skip, *, num_groups2, eps, skip_rescale, int8=False,
                act_scales=None, skip_buffers=None):
    """One block through gddim_resblock (bf16 or f32 activations, the block
    GEMM), or gddim_resblock_int8 when int8 (w1, w2 then (int8 weights, scale) pairs;
    act_scales None, [s1, s2] or [s1, s2, sx]: with sx and skip parts, the
    static skip, w_skip an (int8, scale) pair). gn1: (scale, bias, groups), or None (K4);
    skip_parts None: identity residual parts[0]; temb with dense_w None: the
    (B, Cout) temb row. The activations and the output take parts[0]'s dtype
    (bf16 or f32; bf16 only when int8). skip_buffers (the static skip): a
    dict that receives ``_skip_views``."""
    convs = [*w1, *w2] if int8 else [w1, w2]
    sx = int8 and check_act_scales(act_scales) and skip_parts is not None
    if skip_buffers is not None and not sx:
        raise ValueError("skip_buffers: needs the static skip (act_scales [s1, s2, sx], a 1x1 skip)")
    skips = skip_int8(w_skip, "resblock int8 kernel") if sx else [w_skip]
    require_no_grad("resblock kernel", *parts, temb, dense_w, dense_b, *(gn1 or ())[:2], *convs,
                    b1, gn2_scale, gn2_bias, b2, *(skip_parts or ()), *skips, b_skip)
    bf16, f32 = torch.bfloat16, torch.float32
    act = activation_dtype(parts[0], "resblock int8 kernel" if int8 else "resblock kernel", int8)
    b, h, w, _ = parts[0].shape
    xs = [_operand(p, "resblock input", act, (b, h, w, p.shape[-1])) for p in parts] + [None]
    # a skip part that is an input part is the same operand (the f32 blocks'
    # pre-pass writes the skip's bf16 copy from the input it reads)
    same = {id(q): x for q, x in zip(parts, xs)}
    ss = [same[id(p)] if id(p) in same else _operand(p, "skip input", act, (b, h, w, p.shape[-1]))
          for p in skip_parts or ()] + [None, None]
    c0, c1 = (p.shape[-1] if p is not None else 0 for p in xs[:2])
    cs0, cs1 = (p.shape[-1] if p is not None else 0 for p in ss[:2])
    cin, n = c0 + c1, (w1[1] if int8 else w1).shape[-1]
    if any(c % _VEC for c in (c0, c1)) or cs0 % GEMM_SKIP_SLICE or cs1 % GEMM_SKIP_SLICE:
        raise ValueError(f"resblock: unsupported channels {c0}+{c1} (skip {cs0}+{cs1}) -> {n}")
    if skip_parts is None and cin != n:
        raise ValueError("resblock: identity skip needs Cin == Cout")
    f32_act = act == f32
    entry = "gddim_resblock" + ("_int8" if int8 else "")
    tiles, splits, nbytes = _plan_gemm(entry, b, h, w, cin, cs0 + cs1, n, int8, f32_act, sx)
    plan = [*tiles, *splits]
    row, ld = _temb_row(temb, dense_w, dense_b, b, n)
    gn1 = gn1 or (None, None, 0)
    skip = skip_parts is not None
    keep = []  # operands stay referenced until the launch: a cast's temporary must not be freed

    def op(t, what, dtype, shape=None):
        keep.append(_operand(t, what, dtype, shape))
        return _build.ptr(keep[-1])

    def conv(wt, what, shape):  # bf16 weights, or int8 weights and their scales
        if not int8:
            return [op(wt, what, bf16, shape)]
        return [op(kmajor_int8(wt[0], shape, what), what, torch.int8),
                op(wt[1], f"{what} scales", f32, shape[-1:])]

    args = [
        _build.ptr(xs[0]), _build.ptr(xs[1]), c0, c1, *(() if int8 else (int(f32_act),)),
        row.data_ptr(), ld,
        op(gn1[0], "gn1 scale", f32, (cin,)), op(gn1[1], "gn1 bias", f32, (cin,)),
        gn1[2], *conv(w1, "conv1", (3, 3, cin, n)), op(b1, "b1", f32, (n,)),
        op(gn2_scale, "gn2 scale", f32, (n,)), op(gn2_bias, "gn2 bias", f32, (n,)), num_groups2,
        *conv(w2, "conv2", (3, 3, n, n)), op(b2, "b2", f32, (n,)),
        _build.ptr(ss[0]), _build.ptr(ss[1]), cs0, cs1,
    ]
    if sx:
        ws, wss = _static_skip_weights(op, w_skip, cs0 + cs1, n, entry)
        args += [ws, op(b_skip, "b_skip", f32, (n,)), wss]
    else:
        args += [op(w_skip, "skip", bf16, (cs0 + cs1, n)) if skip else None,
                 op(b_skip, "b_skip", f32, (n,)) if skip else None]
        args += [None] if int8 else []
    if int8:
        args.append(op(None if act_scales is None else act_scales[:3 if sx else 2],
                       "act scales", f32, (3 if sx else 2,)))
    # GN1's route: one launch, or the statistics then the pre-pass
    plan.append(gn_apply_ctas(h, w, cin, f32_act) if gn1[2] else 0)
    dev = xs[0].device
    work = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    out = torch.empty((b, h, w, n), device=dev, dtype=act)
    _build.launch(entry, dev, *args, b, h, w, n, eps, _INV_SQRT2 if skip_rescale else 1.0,
                  work.data_ptr(), *plan, out.data_ptr())
    if skip_buffers is not None:
        _skip_views(skip_buffers, entry, work, (b, h, w), cs0 + cs1,
                    (b, h, w, cin, n, max(splits[0], splits[2]), tiles[3], cs0 + cs1))
    return out


def kmajor_int8(wq, hwio_shape, what: str):
    """wq, the int8 weights of a conv of HWIO shape ``hwio_shape``, checked
    to be K-major (Cout, 9 * Cin) as the int8 block GEMM reads them; raises
    on any other layout (HWIO included): the model packs them once
    (``pack_int8_weight``)."""
    kshape = (hwio_shape[-1], 9 * hwio_shape[-2])
    if tuple(wq.shape) != kshape:
        raise ValueError(f"{what}: the int8 block kernels take K-major int8 weights {kshape} "
                         f"(pack_int8_weight), got {tuple(wq.shape)}")
    return wq


def _on_cpu(x, what):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


def fused_resblock(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                   gn2_bias, w2, b2, w_skip=None, b_skip=None, *, num_groups1: int,
                   num_groups2: int, eps: float = 1e-6, skip_rescale: bool = True):
    """K2: one stride-1 block (identity skip when w_skip is None)."""
    args = (x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
            w2, b2, w_skip, b_skip)
    if _on_cpu(x, "fused_resblock"):
        return resblock_reference(*args, num_groups1=num_groups1, num_groups2=num_groups2,
                                  eps=eps, skip_rescale=skip_rescale)
    out = _block_cuda([x], temb, dense_w, dense_b, (gn1_scale, gn1_bias, num_groups1), w1,
                      b1, gn2_scale, gn2_bias, w2, b2, None if w_skip is None else [x],
                      w_skip, b_skip,
                      num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    fused_resblock.launches += 1
    return out


def fused_resblock_pair(xa, xb, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                        gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, *, num_groups1: int,
                        num_groups2: int, eps: float = 1e-6, skip_rescale: bool = True):
    """K3: K2 on concat(xa, xb) without building the concat; w_skip (c1+c2, Cout)."""
    if _on_cpu(xa, "fused_resblock_pair"):
        return resblock_pair_reference(
            xa, xb, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale,
            gn2_bias, w2, b2, w_skip, b_skip, num_groups1=num_groups1,
            num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    out = _block_cuda([xa, xb], temb, dense_w, dense_b, (gn1_scale, gn1_bias, num_groups1),
                      w1, b1, gn2_scale, gn2_bias, w2, b2, [xa, xb], w_skip, b_skip,
                      num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    fused_resblock_pair.launches += 1
    return out


def fused_resblock_tail(h, x_skip, temb, dense_w, dense_b, w1, b1, gn2_scale, gn2_bias,
                        w2, b2, w_skip, b_skip, *, num_groups2: int, eps: float = 1e-6,
                        skip_rescale: bool = True):
    """K4: the transition tail; h = silu(GN1(x)) after the resample, x_skip the
    resampled block input, w_skip (C, Cout) required."""
    if _on_cpu(h, "fused_resblock_tail"):
        return resblock_tail_reference(
            h, x_skip, temb, dense_w, dense_b, w1, b1, gn2_scale, gn2_bias, w2, b2,
            w_skip, b_skip, num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    out = _block_cuda([h], temb, dense_w, dense_b, None, w1, b1, gn2_scale, gn2_bias, w2,
                      b2, [x_skip], w_skip, b_skip, num_groups2=num_groups2, eps=eps,
                      skip_rescale=skip_rescale)
    fused_resblock_tail.launches += 1
    return out


def fused_resblock_int8(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                        gn2_bias, w2, b2, w_skip=None, b_skip=None, act_scales=None, *,
                        num_groups1: int, num_groups2: int, eps: float = 1e-6,
                        skip_rescale: bool = True, skip_buffers: dict | None = None):
    """K2's int8 mode (see resblock_int8_reference for the arguments; with
    sx, act_scales [s1, s2, sx], and a 1x1 skip, the static skip: w_skip an
    (int8 (Cin, Cout), scale) pair, pack_skip_int8's on CUDA to copy nothing).
    skip_buffers (the static skip only): a dict that receives "xq", the
    skip's int8 input (B, H, W, Cin), as the kernels left it in their
    workspace (on the CPU the plain version's), for checks."""
    args = (x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
            w2, b2, w_skip, b_skip, act_scales)
    kw = dict(num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    if _on_cpu(x, "fused_resblock_int8"):
        if skip_buffers is not None:
            _plain_skip_buffers(skip_buffers, x, w_skip, act_scales)
        return resblock_int8_reference(*args, num_groups1=num_groups1, **kw)
    out = _block_cuda([x], temb, dense_w, dense_b, (gn1_scale, gn1_bias, num_groups1), w1, b1,
                      gn2_scale, gn2_bias, w2, b2, None if w_skip is None else [x], w_skip,
                      b_skip, int8=True, act_scales=act_scales, skip_buffers=skip_buffers, **kw)
    fused_resblock_int8.launches += 1
    return out


def fused_resblock_pair_int8(xa, xb, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                             gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, act_scales=None, *,
                             num_groups1: int, num_groups2: int, eps: float = 1e-6,
                             skip_rescale: bool = True, skip_buffers: dict | None = None):
    """K3's int8 mode: K2's on concat(xa, xb) without building the concat
    (with sx both halves quantized by it into one int8 skip input;
    skip_buffers as K2's, "xq" of the concat)."""
    kw = dict(num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    if _on_cpu(xa, "fused_resblock_pair_int8"):
        if skip_buffers is not None:
            _plain_skip_buffers(skip_buffers, torch.cat([xa, xb], -1), w_skip, act_scales)
        return resblock_pair_int8_reference(
            xa, xb, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
            w2, b2, w_skip, b_skip, act_scales, num_groups1=num_groups1, **kw)
    out = _block_cuda([xa, xb], temb, dense_w, dense_b, (gn1_scale, gn1_bias, num_groups1),
                      w1, b1, gn2_scale, gn2_bias, w2, b2, [xa, xb], w_skip, b_skip,
                      int8=True, act_scales=act_scales, skip_buffers=skip_buffers, **kw)
    fused_resblock_pair_int8.launches += 1
    return out


def fused_resblock_tail_int8(h, x_skip, temb, dense_w, dense_b, w1, b1, gn2_scale, gn2_bias,
                             w2, b2, w_skip, b_skip, act_scales=None, *, num_groups2: int,
                             eps: float = 1e-6, skip_rescale: bool = True,
                             skip_buffers: dict | None = None):
    """K4's int8 mode: the transition tail on h = silu(GN1(x)) resampled
    (with sx, x_skip quantized by it; skip_buffers as K2's)."""
    kw = dict(num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    if _on_cpu(h, "fused_resblock_tail_int8"):
        if skip_buffers is not None:
            _plain_skip_buffers(skip_buffers, x_skip, w_skip, act_scales)
        return resblock_tail_int8_reference(h, x_skip, temb, dense_w, dense_b, w1, b1,
                                            gn2_scale, gn2_bias, w2, b2, w_skip, b_skip,
                                            act_scales, **kw)
    out = _block_cuda([h], temb, dense_w, dense_b, None, w1, b1, gn2_scale, gn2_bias, w2, b2,
                      [x_skip], w_skip, b_skip, int8=True, act_scales=act_scales,
                      skip_buffers=skip_buffers, **kw)
    fused_resblock_tail_int8.launches += 1
    return out


def _transition_cuda(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                     gn2_bias, w2, b2, w_skip, b_skip, act_scales, *, up, fir, fir_kernel,
                     num_groups1, num_groups2, eps, skip_rescale, int8, skip_buffers=None):
    """K9 through gddim_resblock_transition (bf16 or f32 x, the block GEMM), or
    gddim_resblock_transition_int8 (w1, w2 then (int8 weights, scale) pairs;
    act_scales None, [s1, s2] or [s1, s2, sx]: the static skip, w_skip an
    (int8, scale) pair; skip_buffers a dict that receives ``_skip_views``)."""
    convs = [*w1, *w2] if int8 else [w1, w2]
    sx = int8 and check_act_scales(act_scales)
    if skip_buffers is not None and not sx:
        raise ValueError("skip_buffers: needs the static skip (act_scales [s1, s2, sx], a 1x1 skip)")
    skips = skip_int8(w_skip, "resblock transition int8 kernel") if sx else [w_skip]
    require_no_grad("resblock transition kernel", x, temb, dense_w, dense_b, gn1_scale, gn1_bias,
                    *convs, b1, gn2_scale, gn2_bias, b2, *skips, b_skip)
    what = "fused_resblock_transition" + ("_int8" if int8 else "")
    bf16, f32 = torch.bfloat16, torch.float32
    act = activation_dtype(x, what, int8)
    b, hin, win, cin = x.shape
    n = (w1[1] if int8 else w1).shape[-1]
    if w_skip is None or not transition_supported(x.shape, n, up, fir, fir_kernel, int8):
        raise ValueError(f"{what}: unsupported block {tuple(x.shape)} -> {n} (the 1x1 skip is "
                         "required; channels in whole GEMM tiles, even H and W)")
    ho, wo = (2 * hin, 2 * win) if up else (hin // 2, win // 2)
    kh, kw = transition_kerns(up, fir, fir_kernel)
    f32_act = act == f32
    entry = "gddim_resblock_transition" + ("_int8" if int8 else "")
    tiles, splits, nbytes = _plan_gemm(entry, b, ho, wo, cin, cin, n, int8, False, sx)
    plan = (*tiles, *splits, gn_resample_ctas(hin, win, cin, up, f32_act))
    row, ld = _temb_row(temb, dense_w, dense_b, b, n)
    keep = []  # operands stay referenced until the launch: a cast's temporary must not be freed

    def op(t, what_, dtype, shape=None):
        keep.append(_operand(t, what_, dtype, shape))
        return _build.ptr(keep[-1])

    def conv(wt, what_, shape):  # bf16 weights, or int8 weights and their scales
        if not int8:
            return [op(wt, what_, bf16, shape)]
        return [op(kmajor_int8(wt[0], shape, what_), what_, torch.int8),
                op(wt[1], f"{what_} scales", f32, shape[-1:])]

    args = [
        op(x, "x", act, (b, hin, win, cin)), cin, *(() if int8 else (int(f32_act),)),
        row.data_ptr(), ld,
        op(gn1_scale, "gn1 scale", f32, (cin,)),
        op(gn1_bias, "gn1 bias", f32, (cin,)), num_groups1, *conv(w1, "conv1", (3, 3, cin, n)),
        op(b1, "b1", f32, (n,)), op(gn2_scale, "gn2 scale", f32, (n,)),
        op(gn2_bias, "gn2 bias", f32, (n,)), num_groups2, *conv(w2, "conv2", (3, 3, n, n)),
        op(b2, "b2", f32, (n,)),
    ]
    if sx:
        ws, wss = _static_skip_weights(op, w_skip, cin, n, what)
        args += [ws, op(b_skip, "b_skip", f32, (n,)), wss]
    else:
        args += [op(w_skip, "skip", bf16, (cin, n)), op(b_skip, "b_skip", f32, (n,))]
        args += [None] if int8 else []
    if int8:
        args.append(op(None if act_scales is None else act_scales[:3 if sx else 2],
                       "act scales", f32, (3 if sx else 2,)))
    work = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    out = torch.empty((b, ho, wo, n), device=x.device, dtype=act)
    _build.launch(entry, x.device, *args, b, hin, win, int(up), *kh, *kw, n, eps,
                  _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(), *plan, out.data_ptr())
    if skip_buffers is not None:
        _skip_views(skip_buffers, entry, work, (b, ho, wo), cin,
                    (b, ho, wo, cin, n, max(splits[0], splits[2]), tiles[3]))
    return out


def fused_resblock_transition(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                              gn2_bias, w2, b2, w_skip, b_skip, *, up: bool, fir: bool = True,
                              fir_kernel=(1, 3, 3, 1), num_groups1: int, num_groups2: int,
                              eps: float = 1e-6, skip_rescale: bool = True):
    """K9: one up (``up``) or down transition block on x before the resample;
    w_skip (C, Cout) required. Writes x's dtype (bf16 or f32). A shape that
    ``transition_supported`` refuses raises on CUDA."""
    kw = dict(up=up, fir=fir, fir_kernel=fir_kernel, num_groups1=num_groups1,
              num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    args = (x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2,
            w_skip, b_skip)
    if _on_cpu(x, "fused_resblock_transition"):
        return resblock_transition_reference(*args, **kw)
    out = _transition_cuda(*args, None, int8=False, **kw)
    fused_resblock_transition.launches += 1
    return out


def fused_resblock_transition_int8(x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1,
                                   gn2_scale, gn2_bias, w2, b2, w_skip, b_skip, act_scales=None,
                                   *, up: bool, fir: bool = True, fir_kernel=(1, 3, 3, 1),
                                   num_groups1: int, num_groups2: int, eps: float = 1e-6,
                                   skip_rescale: bool = True, skip_buffers: dict | None = None):
    """K9's int8 mode (see resblock_transition_int8_reference for the
    arguments); bf16 x on CUDA. With sx (act_scales [s1, s2, sx]) the
    static skip: w_skip an (int8 (Cin, Cout), scale) pair (pack_skip_int8);
    skip_buffers as K2's, "xq" q(xr) of the resampled x (B, Ho, Wo, Cin)."""
    kw = dict(up=up, fir=fir, fir_kernel=fir_kernel, num_groups1=num_groups1,
              num_groups2=num_groups2, eps=eps, skip_rescale=skip_rescale)
    args = (x, temb, dense_w, dense_b, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2,
            w_skip, b_skip, act_scales)
    if _on_cpu(x, "fused_resblock_transition_int8"):
        if skip_buffers is not None:
            xr = resample_transition(_bf16r(x.float()), transition_kerns(up, fir, fir_kernel), up)
            _plain_skip_buffers(skip_buffers, xr, w_skip, act_scales)
        return resblock_transition_int8_reference(*args, **kw)
    out = _transition_cuda(*args, int8=True, skip_buffers=skip_buffers, **kw)
    fused_resblock_transition_int8.launches += 1
    return out


def quantize_conv_input(x0, x1=None, scale=None, shift=None, *, silu: bool = False,
                        act_scale=None, amax=None, inv_mul: bool = False):
    """The int8 block's quantize pre-pass alone (see
    quantize_conv_input_reference for the arguments): (B, H, W, C0+C1) int8.
    On CUDA x0, x1 bf16 or f32, scale and shift (B, C) f32, and either the
    static act_scale (one f32) or the per-sample amax (B,)."""
    if _on_cpu(x0, "quantize_conv_input"):
        return quantize_conv_input_reference(x0, x1, scale, shift, silu=silu, act_scale=act_scale,
                                             amax=amax, inv_mul=inv_mul)
    require_no_grad("quantize_conv_input", x0, x1, scale, shift)
    f32 = torch.float32
    act = activation_dtype(x0, "quantize_conv_input", False)
    b, h, w, c0 = x0.shape
    c1 = 0 if x1 is None else x1.shape[-1]
    if c0 % 8 or c1 % 8 or (act_scale is None) == (amax is None):
        raise ValueError("quantize_conv_input: channels in multiples of 8, and act_scale or amax")
    ops = [_operand(x0, "x0", act), _operand(x1, "x1", act, (b, h, w, c1)),
           _operand(scale, "scale", f32, (b, c0 + c1)), _operand(shift, "shift", f32, (b, c0 + c1)),
           _operand(act_scale, "act_scale", f32), _operand(amax, "amax", f32, (b,))]
    if ops[4] is not None and ops[4].numel() != 1:
        raise ValueError("quantize_conv_input: act_scale is one scale")
    x0_, x1_, sc, sh, qs, am = map(_build.ptr, ops)
    out = torch.empty((b, h, w, c0 + c1), device=x0.device, dtype=torch.int8)
    _build.launch("gddim_s8_prepass", x0.device, x0_, x1_, c0, c1, int(act == f32), b, h * w, sc,
                  sh, int(silu), qs, am, int(inv_mul), out.data_ptr())
    return out


def _with_stats(out, stats: bool, plan, cin: int, taps: int):
    """The plain versions' out, or with ``stats`` (out, GN2's partials of out
    under the tile plan of ``plan`` (``s8_tile_plan`` / ``bf16_tile_plan``))."""
    if not stats:
        return out
    b, h, w, n = out.shape
    return out, gn2_partials_reference(out, plan(b, h, w, cin, 0, n, taps))


def _stats_buffer(stats: bool, plan: GemmPlan, b: int, n: int, dev):
    return torch.empty((2, b, plan.tiles_h, n), device=dev, dtype=torch.float32) if stats else None


def int8_conv_gemm(a8, wq, *, stats: bool = False):
    """The int8 block GEMM alone on one 3x3 SAME conv, or a 1x1 projection
    (K5's), with unit scales: the int32 sums of (B, H, W, Cin) int8 ``a8``
    by int8 weights ``wq`` as f32 (exact below 2^24), (B, H, W, Cout). On
    CUDA ``wq`` is K-major: (Cout, 9 * Cin) for the conv, (Cout, Cin) for
    the 1x1; the plain version takes the conv's HWIO weights too. With
    ``stats``, (out, the epilogue's GN2 partial sums of out): (2, B,
    tiles_h, Cout) as conv1 writes them (``gn2_partials_reference``)."""
    cin = a8.shape[-1]
    taps = 1 if wq.dim() == 2 and wq.shape[1] == cin else 9
    if _on_cpu(a8, "int8_conv_gemm"):
        out = (int8_matmul_exact(a8, wq.t()) if taps == 1
               else conv3x3_int8_exact(a8, hwio_int8_weight(wq, cin)))
        return _with_stats(out, stats, s8_tile_plan, cin, taps)
    b, h, w, _ = a8.shape
    n = wq.shape[-1] if wq.dim() == 4 else wq.shape[0]
    if taps == 9:
        wq = kmajor_int8(wq, (3, 3, cin, n), "int8_conv_gemm")
    wk = _operand(wq, "wq", torch.int8)
    plan = s8_tile_plan(b, h, w, cin, 0, n, taps)
    f32, dev = torch.float32, a8.device
    a = _operand(a8, "a8", torch.int8, (b, h, w, cin))
    ones = torch.ones(n, device=dev, dtype=f32)
    work = torch.empty(plan.splits * b * h * w * n if plan.splits > 1 else 0, device=dev, dtype=f32)
    out = torch.empty((b, h, w, n), device=dev, dtype=f32)
    part = _stats_buffer(stats, plan, b, n, dev)
    _build.launch("gddim_conv_s8", dev, a.data_ptr(), wk.data_ptr(), ones.data_ptr(),
                  ones.data_ptr(), b, h, w, cin, n, taps, plan.mw, plan.box_h, plan.box_b,
                  plan.tiles_h, plan.m_tiles, plan.splits, plan.kper, work.data_ptr(),
                  _build.ptr(part), out.data_ptr())
    return (out, part) if stats else out


def bf16_conv_input(x0, x1=None, scale=None, shift=None, *, silu: bool = False):
    """The bf16 block's pre-pass alone (see bf16_conv_input_reference for the
    arguments): (B, H, W, C0+C1) bf16. On CUDA x0, x1 bf16 or f32, scale and
    shift (B, C) f32."""
    if _on_cpu(x0, "bf16_conv_input"):
        return bf16_conv_input_reference(x0, x1, scale, shift, silu=silu)
    require_no_grad("bf16_conv_input", x0, x1, scale, shift)
    f32 = torch.float32
    act = activation_dtype(x0, "bf16_conv_input", False)
    b, h, w, c0 = x0.shape
    c1 = 0 if x1 is None else x1.shape[-1]
    if c0 % 8 or c1 % 8:
        raise ValueError("bf16_conv_input: channels in multiples of 8")
    ops = [_operand(x0, "x0", act), _operand(x1, "x1", act, (b, h, w, c1)),
           _operand(scale, "scale", f32, (b, c0 + c1)), _operand(shift, "shift", f32, (b, c0 + c1))]
    x0_, x1_, sc, sh = map(_build.ptr, ops)
    out = torch.empty((b, h, w, c0 + c1), device=x0.device, dtype=torch.bfloat16)
    _build.launch("gddim_bf16_prepass", x0.device, x0_, x1_, c0, c1, int(act == f32), b, h * w,
                  sc, sh, int(silu), out.data_ptr())
    return out


def bf16_conv_gemm(a, w, *, stats: bool = False):
    """The bf16 block GEMM alone on one 3x3 SAME conv, or a 1x1 projection
    (K5's): the f32 sums of (B, H, W, Cin) bf16 ``a`` by HWIO (3, 3, Cin,
    Cout) or (Cin, Cout) bf16 ``w``, (B, H, W, Cout) f32. The plain version
    is the f32 conv (or product) of the same values. ``stats``: as
    ``int8_conv_gemm``'s."""
    if _on_cpu(a, "bf16_conv_gemm"):
        out = conv3x3_nhwc(a.float(), w.float()) if w.dim() == 4 else a.float() @ w.float()
        return _with_stats(out, stats, bf16_tile_plan, a.shape[-1], 9 if w.dim() == 4 else 1)
    require_no_grad("bf16_conv_gemm", a, w)
    b, h, ww, cin = a.shape
    n, taps = w.shape[-1], 9 if w.dim() == 4 else 1
    plan = bf16_tile_plan(b, h, ww, cin, 0, n, taps)
    bf16, f32, dev = torch.bfloat16, torch.float32, a.device
    a_ = _operand(a, "a", bf16, (b, h, ww, cin))
    w_ = _operand(w, "w", bf16, (3, 3, cin, n) if taps == 9 else (cin, n))
    work = torch.empty(plan.splits * b * h * ww * n if plan.splits > 1 else 0, device=dev,
                       dtype=f32)
    out = torch.empty((b, h, ww, n), device=dev, dtype=f32)
    part = _stats_buffer(stats, plan, b, n, dev)
    _build.launch("gddim_conv_bf16", dev, a_.data_ptr(), w_.data_ptr(), b, h, ww, cin, n, taps,
                  plan.mw, plan.box_h, plan.box_b, plan.tiles_h, plan.m_tiles, plan.splits,
                  plan.kper, work.data_ptr(), _build.ptr(part), out.data_ptr())
    return (out, part) if stats else out


def gn_stats(x0, x1=None, gamma=None, beta=None, *, num_groups: int, eps: float = 1e-6):
    """GroupNorm statistics of the logical concat (x0, x1) (B, H, W, C0+C1),
    bf16 or f32, as the blocks take GN1's (``gn_stats_kernel``, one pass,
    var = E[x^2] - mean^2; plain version ``gn_stats_reference``): (scale,
    shift) (B, C) of the affine x * scale + shift, and mean, rstd (B,
    groups), f32. Counted in C (``block_launches``)."""
    if _on_cpu(x0, "gn_stats"):
        x = x0 if x1 is None else torch.cat([x0, x1], -1)
        return gn_stats_reference(x, num_groups, eps, gamma, beta)
    require_no_grad("gn_stats", x0, x1, gamma, beta)
    f32 = torch.float32
    act = activation_dtype(x0, "gn_stats", False)
    b, h, w, c0 = x0.shape
    c1 = 0 if x1 is None else x1.shape[-1]
    c, dev = c0 + c1, x0.device
    ops = [_operand(x0, "x0", act), _operand(x1, "x1", act, (b, h, w, c1)),
           _operand(gamma, "gamma", f32, (c,)), _operand(beta, "beta", f32, (c,))]
    out = [torch.empty(shape, device=dev, dtype=f32)
           for shape in ((b, c), (b, c), (b, num_groups), (b, num_groups))]
    _build.launch("gddim_gn_stats", dev, *map(_build.ptr, ops[:2]), c0, c1, int(act == f32), b,
                  h * w, num_groups, *map(_build.ptr, ops[2:]), eps, *(t.data_ptr() for t in out))
    return tuple(out)


def gn_apply_reference(x0, x1=None, gamma=None, beta=None, *, num_groups: int,
                       eps: float = 1e-6, silu: bool = True, int8: bool = False,
                       act_scale=None, inv_mul: bool = False):
    """Plain version of ``gn_apply``: the two launches it replaces,
    ``gn_stats_reference`` of the logical concat (x0, x1), then the conv
    input as the pre-pass makes it from that affine (+SiLU): bf16
    (``bf16_conv_input_reference``), or with ``int8`` int8
    (``quantize_conv_input_reference``) by the static act_scale or per
    sample (act_scale None; inv_mul: a * (127 / amax)). Returns (a,
    (scale, shift, mean, rstd), amax): amax the per-sample (B,) max|a| in
    the per-sample int8 mode, else None."""
    x = x0 if x1 is None else torch.cat([x0, x1], -1)
    stats = gn_stats_reference(x, num_groups, eps, gamma, beta)
    sc, sh = stats[:2]
    if not int8:
        return bf16_conv_input_reference(x0, x1, sc, sh, silu=silu), stats, None
    amax = None
    if act_scale is None:
        a = _conv_input(x0, x1, sc, sh, silu)
        amax = a.abs().amax(dim=tuple(range(1, a.dim())))
    q = quantize_conv_input_reference(x0, x1, sc, sh, silu=silu, act_scale=act_scale, amax=amax,
                                      inv_mul=inv_mul)
    return q, stats, amax


def gn_apply(x0, x1=None, gamma=None, beta=None, *, num_groups: int, eps: float = 1e-6,
             silu: bool = True, int8: bool = False, act_scale=None, inv_mul: bool = False,
             ctas: int | None = None):
    """GN1 in one launch alone (``gn_apply_kernel``, csrc/gn_apply.cu; see
    gn_apply_reference for the arguments and the result): bf16 x0, x1 (B, H,
    W, C0+C1) on a cluster of ``ctas`` CTAs a sample (default
    ``gn_apply_ctas``), which reads the sample once for its statistics and
    its conv input; ctas 0 runs the launches it replaces
    (``gn_stats_kernel``, the per-sample amax pass, the pre-pass). Counted
    in C (``block_launches``)."""
    kw = dict(num_groups=num_groups, eps=eps, silu=silu, int8=int8, act_scale=act_scale,
              inv_mul=inv_mul)
    if _on_cpu(x0, "gn_apply"):
        return gn_apply_reference(x0, x1, gamma, beta, **kw)
    require_no_grad("gn_apply", x0, x1, gamma, beta)
    bf16, f32, dev = torch.bfloat16, torch.float32, x0.device
    if x0.dtype != bf16 or (x1 is not None and x1.dtype != bf16):
        raise ValueError("gn_apply: takes bf16 activations (f32 ones take gn_stats and the "
                         "pre-pass)")
    b, h, w, c0 = x0.shape
    c1 = 0 if x1 is None else x1.shape[-1]
    c = c0 + c1
    ctas = gn_apply_ctas(h, w, c) if ctas is None else ctas
    if ctas not in (0, GN_APPLY_CTAS) or c0 % _VEC or c1 % _VEC:
        raise ValueError(f"gn_apply: no route of {ctas} CTAs for {(b, h, w, c0, c1)}")
    ops = [_operand(x0, "x0", bf16), _operand(x1, "x1", bf16, (b, h, w, c1)),
           _operand(gamma, "gamma", f32, (c,)), _operand(beta, "beta", f32, (c,)),
           _operand(act_scale, "act_scale", f32)]
    if ops[4] is not None and ops[4].numel() != 1:
        raise ValueError("gn_apply: act_scale is one scale")
    out = torch.empty((b, h, w, c), device=dev, dtype=torch.int8 if int8 else bf16)
    stats = tuple(torch.empty(shape, device=dev, dtype=f32)
                  for shape in ((b, c), (b, c), (b, num_groups), (b, num_groups)))
    amax = torch.empty(b, device=dev, dtype=f32) if int8 and act_scale is None else None
    x0_, x1_, gamma_, beta_, qs = map(_build.ptr, ops)
    _build.launch("gddim_gn_apply", dev, x0_, x1_, c0, c1, b, h * w, num_groups, gamma_, beta_, eps,
                  int(silu), int(int8), qs, _build.ptr(amax), int(inv_mul), ctas, out.data_ptr(),
                  *(t.data_ptr() for t in stats))
    return out, stats, amax


GN2_PREPASS_MODES = ("bf16", "int8", "train")  # the blocks' bf16 and int8 static, K6/K7's d


def gn2_prepass_reference(h1, part, gamma, beta, *, num_groups: int, eps: float = 1e-6,
                          mode: str = "bf16", act_scale=None, mask=None, keep_prob: float = 1.0):
    """Plain version of ``gn2_prepass``: conv2's operand from conv1's f32 h1
    (B, H, W, N) and its partial sums part (2, B, parts, N): the fold
    (``gn_fold_reference``), a2 = silu(h1 * scale + shift) in f32, then bf16
    ('bf16'), int8 by the static act_scale ('int8'), or times mask /
    keep_prob then bf16 ('train', K6/K7's d). Returns (out, (scale, shift,
    mean, rstd))."""
    stats = gn_fold_reference(part, h1.shape[1] * h1.shape[2], num_groups, eps, gamma, beta)
    return gn2_convert_reference(h1, *stats[:2], mode=mode, act_scale=act_scale, mask=mask,
                                 keep_prob=keep_prob), stats


def gn2_convert_reference(h1, scale, shift, *, mode: str = "bf16", act_scale=None, mask=None,
                          keep_prob: float = 1.0):
    """The conversion of gn2_prepass_reference from a given affine (B, N)."""
    a = _conv_input(h1, None, scale, shift, True)
    if mode == "int8":
        return quant_static(a, act_scale.float().reshape(())).to(torch.int8)
    if mode == "train" and mask is not None:
        a = a * (mask.float() * (1.0 / keep_prob))
    return a.to(torch.bfloat16)


def gn2_prepass(h1, part, gamma, beta, *, num_groups: int, eps: float = 1e-6, mode: str = "bf16",
                act_scale=None, mask=None, keep_prob: float = 1.0, fold_only: bool = False):
    """GN2's folding pre-pass alone (``gn_prepass_kernel``, see
    gn2_prepass_reference): f32 h1 and conv1's partial sums on the card, as
    the blocks launch it; with fold_only, the fold alone (``gn_fold_kernel``,
    one CTA a sample; out None). Returns (out, (scale, shift, mean, rstd)):
    the statistics in mode 'train' (K7 reads them), (scale, shift, None,
    None) with fold_only, else None. Counted in C (``block_launches``), as
    the blocks count it."""
    kw = dict(num_groups=num_groups, eps=eps, mode=mode, act_scale=act_scale, mask=mask,
              keep_prob=keep_prob)
    if _on_cpu(h1, "gn2_prepass"):
        out, stats = gn2_prepass_reference(h1, part, gamma, beta, **kw)
        return (None, (*stats[:2], None, None)) if fold_only else (out, stats)
    require_no_grad("gn2_prepass", h1, part)
    b, h, w, n = h1.shape
    if mode not in GN2_PREPASS_MODES or (mode == "int8") != (act_scale is not None) or \
            (mode != "train" and mask is not None):
        raise ValueError(f"gn2_prepass: mode {mode!r}, a static scale for 'int8' only and a "
                         "mask for 'train' only")
    f32, dev = torch.float32, h1.device
    ops = [_operand(h1, "h1", f32, (b, h, w, n)), _operand(part, "part", f32),
           _operand(gamma, "gamma", f32, (n,)), _operand(beta, "beta", f32, (n,)),
           _operand(act_scale, "act_scale", f32), _operand(mask, "mask", torch.int8, (b, h, w, n))]
    if ops[1].dim() != 4 or tuple(ops[1].shape[:2]) != (2, b) or ops[1].shape[3] != n:
        raise ValueError(f"gn2_prepass: part (2, B, parts, N), got {tuple(ops[1].shape)}")
    out = None if fold_only else torch.empty(
        (b, h, w, n), device=dev, dtype=torch.int8 if mode == "int8" else torch.bfloat16)
    shapes = ((b, n), (b, n), (b, num_groups), (b, num_groups))
    stats = (tuple(torch.empty(shape, device=dev, dtype=f32) for shape in shapes[:2]) + (None,) * 2
             if fold_only else tuple(torch.empty(shape, device=dev, dtype=f32) for shape in shapes)
             if mode == "train" else (None,) * 4)
    h1_, part_, g_, b_, qs, m_ = map(_build.ptr, ops)
    _build.launch("gddim_gn2_prepass", dev, h1_, part_, ops[1].shape[2], num_groups, g_, b_, eps,
                  GN2_PREPASS_MODES.index(mode), qs, m_, 1.0 / keep_prob, b, h * w, n,
                  int(fold_only), _build.ptr(out), *map(_build.ptr, stats))
    return out, (None if stats[0] is None else stats)


GN_RESAMPLE_MODES = ("bf16", "f32", "int8")  # h's type: K9 bf16, int8 per sample, int8 static


def gn_resample_reference(x, gamma, beta, *, up: bool, fir: bool = True, fir_kernel=(1, 3, 3, 1),
                          num_groups: int, eps: float = 1e-6, mode: str = "bf16", act_scale=None):
    """Plain version of ``gn_resample``: K9's first pass as its two launches
    make it, ``gn_stats_reference``'s affine, a = silu(x * scale + shift)
    rounded to bf16 (the TPU kernel's zero-bordered scratch), resampled
    (``resample_transition``) into h: bf16 ('bf16'), f32 ('f32'), or int8
    by the static act_scale ('int8', the int8 pre-pass's quantizer); and xr =
    bf16(resample(bf16(x))). Returns (h, xr, amax), amax the per-sample
    (B,) max|h| in 'f32', else None."""
    kerns = transition_kerns(up, fir, fir_kernel)
    sc, sh = gn_stats_reference(x, num_groups, eps, gamma, beta)[:2]
    h = resample_transition(_bf16r(_conv_input(x, None, sc, sh, True)), kerns, up)
    xr = resample_transition(_bf16r(x.float()), kerns, up).to(torch.bfloat16)
    if mode == "bf16":
        return h.to(torch.bfloat16), xr, None
    if mode == "f32":
        return h, xr, h.abs().amax(dim=(1, 2, 3))
    return quant_static(h, act_scale.float().reshape(())).to(torch.int8), xr, None


def gn_resample(x, gamma, beta, *, up: bool, fir: bool = True, fir_kernel=(1, 3, 3, 1),
                num_groups: int, eps: float = 1e-6, mode: str = "bf16", act_scale=None,
                ctas: int | None = None):
    """K9's GN1 and resample in one launch alone (``gn_apply_kernel``'s
    resample variant; see gn_resample_reference for the arguments and the
    result): bf16 x (B, H, W, C) on ``ctas`` CTAs a sample (default
    ``gn_resample_ctas``); ctas 0 runs the two launches it replaces
    (``gn_stats_kernel``, ``transition_resample_kernel``; 'bf16' and 'f32').
    Counted in C (``block_launches``)."""
    kw = dict(up=up, fir=fir, fir_kernel=fir_kernel, num_groups=num_groups, eps=eps, mode=mode,
              act_scale=act_scale)
    if mode not in GN_RESAMPLE_MODES or (mode == "int8") != (act_scale is not None):
        raise ValueError(f"gn_resample: mode one of {GN_RESAMPLE_MODES}, act_scale with 'int8'")
    if _on_cpu(x, "gn_resample"):
        return gn_resample_reference(x, gamma, beta, **kw)
    require_no_grad("gn_resample", x, gamma, beta)
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    b, hin, win, c = x.shape
    if x.dtype != bf16:
        raise ValueError("gn_resample: takes bf16 x (f32 x: the f32 block's two launches)")
    ctas = gn_resample_ctas(hin, win, c, up) if ctas is None else ctas
    if ctas not in (0, GN_APPLY_CTAS) or (fir and len(fir_kernel) != 4) or (
            ctas == 0 and mode == "int8"):
        raise ValueError(f"gn_resample: no route of {ctas} CTAs for {tuple(x.shape)} {mode}")
    ho, wo = (2 * hin, 2 * win) if up else (hin // 2, win // 2)
    kh, kwt = transition_kerns(up, fir, fir_kernel)
    ops = [_operand(x, "x", bf16), _operand(gamma, "gamma", f32, (c,)),
           _operand(beta, "beta", f32, (c,)), _operand(act_scale, "act_scale", f32)]
    htype = {"bf16": bf16, "f32": f32, "int8": torch.int8}[mode]
    h = torch.empty((b, ho, wo, c), device=dev, dtype=htype)
    xr = torch.empty((b, ho, wo, c), device=dev, dtype=bf16)
    amax = torch.empty(b, device=dev, dtype=f32) if mode == "f32" else None
    affine = [torch.empty((b, c), device=dev, dtype=f32) for _ in range(2)]
    _build.launch("gddim_gn_resample", dev, ops[0].data_ptr(), c, b, hin, win, int(up), *kh, *kwt,
                  num_groups, *map(_build.ptr, ops[1:3]), eps, GN_RESAMPLE_MODES.index(mode),
                  _build.ptr(ops[3]), _build.ptr(amax), ctas, h.data_ptr(), xr.data_ptr(),
                  *(t.data_ptr() for t in affine))
    return h, xr, amax


# The kernels that run inside a C call (a block's two convs, K5's
# projections and attention core, the GroupNorm statistics, GN1, K7's
# weight gradients, or the bare wrappers), counted in C where each is
# launched, in csrc/conv.cuh's Counted order: the block GEMM and its
# pre-pass, int8 then bf16 (the bf16 pre-passes: GN2's folding pre-pass and
# K7's rounding of the cotangent among them), then K5's attention core,
# gn_stats_kernel, gn_apply_kernel (both variants: K2/K3/K5's GN1 and K9's
# resample), K7's wgrad_kernel, K1's gn_silu_kernel,
# the block GEMM in the training blocks (K6's convs, K7's conv1 and dgrads),
# K7's GroupNorm backward (gn_bwd_kernel, two a block), GN2's folding
# pre-pass (gn_prepass_kernel, every mode; also counted as its mode's
# pre-pass), K8's online-softmax kernels (ops/attention.py, S > 1024; both
# forms), the int8 blocks' conv2 GEMMs that carry the static skip (also
# counted as the int8 block GEMM) and the f32 online kernel's split pre-pass
BLOCK_COUNTED = ("block_gemm_kernel<int8>", "prepass_kernel<int8>", "block_gemm_kernel<bf16>",
                 "prepass_kernel<bf16>", "attention_wgmma_kernel", "gn_stats_kernel",
                 "gn_apply_kernel", "wgrad_kernel", "gn_silu_kernel",
                 "block_gemm_kernel<bf16, train>", "gn_bwd_kernel", "gn_prepass_kernel",
                 "flash_online_kernel", "block_gemm_kernel<int8, static skip>",
                 "online_split_kernel")
S8_COUNTED = BLOCK_COUNTED[:2]
BF16_COUNTED = BLOCK_COUNTED[2:4]


def block_launches(reset: bool = False, kernels=BLOCK_COUNTED) -> dict:
    """{kernel: launches} of ``kernels`` (of BLOCK_COUNTED) since the kernel
    library loaded or the last reset (reset: zero every count after
    reading). Builds or loads the library; a CUDA graph's replays do not
    count."""
    out = torch.zeros(len(BLOCK_COUNTED), dtype=torch.int64)
    _build.library().gddim_block_launches(out.data_ptr(), int(reset))
    return {k: n for k, n in zip(BLOCK_COUNTED, out.tolist()) if k in kernels}


def _resblock_train_cuda(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2,
                         b2, w_skip, b_skip, mask, *, keep_prob, num_groups1, num_groups2, eps,
                         skip_rescale):
    """K6 through gddim_resblock_train: f32 x and out, the f32 block's chain
    (``_plan_gemm``'s plan and scratch, f32) with the dropout mask."""
    bf16, f32 = torch.bfloat16, torch.float32
    if x.dtype != f32:
        raise ValueError(f"fused_resblock_train: needs f32 x, got {x.dtype}")
    b, h, w, cin = x.shape
    n = w1.shape[-1]
    if not train_supported(x.shape, n) or (w_skip is None and cin != n):
        raise ValueError(f"fused_resblock_train: unsupported block {tuple(x.shape)} -> {n}")
    drop = keep_prob < 1.0
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "x", f32, (b, h, w, cin)), _operand(temb_proj, "temb_proj", f32, (b, n)),
        _operand(gn1_scale, "gn1 scale", f32, (cin,)), _operand(gn1_bias, "gn1 bias", f32, (cin,)),
        _operand(w1, "conv1", bf16, (3, 3, cin, n)), _operand(b1, "b1", f32, (n,)),
        _operand(gn2_scale, "gn2 scale", f32, (n,)), _operand(gn2_bias, "gn2 bias", f32, (n,)),
        _operand(w2, "conv2", bf16, (3, 3, n, n)), _operand(b2, "b2", f32, (n,)),
        _operand(w_skip, "skip", bf16, (cin, n)), _operand(b_skip, "b_skip", f32, (n,)),
        _operand(mask, "mask", torch.int8, (b, h, w, n)) if drop else None,
    ]
    x_, t_, g1s, g1b, w1_, b1_, g2s, g2b, w2_, b2_, ws_, bs_, m_ = map(_build.ptr, ops)
    tiles, splits, nbytes = _plan_gemm("gddim_resblock", b, h, w, cin,
                                       0 if w_skip is None else cin, n, False, True)
    work = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    out = torch.empty((b, h, w, n), device=x.device, dtype=f32)
    _build.launch(
        "gddim_resblock_train", x.device, x_, cin, t_, g1s, g1b, num_groups1, w1_, b1_, g2s, g2b,
        num_groups2, w2_, b2_, ws_, bs_, m_, 1.0 / keep_prob if drop else 1.0, b, h, w, n, eps,
        _INV_SQRT2 if skip_rescale else 1.0, work.data_ptr(), *tiles, *splits, out.data_ptr(),
    )
    fused_resblock_train.launches += 1
    return out


class _ResblockTrain(torch.autograd.Function):
    """K6 forward (plain on the CPU); backward K7 (plain on the CPU) from the
    saved inputs: no interior activation is kept."""

    @staticmethod
    def forward(ctx, x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2,
                w_skip, b_skip, mask, cfg):
        args = (x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip,
                b_skip, mask)
        ctx.save_for_backward(*args)
        ctx.cfg = cfg
        if x.device.type == "cpu":
            return resblock_train_reference(*args, **cfg)
        return _resblock_train_cuda(*args, **cfg)

    @staticmethod
    def backward(ctx, g):
        from gddim_torch.ops.resblock_bwd import fused_resblock_train_grads

        *args, mask = ctx.saved_tensors
        grads = fused_resblock_train_grads(*args, mask, g, **ctx.cfg)
        return (*grads, None, None)


def fused_resblock_train(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2,
                         b2, w_skip, b_skip, mask, *, keep_prob: float, num_groups1: int,
                         num_groups2: int, eps: float = 1e-6, skip_rescale: bool = True):
    """K6: one differentiable training block (see resblock_train_reference
    for the arguments); the kernel forward and the K7 backward on CUDA
    tensors, the plain versions of both on CPU tensors."""
    _on_cpu(x, "fused_resblock_train")
    cfg = dict(keep_prob=keep_prob, num_groups1=num_groups1, num_groups2=num_groups2, eps=eps,
               skip_rescale=skip_rescale)
    return _ResblockTrain.apply(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
                                w2, b2, w_skip, b_skip, mask, cfg)


fused_resblock.launches = 0  # block launches on CUDA tensors (one gddim_resblock each)
fused_resblock_pair.launches = 0
fused_resblock_tail.launches = 0
fused_resblock_int8.launches = 0  # one gddim_resblock_int8 each
fused_resblock_pair_int8.launches = 0
fused_resblock_tail_int8.launches = 0
fused_resblock_train.launches = 0  # one gddim_resblock_train each
fused_resblock_transition.launches = 0  # one gddim_resblock_transition each
fused_resblock_transition_int8.launches = 0  # one gddim_resblock_transition_int8 each
