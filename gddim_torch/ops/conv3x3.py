"""K11: the stride-1 SAME 3x3 convolution, bf16 and int8, NHWC / HWIO.

Replaces ``gddim_tpu/ops/conv3x3.py``:

- ``conv3x3_pallas`` (``_conv_kernel``): nine shifted products with f32
  sums, the output in x's dtype (bf16 or f32); no bias (the layer adds it
  afterwards in the activation dtype, ``models/layers.py``). Differentiable
  as the JAX ``custom_vjp`` is (``conv3x3.py:86-132``): the kernel forward,
  and a backward that is the plain f32 conv's VJP from the saved x and w
  (``conv3x3_vjp``; the JAX ``_bwd`` is XLA's VJP of ``conv3x3_xla``);
- ``conv3x3_pallas_int8`` (``_conv_kernel_int8``): int8 x int8 -> int32
  sums, dequantized as ``acc * (s_a[b] * s_w[c]) + bias`` in f32 (the scale
  product first), then cast to ``out_dtype``;
- ``quantize_per_sample`` and ``quantize_weight_per_channel``: the JAX
  package's graph code around the int8 kernel, plain torch here too;
- ``supported``: the JAX gate without its backend test.

The bf16 form is ``csrc/conv3x3.cu`` (see its header for what bounds it on
the H100): an implicit GEMM on ``wgmma`` whose A operand comes by TMA as one
box of the image per tap (no im2col, SAME padding from the TMA unit's zero
fill), laid out by ``tile_plan``. On f32 x its bf16 operand comes from the
block GEMM's cast pre-pass (``ops/resblock.py:bf16_conv_input``, one read of
x), the weights are rounded to bf16, and the epilogue stores the f32 sums
(``conv3x3_bf16_reference`` holds those rounding points), as the whole-block
kernels take f32 activations on bf16 operands. The int8 form runs on the int8 block GEMM
(``csrc/block_gemm.cu:gddim_conv3x3_int8``, ``block_gemm_kernel<int8>``:
wgmma s32.s8.s8 fed by TMA, the weights K-major) under ``s8_tile_plan``;
where K is split, each split stores its int32 sums and the reduction adds
them in int32, so the sum is exact whatever the split and is converted to
f32 once, as the TPU kernel's, and stored in ``out_dtype`` (bf16, or f32
for the f32 model). On a CPU tensor each wrapper runs its plain version; on
a CUDA tensor it launches the kernel or raises (bf16 or f32 activations;
shapes without a tile plan). The int8 form has no backward: the model
trains its 'int8' convs plain, as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gddim_torch import _build
from gddim_torch.ops.resblock import (
    S8_SLICE,
    SMS,
    _gemm_takes,
    _bf16r,
    _div,
    _on_cpu,
    _operand,
    conv3x3_int8_exact,
    conv3x3_nhwc,
    kmajor_int8,
    pack_int8_weight,
    quantize_weight,
    require_no_grad,
    bf16_conv_input,
    s8_tile_plan,
    tile_box,
)


def supported(x_shape, w_shape, stride: int = 1, dilation: int = 1, int8: bool = False) -> bool:
    """Shapes K11 takes on x (B, H, W, Cin): the JAX gate's (stride 1,
    dilation 1, a 3x3 kernel, Cin and Cout multiples of 128;
    ``conv3x3.py:260-270``), and a tile plan of the form that runs, as
    ``ops/resblock.py:stride1_supported`` gates the blocks: the bf16 form's
    ``tile_plan``, or (``int8``) the int8 block GEMM's ``s8_tile_plan``.
    Elsewhere the model runs the plain conv, as the reference runs XLA's."""
    _, h, w, cin = x_shape
    n = w_shape[-1]
    if not (stride == 1 and dilation == 1 and tuple(w_shape[:2]) == (3, 3)
            and cin % 128 == 0 and n % 128 == 0):
        return False
    if int8:
        return _gemm_takes(h, w, cin, 0, n, S8_SLICE)
    return cin % SLICE_K == 0 and n % TILE_N == 0 and 0 < w <= TILE_M


# --------------------------------------------------------------------------
# Plain versions and the quantizers
# --------------------------------------------------------------------------


def conv3x3_reference(x, w):
    """Plain version of K11: the conv of x by w's values in f32 (products of
    bf16 values are exact in f32), rounded once to x's dtype."""
    return conv3x3_nhwc(x.float(), w.float()).to(x.dtype)


def conv3x3_bf16_reference(x, w):
    """Plain version of K11 with the card's rounding points: x and w rounded
    to bf16 (the kernel's operands), f32 sums, out in x's dtype. On bf16 x
    and w it is ``conv3x3_reference``."""
    return conv3x3_nhwc(_bf16r(x.float()), _bf16r(w.float())).to(x.dtype)


def conv3x3_int8_reference(x8, w8, w_scale, act_scale, bias=None, out_dtype=torch.bfloat16):
    """Plain version of K11's int8 form. The int32 sum can exceed 2^24
    (127^2 * 9 * 512), so it is taken exactly in float64 and rounded once to
    f32, as the int32 -> f32 conversion rounds it."""
    b, cout = x8.shape[0], w8.shape[-1]
    acc = conv3x3_int8_exact(x8, w8.reshape(3, 3, -1, cout))
    scale = (torch.as_tensor(act_scale, dtype=torch.float32, device=acc.device).reshape(-1, 1)
             .expand(b, 1) * torch.as_tensor(w_scale, dtype=torch.float32,
                                             device=acc.device).reshape(1, -1))
    out = acc * scale[:, None, None, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def quantize_per_sample(x):
    """(q int8, scale (B,) f32) with x[b] ~= q[b] * scale[b]: scale =
    max(max|x[b]|, 1e-12) / 127, q = clip(round(x / scale), -127, 127) in f32
    (``conv3x3.py:158-171``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())))
    scale = _div(amax.clamp_min(1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale.reshape((-1,) + (1,) * (x.dim() - 1))), -127, 127)
    return q.to(torch.int8), scale


def quantize_weight_per_channel(w):
    """(3, 3, Cin, Cout) weights -> (int8 weights, (Cout,) f32 scales)
    (``conv3x3.py:174-179``): the per-output-channel quantizer of the int8
    block kernels, the same formula."""
    return quantize_weight(w)


# --------------------------------------------------------------------------
# The bf16 kernel's tile plan
# --------------------------------------------------------------------------

TILE_M = 128  # output pixels of a tile (times mw)
TILE_N = 128  # output channels of a tile
SLICE_K = 64  # input channels of one tap per K slice
MIN_SPLIT_SLICES = 4  # K slices per split, at least


class TilePlan(NamedTuple):
    """How ``conv3x3_wgmma_kernel`` cuts one conv. A tile is mw * TILE_M
    output pixels; the A box is box_w = W pixels x box_h rows x box_b
    samples (at most one tile); M tile t covers samples
    [t // tiles_h * box_b, ... + box_b) and rows [t % tiles_h * box_h, ... +
    box_h); rows past the batch or the image are read as zero and not
    written. K = 9 * Cin runs in ``slices`` slices of SLICE_K, ``kper`` to a
    split, over ``splits`` splits."""

    mw: int
    box_w: int
    box_h: int
    box_b: int
    tiles_h: int
    m_tiles: int
    n_tiles: int
    slices: int
    splits: int
    kper: int


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, h: int, w: int, cin: int, n: int) -> TilePlan:
    """The tile plan of a (b, h, w, cin) x (3, 3, cin, n) conv: a pure
    function of the shapes. Tiles of 256 pixels where they alone make a
    wave of at least 128 CTAs (on the H100 128 such tiles beat 256 of 128
    pixels), else of 128 with K split while the tiles leave half the SMs
    idle. Raises for shapes the kernel does not take."""
    if cin % SLICE_K or n % TILE_N or not 0 < w <= TILE_M:
        raise ValueError(f"conv3x3_pallas: no tile plan for x {(b, h, w, cin)}, Cout {n}")
    n_tiles = n // TILE_N
    mw = 2 if tile_box(b, h, w, 2 * TILE_M)[3] * n_tiles >= SMS - 4 else 1
    box_h, box_b, tiles_h, m_tiles = tile_box(b, h, w, mw * TILE_M)
    slices = 9 * cin // SLICE_K
    want = SMS // (m_tiles * n_tiles)
    splits = max(1, min(want, slices // MIN_SPLIT_SLICES))
    kper = -(-slices // splits)
    return TilePlan(mw, w, box_h, box_b, tiles_h, m_tiles, n_tiles, slices,
                    -(-slices // kper), kper)


# --------------------------------------------------------------------------
# CUDA path
# --------------------------------------------------------------------------


def _check(what, x, w_shape):
    b, h, w, cin = x.shape
    if not supported(x.shape, w_shape) or tuple(w_shape[-2:]) != (cin, w_shape[-1]):
        raise ValueError(f"{what}: unsupported shapes x {tuple(x.shape)}, w {tuple(w_shape)}")
    return b, h, w, cin, w_shape[-1]


def _conv3x3_kernel(x, w):
    """K11 on the card: x bf16 as it is, or f32 through the cast pre-pass
    (one ``gddim_bf16_prepass`` launch); w rounded to bf16; out in x's dtype."""
    require_no_grad("conv3x3_pallas", x, w)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_pallas: the kernel takes bf16 or f32 activations, "
                         f"got {x.dtype}")
    b, h, ww, cin, n = _check("conv3x3_pallas", x, w.shape)
    plan = tile_plan(b, h, ww, cin, n)
    f32 = x.dtype == torch.float32
    xs = bf16_conv_input(x) if f32 else _operand(x, "x", torch.bfloat16)
    ws = _operand(w, "w", torch.bfloat16, (3, 3, cin, n))
    work = torch.empty(plan.splits * b * h * ww * n if plan.splits > 1 else 0, device=x.device,
                       dtype=torch.float32)
    out = torch.empty((b, h, ww, n), device=x.device, dtype=x.dtype)
    _build.launch("gddim_conv3x3", x.device, xs.data_ptr(), ws.data_ptr(), b, h, ww, cin, n,
                  plan.mw, plan.box_h, plan.box_b, plan.tiles_h, plan.m_tiles, plan.splits, plan.kper,
                  int(f32), work.data_ptr(), out.data_ptr())
    conv3x3_pallas.launches += 1
    return out


def _forward(x, w):
    if _on_cpu(x, "conv3x3_pallas"):
        return conv3x3_reference(x, w)
    return _conv3x3_kernel(x, w)


def conv3x3_vjp(x, w, g):
    """(d x, d w) of the stride-1 SAME 3x3 conv y = conv(x, w) for the
    cotangent g: x and g NHWC, w HWIO, in f32. The conv's own backward
    (``aten.convolution_backward``) on the views autograd of
    ``conv3x3_nhwc`` hands it, so the gradients are the ones that path
    gives; the forward is not run again."""
    x_, w_, g_ = (t.float() for t in (x, w, g))
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g_.permute(0, 3, 1, 2), x_.permute(0, 3, 1, 2), w_.permute(3, 2, 0, 1), None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


class _Conv3x3Pallas(torch.autograd.Function):
    """K11 forward (its plain version on the CPU); backward the plain f32
    conv's VJP from the saved (x, w) (``conv3x3_vjp``), the JAX
    ``custom_vjp``'s ``_bwd``; the gradients come back in x's and w's dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = conv3x3_vjp(x, w, g)
        return dx.to(x.dtype), dw.to(w.dtype)


def conv3x3_pallas(x, w):
    """K11: (B, H, W, Cin) x (3, 3, Cin, Cout) -> (B, H, W, Cout) in x's dtype,
    differentiable in x and w. When autograd does not record (sampling), the
    ``autograd.Function`` is skipped."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3Pallas.apply(x, w)
    return _forward(x, w)


def conv3x3_pallas_int8(x8, w8, w_scale, act_scale, bias=None, out_dtype=torch.bfloat16, *,
                        w_kmajor=None):
    """K11's int8 form. x8 (B, H, W, Cin) int8; w8 (3, 3, Cin, Cout) or
    (9, Cin, Cout) int8; w_scale () or (Cout,) and act_scale () or (B,) f32;
    an optional f32 bias fused into the dequantization; out in ``out_dtype``,
    bf16 or f32 (the f32 sums stored as they are). On the card the int8
    block GEMM reads the weights K-major, (Cout, 9 * Cin): ``w_kmajor``, w8
    packed once by the caller (``pack_int8_weight``; ``models/layers.py:Conv``
    keeps it), or else w8 packed here for this call."""
    if _on_cpu(x8, "conv3x3_pallas_int8"):
        return conv3x3_int8_reference(x8, w8, w_scale, act_scale, bias, out_dtype)
    require_no_grad("conv3x3_pallas_int8", bias,
                    *(t for t in (w_scale, act_scale) if isinstance(t, torch.Tensor)))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_pallas_int8: the kernel writes bf16 or f32, asked for "
                         f"{out_dtype}")
    b, h, ww, cin = x8.shape
    n = w8.shape[-1]
    _check("conv3x3_pallas_int8", x8, (3, 3, cin, n) if w8.shape[0] == 9 else w8.shape)
    plan = s8_tile_plan(b, h, ww, cin, 0, n)
    if w_kmajor is None:
        w_kmajor = pack_int8_weight((w8.reshape(-1, n), None))[0]
    f32, dev = torch.float32, x8.device
    xs = _operand(x8, "x8", torch.int8, (b, h, ww, cin))
    wk = _operand(kmajor_int8(w_kmajor, (3, 3, cin, n), "conv3x3_pallas_int8"), "w_kmajor",
                  torch.int8)
    sw = _operand(torch.as_tensor(w_scale, dtype=f32, device=dev).expand(n), "w_scale", f32)
    sa = _operand(torch.as_tensor(act_scale, dtype=f32, device=dev).expand(b), "act_scale", f32)
    bs = _operand(bias, "bias", f32, (n,))
    # the splits' int32 partial sums
    work = torch.empty(plan.splits * b * h * ww * n if plan.splits > 1 else 0, device=dev,
                       dtype=torch.int32)
    out = torch.empty((b, h, ww, n), device=dev, dtype=out_dtype)
    _build.launch("gddim_conv3x3_int8", dev, xs.data_ptr(), wk.data_ptr(), sw.data_ptr(),
                  sa.data_ptr(), _build.ptr(bs), b, h, ww, cin, n, plan.mw, plan.box_h,
                  plan.box_b, plan.tiles_h, plan.m_tiles, plan.splits, plan.kper,
                  int(out_dtype == torch.float32), work.data_ptr(), out.data_ptr())
    conv3x3_pallas_int8.launches += 1
    return out


conv3x3_pallas.launches = 0  # kernel launches on CUDA tensors (one gddim_conv3x3 each)
conv3x3_pallas_int8.launches = 0  # one gddim_conv3x3_int8 each (a block GEMM launch)
