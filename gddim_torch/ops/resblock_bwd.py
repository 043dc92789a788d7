"""K7: the fused backward of one training residual block, NHWC.

Replaces ``gddim_tpu/ops/resblock_bwd.py:fused_resblock_train_grads``: all 12
gradients of ``resblock_train_reference`` (x, temb_proj, GN1 scale/bias, W1,
b1, GN2 scale/bias, W2, b2, W_skip, b_skip) from the block's inputs, the
dropout mask and the output cotangent, recomputing the interior from x.

The CUDA implementation is ``csrc/resblock_bwd.cu`` (its header lists the
launches and what bounds them on the H100). Every GEMM operand is a bf16
tensor that the TPU kernel rounds itself (a1, bf16(r * g), d, the GN2
backward's gu, the skip's x), written once: the recomputed conv1, the two 3x3
dgrads and the 1x1 skip's dgrad run on the block GEMM (``bf16_dgrad_gemm``
alone: the forward's HWIO weights read K-major and tap-reversed, no repacked
copy), the three weight gradients on ``wgrad_kernel`` (``wgrad`` alone,
plan ``ops/resblock.py:wgrad_plan``). ``resblock_train_grads_bf16_reference``
is the chain with those rounding points, ``dgrad_reference`` and
``wgrad_reference`` its two GEMMs. On a CPU tensor the wrapper runs the plain
version, autograd of the plain block; on a CUDA tensor it launches the
kernels or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gddim_torch import _build
from gddim_torch.ops.resblock import (
    _INV_SQRT2, GN_BWD_MAX_GROUPS, GnBwdPlan, _bf16r, _conv_input, _on_cpu, _operand,
    bf16_tile_plan, conv3x3_nhwc, gn_bwd_plan, gn_stats_reference, require_no_grad,
    resblock_train_reference, train_supported, wgrad_plan)


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


def wgrad_reference(a, g, taps: int = 9):
    """Plain version of ``wgrad``: dW (taps * C, N) f32 = sum over the pixels
    m of shift_t(a)[m] (x) g[m] for the taps of a 3x3 SAME conv (t = 3 dy +
    dx reads a at (y + dy - 1, x + dx - 1), zeros outside: ``_wgrad9``) or
    the one tap of a 1x1, in f32 on a's and g's values (bf16 on the card)."""
    b, h, w, c = a.shape
    af, gf = a.float(), g.float().reshape(-1, g.shape[-1])
    if taps == 1:
        return af.reshape(-1, c).t() @ gf
    ap = torch.nn.functional.pad(af, (0, 0, 1, 1, 1, 1))
    return torch.cat([ap[:, dy:dy + h, dx:dx + w].reshape(-1, c).t() @ gf
                      for dy in range(3) for dx in range(3)])


def dgrad_reference(g, w):
    """Plain version of ``bf16_dgrad_gemm``: the input gradient of a 3x3 SAME
    conv with HWIO (3, 3, Cin, Cout) weights w (``_dgrad9``: the conv of g
    with the taps flipped and (Cin, Cout) swapped), or of a 1x1 with (Cin,
    Cout) w (g @ w^T), f32 on g's and w's values: (B, H, W, Cin)."""
    if w.dim() == 2:
        return g.float() @ w.float().t()
    return conv3x3_nhwc(g.float(), w.float().flip(0, 1).transpose(2, 3))


def wgrad(a, g, taps: int = 9):
    """K7's weight gradient on ``wgrad_kernel`` alone (see wgrad_reference):
    a (B, H, W, C) and g (B, H, W, N) bf16 -> (taps * C, N) f32, the plan
    ``wgrad_plan``. Counted in C (``block_launches``)."""
    if _on_cpu(a, "wgrad"):
        return wgrad_reference(a, g, taps)
    require_no_grad("wgrad", a, g)
    b, h, w, c = a.shape
    n = g.shape[-1]
    plan = wgrad_plan(b, h, w, c, taps, n)
    a_ = _operand(a, "a", torch.bfloat16, (b, h, w, c))
    g_ = _operand(g, "g", torch.bfloat16, (b, h, w, n))
    dev = a.device
    work = torch.empty(plan.splits * taps * c * n if plan.splits > 1 else 0, device=dev,
                       dtype=torch.float32)
    out = torch.empty((taps * c, n), device=dev, dtype=torch.float32)
    _build.launch("gddim_wgrad", dev, a_.data_ptr(), g_.data_ptr(), b, h, w, c, n, taps, *plan,
                  work.data_ptr(), out.data_ptr())
    return out


def bf16_dgrad_gemm(g, w):
    """K7's dgrad on the block GEMM alone (see dgrad_reference): g (B, H, W,
    Cout) bf16 and the forward's bf16 weights w, HWIO (3, 3, Cin, Cout) or
    (Cin, Cout), read as they are -> (B, H, W, Cin) f32, the dgrad's
    ``bf16_tile_plan`` (Cout in, Cin out). Counted in C."""
    if _on_cpu(g, "bf16_dgrad_gemm"):
        return dgrad_reference(g, w)
    require_no_grad("bf16_dgrad_gemm", g, w)
    b, h, ww, c = g.shape
    n, taps = w.shape[-2], 9 if w.dim() == 4 else 1
    plan = bf16_tile_plan(b, h, ww, c, 0, n, taps)
    bf16, dev = torch.bfloat16, g.device
    g_ = _operand(g, "g", bf16, (b, h, ww, c))
    w_ = _operand(w, "w", bf16, (3, 3, n, c) if taps == 9 else (n, c))
    work = torch.empty(plan.splits * b * h * ww * n if plan.splits > 1 else 0, device=dev,
                       dtype=torch.float32)
    out = torch.empty((b, h, ww, n), device=dev, dtype=torch.float32)
    _build.launch("gddim_dgrad_bf16", dev, g_.data_ptr(), w_.data_ptr(), b, h, ww, c, n, taps,
                  plan.mw, plan.box_h, plan.box_b, plan.tiles_h, plan.m_tiles, plan.splits,
                  plan.kper, work.data_ptr(), out.data_ptr())
    return out


class GnBwd(NamedTuple):
    """What the GroupNorm(+SiLU) backward makes of one tensor: ``out`` (B,
    H, W, C) dL/dv [+ add_scale * add], f32, or bf16 (GN2's gumm);
    per-sample (B, C) sums over the pixels of dy * yhat (``part_s``, dGN
    scale's), of dy (``part_b``, dGN bias's), of ``extra`` (``part_extra``)
    and of the f32 out (``chan_sum``), None where not asked for."""

    out: torch.Tensor
    part_s: torch.Tensor
    part_b: torch.Tensor
    part_extra: torch.Tensor | None
    chan_sum: torch.Tensor | None


def gn_silu_bwd_reference(dpre, v, sc, sh, mean, rstd, gamma, *, num_groups: int, mask=None,
                          keep_prob: float = 1.0, add=None, add_scale: float = 1.0, extra=None,
                          out_bf16: bool = False):
    """Plain version of ``gn_silu_bwd``: the GroupNorm(+SiLU) backward of
    ``_resblock_bwd_kernel`` (gddim_tpu/ops/resblock_bwd.py:209-222 with
    the dropout mask, :233-242), from dpre = dL/d(silu(y) [* mask /
    keep_prob]), y = v * sc + sh, the forward's affine (B, C) and mean, rstd
    (B, groups), in f32. GN2's form: out_bf16 (out rounded once to bf16),
    extra summed, chan_sum; GN1's: add_scale * add added to out."""
    b, c = v.shape[0], v.shape[-1]
    cg = c // num_groups
    rows = lambda t: t.float().reshape(b, 1, 1, c)  # noqa: E731
    v, d = v.float(), dpre.float()
    y = v * rows(sc) + rows(sh)
    s = torch.sigmoid(y)
    if mask is not None:
        d = d * (mask.float() * (1.0 / keep_prob))
    dy = d * (s * (1.0 + y * (1.0 - s)))
    rstd_c = rows(rstd.repeat_interleave(cg, 1))
    yhat = (v - rows(mean.repeat_interleave(cg, 1))) * rstd_c
    dyh = dy * gamma.float()

    def gmean(t):  # each channel's group mean over the sample
        return rows(t.reshape(b, -1, num_groups, cg).mean((1, 3)).repeat_interleave(cg, 1))

    out = rstd_c * (dyh - gmean(dyh) - yhat * gmean(dyh * yhat))
    if add is not None:
        out = out + add_scale * add.float()
    per = lambda t: t.sum((1, 2))  # noqa: E731
    return GnBwd(out.to(torch.bfloat16) if out_bf16 else out, per(dy * yhat), per(dy),
                 None if extra is None else per(extra.float()), per(out) if out_bf16 else None)


def gn_silu_bwd(dpre, v, sc, sh, mean, rstd, gamma, *, num_groups: int, mask=None,
                keep_prob: float = 1.0, add=None, add_scale: float = 1.0, extra=None,
                out_bf16: bool = False, plan: GnBwdPlan | None = None) -> GnBwd:
    """K7's GroupNorm(+SiLU) backward alone on ``gn_bwd_kernel`` (see
    gn_silu_bwd_reference): GN2's form (out_bf16 with extra, mask optional)
    or GN1's (f32 out, add optional). f32 (B, H, W, C) dpre, v, add, extra,
    int8 mask; the cluster plan ``gn_bwd_plan`` unless ``plan`` pins
    another. Counted in C (``block_launches``)."""
    kw = dict(num_groups=num_groups, mask=mask, keep_prob=keep_prob, add=add,
              add_scale=add_scale, extra=extra, out_bf16=out_bf16)
    if _on_cpu(dpre, "gn_silu_bwd"):
        return gn_silu_bwd_reference(dpre, v, sc, sh, mean, rstd, gamma, **kw)
    require_no_grad("gn_silu_bwd", dpre, v, add, extra)
    if out_bf16 != (extra is not None) or (out_bf16 and add is not None) or \
            (not out_bf16 and mask is not None):
        raise ValueError("gn_silu_bwd: GN2's form takes extra (and a mask), GN1's an add")
    b, h, w, c = dpre.shape
    if not 0 < num_groups <= GN_BWD_MAX_GROUPS or c % num_groups:
        raise ValueError(f"gn_silu_bwd: {num_groups} groups of {c} channels (at most "
                         f"{GN_BWD_MAX_GROUPS} groups)")
    plan = gn_bwd_plan(b, h, w, c) if plan is None else plan
    f32, dev, act = torch.float32, dpre.device, (b, h, w, c)
    ops = [_operand(dpre, "dpre", f32, act), _operand(mask, "mask", torch.int8, act),
           _operand(v, "v", f32, act), _operand(sc, "scale", f32, (b, c)),
           _operand(sh, "shift", f32, (b, c)), _operand(mean, "mean", f32, (b, num_groups)),
           _operand(rstd, "rstd", f32, (b, num_groups)), _operand(gamma, "gamma", f32, (c,)),
           _operand(add, "add", f32, act), _operand(extra, "extra", f32, act)]
    out = torch.empty(act, device=dev, dtype=torch.bfloat16 if out_bf16 else f32)
    part_s, part_b = (torch.empty((b, c), device=dev, dtype=f32) for _ in range(2))
    part_e, chan = ((torch.empty((b, c), device=dev, dtype=f32) for _ in range(2)) if out_bf16
                    else (None, None))
    d_, m_, v_, sc_, sh_, mu_, rs_, g_, a_, e_ = map(_build.ptr, ops)
    _build.launch("gddim_gn_bwd", dev, d_, m_, 1.0 / keep_prob, v_, sc_, sh_, mu_, rs_, g_, a_,
                  float(add_scale), e_, None if out_bf16 else out.data_ptr(),
                  out.data_ptr() if out_bf16 else None, part_s.data_ptr(), part_b.data_ptr(),
                  _build.ptr(part_e), _build.ptr(chan), b, h * w, c, num_groups, *plan)
    return GnBwd(out, part_s, part_b, part_e, chan)


def resblock_train_grads_bf16_reference(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                                        gn2_bias, w2, b2, w_skip, b_skip, mask, g, *,
                                        keep_prob: float, num_groups1: int, num_groups2: int,
                                        eps: float = 1e-6, skip_rescale: bool = True):
    """K7 with the card's rounding points, those of the TPU kernel with
    mm_dtype bf16 (``_resblock_bwd_kernel``): bf16 a1 = silu(GN1 x), gmm = r
    * g, d = silu(GN2 u) * mask / keep, gumm = dL/du and the skip's x, with
    f32 sums (``dgrad_reference``, ``wgrad_reference``); u in f32 with the
    kernels' GroupNorm statistics (``gn_stats_reference``), the GroupNorm
    backwards in f32. Returns the 12 gradients as
    ``resblock_train_grads_reference``."""
    r = _INV_SQRT2 if skip_rescale else 1.0
    x, g = x.float(), g.float()
    sc1, sh1, mean1, rstd1 = gn_stats_reference(x, num_groups1, eps, gn1_scale, gn1_bias)
    a1 = _bf16r(_conv_input(x, None, sc1, sh1, True))
    u = conv3x3_nhwc(a1, _bf16r(w1.float()), b1.float()) + temb_proj.float()[:, None, None, :]
    sc2, sh2, mean2, rstd2 = gn_stats_reference(u, num_groups2, eps, gn2_scale, gn2_bias)
    d = _conv_input(u, None, sc2, sh2, True)
    d = _bf16r(d if keep_prob == 1.0 else d * (mask.float() * (1.0 / keep_prob)))
    gmm = _bf16r(g * r)
    gn2 = gn_silu_bwd_reference(dgrad_reference(gmm, _bf16r(w2.float())), u, sc2, sh2, mean2,
                                rstd2, gn2_scale, num_groups=num_groups2,
                                mask=mask if keep_prob < 1.0 else None, keep_prob=keep_prob,
                                extra=g, out_bf16=True)
    gumm = gn2.out.float()
    ga1 = dgrad_reference(gumm, _bf16r(w1.float()))
    cin, n = x.shape[-1], g.shape[-1]
    dws = dbs = None
    if w_skip is None:
        add, add_scale = g, r
    else:
        add, add_scale = dgrad_reference(gmm, _bf16r(w_skip.float())), 1.0
        dws, dbs = wgrad_reference(_bf16r(x), gmm, 1), r * gn2.part_extra.sum(0)
    gn1 = gn_silu_bwd_reference(ga1, x, sc1, sh1, mean1, rstd1, gn1_scale,
                                num_groups=num_groups1, add=add, add_scale=add_scale)
    dtemb = gn2.chan_sum
    return (gn1.out, dtemb, gn1.part_s.sum(0), gn1.part_b.sum(0),
            wgrad_reference(a1, gumm).reshape(3, 3, cin, n), dtemb.sum(0), gn2.part_s.sum(0),
            gn2.part_b.sum(0), wgrad_reference(d, gmm).reshape(3, 3, n, n),
            r * gn2.part_extra.sum(0), dws, dbs)


PLAN_INTS = 4 * 7 + 3 * 5 + 2 * 4  # csrc/resblock_bwd.cu: PLAN_INTS


@functools.lru_cache(maxsize=None)
def train_bwd_plan(b: int, h: int, w: int, cin: int, n: int, skip: bool) -> tuple:
    """K7's plans, a pure function of the shapes, as its C entry takes them:
    the block-GEMM plans (``bf16_tile_plan``: mw, box_h, box_b, tiles_h,
    m_tiles, splits, kper) of the recomputed conv1 (cin -> n), the dgrads (n
    -> n, n -> cin) and the skip's 1x1 dgrad (n -> cin; zeros without a
    skip), the ``wgrad_plan``s of dW2, dW1 and dW_skip (zeros without), then
    the ``gn_bwd_plan``s of GN2's backward (n channels) and GN1's (cin)."""
    gemms = [bf16_tile_plan(b, h, w, cin, 0, n), bf16_tile_plan(b, h, w, n, 0, n),
             bf16_tile_plan(b, h, w, n, 0, cin),
             bf16_tile_plan(b, h, w, n, 0, cin, 1) if skip else None]
    wgrads = [wgrad_plan(b, h, w, n, 9, n), wgrad_plan(b, h, w, cin, 9, n),
              wgrad_plan(b, h, w, cin, 1, n) if skip else None]
    out = []
    for p in gemms:
        out += [p.mw, p.box_h, p.box_b, p.tiles_h, p.m_tiles, p.splits, p.kper] if p else [0] * 7
    for p in wgrads:
        out += list(p) if p else [0] * 5
    for c in (n, cin):
        out += list(gn_bwd_plan(b, h, w, c))
    assert len(out) == PLAN_INTS
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _plan_array(b: int, h: int, w: int, cin: int, n: int, skip: bool):
    """train_bwd_plan as the int32 host array the C entries read (kept alive
    by the cache: the C call reads it from host memory)."""
    return np.asarray(train_bwd_plan(b, h, w, cin, n, skip), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _workspace(b: int, h: int, w: int, cin: int, n: int, g1: int, g2: int, skip: bool) -> int:
    plan = _plan_array(b, h, w, cin, n, skip)
    return _build.workspace_bytes("gddim_resblock_bwd", b, h, w, cin, n, g1, g2, int(skip),
                                  plan.ctypes.data)


def _grads_cuda(x, temb_proj, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2, w_skip,
                b_skip, mask, g, *, keep_prob, num_groups1, num_groups2, eps, skip_rescale):
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, w, cin = x.shape
    n = w1.shape[-1]
    skip = w_skip is not None
    if not train_supported(x.shape, n) or (not skip and cin != n):
        raise ValueError(f"fused_resblock_train_grads: unsupported block {tuple(x.shape)} -> {n}")
    drop = keep_prob < 1.0
    # operands stay referenced until the launch: a cast's temporary must not be freed
    ops = [
        _operand(x, "x", f32, (b, h, w, cin)), _operand(temb_proj, "temb_proj", f32, (b, n)),
        _operand(gn1_scale, "gn1 scale", f32, (cin,)), _operand(gn1_bias, "gn1 bias", f32, (cin,)),
        _operand(w1, "conv1", bf16, (3, 3, cin, n)), _operand(b1, "b1", f32, (n,)),
        _operand(gn2_scale, "gn2 scale", f32, (n,)), _operand(gn2_bias, "gn2 bias", f32, (n,)),
        _operand(w2, "conv2", bf16, (3, 3, n, n)), _operand(w_skip, "skip", bf16, (cin, n)),
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
    dws = torch.empty((cin, n), device=dev, dtype=f32) if skip else None
    dbs = torch.empty(n, device=dev, dtype=f32) if skip else None
    outs = [dx, dtemb, dgn1s, dgn1b, dw1, db1, dgn2s, dgn2b, dw2, db2, dws, dbs]
    plan = _plan_array(b, h, w, cin, n, skip)
    work = torch.empty(_workspace(b, h, w, cin, n, num_groups1, num_groups2, skip), device=dev,
                       dtype=torch.uint8)
    x_, t_, g1s, g1b, w1_, b1_, g2s, g2b, w2_, ws_, m_, g_ = map(_build.ptr, ops)
    _build.launch(
        "gddim_resblock_bwd", dev, x_, t_, g1s, g1b, num_groups1, w1_, b1_, g2s, g2b,
        num_groups2, w2_, ws_, m_, 1.0 / keep_prob if drop else 1.0, g_, b, h, w, cin, n, eps,
        _INV_SQRT2 if skip_rescale else 1.0, plan.ctypes.data, work.data_ptr(),
        *map(_build.ptr, outs),
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
