"""The blur layer-wise int8 path's two kernels as the card runs them, on the
CPU: K11's int8 form on the int8 block GEMM (``conv3x3_pallas_int8``,
``csrc/block_gemm.cu:gddim_conv3x3_int8``) and K12 as GN1's one-launch
kernel (``group_norm_silu_quant``, ``csrc/gn_apply.cu:gddim_gn_silu_quant``):

(a) K11 int8's split K, emulated: each split's int32 sums over its K slices
    (``s8_tile_plan``), added in int32 in split order, converted to f32 once,
    times (s_a[b] * s_w[n]), plus the bias: at every K11 shape's plan at
    B=4/16/64 and at a shape whose sums pass 2^24, bit for bit the f32
    values of ``conv3x3_int8_reference`` and the sums (unit scales, no
    bias) of ``gddim_tpu.ops.conv3x3.conv3x3_pallas_int8`` in interpret
    mode; its bf16 output one ulp apart on at most JAX_FLIP_SHARE of the
    values (XLA on the CPU fuses the dequantization's multiply and add,
    which moves an f32 value by an ulp and now and then a bf16 rounding);
    the block GEMM's f32 split partials would not be exact;
(b) every K11 shape has an int8 block GEMM plan at B = 1..128;
(c) the K-major weights unpack to the HWIO int8 weights, and ``Conv`` packs
    them once (again only when its weight changes);
(d) K12's route: the 11 bf16 sites one cluster launch, f32 x the launches of
    the statistics route; the per-sample quantizer's reciprocal with its
    fallback to the division near half steps (``csrc/act.cuh:div_quant8``)
    the same int8 values as the division;
(e) the CUDA wrappers' C calls (``_build.launch`` replaced) against their
    entries' signatures.

Cases marked ``cuda`` hold both kernels against their plain versions on the
card and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.models import layers as t_layers
from gddim_torch.ops import conv3x3 as t_c3
from gddim_torch.ops import groupnorm as t_gn
from gddim_torch.ops import resblock as t_rb

# the layer-wise int8 path's K11 convs (H, Cin, Cout) and K12 sites (H, C)
# of the trunk (chip_smoke.py:SHAPES)
K11_SHAPES = [(32, 128, 128), (32, 256, 128), (32, 256, 256), (32, 384, 128), (16, 128, 128),
              (16, 128, 256), (16, 256, 256), (16, 384, 256), (16, 512, 256), (8, 256, 256),
              (8, 512, 256), (4, 256, 256), (4, 512, 256)]
K12_SITES = [(32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384), (16, 512),
             (8, 256), (8, 512), (4, 256), (4, 512)]
# K12 on the card against its plain version: as chip_smoke.py's gate
K12_FLIP_SHARE = 1e-3
# (a) the JAX kernel's bf16 output under XLA's fused multiply-add on the CPU:
# bf16 values one ulp from the plain version's (measured at most 1 of
# 32,768 a shape here)
JAX_FLIP_SHARE = 1e-3


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine,
    which has no JAX, runs the ``cuda`` cases with ``pytest --noconftest -m cuda``)."""
    import jax.numpy as jnp
    from gddim_tpu.ops import conv3x3
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jnp=jnp, c3=conv3x3, pltpu=pltpu)


def _operands(rng, b, h, cin, cout, large=False):
    """int8 x and HWIO w, f32 weight scales, per-sample scales and bias;
    large: operands near 127, so that every interior sum passes 2^24 at
    Cin = 512."""
    lo, hi = (100, 128) if large else (-127, 128)
    x8 = rng.integers(lo, hi, (b, h, h, cin)).astype(np.int8)
    w8 = rng.integers(lo, hi, (3, 3, cin, cout)).astype(np.int8)
    sw = (rng.random(cout) * 1e-3 + 1e-4).astype(np.float32)
    sa = (rng.random(b) * 1e-2 + 1e-3).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x8, w8, sw, sa, bias


def emulate_k11_int8(x8, w8, sw, sa, bias, plan, f32_partials=False):
    """K11 int8 as gddim_conv3x3_int8 computes it under ``plan``, in f32
    before the bf16 rounding: split z sums the K slices [z kper, (z + 1)
    kper) of S8_SLICE channels (K tap-major, as the packed weights run) in
    int32; the partials are added in int32 in split order
    (block_splitk_s32_kernel; one split: the tile's own sums); the sum is
    converted to f32 once, times (w_scale[n] * act_scale[b]), plus the bias.
    f32_partials: the block GEMM's other split K instead, each split's sum
    dequantized to f32 and the partials added in f32."""
    b, h, w, cin = x8.shape
    n = w8.shape[-1]
    xp = np.pad(x8.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.concatenate([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                          -1).reshape(b * h * w, 9 * cin)
    wk = w8.astype(np.int64).reshape(9 * cin, n)
    scale = np.repeat(sw[None, :] * sa[:, None], h * w, axis=0)  # f32 (M, N)
    acc = np.zeros((b * h * w, n), np.int32)
    f32 = np.zeros((b * h * w, n), np.float32)
    for z in range(plan.splits):
        k0 = z * plan.kper * t_rb.S8_SLICE
        k1 = min((z + 1) * plan.kper, plan.conv_slices) * t_rb.S8_SLICE
        part = cols[:, k0:k1] @ wk[k0:k1]  # exact in int64
        assert np.abs(part).max() < 2 ** 31
        if f32_partials:
            f32 = f32 + part.astype(np.float32) * scale
        else:
            acc = acc + part.astype(np.int32)
    out = f32 if f32_partials else acc.astype(np.float32) * scale
    return (out + bias).astype(np.float32).reshape(b, h, w, n)


def _jax_int8(jx, x8, w8, sw, sa, bias, out_dtype="bfloat16"):
    """conv3x3_pallas_int8 of the JAX package in interpret mode, as f32."""
    with jx.pltpu.force_tpu_interpret_mode():
        out = jx.c3.conv3x3_pallas_int8(*(jx.jnp.asarray(a) for a in (x8, w8, sw, sa)),
                                        bias=jx.jnp.asarray(bias),
                                        out_dtype=getattr(jx.jnp, out_dtype))
    return np.asarray(out.astype(jx.jnp.float32))


def _check_against_jax(jx, x8, w8, sw, sa, bias, plan, want_bf16):
    """The JAX kernel's int32 sums (unit scales, no bias: f32 of the sums)
    against the emulation's, and its bf16 output against ``want_bf16``."""
    n = w8.shape[-1]
    unit = (np.ones(n, np.float32), np.ones(x8.shape[0], np.float32), np.zeros(n, np.float32))
    np.testing.assert_array_equal(_jax_int8(jx, x8, w8, *unit, out_dtype="float32"),
                                  emulate_k11_int8(x8, w8, *unit, plan))
    got, want = _jax_int8(jx, x8, w8, sw, sa, bias), want_bf16.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    off = got != want
    assert (np.abs(got - want) <= ulp).all() and off.mean() <= JAX_FLIP_SHARE


def _reference(x8, w8, sw, sa, bias, out_dtype=torch.float32):
    return t_c3.conv3x3_int8_reference(*map(torch.from_numpy, (x8, w8, sw, sa)),
                                       bias=torch.from_numpy(bias), out_dtype=out_dtype)


# --------------------------------------------------------------------------
# (a) K11 int8's split K
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,cin,cout", K11_SHAPES)
def test_split_k_emulation_matches_plain_and_jax(jx, h, cin, cout):
    """Each plan of this conv at B=4/16/64 on a small input of its widths
    (the split runs over K = 9 * Cin only): the f32 values before the bf16
    rounding bit-identical to the plain version's and the JAX kernel's, so
    the bf16 outputs are too."""
    b, hs = 2, min(h, 8)
    ops = _operands(np.random.default_rng(h * 1000 + cin + cout), b, hs, cin, cout)
    want = _reference(*ops).numpy()
    bf16 = _reference(*ops, out_dtype=torch.bfloat16)
    assert torch.equal(torch.from_numpy(want).to(torch.bfloat16), bf16)
    plans = {t_rb.s8_tile_plan(batch, h, h, cin, 0, cout) for batch in (4, 16, 64)}
    for plan in plans:
        got = emulate_k11_int8(*ops, plan)
        np.testing.assert_array_equal(got, want, err_msg=str(plan))
    _check_against_jax(jx, *ops, max(plans, key=lambda p: p.splits), bf16)


def test_split_k_emulation_exact_past_2_24(jx):
    """Sums past 2^24 on a split plan (4x4 512 -> 256 at B=4: 9 splits) and a
    scalar activation scale: the int32 split is bit-identical to the plain
    version and the JAX kernel, where f32 partials round."""
    h, cin, cout = 4, 512, 256
    plan = t_rb.s8_tile_plan(4, h, h, cin, 0, cout)
    assert plan.splits > 1
    x8, w8, sw, _, bias = _operands(np.random.default_rng(7), 2, h, cin, cout, large=True)
    sa = np.float32(3.7e-3)
    sums = _reference(x8, w8, np.ones(cout, np.float32), np.array(1.0, np.float32),
                      np.zeros(cout, np.float32))
    assert sums.abs().min().item() > 2 ** 24
    want = _reference(x8, w8, sw, np.array(sa), bias).numpy()
    sa_b = np.full(2, sa, np.float32)  # the wrapper's expansion of a scalar scale
    np.testing.assert_array_equal(emulate_k11_int8(x8, w8, sw, sa_b, bias, plan), want)
    _check_against_jax(jx, x8, w8, sw, np.array(sa), bias, plan,
                       _reference(x8, w8, sw, np.array(sa), bias, out_dtype=torch.bfloat16))
    rounded = emulate_k11_int8(x8, w8, sw, sa_b, bias, plan, f32_partials=True)
    assert (rounded != want).any()


# --------------------------------------------------------------------------
# (b) the tile plans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,cin,cout", K11_SHAPES)
def test_every_k11_shape_has_an_int8_gemm_plan(h, cin, cout):
    """K11's gate takes the shape, and the int8 block GEMM has a plan for it
    at every batch; a split plan runs on 128-pixel tiles (the int32 split's
    only instantiation)."""
    assert t_c3.supported((1, h, h, cin), (3, 3, cin, cout))
    for b in range(1, 129):
        plan = t_rb.s8_tile_plan(b, h, h, cin, 0, cout)
        assert plan.conv_slices == 9 * cin // t_rb.S8_SLICE and plan.skip_slices == 0
        assert (plan.splits - 1) * plan.kper < plan.conv_slices <= plan.splits * plan.kper
        assert plan.splits == 1 or plan.mw == 1


# --------------------------------------------------------------------------
# (c) the weights
# --------------------------------------------------------------------------


def test_packed_weights_unpack_to_hwio():
    rng = np.random.default_rng(3)
    w8 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 256, 128)).astype(np.int8))
    wk = t_rb.pack_int8_weight((w8, None))[0]
    assert wk.shape == (128, 9 * 256) and wk.is_contiguous()
    assert torch.equal(t_rb.hwio_int8_weight(wk, 256), w8)
    # row n, column t * Cin + c: tap t = 3 dy + dx, input channel c
    assert wk[5, 4 * 256 + 17] == w8[1, 1, 17, 5]


def test_conv_packs_its_int8_weights_once(monkeypatch):
    """The int8 path hands the kernel the K-major weights from Conv's cache:
    packed at the first call, not again while the weight stays, and anew
    once it changes."""
    packs, seen = [], []
    real_pack = t_layers.pack_int8_weight
    real_conv = t_c3.conv3x3_pallas_int8

    def pack(w):
        packs.append(1)
        return real_pack(w)

    def conv(x8, w8, *args, w_kmajor=None, **kw):
        seen.append((w8, w_kmajor))
        return real_conv(x8, w8, *args, w_kmajor=w_kmajor, **kw)

    monkeypatch.setattr(t_layers, "pack_int8_weight", pack)
    monkeypatch.setattr(t_c3, "conv3x3_pallas_int8", conv)
    layer = t_layers.Conv(128, 128, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 4, 4, 128), generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.inference_mode():
        first = layer(x, "int8")
        again = layer(x, "int8")
    assert len(packs) == 1 and torch.equal(first, again)
    w8, wk = seen[0]
    assert torch.equal(t_rb.hwio_int8_weight(wk, 128), w8)
    with torch.no_grad():
        layer.weight.mul_(0.5)
    with torch.inference_mode():
        layer(x, "int8")
    assert len(packs) == 2


# --------------------------------------------------------------------------
# (d) K12's route
# --------------------------------------------------------------------------


def test_k12_sites_take_one_cluster_launch():
    for h, c in K12_SITES:
        assert t_rb.gn_apply_ctas(h, h, c) == t_rb.GN_APPLY_CTAS, (h, c)
        assert t_rb.gn_apply_ctas(h, h, c, f32=True) == 0, (h, c)


def _div_quant(f, s):
    """csrc/act.cuh:div_quant8 in f32, 8 values at a time: rint(f * (1 /
    s)), or rint(f / s) for the whole vector where a product lies within
    1e-4 of a half step; clipped to +-127."""
    f = f.reshape(-1, 8)
    t = f * (np.float32(1.0) / s)
    near = (np.abs(t - np.rint(t)) > np.float32(0.4999)).any(1)
    t[near] = f[near] / s
    return np.clip(np.rint(t), -127, 127).ravel()


def test_quantizer_reciprocal_is_the_division():
    """|f| <= amax, s = max(amax, 1e-12) / 127: random values and values
    within a few ulps of every half step, at amaxes over 30 decades."""
    rng = np.random.default_rng(9)
    for amax in (1e-12, 3.1e-7, 0.37, 1.0, 5.3, 77.7, 3.3e4, 2.9e18):
        am = np.float32(amax)
        s = np.maximum(am, np.float32(1e-12)) / np.float32(127.0)
        f = (rng.uniform(-1, 1, 80_000) * am).astype(np.float32)
        f[0], f[1] = am, -am
        half = (np.arange(-127, 127) + np.float32(0.5)).astype(np.float32) * s
        steps = rng.integers(-4, 5, (half.size, 40)).astype(np.int32)
        edge = (half.view(np.int32)[:, None] + steps).view(np.float32).ravel()
        edge = edge[np.abs(edge) <= am]
        for v in (f, np.resize(edge, -(-edge.size // 8) * 8).astype(np.float32)):
            want = np.clip(np.rint(v / s), -127, 127)
            np.testing.assert_array_equal(_div_quant(v, s), want)


# --------------------------------------------------------------------------
# (e) the C calls
# --------------------------------------------------------------------------


@pytest.fixture
def glue(monkeypatch):
    """The CUDA wrappers on CPU tensors with ``_build.launch`` replaced by a
    recorder of each call, its arguments checked against the entry's
    signature."""
    import ctypes

    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    calls = []

    def launch(name, device, *args):
        sig = [kinds[t] for t in _build._SIGNATURES[name]]
        assert len(args) + 1 == len(sig), (name, len(args) + 1, len(sig))
        for k, v in zip(sig, args):
            assert (v is None or isinstance(v, int)) if k == "P" else \
                isinstance(v, float if k == "F" else int), (name, k, v)
        calls.append((name, args))

    def operand(t, what, dtype, shape=None):
        t = None if t is None else t.to(dtype).contiguous()
        assert t is None or shape is None or tuple(t.shape) == tuple(shape), what
        return t

    for mod in (t_rb, t_c3):
        monkeypatch.setattr(mod, "_on_cpu", lambda x, what: False)
        monkeypatch.setattr(mod, "_operand", operand)
    for fn in (t_c3.conv3x3_pallas_int8, t_gn.group_norm_silu_quant):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "launch", launch)
    return calls


@pytest.mark.parametrize("h,cin,cout", [(32, 384, 128), (4, 512, 256)])
def test_k11_int8_wrapper_passes_its_plan(glue, h, cin, cout):
    """The tile plan of s8_tile_plan, the K-major weights (packed here when
    not given), int32 scratch for the splits, a scalar scale expanded."""
    x8, w8, sw, _, bias = map(torch.from_numpy,
                              _operands(np.random.default_rng(1), 4, h, cin, cout))
    wk = t_rb.pack_int8_weight((w8, sw))[0]
    t_c3.conv3x3_pallas_int8(x8, w8, sw, torch.tensor(0.01), bias)
    t_c3.conv3x3_pallas_int8(x8, w8, sw, torch.full((4,), 0.01), None, w_kmajor=wk)
    plan = t_rb.s8_tile_plan(4, h, h, cin, 0, cout)
    assert [name for name, _ in glue] == ["gddim_conv3x3_int8"] * 2
    for _, args in glue:
        assert args[5:17] == (4, h, h, cin, cout, plan.mw, plan.box_h, plan.box_b, plan.tiles_h,
                              plan.m_tiles, plan.splits, plan.kper)
    assert glue[1][1][4] is None  # no bias
    with pytest.raises(ValueError):  # HWIO weights where K-major ones belong
        t_c3.conv3x3_pallas_int8(x8, w8, sw, torch.tensor(0.01), bias, w_kmajor=w8)


def test_k12_wrapper_passes_its_route(glue):
    """bf16 x: the cluster route (ctas 8, no scratch); f32 x: ctas 0 with
    the affine and amax scratch."""
    x = torch.randn((2, 16, 16, 256))
    g, b = torch.ones(256), torch.zeros(256)
    t_gn.group_norm_silu_quant(x.bfloat16(), g, b, 32)
    t_gn.group_norm_silu_quant(x, g, b, 32, apply_silu=False)
    assert [name for name, _ in glue] == ["gddim_gn_silu_quant"] * 2
    (_, bf), (_, f32) = glue
    assert (bf[1], bf[10], bf[11]) == (0, 8, None)
    assert (f32[1], f32[9], f32[10]) == (1, 0, 0) and isinstance(f32[11], int)
    with pytest.raises(ValueError):
        t_gn.group_norm_silu_quant(x[..., :100], g[:100], b[:100], 25)  # 8-channel vectors


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,cin,cout,large", [(4, 4, 512, 256, True), (4, 32, 384, 128, True),
                                               (16, 8, 512, 256, False),
                                               (64, 16, 256, 256, False)])
def test_k11_int8_on_the_block_gemm_is_exact(cuda, b, h, cin, cout, large):
    x8, w8, sw, sa, bias = (torch.from_numpy(a).to(cuda) for a in _operands(
        np.random.default_rng(b + h), b, h, cin, cout, large))
    sa = sa[0] if large else sa  # a scalar activation scale
    wk = t_rb.pack_int8_weight((w8, sw))[0]
    t_rb.block_launches(reset=True)
    out = t_c3.conv3x3_pallas_int8(x8, w8, sw, sa, bias, w_kmajor=wk)
    assert t_rb.block_launches()["block_gemm_kernel<int8>"] == 1
    assert torch.equal(out, t_c3.conv3x3_int8_reference(x8, w8, sw, sa, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(32, 384), (16, 512), (4, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k12_kernel_matches_plain(cuda, h, c, dtype):
    g = torch.Generator(device=cuda).manual_seed(h + c)
    x = torch.randn((4, h, h, c), generator=g, device=cuda).to(dtype)
    gs = 1.0 + 0.1 * torch.randn((c,), generator=g, device=cuda)
    gb = 0.1 * torch.randn((c,), generator=g, device=cuda)
    t_rb.block_launches(reset=True)
    q, s = t_gn.group_norm_silu_quant(x, gs, gb, 32)
    n = t_rb.block_launches(kernels=("gn_apply_kernel", "gn_stats_kernel"))
    assert n == ({"gn_apply_kernel": 1, "gn_stats_kernel": 0} if dtype == torch.bfloat16
                 else {"gn_apply_kernel": 0, "gn_stats_kernel": 1})
    q_ref, s_ref = t_gn.group_norm_silu_quant_reference(x, gs, gb, 32)
    assert ((s - s_ref).abs() / s_ref).max().item() <= 1e-5
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1 and diff.bool().float().mean().item() <= K12_FLIP_SHARE
