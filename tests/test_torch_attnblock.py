"""K5 on the block GEMM and the wgmma attention core (``csrc/attnblock.cu``)
and what surrounds them in Python, on the CPU:

(a) ``attnblock_bf16_reference``, the plain version with the TPU kernel's
    rounding points, against ``fused_attnblock`` with
    ``mm_dtype=jnp.bfloat16`` in interpret mode, beside the f32 plain
    composition;
(b) ``block_plan`` at the main path's attention shapes (cld/accr_dcifar10:
    16x16 and 4x4 at 256 channels) at B = 4, 16, 64 and 128: the
    projections' tiles cover M and N, the splits cover K, the core's CTAs
    cover the rows; shapes the kernels do not take raise;
(c) ``workspace_bytes`` against the buffers the C call carves;
(d) the K-major int8 packing of the (C, 3C) and (C, C) projections;
(e) the per-block weight cache of ``AttnBlockpp``;
(f) the plain versions of the core and of the bare 1x1 GEMMs, and the
    core's card gate against cores with other rounding points of p.

Cases marked ``cuda`` hold the kernels against their plain versions on the
card, count their launches in C, and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch.models.blocks import AttnBlockpp
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import resblock as t_rb


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    has no JAX)."""
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import attnblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jax=jax, jnp=jnp, attn=attnblock, pltpu=pltpu)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def draw(seed, b, h, c):
    """x, the GN affine and the four NIN weights and biases, f32, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    gn = [(1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
          (0.1 * rng.standard_normal(c)).astype(np.float32)]
    nin = []
    for _ in range(4):
        nin += [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
                (0.1 * rng.standard_normal(c)).astype(np.float32)]
    return [x] + gn + nin


# --------------------------------------------------------------------------
# (a) the bf16 rounding points against the JAX kernel
# --------------------------------------------------------------------------

# The plain version with the TPU kernel's rounding points against the bf16
# kernel in interpret mode, max|diff| / max|out|: the same roundings, f32
# sums in another order, which flip a bf16 rounding of h, q/k/v, p or a now
# and then; measured 1.3e-7 to 3.5e-4 over the 8 cases below, 2.3x under
# the bound. The f32 plain composition measured 9.7e-4 to 2.6e-3 on the
# same cases, above it.
BF16_REL = 8e-4

ROUNDING_CASES = [(4, 128), (8, 128), (16, 128), (4, 256)]


@pytest.mark.parametrize("seed", [90, 91])
@pytest.mark.parametrize("h,c", ROUNDING_CASES, ids=[f"{h}x{h}x{c}" for h, c in ROUNDING_CASES])
def test_attnblock_bf16_rounding_points_match_jax_bf16_kernel(jx, h, c, seed):
    args = draw(seed, 2, h, c)
    kw = dict(num_groups=32, skip_rescale=True)
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jx.attn.fused_attnblock(*map(jx.jnp.asarray, args),
                                                  mm_dtype=jx.jnp.bfloat16, **kw))
    ts = [torch.from_numpy(a) for a in args]
    got = t_attn.attnblock_bf16_reference(*ts, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = rel_err(got, want)
    assert err <= BF16_REL, (err, rel_err(t_attn.attnblock_reference(*ts, **kw), want))


def test_attnblock_bf16_reference_keeps_x_dtype_and_the_residual():
    """With the output projection zero, out = (x + bo) * 1/sqrt(2) in f32:
    the residual never passes through bf16."""
    args = [torch.from_numpy(a) for a in draw(92, 2, 4, 64)]
    args[9] = torch.zeros_like(args[9])
    out = t_attn.attnblock_bf16_reference(*args, num_groups=16, skip_rescale=True)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, (args[0] + args[10]) * t_attn._INV_SQRT2, rtol=0, atol=0)
    bf = t_attn.attnblock_bf16_reference(args[0].bfloat16(), *args[1:], num_groups=16)
    assert bf.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# (b) the plan
# --------------------------------------------------------------------------

# the main path's attention blocks: 9 at 16x16 and 1 at 4x4, 256 channels
MAIN_SHAPES = [(16, 256), (4, 256)]


def tile_pixels(plan, b, h, w, t):
    """The pixels of M tile t's rows that lie in the image, as the block
    GEMM maps them (block_gemm.cu:tile_row)."""
    r = np.arange(plan.mw * t_rb.GEMM_TILE_M)
    per_sample = w * plan.box_h
    bb = t // plan.tiles_h * plan.box_b + r // per_sample
    y = t % plan.tiles_h * plan.box_h + (r // w) % plan.box_h
    inside = (r < per_sample * plan.box_b) & (bb < b) & (y < h)
    return ((bb * h + y) * w + r % w)[inside]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("batch", [4, 16, 64, 128])
@pytest.mark.parametrize("h,c", MAIN_SHAPES, ids=["S256", "S16"])
def test_block_plan_covers_the_main_path_blocks(h, c, batch, int8):
    plan = t_attn.block_plan(batch, h, h, c, int8)
    slice_ = t_rb.S8_SLICE if int8 else t_rb.BF16_SLICE
    for gemm, n in ((plan.qkv, 3 * c), (plan.out, c)):
        # M: every pixel in exactly one tile, a tile's pixels consecutive rows
        pix = [tile_pixels(gemm, batch, h, h, t) for t in range(gemm.m_tiles)]
        assert np.array_equal(np.sort(np.concatenate(pix)), np.arange(batch * h * h))
        assert all(np.array_equal(p, p[0] + np.arange(len(p))) for p in pix)
        # N in whole 128-channel tiles; K: one tap of C channels in whole slices
        assert n % t_rb.GEMM_TILE_N == 0
        assert gemm.conv_slices * slice_ == c and gemm.skip_slices == 0
        runs = [range(z * gemm.kper, min((z + 1) * gemm.kper, gemm.conv_slices))
                for z in range(gemm.splits)]
        assert [s for run in runs for s in run] == list(range(gemm.conv_slices))
        assert all(len(run) > 0 for run in runs)
    # the core: 64-row CTAs, each within one sample (S >= 64) or of whole
    # samples (S < 64, 64 / S of them, with the deep ring)
    s = h * h
    assert s % 64 == 0 if s >= 64 else 64 % s == 0 and plan.stages == 4
    assert plan.stages in (2, 4)


def test_block_plan_takes_the_shallow_ring_only_where_the_grid_fills_the_card():
    assert t_attn.block_plan(64, 16, 16, 256, False).stages == 2  # 256 CTAs, two an SM
    assert t_attn.block_plan(16, 16, 16, 256, False).stages == 4  # 64 CTAs
    assert t_attn.block_plan(64, 4, 4, 256, True).stages == 4  # S=16: 4 samples a CTA, 16 CTAs
    assert t_attn.core_plan(512, 16) == 4  # S < 64 always takes the deep ring
    # the projections: 128-pixel tiles (4 bf16 or 2 int8 K slices fill no deeper ring)
    for int8 in (False, True):
        plan = t_attn.block_plan(64, 16, 16, 256, int8)
        assert plan.qkv.mw == plan.out.mw == 1


@pytest.mark.parametrize("shape,int8", [((4, 16, 16, 96), False), ((4, 16, 16, 64), False),
                                        ((4, 16, 16, 64), True), ((4, 6, 8, 256), False),
                                        ((4, 32, 32, 256), False)],
                         ids=["c96", "c64-bf16", "c64-int8", "s48", "s1024"])
def test_block_plan_refuses_what_the_kernels_do_not_take(shape, int8):
    with pytest.raises(ValueError, match="no (tile )?plan"):
        t_attn.block_plan(*shape, int8)


@pytest.mark.parametrize("s,c,ok", [(256, 256, True), (16, 256, True), (64, 128, True),
                                    (32, 64, True), (48, 256, False), (512, 128, False),
                                    (256, 96, False), (256, 320, False)])
def test_core_supported(s, c, ok):
    """The core's shapes; K5's gate (f32 activations and K10's forward too)
    takes those of them whose C fills the block GEMM's 128-channel tiles."""
    assert t_attn.core_supported(s, c) is ok
    assert t_attn.supported((2, s, 1, c)) is (ok and c % 128 == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", [(4, 16, 16, 256), (4, 4, 4, 256), (4, 16, 16, 128),
                                   (4, 16, 16, 64), (4, 16, 16, 192), (4, 16, 16, 384),
                                   (4, 8, 8, 64), (4, 4, 8, 256), (4, 6, 8, 256),
                                   (4, 32, 32, 256)])
def test_supported_is_where_block_plan_returns(shape, int8):
    """K5's gate in the bf16 and int8 modes says True exactly where the
    card's plans exist (the core's S and C, the block GEMM's 128-channel
    tiles): the model runs the plain block elsewhere."""
    try:
        t_attn.block_plan(*shape, int8)
        planned = True
    except ValueError:
        planned = False
    assert t_attn.supported(shape, int8) is planned


# --------------------------------------------------------------------------
# (c) the scratch
# --------------------------------------------------------------------------


def carve(b, s, c, h_bytes, a_bytes, splits):
    """The buffers csrc/attnblock.cu:carve takes, each rounded up to 256 bytes."""
    m = b * s
    sizes = {"sc": 4 * b * c, "sh": 4 * b * c, "amax": 4 * 2 * b, "h": h_bytes * m * c,
             "qkv": 2 * m * 3 * c, "a": a_bytes * m * c,
             "partial": 4 * splits * m * 3 * c if splits > 1 else 0}
    return {k: -(-v // 256) * 256 for k, v in sizes.items()}


# (h_bytes, a_bytes) of each route: bf16 (a over h), f32 activations (the
# bf16 route's buffers: h and a bf16), int8 static (a8 over h8), int8 per
# sample (f32 a of its own, a8 over h8)
ROUTES = {"bf16": (2, 0), "f32": (2, 0), "int8-static": (1, 0), "int8-dynamic": (1, 4)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("batch", [4, 64])
@pytest.mark.parametrize("h,c", MAIN_SHAPES, ids=["S256", "S16"])
def test_workspace_holds_every_buffer_of_the_call(h, c, batch, route):
    h_bytes, a_bytes = ROUTES[route]
    s = h * h
    plan = t_attn.block_plan(batch, h, h, c, route.startswith("int8"))
    splits = max(plan.qkv.splits, plan.out.splits)
    got = t_attn.workspace_bytes(batch, s, c, h_bytes, a_bytes, splits)
    bufs = carve(batch, s, c, h_bytes, a_bytes, splits)
    assert got == sum(bufs.values()) and got % 256 == 0
    # a over h where the route has no buffer of its own for a: h holds a bf16 or int8 a
    assert a_bytes or bufs["h"] >= (2 if route == "bf16" else 1) * batch * s * c
    # the partials hold the q/k/v GEMM's splits, the larger product
    assert bufs["partial"] >= (4 * splits * batch * s * 3 * c if splits > 1 else 0)


def test_workspace_grows_with_the_split_partials():
    base = t_attn.workspace_bytes(4, 16, 256, 2, 0, 1)
    # two splits of (M = 64, 3C = 768) f32 partials
    assert t_attn.workspace_bytes(4, 16, 256, 2, 0, 2) == base + 2 * 64 * 768 * 4


# --------------------------------------------------------------------------
# (d) the K-major int8 packing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_mult", [3, 1], ids=["qkv", "out"])
def test_pack_projection_round_trip(n_mult):
    rng = np.random.default_rng(93)
    c = 128
    w = torch.from_numpy(rng.standard_normal((c, n_mult * c)).astype(np.float32))
    q, sc = t_rb.quantize_weight(w)
    packed = t_attn.pack_projection((q, sc))
    assert isinstance(packed, t_attn.KMajorInt8)
    assert packed.q.shape == (n_mult * c, c) and packed.q.is_contiguous()
    assert packed.q.dtype == torch.int8 and packed.scale is sc
    # row n holds output channel n's weights
    assert torch.equal(packed.q[5], q[:, 5])
    assert t_attn.pack_projection(packed) is packed
    back_q, back_sc = t_attn.unpack_projection(packed)
    assert torch.equal(back_q, q) and back_sc is sc
    assert t_attn.unpack_projection((q, sc)) == (q, sc)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_int8_plain_version_takes_either_layout(static):
    args = [torch.from_numpy(a) for a in draw(94, 2, 4, 128)]
    x, gs, gb = args[:3]
    wqkv = t_rb.quantize_weight(torch.cat(args[3:9:2], 1))
    bqkv = torch.cat(args[4:9:2])
    wo, bo = t_rb.quantize_weight(args[9]), args[10]
    scales = torch.tensor([0.05, 0.02]) if static else None
    kw = dict(num_groups=32, skip_rescale=True)
    plain = t_attn.attnblock_int8_reference(x, gs, gb, wqkv, bqkv, wo, bo, scales, **kw)
    packed = t_attn.attnblock_int8_reference(x, gs, gb, t_attn.pack_projection(wqkv), bqkv,
                                             t_attn.pack_projection(wo), bo, scales, **kw)
    assert torch.equal(plain, packed)
    # ... and the wrapper on the CPU is that plain version, packed or not
    got = t_attn.fused_attnblock_int8(x, gs, gb, t_attn.pack_projection(wqkv), bqkv,
                                      t_attn.pack_projection(wo), bo, scales, **kw)
    assert torch.equal(got, plain) and t_attn.fused_attnblock_int8.launches == 0


# --------------------------------------------------------------------------
# (e) the per-block weight cache
# --------------------------------------------------------------------------


def _params(block):
    return [block.q.weight, block.q.bias, block.k.weight, block.k.bias, block.v.weight,
            block.v.bias, block.out.weight, block.out.bias]


def _check_cache(block, got):
    q, k, v, o = block.q, block.k, block.v, block.out
    assert isinstance(got, t_attn.AttnWeights)
    assert got.wqkv.dtype == got.wo.dtype == torch.bfloat16
    assert got.bqkv.dtype == got.bo.dtype == torch.float32
    assert torch.equal(got.wqkv, torch.cat([q.weight, k.weight, v.weight], 1).bfloat16())
    assert torch.equal(got.bqkv, torch.cat([q.bias, k.bias, v.bias]))
    assert torch.equal(got.wo, o.weight.bfloat16()) and torch.equal(got.bo, o.bias)
    assert not any(t.requires_grad for t in got)


def test_attention_weight_cache_is_the_concatenation_and_follows_the_parameters():
    block = AttnBlockpp(64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in _params(block):
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    first = block._weights()
    _check_cache(block, first)
    assert block._weights() is first  # made once
    with torch.no_grad():  # in place
        block.k.weight.add_(1.0)
    second = block._weights()
    assert second is not first
    _check_cache(block, second)
    block.out.bias = torch.nn.Parameter(torch.ones(64))  # by replacement
    third = block._weights()
    assert third is not second
    _check_cache(block, third)
    assert t_attn.unpack_attn_weights(third)[7] is third.bo


def test_int8_weight_cache_keeps_the_jax_layout_on_the_cpu():
    block = AttnBlockpp(128, generator=torch.Generator().manual_seed(1))
    wqkv, bqkv, wo, scales = block._int8_weights(torch.float32, None)
    assert not isinstance(wqkv, t_attn.KMajorInt8) and wqkv[0].shape == (128, 384)
    assert wo[0].shape == (128, 128) and scales is None
    assert block._int8_weights(torch.float32, None)[0] is wqkv


def test_packed_wrapper_on_the_cpu_is_the_plain_composition():
    ts = [torch.from_numpy(a) for a in draw(95, 2, 4, 64)]
    kw = dict(num_groups=16, skip_rescale=True)
    w = t_attn.pack_attn_weights(*ts[3:])
    got = t_attn.fused_attnblock_packed(*ts[:3], w, **kw)
    want = t_attn.attnblock_reference(*ts[:3], *t_attn.unpack_attn_weights(w), **kw)
    assert torch.equal(got, want) and t_attn.fused_attnblock.launches == 0


# --------------------------------------------------------------------------
# (f) the plain versions of the core and of the bare 1x1 GEMMs
# --------------------------------------------------------------------------


def test_core_plain_version_is_the_rounding_point_softmax():
    rng = np.random.default_rng(96)
    qkv = torch.from_numpy(rng.standard_normal((2, 16, 3 * 64)).astype(np.float32)).bfloat16()
    a = t_attn.attention_core(qkv)
    q, k, v = qkv.float().chunk(3, -1)
    p = torch.softmax(q @ k.transpose(1, 2) / 8.0, -1).bfloat16().float()
    assert a.dtype == torch.bfloat16 and a.shape == (2, 16, 64)
    assert rel_err(a.float(), p @ v) <= 2 ** -8
    a32, amax = t_attn.attention_core(qkv, mode="f32")
    assert torch.equal(a32.bfloat16(), a) and torch.equal(amax, a32.abs().amax(dim=(1, 2)))
    s_a = torch.tensor(0.01)
    a8 = t_attn.attention_core(qkv, mode="int8", act_scale=s_a)
    assert a8.dtype == torch.int8 and torch.equal(a8, t_rb.quant_static(a32, s_a).to(torch.int8))


def core_flip_share(s: int) -> float:
    """The share of the core's bf16 a that may differ from its plain version
    at S keys (chip_smoke.py's gate), about 3x what an H100 shows: 3e-3 at
    S >= 64 (measured up to 1.1e-3), 1e-2 at S < 64 (up to 4.2e-3 at S=16,
    where one flipped p moves a by a larger part of its ulp)."""
    return 3e-3 if s >= 64 else 1e-2


def _core_late_normalised(q, k, v):
    """An online-softmax core's rounding points: p = exp(logits - max)
    rounded to bf16 before the division, a = (p v) / sum."""
    logits = (q @ k.transpose(1, 2)) * q.shape[-1] ** (-0.5)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return (e.bfloat16().float() @ v) / e.sum(-1, keepdim=True)


def _core_unrounded_p(q, k, v):
    """A core that feeds p v with p in f32 (no bf16 rounding of p)."""
    logits = (q @ k.transpose(1, 2)) * q.shape[-1] ** (-0.5)
    return torch.softmax(logits, -1) @ v


@pytest.mark.parametrize("core", [_core_late_normalised, _core_unrounded_p],
                         ids=["late-normalised", "unrounded-p"])
@pytest.mark.parametrize("h", [16, 4], ids=["S256", "S16"])
def test_core_flip_gate_rejects_other_rounding_points(core, h):
    """The card's core gate holds the TPU kernel's rounding points: a core
    that rounds p elsewhere differs from the plain version on far more of
    the bf16 values than core_flip_share allows (measured 29-44% on these
    q, k, v), where max|diff| / max|a| alone would not tell them apart
    (6.4e-3 to 7.7e-3)."""
    b, c = 4, 256
    args = [torch.from_numpy(a) for a in draw(103, b, h, c)]
    hn = torch.nn.functional.group_norm(args[0].permute(0, 3, 1, 2), 32, args[1], args[2], 1e-6)
    hn = hn.permute(0, 2, 3, 1).bfloat16().float().reshape(b, h * h, c)
    qkv = (hn @ torch.cat(args[3:9:2], 1).bfloat16().float() + torch.cat(args[4:9:2])).bfloat16()
    want = t_attn.attention_core_reference(qkv)
    other = core(*qkv.float().chunk(3, -1)).bfloat16()
    assert (other != want).float().mean() > 10 * core_flip_share(h * h)


def test_bare_1x1_gemm_plain_versions_are_the_products():
    rng = np.random.default_rng(97)
    a = torch.from_numpy(rng.standard_normal((2, 4, 4, 128)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((128, 384)).astype(np.float32)).bfloat16()
    got = t_rb.bf16_conv_gemm(a, w)
    assert got.dtype == torch.float32 and torch.equal(got, a.float() @ w.float())
    a8 = torch.from_numpy(rng.integers(-127, 128, (2, 4, 4, 128)).astype(np.int8))
    wq = t_attn.pack_projection(t_rb.quantize_weight(w.float())).q  # K-major (384, 128)
    got8 = t_rb.int8_conv_gemm(a8, wq)
    assert got8.shape == (2, 4, 4, 384)
    assert torch.equal(got8, (a8.double() @ wq.t().double()).float())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

# Against the plain versions on the same inputs (bf16 x and weights): the
# blocks write bf16 (a rounding of 2^-8 relative), as chip_smoke.py's gates
KERNEL_BOUND = 1e-2
# The core against its plain version on the same bf16 q, k, v: the same
# rounding points, f32 sums in another order flipping a bf16 rounding of p
# or a now and then: measured on an H100 max|diff| / max|a| up to 3.1e-3
# (bf16 a) and 1.1e-3 (f32 a), bf16 values differing on at most
# core_flip_share(S) of them, int8 values one step apart on up to 4.6e-5 of
# them
CORE_INT8_FLIP_SHARE = 1e-3
# K5 bf16 against its rounding-point plain version (f32 out), measured 2.1e-3
# to 2.4e-3 on an H100 at B=4/16/64 on both shapes: the kernel's bf16 output
# rounding; about 3x
RP_BOUND = 7e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _card_args(seed, b, h, c, device):
    return [torch.from_numpy(a).to(device) for a in draw(seed, b, h, c)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,stages", [(4, 256, 2), (4, 256, 4), (64, 256, 2), (64, 256, 4),
                                         (4, 16, 4), (3, 16, 4), (2, 64, 2), (2, 64, 4)])
def test_core_matches_plain(cuda, b, s, stages):
    g = torch.Generator(device=cuda).manual_seed(98)
    qkv = torch.randn((b, s, 768), generator=g, device=cuda).bfloat16()
    with torch.no_grad():
        got = t_attn.attention_core(qkv, stages=stages)
        a32, amax = t_attn.attention_core(qkv, mode="f32", stages=stages)
        s_a = torch.full((), 0.005, device=cuda)
        a8 = t_attn.attention_core(qkv, mode="int8", act_scale=s_a, stages=stages)
    want = t_attn.attention_core_reference(qkv)
    assert got.dtype == torch.bfloat16 and _kernel_rel(got, want) <= KERNEL_BOUND
    assert (got != want).float().mean() <= core_flip_share(s)
    want32, want_amax = t_attn.attention_core_reference(qkv, mode="f32")
    assert _kernel_rel(a32, want32) <= KERNEL_BOUND and _kernel_rel(amax, want_amax) <= KERNEL_BOUND
    step8 = (a8.int() - t_attn.attention_core_reference(qkv, mode="int8", act_scale=s_a).int()).abs()
    assert step8.max() <= 1 and (step8 > 0).float().mean() <= CORE_INT8_FLIP_SHARE
    # the three outputs come from the same sums
    assert torch.equal(a32.bfloat16(), got)
    assert torch.equal(a8, t_rb.quant_static(a32, s_a).to(torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(4, 16), (64, 16), (4, 4), (64, 4)])
def test_attnblock_kernel_matches_rounding_point_plain(cuda, b, h):
    args = _card_args(99, b, h, 256, cuda)
    args[0] = args[0].bfloat16()
    kw = dict(num_groups=32, skip_rescale=True)
    launches = t_attn.fused_attnblock.launches
    t_rb.block_launches(reset=True)
    with torch.no_grad():
        out = t_attn.fused_attnblock(*args, **kw)
        packed = t_attn.fused_attnblock_packed(*args[:3], t_attn.pack_attn_weights(*args[3:]),
                                               **kw)
    torch.cuda.synchronize()
    want = t_attn.attnblock_bf16_reference(args[0].float(), *args[1:], **kw)
    assert out.dtype == torch.bfloat16 and torch.equal(out, packed)
    assert _kernel_rel(out, want) <= RP_BOUND
    assert _kernel_rel(out, t_attn.attnblock_reference(args[0].float(), *args[1:], **kw)) \
        <= KERNEL_BOUND
    assert t_attn.fused_attnblock.launches == launches + 2
    # per block: the two projections, the core and GN in one launch (its
    # statistics and h), counted in C
    assert t_rb.block_launches(reset=True) == {
        **dict.fromkeys(t_rb.BLOCK_COUNTED, 0), "block_gemm_kernel<bf16>": 4,
        "attention_wgmma_kernel": 2, "gn_apply_kernel": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("b,h", [(4, 16), (64, 16), (4, 4)])
def test_attnblock_int8_kernel_counts_its_launches(cuda, static, b, h):
    args = _card_args(100, b, h, 256, cuda)
    x = args[0].bfloat16().float()
    wqkv = t_attn.pack_projection(t_rb.quantize_weight(torch.cat(args[3:9:2], 1)))
    wo = t_attn.pack_projection(t_rb.quantize_weight(args[9]))
    bqkv, bo = torch.cat(args[4:9:2]), args[10]
    scales = torch.tensor([0.05, 0.02], device=cuda) if static else None
    kw = dict(num_groups=32, skip_rescale=True)
    t_rb.block_launches(reset=True)
    with torch.no_grad():
        out = t_attn.fused_attnblock_int8(x.bfloat16(), *args[1:3], wqkv, bqkv, wo, bo, scales,
                                          **kw)
    torch.cuda.synchronize()
    ref = t_attn.attnblock_int8_reference(x, *args[1:3], wqkv, bqkv, wo, bo, scales, **kw)
    assert out.dtype == torch.bfloat16 and _kernel_rel(out, ref) <= KERNEL_BOUND
    # GN in one launch quantizes h (per sample after its own amax); the
    # per-sample mode's a goes through the pre-pass
    assert t_rb.block_launches(reset=True) == {
        **dict.fromkeys(t_rb.BLOCK_COUNTED, 0), "block_gemm_kernel<int8>": 2,
        "prepass_kernel<int8>": 0 if static else 1, "attention_wgmma_kernel": 1,
        "gn_apply_kernel": 1}


@pytest.mark.cuda
def test_int8_wrapper_refuses_unpacked_weights(cuda):
    args = _card_args(101, 2, 16, 256, cuda)
    wqkv = t_rb.quantize_weight(torch.cat(args[3:9:2], 1))
    wo = t_rb.quantize_weight(args[9])
    with torch.no_grad(), pytest.raises(ValueError, match="pack_projection"):
        t_attn.fused_attnblock_int8(args[0].bfloat16(), *args[1:3], wqkv,
                                    torch.cat(args[4:9:2]), wo, args[10], num_groups=32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,int8", [((2, 16, 16, 192), False), ((2, 16, 16, 192), True),
                                        ((2, 16, 16, 64), False), ((2, 6, 8, 256), False)],
                         ids=["c192-bf16", "c192-int8", "c64-bf16", "s48-bf16"])
def test_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda, shape, int8):
    """On the card K5 takes C = 128 or 256 (the block GEMM's 128-channel N
    tile; int8 also its 128-channel K slice) and S = 16, 32 or a multiple of
    64 up to 256; any other shape raises rather than falling back."""
    b, h, w, c = shape
    g = torch.Generator(device=cuda).manual_seed(104)
    x = torch.randn(shape, generator=g, device=cuda).bfloat16()
    gs, gb = torch.ones(c, device=cuda), torch.zeros(c, device=cuda)
    nin = [t for _ in range(4) for t in (torch.randn((c, c), generator=g, device=cuda) / 16,
                                         torch.zeros(c, device=cuda))]
    with torch.no_grad(), pytest.raises(ValueError, match="plan"):
        if int8:
            wqkv = t_attn.pack_projection(t_rb.quantize_weight(torch.cat(nin[0:6:2], 1)))
            wo = t_attn.pack_projection(t_rb.quantize_weight(nin[6]))
            t_attn.fused_attnblock_int8(x, gs, gb, wqkv, torch.cat(nin[1:6:2]), wo, nin[7],
                                        num_groups=32)
        else:
            t_attn.fused_attnblock(x, gs, gb, *nin, num_groups=32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n", [(64, 16, 768), (64, 16, 256), (4, 4, 768), (64, 4, 256)])
def test_bare_1x1_gemms_match_the_products(cuda, b, h, n):
    g = torch.Generator(device=cuda).manual_seed(102)
    a = torch.randn((b, h, h, 256), generator=g, device=cuda).bfloat16()
    w = (torch.randn((256, n), generator=g, device=cuda) / 16).bfloat16()
    with torch.no_grad():
        got = t_rb.bf16_conv_gemm(a, w)
        a8 = torch.randint(-127, 128, (b, h, h, 256), generator=g, device=cuda,
                           dtype=torch.int8)
        wq = t_attn.pack_projection(t_rb.quantize_weight(w.float())).q
        got8 = t_rb.int8_conv_gemm(a8, wq)
    assert _kernel_rel(got, a.float() @ w.float()) <= KERNEL_BOUND
    assert torch.equal(got8, t_rb.int8_matmul_exact(a8, wq.t()))
