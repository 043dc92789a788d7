"""The block GEMM's bf16 mode under K2/K3/K4/K9 on bf16 activations
(``csrc/block_gemm.cu``), its bf16 pre-pass (``csrc/resblock.cu``) and what
surrounds them in Python, on the CPU:

(a) ``bf16_tile_plan`` at every bf16 block conv of the main path
    (cld/accr_dcifar10, conv_impl 'fused') at B = 4, 16, 64 and 128: the
    tiles cover M and N, the splits cover K in whole slices, in order, and
    the ring fits in shared memory; shapes the kernel does not take raise;
(b) the pre-pass's plain version against the JAX package's rounding point:
    the same per-(sample, channel) affine, SiLU, then ``astype(bfloat16)``;
(c) K2/K3/K4's plain versions with the TPU kernels' rounding points (f32 h1,
    bf16 a1 and a2) against ``fused_resblock`` / ``fused_resblock_pair`` /
    ``fused_resblock_tail`` with ``mm_dtype=jnp.bfloat16`` in interpret
    mode, beside the composition that rounds h1 to bf16 before GN2 (what the
    bf16 blocks did before they kept h1 in f32).

Cases marked ``cuda`` hold the kernels against their plain versions on the
card (the bare GEMM against the f32 conv, the pre-pass, K2/K3/K4/K9 bf16 at
B=4 and 64), count their launches in C, and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch.ops import resblock as t_rb

TEMB = 16


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    has no JAX)."""
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import resblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jax=jax, jnp=jnp, rb=resblock, pltpu=pltpu)


# The main path's residual blocks, (H, Cin parts, Cout) at the convs'
# resolution: K2's stride-1 blocks, K3's up-path pairs, K4's and K9's
# transitions (the same convs: K9's at its output resolution, xr the skip)
BLOCKS = {
    "K2": [(32, (128,), 128), (16, (128,), 256), (16, (256,), 256), (8, (256,), 256),
           (4, (256,), 256)],
    "K3": [(4, (256, 256), 256), (8, (256, 256), 256), (16, (256, 256), 256),
           (16, (256, 128), 256), (32, (256, 128), 128), (32, (128, 128), 128)],
    "K4": [(16, (128,), 128), (8, (256,), 256), (4, (256,), 256), (16, (256,), 256),
           (32, (256,), 256)],
    "K9": [(16, (128,), 128), (8, (256,), 256), (4, (256,), 256), (8, (256,), 256),
           (16, (256,), 256), (32, (256,), 256)],
}


def block_convs(kind):
    """(H, Cin, Cskip, Cout) of each block's conv1 and conv2 (+ skip)."""
    for h, parts, cout in BLOCKS[kind]:
        cin = sum(parts)
        skip = 0 if kind == "K2" and cin == cout else cin
        yield h, cin, 0, cout
        yield h, cout, skip, cout


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def bf16_steps(got, want):
    """|got - want| of bf16 values in bf16 ulps of want: 2^(e - 8) for
    |want| in [2^(e-1), 2^e)."""
    w = torch.tensor(np.asarray(want, np.float32))
    e = torch.frexp(w)[1]
    d = (torch.tensor(np.asarray(got, np.float32)) - w).abs()
    return (d / torch.ldexp(torch.ones_like(w), e - 8)).numpy()


# --------------------------------------------------------------------------
# (a) the tile plan
# --------------------------------------------------------------------------


def tile_pixels(plan, b, h, w, t):
    """The pixels (indices into M) of M tile t's rows that lie in the image,
    as the kernel maps them (tile_row), and the number of rows past it."""
    r = np.arange(plan.mw * t_rb.GEMM_TILE_M)
    per_sample = w * plan.box_h
    bb = t // plan.tiles_h * plan.box_b + r // per_sample
    y = t % plan.tiles_h * plan.box_h + (r // w) % plan.box_h
    inside = (r < per_sample * plan.box_b) & (bb < b) & (y < h)
    return ((bb * h + y) * w + r % w)[inside]


def ring_bytes(mw):
    """Shared memory of block_gemm_kernel at tiles of 128 * mw pixels
    (Tile<mw> in csrc/block_gemm.cu, held to the same limits there by
    static_assert): 3 stages (mw 1) or 4 (mw 2), each the A box (128 bytes a
    pixel: 64 bf16 channels) and the 64 x 128 bf16 weight box; 1 KB to
    align; two barriers a stage."""
    stages = 3 if mw == 1 else 4
    return stages * (mw * 128 * 128 + 64 * 128 * 2) + 1024 + 16 * stages


@pytest.mark.parametrize("batch", [4, 16, 64, 128])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_bf16_tile_plan_covers_every_main_path_conv(kind, batch):
    for h, cin, cskip, n in block_convs(kind):
        plan = t_rb.bf16_tile_plan(batch, h, h, cin, cskip, n)
        what = (kind, batch, h, cin, cskip, n)
        # M: every pixel in exactly one tile, each tile one box of whole rows
        assert plan.mw in (1, 2) and h * plan.box_h * plan.box_b <= plan.mw * 128, what
        assert max(plan.box_h, plan.box_b, h) <= 256, what
        pix = np.concatenate([tile_pixels(plan, batch, h, h, t) for t in range(plan.m_tiles)])
        assert np.array_equal(np.sort(pix), np.arange(batch * h * h)), what
        # ... and a tile's pixels are consecutive rows of M (the skip's 2-D box)
        for t in range(plan.m_tiles):
            p = tile_pixels(plan, batch, h, h, t)
            assert np.array_equal(p, p[0] + np.arange(len(p))), what
        # N: whole tiles of 128 channels (the grid's Cout / 128)
        assert n % t_rb.GEMM_TILE_N == 0, what
        # K: the conv in whole 64-channel bf16 slices (no slice across two
        # taps), then the skip's; the splits run over them in order, none empty
        assert plan.conv_slices * t_rb.BF16_SLICE == 9 * cin and cin % t_rb.BF16_SLICE == 0, what
        assert plan.skip_slices * t_rb.GEMM_SKIP_SLICE == cskip, what
        slices = plan.conv_slices + plan.skip_slices
        runs = [range(z * plan.kper, min((z + 1) * plan.kper, slices)) for z in range(plan.splits)]
        assert [s for run in runs for s in run] == list(range(slices)), what
        assert all(len(run) > 0 for run in runs), what
        # shared memory: one CTA of 256-pixel tiles an SM, two of 128-pixel ones
        assert ring_bytes(plan.mw) <= 227 * 1024, what
        if plan.mw == 1:
            assert 2 * (ring_bytes(plan.mw) + 1024) <= 228 * 1024, what


@pytest.mark.parametrize("args", [(4, 8, 8, 96, 0, 128), (4, 8, 8, 128, 0, 64),
                                  (4, 8, 8, 128, 32, 128), (1, 2, 256, 128, 0, 128)],
                         ids=["cin", "cout", "skip", "width"])
def test_bf16_tile_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="no tile plan"):
        t_rb.bf16_tile_plan(*args)


def test_bf16_tile_plan_uses_wide_tiles_and_splits_where_the_grid_needs_them():
    """256-pixel tiles at B=64 32x32 (256 CTAs); split K at B=4 4x4 (one M
    tile), with the bf16 slices of 64 channels twice the int8 plan's count."""
    wide = t_rb.bf16_tile_plan(64, 32, 32, 128, 0, 128)
    assert wide.mw == 2 and wide.splits == 1 and wide.conv_slices == 18
    small = t_rb.bf16_tile_plan(4, 4, 4, 256, 256, 256)
    assert small.mw == 1 and small.m_tiles == 1 and small.splits > 1
    assert small.conv_slices == 2 * t_rb.s8_tile_plan(4, 4, 4, 256, 256, 256).conv_slices


def test_bare_gemm_plain_version_is_the_f32_conv():
    """On the CPU ``bf16_conv_gemm`` is the f32 conv of the bf16 values."""
    rng = np.random.default_rng(70)
    a = torch.from_numpy(rng.standard_normal((2, 4, 4, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 3, 64, 128)).astype(np.float32)).bfloat16()
    got = t_rb.bf16_conv_gemm(a, w)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 4, 128)
    assert torch.equal(got, t_rb.conv3x3_nhwc(a.float(), w.float()))


# --------------------------------------------------------------------------
# (b) the pre-pass's plain version against the JAX rounding point
# --------------------------------------------------------------------------

# a value near a bf16 rounding boundary rounds by the last bit of its SiLU,
# and jax.nn.sigmoid and torch.sigmoid may differ by an f32 ulp: at most one
# bf16 ulp apart, on at most this share of the values
FLIP_SHARE = 1e-3

# the bf16 pre-pass's inputs: conv1 of K2 (bf16 x, GN1 affine + SiLU), of K3
# (the pair's two bf16 parts), and conv2 (f32 h1, GN2 affine + SiLU)
PREPASS_INPUTS = {"gn_silu": ((128,), True), "pair": ((128, 256), True), "h1": ((256,), False)}


@pytest.mark.parametrize("site", sorted(PREPASS_INPUTS))
def test_bf16_prepass_plain_matches_jax_rounding_point(jx, site):
    parts, bf16_in = PREPASS_INPUTS[site]
    rng = np.random.default_rng(71)
    c = sum(parts)
    xs = [(rng.standard_normal((2, 8, 8, p)) * (1 if bf16_in else 2)).astype(np.float32)
          for p in parts]
    if bf16_in:
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    sc = (1.0 + 0.3 * rng.standard_normal((2, c))).astype(np.float32)
    sh = (0.2 * rng.standard_normal((2, c))).astype(np.float32)
    t = [torch.from_numpy(x) for x in xs]
    got = t_rb.bf16_conv_input(t[0], t[1] if len(t) > 1 else None, torch.from_numpy(sc),
                               torch.from_numpy(sh), silu=True)
    # the TPU kernels: out = x * a + b, out * sigmoid(out), a1.astype(mm_dtype)
    jnp = jx.jnp
    a = jnp.asarray(np.concatenate(xs, -1)) * jnp.asarray(sc)[:, None, None, :] \
        + jnp.asarray(sh)[:, None, None, :]
    want = np.asarray((a * jx.jax.nn.sigmoid(a)).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 8, c)
    step = bf16_steps(got.float().numpy(), want)
    assert step.max() <= 1 and (step > 0).mean() <= FLIP_SHARE


# --------------------------------------------------------------------------
# (c) the bf16 blocks' rounding points against the JAX kernels
# --------------------------------------------------------------------------

# The plain versions with the TPU kernels' rounding points against the bf16
# kernels in interpret mode, max|diff| / max|out|: the same roundings, f32
# sums in another order, which flip a bf16 rounding of a1 or a2 now and then;
# measured 2.4e-7 to 7.2e-5 over the 8 cases below, about 7x under the
# bound. The composition that rounds h1 to bf16 before GN2 measured 1.31e-3
# to 1.86e-3 on the same cases, outside it.
BF16_REL = 5e-4

# (kind, H, Cin parts, Cout, skip) at a small width, B=2
ROUNDING_CASES = {"K2": (8, (64,), 64, False), "K2-skip": (8, (64,), 128, True),
                  "K3": (8, (64, 32), 64, True), "K4": (8, (64,), 128, True)}


def _draw_block(seed, kind, h, parts, cout, skip):
    rng = np.random.default_rng(seed)

    def act(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def vec(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    def bf(a):  # bf16 values, as the bf16 blocks receive x
        return torch.from_numpy(a).bfloat16().float().numpy()

    cin = sum(parts)
    xs = [bf(act(2, h, h, c)) for c in parts]
    if kind == "K4":  # h (silu(GN1(x)) resampled) and the resampled x
        xs = [bf(act(2, h, h, cin)), bf(act(2, h, h, cin))]
    temb = (act(2, TEMB), w(TEMB, cout), vec(cout))
    body = [vec(cin, 1.0), vec(cin), w(3, 3, cin, cout), vec(cout), vec(cout, 1.0), vec(cout),
            w(3, 3, cout, cout), vec(cout)]
    sk = [w(cin, cout), vec(cout)] if skip else [None, None]
    return xs, temb, body, sk


def _t(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _temb_proj(temb, w, b):
    t = temb.astype(np.float64)
    return ((t / (1 + np.exp(-t))) @ w + b).astype(np.float32)


def _jax_block(jx, kind, xs, temb, body, sk, kw):
    j = [None if a is None else jx.jnp.asarray(a) for a in xs + [_temb_proj(*temb)] + body + sk]
    bf16 = jx.jnp.bfloat16
    with jx.pltpu.force_tpu_interpret_mode():
        if kind == "K4":
            out = jx.rb.fused_resblock_tail(*j[:3], *j[5:], mm_dtype=bf16,
                                            num_groups2=kw["num_groups2"])
        elif kind == "K3":
            out = jx.rb.fused_resblock_pair(*j, mm_dtype=bf16, **kw)
        else:
            out = jx.rb.fused_resblock(*j, mm_dtype=bf16, **kw)
    return np.asarray(out)


def _port_block(kind, xs, temb, body, sk, kw):
    args = _t(xs) + _t(list(temb))
    if kind == "K4":
        return t_rb.resblock_tail_bf16_reference(*args, *_t(body[2:] + sk),
                                                 num_groups2=kw["num_groups2"])
    if kind == "K3":
        return t_rb.resblock_pair_bf16_reference(*args, *_t(body + sk), **kw)
    return t_rb.resblock_bf16_reference(*args, *_t(body + sk), **kw)


def _h1_bf16_block(kind, xs, temb, body, sk, kw):
    """The same block with h1 rounded to bf16 before GN2's statistics and
    affine (the rounding the bf16 blocks had before h1 stayed f32)."""
    r = t_rb._bf16r
    g1s, g1b, w1, b1, g2s, g2b, w2, b2 = _t(body)
    if kind == "K4":
        a1, x = r(torch.from_numpy(xs[0])), torch.from_numpy(xs[1])
    else:
        x = torch.cat(_t(xs), -1)
        a1 = r(t_rb.group_norm_tpu(x, g1s, g1b, kw["num_groups1"], 1e-6, True, True))
    h1 = t_rb.conv3x3_nhwc(a1, r(w1), b1) + t_rb.temb_projection(*_t(list(temb)))[:, None, None]
    a2 = r(t_rb.group_norm_tpu(r(h1), g2s, g2b, kw["num_groups2"], 1e-6, True, True))
    out = t_rb.conv3x3_nhwc(a2, r(w2), b2)
    ws, bs = _t(sk)
    return (out + (x if ws is None else r(x) @ r(ws) + bs)) * t_rb._INV_SQRT2


@pytest.mark.parametrize("seed", [72, 73])
@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_bf16_block_rounding_points_match_jax_bf16_kernels(jx, case, seed):
    kind = case.split("-")[0]
    h, parts, cout, skip = ROUNDING_CASES[case]
    xs, temb, body, sk = _draw_block(seed, kind, h, parts, cout, skip)
    cin = sum(parts)
    kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
    want = _jax_block(jx, kind, xs, temb, body, sk, kw)
    got = _port_block(kind, xs, temb, body, sk, kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err, err_h1_bf16 = rel_err(got, want), rel_err(_h1_bf16_block(kind, xs, temb, body, sk, kw),
                                                   want)
    assert err <= BF16_REL, (err, err_h1_bf16)
    # the bound tells the two rounding points apart
    assert err_h1_bf16 > BF16_REL, (err, err_h1_bf16)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

# The bare GEMM against the f32 conv of the same bf16 values, and the blocks
# against their plain versions with the TPU kernels' rounding points: about
# 3x the errors chip_smoke.py measures on an H100 (K11's and the blocks' gate)
KERNEL_BOUND = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,cin,n", [(4, 32, 128, 128), (4, 4, 256, 256), (4, 8, 512, 256),
                                           (16, 16, 384, 256), (64, 32, 384, 128),
                                           (64, 16, 256, 256)])
def test_bf16_gemm_matches_f32_conv(cuda, batch, h, cin, n):
    """Every tile height and split the main path plans."""
    g = torch.Generator(device=cuda).manual_seed(80)
    a = torch.randn((batch, h, h, cin), generator=g, device=cuda).bfloat16()
    w = (torch.randn((3, 3, cin, n), generator=g, device=cuda) / (9 * cin) ** 0.5).bfloat16()
    with torch.no_grad():
        got = t_rb.bf16_conv_gemm(a, w)
    want = t_rb.conv3x3_nhwc(a.float(), w.float())
    assert got.dtype == torch.float32 and _kernel_rel(got, want) <= KERNEL_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(PREPASS_INPUTS))
def test_bf16_prepass_kernel_matches_plain(cuda, site):
    parts, bf16_in = PREPASS_INPUTS[site]
    g = torch.Generator(device=cuda).manual_seed(81)
    c = sum(parts)
    dt = torch.bfloat16 if bf16_in else torch.float32
    xs = [torch.randn((4, 16, 16, p), generator=g, device=cuda).to(dt) for p in parts]
    sc = 1.0 + 0.3 * torch.randn((4, c), generator=g, device=cuda)
    sh = 0.2 * torch.randn((4, c), generator=g, device=cuda)
    x1 = xs[1] if len(xs) > 1 else None
    with torch.no_grad():
        got = t_rb.bf16_conv_input(xs[0], x1, sc, sh, silu=True)
    want = t_rb.bf16_conv_input_reference(xs[0], x1, sc, sh, silu=True)
    step = bf16_steps(got.float().cpu().numpy(), want.float().cpu().numpy())
    assert got.dtype == torch.bfloat16 and step.max() <= 1 and (step > 0).mean() <= FLIP_SHARE


# each kind's bf16 wrapper and its plain version with the TPU kernel's rounding points
OPS = {"K2": (t_rb.fused_resblock, t_rb.resblock_bf16_reference),
       "K3": (t_rb.fused_resblock_pair, t_rb.resblock_pair_bf16_reference),
       "K4": (t_rb.fused_resblock_tail, t_rb.resblock_tail_bf16_reference),
       "K9": (t_rb.fused_resblock_transition, t_rb.resblock_transition_bf16_reference)}


def _card_block(kind, h, parts, cout, batch, device):
    """Seeded operands of one bf16 block on the card: x (parts) bf16, the
    rest f32 (the wrappers cast the weights to bf16; the plain versions
    round them so)."""
    g = torch.Generator(device=device).manual_seed(82)

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=device)

    cin = sum(parts)
    hin = 2 * h if kind == "K9" else h  # K9: a down transition onto h x h
    xs = [r(batch, hin, hin, c).bfloat16() for c in parts]
    if kind == "K4":
        xs.append(r(batch, h, h, cin).bfloat16())  # the resampled x, the skip's input
    skip = kind != "K2" or cin != cout
    head = [r(batch, TEMB), r(TEMB, cout, scale=TEMB ** -0.5), r(cout, scale=0.1)]
    gn1 = [] if kind == "K4" else [1 + r(cin, scale=0.1), r(cin, scale=0.1)]
    body = [r(3, 3, cin, cout, scale=(9 * cin) ** -0.5), r(cout, scale=0.1), 1 + r(cout, scale=0.1),
            r(cout, scale=0.1), r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), r(cout, scale=0.1)]
    sk = [r(cin, cout, scale=cin ** -0.5), r(cout, scale=0.1)] if skip else [None, None]
    kw = dict(num_groups2=32) if kind == "K4" else dict(num_groups1=32, num_groups2=32)
    if kind == "K9":
        kw["up"] = False
    return xs + head + gn1 + body + sk, kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 64])
@pytest.mark.parametrize("kind,block", [("K2", 0), ("K2", 4), ("K3", 0), ("K3", 4), ("K4", 1),
                                        ("K9", 5)])
def test_bf16_block_kernels_match_plain(cuda, kind, block, batch):
    """K2/K3/K4/K9 bf16 on the block GEMM within the bf16 bound of their
    plain versions with the TPU kernels' rounding points: small and large
    grids, split K, both tile heights, the identity and the 1x1 skip."""
    h, parts, cout = BLOCKS[kind][block]
    args, kw = _card_block(kind, h, parts, cout, batch, cuda)
    fused, plain = OPS[kind]
    with torch.no_grad():
        out = fused(*args, **kw)
        ref = plain(*[a.float() if a is not None else None for a in args], **kw)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert _kernel_rel(out, ref) <= KERNEL_BOUND


@pytest.mark.cuda
def test_bf16_blocks_refuse_shapes_the_gemm_does_not_take(cuda):
    """Cout 64 has no tile plan: the bf16 block raises on the card (no
    fallback to conv_gemm_kernel or to the plain version)."""
    args, kw = _card_block("K2", 8, (64,), 64, 2, cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="no tile plan"):
        t_rb.fused_resblock(*args, num_groups1=16, num_groups2=16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_bf16_launch_counts_count_each_launch(cuda, kind):
    """The bf16 GEMM and pre-pass are counted in C where they launch: once a
    bare wrapper call, twice and once a block (conv1, conv2; conv1's operand
    comes from GN1's one launch, or K4's h as it is), nothing for a call on
    the CPU, and never as the int8 kernels."""
    gemm, prepass = t_rb.BF16_COUNTED
    h, parts, cout = BLOCKS[kind][1]
    args, kw = _card_block(kind, h, parts, cout, 2, cuda)
    t_rb.block_launches(reset=True)
    with torch.no_grad():
        plain_args = [a.cpu() if a is not None else None for a in args]
        OPS[kind][0](*plain_args, **kw)  # the CPU: the plain version
        assert t_rb.block_launches(kernels=(gemm, prepass)) == {gemm: 0, prepass: 0}
        a = torch.ones((1, 4, 4, 128), dtype=torch.bfloat16, device=cuda)
        t_rb.bf16_conv_gemm(a, torch.ones((3, 3, 128, 128), dtype=torch.bfloat16, device=cuda))
        assert t_rb.block_launches(kernels=(gemm, prepass)) == {gemm: 1, prepass: 0}
        t_rb.bf16_conv_input(a)
        assert t_rb.block_launches(kernels=(gemm, prepass)) == {gemm: 1, prepass: 1}
        OPS[kind][0](*args, **kw)
        torch.cuda.synchronize()
    # and GN1's one-launch kernel once a block with GN1 (K4's h comes with it);
    # the block's pre-pass is GN2's folding one, counted apart too
    want = {gemm: 3, prepass: 2, "gn_apply_kernel": 0 if kind == "K4" else 1,
            "gn_prepass_kernel": 1}
    assert t_rb.block_launches(reset=True) == {**dict.fromkeys(t_rb.BLOCK_COUNTED, 0), **want}
    assert t_rb.block_launches() == dict.fromkeys(t_rb.BLOCK_COUNTED, 0)
