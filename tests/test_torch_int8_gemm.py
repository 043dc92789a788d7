"""The int8 block GEMM of K2/K3/K4/K9's int8 modes (``csrc/block_gemm.cu``) and
what surrounds it in Python, on the CPU:

(a) ``s8_tile_plan`` at every int8 conv of the main path (cld/accr_dcifar10,
    conv_impl 'fused_int8') at B = 4, 16, 64 and 128: the tiles cover M and
    N, the splits cover K in whole slices, in order, and the ring fits in
    shared memory;
(b) ``pack_int8_weight``: the K-major layout round-trips, and a product
    through it equals the HWIO product exactly in integer arithmetic;
(c) the quantize pre-pass's plain version against the JAX package's int8
    quantization of the same GN-affine(+SiLU) input (static, per sample, and
    the pair's a * (127 / amax));
(d) the int8 network through ``models/blocks.py`` with the weights packed
    K-major against the same network with HWIO weights.

Cases marked ``cuda`` hold the kernels against their plain versions on the
card (the GEMM's sums bit for bit) and skip without one.
"""

import functools
import types

import numpy as np
import pytest
import torch

from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models import blocks
from gddim_torch.models.calibrate import calibrate_cld_qscales
from gddim_torch.models.init import seeded_model
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.ops import conv3x3 as t_c3
from gddim_torch.ops import resblock as t_rb


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    has no JAX)."""
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import resblock

    return types.SimpleNamespace(jax=jax, jnp=jnp, rb=resblock)


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


# --------------------------------------------------------------------------
# (a) the tile plan
# --------------------------------------------------------------------------


def tile_pixels(plan, b, h, w, t):
    """The pixels (indices into M) of M tile t's rows that lie in the image,
    as the kernel maps them (s8_row), and the number of rows past it."""
    r = np.arange(plan.mw * t_rb.GEMM_TILE_M)
    per_sample = w * plan.box_h
    bb = t // plan.tiles_h * plan.box_b + r // per_sample
    y = t % plan.tiles_h * plan.box_h + (r // w) % plan.box_h
    inside = (r < per_sample * plan.box_b) & (bb < b) & (y < h)
    return ((bb * h + y) * w + r % w)[inside]


def ring_bytes(mw):
    """Shared memory of block_gemm_kernel at tiles of 128 * mw pixels, as
    csrc/block_gemm.cu lays it out (Tile<mw>, held to the same limits there
    by static_assert): 3 stages (mw 1) or 4 (mw 2), each the A box (128
    bytes a pixel) and the 128 x 128 weight box; 1 KB to align; two
    barriers a stage."""
    stages = 3 if mw == 1 else 4
    return stages * (mw * 128 * 128 + 128 * 128) + 1024 + 16 * stages


@pytest.mark.parametrize("batch", [4, 16, 64, 128])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_s8_tile_plan_covers_every_main_path_conv(kind, batch):
    for h, cin, cskip, n in block_convs(kind):
        plan = t_rb.s8_tile_plan(batch, h, h, cin, cskip, n)
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
        # K: the conv in whole 128-channel slices, then the skip in 64-channel
        # ones; the splits run over them in order, none empty
        assert plan.conv_slices * t_rb.S8_SLICE == 9 * cin, what
        assert plan.skip_slices * t_rb.GEMM_SKIP_SLICE == cskip, what
        slices = plan.conv_slices + plan.skip_slices
        runs = [range(z * plan.kper, min((z + 1) * plan.kper, slices)) for z in range(plan.splits)]
        assert [s for run in runs for s in run] == list(range(slices)), what
        assert all(len(run) > 0 for run in runs), what
        # shared memory: one CTA of 256-pixel tiles an SM, two of 128-pixel
        # ones (each with the 1 KB the runtime keeps per block)
        assert ring_bytes(plan.mw) <= 227 * 1024, what
        if plan.mw == 1:
            assert 2 * (ring_bytes(plan.mw) + 1024) <= 228 * 1024, what


def test_s8_tile_plan_refuses_what_the_kernel_does_not_take():
    for args in [(4, 8, 8, 64, 0, 128), (4, 8, 8, 128, 0, 64), (4, 8, 8, 128, 32, 128),
                 (1, 2, 256, 128, 0, 128)]:
        with pytest.raises(ValueError, match="no tile plan"):
            t_rb.s8_tile_plan(*args)


def test_s8_tile_plan_uses_wide_tiles_and_splits_where_the_grid_needs_them():
    """256-pixel tiles at B=64 32x32 (256 CTAs); split K at B=4 4x4 (one
    M tile)."""
    assert t_rb.s8_tile_plan(64, 32, 32, 128, 0, 128).mw == 2
    assert t_rb.s8_tile_plan(64, 32, 32, 128, 0, 128).splits == 1
    small = t_rb.s8_tile_plan(4, 4, 4, 256, 0, 256)
    assert small.mw == 1 and small.m_tiles == 1 and small.splits > 1


# --------------------------------------------------------------------------
# (b) the K-major weights
# --------------------------------------------------------------------------


def _int8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


@pytest.mark.parametrize("cin,n", [(128, 128), (384, 256), (512, 256)])
def test_pack_int8_weight_round_trips(cin, n):
    rng = np.random.default_rng(50)
    wq, sc = _int8(rng, 3, 3, cin, n), torch.rand(n)
    wk, sk = t_rb.pack_int8_weight((wq, sc))
    assert wk.shape == (n, 9 * cin) and wk.dtype == torch.int8 and wk.is_contiguous()
    assert sk is sc
    assert torch.equal(t_rb.hwio_int8_weight(wk, cin), wq)
    assert torch.equal(t_rb.hwio_int8_weight(wq, cin), wq)  # HWIO stays as it is
    # row n is output channel n's weights in the HWIO K order (tap, channel)
    assert torch.equal(wk[7].reshape(3, 3, cin), wq[..., 7])


@pytest.mark.parametrize("cin,n", [(128, 128), (256, 256)])
def test_packed_product_equals_hwio_product_exactly(cin, n):
    rng = np.random.default_rng(51)
    wq = _int8(rng, 3, 3, cin, n)
    wk, _ = t_rb.pack_int8_weight((wq, torch.ones(n)))
    a = _int8(rng, 64, 9 * cin).long()  # im2col rows of int8 activations
    want = a @ wq.reshape(9 * cin, n).long()
    assert torch.equal((wk.long() @ a.t()).t(), want)
    # the conv through the pack: the GEMM's plain version on either layout
    x = _int8(rng, 2, 4, 4, cin)
    assert torch.equal(t_rb.int8_conv_gemm(x, wk), t_rb.conv3x3_int8_exact(x, wq))


def _block_args(rng, kind, h, parts, cout, batch=2):
    """Seeded operands of one int8 block (plain layout: HWIO weights)."""
    def act(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def w(*shape):
        return act(*shape) / float(np.prod(shape[:-1])) ** 0.5

    def vec(n, base=0.0):
        return base + 0.1 * act(n)

    cin = sum(parts)
    if kind == "K9":
        hin = h * 2  # a down transition onto h x h
        x = act(batch, hin, hin, cin).bfloat16().float()
    else:
        x = [act(batch, h, h, c).bfloat16().float() for c in parts]
    temb = (act(batch, 16), w(16, cout), vec(cout))
    gn1 = (vec(cin, 1.0), vec(cin))
    conv1 = t_rb.quantize_weight(w(3, 3, cin, cout))
    conv2 = t_rb.quantize_weight(w(3, 3, cout, cout))
    body = (vec(cout), vec(cout, 1.0), vec(cout))
    skip = (w(cin, cout), vec(cout)) if kind != "K2" or cin != cout else (None, None)
    return x, temb, gn1, conv1, conv2, body, skip


# each kind's int8 wrapper and its plain version
OPS = {"K2": (t_rb.fused_resblock_int8, t_rb.resblock_int8_reference),
       "K3": (t_rb.fused_resblock_pair_int8, t_rb.resblock_pair_int8_reference),
       "K4": (t_rb.fused_resblock_tail_int8, t_rb.resblock_tail_int8_reference),
       "K9": (t_rb.fused_resblock_transition_int8, t_rb.resblock_transition_int8_reference)}


def _run_block(kind, args, conv1, conv2, scales, plain=False):
    x, temb, gn1, _, _, (b1, g2s, g2b), skip = args
    op = OPS[kind][plain]
    b2 = b1.flip(0)
    kw = dict(num_groups2=32)
    if kind == "K9":
        return op(x, *temb, *gn1, conv1, b1, g2s, g2b, conv2, b2, *skip, scales, up=False,
                  num_groups1=32, **kw)
    if kind == "K4":
        return op(x[0], x[0].flip(1), *temb, conv1, b1, g2s, g2b, conv2, b2, *skip, scales, **kw)
    if kind == "K3":
        return op(x[0], x[1], *temb, *gn1, conv1, b1, g2s, g2b, conv2, b2, *skip, scales,
                  num_groups1=32, **kw)
    return op(x[0], *temb, *gn1, conv1, b1, g2s, g2b, conv2, b2, *skip, scales, num_groups1=32,
              **kw)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_int8_blocks_take_either_layout_on_cpu(kind, static):
    """The CPU wrappers (the plain versions) give the same output bit for bit
    from HWIO weights and from the same weights packed K-major."""
    h, parts, cout = BLOCKS[kind][0]
    args = _block_args(np.random.default_rng(52), kind, h, parts, cout)
    scales = torch.stack(t_rb.act_scales_from_amax((2.0, 2.5))) if static else None
    conv1, conv2 = args[3], args[4]
    hwio = _run_block(kind, args, conv1, conv2, scales)
    packed = _run_block(kind, args, t_rb.pack_int8_weight(conv1), t_rb.pack_int8_weight(conv2),
                        scales)
    assert torch.equal(hwio, packed)


# --------------------------------------------------------------------------
# (c) the pre-pass's plain version against the JAX package's quantizers
# --------------------------------------------------------------------------

# a value on a half step rounds by the last bit of its SiLU, and jax.nn.sigmoid
# and torch.sigmoid may differ by an ulp: at most this share one step apart
FLIP_SHARE = 1e-3
AMAX_STATIC = 2.0  # under the activations' range: the static scale clips some values


def _jax_quantized(jx, a, mode):
    """The JAX package's int8 of f32 activations a (B, H, W, C): static
    (_quant_2d_static with 1/s, as _qs_row makes it), per sample (_quant_2d),
    or the pair kernel's a * (127 / amax)."""
    jnp = jx.jnp
    if mode == "static":
        (s,) = jx.rb.act_scales_from_amax((AMAX_STATIC,))
        return np.asarray(jx.rb._quant_2d_static(jnp.asarray(a), 1.0 / s))
    out = []
    for ab in a:  # one sample at a time, as the kernels quantize
        ab = jnp.asarray(ab.reshape(-1, ab.shape[-1]))
        if mode == "dynamic":
            q, _ = jx.rb._quant_2d(ab)
        else:
            amax = jnp.maximum(jnp.max(jnp.abs(ab)), 1e-12)
            q = jnp.clip(jnp.round(ab * (127.0 / amax)), -127, 127).astype(jnp.int8)
        out.append(np.asarray(q).reshape(a.shape[1:]))
    return np.stack(out)


def _jax_activation(jx, x, sc, sh, silu):
    """x * scale[b] + shift[b] (+ out * sigmoid(out)) in JAX's f32."""
    jnp = jx.jnp
    if sc is None:
        return np.asarray(x)
    a = jnp.asarray(x) * jnp.asarray(sc)[:, None, None, :] + jnp.asarray(sh)[:, None, None, :]
    if silu:
        a = a * jx.jax.nn.sigmoid(a)
    return np.asarray(a)


# the convs' inputs: conv1 of K2 (bf16 x, GN1 affine + SiLU), of K3 (the
# pair's two bf16 parts), conv2 (f32 h1, GN2 affine + SiLU), and K4/K9's
# conv1 (f32 h, no affine)
PREPASS_INPUTS = {"gn_silu": ((128,), True, True), "pair": ((128, 256), True, True),
                  "h1": ((256,), True, False), "no_affine": ((128,), False, False)}


@pytest.mark.parametrize("mode", ["static", "dynamic", "inv_mul"])
@pytest.mark.parametrize("site", sorted(PREPASS_INPUTS))
def test_prepass_plain_matches_jax_quantization(jx, site, mode):
    parts, affine, bf16_in = PREPASS_INPUTS[site]
    rng = np.random.default_rng(53)
    c = sum(parts)
    xs = [rng.standard_normal((2, 8, 8, p)).astype(np.float32) for p in parts]
    if bf16_in:
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    sc = (1.0 + 0.3 * rng.standard_normal((2, c))).astype(np.float32) if affine else None
    sh = (0.2 * rng.standard_normal((2, c))).astype(np.float32) if affine else None
    t = [torch.from_numpy(x) for x in xs]
    kw = dict(silu=affine, inv_mul=mode == "inv_mul")
    if mode == "static":
        kw["act_scale"] = t_rb.act_scales_from_amax((AMAX_STATIC,))[0]
    got = t_rb.quantize_conv_input(t[0], t[1] if len(t) > 1 else None,
                                   None if sc is None else torch.from_numpy(sc),
                                   None if sh is None else torch.from_numpy(sh), **kw).numpy()
    want = _jax_quantized(jx, _jax_activation(jx, np.concatenate(xs, -1), sc, sh, affine), mode)
    assert got.dtype == np.int8 and got.shape == (2, 8, 8, c)
    step = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert step.max() <= 1 and (step > 0).mean() <= FLIP_SHARE


# --------------------------------------------------------------------------
# (d) the int8 network with K-major weights
# --------------------------------------------------------------------------

# tests/test_torch_int8.py's tolerances. The CPU plain versions' int8 outputs
# hinge on the last bit of f32 sums whose order follows the buffers'
# alignment (two runs of one block on the same values, copied to other
# offsets, flip a rounding: measured 2.9e-3 here), and packed weights move
# the allocations: so each block is held on the HWIO network's block inputs
# (NET_BLOCK_REL), eps with every block's output forced to the HWIO block's
# (EPS_REL), and eps run free (EPS_FREE_REL).
NET_BLOCK_REL = 1e-2
EPS_REL = 1e-4
EPS_FREE_REL = 0.15


def small(cfg, transition):
    """The accr structure at nf=128, ch_mult (1, 2), one block per level,
    16x16, attention at 8x8, f32 activations, int8 blocks."""
    cfg.model.nf = 128
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.model.conv_impl = "fused_int8"
    cfg.model.transition_impl = transition
    return cfg


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("transition", ["tail", "full"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_int8_network_with_kmajor_weights_matches_hwio(monkeypatch, transition, static):
    cfg = small(get_config("cld/accr_dcifar10"), transition)
    sde = CLD.from_config(cfg)
    rng = np.random.default_rng(54)
    u = torch.from_numpy(rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32))
    t = torch.tensor([0.5, 0.02])
    eps_fn = make_cld_eps_fn(sde)
    int8_blocks = (blocks.ResnetBlockBigGANpp, blocks.AttnBlockpp)

    hwio_model = seeded_model(cfg, 0)
    if static:
        u0 = torch.from_numpy(rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32))
        hwio_model.qscales = calibrate_cld_qscales(cfg, hwio_model, sde, batch=2, nfe=3, u0=u0)
    outs = {}
    for name, mod in hwio_model.scopes:
        if isinstance(mod, int8_blocks):
            mod.register_forward_hook(lambda m, a, o, name=name: outs.setdefault(name, o.clone()))
    hwio = eps_fn(hwio_model, u, t)

    monkeypatch.setattr(blocks, "_kmajor", lambda w: True)
    model = seeded_model(cfg, 0)
    model.qscales = hwio_model.qscales
    free = eps_fn(model, u, t)
    weights = [m._kw8._val for _, m in model.scopes if isinstance(m, blocks.ResnetBlockBigGANpp)]
    assert weights and all(w[0][0].dim() == 2 and w[1][0].dim() == 2 for w in weights)
    assert _rel(free, hwio) <= EPS_FREE_REL

    errs = {}
    for name, mod in model.scopes:
        if name in outs:
            def forced(*args, _name=name, _fwd=mod.forward, **kw):
                errs[_name] = _rel(_fwd(*args, **kw), outs[_name])
                return outs[_name]

            monkeypatch.setattr(mod, "forward", forced)
    got = eps_fn(model, u, t)
    assert set(errs) == set(outs) and len(errs) == 13  # 10 residual blocks, 3 attention
    assert max(errs.values()) <= NET_BLOCK_REL, errs
    assert _rel(got, hwio) <= EPS_REL


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

# about 3x the errors chip_smoke.py measures on an H100 (bf16 outputs)
KERNEL_BOUND = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,cin,n", [(4, 32, 128, 128), (4, 4, 256, 256), (4, 8, 512, 256),
                                           (16, 16, 384, 256), (64, 32, 384, 128),
                                           (64, 16, 256, 256)])
def test_int8_gemm_sums_match_exact_conv_bit_for_bit(cuda, batch, h, cin, n):
    """Every tile height and split the main path plans: the GEMM's int32
    sums (unit scales, f32 holding them exactly below 2^24) equal the exact
    float64 conv's."""
    g = torch.Generator(device=cuda).manual_seed(60)
    x8, _ = t_c3.quantize_per_sample(torch.randn((batch, h, h, cin), generator=g, device=cuda))
    wq, _ = t_rb.quantize_weight(torch.randn((3, 3, cin, n), generator=g, device=cuda))
    wk, _ = t_rb.pack_int8_weight((wq, None))
    with torch.no_grad():
        got = t_rb.int8_conv_gemm(x8, wk)
    want = t_rb.conv3x3_int8_exact(x8, wq)
    assert want.abs().max().item() < 2 ** 24
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["static", "dynamic", "inv_mul"])
@pytest.mark.parametrize("site", sorted(PREPASS_INPUTS))
def test_prepass_kernel_matches_plain(cuda, site, mode):
    parts, affine, bf16_in = PREPASS_INPUTS[site]
    g = torch.Generator(device=cuda).manual_seed(61)
    c = sum(parts)
    dt = torch.bfloat16 if bf16_in else torch.float32
    xs = [torch.randn((4, 16, 16, p), generator=g, device=cuda).to(dt) for p in parts]
    sc = 1.0 + 0.3 * torch.randn((4, c), generator=g, device=cuda) if affine else None
    sh = 0.2 * torch.randn((4, c), generator=g, device=cuda) if affine else None
    kw = dict(silu=affine, inv_mul=mode == "inv_mul")
    if mode == "static":
        kw["act_scale"] = t_rb.act_scales_from_amax((AMAX_STATIC,))[0].to(cuda)
    else:
        a = torch.cat(xs, -1).float()
        if affine:
            a = a * sc[:, None, None] + sh[:, None, None]
            a = a * torch.sigmoid(a)
        kw["amax"] = a.abs().amax(dim=(1, 2, 3))
    x1 = xs[1] if len(xs) > 1 else None
    with torch.no_grad():
        got = t_rb.quantize_conv_input(xs[0], x1, sc, sh, **kw)
    want = t_rb.quantize_conv_input_reference(xs[0], x1, sc, sh, **kw)
    step = (got.int() - want.int()).abs()
    assert got.dtype == torch.int8 and step.max().item() <= 1
    assert (step > 0).float().mean().item() <= FLIP_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind,batch,block", [("K2", 4, 4), ("K2", 64, 0), ("K3", 4, 4),
                                              ("K3", 64, 4), ("K4", 16, 0), ("K9", 4, 5)])
def test_int8_block_kernels_match_plain(cuda, kind, batch, block, static):
    """K2/K3/K4/K9 int8 on the new GEMM within the bf16 bound of their plain
    versions: small and large grids, split K, both tile heights."""
    h, parts, cout = BLOCKS[kind][block]
    args = _block_args(np.random.default_rng(62), kind, h, parts, cout, batch)

    def to(a):
        if isinstance(a, (tuple, list)):
            return type(a)(to(v) for v in a)
        return None if a is None else a.to(cuda)

    args = to(args)
    scales = torch.stack(t_rb.act_scales_from_amax((4.0, 4.0))).to(cuda) if static else None
    x = args[0]
    kargs = ((x.bfloat16() if kind == "K9" else [v.bfloat16() for v in x]),) + args[1:]
    packed = [t_rb.pack_int8_weight(c) for c in args[3:5]]
    with torch.no_grad():
        out = _run_block(kind, kargs, *packed, scales)
        ref = _run_block(kind, args, args[3], args[4], scales, plain=True)
    assert out.dtype == torch.bfloat16
    rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= KERNEL_BOUND


@pytest.mark.cuda
def test_int8_block_kernels_refuse_hwio_weights(cuda):
    """On the card the int8 wrappers take K-major weights only: HWIO raises
    (no fallback)."""
    h, parts, cout = BLOCKS["K2"][4]
    args = _block_args(np.random.default_rng(63), "K2", h, parts, cout)
    x, temb, gn1, conv1, conv2, (b1, g2s, g2b), skip = args
    dev = lambda a: None if a is None else a.to(cuda)  # noqa: E731
    with torch.no_grad(), pytest.raises(ValueError, match="K-major"):
        t_rb.fused_resblock_int8(dev(x[0]).bfloat16(), *map(dev, temb), *map(dev, gn1),
                                 tuple(map(dev, conv1)), dev(b1), dev(g2s), dev(g2b),
                                 tuple(map(dev, conv2)), dev(b1), *map(dev, skip), None,
                                 num_groups1=32, num_groups2=32)
    with torch.no_grad(), pytest.raises(ValueError, match="K-major"):
        t_rb.int8_conv_gemm(torch.zeros((1, 4, 4, 256), dtype=torch.int8, device=cuda),
                            dev(conv2[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_s8_launch_counts_count_each_launch(cuda, kind):
    """The GEMM and the pre-pass are counted in C where they launch: once a
    bare wrapper call, twice (conv1, conv2) and twice or once (K2 and K3's
    conv1 operand comes from GN1's one launch) an int8 block call with
    per-sample scales, and nothing for a call on the CPU."""
    gemm, prepass = t_rb.S8_COUNTED
    s8_launches = functools.partial(t_rb.block_launches, kernels=t_rb.S8_COUNTED)
    h, parts, cout = BLOCKS[kind][0]
    args = _block_args(np.random.default_rng(64), kind, h, parts, cout)
    s8_launches(reset=True)
    with torch.no_grad():
        _run_block(kind, args, args[3], args[4], None)  # the CPU: the plain version
        assert s8_launches() == {gemm: 0, prepass: 0}
        x8 = torch.ones((1, 4, 4, 128), dtype=torch.int8, device=cuda)
        t_rb.int8_conv_gemm(x8, t_rb.pack_int8_weight(t_rb.quantize_weight(
            torch.ones((3, 3, 128, 128), device=cuda)))[0])
        assert s8_launches() == {gemm: 1, prepass: 0}
        t_rb.quantize_conv_input(x8.bfloat16(), act_scale=torch.ones((), device=cuda))
        assert s8_launches() == {gemm: 1, prepass: 1}
        x = args[0].to(cuda).bfloat16() if kind == "K9" else [v.to(cuda).bfloat16()
                                                              for v in args[0]]
        dev = [tuple(v.to(cuda) if v is not None else None for v in a) for a in args[1:]]
        _run_block(kind, (x, *dev), *(t_rb.pack_int8_weight(c) for c in dev[2:4]), None)
        torch.cuda.synchronize()
    assert s8_launches(reset=True) == {gemm: 3, prepass: 2 if kind in ("K2", "K3") else 3}
    assert s8_launches() == {gemm: 0, prepass: 0}
