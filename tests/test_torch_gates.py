"""The whole-block kernels' gates (``ops/resblock.py:stride1_supported``,
``pair_supported``, ``tail_supported``, ``transition_supported``,
``train_supported``; ``ops/attnblock.py:supported``) and the model's routing
by them, on the CPU:

(a) every gate against the tile plans it stands for, at every block of the
    configs in ``gddim_torch/configs.py`` and of the JAX package's
    cld/simple_cifar10, blur/simple_cifar10 and blur/debug_cifar10 widths
    (nf 32, 64, 128), the blocks' shapes traced from the port's own network
    on the meta device;
(b) small networks at nf=32 and 64 with conv_impl 'fused' against the JAX
    package's NCSN++ on the same weights (converted), the gates consulted:
    the kernel wrappers take the blocks the card's kernels take, the plain
    composition the rest;
(c) the per-eval temb product against each block's own projection, its
    module order, and its cache.

Cases marked ``cuda`` run the nf=32 network's 'fused' and 'fused_int8'
paths on the card against its plain path, and skip without one.
"""

import collections

import numpy as np
import pytest
import torch

from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models import blocks as t_blocks
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.unet import NCSNpp
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import resblock as t_rb

MODEL_REL = 1e-4  # tests/test_torch_model.py's bound on the whole network's eps
TEMB_REL = 1e-6

# the JAX package's configs at other widths, as (structure, nf, ch_mult, blocks per level)
WIDTHS = [("cld/accr_dcifar10", nf, (1, 2, 2, 2), 8) for nf in (32, 64, 128)]
WIDTHS += [("blur/ddpm_deep_cifar10", nf, (1, 2, 2, 2), 8) for nf in (32, 64, 128)]
WIDTHS += [("cld/accr_dcifar10", 32, (1, 2), 1),  # cld/simple_cifar10
           ("blur/ddpm_deep_cifar10", 32, (1, 2), 1),  # blur/simple_cifar10
           ("blur/ddpm_deep_cifar10", 64, (1, 2, 2, 2), 4)]  # blur/debug_cifar10's widths


def trace_blocks(name, nf, ch_mult, blocks):
    """[(kind, input shapes, cout, up)] of every residual block ('stride1',
    'pair', 'down', 'up') and attention block ('attn') of the network, in the
    order the forward runs them, at B=4: the forward on the meta device with
    each block replaced by its output's shape."""
    cfg = get_config(name)
    cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = nf, ch_mult, blocks
    with torch.device("meta"):
        model = NCSNpp(cfg)
    seen = []

    def res(self, x, temb, *args, **kw):
        pair = isinstance(x, (tuple, list))
        shapes = tuple(tuple(t.shape) for t in (x if pair else (x,)))
        cout = self.conv1.weight.shape[-1]
        kind = "pair" if pair else "up" if self.up else "down" if self.down else "stride1"
        seen.append((kind, shapes, cout))
        b, h, w, _ = shapes[0]
        h, w = (2 * h, 2 * w) if self.up else (h // 2, w // 2) if self.down else (h, w)
        return torch.empty((b, h, w, cout), device="meta")

    def attn(self, x, *args, **kw):
        seen.append(("attn", (tuple(x.shape),), x.shape[-1]))
        return x

    model.fused = False  # no kernel wrapper on the meta device
    with pytest.MonkeyPatch.context() as mp, torch.device("meta"):
        mp.setattr(t_blocks.ResnetBlockBigGANpp, "forward", res)
        mp.setattr(t_blocks.AttnBlockpp, "forward", attn)
        size = cfg.data.image_size
        channels = cfg.data.num_channels * (2 if cfg.sde == "cld" else 1)
        model(torch.empty((4, size, size, channels), device="meta"),
              torch.empty((4,), device="meta"))
    return seen


def planned(plan, *args) -> bool:
    try:
        plan(*args)
        return True
    except ValueError:
        return False


def conv_plans(h, w, cin, cskip, cout, int8) -> bool:
    """Both convs of a block have a tile plan (conv2 with the skip in its K)."""
    plan = t_rb.s8_tile_plan if int8 else t_rb.bf16_tile_plan
    return planned(plan, 4, h, w, cin, 0, cout) and planned(plan, 4, h, w, cout, cskip, cout)


@pytest.fixture(scope="module")
def traced():
    return {w: trace_blocks(*w) for w in WIDTHS}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("width", WIDTHS,
                         ids=[f"{n}-nf{nf}-{len(m)}x{b}" for n, nf, m, b in WIDTHS])
def test_gates_say_true_exactly_where_the_tile_plans_return(traced, width, int8):
    blocks = traced[width]
    counts = collections.Counter(kind for kind, *_ in blocks)
    levels = len(width[2])
    assert counts["down"] == counts["up"] == levels - 1
    assert counts["stride1"] == levels * width[3] + 2 and counts["pair"] == levels * (width[3] + 1)
    slice_ = t_rb.GEMM_SKIP_SLICE
    for kind, shapes, cout in blocks:
        b, h, w, c = shapes[0]
        what = (kind, shapes, cout, int8)
        if kind == "stride1":
            want = conv_plans(h, w, c, 0 if c == cout else c, cout, int8)
            assert t_rb.stride1_supported(shapes[0], cout, int8) is want, what
        elif kind == "pair":
            ca, cb = shapes[0][-1], shapes[1][-1]
            want = ca % slice_ == 0 and cb % slice_ == 0 and conv_plans(h, w, ca + cb, ca + cb,
                                                                        cout, int8)
            assert t_rb.pair_supported(shapes[0], cb, cout, int8) is want, what
        elif kind == "attn":
            assert t_attn.supported(shapes[0], int8) is planned(t_attn.block_plan, b, h, w, c,
                                                                 int8), what
        else:  # a transition: its tail (K4) at the output resolution, or K9 around it
            up = kind == "up"
            ho, wo = (2 * h, 2 * w) if up else (h // 2, w // 2)
            want = conv_plans(ho, wo, c, c, cout, int8)
            assert t_rb.tail_supported((b, ho, wo, c), cout, int8) is want, what
            assert t_rb.transition_supported(shapes[0], cout, up, True, (1, 3, 3, 1),
                                             int8) is want, what


def test_gates_at_the_main_path_and_the_small_widths(traced):
    """The main path (nf=128) runs every block on the kernels; the card's
    block GEMM needs Cout a multiple of 128 (and Cin of 64 in bf16, 128 in
    int8), so at nf=64 it takes some stride-1 blocks and at nf=32 none, and
    K5 no attention block at C=64, on f32 activations too (one gate)."""
    for width, blocks in traced.items():
        nf = width[1]
        for int8 in (False, True):
            takes = [t_rb.stride1_supported(s[0], cout, int8) for kind, s, cout in blocks
                     if kind == "stride1"]
            assert all(takes) if nf == 128 else (any(takes) and not all(takes)) if nf == 64 \
                else not any(takes), (width, int8)
    assert not t_attn.supported((4, 16, 16, 64)) and t_attn.supported((4, 16, 16, 128))


@pytest.mark.parametrize("shape,cout,ok", [
    ((4, 32, 32, 32), 32, False), ((4, 32, 32, 32), 64, False), ((4, 16, 16, 64), 64, False),
    ((4, 8, 8, 48), 64, False), ((4, 8, 8, 128), 96, False), ((4, 32, 32, 128), 128, True),
    ((4, 16, 16, 384), 256, True), ((4, 4, 4, 512), 256, True)])
def test_train_gate_follows_the_k6_tiles(shape, cout, ok):
    """K6/K7 take a block where every GEMM has a block-GEMM plan and both
    3x3 wgrads a wgrad plan: Cin and Cout in 128-channel tiles (the dgrads
    write Cin), so nf=32 and 64 run the plain composition."""
    assert t_rb.train_supported(shape, cout) is ok


def test_tile_plan_refuses_several_samples_off_16_rows():
    """A tile that holds several samples keeps a warp's 16 rows in one
    sample (GN2's epilogue sums): 2x2 and 6x6 images have no plan, 12x12
    (one sample a tile) and 4x4 do."""
    for h in (2, 6):
        assert not planned(t_rb.bf16_tile_plan, 4, h, h, 128, 0, 128)
        assert not t_rb.stride1_supported((4, h, h, 128), 128, False)
    for h in (4, 12):
        assert planned(t_rb.bf16_tile_plan, 4, h, h, 128, 0, 128)
        assert t_rb.stride1_supported((4, h, h, 128), 128, False)


# --------------------------------------------------------------------------
# (b) small networks through the gates against the JAX package
# --------------------------------------------------------------------------


def small(cfg, nf):
    cfg.model.nf = nf
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.model.conv_impl = "fused"
    return cfg


def _routes(monkeypatch):
    """Counts of the routes the residual blocks take: 'kernel' (a kernel
    wrapper: K2-K4 or K9) or 'plain' (the plain composition)."""
    counts = collections.Counter()

    def spy(route, fn):
        def call(*a, **k):
            counts[route] += 1
            return fn(*a, **k)
        return call

    ops = {kind: tuple(spy("plain" if i == 2 else "kernel", fn) for i, fn in enumerate(fns))
           for kind, fns in t_blocks._RES_OPS.items()}
    monkeypatch.setattr(t_blocks, "_RES_OPS", ops)
    for name in ("fused_resblock_transition", "fused_resblock_transition_int8"):
        monkeypatch.setattr(t_rb, name, spy("kernel", getattr(t_rb, name)))
    return counts


@pytest.mark.parametrize("nf", [32, 64])
def test_small_network_through_the_gates_matches_jax(nf, monkeypatch):
    import jax
    import jax.numpy as jnp

    from gddim_tpu.configs import get_config as jax_get_config
    from gddim_tpu.math.cld import CLD as JaxCLD
    from gddim_tpu.models import get_model
    from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn

    jcfg = small(jax_get_config("cld/accr_dcifar10"), nf)
    jmodel = get_model("ncsnpp")(config=jcfg)
    cfg = small(get_config("cld/accr_dcifar10"), nf)
    tree = seeded_params(cfg, 0)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    t = np.array([0.5, 0.02], np.float32)
    want = jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), jmodel)(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(u), jnp.asarray(t))
    counts = _routes(monkeypatch)
    model = seeded_model(cfg, 0)
    got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u), torch.from_numpy(t))
    want = np.asarray(want, np.float64)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= MODEL_REL
    # f32 activations: the block GEMM's plans (Cout a multiple of 128), so the
    # kernels take some blocks at nf=64 and none at nf=32
    assert counts["kernel"] + counts["plain"] == len(model.res_blocks)
    assert counts["plain"] > 0 and (counts["kernel"] > 0) is (nf == 64), dict(counts)


@pytest.mark.parametrize("nf", [32, 64, 128])
@pytest.mark.parametrize("name", ["cld/accr_dcifar10", "blur/ddpm_deep_cifar10"])
def test_f32_model_takes_the_kernels_where_the_plans_do(monkeypatch, name, nf):
    """model.dtype float32 with conv_impl 'fused': every residual block and
    attention block consults the gates of the bf16 mode (the block GEMM's
    plans), so it takes the kernels exactly where the bf16 model does: all
    of them at nf=128, some at nf=64 (Cout 128 levels), none at nf=32."""
    routes = []

    def spy(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            routes.append((fn.__name__, tuple(a[0]), out))
            return out
        return call

    for fn in ("stride1_supported", "pair_supported", "tail_supported", "transition_supported"):
        monkeypatch.setattr(t_rb, fn, spy(getattr(t_rb, fn)))
    monkeypatch.setattr(t_attn, "supported", spy(t_attn.supported))
    cfg = small(get_config(name), nf)
    cfg.model.transition_impl = "full"
    seen = {}
    for dtype in ("float32", "bfloat16"):
        cfg.model.dtype = dtype
        model = seeded_model(cfg, 0)
        size, channels = cfg.data.image_size, cfg.data.num_channels
        x = torch.randn((2, size, size, channels * (2 if cfg.sde == "cld" else 1)),
                        generator=torch.Generator().manual_seed(8))
        routes.clear()
        with torch.inference_mode():
            model(x, torch.full((2,), 0.5))
        seen[dtype] = list(routes)
    f32 = seen["float32"]
    assert f32 == seen["bfloat16"] and len(f32) > 0
    took = [ok for fn, _, ok in f32 if fn != "supported"]
    assert all(took) if nf == 128 else (any(took) and not all(took)) if nf == 64 \
        else not any(took), f32


# --------------------------------------------------------------------------
# (c) the per-eval temb rows
# --------------------------------------------------------------------------


def test_temb_rows_are_each_blocks_projection_in_module_order():
    cfg = small(get_config("cld/accr_dcifar10"), 32)
    model = seeded_model(cfg, 0)
    g = torch.Generator().manual_seed(3)
    for blk in model.res_blocks:  # distinct biases, so a slice off by a block shows
        torch.nn.init.normal_(blk.temb_dense.bias, generator=g)
    temb = torch.randn((3, 4 * 32), generator=g)
    rows = model.temb_rows(temb)
    assert rows.dtype == torch.float32
    assert rows.shape == (3, sum(b.temb_dense.weight.shape[1] for b in model.res_blocks))
    order = [mod for _, mod in model.scopes if isinstance(mod, t_blocks.ResnetBlockBigGANpp)]
    assert model.res_blocks == order and order[0].temb_cols.start == 0
    for a, b in zip(order, order[1:]):
        assert a.temb_cols.stop == b.temb_cols.start
    for blk in model.res_blocks:
        want = t_rb.temb_projection(temb, blk.temb_dense.weight, blk.temb_dense.bias)
        got = rows[:, blk.temb_cols]
        assert ((got - want).abs().max() / want.abs().max()).item() <= TEMB_REL


def test_temb_rows_are_remade_when_a_dense_parameter_changes():
    model = seeded_model(small(get_config("cld/accr_dcifar10"), 32), 0)
    temb = torch.randn((2, 128), generator=torch.Generator().manual_seed(4))
    before = model.temb_rows(temb)
    blk = model.res_blocks[3]
    with torch.no_grad():
        blk.temb_dense.bias.add_(1.0)
    after = model.temb_rows(temb)
    cols = blk.temb_cols
    assert torch.allclose(after[:, cols], before[:, cols] + 1.0, atol=1e-5)
    others = torch.ones(after.shape[1], dtype=torch.bool)
    others[cols] = False
    assert torch.equal(after[:, others], before[:, others])
    with torch.no_grad():
        blk.temb_dense.weight.mul_(2.0)
    want = t_rb.temb_projection(temb, blk.temb_dense.weight, blk.temb_dense.bias)
    assert torch.allclose(model.temb_rows(temb)[:, cols], want, rtol=1e-5, atol=1e-5)


def test_block_takes_the_row_in_place_of_its_dense():
    """A block handed its row computes what it computes from temb itself."""
    blk = t_blocks.ResnetBlockBigGANpp(32, 64, 128)
    g = torch.Generator().manual_seed(5)
    x, temb = torch.randn((2, 8, 8, 32), generator=g), torch.randn((2, 128), generator=g)
    row = t_rb.temb_projection(temb, blk.temb_dense.weight, blk.temb_dense.bias)
    with torch.no_grad():
        for fused in (True, False):
            want = blk(x, temb, fused=fused)
            assert torch.equal(blk(x, temb, fused=fused, temb_row=row), want)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl,bound", [("fused", 2e-2), ("fused_int8", 0.15)])
def test_nf32_network_runs_on_the_card(cuda, impl, bound):
    """At nf=32 the card's kernels take some blocks and the plain
    composition the rest; the eps agrees with the f32 plain path within the
    full-width bounds (bf16 2e-2, int8 per sample 0.15)."""
    cfg = get_config("cld/accr_dcifar10")
    cfg.model.nf, cfg.model.conv_impl = 32, impl
    model = seeded_model(cfg, 0, device=cuda)
    eps = make_cld_eps_fn(CLD.from_config(cfg))
    g = torch.Generator(device=cuda).manual_seed(1)
    u = torch.randn((4, 32, 32, 3, 2), generator=g, device=cuda)
    t = torch.full((4,), 0.5, device=cuda)
    assert not torch.backends.cuda.matmul.allow_tf32
    with torch.no_grad():
        got = eps(model, u, t)
        model.fused, model.int8, model.dtype = False, False, torch.float32
        ref = eps(model, u, t)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= bound
