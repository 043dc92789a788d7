"""The port's NCSN++ option space against the JAX package, in f32 on the CPU:
the whole network's eps for each option set (positional embedding, naive
resampling, each progressive_input and progressive mode, DDPM blocks,
skip_rescale off, unconditional, each activation, scale_by_sigma) on the
plain path and through the whole-block kernels' routes (their plain
versions on the CPU, at nf=128 where the gates take the blocks); the
layers the options add (the stride-2 SAME conv, the naive resamplers, the
FIR up-conv, the positional embedding, the activations, Combine, the DDPM
block with its NIN or conv shortcut, Upsample and Downsample); the int8
calibration's sites on DDPM and unconditional blocks; the U-Net's scopes
and refusals."""

import functools

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import convert
from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models import blocks as t_blocks
from gddim_torch.models import layers as t_layers
from gddim_torch.models import resample as t_res
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.unet import NCSNpp
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.ops import resblock as rb
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.models import blocks as j_blocks
from gddim_tpu.models import get_model
from gddim_tpu.models import layers as j_layers
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.models import resample as j_res

# the whole network in f32 (as tests/test_torch_model.py:MODEL_REL):
# measured 1.1e-6 to 2.2e-6 here for every option set and both paths, and
# up to 1.9e-6 for the calibration's amaxes
MODEL_REL = 1e-4
# one layer or block in f32: measured up to 4.8e-7 here
LAYER_REL = 1e-5
FIR = (1, 3, 3, 1)

# (option set, model overrides) on the small accr structure
OPTIONS = {
    "positional": dict(embedding_type="positional"),
    "fir_false": dict(fir=False),
    "input_none": dict(progressive_input="none"),
    "input_skip": dict(progressive_input="input_skip"),
    "input_skip_cat": dict(progressive_input="input_skip", progressive_combine="cat"),
    "input_residual": dict(progressive_input="residual"),
    "output_skip": dict(progressive="output_skip"),
    "output_residual": dict(progressive="residual"),
    "ddpm": dict(resblock_type="ddpm"),
    "ddpm_naive": dict(resblock_type="ddpm", fir=False),
    "ddpm_pyramids": dict(resblock_type="ddpm", progressive="output_skip",
                          progressive_input="input_skip"),
    "naive_pyramids": dict(fir=False, progressive="residual", progressive_input="residual",
                           skip_rescale=False),
    "no_skip_rescale": dict(skip_rescale=False),
    "unconditional": dict(conditional=False),
    "elu": dict(nonlinearity="elu"),
    "relu": dict(nonlinearity="relu"),
    "lrelu": dict(nonlinearity="lrelu"),
    "scale_by_sigma": dict(scale_by_sigma=True),
    "scale_by_sigma_positional": dict(scale_by_sigma=True, embedding_type="positional"),
    "ddpmpp_celeba": dict(embedding_type="positional", fir=False, progressive_input="none"),
}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def small(cfg, options):
    """Two levels of one block at 8x8, attention at 4x4, nf=128 (so that
    the kernels' gates take the blocks), f32."""
    cfg.model.nf = 128
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (4,)
    cfg.data.image_size = 8
    cfg.model.dtype = "float32"
    for key, value in options.items():
        setattr(cfg.model, key, value)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 8, 8, 3, 2)).astype(np.float32)
    return u, np.array([0.5, 0.02], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_eps(option: str):
    """The JAX package's eps of the option set on the seeded weights."""
    jcfg = small(jax_get_config("cld/accr_dcifar10"), OPTIONS[option])
    tree = seeded_params(small(get_config("cld/accr_dcifar10"), OPTIONS[option]), 0)
    u, t = _inputs()
    eps = jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), get_model("ncsnpp")(config=jcfg))
    return np.asarray(eps({"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(u),
                          jnp.asarray(t)))


@pytest.mark.parametrize("conv_impl", ["plain", "fused"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_eps_matches_jax(option, conv_impl):
    cfg = small(get_config("cld/accr_dcifar10"), OPTIONS[option])
    cfg.model.conv_impl = conv_impl
    u, t = _inputs()
    model = seeded_model(cfg, 0)
    got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u), torch.from_numpy(t))
    want = _jax_eps(option)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= MODEL_REL


@pytest.mark.parametrize("n", [7, 8])
def test_strided_conv_pads_as_xla_same(n):
    """conv3x3(stride=2) under XLA's SAME: (0, 1) on an even axis, (1, 1)
    on an odd one; F.conv2d(padding=1) would be a pixel off on an even one."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, n, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    conv = t_layers.Conv(5, 6, 3, stride=2)
    conv.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    got = conv(torch.from_numpy(x)).detach()
    assert got.shape == want.shape == (2, 4, 4, 6)
    assert rel_err(got, want) <= LAYER_REL
    assert t_layers.same_pads(n, 3, 2) == ((0, 1) if n % 2 == 0 else (1, 1))


@pytest.mark.parametrize("n", [7, 8])
def test_naive_resamplers_match_jax(n):
    x = np.random.default_rng(10 + n).standard_normal((2, n, n, 5)).astype(np.float32)
    up = t_res.naive_upsample_2d(torch.from_numpy(x))
    np.testing.assert_array_equal(up.numpy(), np.asarray(j_res.naive_upsample_2d(jnp.asarray(x))))
    nearest = jax.image.resize(jnp.asarray(x), (2, 2 * n, 2 * n, 5), "nearest")
    np.testing.assert_array_equal(up.numpy(), np.asarray(nearest))  # the Upsample's form
    pool = t_res.avg_pool_same(torch.from_numpy(x))
    want = nn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2), padding="SAME")
    assert pool.shape == want.shape and rel_err(pool, want) <= LAYER_REL
    if n % 2 == 0:  # the JAX package's reshape-mean takes even sizes only
        down = t_res.naive_downsample_2d(torch.from_numpy(x))
        assert rel_err(down, j_res.naive_downsample_2d(jnp.asarray(x))) <= LAYER_REL
        assert rel_err(down, pool) <= LAYER_REL


def test_upsample_conv_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 6, 16)) / 7).astype(np.float32)
    got = t_res.upsample_conv_2d(torch.from_numpy(x), torch.from_numpy(w), FIR)
    want = j_res.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w), FIR)
    assert got.shape == want.shape == (2, 16, 16, 16)
    assert rel_err(got, want) <= LAYER_REL


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 3.5, 499.5, 998.99], np.float32)
    got = t_layers.get_timestep_embedding(torch.from_numpy(t), dim)
    want = j_layers.get_timestep_embedding(jnp.asarray(t), dim)
    assert got.shape == want.shape == (4, dim)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


@pytest.mark.parametrize("name", ["elu", "relu", "lrelu", "swish"])
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    cfg = jax_get_config("cld/accr_dcifar10")
    cfg.model.nonlinearity = name
    got = t_layers.get_act(name)(torch.from_numpy(x))
    assert rel_err(got, j_layers.get_act(cfg)(jnp.asarray(x))) <= 1e-6
    assert (t_layers.get_act(name) is torch.nn.functional.silu) == (name == "swish")


def test_unknown_activation_is_refused():
    with pytest.raises(NotImplementedError):
        t_layers.get_act("gelu")


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(max(np.prod(a.shape[:-1]), 1))
                   ).astype(np.float32), tree)


def _jax_module(module, seed, *args, **kw):
    """(output, params) of a JAX module on random params."""
    params = flax.core.unfreeze(module.init(jax.random.PRNGKey(0), *args, **kw)["params"])
    params = _random_like(params, seed)
    return module.apply({"params": params}, *args, **kw), params


def _load(module, tree):
    module.load_state_dict(convert.flax_to_state_dict(module, tree))
    return module


@pytest.mark.parametrize("method", ["cat", "sum"])
def test_combine_matches_jax(method):
    rng = np.random.default_rng(13)
    x, y = (rng.standard_normal((2, 8, 8, c)).astype(np.float32) for c in (6, 32))
    want, params = _jax_module(j_layers.Combine(method=method), 14, jnp.asarray(x), jnp.asarray(y))
    got = _load(t_layers.Combine(6, 32, method), params)(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == want.shape == (2, 8, 8, 64 if method == "cat" else 32)
    assert rel_err(got.detach(), want) <= LAYER_REL


# (kind, input channels, Cout, conv_shortcut)
DDPM_BLOCKS = [("stride1", 32, 32, False), ("nin", 32, 64, False), ("shortcut", 32, 64, True),
               ("pair", (64, 32), 64, False)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind,cin,cout,shortcut", DDPM_BLOCKS)
def test_ddpm_block_matches_jax(kind, cin, cout, shortcut, fused):
    rng = np.random.default_rng(15)
    parts = cin if isinstance(cin, tuple) else (cin,)
    xs = [rng.standard_normal((2, 8, 8, p)).astype(np.float32) for p in parts]
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    jblk = j_blocks.ResnetBlockDDPMpp(act=nn.swish, out_ch=cout, conv_shortcut=shortcut,
                                      skip_rescale=True, init_scale=0.0)
    jx = tuple(map(jnp.asarray, xs)) if kind == "pair" else jnp.asarray(xs[0])
    want, params = _jax_module(jblk, 16, jx, jnp.asarray(temb), False)
    tblk = _load(t_blocks.ResnetBlockDDPMpp(sum(parts), cout, 16, conv_shortcut=shortcut,
                                            skip_rescale=True), params)
    # NIN_0 or Conv_2 as the skip, none at the same width
    assert set(params) == {k for k, a in tblk.subscopes.items() if getattr(tblk, a) is not None}
    tx = tuple(map(torch.from_numpy, xs)) if kind == "pair" else torch.from_numpy(xs[0])
    got = tblk(tx, torch.from_numpy(temb), fused=fused)
    assert got.shape == want.shape
    assert rel_err(got.detach(), want) <= LAYER_REL


@pytest.mark.parametrize("fir", [True, False])
@pytest.mark.parametrize("with_conv", [True, False])
@pytest.mark.parametrize("up", [True, False])
def test_up_down_modules_match_jax(up, with_conv, fir):
    x = np.random.default_rng(17).standard_normal((2, 8, 8, 16)).astype(np.float32)
    cls = (j_blocks.Upsample, t_blocks.Upsample) if up else (j_blocks.Downsample,
                                                               t_blocks.Downsample)
    jmod = cls[0](out_ch=32 if with_conv else None, with_conv=with_conv, fir=fir, fir_kernel=FIR)
    if with_conv:
        want, params = _jax_module(jmod, 18, jnp.asarray(x))
    else:
        want, params = jmod.apply({}, jnp.asarray(x)), {}
    kw = dict(with_conv=with_conv, fir=fir, fir_kernel=FIR)
    tmod = cls[1](16, 32 if with_conv else None, **kw)
    assert set(params) == set(tmod.subscopes)  # Conv_0 (nearest / stride 2) or Conv2d_0 (FIR)
    if with_conv:
        _load(tmod, params)
    got = tmod(torch.from_numpy(x))
    assert got.shape == want.shape
    assert rel_err(got.detach(), want) <= LAYER_REL


class _FixedPrior:
    """The JAX CLD with prior_sampling returning a given u0."""

    def __init__(self, sde, u0):
        self._sde, self._u0 = sde, u0

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def prior_sampling(self, rng, shape):
        return self._u0


@pytest.mark.parametrize("option", ["ddpm_naive", "unconditional"])
def test_calibration_sites_match_jax(option, monkeypatch):
    """The int8 calibration's sites and amaxes on DDPM blocks and on
    unconditional blocks (the unfused layers' sow) against the JAX
    package's, along the same order-0 trajectory (f32, plain)."""
    from gddim_torch.models.calibrate import calibrate_cld_qscales
    from gddim_tpu.models.calibrate import calibrate_cld_qscales as jax_calibrate

    monkeypatch.setattr(j_layers, "CONV3X3_IMPL", j_layers.CONV3X3_IMPL)
    cfg = small(get_config("cld/accr_dcifar10"), OPTIONS[option])
    jcfg = small(jax_get_config("cld/accr_dcifar10"), OPTIONS[option])
    tree = seeded_params(cfg, 0)
    u0 = _inputs()[0]
    want = jax_calibrate(jcfg, get_model("ncsnpp")(config=jcfg),
                         {"params": jax.tree.map(jnp.asarray, tree)},
                         _FixedPrior(JaxCLD.from_config(jcfg), jnp.asarray(u0)), batch=2, nfe=2)
    want = jax.tree.map(np.asarray, flax.core.unfreeze(want))
    got = calibrate_cld_qscales(cfg, seeded_model(cfg, 0), CLD.from_config(cfg), batch=2, nfe=2,
                                u0=torch.from_numpy(u0))
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in want.items()}
    for scope, sites in want.items():
        for site, amax in sites.items():
            assert rel_err(got[scope][site], amax) <= MODEL_REL, (scope, site)


def test_naive_transition_coefficients():
    """K9's naive coefficients resample as the naive resamplers do, and its
    gate takes the naive transitions of the CelebA trunk."""
    x = torch.from_numpy(np.random.default_rng(19).standard_normal((2, 8, 8, 4)).astype(np.float32))
    for up, ref in ((True, t_res.naive_upsample_2d), (False, t_res.naive_downsample_2d)):
        got = rb.resample_transition(x, rb.transition_kerns(up, False), up)
        assert torch.allclose(got, ref(x), rtol=0, atol=1e-6)
    assert rb.transition_supported((4, 64, 64, 128), 128, False, False)
    assert rb.transition_supported((4, 32, 32, 256), 256, True, False)


def test_celeba_scopes_follow_jax_order():
    """cld/ddpmpp_celeba: no Fourier projection, no input pyramid; 44 BigGAN
    blocks (18 stride-1, 20 pairs, 6 transitions), 6 attention blocks."""
    with torch.device("meta"):
        model = NCSNpp(get_config("cld/ddpmpp_celeba"))
    names = [n for n, _ in model.scopes]
    assert names[:3] == ["Dense_0", "Dense_1", "Conv_0"]
    assert not [n for n in names if n.startswith(("GaussianFourier", "Downsample", "Combine"))]
    assert [n for n in names if n.startswith("ResnetBlock")] == [
        f"ResnetBlockBigGANpp_{i}" for i in range(44)]
    assert sum(n.startswith("AttnBlockpp") for n in names) == 6
    assert names[-2:] == ["GroupNorm_0", "Conv_1"]
    assert model.temb0.weight.shape == (128, 512)  # the positional embedding's nf inputs
    assert sum(p.numel() for p in model.parameters()) == 61_811_334


def test_temb_rows_cover_the_blocks_with_a_dense():
    cfg = small(get_config("cld/accr_dcifar10"), OPTIONS["ddpm"])
    model = seeded_model(cfg, 0)
    temb = torch.randn(2, 512, generator=torch.Generator().manual_seed(1))
    rows = model.temb_rows(temb)
    assert rows.shape == (2, sum(b.temb_dense.weight.shape[1] for b in model.res_blocks))
    for blk in model.res_blocks:
        own = torch.nn.functional.silu(temb) @ blk.temb_dense.weight + blk.temb_dense.bias
        assert torch.allclose(rows[:, blk.temb_cols], own, rtol=1e-5, atol=1e-5)
    unconditional = seeded_model(small(get_config("cld/accr_dcifar10"),
                                       OPTIONS["unconditional"]), 0)
    assert unconditional.res_blocks == [] and not hasattr(unconditional, "temb0")


@pytest.mark.parametrize("field,value,error", [
    ("resblock_type", "resnet", ValueError), ("progressive", "skip", AssertionError),
    ("progressive_input", "skip", AssertionError), ("embedding_type", "learned", AssertionError),
    ("nonlinearity", "gelu", NotImplementedError), ("progressive_combine", "mean", ValueError)])
def test_unet_refuses_what_jax_refuses(field, value, error):
    cfg = small(get_config("cld/accr_dcifar10"), {field: value})
    if field == "progressive_combine":
        cfg.model.progressive_input = "input_skip"
    with torch.device("meta"), pytest.raises(error):
        NCSNpp(cfg)
