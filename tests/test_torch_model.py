"""The port's NCSN++ against the JAX package, in f32 on the CPU: the weight
converter, the FIR resampling, one BigGAN block of each kind, the attention
block and the whole network's eps, all on the same numpy weights."""

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
from gddim_torch.models import resample as t_res
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.unet import NCSNpp
from gddim_torch.models.wrappers import (
    make_cld_eps_fn,
    stack_uv_to_channels,
    unstack_channels_to_uv,
)
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.models import blocks as j_blocks
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.models import resample as j_res

BLOCK_REL = 1e-5
MODEL_REL = 1e-4
FIR = (1, 3, 3, 1)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def small(cfg):
    """The accr structure (BigGAN, FIR, progressive_input=residual, Fourier
    embedding) at nf=32, ch_mult=(1, 2), one block per level, 16x16, f32."""
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def jax_model():
    cfg = small(jax_get_config("cld/accr_dcifar10"))
    cfg.model.conv_impl = "fused"  # off the TPU this is the unfused composition
    model = get_model("ncsnpp")(config=cfg)
    x, t = jnp.zeros((2, 16, 16, 6)), jnp.ones((2,))
    # abstract init: the parameter tree's structure and shapes, without compiling
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t)["params"]
    return cfg, model, flax.core.unfreeze(params)


def _shapes(tree):
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(max(np.prod(a.shape[:-1]), 1))
                   ).astype(np.float32), tree)


def test_converter_maps_every_parameter_once(jax_model):
    _, _, params = jax_model
    cfg = small(get_config("cld/accr_dcifar10"))
    tree = seeded_params(cfg, 0)
    assert _shapes(tree) == _shapes(params)  # the port builds the same flax tree
    model = seeded_model(cfg, 0)
    sd = convert.flax_to_state_dict(model, tree)
    assert set(sd) == set(model.state_dict())
    pairs = convert.param_pairs(model)
    assert len({k for _, k in pairs}) == len(pairs) == len(sd)
    back = convert.state_dict_to_flax(model)
    for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, arr)
    bad = dict(tree)
    bad.pop("AttnBlockpp_1")
    with pytest.raises(ValueError):
        convert.flax_to_state_dict(model, bad)


def test_scope_order_is_numeric():
    names = ["ResnetBlockBigGANpp_70", "ResnetBlockBigGANpp_8", "ResnetBlockBigGANpp_9"]
    assert sorted(names, key=convert.scope_key)[0] == "ResnetBlockBigGANpp_8"
    tree = {f"Dense_{i}": {} for i in (0, 2)}
    with pytest.raises(ValueError):
        convert.check_scope_numbering(tree)
    with torch.device("meta"):
        full = NCSNpp(get_config("cld/accr_dcifar10"))
    scopes = [n for n, _ in full.scopes]
    res = [n for n in scopes if n.startswith("ResnetBlockBigGANpp")]
    assert res == [f"ResnetBlockBigGANpp_{i}" for i in range(76)]
    assert [n for n in scopes if n.startswith("AttnBlockpp")] == [
        f"AttnBlockpp_{i}" for i in range(10)]
    assert [n for n in scopes if n.startswith("Downsample")] == [
        f"Downsample_{i}" for i in range(3)]


def test_full_size_parameter_count():
    with torch.device("meta"):
        full = NCSNpp(get_config("cld/accr_dcifar10"))
    assert sum(p.numel() for p in full.parameters()) == 107_597_446


def test_channel_stacking_roundtrip():
    u = torch.arange(2 * 4 * 4 * 3 * 2, dtype=torch.float32).reshape(2, 4, 4, 3, 2)
    h = stack_uv_to_channels(u)
    assert torch.equal(h[..., :3], u[..., 0]) and torch.equal(h[..., 3:], u[..., 1])
    assert torch.equal(unstack_channels_to_uv(h), u)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_fir_resample_matches_jax(kind):
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 5)).astype(np.float32)
    fn_t = t_res.upsample_2d if kind == "up" else t_res.downsample_2d
    fn_j = j_res.upsample_2d if kind == "up" else j_res.downsample_2d
    got = fn_t(torch.from_numpy(x), FIR)
    want = fn_j(jnp.asarray(x), FIR)
    assert got.shape == want.shape
    assert rel_err(got, want) <= BLOCK_REL


def test_conv_downsample_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 6, 16)) / 7).astype(np.float32)
    got = t_res.conv_downsample_2d(torch.from_numpy(x), torch.from_numpy(w), FIR)
    want = j_res.conv_downsample_2d(jnp.asarray(x), jnp.asarray(w), FIR)
    assert got.shape == (2, 4, 4, 16)
    assert rel_err(got, want) <= BLOCK_REL


def _load(module, tree):
    module.load_state_dict(convert.flax_to_state_dict(module, tree))
    return module


@pytest.mark.parametrize("kind,cin,cout", [
    ("stride1", 32, 32), ("stride1", 32, 64), ("pair", (64, 32), 32),
    ("down", 32, 32), ("up", 64, 64),
])
@pytest.mark.parametrize("fused", [True, False])
def test_biggan_block_matches_jax(kind, cin, cout, fused):
    rng = np.random.default_rng(2)
    parts = cin if isinstance(cin, tuple) else (cin,)
    c = sum(parts)
    xs = [rng.standard_normal((2, 8, 8, p)).astype(np.float32) for p in parts]
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    jblk = j_blocks.ResnetBlockBigGANpp(act=nn.swish, out_ch=cout, up=kind == "up",
                                        down=kind == "down", fir=True, fir_kernel=FIR,
                                        skip_rescale=True, init_scale=0.0)
    jx = tuple(map(jnp.asarray, xs)) if kind == "pair" else jnp.asarray(xs[0])
    params = flax.core.unfreeze(jblk.init(jax.random.PRNGKey(0), jx, jnp.asarray(temb),
                                          False)["params"])
    params = _random_like(params, 3)
    want = jblk.apply({"params": params}, jx, jnp.asarray(temb), False)
    tblk = _load(t_blocks.ResnetBlockBigGANpp(c, cout, 16, up=kind == "up",
                                              down=kind == "down", fir_kernel=FIR), params)
    tx = tuple(map(torch.from_numpy, xs)) if kind == "pair" else torch.from_numpy(xs[0])
    got = tblk(tx, torch.from_numpy(temb), fused=fused)
    assert got.shape == want.shape
    assert rel_err(got.detach(), want) <= BLOCK_REL


@pytest.mark.parametrize("fused", [True, False])
def test_attn_block_matches_jax(fused):
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 64)).astype(np.float32)
    jblk = j_blocks.AttnBlockpp(skip_rescale=True, init_scale=0.0)
    params = _random_like(flax.core.unfreeze(
        jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), False)["params"]), 5)
    want = jblk.apply({"params": params}, jnp.asarray(x), False)
    tblk = _load(t_blocks.AttnBlockpp(64, skip_rescale=True), params)
    got = tblk(torch.from_numpy(x), fused=fused)
    assert rel_err(got.detach(), want) <= BLOCK_REL


@pytest.mark.parametrize("conv_impl", ["fused", "plain"])
def test_ncsnpp_eps_matches_jax(jax_model, conv_impl):
    jcfg, jmodel, _ = jax_model
    cfg = small(get_config("cld/accr_dcifar10"))
    cfg.model.conv_impl = conv_impl
    tree = seeded_params(cfg, 0)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    t = np.array([0.5, 0.02], np.float32)
    want = jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), jmodel)(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(u), jnp.asarray(t))
    model = seeded_model(cfg, 0)
    got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u), torch.from_numpy(t))
    assert got.shape == u.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= MODEL_REL
