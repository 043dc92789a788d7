"""The NCSNv1/v2 zoo (``gddim_torch/models/legacy_blocks.py``,
``models/normalization.py``) against the flax modules of
``gddim_tpu/models/legacy_blocks.py`` / ``normalization.py`` on the CPU:
each block and norm on the same numpy inputs with the flax parameters
(drawn from a seed, not the initialisers' streams) converted onto it, at
the shapes ``tests/test_models.py`` builds them, within 1e-5 of max|out|."""

import functools

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gddim_torch import convert
from gddim_torch.models import legacy_blocks as tl
from gddim_torch.models import normalization as tn
from gddim_tpu.models import legacy_blocks as jl
from gddim_tpu.models import normalization as jn

ZOO_REL = 1e-5


def rel_err(got, want):
    got, want = got.detach().numpy().astype(np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _random_like(tree, seed):
    """Every leaf N(0, 1/fan_in) (norm parameters 1 + 0.1 N), so that no
    zero-initialised output projection hides a path."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("scale", "gamma", "alpha")):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = max(int(np.prod(a.shape[:-1])), 1)
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _hold(jmod, tmod, args, targs=None, seed=0, **apply_kw):
    """Init the flax module, redraw its parameters, convert them onto the
    torch module, and compare both outputs on the same inputs."""
    jargs = [jax.tree.map(jnp.asarray, a) for a in args]
    params = flax.core.unfreeze(jmod.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *jargs, **apply_kw).get("params", {}))
    params = _random_like(params, seed)
    want = jmod.apply({"params": params}, *jargs, **apply_kw)
    tmod.load_state_dict(convert.flax_to_state_dict(tmod, params))
    got = tmod(*(targs if targs is not None else
                 [jax.tree.map(torch.from_numpy, a) for a in args]))
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_err(got, want) <= ZOO_REL


X = (2, 16, 16, 32)
XS = [(2, 8, 8, 64), (2, 16, 16, 32)]


def test_crp_rcu_attn_blocks():
    x = _inputs([X], 1)
    _hold(jl.CRPBlock(32, 2), tl.CRPBlock(32, 2), x, seed=2)
    _hold(jl.RCUBlock(32, 2, 2), tl.RCUBlock(32, 2, 2), x, seed=3)
    _hold(jl.LegacyAttnBlock(), tl.LegacyAttnBlock(32), x, seed=4)


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest_neighbor"])
@pytest.mark.parametrize("shape", [(16, 16), (8, 8)])
def test_msf_block(interpolation, shape):
    """The fusion up to the larger input and down to the smaller (the
    antialiased bilinear shrink), both interpolations."""
    xs = _inputs(XS, 5)
    _hold(jl.MSFBlock(32, shape, interpolation), tl.MSFBlock([64, 32], 32, shape, interpolation),
          [xs], targs=[list(map(torch.from_numpy, xs))], seed=6)


@pytest.mark.parametrize("end", [False, True])
def test_refine_block(end):
    xs = _inputs(XS, 7)
    _hold(jl.RefineBlock(32, (16, 16), end=end), tl.RefineBlock([64, 32], 32, (16, 16), end=end),
          [xs], targs=[list(map(torch.from_numpy, xs))], seed=8)
    x = _inputs([(2, 8, 8, 64)], 9)
    _hold(jl.RefineBlock(64, (8, 8), start=True), tl.RefineBlock([64], 64, (8, 8), start=True),
          [x], targs=[[torch.from_numpy(x[0])]], seed=10)


J_NORM = functools.partial(jn.ConditionalInstanceNorm2dPlus, num_classes=10)
T_NORM = functools.partial(tn.ConditionalInstanceNorm2dPlus, num_classes=10)
Y = np.array([1, 7], np.int32)


def test_conditional_crp_rcu_msf():
    x = _inputs([X], 11)[0]
    y_t = torch.from_numpy(Y)
    _hold(jl.CondCRPBlock(32, 2, J_NORM), tl.CondCRPBlock(32, 2, T_NORM), [x, Y],
          targs=[torch.from_numpy(x), y_t], seed=12)
    _hold(jl.CondRCUBlock(32, 2, 2, J_NORM), tl.CondRCUBlock(32, 2, 2, T_NORM), [x, Y],
          targs=[torch.from_numpy(x), y_t], seed=13)
    xs = _inputs(XS, 14)
    _hold(jl.CondMSFBlock(32, (16, 16), J_NORM), tl.CondMSFBlock([64, 32], 32, (16, 16), T_NORM),
          [xs, Y], targs=[list(map(torch.from_numpy, xs)), y_t], seed=15)


@pytest.mark.parametrize("start", [False, True])
def test_conditional_refine_block(start):
    y_t = torch.from_numpy(Y)
    if start:  # one input, the fusion bypassed
        xs = _inputs([(2, 8, 8, 64)], 16)
        jmod, tmod = jl.CondRefineBlock(64, (8, 8), J_NORM, start=True), \
            tl.CondRefineBlock([64], 64, (8, 8), T_NORM, start=True)
    else:
        xs = _inputs(XS, 17)
        jmod, tmod = jl.CondRefineBlock(32, (16, 16), J_NORM, end=True), \
            tl.CondRefineBlock([64, 32], 32, (16, 16), T_NORM, end=True)
    _hold(jmod, tmod, [xs, Y], targs=[list(map(torch.from_numpy, xs)), y_t], seed=18)


@pytest.mark.parametrize("with_conv", [False, True])
def test_legacy_up_and_downsample(with_conv):
    x = _inputs([(2, 8, 8, 16)], 19)
    _hold(jl.LegacyUpsample(with_conv), tl.LegacyUpsample(16, with_conv), x, seed=20)
    _hold(jl.LegacyDownsample(with_conv), tl.LegacyDownsample(16, with_conv), x, seed=21)


@pytest.mark.parametrize("conv_shortcut", [False, True])
def test_legacy_resnet_block_ddpm(conv_shortcut):
    x, temb = _inputs([X, (2, 128)], 22)
    _hold(jl.LegacyResnetBlockDDPM(act=nn.relu, out_ch=64, conv_shortcut=conv_shortcut),
          tl.LegacyResnetBlockDDPM(32, F.relu, 64, conv_shortcut, temb_dim=128), [x, temb],
          seed=23, train=False)
    _hold(jl.LegacyResnetBlockDDPM(act=nn.swish), tl.LegacyResnetBlockDDPM(32, F.silu),
          [x], seed=24, train=False)


@pytest.mark.parametrize("name,bias", [
    ("VarianceNorm2d", False), ("VarianceNorm2d", True), ("InstanceNorm2d", True),
    ("InstanceNorm2d", False), ("InstanceNorm2dPlus", True), ("InstanceNorm2dPlus", False)])
def test_norms(name, bias):
    x = _inputs([(2, 8, 8, 16)], 25)
    _hold(getattr(jn, name)(bias=bias), getattr(tn, name)(16, bias=bias), x, seed=26)


@pytest.mark.parametrize("bias", [True, False])
def test_conditional_instance_norm_plus(bias):
    x = _inputs([(2, 8, 8, 16)], 27)[0]
    _hold(jn.ConditionalInstanceNorm2dPlus(10, bias),
          tn.ConditionalInstanceNorm2dPlus(16, 10, bias),
          [x, Y], targs=[torch.from_numpy(x), torch.from_numpy(Y)], seed=28)


def test_get_normalization_and_group_norm():
    class Cfg:
        class model:
            normalization = "GroupNorm"

    for norm, cls in (("InstanceNorm", "InstanceNorm2d"), ("InstanceNorm++", "InstanceNorm2dPlus"),
                      ("VarianceNorm", "VarianceNorm2d")):
        Cfg.model.normalization = norm
        assert tn.get_normalization(Cfg) is getattr(tn, cls)
        assert jn.get_normalization(Cfg).__name__ == cls
    Cfg.model.normalization = "InstanceNorm++"
    assert tn.get_normalization(Cfg, conditional=True) is tn.ConditionalInstanceNorm2dPlus
    Cfg.model.normalization = "GroupNorm"
    with pytest.raises(NotImplementedError):
        tn.get_normalization(Cfg, conditional=True)
    x = _inputs([(2, 8, 8, 64)], 29)
    _hold(jn.get_normalization(Cfg)(), tn.get_normalization(Cfg)(64), x, seed=30)
