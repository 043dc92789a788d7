"""The port's blur family against the JAX package, on the CPU: the matmul
DCT, the BlurSDE schedule and order-0 stacks, the DCT-space eps of a small
network (all-plain and through the layer-wise int8 path), an NFE=4 order-0
trajectory from the same start, the blur calibration, the 3-channel
parameter tree and the CLI's blur sampling. Inputs are numpy draws handed to
both sides; the JAX package's kernels run in interpret mode."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from gddim_torch import convert
from gddim_torch.run_lib import build_sampling_fn, sampling_from_fn
from gddim_torch.configs import get_config
from gddim_torch.math import dct as t_dct
from gddim_torch.math.blur import BlurSDE
from gddim_torch.models.calibrate import calibrate_blur_qscales
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_blur_yeps_fn
from gddim_torch.samplers.blur import blur_order0_stacks, build_blur_sampler

# the JAX package computes the schedule in f32, the port in float64
SDE_REL = 1e-5
# eps of the small network, f32, every layer plain on both sides
EPS_REL = 1e-4
# eps through the layer-wise int8 path (K12 + K11-int8 plain versions against
# the JAX package's int8 conv kernel in interpret mode): measured 1.3e-7 here,
# every int8 rounding agreeing. Three times that would fail on a single
# rounding that flips on a last-bit change of a sum's order: forcing one
# flip moves eps by up to 4.4e-3 (measured), so the bound admits one, and
# stays under the 8.3e-3 by which the port's int8 and f32 networks part.
EPS_INT8_REL = 5e-3
# an NFE=4 trajectory: the f32 eps error carried through four updates
TRAJ_REL = 1e-3
CALIB_REL = 1e-4


@pytest.fixture(scope="module")
def jx():
    import flax
    import jax
    import jax.numpy as jnp
    from gddim_tpu.configs import get_config as jax_get_config
    from gddim_tpu.math import blur, dct
    from gddim_tpu.models import get_model, layers
    from gddim_tpu.models.calibrate import calibrate_blur_qscales as jax_calibrate
    from gddim_tpu.models.wrappers import make_blur_yeps_fn as jax_yeps
    from gddim_tpu.ops import conv3x3
    from gddim_tpu.samplers.blur import blur_order0_stacks as jax_stacks
    from gddim_tpu.samplers.blur import build_blur_sampler as jax_sampler
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(flax=flax, jax=jax, jnp=jnp, get_config=jax_get_config,
                                 blur=blur, dct=dct, get_model=get_model, layers=layers,
                                 calibrate=jax_calibrate, yeps=jax_yeps, c3=conv3x3,
                                 stacks=jax_stacks, sampler=jax_sampler, pltpu=pltpu)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def small(cfg, nf=128):
    """The ddpm_deep trunk at ch_mult (1, 2), one block per level, 16x16,
    f32; nf=128 so that every block's 3x3 convs qualify for K11."""
    cfg.model.nf = nf
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    return cfg


# --------------------------------------------------------------------------
# DCT and the SDE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 32])
def test_dct_matches_jax(jx, n):
    x = np.random.default_rng(60).standard_normal((2, n, n, 3)).astype(np.float32)
    y = t_dct.batch_img_dct(torch.from_numpy(x))
    assert rel_err(y, jx.dct.batch_img_dct(jx.jnp.asarray(x))) <= 1e-6
    assert rel_err(t_dct.batch_img_idct(torch.from_numpy(x)),
                   jx.dct.batch_img_idct(jx.jnp.asarray(x))) <= 1e-6
    assert rel_err(t_dct.batch_img_idct(y), x) <= 1e-6


# fields of the port's config that the JAX package's config has not: the
# whole-transition kernel's setting (GDDIM_TRANSITION_IMPL, an environment
# variable there)
# model.remat: the JAX network reads it with a default (unet.py:165), no config sets it
# fields no JAX config sets (the JAX package reads remat and tfrecords_path
# with a default; the transition kernel's setting is an environment variable)
PORT_ONLY_FIELDS = {("model", "transition_impl"), ("model", "remat"), ("data", "tfrecords_path")}


def test_blur_config_matches_jax(jx):
    """Every data, model and sampling field of the port's blur config has
    the JAX package's value, with bench.py's opt-mode overrides (bf16,
    conv_impl 'fused'; ``bench.py:50-58``)."""
    want = jx.get_config("blur/ddpm_deep_cifar10")
    want.model.dtype, want.model.conv_impl = "bfloat16", "fused"
    got = get_config("blur/ddpm_deep_cifar10")
    for section in ("data", "model", "sampling"):
        for f in dataclasses.fields(getattr(got, section)):
            if (section, f.name) in PORT_ONLY_FIELDS:
                assert f.name not in getattr(want, section)
                continue
            ours, theirs = getattr(getattr(got, section), f.name), getattr(
                getattr(want, section), f.name)
            if isinstance(theirs, (list, tuple)):
                theirs, ours = tuple(theirs), tuple(ours)
            assert ours == theirs, (section, f.name, ours, theirs)
    assert (got.sde, got.seed) == (want.sde, want.seed) == ("blur", 42)


def _sdes(jx, n=32):
    cfg = get_config("blur/ddpm_deep_cifar10")
    cfg.data.image_size = n
    jcfg = jx.get_config("blur/ddpm_deep_cifar10")
    jcfg.data.image_size = n
    return BlurSDE.from_config(cfg), jx.blur.from_config(jcfg)


def test_blur_sde_coefficients_match_jax(jx):
    sde, jsde = _sdes(jx)
    assert abs(sde.sampling_T - jsde.sampling_T) <= SDE_REL * jsde.sampling_T
    ts = np.array([1e-5, 0.01, 0.2, 0.5, 0.9, sde.sampling_T])
    jts = jx.jnp.asarray(ts, jx.jnp.float32)
    for name in ("get_frequency_scaling", "y_mean_coef", "y_std_coef"):
        got, want = getattr(sde, name)(ts), np.asarray(getattr(jsde, name)(jts))
        assert got.shape == want.shape, name
        assert rel_err(got, want) <= SDE_REL, name
    # the same functions on device tensors
    tt = torch.from_numpy(ts.astype(np.float32))
    assert rel_err(sde.y_mean_coef(tt), jsde.y_mean_coef(jts)) <= SDE_REL


def test_blur_order0_stacks_match_jax(jx):
    sde, jsde = _sdes(jx)
    got, want = blur_order0_stacks(sde, 50, 2.0), jx.stacks(jsde, 50, 2.0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g, w) <= SDE_REL


def test_xeps2x0_matches_jax(jx):
    sde, jsde = _sdes(jx, 16)
    rng = np.random.default_rng(61)
    xt, xeps = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0.3, 0.05], np.float32)
    got = sde.xeps2x0(*map(torch.from_numpy, (xt, t, xeps)))
    want = jsde.xeps2x0(*map(jx.jnp.asarray, (xt, t, xeps)))
    assert rel_err(got, want) <= SDE_REL


# --------------------------------------------------------------------------
# The network: the blur tree, eps, trajectory, calibration
# --------------------------------------------------------------------------


def test_blur_param_tree_matches_jax(jx):
    """seeded_params / flax_to_state_dict build the 3-channel blur tree, with
    the JAX package's scopes and shapes."""
    cfg, jcfg = small(get_config("blur/ddpm_deep_cifar10")), small(
        jx.get_config("blur/ddpm_deep_cifar10"))
    jmodel = jx.get_model("ncsnpp")(config=jcfg)
    shapes = jx.jax.eval_shape(lambda: jmodel.init(
        jx.jax.random.PRNGKey(0), jx.jnp.zeros((2, 16, 16, 3)), jx.jnp.ones((2,)), train=False))
    want = {k: tuple(v.shape) for k, v in jx.flax.traverse_util.flatten_dict(
        jx.flax.core.unfreeze(shapes["params"])).items()}
    tree = seeded_params(cfg, 0)
    got = {k: v.shape for k, v in jx.flax.traverse_util.flatten_dict(tree).items()}
    assert got == want
    assert got[("Conv_0", "kernel")] == (3, 3, 3, 128) and got[("Conv_1", "kernel")][-1] == 3
    model = seeded_model(cfg, 0)
    sd = convert.flax_to_state_dict(model, tree)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in model.state_dict().items())


def _patch_jax(jx, monkeypatch):
    """The JAX package's 3x3 conv gate answering as on a TPU; CONV3X3_IMPL
    (which the JAX model sets from its config) restored after the test."""
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", jx.layers.CONV3X3_IMPL)
    monkeypatch.setattr(jx.c3, "supported", lambda x, w, s, d: (
        s == 1 and d == 1 and x[-1] % 128 == 0 and w[-1] % 128 == 0 and tuple(w[:2]) == (3, 3)))


@pytest.fixture(scope="module")
def net(jx):
    cfg = small(get_config("blur/ddpm_deep_cifar10"))
    tree = seeded_params(cfg, 0)
    return types.SimpleNamespace(cfg=cfg, tree=tree, model=seeded_model(cfg, 0),
                                 jvars={"params": jx.jax.tree.map(jx.jnp.asarray, tree)})


@pytest.mark.parametrize("impl,jimpl,bound", [("plain", "xla", EPS_REL),
                                              ("int8", "int8", EPS_INT8_REL)])
def test_blur_eps_matches_jax(jx, net, monkeypatch, impl, jimpl, bound):
    """make_blur_yeps_fn of the small network (nf=128: K11 qualifies) at two
    times, every layer plain, or through the layer-wise int8 path (K12 and
    K11's int8 form as their plain versions) against the JAX package's int8
    path (its int8 conv kernel in interpret mode)."""
    _patch_jax(jx, monkeypatch)
    jcfg = small(jx.get_config("blur/ddpm_deep_cifar10"))
    jcfg.model.conv_impl = jimpl
    jsde = jx.blur.from_config(jcfg)
    rng = np.random.default_rng(62)
    y = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([0.5, 0.02], np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.yeps(jsde, jx.get_model("ncsnpp")(config=jcfg))(
            net.jvars, jx.jnp.asarray(y), jx.jnp.asarray(t))
    net.model.layer = impl if impl != "plain" else None
    net.model.fused = impl != "plain"
    try:
        got = make_blur_yeps_fn(BlurSDE.from_config(net.cfg))(net.model, torch.from_numpy(y),
                                                             torch.from_numpy(t))
    finally:
        net.model.layer, net.model.fused = None, True
    assert got.shape == y.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= bound


class _FixedPrior:
    """A JAX BlurSDE whose prior_sampling returns a given start."""

    def __init__(self, sde, u0):
        self._sde, self._u0 = sde, u0

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def prior_sampling(self, rng, shape):
        assert tuple(shape) == self._u0.shape
        return self._u0


@pytest.fixture(scope="module")
def tiny(jx):
    """nf=32 (every layer plain): the trajectory and the calibration."""
    cfg = small(get_config("blur/ddpm_deep_cifar10"), nf=32)
    jcfg = small(jx.get_config("blur/ddpm_deep_cifar10"), nf=32)
    tree = seeded_params(cfg, 1)
    u0 = np.random.default_rng(63).standard_normal((2, 16, 16, 3)).astype(np.float32)
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, model=seeded_model(cfg, 1), u0=u0,
                                 jvars={"params": jx.jax.tree.map(jx.jnp.asarray, tree)})


def test_blur_order0_trajectory_matches_jax(jx, tiny, monkeypatch):
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", jx.layers.CONV3X3_IMPL)
    cfg, jcfg = tiny.cfg, tiny.jcfg
    cfg.sampling.nfe = jcfg.sampling.nfe = 4
    jsde = jx.blur.from_config(jcfg)
    want, jnfe = jx.sampler(jcfg, jsde, jx.yeps(jsde, jx.get_model("ncsnpp")(config=jcfg)),
                            (16, 16, 3), lambda x: x)(None, tiny.jvars, u0=jx.jnp.asarray(tiny.u0))
    sde = BlurSDE.from_config(cfg)
    got, nfe = build_blur_sampler(cfg, sde, make_blur_yeps_fn(sde), (16, 16, 3))(
        None, tiny.model, u0=torch.from_numpy(tiny.u0))
    assert nfe == jnfe == 4
    assert got.shape == (2, 16, 16, 3) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TRAJ_REL


def test_blur_calibration_matches_jax(jx, tiny, monkeypatch):
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", jx.layers.CONV3X3_IMPL)
    jcfg = small(jx.get_config("blur/ddpm_deep_cifar10"), nf=32)
    jcfg.model.conv_impl = "fused_int8"
    jsde = _FixedPrior(jx.blur.from_config(jcfg), jx.jnp.asarray(tiny.u0))
    want = jx.jax.tree.map(np.asarray, jx.flax.core.unfreeze(
        jx.calibrate(jcfg, jx.get_model("ncsnpp")(config=jcfg), tiny.jvars, jsde, batch=2,
                     nfe=4)))
    got = calibrate_blur_qscales(tiny.cfg, tiny.model, BlurSDE.from_config(tiny.cfg), nfe=4,
                                 u0=torch.from_numpy(tiny.u0))
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in want.items()}
    assert len(got) == 13  # 10 residual blocks, 3 attention blocks
    for scope, sites in want.items():
        for site, amax in sites.items():
            assert rel_err(got[scope][site], amax) <= CALIB_REL, (scope, site)


def test_cli_writes_blur_samples(tmp_path):
    from gddim_torch.cli import main

    cfg = small(get_config("blur/ddpm_deep_cifar10"), nf=32)
    cfg.sampling.nfe = 2
    (path,) = sampling_from_fn(cfg, build_sampling_fn(cfg), seeded_model(cfg, 2),
                               tmp_path / "out", 2, 2, seed=3)
    with np.load(path) as f:
        assert set(f.files) == {"samples", "nfe"}
        assert f["samples"].shape == (2, 16, 16, 3) and f["samples"].dtype == np.uint8
        assert int(f["nfe"]) == 2
    # blur training is ported too: the train mode writes the weights
    main(["--config", "blur/ddpm_deep_cifar10", "--mode", "train", "--device", "cpu",
          "--steps", "1", "--batch", "2", "--out", str(tmp_path / "run"), "--set",
          "model.nf=32", "--set", "model.ch_mult=(1,2)", "--set", "model.num_res_blocks=1",
          "--set", "data.image_size=16"])
    assert (tmp_path / "run" / "params.pt").exists() and (tmp_path / "run" / "ema.pt").exists()
