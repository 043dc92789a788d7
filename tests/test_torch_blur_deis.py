"""The port's frequency-space DEIS for blurring diffusion against the JAX
package, on the CPU: the BlurSDE transition, diffusion and eps integrand,
the per-frequency AB coefficient stacks (``math/deis_scalar.py``, both
integrands), the cached stacks, an order-2 trajectory of a small network
from the same start through ``build_blur_sampler_from_config``, and the
CLI's blur deis sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import cli
from gddim_torch.configs import get_config
from gddim_torch.math import deis_scalar
from gddim_torch.math.blur import BlurSDE
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_blur_yeps_fn
from gddim_torch.samplers import blur as t_blur
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math import blur as j_blur_sde
from gddim_tpu.math import deis_scalar as j_deis_scalar
from gddim_tpu.models import get_model
from gddim_tpu.models import layers as j_layers
from gddim_tpu.models.wrappers import make_blur_yeps_fn as jax_yeps
from gddim_tpu.samplers import blur as j_blur
from gddim_tpu.samplers.timegrid import rev_time_grid

NFE, ORDER = 6, 2
# psi, G and the eps integrand: the port's torch f32 (on f32 times, as the
# JAX package's jnp computes them) against the JAX package's; measured
# 3.1e-8 (psi) and 0 (G, the integrand) here
SDE_REL = 1e-7
# psi's float64 host form against its f32 form: the f32 rounding of the map
# (measured 1.1e-6)
PSI_F64_REL = 3e-6
# The AB stacks: float64 quadratures of the same f32 psi (and, with
# reference_exact, f32 integrand) maps, so they differ by the f32 maps'
# last-bit differences; measured up to 1.4e-7 (x and eps) here. Evaluating
# psi in float64 instead leaves 6.4e-7 (measured), which this bound does
# not admit.
STACK_REL = 4e-7
# An order-2 NFE=6 trajectory of the small network (f32): the network's eps
# error carried through the updates; measured 7.8e-7 here
TRAJ_REL = 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def small(cfg, nf=32):
    """The ddpm_deep trunk at ch_mult (1, 2), one block per level, 16x16, f32."""
    cfg.model.nf = nf
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.sampling.method = "deis"
    cfg.sampling.deis_order = ORDER
    cfg.sampling.nfe = NFE
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run many small ops, which a full thread
    pool per test worker slows many times over when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sdes():
    cfg, jcfg = small(get_config("blur/ddpm_deep_cifar10")), small(
        jax_get_config("blur/ddpm_deep_cifar10"))
    return BlurSDE.from_config(cfg), j_blur_sde.from_config(jcfg)


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path / "torch"))
    monkeypatch.setenv("GDDIM_CACHE_DIR", str(tmp_path / "jax"))
    # the JAX model sets its conv selector from its config: restore it after
    monkeypatch.setattr(j_layers, "CONV3X3_IMPL", j_layers.CONV3X3_IMPL)
    return tmp_path


def test_blur_sde_transition_and_integrand_match_jax(sdes):
    sde, jsde = sdes
    s = np.array([0.9, 0.5, 0.2, 0.01, 1e-5], np.float32)
    t = np.array([0.8, 0.3, 0.19, 1e-3, 1e-5], np.float32)
    ts, tt = torch.from_numpy(s), torch.from_numpy(t)
    assert rel_err(sde.psi(ts, tt), jsde.psi(jnp.asarray(s), jnp.asarray(t))) <= SDE_REL
    for name in ("G", "eps_integrand"):
        got, want = getattr(sde, name)(ts), getattr(jsde, name)(jnp.asarray(s))
        assert got.shape == want.shape == (5, 16, 16, 1), name
        assert rel_err(got, want) <= SDE_REL, name
    # the float64 host form agrees with the f32 device form
    assert rel_err(sde.psi(s.astype(np.float64), t.astype(np.float64)),
                   sde.psi(ts, tt)) <= PSI_F64_REL


@pytest.mark.parametrize("reference_exact", [False, True])
def test_blur_deis_stacks_match_jax(sdes, reference_exact):
    sde, jsde = sdes
    rev_ts = rev_time_grid(sde.sampling_T, sde.sampling_eps, NFE, 2.0)
    x, eps = deis_scalar.blur_deis_coef(sde, rev_ts, ORDER, reference_exact=reference_exact)
    jx_, jeps = j_deis_scalar.blur_deis_coef(jsde, rev_ts, ORDER,
                                             reference_exact=reference_exact)
    assert x.shape == jx_.shape == (NFE, 16, 16, 1)
    assert eps.shape == jeps.shape == (NFE, ORDER + 1, 16, 16, 1)
    assert rel_err(x, jx_) <= STACK_REL and rel_err(eps, jeps) <= STACK_REL
    # warm-up: step i uses min(i, order) + 1 eps
    assert not eps[0, 1:].any() and not eps[1, 2:].any() and eps[2, 2].any()


def test_blur_deis_order0_is_the_ddim_update():
    """With the schedule-derived integrand, the quadrature order-0
    coefficient is the closed-form DDIM update, C_0 == s(t') - psi(t,t')
    s(t), at the tolerance of tests/test_blur.py's JAX twin of this test."""
    sde = BlurSDE(img_dim=8)
    rev_ts = rev_time_grid(sde.sampling_T, 1e-3, 8, 2.0)
    x, eps = deis_scalar.blur_deis_coef(sde, rev_ts, 0, n_quad=20000)
    s = sde.y_std_coef(rev_ts)
    np.testing.assert_allclose(eps[:, 0], s[1:, None, None, None] - x * s[:-1, None, None, None],
                               rtol=5e-3, atol=1e-5)


def test_blur_deis_stacks_are_cached(sdes, cache):
    sde, _ = sdes
    got = t_blur.blur_deis_stacks(sde, NFE, ORDER, 2.0)
    files = list((cache / "torch").glob("gdt_blur_deis_*.npz"))
    assert len(files) == 1 and not (cache / "jax").exists()
    again = t_blur.blur_deis_stacks(sde, NFE, ORDER, 2.0)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)
    other = t_blur.blur_deis_stacks(sde, NFE, ORDER, 2.0, reference_exact=True)
    assert np.abs(other[2] - got[2]).max() > 0
    assert len(list((cache / "torch").glob("gdt_blur_deis_*.npz"))) == 2


def test_blur_deis_trajectory_matches_jax():
    """build_blur_sampler_from_config with method 'deis' (order 2, NFE=6) on
    the small network (every layer plain) from the same DCT-space start."""
    cfg, jcfg = small(get_config("blur/ddpm_deep_cifar10")), small(
        jax_get_config("blur/ddpm_deep_cifar10"))
    tree = seeded_params(cfg, 1)
    u0 = np.random.default_rng(70).standard_normal((2, 16, 16, 3)).astype(np.float32)
    jsde = j_blur_sde.from_config(jcfg)
    want, jnfe = j_blur.build_blur_sampler_from_config(
        jcfg, jsde, jax_yeps(jsde, get_model("ncsnpp")(config=jcfg)), (16, 16, 3),
        lambda x: x)(None, {"params": jax.tree.map(jnp.asarray, tree)}, u0=jnp.asarray(u0))
    sde = BlurSDE.from_config(cfg)
    got, nfe = t_blur.build_blur_sampler_from_config(
        cfg, sde, make_blur_yeps_fn(sde), (16, 16, 3))(None, seeded_model(cfg, 1),
                                                        u0=torch.from_numpy(u0))
    assert nfe == jnfe == NFE
    assert got.shape == (2, 16, 16, 3) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TRAJ_REL
    with pytest.raises(ValueError, match="order0"):
        cfg.sampling.method = "sdeis"
        t_blur.build_blur_sampler_from_config(cfg, sde, make_blur_yeps_fn(sde), (16, 16, 3))


def test_cli_writes_blur_deis_samples(tmp_path):
    out = tmp_path / "out"
    cli.main(["--config", "blur/ddpm_deep_cifar10", "--mode", "sampling", "--device", "cpu",
              "--batch", "2", "--out", str(out), "--set", "sampling.method=deis", "--set",
              "sampling.nfe=3", "--set", "model.nf=32", "--set", "model.ch_mult=(1,2)",
              "--set", "model.num_res_blocks=1", "--set", "data.image_size=16"])
    with np.load(out / "samples_0.npz") as f:
        assert f["samples"].shape == (2, 16, 16, 3) and int(f["nfe"]) == 3
