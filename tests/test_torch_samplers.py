"""The port's CLD sampler family against the JAX package's, on the CPU: every
sampler's host bundle (bit for bit up to float64 noise), the two engines on
the analytic eps of ``tests/test_samplers.py`` with the JAX package's normals
injected, the probability-flow ODE, and each method end to end on the small
NCSN++ (converted weights, f32 'plain' against the JAX package's f32 path)
from the same u0 and the same draws.

Both packages build their bundles once per module, each into its own cache
directory (neither reads the other's, nor a cache outside this module)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch.cli import build_sampling_fn
from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.math.linalg2 import inv2, sbmm
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.samplers import engine, factory
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.math.linalg2 import inv2 as jinv2
from gddim_tpu.math.linalg2 import sbmm as jsbmm
from gddim_tpu.math.variants import HostLambdaSDE as JaxHostLambdaSDE
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.samplers import coefs as jcoefs
from gddim_tpu.samplers import engine as jengine
from gddim_tpu.samplers import factory as jfactory

NFE, ORDER = 6, 2
# The bundles: the same float64 host code on both sides (DOP853 tables, RK4
# Lyapunov sweeps, quadratures); measured bit-identical here
BUNDLE_REL = 1e-10
# The engines on the analytic eps, f32 on both sides with the same normals:
# only the rounding of the 2x2 sums differs (the JAX package contracts the
# history with one einsum and may fuse multiply-adds). The multistep
# coefficients and, for data at 0, the eps itself (about 1/R(t), 1e3 at the
# last steps) cancel to a small state, which amplifies f32 rounding: each
# package's f32 run sits up to 1.5e-4 (N(0, I) data) and 1.8e-3 (data at 0)
# from a float64 run of the same steps, and the two measured up to 8.7e-5
# and 2.0e-3 apart. About 3x of that; and the port's gap to the float64 run
# may exceed the JAX package's by F64_RATIO at most (measured up to 2.6, at
# gaps of 4e-6)
ENGINE_REL = {"smooth": 3e-4, "delta": 6e-3}
F64_RATIO = 5.0
# The ODE sampler on the analytic eps: the same solve_ivp on drifts that
# differ in f32 rounding only; measured 3.7e-6 with equal nfe (309)
ODE_REL = 2e-5
# Each method end to end on the small network (f32): the eps error of a
# network evaluation carried through NFE steps (the ODE through its adaptive
# steps, nfe 45 at rtol = atol = 1e-2); measured 4.5e-7 to 1.0e-6 here
TRAJ_REL = 1e-4

# (case, sampling overrides): every bundle, reference_exact both ways where
# it changes the bundle (hybdeis's grid, sdeis's covariances)
CASES = {
    "order0": dict(method="order0"),
    "order0_em": dict(method="order0", is_em=True),
    "deis": dict(method="deis"),
    "hybdeis": dict(method="hybdeis"),
    "hybdeis_ref": dict(method="hybdeis", reference_exact=True),
    "mldeis": dict(method="mldeis"),
    "ldeis": dict(method="ldeis"),
    "sdeis": dict(method="sdeis", lambda_coef=1.0),
    "sdeis_ref": dict(method="sdeis", lambda_coef=1.0, reference_exact=True),
    "em": dict(method="em", lambda_coef=1.0),
    "sscs": dict(method="sscs"),
}
# the JAX config's defaults the port's config holds too (is_em False,
# reference_exact False)
JAX_DEFAULTS = dict(is_em=False, reference_exact=False)
# the NFE each case's trajectory runs at: the reference_exact hybdeis grid
# is finite only where its noise region has more than one step
RUN_NFE = {case: 12 if case == "hybdeis_ref" else NFE for case in CASES}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def bundle_err(got, want):
    """rel_err over the finite entries, which must sit where want's do (the
    reference_exact hybdeis grid at NFE=6 repeats T, so one step's Lagrange
    weights divide by zero in both packages); 0 for two all-zero arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    diff = np.abs(got[finite] - want[finite]).max() if finite.any() else 0.0
    return diff / scale if scale else diff


@pytest.fixture(scope="module", autouse=True)
def caches(tmp_path_factory):
    """Each package's own cache directory for the module; and one torch
    thread, since these tests run many small ops, which a full thread pool
    per test worker slows many times over when the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GDDIM_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
        mp.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("torch_cache")))
        yield
    torch.set_num_threads(threads)


def _sampling(cfg, case, nfe=NFE):
    s = cfg.sampling
    s.nfe, s.deis_order, s.ts_order, s.noise_removal = nfe, ORDER, 2, True
    for k, v in {**JAX_DEFAULTS, **CASES[case]}.items():
        setattr(s, k, v)
    return cfg


def _jax_sdeis_ref(sdeis, jcfg):
    """The JAX package's reference_exact sdeis bundle, assembled as its
    sdeis_bundle assembles it: reference_exact reaches only the
    covariances (its untransposed Lyapunov sweep; the polynomial eps
    coefficients, most of an sdeis build's time, do not depend on it), so
    its stack is the plain sdeis bundle's and its noise factors are the
    SVD factors of HostLambdaSDE(reference_exact=True)'s covariances with
    the last step's zeroed."""
    lam = JaxHostLambdaSDE(JaxCLD.from_config(jcfg).host(), jcfg.sampling.lambda_coef,
                           reference_exact=True)
    covs = lam.cond_rev_cov_pairs(sdeis.rev_ts[:-1], sdeis.rev_ts[1:])
    covs[-1] = 0.0
    return dataclasses.replace(sdeis, noise_factors=jcoefs._svd_factor(covs))


@pytest.fixture(scope="module")
def bundles():
    """case -> (port bundle, JAX bundle), each built once."""
    memo = {}

    def get(case, nfe=NFE):
        if (case, nfe) not in memo:
            cfg = _sampling(get_config("cld/accr_dcifar10"), case, nfe)
            jcfg = _sampling(jax_get_config("cld/accr_dcifar10"), case, nfe)
            got = factory._bundle_from_config(CLD.from_config(cfg).host(), cfg.sampling)
            if case == "sdeis_ref":
                want = _jax_sdeis_ref(get("sdeis", nfe)[1], jcfg)
            else:
                want = jfactory._bundle_from_config(JaxCLD.from_config(jcfg).host(),
                                                    jcfg.sampling)
            memo[case, nfe] = got, want
        return memo[case, nfe]

    return get


def test_method_list_matches_jax():
    assert factory.CLD_SAMPLERS == jfactory.CLD_SAMPLERS
    assert len(set(factory.CLD_SAMPLERS)) == 9


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_matches_jax(bundles, case):
    got, want = bundles(case)
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "denoise":
            for df in dataclasses.fields(w):
                assert bundle_err(getattr(g, df.name), getattr(w, df.name)) <= BUNDLE_REL, df.name
        elif isinstance(w, np.ndarray):
            assert bundle_err(g, w) <= BUNDLE_REL, f.name
        else:
            assert g is None if w is None else g == w, f.name
    if case.startswith("sdeis"):
        # the last step's covariance is zeroed, every other one is not
        assert not got.noise_factors[-1].any()
        assert all(f.any() for f in got.noise_factors[:-1])
    if case == "order0_em":
        from gddim_torch.math import deis

        mean, eps = deis.naive_em_coef(CLD().host(), got.rev_ts)
        np.testing.assert_array_equal(got.stack[:, 0], mean)
        np.testing.assert_array_equal(got.stack[:, 1], eps)


def test_reference_exact_changes_the_bundles(bundles):
    """reference_exact reaches the hybdeis grid (non-monotone, restarting at
    T) and the sdeis covariances (the untransposed Lyapunov sweep, whose
    'covariances' are not symmetric), and nothing else."""
    grid, grid_ref = bundles("hybdeis")[0].rev_ts, bundles("hybdeis_ref")[0].rev_ts
    assert np.all(np.diff(grid) < 0) and not np.all(np.diff(grid_ref) < 0)
    sym, ref = bundles("sdeis")[0], bundles("sdeis_ref")[0]
    np.testing.assert_array_equal(sym.stack, ref.stack)
    assert np.abs(sym.noise_factors - ref.noise_factors).max() > 1e-6


def _jax_eps(kind, dev):
    """The analytic eps of tests/test_samplers.py: 'delta' for data at 0,
    eps = R(t)^-1 u; 'smooth' for N(0, I) data, eps = R(t)^T Sm(t)^-1 u with
    Sm = Psi(0, t) Psi(0, t)^T + Sigma(t)."""

    def eps_fn(u, t):
        if kind == "delta":
            return jsbmm(jinv2(dev.R(t)), u)
        ps = dev.psi(jnp.zeros_like(t), t)
        return jsbmm(dev.R(t).T @ jinv2(ps @ ps.T + dev.cov(t)), u)

    return eps_fn


def _port_eps(kind, sde, dtype=torch.float32):
    """_jax_eps's functions in the port, in ``dtype`` (the f32 R table)."""

    def eps_fn(u, t):
        t = torch.tensor(np.float32(t), dtype=dtype)
        r = sde.R(t)
        if kind == "delta":
            return sbmm(inv2(r), u)
        ps = sde.psi(torch.zeros_like(t), t).to(dtype)
        return sbmm(r.T @ inv2(ps @ ps.T + r @ r.T), u)

    return eps_fn


def jax_normals(key, n_steps, shape, sscs=False):
    """The normals the JAX engines draw at each step: normal(fold_in(key, i))
    for the multistep engine, the two halves of its split for sscs."""
    out = []
    for i in range(n_steps):
        step = jax.random.fold_in(key, i)
        if sscs:
            r1, r2 = jax.random.split(step)
            out.append(tuple(torch.from_numpy(np.asarray(jax.random.normal(r, shape)))
                             for r in (r1, r2)))
        else:
            out.append(torch.from_numpy(np.asarray(jax.random.normal(step, shape))))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_on_analytic_eps(bundles, case):
    """The engines on the exact eps of two data distributions, the JAX
    package's own normals fed to the port's engine; both packages' f32 runs
    are measured against a float64 run of the port's engine too."""
    got_b, want_b = bundles(case, RUN_NFE[case])
    u0 = np.random.default_rng(1).standard_normal((3, 5, 2)).astype(np.float32)
    u0[..., 1] *= 0.5
    key = jax.random.PRNGKey(7)
    sscs = case == "sscs"
    n_steps = len(got_b.rev_ts) - 1
    jrun = jengine.sscs_sample if sscs else jengine.ab_sample
    run = engine.sscs_sample if sscs else engine.ab_sample
    stochastic = sscs or got_b.noise_factors is not None
    noise = jax_normals(key, n_steps, u0.shape, sscs) if stochastic else None
    noise64 = None
    if stochastic:
        noise64 = [tuple(z.double() for z in zs) if sscs else zs.double() for zs in noise]
    sde, dev = CLD(), JaxCLD.create()
    for kind in ("smooth", "delta"):
        want = jrun(_jax_eps(kind, dev), jnp.asarray(u0), want_b, key)
        got = run(_port_eps(kind, sde), torch.from_numpy(u0), got_b, noise=noise)
        assert got.shape == u0.shape and torch.isfinite(got).all()
        ref = run(_port_eps(kind, sde, torch.float64), torch.from_numpy(u0).double(), got_b,
                  noise=noise64)
        gap, jax_gap, port_gap = rel_err(got, want), rel_err(want, ref), rel_err(got, ref)
        assert gap <= ENGINE_REL[kind], (kind, gap)
        assert port_gap <= F64_RATIO * jax_gap, (kind, jax_gap, port_gap)
    if stochastic:
        with pytest.raises(ValueError, match="stochastic"):
            run(_port_eps("smooth", sde), torch.from_numpy(u0), got_b)
        # a generator on the state's device draws instead: the same bundle,
        # other normals, another sample
        other = run(_port_eps("smooth", sde), torch.from_numpy(u0), got_b,
                    torch.Generator().manual_seed(0))
        assert torch.isfinite(other).all() and not torch.allclose(other, got)


class _Dummy(torch.nn.Module):
    """A model of no layers: the ODE sampler reads the device from it."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


def test_ode_matches_jax_on_analytic_eps():
    cfg = get_config("cld/accr_dcifar10")
    jcfg = jax_get_config("cld/accr_dcifar10")
    for c in (cfg, jcfg):
        c.sampling.method, c.sampling.noise_removal = "ode", True
    assert (cfg.sampling.rtol, cfg.sampling.atol, cfg.sampling.ode_method) == (
        jcfg.sampling.rtol, jcfg.sampling.atol, jcfg.sampling.ode_method) == (1e-5, 1e-5, "RK45")
    dev, sde = JaxCLD.create(), CLD()
    u0 = np.random.default_rng(2).standard_normal((4, 3, 2)).astype(np.float32)

    def jeps(variables, u, t_vec):
        return jsbmm(jinv2(dev.R(t_vec[0])), u)

    def teps(model, u, t_vec):
        return sbmm(inv2(sde.R(t_vec[0])), u)

    jx, jv, jnfe = jfactory.build_cld_sampler(jcfg, dev, jeps, (3,))(
        jax.random.PRNGKey(0), {}, u0=jnp.asarray(u0))
    x, v, nfe = factory.build_cld_sampler(cfg, sde, teps, (3,))(
        None, _Dummy(), u0=torch.from_numpy(u0))
    assert nfe == jnfe > 10
    assert rel_err(x, jx) <= ODE_REL and rel_err(v, jv) <= ODE_REL


def test_device_drift_matches_jax():
    """F(t), G(t), invR and eps2score on the device, as the ODE drift takes them."""
    sde, dev = CLD(), JaxCLD.create()
    for t in (1e-3, 0.37, 1.0):
        assert rel_err(sde.F(t), dev.F(t)) <= 1e-7 and rel_err(sde.G(t), dev.G(t)) <= 1e-7
    ts = np.array([1e-3, 0.2, 0.7, 1.0], np.float32)
    eps = np.random.default_rng(3).standard_normal((4, 2, 3, 2)).astype(np.float32)
    assert rel_err(sde.invR(torch.from_numpy(ts)), dev.invR(jnp.asarray(ts))) <= 1e-6
    assert rel_err(sde.eps2score(torch.from_numpy(eps), torch.from_numpy(ts)),
                   dev.eps2score(jnp.asarray(eps), jnp.asarray(ts))) <= 1e-6


def small(cfg, case):
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    if case == "ode":  # at 1e-2, a fraction of the default 1e-5's evaluations
        cfg.sampling.method, cfg.sampling.noise_removal = "ode", True
        cfg.sampling.rtol = cfg.sampling.atol = 1e-2
        return cfg
    return _sampling(cfg, case)


@pytest.fixture(scope="module")
def net():
    cfg = small(get_config("cld/accr_dcifar10"), "deis")
    cfg.model.conv_impl = "plain"
    tree = seeded_params(cfg, 0)
    return seeded_model(cfg, 0), {"params": jax.tree.map(jnp.asarray, tree)}


E2E = ["order0", "order0_em", "hybdeis", "mldeis", "ldeis", "sdeis", "em", "sscs", "ode"]


@pytest.mark.parametrize("case", E2E)
def test_method_end_to_end_matches_jax(net, case):
    """The method through the CLI's sampling function on the small NCSN++
    (f32 'plain') against the JAX package's sampler on the same weights,
    with the same u0 and, for sdeis, em and sscs, the JAX draws fed in."""
    model, variables = net
    cfg = small(get_config("cld/accr_dcifar10"), case)
    jcfg = small(jax_get_config("cld/accr_dcifar10"), case)
    u0 = np.random.default_rng(4).standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    u0[..., 1] *= 0.5
    key = jax.random.PRNGKey(5)
    sde = JaxCLD.from_config(jcfg)
    sampler = jfactory.build_cld_sampler(
        jcfg, sde, jax_make_cld_eps_fn(sde, get_model("ncsnpp")(config=jcfg)), (16, 16, 3),
        inverse_scaler=lambda a: (a + 1.0) / 2.0)
    jxs, jvs, jnfe = sampler(key, variables, u0=jnp.asarray(u0))
    noise = None
    if case in ("sdeis", "em", "sscs"):
        noise = jax_normals(key, NFE - 1, u0.shape, sscs=case == "sscs")
    x, v, nfe = build_sampling_fn(cfg)(None, model, u0=torch.from_numpy(u0), noise=noise)
    assert nfe == jnfe and (case == "ode" or nfe == NFE)
    for got, want in ((x, jxs), (v, jvs)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert rel_err(got, want) <= TRAJ_REL, case


def test_cli_samples_with_the_new_methods(tmp_path):
    """--set sampling.method=sdeis / sscs / ode writes samples and nfe."""
    from gddim_torch import cli

    small_cfg = ["--set", "model.nf=32", "--set", "model.ch_mult=(1,2)", "--set",
                 "model.num_res_blocks=1", "--set", "data.image_size=16", "--set",
                 "sampling.nfe=6"]
    for method in ("sdeis", "sscs", "ode"):
        out = tmp_path / method
        cli.main(["--mode", "sampling", "--device", "cpu", "--batch", "2", "--out", str(out),
                  "--set", f"sampling.method={method}", "--set", "sampling.rtol=1e-2",
                  "--set", "sampling.atol=1e-2", *small_cfg])
        with np.load(out / "samples_0.npz") as f:
            assert f["samples"].shape == (2, 16, 16, 3) and f["samples"].dtype == np.uint8
            assert np.isfinite(f["v"]).all()
            assert int(f["nfe"]) == 6 if method != "ode" else int(f["nfe"]) > 6
