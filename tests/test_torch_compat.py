"""The reference-API shims (``gddim_torch/compat.py``) and the package API
against the JAX package's on the CPU: ``tests/test_compat.py``'s surface
name for name, the eps and score closures on the same weights (converted
from the JAX parameter tree) and inputs, the DDPM and SMLD schedules, the
helpers, and the names the package and its ``models``, ``data`` and
``evals`` packages export."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gddim_torch
from gddim_torch import compat
from gddim_torch.configs import get_config
from gddim_torch.models.init import seeded_params
from gddim_torch.models.wrappers import make_cld_eps_fn, make_cld_score_fn
from gddim_tpu import compat as j_compat
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.models import get_model

# the point-set MLP in f32 (tests/test_torch_points.py's bound); the score
# multiplies eps by -R(t)^-T, up to ~1e2 at small t
EPS_REL = 1e-6
SCORE_REL = 1e-5
# the small NCSN++ (tests/test_torch_model.py's bound); rel_err is relative
# to max|want|
MODEL_REL = 1e-4

SURFACE = ["register_model", "get_model", "init_model", "get_eps_fn", "get_score_fn", "State",
           "CLD", "LambdaSDE", "LSDE", "MLCLD", "from_config", "to_flattened_numpy",
           "from_flattened_numpy", "bmm", "sbmm", "inv_2x2", "aug_batch", "create_classifier",
           "get_logit_fn", "get_classifier_grad_fn", "get_data_shape", "get_sigmas",
           "get_ddpm_params"]


def rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_compat_surface():
    for name in SURFACE:
        assert hasattr(j_compat, name) and hasattr(compat, name), name
    assert compat.LambdaSDE.__name__ == "HostLambdaSDE" and compat.State.__name__ == "TrainState"


def _small_ncsnpp(cfg):
    cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 32, (1, 2), 1
    cfg.model.attn_resolutions, cfg.data.image_size, cfg.model.dtype = (8,), 16, "float32"
    return cfg


@pytest.fixture(scope="module", params=["cld/points", "cld/accr_dcifar10"])
def closures(request):
    """The JAX compat closures on init_model's weights and the port's on
    the same weights given as the flax tree; their inputs."""
    name = request.param
    jcfg, cfg = jax_get_config(name), get_config(name)
    if name != "cld/points":
        jcfg, cfg = _small_ncsnpp(jcfg), _small_ncsnpp(cfg)
        cfg.model.conv_impl = "plain"
    model, states, tree = compat.init_model(0, cfg, device="cpu")
    assert states == {}
    if name == "cld/points":
        jmodel, jstates, jparams = j_compat.init_model(jax.random.PRNGKey(0), jcfg)
        params = jax.tree.map(np.asarray, jparams)
        assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, params)
    else:  # the port's seeded tree (tests/test_torch_model.py holds its layout)
        jmodel, jstates, params = get_model("ncsnpp")(config=jcfg), {}, seeded_params(cfg, 0)
        jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    shape = (4, 2, 2) if name == "cld/points" else (4, 16, 16, 3, 2)
    u = rng.standard_normal(shape).astype(np.float32)
    t = np.array([0.2, 0.4, 0.6, 0.8], np.float32)
    jsde, sde = j_compat.from_config(jcfg), compat.from_config(cfg)
    return dict(name=name, jmodel=jmodel, jstates=jstates, jparams=jparams, params=params,
                model=model, jsde=jsde, sde=sde, u=u, t=t)


def test_eps_and_score_fns_match_jax(closures):
    c = closures
    ju, jt, u, t = jnp.asarray(c["u"]), jnp.asarray(c["t"]), torch.from_numpy(c["u"]), \
        torch.from_numpy(c["t"])
    j_eps = j_compat.get_eps_fn(c["jsde"], c["jmodel"], c["jparams"], c["jstates"])(ju, jt)
    j_score = j_compat.get_score_fn(c["jsde"], c["jmodel"], c["jparams"], c["jstates"])(ju, jt)
    eps_fn = compat.get_eps_fn(c["sde"], c["model"], c["params"], {})
    score_fn = compat.get_score_fn(c["sde"], c["model"], None, {})  # the weights stand
    eps, score = eps_fn(u, t), score_fn(u, t)
    bound = EPS_REL if c["name"] == "cld/points" else MODEL_REL
    assert eps.shape == u.shape and rel_err(eps, j_eps) <= bound
    assert rel_err(score, j_score) <= max(bound, SCORE_REL)
    # the closures are the wrappers, called directly: the same bits
    assert torch.equal(eps, make_cld_eps_fn(c["sde"])(c["model"], u, t))
    assert torch.equal(score, make_cld_score_fn(c["sde"])(c["model"], u, t))
    assert torch.equal(score, c["sde"].eps2score(eps, t))
    out, states = compat.get_eps_fn(c["sde"], c["model"], return_state=True)(u, t)
    assert torch.equal(out, eps) and states is None


def test_train_closure_draws_dropout_from_rng(closures):
    """train=True runs the training path; ``rng`` (a torch.Generator) draws
    the dropout masks: one seed, one result."""
    c = closures
    u, t = torch.from_numpy(c["u"]), torch.from_numpy(c["t"])
    fn = compat.get_score_fn(c["sde"], c["model"], train=True, return_state=True)
    a, states = fn(u, t, torch.Generator().manual_seed(3))
    b, _ = fn(u, t, torch.Generator().manual_seed(3))
    assert a.requires_grad and states is None and torch.equal(a, b)


@pytest.mark.parametrize("name", ["cld/accr_dcifar10", "blur/ddpm_deep_cifar10",
                                  "cld/ddpmpp_celeba"])
def test_schedules_match_jax(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert (cfg.model.beta_min, cfg.model.beta_max) == (jcfg.model.beta_min,
                                                        jcfg.model.beta_max) == (0.1, 20.0)
    got, want = compat.get_ddpm_params(cfg), j_compat.get_ddpm_params(jcfg)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    # the port takes the f32 sigmas from f64 numpy, the JAX package from f32 jnp
    assert rel_err(compat.get_sigmas(cfg), np.asarray(j_compat.get_sigmas(jcfg))) <= 1e-6
    assert compat.get_data_shape(cfg) == j_compat.get_data_shape(jcfg)


def test_compat_helpers_match_jax():
    x = np.arange(6.0).reshape(2, 3)
    flat = compat.to_flattened_numpy(torch.from_numpy(x))
    np.testing.assert_array_equal(flat, j_compat.to_flattened_numpy(jnp.asarray(x)))
    back = compat.from_flattened_numpy(flat, (2, 3), device="cpu")
    want = j_compat.from_flattened_numpy(flat, (2, 3))
    assert back.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    aug = compat.aug_batch(torch.ones((2, 3)))
    np.testing.assert_array_equal(aug.numpy(), np.asarray(j_compat.aug_batch(jnp.ones((2, 3)))))
    rng = np.random.default_rng(2)
    m = rng.standard_normal((5, 2, 2)).astype(np.float32)
    s = rng.standard_normal((5, 3, 2)).astype(np.float32)
    assert rel_err(compat.inv_2x2(torch.from_numpy(m)), j_compat.inv_2x2(jnp.asarray(m))) <= 1e-6
    assert rel_err(compat.bmm(torch.from_numpy(m), torch.from_numpy(s)),
                   j_compat.bmm(jnp.asarray(m), jnp.asarray(s))) <= 1e-6
    assert rel_err(compat.sbmm(torch.from_numpy(m[0]), torch.from_numpy(s)),
                   j_compat.sbmm(jnp.asarray(m[0]), jnp.asarray(s))) <= 1e-6
    pts = get_config("cld/points")
    assert compat.get_data_shape(pts) == j_compat.get_data_shape(jax_get_config("cld/points"))


def test_package_api_matches_jax():
    """The lazy top-level names, and every name ``gddim_tpu.models``,
    ``.data`` and ``.evals`` export that the port has (``evals``: all but
    run_features_sharded, whose one-card form is run_features)."""
    import gddim_tpu
    import gddim_tpu.data
    import gddim_tpu.evals
    import gddim_tpu.models

    import gddim_torch.data
    import gddim_torch.evals
    import gddim_torch.models

    for name in ("CLD", "CLDParams", "HostCLD", "BlurSDE", "run_lib", "get_config"):
        getattr(gddim_tpu, name)
        assert getattr(gddim_torch, name).__name__.split(".")[-1] == name
    with pytest.raises(AttributeError):
        gddim_torch.nothing_here
    assert gddim_torch.get_config("cld/points").model.name == "ps_fmlp"
    for jpkg, pkg, skip in ((gddim_tpu.models, gddim_torch.models, ()),
                            (gddim_tpu.data, gddim_torch.data, ()),
                            (gddim_tpu.evals, gddim_torch.evals, ("run_features_sharded",))):
        names = {n for n in vars(jpkg) if not n.startswith("_") and callable(getattr(jpkg, n))}
        assert names - set(skip) <= set(vars(pkg)), (pkg.__name__, names - set(vars(pkg)))
    assert gddim_torch.models.get_model("ncsnpp").__name__ == "NCSNpp"
    assert "run_features" in vars(gddim_torch.evals)


def test_import_is_light():
    """``import gddim_torch`` imports no torch and builds nothing."""
    code = "import sys, gddim_torch; print(sorted(m for m in sys.modules if m.startswith('torch')))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
