"""The mixed-score parameterization (``model.mixed_score``, the
``cld/ndeep_cifar10`` config) in the port against the JAX package, in f32 on
the CPU at a small size: the analytic term invR(t) @ [0, v] and the eps
function, the term kept in f32 under a bf16 model, the training loss and
every gradient at dropout 0.1 (the JAX network's own masks fed in), the int8
calibration's site amaxes, and deis-2 NFE=6 sampling from one u0."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import convert
from gddim_torch.cli import build_sampling_fn
from gddim_torch.configs import get_config, train_config
from gddim_torch.math.cld import CLD
from gddim_torch.models.calibrate import calibrate_cld_qscales
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_cld_eps_fn, mixed_score_term
from gddim_torch.train.losses import make_cld_loss_fn
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.math.linalg2 import bmm as jax_bmm
from gddim_tpu.math.linalg2 import inv2 as jax_inv2
from gddim_tpu.models import get_model
from gddim_tpu.models import layers as j_layers
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.models.calibrate import calibrate_cld_qscales as jax_calibrate
from gddim_tpu.samplers import factory as jfactory

# the analytic term alone: the same f32 table, interpolation and 2x2 inverse
# (measured 0 here, t down to 1e-5; 9e-8 against the float64 term)
TERM_REL = 1e-6
# the eps, the loss and each gradient tensor of the small network, f32 (as
# tests/test_torch_train.py); measured 4.5e-7 (eps), up to 1.4e-5 (a
# gradient tensor) here
MODEL_REL = 1e-4
# the attention key bias's exact gradient is zero: measured against
# LEAF_FLOOR of the largest gradient (as tests/test_torch_train.py)
LEAF_FLOOR = 1e-3
# every calibration site's amax (both sides the plain f32 composition;
# measured 1.2e-6 here)
CALIB_REL = 1e-4
# deis-2 NFE=6 samples from one u0 (as tests/test_torch_samplers.py:TRAJ_REL;
# measured 2.5e-5 here)
TRAJ_REL = 1e-4
TS = np.array([0.5, 0.02, 1e-3, 1e-5], np.float32)


def rel_err(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), floor)
    return np.abs(got - want).max() / scale if scale else np.abs(got).max()


def small(cfg, dropout=0.0):
    """``cld/ndeep_cifar10``'s structure at nf=32, two levels, 16x16, f32."""
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.model.dropout = dropout
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    assert cfg.model.mixed_score
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_jax_conv_selector(monkeypatch):
    monkeypatch.setattr(j_layers, "CONV3X3_IMPL", j_layers.CONV3X3_IMPL)


@pytest.fixture(scope="module")
def net():
    cfg = small(get_config("cld/ndeep_cifar10"))
    jcfg = small(jax_get_config("cld/ndeep_cifar10"))
    tree = seeded_params(cfg, 0)
    return cfg, jcfg, tree, seeded_model(cfg, 0), {"params": jax.tree.map(jnp.asarray, tree)}


def _u(seed, b=4):
    u = np.random.default_rng(seed).standard_normal((b, 16, 16, 3, 2)).astype(np.float32)
    u[..., 1] *= 0.5  # v ~ N(0, 1/m), m_inv = 4
    return u


def test_mixed_score_term_matches_jax():
    sde, jsde = CLD(mixed_score=True), JaxCLD.from_config(jax_get_config("cld/ndeep_cifar10"))
    u = _u(1)
    got = mixed_score_term(sde, torch.from_numpy(u), torch.from_numpy(TS))
    want = jax_bmm(jax_inv2(jsde.R(jnp.asarray(TS))), jnp.asarray(u).at[..., 0].set(0.0))
    assert got.dtype == torch.float32 and got.shape == u.shape
    assert rel_err(got, want) <= TERM_REL


def test_mixed_eps_matches_jax(net):
    cfg, jcfg, _, model, variables = net
    u = _u(2)
    want = jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), get_model("ncsnpp")(config=jcfg))(
        variables, jnp.asarray(u), jnp.asarray(TS))
    got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u), torch.from_numpy(TS))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= MODEL_REL
    # and per sample, where the term does not dominate (t = 0.5)
    assert rel_err(got[0], np.asarray(want)[0]) <= MODEL_REL


def test_mixed_term_stays_f32_under_a_bf16_model():
    """The term is added to the network's eps in f32 whatever the model's
    dtype: a bf16 network that returns zeros gives the f32 term exactly,
    within f32 rounding of the float64 term down to t = 1e-5."""
    sde = CLD(mixed_score=True)

    def zeros(x, labels, train=False, generator=None):
        return torch.zeros(x.shape, dtype=torch.bfloat16)

    u, t = torch.from_numpy(_u(3)), torch.from_numpy(TS)
    eps = make_cld_eps_fn(sde)(zeros, u, t)
    assert eps.dtype == torch.float32
    assert torch.equal(eps, mixed_score_term(sde, u, t))
    r = sde.R(t).double()
    inv = torch.linalg.inv(r)
    exact = inv[:, None, None, None, :, 1] * u.double()[..., 1:]
    assert rel_err(eps, exact) <= TERM_REL


def _recording_dropout(masks):
    """A flax interceptor that runs each nn.Dropout as flax does and
    appends the mask it drew to ``masks``."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, flax.linen.Dropout) or context.method_name != "__call__"
                or mod.rate == 0.0):
            return next_fun(*args, **kwargs)
        (x,) = args
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection), keep, x.shape)
        masks.append(mask)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    return interceptor


def test_mixed_loss_and_gradients_match_jax_with_dropout(monkeypatch):
    """The training loss with injected t, z and the JAX network's dropout
    masks (0.1), and every parameter's gradient, against jax.value_and_grad
    of the JAX package's loss pieces."""
    cfg = small(train_config("cld/ndeep_cifar10"), dropout=0.1)
    jcfg = small(jax_get_config("cld/ndeep_cifar10"), dropout=0.1)
    tree = seeded_params(cfg, 0)
    rng = np.random.default_rng(7)
    images = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    t = np.array([0.4, 2e-3], np.float32)
    z = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    jsde = JaxCLD.from_config(jcfg)
    eps_j = jax_make_cld_eps_fn(jsde, get_model("ncsnpp")(config=jcfg), train=True)

    def loss_j(params):
        data = jnp.stack([jnp.asarray(images), jnp.zeros_like(images)], -1)
        tj, zj = jnp.asarray(t), jnp.asarray(z)
        perturbed = jsde.mean(data, tj) + jax_bmm(jsde.R(tj), zj)
        masks = []
        with flax.linen.intercept_methods(_recording_dropout(masks)):
            eps, _ = eps_j({"params": params}, perturbed, tj, rng=jax.random.PRNGKey(0))
        return jnp.square(eps - zj).reshape(2, -1).mean(-1).mean(), masks

    (want_loss, masks), want_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    queue = [np.array(m) for m in masks]
    assert len(queue) == 10  # one mask a residual block

    def jax_mask(probs, generator=None):
        m = queue.pop(0)
        assert m.shape == tuple(probs.shape)
        return torch.from_numpy(m).to(probs.dtype)

    monkeypatch.setattr(torch, "bernoulli", jax_mask)
    model = seeded_model(cfg, 0).train()
    loss = make_cld_loss_fn(CLD.from_config(cfg), train=True)(
        model, torch.from_numpy(images), torch.Generator().manual_seed(0),
        t=torch.from_numpy(t), z=torch.from_numpy(z))
    assert not queue
    loss.backward()
    assert rel_err(loss.detach(), want_loss) <= MODEL_REL
    got = convert.grads_to_flax(model)
    leaves = jax.tree_util.tree_flatten_with_path(flax.core.unfreeze(want_grads))[0]
    largest = max(float(np.abs(w).max()) for _, w in leaves)
    for path, w in leaves:
        node = got
        for k in path:
            node = node[k.key]
        name = jax.tree_util.keystr(path)
        key_bias = name.startswith("['AttnBlockpp") and name.endswith("['NIN_1']['b']")
        assert rel_err(node, w, LEAF_FLOOR * largest if key_bias else 0.0) <= MODEL_REL, name


class _FixedPrior:
    """The JAX CLD with prior_sampling returning a given u0."""

    def __init__(self, sde, u0):
        self._sde, self._u0 = sde, u0

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def prior_sampling(self, rng, shape):
        return self._u0


def test_mixed_calibration_matches_jax(net):
    """The int8 calibration's trajectory carries the term as the sampler
    does: every site's amax along the same order-0 trajectory."""
    cfg, jcfg, _, model, variables = net
    u0 = _u(8, b=2)
    want = jax_calibrate(jcfg, get_model("ncsnpp")(config=jcfg), variables,
                         _FixedPrior(JaxCLD.from_config(jcfg), jnp.asarray(u0)), batch=2, nfe=4)
    want = jax.tree.map(np.asarray, flax.core.unfreeze(want))
    got = calibrate_cld_qscales(cfg, model, CLD.from_config(cfg), batch=2, nfe=4,
                                u0=torch.from_numpy(u0))
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in want.items()}
    for scope, sites in want.items():
        for site, amax in sites.items():
            assert rel_err(got[scope][site], amax) <= CALIB_REL, (scope, site)
    # the term moves the trajectory: without it the last steps' amaxes differ
    unmixed = dataclasses.replace(CLD.from_config(cfg), mixed_score=False)
    plain = calibrate_cld_qscales(cfg, model, unmixed, batch=2, nfe=4, u0=torch.from_numpy(u0))
    assert any(rel_err(plain[s][k], want[s][k]) > 1e-3 for s in want for k in want[s])


def test_mixed_deis_sampling_matches_jax(net):
    """deis order 2, NFE=6 through the CLI's sampling function against the
    JAX package's sampler on the same weights and u0."""
    cfg, jcfg, _, model, variables = net
    for c in (cfg, jcfg):
        c.sampling.method, c.sampling.nfe, c.sampling.deis_order = "deis", 6, 2
        c.sampling.ts_order, c.sampling.noise_removal = 2, True
    u0 = _u(9, b=2)
    sde = JaxCLD.from_config(jcfg)
    sampler = jfactory.build_cld_sampler(
        jcfg, sde, jax_make_cld_eps_fn(sde, get_model("ncsnpp")(config=jcfg)), (16, 16, 3),
        inverse_scaler=lambda a: a)
    jx, jv, jnfe = sampler(jax.random.PRNGKey(5), variables, u0=jnp.asarray(u0))
    x, v, nfe = build_sampling_fn(cfg)(None, model, u0=torch.from_numpy(u0))
    assert nfe == jnfe == 6
    for got, want in ((x, jx), (v, jv)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert rel_err(got, want) <= TRAJ_REL
