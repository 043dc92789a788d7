"""The port's training path against the JAX package, in f32 on the CPU: the
CLD forward process, the synthetic data stream, the whole network's loss and
every parameter's gradient, one optimizer run, and the CLI's train mode."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import cli, convert
from gddim_torch.configs import train_config
from gddim_torch.data import synthetic
from gddim_torch.math.cld import CLD
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.train import state as t_state
from gddim_torch.train import step as t_step
from gddim_torch.train.losses import make_cld_loss_fn
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.data import pipelines
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.math.linalg2 import bmm as jax_bmm
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.train import state as j_state
from gddim_tpu.train import step as j_step

MATH_REL = 1e-6
MODEL_REL = 1e-4
OPT_REL = 1e-5
# The attention key bias's exact gradient is zero (softmax ignores a constant
# added to every logit of a row), so its leaf is rounding noise (about 1e-9 of
# the largest gradient here): its error is measured against LEAF_FLOOR of the
# largest gradient. Every other leaf is measured against its own largest entry.
LEAF_FLOOR = 1e-3


def rel_err(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), floor)
    if scale == 0:
        return np.abs(got).max()
    return np.abs(got - want).max() / scale


def small(cfg):
    """The accr structure at nf=32, ch_mult=(1, 2), one block per level,
    16x16, f32, dropout 0 (as tests/test_ops.py:600), so both packages
    compute the same function."""
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.model.dropout = 0.0
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    return cfg


def test_cld_forward_process_matches_jax():
    sde, jsde = CLD(), JaxCLD.create()
    rng = np.random.default_rng(0)
    t = np.concatenate([[1e-5, 0.5, 1.0], rng.uniform(1e-5, 1.0, 13)]).astype(np.float32)
    assert rel_err(sde.R(torch.from_numpy(t)), jsde.R(jnp.asarray(t))) <= MATH_REL
    s = (t * 0.5).astype(np.float32)
    assert rel_err(sde.psi(torch.from_numpy(s), torch.from_numpy(t)),
                   jsde.psi(jnp.asarray(s), jnp.asarray(t))) <= MATH_REL
    batch = rng.standard_normal((16, 4, 4, 3, 2)).astype(np.float32)
    z = rng.standard_normal(batch.shape).astype(np.float32)
    got, mean, z_out = sde.perturb_data(torch.from_numpy(batch), torch.from_numpy(t),
                                        z=torch.from_numpy(z))
    jmean = jsde.mean(jnp.asarray(batch), jnp.asarray(t))
    want = jmean + jax_bmm(jsde.R(jnp.asarray(t)), jnp.asarray(z))
    assert rel_err(mean, jmean) <= MATH_REL
    assert rel_err(got, want) <= MATH_REL
    assert torch.equal(z_out, torch.from_numpy(z))


def test_synthetic_stream_matches_jax():
    cfg, jcfg = train_config("cld/accr_dcifar10"), jax_get_config("cld/accr_dcifar10")
    np.testing.assert_array_equal(synthetic.synthetic_images(cfg, 64, seed=3),
                                  pipelines._synthetic_images(jcfg, 64, seed=3))
    stream = synthetic.SyntheticStream(cfg, batch=4, n_jitted=2, seed=5)
    ds = pipelines.ArrayDataset(synthetic.synthetic_images(cfg, 2048, seed=5), (2, 4), seed=5,
                                random_flip=True, prefetch=False)
    for _ in range(3):
        got = next(stream)
        assert got.shape == (2, 4, 32, 32, 3)
        np.testing.assert_array_equal(got, next(ds)["image"])
    scale = synthetic.get_data_scaler(cfg)
    np.testing.assert_array_equal(scale(np.ones(2)), pipelines.get_data_scaler(jcfg)(np.ones(2)))


@pytest.fixture(scope="module")
def small_models():
    cfg = small(train_config("cld/accr_dcifar10"))
    jcfg = small(jax_get_config("cld/accr_dcifar10"))
    tree = seeded_params(cfg, 0)
    return cfg, jcfg, tree


def _inputs(seed, b=2, size=16):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, b).astype(np.float32)
    z = rng.standard_normal((b, size, size, 3, 2)).astype(np.float32)
    return images, t, z


def test_model_loss_and_gradients_match_jax(small_models):
    """The whole training loss with injected t and z, and the gradient of
    every parameter (the Fourier frequencies' zero included), against
    jax.value_and_grad of the JAX package's make_cld_loss_fn pieces."""
    cfg, jcfg, tree = small_models
    images, t, z = _inputs(1)
    jsde = JaxCLD.from_config(jcfg)
    model_j = get_model("ncsnpp")(config=jcfg)
    eps_j = jax_make_cld_eps_fn(jsde, model_j, train=True)

    def loss_j(params):
        data = jnp.stack([jnp.asarray(images), jnp.zeros_like(images)], -1)
        tj, zj = jnp.asarray(t), jnp.asarray(z)
        perturbed = jsde.mean(data, tj) + jax_bmm(jsde.R(tj), zj)
        eps, _ = eps_j({"params": params}, perturbed, tj, rng=jax.random.PRNGKey(0))
        return jnp.square(eps - zj).reshape(2, -1).mean(-1).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_j))(jax.tree.map(jnp.asarray, tree))

    model = seeded_model(cfg, 0).train()
    loss_fn = make_cld_loss_fn(CLD.from_config(cfg), train=True)
    loss = loss_fn(model, torch.from_numpy(images), torch.Generator().manual_seed(0),
                   t=torch.from_numpy(t), z=torch.from_numpy(z))
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


def test_every_trainable_parameter_gets_a_gradient():
    """The training model with dropout and the kernel path's wrappers (K6's
    autograd.Function, K1, K8; plain on CPU tensors) leaves no trainable
    parameter without a nonzero gradient: no kernel output is detached."""
    cfg = small(train_config("cld/accr_dcifar10"))
    cfg.model.dropout = 0.1
    model = seeded_model(cfg, 0).train()
    assert model.fused
    images, t, z = _inputs(2)
    loss_fn = make_cld_loss_fn(CLD.from_config(cfg), train=True)
    loss_fn(model, torch.from_numpy(images), torch.Generator().manual_seed(0),
            t=torch.from_numpy(t), z=torch.from_numpy(z)).backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and p.grad.abs().max() > 0, name
        else:
            assert name == "fourier.weight" and p.grad is None


def test_kernel_path_and_plain_path_agree_with_dropout():
    """model.fused on and off (the comparison chip_smoke.py makes on the
    card) draw the same dropout masks from the same generator and give the
    same loss and gradients; on CPU tensors the kernel path's wrappers run
    their plain versions, so this holds the autograd.Function wiring (K6
    saving only its inputs, K7 recomputing from them) against plain autograd."""
    cfg = small(train_config("cld/accr_dcifar10"))
    cfg.model.dropout = 0.1
    model = seeded_model(cfg, 0).train()
    images, t, z = _inputs(3)
    loss_fn = make_cld_loss_fn(CLD.from_config(cfg), train=True)
    runs = []
    for fused in (True, False):
        model.fused = fused
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, torch.from_numpy(images), torch.Generator().manual_seed(4),
                       t=torch.from_numpy(t), z=torch.from_numpy(z))
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                   if p.requires_grad}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert rel_err(loss_k, loss_p) <= OPT_REL
    largest = max(g.abs().max().item() for g in grads_p.values())
    for name, want in grads_p.items():
        floor = LEAF_FLOOR * largest if name.endswith(".k.bias") else 0.0
        assert rel_err(grads_k[name], want, floor) <= MODEL_REL, name


class _Linear(torch.nn.Module):
    """loss = sum(a * ga) + sum(b * gb): its gradient is the batch itself."""

    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, g):
        return (self.a * g[:12].reshape(4, 3)).sum() + (self.b * g[12:]).sum()


def test_optimizer_steps_match_jax_train_step():
    """Three steps with the same gradients: the lr = 0 first step, the
    warmup, the global-norm clip (steps 1 and 3 clip, step 2 does not) and
    the EMA, against the JAX package's make_train_step."""
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((3, 17)).astype(np.float32)
    grads[1] *= 0.05  # norm < 1: no clipping on the second step
    assert np.linalg.norm(grads[0]) > 1 and np.linalg.norm(grads[1]) < 1

    jcfg = jax_get_config("cld/accr_dcifar10")
    jcfg.optim.lr, jcfg.optim.warmup, jcfg.model.ema_rate = 0.1, 2, 0.9

    def jloss(rng_, params, states, batch):
        loss = jnp.sum(params["a"] * batch["g"][:12].reshape(4, 3)) + jnp.sum(
            params["b"] * batch["g"][12:])
        return loss, ({"score_loss": loss}, states)

    jstate = j_state.create_train_state(jax.random.PRNGKey(0), jcfg,
                                        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, {})
    jstate, _ = j_step.make_train_step(jcfg, jloss)(jstate, {"g": jnp.asarray(grads)})

    cfg = train_config("cld/accr_dcifar10")
    cfg.optim.lr, cfg.optim.warmup, cfg.model.ema_rate = 0.1, 2, 0.9
    model = _Linear(a, b)

    def loss(m, g, generator):
        return m(g)

    state = t_state.create_train_state(cfg, model, torch.Generator())
    info = t_step.make_train_step(loss)(state, torch.from_numpy(grads))
    assert state.step == state.count == 3
    assert rel_err(info["grad_norm"], np.linalg.norm(grads[2])) <= OPT_REL
    for name in ("a", "b"):
        assert rel_err(getattr(model, name).detach(), jstate.params[name]) <= OPT_REL, name
        assert rel_err(state.ema[name], jstate.params_ema[name]) <= OPT_REL, name
    assert not np.allclose(model.a.detach().numpy(), a)  # the later steps moved it
    g0 = torch.from_numpy(grads[0])
    eval_loss = t_step.make_eval_step(loss)(state, g0, None)
    assert torch.allclose(eval_loss, (state.ema["a"] * g0[:12].reshape(4, 3)).sum()
                          + (state.ema["b"] * g0[12:]).sum())
    t_state.swap_params_from_ema(state)
    assert state.count == 0 and torch.equal(model.a.detach(), state.ema["a"])


def test_cli_train_writes_weights_that_sampling_reads(tmp_path):
    small_cfg = ["--set", "model.nf=32", "--set", "model.ch_mult=(1,2)", "--set",
                 "model.num_res_blocks=1", "--set", "data.image_size=16"]
    cli.main(["--mode", "train", "--device", "cpu", "--steps", "3", "--batch", "2", "--out",
              str(tmp_path / "run"), "--set", "training.n_jitted_steps=2", *small_cfg])
    params = torch.load(tmp_path / "run" / "params.pt", weights_only=True)
    ema = torch.load(tmp_path / "run" / "ema.pt", weights_only=True)
    assert set(params) == set(ema) and all(torch.isfinite(v).all() for v in ema.values())
    cli.main(["--mode", "sampling", "--device", "cpu", "--batch", "2", "--out",
              str(tmp_path / "smp"), "--weights", str(tmp_path / "run" / "ema.pt"),
              "--set", "sampling.nfe=6", *small_cfg])
    with np.load(tmp_path / "smp" / "samples_0.npz") as f:
        assert f["samples"].shape == (2, 16, 16, 3)
