"""Blur-diffusion training in the port against the JAX package, in f32 on the
CPU: the forward process (``perturb_data``) and ``sample_t``, the blur loss
with every parameter's gradient on the small network (the JAX package's
t, z draws fed in), the ``model.fused_train`` switch, and the CLI's blur
train mode writing weights that its sampling reads."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import cli, convert
from gddim_torch.configs import get_config, train_config
from gddim_torch.math.blur import BlurSDE
from gddim_torch.models import layers as t_layers
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.ops import resblock as rb
from gddim_torch.train.losses import make_blur_loss_fn, make_loss_fn
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math import blur as j_blur
from gddim_tpu.models import get_model
from gddim_tpu.models import layers as j_layers
from gddim_tpu.train.losses import make_blur_loss_fn as jax_make_blur_loss_fn

# the forward process: the same f32 DCT products and per-frequency scales;
# measured 3.2e-8 (x_t) and 1.2e-7 (mean) here
PERTURB_REL = 1e-6
# the loss and each gradient tensor of the small network (f32, the plain
# composition on both sides), as tests/test_torch_train.py holds the CLD
# loss; measured 9.3e-8 (the loss) and up to 6.8e-6 (a gradient tensor) here
MODEL_REL = 1e-4
# the attention key bias's exact gradient is zero, so its tensor is rounding
# noise: measured against LEAF_FLOOR of the largest gradient (as in
# tests/test_torch_train.py)
LEAF_FLOOR = 1e-3
# fused_train on and off, the same dropout masks: the K6/K7 wrappers run
# their plain versions on CPU tensors; measured 0 (loss) and up to 5.6e-7
# (a gradient tensor) here
SWITCH_REL = 1e-5


def rel_err(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), floor)
    return np.abs(got - want).max() / scale if scale else np.abs(got).max()


def small(cfg, nf=32, dropout=0.0):
    cfg.model.nf = nf
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.model.dropout = dropout
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
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


@pytest.fixture(autouse=True)
def _restore_jax_conv_selector(monkeypatch):
    monkeypatch.setattr(j_layers, "CONV3X3_IMPL", j_layers.CONV3X3_IMPL)


def _jax_draws(key, shape):
    """The t and z the JAX package's blur loss draws from ``key``
    (gddim_tpu/train/losses.py:61-65)."""
    jsde = j_blur.BlurSDE(img_dim=shape[1])
    key, t_key = jax.random.split(key)
    t = jsde.sample_t((shape[0],), t_key)
    key, z_key = jax.random.split(key)
    z = jax.random.normal(z_key, shape)
    return np.array(t), np.array(z)


def test_perturb_data_matches_jax():
    sde = BlurSDE(img_dim=16)
    jsde = j_blur.BlurSDE(img_dim=16)
    rng = np.random.default_rng(80)
    batch = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    t = np.array([1e-5, 0.1, 0.5, 0.97], np.float32)
    key = jax.random.PRNGKey(3)
    want, jmean, jz = jsde.perturb_data(jnp.asarray(batch), jnp.asarray(t), key)
    z = torch.from_numpy(np.array(jax.random.normal(key, batch.shape)))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))  # the draw perturb_data makes
    got, mean, z_out = sde.perturb_data(torch.from_numpy(batch), torch.from_numpy(t), z=z)
    assert z_out is z
    assert rel_err(got, want) <= PERTURB_REL and rel_err(mean, jmean) <= PERTURB_REL
    # the noise comes from the generator when not given
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a, _, za = sde.perturb_data(torch.from_numpy(batch), torch.from_numpy(t), g1)
    b, _, zb = sde.perturb_data(torch.from_numpy(batch), torch.from_numpy(t), g2)
    assert torch.equal(a, b) and torch.equal(za, zb) and za.shape == batch.shape


def test_sample_t_range_and_generator():
    """t ~ U(1e-5, T) as the JAX package's uniform(minval=1e-5, maxval=T):
    the affine map of the generator's uniforms."""
    sde = BlurSDE()
    t = sde.sample_t((4096,), torch.Generator().manual_seed(1))
    u = torch.rand((4096,), generator=torch.Generator().manual_seed(1))
    assert t.shape == (4096,) and t.dtype == torch.float32
    assert torch.equal(t, 1e-5 + (1.0 - 1e-5) * u)
    assert t.min() >= 1e-5 and t.max() < 1.0 and abs(t.mean().item() - 0.5) < 0.02
    jt = np.asarray(j_blur.BlurSDE().sample_t((4096,), jax.random.PRNGKey(1)))
    assert jt.min() >= 1e-5 and jt.max() < 1.0 and abs(jt.mean() - 0.5) < 0.02


def _recording_dropout(masks):
    """A flax method interceptor that runs each nn.Dropout as flax does
    (its own make_rng, bernoulli(keep), select(mask, x / keep, 0)) and
    appends the mask it drew to ``masks``."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, flax.linen.Dropout) or context.method_name != "__call__"
                or mod.rate == 0.0):
            return next_fun(*args, **kwargs)
        (x,) = args
        assert kwargs == {"deterministic": False}
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection), keep, x.shape)
        masks.append(mask)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    return interceptor


def _blur_loss_against_jax(monkeypatch, dropout):
    """make_blur_loss_fn on the small network at ``dropout`` with the JAX
    loss's own t, z and dropout masks, against jax.value_and_grad of the
    JAX package's make_blur_loss_fn: the loss and the gradient of every
    parameter, each held at MODEL_REL. Returns the masks fed in."""
    cfg = small(train_config("blur/ddpm_deep_cifar10"), dropout=dropout)
    jcfg = small(jax_get_config("blur/ddpm_deep_cifar10"), dropout=dropout)
    tree = seeded_params(cfg, 0)
    images = np.random.default_rng(81).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jloss = jax_make_blur_loss_fn(j_blur.from_config(jcfg), get_model("ncsnpp")(config=jcfg),
                                  train=True)

    def loss_j(params):
        masks = []
        with flax.linen.intercept_methods(_recording_dropout(masks)):
            loss = jloss(key, params, {}, {"image": jnp.asarray(images)})[0]
        return loss, masks

    (want_loss, masks), want_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    t, z = _jax_draws(key, images.shape)

    # the port draws each block's mask with torch.bernoulli, in the order the
    # blocks run: hand it the JAX masks in that order instead
    queue = [np.array(m) for m in masks]

    def jax_mask(probs, generator=None):
        m = queue.pop(0)
        assert m.shape == tuple(probs.shape)
        return torch.from_numpy(m).to(probs.dtype)

    monkeypatch.setattr(torch, "bernoulli", jax_mask)
    model = seeded_model(cfg, 0).train()
    loss = make_blur_loss_fn(BlurSDE.from_config(cfg), train=True)(
        model, torch.from_numpy(images), torch.Generator().manual_seed(0),
        t=torch.from_numpy(t), z=torch.from_numpy(z))
    assert not queue  # one JAX mask for each of the port's dropout sites
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
    return masks


def test_blur_loss_and_gradients_match_jax(monkeypatch):
    """The blur loss and every gradient against the JAX package's, without
    dropout (the small config's)."""
    assert _blur_loss_against_jax(monkeypatch, 0.0) == []


def test_blur_loss_and_gradients_match_jax_with_dropout(monkeypatch):
    """The same at dropout 0.1, the port fed the JAX network's own dropout
    masks (one per residual block; about a tenth of them zeros)."""
    masks = _blur_loss_against_jax(monkeypatch, 0.1)
    assert len(masks) == len(seeded_model(small(train_config("blur/ddpm_deep_cifar10")),
                                          0).res_blocks)
    drop = 1.0 - np.mean([np.asarray(m).mean() for m in masks])
    assert 0.05 < drop < 0.15


def test_fused_train_defaults_and_switch(monkeypatch):
    """model.fused_train: JAX's default per family (CLD on, blur off), and
    on the network at nf=128 (where train_supported takes the stride-1
    blocks) it sends them through K6/K7's wrapper or their unfused layers
    with K1's wrapper for the GroupNorms, with the same loss and gradients
    (plain versions here)."""
    assert get_config("cld/accr_dcifar10").model.fused_train is True
    assert get_config("blur/ddpm_deep_cifar10").model.fused_train is False
    assert jax_get_config("blur/ddpm_deep_cifar10").model.fused_train is False
    cfg = small(train_config("blur/ddpm_deep_cifar10"), nf=128, dropout=0.1)
    model = seeded_model(cfg, 0).train()
    assert model.fused and not model.fused_train
    calls, k1 = [], []
    wrapper, gn = rb.fused_resblock_train, t_layers.group_norm_silu
    monkeypatch.setattr(rb, "fused_resblock_train",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    monkeypatch.setattr(t_layers, "group_norm_silu", lambda *a, **k: k1.append(1) or gn(*a, **k))
    images = np.random.default_rng(82).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    t, z = _jax_draws(jax.random.PRNGKey(5), images.shape)
    loss_fn = make_loss_fn(cfg, train=True)
    runs = {}
    for switch in (False, True):
        model.fused_train = switch
        calls.clear()
        k1.clear()
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, torch.from_numpy(images), torch.Generator().manual_seed(6),
                       t=torch.from_numpy(t), z=torch.from_numpy(z))
        loss.backward()
        runs[switch] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.grad is not None}, len(calls), len(k1))
    assert runs[False][2] == 0 and runs[True][2] > 0
    # off: the unfused layers run K1 (its wrapper) for GN1 and GN2 of each
    # block that K6/K7 take when on, as the JAX package's unfused layers do
    assert runs[False][3] == runs[True][3] + 2 * runs[True][2]
    assert rel_err(runs[True][0], runs[False][0]) <= SWITCH_REL
    largest = max(g.abs().max().item() for g in runs[False][1].values())
    for name, want in runs[False][1].items():
        floor = LEAF_FLOOR * largest if name.endswith(".k.bias") else 0.0
        assert rel_err(runs[True][1][name], want, floor) <= SWITCH_REL, name


def test_cli_blur_train_writes_weights_that_sampling_reads(tmp_path):
    small_cfg = ["--set", "model.nf=32", "--set", "model.ch_mult=(1,2)", "--set",
                 "model.num_res_blocks=1", "--set", "data.image_size=16"]
    cli.main(["--config", "blur/ddpm_deep_cifar10", "--mode", "train", "--device", "cpu",
              "--steps", "3", "--batch", "2", "--out", str(tmp_path / "run"), "--set",
              "training.n_jitted_steps=2", "--set", "model.fused_train=true", *small_cfg])
    params = torch.load(tmp_path / "run" / "params.pt", weights_only=True)
    ema = torch.load(tmp_path / "run" / "ema.pt", weights_only=True)
    assert set(params) == set(ema) and all(torch.isfinite(v).all() for v in ema.values())
    assert params["conv_in.weight"].shape[2] == 3  # a 3-channel trunk (HWIO)
    cli.main(["--config", "blur/ddpm_deep_cifar10", "--mode", "sampling", "--device", "cpu",
              "--batch", "2", "--out", str(tmp_path / "smp"), "--weights",
              str(tmp_path / "run" / "ema.pt"), "--set", "sampling.method=deis", "--set",
              "sampling.nfe=3", *small_cfg])
    with np.load(tmp_path / "smp" / "samples_0.npz") as f:
        assert f["samples"].shape == (2, 16, 16, 3) and int(f["nfe"]) == 3
