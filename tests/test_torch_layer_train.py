"""The layer-wise paths on f32 activations and in training, on the CPU,
against the JAX package:

(a) K11's ``autograd.Function`` (``ops/conv3x3.py:conv3x3_pallas``, the
    plain version forward on CPU tensors): output and the gradients of x
    and w against ``jax.vjp`` of ``gddim_tpu.ops.conv3x3.conv3x3_xla``;
(b) the CUDA wrappers' C calls (``_build.launch`` replaced) on f32
    activations: K11 through the cast pre-pass with its f32 store, K11 int8
    with ``out_dtype`` f32 (the fault the card showed: both raised);
(c) a small NCSN++ training step with ``conv_impl='pallas'`` (nf 128 so
    that K11's gate takes the convs, ch_mult (1, 2), one block a level,
    8x8, f32, dropout 0, ``fused_train`` off so that every block runs its
    layers): loss and every parameter's gradient against the JAX package's
    step at ``conv_impl='pallas'`` (whose gate refuses a CPU backend: XLA's
    conv there, the port's plain versions here), BigGAN and DDPM blocks;
(d) ``model.remat``'s four modes: the same loss and gradients as remat
    off, with dropout, and the same ``state_dict`` keys;
(e) AdamW: five steps against ``optax.adamw`` after ``clip_by_global_norm``
    (the JAX package's ``make_train_step`` at ``weight_decay > 0``);
(f) f32 sampling through the layer-wise 'pallas' and 'int8' paths on the
    CPU: 'pallas' against the JAX eps, 'int8' (its int8 plain versions)
    within the card's int8 bound of the f32 plain path, and the CLI.
"""

import ctypes

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import _build, cli, convert
from gddim_torch.configs import get_config, train_config
from gddim_torch.math.cld import CLD
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.ops import conv3x3 as t_c3
from gddim_torch.ops import resblock as t_rb
from gddim_torch.train import state as t_state
from gddim_torch.train import step as t_step
from gddim_torch.train.losses import make_cld_loss_fn
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.math.linalg2 import bmm as jax_bmm
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.ops.conv3x3 import conv3x3_xla
from gddim_tpu.train import state as j_state
from gddim_tpu.train import step as j_step

# (a) f32 convs in two frameworks: sums in another order
CONV_REL = 1e-5
# (c) the whole network's loss and gradients, f32 in both
MODEL_REL = 1e-5
# (c) DDPM++'s positional time embedding: sin and cos of labels up to 999 t
# (hundreds of radians), where XLA's and PyTorch's f32 sin/cos differ by up
# to 1.5e-5 of the embedding (measured at this test's labels); the first
# temb Dense's gradient carries that
POSITIONAL_REL = 5e-5
# (c) the attention key bias's exact gradient is zero (softmax ignores a
# constant added to a row's logits): its leaf is rounding noise, measured
# against this share of the largest gradient (as tests/test_torch_train.py)
LEAF_FLOOR = 1e-3
# (d) remat recomputes the same operations: the gradients agree to f32
# rounding (they are bit for bit the same on the CPU)
REMAT_REL = 1e-6
# (e) the optimizer's arithmetic in f32 in both
OPT_REL = 1e-6
# (f) the int8 path against the f32 plain path: chip_smoke.py's
# EPS_LAYER_BOUND["int8_vs_f32"]
INT8_VS_F32 = 0.1


def rel_err(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), floor)
    return np.abs(got - want).max() / scale if scale else np.abs(got).max()


# --------------------------------------------------------------------------
# (a) K11's Function against jax.vjp of conv3x3_xla
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,cin,cout", [(2, 8, 128, 128), (1, 4, 256, 128), (2, 16, 128, 256)])
def test_k11_function_gradients_match_jax_vjp(b, h, cin, cout):
    rng = np.random.default_rng(cin + h)
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.standard_normal((b, h, h, cout)).astype(np.float32)
    want, vjp = jax.vjp(conv3x3_xla, jnp.asarray(x), jnp.asarray(w))
    wx, ww = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = t_c3.conv3x3_pallas(xt, wt)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("_Conv3x3Pallas")
    out.backward(torch.from_numpy(g))
    assert rel_err(out.detach(), want) <= CONV_REL
    assert rel_err(xt.grad, wx) <= CONV_REL
    assert rel_err(wt.grad, ww) <= CONV_REL
    with torch.no_grad():  # autograd off: no Function
        assert t_c3.conv3x3_pallas(xt, wt).grad_fn is None


def test_k11_bf16_rounding_point_reference():
    """The card's f32 form rounds x and w to bf16 and stores the f32 sums;
    on bf16 operands the reference is the plain one."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 128, 128)) / 34).astype(np.float32))
    got = t_c3.conv3x3_bf16_reference(x, w)
    want = t_c3.conv3x3_reference(x.bfloat16().float(), w.bfloat16().float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    xb, wb = x.bfloat16(), w.bfloat16()
    assert torch.equal(t_c3.conv3x3_bf16_reference(xb, wb), t_c3.conv3x3_reference(xb, wb))


# --------------------------------------------------------------------------
# (b) the C calls on f32 activations
# --------------------------------------------------------------------------


@pytest.fixture
def glue(monkeypatch):
    """K11's wrappers on CPU tensors with ``_build.launch`` replaced by a
    recorder, each call's arguments checked against its signature."""
    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    calls = []

    def launch(name, device, *args):
        sig = [kinds[t] for t in _build._SIGNATURES[name]]
        assert len(args) + 1 == len(sig), (name, len(args) + 1, len(sig))
        for k, v in zip(sig, args):
            assert (v is None or isinstance(v, int)) if k == "P" else \
                isinstance(v, float if k == "F" else int), (name, k, v)
        calls.append((name, args))

    def operand(t, what, dtype, shape=None):
        t = None if t is None else t.to(dtype).contiguous()
        assert t is None or shape is None or tuple(t.shape) == tuple(shape), what
        return t

    for mod in (t_rb, t_c3):
        monkeypatch.setattr(mod, "_on_cpu", lambda x, what: False)
        monkeypatch.setattr(mod, "_operand", operand)
    for fn in (t_c3.conv3x3_pallas, t_c3.conv3x3_pallas_int8):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "launch", launch)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k11_wrapper_on_f32_and_bf16_activations(glue, dtype):
    """f32 x: the cast pre-pass (``gddim_bf16_prepass``, no affine), then
    the kernel with its f32 store (out_f32 1) into an f32 output; bf16 x:
    the kernel alone, bf16 store. w is bf16 on the card either way."""
    x = torch.randn((4, 16, 16, 256), dtype=dtype)
    w = torch.randn((3, 3, 256, 128))
    with torch.no_grad():
        out = t_c3.conv3x3_pallas(x, w)
    assert out.dtype == dtype and out.shape == (4, 16, 16, 128)
    names = [name for name, _ in glue]
    f32 = dtype == torch.float32
    assert names == (["gddim_bf16_prepass"] if f32 else []) + ["gddim_conv3x3"]
    args = glue[-1][1]
    plan = t_c3.tile_plan(4, 16, 16, 256, 128)
    assert args[2:14] == (4, 16, 16, 256, 128, plan.mw, plan.box_h, plan.box_b, plan.tiles_h,
                          plan.m_tiles, plan.splits, plan.kper)
    assert args[14] == int(f32)
    if f32:
        pre = glue[0][1]
        assert pre[2:5] == (256, 0, 1) and pre[7:9] == (None, None)  # f32 x, no affine
    with pytest.raises(ValueError):
        t_c3.conv3x3_pallas(x.half(), w)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k11_int8_wrapper_stores_out_dtype(glue, out_dtype):
    x8 = torch.randint(-127, 128, (4, 8, 8, 256), dtype=torch.int8)
    w8 = torch.randint(-127, 128, (3, 3, 256, 256), dtype=torch.int8)
    out = t_c3.conv3x3_pallas_int8(x8, w8, torch.full((256,), 1e-3), torch.full((4,), 1e-2),
                                   torch.zeros(256), out_dtype=out_dtype)
    assert out.dtype == out_dtype
    (name, args), = glue
    assert name == "gddim_conv3x3_int8" and args[17] == int(out_dtype == torch.float32)
    with pytest.raises(ValueError):
        t_c3.conv3x3_pallas_int8(x8, w8, torch.ones(256), torch.ones(4), out_dtype=torch.half)


# --------------------------------------------------------------------------
# (c) a training step under conv_impl='pallas' against JAX's
# --------------------------------------------------------------------------


def small(cfg, impl="pallas", resblock_type=None):
    cfg.model.resblock_type = resblock_type or cfg.model.resblock_type
    cfg.model.nf = 128
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (4,)
    cfg.model.dropout = 0.0
    cfg.model.conv_impl = impl
    cfg.model.fused_train = False
    cfg.data.image_size = 8
    cfg.model.dtype = "float32"
    return cfg


def _inputs(seed, b=2, size=8):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, b).astype(np.float32)
    z = rng.standard_normal((b, size, size, 3, 2)).astype(np.float32)
    return images, t, z


def _port_step(model, cfg, images, t, z, seed=0):
    model.zero_grad(set_to_none=True)
    loss = make_cld_loss_fn(CLD.from_config(cfg), train=True)(
        model, torch.from_numpy(images), torch.Generator().manual_seed(seed),
        t=torch.from_numpy(t), z=torch.from_numpy(z))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}


# the accr trunk (BigGAN blocks, FIR transitions), and DDPM++ with DDPM
# blocks (a NIN skip, the Upsample's nearest resize and 3x3 conv)
NETS = [("cld/accr_dcifar10", None), ("cld/ddpmpp_cifar10", "ddpm")]


@pytest.mark.parametrize("name,blocks", NETS)
def test_pallas_training_step_matches_jax(name, blocks, monkeypatch):
    """K11's Function in every block conv (and the DDPM Upsample's) on the
    port's side, counted; JAX's step at conv_impl='pallas'."""
    cfg = small(train_config(name), resblock_type=blocks)
    jcfg = small(jax_get_config(name), resblock_type=blocks)
    tree = seeded_params(cfg, 0)
    images, t, z = _inputs(1)
    jsde = JaxCLD.from_config(jcfg)
    eps_j = jax_make_cld_eps_fn(jsde, get_model("ncsnpp")(config=jcfg), train=True)

    def loss_j(params):
        data = jnp.stack([jnp.asarray(images), jnp.zeros_like(images)], -1)
        tj, zj = jnp.asarray(t), jnp.asarray(z)
        perturbed = jsde.mean(data, tj) + jax_bmm(jsde.R(tj), zj)
        eps, _ = eps_j({"params": params}, perturbed, tj, rng=jax.random.PRNGKey(0))
        return jnp.square(eps - zj).reshape(2, -1).mean(-1).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_j))(jax.tree.map(jnp.asarray, tree))
    tol = MODEL_REL if cfg.model.embedding_type == "fourier" else POSITIONAL_REL

    applied = []
    real = t_c3._Conv3x3Pallas.apply
    monkeypatch.setattr(t_c3._Conv3x3Pallas, "apply",
                        staticmethod(lambda *a: applied.append(a[0].shape) or real(*a)))
    model = seeded_model(cfg, 0).train()
    loss, _ = _port_step(model, cfg, images, t, z)
    # every width is a multiple of 128: conv1 and conv2 of all 10 BigGAN
    # blocks (the two transitions too); of the 8 DDPM blocks, and the DDPM
    # Upsample's conv (the stride-2 Downsample conv stays plain)
    assert len(applied) == (20 if blocks is None else 17), len(applied)
    assert rel_err(loss, want_loss) <= MODEL_REL
    got = convert.grads_to_flax(model)
    leaves = jax.tree_util.tree_flatten_with_path(flax.core.unfreeze(want_grads))[0]
    largest = max(float(np.abs(w).max()) for _, w in leaves)
    for path, w in leaves:
        node = got
        for k in path:
            node = node[k.key]
        key = jax.tree_util.keystr(path)
        key_bias = key.startswith("['AttnBlockpp") and key.endswith("['NIN_1']['b']")
        assert rel_err(node, w, LEAF_FLOOR * largest if key_bias else 0.0) <= tol, key


# --------------------------------------------------------------------------
# (d) remat
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,blocks", NETS)
@pytest.mark.parametrize("remat", [True, "convs", "convs_lean"])
def test_remat_modes_match_remat_off(name, blocks, remat):
    """With dropout 0.1 (the masks drawn before each recomputed region) and
    the layer-wise 'pallas' convs: the same loss and gradients as remat
    off, and the same state_dict keys as a model built with it off."""
    cfg = small(train_config(name), resblock_type=blocks)
    cfg.model.dropout = 0.1
    images, t, z = _inputs(2)
    model = seeded_model(cfg, 0).train()
    loss0, grads0 = _port_step(model, cfg, images, t, z, seed=5)
    cfg.model.remat = remat
    remat_model = seeded_model(cfg, 0).train()
    assert remat_model.remat == remat
    assert list(remat_model.state_dict()) == list(model.state_dict())
    loss, grads = _port_step(remat_model, cfg, images, t, z, seed=5)
    assert rel_err(loss, loss0) <= REMAT_REL
    assert set(grads) == set(grads0)
    largest = max(g.abs().max().item() for g in grads0.values())
    for n, g in grads0.items():
        floor = LEAF_FLOOR * largest if n.endswith(".k.bias") else 0.0
        assert rel_err(grads[n], g, floor) <= REMAT_REL, n


def test_remat_values_are_checked():
    cfg = small(train_config("cld/accr_dcifar10"))
    cfg.model.nf = 32
    for bad in ("all", 1, None):
        cfg.model.remat = bad
        with pytest.raises(ValueError):
            seeded_model(cfg, 0)
    args = cli.parse_args(["--set", "model.remat=convs", "--set", "model.remat=True"])
    config = cli.make_config(args)
    assert config.model.remat is True


# --------------------------------------------------------------------------
# (e) AdamW
# --------------------------------------------------------------------------


class _Linear(torch.nn.Module):
    """loss = sum(a * ga) + sum(b * gb): its gradient is the batch itself."""

    def __init__(self, a, b):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, g):
        return (self.a * g[:12].reshape(4, 3)).sum() + (self.b * g[12:]).sum()


@pytest.mark.parametrize("weight_decay", [1e-2, 0.3])
def test_adamw_matches_optax(weight_decay):
    """Five steps: the lr = 0 first step and the warmup (the decay scaled
    with them), clipped and unclipped norms, the EMA."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((5, 17)).astype(np.float32)
    grads[1] *= 0.05
    grads[3] *= 0.1
    jcfg = jax_get_config("cld/accr_dcifar10")
    jcfg.optim.lr, jcfg.optim.warmup, jcfg.model.ema_rate = 0.1, 3, 0.9
    jcfg.optim.unlock()
    jcfg.optim["weight_decay"] = None  # the JAX file types it int (0)
    jcfg.optim.weight_decay = weight_decay

    def jloss(rng_, params, states, batch):
        loss = jnp.sum(params["a"] * batch["g"][:12].reshape(4, 3)) + jnp.sum(
            params["b"] * batch["g"][12:])
        return loss, ({"score_loss": loss}, states)

    jstate = j_state.create_train_state(jax.random.PRNGKey(0), jcfg,
                                        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, {})
    jstate, _ = j_step.make_train_step(jcfg, jloss)(jstate, {"g": jnp.asarray(grads)})

    cfg = train_config("cld/accr_dcifar10")
    cfg.optim.lr, cfg.optim.warmup, cfg.model.ema_rate = 0.1, 3, 0.9
    cfg.optim.weight_decay = weight_decay
    model = _Linear(a, b)
    state = t_state.create_train_state(cfg, model, torch.Generator())
    assert state.weight_decay == weight_decay
    t_step.make_train_step(lambda m, g, gen: m(g))(state, torch.from_numpy(grads))
    for name in ("a", "b"):
        assert rel_err(getattr(model, name).detach(), jstate.params[name]) <= OPT_REL, name
        assert rel_err(state.ema[name], jstate.params_ema[name]) <= OPT_REL, name
    # the decay moved the parameters beyond plain Adam's
    cfg.optim.weight_decay = 0.0
    plain = _Linear(a, b)
    t_step.make_train_step(lambda m, g, gen: m(g))(
        t_state.create_train_state(cfg, plain, torch.Generator()), torch.from_numpy(grads))
    assert not torch.allclose(plain.a, model.a)
    sd = state.state_dict()
    assert sd["weight_decay"] == weight_decay
    state.load_state_dict({k: v for k, v in sd.items() if k != "weight_decay"})
    assert state.weight_decay == 0.0  # a checkpoint of before AdamW


# --------------------------------------------------------------------------
# (f) f32 sampling through the layer-wise paths
# --------------------------------------------------------------------------


def test_f32_layerwise_eps_matches_jax_and_int8_stays_near():
    cfg = small(get_config("blur/ddpm_deep_cifar10"))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    labels = np.array([10.0, 700.0], np.float32)
    tree = seeded_params(cfg, 0)
    jcfg = small(jax_get_config("blur/ddpm_deep_cifar10"))
    jmodel = get_model("ncsnpp")(config=jcfg)
    want = np.asarray(jax.jit(lambda p: jmodel.apply(p, jnp.asarray(x), jnp.asarray(labels),
                                                     train=False))(
        {"params": jax.tree.map(jnp.asarray, tree)}))
    outs = {}
    for impl in ("pallas", "int8", "plain"):
        cfg.model.conv_impl = impl
        with torch.inference_mode():
            outs[impl] = seeded_model(cfg, 0)(torch.from_numpy(x), torch.from_numpy(labels))
        assert outs[impl].dtype == torch.float32
    assert rel_err(outs["pallas"], want) <= MODEL_REL
    assert rel_err(outs["plain"], want) <= MODEL_REL
    assert 0 < rel_err(outs["int8"], outs["plain"]) <= INT8_VS_F32


@pytest.mark.parametrize("impl", ["pallas", "int8"])
def test_cli_samples_f32_layerwise(tmp_path, impl):
    small_cfg = ["--set", "model.nf=128", "--set", "model.ch_mult=(1,2)", "--set",
                 "model.num_res_blocks=1", "--set", "data.image_size=8", "--set",
                 "sampling.nfe=3", "--set", "model.dtype=float32", "--set",
                 f"model.conv_impl={impl}"]
    cli.main(["--config", "cld/accr_dcifar10", "--mode", "sampling", "--device", "cpu",
              "--batch", "2", "--out", str(tmp_path / impl), *small_cfg])
    with np.load(tmp_path / impl / "samples_0.npz") as f:
        assert f["samples"].shape == (2, 8, 8, 3)
