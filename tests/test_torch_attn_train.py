"""K10, the attention block of a training step (K5's forward on the f32
activations, the plain composition's VJP), against the JAX package's
``make_fused_attnblock_train`` on the CPU, a training step of a small network
with the setting on and off, and the CLI's train mode with it. Cases marked
``cuda`` hold the kernel forward and the gradients against the plain
composition on the card and skip without one."""

import types

import numpy as np
import pytest
import torch

from gddim_torch import cli
from gddim_torch.configs import train_config
from gddim_torch.math.cld import CLD
from gddim_torch.models.init import seeded_model
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.train.losses import make_cld_loss_fn

# f32 on both sides (off the TPU the JAX function is the plain composition
# both ways); only summation order differs
REL = 1e-5
# The attention key bias's exact gradient is zero (softmax ignores a constant
# added to every logit of a row). Against JAX both sides' are rounding noise,
# measured 3e-8 to 6e-8 of the largest gradient: each is held under
# KEY_BIAS_NOISE of it. Between two port paths its error is measured against
# LEAF_FLOOR of the largest gradient, as tests/test_torch_train.py does.
KEY_BIAS_NOISE = 1e-6
LEAF_FLOOR = 1e-3
NAMES = ["x", "gn_scale", "gn_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]


def rel_err(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), floor)


def attn_args(seed, b, h, c):
    rng = np.random.default_rng(seed)
    args = [rng.standard_normal((b, h, h, c)).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32)]
    for _ in range(4):
        args += [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
                 (0.1 * rng.standard_normal(c)).astype(np.float32)]
    return args, rng.standard_normal((b, h, h, c)).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import attnblock

    return types.SimpleNamespace(jax=jax, jnp=jnp, attn=attnblock)


@pytest.mark.parametrize("h", [4, 8], ids=["S16", "S64"])
def test_attnblock_train_matches_jax(jx, h):
    """The value and the gradients of all 11 inputs, C=128, f32: measured
    up to 6.7e-7 (the key bias's apart, see KEY_BIAS_NOISE)."""
    args, g = attn_args(0, 2, h, 128)
    kw = dict(num_groups=32, skip_rescale=True)
    f = jx.attn.make_fused_attnblock_train(**kw)
    want, vjp = jx.jax.vjp(f, *map(jx.jnp.asarray, args))
    want_grads = vjp(jx.jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = t_attn.fused_attnblock_train(*ts, **kw)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert rel_err(got.detach(), want) <= REL
    largest = max(float(np.abs(w).max()) for w in want_grads)
    for name, t, w in zip(NAMES, ts, want_grads):
        if name == "bk":
            noise = max(t.grad.abs().max().item(), float(np.abs(w).max()))
            assert noise <= KEY_BIAS_NOISE * largest
        else:
            assert rel_err(t.grad, w) <= REL, name
    assert t_attn.fused_attnblock_train.launches == 0  # CPU tensors never launch


def test_attnblock_train_gradients_only_where_needed():
    """Inputs that do not require a gradient get none; the others get
    autograd's of the plain composition."""
    args, g = attn_args(1, 1, 4, 64)
    ts = [torch.from_numpy(a) for a in args]
    ts[0].requires_grad_(True)
    ts[9].requires_grad_(True)
    t_attn.fused_attnblock_train(*ts, num_groups=16).backward(torch.from_numpy(g))
    ref = [torch.from_numpy(a).requires_grad_(i in (0, 9)) for i, a in enumerate(args)]
    t_attn.attnblock_reference(*ref, num_groups=16).backward(torch.from_numpy(g))
    for i, (t, r) in enumerate(zip(ts, ref)):
        if i in (0, 9):
            assert rel_err(t.grad, r.grad) <= REL
        else:
            assert t.grad is None


def small(cfg):
    """The accr structure at nf=64 (attention at 16x16 on 64 channels, which
    K10's gate refuses, and on 128 in the middle, which it takes), ch_mult
    (1, 2), one block per level, 16x16, dropout 0.1, f32."""
    cfg.model.nf = 64
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.model.dropout = 0.1
    cfg.data.image_size = 16
    return cfg


def test_train_step_with_k10_matches_without(monkeypatch):
    """training.fused_attn on and off: the same loss and gradients (on CPU
    tensors both are the plain composition), and with it on every attention
    block K10's gate takes (the block GEMM's 128-channel tiles: the middle
    one, not the 64-channel ones at 16x16) goes through K10."""
    calls = []
    real = t_attn.fused_attnblock_train
    monkeypatch.setattr(t_attn, "fused_attnblock_train",
                        lambda *a, **k: (calls.append(a[0].shape), real(*a, **k))[1])
    cfg = small(train_config("cld/accr_dcifar10"))
    model = seeded_model(cfg, 0).train()
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(1e-5, 1.0, 2).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32))
    loss_fn = make_cld_loss_fn(CLD.from_config(cfg), train=True)
    runs = []
    for on in (True, False):
        model.fused_attn = on
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, images, torch.Generator().manual_seed(4), t=t, z=z)
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                   if p.requires_grad}))
    assert [tuple(s) for s in calls] == [(2, 8, 8, 128)]
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert rel_err(loss_k, loss_p) <= REL
    largest = max(g.abs().max().item() for g in grads_p.values())
    for name, want in grads_p.items():
        floor = LEAF_FLOOR * largest if name.endswith(".k.bias") else 0.0
        assert rel_err(grads_k[name], want, floor) <= REL, name


def test_cli_train_with_fused_attn(tmp_path):
    cli.main(["--mode", "train", "--device", "cpu", "--steps", "2", "--batch", "2", "--out",
              str(tmp_path / "run"), "--set", "training.n_jitted_steps=2", "--set",
              "training.fused_attn=true", "--set", "model.nf=64", "--set", "model.ch_mult=(1,2)",
              "--set", "model.num_res_blocks=1", "--set", "data.image_size=16"])
    ema = torch.load(tmp_path / "run" / "ema.pt", weights_only=True)
    assert all(torch.isfinite(v).all() for v in ema.values())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

# K10's forward is K5 on f32 activations (bf16 MMA operands, f32 residual):
# K5's bound. Its gradients are autograd's of the plain composition on the
# same inputs: f32 sums in another order only.
FORWARD_BOUND = 1e-2
GRAD_BOUND = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(4, 16), (4, 4)])
def test_attnblock_train_kernel_matches_plain(b, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, g = attn_args(2, b, h, 256)
    kw = dict(num_groups=32, skip_rescale=True)
    ts = [torch.from_numpy(a).cuda().requires_grad_(True) for a in args]
    ref = [torch.from_numpy(a).cuda().requires_grad_(True) for a in args]
    before = t_attn.fused_attnblock_train.launches
    out = t_attn.fused_attnblock_train(*ts, **kw)
    want = t_attn.attnblock_reference(*ref, **kw)
    gt = torch.from_numpy(g).cuda()
    out.backward(gt)
    want.backward(gt)
    assert t_attn.fused_attnblock_train.launches == before + 1
    assert out.dtype == torch.float32
    assert rel_err(out.detach().cpu(), want.detach().cpu()) <= FORWARD_BOUND
    largest = max(r.grad.abs().max().item() for r in ref)
    for name, t, r in zip(NAMES, ts, ref):
        floor = LEAF_FLOOR * largest if name == "bk" else 0.0
        assert rel_err(t.grad.cpu(), r.grad.cpu(), floor) <= GRAD_BOUND, name
