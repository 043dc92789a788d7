"""The port's K1-K8 against the JAX package.

On the CPU the wrappers run their plain versions; these are held against the
JAX references (the unfused compositions the JAX kernel tests use as their
oracle, or the Pallas kernels in interpret mode) in f32 at rel <= 1e-5
(2e-5 for gradients, where autograd and jax.vjp order their sums
differently). Cases marked ``cuda`` hold each hand-written kernel against its
plain version on the card and skip without one; the JAX package is imported
only by the CPU cases, so the card's machine, which has no JAX, runs the
``cuda`` cases with ``pytest --noconftest -m cuda``.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch.ops import attention as t_att
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import groupnorm as t_gn
from gddim_torch.ops import resblock as t_rb
from gddim_torch.ops import resblock_bwd as t_rbw

REL = 1e-5  # f32 on both sides; only summation order differs
REL_GRAD = 2e-5  # gradients: longer sums (over pixels and the batch) in other orders
TEMB = 16
GRAD_NAMES = ["dx", "dtemb", "dgn1s", "dgn1b", "dw1", "db1", "dgn2s", "dgn2b", "dw2", "db2",
              "dwsk", "dbsk"]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


class Draw:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def act(self, *shape):
        return self.rng.standard_normal(shape).astype(np.float32)

    def w(self, *shape):
        return (self.rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def vec(self, n, base=0.0):
        return (base + 0.1 * self.rng.standard_normal(n)).astype(np.float32)


def _t(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's references."""
    import jax.numpy as jnp
    from gddim_tpu.ops import attnblock, groupnorm, resblock

    import jax
    from gddim_tpu.ops import attention, flash, resblock_bwd
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jax=jax, jnp=jnp, gn=groupnorm, rb=resblock, attn=attnblock,
                                 att=attention, flash=flash, rbw=resblock_bwd, pltpu=pltpu)


def _j(jx, args):
    return [None if a is None else jx.jnp.asarray(a) for a in args]


def _temb_proj(temb, w, b):
    t = temb.astype(np.float64)
    return ((t / (1 + np.exp(-t))) @ w + b).astype(np.float32)


def block_args(d, b, h, cin, cout, skip, parts=None):
    """(x parts, temb, dense w, dense b, GN1, conv1, GN2, conv2, skip) numpy operands."""
    xs = [d.act(b, h, h, c) for c in (parts or (cin,))]
    temb, dw, db = d.act(b, TEMB), d.w(TEMB, cout), d.vec(cout)
    body = [d.vec(cin, 1.0), d.vec(cin), d.w(3, 3, cin, cout), d.vec(cout),
            d.vec(cout, 1.0), d.vec(cout), d.w(3, 3, cout, cout), d.vec(cout)]
    sk = [d.w(cin, cout), d.vec(cout)] if skip else [None, None]
    return xs, (temb, dw, db), body, sk


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 8, 8, 64), 16, True), ((2, 4, 4, 128), 32, True), ((3, 8, 8, 32), 8, False),
])
def test_group_norm_silu_plain_matches_jax(jx, shape, groups, silu):
    d = Draw(0)
    x = 3.0 + d.act(*shape)  # offset mean: a one-pass variance would lose digits
    args = (x, d.vec(shape[-1], 1.0), d.vec(shape[-1]))
    want = jx.gn.group_norm_silu_reference(*_j(jx, args), groups, 1e-6, silu)
    got = t_gn.group_norm_silu(*_t(args), groups, 1e-6, silu)
    assert rel_err(got, want) <= REL
    assert t_gn.group_norm_silu.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("h,cin,cout", [(8, 32, 32), (4, 32, 64)])
def test_resblock_plain_matches_jax(jx, h, cin, cout):
    d = Draw(1)
    (x,), (temb, dw, db), body, sk = block_args(d, 2, h, cin, cout, skip=cin != cout)
    kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
    want = jx.rb.resblock_reference(jx.jnp.asarray(x), jx.jnp.asarray(_temb_proj(temb, dw, db)),
                                    *_j(jx, body + sk), **kw)
    got = t_rb.fused_resblock(*_t([x, temb, dw, db] + body + sk), **kw)
    assert got.shape == (2, h, h, cout)
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("h,c1,c2,cout", [(4, 256, 128, 256), (8, 64, 32, 32)])
def test_resblock_pair_plain_matches_jax(jx, h, c1, c2, cout):
    """(4, 256+128): C=384 in 32 groups of 12, so group 21 straddles the
    xa/xb boundary at channel 256."""
    d = Draw(2)
    cin = c1 + c2
    (xa, xb), (temb, dw, db), body, sk = block_args(d, 2, h, cin, cout, True, (c1, c2))
    kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
    want = jx.rb.resblock_reference(jx.jnp.asarray(np.concatenate([xa, xb], -1)),
                                    jx.jnp.asarray(_temb_proj(temb, dw, db)),
                                    *_j(jx, body + sk), **kw)
    got = t_rb.fused_resblock_pair(*_t([xa, xb, temb, dw, db] + body + sk), **kw)
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("h,c,cout", [(8, 32, 32), (4, 64, 64)])
def test_resblock_tail_plain_matches_jax(jx, h, c, cout):
    d = Draw(3)
    (hx,), (temb, dw, db), body, sk = block_args(d, 2, h, c, cout, True)
    x_skip = d.act(2, h, h, c)
    tail = body[2:]
    kw = dict(num_groups2=min(cout // 4, 32))
    want = jx.rb.resblock_tail_reference(*_j(jx, [hx, x_skip, _temb_proj(temb, dw, db)]),
                                         *_j(jx, tail + sk), **kw)
    got = t_rb.fused_resblock_tail(*_t([hx, x_skip, temb, dw, db] + tail + sk), **kw)
    assert rel_err(got, want) <= REL


@pytest.mark.parametrize("h,c", [(4, 64), (8, 64), (4, 256)])
def test_attnblock_plain_matches_jax(jx, h, c):
    """S = 16 and S = 64 tokens."""
    d = Draw(4)
    args = [d.act(2, h, h, c), d.vec(c, 1.0), d.vec(c)]
    for _ in range(4):
        args += [d.w(c, c), d.vec(c)]
    kw = dict(num_groups=min(c // 4, 32), skip_rescale=True)
    want = jx.attn.attnblock_reference(*_j(jx, args), **kw)
    got = t_attn.fused_attnblock(*_t(args), **kw)
    assert rel_err(got, want) <= REL


def train_block_args(d, b, h, cin, cout, skip, keep):
    """numpy operands of resblock_train_reference: (x, temb_proj, GN1, conv1,
    GN2, conv2, skip, mask), weights at their fan-in scale."""
    x = 0.5 * d.act(b, h, h, cin)
    body = [d.act(b, cout), d.vec(cin, 1.0), d.vec(cin), d.w(3, 3, cin, cout), d.vec(cout),
            d.vec(cout, 1.0), d.vec(cout), d.w(3, 3, cout, cout), d.vec(cout)]
    sk = [d.w(cin, cout), d.vec(cout)] if skip else [None, None]
    mask = (d.rng.random((b, h, h, cout)) < keep).astype(np.int8)
    return [x] + body + sk + [mask]


def _jax_train_args(jx, args, cin, cout):
    """JAX placeholders where the port passes None (no skip)."""
    a = list(args)
    if a[10] is None:
        a[10], a[11] = np.zeros((1, 1), np.float32), np.zeros((1,), np.float32)
    return _j(jx, a)


@pytest.mark.parametrize("h,cin,cout,keep", [(8, 64, 64, 0.9), (4, 64, 128, 0.9), (8, 32, 32, 1.0)])
def test_resblock_train_plain_matches_jax(jx, h, cin, cout, keep):
    """K6's plain version (and the K6 wrapper on CPU tensors) against
    resblock_train_reference, dropout with an explicit mask."""
    args = train_block_args(Draw(10), 2, h, cin, cout, cin != cout, keep)
    kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
    want = jx.rb.resblock_train_reference(*_jax_train_args(jx, args, cin, cout), keep_prob=keep,
                                          has_skip=cin != cout, **kw)
    for fn in (t_rb.resblock_train_reference, t_rb.fused_resblock_train):
        got = fn(*_t(args), keep_prob=keep, **kw)
        assert got.shape == (2, h, h, cout)
        assert rel_err(got.detach(), want) <= REL
    assert t_rb.fused_resblock_train.launches == 0


def _jax_vjp(jx, args, g, keep, has_skip, rescale, kw):
    jargs = _jax_train_args(jx, args, None, None)
    mask = jargs.pop()
    _, vjp = jx.jax.vjp(
        lambda *a: jx.rb.resblock_train_reference(*a, mask, keep_prob=keep, has_skip=has_skip,
                                                  skip_rescale=rescale, **kw), *jargs)
    return vjp(jx.jnp.asarray(g))


@pytest.mark.parametrize("via", ["grads", "autograd"])
@pytest.mark.parametrize("cin,cout,has_skip,dropout,rescale", [
    (128, 128, False, 0.1, True),
    (256, 128, True, 0.1, True),
    (128, 256, True, 0.0, True),
    (128, 128, True, 0.3, False),
])
def test_resblock_train_grads_plain_match_jax_vjp(jx, via, cin, cout, has_skip, dropout,
                                                  rescale):
    """K7's plain version ("grads") and the K6 autograd.Function's backward
    ("autograd", through K7 on CPU tensors) against jax.vjp of
    resblock_train_reference, all 12 gradients (cases of
    tests/test_ops.py:test_fused_resblock_bwd_kernel_matches_vjp)."""
    d = Draw(11)
    keep = 1.0 - dropout
    args = train_block_args(d, 2, 8, cin, cout, has_skip, keep)
    g = d.act(2, 8, 8, cout)
    kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
    ref = _jax_vjp(jx, args, g, keep, has_skip, rescale, kw)
    cfg = dict(keep_prob=keep, skip_rescale=rescale, **kw)
    ts = _t(args)
    if via == "grads":
        got = t_rbw.fused_resblock_train_grads(*ts, torch.from_numpy(g), **cfg)
    else:
        leaves = [None if t is None else t.requires_grad_(True) for t in ts[:12]]
        out = t_rb.fused_resblock_train(*leaves, ts[12], **cfg)
        (out * torch.from_numpy(g)).sum().backward()
        got = [None if t is None else t.grad for t in leaves]
    for name, want, have in zip(GRAD_NAMES, ref, got):
        if name in ("dwsk", "dbsk") and not has_skip:
            assert have is None
            continue
        assert rel_err(have, want) <= REL_GRAD, name


def test_resblock_train_grads_plain_match_jax_bwd_kernel(jx):
    """K7's plain version against the JAX package's backward Pallas kernel
    itself, in interpret mode with f32 matmuls."""
    d = Draw(12)
    args = train_block_args(d, 2, 8, 256, 128, True, 0.9)
    g = d.act(2, 8, 8, 128)
    kw = dict(num_groups1=32, num_groups2=32, skip_rescale=True, keep_prob=0.9)
    jargs = _jax_train_args(jx, args, 256, 128)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rbw.fused_resblock_train_grads(*jargs, jx.jnp.asarray(g), has_skip=True,
                                                 mm_dtype=jx.jnp.float32, **kw)
    got = t_rbw.fused_resblock_train_grads(*_t(args), torch.from_numpy(g), **kw)
    for name, w, h in zip(GRAD_NAMES, want, got):
        assert rel_err(h, w) <= REL_GRAD, name


@pytest.mark.parametrize("b,s,c", [(3, 256, 128), (1, 2048, 128)])
def test_attention_plain_matches_flash_interpret(jx, b, s, c):
    """K8's plain version against flash_attention in interpret mode: the
    whole-sequence branch (S = 256) and the k-blocked one (S = 2048)."""
    d = Draw(13)
    q, k, v = (d.act(b, s, c) for _ in range(3))
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.flash.flash_attention(*_j(jx, [q, k, v]))
    got = t_att.flash_attention(*_t([q, k, v]))
    assert rel_err(got, want) <= REL
    assert t_att.flash_attention.launches == 0


def test_attention_gradient_matches_jax(jx):
    """attention_pallas (K8 forward, plain backward) against jax.vjp of
    attention_xla, and self_attention_2d's two paths against each other."""
    d = Draw(14)
    q, k, v, g = (d.act(2, 64, 32) for _ in range(4))
    want_out, vjp = jx.jax.vjp(jx.att.attention_xla, *_j(jx, [q, k, v]))
    want = vjp(jx.jnp.asarray(g))
    leaves = [t.requires_grad_(True) for t in _t([q, k, v])]
    out = t_att.attention_pallas(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    assert rel_err(out.detach(), want_out) <= REL
    for name, w, t in zip("qkv", want, leaves):
        assert rel_err(t.grad, w) <= REL_GRAD, name
    q4, k4, v4 = (t.detach().reshape(2, 8, 8, 32) for t in leaves)
    assert torch.allclose(t_att.self_attention_2d(q4, k4, v4),
                          t_att.self_attention_2d(q4, k4, v4, fused=False))


@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_gradient_matches_jax(jx, silu):
    """K1's autograd.Function against jax.vjp of the JAX package's
    group_norm_silu (its custom_vjp: the reference's gradient)."""
    d = Draw(15)
    x, g = 2.0 + d.act(2, 4, 4, 64), d.act(2, 4, 4, 64)
    sc, bi = d.vec(64, 1.0), d.vec(64)
    _, vjp = jx.jax.vjp(lambda *a: jx.gn.group_norm_silu(*a, 16, 1e-6, silu),
                        *_j(jx, [x, sc, bi]))
    want = vjp(jx.jnp.asarray(g))
    leaves = [t.requires_grad_(True) for t in _t([x, sc, bi])]
    (t_gn.group_norm_silu(*leaves, 16, 1e-6, silu) * torch.from_numpy(g)).sum().backward()
    for name, w, t in zip(["dx", "dscale", "dbias"], want, leaves):
        assert rel_err(t.grad, w) <= REL_GRAD, name


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version, bf16 inputs.
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(args, device, bf16_first=1):
    out = []
    for i, a in enumerate(args):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(a).to(device)
        out.append(t.to(torch.bfloat16) if i < bf16_first else t)
    return out


def _f32(args):
    return [a.float() if isinstance(a, torch.Tensor) else a for a in args]


# Card bounds, as chip_smoke.py holds them (about 3x the errors measured on an
# H100): K1 in f32; K6 (f32 activations, bf16 MMA operands) and K6 with
# conv2's weight zero (the f32 residual alone); K7's gradients through bf16
# MMA operands, and db2/db_skip (f32 sums of the cotangent); K8 (3xTF32, f32 sums).
K1_F32_BOUND = 1e-6
K6_BOUND = 1e-2
K6_RESIDUAL_BOUND = 1e-6
K7_BOUND_MMA = 1.5e-2
K7_BOUND = {"db2": 1e-6, "dbsk": 1e-6}
K8_BOUND = 1e-5


def _kernel_rel(out, ref):
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(32, 128), (4, 256)])
def test_group_norm_silu_kernel_matches_plain(cuda, h, c):
    d = Draw(5)
    args = _on([d.act(4, h, h, c), d.vec(c, 1.0), d.vec(c)], cuda)
    out = t_gn.group_norm_silu(*args, 32)
    assert out.dtype == torch.bfloat16
    assert _kernel_rel(out, t_gn.group_norm_silu_reference(*_f32(args), 32)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,silu", [(16, 128, True), (16, 256, False), (4, 256, False)])
def test_group_norm_silu_kernel_matches_plain_f32(cuda, h, c, silu):
    """K1 at the training path's dtype (f32 in and out), with and without SiLU."""
    d = Draw(20)
    args = _train_on([d.act(4, h, h, c), d.vec(c, 1.0), d.vec(c)], cuda)
    out = t_gn.group_norm_silu(*args, 32, apply_silu=silu)
    assert out.dtype == torch.float32
    ref = t_gn.group_norm_silu_reference(*args, 32, apply_silu=silu)
    assert _kernel_rel(out, ref) <= K1_F32_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(32, 128, 128), (16, 128, 256), (4, 256, 256)])
def test_resblock_kernel_matches_plain(cuda, h, cin, cout):
    d = Draw(6)
    (x,), temb, body, sk = block_args(d, 4, h, cin, cout, cin != cout)
    args = _on([x] + list(temb) + body + sk, cuda)
    kw = dict(num_groups1=32, num_groups2=32)
    out = t_rb.fused_resblock(*args, **kw)
    assert _kernel_rel(out, t_rb.resblock_reference(*_f32(args), **kw)) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,c1,c2,cout", [(4, 256, 128, 256), (32, 128, 128, 128)])
def test_resblock_pair_kernel_matches_plain(cuda, h, c1, c2, cout):
    d = Draw(7)
    xs, temb, body, sk = block_args(d, 4, h, c1 + c2, cout, True, (c1, c2))
    args = _on(xs + list(temb) + body + sk, cuda, bf16_first=2)
    kw = dict(num_groups1=32, num_groups2=32)
    out = t_rb.fused_resblock_pair(*args, **kw)
    assert _kernel_rel(out, t_rb.resblock_pair_reference(*_f32(args), **kw)) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(16, 128), (4, 256)])
def test_resblock_tail_kernel_matches_plain(cuda, h, c):
    d = Draw(8)
    (hx,), temb, body, sk = block_args(d, 4, h, c, c, True)
    args = _on([hx, d.act(4, h, h, c)] + list(temb) + body[2:] + sk, cuda, bf16_first=2)
    out = t_rb.fused_resblock_tail(*args, num_groups2=32)
    ref = t_rb.resblock_tail_reference(*_f32(args), num_groups2=32)
    assert _kernel_rel(out, ref) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 4])
def test_attnblock_kernel_matches_plain(cuda, h):
    d = Draw(9)
    args = [d.act(4, h, h, 256), d.vec(256, 1.0), d.vec(256)]
    for _ in range(4):
        args += [d.w(256, 256), d.vec(256)]
    args = _on(args, cuda)
    kw = dict(num_groups=32, skip_rescale=True)
    out = t_attn.fused_attnblock(*args, **kw)
    assert _kernel_rel(out, t_attn.attnblock_reference(*_f32(args), **kw)) <= 3e-2


def _train_on(args, device):
    return [None if a is None else torch.from_numpy(a).to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(32, 128, 128), (16, 384, 256), (4, 512, 256)])
def test_resblock_train_kernel_matches_plain(cuda, h, cin, cout):
    """K6 (f32 activations, bf16 MMA operands) against the plain f32 block."""
    args = _train_on(train_block_args(Draw(16), 4, h, cin, cout, cin != cout, 0.9), cuda)
    kw = dict(keep_prob=0.9, num_groups1=32, num_groups2=32)
    out = t_rb.fused_resblock_train(*args, **kw)
    assert out.dtype == torch.float32
    assert _kernel_rel(out, t_rb.resblock_train_reference(*args, **kw)) <= K6_BOUND


@pytest.mark.cuda
def test_resblock_train_kernel_keeps_f32_residual(cuda):
    """With conv2's weight zero K6 computes (x + b2)/sqrt(2): x reaches the
    identity residual in f32 (a bf16 x would be off by ~2e-3)."""
    args = _train_on(train_block_args(Draw(21), 4, 16, 256, 256, False, 0.9), cuda)
    args[8] = torch.zeros_like(args[8])  # conv2 weight
    kw = dict(keep_prob=0.9, num_groups1=32, num_groups2=32)
    out = t_rb.fused_resblock_train(*args, **kw)
    assert _kernel_rel(out, t_rb.resblock_train_reference(*args, **kw)) <= K6_RESIDUAL_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(32, 256, 128), (16, 128, 256), (8, 256, 256)])
def test_resblock_train_grads_kernel_matches_plain(cuda, h, cin, cout):
    """K7's 12 gradients against autograd of the plain f32 block, and two
    runs on the same inputs giving the same bits (no atomics)."""
    d = Draw(17)
    args = _train_on(train_block_args(d, 4, h, cin, cout, cin != cout, 0.9), cuda)
    g = torch.from_numpy(d.act(4, h, h, cout)).to(cuda)
    kw = dict(keep_prob=0.9, num_groups1=32, num_groups2=32)
    got = t_rbw.fused_resblock_train_grads(*args, g, **kw)
    again = t_rbw.fused_resblock_train_grads(*args, g, **kw)
    want = t_rbw.resblock_train_grads_reference(*args, g, **kw)
    for name, a, b, w in zip(GRAD_NAMES, got, again, want):
        if w is None:
            assert a is None
            continue
        assert torch.equal(a, b), name
        assert _kernel_rel(a, w) <= K7_BOUND.get(name, K7_BOUND_MMA), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(4, 256, 256), (4, 16, 256), (1, 2048, 128), (128, 256, 256),
                                   (128, 16, 256)])
def test_flash_attention_kernel_matches_plain(cuda, b, s, c):
    d = Draw(18)
    q, k, v = (torch.from_numpy(d.act(b, s, c)).to(cuda) for _ in range(3))
    out = t_att.flash_attention(q, k, v)
    assert _kernel_rel(out, t_att.attention_xla(q, k, v)) <= K8_BOUND


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_autograd(cuda):
    """K2 and K5 would hand autograd an output with no history: they raise."""
    d = Draw(19)
    # 128 channels: the bf16 block GEMM takes Cout in whole 128-channel tiles
    (x,), temb, body, sk = block_args(d, 2, 8, 128, 128, False)
    args = _on([x] + list(temb) + body + sk, cuda)
    args[4].requires_grad_(True)  # the GN1 scale, as a model parameter would
    with pytest.raises(RuntimeError, match="no backward"):
        t_rb.fused_resblock(*args, num_groups1=32, num_groups2=32)
    with torch.no_grad():
        t_rb.fused_resblock(*args, num_groups1=32, num_groups2=32)
    a = [d.act(2, 4, 4, 64), d.vec(64, 1.0), d.vec(64)]
    for _ in range(4):
        a += [d.w(64, 64), d.vec(64)]
    a = _on(a, cuda)
    a[0] = a[0].float().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        t_attn.fused_attnblock(*a, num_groups=16)
