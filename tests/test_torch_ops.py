"""The port's K1-K5 against the JAX package.

On the CPU the wrappers run their plain versions; these are held against the
JAX references (the unfused compositions the JAX kernel tests use as their
oracle) in f32 at rel <= 1e-5. Cases marked ``cuda`` hold each hand-written
kernel against its plain version on the card and skip without one; the JAX
package is imported only by the CPU cases, so the card's machine, which has
no JAX, runs the ``cuda`` cases with ``pytest --noconftest -m cuda``.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import groupnorm as t_gn
from gddim_torch.ops import resblock as t_rb

REL = 1e-5  # f32 on both sides; only summation order differs
TEMB = 16


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

    return types.SimpleNamespace(jnp=jnp, gn=groupnorm, rb=resblock, attn=attnblock)


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
