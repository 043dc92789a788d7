"""K7's GroupNorm(+SiLU) backward on Hopper (``gn_bwd_kernel``, one cluster
of CTAs a sample holding it in shared memory) and GN2's folding pre-pass
(``gn_prepass_kernel``) alone.

On the CPU: the plain versions against the JAX package (``jax.vjp`` of
``group_norm_silu_reference`` with the dropout mask on its output; the TPU
kernels' ``_gn_silu_2d`` for the pre-pass), the cluster plans at every
training shape and their refusals, and the wrappers' C calls with
``_build.launch`` replaced. Cases marked ``cuda`` hold each kernel against
its plain version on the card and skip without one (``pytest --noconftest
-m cuda``: JAX is imported only by the CPU cases).
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import resblock as t_rb
from gddim_torch.ops import resblock_bwd as t_rbw

EPS = 1e-6
KEEP = 0.9
# the plain backward against jax.vjp of the JAX package's reference: the
# same f32 formulas, its two-pass variance against the one-pass statistics
# the kernels fold, sums in another order (measured up to 8.9e-7 of
# max|dL/dv| and of dGN s/b over JAX_SHAPES)
REL_JAX = 1e-5
# the shapes of the CPU comparison: B=2, (H, C)
JAX_SHAPES = [(h, c) for h in (4, 8, 16) for c in (128, 256, 384)]
# the training path's stride-1 block shapes of cld/accr_dcifar10 (H, Cin,
# Cout): tests/test_torch_train_gemm.py's TRAIN_SHAPES
TRAIN_SHAPES = [(32, 128, 128), (32, 384, 128), (32, 256, 128), (16, 512, 256), (16, 384, 256),
                (16, 256, 256), (16, 128, 256), (8, 512, 256), (8, 256, 256), (4, 512, 256),
                (4, 256, 256)]


def groups_of(c):
    return min(c // 4, 32)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import groupnorm, resblock

    return types.SimpleNamespace(jax=jax, jnp=jnp, gn=groupnorm, rb=resblock)


def gn_inputs(seed, b, h, c):
    """numpy (v, gamma, beta, dpre, mask, add, extra) of one GN backward."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    v = 0.7 * f(b, h, h, c) + 0.2
    gamma = (1.0 + 0.1 * f(c)).astype(np.float32)
    beta = (0.1 * f(c)).astype(np.float32)
    mask = (rng.random((b, h, h, c)) < KEEP).astype(np.int8)
    return v, gamma, beta, f(b, h, h, c), mask, f(b, h, h, c), f(b, h, h, c)


def forward_stats(v, gamma, beta, groups):
    """The forward's affine and statistics as the kernels take them."""
    return t_rb.gn_stats_reference(torch.from_numpy(v), groups, EPS, torch.from_numpy(gamma),
                                   torch.from_numpy(beta))


# --------------------------------------------------------------------------
# The plain version against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h,c", JAX_SHAPES)
def test_gn_bwd_plain_matches_jax_vjp(jx, h, c, masked, add):
    """gn_silu_bwd_reference against jax.vjp of group_norm_silu_reference
    (times mask / keep with the dropout mask): dL/dv (+ the add term), and
    the per-sample partials summed into dGN scale and bias."""
    groups = groups_of(c)
    v, gamma, beta, dpre, mask, addv, _ = gn_inputs(h + c, 2, h, c)
    jnp = jx.jnp

    def f(x, s, bb):
        y = jx.gn.group_norm_silu_reference(x, s, bb, groups, EPS)
        return y * (jnp.asarray(mask, jnp.float32) / KEEP) if masked else y

    _, vjp = jx.jax.vjp(f, jnp.asarray(v), jnp.asarray(gamma), jnp.asarray(beta))
    dv, dgamma, dbeta = (np.asarray(t) for t in vjp(jnp.asarray(dpre)))
    t = torch.from_numpy
    got = t_rbw.gn_silu_bwd_reference(
        t(dpre), t(v), *forward_stats(v, gamma, beta, groups), t(gamma), num_groups=groups,
        mask=t(mask) if masked else None, keep_prob=KEEP, add=t(addv) if add else None,
        add_scale=0.7)
    assert got.out.dtype == torch.float32 and got.part_extra is None and got.chan_sum is None
    want = dv + 0.7 * addv if add else dv
    assert rel_err(got.out, want) <= REL_JAX
    assert rel_err(got.part_s.sum(0), dgamma) <= REL_JAX
    assert rel_err(got.part_b.sum(0), dbeta) <= REL_JAX


def test_gn2_form_rounds_and_sums_as_k7():
    """GN2's form: out rounded once to bf16 from the f32 out whose
    per-sample channel sums are chan_sum (K7's dtemb), extra summed per
    sample (K7's db2 and db_skip), the partials those of the f32 form."""
    v, gamma, beta, dpre, mask, _, extra = gn_inputs(3, 2, 8, 256)
    t = torch.from_numpy
    args = (t(dpre), t(v), *forward_stats(v, gamma, beta, 32), t(gamma))
    f32 = t_rbw.gn_silu_bwd_reference(*args, num_groups=32, mask=t(mask), keep_prob=KEEP)
    gn2 = t_rbw.gn_silu_bwd_reference(*args, num_groups=32, mask=t(mask), keep_prob=KEEP,
                                      extra=t(extra), out_bf16=True)
    assert gn2.out.dtype == torch.bfloat16
    assert torch.equal(gn2.out, f32.out.to(torch.bfloat16))
    assert torch.equal(gn2.chan_sum, f32.out.sum((1, 2)))
    assert torch.equal(gn2.part_extra, t(extra).sum((1, 2)))
    assert torch.equal(gn2.part_s, f32.part_s) and torch.equal(gn2.part_b, f32.part_b)


def test_gn2_prepass_plain_matches_jax_gn_silu(jx):
    """gn2_prepass_reference against the TPU kernels' GroupNorm + SiLU
    (``_gn_silu_2d``, the vectorized bodies' fold) of conv1's h1 from its
    partial sums: bf16, int8 by a static scale, and K6/K7's d with the
    dropout mask. Each side rounds its own f32 values, which differ in
    their last bits: a value may land on the neighbouring bf16 value or
    int8 step (measured on at most 1.6e-5 of them)."""
    v, gamma, beta, _, mask, _, _ = gn_inputs(5, 2, 16, 256)
    part = t_rb.gn2_partials_reference(torch.from_numpy(v),
                                       t_rb.bf16_tile_plan(2, 16, 16, 128, 0, 256))
    cg = 256 // 32
    pmat = np.kron(np.eye(32, dtype=np.float32), np.ones((cg, cg), np.float32))
    jnp = jx.jnp
    a2 = np.stack([np.asarray(jx.rb._gn_silu_2d(
        jnp.asarray(v[i].reshape(-1, 256)), jnp.asarray(pmat), jnp.asarray(gamma[None]),
        jnp.asarray(beta[None]), 1.0 / (256 * cg), EPS)).reshape(16, 16, 256) for i in range(2)])
    t = torch.from_numpy
    scale = torch.tensor(0.02)
    for mode, want in (("bf16", t(a2).bfloat16()),
                       ("int8", t(np.clip(np.round(a2 * (1 / 0.02)), -127, 127)).to(torch.int8)),
                       ("train", t(a2 * (mask / KEEP)).bfloat16())):
        got, stats = t_rb.gn2_prepass_reference(
            t(v), part, t(gamma), t(beta), num_groups=32, mode=mode,
            act_scale=scale if mode == "int8" else None,
            mask=t(mask) if mode == "train" else None, keep_prob=KEEP)
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        diff = (got.float() - want.float()).abs()
        step = 1.0 if mode == "int8" else want.float().abs().clamp_min(1e-30) * 2.0 ** -7
        assert bool((diff <= step).all()), mode
        assert (diff > 0).float().mean().item() <= 1e-3, mode
        assert len(stats) == 4


# --------------------------------------------------------------------------
# The cluster plans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b", [2, 4, 128])
@pytest.mark.parametrize("h,cin,cout", TRAIN_SHAPES)
def test_every_training_shape_has_gn_bwd_plans(b, h, cin, cout):
    """GN2's (Cout) and GN1's (Cin) cluster plans at every training shape:
    a cluster size the kernel takes, shares covering the sample, shared
    memory within what two CTAs an SM hold, and K7's plan ints carrying
    both."""
    hw = h * h
    plans = []
    for c in (cout, cin):
        p = t_rb.gn_bwd_plan(b, h, h, c)
        assert p.ctas in t_rb.GN_BWD_CLUSTERS and c % p.ctas == 0 and p.ctas <= hw
        assert p.share == -(-hw // p.ctas) and 0 < p.held <= p.share
        assert p.smem == t_rb.gn_bwd_smem(c, p.held) <= t_rb.GN_BWD_PAIR_BYTES
        assert p.held == p.share or t_rb.gn_bwd_smem(c, p.held + 1) > t_rb.GN_BWD_PAIR_BYTES
        plans.append(p)
    assert t_rbw.train_bwd_plan(b, h, h, cin, cout, cin != cout)[-8:] == (*plans[0], *plans[1])


def test_gn_bwd_plans_fill_one_wave():
    """The smallest cluster that gives the batch a CTA for each SM, of 8
    pixels a CTA at least; the share held as far as two CTAs an SM hold it,
    the rest read again; another cluster or held count on request."""
    assert t_rb.gn_bwd_plan(128, 32, 32, 128) == t_rb.GnBwdPlan(2, 512, 102, 114944)
    assert t_rb.gn_bwd_plan(64, 16, 16, 256).ctas == 4
    assert t_rb.gn_bwd_plan(4, 16, 16, 256) == t_rb.GnBwdPlan(16, 16, 16, 45312)
    assert t_rb.gn_bwd_plan(4, 4, 4, 256).ctas == 2  # 8 pixels a CTA
    assert t_rb.gn_bwd_plan(128, 8, 8, 256).held == 32  # the whole share
    for c in (256, 384):
        q = t_rb.gn_bwd_plan(128, 32, 32, c, ctas=8)
        assert q.share == 128 and q.held < q.share and q.smem <= t_rb.GN_BWD_PAIR_BYTES
        assert t_rb.gn_bwd_plan(128, 32, 32, c, ctas=16, held=64).smem <= t_rb.SMEM_BYTES


@pytest.mark.parametrize("args", [
    dict(b=2, h=8, w=8, c=100),  # not 8-channel vectors
    dict(b=2, h=8, w=8, c=4096),  # more vectors than threads
    dict(b=2, h=8, w=8, c=256, ctas=32),
    dict(b=2, h=2, w=2, c=256, ctas=8),  # more CTAs than pixels
    dict(b=2, h=32, w=32, c=384, ctas=8, held=72),  # more than fits
    dict(b=2, h=8, w=8, c=256, ctas=2, held=33),  # more than the share
])
def test_gn_bwd_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        t_rb.gn_bwd_plan(**args)


def test_gn_silu_bwd_refuses_its_forms_and_groups(glue):
    z = torch.zeros(2, 4, 4, 128)
    st = (torch.zeros(2, 128), torch.zeros(2, 128), torch.zeros(2, 32), torch.zeros(2, 32))
    with pytest.raises(ValueError):  # GN2's form without extra
        t_rbw.gn_silu_bwd(z, z, *st, torch.ones(128), num_groups=32, out_bf16=True)
    with pytest.raises(ValueError):  # GN1's form with a mask
        t_rbw.gn_silu_bwd(z, z, *st, torch.ones(128), num_groups=32, mask=z.to(torch.int8))
    with pytest.raises(ValueError):  # more groups than the kernel folds
        t_rbw.gn_silu_bwd(z, z, st[0], st[1], torch.zeros(2, 64), torch.zeros(2, 64),
                          torch.ones(128), num_groups=64)
    assert glue == []


# --------------------------------------------------------------------------
# The C calls, with _build.launch replaced
# --------------------------------------------------------------------------

_KIND = {"P": (int, type(None)), "I": (int,), "F": (int, float)}


@pytest.fixture
def glue(monkeypatch):
    import ctypes

    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    calls = []

    def launch(name, device, *args):
        sig = [kinds[t] for t in _build._SIGNATURES[name]]
        assert len(args) + 1 == len(sig), (name, len(args) + 1, len(sig))
        for i, (k, v) in enumerate(zip(sig, args)):
            assert isinstance(v, _KIND[k]) and not isinstance(v, bool), (name, i, k, v)
        calls.append((name, args))

    def operand(t, what, dtype, shape=None):
        if t is None:
            return None
        t = t.to(dtype).contiguous()
        assert shape is None or tuple(t.shape) == tuple(shape), what
        return t

    for mod in (t_rb, t_rbw):
        monkeypatch.setattr(mod, "_on_cpu", lambda x, what: False)
        monkeypatch.setattr(mod, "_operand", operand)
    monkeypatch.setattr(_build, "launch", launch)
    yield calls


@pytest.mark.parametrize("gn2", [False, True])
def test_gn_silu_bwd_passes_its_plan(glue, gn2):
    """The wrapper hands gddim_gn_bwd GN2's outputs (bf16 out, the extra and
    channel sums) or GN1's (f32 out, the add term) and the shape's plan,
    or the plan it is given."""
    b, h, c = 2, 16, 256
    z = torch.zeros(b, h, h, c)
    st = (torch.zeros(b, c), torch.zeros(b, c), torch.zeros(b, 32), torch.zeros(b, 32))
    kw = (dict(mask=z.to(torch.int8), keep_prob=KEEP, extra=z, out_bf16=True) if gn2
          else dict(add=z, add_scale=0.5))
    got = t_rbw.gn_silu_bwd(z, z, *st, torch.ones(c), num_groups=32, **kw)
    pinned = t_rb.gn_bwd_plan(b, h, h, c, ctas=16)
    t_rbw.gn_silu_bwd(z, z, *st, torch.ones(c), num_groups=32, plan=pinned, **kw)
    (name, a), (_, a2) = glue
    assert name == "gddim_gn_bwd"
    assert a[-8:] == (b, h * h, c, 32, *t_rb.gn_bwd_plan(b, h, h, c))
    assert a2[-4:] == tuple(pinned)
    assert (a[12] is None, a[13] is None) == (gn2, not gn2)  # out f32, out bf16
    assert got.out.dtype == (torch.bfloat16 if gn2 else torch.float32)
    assert (got.part_extra is None, got.chan_sum is None) == (not gn2, not gn2)
    assert a[2] == pytest.approx(1 / KEEP if gn2 else 1.0) and a[10] == (1.0 if gn2 else 0.5)


@pytest.mark.parametrize("mode", ["bf16", "int8", "train"])
def test_gn2_prepass_passes_its_mode(glue, mode):
    """The wrapper hands gddim_gn2_prepass the partial rows, the mode, the
    static scale or the mask, and the fold-only flag."""
    b, h, n = 2, 8, 256
    h1, part = torch.zeros(b, h, h, n), torch.zeros(2, b, 1, n)
    kw = dict(act_scale=torch.ones(1) if mode == "int8" else None,
              mask=torch.zeros(b, h, h, n, dtype=torch.int8) if mode == "train" else None)
    for fold_only in (False, True):
        out, stats = t_rb.gn2_prepass(h1, part, torch.ones(n), torch.zeros(n), num_groups=32,
                                      mode=mode, fold_only=fold_only, **kw)
        assert (out is None) == fold_only
        assert (stats is None) == (mode != "train" and not fold_only)
    for (name, a), fold_only in zip(glue, (0, 1)):
        assert name == "gddim_gn2_prepass"
        assert a[2:4] == (1, 32) and a[7] == t_rb.GN2_PREPASS_MODES.index(mode)
        assert a[11:15] == (b, h * h, n, fold_only)
        assert (a[8] is None) == (mode != "int8") and (a[9] is None) == (mode != "train")
    with pytest.raises(ValueError):
        t_rb.gn2_prepass(h1, part, torch.ones(n), torch.zeros(n), num_groups=32, mode="bf16",
                         mask=torch.zeros(b, h, h, n, dtype=torch.int8))


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------

# the kernel's f32 sums in another order than the plain version's: out,
# dL/dv, and the partials within 1e-5 of their largest values; gumm (bf16)
# differing on at most 1e-3 of its values (a rounding flipped by a last-bit
# difference of its f32 value), each by one ulp or within 1e-5 of max|o|
REL_CARD = 1e-5
FLIP_SHARE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def bf16_flips(got, want):
    """(largest difference in bf16 ulps of want among the values that differ
    by more than REL_CARD of max|want|, share of values that differ): where
    o cancels to near zero, f32 last bits of the group means move it by
    several ulps of itself, within the f32 outputs' own bound."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    diff = (g - w).abs()
    big = diff > REL_CARD * w.abs().max()
    return ((diff / ulp)[big].max().item() if big.any() else 0.0), (diff > 0).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 128])
@pytest.mark.parametrize("h,cin,cout", TRAIN_SHAPES)
def test_gn_bwd_kernel_matches_plain(cuda, b, h, cin, cout):
    """GN2's form (mask, g's sums, dtemb, gumm) on Cout channels and GN1's
    (the add term) on Cin, against the plain version on the same inputs,
    the same bits on repeat."""
    for c, gn2 in ((cout, True), (cin, False)):
        groups = groups_of(c)
        v, gamma, beta, dpre, mask, addv, extra = (torch.from_numpy(a).to(cuda)
                                                   for a in gn_inputs(h + c, b, h, c))
        stats = t_rb.gn_stats_reference(v, groups, EPS, gamma, beta)
        kw = (dict(mask=mask, keep_prob=KEEP, extra=extra, out_bf16=True) if gn2
              else dict(add=addv, add_scale=0.7))
        got = t_rbw.gn_silu_bwd(dpre, v, *stats, gamma, num_groups=groups, **kw)
        again = t_rbw.gn_silu_bwd(dpre, v, *stats, gamma, num_groups=groups, **kw)
        want = t_rbw.gn_silu_bwd_reference(dpre, v, *stats, gamma, num_groups=groups, **kw)
        for name, x, y, w in zip(t_rbw.GnBwd._fields, got, again, want):
            if w is None:
                assert x is None, name
                continue
            assert torch.equal(x, y), name
            if name == "out" and gn2:
                most, share = bf16_flips(x, w)
                assert most <= 1 and share <= FLIP_SHARE, (name, most, share)
            else:
                assert rel_err(x.cpu(), w.cpu()) <= REL_CARD, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "train"])
@pytest.mark.parametrize("h,n", [(32, 128), (16, 256), (8, 256), (4, 256)])
def test_gn2_prepass_kernel_matches_plain(cuda, h, n, mode):
    """The pre-pass's fold is the fold alone's bits (and, training, the fold
    it writes out); its output the plain conversion from that fold, one ulp
    or step apart on at most FLIP_SHARE of the values."""
    v, gamma, beta, _, mask, _, _ = (torch.from_numpy(a).to(cuda) for a in gn_inputs(n, 16, h, n))
    part = t_rb.gn2_partials_reference(v, t_rb.bf16_tile_plan(16, h, h, 128, 0, n))
    scale = torch.full((1,), 0.02, device=cuda) if mode == "int8" else None
    kw = dict(num_groups=32, mode=mode, act_scale=scale, mask=mask if mode == "train" else None,
              keep_prob=KEEP)
    out, stats = t_rb.gn2_prepass(v, part, gamma, beta, **kw)
    _, fold = t_rb.gn2_prepass(v, part, gamma, beta, num_groups=32, fold_only=True)
    assert torch.equal(out, t_rb.gn2_prepass(v, part, gamma, beta, **kw)[0])
    if mode == "train":
        assert all(torch.equal(a, b) for a, b in zip(stats[:2], fold[:2]))
    want = t_rb.gn2_convert_reference(v, *fold[:2], mode=mode, act_scale=scale,
                                      mask=kw["mask"], keep_prob=KEEP)
    diff = (out.float() - want.float()).abs()
    step = 1.0 if mode == "int8" else want.float().abs() * 2.0 ** -7
    assert bool((diff <= step).all()) and (diff > 0).float().mean().item() <= FLIP_SHARE
