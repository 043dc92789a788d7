"""The training path's GEMMs on Hopper: K6's and K7's convs and dgrads on the
block GEMM, K7's weight gradients on ``wgrad_kernel``.

On the CPU: the plain versions of the two GEMMs against the JAX package's
``_wgrad9`` and ``_dgrad9`` with bf16 operands (the same bf16 values, f32
sums: only the summation order differs, rel <= 1e-5), and the chains with
the card's rounding points (``resblock_train_bf16_reference``,
``resblock_train_grads_bf16_reference``) against the TPU kernels themselves
with mm_dtype bf16 in interpret mode; the plans and the gate; the wrappers'
C calls with ``_build.launch`` replaced. Cases marked ``cuda`` hold each
kernel against its plain version on the card and skip without one (``pytest
--noconftest -m cuda``: JAX is imported only by the CPU cases).
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import resblock as t_rb
from gddim_torch.ops import resblock_bwd as t_rbw

REL = 1e-5  # the same bf16 operands, f32 sums in another order
GRAD_NAMES = ["dx", "dtemb", "dgn1s", "dgn1b", "dw1", "db1", "dgn2s", "dgn2b", "dw2", "db2",
              "dwsk", "dbsk"]
# the cases: (H, Cin, Cout, 1x1 skip, keep_prob); Cin != Cout takes the skip
CASES = [(4, 128, 256, True, 0.9), (8, 256, 128, True, 1.0), (16, 128, 128, False, 0.9)]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def bf16_values(a):
    """a rounded to bf16, as f32 numpy (the operands both sides take)."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


class Draw:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def act(self, *shape):
        return self.rng.standard_normal(shape).astype(np.float32)

    def w(self, *shape):
        return (self.rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def vec(self, n, base=0.0):
        return (base + 0.1 * self.rng.standard_normal(n)).astype(np.float32)


def train_args(d, b, h, cin, cout, skip, keep):
    """numpy operands of a training block: (x, temb_proj, GN1, conv1, GN2,
    conv2, skip, mask), weights at their fan-in scale."""
    x = 0.5 * d.act(b, h, h, cin)
    body = [d.act(b, cout), d.vec(cin, 1.0), d.vec(cin), d.w(3, 3, cin, cout), d.vec(cout),
            d.vec(cout, 1.0), d.vec(cout), d.w(3, 3, cout, cout), d.vec(cout)]
    sk = [d.w(cin, cout), d.vec(cout)] if skip else [None, None]
    mask = (d.rng.random((b, h, h, cout)) < keep).astype(np.int8)
    return [x] + body + sk + [mask]


def _t(args, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in args]


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from gddim_tpu.ops import resblock, resblock_bwd
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jnp=jnp, rb=resblock, rbw=resblock_bwd, pltpu=pltpu)


def _jax_args(jx, args):
    """JAX placeholders where the port passes None (no skip)."""
    a = list(args)
    if a[10] is None:
        a[10], a[11] = np.zeros((1, 1), np.float32), np.zeros((1,), np.float32)
    return [jx.jnp.asarray(v) for v in a]


def _kw(cin, cout):
    return dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))


# --------------------------------------------------------------------------
# The GEMMs' plain versions against the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,cin,cout,skip,keep", CASES)
def test_wgrad_plain_matches_jax_wgrad9(jx, h, cin, cout, skip, keep):
    """wgrad_reference against _wgrad9 (mm_dtype bf16) on the same bf16
    activation and cotangent, the 3x3's nine taps and the 1x1's one."""
    d = Draw(h + cin)
    a, g = bf16_values(d.act(2, h, h, cin)), bf16_values(d.act(2, h, h, cout))
    bf = jx.jnp.bfloat16
    want = jx.rbw._wgrad9(jx.jnp.asarray(a, bf), jx.jnp.asarray(g.reshape(-1, cout), bf), cout,
                          bf, 3)
    at, gt = torch.from_numpy(a).bfloat16(), torch.from_numpy(g).bfloat16()
    assert rel_err(t_rbw.wgrad_reference(at, gt), want) <= REL
    assert rel_err(t_rbw.wgrad(at, gt, 1), a.reshape(-1, cin).T @ g.reshape(-1, cout)) <= REL


@pytest.mark.parametrize("h,cin,cout,skip,keep", CASES)
def test_dgrad_plain_matches_jax_dgrad9(jx, h, cin, cout, skip, keep):
    """dgrad_reference (the conv of g with the taps flipped and (Cin, Cout)
    swapped, from the forward's HWIO weights) against _dgrad9 on the same
    bf16 values, and the 1x1's g @ w^T."""
    d = Draw(2 * h + cout)
    g, w = bf16_values(d.act(2, h, h, cout)), bf16_values(d.w(3, 3, cin, cout))
    bf = jx.jnp.bfloat16
    wf = jx.rb._pack_w_scatter(jx.jnp.asarray(w.reshape(9, cin, cout), bf))
    want = jx.rbw._dgrad9(jx.jnp.asarray(g.reshape(-1, cout), bf), wf, 2, h, h, cin, cout, bf)
    gt, wt = torch.from_numpy(g).bfloat16(), torch.from_numpy(w).bfloat16()
    got = t_rbw.bf16_dgrad_gemm(gt, wt)
    assert got.shape == (2, h, h, cin)
    assert rel_err(got.reshape(-1, cin), want) <= REL
    ws = bf16_values(d.w(cin, cout))
    assert rel_err(t_rbw.dgrad_reference(gt, torch.from_numpy(ws)), g @ ws.T) <= REL


# --------------------------------------------------------------------------
# The chains against the TPU kernels with mm_dtype bf16, in interpret mode
# --------------------------------------------------------------------------

# Both sides round the same operands to bf16 (a1, d, the skip's x; K7: gmm,
# gumm) from f32 values that differ in their last bits (GroupNorm statistics
# summed in another order, the affine as x * a + b against (x - mean) * rstd
# * gamma + beta), so a few operands round to the neighbouring bf16 value: a
# flip moves its product by 2^-8 of itself. Measured on the CPU: K6 up to
# 1.0e-4 (16x16 with dropout), K7 up to 6.7e-4 (dW1 at 16x16), the gap
# growing with the operands an output sums
K6_CHAIN = 5e-4
K7_CHAIN = 2e-3


@pytest.mark.parametrize("h,cin,cout,skip,keep", CASES)
def test_k6_chain_matches_jax_kernel(jx, h, cin, cout, skip, keep):
    """K6's chain (pre-pass, block GEMM, f32 residual) against the TPU
    kernel's training forward, fused_resblock with the dropout mask, as
    make_fused_resblock_train runs it on a TPU."""
    args = train_args(Draw(3 * h + cin), 2, h, cin, cout, skip, keep)
    ja = _jax_args(jx, args)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock(
            *ja[:10], ja[10] if skip else None, ja[11] if skip else None, **_kw(cin, cout),
            mm_dtype=jx.jnp.bfloat16, drop_mask=ja[12] if keep < 1.0 else None, keep_prob=keep)
    got = t_rb.resblock_train_bf16_reference(*_t(args), keep_prob=keep, **_kw(cin, cout))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= K6_CHAIN


@pytest.mark.parametrize("h,cin,cout,skip,keep", CASES)
def test_k7_chain_matches_jax_kernel(jx, h, cin, cout, skip, keep):
    """K7's chain (bf16 a1, gmm, d, gumm and skip x; block-GEMM dgrads, the
    wgrads) against the TPU kernel fused_resblock_train_grads with mm_dtype
    bf16 in interpret mode, all 12 gradients."""
    d = Draw(4 * h + cout)
    args = train_args(d, 2, h, cin, cout, skip, keep)
    g = d.act(2, h, h, cout)
    cfg = dict(keep_prob=keep, skip_rescale=True, **_kw(cin, cout))
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rbw.fused_resblock_train_grads(*_jax_args(jx, args), jx.jnp.asarray(g),
                                                 has_skip=skip, mm_dtype=jx.jnp.bfloat16, **cfg)
    got = t_rbw.resblock_train_grads_bf16_reference(*_t(args), torch.from_numpy(g), **cfg)
    for name, w, have in zip(GRAD_NAMES, want, got):
        if name in ("dwsk", "dbsk") and not skip:
            assert have is None
            continue
        assert rel_err(have, np.asarray(w).reshape(have.shape)) <= K7_CHAIN, name


def test_k7_chain_matches_autograd_in_f32():
    """Without its bf16 rounding points (every operand f32-valued, the
    weights bf16 values) K7's chain is the plain block's gradient: autograd
    of resblock_train_reference on the same values."""
    d = Draw(5)
    args = train_args(d, 2, 8, 128, 256, True, 0.9)
    for i in (4, 8, 10):
        args[i] = bf16_values(args[i])
    g = d.act(2, 8, 8, 256)
    cfg = dict(keep_prob=0.9, **_kw(128, 256))
    want = t_rbw.resblock_train_grads_reference(*_t(args), torch.from_numpy(g), **cfg)
    got = t_rbw.resblock_train_grads_bf16_reference(*_t(args), torch.from_numpy(g), **cfg)
    for name, w, have in zip(GRAD_NAMES, want, got):
        # bf16 operands against f32 ones, the chain's own rounding: measured
        # up to 3.5e-3 (dGN1 scale)
        assert rel_err(have, w) <= 2e-2, name


# --------------------------------------------------------------------------
# Plans and the gate
# --------------------------------------------------------------------------

# the training path's stride-1 block shapes of cld/accr_dcifar10 (H, Cin, Cout)
TRAIN_SHAPES = [(32, 128, 128), (32, 384, 128), (32, 256, 128), (16, 512, 256), (16, 384, 256),
                (16, 256, 256), (16, 128, 256), (8, 512, 256), (8, 256, 256), (4, 512, 256),
                (4, 256, 256)]


@pytest.mark.parametrize("b", [2, 4, 128])
@pytest.mark.parametrize("h,cin,cout", TRAIN_SHAPES)
def test_every_training_shape_has_plans(b, h, cin, cout):
    """Each training shape takes K6 and K7, and every wgrad plan covers the
    pixels in WGRAD_PIX-pixel boxes, its splits in order."""
    assert t_rb.train_supported((b, h, h, cin), cout)
    plan = t_rbw.train_bwd_plan(b, h, h, cin, cout, cin != cout)
    assert len(plan) == t_rbw.PLAN_INTS
    slices = -(-(b * h * h) // t_rb.WGRAD_PIX)
    for c, taps in ((cout, 9), (cin, 9), (cin, 1)):
        p = t_rb.wgrad_plan(b, h, h, c, taps, cout)
        assert h * p.box_h * p.box_b == t_rb.WGRAD_PIX
        assert (taps * c // 64) % (2 * p.mw) == 0
        assert (p.splits - 1) * p.per < slices <= p.splits * p.per


@pytest.mark.parametrize("shape,cout,ok", [
    ((4, 32, 32, 128), 128, True), ((4, 4, 4, 256), 256, True), ((4, 16, 16, 384), 256, True),
    ((4, 32, 32, 64), 128, False),  # the dgrad into 64 channels: N tiles of 128
    ((4, 16, 16, 128), 64, False), ((4, 8, 8, 128), 96, False), ((4, 2, 2, 128), 128, False),
    ((4, 32, 32, 32), 64, False)])
def test_train_gate_follows_the_plans(shape, cout, ok):
    assert t_rb.train_supported(shape, cout) is ok
    if not ok:
        with pytest.raises(ValueError):
            t_rbw.train_bwd_plan(shape[0], shape[1], shape[2], shape[3], cout, True)


def test_wgrad_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        t_rb.wgrad_plan(2, 6, 6, 128, 9, 128)  # 64 pixels are no whole rows of 6
    with pytest.raises(ValueError):
        t_rb.wgrad_plan(2, 8, 8, 96, 9, 128)
    with pytest.raises(ValueError):
        t_rb.wgrad_plan(2, 8, 8, 64, 9, 128)  # 9 blocks of 64 rows: two warpgroups a CTA


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
    for fn in (t_rb.fused_resblock_train, t_rbw.fused_resblock_train_grads):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "workspace_bytes", lambda name, *a: 256)
    yield calls
    t_rb._plan_gemm.cache_clear()  # they cached the stand-in workspace sizes
    t_rbw._workspace.cache_clear()


@pytest.mark.parametrize("skip", [False, True])
def test_train_wrappers_pass_their_plans(glue, skip):
    """K6 and K7 hand their entries the plans of the Python side: K6 conv1's
    M tiling and both splits, K7 the address of train_bwd_plan's ints."""
    cin, cout = (128, 256) if skip else (128, 128)
    args = _t(train_args(Draw(6), 2, 8, cin, cout, skip, 0.9))
    kw = dict(keep_prob=0.9, **_kw(cin, cout))
    t_rb._resblock_train_cuda(*args, eps=1e-6, skip_rescale=True, **kw)
    t_rbw._grads_cuda(*args, torch.zeros(2, 8, 8, cout), eps=1e-6, skip_rescale=True, **kw)
    (k6, a6), (k7, a7) = glue
    assert (k6, k7) == ("gddim_resblock_train", "gddim_resblock_bwd")
    p1 = t_rb.bf16_tile_plan(2, 8, 8, cin, 0, cout)
    p2 = t_rb.bf16_tile_plan(2, 8, 8, cout, cin if skip else 0, cout)
    assert a6[-10:-1] == (p1.mw, p1.box_h, p1.box_b, p1.tiles_h, p1.m_tiles, p1.splits, p1.kper,
                          p2.splits, p2.kper)
    plan = t_rbw._plan_array(2, 8, 8, cin, cout, skip)
    assert a7[22] == plan.ctypes.data
    assert tuple(plan) == t_rbw.train_bwd_plan(2, 8, 8, cin, cout, skip)


def test_bare_gemm_wrappers_pass_their_plans(glue):
    a, g = torch.zeros(2, 16, 16, 128), torch.zeros(2, 16, 16, 256)
    t_rbw.wgrad(a, g)
    t_rbw.bf16_dgrad_gemm(g, torch.zeros(3, 3, 128, 256))
    t_rbw.bf16_dgrad_gemm(g, torch.zeros(128, 256))
    (nw, aw), (nd, ad), (n1, a1) = glue
    assert (nw, nd, n1) == ("gddim_wgrad", "gddim_dgrad_bf16", "gddim_dgrad_bf16")
    assert aw[8:13] == tuple(t_rb.wgrad_plan(2, 16, 16, 128, 9, 256))
    assert ad[7] == 9 and a1[7] == 1  # taps
    assert ad[5:7] == (256, 128)  # the dgrad's channels in, and out: the forward's Cin


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------

# the kernels' operands are the plain versions' bf16 values, so the GEMMs
# differ only by f32 summation order: a wgrad sums B*H*W products, 131072 at
# B=128 32x32, in 64-pixel slices and splits against the plain product's
# order (measured 1.5e-5 there on an H100); the blocks round their operands
# from f32 values computed in another order (a few bf16 flips, K6_CHAIN and
# K7_CHAIN above)
GEMM_BOUND = 1e-4
K6_KERNEL_BOUND = 1e-3
K7_KERNEL_BOUND = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 128])
@pytest.mark.parametrize("h,cin,cout", TRAIN_SHAPES)
def test_gemm_kernels_match_plain(cuda, b, h, cin, cout):
    """wgrad_kernel (dW2, dW1, dW_skip) and the block GEMM's dgrads (N -> N,
    N -> Cin, the 1x1) at every training shape."""
    d = Draw(7)
    a1, dd, g = (torch.from_numpy(d.act(b, h, h, c)).to(cuda).bfloat16()
                 for c in (cin, cout, cout))
    for a, taps in ((dd, 9), (a1, 9), (a1, 1)):
        got = t_rbw.wgrad(a, g, taps)
        assert rel_err(got.cpu(), t_rbw.wgrad_reference(a, g, taps).cpu()) <= GEMM_BOUND
    for w in (d.w(3, 3, cout, cout), d.w(3, 3, cin, cout), d.w(cin, cout)):
        wt = torch.from_numpy(w).to(cuda).bfloat16()
        got = t_rbw.bf16_dgrad_gemm(g, wt)
        assert rel_err(got.cpu(), t_rbw.dgrad_reference(g, wt).cpu()) <= GEMM_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", TRAIN_SHAPES)
def test_train_blocks_match_their_chains(cuda, h, cin, cout):
    """K6 and K7 against the chains with their rounding points, K7 the same
    bits on repeat."""
    d = Draw(8)
    args = _t(train_args(d, 4, h, cin, cout, cin != cout, 0.9), cuda)
    g = torch.from_numpy(d.act(4, h, h, cout)).to(cuda)
    kw = dict(keep_prob=0.9, **_kw(cin, cout))
    out = t_rb.fused_resblock_train(*args, **kw)
    assert rel_err(out.cpu(), t_rb.resblock_train_bf16_reference(*args, **kw).cpu()) \
        <= K6_KERNEL_BOUND
    got = t_rbw.fused_resblock_train_grads(*args, g, **kw)
    again = t_rbw.fused_resblock_train_grads(*args, g, **kw)
    want = t_rbw.resblock_train_grads_bf16_reference(*args, g, **kw)
    for name, a, b2, w in zip(GRAD_NAMES, got, again, want):
        if w is None:
            assert a is None
            continue
        assert torch.equal(a, b2), name
        assert rel_err(a.cpu(), w.cpu()) <= K7_KERNEL_BOUND, name
