"""The int8 blocks' static skip projection (``act_scales = [s1, s2, sx]``,
the JAX package's ``static_skip``) in the H100 port.

On the CPU: the skip's quantizer bit for bit against the JAX package's; the
int8 plain versions of K2 (128 -> 256), K3 (the pair), K4 (after an up and
a down resample) and K9 (up and down, FIR and naive coefficients) with the
three scales against the JAX package's int8 Pallas kernels in interpret
mode with the same scales; sx ignored where a block has no 1x1 skip; the
skip weights' packing; and the CUDA wrappers' C calls with
``_build.launch`` replaced. Cases marked ``cuda`` hold each kernel against
its plain version on the card, and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import resblock as t_rb

# rel max|port - JAX| / max|JAX| per block (tests/test_torch_int8.py's
# BLOCK_REL): rounding flips only
BLOCK_REL = 2e-3
KERNEL_BOUND = 1e-2  # the kernels against their plain versions on the card
TEMB = 16
# amaxes under the activations' range, so that every static scale clips some values
A1, A2, AX = 2.0, 2.5, 2.0


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from gddim_tpu.ops import resblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jnp=jnp, rb=resblock, pltpu=pltpu)


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


def _j(jx, args):
    return [None if a is None else jx.jnp.asarray(a) for a in args]


def _q(w):
    return t_rb.quantize_weight(torch.from_numpy(w))


def _temb_proj(temb, w, b):
    t = temb.astype(np.float64)
    return ((t / (1 + np.exp(-t))) @ w + b).astype(np.float32)


def _scales(*amax):
    return torch.stack(t_rb.act_scales_from_amax(amax))


def _block(d, h, cin, cout, parts=None):
    xs = [d.act(2, h, h, c) for c in (parts or (cin,))]
    return (xs, (d.act(2, TEMB), d.w(TEMB, cout), d.vec(cout)), [d.vec(cin, 1.0), d.vec(cin)],
            (d.w(3, 3, cin, cout), d.vec(cout)), [d.vec(cout, 1.0), d.vec(cout)],
            (d.w(3, 3, cout, cout), d.vec(cout)), (d.w(cin, cout), d.vec(cout)))


# --------------------------------------------------------------------------
# (a) the skip's quantizer and scales
# --------------------------------------------------------------------------


def test_skip_quantizer_matches_jax_bit_for_bit(jx):
    """q(x) = clip(round(x * (1/sx))) against the JAX kernels' _quant_2d_static
    with _qs_row's inverse, values on half steps and past the clip included."""
    sx = t_rb.act_scales_from_amax((AX,))[0]
    x = Draw(1).act(64, 128) * 2.5
    x[0, :8] = (np.arange(8) - 3.5) * float(sx)  # half steps
    inv = jx.rb._qs_row(tuple(jx.rb.act_scales_from_amax((A1, A2, AX))))[0, 2]
    want = np.asarray(jx.rb._quant_2d_static(jx.jnp.asarray(x), inv))
    got = t_rb.quant_static(torch.from_numpy(x), sx)
    np.testing.assert_array_equal(got.numpy().astype(np.int8), want)
    assert got.abs().max() == 127  # some values clip


def test_act_scales_take_two_or_three():
    assert t_rb.check_act_scales(None) is False
    assert t_rb.check_act_scales(_scales(A1, A2)) is False
    assert t_rb.check_act_scales(_scales(A1, A2, AX)) is True
    with pytest.raises(ValueError):
        t_rb.check_act_scales(torch.ones(4))


def test_pack_skip_int8_keeps_the_values_k_major():
    wq, sc = _q(Draw(2).w(256, 128))
    pq, psc = t_rb.pack_skip_int8((wq, sc))
    assert torch.equal(pq, wq) and psc is sc
    assert pq.shape == (256, 128) and pq.t().is_contiguous()


# --------------------------------------------------------------------------
# (b) the blocks against the JAX int8 kernels with (s1, s2, sx)
# --------------------------------------------------------------------------


def _jax_sx(jx):
    return tuple(jx.rb.act_scales_from_amax((A1, A2, AX)))


def test_resblock_int8_static_skip_matches_jax_kernel(jx):
    d = Draw(10)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, 8, 128, 256)
    kw = dict(num_groups1=32, num_groups2=32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock(*_j(jx, [x, _temb_proj(temb, dw, db), *g1, w1, b1, *g2, w2,
                                             b2, ws, bs]), mm_dtype=jx.jnp.int8,
                                    act_scales=_jax_sx(jx), **kw)
    got = t_rb.fused_resblock_int8(*_t([x, temb, dw, db, *g1]), _q(w1), torch.from_numpy(b1),
                                   *_t(g2), _q(w2), torch.from_numpy(b2), _q(ws),
                                   torch.from_numpy(bs), _scales(A1, A2, AX), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= BLOCK_REL
    # the static skip changes the block: the bf16 skip's output differs
    two = t_rb.fused_resblock_int8(*_t([x, temb, dw, db, *g1]), _q(w1), torch.from_numpy(b1),
                                   *_t(g2), _q(w2), torch.from_numpy(b2), *_t([ws, bs]),
                                   _scales(A1, A2), **kw)
    assert not torch.equal(got, two)
    assert t_rb.fused_resblock_int8.launches == 0


def test_resblock_pair_int8_static_skip_matches_jax_kernel(jx):
    """C1=128, C2=256: both halves quantized by sx, their products summed."""
    d = Draw(11)
    (xa, xb), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(
        d, 8, 384, 256, (128, 256))
    kw = dict(num_groups1=32, num_groups2=32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock_pair(
            *_j(jx, [xa, xb, _temb_proj(temb, dw, db), *g1, w1, b1, *g2, w2, b2, ws, bs]),
            mm_dtype=jx.jnp.int8, act_scales=_jax_sx(jx), **kw)
    got = t_rb.fused_resblock_pair_int8(*_t([xa, xb, temb, dw, db, *g1]), _q(w1),
                                        torch.from_numpy(b1), *_t(g2), _q(w2),
                                        torch.from_numpy(b2), _q(ws), torch.from_numpy(bs),
                                        _scales(A1, A2, AX), **kw)
    assert rel_err(got, want) <= BLOCK_REL


@pytest.mark.parametrize("h", [16, 4], ids=["after_up", "after_down"])
def test_resblock_tail_int8_static_skip_matches_jax_kernel(jx, h):
    """K4 at the output of an up (8 -> 16) and a down (8 -> 4) resample."""
    d = Draw(12)
    (hh,), (temb, dw, db), _, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, h, 128, 128)
    hh = hh * (hh > -0.3)  # a silu-like range
    x_skip = d.act(2, h, h, 128)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock_tail(
            *_j(jx, [hh, x_skip, _temb_proj(temb, dw, db), w1, b1, *g2, w2, b2, ws, bs]),
            num_groups2=32, mm_dtype=jx.jnp.int8, act_scales=_jax_sx(jx))
    got = t_rb.fused_resblock_tail_int8(*_t([hh, x_skip, temb, dw, db]), _q(w1),
                                        torch.from_numpy(b1), *_t(g2), _q(w2),
                                        torch.from_numpy(b2), _q(ws), torch.from_numpy(bs),
                                        _scales(A1, A2, AX), num_groups2=32)
    assert rel_err(got, want) <= BLOCK_REL


@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
@pytest.mark.parametrize("fir", [True, False], ids=["fir", "naive"])
def test_transition_int8_static_skip_matches_jax_kernel(jx, up, fir):
    """K9: the skip input is the resampled x, quantized before any rounding."""
    d = Draw(13)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, 8, 128, 128)
    kw = dict(up=up, fir=fir, num_groups1=32, num_groups2=32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock_transition(
            *_j(jx, [x, _temb_proj(temb, dw, db), *g1, w1, b1, *g2, w2, b2, ws, bs]),
            mm_dtype=jx.jnp.int8, act_scales=_jax_sx(jx), **kw)
    got = t_rb.fused_resblock_transition_int8(
        *_t([x, temb, dw, db, *g1]), _q(w1), torch.from_numpy(b1), *_t(g2), _q(w2),
        torch.from_numpy(b2), _q(ws), torch.from_numpy(bs), _scales(A1, A2, AX), **kw)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= BLOCK_REL
    assert t_rb.fused_resblock_transition_int8.launches == 0


def test_identity_skip_ignores_sx():
    d = Draw(14)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), _ = _block(d, 8, 128, 128)
    args = (*_t([x, temb, dw, db, *g1]), _q(w1), torch.from_numpy(b1), *_t(g2), _q(w2),
            torch.from_numpy(b2), None, None)
    kw = dict(num_groups1=32, num_groups2=32)
    assert torch.equal(t_rb.fused_resblock_int8(*args, _scales(A1, A2, AX), **kw),
                       t_rb.fused_resblock_int8(*args, _scales(A1, A2), **kw))


def test_static_skip_needs_quantized_skip_weights():
    d = Draw(15)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, 4, 128, 256)
    with pytest.raises(ValueError, match="pair"):
        t_rb.fused_resblock_int8(*_t([x, temb, dw, db, *g1]), _q(w1), torch.from_numpy(b1),
                                 *_t(g2), _q(w2), torch.from_numpy(b2), *_t([ws, bs]),
                                 _scales(A1, A2, AX), num_groups1=32, num_groups2=32)


def _skip_case(kind: str, d):
    """(entry, args, keywords, the skip's f32 input) of one int8 block with
    the static skip on CPU tensors."""
    cin, parts = (384, (128, 256)) if kind == "K3" else (128, None)
    xs, (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, 8, cin, 256, parts)
    xs = _t(xs)
    tail = (_q(w1), torch.from_numpy(b1), *_t(g2), _q(w2), torch.from_numpy(b2), _q(ws),
            torch.from_numpy(bs), _scales(A1, A2, AX))
    kw = dict(num_groups1=32, num_groups2=32)
    if kind == "K2":
        return t_rb.fused_resblock_int8, (xs[0], *_t([temb, dw, db, *g1]), *tail), kw, xs[0]
    if kind == "K3":
        return (t_rb.fused_resblock_pair_int8, (*xs, *_t([temb, dw, db, *g1]), *tail), kw,
                torch.cat(xs, -1))
    if kind == "K4":
        x_skip = torch.from_numpy(d.act(2, 8, 8, cin))
        return (t_rb.fused_resblock_tail_int8, (xs[0], x_skip, *_t([temb, dw, db]), *tail),
                dict(num_groups2=32), x_skip)
    up = kind == "K9-up"
    # K9's skip input: x rounded to bf16 (the kernel's operand), resampled in f32
    xr = t_rb.resample_transition(xs[0].bfloat16().float(), t_rb.transition_kerns(up, True), up)
    return (t_rb.fused_resblock_transition_int8, (xs[0], *_t([temb, dw, db, *g1]), *tail),
            dict(kw, up=up), xr)


@pytest.mark.parametrize("kind", ["K2", "K3", "K4", "K9-up", "K9-down"])
def test_skip_buffers_hold_the_plain_skip_on_cpu(kind):
    """skip_buffers on the CPU: the plain static skip's q(x) of the skip input
    (K3 the concat, K9 the resampled x), and nothing else (the kernels keep
    no skip product of their own); the block's output is unchanged by asking
    for it."""
    fn, args, kw, x_skip = _skip_case(kind, Draw(17))
    bufs = {}
    out = fn(*args, **kw, skip_buffers=bufs)
    assert torch.equal(out, fn(*args, **kw))
    sx = args[-1][2]
    assert list(bufs) == ["xq"]
    assert bufs["xq"].dtype == torch.int8 and bufs["xq"].shape == x_skip.shape
    assert torch.equal(bufs["xq"], t_rb.quant_static(x_skip, sx).to(torch.int8))


def test_skip_buffers_need_the_static_skip():
    fn, args, kw, _ = _skip_case("K2", Draw(18))
    with pytest.raises(ValueError, match="static skip"):
        fn(*args[:-1], args[-1][:2], **kw, skip_buffers={})


# --------------------------------------------------------------------------
# (c) the CUDA wrappers' C calls, _build.launch replaced
# --------------------------------------------------------------------------


_KIND = {_build._P: "P", _build._I: "I", _build._F: "F", _build._L: "L"}


@pytest.fixture
def glue(monkeypatch):
    """The int8 block wrappers on CPU tensors with ``_build.launch`` recording
    each call (its arguments checked against the entry's signature) and the
    workspace sizes asked for."""
    calls, sizes = [], []

    def launch(name, device, *args):
        kinds = [_KIND[t] for t in _build._SIGNATURES[name]]
        assert len(args) + 1 == len(kinds), (name, len(args) + 1, len(kinds))
        for i, (k, v) in enumerate(zip(kinds, args)):
            assert (v is None or isinstance(v, int)) if k == "P" else not isinstance(v, bool), i
        calls.append((name, args))

    def operand(t, what, dtype, shape=None):
        if t is None:
            return None
        t = t.to(dtype).contiguous()
        assert shape is None or tuple(t.shape) == tuple(shape), what
        return t

    def temb_row(temb, dense_w, dense_b, b, n):
        row = t_rb.temb_projection(temb, dense_w, dense_b).contiguous()
        return row, row.stride(0)

    def workspace(name, *a):
        sizes.append((name, a))
        return 256

    monkeypatch.setattr(t_rb, "_on_cpu", lambda x, what: False)
    monkeypatch.setattr(t_rb, "_operand", operand)
    monkeypatch.setattr(t_rb, "_temb_row", temb_row)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "workspace_bytes", workspace)
    for fn in (t_rb.fused_resblock_int8, t_rb.fused_resblock_pair_int8,
               t_rb.fused_resblock_tail_int8, t_rb.fused_resblock_transition_int8):
        monkeypatch.setattr(fn, "launches", fn.launches)
    t_rb._plan_gemm.cache_clear()
    yield calls, sizes
    t_rb._plan_gemm.cache_clear()  # it cached the stand-in workspace sizes


@pytest.mark.parametrize("sx", [True, False], ids=["static_skip", "bf16_skip"])
def test_int8_wrappers_pass_the_static_skip(glue, sx):
    """K2/K3/K4/K9 int8 hand their entries the static skip (the skip's int8
    weights K-major, their scales and three scales; no plan of its own: its
    slices join conv2's), or a null and two scales; gddim_resblock_int8's
    workspace holds the skip's channels (q(x)) or 0, the transition's takes
    no such count (q(xr) in its own xr)."""
    calls, sizes = glue
    d = Draw(16)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, 16, 128, 256)
    s = _scales(A1, A2, AX) if sx else _scales(A1, A2)
    pk = lambda w: t_rb.pack_int8_weight(_q(w))  # noqa: E731
    skip = t_rb.pack_skip_int8(_q(ws)) if sx else torch.from_numpy(ws).bfloat16()
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731  the int8 modes' activations
    head = (bf(x), *_t([temb, dw, db, *g1]), pk(w1), torch.from_numpy(b1), *_t(g2), pk(w2),
            torch.from_numpy(b2), skip, torch.from_numpy(bs), s)
    kw = dict(num_groups1=32, num_groups2=32)
    t_rb.fused_resblock_int8(*head, **kw)
    xa = bf(d.act(2, 16, 16, 128))
    (xp,), _, gp1, (wp1, _), _, _, (wps, _) = _block(d, 16, 384, 256)
    pskip = t_rb.pack_skip_int8(_q(wps)) if sx else torch.from_numpy(wps).bfloat16()
    t_rb.fused_resblock_pair_int8(xa, bf(xp[..., 128:]), *_t([temb, dw, db]),
                                  *_t(gp1), pk(wp1), *head[7:12], pskip, torch.from_numpy(bs), s,
                                  **kw)
    (h,), _, _, (w1t, _), _, _, (wst, _) = _block(d, 16, 256, 256)
    tskip = t_rb.pack_skip_int8(_q(wst)) if sx else torch.from_numpy(wst).bfloat16()
    t_rb.fused_resblock_tail_int8(bf(h), bf(d.act(2, 16, 16, 256)),
                                  *_t([temb, dw, db]), pk(w1t), *head[7:12], tskip,
                                  torch.from_numpy(bs), s, num_groups2=32)
    (xt,), _, gt1, (wt1, bt1), gt2, (wt2, bt2), (wts, bts) = _block(d, 8, 256, 256)
    tskip = t_rb.pack_skip_int8(_q(wts)) if sx else torch.from_numpy(wts).bfloat16()
    t_rb.fused_resblock_transition_int8(
        bf(xt), *_t([temb, dw, db]), *_t(gt1), pk(wt1),
        torch.from_numpy(bt1), *_t(gt2), pk(wt2), torch.from_numpy(bt2), tskip,
        torch.from_numpy(bts), s, up=True, **kw)
    assert [n for n, _ in calls] == ["gddim_resblock_int8"] * 3 + ["gddim_resblock_transition_int8"]
    for name, args in calls:
        i = 24 if name == "gddim_resblock_int8" else 18  # wss, act_scales
        assert all(a is not None for a in args[i:i + 2]) if sx else (
            args[i] is None and args[i + 1] is not None)
        assert isinstance(args[i + 2], int)  # the batch: no skip plan between
    assert [(n, a[-1]) for n, a in sizes[:3]] == [("gddim_resblock_int8", c) for c in (
        [128, 384, 256] if sx else [0, 0, 0])]
    assert sizes[3][0] == "gddim_resblock_transition_int8" and len(sizes[3][1]) == 7


@pytest.mark.parametrize("kind", ["K2", "K3", "K4", "K9-up"])
def test_skip_buffers_view_the_workspace(glue, monkeypatch, kind):
    """On CUDA, skip_buffers views the launch's workspace at the offset the
    C entry gives for the workspace's own arguments: "xq" int8 (B, H, W,
    Cskip), and no f32 skip product (the kernels keep none)."""
    calls, sizes = glue
    fn, args, kw, x_skip = _skip_case(kind, Draw(19))
    bf = lambda t: t.bfloat16()  # noqa: E731  the int8 modes' activations
    pk = lambda w: t_rb.pack_int8_weight(w)  # noqa: E731
    n_x = 2 if kind == "K3" else 1
    xs = [bf(a) for a in args[:n_x + (kind == "K4")]]
    rest = list(args[len(xs):])
    i = len(rest) - 9  # conv1's int8 weights, then b1, GN2's pair and conv2's
    rest[i], rest[i + 4] = pk(rest[i]), pk(rest[i + 4])
    rest[-3] = t_rb.pack_skip_int8(rest[-3])
    asked = []

    def xq_offset(name, *a):
        asked.append((name, a))
        return 256

    def workspace(name, *a):
        sizes.append((name, a))
        return 1 << 20

    monkeypatch.setattr(_build, "xq_offset", xq_offset)
    monkeypatch.setattr(_build, "workspace_bytes", workspace)
    bufs = {}
    out = fn(*xs, *rest, **kw, skip_buffers=bufs)
    name, a = asked[0]
    assert name == calls[0][0] and sizes[0] == (name, a)
    b, h, w, cout = out.shape
    assert list(bufs) == ["xq"]
    assert bufs["xq"].dtype == torch.int8 and bufs["xq"].shape == (b, h, w, x_skip.shape[-1])
    base = bufs["xq"].untyped_storage().data_ptr()
    assert bufs["xq"].data_ptr() - base == 256


def test_static_skip_gemm_is_counted_in_c():
    src = (_build._CSRC / "conv.cuh").read_text()
    i = t_rb.BLOCK_COUNTED.index("block_gemm_kernel<int8, static skip>")
    assert f"COUNT_STATIC_SKIP = {i}," in src and f"N_COUNTED = {len(t_rb.BLOCK_COUNTED)}" in src


@pytest.mark.parametrize("b", [4, 16, 64])
@pytest.mark.parametrize("h,cin,cout", [(32, 128, 128), (16, 128, 256), (16, 384, 256),
                                        (32, 384, 128), (8, 512, 256), (4, 512, 256)])
def test_skip_plan_takes_the_skip_shapes_unsplit(b, h, cin, cout):
    """conv2's plan at every skip shape of the int8 blocks: its K split is
    the conv slices' own (each split's conv partial as without the skip),
    every int8 skip slice falls in one split, the last, and the ring with
    the parked conv sums of the skip's phase fits the H100's 227 KB (two
    CTAs an SM at 128-pixel tiles)."""
    plan = t_rb.s8_tile_plan(b, h, h, cout, 0, cout)
    slices = t_rb.static_skip_slices(plan, cin)
    assert [c for c, _ in slices] == [min(plan.kper, plan.conv_slices - z * plan.kper)
                                      for z in range(plan.splits)]
    assert all(c > 0 for c, _ in slices) and sum(c for c, _ in slices) == plan.conv_slices
    assert [k for _, k in slices] == [0] * (plan.splits - 1) + [cin // t_rb.S8_SLICE]
    # csrc/block_gemm.cu's Tile<MW>: 3 stages at mw 1, 4 at mw 2, each 128 * mw
    # pixel rows and a 128 x 128 weight box of 128 bytes a row
    stages = 3 if plan.mw == 1 else 4
    stage = (128 * plan.mw + 128) * 128
    smem = stages * stage + 1024 + 2 * stages * 8
    park = 256 * 64 * plan.mw * 4  # each consumer thread's f32 conv sums
    assert park <= (stages - 1) * stage  # the stages the skip's slices leave alone
    assert smem <= 227 * 1024 and (plan.mw == 2 or 2 * (smem + 1024) <= 228 * 1024)


# --------------------------------------------------------------------------
# (d) the kernels on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(args, dev):
    return [None if a is None else torch.from_numpy(a).to(dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,cin,cout", [("K2", 16, 128, 256), ("K3", 16, 384, 256),
                                             ("K4", 16, 256, 256), ("K9-up", 8, 256, 256),
                                             ("K9-down", 16, 128, 128),
                                             ("K9-down", 64, 128, 128)])
def test_static_skip_kernel_matches_plain(cuda, kind, h, cin, cout):
    """K9 down at 64x64x128 takes GN1's two-launch route (its resample kernel
    writes q(xr)); the other transitions the one-launch route. The block's
    own q(x) (skip_buffers) bit for bit against the plain static skip's on
    the same f32 skip input."""
    d = Draw(40)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), (ws, bs) = _block(d, h, cin, cout)
    x = torch.from_numpy(x).to(cuda).bfloat16()
    temb, dw, db, b1, b2, bs = _on([temb, dw, db, b1, b2, bs], cuda)
    g1, g2 = _on(g1, cuda), _on(g2, cuda)
    pk = lambda w: t_rb.pack_int8_weight(tuple(t.to(cuda) for t in _q(w)))  # noqa: E731
    wsq = t_rb.pack_skip_int8(tuple(t.to(cuda) for t in _q(ws)))
    s = _scales(A1, A2, AX).to(cuda)
    bufs = {}
    with torch.no_grad():
        if kind in ("K2", "K3"):
            fused, plain = ((t_rb.fused_resblock_int8, t_rb.resblock_int8_reference)
                            if kind == "K2" else
                            (t_rb.fused_resblock_pair_int8, t_rb.resblock_pair_int8_reference))
            xs = (x,) if kind == "K2" else (x[..., :128].contiguous(), x[..., 128:].contiguous())
            args = (temb, dw, db, *g1, pk(w1), b1, *g2, pk(w2), b2, wsq, bs, s)
            kw = dict(num_groups1=32, num_groups2=32)
            out = fused(*xs, *args, **kw, skip_buffers=bufs)
            ref = plain(*(t.float() for t in xs), *args, **kw)
            x_skip = x.float()
        elif kind == "K4":
            x_skip = torch.from_numpy(d.act(2, h, h, cin)).to(cuda).bfloat16()
            args = (temb, dw, db, pk(w1), b1, *g2, pk(w2), b2, wsq, bs, s)
            out = t_rb.fused_resblock_tail_int8(x, x_skip, *args, num_groups2=32,
                                                skip_buffers=bufs)
            ref = t_rb.resblock_tail_int8_reference(x.float(), x_skip.float(), *args,
                                                    num_groups2=32)
            x_skip = x_skip.float()
        else:
            args = (temb, dw, db, *g1, pk(w1), b1, *g2, pk(w2), b2, wsq, bs, s)
            kw = dict(up=kind == "K9-up", num_groups1=32, num_groups2=32)
            out = t_rb.fused_resblock_transition_int8(x, *args, **kw, skip_buffers=bufs)
            ref = t_rb.resblock_transition_int8_reference(x.float(), *args, **kw)
            x_skip = t_rb.resample_transition(x.float(), t_rb.transition_kerns(kw["up"], True),
                                              kw["up"])
    assert out.dtype == torch.bfloat16
    assert rel_err(out.float().cpu(), ref.float().cpu()) <= KERNEL_BOUND
    assert torch.equal(bufs["xq"], t_rb.quant_static(x_skip, s[2]).to(torch.int8))
