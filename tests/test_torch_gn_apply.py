"""GN1 in one launch (``gn_apply_kernel``, csrc/gn_apply.cu): the wrappers'
plain versions, the route function and the C bindings, on the CPU:

(a) ``gn_apply_reference`` (GN1's statistics and its conv input as the
    pre-pass makes it) against the JAX package's GN + SiLU of a sample
    (``gddim_tpu/ops/resblock.py:_gn_silu_2d``) at every GroupNorm shape of
    the sampling path, two seeds, f32 and bf16 x: bf16 values at most one
    ulp apart on at most 1e-3 of them; int8 (static, and per sample by the
    JAX package's own quantizers) at most one step apart on at most 1e-3;
(b) ``gn_resample_reference`` (K9's GN1 + SiLU rounded to bf16, then the
    resample) composed with the rest of the block against
    ``gddim_tpu.ops.resblock.fused_resblock_transition`` in interpret mode,
    up and down, bf16 and int8 (static and per sample);
(c) the route: every main-path GN1 site and transition takes the one-launch
    kernel; f32 activations and shares too large for shared memory take the
    two launches; the resample variant's rows cover what each CTA sums and
    reads;
(d) every C entry point's arguments against ``_build._SIGNATURES``, and the
    CUDA wrappers' arguments against the entry they call (``_build.launch``
    replaced), the new ``gn_ctas`` among them;
(e) the wrappers on CPU tensors run their plain versions.

Cases marked ``cuda`` hold the kernel against its plain version on the card
(statistics 1e-6, outputs one ulp or step on at most 1e-3 of the values, the
same bits on repeat and as the launches it replaces), and skip without one.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import resblock as t_rb

EPS = 1e-6
STATS_REL = 1e-6
# (a) share of bf16 / int8 values that may differ by one ulp or step: the
# folded affine (x * a + (beta - mean * a), the kernels') against the JAX
# package's centred one ((x - mean) * rstd * gamma + beta) moves a value by
# f32 roundings, which flip a bf16 or int8 rounding now and then (measured
# at most 1.2e-4 of the values, 2 of 16,384 at 4x4x512)
FLIP_SHARE = 1e-3
# (a) bf16 values under 2^-6 in magnitude are compared at the ulp of 2^-6:
# near an output's zero the two affines' f32 difference (~1e-7) is several
# ulps of the tiny value itself (measured up to 48 such ulps; at most one at
# this floor)
ULP_FLOOR = 2.0 ** -6
# (b) the block on gn_resample_reference's h against the JAX kernel: bf16
# the transition tests' own bound (tests/test_torch_transition.py, BF16_REL;
# measured at most 5.7e-4 here); int8, one value of q(h) that rounds the
# other way under the folded affine moves the output by up to ~3e-3 of its
# largest value (measured 2.8e-3 once, else 2e-7), held to the K9 int8
# kernel's gate (chip_smoke.py, KERNEL_BOUND["K9-int8"])
BLOCK_BF16_REL = 1e-2
BLOCK_INT8_REL = 1e-2
TEMB = 16

# (H, C) of every GroupNorm of the sampling path (tests/test_torch_gn_stats.py)
GN_SHAPES = [(32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384), (16, 512),
             (8, 256), (8, 512), (4, 256), (4, 512)]
# the GN1 sites of cld/accr_dcifar10's sampling path: (H, channel parts)
# of the K2 and K3 blocks' conv1 input, and the attention blocks' GN
GN1_SITES = [(32, (128,)), (16, (128,)), (16, (256,)), (8, (256,)), (4, (256,)),
             (4, (256, 256)), (8, (256, 256)), (16, (256, 256)), (16, (256, 128)),
             (32, (256, 128)), (32, (128, 128))]
# (H_in, C, up) of its 6 transitions
TRANSITIONS = [(32, 128, False), (16, 256, False), (8, 256, False), (4, 256, True),
               (8, 256, True), (16, 256, True)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    runs the ``cuda`` cases with ``pytest --noconftest -m cuda``)."""
    import jax.numpy as jnp
    from gddim_tpu.ops import groupnorm, resblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jnp=jnp, gn=groupnorm, rb=resblock, pltpu=pltpu)


def _operands(seed, b, h, c, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, c)) * 1.5 + rng.standard_normal(c)
    x = torch.tensor(x, dtype=torch.float32).to(dtype)
    gamma = torch.tensor(1.0 + 0.1 * rng.standard_normal(c), dtype=torch.float32)
    beta = torch.tensor(0.1 * rng.standard_normal(c), dtype=torch.float32)
    return x, gamma, beta


def bf16_ulps(got, ref, floor=0.0):
    """|got - ref| in bf16 ulps of max(|ref|, floor)."""
    r = ref.float()
    m = torch.maximum(r.abs(), torch.full_like(r, floor))
    return (got.float() - r).abs() / torch.ldexp(torch.ones_like(r), torch.frexp(m)[1] - 8)


def _jax_gn_silu(jx, x, gamma, beta, groups):
    """_gn_silu_2d of each sample of (B, H, W, C) x, f32 (B, H, W, C) numpy."""
    b, h, w, c = x.shape
    xf = jx.jnp.asarray(x.float().numpy()).reshape(b, h * w, c)
    pmat = jx.gn._group_indicator(c, groups)
    inv_n = 1.0 / (h * w * (c // groups))
    g, bt = jx.jnp.asarray(gamma.numpy())[None], jx.jnp.asarray(beta.numpy())[None]
    return np.stack([np.asarray(jx.rb._gn_silu_2d(xf[s], pmat, g, bt, inv_n, EPS))
                     for s in range(b)]).reshape(x.shape)


# --------------------------------------------------------------------------
# (a) the convert variant's plain version against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,c", GN_SHAPES, ids=[f"{h}x{h}x{c}" for h, c in GN_SHAPES])
def test_gn_apply_reference_bf16_matches_jax_gn_silu(jx, h, c, seed, dtype):
    x, gamma, beta = _operands(100 * seed + 7 * h + c, 2, h, c, dtype)
    groups = min(c // 4, 32)
    a, stats, amax = t_rb.gn_apply_reference(x, None, gamma, beta, num_groups=groups, eps=EPS)
    assert a.dtype == torch.bfloat16 and a.shape == x.shape and amax is None
    want = torch.from_numpy(_jax_gn_silu(jx, x, gamma, beta, groups)).to(torch.bfloat16)
    d = bf16_ulps(a, want, ULP_FLOOR)
    assert d.max().item() <= 1.0
    assert (d > 0).float().mean().item() <= FLIP_SHARE
    # the statistics are gn_stats_reference's
    for got, ref in zip(stats, t_rb.gn_stats_reference(x, groups, EPS, gamma, beta)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,c", GN_SHAPES, ids=[f"{h}x{h}x{c}" for h, c in GN_SHAPES])
def test_gn_apply_reference_int8_matches_jax_quantizers(jx, h, c, seed, mode):
    """int8 by a static scale (``_quant_2d_static``) or per sample
    (``_quant_2d``) of the JAX package's GN + SiLU: one step at most, on at
    most FLIP_SHARE of the values; the per-sample amax within 1e-6."""
    x, gamma, beta = _operands(100 * seed + 7 * h + c, 2, h, c, torch.bfloat16)
    groups = min(c // 4, 32)
    s = t_rb.act_scales_from_amax((4.0,))[0] if mode == "static" else None
    q, _, amax = t_rb.gn_apply_reference(x, None, gamma, beta, num_groups=groups, eps=EPS,
                                         int8=True, act_scale=s)
    assert q.dtype == torch.int8 and q.shape == x.shape
    want = _jax_gn_silu(jx, x, gamma, beta, groups)
    jnp = jx.jnp
    if mode == "static":
        wq = [jx.rb._quant_2d_static(jnp.asarray(want[i].reshape(-1, c)), float(1.0 / s))
              for i in range(2)]
        assert amax is None
    else:
        wq = [jx.rb._quant_2d(jnp.asarray(want[i].reshape(-1, c)))[0] for i in range(2)]
        wam = np.abs(want).reshape(2, -1).max(1)
        assert np.abs(amax.numpy() - wam).max() / wam.max() <= STATS_REL
    d = (q.int() - torch.from_numpy(np.stack([np.asarray(t) for t in wq]).reshape(q.shape)).int())
    assert d.abs().max().item() <= 1
    assert (d != 0).float().mean().item() <= FLIP_SHARE


def test_gn_apply_reference_pair_is_the_concat():
    """The pair's two inputs (K3) by logical channel: the reference of the
    concat, with the pair's per-sample form a * (127 / amax)."""
    xa, gamma, beta = _operands(3, 2, 8, 384, torch.bfloat16)
    a_cat = t_rb.gn_apply_reference(xa, None, gamma, beta, num_groups=32, int8=True,
                                    inv_mul=True)
    a_two = t_rb.gn_apply_reference(xa[..., :256], xa[..., 256:], gamma, beta, num_groups=32,
                                    int8=True, inv_mul=True)
    assert torch.equal(a_cat[0], a_two[0]) and torch.equal(a_cat[2], a_two[2])


# --------------------------------------------------------------------------
# (b) the resample variant's plain version in K9 against the JAX kernel
# --------------------------------------------------------------------------


def _draw(rng, *shape, w=False, base=None):
    if base is not None:
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    t = rng.standard_normal(shape)
    return (t / np.sqrt(np.prod(shape[:-1])) if w else t).astype(np.float32)


@pytest.mark.parametrize("mode", ["bf16", "static", "dynamic"])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_gn_resample_reference_in_k9_matches_jax_kernel(jx, up, mode):
    """B=2, H=8, C=128: the block from gn_resample_reference's h and xr (the
    rest as K9's plain versions run it) against fused_resblock_transition in
    interpret mode, mm_dtype bf16 or int8 (static scales under the
    activations' range, or per sample)."""
    rng = np.random.default_rng(40 + up)
    b, h, c = 2, 8, 128
    x, temb = _draw(rng, b, h, h, c), _draw(rng, b, TEMB)
    dw, db = _draw(rng, TEMB, c, w=True), _draw(rng, c, base=0.0)
    g1s, g1b = _draw(rng, c, base=1.0), _draw(rng, c, base=0.0)
    w1, b1 = _draw(rng, 3, 3, c, c, w=True), _draw(rng, c, base=0.0)
    g2s, g2b = _draw(rng, c, base=1.0), _draw(rng, c, base=0.0)
    w2, b2 = _draw(rng, 3, 3, c, c, w=True), _draw(rng, c, base=0.0)
    ws, bs = _draw(rng, c, c, w=True), _draw(rng, c, base=0.0)
    t64 = temb.astype(np.float64)
    tp = ((t64 / (1 + np.exp(-t64))) @ dw + db).astype(np.float32)
    jnp = jx.jnp
    mm = jnp.bfloat16 if mode == "bf16" else jnp.int8
    js = tuple(jx.rb.act_scales_from_amax((1.5, 2.0))) + (None,) if mode == "static" else None
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jx.rb.fused_resblock_transition(
            *[jnp.asarray(a) for a in (x, tp, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs)],
            up=up, fir=True, num_groups1=32, num_groups2=32, mm_dtype=mm, act_scales=js))
    T = torch.from_numpy
    hh, xr, amax = t_rb.gn_resample_reference(T(x), T(g1s), T(g1b), up=up, num_groups=32,
                                              eps=EPS, mode="bf16" if mode == "bf16" else "f32")
    ho = 2 * h if up else h // 2
    assert hh.shape == xr.shape == (b, ho, ho, c) and xr.dtype == torch.bfloat16
    if mode == "bf16":
        got = t_rb._bf16_block(hh.float(), xr, T(tp), T(w1), T(b1), T(g2s), T(g2b), T(w2),
                               T(b2), T(ws), T(bs), 32, EPS, True, torch.float32, False)
        bound = BLOCK_BF16_REL
    else:
        assert torch.equal(amax, hh.abs().amax(dim=(1, 2, 3)))
        ts = torch.stack(t_rb.act_scales_from_amax((1.5, 2.0))) if mode == "static" else None
        got = t_rb._int8_block(hh, xr, T(tp), t_rb.quantize_weight(T(w1)), T(b1), T(g2s),
                               T(g2b), t_rb.quantize_weight(T(w2)), T(b2), T(ws), T(bs), ts, 32,
                               EPS, True, torch.float32, pair=False, fold2=False)
        bound = BLOCK_INT8_REL
    rel = np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert rel <= bound


@pytest.mark.parametrize("hin,c,up", TRANSITIONS)
def test_gn_resample_reference_int8_is_the_pre_pass_of_f32_h(hin, c, up):
    """The static mode's q(h) (the kernel writes it in place of K9's conv1
    pre-pass) is the int8 pre-pass's quantizer of the f32 h."""
    x, gamma, beta = _operands(hin + c, 2, hin, c, torch.bfloat16)
    s = t_rb.act_scales_from_amax((4.0,))[0]
    kw = dict(up=up, num_groups=32, eps=EPS)
    q, xr, _ = t_rb.gn_resample_reference(x, gamma, beta, mode="int8", act_scale=s, **kw)
    h, xr32, amax = t_rb.gn_resample_reference(x, gamma, beta, mode="f32", **kw)
    assert torch.equal(q, t_rb.quantize_conv_input_reference(h, act_scale=s))
    assert torch.equal(xr, xr32)
    hb, _, _ = t_rb.gn_resample_reference(x, gamma, beta, mode="bf16", **kw)
    assert torch.equal(hb, h.to(torch.bfloat16))


# --------------------------------------------------------------------------
# (c) the route
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,parts", GN1_SITES, ids=[f"{h}x{h}x{'+'.join(map(str, p))}"
                                                    for h, p in GN1_SITES])
def test_every_main_path_gn1_site_takes_one_launch(h, parts):
    c = sum(parts)
    assert t_rb.gn_apply_ctas(h, h, c) == 8
    assert t_rb.gn_apply_ctas(h, h, c, f32=True) == 0  # f32 activations: two launches
    # two CTAs share an SM: the largest share (32x32x384) fits twice in 228 KB
    assert 2 * (t_rb.gn_apply_smem(c, -(-(h * h) // 8)) + 1024) <= 228 * 1024


@pytest.mark.parametrize("hin,c,up", TRANSITIONS)
def test_every_transition_takes_one_launch(hin, c, up):
    assert t_rb.gn_resample_ctas(hin, hin, c, up) == 8
    assert t_rb.gn_resample_ctas(hin, hin, c, up, f32=True) == 0


def test_route_refuses_what_does_not_fit():
    # an eighth of 32x32x1024 bf16 (256 KB) does not fit a CTA: two launches
    assert t_rb.gn_apply_ctas(32, 32, 1024) == 0
    assert t_rb.gn_apply_ctas(32, 32, 512) == 8  # an eighth of 1 MB does
    # larger shares, and widths the statistics do not take
    assert t_rb.gn_apply_ctas(32, 32, 2048) == 0
    assert t_rb.gn_apply_ctas(64, 64, 1024) == 0
    assert t_rb.gn_apply_ctas(8, 8, 4096) == 0
    assert t_rb.gn_apply_ctas(8, 8, 260) == 0
    assert t_rb.gn_resample_ctas(128, 128, 512, False) == 0
    assert t_rb.gn_resample_ctas(9, 8, 128, True) == 0  # odd H


def _rows_of(hin, win, up, ctas, r):
    """rs_rows of csrc/gn_apply.cu in Python: (held rows, activated rows,
    output rows) of CTA r."""
    hw, units = hin * win, hin if up else hin // 2
    p0, p1 = hw * r // ctas, hw * (r + 1) // ctas
    lo, hi = p0 // win, -(-p1 // win)
    u0, u1 = units * r // ctas, units * (r + 1) // ctas
    if u1 <= u0:
        return (lo, hi), (0, 0), (0, 0)
    nlo, nhi = max(u0 - 1 if up else 2 * u0 - 1, 0), min(u1 + 1 if up else 2 * u1 + 1, hin)
    outs = (2 * u0, 2 * u1) if up else (u0, u1)
    return (min(lo, nlo), max(hi, nhi)), (nlo, nhi), outs


@pytest.mark.parametrize("hin,c,up", TRANSITIONS + [(16, 128, True), (64, 128, False)])
def test_resample_rows_cover_each_ctas_sums_and_taps(hin, c, up):
    """Each CTA holds the rows of its statistics share and every input row
    its outputs' taps read; the outputs cover the image once; the held rows
    are what gn_apply_smem sizes."""
    ctas, hw = 8, hin * hin
    ho = 2 * hin if up else hin // 2
    k = (1.0, 1.0, 1.0, 1.0)
    seen, most = [], 0
    for r in range(ctas):
        (lo, hi), (nlo, nhi), (o0, o1) = _rows_of(hin, hin, up, ctas, r)
        assert lo * hin <= hw * r // ctas and hw * (r + 1) // ctas <= hi * hin
        for yo in range(o0, o1):
            taps = ([yo // 2 - 1, yo // 2] if yo % 2 == 0 else [yo // 2, yo // 2 + 1]) if up \
                else [2 * yo - 1, 2 * yo, 2 * yo + 1, 2 * yo + 2]
            assert all(nlo <= t < nhi for t in taps if 0 <= t < hin), (r, yo, k)
        assert lo <= nlo <= nhi <= hi or nlo == nhi
        seen += list(range(o0, o1))
        most = max(most, hi - lo)
    assert sorted(seen) == list(range(ho))
    assert t_rb._resample_rows(hin, hin, up, ctas) == most


# --------------------------------------------------------------------------
# (d) the C bindings
# --------------------------------------------------------------------------

_KIND = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F", ctypes.c_longlong: "L"}


def _c_entries():
    """{name: argument kinds} of every extern "C" definition in csrc/*.cu."""
    src = "".join(p.read_text() for p in sorted((Path(_build.__file__).parent / "csrc")
                                                .glob("*.cu")))
    out = {}
    for m in re.finditer(r"^(?:int|long long)\s+(gddim_\w+)\(([^)]*)\)\s*\{", src, re.M):
        args = [a.strip() for a in m.group(2).replace("\n", " ").split(",") if a.strip()]
        out[m.group(1)] = ["P" if "*" in a else "L" if a.startswith("long long")
                           else "F" if a.startswith("float") else "I" for a in args]
    return out


def test_every_entry_point_matches_its_ctypes_signature():
    entries = _c_entries()
    assert set(entries) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert [_KIND[t] for t in argtypes] == entries[name], name


def _fits(kind, value) -> bool:
    if kind == "P":
        return value is None or isinstance(value, int)
    if kind == "F":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    return isinstance(value, int)


@pytest.fixture
def glue(monkeypatch):
    """The CUDA wrappers on CPU tensors with ``_build.launch`` replaced by a
    recorder that checks each call's arguments against its entry's
    signature: the Python side of every C call, without a card."""
    calls = []

    def launch(name, device, *args):
        kinds = [_KIND[t] for t in _build._SIGNATURES[name]]
        assert len(args) + 1 == len(kinds), (name, len(args) + 1, len(kinds))
        for i, (k, v) in enumerate(zip(kinds, args)):
            assert _fits(k, v), (name, i, k, v)
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

    for mod in (t_rb, t_attn):
        monkeypatch.setattr(mod, "_on_cpu", lambda x, what: False)
        monkeypatch.setattr(mod, "_operand", operand)
        for fn in vars(mod).values():  # the wrappers' launch counts come back after
            if callable(fn) and hasattr(fn, "launches"):
                monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(t_rb, "_temb_row", temb_row)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "workspace_bytes", lambda name, *a: 256)
    yield calls
    t_rb._plan_gemm.cache_clear()  # it cached the stand-in workspace sizes


def _block_args(rng, b, h, cin, cout, skip, int8=False):
    f = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)  # noqa: E731
    conv = lambda *s: t_rb.pack_int8_weight(t_rb.quantize_weight(f(*s))) if int8 \
        else f(*s).bfloat16()  # noqa: E731
    return (f(b, h, h, cin).bfloat16(), f(b, cout), None, None, f(cin), f(cin),
            conv(3, 3, cin, cout), f(cout), f(cout), f(cout), conv(3, 3, cout, cout), f(cout),
            *((f(cin, cout).bfloat16(), f(cout)) if skip else (None, None)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_block_wrappers_pass_the_gn1_route(glue, int8):
    """K2, K3, K9 and K5 hand their entry the route of ops/resblock.py
    (gn_ctas, the argument before out)."""
    rng = np.random.default_rng(5)
    s = torch.stack(t_rb.act_scales_from_amax((4.0, 4.0))) if int8 else None
    x = _block_args(rng, 2, 16, 256, 256, False, int8)
    kw = dict(num_groups1=32, num_groups2=32)
    if int8:
        t_rb.fused_resblock_int8(*x, s, **kw)
        xa = torch.tensor(rng.standard_normal((2, 16, 16, 128)), dtype=torch.bfloat16)
        p = _block_args(rng, 2, 16, 384, 256, True, int8)
        t_rb.fused_resblock_pair_int8(xa, p[0][..., 128:], *p[1:], s, **kw)
        t_rb.fused_resblock_transition_int8(*_block_args(rng, 2, 8, 256, 256, True, int8), s,
                                            up=True, **kw)
    else:
        t_rb.fused_resblock(*x, **kw)
        xa = torch.tensor(rng.standard_normal((2, 16, 16, 128)), dtype=torch.bfloat16)
        p = _block_args(rng, 2, 16, 384, 256, True, int8)
        t_rb.fused_resblock_pair(xa, p[0][..., 128:], *p[1:], **kw)
        t_rb.fused_resblock_transition(*_block_args(rng, 2, 8, 256, 256, True, int8), up=True,
                                       **kw)
    f = lambda *s_: torch.tensor(rng.standard_normal(s_), dtype=torch.float32)  # noqa: E731
    xs = f(2, 16, 16, 256).bfloat16()
    if int8:
        q = [t_attn.pack_projection(t_rb.quantize_weight(f(256, n))) for n in (768, 256)]
        t_attn.fused_attnblock_int8(xs, f(256), f(256), q[0], f(768), q[1], f(256),
                                    torch.stack(t_rb.act_scales_from_amax((4.0, 1.0))),
                                    num_groups=32)
    else:
        w = t_attn.pack_attn_weights(*[f(256, 256) if i % 2 == 0 else f(256) for i in range(8)])
        t_attn.fused_attnblock_packed(xs, f(256), f(256), w, num_groups=32)
    names = [n for n, _ in glue]
    suffix = "_int8" if int8 else ""
    assert names == ["gddim_resblock" + suffix, "gddim_resblock" + suffix,
                     "gddim_resblock_transition" + suffix, "gddim_attnblock" + suffix]
    assert [args[-2] for _, args in glue] == [8, 8, 8, 8]


def test_bare_wrappers_pass_their_arguments(glue):
    x, gamma, beta = _operands(9, 2, 8, 256, torch.bfloat16)
    t_rb.gn_apply(x, None, gamma, beta, num_groups=32)
    t_rb.gn_apply(x[..., :128], x[..., 128:], gamma, beta, num_groups=32, int8=True, inv_mul=True)
    t_rb.gn_apply(x, None, gamma, beta, num_groups=32, int8=True,
                  act_scale=t_rb.act_scales_from_amax((4.0,))[0], ctas=0)
    for mode in t_rb.GN_RESAMPLE_MODES:
        s = t_rb.act_scales_from_amax((4.0,))[0] if mode == "int8" else None
        t_rb.gn_resample(x, gamma, beta, up=False, num_groups=32, mode=mode, act_scale=s)
    t_rb.gn_resample(x, gamma, beta, up=True, num_groups=32, ctas=0)
    assert [n for n, _ in glue] == ["gddim_gn_apply"] * 3 + ["gddim_gn_resample"] * 4
    assert [args[15] for _, args in glue[:3]] == [8, 8, 0]  # ctas
    assert [args[21] for _, args in glue[3:]] == [8, 8, 8, 0]
    with pytest.raises(ValueError):
        t_rb.gn_resample(x, gamma, beta, up=True, num_groups=32, mode="int8",
                         act_scale=t_rb.act_scales_from_amax((4.0,))[0], ctas=0)
    with pytest.raises(ValueError):
        t_rb.gn_apply(x.float(), None, gamma, beta, num_groups=32)


# --------------------------------------------------------------------------
# (e) CPU tensors
# --------------------------------------------------------------------------


def test_wrappers_on_cpu_tensors_run_their_plain_versions():
    x, gamma, beta = _operands(11, 2, 8, 256, torch.bfloat16)
    got = t_rb.gn_apply(x[..., :128], x[..., 128:], gamma, beta, num_groups=32)
    want = t_rb.gn_apply_reference(x[..., :128], x[..., 128:], gamma, beta, num_groups=32)
    assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    h, xr, amax = t_rb.gn_resample(x, gamma, beta, up=True, num_groups=32, mode="f32")
    rh, rxr, ramax = t_rb.gn_resample_reference(x, gamma, beta, up=True, num_groups=32,
                                                mode="f32")
    assert torch.equal(h, rh) and torch.equal(xr, rxr) and torch.equal(amax, ramax)
    assert h.shape == (2, 16, 16, 256)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the kernel's statistics are gn_stats_kernel's (f32 sums in another order
# than the plain version's): chip_smoke.py's GN-stats bound
KERNEL_STATS_REL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "gn", "static", "dynamic"])
@pytest.mark.parametrize("b,h,parts", [(4, 32, (256, 128)), (64, 16, (256,)), (16, 4, (256, 256)),
                                       (2, 32, (512,)), (3, 8, (64,))])
def test_gn_apply_kernel_matches_its_plain_version(cuda, b, h, parts, mode):
    """Statistics within 1e-6 of the plain version's; the output against
    the plain conversion from the kernel's own affine (the pre-pass's gate:
    one ulp or step on at most 1e-3); the same bits on repeat and as the
    launches it replaces (ctas 0). (2, 32, 512): one CTA an SM, the largest
    share."""
    xs = [_operands(20 + h + c, b, h, c, torch.bfloat16)[0].to(cuda) for c in parts]
    c = sum(parts)
    _, gamma, beta = _operands(21, 1, 1, c, torch.float32)
    gamma, beta = gamma.to(cuda), beta.to(cuda)
    x1 = xs[1] if len(xs) > 1 else None
    int8 = mode in ("static", "dynamic")
    kw = dict(num_groups=min(c // 4, 32), eps=EPS, silu=mode != "gn", int8=int8,
              act_scale=t_rb.act_scales_from_amax((4.0,))[0].to(cuda) if mode == "static" else None,
              inv_mul=mode == "dynamic" and x1 is not None)
    with torch.no_grad():
        got = t_rb.gn_apply(xs[0], x1, gamma, beta, **kw)
        again = t_rb.gn_apply(xs[0], x1, gamma, beta, **kw)
        was = t_rb.gn_apply(xs[0], x1, gamma, beta, ctas=0, **kw)
    torch.cuda.synchronize()
    assert t_rb.gn_apply_ctas(h, h, c) == 8
    assert torch.equal(got[0], again[0])
    assert torch.equal(got[0], was[0])  # gn_stats_kernel's share and order
    s = None if kw["act_scale"] is None else kw["act_scale"].cpu()
    ref = t_rb.gn_apply_reference(torch.cat(xs, -1).cpu(), None, gamma.cpu(), beta.cpu(),
                                  **{**kw, "act_scale": s})
    for g, w in zip(got[1], ref[1]):
        assert (g.cpu() - w).abs().max() / w.abs().max() <= KERNEL_STATS_REL
    sc, sh = got[1][0].cpu(), got[1][1].cpu()
    xc = torch.cat(xs, -1).cpu()
    if int8:
        amax = None if got[2] is None else got[2].cpu()
        if amax is not None:
            assert (amax - ref[2]).abs().max() / ref[2].abs().max() <= KERNEL_STATS_REL
        want = t_rb.quantize_conv_input_reference(xc, None, sc, sh, silu=kw["silu"], act_scale=s,
                                                  amax=amax, inv_mul=kw["inv_mul"])
        d = (got[0].cpu().int() - want.int()).abs().float()
    else:
        want = t_rb.bf16_conv_input_reference(xc, None, sc, sh, silu=kw["silu"])
        d = bf16_ulps(got[0].cpu(), want)
    assert d.max().item() <= 1 and (d > 0).float().mean().item() <= FLIP_SHARE


@pytest.mark.cuda
def test_route_functions_reckon_the_launchers_shared_memory(cuda):
    """The route functions' shared memory (gn_apply_smem and _resample_rows,
    a copy of csrc/gn_apply.cu's layout, so that the route is known without
    the build) is the launcher's own (gddim_gn_apply_smem) at every GN1
    site and transition and at shares the route refuses."""
    smem = _build.library().gddim_gn_apply_smem
    for h, c in [(h, sum(p)) for h, p in GN1_SITES] + [(32, 512), (32, 1024), (64, 1024),
                                                         (8, 2048), (7, 64)]:
        assert smem(c, h, h, 0, 0) == t_rb.gn_apply_smem(c, -(-(h * h) // 8)), (h, c)
    for hin, c, up in TRANSITIONS + [(16, 128, True), (64, 128, False), (128, 512, False)]:
        rows = t_rb._resample_rows(hin, hin, up, 8)
        assert smem(c, hin, hin, 1, int(up)) == t_rb.gn_apply_smem(c, rows * hin, True), (hin, c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(t_rb.GN_RESAMPLE_MODES))
@pytest.mark.parametrize("hin,c,up", TRANSITIONS)
def test_gn_resample_kernel_is_the_launches_it_replaces(cuda, hin, c, up, mode):
    """h, xr (and the per-sample amax) the same bits as gn_stats_kernel then
    transition_resample_kernel (and, static, the int8 pre-pass of the f32
    h), and on repeat."""
    x, gamma, beta = (t.to(cuda) for t in _operands(30 + hin, 4, hin, c, torch.bfloat16))
    s = t_rb.act_scales_from_amax((4.0,))[0].to(cuda)
    kw = dict(up=up, num_groups=32, eps=EPS)
    with torch.no_grad():
        got = t_rb.gn_resample(x, gamma, beta, mode=mode, act_scale=s if mode == "int8" else None,
                               **kw)
        again = t_rb.gn_resample(x, gamma, beta, mode=mode,
                                 act_scale=s if mode == "int8" else None, **kw)
        was = t_rb.gn_resample(x, gamma, beta, mode="f32" if mode == "int8" else mode, ctas=0,
                               **kw)
        if mode == "int8":
            was = (t_rb.quantize_conv_input(was[0], act_scale=s), was[1], None)
    torch.cuda.synchronize()
    for a, b_, w in zip(got, again, was):
        assert (a is None) == (w is None)
        if a is not None:
            assert torch.equal(a, b_) and torch.equal(a, w)
