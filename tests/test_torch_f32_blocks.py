"""The residual and attention blocks on f32 activations (K2/K3/K4/K9 and
K5 with f32 x and out, bf16 MMA operands: ``model.dtype = float32`` with
``conv_impl='fused'``, and K10's forward) on the CPU:

(a) the plain versions with the TPU kernels' rounding points
    (``resblock_bf16_reference`` and its pair, tail and transition forms,
    ``attnblock_bf16_reference``) on unrounded f32 x against the JAX
    package's kernels with ``mm_dtype=jnp.bfloat16`` on the same f32 x, in
    interpret mode;
(b) the wrappers' C calls on f32 x (``_build.launch`` replaced): the bf16
    modes' entries with act_f32 set, GN1's two-launch route, the skip's
    bf16 copy in the workspace.

Cases marked ``cuda`` hold the kernels against those plain versions and
the f32 plain composition on the card, and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import resblock as t_rb

TEMB = 16


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    runs the ``cuda`` cases with ``pytest --noconftest -m cuda``)."""
    import jax.numpy as jnp
    from gddim_tpu.ops import attnblock, resblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jnp=jnp, rb=resblock, attn=attnblock, pltpu=pltpu)


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


def _temb_proj(temb, w, b):
    t = temb.astype(np.float64)
    return ((t / (1 + np.exp(-t))) @ w + b).astype(np.float32)


def _t(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


# --------------------------------------------------------------------------
# (a) the rounding points on f32 x against the JAX kernels
# --------------------------------------------------------------------------

# max|port - JAX| / max|JAX|: the same roundings (the MMA operands a1, a2,
# the weights, the skip's x, K5's h, q/k/v, p and a rounded to bf16; x, h1,
# the residual and out f32), f32 sums in another order, which flip a bf16
# rounding now and then. The bf16-input bounds of tests/test_torch_bf16_gemm.py
# (5e-4, blocks), tests/test_torch_transition.py (1e-2, K9) and
# tests/test_torch_attnblock.py (8e-4, K5) hold here too.
REL = {"K2": 5e-4, "K3": 5e-4, "K4": 5e-4, "K9": 1e-2, "K5": 8e-4}

# (kind, H, Cin parts, Cout, skip) at a small width, B=2
CASES = {"K2": (8, (64,), 64, False), "K2-skip": (8, (64,), 128, True),
         "K3": (8, (64, 32), 64, True), "K4": (8, (64,), 128, True),
         "K9-up": (4, (128,), 128, True), "K9-down": (8, (128,), 128, True),
         "K5": (8, (128,), 128, False)}


def block_args(d, kind, h, parts, cout, skip):
    cin = sum(parts)
    xs = [d.act(2, h, h, c) for c in parts]
    if kind == "K4":  # h (silu(GN1(x)) resampled, here any f32 map) and the resampled x
        xs = [d.act(2, h, h, cin), d.act(2, h, h, cin)]
    temb = [d.act(2, TEMB), d.w(TEMB, cout), d.vec(cout)]
    gn1 = [] if kind == "K4" else [d.vec(cin, 1.0), d.vec(cin)]
    body = [d.w(3, 3, cin, cout), d.vec(cout), d.vec(cout, 1.0), d.vec(cout),
            d.w(3, 3, cout, cout), d.vec(cout)]
    sk = [d.w(cin, cout), d.vec(cout)] if skip else [None, None]
    return xs, temb, gn1 + body + sk


@pytest.mark.parametrize("seed", [74, 75])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rounding_points_on_f32_x_match_jax_bf16_kernels(jx, case, seed):
    kind = case.split("-")[0]
    h, parts, cout, skip = CASES[case]
    d = Draw(seed)
    bf16 = jx.jnp.bfloat16
    j = lambda args: [None if a is None else jx.jnp.asarray(a) for a in args]  # noqa: E731
    if kind == "K5":
        c = parts[0]
        args = [d.act(2, h, h, c), d.vec(c, 1.0), d.vec(c)]
        for _ in range(4):
            args += [d.w(c, c), d.vec(c)]
        kw = dict(num_groups=32, skip_rescale=True)
        with jx.pltpu.force_tpu_interpret_mode():
            want = np.asarray(jx.attn.fused_attnblock(*j(args), mm_dtype=bf16, **kw))
        got = t_attn.attnblock_bf16_reference(*_t(args), **kw)
    else:
        xs, temb, rest = block_args(d, kind, h, parts, cout, skip)
        cin = sum(parts)
        kw = dict(num_groups2=min(cout // 4, 32))
        if kind != "K4":
            kw["num_groups1"] = min(cin // 4, 32)
        jargs = j(xs + [_temb_proj(*temb)] + rest)
        with jx.pltpu.force_tpu_interpret_mode():
            if kind == "K9":
                kw.update(up=case.endswith("up"), fir=True)
                want = jx.rb.fused_resblock_transition(*jargs, mm_dtype=bf16, **kw)
            elif kind == "K4":
                want = jx.rb.fused_resblock_tail(*jargs, mm_dtype=bf16, **kw)
            elif kind == "K3":
                want = jx.rb.fused_resblock_pair(*jargs, mm_dtype=bf16, **kw)
            else:
                want = jx.rb.fused_resblock(*jargs, mm_dtype=bf16, **kw)
        want = np.asarray(want)
        plain = {"K2": t_rb.resblock_bf16_reference, "K3": t_rb.resblock_pair_bf16_reference,
                 "K4": t_rb.resblock_tail_bf16_reference,
                 "K9": t_rb.resblock_transition_bf16_reference}[kind]
        got = plain(*_t(xs + temb + rest), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.dtype == np.float32
    assert rel_err(got, want) <= REL[kind]


# --------------------------------------------------------------------------
# (b) the wrappers' C calls on f32 x
# --------------------------------------------------------------------------


@pytest.fixture
def glue(monkeypatch):
    """The CUDA wrappers on CPU tensors with ``_build.launch`` replaced by a
    recorder, and the workspace sizes by their arguments."""
    calls, spaces = [], []

    def launch(name, device, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[name]), name
        calls.append((name, args))

    def workspace(name, *args):
        spaces.append((name, args))
        return 256

    def operand(t, what, dtype, shape=None):
        return None if t is None else t.to(dtype).contiguous()

    def temb_row(temb, dense_w, dense_b, b, n):
        row = t_rb.temb_projection(temb, dense_w, dense_b).contiguous()
        return row, row.stride(0)

    for mod in (t_rb, t_attn):
        monkeypatch.setattr(mod, "_on_cpu", lambda x, what: False)
        monkeypatch.setattr(mod, "_operand", operand)
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches"):
                monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(t_rb, "_temb_row", temb_row)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "workspace_bytes", workspace)
    t_rb._plan_gemm.cache_clear()
    yield calls, spaces
    t_rb._plan_gemm.cache_clear()  # it cached the stand-in workspace sizes


def test_f32_blocks_take_the_bf16_entries_with_act_f32(glue):
    """K2 (identity and 1x1 skip), K3, K4, K9 and K5 on f32 x: the bf16
    modes' entries with act_f32 1 and GN1's two-launch route (gn_ctas 0);
    the workspace holds the skip's bf16 copy (xs = its channels)."""
    calls, spaces = glue
    d = Draw(3)
    f = lambda *s: torch.from_numpy(d.act(*s))  # noqa: E731
    kw = dict(num_groups1=32, num_groups2=32)

    def block(cin, cout, skip):
        return [f(2, TEMB), f(TEMB, cout), f(cout), f(cin), f(cin), f(3, 3, cin, cout), f(cout),
                f(cout), f(cout), f(3, 3, cout, cout), f(cout),
                *((f(cin, cout), f(cout)) if skip else (None, None))]

    t_rb.fused_resblock(f(2, 8, 8, 128), *block(128, 128, False), **kw)
    # a strided x: its one contiguous copy is conv1's input and the skip's
    t_rb.fused_resblock(f(2, 8, 16, 128)[:, :, ::2], *block(128, 256, True), **kw)
    t_rb.fused_resblock_pair(f(2, 8, 8, 128), f(2, 8, 8, 64), *block(192, 128, True), **kw)
    b = block(128, 128, True)
    t_rb.fused_resblock_tail(f(2, 8, 8, 128), f(2, 8, 8, 128), *b[:3], *b[5:], num_groups2=32)
    t_rb.fused_resblock_transition(f(2, 8, 8, 128), *block(128, 128, True), up=False, **kw)
    w = t_attn.pack_attn_weights(*[f(128, 128) if i % 2 == 0 else f(128) for i in range(8)])
    t_attn.fused_attnblock_packed(f(2, 8, 8, 128), f(128), f(128), w, num_groups=32)
    names = [n for n, _ in calls]
    assert names == ["gddim_resblock"] * 4 + ["gddim_resblock_transition", "gddim_attnblock"]
    assert [a[4] for _, a in calls[:4]] == [1] * 4  # act_f32
    assert calls[4][1][2] == 1 and calls[5][1][1] == 1
    assert [a[-2] for _, a in calls] == [0] * 6  # GN1: gn_stats_kernel and the pre-pass
    # the skip parts of K2 and K3 are their input parts (s0, s1 = x0, x1)
    assert [a[17:19] for _, a in calls[1:3]] == [a[0:2] for _, a in calls[1:3]]
    xs = [a[-1] for n, a in spaces if n == "gddim_resblock"]
    assert xs == [0, 128, 192, 128]  # the skip's channels (K2 identity: none)
    assert [n for n, _ in spaces][-1] == "gddim_resblock_transition"


def test_bf16_blocks_keep_their_route(glue):
    """The same calls on bf16 x: act_f32 0, GN1 in one launch, no skip copy."""
    calls, spaces = glue
    d = Draw(4)
    f = lambda *s: torch.from_numpy(d.act(*s))  # noqa: E731
    x = f(2, 8, 8, 128).bfloat16()
    t_rb.fused_resblock(x, f(2, TEMB), f(TEMB, 256), f(256), f(128), f(128), f(3, 3, 128, 256),
                        f(256), f(256), f(256), f(3, 3, 256, 256), f(256), f(128, 256), f(256),
                        num_groups1=32, num_groups2=32)
    ((name, a),) = calls
    assert name == "gddim_resblock" and a[4] == 0 and a[-2] == t_rb.gn_apply_ctas(8, 8, 128)
    assert spaces[0][1][-1] == 0


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


# chip_smoke.py's F32_ACT_BOUND (against the f32 plain composition) and
# F32_TPU_BOUND (against the rounding points)
F32_ACT_BOUND = 4e-3
F32_TPU_BOUND = 2e-3
# CASES at the widths the block GEMM takes (Cout in 128-channel tiles)
CARD_CASES = {"K2": (8, (128,), 128, False), "K2-skip": (8, (128,), 256, True),
              "K3": (8, (128, 64), 128, True), "K4": (8, (128,), 128, True),
              "K9-up": (4, (128,), 128, True), "K9-down": (8, (128,), 128, True),
              "K5": (8, (128,), 128, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 64])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_f32_block_kernels_match_plain(cuda, case, batch):
    """The bf16 modes on f32 x on the block GEMM: f32 out within the bounds
    of their rounding-point and f32 plain versions, the same bits on
    repeat."""
    kind = case.split("-")[0]
    h, parts, cout, skip = CARD_CASES[case]
    d = Draw(76)
    if kind == "K5":
        c = parts[0]
        args = [d.act(batch, h, h, c), d.vec(c, 1.0), d.vec(c)]
        for _ in range(4):
            args += [d.w(c, c), d.vec(c)]
        kw = dict(num_groups=32, skip_rescale=True)
        ops = (t_attn.fused_attnblock, t_attn.attnblock_bf16_reference, t_attn.attnblock_reference)
    else:
        xs, temb, rest = block_args(d, kind, h, parts, cout, skip)
        xs = [np.repeat(x, batch // 2, axis=0) for x in xs]
        temb[0] = np.repeat(temb[0], batch // 2, axis=0)
        args = xs + temb + rest
        kw = dict(num_groups2=32)
        if kind != "K4":
            kw["num_groups1"] = 32
        if kind == "K9":
            kw["up"] = case.endswith("up")
        ops = {"K2": (t_rb.fused_resblock, t_rb.resblock_bf16_reference, t_rb.resblock_reference),
               "K3": (t_rb.fused_resblock_pair, t_rb.resblock_pair_bf16_reference,
                      t_rb.resblock_pair_reference),
               "K4": (t_rb.fused_resblock_tail, t_rb.resblock_tail_bf16_reference,
                      t_rb.resblock_tail_reference),
               "K9": (t_rb.fused_resblock_transition, t_rb.resblock_transition_bf16_reference,
                      t_rb.resblock_transition_reference)}[kind]
    ts = [None if a is None else torch.from_numpy(a).to(cuda) for a in args]
    with torch.no_grad():
        out = ops[0](*ts, **kw)
        again = ops[0](*ts, **kw)
        tpu, plain = ops[1](*ts, **kw), ops[2](*ts, **kw)
    assert out.dtype == torch.float32 and out.shape == plain.shape and torch.equal(out, again)
    rel = lambda r: ((out - r).abs().max() / r.abs().max()).item()  # noqa: E731
    assert rel(tpu) <= F32_TPU_BOUND and rel(plain) <= F32_ACT_BOUND
