"""The port's int8 inference path (``conv_impl='fused_int8'``) against the
JAX package, on the CPU:

(a) the activation-scale and weight quantizers, bit for bit;
(b) the int8 plain versions of K2-K5, with static and per-sample scales,
    against the JAX package's int8 Pallas kernels in interpret mode;
(c) ``calibrate_cld_qscales`` against the JAX package's on one trajectory;
(d) one eps evaluation of a small network through the int8 path with the
    JAX package's calibration, against ``make_cld_eps_fn`` in interpret mode.

Both sides quantize the same f32 values with the same formulas, so the only
gap is f32 summation order (GroupNorm statistics, the skip product),
which can flip the rounding of a value that sits on a half step. Cases
marked ``cuda`` hold each int8 kernel against its plain version on the card
and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import convert
from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models.calibrate import calibrate_cld_qscales
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import resblock as t_rb


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only: the card's machine,
    which has no JAX, runs the ``cuda`` cases with ``pytest --noconftest -m cuda``."""
    import flax
    import jax
    import jax.numpy as jnp
    from gddim_tpu.configs import get_config as jax_get_config
    from gddim_tpu.math.cld import CLD as JaxCLD
    from gddim_tpu.models import get_model
    from gddim_tpu.models import layers
    from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
    from gddim_tpu.models.calibrate import calibrate_cld_qscales as jax_calibrate
    from gddim_tpu.ops import attnblock, resblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(
        flax=flax, jax=jax, jnp=jnp, get_config=jax_get_config, CLD=JaxCLD,
        get_model=get_model, layers=layers, make_cld_eps_fn=jax_make_cld_eps_fn,
        calibrate=jax_calibrate, attn=attnblock, rb=resblock, pltpu=pltpu)


# (b) rel max|port - JAX| / max|JAX| per block: rounding flips only (a flip
# moves one int8 step of one activation); measured up to 3e-5 here
BLOCK_REL = 2e-3
# (c) every site's amax: both sides run the plain f32 composition
CALIB_REL = 1e-4
# (d) each block of the network on the JAX block's inputs: most agree to
# 3e-7, but a network's blocks see more values than (b)'s, and where one sits
# on a half step its rounding flips: measured 3.5e-4 (ResnetBlockBigGANpp_1)
# and 3.4e-3 (AttnBlockpp_2, where a flipped h moves one token's q, k and v)
NET_BLOCK_REL = 1e-2
# (d) eps with every block's output forced to the JAX block's: the rest of
# the network is the plain f32 path (as tests/test_torch_model.py holds it)
EPS_REL = 1e-4
# (d) eps run free on both sides: about 3x the 5.1e-2 measured here
EPS_FREE_REL = 0.15
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


def _j(jx, args):
    return [None if a is None else jx.jnp.asarray(a) for a in args]


def _temb_proj(temb, w, b):
    t = temb.astype(np.float64)
    return ((t / (1 + np.exp(-t))) @ w + b).astype(np.float32)


def _q(w):
    return t_rb.quantize_weight(torch.from_numpy(w))


# --------------------------------------------------------------------------
# (a) quantizers
# --------------------------------------------------------------------------


def test_act_scales_from_amax_match_jax_bit_for_bit(jx):
    amax = np.random.default_rng(0).lognormal(0.0, 2.0, 64).astype(np.float32)
    amax[:3] = [0.0, 1e-20, 3.0]  # floored at 1e-12, and an exact value
    want = jx.rb.act_scales_from_amax(tuple(amax) + (None,))
    got = t_rb.act_scales_from_amax(tuple(torch.from_numpy(amax)) + (None,))
    assert got[-1] is None and want[-1] is None
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == torch.float32
        assert np.asarray(g).tobytes() == np.asarray(w, np.float32).tobytes()


@pytest.mark.parametrize("shape", [(3, 3, 64, 32), (128, 96), (3, 3, 16, 8)])
def test_quantize_weight_matches_jax_prep_w_bit_for_bit(jx, shape):
    """quantize_weight against the JAX package's prep_w expression
    (gddim_tpu/ops/resblock.py:645-648, the same as attnblock.py:213-215)."""
    w = Draw(1).w(*shape)
    w[..., 0] = 0.0  # an all-zero output channel: the 1e-12 floor
    wm = jx.jnp.asarray(w, jx.jnp.float32)
    sc = jx.jnp.maximum(jx.jnp.abs(wm).max(axis=tuple(range(wm.ndim - 1))), 1e-12) / 127.0
    q = jx.jnp.clip(jx.jnp.round(wm / sc), -127, 127).astype(jx.jnp.int8)
    got_q, got_sc = _q(w)
    assert got_q.dtype == torch.int8 and got_sc.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
    assert got_sc.numpy().tobytes() == np.asarray(sc).tobytes()


def test_quantized_concat_is_the_concat_of_the_quantized():
    """K5 quantizes [Wq | Wk | Wv] as one matrix: per output channel, so it
    equals the three quantized apart."""
    d = Draw(2)
    ws = [torch.from_numpy(d.w(64, 64)) for _ in range(3)]
    q, sc = t_rb.quantize_weight(torch.cat(ws, 1))
    parts = [t_rb.quantize_weight(w) for w in ws]
    assert torch.equal(q, torch.cat([p[0] for p in parts], 1))
    assert torch.equal(sc, torch.cat([p[1] for p in parts]))


# --------------------------------------------------------------------------
# (b) the blocks against the JAX int8 kernels (interpret mode)
# --------------------------------------------------------------------------


def _scales(static, *amax):
    """The port's act_scales of amaxes (static), or None."""
    return torch.stack(t_rb.act_scales_from_amax(amax)) if static else None


def _jax_scales(jx, static, *amax, skip=True):
    """The JAX package's act_scales of amaxes (static; with skip, sx=None), or None."""
    if not static:
        return None
    return tuple(jx.rb.act_scales_from_amax(amax)) + ((None,) if skip else ())


def _block(d, h, cin, cout, skip, parts=None):
    xs = [d.act(2, h, h, c) for c in (parts or (cin,))]
    temb, dw, db = d.act(2, TEMB), d.w(TEMB, cout), d.vec(cout)
    g1 = [d.vec(cin, 1.0), d.vec(cin)]
    w1, b1 = d.w(3, 3, cin, cout), d.vec(cout)
    g2 = [d.vec(cout, 1.0), d.vec(cout)]
    w2, b2 = d.w(3, 3, cout, cout), d.vec(cout)
    sk = [d.w(cin, cout), d.vec(cout)] if skip else [None, None]
    return xs, (temb, dw, db), g1, (w1, b1), g2, (w2, b2), sk


# amaxes under the activations' range, so the static scales clip some values
A1, A2 = 2.0, 2.5


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("cin,cout", [(128, 128), (128, 256)])
def test_resblock_int8_plain_matches_jax_kernel(jx, static, cin, cout):
    d = Draw(10)
    (x,), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), sk = _block(d, 8, cin, cout, cin != cout)
    js, ts = _jax_scales(jx, static, A1, A2), _scales(static, A1, A2)
    kw = dict(num_groups1=32, num_groups2=32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock(*_j(jx, [x, _temb_proj(temb, dw, db), *g1, w1, b1, *g2, w2,
                                             b2, *sk]), mm_dtype=jx.jnp.int8, act_scales=js, **kw)
    got = t_rb.fused_resblock_int8(*_t([x, temb, dw, db, *g1]), _q(w1), torch.from_numpy(b1),
                                   *_t(g2), _q(w2), torch.from_numpy(b2), *_t(sk), ts, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= BLOCK_REL
    assert t_rb.fused_resblock_int8.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_resblock_pair_int8_plain_matches_jax_kernel(jx, static):
    """C1=128, C2=256: 384 channels in 32 groups of 12, so group 10
    straddles the xa/xb boundary."""
    d = Draw(11)
    (xa, xb), (temb, dw, db), g1, (w1, b1), g2, (w2, b2), sk = _block(d, 8, 384, 256, True,
                                                                       (128, 256))
    js, ts = _jax_scales(jx, static, A1, A2), _scales(static, A1, A2)
    kw = dict(num_groups1=32, num_groups2=32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock_pair(
            *_j(jx, [xa, xb, _temb_proj(temb, dw, db), *g1, w1, b1, *g2, w2, b2, *sk]),
            mm_dtype=jx.jnp.int8, act_scales=js, **kw)
    got = t_rb.fused_resblock_pair_int8(*_t([xa, xb, temb, dw, db, *g1]), _q(w1),
                                        torch.from_numpy(b1), *_t(g2), _q(w2),
                                        torch.from_numpy(b2), *_t(sk), ts, **kw)
    assert rel_err(got, want) <= BLOCK_REL


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_resblock_tail_int8_plain_matches_jax_kernel(jx, static):
    d = Draw(12)
    (h,), (temb, dw, db), _, (w1, b1), g2, (w2, b2), sk = _block(d, 8, 128, 128, True)
    h = h * (h > -0.3)  # a silu-like range: the transition's h is silu(GN1(x)) resampled
    x_skip = d.act(2, 8, 8, 128)
    js, ts = _jax_scales(jx, static, A1, A2), _scales(static, A1, A2)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.rb.fused_resblock_tail(
            *_j(jx, [h, x_skip, _temb_proj(temb, dw, db), w1, b1, *g2, w2, b2, *sk]),
            num_groups2=32, mm_dtype=jx.jnp.int8, act_scales=js)
    got = t_rb.fused_resblock_tail_int8(*_t([h, x_skip, temb, dw, db]), _q(w1),
                                        torch.from_numpy(b1), *_t(g2), _q(w2),
                                        torch.from_numpy(b2), *_t(sk), ts, num_groups2=32)
    assert rel_err(got, want) <= BLOCK_REL


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("h", [16, 4], ids=["S256", "S16"])
def test_attnblock_int8_plain_matches_jax_kernel(jx, static, h):
    d = Draw(13)
    c = 128
    x, gs, gb = d.act(2, h, h, c), d.vec(c, 1.0), d.vec(c)
    mats = [(d.w(c, c), d.vec(c)) for _ in range(4)]
    js, ts = _jax_scales(jx, static, 2.0, 1.0, skip=False), _scales(static, 2.0, 1.0)
    kw = dict(num_groups=32, skip_rescale=True)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.attn.fused_attnblock(*_j(jx, [x, gs, gb] + [a for m in mats for a in m]),
                                      mm_dtype=jx.jnp.int8, act_scales=js, **kw)
    wqkv = torch.from_numpy(np.concatenate([m[0] for m in mats[:3]], 1))
    bqkv = torch.from_numpy(np.concatenate([m[1] for m in mats[:3]]))
    got = t_attn.fused_attnblock_int8(*_t([x, gs, gb]), t_rb.quantize_weight(wqkv), bqkv,
                                      _q(mats[3][0]), torch.from_numpy(mats[3][1]), ts, **kw)
    assert rel_err(got, want) <= BLOCK_REL
    assert t_attn.fused_attnblock_int8.launches == 0


# --------------------------------------------------------------------------
# (c), (d): a small network, calibration and one int8 eps evaluation
# --------------------------------------------------------------------------


def small(cfg):
    """The accr structure at nf=128 (the JAX kernels need channels in
    multiples of 128), ch_mult (1, 2), one block per level, 16x16, attention
    at 8x8, f32 activations."""
    cfg.model.nf = 128
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.model.conv_impl = "fused_int8"
    # the transitions through K4's int8 mode, as the JAX network runs them
    # off the TPU; K9's int8 network is held in tests/test_torch_transition.py
    cfg.model.transition_impl = "tail"
    return cfg


class _FixedPrior:
    """The JAX CLD with prior_sampling returning a given u0 (a JAX array)."""

    def __init__(self, sde, u0):
        self._sde, self._u0 = sde, u0

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def prior_sampling(self, rng, shape):
        assert tuple(shape) == self._u0.shape[:-1]
        return self._u0


@pytest.fixture(scope="module")
def net(jx):
    """The small network on both sides, the same seeded weights, and the
    JAX package's calibration from a fixed u0 (batch 2, nfe 4)."""
    jcfg = small(jx.get_config("cld/accr_dcifar10"))
    cfg = small(get_config("cld/accr_dcifar10"))
    tree = seeded_params(cfg, 0)
    jmodel = jx.get_model("ncsnpp")(config=jcfg)
    jvars = {"params": jx.jax.tree.map(jx.jnp.asarray, tree)}
    u0 = np.random.default_rng(20).standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    u0[..., 1] *= 0.5  # v ~ N(0, 1/m), m_inv = 4
    old = jx.layers.CONV3X3_IMPL
    try:
        jqs = jx.calibrate(jcfg, jmodel, jvars, _FixedPrior(jx.CLD.from_config(jcfg), jx.jnp.asarray(u0)),
                            batch=2, nfe=4)
    finally:
        jx.layers.CONV3X3_IMPL = old
    jqs = jx.jax.tree.map(np.asarray, jx.flax.core.unfreeze(jqs))
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, tree=tree, jmodel=jmodel, jvars=jvars,
                                 u0=u0, jqs=jqs, model=seeded_model(cfg, 0))


def test_calibration_matches_jax(net):
    got = calibrate_cld_qscales(net.cfg, net.model, CLD.from_config(net.cfg), batch=2, nfe=4,
                                u0=torch.from_numpy(net.u0))
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in net.jqs.items()}
    assert len(got) == 13  # 10 residual blocks, 3 attention blocks
    for scope, sites in net.jqs.items():
        for site, want in sites.items():
            assert got[scope][site].dtype == torch.float32
            assert rel_err(got[scope][site], want) <= CALIB_REL, (scope, site)


def test_int8_eps_matches_jax(jx, net, monkeypatch):
    """conv_impl='fused_int8' with the JAX calibration: each block of the
    port's network (the int8 plain versions, through the model's own
    dispatch, weight quantization and static scales) against the same block
    of the JAX package's network (its int8 kernels in interpret mode) on the
    same inputs, then the whole eps.

    Run free, the two networks part by more than a block test allows: int8
    rounding is discontinuous, so a last-bit difference in a GroupNorm
    statistic (f32 sums in another order) flips a rounding, and the flip's
    change flips others downstream; measured 0.051 of max|eps| here
    (``test_int8_eps_free_run_matches_jax``), against 0.049 between the JAX
    package's own int8 and f32 (conv_impl 'xla') networks. So each port block
    takes the JAX block's inputs: the port's network runs with every block's
    output replaced by the JAX block's, after the comparison."""
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", jx.layers.CONV3X3_IMPL)
    monkeypatch.setattr(jx.rb, "supported",
                        lambda shape, cout: shape[-1] % 128 == 0 and cout % 128 == 0)
    monkeypatch.setattr(jx.attn, "supported", lambda shape: shape[-1] % 128 == 0)
    rng = np.random.default_rng(21)
    u = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    t = np.array([0.5, 0.02], np.float32)
    jvars = dict(net.jvars, qscales=jx.jax.tree.map(jx.jnp.asarray, net.jqs))
    x_in = jx.jnp.concatenate([u[..., 0], u[..., 1]], -1)  # stack_uv_to_channels
    with jx.pltpu.force_tpu_interpret_mode():
        want, state = net.jmodel.apply(jvars, x_in, jx.jnp.asarray(t) * 999.0, train=False,
                                       capture_intermediates=True, mutable=["intermediates"])
    blocks_out = {name: np.array(v["__call__"][0])
                  for name, v in state["intermediates"].items() if name in net.jqs}
    model = net.model
    model.qscales = convert.qscales_from_flax(model, net.jqs)
    errs = {}
    for name, mod in model.scopes:
        if name in blocks_out:
            def forced(*args, _name=name, _fwd=mod.forward, **kw):
                errs[_name] = rel_err(_fwd(*args, **kw), blocks_out[_name])
                return torch.from_numpy(blocks_out[_name])

            monkeypatch.setattr(mod, "forward", forced)
    got = make_cld_eps_fn(CLD.from_config(net.cfg))(model, torch.from_numpy(u),
                                                    torch.from_numpy(t))
    model.qscales = {}
    assert set(errs) == set(blocks_out) and len(errs) == 13
    assert max(errs.values()) <= NET_BLOCK_REL, errs
    want = np.stack([want[..., :3], want[..., 3:]], -1)  # unstack_channels_to_uv
    assert rel_err(got, want) <= EPS_REL


def test_int8_eps_free_run_matches_jax(jx, net, monkeypatch):
    """The same eps evaluation run free on both sides: the port's network
    (fused_int8, the JAX calibration) against the JAX package's
    ``make_cld_eps_fn`` (its int8 kernels in interpret mode), each block on
    its own side's inputs. The flipped roundings (see above) add up through
    the network to the int8 noise level itself: measured 5.1e-2 of max|eps|,
    against 4.9e-2 between the JAX package's own int8 and f32 (conv_impl 'xla')
    networks on the same input."""
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", jx.layers.CONV3X3_IMPL)
    monkeypatch.setattr(jx.rb, "supported",
                        lambda shape, cout: shape[-1] % 128 == 0 and cout % 128 == 0)
    monkeypatch.setattr(jx.attn, "supported", lambda shape: shape[-1] % 128 == 0)
    rng = np.random.default_rng(21)
    u = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    t = np.array([0.5, 0.02], np.float32)
    jvars = dict(net.jvars, qscales=jx.jax.tree.map(jx.jnp.asarray, net.jqs))
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.make_cld_eps_fn(jx.CLD.from_config(net.jcfg), net.jmodel)(
            jvars, jx.jnp.asarray(u), jx.jnp.asarray(t))
    model = net.model
    model.qscales = convert.qscales_from_flax(model, net.jqs)
    try:
        got = make_cld_eps_fn(CLD.from_config(net.cfg))(model, torch.from_numpy(u),
                                                        torch.from_numpy(t))
    finally:
        model.qscales = {}
    assert rel_err(got, np.asarray(want)) <= EPS_FREE_REL


def test_qscales_from_flax_rejects_unknown_sites(net):
    with pytest.raises(ValueError):
        convert.qscales_from_flax(net.model, {"AttnBlockpp_0": {"a1": 1.0}})
    with pytest.raises(ValueError):
        convert.qscales_from_flax(net.model, {"Dense_0": {"h": 1.0}})


# --------------------------------------------------------------------------
# On the card: each int8 kernel against its int8 plain version
# --------------------------------------------------------------------------

# about 3x the errors chip_smoke.py measures on an H100 (bf16 outputs)
KERNEL_BOUND = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _on(a, device, bf16=False):
    if a is None:
        return None
    t = torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a.to(device)
    return t.to(torch.bfloat16).float() if bf16 else t


@pytest.mark.cuda
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind,h,cin,cout", [("stride1", 32, 128, 128), ("stride1", 16, 128, 256),
                                             ("pair", 8, (256, 256), 256),
                                             ("tail", 16, 256, 256)])
def test_resblock_int8_kernel_matches_plain(cuda, static, kind, h, cin, cout):
    d = Draw(30)
    parts = cin if isinstance(cin, tuple) else None
    c = sum(parts) if parts else cin
    xs, (temb, dw, db), g1, (w1, b1), g2, (w2, b2), sk = _block(d, h, c, cout,
                                                                c != cout or kind != "stride1",
                                                                parts)
    xs = [_on(x, cuda, bf16=True) for x in xs]
    ts = _scales(static, A1, A2)
    ts = None if ts is None else ts.to(cuda)
    # K-major, as the model hands them to the kernels on the card (the plain
    # versions take either layout)
    ws = [t_rb.pack_int8_weight(t_rb.quantize_weight(_on(w, cuda))) for w in (w1, w2)]
    common = [_on(a, cuda) for a in (temb, dw, db)]
    body = [ws[0], _on(b1, cuda), *[_on(a, cuda) for a in g2], ws[1], _on(b2, cuda),
            *[_on(a, cuda) for a in sk], ts]
    gn1 = [_on(a, cuda) for a in g1]
    kw = dict(num_groups2=32)
    if kind == "tail":
        args = [xs[0], _on(d.act(2, h, h, c), cuda, bf16=True)] + common + body
        fused, plain = t_rb.fused_resblock_tail_int8, t_rb.resblock_tail_int8_reference
    else:
        kw["num_groups1"] = 32
        args = xs + common + gn1 + body
        fused, plain = ((t_rb.fused_resblock_pair_int8, t_rb.resblock_pair_int8_reference)
                        if parts else (t_rb.fused_resblock_int8, t_rb.resblock_int8_reference))
    with torch.no_grad():
        out = fused(*[a.to(torch.bfloat16) if i < len(xs) + (kind == "tail") else a
                      for i, a in enumerate(args)], **kw)
        ref = plain(*args, **kw)
    assert out.dtype == torch.bfloat16
    assert _kernel_rel(out, ref) <= KERNEL_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("h", [16, 4])
def test_attnblock_int8_kernel_matches_plain(cuda, static, h):
    d = Draw(31)
    c = 256
    x = _on(d.act(4, h, h, c), cuda, bf16=True)
    gs, gb = _on(d.vec(c, 1.0), cuda), _on(d.vec(c), cuda)
    # K-major, as the model hands them to the kernels on the card (the plain
    # version takes either layout)
    wqkv = t_attn.pack_projection(t_rb.quantize_weight(_on(d.w(c, 3 * c), cuda)))
    wo = t_attn.pack_projection(t_rb.quantize_weight(_on(d.w(c, c), cuda)))
    bqkv, bo = _on(d.vec(3 * c), cuda), _on(d.vec(c), cuda)
    ts = _scales(static, 2.0, 1.0)
    ts = None if ts is None else ts.to(cuda)
    kw = dict(num_groups=32, skip_rescale=True)
    with torch.no_grad():
        out = t_attn.fused_attnblock_int8(x.to(torch.bfloat16), gs, gb, wqkv, bqkv, wo, bo, ts,
                                          **kw)
        ref = t_attn.attnblock_int8_reference(x, gs, gb, wqkv, bqkv, wo, bo, ts, **kw)
    assert out.dtype == torch.bfloat16
    assert _kernel_rel(out, ref) <= KERNEL_BOUND
