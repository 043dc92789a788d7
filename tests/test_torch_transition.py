"""K9, the whole up/down transition block, against the JAX package on the CPU,
and the rule that the whole-block kernels keep x's dtype:

(a) the phase coefficients and the polyphase resample against
    ``_transition_kerns`` and the JAX package's FIR and naive resampling;
(b) K9's plain versions (f32, bf16 with the TPU kernel's rounding points,
    int8 per-sample and static) against ``fused_resblock_transition`` in
    interpret mode, up/down;
(c) one up and one down ``ResnetBlockBigGANpp`` with ``transition='full'``
    against the JAX block with the whole-transition kernel (its backend gate
    monkeypatched), under 'fused' and 'fused_int8', and against the same port
    block with the setting off;
(d) a small network's eps with ``model.transition_impl='full'`` against the
    JAX package's with the kernel on, f32 and int8 static;
(e) the CLI's sampling with the setting, both families, 'fused' and
    'fused_int8';
(f) every plain version of K2-K5 and K9 returns x's dtype.

Cases marked ``cuda`` hold K9 (bf16, int8 per-sample and static) against its
plain versions on the card, K2-K5 on f32 activations, and the refusals, and
skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import cli, convert
from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models import blocks as t_blocks
from gddim_torch.models.calibrate import calibrate_cld_qscales
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.ops import attnblock as t_attn
from gddim_torch.ops import resblock as t_rb

FIR = (1, 3, 3, 1)
TEMB = 16
# (b) f32: the JAX kernel test's own bound (tests/test_ops.py:447)
F32_TOL = 5e-4
# (b) bf16 plain against the bf16 interpret kernel, max|diff| / max|out|:
# the same rounding points, f32 sums in another order; measured 4.5e-4 (up)
# and 3.7e-7 (down)
BF16_REL = 1e-2
# (b) int8 plain against the int8 interpret kernel: the same quantization of
# the same f32 values, so only a value on a half step could flip; measured
# 2.3e-7 at most (no flip)
INT8_REL = 2e-3
# (c) the port block against the JAX block (K9 bf16 or int8 per-sample in
# interpret mode; the port's CPU block runs the f32 plain version under
# 'fused'): measured 2.2e-3 / 1.4e-3 (fused up / down), 1.8e-7 (int8). K9 on
# against off: 8.2e-7 in f32 (NET_REL); int8 7.3e-3 / 3.1e-3, as K9 rounds
# silu(GN1(x)) to bf16 before the resample (the TPU kernel's scratch) where
# the off path's f32 plain versions resample it unrounded
BLOCK_REL = 1e-2
# (d) f32: the whole network, measured 1.8e-6. int8 static, run free: the
# flipped roundings of tests/test_torch_int8.py add up to 4.5e-2 of max|eps|
# here (5.1e-2 there without K9); about 3x
NET_REL = 1e-4
NET_INT8_REL = 0.15


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


def _temb_proj(temb, w, b):
    t = temb.astype(np.float64)
    return ((t / (1 + np.exp(-t))) @ w + b).astype(np.float32)


def _q(w):
    return t_rb.quantize_weight(torch.from_numpy(w) if isinstance(w, np.ndarray) else w)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    runs the ``cuda`` cases with ``pytest --noconftest -m cuda``)."""
    import flax
    import jax
    import jax.numpy as jnp
    from gddim_tpu.configs import get_config as jax_get_config
    from gddim_tpu.math.cld import CLD as JaxCLD
    from gddim_tpu.models import blocks, get_model, layers, resample
    from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
    from gddim_tpu.models.calibrate import calibrate_cld_qscales as jax_calibrate
    from gddim_tpu.ops import attnblock, resblock
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(
        flax=flax, jax=jax, jnp=jnp, get_config=jax_get_config, CLD=JaxCLD, blocks=blocks,
        get_model=get_model, layers=layers, res=resample, make_cld_eps_fn=jax_make_cld_eps_fn,
        calibrate=jax_calibrate, attn=attnblock, rb=resblock, pltpu=pltpu)


def _j(jx, args):
    return [None if a is None else jx.jnp.asarray(a) for a in args]


DIRS = [(True, True), (True, False), (False, True), (False, False)]
DIR_IDS = ["up-fir", "up-naive", "down-fir", "down-naive"]


# --------------------------------------------------------------------------
# (a) coefficients and resample
# --------------------------------------------------------------------------


@pytest.mark.parametrize("up,fir", DIRS, ids=DIR_IDS)
def test_transition_kerns_match_jax(jx, up, fir):
    assert t_rb.transition_kerns(up, fir, FIR) == jx.rb._transition_kerns(up, fir, FIR)


@pytest.mark.parametrize("up,fir", DIRS, ids=DIR_IDS)
def test_resample_matches_jax_resampling(jx, up, fir):
    """The polyphase form against the upfirdn pipeline (FIR) and the nearest /
    2x2-mean resampling (naive) of the JAX package."""
    x = Draw(0).act(2, 8, 6, 16)
    got = t_rb.resample_transition(torch.from_numpy(x), t_rb.transition_kerns(up, fir, FIR), up)
    if fir:
        want = (jx.res.upsample_2d if up else jx.res.downsample_2d)(jx.jnp.asarray(x), FIR, 2)
    else:
        want = (jx.res.naive_upsample_2d if up else jx.res.naive_downsample_2d)(
            jx.jnp.asarray(x), 2)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


# --------------------------------------------------------------------------
# (b) the plain versions against the JAX kernel in interpret mode
# --------------------------------------------------------------------------


def transition_args(d, b, h, c, cout):
    """(x, temb, dense w, dense b, GN1, conv1, GN2, conv2, skip) numpy operands."""
    return [d.act(b, h, h, c), d.act(b, TEMB), d.w(TEMB, cout), d.vec(cout), d.vec(c, 1.0),
            d.vec(c), d.w(3, 3, c, cout), d.vec(cout), d.vec(cout, 1.0), d.vec(cout),
            d.w(3, 3, cout, cout), d.vec(cout), d.w(c, cout), d.vec(cout)]


def _jax_transition(jx, args, mm_dtype, act_scales=None, **kw):
    x, temb, dw, db, *rest = args
    with jx.pltpu.force_tpu_interpret_mode():
        return np.asarray(jx.rb.fused_resblock_transition(
            *_j(jx, [x, _temb_proj(temb, dw, db), *rest]), mm_dtype=mm_dtype,
            act_scales=act_scales, **kw))


@pytest.mark.parametrize("up,fir", DIRS, ids=DIR_IDS)
def test_transition_plain_matches_jax_f32_kernel(jx, up, fir):
    """B=2, H=8, C=128: the f32 plain version (and the wrapper on a CPU
    tensor) against the kernel with mm_dtype f32."""
    args = transition_args(Draw(1), 2, 8, 128, 128)
    kw = dict(up=up, fir=fir, num_groups1=32, num_groups2=32, skip_rescale=True)
    want = _jax_transition(jx, args, jx.jnp.float32, **kw)
    got = t_rb.fused_resblock_transition(*_t(args), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    ref = t_rb.resblock_transition_reference(*_t(args), **kw)
    np.testing.assert_allclose(ref.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    assert t_rb.fused_resblock_transition.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_transition_bf16_plain_matches_jax_bf16_kernel(jx, up):
    args = transition_args(Draw(2), 2, 8, 128, 128)
    kw = dict(up=up, fir=True, num_groups1=32, num_groups2=32)
    want = _jax_transition(jx, args, jx.jnp.bfloat16, **kw)
    got = t_rb.resblock_transition_bf16_reference(*_t(args), **kw)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= BF16_REL


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_transition_int8_plain_matches_jax_kernel(jx, static, up):
    """Per-sample scales, and static (s1, s2) with the skip bf16 (sx None),
    the scales under the activations' range so that they clip."""
    x, temb, dw, db, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs = transition_args(
        Draw(3), 2, 8, 128, 128)
    kw = dict(up=up, fir=True, num_groups1=32, num_groups2=32)
    js = tuple(jx.rb.act_scales_from_amax((1.5, 2.0))) + (None,) if static else None
    want = _jax_transition(jx, [x, temb, dw, db, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs],
                           jx.jnp.int8, js, **kw)
    ts = torch.stack(t_rb.act_scales_from_amax((1.5, 2.0))) if static else None
    got = t_rb.fused_resblock_transition_int8(
        *_t([x, temb, dw, db, g1s, g1b]), _q(w1), torch.from_numpy(b1), *_t([g2s, g2b]), _q(w2),
        *_t([b2, ws, bs]), ts, **kw)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= INT8_REL
    assert t_rb.fused_resblock_transition_int8.launches == 0


def test_transition_supported_shapes():
    assert t_rb.transition_supported((2, 16, 16, 128), 128, False, True, FIR)
    assert t_rb.transition_supported((2, 4, 4, 256), 256, True, True, FIR)
    assert not t_rb.transition_supported((2, 16, 16, 32), 32, False, True, FIR)  # Cout tile
    assert not t_rb.transition_supported((2, 16, 16, 48), 64, False, True, FIR)  # Cin slice
    assert not t_rb.transition_supported((2, 5, 5, 128), 128, False, True, FIR)  # odd H, W
    assert not t_rb.transition_supported((2, 8, 8, 128), 128, True, True, (1, 2, 1))  # 3 taps


# --------------------------------------------------------------------------
# (c) blocks
# --------------------------------------------------------------------------


def _load(module, tree):
    module.load_state_dict(convert.flax_to_state_dict(module, tree))
    return module


def _block_pair(jx, up, seed):
    """A JAX up or down block at C=128 with random parameters, and the port's
    block with the same ones; x (2, 8, 8, 128), temb (2, 16)."""
    import flax.linen as nn

    d = Draw(seed)
    x, temb = d.act(2, 8, 8, 128), d.act(2, TEMB)
    jblk = jx.blocks.ResnetBlockBigGANpp(act=nn.swish, out_ch=128, up=up, down=not up, fir=True,
                                         fir_kernel=FIR, skip_rescale=True, init_scale=0.0)
    params = jx.flax.core.unfreeze(jblk.init(jx.jax.random.PRNGKey(0), jx.jnp.asarray(x),
                                             jx.jnp.asarray(temb), False)["params"])
    params = jx.jax.tree.map(
        lambda a: (d.rng.standard_normal(a.shape) / np.sqrt(max(np.prod(a.shape[:-1]), 1))
                   ).astype(np.float32), params)
    tblk = _load(t_blocks.ResnetBlockBigGANpp(128, 128, TEMB, up=up, down=not up,
                                              fir_kernel=FIR), params)
    return jblk, params, tblk, x, temb


@pytest.mark.parametrize("impl", ["fused", "fused_int8"])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_transition_block_matches_jax_block(jx, monkeypatch, impl, up):
    """GDDIM_TRANSITION_IMPL=full with the backend gate monkeypatched: the JAX
    block runs K9 in interpret mode (bf16, or int8 per-sample), the port block
    K9's plain version; with the setting off the port block takes K1, the
    FIR passes and K4's plain versions and agrees too."""
    jblk, params, tblk, x, temb = _block_pair(jx, up, 5 + up)
    monkeypatch.setenv("GDDIM_TRANSITION_IMPL", "full")
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", impl)
    monkeypatch.setattr(jx.rb, "transition_supported",
                        lambda shape, cout, up, fir, fk: shape[-1] % 128 == 0 and cout % 128 == 0)
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jblk.apply({"params": params}, jx.jnp.asarray(x),
                                     jx.jnp.asarray(temb), False))
    int8 = impl == "fused_int8"
    calls = []
    for name in ("fused_resblock_transition", "fused_resblock_transition_int8"):
        fn = getattr(t_rb, name)
        monkeypatch.setattr(t_rb, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                         _fn(*a, **k))[1])
    tx, tt = torch.from_numpy(x), torch.from_numpy(temb)
    got = tblk(tx, tt, fused=True, int8=int8, transition="full")
    assert calls == ["fused_resblock_transition" + ("_int8" if int8 else "")]
    assert got.shape == want.shape
    assert rel_err(got.detach(), want) <= BLOCK_REL
    off = tblk(tx, tt, fused=True, int8=int8, transition="tail")
    assert len(calls) == 1
    assert rel_err(got.detach(), off.detach()) <= (BLOCK_REL if int8 else NET_REL)


# --------------------------------------------------------------------------
# (d) a small network
# --------------------------------------------------------------------------


def small(cfg, conv_impl="fused"):
    """The accr structure at nf=128 (the channels K9 and the JAX kernels
    take), ch_mult (1, 2), one block per level, 16x16, attention at 8x8, f32."""
    cfg.model.nf = 128
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.model.conv_impl = conv_impl
    return cfg


class _FixedPrior:
    """The JAX CLD with prior_sampling returning a given u0 (a JAX array)."""

    def __init__(self, sde, u0):
        self._sde, self._u0 = sde, u0

    def __getattr__(self, name):
        return getattr(self._sde, name)

    def prior_sampling(self, rng, shape):
        return self._u0


def _net_inputs():
    rng = np.random.default_rng(21)
    return rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32), np.array([0.5, 0.02],
                                                                                np.float32)


def _patch_jax_gates(jx, monkeypatch, impl, kernels_everywhere):
    monkeypatch.setenv("GDDIM_TRANSITION_IMPL", "full")
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", impl)
    monkeypatch.setattr(jx.rb, "transition_supported",
                        lambda shape, cout, up, fir, fk: shape[-1] % 128 == 0 and cout % 128 == 0)
    if kernels_everywhere:
        monkeypatch.setattr(jx.rb, "supported",
                            lambda shape, cout: shape[-1] % 128 == 0 and cout % 128 == 0)
        monkeypatch.setattr(jx.attn, "supported", lambda shape: shape[-1] % 128 == 0)


def test_small_net_eps_with_k9_matches_jax_f32(jx, monkeypatch):
    """conv_impl 'fused', transition_impl 'full', f32: the port's transitions
    run K9's f32 plain version, the JAX network runs K9 in interpret mode with
    MM_DTYPE f32 (the other blocks off the TPU take the XLA composition)."""
    _patch_jax_gates(jx, monkeypatch, "fused", False)
    monkeypatch.setattr(jx.rb, "MM_DTYPE", jx.jnp.float32)
    calls = []
    real = t_rb.resblock_transition_reference
    monkeypatch.setattr(t_rb, "resblock_transition_reference",
                        lambda *a, **k: (calls.append(k["up"]), real(*a, **k))[1])
    cfg, jcfg = small(get_config("cld/accr_dcifar10")), small(jx.get_config("cld/accr_dcifar10"))
    tree = seeded_params(cfg, 0)
    u, t = _net_inputs()
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.make_cld_eps_fn(jx.CLD.from_config(jcfg), jx.get_model("ncsnpp")(config=jcfg))(
            {"params": jx.jax.tree.map(jx.jnp.asarray, tree)}, jx.jnp.asarray(u), jx.jnp.asarray(t))
    cfg.model.transition_impl = "full"
    got = make_cld_eps_fn(CLD.from_config(cfg))(seeded_model(cfg, 0), torch.from_numpy(u),
                                                torch.from_numpy(t))
    assert calls == [False, True]  # the network's one down and one up transition
    assert rel_err(got, want) <= NET_REL


def test_small_net_eps_with_k9_int8_static_matches_jax(jx, monkeypatch):
    """conv_impl 'fused_int8' with the JAX package's calibration (static
    scales), transition_impl 'full', run free on both sides: the JAX network's
    int8 kernels (K9 included) in interpret mode, the port's int8 plain
    versions. Int8 rounding flips on last-bit differences (see
    tests/test_torch_int8.py) add up to 4.5e-2 of max|eps| here."""
    jcfg = small(jx.get_config("cld/accr_dcifar10"), "fused_int8")
    cfg = small(get_config("cld/accr_dcifar10"), "fused_int8")
    tree = seeded_params(cfg, 0)
    jmodel = jx.get_model("ncsnpp")(config=jcfg)
    jvars = {"params": jx.jax.tree.map(jx.jnp.asarray, tree)}
    u0 = np.random.default_rng(20).standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    u0[..., 1] *= 0.5
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", jx.layers.CONV3X3_IMPL)
    jqs = jx.calibrate(jcfg, jmodel, jvars, _FixedPrior(jx.CLD.from_config(jcfg),
                                                        jx.jnp.asarray(u0)), batch=2, nfe=4)
    jqs = jx.jax.tree.map(np.asarray, jx.flax.core.unfreeze(jqs))
    _patch_jax_gates(jx, monkeypatch, "fused_int8", True)
    u, t = _net_inputs()
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.make_cld_eps_fn(jx.CLD.from_config(jcfg), jmodel)(
            dict(jvars, qscales=jx.jax.tree.map(jx.jnp.asarray, jqs)), jx.jnp.asarray(u),
            jx.jnp.asarray(t))
    cfg.model.transition_impl = "full"
    model = seeded_model(cfg, 0)
    model.qscales = convert.qscales_from_flax(model, jqs)
    got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u), torch.from_numpy(t))
    assert rel_err(got, np.asarray(want)) <= NET_INT8_REL


def test_port_calibration_feeds_k9_static_scales():
    """The port's own calibration records the transitions' a1/a2 after the
    resample, where K9 quantizes: every transition block gets both."""
    cfg = small(get_config("cld/accr_dcifar10"), "fused_int8")
    cfg.model.nf = 64
    model = seeded_model(cfg, 0)
    qs = calibrate_cld_qscales(cfg, model, CLD.from_config(cfg), batch=1, nfe=2,
                               generator=torch.Generator().manual_seed(0))
    scopes = [blk.scope for blk in model.down_blocks if blk.down]
    scopes += [blk.scope for blk in model.up_blocks if blk.up]
    assert len(scopes) == 2 and all({"a1", "a2"} <= set(qs[s]) for s in scopes)


# --------------------------------------------------------------------------
# (e) the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["fused", "fused_int8"])
@pytest.mark.parametrize("config", ["cld/accr_dcifar10", "blur/ddpm_deep_cifar10"])
def test_cli_sampling_with_k9(tmp_path, monkeypatch, config, impl):
    """``--set model.transition_impl=full`` on a small config whose channels
    K9 takes (nf=64): the transitions go through K9's plain versions."""
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    calls = []
    for name in ("fused_resblock_transition", "fused_resblock_transition_int8"):
        fn = getattr(t_rb, name)
        monkeypatch.setattr(t_rb, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                         _fn(*a, **k))[1])
    cli.main(["--config", config, "--mode", "sampling", "--device", "cpu", "--batch", "2",
              "--out", str(tmp_path / "out"), "--set", "model.nf=64", "--set",
              "model.ch_mult=(1,2)", "--set", "model.num_res_blocks=1", "--set",
              "data.image_size=16", "--set", "sampling.nfe=2", "--set",
              f"model.conv_impl={impl}", "--set", "model.transition_impl=full"])
    with np.load(tmp_path / "out" / "samples_0.npz") as f:
        assert f["samples"].shape == (2, 16, 16, 3)
    name = "fused_resblock_transition" + ("_int8" if impl == "fused_int8" else "")
    assert set(calls) == {name} and len(calls) >= 2 and len(calls) % 2 == 0  # 2 an eval


def test_unknown_transition_impl_is_refused():
    cfg = small(get_config("cld/accr_dcifar10"))
    cfg.model.nf, cfg.model.transition_impl = 32, "fused"
    with pytest.raises(ValueError, match="transition_impl"):
        seeded_model(cfg, 0)


# --------------------------------------------------------------------------
# (f) the plain versions keep x's dtype
# --------------------------------------------------------------------------


def _plain_cases(d, dtype):
    """(name, plain fn, args, kwargs) of every K2-K5 and K9 plain version on
    x of ``dtype`` (C=32, 4x4 or 8x8)."""
    c = 32
    x = torch.from_numpy(d.act(1, 4, 4, c)).to(dtype)
    temb = _t([d.act(1, TEMB), d.w(TEMB, c), d.vec(c)])
    g1 = _t([d.vec(c, 1.0), d.vec(c)])
    g1x2 = [torch.cat([g, g]) for g in g1]  # the pair's 2C channels
    w1, w2 = (torch.from_numpy(d.w(3, 3, c, c)) for _ in range(2))
    b1, b2, g2s, g2b = _t([d.vec(c), d.vec(c), d.vec(c, 1.0), d.vec(c)])
    sk = _t([d.w(c, c), d.vec(c)])
    kw1 = dict(num_groups1=8, num_groups2=8)
    kw2 = dict(num_groups2=8)
    tk = dict(up=False, num_groups1=8, num_groups2=8)
    mats = _t([a for _ in range(4) for a in (d.w(c, c), d.vec(c))])
    wqkv = torch.cat(mats[0:6:2], 1)
    bqkv = torch.cat(mats[1:6:2])
    x8 = torch.from_numpy(d.act(1, 8, 8, c)).to(dtype)
    return [
        ("K2", t_rb.resblock_reference, (x, *temb, *g1, w1, b1, g2s, g2b, w2, b2), kw1),
        ("K3", t_rb.resblock_pair_reference, (x, x, *temb, *g1x2, torch.cat([w1, w1], 2), b1,
                                              g2s, g2b, w2, b2, torch.cat(sk[:1] * 2), sk[1]),
         dict(num_groups1=8, num_groups2=8)),
        ("K4", t_rb.resblock_tail_reference, (x, x, *temb, w1, b1, g2s, g2b, w2, b2, *sk), kw2),
        ("K5", t_attn.attnblock_reference, (x, *g1, *mats), dict(num_groups=8)),
        ("K2-int8", t_rb.resblock_int8_reference, (x, *temb, *g1, _q(w1), b1, g2s, g2b, _q(w2),
                                                   b2), kw1),
        ("K3-int8", t_rb.resblock_pair_int8_reference,
         (x, x, *temb, *g1x2, _q(torch.cat([w1, w1], 2)), b1, g2s, g2b, _q(w2), b2,
          torch.cat(sk[:1] * 2), sk[1]), dict(num_groups1=8, num_groups2=8)),
        ("K4-int8", t_rb.resblock_tail_int8_reference, (x, x, *temb, _q(w1), b1, g2s, g2b,
                                                        _q(w2), b2, *sk), kw2),
        ("K5-int8", t_attn.attnblock_int8_reference, (x, *g1, _q(wqkv), bqkv, _q(mats[6]),
                                                      mats[7]), dict(num_groups=8)),
        ("K9", t_rb.resblock_transition_reference, (x8, *temb, *g1, w1, b1, g2s, g2b, w2, b2,
                                                    *sk), tk),
        ("K9-bf16", t_rb.resblock_transition_bf16_reference, (x8, *temb, *g1, w1, b1, g2s, g2b,
                                                              w2, b2, *sk), tk),
        ("K9-int8", t_rb.resblock_transition_int8_reference, (x8, *temb, *g1, _q(w1), b1, g2s,
                                                              g2b, _q(w2), b2, *sk), tk),
    ]


PLAIN_NAMES = ["K2", "K3", "K4", "K5", "K2-int8", "K3-int8", "K4-int8", "K5-int8", "K9",
               "K9-bf16", "K9-int8"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", PLAIN_NAMES)
def test_plain_versions_keep_x_dtype(name, dtype):
    """The plain versions write x's dtype, as the TPU kernels do; the CUDA
    wrappers of the bf16 modes follow them (the ``cuda`` cases below)."""
    (case,) = [c for c in _plain_cases(Draw(9), dtype) if c[0] == name]
    _, fn, args, kw = case
    out = fn(*args, **kw)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

# about 3x the errors chip_smoke.py measures on an H100
KERNEL_BOUND = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _on(args, device):
    return [None if a is None else torch.from_numpy(a).to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,cout,up", [(32, 128, 128, False), (4, 256, 256, True),
                                         (16, 256, 256, True)])
def test_transition_kernel_matches_plain(cuda, h, c, cout, up):
    """K9 bf16 against its plain version with the TPU kernel's rounding
    points (bf16-valued inputs), and on f32 x against the same."""
    args = _on(transition_args(Draw(40), 4, h, c, cout), cuda)
    x = args[0].to(torch.bfloat16)
    kw = dict(up=up, num_groups1=32, num_groups2=32)
    with torch.no_grad():
        out = t_rb.fused_resblock_transition(x, *args[1:], **kw)
        ref = t_rb.resblock_transition_bf16_reference(x.float(), *args[1:], **kw)
        out32 = t_rb.fused_resblock_transition(x.float(), *args[1:], **kw)
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert _kernel_rel(out, ref) <= KERNEL_BOUND
    assert _kernel_rel(out32, ref) <= KERNEL_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("h,c,up", [(32, 128, False), (8, 256, True)])
def test_transition_int8_kernel_matches_plain(cuda, static, h, c, up):
    x, temb, dw, db, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs = _on(
        transition_args(Draw(41), 4, h, c, c), cuda)
    x = x.to(torch.bfloat16)
    ts = torch.stack(t_rb.act_scales_from_amax((4.0, 4.0))).to(cuda) if static else None
    # K-major, as the model hands them to the kernels on the card
    w1, w2 = (t_rb.pack_int8_weight(_q(w)) for w in (w1, w2))
    args = (temb, dw, db, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs, ts)
    kw = dict(up=up, num_groups1=32, num_groups2=32)
    with torch.no_grad():
        out = t_rb.fused_resblock_transition_int8(x, *args, **kw)
        ref = t_rb.resblock_transition_int8_reference(x.float(), *args, **kw)
    assert out.dtype == torch.bfloat16
    assert _kernel_rel(out, ref) <= KERNEL_BOUND


@pytest.mark.cuda
def test_transition_kernel_refusals(cuda):
    """An unsupported shape, a static skip scale (sx) with skip weights that
    are not an int8 pair, and f32 x in int8 mode raise on the card; none
    falls back."""
    x, temb, dw, db, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs = _on(
        transition_args(Draw(42), 2, 6, 64, 32), cuda)
    kw = dict(up=False, num_groups1=16, num_groups2=8)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported"):
        t_rb.fused_resblock_transition(x.bfloat16(), temb, dw, db, g1s, g1b, w1, b1, g2s, g2b,
                                       w2, b2, ws, bs, **kw)
    x, temb, dw, db, g1s, g1b, w1, b1, g2s, g2b, w2, b2, ws, bs = _on(
        transition_args(Draw(43), 2, 8, 64, 64), cuda)
    args = (temb, dw, db, g1s, g1b, _q(w1), b1, g2s, g2b, _q(w2), b2, ws, bs)
    with torch.no_grad(), pytest.raises(ValueError, match="pair"):
        t_rb.fused_resblock_transition_int8(x.bfloat16(), *args, torch.ones(3, device=cuda), **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="activations"):
        t_rb.fused_resblock_transition_int8(x, *args, None, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K2", "K3", "K4", "K5"])
def test_block_kernels_keep_f32_activations(cuda, kind):
    """K2-K5 on f32 activations write f32, within the bf16 bound of the
    plain f32 composition; their int8 modes refuse f32 activations."""
    d = Draw(44)
    c, h = 256, 16
    x = torch.from_numpy(d.act(4, h, h, c)).to(cuda)
    temb = _on([d.act(4, TEMB), d.w(TEMB, c), d.vec(c)], cuda)
    g1 = _on([d.vec(c, 1.0), d.vec(c)], cuda)
    w1, b1, g2s, g2b, w2, b2 = _on([d.w(3, 3, c, c), d.vec(c), d.vec(c, 1.0), d.vec(c),
                                    d.w(3, 3, c, c), d.vec(c)], cuda)
    sk = _on([d.w(c, c), d.vec(c)], cuda)
    with torch.no_grad():
        if kind == "K2":
            args, kw = (x, *temb, *g1, w1, b1, g2s, g2b, w2, b2), dict(num_groups1=32,
                                                                       num_groups2=32)
            out, ref = t_rb.fused_resblock(*args, **kw), t_rb.resblock_reference(*args, **kw)
            with pytest.raises(ValueError, match="activations"):
                t_rb.fused_resblock_int8(x, *temb, *g1, _q(w1), b1, g2s, g2b, _q(w2), b2,
                                         num_groups1=32, num_groups2=32)
        elif kind == "K3":
            xa, xb = x[..., :128].contiguous(), x[..., 128:].contiguous()
            args = (xa, xb, *temb, *g1, w1, b1, g2s, g2b, w2, b2, *sk)
            kw = dict(num_groups1=32, num_groups2=32)
            out = t_rb.fused_resblock_pair(*args, **kw)
            ref = t_rb.resblock_pair_reference(*args, **kw)
        elif kind == "K4":
            args, kw = (x, x.flip(1).contiguous(), *temb, w1, b1, g2s, g2b, w2, b2, *sk), dict(
                num_groups2=32)
            out, ref = t_rb.fused_resblock_tail(*args, **kw), t_rb.resblock_tail_reference(
                *args, **kw)
        else:
            mats = _on([a for _ in range(4) for a in (d.w(c, c), d.vec(c))], cuda)
            args, kw = (x, *g1, *mats), dict(num_groups=32, skip_rescale=True)
            out = t_attn.fused_attnblock(*args, **kw)
            ref = t_attn.attnblock_reference(*args, **kw)
            wqkv = torch.cat(mats[0:6:2], 1)
            with pytest.raises(ValueError, match="activations"):
                t_attn.fused_attnblock_int8(x, *g1, _q(wqkv), torch.cat(mats[1:6:2]),
                                            _q(mats[6]), mats[7], **kw)
    assert out.dtype == torch.float32
    assert _kernel_rel(out, ref) <= KERNEL_BOUND
