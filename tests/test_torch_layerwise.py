"""The port's layer-wise inference paths (``conv_impl`` 'pallas' and 'int8')
against the JAX package, on the CPU:

(a) K11's plain versions against ``conv3x3_pallas`` and
    ``conv3x3_pallas_int8`` in interpret mode;
(b) K12's plain version against ``_gn_silu_quant_pallas`` in interpret mode;
(c) the quantizers around them, bit for bit;
(d) one BigGAN block of each kind (stride-1, pair, down and up transition)
    and the attention block through the port's layer-wise composition
    against the JAX block with ``CONV3X3_IMPL`` set to the same mode;
(e) K11's gate: the tile plans of the form that runs, and a block at
    shapes outside them running the plain conv, as the reference runs XLA's.

``conv3x3.supported`` answers False off a TPU, so the cases that need the
JAX package's kernels patch it (the shape gate without the backend test), as
``tests/test_ops.py`` does. Cases marked ``cuda`` hold K11 and K12 against
their plain versions on the card and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import convert
from gddim_torch.models import blocks as t_blocks
from gddim_torch.models import layers as t_layers
from gddim_torch.models.layers import QuantizedActivation
from gddim_torch.ops import conv3x3 as t_c3
from gddim_torch.ops import groupnorm as t_gn

FIR = (1, 3, 3, 1)
# (d) max|port - JAX| / max|JAX| per block, f32 activations: measured up to
# 7.2e-7 under 'int8' and 1.2e-6 under 'pallas' here. The bound is the int8
# noise level's scale instead: an int8 rounding that flips on a last-bit
# GroupNorm difference (the JAX package's GN+quantize off the TPU sums its
# statistics in two passes, K12 in one) moves an output by one int8 step of
# one input, and the JAX block's own int8 and f32 paths part by 1.1e-2 to
# 1.3e-2 on these inputs
BLOCK_REL = 1e-2


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine,
    which has no JAX, runs the ``cuda`` cases with ``pytest --noconftest -m cuda``)."""
    import flax
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from gddim_tpu.models import blocks, layers
    from gddim_tpu.ops import conv3x3, groupnorm
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(flax=flax, nn=nn, jax=jax, jnp=jnp, blocks=blocks,
                                 layers=layers, c3=conv3x3, gn=groupnorm, pltpu=pltpu)


def fake_supported(x_shape, w_shape, stride, dilation):
    """``conv3x3.supported`` without its TPU backend test."""
    return (stride == 1 and dilation == 1 and x_shape[-1] % 128 == 0
            and w_shape[-1] % 128 == 0 and tuple(w_shape[:2]) == (3, 3))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# --------------------------------------------------------------------------
# (a) K11
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,cin,cout", [(2, 8, 128, 128), (3, 4, 256, 128)])
def test_conv3x3_plain_matches_pallas_f32(jx, b, h, cin, cout):
    """f32 inputs: only the order of the f32 sums differs (rel <= 1e-5)."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jx.c3.conv3x3_pallas(jx.jnp.asarray(x), jx.jnp.asarray(w)))
    got = t_c3.conv3x3_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


def test_conv3x3_plain_matches_pallas_bf16(jx):
    """bf16 inputs: both sum the exact bf16 products in f32 and round once to
    bf16, so the outputs are within one bf16 ulp of each other."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((2, 8, 8, 256)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 256, 128)) / 48.0).astype(np.float32)
    xb, wb = (jx.jnp.asarray(a).astype(jx.jnp.bfloat16) for a in (x, w))
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jx.c3.conv3x3_pallas(xb, wb).astype(jx.jnp.float32))
    got = t_c3.conv3x3_reference(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def _int8_operands(rng, b, h, cin, cout):
    x8 = rng.integers(-127, 128, (b, h, h, cin)).astype(np.int8)
    w8 = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    sw = (rng.random(cout) * 1e-3 + 1e-4).astype(np.float32)
    sa = (rng.random(b) * 1e-2 + 1e-3).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x8, w8, sw, sa, bias


@pytest.mark.parametrize("b,h,cin,cout", [(2, 8, 128, 128), (2, 4, 512, 256)])
def test_conv3x3_int8_plain_matches_pallas(jx, b, h, cin, cout):
    """The same int8 inputs and scales: the int32 sums are exact on both
    sides and the dequantization is the same f32 arithmetic, so the bf16
    outputs agree bit for bit (at 4x4x512 the sums reach 2^24 and beyond)."""
    x8, w8, sw, sa, bias = _int8_operands(np.random.default_rng(42), b, h, cin, cout)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.c3.conv3x3_pallas_int8(*(jx.jnp.asarray(a) for a in (x8, w8, sw, sa)),
                                         bias=jx.jnp.asarray(bias))
    want = np.asarray(want.astype(jx.jnp.float32))
    got = t_c3.conv3x3_pallas_int8(*map(torch.from_numpy, (x8, w8, sw, sa)),
                                   bias=torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# --------------------------------------------------------------------------
# (b) K12
# --------------------------------------------------------------------------

# share of int8 values allowed to differ by one step between K12's plain
# version and the Pallas kernel: a value on a half step flips when the f32
# GroupNorm differs in its last bit (summation order); measured 0 of the
# 92,160 values of these cases, and scales within 2.3e-7
K12_FLIP_SHARE = 1e-3


@pytest.mark.parametrize("h,c,silu", [(8, 128, True), (4, 384, True), (8, 256, False)])
def test_group_norm_silu_quant_plain_matches_pallas(jx, h, c, silu):
    rng = np.random.default_rng(43)
    x = (2.0 * rng.standard_normal((3, h, h, c)) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        q_j, s_j = jx.gn._gn_silu_quant_pallas(*(jx.jnp.asarray(a) for a in (x, g, bta)), 32,
                                               1e-6, silu)
    q, s = t_gn.group_norm_silu_quant(*map(torch.from_numpy, (x, g, bta)), 32, 1e-6, silu)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3,)
    assert rel_err(s, s_j) <= 1e-6
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_j, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= K12_FLIP_SHARE


# --------------------------------------------------------------------------
# (c) quantizers
# --------------------------------------------------------------------------


def test_quantize_per_sample_matches_jax_bit_for_bit(jx):
    rng = np.random.default_rng(44)
    x = (rng.standard_normal((4, 8, 8, 128)) * np.array([1e-3, 1.0, 7.0, 0.0])[:, None, None,
                                                                              None])
    x = x.astype(np.float32)
    q_j, s_j = jx.c3.quantize_per_sample(jx.jnp.asarray(x))
    for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
        want_q, want_s = (q_j, s_j) if xt.dtype == torch.float32 else \
            jx.c3.quantize_per_sample(jx.jnp.asarray(x).astype(jx.jnp.bfloat16))
        q, s = t_c3.quantize_per_sample(xt)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_quantize_weight_per_channel_matches_jax_bit_for_bit(jx):
    w = (np.random.default_rng(45).standard_normal((3, 3, 128, 256)) / 30).astype(np.float32)
    w[..., 0] = 0.0  # a zero channel: the 1e-12 floor
    q_j, s_j = jx.c3.quantize_weight_per_channel(w)
    q, s = t_c3.quantize_weight_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), q_j)
    np.testing.assert_array_equal(s.numpy(), s_j)


def test_quantized_activation_dequantizes():
    q = torch.tensor([[[[-127, 0, 64]]]], dtype=torch.int8)
    act = QuantizedActivation(q, torch.tensor([0.5]), torch.bfloat16)
    assert act.shape == (1, 1, 1, 3)
    assert act.dequant().dtype == torch.bfloat16
    assert act.dequant().float().tolist() == [[[[-63.5, 0.0, 32.0]]]]


# --------------------------------------------------------------------------
# (d) blocks through the layer-wise composition
# --------------------------------------------------------------------------


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = tuple(leaf.shape)
        if path[-1] == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) == 1:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def walk(node, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v)
                for k, v in node.items()}

    return walk(tree)


@pytest.fixture
def jax_impl(jx, monkeypatch):
    """Sets the JAX package's CONV3X3_IMPL for one test (restored after it),
    with the 3x3 conv gate answering as on a TPU."""
    monkeypatch.setattr(jx.c3, "supported", fake_supported)

    def use(impl):
        monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", impl)

    return use


@pytest.mark.parametrize("impl", ["int8", "pallas"])
@pytest.mark.parametrize("kind,cin,cout", [("stride1", 128, 128), ("stride1", 128, 256),
                                           ("pair", (256, 128), 128), ("down", 128, 128),
                                           ("up", 256, 256)])
def test_biggan_block_layerwise_matches_jax(jx, jax_impl, impl, kind, cin, cout):
    rng = np.random.default_rng(46)
    parts = cin if isinstance(cin, tuple) else (cin,)
    c = sum(parts)
    xs = [rng.standard_normal((2, 8, 8, p)).astype(np.float32) for p in parts]
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    jblk = jx.blocks.ResnetBlockBigGANpp(act=jx.nn.swish, out_ch=cout, up=kind == "up",
                                         down=kind == "down", fir=True, fir_kernel=FIR,
                                         skip_rescale=True, init_scale=0.0, dropout=0.0,
                                         dtype=jx.jnp.float32)
    jin = tuple(map(jx.jnp.asarray, xs)) if kind == "pair" else jx.jnp.asarray(xs[0])
    jax_impl("xla")
    shapes = jx.jax.eval_shape(lambda: jblk.init(jx.jax.random.PRNGKey(0), jin,
                                                 jx.jnp.asarray(temb), False))
    params = _random_like(jx.flax.core.unfreeze(shapes["params"]), 47)
    jax_impl(impl)
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jblk.apply({"params": params}, jin, jx.jnp.asarray(temb), False))
    tblk = t_blocks.ResnetBlockBigGANpp(c, cout, 32, up=kind == "up", down=kind == "down",
                                        fir_kernel=FIR)
    tblk.load_state_dict(convert.flax_to_state_dict(tblk, params))
    tin = tuple(map(torch.from_numpy, xs)) if kind == "pair" else torch.from_numpy(xs[0])
    with torch.inference_mode():
        got = tblk(tin, torch.from_numpy(temb), fused=True, layer=impl)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) <= BLOCK_REL


@pytest.mark.parametrize("impl", ["int8", "pallas"])
def test_attn_block_layerwise_matches_jax(jx, jax_impl, impl):
    """K1 GroupNorm (no SiLU), the NIN projections and attention."""
    x = np.random.default_rng(48).standard_normal((2, 8, 8, 128)).astype(np.float32)
    jblk = jx.blocks.AttnBlockpp(skip_rescale=True, init_scale=0.0, dtype=jx.jnp.float32)
    shapes = jx.jax.eval_shape(lambda: jblk.init(jx.jax.random.PRNGKey(0), jx.jnp.asarray(x),
                                                 False))
    params = _random_like(jx.flax.core.unfreeze(shapes["params"]), 49)
    jax_impl(impl)
    want = np.asarray(jblk.apply({"params": params}, jx.jnp.asarray(x), False))
    tblk = t_blocks.AttnBlockpp(128, skip_rescale=True)
    tblk.load_state_dict(convert.flax_to_state_dict(tblk, params))
    with torch.inference_mode():
        got = tblk(torch.from_numpy(x), fused=True, layer=impl)
    assert rel_err(got, want) <= 1e-5


# --------------------------------------------------------------------------
# (e) K11's gate: the plans of the form that runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("x_shape,bf16,int8", [
    ((4, 32, 32, 128), True, True), ((4, 4, 4, 512), True, True),
    ((2, 2, 2, 128), True, False),  # 4 pixels a sample: no int8 tile of whole samples
    ((2, 2, 4, 128), True, False),  # 8 pixels: not a multiple of 16
    ((1, 2, 256, 128), False, False),  # W above a tile's 128 pixels
    ((1, 4, 128, 128), True, True), ((4, 8, 8, 192), False, False),  # the JAX gate's Cin
])
def test_k11_gate_is_the_plans(x_shape, bf16, int8):
    """``conv3x3.supported`` says yes exactly where the form's tile plan
    returns (``tile_plan``, ``s8_tile_plan``) within the JAX gate."""
    from gddim_torch.ops import resblock as t_rb

    w_shape = (3, 3, x_shape[-1], 128)
    for want, int8_, plan in ((bf16, False, lambda: t_c3.tile_plan(*x_shape, 128)),
                              (int8, True, lambda: t_rb.s8_tile_plan(*x_shape, 0, 128))):
        assert t_c3.supported(x_shape, w_shape, int8=int8_) == want
        if want:
            plan()
        elif x_shape[-1] % 128 == 0:
            with pytest.raises(ValueError):
                plan()


@pytest.mark.parametrize("impl", ["int8", "pallas"])
@pytest.mark.parametrize("b,h,w", [(2, 2, 2), (1, 2, 256)], ids=["2x2", "W256"])
def test_layers_outside_k11_plans_run_plain(jx, monkeypatch, impl, b, h, w):
    """A stride-1 block at a 2x2 map and at W=256 through the layer-wise
    paths: K11 and K12 run only where the form's plan takes the conv (at 2x2
    the bf16 form has a plan of whole samples, the int8 form none; at W=256
    neither has), the plain conv elsewhere, and the output is the JAX
    block's, whose conv runs XLA there."""
    calls = []

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for mod, name in ((t_c3, "conv3x3_pallas"), (t_c3, "conv3x3_pallas_int8"),
                      (t_layers, "group_norm_silu_quant")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    rng = np.random.default_rng(50)
    x = rng.standard_normal((b, h, w, 128)).astype(np.float32)
    temb = rng.standard_normal((b, 32)).astype(np.float32)
    jblk = jx.blocks.ResnetBlockBigGANpp(act=jx.nn.swish, out_ch=128, fir=True, fir_kernel=FIR,
                                         skip_rescale=True, init_scale=0.0, dropout=0.0,
                                         dtype=jx.jnp.float32)
    monkeypatch.setattr(jx.layers, "CONV3X3_IMPL", "xla")
    shapes = jx.jax.eval_shape(lambda: jblk.init(jx.jax.random.PRNGKey(0), jx.jnp.asarray(x),
                                                 jx.jnp.asarray(temb), False))
    params = _random_like(jx.flax.core.unfreeze(shapes["params"]), 51)
    want = np.asarray(jblk.apply({"params": params}, jx.jnp.asarray(x), jx.jnp.asarray(temb),
                                 False))
    tblk = t_blocks.ResnetBlockBigGANpp(128, 128, 32, fir_kernel=FIR)
    tblk.load_state_dict(convert.flax_to_state_dict(tblk, params))
    with torch.inference_mode():
        got = tblk(torch.from_numpy(x), torch.from_numpy(temb), fused=True, layer=impl)
    assert calls == (["conv3x3_pallas"] * 2 if (impl, w) == ("pallas", 2) else [])
    assert got.shape == want.shape and rel_err(got, want) <= 1e-5


# --------------------------------------------------------------------------
# On the card: K11 and K12 against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,cin,cout", [(4, 32, 128, 128), (4, 16, 384, 256), (4, 4, 512, 256),
                                         (16, 32, 256, 256), (64, 32, 384, 128),
                                         (64, 16, 512, 256), (64, 4, 512, 256)])
def test_conv3x3_kernels_match_plain(cuda, b, h, cin, cout):
    """bf16: the same f32 sums in another order, then one bf16 rounding
    (about 4e-3 of max|out| at most); int8: exact sums, the same dequant."""
    g = torch.Generator(device=cuda).manual_seed(50)
    x = torch.randn((b, h, h, cin), generator=g, device=cuda).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=g, device=cuda) / (9 * cin) ** 0.5).bfloat16()
    with torch.no_grad():
        out, ref = t_c3.conv3x3_pallas(x, w), t_c3.conv3x3_reference(x, w)
    assert out.dtype == torch.bfloat16
    assert ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= 1e-2
    x8, sx = t_c3.quantize_per_sample(x)
    w8, sw = t_c3.quantize_weight_per_channel(w)
    bias = 0.1 * torch.randn((cout,), generator=g, device=cuda)
    with torch.no_grad():
        out = t_c3.conv3x3_pallas_int8(x8, w8, sw, sx, bias)
        ref = t_c3.conv3x3_int8_reference(x8, w8, sw, sx, bias)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(32, 128), (16, 384), (4, 512)])
def test_group_norm_silu_quant_kernel_matches_plain(cuda, h, c):
    g = torch.Generator(device=cuda).manual_seed(51)
    x = torch.randn((4, h, h, c), generator=g, device=cuda).bfloat16()
    gs = 1.0 + 0.1 * torch.randn((c,), generator=g, device=cuda)
    gb = 0.1 * torch.randn((c,), generator=g, device=cuda)
    q, s = t_gn.group_norm_silu_quant(x, gs, gb, 32)
    q_ref, s_ref = t_gn.group_norm_silu_quant_reference(x, gs, gb, 32)
    assert ((s - s_ref).abs().max() / s_ref.abs().max()).item() <= 1e-5
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1 and diff.bool().float().mean().item() <= K12_FLIP_SHARE


@pytest.mark.cuda
def test_kernels_refuse_unsupported_shapes_on_cuda(cuda):
    x = torch.zeros((2, 8, 8, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_c3.conv3x3_pallas(x, torch.zeros((3, 3, 96, 128), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        t_c3.conv3x3_pallas_int8(torch.zeros((2, 8, 8, 96), device=cuda, dtype=torch.int8),
                                 torch.zeros((3, 3, 96, 128), device=cuda, dtype=torch.int8),
                                 torch.ones(128, device=cuda), torch.ones(2, device=cuda))
    with pytest.raises(ValueError):  # groups that do not divide C
        t_gn.group_norm_silu_quant(x, torch.ones(96, device=cuda), torch.zeros(96, device=cuda),
                                   num_groups=7)
