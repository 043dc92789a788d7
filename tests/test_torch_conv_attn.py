"""K8 (attention, f32 and bf16) and K11 bf16 (the 3x3 conv) as the H100
kernels take them.

On the CPU: K8's plain version on bf16 inputs against the JAX package's
``flash_attention`` in interpret mode on the same bf16 inputs, both of its
branches; the dtype each wrapper returns; the tile plan of K11's wgmma
kernel at every conv of the layer-wise paths, and K8's query tile. Cases
marked ``cuda`` hold the kernels against their plain versions on the card
at the batches the paths use and skip without one; the JAX package is
imported only by the CPU cases, so the card's machine, which has no JAX,
runs them with ``pytest --noconftest -m cuda``.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch.ops import attention as t_att
from gddim_torch.ops import conv3x3 as t_c3

# every 3x3 conv (H, Cin, Cout) of the trunk's 76 residual blocks
K11_SHAPES = [(32, 128, 128), (32, 256, 128), (32, 256, 256), (32, 384, 128), (16, 128, 128),
              (16, 128, 256), (16, 256, 256), (16, 384, 256), (16, 512, 256), (8, 256, 256),
              (8, 512, 256), (4, 256, 256), (4, 512, 256)]
# K8 bf16 against the JAX kernel on bf16 inputs, max|port - JAX| / max|JAX|.
# S = 256: the same rounding points (weights normalised, then rounded to
# bf16; f32 sums), so the gap is f32 summation order flipping a bf16 rounding
# of a weight or of the output (one bf16 step, 2^-8 = 3.9e-3 of a value, at
# most). S = 2048: the JAX kernel's blocked branch rounds the unnormalised
# weights and divides at the end, so a weight's rounding differs too. The
# bound is the bf16 kernels' gate on the card.
BF16_REL = 1e-2
K8_F32_BOUND = 1e-5  # f32 on the card: 3xTF32 against the f32 plain version
K8_BF16_BOUND = 1e-2  # bf16 on the card: the kernel against attention_xla on bf16 inputs
K11_BOUND = 1e-2  # bf16 out: f32 sums in another order, one bf16 rounding


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import flash
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=flash, pltpu=pltpu)


def _bf16_qkv(seed, b, s, c):
    """Seeded q, k, v as bf16 torch tensors and the same values as f32 numpy."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal((b, s, c)).astype(np.float32)).bfloat16()
          for _ in range(3)]
    return ts, [t.float().numpy() for t in ts]


# --------------------------------------------------------------------------
# K8 on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,c", [(3, 256, 128), (1, 2048, 128)])
def test_attention_plain_bf16_matches_flash_interpret(jx, b, s, c):
    """K8's plain version on bf16 inputs against flash_attention in interpret
    mode on the same bf16 inputs: the whole-sequence branch (S = 256) and the
    k-blocked one (S = 2048)."""
    ts, arrays = _bf16_qkv(31, b, s, c)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.flash.flash_attention(*(jx.jnp.asarray(a, jx.jnp.bfloat16) for a in arrays))
    got = t_att.flash_attention(*ts)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want.astype(jx.jnp.float32))) <= BF16_REL
    assert t_att.flash_attention.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cpu_returns_input_dtype(dtype):
    q, k, v = (torch.randn((2, 32, 64), generator=torch.Generator().manual_seed(i)).to(dtype)
               for i in range(3))
    out = t_att.flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, t_att.attention_xla(q, k, v))


@pytest.mark.parametrize("b,s,c,bf16", [
    (4, 256, 256, False), (4, 16, 256, False), (128, 256, 256, False),
    (128, 16, 256, False), (16, 256, 256, True), (16, 16, 256, True), (64, 256, 256, True),
    (64, 16, 256, True)])
def test_flash_plan_fits(b, s, c, bf16):
    """K8's whole-row query tile (S <= 1024) divides S and its CTA fits shared
    memory; outside registers the tile shrinks only while the grid leaves SMs
    idle. (S > 1024: test_torch_flash_online.py:test_flash_online_plan.)"""
    qt = t_att.flash_plan(b, s, c, bf16)
    assert qt in (16, 32, 64) and s % qt == 0
    assert t_att.flash_smem(bf16, s, c, qt) <= t_att.SMEM_MAX
    if t_att.flash_in_registers(bf16, s):
        assert qt == 64
    elif qt < 64 and s % (2 * qt) == 0 and t_att.flash_smem(bf16, s, c, 2 * qt) <= t_att.SMEM_MAX:
        assert b * s // (2 * qt) < t_att.SMS


def test_flash_plan_refuses():
    for shape in [(1, 24, 64, True), (1, 256, 96, False), (1, 8200, 256, False)]:
        with pytest.raises(ValueError):
            t_att.flash_plan(*shape)


# --------------------------------------------------------------------------
# K11's tile plan
# --------------------------------------------------------------------------


def _plan_rows(plan, b, h, w):
    """Every (tile, row) -> output pixel the kernel writes (its epilogue's
    map), as a list of pixel indices."""
    per_sample = plan.box_w * plan.box_h
    pixels = []
    for t in range(plan.m_tiles):
        b0, y0 = t // plan.tiles_h * plan.box_b, t % plan.tiles_h * plan.box_h
        for r in range(min(plan.mw * t_c3.TILE_M, per_sample * plan.box_b)):
            bi, y = b0 + r // per_sample, y0 + (r // plan.box_w) % plan.box_h
            if bi < b and y < h:
                pixels.append((bi * h + y) * w + r % plan.box_w)
    return pixels


@pytest.mark.parametrize("b", [1, 4, 16, 64])
@pytest.mark.parametrize("h,cin,cout", K11_SHAPES)
def test_conv3x3_tile_plan_covers_once(b, h, cin, cout):
    plan = t_c3.tile_plan(b, h, h, cin, cout)
    # the box: whole rows of the image, at most one tile of pixels; a tile
    # that crosses samples covers whole samples
    assert plan.mw in (1, 2) and plan.box_w == h and 1 <= plan.box_h <= h
    assert plan.box_w * plan.box_h * plan.box_b <= plan.mw * t_c3.TILE_M
    assert plan.box_b == 1 or plan.box_h == h
    # every output row once
    pixels = _plan_rows(plan, b, h, h)
    assert sorted(pixels) == list(range(b * h * h))
    # every K slice once: the splits cut [0, slices) into runs of kper, none empty
    assert plan.slices * t_c3.SLICE_K == 9 * cin and plan.n_tiles * t_c3.TILE_N == cout
    runs = [range(z * plan.kper, min(plan.slices, (z + 1) * plan.kper))
            for z in range(plan.splits)]
    assert all(len(r) > 0 for r in runs)
    assert [s for r in runs for s in r] == list(range(plan.slices))
    # split K only while the tiles leave half the SMs idle
    assert plan.splits == 1 or 2 * plan.m_tiles * plan.n_tiles <= t_c3.SMS


def test_conv3x3_tile_plan_refuses():
    for shape in [(4, 8, 8, 96, 128), (4, 8, 8, 128, 64), (1, 4, 256, 128, 128)]:
        with pytest.raises(ValueError):
            t_c3.tile_plan(*shape)


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


def _kernel_rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 64])
@pytest.mark.parametrize("h,cin,cout", K11_SHAPES)
def test_conv3x3_kernel_matches_plain_at_batch(cuda, b, h, cin, cout):
    g = torch.Generator(device=cuda).manual_seed(60)
    x = torch.randn((b, h, h, cin), generator=g, device=cuda).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=g, device=cuda) / (9 * cin) ** 0.5).bfloat16()
    with torch.no_grad():
        out, ref = t_c3.conv3x3_pallas(x, w), t_c3.conv3x3_reference(x, w)
    assert out.dtype == torch.bfloat16
    assert _kernel_rel(out, ref) <= K11_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(16, 256, 256), (16, 16, 256), (64, 256, 256), (64, 16, 256)])
def test_flash_attention_bf16_kernel_matches_plain(cuda, b, s, c):
    """The bf16 mode reads bf16 q/k/v and writes bf16, against the plain
    version on the same bf16 inputs (S = 2048: test_torch_flash_online.py)."""
    g = torch.Generator(device=cuda).manual_seed(61)
    q, k, v = (torch.randn((b, s, c), generator=g, device=cuda).bfloat16() for _ in range(3))
    before = t_att.flash_attention.launches
    out = t_att.flash_attention(q, k, v)
    assert t_att.flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16
    assert _kernel_rel(out, t_att.attention_xla(q, k, v)) <= K8_BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(128, 256, 256), (128, 16, 256)])
def test_flash_attention_f32_kernel_matches_plain_at_batch(cuda, b, s, c):
    g = torch.Generator(device=cuda).manual_seed(62)
    q, k, v = (torch.randn((b, s, c), generator=g, device=cuda) for _ in range(3))
    out = t_att.flash_attention(q, k, v)
    assert out.dtype == torch.float32
    assert _kernel_rel(out, t_att.attention_xla(q, k, v)) <= K8_F32_BOUND


@pytest.mark.cuda
def test_flash_attention_refuses_other_dtypes(cuda):
    q = torch.zeros((1, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        t_att.flash_attention(q, q, q)
