"""K1, GroupNorm(+SiLU) (``gddim_torch/ops/groupnorm.py:group_norm_silu``,
``csrc/groupnorm.cu``), against the JAX package on the CPU:

(a) the plain version against ``gddim_tpu/ops/groupnorm.py:group_norm_silu``
    (its XLA form off a TPU) and its Pallas kernel ``_gn_silu_pallas`` in
    interpret mode, bf16 and f32, with and without SiLU;
(b) the cluster plan ``gn_silu_ctas`` as a pure function: every K1 site of
    both configs, the training shapes, B = 1 to 128;
(c) the wrapper's C call (``_build.launch`` replaced).

Cases marked ``cuda`` hold the kernel against its plain version on the
card (the same bits on repeat) and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import groupnorm as t_gn
from gddim_torch.ops import resblock as t_rb


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU cases only (the card's machine
    runs the ``cuda`` cases with ``pytest --noconftest -m cuda``)."""
    import jax.numpy as jnp
    from gddim_tpu.ops import groupnorm
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jnp=jnp, gn=groupnorm, pltpu=pltpu)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def draw(seed, shape, dtype):
    """x (offset mean: a one-pass variance loses digits there), scale, bias
    from numpy; x rounded to ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (2.0 + rng.standard_normal(shape)).astype(np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()
    return [x, (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32)]


# (a) bf16: both sides round the f32 result once to bf16 (2^-8 relative) from
# statistics in another order; f32: the plain version's two-pass variance
# against the XLA reference's (its form) and the Pallas kernel's one-pass
# E[x^2] - mean^2 (measured below 1e-6 here)
BF16_REL = 1e-2
F32_REL = 1e-5
CASES = [((2, 8, 8, 128), 32), ((2, 4, 4, 256), 32), ((3, 16, 16, 128), 16)]


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape,groups", CASES, ids=["8x8x128", "4x4x256", "16x16x128"])
def test_plain_matches_jax_group_norm_silu(jx, shape, groups, dtype, silu):
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    jdt = {"bf16": jx.jnp.bfloat16, "f32": jx.jnp.float32}[dtype]
    x, s, b = draw(7, shape, tdt)
    got = t_gn.group_norm_silu(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                               torch.from_numpy(b), groups, 1e-6, silu)
    assert got.dtype == tdt and got.shape == shape
    jargs = (jx.jnp.asarray(x).astype(jdt), jx.jnp.asarray(s), jx.jnp.asarray(b))
    want = jx.gn.group_norm_silu(*jargs, groups, 1e-6, silu)
    with jx.pltpu.force_tpu_interpret_mode():
        want_kernel = jx.gn._gn_silu_pallas(*jargs, groups, 1e-6, silu)
    bound = BF16_REL if dtype == "bf16" else F32_REL
    for w in (want, want_kernel):
        assert rel_err(got.float(), np.asarray(w.astype(jx.jnp.float32))) <= bound


# --------------------------------------------------------------------------
# (b) the plan
# --------------------------------------------------------------------------

# (H, C) of every K1 site of both configs (the trunk's GroupNorms on the
# layer-wise paths, the transitions, attention, the head) and the training
# shapes
SITES = sorted({(32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384), (16, 512),
                (8, 256), (8, 512), (4, 256), (4, 512)})


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("h,c", SITES)
def test_plan_holds_every_site_at_every_batch(h, c, itemsize):
    """A cluster of 1-16 CTAs holds every site's sample in shared memory at
    B = 1 to 128; more CTAs a sample only at a smaller batch, never fewer
    than at a larger one."""
    last = None
    for b in range(128, 0, -1):
        k = t_rb.gn_silu_ctas(b, h, h, c, itemsize)
        assert k in t_rb.GN_SILU_CLUSTERS
        assert t_rb.gn_silu_holds(h, h, c, itemsize, k), (b, k)
        assert t_rb.gn_silu_smem(c, itemsize, -(-(h * h) // k), True) <= t_rb.SMEM_BYTES
        assert last is None or k >= last
        last = k
    # the fewest that hold it where the batch fills the card
    k = t_rb.gn_silu_ctas(128, h, h, c, itemsize)
    fewer = [q for q in t_rb.GN_SILU_CLUSTERS if q < k]
    assert all(not t_rb.gn_silu_holds(h, h, c, itemsize, q) for q in fewer)


def test_plan_takes_one_cta_at_the_small_sites_and_spreads_a_small_batch():
    # 4x4, 8x8 and 16x16 bf16: 8 / 32 / 128 KB, one CTA holds each
    for h in (4, 8, 16):
        assert t_rb.gn_silu_ctas(128, h, h, 256, 2) == 1
    assert t_rb.gn_silu_ctas(4, 4, 4, 256, 2) == 1  # 8 KB: no share of 16 KB to spread
    assert t_rb.gn_silu_ctas(4, 8, 8, 256, 2) == 2
    assert t_rb.gn_silu_ctas(4, 16, 16, 256, 2) == 8
    assert t_rb.gn_silu_ctas(64, 16, 16, 256, 2) == 2  # 128 CTAs
    assert t_rb.gn_silu_ctas(64, 32, 32, 128, 2) == 2  # 256 KB: two CTAs hold it
    assert t_rb.gn_silu_ctas(128, 32, 32, 256, 4) == 8  # 1 MB of f32


def test_plan_streams_what_16_ctas_cannot_hold():
    assert t_rb.gn_silu_ctas(4, 128, 128, 128, 4) == 16
    assert not t_rb.gn_silu_holds(128, 128, 128, 4, 16)


def test_smem_mirrors_the_kernels_layout():
    """The share (128-byte aligned) and 4 C (lanes + 7) floats: 256
    threads over 16-byte vectors, or one channel each where C does not
    divide into them."""
    assert t_rb.gn_silu_vec(256, 2) == 8 and t_rb.gn_silu_vec(256, 4) == 4
    assert t_rb.gn_silu_vec(36, 2) == 1 and t_rb.gn_silu_vec(36, 4) == 4
    assert t_rb.gn_silu_smem(256, 2, 16, True) == 16 * 256 * 2 + 4 * 256 * (8 + 7)
    assert t_rb.gn_silu_smem(256, 2, 16, False) == 4 * 256 * (8 + 7)
    assert t_rb.gn_silu_smem(3, 2, 5, True) == 128 + 4 * 3 * (85 + 7)
    assert t_rb.gn_silu_smem(4096, 2, 1, True) == 8192 + 4 * 4096 * (1 + 7)


# --------------------------------------------------------------------------
# (c) the wrapper's C call
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 0), (torch.float16, 1),
                                        (torch.float32, 2)])
@pytest.mark.parametrize("shape,groups", [((4, 32, 32, 128), 32), ((2, 4, 4, 36), 9)])
def test_wrapper_passes_its_plan(monkeypatch, dtype, code, shape, groups):
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(t_gn.group_norm_silu, "launches", t_gn.group_norm_silu.launches)
    x = torch.zeros(shape, dtype=dtype)
    t_gn._group_norm_silu_kernel(x, torch.ones(shape[-1]), torch.zeros(shape[-1]), groups, 1e-6,
                                 False)
    ((name, a),) = calls
    b, h, w, c = shape
    ctas = t_rb.gn_silu_ctas(b, h, w, c, x.element_size())
    assert name == "gddim_gn_silu" and len(a) + 1 == len(_build._SIGNATURES[name])
    assert a[1:6] == (code, b, h * w, c, groups) and a[8:10] == (1e-6, 0)
    assert a[10:12] == (ctas, int(t_rb.gn_silu_holds(h, w, c, x.element_size(), ctas)))
    assert t_gn.group_norm_silu.launches == 1


def test_wrapper_refuses_groups_that_do_not_divide_c():
    with pytest.raises(ValueError, match="unsupported"):
        t_gn._group_norm_silu_kernel(torch.zeros(1, 4, 4, 30), torch.ones(30), torch.zeros(30),
                                     4, 1e-6, True)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# bf16 and f16: the f32 result rounded once (chip_smoke.py's K1 bound); f32:
# its K1 f32 bound (f32 sums in another order)
CARD_BOUND = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-6}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,h,c,groups", [(4, 32, 128, 32), (64, 16, 256, 32), (2, 4, 256, 32),
                                          (3, 8, 36, 9), (1, 7, 42, 6), (2, 128, 128, 32)])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
def test_kernel_matches_plain(cuda, dtype, b, h, c, groups, silu):
    """Every plan shape: one CTA, clusters of 2-16, 16-byte vectors and
    scalar ones (C 36 in bf16 and f16, 42 in each type), a share 16 CTAs cannot hold
    (128x128x128 f32 at B=2); the same bits on repeat."""
    g = torch.Generator(device=cuda).manual_seed(31)
    x = (2.0 + torch.randn((b, h, h, c), generator=g, device=cuda)).to(dtype)
    s = 1.0 + 0.1 * torch.randn(c, generator=g, device=cuda)
    bias = 0.1 * torch.randn(c, generator=g, device=cuda)
    out = t_gn.group_norm_silu(x, s, bias, groups, 1e-6, silu)
    again = t_gn.group_norm_silu(x, s, bias, groups, 1e-6, silu)
    ref = t_gn.group_norm_silu_reference(x.float(), s, bias, groups, 1e-6, silu)
    assert out.dtype == dtype and out.shape == x.shape and torch.equal(out, again)
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= CARD_BOUND[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", SITES)
def test_smem_matches_the_launchers(cuda, h, c):
    lib = _build.library()
    for itemsize in (2, 4):
        for ctas in t_rb.GN_SILU_CLUSTERS:
            for hold in (True, False):
                assert lib.gddim_gn_silu_smem(c, itemsize, h * h, ctas, int(hold)) == \
                    t_rb.gn_silu_smem(c, itemsize, -(-(h * h) // ctas), hold)
