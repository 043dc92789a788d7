"""The blocks' GroupNorm statistics (``gn_stats_kernel`` for GN1, K5's GN
and the f32 paths; conv1's epilogue sums folded by conv2's pre-pass for
GN2) and their plain versions, on the CPU:

(a) ``gn_stats_reference`` against the JAX package's formula (per-channel
    sums and squares through the group indicator, var = E[x^2] - mean^2) at
    every GroupNorm shape of cld/accr_dcifar10's sampling path, f32 and bf16
    inputs, and its affine with SiLU against
    ``gddim_tpu/ops/resblock.py:_gn_silu_2d`` sample by sample;
(b) ``gn2_partials_reference`` folded by ``gn_fold_reference`` equal to
    ``gn_stats_reference`` under every int8 and bf16 tile plan of the main
    path's conv1s at B=4 and 64, tiles of several samples (8x8, 4x4) and
    split-K plans among them, and the bare GEMMs' plain versions with
    ``stats``;
(c) the rounding-point plain versions' GN2 (``group_norm_tpu``, folded)
    the affine of the same statistics.

Cases marked ``cuda`` hold the statistics kernel and the GEMM's epilogue
sums against their plain versions on the card, and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch.ops import resblock as t_rb

STATS_REL = 1e-6
EPS = 1e-6


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from gddim_tpu.ops import groupnorm, resblock

    return types.SimpleNamespace(jax=jax, jnp=jnp, gn=groupnorm, rb=resblock)


# (H, C) of every GroupNorm of the sampling path: the residual blocks' GN1
# inputs (the pairs' concatenated widths), their GN2 inputs (conv1's
# outputs), the attention blocks' and the head's
GN_SHAPES = [(32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384), (16, 512),
             (8, 256), (8, 512), (4, 256), (4, 512)]
# conv1 of the main path's residual blocks, (H, Cin, Cout) at the conv's resolution
CONV1 = [(32, 128, 128), (32, 256, 128), (32, 384, 128), (16, 128, 256), (16, 256, 256),
         (16, 384, 256), (16, 512, 256), (8, 256, 256), (8, 512, 256), (4, 256, 256),
         (4, 512, 256), (16, 128, 128), (32, 256, 256)]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _operands(rng, b, h, c, dtype):
    """x around a per-channel offset (GN's E[x^2] - mean^2 then cancels a
    part), gamma, beta."""
    x = rng.standard_normal((b, h, h, c)) + rng.standard_normal(c)
    x = torch.tensor(x, dtype=torch.float32).to(dtype)
    gamma = torch.tensor(1.0 + 0.1 * rng.standard_normal(c), dtype=torch.float32)
    beta = torch.tensor(0.1 * rng.standard_normal(c), dtype=torch.float32)
    return x, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,c", GN_SHAPES, ids=[f"{h}x{h}x{c}" for h, c in GN_SHAPES])
def test_gn_stats_reference_is_the_tpu_formula(jx, h, c, dtype):
    rng = np.random.default_rng(h * 1000 + c)
    x, gamma, beta = _operands(rng, 2, h, c, dtype)
    groups = min(c // 4, 32)
    scale, shift, mean, rstd = t_rb.gn_stats_reference(x, groups, EPS, gamma, beta)
    assert scale.shape == shift.shape == (2, c) and mean.shape == rstd.shape == (2, groups)
    jnp = jx.jnp
    xf = jnp.asarray(x.float().numpy()).reshape(2, h * h, c)
    pmat = jx.gn._group_indicator(c, groups)
    inv_n = 1.0 / (h * h * (c // groups))
    m = jnp.sum(xf, 1) @ pmat * inv_n  # each channel's group mean, (B, C)
    r = jx.jax.lax.rsqrt(jnp.sum(xf * xf, 1) @ pmat * inv_n - m * m + EPS)
    cg = c // groups
    assert rel_err(mean.repeat_interleave(cg, -1), m) <= STATS_REL
    assert rel_err(rstd.repeat_interleave(cg, -1), r) <= STATS_REL
    assert rel_err(scale, r * gamma.numpy()) <= STATS_REL
    # the affine with SiLU against the TPU kernels' own GN+SiLU of a sample
    a = x.float().reshape(2, -1, c) * scale[:, None] + shift[:, None]
    out = a * torch.sigmoid(a)
    for s in range(2):
        want = jx.rb._gn_silu_2d(xf[s], pmat, jnp.asarray(gamma.numpy())[None],
                                 jnp.asarray(beta.numpy())[None], inv_n, EPS)
        assert rel_err(out[s], want) <= STATS_REL


@pytest.mark.parametrize("batch", [4, 64])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_gn2_partials_fold_to_the_whole_sample_statistics(batch, int8):
    plan_of = t_rb.s8_tile_plan if int8 else t_rb.bf16_tile_plan
    rng = np.random.default_rng(7 + batch)
    kinds = set()
    for h, cin, cout in CONV1:
        if int8 and cin % t_rb.S8_SLICE:
            continue
        plan = plan_of(batch, h, h, cin, 0, cout)
        kinds |= {"rows" if plan.tiles_h > 1 else "samples" if plan.box_b > 1 else "one",
                  "split" if plan.splits > 1 else "whole"}
        h1 = torch.tensor(rng.standard_normal((batch, h, h, cout)) * 2 + 0.5, dtype=torch.float32)
        gamma = torch.tensor(1.0 + 0.1 * rng.standard_normal(cout), dtype=torch.float32)
        beta = torch.tensor(0.1 * rng.standard_normal(cout), dtype=torch.float32)
        part = t_rb.gn2_partials_reference(h1, plan)
        assert part.shape == (2, batch, plan.tiles_h, cout)
        flat = h1.reshape(batch, -1, cout)
        assert rel_err(part[0].sum(1), flat.sum(1)) <= STATS_REL
        assert rel_err(part[1].sum(1), (flat * flat).sum(1)) <= STATS_REL
        groups = min(cout // 4, 32)
        got = t_rb.gn_fold_reference(part, h * h, groups, EPS, gamma, beta)
        want = t_rb.gn_stats_reference(h1, groups, EPS, gamma, beta)
        for g, w in zip(got, want):
            assert rel_err(g, w) <= STATS_REL, (h, cin, cout)
    # the main path's plans cut tiles of rows of one sample, tiles of several
    # samples, and split K (at B=4; at B=64 the 4x4 and 8x8 convs split)
    assert {"rows", "samples", "split"} <= kinds


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_bare_gemm_plain_versions_give_the_partials(int8):
    """``bf16_conv_gemm`` / ``int8_conv_gemm`` with ``stats`` on the CPU:
    the plain conv and ``gn2_partials_reference`` of it under the GEMM's
    own tile plan (which may differ between the modes)."""
    rng = np.random.default_rng(11)
    b, h, cin, cout = 4, 8, 256, 256
    if int8:
        a = torch.tensor(rng.integers(-127, 128, (b, h, h, cin)), dtype=torch.int8)
        w = torch.tensor(rng.integers(-127, 128, (3, 3, cin, cout)), dtype=torch.int8)
        out, part = t_rb.int8_conv_gemm(a, w, stats=True)
        plan = t_rb.s8_tile_plan(b, h, h, cin, 0, cout)
        assert torch.equal(out, t_rb.int8_conv_gemm(a, w))
    else:
        a = torch.tensor(rng.standard_normal((b, h, h, cin)), dtype=torch.bfloat16)
        w = torch.tensor(rng.standard_normal((3, 3, cin, cout)) / 48, dtype=torch.bfloat16)
        out, part = t_rb.bf16_conv_gemm(a, w, stats=True)
        plan = t_rb.bf16_tile_plan(b, h, h, cin, 0, cout)
        assert torch.equal(out, t_rb.bf16_conv_gemm(a, w))
    assert torch.equal(part, t_rb.gn2_partials_reference(out, plan))


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "centred"])
def test_rounding_point_gn_is_the_affine_of_the_same_statistics(fold):
    """``group_norm_tpu`` (the int8 and bf16 plain versions' GN) is the
    affine of ``gn_stats_reference``'s statistics, folded (x * a + b, the
    kernels' form) or centred ((x - mean) * rstd * gamma + beta)."""
    rng = np.random.default_rng(12)
    x, gamma, beta = _operands(rng, 2, 8, 256, torch.float32)
    scale, shift, mean, rstd = t_rb.gn_stats_reference(x, 32, EPS, gamma, beta)
    got = t_rb.group_norm_tpu(x, gamma, beta, 32, EPS, True, fold)
    a = x.reshape(2, -1, 256) * scale[:, None] + shift[:, None]
    assert rel_err(got.reshape(2, -1, 256), a * torch.sigmoid(a)) <= STATS_REL


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


# the kernel's f32 sums in another order than the plain version's: about 3x
# the errors chip_smoke.py measures on an H100 (at most 3.5e-7)
KERNEL_STATS_REL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,parts", [(4, 32, (128,)), (4, 32, (256, 128)), (64, 16, (256, 256)),
                                       (16, 4, (512,)), (2, 8, (64, 32))])
def test_gn_stats_kernel_matches_its_plain_version(cuda, b, h, parts, dtype):
    rng = np.random.default_rng(20 + h)
    xs = [_operands(rng, b, h, c, dtype)[0].to(cuda) for c in parts]
    c = sum(parts)
    gamma = torch.tensor(1.0 + 0.1 * rng.standard_normal(c), dtype=torch.float32, device=cuda)
    beta = torch.tensor(0.1 * rng.standard_normal(c), dtype=torch.float32, device=cuda)
    groups = min(c // 4, 32)
    t_rb.block_launches(reset=True)
    with torch.no_grad():
        got = t_rb.gn_stats(*xs, gamma, beta, num_groups=groups, eps=EPS) if len(xs) == 2 else \
            t_rb.gn_stats(xs[0], None, gamma, beta, num_groups=groups, eps=EPS)
        again = t_rb.gn_stats(*xs, gamma, beta, num_groups=groups, eps=EPS) if len(xs) == 2 else \
            t_rb.gn_stats(xs[0], None, gamma, beta, num_groups=groups, eps=EPS)
    torch.cuda.synchronize()
    assert t_rb.block_launches(kernels=("gn_stats_kernel",)) == {"gn_stats_kernel": 2}
    want = t_rb.gn_stats_reference(torch.cat(xs, -1), groups, EPS, gamma, beta)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # a fixed order: the same bits every run
        assert rel_err(g.cpu(), w.cpu()) <= KERNEL_STATS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b,h,cin,cout", [(4, 32, 128, 128), (64, 32, 128, 128), (4, 8, 256, 256),
                                          (64, 4, 256, 256), (4, 4, 512, 256)])
def test_gemm_epilogue_sums_match_their_plain_version(cuda, b, h, cin, cout, int8):
    """conv1's epilogue (or the split-K reduction) writes GN2's partials of
    what it stores: against ``gn2_partials_reference`` of the same output
    under the same plan (the int8 sums exact, so the partials' f32 order
    alone differs), and the same bits on repeat."""
    g = torch.Generator(device=cuda).manual_seed(30 + h)
    if int8:
        a = torch.randint(-127, 128, (b, h, h, cin), generator=g, device=cuda, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, 9 * cin), generator=g, device=cuda,
                           dtype=torch.int8)
        run = lambda: t_rb.int8_conv_gemm(a, wq, stats=True)  # noqa: E731
        plan = t_rb.s8_tile_plan(b, h, h, cin, 0, cout)
    else:
        a = torch.randn((b, h, h, cin), generator=g, device=cuda).bfloat16()
        w = (torch.randn((3, 3, cin, cout), generator=g, device=cuda) / 48).bfloat16()
        run = lambda: t_rb.bf16_conv_gemm(a, w, stats=True)  # noqa: E731
        plan = t_rb.bf16_tile_plan(b, h, h, cin, 0, cout)
    with torch.no_grad():
        out, part = run()
        out2, part2 = run()
    torch.cuda.synchronize()
    assert torch.equal(part, part2) and torch.equal(out, out2)
    assert rel_err(part.cpu(), t_rb.gn2_partials_reference(out, plan).cpu()) <= KERNEL_STATS_REL
