"""K8's k-blocked online-softmax kernel (S > 1024) as the H100 port takes it.

On the CPU: its plain version (``flash_attention_blocked_reference``, the
TPU blocked branch's recurrence and rounding points) against the JAX
package's ``flash_attention`` in interpret mode on the same inputs, f32 and
bf16; the gate and plan (``flash_plan``: every S > 1024 that is a multiple
of 16 takes the online kernels, bf16 with 128 or 64 queries a CTA by grid
fill, f32 with 128 or (C = 256) 64, and each CTA fits shared memory); the
short last block; the f32 form's split pre-pass (``online_split_reference``:
TF32 hi and lo planes, v^T in the kernel's key order) against a numpy
reconstruction; the wrappers' C calls with ``_build.launch`` replaced; and a
small NCSN++ that attends at its top level (48x48, S = 2304) against the JAX
package's on the same weights. Cases marked ``cuda`` hold the kernels
against their plain versions on the card (the pre-pass bit for bit), and
each kernel's output against itself on a second launch, and skip without
one (the card's machine runs them with ``pytest --noconftest -m cuda``; the
JAX package is imported only by CPU cases).
"""

import types

import numpy as np
import pytest
import torch

from gddim_torch import _build
from gddim_torch.ops import attention as t_att
from gddim_torch.ops import resblock as t_rb

# the reference against the JAX blocked kernel, max|port - JAX| / max|JAX|:
# f32 sums in another order (XLA's and torch's einsums); bf16 one step of a
# rounded weight or of the output at most (test_torch_conv_attn.BF16_REL)
F32_REL = 1e-6
BF16_REL = 1e-2
K8_BF16_BOUND = 1e-2  # the kernel against the reference on the card
K8_F32_BOUND = 1e-5
MODEL_REL = 1e-4  # the f32 network against the JAX package (test_torch_model.MODEL_REL)


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


def _qkv(seed, b, s, c, dtype):
    """Seeded q, k, v in ``dtype`` as torch tensors and their values as f32 numpy."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal((b, s, c)).astype(np.float32)).to(dtype)
          for _ in range(3)]
    return ts, [t.float().numpy() for t in ts]


# --------------------------------------------------------------------------
# (a) the plain version against the JAX blocked branch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,c", [(1, 1536, 128), (1, 2048, 128), (1, 4096, 128)])
def test_blocked_reference_matches_jax_interpret(jx, b, s, c, dtype):
    ts, arrays = _qkv(41, b, s, c, dtype)
    jdt = jx.jnp.bfloat16 if dtype == torch.bfloat16 else jx.jnp.float32
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.flash.flash_attention(*(jx.jnp.asarray(a, jdt) for a in arrays))
    got = t_att.flash_attention_blocked_reference(*ts)
    assert got.dtype == dtype and got.shape == (b, s, c)
    bound = BF16_REL if dtype == torch.bfloat16 else F32_REL
    assert rel_err(got.float(), np.asarray(want.astype(jx.jnp.float32))) <= bound


def test_blocked_reference_short_last_block():
    """S not a multiple of 512: the last block is shorter (the TPU wrapper
    asserts a multiple); in f32 the recurrence is the softmax still."""
    ts, _ = _qkv(42, 2, 1040, 64, torch.float32)
    got = t_att.flash_attention_blocked_reference(*ts)
    assert rel_err(got, t_att.attention_xla(*ts)) <= F32_REL
    # one block of all the keys is the whole-sequence softmax, bf16 rounding aside
    whole = t_att.flash_attention_blocked_reference(*ts, block_k=1040)
    assert rel_err(whole, t_att.attention_xla(*ts)) <= F32_REL


# --------------------------------------------------------------------------
# (b) the gate and the plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,c,bf16,qt", [
    (1, 2048, 128, False, 128), (1, 2048, 256, True, 64), (1, 1040, 64, True, 64),
    (2, 3072, 128, True, 64), (16, 4096, 128, True, 128), (4, 4096, 256, True, 128),
    (8, 4096, 128, False, 128), (1, 16384, 128, True, 128), (1, 65536, 256, False, 64),
    (1, 65536, 64, True, 128), (8, 4096, 64, True, 128), (2, 2064, 128, True, 64),
    (5, 1664, 256, True, 64), (6, 1408, 256, True, 128), (2, 2064, 64, False, 128),
    (32, 4096, 128, False, 128), (4, 4096, 256, False, 64)])
def test_flash_online_plan(b, s, c, bf16, qt):
    """Every S > 1024 that is a multiple of 16 takes the online kernels, at
    any length (a CTA keeps nothing per key): f32 128 queries a CTA (two
    consumer warpgroups) at C = 64 and 128, 64 at C = 256 (one: its q
    planes fill half the CTA's shared memory), at any grid; bf16 128 (two
    consumer warpgroups) where B * ceil(S / 128) CTAs cover at least half
    the 132 SMs, else 64 (one warpgroup, two CTAs an SM)."""
    assert t_att.flash_online(s)
    assert t_att.flash_plan(b, s, c, bf16) == qt


@pytest.mark.parametrize("c", [64, 128, 256])
def test_flash_online_smem_fits(c):
    """The bf16 kernel's CTA fits the H100's shared memory at every plan and
    length, and two of the 64-query CTAs fit one SM (228 KB, 1 KB of each
    reserved), as their launch bounds assume."""
    for s in range(1040, 65537, 16 * 97):
        for b in (1, 2, 16, 64):
            qt = t_att.flash_plan(b, s, c, True)
            assert t_att.flash_online_smem(c, qt) <= t_att.SMEM_MAX
    assert 2 * (t_att.flash_online_smem(c, 64) + 1024) <= 228 * 1024
    assert t_att.flash_online_smem(c, 128) <= t_att.SMEM_MAX


@pytest.mark.parametrize("c", [64, 128, 256])
def test_flash_online_f32_smem_fits(c):
    """The f32 kernel's CTA (its q planes and ring, ``ot_smem``) fits the
    H100's 227 KB at its plan's queries for every C, at any length and batch
    (the plan depends on C alone), and a CTA is one an SM (the launch bound
    the kernel's registers assume)."""
    qts = {t_att.flash_plan(b, s, c, False) for s in (1040, 2064, 4096, 65536) for b in (1, 64)}
    assert qts == {t_att.online_f32_qt(c)}
    smem = t_att.flash_online_f32_smem(c, t_att.online_f32_qt(c))
    assert smem <= t_att.SMEM_MAX
    assert 2 * (smem + 1024) > 228 * 1024


def test_whole_row_kernels_keep_s_up_to_1024():
    for s in (16, 256, 1024):
        assert not t_att.flash_online(s)
        qt = t_att.flash_plan(4, s, 256, False)
        assert t_att.flash_smem(False, s, 256, qt) <= t_att.SMEM_MAX


def test_flash_attention_cpu_long_sequence_is_the_plain_version():
    ts, _ = _qkv(43, 1, 2048, 64, torch.bfloat16)
    launches = t_att.flash_attention.launches
    out = t_att.flash_attention(*ts)
    assert torch.equal(out, t_att.attention_xla(*ts))
    assert t_att.flash_attention.launches == launches


def test_flash_attention_calls_the_online_entry(monkeypatch):
    """On a CUDA tensor (CPU tensors with the device test and ``_build.launch``
    replaced) S > 1024 calls gddim_flash_online with its signature's
    arguments (B, S, C, the plan's queries a CTA, bf16); S <= 1024 the
    whole-row entry, which alone counts in flash_attention.launches."""
    calls = []

    def launch(name, device, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[name]), name
        assert all(isinstance(a, (int, float)) for a in args), name
        calls.append((name, args))

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(t_att, "_on_cpu", lambda x, what: False)
    monkeypatch.setattr(t_att, "_operand", lambda t, what, dtype, shape=None: t)
    monkeypatch.setattr(t_att.flash_attention, "launches", 0)
    for b, s, dtype in ((2, 2048, torch.bfloat16), (2, 4096, torch.float32),
                        (1, 16384, torch.bfloat16), (2, 256, torch.bfloat16)):
        q = torch.zeros((b, s, 128), dtype=dtype)
        assert t_att.flash_attention(q, q, q).dtype == dtype
    assert [n for n, _ in calls] == ["gddim_flash_online"] * 3 + ["gddim_flash_attention"]
    assert calls[0][1][4:9] == (2, 2048, 128, 64, 1)
    assert calls[1][1][4:9] == (2, 4096, 128, 128, 0)
    assert calls[2][1][4:9] == (1, 16384, 128, 128, 1)
    assert calls[0][1][9] == pytest.approx(128 ** -0.5)
    # the f32 form's scratch (the split pre-pass's planes); bf16 passes NULL
    assert calls[1][1][10] != 0 and calls[0][1][10] == 0 and calls[2][1][10] == 0
    assert t_att.flash_attention.launches == 1


def test_online_split_calls_its_entry(monkeypatch):
    """On a CUDA tensor (CPU tensors with the device test and
    ``_build.launch`` replaced) the pre-pass alone calls
    gddim_flash_online_split with its signature's arguments and returns
    views of one 6 B S C workspace; it refuses bf16 and unsupported shapes."""
    calls = []

    def launch(name, device, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[name]), name
        assert all(isinstance(a, int) for a in args), name
        calls.append((name, args))

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(t_att, "_on_cpu", lambda x, what: False)
    monkeypatch.setattr(t_att, "_operand", lambda t, what, dtype, shape=None: t)
    q = torch.zeros((2, 2064, 64))
    qs, ks, vts = t_att.online_split(q, q, q)
    assert [n for n, _ in calls] == ["gddim_flash_online_split"]
    assert calls[0][1][4:] == (2, 2064, 64)
    assert qs.shape == ks.shape == (2, 2, 2064, 64) and vts.shape == (2, 2, 64, 2064)
    assert qs.data_ptr() == calls[0][1][3]
    assert vts.data_ptr() - qs.data_ptr() == 4 * 4 * 2 * 2064 * 64
    for bad in (q.to(torch.bfloat16), torch.zeros((2, 2056, 64)), torch.zeros((2, 2064, 96))):
        with pytest.raises(ValueError):
            t_att.online_split(bad, bad, bad)


def _tf32_rna(x):
    """numpy: f32 rounded to TF32 to nearest, ties away from zero (the low
    13 bits dropped), by integer arithmetic on the magnitude."""
    bits = x.view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    mag = ((mag.astype(np.uint64) + 0x1000) >> 13 << 13).astype(np.uint32)
    return (sign | mag).view(np.float32)


@pytest.mark.parametrize("b,s,c", [(1, 1040, 64), (2, 48, 128), (1, 32, 256)])
def test_online_split_reference_matches_numpy(b, s, c):
    """The pre-pass's plain version: hi = x rounded to TF32 (to nearest,
    ties away), lo = (x - hi) rounded likewise, both with 13 zero low bits,
    hi + lo within 2^-21 of x; v^T (B, C, S) with the keys of each 8 in the
    order (0, 2, 4, 6, 1, 3, 5, 7). Ties at the 13th bit included."""
    ts, arrays = _qkv(44, b, s, c, torch.float32)
    # exact ties: 1 + 2^-11 (hi rounds away from zero), its negative
    arrays[0][0, 0, :2] = [1 + 2.0 ** -11, -(1 + 2.0 ** -11)]
    ts[0] = torch.from_numpy(arrays[0].copy())
    got = t_att.online_split_reference(*ts)
    order = np.array(t_att.ONLINE_KEY_ORDER)
    perm = (np.arange(s) // 8 * 8) + np.tile(order, s // 8)
    wants = [arrays[0], arrays[1], arrays[2].transpose(0, 2, 1)[..., perm]]
    for plane, x in zip(got, wants):
        hi = _tf32_rna(np.ascontiguousarray(x))
        lo = _tf32_rna((x - hi).astype(np.float32))
        assert np.array_equal(plane[0].numpy(), hi) and np.array_equal(plane[1].numpy(), lo)
        assert not (plane.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
        err = np.abs(hi.astype(np.float64) + lo - x) / np.maximum(np.abs(x), 1e-30)
        assert err.max() <= 2.0 ** -21
    assert got[0][0, 0, 0, 0].item() == 1 + 2.0 ** -10
    assert got[0][0, 0, 0, 1].item() == -(1 + 2.0 ** -10)


def test_online_split_cpu_is_the_plain_version():
    ts, _ = _qkv(45, 1, 1040, 64, torch.float32)
    got, want = t_att.online_split(*ts), t_att.online_split_reference(*ts)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_online_kernel_is_counted_in_c():
    src = (_build._CSRC / "conv.cuh").read_text()
    assert f"COUNT_FLASH_ONLINE = {t_rb.BLOCK_COUNTED.index('flash_online_kernel')}," in src
    assert f"COUNT_ONLINE_SPLIT = {t_rb.BLOCK_COUNTED.index('online_split_kernel')}," in src
    assert f"N_COUNTED = {len(t_rb.BLOCK_COUNTED)}" in src


def test_flash_plan_refuses_what_neither_kernel_takes():
    for shape in [(1, 2056, 128, True), (1, 4096, 96, False), (1, 4100, 64, True)]:
        with pytest.raises(ValueError):
            t_att.flash_plan(*shape)


# --------------------------------------------------------------------------
# (c) a network that attends at 48x48 (S = 2304) against the JAX package
# --------------------------------------------------------------------------


def test_ncsnpp_attending_at_48x48_matches_jax():
    import flax
    import jax
    import jax.numpy as jnp

    from gddim_torch.configs import get_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model, seeded_params
    from gddim_torch.models.wrappers import make_cld_eps_fn
    from gddim_tpu.configs import get_config as jax_get_config
    from gddim_tpu.math.cld import CLD as JaxCLD
    from gddim_tpu.models import get_model
    from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn

    def small(cfg):
        cfg.model.nf = 32
        cfg.model.ch_mult = (1, 2)
        cfg.model.num_res_blocks = 1
        cfg.model.attn_resolutions = (48,)
        cfg.data.image_size = 48
        cfg.model.dtype = "float32"
        cfg.model.conv_impl = "fused"
        return cfg

    jcfg = small(jax_get_config("cld/accr_dcifar10"))
    jmodel = get_model("ncsnpp")(config=jcfg)
    cfg = small(get_config("cld/accr_dcifar10"))
    tree = seeded_params(cfg, 0)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((1, 48, 48, 3, 2)).astype(np.float32)
    t = np.array([0.5], np.float32)
    # one compile of the whole forward: faster on the CPU than op-by-op dispatch
    want = jax.jit(jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), jmodel))(
        {"params": flax.core.freeze(jax.tree.map(jnp.asarray, tree))}, jnp.asarray(u),
        jnp.asarray(t))
    model = seeded_model(cfg, 0)
    with torch.no_grad():
        got = make_cld_eps_fn(CLD.from_config(cfg))(model, torch.from_numpy(u),
                                                     torch.from_numpy(t))
    assert got.shape == u.shape and bool(torch.isfinite(got).all())
    assert rel_err(got, want) <= MODEL_REL


# --------------------------------------------------------------------------
# (d) the kernel on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,c", [(2, 1040, 64), (1, 2048, 256), (2, 3072, 128),
                                   (1, 4096, 256), (8, 4096, 64), (2, 2064, 128),
                                   (1, 16384, 128)])
def test_flash_online_kernel_matches_plain(cuda, b, s, c, dtype):
    g = torch.Generator(device=cuda).manual_seed(63)
    q, k, v = (torch.randn((b, s, c), generator=g, device=cuda).to(dtype) for _ in range(3))
    before = t_rb.block_launches()["flash_online_kernel"]
    got = t_att.flash_attention(q, k, v)
    assert t_rb.block_launches()["flash_online_kernel"] == before + 1
    want = t_att.flash_attention_blocked_reference(q, k, v)
    bound = K8_BF16_BOUND if dtype == torch.bfloat16 else K8_F32_BOUND
    assert got.dtype == dtype
    assert rel_err(got.float().cpu(), want.float().cpu()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,dtype", [
    (2, 2064, 128, torch.bfloat16), (16, 4096, 128, torch.bfloat16),
    (4, 4096, 256, torch.bfloat16), (2, 2064, 64, torch.float32), (8, 4096, 128, torch.float32),
    (2, 2064, 256, torch.float32)])
def test_flash_online_kernel_repeats_bit_for_bit(cuda, b, s, c, dtype):
    """Each kernel launched twice on the same inputs writes the same bits
    (no atomics, a fixed summation order): bf16 at 64 and 128 queries a CTA,
    f32 at each C."""
    g = torch.Generator(device=cuda).manual_seed(64)
    q, k, v = (torch.randn((b, s, c), generator=g, device=cuda).to(dtype) for _ in range(3))
    first = t_att.flash_attention(q, k, v)
    second = t_att.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(2, 2064, 64), (8, 4096, 128), (1, 2048, 256)])
def test_online_split_kernel_matches_plain_bit_for_bit(cuda, b, s, c):
    g = torch.Generator(device=cuda).manual_seed(65)
    q, k, v = (torch.randn((b, s, c), generator=g, device=cuda) for _ in range(3))
    before = t_rb.block_launches()["online_split_kernel"]
    got = t_att.online_split(q, k, v)
    assert t_rb.block_launches()["online_split_kernel"] == before + 1
    for plane, want in zip(got, t_att.online_split_reference(q, k, v)):
        assert torch.equal(plane, want)
