"""K8: single-head spatial self-attention over flattened tokens.

Counterpart of ``gddim_tpu/ops/attention.py`` and ``gddim_tpu/ops/flash.py``:

- ``attention_xla``: the plain version, softmax(q k^T / sqrt(C)) v with f32
  logits and softmax (``attention.py:21``);
- ``flash_attention``: K8 (``flash.py:97``), hand-written kernels on the
  tensor cores (each header says what bounds it on the H100), in the input's
  dtype: f32 (3xTF32) or bf16, S a multiple of 16, C in {64, 128, 256}, as
  the JAX wrapper branches (``flash_plan``): S <= 1024 the whole-sequence
  kernels of ``csrc/flash.cu`` (a query's row of scores on chip; the
  normalised weights rounded to bf16 before w v, the plain version's
  rounding points), so the 4x4 mid-block attention (S = 16), which the JAX
  package sends to XLA for the TPU's 128-lane gate, runs them too; S > 1024
  the k-blocked online-softmax kernels with the TPU blocked branch's
  rounding points (``flash_attention_blocked_reference``), for any length:
  bf16 on ``csrc/flash_online_wgmma.cu`` (wgmma for q k^T and p v, fed by
  TMA from a producer warpgroup, 64 or 128 queries a CTA by
  ``flash_plan``), f32 on ``csrc/flash_online.cu`` (3xTF32 on wgmma fed by
  TMA, after a pre-pass that splits q, k and v^T into TF32 hi and lo planes:
  ``online_split``, plain version ``online_split_reference``);
- ``flash_attention_blocked_reference``: the plain version of the blocked
  branch (``flash.py:50-95``): the running max, sum and accumulator over
  512-key blocks, the unnormalised weights rounded to v's dtype, one
  division at the end;
- ``attention_pallas``: K8 forward with the gradient of the plain version
  recomputed from (q, k, v), as the JAX ``custom_vjp`` (``attention.py:35-54``);
- ``attention_einsum5d``: the reference-shaped attention
  (``attention.py:67-75``), ``bhwc,bHWc->bhwHW`` logits in q's dtype, the
  (B, H, W, H, W) scores materialised; the x1 baseline's attention
  (``model.attention_impl='einsum5d'``, ``bench.py``'s ``ref`` mode);
- ``self_attention_2d``: the (B, H, W, C) entry the attention block calls,
  by ``impl`` (``ATTENTION_IMPLS``, the JAX values).

On a CPU tensor ``flash_attention`` runs the plain version ``attention_xla``
(what the JAX package runs off the TPU); on a CUDA tensor it launches a
kernel or raises.
"""

from __future__ import annotations

import torch

from gddim_torch import _build
from gddim_torch.configs import ATTENTION_IMPLS
from gddim_torch.ops.resblock import _on_cpu, _operand, require_no_grad


def attention_xla(q, k, v):
    """(B, S, C) attention, f32 logits and softmax; the weights round to
    q's dtype before p.v, as the JAX package's version does."""
    c = q.shape[-1]
    logits = torch.einsum("bsc,btc->bst", q.float(), k.float()) * c ** (-0.5)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bst,btc->bsc", w.float(), v.float()).to(q.dtype)


SMEM_MAX = 232448  # shared memory a block may have on the H100 (227 KB)
SMS = 132


REG_SMAX = 256  # bf16 rows up to this length stay in registers (flash_reg_kernel)


def flash_in_registers(bf16: bool, s: int) -> bool:
    """Whether K8 keeps a row of scores in registers (bf16, S a multiple of
    64 up to REG_SMAX) rather than in shared memory."""
    return bf16 and s % 64 == 0 and s <= REG_SMAX


def flash_smem(bf16: bool, s: int, c: int, qt: int) -> int:
    """Shared memory of one K8 CTA (``csrc/flash.cu``): in registers
    (``reg_smem``), the 64-query tile and four 32-key k/v tiles; else
    (``fl_smem``) the q tile, two k/v tiles of 64 (bf16) or 32 (f32) keys,
    the (qt, S) f32 scores and the row statistics. Rows are padded by 16
    bytes."""
    if flash_in_registers(bf16, s):
        return (qt + 4 * 32) * (c + 8) * 2
    size, ldt, kt = (2, c + 8, 64) if bf16 else (4, c + 4, 32)
    return qt * ldt * size + 2 * kt * ldt * size + qt * (s + 4) * 4 + 2 * qt * 4


ONLINE_MIN_S = 1024  # longer sequences take the online-softmax kernel (the JAX branch point)
BLOCK_K = 512  # the statistics block, the TPU kernel's block_k
# the f32 form's key order within each 8 keys of v^T (csrc/flash_online.cu)
ONLINE_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def flash_online_smem(c: int, qt: int) -> int:
    """Shared memory of one CTA of the bf16 online kernel
    (``csrc/flash_online_wgmma.cu``, ``ow_smem``) with ``qt`` queries (one
    consumer warpgroup each 64): the q tiles, a ring of 4 (qt 128) or 2 (qt
    64, two CTAs an SM) K / V slices of 128 keys (64 at C = 256), 1 KB of
    alignment and the mbarriers."""
    stages = 4 if qt == 128 else 2
    kn = 64 if c == 256 else 128
    return qt * c * 2 + stages * kn * c * 2 + 1024 + 8 * (2 * stages + 1)


def online_f32_qt(c: int) -> int:
    """The f32 online kernel's queries a CTA (``csrc/flash_online.cu``,
    ``OtShape<C>::NWG`` consumer warpgroups of 64): 128 at C = 64 and 128,
    64 at C = 256, where one warpgroup's q planes fill half the CTA's shared
    memory."""
    return 64 if c == 256 else 128


def flash_online_f32_smem(c: int, qt: int) -> int:
    """Shared memory of one CTA of the f32 online kernel
    (``csrc/flash_online.cu``, ``ot_smem``) with ``qt`` queries: the q
    planes (hi and lo, 64 rows x C f32 each, a consumer warpgroup each 64
    queries), a ring of planes of KN keys x C f32 (KN 64, or 32 at C = 256;
    8 stages at C = 64, else 3), 1 KB of alignment and the mbarriers."""
    stages = 8 if c == 64 else 3
    kn = 32 if c == 256 else 64
    return (qt // 64) * 2 * 64 * c * 4 + stages * kn * c * 4 + 1024 + 8 * (2 * stages + 1)


def online_workspace(b: int, s: int, c: int) -> int:
    """f32 elements of the f32 online kernel's scratch: the split
    pre-pass's six planes, q and k (hi, lo) (2, B, S, C) and v^T (hi, lo)
    (2, B, C, S)."""
    return 6 * b * s * c


def tf32_round(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
    away from zero; the low 13 bits of the result zero), on f32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def online_split_reference(q, k, v):
    """Plain version of the f32 online kernel's pre-pass
    (``online_split_kernel``), bit for bit: (qs, ks, vts) with qs, ks
    (2, B, S, C) the (hi, lo) planes of q and k, hi = tf32_round(x) and lo =
    tf32_round(x - hi), and vts (2, B, C, S) those of v^T, the keys of each 8
    in ONLINE_KEY_ORDER."""
    b, s, c = v.shape

    def split(x):
        hi = tf32_round(x)
        return torch.stack([hi, tf32_round(x - hi)])

    order = torch.tensor(ONLINE_KEY_ORDER, device=v.device).repeat(s // 8)
    order += torch.arange(s, device=v.device) // 8 * 8
    return split(q.float()), split(k.float()), split(v.float().transpose(1, 2)[..., order])


def online_split(q, k, v):
    """The f32 online kernel's pre-pass alone (``gddim_flash_online_split``):
    q, k, v (B, S, C) f32, S a multiple of 16, C in {64, 128, 256} -> (qs,
    ks, vts) as ``online_split_reference`` returns them, views of one
    workspace (counted in C: ``block_launches()['online_split_kernel']``).
    On CPU tensors the plain version."""
    if _on_cpu(q, "online_split"):
        return online_split_reference(q, k, v)
    require_no_grad("online_split", q, k, v)
    b, s, c = q.shape
    if q.dtype != torch.float32 or not flash_supported(s, c):
        raise ValueError(f"online_split: needs f32 of a supported shape, got {q.dtype} "
                         f"{(b, s, c)}")
    ops = [_operand(t, name, q.dtype, (b, s, c)) for t, name in ((q, "q"), (k, "k"), (v, "v"))]
    work = torch.empty(online_workspace(b, s, c), device=q.device, dtype=torch.float32)
    _build.launch("gddim_flash_online_split", q.device, *map(_build.ptr, ops), work.data_ptr(),
                  b, s, c)
    n = b * s * c
    return (work[:2 * n].view(2, b, s, c), work[2 * n:4 * n].view(2, b, s, c),
            work[4 * n:].view(2, b, c, s))


def flash_online(s: int) -> bool:
    """Whether K8 runs the k-blocked online-softmax kernel at length S (S >
    1024, as ``flash.py:97`` branches) rather than a whole-row one."""
    return s > ONLINE_MIN_S


def flash_supported(s: int, c: int) -> bool:
    """Whether K8 takes a sequence of S tokens of C channels on the card (S a
    multiple of 16, C in {64, 128, 256}): the port's counterpart of the JAX
    package's ``_pallas_supported`` (``attention.py:57-62``), which 'auto'
    consults."""
    return s >= 16 and s % 16 == 0 and c in (64, 128, 256)


def flash_plan(b: int, s: int, c: int, bf16: bool) -> int:
    """K8's query tile: for S > 1024 the online-softmax kernels' (bf16: 128
    queries a CTA, two consumer warpgroups, where that grid covers at least
    half the SMs, else 64, one warpgroup and two CTAs an SM; f32:
    ``online_f32_qt``); else
    64 where the row stays in registers, or the largest of 64, 32, 16 that
    divides S and whose CTA fits shared memory, halved while the grid leaves
    SMs idle. Raises for shapes neither kernel takes (S not a multiple of
    16, C outside {64, 128, 256})."""
    if not flash_supported(s, c):
        raise ValueError(f"flash_attention: unsupported shape {(b, s, c)}")
    if flash_online(s):
        if not bf16:
            return online_f32_qt(c)
        return 128 if 2 * b * -(-s // 128) >= SMS else 64
    if flash_in_registers(bf16, s):
        return 64
    tiles = [qt for qt in (64, 32, 16) if s % qt == 0 and flash_smem(bf16, s, c, qt) <= SMEM_MAX]
    if not tiles:
        raise ValueError(f"flash_attention: unsupported shape {(b, s, c)}")
    qt = tiles[0]
    while b * (s // qt) < SMS and qt // 2 in tiles:
        qt //= 2
    return qt


def flash_attention_blocked_reference(q, k, v, block_k: int = BLOCK_K):
    """Plain version of the TPU kernel's blocked branch (``flash.py:50-95``)
    on (B, S, C): s = (q . k) * C^-0.5 in f32; per block of ``block_k`` keys
    (the last one may be shorter), m_new = max(m, rowmax(s)), alpha =
    exp(m - m_new), p = exp(s - m_new), l = l * alpha + rowsum(p) (p
    unrounded), acc = acc * alpha + (p rounded to v's dtype) . v in f32;
    then acc / l rounded once to q's dtype."""
    b, s, c = q.shape
    qf = q.float()
    m = torch.full((b, s, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, s, 1), device=q.device)
    acc = torch.zeros((b, s, c), device=q.device)
    for k0 in range(0, s, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        logits = torch.einsum("bsc,btc->bst", qf, kb.float()) * c ** (-0.5)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bst,btc->bsc", p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(q.dtype)


def flash_attention(q, k, v):
    """K8: (B, S, C) attention in q's dtype (f32 or bf16 on the card); S a
    multiple of 16, C in {64, 128, 256}: the whole-row kernels up to S =
    1024 (counted in ``flash_attention.launches``), the online-softmax
    kernels above, with ``flash_plan``'s queries a CTA (counted in C:
    ``ops/resblock.py:block_launches``'s flash_online_kernel, both forms, and
    for f32 its pre-pass, online_split_kernel)."""
    if _on_cpu(q, "flash_attention"):
        return attention_xla(q, k, v)
    require_no_grad("flash_attention", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: the kernel takes f32 or bf16, got {q.dtype}")
    b, s, c = q.shape
    bf16 = q.dtype == torch.bfloat16
    qt = flash_plan(b, s, c, bf16)
    ops = [_operand(t, name, q.dtype, (b, s, c)) for t, name in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((b, s, c), device=q.device, dtype=q.dtype)
    if flash_online(s):
        # f32: the split pre-pass's planes (online_split), then the kernel
        work = None if bf16 else torch.empty(online_workspace(b, s, c), device=q.device,
                                             dtype=torch.float32)
        _build.launch("gddim_flash_online", q.device, *map(_build.ptr, ops), out.data_ptr(),
                      b, s, c, qt, int(bf16), c ** -0.5, 0 if work is None else work.data_ptr())
        return out
    _build.launch("gddim_flash_attention", q.device, *map(_build.ptr, ops), out.data_ptr(),
                  b, s, c, qt, int(bf16), c ** -0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # whole-row kernel launches on CUDA tensors


class _AttentionPallas(torch.autograd.Function):
    """K8 forward; backward by autograd of attention_xla recomputed from the
    saved (q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            return torch.autograd.grad(attention_xla(*qkv), qkv, g)


def attention_pallas(q, k, v):
    """Differentiable K8 (the JAX package's name for its kernel path)."""
    return _AttentionPallas.apply(q, k, v)


def attention_einsum5d(q, k, v):
    """Reference-shaped attention on (B, H, W, C): the bhwc,bHWc->bhwHW
    logits scaled by C^-1/2, softmax over the flattened HW, then
    bhwHW,bHWc->bhwc, all in q's dtype (``attention.py:67-75``)."""
    b, h, w, c = q.shape
    logits = torch.einsum("bhwc,bHWc->bhwHW", q, k) * (int(c) ** (-0.5))
    weights = torch.softmax(logits.reshape(b, h, w, h * w), dim=-1).reshape(b, h, w, h, w)
    return torch.einsum("bhwHW,bHWc->bhwc", weights, v)


def resolve_impl(impl: str, fused: bool, s: int, c: int) -> str:
    """``impl`` with 'auto' resolved for S tokens of C channels: 'pallas'
    (K8) when ``fused`` and K8 takes the shape (``flash_supported``), else
    'xla'; any other impl as it is."""
    if impl != "auto":
        return impl
    return "pallas" if fused and flash_supported(s, c) else "xla"


def self_attention_2d(q, k, v, impl: str = "auto", fused: bool = True):
    """Attention over spatial tokens; q, k, v (B, H, W, C). impl (one of
    ATTENTION_IMPLS): 'auto' is K8 (attention_pallas) when ``fused`` and K8
    takes the shape (``flash_supported``), else the plain version, as the
    JAX package's 'auto' takes its kernel where its gate does; 'xla' the
    plain version; 'pallas' K8 (raises on the card where it does not take
    the shape); 'einsum5d' attention_einsum5d."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {ATTENTION_IMPLS}")
    if impl == "einsum5d":
        return attention_einsum5d(q, k, v)
    b, h, w, c = q.shape
    impl = resolve_impl(impl, fused, h * w, c)
    qf, kf, vf = (t.reshape(b, h * w, c) for t in (q, k, v))
    out = attention_pallas(qf, kf, vf) if impl == "pallas" else attention_xla(qf, kf, vf)
    return out.reshape(b, h, w, c)
