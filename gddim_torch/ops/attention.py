"""K8: single-head spatial self-attention over flattened tokens.

Counterpart of ``gddim_tpu/ops/attention.py`` and ``gddim_tpu/ops/flash.py``:

- ``attention_xla``: the plain version, softmax(q k^T / sqrt(C)) v with f32
  logits and softmax (``attention.py:21``);
- ``flash_attention``: K8 (``flash.py:97``), the hand-written kernel
  ``csrc/flash.cu`` (f32 FMA, online softmax over key tiles; its header says
  what bounds it on the H100). One kernel covers the JAX package's
  whole-sequence and k-blocked branches, and every S that is a multiple of
  16, so the 4x4 mid-block attention (S = 16), which the JAX package sends to
  XLA for the TPU's 128-lane gate, runs it too;
- ``attention_pallas``: K8 forward with the gradient of the plain version
  recomputed from (q, k, v), as the JAX ``custom_vjp`` (``attention.py:35-54``);
- ``self_attention_2d``: the (B, H, W, C) entry the attention block calls.

On a CPU tensor ``flash_attention`` runs the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from gddim_torch import _build
from gddim_torch.ops.resblock import _operand, require_no_grad


def attention_xla(q, k, v):
    """(B, S, C) attention, f32 logits and softmax; the weights round to
    q's dtype before p.v, as the JAX package's version does."""
    c = q.shape[-1]
    logits = torch.einsum("bsc,btc->bst", q.float(), k.float()) * c ** (-0.5)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bst,btc->bsc", w.float(), v.float()).to(q.dtype)


def flash_attention(q, k, v):
    """K8: (B, S, C) f32 attention; S a multiple of 16, C in {64, 128, 256}
    on the card."""
    if q.device.type == "cpu":
        return attention_xla(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    require_no_grad("flash_attention", q, k, v)
    b, s, c = q.shape
    if s % 16 or c not in (64, 128, 256):
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
    ops = [_operand(t, name, torch.float32, (b, s, c)) for t, name in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((b, s, c), device=q.device, dtype=torch.float32)
    _build.launch("gddim_flash_attention", q.device, *map(_build.ptr, ops), out.data_ptr(),
                  b, s, c)
    flash_attention.launches += 1
    return out.to(q.dtype)


flash_attention.launches = 0  # kernel launches on CUDA tensors


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


def self_attention_2d(q, k, v, fused: bool = True):
    """Attention over spatial tokens; q, k, v (B, H, W, C). fused: K8
    (attention_pallas), else the plain version."""
    b, h, w, c = q.shape
    qf, kf, vf = (t.reshape(b, h * w, c) for t in (q, k, v))
    out = attention_pallas(qf, kf, vf) if fused else attention_xla(qf, kf, vf)
    return out.reshape(b, h, w, c)
