"""Batched 2x2 linear algebra on the trailing two axes.

Counterpart of ``gddim_tpu/math/linalg2.py``: the numpy half (``inv2``,
``mat2``, ``psd_sqrt_factor``) for the float64 host layer, and ``bmm`` /
``sbmm`` on torch tensors for the sampler. The K=2 contractions are written
out elementwise, so they run in full float32 on every device (no TF32 or
reduced-precision matmul path can touch them).
"""

from __future__ import annotations

import numpy as np
import torch


def inv2(m):
    """Inverse of (..., 2, 2) matrices (numpy or torch)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    xp = torch if isinstance(m, torch.Tensor) else np
    out = xp.stack([xp.stack([d, -b], -1), xp.stack([-c, a], -1)], -2)
    return out / det[..., None, None]


def mat2(a00, a01, a10, a11, xp=np):
    """Assemble (..., 2, 2) from four broadcastable components."""
    return xp.stack([xp.stack([a00, a01], -1), xp.stack([a10, a11], -1)], -2)


def sbmm(mat, state: torch.Tensor) -> torch.Tensor:
    """Apply one 2x2 matrix to trailing-dim-2 states: (2, 2), (..., 2) -> (..., 2)."""
    m = [[float(mat[i][j]) for j in range(2)] for i in range(2)]
    s0, s1 = state[..., 0], state[..., 1]
    return torch.stack([m[0][0] * s0 + m[0][1] * s1, m[1][0] * s0 + m[1][1] * s1], -1)


def bmm(mats: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Apply per-batch 2x2 matrices: (B, 2, 2), (B, ..., 2) -> (B, ..., 2)."""
    shape = (mats.shape[0],) + (1,) * (state.ndim - 2)
    m = [[mats[:, i, j].reshape(shape) for j in range(2)] for i in range(2)]
    s0, s1 = state[..., 0], state[..., 1]
    return torch.stack([m[0][0] * s0 + m[0][1] * s1, m[1][0] * s0 + m[1][1] * s1], -1)


def psd_sqrt_factor(cov: np.ndarray) -> np.ndarray:
    """Symmetric PSD factor A with A @ A.T = cov, for (..., 2, 2) covariances
    (negative eigenvalues clipped to zero)."""
    cov = np.asarray(cov, dtype=np.float64)
    w, v = np.linalg.eigh(cov)
    w = np.clip(w, 0.0, None)
    return np.einsum("...ij,...j,...kj->...ik", v, np.sqrt(w), v)
