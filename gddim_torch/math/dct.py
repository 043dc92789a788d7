"""Orthonormal 2-D DCT-II / DCT-III as two products with a constant matrix.

Counterpart of ``gddim_tpu/math/dct.py`` (its default ``DCT_IMPL='matmul'``):
for an NHWC batch, ``Y = D X D^T`` over (H, W) per channel, with ``D`` the
orthonormal DCT-II matrix (``dct(x, norm='ortho')``), and the inverse with
``D^T``. The matrix is built in float64 on the host and used in the input's
dtype on its device; plain torch, outside any kernel, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D with (D x)[k] = dct(x, norm='ortho')[k]."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d


def _apply(x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """D x D^T (or D^T x D) over the H and W axes of an NHWC batch."""
    n_h, n_w = x.shape[1], x.shape[2]
    d_h, d_w = (torch.as_tensor(dct_matrix(n).T if transpose else dct_matrix(n),
                                dtype=x.dtype, device=x.device) for n in (n_h, n_w))
    x = torch.einsum("hi,biwc->bhwc", d_h, x)
    return torch.einsum("wj,bhjc->bhwc", d_w, x)


def batch_img_dct(xs: torch.Tensor) -> torch.Tensor:
    """NHWC batch -> DCT space (2-D orthonormal DCT-II over H, W)."""
    return _apply(xs, transpose=False)


def batch_img_idct(ys: torch.Tensor) -> torch.Tensor:
    """DCT space -> NHWC batch (2-D orthonormal DCT-III, the inverse)."""
    return _apply(ys, transpose=True)
