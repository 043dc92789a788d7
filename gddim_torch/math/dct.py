"""Orthonormal 2-D DCT-II / DCT-III (counterpart of ``gddim_tpu/math/dct.py``).

Two forms, picked by the module switch ``DCT_IMPL``, read at every call as
the JAX package reads its own:

- ``'matmul'`` (the default): for an NHWC batch, ``Y = D X D^T`` over
  (H, W) per channel, with ``D`` the orthonormal DCT-II matrix
  (``dct(x, norm='ortho')``), and the inverse with ``D^T``. The matrix is
  built in float64 on the host and used in the input's dtype on its device;
- ``'fft'``: the reference's construction (``blur_jax/blur.py:11-97``) from
  one FFT an axis, with Makhoul's even-odd permutation and the twiddle
  factors: the x1 baseline's DCT (``bench.py``'s ``ref`` mode). f32 runs
  in complex64, f64 in complex128.

Plain torch, outside any kernel, as in the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from gddim_torch.utils.consts import device_constant

# 'matmul' (default) or 'fft' (the reference-style form)
DCT_IMPL = "matmul"
DCT_IMPLS = ("matmul", "fft")


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D with (D x)[k] = dct(x, norm='ortho')[k]."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d


def _fft_dtype(x: torch.Tensor) -> torch.dtype:
    """The real dtype the FFT form computes in: f64 stays f64, all else f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _twiddle(n: int, sign: float, dtype: torch.dtype, device) -> torch.Tensor:
    """exp(sign * i pi k / 2n), k = 0..n-1, complex of ``dtype``'s width."""
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return device_constant(np.exp(sign * 1j * np.pi * np.arange(n) / (2 * n)), ctype, device)


def _dct1d_fft(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Orthonormal DCT-II along ``axis`` by FFT (``dct.py:30-41``)."""
    dtype = x.dtype
    x = x.movedim(axis, -1).to(_fft_dtype(x))
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], -1)
    y = (torch.fft.fft(v) * _twiddle(n, -1.0, x.dtype, x.device)).real * math.sqrt(2.0 / n)
    y = torch.cat([y[..., :1] * math.sqrt(0.5), y[..., 1:]], -1)
    return y.to(dtype).movedim(-1, axis)


def _idct1d_fft(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Orthonormal DCT-III (the inverse of _dct1d_fft) along ``axis``
    (``dct.py:44-63``): the mirror term Y[n - k] with Y[0]'s mirror 0, one
    inverse FFT, then the even output slots from the first half and the odd
    ones from the reversed second half."""
    dtype = y.dtype
    y = y.movedim(axis, -1).to(_fft_dtype(y))
    n = y.shape[-1]
    yy = y / math.sqrt(2.0 / n)
    yy = torch.cat([yy[..., :1] * math.sqrt(2.0), yy[..., 1:]], -1)
    y_rev = torch.cat([torch.zeros_like(yy[..., :1]), yy[..., 1:].flip(-1)], -1)
    v = torch.fft.ifft(torch.complex(yy, -y_rev) * _twiddle(n, 1.0, y.dtype, y.device)).real
    half = (n + 1) // 2
    out = torch.empty_like(v)
    out[..., ::2] = v[..., :half]
    out[..., 1::2] = v[..., half:].flip(-1)
    return out.to(dtype).movedim(-1, axis)


def _matmul(x: torch.Tensor, axis: int, transpose: bool) -> torch.Tensor:
    """D x (or D^T x) along ``axis``."""
    n = x.shape[axis]
    d = dct_matrix(n).T if transpose else dct_matrix(n)
    d = device_constant(d, x.dtype, x.device)
    return torch.einsum("ki,...i->...k", d, x.movedim(axis, -1)).movedim(-1, axis)


def _impl() -> str:
    if DCT_IMPL not in DCT_IMPLS:
        raise ValueError(f"DCT_IMPL must be one of {DCT_IMPLS}, got {DCT_IMPL!r}")
    return DCT_IMPL


def dct2(x: torch.Tensor, axes=(1, 2)) -> torch.Tensor:
    """2-D orthonormal DCT-II over ``axes`` (default the H, W of NHWC)."""
    h_ax, w_ax = axes
    if _impl() == "fft":
        return _dct1d_fft(_dct1d_fft(x, h_ax), w_ax)
    return _matmul(_matmul(x, h_ax, False), w_ax, False)


def idct2(y: torch.Tensor, axes=(1, 2)) -> torch.Tensor:
    """2-D orthonormal DCT-III over ``axes``, the inverse of dct2."""
    h_ax, w_ax = axes
    if _impl() == "fft":
        return _idct1d_fft(_idct1d_fft(y, w_ax), h_ax)
    return _matmul(_matmul(y, h_ax, True), w_ax, True)


def batch_img_dct(xs: torch.Tensor) -> torch.Tensor:
    """NHWC batch -> DCT space (2-D orthonormal DCT-II over H, W)."""
    return dct2(xs, axes=(1, 2))


def batch_img_idct(ys: torch.Tensor) -> torch.Tensor:
    """DCT space -> NHWC batch (2-D orthonormal DCT-III, the inverse)."""
    return idct2(ys, axes=(1, 2))
