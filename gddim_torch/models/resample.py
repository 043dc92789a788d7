"""FIR and naive up/down-sampling, NHWC (counterpart of
``gddim_tpu/models/resample.py``).

The upfirdn pipeline (zero-insert, pad, FIR, decimate), the FIR-composed
convs of ``upsample_conv_2d`` (zero-insert, then one conv) and
``conv_downsample_2d`` (one strided conv), the naive resamplers (nearest up,
the mean of each 2x2 down) and XLA's "SAME" average pool, in plain torch:
the JAX package computes these with XLA operations outside any Pallas
kernel.

Two module switches, read at every call as the JAX package reads its own:
``FIR_IMPL`` picks the FIR pass, 'separable' (default: two depthwise 1-D
passes) or 'channel_batch' (the reference's form, channels folded into the
batch and one single-channel 2-D conv, ``up_or_down_sampling.py:276-291``;
the x1 baseline's, ``bench.py``'s ``ref`` mode); ``FUSE_FIR_CONV`` (True)
lets the two fused resample convs compose the FIR taps into the conv
kernel, which they do only under 'separable'. Otherwise they run the conv
and the FIR apart (``resample.py:180-197,220-229``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.models.layers import default_init, same_pads
from gddim_torch.utils.consts import device_constant


def _fir_taps(k) -> np.ndarray:
    k = np.asarray(k, dtype=np.float32)
    assert k.ndim == 1
    return k / k.sum()


# 'separable' (default) or 'channel_batch' (the reference-style FIR)
FIR_IMPL = "separable"
FIR_IMPLS = ("separable", "channel_batch")
# the fused resample convs compose the FIR into the conv kernel (under 'separable')
FUSE_FIR_CONV = True


def _compose_shift_tensor(kw: int, k1d: np.ndarray) -> np.ndarray:
    """S[d, e, x, y] = k_flipped[x - d, y - e]: the composed kernel is
    K[x, y, i, o] = sum_{d,e} w[d, e, i, o] * S[d, e, x, y]."""
    kf = k1d.shape[0]
    k_fl = np.outer(k1d, k1d)[::-1, ::-1]
    out = kw + kf - 1
    s = np.zeros((kw, kw, out, out), dtype=np.float32)
    for d in range(kw):
        for e in range(kw):
            s[d, e, d: d + kf, e: e + kf] = k_fl
    return s


def _zero_insert(y, up: int):
    """NCHW y with (up - 1) zeros after every pixel along H and W, the
    trailing ones dropped: ((h - 1) up + 1, (w - 1) up + 1)."""
    b, c, h, w = y.shape
    z = y.new_zeros((b, c, (h - 1) * up + 1, (w - 1) * up + 1))
    z[:, :, ::up, ::up] = y
    return z


def _upsample_pad(x, up: int, pad0: int, pad1: int):
    """NHWC x as NCHW, zero-inserted by ``up`` with the trailing (up - 1)
    zeros of the reference's reshape-upsample kept, then padded (pad0,
    pad1) along H and W: the input of upfirdn's filter."""
    y = x.permute(0, 3, 1, 2)
    if up > 1:
        y = F.pad(_zero_insert(y, up), (0, up - 1, 0, up - 1))
    return F.pad(y, (pad0, pad1, pad0, pad1))


def _channel_batch_fir(x, k1d: np.ndarray, up: int, down: int, pad0: int, pad1: int,
                       gain: float):
    """The reference's upfirdn (``resample.py:63-81``): zero-insert, pad,
    the channels folded into the batch, one single-channel conv with the
    flipped 2-D kernel, then the decimation ``[::down]``; NHWC."""
    n, c = x.shape[0], x.shape[-1]
    y = _upsample_pad(x, up, pad0, pad1)
    k2d = device_constant(np.outer(k1d, k1d) * gain, x.dtype, x.device)
    y = F.conv2d(y.reshape(n * c, 1, y.shape[2], y.shape[3]), k2d.flip(0, 1)[None, None])
    y = y.reshape(n, c, y.shape[2], y.shape[3]).permute(0, 2, 3, 1)
    return y[:, ::down, ::down, :]


def _sep_fir(x, k1d: np.ndarray, up: int, down: int, pad0: int, pad1: int, gain: float):
    """upfirdn along H then W with a separable FIR kernel, depthwise; NHWC.
    Under FIR_IMPL 'channel_batch', the reference's form instead."""
    if FIR_IMPL not in FIR_IMPLS:
        raise ValueError(f"FIR_IMPL must be one of {FIR_IMPLS}, got {FIR_IMPL!r}")
    if FIR_IMPL == "channel_batch":
        return _channel_batch_fir(x, k1d, up, down, pad0, pad1, gain)
    c = x.shape[-1]
    y = _upsample_pad(x, up, pad0, pad1)
    taps = device_constant(k1d[::-1], y.dtype, y.device)
    kh = taps.shape[0]
    kern_h = (taps * gain).reshape(1, 1, kh, 1).expand(c, 1, kh, 1)
    y = F.conv2d(y, kern_h, stride=(down, 1), groups=c)
    kern_w = taps.reshape(1, 1, 1, kh).expand(c, 1, 1, kh)
    y = F.conv2d(y, kern_w, stride=(1, down), groups=c)
    return y.permute(0, 2, 3, 1)


def upsample_2d(x, k=(1, 3, 3, 1), factor: int = 2, gain: float = 1.0):
    """FIR upsample (reference up_or_down_sampling.py:333-369)."""
    k1d = _fir_taps(k)
    p = k1d.shape[0] - factor
    return _sep_fir(x, k1d, up=factor, down=1, pad0=(p + 1) // 2 + factor - 1,
                    pad1=p // 2, gain=gain * factor ** 2)


def downsample_2d(x, k=(1, 3, 3, 1), factor: int = 2, gain: float = 1.0):
    """FIR downsample (reference up_or_down_sampling.py:372-411)."""
    k1d = _fir_taps(k)
    p = k1d.shape[0] - factor
    return _sep_fir(x, k1d, up=1, down=factor, pad0=(p + 1) // 2, pad1=p // 2, gain=gain)


def _composed(w, k1d: np.ndarray, gain: float):
    """The conv kernel w (HWIO) composed with the 2-D FIR taps, f32."""
    s = device_constant(_compose_shift_tensor(w.shape[0], k1d) * gain, torch.float32, w.device)
    return torch.einsum("deio,dexy->xyio", w.float(), s)


def _fused() -> bool:
    """Whether the resample convs compose the FIR into the conv kernel."""
    return FUSE_FIR_CONV and FIR_IMPL == "separable"


def upsample_conv_2d(x, w, k=(1, 3, 3, 1), factor: int = 2, gain: float = 1.0):
    """Zero-insert upsample + conv + FIR (reference :89-165): one conv of the
    input dilated by ``factor`` with the FIR-composed kernel; unfused, the
    dilated conv with full (k - 1) padding, then the FIR.
    w: (kh, kw, Cin, Cout)."""
    kh, kw, in_c, _ = w.shape
    assert kh == kw and x.shape[-1] == in_c
    k1d = _fir_taps(k)
    p = (k1d.shape[0] - factor) - (kw - 1)
    pad0, pad1 = (p + 1) // 2 + factor - 1, p // 2 + 1
    y = _zero_insert(x.permute(0, 3, 1, 2), factor)
    if not _fused():
        y = F.pad(y, (kw - 1, kw - 1, kh - 1, kh - 1))
        y = F.conv2d(y, w.to(x.dtype).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        return _sep_fir(y, k1d, up=1, down=1, pad0=pad0, pad1=pad1, gain=gain * factor ** 2)
    kern = _composed(w, k1d, gain * factor ** 2).to(x.dtype)
    lo, hi = kh - 1 + pad0, kh - 1 + pad1
    y = F.conv2d(F.pad(y, (lo, hi, lo, hi)), kern.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def conv_downsample_2d(x, w, k=(1, 3, 3, 1), factor: int = 2, gain: float = 1.0):
    """FIR + conv + decimate (reference :168-209) as one strided conv with
    the FIR-composed kernel; unfused, the FIR, then the strided VALID conv.
    w: (kh, kw, Cin, Cout)."""
    kh, kw, in_c, _ = w.shape
    assert kh == kw and x.shape[-1] == in_c
    k1d = _fir_taps(k)
    p = (k1d.shape[0] - factor) + (kw - 1)
    pad0, pad1 = (p + 1) // 2, p // 2
    if not _fused():
        y = _sep_fir(x, k1d, up=1, down=1, pad0=pad0, pad1=pad1, gain=gain).permute(0, 3, 1, 2)
        return F.conv2d(y, w.to(x.dtype).permute(3, 2, 0, 1), stride=factor).permute(0, 2, 3, 1)
    kern = _composed(w, k1d, gain).to(x.dtype)
    y = F.pad(x.permute(0, 3, 1, 2), (pad0, pad1, pad0, pad1))
    y = F.conv2d(y, kern.permute(3, 2, 0, 1), stride=factor)
    return y.permute(0, 2, 3, 1)


def naive_upsample_2d(x, factor: int = 2):
    """Nearest upsample: each pixel repeated factor x factor times."""
    return x.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


def naive_downsample_2d(x, factor: int = 2):
    """The mean of each factor x factor block."""
    n, h, w, c = x.shape
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean((2, 4))


def avg_pool_same(x, window: int = 2):
    """flax's ``nn.avg_pool`` at stride ``window`` with "SAME" padding: zero
    padding as XLA places it, counted in each window's mean."""
    (t, b), (le, r) = (same_pads(n, window, window) for n in x.shape[1:3])
    y = F.pad(x.permute(0, 3, 1, 2), (le, r, t, b))
    return F.avg_pool2d(y, window, window).permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """Conv with fused FIR up- or downsampling (reference
    up_or_down_sampling.py:40-73); weight (k, k, Cin, Cout) as the JAX
    'weight'."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, resample_kernel=(1, 3, 3, 1),
                 generator=None, up: bool = False):
        super().__init__()
        self.up = up
        self.resample_kernel = tuple(resample_kernel)
        self.weight = nn.Parameter(default_init()((kernel, kernel, cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        op = upsample_conv_2d if self.up else conv_downsample_2d
        y = op(x, self.weight, k=self.resample_kernel)
        return y + self.bias.to(y.dtype)
