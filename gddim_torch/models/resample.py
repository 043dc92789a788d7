"""FIR up/down-sampling, NHWC (counterpart of ``gddim_tpu/models/resample.py``).

The upfirdn pipeline (zero-insert, pad, separable FIR, decimate) and the
FIR-composed strided conv of ``conv_downsample_2d``, in plain torch: the JAX
package computes these with XLA convolutions outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.models.layers import default_init


def _fir_taps(k) -> np.ndarray:
    k = np.asarray(k, dtype=np.float32)
    assert k.ndim == 1
    return k / k.sum()


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


def _sep_fir(x, k1d: np.ndarray, up: int, down: int, pad0: int, pad1: int, gain: float):
    """upfirdn along H then W with a separable FIR kernel, depthwise; NHWC."""
    b, h, w, c = x.shape
    y = x.permute(0, 3, 1, 2)
    if up > 1:  # zero-insert; the trailing (up-1) zeros fold into the right pad
        z = y.new_zeros((b, c, h * up, w * up))
        z[:, :, ::up, ::up] = y
        y = z
    y = F.pad(y, (pad0, pad1, pad0, pad1))
    taps = torch.as_tensor(k1d[::-1].copy(), dtype=y.dtype, device=y.device)
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


def conv_downsample_2d(x, w, k=(1, 3, 3, 1), factor: int = 2, gain: float = 1.0):
    """FIR + conv + decimate as one strided conv with the FIR-composed kernel.
    w: (kh, kw, Cin, Cout)."""
    kh, kw, in_c, _ = w.shape
    assert kh == kw and x.shape[-1] == in_c
    k1d = _fir_taps(k)
    p = (k1d.shape[0] - factor) + (kw - 1)
    pad0, pad1 = (p + 1) // 2, p // 2
    s = torch.as_tensor(_compose_shift_tensor(kw, k1d) * gain, device=w.device)
    kern = torch.einsum("deio,dexy->xyio", w.float(), s).to(x.dtype)
    y = F.pad(x.permute(0, 3, 1, 2), (pad0, pad1, pad0, pad1))
    y = F.conv2d(y, kern.permute(3, 2, 0, 1), stride=factor)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """Conv with fused FIR downsampling (reference up_or_down_sampling.py:40-73);
    weight (k, k, Cin, Cout) as the JAX 'weight'."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, resample_kernel=(1, 3, 3, 1),
                 generator=None):
        super().__init__()
        self.resample_kernel = tuple(resample_kernel)
        self.weight = nn.Parameter(default_init()((kernel, kernel, cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = conv_downsample_2d(x, self.weight, k=self.resample_kernel)
        return y + self.bias.to(y.dtype)
