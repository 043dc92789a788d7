"""NCSN++ building blocks (counterpart of ``gddim_tpu/models/blocks.py``).

Each block takes its kernel choice explicitly: ``fused=True`` runs the
block through its kernel wrapper (K2-K5, and K1 for a transition's GN1),
which on a CPU tensor is the plain composition and on a CUDA tensor the
hand-written kernels; ``fused=False`` runs the plain composition on any
device.
"""

from __future__ import annotations

import torch
from torch import nn

from gddim_torch.models import resample
from gddim_torch.models.layers import NIN, Conv, Dense, GroupNorm, num_groups_for
from gddim_torch.ops import attnblock as attn_ops
from gddim_torch.ops import resblock as rb


class _KernelWeights:
    """bf16 copies of a block's conv kernels for the fused path, remade
    only when a parameter changes (in place or by replacement)."""

    def __init__(self):
        self._key = None
        self._val = None

    def get(self, params):
        key = tuple((p.data_ptr(), p._version, p.device) for p in params)
        if key != self._key:
            self._val = [p.detach().to(torch.bfloat16).contiguous() for p in params]
            self._key = key
        return self._val


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with in-block FIR resampling
    (reference layerspp.py:180-227)."""

    def __init__(self, cin: int, out_ch: int | None, temb_dim: int, up: bool = False,
                 down: bool = False, fir_kernel=(1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0, generator=None):
        super().__init__()
        out_ch = out_ch or cin
        self.up, self.down = up, down
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(cin, out_ch, 3, generator=generator)
        self.temb_dense = Dense(temb_dim, out_ch, generator=generator)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, init_scale=init_scale, generator=generator)
        self.skip = (Conv(cin, out_ch, 1, generator=generator)
                     if cin != out_ch or up or down else None)
        self._kw = _KernelWeights()

    def forward(self, x, temb, fused: bool = False):
        """x: (B, H, W, C), or the up path's (h, skip) pair."""
        w1, w2 = self.conv1.weight, self.conv2.weight
        w_skip = b_skip = None
        if self.skip is not None:
            w_skip, b_skip = self.skip.weight[0, 0], self.skip.bias
        first = x[0] if isinstance(x, (tuple, list)) else x
        if fused and first.is_cuda:
            kw = [w1, w2] + ([w_skip] if w_skip is not None else [])
            kw = self._kw.get(kw)
            w1, w2 = kw[0], kw[1]
            w_skip = kw[2] if w_skip is not None else None
        tail = (self.temb_dense.weight, self.temb_dense.bias)
        mid = (w1, self.conv1.bias, self.norm2.weight, self.norm2.bias, w2, self.conv2.bias,
               w_skip, b_skip)
        kw = dict(num_groups2=self.norm2.num_groups, eps=self.norm2.eps,
                  skip_rescale=self.skip_rescale)
        if self.up or self.down:
            h = self.norm1(x, act=True, fused=fused)
            res = resample.upsample_2d if self.up else resample.downsample_2d
            h, xr = res(h, self.fir_kernel), res(x, self.fir_kernel)
            op = rb.fused_resblock_tail if fused else rb.resblock_tail_reference
            return op(h, xr, temb, *tail, *mid, **kw)
        gn1 = (self.norm1.weight, self.norm1.bias)
        kw["num_groups1"] = self.norm1.num_groups
        if isinstance(x, (tuple, list)):
            op = rb.fused_resblock_pair if fused else rb.resblock_pair_reference
            return op(x[0], x[1], temb, *tail, *gn1, *mid, **kw)
        op = rb.fused_resblock if fused else rb.resblock_reference
        return op(x, temb, *tail, *gn1, *mid, **kw)


class AttnBlockpp(nn.Module):
    """Spatial self-attention block (reference layerspp.py:61-83)."""

    def __init__(self, c: int, skip_rescale: bool = False, init_scale: float = 0.0,
                 generator=None):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.norm = GroupNorm(c)
        self.q = NIN(c, c, generator=generator)
        self.k = NIN(c, c, generator=generator)
        self.v = NIN(c, c, generator=generator)
        self.out = NIN(c, c, init_scale=init_scale, generator=generator)

    def forward(self, x, fused: bool = False):
        op = attn_ops.fused_attnblock if fused else attn_ops.attnblock_reference
        return op(x, self.norm.weight, self.norm.bias,
                  self.q.weight, self.q.bias, self.k.weight, self.k.bias,
                  self.v.weight, self.v.bias, self.out.weight, self.out.bias,
                  num_groups=num_groups_for(x.shape[-1]), eps=self.norm.eps,
                  skip_rescale=self.skip_rescale)


class Downsample(nn.Module):
    """FIR downsample with conv (the progressive_input='residual' pyramid;
    reference layerspp.py:115-143)."""

    def __init__(self, cin: int, out_ch: int, fir_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        self.conv = resample.Conv2d(cin, out_ch, 3, fir_kernel, generator=generator)

    def forward(self, x):
        return self.conv(x)
