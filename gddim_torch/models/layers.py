"""Base layers of the score U-Net (counterpart of ``gddim_tpu/models/layers.py``).

Parameters keep the JAX package's layouts, so converted weights load as
they are: conv kernels HWIO, Dense and NIN kernels (in, out). Activations are
NHWC. Parameters stay float32; a layer computes in its input's dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gddim_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference
from gddim_torch.ops.resblock import conv3x3_nhwc


def default_init(scale: float = 1.0):
    """DDPM variance-scaling init: fan_avg, uniform (scale 0 -> 1e-10).

    Returns init(shape, generator) -> f32 tensor; for conv kernels the
    leading dims are the receptive field (HWIO)."""
    scale = 1e-10 if scale == 0 else scale

    def init(shape, generator=None):
        rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
        limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (2.0 * u - 1.0) * limit

    return init


class Conv(nn.Module):
    """k x k stride-1 SAME conv (k in {1, 3}); weight (k, k, Cin, Cout)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, init_scale: float = 1.0,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(default_init(init_scale)((kernel, kernel, cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        if self.weight.shape[0] == 1:
            return torch.einsum("bhwc,cd->bhwd", x, self.weight[0, 0].to(x.dtype)) + \
                self.bias.to(x.dtype)
        return conv3x3_nhwc(x, self.weight, self.bias)


class Dense(nn.Module):
    """y = x @ W + b with W (in, out), computed in x's dtype."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(default_init()((cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


class NIN(nn.Module):
    """1x1 dense mix over channels; weight (in, out)."""

    def __init__(self, cin: int, cout: int, init_scale: float = 0.1, generator=None):
        super().__init__()
        self.weight = nn.Parameter(default_init(init_scale)((cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier time embedding [sin(2 pi x W), cos(2 pi x W)]."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0, generator=None):
        super().__init__()
        w = torch.randn((embedding_size,), generator=generator) * scale
        self.weight = nn.Parameter(w, requires_grad=False)

    def forward(self, x):
        x_proj = x[:, None] * self.weight[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], -1)


def num_groups_for(c: int) -> int:
    return min(c // 4, 32)


class GroupNorm(nn.Module):
    """GroupNorm, eps 1e-6, min(C//4, 32) groups, f32 statistics; weight is
    the JAX 'scale'. ``act=True`` fuses the SiLU; ``fused=True`` runs K1."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups_for(c)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, act: bool = False, fused: bool = False):
        op = group_norm_silu if fused else group_norm_silu_reference
        return op(x, self.weight, self.bias, self.num_groups, self.eps, act)

