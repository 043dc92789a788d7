"""The normalization zoo (counterpart of ``gddim_tpu/models/normalization.py``,
after the reference's cld_jax/models/normalization.py).

The networks of every config use GroupNorm; the NCSNv1/v2-era variants
stand behind ``get_normalization`` for the reference's surface. NHWC
``nn.Module``s in plain torch; each parameter keeps its flax name and shape
((1, 1, 1, C), or the embedding's (classes, n)), so ``convert.py`` maps a
flax tree onto them (``flax_leaves``, ``subscopes``). A module is built
for its channel count, which flax infers at the first call.
"""

from __future__ import annotations

import torch
from torch import nn

from gddim_torch.models.layers import GroupNorm as _GroupNorm

_EPS = 1e-5


def get_normalization(config, conditional: bool = False):
    """The normalization class ``config.model.normalization`` names
    (reference normalization.py:23-41); each is built as cls(c)."""
    norm = config.model.normalization
    if conditional:
        if norm == "InstanceNorm++":
            return ConditionalInstanceNorm2dPlus
        raise NotImplementedError(f"{norm} not implemented conditionally.")
    if norm == "InstanceNorm":
        return InstanceNorm2d
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        return GroupNorm
    raise NotImplementedError(f"normalization {norm} not implemented")


class GroupNorm(_GroupNorm):
    """flax ``nn.GroupNorm()`` at its defaults: 32 groups, eps 1e-6."""

    flax_leaves = {"scale": "weight", "bias": "bias"}

    def __init__(self, c: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__(c, eps)
        self.num_groups = num_groups


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.reshape(1, 1, 1, -1))


def _noisy_ones(c: int, generator=None) -> torch.Tensor:
    """1 + 0.02 N(0, 1) (``normalization.py:138-141``)."""
    return 1.0 + 0.02 * torch.randn((c,), generator=generator)


def _instance_stats(x):
    """Per-sample, per-channel mean and (population) variance over H, W."""
    return x.mean((1, 2), keepdim=True), x.var((1, 2), unbiased=False, keepdim=True)


def _means_plus(x):
    """(the channel means (B, C), their standardisation across channels)."""
    means = x.mean((1, 2))
    m = means.mean(-1, keepdim=True)
    v = means.var(-1, unbiased=False, keepdim=True)
    return means, (means - m) / torch.sqrt(v + _EPS)


class VarianceNorm2d(nn.Module):
    """Variance-only normalization (reference normalization.py:44-61)."""

    def __init__(self, c: int, bias: bool = False, generator=None):
        super().__init__()
        self.scale = _param(1.0 + 0.02 * torch.randn((c,), generator=generator))
        self.bias = _param(torch.zeros(c)) if bias else None
        self.flax_leaves = {"scale": "scale", **({"bias": "bias"} if bias else {})}

    def forward(self, x):
        _, var = _instance_stats(x)
        out = self.scale * (x / torch.sqrt(var + _EPS))
        return out + self.bias if self.bias is not None else out


class InstanceNorm2d(nn.Module):
    """Per-channel instance normalization (reference normalization.py:64-84)."""

    def __init__(self, c: int, bias: bool = True, generator=None):
        super().__init__()
        self.gamma = _param(torch.ones(c))
        self.beta = _param(torch.zeros(c)) if bias else None
        self.flax_leaves = {"gamma": "gamma", **({"beta": "beta"} if bias else {})}

    def forward(self, x):
        mean, var = _instance_stats(x)
        out = self.gamma * ((x - mean) / torch.sqrt(var + _EPS))
        return out + self.beta if self.beta is not None else out


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++: instance normalization plus alpha times the channel
    means standardised across channels (reference normalization.py:87-114)."""

    def __init__(self, c: int, bias: bool = True, generator=None):
        super().__init__()
        self.alpha = _param(_noisy_ones(c, generator))
        self.gamma = _param(_noisy_ones(c, generator))
        self.beta = _param(torch.zeros(c)) if bias else None
        self.flax_leaves = {"alpha": "alpha", "gamma": "gamma",
                            **({"beta": "beta"} if bias else {})}

    def forward(self, x):
        means, means_plus = _means_plus(x)
        _, var = _instance_stats(x)
        h = (x - means[:, None, None, :]) / torch.sqrt(var + _EPS)
        h = h + means_plus[:, None, None, :] * self.alpha
        out = self.gamma * h
        return out + self.beta if self.beta is not None else out


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding`` (num, features), N(0, 0.02^2)."""

    flax_leaves = {"embedding": "embedding"}

    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(0.02 * torch.randn((num, features), generator=generator))

    def forward(self, y):
        return self.embedding[y.long()]


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional InstanceNorm++ (reference normalization.py:117-145):
    gamma, alpha and beta per class from one embedding (``Embed_0``)."""

    def __init__(self, c: int, num_classes: int = 10, bias: bool = True, generator=None):
        super().__init__()
        self.bias = bias
        self.Embed_0 = Embed(num_classes, (3 if bias else 2) * c, generator)
        self.subscopes = {"Embed_0": "Embed_0"}

    def forward(self, x, y):
        means, means_plus = _means_plus(x)
        _, var = _instance_stats(x)
        h = (x - means[:, None, None, :]) / torch.sqrt(var + _EPS)
        parts = self.Embed_0(y).chunk(3 if self.bias else 2, -1)
        gamma, alpha = parts[0], parts[1]
        out = (gamma + 1.0)[:, None, None, :] * h + means_plus[:, None, None, :] * \
            alpha[:, None, None, :]
        return out + parts[2][:, None, None, :] if self.bias else out
