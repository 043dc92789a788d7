"""The NCSNv1/v2-era layer library (counterpart of
``gddim_tpu/models/legacy_blocks.py``, after the reference's
cld_jax/models/layers.py): the RefineNet blocks (CRP, RCU, MSF, Refine),
their noise-conditional NCSNv1 forms, and the DDPM-era attention,
up/downsampling and residual blocks.

No config builds a network from them, in the JAX package either: they are
the model zoo's surface, plain torch on NHWC tensors. Each block names its
sub-modules by the flax scopes the JAX block creates, in its creation order
(``Conv_0``, ``RCUBlock_1``, ``ConditionalInstanceNorm2dPlus_3``, ...), and
lists them in ``subscopes``, so ``convert.flax_to_state_dict`` maps a flax
tree onto a block as it is. A module is built for its input channels,
which flax infers at the first call; a conditional block takes
``normalizer``, a callable c -> module (``normalization.py``).
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.models.layers import NIN, Conv, Dense, GroupNorm, default_init, same_pads
from gddim_torch.models.resample import avg_pool_same, naive_upsample_2d
from gddim_torch.ops.attention import self_attention_2d


class _Scoped(nn.Module):
    """A block whose sub-modules are attributes named by their flax scopes."""

    def __init__(self):
        super().__init__()
        self.subscopes: dict[str, str] = {}
        self._counts = collections.Counter()

    def add(self, module: nn.Module, cls_name: str | None = None, alias: str | None = None):
        """Register ``module`` under its flax scope name (``cls_name``, else
        its class name, and a count); ``alias`` names it once more outside
        the registry, so that ``state_dict`` holds each parameter once."""
        cls_name = cls_name or type(module).__name__
        name = f"{cls_name}_{self._counts[cls_name]}"
        self._counts[cls_name] += 1
        self.add_module(name, module)
        self.subscopes[name] = name
        if alias is not None:
            object.__setattr__(self, alias, module)
        return module


def ncsn_conv_init(scale: float = 1.0):
    """The NCSNv1/v2 conv init (reference layers.py:45-48): variance
    scaling scale / 3, fan_in, uniform; init(shape, generator)."""
    scale = 1e-10 if scale == 0 else scale

    def init(shape, generator=None):
        limit = math.sqrt(scale / math.prod(shape[:-1]))
        return (2.0 * torch.rand(shape, generator=generator) - 1.0) * limit

    return init


class NCSNConv(nn.Module):
    """flax ``nn.Conv`` with padding "SAME" (``ncsn_conv``): weight
    (k, k, Cin, Cout), optional bias; XLA's SAME padding placed explicitly
    (more after than before where the total is odd, as at stride 2), over
    the dilated extent (k - 1) * dilation + 1."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, bias: bool = True,
                 dilation: int = 1, init_scale: float = 1.0, generator=None):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(ncsn_conv_init(init_scale)((kernel, kernel, cin, cout),
                                                              generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.flax_leaves = {"kernel": "weight", **({"bias": "bias"} if bias else {})}

    def forward(self, x):
        extent = (self.weight.shape[0] - 1) * self.dilation + 1
        (t, b), (le, r) = (same_pads(n, extent, self.stride) for n in x.shape[1:3])
        y = F.pad(x.permute(0, 3, 1, 2), (le, r, t, b))
        y = F.conv2d(y, self.weight.to(x.dtype).permute(3, 2, 0, 1), stride=self.stride,
                     dilation=self.dilation).permute(0, 2, 3, 1)
        return y + self.bias.to(x.dtype) if self.bias is not None else y


def _pool5(x, kind: str):
    """A 5x5 window at stride 1 with "SAME" padding: max (the padding never
    wins) or mean (zeros counted, as flax's avg_pool)."""
    y = x.permute(0, 3, 1, 2)
    y = F.max_pool2d(y, 5, 1, 2) if kind == "max" else F.avg_pool2d(y, 5, 1, 2,
                                                                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def _msf_resize(h, shape, interpolation: str):
    """``jax.image.resize`` to ``shape`` (``legacy_blocks.py:82-88``):
    'nearest_neighbor' by half-pixel centres (torch's 'nearest-exact');
    'bilinear' half-pixel, antialiased when it shrinks."""
    if interpolation not in ("bilinear", "nearest_neighbor"):
        raise ValueError(f"Interpolation {interpolation} does not exist!")
    size = (int(shape[0]), int(shape[1]))
    if tuple(h.shape[1:3]) == size:
        return h
    y = h.permute(0, 3, 1, 2)
    if interpolation == "nearest_neighbor":
        y = F.interpolate(y, size=size, mode="nearest-exact")
    else:
        shrink = size[0] < h.shape[1] or size[1] < h.shape[2]
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


class CRPBlock(_Scoped):
    """Chained residual pooling (reference layers.py:117-145)."""

    def __init__(self, features: int, n_stages: int, act: Callable = F.relu, generator=None):
        super().__init__()
        self.act = act
        self.convs = [self.add(NCSNConv(features, features, bias=False, generator=generator),
                               "Conv") for _ in range(n_stages)]

    def forward(self, x):
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, "max"))
            x = x + path
        return x


class RCUBlock(_Scoped):
    """Residual conv unit (reference layers.py:183-211)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu,
                 generator=None):
        super().__init__()
        self.act = act
        self.convs = [[self.add(NCSNConv(features, features, bias=False, generator=generator),
                                "Conv") for _ in range(n_stages)] for _ in range(n_blocks)]

    def forward(self, x):
        for stages in self.convs:
            residual = x
            for conv in stages:
                x = conv(self.act(x))
            x = x + residual
        return x


class MSFBlock(_Scoped):
    """Multi-scale fusion: each input projected, resized to ``shape`` and
    summed (reference layers.py:246-277); in_planes: the inputs' channels."""

    def __init__(self, in_planes: Sequence[int], features: int, shape: Sequence[int],
                 interpolation: str = "bilinear", generator=None):
        super().__init__()
        self.shape, self.interpolation = tuple(shape), interpolation
        self.convs = [self.add(NCSNConv(c, features, bias=True, generator=generator), "Conv")
                      for c in in_planes]

    def forward(self, xs):
        total = None
        for conv, x in zip(self.convs, xs):
            h = _msf_resize(conv(x), self.shape, self.interpolation)
            total = h if total is None else total + h
        return total


class RefineBlock(_Scoped):
    """RefineNet block: an RCU on each input, their MSF fusion (skipped by
    the start block, which takes its single RCU output), CRP, then the
    output RCU (reference layers.py:309-341)."""

    def __init__(self, in_planes: Sequence[int], features: int, shape: Sequence[int],
                 act: Callable = F.relu, interpolation: str = "bilinear", start: bool = False,
                 end: bool = False, generator=None):
        super().__init__()
        self.start = start
        self.rcus = [self.add(RCUBlock(c, 2, 2, act, generator)) for c in in_planes]
        if not start:
            self.add(MSFBlock(in_planes, features, shape, interpolation, generator), alias="msf")
        self.add(CRPBlock(features, 2, act, generator), alias="crp")
        self.add(RCUBlock(features, 3 if end else 1, 2, act, generator), alias="out")

    def forward(self, xs):
        hs = [rcu(x) for rcu, x in zip(self.rcus, xs)]
        h = hs[0] if self.start else self.msf(hs)
        return self.out(self.crp(h))


class CondCRPBlock(_Scoped):
    """Noise-conditional chained residual pooling, NCSNv1 (reference
    layers.py:135-151): each stage normalizes its path, then an average
    (not max) pool and the conv."""

    def __init__(self, features: int, n_stages: int, normalizer: Callable,
                 act: Callable = F.relu, generator=None):
        super().__init__()
        self.act = act
        self.stages = [(self.add(normalizer(features)),
                        self.add(NCSNConv(features, features, bias=False, generator=generator),
                                 "Conv")) for _ in range(n_stages)]

    def forward(self, x, y):
        x = self.act(x)
        path = x
        for norm, conv in self.stages:
            path = conv(_pool5(norm(path, y), "avg"))
            x = x + path
        return x


class CondRCUBlock(_Scoped):
    """Noise-conditional residual conv unit, NCSNv1 (reference
    layers.py:173-191): each stage normalizer, activation, conv."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, normalizer: Callable,
                 act: Callable = F.relu, generator=None):
        super().__init__()
        self.act = act
        self.blocks = [[(self.add(normalizer(features)),
                         self.add(NCSNConv(features, features, bias=False, generator=generator),
                                  "Conv")) for _ in range(n_stages)] for _ in range(n_blocks)]

    def forward(self, x, y):
        for stages in self.blocks:
            residual = x
            for norm, conv in stages:
                x = conv(self.act(norm(x, y)))
            x = x + residual
        return x


class CondMSFBlock(_Scoped):
    """Noise-conditional multi-scale fusion, NCSNv1 (reference
    layers.py:217-241): each input normalized before its projection."""

    def __init__(self, in_planes: Sequence[int], features: int, shape: Sequence[int],
                 normalizer: Callable, interpolation: str = "bilinear", generator=None):
        super().__init__()
        self.shape, self.interpolation = tuple(shape), interpolation
        self.inputs = [(self.add(normalizer(c)),
                        self.add(NCSNConv(c, features, bias=True, generator=generator), "Conv"))
                       for c in in_planes]

    def forward(self, xs, y):
        total = None
        for (norm, conv), x in zip(self.inputs, xs):
            h = _msf_resize(conv(norm(x, y)), self.shape, self.interpolation)
            total = h if total is None else total + h
        return total


class CondRefineBlock(_Scoped):
    """Noise-conditional RefineNet block, NCSNv1 (reference
    layers.py:271-310): RefineBlock's structure on the conditional blocks."""

    def __init__(self, in_planes: Sequence[int], features: int, shape: Sequence[int],
                 normalizer: Callable, act: Callable = F.relu, interpolation: str = "bilinear",
                 start: bool = False, end: bool = False, generator=None):
        super().__init__()
        self.start = start
        self.rcus = [self.add(CondRCUBlock(c, 2, 2, normalizer, act, generator))
                     for c in in_planes]
        if not start:
            self.add(CondMSFBlock(in_planes, features, shape, normalizer, interpolation,
                                  generator), alias="msf")
        self.add(CondCRPBlock(features, 2, normalizer, act, generator), alias="crp")
        self.add(CondRCUBlock(features, 3 if end else 1, 2, normalizer, act, generator),
                 alias="out")

    def forward(self, xs, y):
        hs = [rcu(x, y) for rcu, x in zip(self.rcus, xs)]
        h = hs[0] if self.start else self.msf(hs, y)
        return self.out(self.crp(h, y), y)


class LegacyAttnBlock(_Scoped):
    """Channel-wise self-attention, DDPM-era (reference layers.py:504-522):
    GroupNorm, the q, k, v projections, attention (the plain version),
    the zero-initialised output projection, the residual."""

    def __init__(self, c: int, generator=None):
        super().__init__()
        self.add(GroupNorm(c), alias="norm")
        for name in ("q", "k", "v"):
            self.add(NIN(c, c, generator=generator), alias=name)
        self.add(NIN(c, c, init_scale=0.0, generator=generator), alias="out")

    def forward(self, x):
        h = self.norm(x)
        h = self_attention_2d(self.q(h), self.k(h), self.v(h), impl="xla")
        return x + self.out(h)


class LegacyUpsample(_Scoped):
    """Nearest 2x upsampling, then optionally a 3x3 conv (reference
    layers.py:525-538)."""

    def __init__(self, c: int, with_conv: bool = False, generator=None):
        super().__init__()
        self.conv = None
        if with_conv:
            self.add(Conv(c, c, 3, generator=generator), alias="conv")

    def forward(self, x):
        y = naive_upsample_2d(x, 2)
        return self.conv(y) if self.conv is not None else y


class LegacyDownsample(_Scoped):
    """A 3x3 conv at stride 2, or a 2x2 average pool, both "SAME"
    (reference layers.py:541-552)."""

    def __init__(self, c: int, with_conv: bool = False, generator=None):
        super().__init__()
        self.conv = None
        if with_conv:
            self.add(Conv(c, c, 3, generator=generator, stride=2), alias="conv")

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.conv(x) if self.conv is not None else avg_pool_same(x, 2)
        assert y.shape == (b, h // 2, w // 2, c)
        return y


class LegacyResnetBlockDDPM(_Scoped):
    """The original DDPM residual block (reference layers.py:555-568):
    GroupNorm + act, conv, plus the temb projection (``temb_dim`` given),
    GroupNorm + act, dropout, the zero-initialised conv, and the skip (a 3x3
    conv with ``conv_shortcut``, else NIN) where the width changes."""

    def __init__(self, cin: int, act: Callable, out_ch: int | None = None,
                 conv_shortcut: bool = False, dropout: float = 0.1, temb_dim: int | None = None,
                 generator=None):
        super().__init__()
        out_ch = out_ch or cin
        self.act, self.dropout = act, dropout
        self.dense = self.skip = None
        self.add(GroupNorm(cin), alias="norm1")
        self.add(Conv(cin, out_ch, 3, generator=generator), alias="conv1")
        if temb_dim:
            self.add(Dense(temb_dim, out_ch, generator, default_init()), alias="dense")
        self.add(GroupNorm(out_ch), alias="norm2")
        self.add(Conv(out_ch, out_ch, 3, init_scale=0.0, generator=generator), alias="conv2")
        if cin != out_ch:
            self.add(Conv(cin, out_ch, 3, generator=generator) if conv_shortcut
                     else NIN(cin, out_ch, generator=generator), alias="skip")

    def forward(self, x, temb=None, train: bool = False, generator=None):
        """train: dropout, its mask drawn from ``generator``."""
        h = self.conv1(self.act(self.norm1(x)))
        if temb is not None:
            h = h + self.dense(self.act(temb))[:, None, None, :]
        h = self.act(self.norm2(h))
        if train and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        h = self.conv2(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h
