"""The noise-conditional WideResNet-28-10 classifier (counterpart of
``gddim_tpu/models/wideresnet.py``).

Classifier guidance's network: per-image standardisation (the std floored
at 1/sqrt(H*W*C)), Gaussian Fourier features of log sigma (128 at scale 16)
through two Dense layers of 512, three groups of ``blocks_per_group`` wide
residual blocks (16, 32, 64 times ``channel_multiplier`` channels; the
second and third groups at stride 2), GroupNorm + relu before the global
average pool and the Dense head. A block: GroupNorm(eps 1e-5, min(C//4, 32)
groups; F.group_norm's two-pass statistics) + relu, a 3x3 conv (no bias),
the Dense temb projection of
swish(temb) added, GroupNorm + relu, a 3x3 conv; the skip is the input (the
normalised input in a group's first block with ``activate_before_residual``)
average-pooled at the stride and zero-padded in channels where the shape
changes. Parameter names follow the JAX tree (``init_bn``, ``conv1``,
``Dense_0``, ``bn_2``, ``conv2``, ``init_conv``, ``pre-pool-bn``), so
``convert.flax_to_state_dict`` maps it one to one.

It runs no kernel of the port: its GroupNorms are followed by relu, not
swish, so K1 does not apply, and its convs are the JAX package's
``nn.Conv``, which never reached K11. Trained weights are not in the
repository; ``create_classifier`` reads a port ``state_dict`` or a flax
msgpack file, and refuses an orbax directory (the JAX package's format).
"""

from __future__ import annotations

import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.models.layers import (
    Dense,
    GaussianFourierProjection,
    GroupNorm,
    lecun_normal,
    same_pads,
)
from gddim_torch.models.registry import register_model

# the CIFAR-10 statistics the logit function standardises by (wideresnet.py:156-157)
IMAGE_MEAN = (0.49139968, 0.48215841, 0.44653091)
IMAGE_STD = (0.24703223, 0.24348513, 0.26158784)


def _conv_init(shape, generator=None):
    """variance_scaling(2.0, 'fan_out', 'normal') of an HWIO kernel."""
    fan_out = math.prod(shape[:-2]) * shape[-1]
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_out)


def _head_init(shape, generator=None):
    """U(-1/sqrt(out), 1/sqrt(out)) (``wideresnet.py:_dense_init``)."""
    scale = 1.0 / math.sqrt(shape[-1])
    return (2.0 * torch.rand(shape, generator=generator) - 1.0) * scale


class ConvNoBias(nn.Module):
    """A 3x3 SAME conv without bias at ``stride`` (XLA's SAME padding),
    NHWC / HWIO: flax's ``nn.Conv(use_bias=False)``."""

    flax_leaves = {"kernel": "weight"}

    def __init__(self, cin: int, cout: int, stride: int = 1, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_conv_init((3, 3, cin, cout), generator))
        self.stride = stride

    def forward(self, x):
        (t, b), (le, r) = (same_pads(n, 3, self.stride) for n in x.shape[1:3])
        y = F.pad(x.permute(0, 3, 1, 2), (le, r, t, b))
        y = F.conv2d(y, self.weight.to(x.dtype).permute(3, 2, 0, 1), stride=self.stride)
        return y.permute(0, 2, 3, 1)


def _norm_relu(norm: GroupNorm, x):
    """GroupNorm (two-pass statistics, in x's dtype) + relu, NHWC."""
    y = F.group_norm(x.permute(0, 3, 1, 2), norm.num_groups, norm.weight.to(x.dtype),
                     norm.bias.to(x.dtype), norm.eps)
    return F.relu(y.permute(0, 2, 3, 1))


class WideResnetBlock(nn.Module):
    subscopes = {"init_bn": "init_bn", "conv1": "conv1", "Dense_0": "dense", "bn_2": "bn_2",
                 "conv2": "conv2"}

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 activate_before_residual: bool = False, temb_dim: int = 512, generator=None):
        super().__init__()
        self.stride = stride
        self.activate_before_residual = activate_before_residual
        self.init_bn = GroupNorm(cin, eps=1e-5)
        self.conv1 = ConvNoBias(cin, channels, stride, generator)
        self.dense = Dense(temb_dim, channels, generator=generator, init=lecun_normal())
        self.bn_2 = GroupNorm(channels, eps=1e-5)
        self.conv2 = ConvNoBias(channels, channels, 1, generator)

    def forward(self, x, temb):
        if self.activate_before_residual:
            x = _norm_relu(self.init_bn, x)
            orig = x
        else:
            orig = x
            x = _norm_relu(self.init_bn, x)
        x = self.conv1(x)
        x = x + self.dense(F.silu(temb))[:, None, None, :]
        x = self.conv2(_norm_relu(self.bn_2, x))
        if orig.shape != x.shape:
            if self.stride > 1:
                orig = F.avg_pool2d(orig.permute(0, 3, 1, 2), self.stride).permute(0, 2, 3, 1)
            orig = F.pad(orig, (0, x.shape[-1] - orig.shape[-1]))
        return x + orig


class WideResnetGroup(nn.ModuleList):
    """``blocks_per_group`` blocks, the first at ``stride``."""

    def __init__(self, blocks_per_group: int, cin: int, channels: int, stride: int = 1,
                 activate_before_residual: bool = False, generator=None):
        super().__init__([
            WideResnetBlock(cin if i == 0 else channels, channels, stride if i == 0 else 1,
                            activate_before_residual and i == 0, generator=generator)
            for i in range(blocks_per_group)])
        self.subscopes = {f"WideResnetBlock_{i}": str(i) for i in range(blocks_per_group)}

    def forward(self, x, temb):
        for block in self:
            x = block(x, temb)
        return x


@register_model(name="wideresnet_noise_conditional")
class WideResnet(nn.Module):
    """The WideResNet classifier conditioned on the noise level:
    (x (B, H, W, 3), sigmas (B,)) -> logits (B, num_outputs), f32."""

    def __init__(self, blocks_per_group: int = 4, channel_multiplier: int = 10,
                 num_outputs: int = 10, config=None, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.fourier = GaussianFourierProjection(128, 16, generator=g)
        self.temb0 = Dense(256, 512, generator=g, init=lecun_normal())
        self.temb1 = Dense(512, 512, generator=g, init=lecun_normal())
        self.init_conv = ConvNoBias(3, 16, 1, g)
        widths = [16 * channel_multiplier, 32 * channel_multiplier, 64 * channel_multiplier]
        self.groups = nn.ModuleList([
            WideResnetGroup(blocks_per_group, 16, widths[0], 1, True, g),
            WideResnetGroup(blocks_per_group, widths[0], widths[1], 2, False, g),
            WideResnetGroup(blocks_per_group, widths[1], widths[2], 2, False, g)])
        self.pre_pool_bn = GroupNorm(widths[2], eps=1e-5)
        self.head = Dense(widths[2], num_outputs, generator=g, init=_head_init)
        # flax scope names of the top level (convert.py)
        self.scopes = ([("GaussianFourierProjection_0", self.fourier), ("Dense_0", self.temb0),
                        ("Dense_1", self.temb1), ("init_conv", self.init_conv)]
                       + [(f"WideResnetGroup_{i}", grp) for i, grp in enumerate(self.groups)]
                       + [("pre-pool-bn", self.pre_pool_bn), ("Dense_2", self.head)])

    def forward(self, x, sigmas, train: bool = False):
        """In x's dtype (f32; f64 for a check of the arithmetic)."""
        n = math.prod(x.shape[1:])
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
        x = (x - mean) / torch.clamp_min(std, 1.0 / math.sqrt(n))
        temb = self.fourier(torch.log(sigmas.to(x.dtype)))
        temb = self.temb1(F.silu(self.temb0(temb)))
        x = self.init_conv(x)
        for group in self.groups:
            x = group(x, temb)
        x = _norm_relu(self.pre_pool_bn, x)
        return self.head(x.mean(dim=(1, 2)))


def create_classifier(generator: torch.Generator | None, batch_size: int,
                      ckpt_path: str | None = None, device="cuda"):
    """(classifier, its parameters as a ``state_dict``): WideResNet-28-10
    (4 blocks a group, multiplier 10, 10 classes) drawn from ``generator``
    on the CPU and moved to ``device``, or restored from ``ckpt_path``: a
    port ``state_dict`` file (``torch.save``) or a flax msgpack file of the
    parameter tree (``{'params': tree}`` or the tree). ``batch_size`` is the
    JAX signature's (its init batch); the port needs none."""
    del batch_size
    classifier = WideResnet(4, 10, 10, generator=generator)
    if ckpt_path:
        path = Path(ckpt_path)
        if path.is_dir():
            raise ValueError(f"{path}: an orbax checkpoint directory; the port reads a "
                             "state_dict file or a flax msgpack file of the parameters")
        with open(path, "rb") as f:
            zip_file = f.read(4) == b"PK\x03\x04"
        if zip_file:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        else:
            from gddim_torch import convert
            from gddim_torch.checkpoints.legacy import legacy_state_dict

            tree = legacy_state_dict(path)
            tree = tree.get("params", tree)
            sd = convert.flax_to_state_dict(classifier, tree)
        classifier.load_state_dict(sd)
    classifier = classifier.to(device).eval()
    return classifier, classifier.state_dict()


def get_logit_fn(classifier, classifier_params=None):
    """logit_fn(data, ve_noise_scale) -> logits, data (B, H, W, 3) in [0, 1]
    standardised by the CIFAR-10 statistics first. ``classifier_params``: a
    state_dict to load first (the JAX signature's parameters), or None."""
    if classifier_params is not None:
        classifier.load_state_dict(classifier_params)

    def logit_fn(data, ve_noise_scale):
        dtype = data.dtype if data.is_floating_point() else torch.float32
        mean = torch.tensor(IMAGE_MEAN, device=data.device, dtype=dtype)
        std = torch.tensor(IMAGE_STD, device=data.device, dtype=dtype)
        return classifier((data.to(dtype) - mean) / std, ve_noise_scale, train=False)

    return logit_fn


def get_classifier_grad_fn(logit_fn):
    """grad_fn(data, ve_noise_scale, labels) -> d/d data of sum_b log
    softmax(logits_b)[labels_b], the gradient classifier guidance adds to
    the score."""

    def grad_fn(data, ve_noise_scale, labels):
        with torch.enable_grad():
            d = data.detach()
            d = (d if d.is_floating_point() else d.float()).requires_grad_(True)
            logp = torch.log_softmax(logit_fn(d, ve_noise_scale), -1)
            picked = logp[torch.arange(labels.shape[0], device=d.device), labels.long()].sum()
            (grad,) = torch.autograd.grad(picked, d)
        return grad

    return grad_fn
