"""Feature extractors for FID / IS (counterpart of ``gddim_tpu/evals/features.py``).

- ``inception``: InceptionV3 from a local ``.npz`` (``eval.inception_weights``,
  ``evals/inception.py``): 2048-d pool_3 features and 1008 / 1000 logits.
- ``proxy``: a fixed, seeded 3-layer random conv net with pooled moments, the
  JAX package's weights draw for draw (numpy, seed 1234). For pipeline
  tests and relative comparisons where Inception weights are absent; its
  distances are not comparable to published FIDs and are reported under
  ``_proxy`` keys.

``run_features`` runs an extractor over a uint8 corpus in batches on the
extractor's device, in float32 (TF32 off), where the JAX package shards the
batches over its mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FeatureExtractor:
    def __init__(self, name, apply_fn, feature_dim, logits_dim):
        self.name = name
        self.apply_fn = apply_fn  # (B, H, W, C) images in [0, 255] -> {pool_3, logits}
        self.feature_dim = feature_dim
        self.logits_dim = logits_dim

    @property
    def device(self) -> torch.device:
        return self.apply_fn.device


def _same_pad(x, k: int, stride: int):
    """XLA's 'SAME' padding of an NCHW map for a k x k kernel: the extra
    pixel of an odd total goes after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ProxyNet(nn.Module):
    """Three stride-2 3x3 convs with tanh-GELU, then each channel's mean and
    standard deviation as the features and a linear map to 100 logits."""

    def __init__(self, channels: int = 3, dim: int = 256):
        super().__init__()
        rng = np.random.default_rng(1234)
        draws = [rng.normal(size=(3, 3, channels, 32)) / np.sqrt(9 * channels),
                 rng.normal(size=(3, 3, 32, 64)) / np.sqrt(9 * 32),
                 rng.normal(size=(3, 3, 64, dim // 2)) / np.sqrt(9 * 64)]
        for i, k in enumerate(draws):  # HWIO -> OIHW
            self.register_buffer(f"k{i}", torch.from_numpy(
                k.astype(np.float32).transpose(3, 2, 0, 1).copy()))
        self.register_buffer("w_logits", torch.from_numpy(
            (rng.normal(size=(dim, 100)) / np.sqrt(dim)).astype(np.float32)))

    @property
    def device(self):
        return self.w_logits.device

    def forward(self, images) -> dict:
        x = images.to(self.device, torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
        for k in (self.k0, self.k1, self.k2):
            x = F.gelu(F.conv2d(_same_pad(x, 3, 2), k, stride=2), approximate="tanh")
        pool = torch.cat([x.mean(dim=(2, 3)), x.std(dim=(2, 3), correction=0)], dim=-1)
        return {"pool_3": pool, "logits": pool @ self.w_logits}


def get_feature_extractor(config, device="cuda") -> FeatureExtractor:
    weights = str(config.eval.inception_weights or "")
    if weights:
        from gddim_torch.evals.inception import load_inception_extractor

        return load_inception_extractor(weights, device)
    net = ProxyNet(config.data.num_channels).to(device).eval()
    return FeatureExtractor("proxy", net, 256, 100)


@torch.no_grad()
def run_features(extractor: FeatureExtractor, images: np.ndarray, batch_size: int = 256):
    """(pool_3, logits) float32 numpy arrays of a uint8 (N, H, W, C) corpus."""
    pools, logits = [], []
    device = extractor.device
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i in range(0, len(images), batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(images[i: i + batch_size])).to(device)
            out = extractor.apply_fn(chunk)
            pools.append(out["pool_3"].float().cpu().numpy())
            logits.append(out["logits"].float().cpu().numpy())
    return np.concatenate(pools), np.concatenate(logits)
