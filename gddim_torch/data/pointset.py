"""Synthetic 2-D point sets (counterpart of ``gddim_tpu/data/pointset.py``).

The same numpy draws in the same order as the JAX package's, so the same
``rng`` gives the same points bit for bit. Without an ``rng`` both draw from
an unseeded ``np.random.default_rng()``; the port's pipeline always passes
one seeded from ``config.seed`` (``data/pipelines.py``).
"""

from __future__ import annotations

import numpy as np


def circle_generate_sample(n: int, noise: float = 0.25, rng=None) -> np.ndarray:
    """n points on the unit circle plus Gaussian noise of std noise * sqrt(0.2)."""
    rng = rng or np.random.default_rng()
    angle = rng.uniform(high=2 * np.pi, size=n)
    random_noise = rng.normal(scale=np.sqrt(0.2), size=(n, 2))
    pos = np.stack([np.cos(angle), np.sin(angle)]).T
    return pos + noise * random_noise


def olympic_generate_sample(n: int, noise: float = 0.25, rng=None) -> np.ndarray:
    """The five Olympic rings: n // 5 noisy circle points around each centre."""
    rng = rng or np.random.default_rng()
    w, h = 3.5, 1.5
    centers = np.array([[-w, h], [0.0, h], [w, h], [-w * 0.6, -h], [w * 0.6, -h]])
    pos = [circle_generate_sample(n // 5, noise, rng) + centers[i: i + 1] / 2 for i in range(5)]
    return np.concatenate(pos)
