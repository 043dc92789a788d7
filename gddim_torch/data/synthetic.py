"""The synthetic image stream the trainer reads (no dataset is in the repo).

Counterpart of ``gddim_tpu/data/pipelines.py``: ``synthetic_images`` is
``_synthetic_images`` (smooth random Fourier textures, uint8, the same
corpus from the same seed), ``get_data_scaler`` the centred scaler, and
``SyntheticStream`` the shuffled, flipped batch iterator of its
``ArrayDataset`` (same numpy draws, so the same batches) with a leading
``n_jitted_steps`` axis, as ``get_dataset(config, additional_dim=...)`` for
a synthetic or data-less config.
"""

from __future__ import annotations

import numpy as np

CORPUS_SIZE = 2048  # pipelines.py:571


def synthetic_images(config, n: int, seed: int) -> np.ndarray:
    """(n, S, S, C) uint8 pseudo-images, deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    s = config.data.image_size
    c = config.data.num_channels
    yy, xx = np.meshgrid(np.arange(s, dtype=np.float32), np.arange(s, dtype=np.float32),
                         indexing="ij")
    imgs = np.zeros((n, s, s, c), dtype=np.float32)
    for k in range(4):
        scale = np.float32((k + 1) * 2 * np.pi / s)
        fx = rng.normal(size=(n, 1, 1, c)).astype(np.float32) * scale
        fy = rng.normal(size=(n, 1, 1, c)).astype(np.float32) * scale
        phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1, c)).astype(np.float32)
        arg = fx * xx[None, :, :, None]
        arg += fy * yy[None, :, :, None]
        arg += phase
        imgs += np.sin(arg, out=arg)
    imgs -= imgs.min()
    imgs /= imgs.max() + 1e-9
    return (imgs * 255).astype(np.uint8)


def get_data_scaler(config):
    """[0, 1] -> [-1, 1] when data.centered."""
    if config.data.centered:
        return lambda x: x * 2.0 - 1.0
    return lambda x: x


class SyntheticStream:
    """Endless shuffled batches of the synthetic corpus, in [0, 1], shaped
    (n_jitted, batch, S, S, C) float32."""

    def __init__(self, config, batch: int, n_jitted: int, seed: int):
        self.batch_dims = (n_jitted, batch)
        self.flat = int(np.prod(self.batch_dims))
        self.images = synthetic_images(config, max(CORPUS_SIZE, self.flat), seed)
        self.rng = np.random.default_rng(seed)
        self.random_flip = bool(config.data.random_flip)
        self._perm = None
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        n = len(self.images)
        if self._perm is None or self._pos + self.flat > n:
            self._perm = self.rng.permutation(n)
            self._pos = 0
        idx = self._perm[self._pos: self._pos + self.flat]
        self._pos += self.flat
        imgs = self.images[idx].astype(np.float32) / 255.0
        if self.random_flip:
            flip = self.rng.random(len(imgs)) < 0.5
            imgs[flip] = imgs[flip, :, ::-1]
        return imgs.reshape(self.batch_dims + imgs.shape[1:])
