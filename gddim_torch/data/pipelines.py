"""Input pipelines on local data (counterpart of ``gddim_tpu/data/pipelines.py``).

numpy only. From the same corpus and seed they give the JAX package's
batches bit for bit: the same corpus loaders, the same shuffling without
replacement (one permutation an epoch, the remainder dropped), then the
flips, then the uniform dequantization noise, drawn from one
``np.random.default_rng`` in that order, and the same held-out split rule.
Batches are ``{'image': float32 [0, 1]}`` shaped ``(n_jitted_steps, B, H, W,
C)`` with ``additional_dim``, else ``(B, H, W, C)``. ``evaluation=True``
makes both iterators one epoch long, ending in StopIteration; training
iterators repeat. One process: the corpus is not sharded.

Corpora: CIFAR-10 as the ``cifar-10-batches-py`` pickles or
``cifar10_{train,test}.npz``, other ``<name>_<split>.npz`` / ``<name>.npz``
files at the configured size, or the synthetic corpus (``data.synthetic``,
or no ``data.data_dir``). Not ported: the crops and resizes (PIL), image
folders, TFRecord corpora (FFHQ, CelebA-HQ) and the points dataset; they
raise.
"""

from __future__ import annotations

import logging
import pickle
import queue
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("gddim_torch")

SYNTHETIC_SIZE = 2048  # images in the synthetic training corpus


def get_data_scaler(config):
    """[0, 1] -> [-1, 1] when data.centered."""
    if config.data.centered:
        return lambda x: x * 2.0 - 1.0
    return lambda x: x


def get_data_inverse_scaler(config):
    """[-1, 1] -> [0, 1] when data.centered."""
    if config.data.centered:
        return lambda x: (x + 1.0) / 2.0
    return lambda x: x


def get_data_shape(config):
    """The samplers' per-sample shape (H, W, C)."""
    if "ps" in config.data.dataset.lower():
        raise NotImplementedError("the points dataset is not ported")
    return (config.data.image_size, config.data.image_size, config.data.num_channels)


def _to_unit(images: np.ndarray) -> np.ndarray:
    return images.astype(np.float32) / (255.0 if images.dtype == np.uint8 else 1.0)


def preprocess_corpus(name: str, images: np.ndarray, size: int) -> np.ndarray:
    """Float32 images in [0, 1]: the JAX package's preprocessing of a corpus
    stored at the configured size (clipped for CIFAR-10, SVHN, CelebA and
    LSUN, as there). The resizes and crops are not ported and raise."""
    name = name.lower().split("_")[0].split("/")[0]
    if images.shape[1] != size or images.shape[2] != size:
        raise NotImplementedError(
            f"resizing a {images.shape[1]}x{images.shape[2]} {name} corpus to {size} is not ported")
    if name == "lsun" and size != 128:
        raise NotImplementedError("the LSUN crop + bicubic resize pipeline is not ported")
    imgs = _to_unit(images)
    if name in ("cifar10", "svhn", "celeba", "lsun"):
        return np.clip(imgs, 0.0, 1.0)
    return imgs


def _load_cifar10_dir(data_dir: str, train: bool) -> np.ndarray:
    """CIFAR-10 from the ``cifar-10-batches-py`` pickles or an .npz: uint8 NHWC."""
    d = Path(data_dir)
    npz = d / ("cifar10_train.npz" if train else "cifar10_test.npz")
    if npz.exists():
        with np.load(npz) as z:
            return z["images"]
    batch_dir = d / "cifar-10-batches-py"
    if not batch_dir.exists() and (d / "data_batch_1").exists():
        batch_dir = d
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    arrays = []
    for name in names:
        with open(batch_dir / name, "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        arrays.append(raw[b"data"])
    return np.concatenate(arrays).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def _find_corpus(config, train: bool) -> np.ndarray | None:
    """The split's raw corpus under ``data.data_dir``, or None. Held-out
    splits: 'test' for CIFAR-10 / SVHN, 'validation' for CelebA / LSUN."""
    name = config.data.dataset.lower()
    d = Path(config.data.data_dir)
    if name == "cifar10" and (
        (d / "cifar-10-batches-py").exists() or (d / "data_batch_1").exists()
        or (d / ("cifar10_train.npz" if train else "cifar10_test.npz")).exists()
    ):
        try:
            return _load_cifar10_dir(config.data.data_dir, train)
        except FileNotFoundError:
            return None
    if name in ("ffhq", "celebahq"):
        raise NotImplementedError(f"the {name} TFRecord corpus is not ported")
    split_names = (
        ["train"] if train else
        (["validation", "val", "test"] if name.split("_")[0] in ("celeba", "lsun")
         else ["test", "validation", "val"])
    )
    for split in split_names + (["train"] if train else []):
        npz = d / f"{name}_{split}.npz"
        if npz.exists():
            with np.load(npz) as z:
                return z["images"]
    if train:
        npz = d / f"{name}.npz"
        if npz.exists():
            with np.load(npz) as z:
                return z["images"]
        if d.is_dir() and any(p.suffix.lower() in (".png", ".jpg", ".jpeg", ".webp")
                              for p in d.rglob("*")):
            raise NotImplementedError("image-folder corpora (PIL) are not ported")
    return None


def _synthetic_images(config, n: int, seed: int) -> np.ndarray:
    """(n, S, S, C) uint8 pseudo-images (smooth random Fourier textures),
    deterministic in ``seed``."""
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


_STOP = object()


class _Prefetcher:
    """A background thread that makes the next batches while the card
    computes; ``close`` stops it."""

    def __init__(self, gen_fn):
        self._gen = gen_fn
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; False when closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._gen()
            except StopIteration:
                self._put(_STOP)
                return
            except Exception as e:  # handed to the consumer, raised by next()
                self._put(e)
                return
            if not self._put(item):
                return

    def close(self):
        """Stop the thread and drop its queued batches; next() then ends."""
        self._stop.set()
        self._thread.join()
        self._done = True
        self._q = queue.Queue()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _STOP or isinstance(item, Exception):
            self._done = True
            if item is _STOP:
                raise StopIteration
            raise item
        return item


class ArrayDataset:
    """Shuffled batches of an in-memory corpus (uint8 or float).

    num_epochs=None repeats forever; a count raises StopIteration after that
    many shuffled passes. The remainder of each pass is dropped. With
    ``prefetch`` a thread makes the batches, started by the first ``next``
    and stopped by ``close`` (or the end of the last pass); the draws are the
    same either way.
    """

    def __init__(self, images: np.ndarray, batch_dims: tuple[int, ...], *, seed: int = 0,
                 random_flip: bool = False, uniform_dequantization: bool = False,
                 evaluation: bool = False, num_epochs: int | None = None,
                 prefetch: bool = True):
        self.images = images
        self.batch_dims = tuple(batch_dims)
        self.flat = int(np.prod(self.batch_dims))
        if self.flat > len(images):
            raise ValueError(f"batch of {self.flat} exceeds corpus of {len(images)}")
        self.rng = np.random.default_rng(seed)
        self.random_flip = random_flip and not evaluation
        self.uniform_dequantization = uniform_dequantization
        self.evaluation = evaluation
        self.num_epochs = num_epochs
        self._epochs_done = 0
        self._perm = None
        self._pos = 0
        self._prefetch = prefetch
        self._iter = None

    def _next_indices(self):
        n = len(self.images)
        if self._perm is None or self._pos + self.flat > n:
            if self._perm is not None:
                self._epochs_done += 1
            if self.num_epochs is not None and self._epochs_done >= self.num_epochs:
                raise StopIteration
            self._perm = self.rng.permutation(n)
            self._pos = 0
        idx = self._perm[self._pos: self._pos + self.flat]
        self._pos += self.flat
        return idx

    def _make_batch(self):
        idx = self._next_indices()
        imgs = self.images[idx]
        if imgs.dtype == np.uint8:
            imgs = imgs.astype(np.float32) / 255.0
        else:
            imgs = imgs.astype(np.float32)
        if self.random_flip:
            flip = self.rng.random(len(imgs)) < 0.5
            imgs[flip] = imgs[flip, :, ::-1]
        if self.uniform_dequantization:
            imgs = (self.rng.uniform(size=imgs.shape).astype(np.float32) + imgs * 255.0) / 256.0
        return {"image": imgs.reshape(self.batch_dims + imgs.shape[1:])}

    def __iter__(self):
        return self

    def __next__(self):
        if not self._prefetch:
            return self._make_batch()
        if self._iter is None:
            self._iter = _Prefetcher(self._make_batch)
        return next(self._iter)

    def close(self):
        """Stop the prefetch thread, if one runs."""
        if self._iter is not None:
            self._iter.close()


def _split(train_images, name: str, flat: int):
    """The held-out split where the corpus has none: the trailing 10% (at
    most 10,000) of train, if both parts hold a batch; else eval reuses train."""
    n_eval = min(max(len(train_images) // 10, 1), 10_000)
    if len(train_images) - n_eval >= flat and n_eval >= flat:
        logger.warning("no held-out %s corpus; holding out trailing %d train images for eval",
                       name, n_eval)
        return train_images[:-n_eval], train_images[-n_eval:]
    logger.warning("corpus too small to hold out an eval split; eval reuses train images")
    return train_images, train_images


def get_dataset(config, additional_dim=None, uniform_dequantization=False, evaluation=False,
                prefetch=True):
    """(train_iter, eval_iter) over the configured corpus.

    additional_dim: n_jitted_steps (a leading axis of the batches) or None.
    evaluation=True: both iterators one epoch long, at eval.batch_size.
    prefetch: each iterator makes its batches on a thread of its own
    (``ArrayDataset.close`` stops it).
    """
    batch_size = config.training.batch_size if not evaluation else config.eval.batch_size
    batch_dims = (additional_dim, batch_size) if additional_dim else (batch_size,)
    flat = int(np.prod(batch_dims))
    num_epochs = 1 if evaluation else None
    name = config.data.dataset.lower()
    if "ps" in name:
        raise NotImplementedError("the points dataset is not ported")

    if config.data.synthetic or not config.data.data_dir:
        n = SYNTHETIC_SIZE if not config.data.is_partial else 512
        n = max(n, flat)
        train_images = _synthetic_images(config, n, seed=config.seed)
        # a disjoint eval corpus: another draw
        eval_images = _synthetic_images(config, max(n // 2, flat), seed=config.seed + 7919)
    else:
        train_images = _find_corpus(config, train=True)
        if train_images is None:
            raise FileNotFoundError(f"no data for {name} under {config.data.data_dir}")
        eval_images = _find_corpus(config, train=False)
        if eval_images is None:
            train_images, eval_images = _split(train_images, name, flat)
        shared = eval_images is train_images
        size = config.data.image_size
        train_images = preprocess_corpus(name, train_images, size)
        eval_images = train_images if shared else preprocess_corpus(name, eval_images, size)
        if config.data.is_partial:
            train_images = train_images[: max(len(train_images) // 1000, 1)]

    train = ArrayDataset(train_images, batch_dims, seed=config.seed,
                         random_flip=config.data.random_flip,
                         uniform_dequantization=uniform_dequantization, evaluation=evaluation,
                         num_epochs=num_epochs, prefetch=prefetch)
    eval_ds = ArrayDataset(eval_images, batch_dims, seed=config.seed + 1,
                           uniform_dequantization=uniform_dequantization, evaluation=True,
                           num_epochs=num_epochs, prefetch=prefetch)
    return train, eval_ds
