"""Input pipelines on local data (counterpart of ``gddim_tpu/data/pipelines.py``).

numpy only. From the same corpus and seed they give the JAX package's
batches bit for bit: the same corpus loaders and preprocessing, the same
shuffling without replacement (one permutation an epoch, the remainder
dropped), then the flips, then the uniform dequantization noise, drawn from
one ``np.random.default_rng`` in that order, and the same held-out split
rule. Batches are ``{'image': float32 [0, 1]}`` shaped ``(n_jitted_steps,
B, H, W, C)`` with ``additional_dim``, else ``(B, H, W, C)``.
``evaluation=True`` makes both iterators one epoch long, ending in
StopIteration; training iterators repeat. One process: the corpus is not
sharded.

Corpora: CIFAR-10 as the ``cifar-10-batches-py`` pickles or
``cifar10_{train,test}.npz``, other ``<name>_<split>.npz`` / ``<name>.npz``
files under ``data.data_dir``, FFHQ and CelebA-HQ from the TFRecord file
``data.tfrecords_path`` (raw CHW uint8 ``tf.train.Example`` records, read
and written by the dependency-free codec below; one corpus for both
splits), the synthetic corpus (``data.synthetic``, or no
``data.data_dir``), and the point sets (``ps_*``: the Olympic rings, 12,800
points at noise 0.01, standardised per dimension; the JAX package draws
them from an unseeded generator, the port from ``config.seed``).

``preprocess_corpus`` dispatches as the JAX package does (CIFAR-10 / SVHN
bilinear, CelebA central crop 140 then bilinear, LSUN at 128 resize-small
then crop, other LSUN sizes square crop, bicubic and uint8 rounding, FFHQ /
CelebA-HQ as stored). Its antialiased resize is PIL's ``Image.resize`` on
mode-"F" planes written in numpy (``pil_resize``), so that the port needs
no PIL for it. An image folder (PNG / JPEG / WebP files under data_dir, at
any depth, in sorted order, each converted to RGB) is decoded by PIL, as
the JAX package decodes it, imported only there: without PIL it raises
ImportError, and the images can be stored as <name>_train.npz instead.
"""

from __future__ import annotations

import logging
import math
import pickle
import queue
import struct
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("gddim_torch")

SYNTHETIC_SIZE = 2048  # images in the synthetic training corpus
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".webp")  # an image folder's files


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


POINTSET_SIZE = 128 * 100  # points of the point-set corpus (pipelines.py:556)


def get_data_shape(config):
    """The samplers' per-sample shape: (H, W, C), or (dim,) for a point set."""
    if "ps" in config.data.dataset.lower():
        return (config.data.dim,)
    return (config.data.image_size, config.data.image_size, config.data.num_channels)


def pointset_corpus(rng: np.random.Generator) -> np.ndarray:
    """The point-set corpus (``gddim_tpu/data/pipelines.py:553-567``): the
    Olympic rings drawn from ``rng`` at noise 0.01, standardised per
    dimension, f32."""
    from gddim_torch.data.pointset import olympic_generate_sample

    raw = olympic_generate_sample(POINTSET_SIZE, noise=0.01, rng=rng)
    raw = (raw - raw.mean(0, keepdims=True)) / raw.std(0, keepdims=True)
    return raw.astype(np.float32)


def _to_unit(images: np.ndarray) -> np.ndarray:
    return images.astype(np.float32) / (255.0 if images.dtype == np.uint8 else 1.0)


# ---------------------------------------------------------------------------
# resizes and crops (``gddim_tpu/data/pipelines.py:74-162``)
# ---------------------------------------------------------------------------


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


# method -> (filter, its support), PIL's (libImaging/Resample.c)
_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def resample_coeffs(in_size: int, out_size: int, method: str):
    """PIL's ``precompute_coeffs`` for a whole axis: (taps (out, K) int,
    weights (out, K) f64). Output pixel i reads the input pixels
    xmin .. xmin + n - 1 with xmin = max(int(center - support + 0.5), 0),
    center = (i + 0.5) * scale, the support the filter's times
    max(in / out, 1), each weighted filter((j + xmin - center + 0.5) /
    filterscale) and the weights normalised to sum 1 (summed in order);
    the unused trailing taps carry weight 0."""
    filt, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support *= filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    taps = np.zeros((out_size, ksize), np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        w = filt((np.arange(n) + xmin - center + 0.5) * ss)
        total = 0.0
        for v in w:
            total += v
        if total != 0.0:
            w = w / total
        taps[i, :n], taps[i, n:] = np.arange(xmin, xmin + n), xmin
        weights[i, :n] = w
    return taps, weights


def _resample_axis(x: np.ndarray, axis: int, out_size: int, method: str) -> np.ndarray:
    """One pass of PIL's separable resample along ``axis`` of f32 ``x``:
    each output the f64 sum, tap by tap in order, of f32 inputs times f64
    weights, stored f32."""
    taps, weights = resample_coeffs(x.shape[axis], out_size, method)
    xm = np.ascontiguousarray(np.moveaxis(x, axis, 0))  # a tap gathers whole rows
    acc = np.zeros((out_size,) + xm.shape[1:], np.float64)
    for j in range(taps.shape[1]):
        acc += xm[taps[:, j]] * weights[:, j].reshape((out_size,) + (1,) * (xm.ndim - 1))
    return np.moveaxis(acc.astype(np.float32), 0, axis)


RESIZE_CHUNK = 64  # images resampled together


def pil_resize(images: np.ndarray, h: int, w: int, method: str) -> np.ndarray:
    """(N, H, W, C) -> (N, h, w, C) f32: what PIL's ``Image.resize((w, h),
    BILINEAR or BICUBIC)`` gives on each image's mode-"F" planes (the JAX
    package's ``_pil_resize``; antialiased like ``tf.image.resize``), for
    every image and channel at once: the horizontal pass, stored f32, then
    the vertical; an axis whose size stays is not resampled."""
    images = images.astype(np.float32, copy=False)
    out = np.empty((len(images), h, w, images.shape[-1]), np.float32)
    for s in range(0, len(images), RESIZE_CHUNK):
        y = images[s: s + RESIZE_CHUNK]
        if w != y.shape[2]:
            y = _resample_axis(y, 2, w, method)
        if h != y.shape[1]:
            y = _resample_axis(y, 1, h, method)
        out[s: s + RESIZE_CHUNK] = y
    return out


def _central_crop(images: np.ndarray, size: int) -> np.ndarray:
    """Centre crop to (size, size) (reference central_crop)."""
    h, w = images.shape[1], images.shape[2]
    top, left = (h - size) // 2, (w - size) // 2
    return images[:, top: top + size, left: left + size]


def _crop_resize(images: np.ndarray, resolution: int) -> np.ndarray:
    """Square centre crop to min(h, w), bicubic resize, rounded and clipped
    to uint8 (reference crop_resize)."""
    crop = min(images.shape[1], images.shape[2])
    out = pil_resize(_central_crop(images, crop).astype(np.float32), resolution, resolution,
                     "bicubic")
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _resize_small(images: np.ndarray, resolution: int) -> np.ndarray:
    """Bilinear shrink of the short side to ``resolution`` (reference
    resize_small); f32 on the input's scale."""
    h, w = images.shape[1], images.shape[2]
    ratio = resolution / min(h, w)
    return pil_resize(images.astype(np.float32), int(round(h * ratio)), int(round(w * ratio)),
                      "bilinear")


def preprocess_corpus(name: str, images: np.ndarray, size: int) -> np.ndarray:
    """Float32 images in [0, 1] at ``size``, dispatched by the corpus name
    as the JAX package dispatches (``pipelines.py:107-162``, after the
    reference's datasets.py:107-154)."""
    name = name.lower().split("_")[0].split("/")[0]
    if name in ("cifar10", "svhn"):
        imgs = _to_unit(images)
        if imgs.shape[1] != size or imgs.shape[2] != size:
            imgs = pil_resize(imgs, size, size, "bilinear")
        return np.clip(imgs, 0.0, 1.0)
    if name == "celeba":
        h_in, w_in = images.shape[1], images.shape[2]
        if h_in == size and w_in == size:  # stored at the target size
            return np.clip(_to_unit(images), 0.0, 1.0)
        if h_in < 140 or w_in < 140:
            raise ValueError(
                f"celeba corpus images are {h_in}x{w_in}; the reference "
                "pipeline center-crops 140x140 (datasets.py:131-136)")
        imgs = _to_unit(_central_crop(images, 140))
        if imgs.shape[1] != size:
            imgs = np.clip(pil_resize(imgs, size, size, "bilinear"), 0.0, 1.0)
        return imgs
    if name == "lsun":
        if size == 128:  # the short side first, then the crop
            imgs = _central_crop(_resize_small(images, size), size)
            return np.clip(imgs / (255.0 if images.dtype == np.uint8 else 1.0), 0.0, 1.0)
        # square crop, bicubic, uint8 rounding before the /255
        return _crop_resize(images, size).astype(np.float32) / 255.0
    if name in ("ffhq", "celebahq"):  # the records hold the stored size
        return _to_unit(images)
    imgs = _to_unit(images)
    if imgs.shape[1] != size or imgs.shape[2] != size:
        imgs = np.clip(pil_resize(imgs, size, size, "bilinear"), 0.0, 1.0)
    return imgs


# ---------------------------------------------------------------------------
# TFRecord / tf.train.Example codec (``pipelines.py:177-302``)
# ---------------------------------------------------------------------------
#
# FFHQ and CelebA-HQ ship as TFRecords of tf.train.Example protos with the
# features {'shape': int64[3], 'data': bytes} holding raw CHW uint8 pixels.
# A TFRecord frame is [len: u64le][crc(len): u32][payload][crc(payload): u32];
# an Example is nested length-delimited protobuf messages.


def iter_tfrecords(path: str | Path):
    """The raw record payloads of a TFRecord file (CRCs skipped)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            f.read(4)  # the payload's crc
            yield payload


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_proto_fields(buf: bytes):
    """(field number, wire type, value) over a protobuf message body."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos: pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos: pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_example(payload: bytes) -> dict:
    """A tf.train.Example as {name: bytes | list[int]} (its BytesList and
    Int64List features, packed or not)."""
    out = {}
    for f_ex, _, features_buf in _iter_proto_fields(payload):
        if f_ex != 1:  # Example.features
            continue
        for f_fs, _, entry in _iter_proto_fields(features_buf):
            if f_fs != 1:  # a Features.feature map entry
                continue
            key, feature = None, b""
            for f_kv, _, v in _iter_proto_fields(entry):
                if f_kv == 1:
                    key = v.decode()
                elif f_kv == 2:
                    feature = v
            for f_kind, _, kind_buf in _iter_proto_fields(feature):
                if f_kind == 1:  # BytesList
                    for f_b, _, b in _iter_proto_fields(kind_buf):
                        if f_b == 1:
                            out[key] = b
                elif f_kind == 3:  # Int64List
                    vals = []
                    for _, wire, v in _iter_proto_fields(kind_buf):
                        if wire == 0:
                            vals.append(v)
                        elif wire == 2:  # packed
                            p = 0
                            while p < len(v):
                                x, p = _read_varint(v, p)
                                vals.append(x)
                    out[key] = vals
    return out


def load_tfrecord_images(path: str | Path, limit: int | None = None) -> np.ndarray:
    """The FFHQ / CelebA-HQ records as NHWC uint8: each record's raw CHW
    bytes reshaped to its 'shape' and transposed (reference
    datasets.py:166-172)."""
    images = []
    for payload in iter_tfrecords(path):
        ex = parse_example(payload)
        shape = [int(s) for s in ex["shape"]]
        images.append(np.frombuffer(ex["data"], dtype=np.uint8).reshape(shape).transpose(1, 2, 0))
        if limit is not None and len(images) >= limit:
            break
    if not images:
        raise ValueError(f"no records in {path}")
    return np.stack(images)


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def write_tfrecord_images(path: str | Path, images: np.ndarray):
    """NHWC uint8 images in the reference's TFRecord layout, the JAX
    package's bytes: a packed int64 'shape' (C, H, W) and the raw CHW
    'data', CRC fields zeroed (the readers skip them)."""
    with open(path, "wb") as f:
        for img in images:
            chw = np.ascontiguousarray(img.transpose(2, 0, 1))
            feat_shape = _ld(3, _ld(1, b"".join(_varint(s) for s in chw.shape)))
            feat_data = _ld(1, _ld(1, chw.tobytes()))
            payload = (_ld(1, _ld(1, _ld(1, b"shape") + _ld(2, feat_shape)))
                       + _ld(1, _ld(1, _ld(1, b"data") + _ld(2, feat_data))))
            f.write(struct.pack("<Q", len(payload)) + b"\0" * 4)
            f.write(payload + b"\0" * 4)


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
    if name in ("ffhq", "celebahq"):  # one TFRecord file, both splits
        rec = str(config.data.tfrecords_path or "")
        if rec and Path(rec).exists():
            return load_tfrecord_images(rec)
        return None
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
        files = (sorted(p for p in d.rglob("*") if p.suffix.lower() in IMAGE_SUFFIXES)
                 if d.is_dir() else [])
        if files:  # an image folder, decoded as the JAX package decodes it
            try:
                from PIL import Image  # image folders alone need PIL: imported here
            except ImportError as e:
                raise ImportError(
                    f"{d} is an image folder: decoding PNG / JPEG / WebP needs PIL; without "
                    "it, store the images as <name>_train.npz ('images', uint8 NHWC)") from e
            return np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
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


def _process_shard(images: np.ndarray, pidx: int, nproc: int) -> np.ndarray:
    """Each process reads a disjoint slice of the corpus, every nproc-th
    image from its index (``gddim_tpu/data/pipelines.py:523-528``)."""
    return images if nproc <= 1 else images[pidx::nproc]


def get_dataset(config, additional_dim=None, uniform_dequantization=False, evaluation=False,
                prefetch=True, shard: tuple[int, int] | None = None):
    """(train_iter, eval_iter) over the configured corpus.

    additional_dim: n_jitted_steps (a leading axis of the batches) or None.
    evaluation=True: both iterators one epoch long, at eval.batch_size.
    prefetch: each iterator makes its batches on a thread of its own
    (``ArrayDataset.close`` stops it).
    shard: (index, count) of this process's share of the batch, by default
    (its rank, the process count): each share reads its slice of the
    corpus (``_process_shard``) in batches of batch_size // count, its order
    seeded with config.seed + index, as the JAX package's per-host batches
    (``pipelines.py:543-566``). The ranks of one model group (channel TP)
    pass the same index.
    """
    from gddim_torch.parallel.multihost import process_count, process_index

    pidx, nproc = shard if shard is not None else (process_index(), process_count())
    batch_size = config.training.batch_size if not evaluation else config.eval.batch_size
    if batch_size % nproc:
        raise ValueError(f"batch of {batch_size} does not split over {nproc} processes")
    batch_size //= nproc
    batch_dims = (additional_dim, batch_size) if additional_dim else (batch_size,)
    flat = int(np.prod(batch_dims)) * nproc  # every share must hold a batch
    num_epochs = 1 if evaluation else None
    name = config.data.dataset.lower()
    if "ps" in name:
        # the JAX package draws the corpus unseeded; the port from config.seed
        raw = _process_shard(pointset_corpus(np.random.default_rng(config.seed)), pidx, nproc)
        train = ArrayDataset(raw, batch_dims, seed=config.seed + pidx, evaluation=evaluation,
                             num_epochs=num_epochs, prefetch=prefetch)
        eval_ds = ArrayDataset(raw, batch_dims, seed=config.seed + pidx + 1, evaluation=True,
                               num_epochs=num_epochs, prefetch=prefetch)
        return train, eval_ds

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
        if name in ("ffhq", "celebahq"):  # the same records for both splits
            eval_images = train_images
        elif (eval_images := _find_corpus(config, train=False)) is None:
            train_images, eval_images = _split(train_images, name, flat)
        shared = eval_images is train_images
        size = config.data.image_size
        train_images = preprocess_corpus(name, train_images, size)
        eval_images = train_images if shared else preprocess_corpus(name, eval_images, size)
        if config.data.is_partial:
            train_images = train_images[: max(len(train_images) // 1000, 1)]

    train = ArrayDataset(_process_shard(train_images, pidx, nproc), batch_dims,
                         seed=config.seed + pidx, random_flip=config.data.random_flip,
                         uniform_dequantization=uniform_dequantization, evaluation=evaluation,
                         num_epochs=num_epochs, prefetch=prefetch)
    eval_ds = ArrayDataset(_process_shard(eval_images, pidx, nproc), batch_dims,
                           seed=config.seed + pidx + 1,
                           uniform_dequantization=uniform_dequantization, evaluation=True,
                           num_epochs=num_epochs, prefetch=prefetch)
    return train, eval_ds
