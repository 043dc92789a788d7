"""The port's input pipelines against the JAX package's, on the CPU: CIFAR-10
fixtures in its own file formats (the python pickles and the npz), the
synthetic corpus, the eval iterator and the held-out split, batch for batch,
bit for bit."""

import pickle

import numpy as np
import pytest

from gddim_torch.configs import get_config, train_config
from gddim_torch.data import pipelines as tp
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.data import pipelines as jp


def write_cifar_pickles(root, n_train: int = 40, n_test: int = 40, seed: int = 0):
    """CIFAR-10's python layout: data_batch_1..5 and test_batch, each a
    pickled {b'data': (n, 3072) uint8 CHW rows, b'labels': [...]}."""
    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", n_train) for i in range(1, 6)] + [("test_batch", n_test)]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, n).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f, protocol=2)
    return root


def write_cifar_npz(root, n_train: int = 200, n_test: int = 40, size: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    np.savez(root / "cifar10_train.npz",
             images=rng.integers(0, 256, (n_train, size, size, 3), dtype=np.uint8))
    if n_test:
        np.savez(root / "cifar10_test.npz",
                 images=rng.integers(0, 256, (n_test, size, size, 3), dtype=np.uint8))
    return root


def configs(data_dir="", batch=8, eval_batch=8, flip=True, deq=False, seed=42, size=32):
    """The port's and the JAX package's accr configs with the same data fields."""
    cfg, jcfg = train_config("cld/accr_dcifar10"), jax_get_config("cld/accr_dcifar10")
    for c in (cfg, jcfg):
        c.data.data_dir, c.data.synthetic = str(data_dir), False
        c.data.random_flip, c.data.uniform_dequantization = flip, deq
        c.data.image_size = size
        c.training.batch_size, c.eval.batch_size, c.seed = batch, eval_batch, seed
    return cfg, jcfg


def assert_same_stream(got, want, n: int):
    for i in range(n):
        a, b = next(got)["image"], next(want)["image"]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


@pytest.mark.parametrize("fmt", ["pickle", "npz"])
@pytest.mark.parametrize("flip,deq", [(True, True), (False, True), (True, False)])
def test_cifar_train_batches_match_jax(tmp_path, fmt, flip, deq):
    """Two epochs of training batches with the n_jitted_steps axis: the same
    permutations, flips and dequantization noise, bit for bit."""
    root = (write_cifar_pickles(tmp_path) if fmt == "pickle" else write_cifar_npz(tmp_path))
    cfg, jcfg = configs(root, flip=flip, deq=deq)
    got, _ = tp.get_dataset(cfg, additional_dim=2, uniform_dequantization=deq)
    want, _ = jp.get_dataset(jcfg, additional_dim=2, uniform_dequantization=deq)
    # 200 images, 16 a batch: 12 batches an epoch, the remainder dropped
    assert_same_stream(got, want, 25)


def test_cifar_corpora_match_jax(tmp_path):
    root = write_cifar_pickles(tmp_path)
    cfg, jcfg = configs(root)
    for train in (True, False):
        np.testing.assert_array_equal(tp._find_corpus(cfg, train), jp._find_corpus(jcfg, train))
    assert tp._find_corpus(cfg, True).shape == (200, 32, 32, 3)


def test_eval_iterator_is_one_epoch(tmp_path):
    """evaluation=True: both iterators one pass at eval.batch_size, the
    remainder dropped, then StopIteration; the same batches as JAX's."""
    root = write_cifar_npz(tmp_path, n_train=50, n_test=30)
    cfg, jcfg = configs(root, eval_batch=8, deq=True)
    got_train, got_eval = tp.get_dataset(cfg, evaluation=True, uniform_dequantization=True)
    want_train, want_eval = jp.get_dataset(jcfg, evaluation=True, uniform_dequantization=True)
    for got, want, n in ((got_train, want_train, 6), (got_eval, want_eval, 3)):
        got_batches, want_batches = list(got), list(want)
        assert len(got_batches) == len(want_batches) == n
        for a, b in zip(got_batches, want_batches):
            np.testing.assert_array_equal(a["image"], b["image"])
        with pytest.raises(StopIteration):
            next(got)
    # the training iterator of a training run repeats; its eval iterator too
    train, eval_ds = tp.get_dataset(cfg)
    assert len([next(eval_ds) for _ in range(10)]) == 10


@pytest.mark.parametrize("n_train", [100, 20])
def test_held_out_split_and_fallback(tmp_path, n_train):
    """No test corpus: the trailing 10% of train is held out when both parts
    hold a batch (100 images); else eval reuses train (20). As JAX's."""
    root = tmp_path / "d"
    root.mkdir()
    imgs = (np.arange(n_train, dtype=np.uint8)[:, None, None, None]
            * np.ones((1, 32, 32, 3), np.uint8))
    np.savez(root / "cifar10_train.npz", images=imgs)
    cfg, jcfg = configs(root, batch=4, eval_batch=4, flip=False)
    got_train, got_eval = tp.get_dataset(cfg)
    want_train, want_eval = jp.get_dataset(jcfg)
    assert_same_stream(got_train, want_train, 30)
    assert_same_stream(got_eval, want_eval, 10)
    eval_vals = {int(round(v * 255)) for _ in range(5)
                 for v in next(tp.get_dataset(cfg)[1])["image"][:, 0, 0, 0]}
    if n_train == 100:
        assert eval_vals <= set(range(90, 100))  # held out: the trailing 10
    else:
        assert eval_vals <= set(range(20))


@pytest.mark.parametrize("partial", [False, True])
def test_synthetic_corpus_matches_jax(partial):
    cfg, jcfg = configs("", batch=4)
    jcfg.data.synthetic = cfg.data.synthetic = True
    cfg.data.is_partial = partial
    with jcfg.unlocked():
        jcfg.data.is_partial = partial
    got_train, got_eval = tp.get_dataset(cfg, additional_dim=3)
    want_train, want_eval = jp.get_dataset(jcfg, additional_dim=3)
    assert_same_stream(got_train, want_train, 4)
    assert_same_stream(got_eval, want_eval, 2)
    np.testing.assert_array_equal(tp._synthetic_images(cfg, 16, 5),
                                  jp._synthetic_images(jcfg, 16, 5))


def test_scalers_and_shape_match_jax():
    cfg, jcfg = get_config("cld/accr_dcifar10"), jax_get_config("cld/accr_dcifar10")
    x = np.linspace(0, 1, 11, dtype=np.float32)
    for centered in (True, False):
        cfg.data.centered = jcfg.data.centered = centered
        np.testing.assert_array_equal(tp.get_data_scaler(cfg)(x), jp.get_data_scaler(jcfg)(x))
        np.testing.assert_array_equal(tp.get_data_inverse_scaler(cfg)(x),
                                      jp.get_data_inverse_scaler(jcfg)(x))
    assert tp.get_data_shape(cfg) == jp.get_data_shape(jcfg) == (32, 32, 3)


def test_preprocessing_matches_jax_and_unported_paths_raise(tmp_path):
    """Preprocessing at the stored size, a resize, a corpus stored at
    another size and an FFHQ TFRecord all as the JAX package gives them,
    bit for bit; a missing record raises (image folders:
    tests/test_torch_corpora.py)."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    floats = rng.uniform(-0.5, 1.5, (4, 16, 16, 3)).astype(np.float32)
    for name, arr in (("cifar10", imgs), ("svhn", floats), ("celeba", imgs), ("mydata", floats)):
        np.testing.assert_array_equal(tp.preprocess_corpus(name, arr, 16),
                                      jp.preprocess_corpus(name, arr, 16))
    # a resize (the JAX package's runs PIL; the port's is its numpy twin)
    np.testing.assert_array_equal(tp.preprocess_corpus("cifar10", imgs, 32),
                                  jp.preprocess_corpus("cifar10", imgs, 32))
    cfg, jcfg = configs(write_cifar_npz(tmp_path / "c", size=16), size=32)
    assert_same_stream(tp.get_dataset(cfg, prefetch=False)[0], jp.get_dataset(jcfg)[0], 2)
    # an FFHQ TFRecord (data.tfrecords_path) written by the JAX writer
    jp.write_tfrecord_images(tmp_path / "ffhq.tfrecords",
                             rng.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8))
    for c in (cfg, jcfg):
        c.data.dataset, c.data.tfrecords_path = "FFHQ", str(tmp_path / "ffhq.tfrecords")
    assert_same_stream(tp.get_dataset(cfg, prefetch=False)[0], jp.get_dataset(jcfg)[0], 2)
    cfg.data.tfrecords_path = str(tmp_path / "missing.tfrecords")
    with pytest.raises(FileNotFoundError):
        tp.get_dataset(cfg)
    cfg.data.dataset = "olympic_ps"  # ported: the point set (tests/test_torch_points.py)
    train, _ = tp.get_dataset(cfg, prefetch=False)
    assert next(train)["image"].shape == (cfg.training.batch_size, 2)


def test_prefetch_thread_starts_lazily_and_passes_errors():
    images = np.arange(25, dtype=np.uint8).reshape(25, 1, 1, 1)
    ds = tp.ArrayDataset(images, (10,), num_epochs=1)
    assert ds._iter is None  # no thread until the first batch
    assert len(list(ds)) == 2 and ds._iter is not None

    def boom():
        raise RuntimeError("corpus read failed")

    it = tp._Prefetcher(boom)
    with pytest.raises(RuntimeError, match="corpus read failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
