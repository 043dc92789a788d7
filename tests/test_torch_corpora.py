"""The corpora of ``gddim_torch/data/pipelines.py`` against the JAX
package's on the CPU: the numpy resample against PIL's (which the JAX
package calls, and which this box has), every ``preprocess_corpus`` rule,
the TFRecord codec both ways, ``get_dataset`` batches of CelebA stored at
218x178 and of FFHQ from records, and an image folder decoded by PIL (and
refused without it), on corpora made from a seed."""

import sys

import numpy as np
import pytest

from gddim_torch.configs import train_config
from gddim_torch.data import pipelines as tp
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.data import pipelines as jp

FLOAT_TOL = 1e-6  # [0, 1] floats
UINT8_SHARE = 1e-3  # LSUN's uint8 path: at most one level off on at most 0.1% of pixels


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("hw_in,hw_out", [((218, 178), (64, 64)), ((16, 16), (32, 32)),
                                          ((37, 23), (12, 41)), ((20, 20), (20, 9))])
def test_resample_is_pils(method, hw_in, hw_out):
    """pil_resize against PIL's Image.resize on mode-"F" planes (the JAX
    package's _pil_resize): the same bits, shrinking, growing, both axes
    apart and one axis kept."""
    x = np.random.default_rng(0).uniform(-20, 300, (2,) + hw_in + (3,)).astype(np.float32)
    got = tp.pil_resize(x, *hw_out, method)
    want = jp._pil_resize(x, *hw_out, method)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,shape,size", [
    ("cifar10", (3, 32, 32, 3), 16), ("cifar10", (3, 16, 16, 3), 32), ("svhn", (3, 32, 32, 3), 24),
    ("celeba", (3, 218, 178, 3), 64), ("celeba", (3, 218, 178, 3), 140),
    ("celeba", (3, 64, 64, 3), 64), ("lsun", (3, 150, 200, 3), 128),
    ("lsun_church", (3, 100, 80, 3), 64), ("ffhq", (3, 32, 32, 3), 64),
    ("celebahq", (3, 32, 32, 3), 32), ("mydata", (3, 40, 30, 3), 32)])
def test_preprocess_rules_match_jax(name, shape, size):
    """Every rule of the dispatch, on uint8 and on float corpora."""
    for images in (_uint8(shape, 1), np.random.default_rng(2).uniform(0, 1, shape).astype(
            np.float32)):
        got = tp.preprocess_corpus(name, images, size)
        want = jp.preprocess_corpus(name, images, size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        if name.startswith("lsun") and size != 128:  # rounded to uint8 levels
            levels = np.abs(np.round(got * 255) - np.round(want * 255))
            assert levels.max() <= 1 and (levels > 0).mean() <= UINT8_SHARE
        else:
            assert np.abs(got - want).max() <= FLOAT_TOL


def test_celeba_under_140_raises_as_jax():
    images = _uint8((2, 120, 150, 3), 3)
    with pytest.raises(ValueError) as got:
        tp.preprocess_corpus("celeba", images, 64)
    with pytest.raises(ValueError) as want:
        jp.preprocess_corpus("celeba", images, 64)
    assert str(got.value) == str(want.value)


def test_tfrecords_both_ways_bit_for_bit(tmp_path):
    """Records written by the JAX writer read by the port and the reverse;
    both writers give the same bytes; the Example parser on each record."""
    images = _uint8((5, 12, 10, 3), 4)
    jp.write_tfrecord_images(tmp_path / "j.tfrecords", images)
    tp.write_tfrecord_images(tmp_path / "t.tfrecords", images)
    assert (tmp_path / "j.tfrecords").read_bytes() == (tmp_path / "t.tfrecords").read_bytes()
    got = tp.load_tfrecord_images(tmp_path / "j.tfrecords")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, images)
    np.testing.assert_array_equal(jp.load_tfrecord_images(tmp_path / "t.tfrecords"), images)
    np.testing.assert_array_equal(tp.load_tfrecord_images(tmp_path / "t.tfrecords", limit=2),
                                  images[:2])
    for a, b in zip(tp.iter_tfrecords(tmp_path / "t.tfrecords"),
                    jp.iter_tfrecords(tmp_path / "j.tfrecords")):
        assert tp.parse_example(a) == jp.parse_example(b)
    (tmp_path / "empty.tfrecords").write_bytes(b"")
    with pytest.raises(ValueError):
        tp.load_tfrecord_images(tmp_path / "empty.tfrecords")


def _configs(data_dir, dataset, size, **data):
    cfg, jcfg = train_config("cld/ddpmpp_celeba"), jax_get_config("cld/ddpmpp_celeba")
    for c in (cfg, jcfg):
        c.data.data_dir, c.data.synthetic, c.data.dataset = str(data_dir), False, dataset
        c.data.image_size = size
        c.training.batch_size, c.eval.batch_size, c.seed = 4, 4, 7
        for k, v in data.items():
            setattr(c.data, k, v)
    return cfg, jcfg


def _same_batches(cfg, jcfg, n: int = 3, **kw):
    for got_it, want_it in zip(tp.get_dataset(cfg, prefetch=False, **kw),
                               jp.get_dataset(jcfg, **kw)):
        for i in range(n):
            a, b = next(got_it)["image"], next(want_it)["image"]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


def test_celeba_at_218x178_batches_bit_for_bit(tmp_path):
    """cld/ddpmpp_celeba on a CelebA-shaped corpus (celeba_{train,
    validation}.npz at the stored 218x178): crop 140, bilinear to 64, the
    training and eval streams and the evaluation iterators."""
    np.savez(tmp_path / "celeba_train.npz", images=_uint8((12, 218, 178, 3), 5))
    np.savez(tmp_path / "celeba_validation.npz", images=_uint8((8, 218, 178, 3), 6))
    cfg, jcfg = _configs(tmp_path, "CELEBA", 64)
    _same_batches(cfg, jcfg)
    _same_batches(cfg, jcfg, n=2, evaluation=True, additional_dim=1)


def test_ffhq_records_batches_bit_for_bit(tmp_path):
    """FFHQ from a TFRecord file (data.tfrecords_path): no resize, one
    corpus for both splits; an empty or missing path raises
    FileNotFoundError as the JAX package does."""
    rec = tmp_path / "ffhq.tfrecords"
    jp.write_tfrecord_images(rec, _uint8((12, 32, 32, 3), 8))
    cfg, jcfg = _configs(tmp_path, "FFHQ", 32, tfrecords_path=str(rec), uniform_dequantization=True)
    _same_batches(cfg, jcfg, uniform_dequantization=True)
    for path in ("", str(tmp_path / "missing.tfrecords")):
        cfg.data.tfrecords_path = jcfg.data.tfrecords_path = path
        with pytest.raises(FileNotFoundError):
            tp.get_dataset(cfg)
        with pytest.raises(FileNotFoundError):
            jp.get_dataset(jcfg)


def _image_folder(root):
    """A nested folder of 16x16 PNG, JPEG and WebP files in RGB, RGBA and L
    modes (upper- and lower-case suffixes) and a file that is no image, drawn
    from a seed."""
    from PIL import Image

    rng = np.random.default_rng(9)
    files = [("0.png", "RGB"), ("a/1.PNG", "RGBA"), ("a/2.jpg", "RGB"), ("a/b/3.jpeg", "L"),
             ("a/b/4.webp", "RGBA"), ("5.WEBP", "RGB"), ("a/6.png", "L"), ("c/7.JPG", "L")]
    for name, mode in files:
        f = root / name
        f.parent.mkdir(parents=True, exist_ok=True)
        shape = (16, 16) + ((len(mode),) if len(mode) > 1 else ())
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(f)
    (root / "a" / "notes.txt").write_text("not an image")
    return len(files)


def test_image_folders_decode_as_jax(tmp_path):
    """An image folder decodes as the JAX package decodes it (PIL, every
    file converted to RGB, sorted over the nested folders), bit for bit, and
    its batches follow."""
    n = _image_folder(tmp_path / "img")
    cfg, jcfg = _configs(tmp_path / "img", "faces", 16)
    got, want = tp._find_corpus(cfg, True), jp._find_corpus(jcfg, True)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (n, 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    _same_batches(cfg, jcfg)


def test_image_folders_without_pil_raise(tmp_path, monkeypatch):
    """Without PIL an image folder raises ImportError, naming the .npz route."""
    _image_folder(tmp_path / "img")
    cfg, _ = _configs(tmp_path / "img", "faces", 16)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="_train.npz"):
        tp.get_dataset(cfg)
