"""The port's FID / IS / KID, feature extractors and InceptionV3 against the
JAX package's ``gddim_tpu.evals``, on the CPU."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import run_lib
from gddim_torch.configs import get_config
from gddim_torch.evals import features, fid, inception
from gddim_tpu.evals import features as j_features
from gddim_tpu.evals import fid as j_fid
from gddim_tpu.evals import inception as j_inception

FEATURE_REL = 1e-5
INCEPTION_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run many small ops, which a full thread
    pool per test worker slows many times over when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_scores_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((300, 16))
    b = rng.standard_normal((250, 16)) * 1.1 + 0.2
    logits = rng.standard_normal((64, 10)) * 3
    mu1, s1 = fid.activation_stats(a)
    mu2, s2 = fid.activation_stats(b)
    for got, want in ((mu1, j_fid.activation_stats(a)[0]), (s2, j_fid.activation_stats(b)[1])):
        np.testing.assert_array_equal(got, want)
    assert fid.frechet_distance(mu1, s1, mu2, s2) == j_fid.frechet_distance(mu1, s1, mu2, s2)
    assert fid.inception_score(logits) == j_fid.inception_score(logits)
    for block in (1024, 100):
        assert (fid.kernel_distance(a, b, max_block_size=block)
                == j_fid.kernel_distance(a, b, max_block_size=block))
    # the stats files: the port's written, the JAX package's read, and back
    fid.save_dataset_stats(tmp_path / "s.npz", mu1, s1, pools=a)
    for load in (fid.load_dataset_stats, j_fid.load_dataset_stats):
        mu, sigma = load(tmp_path / "s.npz")
        np.testing.assert_array_equal(mu, mu1)
        np.testing.assert_array_equal(sigma, s1)
    np.savez(tmp_path / "pools_only.npz", pool_3=b)
    np.testing.assert_array_equal(fid.load_dataset_stats(tmp_path / "pools_only.npz")[1], s2)


def test_proxy_extractor_matches_jax():
    cfg = get_config("cld/accr_dcifar10")
    imgs = np.random.default_rng(1).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    ex = features.get_feature_extractor(cfg, "cpu")
    assert (ex.name, ex.feature_dim, ex.logits_dim) == ("proxy", 256, 100)
    want = j_features._proxy_extractor(32, 3).apply_fn(jnp.asarray(imgs))
    pools, logits = features.run_features(ex, imgs, batch_size=4)  # two batches
    assert pools.shape == (6, 256) and logits.shape == (6, 100)
    assert rel(pools, want["pool_3"]) <= FEATURE_REL
    assert rel(logits, want["logits"]) <= FEATURE_REL
    # odd sizes take XLA's SAME padding (the extra pixel after)
    odd = imgs[:2, :15, :13]
    want = j_features._proxy_extractor(15, 3).apply_fn(jnp.asarray(odd))
    assert rel(features.run_features(ex, odd)[0], want["pool_3"]) <= FEATURE_REL


@pytest.mark.parametrize("h,w,size", [(32, 32, 299), (5, 7, 12), (8, 8, 3)])
def test_tf1_resize_matches_jax(h, w, size):
    x = np.random.default_rng(2).standard_normal((2, h, w, 3)).astype(np.float32)
    got = inception.tf1_resize_bilinear(torch.from_numpy(x), size).numpy()
    want = np.asarray(j_inception._tf1_resize_bilinear(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pools_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 9, 7, 4)).astype(np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    back = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    for got, want in ((inception.avgpool3(nchw, True), j_inception._avgpool3_excl),
                      (inception.avgpool3(nchw, False), j_inception._avgpool3),
                      (inception.maxpool3s1(nchw), j_inception._maxpool3s1),
                      (inception.maxpool3s2(nchw), j_inception._maxpool3s2)):
        np.testing.assert_allclose(back(got), np.asarray(want(jnp.asarray(x))), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("mode,n_classes,batch", [("fid2015", 1008, 2), ("torchvision", 1000, 1)])
def test_inception_matches_jax(mode, n_classes, batch):
    """InceptionV3 on random_state_dict (the same draws in both packages):
    pool_3 and logits within 1e-4 of the JAX InceptionV3."""
    sd = inception.random_state_dict(np.random.default_rng(7), n_classes=n_classes)
    jsd = j_inception.random_state_dict(np.random.default_rng(7), n_classes=n_classes)
    assert all(np.array_equal(sd[k], jsd[k]) for k in jsd) and set(sd) == set(jsd)
    imgs = np.random.default_rng(8).integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8)
    net = inception.InceptionV3(sd, mode=mode).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(imgs))
    want = jax.jit(j_inception.InceptionV3(jsd, mode=mode).__call__)(jnp.asarray(imgs))
    assert got["pool_3"].shape == (batch, 2048) and got["logits"].shape == (batch, n_classes)
    for k in ("pool_3", "logits"):
        assert rel(got[k], want[k]) <= INCEPTION_REL, k


def test_inception_extractor_loads_a_weights_file(tmp_path):
    sd = inception.random_state_dict(np.random.default_rng(9), n_classes=1008)
    path = tmp_path / "inception.npz"
    np.savez(path, **sd)
    cfg = get_config("cld/accr_dcifar10")
    cfg.eval.inception_weights = str(path)
    ex = features.get_feature_extractor(cfg, "cpu")
    assert (ex.name, ex.feature_dim, ex.logits_dim) == ("inception_fid2015", 2048, 1008)
    imgs = np.random.default_rng(10).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    pools, logits = features.run_features(ex, imgs)
    assert pools.shape == (1, 2048) and np.isfinite(logits).all()
    cfg.eval.inception_weights = str(tmp_path / "absent.npz")
    with pytest.raises(FileNotFoundError):
        features.get_feature_extractor(cfg, "cpu")


def test_extractors_run_on_the_card_unless_asked():
    """The scoring entry points default to the card, as run_lib's do; the
    CPU is an explicit choice."""
    for fn in (features.get_feature_extractor, inception.load_inception_extractor,
               run_lib.check_fid, run_lib.fid_stats, run_lib.evaluate):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
