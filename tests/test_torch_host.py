"""Host layer of the PyTorch port against the JAX package: the deis
coefficient stack, time grid and denoise constants (bit for bit), the config,
the content-keyed cache and the 2x2 algebra."""

import dataclasses

import numpy as np
import pytest
import torch

from gddim_torch.configs import get_config
from gddim_torch.math import linalg2 as tl2
from gddim_torch.math.cld import CLD
from gddim_torch.samplers import coefs as tcoefs
from gddim_torch.utils import io as tio
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.samplers import coefs as jcoefs
from gddim_tpu.utils import io as jio


@pytest.fixture
def fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("GDDIM_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path / "torch"))
    return tmp_path


def _bench_config():
    """cld/accr_dcifar10 with the overrides of bench.py:45-57 (bf16 fused)."""
    cfg = jax_get_config("cld/accr_dcifar10")
    cfg.sampling.method = "deis"
    cfg.sampling.deis_order = 2
    cfg.sampling.noise_removal = True
    cfg.sampling.nfe = 50
    cfg.sampling.ts_order = 2
    cfg.model.dtype = "bfloat16"
    cfg.model.conv_impl = "fused"
    return cfg


def test_deis_bundle_matches_jax_bit_for_bit(fresh_caches):
    cfg = get_config("cld/accr_dcifar10")
    s = cfg.sampling
    args = (int(s.nfe), int(s.deis_order), float(s.ts_order), bool(s.noise_removal))
    got = tcoefs.deis_bundle(CLD.from_config(cfg).host(), *args)
    want = jcoefs.deis_bundle(JaxCLD.from_config(_bench_config()).host(), *args)
    assert got.stack.shape == (49, 5, 2, 2)
    np.testing.assert_array_equal(got.stack, want.stack)
    np.testing.assert_array_equal(got.rev_ts, want.rev_ts)
    assert (got.hist_len, got.nfe) == (want.hist_len, want.nfe) == (3, 50)
    for f in dataclasses.fields(want.denoise):
        np.testing.assert_array_equal(getattr(got.denoise, f.name), getattr(want.denoise, f.name))
    # each package wrote its own cache file, under its own name
    assert list((fresh_caches / "torch").glob("gdt_cld_deis_*.npz"))
    assert not list((fresh_caches / "torch").glob("cld_deis_*.npz"))
    # a second call reads the cache and returns the same stack
    again = tcoefs.deis_bundle(CLD.from_config(cfg).host(), *args)
    np.testing.assert_array_equal(again.stack, got.stack)


# fields of the port's config that the JAX package's config has not: the
# whole-transition kernel's setting (GDDIM_TRANSITION_IMPL, an environment
# variable there), and data.is_partial, which only the JAX blur configs
# set (its pipeline reads it with a default of False, the port's value)
PORT_ONLY_FIELDS = {("model", "transition_impl"), ("data", "is_partial")}


def test_config_fields_match_jax_with_bench_overrides():
    want = _bench_config()
    got = get_config("cld/accr_dcifar10")
    for section in ("data", "model", "sampling"):
        g = getattr(got, section)
        for f in dataclasses.fields(g):
            if (section, f.name) in PORT_ONLY_FIELDS:
                assert f.name not in getattr(want, section)
                continue
            ours = getattr(g, f.name)
            theirs = getattr(getattr(want, section), f.name)
            if isinstance(theirs, (list, tuple)):
                theirs, ours = tuple(theirs), tuple(ours)
            assert ours == theirs, (section, f.name, ours, theirs)
    assert got.sde == want.sde and got.seed == want.seed
    with pytest.raises(ValueError):
        get_config("cld/nope")


def test_cache_never_reads_jax_tables(fresh_caches, monkeypatch):
    shared = fresh_caches / "shared"
    monkeypatch.setenv("GDDIM_CACHE_DIR", str(shared))
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(shared))
    key = jio.content_key("x", 1.0, np.arange(3.0))
    assert key == tio.content_key("x", 1.0, np.arange(3.0))
    jio.save_npz_cache("tbl", key, a=np.ones(2))
    assert tio.load_npz_cache("tbl", key) is None
    tio.save_npz_cache("tbl", key, a=np.zeros(2))
    np.testing.assert_array_equal(jio.load_npz_cache("tbl", key)["a"], np.ones(2))
    np.testing.assert_array_equal(tio.load_npz_cache("tbl", key)["a"], np.zeros(2))


def test_prior_sampling_statistics():
    sde = CLD.from_config(get_config("cld/accr_dcifar10"))
    g = torch.Generator().manual_seed(0)
    u = sde.prior_sampling(g, (64, 8, 8, 3), "cpu")
    assert u.shape == (64, 8, 8, 3, 2) and u.dtype == torch.float32
    assert abs(u[..., 0].std().item() - 1.0) < 0.03
    assert abs(u[..., 1].std().item() - 0.5) < 0.015  # 1/sqrt(m_inv), m_inv = 4


def test_2x2_algebra_matches_numpy():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((5, 2, 2))
    s = rng.standard_normal((5, 3, 4, 2))
    got = tl2.bmm(torch.from_numpy(m), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, np.einsum("bij,b...j->b...i", m, s), rtol=1e-12)
    got = tl2.sbmm(m[0], torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, np.einsum("ij,...j->...i", m[0], s), rtol=1e-12)
    np.testing.assert_allclose(tl2.inv2(m) @ m, np.broadcast_to(np.eye(2), m.shape),
                               atol=1e-10)
    np.testing.assert_allclose(tl2.inv2(torch.from_numpy(m)).numpy(), tl2.inv2(m))
    cov = m @ m.swapaxes(-1, -2)
    a = tl2.psd_sqrt_factor(cov)
    np.testing.assert_allclose(a @ a.swapaxes(-1, -2), cov, atol=1e-10)
