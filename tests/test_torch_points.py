"""The point-set slice (``cld/points``: the Olympic rings and the
``ps_fmlp`` MLP) against the JAX package, on the CPU: the point draws bit
for bit, the config's fields, the data pipeline's corpus and batches, the
MLP with converted weights, a deis-2 NFE=20 sample from the same u0, the
point-set figure, the registry, and the CLI's train and sampling modes."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gddim_torch import cli, convert, run_lib
from gddim_torch.configs import get_config
from gddim_torch.data import pipelines as tp
from gddim_torch.data import pointset as t_ps
from gddim_torch.models import registry
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.mlp import PSFMLP
from gddim_torch.utils import images as t_images
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.data import pipelines as jp
from gddim_tpu.data import pointset as j_ps
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.samplers.factory import build_cld_sampler as jax_build_cld_sampler
from gddim_tpu.utils import images as j_images

# the MLP in f32 in both frameworks: four small products
MLP_REL = 1e-6
# a 20-step deis trajectory of that MLP: the host tables and the f32 steps
SAMPLE_REL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n,noise,seed", [(12800, 0.01, 0), (1000, 0.25, 3), (7, 0.5, 9)])
def test_olympic_points_bit_for_bit(n, noise, seed):
    got = t_ps.olympic_generate_sample(n, noise, np.random.default_rng(seed))
    want = j_ps.olympic_generate_sample(n, noise, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_ps.circle_generate_sample(n, noise, np.random.default_rng(seed)),
                                  j_ps.circle_generate_sample(n, noise, np.random.default_rng(seed)))


def test_points_config_fields_match_jax():
    """Every field the port shares with ``cld/points.py`` has its value,
    the sampling fields included (deis order 2 at NFE=20, not the port's
    image default of NFE=50); ps_fmlp ignores the execution dtype."""
    cfg, jcfg = get_config("cld/points"), jax_get_config("cld/points")
    shared = 0
    for section in ("training", "data", "optim", "sampling"):
        for key, value in vars(getattr(cfg, section)).items():
            if key in getattr(jcfg, section):
                want = getattr(jcfg, section)[key]
                assert value == (tuple(want) if isinstance(want, list) else want), (section, key)
                shared += 1
    for key in ("name", "nf", "num_layers", "fourier_scale", "ema_rate", "nonlinearity",
                "scale_by_sigma"):
        assert getattr(cfg.model, key) == jcfg.model[key], key
    assert shared >= 30
    assert (cfg.sampling.method, cfg.sampling.nfe, cfg.sampling.deis_order) == ("deis", 20, 2)
    assert tp.get_data_shape(cfg) == jp.get_data_shape(jcfg) == (2,)


def test_pointset_pipeline_matches_jax_from_the_same_draw():
    """The corpus from the same rng (the JAX pipeline draws it unseeded, the
    port from config.seed), then the JAX ArrayDataset's batches at its seeds."""
    cfg = get_config("cld/points")
    cfg.seed, cfg.training.batch_size = 5, 64
    raw = j_ps.olympic_generate_sample(12800, noise=0.01, rng=np.random.default_rng(5))
    raw = ((raw - raw.mean(0, keepdims=True)) / raw.std(0, keepdims=True)).astype(np.float32)
    np.testing.assert_array_equal(tp.pointset_corpus(np.random.default_rng(5)), raw)
    train, ev = tp.get_dataset(cfg, additional_dim=3, prefetch=False)
    jtrain = jp.ArrayDataset(raw, (3, 64), seed=5, prefetch=False)
    jev = jp.ArrayDataset(raw, (3, 64), seed=6, evaluation=True, prefetch=False)
    for _ in range(2):
        np.testing.assert_array_equal(next(train)["image"], next(jtrain)["image"])
        np.testing.assert_array_equal(next(ev)["image"], next(jev)["image"])
    assert next(train)["image"].shape == (3, 64, 2)


@pytest.fixture(scope="module")
def points():
    cfg, jcfg = get_config("cld/points"), jax_get_config("cld/points")
    return cfg, jcfg, seeded_params(cfg, 0)


def test_mlp_with_converted_weights_matches_jax(points):
    cfg, jcfg, tree = points
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    labels = rng.uniform(1e-3, 999.0, 16).astype(np.float32)
    jmodel = get_model("ps_fmlp")(config=jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 4)),
                                                jnp.ones((2,))))["params"]
    assert jax.tree.map(lambda s: s.shape, dict(shapes)) == jax.tree.map(np.shape, tree)
    want = jmodel.apply({"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(x),
                        jnp.asarray(labels))
    model = seeded_model(cfg, 0)
    assert isinstance(model, PSFMLP)
    assert sum(p.numel() for p in model.parameters()) == 83_588
    got = model(torch.from_numpy(x), torch.from_numpy(labels))
    assert rel_err(got.detach(), want) <= MLP_REL
    back = convert.state_dict_to_flax(model)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, tree)
    bad = dict(tree)
    bad["Dense_5"] = bad.pop("Dense_4")
    with pytest.raises(ValueError):
        convert.flax_to_state_dict(model, bad)


def test_mlp_runs_f32_whatever_the_dtype(points):
    cfg = points[0]
    assert cfg.model.dtype == "bfloat16"  # the port's execution default, unread by ps_fmlp
    out = seeded_model(cfg, 0)(torch.zeros(3, 4), torch.ones(3))
    assert out.dtype == torch.float32 and out.shape == (3, 4)


def test_deis_sample_matches_jax(points, tmp_path, monkeypatch):
    monkeypatch.setenv("GDDIM_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path / "torch"))
    cfg, jcfg, tree = points
    u0 = np.random.default_rng(4).standard_normal((64, 2, 2)).astype(np.float32)
    x, v, nfe = run_lib.build_sampling_fn(cfg)(None, seeded_model(cfg, 0),
                                                u0=torch.from_numpy(u0))
    sde = JaxCLD.from_config(jcfg)
    sampler = jax_build_cld_sampler(
        jcfg, sde, jax_make_cld_eps_fn(sde, get_model("ps_fmlp")(config=jcfg)), (2,),
        inverse_scaler=lambda a: (a + 1.0) / 2.0)
    jx, jv, jnfe = sampler(jax.random.PRNGKey(0), {"params": jax.tree.map(jnp.asarray, tree)},
                           u0=jnp.asarray(u0))
    assert nfe == jnfe == 20 and x.shape == (64, 2)
    assert rel_err(x, jx) <= SAMPLE_REL
    assert rel_err(v, jv) <= SAMPLE_REL


def test_pointset_figure_matches_jax(tmp_path):
    pts = np.random.default_rng(1).normal(size=(500, 2))
    j_images.save_pointset(pts, tmp_path / "j.png")
    t_images.save_pointset(pts, tmp_path / "t.png")
    want = np.asarray(Image.open(tmp_path / "j.png"))
    got = np.asarray(Image.open(io.BytesIO((tmp_path / "t.png").read_bytes())))
    assert got.shape == want.shape == (260, 260)  # 256 and the grid's padding
    np.testing.assert_array_equal(got, want)


def test_registry_names():
    assert registry.available_models() == ("ncsnpp", "ps_fmlp", "wideresnet_noise_conditional")
    assert registry.get_model("ps_fmlp") is PSFMLP
    with pytest.raises(ValueError):
        registry.get_model("ncsnv2")
    with pytest.raises(ValueError):
        registry.register_model(type("Other", (), {}), name="ps_fmlp")


def test_cli_trains_and_samples_points(tmp_path):
    """A short run of the training loop on the point set (its sample
    figures included), then sampling from its EMA weights: the npz (the
    JAX package's uint8 values and the f32 points) and the figure."""
    run = tmp_path / "run"
    cli.main(["--config", "cld/points", "--mode", "train", "--device", "cpu", "--steps", "20",
              "--batch", "64", "--out", str(run), "--set", "training.n_jitted_steps=10",
              "--set", "training.snapshot_freq_for_sampling=10", "--set",
              "training.snapshot_sampling_batch=128", "--set", "sampling.nfe=5"])
    assert (run / "samples" / "iter_20" / "sample.png").exists()
    cli.main(["--config", "cld/points", "--mode", "sampling", "--device", "cpu", "--batch", "128",
              "--out", str(tmp_path / "smp"), "--weights", str(run / "ema.pt"),
              "--set", "sampling.nfe=5"])
    with np.load(tmp_path / "smp" / "samples_0.npz") as f:
        assert f["samples"].shape == (128, 2) and f["samples"].dtype == np.uint8
        assert f["points"].shape == (128, 2) and np.isfinite(f["points"]).all()
        assert f["v"].shape == (128, 2) and int(f["nfe"]) == 5
    png = Image.open(tmp_path / "smp" / "samples_0.png")
    assert png.size == (260, 260)
