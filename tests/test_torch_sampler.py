"""The port's deis sampler against the JAX package's, and the port's
independence from JAX."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gddim_torch.cli import build_sampling_fn
from gddim_torch.configs import get_config
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.samplers.factory import build_cld_sampler as jax_build_cld_sampler

REPO = Path(__file__).resolve().parents[1]


def small(cfg, nfe=4):
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (16,)
    cfg.data.image_size = 16
    cfg.model.dtype = "float32"
    cfg.sampling.method = "deis"
    cfg.sampling.deis_order = 2
    cfg.sampling.noise_removal = True
    cfg.sampling.nfe = nfe
    cfg.sampling.ts_order = 2
    return cfg


def test_deis_trajectory_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GDDIM_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path / "torch"))
    cfg = small(get_config("cld/accr_dcifar10"))
    tree = seeded_params(cfg, 0)
    u0 = np.random.default_rng(0).standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    u0[..., 1] *= 0.5

    x, v, nfe = build_sampling_fn(cfg)(None, seeded_model(cfg, 0), u0=torch.from_numpy(u0))

    jcfg = small(jax_get_config("cld/accr_dcifar10"))
    jcfg.model.conv_impl = "fused"
    sde = JaxCLD.from_config(jcfg)
    sampler = jax_build_cld_sampler(
        jcfg, sde, jax_make_cld_eps_fn(sde, get_model("ncsnpp")(config=jcfg)), (16, 16, 3),
        inverse_scaler=lambda a: (a + 1.0) / 2.0)
    jxs, jvs, jnfe = sampler(jax.random.PRNGKey(0), {"params": jax.tree.map(jnp.asarray, tree)},
                             u0=jnp.asarray(u0))
    assert nfe == jnfe == 4
    for got, want in ((x, jxs), (v, jvs)):
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape and torch.isfinite(got).all()
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= 1e-3, rel


def test_prior_draw_and_cli_writes_samples(tmp_path, monkeypatch):
    monkeypatch.setenv("GDDIM_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    from gddim_torch.run_lib import sampling_from_fn

    cfg = small(get_config("cld/accr_dcifar10"), nfe=3)
    model = seeded_model(cfg, 1)
    (path,) = sampling_from_fn(cfg, build_sampling_fn(cfg), model, tmp_path / "out", 2, 2,
                               seed=3)
    with np.load(path) as f:
        assert f["samples"].shape == (2, 16, 16, 3) and f["samples"].dtype == np.uint8
        assert f["v"].shape == (2, 16, 16, 3) and int(f["nfe"]) == 3


def test_port_imports_no_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        # what the machine with the card lacks: any import of these fails
        BLOCKED = ("jax", "jaxlib", "flax", "ml_collections", "gddim_tpu", "msgpack", "PIL",
                   "orbax", "wandb", "tensorflow")

        import builtins, importlib
        real_import, real_import_module = builtins.__import__, importlib.import_module

        def guard(name):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")

        def blocked_import(name, *args, **kwargs):
            if not (len(args) > 3 and args[3]):  # absolute imports
                guard(name)
            return real_import(name, *args, **kwargs)

        def blocked_import_module(name, package=None):
            guard(name)
            return real_import_module(name, package)

        builtins.__import__, importlib.import_module = blocked_import, blocked_import_module
        try:
            import msgpack  # noqa: F401
        except ImportError:
            pass
        else:
            raise AssertionError("msgpack was not blocked")
        import torch
        import gddim_torch, gddim_torch.cli, gddim_torch.convert
        from gddim_torch.configs import get_config
        from gddim_torch.math.cld import CLD
        from gddim_torch.models.init import seeded_model
        from gddim_torch.models.wrappers import make_cld_eps_fn
        cfg = get_config("cld/accr_dcifar10")
        cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 32, (1, 2), 1
        cfg.data.image_size, cfg.model.dtype = 16, "float32"
        eps = make_cld_eps_fn(CLD.from_config(cfg))(
            seeded_model(cfg, 0), torch.zeros(1, 16, 16, 3, 2), torch.full((1,), 0.5))
        assert eps.shape == (1, 16, 16, 3, 2)
        import gddim_torch.models.calibrate, gddim_torch.ops.conv3x3, gddim_torch.samplers.blur
        from gddim_torch.math.blur import BlurSDE
        from gddim_torch.models.wrappers import make_blur_yeps_fn
        cfg = get_config("blur/ddpm_deep_cifar10")
        cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 128, (1, 2), 1
        cfg.data.image_size, cfg.model.dtype, cfg.model.conv_impl = 16, "float32", "int8"
        eps = make_blur_yeps_fn(BlurSDE.from_config(cfg))(
            seeded_model(cfg, 0), torch.zeros(1, 16, 16, 3), torch.full((1,), 0.5))
        assert eps.shape == (1, 16, 16, 3)
        from gddim_torch.ops.attnblock import fused_attnblock_train
        from gddim_torch.ops.resblock import fused_resblock_transition
        cfg = get_config("cld/accr_dcifar10")
        cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 64, (1, 2), 1
        cfg.data.image_size, cfg.model.dtype, cfg.model.transition_impl = 16, "float32", "full"
        eps = make_cld_eps_fn(CLD.from_config(cfg))(
            seeded_model(cfg, 0), torch.zeros(1, 16, 16, 3, 2), torch.full((1,), 0.5))
        assert eps.shape == (1, 16, 16, 3, 2)
        # the sampler family, blur DEIS and blur training
        import gddim_torch.math.deis_scalar, gddim_torch.math.variants
        from gddim_torch.samplers import coefs, engine, factory
        from gddim_torch.samplers.blur import blur_deis_stacks
        from gddim_torch.train.losses import make_blur_loss_fn
        host = CLD().host()
        for bundle in (coefs.em_bundle(host, 4, 1.0), coefs.sscs_bundle(host, 4),
                       coefs.ldeis_bundle(host, 4, 1)):
            run = engine.sscs_sample if isinstance(bundle, coefs.SSCSBundle) else engine.ab_sample
            u = run(lambda u, t: u, torch.zeros(1, 2, 2), bundle, torch.Generator())
            assert torch.isfinite(u).all()
        assert len(factory.CLD_SAMPLERS) == 9
        assert blur_deis_stacks(BlurSDE(img_dim=8), 2, 1, 2.0)[2].shape == (2, 2, 8, 8, 1)
        cfg = get_config("blur/ddpm_deep_cifar10")
        cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 32, (1, 2), 1
        cfg.data.image_size, cfg.model.dtype = 16, "float32"
        loss = make_blur_loss_fn(BlurSDE(img_dim=16), train=True)(seeded_model(cfg, 0).train(),
                                                  torch.zeros(2, 16, 16, 3), torch.Generator())
        loss.backward()
        # the run harness: a tiny training run on the synthetic corpus, a
        # legacy export read back, sampling from it and proxy scores
        import tempfile
        import numpy as np
        from gddim_torch import run_lib
        from gddim_torch.checkpoints import codec, legacy, manager
        from gddim_torch.data import pipelines
        from gddim_torch.evals import features, fid, inception
        from gddim_torch.utils import images, logging, tree
        from gddim_torch.configs import train_config
        cfg = train_config("cld/accr_dcifar10")
        cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 16, (1, 2), 1
        cfg.model.attn_resolutions, cfg.data.image_size = (8,), 16
        cfg.training.batch_size, cfg.training.n_iters, cfg.training.n_jitted_steps = 2, 2, 2
        cfg.training.snapshot_freq = cfg.training.snapshot_freq_for_sampling = 2
        cfg.sampling.nfe, cfg.eval.num_samples, cfg.eval.batch_size = 3, 2, 2
        with tempfile.TemporaryDirectory() as tmp:
            state = run_lib.train(cfg, tmp, "cpu")
            path = legacy.export_legacy_checkpoint(tmp + "/legacy", state)
            run_lib.sample_data(cfg, str(path), tmp + "/s", device="cpu")
            assert np.isfinite(run_lib.check_fid(cfg, tmp + "/s", "cpu")["fid_proxy"])
        inception.InceptionV3(inception.random_state_dict(), "fid2015")
        # the point set, the registry, the classifier, remat and AdamW
        from gddim_torch.data import pointset
        from gddim_torch.models import mlp, registry, wideresnet
        assert registry.available_models() == ("ncsnpp", "ps_fmlp",
                                                "wideresnet_noise_conditional")
        cfg = get_config("cld/points")
        cfg.sampling.nfe = 3
        x = run_lib.build_sampling_fn(cfg)(torch.Generator(), seeded_model(cfg, 0), 8)[0]
        assert x.shape == (8, 2) and pointset.olympic_generate_sample(10).shape == (10, 2)
        wrn = wideresnet.WideResnet(1, 1, 10)
        grad = wideresnet.get_classifier_grad_fn(wideresnet.get_logit_fn(wrn))(
            torch.rand(2, 8, 8, 3), torch.ones(2), torch.tensor([1, 2]))
        assert grad.shape == (2, 8, 8, 3)
        cfg = train_config("cld/accr_dcifar10")
        cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 128, (1, 2), 1
        cfg.model.attn_resolutions, cfg.data.image_size = (8,), 8
        cfg.model.conv_impl, cfg.model.remat, cfg.model.fused_train = "pallas", "convs", False
        cfg.optim.weight_decay = 1e-2
        from gddim_torch.train.losses import make_cld_loss_fn
        from gddim_torch.train.state import create_train_state
        from gddim_torch.train.step import make_train_step
        state = create_train_state(cfg, seeded_model(cfg, 0).train(), torch.Generator())
        make_train_step(make_cld_loss_fn(CLD.from_config(cfg), train=True))(
            state, torch.zeros(1, 2, 8, 8, 3))
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), GDDIM_TORCH_CACHE_DIR=str(tmp_path),
               OMP_NUM_THREADS="1")  # small ops: one thread, as the test workers share cores
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
