"""The port's configs against the JAX package's, on the CPU: every
registered config's fields (apart from the port's recorded execution
defaults) and its network's parameter tree at full width, names and shapes;
the converter and the published (legacy) checkpoint format on DDPM++ trees;
the CelebA config through the CLI's sampling mode at a small size."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import cli, convert, run_lib
from gddim_torch.checkpoints import legacy
from gddim_torch.configs import EXECUTION_DEFAULTS, available_configs, get_config
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.unet import NCSNpp
from gddim_torch.train.state import create_train_state, ema_state_dict
from gddim_tpu.checkpoints import legacy as j_legacy
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.models import get_model

CONFIGS = ["cld/accr_dcifar10", "cld/deep_cifar10", "cld/ndeep_cifar10", "cld/ddpmpp_cifar10",
           "cld/ddpmpp_celeba", "cld/simple_cifar10", "cld/calib_cifar10",
           "blur/ddpm_deep_cifar10", "blur/ddpmpp_cifar10", "blur/simple_cifar10",
           "blur/debug_cifar10"]


def test_every_network_config_is_registered():
    """The JAX package's configs that build a network, and no other:
    ``*/default_cifar10`` set no network; ``cld/points`` builds the MLP
    (its fields: tests/test_torch_points.py)."""
    assert sorted(available_configs()) == sorted(CONFIGS + ["cld/points"])
    for name in ("cld/default_cifar10", "blur/default_cifar10"):
        with pytest.raises(ValueError):
            get_config(name)
    assert dataclasses.fields(get_config("cld/accr_dcifar10"))  # a fresh dataclass each call
    assert get_config("cld/ddpmpp_celeba") is not get_config("cld/ddpmpp_celeba")


def _fields(node, prefix=""):
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            yield from _fields(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


def _jax_value(jcfg, path: str):
    node = jcfg
    for part in path.split("."):
        if part not in node:
            return KeyError
        node = node[part]
    return tuple(node) if isinstance(node, list) else node


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_match_jax(name):
    """Every field the port shares with the JAX config has the JAX file's
    value, apart from the port's execution defaults (bf16 'fused'; CLD
    deis-2 NFE=50), which hold their recorded values."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    shared = 0
    for path, value in _fields(cfg):
        want = _jax_value(jcfg, path)
        if want is KeyError or path in EXECUTION_DEFAULTS:
            continue
        shared += 1
        assert value == want and type(value) in (type(want), float, int), (path, value, want)
    assert shared >= 70
    assert (cfg.model.dtype, cfg.model.conv_impl) == ("bfloat16", "fused")
    assert cfg.sampling.nfe == 50 and cfg.sampling.deis_order == 2


def _flax_shapes(tree):
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", CONFIGS)
def test_param_tree_matches_jax_at_full_width(name):
    """The port's scope names and parameter shapes (built on the meta device)
    equal jax.eval_shape of the JAX package's init."""
    jcfg = jax_get_config(name)
    size, ch = jcfg.data.image_size, jcfg.data.num_channels * (2 if jcfg.sde == "cld" else 1)
    want = jax.eval_shape(get_model("ncsnpp")(config=jcfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, ch)), jnp.ones((1,)))["params"]
    want = _flax_shapes(flax.core.unfreeze(want))
    with torch.device("meta"):
        model = NCSNpp(get_config(name))
    shapes = model.state_dict()
    got = {"".join(f"['{p}']" for p in path): tuple(shapes[key].shape)
           for path, key in convert.param_pairs(model)}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(np.prod(s) for s in want.values())


def small(cfg, **model):
    cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 32, (1, 2), 1
    cfg.model.attn_resolutions, cfg.model.dropout = (8,), 0.0
    cfg.data.image_size, cfg.model.dtype = 16, "float32"
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


# a DDPM++ tree (the CelebA structure) and a ddpm-block tree (with its
# Up/Down modules and both pyramids: Combine, the output pyramid's convs;
# three levels, so that the input pyramid's Downsample_1 and _3, which hold
# no parameter, leave gaps in the tree's numbering)
TREES = {"ddpmpp": ("cld/ddpmpp_celeba", {}),
         "ddpm_blocks": ("cld/ddpmpp_cifar10", dict(resblock_type="ddpm", progressive="output_skip",
                                                    progressive_input="input_skip",
                                                    ch_mult=(1, 2, 2)))}


@pytest.mark.parametrize("kind", list(TREES))
def test_converter_round_trips_bit_for_bit(kind):
    name, opts = TREES[kind]
    cfg = small(get_config(name), **opts)
    tree = seeded_params(cfg, 1)
    model = seeded_model(cfg, 1)
    flat = dict(convert._flatten(tree))
    back = dict(convert._flatten(convert.state_dict_to_flax(model)))
    assert set(back) == set(flat) and len(flat) == len(model.state_dict())
    for path, arr in back.items():
        assert arr.dtype == np.float32 and np.array_equal(arr, flat[path]), path
    if kind == "ddpm_blocks":  # every new scope kind holds parameters
        assert {"ResnetBlockDDPMpp", "Combine", "Downsample", "Upsample"} <= {
            p[0].rsplit("_", 1)[0] for p in flat}
        assert {p[0] for p in flat if p[0].startswith("Downsample")} == {"Downsample_0",
                                                                          "Downsample_2"}


def _port_state(cfg, seed=0):
    model = seeded_model(cfg, seed).train()
    state = create_train_state(cfg, model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for d, scale in ((state.ema, 1.0), (state.mu, 1e-3), (state.nu, 1e-6)):
        for k, t in d.items():
            t.copy_(scale * torch.randn(t.shape, generator=g).abs())
    state.step, state.count = 9, 9
    return state


@pytest.mark.parametrize("kind", list(TREES))
def test_legacy_export_reads_back_bit_for_bit(tmp_path, kind):
    """The published msgpack layout: the port's export read by the JAX
    package's reader and by the port's own, every leaf bit for bit."""
    name, opts = TREES[kind]
    cfg = small(get_config(name), **opts)
    state = _port_state(cfg)
    model = state.model
    path = legacy.export_legacy_checkpoint(tmp_path / "checkpoint_9", state)
    got = j_legacy.load_legacy_checkpoint(path)
    want = {"params": convert.state_dict_to_flax(model),
            "params_ema": convert.tensors_to_flax(model, ema_state_dict(state)),
            "adam_mu": convert.tensors_to_flax(model, state.mu)}
    for key, tree in want.items():
        flat_got, flat_want = dict(convert._flatten(got[key])), dict(convert._flatten(tree))
        assert set(flat_got) == set(flat_want), key
        for p, w in flat_want.items():
            assert np.array_equal(np.asarray(flat_got[p]), w), (key, p)
    model2, state2 = run_lib.restore_state(cfg, path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    for attr in ("ema", "mu", "nu"):
        for k, t in getattr(state, attr).items():
            assert torch.equal(getattr(state2, attr)[k], t), (attr, k)
    assert state2.step == 9


@pytest.mark.parametrize("conv_impl", ["fused", "fused_int8"])
def test_cli_samples_ddpmpp_celeba(tmp_path, conv_impl):
    """--mode sampling --config cld/ddpmpp_celeba at a small override on the
    CPU (the kernels' plain versions; fused_int8 calibrates first)."""
    out = tmp_path / "smp"
    cli.main(["--config", "cld/ddpmpp_celeba", "--mode", "sampling", "--device", "cpu",
              "--batch", "2", "--out", str(out), "--set", "model.nf=32", "--set",
              "model.ch_mult=(1,2)", "--set", "model.num_res_blocks=1", "--set",
              "model.attn_resolutions=(8,)", "--set", "data.image_size=16", "--set",
              "sampling.nfe=4", "--set", f"model.conv_impl={conv_impl}"])
    with np.load(out / "samples_0.npz") as f:
        assert f["samples"].shape == (2, 16, 16, 3) and f["samples"].dtype == np.uint8
        assert np.isfinite(f["v"]).all() and int(f["nfe"]) == 4
