"""The noise-conditional WideResNet classifier against the JAX package, on
the CPU: its parameter tree and the converter both ways, the logits and
classifier guidance's gradient with the same weights at a small width,
``create_classifier``'s checkpoint formats, and the full-width size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gddim_torch import convert
from gddim_torch.checkpoints import codec
from gddim_torch.models import wideresnet as t_wrn
from gddim_tpu.models import wideresnet as j_wrn

# f32 in both frameworks, 10 conv layers deep at this size; GroupNorm's
# variance differs in form (flax E[x^2] - mean^2, the port two-pass)
WRN_REL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _random_tree(tree, seed):
    """The init's tree with GroupNorm scales 1 + 0.1 N and every bias 0.1 N
    (the init makes them 1 and 0), so that each parameter matters."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def small_wrn():
    jmodel = j_wrn.WideResnet(blocks_per_group=1, channel_multiplier=2, num_outputs=10)
    init = jax.jit(lambda key: jmodel.init(key, jnp.ones((2, 16, 16, 3)), jnp.ones((2,)),
                                           train=False))
    params = init(jax.random.PRNGKey(3))["params"]
    tree = _random_tree(dict(params), 4)
    model = t_wrn.WideResnet(blocks_per_group=1, channel_multiplier=2, num_outputs=10)
    model.load_state_dict(convert.flax_to_state_dict(model, tree))
    return jmodel, tree, model.eval()


def _inputs(seed, b=3, size=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    sigma = np.exp(rng.uniform(np.log(0.01), np.log(50.0), b)).astype(np.float32)
    labels = rng.integers(0, 10, b)
    return x, sigma, labels


def test_tree_converts_both_ways(small_wrn):
    jmodel, tree, model = small_wrn
    back = convert.state_dict_to_flax(model)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, tree)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(a, b)
    names = set(tree) | set(tree["WideResnetGroup_0"]["WideResnetBlock_0"])
    assert {"init_conv", "pre-pool-bn", "init_bn", "conv1", "Dense_0", "bn_2", "conv2"} <= names
    bad = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
    bad["WideResnetGroup_3"] = bad.pop("WideResnetGroup_2")  # numbering with a gap
    with pytest.raises(ValueError):
        convert.flax_to_state_dict(model, bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_and_guidance_gradient_match_jax(small_wrn, seed):
    jmodel, tree, model = small_wrn
    x, sigma, labels = _inputs(seed)
    jlogit = j_wrn.get_logit_fn(jmodel, jax.tree.map(jnp.asarray, tree))
    want_logits = jax.jit(jlogit)(jnp.asarray(x), jnp.asarray(sigma))
    want_grad = jax.jit(j_wrn.get_classifier_grad_fn(jlogit))(
        jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels))
    logit_fn = t_wrn.get_logit_fn(model)
    with torch.no_grad():
        logits = logit_fn(torch.from_numpy(x), torch.from_numpy(sigma))
    grad = t_wrn.get_classifier_grad_fn(logit_fn)(torch.from_numpy(x), torch.from_numpy(sigma),
                                                  torch.from_numpy(labels))
    assert logits.shape == (3, 10) and grad.shape == x.shape
    assert rel_err(logits, want_logits) <= WRN_REL
    assert rel_err(grad, want_grad) <= WRN_REL


def test_create_classifier_reads_state_dicts_and_msgpack(small_wrn, tmp_path, monkeypatch):
    """The full-width classifier's size; the two file formats through a
    small one (create_classifier builds WRN-28-10); an orbax directory
    refused."""
    with torch.device("meta"):
        full = t_wrn.WideResnet()
    assert sum(p.numel() for p in full.parameters()) == 38_913_242
    jmodel, tree, model = small_wrn
    small = t_wrn.WideResnet
    monkeypatch.setattr(t_wrn, "WideResnet",
                        lambda *a, generator=None, **k: small(1, 2, 10, generator=generator))
    sd_path = tmp_path / "wrn.pt"
    torch.save(model.state_dict(), sd_path)
    (tmp_path / "wrn.msgpack").write_bytes(codec.packb({"params": tree}))
    for path in (sd_path, tmp_path / "wrn.msgpack"):
        got, params = t_wrn.create_classifier(torch.Generator().manual_seed(0), 8, str(path),
                                              device="cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(params[k], v), k
    fresh, _ = t_wrn.create_classifier(torch.Generator().manual_seed(0), 8, device="cpu")
    assert not torch.equal(fresh.init_conv.weight, model.init_conv.weight)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        t_wrn.create_classifier(None, 8, str(tmp_path / "orbax"), device="cpu")


def test_classifier_runs_no_kernel(small_wrn, monkeypatch):
    """Its GroupNorms take the plain version (relu follows, not swish) and
    its convs are plain: no kernel wrapper is called."""
    from gddim_torch.ops import conv3x3, groupnorm

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((groupnorm, "group_norm_silu"), (conv3x3, "conv3x3_pallas")):
        monkeypatch.setattr(mod, name, refuse)
    x, sigma, _ = _inputs(2)
    with torch.no_grad():
        assert torch.isfinite(small_wrn[2](torch.from_numpy(x), torch.from_numpy(sigma))).all()
