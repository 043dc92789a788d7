"""Checkpoints on the CPU: the port's msgpack codec against the ``msgpack``
package both ways, the published (flax-0.3.1) layout read and written
across the two packages, and the run checkpoints (bit-exact resume, a fresh
start, atomic saves, no global RNG touched)."""

import logging
import os

import hypothesis.extra.numpy as hnp
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gddim_torch import convert, run_lib
from gddim_torch.checkpoints import codec, legacy
from gddim_torch.checkpoints.manager import CheckpointManager
from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models.init import seeded_model, seeded_params
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.train.state import create_train_state, ema_state_dict
from gddim_tpu.checkpoints import legacy as j_legacy
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.math.cld import CLD as JaxCLD
from gddim_tpu.models import get_model
from gddim_tpu.models import make_cld_eps_fn as jax_make_cld_eps_fn
from gddim_tpu.train import create_train_state as jax_create_train_state

EPS_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run many small ops, which a full thread
    pool per test worker slows many times over when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _default(obj):
    """flax's ndarray ext, as the msgpack package writes it."""
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(1, msgpack.packb((list(obj.shape), obj.dtype.name, obj.tobytes()),
                                                use_bin_type=True))
    raise TypeError(type(obj))


def _ref_pack(obj, **kw):
    return msgpack.packb(obj, default=_default, use_bin_type=True, **kw)


def _ref_unpack(raw):
    def hook(code, data):
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    return msgpack.unpackb(raw, ext_hook=hook, raw=False, strict_map_key=False)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_equal, a, b))
    return type(a) is type(b) and a == b


ARRAYS = st.sampled_from([np.float32, np.float64, np.int32, np.uint8, np.bool_]).flatmap(
    lambda dt: hnp.arrays(dt, hnp.array_shapes(min_dims=0, max_dims=3, max_side=5)))
SCALARS = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
TREES = st.recursive(SCALARS | ARRAYS, lambda kids: st.lists(kids, max_size=6)
                     | st.dictionaries(st.text(max_size=8), kids, max_size=6), max_leaves=30)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(TREES)
def test_codec_matches_msgpack_both_ways(tree):
    ours = codec.packb(tree)
    assert ours == _ref_pack(tree)  # the same smallest forms, byte for byte
    assert _equal(codec.unpackb(ours), tree)
    assert _equal(_ref_unpack(ours), tree)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), max_size=8))
def test_codec_reads_float32(values):
    assert codec.unpackb(msgpack.packb(values, use_single_float=True)) == values


@pytest.mark.parametrize("value", [
    "s" * 70_000, b"b" * 70_000, list(range(70_000)), {str(i): i for i in range(70_000)},
    [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
    [-1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63],
    np.arange(70_000, dtype=np.float32), {1: "an int key", -5: None},
])
def test_codec_long_forms(value):
    """The 16- and 32-bit length prefixes (big-endian) and every int width."""
    ours = codec.packb(value)
    assert ours == _ref_pack(value)
    assert _equal(codec.unpackb(ours), value)


def test_codec_refuses_other_ext_codes_and_bad_data():
    with pytest.raises(ValueError, match="ext code 5"):
        codec.unpackb(msgpack.packb(msgpack.ExtType(5, b"abcd")))
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(_ref_pack(np.arange(8, dtype=np.float32))[:-3])
    with pytest.raises(ValueError, match="trailing"):
        codec.unpackb(_ref_pack(1) + b"\x01")


def test_codec_arrays_view_a_writable_buffer():
    buf = bytearray(codec.packb({"a": np.arange(6, dtype=np.float32).reshape(2, 3)}))
    arr = codec.unpackb(buf)["a"]
    assert arr.flags.writeable and not arr.flags.owndata
    arr[0, 0] = 9.0  # writes the buffer, no copy was made
    assert codec.unpackb(buf)["a"][0, 0] == 9.0


# --------------------------------------------------------------------------
# The published layout, across the packages
# --------------------------------------------------------------------------


def small(cfg):
    cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 32, (1, 2), 1
    cfg.model.attn_resolutions, cfg.model.dropout = (16,), 0.0
    cfg.data.image_size, cfg.model.dtype = 16, "float32"
    return cfg


def _random_like(tree, rng, scale=1.0):
    return jax.tree.map(lambda x: (scale * rng.standard_normal(np.shape(x))).astype(np.float32),
                        tree)


def _adam(opt_state):
    import optax

    for node in jax.tree.leaves(opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState)):
        if isinstance(node, optax.ScaleByAdamState):
            return node
    raise AssertionError("no adam state")


def _with_moments(state, mu, nu):
    import optax

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            return node._replace(mu=mu, nu=nu)
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(walk(x) for x in node)
        return node

    return state.replace(opt_state=walk(state.opt_state))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_state():
    """A small JAX TrainState of the accr structure: seeded params, another
    EMA, random Adam moments, step 1234; and its configs."""
    cfg, jcfg = small(get_config("cld/accr_dcifar10")), small(jax_get_config("cld/accr_dcifar10"))
    rng = np.random.default_rng(0)
    params = seeded_params(cfg, 0)
    state = jax_create_train_state(jax.random.PRNGKey(1), jcfg, params, {})
    adam = _adam(state.opt_state)
    state = _with_moments(state, _random_like(adam.mu, rng, 1e-3),
                          jax.tree.map(np.abs, _random_like(adam.nu, rng, 1e-6)))
    # the frozen Fourier frequencies' EMA is the frequencies (their gradient
    # is zero), which the port keeps no copy of
    ema = {k: v if k.startswith("GaussianFourierProjection") else jax.tree.map(
        lambda p: p + 0.01 * rng.standard_normal(p.shape).astype(np.float32), v)
        for k, v in params.items()}
    return cfg, jcfg, state.replace(step=jnp.asarray(1234, jnp.int32), params_ema=ema)


def test_jax_export_restores_into_the_port(tmp_path, jax_state):
    """JAX ``export_legacy_checkpoint`` -> the port's ``restore_state``: the
    moments bit-equal, and the port model's eps (params and EMA) within
    1e-5 of the JAX model's on the same input."""
    cfg, jcfg, jstate = jax_state
    path = j_legacy.export_legacy_checkpoint(tmp_path / "checkpoint_1234", jstate)
    model, state = run_lib.restore_state(cfg, path, device="cpu")
    assert state.step == 1234 and state.count == 1234
    adam = _adam(jstate.opt_state)
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = convert.flax_to_state_dict(model, jax.tree.map(np.asarray, tree))
        for k, t in getattr(state, name).items():
            assert torch.equal(t, want[k]), (name, k)

    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 16, 16, 3, 2)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    jmodel = get_model("ncsnpp")(config=jcfg)
    jeps = jax.jit(lambda p, u, t: jax_make_cld_eps_fn(JaxCLD.from_config(jcfg), jmodel)(
        {"params": p}, u, t))
    eps = make_cld_eps_fn(CLD.from_config(cfg))
    for which, tree in (("params", jstate.params), ("ema", jstate.params_ema)):
        if which == "ema":
            run_lib.use_ema(state)
        want = np.asarray(jeps(tree, jnp.asarray(u), jnp.asarray(t)))
        got = eps(model, torch.from_numpy(u), torch.from_numpy(t)).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() <= EPS_REL, which


def _port_state(cfg, seed=0):
    model = seeded_model(cfg, seed).train()
    state = create_train_state(cfg, model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for d, scale in ((state.ema, 1.0), (state.mu, 1e-3), (state.nu, 1e-6)):
        for k, t in d.items():
            t.copy_(scale * torch.randn(t.shape, generator=g).abs())
    state.step, state.count = 7, 5
    torch.randn(3, generator=state.generator)  # advance it
    return state


def test_port_export_reads_in_jax_and_back(tmp_path):
    """The port's export -> JAX ``load_legacy_checkpoint``: params, EMA and
    moments bit for bit; and back into the port unchanged."""
    cfg = small(get_config("cld/accr_dcifar10"))
    state = _port_state(cfg)
    model = state.model
    path = legacy.export_legacy_checkpoint(tmp_path / "ckpt", state)
    got = j_legacy.load_legacy_checkpoint(path)
    assert got["step"] == 7 and got["lr"] == state.lr and got["ema_rate"] == state.ema_rate
    want = {"params": convert.state_dict_to_flax(model),
            "params_ema": convert.tensors_to_flax(model, ema_state_dict(state)),
            "adam_mu": convert.tensors_to_flax(model, state.mu),
            "adam_nu": convert.tensors_to_flax(model, state.nu)}
    for key, tree in want.items():
        flat_got, flat_want = dict(_flat(got[key])), dict(_flat(tree))
        assert set(flat_got) == set(flat_want), key
        for p, w in flat_want.items():
            assert flat_got[p].dtype == w.dtype and np.array_equal(flat_got[p], w), (key, p)
    # the JAX package reads it into its own state
    jcfg = small(jax_get_config("cld/accr_dcifar10"))
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg, seeded_params(cfg, 3), {})
    jstate = j_legacy.into_train_state(got, jstate)
    assert int(jstate.step) == 7
    # and the port reads its own file back, bit for bit
    model2, state2 = run_lib.restore_state(cfg, path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    for name in ("ema", "mu", "nu"):
        for k, t in getattr(state, name).items():
            assert torch.equal(getattr(state2, name)[k], t), (name, k)


def test_moments_that_do_not_fit_are_kept_fresh_with_a_warning(tmp_path, caplog, jax_state):
    cfg, _, jstate = jax_state
    path = j_legacy.export_legacy_checkpoint(tmp_path / "c", jstate)
    raw = legacy.load_legacy_checkpoint(path)
    raw["adam_mu"] = {k: v for k, v in raw["adam_mu"].items() if k != "Conv_0"}
    model = run_lib.empty_model(cfg, "cpu")
    state = create_train_state(cfg, model, torch.Generator())
    for t in state.mu.values():
        t.zero_()
    with caplog.at_level(logging.WARNING, logger="gddim_torch"):
        legacy.into_train_state(raw, state)
    assert "Conv_0" in caplog.text and "fresh moments" in caplog.text
    assert all(not t.any() for t in state.mu.values()) and state.count == 0
    assert state.step == 1234


# --------------------------------------------------------------------------
# Run checkpoints
# --------------------------------------------------------------------------


def _assert_states_equal(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for name in ("ema", "mu", "nu"):
        for k, t in getattr(a, name).items():
            assert torch.equal(getattr(b, name)[k], t), (name, k)
    for k in a._SCALARS:
        assert getattr(a, k) == getattr(b, k), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_manager_round_trip_is_bit_exact(tmp_path):
    cfg = small(get_config("cld/accr_dcifar10"))
    state = _port_state(cfg, 0)
    mgr = CheckpointManager(tmp_path)
    mgr.save_meta(5, state)
    mgr.save_meta(9, state)
    mgr.save_snapshot(1, state)
    assert sorted(os.listdir(tmp_path / "checkpoints-meta")) == ["checkpoint_9.pt"]  # keeps 1
    assert mgr.snapshot_steps() == [1]
    raw = torch.load(tmp_path / "checkpoints" / "checkpoint_1.pt", weights_only=True)
    assert raw["generator"].dtype == torch.uint8
    for restore in (lambda t: mgr.restore_latest_meta(t), lambda t: (mgr.restore_snapshot(1, t),
                                                                     9)):
        template = _port_state(cfg, 4)
        restored, step = restore(template)
        assert restored is template and step == 9
        _assert_states_equal(state, restored)
        # the generator goes on as the saved one would
        assert torch.equal(torch.randn(4, generator=restored.generator),
                           torch.randn(4, generator=torch.Generator().set_state(
                               state.generator.get_state())))


def test_fresh_start_and_leftover_temporary_files(tmp_path):
    cfg = small(get_config("cld/accr_dcifar10"))
    template = _port_state(cfg, 1)
    before = {k: v.clone() for k, v in template.model.state_dict().items()}
    mgr = CheckpointManager(tmp_path)
    restored, step = mgr.restore_latest_meta(template)
    assert restored is template and step == 0
    assert all(torch.equal(v, before[k]) for k, v in template.model.state_dict().items())
    # a save cut short leaves a temporary file that no restore picks up
    mgr.meta_dir.mkdir(parents=True)
    (mgr.meta_dir / ".checkpoint_20.pt.tmp123").write_bytes(b"cut short")
    assert mgr.restore_latest_meta(template)[1] == 0
    mgr.save_meta(10, _port_state(cfg, 2))
    assert mgr.restore_latest_meta(template)[1] == 10


def test_a_failed_save_leaves_nothing(tmp_path, monkeypatch):
    cfg = small(get_config("cld/accr_dcifar10"))
    state = _port_state(cfg)
    mgr = CheckpointManager(tmp_path)
    mgr.save_meta(4, state)

    def cut(obj, f):
        f.write(b"partial")
        raise OSError("preempted")

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(OSError, match="preempted"):
        mgr.save_meta(8, state)
    assert sorted(os.listdir(mgr.meta_dir)) == ["checkpoint_4.pt"]


def test_a_failed_legacy_export_leaves_nothing(tmp_path, monkeypatch):
    state = _port_state(small(get_config("cld/accr_dcifar10")))

    def cut(obj, write):
        write(b"partial")
        raise OSError("preempted")

    monkeypatch.setattr(codec, "pack_to", cut)
    with pytest.raises(OSError, match="preempted"):
        legacy.export_legacy_checkpoint(tmp_path / "checkpoint_8", state)
    assert os.listdir(tmp_path) == []


def test_restore_leaves_the_global_generators_alone(tmp_path, jax_state):
    cfg, _, jstate = jax_state
    legacy_path = j_legacy.export_legacy_checkpoint(tmp_path / "c", jstate)
    CheckpointManager(tmp_path / "run").save_snapshot(3, _port_state(cfg))
    torch.manual_seed(123)
    rng = torch.get_rng_state()
    np_rng = np.random.get_state()[1].copy()
    run_lib.restore_state(cfg, 3, tmp_path / "run", device="cpu")
    run_lib.restore_state(cfg, legacy_path, device="cpu")
    assert torch.equal(torch.get_rng_state(), rng)
    assert np.array_equal(np.random.get_state()[1], np_rng)
