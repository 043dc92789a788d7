"""The port's parallelism over torch.distributed (``gddim_torch/parallel``)
on the CPU: the placement rules against the JAX package's PartitionSpecs,
and 2- and 4-process gloo runs (started here, each with a timeout) against
one process: the TP forward against the JAX replicated forward, train steps
under data parallelism, FSDP, channel TP and FSDP x TP, a TP sampling
trajectory, and a sharded run's checkpoint read back by one process.

The workers are this file run as a script (``__main__`` below).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 120  # seconds a worker group may take (a guard against a hang)
GRAD_CLIP = 0.05  # low enough that clipping acts at both steps (asserted)
BATCH, STEPS = 8, 2  # the global batch and the steps of one train_step call
FORWARD_TOL = 2e-5  # tests/test_parallel.py's TP forward and trajectory bounds
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-5, 1e-6  # tests/test_parallel.py:137-193

# (job, world size): the steps by layout and route, the TP forward and trajectory
STEP_JOBS = [("step:data:fused", 2), ("step:fsdp:fused", 2), ("step:tp:plain", 2),
             ("step:tp:fused", 2), ("step:fsdp_tp:plain", 4)]
OTHER_JOBS = [("forward:tp:plain", 2), ("sample:tp:plain", 2)]


def tiny_config(conv_impl="plain"):
    """tests/test_parallel.py:84-100's network: cld/simple_cifar10 at 16x16,
    nf 32, attention at 8, dropout 0.1; f32 activations."""
    from gddim_torch.configs import train_config

    cfg = train_config("cld/simple_cifar10")
    cfg.data.image_size = 16
    cfg.model.attn_resolutions = (8,)
    cfg.model.nf = 32
    cfg.model.dropout = 0.1
    cfg.model.conv_impl = conv_impl
    cfg.training.n_jitted_steps = STEPS
    cfg.training.batch_size = BATCH
    cfg.optim.warmup = 1  # the second update is taken at the full learning rate
    cfg.optim.grad_clip = GRAD_CLIP
    cfg.sampling.method, cfg.sampling.nfe, cfg.sampling.deis_order = "deis", 4, 1
    cfg.sampling.noise_removal = True
    return cfg


def global_batch():
    rng = np.random.default_rng(0)
    return torch.from_numpy((rng.standard_normal((STEPS, BATCH, 16, 16, 3)) * 0.5)
                            .astype(np.float32))


def forward_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, 6)).astype(np.float32)
    return x, np.array([0.9, 0.5, 0.1, 0.01], np.float32)


def run_step(cfg, placement=None, model=None):
    """Two train steps of the seeded tiny model on the global batch (this
    rank's rows of it under ``placement``): (info, the state)."""
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train.losses import make_loss_fn
    from gddim_torch.train.state import create_train_state
    from gddim_torch.train.step import make_train_step

    model = seeded_model(cfg, 0) if model is None else model
    state = create_train_state(cfg, model, torch.Generator().manual_seed(1), placement)
    batches = global_batch()
    if placement is not None:
        batches = placement.shard_batch(batches, dim=1)
    info = make_train_step(make_loss_fn(cfg, train=True))(state, batches)
    return info, state


def sample_fn(cfg):
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.wrappers import make_cld_eps_fn
    from gddim_torch.samplers.factory import build_cld_sampler

    sde = CLD.from_config(cfg)
    return build_cld_sampler(cfg, sde, make_cld_eps_fn(sde), (16, 16, 3), lambda x: (x + 1) / 2)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def worker(rank: int, world: int, port: int, out: Path, jobs: list) -> None:
    torch.set_num_threads(1)
    from gddim_torch.models.init import seeded_model
    from gddim_torch.parallel import initialize_distributed, is_coordinator, shutdown
    from gddim_torch.parallel.mesh import place_model

    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo", device="cpu")
    try:
        for job in jobs:
            kind, layout, conv_impl = job.split(":")
            cfg = tiny_config(conv_impl)
            n_fsdp, n_tp = {"data": (1, 1), "fsdp": (world, 1), "tp": (1, world),
                            "fsdp_tp": (2, world // 2)}[layout]
            model = seeded_model(cfg, 0)
            if kind == "forward":  # the JAX tree's weights, converted
                model.load_state_dict(torch.load(out / "jax_sd.pt", weights_only=True))
            model, placement = place_model(model, n_fsdp, n_tp, device_type="cpu")
            if kind == "step":
                info, state = run_step(cfg, placement, model)
                sd = state.state_dict()
                state.load_state_dict(sd)  # the whole tensors back into the shards
                result = {"loss": info["loss"], "grad_norm": info["grad_norm"], "sd": sd,
                          "sd_again": state.state_dict(), "tp_names": sorted(placement.tp_names)}
            elif kind == "forward":
                x, t = forward_inputs()
                with torch.no_grad():
                    y = model(torch.from_numpy(x), torch.from_numpy(t))
                result = {"y": y}
            else:
                with torch.no_grad():
                    x, _, nfe = sample_fn(cfg)(torch.Generator().manual_seed(2), model, 4)
                result = {"x": x, "nfe": nfe}
            if is_coordinator():
                torch.save(result, out / f"{job.replace(':', '_')}.pt")
    finally:
        shutdown()
    print(f"worker {rank}: OK", flush=True)


def launch(world: int, jobs: list, out: Path) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("GDDIM_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port), str(out),
                               json.dumps(jobs)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {r}: OK" in text, f"worker {r}:\n{text[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's rank-0 result, from one 2-process and one 4-process run."""
    from gddim_torch import convert
    from gddim_torch.models.init import seeded_model, seeded_params

    out = tmp_path_factory.mktemp("parallel")
    cfg = tiny_config()
    torch.save(convert.flax_to_state_dict(seeded_model(cfg, 0), seeded_params(cfg, 0)),
               out / "jax_sd.pt")
    for world in (2, 4):
        launch(world, [j for j, w in STEP_JOBS + OTHER_JOBS if w == world], out)
    return lambda job: torch.load(out / f"{job.replace(':', '_')}.pt", weights_only=False)


# ---------------------------------------------------------------------------
# placement rules against the JAX PartitionSpecs (tests/test_parallel.py:42-82)
# ---------------------------------------------------------------------------

FSDP_SHAPES = [(1024, 256), (4,), (1026, 65)]
TP_SHAPES = [(3, 3, 64, 128), (128, 512), (128,), (3, 3, 64, 65)]


def _jax_spec(arr, ndim):
    spec = tuple(arr.sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("shape", FSDP_SHAPES)
def test_fsdp_spec_matches_jax(shape):
    from gddim_torch.parallel.mesh import fsdp_spec
    from gddim_tpu.parallel.mesh import fsdp_shard_params, make_mesh

    mesh = make_mesh()
    out = fsdp_shard_params({"x": jnp.ones(shape)}, mesh, min_size=2**10)
    assert fsdp_spec(shape, 8, min_size=2**10) == _jax_spec(out["x"], len(shape))


@pytest.mark.parametrize("shape", TP_SHAPES)
@pytest.mark.parametrize("with_fsdp", [False, True])
def test_tp_spec_matches_jax(shape, with_fsdp):
    from gddim_torch.parallel.mesh import tp_spec
    from gddim_tpu.parallel.mesh import make_mesh_3d, tp_shard_params

    mesh = make_mesh_3d(2, 2, 2)
    fsdp_axis = "fsdp" if with_fsdp else None
    out = tp_shard_params({"x": jnp.ones(shape)}, mesh, axis="model", fsdp_axis=fsdp_axis)
    assert tp_spec(shape, 2, "model", fsdp_axis, 2) == _jax_spec(out["x"], len(shape))


def test_tp_names_follow_the_rule(runs):
    """Every parameter the rule shards over 'model' is channel-sharded, and
    no other: conv kernels HWIO and Dense/NIN kernels (in, out) shard their
    output channels."""
    from gddim_torch.models.init import seeded_model
    from gddim_torch.parallel.mesh import tp_spec

    want = sorted(n for n, p in seeded_model(tiny_config(), 0).named_parameters()
                  if tp_spec(tuple(p.shape), 2)[-1] == "model")
    assert want and runs("step:tp:plain")["tp_names"] == want


# ---------------------------------------------------------------------------
# against one process
# ---------------------------------------------------------------------------


def test_tp_forward_matches_jax(runs):
    """The 2-rank TP forward ('plain': each rank's channel slice, gathered)
    against the JAX package's replicated forward on the same weights."""
    from gddim_torch.models.init import seeded_params
    from gddim_tpu.configs import get_config as jax_get_config
    from gddim_tpu.models import get_model

    jcfg = jax_get_config("cld/simple_cifar10")
    jcfg.data.image_size = 16
    jcfg.model.attn_resolutions = (8,)
    jcfg.model.nf = 32
    model = get_model("ncsnpp")(config=jcfg)
    tree = jax.tree.map(jnp.asarray, seeded_params(tiny_config(), 0))
    x, t = forward_inputs()
    want = np.asarray(model.apply({"params": tree}, jnp.asarray(x), jnp.asarray(t), train=False))
    got = runs("forward:tp:plain")["y"].numpy()
    np.testing.assert_allclose(got, want, rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.fixture(scope="module")
def one_process():
    """The 1-process steps, by route."""
    return {impl: run_step(tiny_config(impl)) for impl in ("plain", "fused")}


@pytest.mark.parametrize("job", [j for j, _ in STEP_JOBS])
def test_train_step_matches_one_process(runs, one_process, job):
    """Loss, gradient norm (clipping acting), updated parameters and EMA of
    a sharded step against the 1-process step on the same global batch."""
    got = runs(job)
    info, state = one_process[job.split(":")[2]]
    ref = state.state_dict()
    np.testing.assert_allclose(float(got["loss"]), float(info["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]), float(info["grad_norm"]), rtol=LOSS_RTOL)
    assert float(info["grad_norm"]) > GRAD_CLIP
    for part in ("params", "ema"):
        assert set(got["sd"][part]) == set(ref[part])
        for k, v in ref[part].items():
            np.testing.assert_allclose(got["sd"][part][k].numpy(), v.numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"{job} {part}.{k}")
    assert got["sd"]["count"] == ref["count"] and got["sd"]["step"] == ref["step"]
    assert torch.equal(got["sd"]["generator"], ref["generator"])


def _bit_equal(a: dict, b: dict) -> list:
    bad = []
    for k in a:
        if isinstance(a[k], dict):
            bad += [f"{k}.{n}" for n in a[k] if not torch.equal(a[k][n], b[k][n])]
        elif torch.is_tensor(a[k]):
            bad += [] if torch.equal(a[k], b[k]) else [k]
        elif a[k] != b[k]:
            bad.append(k)
    return bad


@pytest.mark.parametrize("job", ["step:fsdp:fused", "step:tp:plain", "step:fsdp_tp:plain"])
def test_sharded_checkpoint_round_trip(runs, job):
    """A sharded run's checkpoint (whole tensors, the 1-process keys) loads
    into a 1-process state bit for bit, and back into the shards."""
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train.state import create_train_state

    got = runs(job)
    cfg = tiny_config(job.split(":")[2])
    state = create_train_state(cfg, seeded_model(cfg, 0), torch.Generator())
    state.load_state_dict(got["sd"])
    assert _bit_equal(got["sd"], state.state_dict()) == []
    assert _bit_equal(got["sd"], got["sd_again"]) == []


def test_tp_sampling_trajectory_matches_one_process(runs):
    """A deis-1 NFE=4 trajectory under 2-rank channel TP against the
    1-process trajectory (tests/test_parallel.py's TP sampling test)."""
    from gddim_torch.models.init import seeded_model

    cfg = tiny_config()
    with torch.no_grad():
        want, _, nfe = sample_fn(cfg)(torch.Generator().manual_seed(2), seeded_model(cfg, 0), 4)
    got = runs("sample:tp:plain")
    assert got["nfe"] == nfe
    np.testing.assert_allclose(got["x"].numpy(), want.numpy(), rtol=FORWARD_TOL, atol=FORWARD_TOL)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
           json.loads(sys.argv[5]))
