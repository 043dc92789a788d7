"""The port's multi-process run harness on the CPU (gloo): the helpers at
one process, each rank's shard of the corpus, and a 2-process CLI run of
``cld/points`` as ``tests/multihost_worker.py`` runs the JAX package's:
training with per-rank shards, the metrics mean over ranks, and 4 sampling
rounds dealt out over 2 ranks into one folder, equal bit for bit to one
process's rounds. The worker is this file run as a script (``__main__``)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gddim_torch import cli
from gddim_torch.configs import get_config
from gddim_torch.data.pipelines import ArrayDataset, _process_shard, get_dataset, pointset_corpus
from gddim_torch.parallel import multihost

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 120  # seconds the worker pair may take (a guard against a hang)
MODEL = ["--config", "cld/points", "--device", "cpu", "--set", "model.nf=16",
         "--set", "model.num_layers=1"]
TRAIN = ["--mode", "train", "--steps", "4", "--batch", "16", "--set", "training.n_jitted_steps=2",
         "--set", "training.log_freq=2", "--set", "training.eval_freq=2",
         "--set", "training.snapshot_freq=4", "--set", "training.snapshot_freq_for_preemption=4",
         "--set", "training.snapshot_sampling=False"]
SAMPLE = ["--mode", "sampling", "--ckpt", "1", "--set", "sampling.nfe=4",
          "--set", "sampling.deis_order=1", "--batch", "8", "--rounds", "4"]


def test_helpers_at_one_process():
    assert not multihost.is_distributed()
    assert multihost.initialize_distributed(None, 1, 0) is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_coordinator()
    multihost.barrier("test")  # plain at one process
    assert multihost.allgather_metrics({"loss": 1.5, "n": 2}) == {"loss": 1.5, "n": 2}
    assert str(multihost.local_device("cpu")) == "cpu"


@pytest.mark.parametrize("name", ["cld/points", "cld/simple_cifar10"])
def test_each_rank_reads_its_shard(name):
    """get_dataset's shard (index, count): batch_size // count rows a batch,
    from the rank's slice of the corpus, in an order seeded by seed + index."""
    cfg = get_config(name)
    cfg.training.batch_size = 16
    whole, _ = get_dataset(cfg, additional_dim=2, prefetch=False)
    shares = [get_dataset(cfg, additional_dim=2, prefetch=False, shard=(i, 2))[0]
              for i in range(2)]
    batches = [next(s)["image"] for s in shares]
    assert all(b.shape == (2, 8) + whole.images.shape[1:] for b in batches)
    for i, share in enumerate(shares):
        np.testing.assert_array_equal(share.images, _process_shard(whole.images, i, 2))
        want = ArrayDataset(share.images, (2, 8), seed=cfg.seed + i, prefetch=False,
                            random_flip=share.random_flip)
        np.testing.assert_array_equal(batches[i], next(want)["image"])
    with pytest.raises(ValueError):
        get_dataset(cfg, prefetch=False, shard=(0, 3))


def test_pointset_shards_are_disjoint():
    raw = pointset_corpus(np.random.default_rng(0))
    a, b = _process_shard(raw, 0, 2), _process_shard(raw, 1, 2)
    assert len(a) + len(b) == len(raw)
    np.testing.assert_array_equal(np.concatenate([a, b])[np.argsort(
        np.concatenate([np.arange(0, len(raw), 2), np.arange(1, len(raw), 2)]))], raw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, world: int, ports: list, workdir: Path) -> None:
    """Train through the CLI, sample through the CLI, then the metrics mean;
    each in a process group of its own (the CLI leaves its group at the end)."""
    env = os.environ
    env.update(GDDIM_NUM_PROCESSES=str(world), GDDIM_PROCESS_ID=str(rank),
               GDDIM_DIST_BACKEND="gloo")
    env["GDDIM_COORDINATOR"] = f"localhost:{ports[0]}"
    cli.main([*MODEL, *TRAIN, "--workdir", str(workdir / "train")])
    env["GDDIM_COORDINATOR"] = f"localhost:{ports[1]}"
    cli.main([*MODEL, *SAMPLE, "--workdir", str(workdir / "train"),
              "--result_folder", str(workdir / "samples")])
    for k in ("GDDIM_NUM_PROCESSES", "GDDIM_PROCESS_ID", "GDDIM_COORDINATOR"):
        del env[k]
    multihost.initialize_distributed(f"localhost:{ports[2]}", world, rank, "gloo", "cpu")
    try:
        m = multihost.allgather_metrics({"pid": float(rank)})
        assert abs(m["pid"] - (world - 1) / 2) < 1e-6, m
        multihost.barrier("done")
    finally:
        multihost.shutdown()
    print(f"worker {rank}: OK", flush=True)


def test_two_process_cli_train_and_sample(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GDDIM_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    ports = [str(_free_port()) for _ in range(3)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", *ports, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {r}: OK" in text, f"worker {r}:\n{text[-4000:]}"

    train = tmp_path / "train"
    records = (train / "metrics.jsonl").read_text().splitlines()  # the coordinator's alone
    assert sum('"train/score_loss"' in r for r in records) == 2
    assert sum('"eval/score_loss"' in r for r in records) == 2
    assert sorted(p.name for p in (train / "checkpoints").iterdir()) == ["checkpoint_1.pt"]
    assert (train / "ema.pt").exists() and (train / "params.pt").exists()

    # the same rounds from one process
    ref = tmp_path / "ref"
    cli.main([*MODEL, *SAMPLE, "--workdir", str(train), "--result_folder", str(ref)])
    names = sorted(p.name for p in (tmp_path / "samples").glob("samples_*.npz"))
    assert names == [f"samples_{r}.npz" for r in range(4)]
    assert names == sorted(p.name for p in ref.glob("samples_*.npz"))
    for name in names:
        with np.load(tmp_path / "samples" / name) as a, np.load(ref / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3:6], Path(sys.argv[6]))
