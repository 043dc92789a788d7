"""The port's run harness on the CPU at a tiny size (nf 16, 16x16, one block
a level, NFE 4) on a CIFAR-10 npz fixture: the training loop's schedule
against the JAX loop's rule, preemption resume, sampling rounds, scoring,
evaluate's resume, the CLI's six modes and its parsing against the JAX CLI."""

import copy
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from gddim_torch import cli, run_lib
from gddim_torch.checkpoints import legacy
from gddim_torch.checkpoints.manager import CheckpointManager
from gddim_torch.configs import get_config, train_config
from gddim_torch.models.init import seeded_model
from gddim_torch.utils import images as t_images
from gddim_torch.utils.logging import MetricsLogger
from gddim_torch.utils.tree import flatten_config
from gddim_tpu import cli as j_cli
from gddim_tpu.configs import get_config as jax_get_config
from gddim_tpu.utils import images as j_images

FREQS = ("log_freq", "eval_freq", "snapshot_freq", "snapshot_freq_for_preemption",
         "snapshot_freq_for_sampling")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: these tests run many small ops, which a full thread
    pool per test worker slows many times over when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(cfg, data_dir, freqs=(4, 4, 4, 4, 4)):
    cfg.model.nf, cfg.model.ch_mult, cfg.model.num_res_blocks = 16, (1, 2), 1
    cfg.model.attn_resolutions, cfg.data.image_size = (8,), 16
    cfg.data.data_dir = str(data_dir)
    cfg.training.batch_size, cfg.training.n_jitted_steps, cfg.training.n_iters = 4, 2, 9
    for name, f in zip(FREQS, freqs):
        setattr(cfg.training, name, f)
    cfg.training.snapshot_sampling_batch = 4
    cfg.sampling.nfe, cfg.sampling.deis_order = 4, 1
    cfg.eval.batch_size, cfg.eval.num_samples = 2, 4
    return cfg


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(0)
    np.savez(root / "cifar10_train.npz", images=rng.integers(0, 256, (64, 16, 16, 3), np.uint8))
    np.savez(root / "cifar10_test.npz", images=rng.integers(0, 256, (16, 16, 16, 3), np.uint8))
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory, data_dir):
    """One training run of the tiny config: (config, workdir, final state)."""
    cfg = tiny(train_config("cld/accr_dcifar10"), data_dir)
    workdir = tmp_path_factory.mktemp("run")
    state = run_lib.train(cfg, workdir, "cpu")
    return cfg, workdir, state


def jax_schedule(tc, start: int = 0):
    """What the JAX loop (gddim_tpu/run_lib.py:263-334) does after each call
    of n_jitted_steps steps from ``start``: a step acts when
    cur % freq < n_jitted_steps; the EMA swap skips the first call."""
    n = tc.n_jitted_steps
    out = {"log": [], "meta": [], "eval": [], "snapshots": [], "samples": [], "swaps": []}
    for step in range(start, tc.n_iters, n):
        cur = step + n
        for key, freq in (("log", tc.log_freq), ("meta", tc.snapshot_freq_for_preemption),
                          ("eval", tc.eval_freq), ("samples", tc.snapshot_freq_for_sampling)):
            if cur % freq < n:
                out[key].append(cur)
        if step != start and cur % tc.ema_update_freq < n:
            out["swaps"].append(cur)
        if cur % tc.snapshot_freq < n:
            out["snapshots"].append(cur // tc.snapshot_freq)
    return out


def read_metrics(workdir):
    return [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]


def assert_schedule(cfg, workdir, state, start=0, before=None):
    """The workdir holds what the rule writes from ``start`` (after
    ``before``, the rule's schedule of an earlier run in the same workdir)."""
    want = jax_schedule(cfg.training, start)
    files = {k: set(want[k]) | set(before[k] if before else ()) for k in ("snapshots", "samples")}
    mgr = CheckpointManager(workdir)
    assert mgr.snapshot_steps() == sorted(files["snapshots"])
    assert sorted(os.listdir(workdir / "checkpoints-meta")) == [
        f"checkpoint_{cfg.training.n_iters}.pt"]
    if files["samples"]:
        assert sorted(os.listdir(workdir / "samples")) == sorted(
            f"iter_{c}" for c in files["samples"])
    records = read_metrics(workdir)
    if before is not None:  # this run's records follow the earlier run's
        records = records[len(before["log"]) + len(before["eval"]) + len(before["samples"]):]
    by_key = {}
    for rec in records:
        assert set(rec) - {"_time", "step"} <= {"train/score_loss", "train/imgs_per_sec",
                                                "eval/score_loss", "samples"}
        for k in rec:
            if k not in ("_time", "step"):
                by_key.setdefault(k, []).append(rec["step"])
    assert by_key.get("train/score_loss", []) == want["log"]
    assert by_key.get("train/imgs_per_sec", []) == want["log"]
    assert by_key.get("eval/score_loss", []) == want["eval"]
    assert by_key.get("samples", []) == want["samples"]
    n = cfg.training.n_jitted_steps
    n_calls = len(range(start, cfg.training.n_iters, n))
    assert state.step == start + n * n_calls
    # updates since the last EMA swap (each swap makes a fresh optimizer)
    last = max(want["swaps"], default=None)
    assert state.count == (state.step - last if last else state.count)


def test_train_writes_what_the_jax_loop_writes(run):
    """Checkpoint ids, samples/iter_<n>, and the steps and keys of
    metrics.jsonl are those of the JAX loop's rule on this config."""
    cfg, workdir, state = run
    assert_schedule(cfg, workdir, state)
    png = (workdir / "samples" / "iter_4" / "sample.png").read_bytes()
    assert png.startswith(b"\x89PNG")
    assert all(np.isfinite(r["train/score_loss"]) for r in read_metrics(workdir)
               if "train/score_loss" in r)


def test_train_schedule_at_other_frequencies_and_the_ema_swap(tmp_path, data_dir):
    """Other frequencies, the EMA swap, and a torch.profiler trace of the
    calls from step 2 to step 4 (written after the call that ends at 6)."""
    cfg = tiny(train_config("cld/accr_dcifar10"), data_dir, freqs=(3, 5, 4, 6, 3))
    cfg.training.ema_update_freq = 4
    cfg.training.profile_start, cfg.training.profile_steps = 2, 2
    state = run_lib.train(cfg, tmp_path, "cpu")
    assert_schedule(cfg, tmp_path, state)
    assert jax_schedule(cfg.training)["swaps"] == [4, 8] and state.count == 2
    trace = tmp_path / "profile" / "trace_6.json"
    assert os.listdir(tmp_path / "profile") == ["trace_6.json"]
    assert "traceEvents" in json.loads(trace.read_text())


def _clone(sd):
    return {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
            else v.clone() if torch.is_tensor(v) else v for k, v in sd.items()}


def _assert_sd_equal(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, dict):
            assert set(v) == set(b[k]) and all(torch.equal(t, b[k][n]) for n, t in v.items()), k
        elif torch.is_tensor(v):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_preemption_resume_restores_every_bit(tmp_path, data_dir, monkeypatch):
    """A run to n_iters 5, then the same workdir to 9: the second resumes at
    the first's last step (6) from the meta checkpoint, not from scratch,
    with every tensor, counter and the generator state bit-equal."""
    cfg = tiny(train_config("cld/accr_dcifar10"), data_dir)
    cfg.training.n_iters = 5
    first = _clone(run_lib.train(cfg, tmp_path, "cpu").state_dict())
    assert first["step"] == 6
    seen = {}
    restore = CheckpointManager.restore_latest_meta

    def spy(self, template):
        state, step = restore(self, template)
        seen["sd"], seen["meta_step"] = _clone(state.state_dict()), step
        return state, step

    monkeypatch.setattr(CheckpointManager, "restore_latest_meta", spy)
    before = jax_schedule(cfg.training)
    cfg.training.n_iters = 9
    state = run_lib.train(cfg, tmp_path, "cpu")
    assert seen["meta_step"] == 5
    _assert_sd_equal(seen["sd"], first)
    assert_schedule(cfg, tmp_path, state, start=6, before=before)
    assert state.step == 10


def test_sharded_configs_are_refused(tmp_path, data_dir):
    cfg = tiny(train_config("cld/accr_dcifar10"), data_dir)
    cfg.mesh.fsdp_axis = 2
    with pytest.raises(ValueError, match="one card"):
        run_lib.train(cfg, tmp_path, "cpu")


@pytest.fixture(scope="module")
def sampler():
    cfg = tiny(get_config("cld/accr_dcifar10"), "")
    cfg.model.dtype = "float32"
    return cfg, seeded_model(cfg, 0), run_lib.build_sampling_fn(cfg)


def _samples(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_sampling_rounds_continue_and_are_independent(tmp_path, sampler):
    """Round r draws the same samples whether or not the rounds before it
    ran; is_continue skips the rounds on disk and leaves them as they are."""
    cfg, model, fn = sampler
    full = run_lib.sampling_from_fn(cfg, fn, model, tmp_path / "a", 5, 2, seed=3,
                                    is_continue=False)
    assert [p.name for p in full] == ["samples_0.npz", "samples_1.npz", "samples_2.npz"]
    first = _samples(full[0])
    assert first["samples"].shape == (2, 16, 16, 3) and first["samples"].dtype == np.uint8
    assert first["v"].shape == (2, 16, 16, 3) and int(first["nfe"]) == 4
    stamps = [p.stat().st_mtime_ns for p in full]
    run_lib.sampling_from_fn(cfg, fn, model, tmp_path / "a", 5, 2, seed=3)
    assert [p.stat().st_mtime_ns for p in full] == stamps  # nothing computed again
    part = tmp_path / "b"
    part.mkdir()
    for r in (0, 1):
        (part / f"samples_{r}.npz").write_bytes(b"earlier round")
    run_lib.sampling_from_fn(cfg, fn, model, part, 5, 2, seed=3)
    assert (part / "samples_0.npz").read_bytes() == b"earlier round"
    for k, v in _samples(full[2]).items():
        np.testing.assert_array_equal(_samples(part / "samples_2.npz")[k], v)
    assert not np.array_equal(_samples(full[1])["samples"], _samples(full[2])["samples"])


def test_check_fid_reports_proxy_keys(tmp_path, sampler, data_dir):
    cfg, model, fn = sampler
    cfg = copy.deepcopy(cfg)
    cfg.data.data_dir = str(data_dir)
    cfg.eval.stats_path = str(tmp_path / "stats.npz")
    assert run_lib.fid_stats(cfg, device="cpu") == cfg.eval.stats_path
    folder = tmp_path / "s"
    run_lib.sampling_from_fn(cfg, fn, model, folder, 4, 2, seed=1)
    report = run_lib.check_fid(cfg, folder, "cpu")
    assert set(report) == {"IS_proxy", "fid_proxy", "kid_proxy", "nfe", "extractor", "n"}
    assert report["extractor"] == "proxy" and report["n"] == 4 and report["nfe"] == 4
    assert all(np.isfinite(report[k]) for k in ("IS_proxy", "fid_proxy", "kid_proxy"))
    with np.load(folder / "report.npz") as z:
        assert float(z["fid_proxy"]) == report["fid_proxy"]
    np.savez(tmp_path / "narrow.npz", mu=np.zeros(8), sigma=np.eye(8))
    cfg.eval.stats_path = str(tmp_path / "narrow.npz")
    with pytest.raises(ValueError, match="must match"):
        run_lib.check_fid(cfg, folder, "cpu")


def test_evaluate_scores_snapshots_and_resumes(tmp_path, run, monkeypatch):
    cfg, workdir, _ = run
    cfg = tiny(get_config("cld/accr_dcifar10"), cfg.data.data_dir)
    cfg.model.dtype = "float32"
    cfg.eval.begin_ckpt, cfg.eval.end_ckpt = 0, 3
    cfg.eval.enable_sampling, cfg.eval.max_eval_batches = True, 2
    results = run_lib.evaluate(cfg, workdir, "ev", "cpu")
    assert sorted(results) == ["1", "2"]
    for entry in results.values():
        assert {"eval_loss", "fid_proxy", "IS_proxy", "kid_proxy"} <= set(entry)
        assert all(np.isfinite(entry[k]) for k in ("eval_loss", "fid_proxy"))
    meta = (workdir / "ev" / "eval_meta.json").read_text()

    def refuse(*a, **k):
        raise AssertionError("a finished checkpoint was restored again")

    monkeypatch.setattr(run_lib, "restore_state", refuse)
    assert run_lib.evaluate(cfg, workdir, "ev", "cpu") == results
    assert (workdir / "ev" / "eval_meta.json").read_text() == meta


def test_eval_mode_loss_is_the_loops(tmp_path, data_dir, monkeypatch):
    """The CLI's eval mode scores a snapshot at the training dtype (f32): on
    the batch and the t, z draws of the loop's first eval (step 4, saved as
    snapshot 1), its eval_loss is the loop's eval/score_loss."""
    cfg = tiny(train_config("cld/accr_dcifar10"), data_dir)
    cfg.training.n_iters, cfg.training.snapshot_sampling = 4, False
    # seeded weights (every layer drawn, the output layer too): eps is far
    # from 0, so the activations' dtype shows in the loss
    run_lib.train(cfg, tmp_path, "cpu", model=seeded_model(cfg, 0, "cpu"))
    (loop,) = [r["eval/score_loss"] for r in read_metrics(tmp_path) if "eval/score_loss" in r]
    # the loop's first eval draws from a fresh loop stream
    monkeypatch.setattr(run_lib, "STREAM_EVAL", run_lib.STREAM_LOOP)
    cli.main(["--mode", "eval", "--device", "cpu", "--workdir", str(tmp_path), "--set",
              "model.nf=16", "--set", "model.ch_mult=(1,2)", "--set", "model.num_res_blocks=1",
              "--set", "model.attn_resolutions=(8,)", "--set", "data.image_size=16", "--set",
              f"data.data_dir={data_dir}", "--set", "eval.begin_ckpt=1", "--set",
              "eval.end_ckpt=1", "--set", f"eval.batch_size={cfg.training.batch_size}", "--set",
              "eval.max_eval_batches=1"])
    meta = json.loads((tmp_path / "eval" / "eval_meta.json").read_text())
    assert meta["1"]["eval_loss"] == pytest.approx(loop, rel=1e-6)


def test_evaluate_and_train_leave_no_threads(tmp_path, run, data_dir):
    """A cut eval pass and a finished training run stop every batch thread."""
    _, workdir, _ = run
    before = threading.active_count()
    cfg = tiny(train_config("cld/accr_dcifar10"), data_dir)
    cfg.eval.begin_ckpt, cfg.eval.end_ckpt, cfg.eval.max_eval_batches = 1, 2, 1
    assert sorted(run_lib.evaluate(cfg, workdir, "ev_threads", "cpu")) == ["1", "2"]
    assert threading.active_count() == before
    cfg.training.n_iters, cfg.training.snapshot_sampling = 4, False
    run_lib.train(cfg, tmp_path, "cpu")
    assert threading.active_count() == before


def test_legacy_export_samples_as_the_snapshot(tmp_path, run):
    """A snapshot exported in the legacy layout and restored from the file
    samples the same bits from the same seed."""
    cfg, workdir, _ = run
    cfg = tiny(get_config("cld/accr_dcifar10"), cfg.data.data_dir)
    cfg.model.dtype, cfg.eval.num_samples = "float32", 2
    _, state = run_lib.restore_state(cfg, 2, workdir, "cpu")
    path = legacy.export_legacy_checkpoint(tmp_path / "checkpoint_8", state)
    a = run_lib.sample_data(cfg, 2, tmp_path / "snap", workdir, "cpu")
    b = run_lib.sample_data(cfg, str(path), tmp_path / "legacy", None, "cpu")
    for k, v in _samples(a[0]).items():
        np.testing.assert_array_equal(_samples(b[0])[k], v)


def test_cli_six_modes(tmp_path, data_dir):
    small = ["--set", "model.nf=16", "--set", "model.ch_mult=(1,2)", "--set",
             "model.num_res_blocks=1", "--set", "model.attn_resolutions=(8,)", "--set",
             "data.image_size=16", "--set", f"data.data_dir={data_dir}", "--set",
             "sampling.nfe=4", "--set", "sampling.deis_order=1", "--set", "model.dtype=float32",
             "--config.eval.num_samples=4", "--config.eval.batch_size=2"]
    work, res, stats = tmp_path / "w", tmp_path / "r", tmp_path / "stats.npz"
    cli.main(["--mode", "train", "--device", "cpu", "--workdir", str(work), "--steps", "4",
              "--batch", "4", "--set", "training.n_jitted_steps=2", "--set",
              "training.snapshot_freq=2", "--set", "training.snapshot_sampling=False", *small])
    assert {"stdout.txt", "metrics.jsonl", "params.pt", "ema.pt"} <= set(os.listdir(work))
    assert CheckpointManager(work).snapshot_steps() == [1, 2]
    cli.main(["--mode", "sampling", "--device", "cpu", "--workdir", str(work), "--ckpt", "2",
              "--result_folder", str(res), *small])
    assert sorted(os.listdir(res)) == ["samples_0.npz", "samples_1.npz"]
    cli.main(["--mode", "fid_stats", "--device", "cpu", "--workdir", str(work), "--set",
              f"eval.stats_path={stats}", *small])
    cli.main(["--mode", "fid", "--device", "cpu", "--workdir", str(work), "--result_folder",
              str(res), "--set", f"eval.stats_path={stats}", *small])
    with np.load(res / "report.npz") as z:
        assert np.isfinite(float(z["kid_proxy"]))
    cli.main(["--mode", "check", "--device", "cpu", "--workdir", str(work), "--ckpt", "1",
              "--result_folder", str(tmp_path / "r1"), "--set", f"eval.stats_path={stats}",
              *small])
    assert (tmp_path / "r1" / "report.npz").exists()
    cli.main(["--mode", "eval", "--device", "cpu", "--workdir", str(work), "--set",
              "eval.begin_ckpt=1", "--set", "eval.end_ckpt=2", "--set",
              "eval.max_eval_batches=1", *small])
    meta = json.loads((work / "eval" / "eval_meta.json").read_text())
    assert sorted(meta) == ["1", "2"] and "eval_loss" in meta["1"]


# the run fields the JAX configs do not hold (read there with getattr
# defaults, or the port's own)
RUN_PORT_ONLY = {("training", "fused_attn"), ("training", "profile_start"),
                 ("training", "profile_steps"), ("eval", "max_eval_batches")}


@pytest.mark.parametrize("name", ["cld/accr_dcifar10", "blur/ddpm_deep_cifar10"])
def test_run_config_fields_match_jax(name):
    """The loop's, eval's and mesh's fields carry the JAX configs' values."""
    import dataclasses

    got, want = get_config(name), jax_get_config(name)
    for section in ("training", "eval", "mesh"):
        for f in dataclasses.fields(getattr(got, section)):
            if (section, f.name) in RUN_PORT_ONLY:
                continue
            ours, theirs = getattr(getattr(got, section), f.name), getattr(want, section)[f.name]
            assert ours == theirs, (section, f.name, ours, theirs)
    for field in ("data_dir", "synthetic", "uniform_dequantization"):
        assert getattr(got.data, field) == want.data[field], field
    assert got.seed == want.seed and got.log_wandb is False


def test_cli_parsing_matches_jax():
    args = cli.parse_args(["--mode", "sampling", "--config.sampling.nfe=50",
                           "--config.sampling.method=sdeis", "--set", "optim.lr=0.001",
                           "--ckpt", "3", "--batch", "8"])
    cfg = cli.make_config(args)
    assert (cfg.sampling.nfe, cfg.sampling.method, cfg.optim.lr) == (50, "sdeis", 0.001)
    assert cfg.eval.batch_size == 8 and cfg.eval.num_samples == 50000
    cfg = cli.make_config(cli.parse_args(["--mode", "train", "--steps", "7", "--seed", "3"]))
    assert (cfg.training.n_iters, cfg.seed, cfg.model.dtype) == (7, 3, "float32")
    with pytest.raises(SystemExit):
        cli.parse_args(["--mode", "bench"])


@pytest.mark.parametrize("method,order,lam,denoise", [
    ("deis", 2, 1.0, True), ("sdeis", 3, 0.5, True), ("em", 1, 1.0, False),
    ("order0", 1, 1.0, True)])
def test_result_folder_naming_matches_jax(method, order, lam, denoise):
    cfg, jcfg = get_config("cld/accr_dcifar10"), jax_get_config("cld/default_cifar10")
    for c in (cfg, jcfg):
        c.sampling.method, c.sampling.nfe, c.sampling.deis_order = method, 50, order
        c.sampling.lambda_coef, c.sampling.noise_removal = lam, denoise
    got = cli.resolve_result_folder(cfg, None, "checkpoint_15")
    assert got == j_cli.resolve_result_folder(jcfg, None, "checkpoint_15")
    assert "nfe50" in got and cli.resolve_result_folder(cfg, "explicit", "x") == "explicit"


def test_images_and_logging(tmp_path, monkeypatch):
    from PIL import Image

    imgs = np.random.default_rng(0).uniform(0, 1, (5, 6, 7, 3)).astype(np.float32)
    grid = t_images.make_grid(imgs, nrow=2)
    np.testing.assert_array_equal(grid, j_images.make_grid(imgs, nrow=2))
    for arr in (imgs, imgs[..., :1]):
        t_images.save_image(arr, tmp_path / "g.png", nrow=2)
        want = (t_images.make_grid(arr, nrow=2) * 255).astype(np.uint8)
        got = np.asarray(Image.open(tmp_path / "g.png"))
        np.testing.assert_array_equal(got, want[..., 0] if arr.shape[-1] == 1 else want)
    log = MetricsLogger(tmp_path)
    log.log({"a": 1, "b": "x"}, 3)
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert (rec["step"], rec["a"], rec["b"]) == (3, 1.0, "x")
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    with pytest.raises(ImportError, match="wandb"):
        MetricsLogger(tmp_path / "w", enable_wandb=True)
    flat = flatten_config(get_config("cld/accr_dcifar10"))
    assert flat["sampling.nfe"] == 50 and flat["eval.num_samples"] == 50000


def test_run_keeps_no_stray_files(run):
    cfg, workdir, _ = run
    leftovers = [p for p in workdir.rglob("*") if p.name.startswith(".")]
    assert not leftovers  # no temporary file of a save is left behind
