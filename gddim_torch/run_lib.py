"""Run orchestration: train / evaluate / sampling / fid (counterpart of
``gddim_tpu/run_lib.py``).

Each process runs on one card (``device``: "cuda" is this rank's card,
unless the caller asks for the CPU). In a process group
(``parallel/multihost.py``; the CLI joins one from ``GDDIM_*`` variables)
training places the state as config.mesh says (``_place_train_state``:
data parallel, FSDP, channel TP or FSDP x TP; ``parallel/mesh.py``), each
rank reading its own shard of the corpus. Only the coordinator logs, writes
metrics, checkpoints and sample grids; every rank reaches each save through
a barrier. Sampling rounds are dealt out over the processes (round r to
rank r % n), each on its own card with the whole EMA; the eval loss is the
mean of the ranks' means; FID is scored on the coordinator.

Random streams: each is a ``torch.Generator`` on the device seeded from
(config.seed, stream[, round]) through numpy's SeedSequence: the training
state's (t, z, dropout; saved in every checkpoint), the loop's (eval losses
and samples during training; made anew on resume, as the JAX loop's key),
each sampling round's (round r draws the same samples whether or not the
rounds before it ran) and the eval loss's.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from gddim_torch.checkpoints import legacy as legacy_lib
from gddim_torch.checkpoints.manager import CheckpointManager, save_atomic
from gddim_torch.data.pipelines import (
    get_data_inverse_scaler,
    get_data_scaler,
    get_data_shape,
    get_dataset,
)
from gddim_torch.evals.features import get_feature_extractor, run_features
from gddim_torch.evals.fid import (
    activation_stats,
    frechet_distance,
    inception_score,
    kernel_distance,
    load_dataset_stats,
    save_dataset_stats,
)
from gddim_torch.math.blur import BlurSDE
from gddim_torch.math.cld import CLD
from gddim_torch.models.calibrate import calibrate_blur_qscales, calibrate_cld_qscales
from gddim_torch.models.registry import get_model
from gddim_torch.models.wrappers import make_blur_yeps_fn, make_cld_eps_fn
from gddim_torch.parallel import multihost
from gddim_torch.samplers.blur import build_blur_sampler_from_config
from gddim_torch.samplers.factory import build_cld_sampler
from gddim_torch.train.losses import make_loss_fn
from gddim_torch.train.state import (
    create_train_state,
    ema_state_dict,
    swap_params_from_ema,
    trainable,
)
from gddim_torch.train.step import make_eval_step, make_train_step
from gddim_torch.utils.images import save_image, save_pointset
from gddim_torch.utils.logging import MetricsLogger

logger = logging.getLogger("gddim_torch")

STREAM_TRAIN, STREAM_LOOP, STREAM_SAMPLES, STREAM_EVAL = 0, 1, 2, 3


def is_cld(config) -> bool:
    return str(config.sde).lower() == "cld"


def build_sde(config):
    return CLD.from_config(config) if is_cld(config) else BlurSDE.from_config(config)


def build_sampling_fn(config):
    """sample_fn(generator, model, batch_size, u0=None) -> (x in [0, 1], v,
    nfe) by the config's family; blur has no v (None)."""
    data_shape = get_data_shape(config)
    inverse_scaler = get_data_inverse_scaler(config)
    sde = build_sde(config)
    if is_cld(config):
        return build_cld_sampler(config, sde, make_cld_eps_fn(sde), data_shape, inverse_scaler)
    blur_fn = build_blur_sampler_from_config(config, sde, make_blur_yeps_fn(sde), data_shape,
                                             inverse_scaler)

    def sample_blur(generator, model, batch_size=None, u0=None):
        x, nfe = blur_fn(generator, model, batch_size, u0)
        return x, None, nfe

    return sample_blur


def calibrate_int8(config, model, seed: int = 0) -> float:
    """Calibrate the int8 static activation scales into ``model.qscales``
    with the config family's calibration; returns the seconds it took."""
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(seed)
    if is_cld(config):
        model.qscales = calibrate_cld_qscales(config, model, CLD.from_config(config),
                                              generator=generator)
    else:
        model.qscales = calibrate_blur_qscales(config, model, BlurSDE.from_config(config),
                                               generator=generator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    logger.info("calibrated the int8 scales of %d blocks in %.2f s", len(model.qscales), seconds)
    return seconds


def stream_generator(device, seed: int, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, *key), one stream a key."""
    s = int(np.random.SeedSequence([int(seed), *key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & (2**63 - 1))


def _place_train_state(config, model, layout: str | None = None):
    """(model, placement) of a training run (``gddim_tpu/run_lib.py:93-146``):
    outside a process group (None) the model as it is; in one, placed on the
    ranks by config.mesh (``fsdp_axis`` and ``tp_axis`` ranks, the rest
    'data'), or by ``layout`` ('data', 'fsdp', 'tp', 'fsdp_tp'), which
    takes that layout even where its axes have one rank."""
    n_fsdp = max(1, int(config.mesh.fsdp_axis or 1))
    n_tp = max(1, int(config.mesh.tp_axis or 1))
    if not multihost.is_distributed():
        if layout is not None or n_fsdp * n_tp > 1:
            raise ValueError(f"mesh.fsdp_axis={n_fsdp}, mesh.tp_axis={n_tp}, layout {layout}: "
                             "one process does not split; run it in a process group "
                             "(GDDIM_NUM_PROCESSES, cli.py)")
        return model, None
    from gddim_torch.parallel.mesh import place_model

    device = next(model.parameters()).device
    return place_model(model, n_fsdp, n_tp, layout, device_type=device.type)


class _Silent:
    """The metrics logger of a rank that is not the coordinator."""

    def log(self, *args, **kwargs):
        pass

    log_image = log

    def close(self):
        pass


def init_model(config, device, weights: str | None = None):
    """The model to train (``model.name`` in the registry: 'ncsnpp' or
    'ps_fmlp'): the config's own initialisation drawn on the CPU from
    config.seed (any device gets the same weights), or a state_dict file."""
    if weights is not None:
        model = empty_model(config, device)
        model.load_state_dict(torch.load(weights, map_location=device, weights_only=True))
        return model
    generator = torch.Generator().manual_seed(int(config.seed))
    return get_model(config.model.name)(config, generator=generator).to(device)


def empty_model(config, device):
    """The configured model on ``device`` with uninitialised parameters (to
    be loaded); draws nothing from any generator."""
    with torch.device("meta"):
        model = get_model(config.model.name)(config)
    return model.to_empty(device=device)


def save_samples_figure(x: np.ndarray, path) -> None:
    """A sample grid of images (the first 64), or the point set's figure
    (``save_pointset``), as the JAX loop writes them (``run_lib.py:326-330``)."""
    if x.ndim == 4:
        save_image(x[:64], path)
    else:
        save_pointset(x, path)


@contextlib.contextmanager
def ema_weights(state):
    """The model holds the EMA inside the block, its own weights after: the
    tensors are exchanged, not copied."""
    params = trainable(state.model)

    def swap():
        with torch.no_grad():
            for n, p in params.items():
                p.data, state.ema[n] = state.ema[n], p.data

    swap()
    try:
        yield state.model
    finally:
        swap()


@contextlib.contextmanager
def _ema_model(config, state, device, only_coordinator: bool = False):
    """The EMA model to evaluate or sample with: the state's model holding
    its EMA (``ema_weights``) or, under a sharded placement, a whole copy
    made from the gathered EMA (a collective: every rank enters). With
    ``only_coordinator`` the other ranks get None."""
    if state.placement is not None and state.placement.shards_state:
        sd = ema_state_dict(state)
        if only_coordinator and not multihost.is_coordinator():
            yield None
            return
        model = empty_model(config, device)
        model.load_state_dict(sd)
        yield model.eval()
    elif only_coordinator and not multihost.is_coordinator():
        yield None
    else:
        with ema_weights(state) as model:
            yield model


@torch.no_grad()
def use_ema(state):
    """Copy the EMA into the model's parameters (for sampling and scoring)."""
    for n, p in trainable(state.model).items():
        p.copy_(state.ema[n])
    return state.model


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _acts(cur: int, freq: int, n_jitted: int) -> bool:
    return cur % freq < n_jitted


def train(config, workdir: str, device="cuda", model=None, layout: str | None = None):
    """The training loop: resume from the latest meta checkpoint, then
    ``n_jitted_steps`` optimizer steps a call up to training.n_iters, with
    logging, preemption checkpoints, the EMA swap, eval losses, numbered
    snapshots and sample grids at their frequencies; a final meta checkpoint
    at n_iters. ``model``: a model to train (else ``init_model``), alike on
    every rank; ``layout``: ``_place_train_state``'s. Returns the
    TrainState."""
    device = multihost.local_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    metrics = (MetricsLogger(workdir, enable_wandb=bool(config.log_wandb),
                             project=f"gddim_torch_{config.sde}", config=config)
               if multihost.is_coordinator() else _Silent())
    try:
        return _train(config, workdir, device, model, metrics, layout)
    finally:
        metrics.close()


def _train(config, workdir: Path, device, model, metrics, layout=None):
    if model is None:
        model = init_model(config, device)
    logger.info("model %s: %.2fM params", config.model.name,
                sum(p.numel() for p in model.parameters()) / 1e6)
    model, placement = _place_train_state(config, model, layout)
    state = create_train_state(config, model, stream_generator(device, config.seed, STREAM_TRAIN),
                               placement)
    mgr = CheckpointManager(workdir)
    state, _ = mgr.restore_latest_meta(state)
    n_jitted = int(config.training.n_jitted_steps)
    deq = bool(config.data.uniform_dequantization)
    shard = placement.batch_shard() if placement is not None else None
    train_iter, _ = get_dataset(config, additional_dim=n_jitted, uniform_dequantization=deq,
                                shard=shard)
    _, eval_iter = get_dataset(config, additional_dim=None, uniform_dequantization=deq,
                               shard=shard)
    try:
        return _loop(config, workdir, device, state, mgr, metrics, train_iter, eval_iter)
    finally:
        train_iter.close()
        eval_iter.close()


def _loop(config, workdir: Path, device, state, mgr, metrics, train_iter, eval_iter):
    initial_step = state.step
    tc = config.training
    n_jitted = int(tc.n_jitted_steps)
    scaler = get_data_scaler(config)

    def put(batch):
        """The scaled batch on the device; from pinned memory on a card, so
        the copy does not wait for the queued steps."""
        x = torch.from_numpy(scaler(batch["image"]))
        if device.type == "cuda":
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    train_step = make_train_step(make_loss_fn(config, train=True))
    eval_loss_fn = make_loss_fn(config, train=False)
    eval_step = make_eval_step(eval_loss_fn)
    sampling_fn = build_sampling_fn(config) if tc.snapshot_sampling else None
    loop_gen = stream_generator(device, config.seed, STREAM_LOOP)

    n_iters, log_freq, eval_freq = int(tc.n_iters), int(tc.log_freq), int(tc.eval_freq)
    snapshot_freq, preempt_freq = int(tc.snapshot_freq), int(tc.snapshot_freq_for_preemption)
    ema_update_freq, sampling_freq = int(tc.ema_update_freq), int(tc.snapshot_freq_for_sampling)
    profile_start, profile_steps = int(tc.profile_start), int(tc.profile_steps)
    profiler = None

    logger.info("starting training at step %d", initial_step)
    t_last = time.time()
    for step in range(initial_step, n_iters, n_jitted):
        if profile_start >= 0 and profiler is None and step >= profile_start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        info = train_step(state, put(next(train_iter)))
        cur = step + n_jitted
        if profiler is not None and step >= profile_start + profile_steps:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
            trace = workdir / "profile" / f"trace_{cur}.json"
            trace.parent.mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(trace))
            logger.info("wrote a torch.profiler trace to %s", trace)
            profiler, profile_start = None, -1

        if _acts(cur, log_freq, n_jitted):
            loss = float(info["loss"])
            dt = time.time() - t_last
            t_last = time.time()
            ips = tc.batch_size * log_freq / max(dt, 1e-9)
            logger.info("step %d loss %.5f (%.1f img/s)", cur, loss, ips)
            metrics.log({"train/score_loss": loss, "train/imgs_per_sec": ips}, cur)

        if _acts(cur, preempt_freq, n_jitted):
            mgr.save_meta(cur, state)

        # occasional params <- EMA with a fresh optimizer
        if step != initial_step and _acts(cur, ema_update_freq, n_jitted):
            swap_params_from_ema(state)
            logger.info("step %d: update params from ema", cur)

        if _acts(cur, eval_freq, n_jitted):
            images = put(next(eval_iter))
            if state.placement is not None and state.placement.shards_state:
                with _ema_model(config, state, device) as ema_model, torch.no_grad():
                    loss = eval_loss_fn(ema_model, images, loop_gen)
            else:
                loss = eval_step(state, images, loop_gen)
            # each rank's own eval batch: their mean
            loss = multihost.allgather_metrics({"loss": float(loss)})["loss"]
            metrics.log({"eval/score_loss": loss}, cur)

        if _acts(cur, snapshot_freq, n_jitted):
            mgr.save_snapshot(cur // snapshot_freq, state)

        if sampling_fn is not None and _acts(cur, sampling_freq, n_jitted):
            # a collective under a sharded placement; the coordinator samples
            with _ema_model(config, state, device, only_coordinator=True) as ema_model:
                if ema_model is not None:
                    x = sampling_fn(loop_gen, ema_model, int(tc.snapshot_sampling_batch))[0]
                    path = workdir / "samples" / f"iter_{cur}" / "sample.png"
                    save_samples_figure(x.float().cpu().numpy(), path)
                    metrics.log_image("samples", path, cur)
            multihost.barrier("snapshot_sampled")

    mgr.save_meta(n_iters, state)
    return state


# ---------------------------------------------------------------------------
# sampling / FID
# ---------------------------------------------------------------------------


def restore_state(config, ckpt, workdir: str | None = None, device="cuda"):
    """(model, TrainState) from a legacy checkpoint file, or a snapshot id of
    ``workdir``'s run. Draws nothing from torch's global generators."""
    device = torch.device(device)
    model = empty_model(config, device)
    state = create_train_state(config, model, stream_generator(device, config.seed, STREAM_TRAIN))
    path = Path(str(ckpt))
    if path.is_file():
        legacy_lib.into_train_state(legacy_lib.load_legacy_checkpoint(path), state)
        return model, state
    if workdir is None:
        raise ValueError("a numeric checkpoint id needs --workdir")
    CheckpointManager(workdir).restore_snapshot(int(ckpt), state)
    return model, state


def ready_to_sample(config, state, static: bool = True):
    """The state's model holding its EMA, with int8 static scales
    calibrated (``fused_int8``, unless ``static`` is off)."""
    model = use_ema(state)
    if config.model.conv_impl == "fused_int8" and static:
        calibrate_int8(config, model, int(config.seed))
    return model


def _save_npz(path: Path, **arrays) -> None:
    save_atomic(path, lambda f: np.savez_compressed(f, **arrays))


def sampling_from_fn(config, sampling_fn, model, result_folder, num_samples: int,
                     batch_size: int, seed: int = 0, is_continue: bool = True) -> list[Path]:
    """Write ceil(num_samples / batch_size) rounds of samples as
    ``samples_<r>.npz`` (uint8 images, nfe, CLD's v); with ``is_continue`` a
    round already on disk is skipped. Returns every round's path. Point sets
    (x of shape (B, dim)) also keep their f32 values (``points``) and the
    figure ``samples_<r>.png`` (``save_pointset``): the uint8 values, which
    the JAX package writes for them too, clip the points to [0, 1].

    In a process group round r belongs to rank r % n, each rank writing its
    own files into the shared folder, and every rank leaves through a
    barrier once all rounds exist. Round r's generator is keyed by r, so its
    samples do not depend on the number of processes."""
    result_folder = Path(result_folder)
    result_folder.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    n_rounds = int(np.ceil(num_samples / batch_size))
    nproc, pidx = multihost.process_count(), multihost.process_index()
    paths = []
    for r in range(n_rounds):
        out_path = result_folder / f"samples_{r}.npz"
        paths.append(out_path)
        if r % nproc != pidx or (is_continue and out_path.exists()):
            continue
        t0 = time.time()
        x, v, nfe = sampling_fn(stream_generator(device, seed, STREAM_SAMPLES, r), model,
                                batch_size)
        x = x.float().cpu().numpy()
        if not np.isfinite(x).all():
            # the uint8 cast below would hide them
            logger.warning("round %d: %d non-finite sample values before uint8 cast",
                           r + 1, int((~np.isfinite(x)).sum()))
        extra = {} if v is None else {"v": v.float().cpu().numpy()}
        if x.ndim == 2:
            extra["points"] = x
            save_samples_figure(x, result_folder / f"samples_{r}.png")
        x8 = np.clip(x * 255.0, 0, 255).astype(np.uint8)
        _save_npz(out_path, samples=x8, nfe=nfe, **extra)
        logger.info("round %d/%d: %d samples in %.1fs (nfe=%s)", r + 1, n_rounds, batch_size,
                    time.time() - t0, nfe)
    multihost.barrier("sampling_rounds_done")
    return paths


def sample_data(config, ckpt, result_folder, workdir: str | None = None, device="cuda",
                static: bool = True) -> list[Path]:
    """eval.num_samples samples from a checkpoint's EMA, eval.batch_size a
    round, resuming a folder's earlier rounds (nothing is restored when all
    are on disk)."""
    n, batch = int(config.eval.num_samples), int(config.eval.batch_size)
    paths = [Path(result_folder) / f"samples_{r}.npz" for r in range(int(np.ceil(n / batch)))]
    if all(p.exists() for p in paths):
        multihost.barrier("sampling_rounds_done")
        return paths
    model = ready_to_sample(config, restore_state(config, ckpt, workdir, device)[1], static)
    return sampling_from_fn(config, build_sampling_fn(config), model, result_folder, n, batch,
                            seed=int(config.seed))


def _load_samples(result_folder: Path):
    files = sorted(result_folder.glob("samples_*.npz"), key=lambda p: int(p.stem.split("_")[1]))
    if not files:
        raise FileNotFoundError(f"no samples_*.npz under {result_folder}")
    arrays, nfe = [], 0
    for f in files:
        with np.load(f) as z:
            arrays.append(z["samples"])
            nfe = int(np.asarray(z["nfe"]))
    return np.concatenate(arrays), nfe


def check_fid(config, result_folder, device="cuda") -> dict:
    """IS and FID (and KID, where the reference pools exist) of a folder's
    samples against the dataset's statistics; writes report.npz. With the
    proxy extractor every score's key ends in ``_proxy``: it is not
    comparable to a published FID."""
    result_folder = Path(result_folder)
    samples, nfe = _load_samples(result_folder)
    samples = samples[: int(config.eval.num_samples)]
    extractor = get_feature_extractor(config, device)
    pools, logits = run_features(extractor, samples)

    ref_pools = None
    stats_path = str(config.eval.stats_path or "")
    if stats_path and Path(stats_path).exists():
        mu_ref, sigma_ref = load_dataset_stats(stats_path)
        with np.load(stats_path) as z:
            if "pool_3" in z:
                ref_pools = z["pool_3"]
        if mu_ref.shape[0] != extractor.feature_dim:
            raise ValueError(
                f"stats file {stats_path} has {mu_ref.shape[0]}-d features but extractor "
                f"'{extractor.name}' emits {extractor.feature_dim}-d: stats and extractor "
                "must match")
    else:
        logger.warning("no stats file; computing dataset stats on the fly")
        mu_ref, sigma_ref, ref_pools = _dataset_stats(config, extractor, return_pools=True)

    mu, sigma = activation_stats(pools)
    suffix = "_proxy" if extractor.name == "proxy" else ""
    if suffix:
        logger.warning("scoring with the PROXY extractor: fid_proxy is not comparable to "
                       "published FID numbers (set eval.inception_weights for real FID)")
    report = {
        f"IS{suffix}": inception_score(logits),
        f"fid{suffix}": frechet_distance(mu, sigma, mu_ref, sigma_ref),
        "nfe": nfe,
        "extractor": extractor.name,
        "n": len(samples),
    }
    if ref_pools is not None:
        report[f"kid{suffix}"] = kernel_distance(ref_pools, pools)
    np.savez(result_folder / "report.npz", **report)
    logger.info("FID report: %s", report)
    return report


def _dataset_stats(config, extractor, return_pools: bool = False):
    """Activation statistics over one epoch of the train split."""
    train_iter, _ = get_dataset(config, evaluation=True)
    images = np.concatenate([(batch["image"] * 255).astype(np.uint8) for batch in train_iter])
    pools, _ = run_features(extractor, images)
    mu, sigma = activation_stats(pools)
    return (mu, sigma, pools) if return_pools else (mu, sigma)


def fid_stats(config, out_path: str | None = None, device="cuda") -> str:
    """Write the dataset's activation statistics and raw pool_3 (for KID) to
    ``out_path``, else eval.stats_path, else a name that carries the
    extractor's under assets/stats/."""
    extractor = get_feature_extractor(config, device)
    mu, sigma, pools = _dataset_stats(config, extractor, return_pools=True)
    out = Path(out_path or config.eval.stats_path or (
        Path("assets/stats")
        / f"{config.data.dataset.lower()}_{config.data.image_size}_{extractor.name}_stats.npz"))
    save_dataset_stats(out, mu, sigma, pools=pools)
    logger.info("wrote dataset stats to %s", out)
    return str(out)


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------


def evaluate(config, workdir: str, eval_folder: str = "eval", device="cuda") -> dict:
    """Checkpoints eval.begin_ckpt..end_ckpt: the loss over the eval split
    (cut at eval.max_eval_batches when > 0) and, with eval.enable_sampling,
    samples and their scores. ``config`` is the one the run trained with
    (``train_config``: f32 activations, as the loop's eval loss and the JAX
    package's evaluate run). Every checkpoint's loss sees the same batches,
    read once. eval_meta.json records each finished checkpoint, so a rerun
    computes only the rest."""
    device = multihost.local_device(device)
    workdir = Path(workdir)
    eval_dir = workdir / eval_folder
    eval_dir.mkdir(parents=True, exist_ok=True)
    meta_path = eval_dir / "eval_meta.json"
    done = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    available = set(CheckpointManager(workdir).snapshot_steps())
    todo = [c for c in range(int(config.eval.begin_ckpt), int(config.eval.end_ckpt) + 1)
            if c in available]
    batches = []
    if config.eval.enable_loss and any(str(c) not in done for c in todo):
        _, eval_iter = get_dataset(config, evaluation=True, prefetch=False)
        max_batches = int(config.eval.max_eval_batches or 0)
        scaler = get_data_scaler(config)
        batches = [torch.from_numpy(scaler(b["image"]))
                   for b in itertools.islice(eval_iter, max_batches or None)]
        del eval_iter
    results = {}
    for ckpt_id in todo:
        key = str(ckpt_id)
        if key in done:
            results[key] = done[key]
            continue
        model, state = restore_state(config, ckpt_id, workdir, device)
        entry = {}
        if config.eval.enable_loss:
            eval_step = make_eval_step(make_loss_fn(config, train=False))
            gen = stream_generator(device, config.seed, STREAM_EVAL)
            local = float(np.mean(
                [float(eval_step(state, images.to(device), gen)) for images in batches]))
            entry.update(multihost.allgather_metrics({"eval_loss": local}))  # each rank's shard
        if config.eval.enable_sampling:
            ready_to_sample(config, state)
            folder = eval_dir / f"ckpt_{ckpt_id}"
            sampling_from_fn(config, build_sampling_fn(config), model, folder,
                             int(config.eval.num_samples), int(config.eval.batch_size),
                             seed=int(config.seed))
            if multihost.is_coordinator():
                entry.update({k: v if isinstance(v, (str, int)) else float(v)
                              for k, v in check_fid(config, folder, device).items()})
            multihost.barrier("fid_scored")
        del model, state
        results[key] = done[key] = entry
        if multihost.is_coordinator():
            text = json.dumps(done, indent=2).encode()
            save_atomic(meta_path, lambda f: f.write(text))
        logger.info("ckpt %d: %s", ckpt_id, entry)
    return results
