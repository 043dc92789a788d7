"""Command line of the port (counterpart of ``gddim_tpu/cli.py``).

    python -m gddim_torch.cli --config cld/accr_dcifar10 \\
        --mode {train,eval,sampling,fid,check,fid_stats} \\
        --workdir logs/run1 --ckpt 15 --result_folder out \\
        --set sampling.nfe=50 --set data.data_dir=/data/cifar10

The modes, over ``run_lib``:
  train      the training loop in --workdir (resumes its meta checkpoint;
             local data under data.data_dir, else the synthetic corpus); it
             ends by writing the final weights and their EMA as params.pt and
             ema.pt, state_dict files that --weights reads;
  eval       loss, samples and scores of the snapshots eval.begin_ckpt ..
             eval.end_ckpt into --workdir/--eval_folder (resumable), under
             the training config (f32 activations), as the loop's eval loss;
  sampling   eval.num_samples samples in rounds of eval.batch_size from the
             EMA of --ckpt: a snapshot id of --workdir's run or a legacy
             (flax msgpack) checkpoint file; without --ckpt, from --weights
             (a state_dict) or weights seeded from config.seed;
  fid        IS, FID and KID of the result folder's samples
             (eval.inception_weights, else the proxy extractor);
  check      sampling, then fid;
  fid_stats  the dataset's activation statistics to eval.stats_path.
The result folder is --result_folder (or --out), else a name made from the
sampler's settings under results/. The JAX package's flags --workdir,
--ckpt, --result_folder, --eval_folder, --wandb; ``--set key=value`` (or
``--config.key=value``) overrides a config field. Shorthands: --out (the
workdir of train, the result folder of sampling), --steps
(training.n_iters), --batch (training.batch_size in train, eval.batch_size
in sampling), --rounds (sampling: eval.num_samples = rounds x batch; 1 by
default without --ckpt), --seed (config.seed), --weights.

Sampling runs the config's ``model.conv_impl``; with 'fused_int8' the
int8 static activation scales are calibrated once per model first
(``models/calibrate.py``), unless ``--no-static`` asks for per-sample
scales. Training runs f32 activations, the stride-1 residual blocks through
K6/K7 when ``model.fused_train``; eval's losses and samples run the same f32
activations. Everything runs on the CUDA card unless
``--device cpu`` is given. The published checkpoints, CIFAR-10, its FID
statistics and Inception weights are not in the repository.

Several processes, one a card, run one job as the JAX package's hosts do,
from the environment, read before any device is touched:
GDDIM_NUM_PROCESSES (the count), GDDIM_PROCESS_ID (this one's rank),
GDDIM_COORDINATOR (host:port of rank 0's rendezvous) and GDDIM_DIST_BACKEND
('nccl', the default on CUDA, or 'gloo', the CPU's, which also lets two
ranks share one card). ``--device cuda`` is then this rank's card; training
shards as config.mesh says (``--set mesh.fsdp_axis=2``, ``mesh.tp_axis``);
sampling deals its rounds out over the ranks; only rank 0 writes logs,
checkpoints and scores. A coordinator with one process makes a group of
one.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import os
import sys
from pathlib import Path

import torch

from gddim_torch import run_lib
from gddim_torch.configs import get_config, train_config
from gddim_torch.models.init import seeded_model
from gddim_torch.parallel import multihost
from gddim_torch.run_lib import build_sampling_fn, calibrate_int8
from gddim_torch.train.state import ema_state_dict

logger = logging.getLogger("gddim_torch")

MODES = ("train", "eval", "sampling", "fid", "check", "fid_stats")


def build_model(config, device, weights: str | None = None, seed: int = 0):
    """The configured NCSNpp on ``device``: from a state_dict file, or seeded."""
    if weights is None:
        return seeded_model(config, seed, device)
    model = run_lib.empty_model(config, device)
    model.load_state_dict(torch.load(weights, map_location=device, weights_only=True))
    return model.eval()


def resolve_result_folder(config, base: str | None, ckpt) -> str:
    """The result folder: ``base``, else one named after the sampler's settings."""
    if base:
        return base
    s = config.sampling
    name = f"ckpt{Path(str(ckpt)).name}_{s.method}_nfe{s.nfe}"
    if s.method in ("deis", "hybdeis", "mldeis", "ldeis", "sdeis"):
        name += f"_order{s.deis_order}_ts{s.ts_order}"
    if s.method in ("sdeis", "em"):
        name += f"_lam{s.lambda_coef}"
    if s.noise_removal:
        name += "_denoise"
    return str(Path("results") / name)


def _override(config, item: str):
    """Apply one ``section.field=value`` override (value a Python literal)."""
    key, _, raw = item.partition("=")
    *path, field = key.split(".")
    node = config
    for part in path:
        node = getattr(node, part)
    if not hasattr(node, field):
        raise SystemExit(f"--set {item}: unknown config field {key}")
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    types = {f.name: f.type for f in dataclasses.fields(node)}
    if types.get(field) in (bool, "bool") and isinstance(value, str):
        if value.lower() not in ("true", "false"):
            raise SystemExit(f"--set {item}: {key} takes true or false")
        value = value.lower() == "true"
    setattr(node, field, value)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="cld/accr_dcifar10")
    parser.add_argument("--mode", choices=MODES, default="sampling")
    parser.add_argument("--workdir", default=None, help="the run's directory (train, eval, "
                        "a snapshot --ckpt; stdout.txt); default --out, else logs/default")
    parser.add_argument("--ckpt", default=None,
                        help="snapshot id (with --workdir) or path to a legacy checkpoint file")
    parser.add_argument("--result_folder", default=None)
    parser.add_argument("--eval_folder", default="eval")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--out", default=None, help="train: the workdir; sampling: the folder")
    parser.add_argument("--weights", default=None,
                        help="a state_dict file: sampling's model without --ckpt, train's start")
    parser.add_argument("--steps", type=int, default=None, help="train: training.n_iters")
    parser.add_argument("--batch", type=int, default=None,
                        help="train: training.batch_size; sampling: eval.batch_size")
    parser.add_argument("--rounds", type=int, default=None,
                        help="sampling: eval.num_samples = rounds x batch")
    parser.add_argument("--seed", type=int, default=None, help="config.seed")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-static", action="store_true",
                        help="fused_int8 sampling: per-sample activation scales, no calibration")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config field, e.g. model.nf=32")
    argv = list(sys.argv[1:] if argv is None else argv)
    # the JAX package's --config.<path>=<value> overrides
    sets = [a[len("--config."):] for a in argv if a.startswith("--config.")]
    args = parser.parse_args([a for a in argv if not a.startswith("--config.")])
    args.set = sets + args.set
    return args


def make_config(args):
    config = (train_config if args.mode in ("train", "eval") else get_config)(args.config)
    for item in args.set:
        _override(config, item)
    if args.seed is not None:
        config.seed = args.seed
    if args.wandb:
        config.log_wandb = True
    if args.mode == "train":
        if args.steps is not None:
            config.training.n_iters = args.steps
        if args.batch is not None:
            config.training.batch_size = args.batch
    elif args.mode in ("sampling", "check"):
        seeded = args.ckpt is None  # a smoke run: one round of 16 unless told
        if args.batch is not None or seeded:
            config.eval.batch_size = args.batch or 16
        if args.rounds is not None or seeded:
            config.eval.num_samples = (args.rounds or 1) * config.eval.batch_size
    elif args.batch is not None:
        config.eval.batch_size = args.batch
    return config


def join_process_group(device: str) -> bool:
    """Join the process group the GDDIM_* variables describe (a no-op
    without them); returns whether a group was made."""
    env = os.environ
    if "GDDIM_NUM_PROCESSES" not in env and "GDDIM_COORDINATOR" not in env:
        return False
    return multihost.initialize_distributed(
        coordinator=env.get("GDDIM_COORDINATOR"),
        num_processes=int(env.get("GDDIM_NUM_PROCESSES", "1")),
        process_id=int(env.get("GDDIM_PROCESS_ID", "0")),
        backend=env.get("GDDIM_DIST_BACKEND") or None, device=device)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    joined = join_process_group(args.device)
    try:
        device = multihost.local_device(args.device)
        config = make_config(args)
        workdir = Path(args.workdir or args.out or "logs/default")
        workdir.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(workdir / "stdout.txt")
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logging.getLogger().addHandler(handler)
        try:
            _run(args, config, workdir, device)
        finally:
            logging.getLogger().removeHandler(handler)
            handler.close()
    finally:
        if joined:
            multihost.shutdown()


def _run(args, config, workdir: Path, device):
    mode = args.mode
    if mode == "train":
        model = run_lib.init_model(config, device, args.weights)
        state = run_lib.train(config, workdir, device, model=model)
        params, ema = state.model_state_dict(), ema_state_dict(state)  # whole: collectives
        if multihost.is_coordinator():
            torch.save({k: v.detach().cpu() for k, v in params.items()}, workdir / "params.pt")
            torch.save({k: v.detach().cpu() for k, v in ema.items()}, workdir / "ema.pt")
        multihost.barrier("weights_saved")
        return
    if mode == "eval":
        run_lib.evaluate(config, workdir, args.eval_folder, device)
        return
    if mode == "fid_stats":
        if multihost.is_coordinator():
            run_lib.fid_stats(config, device=device)
        multihost.barrier("fid_stats_done")
        return
    folder = resolve_result_folder(config, args.result_folder or args.out,
                                   args.ckpt or args.weights or "seeded")
    if mode in ("sampling", "check"):
        if args.ckpt is not None:
            run_lib.sample_data(config, args.ckpt, folder, workdir, device,
                                static=not args.no_static)
        else:
            model = build_model(config, device, args.weights, config.seed)
            if config.model.conv_impl == "fused_int8" and not args.no_static:
                calibrate_int8(config, model, config.seed)
            run_lib.sampling_from_fn(config, build_sampling_fn(config), model, folder,
                                     int(config.eval.num_samples), int(config.eval.batch_size),
                                     seed=config.seed, is_continue=False)
    if mode in ("fid", "check"):
        if multihost.is_coordinator():
            run_lib.check_fid(config, folder, device)
        multihost.barrier("fid_scored")


if __name__ == "__main__":
    main()
