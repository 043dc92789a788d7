"""Command line: CLD and blur sampling and training with the port.

    python -m gddim_torch.cli --config cld/accr_dcifar10 --mode sampling \\
        --batch 16 --seed 0 --out samples/ [--weights model.pt] [--rounds 1]
    python -m gddim_torch.cli --config blur/ddpm_deep_cifar10 --mode sampling \\
        --batch 16 --seed 0 --out samples/ [--set model.conv_impl=int8]
    python -m gddim_torch.cli --config cld/accr_dcifar10 --mode sampling \\
        --batch 16 --out samples/ --set sampling.method=sdeis
    python -m gddim_torch.cli --config cld/accr_dcifar10 --mode train \\
        --steps 10 --batch 128 --seed 0 --out run/ [--weights model.pt]
    python -m gddim_torch.cli --config blur/ddpm_deep_cifar10 --mode train \\
        --steps 10 --batch 128 --out run/ [--set model.fused_train=true]

Sampling, by the config's family and ``sampling.method``: the nine CLD
samplers of ``samplers/factory.py:CLD_SAMPLERS`` (order0, deis, hybdeis,
mldeis, sdeis, ldeis, ode, sscs, em; the stochastic ones draw their noise
from the ``--seed`` generator) or blur order-0 and frequency-space deis in
DCT space (``samplers/blur.py``). Weights are seeded
(``models/init.py``) unless ``--weights`` names a ``state_dict`` file
(``torch.save`` of ``convert.flax_to_state_dict``, or a ``--mode train``
output). Each round writes ``samples_<r>.npz`` holding uint8 images and nfe
(and CLD's v), as the JAX package's ``run_lib.sampling_from_fn`` does.
``--set model.conv_impl=...`` picks the network's kernels (``configs.py``):
with 'fused_int8' the whole-block kernels' int8 modes run with static
activation scales calibrated first (``models/calibrate.py``, the family's
calibration, seeded by ``--seed``), as ``bench.py`` does, unless
``--no-static`` asks for per-sample scales; 'int8' (layer-wise, per-sample
scales) and 'pallas' need no calibration.

Training: ``--steps`` Adam steps (``train/``, the family's loss) on the
synthetic image stream (``data/synthetic.py``), f32 activations, the
stride-1 residual blocks through K6/K7 when ``model.fused_train`` (CLD's
default; blur's is off: their unfused layers, K1 for the GroupNorms),
``training.n_jitted_steps`` steps
per ``train_step`` call, from the config's own initialisation drawn from
``--seed`` (or ``--weights``). Writes ``params.pt`` and ``ema.pt``, both
``state_dict`` files that ``--mode sampling --weights`` reads. No preemption
checkpoints.

``--set key=value`` overrides a config field (``--set model.nf=32``), for a
small model on the CPU; ``--set model.transition_impl=full`` runs the
up/down blocks of 'fused' and 'fused_int8' sampling through K9, and
``--set training.fused_attn=true`` the training step's attention through K10.
Needs a CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import ast
import logging
import time
from pathlib import Path

import numpy as np
import torch

from gddim_torch.configs import get_config, train_config
from gddim_torch.data.synthetic import SyntheticStream, get_data_scaler
from gddim_torch.math.blur import BlurSDE
from gddim_torch.math.cld import CLD
from gddim_torch.models.calibrate import calibrate_blur_qscales, calibrate_cld_qscales
from gddim_torch.models.init import seeded_model
from gddim_torch.models.unet import NCSNpp
from gddim_torch.models.wrappers import make_blur_yeps_fn, make_cld_eps_fn
from gddim_torch.samplers.blur import build_blur_sampler_from_config
from gddim_torch.samplers.factory import build_cld_sampler
from gddim_torch.train.losses import make_loss_fn
from gddim_torch.train.state import create_train_state, ema_state_dict
from gddim_torch.train.step import make_train_step

logger = logging.getLogger("gddim_torch")


def build_model(config, device, weights: str | None = None, seed: int = 0):
    """The configured NCSNpp on ``device``: from a state_dict file, or seeded."""
    if weights is None:
        return seeded_model(config, seed, device)
    with torch.device("meta"):
        model = NCSNpp(config)
    model = model.to_empty(device=device)
    model.load_state_dict(torch.load(weights, map_location=device, weights_only=True))
    return model.eval()


def build_sampling_fn(config):
    """sample_fn(generator, model, batch_size, u0=None) -> (x in [0, 1], v,
    nfe) by the config's family; blur has no v (None)."""
    size = config.data.image_size
    data_shape = (size, size, config.data.num_channels)
    inverse_scaler = (lambda x: (x + 1.0) / 2.0) if config.data.centered else (lambda x: x)
    if config.sde != "blur":
        sde = CLD.from_config(config)
        return build_cld_sampler(config, sde, make_cld_eps_fn(sde), data_shape, inverse_scaler)
    sde = BlurSDE.from_config(config)
    blur_fn = build_blur_sampler_from_config(config, sde, make_blur_yeps_fn(sde), data_shape,
                                             inverse_scaler)

    def sample_blur(generator, model, batch_size=None, u0=None):
        x, nfe = blur_fn(generator, model, batch_size, u0)
        return x, None, nfe

    return sample_blur


def sample_data(config, model, out_dir: Path, batch: int, rounds: int, seed: int,
                device) -> list[Path]:
    """Write ``rounds`` files of ``batch`` samples each; returns their paths."""
    out_dir.mkdir(parents=True, exist_ok=True)
    sample_fn = build_sampling_fn(config)
    generator = torch.Generator(device=device).manual_seed(seed)
    paths = []
    for r in range(rounds):
        t0 = time.perf_counter()
        x, v, nfe = sample_fn(generator, model, batch)
        x = x.cpu().numpy()
        if not np.isfinite(x).all():
            logger.warning("round %d: %d non-finite sample values before uint8 cast",
                           r + 1, int((~np.isfinite(x)).sum()))
        x8 = np.clip(x * 255.0, 0, 255).astype(np.uint8)
        path = out_dir / f"samples_{r}.npz"
        extra = {} if v is None else {"v": v.cpu().numpy()}
        np.savez_compressed(path, samples=x8, nfe=nfe, **extra)
        logger.info("round %d/%d: %d samples in %.1fs (nfe=%s)",
                    r + 1, rounds, batch, time.perf_counter() - t0, nfe)
        paths.append(path)
    return paths


def calibrate_int8(config, model, seed: int = 0) -> float:
    """Calibrate the int8 static activation scales into ``model.qscales``
    with the config family's calibration; returns the seconds it took."""
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(seed)
    if config.sde == "blur":
        model.qscales = calibrate_blur_qscales(config, model, BlurSDE.from_config(config),
                                               generator=generator)
    else:
        model.qscales = calibrate_cld_qscales(config, model, CLD.from_config(config),
                                              generator=generator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    logger.info("calibrated the int8 scales of %d blocks in %.2f s", len(model.qscales), seconds)
    return seconds


def init_model(config, device, weights: str | None = None, seed: int = 0):
    """A model to train: the config's own initialisation from ``seed`` (drawn
    on the CPU, so any device gets the same weights), or a state_dict file."""
    if weights is not None:
        return build_model(config, device, weights).train()
    return NCSNpp(config, generator=torch.Generator().manual_seed(seed)).to(device).train()


def train(config, model, out_dir: Path, steps: int, batch: int, seed: int, device):
    """``steps`` Adam steps on the synthetic stream; writes params.pt and
    ema.pt under ``out_dir``. Returns the TrainState."""
    out_dir.mkdir(parents=True, exist_ok=True)
    n_jitted = int(config.training.n_jitted_steps)
    stream = SyntheticStream(config, batch, n_jitted, seed)
    scaler = get_data_scaler(config)
    loss_fn = make_loss_fn(config, train=True)
    state = create_train_state(config, model, torch.Generator(device=device).manual_seed(seed))
    train_step = make_train_step(loss_fn)
    while state.step < steps:
        n = min(n_jitted, steps - state.step)
        batches = torch.from_numpy(scaler(next(stream))[:n]).to(device)
        t0 = time.perf_counter()
        info = train_step(state, batches)
        loss = float(info["loss"])
        logger.info("step %d/%d: loss %.5f, grad norm %.4f, %.2f s for %d steps", state.step,
                    steps, loss, float(info["grad_norm"]), time.perf_counter() - t0, n)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {state.step}")
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    torch.save(cpu(model.state_dict()), out_dir / "params.pt")
    torch.save(cpu(ema_state_dict(state)), out_dir / "ema.pt")
    return state


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
    if isinstance(getattr(node, field), bool) and isinstance(value, str):
        if value.lower() not in ("true", "false"):
            raise SystemExit(f"--set {item}: {key} takes true or false")
        value = value.lower() == "true"
    setattr(node, field, value)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="cld/accr_dcifar10")
    parser.add_argument("--mode", choices=["sampling", "train"], default="sampling")
    parser.add_argument("--batch", type=int, default=None,
                        help="sampling: 16; train: training.batch_size")
    parser.add_argument("--steps", type=int, default=5, help="train: optimizer steps")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True)
    parser.add_argument("--weights", default=None, help="state_dict file; seeded if absent")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-static", action="store_true",
                        help="fused_int8 sampling: per-sample activation scales, no calibration")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a config field, e.g. model.nf=32")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    device = torch.device(args.device)
    config = (train_config if args.mode == "train" else get_config)(args.config)
    for item in args.set:
        _override(config, item)
    if args.mode == "train":
        model = init_model(config, device, args.weights, args.seed)
        batch = args.batch or int(config.training.batch_size)
        train(config, model, Path(args.out), args.steps, batch, args.seed, device)
        return
    model = build_model(config, device, args.weights, args.seed)
    if config.model.conv_impl == "fused_int8" and not args.no_static:
        calibrate_int8(config, model, args.seed)
    sample_data(config, model, Path(args.out), args.batch or 16, args.rounds, args.seed, device)


if __name__ == "__main__":
    main()
