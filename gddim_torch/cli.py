"""Command line: CLD sampling with the port.

    python -m gddim_torch.cli --config cld/accr_dcifar10 --mode sampling \\
        --batch 16 --seed 0 --out samples/ [--weights model.pt] [--rounds 1]

Weights are seeded (``models/init.py``) unless ``--weights`` names a
``state_dict`` file (``torch.save`` of ``convert.flax_to_state_dict``). Each
round writes ``samples_<r>.npz`` holding uint8 images, v and nfe, as the JAX
package's ``run_lib.sampling_from_fn`` does. Needs a CUDA device unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from gddim_torch.configs import get_config
from gddim_torch.math.cld import CLD
from gddim_torch.models.init import seeded_model
from gddim_torch.models.unet import NCSNpp
from gddim_torch.models.wrappers import make_cld_eps_fn
from gddim_torch.samplers.factory import build_cld_sampler

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
    """sample_fn(generator, model, batch_size, u0=None) -> (x in [0, 1], v, nfe)."""
    sde = CLD.from_config(config)
    size = config.data.image_size
    data_shape = (size, size, config.data.num_channels)
    inverse_scaler = (lambda x: (x + 1.0) / 2.0) if config.data.centered else (lambda x: x)
    return build_cld_sampler(config, sde, make_cld_eps_fn(sde), data_shape, inverse_scaler)


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
        np.savez_compressed(path, samples=x8, nfe=nfe, v=v.cpu().numpy())
        logger.info("round %d/%d: %d samples in %.1fs (nfe=%s)",
                    r + 1, rounds, batch, time.perf_counter() - t0, nfe)
        paths.append(path)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="cld/accr_dcifar10")
    parser.add_argument("--mode", choices=["sampling"], default="sampling")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True)
    parser.add_argument("--weights", default=None, help="state_dict file; seeded if absent")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    device = torch.device(args.device)
    config = get_config(args.config)
    model = build_model(config, device, args.weights, args.seed)
    sample_data(config, model, Path(args.out), args.batch, args.rounds, args.seed, device)


if __name__ == "__main__":
    main()
