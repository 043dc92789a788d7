"""Device time of the port's optimizer update (``gddim_torch.train.state.
apply_gradients``) against another tree's, on one CUDA card.

    python scripts/time_update_torch.py --parent DIR

DIR holds the other tree's ``gddim_torch/train/state.py`` (for example the
parent commit unpacked with ``git archive``); that module imports only
torch, so it is loaded from its file beside this tree's. For each config's
parameters (seeded weights, seeded gradients above the clip norm):

- ``apply_gradients`` alone: 3 warm-up calls, then ``--reps`` calls, each
  timed with CUDA events, in the order other, this, this, other; the
  median and the mean ms of each run, and this tree's AdamW
  (weight_decay 1e-2) the same way;
- the global norm alone, f32 sums and f64 sums (``torch._foreach_norm``);
- cld/accr_dcifar10 only: whole B=128 training steps (the model's fused
  path, fused_attn off) with each tree's update in ``train/step.py``,
  2 warm-up steps, then ``--steps`` steps timed with CUDA events, the same
  order.

Prints one line each, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_state_module(tree: Path):
    spec = importlib.util.spec_from_file_location("other_train_state",
                                                  tree / "gddim_torch/train/state.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses looks its module up
    spec.loader.exec_module(module)
    return module


def event_ms(fn, warmup: int, reps: int) -> list[float]:
    """ms of each of ``reps`` calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def summary(times: list[float]) -> str:
    return f"median {statistics.median(times):.3f} ms, mean {statistics.fmean(times):.3f} ms"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--configs", default="cld/calib_cifar10,cld/accr_dcifar10")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_update_torch: no CUDA card")

    from gddim_torch.configs import train_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train import state as this
    from gddim_torch.train import step as step_mod
    from gddim_torch.train.losses import make_cld_loss_fn

    other = load_state_module(args.parent)
    card = card_line()
    for name in args.configs.split(","):
        config = train_config(name)
        model = seeded_model(config, 0, "cuda").train()
        state = this.create_train_state(config, model, torch.Generator(device="cuda"))
        params = this.trainable(model)
        n_values = sum(p.numel() for p in params.values())
        g = torch.Generator(device="cuda").manual_seed(5)
        grads = {n: 1e-2 * torch.randn(p.shape, generator=g, device="cuda")
                 for n, p in params.items()}
        tag = f"{name} ({len(params)} tensors, {n_values / 1e6:.1f}M values)"
        for label, module in (("parent", other), ("change", this), ("change", this),
                              ("parent", other)):
            times = event_ms(lambda: module.apply_gradients(state, grads), 3, args.reps)
            print(f"update {tag} {label} Adam: {summary(times)} [{card}]", flush=True)
        state.weight_decay = 1e-2
        times = event_ms(lambda: this.apply_gradients(state, grads), 3, args.reps)
        print(f"update {tag} change AdamW: {summary(times)} [{card}]", flush=True)
        state.weight_decay = 0.0
        g_list = list(grads.values())
        for label, kw in (("f32", {}), ("f64", {"dtype": torch.float64})):
            times = event_ms(lambda: torch._foreach_norm(g_list, 2, **kw), 3, args.reps)
            print(f"update {tag} global norm {label} sums: {summary(times)} [{card}]", flush=True)
        if name != "cld/accr_dcifar10":
            continue
        model.fused_attn = False
        batch = int(config.training.batch_size)
        images = torch.rand((1, batch, 32, 32, config.data.num_channels),
                            generator=g, device="cuda") * 2 - 1
        train_step = step_mod.make_train_step(
            make_cld_loss_fn(CLD.from_config(config), train=True))
        for label, module in (("parent", other), ("change", this), ("change", this),
                              ("parent", other)):
            step_mod.apply_gradients = module.apply_gradients
            times = event_ms(lambda: train_step(state, images), 2, args.steps)
            print(f"update {name} B={batch} training step with the {label}'s update: "
                  f"{summary(times)} [{card}]", flush=True)
        step_mod.apply_gradients = this.apply_gradients


if __name__ == "__main__":
    main()
