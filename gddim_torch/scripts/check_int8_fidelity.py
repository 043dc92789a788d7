"""Sampling fidelity of the int8 paths (counterpart of
``scripts/check_int8_fidelity.py``): ``fused`` bf16 against ``fused_int8``
with per-sample (dynamic) and calibrated static activation scales, on the
same weights and the same draws, deis order 2 at ``--nfe``.

    python -m gddim_torch.scripts.check_int8_fidelity --config cld/accr_dcifar10 \\
        --workdir logs/cld --ckpt 2 --nfe 50 --batch 64 --rounds 1

Per int8 variant: the pixel correlation with the bf16 samples, max and mean
|dx|, the samples' mean (as the JAX script, on the raw samples; the first
three on the uint8 images the samplers write too, under ``images``), and
the proxy-FID of each set against a held-out
synthetic corpus (seed config.seed + 1) with its delta from bf16's. The
static scales are calibrated as ``run_lib.calibrate_int8`` does. With
``--workdir``/``--ckpt`` the weights are a trained checkpoint's EMA, else
the config's initialisation from config.seed. The draws are the port's own
generators (round r: seed 7, stream r), not the JAX script's
``PRNGKey(7 + r)``, which torch cannot reproduce. Exits non-zero when a
variant's samples are not finite. The proxy-FID is not comparable to a
published FID.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gddim_torch import run_lib
from gddim_torch.configs import get_config
from gddim_torch.data.pipelines import _synthetic_images
from gddim_torch.evals.features import get_feature_extractor, run_features
from gddim_torch.evals.fid import frechet_distance

VARIANTS = (("bf16_fused", "fused", False), ("int8_dynamic", "fused_int8", False),
            ("int8_static", "fused_int8", True))
SEED = 7  # the draws' seed (the JAX script's PRNGKey base)


def variant_config(name: str, conv_impl: str, nfe: int):
    config = get_config(name)
    config.model.conv_impl = conv_impl
    config.model.dtype = "bfloat16"
    config.sampling.method = "deis"
    config.sampling.nfe = nfe
    config.sampling.deis_order = 2
    config.sampling.ts_order = 2
    config.sampling.noise_removal = True
    return config


def build_model(config, device, workdir=None, ckpt=None, static=False):
    """The EMA of a checkpoint, or the config's initialisation; static int8
    scales calibrated where asked."""
    if workdir or ckpt is not None:
        model = run_lib.use_ema(run_lib.restore_state(config, ckpt, workdir, device)[1])
    else:
        model = run_lib.init_model(config, device)
    model.eval()
    if static:
        run_lib.calibrate_int8(config, model, int(config.seed))
    return model


def proxy_fid(config, samples_u8: np.ndarray, ref_u8: np.ndarray, device) -> float:
    extractor = get_feature_extractor(config, device)
    fa, _ = run_features(extractor, samples_u8)
    fb, _ = run_features(extractor, ref_u8)
    return frechet_distance(fa.mean(0), np.cov(fa, rowvar=False), fb.mean(0),
                            np.cov(fb, rowvar=False))


def _u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def agreement(a: np.ndarray, b: np.ndarray) -> dict:
    """Pixel correlation, max and mean |dx| of b against a."""
    return {"corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
            "max_abs_dx": float(np.abs(a - b).max()), "mean_abs_dx": float(np.abs(a - b).mean())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="cld/accr_dcifar10")
    p.add_argument("--workdir", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--nfe", type=int, default=50)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    samples = {}
    for name, conv_impl, static in VARIANTS:
        config = variant_config(args.config, conv_impl, args.nfe)
        model = build_model(config, device, args.workdir, args.ckpt, static)
        sample_fn = run_lib.build_sampling_fn(config)
        rounds = []
        with torch.no_grad():
            for r in range(args.rounds):
                gen = run_lib.stream_generator(device, SEED, run_lib.STREAM_SAMPLES, r)
                rounds.append(sample_fn(gen, model, args.batch)[0].float().cpu().numpy())
        samples[name] = np.concatenate(rounds, 0)
        del model
        bad = int((~np.isfinite(samples[name])).sum())
        print(f"{name}: {len(samples[name])} samples, {bad} non-finite values", flush=True)
        if bad:
            raise SystemExit(f"check_int8_fidelity: {name} has {bad} non-finite sample values")

    config = variant_config(args.config, "fused", args.nfe)
    a = samples["bf16_fused"]
    ref = _synthetic_images(config, max(256, len(a)), seed=int(config.seed) + 1)
    label = "proxy-FID" if get_feature_extractor(config, device).name == "proxy" else "FID"
    fid_a = proxy_fid(config, _u8(a), ref, device)
    results = {"bf16_fused": {"mean": float(a.mean()), label: fid_a}}
    print(f"bf16_fused {label}: {fid_a:.4f}", flush=True)
    for name in ("int8_dynamic", "int8_static"):
        b = samples[name]
        fid_b = proxy_fid(config, _u8(b), ref, device)
        rec = {**agreement(a, b), "mean": float(b.mean()), label: fid_b,
               f"{label}_delta": fid_b - fid_a,
               "images": agreement(_u8(a) / 255.0, _u8(b) / 255.0)}
        results[name] = rec
        print(f"{name}: pixel corr {rec['corr']:.5f}  max|dx| {rec['max_abs_dx']:.4f}  "
              f"mean|dx| {rec['mean_abs_dx']:.5f}  mean {rec['mean']:.4f} (bf16 {a.mean():.4f});  "
              f"images: corr {rec['images']['corr']:.5f}  mean|dx| "
              f"{rec['images']['mean_abs_dx']:.5f};  "
              f"{label} {fid_b:.4f} (delta {fid_b - fid_a:+.4f}, "
              f"{(fid_b - fid_a) / max(fid_a, 1e-9) * 100:+.2f}%)", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
