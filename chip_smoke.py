"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,eps,sample] [--batch 16]

Phases (each prints one line; any failure raises and exits non-zero):
  1. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit;
  2. build: nvcc builds gddim_torch/csrc/*.cu, Triton compiles K1;
  3. kernels: each of K1-K5 at every main-path shape of the
     cld/accr_dcifar10 NCSN++ (B=4, bf16 inputs) against its plain version
     in f32 (TF32 off) on the same inputs, with timings;
  4. eps: one full-width eps evaluation (B=4, t=0.5, seeded weights), kernel
     path in bf16 against the all-plain path in f32, with the launch counts
     of that one evaluation;
  5. sample: CLD deis-2 NFE=50 sampling through gddim_torch.cli's sampling
     function (B=16, seeded weights): finite samples, launch counts, wall time.
Then one line {"kernels": [...]}, one line with the card's name and power
limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Bounds on max|kernel - plain| / max|plain|, bf16 inputs and weights, f32
# plain version. The kernels write bf16 (a relative rounding of up to 2^-8 =
# 3.9e-3 per element) and measured 1.9e-3 to 3.4e-3 at every main-path shape
# on an H100; the bounds leave about 3x margin over that.
KERNEL_BOUND = {"K1": 1e-2, "K2": 1e-2, "K3": 1e-2, "K4": 1e-2, "K5": 1e-2}
# Whole network, bf16 kernel path vs f32 plain path: measured 7.1e-3 and
# 7.6e-3 (seeded weights, B=4, t=0.5); about 2.5x margin.
EPS_BOUND = 2e-2
# kernel launches per eps evaluation of cld/accr_dcifar10
PER_EVAL = {"K1": 7, "K2": 34, "K3": 36, "K4": 6, "K5": 10}

KERNELS = {
    "K1": dict(name="group_norm_silu", route="triton", source="gddim_torch/ops/groupnorm.py",
               replaces="gddim_tpu/ops/groupnorm.py:162"),
    "K2": dict(name="fused_resblock", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:600"),
    "K3": dict(name="fused_resblock_pair", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:993"),
    "K4": dict(name="fused_resblock_tail", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:1111"),
    "K5": dict(name="fused_attnblock", route="cuda", source="gddim_torch/csrc/attnblock.cu",
               replaces="gddim_tpu/ops/attnblock.py:166"),
}
# main-path shapes of cld/accr_dcifar10 (H, channels in, channels out)
SHAPES = {
    "K1": [(32, 128), (16, 256), (8, 256), (4, 256)],
    "K2": [(32, 128, 128), (16, 128, 256), (16, 256, 256), (8, 256, 256), (4, 256, 256)],
    "K3": [(4, (256, 256), 256), (8, (256, 256), 256), (16, (256, 256), 256),
           (16, (256, 128), 256), (32, (256, 128), 128), (32, (128, 128), 128)],
    "K4": [(16, 128, 128), (8, 256, 256), (4, 256, 256), (16, 256, 256), (32, 256, 256)],
    "K5": [(16, 256), (4, 256)],
}
TEMB = 512  # 4 * nf


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Inputs:
    """Seeded random operands on the card. Weights are bf16, as the model
    hands them to the kernels; the plain version gets the same values in f32."""

    def __init__(self, seed: int):
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def act(self, *shape):
        return torch.randn(shape, generator=self.g, device="cuda").to(torch.bfloat16)

    def w(self, *shape, fan_in=None):
        fan_in = fan_in or int(np.prod(shape[:-1]))
        t = torch.randn(shape, generator=self.g, device="cuda") / fan_in ** 0.5
        return t.to(torch.bfloat16)

    def vec(self, n, base=0.0):
        return base + 0.1 * torch.randn((n,), generator=self.g, device="cuda")


def _f32(args):
    return [a.float() if isinstance(a, torch.Tensor) else a for a in args]


def kernel_cases(B: int):
    """(kernel, shape label, fused fn, plain fn, kernel args, plain args)."""
    from gddim_torch.ops import attnblock, groupnorm, resblock

    inp = Inputs(0)
    for h, c in SHAPES["K1"]:
        args = (inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c))
        kw = dict(num_groups=32, eps=1e-6, apply_silu=True)
        yield ("K1", f"{h}x{h}x{c}", lambda a=args, k=kw: groupnorm.group_norm_silu(*a, **k),
               lambda a=args, k=kw: groupnorm.group_norm_silu_reference(*_f32(a), **k), args, kw)
    for h, cin, cout in SHAPES["K2"]:
        skip = (inp.w(cin, cout), inp.vec(cout)) if cin != cout else (None, None)
        args = (inp.act(B, h, h, cin), inp.act(B, TEMB), inp.w(TEMB, cout).float(), inp.vec(cout),
                inp.vec(cin, 1.0), inp.vec(cin), inp.w(3, 3, cin, cout), inp.vec(cout),
                inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout),
                *skip)
        kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        yield ("K2", f"{h}x{h} {cin}->{cout}",
               lambda a=args, k=kw: resblock.fused_resblock(*a, **k),
               lambda a=args, k=kw: resblock.resblock_reference(*_f32(a), **k), args, kw)
    for h, (c1, c2), cout in SHAPES["K3"]:
        cin = c1 + c2
        args = (inp.act(B, h, h, c1), inp.act(B, h, h, c2), inp.act(B, TEMB),
                inp.w(TEMB, cout).float(), inp.vec(cout), inp.vec(cin, 1.0), inp.vec(cin),
                inp.w(3, 3, cin, cout), inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout),
                inp.w(3, 3, cout, cout), inp.vec(cout), inp.w(cin, cout), inp.vec(cout))
        kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        yield ("K3", f"{h}x{h} {c1}+{c2}->{cout}",
               lambda a=args, k=kw: resblock.fused_resblock_pair(*a, **k),
               lambda a=args, k=kw: resblock.resblock_pair_reference(*_f32(a), **k), args, kw)
    for h, c, cout in SHAPES["K4"]:
        args = (inp.act(B, h, h, c), inp.act(B, h, h, c), inp.act(B, TEMB), inp.w(TEMB, cout).float(),
                inp.vec(cout), inp.w(3, 3, c, cout), inp.vec(cout), inp.vec(cout, 1.0),
                inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout), inp.w(c, cout),
                inp.vec(cout))
        kw = dict(num_groups2=min(cout // 4, 32))
        yield ("K4", f"{h}x{h} {c}->{cout}",
               lambda a=args, k=kw: resblock.fused_resblock_tail(*a, **k),
               lambda a=args, k=kw: resblock.resblock_tail_reference(*_f32(a), **k), args, kw)
    for h, c in SHAPES["K5"]:
        args = (inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c),
                *[t for _ in range(4) for t in (inp.w(c, c), inp.vec(c))])
        kw = dict(num_groups=32, skip_rescale=True)
        yield ("K5", f"{h}x{h}x{c}",
               lambda a=args, k=kw: attnblock.fused_attnblock(*a, **k),
               lambda a=args, k=kw: attnblock.attnblock_reference(*_f32(a), **k), args, kw)


def plain_bf16(kernel):
    """The plain version at the working dtype (bf16 activations), for timing."""
    from gddim_torch.ops import attnblock, groupnorm, resblock

    return {"K1": groupnorm.group_norm_silu_reference, "K2": resblock.resblock_reference,
            "K3": resblock.resblock_pair_reference, "K4": resblock.resblock_tail_reference,
            "K5": attnblock.attnblock_reference}[kernel]


def phase_kernels(results: dict, B: int = 4):
    for kernel, label, fused, plain, args, kw in kernel_cases(B):
        out = fused()
        torch.cuda.synchronize()
        ref = plain()
        if out.shape != ref.shape or out.dtype != torch.bfloat16:
            raise AssertionError(f"{kernel} {label}: got {out.dtype} {tuple(out.shape)}, "
                                 f"plain {tuple(ref.shape)}")
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        ms = time_ms(fused)
        plain_ms = time_ms(lambda: plain_bf16(kernel)(*args, **kw))
        plain_f32_ms = time_ms(plain)
        print(f"kernel {kernel} {KERNELS[kernel]['name']} [{label}] B={B}: max|err|={err:.3e} "
              f"rel={rel:.3e} (bound {KERNEL_BOUND[kernel]:.0e}) ms={ms:.4f} "
              f"plain_bf16_ms={plain_ms:.4f} plain_f32_ms={plain_f32_ms:.4f}", flush=True)
        r = results.setdefault(kernel, dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0,
                                            plain_ms=0.0, shapes=[]))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_rel_err"] = max(r["max_rel_err"], rel)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["shapes"].append(dict(shape=label, max_abs_err=err, rel=rel, ms=ms,
                                plain_bf16_ms=plain_ms, plain_f32_ms=plain_f32_ms))
        if not np.isfinite(rel) or rel > KERNEL_BOUND[kernel]:
            raise AssertionError(f"{kernel} {label}: rel err {rel:.3e} > "
                                 f"{KERNEL_BOUND[kernel]:.0e}")


def counters():
    from gddim_torch.ops import attnblock, groupnorm, resblock

    return {"K1": groupnorm.group_norm_silu, "K2": resblock.fused_resblock,
            "K3": resblock.fused_resblock_pair, "K4": resblock.fused_resblock_tail,
            "K5": attnblock.fused_attnblock}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def phase_eps(config):
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.models.wrappers import make_cld_eps_fn

    model = seeded_model(config, seed=0, device="cuda")
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    g = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn((4, 32, 32, 3, 2), generator=g, device="cuda")
    t = torch.full((4,), 0.5, device="cuda")
    reset_counts()
    got = eps_apply(model, u, t)
    torch.cuda.synchronize()
    counts = read_counts()
    model.fused, model.dtype = False, torch.float32
    ref = eps_apply(model, u, t)
    model.fused, model.dtype = True, torch.bfloat16
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"eps B=4 t=0.5: kernel path (bf16) vs plain path (f32) rel={rel:.3e} "
          f"(bound {EPS_BOUND:.0e}); launches {counts}", flush=True)
    if not np.isfinite(rel) or rel > EPS_BOUND:
        raise AssertionError(f"eps rel err {rel:.3e} > {EPS_BOUND:.0e}")
    if counts != PER_EVAL:
        raise AssertionError(f"launch counts {counts} != {PER_EVAL}")
    return model


def phase_sample(config, model, batch: int, card: str):
    from gddim_torch.cli import sample_data

    nfe = int(config.sampling.nfe)
    with tempfile.TemporaryDirectory() as tmp:
        sample_data(config, model, Path(tmp), batch, rounds=1, seed=7, device="cuda")  # warm
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (path,) = sample_data(config, model, Path(tmp), batch, rounds=1, seed=8, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        with np.load(path) as f:
            samples, v, nfe_rec = f["samples"], f["v"], int(f["nfe"])
    expected = {k: n * nfe for k, n in PER_EVAL.items()}
    print(f"sample deis-2 NFE={nfe_rec} B={batch}: wall {wall:.3f} s, "
          f"{batch / wall:.2f} img/s [{card}] (information only); launches {counts}", flush=True)
    if samples.shape != (batch, 32, 32, 3) or not np.isfinite(v).all() or nfe_rec != nfe:
        raise AssertionError(f"bad samples {samples.shape} nfe={nfe_rec}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description="smoke run of gddim_torch on one CUDA card")
    parser.add_argument("--phases", default="build,kernels,eps,sample")
    parser.add_argument("--batch", type=int, default=16)
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from gddim_torch import _build
    from gddim_torch.configs import get_config
    from gddim_torch.ops import groupnorm

    t0 = time.perf_counter()
    _build.library()
    x = torch.zeros((1, 4, 4, 128), device="cuda", dtype=torch.bfloat16)
    groupnorm.group_norm_silu(x, torch.ones(128, device="cuda"), torch.zeros(128, device="cuda"))
    torch.cuda.synchronize()
    print(f"build: nvcc {_build.build_seconds:.1f} s, total with Triton "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    results: dict = {}
    if "kernels" in phases:
        phase_kernels(results)
    config = get_config("cld/accr_dcifar10")
    model = phase_eps(config) if "eps" in phases else None
    counts = {}
    if "sample" in phases:
        if model is None:
            from gddim_torch.models.init import seeded_model

            model = seeded_model(config, seed=0, device="cuda")
        counts = phase_sample(config, model, args.batch, card)
    if phases >= {"kernels", "sample"}:
        missing = [k for k in KERNELS if counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: {missing}")
        print(json.dumps({"kernels": [
            dict(**KERNELS[k], launches=counts[k], max_abs_err=results[k]["max_abs_err"],
                 max_rel_err=results[k]["max_rel_err"], ms=results[k]["ms"],
                 plain_ms=results[k]["plain_ms"], shapes=results[k]["shapes"])
            for k in KERNELS
        ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
