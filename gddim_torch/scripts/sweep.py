"""NFE x order sweep (counterpart of ``scripts/sweep.py``, BASELINE.json
config 3): sampling and FID for each NFE in ``--nfes`` x deis order in
``--orders`` against one checkpoint, one result folder a pair, one JSON
record a pair appended to ``<out>/sweep.jsonl`` and printed.

    python -m gddim_torch.scripts.sweep --config cld/accr_dcifar10 --ckpt 15 \\
        --workdir logs/cld --out sweep_results

``--ckpt``: a snapshot id of ``--workdir``'s run or a legacy checkpoint
file. Each record holds the scorer's report: without Inception weights
(eval.inception_weights) the scores are the proxy extractor's, under
``fid_proxy`` / ``IS_proxy`` with ``"extractor": "proxy"``, and are not
comparable to a published FID. Order 3 at NFE=10 on the ts_order grid is
computed as the JAX package computes it (finite multistep coefficients,
no refusal). Under ``GDDIM_*`` (``cli.py``) the processes share each
pair's sampling rounds; rank 0 scores and writes the records.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from gddim_torch import cli, run_lib
from gddim_torch.configs import get_config
from gddim_torch.parallel import multihost


def sweep_config(name: str, method: str, nfe: int, order: int, num_samples=None,
                 batch_size=None):
    """The config of one (NFE, order) pair."""
    config = get_config(name)
    config.sampling.method = method
    config.sampling.nfe = nfe
    config.sampling.deis_order = order
    if num_samples:
        config.eval.num_samples = num_samples
    if batch_size:
        config.eval.batch_size = batch_size
    return config


def _plain(v):
    return v if isinstance(v, (str, int)) else float(v)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="cld/accr_dcifar10")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--out", default="sweep_results")
    parser.add_argument("--nfes", type=int, nargs="+", default=[10, 20, 50])
    parser.add_argument("--orders", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--method", default="deis")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    joined = cli.join_process_group(args.device)
    try:
        device = multihost.local_device(args.device)
        out_dir = Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        records = []
        for nfe in args.nfes:
            for order in args.orders:
                config = sweep_config(args.config, args.method, nfe, order, args.num_samples,
                                      args.batch_size)
                folder = out_dir / f"{args.method}_nfe{nfe}_order{order}"
                run_lib.sample_data(config, args.ckpt, folder, args.workdir, device)
                if multihost.is_coordinator():
                    report = run_lib.check_fid(config, folder, device)
                    rec = {"method": args.method, "nfe": nfe, "order": order,
                           **{k: _plain(v) for k, v in report.items()}}
                    with open(out_dir / "sweep.jsonl", "a") as f:
                        f.write(json.dumps(rec) + "\n")
                    print(json.dumps(rec), flush=True)
                    records.append(rec)
                multihost.barrier("sweep_pair_scored")
        return records
    finally:
        if joined:
            multihost.shutdown()


if __name__ == "__main__":
    main()
