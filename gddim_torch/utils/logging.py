"""Metrics logging (counterpart of ``gddim_tpu/utils/logging.py``).

Every record goes to ``<workdir>/metrics.jsonl``, one JSON object a line
with its wall time and step. wandb is imported only when a run asks for it
(``config.log_wandb``); a run that asks for it where wandb is not installed
raises rather than carrying on without it. The wandb run id is kept in
``<workdir>/meta.json`` so a resumed run logs to the same wandb run.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from gddim_torch.utils.tree import flatten_config


class MetricsLogger:
    def __init__(self, workdir: str | Path, enable_wandb: bool = False,
                 project: str = "gddim_torch", config=None):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.path = self.workdir / "metrics.jsonl"
        self._wandb = self._init_wandb(project, config) if enable_wandb else None
        self._fh = open(self.path, "a")
        # the cluster's job id, where a scheduler sets one
        job_id = os.environ.get("SLURM_JOB_ID") or os.environ.get("NGC_JOB_ID")
        if job_id:
            self.log({"job_id": job_id})

    def _init_wandb(self, project, config):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("log_wandb is set but wandb is not installed") from e
        meta_path = self.workdir / "meta.json"
        run_id = json.loads(meta_path.read_text()).get("wandb_id") if meta_path.exists() else None
        run = wandb.init(project=project, id=run_id, resume="allow",
                         config=flatten_config(config) if config is not None else None)
        meta_path.write_text(json.dumps({"wandb_id": run.id}))
        return run

    def log(self, metrics: dict, step: int | None = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, path, step: int | None = None):
        """Record a saved image's path (and attach it to wandb)."""
        self.log({name: str(path)}, step)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(str(path))}, step=step)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
