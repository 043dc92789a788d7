"""Run checkpoints (counterpart of ``gddim_tpu/checkpoints/manager.py``).

The JAX package's two tiers: ``checkpoints-meta/`` keeps the latest
preemption checkpoint only, ``checkpoints/`` keeps every numbered snapshot.
Each checkpoint is one ``checkpoint_<n>.pt``, a ``torch.save`` of
``TrainState.state_dict()`` that ``torch.load(weights_only=True)`` reads.
A save writes a hidden temporary file in the same directory and renames it
into place (``os.replace``), so a save cut short leaves no file that a
restore picks up. A restore copies into the caller's state in place and
draws nothing from torch's global generators.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def _steps(directory: Path) -> list[int]:
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for p in directory.iterdir() if (m := _NAME.match(p.name)))


def _path(directory: Path, n: int) -> Path:
    return directory / f"checkpoint_{n}.pt"


def save_atomic(path, write_fn) -> Path:
    """Write ``path`` whole or not at all: ``write_fn(f)`` writes a hidden
    temporary file beside it, which is synced and renamed into place. Every
    file the harness writes goes through here."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _save_state(state, path: Path) -> Path:
    sd = state.state_dict()
    return save_atomic(path, lambda f: torch.save(sd, f))


class CheckpointManager:
    def __init__(self, workdir: str | Path, keep_meta: int = 1):
        workdir = Path(workdir)
        self.meta_dir = workdir / "checkpoints-meta"
        self.snap_dir = workdir / "checkpoints"
        self.keep_meta = keep_meta

    def save_meta(self, step: int, state) -> Path:
        path = _save_state(state, _path(self.meta_dir, step))
        for old in _steps(self.meta_dir)[:-self.keep_meta]:
            _path(self.meta_dir, old).unlink(missing_ok=True)
        return path

    def save_snapshot(self, snapshot_id: int, state) -> Path:
        return _save_state(state, _path(self.snap_dir, snapshot_id))

    @staticmethod
    def _load_into(path: Path, template):
        template.load_state_dict(torch.load(path, map_location="cpu", weights_only=True,
                                            mmap=True))
        return template

    def restore_latest_meta(self, template):
        """(template restored from the latest meta checkpoint, its step), or
        (template, 0) when there is none."""
        steps = _steps(self.meta_dir)
        if not steps:
            return template, 0
        return self._load_into(_path(self.meta_dir, steps[-1]), template), steps[-1]

    def restore_snapshot(self, snapshot_id: int, template):
        path = _path(self.snap_dir, snapshot_id)
        if not path.exists():
            raise FileNotFoundError(f"no snapshot {snapshot_id} under {self.snap_dir}")
        return self._load_into(path, template)

    def snapshot_steps(self) -> list[int]:
        return _steps(self.snap_dir)
