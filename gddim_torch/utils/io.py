"""Content-addressed ``.npz`` cache for host-side coefficient precompute.

Counterpart of ``gddim_tpu/utils/io.py`` with its own directory
(``GDDIM_TORCH_CACHE_DIR``, default ``build/gddim_torch_cache`` in the
checkout) and its own file prefix, so it never reads a table the JAX
package cached.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

_PREFIX = "gdt_"
_DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "gddim_torch_cache"


def cache_dir() -> Path:
    p = Path(os.environ.get("GDDIM_TORCH_CACHE_DIR", _DEFAULT_DIR))
    p.mkdir(parents=True, exist_ok=True)
    return p


def content_key(*parts) -> str:
    """Stable hash of a heterogeneous tuple of floats/ints/strings/arrays."""
    h = hashlib.sha1()
    for part in parts:
        if isinstance(part, np.ndarray):
            h.update(b"arr")
            h.update(str(part.shape).encode())
            h.update(str(part.dtype).encode())
            h.update(np.ascontiguousarray(part).tobytes())
        else:
            h.update(repr(part).encode())
        h.update(b"|")
    return h.hexdigest()


def _path(name: str, key: str) -> Path:
    return cache_dir() / f"{_PREFIX}{name}_{key}.npz"


def load_npz_cache(name: str, key: str):
    path = _path(name, key)
    if not path.exists():
        return None
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_npz_cache(name: str, key: str, **arrays) -> Path:
    path = _path(name, key)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path
