"""Config helpers (counterpart of ``gddim_tpu/utils/tree.py``)."""

from __future__ import annotations

import dataclasses


def flatten_config(cfg, prefix: str = "") -> dict:
    """A nested config (dataclasses or dicts) as {'section.field': value}."""
    items = cfg.items() if isinstance(cfg, dict) else vars(cfg).items()
    out = {}
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or dataclasses.is_dataclass(v):
            out.update(flatten_config(v, key))
        else:
            out[key] = v
    return out
