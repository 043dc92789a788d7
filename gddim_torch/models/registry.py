"""Model registry (counterpart of ``gddim_tpu/models/registry.py``).

The configs name their network by ``model.name``: 'ncsnpp' (the score
U-Net, ``models/unet.py``), 'ps_fmlp' (the point-set MLP, ``models/mlp.py``)
and 'wideresnet_noise_conditional' (the classifier, ``models/wideresnet.py``),
as the JAX package registers them. ``get_model`` imports those modules, so a
name resolves whichever of them the caller imported.
"""

from __future__ import annotations

import importlib

_MODELS: dict[str, type] = {}
_MODULES = ("gddim_torch.models.unet", "gddim_torch.models.mlp", "gddim_torch.models.wideresnet")


def register_model(cls=None, *, name: str | None = None):
    """Class decorator: register ``cls`` under ``name`` (default its class name)."""

    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS and _MODELS[local_name] is not c:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = c
        return c

    return _register if cls is None else _register(cls)


def _load_all() -> None:
    for module in _MODULES:
        importlib.import_module(module)


def get_model(name: str) -> type:
    """The model class registered under ``name``."""
    _load_all()
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: {available_models()}") from None


def available_models() -> tuple[str, ...]:
    _load_all()
    return tuple(sorted(_MODELS))
