"""The published gDDIM checkpoints (counterpart of
``gddim_tpu/checkpoints/legacy.py``).

They are flax-0.3.1 msgpack serializations of the reference's training
state, written by ``flax.training.checkpoints.save_checkpoint``:

    {step, optimizer: {state: {step, param_states: {.. {grad_ema, grad_sq_ema}}},
                       target: <param tree>},
     lr, model_state, ema_rate, params_ema, rng}

The port reads them with its own msgpack codec (``codec.py``): the file is
read into one writable buffer and every array is a view of it, so a read
holds the file and, while a tree is converted, one copy of its tensors.
The parameter trees map onto the port's modules through
``convert.flax_to_state_dict``; Adam's moments (flax.optim's ``grad_ema``
/ ``grad_sq_ema``) onto the state's ``mu`` / ``nu``. The frozen Fourier
frequencies come from the parameters: the port keeps no EMA or moments of a
frozen parameter (their gradient is zero).
``export_legacy_checkpoint`` writes a port run in the same layout, for the
JAX package and the reference to read.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from gddim_torch import convert
from gddim_torch.checkpoints import codec
from gddim_torch.checkpoints.manager import save_atomic
from gddim_torch.train.state import ema_state_dict

logger = logging.getLogger("gddim_torch")


def _read(path: Path) -> bytearray:
    with open(path, "rb", buffering=0) as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, pos = memoryview(buf), 0
        while pos < len(buf):
            n = f.readinto(view[pos:])
            if not n:
                raise EOFError(f"{path}: file shrank while being read")
            pos += n
    return buf


def legacy_state_dict(path: str | Path) -> dict:
    """The raw nested dict of a flax checkpoint file (arrays view the file)."""
    return codec.unpackb(_read(Path(path)))


def _map_tree(tree, leaf_key):
    """``leaf_key`` of each flax.optim param-state node."""
    if isinstance(tree, dict):
        if leaf_key in tree and not isinstance(tree[leaf_key], dict):
            return tree[leaf_key]
        return {k: _map_tree(v, leaf_key) for k, v in tree.items()}
    return tree


def load_legacy_checkpoint(path: str | Path) -> dict:
    """{step, params, params_ema, adam_mu, adam_nu, lr, ema_rate} of a
    legacy file; the trees are flax-layout dicts of numpy arrays."""
    raw = legacy_state_dict(path)
    opt = raw["optimizer"]
    out = {
        "step": int(np.asarray(raw["step"])),
        "params": opt["target"],
        "params_ema": raw["params_ema"],
        "lr": float(np.asarray(raw.get("lr", 2e-4))),
        "ema_rate": float(np.asarray(raw.get("ema_rate", 0.9999))),
        "adam_mu": None,
        "adam_nu": None,
    }
    pstates = opt.get("state", {}).get("param_states")
    if pstates is not None:
        out["adam_mu"] = _map_tree(pstates, "grad_ema")
        out["adam_nu"] = _map_tree(pstates, "grad_sq_ema")
    return out


@torch.no_grad()
def into_train_state(legacy: dict, state):
    """Load a legacy checkpoint's parameters, EMA and (where they fit the
    model) Adam moments into ``state`` in place; the step, and with the
    moments the update count, become the checkpoint's. Moments that do not
    fit are left fresh, with a warning naming the leaf; the JAX package
    drops them without one. ``lr`` and ``ema_rate`` stay the config's."""
    model = state.model
    model.load_state_dict(convert.flax_to_state_dict(model, legacy["params"]))
    ema = convert.flax_to_state_dict(model, legacy["params_ema"])
    for name, t in state.ema.items():
        t.copy_(ema[name])
    del ema
    state.step = int(legacy["step"])
    if legacy["adam_mu"] is None:
        return state
    misfit = _misfit(model, legacy["adam_mu"]) or _misfit(model, legacy["adam_nu"])
    if misfit:
        logger.warning("legacy checkpoint: Adam moments do not fit the model (%s); keeping "
                       "fresh moments", misfit)
        return state
    for name, moments in (("mu", legacy["adam_mu"]), ("nu", legacy["adam_nu"])):
        sd = convert.flax_to_state_dict(model, moments)
        for k, t in getattr(state, name).items():
            t.copy_(sd[k])
        del sd
    state.count = int(legacy["step"])
    return state


def _leaves(tree, prefix=()):
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, prefix + (k,))


def _misfit(model, tree) -> str | None:
    """The first leaf of a flax tree that does not fit the model's
    parameters (missing, unexpected or of another shape), or None."""
    shapes = model.state_dict()
    want = {path: tuple(shapes[key].shape) for path, key in convert.param_pairs(model)}
    have = dict(_leaves(tree))
    for path, shape in want.items():
        if path not in have:
            return f"{'/'.join(path)} is missing"
        if tuple(np.shape(have[path])) != shape:
            return f"{'/'.join(path)} has shape {np.shape(have[path])}, not {shape}"
    extra = [p for p in have if p not in want]
    return f"{'/'.join(map(str, extra[0]))} is not a parameter" if extra else None


def export_legacy_checkpoint(path: str | Path, state) -> Path:
    """Write ``state`` in the reference's checkpoint layout (atomically).
    Parameters without moments (the frozen Fourier frequencies) get zero
    moments, as an optax state holds for them; ``rng`` is the threefry key of
    the training generator's seed."""
    model = state.model
    mu = convert.tensors_to_flax(model, state.mu)
    nu = convert.tensors_to_flax(model, state.nu)

    def pstates(m, n):
        if isinstance(m, dict):
            return {k: pstates(m[k], n[k]) for k in m}
        return {"grad_ema": m, "grad_sq_ema": n}

    seed = int(state.generator.initial_seed()) & 0xFFFFFFFF
    tree = {
        "step": int(state.step),
        "optimizer": {
            "state": {"step": int(state.step), "param_states": pstates(mu, nu)},
            "target": convert.state_dict_to_flax(model),
        },
        "lr": float(state.lr),
        "model_state": {},
        "ema_rate": float(state.ema_rate),
        "params_ema": convert.tensors_to_flax(model, ema_state_dict(state)),
        "rng": np.array([0, seed], dtype=np.uint32),
    }
    return save_atomic(path, lambda f: codec.pack_to(tree, f.write))
