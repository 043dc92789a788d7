"""flax param tree <-> the port's ``state_dict``.

The flax tree is nested dicts of arrays keyed by the scope names
``gddim_tpu`` produces: for ``cld/accr_dcifar10`` ``ResnetBlockBigGANpp_0..75``,
``AttnBlockpp_0..9``, ``Downsample_0..2/Conv2d_0``, ``Conv_0/1``,
``Dense_0/1``, ``GaussianFourierProjection_0``, ``GroupNorm_0``; other
option sets add ``ResnetBlockDDPMpp_k`` (``NIN_0`` or ``Conv_2`` as its
skip), ``Upsample_k`` / ``Downsample_k`` (``Conv_0`` or ``Conv2d_0``, none
without a conv), ``Combine_k/Conv_0`` and the output pyramid's top-level
``GroupNorm_k`` / ``Conv_k``. Flax numbers scopes in
creation order; ``NCSNpp.scopes`` records that order as the port builds the
U-Net, so each scope is looked up by its own name and index (never by a
string sort, under which ``_70`` comes before ``_8``). Layouts are shared:
nothing is transposed. ``qscales_from_flax`` carries the JAX package's int8
calibration ('qscales' collection) over the same way.

The other registered models keep ``scopes`` too: ``ps_fmlp``
(``GaussianFourierProjection_0``, ``Dense_0..num_layers``) and the
WideResNet classifier (``GaussianFourierProjection_0``, ``Dense_0..2``,
``init_conv``, ``WideResnetGroup_0..2/WideResnetBlock_k/{init_bn, conv1,
Dense_0, bn_2, conv2}``, ``pre-pool-bn``); ``check_scope_numbering``
checks the numbering at every level.
"""

from __future__ import annotations

import collections
import re

import numpy as np
import torch

from gddim_torch.models import blocks, layers, resample

# torch module type -> {flax leaf: torch parameter}
_LEAVES = {
    layers.Conv: {"kernel": "weight", "bias": "bias"},
    layers.Dense: {"kernel": "weight", "bias": "bias"},
    layers.NIN: {"W": "weight", "b": "bias"},
    layers.GroupNorm: {"scale": "weight", "bias": "bias"},
    layers.GaussianFourierProjection: {"W": "weight"},
    resample.Conv2d: {"weight": "weight", "bias": "bias"},
}
# block type -> {flax sub-scope: torch attribute}; the residual blocks,
# Upsample and Downsample carry their own (``subscopes``: the skip's and the
# resample conv's scope names depend on the block's options)
_SUBSCOPES = {
    blocks.AttnBlockpp: {
        "GroupNorm_0": "norm", "NIN_0": "q", "NIN_1": "k", "NIN_2": "v", "NIN_3": "out",
    },
    layers.Combine: {"Conv_0": "conv"},
}
_SCOPE = re.compile(r"^(.*)_(\d+)$")
# the names flax gives a module it numbers: its class name (CamelCase) and a count
_AUTO = re.compile(r"^[A-Z][A-Za-z0-9]*_\d+$")


def scope_key(name: str):
    """'ResnetBlockBigGANpp_70' -> ('ResnetBlockBigGANpp', 70): sorts by index."""
    m = _SCOPE.match(name)
    if m is None:
        raise ValueError(f"not a flax scope name: {name!r}")
    return m.group(1), int(m.group(2))


def module_pairs(mod, prefix: str = ""):
    """[(flax path, torch key)] for one layer or block, relative to its
    scope; a block's ``subscopes`` may hold blocks of their own."""
    subs = getattr(mod, "subscopes", None)
    if subs is None:
        subs = _SUBSCOPES.get(type(mod))
    if subs is None:
        leaves = _LEAVES.get(type(mod)) or mod.flax_leaves
        return [((leaf,), f"{prefix}{attr}") for leaf, attr in leaves.items()]
    return [((sub,) + path, key)
            for sub, attr in subs.items() if getattr(mod, attr) is not None
            for path, key in module_pairs(getattr(mod, attr), f"{prefix}{attr}.")]


def param_pairs(model):
    """[(flax path tuple, torch state_dict key)] for every parameter of the model,
    walked in the U-Net's creation order."""
    names = {id(mod): name for name, mod in model.named_modules()}
    return [((scope,) + path, key)
            for scope, mod in model.scopes
            for path, key in module_pairs(mod, names[id(mod)] + ".")]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_scope_numbering(params: dict, empty=()) -> None:
    """Each scope class of the tree must be numbered 0..n-1 at every level,
    counting the top level's scopes named in ``empty``: those that hold no
    parameter (an Upsample or Downsample without a conv), which flax numbers
    but leaves out of the tree. Scopes named explicitly (the classifier's
    ``init_conv`` and ``bn_2``, a leaf's ``kernel``: not a class name and a
    count) are not numbered."""
    by_cls = collections.defaultdict(list)
    for name in set(params) | set(empty):
        if _AUTO.match(name) is not None:
            cls, idx = scope_key(name)
            by_cls[cls].append(idx)
    for cls, idxs in by_cls.items():
        if sorted(idxs) != list(range(len(idxs))):
            raise ValueError(f"scopes of {cls} are not numbered 0..{len(idxs) - 1}")
    for sub in params.values():
        if isinstance(sub, dict):
            check_scope_numbering(sub)


def flax_to_state_dict(model, params: dict) -> dict:
    """Map a flax param tree (nested dicts of arrays) onto ``model.state_dict()``
    keys. Every flax leaf and every torch parameter is mapped exactly once.
    ``model`` is an NCSNpp, or one layer or block with its own subtree."""
    if hasattr(model, "scopes"):
        check_scope_numbering(params, [name for name, mod in model.scopes
                                       if not module_pairs(mod)])
        pairs = param_pairs(model)
    else:
        pairs = module_pairs(model)
    flat = dict(_flatten(params))
    paths = [p for p, _ in pairs]
    if set(paths) != set(flat) or len(paths) != len(flat):
        missing = sorted(set(paths) - set(flat))[:5]
        extra = sorted(set(flat) - set(paths))[:5]
        raise ValueError(f"param trees differ: missing {missing}, unexpected {extra}")
    ref = model.state_dict()
    sd = {}
    for path, key in pairs:
        arr = np.asarray(flat[path], dtype=np.float32)
        if tuple(arr.shape) != tuple(ref[key].shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {tuple(ref[key].shape)}")
        sd[key] = torch.from_numpy(arr.copy())
    if set(sd) != set(ref):
        raise ValueError(f"unmapped torch parameters: {sorted(set(ref) - set(sd))[:5]}")
    return sd


# int8 quantization sites each block kind records (gddim_tpu/models/blocks.py)
QSCALE_SITES = {blocks.ResnetBlockBigGANpp: {"a1", "a2", "x"},
                blocks.ResnetBlockDDPMpp: {"a1", "a2", "x"}, blocks.AttnBlockpp: {"h", "a"}}


def qscales_from_flax(model, tree: dict) -> dict:
    """A JAX 'qscales' collection ({scope: {site: amax}}, what
    ``gddim_tpu.models.calibrate`` returns) as ``NCSNpp.qscales``: 0-d f32
    tensors on the model's device under the same scope names. A scope the
    model lacks, or a site its block does not have, raises."""
    kinds = {name: type(mod) for name, mod in model.scopes}
    device = next(model.parameters()).device
    out = {}
    for scope, sites in tree.items():
        allowed = QSCALE_SITES.get(kinds.get(scope), set())
        if not set(sites) <= allowed:
            raise ValueError(f"qscales: {scope} has no sites {sorted(set(sites) - allowed)}")
        out[scope] = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                      for k, v in sites.items()}
    return out


def tensors_to_flax(model, tensors: dict) -> dict:
    """Tensors keyed like ``model.state_dict()`` (parameters or their
    gradients) as a flax tree of numpy float32 arrays; a key missing from
    ``tensors`` or mapped to None (a parameter with no gradient, such as the
    frozen Fourier frequencies) becomes zeros of the parameter's shape."""
    ref = model.state_dict()
    tree: dict = {}
    pairs = param_pairs(model) if hasattr(model, "scopes") else module_pairs(model)
    for path, key in pairs:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        t = tensors.get(key)
        node[path[-1]] = (np.zeros(tuple(ref[key].shape), np.float32) if t is None
                          else t.detach().float().cpu().numpy())
    return tree


def state_dict_to_flax(model) -> dict:
    """The inverse of flax_to_state_dict: the model's parameters as a flax tree
    of numpy arrays."""
    return tensors_to_flax(model, model.state_dict())


def grads_to_flax(model) -> dict:
    """The model's parameter gradients (``.grad``) in the flax tree's layout,
    to hold leaf by leaf against ``jax.grad``."""
    return tensors_to_flax(model, {n: p.grad for n, p in model.named_parameters()})
