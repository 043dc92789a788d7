"""Seeded weights that exercise every branch of the network (the
configured model, ``model.name`` in the registry).

The configs' own init (``init_scale=0``) draws each block's second conv and
each attention block's output projection at scale 1e-10, so those branches
are ~0 and a wrong conv2 or out-projection would pass any check. Parity
tests, ``chip_smoke.py`` and the CLI's seeded mode use these weights
instead: every tensor drawn with numpy from one seed, in the U-Net's
creation order, as a flax param tree that both packages accept.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seeded_params(config, seed: int) -> dict:
    """Flax-layout param tree: weights ~ N(0, 1/fan_in), GroupNorm scales
    1 + 0.1 N, biases 0.1 N; the Fourier frequencies N(0, fourier_scale^2)."""
    from gddim_torch.convert import param_pairs
    from gddim_torch.models.registry import get_model

    with torch.device("meta"):
        model = get_model(config.model.name)(config)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, key in param_pairs(model):
        shape = shapes[key]
        leaf = path[-1]
        if path[0].startswith("GaussianFourierProjection"):
            arr = rng.standard_normal(shape) * float(config.model.fourier_scale)
        elif leaf == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            arr = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = math.prod(shape[:-1])
            arr = rng.standard_normal(shape) / math.sqrt(fan_in)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return tree


def seeded_model(config, seed: int, device="cpu"):
    """The configured model on ``device`` holding ``seeded_params(config, seed)``."""
    from gddim_torch.convert import flax_to_state_dict
    from gddim_torch.models.registry import get_model

    with torch.device("meta"):
        model = get_model(config.model.name)(config)
    sd = flax_to_state_dict(model, seeded_params(config, seed))
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    return model.eval()
