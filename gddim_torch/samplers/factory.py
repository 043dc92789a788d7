"""Sampler factory: the deis branch of ``gddim_tpu/samplers/factory.py``."""

from __future__ import annotations

from typing import Callable

import torch

from gddim_torch.samplers import coefs
from gddim_torch.samplers.engine import ab_sample


def build_cld_sampler(config, sde, eps_apply, data_shape: tuple,
                      inverse_scaler: Callable = lambda x: x):
    """Returns sample_fn(generator, model, batch_size, u0=None) -> (x, v, nfe).

    eps_apply(model, u, t_vec) -> eps. The prior draw comes from
    ``generator`` on the model's device unless u0 is given.
    """
    sampling = config.sampling
    if sampling.method.lower() != "deis":
        raise NotImplementedError(f"sampler {sampling.method!r} is not ported")
    bundle = coefs.deis_bundle(sde.host(), int(sampling.nfe), int(sampling.deis_order),
                               float(sampling.ts_order), bool(sampling.noise_removal))

    def sample_fn(generator: torch.Generator, model, batch_size=None, u0=None):
        device = next(model.parameters()).device
        if u0 is None:
            u0 = sde.prior_sampling(generator, (batch_size,) + tuple(data_shape), device)
        u0 = u0.to(device=device, dtype=torch.float32)

        def eps_fn(u, t):
            return eps_apply(model, u, torch.full((u.shape[0],), t, device=device))

        u = ab_sample(eps_fn, u0, bundle)
        return inverse_scaler(u[..., 0]), u[..., 1], bundle.nfe

    return sample_fn
