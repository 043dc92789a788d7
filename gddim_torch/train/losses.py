"""The CLD score-matching loss (counterpart of ``gddim_tpu/train/losses.py``).

The eps-matching objective of the reference (cld_jax/losses.py:64-123):
stack v = 0 onto the image batch, draw t ~ U(T_EPS, T), perturb with the
full covariance R(t), and take the squared error between the model's eps and
the raw noise. t and z come from the caller's generator unless given, which
the tests and ``chip_smoke.py`` use to run two paths on the same draws.
"""

from __future__ import annotations

import torch

from gddim_torch.models.wrappers import make_cld_eps_fn

T_EPS = 1e-5  # smallest training time (reference losses.py:64 t_eps)


def _reduce(losses, reduce_mean: bool):
    flat = losses.reshape(losses.shape[0], -1)
    return flat.mean(-1) if reduce_mean else 0.5 * flat.sum(-1)


def make_cld_loss_fn(sde, train: bool, reduce_mean: bool = True):
    """loss_fn(model, images, generator, t=None, z=None) -> scalar loss.

    images: (B, H, W, C) scaled data. ``model`` is anything called like the
    NCSNpp (a module, or a functional_call closure)."""
    eps_apply = make_cld_eps_fn(sde, train=train)

    def loss_fn(model, images, generator: torch.Generator | None = None, t=None, z=None):
        data = torch.stack([images, torch.zeros_like(images)], -1)
        if t is None:
            u = torch.rand((data.shape[0],), generator=generator, device=data.device)
            t = T_EPS + (sde.T - T_EPS) * u
        perturbed, _, z = sde.perturb_data(data, t, generator, z)
        eps = eps_apply(model, perturbed, t, generator)
        return _reduce(torch.square(eps - z), reduce_mean).mean()

    return loss_fn
