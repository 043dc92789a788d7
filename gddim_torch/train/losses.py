"""Score-matching losses (counterpart of ``gddim_tpu/train/losses.py``).

CLD: the eps-matching objective of the reference (cld_jax/losses.py:64-123):
stack v = 0 onto the image batch, draw t ~ U(T_EPS, T), perturb with the
full covariance R(t), and take the squared error between the model's eps and
the raw noise. Blur: the same skeleton with the blur forward process (DCT,
per-frequency scale, iDCT, isotropic noise) and no velocity channel
(reference blur_jax/losses.py:97-104). t and z come from the caller's
generator unless given, which the tests and ``chip_smoke.py`` use to run two
paths on the same draws.
"""

from __future__ import annotations

import torch

from gddim_torch.math.blur import BlurSDE
from gddim_torch.math.cld import CLD
from gddim_torch.models.wrappers import make_blur_eps_fn, make_cld_eps_fn
from gddim_torch.parallel.draws import draw_rows

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
            u = draw_rows(torch.rand, (data.shape[0],), generator, device=data.device)
            t = T_EPS + (sde.T - T_EPS) * u
        perturbed, _, z = sde.perturb_data(data, t, generator, z)
        eps = eps_apply(model, perturbed, t, generator)
        return _reduce(torch.square(eps - z), reduce_mean).mean()

    return loss_fn


def make_blur_loss_fn(sde, train: bool, reduce_mean: bool = True):
    """loss_fn(model, images, generator, t=None, z=None) -> scalar loss for
    blurring diffusion; images: (B, H, W, C) scaled data."""
    eps_apply = make_blur_eps_fn(sde, train=train)

    def loss_fn(model, images, generator: torch.Generator | None = None, t=None, z=None):
        if t is None:
            t = sde.sample_t((images.shape[0],), generator, images.device)
        perturbed, _, z = sde.perturb_data(images, t, generator, z)
        eps = eps_apply(model, perturbed, t, generator)
        return _reduce(torch.square(eps - z), reduce_mean).mean()

    return loss_fn


def make_loss_fn(config, train: bool):
    """The config family's loss (``config.sde``: 'cld' or 'blur')."""
    reduce_mean = bool(config.training.reduce_mean)
    if config.sde == "blur":
        return make_blur_loss_fn(BlurSDE.from_config(config), train, reduce_mean)
    return make_cld_loss_fn(CLD.from_config(config), train, reduce_mean)
