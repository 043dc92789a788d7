"""Model plumbing (counterpart of ``gddim_tpu/models/wrappers.py``).

CLD:
- (x, v) channel stacking "b ... d g -> b ... (g d)" in and out
  (cld_jax/models/utils.py:141-164);
- time conditioning labels = t * 999 (cld_jax/models/utils.py:172);
- the mixed score (``model.mixed_score``, ``wrappers.py:86-89``): the
  network's eps plus the analytic term invR(t) @ [0, v], in f32 whatever
  the model's activation dtype (R(t) is small near t = 0, so invR reaches
  ~1e3 there);
- the score, eps2score(eps) (cld_jax/models/utils.py:184-211).

Blur (``wrappers.py:109-143``): the network on plain image channels with
labels ``sde.encode_t(t)`` = 999 t, and the DCT-space eps, iDCT -> network
-> DCT.
"""

from __future__ import annotations

import torch

from gddim_torch.math.linalg2 import bmm


def stack_uv_to_channels(u: torch.Tensor) -> torch.Tensor:
    """(B, ..., d, 2) -> (B, ..., 2d) with [x-channels | v-channels] order."""
    moved = u.movedim(-1, -2)  # (..., 2, d)
    return moved.reshape(u.shape[:-2] + (2 * u.shape[-2],))


def unstack_channels_to_uv(h: torch.Tensor) -> torch.Tensor:
    """(B, ..., 2d) -> (B, ..., d, 2), the inverse of stack_uv_to_channels."""
    d = h.shape[-1] // 2
    return h.reshape(h.shape[:-1] + (2, d)).movedim(-2, -1)


def mixed_score_term(sde, u, t_vec):
    """invR(t) @ [0, v] per batch element, f32 (``wrappers.py:86-89``): u
    (B, ..., d, 2) with its x half zeroed."""
    v_only = torch.stack([torch.zeros_like(u[..., 1]), u[..., 1]], -1).float()
    return bmm(sde.invR(t_vec.float()), v_only)


def make_cld_eps_fn(sde, train: bool = False):
    """eps_apply(model, u, t_vec, generator=None) -> eps for the CLD score model.

    u: (B, ..., d, 2) f32; t_vec: (B,). eps comes back f32, whatever the
    model's activation dtype; with ``sde.mixed_score`` it carries the
    analytic term ``mixed_score_term``. train=False: inference (no autograd,
    no dropout); train=True: the model's training path, differentiable,
    with dropout masks drawn from ``generator``.
    """

    def eps_apply(model, u, t_vec, generator=None):
        if train:
            out = model(stack_uv_to_channels(u), t_vec * 999.0, train=True, generator=generator)
        else:
            with torch.inference_mode():
                out = model(stack_uv_to_channels(u), t_vec * 999.0)
        eps = unstack_channels_to_uv(out.float())
        if sde.mixed_score:
            eps = eps + mixed_score_term(sde, u, t_vec)
        return eps

    return eps_apply


def make_cld_score_fn(sde, train: bool = False):
    """score_apply(model, u, t_vec, generator=None) -> the CLD score:
    make_cld_eps_fn's eps, then ``sde.eps2score`` (``wrappers.py:97-107``)."""
    eps_apply = make_cld_eps_fn(sde, train=train)

    def score_apply(model, u, t_vec, generator=None):
        return sde.eps2score(eps_apply(model, u, t_vec, generator), t_vec)

    return score_apply


def make_blur_eps_fn(sde, train: bool = False):
    """eps_apply(model, x, t_vec, generator=None) -> pixel-space eps of the
    blur model, f32 whatever the model's dtype. train=False: inference (no
    autograd, no dropout); train=True: the training path, differentiable,
    dropout masks from ``generator``."""

    def eps_apply(model, x, t_vec, generator=None):
        if train:
            return model(x, sde.encode_t(t_vec), train=True, generator=generator).float()
        with torch.inference_mode():
            out = model(x, sde.encode_t(t_vec))
        return out.float()

    return eps_apply


def make_blur_yeps_fn(sde):
    """yeps_apply(model, y, t_vec) -> the DCT-space eps: iDCT, network, DCT."""
    xeps = make_blur_eps_fn(sde)

    def yeps_apply(model, y, t_vec):
        return sde.x2y(xeps(model, sde.y2x(y), t_vec))

    return yeps_apply
