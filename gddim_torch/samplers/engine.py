"""Multistep sampling engine (counterpart of ``gddim_tpu/samplers/engine.py``).

The JAX package folds the NFE loop into one ``lax.scan``; here it is a Python
loop over the N steps with the same carry: the state u and a fixed-length
history of past eps, warm-started with copies of u (whose coefficients are
zero until real history exists).
"""

from __future__ import annotations

from typing import Callable

import torch

from gddim_torch.math.linalg2 import sbmm
from gddim_torch.samplers.coefs import ABBundle, DenoiseConsts

EpsFn = Callable[[torch.Tensor, float], torch.Tensor]  # (u, t_scalar) -> eps


def _apply_row(coef_row, u, full_eps):
    """u' = coef[0] @ u + sum_o coef[1+o] @ full_eps[o]."""
    out = sbmm(coef_row[0], u)
    for o, eps in enumerate(full_eps):
        out = out + sbmm(coef_row[1 + o], eps)
    return out


def denoise_step(eps_fn: EpsFn, u, dn: DenoiseConsts):
    """Final analytic denoising step (cld_jax/sampling.py:30-39).

    u <- u + (F u) dt - (G G score) dt with dt = -eps, score = -invR^T eps_hat.
    """
    eps_hat = eps_fn(u, float(dn.t))
    score = -sbmm(dn.invR_T, eps_hat)
    dt = -float(dn.eps)
    return u + sbmm(dn.F, u) * dt - sbmm(dn.GG, score) * dt


def ab_sample(eps_fn: EpsFn, u0: torch.Tensor, bundle: ABBundle) -> torch.Tensor:
    """Run the deis bundle from the prior draw u0: (B, ..., 2)."""
    stack = bundle.stack.astype("float32")  # (N, K, 2, 2); f32 as the scan sees it
    ts = bundle.rev_ts[:-1].astype("float32")
    u = u0
    hist = [u] * bundle.hist_len
    for i in range(stack.shape[0]):
        eps = eps_fn(u, float(ts[i]))
        full_eps = [eps] + hist
        u = _apply_row(stack[i], u, full_eps)
        hist = full_eps[: bundle.hist_len]
    if bundle.denoise is not None:
        u = denoise_step(eps_fn, u, bundle.denoise)
    return u
