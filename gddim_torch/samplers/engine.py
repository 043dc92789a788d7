"""Sampling engines (counterpart of ``gddim_tpu/samplers/engine.py``).

The JAX package folds the NFE loop into one ``lax.scan``; here it is a Python
loop over the N steps with the same carry: the state u and a fixed-length
history of past eps, warm-started with copies of u (whose coefficients are
zero until real history exists). Every per-step 2x2 constant is rounded to
f32 first, as the scan's inputs are.

Stochastic bundles (sdeis, em, and every sscs step) add correlated noise,
``noise_factor @ z`` with z ~ N(0, I) of the state's shape. z comes from
``generator`` (a ``torch.Generator`` on the state's device), one draw a step
(two for sscs), or from ``noise``: the per-step normals themselves, as the
tests inject the JAX package's ``fold_in(rng, i)`` draws.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from gddim_torch.math.linalg2 import sbmm
from gddim_torch.samplers.coefs import ABBundle, DenoiseConsts, SSCSBundle

EpsFn = Callable[[torch.Tensor, float], torch.Tensor]  # (u, t_scalar) -> eps


def _f32(a):
    return None if a is None else a.astype("float32")


def _apply_row(coef_row, u, full_eps):
    """u' = coef[0] @ u + sum_o coef[1+o] @ full_eps[o]."""
    out = sbmm(coef_row[0], u)
    for o, eps in enumerate(full_eps):
        out = out + sbmm(coef_row[1 + o], eps)
    return out


def _draws(generator: torch.Generator | None, noise: Sequence | None, name: str):
    """draw(i, u) -> step i's normals of u's shape: noise[i], else a fresh
    draw from generator; raises for a stochastic sampler given neither."""
    if noise is not None:
        return lambda i, u: noise[i]
    if generator is None:
        raise ValueError(f"sampler {name!r} is stochastic: pass a generator or the noise")
    return lambda i, u: torch.randn(u.shape, generator=generator, device=u.device,
                                    dtype=u.dtype)


def denoise_step(eps_fn: EpsFn, u, dn: DenoiseConsts):
    """Final analytic denoising step (cld_jax/sampling.py:30-39).

    u <- u + (F u) dt - (G G score) dt with dt = -eps, score = -invR^T eps_hat.
    """
    eps_hat = eps_fn(u, float(dn.t))
    score = -sbmm(dn.invR_T, eps_hat)
    dt = -float(dn.eps)
    return u + sbmm(dn.F, u) * dt - sbmm(dn.GG, score) * dt


def ab_sample(eps_fn: EpsFn, u0: torch.Tensor, bundle: ABBundle,
              generator: torch.Generator | None = None, noise: Sequence | None = None
              ) -> torch.Tensor:
    """Run a linear-multistep bundle (deis, order0, hybdeis, mldeis, ldeis,
    sdeis, em) from the prior draw u0: (B, ..., 2).

    ``init_tf`` maps u0, ``state_tf`` the model's input, ``eps_tf`` the fresh
    eps, ``noise_factors`` the step's normals (added after the update), and
    ``final_tf`` the state after the denoise step. ``noise``: N tensors of
    u0's shape (stochastic bundles only)."""
    stack = _f32(bundle.stack)  # (N, K, 2, 2)
    ts = bundle.rev_ts[:-1].astype("float32")
    noise_fac, eps_tf, state_tf = (_f32(a) for a in (bundle.noise_factors, bundle.eps_tf,
                                                      bundle.state_tf))
    draw = _draws(generator, noise, bundle.name) if noise_fac is not None else None
    u = u0 if bundle.init_tf is None else sbmm(_f32(bundle.init_tf), u0)
    hist = [u] * bundle.hist_len
    for i in range(stack.shape[0]):
        eps = eps_fn(u if state_tf is None else sbmm(state_tf[i], u), float(ts[i]))
        if eps_tf is not None:
            eps = sbmm(eps_tf[i], eps)
        full_eps = [eps] + hist
        u_new = _apply_row(stack[i], u, full_eps)
        if draw is not None:
            u_new = u_new + sbmm(noise_fac[i], draw(i, u))
        u = u_new
        hist = full_eps[: bundle.hist_len]
    if bundle.denoise is not None:
        u = denoise_step(eps_fn, u, bundle.denoise)
    if bundle.final_tf is not None:
        u = sbmm(_f32(bundle.final_tf), u)
    return u


def sscs_sample(eps_fn: EpsFn, u0: torch.Tensor, bundle: SSCSBundle,
                generator: torch.Generator | None = None, noise: Sequence | None = None
                ) -> torch.Tensor:
    """Symmetric Splitting CLD Sampler (cld_jax/sampling.py:542-622).

    Each step: analytic OU half-step (correlated noise), exact score kick on
    the velocity channel, second OU half-step. ``noise``: N pairs (z1, z2)
    of u0's shape; a generator draws z1, then z2, each step."""
    mean_a, fac_a, mean_b, fac_b, inv_rt = (
        _f32(a) for a in (bundle.mean_a, bundle.fac_a, bundle.mean_b, bundle.fac_b,
                          bundle.invR_T))
    score_coef = bundle.score_coef.astype("float32")
    ts = bundle.rev_ts[:-1].astype("float32")
    m_inv = float(bundle.m_inv)
    if noise is None:
        draw = _draws(generator, None, "sscs")
        pair = lambda i, u: (draw(i, u), draw(i, u))  # noqa: E731
    else:
        pair = lambda i, u: noise[i]  # noqa: E731
    u = u0
    for i in range(mean_a.shape[0]):
        z1, z2 = pair(i, u)
        u = sbmm(mean_a[i], u) + sbmm(fac_a[i], z1)
        # score kick on v (sampling.py:571-581)
        score = -sbmm(inv_rt[i], eps_fn(u, float(ts[i])))
        v = u[..., 1] + float(score_coef[i]) * (score[..., 1] + m_inv * u[..., 1])
        u = torch.stack([u[..., 0], v], -1)
        u = sbmm(mean_b[i], u) + sbmm(fac_b[i], z2)
    if bundle.denoise is not None:
        u = denoise_step(eps_fn, u, bundle.denoise)
    return u
