"""Sampler factory: config -> sampling function (counterpart of
``gddim_tpu/samplers/factory.py``).

The nine CLD sampler families {order0, deis, hybdeis, mldeis, sdeis, ldeis,
ode, sscs, em} behind one ``build_cld_sampler``. All but ``ode`` are a host
float64 bundle (``samplers/coefs.py``) run by the engines of
``samplers/engine.py``; ``ode`` is scipy's ``solve_ivp`` on the host around
the probability-flow drift computed on the device, the state brought to the
host once per evaluation, as the JAX package does (reference parity:
cld_jax/sampling.py:432-495).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gddim_torch.math.linalg2 import sbmm
from gddim_torch.samplers import coefs
from gddim_torch.samplers.engine import ab_sample, sscs_sample

CLD_SAMPLERS = ("order0", "deis", "hybdeis", "mldeis", "sdeis", "ldeis", "ode", "sscs", "em")


def _bundle_from_config(host, sampling) -> "coefs.ABBundle | coefs.SSCSBundle":
    name = sampling.method.lower()
    nfe = int(sampling.nfe)
    denoising = bool(sampling.noise_removal)
    ts_order = float(sampling.ts_order)
    order = int(sampling.deis_order)
    ref_exact = bool(sampling.reference_exact)
    if name == "deis":
        return coefs.deis_bundle(host, nfe, order, ts_order, denoising)
    if name == "hybdeis":
        return coefs.hybdeis_bundle(host, nfe, order, ts_order, float(sampling.noise_nfe_ratio),
                                    float(sampling.img_t_ratio), denoising,
                                    reference_exact=ref_exact)
    if name == "order0":
        return coefs.order0_bundle(host, nfe, denoising, bool(sampling.is_em))
    if name == "mldeis":
        return coefs.mldeis_bundle(host, nfe, order, ts_order, denoising)
    if name == "ldeis":
        return coefs.ldeis_bundle(host, nfe, order, ts_order, denoising)
    if name == "sdeis":
        return coefs.sdeis_bundle(host, nfe, order, float(sampling.lambda_coef),
                                  bool(sampling.sdeis_use_order0), ts_order, denoising,
                                  reference_exact=ref_exact)
    if name == "em":
        return coefs.em_bundle(host, nfe, float(sampling.lambda_coef), ts_order, denoising)
    if name == "sscs":
        return coefs.sscs_bundle(host, nfe, ts_order, denoising)
    raise ValueError(f"unknown sampler method: {name!r} (one of {CLD_SAMPLERS})")


def _prior(sde, generator, model, batch_size, u0, data_shape):
    device = next(model.parameters()).device
    if u0 is None:
        u0 = sde.prior_sampling(generator, (batch_size,) + tuple(data_shape), device)
    return u0.to(device=device, dtype=torch.float32), device


def build_cld_sampler(config, sde, eps_apply, data_shape: tuple,
                      inverse_scaler: Callable = lambda x: x):
    """Returns sample_fn(generator, model, batch_size=None, u0=None,
    noise=None) -> (x, v, nfe).

    eps_apply(model, u, t_vec) -> eps. The prior draw comes from
    ``generator`` on the model's device unless u0 is given; so do the
    stochastic samplers' normals (sdeis, em, sscs) unless ``noise`` holds
    them (``engine.ab_sample`` / ``sscs_sample``)."""
    sampling = config.sampling
    if sampling.method.lower() == "ode":
        return _build_ode_sampler(config, sde, eps_apply, data_shape, inverse_scaler)
    bundle = _bundle_from_config(sde.host(), sampling)
    run = sscs_sample if isinstance(bundle, coefs.SSCSBundle) else ab_sample

    def sample_fn(generator: torch.Generator, model, batch_size=None, u0=None, noise=None):
        u0, device = _prior(sde, generator, model, batch_size, u0, data_shape)

        def eps_fn(u, t):
            return eps_apply(model, u, torch.full((u.shape[0],), t, device=device))

        u = run(eps_fn, u0, bundle, generator, noise)
        return inverse_scaler(u[..., 0]), u[..., 1], bundle.nfe

    return sample_fn


def _build_ode_sampler(config, sde, eps_apply, data_shape, inverse_scaler):
    """Black-box probability-flow ODE via scipy (cld_jax/sampling.py:432-495):
    nfe is solve_ivp's count of drift evaluations, +1 for the denoise step."""
    from scipy import integrate

    sampling = config.sampling
    rtol, atol, method = float(sampling.rtol), float(sampling.atol), str(sampling.ode_method)
    dn = coefs._denoise_consts(sde.host()) if sampling.noise_removal else None

    def sample_fn(generator: torch.Generator, model, batch_size=None, u0=None, noise=None):
        u0, device = _prior(sde, generator, model, batch_size, u0, data_shape)
        shape = u0.shape

        def score(u, t):
            tv = torch.full((shape[0],), t, device=device)
            return sde.eps2score(eps_apply(model, u, tv), tv)

        def ode_func(t, flat):
            u = torch.from_numpy(flat.reshape(shape)).to(device=device, dtype=torch.float32)
            g = sde.G(t)
            drift = sbmm(sde.F(t), u) - 0.5 * sbmm(g @ g, score(u, t))
            return drift.double().cpu().numpy().reshape(-1)

        solution = integrate.solve_ivp(ode_func, (sde.T, sde.sampling_eps),
                                       u0.double().cpu().numpy().reshape(-1),
                                       rtol=rtol, atol=atol, method=method)
        nfe = int(solution.nfev)
        u = torch.from_numpy(solution.y[:, -1].reshape(shape)).to(device=device,
                                                                   dtype=torch.float32)
        if dn is not None:
            dt = -float(dn.eps)
            f, gg = dn.F.astype(np.float32), dn.GG.astype(np.float32)
            u = u + sbmm(f, u) * dt - sbmm(gg, score(u, float(dn.t))) * dt
            nfe += 1
        return inverse_scaler(u[..., 0]), u[..., 1], nfe

    return sample_fn
