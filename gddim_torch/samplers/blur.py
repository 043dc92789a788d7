"""Blur-diffusion samplers in DCT space: order-0 (DDIM-style) updates and
frequency-space DEIS.

Counterpart of ``gddim_tpu/samplers/blur.py``. The per-step (H, W, 1) maps
come from the host in float64 (rounded to f32 as the JAX package's stacks
are); each step is iDCT -> network -> DCT
(``models/wrappers.py:make_blur_yeps_fn``) and one elementwise update. The
JAX package's ``lax.scan`` is a Python loop here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gddim_torch.math.blur import BlurSDE
from gddim_torch.math.deis_scalar import blur_deis_coef
from gddim_torch.samplers.timegrid import rev_time_grid
from gddim_torch.utils.io import content_key, load_npz_cache, save_npz_cache


def blur_order0_stacks(sde: BlurSDE, nfe: int, ts_order: float):
    """(rev_ts float64 (N+1,), a (N, H, W, 1) f32, b (N, H, W, 1) f32): the
    order-0 update  y_0 = (y - s_i eps) / m_i,  y_{i+1} = m_{i+1} y_0 +
    s_{i+1} eps  folded into  y_{i+1} = a_i y + b_i eps, a_i = m_{i+1} / m_i,
    b_i = s_{i+1} - a_i s_i."""
    rev_ts = rev_time_grid(sde.sampling_T, sde.sampling_eps, nfe, ts_order)
    m = sde.y_mean_coef(rev_ts)  # (N+1, H, W, 1)
    s = sde.y_std_coef(rev_ts)  # (N+1,)
    a = m[1:] / m[:-1]
    b = s[1:, None, None, None] - a * s[:-1, None, None, None]
    return rev_ts, a.astype(np.float32), b.astype(np.float32)


def build_blur_sampler(config, sde: BlurSDE, yeps_apply, data_shape: tuple,
                       inverse_scaler: Callable = lambda x: x):
    """Returns sample_fn(generator, model, batch_size, u0=None) -> (x, nfe).

    yeps_apply(model, y, t_vec) -> the DCT-space eps. The prior draw comes
    from ``generator`` on the model's device unless u0 (the DCT-space start) is given."""
    nfe = int(config.sampling.nfe)
    rev_ts, a_stack, b_stack = blur_order0_stacks(sde, nfe, float(config.sampling.ts_order))
    ts = rev_ts[:-1].astype(np.float32)  # f32 as the scan sees it

    def sample_fn(generator: torch.Generator, model, batch_size=None, u0=None):
        device = next(model.parameters()).device
        if u0 is None:
            u0 = sde.prior_sampling(generator, (batch_size,) + tuple(data_shape), device)
        y = u0.to(device=device, dtype=torch.float32)
        a, b = (torch.from_numpy(s).to(device) for s in (a_stack, b_stack))
        for i in range(nfe):
            eps_y = yeps_apply(model, y, torch.full((y.shape[0],), float(ts[i]), device=device))
            y = a[i][None] * y + b[i][None] * eps_y
        return inverse_scaler(sde.y2x(y)), nfe

    return sample_fn


def blur_deis_stacks(sde: BlurSDE, nfe: int, order: int, ts_order: float,
                     reference_exact: bool = False):
    """(rev_ts float64 (N+1,), x_coef (N, H, W, 1), eps_coef (N, order+1, H,
    W, 1)), both float64, cached by content: frequency-space DEIS
    (``math/deis_scalar.py``)."""
    rev_ts = rev_time_grid(sde.sampling_T, sde.sampling_eps, nfe, ts_order)
    key = content_key("blur_deis", sde.min_scale, sde.sigma_blur_max, sde.img_dim, rev_ts,
                      order, bool(reference_exact))
    cached = load_npz_cache("blur_deis", key)
    if cached is None:
        x_coef, eps_coef = blur_deis_coef(sde, rev_ts, order, reference_exact=reference_exact)
        save_npz_cache("blur_deis", key, x=x_coef, eps=eps_coef)
        cached = {"x": x_coef, "eps": eps_coef}
    return rev_ts, cached["x"], cached["eps"]


def build_blur_deis_sampler(config, sde: BlurSDE, yeps_apply, data_shape: tuple,
                            inverse_scaler: Callable = lambda x: x):
    """Higher-order frequency-space DEIS for blur diffusion
    (``gddim_tpu/samplers/blur.py:94-152``): per-frequency AB coefficients
    with an eps history of depth ``deis_order``. Returns sample_fn(generator,
    model, batch_size, u0=None) -> (x, nfe)."""
    sampling = config.sampling
    nfe, order = int(sampling.nfe), int(sampling.deis_order)
    rev_ts, x_stack, eps_stack = blur_deis_stacks(sde, nfe, order, float(sampling.ts_order),
                                                  bool(sampling.reference_exact))
    ts = rev_ts[:-1].astype(np.float32)  # f32 as the scan sees it

    def sample_fn(generator: torch.Generator, model, batch_size=None, u0=None):
        device = next(model.parameters()).device
        if u0 is None:
            u0 = sde.prior_sampling(generator, (batch_size,) + tuple(data_shape), device)
        y = u0.to(device=device, dtype=torch.float32)
        xc, ec = (torch.from_numpy(s.astype(np.float32)).to(device) for s in (x_stack, eps_stack))
        hist = [y] * order
        for i in range(nfe):
            eps_y = yeps_apply(model, y, torch.full((y.shape[0],), float(ts[i]), device=device))
            full = [eps_y] + hist
            step = ec[i, 0][None] * full[0]
            for j in range(1, order + 1):
                step = step + ec[i, j][None] * full[j]
            y = xc[i][None] * y + step
            hist = full[:order]
        return inverse_scaler(sde.y2x(y)), nfe

    return sample_fn


def build_blur_sampler_from_config(config, sde: BlurSDE, yeps_apply, data_shape: tuple,
                                   inverse_scaler: Callable = lambda x: x):
    """The configured blur sampler: 'order0' or 'deis'."""
    name = config.sampling.method.lower()
    if name == "order0":
        return build_blur_sampler(config, sde, yeps_apply, data_shape, inverse_scaler)
    if name == "deis":
        return build_blur_deis_sampler(config, sde, yeps_apply, data_shape, inverse_scaler)
    raise ValueError(f"blur samplers are 'order0' and 'deis' (got {name!r})")
