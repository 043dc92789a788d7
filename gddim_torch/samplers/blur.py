"""Blur-diffusion sampler: order-0 (DDIM-style) updates in DCT space.

Counterpart of ``gddim_tpu/samplers/blur.py:22-78,155-166``. The per-step
(H, W, 1) maps come from the host in float64 (rounded to f32 as the JAX
package's stacks are); each step is iDCT -> network -> DCT
(``models/wrappers.py:make_blur_yeps_fn``) and one elementwise update. The
JAX package's ``lax.scan`` is a Python loop here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gddim_torch.math.blur import BlurSDE
from gddim_torch.samplers.timegrid import rev_time_grid


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


def build_blur_sampler_from_config(config, sde: BlurSDE, yeps_apply, data_shape: tuple,
                                   inverse_scaler: Callable = lambda x: x):
    """The configured blur sampler: 'order0' (frequency-space DEIS is not ported)."""
    name = config.sampling.method.lower()
    if name != "order0":
        raise NotImplementedError(f"blur sampler {name!r} is not ported (only 'order0')")
    return build_blur_sampler(config, sde, yeps_apply, data_shape, inverse_scaler)
