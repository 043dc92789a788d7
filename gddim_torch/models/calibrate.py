"""Static activation-scale calibration for the int8 inference path
(counterpart of ``gddim_tpu/models/calibrate.py``).

The int8 kernels quantize each conv or projection input with a per-sample
scale unless the block has calibrated static scales. Quantization sites
behind a GroupNorm (or a softmax's convex combination) have nearly
input-independent amplitudes, so one static scale per site loses little and
saves the kernels a per-sample amax pass. Calibration runs the plain
composition along a short order-0 exact-ODE sampling trajectory and keeps
each site's max|activation| over every step: {scope: {site: amax}}, the
layout of the JAX package's 'qscales' collection. ``NCSNpp.qscales`` takes
it; ``ops/resblock.py:act_scales_from_amax`` turns an amax into a scale.
The skip sites ("x") are recorded too, as the JAX package records them, and
never used: they see pre-norm activations whose range depends on the input.
``calibrate_blur_qscales`` does the same for the blur family along its
order-0 DCT-space trajectory. The layer-wise 'int8' path needs no
calibration: its scales are always per sample, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gddim_torch.math.linalg2 import sbmm
from gddim_torch.models.wrappers import (
    mixed_score_term,
    stack_uv_to_channels,
    unstack_channels_to_uv,
)
from gddim_torch.samplers import coefs
from gddim_torch.samplers.blur import blur_order0_stacks


def calibrate_cld_qscales(config, model, sde, batch: int = 8, nfe: int = 12,
                          generator: torch.Generator | None = None,
                          u0: torch.Tensor | None = None) -> dict:
    """Per-site amaxes along an order-0 (exact-ODE) CLD trajectory of ``nfe``
    steps from u0, or from a prior draw of ``batch`` samples from
    ``generator`` (``calibrate.py:34-80``), the mixed score's analytic term
    added to eps as the sampler adds it. The model runs its plain
    composition in its own activation dtype. Returns {scope: {site: 0-d f32
    tensor}} on the model's device."""
    bundle = coefs.order0_bundle(sde.host(), nfe, denoising=False, is_em=False)
    stack = bundle.stack.astype(np.float32)  # (N, 2, 2, 2): [Psi | eps coef]
    ts = bundle.rev_ts[:-1].astype(np.float32)
    device = next(model.parameters()).device
    if u0 is None:
        s = config.data.image_size
        u0 = sde.prior_sampling(generator, (batch, s, s, config.data.num_channels), device)
    u = u0.to(device=device, dtype=torch.float32)
    qscales: dict = {}
    with torch.no_grad():
        for coef, t in zip(stack, ts):
            tv = torch.full((u.shape[0],), float(t), device=device)
            eps = unstack_channels_to_uv(model(stack_uv_to_channels(u), tv * 999.0,
                                               calib=qscales).float())
            if sde.mixed_score:
                eps = eps + mixed_score_term(sde, u, tv)
            u = sbmm(coef[0], u) + sbmm(coef[1], eps)
    return qscales


def calibrate_blur_qscales(config, model, sde, batch: int = 8, nfe: int = 12,
                           generator: torch.Generator | None = None,
                           u0: torch.Tensor | None = None) -> dict:
    """Per-site amaxes along an order-0 blur trajectory of ``nfe`` steps in
    DCT space (ts_order 2) from u0, or from a prior draw of ``batch`` samples
    from ``generator`` (``calibrate.py:83-112``); as calibrate_cld_qscales
    otherwise."""
    rev_ts, a_stack, b_stack = blur_order0_stacks(sde, nfe, ts_order=2.0)
    ts = rev_ts[:-1].astype(np.float32)
    device = next(model.parameters()).device
    if u0 is None:
        s = config.data.image_size
        u0 = sde.prior_sampling(generator, (batch, s, s, config.data.num_channels), device)
    y = u0.to(device=device, dtype=torch.float32)
    qscales: dict = {}
    with torch.no_grad():
        for a, b, t in zip(a_stack, b_stack, ts):
            labels = sde.encode_t(torch.full((y.shape[0],), float(t), device=device))
            eps = model(sde.y2x(y), labels, calib=qscales).float()
            y = torch.from_numpy(a).to(device) * y + torch.from_numpy(b).to(device) * sde.x2y(eps)
    return qscales
