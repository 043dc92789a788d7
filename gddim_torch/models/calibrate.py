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
"""

from __future__ import annotations

import numpy as np
import torch

from gddim_torch.math.linalg2 import sbmm
from gddim_torch.models.wrappers import stack_uv_to_channels, unstack_channels_to_uv
from gddim_torch.samplers import coefs


def calibrate_cld_qscales(config, model, sde, batch: int = 8, nfe: int = 12,
                          generator: torch.Generator | None = None,
                          u0: torch.Tensor | None = None) -> dict:
    """Per-site amaxes along an order-0 (exact-ODE) CLD trajectory of ``nfe``
    steps from u0, or from a prior draw of ``batch`` samples from
    ``generator`` (``calibrate.py:34-80``). The model runs its plain
    composition in its own activation dtype. Returns {scope: {site: 0-d f32
    tensor}} on the model's device."""
    if sde.mixed_score:
        raise NotImplementedError("mixed_score is not ported")
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
            labels = torch.full((u.shape[0],), float(t), device=device) * 999.0
            eps = unstack_channels_to_uv(model(stack_uv_to_channels(u), labels, calib=qscales).float())
            u = sbmm(coef[0], u) + sbmm(coef[1], eps)
    return qscales
