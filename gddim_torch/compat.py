"""Reference-API compatibility shims (counterpart of ``gddim_tpu/compat.py``).

The reference's public names (cld_jax/models/utils.py, cld_jax/sde_lib.py,
cld_jax/utils.py) mapped onto the port's, so code written against the
reference finds the same entry points here. Where the JAX shims take flax
variables, these take the port's ``nn.Module`` and, optionally, a flax
parameter tree to load into it (``convert.flax_to_state_dict``); tensors
are torch tensors, and a ``torch.Generator`` stands for a PRNG key.
"""

from __future__ import annotations

import numpy as np
import torch

# models/utils.py surface -----------------------------------------------------
from gddim_torch.models.registry import get_model, register_model  # noqa: F401
from gddim_torch.models.wideresnet import (  # noqa: F401
    create_classifier,
    get_classifier_grad_fn,
    get_logit_fn,
)
from gddim_torch.models.wrappers import make_cld_eps_fn, make_cld_score_fn
from gddim_torch.train.state import TrainState as State  # noqa: F401

# sde_lib.py surface -----------------------------------------------------------
from gddim_torch.math.cld import CLD  # noqa: F401
from gddim_torch.math.linalg2 import bmm, inv2 as inv_2x2, sbmm  # noqa: F401
from gddim_torch.math.variants import (  # noqa: F401
    HostLambdaSDE as LambdaSDE,
    HostLSDE as LSDE,
    HostMLCLD as MLCLD,
)


def from_config(config):
    """CLD factory (reference cld_jax/sde_lib.py:321-331)."""
    return CLD.from_config(config)


def init_model(rng, config, device="cuda"):
    """(model, states, params) as the reference's init_model
    (models/utils.py:109-125): the configured model drawn from ``rng`` (a
    CPU ``torch.Generator``, or an int seed) and moved to ``device``; states
    {} (the port's models keep no mutable collection); params its flax
    parameter tree (numpy), which get_eps_fn / get_score_fn load back."""
    from gddim_torch.convert import state_dict_to_flax

    if not isinstance(rng, torch.Generator):
        rng = torch.Generator().manual_seed(int(rng))
    model = get_model(config.model.name)(config, generator=rng).to(device).eval()
    return model, {}, state_dict_to_flax(model)


def _load(model, params, states):
    """Load a flax parameter tree and a 'qscales' collection into the model
    (None: its weights and scales stand)."""
    from gddim_torch import convert

    if params is not None:
        model.load_state_dict(convert.flax_to_state_dict(model, params))
    if states and states.get("qscales"):
        model.qscales = convert.qscales_from_flax(model, states["qscales"])


def _closure(apply, model, states, return_state):
    def fn(x, t, rng=None):
        out = apply(model, x, t, rng)
        return (out, states) if return_state else out

    return fn


def get_eps_fn(sde, model, params=None, states=None, train=False, continuous=True,
               return_state=False):
    """Closure-style eps function (reference models/utils.py:168-182):
    fn(x, t, rng=None) -> eps, or (eps, states) with return_state. With
    train=True the training path runs and ``rng``, a torch.Generator on
    x's device, draws the dropout masks."""
    _load(model, params, states)
    return _closure(make_cld_eps_fn(sde, train=train), model, states, return_state)


def get_score_fn(sde, model, params=None, states=None, train=False, continuous=True,
                 return_state=False):
    """Closure-style score function (reference models/utils.py:184-211):
    eps2score of get_eps_fn's eps."""
    _load(model, params, states)
    return _closure(make_cld_score_fn(sde, train=train), model, states, return_state)


def get_sigmas(config) -> np.ndarray:
    """SMLD noise scales (reference models/utils.py:69-81)."""
    from gddim_torch.models.unet import get_sigmas as _g

    return _g(config)


def get_ddpm_params(config) -> dict:
    """Original-DDPM schedule constants (reference models/utils.py:84-106),
    f64, from model.beta_min / beta_max / num_scales."""
    num_diffusion_timesteps = 1000
    beta_start = config.model.beta_min / config.model.num_scales
    beta_end = config.model.beta_max / config.model.num_scales
    betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


def to_flattened_numpy(x) -> np.ndarray:
    """A tensor (or array) as a flat numpy array (reference models/utils.py:214-216)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def from_flattened_numpy(x, shape, device="cuda") -> torch.Tensor:
    """A flat array as a tensor of ``shape`` on ``device`` (reference
    models/utils.py:219-221); float64 becomes float32, as jnp.asarray
    makes it."""
    t = torch.as_tensor(np.asarray(x)).reshape(shape)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def get_data_shape(config):
    from gddim_torch.data.pipelines import get_data_shape as _g

    return _g(config)


def aug_batch(batch: torch.Tensor) -> torch.Tensor:
    """Stack a zero velocity channel (reference cld_jax/utils.py:187-192)."""
    return torch.stack([batch, torch.zeros_like(batch)], -1)
