"""Host-side coefficient bundle for the deis sampler.

The part of ``gddim_tpu/samplers/coefs.py`` that deis needs, copied: every
step's 2x2 constants are computed in float64 on the host, cached by content,
and consumed by ``samplers/engine.py``.

Layout of the linear-multistep stack (N steps):
    stack[:, 0]     -- 2x2 state transition applied to u
    stack[:, 1:K]   -- 2x2 matrices applied to [eps_now, eps_prev, ...]
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gddim_torch.math import deis
from gddim_torch.math.cld_host import HostCLD
from gddim_torch.math.linalg2 import inv2
from gddim_torch.samplers.timegrid import rev_time_grid
from gddim_torch.utils.io import content_key, load_npz_cache, save_npz_cache


@dataclasses.dataclass
class DenoiseConsts:
    """Final analytic denoising step (cld_jax/sampling.py:30-39).

    u <- u - eps*(F(t) u - G G^T score(u, t)), score = -invR^T eps_model.
    """

    t: float
    eps: float
    F: np.ndarray  # (2, 2)
    GG: np.ndarray  # (2, 2) = G @ G
    invR_T: np.ndarray  # (2, 2)


@dataclasses.dataclass
class ABBundle:
    """Everything one multistep CLD sampler run needs."""

    name: str
    rev_ts: np.ndarray  # (N+1,) float64
    stack: np.ndarray  # (N, K, 2, 2) [x_coef | eps coefs]
    hist_len: int  # number of previous eps kept
    nfe: int  # reported NFE (includes the denoise step if present)
    denoise: DenoiseConsts | None = None


def _denoise_consts(host: HostCLD) -> DenoiseConsts:
    t = host.p.sampling_eps
    g = host.G(t)
    return DenoiseConsts(
        t=t,
        eps=t,
        F=host.F(t),
        GG=g @ g,  # reference uses G @ G (== G @ G.T for diagonal G)
        invR_T=inv2(host.R(t)).T,
    )


def _grid(host: HostCLD, nfe: int, ts_order: float, denoising: bool) -> np.ndarray:
    num_step = nfe - 1 if denoising else nfe
    return rev_time_grid(host.p.T, host.p.sampling_eps, num_step, ts_order)


def _cached_stack(name: str, key_parts, builder):
    key = content_key(name, *key_parts)
    cached = load_npz_cache(name, key)
    if cached is not None:
        return {k: cached[k] for k in cached}
    out = builder()
    save_npz_cache(name, key, **out)
    return out


def deis_bundle(
    host: HostCLD,
    nfe: int,
    order: int,
    ts_order: float = 2.0,
    denoising: bool = True,
    rev_ts: np.ndarray | None = None,
    name: str = "deis",
) -> ABBundle:
    """gDDIM multistep AB (cld_jax/sampling.py:204-253)."""
    if rev_ts is None:
        rev_ts = _grid(host, nfe, ts_order, denoising)
    out = _cached_stack(
        f"cld_{name}", (host.p.key_parts(), rev_ts, order),
        lambda: {"stack": deis.deis_coef_stack(host, rev_ts, order)},
    )
    return ABBundle(
        name=name,
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=order + 1,
        nfe=nfe,
        denoise=_denoise_consts(host) if denoising else None,
    )


def order0_bundle(
    host: HostCLD,
    nfe: int,
    denoising: bool = True,
    is_em: bool = False,
    ts_order: float = 2.0,
) -> ABBundle:
    """Exact-ODE order-0 / naive-Euler sampler (cld_jax/sampling.py:156-202);
    the int8 calibration runs its trajectory (``models/calibrate.py``)."""
    rev_ts = _grid(host, nfe, ts_order, denoising)

    def build():
        if is_em:
            mean, eps = deis.naive_em_coef(host, rev_ts)
        else:
            mean = host.psi(rev_ts[:-1], rev_ts[1:])
            eps = deis.order0_eps_coef(host, rev_ts, n_quad=1000)
        return {"stack": np.concatenate([mean[:, None], eps[:, None]], axis=1)}

    out = _cached_stack("cld_order0", (host.p.key_parts(), rev_ts, bool(is_em)), build)
    return ABBundle(
        name="order0",
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=0,
        nfe=nfe,
        denoise=_denoise_consts(host) if denoising else None,
    )
