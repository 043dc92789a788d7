"""Per-frequency (scalar) DEIS coefficients for blurring diffusion.

A port of ``gddim_tpu/math/deis_scalar.py``. The blur SDE is diagonal in DCT
space: its transition Psi(s,t) and eps integrand are per-frequency scalars
(H, W, 1) rather than CLD's 2x2 blocks (``gddim_torch/math/blur.py``). Each
Adams-Bashforth coefficient is an (H, W, 1) map

    C_j^{(i)} = int_{t_i}^{t_{i+1}} Psi(tau, t_{i+1}) E(tau) L_j(tau) dtau,

computed with the left-endpoint quadrature of the 2x2 engine
(``gddim_torch/math/deis.py``), vectorized over frequencies, in numpy
float64. Psi (and, with ``reference_exact``, the reference's integrand) are
evaluated in float32, as the JAX package evaluates them (``jnp`` without
x64): here by ``BlurSDE`` on CPU float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from gddim_torch.math.deis import lagrange_basis


def _f32_eval(fn, *ts):
    """fn on float32 CPU tensors of the times, back as float64 numpy."""
    args = (torch.as_tensor(np.asarray(t, dtype=np.float64), dtype=torch.float32) for t in ts)
    return fn(*args).double().numpy()


def _schedule_eps_integrand(sde, taus: np.ndarray) -> np.ndarray:
    """Exact per-frequency eps integrand E(tau) = s'(tau) - (m'/m)(tau) s(tau).

    Derived from the forward marginals y_t = m(t) y_0 + s(t) eps themselves
    (m = ``sde.y_mean_coef`` per frequency, s = ``sde.y_std_coef``, both in
    float64): with this E, int psi(tau,t') E(tau) dtau == s(t') - psi(t,t')
    s(t) holds exactly, i.e. order-0 DEIS reduces to the DDIM update. The
    reference's G/eps_integrand (blur_jax/sde_lib.py:58-77) drops the
    frequency-damping drift D'/D term, so E comes from the schedule
    (``reference_exact`` takes the reference's). Derivatives via float64
    central differences.
    """
    taus = np.asarray(taus, dtype=np.float64)
    h = 1e-7  # float64 central differences
    m = sde.y_mean_coef(taus)
    dm = (sde.y_mean_coef(taus + h) - sde.y_mean_coef(taus - h)) / (2 * h)
    s = sde.y_std_coef(taus)
    ds = (sde.y_std_coef(taus + h) - sde.y_std_coef(taus - h)) / (2 * h)
    return ds[:, None, None, None] - dm / m * s[:, None, None, None]


def _freq_core(sde, t_start: float, t_end: float, n_quad: int, reference_exact: bool = False):
    """Psi(tau, t_end) * E(tau) * dtau over the quadrature grid -> (n, H, W, 1)."""
    taus = t_start + (t_end - t_start) * np.arange(n_quad) / n_quad
    dt = (t_end - t_start) / n_quad
    psi = _f32_eval(sde.psi, taus, np.full_like(taus, t_end))
    if reference_exact:
        integrand = _f32_eval(sde.eps_integrand, taus)
    else:
        integrand = _schedule_eps_integrand(sde, taus)
    return psi * integrand * dt, taus


def blur_ab_eps_coef(sde, rev_ts: np.ndarray, order: int, n_quad: int = 2000,
                     reference_exact: bool = False) -> np.ndarray:
    """Scalar AB eps coefficients [N, order+1, H, W, 1] with warm-up."""
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    n_steps = len(rev_ts) - 1
    shape = sde.labda().shape[1:]  # (H, W, 1)
    out = np.zeros((n_steps, order + 1) + shape, dtype=np.float64)
    for i in range(n_steps):
        o = min(i, order)
        core, taus = _freq_core(sde, rev_ts[i], rev_ts[i + 1], n_quad, reference_exact)
        support = rev_ts[i - o : i + 1][::-1]
        for j in range(o + 1):
            w = lagrange_basis(taus, support, j)
            out[i, j] = np.einsum("n,nhwc->hwc", w, core)
    return out


def blur_deis_coef(sde, rev_ts: np.ndarray, order: int, n_quad: int = 2000,
                   reference_exact: bool = False):
    """(x_coef [N,H,W,1], eps_coef [N,order+1,H,W,1]) stacks, float64."""
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    x_coef = _f32_eval(sde.psi, rev_ts[:-1], rev_ts[1:])
    eps_coef = blur_ab_eps_coef(sde, rev_ts, order, n_quad, reference_exact)
    return x_coef, eps_coef
