"""DEIS polynomial-extrapolation coefficients (host-side float64).

The gDDIM/DEIS multistep sampler advances
    u_{i+1} = Psi(t_i, t_{i+1}) u_i + sum_j C_j^{(i)} eps_j
where eps_j are the model's epsilon predictions at the current and previous
steps and the C_j are 2x2 matrices

    C_j^{(i)} = int_{t_i}^{t_{i+1}} Psi(tau, t_{i+1}) E(tau) L_j(tau) dtau,

with E the eps integrand (1/2 G G^T R^{-T} for CLD) and L_j the Lagrange basis
over the polynomial support points {t_i, t_{i-1}, ..., t_{i-order}}. The first
`order` steps use lower effective orders (warm-up), matching the reference's
recursive builder (cld_jax/deis.py:71-95). The quadrature is the reference's
left-endpoint rule with `n_quad` points per interval (cld_jax/deis.py:19-59).

This module is generic over the "SDE" object: it only needs vectorized
``psi(s_array, t_scalar) -> (n,2,2)`` and ``eps_integrand(t_array) -> (n,2,2)``
(duck-typing parity with the reference, which feeds CLD / MLCLD / LSDE /
LambdaSDE through one builder).

Everything here is numpy float64 on the host; the resulting [N, order+3, 2, 2]
stack is shipped to the device as an f32 constant folded into the sampling scan.
"""

from __future__ import annotations

import numpy as np

N_QUAD_DEFAULT = 10_000  # reference: cld_jax/deis.py:43,52


def lagrange_basis(x: np.ndarray, support: np.ndarray, j: int) -> np.ndarray:
    """L_j(x) for the Lagrange basis over `support` (cld_jax/deis.py:30-38)."""
    x = np.asarray(x, dtype=np.float64)[:, None]  # (n, 1)
    support = np.asarray(support, dtype=np.float64)[None, :]  # (1, k)
    num = x - support
    den = support[0, j] - support
    num[:, j] = 1.0
    den[0, j] = 1.0
    return np.prod(num, axis=1) / np.prod(den)


def _step_core(sde, t_start: float, t_end: float, n_quad: int):
    """Psi(tau, t_end) @ E(tau) * dtau over the left-endpoint grid -> (n,2,2)."""
    taus = t_start + (t_end - t_start) * np.arange(n_quad) / n_quad
    dt = (t_end - t_start) / n_quad
    psi = sde.psi(taus, t_end)  # (n, 2, 2)
    integrand = sde.eps_integrand(taus)  # (n, 2, 2)
    return np.einsum("nij,njk->nik", psi, integrand) * dt, taus


def ab_eps_coef(
    sde, rev_ts: np.ndarray, order: int, n_quad: int = N_QUAD_DEFAULT
) -> np.ndarray:
    """Adams-Bashforth eps coefficients [N, order+2, 2, 2].

    Row i holds matrices for eps at times [t_i, t_{i-1}, ..., t_{i-o}] with
    effective order o = min(i, order); trailing entries are zero-padded to the
    fixed width order+2 the sampler's fixed-length eps history expects
    (reference row width: highest_order+1 with highest_order=order+1,
    cld_jax/sde_lib.py:316, deis.py:49-59).
    """
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    n_steps = len(rev_ts) - 1
    width = order + 2
    out = np.zeros((n_steps, width, 2, 2), dtype=np.float64)
    for i in range(n_steps):
        o = min(i, order)
        core, taus = _step_core(sde, rev_ts[i], rev_ts[i + 1], n_quad)
        support = rev_ts[i - o : i + 1][::-1]  # [t_i, t_{i-1}, ..., t_{i-o}]
        for j in range(o + 1):
            w = lagrange_basis(taus, support, j)
            out[i, j] = np.einsum("n,nij->ij", w, core)
    return out


def am_eps_coef(
    sde, rev_ts: np.ndarray, order: int, n_quad: int = N_QUAD_DEFAULT
) -> np.ndarray:
    """Adams-Moulton (implicit) eps coefficients [N, order+2, 2, 2].

    Row i's support points are [t_{i+1}, t_i, ..., t_{i-o+1}] (the *end* point
    of the step is included). Mirrors cld_jax/deis.py:97-139 (unused by the
    reference's samplers but part of the coefficient engine's surface).
    """
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    n_steps = len(rev_ts) - 1
    width = order + 2
    if order < 1:
        raise ValueError("Adams-Moulton requires order >= 1")
    out = np.zeros((n_steps, width, 2, 2), dtype=np.float64)
    for i in range(n_steps):
        o = min(i + 1, order)
        core, taus = _step_core(sde, rev_ts[i], rev_ts[i + 1], n_quad)
        support = rev_ts[i - o + 1 : i + 2][::-1]  # [t_{i+1}, t_i, ...]
        for j in range(o + 1):
            w = lagrange_basis(taus, support, j)
            out[i, j] = np.einsum("n,nij->ij", w, core)
    return out


def order0_eps_coef(sde, rev_ts: np.ndarray, n_quad: int = 1000) -> np.ndarray:
    """Exact-ODE order-0 eps matrix per step [N, 2, 2].

    int Psi(tau, t_end) E(tau) dtau with the reference's 1000-point rule
    (cld_jax/sde_lib.py:289-306).
    """
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    n_steps = len(rev_ts) - 1
    out = np.zeros((n_steps, 2, 2), dtype=np.float64)
    for i in range(n_steps):
        core, _ = _step_core(sde, rev_ts[i], rev_ts[i + 1], n_quad)
        out[i] = core.sum(axis=0)
    return out


def naive_em_coef(sde, rev_ts: np.ndarray):
    """Euler-discretized mean/eps matrices (cld_jax/sde_lib.py:276-287).

    mean_i = I + F(t_i) dt;  eps_i = E(t_i) dt.
    """
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    dts = rev_ts[1:] - rev_ts[:-1]
    eye = np.eye(2)[None]
    mean = eye + sde.F(rev_ts[:-1]) * dts[:, None, None]
    eps = sde.eps_integrand(rev_ts[:-1]) * dts[:, None, None]
    return mean, eps


def deis_coef_stack(
    sde, rev_ts: np.ndarray, order: int, n_quad: int = N_QUAD_DEFAULT
) -> np.ndarray:
    """Full per-step stack [N, order+3, 2, 2]: [Psi | eps coefs (padded)].

    Matches the reference layout consumed by `multistep_ab_step`
    (cld_jax/sde_lib.py:308-319, deis.py:141-151).
    """
    rev_ts = np.asarray(rev_ts, dtype=np.float64)
    x_coef = sde.psi(rev_ts[:-1], rev_ts[1:])  # (N, 2, 2) pairwise
    eps_coef = ab_eps_coef(sde, rev_ts, order, n_quad)
    return np.concatenate([x_coef[:, None], eps_coef], axis=1)
