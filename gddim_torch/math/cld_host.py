"""Host-side float64 CLD schedule math (numpy/scipy).

Everything numerically delicate about the CLD forward SDE lives here and runs
once on the host in float64: the noise-factor ODE R(t), the transition kernel
Psi(s, t), and the integrands feeding the DEIS quadrature. The device side
(gddim_torch/math/cld.py) consumes only precomputed float32 tables/constants.

Reference semantics reproduced (citations into the original cld_jax code):
- forward SDE drift F(t), diffusion G(t): cld_jax/sde_lib.py:215-234
- closed-form transition Psi(s,t) = expm(int_s^t F):  cld_jax/sde_lib.py:182-205
- R(t) ODE dR/dt = F R + 1/2 G G^T R^{-T}, R(0)=R_0: cld_jax/sde_lib.py:93-118
  (the reference integrates with fixed-step Euler-midpoint dt=1e-5 or RK4
  dt=1e-6; we solve the same IVP with scipy DOP853 at rtol=1e-12, which the
  reference's RK4-1e-6 converges to)
- eps integrand 1/2 G G^T R^{-T}: cld_jax/sde_lib.py:208-212
- conservative/dissipative split F1/F2 and expm(F1) rotation used by the
  "mldeis" sampler: cld_jax/sde_lib.py:120-178
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
from scipy.integrate import solve_ivp

from gddim_torch.math.linalg2 import inv2, mat2
from gddim_torch.utils.io import content_key, load_npz_cache, save_npz_cache

_ODE_RTOL = 1e-12
_ODE_ATOL = 1e-14
_T_MARGIN = 1.0 + 1e-3  # R-table domain upper edge (reference grid ends ~1+dt)


@dataclasses.dataclass(frozen=True)
class CLDParams:
    """Static CLD hyperparameters (reference defaults: cld_jax/sde_lib.py:46-48)."""

    m_inv: float = 4.0
    beta_0: float = 4.0
    beta_1: float = 0.0
    vv_gamma: float = 0.04
    numerical_eps: float = 1e-6
    T: float = 1.0
    sampling_eps: float = 1e-3

    @property
    def gamma(self) -> float:
        return 2.0 / np.sqrt(self.m_inv)

    def key_parts(self):
        return (
            self.m_inv,
            self.beta_0,
            self.beta_1,
            self.vv_gamma,
            self.numerical_eps,
        )

    @classmethod
    def from_config(cls, config) -> "CLDParams":
        m = config.model
        return cls(
            m_inv=float(m.m_inv),
            beta_0=float(m.beta_0),
            beta_1=float(m.beta_1),
            vv_gamma=float(m.vv_gamma),
        )


class HostCLD:
    """Vectorized float64 CLD math. All methods accept scalar or ndarray t."""

    def __init__(self, params: CLDParams = CLDParams()):
        self.p = params

    # --- schedule scalars -------------------------------------------------
    def beta(self, t):
        return self.p.beta_0 + self.p.beta_1 * np.asarray(t, dtype=np.float64)

    def beta_int(self, t):
        t = np.asarray(t, dtype=np.float64)
        return self.p.beta_0 * t + 0.5 * self.p.beta_1 * t**2

    # --- matrices ---------------------------------------------------------
    def F(self, t):
        """Drift [[0, b*m_inv], [-b, -Gamma*b*m_inv]] (sde_lib.py:215-224)."""
        b = self.beta(t)
        z = np.zeros_like(b)
        return mat2(z, b * self.p.m_inv, -b, -self.p.gamma * b * self.p.m_inv)

    def G(self, t):
        """Diffusion [[0,0],[0, sqrt(2*Gamma*b)]] (sde_lib.py:226-234)."""
        b = self.beta(t)
        z = np.zeros_like(b)
        return mat2(z, z, z, np.sqrt(2.0 * self.p.gamma * b))

    def psi(self, s, t):
        """Closed-form transition expm(int_s^t F) (sde_lib.py:182-205).

        With a = 2*sqrt(m_inv) and tau = beta_int(t) - beta_int(s):
        exp(-a*tau/2) * [[1 + a*tau/2, a^2*tau/4], [-tau, 1 - a*tau/2]].
        """
        tau = self.beta_int(t) - self.beta_int(s)
        tau = np.asarray(tau, dtype=np.float64)
        a = 2.0 * np.sqrt(self.p.m_inv)
        coef = np.exp(-a * tau / 2.0)
        one = np.ones_like(tau)
        m = mat2(one + a * tau / 2.0, 0.25 * a * a * tau, -tau, one - a * tau / 2.0)
        return m * coef[..., None, None]

    # --- conservative/dissipative split (mldeis) ---------------------------
    def F1(self, t):
        """Conservative part [[0, b*m_inv], [-b, 0]] (sde_lib.py:158-167)."""
        b = self.beta(t)
        z = np.zeros_like(b)
        return mat2(z, b * self.p.m_inv, -b, z)

    def F2(self, t):
        """Dissipative part [[0,0],[0,-Gamma*b*m_inv]] (sde_lib.py:168-178)."""
        b = self.beta(t)
        z = np.zeros_like(b)
        return mat2(z, z, z, -self.p.gamma * b * self.p.m_inv)

    def f1_psi(self, s, t):
        """expm(-int_s^t F1): a rotation (sde_lib.py:120-143)."""
        tau = self.beta_int(t) - self.beta_int(s)
        tau = np.asarray(tau, dtype=np.float64)
        inv_sqrt_m = np.sqrt(self.p.m_inv)
        sqrt_m = 1.0 / inv_sqrt_m
        c = np.cos(tau * inv_sqrt_m)
        s_ = np.sin(tau * inv_sqrt_m)
        return mat2(c, inv_sqrt_m * s_, -sqrt_m * s_, c)

    def psi1(self, t):
        """expm(int_0^t F1); x = psi1 @ y (sde_lib.py:145-149)."""
        return self.f1_psi(0.0, t)

    def inv_psi1(self, t):
        return self.f1_psi(t, 0.0)

    # --- R(t): noise-covariance factor -------------------------------------
    @property
    def R0(self) -> np.ndarray:
        p = self.p
        return np.array(
            [
                [np.sqrt(p.numerical_eps), 0.0],
                [0.0, np.sqrt(p.vv_gamma / p.m_inv + p.numerical_eps)],
            ],
            dtype=np.float64,
        )

    @cached_property
    def _r_solution(self):
        """Dense float64 solution of dR/dt = F R + 1/2 G G^T R^{-T} on [0, T+margin].

        Cached to disk as a fine uniform table; re-solved only on a cache miss.
        """
        key = content_key("cld_r", *self.p.key_parts(), _ODE_RTOL, _T_MARGIN)
        cached = load_npz_cache("cld_r", key)
        n_grid = 100_001
        ts = np.linspace(0.0, _T_MARGIN, n_grid)
        if cached is not None:
            return ts, cached["rs"]

        def rhs(t, y):
            r = y.reshape(2, 2)
            dr = self.F(t) @ r + 0.5 * (self.G(t) @ self.G(t).T) @ inv2(r).T
            return dr.reshape(-1)

        sol = solve_ivp(
            rhs,
            (0.0, _T_MARGIN),
            self.R0.reshape(-1),
            method="DOP853",
            rtol=_ODE_RTOL,
            atol=_ODE_ATOL,
            dense_output=True,
        )
        assert sol.success, sol.message
        rs = sol.sol(ts).T.reshape(n_grid, 2, 2)
        save_npz_cache("cld_r", key, rs=rs)
        return ts, rs

    def R(self, t):
        """R(t) by cubic-free uniform-grid linear interp of the dense solution."""
        ts, rs = self._r_solution
        t = np.clip(np.asarray(t, dtype=np.float64), ts[0], ts[-1])
        h = ts[1] - ts[0]
        idx = np.clip((t / h).astype(np.int64), 0, len(ts) - 2)
        frac = (t - ts[idx]) / h
        return rs[idx] + frac[..., None, None] * (rs[idx + 1] - rs[idx])

    def invR(self, t):
        return inv2(self.R(t))

    def cov(self, t):
        r = self.R(t)
        return r @ r.swapaxes(-1, -2)

    def eps_integrand(self, t):
        """1/2 G G^T R^{-T} (sde_lib.py:208-212)."""
        g = self.G(t)
        return 0.5 * (g @ g.swapaxes(-1, -2)) @ self.invR(t).swapaxes(-1, -2)

    # --- device export ------------------------------------------------------
    def r_table(self, n: int = 8192, dtype=np.float32):
        """Uniform-grid R(t) table for on-device interpolation.

        A uniform grid turns interpolation into index arithmetic +
        one gather (no searchsorted), and n=8192 keeps the table at 128 KiB.
        """
        ts = np.linspace(0.0, _T_MARGIN, n)
        return ts.astype(dtype), self.R(ts).astype(dtype)
