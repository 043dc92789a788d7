"""Host-side float64 auxiliary SDE wrappers around the CLD schedule.

A copy of ``gddim_tpu/math/variants.py`` (numpy/scipy only), caching its
ODE tables through the port's own ``utils/io.py``. The coefficient-generating
twins of the reference's wrapper classes (citations into the original
cld_jax/sde_lib.py and sampling.py):

- :class:`HostLambdaSDE` — λ-parameterized hybrid stochastic kernel used by the
  "sdeis" sampler (sde_lib.py:334-466). Modified drift
  F̂ = F + ½(1+λ²) G Gᵀ Σ⁻¹, transition by ODE, conditional reverse covariance
  P(s,t), and polynomial ε coefficients.
- :class:`HostLSDE` — Cholesky-reparameterized ε space for the "ldeis" sampler
  (sde_lib.py:469-520).
- :class:`HostMLCLD` — rotated "y-space" that removes the conservative part F₁
  of the drift, used by the "mldeis" sampler (sampling.py:272-326).

All duck-type the `psi(s_arr, t) / eps_integrand(t_arr)` protocol the DEIS
builder consumes (gddim_torch/math/deis.py), as the reference feeds its
wrapper classes through one `get_ab_eps_coef`.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
from scipy.integrate import solve_ivp

from gddim_torch.math import deis
from gddim_torch.math.cld_host import HostCLD
from gddim_torch.math.linalg2 import inv2
from gddim_torch.utils.io import content_key, load_npz_cache, save_npz_cache

_ODE_RTOL = 1e-12
_ODE_ATOL = 1e-14


def _dense_matrix_ode(rhs_flat, y0: np.ndarray, t_max: float, cache_name: str, key: str):
    """Solve a (2,2)-matrix IVP on [0, t_max] and return a fine uniform table.

    `rhs_flat(t, y4) -> 4-tuple` operates on the row-major flattened matrix —
    scalar float arithmetic, because adaptive solvers call the RHS hundreds of
    thousands of times on stiff stretches and per-call numpy allocation
    dominates otherwise (measured ~20x).
    """
    n_grid = 100_001
    ts = np.linspace(0.0, t_max, n_grid)
    cached = load_npz_cache(cache_name, key)
    if cached is not None:
        return ts, cached["ys"]
    sol = solve_ivp(
        rhs_flat,
        (0.0, t_max),
        y0.reshape(-1),
        method="DOP853",
        rtol=_ODE_RTOL,
        atol=_ODE_ATOL,
        dense_output=True,
    )
    assert sol.success, sol.message
    ys = sol.sol(ts).T.reshape(n_grid, 2, 2)
    save_npz_cache(cache_name, key, ys=ys)
    return ts, ys


def _interp_table(ts, ys, t):
    t = np.clip(np.asarray(t, dtype=np.float64), ts[0], ts[-1])
    h = ts[1] - ts[0]
    idx = np.clip((t / h).astype(np.int64), 0, len(ts) - 2)
    frac = (t - ts[idx]) / h
    return ys[idx] + frac[..., None, None] * (ys[idx + 1] - ys[idx])


class HostLambdaSDE:
    """λ-interpolated stochastic gDDIM kernel (sde_lib.py:334-466)."""

    def __init__(
        self,
        cld: HostCLD,
        lambda_coef: float = 0.1,
        reference_exact: bool = False,
    ):
        self.cld = cld
        self.lambda_coef = float(lambda_coef)
        # reproduce the reference's Lyapunov integration bit-for-bit: the
        # untransposed `P @ F_hat` term (sde_lib.py:392, a bug yielding
        # non-symmetric covariances) and its endpoint=False stage-time grid
        # whose spacing (t-s)/(n+1) mismatches the RK4 step dt=(t-s)/n
        # (sde_lib.py:386-397)
        self.reference_exact = bool(reference_exact)

    def hat_F(self, t):
        """F̂ = F + ½(1+λ²) G Gᵀ Σ⁻¹ (sde_lib.py:350-355)."""
        g = self.cld.G(t)
        inv_cov = inv2(self.cld.cov(t))
        return self.cld.F(t) + 0.5 * (1.0 + self.lambda_coef**2) * (
            g @ g.swapaxes(-1, -2)
        ) @ inv_cov

    @cached_property
    def _hat_F_scalar(self):
        """Scalar-time F̂ entries `(f01, f10, f11)` (f00 is identically 0).

        Same math as :meth:`hat_F` — R-table linear interp, Σ = R Rᵀ,
        F̂ = F + ½(1+λ²) G Gᵀ Σ⁻¹ — expressed in plain float arithmetic for
        adaptive-ODE RHS loops where per-call numpy allocation dominates.
        """
        p = self.cld.p
        ts, rs = self.cld._r_solution
        h = float(ts[1] - ts[0])
        n2 = len(ts) - 2
        r00, r01 = rs[:, 0, 0], rs[:, 0, 1]
        r10, r11 = rs[:, 1, 0], rs[:, 1, 1]
        beta0, beta1 = p.beta_0, p.beta_1
        m_inv, gamma = p.m_inv, p.gamma
        c = 0.5 * (1.0 + self.lambda_coef**2)

        def entries(t: float):
            b = beta0 + beta1 * t
            x = t / h
            i = int(x)
            i = 0 if i < 0 else (n2 if i > n2 else i)
            f = x - i
            a00 = r00[i] + f * (r00[i + 1] - r00[i])
            a01 = r01[i] + f * (r01[i + 1] - r01[i])
            a10 = r10[i] + f * (r10[i + 1] - r10[i])
            a11 = r11[i] + f * (r11[i + 1] - r11[i])
            s00 = a00 * a00 + a01 * a01  # Sigma = R Rᵀ (symmetric)
            s01 = a00 * a10 + a01 * a11
            s11 = a10 * a10 + a11 * a11
            det = s00 * s11 - s01 * s01
            # GGᵀ = [[0,0],[0, 2Γb]]; c·GGᵀ Σ⁻¹ fills only the second row
            g2c = c * 2.0 * gamma * b / det
            return (
                b * m_inv,
                -b - g2c * s01,
                -gamma * b * m_inv + g2c * s00,
            )

        return entries

    def _hat_psi_rhs(self, t, y):
        """d/dt of row-major-flattened X for dX/dt = F̂(t) X."""
        f01, f10, f11 = self._hat_F_scalar(t)
        return (
            f01 * y[2],
            f01 * y[3],
            f10 * y[0] + f11 * y[2],
            f10 * y[1] + f11 * y[3],
        )

    @cached_property
    def _hat_psi_table(self):
        key = content_key(
            "lambda_hatpsi", *self.cld.p.key_parts(), self.lambda_coef, _ODE_RTOL
        )
        return _dense_matrix_ode(
            self._hat_psi_rhs,
            np.eye(2),
            1.0 + 1e-3,
            "lambda_hatpsi",
            key,
        )

    def hat_psi_02t(self, t):
        """Global X(t) table (API parity with sde_lib.py:357-375). Note: near
        t ~ sampling_eps, F̂ ~ Σ⁻¹ blows up and X varies on the table spacing,
        so coefficient builds use the exact per-interval solver below."""
        ts, ys = self._hat_psi_table
        return _interp_table(ts, ys, t)

    def _hat_psi_dense(self, t_from: float, t_to: float):
        """Dense X on [t_from, t_to] with X(t_from) = I (exact, adaptive)."""
        sol = solve_ivp(
            self._hat_psi_rhs,
            (t_from, t_to),
            np.eye(2).reshape(-1),
            method="DOP853",
            rtol=1e-12,
            atol=1e-14,
            dense_output=True,
        )
        assert sol.success, sol.message
        return sol.sol

    def hat_psi(self, s, t):
        """Ψ̂(s,t) with dΨ̂/dt = F̂ Ψ̂, Ψ̂(s,s)=I (sde_lib.py:377-379).

        Scalars solve one exact IVP; arrays solve per pair. (The reference
        composes two global-table lookups X(t) X(s)⁻¹, which loses accuracy
        where F̂ is stiff; per-interval solves are exact.)
        """
        s_arr = np.atleast_1d(np.asarray(s, dtype=np.float64))
        t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
        out = np.empty((len(s_arr), 2, 2))
        for i, (si, ti) in enumerate(zip(s_arr, t_arr)):
            dense = self._hat_psi_dense(float(si), float(ti))
            out[i] = dense(float(ti)).reshape(2, 2)
        if np.ndim(s) == 0 and np.ndim(t) == 0:
            return out[0]
        return out

    def cond_rev_cov_pairs(
        self, s_arr: np.ndarray, t_arr: np.ndarray, n_step: int = 10_000
    ) -> np.ndarray:
        """Conditional reverse covariances P(s_k, t_k) by fixed-step RK4, batched.

        Integrates the Lyapunov equation dP/dτ = F̂ P + P F̂ᵀ ± λ² G Gᵀ that the
        reference *documents* (sde_lib.py:383) but does not implement — its
        code uses `P @ F̂` untransposed (sde_lib.py:392), yielding
        non-symmetric, non-PSD "covariances" (a reference bug; with the
        transposed form the marginal-preservation identity
        Ψ̂ Σ(s) Ψ̂ᵀ + P(s,t) == Σ(t) holds to solver accuracy — see
        tests/test_samplers.py). All pairs integrate simultaneously with their
        F̂/GGᵀ stage values precomputed on the per-pair time grids (the
        reference runs a 10k-step fori_loop per pair).
        """
        s_arr = np.atleast_1d(np.asarray(s_arr, dtype=np.float64))
        t_arr = np.atleast_1d(np.asarray(t_arr, dtype=np.float64))
        n_pairs = len(s_arr)
        dts = (t_arr - s_arr) / n_step  # (P,)
        dir_sign = np.where(t_arr > s_arr, 1.0, -1.0)
        lam2 = self.lambda_coef**2

        # Per-pair stage time grids: tau_k, tau_k + dt/2, tau_k + dt.
        # reference_exact: stage bases come from linspace(s, t, n+1,
        # endpoint=False) — spacing (t-s)/(n+1) — while the RK4 step is still
        # dt=(t-s)/n (the reference's grid/step mismatch, sde_lib.py:386-397).
        stage_h = (t_arr - s_arr) / (n_step + 1) if self.reference_exact else dts
        base = s_arr[:, None] + stage_h[:, None] * np.arange(n_step)[None, :]  # (P, n)
        hf0 = self.hat_F(base)  # (P, n, 2, 2)
        hf_half = self.hat_F(base + 0.5 * dts[:, None])
        hf1 = self.hat_F(base + dts[:, None])

        def gg(tau):
            g = self.cld.G(tau)
            return g @ g.swapaxes(-1, -2)

        const0 = dir_sign[:, None, None, None] * lam2 * gg(base)
        const_half = dir_sign[:, None, None, None] * lam2 * gg(base + 0.5 * dts[:, None])
        const1 = dir_sign[:, None, None, None] * lam2 * gg(base + dts[:, None])

        x = np.zeros((n_pairs, 2, 2))
        dt_b = dts[:, None, None]
        for i in range(n_step):
            a0, ah, a1 = hf0[:, i], hf_half[:, i], hf1[:, i]
            if self.reference_exact:
                # the reference's untransposed second term (sde_lib.py:392)
                a0t, aht, a1t = a0, ah, a1
            else:
                a0t, aht, a1t = (m.swapaxes(-1, -2) for m in (a0, ah, a1))
            c0, ch, c1 = const0[:, i], const_half[:, i], const1[:, i]
            k1 = a0 @ x + x @ a0t + c0
            x2 = x + 0.5 * dt_b * k1
            k2 = ah @ x2 + x2 @ aht + ch
            x3 = x + 0.5 * dt_b * k2
            k3 = ah @ x3 + x3 @ aht + ch
            x4 = x + dt_b * k3
            k4 = a1 @ x4 + x4 @ a1t + c1
            x = x + dt_b / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    def cond_rev_cov(self, s: float, t: float, n_step: int = 10_000) -> np.ndarray:
        return self.cond_rev_cov_pairs(np.array([s]), np.array([t]), n_step)[0]

    def update_coef(self, s: float, t: float) -> np.ndarray:
        """Order-0 per-step [x_coef, eps_coef, cov] stack (sde_lib.py:401-407)."""
        x_coef = self.cld.psi(s, t)
        eps_coef = (self.hat_psi(s, t) - x_coef) @ self.cld.R(s)
        cov = self.cond_rev_cov(s, t)
        return np.stack([x_coef, eps_coef, cov])

    # --- DEIS protocol for the polynomial (order>0) branch -------------------
    class _PolyView:
        """Duck-typed SDE view feeding the generic AB builder (sde_lib.py:409-423)."""

        def __init__(self, outer: "HostLambdaSDE"):
            self.outer = outer

        def psi(self, s, t):
            """Ψ̂(s_k, t) for a quadrature grid s over one step ending at
            scalar t: one exact dense solve per step (X anchored at s[0]),
            Ψ̂(s_k, t) = X(t) X(s_k)⁻¹."""
            o = self.outer
            s = np.atleast_1d(np.asarray(s, dtype=np.float64))
            t_end = float(np.asarray(t, dtype=np.float64))
            dense = o._hat_psi_dense(float(s[0]), t_end)
            x_s = dense(s).T.reshape(len(s), 2, 2)
            x_t = dense(t_end).reshape(2, 2)
            return x_t @ inv2(x_s)

        def eps_integrand(self, taus):
            o = self.outer
            g = o.cld.G(taus)
            inv_cov = inv2(o.cld.cov(taus))
            return (
                0.5
                * (1.0 + o.lambda_coef**2)
                * (g @ g.swapaxes(-1, -2))
                @ inv_cov
                @ o.cld.psi(np.zeros_like(np.asarray(taus)), taus)
            )

    def poly_eps_coef(self, rev_ts: np.ndarray, order: int, n_quad: int = 10_000):
        """AB eps coefficients in the λ kernel (sde_lib.py:409-433).

        Each step-i coefficient block is right-multiplied by
        Ψ(t_i, 0) R(t_i) (the reference's `last_term`).
        """
        ab = deis.ab_eps_coef(self._PolyView(self), rev_ts, order, n_quad)
        last = self.cld.psi(rev_ts[:-1], np.zeros(len(rev_ts) - 1)) @ self.cld.R(
            rev_ts[:-1]
        )
        return np.einsum("boij,bjk->boik", ab, last)

    def deis_coef(
        self, rev_ts: np.ndarray, order: int, use_order0: bool = True
    ) -> np.ndarray:
        """Full sdeis stack [N, order+4, 2, 2]: [Psi | eps coefs | cov].

        order==0 with use_order0 uses the exact order-0 update coefficients
        (sde_lib.py:435-466); otherwise the polynomial branch.
        """
        rev_ts = np.asarray(rev_ts, dtype=np.float64)
        n = len(rev_ts) - 1
        covs = self.cond_rev_cov_pairs(rev_ts[:-1], rev_ts[1:])  # (N, 2, 2)
        x_coef = self.cld.psi(rev_ts[:-1], rev_ts[1:])
        if use_order0 and order == 0:
            eps_coef = (
                self.hat_psi(rev_ts[:-1], rev_ts[1:]) - x_coef
            ) @ self.cld.R(rev_ts[:-1])
            zeros = np.zeros((n, 1, 2, 2))
            return np.concatenate(
                [x_coef[:, None], eps_coef[:, None], zeros, covs[:, None]], axis=1
            )
        eps_coef = self.poly_eps_coef(rev_ts, order)
        return np.concatenate([x_coef[:, None], eps_coef, covs[:, None]], axis=1)


class HostLSDE:
    """Cholesky-reparameterized ε space (sde_lib.py:469-520)."""

    def __init__(self, cld: HostCLD):
        self.cld = cld

    def L(self, t):
        return np.linalg.cholesky(self.cld.cov(t))

    def eps_r2l_coef(self, t):
        """L(t)ᵀ R(t)^{-T}: converts the model's ε_R to ε_L (sde_lib.py:493-499)."""
        return self.L(t).swapaxes(-1, -2) @ inv2(self.cld.R(t)).swapaxes(-1, -2)

    def psi(self, s, t):
        return self.cld.psi(s, t)

    def eps_integrand(self, t):
        """½ G G L^{-T} (sde_lib.py:502-507; reference uses G@G == G@Gᵀ)."""
        g = self.cld.G(t)
        return 0.5 * (g @ g.swapaxes(-1, -2)) @ inv2(self.L(t)).swapaxes(-1, -2)

    def deis_coef(self, rev_ts: np.ndarray, order: int) -> np.ndarray:
        return deis.deis_coef_stack(self, rev_ts, order)


class HostMLCLD:
    """Rotated y-space removing the conservative drift F₁ (sampling.py:272-326)."""

    def __init__(self, cld: HostCLD):
        if cld.p.beta_1 != 0:
            raise ValueError("MLCLD requires beta_1 == 0 (reference assertion)")
        self.cld = cld

    @cached_property
    def _psi2_table(self):
        key = content_key("mlcld_psi2", *self.cld.p.key_parts(), _ODE_RTOL)
        p = self.cld.p
        beta0 = p.beta_0  # beta_1 == 0 (asserted in __init__)
        m_inv, gamma = p.m_inv, p.gamma
        inv_sqrt_m = np.sqrt(m_inv)
        sqrt_m = 1.0 / inv_sqrt_m
        import math

        def rhs_flat(t, y):
            # M(t) = Ψ₁⁻¹ F₂ Ψ₁ in closed form: with θ = β∫·m^{-1/2} and
            # d = Γ β m⁻¹,  M = d·[[-sin²θ, m^{-1/2}·sinθcosθ],
            #                      [m^{1/2}·sinθcosθ, -cos²θ]]
            th = beta0 * t * inv_sqrt_m
            c_, s_ = math.cos(th), math.sin(th)
            d = gamma * beta0 * m_inv
            m00 = -d * s_ * s_
            m01 = d * inv_sqrt_m * s_ * c_
            m10 = d * sqrt_m * s_ * c_
            m11 = -d * c_ * c_
            return (
                m00 * y[0] + m01 * y[2],
                m00 * y[1] + m01 * y[3],
                m10 * y[0] + m11 * y[2],
                m10 * y[1] + m11 * y[3],
            )

        return _dense_matrix_ode(rhs_flat, np.eye(2), 1.0 + 1e-3, "mlcld_psi2", key)

    def psi2(self, t):
        ts, ys = self._psi2_table
        return _interp_table(ts, ys, t)

    def psi(self, s, t):
        return self.psi2(t) @ inv2(self.psi2(np.asarray(s, dtype=np.float64)))

    def eps_integrand(self, taus):
        c = self.cld
        g = c.G(taus)
        return 0.5 * c.inv_psi1(taus) @ (g @ g.swapaxes(-1, -2)) @ inv2(
            c.R(taus)
        ).swapaxes(-1, -2)

    def deis_coef(self, rev_ts: np.ndarray, order: int) -> np.ndarray:
        return deis.deis_coef_stack(self, rev_ts, order)
