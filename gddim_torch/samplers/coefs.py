"""Host-side per-sampler coefficient bundles (a copy of
``gddim_tpu/samplers/coefs.py``).

Each CLD sampler is reduced to a stack of per-step constants computed in
float64 on the host and consumed step by step by ``samplers/engine.py``.
Bundles are cached content-addressed through the port's ``utils/io.py``.

Layout convention for the linear-multistep stack (N steps):
    stack[:, 0]     -- 2x2 state transition applied to u
    stack[:, 1:K]   -- 2x2 matrices applied to [eps_now, eps_prev, ...]
Optional extras ride alongside: per-step noise factors (correlated 2-D noise
via one 2x2 product, in place of `random.multivariate_normal(method="svd")`),
fresh-eps transforms (ldeis), and state transforms (mldeis y-space).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gddim_torch.math import deis
from gddim_torch.math.cld_host import HostCLD
from gddim_torch.math.linalg2 import inv2
from gddim_torch.math.variants import HostLambdaSDE, HostLSDE, HostMLCLD
from gddim_torch.samplers.timegrid import hybrid_time_grid, rev_time_grid
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
    hist_len: int  # number of previous eps kept (K-2 for deis, 0 for order0)
    nfe: int  # reported NFE (includes the denoise step if present)
    noise_factors: np.ndarray | None = None  # (N, 2, 2)
    eps_tf: np.ndarray | None = None  # (N, 2, 2) applied to fresh eps
    state_tf: np.ndarray | None = None  # (N, 2, 2) model input u_x = A_i u
    init_tf: np.ndarray | None = None  # (2, 2) applied to u0
    final_tf: np.ndarray | None = None  # (2, 2) applied to final u
    denoise: DenoiseConsts | None = None


def _svd_factor(cov: np.ndarray) -> np.ndarray:
    """u * sqrt(s) factor, matching `multivariate_normal(method="svd")`.

    Handles the reference's (possibly slightly non-symmetric) covariance
    integrals the same way jax.random does: factor from the SVD.
    """
    u, s, _ = np.linalg.svd(cov)
    return u * np.sqrt(np.clip(s, 0.0, None))[..., None, :]


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


# --------------------------------------------------------------------------
# Sampler bundles (one per reference sampler family)
# --------------------------------------------------------------------------


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


def hybdeis_bundle(
    host: HostCLD,
    nfe: int,
    order: int,
    ts_order: float = 2.0,
    noise_nfe_ratio: float = 0.3,
    img_t_ratio: float = 0.3,
    denoising: bool = True,
    reference_exact: bool = False,
) -> ABBundle:
    """Hybrid time-grid DEIS (cld_jax/sampling.py:255-269)."""
    num_step = nfe - 1 if denoising else nfe
    rev_ts = hybrid_time_grid(
        host.p.T,
        host.p.sampling_eps,
        num_step,
        ts_order,
        noise_nfe_ratio,
        img_t_ratio,
        reference_exact=reference_exact,
    )
    return deis_bundle(
        host, nfe, order, ts_order, denoising, rev_ts=rev_ts, name="hybdeis"
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

    out = _cached_stack(
        "cld_order0", (host.p.key_parts(), rev_ts, bool(is_em)), build
    )
    return ABBundle(
        name="order0",
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=0,
        nfe=nfe,
        denoise=_denoise_consts(host) if denoising else None,
    )


def mldeis_bundle(
    host: HostCLD,
    nfe: int,
    order: int,
    ts_order: float = 2.0,
    denoising: bool = True,
) -> ABBundle:
    """DEIS in the rotated y-space (cld_jax/sampling.py:272-378).

    u0 is rotated by psi1(T)^-1, the model is queried at x = psi1(t_i) y, and
    the final state is rotated back at t = sampling_eps / 2.
    """
    rev_ts = _grid(host, nfe, ts_order, denoising)
    ml = HostMLCLD(host)

    def build():
        return {
            "stack": ml.deis_coef(rev_ts, order),
            "state_tf": host.psi1(rev_ts[:-1]),
        }

    out = _cached_stack("cld_mldeis", (host.p.key_parts(), rev_ts, order), build)
    return ABBundle(
        name="mldeis",
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=order + 1,
        nfe=nfe,
        state_tf=out["state_tf"],
        init_tf=host.inv_psi1(host.p.T),
        final_tf=host.psi1(host.p.sampling_eps / 2.0),
        denoise=_denoise_consts(host) if denoising else None,
    )


def ldeis_bundle(
    host: HostCLD,
    nfe: int,
    order: int,
    ts_order: float = 2.0,
    denoising: bool = True,
) -> ABBundle:
    """Cholesky-reparameterized DEIS (cld_jax/sampling.py:497-540)."""
    rev_ts = _grid(host, nfe, ts_order, denoising)
    lsde = HostLSDE(host)

    def build():
        return {
            "stack": lsde.deis_coef(rev_ts, order),
            "eps_tf": lsde.eps_r2l_coef(rev_ts[:-1]),
        }

    out = _cached_stack("cld_ldeis", (host.p.key_parts(), rev_ts, order), build)
    return ABBundle(
        name="ldeis",
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=order + 1,
        nfe=nfe,
        eps_tf=out["eps_tf"],
        denoise=_denoise_consts(host) if denoising else None,
    )


def sdeis_bundle(
    host: HostCLD,
    nfe: int,
    order: int,
    lambda_coef: float = 1.0,
    use_order0: bool = True,
    ts_order: float = 2.0,
    denoising: bool = True,
    reference_exact: bool = False,
) -> ABBundle:
    """Stochastic gDDIM with λ-interpolation (cld_jax/sampling.py:380-427).

    The last-step covariance is zeroed (parity with sampling.py:420-422) and
    all per-step covariances are pre-factored so the engine draws correlated
    noise with a single 2x2 matmul. ``reference_exact`` reproduces the
    reference's untransposed-Lyapunov covariances bit-for-bit.
    """
    rev_ts = _grid(host, nfe, ts_order, denoising)
    lam = HostLambdaSDE(host, lambda_coef, reference_exact=reference_exact)

    def build():
        full = lam.deis_coef(rev_ts, order, use_order0=use_order0)
        covs = full[:, -1].copy()
        covs[-1] = 0.0
        return {"stack": full[:, :-1], "noise_factors": _svd_factor(covs)}

    out = _cached_stack(
        "cld_sdeis",
        (
            host.p.key_parts(),
            rev_ts,
            order,
            lambda_coef,
            bool(use_order0),
            bool(reference_exact),
        ),
        build,
    )
    return ABBundle(
        name="sdeis",
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=out["stack"].shape[1] - 2,
        nfe=nfe,
        noise_factors=out["noise_factors"],
        denoise=_denoise_consts(host) if denoising else None,
    )


def em_bundle(
    host: HostCLD,
    nfe: int,
    lambda_coef: float = 0.0,
    ts_order: float = 2.0,
    denoising: bool = True,
) -> ABBundle:
    """Euler-Maruyama with λ noise scale (cld_jax/sampling.py:624-669).

    u' = u + [F u - (1+λ)/2 G Gᵀ score] Δt + λ G z √|Δt|
    folded (score = -invRᵀ eps) into
    u' = (I + F Δt) u + [(1+λ)/2 G Gᵀ invRᵀ Δt] eps + (λ√|Δt| G) z.
    """
    rev_ts = _grid(host, nfe, ts_order, denoising)

    def build():
        ts = rev_ts[:-1]
        dts = (rev_ts[1:] - rev_ts[:-1])[:, None, None]
        f = host.F(ts)
        g = host.G(ts)
        gg = g @ g.swapaxes(-1, -2)
        mean = np.eye(2)[None] + f * dts
        eps_coef = (
            0.5 * (1.0 + lambda_coef) * gg @ inv2(host.R(ts)).swapaxes(-1, -2) * dts
        )
        noise = lambda_coef * np.sqrt(np.abs(dts)) * g
        return {
            "stack": np.concatenate([mean[:, None], eps_coef[:, None]], axis=1),
            "noise_factors": noise,
        }

    out = _cached_stack(
        "cld_em", (host.p.key_parts(), rev_ts, lambda_coef), build
    )
    return ABBundle(
        name="em",
        rev_ts=rev_ts,
        stack=out["stack"],
        hist_len=0,
        nfe=nfe,
        noise_factors=out["noise_factors"],
        denoise=_denoise_consts(host) if denoising else None,
    )


# --------------------------------------------------------------------------
# SSCS (Symmetric Splitting CLD Sampler) constants
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SSCSBundle:
    """Per-step constants for the analytic-OU/score splitting scheme
    (cld_jax/sampling.py:542-622). The paper's time convention runs t <- 1-t.
    """

    rev_ts: np.ndarray  # (N+1,) model-time grid (what eps_fn sees)
    mean_a: np.ndarray  # (N, 2, 2) first OU half-step transition
    fac_a: np.ndarray  # (N, 2, 2) first OU half-step noise factor
    mean_b: np.ndarray  # (N, 2, 2) second OU half-step transition
    fac_b: np.ndarray  # (N, 2, 2) second OU half-step noise factor
    score_coef: np.ndarray  # (N,) 2*beta(s_t)*Gamma*(nt - t)
    invR_T: np.ndarray  # (N, 2, 2) at model time rev_ts[i]
    m_inv: float
    nfe: int
    denoise: DenoiseConsts | None


def _sscs_ou(host: HostCLD, s_t: np.ndarray, s_t_next: np.ndarray):
    """Analytic OU mean matrix and covariance between flipped times
    (cld_jax/sampling.py:543-567)."""
    gamma = host.p.gamma
    beta_int = -(host.beta_int(1.0 - s_t_next) - host.beta_int(1.0 - s_t))
    b = beta_int
    coeff_m = np.exp(-2.0 * b / gamma)
    one = np.ones_like(b)
    mean = (
        np.stack(
            [
                np.stack([one + 2 * b / gamma, -4 * b / gamma / gamma], -1),
                np.stack([b, one - 2 * b / gamma], -1),
            ],
            -2,
        )
        * coeff_m[..., None, None]
    )
    coeff_c = np.exp(-4.0 * b / gamma)
    cov_xx = np.exp(4 * b / gamma) - 1 - 4 * b / gamma - 8 * b**2 / gamma**2
    cov_xv = -4 * b**2 / gamma
    cov_vv = (gamma / 2) ** 2 * (np.exp(4 * b / gamma) - 1) + b * gamma - 2 * b**2
    cov = (
        np.stack(
            [
                np.stack([cov_xx, cov_xv], -1),
                np.stack([cov_xv, cov_vv], -1),
            ],
            -2,
        )
        * coeff_c[..., None, None]
    )
    return mean, cov


def sscs_bundle(
    host: HostCLD, nfe: int, ts_order: float = 2.0, denoising: bool = True
) -> SSCSBundle:
    rev_ts = _grid(host, nfe, ts_order, denoising)
    ts = 1.0 - rev_ts
    t, nt = ts[:-1], ts[1:]
    mid = (t + nt) / 2.0
    mean_a, cov_a = _sscs_ou(host, t, mid)
    mean_b, cov_b = _sscs_ou(host, mid, nt)
    score_coef = 2.0 * host.beta(t) * host.p.gamma * (nt - t)
    return SSCSBundle(
        rev_ts=rev_ts,
        mean_a=mean_a,
        fac_a=_svd_factor(cov_a),
        mean_b=mean_b,
        fac_b=_svd_factor(cov_b),
        score_coef=score_coef,
        invR_T=inv2(host.R(rev_ts[:-1])).swapaxes(-1, -2),
        m_inv=host.p.m_inv,
        nfe=nfe,
        denoise=_denoise_consts(host) if denoising else None,
    )
