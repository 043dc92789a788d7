"""Reverse-time step grids (host, float64).

Power-law grid parity: cld_jax/sampling.py:241-249 (`get_rev_ts`).
"""

from __future__ import annotations

import numpy as np


def rev_time_grid(
    t_start: float, t_end: float, num_step: int, ts_order: float = 2.0
) -> np.ndarray:
    """Power-law spaced grid from t_start down to t_end with num_step+1 points."""
    return (
        np.linspace(
            t_start ** (1.0 / ts_order), t_end ** (1.0 / ts_order), num_step + 1
        )
        ** ts_order
    )


def hybrid_time_grid(
    t_start: float,
    t_end: float,
    num_step: int,
    ts_order: float = 2.0,
    noise_nfe_ratio: float = 0.3,
    img_t_ratio: float = 0.3,
    reference_exact: bool = False,
) -> np.ndarray:
    """Hybrid grid: linear in the noise region, power-law in the image region.

    Mirrors cld_jax/sampling.py:255-269 except that the image-region grid runs
    from mid_t down to t_end. (The reference concatenates a full-range
    [T -> eps] power grid after the noise segment, producing a non-monotonic
    time sequence — an apparent bug; we build the intended monotone grid.)

    With ``reference_exact`` the reference's grid is reproduced bit-for-bit
    (image segment restarts at T, non-monotone) for runs that must replicate
    released artifacts of the buggy path.
    """
    mid_t = t_start * img_t_ratio
    noise_nfe = int(num_step * noise_nfe_ratio)
    img_nfe = num_step - noise_nfe
    noise_ts = np.linspace(t_start, mid_t, noise_nfe, endpoint=False)
    img_start = t_start if reference_exact else mid_t
    img_ts = rev_time_grid(img_start, t_end, img_nfe, ts_order)
    out = np.concatenate([noise_ts, img_ts])
    assert out.shape[0] == num_step + 1
    return out
