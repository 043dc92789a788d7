"""Blurring-diffusion SDE (Hoogeboom & Salimans), counterpart of
``gddim_tpu/math/blur.py:32-182``.

The forward process damps each DCT frequency by D(t) on top of a cosine
alpha(t) schedule and adds isotropic pixel noise; sampling runs order-0
updates in DCT space. Every "matrix" is a per-frequency scalar, a (H, W, 1)
map. The schedule functions take numpy arrays (the host-side coefficient
stacks, in float64) or torch tensors (on the device, in their dtype);
``prior_sampling``, ``sample_t`` and ``perturb_data`` draw from a
``torch.Generator`` unless their draws are given. ``psi``, ``G`` and
``eps_integrand`` feed frequency-space DEIS (``math/deis_scalar.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gddim_torch.math.dct import batch_img_dct, batch_img_idct
from gddim_torch.parallel.draws import draw_rows


def _xp(t):
    return torch if isinstance(t, torch.Tensor) else np


def _per_sample(a, x):
    """(B,) a times (B, ...) x, one scalar per sample."""
    return a.reshape((-1,) + (1,) * (x.ndim - 1)) * x


@dataclasses.dataclass(frozen=True)
class BlurSDE:
    min_scale: float = 0.001
    sigma_blur_max: float = 10.0
    sampling_eps: float = 1e-5
    img_dim: int = 32

    @classmethod
    def from_config(cls, config) -> "BlurSDE":
        return cls(min_scale=float(config.model.min_scale),
                   sigma_blur_max=float(config.model.sigma_blur_max),
                   sampling_eps=float(config.sampling.t0),
                   img_dim=int(config.data.image_size))

    def labda(self, like=None):
        """Per-frequency dissipation rates (1, H, W, 1), float64 numpy, or a
        tensor on ``like``'s device in its dtype."""
        n = self.img_dim
        freqs = np.pi * np.linspace(0, n - 1, n) / n
        lab = freqs[None, :, None, None] ** 2 + freqs[None, None, :, None] ** 2
        if isinstance(like, torch.Tensor):
            return torch.as_tensor(lab, dtype=like.dtype, device=like.device)
        return lab

    @property
    def alpha_start(self) -> float:
        return float(self.t2alpha_fn(np.float64(0.0)))

    @property
    def sampling_T(self) -> float:
        """EDM-style start time rho2t(80) (reference sde_lib.py:33-35,47-51)."""
        return float(self.rho2t(80.0))

    # --- schedule ---------------------------------------------------------
    def t2alpha_fn(self, t):
        return _xp(t).cos((t + 0.004) / 1.008 * math.pi / 2) ** 2

    def dalpha_dt_fn(self, t):
        """d alpha / dt of the cosine schedule (analytic)."""
        xp = _xp(t)
        inner = (t + 0.004) / 1.008 * math.pi / 2
        return -2.0 * xp.cos(inner) * xp.sin(inner) * (math.pi / 2 / 1.008)

    def alpha2t_fn(self, alpha):
        xp = _xp(alpha)
        return xp.arccos(xp.sqrt(alpha)) * 2 / math.pi * 1.008 - 0.004

    def rho2t(self, rho: float):
        a0 = self.alpha_start
        return self.alpha2t_fn(np.float64(a0 / ((rho + math.sqrt(1 - a0)) ** 2 + a0)))

    def get_frequency_scaling(self, t):
        """D(t): (B, H, W, 1) damping per frequency (reference sde_lib.py:79-88)."""
        xp = _xp(t)
        t = t.reshape(-1) if xp is torch else np.atleast_1d(t)
        sigma_blur = self.sigma_blur_max * xp.sin(t * math.pi / 2) ** 2
        dissipation_time = sigma_blur ** 2 / 2
        logits = dissipation_time[:, None, None, None] * self.labda(t if xp is torch else None)
        return xp.exp(-logits) * (1 - self.min_scale) + self.min_scale

    def psi(self, t_start, t_end):
        """Frequency-space transition ratio sqrt(alpha(t_end) / alpha(t_start))
        D(t_end) / D(t_start): (B, H, W, 1) (reference sde_lib.py:53-56)."""
        xp = _xp(t_start)
        t_start = t_start.reshape(-1) if xp is torch else np.atleast_1d(t_start)
        t_end = t_end.reshape(-1) if xp is torch else np.atleast_1d(t_end)
        ratio = xp.sqrt(self.t2alpha_fn(t_end) / self.t2alpha_fn(t_start))
        return _per_sample(ratio, self.get_frequency_scaling(t_end)
                           / self.get_frequency_scaling(t_start))

    def G(self, ts):
        """Per-frequency diffusion coefficient (reference sde_lib.py:58-70)."""
        xp = _xp(ts)
        ts = ts.reshape(-1) if xp is torch else np.atleast_1d(ts)
        d_t = self.get_frequency_scaling(ts)
        inner = -1.0 + _per_sample(1 - 1.0 / self.t2alpha_fn(ts), d_t)
        return xp.sqrt(_per_sample(self.dalpha_dt_fn(ts), inner))

    def eps_integrand(self, ts):
        """(1/2) G^2 / sqrt(1 - alpha) per frequency (reference sde_lib.py:72-77)."""
        xp = _xp(ts)
        ts = ts.reshape(-1) if xp is torch else np.atleast_1d(ts)
        g = self.G(ts)
        return _per_sample(1.0 / xp.sqrt(1 - self.t2alpha_fn(ts)), 0.5 * g * g)

    def y_mean_coef(self, ts):
        """sqrt(alpha(t)) D(t): (B, H, W, 1)."""
        xp = _xp(ts)
        ts = ts.reshape(-1) if xp is torch else np.atleast_1d(ts)
        return _per_sample(xp.sqrt(self.t2alpha_fn(ts)), self.get_frequency_scaling(ts))

    def y_std_coef(self, ts):
        """sqrt(1 - alpha(t)): (B,)."""
        return _xp(ts).sqrt(1 - self.t2alpha_fn(ts))

    # --- pixel <-> frequency, the model adapter --------------------------------
    def x2y(self, xs: torch.Tensor) -> torch.Tensor:
        return batch_img_dct(xs)

    def y2x(self, ys: torch.Tensor) -> torch.Tensor:
        return batch_img_idct(ys)

    def encode_t(self, t):
        """The network's noise label (reference sde_lib.py:146-163)."""
        return 999 * t

    def prior_sampling(self, generator: torch.Generator, shape, device,
                       dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    # --- training: the forward process --------------------------------------
    @property
    def T(self) -> float:
        return 1.0

    def sample_t(self, shape, generator: torch.Generator | None = None, device=None):
        """t ~ U(1e-5, T) (reference sde_lib.py:132-133)."""
        u = draw_rows(torch.rand, shape, generator, device=device)
        return 1e-5 + (self.T - 1e-5) * u

    def perturb_data(self, batch: torch.Tensor, ts: torch.Tensor,
                     generator: torch.Generator | None = None, z=None):
        """(x_t, mean, z): DCT, scale each frequency by sqrt(alpha) D(t),
        iDCT, then + sqrt(1 - alpha) z (reference sde_lib.py:99-110); z ~
        N(0, I) from ``generator`` unless given."""
        if z is None:
            z = draw_rows(torch.randn, batch.shape, generator, device=batch.device,
                          dtype=batch.dtype)
        mean = self.y2x(self.y_mean_coef(ts) * self.x2y(batch))
        return mean + _per_sample(self.y_std_coef(ts), z), mean, z

    def xeps2x0(self, xt: torch.Tensor, ts: torch.Tensor, xeps: torch.Tensor) -> torch.Tensor:
        """The clean image implied by the pixel-space eps at time ts (B,)."""
        clean = xt - _per_sample(self.y_std_coef(ts), xeps)
        return self.y2x(1.0 / self.y_mean_coef(ts) * self.x2y(clean))
