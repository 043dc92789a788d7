"""Device-side CLD schedule: what the sampler needs from the SDE.

Counterpart of ``gddim_tpu/math/cld.py``: the static hyperparameters, the
float64 host twin (``host()``) the coefficient layer reads, the prior draw
x ~ N(0, 1), v ~ N(0, 1/m) (cld_jax/sde_lib.py:270-274), and for training
the closed-form transition ``psi``, ``mean`` and R(t) from the same uniform
f32 table the JAX package interpolates (n = 32768, ``CLD.create``), with
the full-covariance forward perturbation ``perturb_data``; for the ``ode``
sampler's drift the f32 drift ``F(t)``, diffusion ``G(t)``, ``invR`` and
``eps2score`` (``gddim_tpu/math/cld.py:81,86,114,142``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from gddim_torch.math.cld_host import CLDParams, HostCLD
from gddim_torch.math.linalg2 import bmm, inv2
from gddim_torch.parallel.draws import draw_rows

R_TABLE_SIZE = 32768  # gddim_tpu/math/cld.py:48


def _mat2(a00, a01, a10, a11):
    return torch.stack([torch.stack([a00, a01], -1), torch.stack([a10, a11], -1)], -2)


@dataclasses.dataclass(frozen=True)
class CLD:
    params: CLDParams = CLDParams()
    mixed_score: bool = False

    @classmethod
    def from_config(cls, config) -> "CLD":
        m = config.model
        return cls(
            CLDParams(
                m_inv=float(m.m_inv),
                beta_0=float(m.beta_0),
                beta_1=float(m.beta_1),
                vv_gamma=float(m.vv_gamma),
            ),
            mixed_score=bool(m.mixed_score),
        )

    @property
    def T(self) -> float:
        return self.params.T

    @property
    def sampling_eps(self) -> float:
        return self.params.sampling_eps

    def host(self) -> HostCLD:
        """Float64 host-side twin (for coefficient precompute)."""
        return HostCLD(self.params)

    def prior_sampling(self, generator: torch.Generator, shape, device,
                       dtype=torch.float32) -> torch.Tensor:
        """(shape..., 2) draw: x ~ N(0, 1) in [..., 0], v ~ N(0, 1/m) in [..., 1]."""
        xs = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        vs = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return torch.stack([xs, vs / math.sqrt(self.params.m_inv)], -1)

    # --- training: forward process ----------------------------------------

    @functools.cached_property
    def _r_table(self):
        ts, rs = self.host().r_table(n=R_TABLE_SIZE)
        return torch.from_numpy(rs), float(ts[-1])

    def beta(self, t):
        return self.params.beta_0 + self.params.beta_1 * t

    def F(self, t):
        """Drift [[0, b m_inv], [-b, -Gamma b m_inv]], (..., 2, 2) f32, on t's
        device (a Python float: on the CPU)."""
        b = self.beta(torch.as_tensor(t, dtype=torch.float32))
        z = torch.zeros_like(b)
        m_inv, gamma = self.params.m_inv, float(self.params.gamma)
        return _mat2(z, b * m_inv, -b, -gamma * b * m_inv)

    def G(self, t):
        """Diffusion [[0, 0], [0, sqrt(2 Gamma b)]], (..., 2, 2) f32."""
        b = self.beta(torch.as_tensor(t, dtype=torch.float32))
        z = torch.zeros_like(b)
        return _mat2(z, z, z, torch.sqrt(2.0 * float(self.params.gamma) * b))

    def beta_int(self, t):
        return self.params.beta_0 * t + 0.5 * self.params.beta_1 * t ** 2

    def psi(self, s, t):
        """Psi(s, t), (..., 2, 2) f32 (cld_jax/sde_lib.py:182-205)."""
        tau = self.beta_int(t) - self.beta_int(s)
        a = 2.0 * math.sqrt(self.params.m_inv)
        coef = torch.exp(-a * tau / 2.0)
        one = torch.ones_like(tau)
        m = torch.stack([torch.stack([one + a * tau / 2.0, 0.25 * a * a * tau], -1),
                         torch.stack([-tau, one - a * tau / 2.0], -1)], -2)
        return m * coef[..., None, None]

    def R(self, t):
        """R(t) by linear interpolation in the uniform f32 table."""
        table, t_max = self._r_table
        table = table.to(t.device)
        n = table.shape[0]
        h = t_max / (n - 1)
        t = t.clamp(0.0, t_max)
        pos = t / h
        idx = pos.to(torch.int32).clamp(0, n - 2).long()
        frac = pos - idx.to(pos.dtype)
        lo, hi = table[idx], table[idx + 1]
        return lo + frac[..., None, None] * (hi - lo)

    def invR(self, t):
        return inv2(self.R(t))

    def eps2score(self, eps, ts):
        """score = -R(t)^{-T} eps per batch element: eps (B, ..., 2), ts (B,)."""
        return bmm(-self.invR(ts).transpose(-1, -2), eps)

    def mean(self, batch, ts):
        """Psi(0, t_b) applied per batch element; batch (B, ..., d, 2)."""
        return bmm(self.psi(torch.zeros_like(ts), ts), batch)

    def perturb_data(self, batch, ts, generator: torch.Generator | None = None, z=None):
        """(mean + R(t) z, mean, z) with z ~ N(0, I) from ``generator``
        unless given."""
        mean = self.mean(batch, ts)
        if z is None:
            z = draw_rows(torch.randn, mean.shape, generator, device=mean.device,
                          dtype=mean.dtype)
        return mean + bmm(self.R(ts), z), mean, z
