"""Device-side CLD schedule: what the sampler needs from the SDE.

Counterpart of ``gddim_tpu/math/cld.py`` for the sampling path: the static
hyperparameters, the float64 host twin (``host()``) the coefficient layer
reads, and the prior draw x ~ N(0, 1), v ~ N(0, 1/m) (cld_jax/sde_lib.py:270-274).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gddim_torch.math.cld_host import CLDParams, HostCLD


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
