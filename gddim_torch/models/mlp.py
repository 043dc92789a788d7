"""The point-set MLP ``ps_fmlp`` (counterpart of ``gddim_tpu/models/mlp.py``).

Gaussian Fourier features of log(time_cond) (``nf`` frequencies at
``fourier_scale``) concatenated after x, then ``num_layers`` Dense + swish of
width nf and a Dense back to x's width. It computes in f32 whatever
``model.dtype`` says: the JAX module sets no dtype. Its Dense layers draw
flax's default ``lecun_normal`` kernels and zero biases. No kernel of the
port applies: the network is four small matrix products a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.models.layers import Dense, GaussianFourierProjection, lecun_normal
from gddim_torch.models.registry import register_model


@register_model(name="ps_fmlp")
class PSFMLP(nn.Module):
    """MLP with Gaussian Fourier time features for point data: x (B, D) ->
    (B, D). For CLD, D is twice ``data.dim``: the stacked (x, v)
    (``gddim_tpu/models/wrappers.py:30-31``)."""

    def __init__(self, config, generator: torch.Generator | None = None):
        super().__init__()
        m = config.model
        nf, layers = int(m.nf), int(m.num_layers)
        dim = int(config.data.dim) * (2 if config.sde == "cld" else 1)
        self.fourier = GaussianFourierProjection(nf, m.fourier_scale, generator=generator)
        widths = [dim + 2 * nf] + [nf] * layers
        self.dense = nn.ModuleList(
            [Dense(a, b, generator=generator, init=lecun_normal())
             for a, b in zip(widths[:-1], widths[1:])]
            + [Dense(nf, dim, generator=generator, init=lecun_normal())])
        # flax scope names in creation order (convert.py)
        self.scopes = [("GaussianFourierProjection_0", self.fourier)] + [
            (f"Dense_{i}", d) for i, d in enumerate(self.dense)]
        for name, mod in self.scopes:
            mod.scope = name

    def forward(self, x, time_cond, train: bool = False,
                generator: torch.Generator | None = None):
        """x (B, D) f32, time_cond (B,): the noise labels. ``train`` and
        ``generator`` are the score nets' call signature; the MLP has no
        dropout."""
        temb = self.fourier(torch.log(time_cond.float()))
        h = torch.cat([x.float(), temb], -1)
        for dense in self.dense[:-1]:
            h = F.silu(dense(h))
        return self.dense[-1](h)
