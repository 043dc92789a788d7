"""Base layers of the score U-Net (counterpart of ``gddim_tpu/models/layers.py``).

Parameters keep the JAX package's layouts, so converted weights load as
they are: conv kernels HWIO, Dense and NIN kernels (in, out). Activations are
NHWC. Parameters stay float32; a layer computes in its input's dtype.

The layer-wise paths (``conv_impl`` 'pallas' and 'int8',
``layers.py:42-149,261-343``) pass their choice to each call: ``Conv``
runs a qualifying 3x3 conv through K11 (``ops/conv3x3.py``) on bf16 or f32
activations, in its int8 form at inference, and
``GroupNorm(quantize_out=True)`` emits a ``QuantizedActivation`` through
K12, which the int8 conv takes without another quantize pass.
``get_act``, ``get_timestep_embedding`` and ``Combine`` are the JAX
package's (``layers.py:218-258``); a stride-2 ``Conv`` pads as XLA's
"SAME" does.

Channel tensor parallelism (``parallel/mesh.py:tp_shard_params``): a
module whose weight is sharded holds this rank's slice of the output
channels. On the plain path ``Conv``, ``Dense`` and ``NIN`` compute that
slice and gather the slices over the model group (``_plain``), so the
activations after them are whole and replicated, as XLA's are; every
other reader of ``module.weight`` (the whole-block and layer-wise
kernels) gets the whole weight, gathered.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gddim_torch.ops import conv3x3 as c3
from gddim_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_quant,
    group_norm_silu_reference,
)
from gddim_torch.ops.resblock import conv3x3_nhwc, pack_int8_weight


class _KernelWeights:
    """A module's weights as the inference kernels take them (detached: they
    have no backward): ``make()``'s result, remade only when a tensor of
    ``tensors`` changes (in place or by replacement) or ``tag`` does."""

    def __init__(self):
        self._key = None
        self._val = None

    def get(self, tensors, make, tag=()):
        key = (tag, tuple((t.data_ptr(), t.device, 0 if t.is_inference() else t._version)
                          for t in tensors))
        if key != self._key:
            self._val = make()
            self._key = key
        return self._val


class QuantizedActivation(NamedTuple):
    """A per-sample int8 activation passed from K12 to the int8 conv:
    value ~= q * scale[b], standing for a tensor of ``dtype`` (the
    activation dtype it was quantized from, which the conv writes)."""

    q: torch.Tensor  # (B, H, W, C) int8
    scale: torch.Tensor  # (B,) f32
    dtype: torch.dtype

    @property
    def shape(self):
        return self.q.shape

    def dequant(self):
        srow = self.scale.reshape((-1,) + (1,) * (self.q.dim() - 1))
        return (self.q.float() * srow).to(self.dtype)


def default_init(scale: float = 1.0):
    """DDPM variance-scaling init: fan_avg, uniform (scale 0 -> 1e-10).

    Returns init(shape, generator) -> f32 tensor; for conv kernels the
    leading dims are the receptive field (HWIO)."""
    scale = 1e-10 if scale == 0 else scale

    def init(shape, generator=None):
        rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
        limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (2.0 * u - 1.0) * limit

    return init


def lecun_normal():
    """flax's default Dense kernel init: a normal truncated at 2 standard
    deviations, scaled to variance 1 / fan_in."""

    def init(shape, generator=None):
        std = math.sqrt(1.0 / shape[-2]) / 0.87962566103423978
        lo = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
        hi = 1.0 - lo
        u = lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=torch.float32)
        return std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)

    return init


def same_pads(n: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding (before, after) of one axis of n pixels under a
    k-tap window at ``stride``: ceil(n / stride) outputs, the total padding
    split with its odd pixel after (stride 2, k 3: (0, 1) on an even n,
    (1, 1) on an odd one)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_strided_nhwc(x, w, b, stride: int):
    """A k x k conv at ``stride`` with XLA's "SAME" padding, NHWC input, HWIO
    kernel, in x's dtype (``conv3x3(..., stride=2)``, layers.py:131-136);
    ``b`` None adds no bias."""
    k = w.shape[0]
    (t, bo), (le, r) = (same_pads(n, k, stride) for n in x.shape[1:3])
    y = F.pad(x.permute(0, 3, 1, 2), (le, r, t, bo))
    y = F.conv2d(y, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    return y if b is None else y + b.to(x.dtype)


def _weight_shape(module) -> torch.Size:
    """The whole weight's shape, read without gathering it."""
    w = module._parameters["weight"]
    tp = module.__dict__.get("_tp")
    return w.shape if tp is None else tp.whole_shape(w.shape)


def _plain(module, x, op):
    """``op(x, weight) + bias`` in x's dtype; under channel TP ``op`` on this
    rank's output channels, the slices gathered over the model group (x's
    gradient summed over it), then the bias."""
    tp = module.__dict__.get("_tp")
    if tp is None:
        y = op(x, module.weight)
    else:
        y = tp.gather(op(tp.enter(x), module._parameters["weight"]))
    return y + module.bias.to(x.dtype)


class Conv(nn.Module):
    """k x k SAME conv (k in {1, 3}); weight (k, k, Cin, Cout); stride 1, or
    2 (a 3x3, padded as XLA pads, always plain).

    ``impl``: 'plain', or the layer-wise paths for a 3x3 conv that
    ``conv3x3.supported`` takes: 'pallas' runs K11 on the weight in the
    activation dtype (bf16 or f32) and adds the bias in that dtype; 'int8'
    runs K11's int8 form on the incoming ``QuantizedActivation`` (or on
    ``quantize_per_sample(x)``) with the weight quantized per output channel
    from its value in the activation dtype, the bias fused in f32, out in
    the activation dtype (``layers.py:87-148``). At inference the cast or
    quantized weight (int8: with its K-major packing, which the card's int8
    GEMM reads) is made once and kept until the parameter changes.

    Training (autograd records: x or the weight requires grad): 'pallas'
    runs K11's ``autograd.Function`` on the weight cast in the graph, so
    the weight and x get gradients (the backward is the plain f32 conv's
    VJP, the JAX ``custom_vjp``'s); 'int8' runs the plain conv, the JAX
    package's "training-safe fallback" (``layers.py:91-92``: int8 rounding
    has no gradient)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, init_scale: float = 1.0,
                 generator=None, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(default_init(init_scale)((kernel, kernel, cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self._kw = _KernelWeights()

    def forward(self, x, impl: str = "plain"):
        if self.stride != 1:
            return _plain(self, x, lambda x_, w: conv_strided_nhwc(x_, w, None, self.stride))
        q_in = x if isinstance(x, QuantizedActivation) else None
        shape, dtype = (q_in.shape, q_in.dtype) if q_in is not None else (x.shape, x.dtype)
        recording = q_in is None and torch.is_grad_enabled() and (
            x.requires_grad or self._parameters["weight"].requires_grad)
        if recording and impl == "int8":
            impl = "plain"  # the training-safe fallback
        wshape = _weight_shape(self)
        qualifies = impl in ("pallas", "int8") and c3.supported(shape, wshape,
                                                                int8=impl == "int8")
        if qualifies and impl == "int8":
            w8, sw, wk = self._kw.get([self.weight], lambda: self._int8_weight(dtype),
                                      tag=("int8", dtype))
            x8, sx = (q_in.q, q_in.scale) if q_in is not None else c3.quantize_per_sample(x)
            return c3.conv3x3_pallas_int8(x8, w8, sw, sx, bias=self.bias.detach(),
                                          out_dtype=dtype, w_kmajor=wk)
        if q_in is not None:  # a quantized input but no int8 conv for this shape
            x = q_in.dequant()
        if qualifies and recording:
            return c3.conv3x3_pallas(x, self.weight.to(dtype)) + self.bias.to(dtype)
        if qualifies:
            w = self._kw.get([self.weight], lambda: self.weight.detach().to(dtype).contiguous(),
                             tag=("pallas", dtype))
            return c3.conv3x3_pallas(x, w) + self.bias.to(dtype)
        if wshape[0] == 1:
            return _plain(self, x, lambda x_, w: torch.einsum("bhwc,cd->bhwd", x_,
                                                              w[0, 0].to(x_.dtype)))
        return _plain(self, x, conv3x3_nhwc)

    def _int8_weight(self, dtype):
        """(int8 HWIO weights, their scales, the same weights K-major) of the
        weight in ``dtype``."""
        w8, sw = c3.quantize_weight_per_channel(self.weight.detach().to(dtype))
        return w8, sw, pack_int8_weight((w8, sw))[0]


class Dense(nn.Module):
    """y = x @ W + b with W (in, out), computed in x's dtype."""

    def __init__(self, cin: int, cout: int, generator=None, init=None):
        super().__init__()
        self.weight = nn.Parameter((init or default_init())((cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return _plain(self, x, _matmul)


def _matmul(x, w):
    return x @ w.to(x.dtype)


class NIN(nn.Module):
    """1x1 dense mix over channels; weight (in, out)."""

    def __init__(self, cin: int, cout: int, init_scale: float = 0.1, generator=None):
        super().__init__()
        self.weight = nn.Parameter(default_init(init_scale)((cin, cout), generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return _plain(self, x, _matmul)


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier time embedding [sin(2 pi x W), cos(2 pi x W)]."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0, generator=None):
        super().__init__()
        w = torch.randn((embedding_size,), generator=generator) * scale
        self.weight = nn.Parameter(w, requires_grad=False)

    def forward(self, x):
        x_proj = x[:, None] * self.weight[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], -1)


def get_timestep_embedding(timesteps, embedding_dim: int, max_positions: int = 10000):
    """Sinusoidal positional embedding of float timesteps (B,), f32,
    [sin | cos], zero-padded by one column at an odd width (layers.py:218-229)."""
    assert timesteps.dim() == 1
    half = embedding_dim // 2
    scale = math.log(max_positions) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -scale)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], 1)
    return F.pad(emb, (0, 1)) if embedding_dim % 2 else emb


ACTS = {"elu": F.elu, "relu": F.relu, "lrelu": lambda x: F.leaky_relu(x, 0.2), "swish": F.silu}


def get_act(name: str):
    """The activation of ``model.nonlinearity`` (layers.py:231-242); swish is
    ``F.silu``, the one the kernels fuse."""
    try:
        return ACTS[name.lower()]
    except KeyError:
        raise NotImplementedError(f"activation {name} unknown") from None


class Combine(nn.Module):
    """Combine an input-pyramid level with h: a 1x1 conv of x to h's width,
    then concatenated ('cat') or added ('sum') (layers.py:245-258)."""

    def __init__(self, cin: int, cout: int, method: str = "cat", generator=None):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"combine method {method} not recognized")
        self.method = method
        self.conv = Conv(cin, cout, 1, generator=generator)

    def forward(self, x, y):
        h = self.conv(x)
        return torch.cat([h, y], -1) if self.method == "cat" else h + y


def num_groups_for(c: int) -> int:
    return min(c // 4, 32)


class GroupNorm(nn.Module):
    """GroupNorm, eps 1e-6, min(C//4, 32) groups, f32 statistics; weight is
    the JAX 'scale'. ``act=True`` fuses the SiLU; ``fused=True`` runs K1;
    ``quantize_out=True`` runs K12 and returns a ``QuantizedActivation``
    (inference only)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups_for(c)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, act: bool = False, fused: bool = False, quantize_out: bool = False):
        if quantize_out:
            q, s = group_norm_silu_quant(x, self.weight, self.bias, self.num_groups, self.eps, act)
            return QuantizedActivation(q, s, x.dtype)
        op = group_norm_silu if fused else group_norm_silu_reference
        return op(x, self.weight, self.bias, self.num_groups, self.eps, act)


def norm_act(norm: GroupNorm, x, fused: bool = True, quantize_out: bool = False, act=F.silu):
    """GroupNorm followed by SiLU, one kernel (K1), or with quantize_out K12's
    ``QuantizedActivation`` for an int8 conv that follows directly
    (``layers.py:310-324``); another activation follows the GroupNorm on
    its own, unquantized."""
    if act is F.silu:
        return norm(x, act=True, fused=fused, quantize_out=quantize_out)
    return act(norm(x, act=False, fused=fused))


def int8_conv_fusion_ok(x_shape, out_ch: int, impl: str) -> bool:
    """True when a norm_act -> 3x3 conv pair runs the int8 pipeline (K12 into
    K11's int8 form): impl 'int8' and a shape K11's int8 form takes
    (``layers.py:337-343``), so that K12 never quantizes for a conv that
    then runs plain."""
    return impl == "int8" and c3.supported(x_shape, (3, 3, x_shape[-1], out_ch), int8=True)

