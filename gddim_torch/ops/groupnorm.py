"""K1: fused GroupNorm(+SiLU), and K12: GroupNorm+SiLU emitting int8, NHWC.

K1 replaces ``gddim_tpu/ops/groupnorm.py:group_norm_silu`` (``_gn_silu_kernel``).

What bounds it on the H100: bytes (x read once, the output written once;
no tensor-core work), and at the small sites (4x4, 8x8) the launch. The
CUDA kernel (``csrc/groupnorm.cu``, ``gn_silu_kernel``; ``gddim_gn_silu``)
is one launch a call: a cluster of 1-16 CTAs a sample (``gn_silu_ctas`` in
``ops/resblock.py``; one CTA at the small sites) reads the sample once into
shared memory, sums it per group in f32, meets in distributed shared memory
in rank order, takes the two-pass variance (E[x^2] - mean^2 cancels at
32x32 with bf16 inputs) from shared memory, then applies normalise + affine
+ SiLU and writes x's dtype (bf16 in sampling, f32 in training; f16 too).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Either way it is an ``autograd.Function``
whose backward is autograd of the plain version recomputed from
(x, scale, bias), as the JAX ``custom_vjp`` does (``groupnorm.py:183-195``):
the training path (K1 in the transitions, attention and ``norm_out``) gets
the kernel's forward and exact plain gradients.

K12 replaces ``gddim_tpu/ops/groupnorm.py:group_norm_silu_quant``
(``_gn_silu_quant_kernel``): GroupNorm(+SiLU) with the TPU kernel's
arithmetic (one-pass statistics var = E[x^2] - mean^2, then
(x - mean) * rstd * scale + bias, SiLU, all f32), quantized per sample:
qs = max(max|out| over the sample, 1e-12) / 127, q = clip(rint(out / qs),
-127, 127) with a true division and round half to even. It returns
(q int8, qs (B,) f32), which the int8 3x3 conv (K11, ``ops/conv3x3.py``)
takes as they are. Inference only: no backward.

What bounds K12 on the H100: bytes (x read once, q written once). The
kernel reaches ~11% of that bound at B=64 (``PERF.md``): each element's
unfolded affine and SiLU run twice (for the amax, then for q) on two CTAs
an SM at 32x32, and at the 4x4 and 8x8 sites a launch and three cluster
barriers take ~10 us. The per-sample amax
spans the whole sample, which a single CTA reads slowly and a grid of
(group, sample) programs must meet across. K12 is the per-sample int8 mode
of GN1's one-launch kernel (``csrc/gn_apply.cu``, ``gddim_gn_silu_quant``):
a cluster of 8 CTAs a sample holds it in shared memory after one read, its
statistics and its amax meet in distributed shared memory, and the kernel
writes q and qs; its affine is the TPU kernel's, unfolded. Where a sample
does not fit the cluster, or x is f32 (``ops/resblock.py:gn_apply_ctas``),
it is the GroupNorm statistics kernel, the per-sample amax, the int8
pre-pass and a scale kernel, which apply the folded affine x * a + b of the
same statistics. It is CUDA, as K1 is, because Triton has no clusters:
(group, sample) programs must meet through device memory for the amax and
read x again, and one program a sample leaves most SMs idle.
"""

from __future__ import annotations

import functools

import torch

from gddim_torch import _build


def group_norm_silu_reference(x, scale, bias, num_groups: int, eps: float = 1e-6,
                              apply_silu: bool = True):
    """Plain version: f32 statistics, matches nn.GroupNorm + swish."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    norm = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = norm * scale.float() + bias.float()
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@functools.lru_cache(maxsize=None)
def _plan(b: int, h: int, w: int, c: int, itemsize: int) -> tuple[int, bool]:
    """(CTAs a sample, whether they hold it) of K1 on (b, h, w, c), from
    ``gn_silu_ctas``; raises where even the streaming route's shared memory
    does not fit."""
    from gddim_torch.ops.resblock import SMEM_BYTES, gn_silu_ctas, gn_silu_holds, gn_silu_smem

    ctas = gn_silu_ctas(b, h, w, c, itemsize)
    hold = gn_silu_holds(h, w, c, itemsize, ctas)
    if gn_silu_smem(c, itemsize, -(-(h * w) // ctas), hold) > SMEM_BYTES:
        raise ValueError(f"group_norm_silu: {c} channels do not fit the kernel's shared memory")
    return ctas, hold


def _group_norm_silu_kernel(x, scale, bias, num_groups: int, eps: float, apply_silu: bool):
    """One ``gddim_gn_silu`` launch on CUDA tensors, on the plan of
    ``gn_silu_ctas``."""
    b, h, w, c = x.shape
    if c % num_groups or x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_silu: unsupported input {tuple(x.shape)} {x.dtype} "
                         f"with {num_groups} groups")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel's 16-byte vectors
        x = x.clone()
    ctas, hold = _plan(b, h, w, c, x.element_size())
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    _build.launch("gddim_gn_silu", x.device, x.data_ptr(), _DTYPES[x.dtype], b, h * w, c,
                  num_groups, scale.data_ptr(), bias.data_ptr(), eps, int(apply_silu), ctas,
                  int(hold), out.data_ptr())
    group_norm_silu.launches += 1
    return out


def _forward(x, scale, bias, num_groups, eps, apply_silu):
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups, eps, apply_silu)
    return _group_norm_silu_kernel(x, scale, bias, num_groups, eps, apply_silu)


class _GroupNormSiLU(torch.autograd.Function):
    """Kernel (or, on the CPU, plain) forward; backward by autograd of the
    plain version recomputed from the saved (x, scale, bias)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, apply_silu)
        return _forward(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
            out = group_norm_silu_reference(*xs, *ctx.cfg)
            grads = torch.autograd.grad(out, xs, g)
        return (*grads, None, None, None)


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-6,
                    apply_silu: bool = True):
    """GroupNorm(+SiLU) over (B, H, W, C): the CUDA kernel on CUDA tensors
    (bf16, f16 or f32), the plain version on CPU tensors; differentiable
    either way. When autograd does not record (sampling), the
    ``autograd.Function`` is skipped."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
    return _forward(x, scale, bias, num_groups, eps, apply_silu)


group_norm_silu.launches = 0  # kernel launches on CUDA tensors


# --------------------------------------------------------------------------
# K12: GroupNorm+SiLU emitting int8 and a per-sample scale
# --------------------------------------------------------------------------


def group_norm_silu_quant_reference(x, scale, bias, num_groups: int, eps: float = 1e-6,
                                    apply_silu: bool = True):
    """Plain version of K12: the TPU kernel's GroupNorm (``group_norm_tpu``,
    fold=False) in f32, then per-sample quantization. Returns (q int8, qs (B,) f32)."""
    from gddim_torch.ops.resblock import group_norm_tpu, quant_dynamic

    out = group_norm_tpu(x.float(), scale, bias, num_groups, eps, apply_silu, fold=False)
    q, qs = quant_dynamic(out)
    return q.to(torch.int8), qs.reshape(-1)


def group_norm_silu_quant(x, scale, bias, num_groups: int = 32, eps: float = 1e-6,
                          apply_silu: bool = True):
    """K12: GroupNorm(+SiLU) of (B, H, W, C) returning (q int8 (B, H, W, C),
    qs (B,) f32), value ~= q * qs[b]. On CUDA tensors (x bf16 or f32, C a
    multiple of 8 and of the groups) one ``gddim_gn_silu_quant`` call on the
    route of ``gn_apply_ctas`` (one count in ``launches``), on CPU tensors
    the plain version."""
    from gddim_torch.ops.resblock import _on_cpu, _operand, gn_apply_ctas, require_no_grad

    if _on_cpu(x, "group_norm_silu_quant"):
        return group_norm_silu_quant_reference(x, scale, bias, num_groups, eps, apply_silu)
    require_no_grad("group_norm_silu_quant", x, scale, bias)
    b, h, w, c = x.shape
    if c % num_groups or c % 8 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm_silu_quant: unsupported input {tuple(x.shape)} {x.dtype} "
                         f"with {num_groups} groups")
    f32, dev = torch.float32, x.device
    ctas = gn_apply_ctas(h, w, c, x.dtype == f32)
    xs = _operand(x, "x", x.dtype)
    gamma, beta = _operand(scale, "scale", f32, (c,)), _operand(bias, "bias", f32, (c,))
    q = torch.empty((b, h, w, c), device=dev, dtype=torch.int8)
    qs = torch.empty((b,), device=dev, dtype=f32)
    # the route of several launches: the affine (B, C) twice and the amax (B,)
    work = None if ctas else torch.empty(2 * b * c + b, device=dev, dtype=f32)
    _build.launch("gddim_gn_silu_quant", dev, xs.data_ptr(), int(x.dtype == f32), b, h * w, c,
                  num_groups, gamma.data_ptr(), beta.data_ptr(), eps, int(apply_silu), ctas,
                  _build.ptr(work), q.data_ptr(), qs.data_ptr())
    group_norm_silu_quant.launches += 1
    return q, qs


group_norm_silu_quant.launches = 0  # calls on CUDA tensors (one gddim_gn_silu_quant each)
