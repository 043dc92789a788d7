"""K1: fused GroupNorm(+SiLU), and K12: GroupNorm+SiLU emitting int8, NHWC.

K1 replaces ``gddim_tpu/ops/groupnorm.py:group_norm_silu`` (``_gn_silu_kernel``).

What bounds it on the H100: memory. It reads x once for the statistics,
again to normalise (from L2 at these sizes: one sample is at most 512 KB of
bf16) and writes the output once; there is no tensor-core work. The Triton
kernel runs one program per (sample, group), reduces in f32 with a two-pass
variance (E[x^2] - mean^2 cancels at 32x32 with bf16 inputs), then applies
normalise + affine + SiLU in one elementwise pass and writes x's dtype
(bf16 in sampling, f32 in training).

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
same statistics. It is CUDA because Triton has no clusters: (group,
sample) programs must meet through device memory for the amax and read x
again, and one program a sample leaves most SMs idle.
"""

from __future__ import annotations

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


_kernel = None


def _triton_kernel():
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def gn_silu_kernel(x_ptr, scale_ptr, bias_ptr, out_ptr, HW, C, CG, inv_n, eps,
                           APPLY_SILU: tl.constexpr, BLOCK_P: tl.constexpr,
                           BLOCK_C: tl.constexpr):
            g = tl.program_id(0)
            b = tl.program_id(1)
            cols = g * CG + tl.arange(0, BLOCK_C)
            cmask = tl.arange(0, BLOCK_C) < CG
            base = x_ptr + b.to(tl.int64) * HW * C
            acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
            for p0 in range(0, HW, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                m = (rows[:, None] < HW) & cmask[None, :]
                acc += tl.load(base + rows[:, None] * C + cols[None, :], mask=m,
                               other=0.0).to(tl.float32)
            mean = tl.sum(tl.sum(acc, axis=1), axis=0) * inv_n
            acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
            for p0 in range(0, HW, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                m = (rows[:, None] < HW) & cmask[None, :]
                v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m,
                            other=0.0).to(tl.float32)
                d = tl.where(m, v - mean, 0.0)
                acc += d * d
            var = tl.sum(tl.sum(acc, axis=1), axis=0) * inv_n
            rstd = 1.0 / tl.sqrt(var + eps)
            gamma = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            beta = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            a = gamma * rstd
            sh = beta - mean * a
            obase = out_ptr + b.to(tl.int64) * HW * C
            for p0 in range(0, HW, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                m = (rows[:, None] < HW) & cmask[None, :]
                v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m,
                            other=0.0).to(tl.float32)
                y = v * a[None, :] + sh[None, :]
                if APPLY_SILU:
                    y = y * tl.sigmoid(y)
                tl.store(obase + rows[:, None] * C + cols[None, :],
                         y.to(out_ptr.dtype.element_ty), mask=m)

        _kernel = gn_silu_kernel
    return _kernel


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _group_norm_silu_kernel(x, scale, bias, num_groups: int, eps: float, apply_silu: bool):
    """The Triton launch on CUDA tensors."""
    b, h, w, c = x.shape
    if c % num_groups or x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"group_norm_silu: unsupported input {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    cg = c // num_groups
    hw = h * w
    block_c = _next_pow2(cg)
    block_p = max(16, min(_next_pow2(hw), 4096 // block_c))
    _triton_kernel()[(num_groups, b)](
        x, scale, bias, out, hw, c, cg, 1.0 / (hw * cg), eps,
        APPLY_SILU=apply_silu, BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4,
    )
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
    """GroupNorm(+SiLU) over (B, H, W, C): the Triton kernel on CUDA tensors,
    the plain version on CPU tensors; differentiable either way. When autograd
    does not record (sampling), the ``autograd.Function`` is skipped."""
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
