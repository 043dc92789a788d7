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

What bounds K12 on the H100: memory and the per-element arithmetic (the
sigmoid and the IEEE division, twice); there is no tensor-core work. The
per-sample amax spans all groups, so K12 is two Triton launches, each with
one program per (group, sample) as K1: the first takes its group's one-pass
statistics and the amax of its activated values and writes (mean, rstd,
amax); the second takes the sample's scale from the 32 group amaxes (a max,
so every program of the sample computes the same scale, whatever order the
programs ran in: deterministic, no atomics), recomputes its group's
activated values and writes them as int8. x is read three times (the
second and third from L2 at these sizes) and q written once. One program
per sample, in one launch, was the first form: it keeps only B of the
card's 132 SMs busy, each with the arithmetic of a whole sample, and
measured 5x to 26x slower at 32x32, B=4 (``PERF.md``); the second
launch costs its host time instead.
"""

from __future__ import annotations

import torch


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


_quant_kernel = None


def _triton_quant_kernel():
    global _quant_kernel
    if _quant_kernel is None:
        import triton
        import triton.language as tl

        # IEEE division and square root (Triton's own may be approximate) and
        # round half to even, as jnp.round and torch.round
        @triton.jit
        def _div_rn(a, b):
            return tl.inline_asm_elementwise("div.rn.f32 $0, $1, $2;", "=f,f,f", [a, b],
                                             dtype=tl.float32, is_pure=True, pack=1)

        @triton.jit
        def _sqrt_rn(a):
            return tl.inline_asm_elementwise("sqrt.rn.f32 $0, $1;", "=f,f", [a],
                                             dtype=tl.float32, is_pure=True, pack=1)

        @triton.jit
        def _rint(a):
            return tl.inline_asm_elementwise("cvt.rni.f32.f32 $0, $1;", "=f,f", [a],
                                             dtype=tl.float32, is_pure=True, pack=1)

        # Both kernels: one program per (group, sample), its group's channels
        # (padded to a power of two) over all pixels, as K1.
        @triton.jit
        def gn_silu_amax_kernel(x_ptr, scale_ptr, bias_ptr, st_ptr, HW, C, CG, inv_n, eps,
                                APPLY_SILU: tl.constexpr, BLOCK_P: tl.constexpr,
                                BLOCK_CG: tl.constexpr):
            g = tl.program_id(0)
            b = tl.program_id(1)
            G = tl.num_programs(0)
            cols = g * CG + tl.arange(0, BLOCK_CG)
            cmask = tl.arange(0, BLOCK_CG) < CG
            base = x_ptr + b.to(tl.int64) * HW * C
            # one-pass statistics: sums of x and x^2, per tile element through
            # the loop, reduced once after it
            s1 = tl.zeros((BLOCK_P, BLOCK_CG), dtype=tl.float32)
            s2 = tl.zeros((BLOCK_P, BLOCK_CG), dtype=tl.float32)
            for p0 in range(0, HW, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                m = (rows[:, None] < HW) & cmask[None, :]
                v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m,
                            other=0.0).to(tl.float32)
                s1 += v
                s2 += v * v
            mean = tl.sum(tl.sum(s1, axis=1), axis=0) * inv_n
            var = tl.zeros((BLOCK_CG,), dtype=tl.float32) + (
                tl.sum(tl.sum(s2, axis=1), axis=0) * inv_n - mean * mean)
            rstd = _div_rn(tl.full((BLOCK_CG,), 1.0, tl.float32), _sqrt_rn(var + eps))
            gamma = tl.load(scale_ptr + cols, mask=cmask, other=0.0)
            beta = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
            # the group's amax of the activated values
            mx = tl.zeros((BLOCK_P, BLOCK_CG), dtype=tl.float32)
            for p0 in range(0, HW, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                m = (rows[:, None] < HW) & cmask[None, :]
                v = tl.load(base + rows[:, None] * C + cols[None, :], mask=m,
                            other=0.0).to(tl.float32)
                y = (v - mean) * rstd[None, :] * gamma[None, :] + beta[None, :]
                if APPLY_SILU:
                    y = y * tl.sigmoid(y)
                mx = tl.maximum(mx, tl.where(m, tl.abs(y), 0.0))
            st = st_ptr + (b * G + g) * 3
            tl.store(st, mean)
            tl.store(st + 1, tl.max(rstd, axis=0))
            tl.store(st + 2, tl.max(tl.max(mx, axis=1), axis=0))

        @triton.jit
        def gn_silu_quant_kernel(x_ptr, scale_ptr, bias_ptr, st_ptr, q_ptr, s_ptr, HW, C, CG,
                                 APPLY_SILU: tl.constexpr, G: tl.constexpr,
                                 BLOCK_P: tl.constexpr, BLOCK_CG: tl.constexpr):
            g = tl.program_id(0)
            b = tl.program_id(1)
            cols = g * CG + tl.arange(0, BLOCK_CG)
            cmask = tl.arange(0, BLOCK_CG) < CG
            base = b.to(tl.int64) * HW * C
            # the sample's scale from its groups' amaxes: every program of the
            # sample computes it from the same values, so they agree
            amax = tl.max(tl.load(st_ptr + (b * G + tl.arange(0, G)) * 3 + 2), axis=0)
            qs = _div_rn(tl.maximum(tl.zeros((BLOCK_CG,), dtype=tl.float32) + amax, 1e-12),
                         tl.full((BLOCK_CG,), 127.0, tl.float32))
            mean = tl.load(st_ptr + (b * G + g) * 3)
            rstd = tl.load(st_ptr + (b * G + g) * 3 + 1)
            gamma = tl.load(scale_ptr + cols, mask=cmask, other=0.0)
            beta = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
            qs2 = tl.zeros((BLOCK_P, BLOCK_CG), dtype=tl.float32) + qs[None, :]
            for p0 in range(0, HW, BLOCK_P):
                rows = p0 + tl.arange(0, BLOCK_P)
                m = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                v = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
                y = (v - mean) * rstd * gamma[None, :] + beta[None, :]
                if APPLY_SILU:
                    y = y * tl.sigmoid(y)
                q = _rint(_div_rn(y, qs2))
                q = tl.minimum(tl.maximum(q, -127.0), 127.0)
                tl.store(q_ptr + offs, q.to(tl.int8), mask=m)
            if g == 0:
                tl.store(s_ptr + b, tl.max(qs, axis=0))

        _quant_kernel = (gn_silu_amax_kernel, gn_silu_quant_kernel)
    return _quant_kernel


def group_norm_silu_quant(x, scale, bias, num_groups: int = 32, eps: float = 1e-6,
                          apply_silu: bool = True):
    """K12: GroupNorm(+SiLU) of (B, H, W, C) returning (q int8 (B, H, W, C),
    qs (B,) f32), value ~= q * qs[b]. The two Triton launches on CUDA tensors
    (32 or any power-of-two number of groups; one count in ``launches``), the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return group_norm_silu_quant_reference(x, scale, bias, num_groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_quant: unsupported device {x.device}")
    from gddim_torch.ops.resblock import require_no_grad

    require_no_grad("group_norm_silu_quant", x, scale, bias)
    b, h, w, c = x.shape
    if (c % num_groups or num_groups & (num_groups - 1)
            or x.dtype not in (torch.bfloat16, torch.float16, torch.float32)):
        raise ValueError(f"group_norm_silu_quant: unsupported input {tuple(x.shape)} {x.dtype} "
                         f"with {num_groups} groups")
    x = x.contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    q = torch.empty((b, h, w, c), device=x.device, dtype=torch.int8)
    qs = torch.empty((b,), device=x.device, dtype=torch.float32)
    stats = torch.empty((b, num_groups, 3), device=x.device, dtype=torch.float32)
    cg = c // num_groups
    hw = h * w
    block_cg = _next_pow2(cg)
    block_p = max(16, min(_next_pow2(hw), 4096 // block_cg))
    amax_kernel, quant_kernel = _triton_quant_kernel()
    amax_kernel[(num_groups, b)](
        x, scale, bias, stats, hw, c, cg, 1.0 / (hw * cg), eps,
        APPLY_SILU=apply_silu, BLOCK_P=block_p, BLOCK_CG=block_cg, num_warps=4,
    )
    quant_kernel[(num_groups, b)](
        x, scale, bias, stats, q, qs, hw, c, cg,
        APPLY_SILU=apply_silu, G=num_groups, BLOCK_P=block_p, BLOCK_CG=block_cg, num_warps=4,
    )
    group_norm_silu_quant.launches += 1
    return q, qs


group_norm_silu_quant.launches = 0  # kernel launches on CUDA tensors
