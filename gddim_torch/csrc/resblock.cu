// Fused residual-block kernels for Hopper (sm_90a), bf16 tensor-core
// operands with f32 accumulation (int8 with int32 in the int8 modes).
//
// Replaces gddim_tpu/ops/resblock.py: fused_resblock (K2, _resblock_kernel_v2),
// fused_resblock_pair (K3, _resblock_pair_kernel_v2), fused_resblock_tail
// (K4, _resblock_kernel_v2 with GN1 off), and the training forward of
// make_fused_resblock_train (K6: fused_resblock with f32 x and out and the
// dropout mask, on the block GEMM). A block is one C call of a few
// launches, its scratch carved from one workspace buffer. The temb row
// (silu(temb) @ W_dense + b_dense, which the first conv's epilogue adds)
// comes precomputed: the model makes every block's row in one f32 product
// an eval (models/unet.py), as the JAX package makes it outside its Pallas
// kernels.
//
//   gn_apply_kernel   (gn_apply.cu) GN1 on bf16 activations in one launch:
//                     the statistics below and conv1's operand a1 (K5's h)
//                     from the sample held in shared memory, one cluster a
//                     sample that reads x once; the pre-pass's arithmetic.
//   gn_stats_kernel   GroupNorm statistics as the TPU kernels take them
//                     (gn_silu_tile, gddim_tpu/ops/resblock.py:345-356):
//                     per-channel f32 sums and sums of squares in one pass
//                     over x, folded by group, var = E[x^2] - mean^2, into a
//                     per-(sample, channel) affine. A cluster of 8 CTAs a
//                     sample, each over an eighth of its pixels with 16-byte
//                     loads of 8 channels along the channel row; the CTAs'
//                     sums meet through distributed shared memory, added in
//                     rank order (no float atomics: the same result every
//                     run). Reads one input or two (xa, xb) by logical
//                     channel, so a group that straddles the xa/xb boundary
//                     gets statistics over both. GN1 where it is not one
//                     launch (f32 activations, K6, K7; the bare route 0).
//   prepass_kernel    a conv's input through the GN affine + SiLU, written
//                     once NHWC in the workspace as the block GEMM's operand:
//                     bf16 (a1.astype(mm_dtype), the TPU kernels' rounding
//                     point) or int8 (quantize8).
//   block_gemm_launch the block GEMM (block_gemm.cu): wgmma fed by TMA, the
//                     1x1 skip in the same accumulators, the epilogue (bias,
//                     b_skip, temb row, identity residual, 1/sqrt(2)) from
//                     registers; for conv1 also GN2's per-channel partial
//                     sums of h1, a row a (M tile, sample).
//   gn_prepass_kernel GN2's pre-pass: folds conv1's partial sums (fold_affine,
//                     a fixed order) into the affine in shared memory, then
//                     writes silu(GN2(h1)) as prepass_kernel does (the
//                     training blocks: times the dropout mask / keep, and
//                     the fold written out for K7); h1 is read once, for the
//                     pre-pass only.
//
// bf16 mode (K2-K4 on bf16 activations, conv_impl 'fused'; the entry
// gddim_resblock, and K9's through transition.cu), resblock_gemm_run, 3-6
// launches: GN1 (gn_apply_kernel: a1 = silu(GN1(x)) of the logical concat,
// its statistics from the same read of x; the route ops/resblock.py:
// gn_apply_ctas; route 0, gn_stats_kernel then the bf16 pre-pass; K4 and K9
// have no GN1 and conv1 reads h as it is), conv1 -> h1 f32
// (+ b1 + temb) with GN2's partial sums, GN2's folding pre-pass (a2 =
// silu(GN2(h1))), conv2 + the 1x1 skip (or the identity residual) -> bf16
// out, plus a split-K reduction after a conv whose grid is small. h1 stays
// f32 between the convs, as the TPU kernel keeps acc3 in f32 and rounds only
// at the MMA operands; the pre-pass's zeros-out-of-bounds are the
// activation's, as the TPU kernel pads a1 (hpad_ref).
//
// int8 mode (K2-K4 with mm_dtype int8, conv_impl 'fused_int8'; the entry
// gddim_resblock_int8, and K9's through transition.cu). Replaces the same
// three Pallas kernels' int8 path: _resblock_kernel_v2 with static scales,
// _resblock_kernel and _resblock_pair_kernel with per-sample (dynamic)
// scales. The same runner, 3-7 launches: as the bf16 mode; GN1's
// gn_apply_kernel writes q(a1) (in the per-sample mode after its own
// cluster-wide amax of a1), and conv2's pre-pass is GN2's folding pre-pass
// (per sample: gn_fold_kernel, amax_kernel of a2, then the pre-pass);
// every int8 operand by quantize8: clip(rint(a * (1/s))) with a
// static scale, clip(rint(a / s_b)) with s_b = max(amax_b, 1e-12)/127 per
// sample (the pair's conv1: a * (127/amax_b)), as the TPU kernels write
// each; K4's conv1 quantizes h in a pre-pass too, K9's with a static scale
// in its gn_apply_kernel launch (x_q8). The GEMM dequantizes its int32 sums
// by (w_scale * s). The 1x1 skip runs bf16 (the TPU kernels' dynamic-skip
// form; the model never passes a static skip scale), or, with act_scales
// [s1, s2, sx] (the ops API fed by calibration's "x" amaxes; StaticSkip in
// conv.cuh), as the TPU kernels' static skip (resblock.py:283-290, 408-415,
// 830-833, 957, 1404): q(x) = clip(rint(x * (1/sx))) of the skip input as
// stored (K3: both halves) into the workspace, by GN1's gn_apply_kernel
// beside q(a1) from the input it holds (K2, K3), or by the int8 pre-pass
// (K4, whose skip input no launch reads, and GN1's route 0; K9's first
// launch writes q(xr) itself); then its 1x1 runs as int8 K slices of conv2's
// block GEMM (block_gemm.cu's SK8): its int32 sums converted once,
// f32(sums) * (w_skip_scale * sx) + b_skip, added after conv2's + b2,
// before the 1/sqrt(2). No launch and no f32 (M, N) buffer of its own.
//
// f32 activations (K2-K4 on f32 x, which write f32 as the TPU kernels write
// x's dtype: gddim_resblock with act_f32), the bf16 mode's runner and
// launches with x, the identity residual and out in f32: GN1 takes
// gn_stats_kernel on f32 x, then the pre-pass writes a1 in bf16 (K2/K3:
// and bf16 x, the 1x1 skip's operand, from the same read; K4: bf16 h, and
// bf16 x_skip in a second pre-pass), conv1 -> f32 h1 with GN2's sums, GN2's
// folding pre-pass, conv2 + the bf16 skip slices or the f32 identity
// residual -> f32 out. Only the MMA operands are bf16, as on the TPU with
// mm_dtype bf16 (gddim_tpu/models/blocks.py:271-274).
//
// K6 (gddim_resblock_train): the same chain with the dropout mask in GN2's
// folding pre-pass.
//
// What bounds it on the H100: the two convs, tensor-core bound at 32x32 and
// 16x16 (2*M*9*Cin*Cout operations against M*(Cin+Cout) activation bytes
// and 9*Cin*Cout of weights), memory- and latency-bound at 8x8 and 4x4 (M
// = B*H*W a few hundred rows, each weight byte feeding ~M operations).
// Around them, GN1 (bytes: x read once and a1 written once, ~50 + 50 MB of
// bf16 at the largest site, 32x32x384 at B=64, ~30 us; launch and cluster
// latency at the small sites; GN2 costs conv1's epilogue its sums over the
// staged tile and no read of h1) and GN2's pre-pass (bytes: at 32x32x256,
// B=64 ~34 MB of bf16 in, ~17 MB of int8 or ~34 MB of bf16 out, mostly kept
// in L2 for the GEMM). The block GEMM answers the convs (block_gemm.cu's
// header), and K5's 1x1 projections on bf16 activations and in int8
// (attnblock.cu), K6's convs and K7's convs and dgrads, and every block on
// f32 activations (K2-K5, K9, K10's forward).
//
//   amax_kernel          dynamic mode: the per-sample amax of the quantized
//                        activation, one pass before conv2 (and before conv1
//                        on GN1's route 0); atomicMax on
//                        the bit patterns of non-negative floats, so the
//                        result does not depend on the order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act.cuh"
#include "conv.cuh"

namespace cgr = cooperative_groups;

namespace {

constexpr int THREADS_GN = 256;
constexpr int GN_CTAS = 8;         // gn_stats_kernel's cluster: the CTAs of one sample
constexpr int GN_MAX_GROUPS = 32;  // num_groups_for(C) = min(C / 4, 32)
constexpr int GN_MAX_C = 2048;     // 8 channels a thread, at least one pixel lane

// grid (GN_CTAS, B), clusters of GN_CTAS along x: one cluster a sample, CTA
// r over pixels [r hw / 8, (r + 1) hw / 8). Thread t owns the 8 channels of
// vector t % (C / 8) at pixel lane t / (C / 8), so a warp reads whole
// channel rows of consecutive pixels, 16 bytes a thread. Shared memory: the
// lanes' sums and squares (2 lanes C floats), then the CTA's (2 C), which
// the cluster's CTAs read from each other: CTA r folds groups r, r + 8, ...
// (a warp a group: its channels' totals over the 8 CTAs in rank order, then
// a butterfly over the warp) into the affine, mean and rstd.
template <typename T>
__global__ void __cluster_dims__(GN_CTAS, 1, 1) __launch_bounds__(THREADS_GN)
gn_stats_kernel(const T* __restrict__ xa, const T* __restrict__ xb, int ca, int cb, int hw,
                int groups, const float* __restrict__ gamma, const float* __restrict__ beta,
                float eps, float* __restrict__ scale, float* __restrict__ shift,
                float* __restrict__ mean_out, float* __restrict__ rstd_out) {
  extern __shared__ float gsm[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y, t = threadIdx.x;
  const int c_tot = ca + cb, cv = c_tot / 8, lanes = THREADS_GN / cv;
  const int lane = t / cv, v = t % cv;
  float* ls = gsm;                      // [lanes][c_tot] sums
  float* lq = gsm + lanes * c_tot;      // [lanes][c_tot] squares
  float* cs = gsm + 2 * lanes * c_tot;  // [2][c_tot] the CTA's sums and squares
  if (lane < lanes) {
    float s[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
    const int c = 8 * v;
    const T* base = c < ca ? xa + (long)b * hw * ca + c : xb + (long)b * hw * cb + (c - ca);
    const long stride = c < ca ? ca : cb;
    const int p0 = (int)((long)hw * rank / GN_CTAS), p1 = (int)((long)hw * (rank + 1) / GN_CTAS);
#pragma unroll 4
    for (int p = p0 + lane; p < p1; p += lanes) {
      Pack8<T> pk;
      ld8(pk, base + p * stride);
      float f[8];
      unpack8(pk, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] += f[j];
        q[j] += f[j] * f[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ls[lane * c_tot + c + j] = s[j];
      lq[lane * c_tot + c + j] = q[j];
    }
  }
  __syncthreads();
  for (int c = t; c < c_tot; c += THREADS_GN) {
    float s = 0.f, q = 0.f;
    for (int l = 0; l < lanes; ++l) {
      s += ls[l * c_tot + c];
      q += lq[l * c_tot + c];
    }
    cs[c] = s;
    cs[c_tot + c] = q;
  }
  cluster.sync();
  const int cg = c_tot / groups, warp = t >> 5, l32 = t & 31;
  const float inv_n = 1.0f / (float)((long)hw * cg);
  for (int g = rank + GN_CTAS * warp; g < groups; g += GN_CTAS * (THREADS_GN / 32)) {
    float s = 0.f, q = 0.f;
    for (int j = l32; j < cg; j += 32)
      for (int r = 0; r < GN_CTAS; ++r) {
        const float* peer = cluster.map_shared_rank(cs, r);
        s += peer[g * cg + j];
        q += peer[c_tot + g * cg + j];
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    // E[x^2] - mean^2, each product rounded as the plain version's
    const float mean = __fmul_rn(s, inv_n);
    const float rstd =
        rsqrtf(__fadd_rn(__fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(mean, mean)), eps));
    for (int j = l32; j < cg; j += 32) {
      const int c = g * cg + j;
      const float a = __fmul_rn(rstd, gamma[c]);
      scale[(long)b * c_tot + c] = a;
      shift[(long)b * c_tot + c] = __fsub_rn(beta[c], __fmul_rn(mean, a));
    }
    if (mean_out != nullptr && l32 == 0) {
      mean_out[(long)b * groups + g] = mean;
      rstd_out[(long)b * groups + g] = rstd;
    }
  }
  cluster.sync();  // a CTA's shared memory stays until the cluster has read it
}

// GN statistics of one (B, hw, C) tensor as per-channel partial sums:
// part (2, B, parts, C), [0] sums, [1] squares (block_gemm.cu's gn_part)
struct GnFold {
  const float* part;
  int parts, groups;
  const float* gamma;
  const float* beta;
  float eps;
};

// The per-channel affine of sample b from its partial sums, into sc and sh
// (C floats of shared memory each; gs: 2 * GN_MAX_GROUPS floats): each
// channel's partials in order, then each group's channels in order, with
// gn_stats_kernel's arithmetic. Every thread of the CTA takes part.
__device__ void fold_affine(const GnFold& f, int batch, int b, int c, int hw, float* sc,
                            float* sh, float* gs) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float* ps = f.part + (long)b * f.parts * c + ch;
    const float* pq = f.part + (long)(batch + b) * f.parts * c + ch;
    float s = 0.f, q = 0.f;
    for (int k = 0; k < f.parts; ++k) {
      s += ps[(long)k * c];
      q += pq[(long)k * c];
    }
    sc[ch] = s;
    sh[ch] = q;
  }
  __syncthreads();
  const int cg = c / f.groups;
  const float inv_n = 1.0f / (float)((long)hw * cg);
  for (int g = threadIdx.x; g < f.groups; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += sc[g * cg + j];
      q += sh[g * cg + j];
    }
    const float mean = __fmul_rn(s, inv_n);
    gs[g] = mean;
    gs[GN_MAX_GROUPS + g] =
        rsqrtf(__fadd_rn(__fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(mean, mean)), f.eps));
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    const float a = __fmul_rn(gs[GN_MAX_GROUPS + g], f.gamma[ch]);
    sc[ch] = a;
    sh[ch] = __fsub_rn(f.beta[ch], __fmul_rn(gs[g], a));
  }
  __syncthreads();
}

// Shared memory of fold_affine over C channels
inline size_t fold_smem(int c) { return sizeof(float) * (2 * (size_t)c + 2 * GN_MAX_GROUPS); }

// grid B, THREADS_GN threads: the affine of fold_affine written out (the
// int8 per-sample mode, whose amax pass needs it before the pre-pass)
__global__ void __launch_bounds__(THREADS_GN)
gn_fold_kernel(const GnFold f, int batch, int c, int hw, float* __restrict__ scale,
               float* __restrict__ shift) {
  extern __shared__ float fsm[];
  const int b = blockIdx.x;
  fold_affine(f, batch, b, c, hw, fsm, fsm + c, fsm + 2 * c);
  for (int ch = threadIdx.x; ch < c; ch += THREADS_GN) {
    scale[(long)b * c + ch] = fsm[ch];
    shift[(long)b * c + ch] = fsm[c + ch];
  }
}

// ---------------------------------------------------------------------------
// int8 mode.

// grid (chunks, B), THREADS_GN threads; see amax_launch
template <typename T>
__global__ void __launch_bounds__(THREADS_GN)
amax_kernel(const T* __restrict__ xa, const T* __restrict__ xb, int ca, int cb, int hw,
            const float* __restrict__ scale, const float* __restrict__ shift, int silu_on,
            float* __restrict__ amax) {
  __shared__ float red[THREADS_GN / 32];
  const int b = blockIdx.y;
  const int c_tot = ca + cb;
  const long vecs = (long)hw * c_tot / 8;
  float mx = 0.f;
  for (long v = (long)blockIdx.x * THREADS_GN + threadIdx.x; v < vecs;
       v += (long)gridDim.x * THREADS_GN) {
    const long pix = (long)b * hw + v * 8 / c_tot;
    const int c = (int)(v * 8 % c_tot);
    Pack8<T> pk;
    if (c < ca)
      ld8(pk, xa + pix * ca + c);
    else
      ld8(pk, xb + pix * cb + (c - ca));
    float f[8];
    unpack8(pk, f);
    const long o = (long)b * c_tot + c;
    mx = amax8(f, scale ? scale + o : nullptr, scale ? shift + o : nullptr, silu_on, mx);
  }
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < THREADS_GN / 32; ++w) mx = fmaxf(mx, red[w]);
    // non-negative floats order as their bit patterns do, so the max is the
    // same whatever order the blocks arrive in
    atomicMax(reinterpret_cast<int*>(amax + b), __float_as_int(mx));
  }
}

// The block GEMM's pre-pass: the logical concat (xa, xb) of one conv's
// input through the GN affine (+SiLU), written once NHWC (B, H, W, ca+cb)
// for the GEMM's TMA loads (block_gemm.cu), as TQ: int8 by quantize8 (the
// int8 modes), or bf16 (the bf16 modes; a1.astype(mm_dtype) of the TPU
// kernels). Each element is made once. With raw non-null (the blocks on f32
// activations), also bf16(x) itself, the 1x1 skip's operand, from the same
// read. grid
// ceil(M * (ca+cb) / 8 / 256), 256 threads, 8 channels each.
template <typename T, typename TQ>
__global__ void __launch_bounds__(256)
prepass_kernel(const T* __restrict__ xa, const T* __restrict__ xb, int ca, int cb, long vecs,
               int hw, const float* __restrict__ scale, const float* __restrict__ shift,
               int silu_on, const Int8Args q, TQ* __restrict__ out, bf16* __restrict__ raw) {
  const long v = (long)blockIdx.x * 256 + threadIdx.x;
  if (v >= vecs) return;
  const int c_tot = ca + cb;
  const long pix = v * 8 / c_tot;
  const int c = (int)(v * 8 - pix * c_tot);
  const int b = (int)(pix / hw);
  Pack8<T> pk;
  if (c < ca)
    ld8(pk, xa + pix * ca + c);
  else
    ld8(pk, xb + pix * cb + (c - ca));
  if (raw != nullptr) *reinterpret_cast<uint4*>(raw + pix * c_tot + c) = bf16x8(pk);
  float f[8];
  unpack8(pk, f);
  const long base = (long)b * c_tot + c;
  const float* sc = scale != nullptr ? scale + base : nullptr;
  const float* sh = scale != nullptr ? shift + base : nullptr;
  convert8(f, sc, sh, silu_on, q, b, out + pix * c_tot + c);
}

// A training block's GN2 beside its folding pre-pass: the dropout mask
// (null: none) and 1/keep, and where scale is non-null the affine and the
// statistics written out for K7's GN2 backward.
struct GnTrain {
  const int8_t* mask;
  float inv_keep;
  float* scale;  // (B, C)
  float* shift;
  float* mean;   // (B, groups)
  float* rstd;
};

// GN2's pre-pass on conv1's f32 h1 (B, hw, c): fold_affine of the GEMM's
// partial sums into shared memory, then prepass_kernel's conversion of the
// CTA's share of sample b. TRAIN (K6, K7; bf16): d = bf16(silu(GN2(h1)) *
// mask / keep), as the TPU kernel drops a2 before rounding it, and CTA 0 of
// each sample writes the fold out when t.scale is set. grid (chunks, B), 256
// threads, fold_smem(c) bytes.
//
// What bounds it on the H100: bytes at 32x32 and 16x16 (h1 f32 read, the
// operand written; h1 mostly in L2, written by conv1 just before), the
// launch and the fold (dependent loads and three barriers, ~3 us) at 8x8 and
// 4x4. The loop divides nowhere: the thread's channel vector advances by
// 256 vectors a step (a 64-bit remainder a vector is a software division
// per 8 values), and the int8 scale's inverse is taken once a thread; the
// thread's first vector of h1 is loaded before the fold, so that its
// latency overlaps the fold's. Each element's arithmetic is convert8's and
// quantize8's.
template <typename TQ, bool TRAIN = false>
__global__ void __launch_bounds__(256)
gn_prepass_kernel(const float* __restrict__ h1, int c, int hw, const GnFold f, int batch,
                  const Int8Args q, TQ* __restrict__ out, const GnTrain t) {
  extern __shared__ float psm[];
  const int b = blockIdx.y;
  float* gs = psm + 2 * c;
  const long vecs = (long)hw * c / 8, per = (vecs + gridDim.x - 1) / gridDim.x;
  const long v1 = vecs < (blockIdx.x + 1) * per ? vecs : (blockIdx.x + 1) * per;
  const long base = (long)b * hw * c;
  long v = blockIdx.x * per + threadIdx.x;
  Pack8<float> pk;
  if (v < v1) ld8(pk, h1 + base + v * 8);  // in flight over the fold
  fold_affine(f, batch, b, c, hw, psm, psm + c, gs);
  if constexpr (TRAIN) {
    if (blockIdx.x == 0 && t.scale != nullptr) {
      for (int ch = threadIdx.x; ch < c; ch += 256) {
        t.scale[(long)b * c + ch] = psm[ch];
        t.shift[(long)b * c + ch] = psm[c + ch];
      }
      for (int g = threadIdx.x; g < f.groups; g += 256) {
        t.mean[b * f.groups + g] = gs[g];
        t.rstd[b * f.groups + g] = gs[GN_MAX_GROUPS + g];
      }
    }
  }
  const int cv = c / 8, step = 256 % cv;
  int cvec = (int)(v % cv);  // the channel vector of v, advanced by `step` a vector
  const float inv_static = (!TRAIN && q.qs != nullptr) ? 1.0f / *q.qs : 0.0f;
  for (bool first = true; v < v1; v += 256, first = false) {
    const int ch = 8 * cvec;
    cvec += step;
    if (cvec >= cv) cvec -= cv;
    if (!first) ld8(pk, h1 + base + v * 8);
    float x[8];
    unpack8(pk, x);
    if constexpr (TRAIN) {
      // convert8's bf16 arithmetic, then the mask before the rounding
      uint2 mk = {};
      if (t.mask != nullptr) mk = *reinterpret_cast<const uint2*>(t.mask + base + v * 8);
      const int8_t* m8 = reinterpret_cast<const int8_t*>(&mk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = silu(__fadd_rn(__fmul_rn(x[j], psm[ch + j]), psm[c + ch + j]));
        if (t.mask != nullptr) x[j] *= (float)m8[j] * t.inv_keep;
      }
      st8((bf16*)(out + base + v * 8), x);
    } else if constexpr (std::is_same<TQ, int8_t>::value) {
      *reinterpret_cast<uint2*>(out + base + v * 8) =
          quantize8(x, psm + ch, psm + c + ch, 1, inv_static, q, b);
    } else {
      convert8(x, psm + ch, psm + c + ch, 1, q, b, out + base + v * 8);
    }
  }
}

template <typename TQ>
int prepass_run(const void* xa, const void* xb, int ca, int cb, bool f32, int batch, int hw,
                const float* scale, const float* shift, int silu_on, const Int8Args& q, TQ* out,
                cudaStream_t st) {
  const long vecs = (long)batch * hw * (ca + cb) / 8;
  const unsigned grid = (unsigned)((vecs + 255) / 256);
  if (f32)
    prepass_kernel<float, TQ><<<grid, 256, 0, st>>>((const float*)xa, (const float*)xb, ca, cb,
                                                    vecs, hw, scale, shift, silu_on, q, out,
                                                    nullptr);
  else
    prepass_kernel<bf16, TQ><<<grid, 256, 0, st>>>((const bf16*)xa, (const bf16*)xb, ca, cb,
                                                   vecs, hw, scale, shift, silu_on, q, out,
                                                   nullptr);
  return (int)cudaGetLastError();
}

// GN2's pre-pass grid: at least 1024 vectors of 8 channels a CTA, about
// four CTAs an SM in all
int gn_prepass_chunks(int batch, int hw, int c) {
  const long vecs = (long)hw * c / 8;
  long chunks = 528 / batch;
  const long most = (vecs + 1023) / 1024;
  if (chunks > most) chunks = most;
  return chunks < 1 ? 1 : (int)chunks;
}

// GN2's affine into a2 = silu(GN2(h1)), conv2's operand: the folding
// pre-pass, or (int8 per sample: qs null) the fold written out, the amax of
// a2, then the pre-pass. Counted as the pre-pass where it launches.
int gn2_prepass_run(bool int8, const float* h1, const GnFold& f, int batch, int hw, int n,
                    const float* qs, float* sc2, float* sh2, float* amax2, void* out,
                    cudaStream_t st) {
  if (f.groups > GN_MAX_GROUPS || n % f.groups || n % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = fold_smem(n);
  if (int8 && qs == nullptr) {
    gn_fold_kernel<<<batch, THREADS_GN, smem, st>>>(f, batch, n, hw, sc2, sh2);
    int err = (int)cudaGetLastError();
    if (!err) err = amax_launch(h1, nullptr, n, 0, batch, hw, sc2, sh2, 1, amax2, true, st);
    const Int8Args q = {nullptr, amax2, 0};
    return err ? err : prepass_launch(h1, nullptr, n, 0, true, batch, hw, sc2, sh2, 1, &q, out, st);
  }
  const dim3 grid(gn_prepass_chunks(batch, hw, n), batch);
  if (int8)
    gn_prepass_kernel<int8_t><<<grid, 256, smem, st>>>(h1, n, hw, f, batch,
                                                       Int8Args{qs, nullptr, 0}, (int8_t*)out,
                                                       GnTrain{});
  else
    gn_prepass_kernel<bf16><<<grid, 256, smem, st>>>(h1, n, hw, f, batch, Int8Args{}, (bf16*)out,
                                                     GnTrain{});
  const int err = (int)cudaGetLastError();
  if (!err) {
    count_launch(int8 ? COUNT_PREPASS_S8 : COUNT_PREPASS_BF16);
    count_launch(COUNT_GN2_PREPASS);
  }
  return err;
}

// Scratch of one block on the block GEMM (null base: sizes only); act_bytes
// the pre-pass's output type, 1 (int8) or 2 (bf16); parts: conv1's tiles
// along H (GN2's partial rows a sample); xs: the skip's channels on f32
// activations (their bf16 copy), else 0; sx: the skip's channels with the
// int8 static skip (its int8 input q(x)), else 0. Of
//   8 B Cin + 4 M N + 8 B N + 8 B parts N + 8 B + act_bytes M max(Cin, N)
//   + 2 M xs + M sx (+ 4 splits M N when a conv splits K)
//   bytes, each buffer on 256 bytes.
struct WorkGemm {
  float* sc1;      // (B, Cin) GN1 affine
  float* sh1;
  float* h1;       // (M, N) conv1 output, f32
  float* sc2;      // (B, N) GN2 affine (int8 dynamic mode)
  float* sh2;
  float* gn2;      // (2, B, parts, N) GN2's partial sums and squares, from conv1
  float* amax;     // (2, B) int8 dynamic mode: per-sample amax of a1, a2
  void* a;         // (M, max(Cin, N)) the pre-pass's conv input, conv1's then conv2's
  void* xs;        // (M, xs) bf16 skip input (f32 activations), or null
  int8_t* xq;      // (M, sx) the static skip's int8 input, or null
  float* partial;  // (splits, M, N) split-K partial sums
  size_t xq_off;   // the byte offset of xq
  size_t bytes;
};

WorkGemm carve_gemm(char* base, int batch, long m, int cin, int n, int splits, int parts,
                    size_t act_bytes, int xs, int sx = 0) {
  WorkGemm w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  w.sc1 = (float*)take(sizeof(float) * batch * cin);
  w.sh1 = (float*)take(sizeof(float) * batch * cin);
  w.h1 = (float*)take(sizeof(float) * m * n);
  w.sc2 = (float*)take(sizeof(float) * batch * n);
  w.sh2 = (float*)take(sizeof(float) * batch * n);
  w.gn2 = (float*)take(sizeof(float) * 2 * batch * parts * n);
  w.amax = (float*)take(sizeof(float) * 2 * batch);
  w.a = take(act_bytes * m * (cin > n ? cin : n));
  w.xs = xs ? take(2 * m * xs) : nullptr;
  w.xq_off = off;
  w.xq = sx ? (int8_t*)take(m * sx) : nullptr;
  w.partial = splits > 1 ? (float*)take(sizeof(float) * splits * m * n) : nullptr;
  w.bytes = off;
  return w;
}

}  // namespace

// The pre-pass of one conv input: int8 through quantize8's scales q when
// q is non-null, else bf16. Counted where it launches.
int prepass_launch(const void* xa, const void* xb, int ca, int cb, bool f32, int batch, int hw,
                   const float* scale, const float* shift, int silu_on, const Int8Args* q,
                   void* out, cudaStream_t st) {
  if (ca % 8 || cb % 8) return (int)cudaErrorInvalidValue;
  const int err = q != nullptr ? prepass_run(xa, xb, ca, cb, f32, batch, hw, scale, shift,
                                             silu_on, *q, (int8_t*)out, st)
                               : prepass_run(xa, xb, ca, cb, f32, batch, hw, scale, shift,
                                             silu_on, Int8Args{}, (bf16*)out, st);
  if (!err) count_launch(q != nullptr ? COUNT_PREPASS_S8 : COUNT_PREPASS_BF16);
  return err;
}

int f32_prepass_launch(const float* xa, const float* xb, int ca, int cb, int batch, int hw,
                       const float* scale, const float* shift, void* a, void* raw,
                       cudaStream_t st) {
  if (ca % 8 || cb % 8) return (int)cudaErrorInvalidValue;
  const long vecs = (long)batch * hw * (ca + cb) / 8;
  prepass_kernel<float, bf16><<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(
      xa, xb, ca, cb, vecs, hw, scale, shift, 1, Int8Args{}, (bf16*)a, (bf16*)raw);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_PREPASS_BF16);
  return err;
}

int gn2_train_prepass_launch(const float* u, const float* part, int parts, int groups,
                             const float* gamma, const float* beta, float eps,
                             const int8_t* mask, float inv_keep, int batch, int hw, int n,
                             float* scale, float* shift, float* mean, float* rstd, void* d,
                             cudaStream_t st) {
  if (groups > GN_MAX_GROUPS || n % groups || n % 8) return (int)cudaErrorInvalidValue;
  const GnFold f = {part, parts, groups, gamma, beta, eps};
  const GnTrain t = {mask, inv_keep, scale, shift, mean, rstd};
  gn_prepass_kernel<bf16, true><<<dim3(gn_prepass_chunks(batch, hw, n), batch), 256,
                                  fold_smem(n), st>>>(u, n, hw, f, batch, Int8Args{}, (bf16*)d, t);
  const int err = (int)cudaGetLastError();
  if (!err) {
    count_launch(COUNT_PREPASS_BF16);
    count_launch(COUNT_GN2_PREPASS);
  }
  return err;
}

int gn_stats_launch(const void* xa, const void* xb, int ca, int cb, int batch, int hw,
                    int groups, const float* gamma, const float* beta, float eps, float* scale,
                    float* shift, float* mean, float* rstd, bool f32, cudaStream_t stream) {
  const int c = ca + cb;
  if (ca % 8 || cb % 8 || c < 8 || c > GN_MAX_C || groups < 1 || c % groups)
    return (int)cudaErrorInvalidValue;
  const int lanes = THREADS_GN / (c / 8);
  const size_t smem = sizeof(float) * (2 * (size_t)lanes * c + 2 * c);
  const dim3 grid(GN_CTAS, batch);
  if (f32)
    gn_stats_kernel<float><<<grid, THREADS_GN, smem, stream>>>(
        (const float*)xa, (const float*)xb, ca, cb, hw, groups, gamma, beta, eps, scale, shift,
        mean, rstd);
  else
    gn_stats_kernel<bf16><<<grid, THREADS_GN, smem, stream>>>(
        (const bf16*)xa, (const bf16*)xb, ca, cb, hw, groups, gamma, beta, eps, scale, shift,
        mean, rstd);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_GN_STATS);
  return err;
}

int amax_launch(const void* xa, const void* xb, int ca, int cb, int batch, int hw,
                const float* scale, const float* shift, int silu_on, float* amax, bool f32,
                cudaStream_t stream) {
  const int err = (int)cudaMemsetAsync(amax, 0, sizeof(float) * batch, stream);
  if (err) return err;
  // about four 8-value vectors a thread, at most 64 blocks a sample
  const long vecs = (long)hw * (ca + cb) / 8;
  long chunks = (vecs + 4 * THREADS_GN - 1) / (4 * THREADS_GN);
  if (chunks > 64) chunks = 64;
  const dim3 grid((unsigned)chunks, batch);
  if (f32)
    amax_kernel<float><<<grid, THREADS_GN, 0, stream>>>((const float*)xa, (const float*)xb, ca, cb,
                                                        hw, scale, shift, silu_on, amax);
  else
    amax_kernel<bf16><<<grid, THREADS_GN, 0, stream>>>((const bf16*)xa, (const bf16*)xb, ca, cb, hw,
                                                       scale, shift, silu_on, amax);
  return (int)cudaGetLastError();
}

int resblock_gemm_run(bool int8, const void* x0, const void* x1, int c0, int c1, bool x_f32,
                      bool out_f32, bool x_q8, int gn_ctas, const float* amax1,
                      const void* temb_row, int temb_ld, const void* gn1_g,
                      const void* gn1_b, int groups1, const void* w1, const void* w1s,
                      const void* b1, const void* gn2_g, const void* gn2_b, int groups2,
                      const void* w2, const void* w2s, const void* b2, const void* s0,
                      const void* s1, int cs0, int cs1, const void* ws, const void* bs,
                      const void* act_scales, int batch, int h, int w_, int n, float eps,
                      float out_scale, void* work, const GemmTiles& tiles, int splits1, int kper1,
                      int splits2, int kper2, bool train, const int8_t* mask, float inv_keep,
                      void* out, cudaStream_t st, const StaticSkip& sk) {
  const int hw = h * w_;
  const int cin = c0 + c1;
  const bool gn1 = groups1 > 0;
  // f32 activations of the bf16 mode: x0, x1 and the skip parts f32, made
  // bf16 by the pre-passes (with GN1 the skip parts are conv1's input)
  const bool f32_act = !int8 && x_f32;
  // the bf16 mode: conv1 reads bf16 x0 as it is without GN1 (one part);
  // f32 x writes f32 out; x_q8: the int8 mode's static scale, no GN1;
  // gn_ctas: bf16 x with GN1; train: f32 x (K6)
  if ((!int8 && ((x_f32 && !out_f32) || (!gn1 && x1 != nullptr))) || (int8 && out_f32) ||
      (x_q8 && (!int8 || gn1 || x_f32 || act_scales == nullptr)) ||
      (gn_ctas && (!gn1 || x_f32)) || (train && !f32_act) ||
      (f32_act && gn1 && s0 != nullptr && (s0 != x0 || s1 != x1 || cs0 != c0 || cs1 != c1)))
    return (int)cudaErrorInvalidValue;
  const bool static_skip = sk.wss != nullptr;
  if (static_skip && (!int8 || act_scales == nullptr || s0 == nullptr || (sk.q8 && s1 != nullptr)))
    return (int)cudaErrorInvalidValue;
  // the static skip's q(x): K9's s0 as it is; GN1's one launch writes it
  // beside a1 where the skip input is GN1's input (K2, K3); else a pre-pass
  const bool xq_gn1 = static_skip && !sk.q8 && gn_ctas && s0 == x0 && s1 == x1;
  const WorkGemm wk = carve_gemm((char*)work, batch, (long)batch * hw, cin, n,
                                 splits1 > splits2 ? splits1 : splits2, tiles.tiles_h,
                                 int8 ? 1 : 2, f32_act && s0 ? cs0 + cs1 : 0,
                                 static_skip && !sk.q8 ? cs0 + cs1 : 0);
  const float* qs = (const float*)act_scales;
  const float* am1 = amax1 ? amax1 : wk.amax;
  const void* xq = static_skip && !sk.q8 ? wk.xq : s0;
  int err = 0;
  if (static_skip && !sk.q8 && !xq_gn1) {  // q(x) = clip(rint(x * (1/sx))) of x as stored
    const Int8Args q = {qs + 2, nullptr, 0};
    err = prepass_launch(s0, s1, cs0, cs1, false, batch, hw, nullptr, nullptr, 0, &q, wk.xq, st);
  }
  // conv1's operand: x0 as it is (bf16 without GN1: K4's and K9's h; K9's
  // q(h) with x_q8), else a1 = silu(GN1(x)) in bf16 (f32 x without GN1:
  // bf16(h)), or q(a1) (the pair's a * (127 / amax)), made once into the
  // workspace
  const void* a1 = x0;
  if (gn_ctas) {  // GN1's statistics (and the per-sample amax) and a1 in one launch
    GnApply g1 = {};
    g1.xa = x0;
    g1.xb = x1;
    g1.ca = c0;
    g1.cb = c1;
    g1.batch = batch;
    g1.h = h;
    g1.w = w_;
    g1.groups = groups1;
    g1.gamma = (const float*)gn1_g;
    g1.beta = (const float*)gn1_b;
    g1.eps = eps;
    g1.silu = 1;
    g1.int8 = int8;
    g1.q = Int8Args{qs, nullptr, x1 != nullptr};
    g1.out = wk.a;
    g1.amax_out = int8 && qs == nullptr ? wk.amax : nullptr;
    if (xq_gn1) {
      g1.xr = wk.xq;
      g1.qsx = qs + 2;
    }
    g1.ctas = gn_ctas;
    err = gn_apply_launch(g1, st);
    a1 = wk.a;
  } else {
    if (gn1)
      err = gn_stats_launch(x0, x1, c0, c1, batch, hw, groups1, (const float*)gn1_g,
                            (const float*)gn1_b, eps, wk.sc1, wk.sh1, nullptr, nullptr, x_f32, st);
    if (!err && int8 && qs == nullptr && amax1 == nullptr)
      err = amax_launch(x0, x1, c0, c1, batch, hw, gn1 ? wk.sc1 : nullptr,
                        gn1 ? wk.sh1 : nullptr, gn1 ? 1 : 0, wk.amax, x_f32, st);
    if (!err && f32_act && gn1 && s0 != nullptr) {  // a1 and the skip's bf16 x in one read
      err = f32_prepass_launch((const float*)x0, (const float*)x1, c0, c1, batch, hw, wk.sc1,
                               wk.sh1, wk.a, wk.xs, st);
      a1 = wk.a;
    } else if (!err && (int8 || gn1 || x_f32) && !x_q8) {
      const Int8Args q = {qs, am1, x1 != nullptr};
      err = prepass_launch(x0, x1, c0, c1, x_f32, batch, hw, gn1 ? wk.sc1 : nullptr,
                           gn1 ? wk.sh1 : nullptr, gn1 ? 1 : 0, int8 ? &q : nullptr, wk.a, st);
      a1 = wk.a;
    }
    if (!err && f32_act && !gn1 && s0 != nullptr)  // K4 on f32: the skip's bf16 x_skip
      err = prepass_launch(s0, s1, cs0, cs1, true, batch, hw, nullptr, nullptr, 0, nullptr,
                           wk.xs, st);
  }
  BlockGemm g = {};
  g.int8 = int8;
  g.taps = 9;
  g.B = batch;
  g.H = h;
  g.W = w_;
  g.N = n;
  g.partial = wk.partial;
  g.train = train;
  if (!err) {  // h1 = conv1(a1) [* (w1s * s1)] + b1 + temb, f32, and GN2's partial sums
    g.a = a1;
    g.w = w1;
    g.cin = cin;
    g.wsc = (const float*)w1s;
    g.qs = qs;
    g.amax = am1;
    g.bias = (const float*)b1;
    g.temb = (const float*)temb_row;
    g.temb_ld = temb_ld;
    g.out_scale = 1.0f;
    g.out = wk.h1;
    g.out_f32 = true;
    g.gn_part = wk.gn2;
    g.splits = splits1;
    g.kper = kper1;
    err = block_gemm_launch(g, tiles, st);
  }
  // a2 = silu(GN2(h1)) in bf16 (train: times mask / keep), or q(a2), over
  // conv1's input, which conv1 has read
  if (!err && train)
    err = gn2_train_prepass_launch(wk.h1, wk.gn2, tiles.tiles_h, groups2, (const float*)gn2_g,
                                   (const float*)gn2_b, eps, mask, inv_keep, batch, hw, n,
                                   nullptr, nullptr, nullptr, nullptr, wk.a, st);
  else if (!err) {
    const GnFold f = {wk.gn2, tiles.tiles_h, groups2, (const float*)gn2_g, (const float*)gn2_b,
                      eps};
    err = gn2_prepass_run(int8, wk.h1, f, batch, hw, n, qs ? qs + 1 : nullptr, wk.sc2, wk.sh2,
                          wk.amax + batch, wk.a, st);
  }
  if (!err) {  // out = (conv2(a2) [* (w2s * s2)] + skip + b2 + b_skip) * out_scale
    g.a = wk.a;
    g.w = w2;
    g.cin = n;
    // f32 activations: one bf16 copy; the static skip: q(x), its int8 slices
    g.s0 = static_skip ? xq : f32_act ? wk.xs : s0;
    g.s1 = static_skip || f32_act ? nullptr : s1;
    g.cs0 = f32_act || static_skip ? cs0 + cs1 : cs0;
    g.cs1 = f32_act || static_skip ? 0 : cs1;
    g.ws = ws;
    g.wss = sk.wss;
    g.sx = static_skip ? qs + 2 : nullptr;
    g.wsc = (const float*)w2s;
    g.qs = qs ? qs + 1 : nullptr;
    g.amax = wk.amax + batch;
    g.bias = (const float*)b2;
    g.bias2 = (const float*)bs;
    g.temb = nullptr;
    g.resid = s0 ? nullptr : x0;  // the identity residual of out's type
    g.out_scale = out_scale;
    g.out = out;
    g.out_f32 = out_f32;
    g.gn_part = nullptr;
    g.splits = splits2;
    g.kper = kper2;
    err = block_gemm_launch(g, tiles, st);
  }
  return err;
}

extern "C" {

// sx: the skip's channels with the static skip (ws int8), else 0
long long gddim_resblock_int8_workspace(int batch, int h, int w, int cin, int n, int splits,
                                        int parts, int sx) {
  return (long long)carve_gemm(nullptr, batch, (long)batch * h * w, cin, n, splits, parts, 1, 0,
                               sx)
      .bytes;
}

// The byte offset in gddim_resblock_int8's workspace (arguments as
// gddim_resblock_int8_workspace, sx > 0) of the static skip's int8 input
// q(x) (M, sx), which holds its values after the launch, so that a caller
// may check them; -1 without sx.
long long gddim_resblock_int8_xq_offset(int batch, int h, int w, int cin, int n, int splits,
                                        int parts, int sx) {
  if (sx <= 0) return -1;
  return (long long)carve_gemm(nullptr, batch, (long)batch * h * w, cin, n, splits, parts, 1, 0,
                               sx)
      .xq_off;
}

// The int8 mode of K2 / K3 / K4 (arguments as gddim_resblock, with the
// convs' int8 weights w1q/w2q K-major (N, 9 * Cin), as pack_int8_weight
// makes them, and their per-output-channel scales w1s/w2s). act_scales: the
// static scales [s1, s2] (a device array), or null for per-sample scales;
// x1 non-null (the pair) quantizes conv1's input as a * (127 / amax). The
// skip (ws, bs) is bf16, or with wss non-null the static skip (StaticSkip):
// act_scales [s1, s2, sx], ws int8 K-major (N, cs0 + cs1), wss its (N,)
// scales; its (cs0 + cs1) / 128 K slices join conv2's last split. The tile
// plan (ops/resblock.py:s8_tile_plan): the convs' M tiling (mw, box_h,
// box_b, tiles_h, m_tiles), shared by both, and each conv's split of K
// (conv2's over its conv slices alone with the static skip). Scratch:
// gddim_resblock_int8_workspace bytes (sx: cs0 + cs1 with the static skip).
int gddim_resblock_int8(const void* x0, const void* x1, int c0, int c1, const void* temb_row,
                        int temb_ld, const void* gn1_g, const void* gn1_b, int groups1,
                        const void* w1q, const void* w1s, const void* b1, const void* gn2_g,
                        const void* gn2_b, int groups2, const void* w2q, const void* w2s,
                        const void* b2, const void* s0, const void* s1, int cs0, int cs1,
                        const void* ws, const void* bs, const void* wss,
                        const void* act_scales, int batch, int h, int w_, int n, float eps,
                        float out_scale, void* work, int mw, int box_h, int box_b, int tiles_h,
                        int m_tiles, int splits1, int kper1, int splits2, int kper2, int gn_ctas,
                        void* out, void* stream) {
  const StaticSkip sk = {(const float*)wss, false};
  return resblock_gemm_run(true, x0, x1, c0, c1, false, false, false, gn_ctas, nullptr,
                           temb_row, temb_ld, gn1_g, gn1_b, groups1, w1q, w1s, b1, gn2_g, gn2_b,
                           groups2, w2q, w2s, b2, s0, s1, cs0, cs1, ws, bs, act_scales, batch, h,
                           w_, n, eps, out_scale, work,
                           GemmTiles{mw, box_h, box_b, tiles_h, m_tiles}, splits1, kper1,
                           splits2, kper2, false, nullptr, 1.0f, out, (cudaStream_t)stream, sk);
}

// The int8 block's quantize pre-pass alone: out (B, H, W, ca+cb) int8 from
// the logical concat (xa, xb) (f32 with act_f32, else bf16), through the
// per-(sample, channel) affine (scale, shift; none when null) and SiLU
// (silu, with the affine only), then quantized by the static scale *qs or
// per sample by amax (B,) (inv_mul: a * (127 / amax)).
int gddim_s8_prepass(const void* xa, const void* xb, int ca, int cb, int act_f32, int batch,
                     int hw, const void* scale, const void* shift, int silu_on, const void* qs,
                     const void* amax, int inv_mul, void* out, void* stream) {
  const Int8Args q = {(const float*)qs, (const float*)amax, inv_mul};
  return prepass_launch(xa, xb, ca, cb, act_f32 != 0, batch, hw, (const float*)scale,
                        (const float*)shift, silu_on, &q, out, (cudaStream_t)stream);
}

// The bf16 block's pre-pass alone: out (B, H, W, ca+cb) bf16 = the logical
// concat (xa, xb) (f32 with act_f32, else bf16) through the per-(sample,
// channel) affine (scale, shift; none when null) and SiLU (silu, with the
// affine only), in f32, rounded once.
int gddim_bf16_prepass(const void* xa, const void* xb, int ca, int cb, int act_f32, int batch,
                       int hw, const void* scale, const void* shift, int silu_on, void* out,
                       void* stream) {
  return prepass_launch(xa, xb, ca, cb, act_f32 != 0, batch, hw, (const float*)scale,
                        (const float*)shift, silu_on, nullptr, out, (cudaStream_t)stream);
}

// The GroupNorm statistics kernel alone (gn_stats_launch): the logical
// concat (xa, xb) (B, hw, ca+cb), f32 with act_f32, else bf16, to the
// per-(sample, channel) affine scale, shift (B, C) and, when mean is
// non-null, mean and rstd (B, groups), all f32.
int gddim_gn_stats(const void* xa, const void* xb, int ca, int cb, int act_f32, int batch, int hw,
                   int groups, const void* gamma, const void* beta, float eps, void* scale,
                   void* shift, void* mean, void* rstd, void* stream) {
  return gn_stats_launch(xa, xb, ca, cb, batch, hw, groups, (const float*)gamma,
                         (const float*)beta, eps, (float*)scale, (float*)shift, (float*)mean,
                         (float*)rstd, act_f32 != 0, (cudaStream_t)stream);
}

// xs: the skip's channels on f32 activations (the bf16 copy it reads), else 0
long long gddim_resblock_workspace(int batch, int h, int w, int cin, int n, int splits,
                                   int parts, int xs) {
  return (long long)carve_gemm(nullptr, batch, (long)batch * h * w, cin, n, splits, parts, 2, xs)
      .bytes;
}

// GN2's folding pre-pass alone (gn_prepass_kernel, as the blocks launch it):
// f32 h1 (B, hw, n) and conv1's partial sums part (2, B, parts, n) -> out
// (B, hw, n): mode 0 bf16, 1 int8 by the static scale *qs, 2 the training
// blocks' d (bf16, times mask / keep when mask is set) with the fold written
// to scale, shift (B, n) and mean, rstd (B, groups) when scale is set. With
// fold_only, the fold alone (gn_fold_kernel, one CTA a sample) into scale,
// shift: out untouched.
int gddim_gn2_prepass(const void* h1, const void* part, int parts, int groups, const void* gamma,
                      const void* beta, float eps, int mode, const void* qs, const void* mask,
                      float inv_keep, int batch, int hw, int n, int fold_only, void* out,
                      void* scale, void* shift, void* mean, void* rstd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (groups < 1 || groups > GN_MAX_GROUPS || n % groups || n % 8 || mode < 0 || mode > 2 ||
      (mode == 1) != (qs != nullptr) || (mode != 2 && mask) ||
      (fold_only && (scale == nullptr || shift == nullptr)))
    return (int)cudaErrorInvalidValue;
  const GnFold f = {(const float*)part, parts, groups, (const float*)gamma, (const float*)beta, eps};
  const float* x = (const float*)h1;
  if (fold_only) {
    gn_fold_kernel<<<batch, THREADS_GN, fold_smem(n), st>>>(f, batch, n, hw, (float*)scale,
                                                           (float*)shift);
    return (int)cudaGetLastError();
  }
  if (mode < 2) return gn2_prepass_run(mode == 1, x, f, batch, hw, n, (const float*)qs, nullptr,
                                       nullptr, nullptr, out, st);
  return gn2_train_prepass_launch(x, (const float*)part, parts, groups, (const float*)gamma,
                                  (const float*)beta, eps, (const int8_t*)mask, inv_keep, batch,
                                  hw, n, (float*)scale, (float*)shift, (float*)mean, (float*)rstd,
                                  out, st);
}

// K2 (x0, identity or 1x1 skip on x0), K3 (x0 and x1 as the logical concat)
// or K4 (groups1 = 0: no GN1 on the conv1 input; the skip reads s0) through
// the bf16 pre-passes and the block GEMM: h1 f32, the conv operands bf16;
// the activations (x0, x1, s0, s1) and out bf16, or f32 with act_f32 (then
// the skip parts are x0, x1 where GN1 runs, and gn_ctas is 0). temb_row:
// the block's (B, N) f32 temb projection, row b at temb_row + b * temb_ld.
// The tile plan (ops/resblock.py: bf16_tile_plan) as gddim_resblock_int8
// takes it. Scratch comes from `work`, gddim_resblock_workspace bytes
// (parts: the plan's tiles_h; xs: cs0 + cs1 with act_f32).
int gddim_resblock(const void* x0, const void* x1, int c0, int c1, int act_f32,
                   const void* temb_row, int temb_ld, const void* gn1_g, const void* gn1_b,
                   int groups1, const void* w1, const void* b1, const void* gn2_g,
                   const void* gn2_b, int groups2, const void* w2, const void* b2, const void* s0,
                   const void* s1, int cs0, int cs1, const void* ws, const void* bs, int batch,
                   int h, int w_, int n, float eps, float out_scale, void* work, int mw,
                   int box_h, int box_b, int tiles_h, int m_tiles, int splits1, int kper1,
                   int splits2, int kper2, int gn_ctas, void* out, void* stream) {
  return resblock_gemm_run(false, x0, x1, c0, c1, act_f32 != 0, act_f32 != 0, false, gn_ctas,
                           nullptr, temb_row, temb_ld, gn1_g, gn1_b, groups1, w1, nullptr, b1,
                           gn2_g, gn2_b, groups2, w2, nullptr, b2, s0, s1, cs0, cs1, ws, bs,
                           nullptr, batch, h, w_, n, eps, out_scale, work,
                           GemmTiles{mw, box_h, box_b, tiles_h, m_tiles}, splits1, kper1,
                           splits2, kper2, false, nullptr, 1.0f, out, (cudaStream_t)stream);
}

// K6: the training forward of one stride-1 block, f32 x and out: the f32
// block's chain (gddim_resblock with act_f32) with the dropout mask in GN2's
// folding pre-pass (d = bf16(silu(GN2(h1)) * mask / keep)) and the GEMMs
// counted as the training blocks'. temb_row (B, N) f32 is the precomputed
// temb projection; ws == null: identity skip; mask (B, H, W, N) int8 or null
// (no dropout). The tile plan (ops/resblock.py:bf16_tile_plan, shared M
// tiling, each conv's split of K) as gddim_resblock takes it. Scratch:
// gddim_resblock_workspace bytes (xs: c with a 1x1 skip, else 0).
int gddim_resblock_train(const void* x, int c, const void* temb_row, const void* gn1_g,
                         const void* gn1_b, int groups1, const void* w1, const void* b1,
                         const void* gn2_g, const void* gn2_b, int groups2, const void* w2,
                         const void* b2, const void* ws, const void* bs, const void* mask,
                         float inv_keep, int batch, int h, int w_, int n, float eps,
                         float out_scale, void* work, int mw, int box_h, int box_b, int tiles_h,
                         int m_tiles, int splits1, int kper1, int splits2, int kper2, void* out,
                         void* stream) {
  const bool skip = ws != nullptr;
  return resblock_gemm_run(false, x, nullptr, c, 0, true, true, false, 0, nullptr, temb_row, n,
                           gn1_g, gn1_b, groups1, w1, nullptr, b1, gn2_g, gn2_b, groups2, w2,
                           nullptr, b2, skip ? x : nullptr, nullptr, skip ? c : 0, 0, ws, bs,
                           nullptr, batch, h, w_, n, eps, out_scale, work,
                           GemmTiles{mw, box_h, box_b, tiles_h, m_tiles}, splits1, kper1,
                           splits2, kper2, true, (const int8_t*)mask, inv_keep, out,
                           (cudaStream_t)stream);
}

}  // extern "C"
