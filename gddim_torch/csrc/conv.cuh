// Shared interface of the block GEMM, its pre-passes and the GroupNorm
// statistics (defined in resblock.cu, block_gemm.cu and gn_apply.cu), used
// by attnblock.cu, resblock_bwd.cu and transition.cu.
//
// Activations are bf16 (inference, K2-K5) or f32 (training, K6/K7, and
// K2-K5/K9 on f32 activations); the tensor-core operands are bf16 with f32
// accumulation either way, or int8 with int32 accumulation in the int8 mode
// of K2-K5. The block GEMM (block_gemm.cu) runs the 3x3 convs of every
// block (K2-K4, K9; bf16, int8 and on f32 activations), K5's 1x1
// projections (K10's forward too), and the training blocks' convs and
// dgrads (K6, K7), whose weight gradients run on wgrad_kernel
// (resblock_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Scratch carving: every buffer starts on a 256-byte boundary.
inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// Sum of v over a block of 256 threads (red: 32 floats of shared memory);
// every thread gets the total.
__device__ inline float block_sum256(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < 8 ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// The activation scales of an int8 pre-pass (quantize8, resblock.cu).
struct Int8Args {
  const float* qs;    // static mode: the activation scale s (one device float), or null
  const float* amax;  // dynamic mode: (B,) per-sample amax of the quantized activation
  int inv_mul;        // dynamic: q = a * (127 / amax) (the pair's conv1) instead of a / (amax / 127)
};

// The M tiling of the block GEMM (block_gemm.cu), from the tile plan
// (ops/resblock.py:bf16_tile_plan, s8_tile_plan): tiles of 128 * mw output
// pixels, each one TMA box of W pixels x box_h rows x box_b samples;
// tiles_h tiles per sample group along H, m_tiles in all.
struct GemmTiles {
  int mw, box_h, box_b, tiles_h, m_tiles;
};

// One conv of the block GEMM (block_gemm.cu): a 3x3 SAME conv (taps 9) or a
// 1x1 (taps 1) of the pre-pass's activation, bf16 by HWIO bf16 weights (f32
// sums), or int8 by
// K-major int8 weights (int32 sums dequantized in place), then an optional
// bf16 1x1 skip into the same f32 accumulators, then the epilogue (w_kmajor:
// a dgrad, bf16 weights read K-major and tap-reversed, f32 out, no skip):
//   out = (conv(a, w) [* (wsc[n] * s)] + skip + bias + bias2 + temb[b] + resid) * out_scale
// s = *qs (static), asc[b] (K11 int8: the given per-sample scale), else
// max(amax[b], 1e-12) / 127 of the row's sample b. With wss (the int8
// blocks' static skip, int8 bf16 out): s0 the skip input quantized by sx,
// (M, cs0) int8, ws its K-major (N, cs0) int8 weights, bias2 b_skip, and
//   out = (((conv(a, w) * (wsc[n] * s) + bias) + 0) + ((f32(q(x) ws) * (wss[n] * sx)
//          + bias2) + 0)) * out_scale
// the skip's int32 sums converted once (in the last split where K splits).
// With gn_part, the epilogue (or the split-K reduction) also writes each
// output channel's sum and sum of squares over every (M tile, sample in the
// tile): gn_part (2, B, tiles_h, N), [0] the sums, [1] the squares, row
// (b, t) from tile row t of sample b (GN2's statistics of conv1's h1, folded
// by group in a fixed order by the next pre-pass: no float atomics).
struct BlockGemm {
  bool int8;        // the int8 mode, else bf16
  const void* a;    // (B, H, W, cin) bf16 or int8
  const void* w;    // bf16: (taps * cin, N) HWIO flattened; int8: (N, taps * cin), K-major;
                    // w_kmajor: (taps * N, cin), the forward HWIO weights of the dgrad
  bool w_kmajor;
  int cin;
  int taps;         // 9: 3x3 SAME, 1: 1x1
  const void* s0;   // skip inputs (M, cs0) and (M, cs1) bf16 (wss: int8), or s0 null: no skip
  const void* s1;
  int cs0, cs1;
  const void* ws;   // (cs0 + cs1, N) bf16 (wss: (N, cs0) int8, K-major)
  const float* wss;  // the static skip's (N,) weight scales, or null
  const float* sx;   // the static skip's scale (one device float)
  int B, H, W, N;
  const float* wsc;   // int8: (N,) weight scales
  const float* qs;    // int8: static activation scale (one device float), or null
  const float* amax;  // int8: (B,) per-sample amax when qs is null
  const float* asc;   // int8: (B,) per-sample scales (K11 int8: bf16 out, no skip; K split
                      // into int32 partials), or null
  const float* bias;  // (N,) or null, likewise bias2
  const float* bias2;
  const float* temb;   // (B, N) row added per sample (row b at temb + b * temb_ld), or null
  int temb_ld;
  const void* resid;   // (M, N) identity residual of out's type (bf16, or f32), or null
  float out_scale;
  void* out;  // (M, N) f32 (out_f32) or bf16
  bool out_f32;
  float* gn_part;  // (2, B, tiles_h, N) per-channel sums and squares of out, or null
  float* partial;  // (splits, M, N) f32 (dequantized) split-K partials, when splits > 1
  int splits, kper;  // K slices (128 bytes a pixel) per split
  bool train;        // a training block's GEMM (counted as COUNT_GEMM_TRAIN, as dgrads are)
};

// block_gemm_kernel (+ block_splitk_kernel when g.splits > 1). Returns
// cudaError_t (cudaErrorInvalidValue for a plan or shape it does not take,
// or a tensor map that does not encode).
int block_gemm_launch(const BlockGemm& g, const GemmTiles& t, cudaStream_t stream);

// Kernels launched inside a block's C call, counted where they are launched
// (one each time the launch succeeds; gddim_block_launches reads the counts):
// the block GEMM and the pre-pass, int8 and bf16 (the bf16 pre-passes: the
// block pre-pass, GN2's folding pre-pass, K7's rounding of the cotangent),
// K5's attention core, the GroupNorm statistics kernel, the GN1 kernel
// (gn_apply.cu, both variants), K7's weight-gradient kernel, K1's GroupNorm
// kernel (groupnorm.cu), the block GEMM's launches in the training blocks
// (K6, K7) apart from the bf16 ones of the sampling path, K7's GroupNorm
// backward (resblock_bwd.cu), GN2's folding pre-pass (gn_prepass_kernel,
// every mode; counted as its mode's pre-pass too), K8's online-softmax
// kernels (flash_online.cu's f32 and flash_online_wgmma.cu's bf16 form),
// the int8 blocks' conv2 GEMMs that carry the static skip (counted as the
// int8 GEMM too), and the f32 online kernel's split pre-pass
// (online_split_kernel).
enum Counted {
  COUNT_GEMM_S8 = 0,
  COUNT_PREPASS_S8 = 1,
  COUNT_GEMM_BF16 = 2,
  COUNT_PREPASS_BF16 = 3,
  COUNT_ATTN = 4,
  COUNT_GN_STATS = 5,
  COUNT_GN_APPLY = 6,
  COUNT_WGRAD = 7,
  COUNT_GN_SILU = 8,
  COUNT_GEMM_TRAIN = 9,
  COUNT_GN_BWD = 10,
  COUNT_GN2_PREPASS = 11,
  COUNT_FLASH_ONLINE = 12,
  COUNT_STATIC_SKIP = 13,
  COUNT_ONLINE_SPLIT = 14,
  N_COUNTED = 15
};
void count_launch(Counted kernel);

// The int8 blocks' static skip projection (act_scales [s1, s2, sx], the
// TPU kernels' static_skip): the skip input (s0, s1) quantized by sx into
// the workspace's q(x) (M, cs0 + cs1) int8 (by GN1's gn_apply_kernel, which
// holds the input, or by a pre-pass), or (q8) s0 quantized already (K9's
// resampled x); its 1x1 by the int8 skip weights ws (K-major (N, cs0 +
// cs1)) runs as int8 K slices of conv2's block GEMM (BlockGemm's wss),
// f32(int32 sums) * (wss[n] * sx) + b_skip.
struct StaticSkip {
  const float* wss;  // (N,) the skip weights' scales; null: no static skip
  bool q8;
};

// One residual block on the block GEMM (gddim_resblock's and
// gddim_resblock_int8's arguments, in order), int8 or bf16: conv1's input
// x0 f32 (x_f32; the int8 mode: no x1; the bf16 mode: the block's
// activations x0, x1, s0, s1 f32, with out_f32), bf16, or (x_q8: int8 mode,
// no GN1) conv1's int8 operand already quantized by the static scale; and,
// when amax1 is non-null, the per-sample amax of conv1's input already made
// (int8 dynamic scales only). out_f32: out and the identity residual x0 f32
// (the bf16 mode only). gn_ctas: GN1 through gn_apply_kernel in clusters of
// that many CTAs a sample (its statistics, the amax and the pre-pass in one
// launch; bf16 x only), or 0: gn_stats_kernel, amax_kernel and the
// pre-pass. temb_row: the block's (B, N) f32 temb projection, row b at
// temb_row + b * temb_ld. The bf16 mode takes no w1s, w2s, act_scales;
// with groups1 = 0 its conv1 reads bf16 x0 as it is (K4 and K9: h holds
// silu(GN1(x)) already; f32 x0 through a pre-pass). train (K6: f32
// activations): GN2's pre-pass applies the dropout mask (or none) and
// 1/keep, and the GEMMs count as the training blocks'. sk: the int8 mode's
// static skip (below). Scratch: carve_gemm (gddim_resblock_workspace,
// gddim_resblock_int8_workspace).
int resblock_gemm_run(bool int8, const void* x0, const void* x1, int c0, int c1, bool x_f32,
                      bool out_f32, bool x_q8, int gn_ctas, const float* amax1,
                      const void* temb_row, int temb_ld, const void* gn1_g, const void* gn1_b,
                      int groups1, const void* w1, const void* w1s, const void* b1,
                      const void* gn2_g, const void* gn2_b, int groups2, const void* w2,
                      const void* w2s, const void* b2, const void* s0, const void* s1, int cs0,
                      int cs1, const void* ws, const void* bs, const void* act_scales, int batch,
                      int h, int w_, int n, float eps, float out_scale, void* work,
                      const GemmTiles& tiles, int splits1, int kper1, int splits2, int kper2,
                      bool train, const int8_t* mask, float inv_keep, void* out,
                      cudaStream_t st, const StaticSkip& sk = StaticSkip{});

// The block GEMM's pre-pass (resblock.cu): the logical concat (xa, xb) of
// one conv's input (f32 or bf16) through the per-(sample, channel) affine
// (scale, shift; none when null) and SiLU (silu_on), written once NHWC to
// out as int8 by quantize8's scales q when q is non-null, else bf16.
// Counted where it launches.
int prepass_launch(const void* xa, const void* xb, int ca, int cb, bool f32, int batch, int hw,
                   const float* scale, const float* shift, int silu_on, const Int8Args* q,
                   void* out, cudaStream_t st);

// The f32 blocks' pre-pass (resblock.cu): a = bf16(silu(x * scale +
// shift)) of the logical concat (xa, xb) of f32 x (B, hw, ca+cb), a1 of the
// blocks on f32 activations, K6's and K7's, and with raw non-null bf16(x)
// beside it (the 1x1 skip's operand). Counted as the bf16 pre-pass.
int f32_prepass_launch(const float* xa, const float* xb, int ca, int cb, int batch, int hw,
                       const float* scale, const float* shift, void* a, void* raw,
                       cudaStream_t st);

// GN2 of a training block from conv1's partial sums (gn_part of its tile
// plan, `parts` rows a sample), the folding pre-pass: d = bf16(silu(GN2(u))
// * mask / keep) (mask (B, hw, n) int8, or null), and with scale non-null
// the affine (B, n) and mean, rstd (B, groups) written out (K7's GN2
// backward). Counted as the bf16 pre-pass.
int gn2_train_prepass_launch(const float* u, const float* part, int parts, int groups,
                             const float* gamma, const float* beta, float eps,
                             const int8_t* mask, float inv_keep, int batch, int hw, int n,
                             float* scale, float* shift, float* mean, float* rstd, void* d,
                             cudaStream_t st);

// amax[b] = max |f(x)| over sample b of the logical concat (xa, xb), f the
// per-(sample, channel) affine (scale, shift; none when null) and SiLU when
// silu is set. Zeroes amax first.
int amax_launch(const void* xa, const void* xb, int ca, int cb, int batch, int hw,
                const float* scale, const float* shift, int silu, float* amax, bool f32,
                cudaStream_t stream);

// Per-(sample, group) GroupNorm statistics of the logical concat (xa, xb)
// (gn_stats_kernel, resblock.cu: one pass, E[x^2] - mean^2 from per-channel
// f32 sums), folded with gamma/beta into a per-(sample, channel) affine
// (scale, shift); mean and rstd per (sample, group) too when those pointers
// are non-null. Counted where it launches.
int gn_stats_launch(const void* xa, const void* xb, int ca, int cb, int batch, int hw,
                    int groups, const float* gamma, const float* beta, float eps, float* scale,
                    float* shift, float* mean, float* rstd, bool f32, cudaStream_t stream);

// The phase coefficients of K9's factor-2 resample (transition_kerns in
// ops/resblock.py), per axis, H carrying the up gain: see axis_taps (act.cuh).
struct Taps {
  float h[4], w[4];
};

// One launch of gn_apply_kernel (gn_apply.cu): GroupNorm statistics of one
// sample a cluster of `ctas` CTAs, and their consumer from the sample held
// in shared memory. bf16 x only (f32 activations keep gn_stats_kernel).
//   convert (resample 0): the logical concat (xa, xb) (B, h*w, ca+cb)
//     through the affine (+SiLU), written NHWC to out as the pre-pass writes
//     it: bf16 (q null) or int8 by quantize8's scales q (static qs, or per
//     sample: the kernel takes the amax of the activated sample itself, in
//     the cluster, and writes it to amax_out and its scale max(amax, 1e-12)
//     / 127 to qs_out, each where non-null); with unfold (K12, per-sample
//     int8), the affine unfolded as the TPU kernel's group_norm_silu_quant
//     computes it, ((x - mean) * rstd) * gamma + beta; with qsx (the int8
//     blocks' static skip, static int8 out), also the concat itself
//     quantized by *qsx into xr (B, h*w, ca+cb) int8, the skip's q(x);
//   resample (resample 1, xb null, h x w the input): K9's silu(GN1(x))
//     rounded to bf16 once, resampled by the taps k (up or down) into out
//     (out_type 0 bf16, 1 f32 with its per-sample amax into amax_out when
//     non-null, 2 int8 by the static scale q.qs), and bf16(x) resampled
//     into xr.
// scale, shift (B, C) and mean, rstd (B, groups): the affine and the
// statistics, written when non-null.
struct GnApply {
  const void* xa;
  const void* xb;
  int ca, cb;
  int batch, h, w;
  int groups;
  const float* gamma;
  const float* beta;
  float eps;
  int silu;
  int int8;       // convert: int8 out by q, else bf16
  Int8Args q;
  int resample;   // 0 convert, 1 resample
  int up;
  int out_type;   // resample: 0 bf16, 1 f32, 2 int8
  Taps k;
  void* out;
  void* xr;          // resample: the resampled x, bf16, or int8 by *qsx when qsx is set;
                     // convert with qsx: q(x) int8
  const float* qsx;  // the static skip scale sx, or null
  float* amax_out;
  float* qs_out;
  int unfold;
  float* scale;
  float* shift;
  float* mean;
  float* rstd;
  int ctas;       // 8 (GN_APPLY_CTAS); the C entries take 0 for the two launches
};

// gn_apply_kernel on a.ctas CTAs a sample; cudaErrorInvalidValue for a
// shape or cluster it does not take (see ops/resblock.py:gn_apply_ctas,
// gn_resample_ctas). Counted where it launches.
int gn_apply_launch(const GnApply& a, cudaStream_t stream);
