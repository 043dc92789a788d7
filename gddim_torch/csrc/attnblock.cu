// The fused attention block (K5) for Hopper (sm_90a): its attention core,
// and the C calls that run the whole block.
//
// Replaces gddim_tpu/ops/attnblock.py:fused_attnblock (_attnblock_kernel):
//   h = GN(x); [q|k|v] = h @ [Wq|Wk|Wv] + b; a = softmax(q k^T / sqrt(C)) v;
//   out = (x + a @ Wo + bo) * out_scale
// with mm_dtype bf16 (gddim_attnblock: bf16 x and out) or int8
// (gddim_attnblock_int8: the projections int8 with static or per-sample
// activation scales, the attention products bf16). On f32 activations
// (K5 on f32 x, and K10, the training forward) gddim_attnblock reads and
// writes f32 x and out with the same bf16 operands, as the TPU kernel with
// mm_dtype bf16.
//
// gddim_attnblock, four launches, all hand-written:
//   gn_apply_launch (gn_apply.cu)   h = GN(x) rounded to bf16 once (the TPU
//                                   kernel's h_all.astype(bf16)), its
//                                   statistics from the same read of x (or,
//                                   route 0 and f32 x: gn_stats_launch,
//                                   then the pre-pass, resblock.cu)
//   block_gemm_launch (block_gemm.cu, taps 1)
//                                   [q|k|v] = h @ [Wq|Wk|Wv] + b, bf16, one
//                                   N = 3C GEMM over M = B*S pixels
//   attention_wgmma_kernel (here)   a = softmax(q k^T / sqrt(C)) v, bf16
//   block_gemm_launch (taps 1)      out = (a @ Wo + bo + x) * out_scale
//                                   (f32 x: f32 residual and out)
// gddim_attnblock_int8 quantizes h in the same GN launch (static s_h, or per
// sample by the cluster's amax of GN(x)), runs both projections on the int8
// block GEMM (K-major int8 weights, dequantized by w_scale * s in the
// epilogue), and the core writes a as the output projection reads it:
// static scales quantize it in the core's epilogue, clip(rint(a * (1/s_a)))
// from the f32 sums as the TPU kernel does; per-sample scales need the
// sample's amax of a first, so the core writes f32 a and folds its max |a|
// into amax[b] (atomicMax of the bit patterns of non-negative floats: the
// result does not depend on the order), then an int8 pre-pass quantizes it.
//
// The core, attention_wgmma_kernel<STAGES, MASKED, MODE>: a CTA of one
// consumer warpgroup and one producer warp takes 64 query rows. TMA brings
// the q tile (64 rows x C channels, 64-channel boxes with the 128-byte
// swizzle), then K and then V of the rows' sample in slices of 64 keys
// through a ring of full/empty mbarriers: K and V are read once per CTA, a
// box at a time, and never sit in shared memory whole. Grids of a wave of
// CTAs and more take a ring of 2 slices and two CTAs an SM (one CTA's
// softmax overlaps the other's products); smaller grids a ring of 4, all of
// a sample's K in flight at once (ops/attnblock.py:core_plan).
// - q k^T: wgmma m64n64k16 per key slice, K the K-major B operand; the
//   whole 64 x S f32 score row stays in the accumulator registers (S <= 256,
//   four slices of 32 registers a thread). Each sum starts with its first
//   product (the wgmma's scale-d off), so no other instruction writes the
//   accumulators inside a pipeline stage, which would serialize the wgmmas.
// - The softmax in registers in the TPU kernel's order and rounding points
//   (attnblock.py:123-134): logits = sums * C^-1/2 in f32, minus the row
//   max, exp, divided by the row sum, and only then rounded to bf16 -- not
//   an online softmax with a late normalisation, which would move the
//   rounding point. The row's values sit on the four lanes of a quad.
// - p (bf16) goes to shared memory over the q tile, in the layout TMA would
//   have written (128-byte swizzle), and feeds p v as the A operand from
//   shared memory; V is the N-major B operand through the transpose bit, as
//   the block GEMM reads HWIO weights.
// - The epilogue writes a from the registers: bf16, int8 (static s_a), or
//   f32 with the per-sample amax.
// S below 64 (MASKED; the 4x4 block, S = 16): a CTA takes 64 rows of 64 / S
// samples and its one key slice is the same 64 rows; scores across samples
// are masked before the softmax, so each row sees its own sample's keys.
//
// What bounds it on the H100: at S = 256, C = 256 the core does 4 S^2 C =
// 67 MFLOP a sample against 384 KB of q, k, v read and 128 KB of a written
// (bf16): ~175 operations a byte, under the bf16 ridge (~295), so the
// bytes bound it; K and V are read by each of a sample's CTAs from L2. The
// projections are GEMMs of 768 and 256 output channels over K = 256: at
// B=64 (M = 16384) tensor-core bound on the block GEMM. At B=4 and at S=16
// every launch is a few microseconds of latency. The design answers the
// bytes with one read of q, k, v per CTA and a written once, and the
// operations with wgmma at the bf16 rate fed by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_C = 256;
constexpr int MAX_S = 256;
constexpr int BOX_BYTES = 64 * 128;  // a TMA box of qkv: 64 channels x 64 rows, 8 KB
constexpr int SLICE_BYTES = (MAX_C / 64) * BOX_BYTES;  // 64 keys of K or V: 32 KB
constexpr int QP_BYTES = 4 * BOX_BYTES;  // a warpgroup's q tile, then its p tile: 32 KB

// how the core writes a: bf16, int8 by the static s_a, or f32 with the
// per-sample amax
enum AMode { A_BF16 = 0, A_S8 = 1, A_F32 = 2 };

constexpr int ATT_THREADS = 160;  // the consumer warpgroup, then the producer warp

// shared memory of a CTA with a ring of STAGES slices: the q/p tile, the
// ring, 1 KB to align to the swizzle's atom, the barriers
template <int STAGES>
constexpr int attn_smem() {
  return QP_BYTES + STAGES * SLICE_BYTES + 1024 + (2 * STAGES + 1) * 8;
}

static_assert(attn_smem<4>() <= 227 * 1024, "the deep ring exceeds shared memory");
static_assert(2 * (attn_smem<2>() + 1024) <= 228 * 1024, "two shallow-ring CTAs do not fit an SM");

struct AttnArgs {
  int M, S, C;      // rows (B * S), keys a sample, channels
  float scale;      // C^-1/2
  void* out;        // a, (M, C): bf16, int8 or f32 (MODE)
  const float* qs;  // A_S8: the static s_a (one device float)
  float* amax;      // A_F32: (B,) max |a| of each sample, zeroed before
};

__device__ __forceinline__ int8_t quant8(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -127.0f), 127.0f);  // rintf: half to even
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid ceil(M / 64), ATT_THREADS threads, attn_smem<STAGES>() bytes of
// dynamic shared memory; two CTAs an SM with the shallow ring (STAGES 2, for
// grids of a wave and more), one with the deep ring (STAGES 4: all of a
// sample's K in flight at once, for small grids). MASKED: S < 64, 64 / S
// samples a CTA. Accumulator layout (m64nN): register 4 j + 2 h + e of a
// thread holds row 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane %
// 4) + e.
template <int STAGES, bool MASKED, int MODE>
__global__ void __launch_bounds__(ATT_THREADS, 4 / STAGES)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map, const AttnArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qp = smem_u32(reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)));
  const uint32_t ring = qp + QP_BYTES;
  const uint32_t qbar = ring + STAGES * SLICE_BYTES;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int nc = p.C / 64;          // 64-channel boxes of a row
  const int ns = MASKED ? 1 : p.S / 64;  // key slices
  const int row0 = blockIdx.x * 64;
  const int key0 = MASKED ? row0 : row0 / p.S * p.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: q, then the K slices, then the V slices
    if (lane == 0) {
      mbar_expect_tx(qbar, nc * BOX_BYTES);
      for (int c = 0; c < nc; ++c) tma_load_2d(qp + c * BOX_BYTES, &qkv_map, qbar, 64 * c, row0);
      for (int i = 0; i < 2 * ns; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = ring + s * SLICE_BYTES;
        mbar_expect_tx(full, nc * BOX_BYTES);
        const int part = i < ns ? 1 : 2, j = i < ns ? i : i - ns;
        for (int c = 0; c < nc; ++c)
          tma_load_2d(dst + c * BOX_BYTES, &qkv_map, full, part * p.C + 64 * c, key0 + 64 * j);
      }
    }
    return;
  }

  const int wrow = 16 * warp + (lane >> 2);  // the thread's first row of the CTA's 64
  mbar_wait(qbar, 0);

  // scores: key slice j in sc[j], each sum started by its first product (no
  // zeros written between the wgmmas of a pipeline stage)
  float sc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < ns) {
      const int s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const uint32_t kb = ring + s * SLICE_BYTES;
      wgmma_fence();
      for (int c = 0; c < nc; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // q and K alike: 128-byte rows, a k16 step 32 bytes in
          wgmma_m64n64k16<0>(sc[j], sw128_desc(qp + c * BOX_BYTES + 32 * kk, 16, 1024),
                             sw128_desc(kb + c * BOX_BYTES + 32 * kk, 16, 1024), c | kk);
      wgmma_commit();
      // the previous slice's group has completed: free its stage
      wgmma_wait<1>();
      if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(empty0 + 8 * ((ns - 1) % STAGES));

  // the softmax of each of the thread's two rows, in f32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + 8 * h;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j8 + 2 * (lane & 3) + e;
          const bool key = j < ns && (!MASKED || col / p.S == r / p.S);
          float& v = sc[j][4 * j8 + 2 * h + e];
          v = key ? v * p.scale : -INFINITY;
          mx = fmaxf(mx, v);
        }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // MASKED: the masked keys' exp(-inf) and 0 / sum are 0, written as such
    // to stay off expf's and the IEEE division's slow paths
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float& v = sc[j][4 * (k >> 1) + 2 * h + (k & 1)];
        v = MASKED && v == -INFINITY ? 0.f : expf(v - mx);
        sum += v;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float& v = sc[j][4 * (k >> 1) + 2 * h + (k & 1)];
        v = MASKED && v == 0.f ? 0.f : __fdiv_rn(v, sum);
      }
  }

  // p, rounded to bf16, over the q tile (every q k^T product has completed):
  // slice j's 64 keys as 64 rows of 128 bytes, 16-byte unit u of row r at
  // u ^ (r % 8), the 128-byte swizzle TMA writes
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < ns) {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + 8 * h;
          st_shared_b32(qp + j * BOX_BYTES + r * 128 + ((j8 ^ (r & 7)) << 4) + 4 * (lane & 3),
                        pack_bf16x2(sc[j][4 * j8 + 2 * h], sc[j][4 * j8 + 2 * h + 1]));
        }
    }
  }
  // the generic-proxy stores become visible to wgmma; the warpgroup's own barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, 128;" ::: "memory");

  // a = p v: 64-channel blocks q of the output, V N-major through the transpose bit
  float ao[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < ns) {
      const int i = ns + j, s = i % STAGES;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const uint32_t vb = ring + s * SLICE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(qp + j * BOX_BYTES + 32 * kk, 16, 1024);
#pragma unroll
        for (int q = 0; q < 4; ++q)  // V: 64 key rows of 128 bytes a box, a k16 step 16 rows
          if (q < nc)
            wgmma_m64n64k16<1>(ao[q], da, sw128_desc(vb + q * BOX_BYTES + 2048 * kk, BOX_BYTES, 1024),
                               j | kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % STAGES));
    }
  }
  wgmma_wait<0>();  // the last V slice is never reloaded: no release

  // the epilogue; a warp's 16 rows lie in one sample (S a multiple of 16)
  const int m0 = row0 + wrow;
  const float inv_s = MODE == A_S8 ? 1.0f / *p.qs : 0.f;
  float amax = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nc) continue;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const long o = (long)m * p.C + 64 * q + 8 * j8 + 2 * (lane & 3);
        const float a0 = ao[q][4 * j8 + 2 * h], a1 = ao[q][4 * j8 + 2 * h + 1];
        if constexpr (MODE == A_BF16) {
          *reinterpret_cast<__nv_bfloat162*>((bf16*)p.out + o) = __floats2bfloat162_rn(a0, a1);
        } else if constexpr (MODE == A_S8) {
          *reinterpret_cast<char2*>((int8_t*)p.out + o) =
              make_char2(quant8(a0 * inv_s), quant8(a1 * inv_s));
        } else {
          *reinterpret_cast<float2*>((float*)p.out + o) = make_float2(a0, a1);
          amax = fmaxf(amax, fmaxf(fabsf(a0), fabsf(a1)));
        }
      }
    }
  }
  if constexpr (MODE == A_F32) {
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const int mw = row0 + 16 * warp;  // the warp's first row
    if (lane == 0 && mw < p.M) atomicMax(reinterpret_cast<int*>(p.amax + mw / p.S), __float_as_int(amax));
  }
}

template <int STAGES, bool MASKED, int MODE>
int attn_run(const CUtensorMap& map, const AttnArgs& p, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(attention_wgmma_kernel<STAGES, MASKED, MODE>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              attn_smem<STAGES>());
    if (err) return err;
    attr = true;
  }
  attention_wgmma_kernel<STAGES, MASKED, MODE>
      <<<(unsigned)((p.M + 63) / 64), ATT_THREADS, attn_smem<STAGES>(), st>>>(map, p);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_ATTN);
  return err;
}

template <int STAGES, bool MASKED>
int attn_mode(int mode, const CUtensorMap& map, const AttnArgs& p, cudaStream_t st) {
  if (mode == A_S8) return attn_run<STAGES, MASKED, A_S8>(map, p, st);
  if (mode == A_F32) return attn_run<STAGES, MASKED, A_F32>(map, p, st);
  return attn_run<STAGES, MASKED, A_BF16>(map, p, st);
}

// The core on qkv (B * S, 3C) bf16: a (B * S, C) in `mode`'s type into out.
// stages: the ring's depth, 2 or 4 (ops/attnblock.py:core_plan; S < 64
// takes 4). S a multiple of 64 up to 256, or 16 or 32; C a multiple of 64
// up to 256.
int attn_launch(const bf16* qkv, int batch, int s, int c, int stages, int mode, const float* qs,
                float* amax, void* out, cudaStream_t st) {
  const bool s_ok = s >= 64 ? s % 64 == 0 && s <= MAX_S : (s == 16 || s == 32) && stages == 4;
  if (!s_ok || c % 64 || c < 64 || c > MAX_C || (stages != 2 && stages != 4) || mode < A_BF16 ||
      mode > A_F32 || (mode == A_S8 && qs == nullptr) || (mode == A_F32 && amax == nullptr))
    return (int)cudaErrorInvalidValue;
  AttnArgs p = {batch * s, s, c, 1.0f / sqrtf((float)c), out, qs, amax};
  if (mode == A_F32) {
    const int err = (int)cudaMemsetAsync(amax, 0, sizeof(float) * batch, st);
    if (err) return err;
  }
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)3 * c, (cuuint64_t)batch * s};
  const cuuint64_t strides[1] = {(cuuint64_t)3 * c * 2};
  const cuuint32_t box[2] = {64, 64};
  if (!bf16_map(&map, qkv, 2, dims, strides, box)) return (int)cudaErrorInvalidValue;
  if (s < 64) return attn_mode<4, true>(mode, map, p, st);
  return stages == 2 ? attn_mode<2, false>(mode, map, p, st) : attn_mode<4, false>(mode, map, p, st);
}

// The block's scratch (null base: sizes only), each buffer on 256 bytes:
//   4 B C + 4 B C + 8 B + h_bytes M C + 6 M C + a_bytes M C
//   (+ 12 splits M C when a GEMM splits K)
// h_bytes: an element of h = GN(x), the q/k/v GEMM's operand (2 bf16, 1
// int8); a_bytes: an element
// of a buffer of its own for a (0: a takes h's place, which the q/k/v GEMM
// has read). ops/attnblock.py:workspace_bytes computes the same.
struct Work {
  float* sc;       // (B, C) GN affine
  float* sh;
  float* amax;     // (2, B) int8 per-sample: max |h|, max |a| of each sample
  void* h;         // (M, C) bf16 or int8
  bf16* qkv;       // (M, 3C)
  void* a;         // (M, C) the core's output
  float* partial;  // (splits, M, 3C) split-K partial sums
  size_t bytes;
};

Work carve(char* base, int batch, long m, int c, int h_bytes, int a_bytes, int splits) {
  Work w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  w.sc = (float*)take(sizeof(float) * batch * c);
  w.sh = (float*)take(sizeof(float) * batch * c);
  w.amax = (float*)take(sizeof(float) * 2 * batch);
  w.h = take((size_t)h_bytes * m * c);
  w.qkv = (bf16*)take(sizeof(bf16) * m * 3 * c);
  w.a = a_bytes ? take((size_t)a_bytes * m * c) : w.h;
  w.partial = splits > 1 ? (float*)take(sizeof(float) * splits * m * 3 * c) : nullptr;
  w.bytes = off;
  return w;
}

// One 1x1 projection on the block GEMM: a (B, H, W, cin) by w, bias added,
// K split as ops/attnblock.py plans it; the caller sets the rest.
BlockGemm projection(bool int8, const void* a, const void* w, int batch, int h, int w_, int cin,
                     int n, const void* bias, int splits, int kper, float* partial) {
  BlockGemm g = {};
  g.int8 = int8;
  g.a = a;
  g.w = w;
  g.cin = cin;
  g.taps = 1;
  g.B = batch;
  g.H = h;
  g.W = w_;
  g.N = n;
  g.bias = (const float*)bias;
  g.out_scale = 1.0f;
  g.splits = splits;
  g.kper = kper;
  g.partial = partial;
  return g;
}

// h = GN(x) of x (no SiLU; bf16, or f32 with x_f32) into wk.h: bf16, or
// (int8) int8 by the static scale *qs, or per sample by max |h| into
// wk.amax (qs null); in one launch of gn_apply_kernel on gn_ctas CTAs a
// sample (bf16 x), or (gn_ctas 0) the GN statistics kernel, the amax pass
// (per sample) and the pre-pass.
int gn_h(const void* x, bool x_f32, int groups, const void* gn_g, const void* gn_b, int batch,
         int h, int w, int c, float eps, bool int8, const float* qs, const Work& wk, int gn_ctas,
         cudaStream_t st) {
  if (x_f32 && (gn_ctas || int8)) return (int)cudaErrorInvalidValue;
  const int hw = h * w;
  if (gn_ctas) {
    GnApply a = {};
    a.xa = x;
    a.ca = c;
    a.batch = batch;
    a.h = h;
    a.w = w;
    a.groups = groups;
    a.gamma = (const float*)gn_g;
    a.beta = (const float*)gn_b;
    a.eps = eps;
    a.int8 = int8;
    a.q = Int8Args{qs, nullptr, 0};
    a.out = wk.h;
    a.amax_out = int8 && qs == nullptr ? wk.amax : nullptr;
    a.ctas = gn_ctas;
    return gn_apply_launch(a, st);
  }
  int err = gn_stats_launch(x, nullptr, c, 0, batch, hw, groups, (const float*)gn_g,
                            (const float*)gn_b, eps, wk.sc, wk.sh, nullptr, nullptr, x_f32, st);
  if (!err && int8 && qs == nullptr)
    err = amax_launch(x, nullptr, c, 0, batch, hw, wk.sc, wk.sh, 0, wk.amax, false, st);
  const Int8Args q = {qs, wk.amax, 0};
  if (!err)
    err = prepass_launch(x, nullptr, c, 0, x_f32, batch, hw, wk.sc, wk.sh, 0, int8 ? &q : nullptr,
                         wk.h, st);
  return err;
}

}  // namespace

extern "C" {

// The attention core alone: qkv (B * S, 3C) bf16 -> out (B * S, C), bf16
// (mode 0), int8 by the static scale qs (mode 1), or f32 with each sample's
// max |a| in amax (B,) (mode 2).
int gddim_attention_core(const void* qkv, int batch, int s, int c, int stages, int mode,
                         const void* qs, void* amax, void* out, void* stream) {
  return attn_launch((const bf16*)qkv, batch, s, c, stages, mode, (const float*)qs, (float*)amax,
                     out, (cudaStream_t)stream);
}

// K5 in the bf16 mode: x, out (B, H, W, C) bf16, or f32 with act_f32 (K5 on
// f32 x, K10's forward; then gn_ctas 0); wqkv (C, 3C) and wo (C, C) bf16,
// bqkv (3C,) and bo (C,) f32. The tile plans of the q/k/v GEMM (mw1 ..
// kper1) and the output GEMM (mw2 .. kper2), and the core's ring depth, as
// ops/attnblock.py:block_plan makes them. Scratch `work`: work_bytes
// (ops/attnblock.py:workspace_bytes with h_bytes 2, a_bytes 0).
int gddim_attnblock(const void* x, int act_f32, const void* gn_g, const void* gn_b, int groups,
                    const void* wqkv, const void* bqkv, const void* wo, const void* bo, int batch,
                    int h, int w, int c, float eps, float out_scale, void* work,
                    long long work_bytes, int mw1, int box_h1, int box_b1, int tiles_h1,
                    int m_tiles1, int splits1, int kper1, int mw2, int box_h2, int box_b2,
                    int tiles_h2, int m_tiles2, int splits2, int kper2, int stages, int gn_ctas,
                    void* out, void* stream) {
  const int hw = h * w;
  const Work wk = carve((char*)work, batch, (long)batch * hw, c, 2, 0,
                        splits1 > splits2 ? splits1 : splits2);
  if (wk.bytes > (size_t)work_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = gn_h(x, act_f32 != 0, groups, gn_g, gn_b, batch, h, w, c, eps, false, nullptr, wk,
                 gn_ctas, st);
  if (!err) {
    BlockGemm g = projection(false, wk.h, wqkv, batch, h, w, c, 3 * c, bqkv, splits1, kper1,
                             wk.partial);
    g.out = wk.qkv;
    err = block_gemm_launch(g, GemmTiles{mw1, box_h1, box_b1, tiles_h1, m_tiles1}, st);
  }
  if (!err) err = attn_launch(wk.qkv, batch, hw, c, stages, A_BF16, nullptr, nullptr, wk.a, st);
  if (!err) {
    const GemmTiles t2{mw2, box_h2, box_b2, tiles_h2, m_tiles2};
    BlockGemm g = projection(false, wk.a, wo, batch, h, w, c, c, bo, splits2, kper2, wk.partial);
    g.resid = x;  // of out's type
    g.out_f32 = act_f32 != 0;
    g.out_scale = out_scale;
    g.out = out;
    err = block_gemm_launch(g, t2, st);
  }
  return err;
}

// K5's int8 mode: x, out (B, H, W, C) bf16; wqkv_k (3C, C) and wo_k (C, C)
// int8 K-major (ops/attnblock.py:pack_projection) with their per-output-
// channel scales; act_scales the static [s_h, s_a] (a device array), or
// null for per-sample scales. Plans as gddim_attnblock's. Scratch:
// workspace_bytes with h_bytes 1, a_bytes 0 (static) or 4 (per sample).
int gddim_attnblock_int8(const void* x, const void* gn_g, const void* gn_b, int groups,
                         const void* wqkv_k, const void* wqkv_s, const void* bqkv,
                         const void* wo_k, const void* wo_s, const void* bo,
                         const void* act_scales, int batch, int h, int w, int c, float eps,
                         float out_scale, void* work, long long work_bytes, int mw1, int box_h1,
                         int box_b1, int tiles_h1, int m_tiles1, int splits1, int kper1, int mw2,
                         int box_h2, int box_b2, int tiles_h2, int m_tiles2, int splits2,
                         int kper2, int stages, int gn_ctas, void* out, void* stream) {
  const int hw = h * w;
  const float* qs = (const float*)act_scales;
  const Work wk = carve((char*)work, batch, (long)batch * hw, c, 1, qs ? 0 : 4,
                        splits1 > splits2 ? splits1 : splits2);
  if (wk.bytes > (size_t)work_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // h = q(GN(x)): clip(rint(h * (1/s_h))), or per sample by max |h|
  int err = gn_h(x, false, groups, gn_g, gn_b, batch, h, w, c, eps, true, qs, wk, gn_ctas, st);
  if (!err) {  // [q|k|v] = h8 @ Wqkv8 * (w_scale * s_h) + b, bf16
    const GemmTiles t1{mw1, box_h1, box_b1, tiles_h1, m_tiles1};
    BlockGemm g = projection(true, wk.h, wqkv_k, batch, h, w, c, 3 * c, bqkv, splits1, kper1,
                             wk.partial);
    g.wsc = (const float*)wqkv_s;
    g.qs = qs;
    g.amax = wk.amax;
    g.out = wk.qkv;
    err = block_gemm_launch(g, t1, st);
  }
  // a as the output GEMM reads it: int8 from the core (static), or f32 and
  // its per-sample amax, then the quantize pre-pass into h's place
  if (!err && qs != nullptr)
    err = attn_launch(wk.qkv, batch, hw, c, stages, A_S8, qs + 1, nullptr, wk.h, st);
  if (!err && qs == nullptr) {
    err = attn_launch(wk.qkv, batch, hw, c, stages, A_F32, nullptr, wk.amax + batch, wk.a, st);
    const Int8Args q = {nullptr, wk.amax + batch, 0};
    if (!err)
      err = prepass_launch(wk.a, nullptr, c, 0, true, batch, hw, nullptr, nullptr, 0, &q, wk.h, st);
  }
  if (!err) {  // out = (a8 @ Wo8 * (w_scale * s_a) + bo + x) * out_scale
    const GemmTiles t2{mw2, box_h2, box_b2, tiles_h2, m_tiles2};
    BlockGemm g = projection(true, wk.h, wo_k, batch, h, w, c, c, bo, splits2, kper2, wk.partial);
    g.wsc = (const float*)wo_s;
    g.qs = qs ? qs + 1 : nullptr;
    g.amax = wk.amax + batch;
    g.resid = x;
    g.out_scale = out_scale;
    g.out = out;
    err = block_gemm_launch(g, t2, st);
  }
  return err;
}

}  // extern "C"
