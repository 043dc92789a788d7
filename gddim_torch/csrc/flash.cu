// Single-head attention for Hopper (sm_90a): o = softmax(q k^T / sqrt(C)) v
// over (B, S, C), f32 or bf16, with the (S, S) scores never written to
// device memory.
//
// Replaces the whole-sequence kernel of gddim_tpu/ops/flash.py:
// flash_attention (K8), _attn_kernel_single, which the TPU wrapper takes for
// S <= 1024. The two kernels here keep a query's whole row of scores on chip
// for every S they take (S <= 1024, ops/attention.py:flash_plan): in
// registers (flash_reg_kernel, bf16, S a multiple of 64 up to 256) or in
// shared memory (flash_kernel, the rest). The k-blocked online-softmax
// kernel that the TPU wrapper takes for S > 1024 (_attn_kernel_blocked) is
// flash_online.cu's. The training path calls K8 on f32 q/k/v (S = 256 and
// 16, C = 256), the layer-wise sampling paths on bf16 q/k/v.
//
// Rounding points, both modes as the plain version (ops/attention.py:
// attention_xla) and the TPU kernel's whole-sequence branch: s = (q . k) *
// C^-0.5 with f32 sums, f32 softmax statistics, the weights w = exp(s - m) / l
// normalised first and then (bf16 mode) rounded to bf16 before w . v, f32
// sums, the output rounded once to its type. (flash_online.cu follows the
// blocked branch's instead: the unnormalised weights rounded, one division
// at the end.)
// flash_reg_kernel takes exp as __expf and the division as a product with
// the row's rounded reciprocal: a few f32 ulps before the bf16 rounding.
//
// Arithmetic on the tensor cores:
// - bf16: mma.sync m16n8k16 bf16 x bf16 -> f32 for q k^T and w v; bf16
//   products are exact in f32, so only the summation order differs from the
//   plain version.
// - f32: 3xTF32 on mma.sync m16n8k8: each f32 operand splits into hi =
//   tf32(x) and lo = tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi,
//   f32 accumulate, which keeps it within f32 summation-order noise of the
//   f32 plain version (plain TF32 would cost about three decimal digits).
//   The tensor cores' f32 sums do not round to nearest and their error grows
//   with the sum they add to (measured 2.0e-5 of max|o| at S = 2048 with one
//   running sum), so each 32 channels of q k^T and each 32-key tile of w v
//   is a partial sum of its own, added to the running sum in f32.
//
// flash_kernel: one CTA per (sample, QT queries), 8 warps; QT = 16, 32 or 64
// (the QT/16 row groups of 16 rows) from ops/attention.py:flash_plan. The q
// tile sits in shared memory; k tiles, then v tiles, of KT keys stream
// through two cp.async buffers (rows padded by 16 bytes, so ldmatrix and the
// fragment loads hit distinct banks). Pass 1: each warp takes one row group
// and a share of the tile's keys, and writes scaled scores into a (QT, S)
// f32 buffer. Then the row statistics (max, sum of exp) with 256/QT threads
// a row, which overwrite the scores with the normalised weights (one exp a
// score). Pass 2: each warp takes one row group and a share of the C output
// columns and accumulates w v in registers over the v tiles.
// flash_reg_kernel: see its note below.
//
// What bounds it on the H100: 4*S*C operations a query against 4*C*size
// bytes of q, k, v and o, so at S = 256 the bf16 mode is near the ridge
// (about 295 operations a byte) and the f32 mode (3 TF32 products a product
// at 495 TFLOP/s) above it; at S = 16 the bytes bound both. The design keeps
// the scores out of device memory and reads q, k and v once a CTA (k and v
// from L2 for the S/QT CTAs of one sample).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int FL_THREADS = 256;
constexpr int FL_WARPS = 8;
constexpr int FL_SMEM_MAX = 232448;  // 227 KB, the most a block may have
constexpr int F32_CHUNK = 32;        // f32 mode: channels of one tensor-core partial sum

template <bool BF16>
struct Mode {
  using T = float;
  static constexpr int KT = 32;   // keys per tile
  static constexpr int PAD = 4;   // row padding, elements
  static constexpr int KSTEP = 8; // mma K depth
};
template <>
struct Mode<true> {
  using T = __nv_bfloat16;
  static constexpr int KT = 64;
  static constexpr int PAD = 8;
  static constexpr int KSTEP = 16;
};

__host__ __device__ constexpr int fl_smem(bool bf16, int c, int qt, int s) {
  const int sz = bf16 ? 2 : 4, ldt = c + (bf16 ? 8 : 4), kt = bf16 ? 64 : 32;
  return qt * ldt * sz + 2 * kt * ldt * sz + qt * (s + 4) * 4 + 2 * qt * 4;
}

// grid (S / QT, B), FL_THREADS threads, fl_smem(BF16, C, QT, S) bytes.
template <bool BF16, int C, int QT>
__global__ void __launch_bounds__(FL_THREADS)
flash_kernel(const typename Mode<BF16>::T* __restrict__ q,
             const typename Mode<BF16>::T* __restrict__ k,
             const typename Mode<BF16>::T* __restrict__ v, typename Mode<BF16>::T* __restrict__ o,
             int S, float scale) {
  using T = typename Mode<BF16>::T;
  constexpr int KT = Mode<BF16>::KT, LDT = C + Mode<BF16>::PAD, KSTEP = Mode<BF16>::KSTEP;
  constexpr int RG = QT / 16;           // row groups of 16 queries
  constexpr int KS = FL_WARPS / RG;     // warps a row group: key share (pass 1), columns (pass 2)
  constexpr int NT8 = KT / 8;           // n8 key tiles of a tile
  constexpr int NPW = NT8 / KS > 0 ? NT8 / KS : 1;  // of them a warp's, pass 1
  constexpr int CPW = C / KS;           // output columns a warp's, pass 2
  constexpr int CHUNKS = C * (int)sizeof(T) / 16;  // 16-byte chunks of a row
  static_assert(CPW % 8 == 0, "a warp's columns are whole n8 tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KVs = Qs + QT * LDT;  // two buffers of KT rows
  float* Ss = reinterpret_cast<float*>(KVs + 2 * KT * LDT);  // (QT, S + 4)
  const int LDS = S + 4;
  float* row_m = Ss + QT * LDS;
  float* row_l = row_m + QT;

  const int b = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp % RG, share = warp / RG;
  const long base = (long)b * S * C;
  const int ntiles = (S + KT - 1) / KT;

  auto load_tile = [&](int i) {
    const T* src = (i < ntiles ? k : v) + base;
    const int key0 = (i < ntiles ? i : i - ntiles) * KT;
    T* dst = KVs + (i & 1) * KT * LDT;
    for (int x = tid; x < KT * CHUNKS; x += FL_THREADS) {
      const int r = x / CHUNKS, ch = x % CHUNKS;
      const bool ok = key0 + r < S;
      cp_async16(reinterpret_cast<unsigned char*>(dst + r * LDT) + 16 * ch,
                 reinterpret_cast<const unsigned char*>(src + (long)(ok ? key0 + r : 0) * C) +
                     16 * ch,
                 ok);
    }
  };

  for (int x = tid; x < QT * CHUNKS; x += FL_THREADS) {
    const int r = x / CHUNKS, ch = x % CHUNKS;
    cp_async16(reinterpret_cast<unsigned char*>(Qs + r * LDT) + 16 * ch,
               reinterpret_cast<const unsigned char*>(q + base + (long)(q0 + r) * C) + 16 * ch,
               true);
  }
  load_tile(0);
  asm volatile("cp.async.commit_group;" ::: "memory");

  float acc_o[CPW / 8][4];
#pragma unroll
  for (int j = 0; j < CPW / 8; ++j) acc_o[j][0] = acc_o[j][1] = acc_o[j][2] = acc_o[j][3] = 0.f;

  const T* Qw = Qs + rg * 16 * LDT;
  for (int i = 0; i < 2 * ntiles; ++i) {
    if (i + 1 < 2 * ntiles) {
      load_tile(i + 1);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const T* tile = KVs + (i & 1) * KT * LDT;

    if (i == ntiles) {
      // the row statistics; the scores become the normalised weights
      constexpr int TPR = FL_THREADS / QT;
      float* srow = Ss + (tid / TPR) * LDS;
      float m = -INFINITY;
      for (int j = tid % TPR; j < S; j += TPR) m = fmaxf(m, srow[j]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.f;
      for (int j = tid % TPR; j < S; j += TPR) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        l += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      for (int j = tid % TPR; j < S; j += TPR) srow[j] = __fdiv_rn(srow[j], l);
      if (tid % TPR == 0) {
        row_m[tid / TPR] = m;
        row_l[tid / TPR] = l;
      }
      __syncthreads();
    }

    if (i < ntiles) {
      // pass 1: this warp's n8 key tiles of the row group's scores
      const int key0 = i * KT, j0 = share * NPW;
      if (j0 < NT8 && key0 + 8 * j0 < S) {
        float acc[NPW][4];
#pragma unroll
        for (int j = 0; j < NPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        if constexpr (BF16) {
#pragma unroll 4
          for (int kc = 0; kc < C; kc += KSTEP) {
            uint32_t a[4];
            ldsm_x4(a, Qw + (lane & 15) * LDT + kc + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < NPW; ++j) {
              uint32_t bb[2];
              ldsm_x2(bb, tile + (8 * (j0 + j) + (lane & 7)) * LDT + kc + ((lane >> 3) & 1) * 8);
              mma_bf16(acc[j], a, bb);
            }
          }
        } else {
          // 32 channels a partial sum on the tensor cores, added to the
          // running sum in f32 (the tensor cores' sums are not rounded to
          // nearest, and their error grows with the sum they add to)
          for (int kc0 = 0; kc0 < C; kc0 += F32_CHUNK) {
            float part[NPW][4];
#pragma unroll
            for (int j = 0; j < NPW; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
            for (int kc = kc0; kc < kc0 + F32_CHUNK; kc += KSTEP) {
              uint32_t ah[4], al[4];
              split(Qw[g * LDT + kc + t4], ah[0], al[0]);
              split(Qw[(g + 8) * LDT + kc + t4], ah[1], al[1]);
              split(Qw[g * LDT + kc + t4 + 4], ah[2], al[2]);
              split(Qw[(g + 8) * LDT + kc + t4 + 4], ah[3], al[3]);
#pragma unroll
              for (int j = 0; j < NPW; ++j) {
                const T* kr = tile + (8 * (j0 + j) + g) * LDT + kc + t4;
                uint32_t bh[2], bl[2];
                split(kr[0], bh[0], bl[0]);
                split(kr[4], bh[1], bl[1]);
                mma_3xtf32(part[j], ah, al, bh, bl);
              }
            }
#pragma unroll
            for (int j = 0; j < NPW; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
          }
        }
        // accumulator: [0..1] row g, [2..3] row g + 8; columns 2 t4, 2 t4 + 1
        float* s0 = Ss + (rg * 16 + g) * LDS + key0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          if (key0 + 8 * (j0 + j) >= S) continue;
          *reinterpret_cast<float2*>(s0 + 8 * (j0 + j)) =
              make_float2(acc[j][0] * scale, acc[j][1] * scale);
          *reinterpret_cast<float2*>(s0 + 8 * LDS + 8 * (j0 + j)) =
              make_float2(acc[j][2] * scale, acc[j][3] * scale);
        }
      }
    } else {
      // pass 2: acc_o += w v over this tile's keys, this warp's columns
      const int key0 = (i - ntiles) * KT, n0 = share * CPW;
      const float* w0 = Ss + (rg * 16 + g) * LDS;
      if constexpr (BF16) {
#pragma unroll 2
        for (int kk = 0; kk < KT; kk += KSTEP) {
          if (key0 + kk >= S) break;
          const int kg = key0 + kk;
          uint32_t a[4];
          const float2 w00 = *reinterpret_cast<const float2*>(w0 + kg + 2 * t4);
          const float2 w10 = *reinterpret_cast<const float2*>(w0 + 8 * LDS + kg + 2 * t4);
          const float2 w01 = *reinterpret_cast<const float2*>(w0 + kg + 8 + 2 * t4);
          const float2 w11 = *reinterpret_cast<const float2*>(w0 + 8 * LDS + kg + 8 + 2 * t4);
          a[0] = pack_bf16(w00.x, w00.y);
          a[1] = pack_bf16(w10.x, w10.y);
          a[2] = pack_bf16(w01.x, w01.y);
          a[3] = pack_bf16(w11.x, w11.y);
#pragma unroll
          for (int j = 0; j < CPW / 8; ++j) {
            uint32_t bb[2];
            ldsm_x2_trans(bb, tile + (kk + (lane & 15)) * LDT + n0 + 8 * j);
            mma_bf16(acc_o[j], a, bb);
          }
        }
      } else {
        // the tile's keys a partial sum on the tensor cores, added in f32
        float part[CPW / 8][4];
#pragma unroll
        for (int j = 0; j < CPW / 8; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; kk += KSTEP) {
          if (key0 + kk >= S) break;
          const int kg = key0 + kk;
          uint32_t ah[4], al[4];
          split(w0[kg + t4], ah[0], al[0]);
          split(w0[8 * LDS + kg + t4], ah[1], al[1]);
          split(w0[kg + t4 + 4], ah[2], al[2]);
          split(w0[8 * LDS + kg + t4 + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < CPW / 8; ++j) {
            const T* vr = tile + (kk + t4) * LDT + n0 + 8 * j + g;
            uint32_t bh[2], bl[2];
            split(vr[0], bh[0], bl[0]);
            split(vr[4 * LDT], bh[1], bl[1]);
            mma_3xtf32(part[j], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < CPW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_o[j][e] += part[j][e];
      }
    }
    __syncthreads();  // this buffer is refilled next iteration
  }

  // the output: rows g and g + 8 of the row group, columns 2 t4, 2 t4 + 1 of each n8 tile
  T* o0 = o + base + (long)(q0 + rg * 16 + g) * C + share * CPW + 2 * t4;
#pragma unroll
  for (int j = 0; j < CPW / 8; ++j) {
    if constexpr (BF16) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(acc_o[j][0], acc_o[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * C + 8 * j) =
          __floats2bfloat162_rn(acc_o[j][2], acc_o[j][3]);
    } else {
      *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(acc_o[j][0], acc_o[j][1]);
      *reinterpret_cast<float2*>(o0 + 8 * C + 8 * j) = make_float2(acc_o[j][2], acc_o[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, 64 <= S <= 256 (S a multiple of 64): the whole row of scores in
// registers. A CTA is 4 warps and 64 queries (16 a warp). Each warp's q k^T
// accumulators for all S keys (S/8 n8 tiles) stay in registers, the row
// statistics come from quad shuffles, and the normalised weights, rounded to
// bf16, are packed in place into the A fragments of w v (an m16n8k16
// accumulator pair of n8 tiles is an A fragment's layout), so no score leaves
// the registers. k tiles, then v tiles, of 32 keys stream through a 4-stage
// cp.async ring, three tiles ahead. (Measured on the H100 at B = 16 and 64,
// S = C = 256: 8 warps and 128 queries a CTA, or the output's columns cut
// into 2 parts that repeat q k^T for twice the CTAs, were no faster.)
// ---------------------------------------------------------------------------

constexpr int REG_SMAX = 256;  // the longest row this kernel holds
constexpr int REG_KT = 32;     // keys a k or v tile
constexpr int REG_STAGES = 4;
constexpr int REG_QT = 64;     // queries a CTA: 4 warps of 16

__host__ __device__ constexpr int reg_smem(int c) {
  return (REG_QT + REG_STAGES * REG_KT) * (c + 8) * 2;
}

// grid (S / 64, B), 128 threads, reg_smem(C) bytes.
template <int C>
__global__ void __launch_bounds__(128, 2)
flash_reg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                 float scale) {
  using T = __nv_bfloat16;
  constexpr int LDT = C + 8;          // padded row
  constexpr int NT = REG_SMAX / 8;    // n8 score tiles of the longest row
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KVs = Qs + REG_QT * LDT;  // REG_STAGES tiles of REG_KT rows

  const int b = blockIdx.y, q0 = blockIdx.x * REG_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long base = (long)b * S * C;
  const int nkt = S / REG_KT, ntiles = 2 * nkt;

  // tile i: k rows [32 i, 32 i + 32) for i < nkt, else those rows of v
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const T* src = (i < nkt ? k : v) + base + (long)(i < nkt ? i : i - nkt) * REG_KT * C;
      T* dst = KVs + (i % REG_STAGES) * REG_KT * LDT;
      for (int x = tid; x < REG_KT * (C / 8); x += 128) {
        const int r = x / (C / 8), ch = x % (C / 8);
        cp_async16(dst + r * LDT + 8 * ch, src + (long)r * C + 8 * ch, true);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");  // empty past the end: uniform counts
  };
  // tile i has landed and every thread sees it; tile i + 3 is on its way
  // into the buffer tile i - 1 left (the previous step ended on a barrier)
  auto next = [&](int i) {
    load_tile(i + REG_STAGES - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(REG_STAGES - 1) : "memory");
    __syncthreads();
  };

  for (int x = tid; x < REG_QT * (C / 8); x += 128) {
    const int r = x / (C / 8), ch = x % (C / 8);
    cp_async16(Qs + r * LDT + 8 * ch, q + base + (long)(q0 + r) * C + 8 * ch, true);
  }
  for (int i = 0; i < REG_STAGES - 1; ++i) load_tile(i);  // Q rides with tile 0's group

  // q k^T: sc[j] holds keys 8 j + 2 t4 (+1) of rows g ([0], [1]) and g + 8 ([2], [3])
  float sc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  const T* Qw = Qs + warp * 16 * LDT;
#pragma unroll
  for (int kt = 0; kt < REG_SMAX / REG_KT; ++kt) {
    if (kt >= nkt) break;
    next(kt);
    const T* tile = KVs + (kt % REG_STAGES) * REG_KT * LDT;
#pragma unroll 4
    for (int kc = 0; kc < C; kc += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qw + (lane & 15) * LDT + kc + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < REG_KT / 8; j += 2) {
        // two n8 key tiles: matrices (keys 8j.., ch kc), (8j.., kc+8), (8j+8.., kc), (8j+8.., kc+8)
        uint32_t bb[4];
        ldsm_x4(bb, tile + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * LDT + kc +
                        ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        mma_bf16(sc[kt * (REG_KT / 8) + j], a, b0);
        mma_bf16(sc[kt * (REG_KT / 8) + j + 1], a, b1);
      }
    }
    __syncthreads();  // this buffer is refilled next
  }

  // softmax of rows g (h = 0) and g + 8 (h = 1): max and sum over the quad
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j >= S) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] *= scale;
      m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j >= S) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = __expf(sc[j][e] - m[e >> 1]);
      l[e >> 1] += sc[j][e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // the weights, normalised and rounded to bf16, as A fragments of w v:
  // keys 16 kk.. are tiles 2 kk (a0 row g, a1 row g + 8) and 2 kk + 1 (a2, a3)
  const float r0 = __frcp_rn(l[0]), r1 = __frcp_rn(l[1]);
  uint32_t pw[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (16 * kk >= S) break;
    pw[kk][0] = pack_bf16(sc[2 * kk][0] * r0, sc[2 * kk][1] * r0);
    pw[kk][1] = pack_bf16(sc[2 * kk][2] * r1, sc[2 * kk][3] * r1);
    pw[kk][2] = pack_bf16(sc[2 * kk + 1][0] * r0, sc[2 * kk + 1][1] * r0);
    pw[kk][3] = pack_bf16(sc[2 * kk + 1][2] * r1, sc[2 * kk + 1][3] * r1);
  }

  // w v over the v tiles
  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < REG_SMAX / REG_KT; ++kt) {
    if (kt >= nkt) break;
    next(nkt + kt);
    const T* tile = KVs + ((nkt + kt) % REG_STAGES) * REG_KT * LDT;
#pragma unroll
    for (int kk = 0; kk < REG_KT / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < C / 8; j += 2) {
        // two n8 column tiles: matrices (keys 16kk.., ch 8j), (16kk+8.., 8j), (16kk.., 8j+8), (16kk+8.., 8j+8)
        uint32_t bb[4];
        ldsm_x4_trans(bb, tile + (16 * kk + (lane & 15)) * LDT + 8 * j + ((lane >> 4) << 3));
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        mma_bf16(acc[j], pw[kt * (REG_KT / 16) + kk], b0);
        mma_bf16(acc[j + 1], pw[kt * (REG_KT / 16) + kk], b1);
      }
    }
    __syncthreads();
  }

  T* o0 = o + base + (long)(q0 + warp * 16 + g) * C + 2 * t4;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * C + 8 * j) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int C>
int run_reg(const void* q, const void* k, const void* v, void* o, int batch, int s, float scale,
            cudaStream_t st) {
  constexpr int smem = reg_smem(C);
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(
        flash_reg_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr = true;
  }
  flash_reg_kernel<C><<<dim3(s / REG_QT, batch), 128, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, s, scale);
  return (int)cudaGetLastError();
}

template <bool BF16, int C, int QT>
int run(const void* q, const void* k, const void* v, void* o, int batch, int s, float scale,
        cudaStream_t st) {
  using T = typename Mode<BF16>::T;
  const int smem = fl_smem(BF16, C, QT, s);
  if (smem > FL_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the attribute is raised to the largest S seen so far
  static int granted = 48 * 1024;
  if (smem > granted) {
    const int err = (int)cudaFuncSetAttribute(
        flash_kernel<BF16, C, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, FL_SMEM_MAX);
    if (err) return err;
    granted = FL_SMEM_MAX;
  }
  flash_kernel<BF16, C, QT><<<dim3(s / QT, batch), FL_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s, scale);
  return (int)cudaGetLastError();
}

template <bool BF16, int C>
int run_c(const void* q, const void* k, const void* v, void* o, int batch, int s, int qt,
          float scale, cudaStream_t st) {
  switch (qt) {
    case 16: return run<BF16, C, 16>(q, k, v, o, batch, s, scale, st);
    case 32: return run<BF16, C, 32>(q, k, v, o, batch, s, scale, st);
    case 64: return run<BF16, C, 64>(q, k, v, o, batch, s, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool BF16>
int run_mode(const void* q, const void* k, const void* v, void* o, int batch, int s, int c,
             int qt, float scale, cudaStream_t st) {
  // the row in registers: qt is 64 there
  const bool reg = BF16 && s % REG_QT == 0 && s <= REG_SMAX;
  if (reg && qt != REG_QT) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 64: return reg ? run_reg<64>(q, k, v, o, batch, s, scale, st)
                        : run_c<BF16, 64>(q, k, v, o, batch, s, qt, scale, st);
    case 128: return reg ? run_reg<128>(q, k, v, o, batch, s, scale, st)
                         : run_c<BF16, 128>(q, k, v, o, batch, s, qt, scale, st);
    case 256: return reg ? run_reg<256>(q, k, v, o, batch, s, scale, st)
                         : run_c<BF16, 256>(q, k, v, o, batch, s, qt, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K8: q, k, v, o (B, S, C) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); S a
// multiple of 16, C in {64, 128, 256}; scale = C^-0.5. The query tile qt
// (ops/attention.py:flash_plan): 64 for bf16 with S a multiple of 64 up to
// 256, which takes flash_reg_kernel; else 16, 32 or 64, dividing S, for
// flash_kernel.
int gddim_flash_attention(const void* q, const void* k, const void* v, void* o, int batch, int s,
                          int c, int qt, int bf16, float scale, void* stream) {
  if (s % 16 != 0 || qt <= 0 || s % qt != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? run_mode<true>(q, k, v, o, batch, s, c, qt, scale, st)
              : run_mode<false>(q, k, v, o, batch, s, c, qt, scale, st);
}

}  // extern "C"
