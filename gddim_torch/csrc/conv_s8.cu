// The int8 block GEMM for Hopper (sm_90a): both 3x3 convs of the int8 modes
// of K2, K3, K4 and K9 (conv_impl 'fused_int8'), with conv2's bf16 1x1 skip.
//
// Replaces the conv part of gddim_tpu/ops/resblock.py's int8 kernels
// (_resblock_kernel_v2 and _resblock_kernel for K2 and K4,
// _resblock_pair_kernel(_v2) for K3, _resblock_transition_kernel for K9, all
// with mm_dtype int8): _conv9's nine shifted s8 x s8 -> s32 products on the
// zero-padded quantized tile, the dequantization acc * (w_scale * s), and the
// bf16 skip product with f32 sums. The block around it (temb row, GroupNorm
// statistics, amax, the quantize pre-pass, which writes the int8 activation
// once, in resblock.cu) stays one C call, resblock_int8_run.
//
// conv_s8_wgmma_kernel is an implicit GEMM, M = B*H*W output pixels, N =
// Cout, K = 9 * Cin int8 channels, then Cskip bf16 channels:
// - A by TMA with no im2col and no padded copy: the int8 activation is a
//   4-D tensor map (C, W, H, B) with the 128-byte swizzle; a K slice is 128
//   channels of one tap (128 bytes, the byte geometry of K11's 64 bf16), one
//   box of (128 ch, W, box_h rows, box_b samples) at (x, y) offsets (dx-1,
//   dy-1). The TMA unit writes zeros out of bounds, and a quantized zero is
//   0, so SAME padding costs nothing (the TPU kernels pad the quantized tile
//   with zeros).
// - B by TMA from K-major weights (N, 9 * Cin): 8-bit wgmma takes both
//   operands K-major from shared memory and has no transpose bit, so the
//   model packs the quantized HWIO weights once (ops/resblock.py:
//   pack_int8_weight); one 128 x 128 box a slice.
// - One producer warp keeps a 3-stage (128-pixel tiles, two CTAs an SM) or
//   4-stage (256-pixel tiles) ring of full/empty mbarriers fed; two consumer
//   warpgroups run wgmma.mma_async m64n128k32 s32.s8.s8, four a slice.
// - One accumulator set: the s32 and f32 wgmma accumulators share their
//   register layout, so after the last conv slice each consumer converts its
//   sums in place to f32 * (w_scale[n] * s), s the static scale or the row's
//   own sample's amax / 127 (a tile at 8x8 or 4x4 spans several samples), and
//   the skip slices (64 bf16 channels of s0 or s1 by a 2-D TMA box over the
//   tile's pixels, which are consecutive rows of M; w_skip read N-major
//   through the transpose bit, as K11) run as m64n128k16 f32.bf16.bf16 into
//   the same registers (conv_gemm_s8_kernel keeps an int32 and an f32 set,
//   143 registers, and stages both through shared memory).
// - The epilogue (bias + b_skip, the temb row, the identity residual,
//   out_scale; f32 h1 or bf16 out) runs from the registers.
// - Small grids split K as K11 does: each split writes its dequantized f32
//   partial (conv and skip), and conv_s8_splitk_kernel sums them in split
//   order, so the result does not depend on the run. The tile plan (tile
//   height, box, splits) is a pure function of the shapes, computed in
//   Python (ops/resblock.py:s8_tile_plan); the ring's depth and shared
//   memory follow from the tile height here (S8Tile).
//
// What bounds it on the H100: at 32x32 and 16x16 from B=16 the int8
// products (2*M*9*Cin*N operations at 1,979 TOP/s) and the bytes the conv
// must move (the int8 A, mostly from L2 after the pre-pass, and conv1's f32
// h1 at 4 bytes an output) come within a factor of two of each other: at
// B=64 32x32 128->128 conv1 needs 9.8 us of operations and 12.5 us of bytes.
// At 8x8 and 4x4 M is a few hundred rows, each weight byte feeds ~M
// operations, and the weights' bytes, the split's second launch and the
// launch latency bound it. The design answers the operations with wgmma at
// the int8 rate behind a TMA ring (no register staging, no prologue in the
// loop), and the bytes with one accumulator set written once from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int S8_BN = 128;  // output channels of a tile
// bytes of a slice row: 128 int8 channels of a tap, or 64 bf16 skip channels
constexpr int S8_ROW = 128;
constexpr int S8_B_BYTES = S8_BN * S8_ROW;  // 16 KB: the weights of a slice
constexpr int S8_THREADS = 288;  // consumer warpgroups 0 and 1, then the producer warp
constexpr int S8_CONSUMER_WARPS = 8;

// The tile of MW m64 blocks per consumer warpgroup: 128 * MW output pixels.
template <int MW>
struct S8Tile {
  static constexpr int BM = 128 * MW;
  static constexpr int STAGES = MW == 1 ? 3 : 4;
  static constexpr int A_BYTES = BM * S8_ROW;
  static constexpr int STAGE_BYTES = A_BYTES + S8_B_BYTES;
  // the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB atom, barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// the H100's 227 KB of shared memory a block; two 128-pixel CTAs share an SM
static_assert(S8Tile<2>::SMEM <= 227 * 1024, "the 256-pixel ring exceeds shared memory");
static_assert(2 * (S8Tile<1>::SMEM + 1024) <= 228 * 1024, "two 128-pixel CTAs do not fit an SM");

long long s8_launch_counts[S8_COUNTED];

struct S8Plan {
  int B, H, W, N, cin;
  int box_h, box_b, tiles_h;  // the A box: W x box_h pixels of box_b samples
  int conv_slices;  // 9 * cin / 128
  int skip0_slices;  // cs0 / 64: the skip slices that read s0, then those of s1
  int slices, kper, splits;
  const float* wsc;
  const float* qs;
  const float* amax;
  const float* bias;
  const float* bias2;
  const float* temb;
  const bf16* resid;
  float out_scale;
  void* out;
  float* partial;
};

// The output pixel of row r of tile (b0, y0), or -1 past the batch or the image.
__device__ __forceinline__ int s8_row(const S8Plan& p, int b0, int y0, int r) {
  const int per_sample = p.W * p.box_h;
  if (r >= per_sample * p.box_b) return -1;  // the box holds fewer pixels than the tile
  const int b = b0 + r / per_sample, y = y0 + (r / p.W) % p.box_h;
  if (b >= p.B || y >= p.H) return -1;
  return (b * p.H + y) * p.W + r % p.W;
}

__device__ __forceinline__ void store2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}

// The temb row and the residual for output channels n, n+1 of pixel m
// (whose bias + b_skip r0, r1 hold already), then the scale
template <typename TO>
__device__ __forceinline__ void s8_epilogue2(const S8Plan& p, long m, int n, float r0, float r1) {
  if (p.temb) {
    const float* tr = p.temb + (m / (p.H * p.W)) * p.N + n;
    r0 += tr[0];
    r1 += tr[1];
  }
  if (p.resid) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.resid + m * p.N + n));
    r0 += v.x;
    r1 += v.y;
  }
  store2((TO*)p.out + m * p.N + n, r0 * p.out_scale, r1 * p.out_scale);
}

// bias + b_skip of output channels n, n+1 (each null or (N,))
__device__ __forceinline__ float2 s8_bias2(const S8Plan& p, int n) {
  float2 c = make_float2(0.f, 0.f);
  if (p.bias) c = make_float2(p.bias[n], p.bias[n + 1]);
  if (p.bias2) c = make_float2(c.x + p.bias2[n], c.y + p.bias2[n + 1]);
  return c;
}

// grid (m_tiles, N / 128, splits), S8_THREADS threads, S8Tile<MW>::SMEM
// dynamic shared memory. Split z runs the slices [z*kper, min((z+1)*kper,
// slices)): first those of the conv (int8), then those of the skip (bf16).
template <int MW, typename TO>
__global__ void __launch_bounds__(S8_THREADS, 3 - MW)
conv_s8_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap s0map,
                     const __grid_constant__ CUtensorMap s1map,
                     const __grid_constant__ CUtensorMap wsmap, const S8Plan p) {
  using Tile = S8Tile<MW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full0 = ring_u32 + Tile::STAGES * Tile::STAGE_BYTES;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * Tile::STAGES;

  const int tb = blockIdx.x / p.tiles_h, th = blockIdx.x % p.tiles_h;
  const int b0 = tb * p.box_b, y0 = th * p.box_h;
  const int m0 = (b0 * p.H + y0) * p.W;  // the tile's rows are the pixels m0, m0 + 1, ...
  const int n0 = blockIdx.y * S8_BN;
  const int s_beg = blockIdx.z * p.kper;
  const int n_sl = min(p.slices, s_beg + p.kper) - s_beg;
  const int n_conv = max(0, min(n_sl, p.conv_slices - s_beg));  // then n_sl - n_conv skip slices
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, S8_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == S8_CONSUMER_WARPS) {
    // the producer: one thread keeps the ring's loads in flight
    if (lane == 0) {
      const uint32_t a_tx = (uint32_t)(p.W * p.box_h * p.box_b * S8_ROW);
      for (int i = 0; i < n_sl; ++i) {
        const int s = i % Tile::STAGES;
        if (i >= Tile::STAGES) mbar_wait(empty0 + 8 * s, ((i / Tile::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t a = ring_u32 + s * Tile::STAGE_BYTES, b = a + Tile::A_BYTES;
        if (i < n_conv) {
          mbar_expect_tx(full, a_tx + S8_B_BYTES);
          const int k0 = (s_beg + i) * S8_ROW;
          const int tap = k0 / p.cin, c0 = k0 - tap * p.cin;
          tma_load_4d(a, &amap, full, c0, tap % 3 - 1, y0 + tap / 3 - 1, b0);
          tma_load_2d(b, &wmap, full, k0, n0);
        } else {
          // 64 skip channels: the tile's rows of s0 or s1, and the (64 K x
          // 128 N) weights as two N-major boxes
          mbar_expect_tx(full, Tile::A_BYTES + S8_B_BYTES);
          const int j = s_beg + i - p.conv_slices;
          if (j < p.skip0_slices)
            tma_load_2d(a, &s0map, full, 64 * j, m0);
          else
            tma_load_2d(a, &s1map, full, 64 * (j - p.skip0_slices), m0);
          tma_load_2d(b, &wsmap, full, n0, 64 * j);
          tma_load_2d(b + S8_B_BYTES / 2, &wsmap, full, n0 + 64, 64 * j);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g owns the tile's m64 blocks g * MW + t, in
  // one set of accumulators: s32 sums, then (in place) f32
  const int g = warp >> 2;
  uint32_t acc[MW][64];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[t][j] = 0u;
  for (int i = 0; i < n_conv; ++i) {
    const int s = i % Tile::STAGES;
    mbar_wait(full0 + 8 * s, (i / Tile::STAGES) & 1);
    const uint32_t a = ring_u32 + s * Tile::STAGE_BYTES + g * MW * (64 * S8_ROW);
    const uint32_t b = ring_u32 + s * Tile::STAGE_BYTES + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S8_ROW / 32; ++kk) {
      // A and B alike: rows of 128 bytes, 8-row atoms 1 KB apart; a k32
      // step is 32 bytes into the row
      const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
#pragma unroll
      for (int t = 0; t < MW; ++t)
        wgmma_s8_m64n128k32(acc[t], sw128_desc(a + t * (64 * S8_ROW) + 32 * kk, 16, 1024), db);
    }
    wgmma_commit();
    // the previous slice's group has completed: free its stage
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % Tile::STAGES));
  }
  wgmma_wait<0>();
  if (n_conv > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((n_conv - 1) % Tile::STAGES));

  // Accumulator layout: register 4j + 2h + e holds row 16 (warp % 4) +
  // lane / 4 + 8 h of its m64 block, column 8 j + 2 (lane % 4) + e.
  const int hw = p.H * p.W;
  const int row0 = 16 * (warp & 3) + (lane >> 2), col0 = 2 * (lane & 3);
  int rows[MW][2];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[t][h] = s8_row(p, b0, y0, 64 * (g * MW + t) + row0 + 8 * h);

  // the int32 sums to f32 in place, times (w_scale[n] * s) of the row's
  // scale; column-outer, so that a weight scale is loaded once for the
  // thread's 2 MW rows
  float srow[MW][2];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = rows[t][h];
      srow[t][h] = p.qs != nullptr ? *p.qs : m < 0 ? 0.f : fmaxf(p.amax[m / hw], 1e-12f) / 127.0f;
    }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float w = p.wsc[n0 + col0 + 8 * j + e];
#pragma unroll
      for (int t = 0; t < MW; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t& r = acc[t][4 * j + 2 * h + e];
          r = __float_as_uint(__int2float_rn((int)r) * (w * srow[t][h]));
        }
    }

  // the skip slices, bf16 products into the same (now f32) accumulators
  for (int i = n_conv; i < n_sl; ++i) {
    const int s = i % Tile::STAGES;
    mbar_wait(full0 + 8 * s, (i / Tile::STAGES) & 1);
    const uint32_t a = ring_u32 + s * Tile::STAGE_BYTES + g * MW * (64 * S8_ROW);
    const uint32_t b = ring_u32 + s * Tile::STAGE_BYTES + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B: K rows of 128 bytes (64 N), the second 64 N columns 8 KB on (the
      // leading offset), 8-row K atoms 1 KB apart; a k16 step is 16 rows
      const uint64_t db = sw128_desc(b + 2048 * kk, S8_B_BYTES / 2, 1024);
#pragma unroll
      for (int t = 0; t < MW; ++t)
        wgmma_m64n128k16_b32(acc[t], sw128_desc(a + t * (64 * S8_ROW) + 32 * kk, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > n_conv && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % Tile::STAGES));
  }
  wgmma_wait<0>();

  const int M = p.B * hw;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + col0 + 8 * j;
    const float2 cb = p.splits == 1 ? s8_bias2(p, n) : make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < MW; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rows[t][h];
        if (m < 0) continue;
        const float r0 = __uint_as_float(acc[t][4 * j + 2 * h]);
        const float r1 = __uint_as_float(acc[t][4 * j + 2 * h + 1]);
        if (p.splits > 1)  // a split's dequantized f32 partial, straight from the accumulators
          store2(p.partial + ((long)blockIdx.z * M + m) * p.N + n, r0, r1);
        else
          s8_epilogue2<TO>(p, m, n, r0 + cb.x, r1 + cb.y);
      }
  }
}

// Split-K reduction: the dequantized f32 partials summed in split order,
// then the epilogue. grid ceil(M*N/2 / 256), 256 threads, 2 channels each.
template <typename TO>
__global__ void __launch_bounds__(256) conv_s8_splitk_kernel(const S8Plan p) {
  const long mn = (long)p.B * p.H * p.W * p.N;
  const long v = ((long)blockIdx.x * 256 + threadIdx.x) * 2;
  if (v >= mn) return;
  float2 r = *reinterpret_cast<const float2*>(p.partial + v);
  for (int z = 1; z < p.splits; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(p.partial + z * mn + v);
    r.x += a.x;
    r.y += a.y;
  }
  const int n = (int)(v % p.N);
  const float2 cb = s8_bias2(p, n);
  s8_epilogue2<TO>(p, v / p.N, n, r.x + cb.x, r.y + cb.y);
}

template <int MW, typename TO>
int launch_s8(dim3 grid, const CUtensorMap* maps, const S8Plan& p, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(conv_s8_wgmma_kernel<MW, TO>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              S8Tile<MW>::SMEM);
    if (err) return err;
    attr = true;
  }
  conv_s8_wgmma_kernel<MW, TO><<<grid, S8_THREADS, S8Tile<MW>::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  int err = (int)cudaGetLastError();
  if (!err) count_s8_launch(COUNT_CONV_S8);
  if (!err && p.splits > 1) {
    const long vecs = (long)p.B * p.H * p.W * p.N / 2;
    conv_s8_splitk_kernel<TO><<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(p);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace

void count_s8_launch(S8Counted kernel) { ++s8_launch_counts[kernel]; }

int conv_s8_launch(const S8Gemm& g, const S8Tiles& t, cudaStream_t st) {
  const int cskip = g.s0 ? g.cs0 + g.cs1 : 0;
  const int conv_slices = 9 * g.cin / S8_ROW;
  const int slices = conv_slices + cskip / 64;
  const int bm = 128 * t.mw;
  if (g.cin % S8_ROW || g.N % S8_BN || (g.s0 && (g.cs0 % 64 || g.cs1 % 64 || g.ws == nullptr)) ||
      g.W > 256 || t.box_h < 1 || t.box_b < 1 || t.box_h > 256 || t.box_b > 256 ||
      (t.mw != 1 && t.mw != 2) || g.W * t.box_h * t.box_b > bm || g.splits < 1 || g.kper < 1 ||
      (g.splits - 1) * g.kper >= slices || g.splits * g.kper < slices ||
      (g.splits > 1 && g.partial == nullptr) || (g.qs == nullptr && g.amax == nullptr))
    return (int)cudaErrorInvalidValue;
  const long m = (long)g.B * g.H * g.W;
  S8Plan p;
  p.B = g.B;
  p.H = g.H;
  p.W = g.W;
  p.N = g.N;
  p.cin = g.cin;
  p.box_h = t.box_h;
  p.box_b = t.box_b;
  p.tiles_h = t.tiles_h;
  p.conv_slices = conv_slices;
  p.skip0_slices = g.s0 ? g.cs0 / 64 : 0;
  p.slices = slices;
  p.kper = g.kper;
  p.splits = g.splits;
  p.wsc = g.wsc;
  p.qs = g.qs;
  p.amax = g.amax;
  p.bias = g.bias;
  p.bias2 = g.bias2;
  p.temb = g.temb;
  p.resid = (const bf16*)g.resid;
  p.out_scale = g.out_scale;
  p.out = g.out;
  p.partial = g.partial;

  // maps: A, W, skip s0, skip s1, skip weights (unused ones stay zero)
  CUtensorMap maps[5] = {};
  const cuuint64_t adims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint64_t astrides[3] = {(cuuint64_t)g.cin, (cuuint64_t)g.W * g.cin,
                                  (cuuint64_t)g.H * g.W * g.cin};
  const cuuint32_t abox[4] = {S8_ROW, (cuuint32_t)g.W, (cuuint32_t)t.box_h, (cuuint32_t)t.box_b};
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * g.cin, (cuuint64_t)g.N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * g.cin};
  const cuuint32_t wbox[2] = {S8_ROW, S8_BN};
  bool ok = sw128_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.a, 4, adims, astrides, abox) &&
            sw128_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.w, 2, wdims, wstrides, wbox);
  if (ok && g.s0) {
    const cuuint32_t sbox[2] = {64, (cuuint32_t)bm};
    const cuuint64_t s0dims[2] = {(cuuint64_t)g.cs0, (cuuint64_t)m};
    const cuuint64_t s0strides[1] = {(cuuint64_t)g.cs0 * 2};
    ok = bf16_map(&maps[2], g.s0, 2, s0dims, s0strides, sbox);
    if (ok && g.cs1 > 0) {
      const cuuint64_t s1dims[2] = {(cuuint64_t)g.cs1, (cuuint64_t)m};
      const cuuint64_t s1strides[1] = {(cuuint64_t)g.cs1 * 2};
      ok = bf16_map(&maps[3], g.s1, 2, s1dims, s1strides, sbox);
    }
    const cuuint64_t wsdims[2] = {(cuuint64_t)g.N, (cuuint64_t)cskip};
    const cuuint64_t wsstrides[1] = {(cuuint64_t)g.N * 2};
    const cuuint32_t wsbox[2] = {64, 64};
    ok = ok && bf16_map(&maps[4], g.ws, 2, wsdims, wsstrides, wsbox);
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  const dim3 grid(t.m_tiles, g.N / S8_BN, g.splits);
  if (t.mw == 1)
    return g.out_f32 ? launch_s8<1, float>(grid, maps, p, st)
                     : launch_s8<1, bf16>(grid, maps, p, st);
  return g.out_f32 ? launch_s8<2, float>(grid, maps, p, st)
                   : launch_s8<2, bf16>(grid, maps, p, st);
}

extern "C" {

// The bare int8 conv of the block GEMM: out (B, H, W, N) f32 = conv3x3(a8,
// w) * (wsc[n] * *qs), a8 (B, H, W, Cin) int8, wk (N, 9 * Cin) int8 K-major,
// wsc (N,) and qs () f32 on the device; the tile plan as gddim_resblock_int8
// takes it. With wsc and qs ones, out holds the int32 sums (exact in f32 up
// to 2^24). Scratch `work`: splits * M * N f32 when splits > 1.
int gddim_conv_s8(const void* a8, const void* wk, const void* wsc, const void* qs, int batch,
                  int h, int w, int cin, int n, int mw, int box_h, int box_b, int tiles_h,
                  int m_tiles, int splits, int kper, void* work, void* out, void* stream) {
  S8Gemm g = {};
  g.a = (const int8_t*)a8;
  g.w = (const int8_t*)wk;
  g.cin = cin;
  g.B = batch;
  g.H = h;
  g.W = w;
  g.N = n;
  g.wsc = (const float*)wsc;
  g.qs = (const float*)qs;
  g.out_scale = 1.0f;
  g.out = out;
  g.out_f32 = true;
  g.partial = (float*)work;
  g.splits = splits;
  g.kper = kper;
  return conv_s8_launch(g, S8Tiles{mw, box_h, box_b, tiles_h, m_tiles}, (cudaStream_t)stream);
}

// Launches of conv_s8_wgmma_kernel and s8_prepass_kernel (S8Counted order)
// into out (two long long); with reset, zeroed after reading.
int gddim_s8_launches(long long* out, int reset) {
  for (int k = 0; k < S8_COUNTED; ++k) {
    out[k] = s8_launch_counts[k];
    if (reset) s8_launch_counts[k] = 0;
  }
  return 0;
}

}  // extern "C"
