// K11: the stride-1 SAME 3x3 convolution of the layer-wise path conv_impl
// 'pallas' (sampling and, as the forward of its autograd.Function, training),
// NHWC bf16 operands, HWIO weights, for Hopper (sm_90a).
//
// Replaces gddim_tpu/ops/conv3x3.py:conv3x3_pallas (_conv_kernel, nine
// shifted matmuls with f32 sums, out in x's dtype). K11's int8 form
// (conv3x3_pallas_int8, conv_impl 'int8') runs on the int8 block GEMM
// (block_gemm.cu:gddim_conv3x3_int8).
//
//   gddim_conv3x3       conv3x3_wgmma_kernel, an implicit GEMM (M = B*H*W
//                       output pixels, N = Cout, K = 9*Cin) on wgmma fed by
//                       TMA, f32 sums of exact bf16 products, stored in the
//                       activations' type (split-K sums f32 partials in
//                       split order first): rounded once to bf16, or (on
//                       f32 activations, whose bf16 operand the block
//                       GEMM's pre-pass writes, ops/conv3x3.py) stored as
//                       the f32 sums themselves, as the TPU kernel's output
//                       is x's dtype.
//
// What bounds it on the H100: at 32x32 and 16x16 the products (2*M*9*Cin*Cout
// against M*(Cin+Cout) activation bytes and 9*Cin*Cout weight bytes) put it
// above the ridge, so the tensor cores bound it; at 8x8 and 4x4 M = B*H*W is a
// few hundred rows, each weight byte feeds ~M operations, and the weights'
// bytes and the launch bound it.
//
// The design. A CTA owns a 128-pixel x 128-channel output tile and walks
// K in 64-wide slices (one tap, 64 input channels) through a 3-stage ring of
// shared memory (A 16 KB + B 16 KB a stage), with one full/empty mbarrier
// pair a stage:
// - A by TMA with no im2col and no padded copy: x is a 4-D tensor map
//   (C, W, H, B) with the 128-byte swizzle, and the tile's 128 pixels are one
//   box of (64 ch, W, box_h rows, box_b samples). Tap (dy, dx) is the same box
//   at (x, y) offsets (dx-1, dy-1); the TMA unit writes zeros for the
//   out-of-bounds elements, negative coordinates included, so SAME padding
//   costs nothing, and rows past the batch or the image read zero and are
//   masked in the epilogue.
// - B by TMA from the (9*Cin, N) row-major weights as they are: two boxes of
//   64 K rows x 64 N columns, N-major, which wgmma reads through its
//   transpose bit.
// - One producer warp issues the loads; two consumer warpgroups each run
//   wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate), four per slice,
//   keeping one slice's group in flight while the next is issued, and free
//   a stage when its group has completed.
// - Small grids (8x8 and 4x4 at small B give 2-16 tiles against K = 2304 to
//   4608) split K: the tile plan (box, M tiles, splits, slices per split) is
//   a pure function of the shapes computed in ops/conv3x3.py:tile_plan, and
//   a second kernel sums the f32 partials in split order, so the result
//   does not depend on the run.
// - Tile height: 128 pixels (two CTAs an SM, 99 KB each) or, where the grid
//   still fills the card, 256 (each warpgroup two m64 blocks; 193 KB, one
//   CTA an SM), which cuts the L2 bytes a product needs by a quarter: a
//   128 x 128 tile with a 64-deep slice does 64 operations a byte of shared
//   memory filled, so at the bf16 peak it would need ~15 TB/s from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// K11 bf16: conv3x3_wgmma_kernel
// ---------------------------------------------------------------------------

namespace {

constexpr int WG_BN = 128;  // output channels of a tile
constexpr int WG_BK = 64;   // K slice: 64 input channels of one tap (128 bytes of bf16)
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;  // 16 KB: two boxes of 64 K rows x 64 N
constexpr int WG_THREADS = 288;  // consumer warpgroups 0 and 1, then the producer warp
constexpr int WG_CONSUMER_WARPS = 8;

// The tile of MW m64 blocks per consumer warpgroup: 128 * MW output pixels.
// MW = 1: a 3-stage ring of 32 KB stages, two CTAs an SM; MW = 2: a 4-stage
// ring of 48 KB stages, one CTA an SM, which reads half the bytes per
// product from L2.
template <int MW>
struct WgTile {
  static constexpr int BM = 128 * MW;
  static constexpr int STAGES = MW == 1 ? 3 : 4;
  static constexpr int A_BYTES = BM * WG_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + WG_B_BYTES;
  // the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB atom, barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

struct WgPlan {
  int B, H, W, C, N;
  int box_w, box_h, box_b;  // the A box: box_w x box_h pixels of box_b samples
  int tiles_h;              // M tiles of one sample group along H
  int slices, kper;         // K slices of 64 in all, and per split
  int splits;
  float* partial;           // (splits, M, N) f32, when splits > 1
  void* out;                // (M, N) of the output's type (TO)
};

// Two output values, rounded to bf16 or stored as they are
__device__ __forceinline__ void put2(__nv_bfloat16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}

// The output pixel of row r of tile (b0, y0), or -1 past the batch or the image.
__device__ __forceinline__ long tile_row(const WgPlan& p, int b0, int y0, int r) {
  const int per_sample = p.box_w * p.box_h;
  if (r >= per_sample * p.box_b) return -1;  // the box holds fewer pixels than the tile
  const int b = b0 + r / per_sample, y = y0 + (r / p.box_w) % p.box_h;
  if (b >= p.B || y >= p.H) return -1;
  return ((long)b * p.H + y) * p.W + r % p.box_w;
}

// grid (M tiles, N / 128, splits), WG_THREADS threads, WgTile<MW>::SMEM
// dynamic shared memory. Split z accumulates the K slices [z*kper,
// min((z+1)*kper, slices)). TO: the output's type, bf16 or float.
template <int MW, typename TO>
__global__ void __launch_bounds__(WG_THREADS, 3 - MW)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const WgPlan p) {
  using Tile = WgTile<MW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full0 = ring_u32 + Tile::STAGES * Tile::STAGE_BYTES;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * Tile::STAGES;

  const int tb = blockIdx.x / p.tiles_h, th = blockIdx.x % p.tiles_h;
  const int b0 = tb * p.box_b, y0 = th * p.box_h;
  const int n0 = blockIdx.y * WG_BN;
  const int s_beg = blockIdx.z * p.kper;
  const int n_sl = min(p.slices, s_beg + p.kper) - s_beg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WG_CONSUMER_WARPS) {
    // the producer: one thread keeps the ring's loads in flight
    if (lane == 0) {
      const uint32_t tx = (uint32_t)(p.box_w * p.box_h * p.box_b * WG_BK * 2) + WG_B_BYTES;
      for (int i = 0; i < n_sl; ++i) {
        const int s = i % Tile::STAGES;
        if (i >= Tile::STAGES) mbar_wait(empty0 + 8 * s, ((i / Tile::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t a = ring_u32 + s * Tile::STAGE_BYTES, b = a + Tile::A_BYTES;
        mbar_expect_tx(full, tx);
        const int k0 = (s_beg + i) * WG_BK;
        const int tap = k0 / p.C, c0 = k0 - tap * p.C;
        tma_load_4d(a, &xmap, full, c0, tap % 3 - 1, y0 + tap / 3 - 1, b0);
        tma_load_2d(b, &wmap, full, n0, k0);
        tma_load_2d(b + WG_B_BYTES / 2, &wmap, full, n0 + 64, k0);
      }
    }
    return;
  }

  // the consumers: warpgroup g owns the tile's m64 blocks g * MW + t
  const int g = warp >> 2;
  float acc[MW][64];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[t][j] = 0.f;
  for (int i = 0; i < n_sl; ++i) {
    const int s = i % Tile::STAGES;
    mbar_wait(full0 + 8 * s, (i / Tile::STAGES) & 1);
    const uint32_t a = ring_u32 + s * Tile::STAGE_BYTES + g * MW * (64 * 128);
    const uint32_t b = ring_u32 + s * Tile::STAGE_BYTES + Tile::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: 64 rows of 128 bytes, 8-row atoms 1 KB apart; a k16 step is 32
      // bytes into the row. B: K rows of 128 bytes (64 N), the second 64 N
      // columns 8 KB on (the leading offset), 8-row K atoms 1 KB apart; a
      // k16 step is 16 rows.
      const uint64_t db = sw128_desc(b + 2048 * kk, WG_B_BYTES / 2, 1024);
#pragma unroll
      for (int t = 0; t < MW; ++t)
        wgmma_m64n128k16(acc[t], sw128_desc(a + t * (64 * 128) + 32 * kk, 16, 1024), db);
    }
    wgmma_commit();
    // the previous slice's group has completed: free its stage
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % Tile::STAGES));
  }
  wgmma_wait<0>();

  // Accumulator layout: register 4j + 2h + e holds row 16 (warp % 4) +
  // lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
  const int M = p.B * p.H * p.W;
  const int row0 = 16 * (warp & 3) + (lane >> 2), col0 = 2 * (lane & 3);
  if (p.splits > 1) {
    // a split's f32 partial, straight from the accumulators
#pragma unroll
    for (int t = 0; t < MW; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = tile_row(p, b0, y0, 64 * (g * MW + t) + row0 + 8 * h);
        if (m < 0) continue;
        float* dst = p.partial + ((long)blockIdx.z * M + m) * p.N + n0 + col0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
      }
    return;
  }
  // the tile in the output's type through shared memory, so that global
  // stores are whole 16-byte pieces of rows: once every consumer warp is past
  // its last wgmma the ring is free (the producer has exited; barrier 1
  // counts the consumers). A staged row is padded by 16 bytes.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  constexpr int VEC = 16 / sizeof(TO);  // output values of a 16-byte piece
  constexpr int LD = WG_BN + VEC;       // staging row
  static_assert(Tile::BM * LD * sizeof(TO) <= Tile::STAGES * Tile::STAGE_BYTES,
                "the staged tile exceeds the ring");
  TO* stage = reinterpret_cast<TO*>(ring);
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        put2(stage + (64 * (g * MW + t) + row0 + 8 * h) * LD + col0 + 8 * j,
             acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
  asm volatile("bar.sync 1, 256;" ::: "memory");
  TO* out = reinterpret_cast<TO*>(p.out);
  for (int x = threadIdx.x; x < Tile::BM * (WG_BN / VEC); x += 256) {
    const int r = x / (WG_BN / VEC), c = VEC * (x % (WG_BN / VEC));
    const long m = tile_row(p, b0, y0, r);
    if (m >= 0)
      *reinterpret_cast<uint4*>(out + m * p.N + n0 + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// Split-K reduction: the f32 partials summed in split order, rounded once to
// bf16 or stored as f32 (TO). grid ceil(M*N/4 / 256), 256 threads, 4
// channels each.
template <typename TO>
__global__ void __launch_bounds__(256) wgmma_splitk_kernel(const WgPlan p) {
  const long mn = (long)p.B * p.H * p.W * p.N;
  const long v = ((long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (v >= mn) return;
  float4 r = *reinterpret_cast<const float4*>(p.partial + v);
  for (int z = 1; z < p.splits; ++z) {
    const float4 a = *reinterpret_cast<const float4*>(p.partial + z * mn + v);
    r.x += a.x;
    r.y += a.y;
    r.z += a.z;
    r.w += a.w;
  }
  TO* dst = reinterpret_cast<TO*>(p.out) + v;
  put2(dst, r.x, r.y);
  put2(dst + 2, r.z, r.w);
}

template <int MW, typename TO>
int launch_wgmma(dim3 grid, const CUtensorMap& xmap, const CUtensorMap& wmap, const WgPlan& p,
                 cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(conv3x3_wgmma_kernel<MW, TO>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              WgTile<MW>::SMEM);
    if (err) return err;
    attr = true;
  }
  conv3x3_wgmma_kernel<MW, TO><<<grid, WG_THREADS, WgTile<MW>::SMEM, st>>>(xmap, wmap, p);
  int err = (int)cudaGetLastError();
  if (!err && p.splits > 1) {
    const long vecs = (long)p.B * p.H * p.W * p.N / 4;
    wgmma_splitk_kernel<TO><<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(p);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// K11: out (B, H, W, N) = conv3x3(x (B, H, W, Cin) bf16, w (3, 3, Cin, N)
// bf16), f32 sums, out bf16 or, with out_f32, f32. Cin a multiple of 64, N
// of 128, W at most 256.
// The tile plan (ops/conv3x3.py:tile_plan): tiles of 128 * mw pixels (mw 1
// or 2), the A box (box_w = W, box_h rows, box_b samples, at most one tile),
// tiles_h M tiles per sample group along H, m_tiles in all, K split into
// `splits` runs of kper 64-wide slices.
// Scratch `work`: splits * M * N f32 when splits > 1.
int gddim_conv3x3(const void* x, const void* w, int batch, int h, int w_, int cin, int n,
                  int mw, int box_h, int box_b, int tiles_h, int m_tiles, int splits, int kper,
                  int out_f32, void* work, void* out, void* stream) {
  const int slices = 9 * cin / WG_BK;
  if (cin % WG_BK || n % WG_BN || w_ > 256 || box_h < 1 || box_b < 1 || box_h > 256 ||
      box_b > 256 || (mw != 1 && mw != 2) || w_ * box_h * box_b > 128 * mw || splits < 1 || kper < 1 ||
      (splits - 1) * kper >= slices || splits * kper < slices)
    return (int)cudaErrorInvalidValue;
  WgPlan p;
  p.B = batch;
  p.H = h;
  p.W = w_;
  p.C = cin;
  p.N = n;
  p.box_w = w_;
  p.box_h = box_h;
  p.box_b = box_b;
  p.tiles_h = tiles_h;
  p.slices = slices;
  p.kper = kper;
  p.splits = splits;
  p.partial = (float*)work;
  p.out = out;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w_, (cuuint64_t)h,
                               (cuuint64_t)batch};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w_ * cin * 2,
                                  (cuuint64_t)h * w_ * cin * 2};
  const cuuint32_t xbox[4] = {WG_BK, (cuuint32_t)w_, (cuuint32_t)box_h, (cuuint32_t)box_b};
  const cuuint64_t wdims[2] = {(cuuint64_t)n, (cuuint64_t)9 * cin};
  const cuuint64_t wstrides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t wbox[2] = {64, WG_BK};
  if (!bf16_map(&xmap, x, 4, xdims, xstrides, xbox) || !bf16_map(&wmap, w, 2, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(m_tiles, n / WG_BN, splits);
  if (out_f32)
    return mw == 1 ? launch_wgmma<1, float>(grid, xmap, wmap, p, st)
                   : launch_wgmma<2, float>(grid, xmap, wmap, p, st);
  return mw == 1 ? launch_wgmma<1, __nv_bfloat16>(grid, xmap, wmap, p, st)
                 : launch_wgmma<2, __nv_bfloat16>(grid, xmap, wmap, p, st);
}

}  // extern "C"
