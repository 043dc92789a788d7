// The block GEMM for Hopper (sm_90a): both 3x3 convs, and conv2's 1x1 skip
// (bf16, or the int8 blocks' static int8 skip), of the bf16 and int8 modes
// of K2, K3, K4 and K9 (conv_impl 'fused' on bf16 activations, and
// 'fused_int8'), and K5's q/k/v and output
// projections as 1x1 convs over M = B*H*W pixels (taps 1, attnblock.cu);
// the training blocks' GEMMs over M: K6's two convs (resblock.cu), K7's
// recomputed conv1, its two 3x3 dgrads and its 1x1 skip dgrad
// (resblock_bwd.cu); and K11's int8 form (gddim_conv3x3_int8 below, conv_impl
// 'int8': gddim_tpu/ops/conv3x3.py:conv3x3_pallas_int8, whose int32 sums over
// all nine taps are converted once, so its split K adds int32 partials).
//
// Replaces the conv part of gddim_tpu/ops/resblock.py's kernels
// (_resblock_kernel_v2 and _resblock_kernel for K2 and K4,
// _resblock_pair_kernel(_v2) for K3, _resblock_transition_kernel for K9):
// _conv9's nine shifted products on the zero-padded activation tile, with
// mm_dtype bf16 (f32 sums) or int8 (s32 sums, dequantized as acc * (w_scale
// * s)), and the skip product (bf16 with f32 sums, or with act_scales [s1,
// s2, sx] the static_skip branch's int8 product, resblock.py:283-290,
// 408-415, 830-833, 957, 1152-1173, 1404-1409), and conv1's share of GN2's
// statistics (gn_silu_tile's per-channel sums of acc3, resblock.py:345-356,
// 385-386), taken while the tile is in registers. The block around it (GN1
// statistics, amax, and the pre-pass that writes each conv's input once and
// folds GN2's sums, in resblock.cu) stays one C call, resblock_gemm_run.
//
// block_gemm_kernel<TA> is an implicit GEMM, M = B*H*W output pixels, N =
// Cout, K = taps * Cin channels of TA (bf16 or int8; taps 9 for a 3x3 conv,
// 1 for a 1x1 projection), then Cskip bf16 channels (or, SK8, Cskip int8).
// A K slice is 128 bytes a pixel: 64 bf16 or 128 int8 channels of one tap,
// or 64 bf16 (128 int8) skip channels.
// - A by TMA with no im2col and no padded copy: the pre-pass's activation
//   is a 4-D tensor map (C, W, H, B) with the 128-byte swizzle; a conv
//   slice is one box of (the slice's channels, W, box_h rows, box_b
//   samples) at (x, y) offsets (dx-1, dy-1), or (0, 0) with one tap. The TMA unit writes zeros out
//   of bounds, and the activation (GN affine, SiLU, quantization) was
//   applied before, so the zeros are the activation's, as the TPU kernels
//   pad a1 (hpad_ref): SAME padding costs nothing.
// - B by TMA. bf16: the HWIO weights (9 * Cin, N) as they are, two N-major
//   boxes of 64 K rows x 64 N a slice, read through wgmma's transpose bit
//   (as K11, and the skip weights in both modes). int8: 8-bit wgmma takes
//   both operands K-major and has no transpose bit, so the model packs the
//   quantized HWIO weights once (ops/resblock.py:pack_int8_weight), (N, 9 *
//   Cin); one 128 x 128 box a slice. A dgrad (KMAJ: K7's, _dgrad9 of
//   gddim_tpu/ops/resblock_bwd.py:96) is the 3x3 SAME conv of the cotangent
//   with the taps flipped and (Cin, Cout) swapped: for tap t it reads the
//   forward weights W[8 - t] as they are stored, whose (Cin, Cout) plane is
//   (N, K), K-major, one 128 x 128-byte box a slice read with the transpose
//   bit off (the skip dgrad: W_skip (N, K) likewise), so no repacked copy.
// - One producer warp keeps a 3-stage (128-pixel tiles, two CTAs an SM) or
//   4-stage (256-pixel tiles) ring of full/empty mbarriers fed; two consumer
//   warpgroups run wgmma.mma_async m64n128k16 f32.bf16.bf16 (bf16) or
//   m64n128k32 s32.s8.s8 (int8), four a slice.
// - One accumulator set. int8: the s32 and f32 wgmma accumulators share
//   their register layout, so after the last conv slice each consumer
//   converts its sums in place to f32 * (w_scale[n] * s), s the static scale
//   or the row's own sample's amax / 127 (a tile at 8x8 or 4x4 spans several
//   samples). The skip slices (64 bf16 channels of s0 or s1 by a 2-D TMA box
//   over the tile's pixels, which are consecutive rows of M) then run as
//   bf16 products into the same f32 registers; in the bf16 mode they follow
//   the conv slices in one loop.
// - The int8 blocks' static skip (SK8): its cs / 128 int8 K slices (q(x),
//   the skip input quantized by sx, by a 2-D box of the tile's rows, and the
//   K-major (N, cs) int8 skip weights, one 128 x 128 box) all join the last
//   split, after its conv slices, so that the skip's int32 sums are
//   converted once, to f32 * (w_skip_scale[n] * sx) + b_skip, and every
//   other split's partial is the conv's own. Its sums need a second int32
//   set while the conv's f32 values wait, and registers have no room for
//   one: 64 a thread per m64 block, at MW 2 (256-pixel tiles) 128 already,
//   and two CTAs an SM leave about 112 at MW 1. So each consumer parks its
//   f32 conv values in the ring's first STAGES - 1 stages, which the conv
//   has drained (64 KB at MW 1, 128 KB at MW 2: a thread's own float4s,
//   read back by the same thread), runs the skip slices into the same
//   accumulators through the last stage, one after another (the producer
//   reloads that stage for each), converts them and adds: ((conv + b2) +
//   0) + skip, the order of the former separate skip GEMM's f32 product
//   added as conv2's residual, so that an unsplit conv2 gives those bits.
//   The registers, the shared memory and the occupancy are the int8
//   kernel's; the cost is the park (a 64 or 128 KB round trip through
//   shared memory) and skip slices that do not overlap each other's loads.
// - The epilogue (bias + b_skip, the temb row, the identity residual of the
//   output's type, out_scale; f32 h1 or bf16 out, f32 out and residual in
//   K6's conv2; tile_epilogue) stages the tile's sums in
//   the drained ring and stores from there along whole rows. With gn_part
//   (conv1: the STATS instantiation) each thread also sums its 2 columns of
//   each sample's rows and their squares, and the row lanes' sums meet in a
//   fixed order in one row of GN2's partials a (tile, sample). GN2 then
//   never reads h1 back for its statistics.
// - Small grids split K as K11 does: each split writes its f32 partial
//   (dequantized in the int8 mode; conv and skip, SK8's skip in the last
//   split's: there conv + skip enter the split-order sum before b2), and
//   block_splitk_kernel
//   sums them in split order, so the result does not depend on the run
//   (block_splitk_stats_kernel for conv1: by tile, with GN2's sums; K11
//   int8 (S32): raw int32 partials, block_splitk_s32_kernel). The
//   tile plan (tile height, box, splits) is a pure function of the shapes,
//   computed in Python (ops/resblock.py:bf16_tile_plan, s8_tile_plan); the
//   ring's depth and shared memory follow from the tile height here (Tile).
//
// What bounds it on the H100: at 32x32 and 16x16 from B=16 the products
// (2*M*9*Cin*N operations at 989 TFLOP/s bf16 or 1,979 TOP/s int8) and the
// bytes the conv must move (A, mostly from L2 after the pre-pass, and
// conv1's f32 h1 at 4 bytes an output) come within a factor of 2-4 of each
// other: at B=64 32x32 128->128 conv1 needs 19.5 us of bf16 operations and
// 15.0 us of bytes (the bf16 A once and f32 h1). At 8x8 and 4x4 M is a few hundred rows, each weight
// byte feeds ~M operations, and the weights' bytes, the split's second
// launch and the launch latency bound it. The design answers the
// operations with wgmma at the type's rate behind a TMA ring (no register
// staging, no prologue in the loop: the pre-pass applies the activation
// once where a prologue in the loop would recompute it for each of 9 taps),
// and the bytes with one accumulator set written once from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE_N = 128;  // output channels of a tile
// bytes of a slice row: 64 bf16 or 128 int8 channels of a tap, or 64 bf16
// skip channels
constexpr int ROW = 128;
constexpr int B_BYTES = TILE_N * ROW;  // 16 KB: the weights of a slice
constexpr int THREADS = 288;  // consumer warpgroups 0 and 1, then the producer warp
constexpr int CONSUMER_WARPS = 8;

// The tile of MW m64 blocks per consumer warpgroup: 128 * MW output pixels.
template <int MW>
struct Tile {
  static constexpr int BM = 128 * MW;
  static constexpr int STAGES = MW == 1 ? 3 : 4;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB atom, barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// the H100's 227 KB of shared memory a block; two 128-pixel CTAs share an SM
static_assert(Tile<2>::SMEM <= 227 * 1024, "the 256-pixel ring exceeds shared memory");
static_assert(2 * (Tile<1>::SMEM + 1024) <= 228 * 1024, "two 128-pixel CTAs do not fit an SM");
// tile_epilogue stages the tile (and its row lanes' sums) in the drained ring
static_assert((128 * (TILE_N + 8) + 8 * TILE_N) * 4 <= Tile<1>::STAGES * Tile<1>::STAGE_BYTES,
              "the staged 128-pixel tile exceeds the ring");
static_assert((256 * (TILE_N + 8) + 8 * TILE_N) * 4 <= Tile<2>::STAGES * Tile<2>::STAGE_BYTES,
              "the staged 256-pixel tile exceeds the ring");
// the static skip parks the consumers' f32 conv sums (64 * MW a thread) in
// all stages but the last, through which its own slices then pass
static_assert(256 * 64 * 4 <= (Tile<1>::STAGES - 1) * Tile<1>::STAGE_BYTES,
              "the parked 128-pixel conv sums exceed the ring's first stages");
static_assert(256 * 128 * 4 <= (Tile<2>::STAGES - 1) * Tile<2>::STAGE_BYTES,
              "the parked 256-pixel conv sums exceed the ring's first stages");

long long launch_counts[N_COUNTED];

struct Plan {
  int B, H, W, N, cin;
  int taps;  // 9: 3x3 SAME, 1: 1x1
  int box_h, box_b, tiles_h;  // the A box: W x box_h pixels of box_b samples
  int conv_slices;  // taps * cin * sizeof(TA) / 128
  int skip0_slices;  // cs0 / 64: the skip slices that read s0, then those of s1
  int skip8;         // SK8: the static skip's 128-channel int8 slices, in the last split
  const float* wss;    // SK8: the skip weights' (N,) scales
  const float* sx;     // SK8: the static skip scale (one device float)
  const float* bskip;  // SK8: b_skip (N,), or null
  int slices, kper, splits;
  const float* wsc;
  const float* qs;
  const float* amax;
  const float* asc;  // K11 int8: the (B,) activation scales themselves
  const float* bias;
  const float* bias2;
  const float* temb;
  const void* resid;  // of the output's type (TO)
  float out_scale;
  void* out;
  float* partial;
  int temb_ld;     // row b of temb at temb + b * temb_ld
  int mw;          // tiles of 128 * mw output pixels
  float* gn_part;  // (2, B, tiles_h, N) GN2's per-channel sums and squares, or null
  bool kmajor;     // the bf16 weights K-major and tap-reversed (a dgrad)
  bool train;      // counted as a training block's GEMM
};

// The output pixel of row r of tile (b0, y0), or -1 past the batch or the image.
__device__ __forceinline__ int tile_row(const Plan& p, int b0, int y0, int r) {
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
__device__ __forceinline__ float2 load2(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}
__device__ __forceinline__ float2 load2(const bf16* s) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
}

// The temb row and the residual (of the output's type) for output channels
// n, n+1 of pixel m (whose bias + b_skip r0, r1 hold already), then the
// scale; returns the values stored (in f32)
template <typename TO>
__device__ __forceinline__ float2 epilogue2(const Plan& p, long m, int n, float r0, float r1) {
  if (p.temb) {
    const float* tr = p.temb + (m / (p.H * p.W)) * p.temb_ld + n;
    r0 += tr[0];
    r1 += tr[1];
  }
  if (p.resid) {
    const float2 v = load2((const TO*)p.resid + m * p.N + n);
    r0 += v.x;
    r1 += v.y;
  }
  const float2 v = make_float2(r0 * p.out_scale, r1 * p.out_scale);
  store2((TO*)p.out + m * p.N + n, v.x, v.y);
  return v;
}

// The 256 consumer threads (warpgroups 0 and 1) at named barrier 1; the
// producer warp has left
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// The tile row of GN2's partials of sample b: the sums (which 0) or squares (1)
__device__ __forceinline__ float* gn_row(const Plan& p, int which, int b, int th) {
  return p.gn_part + (((long)which * p.B + b) * p.tiles_h + th) * p.N;
}

// bias + b_skip of output channels n, n+1 (each null or (N,))
__device__ __forceinline__ float2 bias2(const Plan& p, int n) {
  float2 c = make_float2(0.f, 0.f);
  if (p.bias) c = make_float2(p.bias[n], p.bias[n + 1]);
  if (p.bias2) c = make_float2(c.x + p.bias2[n], c.y + p.bias2[n + 1]);
  return c;
}

// The epilogue of a tile whose K is not split: the f32 sums through
// shared memory (the drained ring, rows of STAGE_LD floats), then each
// thread takes 2 columns down a quarter of the tile's rows, so that the
// stores (and the residual's loads) run along whole rows: + bias + b_skip
// (not with BIAS off: SK8 added them in registers), the sample's temb row,
// the residual, times out_scale, as epilogue2. With
// STATS (conv1, f32 out) each thread also sums its columns' values of each
// sample and their squares, and the 4 row lanes' sums meet in order in the
// tile's row of GN2's partials. Stores straight from the accumulator layout
// (8 rows of 32 bytes a warp instruction) were slower, and GN2's sums
// folded into that unrolled code slowed this GEMM and every other
// instantiation of it (PERF.md §6).
constexpr int STAGE_LD = TILE_N + 8;  // floats a staged row: 64-bit stores in 2 wavefronts

template <int MW, typename TO, bool STATS, bool BIAS = true>
__device__ __forceinline__ void tile_epilogue(const Plan& p, const uint32_t (&acc)[MW][64],
                                              unsigned char* ring, int g, int row0, int col0,
                                              int b0, int y0, int n0) {
  float* tile = reinterpret_cast<float*>(ring);
  consumer_sync();  // every consumer's last wgmma has read the ring
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (64 * (g * MW + t) + row0 + 8 * h) * STAGE_LD + col0 +
                                   8 * j) =
            make_float2(__uint_as_float(acc[t][4 * j + 2 * h]),
                        __uint_as_float(acc[t][4 * j + 2 * h + 1]));
  consumer_sync();
  float* red = tile + 128 * MW * STAGE_LD;  // [sums, squares][4 row lanes][TILE_N]
  const int x = threadIdx.x, c = 2 * (x & 63), rl = x >> 6;
  const int n = n0 + c;
  const float2 cb = BIAS ? bias2(p, n) : make_float2(0.f, 0.f);
  // the tile's rows are the pixels m0 + r; those past the image or the batch
  // are the last ones
  const int hw = p.H * p.W, m0 = (b0 * p.H + y0) * p.W;
  const int per = p.box_b == 1 ? 128 * MW : hw;  // tile rows a sample
  const int valid = p.box_b == 1 ? min(p.box_h, p.H - y0) * p.W : min(p.box_b, p.B - b0) * hw;
  const long base = (long)m0 * p.N + n;
  for (int i = 0; i < p.box_b; ++i) {
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
    const float* trow = p.temb + (long)(b0 + i) * p.temb_ld + n;
    const float2 tr =
        p.temb && b0 + i < p.B ? make_float2(trow[0], trow[1]) : make_float2(0.f, 0.f);
    const int r_end = min(valid, (i + 1) * per);
#pragma unroll 4
    for (int r = i * per + rl; r < r_end; r += 4) {
      const float2 a = *reinterpret_cast<const float2*>(tile + r * STAGE_LD + c);
      float v0 = a.x + cb.x + tr.x, v1 = a.y + cb.y + tr.y;
      if (p.resid) {
        const float2 e = load2((const TO*)p.resid + base + (long)r * p.N);
        v0 += e.x;
        v1 += e.y;
      }
      v0 *= p.out_scale;
      v1 *= p.out_scale;
      store2((TO*)p.out + base + (long)r * p.N, v0, v1);
      if constexpr (STATS) {
        s0 += v0;
        s1 += v1;
        q0 += v0 * v0;
        q1 += v1 * v1;
      }
    }
    if constexpr (STATS) {
      *reinterpret_cast<float2*>(red + rl * TILE_N + c) = make_float2(s0, s1);
      *reinterpret_cast<float2*>(red + (4 + rl) * TILE_N + c) = make_float2(q0, q1);
      consumer_sync();
      const int col = x & (TILE_N - 1), which = x / TILE_N;
      const float* w = red + 4 * which * TILE_N + col;
      if (b0 + i < p.B)
        gn_row(p, which, b0 + i, blockIdx.x % p.tiles_h)[n0 + col] =
            ((w[0] + w[TILE_N]) + w[2 * TILE_N]) + w[3 * TILE_N];
      consumer_sync();
    }
  }
}

// The (64 K x 128 N) bf16 weights of a slice, K rows from k0 of an N-major
// (K, N) map, as two 64 x 64 boxes: the second 64 N columns B_BYTES / 2 on.
__device__ __forceinline__ void load_nmajor(uint32_t b, const CUtensorMap* map, uint32_t full,
                                            int n0, int k0) {
  tma_load_2d(b, map, full, n0, k0);
  tma_load_2d(b + B_BYTES / 2, map, full, n0 + 64, k0);
}

// Uses of ring stage `st` by the first n slices (slice i in stage i % STAGES)
template <int MW>
__device__ __forceinline__ int stage_uses(int n, int st) {
  return n > st ? (n - 1 - st) / Tile<MW>::STAGES + 1 : 0;
}

// A consumer's parked float4 (shared memory): the load is volatile, so that
// the compiler reads it back there and does not keep the value in
// registers across the skip's wgmmas
__device__ __forceinline__ void park_store(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ float4 park_load(uint32_t addr) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The static skip's slices (SK8, in the last split), after its n_conv conv
// slices: each consumer parks its f32 conv sums in the ring's first STAGES -
// 1 stages (float4 k of thread x at k * 256 + x: its own layout, so that it
// reads back what it wrote), runs the skip's int32 sums in the same
// accumulators from the last stage (the first wgmma starts the sums:
// accumulate 0), each skip slice there in turn (the producer's loads), and
// converts them once: skip = (f32(sums) * (wss[n] * sx) + b_skip) + 0, the
// separate skip GEMM's values, as its epilogue made them. Then acc = ((conv
// + b2) + 0) + skip, conv2's epilogue order with that product as its
// residual (the epilogue then adds no bias: the value is never -0, so its
// + 0 + 0 keeps it), or a split's partial conv + skip.
template <int MW>
__device__ __forceinline__ void static_skip(const Plan& p, uint32_t (&acc)[MW][64],
                                            uint32_t ring_u32, uint32_t full0, uint32_t empty0,
                                            int n_conv, int g, int lane, int col0, int n0) {
  using T = Tile<MW>;
  constexpr int SK = T::STAGES - 1;
  const uint32_t park = ring_u32 + 16 * threadIdx.x;  // float4 k at park + 4096 k
  consumer_sync();  // every consumer's conv wgmmas have read the ring
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int k = 0; k < 16; ++k)
      park_store(park + 4096 * (16 * t + k),
                 make_float4(__uint_as_float(acc[t][4 * k]), __uint_as_float(acc[t][4 * k + 1]),
                             __uint_as_float(acc[t][4 * k + 2]),
                             __uint_as_float(acc[t][4 * k + 3])));
  const int used = stage_uses<MW>(n_conv, SK);
  const uint32_t a = ring_u32 + SK * T::STAGE_BYTES + g * MW * (64 * ROW);
  const uint32_t b = ring_u32 + SK * T::STAGE_BYTES + T::A_BYTES;
  for (int j = 0; j < p.skip8; ++j) {
    mbar_wait(full0 + 8 * SK, (used + j) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROW / 32; ++kk) {
      const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
#pragma unroll
      for (int t = 0; t < MW; ++t)
        wgmma_s8_m64n128k32(acc[t], sw128_desc(a + t * (64 * ROW) + 32 * kk, 16, 1024), db,
                            j > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // the next skip slice takes this stage
    if (lane == 0) mbar_arrive(empty0 + 8 * SK);
  }
  const float sx = *p.sx;
  const bool whole = p.splits == 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // a barrier every 2 of the 16 column pairs: no load of a later pair's
    // scales moves above it, so that the scheduler does not run the
    // registers out (hoisted, they spilled at 128-pixel tiles)
    if (j % 2 == 0 && j > 0) consumer_sync();
    float ws[2], bs[2], b2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + col0 + 8 * j + e;
      ws[e] = __fmul_rn(p.wss[n], sx);
      bs[e] = p.bskip != nullptr ? p.bskip[n] : 0.f;
      b2[e] = p.bias != nullptr ? p.bias[n] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < MW; ++t) {
      const float4 c4 = park_load(park + 4096 * (16 * t + j));
      const float conv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t& r = acc[t][4 * j + 2 * h + e];
          const float skip =
              __fadd_rn(__fadd_rn(__fmul_rn(__int2float_rn((int)r), ws[e]), bs[e]), 0.f);
          const float c = conv[2 * h + e];
          r = __float_as_uint(whole ? __fadd_rn(__fadd_rn(__fadd_rn(c, b2[e]), 0.f), skip)
                                    : __fadd_rn(c, skip));
        }
    }
  }
}

// grid (m_tiles, N / 128, splits), THREADS threads, Tile<MW>::SMEM dynamic
// shared memory. Split z runs the slices [z*kper, min((z+1)*kper, slices)):
// first those of the conv (TA), then those of the skip (bf16). STATS (conv1,
// f32 out, K not split): the epilogue also takes GN2's sums. KMAJ (bf16, no
// skip): a dgrad, the weights K-major and tap-reversed. S32 (int8, no skip,
// K split: K11 int8): a split stores its raw int32 sums, which
// block_splitk_s32_kernel adds in int32 before it dequantizes them once.
// SK8 (int8, bf16 out, no residual): the int8 blocks' static skip, p.skip8
// int8 slices of the quantized skip input q(x) (s0map, (M, cs) by 2-D boxes
// of the tile's rows) by the K-major int8 skip weights (wsmap, (N, cs)) after
// the last split's conv slices (static_skip).
template <typename TA, int MW, typename TO, bool STATS, bool KMAJ = false, bool S32 = false,
          bool SK8 = false>
__global__ void __launch_bounds__(THREADS, 3 - MW)
block_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap s0map,
                  const __grid_constant__ CUtensorMap s1map,
                  const __grid_constant__ CUtensorMap wsmap, const Plan p) {
  constexpr bool kInt8 = std::is_same<TA, int8_t>::value;
  constexpr int SLICE_K = ROW / sizeof(TA);  // conv channels of a slice
  using T = Tile<MW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full0 = ring_u32 + T::STAGES * T::STAGE_BYTES;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * T::STAGES;

  const int tb = blockIdx.x / p.tiles_h, th = blockIdx.x % p.tiles_h;
  const int b0 = tb * p.box_b, y0 = th * p.box_h;
  const int m0 = (b0 * p.H + y0) * p.W;  // the tile's rows are the pixels m0, m0 + 1, ...
  const int n0 = blockIdx.y * TILE_N;
  const int s_beg = blockIdx.z * p.kper;
  const int n_sl = min(p.slices, s_beg + p.kper) - s_beg;
  const int n_conv = max(0, min(n_sl, p.conv_slices - s_beg));  // then n_sl - n_conv skip slices
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // the producer: one thread keeps the ring's loads in flight
    if (lane == 0) {
      const uint32_t a_tx = (uint32_t)(p.W * p.box_h * p.box_b * ROW);
      for (int i = 0; i < n_sl; ++i) {
        const int s = i % T::STAGES;
        if (i >= T::STAGES) mbar_wait(empty0 + 8 * s, ((i / T::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t a = ring_u32 + s * T::STAGE_BYTES, b = a + T::A_BYTES;
        if (i < n_conv) {
          mbar_expect_tx(full, a_tx + B_BYTES);
          const int k0 = (s_beg + i) * SLICE_K;
          const int tap = k0 / p.cin, c0 = k0 - tap * p.cin;
          const int dx = p.taps == 9 ? tap % 3 - 1 : 0, dy = p.taps == 9 ? tap / 3 - 1 : 0;
          tma_load_4d(a, &amap, full, c0, dx, y0 + dy, b0);
          if constexpr (kInt8)
            tma_load_2d(b, &wmap, full, k0, n0);
          else if constexpr (KMAJ)  // W[8 - tap]'s (N, K) plane: rows (tap, n), K along the row
            tma_load_2d(b, &wmap, full, c0, (p.taps == 9 ? 8 - tap : 0) * p.N + n0);
          else
            load_nmajor(b, &wmap, full, n0, k0);
        } else {
          // 64 skip channels: the tile's rows of s0 or s1, and their weights
          mbar_expect_tx(full, T::A_BYTES + B_BYTES);
          const int j = s_beg + i - p.conv_slices;
          if (j < p.skip0_slices)
            tma_load_2d(a, &s0map, full, 64 * j, m0);
          else
            tma_load_2d(a, &s1map, full, 64 * (j - p.skip0_slices), m0);
          load_nmajor(b, &wsmap, full, n0, 64 * j);
        }
      }
      if constexpr (SK8) {
        // the static skip's slices, each in the ring's last stage in turn
        constexpr int SK = T::STAGES - 1;
        const int used = stage_uses<MW>(n_sl, SK);
        const uint32_t full = full0 + 8 * SK, a = ring_u32 + SK * T::STAGE_BYTES;
        for (int j = 0; blockIdx.z == gridDim.z - 1 && j < p.skip8; ++j) {
          if (used + j > 0) mbar_wait(empty0 + 8 * SK, (used + j - 1) & 1);
          mbar_expect_tx(full, T::A_BYTES + B_BYTES);
          tma_load_2d(a, &s0map, full, ROW * j, m0);
          tma_load_2d(a + T::A_BYTES, &wsmap, full, ROW * j, n0);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g owns the tile's m64 blocks g * MW + t, in
  // one set of accumulators (int8: s32 sums, then in place f32)
  const int g = warp >> 2;
  uint32_t acc[MW][64];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[t][j] = 0u;  // 0 and 0.0f alike

  int i = 0;  // the slice; int8 conv slices first, then the bf16 ones
  if constexpr (kInt8) {
    for (; i < n_conv; ++i) {
      const int s = i % T::STAGES;
      mbar_wait(full0 + 8 * s, (i / T::STAGES) & 1);
      const uint32_t a = ring_u32 + s * T::STAGE_BYTES + g * MW * (64 * ROW);
      const uint32_t b = ring_u32 + s * T::STAGE_BYTES + T::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROW / 32; ++kk) {
        // A and B alike: rows of 128 bytes, 8-row atoms 1 KB apart; a k32
        // step is 32 bytes into the row
        const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
#pragma unroll
        for (int t = 0; t < MW; ++t)
          wgmma_s8_m64n128k32(acc[t], sw128_desc(a + t * (64 * ROW) + 32 * kk, 16, 1024), db);
      }
      wgmma_commit();
      // the previous slice's group has completed: free its stage
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % T::STAGES));
    }
    wgmma_wait<0>();
    if (n_conv > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((n_conv - 1) % T::STAGES));
  }

  // Accumulator layout: register 4j + 2h + e holds row 16 (warp % 4) +
  // lane / 4 + 8 h of its m64 block, column 8 j + 2 (lane % 4) + e.
  const int hw = p.H * p.W;
  const int row0 = 16 * (warp & 3) + (lane >> 2), col0 = 2 * (lane & 3);
  int rows[MW][2];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[t][h] = tile_row(p, b0, y0, 64 * (g * MW + t) + row0 + 8 * h);

  if constexpr (S32) {
    // this split's int32 sums as they are (the accumulators before the
    // in-place conversion): a sum of int32 partials is the whole K's sum,
    // whatever the split, where f32 partials round past 2^24
    int* part = reinterpret_cast<int*>(p.partial);
    const long M = (long)p.B * hw;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int t = 0; t < MW; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = rows[t][h];
          if (m >= 0)
            *reinterpret_cast<int2*>(part + (blockIdx.z * M + m) * p.N + n0 + col0 + 8 * j) =
                make_int2((int)acc[t][4 * j + 2 * h], (int)acc[t][4 * j + 2 * h + 1]);
        }
    return;
  }

  if constexpr (kInt8) {
    // the int32 sums to f32 in place, times (w_scale[n] * s) of the row's
    // scale; column-outer, so that a weight scale is loaded once for the
    // thread's 2 MW rows
    float srow[MW][2];
#pragma unroll
    for (int t = 0; t < MW; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rows[t][h];
        srow[t][h] = p.qs != nullptr ? *p.qs
                     : m < 0          ? 0.f
                     : p.asc != nullptr ? p.asc[m / hw]
                                        : fmaxf(p.amax[m / hw], 1e-12f) / 127.0f;
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
  }

  // the bf16 slices (the conv's in the bf16 mode, then the skip's), f32
  // products into the same accumulators
  const int i_bf16 = i;
  for (; i < n_sl; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(full0 + 8 * s, (i / T::STAGES) & 1);
    const uint32_t a = ring_u32 + s * T::STAGE_BYTES + g * MW * (64 * ROW);
    const uint32_t b = ring_u32 + s * T::STAGE_BYTES + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: rows of 128 bytes, 8-row atoms 1 KB apart, a k16 step 32 bytes
      // into the row. B: K rows of 128 bytes (64 N), the second 64 N
      // columns 8 KB on (the leading offset), 8-row K atoms 1 KB apart; a
      // k16 step is 16 rows. KMAJ: B as A, N rows of 128 bytes (64 K)
      const uint64_t db = KMAJ ? sw128_desc(b + 32 * kk, 16, 1024)
                               : sw128_desc(b + 2048 * kk, B_BYTES / 2, 1024);
#pragma unroll
      for (int t = 0; t < MW; ++t)
        wgmma_m64n128k16_b32<0, KMAJ ? 0 : 1>(
            acc[t], sw128_desc(a + t * (64 * ROW) + 32 * kk, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > i_bf16 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % T::STAGES));
  }
  wgmma_wait<0>();

  if constexpr (SK8) {
    if (blockIdx.z == gridDim.z - 1)
      static_skip<MW>(p, acc, ring_u32, full0, empty0, n_conv, g, lane, col0, n0);
    if (p.splits == 1) {
      tile_epilogue<MW, TO, false, false>(p, acc, ring, g, row0, col0, b0, y0, n0);
      return;
    }
  } else if (p.splits == 1) {
    tile_epilogue<MW, TO, STATS>(p, acc, ring, g, row0, col0, b0, y0, n0);
    return;
  }
  // a split's f32 partial, straight from the accumulators
  const long M = (long)p.B * hw;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int t = 0; t < MW; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rows[t][h];
        if (m >= 0)
          store2(p.partial + (blockIdx.z * M + m) * p.N + n0 + col0 + 8 * j,
                 __uint_as_float(acc[t][4 * j + 2 * h]),
                 __uint_as_float(acc[t][4 * j + 2 * h + 1]));
      }
}

// Split-K reduction: the f32 partials summed in split order, then the
// epilogue. grid ceil(M*N/2 / 256), 256 threads, 2 channels each.
template <typename TO>
__global__ void __launch_bounds__(256) block_splitk_kernel(const Plan p) {
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
  const float2 cb = bias2(p, n);
  epilogue2<TO>(p, v / p.N, n, r.x + cb.x, r.y + cb.y);
}

// The split-K reduction of conv1 (gn_part): the same sums in split order,
// the epilogue, and GN2's sums of one sample's rows of an M tile. grid
// (m_tiles, N / 32, box_b), 256 threads: 8 groups of 4 columns by 32 row
// lanes; each row's splits loaded 4 at a time (so that the loads overlap)
// and added in order; the row lanes' sums added in lane order.
template <typename TO>
__global__ void __launch_bounds__(256) block_splitk_stats_kernel(const Plan p) {
  __shared__ float red[2][32][33];
  const long mn = (long)p.B * p.H * p.W * p.N;
  const int tb = blockIdx.x / p.tiles_h, th = blockIdx.x % p.tiles_h, i = blockIdx.z;
  const int b0 = tb * p.box_b, y0 = th * p.box_h;
  if (b0 + i >= p.B) return;  // uniform over the CTA
  const int cq = threadIdx.x & 7, lr = threadIdx.x >> 3;
  const int c = 4 * cq, n = blockIdx.y * 32 + c;
  const int hw = p.H * p.W, m0 = (b0 * p.H + y0) * p.W;
  const int per = p.box_b == 1 ? 128 * p.mw : hw;  // tile rows a sample
  const int valid = p.box_b == 1 ? min(p.box_h, p.H - y0) * p.W : (i + 1) * hw;
  const float2 cb0 = bias2(p, n), cb1 = bias2(p, n + 2);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = i * per + lr; r < valid; r += 32) {
    const long o = (long)(m0 + r) * p.N + n;
    float4 a = *reinterpret_cast<const float4*>(p.partial + o);
    for (int z = 1; z < p.splits; z += 4) {
      float4 d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (z + k < p.splits) d[k] = *reinterpret_cast<const float4*>(p.partial + (z + k) * mn + o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (z + k < p.splits) {
          a.x += d[k].x;
          a.y += d[k].y;
          a.z += d[k].z;
          a.w += d[k].w;
        }
    }
    const float2 v01 = epilogue2<TO>(p, m0 + r, n, a.x + cb0.x, a.y + cb0.y);
    const float2 v23 = epilogue2<TO>(p, m0 + r, n + 2, a.z + cb1.x, a.w + cb1.y);
    const float v[4] = {v01.x, v01.y, v23.x, v23.y};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] += v[k];
      q[k] += v[k] * v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    red[0][lr][c + k] = s[k];
    red[1][lr][c + k] = q[k];
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    const int which = threadIdx.x >> 5, col = threadIdx.x & 31;
    float a = 0.f;
    for (int l = 0; l < 32; ++l) a += red[which][l][col];
    gn_row(p, which, b0 + i, th)[blockIdx.y * 32 + col] = a;
  }
}

// K11 int8's split-K reduction: the int32 partials added in int32 (exact,
// in any order), then the unsplit tile's arithmetic: the sum converted to
// f32 once, times (wsc[n] * asc[b]), plus the bias, rounded once to bf16 or
// stored as f32 (TO), each operation rounded on its own as the plain
// version's. grid ceil(M*N/2 / 256), 256 threads, 2 channels each.
template <typename TO>
__global__ void __launch_bounds__(256) block_splitk_s32_kernel(const Plan p) {
  const long mn = (long)p.B * p.H * p.W * p.N;
  const long v = ((long)blockIdx.x * 256 + threadIdx.x) * 2;
  if (v >= mn) return;
  const int* part = reinterpret_cast<const int*>(p.partial);
  int2 r = *reinterpret_cast<const int2*>(part + v);
  for (int z = 1; z < p.splits; ++z) {
    const int2 a = *reinterpret_cast<const int2*>(part + z * mn + v);
    r.x += a.x;
    r.y += a.y;
  }
  const int n = (int)(v % p.N);
  const float s = p.asc[v / p.N / (p.H * p.W)];
  const float2 cb = bias2(p, n);
  store2((TO*)p.out + v,
         __fadd_rn(__fmul_rn(__int2float_rn(r.x), __fmul_rn(p.wsc[n], s)), cb.x),
         __fadd_rn(__fmul_rn(__int2float_rn(r.y), __fmul_rn(p.wsc[n + 1], s)), cb.y));
}

template <typename TA, int MW, typename TO, bool STATS = false, bool KMAJ = false,
          bool S32 = false, bool SK8 = false>
int launch(dim3 grid, const CUtensorMap* maps, const Plan& p, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(
        block_gemm_kernel<TA, MW, TO, STATS, KMAJ, S32, SK8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<MW>::SMEM);
    if (err) return err;
    attr = true;
  }
  block_gemm_kernel<TA, MW, TO, STATS, KMAJ, S32, SK8><<<grid, THREADS, Tile<MW>::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  int err = (int)cudaGetLastError();
  if (!err) {
    count_launch(std::is_same<TA, int8_t>::value ? COUNT_GEMM_S8
                 : p.train                       ? COUNT_GEMM_TRAIN
                                                 : COUNT_GEMM_BF16);
    if (SK8) count_launch(COUNT_STATIC_SKIP);
  }
  if (!err && p.splits > 1) {
    if constexpr (S32) {
      const long vecs = (long)p.B * p.H * p.W * p.N / 2;
      block_splitk_s32_kernel<TO><<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(p);
    } else if (p.gn_part != nullptr) {
      block_splitk_stats_kernel<TO><<<dim3(grid.x, p.N / 32, p.box_b), 256, 0, st>>>(p);
    } else {
      const long vecs = (long)p.B * p.H * p.W * p.N / 2;
      block_splitk_kernel<TO><<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(p);
    }
    err = (int)cudaGetLastError();
  }
  return err;
}

template <typename TA>
int launch_mw(int mw, bool out_f32, dim3 grid, const CUtensorMap* maps, const Plan& p,
              cudaStream_t st) {
  if constexpr (std::is_same<TA, bf16>::value) {
    if (p.kmajor)  // a dgrad: f32 out, no skip, no statistics
      return mw == 1 ? launch<bf16, 1, float, false, true>(grid, maps, p, st)
                     : launch<bf16, 2, float, false, true>(grid, maps, p, st);
  } else {
    // K11 int8 with K split (bf16 or f32 out, 128-pixel tiles: a plan of
    // 256-pixel tiles fills the card unsplit): the int32 partials
    if (p.asc != nullptr && p.splits > 1)
      return out_f32 ? launch<int8_t, 1, float, false, false, true>(grid, maps, p, st)
                     : launch<int8_t, 1, bf16, false, false, true>(grid, maps, p, st);
    // the static skip's conv2: bf16 out, the skip's int8 slices after the conv's
    if (p.skip8 > 0)
      return mw == 1 ? launch<int8_t, 1, bf16, false, false, false, true>(grid, maps, p, st)
                     : launch<int8_t, 2, bf16, false, false, false, true>(grid, maps, p, st);
  }
  if (p.gn_part != nullptr && p.splits == 1)  // GN2's sums in the epilogue (f32 out)
    return mw == 1 ? launch<TA, 1, float, true>(grid, maps, p, st)
                   : launch<TA, 2, float, true>(grid, maps, p, st);
  if (mw == 1)
    return out_f32 ? launch<TA, 1, float>(grid, maps, p, st) : launch<TA, 1, bf16>(grid, maps, p, st);
  return out_f32 ? launch<TA, 2, float>(grid, maps, p, st) : launch<TA, 2, bf16>(grid, maps, p, st);
}

}  // namespace

void count_launch(Counted kernel) { ++launch_counts[kernel]; }

int block_gemm_launch(const BlockGemm& g, const GemmTiles& t, cudaStream_t st) {
  const int slice_k = g.int8 ? ROW : ROW / 2;  // conv channels of a slice
  const bool sk8 = g.wss != nullptr;  // the static skip: int8 slices, not in the split plan
  const int cskip = g.s0 && !sk8 ? g.cs0 + g.cs1 : 0;
  const int conv_slices = g.taps * g.cin / slice_k;
  const int slices = conv_slices + cskip / 64;
  const int bm = 128 * t.mw;
  if ((g.taps != 1 && g.taps != 9) || g.cin % slice_k || g.N % TILE_N ||
      (g.s0 && (g.cs0 % 64 || g.cs1 % 64 || g.ws == nullptr)) || g.W > 256 || t.box_h < 1 ||
      t.box_b < 1 || t.box_h > 256 || t.box_b > 256 || (t.mw != 1 && t.mw != 2) ||
      g.W * t.box_h * t.box_b > bm || g.splits < 1 || g.kper < 1 ||
      (g.splits - 1) * g.kper >= slices || g.splits * g.kper < slices ||
      (g.splits > 1 && g.partial == nullptr) ||
      (g.int8 && (g.wsc == nullptr || (g.qs == nullptr && g.amax == nullptr && g.asc == nullptr))) ||
      // K11 int8's scales: int8, no skip, residual, temb or statistics
      (g.asc != nullptr && (!g.int8 || g.qs != nullptr || g.s0 || g.resid ||
                            g.temb || g.gn_part != nullptr || (g.splits > 1 && t.mw != 1))) ||
      // the static skip: int8, bf16 out, q(x) in s0 alone (128-channel slices), no
      // residual, statistics or K11 scales
      (sk8 && (!g.int8 || g.s0 == nullptr || g.s1 != nullptr || g.cs0 < ROW || g.cs0 % ROW ||
               g.sx == nullptr || g.resid != nullptr || g.out_f32 || g.gn_part != nullptr ||
               g.asc != nullptr)) ||
      // a dgrad: bf16, f32 out, no skip, no statistics
      (g.w_kmajor && (g.int8 || !g.out_f32 || g.s0 || g.gn_part != nullptr)) ||
      // GN2's sums: f32 out with no residual (conv1), a warp's 16 rows one sample's
      (g.gn_part != nullptr &&
       (!g.out_f32 || g.resid != nullptr || (t.box_b > 1 && (g.H * g.W) % 16))))
    return (int)cudaErrorInvalidValue;
  const long m = (long)g.B * g.H * g.W;
  Plan p;
  p.B = g.B;
  p.H = g.H;
  p.W = g.W;
  p.N = g.N;
  p.cin = g.cin;
  p.taps = g.taps;
  p.mw = t.mw;
  p.box_h = t.box_h;
  p.box_b = t.box_b;
  p.tiles_h = t.tiles_h;
  p.conv_slices = conv_slices;
  p.skip0_slices = cskip ? g.cs0 / 64 : 0;
  p.skip8 = sk8 ? g.cs0 / ROW : 0;
  p.wss = g.wss;
  p.sx = g.sx;
  p.bskip = sk8 ? g.bias2 : nullptr;
  p.slices = slices;
  p.kper = g.kper;
  p.splits = g.splits;
  p.wsc = g.wsc;
  p.qs = g.qs;
  p.amax = g.amax;
  p.asc = g.asc;
  p.bias = g.bias;
  p.bias2 = sk8 ? nullptr : g.bias2;  // the static skip adds b_skip to its own product
  p.temb = g.temb;
  p.temb_ld = g.temb_ld;
  p.resid = g.resid;
  p.out_scale = g.out_scale;
  p.out = g.out;
  p.partial = g.partial;
  p.gn_part = g.gn_part;
  p.kmajor = g.w_kmajor;
  p.train = g.train || g.w_kmajor;

  // maps: A, W, skip s0, skip s1, skip weights (unused ones stay zero)
  CUtensorMap maps[5] = {};
  const cuuint64_t es = g.int8 ? 1 : 2;  // bytes of a conv operand
  const cuuint64_t adims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint64_t astrides[3] = {g.cin * es, g.W * g.cin * es, g.H * g.W * g.cin * es};
  const cuuint32_t abox[4] = {(cuuint32_t)slice_k, (cuuint32_t)g.W, (cuuint32_t)t.box_h,
                              (cuuint32_t)t.box_b};
  const cuuint32_t nbox[2] = {64, 64};  // an N-major bf16 weight box
  bool ok;
  if (g.int8) {
    const cuuint64_t wdims[2] = {(cuuint64_t)g.taps * g.cin, (cuuint64_t)g.N};
    const cuuint64_t wstrides[1] = {(cuuint64_t)g.taps * g.cin};
    const cuuint32_t wbox[2] = {ROW, TILE_N};
    ok = sw128_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.a, 4, adims, astrides, abox) &&
         sw128_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.w, 2, wdims, wstrides, wbox);
  } else if (g.w_kmajor) {  // rows (tap, n) of cin channels: the forward's (N, K) planes
    const cuuint64_t wdims[2] = {(cuuint64_t)g.cin, (cuuint64_t)g.taps * g.N};
    const cuuint64_t wstrides[1] = {(cuuint64_t)g.cin * 2};
    const cuuint32_t kbox[2] = {64, TILE_N};
    ok = bf16_map(&maps[0], g.a, 4, adims, astrides, abox) &&
         bf16_map(&maps[1], g.w, 2, wdims, wstrides, kbox);
  } else {
    const cuuint64_t wdims[2] = {(cuuint64_t)g.N, (cuuint64_t)g.taps * g.cin};
    const cuuint64_t wstrides[1] = {(cuuint64_t)g.N * 2};
    ok = bf16_map(&maps[0], g.a, 4, adims, astrides, abox) &&
         bf16_map(&maps[1], g.w, 2, wdims, wstrides, nbox);
  }
  if (ok && sk8) {  // q(x) (M, cs0) int8 by boxes of the tile's rows; its weights K-major
    const cuuint64_t qdims[2] = {(cuuint64_t)g.cs0, (cuuint64_t)m};
    const cuuint64_t qstrides[1] = {(cuuint64_t)g.cs0};
    const cuuint32_t qbox[2] = {ROW, (cuuint32_t)bm};
    const cuuint64_t wsdims[2] = {(cuuint64_t)g.cs0, (cuuint64_t)g.N};
    const cuuint32_t wsbox[2] = {ROW, TILE_N};
    ok = sw128_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.s0, 2, qdims, qstrides, qbox) &&
         sw128_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.ws, 2, wsdims, qstrides, wsbox);
  } else if (ok && g.s0) {
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
    ok = ok && bf16_map(&maps[4], g.ws, 2, wsdims, wsstrides, nbox);
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  const dim3 grid(t.m_tiles, g.N / TILE_N, g.splits);
  return g.int8 ? launch_mw<int8_t>(t.mw, g.out_f32, grid, maps, p, st)
                : launch_mw<bf16>(t.mw, g.out_f32, grid, maps, p, st);
}

extern "C" {

// The bare int8 conv of the block GEMM: out (B, H, W, N) f32 = conv(a8, w)
// * (wsc[n] * *qs), a 3x3 SAME conv (taps 9) or a 1x1 (taps 1), a8 (B, H, W,
// Cin) int8, wk (N, taps * Cin) int8 K-major, wsc (N,) and qs () f32 on the
// device; the tile plan as gddim_resblock_int8 takes it. With wsc and qs
// ones, out holds the int32 sums (exact in f32 up to 2^24). Scratch `work`:
// splits * M * N f32 when splits > 1. gn_part (2, B, tiles_h, N) f32, or
// null: the epilogue's per-channel sums and squares of out (GN2's partials).
int gddim_conv_s8(const void* a8, const void* wk, const void* wsc, const void* qs, int batch,
                  int h, int w, int cin, int n, int taps, int mw, int box_h, int box_b,
                  int tiles_h, int m_tiles, int splits, int kper, void* work, void* gn_part,
                  void* out, void* stream) {
  BlockGemm g = {};
  g.int8 = true;
  g.taps = taps;
  g.a = a8;
  g.w = wk;
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
  g.gn_part = (float*)gn_part;
  g.splits = splits;
  g.kper = kper;
  return block_gemm_launch(g, GemmTiles{mw, box_h, box_b, tiles_h, m_tiles},
                           (cudaStream_t)stream);
}

// K11 int8 on the block GEMM: out (B, H, W, N) = conv3x3(x8, wk) * (wsc[n] *
// asc[b]) + bias[n] (bias may be null), bf16 or, with out_f32, f32 (stored
// as computed: the f32 model's layer-wise int8 path), the int32 sums of all
// 9 taps converted to f32 once, each operation rounded as the plain version's
// (ops/conv3x3.py:conv3x3_int8_reference). x8 (B, H, W, Cin) int8, wk (N, 9
// * Cin) int8 K-major (ops/resblock.py:pack_int8_weight), wsc (N,) and asc
// (B,) f32; the tile plan of ops/resblock.py:s8_tile_plan(B, H, W, Cin, 0,
// N). Scratch `work`: splits * M * N int32 when splits > 1 (mw 1).
int gddim_conv3x3_int8(const void* x8, const void* wk, const void* wsc, const void* asc,
                       const void* bias, int batch, int h, int w, int cin, int n, int mw,
                       int box_h, int box_b, int tiles_h, int m_tiles, int splits, int kper,
                       int out_f32, void* work, void* out, void* stream) {
  BlockGemm g = {};
  g.int8 = true;
  g.taps = 9;
  g.a = x8;
  g.w = wk;
  g.cin = cin;
  g.B = batch;
  g.H = h;
  g.W = w;
  g.N = n;
  g.wsc = (const float*)wsc;
  g.asc = (const float*)asc;
  g.bias = (const float*)bias;
  g.out_scale = 1.0f;
  g.out = out;
  g.out_f32 = out_f32 != 0;
  g.partial = (float*)work;
  g.splits = splits;
  g.kper = kper;
  return block_gemm_launch(g, GemmTiles{mw, box_h, box_b, tiles_h, m_tiles},
                           (cudaStream_t)stream);
}

// The bare bf16 conv of the block GEMM: out (B, H, W, N) f32 = conv(a, w),
// a 3x3 SAME conv (taps 9) or a 1x1 (taps 1), a (B, H, W, Cin) bf16, w
// (taps * Cin, N) bf16 (HWIO flattened), f32 sums; the tile plan as
// gddim_resblock takes it (ops/resblock.py:bf16_tile_plan). Scratch `work`:
// splits * M * N f32 when splits > 1; gn_part as gddim_conv_s8's.
int gddim_conv_bf16(const void* a, const void* w, int batch, int h, int w_, int cin, int n,
                    int taps, int mw, int box_h, int box_b, int tiles_h, int m_tiles, int splits,
                    int kper, void* work, void* gn_part, void* out, void* stream) {
  BlockGemm g = {};
  g.taps = taps;
  g.a = a;
  g.w = w;
  g.cin = cin;
  g.B = batch;
  g.H = h;
  g.W = w_;
  g.N = n;
  g.out_scale = 1.0f;
  g.out = out;
  g.out_f32 = true;
  g.partial = (float*)work;
  g.gn_part = (float*)gn_part;
  g.splits = splits;
  g.kper = kper;
  return block_gemm_launch(g, GemmTiles{mw, box_h, box_b, tiles_h, m_tiles},
                           (cudaStream_t)stream);
}

// The bare dgrad of the block GEMM (K7's): out (B, H, W, N) f32 = the 3x3
// SAME conv of g (B, H, W, Cin) bf16 with the taps flipped and (Cin, Cout)
// swapped, read from the forward's HWIO weights w (3, 3, N, Cin) bf16 as they
// are (taps 9), or g @ w^T for a 1x1 w (N, Cin) (taps 1); f32 sums. The tile
// plan as gddim_conv_bf16 takes it (bf16_tile_plan of the dgrad: Cin in,
// N out); scratch `work`: splits * M * N f32 when splits > 1.
int gddim_dgrad_bf16(const void* g_, const void* w, int batch, int h, int w_, int cin, int n,
                     int taps, int mw, int box_h, int box_b, int tiles_h, int m_tiles, int splits,
                     int kper, void* work, void* out, void* stream) {
  BlockGemm g = {};
  g.taps = taps;
  g.a = g_;
  g.w = w;
  g.w_kmajor = true;
  g.cin = cin;
  g.B = batch;
  g.H = h;
  g.W = w_;
  g.N = n;
  g.out_scale = 1.0f;
  g.out = out;
  g.out_f32 = true;
  g.partial = (float*)work;
  g.splits = splits;
  g.kper = kper;
  return block_gemm_launch(g, GemmTiles{mw, box_h, box_b, tiles_h, m_tiles},
                           (cudaStream_t)stream);
}

// Launches of the kernels counted in C (conv.cuh's Counted order: the int8
// GEMM, the int8 pre-pass, the bf16 GEMM, the bf16 pre-pass, K5's attention
// core, the GroupNorm statistics, the GN1 kernel, the wgrad kernel, K1's
// kernel, the training blocks' block GEMM, the GN backward, GN2's pre-pass,
// K8's online-softmax kernel, the int8 conv2 GEMMs that carry the static
// skip, the f32 online kernel's split pre-pass) into out
// (N_COUNTED long long); with reset, zeroed after reading.
int gddim_block_launches(long long* out, int reset) {
  for (int k = 0; k < N_COUNTED; ++k) {
    out[k] = launch_counts[k];
    if (reset) launch_counts[k] = 0;
  }
  return 0;
}

}  // extern "C"
