// K11: the stride-1 SAME 3x3 convolution of the layer-wise inference paths
// (conv_impl 'pallas' and 'int8'), NHWC activations, HWIO weights, for
// Hopper (sm_90a).
//
// Replaces gddim_tpu/ops/conv3x3.py: conv3x3_pallas (_conv_kernel, nine
// shifted matmuls with f32 sums, out in x's dtype) and conv3x3_pallas_int8
// (_conv_kernel_int8, s8 x s8 -> s32 sums, dequantized as
// acc * (s_a[b] * s_w[c]) + bias in f32, out bf16).
//
//   gddim_conv3x3       bf16: the implicit-GEMM conv of the residual-block
//                       kernels (conv_gemm_kernel, resblock.cu) with no GN
//                       prologue and no epilogue terms: f32 sums of exact
//                       bf16 products, rounded once to bf16 (split-K sums f32
//                       partials in split order first).
//   gddim_conv3x3_int8  conv3x3_s8_kernel: int8 A read straight from memory
//                       (the activation arrives quantized, from K12 or
//                       quantize_per_sample), int8 W, WMMA s8 16x16x16 into
//                       one int32 accumulator set. A split of split-K writes
//                       its int32 partial and the reduction adds them in
//                       int32, so the sum is exact whatever the split; the
//                       epilogue converts it to f32 once, multiplies by
//                       (s_a[b] * s_w[c]) and adds the bias with no fused
//                       multiply-add, which is the plain version's rounding.
//
// What bounds it on the H100: at 32x32 and 16x16 the products (2*M*9*Cin*Cout
// against M*(Cin+Cout) activation bytes and 9*Cin*Cout weight bytes) put it
// above the ridge, so the tensor cores bound it; at 8x8 and 4x4 M = B*H*W is a
// few hundred rows, each weight byte feeds ~M operations, and the weights'
// bytes and the launch bound it. This first form is right, not fast: a
// 64x64 tile (int8: K slices of 64) double-buffered through registers, as
// conv_gemm_kernel is, with split-K for small grids. wgmma fed by TMA is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // output tile M x N, K slice of int8 values
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int LDC = BN + 4;
constexpr int TARGET_BLOCKS = 4 * 132;  // four resident blocks on each of 132 SMs
constexpr int MIN_SPLIT_SLICES = 4;     // K slices per split, at least

void s8_split_plan(long m, int n, int k, int* splits, int* kper) {
  const long blocks = ((m + BM - 1) / BM) * (n / BN);
  const int slices = k / BK;
  long s = (TARGET_BLOCKS + blocks - 1) / blocks;
  if (s > slices / MIN_SPLIT_SLICES) s = slices / MIN_SPLIT_SLICES;
  if (s < 1) s = 1;
  const int per = (int)((slices + s - 1) / s);
  *kper = per * BK;
  *splits = (slices + per - 1) / per;
}

struct S8Conv {
  const int8_t* x;    // (B, H, W, C)
  const int8_t* w;    // (9*C, N), HWIO flattened
  const float* wsc;   // (N,) weight scales
  const float* asc;   // (B,) activation scales
  const float* bias;  // (N,) or null
  int B, H, W, C, N;
  int splits, kper;
  int* partial;  // (splits, M, N) int32 partial sums, when splits > 1
  __nv_bfloat16* out;
};

// One thread's share of a K slice: 16 int8 activations of two A rows and 16
// int8 weights of two K rows (64 rows x 4 chunks of 16 each).
struct Stage {
  uint4 a[2];
  uint4 b[2];
};

__device__ __forceinline__ void load_stage(const S8Conv& p, int m0, int n0, int k0, Stage& st) {
  const int hw = p.H * p.W;
  const int M = p.B * hw;
  const int tap = k0 / p.C;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int c0 = k0 - tap * p.C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + THREADS * i;
    const int row = v >> 2, chunk = v & 3;
    const int m = m0 + row;
    st.a[i] = make_uint4(0u, 0u, 0u, 0u);  // padding taps and rows past M are zero
    if (m < M) {
      const int b = m / hw, rem = m - b * hw;
      const int y = rem / p.W + dy, x = rem % p.W + dx;
      if (y >= 0 && y < p.H && x >= 0 && x < p.W)
        st.a[i] = *reinterpret_cast<const uint4*>(
            p.x + (((long)b * p.H + y) * p.W + x) * p.C + c0 + chunk * 16);
    }
    st.b[i] = *reinterpret_cast<const uint4*>(p.w + (long)(k0 + row) * p.N + n0 + chunk * 16);
  }
}

// The tiles keep each 16-wide K (A) or N (B) chunk as its own array of
// 16-byte rows, so every WMMA fragment starts 256-byte aligned.
__device__ __forceinline__ void store_stage(const Stage& st, int8_t (*As)[BM][16],
                                            int8_t (*Bs)[BK][16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + THREADS * i;
    const int row = v >> 2, chunk = v & 3;
    *reinterpret_cast<uint4*>(&As[chunk][row][0]) = st.a[i];
    *reinterpret_cast<uint4*>(&Bs[chunk][row][0]) = st.b[i];
  }
}

// acc * (s_a[b] * s_w[n]) + bias for 8 consecutive output channels, bf16 out
__device__ __forceinline__ void epilogue8(const S8Conv& p, int m, int n, const int r[8]) {
  const float sa = p.asc[m / (p.H * p.W)];
  __align__(16) __nv_bfloat16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f = __fmul_rn(__int2float_rn(r[j]), __fmul_rn(sa, p.wsc[n + j]));
    if (p.bias) f = __fadd_rn(f, p.bias[n + j]);
    o[j] = __float2bfloat16_rn(f);
  }
  *reinterpret_cast<uint4*>(p.out + (long)m * p.N + n) = *reinterpret_cast<const uint4*>(o);
}

constexpr int SMEM_TILES = 2 * (BK / 16) * BM * 16 + 2 * (BN / 16) * BK * 16;
constexpr int SMEM_SUMS = BM * LDC * 4;
constexpr int SMEM = SMEM_TILES > SMEM_SUMS ? SMEM_TILES : SMEM_SUMS;

// grid (ceil(M/BM), N/BN, splits), THREADS threads: 4 warps in 2x2, 32x32
// each. Split z accumulates the K slices [z*kper, (z+1)*kper); the next
// slice's loads are in flight in registers during the current slice's MMAs.
__global__ void __launch_bounds__(THREADS) conv3x3_s8_kernel(const S8Conv p) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  auto As = reinterpret_cast<int8_t(*)[BK / 16][BM][16]>(smem);
  auto Bs = reinterpret_cast<int8_t(*)[BN / 16][BK][16]>(smem + 2 * (BK / 16) * BM * 16);
  auto Cs = reinterpret_cast<int(*)[LDC]>(smem);

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int kbeg = blockIdx.z * p.kper;
  const int kend = min(9 * p.C, kbeg + p.kper);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  Stage st;
  load_stage(p, m0, n0, kbeg, st);
  store_stage(st, As[0], Bs[0]);
  __syncthreads();
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < kend;
    if (more) load_stage(p, m0, n0, k0 + BK, st);
#pragma unroll
    for (int kh = 0; kh < BK / 16; ++kh) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[buf][kh][wm + 16 * i][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][(wn >> 4) + j][16 * kh][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other buffer was last read before the previous iteration's barrier
    if (more) store_stage(st, As[buf ^ 1], Bs[buf ^ 1]);
    __syncthreads();
  }

  // the loop ends on a barrier, so the tiles are free for the sums
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const int M = p.B * p.H * p.W;
  for (int v = threadIdx.x; v < BM * BN / 8; v += THREADS) {
    const int row = v / (BN / 8);
    const int col = (v % (BN / 8)) * 8;
    const int m = m0 + row;
    if (m >= M) continue;
    int r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = Cs[row][col + j];
    if (p.splits > 1) {
      int4* dst = reinterpret_cast<int4*>(p.partial + ((long)blockIdx.z * M + m) * p.N + n0 + col);
      dst[0] = make_int4(r[0], r[1], r[2], r[3]);
      dst[1] = make_int4(r[4], r[5], r[6], r[7]);
    } else {
      epilogue8(p, m, n0 + col, r);
    }
  }
}

// Split-K reduction: adds the int32 partials (exact), then the epilogue.
// grid ceil(M*N/8 / 256), 256 threads, 8 channels each.
__global__ void __launch_bounds__(256) s8_splitk_kernel(const S8Conv p) {
  const long M = (long)p.B * p.H * p.W;
  const long v = (long)blockIdx.x * 256 + threadIdx.x;
  if (v >= M * p.N / 8) return;
  const long m = v / (p.N / 8);
  const int n = (int)(v % (p.N / 8)) * 8;
  int r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int z = 0; z < p.splits; ++z) {
    const int4* src = reinterpret_cast<const int4*>(p.partial + ((long)z * M + m) * p.N + n);
    const int4 a = src[0], b = src[1];
    r[0] += a.x; r[1] += a.y; r[2] += a.z; r[3] += a.w;
    r[4] += b.x; r[5] += b.y; r[6] += b.z; r[7] += b.w;
  }
  epilogue8(p, (int)m, n, r);
}

}  // namespace

extern "C" {

long long gddim_conv3x3_workspace(int batch, int h, int w, int cin, int n) {
  int splits, kper;
  const long m = (long)batch * h * w;
  conv_split_plan(m, n, 9 * cin, &splits, &kper);
  return splits > 1 ? (long long)sizeof(float) * splits * m * n : 0;
}

// K11 bf16: out (B, H, W, N) bf16 = conv3x3(x (B, H, W, Cin) bf16, w (3, 3,
// Cin, N) bf16), f32 sums. Cin a multiple of 32, N of 64. Scratch from
// `work`, gddim_conv3x3_workspace bytes.
int gddim_conv3x3(const void* x, const void* w, int batch, int h, int w_, int cin, int n,
                  void* work, void* out, void* stream) {
  if (cin % CONV_BK || n % CONV_BN) return (int)cudaErrorInvalidValue;
  int splits, kper;
  conv_split_plan((long)batch * h * w_, n, 9 * cin, &splits, &kper);
  const ConvArgs p = conv_args(x, cin, nullptr, nullptr, 0, 9, w, batch, h, w_, n, nullptr, 1.0f,
                               out, (float*)work, splits, kper);
  return conv_gemm_launch(p, false, (cudaStream_t)stream);
}

long long gddim_conv3x3_int8_workspace(int batch, int h, int w, int cin, int n) {
  int splits, kper;
  const long m = (long)batch * h * w;
  s8_split_plan(m, n, 9 * cin, &splits, &kper);
  return splits > 1 ? (long long)sizeof(int) * splits * m * n : 0;
}

// K11 int8: out (B, H, W, N) bf16 = conv3x3(x8, w8) * (asc[b] * wsc[n]) +
// bias[n] (bias may be null). x8 (B, H, W, Cin) int8, w8 (3, 3, Cin, N) int8,
// wsc (N,) and asc (B,) f32. Cin a multiple of 64, N of 64.
int gddim_conv3x3_int8(const void* x8, const void* w8, const void* wsc, const void* asc,
                       const void* bias, int batch, int h, int w_, int cin, int n, void* work,
                       void* out, void* stream) {
  if (cin % BK || n % BN) return (int)cudaErrorInvalidValue;
  S8Conv p;
  p.x = (const int8_t*)x8;
  p.w = (const int8_t*)w8;
  p.wsc = (const float*)wsc;
  p.asc = (const float*)asc;
  p.bias = (const float*)bias;
  p.B = batch;
  p.H = h;
  p.W = w_;
  p.C = cin;
  p.N = n;
  const long m = (long)batch * h * w_;
  s8_split_plan(m, n, 9 * cin, &p.splits, &p.kper);
  p.partial = (int*)work;
  p.out = (__nv_bfloat16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((m + BM - 1) / BM), n / BN, p.splits);
  conv3x3_s8_kernel<<<grid, THREADS, 0, st>>>(p);
  int err = (int)cudaGetLastError();
  if (!err && p.splits > 1) {
    const long vecs = m * n / 8;
    s8_splitk_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(p);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // extern "C"
