// Fused residual-block backward for Hopper (sm_90a): all 12 gradients of one
// training block, bf16 tensor-core operands with f32 accumulation.
//
// Replaces gddim_tpu/ops/resblock_bwd.py:fused_resblock_train_grads (K7,
// _resblock_bwd_kernel). The block (resblock_train_reference) is
//
//   a1 = silu(GN1(x));  u = conv1(a1) + b1 + temb_proj
//   d  = silu(GN2(u)) * mask / keep;  out = (skip(x) + conv2(d) + b2) * r
//
// and, like the TPU kernel, the backward recomputes the interior from x: the
// forward saves no interior activation. The TPU kernel runs one VMEM pass
// per batch tile with the weight-gradient accumulators carried across a
// sequential grid; 132 SMs that run blocks in no order have no such carry,
// so here the backward is a chain of launches, each a hand-written kernel:
//
//   1  gn_stats(x)        GN1 statistics (resblock.cu)
//   2  conv_gemm          u = conv1(silu(GN1 x)) + b1 + temb_proj, f32
//   3  gn_stats(u)        GN2 statistics
//   4  conv_gemm          gd = r * conv(g, W2 flipped/transposed): dgrad of
//                         a stride-1 SAME 3x3 conv is the same conv of the
//                         cotangent with the taps flipped and (Cin, Cout)
//                         swapped (the wrapper repacks the weights)
//   5  gn_bwd_kernel      dropout + SiLU + GN2 backward -> gu = dL/du, in
//                         place over gd; dtemb_proj = sum over pixels of gu;
//                         per-sample partials of dGN2 s/b and of sum(g)
//   6  conv_gemm          ga1 = conv(gu, W1 flipped/transposed)
//   7  conv_gemm          (1x1 skip only) dx = r * g @ W_skip^T. The skip's
//                         dgrad cannot share step 6's accumulator: ga1 still
//                         goes through the GN1 backward, the skip term not.
//   8  gn_bwd_kernel      SiLU + GN1 backward of ga1, plus the skip term
//                         (step 7's dx, or r * g for the identity) -> dx;
//                         per-sample partials of dGN1 s/b
//   9  wgrad_kernel x3    dW2 = r * sum_pixels shift_t(d)^T g, dW1 =
//                         sum shift_t(a1)^T gu, dW_skip = r * sum x^T g: the
//                         one new GEMM shape, reducing over M = B*H*W with a
//                         (taps*Cin, Cout) output. d and a1 are recomputed in
//                         the loader (GN affine, SiLU, mask) from u and x.
//                         M is split across blocks into partial sums, which
//   10 rowsum_kernel      sums in split order, as it sums the per-sample
//                         partials into dGN s/b, db1, db2 and db_skip.
//
// No float atomics anywhere: every sum runs in a fixed order, so two runs on
// the same inputs give the same bits.
//
// What bounds it on the H100: the five GEMMs (recomputed conv1, two dgrads,
// two 3x3 wgrads) are 5/2 of the forward's tensor-core work and dominate at
// 32x32 and 16x16; the GN-backward passes read each activation twice (L2
// serves the second read at these sizes). The design keeps every elementwise
// step of the chain (GN affine, SiLU, dropout, their derivatives) inside a
// GEMM prologue or a GN-backward pass, so the activations written to device
// memory are u, gu, ga1 and dx only. The GEMMs use conv_gemm_kernel's
// 64x64x32 WMMA tile; the wgrad kernel is the same tile transposed (A is
// read m-major and fed to the tensor cores column-major).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>

#include "conv.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS_BWD = 256;  // block_sum256 (conv.cuh)
constexpr int WG_BM = 64;  // wgrad output tile: rows (taps*Cin) x cols (Cout)
constexpr int WG_BN = 64;
constexpr int WG_BK = 32;  // pixels per slice of the M reduction
constexpr int WG_THREADS = 128;
constexpr int WG_LD = 64 + 8;  // bf16 elements; rows stay 32-byte aligned for WMMA
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int MIN_SPLIT_SLICES = 8;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + __expf(-v)); }

// ---------------------------------------------------------------------------
// GroupNorm(+SiLU) backward of one (group, sample). grid (G, B), 256 threads.
//
// For each element of the group: y = v*sc + sh, s = sigmoid(y),
// dy = dpre [* mask/keep] * s*(1 + y*(1 - s)), yhat = (v - mean)*rstd,
// dyh = dy*gamma. Pass 1 sums dyh and dyh*yhat over the group, and per
// channel dy*yhat (dGN scale) and dy (dGN bias); pass 2 writes
// out = rstd*(dyh - mean(dyh) - yhat*mean(dyh*yhat)) [+ add_scale*add], and
// per channel sums out (dtemb_proj, when chan_out is set). Each thread owns
// one channel of the group and a stride of pixels, so the per-channel sums
// are register sums reduced across pixel rows through shared memory, in a
// fixed order.
struct GnBwdArgs {
  const float* dpre;  // (M, C) gradient w.r.t. the GN+SiLU(+dropout) output
  const int8_t* mask; // (M, C) or null
  float inv_keep;
  const float* v;     // (M, C) GN input
  const float* sc;    // (B, C) forward affine: y = v*sc + sh
  const float* sh;
  const float* mean;  // (B, G)
  const float* rstd;
  const float* gamma;  // (C,)
  const float* add;   // (M, C) added to the output, or null
  float add_scale;
  const float* extra;  // (M, C) summed per (sample, channel) into part_extra, or null
  float* out;         // (M, C); may alias dpre or add
  float* part_s;      // (B, C) sum over pixels of dy*yhat
  float* part_b;      // (B, C) sum over pixels of dy
  float* part_extra;  // (B, C)
  float* chan_out;    // (B, C) sum over pixels of out, or null
  int HW, C, G;
};

// sum of v over the pixel rows of each channel; thread j < cg writes channel j's
__device__ void channel_sum(float v, float* buf, int cg, int rows, float* dst) {
  __syncthreads();
  buf[threadIdx.x] = v;
  __syncthreads();
  if ((int)threadIdx.x < cg) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += buf[r * cg + threadIdx.x];
    *dst = s;
  }
}

__global__ void __launch_bounds__(THREADS_BWD) gn_bwd_kernel(const GnBwdArgs p) {
  __shared__ float red[32];
  __shared__ float buf[THREADS_BWD];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = p.C / p.G;
  const int rows = THREADS_BWD / cg;  // pixel rows handled in parallel
  const int cl = threadIdx.x % cg;
  const int r0 = threadIdx.x / cg;
  const bool active = r0 < rows;
  const int c = g * cg + cl;
  const long bc = (long)b * p.C + c;
  const float sc = p.sc[bc], sh = p.sh[bc], gam = p.gamma[c];
  const float mean = p.mean[b * p.G + g], rstd = p.rstd[b * p.G + g];
  const long base = (long)b * p.HW * p.C + c;

  auto dy_at = [&](long off, float& yhat) {
    const float v = p.v[off];
    const float y = v * sc + sh;
    const float s = sigmoidf_(y);
    float d = p.dpre[off];
    if (p.mask) d *= (float)p.mask[off] * p.inv_keep;
    yhat = (v - mean) * rstd;
    return d * (s * (1.0f + y * (1.0f - s)));
  };

  float s1 = 0.f, s2 = 0.f, ps = 0.f, pb = 0.f, pe = 0.f;
  if (active) {
    for (int px = r0; px < p.HW; px += rows) {
      const long off = base + (long)px * p.C;
      float yhat;
      const float dy = dy_at(off, yhat);
      const float dyh = dy * gam;
      s1 += dyh;
      s2 += dyh * yhat;
      ps += dy * yhat;
      pb += dy;
      if (p.extra) pe += p.extra[off];
    }
  }
  const float inv_n = 1.0f / ((float)p.HW * cg);
  const float m1 = block_sum256(s1, red) * inv_n;
  const float m2 = block_sum256(s2, red) * inv_n;
  channel_sum(ps, buf, cg, rows, p.part_s + bc);
  channel_sum(pb, buf, cg, rows, p.part_b + bc);
  if (p.extra) channel_sum(pe, buf, cg, rows, p.part_extra + bc);

  float po = 0.f;
  if (active) {
    for (int px = r0; px < p.HW; px += rows) {
      const long off = base + (long)px * p.C;
      float yhat;
      const float dy = dy_at(off, yhat);
      float o = rstd * (dy * gam - m1 - yhat * m2);
      if (p.add) o += p.add_scale * p.add[off];
      p.out[off] = o;
      po += o;
    }
  }
  if (p.chan_out) channel_sum(po, buf, cg, rows, p.chan_out + bc);
}

// out[i] = scale * sum_r in[r*n + i], rows summed in order. 256 threads.
__global__ void __launch_bounds__(256)
rowsum_kernel(const float* __restrict__ in, int rows, long n, float scale, float* __restrict__ out) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += in[(long)r * n + i];
  out[i] = s * scale;
}

int rowsum(const float* in, int rows, long n, float scale, float* out, cudaStream_t st) {
  rowsum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(in, rows, n, scale, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradient of a stride-1 SAME conv (taps 9) or a 1x1 conv (taps 1):
//   partial[z, t*C + c, n] = sum over pixels m of split z of
//                            act(v)[shift_t(m), c] * g[m, n]
// act: the GN affine (+SiLU) (x dropout mask / keep) of v, 0 where the tap
// falls in the padding. grid (taps*C/64, N/64, splits), 128 threads: 4 warps
// in 2x2, 32x32 output each, double-buffered like conv_gemm_kernel.
struct WgradArgs {
  const float* v;  // (M, C)
  int C, taps;
  const float* scale;  // (B, C) or null: act(v) = v
  const float* shift;
  int silu;
  const int8_t* mask;  // (M, C) or null
  float inv_keep;
  const float* g;  // (M, N)
  int N;
  int B, H, W;
  float* partial;  // (splits, taps*C, N)
  int mper;        // pixels per split, a multiple of WG_BK
};

struct WgStage {
  uint4 a[2][2];  // 8 f32 values of v
  uint2 m[2];
  uint4 b[2][2];  // 8 f32 values of g
  int a_b[2];     // sample of the row, -1: zero (padding or m >= M)
};

__device__ __forceinline__ void wg_load(const WgradArgs& p, int k0, int n0, int mb, int mend,
                                        WgStage& st) {
  const int t = threadIdx.x;
  const int hw = p.H * p.W;
  const int tap = k0 / p.C;
  const int c0 = k0 - tap * p.C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (t >> 3) + 16 * i;  // pixel within the slice
    const int col = (t & 7) * 8;        // 8 of the 64 columns
    const int m = mb + row;
    st.a[i][0] = st.a[i][1] = make_uint4(0, 0, 0, 0);
    st.b[i][0] = st.b[i][1] = make_uint4(0, 0, 0, 0);
    st.a_b[i] = -1;
    if (m < mend) {
      const int b = m / hw, rem = m - b * hw;
      int y = rem / p.W, x = rem - (rem / p.W) * p.W;
      if (p.taps == 9) {
        y += tap / 3 - 1;
        x += tap % 3 - 1;
      }
      if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
        const long off = (((long)b * p.H + y) * p.W + x) * p.C + c0 + col;
        const uint4* src = reinterpret_cast<const uint4*>(p.v + off);
        st.a[i][0] = src[0];
        st.a[i][1] = src[1];
        if (p.mask) st.m[i] = *reinterpret_cast<const uint2*>(p.mask + off);
        st.a_b[i] = b;
      }
      const uint4* gsrc = reinterpret_cast<const uint4*>(p.g + (long)m * p.N + n0 + col);
      st.b[i][0] = gsrc[0];
      st.b[i][1] = gsrc[1];
    }
  }
}

__device__ __forceinline__ void wg_store(const WgradArgs& p, int k0, const WgStage& st,
                                         bf16 (*As)[WG_LD], bf16 (*Bs)[WG_LD]) {
  const int t = threadIdx.x;
  const int tap = k0 / p.C;
  const int c0 = k0 - tap * p.C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (t >> 3) + 16 * i;
    const int col = (t & 7) * 8;
    const float* f = reinterpret_cast<const float*>(st.a[i]);
    uint4 va;
    bf16* ea = reinterpret_cast<bf16*>(&va);
    if (st.a_b[i] >= 0 && p.scale) {
      const float* sc = p.scale + (long)st.a_b[i] * p.C + c0 + col;
      const float* sh = p.shift + (long)st.a_b[i] * p.C + c0 + col;
      const int8_t* mk = reinterpret_cast<const int8_t*>(&st.m[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = f[j] * sc[j] + sh[j];
        if (p.silu) v = v * sigmoidf_(v);
        if (p.mask) v *= (float)mk[j] * p.inv_keep;
        ea[j] = __float2bfloat16(v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) ea[j] = __float2bfloat16(f[j]);
    }
    *reinterpret_cast<uint4*>(&As[row][col]) = va;
    const float* gf = reinterpret_cast<const float*>(st.b[i]);
    uint4 vb;
    bf16* eb = reinterpret_cast<bf16*>(&vb);
#pragma unroll
    for (int j = 0; j < 8; ++j) eb[j] = __float2bfloat16(gf[j]);
    *reinterpret_cast<uint4*>(&Bs[row][col]) = vb;
  }
}

__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(const WgradArgs p) {
  // A slice stored m-major (As[pixel][k]); the tensor cores read it column-major
  __shared__ __align__(128) bf16 As[2][WG_BK][WG_LD];
  __shared__ __align__(128) bf16 Bs[2][WG_BK][WG_LD];
  const int k0 = blockIdx.x * WG_BM;
  const int n0 = blockIdx.y * WG_BN;
  const int M = p.B * p.H * p.W;
  const int mbeg = blockIdx.z * p.mper;
  const int mend = min(M, mbeg + p.mper);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  WgStage st;
  wg_load(p, k0, n0, mbeg, mend, st);
  wg_store(p, k0, st, As[0], Bs[0]);
  __syncthreads();
  int buf = 0;
  for (int mb = mbeg; mb < mend; mb += WG_BK, buf ^= 1) {
    const bool more = mb + WG_BK < mend;
    if (more) wg_load(p, k0, n0, mb + WG_BK, mend, st);
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[buf][kk][wm + 16 * i], WG_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[buf][kk][wn + 16 * j], WG_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) wg_store(p, k0, st, As[buf ^ 1], Bs[buf ^ 1]);
    __syncthreads();
  }

  const long K = (long)p.taps * p.C;
  float* dst = p.partial + ((long)blockIdx.z * K + k0) * p.N + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(dst + (long)(wm + 16 * i) * p.N + wn + 16 * j, acc[i][j], p.N,
                              wmma::mem_row_major);
}

void wgrad_plan(long m, int k, int n, int* splits, int* mper) {
  const long tiles = (long)(k / WG_BM) * (n / WG_BN);
  const long slices = (m + WG_BK - 1) / WG_BK;
  long s = (TARGET_BLOCKS + tiles - 1) / tiles;
  if (s > slices / MIN_SPLIT_SLICES) s = slices / MIN_SPLIT_SLICES;
  if (s < 1) s = 1;
  const long per = (slices + s - 1) / s;
  *mper = (int)(per * WG_BK);
  *splits = (int)((slices + per - 1) / per);
}

// dW (taps*C, N) = scale * sum over pixels of act(v)^T g
int wgrad(WgradArgs p, float scale, float* partial, float* dw, cudaStream_t st) {
  const long m = (long)p.B * p.H * p.W;
  const int k = p.taps * p.C;
  int splits;
  wgrad_plan(m, k, p.N, &splits, &p.mper);
  p.partial = partial;
  wgrad_kernel<<<dim3(k / WG_BM, p.N / WG_BN, splits), WG_THREADS, 0, st>>>(p);
  int err = (int)cudaGetLastError();
  if (!err) err = rowsum(partial, splits, (long)k * p.N, scale, dw, st);
  return err;
}

// The plan of one block shape: conv splits per GEMM and the scratch layout.
struct Plan {
  int s_u, k_u;    // conv1 recompute: M x N x 9*Cin
  int s_d2, k_d2;  // dgrad2: M x N x 9*N
  int s_d1, k_d1;  // dgrad1: M x Cin x 9*N
  int s_sk, k_sk;  // skip dgrad: M x Cin x N
  int conv_splits;
  int wg_splits;   // the largest of the three wgrads'
};

Plan make_plan(int batch, int h, int w, int cin, int n) {
  Plan pl;
  const long m = (long)batch * h * w;
  conv_split_plan(m, n, 9 * cin, &pl.s_u, &pl.k_u);
  conv_split_plan(m, n, 9 * n, &pl.s_d2, &pl.k_d2);
  conv_split_plan(m, cin, 9 * n, &pl.s_d1, &pl.k_d1);
  conv_split_plan(m, cin, n, &pl.s_sk, &pl.k_sk);
  pl.conv_splits = pl.s_u;
  for (int s : {pl.s_d2, pl.s_d1, pl.s_sk}) pl.conv_splits = s > pl.conv_splits ? s : pl.conv_splits;
  pl.wg_splits = 1;
  int mper;
  for (int k : {9 * n, 9 * cin, cin}) {
    int s;
    wgrad_plan(m, k, n, &s, &mper);
    pl.wg_splits = s > pl.wg_splits ? s : pl.wg_splits;
  }
  return pl;
}

struct Work {
  float *sc1, *sh1, *mean1, *rstd1, *sc2, *sh2, *mean2, *rstd2;
  float* u;     // (M, N) conv1 output
  float* gu;    // (M, N) dL/dd, then dL/du in place
  float* ga1;   // (M, Cin) dL/da1
  float *p_gn2s, *p_gn2b, *p_g, *p_gn1s, *p_gn1b;  // per-sample partials
  float* conv_partial;  // (conv splits, M, max(N, Cin))
  float* wg_partial;    // (wgrad splits, 9*max(N, Cin), N)
  size_t bytes;
};

Work carve(char* base, int batch, int h, int w, int cin, int n, int g1, int g2, const Plan& pl) {
  Work wk;
  size_t off = 0;
  auto take = [&](size_t count) {
    float* p = base ? (float*)(base + off) : nullptr;
    off += align256(sizeof(float) * count);
    return p;
  };
  const long m = (long)batch * h * w;
  const int cmax = cin > n ? cin : n;
  wk.sc1 = take((size_t)batch * cin);
  wk.sh1 = take((size_t)batch * cin);
  wk.mean1 = take((size_t)batch * g1);
  wk.rstd1 = take((size_t)batch * g1);
  wk.sc2 = take((size_t)batch * n);
  wk.sh2 = take((size_t)batch * n);
  wk.mean2 = take((size_t)batch * g2);
  wk.rstd2 = take((size_t)batch * g2);
  wk.u = take((size_t)m * n);
  wk.gu = take((size_t)m * n);
  wk.ga1 = take((size_t)m * cin);
  wk.p_gn2s = take((size_t)batch * n);
  wk.p_gn2b = take((size_t)batch * n);
  wk.p_g = take((size_t)batch * n);
  wk.p_gn1s = take((size_t)batch * cin);
  wk.p_gn1b = take((size_t)batch * cin);
  wk.conv_partial = pl.conv_splits > 1 ? take((size_t)pl.conv_splits * m * cmax) : nullptr;
  wk.wg_partial = take((size_t)pl.wg_splits * 9 * cmax * n);
  wk.bytes = off;
  return wk;
}

}  // namespace

extern "C" {

long long gddim_resblock_bwd_workspace(int batch, int h, int w, int cin, int n, int groups1,
                                       int groups2) {
  return (long long)carve(nullptr, batch, h, w, cin, n, groups1, groups2,
                          make_plan(batch, h, w, cin, n)).bytes;
}

// K7: the 12 gradients of one training block (f32 in and out).
//   x (B,H,W,Cin), temb_row (B,N), g = dL/dout (B,H,W,N), mask (B,H,W,N) int8 or null;
//   w1 (9*Cin, N) bf16 in the forward (HWIO) layout; w1t (9*N, Cin) and w2t (9*N, N) bf16
//   in the dgrad layout (taps flipped, Cin/Cout swapped); wst (N, Cin) bf16 = W_skip^T, or
//   null for the identity skip. out_scale r = 1/sqrt(2) (skip_rescale) or 1.
// Outputs (f32): dx (B,H,W,Cin), dtemb (B,N), dgn1s/dgn1b (Cin), dw1 (9*Cin, N), db1,
//   dgn2s, dgn2b (N), dw2 (9*N, N), db2 (N), and with wst dws (Cin, N) and dbs (N).
int gddim_resblock_bwd(const void* x, const void* temb_row, const void* gn1_g, const void* gn1_b,
                       int groups1, const void* w1, const void* w1t, const void* b1,
                       const void* gn2_g, const void* gn2_b, int groups2, const void* w2t,
                       const void* wst, const void* mask, float inv_keep, const void* g,
                       int batch, int h, int w_, int cin, int n, float eps, float out_scale,
                       void* work, void* dx, void* dtemb, void* dgn1s, void* dgn1b, void* dw1,
                       void* db1, void* dgn2s, void* dgn2b, void* dw2, void* db2, void* dws,
                       void* dbs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hw = h * w_;
  const Plan pl = make_plan(batch, h, w_, cin, n);
  const Work wk = carve((char*)work, batch, h, w_, cin, n, groups1, groups2, pl);
  const float* gf = (const float*)g;
  const float r = out_scale;

  // 1-3: recompute GN1, u = conv1(silu(GN1 x)) + b1 + temb_proj, GN2
  int err = gn_stats_launch(x, nullptr, cin, 0, batch, hw, groups1, (const float*)gn1_g,
                            (const float*)gn1_b, eps, wk.sc1, wk.sh1, wk.mean1, wk.rstd1, true, st);
  if (!err) {
    ConvArgs p = conv_args(x, cin, wk.sc1, wk.sh1, 1, 9, w1, batch, h, w_, n, b1, 1.0f, wk.u,
                      wk.conv_partial, pl.s_u, pl.k_u);
    p.temb = (const float*)temb_row;
    p.temb_ld = n;
    err = conv_gemm_launch(p, true, st);
  }
  if (!err)
    err = gn_stats_launch(wk.u, nullptr, n, 0, batch, hw, groups2, (const float*)gn2_g,
                          (const float*)gn2_b, eps, wk.sc2, wk.sh2, wk.mean2, wk.rstd2, true, st);
  // 4: dL/dd = r * conv(g, W2^T flipped)
  if (!err)
    err = conv_gemm_launch(conv_args(g, n, nullptr, nullptr, 0, 9, w2t, batch, h, w_, n, nullptr, r,
                                wk.gu, wk.conv_partial, pl.s_d2, pl.k_d2),
                           true, st);
  // 5: dropout + SiLU + GN2 backward -> gu (in place), dtemb, partials
  if (!err) {
    GnBwdArgs a = {};
    a.dpre = wk.gu;
    a.mask = (const int8_t*)mask;
    a.inv_keep = inv_keep;
    a.v = wk.u;
    a.sc = wk.sc2;
    a.sh = wk.sh2;
    a.mean = wk.mean2;
    a.rstd = wk.rstd2;
    a.gamma = (const float*)gn2_g;
    a.extra = gf;
    a.out = wk.gu;
    a.part_s = wk.p_gn2s;
    a.part_b = wk.p_gn2b;
    a.part_extra = wk.p_g;
    a.chan_out = (float*)dtemb;
    a.HW = hw;
    a.C = n;
    a.G = groups2;
    gn_bwd_kernel<<<dim3(groups2, batch), THREADS_BWD, 0, st>>>(a);
    err = (int)cudaGetLastError();
  }
  // 6: dL/da1 = conv(gu, W1^T flipped)
  if (!err)
    err = conv_gemm_launch(conv_args(wk.gu, n, nullptr, nullptr, 0, 9, w1t, batch, h, w_, cin,
                                nullptr, 1.0f, wk.ga1, wk.conv_partial, pl.s_d1, pl.k_d1),
                           true, st);
  // 7: the 1x1 skip's dgrad straight into dx
  if (!err && wst)
    err = conv_gemm_launch(conv_args(g, n, nullptr, nullptr, 0, 1, wst, batch, h, w_, cin, nullptr, r,
                                dx, wk.conv_partial, pl.s_sk, pl.k_sk),
                           true, st);
  // 8: SiLU + GN1 backward, plus the skip term -> dx
  if (!err) {
    GnBwdArgs a = {};
    a.dpre = wk.ga1;
    a.v = (const float*)x;
    a.sc = wk.sc1;
    a.sh = wk.sh1;
    a.mean = wk.mean1;
    a.rstd = wk.rstd1;
    a.gamma = (const float*)gn1_g;
    a.add = wst ? (const float*)dx : gf;
    a.add_scale = wst ? 1.0f : r;
    a.out = (float*)dx;
    a.part_s = wk.p_gn1s;
    a.part_b = wk.p_gn1b;
    a.HW = hw;
    a.C = cin;
    a.G = groups1;
    gn_bwd_kernel<<<dim3(groups1, batch), THREADS_BWD, 0, st>>>(a);
    err = (int)cudaGetLastError();
  }
  // 9: weight gradients
  WgradArgs wa = {};
  wa.B = batch;
  wa.H = h;
  wa.W = w_;
  wa.N = n;
  if (!err) {  // dW2 = r * sum shift_t(d)^T g, d = silu(GN2 u) * mask / keep
    WgradArgs p = wa;
    p.v = wk.u;
    p.C = n;
    p.taps = 9;
    p.scale = wk.sc2;
    p.shift = wk.sh2;
    p.silu = 1;
    p.mask = (const int8_t*)mask;
    p.inv_keep = inv_keep;
    p.g = gf;
    err = wgrad(p, r, wk.wg_partial, (float*)dw2, st);
  }
  if (!err) {  // dW1 = sum shift_t(a1)^T gu, a1 = silu(GN1 x)
    WgradArgs p = wa;
    p.v = (const float*)x;
    p.C = cin;
    p.taps = 9;
    p.scale = wk.sc1;
    p.shift = wk.sh1;
    p.silu = 1;
    p.g = wk.gu;
    err = wgrad(p, 1.0f, wk.wg_partial, (float*)dw1, st);
  }
  if (!err && wst) {  // dW_skip = r * sum x^T g
    WgradArgs p = wa;
    p.v = (const float*)x;
    p.C = cin;
    p.taps = 1;
    p.g = gf;
    err = wgrad(p, r, wk.wg_partial, (float*)dws, st);
  }
  // 10: per-sample partials -> parameter gradients
  if (!err) err = rowsum(wk.p_gn2s, batch, n, 1.0f, (float*)dgn2s, st);
  if (!err) err = rowsum(wk.p_gn2b, batch, n, 1.0f, (float*)dgn2b, st);
  if (!err) err = rowsum((const float*)dtemb, batch, n, 1.0f, (float*)db1, st);
  if (!err) err = rowsum(wk.p_g, batch, n, r, (float*)db2, st);
  if (!err && wst) err = rowsum(wk.p_g, batch, n, r, (float*)dbs, st);
  if (!err) err = rowsum(wk.p_gn1s, batch, cin, 1.0f, (float*)dgn1s, st);
  if (!err) err = rowsum(wk.p_gn1b, batch, cin, 1.0f, (float*)dgn1b, st);
  return err;
}

}  // extern "C"
