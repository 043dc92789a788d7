// Spatial self-attention core of the fused attention block, for Hopper (sm_90a).
//
// Replaces the attention part of gddim_tpu/ops/attnblock.py:fused_attnblock
// (K5, _attnblock_kernel). The whole block is one C call, gddim_attnblock,
// which makes four launches, all hand-written:
//   gn_affine_launch (resblock.cu)   GN statistics -> per-(sample, channel) affine
//   conv_gemm_launch (resblock.cu)   [q|k|v] = GN(x) @ [Wq|Wk|Wv] + b, one N = 3C
//                                    product with the GN affine as its prologue
//   attention_kernel (this file)     a = softmax(q k^T / sqrt(C)) v per sample
//   conv_gemm_launch (resblock.cu)   out = (x + a @ Wo + bo) / sqrt(2) in the epilogue
//
// x and out are bf16, or f32 (act_f32; K10, the training forward, runs K5 on
// f32 activations): the GN statistics and the residual x + o then read x in
// f32 and out is f32, while h = GN(x), q/k/v, p and a are rounded to bf16 for
// the products, as the TPU kernel does with mm_dtype bf16. The int8 mode
// takes bf16 x (the wrapper refuses others).
//
// This kernel: one block per (sample, 16-query tile), 4 warps. S <= 256 keys
// and C <= 256 channels, so the 16 x S score rows sit in shared memory: the
// (S, S) score matrix never touches device memory. q k^T and p v run on the
// tensor cores (bf16 WMMA, f32 accumulation); the softmax is f32, and p is
// rounded to bf16 before p v, as the TPU kernel does.
//
// What bounds it on the H100: at S = 256, C = 256 each block does
// 2 * 16 * 256 * 256 * 2 FLOPs against 16 * 256 * 2 bytes of q plus k and v
// re-read from L2; it is latency-bound at these sizes (a few hundred blocks,
// no pipelining). At S = 16 it is pure launch latency. The design's answer
// is to keep the scores on chip and issue the products on tensor cores;
// overlapping the loads is later work.
//
// The int8 mode of K5 (mm_dtype int8: _attnblock_kernel's int8 path, static
// or per-sample scales) is the C call gddim_attnblock_int8, four launches in
// static mode and six in dynamic mode:
//   gn_affine_launch, [amax_launch of GN(x)]
//   conv_gemm_s8_launch   [q|k|v] = dequant(int8(GN(x)) @ Wqkv_int8) + b, bf16
//   attention_kernel      as above, writing a in f32: the output projection
//                         quantizes it unrounded, as the TPU kernel does
//   [amax_launch of a], conv_gemm_s8_launch   out = (x + dequant(int8(a) @ Wo_int8) + bo) / sqrt(2)
// The attention products stay bf16 on the dequantized q, k, v (bf16 in
// device memory is where the TPU kernel rounds them too). What bounds it on
// the H100 is what bounds the bf16 mode: the projections are int8 products
// (1,979 TOP/s) too small to fill the card at these shapes, so launches and
// latency dominate; a in f32 doubles the bytes between the attention core
// and the out-projection, and the per-sample mode adds two amax passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "conv.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 16;       // query rows per block
constexpr int MAX_S = 256;
constexpr int MAX_C = 256;
constexpr int ATT_THREADS = 128;

__device__ __forceinline__ void store_out(__nv_bfloat16* d, float v) { *d = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* d, float v) { *d = v; }

// grid (S / QT, B); TO: the output type (bf16, or f32 for the int8 mode)
template <typename TO>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ qkv, TO* __restrict__ out, int S, int C,
                 float scale) {
  __shared__ __align__(128) __nv_bfloat16 Qs[QT * (MAX_C + 8)];
  __shared__ __align__(128) __nv_bfloat16 Ps[QT * (MAX_S + 8)];
  __shared__ __align__(128) float SO[QT * ((MAX_S > MAX_C ? MAX_S : MAX_C) + 4)];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long ld = 3L * C;  // row stride of qkv
  const __nv_bfloat16* base = qkv + (long)b * S * ld;
  const int ldq = C + 8, ldp = S + 8, lds = S + 4, ldo = C + 4;

  // q tile -> shared
  for (int v = threadIdx.x; v < QT * C / 8; v += ATT_THREADS) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * ldq + c]) =
        *reinterpret_cast<const uint4*>(base + (long)(q0 + r) * ld + c);
  }
  __syncthreads();

  // scores = q k^T (k read as a column-major K^T straight from qkv)
  for (int jt = warp; jt < S / 16; jt += ATT_THREADS / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, &Qs[kk], ldq);
      wmma::load_matrix_sync(fb, base + (long)(jt * 16) * ld + C + kk, (unsigned)ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(&SO[jt * 16], acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // f32 softmax over each row, p -> bf16
  for (int r = warp; r < QT; r += ATT_THREADS / 32) {
    float mx = -3.0e38f;
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, SO[r * lds + j] * scale);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = __expf(SO[r * lds + j] * scale - mx);
      SO[r * lds + j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.0f / sum;
    for (int j = lane; j < S; j += 32) Ps[r * ldp + j] = __float2bfloat16(SO[r * lds + j] * inv);
  }
  __syncthreads();

  // a = p v
  for (int ct = warp; ct < C / 16; ct += ATT_THREADS / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < S; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, &Ps[kk], ldp);
      wmma::load_matrix_sync(fb, base + (long)kk * ld + 2 * C + ct * 16, (unsigned)ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(&SO[ct * 16], acc, ldo, wmma::mem_row_major);
  }
  __syncthreads();

  TO* dst = out + ((long)b * S + q0) * C;
  for (int v = threadIdx.x; v < QT * C; v += ATT_THREADS) {
    const int r = v / C, c = v % C;
    store_out(dst + (long)r * C + c, SO[r * ldo + c]);
  }
}

struct Work {
  float* sc;  // (B, C) GN affine
  float* sh;
  __nv_bfloat16* qkv;  // (M, 3C)
  __nv_bfloat16* a;    // (M, C) attention output
  float* partial;      // (splits, M, 3C) split-K partial sums
  size_t bytes;
};

Work carve(char* base, int batch, long m, int c, int splits) {
  Work w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  w.sc = (float*)take(sizeof(float) * batch * c);
  w.sh = (float*)take(sizeof(float) * batch * c);
  w.qkv = (__nv_bfloat16*)take(sizeof(__nv_bfloat16) * m * 3 * c);
  w.a = (__nv_bfloat16*)take(sizeof(__nv_bfloat16) * m * c);
  w.partial = splits > 1 ? (float*)take(sizeof(float) * splits * m * 3 * c) : nullptr;
  w.bytes = off;
  return w;
}

// Scratch of the int8 mode: a is f32, and the per-sample amaxes of h and a.
struct WorkS8 {
  float* sc;  // (B, C) GN affine
  float* sh;
  __nv_bfloat16* qkv;  // (M, 3C)
  float* a;            // (M, C) attention output
  float* amax;         // (2, B) dynamic mode
  float* partial;      // (splits, M, 3C) split-K partial sums
  size_t bytes;
};

WorkS8 carve_s8(char* base, int batch, long m, int c, int splits) {
  WorkS8 w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  w.sc = (float*)take(sizeof(float) * batch * c);
  w.sh = (float*)take(sizeof(float) * batch * c);
  w.qkv = (__nv_bfloat16*)take(sizeof(__nv_bfloat16) * m * 3 * c);
  w.a = (float*)take(sizeof(float) * m * c);
  w.amax = (float*)take(sizeof(float) * 2 * batch);
  w.partial = splits > 1 ? (float*)take(sizeof(float) * splits * m * 3 * c) : nullptr;
  w.bytes = off;
  return w;
}

}  // namespace

extern "C" {

long long gddim_attnblock_workspace(int batch, int s, int c, int splits) {
  return (long long)carve(nullptr, batch, (long)batch * s, c, splits).bytes;
}

// The whole attention block: GN stats, [q|k|v] = GN(x) @ wqkv + bqkv (one
// N = 3C GEMM), the attention core, out = (x + a @ wo + bo) * out_scale.
// x and out bf16, or f32 with act_f32. Scratch comes from `work`,
// gddim_attnblock_workspace bytes.
int gddim_attnblock(const void* x, const void* gn_g, const void* gn_b, int groups,
                    const void* wqkv, const void* bqkv, const void* wo, const void* bo, int batch,
                    int s, int c, float eps, float out_scale, void* work, int splits1, int kper1,
                    int splits2, int kper2, void* out, int act_f32, void* stream) {
  if (s % QT != 0 || s > MAX_S || c % 16 != 0 || c > MAX_C) return (int)cudaErrorInvalidValue;
  const Work wk = carve((char*)work, batch, (long)batch * s, c,
                        splits1 > splits2 ? splits1 : splits2);
  cudaStream_t st = (cudaStream_t)stream;
  int err = gn_affine_launch(x, nullptr, c, 0, batch, s, groups, (const float*)gn_g,
                             (const float*)gn_b, eps, wk.sc, wk.sh, nullptr, nullptr, act_f32, st);
  if (!err) {
    // the projections are 1x1 convs over M = B*S pixels (H = S, W = 1)
    err = conv_gemm_launch_as(conv_args(x, c, wk.sc, wk.sh, 0, 1, wqkv, batch, s, 1, 3 * c, bqkv,
                                        1.0f, wk.qkv, wk.partial, splits1, kper1),
                              act_f32, false, st);
  }
  if (err) return err;
  attention_kernel<__nv_bfloat16><<<dim3(s / QT, batch), ATT_THREADS, 0, st>>>(
      wk.qkv, wk.a, s, c, 1.0f / sqrtf((float)c));
  err = (int)cudaGetLastError();
  if (!err) {
    ConvArgs p = conv_args(wk.a, c, nullptr, nullptr, 0, 1, wo, batch, s, 1, c, bo, out_scale,
                           out, wk.partial, splits2, kper2);
    p.resid = x;
    err = conv_gemm_launch_as(p, false, act_f32, st);
  }
  return err;
}

long long gddim_attnblock_int8_workspace(int batch, int s, int c, int splits) {
  return (long long)carve_s8(nullptr, batch, (long)batch * s, c, splits).bytes;
}

// K5's int8 mode: wqkv_q (C, 3C) / wo_q (C, C) int8 with their per-output-
// channel scales; act_scales the static [s_h, s_a] (a device array), or null
// for per-sample scales. Scratch: gddim_attnblock_int8_workspace bytes.
int gddim_attnblock_int8(const void* x, const void* gn_g, const void* gn_b, int groups,
                         const void* wqkv_q, const void* wqkv_s, const void* bqkv,
                         const void* wo_q, const void* wo_s, const void* bo,
                         const void* act_scales, int batch, int s, int c, float eps,
                         float out_scale, void* work, int splits1, int kper1, int splits2,
                         int kper2, void* out, void* stream) {
  if (s % QT != 0 || s > MAX_S || c % 16 != 0 || c > MAX_C) return (int)cudaErrorInvalidValue;
  const WorkS8 wk = carve_s8((char*)work, batch, (long)batch * s, c,
                             splits1 > splits2 ? splits1 : splits2);
  const float* qs = (const float*)act_scales;
  cudaStream_t st = (cudaStream_t)stream;
  int err = gn_affine_launch(x, nullptr, c, 0, batch, s, groups, (const float*)gn_g,
                             (const float*)gn_b, eps, wk.sc, wk.sh, nullptr, nullptr, false, st);
  if (!err && qs == nullptr)
    err = amax_launch(x, nullptr, c, 0, batch, s, wk.sc, wk.sh, 0, wk.amax, false, st);
  if (!err) {  // the projections are 1x1 convs over M = B*S pixels (H = S, W = 1)
    const ConvArgs p = conv_args(x, c, wk.sc, wk.sh, 0, 1, nullptr, batch, s, 1, 3 * c, bqkv,
                                 1.0f, wk.qkv, wk.partial, splits1, kper1);
    const Int8Args q = {(const int8_t*)wqkv_q, (const float*)wqkv_s, qs, wk.amax, 0};
    err = conv_gemm_s8_launch(p, q, false, false, st);
  }
  if (err) return err;
  attention_kernel<float><<<dim3(s / QT, batch), ATT_THREADS, 0, st>>>(
      wk.qkv, wk.a, s, c, 1.0f / sqrtf((float)c));
  err = (int)cudaGetLastError();
  if (!err && qs == nullptr)
    err = amax_launch(wk.a, nullptr, c, 0, batch, s, nullptr, nullptr, 0, wk.amax + batch, true, st);
  if (!err) {
    ConvArgs p = conv_args(wk.a, c, nullptr, nullptr, 0, 1, nullptr, batch, s, 1, c, bo, out_scale,
                           out, wk.partial, splits2, kper2);
    p.resid = x;
    const Int8Args q = {(const int8_t*)wo_q, (const float*)wo_s, qs ? qs + 1 : nullptr,
                        wk.amax + batch, 0};
    err = conv_gemm_s8_launch(p, q, true, false, st);
  }
  return err;
}

}  // extern "C"
