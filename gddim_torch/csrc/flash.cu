// Single-head attention in f32 for Hopper (sm_90a): o = softmax(q k^T / sqrt(C)) v
// over (B, S, C), with the (S, S) scores never written to device memory.
//
// Replaces gddim_tpu/ops/flash.py:flash_attention (K8): both of its
// branches, the whole-sequence kernel (_attn_kernel_single, S <= 1024) and
// the k-blocked online-softmax kernel (_attn_kernel_blocked), are this one
// kernel, which runs the online-softmax recurrence over 16-key tiles for
// every S. The training path calls it on f32 q/k/v (S = 256 and 16, C = 256).
//
// Arithmetic: plain f32 FMA, no tensor cores. The training model is f32 and
// the JAX package runs this attention in f32 too; FMA keeps the result
// within f32 summation-order noise of the plain f32 version (TF32 would cost
// about three decimal digits). exp is the accurate expf.
//
// Layout: one block per (sample, 32 queries), 256 threads; each query row is
// owned by 8 consecutive lanes, each holding C/8 of the row's channels (q and
// the output accumulator in registers). A 16-key tile of k and v sits in
// shared memory; a score is a register dot product reduced over the 8 lanes
// with three shuffles, then the online-softmax update rescales the
// accumulator. The 8 lanes of a row read 128 contiguous bytes of a k or v
// row, and the warp's 4 rows read the same bytes (a broadcast).
//
// What bounds it on the H100: 4*S*C FLOPs per query against one read of its
// q row, so compute; without tensor cores the FMA pipes cap it at the card's
// f32 rate, and each FMA needs one shared-memory read, which caps it lower
// still (shared-memory bandwidth). Sharing k/v reads across several rows per
// thread, or 3xTF32 on the tensor cores, is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BKV = 16;  // keys per tile
constexpr int FL_THREADS = 256;

// CPL: channels per lane, C / 8
template <int CPL>
__global__ void __launch_bounds__(FL_THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, float scale) {
  constexpr int C = 8 * CPL;
  constexpr int NV = CPL / 4;  // float4 groups per lane: channels 32*j + 4*lane8 + (0..3)
  __shared__ __align__(16) float Ks[BKV][C];
  __shared__ __align__(16) float Vs[BKV][C];
  const int b = blockIdx.y;
  const int row = threadIdx.x >> 3, lane8 = threadIdx.x & 7;
  const int qi = blockIdx.x * BQ + row;
  const bool active = qi < S;
  const long base = (long)b * S * C;

  float4 qr[NV], acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    qr[j] = active ? *reinterpret_cast<const float4*>(q + base + (long)qi * C + 32 * j + 4 * lane8)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < BKV * C / 4; i += FL_THREADS) {
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      const long off = base + (long)(kv0 + r) * C + c4;
      *reinterpret_cast<float4*>(&Ks[r][c4]) = *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<float4*>(&Vs[r][c4]) = *reinterpret_cast<const float4*>(v + off);
    }
    __syncthreads();

    float s[BKV];
    float mt = -INFINITY;
#pragma unroll
    for (int t = 0; t < BKV; ++t) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[t][32 * j + 4 * lane8]);
        d = fmaf(qr[j].x, kk.x, d);
        d = fmaf(qr[j].y, kk.y, d);
        d = fmaf(qr[j].z, kk.z, d);
        d = fmaf(qr[j].w, kk.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      s[t] = d * scale;
      mt = fmaxf(mt, s[t]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= alpha;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
      acc[j].z *= alpha;
      acc[j].w *= alpha;
    }
#pragma unroll
    for (int t = 0; t < BKV; ++t) {
      const float pt = expf(s[t] - m_new);
      l += pt;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[t][32 * j + 4 * lane8]);
        acc[j].x = fmaf(pt, vv.x, acc[j].x);
        acc[j].y = fmaf(pt, vv.y, acc[j].y);
        acc[j].z = fmaf(pt, vv.z, acc[j].z);
        acc[j].w = fmaf(pt, vv.w, acc[j].w);
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.0f / l;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      *reinterpret_cast<float4*>(o + base + (long)qi * C + 32 * j + 4 * lane8) =
          make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
  }
}

template <int CPL>
int run(const float* q, const float* k, const float* v, float* o, int batch, int s,
        cudaStream_t st) {
  dim3 grid((s + BQ - 1) / BQ, batch);
  flash_kernel<CPL><<<grid, FL_THREADS, 0, st>>>(q, k, v, o, s, 1.0f / sqrtf(8.0f * CPL));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: q, k, v, o (B, S, C) f32 contiguous; S a multiple of 16, C in {64, 128, 256}.
int gddim_flash_attention(const void* q, const void* k, const void* v, void* o, int batch, int s,
                          int c, void* stream) {
  if (s % BKV != 0) return (int)cudaErrorInvalidValue;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 64: return run<8>(qf, kf, vf, of, batch, s, st);
    case 128: return run<16>(qf, kf, vf, of, batch, s, st);
    case 256: return run<32>(qf, kf, vf, of, batch, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
