// The whole up/down transition block (K9) for Hopper (sm_90a).
//
// Replaces gddim_tpu/ops/resblock.py:fused_resblock_transition
// (_resblock_transition_kernel, with _fir_up_2d / _fir_down_2d): one BigGAN
// block that changes the resolution by 2,
//
//   a1   = silu(GN1(x))                    at the input resolution, f32 stats
//   h    = resample(bf16(a1))              factor-2 polyphase FIR (or naive)
//   xr   = resample(bf16(x))
//   h1   = conv3x3(q(h), W1) + b1 + temb   q: bf16, or int8 (per sample / static)
//   out  = (conv3x3(q(silu(GN2(h1))), W2) + b2 + xr @ Wskip + bskip) / sqrt(2)
//
// xr @ Wskip in bf16, or (int8 with a static skip scale sx) as the int8
// product of q(xr) = clip(rint(xr * (1/sx))), xr quantized from its f32
// sums before any rounding (resblock.py:1490: sx was calibrated after the
// resample), written int8 by the first launch in xr's place.
//
// out-of-border taps of the resample are zero AFTER the activation (the TPU
// kernel fills a zero-bordered scratch with the activation, rounded to the
// scratch dtype, bf16, and resamples that). Each C call runs:
//
//   gn_apply_kernel (gn_apply.cu,    bf16 x: GN1's statistics and the
//   its resample variant)            resample in one launch, one cluster a
//                                    sample that reads x once: silu(GN1(x))
//                                    rounded to bf16 once per value in shared
//                                    memory, then the sums below; h bf16, f32
//                                    with the per-sample amax (a cluster
//                                    max), or with a static scale q(h) int8,
//                                    so that conv1 needs no pre-pass
//                                    (ops/resblock.py:gn_resample_ctas)
//   or, f32 x (and route 0):
//   gn_stats_launch (resblock.cu)    GN1 statistics of x -> per-(sample,
//                                    channel) affine
//   transition_resample_kernel       per output pixel and 8 channels: the
//                                    2x2 (up) or 4x4 (down) input taps, GN1
//                                    affine + SiLU on each, rounded to bf16,
//                                    summed in f32 with the phase
//                                    coefficients (H first, then W, as the
//                                    TPU kernel); writes h (bf16, or f32 for
//                                    the int8 mode, which quantizes it
//                                    unrounded, with the per-sample amax by
//                                    atomicMax on the float bits) and xr
//                                    (the raw x resampled, rounded to bf16,
//                                    or int8 by sx),
//                                    both bf16 on f32 x too: the TPU kernel
//                                    rounds h to its bf16 conv scratch and
//                                    xr to bf16 before the skip's product
//                                    (gddim_tpu/ops/resblock.py:1358-1412)
//   the K4 path of resblock.cu       conv1 with GN1 off (+ the temb row, and
//                                    GN2's partial sums in its epilogue),
//                                    GN2, conv2 with xr as the 1x1 skip's K
//                                    segment: bf16 and int8 through the
//                                    block GEMM (block_gemm.cu; bf16 conv1
//                                    reads h as it is, int8 quantizes it in
//                                    the pre-pass, or reads q(h) as it is);
//                                    on f32 x the bf16 path writing f32 out
//
// What bounds it on the H100: the two 3x3 convs, as in K4 (tensor-core bound
// at 16x16 and 32x32, weight bytes and latency at 4x4 and 8x8). The resample
// is bytes (x read once, h and xr written once), a few us a call; its
// one-launch variant reads each input value once from device memory and
// activates it once. The design replaces K1, two PyTorch FIR passes (five
// to seven launches each) and K4 with one C call of 4-8 launches; folding
// the resample into conv1's A-operand gather, so that h never reaches
// device memory, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act.cuh"
#include "conv.cuh"

extern "C" long long gddim_resblock_workspace(int batch, int h, int w, int cin, int n,
                                              int splits, int parts, int xs);
extern "C" long long gddim_resblock_int8_workspace(int batch, int h, int w, int cin, int n,
                                                   int splits, int parts, int sx);
namespace {

constexpr int RS_THREADS = 256;

__device__ __forceinline__ void load8(const bf16* s, float f[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(s);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load8(const float* s, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0], b = reinterpret_cast<const float4*>(s)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* d, const float f[8]) {
  uint4 v;
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(f[j]);
  *reinterpret_cast<uint4*>(d) = v;
}
__device__ __forceinline__ void store8(float* d, const float f[8]) {
  reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// grid (ceil(Ho*Wo*C/8 / RS_THREADS), B), RS_THREADS threads: one thread per
// output pixel and 8 consecutive channels. TX: x's type; TH: h's; xr bf16,
// or int8 by the static skip scale *qsx when qsx is non-null.
// round_h: h rounded to bf16 (the bf16 mode, whose conv reads h as bf16);
// else (int8 mode) h stays f32 and, when amax is non-null, its per-sample
// amax is folded into amax[b] (zeroed before the launch).
template <typename TX, typename TH>
__global__ void __launch_bounds__(RS_THREADS)
transition_resample_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ shift, int hin, int win, int c, int up,
                           Taps k, int round_h, TH* __restrict__ h_out, void* __restrict__ x_out,
                           float* __restrict__ amax, const float* __restrict__ qsx) {
  __shared__ float red[RS_THREADS / 32];
  const int b = blockIdx.y;
  const int ho = up ? 2 * hin : hin / 2, wo = up ? 2 * win : win / 2;
  const int cv = c / 8;
  const long v = (long)blockIdx.x * RS_THREADS + threadIdx.x;
  float mx = 0.f;
  if (v < (long)ho * wo * cv) {
    const int c0 = (int)(v % cv) * 8;
    const int pix = (int)(v / cv);
    const int yo = pix / wo, xo = pix - (pix / wo) * wo;
    int ys[4], xs[4];
    float ky[4], kx[4];
    const int nt = axis_taps(yo, up, k.h, ys, ky);
    axis_taps(xo, up, k.w, xs, kx);
    float sc[8], sh[8];
    load8(scale + (long)b * c + c0, sc);
    load8(shift + (long)b * c + c0, sh);
    float acc_h[8], acc_x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_h[j] = acc_x[j] = 0.f;
    for (int tx = 0; tx < nt; ++tx) {  // W outer: each column combined along H first
      const int xi = xs[tx];
      if (xi < 0 || xi >= win) continue;
      float col_h[8], col_x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) col_h[j] = col_x[j] = 0.f;
      for (int ty = 0; ty < nt; ++ty) {
        const int yi = ys[ty];
        if (yi < 0 || yi >= hin) continue;
        float f[8];
        load8(x + (((long)b * hin + yi) * win + xi) * c + c0, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = round_bf16(silu(f[j] * sc[j] + sh[j]));
          col_h[j] += ky[ty] * a;
          col_x[j] += ky[ty] * round_bf16(f[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc_h[j] += kx[tx] * col_h[j];
        acc_x[j] += kx[tx] * col_x[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (round_h) acc_h[j] = round_bf16(acc_h[j]);
      mx = fmaxf(mx, fabsf(acc_h[j]));
    }
    const long o = (((long)b * ho + yo) * wo + xo) * c + c0;
    store8(h_out + o, acc_h);
    if (qsx != nullptr) {
      const float inv = 1.0f / *qsx;
      uint2 qv;
      int8_t* e8 = reinterpret_cast<int8_t*>(&qv);
#pragma unroll
      for (int j = 0; j < 8; ++j) e8[j] = quant8(acc_x[j] * inv);
      *reinterpret_cast<uint2*>((int8_t*)x_out + o) = qv;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_x[j] = round_bf16(acc_x[j]);
      store8((bf16*)x_out + o, acc_x);
    }
  }
  if (amax == nullptr) return;  // uniform over the grid
  for (int s = 16; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < RS_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
    // non-negative floats order as their bit patterns do
    atomicMax(reinterpret_cast<int*>(amax + b), __float_as_int(mx));
  }
}

template <typename TX, typename TH>
int resample_launch(const void* x, const float* sc, const float* sh, int batch, int hin, int win,
                    int c, int up, const Taps& k, int round_h, void* h_out, void* x_out,
                    float* amax, const float* qsx, cudaStream_t st) {
  const long ho = up ? 2L * hin : hin / 2, wo = up ? 2L * win : win / 2;
  const long vecs = ho * wo * (c / 8);
  const dim3 grid((unsigned)((vecs + RS_THREADS - 1) / RS_THREADS), batch);
  transition_resample_kernel<TX, TH><<<grid, RS_THREADS, 0, st>>>(
      (const TX*)x, sc, sh, hin, win, c, up, k, round_h, (TH*)h_out, x_out, amax, qsx);
  return (int)cudaGetLastError();
}

// Scratch of one call before the block's own (null base: sizes only).
struct Work {
  void* h;     // (B, Ho, Wo, C) resampled activation
  void* xr;    // (B, Ho, Wo, C) resampled x, bf16 (int8 with the static skip)
  float* sc1;  // (B, C) GN1 affine
  float* sh1;
  float* amax;  // (B,) int8 per-sample mode: amax of h
  char* rest;   // the K4 path's workspace
  size_t xr_off;  // the byte offset of xr
  size_t bytes;
};

Work carve(char* base, int batch, int ho, int wo, int c, size_t h_bytes, size_t x_bytes) {
  Work w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t m = (size_t)batch * ho * wo * c;
  w.h = take(h_bytes * m);
  w.xr_off = off;
  w.xr = take(x_bytes * m);
  w.sc1 = (float*)take(sizeof(float) * batch * c);
  w.sh1 = (float*)take(sizeof(float) * batch * c);
  w.amax = (float*)take(sizeof(float) * batch);
  w.rest = base ? base + off : nullptr;
  w.bytes = off;
  return w;
}

int out_size(int n, int up) { return up ? 2 * n : n / 2; }

// GN1 of x and the resample into h and xr, the first launch of every mode:
// gn_apply_kernel's resample variant on gn_ctas CTAs a sample (bf16 x; h
// bf16 (out_type 0), f32 with its per-sample amax into amax when non-null
// (1), or int8 by the static scale *qs (2); xr int8 by *qsx when qsx is
// non-null).
int gn1_resample_fused(const void* x, int c, const void* gn1_g, const void* gn1_b, int groups1,
                       int batch, int h_in, int w_in, int up, const Taps& k, float eps,
                       int out_type, const float* qs, const Work& wk, float* amax, int gn_ctas,
                       cudaStream_t st, float* scale = nullptr, float* shift = nullptr,
                       const float* qsx = nullptr) {
  GnApply a = {};
  a.xa = x;
  a.ca = c;
  a.batch = batch;
  a.h = h_in;
  a.w = w_in;
  a.groups = groups1;
  a.gamma = (const float*)gn1_g;
  a.beta = (const float*)gn1_b;
  a.eps = eps;
  a.silu = 1;
  a.q = Int8Args{qs, nullptr, 0};
  a.resample = 1;
  a.up = up;
  a.out_type = out_type;
  a.k = k;
  a.out = wk.h;
  a.xr = wk.xr;
  a.qsx = qsx;
  a.amax_out = amax;
  a.scale = scale;
  a.shift = shift;
  a.ctas = gn_ctas;
  return gn_apply_launch(a, st);
}

// The same in two launches (f32 x, or gn_ctas 0): GN1 statistics of x, then
// the resample, TX x's type, TH h's; see transition_resample_kernel.
template <typename TX, typename TH>
int gn1_resample(const void* x, int c, const void* gn1_g, const void* gn1_b, int groups1,
                 int batch, int h_in, int w_in, int up, const Taps& k, float eps, int round_h,
                 const Work& wk, float* amax, cudaStream_t st, const float* qsx = nullptr) {
  int err = gn_stats_launch(x, nullptr, c, 0, batch, h_in * w_in, groups1, (const float*)gn1_g,
                            (const float*)gn1_b, eps, wk.sc1, wk.sh1, nullptr, nullptr,
                            std::is_same<TX, float>::value, st);
  if (!err && amax) err = (int)cudaMemsetAsync(amax, 0, sizeof(float) * batch, st);
  if (!err)
    err = resample_launch<TX, TH>(x, wk.sc1, wk.sh1, batch, h_in, w_in, c, up, k, round_h, wk.h,
                                  wk.xr, amax, qsx, st);
  return err;
}

}  // namespace

extern "C" {

// K9's first pass alone: x (B, h_in, w_in, c) bf16 -> h (B, Ho, Wo, c)
// (out_type 0 bf16, 1 f32 with its per-sample amax into amax (B,) when
// non-null, 2 int8 by the static scale *qs) and xr (B, Ho, Wo, c) bf16;
// (kh, kw) the phase coefficients; GN1's affine into scale, shift (B, c)
// when non-null. ctas: gn_apply_kernel's resample variant on that many
// CTAs a sample, or 0: the two launches it replaces (gn_stats_kernel, then
// transition_resample_kernel; out_type 0 or 1, scale and shift required),
// the yardstick.
int gddim_gn_resample(const void* x, int c, int batch, int h_in, int w_in, int up, float kh0,
                      float kh1, float kh2, float kh3, float kw0, float kw1, float kw2, float kw3,
                      int groups, const void* gamma, const void* beta, float eps, int out_type,
                      const void* qs, void* amax, int ctas, void* h_out, void* xr_out,
                      void* scale, void* shift, void* stream) {
  if (c % 8 || h_in % 2 || w_in % 2 || out_type < 0 || out_type > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Work wk = {};
  wk.h = h_out;
  wk.xr = xr_out;
  wk.sc1 = (float*)scale;
  wk.sh1 = (float*)shift;
  const Taps k = {{kh0, kh1, kh2, kh3}, {kw0, kw1, kw2, kw3}};
  if (ctas)
    return gn1_resample_fused(x, c, gamma, beta, groups, batch, h_in, w_in, up, k, eps, out_type,
                              (const float*)qs, wk, (float*)amax, ctas, st, (float*)scale,
                              (float*)shift);
  if (out_type == 2 || scale == nullptr || shift == nullptr) return (int)cudaErrorInvalidValue;
  return out_type == 0
             ? gn1_resample<bf16, bf16>(x, c, gamma, beta, groups, batch, h_in, w_in, up, k, eps,
                                        1, wk, nullptr, st)
             : gn1_resample<bf16, float>(x, c, gamma, beta, groups, batch, h_in, w_in, up, k, eps,
                                         0, wk, (float*)amax, st);
}

// h, w: the OUTPUT resolution (the block's convs run there); parts: the
// tile plan's tiles_h there
long long gddim_resblock_transition_workspace(int batch, int h, int w, int c, int n, int splits,
                                              int parts) {
  return (long long)(carve(nullptr, batch, h, w, c, sizeof(bf16), sizeof(bf16)).bytes +
                     gddim_resblock_workspace(batch, h, w, c, n, splits, parts, 0));
}

// K9, bf16 mode: x (B, H_in, W_in, C) bf16, or f32 with act_f32 (out in
// x's type). temb_row: the block's (B, N) f32 temb projection, row b at
// temb_row + b * temb_ld. (kh, kw): the phase coefficients. h (bf16) is
// conv1's operand as it is (the bf16 block's path with GN1 off: no
// pre-pass for conv1), xr (bf16) the skip's. f32 x takes GN1's two
// launches (gn_ctas 0). The tile plan (ops/resblock.py:bf16_tile_plan) as
// gddim_resblock takes it, at the output resolution. Scratch:
// gddim_resblock_transition_workspace bytes.
int gddim_resblock_transition(const void* x, int c, int act_f32, const void* temb_row,
                              int temb_ld,
                              const void* gn1_g, const void* gn1_b, int groups1, const void* w1,
                              const void* b1, const void* gn2_g, const void* gn2_b, int groups2,
                              const void* w2, const void* b2, const void* ws, const void* bs,
                              int batch, int h_in,
                              int w_in, int up, float kh0, float kh1, float kh2, float kh3,
                              float kw0, float kw1, float kw2, float kw3, int n, float eps,
                              float out_scale, void* work, int mw, int box_h, int box_b,
                              int tiles_h, int m_tiles, int splits1, int kper1, int splits2,
                              int kper2, int gn_ctas, void* out, void* stream) {
  if (c % 8 || h_in % 2 || w_in % 2 || (act_f32 && gn_ctas)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ho = out_size(h_in, up), wo = out_size(w_in, up);
  const Work wk = carve((char*)work, batch, ho, wo, c, sizeof(bf16), sizeof(bf16));
  const Taps k = {{kh0, kh1, kh2, kh3}, {kw0, kw1, kw2, kw3}};
  const int err =
      gn_ctas  ? gn1_resample_fused(x, c, gn1_g, gn1_b, groups1, batch, h_in, w_in, up, k, eps, 0,
                                    nullptr, wk, nullptr, gn_ctas, st)
      : act_f32 ? gn1_resample<float, bf16>(x, c, gn1_g, gn1_b, groups1, batch, h_in, w_in, up,
                                            k, eps, 1, wk, nullptr, st)
                : gn1_resample<bf16, bf16>(x, c, gn1_g, gn1_b, groups1, batch, h_in, w_in, up, k,
                                           eps, 1, wk, nullptr, st);
  if (err) return err;
  return resblock_gemm_run(false, wk.h, nullptr, c, 0, false, act_f32 != 0, false, 0, nullptr,
                           temb_row, temb_ld, nullptr, nullptr, 0, w1, nullptr, b1, gn2_g, gn2_b,
                           groups2, w2, nullptr, b2, wk.xr, nullptr, c, 0, ws, bs, nullptr, batch,
                           ho, wo, n, eps, out_scale, wk.rest,
                           GemmTiles{mw, box_h, box_b, tiles_h, m_tiles}, splits1, kper1, splits2,
                           kper2, false, nullptr, 1.0f, out, st);
}

long long gddim_resblock_transition_int8_workspace(int batch, int h, int w, int c, int n,
                                                   int splits, int parts) {
  return (long long)(carve(nullptr, batch, h, w, c, sizeof(float), sizeof(bf16)).bytes +
                     gddim_resblock_int8_workspace(batch, h, w, c, n, splits, parts, 0));
}

// The byte offset in gddim_resblock_transition_int8's workspace (arguments
// as gddim_resblock_transition_int8_workspace) of the static skip's int8
// input q(xr) (M, C), as gddim_resblock_int8_xq_offset.
long long gddim_resblock_transition_int8_xq_offset(int batch, int h, int w, int c, int n,
                                                   int splits, int parts) {
  return (long long)carve(nullptr, batch, h, w, c, sizeof(float), sizeof(bf16)).xr_off;
}

// K9, int8 mode: x bf16; conv weights int8 K-major (N, 9 * Cin) with
// per-output-channel scales; act_scales the static [s1, s2] (a device array),
// or null for per-sample scales. h stays f32 (quantized unrounded by the
// int8 block's pre-pass); the skip runs bf16 on xr, or with wss non-null
// the static skip (conv.cuh's StaticSkip): act_scales [s1, s2, sx], ws int8
// K-major (N, C), wss its scales, xr written int8 by the first launch. The
// tile plan as gddim_resblock_int8 takes it, at the output resolution.
// Scratch: gddim_resblock_transition_int8_workspace bytes.
int gddim_resblock_transition_int8(const void* x, int c, const void* temb_row, int temb_ld,
                                   const void* gn1_g, const void* gn1_b, int groups1,
                                   const void* w1q, const void* w1s, const void* b1,
                                   const void* gn2_g, const void* gn2_b, int groups2,
                                   const void* w2q, const void* w2s, const void* b2,
                                   const void* ws, const void* bs, const void* wss,
                                   const void* act_scales,
                                   int batch, int h_in, int w_in, int up,
                                   float kh0, float kh1, float kh2, float kh3, float kw0,
                                   float kw1, float kw2, float kw3, int n, float eps,
                                   float out_scale, void* work, int mw, int box_h, int box_b,
                                   int tiles_h, int m_tiles, int splits1, int kper1, int splits2,
                                   int kper2, int gn_ctas, void* out, void* stream) {
  if (c % 8 || h_in % 2 || w_in % 2 || (wss != nullptr && act_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ho = out_size(h_in, up), wo = out_size(w_in, up);
  const Work wk = carve((char*)work, batch, ho, wo, c, sizeof(float), sizeof(bf16));
  const Taps k = {{kh0, kh1, kh2, kh3}, {kw0, kw1, kw2, kw3}};
  const float* qs = (const float*)act_scales;
  const bool dynamic = qs == nullptr;
  const float* qsx = wss != nullptr ? qs + 2 : nullptr;
  const StaticSkip sk = {(const float*)wss, true};
  // the one-launch route writes q(h) itself with a static scale: conv1 then
  // needs no pre-pass; else h f32 (and its per-sample amax) for the pre-pass
  const bool q8 = gn_ctas && !dynamic;
  const int err =
      gn_ctas ? gn1_resample_fused(x, c, gn1_g, gn1_b, groups1, batch, h_in, w_in, up, k, eps,
                                   q8 ? 2 : 1, qs, wk, dynamic ? wk.amax : nullptr, gn_ctas, st,
                                   nullptr, nullptr, qsx)
              : gn1_resample<bf16, float>(x, c, gn1_g, gn1_b, groups1, batch, h_in, w_in, up, k,
                                          eps, 0, wk, dynamic ? wk.amax : nullptr, st, qsx);
  if (err) return err;
  return resblock_gemm_run(true, wk.h, nullptr, c, 0, !q8, false, q8, 0,
                           dynamic ? wk.amax : nullptr, temb_row, temb_ld, nullptr, nullptr, 0,
                           w1q, w1s, b1, gn2_g, gn2_b, groups2, w2q, w2s, b2, wk.xr, nullptr, c, 0,
                           ws, bs, act_scales, batch, ho, wo, n, eps, out_scale, wk.rest,
                           GemmTiles{mw, box_h, box_b, tiles_h, m_tiles}, splits1, kper1, splits2,
                           kper2, false, nullptr, 1.0f, out, st, sk);
}

}  // extern "C"
