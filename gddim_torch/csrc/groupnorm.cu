// K1, GroupNorm(+SiLU), for Hopper (sm_90a).
//
// Replaces gddim_tpu/ops/groupnorm.py:group_norm_silu (_gn_silu_kernel):
// y = GroupNorm(x) * gamma + beta, then SiLU when silu_on, over x (B, HW, C)
// of bf16, f16 or f32, with f32 statistics and y in x's type; any group
// count that divides C.
//
// gn_silu_kernel<T, VEC>, one launch a call: grid (ctas, B), one cluster of
// `ctas` CTAs a sample (1-16; one CTA is an ordinary launch, 16 a
// non-portable cluster), CTA r over the pixels [r hw / ctas, (r + 1) hw /
// ctas). Thread t owns the VEC channels of vector t % (C / VEC) at pixel
// lane t / (C / VEC) (16-byte vectors: 8 channels of bf16 or f16, 4 of f32;
// one channel where C does not divide into them), so a warp reads whole
// channel rows of consecutive pixels.
//   1. The CTA copies its share once into shared memory, every 16-byte
//      copy in flight at once (cp.async; a CTA's few register loads in
//      flight left the load latency-bound), then sums it per channel from
//      there (lanes in order, then the group's channels in order).
//   2. The cluster's per-group sums meet in distributed shared memory, added
//      in rank order by every CTA alike (no float atomics: the same bits
//      every run): the group's mean.
//   3. The centred squares (x - mean)^2 from shared memory, summed and met
//      the same way: the variance, the plain version's two-pass form
//      (ops/groupnorm.py:group_norm_silu_reference) at no second read of x.
//      The TPU kernel's one-pass E[x^2] - mean^2 (gddim_tpu/ops/
//      groupnorm.py:48-56) differs only in rounding, and cancels at 32x32 on
//      bf16 inputs.
//   4. rstd = 1 / sqrt(var + eps), the affine folded, y = x * a + (beta -
//      mean * a) and SiLU in f32 from shared memory, stored in x's type
//      (gamma and beta loaded into shared memory while the share arrives).
// The plan (ops/resblock.py:gn_silu_ctas) is the fewest CTAs that hold the
// sample, more where the batch alone leaves most of the 132 SMs idle and
// each CTA still holds 16 KB. A sample that 16 CTAs cannot hold (hold 0)
// takes the same kernel on 16 CTAs reading its share again in passes 3 and
// 4 (from L2 where it fits), as does a C of no 16-byte vectors, through
// registers.
//
// What bounds it on the H100: bytes (x read once, y written once; the
// 32x32x128 bf16 site moves 2 x 16.8 MB at B=64, 10 us at 3.35 TB/s); at
// the small sites (4x4, 8x8) the launch and the cluster's barriers. The design
// answers the bytes with one read of x into shared memory and 16-byte
// accesses, and the small sites with one CTA a sample (no cluster barrier
// across SMs) where the batch leaves the card idle anyway.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv.cuh"
#include "hopper.cuh"

namespace cgr = cooperative_groups;

namespace {

constexpr int GS_THREADS = 256;
constexpr int GS_MAX_CTAS = 16;
constexpr int GS_SMEM = 227 * 1024;  // shared memory a block can use on the H100
constexpr int GS_UNROLL = 4;         // vectors in flight a thread

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// VEC consecutive values of T, one aligned load or store (16 bytes where
// VEC * sizeof(T) is)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T e[VEC];
};

// The channel vectors a pixel (C / VEC) and the pixel lanes a CTA sums in
// parallel; ops/resblock.py:gn_silu_smem mirrors them.
__host__ __device__ inline int gs_lanes(int cv) { return cv <= GS_THREADS ? GS_THREADS / cv : 1; }

__host__ __device__ inline long gs_align(long n) { return (n + 127) & ~127L; }

// Shared memory of one CTA over `share` pixels of c channels of `bytes`
// each: the share (where held), the lanes' per-channel sums, the channel
// totals, the folded affine (2 c), and four per-group arrays (groups <= c).
__host__ __device__ inline long gs_smem(int c, int bytes, long share, int vec, bool hold) {
  const int lanes = gs_lanes(c / vec);
  return (hold ? gs_align(share * c * bytes) : 0) + 4L * c * (lanes + 7);
}

struct GsArgs {
  const void* x;
  void* out;
  const float* gamma;
  const float* beta;
  int hw, c, groups;
  float eps;
  int silu;
  int ctas;
  int hold;
};

// The cluster's total of arr[g] (one float a CTA): the peers' values loaded
// at once, then added in rank order, alike in every CTA.
__device__ __forceinline__ float cluster_total(cgr::cluster_group& cluster, float* arr, int g,
                                               int ctas) {
  if (ctas == 1) return arr[g];
  float v[GS_MAX_CTAS];
#pragma unroll
  for (int r = 0; r < GS_MAX_CTAS; ++r) v[r] = r < ctas ? cluster.map_shared_rank(arr, r)[g] : 0.f;
  float t = v[0];
#pragma unroll
  for (int r = 1; r < GS_MAX_CTAS; ++r)
    if (r < ctas) t += v[r];
  return t;
}

// The per-channel sums of this CTA's lanes into per-group sums gsum:
// lanes in order, then each group's channels in order.
__device__ __forceinline__ void group_sums(const float* lane, float* chan, float* gsum, int lanes,
                                           int c, int groups) {
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += GS_THREADS) {
    float t = 0.f;
#pragma unroll 4
    for (int l = 0; l < lanes; ++l) t += lane[(long)l * c + ch];
    chan[ch] = t;
  }
  __syncthreads();
  const int cg = c / groups;
  for (int g = threadIdx.x; g < groups; g += GS_THREADS) {
    float t = 0.f;
#pragma unroll 4
    for (int k = 0; k < cg; ++k) t += chan[g * cg + k];
    gsum[g] = t;
  }
}

// grid (a.ctas, B), GS_THREADS threads, gs_smem bytes; clusters of a.ctas
// along x when a.ctas > 1
template <typename T, int VEC>
__global__ void __launch_bounds__(GS_THREADS) gn_silu_kernel(const GsArgs a) {
  extern __shared__ __align__(128) unsigned char gsm[];
  using V = Vec<T, VEC>;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int ctas = a.ctas;
  const int rank = ctas > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.y, c = a.c, groups = a.groups, cg = c / groups;
  const int cv = c / VEC, lanes = gs_lanes(cv), slots = lanes * cv;
  const long p0 = (long)a.hw * rank / ctas;
  const int px = (int)((long)a.hw * (rank + 1) / ctas - p0);
  const long share = (a.hw + ctas - 1) / ctas;
  T* held = reinterpret_cast<T*>(gsm);
  float* lane = reinterpret_cast<float*>(gsm + (a.hold ? gs_align(share * c * sizeof(T)) : 0));
  float* chan = lane + (long)lanes * c;
  float* aff = chan + c;  // a, then beta - mean * a
  float* gsum = aff + 2 * c;  // this CTA's per-group sums (read by the peers)
  float* gm2 = gsum + c;      // ... and centred squares (read by the peers)
  float* gmean = gm2 + c;
  float* grstd = gmean + c;
  const T* x = static_cast<const T*>(a.x) + ((long)b * a.hw + p0) * c;
  T* y = static_cast<T*>(a.out) + ((long)b * a.hw + p0) * c;
  const T* src = a.hold ? held : x;
  const float n = (float)a.hw * (float)cg;

  // 1. the share read once (held: copied into shared memory, every copy in
  // flight, and summed from there), summed per channel
  constexpr bool ASYNC = VEC * sizeof(T) == 16;
  if (ASYNC && a.hold) {
    const long n16 = (long)px * c * sizeof(T) / 16;
    const char* g8 = reinterpret_cast<const char*>(x);
    char* s8 = reinterpret_cast<char*>(held);
    for (long i = threadIdx.x; i < n16; i += GS_THREADS) cp_async16(s8 + 16 * i, g8 + 16 * i);
    cp_async_commit();
  }
  // gamma and beta, their loads in flight with the share's (stage 4 reads them)
  for (int ch = threadIdx.x; ch < c; ch += GS_THREADS) {
    aff[ch] = a.gamma[ch];
    aff[c + ch] = a.beta[ch];
  }
  if (ASYNC && a.hold) {
    cp_async_wait_chunk(0);
    __syncthreads();
  }
  const T* first = ASYNC && a.hold ? held : x;
  for (int s = threadIdx.x; s < slots; s += GS_THREADS) {
    const int l = s / cv, j = s - l * cv;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int p = l;
    for (; p + (GS_UNROLL - 1) * lanes < px; p += GS_UNROLL * lanes) {
      V v[GS_UNROLL];
#pragma unroll
      for (int u = 0; u < GS_UNROLL; ++u)
        v[u] = *reinterpret_cast<const V*>(first + (long)(p + u * lanes) * c + j * VEC);
#pragma unroll
      for (int u = 0; u < GS_UNROLL; ++u) {
        if (!ASYNC && a.hold)
          *reinterpret_cast<V*>(held + (long)(p + u * lanes) * c + j * VEC) = v[u];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_f32(v[u].e[e]);
      }
    }
    for (; p < px; p += lanes) {
      const V v = *reinterpret_cast<const V*>(first + (long)p * c + j * VEC);
      if (!ASYNC && a.hold) *reinterpret_cast<V*>(held + (long)p * c + j * VEC) = v;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += to_f32(v.e[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) lane[(long)l * c + j * VEC + e] = acc[e];
  }
  group_sums(lane, chan, gsum, lanes, c, groups);

  // 2. the cluster's sums in rank order: the group means
  if (ctas > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int g = threadIdx.x; g < groups; g += GS_THREADS)
    gmean[g] = cluster_total(cluster, gsum, g, ctas) / n;
  __syncthreads();

  // 3. the centred squares, from the held share
  for (int s = threadIdx.x; s < slots; s += GS_THREADS) {
    const int l = s / cv, j = s - l * cv;
    float mu[VEC], acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mu[e] = gmean[(j * VEC + e) / cg];
      acc[e] = 0.f;
    }
    for (int p = l; p < px; p += lanes) {
      const V v = *reinterpret_cast<const V*>(src + (long)p * c + j * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_f32(v.e[e]) - mu[e];
        acc[e] += d * d;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) lane[(long)l * c + j * VEC + e] = acc[e];
  }
  group_sums(lane, chan, gm2, lanes, c, groups);
  if (ctas > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int g = threadIdx.x; g < groups; g += GS_THREADS)
    grstd[g] = 1.0f / sqrtf(cluster_total(cluster, gm2, g, ctas) / n + a.eps);
  if (ctas > 1) cluster_arrive_relaxed();  // done with the peers' sums; waited for before exiting
  __syncthreads();

  // 4. the folded affine, then y = x * a + b (+ SiLU) in f32, stored in T
  for (int ch = threadIdx.x; ch < c; ch += GS_THREADS) {  // this thread's gamma and beta
    const int g = ch / cg;
    const float s = aff[ch] * grstd[g];
    aff[ch] = s;
    aff[c + ch] = aff[c + ch] - gmean[g] * s;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += GS_THREADS) {
    const int l = s / cv, j = s - l * cv;
    float sc[VEC], sh[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sc[e] = aff[j * VEC + e];
      sh[e] = aff[c + j * VEC + e];
    }
    for (int p = l; p < px; p += lanes) {
      const V v = *reinterpret_cast<const V*>(src + (long)p * c + j * VEC);
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float f = fmaf(to_f32(v.e[e]), sc[e], sh[e]);
        // SiLU: IEEE division and expf in f32 (the training path's bound);
        // for a 16-bit output __fdividef and __expf, as the pre-passes
        if (a.silu)
          f = std::is_same<T, float>::value ? f / (1.0f + expf(-f))
                                            : __fdividef(f, 1.0f + __expf(-f));
        o.e[e] = from_f32<T>(f);
      }
      *reinterpret_cast<V*>(y + (long)p * c + j * VEC) = o;
    }
  }
  if (ctas > 1) cluster_wait();  // the peers are done with this CTA's shared memory
}

template <typename T, int VEC>
int gs_run(const GsArgs& a, int batch, size_t smem, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    int err = (int)cudaFuncSetAttribute(gn_silu_kernel<T, VEC>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM);
    if (!err)
      err = (int)cudaFuncSetAttribute(gn_silu_kernel<T, VEC>,
                                      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.ctas, (unsigned)batch);
  cfg.blockDim = dim3(GS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)a.ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.ctas > 1 ? 1 : 0;  // one CTA a sample: an ordinary launch
  int err = (int)cudaLaunchKernelEx(&cfg, gn_silu_kernel<T, VEC>, a);
  if (!err) err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_GN_SILU);
  return err;
}

template <typename T>
int gs_type(const GsArgs& a, int batch, cudaStream_t st) {
  constexpr int V16 = 16 / sizeof(T);
  const int vec = a.c % V16 == 0 ? V16 : 1;
  const long smem = gs_smem(a.c, sizeof(T), (a.hw + a.ctas - 1) / a.ctas, vec, a.hold != 0);
  if (smem > GS_SMEM) return (int)cudaErrorInvalidValue;
  return vec == 1 ? gs_run<T, 1>(a, batch, smem, st) : gs_run<T, V16>(a, batch, smem, st);
}

}  // namespace

extern "C" {

// K1: GroupNorm(+SiLU when silu_on) of x (B, hw, c) into out, both of
// dtype 0 bf16, 1 f16, 2 f32 (16-byte aligned), gamma and beta (c,) f32,
// `groups` dividing c; ctas CTAs a sample (1-16), hold: they hold it in
// shared memory (else passes 3 and 4 read x again). The plan:
// ops/resblock.py:gn_silu_ctas and gn_silu_holds.
int gddim_gn_silu(const void* x, int dtype, int batch, int hw, int c, int groups,
                  const void* gamma, const void* beta, float eps, int silu_on, int ctas, int hold,
                  void* out, void* stream) {
  if (batch < 1 || hw < 1 || c < 1 || groups < 1 || c % groups || ctas < 1 ||
      ctas > GS_MAX_CTAS || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const GsArgs a = {x, out, (const float*)gamma, (const float*)beta, hw, c, groups, eps, silu_on,
                    ctas, hold};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return gs_type<__nv_bfloat16>(a, batch, st);
  if (dtype == 1) return gs_type<__half>(a, batch, st);
  return gs_type<float>(a, batch, st);
}

// Shared memory bytes of one gn_silu_kernel CTA (no stream): `bytes` an
// element, hw pixels a sample over ctas CTAs, held or not
long long gddim_gn_silu_smem(int c, int bytes, int hw, int ctas, int hold) {
  const int v16 = 16 / bytes;
  return (long long)gs_smem(c, bytes, (hw + ctas - 1) / ctas, c % v16 == 0 ? v16 : 1, hold != 0);
}

}  // extern "C"
