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
// so here the backward is a chain of launches, each a hand-written kernel.
// Every GEMM operand is a bf16 tensor that the TPU kernel rounds itself
// (a1mm, gmm, d, gumm, the skip's x: resblock_bwd.py:171-248), so each is
// written once by the pass that makes it and streamed by TMA:
//
//   1  gn_stats(x)          GN1 statistics (resblock.cu)
//   2  pre-pass             a1 = bf16(silu(GN1 x)); bf16(x) for the 1x1 skip
//   3  block GEMM (STATS)   u = conv1(a1) + b1 + temb_proj, f32, and GN2's
//                           per-channel partial sums from its epilogue
//   4  GN2 pre-pass         d = bf16(silu(GN2 u) * mask / keep), and GN2's
//                           affine, mean and rstd for step 7
//   5  round_kernel         gmm = bf16(r * g), as the TPU kernel scales g
//                           before its rounding
//   6  block GEMM (dgrad)   gd = conv(gmm, W2 flipped/transposed): the dgrad
//                           of a stride-1 SAME 3x3 conv is the same conv of
//                           the cotangent with the taps flipped and (Cin,
//                           Cout) swapped, W2[8 - t] read as stored (K-major)
//   7  gn_bwd_kernel<true>  dropout + SiLU + GN2 backward -> gumm =
//                           bf16(dL/du); dtemb_proj = sum over pixels of gu;
//                           per-sample partials of dGN2 s/b and of sum(g):
//                           a cluster a sample holds (dL/dd, u) in shared
//                           memory, one read of each input
//   8  block GEMM (dgrad)   ga1 = conv(gumm, W1 flipped/transposed)
//   9  block GEMM (dgrad)   (1x1 skip only) dx = gmm @ W_skip^T. The skip's
//                           dgrad cannot share step 8's accumulator: ga1
//                           still goes through the GN1 backward, the skip
//                           term not.
//   10 gn_bwd_kernel<false> SiLU + GN1 backward of ga1, plus the skip term
//                           (step 9's dx, or r * g for the identity) -> dx;
//                           per-sample partials of dGN1 s/b
//   11 wgrad_kernel x3      dW2 = sum_pixels shift_t(d)^T gmm, dW1 = sum
//                           shift_t(a1)^T gumm, dW_skip = sum x^T gmm: the
//                           one new GEMM shape, reducing over M = B*H*W with
//                           a (taps*Cin, Cout) output; pixel splits write f32
//                           partials, which
//   12 rowsum_kernel        sums in split order, as it sums the per-sample
//                           partials into dGN s/b, db1, db2 and db_skip.
//
// No float atomics anywhere: every sum runs in a fixed order, so two runs on
// the same inputs give the same bits.
//
// What bounds it on the H100: the five GEMMs (recomputed conv1, two dgrads,
// two 3x3 wgrads) are 5/2 of the forward's tensor-core work and dominate at
// 32x32 and 16x16; the GN-backward passes are bytes (each input read once,
// the sample held in a cluster's shared memory). The convs and dgrads run on the
// block GEMM (block_gemm.cu), the wgrads on wgrad_kernel below: both wgmma
// fed by a TMA ring, the activation arithmetic done once in the passes that
// round each operand, where the WMMA conv and wgrad kernels they replaced
// recomputed GN, SiLU and the mask for every tap.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "act.cuh"
#include "conv.cuh"
#include "hopper.cuh"

namespace cgr = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// GroupNorm(+SiLU) backward of one sample, steps 7 and 10 of K7: the
// backward of _resblock_bwd_kernel's GN2+SiLU with the dropout mask
// (gddim_tpu/ops/resblock_bwd.py:209-222) and GN1+SiLU (:233-242).
//
// For each element: y = v*sc + sh, s = sigmoid(y), dy = dpre [* mask/keep] *
// s*(1 + y*(1 - s)), yhat = (v - mean)*rstd. Per channel: dGN scale = sum
// dy*yhat, dGN bias = sum dy (and GN2's sum of the cotangent g, for db2 and
// db_skip). Per group: m1 = mean of dy*gamma, m2 = mean of dy*gamma*yhat,
// which are sum_c gamma_c * (channel sums) / n. Then o = rstd*(dy*gamma - m1
// - yhat*m2) [+ add_scale*add], written f32 (GN1's dx) or bf16 (GN2's gumm,
// rounded once), and GN2 sums o per channel (dtemb_proj).
//
// What bounds it on the H100: bytes. Each input read once and each output
// written once is 15 B an element for GN2 (dpre, u f32, the mask, g, gumm
// bf16) and 16 for GN1 (dpre, x, add, dx f32): at B = 128 over the 70
// blocks of cld/accr_dcifar10, 18.8 GB, ~5.6 ms at 3.35 TB/s. The design:
// gn_bwd_kernel<GN2>, grid (ctas, B), one cluster of `ctas` CTAs a sample
// (1-16, a pure function of the shape: ops/resblock.py:gn_bwd_plan):
//   1. CTA r brings dpre and v of the first `held` of its pixels [r hw /
//      ctas, (r + 1) hw / ctas) into shared memory by 16-byte asynchronous
//      copies, all in flight at once in up to four commit groups, and reads
//      the rest from device memory in both passes. The plan holds what two
//      CTAs an SM hold, in one wave of CTAs: at B = 128 the SMs' shared
//      memory holds a quarter of a 32x32 layer's (dpre, v) at once, and
//      holding samples whole (16-CTA clusters, more waves) measured slower
//      than reading the rest again (cluster scheduling, each CTA's fixed
//      barriers).
//   2. Pass 1, a commit group at a time as it lands: thread (lane, v) takes
//      the 8 channels of vector v along the channel row (16-byte accesses)
//      of pixels lane, lane + lanes, ...; the mask and g come straight from
//      device memory, two pixels' loads in flight a thread; dy replaces dpre
//      in shared memory. The lanes' per-channel sums meet in lane order.
//   3. The CTAs' sums meet through distributed shared memory in rank order;
//      every CTA folds every channel and group itself (the same bits in
//      each: no float atomics, and two runs give the same bits).
//   4. Pass 2 reads dy and v from shared memory (the add term from device
//      memory) and writes o; GN2's sums of o meet as in 3, each CTA
//      totalling a slice of the channels.
constexpr int GB_THREADS = 256;
constexpr int GB_CHUNKS = 4;               // commit groups of a CTA's copies, at most
constexpr int GB_CHUNK_BYTES = 16 * 1024;  // ... one a 16 KB of the share
constexpr int GB_U = 2;                    // pixel vectors a thread loads ahead
constexpr int GB_PEERS = 8;                // peers' sums in flight a thread
constexpr int GB_MAX_CTAS = 16;
constexpr int GB_MAX_GROUPS = 32;
constexpr int GB_SMEM = 227 * 1024;

__host__ __device__ inline long gb_align(long n) { return (n + 127) & ~127L; }

// Shared memory of one CTA holding `held` pixels of c channels (ops/
// resblock.py:gn_bwd_smem mirrors it): dpre (then dy) and v of the held
// pixels, f32; the CTA's per-channel sums (dy*yhat, dy, g, o: 4 c floats,
// read by the peers); the lanes' buffer (their sums, then the cluster's
// per-channel totals); the groups' m1 and m2.
struct GbLayout {
  long v, cs, red, grp, total;
};
__host__ __device__ inline GbLayout gb_layout(int c, long held) {
  const int lanes = GB_THREADS / (c / 8);
  GbLayout l;
  l.v = gb_align(4 * held * c);
  l.cs = l.v + gb_align(4 * held * c);
  l.red = l.cs + gb_align(16L * c);
  l.grp = l.red + gb_align(4L * (lanes > 2 ? lanes : 2) * c);
  l.total = l.grp + gb_align(8L * GB_MAX_GROUPS);
  return l;
}

struct GnBwdArgs {
  const float* dpre;   // (B, HW, C) gradient w.r.t. the GN+SiLU(+dropout) output
  const int8_t* mask;  // (B, HW, C) or null (GN2)
  float inv_keep;
  const float* v;      // (B, HW, C) the GN input
  const float* sc;     // (B, C) forward affine: y = v*sc + sh
  const float* sh;
  const float* mean;   // (B, G)
  const float* rstd;
  const float* gamma;  // (C,)
  const float* add;    // (B, HW, C) added to o times add_scale, or null (GN1)
  float add_scale;
  const float* extra;  // (B, HW, C) summed per (sample, channel) into part_extra (GN2)
  float* out;          // (B, HW, C) f32 o (GN1); may alias add
  bf16* out_bf16;      // (B, HW, C) bf16 o (GN2)
  float* part_s;       // (B, C) sum over pixels of dy*yhat
  float* part_b;       // (B, C) sum over pixels of dy
  float* part_extra;   // (B, C) sum of extra (GN2)
  float* chan_out;     // (B, C) sum over pixels of o (GN2)
  int HW, C, G;
};

// The cluster plan (ops/resblock.py:GnBwdPlan): CTAs a sample, the largest
// share's pixels, the pixels a CTA holds, shared memory bytes.
struct GbPlan {
  int ctas, share, held, smem;
};

__device__ __forceinline__ void ld8f(float f[8], const float* s) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// dy over d in place, d = dpre already times the mask / keep
__device__ __forceinline__ void gb_dy(float d[8], const float v[8], const float sc[8],
                                      const float sh[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = v[j] * sc[j] + sh[j];
    const float s = __fdividef(1.0f, 1.0f + __expf(-y));
    d[j] *= s * (1.0f + y * (1.0f - s));
  }
}

// grid (ctas, B), GB_THREADS threads, gb_layout(C, held).total bytes,
// clusters of ctas along x
template <bool GN2>
__global__ void __launch_bounds__(GB_THREADS, 2)
gn_bwd_kernel(const GnBwdArgs p, const int held) {
  extern __shared__ __align__(128) unsigned char gsm[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)gridDim.x;
  const int b = blockIdx.y, t = threadIdx.x;
  const int C = p.C, cv = C / 8, lanes = GB_THREADS / cv, hw = p.HW;
  const int p0 = (int)((long)hw * rank / ctas), p1 = (int)((long)hw * (rank + 1) / ctas);
  const int n = p1 - p0, nh = n < held ? n : held;
  const GbLayout L = gb_layout(C, held);
  float* D = reinterpret_cast<float*>(gsm);  // [held][C] dpre, then dy
  float* V = reinterpret_cast<float*>(gsm + L.v);
  float* cs = reinterpret_cast<float*>(gsm + L.cs);  // [4][C] this CTA's sums
  float* red = reinterpret_cast<float*>(gsm + L.red);
  float* grp = reinterpret_cast<float*>(gsm + L.grp);  // [2][G] m1, m2
  const long base = ((long)b * hw + p0) * C;  // the CTA's first element

  // 1. the held pixels' dpre and v, every copy in flight at once
  const long nb = 8L * nh * C / GB_CHUNK_BYTES;
  const int nch = nb < 1 ? 1 : nb > GB_CHUNKS ? GB_CHUNKS : (int)nb;
  for (int k = 0; k < nch; ++k) {
    const long e0 = (long)nh * k / nch * C, units = ((long)nh * (k + 1) / nch * C - e0) / 4;
    for (long i = t; i < 2 * units; i += GB_THREADS) {
      if (i < units)
        cp_async16(D + e0 + 4 * i, p.dpre + base + e0 + 4 * i);
      else
        cp_async16(V + e0 + 4 * (i - units), p.v + base + e0 + 4 * (i - units));
    }
    cp_async_commit();
  }
  const int lane = t / cv, c8 = 8 * (t % cv);
  const bool on = lane < lanes;
  float sc[8], sh[8], gam[8], mu[8], rs[8];
  if (on) {
    ld8f(sc, p.sc + (long)b * C + c8);
    ld8f(sh, p.sh + (long)b * C + c8);
    ld8f(gam, p.gamma + c8);
    const int cg = C / p.G;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mu[j] = p.mean[b * p.G + (c8 + j) / cg];
      rs[j] = p.rstd[b * p.G + (c8 + j) / cg];
    }
  }

  // 2. pass 1, a commit group at a time as it lands; then the pixels not
  // held, from device memory
  float ps[8], pb[8], pe[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ps[j] = pb[j] = pe[j] = 0.f;
  int pl = lane;
  for (int k = 0; k <= nch; ++k) {
    const bool held_part = k < nch;
    if (held_part) {
      cp_async_wait_chunk(nch - 1 - k);  // groups 0..k of this thread's copies
      __syncthreads();                   // ... and of every thread's
    }
    const int end = held_part ? (int)((long)nh * (k + 1) / nch) : n;
    while (on && pl < end) {
      const int cnt = min(GB_U, (end - pl + lanes - 1) / lanes);
      float d[GB_U][8], v[GB_U][8], e[GB_U][8];
      uint2 mk[GB_U];
#pragma unroll
      for (int u = 0; u < GB_U; ++u) {
        if (u >= cnt) continue;
        const long o = (long)(pl + u * lanes) * C + c8;
        if (held_part) {
          ld8f(d[u], D + o);
          ld8f(v[u], V + o);
        } else {
          ld8f(d[u], p.dpre + base + o);
          ld8f(v[u], p.v + base + o);
        }
        if (GN2) {
          ld8f(e[u], p.extra + base + o);
          mk[u] = p.mask ? *reinterpret_cast<const uint2*>(p.mask + base + o) : uint2{};
        }
      }
#pragma unroll
      for (int u = 0; u < GB_U; ++u) {
        if (u >= cnt) continue;
        if (GN2 && p.mask) {
          const int8_t* m8 = reinterpret_cast<const int8_t*>(&mk[u]);
#pragma unroll
          for (int j = 0; j < 8; ++j) d[u][j] *= (float)m8[j] * p.inv_keep;
        }
        gb_dy(d[u], v[u], sc, sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float yhat = (v[u][j] - mu[j]) * rs[j];
          ps[j] += d[u][j] * yhat;
          pb[j] += d[u][j];
          if (GN2) pe[j] += e[u][j];
        }
        if (held_part) st8(D + (long)(pl + u * lanes) * C + c8, d[u]);
      }
      pl += cnt * lanes;
    }
  }
  // the lanes' per-channel sums in lane order: dy*yhat, dy (and g) into cs
  auto lane_sum = [&](const float* val, float* dst) {
    if (on) st8(red + lane * C + c8, val);
    __syncthreads();
    for (int c = t; c < C; c += GB_THREADS) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * C + c];
      dst[c] = s;
    }
    __syncthreads();
  };
  lane_sum(ps, cs);
  lane_sum(pb, cs + C);
  if (GN2) lane_sum(pe, cs + 2 * C);
  cluster_arrive();
  cluster_wait();

  // 3. the cluster's totals per channel, peers in rank order, then m1, m2
  for (int c = t; c < C; c += GB_THREADS) {
    float ts = 0.f, tb = 0.f, te = 0.f;
    for (int r0 = 0; r0 < ctas; r0 += GB_PEERS) {
      float qs[GB_PEERS], qb[GB_PEERS], qe[GB_PEERS];
#pragma unroll
      for (int r = 0; r < GB_PEERS; ++r) {
        if (r0 + r >= ctas) continue;
        const float* peer = cluster.map_shared_rank(cs, r0 + r);
        qs[r] = peer[c];
        qb[r] = peer[C + c];
        if (GN2) qe[r] = peer[2 * C + c];
      }
#pragma unroll
      for (int r = 0; r < GB_PEERS; ++r) {
        if (r0 + r >= ctas) continue;
        ts += qs[r];
        tb += qb[r];
        if (GN2) te += qe[r];
      }
    }
    red[c] = ts;
    red[C + c] = tb;
    if (rank == 0) {
      p.part_s[(long)b * C + c] = ts;
      p.part_b[(long)b * C + c] = tb;
      if (GN2) p.part_extra[(long)b * C + c] = te;
    }
  }
  __syncthreads();
  const int cg = C / p.G;
  const float inv_n = 1.0f / ((float)hw * cg);
  for (int g = t; g < p.G; g += GB_THREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int c = g * cg + j;
      s1 += p.gamma[c] * red[C + c];
      s2 += p.gamma[c] * red[c];
    }
    grp[g] = s1 * inv_n;
    grp[p.G + g] = s2 * inv_n;
  }
  if (!GN2) cluster_arrive_relaxed();  // done with the peers' sums; waited for before exiting
  __syncthreads();

  // 4. pass 2: o from the held dy and v, then from the pixels not held
  float m1[8], m2[8], po[8];
  if (on) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m1[j] = grp[(c8 + j) / cg];
      m2[j] = grp[p.G + (c8 + j) / cg];
      po[j] = 0.f;
    }
  }
  pl = lane;
  for (int seg = 0; seg < 2; ++seg) {
    const bool held_part = seg == 0;
    const int end = held_part ? nh : n;
    while (on && pl < end) {
      const int cnt = min(GB_U, (end - pl + lanes - 1) / lanes);
      float d[GB_U][8], v[GB_U][8], a[GB_U][8];
      uint2 mk[GB_U];
#pragma unroll
      for (int u = 0; u < GB_U; ++u) {
        if (u >= cnt) continue;
        const long o = (long)(pl + u * lanes) * C + c8;
        if (held_part) {
          ld8f(d[u], D + o);
          ld8f(v[u], V + o);
        } else {
          ld8f(d[u], p.dpre + base + o);
          ld8f(v[u], p.v + base + o);
          if (GN2) mk[u] = p.mask ? *reinterpret_cast<const uint2*>(p.mask + base + o) : uint2{};
        }
        if (!GN2 && p.add) ld8f(a[u], p.add + base + o);
      }
#pragma unroll
      for (int u = 0; u < GB_U; ++u) {
        if (u >= cnt) continue;
        if (!held_part) {
          if (GN2 && p.mask) {
            const int8_t* m8 = reinterpret_cast<const int8_t*>(&mk[u]);
#pragma unroll
            for (int j = 0; j < 8; ++j) d[u][j] *= (float)m8[j] * p.inv_keep;
          }
          gb_dy(d[u], v[u], sc, sh);
        }
        float o8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float yhat = (v[u][j] - mu[j]) * rs[j];
          o8[j] = rs[j] * (d[u][j] * gam[j] - m1[j] - yhat * m2[j]);
          if (!GN2 && p.add) o8[j] += p.add_scale * a[u][j];
          po[j] += o8[j];
        }
        const long o = base + (long)(pl + u * lanes) * C + c8;
        if (GN2)
          st8(p.out_bf16 + o, o8);
        else
          st8(p.out + o, o8);
      }
      pl += cnt * lanes;
    }
  }
  if (GN2) {
    // the sums of o per channel: lanes, then the cluster in rank order, CTA
    // r totalling channels [r C / ctas, (r + 1) C / ctas)
    lane_sum(po, cs + 3 * C);
    cluster_arrive();
    cluster_wait();
    const int per = C / ctas;
    for (int c = rank * per + t; c < (rank + 1) * per; c += GB_THREADS) {
      float tot = 0.f;
      for (int r0 = 0; r0 < ctas; r0 += GB_PEERS) {
        float q[GB_PEERS];
#pragma unroll
        for (int r = 0; r < GB_PEERS; ++r)
          if (r0 + r < ctas) q[r] = cluster.map_shared_rank(cs, r0 + r)[3 * C + c];
#pragma unroll
        for (int r = 0; r < GB_PEERS; ++r)
          if (r0 + r < ctas) tot += q[r];
      }
      p.chan_out[(long)b * C + c] = tot;
    }
    cluster_arrive_relaxed();
  }
  cluster_wait();  // the peers are done with this CTA's shared memory
}

template <bool GN2>
int gb_run(const GnBwdArgs& a, const GbPlan& plan, int batch, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    int err = (int)cudaFuncSetAttribute(gn_bwd_kernel<GN2>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, GB_SMEM);
    if (!err)
      err = (int)cudaFuncSetAttribute(gn_bwd_kernel<GN2>,
                                      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)plan.ctas, (unsigned)batch);
  cfg.blockDim = dim3(GB_THREADS);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)plan.ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int err = (int)cudaLaunchKernelEx(&cfg, gn_bwd_kernel<GN2>, a, plan.held);
  if (!err) err = (int)cudaGetLastError();
  return err;
}

// One GroupNorm(+SiLU) backward: GN2's form (out_bf16, extra and chan_out
// set; mask optional; no add) or GN1's (out and add set). Counted where it
// launches; cudaErrorInvalidValue for a plan or shape it does not take.
int gn_bwd_launch(const GnBwdArgs& a, const GbPlan& plan, int batch, cudaStream_t st) {
  const bool gn2 = a.out_bf16 != nullptr;
  const int c = a.C;
  const bool ok =
      batch > 0 && a.HW > 0 && c % 8 == 0 && c >= 8 && c / 8 <= GB_THREADS && a.G > 0 &&
      a.G <= GB_MAX_GROUPS && c % a.G == 0 && plan.ctas >= 1 && plan.ctas <= GB_MAX_CTAS &&
      (plan.ctas & (plan.ctas - 1)) == 0 && plan.ctas <= a.HW && c % plan.ctas == 0 &&
      plan.share == (a.HW + plan.ctas - 1) / plan.ctas &&
      plan.held > 0 && plan.held <= plan.share && plan.smem == gb_layout(c, plan.held).total &&
      plan.smem <= GB_SMEM && a.dpre && a.v && a.sc && a.sh && a.mean && a.rstd && a.gamma &&
      a.part_s && a.part_b &&
      (gn2 ? (a.extra && a.part_extra && a.chan_out && !a.out && !a.add)
           : (a.out && !a.mask && !a.extra && !a.chan_out));
  if (!ok) return (int)cudaErrorInvalidValue;
  const int err = gn2 ? gb_run<true>(a, plan, batch, st) : gb_run<false>(a, plan, batch, st);
  if (!err) count_launch(COUNT_GN_BWD);
  return err;
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

// gmm = bf16(r * g), 8 values a thread (step 5). grid ceil(vecs / 256), 256 threads.
__global__ void __launch_bounds__(256)
round_kernel(const float* __restrict__ g, long vecs, float r, bf16* __restrict__ out) {
  const long v = (long)blockIdx.x * 256 + threadIdx.x;
  if (v >= vecs) return;
  Pack8<float> pk;
  ld8(pk, g + v * 8);
  float f[8];
  unpack8(pk, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] *= r;
  st8(out + v * 8, f);
}

// ---------------------------------------------------------------------------
// The weight gradient of a stride-1 SAME 3x3 conv (taps 9) or a 1x1 (taps 1),
// _wgrad9 of gddim_tpu/ops/resblock_bwd.py:72 (and the skip's x^T g):
//
//   dW[t * C + c, n] = sum over pixels m of shift_t(A)[m, c] * G[m, n]
//
// A (B, H, W, C) and G (M, N) bf16, f32 sums. An implicit GEMM with the
// pixels as its K: the CTA's output is 2 MW m64 blocks of dW rows (64
// channels of one tap each, consecutive in (t, c)) by 128 columns of N, and
// its K runs over WG_PIX-pixel slices. A slice's A is, for each m64 block,
// one 4-D TMA box of the NHWC activation (64 channels, W, box_h rows, box_b
// samples: WG_PIX pixels) at (x, y) offsets (dx - 1, dy - 1), the TMA unit's
// zeros the SAME padding, as the block GEMM reads its conv operand; wgmma
// takes it M-major (the channels along the 128-byte row) through the
// transpose bit of A. G is two 2-D boxes of the slice's WG_PIX consecutive
// pixel rows (64 columns each), N-major through the transpose bit of B, and
// serves the CTA's 2 MW blocks, whichever taps they hold. One producer warp
// keeps a 3-stage (MW 1, two CTAs an SM) or 4-stage ring of full/empty
// mbarriers fed; two consumer warpgroups run m64n128k16 f32.bf16.bf16 on MW
// blocks each. Pixel splits (grid z) write f32 partials straight from the
// accumulators, and rowsum_kernel sums them in split order (no atomics).
// The plan (MW, the box, splits, slices a split) is a pure function of the
// shapes, computed in Python (ops/resblock.py:wgrad_plan).
//
// What bounds it on the H100: the products (2 * M * taps * C * N operations
// at 989 TFLOP/s) against A and G read once (2 M (C + N) bytes): at 32x32
// and 16x16 the operations; at 8x8 and 4x4 (M a few thousand pixels at B =
// 128, a few hundred at B = 4) the partials' bytes and the launches. A CTA
// reads its blocks' A and G from L2 for every tap it holds, so L2's rate
// bounds a CTA with few blocks: MW 2 (256 dW rows a CTA) reads 48 KB a slice
// for 4 MB of products.
constexpr int WG_PIX = 64;      // pixels of a K slice
constexpr int WG_ROW = 128;     // bytes of a slice row: 64 bf16 channels
constexpr int WG_BOX = WG_PIX * WG_ROW;  // 8 KB: an m64 block's A, or half of G
constexpr int WG_THREADS = 288;  // consumer warpgroups 0 and 1, then the producer warp
constexpr int WG_CONSUMER_WARPS = 8;

template <int MW>
struct WgTile {
  static constexpr int STAGES = MW == 1 ? 3 : 4;
  static constexpr int A_BYTES = 2 * MW * WG_BOX;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * WG_BOX;
  // the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB atom, barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

static_assert(WgTile<2>::SMEM <= 227 * 1024, "the MW 2 wgrad ring exceeds shared memory");
static_assert(2 * (WgTile<1>::SMEM + 1024) <= 228 * 1024, "two MW 1 wgrad CTAs do not fit an SM");

struct WgPlan {
  int C, taps, N, B, H, W;
  int slices, per;  // WG_PIX-pixel slices in all, and a split's
  float* out;       // (splits, taps * C, N) f32: the partials, or dW when not split
};

// grid (taps * C / 64 / (2 MW), N / 128, splits), WG_THREADS threads,
// WgTile<MW>::SMEM dynamic shared memory. Split z sums the slices
// [z * per, min((z + 1) * per, slices)).
template <int MW>
__global__ void __launch_bounds__(WG_THREADS, 3 - MW)
wgrad_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap gmap,
             const WgPlan p) {
  using T = WgTile<MW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full0 = ring_u32 + T::STAGES * T::STAGE_BYTES;  // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * T::STAGES;

  const int j0 = blockIdx.x * 2 * MW;  // the CTA's first m64 block of dW rows
  const int n0 = blockIdx.y * 128;
  const int s_beg = blockIdx.z * p.per;
  const int n_sl = min(p.slices, s_beg + p.per) - s_beg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WG_CONSUMER_WARPS) {
    // the producer: one thread keeps the ring's loads in flight
    if (lane == 0) {
      const int hw = p.H * p.W;
      for (int i = 0; i < n_sl; ++i) {
        const int s = i % T::STAGES;
        if (i >= T::STAGES) mbar_wait(empty0 + 8 * s, ((i / T::STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t a = ring_u32 + s * T::STAGE_BYTES, gb = a + T::A_BYTES;
        mbar_expect_tx(full, T::STAGE_BYTES);
        // the slice's pixels: whole rows of one sample (H*W a multiple of
        // WG_PIX), or whole samples (WG_PIX a multiple of H*W: y0 = 0)
        const int m0 = (s_beg + i) * WG_PIX;
        const int b0 = m0 / hw, y0 = (m0 - b0 * hw) / p.W;
#pragma unroll
        for (int k = 0; k < 2 * MW; ++k) {
          const int row = 64 * (j0 + k);
          const int tap = row / p.C, c0 = row - tap * p.C;
          const int dx = p.taps == 9 ? tap % 3 - 1 : 0, dy = p.taps == 9 ? tap / 3 - 1 : 0;
          tma_load_4d(a + k * WG_BOX, &amap, full, c0, dx, y0 + dy, b0);
        }
        tma_load_2d(gb, &gmap, full, n0, m0);
        tma_load_2d(gb + WG_BOX, &gmap, full, n0 + 64, m0);
      }
    }
    return;
  }

  // the consumers: warpgroup g owns the CTA's m64 blocks g * MW + t
  const int g = warp >> 2;
  uint32_t acc[MW][64];
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[t][j] = 0u;

  for (int i = 0; i < n_sl; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(full0 + 8 * s, (i / T::STAGES) & 1);
    const uint32_t a = ring_u32 + s * T::STAGE_BYTES + g * MW * WG_BOX;
    const uint32_t gb = ring_u32 + s * T::STAGE_BYTES + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_PIX / 16; ++kk) {
      // A and G alike: pixel rows of 128 bytes (64 channels of A, 64
      // columns of G), 8-row atoms 1 KB apart, a k16 step 16 rows; G's
      // second 64 columns WG_BOX on (the leading offset)
      const uint64_t dg = sw128_desc(gb + 2048 * kk, WG_BOX, 1024);
#pragma unroll
      for (int t = 0; t < MW; ++t)
        wgmma_m64n128k16_b32<1, 1>(acc[t], sw128_desc(a + t * WG_BOX + 2048 * kk, WG_BOX, 1024),
                                   dg);
    }
    wgmma_commit();
    // the previous slice's group has completed: free its stage
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % T::STAGES));
  }
  wgmma_wait<0>();

  // Accumulator layout: register 4j + 2h + e holds row 16 (warp % 4) +
  // lane / 4 + 8 h of its m64 block, column 8 j + 2 (lane % 4) + e; a warp
  // instruction stores 8 rows of 32 bytes
  const long K = (long)p.taps * p.C;
  float* dst = p.out + (long)blockIdx.z * K * p.N;
  const int row0 = 16 * (warp & 3) + (lane >> 2), col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < MW; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* d = dst + (64L * (j0 + g * MW + t) + row0 + 8 * h) * p.N + col;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(d + 8 * j) =
            make_float2(__uint_as_float(acc[t][4 * j + 2 * h]),
                        __uint_as_float(acc[t][4 * j + 2 * h + 1]));
    }
}

// The wgrad plan of ops/resblock.py:wgrad_plan: MW, the A box (W x box_h
// rows x box_b samples: WG_PIX pixels), the pixel splits and slices a split.
struct WgTiles {
  int mw, box_h, box_b, splits, per;
};

template <int MW>
int wgrad_run(const CUtensorMap* maps, dim3 grid, const WgPlan& p, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(
        wgrad_kernel<MW>, cudaFuncAttributeMaxDynamicSharedMemorySize, WgTile<MW>::SMEM);
    if (err) return err;
    attr = true;
  }
  wgrad_kernel<MW><<<grid, WG_THREADS, WgTile<MW>::SMEM, st>>>(maps[0], maps[1], p);
  return (int)cudaGetLastError();
}

// dW (taps * C, N) f32 = sum over pixels of shift_t(a)^T g: a (B, H, W, C)
// and g (B * H * W, N) bf16; partial: splits * taps * C * N f32 when the
// plan splits the pixels. Counted where it launches; cudaErrorInvalidValue
// for a plan or shape it does not take.
int wgrad_launch(const void* a, const void* g, int C, int taps, int N, int batch, int h, int w,
                 const WgTiles& t, float* partial, float* dw, cudaStream_t st) {
  const long m = (long)batch * h * w;
  const int blocks = taps * C / 64;
  const long slices = (m + WG_PIX - 1) / WG_PIX;
  if ((taps != 1 && taps != 9) || C % 64 || N % 128 || (t.mw != 1 && t.mw != 2) ||
      blocks % (2 * t.mw) || w * t.box_h * t.box_b != WG_PIX || t.box_h > 256 || t.box_b > 256 ||
      (t.box_b > 1 && t.box_h != h) || (t.box_b == 1 && (h * w) % WG_PIX) || t.splits < 1 ||
      t.per < 1 || (long)(t.splits - 1) * t.per >= slices || (long)t.splits * t.per < slices ||
      (t.splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2] = {};
  const cuuint64_t adims[4] = {(cuuint64_t)C, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t astrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)w * C * 2,
                                  (cuuint64_t)h * w * C * 2};
  const cuuint32_t abox[4] = {64, (cuuint32_t)w, (cuuint32_t)t.box_h, (cuuint32_t)t.box_b};
  const cuuint64_t gdims[2] = {(cuuint64_t)N, (cuuint64_t)m};
  const cuuint64_t gstrides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t gbox[2] = {64, WG_PIX};
  if (!bf16_map(&maps[0], a, 4, adims, astrides, abox) ||
      !bf16_map(&maps[1], g, 2, gdims, gstrides, gbox))
    return (int)cudaErrorInvalidValue;
  WgPlan p;
  p.C = C;
  p.taps = taps;
  p.N = N;
  p.B = batch;
  p.H = h;
  p.W = w;
  p.slices = (int)slices;
  p.per = t.per;
  p.out = t.splits > 1 ? partial : dw;
  const dim3 grid(blocks / (2 * t.mw), N / 128, t.splits);
  int err = t.mw == 1 ? wgrad_run<1>(maps, grid, p, st) : wgrad_run<2>(maps, grid, p, st);
  if (err) return err;
  count_launch(COUNT_WGRAD);
  if (t.splits > 1) err = rowsum(partial, t.splits, (long)taps * C * N, 1.0f, dw, st);
  return err;
}

// ---------------------------------------------------------------------------
// K7. The plan of one block shape, from Python (ops/resblock_bwd.py:
// train_bwd_plan): four block-GEMM plans (mw, box_h, box_b, tiles_h,
// m_tiles, splits, kper each: conv1's recompute Cin -> N, the dgrads N -> N
// and N -> Cin, the skip's 1x1 N -> Cin, zeros without a skip), three
// wgrad plans (mw, box_h, box_b, splits, per each: dW2, dW1, dW_skip), then
// the GN backwards' cluster plans (ctas, share, held, smem: GN2's on N
// channels, GN1's on Cin; ops/resblock.py:gn_bwd_plan).
constexpr int PLAN_GEMM = 7;
constexpr int PLAN_WG = 5;
constexpr int PLAN_GB = 4;
constexpr int PLAN_INTS = 4 * PLAN_GEMM + 3 * PLAN_WG + 2 * PLAN_GB;

struct GemmStep {
  GemmTiles t;
  int splits, kper;
};

GemmStep gemm_step(const int* plan, int i) {
  const int* q = plan + PLAN_GEMM * i;
  return GemmStep{GemmTiles{q[0], q[1], q[2], q[3], q[4]}, q[5], q[6]};
}

WgTiles wg_step(const int* plan, int i) {
  const int* q = plan + 4 * PLAN_GEMM + PLAN_WG * i;
  return WgTiles{q[0], q[1], q[2], q[3], q[4]};
}

GbPlan gb_step(const int* plan, int i) {
  const int* q = plan + 4 * PLAN_GEMM + 3 * PLAN_WG + PLAN_GB * i;
  return GbPlan{q[0], q[1], q[2], q[3]};
}

struct Work {
  float *sc1, *sh1, *mean1, *rstd1, *sc2, *sh2, *mean2, *rstd2;
  float* u;     // (M, N) conv1 output, f32
  float* gn2;   // (2, B, parts, N) GN2's partial sums and squares, from conv1
  bf16* a1;     // (M, Cin) the bf16 operands
  bf16* xb;     // (M, Cin), with a 1x1 skip
  bf16* d;      // (M, N)
  bf16* gmm;    // (M, N)
  bf16* gumm;   // (M, N)
  float* gd;    // (M, max(N, Cin)) dL/dd, then dL/da1 over it
  float *p_gn2s, *p_gn2b, *p_g, *p_gn1s, *p_gn1b;  // per-sample partials
  float* conv_partial;  // (conv splits, M, max(N, Cin))
  float* wg_partial;    // (wgrad splits, taps * max(N, Cin), N)
  size_t bytes;
};

Work carve(char* base, int batch, int h, int w, int cin, int n, int g1, int g2, bool skip,
           const int* plan) {
  Work wk;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  auto f32 = [&](size_t count) { return (float*)take(sizeof(float) * count); };
  auto b16 = [&](size_t count) { return (bf16*)take(sizeof(bf16) * count); };
  const long m = (long)batch * h * w;
  const int cmax = cin > n ? cin : n;
  wk.sc1 = f32((size_t)batch * cin);
  wk.sh1 = f32((size_t)batch * cin);
  wk.mean1 = f32((size_t)batch * g1);
  wk.rstd1 = f32((size_t)batch * g1);
  wk.sc2 = f32((size_t)batch * n);
  wk.sh2 = f32((size_t)batch * n);
  wk.mean2 = f32((size_t)batch * g2);
  wk.rstd2 = f32((size_t)batch * g2);
  wk.u = f32((size_t)m * n);
  wk.gn2 = f32((size_t)2 * batch * gemm_step(plan, 0).t.tiles_h * n);
  wk.a1 = b16((size_t)m * cin);
  wk.xb = skip ? b16((size_t)m * cin) : nullptr;
  wk.d = b16((size_t)m * n);
  wk.gmm = b16((size_t)m * n);
  wk.gumm = b16((size_t)m * n);
  wk.gd = f32((size_t)m * cmax);
  wk.p_gn2s = f32((size_t)batch * n);
  wk.p_gn2b = f32((size_t)batch * n);
  wk.p_g = f32((size_t)batch * n);
  wk.p_gn1s = f32((size_t)batch * cin);
  wk.p_gn1b = f32((size_t)batch * cin);
  int cs = 1, ws = 1;  // the most splits of the GEMMs and of the wgrads
  for (int i = 0; i < (skip ? 4 : 3); ++i) cs = std::max(cs, gemm_step(plan, i).splits);
  for (int i = 0; i < (skip ? 3 : 2); ++i) ws = std::max(ws, wg_step(plan, i).splits);
  wk.conv_partial = cs > 1 ? f32((size_t)cs * m * cmax) : nullptr;
  wk.wg_partial = ws > 1 ? f32((size_t)ws * 9 * cmax * n) : nullptr;
  wk.bytes = off;
  return wk;
}

// One GEMM of the chain on the block GEMM: a 3x3 (taps 9) or 1x1 of the
// bf16 operand a (cin channels) into f32 out (n channels); kmajor: a dgrad
int gemm(const void* a, const void* w, int cin, int n, int taps, bool kmajor, int batch, int h,
         int w_, const GemmStep& s, float* partial, float* out, cudaStream_t st) {
  BlockGemm g = {};
  g.a = a;
  g.w = w;
  g.w_kmajor = kmajor;
  g.cin = cin;
  g.taps = taps;
  g.B = batch;
  g.H = h;
  g.W = w_;
  g.N = n;
  g.out_scale = 1.0f;
  g.out = out;
  g.out_f32 = true;
  g.partial = partial;
  g.splits = s.splits;
  g.kper = s.kper;
  return block_gemm_launch(g, s.t, st);
}

}  // namespace

extern "C" {

long long gddim_resblock_bwd_workspace(int batch, int h, int w, int cin, int n, int groups1,
                                       int groups2, int skip, const int* plan) {
  return (long long)carve(nullptr, batch, h, w, cin, n, groups1, groups2, skip != 0, plan).bytes;
}

// K7: the 12 gradients of one training block (f32 in and out).
//   x (B,H,W,Cin), temb_row (B,N), g = dL/dout (B,H,W,N), mask (B,H,W,N) int8 or null;
//   w1 (3,3,Cin,N), w2 (3,3,N,N) and ws (Cin,N) (null: the identity skip), bf16 in the
//   forward (HWIO) layout, which the dgrads read as it is. out_scale r = 1/sqrt(2)
//   (skip_rescale) or 1. plan: PLAN_INTS ints in host memory (train_bwd_plan).
// Outputs (f32): dx (B,H,W,Cin), dtemb (B,N), dgn1s/dgn1b (Cin), dw1 (9*Cin, N), db1,
//   dgn2s, dgn2b (N), dw2 (9*N, N), db2 (N), and with ws dws (Cin, N) and dbs (N).
int gddim_resblock_bwd(const void* x, const void* temb_row, const void* gn1_g, const void* gn1_b,
                       int groups1, const void* w1, const void* b1, const void* gn2_g,
                       const void* gn2_b, int groups2, const void* w2, const void* ws,
                       const void* mask, float inv_keep, const void* g, int batch, int h, int w_,
                       int cin, int n, float eps, float out_scale, const int* plan, void* work,
                       void* dx, void* dtemb, void* dgn1s, void* dgn1b, void* dw1, void* db1,
                       void* dgn2s, void* dgn2b, void* dw2, void* db2, void* dws, void* dbs,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hw = h * w_;
  const bool skip = ws != nullptr;
  const Work wk = carve((char*)work, batch, h, w_, cin, n, groups1, groups2, skip, plan);
  const float* gf = (const float*)g;
  const float r = out_scale;
  const GemmStep s_u = gemm_step(plan, 0), s_d2 = gemm_step(plan, 1), s_d1 = gemm_step(plan, 2),
                 s_sk = gemm_step(plan, 3);

  // 1-2: GN1, a1 = bf16(silu(GN1 x)) and bf16(x)
  int err = gn_stats_launch(x, nullptr, cin, 0, batch, hw, groups1, (const float*)gn1_g,
                            (const float*)gn1_b, eps, wk.sc1, wk.sh1, wk.mean1, wk.rstd1, true, st);
  if (!err)
    err = f32_prepass_launch((const float*)x, nullptr, cin, 0, batch, hw, wk.sc1, wk.sh1, wk.a1,
                             wk.xb, st);
  // 3: u = conv1(a1) + b1 + temb_proj, f32, and GN2's partial sums
  if (!err) {
    BlockGemm c = {};
    c.a = wk.a1;
    c.w = w1;
    c.cin = cin;
    c.taps = 9;
    c.B = batch;
    c.H = h;
    c.W = w_;
    c.N = n;
    c.bias = (const float*)b1;
    c.temb = (const float*)temb_row;
    c.temb_ld = n;
    c.out_scale = 1.0f;
    c.out = wk.u;
    c.out_f32 = true;
    c.gn_part = wk.gn2;
    c.partial = wk.conv_partial;
    c.splits = s_u.splits;
    c.kper = s_u.kper;
    c.train = true;
    err = block_gemm_launch(c, s_u.t, st);
  }
  // 4: d = bf16(silu(GN2 u) * mask / keep), and GN2's affine and statistics
  if (!err)
    err = gn2_train_prepass_launch(wk.u, wk.gn2, s_u.t.tiles_h, groups2, (const float*)gn2_g,
                                   (const float*)gn2_b, eps, (const int8_t*)mask, inv_keep, batch,
                                   hw, n, wk.sc2, wk.sh2, wk.mean2, wk.rstd2, wk.d, st);
  // 5: gmm = bf16(r * g)
  if (!err) {
    const long vecs = (long)batch * hw * n / 8;
    round_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(gf, vecs, r, wk.gmm);
    err = (int)cudaGetLastError();
    if (!err) count_launch(COUNT_PREPASS_BF16);
  }
  // 6: dL/dd = conv(gmm, W2 flipped/transposed)
  if (!err) err = gemm(wk.gmm, w2, n, n, 9, true, batch, h, w_, s_d2, wk.conv_partial, wk.gd, st);
  // 7: dropout + SiLU + GN2 backward -> gumm, dtemb, partials
  if (!err) {
    GnBwdArgs a = {};
    a.dpre = wk.gd;
    a.mask = (const int8_t*)mask;
    a.inv_keep = inv_keep;
    a.v = wk.u;
    a.sc = wk.sc2;
    a.sh = wk.sh2;
    a.mean = wk.mean2;
    a.rstd = wk.rstd2;
    a.gamma = (const float*)gn2_g;
    a.extra = gf;
    a.out_bf16 = wk.gumm;
    a.part_s = wk.p_gn2s;
    a.part_b = wk.p_gn2b;
    a.part_extra = wk.p_g;
    a.chan_out = (float*)dtemb;
    a.HW = hw;
    a.C = n;
    a.G = groups2;
    err = gn_bwd_launch(a, gb_step(plan, 0), batch, st);
  }
  // 8: dL/da1 = conv(gumm, W1 flipped/transposed), over dL/dd
  if (!err)
    err = gemm(wk.gumm, w1, n, cin, 9, true, batch, h, w_, s_d1, wk.conv_partial, wk.gd, st);
  // 9: the 1x1 skip's dgrad straight into dx
  if (!err && skip)
    err = gemm(wk.gmm, ws, n, cin, 1, true, batch, h, w_, s_sk, wk.conv_partial, (float*)dx, st);
  // 10: SiLU + GN1 backward, plus the skip term -> dx
  if (!err) {
    GnBwdArgs a = {};
    a.dpre = wk.gd;
    a.v = (const float*)x;
    a.sc = wk.sc1;
    a.sh = wk.sh1;
    a.mean = wk.mean1;
    a.rstd = wk.rstd1;
    a.gamma = (const float*)gn1_g;
    a.add = skip ? (const float*)dx : gf;
    a.add_scale = skip ? 1.0f : r;
    a.out = (float*)dx;
    a.part_s = wk.p_gn1s;
    a.part_b = wk.p_gn1b;
    a.HW = hw;
    a.C = cin;
    a.G = groups1;
    err = gn_bwd_launch(a, gb_step(plan, 1), batch, st);
  }
  // 11: weight gradients
  if (!err)  // dW2 = sum shift_t(d)^T gmm
    err = wgrad_launch(wk.d, wk.gmm, n, 9, n, batch, h, w_, wg_step(plan, 0), wk.wg_partial,
                       (float*)dw2, st);
  if (!err)  // dW1 = sum shift_t(a1)^T gumm
    err = wgrad_launch(wk.a1, wk.gumm, cin, 9, n, batch, h, w_, wg_step(plan, 1), wk.wg_partial,
                       (float*)dw1, st);
  if (!err && skip)  // dW_skip = sum x^T gmm
    err = wgrad_launch(wk.xb, wk.gmm, cin, 1, n, batch, h, w_, wg_step(plan, 2), wk.wg_partial,
                       (float*)dws, st);
  // 12: per-sample partials -> parameter gradients
  if (!err) err = rowsum(wk.p_gn2s, batch, n, 1.0f, (float*)dgn2s, st);
  if (!err) err = rowsum(wk.p_gn2b, batch, n, 1.0f, (float*)dgn2b, st);
  if (!err) err = rowsum((const float*)dtemb, batch, n, 1.0f, (float*)db1, st);
  if (!err) err = rowsum(wk.p_g, batch, n, r, (float*)db2, st);
  if (!err && skip) err = rowsum(wk.p_g, batch, n, r, (float*)dbs, st);
  if (!err) err = rowsum(wk.p_gn1s, batch, cin, 1.0f, (float*)dgn1s, st);
  if (!err) err = rowsum(wk.p_gn1b, batch, cin, 1.0f, (float*)dgn1b, st);
  return err;
}

// K7's GroupNorm(+SiLU) backward alone (gn_bwd_kernel): GN2's form when
// out_bf16 is set (mask optional, extra, part_extra and chan_out set), GN1's
// when out is (add optional, may alias out); (B, hw, c) f32 dpre and v, the
// forward's affine sc, sh (B, c) and mean, rstd (B, groups); the cluster
// plan of ops/resblock.py:gn_bwd_plan (ctas, share, held, smem).
int gddim_gn_bwd(const void* dpre, const void* mask, float inv_keep, const void* v,
                 const void* sc, const void* sh, const void* mean, const void* rstd,
                 const void* gamma, const void* add, float add_scale, const void* extra, void* out,
                 void* out_bf16, void* part_s, void* part_b, void* part_extra, void* chan_out,
                 int batch, int hw, int c, int groups, int ctas, int share, int held, int smem,
                 void* stream) {
  GnBwdArgs a = {};
  a.dpre = (const float*)dpre;
  a.mask = (const int8_t*)mask;
  a.inv_keep = inv_keep;
  a.v = (const float*)v;
  a.sc = (const float*)sc;
  a.sh = (const float*)sh;
  a.mean = (const float*)mean;
  a.rstd = (const float*)rstd;
  a.gamma = (const float*)gamma;
  a.add = (const float*)add;
  a.add_scale = add_scale;
  a.extra = (const float*)extra;
  a.out = (float*)out;
  a.out_bf16 = (bf16*)out_bf16;
  a.part_s = (float*)part_s;
  a.part_b = (float*)part_b;
  a.part_extra = (float*)part_extra;
  a.chan_out = (float*)chan_out;
  a.HW = hw;
  a.C = c;
  a.G = groups;
  return gn_bwd_launch(a, GbPlan{ctas, share, held, smem}, batch, (cudaStream_t)stream);
}

// The wgrad kernel alone: dw (taps * C, N) f32 = sum over pixels of
// shift_t(a)^T g, a (B, H, W, C) and g (B, H, W, N) bf16; the plan of
// ops/resblock.py:wgrad_plan; scratch `work`: splits * taps * C * N f32
// when splits > 1.
int gddim_wgrad(const void* a, const void* g, int batch, int h, int w, int c, int n, int taps,
                int mw, int box_h, int box_b, int splits, int per, void* work, void* dw,
                void* stream) {
  return wgrad_launch(a, g, c, taps, n, batch, h, w, WgTiles{mw, box_h, box_b, splits, per},
                      (float*)work, (float*)dw, (cudaStream_t)stream);
}

}  // extern "C"
