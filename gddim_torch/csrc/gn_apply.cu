// GN1 in one pass for Hopper (sm_90a): a sample's GroupNorm statistics and
// their consumer in one launch, the sample read from device memory once.
//
// Replaces, at every GN1 site of the sampling path, the two launches that
// computed the TPU kernels' GN1 (gn_silu_tile, gddim_tpu/ops/resblock.py:
// 345-356, inside _resblock_kernel_v2 / _resblock_pair_kernel_v2 (K2, K3),
// _attnblock_kernel (K5, attnblock.py:86-92, no SiLU) and
// _resblock_transition_kernel (K9, resblock.py:1304-1420)): gn_stats_kernel,
// which read x only to learn its statistics, then a second pass that read x
// again (the block pre-pass, amax_kernel in the per-sample int8 mode, or
// K9's transition_resample_kernel, which evaluated GN1 + SiLU again for
// each of the 4 (up) or 16 (down) taps that read a value).
//
// gn_apply_kernel<TQ, RESAMPLE>: grid (8, B), one cluster of 8 CTAs a
// sample (a portable cluster size); a sample an eighth of which does not fit
// a CTA's shared memory takes the two launches (ops/resblock.py:
// gn_apply_ctas).
//   1. Each CTA brings its share of the sample into shared memory by 16-byte
//      asynchronous copies (cp.async, every thread's in flight at once, in
//      four commit groups; the pair's two inputs each by channel rows) and
//      sums each channel's values and squares as the groups land:
//      gn_stats_kernel's lanes, order and arithmetic over gn_stats_kernel's
//      share of the pixels, so the statistics are its bits.
//   2. The CTAs' sums meet through distributed shared memory in rank order,
//      and every CTA folds every group itself (gn_stats_kernel's fold: the
//      same result in each CTA, no float atomics, no second exchange); the
//      affine stays in shared memory.
//   3. convert: the resident share through the affine (+SiLU), then bf16
//      or int8, written NHWC where the block pre-pass wrote it (convert8,
//      the pre-pass's own arithmetic: the same bits), each thread over one
//      channel vector, its affine in registers; with the int8 blocks' static
//      skip (QX), the same held values quantized by sx too, the skip's q(x),
//      as its pre-pass wrote it. The per-sample int8
//      mode first takes the amax of the activated share, a cluster max
//      (exact in any order), then quantizes; it writes the amax for the
//      GEMM's dequantization.
//      resample (K9): each CTA holds the input rows its output rows need
//      (its own and a halo row on each side, read from L2), applies GN1 +
//      SiLU to each value once, rounded to bf16 (the TPU kernel's
//      zero-bordered scratch), and resamples from shared memory in
//      transition_resample_kernel's order and rounding points: h (bf16; f32
//      with the per-sample amax as a cluster max; or, with a static scale,
//      int8 by the quantizer of the int8 pre-pass, which K9 then skips) and
//      xr = resample(bf16(x)) in bf16 (or, K9's static skip, int8 by sx
//      from the unrounded sums).
//   K12 (gddim_tpu/ops/groupnorm.py:group_norm_silu_quant, conv_impl
//      'int8': GN + SiLU + per-sample int8 in front of K11's int8 conv) is
//      the per-sample int8 convert with the TPU kernel's arithmetic
//      (UNFOLD): ((x - mean) * rstd) * gamma + beta, each operation rounded,
//      and the sample's scale max(amax, 1e-12) / 127 written by rank 0
//      beside q: one read of x, where (group, sample) programs without a
//      cluster must meet through device memory for the amax and read x
//      again (in Triton, which has no clusters, three times).
// A CTA's shared memory stays until the cluster has read it: each CTA
// arrives on the cluster barrier once its reads of its peers are done and
// waits on it before it exits, so phase 3 overlaps the barrier.
//
// What bounds it on the H100: bytes, at the largest GN1 site (32x32x384
// bf16, B=64: x 50 MB read once and a 50 MB written once, int8 25 MB, ~30
// us at 3.35 TB/s, where the two launches read x twice); at the small sites
// (8x8, 4x4) a launch and three cluster barriers. The design answers with
// one read of x, all of a CTA's copies in flight at once, and one launch
// where there were two (three per sample with the amax pass). What it
// costs: a CTA converts its share only once the whole sample has met, so
// load and convert overlap only across CTAs; the convert's SiLU takes two
// MUFU operations an element on 8 warps a CTA, two or four CTAs an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act.cuh"
#include "conv.cuh"
#include "hopper.cuh"

namespace cgr = cooperative_groups;

namespace {

constexpr int GA_CTAS = 8;        // a sample's cluster (ops/resblock.py:GN_APPLY_CTAS)
constexpr int GA_THREADS = 256;   // gn_stats_kernel's THREADS_GN: the same lanes, the same sums
constexpr int GA_MIN_CTAS = 4;    // resident an SM (64 registers a thread), where shared memory allows
constexpr int GA_MIN_CTAS_RS = 3;  // the resample variant's (80 registers)
constexpr int GA_CHUNKS = 4;      // commit groups of a CTA's copies, at most (cp_async_wait_chunk)
constexpr int GA_CHUNK_BYTES = 16 * 1024;  // ... one a 16 KB of the share
constexpr int GA_PEERS = 8;       // a channel's peer sums in flight a thread
constexpr int GA_MAX_C = 2048;    // 8 channels a summing thread, at least one pixel lane
constexpr int GA_UNROLL = 2;      // activation vectors in flight a thread
constexpr int GA_SMEM = 227 * 1024;  // shared memory a block can use on the H100
constexpr int GA_MISC = 256;      // the CTA's amax, the sample's, the block max

__host__ __device__ inline long ga_align(long n) { return (n + 127) & ~127L; }

// Shared memory of one CTA holding `px` pixels of c channels (the largest
// share of the launch, so that every CTA of the cluster has the same
// offsets): the share (bf16; the pair's xa rows then xb rows), in the
// resample variant its activation beside it, the CTA's channel sums and
// squares (read by the peers), gamma and beta, the lanes' partial sums or
// squares (then the folded affine over them: 2 C floats at least), and
// GA_MISC bytes; the largest GN1 share, 32x32x384 over 8 CTAs, then takes
// 112,384 bytes, so that two CTAs share an SM.
// ops/resblock.py:gn_apply_smem mirrors it.
struct GaLayout {
  long act, cs, gb, uni, misc, total;
};
__host__ __device__ inline GaLayout ga_layout(int c, long px, bool resample) {
  const int lanes = GA_THREADS / (c / 8);
  const long raw = ga_align(2 * px * c);
  GaLayout l;
  l.act = raw;
  l.cs = resample ? 2 * raw : raw;
  l.gb = l.cs + ga_align(8L * c);
  l.uni = l.gb + ga_align(8L * c);
  l.misc = l.uni + ga_align(4L * (lanes > 2 ? lanes : 2) * c);
  l.total = l.misc + GA_MISC;
  return l;
}

// The rows of the resample variant's CTA r of `ctas` on an input of hin x
// win pixels: the rows it holds [lo, hi) (the rows of its statistics share,
// gn_stats_kernel's pixels [r hw / ctas, (r + 1) hw / ctas), and those its
// outputs read), the rows it activates [nlo, nhi), and its output rows [o0,
// o1). The outputs go by units: an input row and its two output rows (up),
// or an output row and its two input rows (down); each output row reads its
// own input rows and one more on each side. ops/resblock.py:_resample_rows
// mirrors it.
struct RsRows {
  int lo, hi, nlo, nhi, o0, o1;
};
__host__ __device__ inline RsRows rs_rows(int hin, int win, int up, int ctas, int r) {
  const long hw = (long)hin * win;
  const int p0 = (int)(hw * r / ctas), p1 = (int)(hw * (r + 1) / ctas);
  const int units = up ? hin : hin / 2;
  const int u0 = (int)((long)units * r / ctas), u1 = (int)((long)units * (r + 1) / ctas);
  RsRows g = {p0 / win, (p1 + win - 1) / win, 0, 0, 0, 0};
  if (u1 > u0) {
    const int nlo = up ? u0 - 1 : 2 * u0 - 1, nhi = up ? u1 + 1 : 2 * u1 + 1;
    g.nlo = nlo < 0 ? 0 : nlo;
    g.nhi = nhi > hin ? hin : nhi;
    g.o0 = up ? 2 * u0 : u0;
    g.o1 = up ? 2 * u1 : u1;
    g.lo = g.lo < g.nlo ? g.lo : g.nlo;
    g.hi = g.hi > g.nhi ? g.hi : g.nhi;
  }
  return g;
}

// K12's GroupNorm affine of 8 activations, unfolded as the TPU kernel's
// (gddim_tpu/ops/groupnorm.py:100-103): ((x - mean) * rstd) * gamma + beta,
// each operation rounded (no fused multiply-add), then SiLU when silu_on
__device__ __forceinline__ void unfolded8(float f[8], const float mu[8], const float rs[8],
                                          const float* gamma, const float* beta, int silu_on) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j], mu[j]), rs[j]), gamma[j]), beta[j]);
    f[j] = silu_on ? silu(y) : y;
  }
}

// max of v over the CTA's threads, into *out (red: GA_THREADS / 32 floats);
// thread 0 writes
__device__ __forceinline__ void block_max(float v, float* red, float* out) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < GA_THREADS / 32; ++w) v = fmaxf(v, red[w]);
    *out = v;
  }
}

// grid (a.ctas, B), GA_THREADS threads, ga_layout(C, a.px, RESAMPLE).total
// bytes of shared memory, clusters of a.ctas along x. TQ: convert's output
// (bf16, int8_t), or the resample's h (bf16, float, int8_t). UNFOLD: K12
// (int8 per sample; the affine unfolded). QX: convert also writes q(x) by
// the static skip scale (int8 static).
template <typename TQ, bool RESAMPLE, bool UNFOLD = false, bool QX = false>
__global__ void __launch_bounds__(GA_THREADS, RESAMPLE ? GA_MIN_CTAS_RS : GA_MIN_CTAS)
gn_apply_kernel(const GnApply a, const int px) {
  extern __shared__ __align__(128) unsigned char gsm[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = a.ctas;
  const int b = blockIdx.y, t = threadIdx.x;
  const int ca = a.ca, cb = a.cb, c_tot = ca + cb, cv = c_tot / 8, lanes = GA_THREADS / cv;
  const int hw = a.h * a.w;
  // pixels [p0, p1) summed (gn_stats_kernel's share), [l0, l1) held
  const int p0 = (int)((long)hw * rank / ctas), p1 = (int)((long)hw * (rank + 1) / ctas);
  int l0 = p0, l1 = p1;
  RsRows rows = {};
  if constexpr (RESAMPLE) {
    rows = rs_rows(a.h, a.w, a.up, ctas, rank);
    l0 = rows.lo * a.w;
    l1 = rows.hi * a.w;
  }
  const int n = l1 - l0;
  const GaLayout L = ga_layout(c_tot, px, RESAMPLE);
  bf16* raw_a = reinterpret_cast<bf16*>(gsm);  // [n][ca], then [n][cb]
  bf16* raw_b = raw_a + (long)n * ca;
  float* cs = reinterpret_cast<float*>(gsm + L.cs);  // [2][c_tot] the CTA's sums, squares
  float* ls = reinterpret_cast<float*>(gsm + L.uni);  // [lanes][c_tot] sums, then squares
  float* sc = ls;  // [c_tot] the affine, over the lanes' sums once they are folded
  float* sh = ls + c_tot;
  float* gam = reinterpret_cast<float*>(gsm + L.gb);  // [c_tot] gamma, then beta
  float* bet = gam + c_tot;
  float* smax = reinterpret_cast<float*>(gsm + L.misc);  // the CTA's amax (read by peers)
  float* sam = smax + 1;                                 // the sample's amax
  float* red = smax + 8;                                 // [GA_THREADS / 32] block_max

  // 1. the held pixels by 16-byte asynchronous copies, every thread's in
  // flight at once, in commit groups of consecutive pixels: one a
  // GA_CHUNK_BYTES of the share, at most GA_CHUNKS
  const bf16* xa = (const bf16*)a.xa + (long)b * hw * ca;
  const bf16* xb = cb ? (const bf16*)a.xb + (long)b * hw * cb : nullptr;
  const long nb = (long)n * c_tot * 2 / GA_CHUNK_BYTES;
  const int nch = nb < 1 ? 1 : nb > GA_CHUNKS ? GA_CHUNKS : (int)nb;
  for (int k = 0; k < nch; ++k) {
    const int q0 = (int)((long)n * k / nch), q1 = (int)((long)n * (k + 1) / nch);
    const int va = (q1 - q0) * ca / 8, vt = (q1 - q0) * c_tot / 8;
    for (int i = t; i < vt; i += GA_THREADS) {
      if (i < va)
        cp_async16(raw_a + (long)q0 * ca + 8 * i, xa + (long)(l0 + q0) * ca + 8 * i);
      else
        cp_async16(raw_b + (long)q0 * cb + 8 * (i - va), xb + (long)(l0 + q0) * cb + 8 * (i - va));
    }
    cp_async_commit();
  }
  for (int c = t; c < c_tot; c += GA_THREADS) {  // the fold's gamma and beta, while x lands
    gam[c] = a.gamma[c];
    bet[c] = a.beta[c];
  }
  // gn_stats_kernel's loop on the shared copy, a chunk at a time as it lands:
  // each lane's pixels p0 + lane, p0 + lane + lanes, ... in order
  const int lane = t / cv, v = t % cv, c8 = 8 * v;
  const bf16* base = c8 < ca ? raw_a + c8 : raw_b + (c8 - ca);
  const long stride = c8 < ca ? ca : cb;
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  int p = p0 + lane;
  for (int k = 0; k < nch; ++k) {
    cp_async_wait_chunk(nch - 1 - k);  // chunks 0..k of this thread's copies
    __syncthreads();                   // ... and of every thread's
    const int end = l0 + (int)((long)n * (k + 1) / nch);
    for (; lane < lanes && p < p1 && p < end; p += lanes) {
      Pack8<bf16> pk;
      ld8(pk, base + (p - l0) * stride);
      float f[8];
      unpack8(pk, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] += f[j];
        q[j] += f[j] * f[j];
      }
    }
  }
  // the lanes' sums into cs[0, c_tot), then their squares into cs[c_tot, 2 c_tot),
  // each through the lanes' buffer in lane order
  for (int half = 0; half < 2; ++half) {
    if (lane < lanes) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ls[lane * c_tot + c8 + j] = half ? q[j] : s[j];
    }
    __syncthreads();
    for (int c = t; c < c_tot; c += GA_THREADS) {
      float sum = 0.f;
      for (int l = 0; l < lanes; ++l) sum += ls[l * c_tot + c];
      cs[half * c_tot + c] = sum;
    }
    __syncthreads();
  }
  cluster.sync();

  // 2. every CTA folds every group: a warp folds 32 / seg groups at once,
  // seg lanes a group (its channels rounded up to a power of two, at most
  // 32), each lane its channel's totals over the peers in rank order (their
  // values in flight at once), then gn_stats_kernel's butterfly without the
  // lanes that hold no channel, whose zeros add nothing. With at most 32
  // channels a group, a lane's sum is its channel's total, as in
  // gn_stats_kernel: on its share of the pixels (8 CTAs) the same bits.
  const int cg = c_tot / a.groups, warp = t >> 5, l32 = t & 31;
  int seg = 1;
  while (seg < cg && seg < 32) seg <<= 1;
  const int gpw = 32 / seg, sub = l32 / seg, sl = l32 % seg;
  const float inv_n = 1.0f / (float)((long)hw * cg);
  for (int g0 = warp * gpw; g0 < a.groups; g0 += GA_THREADS / 32 * gpw) {
    const int g = g0 + sub;
    float gs = 0.f, gq = 0.f;
    for (int j = sl; g < a.groups && j < cg; j += seg) {
      const int c = g * cg + j;
      float ts = 0.f, tq = 0.f;
      for (int r0 = 0; r0 < ctas; r0 += GA_PEERS) {
        float ps[GA_PEERS], pq[GA_PEERS];
#pragma unroll
        for (int r = 0; r < GA_PEERS; ++r) {
          const float* peer = cluster.map_shared_rank(cs, r0 + r);
          ps[r] = peer[c];
          pq[r] = peer[c_tot + c];
        }
#pragma unroll
        for (int r = 0; r < GA_PEERS; ++r) {
          ts += ps[r];
          tq += pq[r];
        }
      }
      gs += ts;
      gq += tq;
    }
    for (int o = seg / 2; o > 0; o >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
      gq += __shfl_xor_sync(0xffffffffu, gq, o);
    }
    if (g >= a.groups) continue;
    // E[x^2] - mean^2, each product rounded as the plain version's
    const float mean = __fmul_rn(gs, inv_n);
    const float rstd =
        rsqrtf(__fadd_rn(__fsub_rn(__fmul_rn(gq, inv_n), __fmul_rn(mean, mean)), a.eps));
    for (int j = sl; j < cg; j += seg) {
      const int c = g * cg + j;
      const float m = __fmul_rn(rstd, gam[c]);
      const float d = __fsub_rn(bet[c], __fmul_rn(mean, m));
      sc[c] = UNFOLD ? mean : m;  // UNFOLD: the group's mean and rstd a channel
      sh[c] = UNFOLD ? rstd : d;
      if (rank == 0 && a.scale != nullptr) {
        a.scale[(long)b * c_tot + c] = m;
        a.shift[(long)b * c_tot + c] = d;
      }
    }
    if (rank == 0 && a.mean != nullptr && sl == 0) {
      a.mean[(long)b * a.groups + g] = mean;
      a.rstd[(long)b * a.groups + g] = rstd;
    }
  }
  // done with the peers' sums (the loads have returned: their values are
  // folded), waited for below, before exiting; no memory to release
  cluster_arrive_relaxed();
  __syncthreads();

  float mx = 0.f;  // this thread's amax of what it makes, where a mode needs one
  if constexpr (!RESAMPLE) {
    // 3. convert the resident share, as the pre-pass converts it: thread
    // (lane, v) takes channel vector v of the pixels lane, lane + lanes, ...,
    // its 8 channels' affine in registers
    const bool on = lane < lanes;
    float m[8], d[8];
    if (on) {
      reinterpret_cast<float4*>(m)[0] = reinterpret_cast<const float4*>(sc + c8)[0];
      reinterpret_cast<float4*>(m)[1] = reinterpret_cast<const float4*>(sc + c8)[1];
      reinterpret_cast<float4*>(d)[0] = reinterpret_cast<const float4*>(sh + c8)[0];
      reinterpret_cast<float4*>(d)[1] = reinterpret_cast<const float4*>(sh + c8)[1];
    }
    Int8Args qa = a.q;
    int qb = b;
    if (std::is_same<TQ, int8_t>::value && qa.qs == nullptr) {
      // per sample: the amax of the activated sample first, a cluster max
      for (int pl = lane; on && pl < n; pl += lanes) {
        Pack8<bf16> pk;
        ld8(pk, base + pl * stride);
        float f[8];
        unpack8(pk, f);
        if constexpr (UNFOLD) {
          unfolded8(f, m, d, gam + c8, bet + c8, a.silu);
          mx = amax8(f, nullptr, nullptr, 0, mx);
        } else {
          mx = amax8(f, m, d, a.silu, mx);
        }
      }
      block_max(mx, red, smax);
      cluster_wait();
      cluster_arrive();  // every CTA's amax written
      cluster_wait();
      if (t == 0) {
        float am = 0.f;
        for (int r = 0; r < ctas; ++r) am = fmaxf(am, *cluster.map_shared_rank(smax, r));
        *sam = am;
        if (rank == 0 && a.amax_out != nullptr) a.amax_out[b] = am;
        if (rank == 0 && a.qs_out != nullptr) a.qs_out[b] = fmaxf(am, 1e-12f) / 127.0f;
      }
      __syncthreads();
      cluster_arrive();  // done with the peers' amaxes
      qa.amax = sam;
      qb = 0;
    }
    TQ* out = (TQ*)a.out + ((long)b * hw + l0) * c_tot + c8;
    int8_t* xq = QX ? (int8_t*)a.xr + ((long)b * hw + l0) * c_tot + c8 : nullptr;
    // convert8's static scale, taken once a thread rather than once a vector
    const float inv_static = qa.qs != nullptr ? 1.0f / *qa.qs : 0.0f;
    const float inv_sx = QX ? 1.0f / *a.qsx : 0.0f;
    for (int pl = lane; on && pl < n; pl += GA_UNROLL * lanes) {
      float f[GA_UNROLL][8];
#pragma unroll
      for (int u = 0; u < GA_UNROLL; ++u)
        if (pl + u * lanes < n) {
          Pack8<bf16> pk;
          ld8(pk, base + (pl + u * lanes) * stride);
          unpack8(pk, f[u]);
        }
#pragma unroll
      for (int u = 0; u < GA_UNROLL; ++u) {
        if (pl + u * lanes >= n) continue;
        TQ* dst = out + (long)(pl + u * lanes) * c_tot;
        if constexpr (QX) {  // the skip's q(x) of the value as stored
          uint2 qv;
          int8_t* e8 = reinterpret_cast<int8_t*>(&qv);
#pragma unroll
          for (int j = 0; j < 8; ++j) e8[j] = quant8(f[u][j] * inv_sx);
          *reinterpret_cast<uint2*>(xq + (long)(pl + u * lanes) * c_tot) = qv;
        }
        if constexpr (UNFOLD) {
          unfolded8(f[u], m, d, gam + c8, bet + c8, a.silu);
          *reinterpret_cast<uint2*>(dst) = quantize8(f[u], nullptr, nullptr, 0, 0.f, qa, qb);
        } else if constexpr (std::is_same<TQ, int8_t>::value)
          *reinterpret_cast<uint2*>(dst) = quantize8(f[u], m, d, a.silu, inv_static, qa, qb);
        else
          convert8(f[u], m, d, a.silu, qa, qb, dst);
      }
    }
  } else {
    // 3. the resample: GN1 + SiLU once per held value, rounded to bf16, then
    // transition_resample_kernel's sums from shared memory
    bf16* act = reinterpret_cast<bf16*>(gsm + L.act);  // [n][c], rows nlo..nhi filled
    const int c = ca, w = a.w, up = a.up;
    if (lane < lanes) {  // thread (lane, v): channel vector v of every lanes-th pixel
      float m[8], d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = sc[c8 + j];
        d[j] = sh[c8 + j];
      }
      for (int pl = (rows.nlo - rows.lo) * w + lane; pl < (rows.nhi - rows.lo) * w; pl += lanes) {
        Pack8<bf16> pk;
        ld8(pk, raw_a + (long)pl * c + c8);
        float f[8];
        unpack8(pk, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = round_bf16(silu(f[j] * m[j] + d[j]));
        st8(act + (long)pl * c + c8, f);
      }
    }
    __syncthreads();
    const int ho = up ? 2 * a.h : a.h / 2, wo = up ? 2 * w : w / 2;
    const long nout = (long)(rows.o1 - rows.o0) * wo * cv;
    const float inv_static = a.out_type == 2 ? 1.0f / *a.q.qs : 0.f;
    const float inv_sx = a.qsx != nullptr ? 1.0f / *a.qsx : 0.f;
    for (long i = t; i < nout; i += GA_THREADS) {
      const int c0 = (int)(i % cv) * 8;
      const long pix = i / cv;
      const int yo = rows.o0 + (int)(pix / wo), xo = (int)(pix % wo);
      int ys[4], xs[4];
      float ky[4], kx[4];
      const int nt = axis_taps(yo, up, a.k.h, ys, ky);
      axis_taps(xo, up, a.k.w, xs, kx);
      float acc_h[8], acc_x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_h[j] = acc_x[j] = 0.f;
      for (int tx = 0; tx < nt; ++tx) {  // W outer: each column combined along H first
        const int xi = xs[tx];
        if (xi < 0 || xi >= w) continue;
        float col_h[8], col_x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) col_h[j] = col_x[j] = 0.f;
        for (int ty = 0; ty < nt; ++ty) {
          const int yi = ys[ty];
          if (yi < 0 || yi >= a.h) continue;
          const long e = ((long)(yi - rows.lo) * w + xi) * c + c0;
          Pack8<bf16> px8, pa8;
          ld8(px8, raw_a + e);
          ld8(pa8, act + e);
          float f[8], av[8];
          unpack8(px8, f);
          unpack8(pa8, av);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            col_h[j] += ky[ty] * av[j];
            col_x[j] += ky[ty] * round_bf16(f[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_h[j] += kx[tx] * col_h[j];
          acc_x[j] += kx[tx] * col_x[j];
        }
      }
      const long o = (((long)b * ho + yo) * wo + xo) * c + c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (std::is_same<TQ, bf16>::value) acc_h[j] = round_bf16(acc_h[j]);
        mx = fmaxf(mx, fabsf(acc_h[j]));
      }
      if constexpr (std::is_same<TQ, int8_t>::value) {
        uint2 qv;
        int8_t* e8 = reinterpret_cast<int8_t*>(&qv);
#pragma unroll
        for (int j = 0; j < 8; ++j) e8[j] = quant8(acc_h[j] * inv_static);
        *reinterpret_cast<uint2*>((int8_t*)a.out + o) = qv;
      } else {
        st8((TQ*)a.out + o, acc_h);
      }
      if (a.qsx != nullptr) {  // the static skip's q(xr), from the unrounded sums
        uint2 qv;
        int8_t* e8 = reinterpret_cast<int8_t*>(&qv);
#pragma unroll
        for (int j = 0; j < 8; ++j) e8[j] = quant8(acc_x[j] * inv_sx);
        *reinterpret_cast<uint2*>((int8_t*)a.xr + o) = qv;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_x[j] = round_bf16(acc_x[j]);
        st8((bf16*)a.xr + o, acc_x);
      }
    }
    if (std::is_same<TQ, float>::value && a.amax_out != nullptr) {
      // the per-sample amax of h, a cluster max, for the int8 pre-pass
      block_max(mx, red, smax);
      cluster_wait();
      cluster_arrive();  // every CTA's amax written
      cluster_wait();
      if (rank == 0 && t == 0) {
        float am = 0.f;
        for (int r = 0; r < ctas; ++r) am = fmaxf(am, *cluster.map_shared_rank(smax, r));
        a.amax_out[b] = am;
      }
      __syncthreads();
      cluster_arrive();  // done with the peers' amaxes
    }
  }
  cluster_wait();  // the peers are done with this CTA's shared memory
}

// The pixels of the largest share a CTA holds on an h x w sample: the
// convert variant's ceil(hw / GA_CTAS), the resample variant's most held
// rows (rs_rows) times w. ops/resblock.py's route functions reckon the same
// (gn_apply_smem, _resample_rows); gddim_gn_apply_smem below exports it.
long ga_share(int h, int w, bool resample, int up) {
  if (!resample) return ((long)h * w + GA_CTAS - 1) / GA_CTAS;
  long px = 0;
  for (int r = 0; r < GA_CTAS; ++r) {
    const RsRows g = rs_rows(h, w, up, GA_CTAS, r);
    if ((long)(g.hi - g.lo) * w > px) px = (long)(g.hi - g.lo) * w;
  }
  return px;
}

template <typename TQ, bool RESAMPLE, bool UNFOLD = false, bool QX = false>
int ga_run(const GnApply& a, int px, size_t smem, cudaStream_t st) {
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(gn_apply_kernel<TQ, RESAMPLE, UNFOLD, QX>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, GA_SMEM);
    if (err) return err;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.ctas, (unsigned)a.batch);
  cfg.blockDim = dim3(GA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)a.ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int err = (int)cudaLaunchKernelEx(&cfg, gn_apply_kernel<TQ, RESAMPLE, UNFOLD, QX>, a, px);
  if (!err) err = (int)cudaGetLastError();
  return err;
}

// K12's scale on the route of several launches: qs[b] = max(amax[b], 1e-12)
// / 127, as the cluster's rank 0 writes it. One thread a sample.
__global__ void k12_scale_kernel(const float* __restrict__ amax, float* __restrict__ qs, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < batch) qs[b] = fmaxf(amax[b], 1e-12f) / 127.0f;
}

}  // namespace

int gn_apply_launch(const GnApply& a, cudaStream_t st) {
  const int c = a.ca + a.cb;
  const bool rs = a.resample != 0;
  const bool ok =
      a.ctas == GA_CTAS && a.batch > 0 && a.h > 0 && a.w > 0 && a.ca % 8 == 0 &&
      a.cb % 8 == 0 && c >= 8 && c <= GA_MAX_C && a.groups > 0 && c % a.groups == 0 &&
      ((uintptr_t)a.xa % 16 == 0) && ((uintptr_t)a.xb % 16 == 0) && (a.cb == 0) == (a.xb == nullptr) &&
      (rs ? (a.cb == 0 && a.h % 2 == 0 && a.w % 2 == 0 && a.out_type >= 0 && a.out_type <= 2 &&
             (a.out_type != 2 || a.q.qs != nullptr) && a.xr != nullptr)
          : ((a.qsx == nullptr || (a.int8 && a.q.qs != nullptr && a.xr != nullptr)) &&
             (!a.int8 || a.q.qs != nullptr || a.amax_out != nullptr || a.qs_out != nullptr))) &&
      // K12: int8 per sample, its scales out
      (!a.unfold || (!rs && a.int8 && a.q.qs == nullptr && !a.q.inv_mul && a.qs_out != nullptr));
  if (!ok) return (int)cudaErrorInvalidValue;
  const long px = ga_share(a.h, a.w, rs, a.up);
  const long smem = ga_layout(c, px, rs).total;
  if (smem > GA_SMEM) return (int)cudaErrorInvalidValue;
  int err;
  if (a.unfold)
    err = ga_run<int8_t, false, true>(a, (int)px, smem, st);
  else if (!rs && a.qsx != nullptr)
    err = ga_run<int8_t, false, false, true>(a, (int)px, smem, st);
  else if (!rs)
    err = a.int8 ? ga_run<int8_t, false>(a, (int)px, smem, st) : ga_run<bf16, false>(a, (int)px, smem, st);
  else if (a.out_type == 0)
    err = ga_run<bf16, true>(a, (int)px, smem, st);
  else if (a.out_type == 1)
    err = ga_run<float, true>(a, (int)px, smem, st);
  else
    err = ga_run<int8_t, true>(a, (int)px, smem, st);
  if (!err) count_launch(COUNT_GN_APPLY);
  return err;
}

extern "C" {

// Shared memory of one CTA of gn_apply_kernel on an h x w x c sample (the
// resample variant when resample, up or down by up), as gn_apply_launch
// asks for it and refuses it above the H100's 227 KB: what the card tests
// hold ops/resblock.py's route functions to.
long long gddim_gn_apply_smem(int c, int h, int w, int resample, int up) {
  if (c < 8 || c % 8 != 0 || c > GA_MAX_C || h <= 0 || w <= 0) return -1;
  return ga_layout(c, ga_share(h, w, resample != 0, up), resample != 0).total;
}

// GN1 in one launch, the convert variant alone: the logical concat (xa, xb)
// (B, hw, ca+cb) bf16 through GroupNorm's affine (+SiLU when silu), written
// to out (B, hw, ca+cb) as bf16, or with int8 as int8 by the static scale
// *qs, or per sample (qs null: amax (B,) receives each sample's amax;
// inv_mul: a * (127 / amax)). scale, shift (B, C), mean, rstd (B, groups)
// receive the statistics when non-null. ctas: 8 CTAs a sample, or 0:
// the launches it replaces (gn_stats_kernel, amax_kernel per sample, the
// pre-pass; scale and shift required), the yardstick.
int gddim_gn_apply(const void* xa, const void* xb, int ca, int cb, int batch, int hw, int groups,
                   const void* gamma, const void* beta, float eps, int silu_on, int int8,
                   const void* qs, void* amax, int inv_mul, int ctas, void* out, void* scale,
                   void* shift, void* mean, void* rstd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ctas == 0) {
    if (scale == nullptr || shift == nullptr) return (int)cudaErrorInvalidValue;
    float *sc = (float*)scale, *sh = (float*)shift;
    int err = gn_stats_launch(xa, xb, ca, cb, batch, hw, groups, (const float*)gamma,
                              (const float*)beta, eps, sc, sh, (float*)mean, (float*)rstd, false,
                              st);
    if (!err && int8 && qs == nullptr)
      err = amax_launch(xa, xb, ca, cb, batch, hw, sc, sh, silu_on, (float*)amax, false, st);
    const Int8Args q = {(const float*)qs, (const float*)amax, inv_mul};
    if (!err)
      err = prepass_launch(xa, xb, ca, cb, false, batch, hw, sc, sh, silu_on, int8 ? &q : nullptr,
                           out, st);
    return err;
  }
  GnApply a = {};
  a.xa = xa;
  a.xb = xb;
  a.ca = ca;
  a.cb = cb;
  a.batch = batch;
  a.h = hw;
  a.w = 1;
  a.groups = groups;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.eps = eps;
  a.silu = silu_on;
  a.int8 = int8;
  a.q = Int8Args{(const float*)qs, nullptr, inv_mul};
  a.out = out;
  a.amax_out = int8 && qs == nullptr ? (float*)amax : nullptr;
  a.scale = (float*)scale;
  a.shift = (float*)shift;
  a.mean = (float*)mean;
  a.rstd = (float*)rstd;
  a.ctas = ctas;
  return gn_apply_launch(a, st);
}

// K12: GroupNorm(+SiLU when silu_on) of x (B, hw, c), bf16 or f32
// (act_f32), quantized per sample as the TPU kernel does it: qs (B,) =
// max(max|a|, 1e-12) / 127 and q (B, hw, c) int8 = clip(rint(a / qs)).
// ctas 8 (ops/resblock.py:gn_apply_ctas; bf16 x): one gn_apply_kernel
// launch, a cluster a sample, the affine unfolded as the TPU kernel's. ctas
// 0 (f32 x, or an eighth of a sample too large for a CTA): gn_stats_kernel,
// amax_kernel, the int8 pre-pass and k12_scale_kernel, the affine folded (x
// * scale + shift of the same statistics); `work` (2 * B * c + B) f32 there
// (the affine and the amax), unused on the cluster route.
int gddim_gn_silu_quant(const void* x, int act_f32, int batch, int hw, int c, int groups,
                        const void* gamma, const void* beta, float eps, int silu_on, int ctas,
                        void* work, void* q, void* qs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ctas == 0) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    float* sc = (float*)work;
    float* sh = sc + (long)batch * c;
    float* amax = sh + (long)batch * c;
    const bool f32 = act_f32 != 0;
    int err = gn_stats_launch(x, nullptr, c, 0, batch, hw, groups, (const float*)gamma,
                              (const float*)beta, eps, sc, sh, nullptr, nullptr, f32, st);
    if (!err) err = amax_launch(x, nullptr, c, 0, batch, hw, sc, sh, silu_on, amax, f32, st);
    const Int8Args qa = {nullptr, amax, 0};
    if (!err) err = prepass_launch(x, nullptr, c, 0, f32, batch, hw, sc, sh, silu_on, &qa, q, st);
    if (!err) {
      k12_scale_kernel<<<(batch + 127) / 128, 128, 0, st>>>(amax, (float*)qs, batch);
      err = (int)cudaGetLastError();
    }
    return err;
  }
  if (act_f32) return (int)cudaErrorInvalidValue;
  GnApply a = {};
  a.xa = x;
  a.ca = c;
  a.batch = batch;
  a.h = hw;
  a.w = 1;
  a.groups = groups;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.eps = eps;
  a.silu = silu_on;
  a.int8 = 1;
  a.q = Int8Args{nullptr, nullptr, 0};
  a.out = q;
  a.qs_out = (float*)qs;
  a.unfold = 1;
  a.ctas = ctas;
  return gn_apply_launch(a, st);
}

}  // extern "C"
