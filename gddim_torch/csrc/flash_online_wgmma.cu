// K8's k-blocked online-softmax attention in bf16 for Hopper (sm_90a): o =
// softmax(q k^T / sqrt(C)) v over (B, S, C) bf16 for S > 1024 (a multiple
// of 16), C in {64, 128, 256}, with the (S, S) scores never written to
// device memory and nothing kept per key, so S has no upper limit but the
// index range. The f32 form stays on flash_online.cu's mma.sync kernel.
//
// Replaces gddim_tpu/ops/flash.py:_attn_kernel_blocked (its pallas_call in
// flash_attention, the TPU wrapper's branch for every S > 1024), with its
// recurrence and rounding points over 512-key statistics blocks (the TPU
// kernel's block_k):
//   s      = (q . k) * C^-0.5, f32 sums
//   per 512-key block:
//   m_new  = max(m, rowmax(s over the whole block)), alpha = exp(m - m_new)
//   p      = exp(s - m_new)
//   l      = l * alpha + rowsum(p)                 p unrounded
//   acc    = acc * alpha + bf16(p) . v              f32 sums
//   o      = acc / l, rounded once to bf16
// Each weight is exponentiated from the max of its whole block, so each
// block's keys pass twice: pass 1 takes q k^T for the block's max only,
// pass 2 takes q k^T again, the weights and p v (1.5x the products of one
// pass; no per-slice running max with a late rescale, which would move the
// rounding point of p). acc is rescaled once a block. Summation orders
// differ from the plain version (ops/attention.py:flash_attention_blocked_
// reference): l and acc take a block's sums a key slice at a time. The
// block's max is taken on the sums q . k and then scaled (scale > 0, so
// it is the max of the rounded s); p is evaluated as 2^(sums * (C^-0.5
// log2 e) - m_new log2 e), one fused multiply-add and the MUFU exp2 in
// f32 (the f32 digits of p differ from exp(s - m_new)'s, its rounding to
// bf16 stays where it was).
//
// What bounds it on the H100: 4 S^2 C operations a sample (6 S^2 C as run)
// against 4 S C bytes of q, k, v and o: at S = 4096, C = 128 some 16,000
// operations a byte, far above the bf16 ridge (~295), so the tensor cores'
// rate bounds it; beside them the exponentials (one MUFU op a score of
// pass 2, at C = 128 half the cycles of the slice's two products there).
// The design keeps the tensor cores fed and the exponentials beside them:
//
// flash_online_wgmma_kernel<C, NWG>: a CTA of NWG consumer warpgroups (64
// query rows each, so 128 or 64 queries a CTA: ops/attention.py:flash_plan
// takes 64 where 128-query CTAs would cover fewer than half the SMs) and
// one producer warpgroup, which gives its registers to the consumers
// (setmaxnreg: 24 a thread; the consumers 240 at NWG 2, one CTA an SM, or
// 232 at NWG 1, two CTAs an SM). One producer thread issues every TMA load:
// the CTA's q rows once (64-channel boxes, 128-byte swizzle; rows past S
// come as zeros), then for each block its K slices (pass 1: no V), then K
// and V slices in turn (pass 2), KN keys a slice (KN 128, or 64 at C = 256,
// where acc holds 128 registers a thread), through a ring of full/empty
// mbarriers (4 slices at NWG 2, 2 at NWG 1). Both warpgroups read each
// slice, so K and V cross from L2 once a CTA a pass. Keys past S come as
// TMA's zero fill and are masked (pass 1: -inf; pass 2: p = 0).
// - q k^T: wgmma m64nKNk16, q the K-major A and the K slice the K-major B
//   operand, from shared memory; the slice's 64 x KN f32 sums stay in
//   registers. Each sum starts with its first product (scale-d off).
// - p v: p rounded to bf16 and packed as the A fragments of wgmma with A
//   from registers (no round trip through shared memory), the V slice the
//   N-major B operand through the transpose bit.
// - NWG 2 (a 4-slice ring): pass 2 issues slice j's q k^T and slice j-1's
//   p v together and takes slice j's weights while that p v runs; named
//   barriers alternate the two warpgroups' issue of their products, so one
//   warpgroup's exponentials overlap the other's wgmma. NWG 1 (2 slices,
//   which that overlap would starve) runs each slice's products in turn.
// - Epilogue: acc / l (IEEE division) to bf16 over the warpgroup's q tile
//   in the 128-byte swizzle, then one TMA store of its 64 rows, which
//   writes no row past S.
//
// ptxas (nvcc -Xptxas -v -c csrc/flash_online_wgmma.cu, sm_90a): NWG 2
// 168 registers at entry (the launch bound; consumers 240 after
// setmaxnreg), NWG 1 128 (232), no spills, at C = 64, 128 and 256. A
// second score buffer, to overlap pass 1's max with the next slice's q
// k^T, makes NWG 2 spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv.cuh"
#include "mma.cuh"

namespace {

constexpr int OW_BLOCK = 512;         // keys a statistics block (the TPU kernel's block_k)
constexpr int OW_BOX = 64 * 128;      // a q / o box: 64 rows x 64 channels, 8 KB
constexpr int OW_PRODUCER_REGS = 24;  // the producer warpgroup's registers a thread
constexpr float OW_LOG2E = 1.4426950408889634f;

template <int C>
struct OwShape {
  static constexpr int KN = C == 256 ? 64 : 128;  // keys a K or V slice
  static constexpr int NC = C / 64;               // 64-channel boxes of a row
  static constexpr int KBOX = KN * 128;           // bytes of a slice's box
  static constexpr int SLICE = NC * KBOX;         // bytes of a slice
  static constexpr int PN = C < 128 ? C : 128;    // output columns a p v wgmma
  static constexpr int NPV = C / PN;              // p v wgmmas a k16 step
};

template <int NWG>
struct OwRoles {
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int STAGES = NWG == 2 ? 4 : 2;
  static constexpr int CTAS = NWG == 2 ? 1 : 2;  // CTAs an SM
  // the pool: THREADS * (65536 / (CTAS * THREADS), rounded down to 8)
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 232;
};

// shared memory of a CTA: the q tiles, the ring, 1 KB to align to the
// swizzle's atom, the barriers (ops/attention.py:flash_online_smem)
template <int C, int NWG>
constexpr int ow_smem() {
  return NWG * 64 * C * 2 + OwRoles<NWG>::STAGES * OwShape<C>::SLICE + 1024 +
         8 * (2 * OwRoles<NWG>::STAGES + 1);
}

static_assert(ow_smem<256, 2>() <= 227 * 1024, "the CTA exceeds shared memory");
static_assert(2 * (ow_smem<256, 1>() + 1024) <= 228 * 1024, "two CTAs do not fit an SM");
static_assert(2 * (ow_smem<128, 1>() + 1024) <= 228 * 1024, "two CTAs do not fit an SM");

// 2^x, the MUFU approximation (what __expf takes after scaling by log2(e))
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// scores of the slice: d (64 x KN) = q (64 x C) . K slice^T
template <int C>
__device__ __forceinline__ void ow_scores(float (&d)[OwShape<C>::KN / 2], uint32_t qw,
                                          uint32_t kb) {
  using Sh = OwShape<C>;
#pragma unroll
  for (int c = 0; c < Sh::NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // q and K alike: 128-byte rows, a k16 step 32 bytes in
      const uint64_t da = sw128_desc(qw + c * OW_BOX + 32 * kk, 16, 1024);
      const uint64_t db = sw128_desc(kb + c * Sh::KBOX + 32 * kk, 16, 1024);
      if constexpr (Sh::KN == 128)
        wgmma_ss_m64n128k16<0>(d, da, db, c | kk);
      else
        wgmma_m64n64k16<0>(d, da, db, c | kk);
    }
}

// acc (64 x C) += p (64 x KN, registers) . V slice (KN x C)
template <int C>
__device__ __forceinline__ void ow_pv(float (&acc)[OwShape<C>::NPV][OwShape<C>::PN / 2],
                                      const uint32_t (&pa)[OwShape<C>::KN / 16][4], uint32_t vb) {
  using Sh = OwShape<C>;
#pragma unroll
  for (int kk = 0; kk < Sh::KN / 16; ++kk)
#pragma unroll
    for (int n = 0; n < Sh::NPV; ++n) {
      // V: KN key rows of 128 bytes a box, the next 64 channels a box on (the
      // leading offset); a k16 step is 16 rows
      const uint64_t db = sw128_desc(vb + n * (Sh::PN / 64) * Sh::KBOX + 2048 * kk, Sh::KBOX, 1024);
      if constexpr (Sh::PN == 128)
        wgmma_rs_m64n128k16<1>(acc[n], pa[kk], db, 1);
      else
        wgmma_rs_m64n64k16<1>(acc[n], pa[kk], db, 1);
    }
}

// grid (ceil(S / (64 NWG)), B), OwRoles<NWG>::THREADS threads, ow_smem<C,
// NWG>() bytes of dynamic shared memory. Maps: (C, S, B) bf16 with the
// 128-byte swizzle; q and o boxes 64 channels x 64 rows, k and v 64 x KN.
// Accumulator layout (m64nN): register 4 j + 2 h + e of a thread holds row
// 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
template <int C, int NWG>
__global__ void __launch_bounds__(OwRoles<NWG>::THREADS, OwRoles<NWG>::CTAS)
flash_online_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap, int S, float scale) {
  using Sh = OwShape<C>;
  using R = OwRoles<NWG>;
  constexpr int ST = R::STAGES, KN = Sh::KN;
  // pass 2 overlaps a slice's weights with the last slice's p v where the
  // ring holds a slice more than those two (at 2 stages it would starve)
  constexpr bool PIPE = ST > 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = smem_u32(reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)));
  const uint32_t ring = qs + NWG * 64 * C * 2;
  const uint32_t qbar = ring + ST * Sh::SLICE;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * ST;

  const int b = blockIdx.y, q0 = blockIdx.x * 64 * NWG;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);  // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // the producer: q, then per block its K slices, then K and V in turn
    setmaxnreg_dec<OW_PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(qbar, NWG * 64 * C * 2);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < Sh::NC; ++c)
          tma_load_3d(qs + (w * Sh::NC + c) * OW_BOX, &qmap, qbar, 64 * c, q0 + 64 * w, b);
      int i = 0;
      auto push = [&](const CUtensorMap* map, int key0) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty0 + 8 * s, ((i / ST) - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = ring + s * Sh::SLICE;
        mbar_expect_tx(full, Sh::SLICE);
        for (int c = 0; c < Sh::NC; ++c) tma_load_3d(dst + c * Sh::KBOX, map, full, 64 * c, key0, b);
        ++i;
      };
      for (int k0 = 0; k0 < S; k0 += OW_BLOCK) {
        const int k1 = min(k0 + OW_BLOCK, S);
        for (int key = k0; key < k1; key += KN) push(&kmap, key);
        for (int key = k0; key < k1; key += KN) {
          push(&kmap, key);
          push(&vmap, key);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<R::CONSUMER_REGS>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const uint32_t qw = qs + wg * Sh::NC * OW_BOX;  // this warpgroup's q tile
  // NWG 2: the turn to issue products, which alternates between the
  // warpgroups: wait for it, then hand it to the other (named barriers 1 and
  // 2, both warpgroups' 256 threads)
  constexpr bool pp = NWG == 2;
  auto turn_begin = [&]() {
    if (pp) named_sync(1 + wg, 256);
  };
  auto turn_end = [&]() {
    if (pp) named_arrive(2 - wg, 256);
  };
  if (pp && wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first

  // item x of the ring, in the producer's order: wait until it is full
  auto slice = [&](int x) {
    mbar_wait(full0 + 8 * (x % ST), (x / ST) & 1);
    return ring + (x % ST) * Sh::SLICE;
  };
  // after this thread's wgmmas reading item x completed
  auto release = [&](int x) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (x % ST));
  };

  float acc[Sh::NPV][Sh::PN / 2];
#pragma unroll
  for (int n = 0; n < Sh::NPV; ++n)
#pragma unroll
    for (int j = 0; j < Sh::PN / 2; ++j) acc[n][j] = 0.f;
  // rows 16 warp + lane / 4 (h = 0) and + 8 (h = 1) of the warpgroup's 64
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum
  float sc[KN / 2];          // a slice's sums q . k, then (pass 2) its weights in f32
  uint32_t pa[KN / 16][4];   // the weights in bf16: p v's A fragments
  mbar_wait(qbar, 0);

  // a slice at key0 holds keys past S (the last one only); score register
  // x's key lies past S
  auto tail = [&](int key0) { return key0 + KN > S; };
  auto past = [&](int key0, int x) { return key0 + 8 * (x >> 2) + 2 * t4 + (x & 1) >= S; };

  // issue q k^T of the K slice in item x into sc
  auto issue_scores = [&](int x) {
    const uint32_t kb = slice(x);
    turn_begin();
    wgmma_fence();
    ow_scores<C>(sc, qw, kb);
    wgmma_commit();
    turn_end();
  };

  int x0 = 0;  // the block's first item: nsl K slices (pass 1), then K, V in turn
  for (int k0 = 0; k0 < S; k0 += OW_BLOCK) {
    const int nsl = (min(OW_BLOCK, S - k0) + KN - 1) / KN;

    // pass 1: the block's max of the sums (the max of s = sums * scale,
    // scale > 0)
    float mb[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < nsl; ++j) {
      issue_scores(x0 + j);
      wgmma_wait<0>();
      reg_fence(sc);
      release(x0 + j);
      const int key0 = k0 + j * KN;
      const bool t = tail(key0);
#pragma unroll
      for (int x = 0; x < KN / 2; ++x)
        mb[(x >> 1) & 1] = fmaxf(mb[(x >> 1) & 1], t && past(key0, x) ? -INFINITY : sc[x]);
    }
    float ml2[2];  // m_new * log2(e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
      mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 2));
      const float m_new = fmaxf(m[h], mb[h] * scale);
      const float alpha = __expf(m[h] - m_new);
      m[h] = m_new;
      ml2[h] = m_new * OW_LOG2E;
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < Sh::NPV; ++n)
#pragma unroll
        for (int j = 0; j < Sh::PN / 8; ++j) {
          acc[n][4 * j + 2 * h] *= alpha;
          acc[n][4 * j + 2 * h + 1] *= alpha;
        }
    }

    // pass 2: the weights p = exp(s - m_new) = 2^(sums * scale log2(e) -
    // m_new log2(e)) in f32 (keys past S: 0), l += p, then p v
    const float sl2 = scale * OW_LOG2E;
    auto weights = [&](int key0) {
      const bool t = tail(key0);
#pragma unroll
      for (int x = 0; x < KN / 2; ++x) {
        const int h = (x >> 1) & 1;
        sc[x] = t && past(key0, x) ? 0.f : ex2_approx(fmaf(sc[x], sl2, -ml2[h]));
        l[h] += sc[x];
      }
    };
    // keys 16 kk.. are score columns 2 kk (a0 row g, a1 row g + 8) and
    // 2 kk + 1 (a2, a3) of 8
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    const int xk = x0 + nsl;  // K_j: xk + 2 j, V_j: xk + 2 j + 1
    auto issue_pv = [&](int x) {
      const uint32_t vb = slice(x);
      turn_begin();
      wgmma_fence();
      ow_pv<C>(acc, pa, vb);
      wgmma_commit();
      turn_end();
    };
    auto pv_done = [&](int x) {
      reg_fence(acc);
      reg_fence(pa);
      release(x);
    };
    if constexpr (PIPE) {
      // slice j's q k^T and slice j - 1's p v issued together; slice j's
      // weights taken while that p v runs
      issue_scores(xk);
      wgmma_wait<0>();
      reg_fence(sc);
      release(xk);
      weights(k0);
      pack();
      for (int j = 1; j < nsl; ++j) {
        const uint32_t kb = slice(xk + 2 * j), vb = slice(xk + 2 * j - 1);
        turn_begin();
        wgmma_fence();
        ow_scores<C>(sc, qw, kb);
        wgmma_commit();
        ow_pv<C>(acc, pa, vb);
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();  // q k^T of slice j
        reg_fence(sc);
        release(xk + 2 * j);
        weights(k0 + j * KN);
        wgmma_wait<0>();  // p v of slice j - 1
        pv_done(xk + 2 * j - 1);
        pack();
      }
      issue_pv(xk + 2 * nsl - 1);
      wgmma_wait<0>();
      pv_done(xk + 2 * nsl - 1);
    } else {
      for (int j = 0; j < nsl; ++j) {
        issue_scores(xk + 2 * j);
        wgmma_wait<0>();
        reg_fence(sc);
        release(xk + 2 * j);
        weights(k0 + j * KN);
        pack();
        issue_pv(xk + 2 * j + 1);
        wgmma_wait<0>();
        pv_done(xk + 2 * j + 1);
      }
    }
    x0 += 3 * nsl;
  }
  if (pp && wg == 0) named_sync(1, 256);  // warpgroup 1's last hand-over

  // o = acc / l, l summed over the row's quad; bf16 over the q tile (its
  // last reader completed) in the 128-byte swizzle the o map stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int n = 0; n < Sh::NPV; ++n)
#pragma unroll
    for (int j = 0; j < Sh::PN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h, col = n * Sh::PN + 8 * j;
        const uint32_t addr = qw + (col >> 6) * OW_BOX + r * 128 +
                              ((((col & 63) >> 3) ^ (r & 7)) << 4) + 4 * t4;
        st_shared_b32(addr, pack_bf16(__fdiv_rn(acc[n][4 * j + 2 * h], l[h]),
                                        __fdiv_rn(acc[n][4 * j + 2 * h + 1], l[h])));
      }
  // the generic-proxy stores become visible to TMA; the warpgroup's barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(3 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    for (int c = 0; c < Sh::NC; ++c) tma_store_3d(&omap, qw + c * OW_BOX, 64 * c, q0 + 64 * wg, b);
    tma_store_wait();
  }
}

template <int C, int NWG>
int ow_run(const CUtensorMap* maps, int batch, int s, float scale, cudaStream_t st) {
  constexpr int smem = ow_smem<C, NWG>();
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(flash_online_wgmma_kernel<C, NWG>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr = true;
  }
  flash_online_wgmma_kernel<C, NWG>
      <<<dim3((s + 64 * NWG - 1) / (64 * NWG), batch), OwRoles<NWG>::THREADS, smem, st>>>(
          maps[0], maps[1], maps[2], maps[3], s, scale);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_FLASH_ONLINE);
  return err;
}

template <int C>
int ow_queries(const CUtensorMap* maps, int batch, int s, int qt, float scale, cudaStream_t st) {
  if (qt == 128) return ow_run<C, 2>(maps, batch, s, scale, st);
  if (qt == 64) return ow_run<C, 1>(maps, batch, s, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K8 for S > 1024 in bf16 (flash_online.cu's entry, gddim_flash_online,
// calls it): q, k, v, o (B, S, C) contiguous bf16; S a multiple of 16 (the
// entry checks it), C in {64, 128, 256}; qt the queries a CTA, 128 or 64
// (ops/attention.py:flash_plan).
int flash_online_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int s,
                       int c, int qt, float scale, cudaStream_t st) {
  if (c != 64 && c != 128 && c != 256) return (int)cudaErrorInvalidValue;
  const int kn = c == 256 ? 64 : 128;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)s, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)s * c * 2};
  const cuuint32_t qbox[3] = {64, 64, 1}, kbox[3] = {64, (cuuint32_t)kn, 1};
  CUtensorMap maps[4];
  if (!bf16_map(&maps[0], q, 3, dims, strides, qbox) ||
      !bf16_map(&maps[1], k, 3, dims, strides, kbox) ||
      !bf16_map(&maps[2], v, 3, dims, strides, kbox) ||
      !bf16_map(&maps[3], o, 3, dims, strides, qbox))
    return (int)cudaErrorInvalidValue;
  switch (c) {
    case 64: return ow_queries<64>(maps, batch, s, qt, scale, st);
    case 128: return ow_queries<128>(maps, batch, s, qt, scale, st);
    default: return ow_queries<256>(maps, batch, s, qt, scale, st);
  }
}
