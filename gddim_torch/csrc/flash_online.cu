// K8's k-blocked online-softmax attention in f32 for Hopper (sm_90a): o =
// softmax(q k^T / sqrt(C)) v over (B, S, C) f32 for S > 1024 (a multiple
// of 16), C in {64, 128, 256}, with the (S, S) scores never written to
// device memory and nothing kept per key, so S has no upper limit but the
// index range; and the entry gddim_flash_online, which sends bf16 to
// flash_online_wgmma.cu's kernel.
//
// Replaces gddim_tpu/ops/flash.py:_attn_kernel_blocked (its pallas_call in
// flash_attention, which the TPU wrapper takes for every S > 1024): the
// running max m, sum l and f32 accumulator acc of each query row carried
// across 512-key statistics blocks (the TPU kernel's block_k), with its
// rounding points:
//   s      = (q . k) * C^-0.5, f32 sums
//   per 512-key block:
//   m_new  = max(m, rowmax(s over the whole block)), alpha = exp(m - m_new)
//   p      = exp(s - m_new)                        f32, expf
//   l      = l * alpha + rowsum(p)
//   acc    = acc * alpha + p . v                   f32 sums
//   o      = acc / l
// Each weight is exponentiated from the max of its whole block: the block's
// keys pass twice, pass 1 q k^T for the max, pass 2 q k^T again, the
// weights and p v (1.5x the products of one pass). The last block may hold
// fewer than 512 keys. Summation orders differ from the plain version
// (ops/attention.py:flash_attention_blocked_reference): l and acc take the
// block's sums a key slice at a time.
//
// 3xTF32: every product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi with hi =
// tf32(x) (round to nearest) and lo = tf32(x - hi). TMA cannot split, and
// TF32 wgmma takes both operands K-major (no transpose bit), so
// online_split_kernel, a pre-pass, writes six planes into the caller's
// workspace: q and k as (hi, lo) (B, S, C), and v^T as (hi, lo) (B, C, S),
// whose keys run in the order (0, 2, 4, 6, 1, 3, 5, 7) within each 8: the
// weights of a k8 step then feed p v as the A fragment straight from the
// score accumulators (a thread holds keys 2t, 2t + 1 of its rows; the tf32
// A fragment wants columns t and t + 4), with no shuffle. Its plain version
// is ops/attention.py:online_split_reference, bit for bit.
//
// What bounds it on the H100: 4 S^2 C operations a sample (6 S^2 C as run,
// each three TF32 products) against 4 S C bytes of q, k, v and o (with the
// pre-pass's 9 S C more): at S = 4096, C = 128 some 8,000 operations a
// byte, far above the ridge, so the tensor cores' TF32 rate bounds it.
//
// flash_online_tf32_kernel<C>: a CTA of NWG consumer warpgroups (64 query
// rows each: 2 at C = 64 and 128, 1 at C = 256) and one producer
// warpgroup, which gives its registers to the consumers (setmaxnreg). One
// producer thread issues every TMA load (128-byte swizzle): the CTA's q
// planes once (rows past S come as zeros), then for each block pass 1's
// k planes (hi, lo) a slice of KN keys at a time, then pass 2's k hi, k lo,
// v^T hi, v^T lo of each slice, through a ring of full/empty mbarriers
// whose stages are one plane (KN x C f32: 16 KB at C = 64, 32 KB else).
// q's hi and lo planes (64 KB a warpgroup at C = 128 and 256) and the ring
// fill the CTA's shared memory.
// - q k^T: wgmma m64nKNk8 from shared memory (q the A, the k plane the B
//   operand, both K-major). The hi-hi products sum into one accumulator
//   set (C / 8 tensor-core steps, whose sums do not round to nearest), the
//   small terms q_lo k_hi + q_hi k_lo into another; s = (big + small) *
//   scale in f32.
// - p v: p split into hi and lo in registers and fed as wgmma's register A
//   operand, the v^T planes the B operand; each slice's p v a partial sum
//   of its own (started with scale-d off), added to acc in f32 (C = 256: a
//   64-column quarter at a time, for registers). Keys past S come as TMA's
//   zero fill and are masked (pass 1: -inf; pass 2: p = 0).
// - NWG 2: named barriers alternate the two warpgroups' issue of their
//   products, so one warpgroup's softmax overlaps the other's wgmma.
// - Epilogue: acc / l (IEEE division), f32 stores of the rows below S.
//
// ptxas (nvcc -Xptxas -v -c csrc/flash_online.cu, sm_90a): 168 registers
// at entry at C = 64 and 128 (the launch bound of 384 threads), 240 at
// C = 256 (256 threads); the consumers 240 after setmaxnreg; no spills at
// any C. Descriptors hoisted out of the slice loop spilled (see opaque).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv.cuh"
#include "mma.cuh"

// flash_online_wgmma.cu: the bf16 form
int flash_online_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int s,
                       int c, int qt, float scale, cudaStream_t st);

namespace {

constexpr int OT_BLOCK = 512;         // keys a statistics block (the TPU kernel's block_k)
constexpr int OT_BOX = 64 * 128;      // a q box: 64 rows x 32 f32, 8 KB
constexpr int OT_PRODUCER_REGS = 24;  // the producer warpgroup's registers a thread

template <int C>
struct OtShape {
  static constexpr int NWG = C == 256 ? 1 : 2;      // consumer warpgroups of 64 queries
  static constexpr int KN = C == 256 ? 32 : 64;     // keys a slice
  static constexpr int STAGES = C == 64 ? 8 : 3;    // planes of the ring
  static constexpr int THREADS = 128 * (NWG + 1);  // one CTA an SM (shared memory)
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int NB = C / 32;                 // 32-channel boxes of a row
  static constexpr int QPLANE = NB * OT_BOX;        // a q plane (hi or lo) of 64 rows
  static constexpr int KBOX = KN * 128;             // a k box: KN keys x 32 channels
  static constexpr int VBOX = C * 128;              // a v^T box: C channels x 32 keys
  static constexpr int PLANE = KN * C * 4;          // a ring stage: a k or v^T plane
  static constexpr int PN = C == 128 ? 128 : 64;    // output columns a p v product
  static constexpr int NPV = C / PN;                // p v partial sums a slice
};

// shared memory of a CTA: the q planes, the ring, 1 KB to align to the
// swizzle's atom, the barriers (ops/attention.py:flash_online_f32_smem)
template <int C>
constexpr int ot_smem() {
  using Sh = OtShape<C>;
  return Sh::NWG * 2 * Sh::QPLANE + Sh::STAGES * Sh::PLANE + 1024 + 8 * (2 * Sh::STAGES + 1);
}

static_assert(ot_smem<64>() <= 227 * 1024, "the CTA exceeds shared memory");
static_assert(ot_smem<128>() <= 227 * 1024, "the CTA exceeds shared memory");
static_assert(ot_smem<256>() <= 227 * 1024, "the CTA exceeds shared memory");

// x, opaque to the compiler: the shared-memory descriptors built from it are
// computed where a slice's products are issued, not hoisted out of the loop
// over slices (where they would hold registers through p v and spill)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// the pre-pass: grid (ceil(S / 32), C / 32, B), 256 threads. A CTA splits a
// 32-key x 32-channel tile of q and k where they lie, and writes the tile of
// v transposed through shared memory, its keys in the kernel's order.
__global__ void __launch_bounds__(256)
online_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ work, int B, int S, int C) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int key0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const long n = (long)B * S * C;
  float* qs = work;
  float* ks = work + 2 * n;
  float* vts = work + 4 * n;
  uint32_t hi, lo;
  for (int r = ty; r < 32; r += 8) {
    if (key0 + r >= S) break;
    const long at = ((long)b * S + key0 + r) * C + c0 + tx;
    split(q[at], hi, lo);
    qs[at] = __uint_as_float(hi);
    qs[n + at] = __uint_as_float(lo);
    split(k[at], hi, lo);
    ks[at] = __uint_as_float(hi);
    ks[n + at] = __uint_as_float(lo);
    tile[r][tx] = v[at];
  }
  __syncthreads();
  // position tx of each 8 holds key (0, 2, 4, 6, 1, 3, 5, 7)[tx % 8]; S is a
  // multiple of 8, so a group lies below S whole or not at all
  if (key0 + tx >= S) return;
  const int src = (tx & ~7) | ((tx & 7) < 4 ? 2 * (tx & 7) : 2 * (tx & 7) - 7);
  for (int r = ty; r < 32; r += 8) {
    const long at = ((long)b * C + c0 + r) * S + key0 + tx;
    split(tile[src][r], hi, lo);
    vts[at] = __uint_as_float(hi);
    vts[n + at] = __uint_as_float(lo);
  }
}

// grid (ceil(S / (64 NWG)), B), OtShape<C>::THREADS threads, ot_smem<C>()
// bytes of dynamic shared memory. Maps (128-byte swizzle, f32) over the
// pre-pass's planes, the plane p of sample b at batch index p B + b: q and k
// (C, S, 2B), boxes 32 channels x 64 (q) or KN (k) rows; v^T (S, C, 2B),
// boxes 32 keys x C rows. Accumulator layout (m64nN): register 4 j + 2 h + e
// of a thread holds row 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2
// (lane % 4) + e.
template <int C>
__global__ void __launch_bounds__(OtShape<C>::THREADS, 1)
flash_online_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int B,
                         int S, float scale) {
  using Sh = OtShape<C>;
  constexpr int NWG = Sh::NWG, ST = Sh::STAGES, KN = Sh::KN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = smem_u32(reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)));
  const uint32_t ring = qs + NWG * 2 * Sh::QPLANE;
  const uint32_t qbar = ring + ST * Sh::PLANE;
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
    // the producer: q, then per block pass 1's k planes, then pass 2's k and
    // v^T planes, a slice at a time
    setmaxnreg_dec<OT_PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(qbar, NWG * 2 * Sh::QPLANE);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < 2; ++p)
          for (int c = 0; c < Sh::NB; ++c)
            tma_load_3d(qs + (2 * w + p) * Sh::QPLANE + c * OT_BOX, &qmap, qbar, 32 * c,
                        q0 + 64 * w, p * B + b);
      int i = 0;
      auto stage = [&]() {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty0 + 8 * s, ((i / ST) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, Sh::PLANE);
        return s;
      };
      auto push_k = [&](int key0, int p) {
        const int s = stage();
        for (int c = 0; c < Sh::NB; ++c)
          tma_load_3d(ring + s * Sh::PLANE + c * Sh::KBOX, &kmap, full0 + 8 * s, 32 * c, key0,
                      p * B + b);
        ++i;
      };
      auto push_v = [&](int key0, int p) {
        const int s = stage();
        for (int h = 0; h < KN / 32; ++h)
          tma_load_3d(ring + s * Sh::PLANE + h * Sh::VBOX, &vmap, full0 + 8 * s, key0 + 32 * h,
                      0, p * B + b);
        ++i;
      };
      for (int k0 = 0; k0 < S; k0 += OT_BLOCK) {
        const int k1 = min(k0 + OT_BLOCK, S);
        for (int key = k0; key < k1; key += KN) {
          push_k(key, 0);
          push_k(key, 1);
        }
        for (int key = k0; key < k1; key += KN) {
          push_k(key, 0);
          push_k(key, 1);
          push_v(key, 0);
          push_v(key, 1);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<Sh::CONSUMER_REGS>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const uint32_t qh = qs + 2 * wg * Sh::QPLANE, ql = qh + Sh::QPLANE;  // this warpgroup's q
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
  auto plane = [&](int x) {
    mbar_wait(full0 + 8 * (x % ST), (x / ST) & 1);
    return ring + (x % ST) * Sh::PLANE;
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
  float big[KN / 2];        // a slice's q_hi k_hi sums, then s, then p
  float small[KN / 2];      // its q_lo k_hi + q_hi k_lo sums
  uint32_t ph[KN / 8][4], pl[KN / 8][4];  // p's hi and lo: p v's A fragments
  mbar_wait(qbar, 0);

  // q k^T of the slice whose k planes are items x (hi) and x + 1 (lo), then
  // s = (big + small) * scale, -inf for keys past S
  auto scores = [&](int x, int key0) {
    const uint32_t kh = plane(x), qhs = opaque(qh), qls = opaque(ql);
    turn_begin();
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < Sh::NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // a k8 step is 32 bytes of a 128-byte row
        const uint64_t db = sw128_desc(kh + c * Sh::KBOX + 32 * kk, 16, 1024);
        const uint64_t dl = sw128_desc(qls + c * OT_BOX + 32 * kk, 16, 1024);
        const uint64_t dh = sw128_desc(qhs + c * OT_BOX + 32 * kk, 16, 1024);
        if constexpr (KN == 64) {
          wgmma_tf32_ss_m64n64k8(small, dl, db, c | kk);
          wgmma_tf32_ss_m64n64k8(big, dh, db, c | kk);
        } else {
          wgmma_tf32_ss_m64n32k8(small, dl, db, c | kk);
          wgmma_tf32_ss_m64n32k8(big, dh, db, c | kk);
        }
      }
    wgmma_commit();
    const uint32_t kl = plane(x + 1);
#pragma unroll
    for (int c = 0; c < Sh::NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(kl + c * Sh::KBOX + 32 * kk, 16, 1024);
        const uint64_t dh = sw128_desc(qhs + c * OT_BOX + 32 * kk, 16, 1024);
        if constexpr (KN == 64)
          wgmma_tf32_ss_m64n64k8(small, dh, db, 1);
        else
          wgmma_tf32_ss_m64n32k8(small, dh, db, 1);
      }
    wgmma_commit();
    turn_end();
    wgmma_wait<1>();
    release(x);
    wgmma_wait<0>();
    reg_fence(big);
    reg_fence(small);
    release(x + 1);
    const bool tail = key0 + KN > S;
#pragma unroll
    for (int r = 0; r < KN / 2; ++r) {
      const bool past = tail && key0 + 8 * (r >> 2) + 2 * t4 + (r & 1) >= S;
      big[r] = past ? -INFINITY : (big[r] + small[r]) * scale;
    }
  };

  // acc += p v over the slice whose v^T planes are items x (hi) and x + 1
  // (lo): each PN output columns a partial sum of its own, added in f32
  auto pv = [&](int x) {
#pragma unroll
    for (int n = 0; n < Sh::NPV; ++n) {
      float part[Sh::PN / 2];
      const uint32_t vh = opaque(plane(x) + n * Sh::PN * 128);
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 8; ++kk) {
        // v^T: 32-key boxes of C rows of 128 bytes; the PN rows from n PN on
        const uint64_t db = sw128_desc(vh + (kk >> 2) * Sh::VBOX + 32 * (kk & 3), 16, 1024);
        if constexpr (Sh::PN == 128) {
          wgmma_tf32_rs_m64n128k8(part, pl[kk], db, kk);
          wgmma_tf32_rs_m64n128k8(part, ph[kk], db, 1);
        } else {
          wgmma_tf32_rs_m64n64k8(part, pl[kk], db, kk);
          wgmma_tf32_rs_m64n64k8(part, ph[kk], db, 1);
        }
      }
      wgmma_commit();
      const uint32_t vl = opaque(plane(x + 1) + n * Sh::PN * 128);
#pragma unroll
      for (int kk = 0; kk < KN / 8; ++kk) {
        const uint64_t db = sw128_desc(vl + (kk >> 2) * Sh::VBOX + 32 * (kk & 3), 16, 1024);
        if constexpr (Sh::PN == 128)
          wgmma_tf32_rs_m64n128k8(part, ph[kk], db, 1);
        else
          wgmma_tf32_rs_m64n64k8(part, ph[kk], db, 1);
      }
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      reg_fence(part);
#pragma unroll
      for (int j = 0; j < Sh::PN / 2; ++j) acc[n][j] += part[j];
    }
    reg_fence(ph);
    reg_fence(pl);
    release(x);
    release(x + 1);
  };

  int x0 = 0;  // the block's first item: 2 nsl k planes (pass 1), then 4 a slice
  for (int k0 = 0; k0 < S; k0 += OT_BLOCK) {
    const int nsl = (min(OT_BLOCK, S - k0) + KN - 1) / KN;

    // pass 1: the block's max of s
    float mb[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < nsl; ++j) {
      scores(x0 + 2 * j, k0 + j * KN);
#pragma unroll
      for (int r = 0; r < KN / 2; ++r) mb[(r >> 1) & 1] = fmaxf(mb[(r >> 1) & 1], big[r]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
      mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 2));
      const float m_new = fmaxf(m[h], mb[h]);
      const float alpha = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < Sh::NPV; ++n)
#pragma unroll
        for (int j = 0; j < Sh::PN / 8; ++j) {
          acc[n][4 * j + 2 * h] *= alpha;
          acc[n][4 * j + 2 * h + 1] *= alpha;
        }
    }

    // pass 2: p = exp(s - m_new) (keys past S: exp(-inf) = 0), l += p; the
    // k8 step kk takes score registers 4 kk .. 4 kk + 3 (keys 2 t4, 2 t4 + 1
    // of rows g, g + 8) as A columns t4 (keys 2 t4) and t4 + 4 (2 t4 + 1)
    const int xk = x0 + 2 * nsl;  // slice j: k hi, k lo, v^T hi, v^T lo from xk + 4 j
    for (int j = 0; j < nsl; ++j) {
      scores(xk + 4 * j, k0 + j * KN);
#pragma unroll
      for (int r = 0; r < KN / 2; ++r) {
        const int h = (r >> 1) & 1;
        big[r] = expf(big[r] - m[h]);
        l[h] += big[r];
      }
#pragma unroll
      for (int kk = 0; kk < KN / 8; ++kk) {
        split(big[4 * kk], ph[kk][0], pl[kk][0]);
        split(big[4 * kk + 2], ph[kk][1], pl[kk][1]);
        split(big[4 * kk + 1], ph[kk][2], pl[kk][2]);
        split(big[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      pv(xk + 4 * j + 2);
    }
    x0 += 6 * nsl;
  }
  if (pp && wg == 0) named_sync(1, 256);  // warpgroup 1's last hand-over

  // o = acc / l, l summed over the row's quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= S) continue;
    float* orow = o + ((long)b * S + row) * C + 2 * t4;
#pragma unroll
    for (int n = 0; n < Sh::NPV; ++n)
#pragma unroll
      for (int j = 0; j < Sh::PN / 8; ++j)
        *reinterpret_cast<float2*>(orow + n * Sh::PN + 8 * j) =
            make_float2(__fdiv_rn(acc[n][4 * j + 2 * h], l[h]),
                        __fdiv_rn(acc[n][4 * j + 2 * h + 1], l[h]));
  }
}

int split_launch(const float* q, const float* k, const float* v, float* work, int batch, int s,
                 int c, cudaStream_t st) {
  online_split_kernel<<<dim3((s + 31) / 32, c / 32, batch), 256, 0, st>>>(q, k, v, work, batch,
                                                                          s, c);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_ONLINE_SPLIT);
  return err;
}

template <int C>
int ot_run(const float* work, float* o, int batch, int s, float scale, cudaStream_t st) {
  using Sh = OtShape<C>;
  constexpr int smem = ot_smem<C>();
  const long n = (long)batch * s * C;
  const cuuint64_t qdims[3] = {(cuuint64_t)C, (cuuint64_t)s, (cuuint64_t)(2 * batch)};
  const cuuint64_t qstrides[2] = {(cuuint64_t)C * 4, (cuuint64_t)s * C * 4};
  const cuuint64_t vdims[3] = {(cuuint64_t)s, (cuuint64_t)C, (cuuint64_t)(2 * batch)};
  const cuuint64_t vstrides[2] = {(cuuint64_t)s * 4, (cuuint64_t)s * C * 4};
  const cuuint32_t qbox[3] = {32, 64, 1}, kbox[3] = {32, Sh::KN, 1}, vbox[3] = {32, C, 1};
  CUtensorMap maps[3];
  if (!f32_map(&maps[0], work, 3, qdims, qstrides, qbox) ||
      !f32_map(&maps[1], work + 2 * n, 3, qdims, qstrides, kbox) ||
      !f32_map(&maps[2], work + 4 * n, 3, vdims, vstrides, vbox))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(flash_online_tf32_kernel<C>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr = true;
  }
  flash_online_tf32_kernel<C>
      <<<dim3((s + 64 * Sh::NWG - 1) / (64 * Sh::NWG), batch), Sh::THREADS, smem, st>>>(
          maps[0], maps[1], maps[2], o, batch, s, scale);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_FLASH_ONLINE);
  return err;
}

bool online_shape(int batch, int s, int c) {
  return batch >= 1 && s >= 16 && s % 16 == 0 && (c == 64 || c == 128 || c == 256);
}

}  // namespace

extern "C" {

// K8 for S > 1024: q, k, v, o (B, S, C) contiguous, f32 (bf16 = 0) or bf16
// (bf16 = 1); S a multiple of 16, C in {64, 128, 256}; qt the queries a CTA
// (ops/attention.py:flash_plan): bf16 128 or 64, f32 128 (C 64, 128) or 64
// (C 256); scale = C^-0.5; work (f32 only; bf16 ignores it) 6 B S C f32 of
// scratch for the pre-pass's planes (ops/attention.py:online_workspace).
// Counted where each kernel launches (COUNT_ONLINE_SPLIT, COUNT_FLASH_ONLINE).
int gddim_flash_online(const void* q, const void* k, const void* v, void* o, int batch, int s,
                       int c, int qt, int bf16, float scale, void* work, void* stream) {
  if (!online_shape(batch, s, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return flash_online_wgmma(q, k, v, o, batch, s, c, qt, scale, st);
  if (work == nullptr || qt != (c == 256 ? 64 : 128)) return (int)cudaErrorInvalidValue;
  float* w = (float*)work;
  const int err = split_launch((const float*)q, (const float*)k, (const float*)v, w, batch, s, c,
                               st);
  if (err) return err;
  switch (c) {
    case 64: return ot_run<64>(w, (float*)o, batch, s, scale, st);
    case 128: return ot_run<128>(w, (float*)o, batch, s, scale, st);
    default: return ot_run<256>(w, (float*)o, batch, s, scale, st);
  }
}

// the f32 form's pre-pass alone: q, k, v (B, S, C) f32 -> work's planes
// q (hi, lo), k (hi, lo) (2, B, S, C) and v^T (hi, lo) (2, B, C, S), keys in
// the kernel's order (ops/attention.py:online_split_reference)
int gddim_flash_online_split(const void* q, const void* k, const void* v, void* work, int batch,
                             int s, int c, void* stream) {
  if (!online_shape(batch, s, c) || work == nullptr) return (int)cudaErrorInvalidValue;
  return split_launch((const float*)q, (const float*)k, (const float*)v, (float*)work, batch, s,
                      c, (cudaStream_t)stream);
}

}  // extern "C"
