// K8's k-blocked online-softmax attention in f32 for Hopper (sm_90a): o =
// softmax(q k^T / sqrt(C)) v over (B, S, C) f32 for S > 1024, with the
// (S, S) scores never written to device memory and nothing kept per key, so
// S has no upper limit but the index range; and the entry gddim_flash_online,
// which sends bf16 to flash_online_wgmma.cu's kernel (wgmma fed by TMA).
//
// Replaces gddim_tpu/ops/flash.py:_attn_kernel_blocked (its pallas_call in
// flash_attention, which the TPU wrapper takes for every S > 1024): the
// running max m, sum l and f32 accumulator acc of each query row carried
// across 512-key statistics blocks (the TPU kernel's block_k), with its
// rounding points:
//   s      = (q . k) * C^-0.5, f32 sums
//   per 512-key block:
//   m_new  = max(m, rowmax(s over the whole block)), alpha = exp(m - m_new)
//   p      = exp(s - m_new)
//   l      = l * alpha + rowsum(p)
//   acc    = acc * alpha + p . v
//   o      = acc / l
// Each weight is exponentiated from the max of its whole 512-key block, as
// on the TPU: the block's k tiles pass twice, once for the max and once for
// the weights (q k^T recomputed: 1.5x the products of one pass, no score
// buffer). The last block may hold fewer than 512 keys (S a multiple of 16;
// the TPU wrapper asserts a multiple of 512). Summation orders differ from
// the plain version (ops/attention.py:flash_attention_blocked_reference):
// l and acc take the block's sums a 64-key tile at a time.
//
// flash_online_kernel<C>: grid (ceil(S / 64), B), 4 warps, one CTA a
// (sample, 64-query tile), 16 query rows a warp, so that a row's statistics
// stay in one warp's quad (shuffles, no shared memory). q sits in shared
// memory; k and v stream in 64-key tiles through two cp.async buffers (rows
// padded by 16 bytes): a block's k tiles (the max), then k0, v0, k1, v1, ...
// (the weights, then p v). Keys past S load as zeros and score -inf.
// 3xTF32 on mma.sync m16n8k8 (flash.cu's note: each 32 channels of q k^T a
// partial sum of its own, added in f32; likewise each 64-key tile of p v
// for each 8 output columns, since the tensor cores' sums do not round to
// nearest). p's accumulators feed p v without a shuffle: the k8 step over
// an n8 score tile takes its keys in the order (0, 2, 4, 6, 1, 3, 5, 7),
// and reads v's rows in that order. A simple kernel that is right; its
// redesign on wgmma tf32 is queued (ROADMAP.md).
//
// What bounds it on the H100: 4 S^2 C operations a sample (6 S^2 C as run,
// each three TF32 products) against 4 S C bytes of q, k, v and o an
// element size: at S = 4096, C = 128 some 8,000 operations a byte, far
// above the ridge, so the tensor cores' TF32 rate bounds it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv.cuh"
#include "mma.cuh"

// flash_online_wgmma.cu: the bf16 form
int flash_online_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int s,
                       int c, int qt, float scale, cudaStream_t st);

namespace {

constexpr int ON_THREADS = 128;  // 4 warps of 16 query rows
constexpr int ON_QT = 64;        // queries a CTA
constexpr int ON_KT = 64;        // keys a k or v tile
constexpr int ON_BLOCK = 512;    // keys a statistics block (the TPU kernel's block_k)
constexpr int ON_NT = ON_KT / 8;  // n8 score tiles of a k tile
constexpr int ON_PAD = 4;         // row padding, elements (16 bytes)

__host__ __device__ constexpr int on_smem(int c) {
  return 3 * ON_QT * (c + ON_PAD) * 4;  // q and two k / v tiles
}

// Tile i of the stream: a block b of 24 tiles (the last block 3 nt), its
// k tiles 0..nt-1 for the max, then k0, v0, k1, v1, ...
struct Tile {
  int key0;
  bool v;     // a v tile
  bool pass;  // a k tile of the max pass
  bool last;  // the block's last tile of its pass
};

__device__ __forceinline__ Tile tile_of(int i, int S) {
  const int nb = (S + ON_BLOCK - 1) / ON_BLOCK;
  int b = i / (3 * (ON_BLOCK / ON_KT));
  if (b > nb - 1) b = nb - 1;
  const int k0 = b * ON_BLOCK;
  const int keys = min(ON_BLOCK, S - k0);
  const int nt = (keys + ON_KT - 1) / ON_KT;
  const int r = i - b * 3 * (ON_BLOCK / ON_KT);
  Tile t;
  if (r < nt) {
    t.key0 = k0 + r * ON_KT;
    t.v = false;
    t.pass = true;
    t.last = r == nt - 1;
  } else {
    const int j = r - nt;
    t.key0 = k0 + (j >> 1) * ON_KT;
    t.v = j & 1;
    t.pass = false;
    t.last = j == 2 * nt - 1;
  }
  return t;
}

__device__ __forceinline__ int tiles_of(int S) {
  const int nb = (S + ON_BLOCK - 1) / ON_BLOCK;
  const int last = S - (nb - 1) * ON_BLOCK;
  return 3 * (ON_BLOCK / ON_KT) * (nb - 1) + 3 * ((last + ON_KT - 1) / ON_KT);
}

// grid (ceil(S / ON_QT), B), ON_THREADS threads, on_smem(C) bytes.
template <int C>
__global__ void __launch_bounds__(ON_THREADS)
flash_online_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int S, float scale) {
  using T = float;
  constexpr int LDT = C + ON_PAD;
  constexpr int CHUNKS = C * (int)sizeof(T) / 16;  // 16-byte chunks of a row
  constexpr int F32_CHUNK = 32;  // channels of one q k^T partial sum
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KVs = Qs + ON_QT * LDT;  // two tiles of ON_KT rows

  const int b = blockIdx.y, q0 = blockIdx.x * ON_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long base = (long)b * S * C;
  const int ntiles = tiles_of(S);

  auto load_tile = [&](int i) {
    const Tile t = tile_of(i, S);
    const T* src = (t.v ? v : k) + base;
    T* dst = KVs + (i & 1) * ON_KT * LDT;
    for (int x = tid; x < ON_KT * CHUNKS; x += ON_THREADS) {
      const int r = x / CHUNKS, ch = x % CHUNKS;
      const bool ok = t.key0 + r < S;
      cp_async16(reinterpret_cast<unsigned char*>(dst + r * LDT) + 16 * ch,
                 reinterpret_cast<const unsigned char*>(src + (long)(ok ? t.key0 + r : 0) * C) +
                     16 * ch,
                 ok);
    }
  };

  for (int x = tid; x < ON_QT * CHUNKS; x += ON_THREADS) {
    const int r = x / CHUNKS, ch = x % CHUNKS;
    const bool ok = q0 + r < S;
    cp_async16(reinterpret_cast<unsigned char*>(Qs + r * LDT) + 16 * ch,
               reinterpret_cast<const unsigned char*>(q + base + (long)(ok ? q0 + r : 0) * C) +
                   16 * ch,
               ok);
  }
  load_tile(0);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // rows g (h = 0) and g + 8 (h = 1) of this warp's 16
  float m[2] = {-INFINITY, -INFINITY};   // running max, to the last block
  float mb[2] = {-INFINITY, -INFINITY};  // this block's max so far (this thread's keys)
  float l[2] = {0.f, 0.f};               // this thread's share of the running sum
  float acc[C / 8][4];                   // n8 output tiles: [0..1] row g, [2..3] row g + 8
#pragma unroll
  for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // p of the last k tile of the weights pass, split for 3xTF32
  uint32_t ph[ON_NT][4], pl[ON_NT][4];

  const T* Qw = Qs + warp * 16 * LDT;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const T* tile = KVs + (i & 1) * ON_KT * LDT;
    const Tile t = tile_of(i, S);

    if (!t.v) {
      // s = (q . k) * scale for this warp's 16 rows and the tile's 64 keys:
      // sc[j] holds keys 8 j + 2 t4 (+1) of rows g ([0], [1]) and g + 8 ([2], [3])
      float sc[ON_NT][4];
#pragma unroll
      for (int j = 0; j < ON_NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      for (int kc0 = 0; kc0 < C; kc0 += F32_CHUNK) {
        float part[ON_NT][4];
#pragma unroll
        for (int j = 0; j < ON_NT; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
        for (int kc = kc0; kc < kc0 + F32_CHUNK; kc += 8) {
          uint32_t ah[4], al[4];
          split(Qw[g * LDT + kc + t4], ah[0], al[0]);
          split(Qw[(g + 8) * LDT + kc + t4], ah[1], al[1]);
          split(Qw[g * LDT + kc + t4 + 4], ah[2], al[2]);
          split(Qw[(g + 8) * LDT + kc + t4 + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < ON_NT; ++j) {
            const T* kr = tile + (8 * j + g) * LDT + kc + t4;
            uint32_t bh[2], bl[2];
            split(kr[0], bh[0], bl[0]);
            split(kr[4], bh[1], bl[1]);
            mma_3xtf32(part[j], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < ON_NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += part[j][e];
      }
#pragma unroll
      for (int j = 0; j < ON_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = t.key0 + 8 * j + 2 * t4 + (e & 1) < S ? sc[j][e] * scale : -INFINITY;

      if (t.pass) {
        // the max pass: this block's max, and at its end the new running max
#pragma unroll
        for (int j = 0; j < ON_NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], sc[j][e]);
        if (t.last) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
            mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 2));
            const float m_new = fmaxf(m[h], mb[h]);
            const float alpha = expf(m[h] - m_new);
            m[h] = m_new;
            mb[h] = -INFINITY;
            l[h] *= alpha;
#pragma unroll
            for (int j = 0; j < C / 8; ++j) {
              acc[j][2 * h] *= alpha;
              acc[j][2 * h + 1] *= alpha;
            }
          }
        }
      } else {
        // the weights pass: p = exp(s - m), l += p; the k8 step of n8 tile
        // j: column t4 is key 8 j + 2 t4, column t4 + 4 key 8 j + 2 t4 + 1
#pragma unroll
        for (int j = 0; j < ON_NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][e] = expf(sc[j][e] - m[e >> 1]);
            l[e >> 1] += sc[j][e];
          }
          split(sc[j][0], ph[j][0], pl[j][0]);
          split(sc[j][2], ph[j][1], pl[j][1]);
          split(sc[j][1], ph[j][2], pl[j][2]);
          split(sc[j][3], ph[j][3], pl[j][3]);
        }
      }
    } else {
      // acc += p v over the tile's keys: each 8 output columns, the tile's
      // 64 keys a partial sum, added in f32
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < ON_NT; ++j) {
          const T* vr = tile + (8 * j + 2 * t4) * LDT + 8 * n + g;
          uint32_t bh[2], bl[2];
          split(vr[0], bh[0], bl[0]);
          split(vr[LDT], bh[1], bl[1]);
          mma_3xtf32(part, ph[j], pl[j], bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
      }
    }
    __syncthreads();  // this buffer is refilled next iteration
  }

  // o = acc / l: l summed over the row's quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= S) continue;
    T* o0 = o + base + (long)row * C + 2 * t4;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const float x0 = __fdiv_rn(acc[j][2 * h], l[h]), x1 = __fdiv_rn(acc[j][2 * h + 1], l[h]);
      *reinterpret_cast<float2*>(o0 + 8 * j) = make_float2(x0, x1);
    }
  }
}

template <int C>
int run_online(const void* q, const void* k, const void* v, void* o, int batch, int s,
               float scale, cudaStream_t st) {
  constexpr int smem = on_smem(C);
  static bool attr = false;
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(
        flash_online_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    attr = true;
  }
  flash_online_kernel<C><<<dim3((s + ON_QT - 1) / ON_QT, batch), ON_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, s, scale);
  const int err = (int)cudaGetLastError();
  if (!err) count_launch(COUNT_FLASH_ONLINE);
  return err;
}

}  // namespace

extern "C" {

// K8 for S > 1024: q, k, v, o (B, S, C) contiguous, f32 (bf16 = 0) or bf16
// (bf16 = 1); S a multiple of 16, C in {64, 128, 256}; qt the queries a CTA
// (ops/attention.py:flash_plan): bf16 128 or 64, f32 64; scale = C^-0.5.
// Counted where it launches (COUNT_FLASH_ONLINE).
int gddim_flash_online(const void* q, const void* k, const void* v, void* o, int batch, int s,
                       int c, int qt, int bf16, float scale, void* stream) {
  if (s < 16 || s % 16 != 0 || batch < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return flash_online_wgmma(q, k, v, o, batch, s, c, qt, scale, st);
  if (qt != ON_QT) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 64: return run_online<64>(q, k, v, o, batch, s, scale, st);
    case 128: return run_online<128>(q, k, v, o, batch, s, scale, st);
    case 256: return run_online<256>(q, k, v, o, batch, s, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
