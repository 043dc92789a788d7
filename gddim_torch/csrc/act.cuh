// Device helpers of the activation passes (resblock.cu's pre-passes, the
// GN1 kernel in gn_apply.cu, K9's resample in transition.cu): 8-channel
// vectors of bf16 or f32 activations, the GroupNorm affine + SiLU, the bf16
// rounding and the int8 quantizer of the TPU kernels, and the phase taps of
// the factor-2 resample. One definition, so that every pass that makes the
// same value makes it with the same instructions (the same bits).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

// SiLU, v * sigmoid(v) = v / (1 + e^-v).
// silu: the division __fdividef's (within 2 ulp of f32), in the passes that
// round the value to a bf16 or int8 conv operand at once (the block
// pre-passes, in every activation mode, GN1's one-launch kernel, K9's
// resample): IEEE division's test for its slow path put each of a vector's
// 8 divisions in a branch of its own, so that they ran one after another.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// Eight consecutive activations of type T, loaded as 16-byte vectors and
// converted to f32 only when used (so the loads stay in flight meanwhile).
template <typename T> struct Pack8;
template <> struct Pack8<bf16> { uint4 v; };
template <> struct Pack8<float> { uint4 v[2]; };

__device__ __forceinline__ void ld8(Pack8<bf16>& p, const bf16* s) {
  p.v = *reinterpret_cast<const uint4*>(s);
}
__device__ __forceinline__ void ld8(Pack8<float>& p, const float* s) {
  const uint4* q = reinterpret_cast<const uint4*>(s);
  p.v[0] = q[0];
  p.v[1] = q[1];
}
__device__ __forceinline__ void zero8(Pack8<bf16>& p) { p.v = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero8(Pack8<float>& p) { p.v[0] = p.v[1] = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void unpack8(const Pack8<bf16>& p, float f[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&p.v);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void unpack8(const Pack8<float>& p, float f[8]) {
  const float* e = reinterpret_cast<const float*>(p.v);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = e[j];
}
__device__ __forceinline__ uint4 bf16x8(const float f[8]) {
  uint4 v;
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(f[j]);
  return v;
}
__device__ __forceinline__ uint4 bf16x8(const Pack8<bf16>& p) { return p.v; }
__device__ __forceinline__ uint4 bf16x8(const Pack8<float>& p) {
  float f[8];
  unpack8(p, f);
  return bf16x8(f);
}
__device__ __forceinline__ void st8(bf16* d, const float f[8]) {
  *reinterpret_cast<uint4*>(d) = bf16x8(f);
}
__device__ __forceinline__ void st8(float* d, const float f[8]) {
  float4* q = reinterpret_cast<float4*>(d);
  q[0] = make_float4(f[0], f[1], f[2], f[3]);
  q[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// ---------------------------------------------------------------------------
// int8 mode.

__device__ __forceinline__ int8_t quant8(float v) {
  return (int8_t)fminf(fmaxf(rintf(v), -127.0f), 127.0f);  // rintf: half to even
}

// clip(rint(f / s)) of 8 activations, s = max(amax, 1e-12) / 127 of their
// sample, with the IEEE division's result, computed mostly without it: t =
// f * (1 / s) is within 2^-23 |f / s| <= 1.6e-5 of f / s (|f| <= amax), so
// rint(t) is rint(f / s) unless t lies within 1e-4 of a half step, where
// the 8 values are divided after all. IEEE division a value put each of the
// 8 in a branch of its own (its slow-path test), one after another.
__device__ __forceinline__ void div_quant8(const float f[8], float s, int8_t e[8]) {
  const float inv = 1.0f / s;
  float t[8];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j] = f[j] * inv;
    near |= fabsf(t[j] - rintf(t[j])) > 0.4999f;
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = f[j] / s;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = quant8(t[j]);
}

// The int8 values of 8 activations f of sample b: the GN affine (+SiLU)
// in f32 first when sc is non-null, then clip(rint(a * inv_static))
// (static), clip(rint(a * (127 / amax_b))) (inv_mul: the pair's conv1) or
// clip(rint(a / (amax_b / 127))), amax_b = max(amax[b], 1e-12), as the TPU
// kernels write each. The one quantizer of the int8 modes' pre-passes.
__device__ __forceinline__ uint2 quantize8(float f[8], const float* sc, const float* sh,
                                           int silu_on, float inv_static, const Int8Args& q,
                                           int b) {
  if (sc != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f[j] = f[j] * sc[j] + sh[j];
      if (silu_on) f[j] = silu(f[j]);
    }
  }
  uint2 v;
  int8_t* e = reinterpret_cast<int8_t*>(&v);
  if (q.qs != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = quant8(f[j] * inv_static);
  } else {
    const float am = fmaxf(q.amax[b], 1e-12f);
    if (q.inv_mul) {
      const float inv = 127.0f / am;
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = quant8(f[j] * inv);
    } else {
      div_quant8(f, am / 127.0f, e);
    }
  }
  return v;
}

// max |f(x)| of 8 activations, f the GN affine (+SiLU) as quantize8 applies
// it (the dynamic mode's per-sample amax before the quantizer)
__device__ __forceinline__ float amax8(const float f[8], const float* sc, const float* sh,
                                       int silu_on, float mx) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float y = f[j];
    if (sc != nullptr) y = y * sc[j] + sh[j];
    if (silu_on) y = silu(y);
    mx = fmaxf(mx, fabsf(y));
  }
  return mx;
}

// The pre-passes' conversion of 8 activations f of sample b to dst: the GN
// affine (sc, sh; none when null) and SiLU (silu_on), then int8 by quantize8
// (TQ int8) or bf16
template <typename TQ>
__device__ __forceinline__ void convert8(float f[8], const float* sc, const float* sh,
                                         int silu_on, const Int8Args& q, int b, TQ* dst) {
  if constexpr (std::is_same<TQ, int8_t>::value) {
    const float inv_static = q.qs != nullptr ? 1.0f / *q.qs : 0.0f;
    *reinterpret_cast<uint2*>(dst) = quantize8(f, sc, sh, silu_on, inv_static, q, b);
  } else {
    // the affine as the TPU kernels' x * a + b, without a fused multiply-add:
    // a bf16 value keeps 8 bits of its own magnitude, so near zero, where
    // x * a and b cancel, an FMA's unrounded product would move it by ulps
    if (sc != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        f[j] = __fadd_rn(__fmul_rn(f[j], sc[j]), sh[j]);
        if (silu_on) f[j] = silu(f[j]);
      }
    }
    st8(dst, f);
  }
}

// ---------------------------------------------------------------------------
// K9's factor-2 resample.

// The taps of output index o along one axis (Taps: transition_kerns in
// ops/resblock.py): their input indices and coefficients; an index outside
// the input is a zero tap. Up: out[2j] = k[0] x[j-1] + k[2] x[j], out[2j+1]
// = k[1] x[j] + k[3] x[j+1]; down: out[o] = sum_a k[a] x[2o+a-1].
__device__ __forceinline__ int axis_taps(int o, int up, const float k[4], int idx[4], float c[4]) {
  if (up) {
    const int j = o >> 1;
    if (o & 1) {
      idx[0] = j; c[0] = k[1];
      idx[1] = j + 1; c[1] = k[3];
    } else {
      idx[0] = j - 1; c[0] = k[0];
      idx[1] = j; c[1] = k[2];
    }
    return 2;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    idx[a] = 2 * o + a - 1;
    c[a] = k[a];
  }
  return 4;
}

}  // namespace
