// Rows held in registers as 16-byte packs: the loads, element access and
// stores shared by the RMSNorm forward (rmsnorm.cu) and backward
// (rmsnorm_bwd.cu) kernels, and the warp's shuffle sum.
#pragma once

#include "common.cuh"

// V elements of E in registers, as 32-bit words (8, 16 or 32 bytes).
template <typename E, int V>
struct Pack {
  static constexpr int kWords = V * (int)sizeof(E) / 4;
  uint32_t u[kWords];
};

// p is aligned to the pack's size (8 or 16 bytes; 32-byte packs take two
// 16-byte loads).
template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load_pack(const E* p) {
  Pack<E, V> r;
  if constexpr (Pack<E, V>::kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.u[0] = v.x; r.u[1] = v.y;
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < Pack<E, V>::kWords / 4; ++i) {
      const uint4 v = q[i];
      r.u[4 * i] = v.x; r.u[4 * i + 1] = v.y;
      r.u[4 * i + 2] = v.z; r.u[4 * i + 3] = v.w;
    }
  }
  return r;
}

template <int V>
__device__ __forceinline__ float elem(const Pack<float, V>& p, int i) {
  return __uint_as_float(p.u[i]);
}
template <int V>
__device__ __forceinline__ float elem(const Pack<__nv_bfloat16, V>& p,
                                      int i) {
  const uint32_t w = p.u[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// 16 bytes of T from V floats, stored at p (16-byte aligned).
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The thread's NV vectors: vector j = first + stride * i of the row, for
// the j below nvec.  Loads w (once, before the row loop) or a row of x.
template <typename E, int V, int NV>
__device__ __forceinline__ void load_slice(Pack<E, V> (&out)[NV],
                                           const E* base, int first,
                                           int stride, int nvec) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = first + stride * i;
    if (j < nvec) out[i] = load_pack<E, V>(base + (int64_t)j * V);
  }
}
