// Device helpers shared by the lookup kernels (count.cu and embed.cu
// through lookup_fwd.cuh, joint.cu, and the segmented sums of segsum.cuh):
// f32 views of the table dtypes and the column vectors a lane loads and
// stores.
//
// A lookup row is K (slot, weight) pairs. A pair is live when its weight is
// not zero and its slot resolves to a row of the source block: slot in
// [0, u2) and, when a row selection `sel` is given, sel[slot] in [0, gr).
// Dead pairs (hash padding, lookups dropped by the dedupe, padded `sel`
// slots that point past the block) contribute nothing, as they have no
// column in the reference's count matrix or one-hot selection.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dssm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- column vectors --------------------------------------------------------

// What one lane loads at a time: VEC values of T (16 bytes; 4 bf16, 8
// bytes; or one value).
template <typename T, int VEC>
struct Raw;
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<float, 1> {
  using type = float;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<__nv_bfloat16, 1> {
  using type = unsigned short;
};

__device__ __forceinline__ float4 load_raw(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ uint4 load_raw(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint2 load_raw(const uint2* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short load_raw(const unsigned short* p) {
  return __ldg(p);
}

// The Raw vector of T at element offset `at` of `base`.
template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_vec(const T* base,
                                                               int64_t at) {
  using R = typename Raw<T, VEC>::type;
  return load_raw(reinterpret_cast<const R*>(base + at));
}

// A Raw vector as f32 values; bf16 -> f32 is exact (the bf16 bits are the
// f32's upper half).
__device__ __forceinline__ void to_floats(float4 x, float (&f)[4]) {
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void to_floats(float x, float (&f)[1]) { f[0] = x; }
__device__ __forceinline__ void to_floats(uint4 x, float (&f)[8]) {
  const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_floats(uint2 x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x << 16);
  f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16);
  f[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void to_floats(unsigned short x, float (&f)[1]) {
  f[0] = __uint_as_float((unsigned int)x << 16);
}

// VEC f32 values to p (16-byte aligned when VEC > 1), with streaming stores
// (st.global.cs: written once, read once by the next kernel) or plain ones.
template <int VEC, bool kStream>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (kStream) {
      __stcs(p, f[0]);
    } else {
      *p = f[0];
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 v = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      if constexpr (kStream) {
        __stcs(reinterpret_cast<float4*>(p + e), v);
      } else {
        *reinterpret_cast<float4*>(p + e) = v;
      }
    }
  }
}

// Vectors a lane owns in one column pass: 1, 2, 3, 4 or 8 (more passes
// above 32 * 8 vectors a row).
inline int lane_vectors(long long nvec) {
  return nvec <= 32 ? 1 : nvec <= 64 ? 2 : nvec <= 96 ? 3 : nvec <= 128 ? 4 : 8;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace dssm
