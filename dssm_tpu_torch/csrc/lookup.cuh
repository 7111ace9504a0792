// Device functions shared by the lookup kernels (count.cu, joint.cu's
// joint lookup) and the row-group gather (gather.cu).
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

// Threads of a lookup block: one per column of H, whole warps, at most 512
// (wider rows loop).
inline int block_threads(int h) {
  const int threads = ((h + 31) / 32) * 32;
  return threads > 512 ? 512 : threads;
}

// Called by the first warp of a block: writes the live pairs of one lookup
// row, in k order, to s_row (the source row each resolves to) and s_wgt,
// and returns their number (the same value in every lane). `limit` bounds
// the resolved row: u2 without sel, gr with it.
__device__ __forceinline__ int compact_live_pairs(
    const int32_t* __restrict__ inv_row, const float* __restrict__ wgt_row,
    const int32_t* __restrict__ sel, int k, int u2, int limit,
    int32_t* s_row, float* s_wgt) {
  const int lane = threadIdx.x;
  int live = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    int32_t u = -1;
    float w = 0.f;
    if (j < k) {
      u = inv_row[j];
      w = wgt_row[j];
    }
    bool keep = j < k && w != 0.f && u >= 0 && u < u2;
    if (keep && sel != nullptr) u = sel[u];
    keep = keep && u >= 0 && u < limit;
    const unsigned int mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = live + __popc(mask & ((1u << lane) - 1u));
      s_row[pos] = u;
      s_wgt[pos] = w;
    }
    live += __popc(mask);
  }
  return live;
}

// One slot of a row-group gather, by the block's threads: dst = the
// table's row group gid (vecs 16-byte vectors), or zeros when gid is not in
// [0, num_groups) (an empty slot, such as the dedupe's sentinel). gid is
// tested before any table address is formed; offsets are 64-bit.
__device__ __forceinline__ void copy_row_group(
    const int4* __restrict__ table, int64_t gid, int64_t num_groups,
    int64_t vecs, int4* __restrict__ dst) {
  if (gid >= 0 && gid < num_groups) {
    const int4* src = table + gid * vecs;
    for (int64_t i = threadIdx.x; i < vecs; i += blockDim.x) dst[i] = src[i];
  } else {
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int64_t i = threadIdx.x; i < vecs; i += blockDim.x) dst[i] = zero;
  }
}

// out[c] = sum_j s_wgt[j] * src[s_row[j], c] for the block's columns, f32
// accumulation in k order. A negative s_row[j] reads as a zero row: its
// term stays in the sum, as an empty slot's zeroed compact row would.
template <typename T>
__device__ __forceinline__ void accumulate_row(
    const T* __restrict__ src, const int32_t* s_row, const float* s_wgt,
    int n, int h, float* __restrict__ out_row) {
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int32_t row = s_row[j];
      const float v = row >= 0 ? to_f32(src[(int64_t)row * h + c]) : 0.f;
      acc = fmaf(s_wgt[j], v, acc);
    }
    out_row[c] = acc;
  }
}

// The transpose of accumulate_row: dst[s_row[j], c] += s_wgt[j] * g[c].
// Several lookup rows (blocks) add into one dst row, so the adds are f32
// atomics: the sum is right, its order (and so its last bits) is not fixed
// from run to run. count.cu's backward uses it; joint.cu's backward no
// longer does (it sorts the lookups by row and sums each row in order).
template <typename G>
__device__ __forceinline__ void scatter_row_grad(
    float* __restrict__ dst, const int32_t* s_row, const float* s_wgt, int n,
    int h, const G* __restrict__ g_row) {
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    const float g = to_f32(g_row[c]);
    for (int j = 0; j < n; ++j) {
      atomicAdd(dst + (int64_t)s_row[j] * h + c, s_wgt[j] * g);
    }
  }
}

}  // namespace dssm
