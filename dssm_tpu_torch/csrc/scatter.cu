// Row-group scatter-add, in place: table rows of group gids[s] += the
// slot's rows of vals, for an f32 table and, rounding each sum to the
// nearest bf16, for a bf16 table updated without stochastic rounding.
//
// Replaces dssm_tpu/kernels/pallas_gather.py::scatter_add_row_groups (kernel
// _scatter_kernel), which reads each row group into VMEM by DMA, adds and
// writes it back by DMA, skipping sentinel slots. Here a row group is
// `group * H` contiguous floats of the table, added to where they lie.
//
// Semantics: slot s with 0 <= gids[s] < num_groups adds vals[s*group :
// (s+1)*group] to table group gids[s]; any other id (the dedupe's skip
// sentinel 1 << 25) touches nothing. The real ids of one call are distinct
// (the dedupe's sorted unique groups), so no two blocks write one address
// and no atomics are needed; the result is deterministic.
//
// Bound on the H100: bytes. Each real group is read and written once and
// its vals read once: at the `full` preset (f32, H=384, ~110 real slots of
// 256) about 4 MB, ~1.2 us at 3.35 TB/s, below launch overhead.
//
// Design: one thread block per slot, 16-byte vector loads and stores. The
// group id is tested before any address is formed, and offsets are 64-bit:
// sentinel * group * H overflows 32 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_add_row_groups_kernel(float4* __restrict__ table,
                                              const int32_t* __restrict__ gids,
                                              const float4* __restrict__ vals,
                                              int64_t num_groups,
                                              int64_t vecs_per_group) {
  const int64_t slot = blockIdx.x;
  const int64_t gid = gids[slot];
  if (gid < 0 || gid >= num_groups) return;
  float4* dst = table + gid * vecs_per_group;
  const float4* src = vals + slot * vecs_per_group;
  for (int64_t i = threadIdx.x; i < vecs_per_group; i += blockDim.x) {
    float4 t = dst[i];
    const float4 v = src[i];
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
    dst[i] = t;
  }
}

// Two bf16 values in a word: each sum formed in f32 and rounded to nearest
// even, which is what a bf16 add is.
__device__ __forceinline__ uint32_t add_bf16_pair(uint32_t a, uint32_t b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float hi = __uint_as_float(a & 0xFFFF0000u) +
                   __uint_as_float(b & 0xFFFF0000u);
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__global__ void scatter_add_bf16_row_groups_kernel(
    uint4* __restrict__ table, const int32_t* __restrict__ gids,
    const uint4* __restrict__ vals, int64_t num_groups,
    int64_t vecs_per_group) {
  const int64_t slot = blockIdx.x;
  const int64_t gid = gids[slot];
  if (gid < 0 || gid >= num_groups) return;
  uint4* dst = table + gid * vecs_per_group;
  const uint4* src = vals + slot * vecs_per_group;
  for (int64_t i = threadIdx.x; i < vecs_per_group; i += blockDim.x) {
    uint4 t = dst[i];
    const uint4 v = src[i];
    t.x = add_bf16_pair(t.x, v.x);
    t.y = add_bf16_pair(t.y, v.y);
    t.z = add_bf16_pair(t.z, v.z);
    t.w = add_bf16_pair(t.w, v.w);
    dst[i] = t;
  }
}

}  // namespace

// table: [num_groups * group, H] f32, updated in place; gids: [num_slots]
// int32; vals: [num_slots * group, H] f32. group_floats = group * H, a
// multiple of 4; table and vals 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int dssm_scatter_add_row_groups(void* table, const void* gids,
                                           const void* vals,
                                           long long num_slots,
                                           long long num_groups,
                                           long long group_floats,
                                           void* stream) {
  if (num_slots <= 0 || group_floats <= 0 || group_floats % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  scatter_add_row_groups_kernel<<<(unsigned int)num_slots, 256, 0,
                                  (cudaStream_t)stream>>>(
      (float4*)table, (const int32_t*)gids, (const float4*)vals,
      (int64_t)num_groups, (int64_t)(group_floats / 4));
  return (int)cudaGetLastError();
}

// The same for a bf16 table and bf16 vals. group_elems = group * H, a
// multiple of 8.
extern "C" int dssm_scatter_add_bf16_row_groups(void* table, const void* gids,
                                                const void* vals,
                                                long long num_slots,
                                                long long num_groups,
                                                long long group_elems,
                                                void* stream) {
  if (num_slots <= 0 || group_elems <= 0 || group_elems % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  scatter_add_bf16_row_groups_kernel<<<(unsigned int)num_slots, 256, 0,
                                       (cudaStream_t)stream>>>(
      (uint4*)table, (const int32_t*)gids, (const uint4*)vals,
      (int64_t)num_groups, (int64_t)(group_elems / 8));
  return (int)cudaGetLastError();
}
