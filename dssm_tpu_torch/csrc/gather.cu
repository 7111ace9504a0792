// Row-group gather: compact[G*group, H] = the table rows of each group id.
//
// Replaces dssm_tpu/kernels/pallas_gather.py::gather_row_groups (kernel
// _gather_kernel), which starts one DMA per row group because a TPU slices
// HBM in (8, 128) tiles. Here a row group is simply `group * H * itemsize`
// contiguous bytes, so one kernel copies them for f32, bf16 and int8 tables.
//
// Semantics: slot s with 0 <= gids[s] < num_groups copies table group
// gids[s]; any other id (the dedupe's skip sentinel 1 << 25) reads nothing
// and writes zeros.
//
// Bound on the H100: bytes. It moves each real group once in and writes the
// whole output once, with no arithmetic. At the `full` preset (f32 table,
// H=384, 256 slots, ~107 real) that is ~1.3 MB read + 3.1 MB written,
// about 1.3 us at 3.35 TB/s, below launch overhead.
//
// Design: one thread block per slot; threads stream the group with 16-byte
// vector loads and stores (neighbouring threads on neighbouring addresses).
// The group id is tested before any address is formed, and offsets are
// 64-bit: sentinel * group * H overflows 32 bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace {

__global__ void gather_row_groups_kernel(const int4* __restrict__ table,
                                         const int32_t* __restrict__ gids,
                                         int4* __restrict__ out,
                                         int64_t num_groups,
                                         int64_t vecs_per_group) {
  const int64_t slot = blockIdx.x;
  dssm::copy_row_group(table, gids[slot], num_groups, vecs_per_group,
                       out + slot * vecs_per_group);
}

}  // namespace

// table: [num_groups * group, H] (any dtype), gids: [num_slots] int32,
// out: [num_slots * group, H]. group_bytes = group * H * itemsize, a
// multiple of 16; table and out 16-byte aligned. Returns cudaGetLastError().
extern "C" int dssm_gather_row_groups(const void* table, const void* gids,
                                      void* out, long long num_slots,
                                      long long num_groups,
                                      long long group_bytes, void* stream) {
  if (num_slots <= 0 || group_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  gather_row_groups_kernel<<<(unsigned int)num_slots, 256, 0,
                             (cudaStream_t)stream>>>(
      (const int4*)table, (const int32_t*)gids, (int4*)out,
      (int64_t)num_groups, (int64_t)(group_bytes / 16));
  return (int)cudaGetLastError();
}
