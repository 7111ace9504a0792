// Row-group gather: compact[G*group, H] = the table rows of each group id.
//
// Replaces dssm_tpu/kernels/pallas_gather.py::gather_row_groups (kernel
// _gather_kernel), which starts one DMA per row group because a TPU slices
// HBM in (8, 128) tiles. Here a row group is simply `group * H * itemsize`
// contiguous bytes, so one kernel copies them for f32, bf16 and int8 tables.
//
// Semantics: slot s with 0 <= gids[s] < num_groups copies table group
// gids[s]; any other id (the dedupe's skip sentinel 1 << 25, or a negative
// id) reads nothing and writes zeros.
//
// Bound on the H100: bytes. It moves each real group once in and writes the
// whole output once, with no arithmetic. At the `full` preset (256 slots of
// 12 KB, ~107 real at f32) that is ~1.3 MB read + 3.1 MB written, about
// 1.3 us at 3.35 TB/s, near launch latency; at the cnn eval shape (1024
// slots of 32 KB, ~710 real) 23 + 34 MB, 17 us.
//
// Design: the output is one flat run of 16-byte vectors, cut into tiles of
// kThreads * kLoads, a block a tile. A thread issues all kLoads of its
// loads (the slot's id, then a non-allocating 16-byte load of the table,
// or zeros for an empty slot) before any of its stores, so each thread has
// kLoads copies in flight. kLoads is 1 for an output of
// up to kSmallVecs vectors (`full`: one wave of short-lived blocks, the
// least latency) and 8 above (cnn: 8 loads in flight a thread). The slot's
// id is tested before a table address is formed; table offsets are 64-bit
// (sentinel * group bytes overflows 32 bits).
// Also tried on the card (tools/eval_kernels.py, PERF.md): the copy through
// the TMA's bulk copies, a thread issuing global -> shared -> global
// chunks through a ring of shared-memory stages: slower at both shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSmallVecs = 1u << 20;  // 16 MB of output

__device__ __forceinline__ int4 load_no_allocate(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int kLoads>
__global__ void __launch_bounds__(kThreads)
    gather_row_groups_kernel(const int4* __restrict__ table,
                             const int32_t* __restrict__ gids,
                             int4* __restrict__ out, uint32_t total,
                             int64_t num_groups, uint32_t vecs) {
  const uint32_t base = blockIdx.x * (kThreads * kLoads) + threadIdx.x;
  int4 x[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const uint32_t v = base + j * kThreads;
    x[j] = make_int4(0, 0, 0, 0);
    if (v < total) {
      const uint32_t slot = v / vecs;
      const int64_t gid = __ldg(gids + slot);
      if (gid >= 0 && gid < num_groups) {
        x[j] = load_no_allocate(table + gid * vecs + (v - slot * vecs));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const uint32_t v = base + j * kThreads;
    if (v < total) out[v] = x[j];
  }
}

template <int kLoads>
void launch(const void* table, const void* gids, void* out, uint32_t total,
            long long num_groups, uint32_t vecs, cudaStream_t s) {
  constexpr uint32_t kTile = kThreads * kLoads;
  gather_row_groups_kernel<kLoads><<<(total + kTile - 1) / kTile, kThreads, 0,
                                     s>>>(
      (const int4*)table, (const int32_t*)gids, (int4*)out, total,
      (int64_t)num_groups, vecs);
}

}  // namespace

// table: [num_groups * group, H] (any dtype), gids: [num_slots] int32,
// out: [num_slots * group, H]. group_bytes = group * H * itemsize, a
// multiple of 16; the output under 2^31 16-byte vectors (32 GB); table and
// out 16-byte aligned. Returns cudaGetLastError().
extern "C" int dssm_gather_row_groups(const void* table, const void* gids,
                                      void* out, long long num_slots,
                                      long long num_groups,
                                      long long group_bytes, void* stream) {
  if (num_slots <= 0 || group_bytes <= 0 || group_bytes % 16 != 0 ||
      num_slots >= (1LL << 31) / (group_bytes / 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t vecs = (uint32_t)(group_bytes / 16);
  const uint32_t total = (uint32_t)(num_slots * vecs);
  cudaStream_t s = (cudaStream_t)stream;
  if (total <= kSmallVecs) {
    launch<1>(table, gids, out, total, num_groups, vecs, s);
  } else {
    launch<8>(table, gids, out, total, num_groups, vecs, s);
  }
  return (int)cudaGetLastError();
}
