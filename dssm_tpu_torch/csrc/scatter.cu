// Row-group scatter-add, in place: table rows of group gids[s] += the
// slot's rows of vals, for an f32 table and, rounding each sum to the
// nearest bf16, for a bf16 table updated without stochastic rounding.
//
// Replaces dssm_tpu/kernels/pallas_gather.py::scatter_add_row_groups (kernel
// _scatter_kernel), which reads each row group into VMEM by DMA, adds and
// writes it back by DMA, skipping sentinel slots. Here a row group is
// `group * H` contiguous elements of the table, added to where they lie.
//
// Semantics: slot s with 0 <= gids[s] < num_groups adds vals[s*group :
// (s+1)*group] to table group gids[s]; any other id, at any position (the
// dedupe's skip sentinel 1 << 25, a negative id, one past the table),
// touches nothing. The real ids of one call are distinct (the dedupe's
// sorted unique groups), so no two threads write one address and no
// atomics are needed; the result is deterministic and bit-equal to one add
// an element (f32, or bf16 formed in f32 and rounded to nearest even).
//
// Bound on the H100: bytes. Each real group is read and written once and
// its vals read once: at the `full` preset (f32, H=384, 107 real slots of
// 256) about 4 MB, 1.18 us at 3.35 TB/s; at the cnn width (Wc [30000,
// 1024] f32, 709 real of 1024 slots of 8 rows) 70 MB, 20.8 us.
//
// Design: the flat grid of scatter_sr.cu. A thread takes one 16-byte vector
// of a slot's group (4 f32 or 8 bf16), a block kThreads of them, and a slot
// ceil(vectors / kThreads) blocks (`blockIdx.x / blocks` names it), so a
// real slot's work spreads over several blocks and SMs and a skip slot
// costs blocks that read one id. A thread tests its slot's id before it
// forms any address, issues its table load and its vals load together,
// adds and stores: one memory round trip. Offsets are 64-bit: sentinel *
// group * H overflows 32 bits.
// Measured on the card (tools/eval_kernels.py --cases scatter, PERF.md):
// vals read with L1::evict_first or L1::no_allocate, or streaming (.cs),
// are as fast as each other; plain loads a third slower at the cnn width;
// 2 or 4 vectors a thread no faster. At the lstm width (1024 slots of 8 x
// 384) the block-a-slot loop is up to 1.5 us faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // load_evict_first

namespace {

constexpr int kThreads = 256;

struct F32 {
  using Vec = float4;
  static constexpr int kElems = 4;  // a 16-byte vector's
  static __device__ __forceinline__ float4 add(float4 t, float4 v) {
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
    return t;
  }
};

// Two bf16 values in a word: each sum formed in f32 and rounded to nearest
// even, which is what a bf16 add is.
__device__ __forceinline__ uint32_t add_bf16_pair(uint32_t a, uint32_t b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float hi = __uint_as_float(a & 0xFFFF0000u) +
                   __uint_as_float(b & 0xFFFF0000u);
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

struct Bf16 {
  using Vec = uint4;
  static constexpr int kElems = 8;
  static __device__ __forceinline__ uint4 add(uint4 t, uint4 v) {
    t.x = add_bf16_pair(t.x, v.x);
    t.y = add_bf16_pair(t.y, v.y);
    t.z = add_bf16_pair(t.z, v.z);
    t.w = add_bf16_pair(t.w, v.w);
    return t;
  }
};

// table and vals as 16-byte vectors; vecs: a group's vectors; blocks: a
// slot's blocks.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
    scatter_add_row_groups_kernel(typename Op::Vec* __restrict__ table,
                                  const int32_t* __restrict__ gids,
                                  const typename Op::Vec* __restrict__ vals,
                                  int64_t num_groups, uint32_t vecs,
                                  uint32_t blocks) {
  const uint32_t slot = blockIdx.x / blocks;
  const uint32_t vec = (blockIdx.x - slot * blocks) * kThreads + threadIdx.x;
  const int64_t gid = __ldg(gids + slot);
  if (gid < 0 || gid >= num_groups || vec >= vecs) return;
  typename Op::Vec* dst = table + gid * vecs + vec;
  const typename Op::Vec t = *dst;
  // A thread reads one vals vector, once.
  const typename Op::Vec v =
      dssm::load_evict_first(vals + (uint64_t)slot * vecs + vec);
  *dst = Op::add(t, v);
}

template <typename Op>
int launch(void* table, const void* gids, const void* vals,
           long long num_slots, long long num_groups, long long group_elems,
           void* stream) {
  if (num_slots <= 0 || group_elems <= 0 || group_elems % Op::kElems != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long vecs = group_elems / Op::kElems;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  if (vecs >= (1LL << 32) || num_slots * blocks >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  using V = typename Op::Vec;
  scatter_add_row_groups_kernel<Op>
      <<<(unsigned int)(num_slots * blocks), kThreads, 0,
         (cudaStream_t)stream>>>((V*)table, (const int32_t*)gids,
                                 (const V*)vals, (int64_t)num_groups,
                                 (uint32_t)vecs, (uint32_t)blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// table: [num_groups * group, H] f32, updated in place; gids: [num_slots]
// int32; vals: [num_slots * group, H] f32. group_floats = group * H, a
// multiple of 4; table and vals 16-byte aligned; under 2^31 blocks of 256
// vectors. Returns cudaGetLastError().
extern "C" int dssm_scatter_add_row_groups(void* table, const void* gids,
                                           const void* vals,
                                           long long num_slots,
                                           long long num_groups,
                                           long long group_floats,
                                           void* stream) {
  return launch<F32>(table, gids, vals, num_slots, num_groups, group_floats,
                     stream);
}

// The same for a bf16 table and bf16 vals. group_elems = group * H, a
// multiple of 8.
extern "C" int dssm_scatter_add_bf16_row_groups(void* table, const void* gids,
                                                const void* vals,
                                                long long num_slots,
                                                long long num_groups,
                                                long long group_elems,
                                                void* stream) {
  return launch<Bf16>(table, gids, vals, num_slots, num_groups, group_elems,
                      stream);
}
