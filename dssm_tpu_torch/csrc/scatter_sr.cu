// Row-group scatter updates with stochastic rounding, in place, for bf16 and
// int8 tables:
//
//   bf16: row = SR_bf16(f32(row) + vals)               for each real slot
//   int8: q   = int8(clip(floor(f32(q) + vals_grid + u), -127, 127)),
//         u   = (bits >> 8) * 2^-24
//
// Replaces dssm_tpu/kernels/pallas_gather.py::scatter_sr_row_groups (kernel
// _scatter_sr_kernel) and ::scatter_sr_int8_row_groups (kernel
// _scatter_sr_int8_kernel), which DMA each row group into VMEM, draw bits
// from the TPU's PRNG seeded per 32-group grid step, round and DMA back.
//
// Semantics: slot s with 0 <= gids[s] < num_groups replaces table group
// gids[s] by the rounded sum of its rows and vals[s*group : (s+1)*group]
// (SET semantics: the real ids of one call are distinct, as the dedupe
// makes them, so no two blocks touch one address and the result is
// deterministic). Any other id (the dedupe's skip sentinel 1 << 25) touches
// nothing. A zero update leaves a row bit-identical: a bf16 value has zero
// low bits and cannot carry, and floor(q + u) = q for u < 1 (the int8
// kernel adds u to the fraction alone, so f32 rounding cannot carry either).
//
// Random bits: Philox4x32-10 in registers, key (seed, 0), counter
// (e / 4, 0, 0) as a 64-bit value in the first two words, output word e % 4,
// for the element with flat index e = slot * group * H + offset in the
// compact block. kernels/stochastic.py::philox_bits is the same stream in
// plain PyTorch, so the plain versions of these updates are bit-equal to
// the kernels.
//
// Bound on the H100: bytes. Each real group is read and written once and
// its f32 vals read once: at the `full` preset (H = 384, ~107 real slots of
// 256) 5.3 MB for bf16 (16-row groups) and 7.9 MB for int8 (32-row groups),
// 1.6 and 2.4 us at 3.35 TB/s, below launch overhead. The ten Philox rounds
// per four elements are integer work the memory traffic hides.
//
// Design: one thread block per slot; a thread takes one 16-byte vector of
// the table at a time (8 bf16 or 16 int8), the f32 vals that belong to it as
// 16-byte loads, and one Philox call per four elements. The group id is
// tested before any address is formed, and offsets are 64-bit: sentinel *
// group * H overflows 32 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint64_t counter,
                                               uint32_t key0) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = key0, k1 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// f32 accumulator -> bf16 bits: add 16 random bits below the kept half and
// truncate.
__device__ __forceinline__ uint32_t sr_bf16_bits(uint32_t old_bf16, float val,
                                                 uint32_t rnd) {
  const float acc = __uint_as_float(old_bf16 << 16) + val;
  return (__float_as_uint(acc) + (rnd & 0xFFFFu)) >> 16;
}

// Two bf16 values packed in one word (lower address in the low half).
__device__ __forceinline__ uint32_t sr_bf16_pair(uint32_t word, float v_lo,
                                                 float v_hi, uint32_t r_lo,
                                                 uint32_t r_hi) {
  return sr_bf16_bits(word & 0xFFFFu, v_lo, r_lo) |
         (sr_bf16_bits(word >> 16, v_hi, r_hi) << 16);
}

__global__ void scatter_sr_bf16_kernel(uint4* __restrict__ table,
                                       const int32_t* __restrict__ gids,
                                       const float4* __restrict__ vals,
                                       int64_t num_groups,
                                       int64_t vecs_per_group, uint32_t seed) {
  const int64_t slot = blockIdx.x;
  const int64_t gid = gids[slot];
  if (gid < 0 || gid >= num_groups) return;
  uint4* dst = table + gid * vecs_per_group;
  // A table vector holds 8 elements: two float4 of vals, two counters.
  const float4* src = vals + slot * vecs_per_group * 2;
  const uint64_t ctr0 = (uint64_t)slot * (uint64_t)vecs_per_group * 2u;
  for (int64_t i = threadIdx.x; i < vecs_per_group; i += blockDim.x) {
    uint4 t = dst[i];
    const float4 va = src[2 * i], vb = src[2 * i + 1];
    const uint4 ra = philox4x32_10(ctr0 + 2u * (uint64_t)i, seed);
    const uint4 rb = philox4x32_10(ctr0 + 2u * (uint64_t)i + 1u, seed);
    t.x = sr_bf16_pair(t.x, va.x, va.y, ra.x, ra.y);
    t.y = sr_bf16_pair(t.y, va.z, va.w, ra.z, ra.w);
    t.z = sr_bf16_pair(t.z, vb.x, vb.y, rb.x, rb.y);
    t.w = sr_bf16_pair(t.w, vb.z, vb.w, rb.z, rb.w);
    dst[i] = t;
  }
}

__device__ __forceinline__ uint32_t sr_int8_byte(uint32_t old_byte, float val,
                                                 uint32_t rnd) {
  const float acc = (float)(int)(int8_t)old_byte + val;
  const float u = (float)(rnd >> 8) * 5.9604644775390625e-08f;  // 2^-24
  // floor(acc + u) as floor(acc) + (frac + u >= 1): one f32 add of acc and
  // u would round an integer acc up when u is within half an ulp of 1.
  const float low = floorf(acc);
  const float q = low + (((acc - low) + u >= 1.0f) ? 1.0f : 0.0f);
  return (uint32_t)(int)fminf(fmaxf(q, -127.0f), 127.0f) & 0xFFu;
}

// Four int8 values packed in one word, lowest address in the low byte.
__device__ __forceinline__ uint32_t sr_int8_word(uint32_t word, float4 v,
                                                 uint4 r) {
  return sr_int8_byte(word & 0xFFu, v.x, r.x) |
         (sr_int8_byte((word >> 8) & 0xFFu, v.y, r.y) << 8) |
         (sr_int8_byte((word >> 16) & 0xFFu, v.z, r.z) << 16) |
         (sr_int8_byte(word >> 24, v.w, r.w) << 24);
}

__global__ void scatter_sr_int8_kernel(uint4* __restrict__ table,
                                       const int32_t* __restrict__ gids,
                                       const float4* __restrict__ vals,
                                       int64_t num_groups,
                                       int64_t vecs_per_group, uint32_t seed) {
  const int64_t slot = blockIdx.x;
  const int64_t gid = gids[slot];
  if (gid < 0 || gid >= num_groups) return;
  uint4* dst = table + gid * vecs_per_group;
  // A table vector holds 16 elements: four float4 of vals, four counters.
  const float4* src = vals + slot * vecs_per_group * 4;
  const uint64_t ctr0 = (uint64_t)slot * (uint64_t)vecs_per_group * 4u;
  for (int64_t i = threadIdx.x; i < vecs_per_group; i += blockDim.x) {
    uint4 t = dst[i];
    const uint64_t c = ctr0 + 4u * (uint64_t)i;
    t.x = sr_int8_word(t.x, src[4 * i], philox4x32_10(c, seed));
    t.y = sr_int8_word(t.y, src[4 * i + 1], philox4x32_10(c + 1u, seed));
    t.z = sr_int8_word(t.z, src[4 * i + 2], philox4x32_10(c + 2u, seed));
    t.w = sr_int8_word(t.w, src[4 * i + 3], philox4x32_10(c + 3u, seed));
    dst[i] = t;
  }
}

}  // namespace

// table: [num_groups * group, H] bf16, updated in place; gids: [num_slots]
// int32; vals: [num_slots * group, H] f32. group_elems = group * H, a
// multiple of 8; table and vals 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int dssm_scatter_sr_bf16_row_groups(void* table, const void* gids,
                                               const void* vals,
                                               long long num_slots,
                                               long long num_groups,
                                               long long group_elems,
                                               int seed, void* stream) {
  if (num_slots <= 0 || group_elems <= 0 || group_elems % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  scatter_sr_bf16_kernel<<<(unsigned int)num_slots, 256, 0,
                           (cudaStream_t)stream>>>(
      (uint4*)table, (const int32_t*)gids, (const float4*)vals,
      (int64_t)num_groups, (int64_t)(group_elems / 8), (uint32_t)seed);
  return (int)cudaGetLastError();
}

// table: [num_groups * group, H] int8, updated in place; vals_grid:
// [num_slots * group, H] f32 in grid units (already divided by the row's
// scale). group_elems = group * H, a multiple of 16.
extern "C" int dssm_scatter_sr_int8_row_groups(void* table, const void* gids,
                                               const void* vals_grid,
                                               long long num_slots,
                                               long long num_groups,
                                               long long group_elems,
                                               int seed, void* stream) {
  if (num_slots <= 0 || group_elems <= 0 || group_elems % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  scatter_sr_int8_kernel<<<(unsigned int)num_slots, 256, 0,
                           (cudaStream_t)stream>>>(
      (uint4*)table, (const int32_t*)gids, (const float4*)vals_grid,
      (int64_t)num_groups, (int64_t)(group_elems / 16), (uint32_t)seed);
  return (int)cudaGetLastError();
}
