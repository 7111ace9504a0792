// Count lookup: out[r, :] = sum_k wgt[r, k] * compact2[inv[r, k], :].
//
// Replaces dssm_tpu/kernels/pallas_count.py::count_lookup_pallas, forward
// (kernel _fwd_kernel) and backward (kernel _bwd_kernel). A TPU gathers rows
// serially, so that kernel builds the count matrix
// cnt[r, u] = sum_k wgt[r,k]*[inv==u] with vector compares and multiplies it
// into compact2 on the matrix unit.
// The same function here is a direct gather-accumulate: the count matrix is
// never built. Counts are small integers, exact in bf16, so only the f32
// summation order differs from cnt @ compact2.
//
// Semantics: lookups with wgt == 0 or inv outside [0, u2) contribute
// nothing (the count matrix has no column for them); accumulation is f32;
// compact2 is f32 or bf16; out is f32.
//
// Bound on the H100: bytes. At the `full` preset (1024 rows, K=64, H=384,
// u2=1024 bf16) it reads inv+wgt (0.5 MB) and the touched compact2 rows
// (<= 0.8 MB) and writes 1.6 MB: ~1 us at 3.35 TB/s; the 2*nnz*H FLOPs
// are ~50 MFLOP.
//
// Design: one thread block per row, one thread per column of H. The first
// warp compacts the row's live (inv, wgt) pairs into shared memory in k
// order (ballot + popc, so the sum order is fixed); every thread then runs
// the same branch-free loop over them, unrolled so that several compact2
// loads are in flight. Reads of one compact2 row are coalesced.
//
// Backward: d_compact2[inv[r, k], :] += wgt[r, k] * g[r, :], f32, into a
// zeroed [u2, h] buffer: the same block layout, with an atomic add per
// (live lookup, column) in place of the load (lookup.cuh). It moves g once
// and the touched rows of d_compact2 once; the atomics on hot rows bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace {

template <typename T>
__global__ void count_lookup_kernel(const T* __restrict__ compact2,
                                    const int32_t* __restrict__ inv,
                                    const float* __restrict__ wgt,
                                    float* __restrict__ out, int k, int u2,
                                    int h) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_row = reinterpret_cast<int32_t*>(smem_raw);
  float* s_wgt = reinterpret_cast<float*>(smem_raw + sizeof(int32_t) * k);
  __shared__ int s_live;
  const int64_t r = blockIdx.x;
  if (threadIdx.x < 32) {
    const int live = dssm::compact_live_pairs(inv + r * k, wgt + r * k,
                                              nullptr, k, u2, u2, s_row,
                                              s_wgt);
    if (threadIdx.x == 0) s_live = live;
  }
  __syncthreads();
  dssm::accumulate_row(compact2, s_row, s_wgt, s_live, h, out + r * h);
}

template <typename G>
__global__ void count_lookup_bwd_kernel(const int32_t* __restrict__ inv,
                                        const float* __restrict__ wgt,
                                        const G* __restrict__ g,
                                        float* __restrict__ dc2, int k,
                                        int u2, int h) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_row = reinterpret_cast<int32_t*>(smem_raw);
  float* s_wgt = reinterpret_cast<float*>(smem_raw + sizeof(int32_t) * k);
  __shared__ int s_live;
  const int64_t r = blockIdx.x;
  if (threadIdx.x < 32) {
    const int live = dssm::compact_live_pairs(inv + r * k, wgt + r * k,
                                              nullptr, k, u2, u2, s_row,
                                              s_wgt);
    if (threadIdx.x == 0) s_live = live;
  }
  __syncthreads();
  dssm::scatter_row_grad(dc2, s_row, s_wgt, s_live, h, g + r * h);
}

}  // namespace

// compact2: [u2, h] (dtype 0 = f32, 1 = bf16), inv: [rows, k] int32,
// wgt: [rows, k] f32, out: [rows, h] f32. Returns cudaGetLastError().
extern "C" int dssm_count_lookup(const void* compact2, const void* inv,
                                 const void* wgt, void* out, long long rows,
                                 int k, int u2, int h, int dtype,
                                 void* stream) {
  if (rows <= 0 || k <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(int32_t) + sizeof(float)) * (size_t)k;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = dssm::block_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    count_lookup_kernel<float><<<(unsigned int)rows, threads, smem, s>>>(
        (const float*)compact2, (const int32_t*)inv, (const float*)wgt,
        (float*)out, k, u2, h);
  } else if (dtype == 1) {
    count_lookup_kernel<__nv_bfloat16><<<(unsigned int)rows, threads, smem,
                                         s>>>(
        (const __nv_bfloat16*)compact2, (const int32_t*)inv,
        (const float*)wgt, (float*)out, k, u2, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// inv, wgt: [rows, k]; g: [rows, h] (g_dtype 0 = f32, 1 = bf16); dc2:
// [u2, h] f32, zeroed by the caller, added into. Returns cudaGetLastError().
extern "C" int dssm_count_lookup_bwd(const void* inv, const void* wgt,
                                     const void* g, void* dc2, long long rows,
                                     int k, int u2, int h, int g_dtype,
                                     void* stream) {
  if (rows <= 0 || k <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(int32_t) + sizeof(float)) * (size_t)k;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = dssm::block_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (g_dtype == 0) {
    count_lookup_bwd_kernel<float><<<(unsigned int)rows, threads, smem, s>>>(
        (const int32_t*)inv, (const float*)wgt, (const float*)g, (float*)dc2,
        k, u2, h);
  } else if (g_dtype == 1) {
    count_lookup_bwd_kernel<__nv_bfloat16><<<(unsigned int)rows, threads,
                                             smem, s>>>(
        (const int32_t*)inv, (const float*)wgt, (const __nv_bfloat16*)g,
        (float*)dc2, k, u2, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
