// Hopper helpers shared by the kernels that run as thread-block clusters
// and stage tiles through cp.async rings (tower.cu, loss.cu): the cluster's
// rank, distributed shared memory, cluster barriers, asynchronous copies
// from global to shared memory, and the cluster launch; and the cache-hinted
// loads of the row-group scatters (scatter.cu, scatter_sr.cu).
//
// Barriers: cluster_sync() is a release arrive and an acquire wait by every
// thread of the cluster, so shared, distributed shared and global writes
// before it are visible to every block after it. A relaxed arrive orders
// nothing: use it only where the waiting side reads nothing the arriving
// side wrote before it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dssm {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cache-hinted loads -------------------------------------------------

// 16 bytes read once, through the non-coherent path with L1::evict_first:
// a second load of the same 32-byte sector finds it in L1 without the
// stream pushing out more than it needs (the scatters' vals, PERF.md).
__device__ __forceinline__ float4 load_evict_first(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::evict_first.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 load_evict_first(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::evict_first.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// ---- the cluster --------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Address of the same shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Every thread of the cluster; orders shared, distributed shared and
// global memory (release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// ---- copies -------------------------------------------------------------

// f(r, v) for every cell of a [rows][per_row] grid, spread over a block of
// kBlock threads with one division a call (not one a cell).
template <int kBlock, typename F>
__device__ __forceinline__ void for_grid(int rows, int per_row, F f) {
  if (per_row <= 0) return;
  if (per_row <= kBlock) {
    const int step = kBlock / per_row;
    const int r0 = threadIdx.x / per_row;
    if (r0 >= step) return;
    const int v = threadIdx.x - r0 * per_row;
    for (int r = r0; r < rows; r += step) f(r, v);
  } else {
    for (int r = 0; r < rows; ++r) {
      for (int v = threadIdx.x; v < per_row; v += kBlock) f(r, v);
    }
  }
}

// kBytes from global to shared, zero-filled (nothing read) when !valid.
template <int kBytes>
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         bool valid) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (kBytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
                 : "memory");
  } else {  // a 2-byte pitch: no cp.async that small, copy through registers
    static_assert(kBytes == 2, "cp.async takes 4, 8 or 16 bytes");
    *static_cast<uint16_t*>(dst) =
        valid ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are open.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// dst[r][c] (row stride dld) = src[r][c] (row stride sld) for r < rows,
// c < cols (a multiple of 8), zero where r >= valid_rows or c >= valid_cols.
// kBytes divides valid_cols * sizeof(T), so a vector is all in or all out.
template <int kBlock, typename T, int kBytes>
__device__ __forceinline__ void copy_tile_vec(T* dst, int dld, const T* src,
                                              int64_t sld, int rows, int cols,
                                              int valid_rows, int valid_cols) {
  constexpr int ve = kBytes / (int)sizeof(T);
  for_grid<kBlock>(rows, cols / ve, [&](int r, int v) {
    const int c = v * ve;
    const bool valid = r < valid_rows && c < valid_cols;
    copy_vec<kBytes>(dst + r * dld + c, valid ? src + r * sld + c : src,
                     valid);
  });
}

template <int kBlock, typename T>
__device__ __noinline__ void copy_tile(T* dst, int dld, const T* src,
                                       int64_t sld, int rows, int cols,
                                       int valid_rows, int valid_cols,
                                       int vec_bytes) {
  switch (vec_bytes) {
    case 16:
      copy_tile_vec<kBlock, T, 16>(dst, dld, src, sld, rows, cols,
                                   valid_rows, valid_cols);
      break;
    case 8:
      copy_tile_vec<kBlock, T, 8>(dst, dld, src, sld, rows, cols, valid_rows,
                                  valid_cols);
      break;
    case 4:
      copy_tile_vec<kBlock, T, 4>(dst, dld, src, sld, rows, cols, valid_rows,
                                  valid_cols);
      break;
    default:
      copy_tile_vec<kBlock, T, (int)sizeof(T)>(dst, dld, src, sld, rows, cols,
                                               valid_rows, valid_cols);
      break;
  }
}

// ---- the launch ---------------------------------------------------------

// A launch of `blocks` blocks of `threads` in clusters of `nranks` along x
// (`attr` holds the cluster attribute the config points to).
inline cudaLaunchConfig_t cluster_config(unsigned int blocks, int threads,
                                         int nranks, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace dssm
