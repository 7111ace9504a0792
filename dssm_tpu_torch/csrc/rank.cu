// Streaming rank count for retrieval eval:
//
//   count[i] += #{ j < ND, j != i : q_i . d_j > true_i }
//
// so that with count preset to 1 it ends as the rank of query i's aligned
// doc (rank 1 = nothing scores strictly above it; a tie does not count).
//
// Replaces dssm_tpu/kernels/pallas_rank.py::rank_counts_pallas (kernel
// _rank_kernel), which fuses compare-and-count into a blockwise matmul so
// that score blocks live only in VMEM, with 512 x 2048 tiles, a sequential
// column grid carrying the count in scratch, and closed-form corrections for
// the self column and the zero padding. Here the [N, ND] scores never leave
// registers; the self column and the ragged edges are index tests.
//
// true_i = sum(q_i * d_i) is computed outside and passed in, so the
// comparison cannot be flipped by the product's own rounding of the
// diagonal entry, as in the reference.
//
// Bound on the H100: operations. 2 * N * ND * D f32 FLOPs on CUDA cores
// (67 TFLOP/s): 164 us at 6553 x 6553 x 128; the bytes (q, d, true once,
// the counts once) are 6.8 MB, 2 us.
//
// Design: a block of 256 threads forms one 64 x 64 tile of scores, a thread
// a 4 x 4 patch (rows ty*4 + i, columns tx + 16*j, which keeps the 16-byte
// shared-memory reads of the doc tile free of bank conflicts). The depth is
// walked in chunks of 32 through shared memory, rows padded by 4 floats;
// products are f32 FMAs in increasing k. The patch is compared with the
// row's true score, the 16 threads of a row add their counts by warp
// shuffle, and one int32 atomicAdd per row and tile adds into the output:
// integer adds commute, so the result is deterministic whatever the order
// of the blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;    // rows of q and rows of d per block
constexpr int KC = 32;      // depth chunk
constexpr int PITCH = KC + 4;

// Copy rows [row0, row0 + 64) x depth [k0, k0 + 32) of src [n_rows, dim]
// into the tile, zero beyond the edges. 512 float4, two a thread.
__device__ __forceinline__ void load_tile(float (*tile)[PITCH],
                                          const float* __restrict__ src,
                                          int64_t row0, int64_t n_rows,
                                          int k0, int dim) {
  for (int v = threadIdx.x; v < TILE * (KC / 4); v += blockDim.x) {
    const int r = v / (KC / 4), kq = (v % (KC / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && k0 + kq < dim) {
      x = *reinterpret_cast<const float4*>(src + (row0 + r) * dim + k0 + kq);
    }
    *reinterpret_cast<float4*>(&tile[r][kq]) = x;
  }
}

__global__ void __launch_bounds__(256)
rank_counts_kernel(const float* __restrict__ q, const float* __restrict__ d,
                   const float* __restrict__ true_score,
                   int32_t* __restrict__ counts, int64_t n, int64_t nd,
                   int dim) {
  __shared__ __align__(16) float qs[TILE][PITCH];
  __shared__ __align__(16) float ds[TILE][PITCH];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < dim; k0 += KC) {
    load_tile(qs, q, row0, n, k0, dim);
    load_tile(ds, d, col0, nd, k0, dim);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[ty * 4 + i][k]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&ds[tx + 16 * j][k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty * 4 + i;
    const float t = row < n ? true_score[row] : 0.f;
    int c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = col0 + tx + 16 * j;
      c += (row < n && col < nd && col != row && acc[i][j] > t) ? 1 : 0;
    }
    // The 16 threads of a row are 16 neighbouring lanes of one warp.
    c += __shfl_xor_sync(0xffffffffu, c, 8);
    c += __shfl_xor_sync(0xffffffffu, c, 4);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    if (tx == 0 && c > 0) atomicAdd(&counts[row], c);
  }
}

}  // namespace

// q: [n, dim] f32, d: [nd, dim] f32, true_score: [n] f32, counts: [n] int32
// (added into). dim a multiple of 4; q and d 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int dssm_rank_counts(const void* q, const void* d,
                                const void* true_score, void* counts,
                                long long n, long long nd, int dim,
                                void* stream) {
  if (n <= 0 || nd <= 0 || dim <= 0 || dim % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles_y = (n + TILE - 1) / TILE;
  const long long tiles_x = (nd + TILE - 1) / TILE;
  if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)tiles_x, (unsigned int)tiles_y);
  rank_counts_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)d, (const float*)true_score,
      (int32_t*)counts, (int64_t)n, (int64_t)nd, dim);
  return (int)cudaGetLastError();
}
