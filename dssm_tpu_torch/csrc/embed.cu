// Raw-index embedding bag: out[r, :] = sum_k wgt[r, k] * table[idx[r, k], :]
// and the gradient in the weights, d_wgt[r, k] = sum_h g[r, h] *
// table[idx[r, k], h].
//
// Replaces dssm_tpu/kernels/pallas_embed.py::embedding_bag_pallas (kernels
// _fwd_kernel and _bwd_kernel). A TPU slices device memory in aligned row
// groups, so that kernel DMAs the whole group around every looked-up row
// and picks the row out with a one-hot select matmul. None of that is
// needed here: a warp reads exactly the rows its lookups name, with 16-byte
// loads, and sums them in f32 registers.
//
// Semantics: the table is f32 or bf16, idx int32 and wgt f32 [rows, k],
// out f32. A lookup with weight 0 (hash padding, trigram.PAD_INDEX) is
// skipped without a read, and so is one whose index is outside [0, v): the
// wrapper raises on a live lookup outside the table before it launches.
// The forward sums the live lookups in k order. d_wgt is written for every
// lookup, padding included (its row is read; the reference's gradient has
// it too); a lookup whose index is outside [0, v) gets 0.
//
// Bound on the H100: bytes. At the cnn preset's raw batches (16384 word
// rows, Kw = 8, table [30000, 1024] f32) the forward reads idx + wgt (1 MB)
// and the few thousand distinct rows a batch names (~10 MB), and writes
// 64 MB: ~22 us at 3.35 TB/s. Every lookup re-reads its row (512 MB in
// all), which the 50 MB L2 serves; the 2 * nnz * H FLOPs (~0.2 GFLOP)
// are far below the f32 rate. At the `full` raw batch (1024 rows, K = 64,
// table [500000, 384]) ~1 us: the ~2,000 distinct rows a batch names come
// from device memory on first touch, but the ~33k lookups re-read ~51 MB
// of rows (f32) from L2, which holds the kernel near 8 us.
//
// Design, forward: the count lookup's body (csrc/lookup_fwd.cuh) with the
// table as its source, so that the bag and the count lookup are one kernel
// and give the same bits on the same inputs: a block a row, the live pairs
// compacted in k order by a ballot, a thread a 4-column vector (16 bytes
// of f32, 8 of bf16), 4 pairs loaded ahead, one fmaf chain a column in k
// order from 0 (bit-equal to the earlier design of a thread a 16-byte
// vector). Backward (d_wgt): one block per row; g's row is staged once in
// shared memory as f32, and each warp takes lookups k = warp, warp +
// warps, ...: a dot product over the row with 16-byte loads and a shuffle
// reduction. Both are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup_fwd.cuh"

namespace {

// 16 bytes of a table row as f32 values: 4 f32 or 8 bf16.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, typename G>
__global__ void embedding_bag_dwgt_kernel(const T* __restrict__ table,
                                          const int32_t* __restrict__ idx,
                                          const G* __restrict__ g,
                                          float* __restrict__ dwgt, int k,
                                          int v, int h) {
  constexpr int N = Vec<T>::kN;
  extern __shared__ float4 s_g4[];
  float* s_g = reinterpret_cast<float*>(s_g4);
  const int64_t r = blockIdx.x;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    s_g[c] = dssm::to_f32(g[r * h + c]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int vecs = h / N;
  for (int j = threadIdx.x >> 5; j < k; j += warps) {
    const int32_t row = idx[r * k + j];
    float acc = 0.f;
    if (row >= 0 && row < v) {
      const T* src = table + (int64_t)row * h;
      for (int c = lane; c < vecs; c += 32) {
        float x[N];
        Vec<T>::load(src + (int64_t)c * N, x);
        // g's matching columns as 16-byte shared loads (no bank conflict).
        const float4* gv = reinterpret_cast<const float4*>(s_g + c * N);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const float4 q = gv[i];
          acc = fmaf(x[4 * i], q.x, acc);
          acc = fmaf(x[4 * i + 1], q.y, acc);
          acc = fmaf(x[4 * i + 2], q.z, acc);
          acc = fmaf(x[4 * i + 3], q.w, acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) dwgt[r * k + j] = acc;
  }
}

int vec_width(int dtype) { return dtype == 0 ? 4 : 8; }

}  // namespace

// table: [v, h] (dtype 0 = f32, 1 = bf16), 16-byte aligned, h a multiple
// of 4 (f32) or 8 (bf16); idx: [rows, k] int32; wgt: [rows, k] f32; out:
// [rows, h] f32. Returns cudaGetLastError().
extern "C" int dssm_embedding_bag(const void* table, const void* idx,
                                  const void* wgt, void* out, long long rows,
                                  int k, int v, int h, int dtype,
                                  void* stream) {
  if ((dtype != 0 && dtype != 1) || h <= 0 || h % vec_width(dtype) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return dssm::lookup_fwd(table, idx, wgt, out, rows, k, v, h, dtype, stream);
}

// table as dssm_embedding_bag; idx: [rows, k] int32; g: [rows, h]
// (g_dtype 0 = f32, 1 = bf16); dwgt: [rows, k] f32. Returns
// cudaGetLastError().
extern "C" int dssm_embedding_bag_dwgt(const void* table, const void* idx,
                                       const void* g, void* dwgt,
                                       long long rows, int k, int v, int h,
                                       int dtype, int g_dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || k <= 0 || v <= 0 || h <= 0 ||
      (dtype != 0 && dtype != 1) || (g_dtype != 0 && g_dtype != 1) ||
      h % vec_width(dtype) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)h;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // One warp per lookup, up to 8 warps a block.
  const int threads = 32 * (k < 8 ? k : 8);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int blocks = (unsigned int)rows;
  if (dtype == 0 && g_dtype == 0) {
    embedding_bag_dwgt_kernel<float, float><<<blocks, threads, smem, s>>>(
        (const float*)table, (const int32_t*)idx, (const float*)g,
        (float*)dwgt, k, v, h);
  } else if (dtype == 0) {
    embedding_bag_dwgt_kernel<float, __nv_bfloat16>
        <<<blocks, threads, smem, s>>>((const float*)table,
                                       (const int32_t*)idx,
                                       (const __nv_bfloat16*)g, (float*)dwgt,
                                       k, v, h);
  } else if (g_dtype == 0) {
    embedding_bag_dwgt_kernel<__nv_bfloat16, float>
        <<<blocks, threads, smem, s>>>((const __nv_bfloat16*)table,
                                       (const int32_t*)idx, (const float*)g,
                                       (float*)dwgt, k, v, h);
  } else {
    embedding_bag_dwgt_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<blocks, threads, smem, s>>>((const __nv_bfloat16*)table,
                                       (const int32_t*)idx,
                                       (const __nv_bfloat16*)g, (float*)dwgt,
                                       k, v, h);
  }
  return (int)cudaGetLastError();
}
