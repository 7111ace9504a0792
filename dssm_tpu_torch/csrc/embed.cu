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
// entry points refuse a live lookup outside the table on the host, before
// its batch is moved (bridge.check_raw_rows), so the kernel reads nothing
// back.
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
// of rows (f32) from L2, which holds the kernel near 8 us. d_wgt moves
// about the same bytes the other way: it reads an [rows, H] g where the
// forward writes an [rows, H] output, and the distinct rows each chunk of
// lookups names (padding included: PAD_INDEX 0 at weight 0 is a lookup of
// row 0 whose gradient the reference has) from L2. The forward's time at a
// shape is its yardstick, though every raw batch's padding makes d_wgt
// resolve 4x the forward's live lookups at the cnn shape (131k against
// 32k).
//
// Design, forward: the count lookup's body (csrc/lookup_fwd.cuh) with the
// table as its source, so that the bag and the count lookup are one kernel
// and give the same bits on the same inputs: a block a row, the live pairs
// compacted in k order by a ballot, a thread a 4-column vector (16 bytes
// of f32, 8 of bf16), 4 pairs loaded ahead, one fmaf chain a column in k
// order from 0 (bit-equal to the earlier design of a thread a 16-byte
// vector). Backward (d_wgt): a block a (row, chunk of kDwgtChunk lookups),
// of the fewest whole warps that give each 4-column vector of the row a
// thread (at most 256; wider rows loop). The first warp resolves the
// chunk's distinct live rows with one ballot and one match (a row's
// padding lookups name row 0 once); a thread holds its columns of g in
// registers (read once, streaming), loads its vector of kDwgtAhead
// distinct rows before their FMAs and keeps a partial a distinct row; a
// transposed butterfly sums the chunk's partials over the warp (9 shuffles
// for 8, not 40), the block sums its warps in warp order through shared
// memory, and each lookup takes its row's sum. No atomics: both are
// deterministic.
// Measured on the card (tools/eval_kernels.py --cases lookup, PERF.md)
// and slower: the design it replaced (a block a row, a warp a lookup, one
// 16-byte load in flight a lane); every lookup of the chunk loaded before
// any FMA, with no dedupe (the padding's row 0 read once a lookup); a
// block a row looping over its chunks; chunks of 4 or 16 lookups; 4 or 8
// distinct rows ahead; 5 or 6 blocks an SM; a persistent grid that loads
// the next chunk's lookups and g while it works on this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup_fwd.cuh"

namespace {

constexpr int kDwgtMaxThreads = 256;
constexpr int kDwgtChunk = 8;  // lookups a block resolves
constexpr int kDwgtAhead = 2;  // distinct rows a thread loads ahead

// Four columns of g's row as f32, read once (a streaming load).
__device__ __forceinline__ float4 load_g4(const float* g) {
  return __ldcs(reinterpret_cast<const float4*>(g));
}
__device__ __forceinline__ float4 load_g4(const __nv_bfloat16* g) {
  const uint2 w = __ldcs(reinterpret_cast<const uint2*>(g));
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// The warp's sums of N partials a lane (N a power of two, at most 32), as
// a transposed butterfly: at each level a lane keeps half of its partials
// and sends the other half to the lane OFF apart, so N = 8 takes 4 + 2 + 1
// shuffles and then 2 more over the lanes that hold one partial. After it,
// p[0] of lane l is the sum of partial l / (32 / N) over the 32 lanes; the
// lanes that hold one partial hold the same bits.
template <int N, int OFF>
__device__ __forceinline__ void warp_sums(float* p, int lane) {
  if constexpr (N > 1) {
    constexpr int kHalf = N / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? p[i] : p[i + kHalf];
      const float keep = upper ? p[i + kHalf] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    warp_sums<kHalf, OFF / 2>(p, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1) {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
    }
  }
}

struct DwgtArgs {
  const void* table;
  const int32_t* idx;
  const void* g;
  float* dwgt;
  int k, v, h;
  int nvec;    // 4-column vectors a row
  int chunks;  // of kDwgtChunk lookups a row
};

// A block takes one chunk of kDwgtChunk lookups of one row, a thread a
// 4-column vector of the row (wider rows loop) with its g columns in
// registers. The first warp resolves the chunk: the distinct rows its live
// lookups name, in order of first use, to s_row (the padding lookups of a
// row, all PAD_INDEX 0, name one), and for each lookup the index of its
// row there, or -1 (s_map). A thread then loads its vector of the next
// kDwgtAhead distinct rows before their FMAs, one partial a distinct row;
// the warp sums the partials by the transposed butterfly, the block over
// its warps in warp order through shared memory, and each lookup takes its
// row's sum. No atomics: two calls give the same bits. Eight blocks an SM
// (32 registers, 4-12 bytes spilled): each step up from the 5 that 44
// registers gave was faster (PERF.md).
template <typename T, typename G>
__global__ void __launch_bounds__(kDwgtMaxThreads, 8)
    embedding_bag_dwgt_kernel(DwgtArgs a) {
  constexpr int C = kDwgtChunk;
  constexpr int kSpread = 32 / C;  // lanes that hold one partial at the end
  using R = typename dssm::Raw<T, 4>::type;
  __shared__ float s_part[kDwgtMaxThreads / 32][C];
  __shared__ int32_t s_row[C];
  __shared__ int s_map[C];
  __shared__ int s_n;
  const int64_t r = blockIdx.x / a.chunks;
  const int kb = (int)(blockIdx.x - r * a.chunks) * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const T* table = static_cast<const T*>(a.table);
  const G* g = static_cast<const G*>(a.g) + r * a.h;
  const bool one_pass = a.nvec <= (int)blockDim.x;
  float4 g1 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (one_pass && (int)threadIdx.x < a.nvec) {
    g1 = load_g4(g + (int64_t)threadIdx.x * 4);
  }
  if (warp == 0) {
    const bool mine = lane < C && kb + lane < a.k;
    const int32_t rw = mine ? __ldg(a.idx + r * a.k + kb + lane) : -1;
    const bool live = mine && rw >= 0 && rw < a.v;  // else 0, nothing read
    const unsigned int lives = __ballot_sync(0xffffffffu, live);
    // The first live lookup of the chunk that names this lane's row.
    const int lead = __ffs(__match_any_sync(0xffffffffu, rw) & lives) - 1;
    const unsigned int leads = __ballot_sync(0xffffffffu, live && lead == lane);
    const int m = live ? __popc(leads & ((1u << lead) - 1u)) : -1;
    if (live && lead == lane) s_row[m] = rw;
    if (lane < C) s_map[lane] = m;
    if (lane == 0) s_n = __popc(leads);
  }
  __syncthreads();
  const int n = s_n;
  float p[C];
#pragma unroll
  for (int u = 0; u < C; ++u) p[u] = 0.f;
  for (int c = threadIdx.x; c < a.nvec; c += blockDim.x) {
    const float4 gq = one_pass ? g1 : load_g4(g + (int64_t)c * 4);
#pragma unroll
    for (int i = 0; i < C; i += kDwgtAhead) {
      if (i >= n) break;  // the same on every thread
      R x[kDwgtAhead];
#pragma unroll
      for (int u = 0; u < kDwgtAhead; ++u) {
        x[u] = R{};
        if (i + u < n) {
          x[u] = dssm::load_vec<T, 4>(
              table, (int64_t)s_row[i + u] * a.h + (int64_t)c * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kDwgtAhead; ++u) {
        float f[4];
        dssm::to_floats(x[u], f);
        p[i + u] = fmaf(f[0], gq.x, p[i + u]);
        p[i + u] = fmaf(f[1], gq.y, p[i + u]);
        p[i + u] = fmaf(f[2], gq.z, p[i + u]);
        p[i + u] = fmaf(f[3], gq.w, p[i + u]);
      }
    }
  }
  warp_sums<C, 16>(p, lane);
  if (warps == 1) {
    // Lookup j's sum is distinct row s_map[j]'s, which lanes s_map[j] *
    // kSpread on hold.
    const int j = lane / kSpread;
    const int m = s_map[j];
    const float sum = __shfl_sync(0xffffffffu, p[0], max(m, 0) * kSpread);
    if (lane % kSpread == 0 && kb + j < a.k) {
      a.dwgt[r * a.k + kb + j] = m < 0 ? 0.f : sum;
    }
    return;
  }
  if (lane % kSpread == 0) s_part[warp][lane / kSpread] = p[0];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < C && kb + t < a.k) {
    const int m = s_map[t];
    float sum = 0.f;
    if (m >= 0) {
      sum = s_part[0][m];
      for (int w = 1; w < warps; ++w) sum += s_part[w][m];
    }
    a.dwgt[r * a.k + kb + t] = sum;
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
// (g_dtype 0 = f32, 1 = bf16), 16-byte aligned; dwgt: [rows, k] f32.
// Returns cudaGetLastError().
extern "C" int dssm_embedding_bag_dwgt(const void* table, const void* idx,
                                       const void* g, void* dwgt,
                                       long long rows, int k, int v, int h,
                                       int dtype, int g_dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || k <= 0 || v <= 0 || h <= 0 ||
      (dtype != 0 && dtype != 1) || (g_dtype != 0 && g_dtype != 1) ||
      h % vec_width(dtype) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  DwgtArgs a = {};
  a.table = table;
  a.idx = (const int32_t*)idx;
  a.g = g;
  a.dwgt = (float*)dwgt;
  a.k = k;
  a.v = v;
  a.h = h;
  a.nvec = h / 4;
  a.chunks = (k + kDwgtChunk - 1) / kDwgtChunk;
  if (rows * a.chunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int threads = (a.nvec + 31) / 32 * 32;
  if (threads > kDwgtMaxThreads) threads = kDwgtMaxThreads;
  const unsigned int blocks = (unsigned int)(rows * a.chunks);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && g_dtype == 0) {
    embedding_bag_dwgt_kernel<float, float><<<blocks, threads, 0, s>>>(a);
  } else if (dtype == 0) {
    embedding_bag_dwgt_kernel<float, __nv_bfloat16>
        <<<blocks, threads, 0, s>>>(a);
  } else if (g_dtype == 0) {
    embedding_bag_dwgt_kernel<__nv_bfloat16, float>
        <<<blocks, threads, 0, s>>>(a);
  } else {
    embedding_bag_dwgt_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<blocks, threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
