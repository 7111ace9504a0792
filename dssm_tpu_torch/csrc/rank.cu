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
// Design: the work is the grid of 128 x 128 tile pairs (q tile, doc tile),
// in q-tile-major order, cut into one contiguous range a block, with as
// many blocks as the card holds at once (SMs x blocks an SM). A block is
// then one wave's share of the pairs to within one pair, whatever the
// shape, and sweeps the doc tiles of one q tile, or of a few.
//   - q stays: the block's q tile (128 rows, the whole depth up to 320)
//     sits in shared memory k-major, transposed once as it is loaded, so one
//     16-byte read gives 4 rows at one k. It is reloaded only when the
//     block's range moves on to the next q tile. Deeper rows are walked in
//     passes of 320, each reloading its slice of q for each doc tile.
//   - d streams: chunks of 128 doc rows x 32 depth come through a 3-stage
//     cp.async ring, rows padded by 4 floats, so the next chunks' copies
//     overlap this chunk's products. The doc matrix is read from L2 once a
//     q tile: ~175 MB at 6553 x 6553, not the ~695 MB of 64 x 64 blocks.
//   - 256 threads in 8 warps of 32 x 64; a thread holds an 8 x 8 tile of
//     scores (rows wr*32 + ty*4 + {0..3} and +16, columns wc*64 + tx + 8j),
//     so a k step takes 2 + 2 16-byte shared reads for 64 FMAs, free of
//     bank conflicts (4 row groups broadcast; 8 doc rows on 8 bank quads):
//     a byte of shared memory an FMA, which an SM delivers at the rate of
//     its FMA pipes (128 B and 128 FMAs a clock), so the two share the time.
//     Products are exact f32 fmaf chains in increasing k from 0: the sums
//     of the earlier design of 64 x 64 blocks, bit for bit. At 6553^2 it
//     takes ~1.1x cuBLAS's f32 product alone. Slower, on the card: 16 x 8
//     tiles (255 registers), two blocks an SM (128 registers, spilling),
//     the doc chunks stored k-major (4-byte copies, XOR swizzle); float2
//     doc reads were no faster.
//   - counts stay in registers across the block's whole sweep of a q tile:
//     each score is compared with its row's true score (+inf for rows past
//     N, so they never count) as its doc tile completes; when the q tile is
//     done, a row's 8 lanes add by shuffles, the two column warps through
//     shared memory, and one int32 atomicAdd a row and block adds into the
//     output. Integer adds commute: the result is the same whatever the
//     order of the blocks.
// Zero padding past N, ND and D adds exact zeros (or nothing counts).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTile = 128;     // q rows and doc rows of a tile pair
constexpr int kTM = 8;         // rows a thread holds: two groups of 4
constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 32 x 64
constexpr int kKc = 32;        // depth of a ring stage
constexpr int kPitch = kKc + 4;
constexpr int kStages = 3;
constexpr int kStageFloats = kTile * kPitch;
constexpr int kMaxPassChunks = 10;  // q depth held at once: 320
constexpr size_t kMaxSmem =
    sizeof(float) * ((size_t)kMaxPassChunks * kKc * kTile +
                     (size_t)kStages * kStageFloats);

struct RankArgs {
  const float* q;
  const float* d;
  const float* true_score;
  int32_t* counts;
  int64_t n, nd;
  int64_t dtiles;  // doc tiles, the pairs' minor axis
  int64_t pairs;   // q tiles x doc tiles
  int dim;
  int chunks;       // ring chunks a tile pair: dim / kKc rounded up
  int pass_chunks;  // chunks a q pass holds
};

// Local row of the thread's score i (i < 8).
__device__ __forceinline__ int tile_row(int wr, int ty, int i) {
  return wr * 32 + (i >> 2) * 16 + ty * 4 + (i & 3);
}

// Depth chunk [k0, k0 + 32) of doc rows [col0, col0 + 128) into a ring
// stage: [128 doc rows][kPitch], zero past ND and dim (dim % 4 == 0, so a
// vector is all in or all out).
__device__ __forceinline__ void issue_chunk(const RankArgs& a, float* stage,
                                            int64_t col0, int k0) {
#pragma unroll
  for (int s = 0; s < kTile * (kKc / 4) / kThreads; ++s) {
    const int v = threadIdx.x + s * kThreads;
    const int r = v / (kKc / 4), kq = (v % (kKc / 4)) * 4;
    const bool valid = col0 + r < a.nd && k0 + kq < a.dim;
    const float* src = valid ? a.d + (col0 + r) * a.dim + k0 + kq : a.d;
    dssm::copy_vec<16>(stage + r * kPitch + kq, src, valid);
  }
}

// One step along a block's sequence of chunks: the next depth chunk, else
// the next doc tile's first; true when the doc tiles wrap (next q tile).
__device__ __forceinline__ bool next_chunk(const RankArgs& a, int& kc,
                                           int64_t& dt) {
  if (++kc < a.chunks) return false;
  kc = 0;
  if (++dt < a.dtiles) return false;
  dt = 0;
  return true;
}

// qs[k][r] = q[qt * 128 + r][k0 + k] for k < depth, zero past N and dim.
__device__ __forceinline__ void load_q(const RankArgs& a, float* qs,
                                       int64_t qt, int k0, int depth) {
  const int vecs = kTile * (depth / 4);
  for (int v0 = threadIdx.x; v0 < vecs; v0 += 4 * kThreads) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = v0 + u * kThreads;
      const int64_t row = qt * kTile + (v % kTile);
      const int k = k0 + (v / kTile) * 4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < vecs && row < a.n && k < a.dim) {
        x[u] = __ldg(reinterpret_cast<const float4*>(a.q + row * a.dim + k));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = v0 + u * kThreads;
      if (v < vecs) {
        float* dst = qs + (v / kTile) * 4 * kTile + v % kTile;
        dst[0] = x[u].x;
        dst[kTile] = x[u].y;
        dst[2 * kTile] = x[u].z;
        dst[3 * kTile] = x[u].w;
      }
    }
  }
}

// acc += the chunk's products: qs at the chunk's depth, ds a ring stage.
__device__ __forceinline__ void chunk_products(const float* __restrict__ qs,
                                               const float* __restrict__ ds,
                                               int wr, int wc, int ty, int tx,
                                               float (&acc)[kTM][8]) {
  const float* qa = qs + wr * 32 + ty * 4;
  const float* db = ds + (wc * 64 + tx) * kPitch;
#pragma unroll
  for (int k4 = 0; k4 < kKc; k4 += 4) {
    float4 b4[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b4[j] = *reinterpret_cast<const float4*>(db + j * 8 * kPitch + k4);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* qk = qa + (k4 + e) * kTile;
      const float4 a0 = *reinterpret_cast<const float4*>(qk);
      const float4 a1 = *reinterpret_cast<const float4*>(qk + 16);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bv[j] = e == 0 ? b4[j].x : e == 1 ? b4[j].y : e == 2 ? b4[j].z
                                                             : b4[j].w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

// cnt[i] += this doc tile's scores of row i above its true score t[i]:
// docs past ND and the self column do not count.
__device__ __forceinline__ void count_tile(const float (&acc)[kTM][8],
                                           const float (&t)[kTM], int (&cnt)[kTM],
                                           int64_t qt, int64_t dt, int64_t nd,
                                           int wr, int wc, int ty, int tx) {
  if (qt != dt && (dt + 1) * kTile <= nd) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) cnt[i] += acc[i][j] > t[i] ? 1 : 0;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = qt * kTile + tile_row(wr, ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = dt * kTile + wc * 64 + tx + 8 * j;
      cnt[i] += (acc[i][j] > t[i] && col < nd && col != row) ? 1 : 0;
    }
  }
}

// Adds the block's counts of q tile qt into the output, one atomicAdd a
// row; every thread of the block calls it.
__device__ __forceinline__ void flush_counts(const RankArgs& a, int64_t qt,
                                             int (&cnt)[kTM], int* s_cnt,
                                             int wr, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    int c = cnt[i];
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    c += __shfl_xor_sync(0xffffffffu, c, 4);
    if (tx == 0 && c > 0) atomicAdd(&s_cnt[tile_row(wr, ty, i)], c);
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int64_t row = qt * kTile + threadIdx.x;
    const int c = s_cnt[threadIdx.x];
    if (c > 0 && row < a.n) atomicAdd(a.counts + row, c);
    s_cnt[threadIdx.x] = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    rank_counts_kernel(RankArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_cnt[kTile];
  const int pass_depth = a.pass_chunks * kKc;
  float* qs = smem;
  float* ring = smem + (size_t)pass_depth * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 1, wc = warp & 1, ty = lane >> 3, tx = lane & 7;
  const int64_t p0 = (int64_t)blockIdx.x * a.pairs / gridDim.x;
  const int64_t p1 = (int64_t)(blockIdx.x + 1) * a.pairs / gridDim.x;
  const int64_t total = (p1 - p0) * a.chunks;
  if (threadIdx.x < kTile) s_cnt[threadIdx.x] = 0;
  // The consumer's place (q tile, doc tile, depth chunk, ring stage) and
  // the producer's, kStages - 1 chunks ahead.
  int64_t qt = p0 / a.dtiles, dt = p0 % a.dtiles;
  int kc = 0, stage = 0;
  int64_t issue_dt = dt;
  int issue_kc = 0, issue_stage = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      issue_chunk(a, ring + issue_stage * kStageFloats, issue_dt * kTile,
                  issue_kc * kKc);
      next_chunk(a, issue_kc, issue_dt);
      ++issue_stage;
    }
    dssm::cp_async_commit();
  }
  float acc[kTM][8];
  float t[kTM];
  int cnt[kTM];
  int64_t cur_qt = -1;
  int cur_pass = -1;
  for (int64_t c = 0; c < total; ++c) {
    const int pass = kc / a.pass_chunks;
    if (qt != cur_qt || pass != cur_pass) {  // the same in every thread
      if (qt != cur_qt && cur_qt >= 0) {
        flush_counts(a, cur_qt, cnt, s_cnt, wr, ty, tx);
      }
      __syncthreads();  // no thread reads the old q slice any more
      load_q(a, qs, qt, pass * pass_depth, pass_depth);
      if (qt != cur_qt) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int64_t row = qt * kTile + tile_row(wr, ty, i);
          t[i] = row < a.n ? a.true_score[row] : INFINITY;
          cnt[i] = 0;
        }
      }
      cur_qt = qt;
      cur_pass = pass;
    }
    dssm::cp_async_wait(kStages - 2);
    __syncthreads();  // chunk c and the q slice visible; chunk c - 1 read
    if (c + kStages - 1 < total) {
      issue_chunk(a, ring + issue_stage * kStageFloats, issue_dt * kTile,
                  issue_kc * kKc);
      next_chunk(a, issue_kc, issue_dt);
      issue_stage = issue_stage + 1 == kStages ? 0 : issue_stage + 1;
    }
    dssm::cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    chunk_products(qs + (size_t)(kc - pass * a.pass_chunks) * kKc * kTile,
                   ring + stage * kStageFloats, wr, wc, ty, tx, acc);
    if (kc == a.chunks - 1) {
      count_tile(acc, t, cnt, qt, dt, a.nd, wr, wc, ty, tx);
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (next_chunk(a, kc, dt)) ++qt;
  }
  if (cur_qt >= 0) flush_counts(a, cur_qt, cnt, s_cnt, wr, ty, tx);
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
  RankArgs a = {};
  a.q = (const float*)q;
  a.d = (const float*)d;
  a.true_score = (const float*)true_score;
  a.counts = (int32_t*)counts;
  a.n = n;
  a.nd = nd;
  a.dim = dim;
  a.chunks = (dim + kKc - 1) / kKc;
  a.pass_chunks = a.chunks < kMaxPassChunks ? a.chunks : kMaxPassChunks;
  a.dtiles = (nd + kTile - 1) / kTile;
  a.pairs = ((n + kTile - 1) / kTile) * a.dtiles;
  const size_t smem =
      sizeof(float) * ((size_t)a.pass_chunks * kKc * kTile +
                       (size_t)kStages * kStageFloats);
  // Raised once for each device this process launches on; the SM count
  // kept beside it.
  static int attr_device = -1, sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(rank_counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    attr_device = device;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rank_counts_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long blocks = a.pairs < slots ? a.pairs : slots;
  rank_counts_kernel<<<(unsigned int)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
