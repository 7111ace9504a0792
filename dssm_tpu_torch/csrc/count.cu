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
// are ~50 MFLOP. The ~33k live lookups re-read ~25 MB of compact2 rows,
// which the L2 cache serves. At the cnn eval shape (16384 word rows, K=8,
// H=1024) the 64 MB of outputs bound it.
//
// Forward design: blocks of 8 warps, one warp per lookup row (the rows of a
// call with fewer than 4096 rows, such as `full`'s 1024, are split over
// 2-3 warps by column range, so that more loads are in flight). Each warp
// resolves up to 128 of the row's k in one pass, every inv and wgt load in
// flight at once, and a ballot compacts the live pairs in k order into the
// warp's own shared memory (no block barrier). A lane then owns 16-byte
// column vectors (4 f32 or 8 bf16 columns; `full` bf16: 1 a lane in each of
// 2 warps, f32: 1 in each of 3; cnn bf16: 4; lstm bf16: 2) and loads them
// for the next U live pairs before their FMAs, 8 vectors in flight a lane
// (U = 8 / VPL: as fast as 16 at `full` and cnn, faster at lstm, where the
// registers of 16 cost occupancy). An h that is not a whole number of
// vectors, or a compact2 or output that is not 16-byte aligned, takes the
// same loop one column at a time, a warp a row. Outputs are written with
// streaming stores: at the cnn shape they are the largest stream, read once
// by the tower (faster there than plain stores; the same at `full`).
// Sum order: each column is one fmaf chain over the live pairs in k order
// from 0, as joint.cu's lookups sum: the output is bit-equal to the joint
// lookup through sel = arange(u2), and to the earlier design of a block a
// row and a thread a column.
//
// Backward: d_compact2[u, :] = sum over the live lookups with inv == u of
// wgt * g[row, :], f32, g f32 or bf16; every row of d_compact2 written (0
// where no live lookup names it), with no float atomics: two calls give the
// same bits. It is joint.cu's backward taken as one side with no row
// selection (segsum.cuh): a stable counting sort of the live lookups by
// compact row (rank, scan and place kernels), then a segmented sum, a warp
// a piece of at most 32 lookups in flat order, a row's pieces added in
// order. Four kernels in one call, the last three with programmatic
// dependent launch.
// Bound on the H100: bytes. At `full` (d side, f32 g) inv + wgt (0.5 MB),
// g (1.6 MB) and d_compact2 (1.6 MB) once: ~1.1 us at 3.35 TB/s (bf16 g:
// 0.9 us). The segmented sum re-reads one g row a live lookup (~33k rows:
// 50 MB f32, 25 MB bf16) from L2, a floor of several microseconds at the
// L2's rate, and the four kernels' dependent global round trips come one
// after another: on these shapes it is slower than the one-kernel f32
// atomics it replaced, which have no such chain.
// Scratch (keys, ranks, counts, the sorted lists, descriptors, partials)
// comes from the caller, sized by dssm_count_lookup_bwd_workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"
#include "segsum.cuh"

namespace {

constexpr unsigned int kFull = 0xffffffffu;
constexpr int kWarps = 8;  // lookup rows a forward block
constexpr int kThreads = 32 * kWarps;
constexpr int kCap = 128;  // k a warp resolves in one pass

// Warps a launch aims for: with fewer rows than this, each row's vectors
// are split over up to one warp per 32 of them.
constexpr long long kTargetWarps = 4096;
constexpr int kLoads = 8;  // 16-byte loads in flight a lane

struct FwdArgs {
  const void* compact2;
  const int32_t* inv;
  const float* wgt;
  float* out;
  int64_t rows;
  int k, u2, h;
  int nvec;   // vectors (or columns, one at a time) a row
  int split;  // warps a row
  int per;    // vectors a warp: nvec / split rounded up
};

// One warp: the live pairs among k in [kb, kend) (at most kCap), in k order,
// to s_row and s_wgt; returns their count.
__device__ __forceinline__ int resolve_pairs(const int32_t* __restrict__ inv,
                                             const float* __restrict__ wgt,
                                             int kb, int kend, int u2,
                                             int32_t* s_row, float* s_wgt) {
  constexpr int kSub = kCap / 32;
  const int lane = threadIdx.x & 31;
  int32_t u[kSub];
  float w[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int kk = kb + s * 32 + lane;
    u[s] = -1;
    w[s] = 0.f;
    if (kk < kend) {
      u[s] = __ldg(inv + kk);
      w[s] = __ldg(wgt + kk);
    }
  }
  __syncwarp();  // the warp is done reading the previous pass's pairs
  int n = 0;
  const unsigned int lt = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const bool keep = w[s] != 0.f && u[s] >= 0 && u[s] < u2;
    const unsigned int mask = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = n + __popc(mask & lt);
      s_row[pos] = u[s];
      s_wgt[pos] = w[s];
    }
    n += __popc(mask);
  }
  __syncwarp();
  return n;
}

template <typename T, int VEC, int VPL, int U>
__global__ void __launch_bounds__(kThreads)
    count_lookup_kernel(FwdArgs a) {
  using R = typename dssm::Raw<T, VEC>::type;
  __shared__ int32_t s_rows[kWarps][kCap];
  __shared__ float s_wgts[kWarps][kCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wi = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t r = wi / a.split;
  if (r >= a.rows) return;
  const int vb = (int)(wi - r * a.split) * a.per;
  const int ve = min(a.nvec, vb + a.per);
  const int32_t* inv = a.inv + r * a.k;
  const float* wgt = a.wgt + r * a.k;
  float* out = a.out + r * a.h;
  const T* src = static_cast<const T*>(a.compact2);
  int32_t* s_row = s_rows[warp];
  float* s_wgt = s_wgts[warp];
  int n = 0;
  for (int v0 = vb; v0 < ve; v0 += 32 * VPL) {
    float acc[VPL][VEC];
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = 0.f;
    }
    for (int kb = 0; kb < a.k; kb += kCap) {
      if (v0 == vb || a.k > kCap) {
        n = resolve_pairs(inv, wgt, kb, min(a.k, kb + kCap), a.u2, s_row,
                          s_wgt);
      }
      for (int i = 0; i < n; i += U) {
        R x[U][VPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool live = i + u < n;
          const int32_t row = live ? s_row[i + u] : 0;
#pragma unroll
          for (int q = 0; q < VPL; ++q) {
            const int v = v0 + lane + 32 * q;
            x[u][q] = R{};
            if (live && v < ve) {
              x[u][q] = dssm::load_vec<T, VEC>(
                  src, (int64_t)row * a.h + (int64_t)v * VEC);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i + u < n) {
            const float w = s_wgt[i + u];
#pragma unroll
            for (int q = 0; q < VPL; ++q) {
              float f[VEC];
              dssm::to_floats(x[u][q], f);
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[q][e] = fmaf(w, f[e], acc[q][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int v = v0 + lane + 32 * q;
      if (v < ve) dssm::store_floats<VEC, true>(out + (int64_t)v * VEC, acc[q]);
    }
  }
}

// U = kLoads / VPL live pairs loaded ahead, VPL vectors each.
template <typename T, int VEC>
void launch_fwd_vpl(const FwdArgs& a, unsigned int blocks, int vpl,
                    cudaStream_t s) {
  switch (vpl) {
    case 1:
      count_lookup_kernel<T, VEC, 1, kLoads><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 2:
      count_lookup_kernel<T, VEC, 2, kLoads / 2><<<blocks, kThreads, 0, s>>>(
          a);
      break;
    case 3:
      count_lookup_kernel<T, VEC, 3, 3><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 4:
      count_lookup_kernel<T, VEC, 4, kLoads / 4><<<blocks, kThreads, 0, s>>>(
          a);
      break;
    default:
      count_lookup_kernel<T, VEC, 8, 1><<<blocks, kThreads, 0, s>>>(a);
  }
}

// Rows of a launch's warps: one warp a row, or, when there are fewer rows
// than kTargetWarps, each row's vectors split over up to one warp per 32.
template <typename T>
int launch_fwd(FwdArgs a, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = ((size_t)a.h * sizeof(T)) % 16 == 0 &&
                   dssm::aligned16(a.compact2) && dssm::aligned16(a.out);
  a.nvec = vec ? a.h / kVec : a.h;
  const long long most = vec ? (a.nvec + 31) / 32 : 1;
  const long long want = (kTargetWarps + a.rows - 1) / a.rows;
  a.split = (int)(want < most ? want : most);
  a.per = (a.nvec + a.split - 1) / a.split;
  const long long blocks = (a.rows * a.split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (!vec) {
    count_lookup_kernel<T, 1, 4, 4><<<(unsigned int)blocks, kThreads, 0, s>>>(
        a);
  } else {
    launch_fwd_vpl<T, kVec>(a, (unsigned int)blocks,
                            dssm::lane_vectors(a.per), s);
  }
  return (int)cudaGetLastError();
}


}  // namespace

// compact2: [u2, h] (dtype 0 = f32, 1 = bf16), inv: [rows, k] int32,
// wgt: [rows, k] f32, out: [rows, h] f32. Returns cudaGetLastError().
extern "C" int dssm_count_lookup(const void* compact2, const void* inv,
                                 const void* wgt, void* out, long long rows,
                                 int k, int u2, int h, int dtype,
                                 void* stream) {
  if (rows <= 0 || k <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.compact2 = compact2;
  a.inv = (const int32_t*)inv;
  a.wgt = (const float*)wgt;
  a.out = (float*)out;
  a.rows = rows;
  a.k = k;
  a.u2 = u2;
  a.h = h;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(a, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of scratch dssm_count_lookup_bwd needs for these shapes; -1 for
// shapes it does not take.
extern "C" long long dssm_count_lookup_bwd_workspace(long long rows, int k,
                                                     int u2, int h) {
  dssm::BwdLayout l;
  return dssm::bwd_layout(rows, k, 0, u2, h, &l) ? 4 * l.words : -1;
}

// inv, wgt: [rows, k]; g: [rows, h] (g_dtype 0 = f32, 1 = bf16); dc2:
// [u2, h] f32, every row written (the caller does not fill it); work:
// 16-byte aligned scratch of work_bytes >=
// dssm_count_lookup_bwd_workspace(...). Four kernels on the stream
// (segsum.cuh). Returns the first CUDA error.
extern "C" int dssm_count_lookup_bwd(const void* inv, const void* wgt,
                                     const void* g, void* dc2, void* work,
                                     long long work_bytes, long long rows,
                                     int k, int u2, int h, int g_dtype,
                                     void* stream) {
  dssm::BwdLayout l;
  if (!dssm::bwd_layout(rows, k, 0, u2, h, &l) || work_bytes < 4 * l.words ||
      !dssm::aligned16(work) || (g_dtype != 0 && g_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  dssm::BwdArgs a = {};
  a.inv[0] = (const int32_t*)inv;
  a.wgt[0] = (const float*)wgt;
  a.k[0] = k;
  a.g[0] = g;
  a.g[1] = g;
  a.dc = (float*)dc2;
  a.rows = (int)rows;
  a.u2 = u2;
  a.gr = u2;
  a.h = h;
  return dssm::lookup_bwd(a, l, work, g_dtype, (cudaStream_t)stream);
}
