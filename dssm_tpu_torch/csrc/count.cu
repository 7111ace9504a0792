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
// Forward design: csrc/lookup_fwd.cuh, the body embed.cu's bag forward
// launches too, with compact2 as its source: a block a lookup row, the
// live pairs compacted in k order by a ballot, a thread a 4-column vector,
// 4 pairs loaded ahead, streaming stores. Each column is one fmaf chain
// over the live pairs in k order from 0: the output is bit-equal to the
// joint lookup through sel = arange(u2), and to the earlier designs (a
// block a row and a thread a column; a warp a row).
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

#include "lookup_fwd.cuh"
#include "segsum.cuh"

// compact2: [u2, h] (dtype 0 = f32, 1 = bf16), inv: [rows, k] int32,
// wgt: [rows, k] f32, out: [rows, h] f32. Returns cudaGetLastError().
extern "C" int dssm_count_lookup(const void* compact2, const void* inv,
                                 const void* wgt, void* out, long long rows,
                                 int k, int u2, int h, int dtype,
                                 void* stream) {
  return dssm::lookup_fwd(compact2, inv, wgt, out, rows, k, u2, h, dtype,
                          stream);
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
