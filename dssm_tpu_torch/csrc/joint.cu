// Joint lookup: both towers' lookups from one compact block through one row
// selection,
//   q_out[r, :] = sum_k q_wgt[r, k] * compact[sel[q_inv[r, k]], :]
//   d_out[r, :] = sum_k d_wgt[r, k] * compact[sel[d_inv[r, k]], :]
// and its backward,
//   d_compact[j, :] = sum over live (side, r, k) with sel[inv[r, k]] == j
//                     of wgt[r, k] * g_side[r, :].
//
// Replaces dssm_tpu/kernels/pallas_count.py::joint_lookup_pallas (kernels
// _joint_fwd_kernel and _joint_bwd_kernel). On the TPU the selection is a
// one-hot matmul, the lookups are count-matrix matmuls, and the forward
// writes both count matrices as residuals for the backward. Here the
// forward reads compact[sel[inv]] directly and the backward rebuilds
// nothing: it needs only sel, inv, wgt and g. No compact2, no count matrix
// and no residual reaches device memory.
//
// Semantics: arithmetic in f32 whatever the compact dtype (f32 or bf16), as
// the TPU kernel computes in compact's dtype with f32 accumulation; outputs
// f32. A lookup is dead when its weight is 0, its slot is outside [0, u2)
// or sel[slot] is outside [0, gr). `sel` is padded with 0, so several slots
// may name compact row 0: the backward ADDS through sel, and padding slots
// are named by no live lookup. Offsets into the tables are 64-bit.
//
// The lookups (dssm_joint_lookup, the int8 table's split path, and the
// lookup blocks of the fused kernel below) share one warp body: blocks of 8
// warps, a warp per (side, lookup row). Each lane resolves up to 4 of the
// row's k in one pass, every load of a stage in flight at once: inv and
// wgt, then sel (and, in the fused kernel, uniq, giving the TABLE row
// uniq[j / group] * group + j % group of compact row j, -1 for an empty
// slot). A ballot compacts the live pairs in k order into the warp's shared
// memory (no block barrier). A lane then owns 16-byte column vectors (4 f32
// or 8 bf16 columns) and loads them for the next U live pairs before their
// FMAs, U x VPL vectors in flight a lane. h that is not a whole number of
// vectors, or a source or output that is not 16-byte aligned, takes the
// same loop one column at a time. Outputs are written with 16-byte
// streaming stores (st.global.cs): at the cnn shapes they are the largest
// stream and are read once, by the tower.
//   - dssm_joint_lookup splits a row's vectors over 2-3 warps when a call
//     has fewer than 4096 (side, row) pairs, as count.cu's forward does
//     (`full`: 1024 rows a side, 2 warps a row: f32 2 vectors a lane, bf16
//     1), with 8 vectors in flight a lane (U = 8 / VPL).
//   - dssm_fused_gather_joint_lookup (replaces dssm_tpu/kernels/
//     pallas_count.py::fused_gather_joint_lookup, kernel
//     _fused_gather_joint_kernel): on the TPU, program 0 starts every row
//     group's table -> compact DMA from the scalar unit, selects compact2
//     with a one-hot matmul once they land, and every program builds count
//     tiles for the MXU. Here one launch holds two kinds of block that
//     nothing orders: slot blocks copy each real row group of the table
//     into compact with 16-byte vectors, 8 in flight a thread, and zero the
//     rows of empty slots (the gather's semantics); lookup blocks read the
//     table rows directly, a warp a whole row (U = 16 / VPL).
// Sum order: each column's sum is one fmaf chain over the live pairs in k
// order from 0, and a pair whose slot is empty adds its zero term, as the
// lookup over the gathered compact block does; so the fused kernel's
// outputs and compact are bit-equal to gather_row_groups followed by
// joint_lookup, and joint_lookup through sel = arange(u2) is bit-equal to
// count.cu's forward.
// Bound on the H100: bytes. At `full` (1024 rows, K = 32 / 64) the joint
// lookup reads inv + wgt + sel (0.8 MB) and the touched compact rows, and
// writes 3.1 MB of outputs: ~1.5 us at 3.35 TB/s; the ~52k live lookups
// re-read ~80 MB of f32 compact rows (40 MB bf16) from L2, which with the
// resolve stage's dependent loads bounds it. The fused kernel adds the real
// groups (~1.3 MB) and compact (3.1 MB written): ~2.5 us. At the cnn shapes
// the 134 MB of outputs bound them (~42 and 58 us).
//
// The backward (dssm_joint_lookup_bwd) is segsum.cuh's stable counting sort
// of the live lookups by compact row and segmented sum, both sides through
// sel: four kernels, no float atomics, the same bits from every call.
// Bound on the H100: bytes. At `full` g (bf16, 1.6 MB), inv + wgt + sel
// (0.8 MB) and dc (3.1 MB) once: 1.6 us; the ~52k live lookups re-read
// 40 MB of g rows from L2, and the four kernels run one after another. At
// the cnn shapes the 32 MB of dc, mostly zero rows, and the g rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"
#include "segsum.cuh"

namespace {

constexpr unsigned int kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block (lookup rows)
constexpr int kThreads = 32 * kWarps;
constexpr int kCap = 128;  // k a lookup warp resolves in one pass
constexpr int kCopyUnroll = 8;     // 16-byte copies in flight a thread
// (side, row) warps a joint lookup launch aims for: with fewer rows than
// this, each row's vectors are split over up to one warp per 32 of them.
constexpr long long kTargetWarps = 4096;
constexpr int kLoads = 8;          // joint lookup: 16-byte loads in flight

// ---- the lookups: the joint lookup, and the fused gather + joint lookup --

struct LookupArgs {
  const void* src;  // the compact block, or (fused) the table
  const int32_t* uniq;  // fused: the slots' group ids
  const int32_t* sel;
  const int32_t* inv[2];
  const float* wgt[2];
  int k[2];
  float* out[2];
  int4* compact;  // fused: the gathered block
  int64_t num_groups;
  int64_t copy_vecs;  // fused: 16-byte vectors in a row group
  int rows, u2, gr, num_slots, group, h;
  int nvec;   // vectors (or columns, one at a time) a row
  int split;  // warps a (side, row)
  int per;    // vectors a warp: nvec / split rounded up
  int row_blocks;  // fused: blocks of lookup rows; the slot blocks follow
};

// Slot block: compact's row group `slot` = the table's group uniq[slot], or
// zeros for an empty slot (the id is tested before any address is formed).
__device__ __forceinline__ void copy_slot(const LookupArgs& a, int slot) {
  const int64_t gid = a.uniq[slot];
  const bool real = gid >= 0 && gid < a.num_groups;
  const int64_t vecs = a.copy_vecs;
  const int4* src = reinterpret_cast<const int4*>(a.src) + (real ? gid * vecs : 0);
  int4* dst = a.compact + (int64_t)slot * vecs;
  for (int64_t i0 = threadIdx.x; i0 < vecs; i0 += kThreads * kCopyUnroll) {
    int4 x[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      x[u] = make_int4(0, 0, 0, 0);
      if (real && i < vecs) x[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      if (i < vecs) dst[i] = x[u];
    }
  }
}

// One warp: the live pairs among k in [kb, kend) (at most kCap), in k order,
// to s_row and s_wgt; returns their count. s_row is the compact row j, or
// with kGather the table row of compact row j (-1 for an empty slot).
template <bool kGather>
__device__ __forceinline__ int resolve_pairs(const LookupArgs& a,
                                             const int32_t* inv,
                                             const float* wgt, int kb,
                                             int kend, int32_t* s_row,
                                             float* s_wgt) {
  constexpr int kSub = kCap / 32;
  const int lane = threadIdx.x & 31;
  int u[kSub], j[kSub];
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
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    j[s] = -1;
    if (w[s] != 0.f && u[s] >= 0 && u[s] < a.u2) {
      const int32_t jj = __ldg(a.sel + u[s]);
      if (jj >= 0 && jj < a.gr) j[s] = jj;
    }
  }
  int32_t row[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    row[s] = j[s];
    if (kGather && j[s] >= 0) {
      row[s] = -1;
      const int64_t gid = __ldg(a.uniq + j[s] / a.group);
      if (gid >= 0 && gid < a.num_groups) {
        row[s] = (int32_t)(gid * a.group + j[s] % a.group);
      }
    }
  }
  __syncwarp();  // the warp is done reading the previous pass's pairs
  int n = 0;
  const unsigned int lt = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const bool keep = j[s] >= 0;
    const unsigned int mask = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = n + __popc(mask & lt);
      s_row[pos] = row[s];
      s_wgt[pos] = w[s];
    }
    n += __popc(mask);
  }
  __syncwarp();
  return n;
}

// Warp wi of the launch: vectors [vb, ve) of (side, row) wi / split, from
// the source rows its live pairs resolve to (kGather: table rows).
template <typename T, int VEC, int VPL, int U, bool kGather>
__device__ __forceinline__ void lookup_warp(const LookupArgs& a, int64_t wi,
                                            int32_t* s_row, float* s_wgt) {
  using R = typename dssm::Raw<T, VEC>::type;
  const int lane = threadIdx.x & 31;
  const int64_t sr = wi / a.split;
  if (sr >= 2 * (int64_t)a.rows) return;
  const int side = sr >= a.rows ? 1 : 0;
  const int64_t r = sr - (int64_t)side * a.rows;
  const int vb = (int)(wi - sr * a.split) * a.per;
  const int ve = min(a.nvec, vb + a.per);
  // Parameters picked by selects, not indexed: an index would copy them to
  // the stack.
  const int k = side ? a.k[1] : a.k[0];
  const int32_t* inv = (side ? a.inv[1] : a.inv[0]) + r * k;
  const float* wgt = (side ? a.wgt[1] : a.wgt[0]) + r * k;
  float* out = (side ? a.out[1] : a.out[0]) + r * a.h;
  const T* src = static_cast<const T*>(a.src);
  int n = 0;
  for (int v0 = vb; v0 < ve; v0 += 32 * VPL) {
    float acc[VPL][VEC];
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = 0.f;
    }
    for (int kb = 0; kb < k; kb += kCap) {
      if (v0 == vb || k > kCap) {
        n = resolve_pairs<kGather>(a, inv, wgt, kb, min(k, kb + kCap), s_row,
                                   s_wgt);
      }
      for (int i = 0; i < n; i += U) {
        R x[U][VPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int32_t row = i + u < n ? s_row[i + u] : -1;
#pragma unroll
          for (int q = 0; q < VPL; ++q) {
            const int v = v0 + lane + 32 * q;
            x[u][q] = R{};
            if (row >= 0 && v < ve) {
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
      if (v < ve) {
        dssm::store_floats<VEC, true>(out + (int64_t)v * VEC, acc[q]);
      }
    }
  }
}

template <typename T, int VEC, int VPL, int U>
__global__ void __launch_bounds__(kThreads) joint_lookup_kernel(LookupArgs a) {
  __shared__ int32_t s_rows[kWarps][kCap];
  __shared__ float s_wgts[kWarps][kCap];
  const int warp = threadIdx.x >> 5;
  lookup_warp<T, VEC, VPL, U, false>(
      a, (int64_t)blockIdx.x * kWarps + warp, s_rows[warp], s_wgts[warp]);
}

// Blocks [0, row_blocks) hold kWarps lookup rows each, the rest are slot
// blocks: the lookups, the longer work, are scheduled first.
template <typename T, int VEC, int VPL, int U>
__global__ void __launch_bounds__(kThreads)
    fused_gather_joint_kernel(LookupArgs a) {
  if (blockIdx.x >= (unsigned int)a.row_blocks) {
    copy_slot(a, blockIdx.x - a.row_blocks);
    return;
  }
  __shared__ int32_t s_rows[kWarps][kCap];
  __shared__ float s_wgts[kWarps][kCap];
  const int warp = threadIdx.x >> 5;
  lookup_warp<T, VEC, VPL, U, true>(
      a, (int64_t)blockIdx.x * kWarps + warp, s_rows[warp], s_wgts[warp]);
}

// The fused kernel: a warp a whole row, U = 16 / VPL.
template <typename T, int VEC>
void launch_fused_vpl(const LookupArgs& a, unsigned int blocks, int vpl,
                      cudaStream_t s) {
  switch (vpl) {
    case 1:
      fused_gather_joint_kernel<T, VEC, 1, 16><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 2:
      fused_gather_joint_kernel<T, VEC, 2, 8><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 3:
      fused_gather_joint_kernel<T, VEC, 3, 5><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 4:
      fused_gather_joint_kernel<T, VEC, 4, 4><<<blocks, kThreads, 0, s>>>(a);
      break;
    default:
      fused_gather_joint_kernel<T, VEC, 8, 2><<<blocks, kThreads, 0, s>>>(a);
  }
}

template <typename T>
int launch_fused(LookupArgs a, unsigned int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (a.h * sizeof(T)) % 16 == 0 && dssm::aligned16(a.src) &&
                   dssm::aligned16(a.out[0]) && dssm::aligned16(a.out[1]);
  a.split = 1;
  if (!vec) {
    a.nvec = a.per = a.h;
    fused_gather_joint_kernel<T, 1, 4, 4><<<blocks, kThreads, 0, s>>>(a);
  } else {
    a.nvec = a.per = a.h / kVec;
    launch_fused_vpl<T, kVec>(a, blocks, dssm::lane_vectors(a.nvec), s);
  }
  return (int)cudaGetLastError();
}

// The joint lookup: U = kLoads / VPL live pairs loaded ahead.
template <typename T, int VEC>
void launch_joint_vpl(const LookupArgs& a, unsigned int blocks, int vpl,
                      cudaStream_t s) {
  switch (vpl) {
    case 1:
      joint_lookup_kernel<T, VEC, 1, kLoads><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 2:
      joint_lookup_kernel<T, VEC, 2, kLoads / 2><<<blocks, kThreads, 0, s>>>(
          a);
      break;
    case 3:
      joint_lookup_kernel<T, VEC, 3, 3><<<blocks, kThreads, 0, s>>>(a);
      break;
    case 4:
      joint_lookup_kernel<T, VEC, 4, kLoads / 4><<<blocks, kThreads, 0, s>>>(
          a);
      break;
    default:
      joint_lookup_kernel<T, VEC, 8, 1><<<blocks, kThreads, 0, s>>>(a);
  }
}

// A warp per (side, row), or, when there are fewer of them than
// kTargetWarps, each row's vectors split over up to one warp per 32.
template <typename T>
int launch_joint(LookupArgs a, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = ((size_t)a.h * sizeof(T)) % 16 == 0 &&
                   dssm::aligned16(a.src) && dssm::aligned16(a.out[0]) &&
                   dssm::aligned16(a.out[1]);
  a.nvec = vec ? a.h / kVec : a.h;
  const long long pairs = 2LL * a.rows;
  const long long most = vec ? (a.nvec + 31) / 32 : 1;
  const long long want = (kTargetWarps + pairs - 1) / pairs;
  a.split = (int)(want < most ? want : most);
  a.per = (a.nvec + a.split - 1) / a.split;
  const long long blocks = (pairs * a.split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (!vec) {
    joint_lookup_kernel<T, 1, 4, 4><<<(unsigned int)blocks, kThreads, 0, s>>>(
        a);
  } else {
    launch_joint_vpl<T, kVec>(a, (unsigned int)blocks,
                              dssm::lane_vectors(a.per), s);
  }
  return (int)cudaGetLastError();
}

bool fill_sides(LookupArgs* a, const void* q_inv, const void* q_wgt,
                const void* d_inv, const void* d_wgt, int kq, int kd) {
  if (kq <= 0 || kd <= 0) return false;
  a->inv[0] = (const int32_t*)q_inv;
  a->inv[1] = (const int32_t*)d_inv;
  a->wgt[0] = (const float*)q_wgt;
  a->wgt[1] = (const float*)d_wgt;
  a->k[0] = kq;
  a->k[1] = kd;
  return true;
}

}  // namespace

// compact: [gr, h] (dtype 0 = f32, 1 = bf16); sel: [u2] int32; q_inv, q_wgt:
// [rows, kq]; d_inv, d_wgt: [rows, kd] (int32, f32); q_out, d_out:
// [rows, h] f32. Returns cudaGetLastError().
extern "C" int dssm_joint_lookup(const void* compact, const void* sel,
                                 const void* q_inv, const void* q_wgt,
                                 const void* d_inv, const void* d_wgt,
                                 void* q_out, void* d_out, long long rows,
                                 int kq, int kd, int u2, int gr, int h,
                                 int dtype, void* stream) {
  LookupArgs a = {};
  if (rows <= 0 || rows > (1 << 30) || h <= 0 || gr < 0 ||
      !fill_sides(&a, q_inv, q_wgt, d_inv, d_wgt, kq, kd)) {
    return (int)cudaErrorInvalidValue;
  }
  a.src = compact;
  a.sel = (const int32_t*)sel;
  a.out[0] = (float*)q_out;
  a.out[1] = (float*)d_out;
  a.rows = (int)rows;
  a.u2 = u2;
  a.gr = gr;
  a.h = h;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_joint<float>(a, s);
  if (dtype == 1) return launch_joint<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of scratch dssm_joint_lookup_bwd needs for these shapes; -1 for
// shapes it does not take.
extern "C" long long dssm_joint_lookup_bwd_workspace(long long rows, int kq,
                                                     int kd, int gr, int h) {
  dssm::BwdLayout l;
  return kd > 0 && dssm::bwd_layout(rows, kq, kd, gr, h, &l) ? 4 * l.words
                                                            : -1;
}

// g_q, g_d: [rows, h] (g_dtype 0 = f32, 1 = bf16); dc: [gr, h] f32, every
// row written (the caller does not fill it); work: 16-byte aligned scratch
// of work_bytes >= dssm_joint_lookup_bwd_workspace(...). Four kernels on
// the stream (segsum.cuh). Returns the first CUDA error.
extern "C" int dssm_joint_lookup_bwd(const void* sel, const void* q_inv,
                                     const void* q_wgt, const void* d_inv,
                                     const void* d_wgt, const void* g_q,
                                     const void* g_d, void* dc, void* work,
                                     long long work_bytes, long long rows,
                                     int kq, int kd, int u2, int gr, int h,
                                     int g_dtype, void* stream) {
  dssm::BwdLayout l;
  if (kd <= 0 || !dssm::bwd_layout(rows, kq, kd, gr, h, &l) ||
      work_bytes < 4 * l.words || !dssm::aligned16(work) ||
      (g_dtype != 0 && g_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  dssm::BwdArgs a = {};
  a.sel = (const int32_t*)sel;
  a.inv[0] = (const int32_t*)q_inv;
  a.inv[1] = (const int32_t*)d_inv;
  a.wgt[0] = (const float*)q_wgt;
  a.wgt[1] = (const float*)d_wgt;
  a.k[0] = kq;
  a.k[1] = kd;
  a.g[0] = g_q;
  a.g[1] = g_d;
  a.dc = (float*)dc;
  a.rows = (int)rows;
  a.u2 = u2;
  a.gr = gr;
  a.h = h;
  return dssm::lookup_bwd(a, l, work, g_dtype, (cudaStream_t)stream);
}

// table: [num_groups * group, h] (dtype 0 = f32, 1 = bf16); uniq:
// [num_slots] int32 group ids (out of [0, num_groups): an empty slot); sel,
// q_inv, q_wgt, d_inv, d_wgt as dssm_joint_lookup; q_out, d_out: [rows, h]
// f32; compact: [num_slots * group, h] of the table's dtype. A row group is
// a whole number of 16-byte vectors; table and compact 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int dssm_fused_gather_joint_lookup(
    const void* table, const void* uniq, const void* sel, const void* q_inv,
    const void* q_wgt, const void* d_inv, const void* d_wgt, void* q_out,
    void* d_out, void* compact, long long rows, int kq, int kd, int u2,
    int num_slots, int group, long long num_groups, int h, int dtype,
    void* stream) {
  const long long item = dtype == 0 ? 4 : 2;
  const long long row_blocks = (2 * rows + kWarps - 1) / kWarps;
  const long long blocks = (long long)num_slots + row_blocks;
  LookupArgs a = {};
  if (rows < 0 || rows > (1 << 30) || num_slots < 0 || group <= 0 ||
      h <= 0 || blocks <= 0 || blocks > 0x7fffffffLL ||
      (long long)num_slots * group > 0x7fffffffLL ||
      num_groups * group > 0x7fffffffLL || (group * h * item) % 16 != 0 ||
      !dssm::aligned16(table) || !dssm::aligned16(compact) ||
      (dtype != 0 && dtype != 1) ||
      !fill_sides(&a, q_inv, q_wgt, d_inv, d_wgt, kq, kd)) {
    return (int)cudaErrorInvalidValue;
  }
  a.src = table;
  a.uniq = (const int32_t*)uniq;
  a.sel = (const int32_t*)sel;
  a.out[0] = (float*)q_out;
  a.out[1] = (float*)d_out;
  a.compact = (int4*)compact;
  a.num_groups = (int64_t)num_groups;
  a.copy_vecs = (int64_t)group * h * item / 16;
  a.rows = (int)rows;
  a.u2 = u2;
  a.gr = num_slots * group;
  a.num_slots = num_slots;
  a.group = group;
  a.h = h;
  a.row_blocks = (int)row_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch_fused<float>(a, (unsigned int)blocks, s)
             : launch_fused<__nv_bfloat16>(a, (unsigned int)blocks, s);
}
