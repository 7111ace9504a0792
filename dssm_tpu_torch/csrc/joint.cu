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
// joint_lookup_kernel (dssm_joint_lookup, the int8 table's split path): one
// thread block per (side, row), one thread per column. The first warp
// compacts the row's live lookups in k order into shared memory
// (lookup.cuh); the block then runs accumulate_row: each column's sum is
// fmaf over the live lookups in k order, from 0.
//
// The fused gather + joint lookup (dssm_fused_gather_joint_lookup) replaces
// dssm_tpu/kernels/pallas_count.py::fused_gather_joint_lookup (kernel
// _fused_gather_joint_kernel). On the TPU, program 0 starts every row
// group's table -> compact DMA from the scalar unit, selects compact2 with a
// one-hot matmul once they land, and every program builds count tiles for
// the MXU. Here one launch holds two kinds of block that nothing orders:
//   - slot blocks copy each real row group of the table into compact with
//     16-byte vectors, 8 in flight a thread, and zero the rows of empty
//     slots (the gather's semantics);
//   - lookup blocks of 8 warps, one warp per (side, lookup row). Each lane
//     resolves up to 4 of the row's k in one pass, every load of a stage in
//     flight at once: inv and wgt, then sel, then uniq, giving the TABLE row
//     uniq[j / group] * group + j % group of compact row j (-1 for an empty
//     slot). A ballot compacts the live pairs in k order into the warp's
//     shared memory (no block barrier). A lane then owns 16-byte column
//     vectors (4 f32 or 8 bf16 columns; `full` f32: 3 a lane, cnn: 8) and
//     loads them for the next U live pairs before their FMAs, U x VPL
//     vectors in flight a lane (VPL vectors a lane, U = 16 / VPL). h that is
//     not a whole number of vectors, or a table or output that is not
//     16-byte aligned, takes the same loop one column at a time.
// Sum order: each column's sum is fmaf over the live pairs in k order from
// 0, and a pair whose slot is empty adds its zero term, exactly as
// accumulate_row does over the gathered compact block; so outputs and
// compact are bit-equal to gather_row_groups followed by joint_lookup.
// Outputs are written with 16-byte streaming stores (st.global.cs): at the
// cnn shapes they are the largest stream and are read once, by the tower.
// Bound on the H100: bytes. At `full` the real groups (~1.3 MB), inv + wgt
// (0.8 MB), compact (3.1 MB written) and the outputs (3.1 MB): ~2.5 us at
// 3.35 TB/s; the ~52k live lookups re-read 80 MB of table rows, which the
// L2 cache serves. At the cnn shapes the 134 MB of outputs bound it (58 us).
//
// The backward (dssm_joint_lookup_bwd) is a stable counting sort of the live
// lookups by compact row, then a segmented sum: four kernels, no float
// atomics, the same bits from every call.
//   1. rank: a block takes a chunk of 512-4096 flat lookups f = (side, r,
//      k), q side first. Each lane resolves its lookups' compact rows
//      j = sel[inv] (-1 dead); __match_any_sync groups equal rows within a
//      warp step, and the warps then take turns against a per-chunk row
//      histogram in shared memory, so each lookup gets its rank among the
//      chunk's earlier lookups of the same row. The histogram is written as
//      the chunk's row of counts [chunks, gr] (in passes of 16384 rows when
//      gr is larger).
//   2. scan: a block of 32 warps takes 32 rows, a warp a row: it turns the
//      row's counts into offsets across chunks (a shared-memory tile, warp
//      scans) and cuts the row's segment into pieces of at most 32 lookups.
//      First pieces and first partials are two-level: the row's offset
//      within its block plus the block's base, which the last block to
//      finish (an integer ticket) scans from the blocks' sums.
//   3. place: each live lookup's place in its row's segment is its chunk's
//      offset + its rank, so the segment lists row j's lookups in flat
//      order; it goes to slot place % 32 of the row's piece place / 32, and
//      the first lookup of each piece writes the piece's descriptor (row,
//      lookups, partial).
//   4. reduce: a warp per piece sums wgt * g[r, :] over its lookups in flat
//      order (fmaf from 0), loading 16-byte vectors of g (8 bf16 or 4 f32)
//      for the next U lookups before their FMAs. A row of one piece is
//      written straight into dc; a longer row's pieces write partials, and
//      the last piece to finish (an integer ticket) adds them in piece
//      order. Blocks after the pieces' zero the rows no live lookup names,
//      so every row of dc is written exactly once and the caller does not
//      fill it.
// Kernels 2-4 are launched with programmatic dependent launch, so each is
// scheduled while the one before it drains (griddepcontrol.wait guards its
// first read).
// Sum order: each dc row is a fixed function of the inputs: fmaf over each
// piece's lookups in flat order, then the pieces' partials added in order.
// Integer atomics count tickets only; no float sum depends on their order.
// Bound on the H100: bytes. At `full` g (bf16, 1.6 MB), inv + wgt + sel
// (0.8 MB) and dc (3.1 MB) once: 1.6 us; the ~52k live lookups re-read
// 40 MB of g rows from L2, and the four kernels run one after another. At
// the cnn shapes the 32 MB of dc, mostly zero rows, and the g rows.
// Scratch (keys, ranks, counts, offsets, the sorted lists, partials) comes
// from the caller, sized by dssm_joint_lookup_bwd_workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace {

constexpr unsigned int kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block (lookup rows, or pieces)
constexpr int kThreads = 32 * kWarps;
constexpr int kCap = 128;  // k a lookup warp resolves in one pass
constexpr int kCopyUnroll = 8;     // 16-byte copies in flight a thread
constexpr int kPiece = 32;         // lookups a reduce warp sums
constexpr int kKeyRange = 16384;   // compact rows a rank pass counts
constexpr int kScanKeys = 32;      // compact rows a scan block takes
constexpr int kScanChunks = 256;   // chunks a scan tile holds
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;

struct JointSides {
  const int32_t* inv[2];
  const float* wgt[2];
  int k[2];
};

template <typename T>
__global__ void joint_lookup_kernel(const T* __restrict__ compact,
                                    const int32_t* __restrict__ sel,
                                    JointSides sides, float* __restrict__ q_out,
                                    float* __restrict__ d_out, int rows,
                                    int u2, int gr, int h) {
  extern __shared__ unsigned char smem_raw[];
  const int kmax = sides.k[0] > sides.k[1] ? sides.k[0] : sides.k[1];
  int32_t* s_row = reinterpret_cast<int32_t*>(smem_raw);
  float* s_wgt = reinterpret_cast<float*>(smem_raw + sizeof(int32_t) * kmax);
  __shared__ int s_live;
  const int side = blockIdx.x >= rows ? 1 : 0;
  const int64_t r = blockIdx.x - side * rows;
  const int k = sides.k[side];
  if (threadIdx.x < 32) {
    const int live = dssm::compact_live_pairs(
        sides.inv[side] + r * k, sides.wgt[side] + r * k, sel, k, u2, gr,
        s_row, s_wgt);
    if (threadIdx.x == 0) s_live = live;
  }
  __syncthreads();
  float* out = side ? d_out : q_out;
  dssm::accumulate_row(compact, s_row, s_wgt, s_live, h, out + r * h);
}

// ---- 16-byte column vectors ------------------------------------------------

// What one lane loads at a time: VEC values of T (16 bytes, or one value).
template <typename T, int VEC>
struct Raw;
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<float, 1> {
  using type = float;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Raw<__nv_bfloat16, 1> {
  using type = unsigned short;
};

__device__ __forceinline__ float4 load_raw(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ uint4 load_raw(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short load_raw(const unsigned short* p) {
  return __ldg(p);
}

// bf16 -> f32 is exact: the bf16 bits are the f32's upper half.
__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void to_floats(float4 x, float (&f)[4]) {
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void to_floats(float x, float (&f)[1]) { f[0] = x; }
__device__ __forceinline__ void to_floats(uint4 x, float (&f)[8]) {
  f[0] = bf16_lo(x.x);
  f[1] = bf16_hi(x.x);
  f[2] = bf16_lo(x.y);
  f[3] = bf16_hi(x.y);
  f[4] = bf16_lo(x.z);
  f[5] = bf16_hi(x.z);
  f[6] = bf16_lo(x.w);
  f[7] = bf16_hi(x.w);
}
__device__ __forceinline__ void to_floats(unsigned short x, float (&f)[1]) {
  f[0] = __uint_as_float((unsigned int)x << 16);
}

// The Raw vector of T at element offset `at` of `base`.
template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_vec(const T* base,
                                                               int64_t at) {
  using R = typename Raw<T, VEC>::type;
  return load_raw(reinterpret_cast<const R*>(base + at));
}

// VEC f32 values to p (16-byte aligned when VEC > 1); streaming or plain.
template <int VEC, bool kStream>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (kStream) {
      __stcs(p, f[0]);
    } else {
      *p = f[0];
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 v = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      if constexpr (kStream) {
        __stcs(reinterpret_cast<float4*>(p + e), v);
      } else {
        *reinterpret_cast<float4*>(p + e) = v;
      }
    }
  }
}

// Vectors a lane owns in one column pass: 1, 2, 3, 4 or 8 (more passes
// above 32 * 8 vectors a row); the kernels load U ~ 16 / VPL rows ahead.
inline int lane_vectors(long long nvec) {
  return nvec <= 32 ? 1 : nvec <= 64 ? 2 : nvec <= 96 ? 3 : nvec <= 128 ? 4 : 8;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- the fused gather + joint lookup ----------------------------------------

struct FusedArgs {
  const void* table;
  const int32_t* uniq;
  const int32_t* sel;
  const int32_t* inv[2];
  const float* wgt[2];
  int k[2];
  float* out[2];
  int4* compact;
  int64_t num_groups;
  int64_t copy_vecs;  // 16-byte vectors in a row group
  int rows, u2, num_slots, group, h, nvec;
  int row_blocks;  // blocks of lookup rows; the slot blocks follow
};

// Slot block: compact's row group `slot` = the table's group uniq[slot], or
// zeros for an empty slot (the id is tested before any address is formed).
__device__ __forceinline__ void copy_slot(const FusedArgs& a, int slot) {
  const int64_t gid = a.uniq[slot];
  const bool real = gid >= 0 && gid < a.num_groups;
  const int64_t vecs = a.copy_vecs;
  const int4* src = reinterpret_cast<const int4*>(a.table) + (real ? gid * vecs : 0);
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
// to s_row (table row, -1 for an empty slot) and s_wgt; returns their count.
__device__ __forceinline__ int resolve_pairs(const FusedArgs& a,
                                             const int32_t* inv,
                                             const float* wgt, int kb,
                                             int kend, int32_t* s_row,
                                             float* s_wgt) {
  constexpr int kSub = kCap / 32;
  const int lane = threadIdx.x & 31;
  const int gr = a.num_slots * a.group;
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
      if (jj >= 0 && jj < gr) j[s] = jj;
    }
  }
  int32_t row[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    row[s] = -1;
    if (j[s] >= 0) {
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

// Blocks [0, row_blocks) hold kWarps lookup rows each, the rest are slot
// blocks: the lookups, the longer work, are scheduled first.
template <typename T, int VEC, int VPL, int U>
__global__ void __launch_bounds__(kThreads)
    fused_gather_joint_kernel(FusedArgs a) {
  if (blockIdx.x >= (unsigned int)a.row_blocks) {
    copy_slot(a, blockIdx.x - a.row_blocks);
    return;
  }
  using R = typename Raw<T, VEC>::type;
  __shared__ int32_t s_rows[kWarps][kCap];
  __shared__ float s_wgts[kWarps][kCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wi = (int64_t)blockIdx.x * kWarps + warp;
  if (wi >= 2 * (int64_t)a.rows) return;
  const int side = wi >= a.rows ? 1 : 0;
  const int64_t r = wi - (int64_t)side * a.rows;
  // Parameters picked by selects, not indexed: an index would copy them to
  // the stack.
  const int k = side ? a.k[1] : a.k[0];
  const int32_t* inv = (side ? a.inv[1] : a.inv[0]) + r * k;
  const float* wgt = (side ? a.wgt[1] : a.wgt[0]) + r * k;
  float* out = (side ? a.out[1] : a.out[0]) + r * a.h;
  const T* table = static_cast<const T*>(a.table);
  int32_t* s_row = s_rows[warp];
  float* s_wgt = s_wgts[warp];
  int n = 0;
  for (int v0 = 0; v0 < a.nvec; v0 += 32 * VPL) {
    float acc[VPL][VEC];
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = 0.f;
    }
    for (int kb = 0; kb < k; kb += kCap) {
      if (v0 == 0 || k > kCap) {
        n = resolve_pairs(a, inv, wgt, kb, min(k, kb + kCap), s_row, s_wgt);
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
            if (row >= 0 && v < a.nvec) {
              x[u][q] = load_vec<T, VEC>(
                  table, (int64_t)row * a.h + (int64_t)v * VEC);
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
              to_floats(x[u][q], f);
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
      if (v < a.nvec) store_floats<VEC, true>(out + (int64_t)v * VEC, acc[q]);
    }
  }
}

template <typename T, int VEC>
int launch_fused_vpl(const FusedArgs& a, unsigned int blocks, int vpl,
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
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(FusedArgs a, unsigned int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (a.h * sizeof(T)) % 16 == 0 && aligned16(a.table) &&
                   aligned16(a.out[0]) && aligned16(a.out[1]);
  if (!vec) {
    a.nvec = a.h;
    fused_gather_joint_kernel<T, 1, 4, 4><<<blocks, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  a.nvec = a.h / kVec;
  return launch_fused_vpl<T, kVec>(a, blocks, lane_vectors(a.nvec), s);
}

// ---- the backward: stable counting sort + segmented sum ---------------------

struct BwdArgs {
  const int32_t* sel;
  const int32_t* inv[2];
  const float* wgt[2];
  int k[2];
  const void* g[2];
  float* dc;
  int rows, u2, gr, h, nvec;
  int n;       // flat lookups, rows * (kq + kd)
  int nq;      // the q side's, rows * kq
  int chunk;   // flat lookups a rank block takes
  int nc;      // chunks
  int zero_blocks;  // reduce blocks before the zero rows' blocks
  int nb;      // scan blocks, gr / kScanKeys rounded up
  // Scratch (dssm_joint_lookup_bwd_workspace).
  // First pieces and first partials are two-level: a scan block's base
  // (over the blocks of kScanKeys rows) plus the row's offset within it.
  int* ctrl;       // [0]: scan blocks done; [1]: pieces
  int* key;        // [n] compact row of each lookup, -1 dead
  int* rank;       // [n] rank among the chunk's lookups of its row
  int* cnt;        // [nc, gr] counts, then offsets within the row
  int* total;      // [gr] live lookups a row
  int* npc;        // [gr] pieces a row (0 for an empty row)
  int* local;      // [2, gr] first piece, first partial within the block
  int* agg;        // [2, nb] each scan block's sums of the two
  int* base;       // [2, nb] exclusive scans of agg over the blocks
  int* arrive;     // [gr] pieces of each row finished
  int4* piece;     // [max_pieces] {lookups, partial or -1, row, 0}
  int* list_g;     // [max_pieces, kPiece] by piece: g row (q rows, then d)
  float* list_w;   // [max_pieces, kPiece] by piece: weight
  float* partial;  // [max_partials, h]
};

// Kernels 2-4 are launched with programmatic stream serialization (see
// launch_after): each may be scheduled while the kernel before it drains,
// and waits here, before its first read, until that kernel's writes are
// visible.
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Kernel 1: each lookup's compact row and its rank among its chunk's
// earlier lookups of that row; the chunk's counts. EPT = chunk / kThreads.
template <int EPT>
__global__ void __launch_bounds__(kThreads) bwd_rank_kernel(BwdArgs a) {
  extern __shared__ int hist[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.gr;
       i += (int64_t)gridDim.x * kThreads) {
    a.arrive[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctrl[0] = 0;
  // A warp takes 32 * EPT consecutive lookups, a step of 32 at a time.
  const int64_t base = (int64_t)blockIdx.x * a.chunk + warp * (32 * EPT);
  int key[EPT];
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const int64_t f = base + s * 32 + lane;
    key[s] = -1;
    if (f < a.n) {
      const bool d_side = f >= a.nq;
      const int64_t idx = d_side ? f - a.nq : f;
      const int32_t u = __ldg((d_side ? a.inv[1] : a.inv[0]) + idx);
      const float w = __ldg((d_side ? a.wgt[1] : a.wgt[0]) + idx);
      if (w != 0.f && u >= 0 && u < a.u2) {
        const int32_t j = __ldg(a.sel + u);
        if (j >= 0 && j < a.gr) key[s] = j;
      }
      a.key[f] = key[s];
    }
  }
  unsigned int peers[EPT];
#pragma unroll
  for (int s = 0; s < EPT; ++s) peers[s] = __match_any_sync(kFull, key[s]);
  const unsigned int lt = (1u << lane) - 1u;
  for (int kr0 = 0; kr0 < a.gr; kr0 += kKeyRange) {
    const int kr = min(kKeyRange, a.gr - kr0);
    for (int i = threadIdx.x; i < kr; i += kThreads) hist[i] = 0;
    __syncthreads();
    // Warps in chunk order; within a warp, steps in order, lanes in order.
    for (int turn = 0; turn < kWarps; ++turn) {
      if (warp == turn) {
#pragma unroll
        for (int s = 0; s < EPT; ++s) {
          const int kk = key[s] - kr0;
          const bool mine = key[s] >= 0 && kk >= 0 && kk < kr;
          const int before = mine ? hist[kk] : 0;
          __syncwarp();
          const int lower = __popc(peers[s] & lt);
          if (mine && lower == 0) hist[kk] = before + __popc(peers[s]);
          __syncwarp();
          if (mine) a.rank[base + s * 32 + lane] = before + lower;
        }
      }
      __syncthreads();
    }
    int* row = a.cnt + (int64_t)blockIdx.x * a.gr + kr0;
    for (int i = threadIdx.x; i < kr; i += kThreads) row[i] = hist[i];
    __syncthreads();
  }
}

// Block-wide exclusive scan of two ints (kScanThreads threads, each
// scanned on its own); every thread gets the two block totals.
__device__ __forceinline__ void block_scan2(int (&x)[2], int (&tot)[2]) {
  __shared__ int s_warp[2][32];
  __shared__ int s_tot[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    incl[q] = x[q];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl[q], o);
      if (lane >= o) incl[q] += y;
    }
    if (lane == 31) s_warp[q][warp] = incl[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = s_warp[q][lane];
      int wi = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += y;
      }
      s_warp[q][lane] = wi - v;  // exclusive over warps
      if (lane == 31) s_tot[q] = wi;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    x[q] = s_warp[q][warp] + incl[q] - x[q];
    tot[q] = s_tot[q];
  }
  __syncthreads();  // s_warp and s_tot are free for the next call
}

// One warp: out[0, h) = 0.
__device__ __forceinline__ void zero_row(float* out, int h) {
  const int lane = threadIdx.x & 31;
  if (h % 4 == 0) {
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int v = lane; v < h / 4; v += 32) {
      o4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = lane; c < h; c += 32) out[c] = 0.f;
  }
}

// Kernel 2: a block of kScanKeys rows, a warp a row. Counts -> offsets
// within the row across chunks (in place, through a shared-memory tile);
// the row's lookups and pieces; an empty row's dc row zeroed; the rows'
// offsets within the block and the block's sums. The last block to finish
// (an integer ticket) scans the block sums into the blocks' bases.
__global__ void __launch_bounds__(kScanThreads) bwd_scan_kernel(BwdArgs a) {
  static_assert(kScanKeys == kScanWarps, "a warp a row");
  wait_previous();
  __shared__ int tile[kScanChunks][kScanKeys + 1];
  __shared__ int s_rows[2][kScanKeys];
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kScanKeys;
  const int j = j0 + warp;  // this warp's row
  const bool col_ok = j0 + lane < a.gr;
  int carry = 0;
  for (int c0 = 0; c0 < a.nc; c0 += kScanChunks) {
#pragma unroll
    for (int i = 0; i < kScanChunks / kScanWarps; ++i) {
      const int row = warp + kScanWarps * i;
      const int64_t c = c0 + row;
      tile[row][lane] =
          c < a.nc && col_ok ? a.cnt[c * a.gr + j0 + lane] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScanChunks / 32; ++i) {
      const int x = tile[32 * i + lane][warp];
      int incl = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      tile[32 * i + lane][warp] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScanChunks / kScanWarps; ++i) {
      const int row = warp + kScanWarps * i;
      const int64_t c = c0 + row;
      if (c < a.nc && col_ok) a.cnt[c * a.gr + j0 + lane] = tile[row][lane];
    }
    __syncthreads();
  }
  const bool real = j < a.gr;
  const int np = (carry + kPiece - 1) / kPiece;
  if (lane == 0) {
    s_rows[0][warp] = real ? np : 0;
    s_rows[1][warp] = real && np > 1 ? np : 0;
    if (real) {
      a.total[j] = carry;
      a.npc[j] = np;
    }
  }
  __syncthreads();
  if (warp < 2) {  // warp q scans quantity q over the block's rows
    const int v = s_rows[warp][lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (j0 + lane < a.gr) a.local[warp * a.gr + j0 + lane] = incl - v;
    if (lane == 31) a.agg[warp * a.nb + blockIdx.x] = incl;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(a.ctrl, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int run[2] = {0, 0};
  for (int b0 = 0; b0 < a.nb; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    int x[2], tot[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      x[q] = b < a.nb ? __ldcg(a.agg + q * a.nb + b) : 0;
    }
    block_scan2(x, tot);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (b < a.nb) a.base[q * a.nb + b] = run[q] + x[q];
      run[q] += tot[q];
    }
  }
  if (threadIdx.x == 0) a.ctrl[1] = run[0];
}

// Row j's first piece and first partial.
__device__ __forceinline__ int row_pbase(const BwdArgs& a, int j) {
  return a.base[j / kScanKeys] + a.local[j];
}
__device__ __forceinline__ int row_ppbase(const BwdArgs& a, int j) {
  return a.base[a.nb + j / kScanKeys] + a.local[a.gr + j];
}

// Kernel 3: each live lookup to its place in its row's segment; the first
// lookup of each piece writes the piece's descriptor.
__global__ void __launch_bounds__(kThreads) bwd_place_kernel(BwdArgs a) {
  wait_previous();
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= a.n) return;
  const int j = a.key[f];
  if (j < 0) return;
  const int c = f / a.chunk;
  const int r = a.cnt[(int64_t)c * a.gr + j] + a.rank[f];  // in the segment
  const int piece = row_pbase(a, j) + r / kPiece;
  const int pos = piece * kPiece + r % kPiece;
  if (r % kPiece == 0) {
    a.piece[piece] = make_int4(
        min(a.total[j] - r, kPiece),
        a.npc[j] > 1 ? row_ppbase(a, j) + r / kPiece : -1, j, 0);
  }
  const bool d_side = f >= a.nq;
  const int idx = d_side ? f - a.nq : f;
  a.list_g[pos] = d_side ? a.rows + (int)(idx / a.k[1]) : (int)(idx / a.k[0]);
  a.list_w[pos] = (d_side ? a.wgt[1] : a.wgt[0])[idx];
}

// The last piece of a row: dc row = the m partials added in piece order.
__device__ __forceinline__ void combine_pieces(const float* pp, int m, int h,
                                               float* out) {
  const int lane = threadIdx.x & 31;
  constexpr int kAhead = 8;
  if (h % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(pp);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int nv = h / 4;
    for (int v = lane; v < nv; v += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p0 = 0; p0 < m; p0 += kAhead) {
        float4 x[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p0 + u < m) x[u] = __ldcg(p4 + (int64_t)(p0 + u) * nv + v);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (p0 + u < m) {
            acc.x += x[u].x;
            acc.y += x[u].y;
            acc.z += x[u].z;
            acc.w += x[u].w;
          }
        }
      }
      o4[v] = acc;
    }
  } else {
    for (int c = lane; c < h; c += 32) {
      float acc = 0.f;
      for (int p = 0; p < m; ++p) acc += __ldcg(pp + (int64_t)p * h + c);
      out[c] = acc;
    }
  }
}

// Kernel 4: a warp per piece; partials of a row of several pieces are added
// by the row's last piece to finish. Blocks from zero_blocks on zero the dc
// rows no live lookup names, after the pieces' blocks.
template <typename G, int VEC, int VPL, int U>
__global__ void __launch_bounds__(kThreads) bwd_reduce_kernel(BwdArgs a) {
  using R = typename Raw<G, VEC>::type;
  __shared__ int s_gs[kWarps][kPiece];
  __shared__ float s_ws[kWarps][kPiece];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  wait_previous();
  const int pieces = a.ctrl[1];
  if (blockIdx.x >= a.zero_blocks) {  // the tail: dc rows no lookup names
    const int j = (blockIdx.x - a.zero_blocks) * kWarps + warp;
    if (j < a.gr && a.total[j] == 0) zero_row(a.dc + (int64_t)j * a.h, a.h);
    return;
  }
  if (w >= pieces) return;
  const int4 pc = a.piece[w];
  const int n = pc.x, pp = pc.y, j = pc.z;
  int* s_g = s_gs[warp];
  float* s_w = s_ws[warp];
  // The piece's slots, read beside its descriptor (lookups past n unused).
  for (int t = lane; t < kPiece; t += 32) {
    s_g[t] = a.list_g[(int64_t)w * kPiece + t];
    s_w[t] = a.list_w[(int64_t)w * kPiece + t];
  }
  __syncwarp();
  const G* gq = static_cast<const G*>(a.g[0]);
  const G* gd = static_cast<const G*>(a.g[1]);
  float* dst = pp < 0 ? a.dc + (int64_t)j * a.h : a.partial + (int64_t)pp * a.h;
  for (int v0 = 0; v0 < a.nvec; v0 += 32 * VPL) {
    float acc[VPL][VEC];
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[q][e] = 0.f;
    }
    for (int t = 0; t < n; t += U) {
      R x[U][VPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int gi = t + u < n ? s_g[t + u] : -1;
        const G* grow = gi < 0        ? gq
                        : gi < a.rows ? gq + (int64_t)gi * a.h
                                      : gd + (int64_t)(gi - a.rows) * a.h;
#pragma unroll
        for (int q = 0; q < VPL; ++q) {
          const int v = v0 + lane + 32 * q;
          x[u][q] = R{};
          if (gi >= 0 && v < a.nvec) {
            x[u][q] = load_vec<G, VEC>(grow, (int64_t)v * VEC);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u < n) {
          const float wt = s_w[t + u];
#pragma unroll
          for (int q = 0; q < VPL; ++q) {
            float f[VEC];
            to_floats(x[u][q], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[q][e] = fmaf(wt, f[e], acc[q][e]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int v = v0 + lane + 32 * q;
      if (v < a.nvec) store_floats<VEC, false>(dst + (int64_t)v * VEC, acc[q]);
    }
  }
  if (pp < 0) return;
  const int m = a.npc[j];
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.arrive + j, 1);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != m - 1) return;
  __threadfence();
  combine_pieces(a.partial + (int64_t)row_ppbase(a, j) * a.h, m, a.h,
                 a.dc + (int64_t)j * a.h);
}

// A kernel of the backward after the one before it on the stream, with
// Hopper's programmatic dependent launch: its blocks may be scheduled while
// the previous kernel drains (they wait in wait_previous), which hides the
// launch gap between the four kernels. Returns the launch's error.
template <typename Kernel>
int launch_after(Kernel kernel, unsigned int blocks, int threads,
                 const BwdArgs& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename G, int VEC>
int launch_reduce_vpl(const BwdArgs& a, unsigned int blocks, int vpl,
                      cudaStream_t s) {
  switch (vpl) {
    case 1:
      return launch_after(bwd_reduce_kernel<G, VEC, 1, 16>, blocks, kThreads,
                          a, s);
    case 2:
      return launch_after(bwd_reduce_kernel<G, VEC, 2, 8>, blocks, kThreads,
                          a, s);
    case 3:
      return launch_after(bwd_reduce_kernel<G, VEC, 3, 5>, blocks, kThreads,
                          a, s);
    case 4:
      return launch_after(bwd_reduce_kernel<G, VEC, 4, 4>, blocks, kThreads,
                          a, s);
    default:
      return launch_after(bwd_reduce_kernel<G, VEC, 8, 2>, blocks, kThreads,
                          a, s);
  }
}

template <typename G>
int launch_reduce(BwdArgs a, unsigned int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(G);
  const bool vec = (a.h * sizeof(G)) % 16 == 0 && aligned16(a.g[0]) &&
                   aligned16(a.g[1]) && aligned16(a.dc);
  if (!vec) {
    a.nvec = a.h;
    return launch_after(bwd_reduce_kernel<G, 1, 4, 4>, blocks, kThreads, a,
                        s);
  }
  a.nvec = a.h / kVec;
  return launch_reduce_vpl<G, kVec>(a, blocks, lane_vectors(a.nvec), s);
}

// The backward's sizes and its scratch layout, in 4-byte words (each part
// 16-byte aligned). False for shapes it does not take.
struct BwdLayout {
  long long n, nq, chunk, nc, nb, max_pieces, max_partials;
  long long ctrl, key, rank, cnt, total, npc, local, agg, base, arrive,
      piece, list_g, list_w, partial, words;
};

bool bwd_layout(long long rows, int kq, int kd, int gr, int h,
                BwdLayout* l) {
  if (rows <= 0 || rows > (1 << 30) || kq <= 0 || kd <= 0 || gr <= 0 ||
      h <= 0 || gr > (1 << 30)) {
    return false;
  }
  l->n = rows * (kq + kd);
  l->nq = rows * kq;
  if (l->n > 0x7fffffffLL - 2 * kPiece) return false;
  // The smallest chunk that keeps the [chunks, gr] counts within 4 MB.
  l->chunk = 512;
  while (l->chunk < 4096 &&
         (l->n + l->chunk - 1) / l->chunk * gr > (1LL << 20)) {
    l->chunk *= 2;
  }
  l->nc = (l->n + l->chunk - 1) / l->chunk;
  l->nb = (gr + kScanKeys - 1) / kScanKeys;
  const long long pieces = (l->n + kPiece - 1) / kPiece;
  l->max_pieces = gr + pieces;
  // A row of several pieces has more than kPiece lookups and fewer than
  // twice as many pieces as it has lookups / kPiece.
  l->max_partials = 2 * pieces;
  if (l->max_pieces * kPiece > 0x7fffffffLL || l->nc * gr > (1LL << 34)) {
    return false;
  }
  long long at = 0;
  auto take = [&at](long long words) {
    const long long here = at;
    at += (words + 3) / 4 * 4;
    return here;
  };
  l->ctrl = take(4);
  l->key = take(l->n);
  l->rank = take(l->n);
  l->cnt = take(l->nc * gr);
  l->total = take(gr);
  l->npc = take(gr);
  l->local = take(2LL * gr);
  l->agg = take(2 * l->nb);
  l->base = take(2 * l->nb);
  l->arrive = take(gr);
  l->piece = take(4 * l->max_pieces);
  l->list_g = take(l->max_pieces * kPiece);
  l->list_w = take(l->max_pieces * kPiece);
  l->partial = take(l->max_partials * h);
  l->words = at;
  return true;
}

template <int EPT>
int launch_rank(const BwdArgs& a, unsigned int blocks, cudaStream_t s) {
  const int smem = (int)sizeof(int) * min(a.gr, kKeyRange);
  auto kernel = bwd_rank_kernel<EPT>;
  // Raised once for each device this process launches it on.
  static int attr_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(int) * kKeyRange);
    if (err != cudaSuccess) return (int)err;
    attr_device = device;
  }
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool fill_sides(JointSides* sides, const void* q_inv, const void* q_wgt,
                const void* d_inv, const void* d_wgt, int kq, int kd,
                size_t* smem) {
  if (kq <= 0 || kd <= 0) return false;
  sides->inv[0] = (const int32_t*)q_inv;
  sides->inv[1] = (const int32_t*)d_inv;
  sides->wgt[0] = (const float*)q_wgt;
  sides->wgt[1] = (const float*)d_wgt;
  sides->k[0] = kq;
  sides->k[1] = kd;
  *smem = (sizeof(int32_t) + sizeof(float)) * (size_t)(kq > kd ? kq : kd);
  return *smem <= 48 * 1024;
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
  JointSides sides;
  size_t smem;
  if (rows <= 0 || rows > (1 << 30) || h <= 0 ||
      !fill_sides(&sides, q_inv, q_wgt, d_inv, d_wgt, kq, kd, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = 2u * (unsigned int)rows;
  const int threads = dssm::block_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    joint_lookup_kernel<float><<<blocks, threads, smem, s>>>(
        (const float*)compact, (const int32_t*)sel, sides, (float*)q_out,
        (float*)d_out, (int)rows, u2, gr, h);
  } else if (dtype == 1) {
    joint_lookup_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(
        (const __nv_bfloat16*)compact, (const int32_t*)sel, sides,
        (float*)q_out, (float*)d_out, (int)rows, u2, gr, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Bytes of scratch dssm_joint_lookup_bwd needs for these shapes; -1 for
// shapes it does not take.
extern "C" long long dssm_joint_lookup_bwd_workspace(long long rows, int kq,
                                                     int kd, int gr, int h) {
  BwdLayout l;
  return bwd_layout(rows, kq, kd, gr, h, &l) ? 4 * l.words : -1;
}

// g_q, g_d: [rows, h] (g_dtype 0 = f32, 1 = bf16); dc: [gr, h] f32, every
// row written (the caller does not fill it); work: 16-byte aligned scratch
// of work_bytes >= dssm_joint_lookup_bwd_workspace(...). Four kernels on
// the stream. Returns the first CUDA error.
extern "C" int dssm_joint_lookup_bwd(const void* sel, const void* q_inv,
                                     const void* q_wgt, const void* d_inv,
                                     const void* d_wgt, const void* g_q,
                                     const void* g_d, void* dc, void* work,
                                     long long work_bytes, long long rows,
                                     int kq, int kd, int u2, int gr, int h,
                                     int g_dtype, void* stream) {
  BwdLayout l;
  if (!bwd_layout(rows, kq, kd, gr, h, &l) || work_bytes < 4 * l.words ||
      !aligned16(work) || (g_dtype != 0 && g_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int* w = static_cast<int*>(work);
  BwdArgs a;
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
  a.nvec = h;
  a.n = (int)l.n;
  a.nq = (int)l.nq;
  a.chunk = (int)l.chunk;
  a.nc = (int)l.nc;
  a.zero_blocks = (int)((l.max_pieces + kWarps - 1) / kWarps);
  a.nb = (int)l.nb;
  a.ctrl = w + l.ctrl;
  a.key = w + l.key;
  a.rank = w + l.rank;
  a.cnt = w + l.cnt;
  a.total = w + l.total;
  a.npc = w + l.npc;
  a.local = w + l.local;
  a.agg = w + l.agg;
  a.base = w + l.base;
  a.arrive = w + l.arrive;
  a.piece = reinterpret_cast<int4*>(w + l.piece);
  a.list_g = w + l.list_g;
  a.list_w = reinterpret_cast<float*>(w + l.list_w);
  a.partial = reinterpret_cast<float*>(w + l.partial);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int chunks = (unsigned int)l.nc;
  int rc = l.chunk == 512    ? launch_rank<512 / kThreads>(a, chunks, s)
           : l.chunk == 1024 ? launch_rank<1024 / kThreads>(a, chunks, s)
           : l.chunk == 2048 ? launch_rank<2048 / kThreads>(a, chunks, s)
                             : launch_rank<4096 / kThreads>(a, chunks, s);
  if (rc != 0) return rc;
  rc = launch_after(bwd_scan_kernel, (unsigned int)l.nb, kScanThreads, a, s);
  if (rc != 0) return rc;
  rc = launch_after(bwd_place_kernel,
                    (unsigned int)((l.n + kThreads - 1) / kThreads), kThreads,
                    a, s);
  if (rc != 0) return rc;
  const unsigned int blocks =
      (unsigned int)(a.zero_blocks + (gr + kWarps - 1) / kWarps);
  rc = g_dtype == 0 ? launch_reduce<float>(a, blocks, s)
                    : launch_reduce<__nv_bfloat16>(a, blocks, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
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
  if (rows < 0 || rows > (1 << 30) || num_slots < 0 || group <= 0 ||
      h <= 0 || kq <= 0 || kd <= 0 || blocks <= 0 ||
      blocks > 0x7fffffffLL || (long long)num_slots * group > 0x7fffffffLL ||
      num_groups * group > 0x7fffffffLL || (group * h * item) % 16 != 0 ||
      !aligned16(table) || !aligned16(compact) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  FusedArgs a;
  a.table = table;
  a.uniq = (const int32_t*)uniq;
  a.sel = (const int32_t*)sel;
  a.inv[0] = (const int32_t*)q_inv;
  a.inv[1] = (const int32_t*)d_inv;
  a.wgt[0] = (const float*)q_wgt;
  a.wgt[1] = (const float*)d_wgt;
  a.k[0] = kq;
  a.k[1] = kd;
  a.out[0] = (float*)q_out;
  a.out[1] = (float*)d_out;
  a.compact = (int4*)compact;
  a.num_groups = (int64_t)num_groups;
  a.copy_vecs = (int64_t)group * h * item / 16;
  a.rows = (int)rows;
  a.u2 = u2;
  a.num_slots = num_slots;
  a.group = group;
  a.h = h;
  a.nvec = h;
  a.row_blocks = (int)row_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch_fused<float>(a, (unsigned int)blocks, s)
             : launch_fused<__nv_bfloat16>(a, (unsigned int)blocks, s);
}
