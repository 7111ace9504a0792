// The lookup backward shared by joint.cu (dssm_joint_lookup_bwd: both
// sides through a row selection) and count.cu (dssm_count_lookup_bwd: one
// side, no selection):
//
//   dc[j, :] = sum over the live lookups (side, r, k) whose compact row
//              sel[inv[r, k]] (inv[r, k] without sel) is j of
//              wgt[r, k] * g_side[r, :]
//
// a stable counting sort of the live lookups by compact row, then a
// segmented sum: four kernels, no float atomics, the same bits from every
// call. Flat lookups are f = (side, r, k), q side first.
//   1. rank: a block takes a chunk of 512-4096 flat lookups. Each lane
//      resolves its lookups' compact rows (-1 dead); __match_any_sync groups
//      equal rows within a warp step, and the warps then take turns against
//      a per-chunk row histogram in shared memory, so each lookup gets its
//      rank among the chunk's earlier lookups of the same row. The
//      histogram is written as the chunk's row of counts [chunks, gr] (in
//      passes of 16384 rows when gr is larger).
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
// Scratch (keys, ranks, counts, offsets, the sorted lists, partials) comes
// from the caller, laid out by bwd_layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace dssm {
// Internal linkage: each source that includes this has its own kernels.
namespace {

constexpr int kBwdWarps = 8;  // warps a rank, place or reduce block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kPiece = 32;         // lookups a reduce warp sums
constexpr int kKeyRange = 16384;   // compact rows a rank pass counts
constexpr int kScanKeys = 32;      // compact rows a scan block takes
constexpr int kScanChunks = 256;   // chunks a scan tile holds
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;

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
  // Scratch (bwd_layout).
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
// earlier lookups of that row; the chunk's counts. EPT = chunk / kBwdThreads.
template <int EPT>
__global__ void __launch_bounds__(kBwdThreads) bwd_rank_kernel(BwdArgs a) {
  extern __shared__ int hist[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x; i < a.gr;
       i += (int64_t)gridDim.x * kBwdThreads) {
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
        const int32_t j = a.sel != nullptr ? __ldg(a.sel + u) : u;
        if (j >= 0 && j < a.gr) key[s] = j;
      }
      a.key[f] = key[s];
    }
  }
  unsigned int peers[EPT];
#pragma unroll
  for (int s = 0; s < EPT; ++s) peers[s] = __match_any_sync(0xffffffffu, key[s]);
  const unsigned int lt = (1u << lane) - 1u;
  for (int kr0 = 0; kr0 < a.gr; kr0 += kKeyRange) {
    const int kr = min(kKeyRange, a.gr - kr0);
    for (int i = threadIdx.x; i < kr; i += kBwdThreads) hist[i] = 0;
    __syncthreads();
    // Warps in chunk order; within a warp, steps in order, lanes in order.
    for (int turn = 0; turn < kBwdWarps; ++turn) {
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
    for (int i = threadIdx.x; i < kr; i += kBwdThreads) row[i] = hist[i];
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
      const int y = __shfl_up_sync(0xffffffffu, incl[q], o);
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
        const int y = __shfl_up_sync(0xffffffffu, wi, o);
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
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      tile[32 * i + lane][warp] = carry + incl - x;
      carry += __shfl_sync(0xffffffffu, incl, 31);
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
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
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
__global__ void __launch_bounds__(kBwdThreads) bwd_place_kernel(BwdArgs a) {
  wait_previous();
  const int f = blockIdx.x * kBwdThreads + threadIdx.x;
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
__global__ void __launch_bounds__(kBwdThreads) bwd_reduce_kernel(BwdArgs a) {
  using R = typename Raw<G, VEC>::type;
  __shared__ int s_gs[kBwdWarps][kPiece];
  __shared__ float s_ws[kBwdWarps][kPiece];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kBwdWarps + warp;
  wait_previous();
  const int pieces = a.ctrl[1];
  if (blockIdx.x >= a.zero_blocks) {  // the tail: dc rows no lookup names
    const int j = (blockIdx.x - a.zero_blocks) * kBwdWarps + warp;
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
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
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
      return launch_after(bwd_reduce_kernel<G, VEC, 1, 16>, blocks, kBwdThreads,
                          a, s);
    case 2:
      return launch_after(bwd_reduce_kernel<G, VEC, 2, 8>, blocks, kBwdThreads,
                          a, s);
    case 3:
      return launch_after(bwd_reduce_kernel<G, VEC, 3, 5>, blocks, kBwdThreads,
                          a, s);
    case 4:
      return launch_after(bwd_reduce_kernel<G, VEC, 4, 4>, blocks, kBwdThreads,
                          a, s);
    default:
      return launch_after(bwd_reduce_kernel<G, VEC, 8, 2>, blocks, kBwdThreads,
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
    return launch_after(bwd_reduce_kernel<G, 1, 4, 4>, blocks, kBwdThreads, a,
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
  if (rows <= 0 || rows > (1 << 30) || kq <= 0 || kd < 0 || gr <= 0 ||
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
  kernel<<<blocks, kBwdThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}


// The backward on the stream: a.dc [gr, h] f32 (every row written) from
// a.g (g_dtype 0 = f32, 1 = bf16) through the four kernels; `a` holds the
// lookups (sel may be null: the identity) and its shapes, work the scratch
// of layout l (16-byte aligned). Returns the first CUDA error.
inline int lookup_bwd(BwdArgs a, const BwdLayout& l, void* work, int g_dtype,
                      cudaStream_t s) {
  int* w = static_cast<int*>(work);
  a.nvec = a.h;
  a.n = (int)l.n;
  a.nq = (int)l.nq;
  a.chunk = (int)l.chunk;
  a.nc = (int)l.nc;
  a.zero_blocks = (int)((l.max_pieces + kBwdWarps - 1) / kBwdWarps);
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
  const unsigned int chunks = (unsigned int)l.nc;
  int rc = l.chunk == 512    ? launch_rank<512 / kBwdThreads>(a, chunks, s)
           : l.chunk == 1024 ? launch_rank<1024 / kBwdThreads>(a, chunks, s)
           : l.chunk == 2048 ? launch_rank<2048 / kBwdThreads>(a, chunks, s)
                             : launch_rank<4096 / kBwdThreads>(a, chunks, s);
  if (rc != 0) return rc;
  rc = launch_after(bwd_scan_kernel, (unsigned int)l.nb, kScanThreads, a, s);
  if (rc != 0) return rc;
  rc = launch_after(bwd_place_kernel,
                    (unsigned int)((l.n + kBwdThreads - 1) / kBwdThreads),
                    kBwdThreads, a, s);
  if (rc != 0) return rc;
  const unsigned int blocks =
      (unsigned int)(a.zero_blocks + (a.gr + kBwdWarps - 1) / kBwdWarps);
  rc = g_dtype == 0 ? launch_reduce<float>(a, blocks, s)
                    : launch_reduce<__nv_bfloat16>(a, blocks, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dssm
