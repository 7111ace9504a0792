// Fused in-batch cosine-softmax loss: per query row i over the doc pool,
//   logits[i, j] = gamma * q[i] . d[j]
//   nll[i] = logsumexp_j logits[i, j] - logits[i, labels[i]]
// with lse, the positive logit and hit = (positive >= row max), and the two
// backward kernels
//   dlog[i, j] = (exp(logits[i, j] - lse[i]) - [j == labels[i]]) * g[i]
//   dq = gamma * dlog @ d,   dd = gamma * dlog^T @ q.
//
// Replaces dssm_tpu/kernels/pallas_loss.py::in_batch_loss_pallas (kernels
// _fwd_kernel, _bwd_dq_kernel, _bwd_dd_kernel). As there, the [B, B'] logits
// never reach device memory: the forward streams column tiles through an
// online max/sum, the backward kernels recompute each logits tile from q, d
// and the saved lse. Ties count as hits (positive >= max), as in the
// reference kernel. No gradient flows through pos or hit. Any B, B' >= 1 and
// D >= 1 are taken (shared memory does not grow with D); ragged tiles are
// masked; a label outside [0, B') has pos = 0 and no one-hot.
//
// Bound on the H100: operations. At the `full` preset (B = B' = 1024,
// D = 128, f32) the forward does 0.27 GFLOP and each backward kernel 0.54,
// against ~1 MB moved: 4.0 us and 8.0 us at 67 TFLOP/s f32, under 1 us of
// bytes.
//
// Exact f32, not TF32. The products are f32 fmaf chains in k order on the
// CUDA cores. Single-pass TF32 keeps 10 mantissa bits: ~1e-3 of error on a
// logit of up to gamma = 20, ten times the 1e-4 the kernels are held to
// against their plain versions. The k-order chain also gives a logit
// computed twice from the same vectors the same bits, so an exact tie
// counts as a hit, and dd's logits are bit-equal to the forward's.
//
// Design. A block owns a tile of 16 kMR rows of one side (queries for the
// forward and dq, docs for dd) and is rank r of a cluster of 8 blocks that
// share that tile; rank r walks the other side's tiles of 128 rows r, r + 8,
// r + 16, ... (any B'). The tile is 64 rows (kMR = 4), or 80 (kMR = 5)
// where 64-row tiles would take two waves: an H100 holds 15 clusters of 8
// at once (cudaOccupancyMaxActiveClusters), and B = 1024 makes 16 clusters
// of 64 rows but 13 of 80 (104 blocks, one wave).
//  - Products. Thread (ty, tx) of a 16 x 16 grid (a warp is 4 ty x 8 tx)
//    holds a kMR x 8 register tile: own rows ty + 16 ii, streamed rows
//    tx + 16 j. Both operands are staged row-major, rows pitched 36 words,
//    and read as float4 along k: per k a thread reads kMR + 8 words for
//    8 kMR FMAs (2.7 at kMR = 4, 3.1 at 5; the design before this one 0.8).
//    A warp's 8 streamed rows fall on 8 distinct bank quads and its 4 own
//    rows are broadcasts: no bank conflict.
//  - Staging. A 2-slot ring filled by cp.async (16-byte copies where
//    D % 4 == 0 and q, d are 16-byte aligned, else 4-byte; zero-filled past
//    the rows and D), each job's copies issued one job ahead, so they land
//    during the job before: a logits job is 32 columns of D of the own tile
//    and of the streamed tile, a dq / dd job 32 streamed rows by 128 output
//    columns.
//  - Forward. Each thread keeps an online (max, sum, positive logit) per
//    own row over its columns (pos is the very value that entered the max;
//    the label column lies in one rank), merged over the 8 tx lanes by
//    shuffles into stat[warp column][row]. Rank r then merges its 2 kMR rows
//    over the 8 ranks (2 entries each) in rank order through distributed
//    shared memory and writes nll, lse, pos and hit. An empty entry is
//    (-1e30, 0, 0): finite, so exp(m - max) is 0 and never NaN.
//  - dq, dd. After a tile's last logits job each thread writes its kMR x 8
//    dlog (dd: the streamed queries' lse, g and labels staged per tile) into
//    dlog[16 kMR][136] (pitch 136: the scalar stores and float4 reads meet
//    no bank conflict), and the tile's dq / dd jobs add dlog @ tile into a
//    kMR x 8 register tile (output columns 4 tx + 64 h + e) for the rank's
//    whole walk. A pass covers 128 output columns; D = 128 (every preset) is
//    one pass, so each logit is computed once; a wider D recomputes the
//    logits once a pass. At the pass's end each block writes its partial
//    product into dlog, and rank r sums its 2 kMR rows over the 8 ranks in
//    rank order through distributed shared memory and writes gamma times
//    it. No atomics: dq and dd are the same bits from call to call.
// Barriers. __syncthreads at the top of every job: the job's copies have
// landed (each thread waited on its own), the slot fetched next is no
// longer read, and the dlog written at the end of a tile's logits is
// complete before its dq / dd jobs read it. dd's tile scalars are written
// after that barrier and read after one more before the tile's dlog. In
// the forward, cluster_sync (release arrive, acquire wait) orders the stat
// writes before any rank reads them, and a second one keeps every block's
// stat alive until its peers have read it. In dq / dd, a __syncthreads
// ends the pass's reads of dlog, the partials are written, a cluster_sync
// orders them before the peers' reads, and a second cluster_sync keeps them
// until every peer has read them (dlog is written again, or the block
// exits, only after it).
//
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at the
// `full` shapes the forward takes 16.2 us, dq 32.6, dd 29.5, 3.7-4.1x their
// bounds. Per wave of 64-row tiles a launch costs ~1.3 us, the cluster
// barriers, epilogue and merges ~2.4, and each job's copies ~1.2 where
// nothing hides them. The products are bound by the shared-memory reads:
// a thread's kMR + 8 words a k for 8 kMR FMAs need more of the SM's
// 128 bytes a clock than its FMAs need of the FMA pipes until kMR = 8.
// dq and dd use 255 registers and spill 120-176 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kStr = 128;       // streamed rows a tile
constexpr int kRanks = 8;       // blocks a cluster, one per column rank
constexpr int kThreads = 256;   // 16 x 16, a kMR x 8 register tile each
constexpr int kK = 32;          // columns of D a logits job
constexpr int kN = 32;          // streamed rows a dq / dd job
constexpr int kPass = 128;      // output columns a dq / dd pass
constexpr int kStages = 2;      // ring slots
constexpr int kP1 = kK + 4;     // row pitch of a logits job (words)
constexpr int kP2 = kPass;      // row pitch of a dq / dd job
constexpr int kPD = kStr + 8;   // row pitch of dlog
constexpr int kGradJobs = kStr / kN;  // dq / dd jobs a tile
constexpr float kNegInf = -1e30f;

enum Mode { kFwd = 0, kDq = 1, kDd = 2 };

// kMR own rows a thread: a block owns kOwn = 16 kMR rows.
template <int kMR>
struct Tile {
  static constexpr int kOwn = 16 * kMR;
  static constexpr int kRowsPerRank = kOwn / kRanks;
  static constexpr int kSlot = (kOwn + kStr) * kP1;  // floats a ring slot
  static_assert(kN * kP2 <= kSlot, "a dq / dd job fits a slot");
  static constexpr size_t smem_bytes(int mode) {
    return sizeof(float) *
           (kStages * kSlot +
            (mode == kFwd ? 2 * kOwn * 4                    // stat
                          : kOwn * kPD + (mode == kDd ? 3 * kStr : 0)));
  }
};

struct Args {
  const float* q;
  const float* d;
  const int32_t* labels;
  const float* lse_in;  // dq, dd
  const float* g;       // dq, dd
  float* out;           // dq [b, dim] or dd [bg, dim]
  float* nll;           // the forward's outputs, [b] each
  float* lse;
  float* pos;
  float* hit;
  int64_t b, bg;
  int dim, vec;
  float gamma;
};

__device__ __forceinline__ int rows_left(int64_t total, int64_t row0,
                                         int rows) {
  const int64_t left = total - row0;
  return left <= 0 ? 0 : (left < rows ? (int)left : rows);
}

__device__ __forceinline__ float part(float4 v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// dst[r][c] (pitch kPitch) = src[r][c] (row stride ld) for r < kRows,
// c < kCols, by kBytes copies; zero-filled (nothing read) where
// r >= valid_rows or c >= valid_cols. Shapes are compile-time here, so the
// index arithmetic folds away; sm90.cuh's copy_tile (run-time shapes) cost
// the forward ~1.8 us more at B = 512 on an H100.
template <int kRows, int kCols, int kPitch, int kBytes>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t ld, int valid_rows,
                                      int valid_cols) {
  constexpr int ve = kBytes / 4;
  constexpr int per_row = kCols / ve;
  constexpr int n = kRows * per_row;
#pragma unroll
  for (int u = 0; u < (n + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (n % kThreads != 0 && i >= n) break;
    const int r = i / per_row;
    const int c = (i % per_row) * ve;
    const bool ok = r < valid_rows && c < valid_cols;
    dssm::copy_vec<kBytes>(dst + r * kPitch + c, ok ? src + r * ld + c : src,
                           ok);
  }
}

// A block's jobs, in order: passes, each the rank's tiles in order, each kc
// logits jobs (c < kc) then, for dq / dd, kGradJobs jobs of its rows.
struct Cursor {
  int p = 0, ti = 0, c = 0;
  __device__ __forceinline__ void next(int mt, int jt) {
    if (++c < jt) return;
    c = 0;
    if (++ti < mt) return;
    ti = 0;
    ++p;
  }
};

template <int kMR, int kBytes>
__device__ __forceinline__ void fetch_job(float* slot, const float* own,
                                          const float* str, int64_t n_own,
                                          int64_t n_str, int64_t own0,
                                          int rank, int kc, int dim,
                                          const Cursor& job) {
  constexpr int kOwn = Tile<kMR>::kOwn;
  const int64_t t0 = ((int64_t)rank + (int64_t)kRanks * job.ti) * kStr;
  if (job.c < kc) {
    const int k0 = job.c * kK;
    stage<kOwn, kK, kP1, kBytes>(slot, own + own0 * dim + k0, dim,
                                 rows_left(n_own, own0, kOwn), dim - k0);
    stage<kStr, kK, kP1, kBytes>(slot + kOwn * kP1, str + t0 * dim + k0, dim,
                                 rows_left(n_str, t0, kStr), dim - k0);
  } else {
    const int64_t r0 = t0 + (int64_t)(job.c - kc) * kN;
    const int c0 = job.p * kPass;
    const int valid = rows_left(n_str, r0, kN);
    // Past the rows (a ragged tile's last jobs): zero-filled, nothing read.
    stage<kN, kPass, kP2, kBytes>(slot, valid > 0 ? str + r0 * dim + c0 : str,
                                  dim, valid, dim - c0);
  }
}

// acc[ii][j] += own row ty + 16 ii . streamed row tx + 16 j over the job's
// 32 columns, in k order.
template <int kMR>
__device__ __forceinline__ void job_logits(float (&acc)[kMR][8],
                                           const float* slot, int ty,
                                           int tx) {
  const float* a = slot + ty * kP1;
  const float* s = slot + (Tile<kMR>::kOwn + tx) * kP1;
#pragma unroll
  for (int k4 = 0; k4 < kK / 4; ++k4) {
    float4 av[kMR];
#pragma unroll
    for (int ii = 0; ii < kMR; ++ii) {
      av[ii] = *reinterpret_cast<const float4*>(a + ii * 16 * kP1 + 4 * k4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(s + j * 16 * kP1 + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ii = 0; ii < kMR; ++ii) {
          acc[ii][j] = fmaf(part(av[ii], kk), part(bv, kk), acc[ii][j]);
        }
      }
    }
  }
}

// oacc[ii][4 h + e] += dlog[ty + 16 ii][n0 + n] * rows[n][4 tx + 64 h + e]
// over the job's 32 streamed rows n.
template <int kMR>
__device__ __forceinline__ void job_grad(float (&oacc)[kMR][8],
                                         const float* dlog, int n0,
                                         const float* slot, int ty, int tx) {
  const float* dl = dlog + ty * kPD + n0;
  const float* s = slot + 4 * tx;
#pragma unroll
  for (int n4 = 0; n4 < kN / 4; ++n4) {
    float4 dv[kMR];
#pragma unroll
    for (int ii = 0; ii < kMR; ++ii) {
      dv[ii] = *reinterpret_cast<const float4*>(dl + ii * 16 * kPD + 4 * n4);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = s + (4 * n4 + e) * kP2;
      const float4 s0 = *reinterpret_cast<const float4*>(row);
      const float4 s1 = *reinterpret_cast<const float4*>(row + 64);
#pragma unroll
      for (int ii = 0; ii < kMR; ++ii) {
        const float w = part(dv[ii], e);
        oacc[ii][0] = fmaf(w, s0.x, oacc[ii][0]);
        oacc[ii][1] = fmaf(w, s0.y, oacc[ii][1]);
        oacc[ii][2] = fmaf(w, s0.z, oacc[ii][2]);
        oacc[ii][3] = fmaf(w, s0.w, oacc[ii][3]);
        oacc[ii][4] = fmaf(w, s1.x, oacc[ii][4]);
        oacc[ii][5] = fmaf(w, s1.y, oacc[ii][5]);
        oacc[ii][6] = fmaf(w, s1.z, oacc[ii][6]);
        oacc[ii][7] = fmaf(w, s1.w, oacc[ii][7]);
      }
    }
  }
}

// (m, s, p) <- the online softmax state of both (m, s, p) and (mo, so, po).
__device__ __forceinline__ void merge(float& m, float& s, float& p, float mo,
                                      float so, float po) {
  const float mn = fmaxf(m, mo);
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
  p += po;
}

template <int kMode, int kMR>
__global__ void __launch_bounds__(kThreads, 1)
    in_batch_loss_kernel(const Args A) {
  using T = Tile<kMR>;
  constexpr int kOwn = T::kOwn;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                      // [kStages][kSlot]
  float* dlog = ring + kStages * T::kSlot;  // dq, dd: [kOwn][kPD]
  float4* stat = reinterpret_cast<float4*>(dlog);  // forward: [2][kOwn]
  float* lse_s = dlog + kOwn * kPD;        // dd: [kStr] a tile's queries'
  float* g_s = lse_s + kStr;               // ... g
  int32_t* lab_s = reinterpret_cast<int32_t*>(g_s + kStr);  // ... labels

  constexpr bool kIsDd = kMode == kDd;
  const float* own = kIsDd ? A.d : A.q;
  const float* str = kIsDd ? A.q : A.d;
  const int64_t n_own = kIsDd ? A.bg : A.b;
  const int64_t n_str = kIsDd ? A.b : A.bg;
  const int dim = A.dim;
  const int rank = (int)dssm::cluster_rank();
  const int64_t own0 = (int64_t)(blockIdx.x / kRanks) * kOwn;
  const int64_t tiles = (n_str + kStr - 1) / kStr;
  const int mt = rank < tiles ? (int)((tiles - 1 - rank) / kRanks + 1) : 0;
  const int kc = (dim + kK - 1) / kK;
  const int jt = kc + (kMode == kFwd ? 0 : kGradJobs);
  const int passes = kMode == kFwd ? 1 : (dim + kPass - 1) / kPass;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8;  // own rows ty + 16 ii
  const int tx = (warp % 2) * 8 + lane % 8;  // streamed rows tx + 16 j

  // The own rows' label (forward, dq), lse and g (dq).
  int32_t lab[kMR];
  float lse_r[kMR], g_r[kMR];
#pragma unroll
  for (int ii = 0; ii < kMR; ++ii) {
    const int64_t i = own0 + ty + 16 * ii;
    const bool ok = i < n_own;
    lab[ii] = !kIsDd && ok ? A.labels[i] : -1;
    lse_r[ii] = kMode == kDq && ok ? A.lse_in[i] : 0.f;
    g_r[ii] = kMode == kDq && ok ? A.g[i] : 0.f;
  }

  // The jobs' copies, kStages - 1 jobs ahead of the products.
  Cursor fetch;
  int fetch_slot = 0;
  auto fetch_next = [&]() {
    if (mt > 0 && fetch.p < passes) {
      float* slot = ring + fetch_slot * T::kSlot;
      if (A.vec == 16) {
        fetch_job<kMR, 16>(slot, own, str, n_own, n_str, own0, rank, kc, dim,
                           fetch);
      } else {
        fetch_job<kMR, 4>(slot, own, str, n_own, n_str, own0, rank, kc, dim,
                          fetch);
      }
      fetch.next(mt, jt);
    }
    dssm::cp_async_commit();
    fetch_slot = fetch_slot + 1 == kStages ? 0 : fetch_slot + 1;
  };
  for (int s = 0; s < kStages - 1; ++s) fetch_next();

  float m_run[kMR], s_run[kMR], pos[kMR];
#pragma unroll
  for (int ii = 0; ii < kMR; ++ii) {
    m_run[ii] = kNegInf;
    s_run[ii] = 0.f;
    pos[ii] = 0.f;
  }
  float acc[kMR][8];
  float oacc[kMR][8];
  int slot_i = 0;
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int ii = 0; ii < kMR; ++ii) {
#pragma unroll
      for (int e = 0; e < 8; ++e) oacc[ii][e] = 0.f;
    }
    for (int ti = 0; ti < mt; ++ti) {
      const int64_t t0 = ((int64_t)rank + (int64_t)kRanks * ti) * kStr;
      for (int c = 0; c < jt; ++c) {
        dssm::cp_async_wait(kStages - 2);  // this job has landed (own copies)
        __syncthreads();  // ... everyone's; the slot fetched next is free
        fetch_next();
        const float* slot = ring + slot_i * T::kSlot;
        slot_i = slot_i + 1 == kStages ? 0 : slot_i + 1;
        if (kMode != kFwd && c >= kc) {
          job_grad<kMR>(oacc, dlog, (c - kc) * kN, slot, ty, tx);
          continue;
        }
        if (c == 0) {
#pragma unroll
          for (int ii = 0; ii < kMR; ++ii) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[ii][e] = 0.f;
          }
          if (kIsDd && threadIdx.x < kStr) {
            const int64_t i = t0 + threadIdx.x;
            lse_s[threadIdx.x] = i < n_str ? A.lse_in[i] : 0.f;
            g_s[threadIdx.x] = i < n_str ? A.g[i] : 0.f;
            lab_s[threadIdx.x] = i < n_str ? A.labels[i] : -1;
          }
        }
        job_logits<kMR>(acc, slot, ty, tx);
        if (c + 1 < kc) continue;
        // The tile's logits are complete.
        if (kMode == kFwd) {
#pragma unroll
          for (int ii = 0; ii < kMR; ++ii) {
            float l[8];
            float tmax = kNegInf;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int64_t n = t0 + tx + 16 * jj;
              l[jj] = A.gamma * acc[ii][jj];
              if (n < n_str) {
                tmax = fmaxf(tmax, l[jj]);
                if (n == lab[ii]) pos[ii] = l[jj];
              }
            }
            const float mn = fmaxf(m_run[ii], tmax);
            float sum = s_run[ii] * expf(m_run[ii] - mn);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              if (t0 + tx + 16 * jj < n_str) sum += expf(l[jj] - mn);
            }
            m_run[ii] = mn;
            s_run[ii] = sum;
          }
          continue;
        }
        if (kIsDd) __syncthreads();  // the tile's scalars are in
#pragma unroll
        for (int ii = 0; ii < kMR; ++ii) {
          const int r = ty + 16 * ii;
          const int64_t own_row = own0 + r;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int n = tx + 16 * jj;
            float dl = 0.f;
            if (own_row < n_own && t0 + n < n_str) {
              const float l = A.gamma * acc[ii][jj];
              if (kIsDd) {
                const float hot = (int64_t)lab_s[n] == own_row ? 1.f : 0.f;
                dl = (expf(l - lse_s[n]) - hot) * g_s[n];
              } else {
                const float hot = lab[ii] == t0 + n ? 1.f : 0.f;
                dl = (expf(l - lse_r[ii]) - hot) * g_r[ii];
              }
            }
            dlog[r * kPD + n] = dl;
          }
        }
      }
    }
    if (kMode == kFwd) break;

    // The pass's partial products, summed over the cluster in rank order.
    __syncthreads();  // every read of dlog is done: it takes the partials
#pragma unroll
    for (int ii = 0; ii < kMR; ++ii) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float4*>(dlog + (ty + 16 * ii) * kPD + 4 * tx +
                                   64 * h) =
            make_float4(oacc[ii][4 * h], oacc[ii][4 * h + 1],
                        oacc[ii][4 * h + 2], oacc[ii][4 * h + 3]);
      }
    }
    dssm::cluster_sync();  // every rank's partials are written
    for (int it = threadIdx.x; it < T::kRowsPerRank * 32; it += kThreads) {
      const int r = rank * T::kRowsPerRank + it / 32;
      const int c4 = it % 32;
      float4 v[kRanks];
#pragma unroll
      for (int q = 0; q < kRanks; ++q) {
        v[q] = dssm::ld_cluster4(dssm::peer_addr(dlog + r * kPD + 4 * c4, q));
      }
      float4 t = v[0];
#pragma unroll
      for (int q = 1; q < kRanks; ++q) {
        t.x += v[q].x;
        t.y += v[q].y;
        t.z += v[q].z;
        t.w += v[q].w;
      }
      const int64_t row = own0 + r;
      if (row < n_own) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = p * kPass + 4 * c4 + e;
          if (col < dim) A.out[row * dim + col] = A.gamma * part(t, e);
        }
      }
    }
    dssm::cluster_sync();  // every peer has read this block's partials
  }
  if (kMode != kFwd) return;

  // The 8 tx lanes of a row, then both warp columns and the 8 ranks.
#pragma unroll
  for (int ii = 0; ii < kMR; ++ii) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[ii], o);
      const float so = __shfl_xor_sync(0xffffffffu, s_run[ii], o);
      const float po = __shfl_xor_sync(0xffffffffu, pos[ii], o);
      merge(m_run[ii], s_run[ii], pos[ii], mo, so, po);
    }
    if (lane % 8 == 0) {
      stat[(warp % 2) * kOwn + ty + 16 * ii] =
          make_float4(m_run[ii], s_run[ii], pos[ii], 0.f);
    }
  }
  dssm::cluster_sync();  // every rank's stat is written
  if (threadIdx.x < T::kRowsPerRank) {
    const int r = rank * T::kRowsPerRank + threadIdx.x;
    float4 e[2 * kRanks];
#pragma unroll
    for (int q = 0; q < kRanks; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        e[2 * q + h] =
            dssm::ld_cluster4(dssm::peer_addr(&stat[h * kOwn + r], q));
      }
    }
    float m = kNegInf, s = 0.f, p = 0.f;
#pragma unroll
    for (int k = 0; k < 2 * kRanks; ++k) {
      merge(m, s, p, e[k].x, e[k].y, e[k].z);
    }
    const int64_t i = own0 + r;
    if (i < n_own) {
      const float l = m + logf(s);
      A.lse[i] = l;
      A.nll[i] = l - p;
      A.pos[i] = p;
      A.hit[i] = p >= m ? 1.f : 0.f;
    }
  }
  dssm::cluster_sync();  // every peer has read this block's stat
}

constexpr int kNoWave = -2;  // try_rows: the grid would not fit one wave

// Launch with own tiles of 16 kMR rows; kNoWave (nothing launched) where
// one_wave and the card cannot hold every cluster at once
// (cudaOccupancyMaxActiveClusters).
template <int kMode, int kMR>
int try_rows(const Args& a, bool one_wave, cudaStream_t stream) {
  using T = Tile<kMR>;
  auto kernel = in_batch_loss_kernel<kMode, kMR>;
  constexpr size_t smem = T::smem_bytes(kMode);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  // Kept per kernel: the device its shared-memory attribute was raised
  // for, and the clusters that device holds at once.
  static int attr_device = -1, max_clusters = 0;
  cudaLaunchAttribute attr;
  if (device != attr_device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t probe =
        dssm::cluster_config(kRanks, kThreads, kRanks, smem, stream, &attr);
    err = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &probe);
    if (err != cudaSuccess) return (int)err;
    attr_device = device;
  }
  const long long n_own = kMode == kDd ? a.bg : a.b;
  const long long clusters = (n_own + T::kOwn - 1) / T::kOwn;
  if (one_wave && clusters > max_clusters) return kNoWave;
  if (clusters * kRanks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg =
      dssm::cluster_config((unsigned int)(clusters * kRanks), kThreads,
                           kRanks, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Own tiles of 64 rows, or of 80 where that puts a grid the card cannot
// hold at once into one wave (B = 1024: 16 clusters of 64 rows, 13 of 80,
// where an H100 holds 15 clusters of 8 blocks).
template <int kMode>
int launch(const Args& a, void* stream) {
  if (a.b <= 0 || a.bg <= 0 || a.dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = try_rows<kMode, 4>(a, true, s);
  if (rc == kNoWave) rc = try_rows<kMode, 5>(a, true, s);
  if (rc == kNoWave) rc = try_rows<kMode, 4>(a, false, s);
  return rc;
}

Args make_args(const void* q, const void* d, const void* labels,
               long long b, long long bg, int dim, float gamma) {
  Args a = {};
  a.q = (const float*)q;
  a.d = (const float*)d;
  a.labels = (const int32_t*)labels;
  a.b = b;
  a.bg = bg;
  a.dim = dim;
  a.gamma = gamma;
  a.vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(d) % 16 == 0
              ? 16
              : 4;
  return a;
}

}  // namespace

// q: [b, dim] f32, d: [bg, dim] f32, labels: [b] int32; nll, lse, pos, hit:
// [b] f32. Returns cudaGetLastError().
extern "C" int dssm_in_batch_loss_fwd(const void* q, const void* d,
                                      const void* labels, void* nll,
                                      void* lse, void* pos, void* hit,
                                      long long b, long long bg, int dim,
                                      float gamma, void* stream) {
  Args a = make_args(q, d, labels, b, bg, dim, gamma);
  a.nll = (float*)nll;
  a.lse = (float*)lse;
  a.pos = (float*)pos;
  a.hit = (float*)hit;
  return launch<kFwd>(a, stream);
}

// lse: [b] f32 from the forward, g: [b] f32 (the gradient of each row's
// nll); dq: [b, dim] f32. Returns cudaGetLastError().
extern "C" int dssm_in_batch_loss_dq(const void* q, const void* d,
                                     const void* labels, const void* lse,
                                     const void* g, void* dq, long long b,
                                     long long bg, int dim, float gamma,
                                     void* stream) {
  Args a = make_args(q, d, labels, b, bg, dim, gamma);
  a.lse_in = (const float*)lse;
  a.g = (const float*)g;
  a.out = (float*)dq;
  return launch<kDq>(a, stream);
}

// dd: [bg, dim] f32. Returns cudaGetLastError().
extern "C" int dssm_in_batch_loss_dd(const void* q, const void* d,
                                     const void* labels, const void* lse,
                                     const void* g, void* dd, long long b,
                                     long long bg, int dim, float gamma,
                                     void* stream) {
  Args a = make_args(q, d, labels, b, bg, dim, gamma);
  a.lse_in = (const float*)lse;
  a.g = (const float*)g;
  a.out = (float*)dd;
  return launch<kDd>(a, stream);
}
