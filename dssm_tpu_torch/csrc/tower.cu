// Fused dense tower forward: per layer z = h @ W + b, tanh or relu, with an
// optional L2 norm at the end, for 1 to 8 layers of any widths.
//
// Replaces the forward of dssm_tpu/kernels/pallas_tower.py::
// dense_tower_pallas (kernel _tower_kernel), with its arithmetic: f32
// accumulation, f32 bias and activation, the activation cast back to the
// input dtype between layers, the last layer kept in f32, and
// y = h / max(||h||, eps) when normalizing. Asked for residuals (training),
// it also writes every layer's activation in f32, before the cast that
// feeds the next layer, as the Pallas kernel does; its backward (plain
// matmuls in the reference too) reads them. A serving call passes no
// residual pointers and writes y only. The reference's norm residual is
// recomputed by the backward from the last activation.
//
// Bound on the H100: bytes. At the `full` preset (x [1024, 300] bf16,
// W1 [300, 300], W2 [300, 128] bf16, y [1024, 128] f32) it moves ~1.4 MB
// and does 0.26 GFLOP: ~0.4 us of memory and ~0.3 us of bf16 tensor-core
// time. What holds a fused tower far above that is latency: a block that
// streams the weight set (257 KB bf16) from L2 into shared memory takes
// thousands of cycles whatever its row count; mma.sync waits on the
// ldmatrix before it, so a warp's k steps must not wait on each other; and
// the layers follow one another. The design before this one re-read every
// weight from L2 into registers for each 4-row block, with scalar f32 FMAs.
//
// Design. A cluster of C blocks (8 up to 256 rows, 4 up to 512, else 2)
// takes a tile of BM = 16 x kMT rows, BM the fewest that keep the grid in
// one wave (cudaOccupancyMaxActiveClusters). The blocks split every layer's
// output columns (n8 tiles) among them, so each streams 1/C of the weights,
// and exchange activations through distributed shared memory. Rows depend
// only on rows, so clusters never wait for each other.
//  - Each block loads the x tile and keeps the tile's whole activation
//    (every column) in shared memory between layers, in the input dtype
//    (the operand of the next product), two buffers ping-ponged, K
//    zero-padded to 16; a row's stride is an odd number of 16-byte units,
//    so ldmatrix and the f32 loads meet no bank conflict. After a layer,
//    each block pushes its columns into the other blocks (16-byte remote
//    stores) and a cluster barrier separates the layers.
//  - A job is a chunk of one layer's K (its whole K where that fits and
//    costs least) against a "pass" of the block's output tiles, chunk and
//    pass width those that fit and cost the fewest k steps of warp rounds
//    (layout_for): its slab of W and its bias come in through a ring
//    of 2-4 stages by cp.async (16, 8 or 4 bytes, as the row pitch and the
//    pointer allow; zero-filled past din and dout), so the next layer's
//    slab lands during this layer's work.
//  - A warp takes units, one m16 tile of rows against a pair of n8 tiles,
//    over the whole slab, with four independent accumulator phases so its
//    k steps do not wait on each other. bf16: mma.sync m16n8k16 (bf16 x
//    bf16, f32 accumulate), A fragments from the activation tile by
//    ldmatrix, B fragments from the K-major slab by ldmatrix.trans. f32: the
//    same units and fragments, each product an exact f32 fmaf on the CUDA
//    cores (no TF32). Where K takes several chunks, the unit's thread keeps
//    its running sums in shared memory between them.
//  - Epilogue in registers: f32 bias, tanh / relu, the f32 residual and
//    (last layer) y stored as float2 pairs; the value rounded to the input
//    dtype into the next activation buffer (zero past dout). The last
//    layer's row sums of squares go through quad shuffles and shared
//    atomics into the block's own sums; with normalize, after a cluster
//    barrier, each block adds the cluster's sums in rank order (distributed
//    shared memory) and rescales its columns of y.
// Wide layers: where the widest layer input takes more than kTileBytes a
// row, the tile is not kept. Each job then reads its chunk of the layer's
// input into shared memory (x for the first layer, else the f32 residual
// of the layer before, rounded to the input dtype), and the cluster barrier
// between layers orders the residual stores before those reads. The wrapper
// passes residual buffers for such widths even to a serving call. The
// kernel is built for each mode (kWide), so the tile mode carries none of
// this code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // the cluster, distributed shared memory, cp.async

#define DSSM_TOWER_MAX_LAYERS 8

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block
constexpr int kNoRoom = -1;  // try_tower: the widths leave no room
// The widest layer input, in bytes a row, whose activation tile is kept in
// shared memory (kernels/tower.py's _TILE_BYTES): 1,536 f32 or 3,072 bf16
// columns, for which a 16-row tile always fits.
constexpr int kTileBytes = 6144;

struct TowerLayers {
  const void* w[DSSM_TOWER_MAX_LAYERS];
  const void* b[DSSM_TOWER_MAX_LAYERS];
  float* hs[DSSM_TOWER_MAX_LAYERS];  // per-layer f32 residuals, or null
  int wvec[DSSM_TOWER_MAX_LAYERS];   // bytes per copy of W's rows
  int bvec[DSSM_TOWER_MAX_LAYERS];   // ... and of b
  int dims[DSSM_TOWER_MAX_LAYERS + 1];
  int num_layers;
};

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// n8 column tiles of a layer's (padded) output.
__host__ __device__ __forceinline__ int out_tiles(int dout) {
  return round16(dout) / 8;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dst[r][c] (row stride dld) = src[r][c] (row stride sld) rounded to T, for
// r < rows, c < cols; zero where r >= valid_rows or c >= valid_cols. Each
// thread keeps kBatch loads in flight.
template <typename T, typename S>
__device__ __forceinline__ void load_rounded(T* dst, int dld, const S* src,
                                             int64_t sld, int rows, int cols,
                                             int valid_rows, int valid_cols) {
  constexpr int kBatch = 8;
  const int n = rows * cols;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / cols;
      const int c = i - r * cols;
      v[u] = i < n && r < valid_rows && c < valid_cols
                 ? to_f32(src[r * sld + c])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) put(dst + (i / cols) * dld + i % cols, v[u]);
    }
  }
}

// Columns [c0, c0 + cols) of the [rows][ld] tile at buf (cols a multiple
// of 8), from this block into the same place in every other block of the
// cluster, 16 bytes a store.
template <typename T>
__device__ __forceinline__ void push_columns(const T* buf, int ld, int rows,
                                             int c0, int cols, int rank,
                                             int nranks) {
  constexpr int ve = 16 / (int)sizeof(T);
  dssm::for_grid<kThreads>(rows, cols / ve, [&](int r, int v) {
    const T* src = buf + r * ld + c0 + v * ve;
    const uint4 val = *reinterpret_cast<const uint4*>(src);
    for (int q = 1; q < nranks; ++q) {
      dssm::st_cluster(dssm::peer_addr(src, (rank + q) % nranks), val);
    }
  });
}

// ---- the sequence of jobs -----------------------------------------------

// A run of n8 column tiles of a layer: [first, first + count).
struct Slice {
  int first, count;
};

// This block's share of a layer: its output tiles, the cluster's passes
// over them (following the widest share), and the chunks of K a pass takes.
// In shared memory, one a layer.
struct Plan {
  Slice mine;
  int passes, chunks;
};

// A job is one chunk (up to kc rows of W; a layer's whole K wherever it
// fits) of one pass (up to pass_tiles of the block's output tiles) of one
// layer: one ring slot. Every block of the cluster walks the same sequence.
struct Cursor {
  int l = 0, p = 0, c = 0;
  __device__ __forceinline__ bool done(int num_layers) const {
    return l >= num_layers;
  }
  __device__ __forceinline__ void next(const Plan* plan) {
    if (++c < plan[l].chunks) return;
    c = 0;
    if (++p < plan[l].passes) return;
    p = 0;
    ++l;
  }
  // This block's tiles in this pass (0 to pass_tiles).
  __device__ __forceinline__ Slice pass(const Plan* plan,
                                        int pass_tiles) const {
    const Slice s = plan[l].mine;
    const int left = s.count - p * pass_tiles;
    return {s.first + p * pass_tiles,
            left < 0 ? 0 : (left < pass_tiles ? left : pass_tiles)};
  }
};

// Rows of a layer's K in chunk c (a multiple of 16).
__device__ __forceinline__ int chunk_rows(int din, int kc, int c) {
  const int left = round16(din) - c * kc;
  return left < kc ? left : kc;
}

template <typename T>
__device__ __forceinline__ void fetch_job(T* slot, int rld, int kc,
                                          int pass_tiles,
                                          const TowerLayers& L,
                                          const Plan* plan,
                                          const Cursor& cur) {
  const int din = L.dims[cur.l];
  const int dout = L.dims[cur.l + 1];
  const Slice ps = cur.pass(plan, pass_tiles);
  const int n0 = ps.first * 8;
  const int k0 = cur.c * kc;
  if (ps.count == 0) return;
  dssm::copy_tile<kThreads, T>(
      slot, rld, static_cast<const T*>(L.w[cur.l]) + (int64_t)k0 * dout + n0,
      dout, chunk_rows(din, kc, cur.c), ps.count * 8, din - k0, dout - n0,
      L.wvec[cur.l]);
  // The pass's bias, after the chunk's kc rows.
  dssm::copy_tile<kThreads, T>(slot + kc * rld, 0,
                               static_cast<const T*>(L.b[cur.l]) + n0, 0, 1,
                               ps.count * 8, 1, dout - n0, L.bvec[cur.l]);
}

// ---- the product of a unit: a policy per input dtype --------------------
// A unit is one m16 tile of the block's rows (mt) against one pair of the
// pass's n8 tiles (its second tile may be past the pass: then it repeats
// the first and its result is dropped), over one chunk of K. k step
// ks adds into phase ks % phases(), so the warp's MMAs (FMAs) do not wait
// on each other. Both leave acc[ph][e][i] summed over phases in acc[0]:
// the m16n8 C fragment of mma.sync for tile e of the pair, row
// mt * 16 + lane/4 + 8*(i/2), column (lane%4)*2 + i%2.

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(dssm::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(dssm::smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kPhases = 4;

// bf16: tensor cores. `a` is the activation tile at the chunk's first k,
// `slot` the job's [kpad][rld] slab of W, t0 / t1 the pair's tiles, `kpad`
// the chunk's rows.
__device__ __forceinline__ void unit_product(float (&acc)[kPhases][2][4],
                                             const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* slot,
                                             int rld, int kpad, int mt,
                                             int t0, int t1, int lane) {
  const __nv_bfloat16* arow = a + (mt * 16 + lane % 16) * lda + (lane / 16) * 8;
  // lanes 0-15 read tile t0's k rows, lanes 16-31 tile t1's
  const __nv_bfloat16* brow =
      slot + (lane % 16) * rld + (lane < 16 ? t0 : t1) * 8;
  const int steps = kpad / 16;
  int ks = 0;
  for (; ks + kPhases <= steps; ks += kPhases) {  // every load, then MMAs
    uint32_t af[kPhases][4], bf[kPhases][4];
#pragma unroll
    for (int ph = 0; ph < kPhases; ++ph) {
      ldmatrix_x4(af[ph], arow + (ks + ph) * 16);
      ldmatrix_x4_trans(bf[ph], brow + (ks + ph) * 16 * rld);
    }
#pragma unroll
    for (int ph = 0; ph < kPhases; ++ph) {
      mma_bf16(acc[ph][0], af[ph], bf[ph][0], bf[ph][1]);
      mma_bf16(acc[ph][1], af[ph], bf[ph][2], bf[ph][3]);
    }
  }
  for (; ks < steps; ++ks) {  // the last steps, into phase 0
    uint32_t af[4], bf[4];
    ldmatrix_x4(af, arow + ks * 16);
    ldmatrix_x4_trans(bf, brow + ks * 16 * rld);
    mma_bf16(acc[0][0], af, bf[0], bf[1]);
    mma_bf16(acc[0][1], af, bf[2], bf[3]);
  }
}

// c (an m16n8 C fragment) += rows lo / hi (k, k + 1) x B rows k (u) and
// k + 1 (v): exact f32 fmaf, k in order.
__device__ __forceinline__ void fma_pair(float (&c)[4], float2 lo, float2 hi,
                                         float2 u, float2 v) {
  c[0] = fmaf(lo.y, v.x, fmaf(lo.x, u.x, c[0]));
  c[1] = fmaf(lo.y, v.y, fmaf(lo.x, u.y, c[1]));
  c[2] = fmaf(hi.y, v.x, fmaf(hi.x, u.x, c[2]));
  c[3] = fmaf(hi.y, v.y, fmaf(hi.x, u.y, c[3]));
}

// f32: exact fmaf on the CUDA cores, same fragment ownership; k pair kp
// adds into phase kp % kPhases, k in order within a phase.
__device__ __forceinline__ void unit_product(float (&acc)[kPhases][2][4],
                                             const float* a, int lda,
                                             const float* slot, int rld,
                                             int kpad, int mt, int t0, int t1,
                                             int lane) {
  const float* arow = a + (mt * 16 + lane / 4) * lda;
  const float* b0col = slot + t0 * 8 + (lane % 4) * 2;
  const float* b1col = slot + t1 * 8 + (lane % 4) * 2;
  int k = 0;
  for (; k + 2 * kPhases <= kpad; k += 2 * kPhases) {
    float2 lo[kPhases], hi[kPhases], u[kPhases][2], v[kPhases][2];
#pragma unroll
    for (int ph = 0; ph < kPhases; ++ph) {  // every load, then the FMAs
      const int kk = k + 2 * ph;
      lo[ph] = *reinterpret_cast<const float2*>(arow + kk);
      hi[ph] = *reinterpret_cast<const float2*>(arow + 8 * lda + kk);
      u[ph][0] = *reinterpret_cast<const float2*>(b0col + kk * rld);
      v[ph][0] = *reinterpret_cast<const float2*>(b0col + (kk + 1) * rld);
      u[ph][1] = *reinterpret_cast<const float2*>(b1col + kk * rld);
      v[ph][1] = *reinterpret_cast<const float2*>(b1col + (kk + 1) * rld);
    }
#pragma unroll
    for (int ph = 0; ph < kPhases; ++ph) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fma_pair(acc[ph][e], lo[ph], hi[ph], u[ph][e], v[ph][e]);
      }
    }
  }
  for (; k < kpad; k += 2) {  // the last pairs, into phase 0
    const float2 lo = *reinterpret_cast<const float2*>(arow + k);
    const float2 hi = *reinterpret_cast<const float2*>(arow + 8 * lda + k);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* bc = (e == 0 ? b0col : b1col) + k * rld;
      fma_pair(acc[0][e], lo, hi, *reinterpret_cast<const float2*>(bc),
               *reinterpret_cast<const float2*>(bc + rld));
    }
  }
}

template <bool kRelu>
__device__ __forceinline__ float activate(float z) {
  return kRelu ? fmaxf(z, 0.f) : tanhf(z);
}

__device__ __forceinline__ void store_act(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_act(__nv_bfloat16* p, float v0,
                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// out[0..1] = (v0, v1) for the columns col, col + 1 that are < dout.
__device__ __forceinline__ void store_pair(float* out, float v0, float v1,
                                           int col, int dout) {
  if (col + 1 < dout && (dout & 1) == 0) {
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  } else {
    if (col < dout) out[0] = v0;
    if (col + 1 < dout) out[1] = v1;
  }
}

template <typename T, bool kRelu, int kMT, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
    dense_tower_kernel(const T* __restrict__ x, float* __restrict__ y,
                       const TowerLayers L, int64_t batch, int lda, int rld,
                       int kc, int pass_tiles, int stages, int xvec,
                       int normalize, float eps) {
  constexpr int BM = 16 * kMT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The activation tile, [BM][lda] x 2; wide: one chunk of it, [BM][lda].
  T* act0 = reinterpret_cast<T*>(smem_raw);
  T* ring = act0 + (kWide ? 1 : 2) * BM * lda;  // [stages][kc + 1][rld]
  const int slot_elems = (kc + 1) * rld;
  // The block's row sums of squares over its columns, then the rows' norms.
  float* ss = reinterpret_cast<float*>(ring + stages * slot_elems);  // [BM]
  float* norm = ss + BM;                                             // [BM]
  Plan* plan = reinterpret_cast<Plan*>(norm + BM);  // [DSSM_TOWER_MAX_LAYERS]
  // A pass's sums over its earlier chunks, where K takes several:
  // [BM][pass_tiles * 8], each element kept by the thread that owns it.
  float* part_sum = reinterpret_cast<float*>(plan + DSSM_TOWER_MAX_LAYERS);
  const int part_ld = pass_tiles * 8;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rank = (int)dssm::cluster_rank();
  const int nranks = (int)dssm::cluster_size();
  const int64_t row0 = (int64_t)(blockIdx.x / nranks) * BM;
  const int rows = batch - row0 < BM ? (int)(batch - row0) : BM;
  const int d0 = L.dims[0];
  // Remote stores wait for every block of the cluster to run (cluster_wait
  // below); they go only where the receiving block writes nothing before.
  dssm::cluster_arrive_relaxed();

  if (threadIdx.x < L.num_layers) {
    const int l = threadIdx.x;
    const int tiles = out_tiles(L.dims[l + 1]);
    const int t0 = rank * tiles / nranks;
    const int widest = (tiles + nranks - 1) / nranks;
    plan[l] = {{t0, (rank + 1) * tiles / nranks - t0},
               (widest + pass_tiles - 1) / pass_tiles,
               (round16(L.dims[l]) + kc - 1) / kc};
  }
  for (int i = threadIdx.x; i < BM; i += kThreads) ss[i] = 0.f;
  __syncthreads();

  // The x tile joins the first job's cp.async group.
  if (!kWide) {
    dssm::copy_tile<kThreads, T>(act0, lda, x + row0 * d0, d0, BM,
                                 round16(d0), rows, d0, xvec);
  }
  Cursor fetch;
  for (int s = 0; s < stages - 1; ++s) {
    if (!fetch.done(L.num_layers)) {
      fetch_job<T>(ring + s * slot_elems, rld, kc, pass_tiles, L, plan,
                   fetch);
      fetch.next(plan);
    }
    dssm::cp_async_commit();
  }
  dssm::cluster_wait();  // every block of the cluster runs: remote stores go

  Cursor comp;
  for (int j = 0; !comp.done(L.num_layers); ++j) {
    dssm::cp_async_wait(stages - 2);  // job j has landed (this thread's copies)
    __syncthreads();            // ... everyone's; slot j - 1 is free
    if (!fetch.done(L.num_layers)) {
      fetch_job<T>(ring + ((j + stages - 1) % stages) * slot_elems, rld, kc,
                   pass_tiles, L, plan, fetch);
      fetch.next(plan);
    }
    dssm::cp_async_commit();

    const int l = comp.l;
    const int dout = L.dims[l + 1];
    const bool last = l + 1 == L.num_layers;
    const bool first_chunk = comp.c == 0;
    const bool last_chunk = comp.c + 1 == plan[l].chunks;
    const Slice ps = comp.pass(plan, pass_tiles);
    const int krows = chunk_rows(L.dims[l], kc, comp.c);
    const T* a_in = act0 + (l & 1) * BM * lda + comp.c * kc;
    T* a_out = act0 + ((l + 1) & 1) * BM * lda;
    // Wide: the chunk of this layer's input, after the last job's reads
    // (kept from the pass before where the layer's K is one chunk).
    if (kWide && (comp.p == 0 || plan[l].chunks > 1)) {
      const int din = L.dims[l];
      const int64_t at = row0 * din + comp.c * kc;
      if (l == 0) {
        load_rounded(act0, lda, x + at, din, BM, krows, rows,
                     din - comp.c * kc);
      } else {
        load_rounded(act0, lda, L.hs[l - 1] + at, din, BM, krows, rows,
                     din - comp.c * kc);
      }
      __syncthreads();
    }
    if (kWide) a_in = act0;
    const T* slot = ring + (j % stages) * slot_elems;
    const T* bias = slot + kc * rld;  // the pass's, from its first column
    float* hs = L.hs[l];
    const int units = kMT * ((ps.count + 1) / 2);
    for (int u = warp; u < units; u += kWarps) {
      const int mt = u % kMT;
      const int t0 = 2 * (u / kMT);
      const bool two = t0 + 1 < ps.count;
      float acc[kPhases][2][4] = {};
      unit_product(acc, a_in, lda, slot, rld, krows, mt, t0,
                   two ? t0 + 1 : t0, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e == 1 && !two) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int ph = 1; ph < kPhases; ++ph) acc[0][e][i] += acc[ph][e][i];
          // earlier chunks' sums: this thread's own elements of part_sum
          float* ps_i = part_sum + (mt * 16 + lane / 4 + 8 * (i / 2)) *
                                       part_ld + (t0 + e) * 8 +
                        (lane % 4) * 2 + i % 2;
          if (!first_chunk) acc[0][e][i] += *ps_i;
          if (!last_chunk) *ps_i = acc[0][e][i];
        }
      }
      if (!last_chunk) continue;
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e == 1 && !two) break;
        const int col = (ps.first + t0 + e) * 8 + (lane % 4) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + lane / 4 + 8 * h;
          const T* bp = bias + (t0 + e) * 8 + (lane % 4) * 2;
          float v0 = acc[0][e][2 * h] + to_f32(bp[0]);
          float v1 = acc[0][e][2 * h + 1] + to_f32(bp[1]);
          v0 = col < dout ? activate<kRelu>(v0) : 0.f;
          v1 = col + 1 < dout ? activate<kRelu>(v1) : 0.f;
          if (r < rows) {
            const int64_t g = (row0 + r) * dout + col;
            if (hs != nullptr) store_pair(hs + g, v0, v1, col, dout);
            if (last) store_pair(y + g, v0, v1, col, dout);
          }
          if (last) {
            part[h] = fmaf(v1, v1, fmaf(v0, v0, part[h]));
          } else if (!kWide) {
            store_act(a_out + r * lda + col, v0, v1);
          }
        }
      }
      if (last && normalize) {  // the quad's sums, into the block's
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = part[h];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (lane % 4 == 0) atomicAdd(&ss[mt * 16 + lane / 4 + 8 * h], s);
        }
      }
    }
    if (!last && last_chunk && comp.p + 1 == plan[l].passes) {  // to the others
      if (!kWide) {
        __syncthreads();
        push_columns(a_out, lda, BM, plan[l].mine.first * 8,
                     plan[l].mine.count * 8, rank, nranks);
      }
      dssm::cluster_sync();
    }
    comp.next(plan);
  }

  if (normalize) {  // y = h / max(||h||, eps) on this block's columns
    dssm::cluster_sync();  // every block's row sums are in
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      float t = 0.f;  // the cluster's, in rank order
      for (int q = 0; q < nranks; ++q) {
        t += dssm::ld_cluster(dssm::peer_addr(&ss[r], q));
      }
      norm[r] = fmaxf(sqrtf(t), eps);
    }
    __syncthreads();
    const int dl = L.dims[L.num_layers];
    const Slice s = plan[L.num_layers - 1].mine;
    const int c0 = s.first * 8;
    const int c1 = (s.first + s.count) * 8 < dl ? (s.first + s.count) * 8 : dl;
    dssm::for_grid<kThreads>(rows, c1 - c0, [&](int r, int v) {
      float* p = y + (row0 + r) * dl + c0 + v;
      *p = *p / norm[r];
    });
    dssm::cluster_sync();  // the row sums stay until every block has read them
  }
}

// Bytes per copy of rows of `row_elems` elements at p: the widest of 16, 8,
// 4 (and 2 for bf16) that divides the pitch and p's alignment.
int vec_bytes(const void* p, long long row_elems, int esize) {
  int v = 16;
  while (v > esize && ((reinterpret_cast<uintptr_t>(p) % v) != 0 ||
                       (row_elems * esize) % v != 0)) {
    v >>= 1;
  }
  return v;
}

// Shared-memory layout of a launch: activation and ring strides, the ring
// chunk's rows, the tiles of a pass, the stages, and the bytes in all.
struct Layout {
  int lda, rld, kc, pass_tiles, stages;
  size_t smem;
};

// The ring that fits beside a tile of BM rows (wide: beside one chunk of
// it): the chunk of K (the widest layer input whole, or halved) and the
// pass width (even, 2 tiles up to the widest share) that cost the fewest k
// steps of warp rounds over all jobs, a job costing kJobSteps more (ties:
// the longer chunk, then the wider pass); then the most stages (4 down to
// 2). False where even 2 stages of 16 x 2 tiles leave no room.
template <typename T>
bool layout_for(const TowerLayers& L, int max_in, bool wide, int nranks,
                int bm, Layout* out) {
  constexpr int kJobSteps = 8;
  int widest = 2;  // the widest share of any layer, in tiles (even)
  for (int l = 0; l < L.num_layers; ++l) {
    const int t = (out_tiles(L.dims[l + 1]) + nranks - 1) / nranks;
    if (t > widest) widest = t;
  }
  widest = (widest + 1) & ~1;
  const int kfull = round16(max_in);
  bool found = false;
  long long best_cost = 0;
  for (int kc = kfull; kc >= 16; kc = kc > 16 ? round16(kc / 2) : 0) {
    const int lda = (wide ? kc : kfull) + (sizeof(T) == 2 ? 8 : 4);
    const size_t fixed = (wide ? 1 : 2) * sizeof(T) * bm * (size_t)lda +
                         2 * sizeof(float) * bm +
                         sizeof(Plan) * DSSM_TOWER_MAX_LAYERS;
    for (int pt = widest; pt >= 2; pt -= 2) {
      const int rld = pt * 8 + 8;  // an odd number of 16-byte units
      const size_t slot = sizeof(T) * (kc + 1) * (size_t)rld;
      const size_t sums = kc < kfull ? sizeof(float) * bm * pt * 8 : 0;
      int stages = kMaxStages;
      while (stages >= kMinStages && fixed + sums + stages * slot > kSmemLimit)
        --stages;
      if (stages < kMinStages) continue;
      long long cost = 0;
      for (int l = 0; l < L.num_layers; ++l) {
        const int share = (out_tiles(L.dims[l + 1]) + nranks - 1) / nranks;
        const int din = round16(L.dims[l]);
        const int chunks = (din + kc - 1) / kc;
        const int steps = (din < kc ? din : kc) / 16;
        for (int first = 0; first < share; first += pt) {
          const int tiles = share - first < pt ? share - first : pt;
          const int units = (bm / 16) * ((tiles + 1) / 2);
          cost += (long long)chunks *
                  ((units + kWarps - 1) / kWarps * steps + kJobSteps);
        }
      }
      if (!found || cost < best_cost) {
        found = true;
        best_cost = cost;
        *out = {lda, rld, kc, pt, stages, fixed + sums + stages * slot};
      }
    }
  }
  return found;
}

constexpr int kTwoWaves = -2;  // try_tower: the grid would not fit one wave

// Launch a tile of 16 kMT rows; kNoRoom where the widths leave it no room,
// kTwoWaves (nothing launched) where one_wave and the card cannot hold
// every cluster at once (cudaOccupancyMaxActiveClusters).
template <typename T, bool kRelu, int kMT, bool kWide>
int try_tower(const void* x, void* y, const TowerLayers& L, long long batch,
              int max_in, int nranks, bool one_wave, int normalize,
              float eps, cudaStream_t stream) {
  constexpr int BM = 16 * kMT;
  Layout g;
  if (!layout_for<T>(L, max_in, kWide, nranks, BM, &g)) return kNoRoom;
  auto kernel = dense_tower_kernel<T, kRelu, kMT, kWide>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  // Kept per kernel: the device and shared-memory size its attribute was
  // raised for, and the clusters a device holds at once for a cluster size
  // and a shared-memory size.
  static int attr_device = -1;
  static size_t attr_smem = 0;
  if (device != attr_device || g.smem > attr_smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(g.smem > 48 * 1024 ? g.smem : 48 * 1024));
    if (err != cudaSuccess) return (int)err;
    attr_device = device;
    attr_smem = g.smem;
  }
  const long long clusters = (batch + BM - 1) / BM;
  cudaLaunchAttribute attr;
  if (one_wave) {
    static int occ_device = -1, occ_ranks = 0, occ_clusters = 0;
    static size_t occ_smem = 0;
    if (device != occ_device || nranks != occ_ranks || g.smem != occ_smem) {
      cudaLaunchConfig_t probe = dssm::cluster_config(
          (unsigned int)nranks, kThreads, nranks, g.smem, stream, &attr);
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &probe);
      if (err != cudaSuccess) return (int)err;
      occ_device = device;
      occ_ranks = nranks;
      occ_smem = g.smem;
      occ_clusters = n;
    }
    if (clusters > occ_clusters) return kTwoWaves;
  }
  cudaLaunchConfig_t cfg =
      dssm::cluster_config((unsigned int)(clusters * nranks), kThreads, nranks,
                           g.smem, stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<float*>(y), L,
      (int64_t)batch, g.lda, g.rld, g.kc, g.pass_tiles, g.stages,
      vec_bytes(x, L.dims[0], sizeof(T)), normalize, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Rows a cluster takes: the fewest of 16, 32, 64 and 128 whose grid the
// card holds in one wave; else the most that fit the widths.
template <typename T, bool kRelu, bool kWide>
int launch_rows(const void* x, void* y, const TowerLayers& L,
                long long batch, int max_in, int normalize, float eps,
                cudaStream_t stream) {
  // Blocks a cluster, from measurement (PERF.md, PR 8): 8 up to 256 rows
  // (the columns spread over the most SMs), 4 up to 512, else 2.
  const int nranks = batch <= 256 ? 8 : (batch <= 512 ? 4 : 2);
  for (const bool one_wave : {true, false}) {
    for (int i = 0; i < 4; ++i) {
      // One wave: the smallest tile first; else the largest that fits.
      const int mt = one_wave ? 1 << i : 8 >> i;
      int rc;
      if (mt == 1) {
        rc = try_tower<T, kRelu, 1, kWide>(x, y, L, batch, max_in, nranks,
                                           one_wave, normalize, eps, stream);
      } else if (mt == 2) {
        rc = try_tower<T, kRelu, 2, kWide>(x, y, L, batch, max_in, nranks,
                                           one_wave, normalize, eps, stream);
      } else if (mt == 4) {
        rc = try_tower<T, kRelu, 4, kWide>(x, y, L, batch, max_in, nranks,
                                           one_wave, normalize, eps, stream);
      } else {
        rc = try_tower<T, kRelu, 8, kWide>(x, y, L, batch, max_in, nranks,
                                           one_wave, normalize, eps, stream);
      }
      if (rc != kNoRoom && rc != kTwoWaves) return rc;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_act(const void* x, void* y, const TowerLayers& L, long long batch,
               int max_in, bool wide, int activation, int normalize,
               float eps, cudaStream_t stream) {
  if (activation == 0) {
    return wide ? launch_rows<T, false, true>(x, y, L, batch, max_in,
                                              normalize, eps, stream)
                : launch_rows<T, false, false>(x, y, L, batch, max_in,
                                               normalize, eps, stream);
  }
  if (activation == 1) {
    return wide ? launch_rows<T, true, true>(x, y, L, batch, max_in,
                                             normalize, eps, stream)
                : launch_rows<T, true, false>(x, y, L, batch, max_in,
                                              normalize, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: [batch, dims[0]] (dtype 0 = f32, 1 = bf16); ws[l]: [dims[l], dims[l+1]]
// and bs[l]: [dims[l+1]] of x's dtype; y: [batch, dims[num_layers]] f32.
// hs: null, or num_layers pointers to [batch, dims[l+1]] f32 residuals
// (required where a layer input takes more than kTileBytes a row).
// activation 0 = tanh, 1 = relu. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dssm_dense_tower(const void* x, void* y, const void* const* ws,
                                const void* const* bs, void* const* hs,
                                const int* dims,
                                int num_layers, long long batch, int dtype,
                                int activation, int normalize, float eps,
                                void* stream) {
  if (num_layers < 1 || num_layers > DSSM_TOWER_MAX_LAYERS || batch <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int esize = dtype == 0 ? 4 : 2;
  TowerLayers layers;
  layers.num_layers = num_layers;
  int max_in = 0;  // the widest layer input: the activation tile's width
  for (int l = 0; l <= num_layers; ++l) {
    layers.dims[l] = dims[l];
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    if (l < num_layers && dims[l] > max_in) max_in = dims[l];
  }
  for (int l = 0; l < num_layers; ++l) {
    layers.w[l] = ws[l];
    layers.b[l] = bs[l];
    layers.hs[l] = hs == nullptr ? nullptr : (float*)hs[l];
    layers.wvec[l] = vec_bytes(ws[l], dims[l + 1], esize);
    layers.bvec[l] = vec_bytes(bs[l], dims[l + 1], esize);
  }
  const bool wide = (long long)max_in * esize > kTileBytes;
  if (wide && hs == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_act<float>(x, y, layers, batch, max_in, wide, activation,
                             normalize, eps, s);
  }
  return launch_act<__nv_bfloat16>(x, y, layers, batch, max_in, wide,
                                   activation, normalize, eps, s);
}
