// Joint lookup: both towers' lookups from one compact block through one row
// selection,
//   q_out[r, :] = sum_k q_wgt[r, k] * compact[sel[q_inv[r, k]], :]
//   d_out[r, :] = sum_k d_wgt[r, k] * compact[sel[d_inv[r, k]], :]
// and its backward,
//   d_compact[sel[inv[r, k]], :] += wgt[r, k] * g[r, :]   (both sides).
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
// are named by no live lookup.
//
// Bound on the H100: bytes. At the `full` preset (compact [2048, 384] f32,
// 1024 rows, Kq=32, Kd=64) the forward reads inv+wgt (0.8 MB), sel and the
// touched compact rows (<= 1.6 MB) and writes 3.1 MB: under 2 us at 3.35
// TB/s. The backward reads g (bf16, 1.6 MB) and updates the touched rows;
// its f32 atomics (one per live lookup and column) bound it in practice.
//
// Design: one launch for both sides, one thread block per (side, row), one
// thread per column. The first warp compacts the row's live lookups in k
// order into shared memory, resolving sel once per lookup (lookup.cuh); the
// forward then runs the branch-free gather-accumulate of count.cu, the
// backward the same loop with an atomic add in place of the load. The
// backward's sum order, and so its last bits, differs from run to run.
//
// The fused gather + joint lookup (dssm_fused_gather_joint_lookup below)
// replaces dssm_tpu/kernels/pallas_count.py::fused_gather_joint_lookup
// (kernel _fused_gather_joint_kernel). On the TPU, program 0 starts every
// row group's table -> compact DMA from the scalar unit, selects compact2
// with a one-hot matmul once they land, and every program then builds count
// tiles for the MXU; starting the DMAs one by one made it slower than the
// split path there. Here one launch holds two kinds of block that nothing
// orders:
//   - slot blocks copy each real row group of the table into compact with
//     16-byte vectors and zero the rows of empty slots (copy_row_group, the
//     gather's own loop);
//   - (side, row) blocks compact the row's live lookups as the joint lookup
//     does, then map each live compact row j to its table row
//     uniq[j / group] * group + j % group (-1 for an empty slot), and
//     accumulate from the TABLE with the joint lookup's accumulate_row, where
//     row -1 reads as zero. Every sum has the split path's terms in k order:
//     outputs and compact are bit-equal to gather_row_groups followed by
//     joint_lookup.
// No lookup waits for compact, and compact never makes a round trip through
// device memory before the lookups read it. Bound on the H100: bytes; at the
// `full` preset the real groups (~1.3 MB), inv + wgt (0.8 MB), compact
// (3.1 MB written) and the outputs (3.1 MB), about 2.5 us at 3.35 TB/s.
// Offsets into table and compact are 64-bit: sentinel * group * H overflows
// 32 bits, and the slot is tested before any table address is formed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace {

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

template <typename G>
__global__ void joint_lookup_bwd_kernel(const int32_t* __restrict__ sel,
                                        JointSides sides,
                                        const G* __restrict__ g_q,
                                        const G* __restrict__ g_d,
                                        float* __restrict__ dc, int rows,
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
  const G* g = side ? g_d : g_q;
  dssm::scatter_row_grad(dc, s_row, s_wgt, s_live, h, g + r * h);
}

// Blocks [0, num_slots) are slot blocks, the rest (side, row) blocks.
template <typename T>
__global__ void fused_gather_joint_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ uniq,
    const int32_t* __restrict__ sel, JointSides sides,
    float* __restrict__ q_out, float* __restrict__ d_out,
    T* __restrict__ compact, int rows, int u2, int num_slots, int group,
    int64_t num_groups, int h) {
  if (blockIdx.x < (unsigned int)num_slots) {
    const int64_t slot = blockIdx.x;
    const int64_t vecs = (int64_t)group * h * sizeof(T) / 16;
    dssm::copy_row_group(reinterpret_cast<const int4*>(table), uniq[slot],
                         num_groups, vecs,
                         reinterpret_cast<int4*>(compact) + slot * vecs);
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const int kmax = sides.k[0] > sides.k[1] ? sides.k[0] : sides.k[1];
  int32_t* s_row = reinterpret_cast<int32_t*>(smem_raw);
  float* s_wgt = reinterpret_cast<float*>(smem_raw + sizeof(int32_t) * kmax);
  __shared__ int s_live;
  const int b = blockIdx.x - num_slots;
  const int side = b >= rows ? 1 : 0;
  const int64_t r = b - side * rows;
  const int k = sides.k[side];
  if (threadIdx.x < 32) {
    const int live = dssm::compact_live_pairs(
        sides.inv[side] + r * k, sides.wgt[side] + r * k, sel, k, u2,
        num_slots * group, s_row, s_wgt);
    __syncwarp();
    // Compact row -> table row; -1 where the slot is empty (reads zero).
    for (int i = threadIdx.x; i < live; i += 32) {
      const int32_t j = s_row[i];
      const int64_t gid = uniq[j / group];
      s_row[i] = (gid >= 0 && gid < num_groups)
                     ? (int32_t)(gid * group + j % group)
                     : -1;
    }
    if (threadIdx.x == 0) s_live = live;
  }
  __syncthreads();
  dssm::accumulate_row(table, s_row, s_wgt, s_live, h,
                       (side ? d_out : q_out) + r * h);
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

// g_q, g_d: [rows, h] (g_dtype 0 = f32, 1 = bf16); dc: [gr, h] f32, zeroed
// by the caller, added into. Returns cudaGetLastError().
extern "C" int dssm_joint_lookup_bwd(const void* sel, const void* q_inv,
                                     const void* q_wgt, const void* d_inv,
                                     const void* d_wgt, const void* g_q,
                                     const void* g_d, void* dc,
                                     long long rows, int kq, int kd, int u2,
                                     int gr, int h, int g_dtype,
                                     void* stream) {
  JointSides sides;
  size_t smem;
  if (rows <= 0 || rows > (1 << 30) || h <= 0 ||
      !fill_sides(&sides, q_inv, q_wgt, d_inv, d_wgt, kq, kd, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = 2u * (unsigned int)rows;
  const int threads = dssm::block_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (g_dtype == 0) {
    joint_lookup_bwd_kernel<float><<<blocks, threads, smem, s>>>(
        (const int32_t*)sel, sides, (const float*)g_q, (const float*)g_d,
        (float*)dc, (int)rows, u2, gr, h);
  } else if (g_dtype == 1) {
    joint_lookup_bwd_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(
        (const int32_t*)sel, sides, (const __nv_bfloat16*)g_q,
        (const __nv_bfloat16*)g_d, (float*)dc, (int)rows, u2, gr, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
  JointSides sides;
  size_t smem;
  const long long item = dtype == 0 ? 4 : 2;
  const long long blocks = (long long)num_slots + 2 * rows;
  if (rows < 0 || num_slots < 0 || group <= 0 || h <= 0 || blocks <= 0 ||
      blocks > 0x7fffffffLL || (long long)num_slots * group > 0x7fffffffLL ||
      num_groups * group > 0x7fffffffLL || (group * h * item) % 16 != 0 ||
      !fill_sides(&sides, q_inv, q_wgt, d_inv, d_wgt, kq, kd, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = dssm::block_threads(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    fused_gather_joint_kernel<float><<<(unsigned int)blocks, threads, smem,
                                       s>>>(
        (const float*)table, (const int32_t*)uniq, (const int32_t*)sel, sides,
        (float*)q_out, (float*)d_out, (float*)compact, (int)rows, u2,
        num_slots, group, (int64_t)num_groups, h);
  } else if (dtype == 1) {
    fused_gather_joint_kernel<__nv_bfloat16>
        <<<(unsigned int)blocks, threads, smem, s>>>(
            (const __nv_bfloat16*)table, (const int32_t*)uniq,
            (const int32_t*)sel, sides, (float*)q_out, (float*)d_out,
            (__nv_bfloat16*)compact, (int)rows, u2, num_slots, group,
            (int64_t)num_groups, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
