// The lookup forward shared by count.cu's count lookup and embed.cu's
// raw-index bag: out[r, :] = sum_k wgt[r, k] * src[idx[r, k], :], f32, src
// f32 or bf16 [u2, h]. The count lookup's src is a compact block; the bag's
// is the whole table (u2 = the vocabulary). A pair is live when its weight
// is not 0 and its index is in [0, u2); dead pairs read nothing.
//
// Design: a block a lookup row, of the fewest whole warps that give each
// 4-column vector of the row a thread (at most 256; wider rows loop). The
// first warp resolves up to 128 of the row's k in one pass, every idx and
// wgt load in flight at once, and a ballot compacts the live pairs in k
// order into shared memory. Each thread then loads its vector (16 bytes of
// f32, 8 of bf16) for the next kFwdAhead live pairs before their FMAs. A
// warp's store writes 512 contiguous bytes, with a streaming hint: at the
// cnn shapes the outputs are the largest stream, read once by the tower.
// An h that is not a multiple of 4, or a src or output that is not 16-byte
// aligned, takes the same loop one column at a time.
// Measured on the card (tools/eval_kernels.py, PERF.md) against the
// warp-a-row design it replaced in the count lookup (several warps a row,
// 8 loads in flight a lane) and the bag's thread-a-16-byte-vector design:
// as fast or faster at every `full`, cnn and lstm shape but the lstm bag
// on a bf16 table (3-4% slower); 8 or 16 pairs ahead, 2 vectors a thread
// and 16-byte bf16 vectors (whose two stores a lane write every other 16
// bytes, or need shuffles to write whole lines) were slower.
// Sum order: each column is one fmaf chain over the live pairs in k order
// from 0, as joint.cu's lookups sum: the count lookup is bit-equal to the
// joint lookup through sel = arange(u2), and the bag to the count lookup
// on the same inputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup.cuh"

namespace dssm {
namespace {

constexpr int kFwdMaxThreads = 256;
constexpr int kFwdCap = 128;   // k the first warp resolves in one pass
constexpr int kFwdAhead = 4;   // live pairs a thread loads ahead of its FMAs

struct FwdArgs {
  const void* src;
  const int32_t* idx;
  const float* wgt;
  float* out;
  int64_t rows;
  int k, u2, h;
  int nvec;  // vectors (or columns, one at a time) a row
};

// The first warp: the live pairs among k in [kb, kend) (at most kFwdCap),
// in k order, to s_row and s_wgt; returns their count.
__device__ __forceinline__ int resolve_pairs(const int32_t* __restrict__ idx,
                                             const float* __restrict__ wgt,
                                             int kb, int kend, int u2,
                                             int32_t* s_row, float* s_wgt) {
  constexpr int kSub = kFwdCap / 32;
  const int lane = threadIdx.x & 31;
  const int subs = (kend - kb + 31) / 32;  // the warp's ballots: k = 8 takes 1
  int32_t u[kSub];
  float w[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int kk = kb + s * 32 + lane;
    u[s] = -1;
    w[s] = 0.f;
    if (kk < kend) {
      u[s] = __ldg(idx + kk);
      w[s] = __ldg(wgt + kk);
    }
  }
  int n = 0;
  const unsigned int lt = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    if (s == subs) break;
    const bool keep = w[s] != 0.f && u[s] >= 0 && u[s] < u2;
    const unsigned int mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = n + __popc(mask & lt);
      s_row[pos] = u[s];
      s_wgt[pos] = w[s];
    }
    n += __popc(mask);
  }
  return n;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdMaxThreads)
    lookup_fwd_kernel(FwdArgs a) {
  using R = typename Raw<T, VEC>::type;
  __shared__ int32_t s_row[kFwdCap];
  __shared__ float s_wgt[kFwdCap];
  __shared__ int s_n;
  const int64_t r = blockIdx.x;
  const int32_t* idx = a.idx + r * a.k;
  const float* wgt = a.wgt + r * a.k;
  float* out = a.out + r * a.h;
  const T* src = static_cast<const T*>(a.src);
  int n = 0;
  for (int v0 = 0; v0 < a.nvec; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int kb = 0; kb < a.k; kb += kFwdCap) {
      if (v0 == 0 || a.k > kFwdCap) {  // the same on every thread
        if (v0 > 0 || kb > 0) __syncthreads();  // the last pairs are read
        if (threadIdx.x < 32) {
          const int m = resolve_pairs(idx, wgt, kb, min(a.k, kb + kFwdCap),
                                      a.u2, s_row, s_wgt);
          if (threadIdx.x == 0) s_n = m;
        }
        __syncthreads();
        n = s_n;
      }
      for (int i = 0; i < n; i += kFwdAhead) {
        R x[kFwdAhead];
#pragma unroll
        for (int u = 0; u < kFwdAhead; ++u) {
          x[u] = R{};
          if (i + u < n && v < a.nvec) {
            x[u] = load_vec<T, VEC>(
                src, (int64_t)s_row[i + u] * a.h + (int64_t)v * VEC);
          }
        }
#pragma unroll
        for (int u = 0; u < kFwdAhead; ++u) {
          if (i + u < n) {
            const float w = s_wgt[i + u];
            float f[VEC];
            to_floats(x[u], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, f[e], acc[e]);
          }
        }
      }
    }
    if (v < a.nvec) store_floats<VEC, true>(out + (int64_t)v * VEC, acc);
  }
}

// A block of the fewest whole warps that give each vector of the row a
// thread (at most kFwdMaxThreads; wider rows loop).
template <typename T, int VEC>
int launch_rows(FwdArgs a, cudaStream_t s) {
  a.nvec = a.h / VEC;
  int threads = (a.nvec + 31) / 32 * 32;
  if (threads > kFwdMaxThreads) threads = kFwdMaxThreads;
  lookup_fwd_kernel<T, VEC><<<(unsigned int)a.rows, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// 4-column vectors when h allows and src and out are 16-byte aligned, else
// one column at a time.
template <typename T>
int launch_fwd(const FwdArgs& a, cudaStream_t s) {
  if (a.h % 4 == 0 && aligned16(a.src) && aligned16(a.out)) {
    return launch_rows<T, 4>(a, s);
  }
  return launch_rows<T, 1>(a, s);
}

// src: [u2, h] (dtype 0 = f32, 1 = bf16), idx: [rows, k] int32, wgt:
// [rows, k] f32, out: [rows, h] f32. Returns cudaGetLastError().
inline int lookup_fwd(const void* src, const void* idx, const void* wgt,
                      void* out, long long rows, int k, int u2, int h,
                      int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || k <= 0 || h <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgs a = {};
  a.src = src;
  a.idx = (const int32_t*)idx;
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

}  // namespace
}  // namespace dssm
