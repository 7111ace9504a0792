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
// reference kernel. No gradient flows through pos or hit. Any B, B' and D
// (D up to the shared-memory limit) are taken; ragged tiles are masked.
//
// Bound on the H100: operations. At the `full` preset (B = B' = 1024,
// D = 128, f32) the forward does 0.27 GFLOP and each backward kernel 0.54,
// against 1 MB moved: 4 us and 8 us at 67 TFLOP/s f32, under 1 us of bytes.
//
// Design: a block owns 16 rows of one side (q rows for the forward and dq,
// doc rows for dd) and streams the other side in tiles of 64 rows through
// shared memory. Rows are zero-padded to a multiple of 4 columns and
// pitched 4 words further, so every read of the products is a 16-byte
// shared-memory load and the 8 threads of a load phase fall on distinct
// banks. The 256 threads form a 16 x 16 grid: thread (ty, tx) computes the
// logits of own row ty against streamed rows tx + 16 m, m < 4, as an f32
// product from shared memory. The forward keeps a running (max, sum,
// positive) per thread over its own columns and merges the 16 threads of a
// row with shuffles at the end. The backward kernels write the dlog tile
// to shared memory and accumulate the second product dlog [16, 64] @ tile
// [64, D] with 8 output columns per thread (columns 4 tx + 64 jj + e; one
// pass per 128 columns of D). B = 1024 gives 64 blocks of 8 warps: the card
// is half full and the product runs on CUDA cores, not tensor cores. Tile
// loads are not overlapped with the products (no double buffer yet); a
// thread's global loads of one tile are started together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOwn = 16;       // rows a block owns
constexpr int kStream = 64;    // rows per streamed tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPerThread = kStream / 16;
constexpr int kChunk = 128;    // output columns per pass of a backward kernel
constexpr int kOutPerThread = kChunk / 16;  // two float4 a thread
constexpr float kNegInf = -1e30f;

// Columns padded to a multiple of 4, and the shared-memory row pitch.
__host__ __device__ __forceinline__ int padded(int dim) {
  return (dim + 3) & ~3;
}
__host__ __device__ __forceinline__ int pitch_of(int dim) {
  return padded(dim) + 4;
}

// dst[r, c] (row pitch pitch_of(dim)) = src[row0 + r, c], zero past `total`
// rows and in the padding columns [dim, padded(dim)). With dim a multiple
// of 4 (rows of 16-byte vectors) a thread starts its 16-byte global loads
// eight at a time before it stores them, so their latencies overlap.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t row0, int64_t total,
                                          int tile_rows, int dim) {
  const int pitch = pitch_of(dim);
  if (dim % 4 == 0) {
    constexpr int kBatch = 8;
    const int d4 = dim / 4;
    const int n = tile_rows * d4;
    for (int base = threadIdx.x; base < n; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        const int r = i / d4;
        const int64_t row = row0 + r;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n && row < total) {
          v[u] = *reinterpret_cast<const float4*>(src + row * dim +
                                                  4 * (i - r * d4));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        const int r = i / d4;
        if (i < n) {
          *reinterpret_cast<float4*>(dst + r * pitch + 4 * (i - r * d4)) =
              v[u];
        }
      }
    }
    return;
  }
  const int dpad = padded(dim);
  for (int i = threadIdx.x; i < tile_rows * dpad; i += kThreads) {
    const int r = i / dpad;
    const int c = i - r * dpad;
    const int64_t row = row0 + r;
    dst[r * pitch + c] = (row < total && c < dim) ? src[row * dim + c] : 0.f;
  }
}

// logits of own row ty against streamed rows tx + 16 m of the tile.
__device__ __forceinline__ void logits_tile(const float* own_s,
                                            const float* str_s, int dim,
                                            float gamma, int ty, int tx,
                                            float (&logit)[kPerThread]) {
  float acc[kPerThread];
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) acc[m] = 0.f;
  const int p4 = pitch_of(dim) / 4;
  const float4* a = reinterpret_cast<const float4*>(own_s) + ty * p4;
  const float4* b = reinterpret_cast<const float4*>(str_s) + tx * p4;
  for (int k4 = 0; k4 < padded(dim) / 4; ++k4) {
    const float4 av = a[k4];
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const float4 bv = b[m * 16 * p4 + k4];
      acc[m] = fmaf(av.x, bv.x, acc[m]);
      acc[m] = fmaf(av.y, bv.y, acc[m]);
      acc[m] = fmaf(av.z, bv.z, acc[m]);
      acc[m] = fmaf(av.w, bv.w, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) logit[m] = gamma * acc[m];
}

__global__ void in_batch_loss_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ d,
    const int32_t* __restrict__ labels, float* __restrict__ nll,
    float* __restrict__ lse, float* __restrict__ pos_out,
    float* __restrict__ hit, int64_t b, int64_t bg, int dim, float gamma) {
  extern __shared__ __align__(16) float smem[];
  float* own_s = smem;                          // [kOwn, pitch]
  float* str_s = smem + kOwn * pitch_of(dim);   // [kStream, pitch]
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t row0 = (int64_t)blockIdx.x * kOwn;
  const int64_t i = row0 + ty;
  const int64_t lab = i < b ? (int64_t)labels[i] : -1;
  load_tile(own_s, q, row0, b, kOwn, dim);
  float m_run = kNegInf, s_run = 0.f, pos = 0.f;
  for (int64_t j0 = 0; j0 < bg; j0 += kStream) {
    __syncthreads();  // the previous tile is consumed (and own_s is loaded)
    load_tile(str_s, d, j0, bg, kStream, dim);
    __syncthreads();
    float logit[kPerThread];
    logits_tile(own_s, str_s, dim, gamma, ty, tx, logit);
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
      const int64_t j = j0 + tx + 16 * m;
      if (j < bg) {
        const float l = logit[m];
        if (l > m_run) {
          s_run = s_run * expf(m_run - l) + 1.f;
          m_run = l;
        } else {
          s_run += expf(l - m_run);
        }
        if (j == lab) pos += l;
      }
    }
  }
  // Merge the 16 threads of a row (one half-warp).
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m_run, o);
    const float s_o = __shfl_xor_sync(0xffffffffu, s_run, o);
    const float p_o = __shfl_xor_sync(0xffffffffu, pos, o);
    const float m_new = fmaxf(m_run, m_o);
    s_run = s_run * expf(m_run - m_new) + s_o * expf(m_o - m_new);
    m_run = m_new;
    pos += p_o;
  }
  if (tx == 0 && i < b) {
    const float l = m_run + logf(s_run);
    lse[i] = l;
    nll[i] = l - pos;
    pos_out[i] = pos;
    hit[i] = pos >= m_run ? 1.f : 0.f;
  }
}

// kDd = false: own rows are queries, streamed rows docs, out = dq.
// kDd = true:  own rows are docs, streamed rows queries, out = dd.
template <bool kDd>
__global__ void in_batch_loss_grad_kernel(
    const float* __restrict__ q, const float* __restrict__ d,
    const int32_t* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g, float* __restrict__ out, int64_t b,
    int64_t bg, int dim, float gamma) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = pitch_of(dim);
  float* own_s = smem;                                 // [kOwn, pitch]
  float* str_s = own_s + kOwn * pitch;                 // [kStream, pitch]
  float* dlog_s = str_s + kStream * pitch;             // [kOwn, kStream + 1]
  float* lse_s = dlog_s + kOwn * (kStream + 1);        // [kStream] (dd)
  float* g_s = lse_s + kStream;                        // [kStream] (dd)
  int32_t* lab_s = reinterpret_cast<int32_t*>(g_s + kStream);  // [kStream]
  const float* own = kDd ? d : q;
  const float* str = kDd ? q : d;
  const int64_t n_own = kDd ? bg : b;
  const int64_t n_str = kDd ? b : bg;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t row0 = (int64_t)blockIdx.x * kOwn;
  const int64_t own_row = row0 + ty;
  const bool own_ok = own_row < n_own;
  // dq: the query is the own row, so its scalars live in registers.
  float lse_i = 0.f, g_i = 0.f;
  int64_t lab_i = -1;
  if (!kDd && own_ok) {
    lse_i = lse[own_row];
    g_i = g[own_row];
    lab_i = labels[own_row];
  }
  load_tile(own_s, own, row0, n_own, kOwn, dim);
  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    float acc[kOutPerThread];
#pragma unroll
    for (int jj = 0; jj < kOutPerThread; ++jj) acc[jj] = 0.f;
    for (int64_t t0 = 0; t0 < n_str; t0 += kStream) {
      __syncthreads();  // the previous tile and dlog_s are consumed
      load_tile(str_s, str, t0, n_str, kStream, dim);
      if (kDd && threadIdx.x < kStream) {
        const int64_t i = t0 + threadIdx.x;
        lse_s[threadIdx.x] = i < b ? lse[i] : 0.f;
        g_s[threadIdx.x] = i < b ? g[i] : 0.f;
        lab_s[threadIdx.x] = i < b ? labels[i] : -1;
      }
      __syncthreads();
      float logit[kPerThread];
      logits_tile(own_s, str_s, dim, gamma, ty, tx, logit);
#pragma unroll
      for (int m = 0; m < kPerThread; ++m) {
        const int n = tx + 16 * m;
        const int64_t str_row = t0 + n;
        float dl = 0.f;
        if (own_ok && str_row < n_str) {
          if (kDd) {
            const float hot = (int64_t)lab_s[n] == own_row ? 1.f : 0.f;
            dl = (expf(logit[m] - lse_s[n]) - hot) * g_s[n];
          } else {
            const float hot = lab_i == str_row ? 1.f : 0.f;
            dl = (expf(logit[m] - lse_i) - hot) * g_i;
          }
        }
        dlog_s[ty * (kStream + 1) + n] = dl;
      }
      __syncthreads();
      // acc[4 jj + e] belongs to column c0 + 4 tx + 64 jj + e.
      const float* dl_row = dlog_s + ty * (kStream + 1);
      const float* scol = str_s + c0 + 4 * tx;
      const bool ok0 = c0 + 4 * tx < padded(dim);
      const bool ok1 = c0 + 4 * tx + 64 < padded(dim);
      for (int n = 0; n < kStream; ++n) {
        const float dv = dl_row[n];
        if (ok0) {
          const float4 sv = *reinterpret_cast<const float4*>(scol + n * pitch);
          acc[0] = fmaf(dv, sv.x, acc[0]);
          acc[1] = fmaf(dv, sv.y, acc[1]);
          acc[2] = fmaf(dv, sv.z, acc[2]);
          acc[3] = fmaf(dv, sv.w, acc[3]);
        }
        if (ok1) {
          const float4 sv =
              *reinterpret_cast<const float4*>(scol + n * pitch + 64);
          acc[4] = fmaf(dv, sv.x, acc[4]);
          acc[5] = fmaf(dv, sv.y, acc[5]);
          acc[6] = fmaf(dv, sv.z, acc[6]);
          acc[7] = fmaf(dv, sv.w, acc[7]);
        }
      }
    }
    if (own_ok) {
#pragma unroll
      for (int jj = 0; jj < kOutPerThread; ++jj) {
        const int col = c0 + 4 * tx + 64 * (jj / 4) + jj % 4;
        if (col < dim) out[own_row * dim + col] = gamma * acc[jj];
      }
    }
  }
}

size_t fwd_smem(int dim) {
  return sizeof(float) * (size_t)(kOwn + kStream) * pitch_of(dim);
}

size_t grad_smem(int dim) {
  return fwd_smem(dim) + sizeof(float) * kOwn * (kStream + 1) +
         3 * sizeof(float) * kStream;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kDd>
int launch_grad(const void* q, const void* d, const void* labels,
                const void* lse, const void* g, void* out, long long b,
                long long bg, int dim, float gamma, void* stream) {
  if (b <= 0 || bg <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = grad_smem(dim);
  cudaError_t err = allow_smem(in_batch_loss_grad_kernel<kDd>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_own = kDd ? bg : b;
  const unsigned int blocks = (unsigned int)((n_own + kOwn - 1) / kOwn);
  in_batch_loss_grad_kernel<kDd><<<blocks, kThreads, smem,
                                   (cudaStream_t)stream>>>(
      (const float*)q, (const float*)d, (const int32_t*)labels,
      (const float*)lse, (const float*)g, (float*)out, (int64_t)b,
      (int64_t)bg, dim, gamma);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [b, dim] f32, d: [bg, dim] f32, labels: [b] int32; nll, lse, pos, hit:
// [b] f32. Returns cudaGetLastError().
extern "C" int dssm_in_batch_loss_fwd(const void* q, const void* d,
                                      const void* labels, void* nll,
                                      void* lse, void* pos, void* hit,
                                      long long b, long long bg, int dim,
                                      float gamma, void* stream) {
  if (b <= 0 || bg <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(dim);
  cudaError_t err = allow_smem(in_batch_loss_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)((b + kOwn - 1) / kOwn);
  in_batch_loss_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)d, (const int32_t*)labels, (float*)nll,
      (float*)lse, (float*)pos, (float*)hit, (int64_t)b, (int64_t)bg, dim,
      gamma);
  return (int)cudaGetLastError();
}

// lse: [b] f32 from the forward, g: [b] f32 (the gradient of each row's
// nll); dq: [b, dim] f32. Returns cudaGetLastError().
extern "C" int dssm_in_batch_loss_dq(const void* q, const void* d,
                                     const void* labels, const void* lse,
                                     const void* g, void* dq, long long b,
                                     long long bg, int dim, float gamma,
                                     void* stream) {
  return launch_grad<false>(q, d, labels, lse, g, dq, b, bg, dim, gamma,
                            stream);
}

// dd: [bg, dim] f32. Returns cudaGetLastError().
extern "C" int dssm_in_batch_loss_dd(const void* q, const void* d,
                                     const void* labels, const void* lse,
                                     const void* g, void* dd, long long b,
                                     long long bg, int dim, float gamma,
                                     void* stream) {
  return launch_grad<true>(q, d, labels, lse, g, dd, b, bg, dim, gamma,
                           stream);
}
