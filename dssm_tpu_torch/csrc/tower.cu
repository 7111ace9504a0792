// Fused dense tower forward: per layer z = h @ W + b, tanh or relu, with an
// optional L2 norm at the end, for any number of layers and any widths.
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
// time, both below launch overhead.
//
// Design: a block takes kRows (4) rows and keeps their activations in shared
// memory (two [kRows, max_dim] f32 buffers, ping-ponged between layers;
// dynamic shared memory, raised above 48 KB where the widths need it).
// Each thread owns one output column of a layer for all kRows rows: it
// reads each weight once per block (coalesced across threads, four loads
// in flight) and broadcasts activations from shared memory into kRows f32
// accumulators. 1024 rows make 256 blocks. Every block reads all the
// weights from L2, so fewer rows per block buys parallelism with L2
// traffic; staging weight tiles in shared memory for many rows and tensor
// cores are the next step (no mma yet: simple and right first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DSSM_TOWER_MAX_LAYERS 8

namespace {

constexpr int kRows = 4;

struct TowerLayers {
  const void* w[DSSM_TOWER_MAX_LAYERS];
  const void* b[DSSM_TOWER_MAX_LAYERS];
  float* hs[DSSM_TOWER_MAX_LAYERS];  // per-layer f32 residuals, or null
  int dims[DSSM_TOWER_MAX_LAYERS + 1];
  int num_layers;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// float -> T -> float: the cast to the input dtype between layers.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, bool kRelu>
__global__ void dense_tower_kernel(const T* __restrict__ x,
                                   float* __restrict__ y, TowerLayers layers,
                                   int64_t batch, int max_dim, int normalize,
                                   float eps) {
  extern __shared__ float smem[];
  float* h_in = smem;                     // [kRows, max_dim]
  float* h_out = smem + kRows * max_dim;  // [kRows, max_dim]
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t remaining = batch - row0;
  const int rows = remaining < kRows ? (int)remaining : kRows;

  const int d0 = layers.dims[0];
  for (int i = threadIdx.x; i < kRows * d0; i += blockDim.x) {
    const int r = i / d0;
    const int c = i - r * d0;
    h_in[r * max_dim + c] = r < rows ? to_f32(x[(row0 + r) * d0 + c]) : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < layers.num_layers; ++l) {
    const int din = layers.dims[l];
    const int dout = layers.dims[l + 1];
    const T* w = static_cast<const T*>(layers.w[l]);
    const T* b = static_cast<const T*>(layers.b[l]);
    const bool last = l + 1 == layers.num_layers;
    float* hs = layers.hs[l];
    for (int c = threadIdx.x; c < dout; c += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      int i = 0;
      for (; i + 4 <= din; i += 4) {  // four weight loads in flight
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = to_f32(w[(int64_t)(i + q) * dout + c]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r] = fmaf(h_in[r * max_dim + i + q], wv[q], acc[r]);
          }
        }
      }
      for (; i < din; ++i) {
        const float wv = to_f32(w[(int64_t)i * dout + c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fmaf(h_in[r * max_dim + i], wv, acc[r]);
        }
      }
      const float bias = to_f32(b[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float z = acc[r] + bias;
        const float a = kRelu ? fmaxf(z, 0.f) : tanhf(z);
        h_out[r * max_dim + c] = last ? a : round_to<T>(a);
        if (hs != nullptr && r < rows) hs[(row0 + r) * dout + c] = a;
      }
    }
    __syncthreads();
    float* t = h_in;
    h_in = h_out;
    h_out = t;
  }

  // h_in now holds the last layer's f32 activations; one warp per row.
  const int dl = layers.dims[layers.num_layers];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_warps = blockDim.x / 32;
  for (int r = warp; r < rows; r += num_warps) {
    const float* hr = h_in + r * max_dim;
    float norm = 1.f;
    if (normalize) {
      float ss = 0.f;
      for (int c = lane; c < dl; c += 32) ss = fmaf(hr[c], hr[c], ss);
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      norm = fmaxf(sqrtf(ss), eps);
    }
    float* yr = y + (row0 + r) * dl;
    for (int c = lane; c < dl; c += 32) yr[c] = normalize ? hr[c] / norm : hr[c];
  }
}

template <typename T, bool kRelu>
int launch_tower_act(const void* x, void* y, const TowerLayers& layers,
                 long long batch, int max_dim, int threads, int normalize,
                 float eps, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * kRows * (size_t)max_dim;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_tower_kernel<T, kRelu>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned int blocks = (unsigned int)((batch + kRows - 1) / kRows);
  dense_tower_kernel<T, kRelu><<<blocks, threads, smem, stream>>>(
      (const T*)x, (float*)y, layers, (int64_t)batch, max_dim, normalize,
      eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tower(const void* x, void* y, const TowerLayers& layers,
                 long long batch, int max_dim, int threads, int activation,
                 int normalize, float eps, cudaStream_t stream) {
  if (activation == 0) {
    return launch_tower_act<T, false>(x, y, layers, batch, max_dim,
                                      threads, normalize, eps, stream);
  }
  if (activation == 1) {
    return launch_tower_act<T, true>(x, y, layers, batch, max_dim,
                                     threads, normalize, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: [batch, dims[0]] (dtype 0 = f32, 1 = bf16); ws[l]: [dims[l], dims[l+1]]
// and bs[l]: [dims[l+1]] of x's dtype; y: [batch, dims[num_layers]] f32.
// hs: null, or num_layers pointers to [batch, dims[l+1]] f32 residuals.
// activation 0 = tanh, 1 = relu. Returns cudaGetLastError().
extern "C" int dssm_dense_tower(const void* x, void* y, const void* const* ws,
                                const void* const* bs, void* const* hs,
                                const int* dims,
                                int num_layers, long long batch, int dtype,
                                int activation, int normalize, float eps,
                                void* stream) {
  if (num_layers < 1 || num_layers > DSSM_TOWER_MAX_LAYERS || batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  TowerLayers layers;
  layers.num_layers = num_layers;
  int max_dim = 0;
  int max_out = 0;
  for (int l = 0; l <= num_layers; ++l) {
    layers.dims[l] = dims[l];
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    if (dims[l] > max_dim) max_dim = dims[l];
    if (l > 0 && dims[l] > max_out) max_out = dims[l];
  }
  for (int l = 0; l < num_layers; ++l) {
    layers.w[l] = ws[l];
    layers.b[l] = bs[l];
    layers.hs[l] = hs == nullptr ? nullptr : (float*)hs[l];
  }
  if (2 * sizeof(float) * kRows * (size_t)max_dim > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = ((max_out + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > 512 ? 512 : threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_tower<float>(x, y, layers, batch, max_dim, threads,
                               activation, normalize, eps, s);
  }
  if (dtype == 1) {
    return launch_tower<__nv_bfloat16>(x, y, layers, batch, max_dim, threads,
                                       activation, normalize, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
