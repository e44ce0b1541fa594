// Masked GeM pooling + L2 normalisation of NCHW float32 features, for sm_90a.
//
// Replaces the Pallas TPU kernel mdir_tpu/ops/pooling_pallas.py::_gem_kernel
// (launched by gem_l2n_pallas). It computes the same function, not the TPU's
// grid: for each image n and channel c
//   acc    = sum over cells h < vh[n], w < vw[n] of max(x, eps)^p
//   pooled = (acc / max(vh * vw, 1))^(1/p)
// and then out[n, :] = pooled[n, :] / (||pooled[n, :]||_2 + eps).
//
// Bound: memory. The function reads every valid feature cell once and writes
// N*C floats; it does about three float operations per cell read, far below
// what the card computes in the time the bytes take. The design keeps each
// cell to one read and uses the whole card:
//   1. gem_pool_kernel: one warp per (n, c) plane. The lanes walk the plane's
//      valid cells as one flat index (consecutive lanes on consecutive cells
//      of a row, so the loads coalesce along W), accumulate in f32 registers
//      and reduce with shuffles. Padded cells are never read. N*C warps fill
//      the card (32,768 at N = 16, C = 2048).
//   2. l2n_kernel: one block per image sums pooled^2 over C and divides.
// The TPU kernel carried its sum across a sequential grid in scratch memory;
// blocks here run in no order, so nothing is carried between them.
// powf is the accurate libdevice function (no --use_fast_math). Eval only: the
// TPU kernel has no gradient either.

#include <cuda_runtime.h>

constexpr int kWarpsPerBlock = 8;
constexpr int kL2nThreads = 256;

static __device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

static __global__ void gem_pool_kernel(const float* __restrict__ x,
                                       const int* __restrict__ valid_hw,
                                       const float* __restrict__ p_ptr,
                                       float* __restrict__ pooled, int n,
                                       int c, int h, int w, float eps) {
  const int lane = threadIdx.x & 31;
  const long long plane =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (plane >= static_cast<long long>(n) * c) {
    return;
  }
  const int img = static_cast<int>(plane / c);
  const int vh = min(max(valid_hw[2 * img], 0), h);
  const int vw = min(max(valid_hw[2 * img + 1], 0), w);
  const int cells = vh * vw;
  const float p = *p_ptr;
  const float* base = x + plane * h * w;

  float acc = 0.0f;
  for (int i = lane; i < cells; i += 32) {
    const int row = i / vw;
    const int col = i - row * vw;
    acc += powf(fmaxf(__ldg(base + row * w + col), eps), p);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const float count = static_cast<float>(max(cells, 1));
    pooled[plane] = powf(acc / count, 1.0f / p);
  }
}

static __global__ void l2n_kernel(const float* __restrict__ pooled,
                                  float* __restrict__ out, int c, float eps) {
  __shared__ float partial[kL2nThreads / 32];
  const float* row = pooled + static_cast<long long>(blockIdx.x) * c;
  float* dst = out + static_cast<long long>(blockIdx.x) * c;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float sum = 0.0f;
  for (int j = threadIdx.x; j < c; j += kL2nThreads) {
    const float v = row[j];
    sum += v * v;
  }
  sum = warp_sum(sum);
  if (lane == 0) {
    partial[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    sum = lane < kL2nThreads / 32 ? partial[lane] : 0.0f;
    sum = warp_sum(sum);
    if (lane == 0) {
      partial[0] = sum;
    }
  }
  __syncthreads();
  const float denom = sqrtf(partial[0]) + eps;
  for (int j = threadIdx.x; j < c; j += kL2nThreads) {
    dst[j] = row[j] / denom;
  }
}

// x: (n, c, h, w) contiguous f32; valid_hw: (n, 2) int32; p: one f32;
// pooled: (n, c) scratch; out: (n, c). Launches on `stream` and returns
// cudaGetLastError() after the launches (0 when both were accepted).
extern "C" int gem_l2n_f32(const float* x, const int* valid_hw, const float* p,
                           float* pooled, float* out, int n, int c, int h,
                           int w, float eps, void* stream) {
  if (n <= 0 || c <= 0) {
    return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long planes = static_cast<long long>(n) * c;
  const unsigned int blocks = static_cast<unsigned int>(
      (planes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gem_pool_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      x, valid_hw, p, pooled, n, c, h, w, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  l2n_kernel<<<n, kL2nThreads, 0, s>>>(pooled, out, c, eps);
  return static_cast<int>(cudaGetLastError());
}
