// Masked GeM pooling + L2 normalisation of NCHW float32 or bfloat16
// features, for sm_90a.
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
// what the card computes in the time the bytes take. So the design is about
// keeping enough bytes in flight and spending few instructions per cell:
//   * One launch. Each image is a thread-block cluster; each block pools a
//     contiguous group of channels, whose planes are one contiguous span of
//     NCHW, and keeps its pooled values in shared memory. The blocks sum
//     their squares across the cluster through distributed shared memory
//     and each writes its normalised slice: no second launch and no pooled
//     (N, C) round trip through device memory. The wrapper picks the
//     cluster (ops/pooling_kernel.py::launch_geometry): at N = 16 images,
//     16 blocks of 256 threads an image; below 12 images, 8 blocks of 1024.
//     A cluster's blocks must share a GPC, so whole clusters of large
//     blocks do not tile the 132 SMs: at N = 16, 8 blocks of 16 warps an
//     image left some SMs idle and gave others two blocks; 16 smaller
//     blocks an image spread better.
//   * One warp per plane, walking the valid rectangle only (rows < vh,
//     columns < vw) with row and column counters that step by the warp's
//     width without division. Rows whose width is a multiple of 4 (and a
//     16-byte aligned tensor) are read as float4, the rest as floats; each
//     lane issues 4 float4 (or 8 float) loads before it uses any. A float4
//     that straddles the column edge is read whole (one sector) and its
//     outside cells masked; no vector wholly outside the valid extent is
//     read.
//   * A cheap power: p is read once; p = 3 (the path's) and p = 1 take a
//     block-uniform branch that multiplies out, any other p is
//     exp2f(p * __log2f(x)).
//     Error bound of that path (CUDA Math API: __log2f has at most 2^-22
//     absolute error on [0.5, 2] and 2 ulp elsewhere; exp2f 2 ulp): for a
//     cell x in [0.5, 1] the relative error of x^p is below
//     p * ln2 * 2^-22 plus a few ulp of rounding (about 1.2e-6 at p = 4.7);
//     for smaller x it grows with |log2 x| (about 1.5e-5 at x = 2^-20,
//     p = 4.7), but such a cell adds at most x^p to a sum of cells that are
//     mostly near 1. The root (acc/count)^(1/p), once per channel, is the
//     accurate powf.
// The TPU kernel carried its sum across a sequential grid in scratch memory;
// blocks here run in no order, and the cluster is what ties an image's
// blocks together. Eval only: the TPU kernel has no gradient either.
//
// bfloat16 input (gem_l2n_bf16): the bf16 extraction program feeds the pool
// its trunk's bf16 map, so the kernel reads half the bytes. The walk is the
// same; a vector is 8 cells (16 bytes) where the float path's is 4, or 4, 2
// or 1 cells where the row width or the tensor's alignment allows no wider
// load (a ResNet map at a non-unit scale is often only even in width). Each
// cell widens to float32 exactly (its bits shifted up), and max(x, eps)^p,
// the sums, the root and the L2N all run in float32, and the output is
// float32 (N, C). The TPU kernel keeps its sum and output in bf16; float32
// accumulation is more exact than that, and the reference's bf16 guard
// (cosine >= 0.997 against float32) bounds what either may drift.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

static __device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// x^p for x >= eps > 0; kPow is p itself (1 or 3), or 0 for any other p.
template <int kPow>
static __device__ __forceinline__ float pow_cell(float x, float p) {
  if constexpr (kPow == 1) {
    return x;
  } else if constexpr (kPow == 3) {
    return x * x * x;
  } else {
    return exp2f(p * __log2f(x));
  }
}

// The register word of one vector load of kBytes bytes.
template <int kBytes>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

// kVec cells of type T, loaded as one word and widened to float on use.
template <typename T, int kVec>
struct Cells {
  static constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  typename Word<kBytes>::type word;

  __device__ __forceinline__ void load(const T* p) {
    word = __ldg(reinterpret_cast<const typename Word<kBytes>::type*>(p));
  }

  // cell k (a compile-time index after unrolling) as float32
  __device__ __forceinline__ float operator[](int k) const {
    if constexpr (kBytes == 2) {
      return __uint_as_float(static_cast<unsigned int>(word) << 16);
    } else {
      const unsigned int* u = reinterpret_cast<const unsigned int*>(&word);
      if constexpr (sizeof(T) == 4) {
        return __uint_as_float(u[k]);
      } else {  // two bf16 a word, the lower address in the low half
        const unsigned int w = u[k >> 1];
        return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
      }
    }
  }
};

// Where a lane starts in an image's valid rectangle of vh rows by vcols
// vectors, and how far its position moves per step of 32 vectors: computed
// once per thread, so the walk itself never divides.
struct Walk {
  int row0, col0, drow, dcol;
};

// The sum over one plane's valid cells of max(x, eps)^p, across the warp
// (every lane ends with the whole sum). Each round, a lane loads kUnroll
// vectors before it uses any; bit u * kVec + k of `inside` says whether
// cell k of vector u was loaded and lies inside the extent.
template <typename T, int kPow, int kVec>
static __device__ __forceinline__ float pool_plane(
    const T* __restrict__ plane, int w, int vh, int vw, int vcols,
    const Walk& walk, float eps, float p) {
  constexpr int kUnroll = kVec == 1 ? 8 : 4;  // at most 32 cells a round
  constexpr unsigned int kAll = (1u << kVec) - 1;
  float acc = 0.0f;
  int row = walk.row0;
  int col = walk.col0;
  while (row < vh) {
    Cells<T, kVec> cells[kUnroll];
    unsigned int inside = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row < vh) {
        cells[u].load(plane + row * w + col * kVec);
        const int lim = vw - col * kVec;  // cells of the vector inside
        inside |= (lim >= kVec ? kAll : (1u << lim) - 1) << (u * kVec);
      }
      col += walk.dcol;
      row += walk.drow;
      if (col >= vcols) {
        col -= vcols;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if ((inside >> (u * kVec + k)) & 1u) {
          acc += pow_cell<kPow>(fmaxf(cells[u][k], eps), p);
        }
      }
    }
  }
  return warp_sum(acc);
}

// This block's channels [c0, c1) of image img: pooled values into `pooled`
// (shared), and the sum of their squares returned to lane 0 of each warp.
template <typename T, int kPow, int kVec>
static __device__ __forceinline__ float pool_group(
    const T* __restrict__ x, float* pooled, int img, int c, int c0,
    int c1, int h, int w, int vh, int vw, float eps, float p) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int vcols = (vw + kVec - 1) / kVec;
  const float count = static_cast<float>(max(vh * vw, 1));
  const float inv_p = 1.0f / p;
  Walk walk = {vh, 0, 0, 0};  // an empty extent: no row to walk
  if (vh > 0 && vcols > 0) {
    walk.row0 = lane / vcols;
    walk.col0 = lane - walk.row0 * vcols;
    walk.drow = 32 / vcols;
    walk.dcol = 32 - walk.drow * vcols;
  }
  float sq = 0.0f;
  for (int ch = c0 + static_cast<int>(threadIdx.x >> 5); ch < c1;
       ch += warps) {
    const T* plane = x + (static_cast<long long>(img) * c + ch) * h * w;
    const float acc =
        pool_plane<T, kPow, kVec>(plane, w, vh, vw, vcols, walk, eps, p);
    if (lane == 0) {
      const float v = powf(acc / count, inv_p);
      pooled[ch - c0] = v;
      sq += v * v;
    }
  }
  return sq;
}

template <typename T, int kVec>
static __global__ void __launch_bounds__(kMaxThreads)
    gem_l2n_kernel(const T* __restrict__ x,
                   const int* __restrict__ valid_hw,
                   const float* __restrict__ p_ptr, float* __restrict__ out,
                   int c, int h, int w, int group, float eps) {
  extern __shared__ float pooled[];  // this block's group of pooled values
  __shared__ float warp_sq[kMaxWarps];
  __shared__ float block_sq;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int blocks = cluster.num_blocks();
  const unsigned int rank = cluster.block_rank();
  const int img = static_cast<int>(blockIdx.x / blocks);
  const int c0 = static_cast<int>(rank) * group;
  const int c1 = min(c0 + group, c);
  const int vh = min(max(valid_hw[2 * img], 0), h);
  const int vw = min(max(valid_hw[2 * img + 1], 0), w);
  const float p = *p_ptr;

  float sq;
  if (p == 1.0f) {
    sq = pool_group<T, 1, kVec>(x, pooled, img, c, c0, c1, h, w, vh, vw, eps,
                                p);
  } else if (p == 3.0f) {
    sq = pool_group<T, 3, kVec>(x, pooled, img, c, c0, c1, h, w, vh, vw, eps,
                                p);
  } else {
    sq = pool_group<T, 0, kVec>(x, pooled, img, c, c0, c1, h, w, vh, vw, eps,
                                p);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sq[warp] = sq;
  }
  __syncthreads();
  if (warp == 0) {
    sq = lane < static_cast<int>(blockDim.x >> 5) ? warp_sq[lane] : 0.0f;
    sq = warp_sum(sq);
    if (lane == 0) {
      block_sq = sq;
    }
  }
  // every block's block_sq and pooled[] are written and visible
  cluster.sync();
  float total = 0.0f;  // the same sum, in the same order, in every block
  for (unsigned int r = 0; r < blocks; ++r) {
    total += *cluster.map_shared_rank(&block_sq, r);
  }
  const float denom = sqrtf(total) + eps;
  float* dst = out + static_cast<long long>(img) * c + c0;
  for (int j = threadIdx.x; j < c1 - c0; j += blockDim.x) {
    dst[j] = pooled[j] / denom;
  }
  // no block leaves (and frees its shared memory) while another still
  // reads its block_sq
  cluster.sync();
}

template <typename T, int kVec>
static int launch(const T* x, const int* valid_hw, const float* p, float* out,
                  int n, int c, int cluster, int h, int w, int group,
                  int threads, float eps, void* stream) {
  void (*kernel)(const T*, const int*, const float*, float*, int, int, int,
                 int, float) = gem_l2n_kernel<T, kVec>;
  if (cluster > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(n) * cluster);
  config.blockDim = dim3(static_cast<unsigned int>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(group) * sizeof(float);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, x, valid_hw, p, out,
                                       c, h, w, group, eps);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

static bool bad_launch(int threads, int cluster, int group, int c) {
  return threads > kMaxThreads || threads % 32 != 0 || cluster < 1 ||
         static_cast<long long>(cluster) * group < c;
}

// x: (n, c, h, w) contiguous f32 (gem_l2n_f32) or bf16 (gem_l2n_bf16);
// valid_hw: (n, 2) int32; p: one f32; out: (n, c) f32. One launch of n
// clusters of `cluster` blocks of `threads` threads; block r of an image
// pools channels [r*group, min((r+1)*group, c)). vec is the cells a load
// reads: 4 or 1 for f32 (float4 loads need w % 4 == 0 and x 16-byte
// aligned), 8, 4, 2 or 1 for bf16 (w % vec == 0 and x aligned to 2 * vec
// bytes). The geometry comes from the wrapper
// (ops/pooling_kernel.py::launch_geometry). Returns the launch's CUDA error
// (0 when it was accepted).
extern "C" int gem_l2n_f32(const float* x, const int* valid_hw, const float* p,
                           float* out, int n, int c, int h, int w, int cluster,
                           int group, int threads, int vec, float eps,
                           void* stream) {
  if (n <= 0 || c <= 0) {
    return 0;
  }
  if ((vec != 4 && vec != 1) || bad_launch(threads, cluster, group, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return vec == 4 ? launch<float, 4>(x, valid_hw, p, out, n, c, cluster, h,
                                     w, group, threads, eps, stream)
                  : launch<float, 1>(x, valid_hw, p, out, n, c, cluster, h,
                                     w, group, threads, eps, stream);
}

extern "C" int gem_l2n_bf16(const __nv_bfloat16* x, const int* valid_hw,
                            const float* p, float* out, int n, int c, int h,
                            int w, int cluster, int group, int threads,
                            int vec, float eps, void* stream) {
  if (n <= 0 || c <= 0) {
    return 0;
  }
  if (bad_launch(threads, cluster, group, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (vec) {
    case 8:
      return launch<__nv_bfloat16, 8>(x, valid_hw, p, out, n, c, cluster, h,
                                      w, group, threads, eps, stream);
    case 4:
      return launch<__nv_bfloat16, 4>(x, valid_hw, p, out, n, c, cluster, h,
                                      w, group, threads, eps, stream);
    case 2:
      return launch<__nv_bfloat16, 2>(x, valid_hw, p, out, n, c, cluster, h,
                                      w, group, threads, eps, stream);
    case 1:
      return launch<__nv_bfloat16, 1>(x, valid_hw, p, out, n, c, cluster, h,
                                      w, group, threads, eps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
