// cv2-exact bucketed CLAHE for sm_90a: tile LUTs and LUT interpolation.
//
// Two kernels over a padded bucket of B images (B, BH, BW) of u8 values held
// in int32, each image with its own cv2 tile geometry computed on the host
// (mdir_tpu_torch/ops/clahe.py::clahe_bucket_aux).
//
// 1. tile_luts_kernel replaces the Pallas TPU kernel
//    mdir_tpu/ops/clahe_pallas.py::_lut_kernel (tile_luts_pallas), in the
//    bucketed form of mdir_tpu/ops/clahe.py::_hist_dynamic + _luts_dynamic.
//    One block per (tile, image). The block counts the tile's histogram in
//    shared memory with atomicAdd over the rows and columns of cv2's padded
//    extent, reading each pixel through the reflect-101 maps row_src /
//    col_src. Then each of the 256 threads owns one bin: clip at clim, add
//    the uniform clipped / 256 and cv2's strided residual (step = max(256 /
//    residual, 1), the first `residual` indices 0, step, 2 step, ...), an
//    inclusive scan gives the cdf, and lut = rint(cdf * scale) in [0, 255].
//    The TPU counted with one-hot MXU contractions and summed the cdf as a
//    triangular matmul, because it has no fast scatter or scan; shared-memory
//    atomics and a warp-shuffle scan are this card's direct form.
//    Bound: memory. It reads each pixel of the padded tiles once (int32) and
//    writes 256 floats per tile; the per-tile work is a few hundred
//    operations.
//
// 2. interp_kernel replaces clahe_pallas.py::_interp_dyn_kernel
//    (clahe_interp_bucketed_pallas). One thread per pixel of the bucket:
//      f = i * inv_t - 0.5, i1 = floor(f), alpha = f - i1, i2 = i1 + 1,
//      both clamped to the grid, per axis, with the host's f32 inv_th/inv_tw;
//      res = (v11 (1 - xa) + v12 xa)(1 - ya) + (v21 (1 - xa) + v22 xa) ya
//    from the 4 neighbouring tiles' LUTs at the pixel's value, then rint and
//    clamp. Every multiply, add and subtract is an explicit round-to-nearest
//    intrinsic (__fmul_rn, __fadd_rn, __fsub_rn): nvcc contracts a*b + c
//    into an FMA by default, and one FMA changes the rounding of a blend that
//    sits on a .5 boundary, which is the TPU kernel's +-1 u8 error against
//    cv2. The TPU looked each value up in every tile's LUT with a one-hot
//    matmul; here each thread reads its 4 entries through the read-only
//    cache (the LUTs of a bucket are 64 KB per image at an 8x8 grid).
//    Bound: memory. It reads one int32 and writes one float per pixel.
//
// Launches go to the caller's stream; each entry point returns
// cudaGetLastError() (0 when the launch was accepted).

#include <cuda_runtime.h>

constexpr int kHist = 256;
constexpr int kWarps = kHist / 32;
constexpr int kInterpThreads = 256;

static __device__ __forceinline__ int warp_sum(int v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

static __device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, offset);
    if (lane >= offset) {
      v += up;
    }
  }
  return v;
}

static __global__ void tile_luts_kernel(
    const int* __restrict__ vals, const int* __restrict__ row_src,
    const int* __restrict__ col_src, const int* __restrict__ tile_h,
    const int* __restrict__ tile_w, const float* __restrict__ clim_f,
    const float* __restrict__ scale_f, float* __restrict__ luts, int bh,
    int bw, int gh, int gw) {
  __shared__ int hist[kHist];
  __shared__ int warp_total[kWarps];
  const int bin = threadIdx.x;
  const int lane = bin & 31;
  const int warp = bin >> 5;
  const int tile = blockIdx.x;
  const int img = blockIdx.y;
  const int ty = tile / gw;
  const int tx = tile - ty * gw;
  const int th = tile_h[img];
  const int tw = tile_w[img];
  const int* rows =
      row_src + static_cast<long long>(img) * (bh + gh) + ty * th;
  const int* cols =
      col_src + static_cast<long long>(img) * (bw + gw) + tx * tw;
  const int* image = vals + static_cast<long long>(img) * bh * bw;

  hist[bin] = 0;
  __syncthreads();
  const int area = th * tw;
  for (int k = bin; k < area; k += kHist) {
    const int r = k / tw;
    const int c = k - r * tw;
    const int v = __ldg(image + static_cast<long long>(__ldg(rows + r)) * bw +
                        __ldg(cols + c));
    if (static_cast<unsigned int>(v) < kHist) {
      atomicAdd(&hist[v], 1);
    }
  }
  __syncthreads();

  // clip and redistribute (cv2: uniform batch + strided residual)
  const int clim = static_cast<int>(clim_f[img]);
  int h = hist[bin];
  int excess = warp_sum(max(h - clim, 0));
  if (lane == 0) {
    warp_total[warp] = excess;
  }
  __syncthreads();
  int clipped = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    clipped += warp_total[i];
  }
  __syncthreads();  // warp_total is reused by the scan below
  const int batch = clipped / kHist;
  const int residual = clipped - batch * kHist;
  h = min(h, clim) + batch;
  if (residual > 0) {
    const int step = max(kHist / residual, 1);
    if (bin % step == 0 && bin / step < residual) {
      h += 1;
    }
  }

  // inclusive scan over the 256 bins
  int cdf = warp_inclusive_scan(h, lane);
  if (lane == 31) {
    warp_total[warp] = cdf;
  }
  __syncthreads();
  for (int i = 0; i < warp; ++i) {
    cdf += warp_total[i];
  }
  const float lut = rintf(__fmul_rn(static_cast<float>(cdf), scale_f[img]));
  luts[(static_cast<long long>(img) * gh * gw + tile) * kHist + bin] =
      fminf(fmaxf(lut, 0.0f), 255.0f);
}

// Lower and upper tile and the blend weight of index i along one axis.
static __device__ __forceinline__ void axis_coord(int i, float inv_t,
                                                  int tiles, int* lo, int* hi,
                                                  float* alpha) {
  const float f = __fsub_rn(__fmul_rn(static_cast<float>(i), inv_t), 0.5f);
  const float fl = floorf(f);
  *alpha = __fsub_rn(f, fl);
  const int i1 = static_cast<int>(fl);
  *hi = min(max(i1 + 1, 0), tiles - 1);
  *lo = min(max(i1, 0), tiles - 1);
}

static __global__ void interp_kernel(const int* __restrict__ vals,
                                     const float* __restrict__ luts,
                                     const float* __restrict__ inv_th,
                                     const float* __restrict__ inv_tw,
                                     float* __restrict__ out, int bh, int bw,
                                     int gh, int gw, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kInterpThreads + threadIdx.x;
  if (i >= total) {
    return;
  }
  const int x = static_cast<int>(i % bw);
  const long long rest = i / bw;
  const int y = static_cast<int>(rest % bh);
  const int img = static_cast<int>(rest / bh);

  int ty1, ty2, tx1, tx2;
  float ya, xa;
  axis_coord(y, __ldg(inv_th + img), gh, &ty1, &ty2, &ya);
  axis_coord(x, __ldg(inv_tw + img), gw, &tx1, &tx2, &xa);
  const int v = min(max(vals[i], 0), kHist - 1);
  const float* lut = luts + static_cast<long long>(img) * gh * gw * kHist + v;
  const float v11 = __ldg(lut + (ty1 * gw + tx1) * kHist);
  const float v12 = __ldg(lut + (ty1 * gw + tx2) * kHist);
  const float v21 = __ldg(lut + (ty2 * gw + tx1) * kHist);
  const float v22 = __ldg(lut + (ty2 * gw + tx2) * kHist);
  const float xa1 = __fsub_rn(1.0f, xa);
  const float ya1 = __fsub_rn(1.0f, ya);
  const float top = __fadd_rn(__fmul_rn(v11, xa1), __fmul_rn(v12, xa));
  const float bottom = __fadd_rn(__fmul_rn(v21, xa1), __fmul_rn(v22, xa));
  const float res = __fadd_rn(__fmul_rn(top, ya1), __fmul_rn(bottom, ya));
  out[i] = fminf(fmaxf(rintf(res), 0.0f), 255.0f);
}

// vals: (b, bh, bw) int32; row_src: (b, bh + gh) and col_src: (b, bw + gw)
// int32; tile_h, tile_w: (b,) int32; clim, scale: (b,) f32; luts: (b, gh*gw,
// 256) f32 out.
extern "C" int clahe_tile_luts_i32(const int* vals, const int* row_src,
                                   const int* col_src, const int* tile_h,
                                   const int* tile_w, const float* clim,
                                   const float* scale, float* luts, int b,
                                   int bh, int bw, int gh, int gw,
                                   void* stream) {
  if (b <= 0) {
    return 0;
  }
  const dim3 grid(static_cast<unsigned int>(gh * gw),
                  static_cast<unsigned int>(b));
  tile_luts_kernel<<<grid, kHist, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, row_src, col_src, tile_h, tile_w, clim, scale, luts, bh, bw, gh,
      gw);
  return static_cast<int>(cudaGetLastError());
}

// vals: (b, bh, bw) int32; luts: (b, gh*gw, 256) f32; inv_th, inv_tw: (b,)
// f32; out: (b, bh, bw) f32.
extern "C" int clahe_interp_i32(const int* vals, const float* luts,
                                const float* inv_th, const float* inv_tw,
                                float* out, int b, int bh, int bw, int gh,
                                int gw, void* stream) {
  const long long total = static_cast<long long>(b) * bh * bw;
  if (total <= 0) {
    return 0;
  }
  const unsigned int blocks = static_cast<unsigned int>(
      (total + kInterpThreads - 1) / kInterpThreads);
  interp_kernel<<<blocks, kInterpThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      vals, luts, inv_th, inv_tw, out, bh, bw, gh, gw, total);
  return static_cast<int>(cudaGetLastError());
}
