// cv2-exact bucketed CLAHE for sm_90a: tile LUTs and LUT interpolation.
//
// Two kernels over a padded bucket of B images (B, BH, BW) of u8 values held
// in int32, each image with its own cv2 tile geometry computed on the host
// (mdir_tpu_torch/ops/clahe.py::clahe_bucket_aux). The host also picks each
// launch's shape (clahe.py::tile_luts_geometry, interp_geometry).
//
// 1. tile_luts_kernel replaces the Pallas TPU kernel
//    mdir_tpu/ops/clahe_pallas.py::_lut_kernel (tile_luts_pallas), in the
//    bucketed form of mdir_tpu/ops/clahe.py::_hist_dynamic + _luts_dynamic.
//    One block per (tile, image) counts the tile's histogram over cv2's
//    padded extent, reading each pixel through the reflect-101 maps row_src /
//    col_src. Then each of 256 threads owns one bin: clip at clim, add the
//    uniform clipped / 256 and cv2's strided residual (step = max(256 /
//    residual, 1), the first `residual` indices 0, step, 2 step, ...), an
//    inclusive scan gives the cdf, and lut = rint(cdf * scale) in [0, 255].
//    The TPU counted with one-hot MXU contractions and summed the cdf as a
//    triangular matmul, because it has no fast scatter or scan; shared-memory
//    atomics and a warp-shuffle scan are this card's direct form.
//    Bound: memory. It reads each pixel of the padded tiles once (int32) and
//    writes 256 floats per tile; the per-tile work is a few hundred
//    operations. What the design does to reach the memory rate:
//      * the tile's th row and tw column source indices are staged in shared
//        memory once, so no pixel load waits on a map load, and the block
//        walks its (row, column) items with counters, not a divide per item;
//      * over the tile's columns that are the image's own (the column map is
//        the identity there: all of a tile but the columns reaching into
//        cv2's reflected border), a 16-byte aligned bucket loads pixels 4 at
//        a time as int4; the 0-3 columns at either end that are off the
//        16-byte grid, and the reflected ones, load one at a time through
//        the column map. Each thread has kLutInFlight loads in flight, at
//        8 blocks an SM;
//      * each warp counts into its own 256-bin sub-histogram with shared
//        atomics, summed per bin before the clip. The card does not
//        serialize a warp's atomics on one bin: a constant image counts as
//        fast as a random one, and aggregating a warp's equal values with
//        __match_any_sync first costs more than it saves (PERF.md §6).
//
// 2. interp_kernel replaces clahe_pallas.py::_interp_dyn_kernel
//    (clahe_interp_bucketed_pallas). For each pixel:
//      f = i * inv_t - 0.5, i1 = floor(f), alpha = f - i1, i2 = i1 + 1,
//      both clamped to the grid, per axis, with the host's f32 inv_th/inv_tw;
//      res = (v11 (1 - xa) + v12 xa)(1 - ya) + (v21 (1 - xa) + v22 xa) ya
//    from the 4 neighbouring tiles' LUTs at the pixel's value, then rint and
//    clamp. Every multiply, add and subtract is an explicit round-to-nearest
//    intrinsic (__fmul_rn, __fadd_rn, __fsub_rn): nvcc contracts a*b + c
//    into an FMA by default, and one FMA changes the rounding of a blend that
//    sits on a .5 boundary, which is the TPU kernel's +-1 u8 error against
//    cv2. The TPU looked each value up in every tile's LUT with a one-hot
//    matmul.
//    Bound: memory. It reads one int32 and writes one float per pixel. A
//    block takes a strip of consecutive rows of one image:
//      * it stages in shared memory the LUTs of the tile rows its rows touch
//        (2 or 3 of 8 at the main path's tiles of 86-128 rows), as u8:
//        every LUT entry is an integer in [0, 255], so the copy is exact and
//        a quarter of the floats' size. The 4 gathers per pixel read shared
//        memory, not L1 lines;
//      * each row's tile coordinates are computed once, into shared memory;
//        each thread keeps a group of columns for the whole strip, with their
//        coordinates in registers;
//      * a thread loads 4 pixels with one 16-byte load and stores them with
//        one 16-byte store, kInterpInFlight rows in flight. A bucket whose
//        width is not a multiple of 4, or that is not 16-byte aligned, takes
//        one pixel a load.
//    No 64-bit divide, and no divide per pixel.
//
// Launches go to the caller's stream; each entry point returns
// cudaGetLastError() (0 when the launch was accepted), or a CUDA error code
// for a launch shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kHist = 256;          // bins; tile_luts' threads, one a bin
constexpr int kWarps = kHist / 32;  // tile_luts' warps and sub-histograms
constexpr int kLutInFlight = 2;     // tile_luts' int4 loads a thread
constexpr int kInterpInFlight = 4;  // interp's rows in flight a thread
constexpr int kMaxStripRows = 64;   // clahe.py::INTERP_MAX_ROWS
constexpr size_t kDefaultSharedBytes = 48 * 1024;

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

static __device__ __forceinline__ int u8_value(int v) {
  return min(max(v, 0), kHist - 1);
}

// Items t, t + stride, t + 2 stride, ... of a row-major walk over a grid of
// `cols` columns, as (r, c) counters: one divide when the walk starts, none
// per item.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int t, int stride, int ncols)
      : r(t / ncols), c(t % ncols), dr(stride / ncols), dc(stride % ncols),
        cols(ncols) {}
  __device__ void next() {
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// 8 blocks of 256 threads fill an SM: ptxas holds each thread to 32
// registers. Fewer loads in flight at full occupancy beat more at less.
static __global__ void __launch_bounds__(kHist, 8) tile_luts_kernel(
    const int* __restrict__ vals, const int* __restrict__ row_src,
    const int* __restrict__ col_src, const int* __restrict__ tile_h,
    const int* __restrict__ tile_w, const float* __restrict__ clim_f,
    const float* __restrict__ scale_f, float* __restrict__ luts, int bh,
    int bw, int gh, int gw, int max_th, int max_tw, int vec) {
  extern __shared__ int smem[];
  __shared__ int warp_total[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* hist = smem;                   // kWarps x 256
  int* rows = hist + kWarps * kHist;  // max_th source rows
  int* cols = rows + max_th;          // max_tw source columns
  const int tile = blockIdx.x;
  const int img = blockIdx.y;
  const int ty = tile / gw;
  const int tx = tile - ty * gw;
  const int th = tile_h[img];
  const int tw = tile_w[img];
  if (th > max_th || tw > max_tw) {
    __trap();  // the host sizes max_th, max_tw from the bucket
  }
  const int c0 = tx * tw;
  for (int i = tid; i < kWarps * kHist; i += kHist) {
    hist[i] = 0;
  }
  for (int i = tid; i < th; i += kHist) {
    rows[i] = row_src[static_cast<long long>(img) * (bh + gh) + ty * th + i];
  }
  for (int i = tid; i < tw; i += kHist) {
    cols[i] = col_src[static_cast<long long>(img) * (bw + gw) + c0 + i];
  }
  __syncthreads();

  const int* image = vals + static_cast<long long>(img) * bh * bw;
  int* own = hist + warp * kHist;
  // The tile's columns that are the image's own: col_src[i] == i exactly
  // for i below the image's width (past it, cv2's reflection maps i to an
  // earlier column), so they are a prefix of the tile, counted by ballot.
  int inside = 0;
  for (int j = lane; j - lane < tw; j += 32) {
    inside += __popc(
        __ballot_sync(0xffffffffu, j < tw && cols[j] == c0 + j));
  }
  // Of those, the columns on the 16-byte grid, [head, head + 4 nvec), load
  // as int4; the others load one at a time through the map.
  int head = tw;
  int nvec = 0;
  if (vec) {
    const int first = (c0 + 3) & ~3;
    const int end = (c0 + inside) & ~3;
    if (end > first) {
      head = first - c0;
      nvec = (end - first) >> 2;
    }
  }
  if (nvec > 0) {
    const int* base = image + c0 + head;
    Walk w(tid, kHist, nvec);
    for (int done = 0; done < th * nvec; done += kLutInFlight * kHist) {
      int4 q[kLutInFlight];
      bool ok[kLutInFlight];
#pragma unroll
      for (int k = 0; k < kLutInFlight; ++k) {
        ok[k] = w.r < th;
        if (ok[k]) {
          q[k] = __ldg(reinterpret_cast<const int4*>(base + rows[w.r] * bw) +
                       w.c);
        }
        w.next();
      }
#pragma unroll
      for (int k = 0; k < kLutInFlight; ++k) {
        if (ok[k]) {
          atomicAdd(own + u8_value(q[k].x), 1);
          atomicAdd(own + u8_value(q[k].y), 1);
          atomicAdd(own + u8_value(q[k].z), 1);
          atomicAdd(own + u8_value(q[k].w), 1);
        }
      }
    }
  }
  const int single = tw - 4 * nvec;  // columns [0, head) and after the int4s
  if (single > 0) {
    Walk w(tid, kHist, single);
    for (int done = 0; done < th * single; done += kLutInFlight * kHist) {
      int v[kLutInFlight];
      bool ok[kLutInFlight];
#pragma unroll
      for (int k = 0; k < kLutInFlight; ++k) {
        ok[k] = w.r < th;
        if (ok[k]) {
          const int c = w.c < head ? w.c : w.c + 4 * nvec;
          v[k] = __ldg(image + rows[w.r] * bw + cols[c]);
        }
        w.next();
      }
#pragma unroll
      for (int k = 0; k < kLutInFlight; ++k) {
        if (ok[k]) {
          atomicAdd(own + u8_value(v[k]), 1);
        }
      }
    }
  }
  __syncthreads();

  const int bin = tid;
  int h = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    h += hist[i * kHist + bin];
  }
  // clip and redistribute (cv2: uniform batch + strided residual)
  const int clim = static_cast<int>(clim_f[img]);
  const int excess = warp_sum(max(h - clim, 0));
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

// A u8 LUT entry as a float, exactly: the bits of 2^23 + b, less 2^23 (two
// full-rate operations, where a conversion runs at a sixteenth of the rate).
static __device__ __forceinline__ float u8_float(unsigned int b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

static __device__ __forceinline__ float blend(const unsigned char* lo_row,
                                              const unsigned char* hi_row,
                                              int t1, int t2, float xa,
                                              float xa1, float ya, float ya1,
                                              int v) {
  v = u8_value(v);
  const float v11 = u8_float(lo_row[t1 + v]);
  const float v12 = u8_float(lo_row[t2 + v]);
  const float v21 = u8_float(hi_row[t1 + v]);
  const float v22 = u8_float(hi_row[t2 + v]);
  const float top = __fadd_rn(__fmul_rn(v11, xa1), __fmul_rn(v12, xa));
  const float bottom = __fadd_rn(__fmul_rn(v21, xa1), __fmul_rn(v22, xa));
  const float res = __fadd_rn(__fmul_rn(top, ya1), __fmul_rn(bottom, ya));
  return fminf(fmaxf(rintf(res), 0.0f), 255.0f);
}

static __device__ __forceinline__ unsigned int lut_byte(float f) {
  return static_cast<unsigned int>(f);
}

template <int kVec>
static __device__ __forceinline__ void load_pixels(const int* p,
                                                   int (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kVec>
static __device__ __forceinline__ void store_pixels(float* p,
                                                    const float (&o)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    p[0] = o[0];
  }
}

template <int kVec>
static __global__ void interp_kernel(const int* __restrict__ vals,
                                     const float* __restrict__ luts,
                                     const float* __restrict__ inv_th,
                                     const float* __restrict__ inv_tw,
                                     float* __restrict__ out, int bh, int bw,
                                     int gh, int gw, int strip_rows,
                                     int staged_rows) {
  extern __shared__ __align__(16) unsigned char staged[];  // u8 LUT rows
  __shared__ int row_lo[kMaxStripRows];  // offsets into staged, per row
  __shared__ int row_hi[kMaxStripRows];
  __shared__ float row_a[kMaxStripRows];
  const int img = blockIdx.y;
  const int y0 = blockIdx.x * strip_rows;
  const int rows = min(strip_rows, bh - y0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int tile_row = gw * kHist;  // one tile row's LUT entries

  // the strip's tile rows: [first, last], monotone in the row index
  const float inv_y = __ldg(inv_th + img);
  int first, last, unused;
  float alpha;
  axis_coord(y0, inv_y, gh, &first, &unused, &alpha);
  axis_coord(y0 + rows - 1, inv_y, gh, &unused, &last, &alpha);
  const int span = last - first + 1;
  if (span > staged_rows) {
    __trap();  // the host stages min(gh, strip_rows + 1) tile rows
  }
  for (int r = tid; r < rows; r += nthreads) {
    int lo, hi;
    axis_coord(y0 + r, inv_y, gh, &lo, &hi, &row_a[r]);
    row_lo[r] = (lo - first) * tile_row;
    row_hi[r] = (hi - first) * tile_row;
  }
  const float* src =
      luts + (static_cast<long long>(img) * gh + first) * tile_row;
  const int entries = span * tile_row;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = tid; i < entries / 4; i += nthreads) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src) + i);
      reinterpret_cast<unsigned int*>(staged)[i] =
          lut_byte(f.x) | lut_byte(f.y) << 8 | lut_byte(f.z) << 16 |
          lut_byte(f.w) << 24;
    }
  } else {
    for (int i = tid; i < entries; i += nthreads) {
      staged[i] = static_cast<unsigned char>(lut_byte(__ldg(src + i)));
    }
  }
  __syncthreads();

  const float inv_x = __ldg(inv_tw + img);
  const long long row0 = (static_cast<long long>(img) * bh + y0) * bw;
  for (int g = threadIdx.x; g < bw / kVec; g += blockDim.x) {
    const int x0 = g * kVec;
    int t1[kVec], t2[kVec];
    float xa[kVec], xa1[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      int lo, hi;
      axis_coord(x0 + j, inv_x, gw, &lo, &hi, &xa[j]);
      t1[j] = lo * kHist;
      t2[j] = hi * kHist;
      xa1[j] = __fsub_rn(1.0f, xa[j]);
    }
    for (int r0 = threadIdx.y; r0 < rows; r0 += kInterpInFlight * blockDim.y) {
      int v[kInterpInFlight][kVec];
#pragma unroll
      for (int k = 0; k < kInterpInFlight; ++k) {
        const int r = r0 + k * blockDim.y;
        if (r < rows) {
          load_pixels<kVec>(vals + row0 + static_cast<long long>(r) * bw + x0,
                            v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kInterpInFlight; ++k) {
        const int r = r0 + k * blockDim.y;
        if (r < rows) {
          const unsigned char* lo_row = staged + row_lo[r];
          const unsigned char* hi_row = staged + row_hi[r];
          const float ya = row_a[r];
          const float ya1 = __fsub_rn(1.0f, ya);
          float o[kVec];
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            o[j] = blend(lo_row, hi_row, t1[j], t2[j], xa[j], xa1[j], ya, ya1,
                         v[k][j]);
          }
          store_pixels<kVec>(out + row0 + static_cast<long long>(r) * bw + x0,
                             o);
        }
      }
    }
  }
}

template <typename Kernel>
static cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) {
    return cudaSuccess;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// vals: (b, bh, bw) int32, bh * bw < 2^31; row_src: (b, bh + gh) and
// col_src: (b, bw + gw) int32; tile_h, tile_w: (b,) int32, at most max_th,
// max_tw; clim, scale: (b,) f32; luts: (b, gh*gw, 256) f32 out. vec: 1 for
// int4 loads (bw % 4 == 0 and vals 16-byte aligned), else 0.
extern "C" int clahe_tile_luts_i32(const int* vals, const int* row_src,
                                   const int* col_src, const int* tile_h,
                                   const int* tile_w, const float* clim,
                                   const float* scale, float* luts, int b,
                                   int bh, int bw, int gh, int gw,
                                   int max_th, int max_tw, int vec,
                                   void* stream) {
  if (b <= 0) {
    return 0;
  }
  if (vec && (bw % 4 != 0 || !aligned16(vals))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(kWarps) * kHist + max_th + max_tw);
  const dim3 grid(static_cast<unsigned int>(gh * gw),
                  static_cast<unsigned int>(b));
  const cudaError_t err = allow_shared(tile_luts_kernel, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  tile_luts_kernel<<<grid, kHist, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, row_src, col_src, tile_h, tile_w, clim, scale, luts, bh, bw, gh,
      gw, max_th, max_tw, vec);
  return static_cast<int>(cudaGetLastError());
}

// vals: (b, bh, bw) int32; luts: (b, gh*gw, 256) f32 of integers in
// [0, 255]; inv_th, inv_tw: (b,) f32; out: (b, bh, bw) f32. vec: 4 (bw % 4
// == 0, vals and out 16-byte aligned) or 1 pixels a load; strip_rows: rows
// a block, at most kMaxStripRows; staged_rows: tile rows of LUTs a block
// stages, at least min(gh, strip_rows + 1); threads_x x threads_y threads.
extern "C" int clahe_interp_i32(const int* vals, const float* luts,
                                const float* inv_th, const float* inv_tw,
                                float* out, int b, int bh, int bw, int gh,
                                int gw, int vec, int strip_rows,
                                int staged_rows, int threads_x,
                                int threads_y, void* stream) {
  if (b <= 0 || bh <= 0 || bw <= 0) {
    return 0;
  }
  if (strip_rows < 1 || strip_rows > kMaxStripRows ||
      staged_rows < (gh < strip_rows + 1 ? gh : strip_rows + 1) ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && (bw % 4 != 0 || !aligned16(vals) || !aligned16(out)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(staged_rows) * gw * kHist;
  const dim3 grid(static_cast<unsigned int>((bh + strip_rows - 1) /
                                            strip_rows),
                  static_cast<unsigned int>(b));
  const dim3 block(static_cast<unsigned int>(threads_x),
                   static_cast<unsigned int>(threads_y));
  const auto kernel = vec == 4 ? interp_kernel<4> : interp_kernel<1>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, luts, inv_th, inv_tw, out, bh, bw, gh, gw, strip_rows,
      staged_rows);
  return static_cast<int>(cudaGetLastError());
}
