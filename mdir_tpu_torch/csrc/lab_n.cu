// cv2-exact RGB -> Lab lattice values of uint8 RGB pixels, for sm_90a.
//
// Replaces the Pallas TPU kernel mdir_tpu/ops/lab_trilinear.py::_lab_v3_kernel
// (launched by lab_n_pallas). Same function, not the TPU's form: the TPU
// builds one-hot corner weights and contracts them against the node table on
// the MXU because it gathers slowly; this card gathers well, so each thread
// reads its pixels' lattice corners directly. For one pixel (r, g, b):
//   (tx, w) = tables[v] for each channel   (host-made, cv2's f32 rounding)
//   acc[c]  = sum over dx, dy, dz in {0, 1} of
//             node[min(tx_r+dx, 32), min(tx_g+dy, 32), min(tx_b+dz, 32), c]
//             * wx * wy * wz,   wx = dx ? w_r : 16 - w_r (likewise y, z)
//   n[c]    = (acc[c] + 2048) >> 12
// Everything is int32 (acc <= 2^14 * 16^3 = 2^26); there is no floating
// point in the kernel, so the result is bit-equal to the plain version.
//
// Bound: memory. Per pixel it reads 3 bytes and writes 12 (three int32) and
// does about 50 integer operations, under what the card computes in the time
// the bytes take. What holds it back is the corner gathers, through L1: a
// warp's 16-byte gather hands out 512 bytes, at least 4 of the L1's 128-byte
// cycles even when every lane reads one entry, plus a pass for each further
// 128-byte line its lanes touch. The design cuts loads and lines:
//   * a corner-pair table made on the host (ops/lab_trilinear.py::
//     _packed_tables): entry (ix, iy, iz) holds node (ix, iy, iz) and node
//     (ix, iy, min(iz+1, 32)) as int16 pairs per channel, (n0, n1) for L,
//     a, b, padded to 16 bytes. So the 8 corners are 4 aligned 16-byte
//     loads (the first version made 24 two-byte loads), and __dp2a_lo folds
//     each pair with the packed weights (16 - wz, wz) in one instruction;
//   * the entries lie in 2 x 2 x 2 bricks, one 128-byte line each (17^3
//     bricks, 629 KB, which stays in L2): lanes whose colours are near each
//     other, and one pixel's 4 loads, touch fewer lines than in row-major
//     order;
//   * the 256 (tx | w << 8) entries sit in shared memory, loaded once per
//     block of 512 threads;
//   * 4 pixels per thread: the 12 input bytes as three 32-bit loads and the
//     48 output bytes as three 16-byte stores. The last, ragged warp of a
//     launch, and an input that is not 4-byte aligned, take byte loads and
//     int32 stores instead.
// Staging the pixel I/O through shared memory for full coalescing measured
// slower: shared memory and L1 share one data path, and the gathers need it.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 512;
constexpr int kValues = 256;  // (tx, w) entries, one per u8 value
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerThread = 4;
constexpr int kPixelsPerWarp = 32 * kPixelsPerThread;
constexpr int kNodes = 33;
constexpr int kBricks = (kNodes + 1) / 2;  // 17 bricks of 2 nodes an axis

struct Lab {
  int l, a, b;
};

// Offsets of lattice coordinate i in the brick order, per axis: entry
// (ix, iy, iz) is at brick_x(ix) + brick_y(iy) + brick_z(iz).
static __device__ __forceinline__ int brick_x(int i) {
  return (i >> 1) * (kBricks * kBricks * 8) + ((i & 1) << 2);
}
static __device__ __forceinline__ int brick_y(int i) {
  return (i >> 1) * (kBricks * 8) + ((i & 1) << 1);
}
static __device__ __forceinline__ int brick_z(int i) {
  return (i >> 1) * 8 + (i & 1);
}

static __device__ __forceinline__ Lab lab_pixel(
    unsigned int r, unsigned int g, unsigned int b, const int* tw,
    const int4* __restrict__ pairs) {
  const int er = tw[r];
  const int eg = tw[g];
  const int eb = tw[b];
  const int tx = er & 0xff;
  const int wx = er >> 8;
  const int ty = eg & 0xff;
  const int wy = eg >> 8;
  const int tz = eb & 0xff;
  const int wz = eb >> 8;
  const int x0 = brick_x(tx);
  const int x1 = brick_x(min(tx + 1, kNodes - 1));
  const int z = brick_z(tz);
  const int y0 = brick_y(ty) + z;
  const int y1 = brick_y(min(ty + 1, kNodes - 1)) + z;
  const int4 c00 = __ldg(pairs + x0 + y0);
  const int4 c01 = __ldg(pairs + x0 + y1);
  const int4 c10 = __ldg(pairs + x1 + y0);
  const int4 c11 = __ldg(pairs + x1 + y1);
  // bytes (16 - wz, wz): __dp2a_lo(pair, wz2, 0) = n0 * (16 - wz) + n1 * wz
  const int wz2 = (16 - wz) | (wz << 8);
  const int w00 = (16 - wx) * (16 - wy);
  const int w01 = (16 - wx) * wy;
  const int w10 = wx * (16 - wy);
  const int w11 = wx * wy;
  Lab o;
  o.l = __dp2a_lo(c00.x, wz2, 0) * w00 + __dp2a_lo(c01.x, wz2, 0) * w01 +
        __dp2a_lo(c10.x, wz2, 0) * w10 + __dp2a_lo(c11.x, wz2, 0) * w11;
  o.a = __dp2a_lo(c00.y, wz2, 0) * w00 + __dp2a_lo(c01.y, wz2, 0) * w01 +
        __dp2a_lo(c10.y, wz2, 0) * w10 + __dp2a_lo(c11.y, wz2, 0) * w11;
  o.b = __dp2a_lo(c00.z, wz2, 0) * w00 + __dp2a_lo(c01.z, wz2, 0) * w01 +
        __dp2a_lo(c10.z, wz2, 0) * w10 + __dp2a_lo(c11.z, wz2, 0) * w11;
  o.l = (o.l + 2048) >> 12;
  o.a = (o.a + 2048) >> 12;
  o.b = (o.b + 2048) >> 12;
  return o;
}

static __global__ void __launch_bounds__(kThreads)
    lab_n_kernel(const uint8_t* __restrict__ rgb,
                 const int* __restrict__ tw_table,
                 const int4* __restrict__ pairs, int* __restrict__ out,
                 long long pixels, int words_aligned) {
  __shared__ int tw[kValues];
  if (threadIdx.x < kValues) {
    tw[threadIdx.x] = tw_table[threadIdx.x];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kPixelsPerWarp;
  const long long quad = first / kPixelsPerThread + lane;  // 4 pixels
  if (words_aligned && first + kPixelsPerWarp <= pixels) {
    // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
    const unsigned int* src =
        reinterpret_cast<const unsigned int*>(rgb) + 3 * quad;
    const unsigned int w0 = __ldg(src);
    const unsigned int w1 = __ldg(src + 1);
    const unsigned int w2 = __ldg(src + 2);
    const Lab q0 = lab_pixel(w0 & 0xff, (w0 >> 8) & 0xff, (w0 >> 16) & 0xff,
                             tw, pairs);
    const Lab q1 = lab_pixel(w0 >> 24, w1 & 0xff, (w1 >> 8) & 0xff, tw,
                             pairs);
    const Lab q2 = lab_pixel((w1 >> 16) & 0xff, w1 >> 24, w2 & 0xff, tw,
                             pairs);
    const Lab q3 = lab_pixel((w2 >> 8) & 0xff, (w2 >> 16) & 0xff, w2 >> 24,
                             tw, pairs);
    int4* dst = reinterpret_cast<int4*>(out) + 3 * quad;
    dst[0] = make_int4(q0.l, q0.a, q0.b, q1.l);
    dst[1] = make_int4(q1.a, q1.b, q2.l, q2.a);
    dst[2] = make_int4(q2.b, q3.l, q3.a, q3.b);
  } else {
    // the launch's ragged end, or an input that is not 4-byte aligned
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
      const long long i = quad * kPixelsPerThread + k;
      if (i < pixels) {
        const uint8_t* px = rgb + 3 * i;
        const Lab q = lab_pixel(px[0], px[1], px[2], tw, pairs);
        int* d = out + 3 * i;
        d[0] = q.l;
        d[1] = q.a;
        d[2] = q.b;
      }
    }
  }
}

// rgb: (pixels, 3) uint8; tw_table: 256 int32 (tx | w << 8); pairs: 17^3
// bricks of 8 entries of 8 int16, 16-byte aligned; out: (pixels, 3) int32,
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int lab_n_u8(const uint8_t* rgb, const int* tw_table,
                        const void* pairs, int* out, long long pixels,
                        void* stream) {
  if (pixels <= 0) {
    return 0;
  }
  if ((reinterpret_cast<uintptr_t>(pairs) | reinterpret_cast<uintptr_t>(out))
      & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long per_block = static_cast<long long>(kThreads) *
                              kPixelsPerThread;
  const unsigned int blocks =
      static_cast<unsigned int>((pixels + per_block - 1) / per_block);
  const int words_aligned = (reinterpret_cast<uintptr_t>(rgb) & 3) == 0;
  lab_n_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rgb, tw_table, static_cast<const int4*>(pairs), out, pixels,
      words_aligned);
  return static_cast<int>(cudaGetLastError());
}
