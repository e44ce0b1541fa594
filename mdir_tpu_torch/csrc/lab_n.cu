// cv2-exact RGB -> Lab lattice values of uint8 RGB pixels, for sm_90a.
//
// Replaces the Pallas TPU kernel mdir_tpu/ops/lab_trilinear.py::_lab_v3_kernel
// (launched by lab_n_pallas). Same function, not the TPU's form: the TPU
// builds one-hot corner weights and contracts them against the node table on
// the MXU because it gathers slowly; this card gathers well, so each thread
// reads its pixel's 8 lattice corners directly. For one pixel (r, g, b):
//   (tx, w) = tables[v] for each channel   (host-made, cv2's f32 rounding)
//   acc[c]  = sum over dx, dy, dz in {0, 1} of
//             node[min(tx_r+dx, 32), min(tx_g+dy, 32), min(tx_b+dz, 32), c]
//             * wx * wy * wz,   wx = dx ? w_r : 16 - w_r (likewise y, z)
//   n[c]    = (acc[c] + 2048) >> 12
// Everything is int32 (acc <= 2^14 * 16^3 = 2^26); there is no floating
// point in the kernel, so the result is bit-equal to the plain version.
//
// Bound: memory. Per pixel it reads 3 bytes and writes 12 (three int32) and
// does about 70 integer operations, well under what the card computes in the
// time the bytes take. The node table (216 KB, int16) and the 256-entry
// corner tables are read through the read-only cache (__ldg); they stay in
// L1/L2 across the whole launch. One thread per pixel, consecutive threads
// on consecutive pixels, so input and output accesses coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kNodes = 33;

static __global__ void lab_n_kernel(const uint8_t* __restrict__ rgb,
                                    const int* __restrict__ tx_table,
                                    const int* __restrict__ w_table,
                                    const short* __restrict__ node,
                                    int* __restrict__ out,
                                    long long pixels) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pixels) {
    return;
  }
  const uint8_t* px = rgb + 3 * i;
  const int r = px[0];
  const int g = px[1];
  const int b = px[2];
  const int t0 = __ldg(tx_table + r);
  const int t1 = __ldg(tx_table + g);
  const int t2 = __ldg(tx_table + b);
  const int f0 = __ldg(w_table + r);
  const int f1 = __ldg(w_table + g);
  const int f2 = __ldg(w_table + b);

  int acc0 = 0;
  int acc1 = 0;
  int acc2 = 0;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int wx = dx ? f0 : 16 - f0;
    const int ix = min(t0 + dx, kNodes - 1);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int wxy = wx * (dy ? f1 : 16 - f1);
      const int iy = min(t1 + dy, kNodes - 1);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int weight = wxy * (dz ? f2 : 16 - f2);
        const int iz = min(t2 + dz, kNodes - 1);
        const short* corner = node + ((ix * kNodes + iy) * kNodes + iz) * 3;
        acc0 += static_cast<int>(__ldg(corner)) * weight;
        acc1 += static_cast<int>(__ldg(corner + 1)) * weight;
        acc2 += static_cast<int>(__ldg(corner + 2)) * weight;
      }
    }
  }
  int* dst = out + 3 * i;
  dst[0] = (acc0 + 2048) >> 12;
  dst[1] = (acc1 + 2048) >> 12;
  dst[2] = (acc2 + 2048) >> 12;
}

// rgb: (pixels, 3) uint8; tx_table, w_table: 256 int32 each; node: (33, 33,
// 33, 3) int16; out: (pixels, 3) int32. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int lab_n_u8(const uint8_t* rgb, const int* tx_table,
                        const int* w_table, const short* node, int* out,
                        long long pixels, void* stream) {
  if (pixels <= 0) {
    return 0;
  }
  const unsigned int blocks =
      static_cast<unsigned int>((pixels + kThreads - 1) / kThreads);
  lab_n_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rgb, tx_table, w_table, node, out, pixels);
  return static_cast<int>(cudaGetLastError());
}
