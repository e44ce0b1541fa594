// Masked GeM pooling + L2 normalisation of NCHW float32, bfloat16 or float16
// features, for sm_90a.
//
// Replaces the Pallas TPU kernel mdir_tpu/ops/pooling_pallas.py::_gem_kernel
// (launched by gem_l2n_pallas). It computes the same function, not the TPU's
// grid: for each image n and channel c
//   acc    = sum over cells h < vh[n], w < vw[n] of max(x, eps)^p
//   pooled = (acc / max(vh * vw, 1))^(1/p)
// and then out[n, :] = pooled[n, :] / (||pooled[n, :]||_2 + eps).
// 16-bit cells widen to float32 exactly (bfloat16 by a bit shift, float16 by
// the hardware conversion); the powers, sums, root and L2N all run in float32
// and the output is float32 (N, C). (The TPU kernel keeps bf16 sums; float32
// is more exact, and the reference's bf16 guard bounds what either drifts.)
//
// Bound: memory. The function reads every valid cell once and writes N*C
// floats. On 16-bit maps the bytes halve, so the per-cell instructions and
// the special-function unit (SFU: 16 results a clock per SM) weigh twice as
// much against them: at the ResNet map (16, 2048, 32, 24), 25 M cells, two
// SFU ops a cell (log2 and exp2) took about 12-14 us of the 15.1 us the
// bytes take. The design:
//   * One launch of plain blocks, no clusters: `blocks` blocks an image,
//     block r pooling the contiguous span of channels [r*group, (r+1)*group)
//     of NCHW. (A cluster of 16 blocks an image left 16 of the 132 SMs
//     idle and put three blocks on others: clusters are placed whole
//     within a GPC.) A block keeps each channel's raw sum in shared
//     memory and after its last plane takes every root and square at once
//     across all its threads, writes its pooled values to `out` and its sum
//     of squares to `partial`, and takes a ticket on its image's counter;
//     the image's last block adds the partial sums in rank order (the same
//     order every run) and divides the image's row by its L2 norm in place,
//     then resets the counter for the next launch. No second launch.
//   * Bulk route, for an image whose valid extent is the whole map when the
//     wrapper found the tensor 16-byte aligned and a plane a multiple of 16
//     bytes (stage_planes > 0): the block's span streams through a ring of
//     kStages shared-memory stages of `stage_planes` planes each, one
//     cp.async.bulk per stage, completed on an mbarrier. One thread issues
//     the copies; no register or instruction is spent per byte, and the
//     next stage's copy stays in flight while the warps reduce the stage
//     that arrived (16-byte shared loads; a plane per warp, or a plane split
//     across warps when a stage holds fewer planes than the block has
//     warps). On whole extents the ring beats the fastest walk by up to
//     12 % at the ResNet map and 8 % at the 8-image launch (at p = 2.5 in
//     every type) and trails it by up to 3 % at the VGG16 map; four stages
//     were never more than 0.5 % faster than two (kernel_times.py --sweep
//     on an H100, PERF.md §6).
//   * Walk route, for a ragged extent (or an unaligned tensor): one warp per
//     plane, walking the valid rectangle only with row and column counters
//     that step by the warp's width without division; 16-byte loads where
//     the row width and the address allow (else 8, 4, 2 bytes or one cell),
//     a vector straddling the column edge read whole and its outside cells
//     masked. Each warp runs its planes as one stream of rounds and loads
//     the next round (the next plane's, at the end of a plane) before it
//     reduces this one, so a plane's reduction never waits out a trip to
//     device memory alone.
//   * Each route is a device function of its own, not inlined, so each
//     gets its own registers: inlined into one kernel, the float32 kernel
//     got 64 registers (94 with the routes apart) and the VGG16 path's map
//     with 4 ragged images of 16 read 22 % slower (PERF.md §6).
//   * At most one SFU op a cell. p is read once; p = 3 (seeded nets) and
//     p = 1 take a block-uniform branch that multiplies out. Any other p (a
//     trained one) is ex2(p * log2 x) with log2 x split exactly into the
//     float's exponent e and its mantissa m: log2 x = e + log2 m with m
//     centred in [sqrt(1/2), sqrt(2)) and log2 m = f q(f), f = m - 1, q of
//     degree 7 (8 FMAs, coefficients fitted on that interval), and e turned
//     to a float by a magic-number add, not an int->float conversion. (A
//     per-block table of log2(1 + k/128) for bfloat16's 7-bit mantissa, one
//     column per lane, measured no faster: PERF.md §6.)
//     Error bound of the power (against x^p in exact arithmetic): the
//     polynomial's log2 m is within 9.1e-8 of the exact value for every
//     float32 m of the interval, its float32 evaluation included; e + log2 m
//     rounds once (half an ulp of |e| + 1: 6e-8 for x in [0.35, 2.8), 9.5e-7
//     at x = eps = 1e-6); ex2.approx adds 2^-22 relative. So x^p is within
//     p ln2 (9.1e-8 + 6e-8) + 2.4e-7, about 7.3e-7 relative at p = 4.7, for
//     x in [0.35, 2.8), and 3.1e-6 at x = 1e-6, p = 4.7 (such a cell adds
//     1e-28 to a sum of cells mostly near 1). ex2 flushes results below
//     2^-126 to zero: only where p log2(1/x) > 126, e.g. a cell at eps =
//     1e-6 with p > 6.3. The root (acc / count)^(1/p), once per channel, is
//     the accurate powf.
// The TPU kernel carried its sum across a sequential grid in scratch memory;
// blocks here run in no order, and the ticket is what ties an image's blocks
// together. Eval only: the TPU kernel has no gradient either.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStages = 2;  // stages of the bulk route's ring
constexpr int kRowLoads = 8;  // the last block's loads in flight a thread

static __device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// ---- the power ------------------------------------------------------------

// 2^a in one SFU op
static __device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// the integer e (|e| < 2^22) as a float, by one add on the FMA pipe
static __device__ __forceinline__ float int_as_exact_float(int e) {
  return __int_as_float(0x4b400000 + e) - 12582912.0f;  // 1.5 * 2^23
}

// log2 x for a normal positive float: its exponent, read from the bits with
// the mantissa centred in [sqrt(1/2), sqrt(2)), plus log2 m = f q(f)
static __device__ __forceinline__ float log2_split(float x) {
  const int bits = __float_as_int(x);
  const int e = (bits - 0x3f3504f3) >> 23;  // 0x3f3504f3: sqrt(1/2)
  const float f = __int_as_float(bits - e * (1 << 23)) - 1.0f;  // exact
  float q = -0.14574334f;
  q = fmaf(q, f, 0.23688994f);
  q = fmaf(q, f, -0.25006923f);
  q = fmaf(q, f, 0.28670752f);
  q = fmaf(q, f, -0.36008722f);
  q = fmaf(q, f, 0.48093945f);
  q = fmaf(q, f, -0.72135717f);
  q = fmaf(q, f, 1.44269478f);
  return int_as_exact_float(e) + q * f;
}

// What the power of a cell needs, read once per block.
struct Power {
  float p, eps;
};

// max(x, eps)^p; kPow is p itself (1 or 3), or 0 for any other p
template <int kPow>
static __device__ __forceinline__ float pow_cell(float x, const Power& pw) {
  x = fmaxf(x, pw.eps);
  if constexpr (kPow == 1) {
    return x;
  } else if constexpr (kPow == 3) {
    return x * x * x;
  } else {
    return ex2(pw.p * log2_split(x));
  }
}

// ---- cells ----------------------------------------------------------------

// cell k of a 32-bit word of T cells (the lower address in the low half),
// widened exactly to float32
template <typename T>
static __device__ __forceinline__ float cell_of(unsigned int w, int k) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((k & 1) ? (w >> 16) : (w & 0xffffu))));
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
      return cell_of<T>(static_cast<unsigned int>(word), 0);
    } else {
      constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
      const unsigned int* u = reinterpret_cast<const unsigned int*>(&word);
      return cell_of<T>(u[k / kPerWord], k % kPerWord);
    }
  }
};

// the sum of max(x, eps)^p over the cells of 16 bytes, as a tree
template <typename T, int kPow>
static __device__ __forceinline__ float sum16(const uint4& word,
                                              const Power& pw) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  const unsigned int u[4] = {word.x, word.y, word.z, word.w};
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = pow_cell<kPow>(cell_of<T>(u[i], 0), pw);
    if constexpr (kPerWord == 2) {
      s[i] += pow_cell<kPow>(cell_of<T>(u[i], 1), pw);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// ---- the bulk route -------------------------------------------------------

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void wait_parity(uint32_t bar,
                                                   uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one thread: copy `bytes` from src into the stage at dst, completing on bar
static __device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                                 uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The raw sums of this block's `planes` planes (contiguous from `first`, each
// of `plane` cells, plane * sizeof(T) a multiple of 16) into sums[], through
// a ring of kStages stages of `sp` planes.
template <typename T, int kPow>
static __device__ __noinline__ void bulk_group(
    const T* __restrict__ first, unsigned char* ring, unsigned long long* full,
    float (*parts)[kMaxWarps], float* sums, int planes, int plane, int sp,
    const Power pw) {
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nvec = plane / kPerVec;
  const uint32_t stage_bytes =
      static_cast<uint32_t>(sp) * plane * static_cast<uint32_t>(sizeof(T));
  const int nstage = (planes + sp - 1) / sp;
  const int split = sp < warps ? warps / sp : 1;  // warps a plane
  const int tasks = sp * split;
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t bar0 = smem_addr(full);

  auto issue = [&](int k) {
    const int here = min(sp, planes - k * sp);
    const int slot = k % kStages;
    bulk_load(ring0 + slot * stage_bytes,
              first + static_cast<long long>(k) * sp * plane,
              static_cast<uint32_t>(here) * plane *
                  static_cast<uint32_t>(sizeof(T)),
              bar0 + 8 * slot);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < min(kStages, nstage); ++k) {
      issue(k);
    }
  }
  for (int k = 0; k < nstage; ++k) {
    const int slot = k % kStages;
    wait_parity(bar0 + 8 * slot, static_cast<uint32_t>((k / kStages) & 1));
    const uint4* buf =
        reinterpret_cast<const uint4*>(ring + slot * stage_bytes);
    const int here = min(sp, planes - k * sp);
    for (int t = warp; t < tasks; t += warps) {
      const int j = t / split;
      if (j >= here) {
        break;
      }
      const uint4* vecs = buf + j * nvec;
      float acc = 0.0f;
#pragma unroll 4
      for (int i = (t - j * split) * 32 + lane; i < nvec; i += 32 * split) {
        acc += sum16<T, kPow>(vecs[i], pw);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        if (split == 1) {
          sums[k * sp + j] = acc;
        } else {
          parts[k & 1][t] = acc;
        }
      }
    }
    // every warp is done with this stage's slot (and wrote its parts)
    __syncthreads();
    if (split > 1 && static_cast<int>(threadIdx.x) < here) {
      float s = 0.0f;
      for (int q = 0; q < split; ++q) {
        s += parts[k & 1][threadIdx.x * split + q];
      }
      sums[k * sp + threadIdx.x] = s;
    }
    if (threadIdx.x == 0 && k + kStages < nstage) {
      // the slot's generic reads are ordered before the async proxy's write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + kStages);
    }
  }
}

// ---- the walk route -------------------------------------------------------

template <typename T, int kVec, int kUnroll>
struct Round {
  Cells<T, kVec> cells[kUnroll];
  unsigned int inside;  // bit u * kVec + k: cell k of vector u is valid
};

// The raw sums of this block's `planes` planes of an image with valid extent
// vh x vw into sums[]: warp v pools planes v, v + warps, ...
template <typename T, int kPow, int kVec>
static __device__ __noinline__ void walk_group(const T* __restrict__ first,
                                                  float* sums, int planes,
                                                  int plane, int w, int vh,
                                                  int vw, const Power pw) {
  constexpr int kUnroll = kVec == 1 ? 8 : 4;  // at most 32 cells a round
  constexpr unsigned int kAll = (1u << kVec) - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (warp >= planes) {
    return;
  }
  // a lane's start in the rectangle of vh rows by vcols vectors, and how far
  // it moves per step of 32 vectors
  const int vcols = (vw + kVec - 1) / kVec;
  const int row0 = lane / vcols;
  const int col0 = lane - row0 * vcols;
  const int drow = 32 / vcols;
  const int dcol = 32 - drow * vcols;
  const int rounds = (vh * vcols + 32 * kUnroll - 1) / (32 * kUnroll);
  const int items = (planes - warp + warps - 1) / warps * rounds;
  const long long step = static_cast<long long>(warps) * plane;

  const T* lplane = first + static_cast<long long>(warp) * plane;
  int lround = 0, row = row0, col = col0;
  auto load = [&](Round<T, kVec, kUnroll>& r) {
    r.inside = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row < vh) {
        r.cells[u].load(lplane + row * w + col * kVec);
        const int lim = vw - col * kVec;  // cells of the vector inside
        r.inside |= (lim >= kVec ? kAll : (1u << lim) - 1) << (u * kVec);
      } else {
        r.cells[u].word = {};
      }
      col += dcol;
      row += drow;
      if (col >= vcols) {
        col -= vcols;
        ++row;
      }
    }
    if (++lround == rounds) {  // the next round is the next plane's
      lround = 0;
      lplane += step;
      row = row0;
      col = col0;
    }
  };

  int cj = warp, cround = 0;
  float acc = 0.0f;
  auto consume = [&](const Round<T, kVec, kUnroll>& r) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // every cell's power, the outside ones selected away, summed as a
      // tree: independent chains, no branch per cell
      float s[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float v = pow_cell<kPow>(r.cells[u][k], pw);
        s[k] = ((r.inside >> (u * kVec + k)) & 1u) ? v : 0.0f;
      }
#pragma unroll
      for (int step = 1; step < kVec; step *= 2) {
#pragma unroll
        for (int k = 0; k + step < kVec; k += 2 * step) {
          s[k] += s[k + step];
        }
      }
      acc += s[0];
    }
    if (++cround == rounds) {  // warp-uniform: the plane is done
      const float s = warp_sum(acc);
      if (lane == 0) {
        sums[cj] = s;
      }
      cj += warps;
      cround = 0;
      acc = 0.0f;
    }
  };

  Round<T, kVec, kUnroll> a, b;
  load(a);
  for (int k = 0; k < items; k += 2) {
    if (k + 1 < items) {
      load(b);
    }
    consume(a);
    if (k + 2 < items) {
      load(a);
    }
    if (k + 1 < items) {
      consume(b);
    }
  }
}

// ---- the kernel -----------------------------------------------------------

template <typename T, int kPow, int kVec>
static __device__ __forceinline__ void pool_group(
    bool bulk, const T* __restrict__ first, unsigned char* ring,
    unsigned long long* full, float (*parts)[kMaxWarps], float* sums,
    int planes, int h, int w, int vh, int vw, int sp, const Power& pw) {
  if (bulk) {
    bulk_group<T, kPow>(first, ring, full, parts, sums, planes, h * w, sp,
                        pw);
  } else {
    walk_group<T, kPow, kVec>(first, sums, planes, h * w, w, vh, vw, pw);
  }
}

template <typename T, int kVec>
static __global__ void __launch_bounds__(kMaxThreads)
    gem_l2n_kernel(const T* __restrict__ x,
                   const int* __restrict__ valid_hw,
                   const float* __restrict__ p_ptr, float* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counter,
                   int c, int h, int w, int blocks, int group,
                   int stage_planes, float eps) {
  // [ring: kStages x stage_planes planes][sums: group]
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ alignas(8) unsigned long long full[kStages];
  __shared__ float parts[2][kMaxWarps];
  __shared__ float warp_sq[kMaxWarps];
  __shared__ float denom;
  __shared__ int last;
  const int img = static_cast<int>(blockIdx.x) / blocks;
  const int rank = static_cast<int>(blockIdx.x) - img * blocks;
  const int c0 = rank * group;
  const int c1 = min(c0 + group, c);
  const int vh = min(max(valid_hw[2 * img], 0), h);
  const int vw = min(max(valid_hw[2 * img + 1], 0), w);
  const int plane = h * w;
  const float p = *p_ptr;
  const bool bulk = stage_planes > 0 && vh == h && vw == w;
  const long long ring_bytes =
      stage_planes > 0 ? static_cast<long long>(kStages) * stage_planes *
                             plane * static_cast<long long>(sizeof(T))
                       : 0;
  float* sums = reinterpret_cast<float*>(smem + ring_bytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Power pw = {p, eps};

  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(full + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are ready

  const int planes = c1 - c0;
  const T* first = x + (static_cast<long long>(img) * c + c0) * plane;
  if (vh == 0 || vw == 0) {  // an empty extent pools to 0
    for (int j = threadIdx.x; j < planes; j += blockDim.x) {
      sums[j] = 0.0f;
    }
  } else if (p == 1.0f) {
    pool_group<T, 1, kVec>(bulk, first, smem, full, parts, sums, planes, h,
                           w, vh, vw, stage_planes, pw);
  } else if (p == 3.0f) {
    pool_group<T, 3, kVec>(bulk, first, smem, full, parts, sums, planes, h,
                           w, vh, vw, stage_planes, pw);
  } else {
    pool_group<T, 0, kVec>(bulk, first, smem, full, parts, sums, planes, h,
                           w, vh, vw, stage_planes, pw);
  }
  __syncthreads();  // every raw sum is in sums[]

  // the roots and squares of the block's channels, across all its threads;
  // the pooled values go to out, to be divided by the norm below
  const float count = static_cast<float>(max(vh * vw, 1));
  const float inv_p = 1.0f / p;
  float* row = out + static_cast<long long>(img) * c;
  float sq = 0.0f;
  for (int j = threadIdx.x; j < planes; j += blockDim.x) {
    const float v = powf(sums[j] / count, inv_p);
    row[c0 + j] = v;
    sq += v * v;
  }
  sq = warp_sum(sq);
  if (lane == 0) {
    warp_sq[warp] = sq;
  }
  __syncthreads();
  if (warp == 0) {
    sq = lane < static_cast<int>(blockDim.x >> 5) ? warp_sq[lane] : 0.0f;
    sq = warp_sum(sq);
    if (lane == 0) {
      partial[img * blocks + rank] = sq;
    }
  }
  // this block's pooled values and partial sum are visible to the device
  // before its ticket is
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter + img, 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) {
    return;
  }
  __threadfence();
  if (warp == 0) {
    // the partial sums, read in parallel and added in the same order every
    // run (lane by rank, then the shuffle tree)
    float total = 0.0f;
    for (int r = lane; r < blocks; r += 32) {
      total += __ldcg(partial + img * blocks + r);
    }
    total = warp_sum(total);
    if (lane == 0) {
      denom = sqrtf(total) + eps;
      counter[img] = 0;  // ready for the next launch on the stream
    }
  }
  __syncthreads();
  // the row, kRowLoads values a thread in flight before any is divided
  for (int j0 = threadIdx.x; j0 < c; j0 += kRowLoads * blockDim.x) {
    float v[kRowLoads];
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int j = j0 + u * static_cast<int>(blockDim.x);
      v[u] = j < c ? __ldcg(row + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int j = j0 + u * static_cast<int>(blockDim.x);
      if (j < c) {
        row[j] = v[u] / denom;
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

struct Launch {
  int n, c, h, w, blocks, group, threads, vec, stage_planes;
  float eps;
};

// dynamic shared memory of a launch: the ring and the sums
template <typename T>
static size_t smem_bytes(const Launch& l) {
  const size_t ring = l.stage_planes > 0
                          ? static_cast<size_t>(kStages) * l.stage_planes *
                                l.h * l.w * sizeof(T)
                          : 0;
  return ring + static_cast<size_t>(l.group) * sizeof(float);
}

template <typename T, int kVec>
static int launch(const T* x, const int* valid_hw, const float* p, float* out,
                  float* partial, int* counter, const Launch& l,
                  void* stream) {
  void (*kernel)(const T*, const int*, const float*, float*, float*, int*,
                 int, int, int, int, int, int, float) =
      gem_l2n_kernel<T, kVec>;
  const size_t smem = smem_bytes<T>(l);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  kernel<<<static_cast<unsigned int>(l.n) * l.blocks, l.threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, valid_hw, p, out, partial, counter, l.c, l.h, l.w, l.blocks,
      l.group, l.stage_planes, l.eps);
  return static_cast<int>(cudaGetLastError());
}

// Checks what the kernel relies on and launches it at the walk's load width.
template <typename T>
static int run(const T* x, const int* valid_hw, const float* p, float* out,
               float* partial, int* counter, const Launch& l, void* stream) {
  if (l.n <= 0 || l.c <= 0) {
    return 0;
  }
  const size_t plane_bytes = static_cast<size_t>(l.h) * l.w * sizeof(T);
  if (l.threads > kMaxThreads || l.threads < 32 || l.threads % 32 != 0 ||
      l.blocks < 1 || l.group < 1 ||
      static_cast<long long>(l.blocks) * l.group < l.c ||
      static_cast<long long>(l.blocks - 1) * l.group >= l.c ||
      l.stage_planes < 0 ||
      (l.stage_planes > 0 &&
       (plane_bytes % 16 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (l.vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch<T, 8>(x, valid_hw, p, out, partial, counter, l, stream);
      }
      break;
    case 4:
      return launch<T, 4>(x, valid_hw, p, out, partial, counter, l, stream);
    case 2:
      if constexpr (sizeof(T) == 2) {
        return launch<T, 2>(x, valid_hw, p, out, partial, counter, l, stream);
      }
      break;
    case 1:
      return launch<T, 1>(x, valid_hw, p, out, partial, counter, l, stream);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (n, c, h, w) contiguous f32 (gem_l2n_f32), bf16 (gem_l2n_bf16) or f16
// (gem_l2n_f16); valid_hw: (n, 2) int32; p: one f32; out: (n, c) f32;
// partial: n * blocks f32 of scratch; counter: n int32, zero, and left zero.
// One launch of n * blocks blocks of `threads` threads; block r of an image
// pools channels [r*group, min((r+1)*group, c)), none empty. vec is the
// cells a walk load reads: 4 or 1 for f32, 8, 4, 2 or 1 for 16-bit cells
// (w % vec == 0 and x aligned to vec cells' bytes). stage_planes > 0 (x
// 16-byte aligned, a plane a multiple of 16 bytes) lets whole-extent images
// take the bulk route through kStages stages of that many planes; 0 walks
// every image. Launches on one stream share a counter safely; launches that
// may overlap need counters of their own. The geometry comes from the
// wrapper (ops/pooling_kernel.py::launch_geometry). Returns the launch's
// CUDA error (0 when it was accepted).
#define GEM_L2N_ENTRY(name, T)                                               \
  extern "C" int name(const T* x, const int* valid_hw, const float* p,      \
                      float* out, float* partial, int* counter, int n, int c, \
                      int h, int w, int blocks, int group, int threads,      \
                      int vec, int stage_planes, float eps, void* stream) {  \
    const Launch l = {n,       c,   h,            w,  blocks, group,         \
                      threads, vec, stage_planes, eps};                      \
    return run<T>(x, valid_hw, p, out, partial, counter, l, stream);         \
  }

GEM_L2N_ENTRY(gem_l2n_f32, float)
GEM_L2N_ENTRY(gem_l2n_bf16, __nv_bfloat16)
GEM_L2N_ENTRY(gem_l2n_f16, __half)
