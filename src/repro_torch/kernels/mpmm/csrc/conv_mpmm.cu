// K2: NHWC convolution as implicit GEMM over packed k-bit digit planes, on
// int8 tensor cores, for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mpmm/conv_kernel.py::conv_mpmm_pallas (body _conv_kernel):
//
//   out[b, oh, ow, n] = epilogue(gamma * (sum over (ki, kj, c) of
//     xp[b, oh*s + ki, ow*s + kj, c] * W_int[(ki*kw + kj)*C + c, n]
//     + act_zero * colsum[n]))
//
// with xp the int8 input padded with -act_zero (the code of a float zero)
// and W_int decoded from the same uint8 planes (P, kh*kw*C/f, N) the
// im2col path reads: K2's weight matrix is the im2col weight matrix, so K1's
// route A (mpmm_wgmma.cu) decode carries over unchanged.
//
// What bounds it on this card: the H100 balances at about 590 int8
// operations per byte (1979 TOP/s over 3.35 TB/s).  ResNet-18's early,
// wide feature maps do fewer operations per byte than that, the late ones
// (7x7x512, 4608-deep contraction) more; chip_smoke.py computes the bound
// of each shape it runs.  At serving batches either bound is a few
// microseconds, so what a kernel of this size has to beat is latency: too
// few output tiles to occupy 132 SMs, and each K-step's load latency.
//
// What the design does about it:
// - Products: wgmma m64nBNk32 s32.s8.s8 (BN = 128, or 64 where N <= 64 so
//   that no product is half padding), A and the decoded B both K-major in
//   128-byte-swizzled shared memory behind descriptors.  A block owns a
//   128 x BN output tile, one 64-row product a warpgroup, and steps K by
//   BK = 128 digits.  Sum-Together costs one product a K-step whatever P is
//   (the decode ORs the planes into the int8 code); Sum-Apart runs one
//   product a plane and shift-adds it.  The decode, the products and the
//   epilogue are mpmm_bits.cuh's tc:: pieces, shared with route A.
// - Gathered A tile, asynchronous: a tile row is one output pixel (b, oh,
//   ow), whose image base and top-left input corner the block computes
//   once (`rows`).  Each 16-byte chunk of a K-step is 16 channels of one
//   tap (ki, kj) -- C % 16 == 0, so no chunk straddles a tap -- and goes in
//   one 16-byte cp.async from the unpadded input.  Where C % 16 != 0 or the
//   input is not 16-byte aligned, byte loads (the wrapper takes every C
//   with C % (8/k) == 0).
// - Padding in the kernel: a chunk outside the image is stored as the fill
//   byte (int8)(-act_zero), not zero-filled (a zero would add act_zero * w
//   that the colsum correction does not remove).  Top/left pads are
//   arguments; bottom/right are the bounds check (XLA's SAME pads are
//   (0, 1) at stride 2 on an even size).  No padded copy of the input.
// - A four-stage cp.async ring carries the A chunks and the packed bytes
//   of every plane; under Sum-Together step t+1's planes are decoded into
//   the second B tile while step t's products run.
// - Grid (M tiles, N tiles, splits): where the output tiles alone cannot
//   occupy the card, kernels/mpmm/conv_kernel.py::conv_plan splits the
//   contraction into runs of whole K-steps (a cost model measured on the
//   card picks the run length).  Each split stages its int32 partial tile
//   in shared memory and stores it in coalesced 16-byte chunks; the last
//   block to arrive at an output tile (a per-tile counter in a small
//   persistent buffer, which it resets to zero) adds the other splits'
//   partials to its own and runs the epilogue, so a conv stays one launch.
//   Integer sums are exact in any order.
// - Epilogue: on the int32 accumulators in registers, epilogue_value op for
//   op (the order and rounding of kernels/mpmm/epilogue.py), each column's
//   operands loaded once, two columns stored together.
#include "mpmm_bits.cuh"

namespace {

using mpmm::Epilogue;
using namespace k1;

constexpr int BM = 128;  // output pixels a block, 64 a warpgroup
constexpr int BK = tc::BK;
constexpr int THREADS = tc::THREADS;
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;  // 16 KB

// A stage holds the A tile and the P * BK/f = 16 P k packed rows of BN
// bytes (P k = w, or k where k > w); two B tiles of BN rows of BK digits
// follow the ring.  Every piece is a multiple of 1024 bytes, as the
// 128-byte swizzle needs.
__host__ __device__ constexpr int stage_bytes(int plane_bits, int bn) {
  return A_BYTES + 16 * plane_bits * bn;
}
__host__ __device__ constexpr int smem_bytes(int plane_bits, int bn) {
  return STAGES * stage_bytes(plane_bits, bn) + 2 * bn * BK;
}

// After the products the ring is free: a split block stages its int32
// tile there, BM rows of BN + TPAD ints (the padding spreads the rows'
// 8-byte accumulator pairs over the banks), and the epilogue's column
// operands follow it.
constexpr int TPAD = 8;
template <int BN>
constexpr int TILE_SMEM = BM * (BN + TPAD) * 4;

// Accumulator register 4j + 2i + c of a thread <-> tile row (wgi 64 + 16
// (warp % 4) + lane/4 + 8i), column 8j + 2 (lane % 4) + c: store (to
// shared memory) or load.
template <int BN>
__device__ __forceinline__ void acc_tile(int (&acc)[BN / 2], int* tsm,
                                         bool store) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                 (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      auto* p = reinterpret_cast<int2*>(tsm + (r0 + 8 * i) * (BN + TPAD) +
                                        c0 + 8 * j);
      if (store) {
        *p = make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      } else {
        const int2 v = *p;
        acc[4 * j + 2 * i] = v.x;
        acc[4 * j + 2 * i + 1] = v.y;
      }
    }
  }
}

struct Conv {
  int h, w, c;           // input (B, h, w, c), unpadded
  int ho, wo, n;         // output (B, ho, wo, n)
  int kw, stride, pad_t, pad_l;
  int m, kd, kp;         // M = B*ho*wo, K = kh*kw*c, packed rows of K
  int steps, splits;     // K-steps a split, splits (grid z)
  int vec_a, vec_b;      // 16-byte loads of the input, of the planes
  uint32_t fill;         // (int8)(-act_zero) in each byte
};

// Where this thread's 16-byte chunk of the next K-step starts: digit kk of
// the patch, tap (ki, kj), channel cc.  Divided once per block, then
// advanced by one K-step each load (the vector path's chunk is fixed per
// thread).
struct Tap {
  int kk, ki, kj, cc;
};

__device__ __forceinline__ Tap first_tap(const Conv& g, int t) {
  Tap p{t * BK + 16 * static_cast<int>(threadIdx.x & 7), 0, 0, 0};
  const int tap = p.kk / g.c;
  p.cc = p.kk - tap * g.c;
  p.ki = tap / g.kw;
  p.kj = tap - p.ki * g.kw;
  return p;
}

// A tile of K-step t: row r is output pixel m0 + r, byte k is digit
// t*BK + k = (tap (ki, kj), channel cc) of its patch, stored swizzled.
// rows[r] = (image base b*h*w or -1 past M, oh*s - pad_t, ow*s - pad_l).
__device__ __forceinline__ void load_a(unsigned char* at,
                                       const int8_t* __restrict__ x,
                                       const Conv& g, const int3* rows,
                                       int t, Tap& p) {
  if (g.vec_a) {
    const int c = threadIdx.x & 7;  // this thread's chunk of every row
    const bool in_k = p.kk < g.kd;
#pragma unroll
    for (int j = 0; j < BM * 8 / THREADS; ++j) {
      const int r = (threadIdx.x >> 3) + j * (THREADS / 8);
      unsigned char* dst = at + r * 128 + (((c ^ r) & 7) << 4);
      const int3 row = rows[r];
      const int ih = row.y + p.ki, iw = row.z + p.kj;
      if (!in_k || row.x < 0) {
        cp_async16(dst, x, false);  // past K or M: zeros
      } else if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
        cp_async16(
            dst, x + static_cast<size_t>(row.x + ih * g.w + iw) * g.c + p.cc,
            true);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(g.fill, g.fill, g.fill, g.fill);
      }
    }
    p.kk += BK;
    p.cc += BK;
    while (p.cc >= g.c) {
      p.cc -= g.c;
      if (++p.kj == g.kw) {
        p.kj = 0;
        ++p.ki;
      }
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const int kk = t * BK + k;
      const int3 row = rows[r];
      int8_t v = 0;
      if (kk < g.kd && row.x >= 0) {
        const int tap = kk / g.c;
        const int cc = kk - tap * g.c;
        const int ki = tap / g.kw;
        const int ih = row.y + ki, iw = row.z + tap - ki * g.kw;
        v = (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
                ? x[static_cast<size_t>(row.x + ih * g.w + iw) * g.c + cc]
                : static_cast<int8_t>(g.fill);
      }
      at[wg::swz(r, k)] = static_cast<unsigned char>(v);
    }
  }
}

// The packed rows of K-step t of every plane (BN columns from n0), as
// route A stages them; past K or N zero-filled.
template <int W, int K, int BN>
__device__ __forceinline__ void load_b(unsigned char* raw,
                                       const uint8_t* __restrict__ planes,
                                       const Conv& g, int n0, int t) {
  using Fm = Format<W, K>;
  constexpr int RR = BK / Fm::F;
  constexpr int CG = BN / 16;
  const int kb0 = t * RR;
  if (g.vec_b) {
#pragma unroll
    for (int i = threadIdx.x; i < Fm::P * RR * CG; i += THREADS) {
      const int c = i % CG, row = i / CG;
      const int p = row / RR, kb = row % RR;
      const int gb = kb0 + kb, gn = n0 + 16 * c;
      const bool ok = gb < g.kp && gn < g.n;
      cp_async16(raw + tc::raw_off<K, BN>(row, kb, c),
                 ok ? planes + (static_cast<size_t>(p) * g.kp + gb) * g.n + gn
                    : planes,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < Fm::P * RR * BN; i += THREADS) {
      const int n = i % BN, row = i / BN;
      const int p = row / RR, kb = row % RR;
      const int gb = kb0 + kb, gn = n0 + n;
      raw[tc::raw_off<K, BN>(row, kb, n >> 4) + (n & 15)] =
          (gb < g.kp && gn < g.n)
              ? planes[(static_cast<size_t>(p) * g.kp + gb) * g.n + gn]
              : 0;
    }
  }
}

template <int W, int K, bool SA, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_mpmm_kernel(const int8_t* __restrict__ x,
                     const uint8_t* __restrict__ planes, Conv g, Epilogue e,
                     int* __restrict__ ws, int* __restrict__ counters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int3 rows[BM];
  __shared__ int last;
  using Fm = Format<W, K>;
  constexpr int STAGE = stage_bytes(Fm::P * K, BN);
  constexpr int B_BYTES = BN * BK;
  constexpr int NA = BN / 2;  // accumulator registers a thread
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * g.steps;
  const int nt = min(g.steps, (g.kd + BK - 1) / BK - t0);
  const int wgi = threadIdx.x >> 7;

  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int gm = m0 + r;
    int3 row = make_int3(-1, 0, 0);
    if (gm < g.m) {
      const int img = gm / (g.ho * g.wo);
      const int rem = gm - img * (g.ho * g.wo);
      const int oh = rem / g.wo;
      const int ow = rem - oh * g.wo;
      row = make_int3(img * g.h * g.w, oh * g.stride - g.pad_t,
                      ow * g.stride - g.pad_l);
    }
    rows[r] = row;
  }
  __syncthreads();

  unsigned char* btile = smem + STAGES * STAGE;
  auto slot = [&](int u) { return smem + (u % STAGES) * STAGE; };
  Tap tap = first_tap(g, t0);
  auto load = [&](int u) {
    if (u < nt) {
      load_a(slot(u), x, g, rows, t0 + u, tap);
      load_b<W, K, BN>(slot(u) + A_BYTES, planes, g, n0, t0 + u);
    }
    cp_commit();
  };

  int acc[1][NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[0][i] = 0;

#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) load(u);

  if constexpr (!SA) {
    cp_wait<STAGES - 2>();
    wg::fence_proxy();
    __syncthreads();
    tc::decode_stage<W, K, false, BN>(slot(0) + A_BYTES, btile, 0);
    wg::fence_proxy();
    __syncthreads();
    for (int u = 0; u < nt; ++u) {
      tc::mma_step<1, BN>(acc, slot(u), btile + (u & 1) * B_BYTES, wgi,
                          false);
      load(u + STAGES - 1);
      if (u + 1 < nt) {
        cp_wait<STAGES - 2>();
        wg::fence_proxy();
        __syncthreads();
        tc::decode_stage<W, K, false, BN>(
            slot(u + 1) + A_BYTES, btile + ((u + 1) & 1) * B_BYTES, 0);
        wg::fence_proxy();
      }
      wg::wait0();
      wg::pin(acc[0]);
      __syncthreads();
    }
  } else {
    int tmp[1][NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) tmp[0][i] = 0;
    for (int u = 0; u < nt; ++u) {
      load(u + STAGES - 1);
      cp_wait<STAGES - 1>();
      wg::fence_proxy();
      __syncthreads();
#pragma unroll
      for (int p = 0; p < Fm::P; ++p) {
        tc::decode_stage<W, K, true, BN>(slot(u) + A_BYTES, btile, p);
        wg::fence_proxy();
        __syncthreads();
        tc::mma_step<1, BN>(tmp, slot(u), btile, wgi, true);
        wg::wait0();
        wg::pin(tmp[0]);
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[0][i] += tmp[0][i] * (1 << (K * p));
        __syncthreads();
      }
    }
  }
  cp_wait<0>();

  unsigned char* scratch = smem + TILE_SMEM<BN>;  // the epilogue's columns
  if (g.splits > 1) {
    // Split: stage the partial in shared memory (tile T, rows TS ints
    // apart), store it to the workspace in 16-byte chunks, tile-major
    // (split, tile, BM, BN), and count the arrival; the last block of the
    // tile adds the other splits' partials to its own, chunk by chunk.
    constexpr int TS = BN + TPAD;
    constexpr int CPR = BN / 4;            // 16-byte chunks a row
    constexpr int CH = BM * CPR / THREADS;  // chunks a thread
    int* tsm = reinterpret_cast<int*>(smem);
    const int tile = blockIdx.x + blockIdx.y * gridDim.x;
    const size_t tile_ints = static_cast<size_t>(BM) * BN;
    const size_t split_ints = tile_ints * gridDim.x * gridDim.y;
    const int rows = min(BM, g.m - m0);
    __syncthreads();  // every thread is past its last product
    acc_tile<BN>(acc[0], tsm, true);
    __syncthreads();
    int4* mine = reinterpret_cast<int4*>(ws + blockIdx.z * split_ints +
                                         tile * tile_ints);
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int l = threadIdx.x + q * THREADS;
      const int r = l / CPR;
      if (r < rows) {
        __stcg(mine + l,
               *reinterpret_cast<const int4*>(tsm + r * TS + 4 * (l % CPR)));
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counters + tile, 1) == g.splits - 1;
      if (last) counters[tile] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    int4 sum[CH];
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int l = threadIdx.x + q * THREADS;
      sum[q] = *reinterpret_cast<const int4*>(tsm + (l / CPR) * TS +
                                              4 * (l % CPR));
    }
    // Every load of a split issued before any is used; rows past M were
    // never stored and are never used.
    for (int k = 0; k + 1 < g.splits; ++k) {
      const int s = k + (k >= static_cast<int>(blockIdx.z));
      const int4* part = reinterpret_cast<const int4*>(
          ws + s * split_ints + tile * tile_ints);
      int4 v[CH];
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        v[q] = __ldcg(part + threadIdx.x + q * THREADS);
      }
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        sum[q].x += v[q].x;
        sum[q].y += v[q].y;
        sum[q].z += v[q].z;
        sum[q].w += v[q].w;
      }
    }
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int l = threadIdx.x + q * THREADS;
      *reinterpret_cast<int4*>(tsm + (l / CPR) * TS + 4 * (l % CPR)) = sum[q];
    }
    __syncthreads();
    acc_tile<BN>(acc[0], tsm, false);
  }
  tc::store_tile<1, BN>(e, acc, m0, n0, g.m, g.n, scratch);
}

using KernelFn = void (*)(const int8_t*, const uint8_t*, Conv, Epilogue, int*,
                          int*);

template <int W, int K>
KernelFn pick(int sa, int bn) {
  if (sa) {
    return bn == 128 ? conv_mpmm_kernel<W, K, true, 128>
                     : conv_mpmm_kernel<W, K, true, 64>;
  }
  return bn == 128 ? conv_mpmm_kernel<W, K, false, 128>
                   : conv_mpmm_kernel<W, K, false, 64>;
}

// The instantiation for a format, variant and N tile; null if none.
KernelFn kernel_for(int w_bits, int k_bits, int sa, int bn) {
  if (bn != 128 && bn != 64) return nullptr;
#define K2_PICK(W, K) pick<W, K>(sa, bn)
  switch (w_bits * 16 + k_bits) {
    K1_FORMATS(K1_FORMAT_CASE, K2_PICK)
    default: return nullptr;
  }
#undef K2_PICK
}

}  // namespace

// Plain C entry points, loaded with ctypes (kernels/mpmm/conv_kernel.py).
//
// conv_mpmm_launch launches K2 on `stream` and returns cudaGetLastError()
// of the launch (0 on success).  x is the unpadded int8 input (B, H, W, C);
// the grid is (ceil(M/128), ceil(N/bn), splits) with `steps` K-steps a
// split.  With splits > 1, ws holds the int32 partials, tile-major
// (splits, tiles, 128, bn), and counters one zeroed int per output tile
// (the kernel leaves them zero).
extern "C" int conv_mpmm_launch(
    const void* x, const void* planes, const void* gamma, const void* colsum,
    const void* scale, const void* shift, const void* residual, void* out,
    void* ws, void* counters, int B, int H, int W, int C, int Ho, int Wo,
    int N, int kh, int kw, int stride, int pad_top, int pad_left, int kp,
    int n_planes, int k_bits, int w_bits, int act_zero, int sa, int flags,
    int bn, int steps, int splits, void* stream) {
  const Epilogue e{static_cast<const float*>(gamma),
                   static_cast<const int*>(colsum),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(shift),
                   residual, out, act_zero, flags};
  const KernelFn kernel = kernel_for(w_bits, k_bits, sa, bn);
  const int kd = kh * kw * C;
  const int nk = (kd + BK - 1) / BK;
  if (kernel == nullptr || n_planes != planes_of(w_bits, k_bits) ||
      steps < 1 || splits < 1 || (splits - 1) * steps >= nk ||
      splits * steps < nk ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t fill =
      0x01010101u * (static_cast<uint32_t>(-act_zero) & 0xFFu);
  const Conv g{H, W, C, Ho, Wo, N, kw, stride, pad_top, pad_left,
               B * Ho * Wo, kd, kp, steps, splits,
               C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
               N % 16 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0,
               fill};
  const dim3 grid((g.m + BM - 1) / BM, (N + bn - 1) / bn, splits);
  return launch(kernel, smem_bytes(n_planes * k_bits, bn), grid, THREADS,
                static_cast<cudaStream_t>(stream),
                static_cast<const int8_t*>(x),
                static_cast<const uint8_t*>(planes), g, e,
                static_cast<int*>(ws), static_cast<int*>(counters));
}

// Dynamic shared memory and resident blocks an SM of one instantiation:
// info[0] = bytes, info[1] = blocks.  Returns a CUDA error code.
extern "C" int conv_mpmm_info(int w_bits, int k_bits, int sa, int bn,
                              int* info) {
  const KernelFn kernel = kernel_for(w_bits, k_bits, sa, bn);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(planes_of(w_bits, k_bits) * k_bits, bn);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(info + 1, kernel,
                                                        THREADS, smem);
  }
  info[0] = smem;
  return static_cast<int>(err);
}
