// Pieces of the mixed-precision kernels: K2's (conv_mpmm.cu) fixed tile,
// in-shared-memory decode of packed k-bit digit planes and int8 dot-product
// inner loop, and the fused f32 epilogue that K2 and both routes of K1
// (mpmm_wgmma.cu, mpmm_splitk.cu) share.
//
// Storage format (repro_torch/core/packing.py): a w-bit signed weight code
// is split into P = ceil(w/k) k-bit digit planes, lower planes unsigned, the
// top plane a (w - k*(P-1))-bit two's-complement field.  Planes are stored
// uint8 (P, ceil(K/f), N) with f = 8/k digits per byte along K, field index
// minor within a byte: digit (p, kk, n) sits at bits [k*(kk%f), k*(kk%f)+k)
// of byte (p, kk/f, n).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mpmm {

// One block computes a BM x BN output tile, stepping over K in BK digits.
// 256 threads as 16 x 16, each owning a 4 x 4 micro-tile (rows ty + 16 i,
// columns tx + 16 j), so stores along N are coalesced.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int KW = BK / 4 + 1;  // words per shared row; +1 word of padding
                                // keeps the column reads conflict-free

// Epilogue flags (kernels/mpmm/kernel.py builds the same bits).
enum : int {
  EPI_BN = 1,
  EPI_RESIDUAL = 2,
  EPI_RELU = 4,
  RES_BF16 = 8,
  OUT_BF16 = 16,
};

struct Epilogue {
  const float* gamma;     // (N,) gamma_a * gamma_w
  const int* colsum;      // (N,) column sums of the integer weight codes
  const float* scale;     // (N,) folded BN scale, when EPI_BN
  const float* shift;     // (N,) folded BN shift, when EPI_BN
  const void* residual;   // (M, N) f32 or bf16, when EPI_RESIDUAL
  void* out;              // (M, N) f32 or bf16
  int act_zero;
  int flags;
};

// Decode one K-step of packed bytes into int8 digits, ws[p][n][k] with k
// contiguous (4 digits per word).  Bytes [kb0, kb0 + BK/f) of each plane
// are read; bytes at or past kb_end, and columns at or past n_total, decode
// to zero.
template <int P>
__device__ __forceinline__ void decode_tile(int (*ws)[BN][KW],
                                            const uint8_t* __restrict__ planes,
                                            int kp, int n_total, int kb0,
                                            int kb_end, int n0, int k_bits,
                                            int top_bits) {
  const int f = 8 / k_bits;
  const int nbytes = BK / f;
  const int mask = (1 << k_bits) - 1;
  const int top_mask = (1 << top_bits) - 1;
  const int sign = 1 << (top_bits - 1);
  int8_t* ws8 = reinterpret_cast<int8_t*>(ws);
  for (int idx = threadIdx.x; idx < P * nbytes * BN; idx += THREADS) {
    const int n = idx % BN;
    const int r = idx / BN;
    const int kb = r % nbytes;
    const int p = r / nbytes;
    const int gb = kb0 + kb;
    const int gn = n0 + n;
    unsigned byte = 0;
    if (gb < kb_end && gn < n_total) {
      byte = planes[(static_cast<size_t>(p) * kp + gb) * n_total + gn];
    }
    int8_t* dst = ws8 + (p * BN + n) * KW * 4 + kb * f;
    for (int i = 0; i < f; ++i) {
      int d = (byte >> (k_bits * i)) & mask;
      if (p == P - 1) {  // top plane: sign-extend its two's-complement field
        d &= top_mask;
        if (d >= sign) d -= 1 << top_bits;
      }
      dst[i] = static_cast<int8_t>(d);
    }
  }
}

// acc += a_tile @ digits for one K-step.  Sum-Together (SA = false) shifts
// each plane's partial by 2^{k p} into one accumulator; Sum-Apart keeps one
// accumulator per plane and combines them in the epilogue.
template <int P, bool SA>
__device__ __forceinline__ void dot_tile(int (*as)[KW], int (*ws)[BN][KW],
                                         int (&acc)[SA ? P : 1][4][4], int ty,
                                         int tx, int k_bits) {
#pragma unroll
  for (int kk = 0; kk < BK / 4; ++kk) {
    int av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][kk];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[p][tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (SA) {
            acc[SA ? p : 0][i][j] = __dp4a(av[i], wv[j], acc[SA ? p : 0][i][j]);
          } else if (P == 1) {
            acc[0][i][j] = __dp4a(av[i], wv[j], acc[0][i][j]);
          } else {
            acc[0][i][j] += __dp4a(av[i], wv[j], 0) * (1 << (k_bits * p));
          }
        }
      }
    }
  }
}

// The deferred Sum-Apart shift-add (identity for Sum-Together).
template <int P, bool SA>
__device__ __forceinline__ int combine(const int (&acc)[SA ? P : 1][4][4],
                                       int i, int j, int k_bits) {
  if (!SA) return acc[0][i][j];
  int total = 0;
#pragma unroll
  for (int p = 0; p < (SA ? P : 1); ++p) total += acc[p][i][j] * (1 << (k_bits * p));
  return total;
}

// zero-point correction -> dequant -> BN -> residual -> ReLU -> cast, in the
// op order of kernels/mpmm/epilogue.py.  Each step rounds once: __fmul_rn
// and __fadd_rn are never contracted, and BN is one fused multiply-add,
// as XLA contracts y * scale + shift.
__device__ __forceinline__ void epilogue_store(const Epilogue& e, int acc,
                                               int n, size_t idx) {
  const int corrected = acc + e.act_zero * e.colsum[n];
  float y = __fmul_rn(__int2float_rn(corrected), e.gamma[n]);
  if (e.flags & EPI_BN) y = __fmaf_rn(y, e.scale[n], e.shift[n]);
  if (e.flags & EPI_RESIDUAL) {
    const float r =
        (e.flags & RES_BF16)
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.residual)[idx])
            : static_cast<const float*>(e.residual)[idx];
    y = __fadd_rn(y, r);
  }
  if (e.flags & EPI_RELU) y = fmaxf(y, 0.0f);
  if (e.flags & OUT_BF16) {
    static_cast<__nv_bfloat16*>(e.out)[idx] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(e.out)[idx] = y;
  }
}

// Write a block's BM x BN tile through the epilogue; rows are the flattened
// output pixels (conv) or matrix rows (matmul), both (M, N) row-major.
template <int P, bool SA>
__device__ __forceinline__ void store_tile(const Epilogue& e,
                                           const int (&acc)[SA ? P : 1][4][4],
                                           int m0, int n0, int M, int N,
                                           int ty, int tx, int k_bits) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      epilogue_store(e, combine<P, SA>(acc, i, j, k_bits), n,
                     static_cast<size_t>(m) * N + n);
    }
  }
}

}  // namespace mpmm

// Instantiate KERNEL<P, SA> for the plane counts a format can have
// (P = ceil(w/k) with w, k in {1, 2, 4, 8}) and launch it; an unsupported
// plane count returns cudaErrorInvalidValue without launching.
#define MPMM_DISPATCH(KERNEL, planes, sa, grid, stream, ...)                  \
  switch ((planes) * 2 + ((sa) ? 1 : 0)) {                                    \
    case 2: KERNEL<1, false><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 3: KERNEL<1, true><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break;  \
    case 4: KERNEL<2, false><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 5: KERNEL<2, true><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break;  \
    case 8: KERNEL<4, false><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 9: KERNEL<4, true><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break;  \
    case 16: KERNEL<8, false><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break; \
    case 17: KERNEL<8, true><<<grid, mpmm::THREADS, 0, stream>>>(__VA_ARGS__); break;  \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }
