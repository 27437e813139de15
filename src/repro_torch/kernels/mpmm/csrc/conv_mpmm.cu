// K2: NHWC convolution as implicit GEMM over packed k-bit digit planes,
// for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mpmm/conv_kernel.py::conv_mpmm_pallas (body _conv_kernel):
// out[b, oh, ow, n] = epilogue(gamma * (sum over (ki, kj, c) of
//   x[b, oh*s + ki, ow*s + kj, c] * W_int[(ki*kw + kj)*C + c, n]
//   + act_zero * colsum[n]))
// with x the int8 input pre-padded with -act_zero, and W_int decoded from the
// same uint8 planes (P, kh*kw*C/f, N) the im2col path reads: no repack.
//
// What bounds it on this card: the H100 balances at about 590 int8
// operations per byte of device memory (1979 TOP/s over 3.35 TB/s).  At
// serving batch sizes ResNet-18's early, wide feature maps (56x56x64) do
// fewer operations per byte than that and are bound by memory traffic; the
// late ones (7x7x512, 4.6k-deep contraction) do more and are bound by int8
// operations.  chip_smoke.py computes the bound of each shape it runs.  The
// memory bound is only reachable by reading the feature map once instead
// of the kh*kw/stride^2 times larger patch matrix that im2col materializes.
//
// What the design does about it: the patch matrix never exists in device
// memory.  M is tiled over the flattened (b, oh, ow) output pixels, not one
// output row per program as on the TPU (at Wo = 7 a row is far too thin);
// for each kernel tap (ki, kj) and each 32-channel slice, the block gathers
// the (BM, 32) strip of the padded input with stride into shared memory and
// decodes the matching C-slice of the packed planes next to it, then runs
// the same dot-product loop and fused epilogue as K1.  C must be a multiple
// of 8/k so every tap's slice starts on a byte of the packed K axis; the
// wrapper raises otherwise and callers route such layers to im2col.  The
// dot products are __dp4a on CUDA cores; tensor cores, TMA gathers and
// software pipelining are later work.
#include "mpmm_common.cuh"

namespace {

using namespace mpmm;

template <int P, bool SA>
__global__ void __launch_bounds__(THREADS)
    conv_mpmm_kernel(const int8_t* __restrict__ x,
                     const uint8_t* __restrict__ planes, int B, int Hp, int Wp,
                     int C, int Ho, int Wo, int N, int kh, int kw, int stride,
                     int kp, int k_bits, int top_bits, Epilogue e) {
  __shared__ int a_s[BM][KW];
  __shared__ int w_s[P][BN][KW];
  __shared__ long long row_base[BM];  // input offset of (b, oh*s, ow*s, 0)
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int M = B * Ho * Wo;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int f = 8 / k_bits;
  int8_t* a8 = reinterpret_cast<int8_t*>(a_s);
  int acc[SA ? P : 1][4][4] = {};

  for (int r = tid; r < BM; r += THREADS) {
    const int gm = m0 + r;
    long long base = -1;
    if (gm < M) {
      const int b = gm / (Ho * Wo);
      const int rem = gm % (Ho * Wo);
      const int oh = rem / Wo;
      const int ow = rem % Wo;
      base = ((static_cast<long long>(b) * Hp + oh * stride) * Wp +
              ow * stride) * C;
    }
    row_base[r] = base;
  }
  __syncthreads();

  for (int t = 0; t < kh * kw; ++t) {
    const long long tap = (static_cast<long long>(t / kw) * Wp + t % kw) * C;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int r = idx / BK;
        const int c = idx % BK;
        const long long base = row_base[r];
        a8[r * KW * 4 + c] =
            (base >= 0 && c0 + c < C) ? x[base + tap + c0 + c] : 0;
      }
      // This tap's C-slice occupies packed bytes [t*C/f, (t+1)*C/f).
      decode_tile<P>(w_s, planes, kp, N, (t * C + c0) / f, (t + 1) * C / f,
                     n0, k_bits, top_bits);
      __syncthreads();
      dot_tile<P, SA>(a_s, w_s, acc, ty, tx, k_bits);
      __syncthreads();
    }
  }
  store_tile<P, SA>(e, acc, m0, n0, M, N, ty, tx, k_bits);
}

}  // namespace

// Plain C entry point, loaded with ctypes (kernels/mpmm/conv_kernel.py).
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int conv_mpmm_launch(const void* x, const void* planes,
                                const void* gamma, const void* colsum,
                                const void* scale, const void* shift,
                                const void* residual, void* out, int B,
                                int Hp, int Wp, int C, int Ho, int Wo, int N,
                                int kh, int kw, int stride, int kp,
                                int n_planes, int k_bits, int w_bits,
                                int act_zero, int sa, int flags,
                                void* stream) {
  const Epilogue e{static_cast<const float*>(gamma),
                   static_cast<const int*>(colsum),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(shift),
                   residual, out, act_zero, flags};
  const int top_bits = w_bits - k_bits * (n_planes - 1);
  const int M = B * Ho * Wo;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MPMM_DISPATCH(conv_mpmm_kernel, n_planes, sa, grid, s,
                static_cast<const int8_t*>(x),
                static_cast<const uint8_t*>(planes), B, Hp, Wp, C, Ho, Wo, N,
                kh, kw, stride, kp, k_bits, top_bits, e);
  return static_cast<int>(cudaGetLastError());
}
