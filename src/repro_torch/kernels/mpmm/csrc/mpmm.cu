// K1: mixed-precision matmul over packed k-bit digit planes, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mpmm/kernel.py::mpmm_pallas
// (body _mpmm_kernel, decode _decode_block):
//
//   y[M, N] = epilogue(gamma * ((a_biased @ W_int) + act_zero * colsum))
//
// with a_biased int8 (M, K) and W_int decoded from uint8 planes (P, Kp, N).
//
// What bounds it on this card: at the serve path's shapes (the ResNet stem
// as im2col, M = B*112*112, K = 147, N = 64; the classifier, M = B, K = 512,
// N = 1000) the function moves far more bytes than it does operations per
// byte, so device-memory traffic is the bound: the activation codes in and
// the bf16 output, plus w/8 bytes per weight.
//
// What the design does about it: each byte of the inputs is read once per
// output tile that needs it, the weights stay packed in device memory and
// are decoded to int8 digits in shared memory, and the whole epilogue
// (zero-point, dequant, BN, residual, ReLU, cast) runs on the int32
// accumulators in registers, so no partial sum ever reaches device memory.
// Where the TPU kernel carried the accumulator across its sequential K grid
// axis, one block here owns a BM x BN output tile and loops over K inside.
// The dot products are __dp4a on CUDA cores with int32 accumulation; the
// tensor-core (wgmma) and TMA versions, vector loads and a split-K for the
// small-M classifier are later work.
#include "mpmm_common.cuh"

namespace {

using namespace mpmm;

template <int P, bool SA>
__global__ void __launch_bounds__(THREADS)
    mpmm_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ planes,
                int M, int N, int K, int kp, int k_bits, int top_bits,
                Epilogue e) {
  __shared__ int a_s[BM][KW];
  __shared__ int w_s[P][BN][KW];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int f = 8 / k_bits;
  int8_t* a8 = reinterpret_cast<int8_t*>(a_s);
  int acc[SA ? P : 1][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int c = idx % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      a8[r * KW * 4 + c] =
          (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk] : 0;
    }
    decode_tile<P>(w_s, planes, kp, N, k0 / f, kp, n0, k_bits, top_bits);
    __syncthreads();
    dot_tile<P, SA>(a_s, w_s, acc, ty, tx, k_bits);
    __syncthreads();
  }
  store_tile<P, SA>(e, acc, m0, n0, M, N, ty, tx, k_bits);
}

}  // namespace

// Plain C entry point, loaded with ctypes (kernels/mpmm/kernel.py).  Launches
// on `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int mpmm_launch(const void* a, const void* planes,
                           const void* gamma, const void* colsum,
                           const void* scale, const void* shift,
                           const void* residual, void* out, int M, int N,
                           int K, int kp, int n_planes, int k_bits,
                           int w_bits, int act_zero, int sa, int flags,
                           void* stream) {
  const Epilogue e{static_cast<const float*>(gamma),
                   static_cast<const int*>(colsum),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(shift),
                   residual, out, act_zero, flags};
  const int top_bits = w_bits - k_bits * (n_planes - 1);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MPMM_DISPATCH(mpmm_kernel, n_planes, sa, grid, s,
                static_cast<const int8_t*>(a),
                static_cast<const uint8_t*>(planes), M, N, K, kp, k_bits,
                top_bits, e);
  return static_cast<int>(cudaGetLastError());
}
