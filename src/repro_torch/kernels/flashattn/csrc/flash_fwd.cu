// K3: causal / windowed GQA flash-attention forward, for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flashattn/kernel.py:233 flash_fwd (body _fwd_kernel),
// together with the GQA gather of its wrapper ops.flash_attention:
//
//   O[b, i, h] = sum_j softmax_j(scale * q_i . k_j) v_j
//
// over the keys the causal / window masks leave to query row i (absolute
// position q_offset + i), with q (B, Sq, H, D), k and v (B, Sk, KV, D) in f32
// or bf16, scores, softmax and accumulator in f32, O in q's type.
//
// What bounds it on this card: at the serve path's prefill (granite-8b,
// B 4, S 1000, H 32, KV 8, D 128, causal) the two products are about
// 2 * B * H * S^2 * D / 2 * 2 = 33 GFLOP against 82 MB of q, k, v and O, so
// the function is bound by operations (tens of microseconds at the bf16
// tensor-core peak), not by bytes.
//
// What the design does about it, in this first version: the score tile never
// leaves the SM.  Each block keeps its pre-scaled 64-row query tile in shared
// memory, reads each 64-key K and V tile once per query tile, and runs both
// products as f32 FMAs on CUDA cores from conflict-free shared-memory rows,
// 16 scores and 32 accumulators per thread.  GQA is an index (KV head
// h / (H / KV)), so K/V are never copied per query head; KV tiles past the
// causal band and below the window are never read.  Tensor cores (mma /
// wgmma on bf16 tiles), TMA and a software pipeline are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, Shape s) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (s.H / s.KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  load_q<D>(smem, q, s, b, h, q0);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;

  int begin, end;
  sweep_range(s, q0, &begin, &end);
  for (int kv0 = begin; kv0 < end; kv0 += BKV) {
    const int n_cols = min(BKV, s.Sk_total - kv0);
    __syncthreads();  // the previous tile's P.V is done with the buffers
    for (int idx = threadIdx.x; idx < BKV * D; idx += THREADS) {
      const int c = idx / D;
      const int d = idx % D;
      const int key = kv0 + c;
      smem[L::KV + c * L::LD + d] =
          key < s.Sk ? to_f32(k[((static_cast<size_t>(b) * s.Sk + key) * s.KV +
                                 g) * D + d])
                     : 0.0f;
    }
    __syncthreads();
    float sc[4][4];
    score_tile<D>(smem, sc, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = s.q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        smem[L::S + r * L::LS + c] =
            visible(s, q_pos, kv0 + c) ? sc[i][j] : NEG_INF;
      }
    }
    __syncthreads();  // scores are in; K is no longer read
    softmax_step<D>(smem, n_cols, nullptr, nullptr);
    for (int idx = threadIdx.x; idx < BKV * D; idx += THREADS) {
      const int c = idx / D;
      const int d = idx % D;
      const int key = kv0 + c;
      smem[L::KV + c * L::LD + d] =
          key < s.Sk ? to_f32(v[((static_cast<size_t>(b) * s.Sk + key) * s.KV +
                                 g) * D + d])
                     : 0.0f;
    }
    __syncthreads();
    pv_tile<D>(smem, acc, n_cols, false, ty, tx);
  }
  store_out<D>(smem, acc, out, s, b, h, q0, ty, tx);
}

template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const Shape& s, cudaStream_t stream) {
  const dim3 grid((s.Sq + BQ - 1) / BQ, s.H, s.B);
  return launch(flash_fwd_kernel<D, T>, Layout<D>::BYTES, grid, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out), s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int D,
             const Shape& s, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_d<64, T>(q, k, v, out, s, stream);
    case 128: return launch_d<128, T>(q, k, v, out, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes (kernels/flashattn/kernel.py).
// Launches on `stream` and returns the launch's CUDA error (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int KV, int Sq,
                                int Sk, int Sk_total, int D, int q_offset,
                                int causal, int window, float scale, int bf16,
                                void* stream) {
  const Shape s{B, H, KV, Sq, Sk, Sk_total, q_offset, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_t<__nv_bfloat16>(q, k, v, out, D, s, st)
              : launch_t<float>(q, k, v, out, D, s, st);
}
