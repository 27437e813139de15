// K4: flash-attention forward over the packed digit-plane KV cache, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flashattn/kernel.py:178 flash_fwd_packed (body
// _fwd_kernel_packed), together with the GQA gather and transposes of its
// wrapper ops.flash_attention_packed.  K and V arrive in the decode cache's
// own layout (repro_torch/nn/kvcache.py): unsigned k-bit digit planes, uint8
// (P, B, Sk, KV, ceil(D / (8/k))), 8/k digits per byte along head_dim with
// the digit index minor inside a byte, and a bf16 scale s and zero z per
// (token, KV head).  A cached row is code * s + z, so
//
//   score  = s_k * (q . code_k) + z_k * sum(q)
//   P.V    = sum_j (p_j s_v,j) code_v,j + sum_j p_j z_v,j
//
// and dequantized K/V never exist.  Masks, the causal skip, NEG_INF and the
// final acc / max(l, 1e-30) are K3's (flash_common.cuh).
//
// What bounds it on this card: at granite-8b's prefill (B 4, S 1000, H 32,
// KV 8, D 128) the products are the same 33 GFLOP as K3's against fewer
// bytes (the planes are 2-8 bits a value), so operations bound it; the plane
// decode adds integer work per KV byte, not per score.
//
// What the design does about it: each KV tile's packed bytes are read once
// per query tile and recombined into codes (f32, exact below 2^8) in shared
// memory, so the inner loops are K3's; the scale and zero of each key are
// read once per tile; the V scale is folded into p (p * s_v) and the V zero
// into one per-row sum, as the reference does.  Tensor cores on the integer
// codes, TMA and pipelining are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Planes {
  const uint8_t* p;     // (P, B, Sk, KV, pd)
  const __nv_bfloat16* s;  // (B, Sk, KV)
  const __nv_bfloat16* z;  // (B, Sk, KV)
  int planes;
  int k_bits;
};

// Recombine one KV tile's digit planes into codes in the k/v buffer (f32,
// exact below 2^8).  Keys at or past Sk decode to code 0: the zero rows of
// the padding.
template <int D>
__device__ __forceinline__ void decode_codes(float* smem, const Planes& pl,
                                             const Shape& s, int b, int g,
                                             int kv0) {
  using L = Layout<D>;
  const int f = 8 / pl.k_bits;
  const int pd = (D + f - 1) / f;
  const int mask = (1 << pl.k_bits) - 1;
  const size_t plane_stride = static_cast<size_t>(s.B) * s.Sk * s.KV * pd;
  for (int idx = threadIdx.x; idx < BKV * pd; idx += THREADS) {
    const int c = idx / pd;
    const int byte = idx % pd;
    const int key = kv0 + c;
    int code[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (key < s.Sk) {
      const uint8_t* src =
          pl.p + ((static_cast<size_t>(b) * s.Sk + key) * s.KV + g) * pd + byte;
      for (int p = 0; p < pl.planes; ++p) {
        const int v = src[p * plane_stride];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < f) code[i] |= ((v >> (pl.k_bits * i)) & mask) << (pl.k_bits * p);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = byte * f + i;
      if (i < f && d < D) smem[L::KV + c * L::LD + d] = static_cast<float>(code[i]);
    }
  }
}

// Read the tile's per-key scale and zero (bf16 -> f32, exact) into `col_s` /
// `col_z`; keys at or past Sk get 0.
__device__ __forceinline__ void load_scales(const Planes& pl, const Shape& s,
                                            int b, int g, int kv0,
                                            float* col_s, float* col_z) {
  if (threadIdx.x < BKV) {
    const int key = kv0 + threadIdx.x;
    float sv = 0.0f, zv = 0.0f;
    if (key < s.Sk) {
      const size_t i = (static_cast<size_t>(b) * s.Sk + key) * s.KV + g;
      sv = __bfloat162float(pl.s[i]);
      zv = __bfloat162float(pl.z[i]);
    }
    col_s[threadIdx.x] = sv;
    col_z[threadIdx.x] = zv;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_packed_kernel(const T* __restrict__ q, Planes kp, Planes vp,
                            T* __restrict__ out, Shape s) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (s.H / s.KV);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float* q_sum = smem + L::ROW + 3 * BQ;
  float* k_s = smem + L::COL;
  float* k_z = k_s + BKV;
  float* v_s = k_z + BKV;
  float* v_z = v_s + BKV;
  load_q<D>(smem, q, s, b, h, q0);
  __syncthreads();
  if (threadIdx.x < BQ) {  // sum of the scaled query row: the K zero's factor
    float t = 0.0f;
    for (int d = 0; d < D; ++d) t = __fadd_rn(t, smem[L::Q + threadIdx.x * L::LD + d]);
    q_sum[threadIdx.x] = t;
  }

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
    decode_codes<D>(smem, kp, s, b, g, kv0);
    load_scales(kp, s, b, g, kv0, k_s, k_z);
    load_scales(vp, s, b, g, kv0, v_s, v_z);  // V's enter the softmax step
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
        const float val = fmaf(q_sum[r], k_z[c], __fmul_rn(sc[i][j], k_s[c]));
        smem[L::S + r * L::LS + c] = visible(s, q_pos, kv0 + c) ? val : NEG_INF;
      }
    }
    __syncthreads();  // scores are in; the K codes are no longer read
    softmax_step<D>(smem, n_cols, v_s, v_z);
    decode_codes<D>(smem, vp, s, b, g, kv0);
    __syncthreads();
    pv_tile<D>(smem, acc, n_cols, true, ty, tx);
  }
  store_out<D>(smem, acc, out, s, b, h, q0, ty, tx);
}

template <int D, typename T>
int launch_d(const void* q, const Planes& kp, const Planes& vp, void* out,
             const Shape& s, cudaStream_t stream) {
  const dim3 grid((s.Sq + BQ - 1) / BQ, s.H, s.B);
  return launch(flash_fwd_packed_kernel<D, T>, Layout<D>::BYTES, grid, stream,
                static_cast<const T*>(q), kp, vp, static_cast<T*>(out), s);
}

template <typename T>
int launch_t(const void* q, const Planes& kp, const Planes& vp, void* out,
             int D, const Shape& s, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_d<64, T>(q, kp, vp, out, s, stream);
    case 128: return launch_d<128, T>(q, kp, vp, out, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes (kernels/flashattn/kernel.py).
// Launches on `stream` and returns the launch's CUDA error (0 on success).
extern "C" int flash_fwd_packed_launch(
    const void* q, const void* kp, const void* ks, const void* kz,
    const void* vp, const void* vs, const void* vz, void* out, int B, int H,
    int KV, int Sq, int Sk, int Sk_total, int D, int k_planes, int k_bits,
    int v_planes, int v_bits, int q_offset, int causal, int window,
    float scale, int bf16, void* stream) {
  if (k_bits < 1 || 8 % k_bits || v_bits < 1 || 8 % v_bits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{B, H, KV, Sq, Sk, Sk_total, q_offset, causal, window, scale};
  const Planes k{static_cast<const uint8_t*>(kp),
                 static_cast<const __nv_bfloat16*>(ks),
                 static_cast<const __nv_bfloat16*>(kz), k_planes, k_bits};
  const Planes v{static_cast<const uint8_t*>(vp),
                 static_cast<const __nv_bfloat16*>(vs),
                 static_cast<const __nv_bfloat16*>(vz), v_planes, v_bits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_t<__nv_bfloat16>(q, k, v, out, D, s, st)
              : launch_t<float>(q, k, v, out, D, s, st);
}
