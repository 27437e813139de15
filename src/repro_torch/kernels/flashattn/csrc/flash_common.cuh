// Shared pieces of the two flash-attention forward kernels (flash_fwd.cu,
// flash_fwd_packed.cu): the block shape, the shared-memory layout, the score
// tile, the online-softmax step and the P.V accumulation.
//
// One block owns one (batch b, query head h, BQ-row query tile).  It keeps
// the pre-scaled query tile in shared memory and sweeps the key/value tiles
// of KV head h / (H / KV) in a loop, carrying the running max m, the running
// sum l and the f32 accumulator (registers) from tile to tile; O is written
// once.  Layouts are the public ones (repro_torch/kernels/flashattn/kernel.py):
// q and out (B, Sq, H, D); keys are indexed 0 .. Sk_total - 1, where keys
// Sk .. Sk_total - 1 are zero rows standing for the reference wrapper's
// padding of K/V to its block.
//
// Masks follow the reference (src/repro/kernels/flashattn/kernel.py): a
// masked score is the finite NEG_INF = -1e30, so a tile that is fully masked
// for a row adds exp(0) = 1 terms that the next unmasked tile wipes with
// alpha = exp(-1e30 - m) = 0; -inf would give NaN there.  Keys at or past
// Sk_total do not exist and take no part at all.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx) owns rows ty + 16 i
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory, in floats.  Rows of the q and k/v tiles are padded to D + 1
// and score rows to BKV + 1, so the column reads of the inner loops fall in
// distinct banks.  The k/v tile buffer holds K during the scores and V (or
// the decoded V codes) during P.V.
template <int D>
struct Layout {
  static constexpr int LD = D + 1;
  static constexpr int LS = BKV + 1;
  static constexpr int Q = 0;
  static constexpr int KV = Q + BQ * LD;
  static constexpr int S = KV + BKV * LD;
  static constexpr int ROW = S + BQ * LS;     // 5 arrays of BQ: m, l, alpha,
                                              // q_sum, z_sum
  static constexpr int COL = ROW + 5 * BQ;    // 4 arrays of BKV: s_k, z_k,
                                              // s_v, z_v (packed kernel)
  static constexpr int FLOATS = COL + 4 * BKV;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

struct Shape {
  int B, H, KV, Sq, Sk, Sk_total, q_offset, causal, window;  // window 0: none
  float scale;
};

// The keys [begin, end) a block has to sweep: past the causal band nothing
// is read (as the reference skips its blocks), and below the window of the
// block's first row every score is masked for every row of the block.
__device__ __forceinline__ void sweep_range(const Shape& s, int q0, int* begin,
                                            int* end) {
  const int last = min(q0 + BQ, s.Sq) - 1;
  int e = s.Sk_total;
  if (s.causal) e = min(e, s.q_offset + last + 1);
  int b = 0;
  if (s.window > 0) b = max(0, s.q_offset + q0 - s.window + 1) / BKV * BKV;
  *begin = b;
  *end = e;
}

// Load the query tile, pre-scaled in f32 as the reference does; rows past Sq
// are zero and never stored.
template <int D, typename T>
__device__ __forceinline__ void load_q(float* smem, const T* __restrict__ q,
                                       const Shape& s, int b, int h, int q0) {
  using L = Layout<D>;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    const int row = q0 + r;
    float v = 0.0f;
    if (row < s.Sq) {
      v = __fmul_rn(
          to_f32(q[(static_cast<size_t>(b) * s.Sq + row) * s.H * D +
                   static_cast<size_t>(h) * D + d]),
          s.scale);
    }
    smem[L::Q + r * L::LD + d] = v;
  }
  if (threadIdx.x < BQ) {
    smem[L::ROW + threadIdx.x] = NEG_INF;  // m
    smem[L::ROW + BQ + threadIdx.x] = 0.0f;  // l
  }
}

// Raw scores of the tile: s[i][j] = q_(ty+16i) . k_(tx+16j) in f32.
template <int D>
__device__ __forceinline__ void score_tile(const float* smem, float (&s)[4][4],
                                           int ty, int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = smem[L::Q + (ty + 16 * i) * L::LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = smem[L::KV + (tx + 16 * j) * L::LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], k[j], s[i][j]);
  }
}

// Write the masked scores of the tile into the score buffer.
__device__ __forceinline__ bool visible(const Shape& s, int q_pos, int key) {
  bool ok = true;
  if (s.causal) ok = ok && key <= q_pos;
  if (s.window > 0) ok = ok && key > q_pos - s.window;
  return ok;
}

// Online-softmax step over the score buffer, four threads per row.  Turns
// each score into p = exp(s - m_new) times the row weight w[c] (1 for K3, the
// V scale for K4), stores it back for P.V, and updates m, l and alpha; with
// z_v the per-row sum of p * z_v[c] (K4's V zero-point term) goes to z_sum.
template <int D>
__device__ __forceinline__ void softmax_step(float* smem, int n_cols,
                                             const float* w, const float* z_v) {
  using L = Layout<D>;
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  float* srow = smem + L::S + r * L::LS;
  float mx = NEG_INF;
  for (int c = part * 16; c < part * 16 + 16; ++c) {
    if (c < n_cols) mx = fmaxf(mx, srow[c]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_old = smem[L::ROW + r];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.0f;
  float zsum = 0.0f;
  for (int c = part * 16; c < part * 16 + 16; ++c) {
    float p = 0.0f;
    if (c < n_cols) p = expf(srow[c] - m_new);
    sum += p;
    if (z_v != nullptr) zsum = fmaf(p, z_v[c], zsum);
    srow[c] = (w != nullptr) ? __fmul_rn(p, w[c]) : p;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  zsum += __shfl_xor_sync(0xffffffffu, zsum, 1);
  zsum += __shfl_xor_sync(0xffffffffu, zsum, 2);
  if (part == 0) {
    const float alpha = expf(m_old - m_new);
    smem[L::ROW + r] = m_new;
    smem[L::ROW + BQ + r] = fmaf(smem[L::ROW + BQ + r], alpha, sum);
    smem[L::ROW + 2 * BQ + r] = alpha;
    smem[L::ROW + 4 * BQ + r] = zsum;
  }
}

// acc = acc * alpha + P . V (+ z_sum when `with_z`); thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j of the (BQ, D) accumulator.
template <int D>
__device__ __forceinline__ void pv_tile(const float* smem,
                                        float (&acc)[4][D / 16], int n_cols,
                                        bool with_z, int ty, int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float alpha = smem[L::ROW + 2 * BQ + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
  }
  for (int c = 0; c < n_cols; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = smem[L::S + (ty + 16 * i) * L::LS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float v = smem[L::KV + c * L::LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
    }
  }
  if (with_z) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float z = smem[L::ROW + 4 * BQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = __fadd_rn(acc[i][j], z);
    }
  }
}

// O = acc / max(l, 1e-30), cast to the output type; rows past Sq are dropped.
template <int D, typename T>
__device__ __forceinline__ void store_out(const float* smem,
                                          const float (&acc)[4][D / 16],
                                          T* __restrict__ out, const Shape& s,
                                          int b, int h, int q0, int ty,
                                          int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= s.Sq) continue;
    const float l = fmaxf(smem[L::ROW + BQ + r], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * s.Sq + row) * s.H * D +
           static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) store(o + tx + 16 * j, __fdiv_rn(acc[i][j], l));
  }
}

// Raise the dynamic shared-memory limit of KERNEL once, then launch it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
