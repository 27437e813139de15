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
// 4 * B * H * D * S^2 / 2 = 33 GFLOP against 82 MB of q, k, v and O, so the
// function is bound by operations (33 us at the 989 TFLOP/s bf16
// tensor-core peak), not by bytes (25 us at 3.35 TB/s).
//
// What the design does about it:
// - Tile: a block owns 128 query rows of one (b, h) (64 when Sq <= 64, the
//   verify chunk) and sweeps 64-key tiles of KV head h / (H / KV); GQA is
//   an index, K/V are never copied per query head, and tiles past the
//   causal band or below the window are never read.  Scores, the online
//   softmax (row max and sum by quad shuffles, in the log2 domain), alpha
//   and the accumulator stay in registers; a rescale by alpha = 1 is
//   skipped.
// - Copies: q, K and V move with cp.async, 16 bytes a transaction, into
//   swizzled shared memory.  K/V tiles sit in a two-stage ring: the copy of
//   tile t + 1 is in flight while the warps run the products of tile t
//   (cp.async groups, wait_group 1, one block-wide barrier per stage
//   hand-over).
// - Products, bf16 at D 128 (the serve path): wgmma.  Two warpgroups of 64
//   rows; QK^T is m64n32k16 with q and K read from shared memory through
//   descriptors (128-byte-swizzled panels), PV is m64n128k16 with P from
//   registers and V read transposed from shared memory.  Scoring 32 keys at
//   a time keeps a thread at 124 registers, so two blocks share an SM and
//   one block's softmax runs while the other's products do.
// - Products, f32 I/O, D 64, D 192 (nemotron-4-340b) and D 256
//   (recurrentgemma-9b; both bf16 only, an f32 q tile and two f32 K/V
//   stages exceed a block's shared memory there): mma.sync.m16n8k16 bf16
//   fed by ldmatrix (ldmatrix.trans for V), 8 warps of 16 rows, P reused
//   from the score registers as the A operand of PV.  At D 256 two blocks
//   share a head, each scoring every key over the whole D and keeping 128
//   of V's columns (grid x = 2H): the O accumulator of all 256 would be 128
//   f32 registers a thread and spill; the price is QK^T done twice.
// - Split precision (flash_common.cuh): QK^T on the raw bf16 q, the scale
//   (times log2 e) applied to the f32 score; PV with p = p_hi + p_lo (two
//   bf16 terms); with f32 I/O q, K, V and p in three bf16 terms each (six
//   term products).
//
// Registers (nvcc -Xptxas -v, sm_90a) and shared memory a block; no
// variant spills:
//   flash_fwd_wgmma_kernel<2> (Sq > 64)   124 regs, 99328 B, 2 blocks an SM
//   flash_fwd_wgmma_kernel<1> (Sq <= 64)  128 regs, 82944 B
//   flash_fwd_kernel<D, warps, T>:  <128,8,f32> 194 regs, 202752 B;
//   <128,4,f32> 194, 168960 B;  <64,8,f32> 160, 104448 B;
//   <64,4,f32> 160, 87040 B;  <64,8,bf16> 142, 49152 B;  <64,4,bf16> 142,
//   40960 B;  <192,8,bf16> 239, 147456 B;  <192,4,bf16> 239, 122880 B;
//   <256,8,bf16> 193, 163840 B;  <256,4,bf16> 193, 131072 B (128 of V's
//   columns a block: template argument DV, = D at the other head dims).
#include "flash_common.cuh"

namespace {

using namespace flash;

// --- bf16, D 128: wgmma ------------------------------------------------------

constexpr int WG_KEYS = 32;  // keys a warpgroup scores at once

template <int WG>
struct K3WgSmem {
  static constexpr int BQ = 64 * WG;
  static constexpr size_t TILE = 64 * 128 * 2;  // one K or V tile
  static constexpr size_t Q = 0;                 // every offset 1024-aligned
  static constexpr size_t KV = Q + BQ * 128 * 2;
  static constexpr size_t STAGE = 2 * TILE;
  static constexpr size_t BYTES = KV + 2 * STAGE + 1024;  // + alignment
};

// WG warpgroups of 64 query rows.
template <int WG>
__global__ void __launch_bounds__(128 * WG, 2)
    flash_fwd_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           Shape s) {
  using S = K3WgSmem<WG>;
  constexpr int BQ = S::BQ;
  constexpr int THREADS = 128 * WG;
  constexpr int D = 128;
  constexpr int KEYS = WG_KEYS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* q_tile = reinterpret_cast<bf16*>(smem + S::Q);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int g = h / (s.H / s.KV);
  const int wgi = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int row0 = 64 * wgi + 16 * warp;  // the warp's first row
  const int q_lo = s.q_offset + q0 + row0;
  const int wg_lo = s.q_offset + q0 + 64 * wgi;  // the warpgroup's first
  const bool live = q0 + 64 * wgi < s.Sq;       // warpgroup-uniform
  const float scale2 = s.scale * LOG2E;         // scores in the log2 domain

  wg::copy_rows<BQ, THREADS>(
      q_tile,
      [&](int r) -> const bf16* {
        const int row = q0 + r;
        return row < s.Sq ? q + (static_cast<size_t>(b) * s.Sq + row) * s.H * D +
                                static_cast<size_t>(h) * D
                          : nullptr;
      },
      q);
  cp_commit();
  auto stage_k = [&](int st) {
    return reinterpret_cast<bf16*>(smem + S::KV + st * S::STAGE);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<bf16*>(smem + S::KV + st * S::STAGE + S::TILE);
  };
  auto issue = [&](int kv0, int st) {
    auto row_of = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        const int key = kv0 + r;
        return key < s.Sk ? base + ((static_cast<size_t>(b) * s.Sk + key) *
                                        s.KV + g) * D
                          : nullptr;
      };
    };
    wg::copy_rows<BKV, THREADS>(stage_k(st), row_of(k), k);
    wg::copy_rows<BKV, THREADS>(stage_v(st), row_of(v), v);
  };

  int begin, end;
  sweep_range<BQ>(s, q0, &begin, &end);
  if (begin < end) issue(begin, 0);
  cp_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  float(&o_flat)[64] = *reinterpret_cast<float(*)[64]>(&o[0][0]);
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};

  int st = 0;
  for (int kv0 = begin; kv0 < end; kv0 += BKV, st ^= 1) {
    if (kv0 + BKV < end) issue(kv0 + BKV, st ^ 1);
    cp_commit();
    cp_wait<1>();       // q and tile kv0 have landed (this thread's copies)
    wg::fence_proxy();  // ... visible to wgmma once every thread is past:
    __syncthreads();
#pragma unroll
    for (int half = 0; half < BKV / KEYS; ++half) {
      const int kb = kv0 + half * KEYS;
      if (!live || tile_mask(s, wg_lo, kb, 64, KEYS) == TileMask::kAll) {
        continue;
      }
      float sc[KEYS / 8][4];
      float(&s_flat)[KEYS / 2] =
          *reinterpret_cast<float(*)[KEYS / 2]>(&sc[0][0]);
      const bf16* kt = stage_k(st) + half * KEYS * 64;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wg::mma_ss(s_flat,
                   wg::desc(q_tile + wg::off<BQ>(64 * wgi, 2 * kk), 16, 1024),
                   wg::desc(kt + wg::off<BKV>(0, 2 * kk), 16, 1024), kk > 0);
      }
      wg::commit();
      wg::wait0();
      wg::pin(s_flat);
      const TileMask mask = tile_mask(s, q_lo, kb, 16, KEYS);
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = __fmul_rn(sc[n][c], scale2);
          sc[n][c] = mask == TileMask::kNone
                         ? x
                         : mask_score(s, x, q_lo + (lane >> 2) + 8 * (c >> 1),
                                      kb + 8 * n + 2 * (lane & 3) + (c & 1));
        }
      float alpha[2];
      softmax_step<KEYS>(sc, m, l, alpha);
      rescale<D>(o, alpha);
      uint32_t a[KEYS / 16][2][4];  // p_hi, p_lo per 16 keys
#pragma unroll
      for (int ks = 0; ks < KEYS / 16; ++ks) p_fragment<2>(sc, ks, a[ks]);
      const bf16* vt = stage_v(st) + half * KEYS * 64;
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < KEYS / 16; ++ks) {
        const uint64_t dv =
            wg::desc(vt + wg::off<BKV>(16 * ks, 0), BKV * 128, 1024);
        wg::mma_rs(o_flat, a[ks][1], dv);  // the smaller term first
        wg::mma_rs(o_flat, a[ks][0], dv);
      }
      wg::commit();
      wg::wait0();
      wg::pin(o_flat);
#pragma unroll
      for (int ks = 0; ks < KEYS / 16; ++ks) {
        wg::pin(a[ks][0]);
        wg::pin(a[ks][1]);
      }
    }
    __syncthreads();  // stage st is free for the copy issued next iteration
  }
  cp_wait<0>();
  const float z[2] = {0.0f, 0.0f};
  store_out<D>(o, l, z, out, s, b, h, q0 + row0 + (lane >> 2));
}

// --- f32 I/O, D 64, 192 and 256: mma.sync ------------------------------------

// A block computes DV of the head's D output columns (DV = D but at D 256,
// where two blocks share a head, each scoring every key over the whole D
// and keeping 128 accumulator columns: 64 f32 registers a thread instead
// of 128, which would spill).  The K tile holds D columns, the V tile DV.
template <int D, int DV, int WARPS, typename T>
struct K3Smem {
  static constexpr int BQ = 16 * WARPS;
  static constexpr size_t Q = 0;
  static constexpr size_t KV = Q + tile_bytes<T, D>(BQ);  // 2 stages of K, V
  static constexpr size_t K_TILE = tile_bytes<T, D>(BKV);
  static constexpr size_t STAGE = K_TILE + tile_bytes<T, DV>(BKV);
  static constexpr size_t BYTES = KV + 2 * STAGE;
};

template <int D, int DV, int WARPS, typename T>
__global__ void __launch_bounds__(32 * WARPS, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, Shape s) {
  using S = K3Smem<D, DV, WARPS, T>;
  constexpr int BQ = S::BQ;
  constexpr int THREADS = 32 * WARPS;
  constexpr int PT = Tile<T, D>::TERMS == 1 ? 2 : 3;  // terms of p
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_tile = reinterpret_cast<T*>(smem + S::Q);
  const int h = blockIdx.x / (D / DV);
  const int dv0 = (blockIdx.x % (D / DV)) * DV;  // the block's V columns
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int g = h / (s.H / s.KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * warp;
  const int q_lo = s.q_offset + q0 + row0;  // the warp's first position
  const bool live = q0 + row0 < s.Sq;  // rows past Sq are never stored
  const float scale2 = s.scale * LOG2E;  // scores in the log2 domain

  copy_rows<T, D, BQ, THREADS>(
      q_tile,
      [&](int r) -> const T* {
        const int row = q0 + r;
        return row < s.Sq ? q + (static_cast<size_t>(b) * s.Sq + row) * s.H * D +
                                static_cast<size_t>(h) * D
                          : nullptr;
      },
      q);
  cp_commit();

  auto stage_k = [&](int st) {
    return reinterpret_cast<T*>(smem + S::KV + st * S::STAGE);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<T*>(smem + S::KV + st * S::STAGE + S::K_TILE);
  };
  auto issue = [&](int kv0, int st) {
    auto row_of = [&](const T* base, int col0) {
      return [=](int r) -> const T* {
        const int key = kv0 + r;
        return key < s.Sk ? base + ((static_cast<size_t>(b) * s.Sk + key) *
                                        s.KV + g) * D + col0
                          : nullptr;
      };
    };
    copy_rows<T, D, BKV, THREADS>(stage_k(st), row_of(k, 0), k);
    copy_rows<T, DV, BKV, THREADS>(stage_v(st), row_of(v, dv0), v);
  };

  int begin, end;
  sweep_range<BQ>(s, q0, &begin, &end);
  if (begin < end) issue(begin, 0);
  cp_commit();

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};

  int st = 0;
  for (int kv0 = begin; kv0 < end; kv0 += BKV, st ^= 1) {
    if (kv0 + BKV < end) issue(kv0 + BKV, st ^ 1);
    cp_commit();
    cp_wait<1>();  // q and tile kv0 have landed (this thread's copies)
    __syncthreads();  // ... and every thread's
    const TileMask mask = tile_mask(s, q_lo, kv0, 16, BKV);
    if (live && mask != TileMask::kAll) {
      float sc[BKV / 8][4];
      qk_tile<D>(q_tile, stage_k(st), row0, sc);
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = __fmul_rn(sc[n][c], scale2);
          sc[n][c] = mask == TileMask::kNone
                         ? x
                         : mask_score(s, x, q_lo + (lane >> 2) + 8 * (c >> 1),
                                      kv0 + 8 * n + 2 * (lane & 3) + (c & 1));
        }
      float alpha[2];
      softmax_step<BKV>(sc, m, l, alpha);
      rescale<DV>(o, alpha);
      pv_tile<DV, PT>(stage_v(st), sc, o);
    }
    __syncthreads();  // stage st is free for the copy issued next iteration
  }
  cp_wait<0>();
  const float z[2] = {0.0f, 0.0f};
  store_out<DV, T, D>(o, l, z, out + dv0, s, b, h, q0 + row0 + (lane >> 2));
}

// --- launch --------------------------------------------------------------------

template <int WG>
int launch_wg(const void* q, const void* k, const void* v, void* out,
              const Shape& s, cudaStream_t stream) {
  return launch(flash_fwd_wgmma_kernel<WG>, K3WgSmem<WG>::BYTES,
                grid_of(s, 64 * WG), 128 * WG, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(out), s);
}

template <int D, int WARPS, typename T>
int launch_w(const void* q, const void* k, const void* v, void* out,
             const Shape& s, cudaStream_t stream) {
  constexpr int DV = D == 256 ? 128 : D;  // two column halves at D 256
  dim3 grid = grid_of(s, 16 * WARPS);
  grid.x *= D / DV;
  return launch(flash_fwd_kernel<D, DV, WARPS, T>,
                K3Smem<D, DV, WARPS, T>::BYTES, grid, 32 * WARPS, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out), s);
}

// 128 query rows a block, 64 for short query chunks (the verify chunk).
template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const Shape& s, cudaStream_t stream) {
  if constexpr (D == 128 && Tile<T, D>::TERMS == 1) {
    return s.Sq <= 64 ? launch_wg<1>(q, k, v, out, s, stream)
                      : launch_wg<2>(q, k, v, out, s, stream);
  } else {
    return s.Sq <= 64 ? launch_w<D, 4, T>(q, k, v, out, s, stream)
                      : launch_w<D, 8, T>(q, k, v, out, s, stream);
  }
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int D,
             const Shape& s, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_d<64, T>(q, k, v, out, s, stream);
    case 128: return launch_d<128, T>(q, k, v, out, s, stream);
    case 192:  // bf16 only: an f32 q tile and two f32 K/V stages exceed
               // a block's shared memory at D 192 and 256
      if constexpr (Tile<T, 192>::TERMS == 1) {
        return launch_d<192, T>(q, k, v, out, s, stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    case 256:
      if constexpr (Tile<T, 256>::TERMS == 1) {
        return launch_d<256, T>(q, k, v, out, s, stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
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
