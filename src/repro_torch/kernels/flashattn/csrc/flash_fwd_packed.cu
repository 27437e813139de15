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
//   score  = scale * s_k * (q . code_k) + z_k * sum(q * scale)
//   P.V    = sum_j (p_j s_v,j) code_v,j + sum_j p_j z_v,j
//
// and dequantized K/V never exist.  Masks, the causal skip, NEG_INF and the
// final acc / max(l, 1e-30) are K3's (flash_common.cuh).
//
// What bounds it on this card: at granite-8b's prefill (B 4, S 1000, H 32,
// KV 8, D 128) the products are the same 33 GFLOP as K3's against fewer
// bytes (the planes are 2-8 bits a value: 69 MB with K kv2 and V kv4, q and
// O being 66 MB of it), so operations bound it (33 us at the bf16
// tensor-core peak, 21 us for the bytes at 3.35 TB/s).
//
// What the design does about it:
// - Tile: 128 query rows a block (64 when Sq <= 64), 64-key tiles, scores,
//   softmax and accumulator in registers (flash_common.cuh).
// - Products, bf16 q at D 128 (the serve path): wgmma, two warpgroups of 64
//   rows; QK^T m64n64k16 with q and the K codes read from shared memory
//   through descriptors, PV m64n128k16 with p * s_v from registers and the
//   V codes read transposed.  f32 I/O, D 64 and D 192 (bf16 only):
//   mma.sync.m16n8k16 bf16 fed by ldmatrix, 8 warps of 16 rows.
// - Copies: q and the packed bytes of each K and V tile (P planes x 64 keys
//   x pd bytes, pd = D * k / 8, keys KV * pd bytes apart) move with
//   cp.async, 16 bytes a transaction (8 where pd is not a multiple of 16:
//   1-bit digits at D 64 and D 192), into a two-stage raw ring.  Each key's
//   bf16 scale and zero (2 bytes, KV apart: too small for cp.async) are
//   loaded into registers two tiles ahead.
// - Pipeline, one barrier a tile: between two barriers a warp multiplies
//   tile t from one pair of code tiles and decodes tile t + 1 into the
//   other, while tile t + 2's bytes land; warps at different points of the
//   two phases overlap.
// - Decode: threads recombine the planes of 8 digits into one code and write
//   it as a bf16 c - 2^(bits - 1) (exact: |c - 2^(bits-1)| <= 128) into
//   swizzled K and V code tiles, with byte permutes, masks and one bf16x2
//   subtraction per pair and no int -> float conversion; the zero point
//   becomes z + 2^(bits - 1) s.  QK^T is one product whatever the plane
//   count (the ST shortcut of ops.combined_int8_weights for K1), and centred
//   codes keep the tensor cores' f32 sums small (uncentred kv8 codes all
//   share one sign, and their sums cancel against the zero-point term only
//   after the product).
// - Split precision: QK^T on the raw q against the exact codes, scale,
//   log2 e and s_k applied to the f32 score, z_k * q_sum added in f32; PV on
//   the weights p * s_v split into two bf16 terms (three with f32 I/O, where
//   q is split into three terms too), the V zero one f32 sum per row.
//
// Registers (nvcc -Xptxas -v, sm_90a) and shared memory a block; one block
// an SM; no variant spills but <192,8,bf16> (112 bytes stored, 128 loaded):
//   flash_fwd_packed_wgmma_kernel<2> (Sq > 64)   252 regs, 135168 B
//   flash_fwd_packed_wgmma_kernel<1> (Sq <= 64)  255 regs, 118784 B
//   flash_fwd_packed_kernel<D, warps, T>:  <128,8,f32> 237 regs, 168960 B;
//   <128,4,f32> 242, 135168 B;  <64,8,f32> 179, 87040 B;  <64,4,f32> 186,
//   69632 B;  <64,8,bf16> 169, 68608 B;  <64,4,bf16> 179, 60416 B;
//   <192,8,bf16> 255, 199680 B;  <192,4,bf16> 254, 175104 B.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Planes {
  const uint8_t* p;   // (P, B, Sk, KV, pd)
  const bf16* s;      // (B, Sk, KV)
  const bf16* z;      // (B, Sk, KV)
  int planes;
  int k_bits;
};

template <int D, int WARPS, typename T>
struct K4Smem {
  static constexpr int BQ = 16 * WARPS;
  static constexpr size_t RAW = static_cast<size_t>(BKV) * D;  // P * pd <= D
  static constexpr size_t CODES = 2 * tile_bytes<bf16, D>(BKV);  // K, V codes
  static constexpr size_t Q = 0;
  static constexpr size_t CODE = Q + tile_bytes<T, D>(BQ);  // 2 x (K, V)
  static constexpr size_t RING = CODE + 2 * CODES;           // 2 x (K, V) raw
  static constexpr size_t COL = RING + 4 * RAW;  // 3 x (s_k, z_k, s_v, z_v)
  static constexpr size_t BYTES = COL + 3 * 4 * BKV * sizeof(float);
};

// Start the copy of one tile's packed bytes (every plane, keys kv0 ..
// kv0 + 63) into `raw`: plane p's key c at raw + (p * BKV + c) * pd.  Keys at
// or past Sk are zero bytes (code 0: the padding's zero rows).
template <int D, int THREADS>
__device__ __forceinline__ void copy_planes(uint8_t* raw, const Planes& pl,
                                            const Shape& s, int b, int g,
                                            int kv0) {
  const int pd = D * pl.k_bits / 8;
  const size_t plane_stride = static_cast<size_t>(s.B) * s.Sk * s.KV * pd;
  const int bytes = pl.planes * BKV * pd;
  auto src = [&](int byte, bool* valid) {
    const int p = byte / (BKV * pd);
    const int c = byte / pd % BKV;
    const int key = kv0 + c;
    *valid = key < s.Sk;
    return pl.p + p * plane_stride +
           ((static_cast<size_t>(b) * s.Sk + key) * s.KV + g) * pd + byte % pd;
  };
  if (pd % 16 == 0) {
    for (int byte = 16 * threadIdx.x; byte < bytes; byte += 16 * THREADS) {
      bool valid;
      const uint8_t* p = src(byte, &valid);
      cp_async<16>(raw + byte, valid ? p : pl.p, valid);
    }
  } else {  // 1-bit digits at D 64 and D 192: rows of 8 and 24 bytes
    for (int byte = 8 * threadIdx.x; byte < bytes; byte += 8 * THREADS) {
      bool valid;
      const uint8_t* p = src(byte, &valid);
      cp_async<8>(raw + byte, valid ? p : pl.p, valid);
    }
  }
}

// The centre of a format's codes, 2^(bits - 1): codes are stored and
// multiplied as c - center (|c - center| <= 128, exact in bf16), and the
// zero point takes z + center * s, so the tensor cores sum values of both
// signs instead of codes that all share one sign.
__device__ __forceinline__ int code_center(const Planes& pl) {
  return 1 << (pl.planes * pl.k_bits - 1);
}

// 8 digits of k bits (digit e at bits k * e of w) -> digit e at bits 4e.
template <int K>
__device__ __forceinline__ uint32_t digits_to_nibbles(uint32_t w) {
  if constexpr (K == 1) {
    w = (w | (w << 12)) & 0x000F000Fu;
    w = (w | (w << 6)) & 0x03030303u;
    w = (w | (w << 3)) & 0x11111111u;
  } else if constexpr (K == 2) {
    w = (w | (w << 8)) & 0x00FF00FFu;
    w = (w | (w << 4)) & 0x0F0F0F0Fu;
    w = (w | (w << 2)) & 0x33333333u;
  }
  return w;
}

// Codes of one 16-byte chunk (8 values of head_dim) from a tile's planes:
// code e in byte e of (lo, hi).  A chunk's 8 digits of k bits are k bytes
// of each plane (little-endian, digit e at bits k * e); plane p is digit p
// of the code, shifted by k * p.
template <int K>
__device__ __forceinline__ void chunk_codes(const uint8_t* src, int planes,
                                            int plane_bytes, uint32_t* lo,
                                            uint32_t* hi) {
  if constexpr (K == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);  // one plane
    *lo = w.x;
    *hi = w.y;
  } else {
    *lo = *hi = 0;
    for (int p = 0; p < planes; ++p, src += plane_bytes) {
      uint32_t w;
      if constexpr (K == 4) w = *reinterpret_cast<const uint32_t*>(src);
      if constexpr (K == 2) w = *reinterpret_cast<const uint16_t*>(src);
      if constexpr (K == 1) w = *src;
      w = digits_to_nibbles<K>(w);
      const uint32_t even = w & 0x0F0F0F0Fu;         // codes 0, 2, 4, 6
      const uint32_t odd = (w >> 4) & 0x0F0F0F0Fu;   // codes 1, 3, 5, 7
      *lo |= __byte_perm(even, odd, 0x5140) << (K * p);
      *hi |= __byte_perm(even, odd, 0x7362) << (K * p);
    }
  }
}

// Two codes (bytes 2i, 2i + 1 of `word`'s pair) -> bf16x2 of c - center.
// The bf16 with bits 0x4300 | (c & 127) is 128 + (c & 127), which is c
// itself when c >= 128; the subtrahend is 128 + center below 128 and center
// above (with 8-bit codes center is 128: bf16 0x4380 or 0x4300).  Every
// value is an integer of at most 8 significant bits, so the bf16
// subtraction is exact.  No int -> float conversion takes place.
__device__ __forceinline__ uint32_t centered_pair(uint32_t word, int pair,
                                                  bool wide, uint32_t sub) {
  const uint32_t t = __byte_perm(word, 0, pair ? 0x4342 : 0x4140);
  uint32_t v;
  if (wide) {
    v = (t & 0x007F007Fu) | 0x43004300u;
    sub = 0x43804380u - (t & 0x00800080u);
  } else {
    v = t | 0x43004300u;
  }
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Recombine one tile's digit planes (`raw`, as copy_planes lays them out)
// into centred bf16 codes in a swizzled (BKV, D) tile, one 16-byte chunk of
// 8 codes at a time.
template <int D, int THREADS, int K, bool PANELS>
__device__ __forceinline__ void decode_k(bf16* codes, const uint8_t* raw,
                                         int planes) {
  constexpr int PD = D * K / 8;
  constexpr int PER_ROW = D / 8;
  static_assert(BKV * PER_ROW % THREADS == 0, "whole chunks per thread");
  const bool wide = planes * K == 8;
  const int center = 1 << (planes * K - 1);
  const uint32_t sub = 0x00010001u * __bfloat16_as_ushort(__float2bfloat16_rn(
                                         static_cast<float>(128 + center)));
  for (int r = 0; r < BKV * PER_ROW / THREADS; ++r) {
    const int i = threadIdx.x + r * THREADS;
    const int c = i / PER_ROW;
    const int j = i % PER_ROW;
    uint32_t lo, hi;
    chunk_codes<K>(raw + c * PD + j * K, planes, BKV * PD, &lo, &hi);
    uint4 packed;
    packed.x = centered_pair(lo, 0, wide, sub);
    packed.y = centered_pair(lo, 1, wide, sub);
    packed.z = centered_pair(hi, 0, wide, sub);
    packed.w = centered_pair(hi, 1, wide, sub);
    const int at = PANELS ? wg::off<BKV>(c, j) : Tile<bf16, D>::chunk_off(c, j);
    *reinterpret_cast<uint4*>(codes + at) = packed;
  }
}

// PANELS: the wgmma layout (wg::off) instead of the ldmatrix one.
template <int D, int THREADS, bool PANELS = false>
__device__ __forceinline__ void decode_codes(bf16* codes, const uint8_t* raw,
                                             const Planes& pl) {
  switch (pl.k_bits) {
    case 1: decode_k<D, THREADS, 1, PANELS>(codes, raw, pl.planes); break;
    case 2: decode_k<D, THREADS, 2, PANELS>(codes, raw, pl.planes); break;
    case 4: decode_k<D, THREADS, 4, PANELS>(codes, raw, pl.planes); break;
    default: decode_k<D, THREADS, 8, PANELS>(codes, raw, pl.planes); break;
  }
}

// One key's scale s and centred zero z + center * s (f32) for thread i <
// 2 * BKV: key kv0 + i % BKV of K (i < BKV) or of V.  Keys at or past Sk get
// 0 and 0 (with their codes, the padding's zero rows).  The tile's columns
// in shared memory are s_k, z_k, s_v, z_v, BKV floats each.
__device__ __forceinline__ void load_cols(float (&sz)[2], const Planes& kp,
                                          const Planes& vp, const Shape& s,
                                          int b, int g, int kv0) {
  sz[0] = sz[1] = 0.0f;
  const int i = threadIdx.x;
  const bool is_k = i < BKV;
  const int key = kv0 + i % BKV;
  if (i < 2 * BKV && key < s.Sk) {
    const size_t at = (static_cast<size_t>(b) * s.Sk + key) * s.KV + g;
    const float center =
        static_cast<float>(is_k ? code_center(kp) : code_center(vp));
    sz[0] = __bfloat162float(is_k ? kp.s[at] : vp.s[at]);
    sz[1] = fmaf(center, sz[0], __bfloat162float(is_k ? kp.z[at] : vp.z[at]));
  }
}

__device__ __forceinline__ void store_cols(float* cols, const float (&sz)[2]) {
  const int i = threadIdx.x;
  if (i < 2 * BKV) {
    float* base = cols + (i / BKV) * 2 * BKV + i % BKV;
    base[0] = sz[0];
    base[BKV] = sz[1];
  }
}

// --- f32 I/O and D 64: mma.sync ---------------------------------------------

template <int D, int WARPS, typename T>
__global__ void __launch_bounds__(32 * WARPS, 1)
    flash_fwd_packed_kernel(const T* __restrict__ q, Planes kp, Planes vp,
                            T* __restrict__ out, Shape s) {
  using S = K4Smem<D, WARPS, T>;
  constexpr int BQ = S::BQ;
  constexpr int THREADS = 32 * WARPS;
  constexpr int PT = Tile<T, D>::TERMS == 1 ? 2 : 3;  // terms of p * s_v
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_tile = reinterpret_cast<T*>(smem + S::Q);
  auto k_codes = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + S::CODE + buf * S::CODES);
  };
  auto v_codes = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + S::CODE + buf * S::CODES +
                                   tile_bytes<bf16, D>(BKV));
  };
  auto raw_k = [&](int st) { return smem + S::RING + 2 * st * S::RAW; };
  auto raw_v = [&](int st) { return smem + S::RING + (2 * st + 1) * S::RAW; };
  auto cols = [&](int st) {
    return reinterpret_cast<float*>(smem + S::COL) + st * 4 * BKV;
  };
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int g = h / (s.H / s.KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * warp;
  const int q_lo = s.q_offset + q0 + row0;
  const bool live = q0 + row0 < s.Sq;  // rows past Sq are never stored
  const float scale2 = s.scale * LOG2E;  // scores in the log2 domain

  int begin, end;
  sweep_range<BQ>(s, q0, &begin, &end);
  const int n_tiles = begin < end ? (end - begin + BKV - 1) / BKV : 0;
  auto issue = [&](int t) {  // tile t's packed bytes into raw stage t % 2
    copy_planes<D, THREADS>(raw_k(t & 1), kp, s, b, g, begin + t * BKV);
    copy_planes<D, THREADS>(raw_v(t & 1), vp, s, b, g, begin + t * BKV);
  };
  auto decode = [&](int t) {  // raw stage t % 2 -> code buffer t % 2
    decode_codes<D, THREADS>(k_codes(t & 1), raw_k(t & 1), kp);
    decode_codes<D, THREADS>(v_codes(t & 1), raw_v(t & 1), vp);
  };

  // Prologue: q and tile 0 land and tile 0 is decoded; tile 1's bytes land.
  copy_rows<T, D, BQ, THREADS>(
      q_tile,
      [&](int r) -> const T* {
        const int row = q0 + r;
        return row < s.Sq ? q + (static_cast<size_t>(b) * s.Sq + row) * s.H * D +
                                static_cast<size_t>(h) * D
                          : nullptr;
      },
      q);
  if (n_tiles > 0) issue(0);
  cp_commit();
  if (n_tiles > 1) issue(1);
  cp_commit();
  float col_next[2];
  load_cols(col_next, kp, vp, s, b, g, begin);
  store_cols(cols(0), col_next);
  load_cols(col_next, kp, vp, s, b, g, begin + BKV);
  store_cols(cols(1), col_next);
  cp_wait<1>();
  __syncthreads();

  // q_sum: the sum of the scaled query row (the K zero's factor), over D in
  // order, times log2(e); lanes 2i and 2i + 1 take halves of the warp's row i
  float q_sum[2];
  {
    const int r = row0 + (lane >> 1);
    const int d0 = (lane & 1) * (D / 2);
    float t = 0.0f;
    for (int d = d0; d < d0 + D / 2; ++d) {
      t = __fadd_rn(t, __fmul_rn(Tile<T, D>::at(q_tile, r, d), s.scale));
    }
    const float lo = __shfl_sync(0xffffffffu, t, (lane & ~1));
    const float hi = __shfl_sync(0xffffffffu, t, (lane | 1));
    const float row_sum = __fadd_rn(lo, hi);
    q_sum[0] = __fmul_rn(__shfl_sync(0xffffffffu, row_sum, 2 * (lane >> 2)),
                         LOG2E);
    q_sum[1] = __fmul_rn(
        __shfl_sync(0xffffffffu, row_sum, 2 * ((lane >> 2) + 8)), LOG2E);
  }
  if (n_tiles > 0) decode(0);
  cp_wait<0>();
  __syncthreads();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float z[2] = {0.0f, 0.0f};  // the lane's share of sum_j p_j z_v,j

  // One barrier a tile.  Between two barriers a warp multiplies tile t
  // (codes t % 2, columns t % 3) and decodes tile t + 1 (landed before the
  // barrier) into the other code buffer, while tile t + 2's bytes land in
  // the raw stage that tile t left; warps at different points of the two
  // phases overlap.
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = begin + t * BKV;
    if (t + 2 < n_tiles) {
      issue(t + 2);
      load_cols(col_next, kp, vp, s, b, g, kv0 + 2 * BKV);
    }
    cp_commit();
    const TileMask mask = tile_mask(s, q_lo, kv0, 16, BKV);
    if (live && mask != TileMask::kAll) {
      const float* col = cols(t % 3);
      float sc[BKV / 8][4];
      qk_tile<D>(q_tile, k_codes(t & 1), row0, sc);
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        const int c0 = 8 * n + 2 * (lane & 3);
        const float2 sk = *reinterpret_cast<const float2*>(col + c0);
        const float2 zk = *reinterpret_cast<const float2*>(col + BKV + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = fmaf(q_sum[c >> 1], (c & 1) ? zk.y : zk.x,
                               __fmul_rn(__fmul_rn(sc[n][c], scale2),
                                         (c & 1) ? sk.y : sk.x));
          sc[n][c] = mask == TileMask::kNone
                         ? x
                         : mask_score(s, x, q_lo + (lane >> 2) + 8 * (c >> 1),
                                      kv0 + c0 + (c & 1));
        }
      }
      float alpha[2];
      softmax_step<BKV>(sc, m, l, alpha);
      rescale<D>(o, alpha);
      z[0] = __fmul_rn(z[0], alpha[0]);
      z[1] = __fmul_rn(z[1], alpha[1]);
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        const int c0 = 8 * n + 2 * (lane & 3);
        const float2 sv = *reinterpret_cast<const float2*>(col + 2 * BKV + c0);
        const float2 zv = *reinterpret_cast<const float2*>(col + 3 * BKV + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = sc[n][c];
          z[c >> 1] = fmaf(p, (c & 1) ? zv.y : zv.x, z[c >> 1]);
          sc[n][c] = __fmul_rn(p, (c & 1) ? sv.y : sv.x);
        }
      }
      pv_tile<D, PT>(v_codes(t & 1), sc, o);
    }
    if (t + 1 < n_tiles) decode(t + 1);
    if (t + 2 < n_tiles) store_cols(cols((t + 2) % 3), col_next);
    cp_wait<0>();     // tile t + 2's bytes have landed (this thread's copies)
    __syncthreads();  // ... and every thread's; tile t + 1 is decoded
  }
  cp_wait<0>();
  store_out<D>(o, l, z, out, s, b, h, q0 + row0 + (lane >> 2));
}

// --- bf16, D 128: wgmma -------------------------------------------------------

template <int WG>
struct K4WgSmem {
  static constexpr int BQ = 64 * WG;
  static constexpr size_t RAW = static_cast<size_t>(BKV) * 128;
  static constexpr size_t TILE = 64 * 128 * 2;  // one code tile
  static constexpr size_t Q = 0;                 // tile offsets 1024-aligned
  static constexpr size_t CODE = Q + BQ * 128 * 2;  // 2 x (K, V) codes
  static constexpr size_t RING = CODE + 4 * TILE;   // 2 x (K, V) raw
  static constexpr size_t COL = RING + 4 * RAW;     // 3 x (s_k, z_k, s_v, z_v)
  static constexpr size_t BYTES = COL + 3 * 4 * BKV * sizeof(float) + 1024;
};

// WG warpgroups of 64 query rows; the pipeline of flash_fwd_packed_kernel,
// with the code tiles in wgmma's panel layout.
template <int WG>
__global__ void __launch_bounds__(128 * WG, 1)
    flash_fwd_packed_wgmma_kernel(const bf16* __restrict__ q, Planes kp,
                                  Planes vp, bf16* __restrict__ out, Shape s) {
  using S = K4WgSmem<WG>;
  constexpr int BQ = S::BQ;
  constexpr int THREADS = 128 * WG;
  constexpr int D = 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* q_tile = reinterpret_cast<bf16*>(smem + S::Q);
  auto k_codes = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + S::CODE + buf * 2 * S::TILE);
  };
  auto v_codes = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + S::CODE + (buf * 2 + 1) * S::TILE);
  };
  auto raw_k = [&](int st) { return smem + S::RING + 2 * st * S::RAW; };
  auto raw_v = [&](int st) { return smem + S::RING + (2 * st + 1) * S::RAW; };
  auto cols = [&](int st) {
    return reinterpret_cast<float*>(smem + S::COL) + st * 4 * BKV;
  };
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int g = h / (s.H / s.KV);
  const int wgi = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int row0 = 64 * wgi + 16 * warp;
  const int q_lo = s.q_offset + q0 + row0;
  const int wg_lo = s.q_offset + q0 + 64 * wgi;
  const bool live = q0 + 64 * wgi < s.Sq;
  const float scale2 = s.scale * LOG2E;

  int begin, end;
  sweep_range<BQ>(s, q0, &begin, &end);
  const int n_tiles = begin < end ? (end - begin + BKV - 1) / BKV : 0;
  auto issue = [&](int t) {
    copy_planes<D, THREADS>(raw_k(t & 1), kp, s, b, g, begin + t * BKV);
    copy_planes<D, THREADS>(raw_v(t & 1), vp, s, b, g, begin + t * BKV);
  };
  auto decode = [&](int t) {
    decode_codes<D, THREADS, true>(k_codes(t & 1), raw_k(t & 1), kp);
    decode_codes<D, THREADS, true>(v_codes(t & 1), raw_v(t & 1), vp);
  };

  wg::copy_rows<BQ, THREADS>(
      q_tile,
      [&](int r) -> const bf16* {
        const int row = q0 + r;
        return row < s.Sq ? q + (static_cast<size_t>(b) * s.Sq + row) * s.H * D +
                                static_cast<size_t>(h) * D
                          : nullptr;
      },
      q);
  if (n_tiles > 0) issue(0);
  cp_commit();
  if (n_tiles > 1) issue(1);
  cp_commit();
  float col_next[2];
  load_cols(col_next, kp, vp, s, b, g, begin);
  store_cols(cols(0), col_next);
  load_cols(col_next, kp, vp, s, b, g, begin + BKV);
  store_cols(cols(1), col_next);
  cp_wait<1>();
  __syncthreads();

  float q_sum[2];
  {
    const int r = row0 + (lane >> 1);
    const int d0 = (lane & 1) * (D / 2);
    float t = 0.0f;
    for (int d = d0; d < d0 + D / 2; ++d) {
      const float x =
          __bfloat162float(q_tile[wg::off<BQ>(r, d >> 3) + (d & 7)]);
      t = __fadd_rn(t, __fmul_rn(x, s.scale));
    }
    const float lo = __shfl_sync(0xffffffffu, t, (lane & ~1));
    const float hi = __shfl_sync(0xffffffffu, t, (lane | 1));
    const float row_sum = __fadd_rn(lo, hi);
    q_sum[0] = __fmul_rn(__shfl_sync(0xffffffffu, row_sum, 2 * (lane >> 2)),
                         LOG2E);
    q_sum[1] = __fmul_rn(
        __shfl_sync(0xffffffffu, row_sum, 2 * ((lane >> 2) + 8)), LOG2E);
  }
  if (n_tiles > 0) decode(0);
  cp_wait<0>();
  wg::fence_proxy();
  __syncthreads();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  float(&o_flat)[64] = *reinterpret_cast<float(*)[64]>(&o[0][0]);
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float z[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = begin + t * BKV;
    if (t + 2 < n_tiles) {
      issue(t + 2);
      load_cols(col_next, kp, vp, s, b, g, kv0 + 2 * BKV);
    }
    cp_commit();
    const TileMask wg_mask = tile_mask(s, wg_lo, kv0, 64, BKV);
    if (live && wg_mask != TileMask::kAll) {
      const float* col = cols(t % 3);
      float sc[BKV / 8][4];
      float(&s_flat)[32] = *reinterpret_cast<float(*)[32]>(&sc[0][0]);
      const bf16* kt = k_codes(t & 1);
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
      const TileMask mask = tile_mask(s, q_lo, kv0, 16, BKV);
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        const int c0 = 8 * n + 2 * (lane & 3);
        const float2 sk = *reinterpret_cast<const float2*>(col + c0);
        const float2 zk = *reinterpret_cast<const float2*>(col + BKV + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = fmaf(q_sum[c >> 1], (c & 1) ? zk.y : zk.x,
                               __fmul_rn(__fmul_rn(sc[n][c], scale2),
                                         (c & 1) ? sk.y : sk.x));
          sc[n][c] = mask == TileMask::kNone
                         ? x
                         : mask_score(s, x, q_lo + (lane >> 2) + 8 * (c >> 1),
                                      kv0 + c0 + (c & 1));
        }
      }
      float alpha[2];
      softmax_step<BKV>(sc, m, l, alpha);
      rescale<D>(o, alpha);
      z[0] = __fmul_rn(z[0], alpha[0]);
      z[1] = __fmul_rn(z[1], alpha[1]);
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        const int c0 = 8 * n + 2 * (lane & 3);
        const float2 sv = *reinterpret_cast<const float2*>(col + 2 * BKV + c0);
        const float2 zv = *reinterpret_cast<const float2*>(col + 3 * BKV + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = sc[n][c];
          z[c >> 1] = fmaf(p, (c & 1) ? zv.y : zv.x, z[c >> 1]);
          sc[n][c] = __fmul_rn(p, (c & 1) ? sv.y : sv.x);
        }
      }
      uint32_t a[BKV / 16][2][4];  // (p s_v)_hi, _lo per 16 keys
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) p_fragment<2>(sc, ks, a[ks]);
      const bf16* vt = v_codes(t & 1);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) {
        const uint64_t dv =
            wg::desc(vt + wg::off<BKV>(16 * ks, 0), BKV * 128, 1024);
        wg::mma_rs(o_flat, a[ks][1], dv);  // the smaller term first
        wg::mma_rs(o_flat, a[ks][0], dv);
      }
      wg::commit();
      wg::wait0();
      wg::pin(o_flat);
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) {
        wg::pin(a[ks][0]);
        wg::pin(a[ks][1]);
      }
    }
    if (t + 1 < n_tiles) decode(t + 1);
    if (t + 2 < n_tiles) store_cols(cols((t + 2) % 3), col_next);
    cp_wait<0>();
    wg::fence_proxy();
    __syncthreads();
  }
  store_out<D>(o, l, z, out, s, b, h, q0 + row0 + (lane >> 2));
}

// --- launch --------------------------------------------------------------------

template <int WG>
int launch_wg(const void* q, const Planes& kp, const Planes& vp, void* out,
              const Shape& s, cudaStream_t stream) {
  return launch(flash_fwd_packed_wgmma_kernel<WG>, K4WgSmem<WG>::BYTES,
                grid_of(s, 64 * WG), 128 * WG, stream,
                static_cast<const bf16*>(q), kp, vp, static_cast<bf16*>(out),
                s);
}

template <int D, int WARPS, typename T>
int launch_w(const void* q, const Planes& kp, const Planes& vp, void* out,
             const Shape& s, cudaStream_t stream) {
  return launch(flash_fwd_packed_kernel<D, WARPS, T>,
                K4Smem<D, WARPS, T>::BYTES, grid_of(s, 16 * WARPS), 32 * WARPS,
                stream, static_cast<const T*>(q), kp, vp, static_cast<T*>(out),
                s);
}

template <int D, typename T>
int launch_d(const void* q, const Planes& kp, const Planes& vp, void* out,
             const Shape& s, cudaStream_t stream) {
  if constexpr (D == 128 && Tile<T, D>::TERMS == 1) {
    return s.Sq <= 64 ? launch_wg<1>(q, kp, vp, out, s, stream)
                      : launch_wg<2>(q, kp, vp, out, s, stream);
  } else {
    return s.Sq <= 64 ? launch_w<D, 4, T>(q, kp, vp, out, s, stream)
                      : launch_w<D, 8, T>(q, kp, vp, out, s, stream);
  }
}

template <typename T>
int launch_t(const void* q, const Planes& kp, const Planes& vp, void* out,
             int D, const Shape& s, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_d<64, T>(q, kp, vp, out, s, stream);
    case 128: return launch_d<128, T>(q, kp, vp, out, s, stream);
    case 192:  // bf16 only: an f32 q tile does not fit beside the code
               // tiles of D 192 in 8 warps' shared memory
      if constexpr (Tile<T, 192>::TERMS == 1) {
        return launch_d<192, T>(q, kp, vp, out, s, stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
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
  if (k_bits < 1 || 8 % k_bits || v_bits < 1 || 8 % v_bits ||
      k_planes * k_bits > 8 || v_planes * v_bits > 8) {
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
