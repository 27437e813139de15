// Shared pieces of the two flash-attention forward kernels (flash_fwd.cu,
// flash_fwd_packed.cu) for sm_90a: the PTX wrappers (cp.async, ldmatrix,
// mma.sync, wgmma), the shared-memory tile layouts, the split-precision
// fragment loads, the QK^T and PV products and the online softmax in
// registers.
//
// One block owns one (query head h, batch b, BQ-row query tile) and sweeps
// the 64-key tiles of KV head h / (H / KV) in a loop; O is written once.
// Warp w owns 16 query rows and keeps their scores, running max m, running
// sum l and f32 accumulator in registers, in the C-fragment layout that
// mma.sync m16n8k16 and wgmma m64nNk16 share: lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 8n + 2t and 8n + 2t + 1 of
// each 8-column tile n.  Two routes run the products: wgmma for bf16 at
// D 128 (the serve path; namespace wg below), warp-level mma.sync for f32
// I/O and D 64.  Layouts are the public ones
// (repro_torch/kernels/flashattn/kernel.py): q and out (B, Sq, H, D); keys
// are indexed 0 .. Sk_total - 1, where keys Sk .. Sk_total - 1 are zero rows
// standing for the reference wrapper's padding of K/V to its block.
//
// Masks follow the reference (src/repro/kernels/flashattn/kernel.py): a
// masked score is the finite NEG_INF = -1e30, so a tile that is fully masked
// for a row adds exp(0) = 1 terms that the next unmasked tile wipes with
// alpha = exp(-1e30 - m) = 0; -inf would give NaN there.  Keys at or past
// Sk_total do not exist and take no part at all (score -inf, p = 0).
//
// Split precision.  The tensor cores multiply bf16 operands exactly and sum
// in f32.  An f32 value x is carried as terms x = x0 + x1 (+ x2), each
// x_i = bf16(x - x0 - ... - x_(i-1)): two terms hold 16 significant bits,
// three hold all 24 of f32.  A product of split operands sums the term pairs
// (i, j) with i + j <= 2, smallest first; the dropped pairs are below 2^-26
// of the product.  QK^T runs on the raw q (bf16 I/O: one term each side,
// exact products); the softmax scale is applied to the f32 score after.
// PV splits the f32 weights p into two bf16 terms (three with f32 I/O), so
// a bf16 output does not carry p's bf16 rounding.  With f32 I/O, q, K and V
// are split into three terms each when the fragments are read.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int BKV = 64;  // keys per KV tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  int B, H, KV, Sq, Sk, Sk_total, q_offset, causal, window;  // window 0: none
  float scale;
};

// --- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of BYTES (8 or 16); `valid` false
// writes zeros instead (src-size 0, src is not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(BYTES == 8 || BYTES == 16, "cp.async of 8 or 16 bytes");
  const uint32_t n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on the tensor cores: (16 x 16 bf16) . (16 x 8 bf16), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += sum over term pairs (i, j), i + j <= 2, of a_i . b_j, smallest first.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float (&c)[4],
                                          const uint32_t (&a)[TA][4],
                                          const uint32_t (&b)[TB][2]) {
#pragma unroll
  for (int sum = 2; sum >= 0; --sum)
#pragma unroll
    for (int i = 0; i < TA; ++i) {
      const int j = sum - i;
      if (j >= 0 && j < TB) mma_bf16(c, a[i], b[j]);
    }
}

// Two f32 values -> TERMS packed bf16 pairs (x in the low half), x = sum of
// the terms to 8 * TERMS significant bits.
template <int TERMS>
__device__ __forceinline__ void split2(float x, float y,
                                       uint32_t (&out)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
    x = __fsub_rn(x, __low2float(v));
    y = __fsub_rn(y, __high2float(v));
  }
}

// Split (x, y) into term i's slot `slot` of a fragment array frag[TERMS][N].
template <int TERMS, int N>
__device__ __forceinline__ void split_into(uint32_t (&frag)[TERMS][N],
                                           int slot, float x, float y) {
  uint32_t t[TERMS];
  split2<TERMS>(x, y, t);
#pragma unroll
  for (int i = 0; i < TERMS; ++i) frag[i][slot] = t[i];
}

// --- shared-memory tiles -------------------------------------------------------

// A (rows, D) tile of T in shared memory.  bf16 rows are D contiguous values
// whose 16-byte chunks are XOR-swizzled by row (chunk c of row r sits at
// c ^ (r % 8)), so the eight rows that one ldmatrix reads fall in distinct
// banks.  f32 rows are padded to D + 4 values (16-byte aligned for cp.async).
template <typename T, int D>
struct Tile;

template <int D>
struct Tile<bf16, D> {
  static constexpr int TERMS = 1;  // bf16 operands are exact
  static constexpr int LD = D;
  static constexpr int CHUNK = 8;  // values per 16-byte chunk
  static __device__ __forceinline__ int chunk_off(int row, int c) {
    return row * D + ((c ^ (row & 7)) << 3);
  }
  static __device__ __forceinline__ float at(const bf16* tile, int row, int d) {
    return __bfloat162float(tile[chunk_off(row, d >> 3) + (d & 7)]);
  }
};

template <int D>
struct Tile<float, D> {
  static constexpr int TERMS = 3;  // split into three bf16 terms when read
  static constexpr int LD = D + 4;
  static constexpr int CHUNK = 4;
  static __device__ __forceinline__ int chunk_off(int row, int c) {
    return row * LD + c * 4;
  }
  static __device__ __forceinline__ float at(const float* tile, int row, int d) {
    return tile[row * LD + d];
  }
};

template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes(int rows) {
  return static_cast<size_t>(rows) * Tile<T, D>::LD * sizeof(T);
}

// Start the asynchronous copy of ROWS rows of D values into `tile`, 16 bytes
// a transaction; row_src(r) gives row r's global address or nullptr for a
// zero row.  `any` is a valid global address (read for nothing).
template <typename T, int D, int ROWS, int THREADS, typename RowSrc>
__device__ __forceinline__ void copy_rows(T* tile, RowSrc row_src,
                                          const T* any) {
  using L = Tile<T, D>;
  constexpr int PER_ROW = D / L::CHUNK;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = i % PER_ROW;
    const T* src = row_src(r);
    cp_async<16>(tile + L::chunk_off(r, c),
                 src != nullptr ? src + c * L::CHUNK : any, src != nullptr);
  }
}

// --- fragment loads --------------------------------------------------------------

// A operand, rows row0 .. row0 + 15 and columns kk .. kk + 15 of a (rows, D)
// tile (q, or nothing else: P stays in registers).
template <int D>
__device__ __forceinline__ void load_a(const bf16* tile, int row0, int kk,
                                       uint32_t (&a)[1][4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a[0], tile + Tile<bf16, D>::chunk_off(row0 + (lane & 15),
                                                (kk >> 3) + (lane >> 4)));
}

template <int D>
__device__ __forceinline__ void load_a(const float* tile, int row0, int kk,
                                       uint32_t (&a)[3][4]) {
  constexpr int LD = Tile<float, D>::LD;
  const int lane = threadIdx.x & 31;
  const float* p = tile + (row0 + (lane >> 2)) * LD + kk + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LD);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * LD + 8);
  split_into<3, 4>(a, 0, x0.x, x0.y);
  split_into<3, 4>(a, 1, x1.x, x1.y);
  split_into<3, 4>(a, 2, x2.x, x2.y);
  split_into<3, 4>(a, 3, x3.x, x3.y);
}

// B operand of QK^T for the two 8-key tiles n0 .. n0 + 15 of a (keys, D)
// tile, depth kk .. kk + 15: b[j] is key tile n0 + 8j.
template <int D>
__device__ __forceinline__ void load_b_keys(const bf16* tile, int n0, int kk,
                                            uint32_t (&b)[2][1][2]) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4(r, tile + Tile<bf16, D>::chunk_off(
                        n0 + (lane & 7) + ((lane >> 4) << 3),
                        (kk >> 3) + ((lane >> 3) & 1)));
  b[0][0][0] = r[0];
  b[0][0][1] = r[1];
  b[1][0][0] = r[2];
  b[1][0][1] = r[3];
}

template <int D>
__device__ __forceinline__ void load_b_keys(const float* tile, int n0, int kk,
                                            uint32_t (&b)[2][3][2]) {
  constexpr int LD = Tile<float, D>::LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* p = tile + (n0 + 8 * j + (lane >> 2)) * LD + kk + 2 * (lane & 3);
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 8);
    split_into<3, 2>(b[j], 0, lo.x, lo.y);
    split_into<3, 2>(b[j], 1, hi.x, hi.y);
  }
}

// B operand of PV for keys kk .. kk + 15 and the two 8-column tiles n0 ..
// n0 + 15 of a (keys, D) tile: b[j] is column tile n0 + 8j.
template <int D>
__device__ __forceinline__ void load_b_values(const bf16* tile, int kk, int n0,
                                              uint32_t (&b)[2][1][2]) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4_trans(r, tile + Tile<bf16, D>::chunk_off(
                              kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                              (n0 >> 3) + (lane >> 4)));
  b[0][0][0] = r[0];
  b[0][0][1] = r[1];
  b[1][0][0] = r[2];
  b[1][0][1] = r[3];
}

template <int D>
__device__ __forceinline__ void load_b_values(const float* tile, int kk, int n0,
                                              uint32_t (&b)[2][3][2]) {
  constexpr int LD = Tile<float, D>::LD;
  const int lane = threadIdx.x & 31;
  const float* p = tile + (kk + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split_into<3, 2>(b[j], 0, p[8 * j], p[LD + 8 * j]);
    split_into<3, 2>(b[j], 1, p[8 * LD + 8 * j], p[9 * LD + 8 * j]);
  }
}

// --- warp products -----------------------------------------------------------------

// s = q . k^T for the warp's 16 rows (from row0 of the q tile) and the 64
// keys of the k tile, in f32: s[n][c] is the C fragment of key tile n.
template <int D, typename TQ, typename TK>
__device__ __forceinline__ void qk_tile(const TQ* q_tile, const TK* k_tile,
                                        int row0, float (&s)[BKV / 8][4]) {
  constexpr int TA = Tile<TQ, D>::TERMS;
  constexpr int TB = Tile<TK, D>::TERMS;
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[TA][4];
    load_a<D>(q_tile, row0, kk, a);
#pragma unroll
    for (int n2 = 0; n2 < BKV / 16; ++n2) {
      uint32_t b[2][TB][2];
      load_b_keys<D>(k_tile, 16 * n2, kk, b);
      mma_terms<TA, TB>(s[2 * n2], a, b[0]);
      mma_terms<TA, TB>(s[2 * n2 + 1], a, b[1]);
    }
  }
}

// The A operand of PV from the scores' C fragments: key tiles 2ks and
// 2ks + 1 of w (16 rows x 16 keys), split into PT bf16 terms.
template <int PT, int NT>
__device__ __forceinline__ void p_fragment(const float (&w)[NT][4], int ks,
                                           uint32_t (&a)[PT][4]) {
  split_into<PT, 4>(a, 0, w[2 * ks][0], w[2 * ks][1]);
  split_into<PT, 4>(a, 1, w[2 * ks][2], w[2 * ks][3]);
  split_into<PT, 4>(a, 2, w[2 * ks + 1][0], w[2 * ks + 1][1]);
  split_into<PT, 4>(a, 3, w[2 * ks + 1][2], w[2 * ks + 1][3]);
}

// o += w . v for the warp's 16 rows: w (16 x 64, f32, in the C-fragment
// layout of qk_tile) split into PT bf16 terms, v a (keys, D) tile.
template <int D, int PT, typename TV>
__device__ __forceinline__ void pv_tile(const TV* v_tile,
                                        const float (&w)[BKV / 8][4],
                                        float (&o)[D / 8][4]) {
  constexpr int TB = Tile<TV, D>::TERMS;
#pragma unroll
  for (int ks = 0; ks < BKV / 16; ++ks) {
    uint32_t a[PT][4];
    p_fragment<PT>(w, ks, a);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[2][TB][2];
      load_b_values<D>(v_tile, 16 * ks, 16 * n2, b);
      mma_terms<PT, TB>(o[2 * n2], a, b[0]);
      mma_terms<PT, TB>(o[2 * n2 + 1], a, b[1]);
    }
  }
}

// --- masks and the online softmax ----------------------------------------------------

// The keys [begin, end) a block has to sweep: past the causal band nothing
// is read (as the reference skips its blocks), and below the window of the
// block's first row every score is masked for every row of the block.
template <int BQ>
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

// What the masks do to one warp's `rows` rows (absolute positions q_lo ..
// q_lo + rows - 1) and the `keys` keys from kv0: nothing, some scores, or
// every score.  A
// fully masked tile is skipped: its p = exp(NEG_INF - m) are 0 once a row has
// seen a visible key, and before that the next visible tile wipes them with
// alpha = 0, so skipping changes no bit.
enum class TileMask { kNone, kSome, kAll };

__device__ __forceinline__ TileMask tile_mask(const Shape& s, int q_lo,
                                              int kv0, int rows, int keys) {
  const int q_hi = q_lo + rows - 1;
  const int k_hi = kv0 + keys - 1;
  if (s.causal && kv0 > q_hi) return TileMask::kAll;
  if (s.window > 0 && k_hi <= q_lo - s.window) return TileMask::kAll;
  if (k_hi >= s.Sk_total || (s.causal && k_hi > q_lo) ||
      (s.window > 0 && kv0 <= q_hi - s.window)) {
    return TileMask::kSome;
  }
  return TileMask::kNone;
}

// Mask one score: key past Sk_total -> -inf (no part at all), key outside
// the causal band or the window -> NEG_INF (the reference's finite mask).
__device__ __forceinline__ float mask_score(const Shape& s, float x, int q_pos,
                                            int key) {
  if (key >= s.Sk_total) return -INFINITY;
  if (s.causal && key > q_pos) return NEG_INF;
  if (s.window > 0 && key <= q_pos - s.window) return NEG_INF;
  return x;
}

// Online-softmax step of one warp on its scores in registers, in the log2
// domain: s holds score * log2(e) (masked: NEG_INF).  Turns s into
// p = 2^(s - m_new) = exp(score - max) for the lane's rows g (c = 0, 1) and
// g + 8 (c = 2, 3); updates the row max m (all four lanes of a row agree, by
// quad shuffles), the lane's partial row sum l, and returns
// alpha = 2^(m_old - m_new).  A row whose scores are all NEG_INF so far has
// m = NEG_INF and p = 2^0 = 1, as the reference's finite mask gives.
template <int KEYS>
__device__ __forceinline__ void softmax_step(float (&s)[KEYS / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < KEYS / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(__fsub_rn(m[i], mx[i]));
    m[i] = mx[i];
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = exp2f(__fsub_rn(s[n][c], m[c >> 1]));
      s[n][c] = p;
      sum[c >> 1] += p;
    }
  l[0] = fmaf(l[0], alpha[0], sum[0]);
  l[1] = fmaf(l[1], alpha[1], sum[1]);
}

// o *= alpha by rows; skipped when the running max moved for no row of the
// warp (every alpha is 1), as it mostly does once a row has seen a few
// hundred keys.
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 8][4],
                                        const float (&alpha)[2]) {
  if (__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] = __fmul_rn(o[n][0], alpha[0]);
    o[n][1] = __fmul_rn(o[n][1], alpha[0]);
    o[n][2] = __fmul_rn(o[n][2], alpha[1]);
    o[n][3] = __fmul_rn(o[n][3], alpha[1]);
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// O = (o + z) / max(l, 1e-30) for the warp's rows, cast to the output type;
// z is the lane's share of a per-row term (K4's V zero-point sum; 0 for K3)
// and l the lane's partial row sum.  Rows past Sq are dropped.  o holds D
// columns of rows LD values long (LD > D: a block that owns a column slice
// of the head, `out` pointing at the slice's first column).
template <int D, typename T, int LD = D>
__device__ __forceinline__ void store_out(const float (&o)[D / 8][4],
                                          const float (&l)[2],
                                          const float (&z)[2],
                                          T* __restrict__ out, const Shape& s,
                                          int b, int h, int row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    const float zi = quad_sum(z[i]);
    const int r = row + 8 * i;
    if (r >= s.Sq) continue;
    T* dst = out + (static_cast<size_t>(b) * s.Sq + r) * s.H * LD +
             static_cast<size_t>(h) * LD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dst + 8 * n, __fdiv_rn(__fadd_rn(o[n][2 * i], zi), li),
             __fdiv_rn(__fadd_rn(o[n][2 * i + 1], zi), li));
    }
  }
}

// --- wgmma (bf16, D 128) ------------------------------------------------------

// Warpgroup products: four warps issue one asynchronous product of 64 rows
// (warp w of the group owns rows 16w .. 16w + 15 of it, in the C-fragment
// layout above).  The operands in shared memory are read through
// descriptors, in the layout below; the accumulators and a register A
// operand belong to the product from its issue to wgmma.wait_group.
namespace wg {

// A (ROWS, 128) bf16 tile in 128-byte-swizzled panels of 64 columns, the
// layout wgmma's descriptors read: panel p holds columns 64p .. 64p + 63, a row of a panel is 128 bytes, and
// its 16-byte chunk c sits at c ^ (row % 8); tiles start 1024-aligned.
// Offset in elements of chunk c (0 .. 15) of row `row`.
template <int ROWS>
__device__ __forceinline__ int off(int row, int c) {
  return (c >> 3) * ROWS * 64 + row * 64 + (((c & 7) ^ (row & 7)) << 3);
}

// Start the asynchronous copy of ROWS rows of 128 bf16 into `tile`, 16 bytes
// a transaction (as flash::copy_rows, in the panel layout).
template <int ROWS, int THREADS, typename RowSrc>
__device__ __forceinline__ void copy_rows(bf16* tile, RowSrc row_src,
                                          const bf16* any) {
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * 16; i += THREADS) {
    const int r = i >> 4;
    const int c = i & 15;
    const bf16* src = row_src(r);
    cp_async<16>(tile + off<ROWS>(r, c), src != nullptr ? src + c * 8 : any,
                 src != nullptr);
  }
}

// Shared-memory matrix descriptor with the 128-byte swizzle: the start
// address; `lbo`, the bytes between 64-column panels along the contiguous
// dimension (read for MN-major operands only); `sbo`, the bytes between
// groups of 8 rows (1024 in a panel).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes shared memory through the generic proxy and wgmma reads it
// through the async proxy: each writer fences before the barrier.
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// After wait0: the registers of a finished product stay where it wrote them
// (the compiler sees the asynchronous reads and writes only at the issue).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 64, f32) = A . B (+ d when `accumulate`): A (64 x 16) and B^T
// (64 x 16) bf16, both K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with 32 columns: d (64 x 32).
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A . B: A (64 x 16 bf16) in registers, each warp's
// 16 rows in the mma.sync A-fragment layout; B (16 x 128) MN-major in
// shared memory (a (keys, D) tile read transposed).
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace wg

// Raise the dynamic shared-memory limit of KERNEL, then launch it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The grid of a launch: (H, B, query tiles), the last query tile first (the
// longest causal sweep starts first).
inline dim3 grid_of(const Shape& s, int bq) {
  return dim3(s.H, s.B, (s.Sq + bq - 1) / bq);
}

}  // namespace flash
