// Shared pieces of the mixed-precision kernels on int8 tensor cores (K1's
// route A, mpmm_wgmma.cu, and K2, conv_mpmm.cu) and of K1's route B
// (mpmm_splitk.cu): the bit assembly that turns packed k-bit digit planes
// into int8 weight codes in registers, the byte transpose that makes the
// codes K-contiguous per column, the copy helpers, the int8 warpgroup
// products, and the tile pieces both tensor-core kernels run (the swizzled
// stage of raw planes, its decode into the B tile, a K-step's products,
// the epilogue from the accumulator registers).
//
// Storage format (repro_torch/core/packing.py; see mpmm_common.cuh): a w-bit
// signed code is split into P = w/k planes of k-bit fields, lower planes
// unsigned, the top plane the sign-carrying field.  Where k > w there is
// one plane (P = 1) whose k-bit fields each hold the w-bit two's-complement
// code in their low w bits (the high bits zero).  Planes are uint8
// (P, ceil(K/f), N), f = 8/k digits a byte along K, field index minor.
//
// Bit assembly, four columns at once: a 32-bit word read from a plane row
// holds one byte of each of four neighbouring columns (N is the planes'
// minor axis), so every operation below acts on four byte lanes.  Digit j
// of a byte is (x >> k*(j % f)) & lane_mask, the mask keeping the field's
// low min(k, w) bits; the planes are disjoint bit fields of the code, so
// the w-bit code is the OR of each plane's field shifted by k*p, and the
// int8 weight is that code sign-extended from w bits, per lane: (u ^ s) -
// s with s = 2^(w-1) in every lane (__vsub4 subtracts lane by lane,
// without borrows across lanes).  This is ref.combined_int8_weights bit
// for bit (tests/test_torch_mpmm_routes.py holds a numpy twin of these
// operations against it).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "mpmm_common.cuh"

namespace k1 {

template <int W, int K>
struct Format {
  static_assert(K == 1 || K == 2 || K == 4 || K == 8, "k divides 8");
  static_assert(W == 1 || W == 2 || W == 4 || W == 8, "w in 1, 2, 4, 8");
  static constexpr int P = W > K ? W / K : 1;     // planes
  static constexpr int F = 8 / K;                 // digits a byte
  static constexpr int FB = W < K ? W : K;        // code bits of a field
  static constexpr uint32_t LANE_MASK = 0x01010101u * ((1u << FB) - 1u);
};

// Planes of a (w, k) format on the host side of a launch: w/k, or 1 where
// k > w.  The C entry points refuse a plane count that disagrees.
constexpr int planes_of(int w_bits, int k_bits) {
  return w_bits > k_bits ? w_bits / k_bits : 1;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Sign-extend each byte lane of `u` from BITS bits to 8.
template <int BITS>
__device__ __forceinline__ uint32_t sext_lanes(uint32_t u) {
  if constexpr (BITS == 8) {
    return u;
  } else {
    constexpr uint32_t s = 0x01010101u << (BITS - 1);
    return __vsub4(u ^ s, s);
  }
}

// Lane-wise field of digit j (0 <= j < R*F) of plane p, from the plane's
// row words x[p][r] (row r holds digits r*F .. r*F + F - 1).
template <int W, int K, int NP, int R>
__device__ __forceinline__ uint32_t field(const uint32_t (&x)[NP][R], int p,
                                          int j) {
  using Fm = Format<W, K>;
  return (x[p][j / Fm::F] >> (K * (j % Fm::F))) & Fm::LANE_MASK;
}

// Sum-Together: the int8 weight codes of digit j, four columns a word.
template <int W, int K, int R>
__device__ __forceinline__ uint32_t code_word(
    const uint32_t (&x)[Format<W, K>::P][R], int j) {
  uint32_t u = 0;
#pragma unroll
  for (int p = 0; p < Format<W, K>::P; ++p) {
    u |= field<W, K>(x, p, j) << (K * p);
  }
  return sext_lanes<W>(u);
}

// Sum-Apart: plane p's digits of position j as int8 (the top plane's
// field sign-extended from its code bits -- k, or w where k > w -- the
// lower planes' unsigned).
template <int W, int K, int R>
__device__ __forceinline__ uint32_t digit_word(
    const uint32_t (&x)[Format<W, K>::P][R], int p, int j) {
  using Fm = Format<W, K>;
  const uint32_t u = field<W, K>(x, p, j);
  return p == Fm::P - 1 ? sext_lanes<Fm::FB>(u) : u;
}

// 4 x 4 byte transpose: r[i] holds digit i of columns 0..3 (lane c =
// column c); afterwards r[c] holds digits 0..3 of column c (lane i =
// digit i), the K-contiguous order of dp4a and of wgmma's K-major operand.
__device__ __forceinline__ void transpose4(uint32_t (&r)[4]) {
  const uint32_t t0 = prmt(r[0], r[1], 0x5140);
  const uint32_t t1 = prmt(r[0], r[1], 0x7362);
  const uint32_t t2 = prmt(r[2], r[3], 0x5140);
  const uint32_t t3 = prmt(r[2], r[3], 0x7362);
  r[0] = prmt(t0, t2, 0x5410);
  r[1] = prmt(t0, t2, 0x7632);
  r[2] = prmt(t1, t3, 0x5410);
  r[3] = prmt(t1, t3, 0x7632);
}

// --- epilogue -------------------------------------------------------------------

// mpmm_common.cuh's epilogue_store up to the cast, op for op (zero-point
// correction -> dequant -> BN -> residual -> ReLU, each step rounded once),
// on operands the caller has loaded: route A loads a column's gamma,
// colsum, scale and shift once for all the rows it stores, with read-only
// loads that need not wait for the stores before them.
__device__ __forceinline__ float epilogue_value(int acc, int act_zero,
                                               int colsum, float gamma,
                                               int flags, float scale,
                                               float shift, float res) {
  const int corrected = acc + act_zero * colsum;
  float y = __fmul_rn(__int2float_rn(corrected), gamma);
  if (flags & mpmm::EPI_BN) y = __fmaf_rn(y, scale, shift);
  if (flags & mpmm::EPI_RESIDUAL) y = __fadd_rn(y, res);
  if (flags & mpmm::EPI_RELU) y = fmaxf(y, 0.0f);
  return y;
}

// --- copies ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous 16-byte global -> shared copy; `valid` false writes zeros
// (src-size 0, src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- int8 warpgroup products (wgmma, sm_90a) ----------------------------------

// Four warps issue one asynchronous product of 64 rows; warp w of the group
// owns rows 16w .. 16w + 15 of it.  The int32 accumulator of m64nNk32 has
// the f32 layout of m64nNk16: register 4j + 2i + c of lane l holds row
// l/4 + 8i, column 8j + 2(l%4) + c.  Both operands are read from shared
// memory through descriptors and, for 8-bit types, must be K-major.
namespace wg {

// Shared-memory matrix descriptor for a K-major operand in 128-byte-swizzled
// rows (row r's 16-byte chunk c at c ^ (r % 8), 8-row groups 1024 bytes
// apart, tile 1024-aligned).  Advancing the start address by 32 bytes steps
// one k32 slice along the row.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Offset in bytes of byte `k` (0 .. 127) of row `row` in that layout.
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
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
// Generic-proxy shared-memory writes (cp.async, st.shared) before reads by
// the async proxy (wgmma): each writer fences before the barrier.
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// After wait0: keep the finished product's registers where it wrote them.
template <int NR>
__device__ __forceinline__ void pin(int (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, s32) = A . B^T (+ d when `accumulate`): A (64 x 32) and B
// (128 x 32) s8, both K-major in shared memory.
__device__ __forceinline__ void mma_s8(int (&d)[64], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same product at 64 columns: d (64 x 64, s32), B (64 x 32).
__device__ __forceinline__ void mma_s8_n64(int (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x BN) (+)= A . B^T at BN = 128 or 64 columns.
template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db,
                                    int accumulate) {
  static_assert(BN == 128 || BN == 64, "N tile 128 or 64");
  if constexpr (BN == 128) {
    mma_s8(d, da, db, accumulate);
  } else {
    mma_s8_n64(d, da, db, accumulate);
  }
}

}  // namespace wg

// --- tensor-core tile pieces (route A and K2) --------------------------------
// A block of THREADS threads (two warpgroups) steps K by BK = 128 digits,
// one 128-byte swizzle row of int8.  Its B tile holds BN (128 or 64)
// weight columns as rows of BK digits, K-major and swizzled; the raw
// packed planes of a K-step are staged as rows of BN bytes, one row per
// packed byte of K.
namespace tc {

constexpr int BK = 128;
constexpr int THREADS = 256;

// Slot of the 16-byte chunk `c` (columns 16c .. 16c + 15) of packed row
// `kb` of a stage: XORed with the 16-digit block the row belongs to, which
// is what a decoding thread's lane index walks.
template <int K, int BN>
__device__ __forceinline__ int raw_off(int plane_row, int kb, int c) {
  constexpr int F = 8 / K;
  return plane_row * BN + (((c ^ (kb * F / 16)) & (BN / 16 - 1)) << 4);
}

// Decode one stage's packed bytes into the K-major B tile (row n = column
// n of the weights, BK int8 digits, swizzled).  Thread (warp h, lane
// 8a + b) takes the four columns 16(h % CG) + 4a .. + 3 and DIG = 2 CG
// digits from (8 (h / CG) + b) DIG on (CG = BN/16 chunks of 16 columns: at
// BN 128 each warp owns a chunk and a thread 16 digits, at BN 64 two warps
// share a chunk and a thread takes 8).  It reads DIG/f words of each plane
// it needs (4 columns a word), assembles DIG code words -- Sum-Together
// codes, or under SA plane `plane`'s digits -- transposes them four by
// four into column order and stores each column's DIG bytes at once.
template <int W, int K, bool SA, int BN>
__device__ __forceinline__ void decode_stage(const unsigned char* raw,
                                             unsigned char* bt, int plane) {
  using Fm = Format<W, K>;
  constexpr int RR = BK / Fm::F;
  constexpr int CG = BN / 16;
  constexpr int DIG = 2 * CG;
  constexpr int R = DIG / Fm::F;  // packed rows a thread reads per plane
  constexpr int Q = DIG / 4;
  constexpr int NP = SA ? 1 : Fm::P;
  const int h = threadIdx.x >> 5;
  const int ch = h % CG;
  const int a = (threadIdx.x >> 3) & 3;
  const int d0 = (8 * (h / CG) + (threadIdx.x & 7)) * DIG;
  const int kb0 = d0 / Fm::F;
  uint32_t x[NP][R];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int pl = SA ? plane : p;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int kb = kb0 + r;
      x[p][r] = *reinterpret_cast<const uint32_t*>(
          raw + raw_off<K, BN>(pl * RR + kb, kb, ch) + 4 * a);
    }
  }
  uint32_t col[4][Q];  // col[c][q]: digits d0 + 4q .. + 3 of column c
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (SA) {  // one plane's digits; the top plane's signed
        const uint32_t u = field<W, K>(x, 0, 4 * q + i);
        w[i] = plane == Fm::P - 1 ? sext_lanes<Fm::FB>(u) : u;
      } else {
        w[i] = code_word<W, K, R>(x, 4 * q + i);
      }
    }
    transpose4(w);
#pragma unroll
    for (int c = 0; c < 4; ++c) col[c][q] = w[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = 16 * ch + 4 * a + c;
    unsigned char* dst =
        bt + n * 128 + ((((d0 >> 4) ^ n) & 7) << 4) + (d0 & 15);
    if constexpr (Q == 4) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(col[c][0], col[c][1], col[c][2], col[c][3]);
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(col[c][0], col[c][1]);
    }
  }
}

// The k32 products of one K-step: acc[mi] (+)= rows (wgi * MI + mi) * 64
// .. + 63 of A . B^T, A in 128-byte rows.
template <int MI, int BN>
__device__ __forceinline__ void mma_step(int (&acc)[MI][BN / 2],
                                         const unsigned char* at,
                                         const unsigned char* bt, int wgi,
                                         bool first_zero) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      wg::mma<BN>(acc[mi],
                  wg::desc(at + (wgi * MI + mi) * 64 * 128 + 32 * kk),
                  wg::desc(bt + 32 * kk), (first_zero && kk == 0) ? 0 : 1);
    }
  }
  wg::commit();
}

// Finish and store a block's (128 MI) x BN tile from the accumulator
// registers (rows m0 .., columns n0 .. of the (M, N) row-major output).
// No load waits behind a branch or a store: the block first stages its
// BN columns' gamma, colsum, scale and shift in `scratch` (4 BN words of
// shared memory the products no longer use), then each thread loads the
// residual of G column pairs of all its rows at once (addresses clamped
// into the output, values past M or N unused) before it finishes those
// elements through epilogue_value and stores each pair together.  Under
// mpmm::ACC_ONLY each pair is stored as its two int32 accumulators.
template <int MI, int BN>
__device__ __forceinline__ void store_tile(const mpmm::Epilogue& e,
                                           const int (&acc)[MI][BN / 2],
                                           int m0, int n0, int M, int N,
                                           unsigned char* scratch) {
  constexpr int G = 8 / MI;  // column groups of 8 a residual batch
  float* s_gamma = reinterpret_cast<float*>(scratch);
  int* s_colsum = reinterpret_cast<int*>(s_gamma + BN);
  float* s_scale = reinterpret_cast<float*>(s_colsum + BN);
  float* s_shift = s_scale + BN;
  const bool bn = e.flags & mpmm::EPI_BN;
  const bool res = e.flags & mpmm::EPI_RESIDUAL;
  const bool res_bf16 = e.flags & mpmm::RES_BF16;
  const bool acc_only = e.flags & mpmm::ACC_ONLY;
  __syncthreads();  // every thread is past its last product
  for (int i = threadIdx.x; i < BN; i += THREADS) {
    const int n = min(n0 + i, N - 1);
    s_gamma[i] = acc_only ? 0.f : __ldg(e.gamma + n);
    s_colsum[i] = acc_only ? 0 : __ldg(e.colsum + n);
    s_scale[i] = bn ? __ldg(e.scale + n) : 0.f;
    s_shift[i] = bn ? __ldg(e.shift + n) : 0.f;
  }
  __syncthreads();
  const int wgi = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int rbase = m0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int cbase = 2 * (lane & 3);  // first column of j = 0 in the tile
  const bool pair_ok = (N % 2) == 0;  // pairs 4- or 8-byte aligned
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += G) {
    // element (mi, jj, i, c): row rbase + (wgi MI + mi) 64 + 8i, column
    // n0 + cbase + 8 (j0 + jj) + c; its index, clamped into the output
    auto at = [&](int mi, int jj, int i, int c) -> size_t {
      const int m = rbase + (wgi * MI + mi) * 64 + 8 * i;
      const int n = n0 + cbase + 8 * (j0 + jj) + c;
      return (m < M && n < N) ? static_cast<size_t>(m) * N + n : 0;
    };
    float r[MI][G][2][2] = {};
    if (res && res_bf16) {
      const auto* rp = static_cast<const __nv_bfloat16*>(e.residual);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              r[mi][jj][i][c] =
                  __bfloat162float(__ldg(rp + at(mi, jj, i, c)));
    } else if (res) {
      const auto* rp = static_cast<const float*>(e.residual);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              r[mi][jj][i][c] = __ldg(rp + at(mi, jj, i, c));
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int col = cbase + 8 * (j0 + jj);
      const int n = n0 + col;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = rbase + (wgi * MI + mi) * 64 + 8 * i;
          if (acc_only) {  // the raw int32 pair, no epilogue
            if (m >= M || n >= N) continue;
            const int v0 = acc[mi][4 * (j0 + jj) + 2 * i];
            const int v1 = acc[mi][4 * (j0 + jj) + 2 * i + 1];
            int* out = static_cast<int*>(e.out) +
                       static_cast<size_t>(m) * N + n;
            if (pair_ok) {
              *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
            } else {
              out[0] = v0;
              if (n + 1 < N) out[1] = v1;
            }
            continue;
          }
          float y[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            y[c] = epilogue_value(acc[mi][4 * (j0 + jj) + 2 * i + c],
                                  e.act_zero, s_colsum[col + c],
                                  s_gamma[col + c], e.flags, s_scale[col + c],
                                  s_shift[col + c], r[mi][jj][i][c]);
          }
          if (m >= M || n >= N) continue;
          const size_t idx = static_cast<size_t>(m) * N + n;
          if (e.flags & mpmm::OUT_BF16) {
            auto* out = static_cast<__nv_bfloat16*>(e.out) + idx;
            if (pair_ok) {
              *reinterpret_cast<__nv_bfloat162*>(out) =
                  __floats2bfloat162_rn(y[0], y[1]);
            } else {
              out[0] = __float2bfloat16_rn(y[0]);
              if (n + 1 < N) out[1] = __float2bfloat16_rn(y[1]);
            }
          } else {
            auto* out = static_cast<float*>(e.out) + idx;
            if (pair_ok) {
              *reinterpret_cast<float2*>(out) = make_float2(y[0], y[1]);
            } else {
              out[0] = y[0];
              if (n + 1 < N) out[1] = y[1];
            }
          }
        }
      }
    }
  }
}

}  // namespace tc

// Raise the dynamic shared-memory limit of KERNEL, then launch it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k1

// Instantiate KERNEL<W, K, ...> for every weight format (w and k in
// 1/2/4/8: the 16 formats, k > w among them) and launch it through
// k1::launch; an unsupported format returns cudaErrorInvalidValue without
// launching.  K1_FORMATS lists the formats, as CASE(W, K, LAUNCH) for each.
//
// The build names the word lengths whose formats a library holds, each
// as -DK1_BUILD_W<w>=0|1 (kernels/_build.py's FORMAT_PARTS, the one place
// the split is written: route A and K2 are built as two libraries, one
// per half of the formats, so that the halves compile in parallel).
#if !defined(K1_BUILD_W1) || !defined(K1_BUILD_W2) || \
    !defined(K1_BUILD_W4) || !defined(K1_BUILD_W8)
#error "define K1_BUILD_W1/2/4/8 (0 or 1): the word lengths to instantiate"
#endif
#define K1_FORMAT_CASE(W, K, LAUNCH) \
  case W * 16 + K: return LAUNCH(W, K);
#define K1_FORMATS_OF(W, CASE, LAUNCH)                                       \
  CASE(W, 1, LAUNCH) CASE(W, 2, LAUNCH) CASE(W, 4, LAUNCH) CASE(W, 8, LAUNCH)
#if K1_BUILD_W1
#define K1_FORMATS_W1(CASE, LAUNCH) K1_FORMATS_OF(1, CASE, LAUNCH)
#else
#define K1_FORMATS_W1(CASE, LAUNCH)
#endif
#if K1_BUILD_W2
#define K1_FORMATS_W2(CASE, LAUNCH) K1_FORMATS_OF(2, CASE, LAUNCH)
#else
#define K1_FORMATS_W2(CASE, LAUNCH)
#endif
#if K1_BUILD_W4
#define K1_FORMATS_W4(CASE, LAUNCH) K1_FORMATS_OF(4, CASE, LAUNCH)
#else
#define K1_FORMATS_W4(CASE, LAUNCH)
#endif
#if K1_BUILD_W8
#define K1_FORMATS_W8(CASE, LAUNCH) K1_FORMATS_OF(8, CASE, LAUNCH)
#else
#define K1_FORMATS_W8(CASE, LAUNCH)
#endif
#define K1_FORMATS(CASE, LAUNCH)                                             \
  K1_FORMATS_W1(CASE, LAUNCH) K1_FORMATS_W2(CASE, LAUNCH)                    \
  K1_FORMATS_W4(CASE, LAUNCH) K1_FORMATS_W8(CASE, LAUNCH)
#define K1_DISPATCH(w_bits, k_bits, LAUNCH)                                  \
  switch ((w_bits) * 16 + (k_bits)) {                                        \
    K1_FORMATS(K1_FORMAT_CASE, LAUNCH)                                       \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }
