// K1, route A: the mixed-precision matmul on int8 tensor cores, for M > 16
// (LM prefill projections, the ResNet stem as im2col), sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mpmm/kernel.py::mpmm_pallas
// (body _mpmm_kernel, decode _decode_block):
//
//   y[M, N] = epilogue(gamma * ((a_biased @ W_int) + act_zero * colsum))
//
// with a_biased int8 (M, K) and W_int decoded from uint8 planes (P, Kp, N).
// kernels/mpmm/kernel.py::mpmm_route sends M <= 16 to route B
// (mpmm_splitk.cu) instead.
//
// What bounds it on this card: at granite-8b's prefill (M = 4000, K 4096 or
// 14336) the product does 2*M*N*K int8 operations, against far fewer bytes,
// so the 1979 TOP/s int8 tensor-core peak is the bound; the weights are
// decoded from w/8 bytes a weight, which costs instructions, not bytes.
//
// What the design does about it:
// - Products: wgmma m64n128k32 s32.s8.s8, A (activations) and B (decoded
//   weights) both K-major in 128-byte-swizzled shared memory read through
//   descriptors; the int32 accumulators stay in registers.  A block owns a
//   256 x 128 output tile (two warpgroups of two 64-row products; 128 x 128
//   under Sum-Apart) and steps K by 128, one swizzle row of int8.  Its
//   loads from L2 bound it before its products do, so the tile is tall:
//   each weight byte loaded and decoded feeds two 64-row products.
// - Sum-Together costs one product a K-step whatever P is: the planes are
//   disjoint bit fields of the code, so the decode ORs them into the int8
//   weight (mpmm_bits.cuh) and writes it, transposed to K-major, into the
//   swizzled B tile.  Sum-Apart runs one product a K-step per plane on the
//   digit tiles; P accumulators of 64 registers would not fit, so each
//   plane's product is shift-added into the accumulator after its K-step
//   (the same integers as adding them in the epilogue).
// - Copies: a four-stage cp.async ring carries the activation tile and the
//   packed bytes of every plane (16 bytes a transaction; byte loads where K
//   or N is not a multiple of 16).  The packed bytes are stored with their
//   16-byte chunks XOR-swizzled by the digit block a thread decodes, so
//   both the decode's reads and its 16-byte writes of B are free of bank
//   conflicts.
// - Overlap (Sum-Together): stage s+1 is decoded into the second B tile
//   while the products of stage s run.
// - Grid: M tiles fastest, so the blocks that share an N strip of packed
//   weights run together and find it in L2 (the TPU kernel's digit cache).
//   A grouped call (an MoE expert bank, which the reference batches over
//   the expert axis with jax.vmap) adds the group as the grid's z: each
//   block offsets its activations, planes and epilogue operands by its
//   group, so one launch covers the whole bank.
// - Ragged M/N/K are zero-filled in shared memory and masked in the
//   epilogue; nothing is read out of bounds.
// - Epilogue: on the int32 accumulators in registers, mpmm_common.cuh's
//   epilogue_store op for op (epilogue_value, the op order and rounding of
//   kernels/mpmm/epilogue.py), with the tile's column operands staged in
//   shared memory, the residual loaded in batches that wait on no branch
//   or store, and two columns stored together (mpmm_bits.cuh store_tile).
//   With the ACC_ONLY flag the pairs are the raw int32 accumulators (a
//   tensor-parallel row shard, summed across ranks before the epilogue).
#include "mpmm_bits.cuh"

namespace {

using mpmm::Epilogue;
using namespace k1;

// A block owns a BM x BN output tile, BM = 128 * MI: each of its two
// warpgroups owns MI products of 64 rows (MI = 2 under Sum-Together, 1
// under Sum-Apart, whose per-plane products need a second accumulator).
constexpr int BN = 128;
constexpr int BK = tc::BK;
constexpr int THREADS = tc::THREADS;
constexpr int STAGES = 4;
constexpr int TILE_BYTES = 128 * 128;  // 128 rows of BK int8, 16 KB

template <int MI>
struct Smem {
  static constexpr int BM = 128 * MI;
  static constexpr int A_BYTES = MI * TILE_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + TILE_BYTES;  // + packed bytes
  static constexpr size_t BYTES = STAGES * STAGE_BYTES + 2 * TILE_BYTES;
};

// Load K-step t (digits t*BK ..) into ring slot `st`: the activation tile
// (BM rows of BK codes) into the swizzled A layout, and BK/f packed rows of
// every plane (BN columns).
template <int W, int K, int MI>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const int8_t* __restrict__ a,
                                           const uint8_t* __restrict__ planes,
                                           int M, int N, int Kd, int kp,
                                           int m0, int n0, int t, bool vec) {
  using Fm = Format<W, K>;
  constexpr int RR = BK / Fm::F;  // packed rows of a plane a K-step
  constexpr int BM = Smem<MI>::BM;
  unsigned char* at = st;
  unsigned char* raw = st + Smem<MI>::A_BYTES;
  const int k0 = t * BK;
  const int kb0 = t * RR;
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < BM * 8; i += THREADS) {
      const int r = i >> 3, c = i & 7;
      const int gm = m0 + r, gk = k0 + 16 * c;
      const bool ok = gm < M && gk < Kd;
      cp_async16(at + r * 128 + (((c ^ r) & 7) << 4),
                 ok ? a + static_cast<size_t>(gm) * Kd + gk : a, ok);
    }
#pragma unroll
    for (int i = threadIdx.x; i < Fm::P * RR * 8; i += THREADS) {
      const int c = i & 7, row = i >> 3;
      const int p = row / RR, kb = row % RR;
      const int gb = kb0 + kb, gn = n0 + 16 * c;
      const bool ok = gb < kp && gn < N;
      cp_async16(raw + tc::raw_off<K, BN>(row, kb, c),
                 ok ? planes + (static_cast<size_t>(p) * kp + gb) * N + gn
                    : planes,
                 ok);
    }
  } else {  // K or N not a multiple of 16: byte loads, zero-filled
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      at[wg::swz(r, kk)] =
          (gm < M && gk < Kd) ? a[static_cast<size_t>(gm) * Kd + gk] : 0;
    }
    for (int i = threadIdx.x; i < Fm::P * RR * BN; i += THREADS) {
      const int n = i % BN, row = i / BN;
      const int p = row / RR, kb = row % RR;
      const int gb = kb0 + kb, gn = n0 + n;
      raw[tc::raw_off<K, BN>(row, kb, n >> 4) + (n & 15)] =
          (gb < kp && gn < N)
              ? planes[(static_cast<size_t>(p) * kp + gb) * N + gn]
              : 0;
    }
  }
}

template <int W, int K, bool SA>
__global__ void __launch_bounds__(THREADS, 1)
    mpmm_wgmma_kernel(const int8_t* __restrict__ a_all,
                      const uint8_t* __restrict__ planes_all, int M, int N,
                      int Kd, int kp, int vec, Epilogue e_all) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using Fm = Format<W, K>;
  constexpr int MI = SA ? 1 : 2;
  using S = Smem<MI>;
  constexpr int A_BYTES = S::A_BYTES;
  // Group (expert) blockIdx.z: its own activations, planes and epilogue.
  const int grp = blockIdx.z;
  const int8_t* __restrict__ a = a_all + static_cast<size_t>(grp) * M * Kd;
  const uint8_t* __restrict__ planes =
      planes_all + static_cast<size_t>(grp) * Fm::P * kp * N;
  const Epilogue e = mpmm::group_epilogue(e_all, grp, M, N);
  const int m0 = blockIdx.x * S::BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (Kd + BK - 1) / BK;
  const int wgi = threadIdx.x >> 7;
  unsigned char* btile = smem + STAGES * S::STAGE_BYTES;
  auto slot = [&](int t) { return smem + (t % STAGES) * S::STAGE_BYTES; };
  auto load = [&](int t) {
    if (t < nk) {
      load_stage<W, K, MI>(slot(t), a, planes, M, N, Kd, kp, m0, n0, t,
                           vec != 0);
    }
    cp_commit();
  };

  int acc[MI][64];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mi][i] = 0;
  }

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load(t);

  if constexpr (!SA) {
    cp_wait<STAGES - 2>();
    wg::fence_proxy();
    __syncthreads();
    tc::decode_stage<W, K, false, BN>(slot(0) + A_BYTES, btile, 0);
    wg::fence_proxy();
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
      tc::mma_step<MI, BN>(acc, slot(t), btile + (t & 1) * TILE_BYTES, wgi,
                           false);
      load(t + STAGES - 1);
      if (t + 1 < nk) {
        cp_wait<STAGES - 2>();
        wg::fence_proxy();
        __syncthreads();
        tc::decode_stage<W, K, false, BN>(
            slot(t + 1) + A_BYTES, btile + ((t + 1) & 1) * TILE_BYTES, 0);
        wg::fence_proxy();
      }
      wg::wait0();
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) wg::pin(acc[mi]);
      __syncthreads();
    }
  } else {
    int tmp[1][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tmp[0][i] = 0;
    for (int t = 0; t < nk; ++t) {
      load(t + STAGES - 1);
      cp_wait<STAGES - 1>();
      wg::fence_proxy();
      __syncthreads();
#pragma unroll
      for (int p = 0; p < Fm::P; ++p) {
        tc::decode_stage<W, K, true, BN>(slot(t) + A_BYTES, btile, p);
        wg::fence_proxy();
        __syncthreads();
        tc::mma_step<1, BN>(tmp, slot(t), btile, wgi, true);
        wg::wait0();
        wg::pin(tmp[0]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += tmp[0][i] * (1 << (K * p));
        __syncthreads();
      }
    }
  }
  cp_wait<0>();

  tc::store_tile<MI, BN>(e, acc, m0, n0, M, N, smem);
}

}  // namespace

// Plain C entry point, loaded with ctypes (kernels/mpmm/kernel.py).  Runs
// `groups` products of the same shape in one launch, their operands stored
// one after the other (a (groups, M, Kd), planes (groups, P, kp, N), gamma
// and colsum (groups, N), out (groups, M, N)).  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int mpmm_launch(const void* a, const void* planes,
                           const void* gamma, const void* colsum,
                           const void* scale, const void* shift,
                           const void* residual, void* out, int M, int N,
                           int Kd, int kp, int n_planes, int k_bits,
                           int w_bits, int act_zero, int sa, int flags,
                           int groups, void* stream) {
  const Epilogue e{static_cast<const float*>(gamma),
                   static_cast<const int*>(colsum),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(shift),
                   residual, out, act_zero, flags};
  if (n_planes != planes_of(w_bits, k_bits) || groups < 1 ||
      groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = (Kd % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 16 == 0);
  const int bm = sa ? Smem<1>::BM : Smem<2>::BM;
  const dim3 grid((M + bm - 1) / bm, (N + BN - 1) / BN, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* p8 = static_cast<const uint8_t*>(planes);
#define K1_WGMMA_LAUNCH(W, K)                                                \
  (sa ? launch(mpmm_wgmma_kernel<W, K, true>, Smem<1>::BYTES, grid,         \
               THREADS, s, a8, p8, M, N, Kd, kp, vec, e)                     \
      : launch(mpmm_wgmma_kernel<W, K, false>, Smem<2>::BYTES, grid,        \
               THREADS, s, a8, p8, M, N, Kd, kp, vec, e))
  K1_DISPATCH(w_bits, k_bits, K1_WGMMA_LAUNCH)
#undef K1_WGMMA_LAUNCH
}
