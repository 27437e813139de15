// K1, route B: the mixed-precision matmul for M <= 16 (LM decode
// projections, the LM head, the ResNet classifier), split along K, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mpmm/kernel.py::mpmm_pallas
// at the shapes where M, the batch, is a handful of rows:
//
//   y[M, N] = epilogue(gamma * ((a_biased @ W_int) + act_zero * colsum))
//
// kernels/mpmm/kernel.py::mpmm_route sends M > 16 to route A
// (mpmm_wgmma.cu) instead.
//
// What bounds it on this card: at M = 4 the product does 8 operations a
// weight and reads w/8 bytes a weight, so the packed planes' bytes over
// 3.35 TB/s are the bound (granite-8b's decode step: 2.21 ms of them).
//
// What the design does about it:
// - Work split: a block owns an N strip (512 columns, 256 at M > 4) and
//   one chunk of K; kernel.py::split_plan cuts K into byte-aligned chunks so
//   that the grid fills the 132 SMs several times over even at N = 4096.
//   A grouped call (an MoE expert bank: E products in one launch, as the
//   reference's jax.vmap batches its kernel) adds the group as the grid's
//   z, and split_plan counts its blocks over all groups.
//   Within a block the eight warps take the chunk's digit groups in turn.
// - Loads: each thread streams 16 (8 at M > 4) neighbouring columns of
//   each plane row with one vector load -- N is the planes' minor axis, so
//   a warp reads 512 (256) contiguous bytes -- and loads the next group
//   before it computes on the current one.  The chunk's activation rows are
//   staged in shared memory and read as broadcast words.
// - Decode in registers with route A's bit assembly (mpmm_bits.cuh): one
//   code word per digit and four columns, then a byte transpose into the
//   K-contiguous words that __dp4a takes.
// - Products: __dp4a with int32 accumulation.  mma.sync.m16n8k32 would pad
//   the 4 rows of a decode step to 16, wasting three quarters of its work,
//   and would need the decoded weights moved into its fragment layout
//   through shared memory or shuffles; at this byte bound the CUDA cores'
//   dp4a keep up and the weights stay in the thread that loaded them.
// - Reduction: a block adds its eight warps' sums in shared memory and
//   writes one int32 partial per (split, row, column) to a workspace the
//   wrapper allocates; a second kernel adds the partials in split order (a
//   fixed order, exact in integers) and runs mpmm_common.cuh's
//   epilogue_store, the op order and rounding of kernels/mpmm/epilogue.py.
#include "mpmm_bits.cuh"

namespace {

using mpmm::Epilogue;
using mpmm::epilogue_store;
using namespace k1;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK_DIGITS = 2048;  // kernel.py SPLITK_MAX_CHUNK_DIGITS

// Digits a thread handles at a time: 4 (one dp4a word), 8 for k = 1 (one
// packed byte holds 8 digits).
template <int K>
struct Group {
  static constexpr int F = 8 / K;
  static constexpr int G = F > 4 ? F : 4;  // digits
  static constexpr int ROWS = G / F;       // packed rows of a plane
};

// CT bytes (columns) of one plane row into words, zero past the row's end
// or N.
template <int CT>
__device__ __forceinline__ void load_row(uint32_t (&w)[CT / 4],
                                         const uint8_t* __restrict__ src,
                                         bool row_ok, int cols_left,
                                         bool vec) {
  if (row_ok && vec && cols_left >= CT) {
    if constexpr (CT == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = v.x; w[1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < CT / 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * q + c;
      if (row_ok && col < cols_left) {
        word |= static_cast<uint32_t>(__ldg(src + col)) << (8 * c);
      }
    }
    w[q] = word;
  }
}

template <int W, int K, int MT, int CT, bool SA>
__global__ void __launch_bounds__(THREADS)
    mpmm_splitk_kernel(const int8_t* __restrict__ a_all,
                       const uint8_t* __restrict__ planes_all,
                       int* __restrict__ ws_all, int M, int N, int Kd,
                       int kp, int chunk_bytes, int vec) {
  using Fm = Format<W, K>;
  using Gr = Group<K>;
  constexpr int P = Fm::P;
  constexpr int STRIP = 32 * CT;
  constexpr int QW = CT / 4;  // words (column quads) a thread holds a row
  // The chunk's activation rows; after the K loop the same bytes hold the
  // block's sums, a row of CT + 1 words per lane (conflict-free atomics).
  constexpr int A_BYTES = MT * MAX_CHUNK_DIGITS;
  constexpr int RED_BYTES = MT * 32 * (CT + 1) * 4;
  __shared__ __align__(16)
      unsigned char smem[A_BYTES > RED_BYTES ? A_BYTES : RED_BYTES];
  auto a_s = reinterpret_cast<int8_t(*)[MAX_CHUNK_DIGITS]>(smem);
  auto red = reinterpret_cast<int(*)[32][CT + 1]>(smem);

  // Group (expert) blockIdx.z: its own activations, planes and partials.
  const int grp = blockIdx.z;
  const int8_t* __restrict__ a = a_all + static_cast<size_t>(grp) * M * Kd;
  const uint8_t* __restrict__ planes =
      planes_all + static_cast<size_t>(grp) * P * kp * N;
  int* __restrict__ ws =
      ws_all + static_cast<size_t>(grp) * gridDim.y * M * N;
  const int split = blockIdx.y;
  const int n_strip = blockIdx.x * STRIP;
  const int cb0 = split * chunk_bytes;
  const int cb1 = min(cb0 + chunk_bytes, kp);
  const int k0 = cb0 * Fm::F;
  const int nd = (cb1 - cb0) * Fm::F;  // digits of the chunk (<= K - k0 + pad)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Stage the chunk's activation rows (zero past K and past the chunk).
  for (int i = threadIdx.x; i < MT * nd; i += THREADS) {
    const int m = i / nd, kk = i % nd;
    const int gk = k0 + kk;
    a_s[m][kk] = (m < M && gk < Kd) ? a[static_cast<size_t>(m) * Kd + gk] : 0;
  }
  __syncthreads();

  const int col0 = n_strip + lane * CT;
  const int cols_left = N - col0;
  const int ngroups = (cb1 - cb0 + Gr::ROWS - 1) / Gr::ROWS;
  int acc[MT][CT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[m][c] = 0;
  }

  auto load_group = [&](uint32_t (&x)[P][Gr::ROWS][QW], int g) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int r = 0; r < Gr::ROWS; ++r) {
        const int gb = cb0 + g * Gr::ROWS + r;
        const bool ok = gb < cb1;
        load_row<CT>(x[p][r],
                     planes + (static_cast<size_t>(p) * kp + (ok ? gb : 0)) * N +
                         (cols_left > 0 ? col0 : 0),
                     ok && cols_left > 0, cols_left, vec != 0);
      }
    }
  };

  uint32_t x[P][Gr::ROWS][QW];
  int g = warp;
  if (g < ngroups) load_group(x, g);
  for (; g < ngroups; g += WARPS) {
    uint32_t nx[P][Gr::ROWS][QW];
    if (g + WARPS < ngroups) load_group(nx, g + WARPS);
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      uint32_t xq[P][Gr::ROWS];  // this column quad's row words
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int r = 0; r < Gr::ROWS; ++r) xq[p][r] = x[p][r][q];
      }
#pragma unroll
      for (int d4 = 0; d4 < Gr::G / 4; ++d4) {
        const int kk = g * Gr::G + 4 * d4;  // digit offset in the chunk
        int av[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          av[m] = *reinterpret_cast<const int*>(&a_s[m][kk]);
        }
        if constexpr (!SA) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = code_word<W, K, Gr::ROWS>(xq, 4 * d4 + i);
          }
          transpose4(w);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int m = 0; m < MT; ++m) {  // rows past M are zero codes
              acc[m][4 * q + c] =
                  __dp4a(static_cast<int>(w[c]), av[m], acc[m][4 * q + c]);
            }
          }
        } else {  // one product per plane, shifted into the accumulator
#pragma unroll
          for (int p = 0; p < P; ++p) {
            uint32_t w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              w[i] = digit_word<W, K, Gr::ROWS>(xq, p, 4 * d4 + i);
            }
            transpose4(w);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                acc[m][4 * q + c] +=
                    __dp4a(static_cast<int>(w[c]), av[m], 0) * (1 << (K * p));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int r = 0; r < Gr::ROWS; ++r) {
#pragma unroll
        for (int q = 0; q < QW; ++q) x[p][r][q] = nx[p][r][q];
      }
    }
  }

  // The eight warps' sums, then one partial per (split, row, column).
  __syncthreads();  // every warp is done with the activation rows
  for (int i = threadIdx.x; i < RED_BYTES / 4; i += THREADS) {
    reinterpret_cast<int*>(smem)[i] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) atomicAdd(&red[m][lane][c], acc[m][c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * STRIP; i += THREADS) {
    const int m = i / STRIP, nl = i % STRIP, n = n_strip + nl;
    if (n < N) {
      ws[(static_cast<size_t>(split) * M + m) * N + n] = red[m][nl / CT][nl % CT];
    }
  }
}

// y = epilogue(sum over splits of the partials, in split order), for every
// (group, row, column); under ACC_ONLY the int32 sum itself.
__global__ void __launch_bounds__(THREADS)
    mpmm_splitk_epilogue(const int* __restrict__ ws, int M, int N, int splits,
                         int groups, Epilogue e) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (idx >= mn * groups) return;
  const int g = static_cast<int>(idx / mn);
  const size_t at = idx % mn;
  const int* part = ws + static_cast<size_t>(g) * splits * mn + at;
  int total = 0;
  for (int s = 0; s < splits; ++s) total += part[s * mn];
  epilogue_store(mpmm::group_epilogue(e, g, M, N), total,
                 static_cast<int>(at % N), at);
}

template <int W, int K, int MT, int CT>
int launch_splitk(bool sa, dim3 grid, cudaStream_t s, const int8_t* a,
                  const uint8_t* p, int* ws, int M, int N, int Kd, int kp,
                  int chunk_bytes, int vec) {
  return sa ? launch(mpmm_splitk_kernel<W, K, MT, CT, true>, 0, grid, THREADS,
                     s, a, p, ws, M, N, Kd, kp, chunk_bytes, vec)
            : launch(mpmm_splitk_kernel<W, K, MT, CT, false>, 0, grid, THREADS,
                     s, a, p, ws, M, N, Kd, kp, chunk_bytes, vec);
}

}  // namespace

// Plain C entry point, loaded with ctypes (kernels/mpmm/kernel.py).  Runs
// `groups` products of the same shape in one call, their operands stored
// one after the other (a (groups, M, Kd), planes (groups, P, kp, N), gamma
// and colsum (groups, N), out (groups, M, N)); `ws` holds groups * splits *
// M * N int32 partials; chunk_bytes and splits come from
// kernel.py::split_plan.  Launches both kernels on `stream` and returns the
// first nonzero cudaGetLastError() (0 on success).
extern "C" int mpmm_splitk_launch(const void* a, const void* planes,
                                  const void* gamma, const void* colsum,
                                  const void* scale, const void* shift,
                                  const void* residual, void* out, void* ws,
                                  int M, int N, int Kd, int kp, int n_planes,
                                  int k_bits, int w_bits, int act_zero, int sa,
                                  int flags, int chunk_bytes, int splits,
                                  int groups, void* stream) {
  const Epilogue e{static_cast<const float*>(gamma),
                   static_cast<const int*>(colsum),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(shift),
                   residual, out, act_zero, flags};
  const int group_rows = k_bits == 8 ? 4 : k_bits == 4 ? 2 : 1;
  if (n_planes != planes_of(w_bits, k_bits) || M < 1 || M > 16 ||
      chunk_bytes < 1 || chunk_bytes % group_rows != 0 ||
      chunk_bytes * (8 / k_bits) > MAX_CHUNK_DIGITS ||
      static_cast<long long>(splits - 1) * chunk_bytes >= kp ||
      static_cast<long long>(splits) * chunk_bytes < kp || groups < 1 ||
      groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = M <= 4;  // 4 rows x 16 columns, else 16 x 8
  const int strip = wide ? 512 : 256;
  const int vec = (N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 16 == 0);
  const dim3 grid((N + strip - 1) / strip, splits, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* p8 = static_cast<const uint8_t*>(planes);
  int* wsi = static_cast<int*>(ws);
#define K1_SPLITK_LAUNCH(W, K)                                               \
  (wide ? launch_splitk<W, K, 4, 16>(sa != 0, grid, s, a8, p8, wsi, M, N,    \
                                     Kd, kp, chunk_bytes, vec)               \
        : launch_splitk<W, K, 16, 8>(sa != 0, grid, s, a8, p8, wsi, M, N,    \
                                     Kd, kp, chunk_bytes, vec))
  int err = [&]() -> int { K1_DISPATCH(w_bits, k_bits, K1_SPLITK_LAUNCH) }();
#undef K1_SPLITK_LAUNCH
  if (err != 0) return err;
  const size_t total = static_cast<size_t>(M) * N * groups;
  const dim3 egrid(static_cast<unsigned>((total + THREADS - 1) / THREADS));
  mpmm_splitk_epilogue<<<egrid, THREADS, 0, s>>>(wsi, M, N, splits, groups,
                                                 e);
  return static_cast<int>(cudaGetLastError());
}
