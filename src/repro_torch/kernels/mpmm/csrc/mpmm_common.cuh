// The fused f32 epilogue of the mixed-precision kernels: its flag bits,
// its operands, and epilogue_store, the op order every kernel follows (K1's
// route B, mpmm_splitk.cu, stores through it; K1's route A and K2 apply the
// same ops through mpmm_bits.cuh's epilogue_value).  ACC_ONLY stores the raw
// int32 accumulator instead, with no zero point, dequant or post-op: a
// tensor-parallel row shard's partial product, which the caller sums across
// ranks before the epilogue (gamma and colsum are then not read and may be
// null).
//
// Storage format (repro_torch/core/packing.py): a w-bit signed weight code
// is split into P = ceil(w/k) k-bit digit planes, lower planes unsigned, the
// top plane a (w - k*(P-1))-bit two's-complement field.  Planes are stored
// uint8 (P, ceil(K/f), N) with f = 8/k digits per byte along K, field index
// minor within a byte: digit (p, kk, n) sits at bits [k*(kk%f), k*(kk%f)+k)
// of byte (p, kk/f, n).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mpmm {

// Epilogue flags (kernels/mpmm/kernel.py builds the same bits).
enum : int {
  EPI_BN = 1,
  EPI_RESIDUAL = 2,
  EPI_RELU = 4,
  RES_BF16 = 8,
  OUT_BF16 = 16,
  ACC_ONLY = 32,  // out is int32 (M, N): the accumulator, nothing else
};

struct Epilogue {
  const float* gamma;     // (N,) gamma_a * gamma_w
  const int* colsum;      // (N,) column sums of the integer weight codes
  const float* scale;     // (N,) folded BN scale, when EPI_BN
  const float* shift;     // (N,) folded BN shift, when EPI_BN
  const void* residual;   // (M, N) f32 or bf16, when EPI_RESIDUAL
  void* out;              // (M, N) f32 or bf16
  int act_zero;
  int flags;
};

// The epilogue of group g of a grouped call (an expert bank: E products of
// M x K by K x N, one launch): each per-column operand holds E rows of N
// values, the residual and the output E matrices of M x N, one after the
// other.  Group 0 is the call's own operands.
__device__ __forceinline__ Epilogue group_epilogue(const Epilogue& e, int g,
                                                   int M, int N) {
  Epilogue r = e;
  const size_t col = static_cast<size_t>(g) * N;
  const size_t mat = col * M;
  if (r.gamma != nullptr) r.gamma += col;
  if (r.colsum != nullptr) r.colsum += col;
  if (r.scale != nullptr) r.scale += col;
  if (r.shift != nullptr) r.shift += col;
  if (r.residual != nullptr) {
    r.residual = static_cast<const char*>(r.residual) +
                 mat * ((e.flags & RES_BF16) ? 2 : 4);
  }
  r.out = static_cast<char*>(r.out) + mat * ((e.flags & OUT_BF16) ? 2 : 4);
  return r;
}

// zero-point correction -> dequant -> BN -> residual -> ReLU -> cast, in the
// op order of kernels/mpmm/epilogue.py.  Each step rounds once: __fmul_rn
// and __fadd_rn are never contracted, and BN is one fused multiply-add,
// as XLA contracts y * scale + shift.  Under ACC_ONLY the int32 itself.
__device__ __forceinline__ void epilogue_store(const Epilogue& e, int acc,
                                               int n, size_t idx) {
  if (e.flags & ACC_ONLY) {
    static_cast<int*>(e.out)[idx] = acc;
    return;
  }
  const int corrected = acc + e.act_zero * e.colsum[n];
  float y = __fmul_rn(__int2float_rn(corrected), e.gamma[n]);
  if (e.flags & EPI_BN) y = __fmaf_rn(y, e.scale[n], e.shift[n]);
  if (e.flags & EPI_RESIDUAL) {
    const float r =
        (e.flags & RES_BF16)
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.residual)[idx])
            : static_cast<const float*>(e.residual)[idx];
    y = __fadd_rn(y, r);
  }
  if (e.flags & EPI_RELU) y = fmaxf(y, 0.0f);
  if (e.flags & OUT_BF16) {
    static_cast<__nv_bfloat16*>(e.out)[idx] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(e.out)[idx] = y;
  }
}

}  // namespace mpmm
