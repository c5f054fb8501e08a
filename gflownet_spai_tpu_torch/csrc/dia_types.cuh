// The element types of the DIA kernels (csrc/dia.cu, csrc/dia_spmm.cu).
//
// Diagonals are stored in float32 or bf16; the vectors and buffers of one
// call share one type, float32 or bf16, which is also the output's (the
// type promotion of the two: a float32 vector with bf16 diagonals gives a
// float32 result, a bf16 one a bf16 result; the wrapper converts a bf16
// vector to float32 before a call on float32 diagonals).  Every
// multiply-add runs in float32: a bf16 value is widened exactly in a
// register where it is read (`to_f`), and each result is rounded once,
// to nearest even, where it is stored (`from_f`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dia_types {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// The (diagonal, vector) element types of a call, by the code the C
// entry points take: 0 (float32, float32), 1 (bf16, float32), 2 (bf16, bf16).
template <typename D, typename V>
struct Types {
  using Data = D;
  using Vec = V;
};

template <typename F>
cudaError_t with_types(int types, F f) {
  switch (types) {
    case 0: return f(Types<float, float>{});
    case 1: return f(Types<bf16, float>{});
    case 2: return f(Types<bf16, bf16>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dia_types
