// Value types of the port's kernels: each storage type T has an
// arithmetic type (`Acc<T>::type`) that products and sums are formed in,
// `widen` reads a stored value into it and `narrow<T>` stores a result.
// float and double are their own arithmetic type.  bf16 is formed in f32
// and rounded once, to nearest even, on store: the rounding torch applies
// to a bf16 product (`a * b` computes in float, then rounds) and to a
// `.to(torch.bfloat16)`, so a bf16 kernel and its plain PyTorch version
// agree bitwise wherever they form the same f32 value.

#pragma once

#include <cuda_bf16.h>

namespace sblas {

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A>
__device__ __forceinline__ T narrow(A v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace sblas
