// Storage-width elements for the CUDA kernels: a design held at a narrower
// float than the solver (bf16 or f16 against float32 or float64, float32
// against float64) is widened element by element as it is read, and a value
// that the reference rounds to the storage width (``r.astype(x.dtype)``) is
// rounded to nearest even and widened back, as the reference's casts round
// (core/batch.py ``narrow``).  Widening is exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace photon {

// An element of storage type XT at accumulation type T.
template <typename T>
__device__ __forceinline__ T widen(float v) { return T(v); }
template <typename T>
__device__ __forceinline__ T widen(double v) { return T(v); }
template <typename T>
__device__ __forceinline__ T widen(__nv_bfloat16 v) { return T(__bfloat162float(v)); }
template <typename T>
__device__ __forceinline__ T widen(__half v) { return T(__half2float(v)); }

// v rounded to storage type XT, at its own type T.
template <typename XT>
struct Round;
template <>
struct Round<float> {
  template <typename T>
  __device__ __forceinline__ static T to(T v) { return T(float(v)); }
};
template <>
struct Round<double> {
  __device__ __forceinline__ static double to(double v) { return v; }
};
template <>
struct Round<__nv_bfloat16> {
  __device__ __forceinline__ static float to(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // through float32, as XLA and ml_dtypes cast float64 to bf16
  __device__ __forceinline__ static double to(double v) {
    return double(__bfloat162float(__float2bfloat16_rn(float(v))));
  }
};
template <>
struct Round<__half> {
  __device__ __forceinline__ static float to(float v) {
    return __half2float(__float2half_rn(v));
  }
  // once, as XLA casts float64 to f16
  __device__ __forceinline__ static double to(double v) {
    return double(__half2float(__double2half(v)));
  }
};

// Element type codes of the C interfaces (ops/fused_glm.py DTYPE_CODE).
enum DtypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

}  // namespace photon
