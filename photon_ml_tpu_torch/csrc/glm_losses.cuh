// Pointwise GLM losses for the CUDA kernels: l(z, y), dl/dz and d2l/dz2.
//
// The loss codes match PointwiseLoss.code in photon_ml_tpu_torch/core/losses.py:
//   0 logistic        l = log(1 + exp(z)) - y z        labels in {0, 1}
//   1 squared         l = (z - y)^2 / 2
//   2 poisson         l = exp(z) - y z
//   3 smoothed hinge  Rennie's smoothed hinge, s = +1 if y >= 0.5 else -1,
//                     t = s z; l = 0 (t >= 1), 1/2 - t (t <= 0), (1 - t)^2 / 2
//                     otherwise; d2 = 1 strictly inside (0, 1), else 0.
#pragma once

#include <cuda_runtime.h>

namespace photon {

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_log1p(float v) { return log1pf(v); }
__device__ __forceinline__ double dev_log1p(double v) { return log1p(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

template <typename T>
__device__ __forceinline__ T sigmoid(T z) {
  return T(1) / (T(1) + dev_exp(-z));
}

template <int LOSS, typename T>
__device__ __forceinline__ void loss_and_d1(T z, T y, T& l, T& d1) {
  if constexpr (LOSS == 0) {
    // stable log(1 + exp(z)) = max(z, 0) + log1p(exp(-|z|))
    T az = z < T(0) ? -z : z;
    T lp = (z > T(0) ? z : T(0)) + dev_log1p(dev_exp(-az));
    l = lp - y * z;
    d1 = sigmoid(z) - y;
  } else if constexpr (LOSS == 1) {
    T r = z - y;
    l = T(0.5) * r * r;
    d1 = r;
  } else if constexpr (LOSS == 2) {
    T e = dev_exp(z);
    l = e - y * z;
    d1 = e - y;
  } else {
    T s = y >= T(0.5) ? T(1) : T(-1);
    T t = s * z;
    if (t >= T(1)) {
      l = T(0);
      d1 = T(0);
    } else if (t <= T(0)) {
      l = T(0.5) - t;
      d1 = -s;
    } else {
      T u = T(1) - t;
      l = T(0.5) * u * u;
      d1 = s * (t - T(1));
    }
  }
}

template <int LOSS, typename T>
__device__ __forceinline__ T d2(T z, T y) {
  if constexpr (LOSS == 0) {
    T s = sigmoid(z);
    return s * (T(1) - s);
  } else if constexpr (LOSS == 1) {
    return T(1);
  } else if constexpr (LOSS == 2) {
    return dev_exp(z);
  } else {
    T s = y >= T(0.5) ? T(1) : T(-1);
    T t = s * z;
    return (t > T(0) && t < T(1)) ? T(1) : T(0);
  }
}

}  // namespace photon
