// newton_step: the per-lane Newton step of the structure-of-arrays solver.
//
// Replaces the TPU kernel _newton_step_kernel (photon_ml_tpu/ops/soa_newton.py,
// newton_step).  Per lane l, on lanes-last state: margins over the cap rows,
// q = wt * l''(z, y), the Hessian lower triangle sum_c x_i x_j q plus l2 on the
// diagonal, jitter = eps * (max |diag| + 1), an unrolled Cholesky with the
// sqrt(max(s, jitter)) floor, then forward and back substitution; the output
// is the [d, L] step (H + jitter I)^-1 g.  The op order follows
// photon_ml_tpu/opt/newton_soa.py (_hess, _cholesky_solve_soa).
//
// Storage width: x may be held at a narrower float XT than the solver type T
// of w, g, y, off, wt and l2 (bf16 or f16 against float32 or float64,
// float32 against float64); each element is widened as it is read
// (storage.cuh), and w is not rounded, as the TPU kernel computes at
// promote(x, w).
//
// Bound on an H100: bytes.  Each lane reads cap * d elements of x and
// 3 * cap values of T once, and does
// O(cap d^2 + d^3) flops on them in registers; at glmix_chip's d = 4, cap = 32
// that is ~10 flops per byte against the FP32 ridge of ~20, so HBM bandwidth
// is the floor.  Design: one thread per lane, templated on D (1..16) so the
// D(D+1)/2 triangle, the factor (stored in place) and both solves stay in
// registers; lanes-last [cap, d, L] storage makes neighbouring threads read
// neighbouring addresses, so every load is coalesced without staging, and the
// [cap, d, L] x*q product of the XLA path never exists.  At D = 16 the 136
// triangle values exceed what the register file keeps per thread and spill
// (the build prints ptxas's count).  Any L is taken; the TPU kernel needed
// L % 128 == 0.
//
// Plain C interface for ctypes: returns the CUDA error of the launch (0 on
// success) or -1 for arguments it does not take.

#include <cstdint>
#include <cuda_runtime.h>

#include "glm_losses.cuh"
#include "storage.cuh"

namespace {

using photon::widen;

constexpr int kThreads = 128;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <typename T>
__device__ __forceinline__ T dev_abs(T v) { return v < T(0) ? -v : v; }
template <typename T>
__device__ __forceinline__ T dev_max(T a, T b) { return a > b ? a : b; }

template <typename T, typename XT, int D, int LOSS>
__global__ void __launch_bounds__(kThreads)
newton_step_kernel(const T* __restrict__ w, const T* __restrict__ g,
                   const XT* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ off, const T* __restrict__ wt,
                   const T* __restrict__ l2, int cap, int64_t L, T eps,
                   T* __restrict__ out) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  constexpr int NT = D * (D + 1) / 2;

  T wl[D];
#pragma unroll
  for (int i = 0; i < D; ++i) wl[i] = w[i * L + l];

  T h[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) h[k] = T(0);

  for (int c = 0; c < cap; ++c) {
    T xv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) xv[i] = widen<T>(x[((int64_t)c * D + i) * L + l]);
    T z = xv[0] * wl[0];
#pragma unroll
    for (int i = 1; i < D; ++i) z += xv[i] * wl[i];
    const int64_t cl = (int64_t)c * L + l;
    z += off[cl];
    const T q = wt[cl] * photon::d2<LOSS>(z, y[cl]);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const T xq = xv[i] * q;
#pragma unroll
      for (int j = 0; j <= i; ++j) h[tri(i, j)] += xq * xv[j];
    }
  }

  const T l2v = l2[l];
  T dmax = T(0);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    h[tri(i, i)] += l2v;
    dmax = dev_max(dmax, dev_abs(h[tri(i, i)]));
  }
  const T jitter = eps * (dmax + T(1));

  // Cholesky in place: h[tri(j, i)] becomes L[j][i]
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = h[tri(i, i)] + jitter;
#pragma unroll
    for (int k = 0; k < i; ++k) s -= h[tri(i, k)] * h[tri(i, k)];
    const T lii = photon::dev_sqrt(dev_max(s, jitter));
    h[tri(i, i)] = lii;
#pragma unroll
    for (int j = i + 1; j < D; ++j) {
      T s2 = h[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 -= h[tri(j, k)] * h[tri(i, k)];
      h[tri(j, i)] = s2 / lii;
    }
  }

  // forward (L zz = g), then back (L^T x = zz) in place
  T zz[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = g[i * L + l];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= h[tri(i, k)] * zz[k];
    zz[i] = s / h[tri(i, i)];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    T s = zz[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s -= h[tri(k, i)] * zz[k];
    zz[i] = s / h[tri(i, i)];
    out[i * L + l] = zz[i];
  }
}

template <typename T, typename XT, int D, int LOSS>
int launch_typed(const void* w, const void* g, const void* x, const void* y,
                 const void* off, const void* wt, const void* l2, int cap,
                 int64_t L, double eps, void* out, cudaStream_t stream) {
  const int64_t blocks = (L + kThreads - 1) / kThreads;
  newton_step_kernel<T, XT, D, LOSS><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(g), static_cast<const XT*>(x),
      static_cast<const T*>(y), static_cast<const T*>(off),
      static_cast<const T*>(wt), static_cast<const T*>(l2), cap, L, (T)eps,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, typename XT, int LOSS>
int dispatch_d(int d, const void* w, const void* g, const void* x, const void* y,
               const void* off, const void* wt, const void* l2, int cap, int64_t L,
               double eps, void* out, cudaStream_t s) {
#define PHOTON_SOA_CASE(DD) \
  case DD:                  \
    return launch_typed<T, XT, DD, LOSS>(w, g, x, y, off, wt, l2, cap, L, eps, out, s);
  switch (d) {
    PHOTON_SOA_CASE(1)
    PHOTON_SOA_CASE(2)
    PHOTON_SOA_CASE(3)
    PHOTON_SOA_CASE(4)
    PHOTON_SOA_CASE(5)
    PHOTON_SOA_CASE(6)
    PHOTON_SOA_CASE(7)
    PHOTON_SOA_CASE(8)
    PHOTON_SOA_CASE(9)
    PHOTON_SOA_CASE(10)
    PHOTON_SOA_CASE(11)
    PHOTON_SOA_CASE(12)
    PHOTON_SOA_CASE(13)
    PHOTON_SOA_CASE(14)
    PHOTON_SOA_CASE(15)
    PHOTON_SOA_CASE(16)
    default:
      return -1;
  }
#undef PHOTON_SOA_CASE
}

template <typename T, typename XT>
int dispatch_loss(int loss, int d, const void* w, const void* g, const void* x,
                  const void* y, const void* off, const void* wt, const void* l2,
                  int cap, int64_t L, double eps, void* out, cudaStream_t s) {
  // the losses the SoA gate admits: logistic, squared, Poisson
  switch (loss) {
    case 0:
      return dispatch_d<T, XT, 0>(d, w, g, x, y, off, wt, l2, cap, L, eps, out, s);
    case 1:
      return dispatch_d<T, XT, 1>(d, w, g, x, y, off, wt, l2, cap, L, eps, out, s);
    case 2:
      return dispatch_d<T, XT, 2>(d, w, g, x, y, off, wt, l2, cap, L, eps, out, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: the solver type of w, g, y, off, wt, l2 and out; xtype: x's
// storage type, the same or narrower; codes 0 float32, 1 float64,
// 2 bfloat16, 3 float16.  w, g, out [d, L]; x [cap, d, L]; y, off, wt
// [cap, L]; l2 [L]; all contiguous, lanes last.
int newton_step_launch(int dtype, int xtype, int loss, int d, const void* w,
                       const void* g, const void* x, const void* y, const void* off,
                       const void* wt, const void* l2, int cap, long long L,
                       double eps, void* out, void* stream) {
  using photon::kBF16;
  using photon::kF16;
  using photon::kF32;
  using photon::kF64;
  if (cap < 1 || L < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PHOTON_SOA_TYPES(TT, XX) \
  return dispatch_loss<TT, XX>(loss, d, w, g, x, y, off, wt, l2, cap, L, eps, out, s)
  if (dtype == kF32) {
    if (xtype == kF32) PHOTON_SOA_TYPES(float, float);
    if (xtype == kBF16) PHOTON_SOA_TYPES(float, __nv_bfloat16);
    if (xtype == kF16) PHOTON_SOA_TYPES(float, __half);
  } else if (dtype == kF64) {
    if (xtype == kF64) PHOTON_SOA_TYPES(double, double);
    if (xtype == kF32) PHOTON_SOA_TYPES(double, float);
    if (xtype == kBF16) PHOTON_SOA_TYPES(double, __nv_bfloat16);
    if (xtype == kF16) PHOTON_SOA_TYPES(double, __half);
  }
#undef PHOTON_SOA_TYPES
  return -1;
}

}  // extern "C"
