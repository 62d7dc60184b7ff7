// Fused GLM passes over a dense design X, each in one read of X:
//
//   fused_value_and_grad: (sum wt*l(z, y), X^T r, sum r), z = X w + offset +
//     shift, r = weight * l'(z, y).  Replaces the TPU kernel _value_grad_kernel
//     (photon_ml_tpu/ops/fused_glm.py, fused_value_and_grad).
//   fused_hvp: (X^T q, sum q), q = weight * l''(z, y) * (X v + v_shift).
//     Replaces the TPU kernel _hvp_kernel (photon_ml_tpu/ops/fused_glm.py,
//     fused_hvp): X w and X v come from the same read of each row.
//
// In both, z = 0 where weight <= 0, so unbounded losses (Poisson's exp) stay
// finite on padded and weight-0 rows.  Outputs are raw-space sums; the caller
// applies the normalization chain rule and L2.
//
// Bound on an H100: bytes.  Value+gradient does 4 flops per element of X and
// the Hessian-vector product 6, against one 4-byte read of it, so X's bytes
// over HBM bandwidth is the floor (~5 ms for the 17.2 GB f32 design of
// glmix_chip, ~0.16 ms for glmix2's 0.54 GB) and the FP32 pipes are never the
// limit.  Design for that bound, shared by both kernels: X is read from HBM
// once.  Each block owns a contiguous range of rows and walks it in tiles of
// whole rows staged in shared memory (one contiguous, vectorised copy per
// tile); a warp per staged row forms the row's dot product(s) from the tile,
// with w (and v) read through L1 rather than held in shared memory (at
// d = 8192 in f64 they would take 128 KB beside the tile), lane 0 evaluates
// the loss, then every thread folds the row coefficient times x into its own
// columns of a per-block accumulator held in shared memory.  Blocks write
// [grid, width] partials and a second kernel sums them over blocks in a fixed
// order: no float atomics, so results are bitwise repeatable.  The TPU
// kernels' carried accumulators relied on their grid running in order on one
// core; blocks here run concurrently.  Products are plain FP32 (or FP64) FMAs,
// the precision the TPU kernels forced on the MXU.
//
// Plain C interface for ctypes.  Every entry point returns the CUDA error of
// its launches (0 on success) or -1 for arguments it does not take.

#include <cstdint>
#include <cuda_runtime.h>

#include "glm_losses.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};

// Shared memory of either kernel: the row tile [tile_rows, d], then the block
// accumulator [d], the tile's row coefficients [tile_rows] and the per-warp
// scalar sums [2 * kWarps].
template <typename T>
size_t smem_bytes(int d, int tile_rows) {
  return sizeof(T) * ((size_t)tile_rows * d + d + tile_rows + 2 * kWarps);
}

template <typename T>
struct BlockSmem {
  T* tile;
  T* acc;
  T* coef;
  T* red;
  __device__ BlockSmem(unsigned char* raw, int d, int tile_rows) {
    tile = reinterpret_cast<T*>(raw);
    acc = tile + (size_t)tile_rows * d;
    coef = acc + d;
    red = coef + tile_rows;
  }
};

// Copy `count` contiguous elements of X into the tile, vectorised when the
// rows and the base pointer allow it.
template <typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* __restrict__ src,
                                           int64_t count, bool vec_ok) {
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::width;
  if (vec_ok) {
    const V* s4 = reinterpret_cast<const V*>(src);
    V* t4 = reinterpret_cast<V*>(tile);
    const int64_t nv = count / VW;
    for (int64_t k = threadIdx.x; k < nv; k += kThreads) t4[k] = __ldg(s4 + k);
  } else {
    for (int64_t k = threadIdx.x; k < count; k += kThreads) tile[k] = __ldg(src + k);
  }
}

template <typename T>
__device__ __forceinline__ bool vectorisable(const T* x, int d) {
  using V = typename Vec<T>::type;
  return (d % Vec<T>::width) == 0 && (reinterpret_cast<uintptr_t>(x) % sizeof(V)) == 0;
}

// Fixed-order butterfly sum over the warp.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[j] += sum over the tile's rows of coef[rr] * tile[rr, j]; each thread
// owns columns j = tid + k * kThreads.
template <typename T>
__device__ __forceinline__ void fold_rows(T* acc, const T* coef, const T* tile,
                                          int rows, int d) {
  for (int j = threadIdx.x; j < d; j += kThreads) {
    T g = acc[j];
    for (int rr = 0; rr < rows; ++rr) g += coef[rr] * tile[(size_t)rr * d + j];
    acc[j] = g;
  }
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kThreads)
fvg_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ y, const T* __restrict__ off,
                   const T* __restrict__ wt, const T* __restrict__ shift,
                   int64_t n, int d, int64_t rows_per_block, int tile_rows,
                   T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockSmem<T> s(smem_raw, d, tile_rows);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j = tid; j < d; j += kThreads) s.acc[j] = T(0);

  const T sh = shift[0];
  T val_acc = T(0);
  T rsum_acc = T(0);
  const int64_t row_begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end =
      row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  const bool vec_ok = vectorisable(x, d);

  for (int64_t r0 = row_begin; r0 < row_end; r0 += tile_rows) {
    const int rows = (int)(row_end - r0 < tile_rows ? row_end - r0 : tile_rows);
    __syncthreads();  // the previous tile's fold is done with it
    stage_tile(s.tile, x + r0 * (int64_t)d, (int64_t)rows * d, vec_ok);
    __syncthreads();

    // margins, loss and residual: one warp per row
    for (int rr = warp; rr < rows; rr += kWarps) {
      const T* xr = s.tile + (size_t)rr * d;
      T acc = T(0);
      for (int j = lane; j < d; j += 32) acc += xr[j] * __ldg(w + j);
      acc = warp_sum(acc);
      if (lane == 0) {
        const int64_t row = r0 + rr;
        const T wtv = wt[row];
        T z = acc + off[row] + sh;
        z = wtv > T(0) ? z : T(0);  // weight-0 rows stay finite
        T l, d1;
        photon::loss_and_d1<LOSS>(z, y[row], l, d1);
        const T r = wtv * d1;
        s.coef[rr] = r;
        val_acc += wtv * l;
        rsum_acc += r;
      }
    }
    __syncthreads();
    fold_rows(s.acc, s.coef, s.tile, rows, d);
  }

  if (lane == 0) {
    s.red[warp] = val_acc;
    s.red[kWarps + warp] = rsum_acc;
  }
  __syncthreads();
  T* out = partials + (int64_t)blockIdx.x * (d + 2);
  for (int j = tid; j < d; j += kThreads) out[j] = s.acc[j];
  if (tid == 0) {
    T v = T(0), rs = T(0);
    for (int k = 0; k < kWarps; ++k) {
      v += s.red[k];
      rs += s.red[kWarps + k];
    }
    out[d] = v;
    out[d + 1] = rs;
  }
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kThreads)
hvp_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ v, const T* __restrict__ y,
                   const T* __restrict__ off, const T* __restrict__ wt,
                   const T* __restrict__ shift, const T* __restrict__ vshift,
                   int64_t n, int d, int64_t rows_per_block, int tile_rows,
                   T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockSmem<T> s(smem_raw, d, tile_rows);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j = tid; j < d; j += kThreads) s.acc[j] = T(0);

  const T sh = shift[0];
  const T vsh = vshift[0];
  T qsum_acc = T(0);
  const int64_t row_begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end =
      row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  const bool vec_ok = vectorisable(x, d);

  for (int64_t r0 = row_begin; r0 < row_end; r0 += tile_rows) {
    const int rows = (int)(row_end - r0 < tile_rows ? row_end - r0 : tile_rows);
    __syncthreads();
    stage_tile(s.tile, x + r0 * (int64_t)d, (int64_t)rows * d, vec_ok);
    __syncthreads();

    // X w and X v from one read of the staged row, then the curvature weight
    for (int rr = warp; rr < rows; rr += kWarps) {
      const T* xr = s.tile + (size_t)rr * d;
      T aw = T(0), av = T(0);
      for (int j = lane; j < d; j += 32) {
        const T xv = xr[j];
        aw += xv * __ldg(w + j);
        av += xv * __ldg(v + j);
      }
      aw = warp_sum(aw);
      av = warp_sum(av);
      if (lane == 0) {
        const int64_t row = r0 + rr;
        const T wtv = wt[row];
        T z = aw + off[row] + sh;
        z = wtv > T(0) ? z : T(0);  // weight-0 rows stay finite
        const T q = wtv * photon::d2<LOSS>(z, y[row]) * (av + vsh);
        s.coef[rr] = q;
        qsum_acc += q;
      }
    }
    __syncthreads();
    fold_rows(s.acc, s.coef, s.tile, rows, d);
  }

  if (lane == 0) s.red[warp] = qsum_acc;
  __syncthreads();
  T* out = partials + (int64_t)blockIdx.x * (d + 1);
  for (int j = tid; j < d; j += kThreads) out[j] = s.acc[j];
  if (tid == 0) {
    T q = T(0);
    for (int k = 0; k < kWarps; ++k) q += s.red[k];
    out[d] = q;
  }
}

// out[j] = sum over blocks of partials[b, j], blocks in order.
template <typename T>
__global__ void reduce_partials_kernel(const T* __restrict__ partials,
                                       int num_blocks, int width,
                                       T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  T s = T(0);
  for (int b = 0; b < num_blocks; ++b) s += partials[(int64_t)b * width + j];
  out[j] = s;
}

// Arguments of either pass; v and vshift are read by the Hessian-vector
// product only.
struct GlmArgs {
  const void* x;
  const void* w;
  const void* v;
  const void* y;
  const void* off;
  const void* wt;
  const void* shift;
  const void* vshift;
  int64_t n;
  int d;
  int64_t rows_per_block;
  int tile_rows;
  int num_blocks;
  void* partials;
  void* out;
};

template <typename T, int LOSS, bool HVP>
int launch_typed(const GlmArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.d, a.tile_rows);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* y = static_cast<const T*>(a.y);
  const T* off = static_cast<const T*>(a.off);
  const T* wt = static_cast<const T*>(a.wt);
  const T* shift = static_cast<const T*>(a.shift);
  T* partials = static_cast<T*>(a.partials);
  cudaError_t err;
  if constexpr (HVP) {
    auto kern = hvp_partial_kernel<T, LOSS>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<a.num_blocks, kThreads, smem, stream>>>(
        x, w, static_cast<const T*>(a.v), y, off, wt, shift,
        static_cast<const T*>(a.vshift), a.n, a.d, a.rows_per_block, a.tile_rows,
        partials);
  } else {
    auto kern = fvg_partial_kernel<T, LOSS>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<a.num_blocks, kThreads, smem, stream>>>(
        x, w, y, off, wt, shift, a.n, a.d, a.rows_per_block, a.tile_rows, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = a.d + (HVP ? 1 : 2);
  reduce_partials_kernel<T><<<(width + 255) / 256, 256, 0, stream>>>(
      partials, a.num_blocks, width, static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

template <typename T, bool HVP>
int dispatch_loss(int loss, const GlmArgs& a, cudaStream_t stream) {
  switch (loss) {
    case 0:
      return launch_typed<T, 0, HVP>(a, stream);
    case 1:
      return launch_typed<T, 1, HVP>(a, stream);
    case 2:
      return launch_typed<T, 2, HVP>(a, stream);
    case 3:
      return launch_typed<T, 3, HVP>(a, stream);
    default:
      return -1;
  }
}

template <bool HVP>
int dispatch(int dtype, int loss, const GlmArgs& a, void* stream) {
  if (a.d < 1 || a.n < 1 || a.tile_rows < 1 || a.num_blocks < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_loss<float, HVP>(loss, a, s);
  if (dtype == 1) return dispatch_loss<double, HVP>(loss, a, s);
  return -1;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of either kernel needs; the wrapper sizes
// tiles with it.
long long glm_smem_bytes(int dtype, int d, int tile_rows) {
  return dtype == 0 ? (long long)smem_bytes<float>(d, tile_rows)
                    : (long long)smem_bytes<double>(d, tile_rows);
}

// dtype: 0 float32, 1 float64.  x [n, d] row-major; w [d]; y, off, wt [n];
// shift [1]; partials [num_blocks, d + 2]; out [d + 2] = (grad, value, rsum).
int fvg_launch(int dtype, int loss, const void* x, const void* w, const void* y,
               const void* off, const void* wt, const void* shift, long long n,
               int d, long long rows_per_block, int tile_rows, int num_blocks,
               void* partials, void* out, void* stream) {
  const GlmArgs a{x, w, nullptr, y, off, wt, shift, nullptr, n, d,
                  rows_per_block, tile_rows, num_blocks, partials, out};
  return dispatch<false>(dtype, loss, a, stream);
}

// dtype: 0 float32, 1 float64.  x [n, d] row-major; w, v [d]; y, off, wt [n];
// shift, vshift [1]; partials [num_blocks, d + 1]; out [d + 1] = (X^T q, sum q).
int hvp_launch(int dtype, int loss, const void* x, const void* w, const void* v,
               const void* y, const void* off, const void* wt, const void* shift,
               const void* vshift, long long n, int d, long long rows_per_block,
               int tile_rows, int num_blocks, void* partials, void* out,
               void* stream) {
  const GlmArgs a{x, w, v, y, off, wt, shift, vshift, n, d,
                  rows_per_block, tile_rows, num_blocks, partials, out};
  return dispatch<true>(dtype, loss, a, stream);
}

}  // extern "C"
