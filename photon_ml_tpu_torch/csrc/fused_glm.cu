// fused_value_and_grad: (sum wt*l(z, y), X^T r, sum r) in one read of X.
//
// Replaces the TPU kernel _value_grad_kernel (photon_ml_tpu/ops/fused_glm.py,
// fused_value_and_grad): z = X w + offset + shift, z = 0 where weight <= 0,
// r = weight * l'(z, y).  Outputs are raw-space sums; the caller applies the
// normalization chain rule and L2.
//
// Bound on an H100: bytes.  The work is 2 FMAs per element of X against one
// 4-byte read of it, so X's bytes over HBM bandwidth is the floor (~5 ms for
// the 17.2 GB f32 design of glmix_chip) and the FP32 pipes are never the limit.
// Design for that bound: X is read from HBM once.  Each block owns a
// contiguous range of rows and walks it in tiles of whole rows staged in
// shared memory (one contiguous, vectorised copy per tile); a warp per row
// computes the margin from the staged tile, lane 0 evaluates the loss, then
// every thread folds r * x into its own columns of a per-block gradient held
// in shared memory.  Blocks write [grid, d + 2] partials and a second kernel
// sums them over blocks in a fixed order: no float atomics, so results are
// bitwise repeatable.  The TPU kernel's carried accumulator relied on its grid
// running in order on one core; blocks here run concurrently.
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

// Shared memory: the row tile [tile_rows, d], then the block gradient [d],
// the tile's residuals [tile_rows] and the per-warp value / rsum sums.
template <typename T>
size_t smem_bytes(int d, int tile_rows) {
  return sizeof(T) * ((size_t)tile_rows * d + d + tile_rows + 2 * kWarps);
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kThreads)
fvg_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ y, const T* __restrict__ off,
                   const T* __restrict__ wt, const T* __restrict__ shift,
                   int64_t n, int d, int64_t rows_per_block, int tile_rows,
                   T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* g_acc = tile + (size_t)tile_rows * d;
  T* r_tile = g_acc + d;
  T* red = r_tile + tile_rows;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j = tid; j < d; j += kThreads) g_acc[j] = T(0);

  const T sh = shift[0];
  T val_acc = T(0);
  T rsum_acc = T(0);
  const int64_t row_begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end =
      row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::width;
  const bool vec_ok =
      (d % VW) == 0 && (reinterpret_cast<uintptr_t>(x) % sizeof(V)) == 0;

  for (int64_t r0 = row_begin; r0 < row_end; r0 += tile_rows) {
    const int rows = (int)(row_end - r0 < tile_rows ? row_end - r0 : tile_rows);
    const int64_t count = (int64_t)rows * d;
    const T* src = x + r0 * (int64_t)d;
    __syncthreads();  // the previous tile's gradient pass is done with it
    if (vec_ok) {
      const V* s4 = reinterpret_cast<const V*>(src);
      V* t4 = reinterpret_cast<V*>(tile);
      const int64_t nv = count / VW;
      for (int64_t k = tid; k < nv; k += kThreads) t4[k] = __ldg(s4 + k);
    } else {
      for (int64_t k = tid; k < count; k += kThreads) tile[k] = __ldg(src + k);
    }
    __syncthreads();

    // margins, loss and residual: one warp per row, fixed-order shuffle sum
    for (int rr = warp; rr < rows; rr += kWarps) {
      const T* xr = tile + (size_t)rr * d;
      T acc = T(0);
      for (int j = lane; j < d; j += 32) acc += xr[j] * __ldg(w + j);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const int64_t row = r0 + rr;
        const T wtv = wt[row];
        T z = acc + off[row] + sh;
        z = wtv > T(0) ? z : T(0);  // weight-0 rows stay finite
        T l, d1;
        photon::loss_and_d1<LOSS>(z, y[row], l, d1);
        const T r = wtv * d1;
        r_tile[rr] = r;
        val_acc += wtv * l;
        rsum_acc += r;
      }
    }
    __syncthreads();

    // gradient: each thread owns columns j = tid + k * kThreads
    for (int j = tid; j < d; j += kThreads) {
      T g = g_acc[j];
      for (int rr = 0; rr < rows; ++rr) g += r_tile[rr] * tile[(size_t)rr * d + j];
      g_acc[j] = g;
    }
  }

  if (lane == 0) {
    red[warp] = val_acc;
    red[kWarps + warp] = rsum_acc;
  }
  __syncthreads();
  T* out = partials + (int64_t)blockIdx.x * (d + 2);
  for (int j = tid; j < d; j += kThreads) out[j] = g_acc[j];
  if (tid == 0) {
    T v = T(0), rs = T(0);
    for (int k = 0; k < kWarps; ++k) {
      v += red[k];
      rs += red[kWarps + k];
    }
    out[d] = v;
    out[d + 1] = rs;
  }
}

// out[j] = sum over blocks of partials[b, j], blocks in order.
template <typename T>
__global__ void fvg_reduce_kernel(const T* __restrict__ partials, int num_blocks,
                                  int width, T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  T s = T(0);
  for (int b = 0; b < num_blocks; ++b) s += partials[(int64_t)b * width + j];
  out[j] = s;
}

template <typename T, int LOSS>
int launch_typed(const void* x, const void* w, const void* y, const void* off,
                 const void* wt, const void* shift, int64_t n, int d,
                 int64_t rows_per_block, int tile_rows, int num_blocks,
                 void* partials, void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(d, tile_rows);
  auto kern = fvg_partial_kernel<T, LOSS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(y),
      static_cast<const T*>(off), static_cast<const T*>(wt),
      static_cast<const T*>(shift), n, d, rows_per_block, tile_rows,
      static_cast<T*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = d + 2;
  fvg_reduce_kernel<T><<<(width + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(partials), num_blocks, width, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_loss(int loss, const void* x, const void* w, const void* y,
                  const void* off, const void* wt, const void* shift, int64_t n,
                  int d, int64_t rows_per_block, int tile_rows, int num_blocks,
                  void* partials, void* out, cudaStream_t stream) {
  switch (loss) {
    case 0:
      return launch_typed<T, 0>(x, w, y, off, wt, shift, n, d, rows_per_block,
                                tile_rows, num_blocks, partials, out, stream);
    case 1:
      return launch_typed<T, 1>(x, w, y, off, wt, shift, n, d, rows_per_block,
                                tile_rows, num_blocks, partials, out, stream);
    case 2:
      return launch_typed<T, 2>(x, w, y, off, wt, shift, n, d, rows_per_block,
                                tile_rows, num_blocks, partials, out, stream);
    case 3:
      return launch_typed<T, 3>(x, w, y, off, wt, shift, n, d, rows_per_block,
                                tile_rows, num_blocks, partials, out, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper sizes tiles with it.
long long fvg_smem_bytes(int dtype, int d, int tile_rows) {
  return dtype == 0 ? (long long)smem_bytes<float>(d, tile_rows)
                    : (long long)smem_bytes<double>(d, tile_rows);
}

// dtype: 0 float32, 1 float64.  x [n, d] row-major; w [d]; y, off, wt [n];
// shift [1]; partials [num_blocks, d + 2]; out [d + 2] = (grad, value, rsum).
int fvg_launch(int dtype, int loss, const void* x, const void* w, const void* y,
               const void* off, const void* wt, const void* shift, long long n,
               int d, long long rows_per_block, int tile_rows, int num_blocks,
               void* partials, void* out, void* stream) {
  if (d < 1 || n < 1 || tile_rows < 1 || num_blocks < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_loss<float>(loss, x, w, y, off, wt, shift, n, d, rows_per_block,
                                tile_rows, num_blocks, partials, out, s);
  if (dtype == 1)
    return dispatch_loss<double>(loss, x, w, y, off, wt, shift, n, d, rows_per_block,
                                 tile_rows, num_blocks, partials, out, s);
  return -1;
}

}  // extern "C"
