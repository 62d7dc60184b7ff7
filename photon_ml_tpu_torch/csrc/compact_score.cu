// match_dot: compact sparse random-effect scoring.
//
// Replaces the TPU kernel _match_dot_kernel (photon_ml_tpu/ops/compact_score.py,
// match_dot / score_sparse_compact).  Per sample i with entity e = slots[i]:
//
//   out[i] = sum_f sum_m [w_idx[e, m] == f_idx[i, f]] * w_val[e, m] * f_val[i, f]
//
// over the entity's sorted, dim-padded model row (w_idx / w_val [E, k_model])
// and the sample's padded COO features (f_idx / f_val [n, k_feat]).  Model
// padding (index dim, value 0) and COO padding (value 0) add nothing;
// duplicate feature ids accumulate; a sample whose slot is outside [0, E)
// (slot -1: no model) scores 0, and its row is never read.
//
// Bound on an H100: bytes.  Each sample reads its slot, its k_feat feature
// pairs and its entity's k_model model pairs, and writes one value; the
// k_model * k_feat integer compare-selects on them (at most 4096 by the gate,
// ops/compact_score.eligible) are cheap beside that at the main path's shapes.
//
// Design: the TPU kernel had the wrapper gather w_idx[e] and transpose every
// operand to [k, n] so samples lie on the 128 lanes.  Here the slot gather is
// fused: one warp per sample reads its entity row in place from the [E, k]
// tables (L1 serves the repeated reads) and its feature row row-major; no
// [k, n] copy exists.  The warp's lanes stride over the flattened
// (feature, model entry) pairs, so every shape from (1, 4096) to (4096, 1)
// keeps the lanes busy, and a fixed-order shuffle reduction makes the result
// repeatable.  Any n; float32 and float64.
//
// Plain C interface for ctypes: returns the CUDA error of the launch (0 on
// success) or -1 for arguments it does not take.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // samples per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_dot_kernel(const int32_t* __restrict__ w_idx, const T* __restrict__ w_val,
                 int64_t num_entities, int k_model,
                 const int32_t* __restrict__ slots, const int32_t* __restrict__ f_idx,
                 const T* __restrict__ f_val, int64_t n, int k_feat,
                 T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warps leave together
  const int32_t slot = slots[i];
  T acc = T(0);
  if (slot >= 0 && slot < num_entities) {  // uniform across the warp
    const int32_t* wi = w_idx + (int64_t)slot * k_model;
    const T* wv = w_val + (int64_t)slot * k_model;
    const int32_t* fi = f_idx + i * k_feat;
    const T* fv = f_val + i * k_feat;
    const int pairs = k_model * k_feat;
    for (int p = lane; p < pairs; p += 32) {
      const int f = p / k_model;
      const int m = p - f * k_model;
      if (__ldg(fi + f) == __ldg(wi + m)) acc += __ldg(fv + f) * __ldg(wv + m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[i] = acc;
}

template <typename T>
int launch_typed(const void* w_idx, const void* w_val, int64_t num_entities, int k_model,
                 const void* slots, const void* f_idx, const void* f_val, int64_t n,
                 int k_feat, void* out, cudaStream_t stream) {
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  match_dot_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(w_idx), static_cast<const T*>(w_val), num_entities,
      k_model, static_cast<const int32_t*>(slots), static_cast<const int32_t*>(f_idx),
      static_cast<const T*>(f_val), n, k_feat, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64.  w_idx int32 / w_val [E, k_model]; slots int32
// [n]; f_idx int32 / f_val [n, k_feat]; out [n]; all contiguous.
int match_dot_launch(int dtype, const void* w_idx, const void* w_val,
                     long long num_entities, int k_model, const void* slots,
                     const void* f_idx, const void* f_val, long long n, int k_feat,
                     void* out, void* stream) {
  if (k_model < 1 || k_feat < 1 || n < 1 || num_entities < 0) return -1;
  if ((int64_t)k_model * k_feat > (1 << 20)) return -1;
  if ((n + kWarps - 1) / kWarps > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                               n, k_feat, out, s);
  if (dtype == 1)
    return launch_typed<double>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                                n, k_feat, out, s);
  return -1;
}

}  // extern "C"
