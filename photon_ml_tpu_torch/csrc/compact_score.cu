// match_dot: compact sparse random-effect scoring.
//
// Replaces the TPU kernel _match_dot_kernel (photon_ml_tpu/ops/compact_score.py,
// match_dot / score_sparse_compact).  Per sample i with entity e = slots[i]:
//
//   out[i] = sum_f sum_m [w_idx[e, m] == f_idx[i, f]] * w_val[e, m] * f_val[i, f]
//
// over the entity's model row (w_idx / w_val [E, k_model]) and the sample's
// padded COO features (f_idx / f_val [n, k_feat]).  Duplicate feature ids
// accumulate; a sample whose slot is outside [0, E) (slot -1: no model)
// scores 0, and its row is never read.
//
// Invariant relied on: every model row is sorted ascending, and its ids are
// unique apart from the trailing padding (id dim, value 0).  The
// reference's searchsorted chain relies on the same order; the producers of
// compact rows (to_compact, convert's "compact" kind) give it, and a CPU test
// holds them to it.  Then the double sum above has at most one nonzero term
// per feature: the model entry found by a binary search of the feature id.
//
// Bound on an H100: bytes.  Each sample reads its slot, its k_feat feature
// pairs and writes one value; its entity's row is read from L2 (the
// [E, k_model] tables are shared by many samples and stay resident), so HBM
// carries each touched row once.
//
// Design for that bound.  The TPU kernel compared every (feature, model
// entry) pair, k_model * k_feat compare-selects per sample, and the first
// port gave each sample a warp striding over those pairs with an integer
// division per pair and one sample in flight per warp: latency-bound at
// 4-10% of the bytes bound.  Here one lane takes one (sample, feature): it
// binary-searches its feature id in the entity's row, ceil(log2 k_model)
// dependent probes and one final load of the id and the value, all through
// L1/L2.  A sample is a sub-warp group of G = 2^log_group lanes (sized to
// k_feat by ops/compact_score.match_plan), so 32 / G samples are in flight
// per warp; a lane takes features sub, sub + G, ... (feats_per_lane of
// them) in batches of BATCH = min(feats_per_lane, 4) whose searches
// interleave, so no batch slot is spent on a feature the lane does not
// have.  Groups walk the samples with a grid stride and load the next
// sample's slot before working on the current one, so the slot-then-row
// chain of one sample overlaps the last one's.  No integer division
// anywhere: group and lane come from shifts and masks.  The group sums its
// lanes' products with a fixed xor butterfly, so the result is repeatable
// bitwise.
//
// Warp instructions per sample at glmix_sparse's (k_model 32, k_feat 24):
// G = 8, so a warp round serves 4 samples with one batch of three features
// a lane, five probes of ~6 instructions (address, load, compare, select)
// and a final compare-and-multiply each, plus the feature loads, the
// butterfly, the slot and the output: ~140 a round, ~35 a sample, against
// 24 trips of ~10 (the division, four loads, compare, multiply-add, loop)
// for the warp-per-sample walk.  At that count the kernel is bound by
// instruction issue more than by latency.  The lane-steps per sample,
// G * feats_per_lane * (probes + 1), never exceed the flattened walk's
// 32 * ceil(k_model * k_feat / 32) over the whole eligible range
// (match_plan halves G until they do).
//
// Plain C interface for ctypes: returns the CUDA error of the launch (0 on
// success) or -1 for arguments it does not take.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 4;  // features a lane searches at once, at most

template <typename T, int BATCH>
__global__ void __launch_bounds__(kThreads)
match_dot_kernel(const int32_t* __restrict__ w_idx, const T* __restrict__ w_val,
                 int64_t num_entities, int k_model,
                 const int32_t* __restrict__ slots, const int32_t* __restrict__ f_idx,
                 const T* __restrict__ f_val, int64_t n, int k_feat, int log_group,
                 int feats_per_lane, T* __restrict__ out) {
  const int group = 1 << log_group;
  const int sub = threadIdx.x & (group - 1);
  const int64_t stride = ((int64_t)gridDim.x * kThreads) >> log_group;
  const int64_t first = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> log_group;
  // the warp's first sample decides how many rounds the warp runs, so every
  // lane of the warp reaches the butterfly's shuffles
  const int64_t warp_first =
      ((int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31)) >> log_group;
  int32_t slot = first < n ? __ldg(slots + first) : -1;
  for (int64_t i = first, w0 = warp_first; w0 < n; i += stride, w0 += stride) {
    const int64_t next = i + stride;
    const int32_t next_slot = next < n ? __ldg(slots + next) : -1;  // in flight early
    T acc = T(0);
    if (i < n && slot >= 0 && slot < num_entities) {
      const int32_t* fi = f_idx + i * k_feat;
      const T* fv = f_val + i * k_feat;
      const int32_t* row = w_idx + (int64_t)slot * k_model;
      const T* rval = w_val + (int64_t)slot * k_model;
      for (int t0 = 0; t0 < feats_per_lane; t0 += BATCH) {
        int fid[BATCH], lo[BATCH];
        T x[BATCH];
        bool ok[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int f = sub + (t0 + b) * group;
          ok[b] = f < k_feat;
          fid[b] = ok[b] ? __ldg(fi + f) : 0;
          x[b] = ok[b] ? __ldg(fv + f) : T(0);
          lo[b] = 0;
        }
        // lower bound: the first entry >= fid lies in [lo, lo + len)
        for (int len = k_model; len > 1;) {
          const int half = len >> 1;
#pragma unroll
          for (int b = 0; b < BATCH; ++b)
            lo[b] = __ldg(row + lo[b] + half - 1) < fid[b] ? lo[b] + half : lo[b];
          len -= half;
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          if (ok[b] && __ldg(row + lo[b]) == fid[b]) acc += x[b] * __ldg(rval + lo[b]);
      }
    }
    for (int o = group >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (i < n && sub == 0) out[i] = acc;
    slot = next_slot;
  }
}

template <typename T, int BATCH>
int launch_batch(const void* w_idx, const void* w_val, int64_t num_entities, int k_model,
                 const void* slots, const void* f_idx, const void* f_val, int64_t n,
                 int k_feat, int log_group, int feats_per_lane, void* out,
                 cudaStream_t stream) {
  static int blocks_per_sm = 0;  // resident blocks of this instantiation
  cudaError_t err;
  if (blocks_per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, match_dot_kernel<T, BATCH>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // one resident wave; each group then walks its samples with a grid stride
  const int64_t groups_per_block = kThreads >> log_group;
  const int64_t needed = (n + groups_per_block - 1) / groups_per_block;
  const int64_t wave = (int64_t)sms * blocks_per_sm;
  const int blocks = (int)(needed < wave ? needed : wave);
  match_dot_kernel<T, BATCH><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(w_idx), static_cast<const T*>(w_val), num_entities,
      k_model, static_cast<const int32_t*>(slots), static_cast<const int32_t*>(f_idx),
      static_cast<const T*>(f_val), n, k_feat, log_group, feats_per_lane,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* w_idx, const void* w_val, int64_t num_entities, int k_model,
                 const void* slots, const void* f_idx, const void* f_val, int64_t n,
                 int k_feat, int log_group, int feats_per_lane, void* out,
                 cudaStream_t stream) {
  switch (feats_per_lane < kMaxBatch ? feats_per_lane : kMaxBatch) {
    case 1:
      return launch_batch<T, 1>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                                n, k_feat, log_group, feats_per_lane, out, stream);
    case 2:
      return launch_batch<T, 2>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                                n, k_feat, log_group, feats_per_lane, out, stream);
    case 3:
      return launch_batch<T, 3>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                                n, k_feat, log_group, feats_per_lane, out, stream);
    default:
      return launch_batch<T, 4>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                                n, k_feat, log_group, feats_per_lane, out, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64.  w_idx int32 / w_val [E, k_model], rows sorted
// ascending and dim-padded; slots int32 [n]; f_idx int32 / f_val [n, k_feat];
// out [n]; all contiguous.  log_group in [0, 5] and feats_per_lane =
// ceil(k_feat / 2^log_group) come from ops/compact_score.match_plan.
int match_dot_launch(int dtype, const void* w_idx, const void* w_val,
                     long long num_entities, int k_model, const void* slots,
                     const void* f_idx, const void* f_val, long long n, int k_feat,
                     int log_group, int feats_per_lane, void* out, void* stream) {
  if (k_model < 1 || k_feat < 1 || n < 1 || num_entities < 0) return -1;
  if (log_group < 0 || log_group > 5) return -1;
  if ((long long)feats_per_lane << log_group < k_feat) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                               n, k_feat, log_group, feats_per_lane, out, s);
  if (dtype == 1)
    return launch_typed<double>(w_idx, w_val, num_entities, k_model, slots, f_idx, f_val,
                                n, k_feat, log_group, feats_per_lane, out, s);
  return -1;
}

}  // extern "C"
