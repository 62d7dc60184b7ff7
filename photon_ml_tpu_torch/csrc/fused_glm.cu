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
// Storage width (the reference's mixed-precision contract): the kernels are
// templated on X's element type XT (float, double, __nv_bfloat16, __half)
// and the accumulation type T (float or double: y, offset, weight, the
// shifts, the sums and the outputs).  X, w and v are at XT; each element is
// widened to T as it is read (storage.cuh), and the row coefficient r (or
// q) is rounded to XT and widened back before it multiplies X in X^T r, as
// the TPU kernels round r.astype(x.dtype); sum r and sum q are not rounded.
//
// Bound on an H100: bytes.  Value+gradient does 4 flops per element of X and
// the Hessian-vector product 6, against one read of it (4 bytes in f32, 2 in
// bf16), so X's bytes over HBM bandwidth is the floor (~5.2 ms for the
// 17.2 GB f32 design of glmix_chip, ~2.6 ms at bf16; ~0.16 ms for glmix2's
// 0.54 GB) and the FP32 pipes are never the limit.  The design keeps bytes in
// flight at every row width and element size:
//
// - A persistent grid (the wrapper plans one or two blocks per SM) in which
//   each block walks a contiguous range of whole tiles of rows.
// - An asynchronous ring of `stages` tile buffers in shared memory
//   (stage_tile): while the block computes on tile t, tiles t+1 .. t+S-1 are
//   in flight.  One thread starts each tile's copy as a Hopper bulk copy
//   (cp.async.bulk, 1D, no tensor map) that completes on the stage's
//   mbarrier; the consumers wait on it by phase parity.  The compute warps
//   spend no instructions or registers on the bytes.  (Per-thread cp.async
//   of 16 bytes each, tried first, read markedly less of the bound at
//   d <= 257 on an H100: the issuing warps stalled on the copies they
//   queued, and those warps are the ones computing.)  The tile's ragged head and
//   tail and its rows' y, offset and weight (a few hundred bytes) go as
//   element-sized cp.async in one commit group a tile.  A slot is refilled
//   only after the block barrier that follows every warp's last use of it.
// - 16-byte copies at every d and base alignment.  A tile of whole rows is
//   one contiguous span of X.  Its 16-byte-aligned interior is the bulk
//   copy, into a stage whose start is offset by the span's misalignment
//   (`pad` elements), so the interior lands aligned in shared memory; the
//   head and tail (under 16 bytes each) go element by element (cp.async
//   moves 4, 8 or 16 bytes, so 2-byte elements go as 4-byte pairs, and an
//   odd element at a piece's end as a plain load and store).  Nothing
//   reads past the span.
// - Short dependency chains on each staged row.  w (and v), widened to T,
//   sit in registers up to 32 * kRegCoefs columns (768 at f32
//   accumulation, 256 at f64: every main path's fixed effect) and are read
//   through L1 above that.  Past the
//   bytes, the cost of a row is its loss, so a row's dot products are formed
//   by the fewest of 8, 16 or 32 lanes that hold its columns (24 a lane in
//   f32), and a warp works on up to four rows and their losses at once:
//   each lane reads its columns of its row at immediate offsets into the
//   staged tile, the group sums them by a butterfly, evaluates the loss,
//   and its first lane stores the row coefficient.  After a block barrier
//   each thread folds coefficient times x into its own columns of a
//   per-block accumulator in shared memory.  Two block barriers a tile.
// - Blocks write [grid, width] partials and a second kernel sums them over
//   blocks in a fixed order: no float atomics, so results are bitwise
//   repeatable.  The TPU kernels' carried accumulators relied on their grid
//   running in order on one core; blocks here run concurrently.  Products
//   are plain FP32 (or FP64) FMAs, the precision the TPU kernels forced on
//   the MXU.
//
// Plain C interface for ctypes.  Every entry point returns the CUDA error of
// its launches (0 on success) or -1 for arguments it does not take.

#include <cstdint>
#include <cuda_runtime.h>

#include "glm_losses.cuh"
#include "storage.cuh"

namespace {

using photon::Round;
using photon::widen;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 8;
// Columns of w (and v) each lane holds in registers at the accumulation
// type: a row of up to 8 * 24, 16 * 24 or 32 * 24 columns on 8, 16 or 32
// lanes in f32 (8 a lane in f64).
template <typename T>
constexpr int kRegCoefs = sizeof(T) == 4 ? 24 : 8;
// Elements of X in one 16-byte copy.
template <typename XT>
constexpr int kVec = 16 / (int)sizeof(XT);

__host__ __device__ inline int64_t round_up(int64_t v, int64_t m) {
  return (v + m - 1) / m * m;
}

// One stage of the ring, in bytes: the tile's span of X (up to kVec - 1
// elements of pad before it) in whole 16-byte pieces, then the tile's y,
// offset and weight at T; a whole number of 16-byte pieces, so every stage
// starts aligned.
template <typename XT>
__host__ __device__ int64_t stage_x_bytes(int d, int tile_rows) {
  return sizeof(XT) * round_up((int64_t)tile_rows * d + kVec<XT> - 1, kVec<XT>);
}
template <typename XT, typename T>
__host__ __device__ int64_t stage_bytes(int d, int tile_rows) {
  return round_up(stage_x_bytes<XT>(d, tile_rows) + 3 * (int64_t)tile_rows * sizeof(T), 16);
}

// Shared memory of either kernel: the ring, then the block accumulator [d],
// the tile's row coefficients [tile_rows], the per-warp scalar sums
// [2 * kWarps] (all at T), and from the next 8-byte boundary one mbarrier
// per stage.
template <typename XT, typename T>
__host__ __device__ int64_t barrier_offset(int d, int tile_rows, int stages) {
  return round_up(stages * stage_bytes<XT, T>(d, tile_rows) +
                      (int64_t)sizeof(T) * (d + tile_rows + 2 * kWarps),
                  8);
}
template <typename XT, typename T>
size_t smem_bytes(int d, int tile_rows, int stages) {
  return barrier_offset<XT, T>(d, tile_rows, stages) + 8 * (size_t)stages;
}

// The tensors both kernels read, and the launch plan.
template <typename XT, typename T>
struct GlmIn {
  const XT* __restrict__ x;
  const T* __restrict__ y;
  const T* __restrict__ off;
  const T* __restrict__ wt;
  int64_t n;
  int d;
  int64_t rows_per_block;
  int tile_rows;
  int stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
}

// cp.async of one 4-byte word (two 2-byte elements), both ends 4-byte aligned.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on `bar` and have its phase also wait for `bytes` of bulk copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Hopper's bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Elements of the span starting at `p` that lie past its last 16-byte
// boundary: the stage's pad, which puts the span's aligned interior on a
// 16-byte boundary of shared memory.
template <typename XT>
__device__ __forceinline__ int span_pad(const XT* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) % 16) / sizeof(XT));
}

// Copy `count` (< kVec) elements of a span's head or tail; thread `i` of
// the 8 that serve the piece.  dst and src agree modulo 16 bytes.  4- and
// 8-byte elements go one cp.async each; 2-byte elements go as 4-byte pairs
// from the piece's first 4-byte boundary, and an element before it or
// after the last pair as a plain load and store (ordered before the
// consumers' reads by the block barrier that precedes them).
template <typename XT>
__device__ __forceinline__ void copy_piece(XT* dst, const XT* src, int count, int i) {
  if (count <= 0 || i < 0 || i >= 8) return;
  if constexpr (sizeof(XT) >= 4) {
    if (i < count) cp_async_elem(dst + i, src + i);
  } else {
    const int lead = (reinterpret_cast<uintptr_t>(src) & 3) ? 1 : 0;
    const int pairs = (count - lead) / 2;
    const int trail = count - lead - 2 * pairs;
    if (i < pairs) {
      cp_async_4(dst + lead + 2 * i, src + lead + 2 * i);
    } else if (i == pairs) {
      if (lead) dst[0] = src[0];
    } else if (i == pairs + 1) {
      if (trail) dst[count - 1] = src[count - 1];
    }
  }
}

// Start the copies of rows [r0, r0 + rows) into `stage`: X's span
// [r0 * d, (r0 + rows) * d) at stage[pad ..], its aligned interior as one
// bulk copy that completes on `bar`, its head and tail piece by piece,
// then the rows' y, offset and weight.  The caller commits the group of
// element copies.
template <typename XT, typename T>
__device__ __forceinline__ void stage_tile(unsigned char* stage, const GlmIn<XT, T>& in,
                                           int64_t r0, int rows, uint64_t* bar) {
  constexpr int VW = kVec<XT>;
  const int tid = threadIdx.x;
  const XT* src = in.x + r0 * in.d;
  const int64_t count = (int64_t)rows * in.d;
  const int pad = span_pad(src);
  const int head = pad ? (int)(VW - pad < count ? VW - pad : count) : 0;
  const int64_t nvec = (count - head) / VW;
  const int tail = (int)(count - head - nvec * VW);
  XT* dst = reinterpret_cast<XT*>(stage) + pad;
  if (tid == 0) {
    mbar_arrive_expect(bar, (uint32_t)(nvec * 16));
    if (nvec > 0) bulk_copy(dst + head, src + head, (uint32_t)(nvec * 16), bar);
  }
  copy_piece(dst, src, head, tid);
  const int64_t e = head + nvec * VW;
  copy_piece(dst + e, src + e, tail, tid - (kThreads - 8));
  T* vec = reinterpret_cast<T*>(stage + stage_x_bytes<XT>(in.d, in.tile_rows));
  for (int i = tid; i < rows; i += kThreads) {
    cp_async_elem(vec + i, in.y + r0 + i);
    cp_async_elem(vec + in.tile_rows + i, in.off + r0 + i);
    cp_async_elem(vec + 2 * in.tile_rows + i, in.wt + r0 + i);
  }
}

// Fixed-order butterfly sum over aligned groups of `lanes` lanes (a power of
// 2); every lane of a group gets the same bits.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ... and over the groups of a warp: every lane gets the warp's sum.
template <typename T>
__device__ __forceinline__ T across_groups(T v, int lanes) {
  for (int o = lanes; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lanes that form one row's dot products: the fewest of 8, 16 and 32 that
// hold the row's columns in registers, kRegCoefs each; 32 when none does.
template <typename T>
__host__ __device__ inline int row_lanes(int d) {
  return d <= 8 * kRegCoefs<T> ? 8 : d <= 16 * kRegCoefs<T> ? 16 : 32;
}

// The NV coefficient vectors of a group of L lanes' row dot products: lane p
// of the group holds columns p + L * k in registers, widened to T, when
// d <= L * kRegCoefs, and reads them through L1 above that (L = 32 only).
template <typename XT, typename T, int NV>
struct RowCoefs {
  static constexpr int K = kRegCoefs<T>;
  T r[NV][K];
  const XT* g[NV];
  bool in_regs;

  template <int L>
  __device__ __forceinline__ void load(const XT* const* vecs, int d, int p) {
    in_regs = d <= L * K;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      g[v] = vecs[v];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = p + L * k;
        r[v][k] = in_regs && j < d ? widen<T>(vecs[v][j]) : T(0);
      }
    }
  }
};

// The dot-product half of a tile: a warp takes 32 / L rows at a time, one
// per group of L lanes; each lane reads its columns of its group's row at
// immediate offsets, the group sums its products by a butterfly, and its
// lanes evaluate the row's loss (so a warp works on up to four losses at
// once), the first storing the row coefficient rounded to X's type.
template <int L, typename XT, typename T, class Row, int NV>
__device__ __forceinline__ void tile_dots(const RowCoefs<XT, T, NV>& cs, Row& row,
                                          const XT* xt, const T* vy, const T* voff,
                                          const T* vwt, int rows, int d, int warp, int lane,
                                          T* coef) {
  constexpr int G = 32 / L;
  const int p = lane % L;
  for (int base = warp * G; base < rows; base += kWarps * G) {
    const int rr = base + lane / L;
    const bool ok = rr < rows;
    // a group past the tile's last row reads row 0 (finite data) and is
    // discarded
    const XT* xr = xt + (size_t)(ok ? rr : 0) * d + p;
    T m[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) m[v] = T(0);
    if (cs.in_regs) {
#pragma unroll
      for (int k = 0; k < RowCoefs<XT, T, NV>::K; ++k) {
        if (p + L * k < d) {
          const T x = widen<T>(xr[L * k]);
#pragma unroll
          for (int v = 0; v < NV; ++v) m[v] += x * cs.r[v][k];
        }
      }
    } else {
      for (int j = 0; p + j < d; j += L) {
        const T x = widen<T>(xr[j]);
#pragma unroll
        for (int v = 0; v < NV; ++v) m[v] += x * widen<T>(cs.g[v][p + j]);
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) m[v] = group_sum(m[v], L);
    if (ok) {
      const T c = row(m, vy[rr], voff[rr], vwt[rr]);
      if (p == 0) coef[rr] = Round<XT>::to(c);
    }
  }
}

// The row pipeline both kernels share.  Walks this block's rows in tiles
// through the ring; for each row, `row` turns the row's NV dot products with
// `vecs` (and its y, offset, weight) into its coefficient c; after a block
// barrier each thread folds c * x of the tile's rows into its columns
// tid + k * kThreads of the block accumulator in shared memory.  Then
// writes the block's row of partials: the accumulator, and the NS scalar
// sums that `row` keeps (its `sums()`, summed over a group's rows, the
// groups and the warps in a fixed order).
template <typename XT, typename T, int NV, int NS, class Row>
__device__ __forceinline__ void fold_rows(const GlmIn<XT, T>& in, const XT* const* vecs,
                                          Row& row, unsigned char* smem_raw,
                                          T* __restrict__ partials) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d = in.d;
  const int S = in.stages;
  const int64_t sb = stage_bytes<XT, T>(d, in.tile_rows);
  const int64_t sxb = stage_x_bytes<XT>(d, in.tile_rows);
  unsigned char* ring = smem_raw;
  T* acc = reinterpret_cast<T*>(ring + S * sb);
  T* coef = acc + d;
  T* red = coef + in.tile_rows;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem_raw + barrier_offset<XT, T>(d, in.tile_rows, S));  // one per stage
  if (tid == 0) {
    for (int k = 0; k < S; ++k) mbar_init(full + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int L = row_lanes<T>(d);
  RowCoefs<XT, T, NV> cs;
  if (L == 8)
    cs.template load<8>(vecs, d, lane % 8);
  else if (L == 16)
    cs.template load<16>(vecs, d, lane % 16);
  else
    cs.template load<32>(vecs, d, lane);
  for (int j = tid; j < d; j += kThreads) acc[j] = T(0);
  __syncthreads();  // the barriers are ready

  const int64_t row_begin = (int64_t)blockIdx.x * in.rows_per_block;
  const int64_t row_end =
      row_begin + in.rows_per_block < in.n ? row_begin + in.rows_per_block : in.n;
  const int num_tiles = (int)((row_end - row_begin + in.tile_rows - 1) / in.tile_rows);
  auto rows_of = [&](int t) {
    const int64_t left = row_end - (row_begin + (int64_t)t * in.tile_rows);
    return (int)(left < in.tile_rows ? left : in.tile_rows);
  };

  // one commit group of element copies per tile slot, empty past the last
  // tile, so that wait_group(S - 2) and the stage's barrier in phase t / S
  // always mean "tile t has landed"
  for (int t = 0; t < S - 1; ++t) {
    if (t < num_tiles)
      stage_tile(ring + t * sb, in, row_begin + (int64_t)t * in.tile_rows, rows_of(t),
                 full + t);
    cp_async_commit();
  }
  for (int t = 0; t < num_tiles; ++t) {
    cp_async_wait(S - 2);
    mbar_wait(full + t % S, (uint32_t)((t / S) & 1));
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's slot
    const int tn = t + S - 1;
    if (tn < num_tiles)
      stage_tile(ring + (tn % S) * sb, in, row_begin + (int64_t)tn * in.tile_rows,
                 rows_of(tn), full + tn % S);
    cp_async_commit();

    const int64_t r0 = row_begin + (int64_t)t * in.tile_rows;
    const int rows = rows_of(t);
    const unsigned char* stage = ring + (t % S) * sb;
    const XT* xt = reinterpret_cast<const XT*>(stage) + span_pad(in.x + r0 * d);
    const T* vy = reinterpret_cast<const T*>(stage + sxb);
    const T* voff = vy + in.tile_rows;
    const T* vwt = voff + in.tile_rows;
    if (L == 8)
      tile_dots<8>(cs, row, xt, vy, voff, vwt, rows, d, warp, lane, coef);
    else if (L == 16)
      tile_dots<16>(cs, row, xt, vy, voff, vwt, rows, d, warp, lane, coef);
    else
      tile_dots<32>(cs, row, xt, vy, voff, vwt, rows, d, warp, lane, coef);
    __syncthreads();  // the tile's coefficients are in
    for (int j = tid; j < d; j += kThreads) {
      T a = acc[j];
#pragma unroll 4
      for (int rr = 0; rr < rows; ++rr) a += coef[rr] * widen<T>(xt[(size_t)rr * d + j]);
      acc[j] = a;
    }
  }

  T sums[NS];
  row.sums(sums);
#pragma unroll
  for (int k = 0; k < NS; ++k) sums[k] = across_groups(sums[k], L);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) red[k * kWarps + warp] = sums[k];
  }
  __syncthreads();
  T* out = partials + (int64_t)blockIdx.x * (d + NS);
  for (int j = tid; j < d; j += kThreads) out[j] = acc[j];
  if (tid < NS) {
    T v = T(0);
    for (int k = 0; k < kWarps; ++k) v += red[tid * kWarps + k];
    out[d + tid] = v;
  }
}

// value and gradient: c = wt * l'(z, y), sums (sum wt * l, sum c)
template <typename T, int LOSS>
struct FvgRow {
  T shift;
  T value = T(0);
  T rsum = T(0);

  __device__ __forceinline__ T operator()(const T (&m)[1], T yv, T offv, T wtv) {
    T z = m[0] + offv + shift;
    z = wtv > T(0) ? z : T(0);  // weight-0 rows stay finite
    T l, d1;
    photon::loss_and_d1<LOSS>(z, yv, l, d1);
    const T r = wtv * d1;
    value += wtv * l;
    rsum += r;
    return r;
  }
  __device__ __forceinline__ void sums(T (&s)[2]) const {
    s[0] = value;
    s[1] = rsum;
  }
};

// Hessian-vector product: c = wt * l''(z, y) * (x.v + v_shift), sum (sum c);
// m = (x.w, x.v) from one read of the row
template <typename T, int LOSS>
struct HvpRow {
  T shift;
  T vshift;
  T qsum = T(0);

  __device__ __forceinline__ T operator()(const T (&m)[2], T yv, T offv, T wtv) {
    T z = m[0] + offv + shift;
    z = wtv > T(0) ? z : T(0);  // weight-0 rows stay finite
    const T q = wtv * photon::d2<LOSS>(z, yv) * (m[1] + vshift);
    qsum += q;
    return q;
  }
  __device__ __forceinline__ void sums(T (&s)[1]) const { s[0] = qsum; }
};

template <typename XT, typename T, int LOSS>
__global__ void __launch_bounds__(kThreads, 2)
fvg_partial_kernel(GlmIn<XT, T> in, const XT* __restrict__ w, const T* __restrict__ shift,
                   T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const XT* vecs[1] = {w};
  FvgRow<T, LOSS> row{shift[0]};
  fold_rows<XT, T, 1, 2>(in, vecs, row, smem_raw, partials);
}

template <typename XT, typename T, int LOSS>
__global__ void __launch_bounds__(kThreads, 2)
hvp_partial_kernel(GlmIn<XT, T> in, const XT* __restrict__ w, const XT* __restrict__ v,
                   const T* __restrict__ shift, const T* __restrict__ vshift,
                   T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const XT* vecs[2] = {w, v};
  HvpRow<T, LOSS> row{shift[0], vshift[0]};
  fold_rows<XT, T, 2, 1>(in, vecs, row, smem_raw, partials);
}

// out[j] = sum over blocks of partials[b, j] in a fixed order: each of 8
// groups sums blocks g, g + 8, ... in order, then the 8 group sums are added
// in order.  A block serves 32 columns.
template <typename T>
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const T* __restrict__ partials, int num_blocks, int width,
                       T* __restrict__ out) {
  __shared__ T part[8][32];
  const int c = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + c;
  T s = T(0);
  if (j < width)
    for (int b = g; b < num_blocks; b += 8) s += partials[(int64_t)b * width + j];
  part[g][c] = s;
  __syncthreads();
  if (g == 0 && j < width) {
    T t = part[0][c];
    for (int k = 1; k < 8; ++k) t += part[k][c];
    out[j] = t;
  }
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
  int stages;
  int num_blocks;
  void* partials;
  void* out;
};

template <typename XT, typename T, int LOSS, bool HVP>
int launch_typed(const GlmArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<XT, T>(a.d, a.tile_rows, a.stages);
  const GlmIn<XT, T> in{static_cast<const XT*>(a.x), static_cast<const T*>(a.y),
                        static_cast<const T*>(a.off), static_cast<const T*>(a.wt),
                        a.n, a.d, a.rows_per_block, a.tile_rows, a.stages};
  const XT* w = static_cast<const XT*>(a.w);
  const T* shift = static_cast<const T*>(a.shift);
  T* partials = static_cast<T*>(a.partials);
  auto prepare = [&](const void* kern) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)  // room for two blocks an SM where the plan asks for it
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    return err;
  };
  cudaError_t err;
  if constexpr (HVP) {
    auto kern = hvp_partial_kernel<XT, T, LOSS>;
    err = prepare(reinterpret_cast<const void*>(kern));
    if (err != cudaSuccess) return (int)err;
    kern<<<a.num_blocks, kThreads, smem, stream>>>(
        in, w, static_cast<const XT*>(a.v), shift, static_cast<const T*>(a.vshift),
        partials);
  } else {
    auto kern = fvg_partial_kernel<XT, T, LOSS>;
    err = prepare(reinterpret_cast<const void*>(kern));
    if (err != cudaSuccess) return (int)err;
    kern<<<a.num_blocks, kThreads, smem, stream>>>(in, w, shift, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = a.d + (HVP ? 1 : 2);
  reduce_partials_kernel<T><<<(width + 31) / 32, 256, 0, stream>>>(
      partials, a.num_blocks, width, static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

template <typename XT, typename T, bool HVP>
int dispatch_loss(int loss, const GlmArgs& a, cudaStream_t stream) {
  switch (loss) {
    case 0:
      return launch_typed<XT, T, 0, HVP>(a, stream);
    case 1:
      return launch_typed<XT, T, 1, HVP>(a, stream);
    case 2:
      return launch_typed<XT, T, 2, HVP>(a, stream);
    case 3:
      return launch_typed<XT, T, 3, HVP>(a, stream);
    default:
      return -1;
  }
}

// f.template run<XT, T>() for the (storage, accumulation) type codes the
// kernels take (storage equal to or narrower than accumulation); -1 for any
// other pair.
template <class F>
long long with_types(int xtype, int acctype, const F& f) {
  using photon::kBF16;
  using photon::kF16;
  using photon::kF32;
  using photon::kF64;
  if (acctype == kF32) {
    if (xtype == kF32) return f.template run<float, float>();
    if (xtype == kBF16) return f.template run<__nv_bfloat16, float>();
    if (xtype == kF16) return f.template run<__half, float>();
  } else if (acctype == kF64) {
    if (xtype == kF64) return f.template run<double, double>();
    if (xtype == kF32) return f.template run<float, double>();
    if (xtype == kBF16) return f.template run<__nv_bfloat16, double>();
    if (xtype == kF16) return f.template run<__half, double>();
  }
  return -1;
}

// The plan must give every block a nonempty range of whole tiles, and the
// blocks must cover the rows.
bool plan_ok(const GlmArgs& a) {
  return a.d >= 1 && a.n >= 1 && a.tile_rows >= 1 && a.stages >= 2 &&
         a.stages <= kMaxStages && a.num_blocks >= 1 && a.rows_per_block >= 1 &&
         a.rows_per_block % a.tile_rows == 0 &&
         (int64_t)(a.num_blocks - 1) * a.rows_per_block < a.n &&
         (int64_t)a.num_blocks * a.rows_per_block >= a.n;
}

template <bool HVP>
struct LaunchOp {
  int loss;
  const GlmArgs& a;
  cudaStream_t stream;
  template <typename XT, typename T>
  long long run() const {
    return dispatch_loss<XT, T, HVP>(loss, a, stream);
  }
};

struct SmemOp {
  int d, tile_rows, stages;
  template <typename XT, typename T>
  long long run() const {
    return (long long)smem_bytes<XT, T>(d, tile_rows, stages);
  }
};

template <bool HVP>
int dispatch(int xtype, int acctype, int loss, const GlmArgs& a, void* stream) {
  if (!plan_ok(a)) return -1;
  const LaunchOp<HVP> op{loss, a, static_cast<cudaStream_t>(stream)};
  return (int)with_types(xtype, acctype, op);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of either kernel needs (-1 for a type pair
// the kernels do not take); the wrapper checks its plan against it.
long long glm_smem_bytes(int xtype, int acctype, int d, int tile_rows, int stages) {
  return with_types(xtype, acctype, SmemOp{d, tile_rows, stages});
}

// xtype: X's (and w's) element type, acctype: the accumulation type (of y,
// off, wt, shift and the outputs); codes 0 float32, 1 float64, 2 bfloat16,
// 3 float16.  x [n, d] row-major; w [d]; y, off, wt [n]; shift [1]; partials
// [num_blocks, d + 2]; out [d + 2] = (grad, value, rsum).
int fvg_launch(int xtype, int acctype, int loss, const void* x, const void* w,
               const void* y, const void* off, const void* wt, const void* shift,
               long long n, int d, long long rows_per_block, int tile_rows, int stages,
               int num_blocks, void* partials, void* out, void* stream) {
  const GlmArgs a{x, w, nullptr, y, off, wt, shift, nullptr, n, d,
                  rows_per_block, tile_rows, stages, num_blocks, partials, out};
  return dispatch<false>(xtype, acctype, loss, a, stream);
}

// Types as fvg_launch.  x [n, d] row-major; w, v [d]; y, off, wt [n]; shift,
// vshift [1]; partials [num_blocks, d + 1]; out [d + 1] = (X^T q, sum q).
int hvp_launch(int xtype, int acctype, int loss, const void* x, const void* w,
               const void* v, const void* y, const void* off, const void* wt,
               const void* shift, const void* vshift, long long n, int d,
               long long rows_per_block, int tile_rows, int stages, int num_blocks,
               void* partials, void* out, void* stream) {
  const GlmArgs a{x, w, v, y, off, wt, shift, vshift, n, d,
                  rows_per_block, tile_rows, stages, num_blocks, partials, out};
  return dispatch<true>(xtype, acctype, loss, a, stream);
}

}  // extern "C"
