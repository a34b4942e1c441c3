// Write-only sparse row update for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrm_yx_tpu/ops/pallas_sparse_update.py,
// sparse_rows_overwrite (the blind-write pass _wkernel and the serialized
// duplicate tail _tail_kernel). For items k of one batch, in place:
//
//   the row of k occurs once among the active items:  store[idx[k]] = new_vals[k]
//   it occurs several times:  store[idx[k]] += delta[k], in ascending k
//   k is inactive:            nothing
//
// Active ids are clipped to [0, R - 9]: the last 8 (sentinel) rows are
// never written.
//
// Bound on an H100 SXM: memory. At the training shape (K = 16,384 items of
// 128 f32, all rows unique) it reads each new_vals row once and writes each
// store row once: 2 x 8.4 MB = 16.8 MB, about 5 us at 3.35 TB/s; the ids
// and flags add 0.1 MB. There is no arithmetic to speak of.
//
// On power-law ids (MLPerf's Terabyte tables, alpha 1.15) most items are
// duplicates: of K = 16,384, about 10,200 fall on some 1,190 duplicated
// rows, the longest run ~250 items. Those add in ascending k, so a run is a
// serial chain of adds a column; what bounds the call there is the longest
// run's chain, not the bytes.
//
// Design: the row plan of row_plan.cuh, in four launches and with no
// sort of the items. The plan counts each row's active occurrences in a hash
// table; an item whose row occurs once copies its new_vals row to the
// store with 16-byte loads and stores (a group of up to 32 lanes per item),
// or, when W % 4 != 0 (the packed mixed-dimension groups of widths 1 and
// 2), with one f32 a lane: row_plan::launch picks V = 4 or V = 1; the items of
// duplicated rows are placed in a segment a row, and the tail orders each
// segment by k and adds its delta rows to its row in that order, a run to
// a warp or a block all over the card, without atomics on the store: no
// sort of all K items, and no torch op around the kernels. The TPU
// kernel's DMA slot window, its redirection of dead items to a sentinel
// row and its 64-item tail blocks have no counterpart here.

#include "row_plan.cuh"

namespace {

constexpr int kClipMargin = 8;  // active ids are clipped to R - 1 - kClipMargin

// An item whose row occurs once: its new_vals row, copied.
struct CopyNewVals {
  const float* __restrict__ new_vals;

  __device__ __forceinline__ unsigned seed() const { return 0u; }

  template <int V, int G, class S>
  __device__ __forceinline__ void prefetch(const S*, int, long long k, int gl, int nv) const {
    using Raw = typename row_plan::RowVec<float, V>::Raw;
    if (gl < nv) row_plan::prefetch_l2(reinterpret_cast<const Raw*>(new_vals) + k * nv + gl);
  }

  template <int V, int G, class S>
  __device__ __forceinline__ void apply(S* __restrict__ store, int row, long long k, int,
                                        int gl, int nv, unsigned) const {
    using Raw = typename row_plan::RowVec<float, V>::Raw;
    Raw* dst = reinterpret_cast<Raw*>(store) + static_cast<long long>(row) * nv;
    const Raw* src = reinterpret_cast<const Raw*>(new_vals) + k * nv;
    for (int c = gl; c < nv; c += G) dst[c] = src[c];
  }
};

}  // namespace

// Bytes of zeroed scratch a call with K items needs (row_plan.cuh).
extern "C" long long sparse_rows_overwrite_scratch_bytes(long long K) {
  return row_plan::scratch_bytes(K);
}

// Launches the plan, apply, place and tail kernels on `stream` (a
// cudaStream_t) on device `device` and returns cudaGetLastError(): 0 on
// success. store [R, W] (R < 2^30), new_vals and delta [K, W] are
// contiguous f32, with 16-byte aligned bases when W % 4 == 0 (any W > 0);
// idx [K] int32 (idx64 = 0) or int64; active [K] int32; scratch:
// sparse_rows_overwrite_scratch_bytes(K) bytes, zero before the first call,
// which every call leaves as it needs it; counts: three int64 on the device
// (or null) that gain each call's duplicated items, runs and long runs.
extern "C" int sparse_rows_overwrite(float* store, const void* idx, int idx64,
                                     const int* active, const float* new_vals,
                                     const float* delta, void* scratch, long long* counts,
                                     long long R, long long K, int W, int device,
                                     void* stream) {
  return row_plan::launch<false>(store, idx, idx64, active, delta, scratch, counts, K,
                                 R - 1 - kClipMargin, 1, W, false, nullptr, device,
                                 static_cast<cudaStream_t>(stream), CopyNewVals{new_vals});
}
