// Row read-modify-write sparse update, rounded after every add, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of sparse_rows_add in
// dlrm_yx_tpu/ops/pallas_sparse_update.py (the RMW pass _kernel and the
// serialized tail _tail_kernel). In place, for the active items k of one
// batch:
//
//   v = f32(store[row(k)]) + upd[k];  store[row(k)] = round(v)
//
// round is the store's type: nothing for f32; for bf16 nearest even, or,
// with stochastic rounding on an occurrence of the JAX kernel's main pass,
// u = bits(v) + (r & 0xFFFF) with the low 16 bits of u dropped. r is
// murmur3's fmix32 of seed ^ (k * dim + element), where seed = step *
// 0x9E3779B9 (32-bit) and the kernels read the step (an int64) from device
// memory, so that a CUDA-graph replay rounds with the step of its dispatch;
// the plain version in ops/sparse_rows_add.py draws the same bits.
//
// Order: a row's occurrences land as the JAX kernel applies them, its
// unflagged ones (the main pass) in ascending k and then its flagged ones
// (the tail) in ascending k; an active item is flagged when an active item
// of its transfer unit (unit rows: 1 for f32, 8 for bf16, times 128 / dim
// for a packed dim) is among the 63 items before it. Ids are clipped to
// [0, R - 1 - unit]: the last unit is never written.
//
// Bound on an H100 SXM: memory. At the capacity config's shape (a bf16
// store of 53,942,848 x 128, one batch's K = 16,384 mostly distinct rows)
// it reads the f32 update rows once (8.4 MB), the touched bf16 rows once
// and writes them once (2 x 4.2 MB), and the ids and flags (0.1 MB): about
// 17 MB, 5 us at 3.35 TB/s. The 1-D momentum accumulator (f32, dim 1)
// moves 16 bytes an item. One add and one rounding an element are far below
// the card's f32 rate.
//
// Design: the row plan of row_plan.cuh, in four launches and with no
// sort of the items. The plan computes the flags by the JAX package's own
// window compare (63 compares an item in shared memory) and counts each
// row's occurrences in a hash table; an item whose row occurs once reads,
// adds, rounds (SR by its own flag) and writes its row at once; only the
// items of duplicated rows are placed in a segment a row, each segment
// ordered by (flag, k) and walked in that order, a run to a warp or a
// block all over the card (a hot row's serial chain of adds bounds the
// tail): no sort of all K items, and no torch op around the kernels.
// The TPU kernels' DMA slot window, sentinel redirection, block skipping
// and SMEM chunking have no counterpart: only the touched rows move.

#include "row_plan.cuh"

namespace {

using row_plan::RowVec;

// An item whose row occurs once: its row plus upd[k], rounded to S (SR when
// sr and the item is unflagged).
struct RoundedRowAdd {
  const float* __restrict__ upd;
  int dim;
  bool sr;
  const long long* step;  // the SR step, on the device (read only when sr)

  __device__ __forceinline__ unsigned seed() const { return sr ? row_plan::seed_of(step) : 0u; }

  template <int V, int G, class S>
  __device__ __forceinline__ void prefetch(const S* store, int row, long long k, int gl,
                                           int nv) const {
    using RV = RowVec<S, V>;
    if (gl < nv) {
      row_plan::prefetch_l2(reinterpret_cast<const typename RV::Raw*>(store) +
                            static_cast<long long>(row) * nv + gl);
      row_plan::prefetch_l2(reinterpret_cast<const typename RV::T*>(upd) + k * nv + gl);
    }
  }

  template <int V, int G, class S>
  __device__ __forceinline__ void apply(S* __restrict__ store, int row, long long k, int flag,
                                        int gl, int nv, unsigned seed) const {
    using RV = RowVec<S, V>;
    typename RV::Raw* dst = reinterpret_cast<typename RV::Raw*>(store) +
                            static_cast<long long>(row) * nv;
    const typename RV::T* u = reinterpret_cast<const typename RV::T*>(upd) + k * nv;
    const unsigned col = static_cast<unsigned>(k) * static_cast<unsigned>(dim);
    for (int c = gl; c < nv; c += G) {
      dst[c] = RV::store(row_plan::add_round<S>(RV::load(dst[c]), u[c], sr && !flag, seed,
                                                col + static_cast<unsigned>(c * V)));
    }
  }
};

template <class S>
int launch(S* store, const void* idx, int idx64, const int* active, const float* upd,
           void* scratch, long long* counts, long long R, long long K, int dim, int unit,
           bool sr, const long long* step, int device, cudaStream_t stream) {
  return row_plan::launch<true>(store, idx, idx64, active, upd, scratch, counts, K,
                                R - 1 - unit, unit, dim, sr, step, device, stream,
                                RoundedRowAdd{upd, dim, sr, step});
}

}  // namespace

// Bytes of zeroed scratch a call with K items needs (row_plan.cuh).
extern "C" long long sparse_rows_add_scratch_bytes(long long K) {
  return row_plan::scratch_bytes(K);
}

// Launches the plan, apply, place and tail kernels on `stream` (a
// cudaStream_t) on device `device` and returns cudaGetLastError(): 0 on
// success. store [R, dim] contiguous f32 (bf16 = 0) or bf16 (bf16 = 1),
// R < 2^30 a whole number of `unit`-row units; idx [K] int32 (idx64 = 0) or
// int64; active [K] int32; upd [K, dim] contiguous f32 (16-byte aligned
// rows and an aligned store when dim % 4 == 0); scratch:
// sparse_rows_add_scratch_bytes(K) bytes, zero before the first call, which
// every call leaves as it needs it; counts: three int64 on the device (or
// null) that gain each call's duplicated items, runs and long runs.
// Stochastic rounding applies to a bf16 store only, with the step read
// from `step` (one int64 on the device; unread, and may be null, without
// SR).
extern "C" int sparse_rows_add(void* store, int bf16, const void* idx, int idx64,
                               const int* active, const float* upd, void* scratch,
                               long long* counts, long long R, long long K, int dim, int unit,
                               int stochastic, const long long* step, int device,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(static_cast<__nv_bfloat16*>(store), idx, idx64, active, upd, scratch, counts,
                  R, K, dim, unit, stochastic != 0, step, device, s);
  }
  return launch(static_cast<float*>(store), idx, idx64, active, upd, scratch, counts, R, K,
                dim, unit, false, nullptr, device, s);
}
