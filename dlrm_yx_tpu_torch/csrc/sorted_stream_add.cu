// Sorted-stream sparse row update of expanded rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel sorted_stream_add of
// dlrm_yx_tpu/ops/pallas_stream_update.py (_kernel), the high-L update's
// route when the pooled-gradient table is too big for sorted_stream_apply
// (GTAB_MAX_BYTES). In place, for k ascending:
//
//   store[pos[k]] += upd[k]     (pos[k] outside [0, R): dropped)
//
// store [R, dim] and upd [K, dim] are f32 rows; pos [K] int32 is sorted
// ascending, so the occurrences of one row are neighbours (a run).
//
// Bound on an H100 SXM: memory. At the reference's L=100 benchmark at batch
// 4096 (8 tables of 1M rows, dim 64) K = 3,276,800 update rows of 256 B are
// read once (0.84 GB), the ids once (13 MB), and each of the ~2.69M
// distinct rows is read and written once (1.38 GB): about 2.2 GB, 0.66 ms
// at 3.35 TB/s. One add an element is far below the f32 rate.
//
// Design: the run walk of sorted_stream.cuh; a run's update rows are
// neighbours in upd too, so they stream. The TPU kernel's full-store block
// stream, its chunked DMAs and the CHP sentinel padding have no
// counterpart.

#include "sorted_stream.cuh"

namespace {

using sorted_stream::kThreads;

__device__ __forceinline__ float add_rn(float a, float u) { return __fadd_rn(a, u); }

__device__ __forceinline__ float4 add_rn(float4 a, float4 u) {
  a.x = __fadd_rn(a.x, u.x);
  a.y = __fadd_rn(a.y, u.y);
  a.z = __fadd_rn(a.z, u.z);
  a.w = __fadd_rn(a.w, u.w);
  return a;
}

// Occurrence k's row: upd[k].
struct UpdateRow {
  const float* __restrict__ upd;

  struct Item {};

  __device__ __forceinline__ Item load(long long, bool) const { return {}; }

  template <int G, class T>
  __device__ __forceinline__ T add_step(T v, Item, long long q0, int n, int c, int nv, bool has,
                                   unsigned) const {
    const T* u = reinterpret_cast<const T*>(upd);
    if (has) {
      for (int j = 0; j < n; ++j) v = add_rn(v, u[(q0 + j) * nv + c]);
    }
    return v;
  }
};

template <int V, int G>
__global__ void __launch_bounds__(kThreads)
sorted_stream_add_kernel(float* __restrict__ store, const int* __restrict__ pos,
                         const float* __restrict__ upd, long long R, long long K,
                         int nv) {
  sorted_stream::apply_runs<V, G>(store, pos, R, K, nv, UpdateRow{upd});
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. store [R, dim], upd [K, dim]
// contiguous f32 (16-byte aligned when dim % 4 == 0); pos [K] int32
// ascending.
extern "C" int sorted_stream_add(float* store, const int* pos, const float* upd,
                                 long long R, long long K, int dim, int device,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return sorted_stream::launch_for_dim(K, dim, device, [&](auto v, auto g, int nv,
                                                           unsigned blocks) {
    sorted_stream_add_kernel<decltype(v)::value, decltype(g)::value>
        <<<blocks, kThreads, 0, s>>>(store, pos, upd, R, K, nv);
  });
}
