// Sorted-stream sparse row update with the value expansion folded in, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel sorted_stream_apply of
// dlrm_yx_tpu/ops/pallas_stream_update.py (_apply_kernel), the high-L
// (multi-hot) update of the embedding stores. In place, for k ascending:
//
//   store[pos[k]] += w[k] * gtab[seg[k]]     (pos[k] outside [0, R): dropped)
//
// store [R, dim] and gtab [S, dim] are f32 rows; pos [K] int32 is sorted
// ascending, so the occurrences of one row are neighbours (a run); seg [K]
// int32 names the pooled-gradient row of each occurrence and w [K] f32 its
// weight, with the optimizer's scalars folded in. Each product is rounded
// before it is added (__fmul_rn, __fadd_rn: nvcc would otherwise contract
// the two into an FMA), as the JAX package and the plain version round it.
//
// Bound on an H100 SXM: memory. At the reference's L=100 benchmark (8
// tables of 1M rows, dim 64, batch 2048) K = 1,638,400 occurrences fall on
// about 1.48M distinct rows, but half the occurrences are weight-0 padding:
// only the ~0.79M rows with a nonzero weight need reading and writing
// (512 B each), with the scalar streams read once (12 B an occurrence) and
// the 4 MB grad table once; about 0.43 GB, 0.13 ms at 3.35 TB/s. This kernel
// moves every distinct row (0.78 GB), which keeps a non-finite gradient's
// NaN in a weight-0 row as the JAX kernel does. The arithmetic (two
// operations an element) is far below the f32 rate.
//
// Design: the run walk of sorted_stream.cuh. Each lane of a walk step loads
// one occurrence's (seg, w), shuffles hand them to the group in order, and
// the grad-table rows come from L2. The TPU kernel's full-store block
// stream, its VMEM-resident grad table, the scalar chunk ping-pong, the CHP
// sentinel padding and the lane sub-slot of packed rows have no
// counterpart: the port's stores are logical rows.

#include "sorted_stream.cuh"

namespace {

using sorted_stream::kThreads;

__device__ __forceinline__ float add_product(float a, float g, float w) {
  return __fadd_rn(a, __fmul_rn(g, w));
}

__device__ __forceinline__ float4 add_product(float4 a, float4 g, float w) {
  a.x = __fadd_rn(a.x, __fmul_rn(g.x, w));
  a.y = __fadd_rn(a.y, __fmul_rn(g.y, w));
  a.z = __fadd_rn(a.z, __fmul_rn(g.z, w));
  a.w = __fadd_rn(a.w, __fmul_rn(g.w, w));
  return a;
}

// Occurrence k's row: w[k] * gtab[seg[k]].
struct WeightedGradRow {
  const int* __restrict__ seg;
  const float* __restrict__ w;
  const float* __restrict__ gtab;

  struct Item {
    int s;
    float w;
  };

  __device__ __forceinline__ Item load(long long q, bool in) const {
    return in ? Item{seg[q], w[q]} : Item{0, 0.f};
  }

  template <int G, class T>
  __device__ __forceinline__ T add_step(T v, Item item, long long, int n, int c, int nv,
                                   bool has, unsigned gmask) const {
    const T* g = reinterpret_cast<const T*>(gtab);
    for (int j = 0; j < n; ++j) {
      const int sj = __shfl_sync(gmask, item.s, j, G);
      const float wj = __shfl_sync(gmask, item.w, j, G);
      if (has) v = add_product(v, g[static_cast<long long>(sj) * nv + c], wj);
    }
    return v;
  }
};

template <int V, int G>
__global__ void __launch_bounds__(kThreads)
sorted_stream_apply_kernel(float* __restrict__ store, const int* __restrict__ pos,
                           const int* __restrict__ seg, const float* __restrict__ w,
                           const float* __restrict__ gtab, long long R, long long K,
                           int nv) {
  sorted_stream::apply_runs<V, G>(store, pos, R, K, nv, WeightedGradRow{seg, w, gtab});
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. store [R, dim], gtab [S, dim]
// contiguous f32 (16-byte aligned when dim % 4 == 0); pos, seg [K] int32,
// w [K] f32; pos ascending; seg in [0, S).
extern "C" int sorted_stream_apply(float* store, const int* pos, const int* seg,
                                   const float* w, const float* gtab, long long R,
                                   long long K, int dim, int device, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return sorted_stream::launch_for_dim(K, dim, device, [&](auto v, auto g, int nv,
                                                           unsigned blocks) {
    sorted_stream_apply_kernel<decltype(v)::value, decltype(g)::value>
        <<<blocks, kThreads, 0, s>>>(store, pos, seg, w, gtab, R, K, nv);
  });
}
