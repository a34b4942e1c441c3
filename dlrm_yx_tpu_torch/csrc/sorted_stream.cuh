// The run walk shared by sorted_stream_apply.cu (K5) and
// sorted_stream_add.cu (K6), for Hopper (sm_90a). In place, for k
// ascending:
//
//   store[row(k)] += (update row of occurrence k)     (row(k) outside [0, R): dropped)
//
// store [R, dim] is f32 rows; row(k) = pos[k], where pos [K] is sorted
// ascending, so the occurrences of one row are neighbours (a run).
//
// A group of G lanes (the power of two that covers the row's vectors, at
// most a warp) takes one sorted position. A position that is not the head
// of its run returns. A run head holds its row in registers, one vector of
// V elements a lane (16 bytes of f32 when dim % 4 == 0), adds the run's
// update rows in ascending k and stores the row once: duplicates are exact
// and deterministic, with no atomics and no second launch. The run is
// walked G occurrences at a time: each lane loads one occurrence and a
// ballot finds where the run ends. Only the rows that occur move. dim == 1
// (a 1-D accumulator viewed as [R, 1]) runs with V = 1 and G = 1.
//
// An update Op says where occurrence k's row comes from:
//   Op::Item                         what a lane loads for its occurrence
//   Item load(q, in)                 occurrence q's item; in: q is in the run
//   T add_step<G>(v, item, q0, n, c, nv, has, gmask)
//                                    v plus vector c of the rows of occurrences
//                                    q0 .. q0 + n - 1, in order (occurrence q0 + j's
//                                    item is lane j's); called by every lane of the
//                                    group, has = (c < nv); T is float4 or float

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace sorted_stream {

constexpr int kThreads = 256;

// V elements of an f32 store: Raw as they lie in memory, T as held.
template <class S, int V> struct StoreVec;

template <> struct StoreVec<float, 4> {
  using Raw = float4;
  using T = float4;
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ Raw store(T v) { return v; }
};

template <> struct StoreVec<float, 1> {
  using Raw = float;
  using T = float;
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ Raw store(T v) { return v; }
};

// The body of a kernel instance: V elements a vector, nv vectors a row, G
// lanes a position.
template <int V, int G, class S, class P, class Op>
__device__ __forceinline__ void apply_runs(S* __restrict__ store, const P* __restrict__ pos,
                                           long long R, long long K, int nv, const Op& op) {
  using SV = StoreVec<S, V>;
  using T = typename SV::T;
  const long long p =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (p >= K) return;
  const long long row = pos[p];
  if (row < 0 || row >= R) return;
  if (p > 0 && pos[p - 1] == row) return;  // the head applies the run
  const int gl = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << (lane & ~(G - 1));
  typename SV::Raw* dst = reinterpret_cast<typename SV::Raw*>(store) + row * nv;
  for (int c0 = 0; c0 < nv; c0 += G) {
    const int c = c0 + gl;
    const bool has = c < nv;
    T v{};
    if (has) v = SV::load(dst[c]);
    for (long long q0 = p;; q0 += G) {
      const long long q = q0 + gl;
      // the run is a prefix of the lanes
      const bool in = q < K && pos[q] == row;
      const typename Op::Item item = op.load(q, in);
      const int n = __popc(__ballot_sync(gmask, in));
      v = op.template add_step<G>(v, item, q0, n, c, nv, has, gmask);
      if (n < G) break;
    }
    if (has) dst[c] = SV::store(v);
  }
}

template <int V, class Launch>
void launch_groups(long long K, int nv, Launch& launch) {
  const auto go = [&](auto g) {
    constexpr int G = decltype(g)::value;
    const long long blocks = (K * G + kThreads - 1) / kThreads;
    launch(std::integral_constant<int, V>{}, g, nv, static_cast<unsigned>(blocks));
  };
  if (nv <= 1) return go(std::integral_constant<int, 1>{});
  if (nv <= 2) return go(std::integral_constant<int, 2>{});
  if (nv <= 4) return go(std::integral_constant<int, 4>{});
  if (nv <= 8) return go(std::integral_constant<int, 8>{});
  if (nv <= 16) return go(std::integral_constant<int, 16>{});
  return go(std::integral_constant<int, 32>{});
}

// Sets the device and calls launch(V, G, nv, blocks) (V and G as
// std::integral_constant) for the instance that suits dim; returns
// cudaGetLastError(): 0 on success.
template <class Launch>
int launch_for_dim(long long K, int dim, int device, Launch launch) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K == 0 || dim == 0) return 0;
  if (dim % 4 == 0) {
    launch_groups<4>(K, dim / 4, launch);
  } else {
    launch_groups<1>(K, dim, launch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sorted_stream
