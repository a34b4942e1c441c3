// The run walk shared by sorted_stream_apply.cu (K5) and sorted_stream_add.cu
// (K6), for Hopper (sm_90a). In place, for k ascending:
//
//   store[pos[k]] += (update row of occurrence k)     (pos[k] outside [0, R): dropped)
//
// store [R, dim] is f32 rows; pos [K] int32 is sorted ascending, so the
// occurrences of one row are neighbours (a run).
//
// A group of G lanes (the power of two that covers the row's vectors, at
// most a warp) takes one sorted position. A position that is not the head
// of its run (pos[p - 1] == pos[p]) returns. A run head holds its row in
// registers, one 16-byte vector a lane when dim % 4 == 0, adds the run's
// update rows in ascending k and stores the row once: duplicates are exact
// and deterministic, with no atomics and no second launch. The run is
// walked G occurrences at a time: each lane loads one occurrence and a
// ballot finds where the run ends. Only the rows that occur move.
//
// An update Op says where occurrence k's row comes from:
//   Op::Item                         what a lane loads for its occurrence
//   Item load(q, in)                 occurrence q's item; in: q is in the run
//   T add_step<G>(v, item, q0, n, c, nv, has, gmask)
//                                    v plus vector c of the rows of occurrences
//                                    q0 .. q0 + n - 1, in order (occurrence q0 + j's
//                                    item is lane j's); called by every lane of the
//                                    group, has = (c < nv)

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace sorted_stream {

constexpr int kThreads = 256;

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

// The body of a kernel instance: V floats a vector, nv vectors a row, G
// lanes a position.
template <int V, int G, class Op>
__device__ __forceinline__ void apply_runs(float* __restrict__ store,
                                           const int* __restrict__ pos, long long R,
                                           long long K, int nv, const Op& op) {
  using T = typename Vec<V>::T;
  const long long p =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (p >= K) return;
  const int row = pos[p];
  if (row < 0 || row >= R) return;
  if (p > 0 && pos[p - 1] == row) return;  // the run's head applies the run
  const int gl = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << (lane & ~(G - 1));
  T* dst = reinterpret_cast<T*>(store) + static_cast<long long>(row) * nv;
  for (int c0 = 0; c0 < nv; c0 += G) {
    const int c = c0 + gl;
    const bool has = c < nv;
    T v{};
    if (has) v = dst[c];
    for (long long q0 = p;; q0 += G) {
      const long long q = q0 + gl;
      const bool in = q < K && pos[q] == row;  // the run is a prefix of the lanes
      const typename Op::Item item = op.load(q, in);
      const int n = __popc(__ballot_sync(gmask, in));
      v = op.template add_step<G>(v, item, q0, n, c, nv, has, gmask);
      if (n < G) break;
    }
    if (has) dst[c] = v;
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
