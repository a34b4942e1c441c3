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
// murmur3's fmix32 of seed ^ (k * dim + element), where the wrapper passes
// seed = step * 0x9E3779B9 (32-bit); the plain version in
// ops/sparse_rows_add.py draws the same bits.
//
// The wrapper (ops/sparse_rows_add.py) hands the kernel the active items
// sorted by key = row * 2 + flag with a stable sort (inactive items last,
// with key 2R), and perm, the item each sorted position came from. A row's
// occurrences are then neighbours, its unflagged ones (the JAX kernel's
// main pass) in ascending k and then its flagged ones (the JAX tail) in
// ascending k: the order in which the JAX kernel applies them, which a
// bf16 store's per-add rounding makes part of the result.
//
// Bound on an H100 SXM: memory. At the capacity config's shape (a bf16
// store of 53,942,848 x 128, one batch's K = 16,384 mostly distinct rows)
// it reads the f32 update rows once (8.4 MB), the touched bf16 rows once
// and writes them once (2 x 4.2 MB), and the keys and the order (0.2 MB):
// about 17 MB, 5 us at 3.35 TB/s. The 1-D momentum accumulator (f32, dim 1)
// moves 16 bytes an item. One add and one rounding an element are far below
// the card's f32 rate.
//
// Design: the run walk of sorted_stream.cuh, with the row read in its
// store type and held in f32; each occurrence's add is rounded to the
// store's type before the next one. The TPU kernels' DMA slot window, 8-row
// bf16 transfer units, sentinel redirection, block skipping and SMEM
// chunking have no counterpart: only the touched rows move, and the sort
// stands in for the window's hazard handling.

#include "sorted_stream.cuh"

#include <cuda_bf16.h>

namespace {

using sorted_stream::kThreads;

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// x rounded to the store type S, as f32. salt = seed ^ (k * dim + element).
template <class S>
__device__ __forceinline__ float round_to(float x, bool stochastic, unsigned salt) {
  if constexpr (std::is_same_v<S, float>) {
    return x;
  } else {
    if (stochastic) {
      const unsigned u = __float_as_uint(x) + (fmix32(salt) & 0xFFFFu);
      return __uint_as_float(u & 0xFFFF0000u);
    }
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// v + u rounded to S element by element; element e's salt is base ^ e's
// index in the row (base = seed, col = the vector's first element).
template <class S>
__device__ __forceinline__ float add_round(float v, float u, bool sr, unsigned seed,
                                           unsigned col) {
  return round_to<S>(__fadd_rn(v, u), sr, seed ^ col);
}

template <class S>
__device__ __forceinline__ float4 add_round(float4 v, float4 u, bool sr, unsigned seed,
                                            unsigned col) {
  v.x = round_to<S>(__fadd_rn(v.x, u.x), sr, seed ^ col);
  v.y = round_to<S>(__fadd_rn(v.y, u.y), sr, seed ^ (col + 1));
  v.z = round_to<S>(__fadd_rn(v.z, u.z), sr, seed ^ (col + 2));
  v.w = round_to<S>(__fadd_rn(v.w, u.w), sr, seed ^ (col + 3));
  return v;
}

// Occurrence q's row: upd[perm[q]], rounded to S after the add; key[q]'s
// low bit is the JAX tail's flag.
template <class S, class P>
struct RoundedRowAdd {
  const P* __restrict__ key;
  const long long* __restrict__ perm;
  const float* __restrict__ upd;
  int dim;
  bool stochastic;
  unsigned seed;

  struct Item {
    long long k;
    int main_pass;
  };

  __device__ __forceinline__ Item load(long long q, bool in) const {
    return in ? Item{perm[q], static_cast<int>((key[q] & 1) == 0)} : Item{0, 0};
  }

  template <int G, class T>
  __device__ __forceinline__ T add_step(T v, Item item, long long, int n, int c, int nv,
                                        bool has, unsigned gmask) const {
    constexpr int V = sizeof(T) / sizeof(float);
    const T* u = reinterpret_cast<const T*>(upd);
    for (int j = 0; j < n; ++j) {
      const long long kj = __shfl_sync(gmask, item.k, j, G);
      const int mj = __shfl_sync(gmask, item.main_pass, j, G);
      if (has) {
        const unsigned col = static_cast<unsigned>(kj) * static_cast<unsigned>(dim) +
                             static_cast<unsigned>(c * V);
        v = add_round<S>(v, u[kj * nv + c], stochastic && mj, seed, col);
      }
    }
    return v;
  }
};

template <int V, int G, class S, class P>
__global__ void __launch_bounds__(kThreads)
sparse_rows_add_kernel(S* __restrict__ store, const P* __restrict__ key,
                       const long long* __restrict__ perm, const float* __restrict__ upd,
                       long long R, long long K, int nv, int dim, bool stochastic,
                       unsigned seed) {
  sorted_stream::apply_runs<V, G>(store, key, R, K, nv,
                                  RoundedRowAdd<S, P>{key, perm, upd, dim, stochastic, seed},
                                  1);
}

template <class S, class P>
int launch(S* store, const P* key, const long long* perm, const float* upd, long long R,
           long long K, int dim, bool stochastic, unsigned seed, int device,
           cudaStream_t stream) {
  return sorted_stream::launch_for_dim(K, dim, device, [&](auto v, auto g, int nv,
                                                           unsigned blocks) {
    sparse_rows_add_kernel<decltype(v)::value, decltype(g)::value, S, P>
        <<<blocks, kThreads, 0, stream>>>(store, key, perm, upd, R, K, nv, dim, stochastic,
                                          seed);
  });
}

template <class S>
int launch_keys(S* store, const void* key, int key64, const long long* perm,
                const float* upd, long long R, long long K, int dim, bool stochastic,
                unsigned seed, int device, cudaStream_t stream) {
  if (key64) {
    return launch(store, static_cast<const long long*>(key), perm, upd, R, K, dim,
                  stochastic, seed, device, stream);
  }
  return launch(store, static_cast<const int*>(key), perm, upd, R, K, dim, stochastic, seed,
                device, stream);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. store [R, dim] contiguous f32
// (bf16 = 0) or bf16 (bf16 = 1); upd [K, dim] contiguous f32 (16-byte
// aligned rows and an aligned store when dim % 4 == 0); key [K] ascending,
// int32 (key64 = 0) or int64; perm [K] int64; stochastic rounding applies
// to a bf16 store only.
extern "C" int sparse_rows_add(void* store, int bf16, const void* key, int key64,
                               const long long* perm, const float* upd, long long R,
                               long long K, int dim, int stochastic, unsigned seed,
                               int device, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_keys(static_cast<__nv_bfloat16*>(store), key, key64, perm, upd, R, K, dim,
                       stochastic != 0, seed, device, s);
  }
  return launch_keys(static_cast<float*>(store), key, key64, perm, upd, R, K, dim, false, seed,
                     device, s);
}
