// The row plan shared by sparse_rows_add.cu (K4) and
// sparse_rows_overwrite.cu (K2), for Hopper (sm_90a): a sparse row update of
// K items without a sort of the items.
//
// Both updates apply each active item's update to its row, in place, with
// one rule for a row that occurs once among the active items and another
// for a row that occurs several times, whose occurrences must land in a
// fixed order:
//
//   K4: store[row] = round(f32(store[row]) + upd[k]), unflagged occurrences
//       in ascending k, then flagged ones in ascending k;
//   K2: a row that occurs once: store[row] = new_vals[k]; several times:
//       store[row] += delta[k] in ascending k (K4's rule on an f32 store).
//
// Three launches per call, with no host sync; apply and tail are launched
// programmatically (Hopper's programmatic dependent launch): each may start
// while its predecessor drains and waits for it in griddepcontrol.wait, so
// the gaps between the three shrink.
//
//   plan   a thread per item: clips its id, computes K4's flag (an active
//          item of the same unit among the 63 items before it, compared in
//          shared memory with a 63-item halo: the JAX package's definition),
//          inserts the row into an open-addressing hash table of 64-bit
//          slots, (row + 1) << 32 | count: one lane for the warp's items of
//          the row, with one atomicCAS and, for a row already there, one
//          atomicAdd of their count (linear probing; P >= 16K slots, sized
//          from K, never from the store: the CAS round trips of the longest
//          probe chain set the plan's time, and a fuller table made it
//          several times slower on the H100);
//   apply  a group of G lanes per item: reads its row and slot as the plan
//          left them, prefetches its rows while it reads the count; a row
//          that occurs once is applied straight away by its item (the
//          unique functor); an item of a duplicated row appends the key
//          (row * 2 + flag) << 32 | k to a list, one atomic a block;
//   tail   one block: sorts the D listed keys by (row, flag, k), by rank
//          for a few, else with a bitonic sort (in shared memory up to
//          kSmemKeys, in the list itself past it), and walks each row's run
//          in that order: a short run with G lanes a row, a long one
//          (kLongRun items or more, a hot row of skewed traffic) with one
//          thread a column and 32 loads in flight, since each column's adds
//          are a serial chain. (A counting order, dense row ids and a stable
//          scatter by k, made no hot-row case faster on the H100: the walk
//          is their time.)
//
// So the common case, rows that occur once, sorts nothing, and the order
// of a duplicated row's adds is fixed by the keys, not by the atomics: the
// same inputs give the same bits. (A tail run by the apply kernel's last
// block, picked by a ticket counter, was slower on the H100: the walk's
// registers cut the apply kernel's occupancy, and every block waited for
// its ticket.)
//
// The scratch (scratch_bytes(K), from the caching allocator) is zero
// between calls: a row that occurs once clears its slot when its item is
// applied, the tail clears the duplicated rows' slots and resets the
// counter. So a call needs no clearing launch and can be captured in a
// CUDA graph. Calls that share one scratch must run in stream order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace row_plan {

constexpr int kThreads = 256;       // plan and apply blocks
constexpr int kTailThreads = 512;   // the tail's one block (1024 spilled the column walk)
constexpr int kWindow = 64;         // K4's look-back: an item sees the 63 before it
constexpr int kRankKeys = 512;      // duplicate keys the tail sorts by rank
constexpr long long kSmemKeys = 16384;  // ... or with a bitonic sort in shared memory
constexpr int kLongRun = 64;        // runs this long are walked a column per thread

using u64 = unsigned long long;

// Scratch, in this order: u64 table[P] ((row + 1) << 32 | the row's active
// occurrences; 0 = empty), int2 item[K] (each item's clipped row and
// slot * 2 + flag, slot -1 if inactive), int ctr[2] (ctr[0]: duplicate
// keys listed), u64 dup[pow2(K)] (the duplicate keys).
struct Scratch {
  u64* table;
  int2* item;
  int* ctr;
  u64* dup;
  int pbits;
};

inline long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

inline int table_bits(long long K) {
  int b = 6;
  while ((1LL << b) < 16 * K) ++b;
  return b;
}

// in 8-byte words
inline long long scratch_words(long long K) {
  return (1LL << table_bits(K)) + K + 1 + pow2_at_least(K);
}

inline long long scratch_bytes(long long K) { return 8 * scratch_words(K); }

inline Scratch carve(void* base, long long K) {
  const int pbits = table_bits(K);
  u64* p = static_cast<u64*>(base);
  u64* item = p + (1LL << pbits);
  return Scratch{p, reinterpret_cast<int2*>(item), reinterpret_cast<int*>(item + K),
                 item + K + 1, pbits};
}

// Waits until the grid launched before this one on the stream has finished
// and its writes are visible (launch_after lets this grid start earlier).
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// V elements of a row of type S: Raw as they lie in memory, T as f32.
template <class S, int V> struct RowVec;

template <> struct RowVec<float, 4> {
  using Raw = float4;
  using T = float4;
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ Raw store(T v) { return v; }
};

template <> struct RowVec<float, 1> {
  using Raw = float;
  using T = float;
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ Raw store(T v) { return v; }
};

template <> struct RowVec<__nv_bfloat16, 4> {
  struct alignas(8) Raw {
    __nv_bfloat162 lo, hi;
  };
  using T = float4;
  static __device__ __forceinline__ T load(Raw r) {
    const float2 a = __bfloat1622float2(r.lo), b = __bfloat1622float2(r.hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ Raw store(T v) {
    return Raw{__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  }
};

template <> struct RowVec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  using T = float;
  static __device__ __forceinline__ T load(Raw r) { return __bfloat162float(r); }
  static __device__ __forceinline__ Raw store(T v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// The seed's part of the SR hash, step * 0x9E3779B9 (mod 2^32), with the
// step read from the device, so that a CUDA-graph replay rounds with the
// step it is given and not the captured one; 0 without a step.
__device__ __forceinline__ unsigned seed_of(const long long* step) {
  return step == nullptr ? 0u : static_cast<unsigned>(*step) * 0x9E3779B9u;
}

// x rounded to the store type S, as f32: bf16 to nearest even or, when
// stochastic, u = bits(x) + (fmix32(salt) & 0xFFFF) with the low 16 bits
// of u dropped. salt = seed ^ (k * dim + element).
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

// v + u rounded to S element by element; col = k * dim + the vector's
// first element.
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

__device__ __forceinline__ int clip_row(long long id, long long hi) {
  return static_cast<int>(id < 0 ? 0 : (id > hi ? hi : id));
}

// Plan: each item's row and slot * 2 + flag (slot -1 if inactive); the
// table holds each active row once with its count. Flags (kFlags, K4
// only): an active item is flagged when an active item among the
// kWindow - 1 before it has the same unit (row / unit).
template <bool kFlags, class I>
__global__ void __launch_bounds__(kThreads)
plan_kernel(const I* __restrict__ idx, const int* __restrict__ active, long long K,
            long long hi, int unit, Scratch s) {
  __shared__ int units[kThreads + kWindow - 1];  // -1: inactive or past K
  const long long k0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long k = k0 + threadIdx.x;
  const int row = k < K && active[k] > 0 ? clip_row(idx[k], hi) : -1;
  int flag = 0;
  if constexpr (kFlags) {
    units[kWindow - 1 + threadIdx.x] = row < 0 ? -1 : row / unit;
    if (threadIdx.x < kWindow - 1) {
      const long long h = k0 - (kWindow - 1) + threadIdx.x;
      units[threadIdx.x] = h >= 0 && active[h] > 0 ? clip_row(idx[h], hi) / unit : -1;
    }
    __syncthreads();
    const int u = units[kWindow - 1 + threadIdx.x];
    for (int j = 1; j < kWindow; ++j) flag |= units[kWindow - 1 + threadIdx.x - j] == u;
  }
  // the warp's items of one row insert it once, with their count: a hot
  // row's items do not queue on its slot
  const int lane = threadIdx.x % 32;
  const unsigned peers = __match_any_sync(0xffffffffu, row >= 0 ? row : ~lane);
  const int leader = __ffs(peers) - 1;
  unsigned h = 0;
  if (row >= 0 && lane == leader) {
    const unsigned mask = (1u << s.pbits) - 1u;
    const u64 n = __popc(peers);
    h = (static_cast<unsigned>(row) * 2654435761u) >> (32 - s.pbits);
    for (;;) {
      const u64 prev = atomicCAS(&s.table[h], 0ull, (static_cast<u64>(row + 1) << 32) | n);
      if (prev == 0) break;
      if ((prev >> 32) == static_cast<u64>(row + 1)) {
        atomicAdd(&s.table[h], n);
        break;
      }
      h = (h + 1) & mask;
    }
  }
  h = __shfl_sync(0xffffffffu, h, leader);
  if (k < K) {
    s.item[k] = row < 0 ? make_int2(0, -1) : make_int2(row, static_cast<int>(h) * 2 + flag);
  }
}

template <bool kGlobal>
__device__ __forceinline__ u64 ld(const u64* p) {
  if constexpr (kGlobal) return __ldcg(p);
  else return *p;
}

template <bool kGlobal>
__device__ __forceinline__ void st(u64* p, u64 v) {
  if constexpr (kGlobal) __stcg(p, v);
  else *p = v;
}

// Sorts a[0, n) ascending (n a power of two) with the whole block; a lies
// in shared memory, or in device memory (kGlobal, read and written in L2).
template <bool kGlobal>
__device__ void bitonic_sort(u64* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kTailThreads) {
        const int l = i ^ j;
        if (l > i) {
          const u64 x = ld<kGlobal>(a + i), y = ld<kGlobal>(a + l);
          if ((x > y) == ((i & size) == 0)) {
            st<kGlobal>(a + i, y);
            st<kGlobal>(a + l, x);
          }
        }
      }
      __syncthreads();
    }
  }
}

// The row of a listed key, (row * 2 + flag) << 32 | k.
__device__ __forceinline__ int run_id(u64 key) { return static_cast<int>(key >> 33); }

// Whether the run of `row` that starts at p has kLongRun items or more.
template <bool kGlobal>
__device__ __forceinline__ bool long_run(const u64* keys, int p, int D, int row) {
  return p + kLongRun - 1 < D && run_id(ld<kGlobal>(keys + p + kLongRun - 1)) == row;
}

// Applies the ordered keys[0, D) run by run: a group of G lanes takes a run
// head, holds the row's vectors in f32 and adds the run's update rows in
// key order (unflagged occurrences in ascending k, then flagged ones),
// rounding to S after every add; SR on unflagged occurrences when sr.
template <bool kGlobal, int V, int G, class S>
__device__ void walk_runs(const u64* keys, int D, S* __restrict__ store,
                          const float* __restrict__ upd, int nv, int dim, bool sr,
                          unsigned seed, bool skip_long) {
  using RV = RowVec<S, V>;
  using T = typename RV::T;
  constexpr int kUnroll = 8;  // update rows loaded ahead of the serial adds
  const int gl = threadIdx.x % G;
  const T* u = reinterpret_cast<const T*>(upd);
  for (int p = threadIdx.x / G; p < D; p += kTailThreads / G) {
    const int row = run_id(ld<kGlobal>(keys + p));
    if (p > 0 && run_id(ld<kGlobal>(keys + p - 1)) == row) continue;
    if (skip_long && long_run<kGlobal>(keys, p, D, row)) continue;
    typename RV::Raw* dst = reinterpret_cast<typename RV::Raw*>(store) +
                            static_cast<long long>(row) * nv;
    for (int c = gl; c < nv; c += G) {
      T v = RV::load(dst[c]);
      for (int q = p;; q += kUnroll) {
        u64 key[kUnroll];
        T add[kUnroll];
        bool in[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          key[j] = q + j < D ? ld<kGlobal>(keys + q + j) : ~0ull;
          in[j] = run_id(key[j]) == row;  // the run is a prefix
          if (in[j]) add[j] = u[static_cast<long long>(static_cast<unsigned>(key[j])) * nv + c];
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (in[j]) {
            const unsigned k = static_cast<unsigned>(key[j]);
            const bool main_pass = ((key[j] >> 32) & 1) == 0;
            v = add_round<S>(v, add[j], sr && main_pass, seed,
                             k * static_cast<unsigned>(dim) + static_cast<unsigned>(c * V));
          }
        }
        if (!in[kUnroll - 1]) break;
      }
      dst[c] = RV::store(v);
    }
  }
}

// Applies the long runs of the ordered keys[0, D): a team of dim threads
// (dim <= kTailThreads) takes a run head, each thread one column of the
// row in f32, with kUnroll update elements loaded ahead of its serial adds.
template <bool kGlobal, class S>
__device__ void walk_long_runs(const u64* keys, int D, S* __restrict__ store,
                               const float* __restrict__ upd, int dim, bool sr,
                               unsigned seed) {
  using RV = RowVec<S, 1>;
  constexpr int kUnroll = 32;
  const int teams = kTailThreads / dim, team = threadIdx.x / dim, col = threadIdx.x % dim;
  if (team >= teams) return;
  for (int p = team; p < D; p += teams) {
    const int row = run_id(ld<kGlobal>(keys + p));
    if (p > 0 && run_id(ld<kGlobal>(keys + p - 1)) == row) continue;
    if (!long_run<kGlobal>(keys, p, D, row)) continue;
    typename RV::Raw* dst = reinterpret_cast<typename RV::Raw*>(store) +
                            static_cast<long long>(row) * dim + col;
    float v = RV::load(*dst);
    for (int q = p;; q += kUnroll) {
      float add[kUnroll];
      int n = 0;  // the run's items in this batch: a prefix of it
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const u64 key = q + j < D ? ld<kGlobal>(keys + q + j) : ~0ull;
        if (run_id(key) == row) {
          add[j] = upd[static_cast<long long>(static_cast<unsigned>(key)) * dim + col];
          ++n;
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n) {
          const u64 key = ld<kGlobal>(keys + q + j);
          const unsigned k = static_cast<unsigned>(key);
          v = add_round<S>(v, add[j], sr && ((key >> 32) & 1) == 0, seed,
                           k * static_cast<unsigned>(dim) + static_cast<unsigned>(col));
        }
      }
      if (n < kUnroll) break;
    }
    *dst = RV::store(v);
  }
}

// Every run of the ordered keys: the short ones G lanes a row, the long
// ones a column a thread when a row's columns fit the block.
template <bool kGlobal, int V, int G, class S>
__device__ __forceinline__ void walk_all(const u64* keys, int D, S* __restrict__ store,
                                         const float* __restrict__ upd, int nv, int dim,
                                         bool sr, unsigned seed) {
  const bool by_column = dim <= kTailThreads;
  walk_runs<kGlobal, V, G>(keys, D, store, upd, nv, dim, sr, seed, by_column);
  if (by_column) walk_long_runs<kGlobal>(keys, D, store, upd, dim, sr, seed);
}

// Zeroes the duplicated rows' table slots (keys[0, D) name their items).
__device__ __forceinline__ void clear_slots(const u64* keys, int D, const Scratch& s) {
  for (int i = threadIdx.x; i < D; i += kTailThreads) {
    s.table[s.item[static_cast<unsigned>(keys[i])].y >> 1] = 0;
  }
}

// Tail: sorts the listed duplicate keys, applies them (adding upd's rows:
// K4's upd, K2's delta, rounded to S), zeroes their table slots and resets
// the counter, so that the scratch is zero for the next call. Few keys are
// sorted by rank, more with a bitonic sort in shared memory or, past
// smem_bytes, in the list itself.
template <int V, int G, class S>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(S* __restrict__ store, const float* __restrict__ upd, int nv, int dim, bool sr,
            const long long* step, Scratch s, long long smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sk = reinterpret_cast<u64*>(smem);
  // the step was written before the plan kernel began, so it is read
  // while the grid waits for its predecessor
  const unsigned seed = sr ? seed_of(step) : 0u;
  wait_for_predecessor();
  const int D = s.ctr[0];
  if (D <= kRankKeys) {  // keys are distinct (k is): each one's rank is its place
    for (int i = threadIdx.x; i < D; i += kTailThreads) sk[kRankKeys + i] = s.dup[i];
    __syncthreads();
    clear_slots(sk + kRankKeys, D, s);
    for (int i = threadIdx.x; i < D; i += kTailThreads) {
      const u64 key = sk[kRankKeys + i];
      int rank = 0;
      for (int j = 0; j < D; ++j) rank += sk[kRankKeys + j] < key;
      sk[rank] = key;
    }
    __syncthreads();
    walk_all<false, V, G>(sk, D, store, upd, nv, dim, sr, seed);
  } else {
    clear_slots(s.dup, D, s);
    int n = 1;
    while (n < D) n <<= 1;
    const bool in_smem = 8ll * n <= smem_bytes;
    for (int i = threadIdx.x; i < n; i += kTailThreads) {
      const u64 key = i < D ? s.dup[i] : ~0ull;  // padding sorts last
      if (in_smem) {
        sk[i] = key;
      } else if (i >= D) {
        __stcg(&s.dup[i], key);
      }
    }
    __syncthreads();
    if (in_smem) {
      bitonic_sort<false>(sk, n);
      walk_all<false, V, G>(sk, D, store, upd, nv, dim, sr, seed);
    } else {
      bitonic_sort<true>(s.dup, n);
      walk_all<true, V, G>(s.dup, D, store, upd, nv, dim, sr, seed);
    }
  }
  if (threadIdx.x == 0) s.ctr[0] = 0;  // every thread read D before the first sync
}

// Dynamic shared memory for the tail of K items: a power of two of keys,
// enough for the rank sort and for a bitonic sort of up to kSmemKeys.
inline long long tail_smem_bytes(long long K) {
  return 8 * std::min(std::max(pow2_at_least(K), 2LL * kRankKeys), kSmemKeys);
}

// Apply: G lanes per item. Unique::prefetch<V, G>(store, row, k, gl, nv)
// asks L2 for the item's rows; Unique::apply<V, G>(store, row, k, flag, gl,
// nv, seed) applies an item whose row occurs once (every lane of the group
// calls both), with seed = Unique::seed(), read before the grid waits for
// its predecessor; the items of duplicated rows are listed for the tail.
template <int V, int G, class S, class Unique>
__global__ void __launch_bounds__(kThreads)
apply_kernel(S* __restrict__ store, long long K, int nv, Scratch s, Unique unique) {
  const long long k = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int gl = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << (lane & ~(G - 1));
  const unsigned seed = unique.seed();  // written before the plan kernel began
  wait_for_predecessor();
  const int2 plan = k < K ? s.item[k] : make_int2(0, -1);
  const int row = plan.x, slot = plan.y >> 1, flag = plan.y & 1;
  int n = 0;
  if (plan.y >= 0) {
    unique.template prefetch<V, G>(store, row, k, gl, nv);
    if (gl == 0) n = static_cast<int>(s.table[slot] & 0xffffffffull);
    n = __shfl_sync(gmask, n, 0, G);
    if (n == 1) {
      unique.template apply<V, G>(store, row, k, flag, gl, nv, seed);
      if (gl == 0) s.table[slot] = 0;  // no other item reads this slot
    }
  }
  // the block's duplicate items take their places in the list with one
  // atomic a block (a hot row's items would queue on the counter)
  __shared__ int listed, base;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();
  const int at = n > 1 && gl == 0 ? atomicAdd(&listed, 1) : -1;
  __syncthreads();
  if (threadIdx.x == 0 && listed > 0) base = atomicAdd(&s.ctr[0], listed);
  __syncthreads();
  if (at >= 0) {
    s.dup[base + at] = (static_cast<u64>(row * 2 + flag) << 32) | static_cast<u64>(k);
  }
}

// Launches kernel<<<blocks, threads, smem, stream>>>(args...), allowed to
// start while the kernel before it on the stream drains (it waits for it
// with wait_for_predecessor).
template <class... Params, class... Args>
cudaError_t launch_after(void (*kernel)(Params...), unsigned blocks, int threads, size_t smem,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Launches the plan, apply and tail kernels for K items (ids int32, or int64
// when idx64) on `stream` on device `device`; active ids are clipped to
// [0, hi]; K < 2^26 (the table's slot ids); with sr, the tail reads the
// SR step from the device at `step` (seed_of). Returns the first launch
// error, or cudaGetLastError(): 0 on success.
template <bool kFlags, class S, class Unique>
int launch(S* store, const void* idx, int idx64, const int* active, const float* dup_upd,
           void* scratch, long long K, long long hi, int unit, int dim, bool sr,
           const long long* step, int device, cudaStream_t stream, Unique unique) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K == 0 || dim == 0) return 0;
  const Scratch s = carve(scratch, K);
  const unsigned plan_blocks = static_cast<unsigned>((K + kThreads - 1) / kThreads);
  if (idx64) {
    plan_kernel<kFlags><<<plan_blocks, kThreads, 0, stream>>>(
        static_cast<const long long*>(idx), active, K, hi, unit, s);
  } else {
    plan_kernel<kFlags><<<plan_blocks, kThreads, 0, stream>>>(static_cast<const int*>(idx),
                                                              active, K, hi, unit, s);
  }
  cudaError_t launch_err = cudaSuccess;
  const auto go = [&](auto v, auto g, int nv) {
    constexpr int V = decltype(v)::value, G = decltype(g)::value;
    const unsigned blocks = static_cast<unsigned>((K * G + kThreads - 1) / kThreads);
    // a launch with more than 48 KB of shared memory needs the kernel's
    // attribute, set once a device
    static bool allowed[64] = {};
    cudaError_t e = cudaSuccess;
    if (device >= 64 || !allowed[device]) {
      e = cudaFuncSetAttribute(tail_kernel<V, G, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               8 * kSmemKeys);
      if (e == cudaSuccess && device < 64) allowed[device] = true;
    }
    const long long smem = tail_smem_bytes(K);
    if (e == cudaSuccess) {
      e = launch_after(apply_kernel<V, G, S, Unique>, blocks, kThreads, 0, stream, store, K, nv,
                       s, unique);
    }
    if (e == cudaSuccess) {
      e = launch_after(tail_kernel<V, G, S>, 1, kTailThreads, static_cast<size_t>(smem), stream,
                       store, dup_upd, nv, dim, sr, step, s, smem);
    }
    if (launch_err == cudaSuccess) launch_err = e;
  };
  const auto groups = [&](auto v, int nv) {
    using I = std::integral_constant<int, 1>;
    if (nv <= 1) return go(v, I{}, nv);
    if (nv <= 2) return go(v, std::integral_constant<int, 2>{}, nv);
    if (nv <= 4) return go(v, std::integral_constant<int, 4>{}, nv);
    if (nv <= 8) return go(v, std::integral_constant<int, 8>{}, nv);
    if (nv <= 16) return go(v, std::integral_constant<int, 16>{}, nv);
    return go(v, std::integral_constant<int, 32>{}, nv);
  };
  if (dim % 4 == 0) {
    groups(std::integral_constant<int, 4>{}, dim / 4);
  } else {
    groups(std::integral_constant<int, 1>{}, dim);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launch_err != cudaSuccess ? launch_err : last);
}

}  // namespace row_plan
