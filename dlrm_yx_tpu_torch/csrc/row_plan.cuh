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
// Four launches per call, with no host sync; apply, place and tail are
// launched programmatically (Hopper's programmatic dependent launch): each
// may start while its predecessor drains and waits for it in
// griddepcontrol.wait, so the gaps between the four shrink. (Letting each
// start as soon as its predecessor's blocks had all begun, with
// griddepcontrol.launch_dependents, made a call 0.5-1 us slower on the
// H100.)
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
//          several times slower on the H100). The item whose CAS inserted
//          the row is its owner;
//   apply  a group of G lanes per item: reads its row and slot as the plan
//          left them, prefetches its rows while it reads the count; a row
//          that occurs once is applied straight away by its item (the
//          unique functor); an item of a duplicated row is marked, and the
//          row's owner takes a segment of n places in the key list and a
//          place in the run list (one atomic a block for each), and leaves
//          the segment's base in the row's slot, base << 32 | n;
//   place  a thread per item: each marked item takes a place in its row's
//          segment from the slot's count (one atomicAdd a row and warp) and
//          writes its key (row * 2 + flag) << 32 | k there, in no order;
//          the row's last items clear its slot;
//   tail   a grid sized from K: each run (a duplicated row's segment) is
//          ordered by its own keys, (flag, k), and walked in that order,
//          each column's adds a serial chain rounded after every add. A
//          short run (under kLongRun items) is ordered by rank by one warp
//          and walked by G lanes, 32 / G runs a warp; a long one (a hot row
//          of skewed traffic) by a block: ordered in place by a bitmap of
//          its keys in shared memory (by a bitonic sort past kBitmapItems
//          items), then walked a thread a column, kTailThreads columns at a
//          time, the update elements copied into shared memory kStages - 1
//          chunks ahead of the adds.
//
// So the common case, rows that occur once, sorts nothing, and the order
// of a duplicated row's adds is fixed by the keys, not by the atomics: the
// same inputs give the same bits. Runs are independent of each other, so
// the tail spreads them over the card's SMs: what bounds it is the longest
// run's serial chain (its sort and its adds), not D, the number of
// duplicated items. (A tail of one block, which sorted all D keys and
// walked every run, took 0.68 ms on power-law ids, D ~ 10,200 of K =
// 16,384, while the other 131 SMs idled; a counting order, dense row ids, a
// stable scatter by k and a tail run by the apply kernel's last block made
// it no faster, since the one block was the limit.)
//
// The scratch (scratch_bytes(K), from the caching allocator) is zero
// between calls where a call reads before it writes: a row that occurs once
// clears its slot when its item is applied, the place kernel clears the
// duplicated rows' slots, the tail's last block resets the counters. So a
// call needs no clearing launch and can be captured in a CUDA graph. Calls
// that share one scratch must run in stream order. The tail's last block
// also adds the call's duplicated items, runs and long runs to the
// wrapper's counts (three u64 on the device, when given).

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace row_plan {

constexpr int kThreads = 256;       // plan, apply and place blocks
constexpr int kTailThreads = 256;   // a tail block: a long run's team, or 8 warps of short runs
constexpr int kWindow = 64;         // K4's look-back: an item sees the 63 before it
constexpr int kLongRun = 64;        // runs this long take a block, a column a thread
constexpr int kBitmapItems = 131072;  // K up to which a long run is ordered by a bitmap
constexpr int kStages = 4;          // a long run's walk: chunks in flight
constexpr int kStageFloats = 2048;  // ... of this many update elements
constexpr int kMaxChunk = 128;      // ... and at most this many keys
constexpr int kSpan = 2048;         // a long run's keys read into shared memory at once
constexpr int kTailItems = 64;      // items of K a tail block, at most kMaxTailBlocks blocks
constexpr int kMaxTailBlocks = 1024;
constexpr unsigned kOwner = 1u << 30;  // item.x: the item that inserted its row
constexpr unsigned kDup = 1u << 31;    // item.x: an item of a duplicated row
constexpr unsigned kRowBits = kOwner - 1u;

// counters, each on its own 128-byte line (a block's atomics on one do not
// queue behind another's)
enum Counter { kSegEnd = 0, kShortRuns = 1, kLongRuns = 2, kTicket = 3, kCounters = 4 };
constexpr int kCounterStride = 32;  // ints

using u64 = unsigned long long;

// Scratch, in this order: u64 table[P] ((row + 1) << 32 | the row's active
// occurrences after the plan, base << 32 | occurrences left after apply;
// 0 = empty), int2 item[K] (each item's clipped row with the kOwner and
// kDup bits, and slot * 2 + flag, slot -1 if inactive), int ctr[...] (the
// counters), u64 seg[K] (the duplicated items' keys, a segment a row),
// int2 runs[K / 2 + 1] ((base, n): short runs from the front, long runs
// from the back).
struct Scratch {
  u64* table;
  int2* item;
  int* ctr;
  u64* seg;
  int2* runs;
  int pbits;
  int run_cap;
};

inline int table_bits(long long K) {
  int b = 6;
  while ((1LL << b) < 16 * K) ++b;
  return b;
}

inline long long run_cap(long long K) { return K / 2 + 1; }

constexpr long long kCounterWords = kCounters * kCounterStride / 2;

// in 8-byte words
inline long long scratch_words(long long K) {
  return (1LL << table_bits(K)) + K + kCounterWords + K + run_cap(K);
}

inline long long scratch_bytes(long long K) { return 8 * scratch_words(K); }

inline Scratch carve(void* base, long long K) {
  const int pbits = table_bits(K);
  u64* p = static_cast<u64*>(base);
  u64* item = p + (1LL << pbits);
  u64* ctr = item + K;
  u64* seg = ctr + kCounterWords;
  u64* runs = seg + K;
  return Scratch{p, reinterpret_cast<int2*>(item), reinterpret_cast<int*>(ctr), seg,
                 reinterpret_cast<int2*>(runs), pbits, static_cast<int>(run_cap(K))};
}

__device__ __forceinline__ int* counter(const Scratch& s, Counter c) {
  return s.ctr + c * kCounterStride;
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

// Plan: each item's row (with kOwner on the item that inserted it) and
// slot * 2 + flag (slot -1 if inactive); the table holds each active row
// once with its count. Flags (kFlags, K4 only): an active item is flagged
// when an active item among the kWindow - 1 before it has the same unit
// (row / unit).
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
  bool owner = false;  // only the leader's lane inserts
  if (row >= 0 && lane == leader) {
    const unsigned mask = (1u << s.pbits) - 1u;
    const u64 n = __popc(peers);
    h = (static_cast<unsigned>(row) * 2654435761u) >> (32 - s.pbits);
    for (;;) {
      const u64 prev = atomicCAS(&s.table[h], 0ull, (static_cast<u64>(row + 1) << 32) | n);
      if (prev == 0) {
        owner = true;
        break;
      }
      if ((prev >> 32) == static_cast<u64>(row + 1)) {
        atomicAdd(&s.table[h], n);
        break;
      }
      h = (h + 1) & mask;
    }
  }
  h = __shfl_sync(0xffffffffu, h, leader);
  if (k < K) {
    s.item[k] = row < 0 ? make_int2(0, -1)
                        : make_int2(static_cast<int>(row | (owner ? kOwner : 0u)),
                                    static_cast<int>(h) * 2 + flag);
  }
}

// Apply: G lanes per item. Unique::prefetch<V, G>(store, row, k, gl, nv)
// asks L2 for the item's rows; Unique::apply<V, G>(store, row, k, flag, gl,
// nv, seed) applies an item whose row occurs once (every lane of the group
// calls both), with seed = Unique::seed(), read before the grid waits for
// its predecessor. An item of a duplicated row is marked (kDup) for the
// place kernel; its row's owner takes the row's segment and run.
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
  const int row = static_cast<int>(static_cast<unsigned>(plan.x) & kRowBits);
  const int slot = plan.y >> 1, flag = plan.y & 1;
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
  const bool dup = n > 1 && gl == 0;
  if (dup) s.item[k].x = static_cast<int>(static_cast<unsigned>(plan.x) | kDup);
  // the block's owners take their segments and runs with one atomic a
  // block for each (a hot row's items would queue on the counters)
  __shared__ int seg_n, short_n, long_n, seg_base, short_base, long_base;
  if (threadIdx.x == 0) seg_n = short_n = long_n = 0;
  __syncthreads();
  int seg_at = -1, run_at = -1;
  if (dup && (static_cast<unsigned>(plan.x) & kOwner)) {
    seg_at = atomicAdd(&seg_n, n);
    run_at = atomicAdd(n >= kLongRun ? &long_n : &short_n, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (seg_n > 0) seg_base = atomicAdd(counter(s, kSegEnd), seg_n);
    if (short_n > 0) short_base = atomicAdd(counter(s, kShortRuns), short_n);
    if (long_n > 0) long_base = atomicAdd(counter(s, kLongRuns), long_n);
  }
  __syncthreads();
  if (seg_at >= 0) {
    const int base = seg_base + seg_at;
    // the count stays in the low half, where the row's other items read it
    s.table[slot] = (static_cast<u64>(base) << 32) | static_cast<u64>(n);
    const int r = n >= kLongRun ? s.run_cap - 1 - (long_base + run_at) : short_base + run_at;
    s.runs[r] = make_int2(base, n);
  }
}

// Place: a thread per item; each item of a duplicated row writes its key
// (row * 2 + flag) << 32 | k into its row's segment, at a place taken from
// the slot's count (base << 32 | left): the warp's items of one row take
// theirs with one atomic, and the row's last items clear the slot.
__global__ void __launch_bounds__(kThreads) place_kernel(long long K, Scratch s) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  wait_for_predecessor();
  const int2 it = k < K ? s.item[k] : make_int2(0, -1);
  const bool dup = (static_cast<unsigned>(it.x) & kDup) != 0;
  const int slot = it.y >> 1;
  const unsigned peers = __match_any_sync(0xffffffffu, dup ? slot : ~lane);
  if (!dup) return;
  const int leader = __ffs(peers) - 1;
  const int cnt = __popc(peers), rank = __popc(peers & ((1u << lane) - 1u));
  u64 old = 0;
  if (lane == leader) old = atomicAdd(&s.table[slot], 0ull - static_cast<u64>(cnt));
  old = __shfl_sync(peers, old, leader);
  const int left = static_cast<int>(old & 0xffffffffull), base = static_cast<int>(old >> 32);
  const unsigned row = static_cast<unsigned>(it.x) & kRowBits;
  s.seg[base + left - 1 - rank] =
      (static_cast<u64>(row * 2 + (it.y & 1)) << 32) | static_cast<u64>(k);
  if (lane == leader && left == cnt) s.table[slot] = 0;  // the row's last items
}

// Sorts a[0, n) ascending in device memory (read and written in L2) with
// the whole block: a bitonic network in its form with every comparator
// ascending (each merge starts by comparing mirrored places), so places at
// or past n act as +inf padding that never moves and needs no storage.
__device__ void bitonic_sort(u64* a, int n) {
  int m = 1;
  while (m < n) m <<= 1;
  const auto up = [a, n](int lo, int hi) {
    if (hi >= n) return;
    const u64 x = __ldcg(a + lo), y = __ldcg(a + hi);
    if (x > y) {
      __stcg(a + lo, y);
      __stcg(a + hi, x);
    }
  };
  for (int size = 2; size <= m; size <<= 1) {
    const int half = size >> 1;
    for (int i = threadIdx.x; i < m / 2; i += kTailThreads) {
      const int lo = (i / half) * size + i % half;
      up(lo, lo ^ (size - 1));
    }
    __syncthreads();
    for (int j = half >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m / 2; i += kTailThreads) {
        const int lo = (i / j) * 2 * j + i % j;
        up(lo, lo + j);
      }
      __syncthreads();
    }
  }
}

// The row of a listed key, (row * 2 + flag) << 32 | k.
__device__ __forceinline__ int run_id(u64 key) { return static_cast<int>(key >> 33); }

// Whether an unflagged occurrence (the main pass: SR when sr).
__device__ __forceinline__ bool main_pass(u64 key) { return ((key >> 32) & 1) == 0; }

// The tail block's shared memory: a long run's order (a bitmap of its
// keys), then its walk's stages.
struct alignas(16) TailSmem {
  union {
    unsigned bits[kBitmapItems / 16];  // bit flag * K + k of each key
    struct {
      float rows[kStages][kStageFloats];  // update elements, a stage a chunk
      unsigned keys[kSpan];               // the span's keys, compact
    } walk;
  };
  int warp_sums[kTailThreads / 32];
};

// Orders a long run keys[0, n) of K items in place by a bitmap in shared
// memory of its keys' flag * K + k: a key's place is the number of set bits
// below its own (a thread counts a contiguous share of the words, and a
// scan over the threads gives each share the count before it).
// K <= kBitmapItems.
__device__ void order_by_bitmap(u64* keys, int n, int K, TailSmem& sm) {
  const int nw = (2 * K + 31) / 32;
  unsigned* bits = sm.bits;
  for (int i = threadIdx.x; i < nw; i += kTailThreads) bits[i] = 0;
  const u64 head = __ldcg(keys);  // every key of the run has its row
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kTailThreads) {
    const u64 key = __ldcg(keys + i);
    const unsigned b = (main_pass(key) ? 0u : static_cast<unsigned>(K)) +
                       static_cast<unsigned>(key);
    atomicOr(&bits[b / 32], 1u << (b % 32));
  }
  __syncthreads();
  const int per = (nw + kTailThreads - 1) / kTailThreads, w0 = threadIdx.x * per;
  const int w1 = min(w0 + per, nw);
  int own = 0;
  for (int w = w0; w < w1; ++w) own += __popc(bits[w]);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sm.warp_sums[warp] = incl;
  __syncthreads();
  int at = incl - own;
  for (int j = 0; j < warp; ++j) at += sm.warp_sums[j];
  const u64 high = (head >> 33) << 33;  // row * 2 << 32
  for (int w = w0; w < w1; ++w) {
    for (unsigned m = bits[w]; m != 0; m &= m - 1) {
      const unsigned b = w * 32 + __ffs(m) - 1;
      const bool flagged = b >= static_cast<unsigned>(K);
      __stcg(keys + at++, high | (static_cast<u64>(flagged) << 32) |
                              (b - (flagged ? static_cast<unsigned>(K) : 0u)));
    }
  }
  __syncthreads();
}

// A key as the walk keeps it in shared memory: flag << 31 | k (k < 2^26).
__device__ __forceinline__ unsigned compact(u64 key) {
  return (main_pass(key) ? 0u : 0x80000000u) | static_cast<unsigned>(key);
}

// Walks one ordered long run keys[0, n) (in device memory) over the
// columns [col0, col0 + cols) of its row, cols <= kTailThreads, kSpan keys
// at a time: the span's keys are read into shared memory at once, then the
// block copies chunks of their update elements into shared memory, kStages
// - 1 chunks ahead of the adds (cp.async of V elements: the copies hold no
// registers), and a thread a column adds them to its element of the row in
// key order.
template <int V, class S>
__device__ void walk_long(const u64* keys, int n, int col0, int cols, S* __restrict__ store,
                          const float* __restrict__ upd, int dim, bool sr, unsigned seed,
                          TailSmem& sm) {
  using RV = RowVec<S, 1>;
  const int chunk = min(kMaxChunk, kStageFloats / cols);
  const int col = threadIdx.x;
  typename RV::Raw* dst = reinterpret_cast<typename RV::Raw*>(store) +
                          static_cast<long long>(run_id(__ldcg(keys))) * dim + col0 + col;
  float v = col < cols ? RV::load(*dst) : 0.f;
  for (int b = 0; b < n; b += kSpan) {
    const int span = min(kSpan, n - b), chunks = (span + chunk - 1) / chunk;
    __syncthreads();  // the last span's keys are no longer read
    for (int i = threadIdx.x; i < span; i += kTailThreads) {
      sm.walk.keys[i] = compact(__ldcg(keys + b + i));
    }
    __syncthreads();
    const auto issue = [&](int c) {
      if (c < chunks) {
        const int q = c * chunk, m = min(chunk, span - q) * cols, st = c % kStages;
        for (int e = threadIdx.x * V; e < m; e += kTailThreads * V) {
          const int r = e / cols;
          const unsigned k = sm.walk.keys[q + r] & 0x7fffffffu;
          __pipeline_memcpy_async(&sm.walk.rows[st][e],
                                  upd + static_cast<long long>(k) * dim + col0 + e - r * cols,
                                  4 * V);
        }
      }
      __pipeline_commit();
    };
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    for (int c = 0; c < chunks; ++c) {
      issue(c + kStages - 1);
      __pipeline_wait_prior(kStages - 1);
      __syncthreads();
      if (col < cols) {
        const int q = c * chunk, len = min(chunk, span - q);
        const float* rows = sm.walk.rows[c % kStages];
#pragma unroll 8
        for (int r = 0; r < len; ++r) {
          const unsigned key = sm.walk.keys[q + r];
          const unsigned k = key & 0x7fffffffu;
          v = add_round<S>(v, rows[r * cols + col], sr && (key >> 31) == 0, seed,
                           k * static_cast<unsigned>(dim) + static_cast<unsigned>(col0 + col));
        }
      }
      __syncthreads();  // before a later issue refills this stage
    }
  }
  if (col < cols) *dst = RV::store(v);
}

// Orders a short run's keys (n < kLongRun <= 64) in its segment with the
// warp: a key's place is its rank, since the keys are distinct (k is).
__device__ __forceinline__ void order_short(u64* keys, int n, int lane) {
  const u64 a = lane < n ? keys[lane] : ~0ull;
  const u64 b = lane + 32 < n ? keys[lane + 32] : ~0ull;
  int ra = 0, rb = 0;
  for (int j = 0; j < n; ++j) {
    const u64 x = __shfl_sync(0xffffffffu, j < 32 ? a : b, j & 31);
    ra += x < a;
    rb += x < b;
  }
  __syncwarp();
  if (lane < n) keys[ra] = a;
  if (lane + 32 < n) keys[rb] = b;
  __syncwarp();
}

// Walks one ordered short run keys[0, n) with a group of G lanes: the row's
// vectors in f32, the run's update rows added in key order (unflagged
// occurrences in ascending k, then flagged ones), rounding to S after every
// add; SR on unflagged occurrences when sr. Each batch's loads are issued
// together (past the run's end they repeat its last key, and are not added).
template <int V, int G, class S>
__device__ void walk_short(const u64* keys, int n, S* __restrict__ store,
                           const float* __restrict__ upd, int nv, int dim, bool sr,
                           unsigned seed, int gl) {
  using RV = RowVec<S, V>;
  using T = typename RV::T;
  constexpr int kUnroll = 16;  // update rows loaded ahead of the serial adds
  const T* u = reinterpret_cast<const T*>(upd);
  typename RV::Raw* dst =
      reinterpret_cast<typename RV::Raw*>(store) + static_cast<long long>(run_id(keys[0])) * nv;
  for (int c = gl; c < nv; c += G) {
    T v = RV::load(dst[c]);
    for (int q = 0; q < n; q += kUnroll) {
      u64 key[kUnroll];
      T add[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        key[j] = keys[min(q + j, n - 1)];
        add[j] = u[static_cast<long long>(static_cast<unsigned>(key[j])) * nv + c];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (q + j < n) {
          v = add_round<S>(v, add[j], sr && main_pass(key[j]), seed,
                           static_cast<unsigned>(key[j]) * static_cast<unsigned>(dim) +
                               static_cast<unsigned>(c * V));
        }
      }
    }
    dst[c] = RV::store(v);
  }
}

// Tail: each run ordered by its keys and walked (adding upd's rows: K4's
// upd, K2's delta, rounded to S). Long runs take a block each, from the
// grid's first blocks: ordered in place (by a bitmap up to kBitmapItems
// items, else a bitonic sort) and walked kTailThreads columns at a time;
// short runs take a group of G lanes each, 32 / G a warp, from the grid's
// last blocks. Every block takes a ticket once it has read the counters;
// the last one resets them and adds the call's counts to stats.
template <int V, int G, class S>
__global__ void __launch_bounds__(kTailThreads, 2)
tail_kernel(S* __restrict__ store, const float* __restrict__ upd, long long K, int nv, int dim,
            bool sr, const long long* step, Scratch s, u64* stats) {
  __shared__ TailSmem sm;
  __shared__ int runs_short, runs_long;
  // the step was written before the plan kernel began, so it is read
  // while the grid waits for its predecessor
  const unsigned seed = sr ? seed_of(step) : 0u;
  wait_for_predecessor();
  if (threadIdx.x == 0) {
    const int d = *reinterpret_cast<volatile int*>(counter(s, kSegEnd));
    const int ns = *reinterpret_cast<volatile int*>(counter(s, kShortRuns));
    const int nl = *reinterpret_cast<volatile int*>(counter(s, kLongRuns));
    runs_short = ns;
    runs_long = nl;
    __threadfence();
    if (atomicAdd(counter(s, kTicket), 1) == static_cast<int>(gridDim.x) - 1) {
      for (int c = 0; c < kCounters; ++c) *counter(s, static_cast<Counter>(c)) = 0;
      if (stats != nullptr && d > 0) {
        atomicAdd(stats, static_cast<u64>(d));
        atomicAdd(stats + 1, static_cast<u64>(ns + nl));
        atomicAdd(stats + 2, static_cast<u64>(nl));
      }
    }
  }
  __syncthreads();
  const int n_short = runs_short, n_long = runs_long;
  for (int w = blockIdx.x; w < n_long; w += gridDim.x) {
    const int2 run = s.runs[s.run_cap - 1 - w];
    u64* keys = s.seg + run.x;
    if (K <= kBitmapItems) {
      order_by_bitmap(keys, run.y, static_cast<int>(K), sm);
    } else {
      bitonic_sort(keys, run.y);
    }
    for (int c0 = 0; c0 < dim; c0 += kTailThreads) {
      walk_long<V>(keys, run.y, c0, min(dim - c0, kTailThreads), store, upd, dim, sr, seed,
                   sm);
    }
  }
  constexpr int kWarps = kTailThreads / 32, kPerWarp = 32 / G;
  const int lane = threadIdx.x % 32;
  const int warp = (gridDim.x - 1 - blockIdx.x) * kWarps + threadIdx.x / 32;
  for (int r0 = warp * kPerWarp; r0 < n_short; r0 += gridDim.x * kWarps * kPerWarp) {
    for (int j = 0; j < kPerWarp && r0 + j < n_short; ++j) {
      const int2 run = s.runs[r0 + j];
      order_short(s.seg + run.x, run.y, lane);
    }
    const int r = r0 + lane / G;
    if (r < n_short) {
      const int2 run = s.runs[r];
      walk_short<V, G>(s.seg + run.x, run.y, store, upd, nv, dim, sr, seed, lane % G);
    }
  }
}

inline unsigned tail_blocks(long long K) {
  return static_cast<unsigned>(
      std::min<long long>((K + kTailItems - 1) / kTailItems, kMaxTailBlocks));
}

// Launches kernel<<<blocks, threads, 0, stream>>>(args...), allowed to
// start while the kernel before it on the stream drains (it waits for it
// with wait_for_predecessor).
template <class... Params, class... Args>
cudaError_t launch_after(void (*kernel)(Params...), unsigned blocks, int threads,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Launches the plan, apply, place and tail kernels for K items (ids int32,
// or int64 when idx64) on `stream` on device `device`; active ids are
// clipped to [0, hi]; K < 2^26 (the table's slot ids); with sr, the tail
// reads the SR step from the device at `step` (seed_of); `stats` (three
// u64 on the device, or null) gains the call's duplicated items, runs and
// long runs. Returns the first launch error, or cudaGetLastError(): 0 on
// success.
template <bool kFlags, class S, class Unique>
int launch(S* store, const void* idx, int idx64, const int* active, const float* dup_upd,
           void* scratch, long long* stats, long long K, long long hi, int unit, int dim,
           bool sr, const long long* step, int device, cudaStream_t stream, Unique unique) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K == 0 || dim == 0) return 0;
  const Scratch s = carve(scratch, K);
  const unsigned item_blocks = static_cast<unsigned>((K + kThreads - 1) / kThreads);
  if (idx64) {
    plan_kernel<kFlags><<<item_blocks, kThreads, 0, stream>>>(
        static_cast<const long long*>(idx), active, K, hi, unit, s);
  } else {
    plan_kernel<kFlags><<<item_blocks, kThreads, 0, stream>>>(static_cast<const int*>(idx),
                                                              active, K, hi, unit, s);
  }
  u64* counts = reinterpret_cast<u64*>(stats);
  cudaError_t launch_err = cudaSuccess;
  const auto go = [&](auto v, auto g, int nv) {
    constexpr int V = decltype(v)::value, G = decltype(g)::value;
    const unsigned blocks = static_cast<unsigned>((K * G + kThreads - 1) / kThreads);
    cudaError_t e = launch_after(apply_kernel<V, G, S, Unique>, blocks, kThreads, stream, store,
                                 K, nv, s, unique);
    if (e == cudaSuccess) e = launch_after(place_kernel, item_blocks, kThreads, stream, K, s);
    if (e == cudaSuccess) {
      e = launch_after(tail_kernel<V, G, S>, tail_blocks(K), kTailThreads, stream, store,
                       dup_upd, K, nv, dim, sr, step, s, counts);
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
