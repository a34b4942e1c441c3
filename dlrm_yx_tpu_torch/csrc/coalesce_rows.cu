// Coalescing of sparse row gradients for Hopper (sm_90a): K7.
//
// Replaces no TPU kernel. The JAX package coalesces with XLA's ops
// (dlrm_yx_tpu/ops/coalesce.py coalesce_rows: a stable sort, a neighbour
// compare, a cumulative sum and a segment scatter-add); the port's plain
// version (ops/coalesce.py) repeats those ops in PyTorch, which on the card
// made some ten passes over [K, dim] f32 a step for DLRM-DCNv2's big store
// (K = 1,392,640 items, ~275,000 distinct rows): the expanded gradient, its
// sort-order gather, a zero fill and an atomic index_add_, the gathered
// rows' gather and index_copy_, and the element-wise finish on all K rows.
//
// K7a, the segment sum (coalesce_rows_segments: four launches). The items
// come sorted by a stable torch.sort: keys [K] ascending and order [K],
// the item each sorted place came from. Each item's gradient row is read
// where it lies: row order[i] of a [K, dim] table, or, for a bag batch,
// row owner[k / per] * per + k % per of the pooled cotangent [T * per,
// dim] (so the expanded [K, dim] gradient is never written). Each distinct
// key is a segment; segment j's key, summed row, first item (its
// representative) and, asked for, RWSAdagrad's momentum increment
// sum(g^2) / mdim go to place j of static-shaped outputs, and the places
// after the last segment take the sentinel id, a zero increment, item 0
// and, asked for, zero rows. Nothing waits for the host: the number of
// segments stays on the device.
//
//   coalesce_rows_count    a warp a chunk of kChunk sorted items counts
//                          the segments that start in it (and the live
//                          ones, keys below the sentinel, for the counter)
//   coalesce_rows_scan     one block: the chunks' exclusive prefix, the
//                          place of each chunk's first new segment
//   coalesce_rows_sum      a warp a chunk walks its items in order and
//                          sums each segment's rows in registers, a 16-byte
//                          vector a lane, with the next rows' loads in
//                          flight; a segment that ends in the chunk is
//                          written whole; a segment that enters from the
//                          chunk before leaves its part as the chunk's
//                          head partial, one that runs on into the next
//                          chunk its part as the tail partial
//   coalesce_rows_combine  a warp for each segment that runs past its
//                          first chunk adds its tail partial and the head
//                          partials of the chunks it covers, in chunk
//                          order, and writes the segment
//
// No float atomics: each sum is taken in one fixed order, so two calls give
// the same bits. A segment inside one chunk is summed 0 + g_0 + g_1 + ...
// in occurrence order, which is the CPU's index_add_ order bit for bit; a
// longer one is its chunks' sums added in chunk order, within
// (kChunk + ceil(n / kChunk)) * 2^-24 * sum |g| of the exact sum. A run of
// 87,000 items of one row (the top id of a table of hotness 100) is spread
// over some 680 warps and one combine.
//
// K7b, the finish (coalesce_rows_finish: one launch). After K4 has added
// the increments to the row momentum acc, for each segment u below the
// segment count whose key is below the sentinel:
//
//   delta[u] = (-lr * sums[u]) / (sqrt(acc[key]) + eps)
//   new[u]   = old_rows[rep[u]] + delta[u]
//
// in f32, in the order of operations of the port's torch route; lr is read
// from device memory (a CUDA-graph replay takes its step's). delta may be
// the sums themselves (each element is read, then written, by one thread).
// old_rows are the rows the forward lookup gathered: every occurrence of a
// row carries the same, so the representative's is the row before the
// update. K2 then writes new[u] to the store.
//
// Bound on an H100 SXM: memory. At DLRM-DCNv2's big store (K = 1,392,640,
// dim 128, U ~ 275,000) the least bytes are the sorted ids and order
// (8 K), each distinct row's old row read and new row written (8 dim U)
// and its momentum read and increment written (8 U): ~0.33 GB, ~0.1 ms at
// 3.35 TB/s. Each item's gradient row (K x 512 B) is read too, from the
// pooled cotangent of 33.5 MB, which the 50 MB L2 may hold; the summed
// rows go out and come back between K7a and K7b (2 x 4 dim U).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;          // sorted items a warp walks in order
constexpr int kWarps = 8;            // warps a block
constexpr int kScanThreads = 1024;   // the scan's one block
constexpr int kFinishBlocks = 2048;  // the finish's grid (it walks the segments)

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ float sumsq(const float4& a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}
__device__ __forceinline__ float sumsq(float a) { return a * a; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where item k's gradient row lies in the table: row k, or, for a bag
// batch, the pooled cotangent's row of its slot's table and its sample.
struct Source {
  const float* table;
  const int* owner;  // [slots] or null
  long long per;     // items a slot (the batch) when owner is set

  __device__ __forceinline__ long long row(long long k) const {
    if (owner == nullptr) return k;
    const long long s = k / per;
    return static_cast<long long>(owner[s]) * per + (k - s * per);
  }
};

// Prefetch depth: rows whose loads a lane keeps in flight while the sums
// walk the items (P) and while a combine walks a run's partials (C: a run
// of 87,000 items leaves ~680 partials to one warp, so each round of 32
// chunks issues all its loads at once).
template <int VEC, int NV>
struct Depth {
  static constexpr int P = VEC == 1 ? 8 : (NV >= 8 ? 1 : 8 / NV);
  static constexpr int C = VEC == 1 ? 32 : 32 / NV;
};

template <class Key>
__global__ void __launch_bounds__(kWarps * 32)
    coalesce_rows_count(const Key* __restrict__ keys, long long K, long long nchunks,
                        long long sentinel, long long* __restrict__ base,
                        unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  int live = 0;
  if (c < nchunks) {
    const long long lo = c * kChunk, hi = min(lo + kChunk, K);
    int starts = 0;
    for (long long i0 = lo; i0 < hi; i0 += 32) {
      const long long i = i0 + lane;
      bool start = false, act = false;
      if (i < hi) {
        const Key k = keys[i];
        start = i == 0 || keys[i - 1] != k;
        act = start && static_cast<long long>(k) < sentinel;
      }
      starts += __popc(__ballot_sync(0xffffffffu, start));
      live += __popc(__ballot_sync(0xffffffffu, act));
    }
    if (lane == 0) base[c] = starts;
  }
  __shared__ int s_live[kWarps];
  if (lane == 0) s_live[warp] = live;
  __syncthreads();
  if (threadIdx.x == 0 && counts != nullptr) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_live[w];
    if (t) atomicAdd(&counts[0], static_cast<unsigned long long>(t));
  }
}

// base[0, n) in place to its exclusive prefix; base[n] and *nseg the total.
__global__ void __launch_bounds__(kScanThreads)
    coalesce_rows_scan(long long* __restrict__ base, long long n, long long* __restrict__ nseg) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = min(n, t * per), hi = min(n, lo + per);
  long long s = 0;
  for (long long i = lo; i < hi; ++i) s += base[i];
  long long incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __shared__ long long warp_incl[kScanThreads / 32];
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_incl[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_incl[lane] = w;
  }
  __syncthreads();
  long long prefix = incl - s + (warp > 0 ? warp_incl[warp - 1] : 0);
  for (long long i = lo; i < hi; ++i) {
    const long long v = base[i];
    base[i] = prefix;
    prefix += v;
  }
  if (t == 0) {
    base[n] = warp_incl[kScanThreads / 32 - 1];
    *nseg = warp_incl[kScanThreads / 32 - 1];
  }
}

// A finished segment's row and increment, by the whole warp.
template <int VEC, int NV, class Key>
__device__ __forceinline__ void write_segment(const typename Vec<VEC>::T (&acc)[NV], long long pos,
                                              Key key, int lane, int nv, long long sentinel,
                                              int mdim, float* __restrict__ sums,
                                              float* __restrict__ inc) {
  using T = typename Vec<VEC>::T;
  T* out = reinterpret_cast<T*>(sums) + pos * nv;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < nv) {
      out[v] = acc[j];
      ss += sumsq(acc[j]);
    }
  }
  if (inc != nullptr) {
    ss = warp_sum(ss);
    if (lane == 0) inc[pos] = static_cast<long long>(key) < sentinel ? ss / mdim : 0.f;
  }
}

template <int VEC, int NV>
__device__ __forceinline__ void write_partial(const typename Vec<VEC>::T (&acc)[NV], float* p,
                                              int lane, int nv) {
  using T = typename Vec<VEC>::T;
  T* out = reinterpret_cast<T*>(p);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < nv) out[v] = acc[j];
  }
}

template <class Key, int VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    coalesce_rows_sum(const Key* __restrict__ keys, const long long* __restrict__ order,
                      Source src, long long K, int dim, long long nchunks,
                      const long long* __restrict__ base, const long long* __restrict__ nseg_p,
                      long long sentinel, int mdim, Key* __restrict__ ids,
                      float* __restrict__ sums, float* __restrict__ inc,
                      long long* __restrict__ rep, float* __restrict__ partial, int zero_tail) {
  using T = typename Vec<VEC>::T;
  constexpr int P = Depth<VEC, NV>::P;
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= nchunks) return;
  const int nv = dim / VEC;
  const long long lo = c * kChunk, hi = min(lo + kChunk, K);
  const T* table = reinterpret_cast<const T*>(src.table);

  Key cur = keys[lo];
  bool head = lo > 0 && keys[lo - 1] == cur;  // the segment entered from the chunk before
  long long pos = base[c] - (head ? 1 : 0);
  if (!head && lane == 0) {
    ids[pos] = cur;
    rep[pos] = order[lo];
  }
  T acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) zero(acc[j]);

  for (long long i0 = lo; i0 < hi; i0 += 32) {
    const long long i = i0 + lane;
    Key my_key = cur;
    long long my_ord = 0, my_row = 0;
    if (i < hi) {
      my_key = keys[i];
      my_ord = order[i];
      my_row = src.row(my_ord);
    }
    const int n = static_cast<int>(min(32LL, hi - i0));
    for (int j0 = 0; j0 < n; j0 += P) {
      T buf[P][NV];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long r = __shfl_sync(0xffffffffu, my_row, (j0 + p) & 31);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = lane + 32 * j;
          if (v < nv && j0 + p < n) buf[p][j] = table[r * nv + v];
          else zero(buf[p][j]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (j0 + p < n) {
          const Key k = __shfl_sync(0xffffffffu, my_key, j0 + p);
          const long long o = __shfl_sync(0xffffffffu, my_ord, j0 + p);
          if (k != cur) {
            // the segment `cur` ends inside this chunk
            if (head) write_partial<VEC, NV>(acc, partial + (2 * c) * dim, lane, nv);
            else write_segment<VEC, NV>(acc, pos, cur, lane, nv, sentinel, mdim, sums, inc);
            head = false;
            ++pos;
            cur = k;
            if (lane == 0) {
              ids[pos] = k;
              rep[pos] = o;
            }
#pragma unroll
            for (int j = 0; j < NV; ++j) zero(acc[j]);
          }
#pragma unroll
          for (int j = 0; j < NV; ++j) add(acc[j], buf[p][j]);
        }
      }
    }
  }
  const bool runs_on = hi < K && keys[hi] == cur;
  if (head) write_partial<VEC, NV>(acc, partial + (2 * c) * dim, lane, nv);
  else if (runs_on) write_partial<VEC, NV>(acc, partial + (2 * c + 1) * dim, lane, nv);
  else write_segment<VEC, NV>(acc, pos, cur, lane, nv, sentinel, mdim, sums, inc);

  // the places after the last segment, a chunk's worth a warp
  const long long nseg = *nseg_p;
  const long long t_lo = min(K, nseg + c * kChunk), t_hi = min(K, t_lo + kChunk);
  for (long long p = t_lo + lane; p < t_hi; p += 32) {
    ids[p] = static_cast<Key>(sentinel);
    rep[p] = 0;
    if (inc != nullptr) inc[p] = 0.f;
  }
  if (zero_tail) {
    T* out = reinterpret_cast<T*>(sums);
    T z;
    zero(z);
    for (long long e = t_lo * nv + lane; e < t_hi * nv; e += 32) out[e] = z;
  }
}

template <class Key, int VEC, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    coalesce_rows_combine(const Key* __restrict__ keys, long long K, int dim, long long nchunks,
                          const long long* __restrict__ base, long long sentinel, int mdim,
                          const float* __restrict__ partial, float* __restrict__ sums,
                          float* __restrict__ inc, unsigned long long* __restrict__ counts) {
  using T = typename Vec<VEC>::T;
  constexpr int P = Depth<VEC, NV>::C;
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= nchunks) return;
  const long long lo = c * kChunk, hi = min(lo + kChunk, K);
  // the chunk's last segment starts in it and runs on past it
  if (base[c + 1] == base[c] || hi >= K || keys[hi] != keys[hi - 1]) return;
  const Key k0 = keys[hi - 1];
  const int nv = dim / VEC;
  T acc[NV];
  const T* tail = reinterpret_cast<const T*>(partial + (2 * c + 1) * dim);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < nv) acc[j] = tail[v];
    else zero(acc[j]);
  }
  for (long long c2 = c + 1;;) {
    // which of the next 32 chunks the segment still covers (keys ascend)
    const long long cc = c2 + lane;
    const bool more = cc < nchunks && keys[cc * kChunk] == k0;
    const unsigned m = __ballot_sync(0xffffffffu, more);
    const int n = m == 0xffffffffu ? 32 : __ffs(~m) - 1;
    for (int j0 = 0; j0 < n; j0 += P) {
      T buf[P][NV];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T* head = reinterpret_cast<const T*>(partial + (2 * (c2 + j0 + p)) * dim);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = lane + 32 * j;
          if (v < nv && j0 + p < n) buf[p][j] = head[v];
          else zero(buf[p][j]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (j0 + p < n) {
#pragma unroll
          for (int j = 0; j < NV; ++j) add(acc[j], buf[p][j]);
        }
      }
    }
    c2 += n;
    if (n < 32) break;
  }
  write_segment<VEC, NV>(acc, base[c + 1] - 1, k0, lane, nv, sentinel, mdim, sums, inc);
  if (lane == 0 && counts != nullptr) atomicAdd(&counts[1], 1ULL);
}

template <class Key, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    coalesce_rows_finish(const Key* __restrict__ ids, const long long* __restrict__ rep,
                         const long long* __restrict__ nseg_p, long long sentinel,
                         const float* __restrict__ acc, const float* __restrict__ lr, float eps,
                         const float* sums, const float* __restrict__ old_rows, int dim,
                         float* __restrict__ new_vals, float* delta) {
  const int lane = threadIdx.x & 31;
  const long long nseg = *nseg_p;
  const long long nw = static_cast<long long>(gridDim.x) * kWarps;
  const float nlr = -*lr;
  const int nv = dim / 4;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); u < nseg;
       u += nw) {
    const long long id = static_cast<long long>(ids[u]);
    if (id >= sentinel) continue;
    const float denom = sqrtf(acc[id]) + eps;
    const float4* g = reinterpret_cast<const float4*>(sums) + u * nv;
    const float4* old = reinterpret_cast<const float4*>(old_rows) + rep[u] * nv;
    float4* nw_out = reinterpret_cast<float4*>(new_vals) + u * nv;
    float4* d_out = reinterpret_cast<float4*>(delta) + u * nv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lane + 32 * j;
      if (v < nv) {
        const float4 x = g[v], o = old[v];
        float4 d;
        d.x = (nlr * x.x) / denom;
        d.y = (nlr * x.y) / denom;
        d.z = (nlr * x.z) / denom;
        d.w = (nlr * x.w) / denom;
        nw_out[v] = make_float4(o.x + d.x, o.y + d.y, o.z + d.z, o.w + d.w);
        d_out[v] = d;
      }
    }
  }
}

template <class Key, int VEC, int NV>
cudaError_t launch_segments(const Key* keys, const long long* order, Source src, long long K,
                            int dim, long long sentinel, Key* ids, float* sums, float* inc,
                            int mdim, long long* rep, long long* nseg, long long* base,
                            float* partial, int zero_tail, unsigned long long* counts,
                            cudaStream_t s) {
  const long long nchunks = (K + kChunk - 1) / kChunk;
  const unsigned blocks = static_cast<unsigned>((nchunks + kWarps - 1) / kWarps);
  coalesce_rows_count<Key><<<blocks, kWarps * 32, 0, s>>>(keys, K, nchunks, sentinel, base,
                                                          counts);
  coalesce_rows_scan<<<1, kScanThreads, 0, s>>>(base, nchunks, nseg);
  coalesce_rows_sum<Key, VEC, NV><<<blocks, kWarps * 32, 0, s>>>(
      keys, order, src, K, dim, nchunks, base, nseg, sentinel, mdim, ids, sums, inc, rep,
      partial, zero_tail);
  coalesce_rows_combine<Key, VEC, NV><<<blocks, kWarps * 32, 0, s>>>(
      keys, K, dim, nchunks, base, sentinel, mdim, partial, sums, inc, counts);
  return cudaGetLastError();
}

template <class Key>
cudaError_t segments_by_width(const Key* keys, const long long* order, Source src, long long K,
                              int dim, long long sentinel, Key* ids, float* sums, float* inc,
                              int mdim, long long* rep, long long* nseg, long long* base,
                              float* partial, int zero_tail, unsigned long long* counts,
                              cudaStream_t s) {
#define K7A(VEC, NV)                                                                            \
  launch_segments<Key, VEC, NV>(keys, order, src, K, dim, sentinel, ids, sums, inc, mdim, rep, \
                                nseg, base, partial, zero_tail, counts, s)
  if (dim == 1) return K7A(1, 1);
  const int nv = dim / 4;
  if (nv <= 32) return K7A(4, 1);
  if (nv <= 64) return K7A(4, 2);
  if (nv <= 128) return K7A(4, 4);
  return K7A(4, 8);
#undef K7A
}

template <class Key>
cudaError_t launch_finish(const Key* ids, const long long* rep, const long long* nseg, long long K,
                          long long sentinel, const float* acc, const float* lr, float eps,
                          const float* sums, const float* old_rows, int dim, float* new_vals,
                          float* delta, cudaStream_t s) {
  const long long want = (K + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(want < kFinishBlocks ? want : kFinishBlocks);
  const int nv = dim / 4;
#define K7B(NV)                                                                        \
  coalesce_rows_finish<Key, NV><<<blocks, kWarps * 32, 0, s>>>(ids, rep, nseg, sentinel, \
                                                               acc, lr, eps, sums,      \
                                                               old_rows, dim, new_vals, delta)
  if (nv <= 32) K7B(1);
  else if (nv <= 64) K7B(2);
  else if (nv <= 128) K7B(4);
  else K7B(8);
#undef K7B
  return cudaGetLastError();
}

}  // namespace

// The widest row the kernels take, in f32.
extern "C" int coalesce_rows_max_dim() { return 32 * 4 * 8; }

// Bytes of scratch a call with K items of width dim needs: the chunks'
// prefix (K / kChunk + 1 int64) and two partial rows a chunk. Written
// before it is read: no zeroing.
extern "C" long long coalesce_rows_scratch_bytes(long long K, int dim) {
  const long long nchunks = (K + kChunk - 1) / kChunk;
  return ((nchunks + 2) & ~1LL) * 8 + nchunks * 2 * static_cast<long long>(dim) * 4;
}

// K7a on `stream` (a cudaStream_t) on `device`: four launches; returns
// cudaGetLastError(), 0 on success. keys [K] (int32, or int64 when keys64)
// ascending and order [K] int64 from a stable sort; table [N, dim] f32
// contiguous, 16-byte aligned when dim % 4 == 0 (dim 1, or a multiple of 4
// up to coalesce_rows_max_dim()); owner [slots] int32 and per > 0 for a
// bag batch, else null; ids [K] of the keys' type, sums [K, dim] f32, inc
// [K] f32 (or null: no increments), rep [K] int64, nseg one int64; scratch:
// coalesce_rows_scratch_bytes(K, dim) bytes, 16-byte aligned; zero_tail:
// write zero rows after the last segment; counts: two uint64 on the device
// (or null) that gain each call's live distinct ids and its segments summed
// across chunks.
extern "C" int coalesce_rows_segments(const void* keys, int keys64, const long long* order,
                                      const float* table, const int* owner, long long per,
                                      long long K, int dim, long long sentinel, void* ids,
                                      float* sums, float* inc, int mdim, long long* rep,
                                      long long* nseg, void* scratch, int zero_tail,
                                      unsigned long long* counts, int device, void* stream) {
  if (K < 1 || dim < 1 || (dim != 1 && (dim % 4 || dim > coalesce_rows_max_dim())) ||
      (owner != nullptr && per < 1) || mdim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nchunks = (K + kChunk - 1) / kChunk;
  long long* base = static_cast<long long*>(scratch);
  // the partials after the prefix, 16-byte aligned
  float* partial = reinterpret_cast<float*>(base + ((nchunks + 2) & ~1LL));
  Source src{table, owner, per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys64)
    return static_cast<int>(segments_by_width<long long>(
        static_cast<const long long*>(keys), order, src, K, dim, sentinel,
        static_cast<long long*>(ids), sums, inc, mdim, rep, nseg, base, partial, zero_tail,
        counts, s));
  return static_cast<int>(segments_by_width<int>(
      static_cast<const int*>(keys), order, src, K, dim, sentinel, static_cast<int*>(ids), sums,
      inc, mdim, rep, nseg, base, partial, zero_tail, counts, s));
}

// K7b on `stream` on `device`: one launch; returns cudaGetLastError(). ids
// [K] (int32, or int64 when ids64), rep [K] int64 and nseg (one int64) as
// K7a wrote them; acc the 1-D f32 row momentum (every live id indexes it);
// lr one f32 on the device; sums [K, dim] and old_rows [*, dim] f32;
// new_vals and delta [K, dim] f32 (delta may be sums); dim a multiple of 4
// up to coalesce_rows_max_dim(), every row 16-byte aligned. Places at and
// after the segment count, and segments of ids at or above the sentinel,
// are not written.
extern "C" int coalesce_rows_finish_rows(const void* ids, int ids64, const long long* rep,
                                         const long long* nseg, long long K, long long sentinel,
                                         const float* acc, const float* lr, float eps,
                                         const float* sums, const float* old_rows, int dim,
                                         float* new_vals, float* delta, int device,
                                         void* stream) {
  if (K < 1 || dim < 4 || dim % 4 || dim > coalesce_rows_max_dim())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids64)
    return static_cast<int>(launch_finish<long long>(static_cast<const long long*>(ids), rep,
                                                     nseg, K, sentinel, acc, lr, eps, sums,
                                                     old_rows, dim, new_vals, delta, s));
  return static_cast<int>(launch_finish<int>(static_cast<const int*>(ids), rep, nseg, K,
                                             sentinel, acc, lr, eps, sums, old_rows, dim,
                                             new_vals, delta, s));
}
