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
// the 4 MB grad table once; about 0.43 GB, 0.13 ms at 3.35 TB/s. The
// arithmetic (two operations an element) is far below the f32 rate.
//
// Design: apply only the live occurrences. An occurrence with w == +-0 and
// a finite grad row adds +-0, which leaves every value as it is (except
// that -0.0 + +0.0 is +0.0: such an element keeps its -0.0 here); one with
// a non-finite grad row adds NaN and stays. Four launches, no host sync,
// no torch op, so one call is captured whole in a CUDA graph:
//   1. flags: one byte a grad-table row, set when the row is all finite
//      (a warp a row);
//   2. count: each tile of kTile occurrences counts its live ones (in
//      [0, R), and w != 0 or a non-finite grad row), with coalesced loads;
//      the last tile to finish (a ticket counter) turns the counts into
//      exclusive offsets and writes the total to the device;
//   3. compaction: each tile writes its live (pos, seg, w) at its offset,
//      in order (ballots and one block scan), so pos stays ascending and a
//      row's items stay in k order;
//   4. walk: the compacted stream's run walk. A group of G lanes takes a
//      window of G positions with one coalesced load of each stream, finds
//      the run heads in it with a ballot, and applies up to kHeads heads at
//      a time: their store rows and first grad rows are all requested
//      before any is used, so several independent rows are in flight per
//      group (the row-by-row walk of sorted_stream.cuh waits on each head's
//      own chain). A run that crosses the window's end is walked on by its
//      head's group. The grid is sized from K and strides over the device
//      count, so positions past it cost nothing.
// Host batches pad every bag with row 0 at weight 0, one run of ~100k items
// per table at the benchmark's shape; compaction leaves only row 0's live
// lookups, so no group walks the padding. The scratch (the ticket, the
// count, tile counts, compacted streams, the flags) is one buffer that the
// caller keeps and may share between calls of other sizes; the ticket is
// zero when it is made and every call leaves it zero. The TPU kernel's full-store block stream, its VMEM-resident grad
// table, the scalar chunk ping-pong, the CHP sentinel padding and the lane
// sub-slot of packed rows have no counterpart: the port's stores are
// logical rows.

#include "sorted_stream.cuh"

namespace {

using sorted_stream::kThreads;

constexpr int kItems = 8;                   // occurrences a thread: count, compaction
constexpr int kTile = kThreads * kItems;    // occurrences a tile (block)
constexpr int kHeads = 4;                   // run heads a walk group holds at once
constexpr int kWalkBlocksPerSM = 8;

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

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

__device__ __forceinline__ bool finite(float4 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
}

// The scratch, carved from one buffer: offsets in bytes, 16-byte aligned.
struct Scratch {
  int* pos;
  int* seg;
  float* w;
  int* tiles;              // [n_tiles] live counts, then exclusive offsets
  int* count;              // [1] live occurrences
  unsigned* ticket;        // [1] tiles finished; zero between calls
  unsigned char* flags;    // [S] 1 = the grad row is all finite
};

inline long long align16(long long n) { return (n + 15) / 16 * 16; }

inline long long n_tiles(long long K) { return (K + kTile - 1) / kTile; }

inline long long scratch_layout(long long K, long long S, unsigned char* base, Scratch* s) {
  long long off = 0;
  const auto take = [&](long long bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align16(bytes);
    return p;
  };
  // the ticket first: every (K, S) finds it at offset 0, where every call
  // leaves it zero; each other part is written in a call before it is read
  unsigned char* ticket = take(4);
  unsigned char* count = take(4);
  unsigned char* tiles = take(4 * n_tiles(K));
  unsigned char* pos = take(4 * K);
  unsigned char* seg = take(4 * K);
  unsigned char* w = take(4 * K);
  unsigned char* flags = take(S);
  if (s) {
    *s = Scratch{reinterpret_cast<int*>(pos), reinterpret_cast<int*>(seg),
                 reinterpret_cast<float*>(w), reinterpret_cast<int*>(tiles),
                 reinterpret_cast<int*>(count), reinterpret_cast<unsigned*>(ticket), flags};
  }
  return off;
}

// 1. flags[s] = every element of gtab row s is finite; a warp a row.
template <int V>
__global__ void __launch_bounds__(kThreads)
sorted_stream_apply_flags(const float* __restrict__ gtab, long long S, int nv,
                    unsigned char* __restrict__ flags) {
  using T = typename sorted_stream::StoreVec<float, V>::T;
  const long long s = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  if (s >= S) return;
  const T* g = reinterpret_cast<const T*>(gtab) + s * nv;
  bool ok = true;
  for (int c = threadIdx.x % 32; c < nv; c += 32) ok = ok && finite(g[c]);
  ok = __all_sync(0xffffffffu, ok);
  if (threadIdx.x % 32 == 0) flags[s] = ok;
}

// Does occurrence k change its row?
__device__ __forceinline__ bool live(const int* __restrict__ pos, const int* __restrict__ seg,
                                     const float* __restrict__ w,
                                     const unsigned char* __restrict__ flags, long long R,
                                     long long k) {
  const int p = pos[k];
  if (p < 0 || p >= R) return false;
  return w[k] != 0.f || !flags[seg[k]];
}

// Exclusive scan of one value a thread over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += o;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + inc - v;
}

// A tile's occurrences go to its threads in kItems rounds of kThreads
// neighbours (occurrence base + i * kThreads + thread), so every load of a
// round is coalesced.

// 2. the live count of each tile; the last tile to finish scans them.
__global__ void __launch_bounds__(kThreads)
sorted_stream_apply_count(const int* __restrict__ pos, const int* __restrict__ seg,
                          const float* __restrict__ w, long long R, long long K, Scratch s) {
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  int n = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long k = k0 + i * kThreads;
    if (k < K) n += live(pos, seg, w, s.flags, R, k);
  }
  int total;
  block_exclusive_scan(n, &total);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    s.tiles[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(s.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int t0 = 0; t0 < static_cast<int>(gridDim.x); t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int c = t < static_cast<int>(gridDim.x) ? __ldcg(s.tiles + t) : 0;
    int chunk;
    const int ex = block_exclusive_scan(c, &chunk);
    if (t < static_cast<int>(gridDim.x)) s.tiles[t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) {
    *s.count = carry;
    *s.ticket = 0;
  }
}

// 3. each tile writes its live occurrences at its offset, in order: a
// ballot a round and warp, and one scan of the kItems x warps counts in
// (round, warp) order, place each live occurrence; a warp's live
// occurrences of a round land next to each other.
__global__ void __launch_bounds__(kThreads)
sorted_stream_apply_compact(const int* __restrict__ pos, const int* __restrict__ seg,
                            const float* __restrict__ w, long long R, long long K, Scratch s) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kItems * kWarps == 64, "the scan below takes two counts a lane");
  __shared__ int offs[kItems * kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  unsigned ballots[kItems];
  int p[kItems] = {}, sg[kItems] = {};
  float wv[kItems] = {};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long k = k0 + i * kThreads;
    bool in = false;
    if (k < K) {
      p[i] = pos[k];
      wv[i] = w[k];
      sg[i] = seg[k];
      in = p[i] >= 0 && p[i] < R && (wv[i] != 0.f || !s.flags[sg[i]]);
    }
    ballots[i] = __ballot_sync(0xffffffffu, in);
    if (lane == 0) offs[i * kWarps + warp] = __popc(ballots[i]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 64 counts, two a lane
    const int a = offs[2 * lane], b = offs[2 * lane + 1];
    int inc = a + b;
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    offs[2 * lane] = inc - a - b;
    offs[2 * lane + 1] = inc - b;
  }
  __syncthreads();
  const int base = s.tiles[blockIdx.x];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (ballots[i] >> lane & 1u) {
      const int out = base + offs[i * kWarps + warp] + __popc(ballots[i] & below);
      s.pos[out] = p[i];
      s.seg[out] = sg[i];
      s.w[out] = wv[i];
    }
  }
}

// 4. the run walk over the compacted stream (all of it in [0, R)).
template <int V, int G>
__global__ void __launch_bounds__(kThreads)
sorted_stream_apply_walk(float* __restrict__ store, const float* __restrict__ gtab, int nv,
                         Scratch s) {
  using T = typename sorted_stream::StoreVec<float, V>::T;
  const long long K = *s.count;
  const int gl = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << (lane & ~(G - 1));
  const unsigned gbits = G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const T* g = reinterpret_cast<const T*>(gtab);
  T* rows = reinterpret_cast<T*>(store);
  for (long long p0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G * G;
       p0 < K; p0 += stride) {
    // one coalesced load of each stream for the window [p0, p0 + G)
    const long long q = p0 + gl;
    const bool in_k = q < K;
    const int row = in_k ? s.pos[q] : -1;
    const int sq = in_k ? s.seg[q] : 0;
    const float wq = in_k ? s.w[q] : 0.f;
    int prev = __shfl_up_sync(gmask, row, 1, G);
    if (gl == 0) prev = p0 > 0 ? s.pos[p0 - 1] : -1;
    const unsigned heads = (__ballot_sync(gmask, in_k && row != prev) >> (lane & ~(G - 1))) & gbits;
    const int n_in = K - p0 < G ? static_cast<int>(K - p0) : G;
    for (int c0 = 0; c0 < nv; c0 += G) {
      const int c = c0 + gl;
      const bool has = c < nv;
      for (unsigned todo = heads; todo;) {
        int h[kHeads], e[kHeads], r[kHeads];
        T v[kHeads] = {}, g0[kHeads] = {};
        float w0[kHeads];
#pragma unroll
        for (int u = 0; u < kHeads; ++u) {
          h[u] = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1;
          // the run ends at the next head in the window, or at its end
          const unsigned later = h[u] < 0 ? 0 : heads & ~((2u << h[u]) - 1u);
          e[u] = later ? __ffs(later) - 1 : n_in;
          r[u] = __shfl_sync(gmask, row, h[u] < 0 ? 0 : h[u], G);
        }
        // every head's store row and first grad row requested before any use
#pragma unroll
        for (int u = 0; u < kHeads; ++u) {
          const int sj = __shfl_sync(gmask, sq, h[u] < 0 ? 0 : h[u], G);
          w0[u] = __shfl_sync(gmask, wq, h[u] < 0 ? 0 : h[u], G);
          if (h[u] >= 0 && has) {
            v[u] = rows[static_cast<long long>(r[u]) * nv + c];
            g0[u] = g[static_cast<long long>(sj) * nv + c];
          }
        }
#pragma unroll
        for (int u = 0; u < kHeads; ++u) {
          if (h[u] < 0) continue;
          if (has) v[u] = add_product(v[u], g0[u], w0[u]);
          for (int j = h[u] + 1; j < e[u]; ++j) {
            const int sj = __shfl_sync(gmask, sq, j, G);
            const float wj = __shfl_sync(gmask, wq, j, G);
            if (has) v[u] = add_product(v[u], g[static_cast<long long>(sj) * nv + c], wj);
          }
          if (e[u] == G) {  // the run may go on past the window
            for (long long q0 = p0 + G; q0 < K; q0 += G) {
              const long long qq = q0 + gl;
              const bool in = qq < K && s.pos[qq] == r[u];  // the run is a prefix
              const int s2 = in ? s.seg[qq] : 0;
              const float w2 = in ? s.w[qq] : 0.f;
              const int n = __popc(__ballot_sync(gmask, in));
              for (int j = 0; j < n; ++j) {
                const int sj = __shfl_sync(gmask, s2, j, G);
                const float wj = __shfl_sync(gmask, w2, j, G);
                if (has) v[u] = add_product(v[u], g[static_cast<long long>(sj) * nv + c], wj);
              }
              if (n < G) break;
            }
          }
          if (has) rows[static_cast<long long>(r[u]) * nv + c] = v[u];
        }
      }
    }
  }
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (!counts[device] &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    counts[device] = 132;
  }
  return counts[device];
}

}  // namespace

// Bytes of scratch a call with K occurrences and S grad-table rows needs.
extern "C" long long sorted_stream_apply_scratch_bytes(long long K, long long S) {
  return scratch_layout(K, S, nullptr, nullptr);
}

// Launches the four kernels on `stream` (a cudaStream_t) on device `device`
// and returns cudaGetLastError(): 0 on success. store [R, dim], gtab
// [S, dim] contiguous f32 (16-byte aligned when dim % 4 == 0); pos, seg [K]
// int32, w [K] f32; pos ascending; seg in [0, S). scratch: 16-byte aligned,
// sorted_stream_apply_scratch_bytes(K, S) bytes, zero when first used and
// used by one stream at a time (each call leaves it fit for the next).
extern "C" int sorted_stream_apply(float* store, const int* pos, const int* seg,
                                   const float* w, const float* gtab, long long R,
                                   long long K, long long S, int dim, void* scratch,
                                   int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K == 0 || dim == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  Scratch s;
  scratch_layout(K, S, static_cast<unsigned char*>(scratch), &s);
  const bool vec4 = dim % 4 == 0;
  const int nv = vec4 ? dim / 4 : dim;
  const unsigned flag_blocks = static_cast<unsigned>((S * 32 + kThreads - 1) / kThreads);
  if (vec4) {
    sorted_stream_apply_flags<4><<<flag_blocks, kThreads, 0, st>>>(gtab, S, nv, s.flags);
  } else {
    sorted_stream_apply_flags<1><<<flag_blocks, kThreads, 0, st>>>(gtab, S, nv, s.flags);
  }
  const unsigned tiles = static_cast<unsigned>(n_tiles(K));
  sorted_stream_apply_count<<<tiles, kThreads, 0, st>>>(pos, seg, w, R, K, s);
  sorted_stream_apply_compact<<<tiles, kThreads, 0, st>>>(pos, seg, w, R, K, s);
  const long long cap = static_cast<long long>(sm_count(device)) * kWalkBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(tiles * kItems < cap ? tiles * kItems : cap);
  const auto walk = [&](auto v, auto g) {
    sorted_stream_apply_walk<decltype(v)::value, decltype(g)::value><<<blocks, kThreads, 0, st>>>(
        store, gtab, nv, s);
  };
  const auto go = [&](auto v) {
    using I = std::integral_constant<int, 1>;
    if (nv <= 1) return walk(v, I{});
    if (nv <= 2) return walk(v, std::integral_constant<int, 2>{});
    if (nv <= 4) return walk(v, std::integral_constant<int, 4>{});
    if (nv <= 8) return walk(v, std::integral_constant<int, 8>{});
    if (nv <= 16) return walk(v, std::integral_constant<int, 16>{});
    return walk(v, std::integral_constant<int, 32>{});
  };
  if (vec4) {
    go(std::integral_constant<int, 4>{});
  } else {
    go(std::integral_constant<int, 1>{});
  }
  return static_cast<int>(cudaGetLastError());
}
