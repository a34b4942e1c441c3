// Row-wise Adagrad finish over dense gradients, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_yx_tpu/ops/pallas_dense_finish.py
// (rwsadagrad_dense_finish, _kernel and _finish_math). For every row r of
// a store [R, dim], with g = dense_g[r] the exactly coalesced gradient, in
// place and in the JAX package's order of operations:
//
//   mom      = sum(g * g) / dim
//   acc[r]  += mom
//   store[r] = store[r] - (lr * g) / (sqrt(acc[r]) + eps)
//
// computed in f32 (a bf16 store is widened, and rounded to nearest even at
// write-back). Entries of acc past R are not touched. A row whose gradient
// is all zero is left as it is, store and acc, without being read: its
// update is exactly a no-op. lr is read from device memory, so that a
// CUDA-graph replay applies the lr of its step (an LR schedule) and not the
// one it was captured with.
//
// Bound on an H100 SXM: memory. The gradient must be read whole; each
// touched row's store is read and written and its acc entry read and
// written. At the training shape (the small-table group, R = 121,232 rows
// of 128 f32, one batch touching 16,949 of them) that is 80 MB, 23.75 us
// at 3.35 TB/s; the arithmetic, a few operations per element, is far below
// the f32 rate.
//
// The kernel's first design gave every row a warp and every store a
// launch. Its three limits, and what this design does about each:
//
//  1. A warp per row, whatever the row's width: a row of dim 8 kept 2 lanes
//     of 32 busy, and a warp moved 32 bytes of gradient. Narrow rows
//     (16-byte route, dim % 4 == 0, dim <= 64; scalar route, dim <= 16) now
//     take a lane group sized to the row: G lanes, the power of two >=
//     dim / 4 (or >= dim), 1 to 16, so that a warp carries 32 / G rows (at
//     dim 1, a row a lane). The sum of squares is a butterfly of
//     __shfl_xor_sync of width G, the zero-row vote a __ballot_sync masked
//     to the row's segment, and the segment's first lane writes acc[r].
//  2. One row in flight per warp, in two dependent phases (load g, reduce
//     and vote; then load the store, update, write). Keeping more rows in
//     flight was measured on the card and not kept: 2 or 4 rows a warp
//     (their 16-byte gradient loads issued before any reduction), and a
//     persistent grid whose warps loaded the next rows into registers while
//     they finished the current ones, each came out slower than a warp per
//     row at widths 128 to 512: the extra registers cost more occupancy
//     than the loads in flight gained. 1-D TMA (cp.async.bulk with an
//     mbarrier into a shared-memory ring) was not tried: it would move the
//     same bytes through shared memory, the reduction needs them in
//     registers, and a store row can only be fetched after its vote. Wide
//     rows therefore keep a warp per row, the columns in a loop.
//  3. One launch per store: a small store cost its launch (2-2.5 us inside
//     a CUDA graph), not its bytes, and the QR step paid it 30 times. A
//     step's dense-branch stores now go in one launch
//     (rwsadagrad_dense_finish_many): each store is a descriptor (store,
//     acc, g, R, dim, dtype) passed BY VALUE in the parameter block
//     (__grid_constant__), so a captured graph bakes the descriptors in
//     with no host-to-device copy and no host sync. A store is cut into
//     units (a warp's rows); the units of all stores form one sequence, a
//     warp a unit, and a warp finds its store by a binary search over the
//     prefix of the units. An instance of the kernel is compiled for each
//     set of routes and store types a launch can hold, so that a launch of
//     one route and one type gets the registers its own code needs.
//
// A launch of a single store takes a smaller instance with the store in
// its parameters (no search), on wide rows the first design's code. The
// readings behind these choices (compare_kernels.py, checkouts in turns
// on an NVIDIA H100 80GB HBM3 at 700 W; warm / cold us, two runs each):
//  - a single store sent through the descriptor kernel instead (the case
//    of one descriptor) was slower: the Terabyte small group [121,232,
//    128] f32 34.5-34.8 / 36.9-37.3 against 30.4 / 34.3-34.7 here, bf16
//    30.4-30.7 / 34.6-34.7 against 28.5-28.8 / 33.2-33.3, a [26,760, 512]
//    store 61.1-61.2 / 61.9 against 56.4-56.9 / 57.4;
//  - the wide-only descriptor instance without its register cap (1 block
//    an SM, not kMinBlocks) was slower on the QR step's 30 stores of 128
//    columns: 39.0 / 42.7 against 36.9 / 40.5;
//  - against the first design's kernel, a single wide store is faster at
//    128 columns (30.4 / 34.3-34.7 against 32.7-32.9 / 37.1) and slower at
//    256 (7.8-7.9 / 16.2 against 7.9-8.0 / 16.0-16.1) and 512 (56.4-56.9 /
//    57.4 against 55.1-55.3 / 55.3). No train step finishes a single store
//    that wide: the processed model's groups of 256 and 512 columns are
//    finished grouped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;       // warps per block
constexpr int kMaxDescs = 64;   // descriptors a launch (parameter block < 4 KB)
constexpr int kMinBlocks = 8;   // blocks an SM holds, a launch of one route and type

struct Desc {
  void* store;
  float* acc;
  const float* g;
  long long rows;
  int dim;
  int bf16;
};

struct Batch {
  Desc d[kMaxDescs];
  long long unit_end[kMaxDescs];  // inclusive prefix sum of the descriptors' units
  const float* lr;
  float eps;
  int n;
};
static_assert(sizeof(Batch) < 4096, "the parameter block must stay under 4 KB");

// A row's lanes on the narrow route: the power of two >= its 16-byte
// chunks (dim % 4 == 0, dim <= 64) or >= its columns (scalar, dim <= 16),
// 1 to 16; 0 for a row that takes the wide route (a warp).
__host__ __device__ inline int narrow_lanes(int dim) {
  const bool vec = dim % 4 == 0;
  if (vec ? dim > 64 : dim > 16) return 0;
  const int chunks = vec ? dim / 4 : dim;
  int g = 1;
  while (g < chunks) g <<= 1;
  return g;
}

// The rows a warp finishes (a unit): a row of each of its 32 / G lane
// groups, or one row.
__host__ __device__ inline long long unit_rows(int dim) {
  const int g = narrow_lanes(dim);
  return g ? 32 / g : 1;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// g * g rounded before the add, as the JAX package squares then sums (the
// compiler would otherwise contract the two into one fma)
__device__ __forceinline__ float square_add(float sq, float v) {
  return __fadd_rn(sq, __fmul_rn(v, v));
}

__device__ __forceinline__ float step(float s, float g, float lr, float denom) {
  return s - (lr * g) / denom;
}

__device__ __forceinline__ float4 step4(float4 s, float4 g, float lr, float denom) {
  return make_float4(step(s.x, g.x, lr, denom), step(s.y, g.y, lr, denom),
                     step(s.z, g.z, lr, denom), step(s.w, g.w, lr, denom));
}

// Route 1, narrow rows: unit u of one store, G lanes a row and a row of
// 32 / G rows a lane group, one 16-byte chunk (or one column) a lane.
template <typename T, bool kVec, int G>
__device__ void finish_lane_groups(const Desc& d, long long u, const float* lr_at,
                                   float eps) {
  const int lane = threadIdx.x % 32;
  const int sub = lane % G;  // the lane's place in its row's group
  const long long r = u * (32 / G) + lane / G;
  const unsigned seg_mask = ((1u << G) - 1u) << (lane / G * G);  // the row's lanes
  const int dim = d.dim;
  const int c = sub * (kVec ? 4 : 1);
  const bool live = r < d.rows && c < dim;
  const float* gp = d.g + r * dim + c;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    if (kVec) x = load4(gp);
    else x.x = *gp;
  }
  float sq = square_add(0.0f, x.x);
  bool nz = x.x != 0.0f;
  if (kVec) {
    sq = square_add(sq, x.y);
    sq = square_add(sq, x.z);
    sq = square_add(sq, x.w);
    nz |= x.y != 0.0f || x.z != 0.0f || x.w != 0.0f;
  }
  const bool hot = (__ballot_sync(0xffffffffu, nz) & seg_mask) != 0;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off, G);
  if (!hot) return;
  const float a = d.acc[r] + sq / static_cast<float>(dim);
  const float denom = sqrtf(a) + eps;
  const float lr = *lr_at;
  if (sub == 0) d.acc[r] = a;
  if (c >= dim) return;
  T* p = static_cast<T*>(d.store) + r * dim + c;
  if (kVec) store4(p, step4(load4(p), x, lr, denom));
  else store1(p, step(load1(p), x.x, lr, denom));
}

// Route 2, wide rows: row u of one store, a warp a row, the columns in a
// loop (16 bytes a lane, or one column).
template <typename T, bool kVec>
__device__ void finish_warp_row(const Desc& d, long long r, const float* lr_at, float eps) {
  const int lane = threadIdx.x % 32;
  const int dim = d.dim;
  const float* gr = d.g + r * dim;
  T* sr = static_cast<T*>(d.store) + r * dim;
  float sq = 0.0f;
  bool nonzero = false;
  if (kVec) {
    for (int c = 4 * lane; c < dim; c += 128) {
      const float4 v = load4(gr + c);
      sq = square_add(sq, v.x);
      sq = square_add(sq, v.y);
      sq = square_add(sq, v.z);
      sq = square_add(sq, v.w);
      nonzero |= v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
    }
  } else {
    for (int c = lane; c < dim; c += 32) {
      const float v = gr[c];
      sq = square_add(sq, v);
      nonzero |= v != 0.0f;
    }
  }
  if (!__any_sync(0xffffffffu, nonzero)) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float a = d.acc[r] + sq / static_cast<float>(dim);
  const float denom = sqrtf(a) + eps;
  const float lr = *lr_at;
  if (lane == 0) d.acc[r] = a;
  if (kVec) {
    for (int c = 4 * lane; c < dim; c += 128)
      store4(sr + c, step4(load4(sr + c), load4(gr + c), lr, denom));
  } else {
    for (int c = lane; c < dim; c += 32)
      store1(sr + c, step(load1(sr + c), gr[c], lr, denom));
  }
}

// One unit on its descriptor's route; kNarrow / kWide say which routes the
// launch's descriptors take.
template <typename T, bool kNarrow, bool kWide>
__device__ void finish_unit(const Desc& d, long long u, const float* lr, float eps) {
  const bool vec = d.dim % 4 == 0;
  const int lanes = kNarrow ? narrow_lanes(d.dim) : 0;
  if (kWide && lanes == 0) {
    if (vec) finish_warp_row<T, true>(d, u, lr, eps);
    else finish_warp_row<T, false>(d, u, lr, eps);
    return;
  }
  if (!kNarrow) return;
  switch (lanes) {
    case 1: vec ? finish_lane_groups<T, true, 1>(d, u, lr, eps)
                : finish_lane_groups<T, false, 1>(d, u, lr, eps); return;
    case 2: vec ? finish_lane_groups<T, true, 2>(d, u, lr, eps)
                : finish_lane_groups<T, false, 2>(d, u, lr, eps); return;
    case 4: vec ? finish_lane_groups<T, true, 4>(d, u, lr, eps)
                : finish_lane_groups<T, false, 4>(d, u, lr, eps); return;
    case 8: vec ? finish_lane_groups<T, true, 8>(d, u, lr, eps)
                : finish_lane_groups<T, false, 8>(d, u, lr, eps); return;
    default: vec ? finish_lane_groups<T, true, 16>(d, u, lr, eps)
                 : finish_lane_groups<T, false, 16>(d, u, lr, eps); return;
  }
}

// A launch whose stores are f32 and bf16 both.
struct MixedTypes {};

// The units of all descriptors form one sequence, a warp each: warp w
// finds its descriptor by a binary search over the prefix of the units.
// An instance a set of routes and store types, each with the registers its
// own code needs: a launch of one route and one type holds kMinBlocks
// blocks an SM.
template <typename T, bool kNarrow, bool kWide>
__global__ void __launch_bounds__(
    kWarps * 32, (kNarrow && kWide) || std::is_same<T, MixedTypes>::value ? 1 : kMinBlocks)
dense_finish_kernel(__grid_constant__ const Batch b) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= b.unit_end[b.n - 1]) return;  // warp-uniform
  int lo = 0, hi = b.n - 1;  // the first descriptor whose units end past w
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (b.unit_end[mid] > w) hi = mid;
    else lo = mid + 1;
  }
  const Desc& d = b.d[lo];
  const long long u = w - (lo ? b.unit_end[lo - 1] : 0);
  if constexpr (std::is_same<T, MixedTypes>::value) {
    if (d.bf16) finish_unit<__nv_bfloat16, kNarrow, kWide>(d, u, b.lr, b.eps);
    else finish_unit<float, kNarrow, kWide>(d, u, b.lr, b.eps);
  } else {
    finish_unit<T, kNarrow, kWide>(d, u, b.lr, b.eps);
  }
}

using Kernel = void (*)(const Batch);

// A launch of one store: the store as parameters, no descriptor search; on
// wide rows (G = 0) a warp a row as the kernel's first design had it.
template <typename T, bool kVec, int G>
__global__ void __launch_bounds__(kWarps * 32)
dense_finish_one_kernel(const Desc d, const float* lr, float eps) {
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u * (G ? 32 / G : 1) >= d.rows) return;  // warp-uniform
  if constexpr (G > 0) finish_lane_groups<T, kVec, G>(d, u, lr, eps);
  else finish_warp_row<T, kVec>(d, u, lr, eps);
}

template <typename T, bool kVec>
cudaError_t launch_one(const Desc& d, const float* lr, float eps, unsigned blocks,
                       cudaStream_t stream) {
  switch (narrow_lanes(d.dim)) {
    case 0: dense_finish_one_kernel<T, kVec, 0><<<blocks, kWarps * 32, 0, stream>>>(d, lr, eps); break;
    case 1: dense_finish_one_kernel<T, kVec, 1><<<blocks, kWarps * 32, 0, stream>>>(d, lr, eps); break;
    case 2: dense_finish_one_kernel<T, kVec, 2><<<blocks, kWarps * 32, 0, stream>>>(d, lr, eps); break;
    case 4: dense_finish_one_kernel<T, kVec, 4><<<blocks, kWarps * 32, 0, stream>>>(d, lr, eps); break;
    case 8: dense_finish_one_kernel<T, kVec, 8><<<blocks, kWarps * 32, 0, stream>>>(d, lr, eps); break;
    default: dense_finish_one_kernel<T, kVec, 16><<<blocks, kWarps * 32, 0, stream>>>(d, lr, eps);
  }
  return cudaGetLastError();
}

template <typename T>
Kernel kernel_for(bool narrow, bool wide) {
  return !wide ? dense_finish_kernel<T, true, false>
         : !narrow ? dense_finish_kernel<T, false, true> : dense_finish_kernel<T, true, true>;
}

}  // namespace

// Finishes n <= 64 stores in one launch on `stream` (a cudaStream_t) on
// device `device`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for n out of range. Store i is stores[i] [rows[i],
// dims[i]] (f32, or bf16 when store_bf16[i]), with its gradient gs[i] of
// the same shape in f32 and its accumulator accs[i] of at least rows[i]
// floats, all contiguous; where dims[i] % 4 == 0 the store and gradient
// bases are 16-byte aligned. lr points to one f32 on the device. The
// arrays are the host's: their values go into the kernel's parameter block.
// Stores with no rows are skipped; with none left nothing is launched.
extern "C" int rwsadagrad_dense_finish_many(int n, void* const* stores,
                                            const int* store_bf16,
                                            float* const* accs,
                                            const float* const* gs,
                                            const long long* rows,
                                            const int* dims, const float* lr,
                                            float eps, int device, void* stream) {
  if (n < 1 || n > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Batch b;
  int k = 0;
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    if (dims[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (rows[i] <= 0) continue;
    total += (rows[i] + unit_rows(dims[i]) - 1) / unit_rows(dims[i]);
    b.d[k] = Desc{stores[i], accs[i], gs[i], rows[i], dims[i], store_bf16[i] ? 1 : 0};
    b.unit_end[k] = total;
    ++k;
  }
  if (k == 0) return 0;
  b.n = k;
  b.lr = lr;
  b.eps = eps;
  const long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    const Desc& d = b.d[0];
    const bool vec = d.dim % 4 == 0;
    const unsigned nb = static_cast<unsigned>(blocks);
    return static_cast<int>(
        d.bf16 ? (vec ? launch_one<__nv_bfloat16, true>(d, lr, eps, nb, s)
                      : launch_one<__nv_bfloat16, false>(d, lr, eps, nb, s))
               : (vec ? launch_one<float, true>(d, lr, eps, nb, s)
                      : launch_one<float, false>(d, lr, eps, nb, s)));
  }
  bool narrow = false, wide = false, f32 = false, bf16 = false;
  for (int i = 0; i < k; ++i) {
    (narrow_lanes(b.d[i].dim) ? narrow : wide) = true;
    (b.d[i].bf16 ? bf16 : f32) = true;
  }
  const Kernel kernel = !bf16 ? kernel_for<float>(narrow, wide)
                      : !f32 ? kernel_for<__nv_bfloat16>(narrow, wide)
                             : kernel_for<MixedTypes>(narrow, wide);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// The one-store case: store [R, dim] (f32, or bf16 when store_bf16) and g
// [R, dim] f32 contiguous; acc holds at least R floats; with dim % 4 == 0
// the bases are 16-byte aligned; lr points to one f32 on the device.
extern "C" int rwsadagrad_dense_finish(void* store, int store_bf16, float* acc,
                                       const float* g, long long R, int dim,
                                       const float* lr, float eps, int device,
                                       void* stream) {
  return rwsadagrad_dense_finish_many(1, &store, &store_bf16, &acc, &g, &R, &dim,
                                      lr, eps, device, stream);
}
