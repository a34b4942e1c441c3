// Write-only sparse row update for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrm_yx_tpu/ops/pallas_sparse_update.py,
// sparse_rows_overwrite (the blind-write pass _wkernel and the serialized
// duplicate tail _tail_kernel). For items k of one batch, in place:
//
//   the row of k occurs once among the active items:  store[idx[k]] = new_vals[k]
//   it occurs several times:  store[idx[k]] += delta[k], in ascending k
//   k is inactive:            nothing
//
// The wrapper (ops/sparse_rows_overwrite.py) hands the kernel the items
// sorted by row with a stable sort: key[p] is the p-th smallest row id
// (inactive items carry kInactive and sort last) and order[p] is the item
// it came from. Equal keys are neighbours, in ascending item order.
//
// Bound on an H100 SXM: memory. At the training shape (K = 16,384 items of
// 128 f32, all rows unique) it reads each new_vals row once and writes each
// store row once: 2 x 8.4 MB = 16.8 MB, about 5 us at 3.35 TB/s; the keys
// and the order add 0.2 MB. There is no arithmetic to speak of.
//
// Design: one warp per sorted position. A position whose key differs from
// both neighbours copies its item's new_vals row to the store with 16-byte
// loads and stores. The first position of a run of equal keys walks the
// whole run: each lane holds its own columns of the store row in registers
// and adds the run's delta rows to them in ascending item order, so every
// element takes the same serial sum as the TPU kernel's tail, without
// atomics and without a second launch. Runs of different rows are disjoint
// and proceed in parallel; the other positions of a run do nothing. The
// TPU kernel's DMA slot window, its redirection of dead items to a
// sentinel row and its 64-item tail blocks have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInactive = 1 << 30;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparse_rows_overwrite_kernel(float* __restrict__ store,
                             const int* __restrict__ key,
                             const long long* __restrict__ order,
                             const float* __restrict__ new_vals,
                             const float* __restrict__ delta, int K, int W) {
  const int p = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= K) return;
  const int row = key[p];
  if (row >= kInactive) return;
  const bool first = p == 0 || key[p - 1] != row;
  if (!first) return;  // the run's first position applies the whole run
  const int w4 = W / 4;
  float4* dst = reinterpret_cast<float4*>(store + static_cast<long long>(row) * W);
  const bool unique = p + 1 == K || key[p + 1] != row;
  if (unique) {
    const float4* src =
        reinterpret_cast<const float4*>(new_vals + order[p] * W);
    for (int c = lane; c < w4; c += 32) dst[c] = src[c];
    return;
  }
  for (int c = lane; c < w4; c += 32) {
    float4 v = dst[c];
    for (int q = p; q < K && key[q] == row; ++q) {
      const float4 d = reinterpret_cast<const float4*>(delta + order[q] * W)[c];
      v.x += d.x;
      v.y += d.y;
      v.z += d.z;
      v.w += d.w;
    }
    dst[c] = v;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. store [R, W], new_vals and
// delta [K, W] are contiguous f32 with W % 4 == 0 and 16-byte aligned
// bases; key [K] int32 ascending, order [K] int64 (a stable sort's
// permutation); active keys are row ids below R.
extern "C" int sparse_rows_overwrite(float* store, const int* key,
                                     const long long* order,
                                     const float* new_vals, const float* delta,
                                     int K, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K == 0) return 0;
  const int blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sparse_rows_overwrite_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      store, key, order, new_vals, delta, K, W);
  return static_cast<int>(cudaGetLastError());
}
