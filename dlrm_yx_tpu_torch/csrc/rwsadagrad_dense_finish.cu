// Row-wise Adagrad finish over a dense gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_yx_tpu/ops/pallas_dense_finish.py
// (rwsadagrad_dense_finish, _kernel and _finish_math). For every row r of
// the store [R, dim], with g = dense_g[r] the exactly coalesced gradient,
// in place and in the JAX package's order of operations:
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
// Bound on an H100 SXM: memory. At the training shape (the small-table
// group, R = 121,232 rows of 128 f32) the gradient must be read whole
// (62 MB); each touched row's store is read and written and its acc entry
// read and written. With every row touched that is 186 MB, about 56 us at
// 3.35 TB/s; a batch of 2048 touches fewer rows and the bound shrinks with
// them. The arithmetic, a few operations per element, is far below the
// f32 rate.
//
// Design: one warp per row. Each lane reads its columns of g (16 bytes at
// a time when dim % 4 == 0, else one element), sums their squares and
// whether any is nonzero; a warp vote finds the rows with no nonzero
// element, which return, and a butterfly of shuffles leaves the row's sum
// in every lane. The others
// read the store, update it and write it back, the same lanes on the same
// columns, and lane 0 writes acc[r]. The TPU kernel's 0/1 selector
// matmuls, which move per-row scalars between the row layout and the
// accumulator's [rows/128, 128] tiling, have no counterpart: acc is read
// and written as one float per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dense_finish_kernel(T* __restrict__ store, float* __restrict__ acc,
                    const float* __restrict__ g, long long R, int dim,
                    const float* __restrict__ lr_at, float eps) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;
  const float* gr = g + r * dim;
  T* sr = store + r * dim;
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
  const float a = acc[r] + sq / static_cast<float>(dim);
  const float denom = sqrtf(a) + eps;
  const float lr = *lr_at;
  if (lane == 0) acc[r] = a;
  if (kVec) {
    for (int c = 4 * lane; c < dim; c += 128) {
      const float4 v = load4(gr + c);
      float4 s = load4(sr + c);
      s.x = step(s.x, v.x, lr, denom);
      s.y = step(s.y, v.y, lr, denom);
      s.z = step(s.z, v.z, lr, denom);
      s.w = step(s.w, v.w, lr, denom);
      store4(sr + c, s);
    }
  } else {
    for (int c = lane; c < dim; c += 32)
      store1(sr + c, step(load1(sr + c), gr[c], lr, denom));
  }
}

template <typename T>
cudaError_t launch(T* store, float* acc, const float* g, long long R, int dim,
                   const float* lr, float eps, cudaStream_t stream) {
  const long long blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (dim % 4 == 0)
    dense_finish_kernel<T, true><<<static_cast<unsigned>(blocks),
                                   kWarpsPerBlock * 32, 0, stream>>>(
        store, acc, g, R, dim, lr, eps);
  else
    dense_finish_kernel<T, false><<<static_cast<unsigned>(blocks),
                                    kWarpsPerBlock * 32, 0, stream>>>(
        store, acc, g, R, dim, lr, eps);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. store [R, dim] (f32, or bf16
// when store_bf16) and g [R, dim] f32 are contiguous; acc holds at least R
// floats; with dim % 4 == 0 the bases are 16-byte aligned; lr points to one
// f32 on the device.
extern "C" int rwsadagrad_dense_finish(void* store, int store_bf16, float* acc,
                                       const float* g, long long R, int dim,
                                       const float* lr, float eps, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = store_bf16
            ? launch(static_cast<__nv_bfloat16*>(store), acc, g, R, dim, lr, eps, s)
            : launch(static_cast<float*>(store), acc, g, R, dim, lr, eps, s);
  return static_cast<int>(err);
}
