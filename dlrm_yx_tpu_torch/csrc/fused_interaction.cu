// Fused DLRM dot interaction, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_yx_tpu/ops/pallas_interaction.py
// (fused_interaction_fwd, _fwd_kernel). For each batch row b:
//
//   T   = [x[b]; ly[b, 0]; ...; ly[b, S-1]]            F = S + 1 rows of D
//   Tc  = T rounded to bf16 (kept as floats) when round_bf16, else T
//   out[b, 0:D)     = x[b]                  (the unrounded f32 x)
//   out[b, D + p)   = <Tc[i_p], Tc[j_p]>    f32 FMA accumulation
//
// with (i_p, j_p) the p-th pair of torch.tril_indices(F, F, offset) in
// row-major order: offset -1 (strict lower triangle) or 0 when diag = 1
// (interact_itself).
//
// Bound on an H100 SXM: memory. At the serving shape (B=2048, S=26, D=128,
// P=351) it reads 2048*27*128*4 B = 28.3 MB and writes 2048*479*4 B = 3.9 MB:
// 32.2 MB at 3.35 TB/s is about 9.6 us. The arithmetic, 2*B*P*D = 0.18 GFLOP,
// takes under 3 us at the f32 rate.
//
// Design: one block per batch row, one thread per pair (P = 351 -> 352
// threads). The block stages its F x D slab in shared memory with 16-byte
// loads, so each input element is read from device memory once and the
// concat [x; ly] is never materialised there. Each thread then takes the
// whole dot product of its pair from shared memory, four floats per load,
// into four independent accumulators. Rows are padded by 4 floats so that
// threads reading the same column of different rows hit different banks.
// Consecutive threads hold consecutive pairs, so the output row is written
// coalesced. What bounds it now is shared-memory bandwidth (each pair reads
// two rows), not device memory; no TPU mechanics carry over (no F->8 pad,
// no 0/1 selector matmul, no 128-lane output pad).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPad = 4;  // floats of padding per staged row

// Pairs before row i of the triangle: i*(i-1)/2 + diag*i.
__device__ __forceinline__ int row_start(int i, int diag) {
  return i * (i - 1) / 2 + diag * i;
}

// The (i, j) of the p-th pair in row-major tril order: i is the largest row
// with row_start(i) <= p (an empty row 0 is skipped when diag = 0).
__device__ __forceinline__ void pair_of(int p, int diag, int* i, int* j) {
  float est = diag ? (sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f
                   : (sqrtf(8.0f * p + 1.0f) + 1.0f) * 0.5f;
  int r = static_cast<int>(est);
  while (row_start(r + 1, diag) <= p) ++r;
  while (r > 0 && row_start(r, diag) > p) --r;
  *i = r;
  *j = p - row_start(r, diag);
}

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__global__ void __launch_bounds__(kMaxThreads)
fused_interaction_kernel(const float* __restrict__ x, long long x_stride_b,
                         const float* __restrict__ ly, long long ly_stride_b,
                         long long ly_stride_s, float* __restrict__ out,
                         int S, int D, int P, int diag, int round_bf16) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);  // [F, D + kPad]
  const int b = blockIdx.x;
  const int F = S + 1;
  const int ld = D + kPad;
  const int d4 = D / 4;
  float* ob = out + static_cast<long long>(b) * (D + P);

  // stage T, 4 floats per load: row 0 is x, rows 1..S are the slots; the
  // x lanes of the output take the unrounded value
  for (int e = threadIdx.x; e < F * d4; e += blockDim.x) {
    const int f = e / d4;
    const int k = (e - f * d4) * 4;
    float4 v;
    if (f == 0) {
      v = *reinterpret_cast<const float4*>(x + b * x_stride_b + k);
      ob[k] = v.x;
      ob[k + 1] = v.y;
      ob[k + 2] = v.z;
      ob[k + 3] = v.w;
    } else {
      v = *reinterpret_cast<const float4*>(
          ly + b * ly_stride_b + (f - 1) * ly_stride_s + k);
    }
    if (round_bf16) {
      v.x = round_to_bf16(v.x);
      v.y = round_to_bf16(v.y);
      v.z = round_to_bf16(v.z);
      v.w = round_to_bf16(v.w);
    }
    *reinterpret_cast<float4*>(t + f * ld + k) = v;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int i, j;
    pair_of(p, diag, &i, &j);
    const float4* ti = reinterpret_cast<const float4*>(t + i * ld);
    const float4* tj = reinterpret_cast<const float4*>(t + j * ld);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
    for (int k = 0; k < d4; ++k) {
      const float4 u = ti[k];
      const float4 w = tj[k];
      a0 = fmaf(u.x, w.x, a0);
      a1 = fmaf(u.y, w.y, a1);
      a2 = fmaf(u.z, w.z, a2);
      a3 = fmaf(u.w, w.w, a3);
    }
    ob[D + p] = (a0 + a1) + (a2 + a3);
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. out is [B, D + P] f32,
// contiguous. x rows and ly slots may be strided; the caller guarantees
// D % 4 == 0, 16-byte aligned x and ly, and strides that are multiples of 4.
extern "C" int fused_interaction_fwd(const float* x, long long x_stride_b,
                                     const float* ly, long long ly_stride_b,
                                     long long ly_stride_s, float* out, int B,
                                     int S, int D, int diag, int round_bf16,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int F = S + 1;
  const int P = F * (F - 1) / 2 + diag * F;
  const int threads = P >= kMaxThreads ? kMaxThreads : (P + 31) / 32 * 32;
  const size_t smem = sizeof(float) * static_cast<size_t>(F) * (D + kPad);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_interaction_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_interaction_kernel<<<B, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, x_stride_b, ly, ly_stride_b, ly_stride_s, out, S, D, P, diag,
      round_bf16);
  return static_cast<int>(cudaGetLastError());
}
