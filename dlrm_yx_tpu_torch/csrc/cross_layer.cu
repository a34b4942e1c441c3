// DLRM-DCNv2's cross layers, element-wise, for Hopper (sm_90a): K8.
//
// Replaces no TPU kernel. The JAX package has no cross network; the port's
// own (ops/dcn.py) took each layer
//
//   x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l
//
// as two bf16 GEMMs with f32 output and some ten torch passes over [B, N]
// f32 around them a layer, forward and backward (the bias add, the
// Hadamard product, the residual, the casts to and from bf16, the
// products' cotangents, x0's gradient summed by autograd, the bias's
// gradient reduced). The GEMMs stay torch.mm (ops/dcn.py); these kernels
// do everything between them, each element read and written once a layer:
//
//   cross_layer_fwd        a layer's forward: reads xw (the second
//                          product's f32 output), b, x0 and x_l; writes
//                          x_{l+1} = x0 * (xw + b) + x_l in f32 and, but
//                          at the top layer, its bf16 copy (the next
//                          layer's operand): 18 bytes an element
//   cross_layer_bwd        a layer's backward, top layer first: forms the
//                          cotangent g of x_{l+1} as the incoming g plus
//                          f32(bf16(gx)), gx the layer above's first
//                          product's f32 input gradient (the rounding that
//                          _F32OutProduct and the .to(bf16) cast's backward
//                          make); writes g for the layer below, bf16(g *
//                          x0) (the second product's cotangent, rounded
//                          where _F32OutProduct.backward rounds it), adds
//                          g * (xw + b) to x0's gradient in place (writes
//                          it at the top layer; adds g too at the bottom
//                          layer, the residual's share), and each band of
//                          rows' f32 column sums of g * x0: 30 bytes an
//                          element (the top layer 18, the bottom 26)
//   cross_layer_bias_grad  b's gradient: the bands' sums added in band
//                          order (kBiasGroups runs of consecutive bands,
//                          each in order, then the runs in order)
//   cross_layer_x0_grad    after the bottom layer's products: x0's
//                          gradient plus f32(bf16(gx_0)), the bottom
//                          operand's share: 12 bytes an element
//
// Every add and multiply is __fadd_rn / __fmul_rn: nvcc contracts a * b + c
// into an FMA by default, and torch's separate kernels round each step, so
// the forward gives torch's bits. Nothing is summed with atomics: a band's
// rows are summed in row order by one thread, the bands in a fixed order,
// so two calls give the same bits. ops/dcn.py's plain version repeats each
// kernel's arithmetic and order.
//
// Bound on an H100 SXM: memory. At DLRM-DCNv2's cell (B = 8,192, N =
// 3,456) one f32 pass over [B, N] is 113 MB, 0.034 ms at 3.35 TB/s; a
// layer's forward moves 18 and its backward 30 bytes an element, 48
// B N a layer, 4.08 GB a step at three layers: 1.22 ms, against some
// 108 B N a layer in the torch passes. Design: each thread moves 8
// elements (two 16-byte loads a tensor), so N must be a multiple of 8;
// the forward is a grid-stride loop over the elements; the backward gives
// a thread a column vector of 8 and a band of consecutive rows, so the
// bias's column sums stay in registers, with enough bands to fill the 132
// SMs (ops/dcn.band_rows); a warp's 32 threads read 32 neighbouring
// vectors of one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVec = 8;           // elements a thread moves at a time
constexpr int kThreads = 256;     // threads a block (forward, backward, finish)
constexpr int kGridBlocks = 132 * 8;  // the forward's and finish's grid-stride grid
constexpr int kBiasColumns = 32;  // the bias sum: columns a block
constexpr int kBiasGroups = 8;    // the bias sum: runs of bands a column

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const unsigned*>(&h);
}

// 8 values rounded to bf16 (to nearest, ties to even, as torch's .to)
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* p, const float (&v)[kVec]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
    cross_layer_fwd(const float* __restrict__ xw, const float* __restrict__ b,
                    const float* __restrict__ x0, const float* __restrict__ x,
                    float* __restrict__ out, __nv_bfloat16* __restrict__ out16, long long nvec,
                    int row_vecs) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const long long off = i * kVec;
    float w[kVec], bb[kVec], z[kVec], xl[kVec], y[kVec];
    load8(xw + off, w);
    load8(b + static_cast<int>(i % row_vecs) * kVec, bb);
    load8(x0 + off, z);
    load8(x + off, xl);
#pragma unroll
    for (int j = 0; j < kVec; ++j) y[j] = __fadd_rn(__fmul_rn(z[j], __fadd_rn(w[j], bb[j])), xl[j]);
    store8(out + off, y);
    if (out16 != nullptr) store8_bf16(out16 + off, y);
  }
}

// One thread a (band, column vector): rows [band * rows_per_band, ...) in
// order. g_out may be g_in (each element is read, then written, by one
// thread), or null (not written); gx null at the top layer. x0's gradient
// is written (the top layer) or added to (add_x0grad), with the cotangent
// added after the product where with_g is set (the bottom layer: the
// residual's share).
__global__ void __launch_bounds__(kThreads)
    cross_layer_bwd(const float* g_in, const float* __restrict__ gx,
                    const float* __restrict__ x0, const float* __restrict__ xw,
                    const float* __restrict__ b, float* g_out, __nv_bfloat16* __restrict__ t16,
                    float* __restrict__ x0grad, int add_x0grad, int with_g,
                    float* __restrict__ partial,
                    long long rows, int row_vecs, int rows_per_band, long long nbands) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= nbands * row_vecs) return;
  const long long band = tid / row_vecs;
  const int col = static_cast<int>(tid - band * row_vecs) * kVec;
  const long long width = static_cast<long long>(row_vecs) * kVec;
  float bb[kVec], acc[kVec];
  load8(b + col, bb);
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  const long long r0 = band * rows_per_band;
  const long long r1 = r0 + rows_per_band < rows ? r0 + rows_per_band : rows;
  for (long long r = r0; r < r1; ++r) {
    const long long off = r * width + col;
    float g[kVec], z[kVec], w[kVec], t[kVec], a[kVec];
    load8(g_in + off, g);
    if (gx != nullptr) {
      float q[kVec];
      load8(gx + off, q);
#pragma unroll
      for (int j = 0; j < kVec; ++j) g[j] = __fadd_rn(g[j], round_bf16(q[j]));
    }
    load8(x0 + off, z);
    load8(xw + off, w);
    if (add_x0grad) load8(x0grad + off, a);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      t[j] = __fmul_rn(g[j], z[j]);
      acc[j] = __fadd_rn(acc[j], t[j]);
      const float u = __fmul_rn(g[j], __fadd_rn(w[j], bb[j]));
      a[j] = add_x0grad ? __fadd_rn(a[j], u) : u;
      if (with_g) a[j] = __fadd_rn(a[j], g[j]);
    }
    if (g_out != nullptr) store8(g_out + off, g);
    store8_bf16(t16 + off, t);
    store8(x0grad + off, a);
  }
  store8(partial + band * width + col, acc);
}

// A block: kBiasColumns columns (x) by kBiasGroups runs of bands (y); a
// run's bands summed in order, then the runs in order.
__global__ void __launch_bounds__(kBiasColumns * kBiasGroups)
    cross_layer_bias_grad(const float* __restrict__ partial, float* __restrict__ gb, int width,
                          long long nbands) {
  __shared__ float run_sum[kBiasGroups][kBiasColumns];
  const int c = blockIdx.x * kBiasColumns + threadIdx.x;
  const long long per = (nbands + kBiasGroups - 1) / kBiasGroups;
  const long long k0 = threadIdx.y * per;
  const long long k1 = k0 + per < nbands ? k0 + per : nbands;
  float s = 0.f;
  if (c < width)
    for (long long k = k0; k < k1; ++k) s = __fadd_rn(s, partial[k * width + c]);
  run_sum[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || c >= width) return;
  float total = run_sum[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < kBiasGroups; ++y) total = __fadd_rn(total, run_sum[y][threadIdx.x]);
  gb[c] = total;
}

__global__ void __launch_bounds__(kThreads)
    cross_layer_x0_grad(float* __restrict__ x0grad, const float* __restrict__ gx, long long nvec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const long long off = i * kVec;
    float a[kVec], q[kVec];
    load8(x0grad + off, a);
    load8(gx + off, q);
#pragma unroll
    for (int j = 0; j < kVec; ++j) a[j] = __fadd_rn(a[j], round_bf16(q[j]));
    store8(x0grad + off, a);
  }
}

bool aligned(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

int grid_for(long long nvec) {
  const long long blocks = (nvec + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kGridBlocks ? blocks : kGridBlocks);
}

}  // namespace

extern "C" int cross_layer_vec() { return kVec; }
extern "C" int cross_layer_bias_groups() { return kBiasGroups; }

// cross_layer_fwd on `stream` (a cudaStream_t) on `device`: one launch;
// returns cudaGetLastError(), 0 on success. xw, x0, x, out [rows, width]
// f32 and out16 [rows, width] bf16 (or null: not written), b [width] f32,
// all contiguous and 16-byte aligned; width a multiple of 8.
extern "C" int cross_layer_forward(const float* xw, const float* b, const float* x0,
                                   const float* x, float* out, void* out16, long long rows,
                                   int width, int device, void* stream) {
  if (rows < 1 || width < kVec || width % kVec || !aligned(xw) || !aligned(b) ||
      !aligned(x0) || !aligned(x) || !aligned(out) || (out16 != nullptr && !aligned(out16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nvec = rows * (width / kVec);
  cross_layer_fwd<<<grid_for(nvec), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xw, b, x0, x, out, static_cast<__nv_bfloat16*>(out16), nvec, width / kVec);
  return static_cast<int>(cudaGetLastError());
}

// cross_layer_bwd, then cross_layer_bias_grad, on `stream` on `device`:
// two launches; returns cudaGetLastError(). g_in, x0, xw, x0grad [rows,
// width] f32; gx [rows, width] f32 or null (the top layer); g_out [rows,
// width] f32, g_in itself, or null (not written); t16 [rows, width] bf16;
// b and gb [width] f32; add_x0grad: add g * (xw + b) to x0grad (else
// write it); with_g: add the cotangent to x0grad after it; partial [ceil(rows / rows_per_band), width] f32, scratch
// written before it is read. Contiguous and 16-byte aligned; width a
// multiple of 8.
extern "C" int cross_layer_backward(const float* g_in, const float* gx, const float* x0,
                                    const float* xw, const float* b, float* g_out, void* t16,
                                    float* x0grad, int add_x0grad, int with_g, float* partial,
                                    float* gb,
                                    long long rows, int width, int rows_per_band, int device,
                                    void* stream) {
  if (rows < 1 || width < kVec || width % kVec || rows_per_band < 1 || !aligned(g_in) || (gx != nullptr && !aligned(gx)) ||
      !aligned(x0) || !aligned(xw) || !aligned(b) || (g_out != nullptr && !aligned(g_out)) ||
      !aligned(t16) || !aligned(x0grad) || !aligned(partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_vecs = width / kVec;
  const long long nbands = (rows + rows_per_band - 1) / rows_per_band;
  const long long threads = nbands * row_vecs;
  cross_layer_bwd<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      g_in, gx, x0, xw, b, g_out, static_cast<__nv_bfloat16*>(t16), x0grad, add_x0grad, with_g,
      partial, rows, row_vecs, rows_per_band, nbands);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_layer_bias_grad<<<(width + kBiasColumns - 1) / kBiasColumns,
                          dim3(kBiasColumns, kBiasGroups), 0, s>>>(partial, gb, width, nbands);
  return static_cast<int>(cudaGetLastError());
}

// cross_layer_x0_grad on `stream` on `device`: one launch; returns
// cudaGetLastError(). x0grad and gx [rows, width] f32, contiguous and
// 16-byte aligned; width a multiple of 8.
extern "C" int cross_layer_finish(float* x0grad, const float* gx, long long rows, int width,
                                  int device, void* stream) {
  if (rows < 1 || width < kVec || width % kVec || !aligned(x0grad) || !aligned(gx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nvec = rows * (width / kVec);
  cross_layer_x0_grad<<<grid_for(nvec), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0grad, gx, nvec);
  return static_cast<int>(cudaGetLastError());
}
