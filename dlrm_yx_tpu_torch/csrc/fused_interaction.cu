// Fused DLRM dot interaction, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_yx_tpu/ops/pallas_interaction.py
// (fused_interaction_fwd, _fwd_kernel). For each batch row b:
//
//   T   = [x[b]; ly[b, 0]; ...; ly[b, S-1]]            F = S + 1 rows of D
//   Tc  = T rounded to bf16 when round_bf16, else T
//   out[b, 0:D)     = x[b]                  (the unrounded f32 x)
//   out[b, D + p)   = <Tc[i_p], Tc[j_p]>    summed in f32
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
// Design: a thread a pair would read two whole rows from shared memory for
// every pair, ~360 KB a batch row, whose time exceeds the device-memory
// bound; both routes here cut those reads, read each input element from
// device memory once and never materialise the concat [x; ly]:
//   * f32 at the Criteo models' shape (F = 27, D = 128), the CLI's default
//     compute dtype: a warp a batch row with no shared memory. Lane l holds
//     columns 4l..4l+3 of all F rows in registers (F 16-byte loads in flight
//     together), forms every pair's partial dot product over its 4 columns
//     (no triangle padding: each FMA is a pair's), and a reduce-scatter of
//     shuffles over 32 pairs at a time leaves lane l with pair l's sum. The
//     pairs are expanded at compile time, so nothing is indexed at run time.
//   * every other shape, and bf16: a persistent grid whose blocks take
//     kRows batch rows at a time. The rows' F x D slabs go to shared memory
//     by cp.async (16 bytes a copy), and the pair sums come from there in
//     tiles, which cuts the shared-memory reads per pair:
//       - f32: kSplit lanes own a 4 x 4 block of the lower triangle (F
//         padded to a multiple of 4 by zero rows), each over every
//         kSplit-th 4-float column, with 16 sums in registers added across
//         the lanes at the end; a k-step reads 8 row vectors for 64 FMAs.
//         Rows are padded (4 floats, and 4 more after every 8 rows) so that
//         the rows 4 apart that a warp reads at one column fall in
//         different banks.
//       - bf16: a warp forms 16 x 8 tiles of the Gram matrix with
//         mma.sync.m16n8k16 (bf16 in, f32 sums), only the tiles that meet
//         the lower triangle; the fragments are read from the f32 slab and
//         rounded to bf16 on the way (rows past F read as 0), as the plain
//         version rounds T. A bf16 x bf16 product is exact in f32, so only
//         the order of the sums differs from the plain version. Rows are
//         padded by 8 floats: a fragment's 8-byte reads then hit 32
//         different banks. wgmma wants 64-row tiles: a 27 x 27 Gram a
//         sample is too small for it.
//     The sums go to a staging buffer, and the block writes its rows [x |
//     pairs], which lie next to each other in out, with coalesced stores
//     (x from the slab, unrounded). Small blocks (two rows, 128 threads,
//     ~32 KB) let up to 7 run on an SM, so one block's loads overlap
//     another's arithmetic; a second buffer per block was no faster.
// No tensor cores for f32: TF32 keeps ~3 digits, and the JAX kernel runs at
// Precision.HIGHEST. No TPU mechanics carry over (no F->8 pad, no 0/1
// selector matmul, no 128-lane output pad).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kRows = 2;     // batch rows a group
constexpr int kThreads = 128;
constexpr int kSplit = 2;    // f32 tiles: lanes a 4 x 4 tile (1, 2 or 4)
constexpr int kSmemLimit = 232448;

// Pairs before row i of the triangle: i*(i-1)/2 + diag*i.
__host__ __device__ __forceinline__ int row_start(int i, int diag) {
  return i * (i - 1) / 2 + diag * i;
}

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The largest t with t*(t+1)/2 <= u (u >= 0).
__device__ __forceinline__ int tri_root(int u) {
  int t = static_cast<int>((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= u) ++t;
  while (t > 0 && t * (t + 1) / 2 > u) --t;
  return t;
}

// The staged slabs: batch row r's row f lies at row(r * Fp + f) floats.
struct Layout {
  int Fp;    // rows a slab: F rounded up (f32: to 4, zero rows; bf16: F)
  int ld;    // floats a row
  bool f32;  // 4 more floats after every 8 rows

  __host__ __device__ long long row(long long q) const {
    return q * ld + (f32 ? 4 * (q >> 3) : 0);
  }
  __host__ __device__ long long buffer_floats() const { return row(kRows * Fp); }
};

__host__ __device__ inline Layout layout(int F, int D, bool bf16) {
  return bf16 ? Layout{F, D + 8, false} : Layout{round_up(F, 4), D + 4, true};
}

// Bytes of shared memory a block needs: the slabs, then the pair sums of a
// group.
__host__ __device__ inline size_t smem_bytes(int F, int D, int P, bool bf16) {
  return 4 * (static_cast<size_t>(layout(F, D, bf16).buffer_floats()) +
              static_cast<size_t>(kRows) * P);
}

struct Args {
  const float* x;
  long long x_stride_b;
  const float* ly;
  long long ly_stride_b;
  long long ly_stride_s;
  float* out;
  int B, S, D, P, diag;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Request group g's slabs into buf (rows F..Fp-1 are left as they are).
// Thread e copies vectors e, e + blockDim, ...: its (batch row, row,
// column) steps by constants, so no division is done past the first.
__device__ __forceinline__ void load_group(const Args& a, const Layout& L, int g, float* buf) {
  const int F = a.S + 1;
  const int d4 = a.D / 4;
  const int b0 = g * kRows;
  const int n = min(kRows, a.B - b0) * F * d4;
  int q = threadIdx.x / d4;  // r * F + f
  int k4 = threadIdx.x - q * d4;
  int r = q / F;
  int f = q - r * F;
  const int step_q = blockDim.x / d4, step_k = blockDim.x - step_q * d4;
  const int step_r = step_q / F, step_f = step_q - step_r * F;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const long long b = b0 + r;
    const float* src = f == 0 ? a.x + b * a.x_stride_b + 4 * k4
                              : a.ly + b * a.ly_stride_b + (f - 1) * a.ly_stride_s + 4 * k4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(buf + L.row(static_cast<long long>(r) * L.Fp + f) + 4 * k4)),
                 "l"(src));
    k4 += step_k;
    const int carry = k4 >= d4;
    k4 -= carry * d4;
    f += step_f + carry;
    r += step_r;
    if (f >= F) {
      f -= F;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Sum (i, j) of batch row r's Gram matrix to its staging lane, when it is a
// pair of the triangle.
__device__ __forceinline__ void put(const Args& a, float* sums, int r, int i, int j, float v) {
  if (i < a.S + 1 && j < i + a.diag) sums[r * a.P + row_start(i, a.diag) + j] = v;
}

// The group's rows [x | pairs], where they lie in out: one coalesced run.
__device__ __forceinline__ void write_group(const Args& a, const Layout& L, int g,
                                            const float* buf, const float* sums) {
  const int b0 = g * kRows;
  const int nrows = min(kRows, a.B - b0);
  for (int r = 0; r < nrows; ++r) {
    float* dst = a.out + static_cast<long long>(b0 + r) * (a.D + a.P);
    const float* x = buf + L.row(static_cast<long long>(r) * L.Fp);
    for (int c = threadIdx.x; c < a.D; c += blockDim.x) dst[c] = x[c];
    for (int c = threadIdx.x; c < a.P; c += blockDim.x) dst[a.D + c] = sums[r * a.P + c];
  }
}

// f32: kSplit lanes a 4 x 4 tile, each over a kSplit-th of D.
__device__ __forceinline__ void gram_f32(const Args& a, const Layout& L, int nrows,
                                         const float* buf, float* sums) {
  const int nt = L.Fp / 4;
  const int tiles = nt * (nt + 1) / 2;
  const int units = kSplit * nrows * tiles;
  const int lane = threadIdx.x % 32;
  const int part_d4 = a.D / (4 * kSplit);
  const int ld4 = L.ld / 4;
  for (int u0 = threadIdx.x - lane; u0 < units; u0 += blockDim.x) {
    const int u = u0 + lane;
    const bool on = u < units;
    const int tile = (on ? u : 0) / kSplit;
    const int part = u % kSplit;
    const int r = tile / tiles;
    const int t = tile - r * tiles;
    const int ti = tri_root(t);
    const int tj = t - ti * (ti + 1) / 2;
    // a tile's 4 rows share one 8-row group: they lie ld apart
    // lane `part` takes the 4-float columns part, part + kSplit, ...: the
    // lanes of a tile read neighbouring columns, in different banks
    const float4* ri = reinterpret_cast<const float4*>(buf + L.row(r * L.Fp + 4 * ti)) + part;
    const float4* rj = reinterpret_cast<const float4*>(buf + L.row(r * L.Fp + 4 * tj)) + part;
    float acc[4][4] = {};
    if (on) {
#pragma unroll 2
      for (int k = 0; k < part_d4; ++k) {
        float4 u4[4], w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u4[i] = ri[i * ld4 + k * kSplit];
          w4[i] = rj[i * ld4 + k * kSplit];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(u4[i].x, w4[j].x, acc[i][j]);
            acc[i][j] = fmaf(u4[i].y, w4[j].y, acc[i][j]);
            acc[i][j] = fmaf(u4[i].z, w4[j].z, acc[i][j]);
            acc[i][j] = fmaf(u4[i].w, w4[j].w, acc[i][j]);
          }
        }
      }
    }
    // every lane of a tile ends with the whole sums (the parts added)
#pragma unroll
    for (int m = 1; m < kSplit; m *= 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], m);
      }
    }
    if (on) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i * kSplit / 4 != part) continue;  // each lane writes 4 / kSplit rows
#pragma unroll
        for (int j = 0; j < 4; ++j) put(a, sums, r, 4 * ti + i, 4 * tj + j, acc[i][j]);
      }
    }
  }
}

// Two f32 values of row i (0 past F) from column k, rounded to a bf16 pair.
__device__ __forceinline__ unsigned bf16_pair(const float* buf, const Layout& L, int r, int i,
                                              int F, int k) {
  float2 v = make_float2(0.f, 0.f);
  if (i < F) v = *reinterpret_cast<const float2*>(buf + L.row(r * L.Fp + i) + k);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// bf16: a warp a 16 x 8 tile (mi, nj) with nj < 2 (mi + 1).
__device__ __forceinline__ void gram_bf16(const Args& a, const Layout& L, int nrows,
                                          const float* buf, float* sums) {
  const int F = a.S + 1;
  const int m = round_up(F, 16) / 16;
  const int tiles = m * (m + 1);
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  for (int u = threadIdx.x / 32; u < nrows * tiles; u += blockDim.x / 32) {
    const int r = u / tiles;
    const int t = u - r * tiles;
    int mi = 0;
    while ((mi + 1) * (mi + 2) <= t) ++mi;
    const int nj = t - mi * (mi + 1);
    const int i0 = mi * 16 + g;
    const int n0 = nj * 8 + g;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    for (int k0 = 0; k0 < a.D; k0 += 16) {
      // the fragments of mma.m16n8k16: A rows g, g + 8 and B column g, at
      // columns t2, t2 + 1 and 8 more
      const unsigned a0 = bf16_pair(buf, L, r, i0, F, k0 + t2);
      const unsigned a1 = bf16_pair(buf, L, r, i0 + 8, F, k0 + t2);
      const unsigned a2 = bf16_pair(buf, L, r, i0, F, k0 + 8 + t2);
      const unsigned a3 = bf16_pair(buf, L, r, i0 + 8, F, k0 + 8 + t2);
      const unsigned b0 = bf16_pair(buf, L, r, n0, F, k0 + t2);
      const unsigned b1 = bf16_pair(buf, L, r, n0, F, k0 + 8 + t2);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    // the sums: rows g and g + 8, columns t2 and t2 + 1
    put(a, sums, r, i0, nj * 8 + t2, c0);
    put(a, sums, r, i0, nj * 8 + t2 + 1, c1);
    put(a, sums, r, i0 + 8, nj * 8 + t2, c2);
    put(a, sums, r, i0 + 8, nj * 8 + t2 + 1, c3);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fused_interaction_tiles(Args a) {
  extern __shared__ float4 smem4[];
  const Layout L = layout(a.S + 1, a.D, kBf16);
  float* const buf = reinterpret_cast<float*>(smem4);
  float* const sums = buf + L.buffer_floats();
  const int groups = (a.B + kRows - 1) / kRows;
  // the zero rows F..Fp-1 of the f32 tiles, never written by a load
  const int pad_rows = L.Fp - a.S - 1;
  for (int e = threadIdx.x; e < kRows * pad_rows * a.D; e += blockDim.x) {
    const int q = e / a.D;  // (batch row, pad row)
    const int r = q / pad_rows;
    buf[L.row(static_cast<long long>(r) * L.Fp + a.S + 1 + q - r * pad_rows) + e - q * a.D] = 0.f;
  }
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    load_group(a, L, g, buf);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const int nrows = min(kRows, a.B - g * kRows);
    if (kBf16) {
      gram_bf16(a, L, nrows, buf, sums);
    } else {
      gram_f32(a, L, nrows, buf, sums);
    }
    __syncthreads();
    write_group(a, L, g, buf, sums);
    __syncthreads();  // buf and sums are refilled next
  }
}

template <bool kBf16>
int launch(const Args& a, size_t smem, int device, cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_interaction_tiles<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_interaction_tiles<kBf16>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (a.B + kRows - 1) / kRows;
  const int resident = per_sm * sms > 0 ? per_sm * sms : 1;
  fused_interaction_tiles<kBf16>
      <<<resident < groups ? resident : groups, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The register route (f32, F = kRegF, D = 128): a warp a batch row.
constexpr int kRegF = 27;
constexpr int kRegWarps = 4;

// Lane l ends with the sum over the warp of part[l]: after the step of
// width s a lane keeps the half of its values whose index has its lane's
// bit s, each added to its partner's. All loops have constant trips, so
// part stays in registers.
__device__ __forceinline__ float reduce_scatter(float (&part)[32], int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2) {
    const bool up = lane & s;
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      if (v < s) {
        const float send = up ? part[v] : part[v + s];
        const float keep = up ? part[v + s] : part[v];
        part[v] = keep + __shfl_xor_sync(0xffffffffu, send, s);
      }
    }
  }
  return part[0];
}

// The row i and column j of pair p of the triangle, at compile time.
constexpr int pair_row(int p, int diag) {
  int i = 0;
  while ((i + 1) * i / 2 + diag * (i + 1) <= p) ++i;
  return i;
}

template <int P, int kDiag>
struct Pair {
  static constexpr int i = pair_row(P, kDiag);
  static constexpr int j = P - (i * (i - 1) / 2 + kDiag * i);
};

__device__ __forceinline__ float dot4(float4 u, float4 w) {
  float d = u.x * w.x;
  d = fmaf(u.y, w.y, d);
  d = fmaf(u.z, w.z, d);
  return fmaf(u.w, w.w, d);
}

// part[v] = the partial dot product of pair 32 C + v (0 past the last pair),
// expanded at compile time so that t and part stay in registers.
template <int F, int kDiag, int C, int... V>
__device__ __forceinline__ void chunk_partials(const float4 (&t)[F], float (&part)[32],
                                               std::integer_sequence<int, V...>) {
  constexpr int P = F * (F - 1) / 2 + kDiag * F;
  ((part[V] = 32 * C + V < P ? dot4(t[Pair<32 * C + V < P ? 32 * C + V : 0, kDiag>::i],
                                    t[Pair<32 * C + V < P ? 32 * C + V : 0, kDiag>::j])
                             : 0.f),
   ...);
}

template <int F, int kDiag, int... C>
__device__ __forceinline__ void all_chunks(const float4 (&t)[F], float* dst, int lane,
                                           std::integer_sequence<int, C...>) {
  constexpr int P = F * (F - 1) / 2 + kDiag * F;
  float part[32];
  (((chunk_partials<F, kDiag, C>(t, part, std::make_integer_sequence<int, 32>{})),
    (32 * C + lane < P ? (void)(dst[32 * C + lane] = reduce_scatter(part, lane))
                       : (void)reduce_scatter(part, lane))),
   ...);
}

template <int F, int kDiag>
__global__ void __launch_bounds__(32 * kRegWarps)
fused_interaction_regs(Args a) {
  constexpr int D = 128;
  constexpr int P = F * (F - 1) / 2 + kDiag * F;
  const int lane = threadIdx.x % 32;
  const long long b = static_cast<long long>(blockIdx.x) * kRegWarps + threadIdx.x / 32;
  if (b >= a.B) return;
  float4 t[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    t[f] = *reinterpret_cast<const float4*>(
        f == 0 ? a.x + b * a.x_stride_b + 4 * lane
               : a.ly + b * a.ly_stride_b + (f - 1) * a.ly_stride_s + 4 * lane);
  }
  float* const dst = a.out + b * (D + P);
  dst[4 * lane] = t[0].x;
  dst[4 * lane + 1] = t[0].y;
  dst[4 * lane + 2] = t[0].z;
  dst[4 * lane + 3] = t[0].w;
  all_chunks<F, kDiag>(t, dst + D, lane, std::make_integer_sequence<int, (P + 31) / 32>{});
}

}  // namespace

// Bytes of shared memory a block needs (the wrapper's check that a shape
// fits the card).
extern "C" long long fused_interaction_smem_bytes(int S, int D, int diag, int round_bf16) {
  const int F = S + 1;
  return static_cast<long long>(smem_bytes(F, D, F * (F - 1) / 2 + diag * F, round_bf16 != 0));
}

// Launches the kernel on `stream` (a cudaStream_t) on device `device` and
// returns cudaGetLastError(): 0 on success. out is [B, D + P] f32,
// contiguous. x rows and ly slots may be strided; the caller guarantees
// D % 16 == 0, 16-byte aligned x and ly, and strides that are multiples of 4.
extern "C" int fused_interaction_fwd(const float* x, long long x_stride_b,
                                     const float* ly, long long ly_stride_b,
                                     long long ly_stride_s, float* out, int B,
                                     int S, int D, int diag, int round_bf16,
                                     int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const int F = S + 1;
  const int P = F * (F - 1) / 2 + diag * F;
  const size_t smem = smem_bytes(F, D, P, round_bf16 != 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, x_stride_b, ly, ly_stride_b, ly_stride_s, out, B, S, D, P, diag};
  const auto st = static_cast<cudaStream_t>(stream);
  if (!round_bf16 && F == kRegF && D == 128) {
    const unsigned blocks = static_cast<unsigned>((B + kRegWarps - 1) / kRegWarps);
    if (diag) {
      fused_interaction_regs<kRegF, 1><<<blocks, 32 * kRegWarps, 0, st>>>(a);
    } else {
      fused_interaction_regs<kRegF, 0><<<blocks, 32 * kRegWarps, 0, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return round_bf16 ? launch<true>(a, smem, device, st) : launch<false>(a, smem, device, st);
}
