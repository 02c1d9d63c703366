// Grouped W4A16 GEMM for Hopper: bf16 activations x group-quantized int4
// weights (AWQ / GPTQ checkpoints, quant="w4g").
//
// Replaces the TPU kernel qspec_tpu/ops/linear_kernels.py:_w4a16_g_kernel
// and its stacked form _stacked_g_kernel (entry point matmul_w4a16_g).
//
//   w[k, n]   = bf16(q[k, n] * s[k / g, n] - o[k / g, n])
//   out[m, n] = sum_k x[m, k] * w[k, n]
//
// x bf16 [M, K]; q int32 [K/8, N] in the SWAR layout of ops/packing.py, but
// holding the unsigned q in [0, 15] (the packer stores q - 8 in excess-8, so
// the nibble reads as q: no rebias); s (scales) and o (offsets, zp * s) f32
// [G, N], G = K / g groups, G even and g dividing K/2, so a word's low plane
// (k = 4r + b) lies in group k / g and its high plane (k = K/2 + 4r + b) in
// group G/2 + k / g; f32 accumulation; out bf16 or f32 [M, N].
//
// What bounds it on the H100: at the draft and verify widths (M <= 16) the
// packed weights (K*N/2 bytes) and the scales and offsets (8*G*N bytes, an
// eighth more at g = 128) are nearly all of the bytes, against about 4*M
// operations per weight byte, so device-memory bytes bound it. The dequant
// costs about five ALU instructions per weight, which at M <= 16 is as much
// issue time as the bytes take to arrive: this kernel sits nearer its
// instruction limit than w4a16.cu, whose scale is an epilogue.
//
// What the design does about that: the mapping of w4a16.cu. Each block owns
// a 32-column stripe of the output for one 16-row M tile, so while M <= 16
// every weight word is read from device memory once per call; the K loop is
// split over the block's 8 warps in a fixed interleave, 4 chunks of weight
// words in flight per warp; the k of a chunk are mapped onto the
// mma.m16n8k16 fragment slots to match the packing, with no shuffles. The
// group scales vary along K, so they cannot be an epilogue: each weight is
// dequantized in registers to bf16(q*s - o), rounded exactly as the plain
// version and the Pallas kernel round it (an f32 product, then an f32
// difference: no fused multiply-add), before the MMA. A chunk's 16 k of one
// plane lie in one group (g % 16 == 0), and the block stages its stripe's
// (scale, offset) pairs of every group in shared memory once, so each is
// read from device memory once per block. The 8 warps' partial sums are
// added in a fixed order: a row's result does not depend on M, on its place
// in the batch or on the other rows (greedy QSpec == its oracle needs that
// between the draft's M and the verify's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // K split inside a block
constexpr int kNT = 4;              // n8 tiles per warp
constexpr int kCols = 8 * kNT;      // output columns per block
constexpr int kRows = 16;           // M tile
constexpr int kUnroll = 4;          // k32 chunks in flight per warp
constexpr int kRedBytes = kWarps * kRows * kCols * 4;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16-bound weight q*s - o of the nibble at `shift`; q is made exact in f32
// by placing it under the exponent of 2^23 (no integer-to-float conversion)
__device__ __forceinline__ float deq(uint32_t word, int shift, float2 so) {
  const float q = __int_as_float(0x4B000000u | ((word >> shift) & 0xFu)) - 8388608.f;
  return __fsub_rn(__fmul_rn(q, so.x), so.y);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint2 load_x4(const __nv_bfloat16* p, bool ok) {
  if (!ok) return make_uint2(0u, 0u);
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__global__ void __launch_bounds__(kWarps * 32)
w4a16_g_kernel(const __nv_bfloat16* __restrict__ x,
               const uint32_t* __restrict__ w, const float* __restrict__ s,
               const float* __restrict__ o, void* __restrict__ out, int M,
               int K, int N, int G, int out_f32) {
  // [G][kCols] (scale, offset) pairs of this block's stripe, then the
  // warps' partial sums [kWarps][kRows][kCols]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* so = reinterpret_cast<float2*>(smem_raw);
  float (*red)[kRows][kCols] =
      reinterpret_cast<float (*)[kRows][kCols]>(smem_raw + (size_t)G * kCols * 8);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment group: row / column
  const int t = lane & 3;             // thread in group: k pair
  const int n_base = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int half = K >> 1;
  const int nchunks = K >> 5;         // 4 word rows = 16 k of each plane
  const int chunks_per_group = K / G / 16;
  const int g_half = G >> 1;

  for (int idx = threadIdx.x; idx < G * kCols; idx += blockDim.x) {
    const int gi = idx / kCols;
    const int n = n_base + idx % kCols;
    // columns past N: scale and offset 0, so their weights are exact zeros
    so[idx] = n < N ? make_float2(__ldg(s + (size_t)gi * N + n), __ldg(o + (size_t)gi * N + n))
                    : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const bool row_lo = m0 + g < M;
  const bool row_hi = m0 + g + 8 < M;
  const __nv_bfloat16* x_lo = x + (size_t)(m0 + g) * K;
  const __nv_bfloat16* x_hi = x + (size_t)(m0 + g + 8) * K;

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int c0 = warp; c0 < nchunks; c0 += kWarps * kUnroll) {
    uint32_t wv[kUnroll][kNT];
    uint2 xa[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      const bool ok = c < nchunks;
      const int r = 4 * c + t;        // this thread's word row
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n_base + 8 * j + g;
        wv[u][j] = (ok && n < N) ? __ldg(w + (size_t)r * N + n) : 0u;
      }
      xa[u][0] = load_x4(x_lo + 4 * r, ok && row_lo);
      xa[u][1] = load_x4(x_hi + 4 * r, ok && row_hi);
      xa[u][2] = load_x4(x_lo + half + 4 * r, ok && row_lo);
      xa[u][3] = load_x4(x_hi + half + 4 * r, ok && row_hi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      if (c >= nchunks) break;        // warp-uniform
      const float2* so_lo = so + (size_t)(c / chunks_per_group) * kCols;
      const float2* so_hi = so_lo + (size_t)g_half * kCols;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t word = wv[u][j];
        const float2 sl = so_lo[8 * j + g];
        const float2 sh = so_hi[8 * j + g];
        // low nibbles: k = 4r + {0,1} -> slots 2t, 2t+1; 4r + {2,3} -> 2t+8, 2t+9
        mma_bf16(acc[j], xa[u][0].x, xa[u][1].x, xa[u][0].y, xa[u][1].y,
                 pack_bf16x2(deq(word, 0, sl), deq(word, 8, sl)),
                 pack_bf16x2(deq(word, 16, sl), deq(word, 24, sl)));
        // high nibbles: the same slots for k = K/2 + 4r + b, group G/2 + k/g
        mma_bf16(acc[j], xa[u][2].x, xa[u][3].x, xa[u][2].y, xa[u][3].y,
                 pack_bf16x2(deq(word, 4, sh), deq(word, 12, sh)),
                 pack_bf16x2(deq(word, 20, sh), deq(word, 28, sh)));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = 8 * j + 2 * t;
    red[warp][g][col] = acc[j][0];
    red[warp][g][col + 1] = acc[j][1];
    red[warp][g + 8][col] = acc[j][2];
    red[warp][g + 8][col + 1] = acc[j][3];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kRows * kCols; idx += blockDim.x) {
    const int row = idx / kCols;
    const int col = idx % kCols;
    const int m = m0 + row;
    const int n = n_base + col;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi][row][col];
    if (out_f32) {
      static_cast<float*>(out)[(size_t)m * N + n] = sum;
    } else {
      static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(sum);
    }
  }
}

}  // namespace

// x bf16 [M, K], w int32 [K/8, N] (unsigned nibbles), s and o f32 [G, N],
// out [M, N] (bf16, or f32 when out_f32). K % 256 == 0, G even, g = K / G a
// multiple of 16 dividing K/2, G * 256 + 16384 bytes of shared memory within
// the block limit; pointers 16-byte aligned.
extern "C" int qspec_w4a16_g(const void* x, const void* w, const void* s,
                             const void* o, void* out, int M, int K, int N,
                             int G, int out_f32, void* stream) {
  const int smem = G * kCols * 8 + kRedBytes;
  static int smem_set = 48 * 1024;   // the default limit of dynamic shared memory
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4a16_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  w4a16_g_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(o), out, M, K, N,
      G, out_f32);
  return static_cast<int>(cudaGetLastError());
}
