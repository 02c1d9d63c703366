// W8A16 GEMM for Hopper: bf16 activations x byte weights, int8 (the int8
// lm_head, the W8A16 trunk of compressed-tensors int-quantized checkpoints)
// or float8_e4m3fn (the trunk of float-quantized / fbgemm_fp8 ones).
//
// Replaces the TPU kernel qspec_tpu/ops/linear_kernels.py:_w8a16_kernel
// (entry point matmul_w8a16, plain and layer-stacked forms), which widens
// either byte type to bf16 in VMEM.
//
//   out[m, n] = (sum_k x[m, k] * bf16(w[k, n])) * s[n]
//
// x bf16 [M, K]; w int8 or e4m3 [K, N] row-major; s f32 [N]; f32
// accumulation; out bf16 or f32 [M, N].
//
// What bounds it on the H100: at decode and verify widths (M <= 16) the
// weights are nearly all of the bytes (K*N: 525 MB for Llama-3's
// 128256-word head, 218 MB for one Llama-3-8B layer's four trunk
// projections) and each weight byte is used for 2*M operations, far under
// the card's ~295 op/byte ridge, so the kernel is bound by device-memory
// bytes.
//
// What the design does about that: each block owns a 64-column stripe of the
// output for one 16-row M tile, so while M <= 16 every weight byte is read
// from device memory once per call. The K loop is split over the block's 8
// warps in a fixed interleave of 16-k chunks, each warp keeping 4 chunks of
// loads in flight. For a chunk, a thread reads rows k = 16c + 4t + {0..3}
// of 8 consecutive columns (one 8-byte load per row; the 8 threads of a
// fragment group cover 64 consecutive bytes of the row). The order in which
// mma.sync m16n8k16 reduces k is free, so the chunk's k are mapped onto the
// fragment slots (2t, 2t+1, 2t+8, 2t+9 <- rows 4t .. 4t+3) and the columns
// onto the n8 tiles (tile j, fragment column c <- column 8c + j) such that
// those bytes are exactly the thread's B fragments of 8 tiles: no shuffles,
// no shared memory on the way in. Only the byte -> bf16 decode differs
// between the two weight types, both exact:
//  - int8: the 2^23 bias (the byte, sign bit flipped, is the low mantissa
//    byte of 0x4B000000), then a bf16 pair (|v| <= 128);
//  - e4m3: a row pair's bytes side by side, cvt.rn.f16x2.e4m3x2 (sm_89+),
//    then f16 -> f32 -> bf16. Every e4m3 value, subnormals down to 2^-9
//    included, is an f16 and a bf16 value; the NaN codes 0x7F / 0xFF stay
//    NaN (e4m3fn has no infinity), so a NaN weight gives a NaN output.
// The 8 warps' partial sums are added in a fixed order in shared memory: a
// row's result does not depend on M, on its place in the batch or on the
// other rows (the greedy spec == AR invariant needs that).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // K split inside a block
constexpr int kNT = 8;              // n8 tiles per warp
constexpr int kCols = 8 * kNT;      // output columns per block
constexpr int kRows = 16;           // M tile
constexpr int kUnroll = 4;          // k16 chunks in flight per warp

__device__ __forceinline__ float i8f(uint32_t biased_word, int byte) {
  // biased_word holds int8 values with their sign bits flipped (v + 128)
  const uint32_t bits = __byte_perm(biased_word, 0x4B000000u, 0x7540u | byte);
  return __uint_as_float(bits) - 8388736.0f;   // 2^23 + 128
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 pair (lo <- word a's byte, hi <- word b's byte) of one column in
// two weight rows. int8: a and b hold the bytes with their sign bits
// flipped (v + 128). e4m3: the raw bytes.
template <bool kFp8>
__device__ __forceinline__ uint32_t decode_pair(uint32_t a, uint32_t b, int byte) {
  if constexpr (kFp8) {
    const uint32_t pair = __byte_perm(a, b, byte | ((4 + byte) << 4));
    uint32_t h2;
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
        : "=r"(h2) : "h"(static_cast<unsigned short>(pair)));
    const __half2 h = *reinterpret_cast<const __half2*>(&h2);
    const float2 f = __half22float2(h);
    return pack_bf16x2(f.x, f.y);
  } else {
    return pack_bf16x2(i8f(a, byte), i8f(b, byte));
  }
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

__device__ __forceinline__ uint2 load8(const void* p, bool ok) {
  if (!ok) return make_uint2(0u, 0u);
  return __ldg(reinterpret_cast<const uint2*>(p));
}

template <bool kFp8>
__global__ void __launch_bounds__(kWarps * 32)
w8a16_kernel(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ w, const float* __restrict__ s,
             void* __restrict__ out, int M, int K, int N, int out_f32) {
  __shared__ float red[kWarps][kRows][kCols];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment group: row / column
  const int t = lane & 3;             // thread in group: k quad
  const int n_base = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int nchunks = K >> 4;

  const bool row_lo = m0 + g < M;
  const bool row_hi = m0 + g + 8 < M;
  const __nv_bfloat16* x_lo = x + (size_t)(m0 + g) * K;
  const __nv_bfloat16* x_hi = x + (size_t)(m0 + g + 8) * K;
  const int col = n_base + 8 * g;     // this thread's 8 weight columns
  const bool col_ok = col < N;        // N % 8 == 0: all 8 or none
  const uint8_t* w_col = w + col;

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int c0 = warp; c0 < nchunks; c0 += kWarps * kUnroll) {
    uint2 wv[kUnroll][4];
    uint2 xa[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      const bool ok = c < nchunks;
      const int k0 = 16 * c + 4 * t;  // this thread's 4 rows
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[u][r] = load8(w_col + (size_t)(k0 + r) * N, ok && col_ok);
      xa[u][0] = load8(x_lo + k0, ok && row_lo);
      xa[u][1] = load8(x_hi + k0, ok && row_hi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * kWarps >= nchunks) break;   // warp-uniform
      const uint32_t flip = kFp8 ? 0u : 0x80808080u;
      uint32_t wb[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wb[r][0] = wv[u][r].x ^ flip;
        wb[r][1] = wv[u][r].y ^ flip;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int h = j >> 2;         // which word holds column byte j
        const int byte = j & 3;
        // slots 2t, 2t+1 <- rows 4t, 4t+1; slots 2t+8, 2t+9 <- rows 4t+2, 4t+3
        mma_bf16(acc[j], xa[u][0].x, xa[u][1].x, xa[u][0].y, xa[u][1].y,
                 decode_pair<kFp8>(wb[0][h], wb[1][h], byte),
                 decode_pair<kFp8>(wb[2][h], wb[3][h], byte));
      }
    }
  }

  // tile j's fragment columns 2t, 2t+1 are block columns 16t + j, 16t + 8 + j
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    red[warp][g][16 * t + j] = acc[j][0];
    red[warp][g][16 * t + 8 + j] = acc[j][1];
    red[warp][g + 8][16 * t + j] = acc[j][2];
    red[warp][g + 8][16 * t + 8 + j] = acc[j][3];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kRows * kCols; idx += blockDim.x) {
    const int row = idx / kCols;
    const int cc = idx % kCols;
    const int m = m0 + row;
    const int n = n_base + cc;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi][row][cc];
    const float v = sum * s[n];
    if (out_f32) {
      static_cast<float*>(out)[(size_t)m * N + n] = v;
    } else {
      static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
}

template <bool kFp8>
int launch(const void* x, const void* w, const void* s, void* out, int M, int K,
           int N, int out_f32, void* stream) {
  dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  w8a16_kernel<kFp8><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), out, M, K, N, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [M, K], w int8 [K, N] (qspec_w8a16) or float8_e4m3fn [K, N]
// (qspec_w8a16_fp8), s f32 [N], out [M, N] (bf16, or f32 when out_f32).
// K % 16 == 0, N % 8 == 0; pointers 16-byte aligned.
extern "C" int qspec_w8a16(const void* x, const void* w, const void* s,
                           void* out, int M, int K, int N, int out_f32,
                           void* stream) {
  return launch<false>(x, w, s, out, M, K, N, out_f32, stream);
}

extern "C" int qspec_w8a16_fp8(const void* x, const void* w, const void* s,
                               void* out, int M, int K, int N, int out_f32,
                               void* stream) {
  return launch<true>(x, w, s, out, M, K, N, out_f32, stream);
}
