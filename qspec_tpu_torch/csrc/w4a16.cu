// W4A16 GEMM for Hopper: bf16 activations x packed-int4 weights.
//
// Replaces the TPU kernel qspec_tpu/ops/linear_kernels.py:_w4a16_kernel
// (built by _w4_pallas, entry point matmul_w4a16).
//
//   out[m, n] = (sum_k x[m, k] * (q[k, n] - 8)) * s[n]
//
// x bf16 [M, K]; q int32 [K/8, N] in the SWAR layout of ops/packing.py
// (byte b of word row r holds k = 4r + b in its low nibble and
// k = K/2 + 4r + b in its high nibble, both excess-8); s f32 [N]; f32
// accumulation; out bf16 or f32 [M, N].
//
// What bounds it on the H100: at the verify widths (M <= 16) the packed
// weights are nearly all of the bytes (K*N/2) and the arithmetic intensity is
// about 4*M operations per weight byte, far under the card's ~295 op/byte
// ridge, so the kernel is bound by device-memory bytes.
//
// What the design does about that: each block owns a 32-column stripe of the
// output for one 16-row M tile, so while M <= 16 every weight word is read
// from device memory once per call. The K loop is split over the block's 8
// warps in a fixed interleave, each warp keeping 4 chunks of weight words in
// flight. The nibbles are decoded exactly into bf16 (q - 8, an integer in
// [-8, 7]) in registers and fed to mma.sync m16n8k16 (bf16 in, f32
// accumulate); the order in which the mma reduces k is free, so the k of a
// chunk are mapped onto the fragment slots to match the packing, with no
// shuffles. The 8 warps' partial sums are added in a fixed order in shared
// memory: a row's result does not depend on M, on its place in the batch or
// on the other rows (the greedy spec == AR invariant needs that).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // K split inside a block
constexpr int kNT = 4;              // n8 tiles per warp
constexpr int kCols = 8 * kNT;      // output columns per block
constexpr int kRows = 16;           // M tile
constexpr int kUnroll = 4;          // k32 chunks in flight per warp

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float nib(uint32_t word, int shift) {
  return static_cast<float>(static_cast<int>((word >> shift) & 0xFu) - 8);
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
w4a16_kernel(const __nv_bfloat16* __restrict__ x,
             const uint32_t* __restrict__ w, const float* __restrict__ s,
             void* __restrict__ out, int M, int K, int N, int out_f32) {
  __shared__ float red[kWarps][kRows][kCols];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment group: row / column
  const int t = lane & 3;             // thread in group: k pair
  const int n_base = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int half = K >> 1;
  const int nchunks = K >> 5;         // 4 word rows = 32 k per chunk

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
        // 0x88888888 decodes to zeros: columns past N add nothing
        wv[u][j] = (ok && n < N) ? __ldg(w + (size_t)r * N + n) : 0x88888888u;
      }
      xa[u][0] = load_x4(x_lo + 4 * r, ok && row_lo);
      xa[u][1] = load_x4(x_hi + 4 * r, ok && row_hi);
      xa[u][2] = load_x4(x_lo + half + 4 * r, ok && row_lo);
      xa[u][3] = load_x4(x_hi + half + 4 * r, ok && row_hi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * kWarps >= nchunks) break;   // warp-uniform
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t word = wv[u][j];
        // low nibbles: k = 4r + {0,1} -> slots 2t, 2t+1; 4r + {2,3} -> 2t+8, 2t+9
        mma_bf16(acc[j], xa[u][0].x, xa[u][1].x, xa[u][0].y, xa[u][1].y,
                 pack_bf16x2(nib(word, 0), nib(word, 8)),
                 pack_bf16x2(nib(word, 16), nib(word, 24)));
        // high nibbles: the same slots for k = K/2 + 4r + b
        mma_bf16(acc[j], xa[u][2].x, xa[u][3].x, xa[u][2].y, xa[u][3].y,
                 pack_bf16x2(nib(word, 4), nib(word, 12)),
                 pack_bf16x2(nib(word, 20), nib(word, 28)));
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
    const float v = sum * s[n];
    if (out_f32) {
      static_cast<float*>(out)[(size_t)m * N + n] = v;
    } else {
      static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// x bf16 [M, K], w int32 [K/8, N], s f32 [N], out [M, N] (bf16, or f32 when
// out_f32). K must be a multiple of 32; pointers 16-byte aligned.
extern "C" int qspec_w4a16(const void* x, const void* w, const void* s,
                           void* out, int M, int K, int N, int out_f32,
                           void* stream) {
  dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  w4a16_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(s), out, M, K, N, out_f32);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
