// W4A4 / W4A8 GEMM for Hopper: int8 activations x packed-int4 weights.
//
// Replaces the TPU kernel qspec_tpu/ops/linear_kernels.py:_w4a4_kernel
// (built by _w4_pallas, entry point matmul_w4a4): the QSpec draft GEMM.
//
//   acc[m, n] = sum_k xq[m, k] * (q[k, n] - 8)          (exact, int32)
//   out[m, n] = bf16((float(acc) * sx[m]) * sw[n])
//
// xq int8 [M, K] (int4 range for w4a4, full int8 for w4a8); sx f32 [M]; q
// int32 [K/8, N] in the SWAR layout of ops/packing.py; sw f32 [N].
//
// What bounds it on the H100: at draft widths (M = batch, or 2x batch on the
// backfill step) the weights are nearly all of the bytes and the arithmetic
// intensity is about 4*M operations per weight byte: bound by device-memory
// bytes.
//
// What the design does about that: the block and warp layout of w4a16.cu
// (32-column stripe, 16-row M tile, K split over 8 warps, 4 chunks of words
// in flight per warp), so each weight word leaves device memory once per call
// while M <= 16. Hopper has no int4 tensor-core path, so each 32-bit word is
// widened in registers to two s8x4 registers (the low and high nibble planes,
// q - 8 per byte with __vsub4) which are exactly one thread's B fragment of
// mma.sync m16n8k32 s8.s8.s32: no -8*rowsum correction and no shuffles. The
// int32 sums are exact, so the result does not depend on the order of the
// reduction at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kNT = 4;
constexpr int kCols = 8 * kNT;
constexpr int kRows = 16;
constexpr int kUnroll = 4;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_x4(const int8_t* p, bool ok) {
  if (!ok) return 0u;
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__global__ void __launch_bounds__(kWarps * 32)
w4a4_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const uint32_t* __restrict__ w, const float* __restrict__ sw,
            __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  __shared__ int red[kWarps][kRows][kCols];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_base = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int half = K >> 1;
  const int nchunks = K >> 5;

  const bool row_lo = m0 + g < M;
  const bool row_hi = m0 + g + 8 < M;
  const int8_t* x_lo = xq + (size_t)(m0 + g) * K;
  const int8_t* x_hi = xq + (size_t)(m0 + g + 8) * K;

  int acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int c0 = warp; c0 < nchunks; c0 += kWarps * kUnroll) {
    uint32_t wv[kUnroll][kNT];
    uint32_t xa[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      const bool ok = c < nchunks;
      const int r = 4 * c + t;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n_base + 8 * j + g;
        wv[u][j] = (ok && n < N) ? __ldg(w + (size_t)r * N + n) : 0x88888888u;
      }
      // A fragment: slots 4t..4t+3 <- k = 4r + b, slots 16+4t.. <- K/2 + 4r + b
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
        const uint32_t lo = __vsub4(word & 0x0F0F0F0Fu, 0x08080808u);
        const uint32_t hi = __vsub4((word >> 4) & 0x0F0F0F0Fu, 0x08080808u);
        mma_s8(acc[j], xa[u][0], xa[u][1], xa[u][2], xa[u][3], lo, hi);
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
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi][row][col];
    const float v = (static_cast<float>(sum) * sx[m]) * sw[n];
    out[(size_t)m * N + n] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// xq int8 [M, K], sx f32 [M], w int32 [K/8, N], sw f32 [N], out bf16 [M, N].
// K must be a multiple of 32; pointers 16-byte aligned.
extern "C" int qspec_w4a4(const void* xq, const void* sx, const void* w,
                          const void* sw, void* out, int M, int K, int N,
                          void* stream) {
  dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  w4a4_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint32_t*>(w), static_cast<const float*>(sw),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
