// RMSNorm and fused RMSNorm -> per-token symmetric quantization for Hopper.
//
// Replaces two TPU kernels of qspec_tpu/ops/rmsnorm_quant.py:
//   _rmsnorm_kernel        (entry rmsnorm):       y = x * rsqrt(mean(x^2) + eps) * gamma
//   _rmsnorm_quant_kernel  (entry rmsnorm_quant): y = x * rsqrt(mean(x^2) + eps),
//       scale = max(absmax(y), 1e-8) / qmax, q = clip(rint(y / scale), qmin, qmax)
// One row reduction, two epilogues: a template flag picks the quant one.
//
// What bounds it on the H100: a few operations per element against 2 bytes
// read and 1-2 written, so device-memory bytes.
//
// What the design does about that: one block per row, 16-byte vector loads
// and stores, one pass that gathers both the sum of squares and max|x| (for
// rstd > 0, max|x * rstd| == max|x| * rstd exactly, since rounding is
// monotonic), then one pass that writes; the second read of the row hits L1.
// The block reductions use a fixed shuffle tree, so a row's result does not
// depend on M or on the other rows. Rounding is rintf (half to even), as
// jnp.round and torch.round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? smem[lane] : 0.f;   // identity of + and of max(|.|)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, other) : v + other;
    }
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  const float r = smem[0];
  __syncthreads();   // smem is reused by the next reduction
  return r;
}

// kQuant = false: out bf16 [M, H] (gamma may be null: weightless norm).
// kQuant = true:  out int8 [M, H], scales f32 [M].
template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ gamma, void* __restrict__ out,
               float* __restrict__ scales, int H, float eps, float qmax,
               float qmin) {
  __shared__ float smem[32];
  const int row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * H);
  const int nvec = H >> 3;

  float ss = 0.f;
  float amax = 0.f;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 raw = __ldg(xr + v);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      ss = fmaf(f, f, ss);
      amax = fmaxf(amax, fabsf(f));
    }
  }
  ss = block_reduce<false>(ss, smem);
  const float rstd = rsqrtf(ss / static_cast<float>(H) + eps);

  if constexpr (kQuant) {
    amax = block_reduce<true>(amax, smem);
    const float scale = fmaxf(amax * rstd, 1e-8f) / qmax;
    if (threadIdx.x == 0) scales[row] = scale;
    uint2* qr = reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + (size_t)row * H);
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 raw = __ldg(xr + v);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint2 packed;
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = __bfloat162float(e[i]) * rstd;
        const float r = fminf(fmaxf(rintf(y / scale), qmin), qmax);
        q[i] = static_cast<int8_t>(r);
      }
      qr[v] = packed;
    }
  } else {
    const uint4* gr = reinterpret_cast<const uint4*>(gamma);
    uint4* orow = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * H);
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 raw = __ldg(xr + v);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint4 graw = make_uint4(0u, 0u, 0u, 0u);
      if (gamma != nullptr) graw = __ldg(gr + v);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&graw);
      uint4 res;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = __bfloat162float(e[i]) * rstd;
        if (gamma != nullptr) y = y * __bfloat162float(ge[i]);
        o[i] = __float2bfloat16_rn(y);
      }
      orow[v] = res;
    }
  }
}

}  // namespace

// x bf16 [M, H], gamma bf16 [H] or null, out bf16 [M, H]. H % 8 == 0.
extern "C" int qspec_rmsnorm(const void* x, const void* gamma, void* out,
                             int M, int H, float eps, void* stream) {
  rmsnorm_kernel<false><<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gamma), out, nullptr, H, eps, 0.f, 0.f);
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [M, H], q int8 [M, H], scales f32 [M]. H % 8 == 0.
extern "C" int qspec_rmsnorm_quant(const void* x, void* q, void* scales,
                                   int M, int H, float eps, float qmax,
                                   float qmin, void* stream) {
  rmsnorm_kernel<true><<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), nullptr, q,
      static_cast<float*>(scales), H, eps, qmax, qmin);
  return static_cast<int>(cudaGetLastError());
}
