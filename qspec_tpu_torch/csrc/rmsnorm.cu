// RMSNorm, and RMSNorm fused with per-token symmetric quantization, each
// optionally after the residual add, for Hopper: one kernel template over
// {quant, gamma, residual}.
//
// Replaces two TPU kernels of qspec_tpu/ops/rmsnorm_quant.py:
//   _rmsnorm_kernel (:78, entry qspec_rmsnorm):
//       y = h * rsqrt(mean(h^2) + eps) [* gamma], bf16 out
//   _rmsnorm_quant_kernel (:68, entry qspec_rmsnorm_quant):
//       y = h * rsqrt(mean(h^2) + eps), scale = max(absmax(y), 1e-8) / qmax,
//       q = clip(rint(y / scale), qmin, qmax)
// where h = x or, given a residual, h = bf16(x + residual) (one f32 add
// rounded to nearest even once, as torch's bf16 +), also written out: the
// residual stream of the next layer. The JAX package takes its jnp path at
// M <= 64 so that XLA fuses that add into the norm; here the add is in the
// norm's one pass.
//
// What bounds it on the H100: at the decode and verify sizes (M <= 64)
// latency, not bytes. A call there moves at most 3.5 MB (tens of ns at
// 3.35 TB/s) against a chain of launch, loads, reduction and stores of a
// few microseconds. At prefill sizes (M = 512, 1024) device-memory bytes.
//
// What the design does about that:
// - The row in registers: one block a row, each thread owning kV 16-byte
//   vectors (v = threadIdx.x + j * blockDim.x), kV and the block size
//   chosen by the host from H (256 threads x 2 at H = 4096, 224 x 2 at
//   3584). A thread issues all its loads (gamma, x, the residual) before
//   the first use; the row is read once.
// - One reduction: (sum of squares, max|h|) together through a warp
//   shuffle tree, then one shared-memory round that every thread adds up
//   itself, warps 0..n-1 in order: one barrier. The order is fixed, so a
//   row's bits do not depend on M, on its place or on the other rows
//   (greedy QSpec == its oracle needs that). For rstd > 0,
//   max|h * rstd| == max|h| * rstd exactly (rounding is monotonic).
// - A programmatic dependent launch: the block is set up while the
//   previous kernel of the stream ends; gamma, a weight that no kernel of
//   the forward writes, is read before griddepcontrol.wait, x and the
//   residual after it; griddepcontrol.launch_dependents once the block has
//   stored, so the next kernel's launch overlaps the norm's end. h is stored
//   as soon as it is formed, its stores overlapping the reduction.
// Rounding is rintf (half to even), as jnp.round and torch.round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxVec = 8;          // vectors a thread: H <= 8 * 8 * 256 = 16384

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* residual;    // null: no add
  const __nv_bfloat16* gamma;       // null: weightless
  void* out;                        // bf16 [M, H], or int8 [M, H] (quant)
  __nv_bfloat16* h;                 // bf16 [M, H] when residual is given
  float* scales;                    // f32 [M] (quant)
  int H;
  float eps;
  float qmax;
  float qmin;
};

__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162 s;
  s.x = __float2bfloat16_rn(__fadd_rn(__bfloat162float(x.x), __bfloat162float(y.x)));
  s.y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(x.y), __bfloat162float(y.y)));
  return *reinterpret_cast<const uint32_t*>(&s);
}

template <bool kQuant, bool kGamma, bool kRes, int kV>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(const Args a) {
  __shared__ float2 part[kMaxThreads / 32];
  const int nvec = a.H >> 3;
  const size_t row = (size_t)blockIdx.x * a.H;
  uint4 xv[kV], rv[kV], gv[kV];
  // vectors past the row's end stay zero: they add nothing to either sum
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    xv[j] = rv[j] = gv[j] = make_uint4(0u, 0u, 0u, 0u);
    const int v = threadIdx.x + j * blockDim.x;
    if (kGamma && v < nvec) gv[j] = __ldg(reinterpret_cast<const uint4*>(a.gamma) + v);
  }
  grid_wait();
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int v = threadIdx.x + j * blockDim.x;
    if (v < nvec) {
      xv[j] = __ldg(reinterpret_cast<const uint4*>(a.x + row) + v);
      if (kRes) rv[j] = __ldg(reinterpret_cast<const uint4*>(a.residual + row) + v);
    }
  }

  float ss = 0.f;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if constexpr (kRes) {
      xv[j].x = add_bf16x2(xv[j].x, rv[j].x);
      xv[j].y = add_bf16x2(xv[j].y, rv[j].y);
      xv[j].z = add_bf16x2(xv[j].z, rv[j].z);
      xv[j].w = add_bf16x2(xv[j].w, rv[j].w);
      const int v = threadIdx.x + j * blockDim.x;
      if (v < nvec) reinterpret_cast<uint4*>(a.h + row)[v] = xv[j];
    }
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      ss = fmaf(f, f, ss);
      if (kQuant) amax = fmaxf(amax, fabsf(f));
    }
  }

  // one reduction of (sum of squares, max|h|): lanes, then warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (kQuant) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(ss, amax);
  __syncthreads();
  ss = 0.f;
  amax = 0.f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    const float2 p = part[w];
    ss += p.x;
    amax = fmaxf(amax, p.y);
  }
  const float rstd = rsqrtf(ss / static_cast<float>(a.H) + a.eps);

  if constexpr (kQuant) {
    const float scale = fmaxf(amax * rstd, 1e-8f) / a.qmax;
    if (threadIdx.x == 0) a.scales[blockIdx.x] = scale;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = threadIdx.x + j * blockDim.x;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv[j]);
      uint2 packed;
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = __bfloat162float(e[i]) * rstd;
        q[i] = static_cast<int8_t>(fminf(fmaxf(rintf(y / scale), a.qmin), a.qmax));
      }
      if (v < nvec) reinterpret_cast<uint2*>(static_cast<int8_t*>(a.out) + row)[v] = packed;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = threadIdx.x + j * blockDim.x;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv[j]);
      const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&gv[j]);
      uint4 res;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = __bfloat162float(e[i]) * rstd;
        if (kGamma) y = y * __bfloat162float(g[i]);
        o[i] = __float2bfloat16_rn(y);
      }
      if (v < nvec) reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + row)[v] = res;
    }
  }
  // the next kernel may launch once every block has stored (a trigger once
  // the loads were issued let the w4 GEMM that follows launch its blocks
  // beside the norm's and cost it 0.5-3.6 us at M <= 16:
  // tools/norm_variants_ab.py)
  launch_dependents();
}

// A yardstick that chip_smoke.py alone launches: no work, launched as the
// norm is (programmatic, one block a row of the norm's threads), so its time
// is the floor under the norm's at that shape.
__global__ void launch_floor_kernel() {
  grid_wait();
  launch_dependents();
}

// The least vector count kV in {1, 2, 4, 8} whose block of ceil(H/8 / kV)
// threads, rounded up to a warp, has at most kMaxThreads; 0 when none has.
int plan(int H, int* threads) {
  const int nvec = H >> 3;
  for (int v = 1; v <= kMaxVec; v *= 2) {
    const int t = (nvec + v - 1) / v;
    if (t <= kMaxThreads) {
      *threads = (t + 31) / 32 * 32;
      return v;
    }
  }
  return 0;
}

template <typename Kernel, typename... A>
int launch_pdl(Kernel kernel, int blocks, int threads, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQuant, bool kGamma, bool kRes>
int run_v(const Args& a, int M, cudaStream_t stream) {
  int threads = 0;
  switch (plan(a.H, &threads)) {
    case 1: return launch_pdl(rmsnorm_kernel<kQuant, kGamma, kRes, 1>, M, threads, stream, a);
    case 2: return launch_pdl(rmsnorm_kernel<kQuant, kGamma, kRes, 2>, M, threads, stream, a);
    case 4: return launch_pdl(rmsnorm_kernel<kQuant, kGamma, kRes, 4>, M, threads, stream, a);
    case 8: return launch_pdl(rmsnorm_kernel<kQuant, kGamma, kRes, 8>, M, threads, stream, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kQuant, bool kGamma>
int run(const Args& a, int M, cudaStream_t stream) {
  return a.residual != nullptr ? run_v<kQuant, kGamma, true>(a, M, stream)
                               : run_v<kQuant, kGamma, false>(a, M, stream);
}

}  // namespace

// x bf16 [M, H]; residual bf16 [M, H] or null; gamma bf16 [H] or null;
// out bf16 [M, H]; h bf16 [M, H] (x + residual) or null. H % 8 == 0,
// H <= 16384, pointers 16-byte aligned.
extern "C" int qspec_rmsnorm(const void* x, const void* residual, const void* gamma,
                             void* out, void* h, int M, int H, float eps, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(residual),
               static_cast<const __nv_bfloat16*>(gamma), out, static_cast<__nv_bfloat16*>(h),
               nullptr, H, eps, 0.f, 0.f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gamma != nullptr ? run<false, true>(a, M, s) : run<false, false>(a, M, s);
}

// x bf16 [M, H]; residual bf16 [M, H] or null; q int8 [M, H]; scales f32 [M];
// h bf16 [M, H] or null. H % 8 == 0, H <= 16384, pointers 16-byte aligned.
extern "C" int qspec_rmsnorm_quant(const void* x, const void* residual, void* q, void* scales,
                                   void* h, int M, int H, float eps, float qmax, float qmin,
                                   void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(residual),
               nullptr, q, static_cast<__nv_bfloat16*>(h), static_cast<float*>(scales), H,
               eps, qmax, qmin};
  return run<true, false>(a, M, static_cast<cudaStream_t>(stream));
}

// The launch floor of the norm at (M, H): launch_floor_kernel on the norm's
// grid and block. A yardstick for chip_smoke.py; the port never calls it.
extern "C" int qspec_norm_launch_floor(int M, int H, void* stream) {
  int threads = 0;
  if (plan(H, &threads) == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pdl(launch_floor_kernel, M, threads, static_cast<cudaStream_t>(stream));
}
