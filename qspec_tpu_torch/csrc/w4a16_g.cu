// Grouped W4A16 GEMM for Hopper: bf16 activations x group-quantized int4
// weights (AWQ / GPTQ checkpoints, quant="w4g").
//
// Replaces the TPU kernel qspec_tpu/ops/linear_kernels.py:372
// (_w4a16_g_kernel) and its stacked form :402 (_stacked_g_kernel), entry
// point matmul_w4a16_g.
//
//   w[k, n]   = bf16(fl32(fl32(q[k, n] * s[k / g, n]) - o[k / g, n]))
//   out[m, n] = sum_k x[m, k] * w[k, n]
//
// x bf16 [M, K]; q int32 [K/8, N] in the SWAR layout of ops/packing.py, but
// holding the unsigned q in [0, 15] (the packer stores q - 8 in excess-8, so
// the nibble reads as q: no rebias); s (scales) and o (offsets, zp * s) f32
// [G, N], G = K / g groups, G even and g dividing K/2, so a word's low plane
// (k = 4r + b) lies in group k / g and its high plane (k = K/2 + 4r + b) in
// group G/2 + k / g; f32 accumulation; out bf16 or f32 [M, N].
//
// What bounds it on the H100: up to M = 64 the packed weights (K*N/2 bytes)
// and the scales and offsets (8*G*N bytes, an eighth more at g = 128) are
// nearly all of the bytes, against about 4*M operations per weight byte, so
// device-memory bytes bound it. Close behind comes the instruction issue of
// the dequant, which has to reproduce the plain version's rounding exactly:
// about 4.7 instructions per weight, plus the loop's own. On the card the
// kernel is issue-bound: the FP32/INT32 pipes, not the bytes, set its time
// (PERF.md §6).
//
// What the design does about each limit of the previous kernel (one 32-column
// stripe per block, loads into registers, a G-sized scale prologue, one M
// tile, a five-instruction dequant):
//
// 1. Bytes in flight: a ring of kStages = 4 shared-memory stages filled by
//    cp.async, 16 bytes a thread (weights, scales and offsets, x). While
//    stage i is dequantized and multiplied, stages i+1..i+3 are on their way:
//    3 x 8 KB of weights per block, two blocks per SM up to M = 32. One
//    barrier per stage. (Tried on the card and dropped: 3, 5 or 6 stages,
//    which time the same; TMA bulk copies of a row each, slower than
//    cp.async at these small copies.)
// 2. All SMs: a block owns a unit of (128-column stripe, K-slice): slice i of
//    S takes the stages [i T / S, (i + 1) T / S) of the T = K / 128. S is
//    fixed by the wrapper's planner (ops/linear_kernels.py w4g_splits) from
//    (K, N) and the SM count, never from M, so that every projection of
//    Llama-3-8B and Gemma-2-9B has at least one unit per SM. Partial sums go
//    to an f32 workspace [S, M, N] allocated by the wrapper; the block that
//    arrives last at a stripe (an integer counter per stripe, which it
//    resets to 0) adds the slices in index order, so the result is
//    deterministic and replays unchanged in a CUDA graph. No float atomics.
//    (Tried and dropped: a thread block cluster per stripe adding the slices
//    through distributed shared memory, slower at every split the planner
//    picks.)
// 3. Scales and offsets: each stage copies the (scale, offset) rows of the
//    groups its 64 k of each plane touch (one per plane for g >= 64; at most
//    four for g = 16), in the same cp.async group as its weights. No
//    prologue, and no bound on G from shared memory.
// 4. M: a block carries MT = ceil(min(M, 64) / 16) m16 tiles (one
//    instantiation per MT) and applies every dequantized B fragment to all of
//    them, so up to M = 64 each weight is read and dequantized once; beyond,
//    blocks along grid.y take 64 rows each. Rows past M are zero-filled by
//    the copy and never stored; M <= 16 does the work of M = 16.
// 5. Dequant: a nibble at bit 4p of a (shifted) word becomes the exact float
//    2^(23-4p) + q in one LOP3 ((word & mask) | magic, the nibble landing in
//    the units place of that power of two), then q in one FADD; then the f32
//    product and the f32 difference (no FMA: the plain version rounds both)
//    and one cvt packs two to bf16x2: 4.75 instructions a weight, against
//    5.5 before. The other candidate, a table of the 16 bf16 values per
//    (group, column) that each warp builds in shared memory when a stage's
//    group changes, looked up by nibble, gives the same bits and is 1.9x
//    slower per Llama-3-8B layer (M=4: 0.178 against 0.095 ms; M=16: 0.181
//    against 0.097; tools/w4a16_g_table_ab.py, NVIDIA H100 80GB HBM3,
//    700 W): the lookup still takes a shift and a mask per weight, then a
//    2-byte shared load (the load pipe serves 32 lanes a clock against 128
//    for the FP32 pipes), and the table has to be built.
//
// Tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate). A thread's four
// n8 tiles take the 4 consecutive columns 4g..4g+3 of its warp's 32, so one
// 16-byte shared load gives it a word row of its 4 columns. The fragment's
// k are the natural ones (x is staged as it lies and loaded by ldmatrix):
// thread t of a fragment needs k = 2t, 2t+1, 2t+8, 2t+9 of a 16-k chunk,
// which are the nibble pair 2 (t & 1) + {0, 1} of word rows t / 2 and
// 2 + t / 2 (low plane at bits 0 and 8 of that half of the word, high plane
// at 4 and 12). The instruction, its shape, the chunk order and the sums
// over the block's two K warps and over the splits are the same for every
// M, so a row's bits do not depend on M, on its place in the batch or on the
// other rows (greedy QSpec == its oracle needs that between the draft's M
// and the verify's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps: 4 along N x 2 along K
constexpr int kWarpsN = 4;
constexpr int kNT = 4;                     // n8 tiles per warp
constexpr int kBN = 8 * kNT * kWarpsN;     // 128 output columns per block
constexpr int kStageRows = 16;             // word rows per stage: 64 k of each plane
constexpr int kStages = 4;
constexpr int kMaxTiles = 4;               // m16 tiles per block
constexpr int kWStride = kBN + 8;          // words per staged weight row (32 B pad)
constexpr int kXStride = 2 * 128 + 16;     // bytes per staged x row: 64 k of each plane
constexpr int kRedStride = kBN + 4;        // floats per row of the reduction tile
constexpr int kWBytes = kStageRows * kWStride * 4;
constexpr int kSoBytes = 4 * kBN * 4;      // one group slot: s, o of both planes

__host__ __device__ constexpr int stage_bytes(int mt, int ng) {
  return kWBytes + ng * kSoBytes + 16 * mt * kXStride;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes with zero fill past `src_bytes`; a source of
// 0 bytes is not read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four consecutive 4-byte columns, `valid` of which lie before N: one
// 16-byte copy when rows are 16-byte aligned (N % 4 == 0), else four
template <bool kVec>
__device__ __forceinline__ void copy_cols4(uint32_t dst, const void* src, int valid) {
  if (kVec) {
    cp_async16(dst, src, valid > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cp_async4(dst + 4 * e, static_cast<const char*>(src) + 4 * (e < valid ? e : 0),
                e < valid ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the nibble q at bit 4p of v (mask 0xF << 4p) as an exact float: OR-ed under
// the exponent of 2^(23 - 4p) it is the units digit of 2^(23 - 4p) + q
template <uint32_t kMask, uint32_t kMagic>
__device__ __forceinline__ float nib(uint32_t v) {
  uint32_t f;
  // (v & kMask) | kMagic as one LOP3 (the compiler folds the constant
  // into a second one otherwise)
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(f) : "r"(v), "n"(kMask), "r"(kMagic));
  return __fsub_rn(__uint_as_float(f), __uint_as_float(kMagic));
}

// bf16-bound q*s - o, rounded as the plain version rounds it (an f32
// product, then an f32 difference: no fused multiply-add)
__device__ __forceinline__ float deq(float q, float s, float o) {
  return __fsub_rn(__fmul_rn(q, s), o);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the A fragment of an m16n8k16 product from four 8x8 tiles of shared
// memory, lane l giving the row address of tile l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

struct Args {
  const __nv_bfloat16* x;
  const uint32_t* w;
  const float* s;
  const float* o;
  void* out;
  float* ws;          // [splits, M, N] partial sums (splits > 1)
  int* counters;      // one per (m block, stripe), 0 between launches
  int M, K, N, G;
  int splits;         // K-slices per stripe, <= K / 128
  int ng;             // group slots per stage
  uint32_t g_mul;     // ceil(2^32 / g): a / g == umulhi(a, g_mul) for a < 2^17
  int out_f32;
};

__device__ __forceinline__ int div_g(int a, uint32_t g_mul) {
  return static_cast<int>(__umulhi(static_cast<uint32_t>(a), g_mul));
}

// this thread's share of every stage's copies, its addresses worked out once:
// weight rows wr and wr + 8 and (scale | offset) rows q and q + 8 at columns
// c..c+3, and 8 k (16 bytes) of x rows xr + 16i in plane xh
template <int MT, bool kVec>
struct Loader {
  const uint32_t* w;
  const float* so[2];
  const __nv_bfloat16* x;
  uint32_t w_dst, so_dst, x_dst;
  int q, valid, x_rows;

  __device__ __forceinline__ Loader(const Args& a, int n0, int m0) {
    const int tid = threadIdx.x;
    const int wr = tid >> 5;
    const int c = (tid & 31) * 4;
    valid = min(4, a.N - n0 - c);
    const int cv = valid > 0 ? c : 0;
    w = a.w + (size_t)wr * a.N + n0 + cv;
    w_dst = (wr * kWStride + c) * 4;
    q = wr;                                  // slot * 4 + plane * 2 + (s | o)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q + 8 * i;
      so[i] = ((qi & 1) ? a.o : a.s) +
              (size_t)((qi >> 2) + ((qi >> 1) & 1) * (a.G >> 1)) * a.N + n0 + cv;
    }
    so_dst = kWBytes + (q * kBN + c) * 4;
    const int xr = tid >> 4;
    const int xh = (tid >> 3) & 1;
    x_rows = min(a.M - m0 - xr, 16 * MT);    // rows xr + 16i < M for 16i < x_rows
    x = a.x + (size_t)(m0 + (x_rows > 0 ? xr : 0)) * a.K + xh * (a.K >> 1) + 8 * (tid & 7);
    x_dst = xr * kXStride + xh * 128 + 16 * (tid & 7);
  }

  // issue the copies of stage `st` into the buffer at shared address `buf`
  __device__ __forceinline__ void load(const Args& a, uint32_t buf, int st) const {
    const uint32_t* ws = w + (size_t)st * kStageRows * a.N;
    copy_cols4<kVec>(buf + w_dst, ws, valid);
    copy_cols4<kVec>(buf + w_dst + 8 * kWStride * 4, ws + 8 * (size_t)a.N, valid);
    const int r0 = st * kStageRows;
    const int gf = div_g(4 * r0, a.g_mul);
    const int rows_so = 4 * (div_g(4 * r0 + 4 * kStageRows - 1, a.g_mul) - gf + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (q + 8 * i < rows_so) {
        copy_cols4<kVec>(buf + so_dst + 8 * i * kBN * 4, so[i] + (size_t)gf * a.N, valid);
      }
    }
    const uint32_t xb = buf + kWBytes + a.ng * kSoBytes + x_dst;
    const __nv_bfloat16* xs = x + 4 * r0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const bool ok = 16 * i < x_rows;
      cp_async16(xb + i * 16 * kXStride, ok ? xs + (size_t)16 * i * a.K : xs, ok ? 16 : 0);
    }
  }
};

// the k of the stage in `buf`: this warp's two chunks of 16 k of each plane.
// Thread t of a fragment takes k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of a
// chunk, the nibble pair 2 (t & 1) + {0, 1} of word rows t / 2 and 2 + t / 2
template <int MT>
__device__ __forceinline__ void compute_stage(const Args& a, const char* buf, int st,
                                              float (&acc)[MT][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wk = warp / kWarpsN;            // K half of the stage: chunks 2wk, 2wk+1
  const int col = (warp % kWarpsN) * 8 * kNT + 4 * (lane >> 2);
  const int t = lane & 3;
  const int half = 16 * (t & 1);
  const uint32_t* w_s = reinterpret_cast<const uint32_t*>(buf) + (t >> 1) * kWStride + col;
  const float* so_s = reinterpret_cast<const float*>(buf + kWBytes) + col;
  // lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of an m16 tile, k
  // 8 (l >> 4) .. + 7 of a chunk
  const uint32_t x_s = smem_u32(buf + kWBytes + a.ng * kSoBytes) +
                       ((lane & 7) + 8 * ((lane >> 3) & 1)) * kXStride + 16 * (lane >> 4);
  const int r0 = st * kStageRows;
  const int gf = div_g(4 * r0, a.g_mul);
  int slot_loaded = 0;
  float4 s_lo, o_lo, s_hi, o_hi;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int c = 2 * wk + cc;
    const int slot = div_g(4 * (r0 + 4 * c), a.g_mul) - gf;
    if (cc == 0 || slot != slot_loaded) {   // warp-uniform
      const float* so = so_s + slot * 4 * kBN;
      s_lo = *reinterpret_cast<const float4*>(so);
      o_lo = *reinterpret_cast<const float4*>(so + kBN);
      s_hi = *reinterpret_cast<const float4*>(so + 2 * kBN);
      o_hi = *reinterpret_cast<const float4*>(so + 3 * kBN);
      slot_loaded = slot;
    }
    const uint4 wa = *reinterpret_cast<const uint4*>(w_s + 4 * c * kWStride);
    const uint4 wb = *reinterpret_cast<const uint4*>(w_s + (4 * c + 2) * kWStride);
    uint32_t xl[MT][4], xh[MT][4];          // A fragments of the low and high plane
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      ldmatrix_x4(xl[mi], x_s + 16 * mi * kXStride + 32 * c);
      ldmatrix_x4(xh[mi], x_s + 16 * mi * kXStride + 128 + 32 * c);
    }
    const uint32_t wva[kNT] = {wa.x, wa.y, wa.z, wa.w};
    const uint32_t wvb[kNT] = {wb.x, wb.y, wb.z, wb.w};
    const float sl[kNT] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
    const float ol[kNT] = {o_lo.x, o_lo.y, o_lo.z, o_lo.w};
    const float sh[kNT] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
    const float oh[kNT] = {o_hi.x, o_hi.y, o_hi.z, o_hi.w};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint32_t u = wva[j] >> half;
      const uint32_t v = wvb[j] >> half;
      // low plane at bits 0 and 8 of this half, high plane at 4 and 12
      const uint32_t bl0 = pack_bf16x2(deq(nib<0xFu, 0x4B000000u>(u), sl[j], ol[j]),
                                       deq(nib<0xF00u, 0x47000000u>(u), sl[j], ol[j]));
      const uint32_t bl1 = pack_bf16x2(deq(nib<0xFu, 0x4B000000u>(v), sl[j], ol[j]),
                                       deq(nib<0xF00u, 0x47000000u>(v), sl[j], ol[j]));
      const uint32_t bh0 = pack_bf16x2(deq(nib<0xF0u, 0x49000000u>(u), sh[j], oh[j]),
                                       deq(nib<0xF000u, 0x45000000u>(u), sh[j], oh[j]));
      const uint32_t bh1 = pack_bf16x2(deq(nib<0xF0u, 0x49000000u>(v), sh[j], oh[j]),
                                       deq(nib<0xF000u, 0x45000000u>(v), sh[j], oh[j]));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][j], xl[mi][0], xl[mi][1], xl[mi][2], xl[mi][3], bl0, bl1);
        mma_bf16(acc[mi][j], xh[mi][0], xh[mi][1], xh[mi][2], xh[mi][3], bh0, bh1);
      }
    }
  }
}

__device__ __forceinline__ void store_out(const Args& a, size_t i, float4 v, bool vec) {
  if (a.out_f32) {
    float* p = static_cast<float*>(a.out) + i;
    if (vec) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      p[0] = v.x;
    }
  } else {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(a.out) + i;
    if (vec) {
      const uint2 u = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
      *reinterpret_cast<uint2*>(p) = u;
    } else {
      p[0] = __float2bfloat16_rn(v.x);
    }
  }
}

template <int MT, bool kVec>
__global__ void __launch_bounds__(kThreads, MT <= 2 ? 2 : 1) w4a16_g_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ int is_last;
  const int stripes = (a.N + kBN - 1) / kBN;
  const int stripe = blockIdx.x % stripes;
  const int split = blockIdx.x / stripes;
  const int n0 = stripe * kBN;
  const int m0 = blockIdx.y * 16 * kMaxTiles;
  // slice i takes stages [i T / splits, (i + 1) T / splits) of T = K / 128
  const int stages = a.K / (8 * kStageRows);
  const int st0 = split * stages / a.splits;
  const int n_st = (split + 1) * stages / a.splits - st0;
  const int sbytes = stage_bytes(MT, a.ng);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t ring = smem_u32(smem);
  const Loader<MT, kVec> loader(a, n0, m0);

  float acc[MT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;

  // the ring: while stage i is dequantized and multiplied, stages i+1 ..
  // i+kStages-1 are on their way
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_st) loader.load(a, ring + i * sbytes, st0 + i);
    cp_async_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage i are in
    __syncthreads();                // everyone's are, and stage i-1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n_st) loader.load(a, ring + (nx % kStages) * sbytes, st0 + nx);
    cp_async_commit();
    compute_stage<MT>(a, smem + (i % kStages) * sbytes, st0 + i, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the two K warps of a column slab: the upper adds into the lower's sums
  // through shared memory (acc_lower + acc_upper), then the block's tile
  // [16 MT, 128] is stored from there
  const int wk = warp / kWarpsN;
  const int col = (warp % kWarpsN) * 8 * kNT + 8 * (lane & 3);
  const int g8 = lane >> 2;
  float* red = reinterpret_cast<float*>(smem);
  for (int pass = 1; pass >= 0; --pass) {
    if (wk == pass) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {        // rows g8 and g8 + 8
          float* p = red + (16 * mi + g8 + 8 * h) * kRedStride + col;
          float4 v0 = make_float4(acc[mi][0][2 * h], acc[mi][1][2 * h], acc[mi][2][2 * h],
                                  acc[mi][3][2 * h]);
          float4 v1 = make_float4(acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                                  acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]);
          if (pass == 0) {
            const float4 u0 = *reinterpret_cast<const float4*>(p);
            const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
            v0 = make_float4(v0.x + u0.x, v0.y + u0.y, v0.z + u0.z, v0.w + u0.w);
            v1 = make_float4(v1.x + u1.x, v1.y + u1.y, v1.z + u1.z, v1.w + u1.w);
          }
          *reinterpret_cast<float4*>(p) = v0;
          *reinterpret_cast<float4*>(p + 4) = v1;
        }
    }
    __syncthreads();
  }

  // stores of 4 columns a thread where N % 4 == 0, else of 1
  const bool vec = kVec;
  const int per = vec ? 4 : 1;
  const int rows = min(16 * MT, a.M - m0);
  const int units = rows * (kBN / per);
  for (int idx = threadIdx.x; idx < units; idx += kThreads) {
    const int row = idx / (kBN / per);
    const int c = (idx % (kBN / per)) * per;
    if (n0 + c >= a.N) continue;
    const float* r = red + row * kRedStride + c;
    const float4 v = vec ? *reinterpret_cast<const float4*>(r) : make_float4(*r, 0.f, 0.f, 0.f);
    const size_t i = (size_t)(m0 + row) * a.N + n0 + c;
    if (a.splits == 1) {
      store_out(a, i, v, vec);
    } else if (vec) {
      *reinterpret_cast<float4*>(a.ws + (size_t)split * a.M * a.N + i) = v;
    } else {
      a.ws[(size_t)split * a.M * a.N + i] = v.x;
    }
  }
  if (a.splits == 1) return;

  // the last block of this (m block, stripe) to arrive adds the splits in
  // index order and resets the counter for the next launch. The barrier
  // orders the block's partial sums before thread 0's fence, which
  // releases them with its arrival (and acquires the others' for the last)
  __syncthreads();
  int* counter = a.counters + blockIdx.y * stripes + stripe;
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(counter, 1) == a.splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  const size_t plane = (size_t)a.M * a.N;
  for (int idx = threadIdx.x; idx < units; idx += kThreads) {
    const int row = idx / (kBN / per);
    const int c = (idx % (kBN / per)) * per;
    if (n0 + c >= a.N) continue;
    const size_t i = (size_t)(m0 + row) * a.N + n0 + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec) {
#pragma unroll 8
      for (int sp = 0; sp < a.splits; ++sp) {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(a.ws + sp * plane + i));
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
    } else {
#pragma unroll 8
      for (int sp = 0; sp < a.splits; ++sp) v.x += __ldcg(a.ws + sp * plane + i);
    }
    store_out(a, i, v, vec);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <int MT, bool kVec>
int launch(const Args& a, int m_blocks, cudaStream_t stream) {
  const int smem = kStages * stage_bytes(MT, a.ng);
  static int smem_set = 48 * 1024;   // the default limit of dynamic shared memory
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4a16_g_kernel<MT, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const dim3 grid(((a.N + kBN - 1) / kBN) * a.splits, m_blocks);
  w4a16_g_kernel<MT, kVec><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_mt(const Args& a, cudaStream_t stream) {
  const int m_blocks = (a.M + 16 * kMaxTiles - 1) / (16 * kMaxTiles);
  switch (a.M > 48 ? 4 : (a.M + 15) / 16) {
    case 1: return launch<1, kVec>(a, m_blocks, stream);
    case 2: return launch<2, kVec>(a, m_blocks, stream);
    case 3: return launch<3, kVec>(a, m_blocks, stream);
    default: return launch<4, kVec>(a, m_blocks, stream);
  }
}

}  // namespace

// x bf16 [M, K], w int32 [K/8, N] (unsigned nibbles), s and o f32 [G, N],
// out [M, N] (bf16, or f32 when out_f32); ws f32 [splits, M, N] when
// splits > 1; counters int32, one per (ceil(M / 64), ceil(N / 128)) tile,
// all 0. K % 256 == 0, K < 2^17, splits <= K / 128, G even, g = K / G a
// multiple of 16 dividing K/2, ng the most groups a stage of 64 k of one
// plane touches (<= 4); pointers 16-byte aligned.
extern "C" int qspec_w4a16_g(const void* x, const void* w, const void* s, const void* o,
                             void* out, void* ws, void* counters, int M, int K, int N,
                             int G, int splits, int ng, int out_f32, void* stream) {
  const int g = K / G;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w),
         static_cast<const float*>(s), static_cast<const float*>(o), out,
         static_cast<float*>(ws), static_cast<int*>(counters), M, K, N, G, splits, ng,
         static_cast<uint32_t>((0x100000000ull + g - 1) / g), out_f32};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N % 4 == 0 ? launch_mt<true>(a, st) : launch_mt<false>(a, st);
}
