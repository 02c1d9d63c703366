// W8A16 GEMM for Hopper: bf16 activations x byte weights, int8 (the int8
// lm_head, the W8A16 trunk of compressed-tensors int-quantized checkpoints)
// or float8_e4m3fn (the trunk of float-quantized / fbgemm_fp8 ones), one
// template over the weight type.
//
// Replaces the TPU kernel qspec_tpu/ops/linear_kernels.py:538
// (_w8a16_kernel, entry point matmul_w8a16, plain and layer-stacked forms),
// which widens either byte type to bf16 in VMEM.
//
//   out[m, n] = (sum_k x[m, k] * bf16(w[k, n])) * s[n]
//
// x bf16 [M, K]; w int8 or e4m3 [K, N] row-major, as the loaders write it
// (no repack); s f32 [N]; f32 accumulation; out bf16 or f32 [M, N].
//
// What bounds it on the H100: up to M = 64 the weights are nearly all of
// the bytes (K*N: 525 MB for Llama-3's 128256-word head, 218 MB for one
// Llama-3-8B layer's four trunk projections) against 2*M operations a
// weight byte, far under the card's ~295 op/byte ridge: device-memory bytes
// bound it.
//
// What the design does (csrc/w4.cu's, carried over to byte weights):
//
// 1. Every SM, with equal shares (stream-K): the weight's (128-column
//    stripe, 128-k stage) units, 16 KB each, stripe after stripe, are cut
//    into P = min(SMs, units) runs of equal length, one a block, block p
//    taking units [p U / P, (p + 1) U / P). A stripe that one run covers is
//    written out by it; the other stripes' pieces (segments) go to an f32
//    workspace, two slots a block (its run's first and last segment), and
//    the last block to arrive at a stripe's counter (one acq_rel atomic a
//    stripe) adds its segments in block order and resets the counter. The
//    cut depends on (K, N, SM count) only, never on M
//    (ops/linear_kernels.py w8_workers). o and down (32 stripes) fill all
//    132 SMs, where one block a 64-column stripe gave them 64 blocks.
// 2. Bytes in flight: a ring of up to 4 shared-memory stages filled by
//    16-byte cp.async copies (8-byte ones when N % 16 != 0), so the loads
//    of the next three stages are in flight while one is decoded and
//    multiplied. A stage is 128 weight rows of the stripe (rows padded to
//    144 bytes: conflict-free 4-byte reads) and the activation rows of the
//    same k (rows padded to 272 bytes: conflict-free ldmatrix). The weight
//    copies carry an L2 evict_first policy (each weight is read once).
// 3. M: a block carries MT = ceil(min(M, 64) / 16) m16 tiles and applies
//    each decoded B fragment to all of them, so up to M = 64 (the Medusa
//    tree verify's 60 among them) each weight leaves device memory once.
//    Past 64 rows a block owns one (stripe, 64-row block) over all of K,
//    with no workspace; the blocks of a stripe are grid neighbours (M
//    fastest), so the first reads the stripe from device memory and the
//    others find it in L2. Such a block ends a segment at the same cuts as
//    in (1) and adds the segments in the same order.
// 4. Decode, exact for every byte (each int8 and each e4m3 value is a bf16
//    value). Thread (g, t) of a warp takes k = 2t, 2t+1 (b0) and 2t+8, 2t+9
//    (b1) of a 16-k chunk, the standard m16n8k16 B fragment, for 4
//    consecutive columns 4g..4g+3 of its warp's 32: one 4-byte shared read
//    a row; fragment column g of n8 tile j is warp column 4g + j. A byte
//    permute puts a column's bytes of two rows in the low bytes of a pair's
//    halves; then
//    - int8 (value v = l - 128 s, l its low 7 bits, s its sign bit): one
//      LOP3 builds the bf16 bits of 128 + l (0x4300 | l), one more those of
//      -(128 + 128 s) (0xC300 | s << 7: -128 or -256), and one packed bf16
//      FMA (x 1) adds them: v, exactly; 4 instructions a pair, 2 a weight
//      in SASS (PRMT, LOP3, HADD2; the earlier 2^23 f32 bias took 2.75);
//    - e4m3: cvt.rn.f16x2.e4m3x2 (sm_89+), then f16 -> f32 -> bf16: every
//      e4m3 value, subnormals down to 2^-9 included, is an f16 and a bf16
//      value, and the NaN codes 0x7F / 0xFF stay NaN (e4m3fn has no
//      infinity), so a NaN weight gives a NaN output.
//    The scale waits for the epilogue.
// 5. Launch: a programmatic dependent launch. The grid is set up while the
//    previous kernel of the stream ends, and waits for it
//    (griddepcontrol.wait) before its first memory access.
//
// Order: a stage's eight 16-k chunks go to two K warps (chunks 0-3 and 4-7)
// by four N warps; a segment's sum is the lower K warp's plus the upper's,
// the segments of a stripe are added in block order. Instruction, shape and
// order are the same at every M: a row's bits do not depend on M, on its
// place in the batch, on a second call or on a graph replay (greedy QSpec ==
// its oracle needs that: the oracle runs the head at M = 4, the verify at
// 16). ops/linear_kernels.py matmul_w8_split_ref is that order in plain
// PyTorch.
//
// Measured on an H100 SXM at 700 W (tools/w8_variants_ab.py: kernel only,
// inputs rotated past L2): one Llama-3-8B trunk layer (218 MB) 0.099 ms at
// M = 4 and 0.109 at 16 (bound 0.065), the Llama-3 head (525 MB) 0.205 /
// 0.209 at M = 4 / 16 (bound 0.158 / 0.160) and 0.325 at M = 60. The ring's
// stream bounds it: before the evict_first hint, the same runs with no
// decode, no MMA and no activation copies took 0.1107 ms a trunk layer at
// M = 16 and 0.2127 for the head, against the kernel's 0.1166 and 0.2195.
// Timed and dropped, against the kernel of the same call (ms a trunk layer
// at M = 4 / 16; the head at M = 16, 60):
//  - a 3-stage ring: 0.1066 / 0.1181, head 0.2298 (kernel 0.1047 / 0.1166,
//    0.2195); 6 stages (5 at four tiles): 0.1095 / 0.1250;
//  - 64-k stages (8 KB units), 8 deep: 0.1150 / 0.1280, head 0.2382;
//  - 2 m16 tiles a block (whole mode past 32 rows): head at 60 0.5052
//    (kernel 0.3260);
//  - 256-column stripes, no K split in a block: the heads 0.3-11% faster (at
//    60 0.2892 against 0.3253), the trunk 4-15% slower (0.1046 / 0.1259
//    against 0.0994 / 0.1091), down 26% slower (coarser runs);
//  - the 2^23-bias int8 decode: 0.1171 / 0.1217 (12% / 4% slower);
//  - no evict_first: 0.1045 / 0.1162 against 0.0994 / 0.1091;
//  - no programmatic launch: 0.1084 / 0.1208 (3.5% slower).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps: 4 along N x 2 along K
constexpr int kWarpsN = 4;
// K warps a stage's chunks are split over: 2 (1 with 8 N warps, 256-column
// stripes: timed and dropped, above)
constexpr int kWarpsK = kThreads / 32 / kWarpsN;
constexpr int kNT = 4;                     // n8 tiles per warp
constexpr int kBN = 8 * kNT * kWarpsN;     // 128 output columns (weight bytes a row) per stripe
constexpr int kStageK = 128;               // weight rows (k) per stage: 16 KB of weights
constexpr int kRingBytes = 180 * 1024;     // the most shared memory the ring takes
constexpr int kMaxStages = 4;
constexpr int kMaxTiles = 4;               // m16 tiles per block
constexpr int kWStride = kBN + 16;         // bytes per staged weight row
constexpr int kWBytes = kStageK * kWStride;
constexpr int kXStride = 2 * kStageK + 16; // bytes per staged activation row
// the upper K warps' sums, per m16 tile
constexpr int kRedBytes = kWarpsK == 2 ? 32 * kWarpsN * kNT * 4 * 4 : 0;

__host__ __device__ constexpr int stage_bytes(int mt) { return kWBytes + 16 * mt * kXStride; }

// stages in the ring: as many as kRingBytes holds, at most kMaxStages
__host__ __device__ constexpr int ring_stages(int mt) {
  return kRingBytes / stage_bytes(mt) < kMaxStages ? kRingBytes / stage_bytes(mt) : kMaxStages;
}

__host__ __device__ constexpr int smem_bytes(int mt) {
  return ring_stages(mt) * stage_bytes(mt) + mt * kRedBytes;
}

struct Args {
  const __nv_bfloat16* x;   // [M, K]
  const uint8_t* w;         // [K, N] int8 or e4m3 bytes
  const float* s;           // per-column scales [N]
  void* out;                // [M, N]: bf16, or f32 when out_f32
  float* ws;                // split mode: [2 P, M, 128] f32
  int* counters;            // split mode: one per stripe, 0 between launches
  int M, K, N;
  int stages;               // T = ceil(K / 128) stages per stripe
  int stripes;              // ceil(N / 128)
  int workers;              // P, the runs the units are cut into
  int m_blocks;             // whole mode: ceil(M / 64)
  int out_f32;
};

// the first unit of run p (p = P: the end)
__device__ __forceinline__ int run_start(const Args& a, int p) {
  return static_cast<int>(static_cast<long long>(p) * a.stripes * a.stages / a.workers);
}

// the run that holds unit u
__device__ __forceinline__ int run_of(const Args& a, int u) {
  return static_cast<int>((static_cast<long long>(u + 1) * a.workers - 1) /
                          (static_cast<long long>(a.stripes) * a.stages));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 8 bytes with zero fill past `src_bytes`; a source of 0
// bytes is not read. The weight copies carry an L2 evict_first policy: each
// weight is read once a call, so it should not push the activations, the
// workspace and the next kernel's inputs out of L2
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16_ef(uint32_t dst, const void* src, int src_bytes,
                                              uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes), "l"(pol) : "memory");
}
__device__ __forceinline__ void cp_async8_ef(uint32_t dst, const void* src, int src_bytes,
                                             uint64_t pol) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2, %3;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes), "l"(pol) : "memory");
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of an m16 tile from four 8x8 tiles of 16-byte rows in
// shared memory, lane l giving the row address of tile l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the bf16 pair (lo <- byte j of a, hi <- byte j of b): one column of two
// weight rows, decoded exactly
template <bool kFp8, int J>
__device__ __forceinline__ uint32_t decode_pair(uint32_t a, uint32_t b) {
  if constexpr (kFp8) {
    const uint32_t pair = __byte_perm(a, b, J | ((4 + J) << 4));
    uint32_t h2;
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h2) : "h"(static_cast<unsigned short>(pair)));
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
    __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    // bytes 0 and 2 <- byte J of a and of b (1 and 3: copies, masked off)
    const uint32_t p = __byte_perm(a, b, J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12));
    uint32_t lo, hi, d;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"        // (p & 0x7F) | 0x4300: 128 + l
        : "=r"(lo) : "r"(p), "n"(0x007F007Fu), "r"(0x43004300u));
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"        // (p & 0x80) | 0xC300: -(128 + 128 s)
        : "=r"(hi) : "r"(p), "n"(0x00800080u), "r"(0xC300C300u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"         // l - 128 s, exactly
        : "=r"(d) : "r"(lo), "r"(0x3F803F80u), "r"(hi));
    return d;
  }
}

// this thread's share of every stage's copies: 16 bytes of weight rows
// wr + kWRows i at stripe column wc; 16 bytes (piece xp, 8 k) of
// activation rows xr + kXRows i
template <int MT, bool kVec>
struct Loader {
  static constexpr int kWRows = kThreads / (kBN / 16);      // weight rows a pass
  static constexpr int kXPieces = kStageK / 8;              // 16-byte pieces of an x row
  static constexpr int kXRows = kThreads / kXPieces;        // activation rows a pass
  int wr, wc, xr, xp;
  uint64_t pol;                                             // the weights' L2 policy

  __device__ __forceinline__ Loader() {
    const int tid = threadIdx.x;
    pol = evict_first_policy();
    wr = tid / (kBN / 16);
    wc = tid % (kBN / 16) * 16;
    xp = tid % kXPieces;
    xr = tid / kXPieces;
  }

  // issue the copies of stage st of stripe s into `buf`
  __device__ __forceinline__ void load(const Args& a, uint32_t buf, int s, int st, int m0) const {
    const int k0 = st * kStageK;
    const int rows = min(kStageK, a.K - k0);                  // weight rows of this stage
    const int n0 = s * kBN;
    const int valid = min(16, a.N - n0 - wc);                 // bytes of the row left of N
    const uint8_t* src = a.w + (size_t)k0 * a.N + n0 + (valid > 0 ? wc : 0);
#pragma unroll
    for (int i = 0; i < kStageK / kWRows; ++i) {
      const int row = wr + kWRows * i;
      const bool ok = row < rows && valid > 0;
      const uint8_t* p = src + (size_t)(ok ? row : 0) * a.N;
      const uint32_t dst = buf + row * kWStride + wc;
      if (kVec) {
        cp_async16_ef(dst, p, ok ? 16 : 0, pol);
      } else {
        cp_async8_ef(dst, p, ok ? 8 : 0, pol);
        cp_async8_ef(dst + 8, p + (ok && valid > 8 ? 8 : 0), ok && valid > 8 ? 8 : 0, pol);
      }
    }
    const bool k_ok = xp * 8 < rows;
    const uint32_t dst = buf + kWBytes + xp * 16;
#pragma unroll
    for (int i = 0; i < (16 * MT + kXRows - 1) / kXRows; ++i) {
      const int row = xr + kXRows * i;
      if (row >= 16 * MT) break;
      const bool ok = k_ok && m0 + row < a.M;
      const __nv_bfloat16* p = a.x + (ok ? (size_t)(m0 + row) * a.K + k0 + xp * 8 : 0);
      cp_async16(dst + row * kXStride, p, ok ? 16 : 0);
    }
  }
};

// the stage in `buf` (its first `rows` weight rows are filled): this warp's
// share of the 16-k chunks, applied to all MT m16 tiles
template <bool kFp8, int MT>
__device__ __forceinline__ void compute_stage(const char* buf, int rows,
                                              float (&acc)[MT][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wk = warp / kWarpsN;
  const int t = lane & 3;
  const char* w_s = buf + (warp % kWarpsN) * 8 * kNT + 4 * (lane >> 2) + 2 * t * kWStride;
  // lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of an m16 tile, k 8 (l / 16)..+7 of a chunk
  const uint32_t x_s = smem_u32(buf + kWBytes) + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kXStride +
                       16 * (lane >> 4);
  constexpr int kChunks = kStageK / 16 / kWarpsK;   // per K warp
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int ch = kChunks * wk + cc;
    if (16 * ch >= rows) break;               // warp-uniform: past K
    // rows 2t, 2t+1, 2t+8, 2t+9 of the chunk, 4 columns each
    const char* wp = w_s + 16 * ch * kWStride;
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(wp);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(wp + kWStride);
    const uint32_t r8 = *reinterpret_cast<const uint32_t*>(wp + 8 * kWStride);
    const uint32_t r9 = *reinterpret_cast<const uint32_t*>(wp + 9 * kWStride);
    uint32_t xa[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(xa[mi], x_s + 16 * mi * kXStride + 32 * ch);
    uint32_t b[kNT][2];
    b[0][0] = decode_pair<kFp8, 0>(r0, r1), b[0][1] = decode_pair<kFp8, 0>(r8, r9);
    b[1][0] = decode_pair<kFp8, 1>(r0, r1), b[1][1] = decode_pair<kFp8, 1>(r8, r9);
    b[2][0] = decode_pair<kFp8, 2>(r0, r1), b[2][1] = decode_pair<kFp8, 2>(r8, r9);
    b[3][0] = decode_pair<kFp8, 3>(r0, r1), b[3][1] = decode_pair<kFp8, 3>(r8, r9);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi][j], xa[mi], b[j][0], b[j][1]);
  }
}

// out[m, n..n+3] = v * s[n..n+3], columns past N skipped
template <bool kVec>
__device__ __forceinline__ void store4(const Args& a, int m, int n, const float (&v)[4]) {
  if (n >= a.N) return;
  const size_t i = (size_t)m * a.N + n;
  float f[4];
  if (kVec) {
    const float4 s = *reinterpret_cast<const float4*>(a.s + n);
    f[0] = v[0] * s.x, f[1] = v[1] * s.y, f[2] = v[2] * s.z, f[3] = v[3] * s.w;
    if (a.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + i) =
          make_float4(f[0], f[1], f[2], f[3]);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + i) =
          make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n + e >= a.N) break;
      const float fe = v[e] * a.s[n + e];
      if (a.out_f32) {
        static_cast<float*>(a.out)[i + e] = fe;
      } else {
        static_cast<__nv_bfloat16*>(a.out)[i + e] = __float2bfloat16_rn(fe);
      }
    }
  }
}

// a lower K warp's tile of sums v (rows g, g + 8 of each m16 tile, columns
// 8t..8t+7 of its 32: n8 tile j holds column 4 g' + j at fragment column
// g'), stored through the epilogue
template <int MT, bool kVec>
__device__ __forceinline__ void store_tile(const Args& a, int m0, int n0,
                                           const float (&v)[MT][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (threadIdx.x >> 5) % kWarpsN * 8 * kNT + 8 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * mi + (lane >> 2) + 8 * h;
      if (m >= a.M) continue;
      const float lo[4] = {v[mi][0][2 * h], v[mi][1][2 * h], v[mi][2][2 * h], v[mi][3][2 * h]};
      const float hi[4] = {v[mi][0][2 * h + 1], v[mi][1][2 * h + 1], v[mi][2][2 * h + 1],
                           v[mi][3][2 * h + 1]};
      store4<kVec>(a, m, n, lo);
      store4<kVec>(a, m, n + 4, hi);
    }
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// old = *p; *p += v, at gpu scope with acquire and release semantics
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// stripe s: its segments' sums from the workspace, added in block order
// (run p_lo's slot is its last segment unless its run begins at the
// stripe; every later run begins inside the stripe: its first slot), then
// the epilogue. Split mode only (M <= 64, m0 = 0).
template <bool kVec>
__device__ void fold_stripe(const Args& a, int s) {
  const int T = a.stages;
  const int p_lo = run_of(a, s * T);
  const int p_hi = run_of(a, (s + 1) * T - 1);
  const int slot_lo = 2 * p_lo + (run_start(a, p_lo) != s * T);
  const size_t plane = (size_t)a.M * kBN;
  for (int idx = threadIdx.x; idx < a.M * (kBN / 4); idx += kThreads) {
    const int row = idx / (kBN / 4);
    const int c = (idx % (kBN / 4)) * 4;
    if (s * kBN + c >= a.N) continue;
    const size_t off = (size_t)row * kBN + c;
    const float4 u = __ldcg(reinterpret_cast<const float4*>(a.ws + slot_lo * plane + off));
    float v[4] = {u.x, u.y, u.z, u.w};
    // the later runs' first slots, four loads in flight, added in order
    int p = p_lo + 1;
    for (; p + 3 <= p_hi; p += 4) {
      float4 q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = __ldcg(reinterpret_cast<const float4*>(a.ws + 2 * (p + i) * plane + off));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[0] += q[i].x, v[1] += q[i].y, v[2] += q[i].z, v[3] += q[i].w;
    }
    for (; p <= p_hi; ++p) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(a.ws + 2 * p * plane + off));
      v[0] += q.x, v[1] += q.y, v[2] += q.z, v[3] += q.w;
    }
    store4<kVec>(a, row, s * kBN + c, v);
  }
}

template <bool kFp8, int MT, bool kVec, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1) w8a16_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ int folds[2];                   // stripes this block adds up (split mode)
  __shared__ int n_folds;
  int pend_first = -1, pend_last = -1;       // stripes of the run's partial segments
  const int T = a.stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wk = warp / kWarpsN;
  int u0, u1, m0;
  if (kWhole) {
    const int s = blockIdx.x / a.m_blocks;
    m0 = (blockIdx.x - s * a.m_blocks) * 16 * kMaxTiles;
    u0 = s * T;
    u1 = u0 + T;
  } else {
    m0 = 0;
    u0 = run_start(a, blockIdx.x);
    u1 = run_start(a, blockIdx.x + 1);
  }
  constexpr int sbytes = stage_bytes(MT);
  constexpr int kStages = ring_stages(MT);
  const uint32_t ring = smem_u32(smem);
  // the upper K warps' sums, thread-major so each lane of a lower warp
  // reads back its twin's values
  float* red = reinterpret_cast<float*>(smem + kStages * sbytes) + (warp % kWarpsN) * 32 + lane;
  const Loader<MT, kVec> loader;
  if (threadIdx.x == 0) n_folds = 0;
  // launched before the previous kernel of the stream ends: wait for it (and
  // its memory) before the first access; the next kernel may launch once
  // every block of this one runs
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float acc[MT][kNT][4];
  float total[kWhole ? MT : 1][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;

  const int n_units = u1 - u0;
  // the next unit to load, as (stripe, stage)
  int ls = u0 / T, lst = u0 - ls * T;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_units) {
      loader.load(a, ring + i * sbytes, ls, lst, m0);
      if (++lst == T) lst = 0, ++ls;
    }
    cp_async_commit();
  }
  int s = u0 / T, st = u0 - s * T;                          // the unit computed next
  int seg0 = u0;                                            // the open segment's first unit
  int cut = kWhole ? run_start(a, run_of(a, u0) + 1) : u1;  // where it must end
  for (int i = 0; i < n_units; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of unit i are in
    __syncthreads();                // everyone's are, and unit i-1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n_units) {
      loader.load(a, ring + (nx % kStages) * sbytes, ls, lst, m0);
      if (++lst == T) lst = 0, ++ls;
    }
    cp_async_commit();
    compute_stage<kFp8, MT>(smem + (i % kStages) * sbytes, min(kStageK, a.K - st * kStageK), acc);
    const int nu = u0 + i + 1;
    const bool stripe_end = ++st == T;
    const int sc = s;                        // the stripe of this unit
    if (stripe_end) st = 0, ++s;
    if (!stripe_end && nu != u1 && nu != cut) continue;

    // the segment [seg0, nu) ends: lower + upper K warp, in the lower
    if constexpr (kWarpsK == 2) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (wk == 1) red[((mi * kNT + j) * 4 + e) * 32 * kWarpsN] = acc[mi][j][e];
          }
      __syncthreads();
      if (wk == 0) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mi][j][e] += red[((mi * kNT + j) * 4 + e) * 32 * kWarpsN];
            }
      }
    }
    const bool whole = seg0 == sc * T && stripe_end;
    if (wk == 0) {
      if constexpr (kWhole) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              total[mi][j][e] = seg0 == u0 ? acc[mi][j][e] : total[mi][j][e] + acc[mi][j][e];
        if (stripe_end) store_tile<MT, kVec>(a, m0, sc * kBN, total);
      } else if (whole) {
        store_tile<MT, kVec>(a, m0, sc * kBN, acc);
      } else {
        // slot 2p: the run's first segment, 2p + 1: its last
        float* ws = a.ws + (size_t)(2 * blockIdx.x + (seg0 != u0)) * a.M * kBN +
                    (warp % kWarpsN) * 8 * kNT + 8 * (lane & 3);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 16 * mi + (lane >> 2) + 8 * h;
            if (m >= a.M) continue;
            st4(ws + (size_t)m * kBN, acc[mi][0][2 * h], acc[mi][1][2 * h], acc[mi][2][2 * h],
                acc[mi][3][2 * h]);
            st4(ws + (size_t)m * kBN + 4, acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]);
          }
      }
    }
    if (!kWhole && !whole) (seg0 == u0 ? pend_first : pend_last) = sc;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    seg0 = nu;
    if (kWhole && nu == cut) cut = run_start(a, run_of(a, nu) + 1);
  }
  cp_async_wait<0>();
  if (kWhole) return;
  // arrive at the counters of the stripes of this run's partial segments;
  // the last of a stripe's n runs adds the stripe up. The barrier orders
  // the block's partial sums before thread 0's arrival, which releases them
  // (and acquires the others' for the last)
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      const int sp = i == 0 ? pend_first : pend_last;
      if (sp < 0) continue;
      const int n = run_of(a, (sp + 1) * T - 1) - run_of(a, sp * T) + 1;
      if (atomic_add_acq_rel(a.counters + sp, 1) == n - 1) folds[n_folds++] = sp;
    }
  }
  __syncthreads();
  const int nf = n_folds;
  for (int f = 0; f < nf; ++f) fold_stripe<kVec>(a, folds[f]);
  if (threadIdx.x == 0) {
    for (int f = 0; f < nf; ++f) a.counters[folds[f]] = 0;
  }
}

template <bool kFp8, int MT, bool kVec, bool kWhole>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int smem = smem_bytes(MT);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a16_kernel<kFp8, MT, kVec, kWhole>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, w8a16_kernel<kFp8, MT, kVec, kWhole>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFp8, bool kVec>
int launch_m(const Args& a, cudaStream_t stream) {
  if (a.M > 16 * kMaxTiles) {
    return launch<kFp8, kMaxTiles, kVec, true>(a, a.stripes * a.m_blocks, stream);
  }
  switch ((a.M + 15) / 16) {
    case 1: return launch<kFp8, 1, kVec, false>(a, a.workers, stream);
    case 2: return launch<kFp8, 2, kVec, false>(a, a.workers, stream);
    case 3: return launch<kFp8, 3, kVec, false>(a, a.workers, stream);
    default: return launch<kFp8, 4, kVec, false>(a, a.workers, stream);
  }
}

template <bool kFp8>
int run(Args a, cudaStream_t stream) {
  a.stages = (a.K + kStageK - 1) / kStageK;
  a.stripes = (a.N + kBN - 1) / kBN;
  a.m_blocks = (a.M + 16 * kMaxTiles - 1) / (16 * kMaxTiles);
  return a.N % 16 == 0 ? launch_m<kFp8, true>(a, stream) : launch_m<kFp8, false>(a, stream);
}

}  // namespace

// x bf16 [M, K], w int8 [K, N] (qspec_w8a16) or float8_e4m3fn [K, N]
// (qspec_w8a16_fp8), s f32 [N], out [M, N] (bf16, or f32 when out_f32).
// M <= 64: ws f32 [2 workers, M, 128] and counters int32, one per
// 128-column stripe, all 0; workers = min(SMs, ceil(N / 128) ceil(K / 128))
// (ops/linear_kernels.py w8_workers). K % 16 == 0, N % 8 == 0; pointers
// 16-byte aligned.
extern "C" int qspec_w8a16(const void* x, const void* w, const void* s, void* out, void* ws,
                           void* counters, int M, int K, int N, int workers, int out_f32,
                           void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
         static_cast<const float*>(s), out, static_cast<float*>(ws), static_cast<int*>(counters),
         M, K, N, 0, 0, workers, 0, out_f32};
  return run<false>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int qspec_w8a16_fp8(const void* x, const void* w, const void* s, void* out, void* ws,
                               void* counters, int M, int K, int N, int workers, int out_f32,
                               void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
         static_cast<const float*>(s), out, static_cast<float*>(ws), static_cast<int*>(counters),
         M, K, N, 0, 0, workers, 0, out_f32};
  return run<true>(a, static_cast<cudaStream_t>(stream));
}
