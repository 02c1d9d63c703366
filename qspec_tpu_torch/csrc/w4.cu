// The QuaRot int4 GEMMs for Hopper: one kernel template over the activation
// type serves matmul_w4a16 (bf16 activations) and matmul_w4a4 (int8).
//
// Replaces the TPU kernels qspec_tpu/ops/linear_kernels.py:139
// (_w4a16_kernel, entry point matmul_w4a16: the verify GEMM and the int4
// head) and :160 (_w4a4_kernel, entry point matmul_w4a4: the W4A4 / W4A8
// draft GEMM), both built by _w4_pallas.
//
//   w4a16: out[m, n] = (sum_k x[m, k] * (q[k, n] - 8)) * s[n]
//          x bf16 [M, K], f32 accumulation, out bf16 or f32
//   w4a4:  out[m, n] = bf16((f32(sum_k xq[m, k] * (q[k, n] - 8)) * sx[m]) * s[n])
//          xq int8 [M, K] (int4 range for w4a4, full for w4a8), exact sums
//
// q int32 [K/8, N] in the SWAR layout of ops/packing.py: byte b of word row
// r holds k = 4r + b in its low nibble and k = K/2 + 4r + b in its high
// one, both excess-8; s f32 [N]. Both kernels read that one buffer as it is.
//
// What bounds it on the H100: up to M = 64 the packed weights (K*N/2 bytes)
// are nearly all of the bytes, against 4*M operations a weight byte, far
// under the card's ridge (~295 bf16, ~590 int8 operations a byte): device-
// memory bytes bound it. At the draft prefill (M = 1024) int8 operations do.
//
// What the design does (csrc/w4a16_g.cu's, carried over and extended):
//
// 1. Bytes in flight: a ring of up to 4 shared-memory stages filled by
//    cp.async, 16 bytes a thread. A stage is 32 word rows (128 k of each
//    plane) of a 128-column stripe and the activation rows of the same k.
//    (Timed on the card and dropped: 6 to 16 stages of 16 rows, and 2
//    blocks an SM: no faster; the stream of the ring alone, no compute and
//    no x, reaches about 2.7 TB/s past a fixed ~6 us a call.)
// 2. Every SM, with equal shares (stream-K): the weight's (stripe, stage)
//    units, stripe after stripe, are cut into P = min(SMs, units) runs of
//    equal length, block p taking units [p U / P, (p + 1) U / P). A run may
//    begin and end inside a stripe and cover whole stripes between. A stripe
//    that one block covers is written out by it. The other stripes' pieces
//    (segments) go to an f32 (w4a16) or int32 (w4a4) workspace, two slots a
//    block (its run's first and last segment). After its run a block arrives
//    at the counters of those stripes (one acq_rel atomic each); the last to
//    arrive adds the stripe's segments in block order and resets the
//    counter. The cut depends on (K, N, SM count) only, never on M
//    (ops/linear_kernels.py w4_workers).
// 3. M: a block carries MT = ceil(min(M, 64) / 16) m16 tiles and applies
//    each decoded B fragment to all of them, so up to M = 64 each weight
//    leaves device memory once. Past 64 rows (whole mode) a block owns one
//    (stripe, 64-row block) over all of K, with no workspace, and the
//    blocks of a stripe are neighbours in the grid (M fastest): the first
//    reads the stripe from device memory, the others find it in L2. A w4a16
//    block there ends a segment at the same cuts as in (2) and adds the
//    segments in the same order, so a row's bits do not depend on M.
// 4. Decode. w4a4: one word is a thread's B fragment of mma.sync m16n8k32
//    s8 (k = 4t..4t+3 from the low nibbles, 16+4t.. from the high ones, x
//    staged to match): the high nibbles masked in place and XOR-ed with
//    0x80 are the bytes 16 (q - 8), the low ones the same after a 4-bit
//    shift, 3 instructions for 8 weights. The int32 sums are then 16 times
//    the true ones and are shifted back, exactly, at each segment's end.
//    w4a16: a byte permute moves two bytes of a word to the low bytes of a
//    bf16 pair, one LOP3 builds the bf16 bits of 128 + q (0x4300 | q) from
//    their low nibbles (or, after a shift, their high ones) and one packed
//    bf16 FMA subtracts 136: q - 8 exactly, 1.5 instructions a weight, fed
//    to mma.sync m16n8k16 (f32 accumulate); the scale waits for the
//    epilogue.
// 5. Launch: a programmatic dependent launch. The grid is set up while the
//    previous kernel of the stream ends, and waits for it
//    (griddepcontrol.wait) before its first memory access, so nothing is
//    read early: 4-6% a Llama-3-8B layer at M <= 16.
//
// Order: a stage's eight 4-row chunks go to two K warps (chunks 0-3 and
// 4-7) by four N warps; a segment's sum is the lower K warp's plus the
// upper's, the segments of a stripe are added in block order. Instruction,
// shape and order are the same at every M: a w4a16 row's bits do not depend
// on M, on its place in the batch, on a second call or a graph replay
// (greedy QSpec == its oracle needs that); the w4a4 sums are exact, so its
// result equals the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps: 4 along N x 2 along K
constexpr int kWarpsN = 4;
constexpr int kNT = 4;                     // n8 tiles per warp
constexpr int kBN = 8 * kNT * kWarpsN;     // 128 output columns per stripe
constexpr int kStageRows = 32;             // word rows per stage: 128 k of each plane
constexpr int kRingBytes = 180 * 1024;     // the most shared memory the ring takes
constexpr int kMaxStages = 4;
constexpr int kMaxTiles = 4;               // m16 tiles per block
constexpr int kWStride = kBN + 8;          // words per staged weight row (32 B pad)
constexpr int kWBytes = kStageRows * kWStride * 4;
constexpr int kRedBytes = kThreads / 2 * kNT * 4 * 4;   // the upper K warps' sums, per m16 tile

// bytes of one plane of a staged activation row (4 k a word row), and of
// the row: both planes, then 16 of padding
__host__ __device__ constexpr int x_plane(bool int8) { return 4 * kStageRows * (int8 ? 1 : 2); }
__host__ __device__ constexpr int x_stride(bool int8) { return 2 * x_plane(int8) + 16; }

__host__ __device__ constexpr int stage_bytes(bool int8, int mt) {
  return kWBytes + 16 * mt * x_stride(int8);
}

// stages in the ring: as many as kRingBytes holds, at most kMaxStages
__host__ __device__ constexpr int ring_stages(bool int8, int mt) {
  return kRingBytes / stage_bytes(int8, mt) < kMaxStages ? kRingBytes / stage_bytes(int8, mt)
                                                         : kMaxStages;
}

__host__ __device__ constexpr int smem_bytes(bool int8, int mt) {
  return ring_stages(int8, mt) * stage_bytes(int8, mt) + mt * kRedBytes;
}

template <bool kInt8> struct AccOf { using T = float; using V = float4; };
template <> struct AccOf<true> { using T = int; using V = int4; };

struct Args {
  const void* x;         // int8 or bf16 [M, K]
  const float* sx;       // w4a4: per-row scales [M]
  const uint32_t* w;     // [K/8, N]
  const float* s;        // per-column scales [N]
  void* out;             // [M, N]: bf16, or f32 when out_f32 (w4a16)
  void* ws;              // split mode: [2 P, M, 128] f32 (w4a16) or int32 (w4a4)
  int* counters;         // split mode: one per stripe, 0 between launches
  int M, K, N;
  int stages;            // T = ceil(K / 256) stages per stripe
  int stripes;           // ceil(N / 128)
  int workers;           // P, the runs the units are cut into
  int m_blocks;          // whole mode: ceil(M / 64)
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// the low nibbles of the two low bytes of p's halves as the bf16 pair
// q - 8: (p & 0x000F000F) | 0x4300 in each half is 128 + q, exactly; one
// packed FMA (x 1 - 136) gives q - 8, exactly
__device__ __forceinline__ uint32_t bf16_pair_q8(uint32_t p) {
  uint32_t v, d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(v) : "r"(p), "n"(0x000F000Fu), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// a 16-byte store of four partial sums (f32 or int32)
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(int* p, int a, int b, int c, int d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}
// old = *p; *p += v, at gpu scope with acquire and release semantics
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// this thread's share of every stage's copies: weight rows wr and wr + 8 at
// columns c..c+3 of the stripe; 16 bytes of x (plane xh, piece xp) of rows
// xr + i * kXRows
template <bool kInt8, int MT, bool kVec>
struct Loader {
  static constexpr int kPieces = x_plane(kInt8) / 16;         // 16-byte pieces per row and plane
  static constexpr int kPieceK = kInt8 ? 16 : 8;             // k per piece
  static constexpr int kXRows = kThreads / (2 * kPieces);    // rows per pass
  static constexpr int kPasses = (16 * MT + kXRows - 1) / kXRows;
  int wr, c, xr, xh, xp;

  __device__ __forceinline__ Loader() {
    const int tid = threadIdx.x;
    wr = tid >> 5;
    c = (tid & 31) * 4;
    xp = tid % kPieces;
    xh = (tid / kPieces) & 1;
    xr = tid / (2 * kPieces);
  }

  // issue the copies of stage st of stripe s into `buf`
  __device__ __forceinline__ void load(const Args& a, uint32_t buf, int s, int st, int m0) const {
    const int r0 = st * kStageRows;
    const int rows = min(kStageRows, a.K / 8 - r0);          // word rows of this stage
    const int n0 = s * kBN;
    const int valid = min(4, a.N - n0 - c);
    const int cv = valid > 0 ? c : 0;
#pragma unroll
    for (int i = 0; i < kStageRows / 8; ++i) {
      const int row = wr + 8 * i;
      const bool ok = row < rows;
      copy_cols4<kVec>(buf + (row * kWStride + c) * 4,
                       a.w + (size_t)(r0 + (ok ? row : 0)) * a.N + n0 + cv, ok ? valid : 0);
    }
    constexpr int kElem = kInt8 ? 1 : 2;
    constexpr int kXS = x_stride(kInt8);
    const bool k_ok = xp * kPieceK < 4 * rows;
    const uint32_t dst = buf + kWBytes + xh * x_plane(kInt8) + xp * 16;
    const char* x = static_cast<const char*>(a.x);
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int row = xr + i * kXRows;
      if (row < 16 * MT) {
        const bool ok = k_ok && m0 + row < a.M;
        const size_t e = (size_t)(m0 + row) * a.K + xh * (a.K >> 1) + 4 * r0 + xp * kPieceK;
        cp_async16(dst + row * kXS, ok ? x + e * kElem : x, ok ? 16 : 0);
      }
    }
  }
};

// the stage in `buf` (its first `rows` word rows hold weights): this
// warp's half of the chunks of 4 word rows, applied to all MT m16 tiles
template <bool kInt8, int MT>
__device__ __forceinline__ void compute_stage(const char* buf, int rows,
                                              typename AccOf<kInt8>::T (&acc)[MT][kNT][4]) {
  constexpr int kXS = x_stride(kInt8);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wk = warp / kWarpsN;
  const int col = (warp % kWarpsN) * 8 * kNT + 4 * (lane >> 2);
  const int t = lane & 3;
  const uint32_t* w_s = reinterpret_cast<const uint32_t*>(buf) + col;
  // lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of an m16 tile and, for
  // int8, plane l / 16 (k slots 16..31 of the m16n8k32 fragment are the
  // high plane), for bf16 k 8 (l / 16)..+7 of a plane's 16-k chunk
  const uint32_t x_s = smem_u32(buf + kWBytes) + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kXS +
                       (kInt8 ? x_plane(true) : 16) * (lane >> 4);
  constexpr int kChunks = kStageRows / 8;   // per K warp
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int ch = kChunks * wk + cc;
    if (4 * ch >= rows) break;               // warp-uniform: past K
    if constexpr (kInt8) {
      // thread t: word row 4 ch + t, whose low plane is k = 16 ch + 4t + b
      const uint4 wv = *reinterpret_cast<const uint4*>(w_s + (4 * ch + t) * kWStride);
      uint32_t xa[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(xa[mi], x_s + 16 * mi * kXS + 16 * ch);
      const uint32_t wj[kNT] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t lo = ((wj[j] << 4) & 0xF0F0F0F0u) ^ 0x80808080u;   // 16 (q - 8)
        const uint32_t hi = (wj[j] & 0xF0F0F0F0u) ^ 0x80808080u;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][j], xa[mi], lo, hi);
      }
    } else {
      // thread t takes k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of a chunk's
      // 16: bytes 2 (t & 1) + {0, 1} of word rows t / 2 and 2 + t / 2
      const uint4 wa = *reinterpret_cast<const uint4*>(w_s + (4 * ch + (t >> 1)) * kWStride);
      const uint4 wb = *reinterpret_cast<const uint4*>(w_s + (4 * ch + 2 + (t >> 1)) * kWStride);
      uint32_t xl[MT][4], xh[MT][4];         // A fragments of the low and high plane
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        ldmatrix_x4(xl[mi], x_s + 16 * mi * kXS + 32 * ch);
        ldmatrix_x4(xh[mi], x_s + 16 * mi * kXS + x_plane(false) + 32 * ch);
      }
      const uint32_t sel = 0x4140u + 0x0202u * (t & 1);   // bytes 2h, 2h+1 -> 0, 2
      const uint32_t wva[kNT] = {wa.x, wa.y, wa.z, wa.w};
      const uint32_t wvb[kNT] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t pa = __byte_perm(wva[j], 0u, sel);
        const uint32_t pb = __byte_perm(wvb[j], 0u, sel);
        const uint32_t bl0 = bf16_pair_q8(pa), bl1 = bf16_pair_q8(pb);
        const uint32_t bh0 = bf16_pair_q8(pa >> 4), bh1 = bf16_pair_q8(pb >> 4);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][j], xl[mi], bl0, bl1);
          mma_bf16(acc[mi][j], xh[mi], bh0, bh1);
        }
      }
    }
  }
}

// out[m, n..n+3] from the sums v (w4a16: v * s[n]; w4a4: (f32(v) * sx[m]) *
// s[n], as the plain version rounds them), columns past N skipped
template <bool kInt8, bool kVec, typename V>
__device__ __forceinline__ void store4(const Args& a, int m, int n, const V (&v)[4]) {
  if (n >= a.N) return;
  const size_t i = (size_t)m * a.N + n;
  float f[4];
  if (kVec) {
    const float4 s = *reinterpret_cast<const float4*>(a.s + n);
    const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = kInt8 ? (static_cast<float>(v[e]) * a.sx[m]) * sc[e]
                                             : static_cast<float>(v[e]) * sc[e];
    if (!kInt8 && a.out_f32) {
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
      const float fe = kInt8 ? (static_cast<float>(v[e]) * a.sx[m]) * a.s[n + e]
                             : static_cast<float>(v[e]) * a.s[n + e];
      if (!kInt8 && a.out_f32) {
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
template <bool kInt8, int MT, bool kVec, typename V>
__device__ __forceinline__ void store_tile(const Args& a, int m0, int n0,
                                           const V (&v)[MT][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (threadIdx.x >> 5) % kWarpsN * 8 * kNT + 8 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * mi + (lane >> 2) + 8 * h;
      if (m >= a.M) continue;
      const V lo[4] = {v[mi][0][2 * h], v[mi][1][2 * h], v[mi][2][2 * h], v[mi][3][2 * h]};
      const V hi[4] = {v[mi][0][2 * h + 1], v[mi][1][2 * h + 1], v[mi][2][2 * h + 1],
                       v[mi][3][2 * h + 1]};
      store4<kInt8, kVec>(a, m, n, lo);
      store4<kInt8, kVec>(a, m, n + 4, hi);
    }
}

// stripe s: its segments' sums from the workspace, added in block order
// (run p_lo's slot is its last segment unless its run begins at the
// stripe; every later run begins inside the stripe: its first slot), then
// the epilogue. Split mode only (M <= 64, m0 = 0).
template <bool kInt8, bool kVec>
__device__ void fold_stripe(const Args& a, int s) {
  using Acc = typename AccOf<kInt8>::T;
  const int T = a.stages;
  const int p_lo = run_of(a, s * T);
  const int p_hi = run_of(a, (s + 1) * T - 1);
  const int slot_lo = 2 * p_lo + (run_start(a, p_lo) != s * T);
  const size_t plane = (size_t)a.M * kBN;
  const Acc* ws = static_cast<const Acc*>(a.ws);
  for (int idx = threadIdx.x; idx < a.M * (kBN / 4); idx += kThreads) {
    const int row = idx / (kBN / 4);
    const int c = (idx % (kBN / 4)) * 4;
    if (s * kBN + c >= a.N) continue;
    const size_t off = (size_t)row * kBN + c;
    using V = typename AccOf<kInt8>::V;
    const V u = __ldcg(reinterpret_cast<const V*>(ws + slot_lo * plane + off));
    Acc v[4] = {u.x, u.y, u.z, u.w};
    // the later runs' first slots, four loads in flight, added in order
    int p = p_lo + 1;
    for (; p + 3 <= p_hi; p += 4) {
      V q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = __ldcg(reinterpret_cast<const V*>(ws + 2 * (p + i) * plane + off));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[0] += q[i].x, v[1] += q[i].y, v[2] += q[i].z, v[3] += q[i].w;
    }
    for (; p <= p_hi; ++p) {
      const V q = __ldcg(reinterpret_cast<const V*>(ws + 2 * p * plane + off));
      v[0] += q.x, v[1] += q.y, v[2] += q.z, v[3] += q.w;
    }
    store4<kInt8, kVec>(a, row, s * kBN + c, v);
  }
}

template <bool kInt8, int MT, bool kVec, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1) w4_kernel(const Args a) {
  using Acc = typename AccOf<kInt8>::T;
  constexpr bool kCuts = kWhole && !kInt8;   // whole mode, w4a16: segments at the runs' cuts
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
  constexpr int sbytes = stage_bytes(kInt8, MT);
  constexpr int kStages = ring_stages(kInt8, MT);
  const uint32_t ring = smem_u32(smem);
  // the upper K warps' sums, thread-major so each lane of a lower warp
  // reads back its twin's values
  Acc* red = reinterpret_cast<Acc*>(smem + kStages * sbytes) + (warp % kWarpsN) * 32 + lane;
  const Loader<kInt8, MT, kVec> loader;
  if (threadIdx.x == 0) n_folds = 0;
  // launched before the previous kernel of the stream ends: wait for it (and
  // its memory) before the first access; the next kernel may launch once
  // every block of this one runs
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  Acc acc[MT][kNT][4];
  float total[kCuts ? MT : 1][kNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0;

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
  int s = u0 / T, st = u0 - s * T;           // the unit computed next
  int seg0 = u0;                                            // the open segment's first unit
  int cut = kCuts ? run_start(a, run_of(a, u0) + 1) : u1;  // where it must end
  for (int i = 0; i < n_units; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of unit i are in
    __syncthreads();                // everyone's are, and unit i-1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n_units) {
      loader.load(a, ring + (nx % kStages) * sbytes, ls, lst, m0);
      if (++lst == T) lst = 0, ++ls;
    }
    cp_async_commit();
    compute_stage<kInt8, MT>(smem + (i % kStages) * sbytes,
                             min(kStageRows, a.K / 8 - st * kStageRows), acc);
    const int nu = u0 + i + 1;
    const bool stripe_end = ++st == T;
    const int sc = s;                        // the stripe of this unit
    if (stripe_end) st = 0, ++s;
    if (!stripe_end && nu != u1 && nu != cut) continue;

    // the segment [seg0, nu) ends: lower + upper K warp, in the lower
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Acc* r = red + ((mi * kNT + j) * 4 + e) * (kThreads / 2);
          if (wk == 1) *r = acc[mi][j][e];
        }
    __syncthreads();
    const bool whole = seg0 == sc * T && stripe_end;
    if (wk == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            Acc v = acc[mi][j][e] + red[((mi * kNT + j) * 4 + e) * (kThreads / 2)];
            if constexpr (kInt8) v >>= 4;   // the B bytes were 16 (q - 8): exact
            acc[mi][j][e] = v;
          }
      if (kWhole) {
        if constexpr (kCuts) {
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                total[mi][j][e] = seg0 == u0 ? acc[mi][j][e] : total[mi][j][e] + acc[mi][j][e];
          if (stripe_end) store_tile<kInt8, MT, kVec>(a, m0, sc * kBN, total);
        } else {
          store_tile<kInt8, MT, kVec>(a, m0, sc * kBN, acc);
        }
      } else if (whole) {
        store_tile<kInt8, MT, kVec>(a, m0, sc * kBN, acc);
      } else {
        // slot 2p: the run's first segment, 2p + 1: its last
        Acc* ws = static_cast<Acc*>(a.ws) +
                  (size_t)(2 * blockIdx.x + (seg0 != u0)) * a.M * kBN +
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
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;
    seg0 = nu;
    if (kCuts && nu == cut) cut = run_start(a, run_of(a, nu) + 1);
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
  for (int f = 0; f < nf; ++f) fold_stripe<kInt8, kVec>(a, folds[f]);
  if (threadIdx.x == 0) {
    for (int f = 0; f < nf; ++f) a.counters[folds[f]] = 0;
  }
}

template <bool kInt8, int MT, bool kVec, bool kWhole>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int smem = smem_bytes(kInt8, MT);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4_kernel<kInt8, MT, kVec, kWhole>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, w4_kernel<kInt8, MT, kVec, kWhole>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8, bool kVec>
int launch_m(const Args& a, cudaStream_t stream) {
  if (a.M > 16 * kMaxTiles) {
    return launch<kInt8, kMaxTiles, kVec, true>(a, a.stripes * a.m_blocks, stream);
  }
  switch ((a.M + 15) / 16) {
    case 1: return launch<kInt8, 1, kVec, false>(a, a.workers, stream);
    case 2: return launch<kInt8, 2, kVec, false>(a, a.workers, stream);
    case 3: return launch<kInt8, 3, kVec, false>(a, a.workers, stream);
    default: return launch<kInt8, 4, kVec, false>(a, a.workers, stream);
  }
}

template <bool kInt8>
int run(Args a, cudaStream_t stream) {
  a.stages = (a.K + 8 * kStageRows - 1) / (8 * kStageRows);
  a.stripes = (a.N + kBN - 1) / kBN;
  a.m_blocks = (a.M + 16 * kMaxTiles - 1) / (16 * kMaxTiles);
  return a.N % 4 == 0 ? launch_m<kInt8, true>(a, stream) : launch_m<kInt8, false>(a, stream);
}

}  // namespace

// x bf16 [M, K], w int32 [K/8, N], s f32 [N], out [M, N] (bf16, or f32 when
// out_f32). M <= 64: ws f32 [2 workers, M, 128] and counters int32, one per
// 128-column stripe, all 0; workers = min(SMs, ceil(N / 128) ceil(K / 256))
// (ops/linear_kernels.py w4_workers). K % 32 == 0, K < 2^17; pointers
// 16-byte aligned.
extern "C" int qspec_w4a16(const void* x, const void* w, const void* s, void* out, void* ws,
                           void* counters, int M, int K, int N, int workers, int out_f32,
                           void* stream) {
  Args a{x, nullptr, static_cast<const uint32_t*>(w), static_cast<const float*>(s), out, ws,
         static_cast<int*>(counters), M, K, N, 0, 0, workers, 0, out_f32};
  return run<false>(a, static_cast<cudaStream_t>(stream));
}

// xq int8 [M, K], sx f32 [M], w int32 [K/8, N], sw f32 [N], out bf16 [M, N];
// ws int32 [2 workers, M, 128] and counters as for qspec_w4a16.
extern "C" int qspec_w4a4(const void* xq, const void* sx, const void* w, const void* sw,
                          void* out, void* ws, void* counters, int M, int K, int N, int workers,
                          void* stream) {
  Args a{xq, static_cast<const float*>(sx), static_cast<const uint32_t*>(w),
         static_cast<const float*>(sw), out, ws, static_cast<int*>(counters), M, K, N, 0, 0,
         workers, 0, 0};
  return run<true>(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* qspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
