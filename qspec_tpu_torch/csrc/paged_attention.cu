// Paged attention for Hopper: decode (Q=1), QSpec verify (Q=k+1), the draft's
// Q=2 backfill step, chunked prefill and the Medusa tree verify, over the
// paged KV cache with bf16, int8, fp8_e4m3 or fp8_e5m2 entries.
//
// Replaces the TPU kernel qspec_tpu/ops/attention_pallas.py:_paged_attn_kernel
// (entry paged_attention_pallas), its causal core, its sliding window, its
// logit softcap, its ALiBi bias, its 8-bit KV option, its Medusa tree mask and
// head dims 128 and 256 (a template parameter): flash attention with an online
// softmax over the sequence's live pages, GQA rows G = (Hq / Hkv) * Q per kv
// head (Q minor), a causal mask by absolute position (query i of row b sits
// at q_start[b] + i) and, under a window W, the mask q_pos - W < kv_pos <= q_pos.
//
// Layouts (D = kD, 128 or 256): q [B, Q, Hq, D] bf16; the layer's cache
// [P, 2, Hkv, S, D] of entries T (K at index 0, V at 1; page 0 is the null
// page); for int8 and fp8_e4m3 the layer's scales [P, 2, Hkv, S] f32, one
// per (k/v, head, token); block_tables [B, PPS] int32; ctx_lens [B] int32
// (tokens including the new ones); out like q.
//
// Numerics, the Pallas body's: q is multiplied by the softmax scale in f32
// and rounded to bf16 once; K and V entries are widened to bf16 exactly
// (int8, e4m3 and e5m2 all are exact in bf16); the scores accumulate in f32
// on the tensor cores and K's per-token scale multiplies them; p, times V's
// per-token scale for int8 and fp8_e4m3, is rounded to bf16 for P.V, which
// accumulates in f32 (the softmax sum takes the unscaled f32 p); fp8_e5m2 is
// a bare cast.
//
// The logit softcap (a launch argument, 0 = none; Gemma-2's
// attn_logit_softcapping), s = tanhf(s * (1 / cap)) * cap on the f32 score,
// in the Pallas body's order: after the query scale and K's per-token scale,
// before the causal / window mask. A capped launch takes instantiations of
// its own, so the uncapped ones carry no cap code.
//
// What bounds it on the H100: every live K/V byte is read once per
// (sequence, kv head, tile of 16 GQA rows) and used for 4 operations per
// element per row, so at decode and verify widths (G = 1..64 rows) it is
// bound by device-memory bytes; at prefill (G in the thousands) by
// operations. 8-bit entries halve the bytes.
//
// What the design does about that:
// - Tensor cores. mma.sync m16n8k16 (bf16 in, f32 accumulate) for both
//   products, the 16 GQA rows of a block on M: S = Q.K^T takes K as the B
//   operand (ldmatrix of the token rows), P.V takes the S accumulators as
//   its A fragments in registers and V by ldmatrix.trans. Rows on M, not N:
//   the softmax then runs on the accumulator fragments with quad shuffles and
//   P needs no trip through shared memory; the rows a decode leaves empty
//   (G = 4 of 16) cost tensor-core cycles, which this bytes-bound regime
//   has to spare, not bytes.
// - The sequence split over blocks in a fixed order. A split is
//   split_tokens = S * ceil(256 / S) tokens by absolute position; token t
//   belongs to split t / split_tokens whatever the batch, Q or the card.
//   Within a block, warp w takes the 16-token slices that start at 16w mod
//   64, each keeping its own online softmax; a split's partial state (m, l,
//   the f32 P.V sum) is the fold of the four warps' in warp order, and the
//   row's result the fold of its splits in ascending order, each fold the
//   one function fold_ml / fold_o below (no contraction: one rounding per
//   product and per sum). Which block computes which split is a schedule the wrapper picks
//   from the shapes (ops/attention_cuda.py:attention_plan): one split a block
//   while a launch has at most 4 row tiles (decode, verify, the tree), so B x
//   Hkv x splits blocks fill the card; every split of a tile in one block at
//   prefill, where the row tiles fill it. The folds are the same in both, so
//   the schedule changes no bit. With one split a block, the blocks of a tile
//   whose live tokens span more than one split write their states to an f32
//   workspace, and a second, small kernel (paged_attention_merge_kernel,
//   a programmatic dependent launch, so its launch overlaps the attention
//   kernel's last blocks) folds them, each thread one float4 of a row with
//   its loads of several splits in flight; a tile whose live tokens lie in one split
//   writes its rows directly. Blocks whose split is wholly before the
//   window's first page or past the tile's last token exit at once, so both
//   grids follow from shapes alone (no read of ctx_lens on the host) and the
//   launch is graph-safe.
// - A cp.async ring. Each warp copies its slices (16 tokens of K and of V in
//   the cache's own entry type, and their scales) into a ring of its own and
//   issues the next one before computing on the current one: 2 stages at
//   D = 128, so 52-68 KB a block and three blocks (12 warps) an SM (two
//   for the tree's, which need more registers), 3 at
//   D = 256 (216 KB bf16, 150-154 KB 8-bit: one block an SM). 8-bit K is
//   widened to bf16 in registers, straight into the B fragments: a lane's 16
//   bytes of a token row are its fragments of 4 k-steps, the query's dims
//   permuted to match once per block; 8-bit V is widened into a per-warp
//   bf16 tile, which P.V reads by ldmatrix.trans.
// - Few instructions a slice, since with so few warps the slice's chain of
//   dependent instructions, not the bytes, sets the pace: a slice that all
//   the warp's rows see whole skips the mask, one that moves no row's
//   maximum skips the rescale of the P.V sums (a product by 1), and the
//   exponential is the fast one, exact 1 at 0.
// - Row independence. A token's split and warp follow from its position
//   only; masked tokens contribute exact zeros (p = 0, and a slice with no
//   live token leaves m, l and the sum unchanged); an empty split folds as
//   (-1e30, 0, 0), which leaves the state unchanged; the mma computes each
//   row from its own A row. So a row's bits do not depend on Q, on the other
//   rows, on its place in the batch, on how far its tile walks or on the
//   schedule. Rows with ctx_len == 0 (padding) read nothing and write zeros.
//
// The sliding window (a launch argument: it may differ per layer; 1 << 30
// means none): a tile starts its walk at the row's first in-window page,
// clamp((q_start - W + 1) / S, 0, n_pages - 1) as the Pallas kernel does,
// so a decode reads about W / S pages however long the context. The start
// and each warp's tokens follow from logical positions only, so a ring of
// recycled pages and a full pool walk the same tokens in the same order and
// give the same bits; pages before the start, which in a ring hold newer
// tokens of the same row, are never read.
//
// The Medusa tree mask (a template flag: the instantiations without it carry
// no tree code at all), with the Pallas body's semantics: the rectangle is
// [prefix rows | T tree rows]; prefix row i sits at q_start + i, the last of
// them (row prefix-1) is the root, and tree node t is stored at slot
// root + 1 + t. A tree row takes the root as its causal bound and its own AR
// position root + d as the window's reference (d = its depth = the popcount
// of its ancestor word, which holds the node itself), and also sees the slots
// of its ancestors and itself: live = (kv <= root && kv > root + d - W) ||
// anc[node] bit (kv - root - 1). (The Pallas body takes the root as the
// window's reference too, which is not AR's mask; the walk's first page,
// from row 0's position, still covers every row, since root + d - W + 1 >
// q_start - W.) The ancestor sets are one 64-bit word per node (bit j: node j
// is an ancestor of the node or the node itself), built once per tree
// (ops/attention.py:tree_mask) and kept on the device, so a tree has at most
// 64 nodes. Each lane holds its two rows' words in registers.
//
// ALiBi (a template flag, instantiated only where the JAX package reaches it:
// head dim 128, no softcap, no tree; BLOOM, MPT), with the Pallas body's
// semantics: score += slope[hq] * (kv_pos - q_pos) in f32 after K's scale and
// before the mask, hq the query head of the row (h * group + r / Q). The
// slopes are one [Hq] f32 array per model, read once per lane and row; the
// bias of a masked token is never used, and padded rows (r >= G) carry slope 0
// and see nothing, as without it.
//
// Multi-head latent attention (MLA: DeepSeek-V2 / V2-Lite / V3, MiniCPM3)
// takes a kernel of its own, paged_attention_mla_kernel below, designed for
// Hopper, at the latent head dims 384 and 640 (kv_lora_rank +
// qk_rope_head_dim rounded up to 128), over all four entry types: the same
// causal function, MQA over one latent KV row per token, with query groups of
// 16, 40 or 128 heads and no window, softcap, ALiBi or tree (the JAX package
// passes none of them there). Only the lanes the function needs are read:
// K's first k_dims (r + dr: 576, 288) and V's first v_dims (r: 512, 256) of
// each stored row; the output's lanes past v_dims are written as zeros.
// What bounds it: a sequence's latent rows serve all G = heads x Q query
// rows, so at DeepSeek-V3's 128 heads over a long context it is bound by the
// tensor cores' operations (2 G (dk + dv) a token), at 16 or 40 heads by the
// rows' bytes. What its design does about that:
// - wgmma over 64-row query tiles. A block takes 64 GQA rows, so a
//   sequence's latent rows are read G / 64 times, not G / 16. S = Q.K^T is a
//   wgmma with the query tile (bf16, 128-byte swizzled [64-lane chunk][64
//   rows][64]) as A and the step's K rows as B; P.V a wgmma with P (bf16 [64
//   rows][tokens], swizzled) as A and the step's V rows as B, read with the
//   transpose bit. Every G and Q, decode's 16 rows too, takes this one path.
// - Two warpgroups a block and nothing else: each takes half of a step's
//   tokens in S and half of V's lanes in P.V (64 x 256 f32 accumulators, 128
//   registers of the up to 255 a thread keeps; a third warp on an SM
//   sub-partition would cap a thread at 168, and spill far more). The two exchange
//   their rows' maxima through shared memory, write their halves of P, and
//   add their halves of the row sums at the end of a split.
// - A TMA ring. The layer's cache is one 2-D tensor map [P * 2 * Hkv * S
//   rows, D], encoded on the host at each launch (so a CUDA graph captures
//   it); a copy is one (64-lane chunk, gcd(S, step) tokens) box, completion
//   counted on the stage's mbarrier. Thread 0 keeps the ring's stages full,
//   kRing steps ahead of the walk, refilling a stage once a block barrier
//   shows every warpgroup past the wgmmas that read it; the block's page ids
//   wait in shared memory. bf16 lands straight in the 128-byte swizzle
//   wgmma reads; 8-bit entries land raw and the block widens them exactly
//   into bf16 stages.
// - V from the K plane where its bits are the same: MLA writes V's first r
//   lanes as the c_kv that leads K's row (update_layer), and over bf16 and
//   fp8_e5m2 the stored bits are equal (a cast with no scale), so those
//   kinds read no V plane: P.V's B is the K stage's first v_dims lanes, and
//   the bytes are K's alone. int8 and fp8_e4m3 take a per-row absmax scale,
//   and K's row also holds k_pe, so there V comes from its own plane.
// - Shared memory, the budget (MlaSmem): at D = 640 the query tile 72 KB, P
//   8 KB, and 2 stages of 64 tokens (72 KB each) at bf16, 4 raw stages of 32
//   tokens (18 KB) and 2 widened (36 KB) at fp8_e5m2, 2 raw (35 KB) and 1
//   widened (69 KB) at int8 / fp8_e4m3: 221-226 KB; at D = 384 the query tile
//   40 KB, P 8 KB, 3 stages of 64 tokens (40 KB) at bf16, 2 raw (20 KB) and
//   2 widened (40 KB) at fp8_e5m2, 2 raw (19 KB) and 2 widened (37 KB) of 32
//   tokens at int8 / fp8_e4m3: 162-170 KB. One block an SM.
// - Flash-decoding splits of 128 tokens fill the SMs when B x tiles is
//   small. A block takes one split and the merge kernel folds a tile's
//   splits; where the row tiles fill the card (prefill), or those split
//   states would pass 256 MB, a block walks all its splits and folds them
//   itself through f32 slabs of its own in device memory
//   (ops/attention_cuda.py:attention_plan).
// The numerics are the kernel above's: q scaled and rounded to bf16 once,
// f32 scores times K's scale, p times V's scale rounded to bf16 for P.V, the
// row sum the unrounded p (each warpgroup sums its tokens; the halves added
// in order), the steps at fixed positions (multiples of the step), the
// splits at fixed positions folded in ascending order by fold_ml / fold_o,
// in the block or by the merge kernel, and a row's result O times the
// reciprocal of its sum, in both. So a row's bits depend on no other row, on
// Q, on the schedule or on its place in the batch.
//
// The file is compiled once per KV entry type, with -DQSPEC_ATTN_KV=k (0
// bf16, 1 int8, 2 fp8_e4m3, 3 fp8_e5m2), so that the four objects build in
// parallel (_build.py): object k holds that type's instantiations behind
// qspec_paged_attention_kv<k>, and object 0 also the entry point, which picks
// the object by the entry type; and once per latent head dim, with
// -DQSPEC_ATTN_MLA=384 or 640: that dim's MLA instantiations over the four
// entry types, behind qspec_paged_attention_mla<dim>.

#if defined(QSPEC_ATTN_KV) == defined(QSPEC_ATTN_MLA)
#error "compile with -DQSPEC_ATTN_KV=0, 1, 2 or 3, or with -DQSPEC_ATTN_MLA=384 or 640"
#endif

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                 // GQA rows per block: one m16 tile
constexpr int kSlice = 16;                // tokens per warp slice: the k16 of P.V
constexpr int kStep = kWarps * kSlice;    // tokens per block step
// the per-warp cp.async ring: 2 stages at D = 128, so three blocks share an
// SM (12 warps to hide each other's latency), 3 at D = 256 (one block an SM)
template <int kD>
constexpr int kStages = kD == 128 ? 2 : 3;
constexpr int kMaxSplitPages = 16;        // pages a split spans: 256 / 16 at most
constexpr float kNegInf = -1e30f;

// the shared memory of one block; the warps' P.V dump for the fold aliases
// the ring, which is drained first
template <typename T, int kD, bool kScaled>
struct Smem {
  static constexpr bool kWide = sizeof(T) == 1;   // 8-bit entries, widened
  static constexpr int kTile = kSlice * kD * (int)sizeof(T);   // K or V slice as stored
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = kWarps * kStages<kD> * kStage;
  static constexpr int kWideTile = kSlice * kD * 2;            // a widened slice
  static constexpr int kWideAll = kWide ? kWarps * kWideTile : 0;   // V only
  static constexpr int kScl = kScaled ? kWarps * kStages<kD> * 2 * kSlice * 4 : 0;
  static constexpr int kDumpStride = kD + 8;   // floats: conflict-free float2 stores
  static constexpr int kDumpO = kWarps * kRows * kDumpStride * 4;
  static constexpr int kDump = kDumpO + 2 * kWarps * kRows * 4;
  static constexpr int kPipe = kRing + kWideAll + kScl;
  static constexpr int kUnion = kPipe > kDump ? kPipe : kDump;
  static constexpr int kOffWide = kRing;
  static constexpr int kOffScl = kRing + kWideAll;
  static constexpr int kOffQ = kUnion;                       // bf16 [16][kD], swizzled
  // the running fold's O: in registers at D = 128, f32 [16][kD] here at 256
  static constexpr int kOffFold = kOffQ + kRows * kD * 2;
  static constexpr int kBytes = kOffFold + (kD == 128 ? 0 : kRows * kD * 4);
};

struct Params {
  const __nv_bfloat16* q;
  const void* kv;
  const float* kv_scales;
  const int* block_tables;
  const int* ctx_lens;
  // row 0's position of each sequence, read in place: q_pos[b * q_pos_stride]
  // (int32, or int64 when q_pos_i64) less q_pos_col, or ctx_len - Q when
  // q_pos is null
  const void* q_pos;
  int q_pos_stride, q_pos_i64, q_pos_col;
  __nv_bfloat16* out;
  float* ws_o;          // [B * Hkv, n_splits, G, kD] f32 (split states), or null
  float* ws_ml;         // [B * Hkv, n_splits, G, 2] f32 (m, l), or null
  int Q, Hq, Hkv, S, pps;
  int dk, dv;           // the MLA kernel's lanes of K and of V read (kD elsewhere)
  int split, n_splits, spb;   // tokens a split, splits, splits a block
  float scale, softcap;
  int window;
  const unsigned long long* tree_anc;
  int tree_prefix;
  const float* alibi;
  int tile_rows;        // GQA rows a block: 16 here, 64 or 128 in the MLA kernel
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes, zero-filled past `src_bytes` (0: the source is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of row r in a bf16 tile of kD columns; the
// XOR spreads the 8 rows an ldmatrix reads over all banks
template <int kD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * kD * 2 + ((c ^ (r & 7)) << 4);
}

// two floats that bf16 holds exactly (their low 16 bits are zero), packed by
// one byte permute instead of a conversion
__device__ __forceinline__ uint32_t pack_exact_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// four 8-bit entries (one word) widened exactly to two bf16 pairs
__device__ __forceinline__ void widen4(int8_t, uint32_t w, uint32_t& lo, uint32_t& hi) {
  // x + 128 as the low byte of 2^23 + (x + 128), less 2^23 + 128: exact
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)), 8388736.f);
  lo = pack_exact_bf16x2(f[0], f[1]);
  hi = pack_exact_bf16x2(f[2], f[3]);
}
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t pair, __nv_fp8_interpretation_t k) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair), k);
  const float2 f = __half22float2(__half2(hr));
  return pack_exact_bf16x2(f.x, f.y);
}
__device__ __forceinline__ void widen4(__nv_fp8_e4m3, uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = fp8x2_to_bf16x2(w & 0xFFFFu, __NV_E4M3);
  hi = fp8x2_to_bf16x2(w >> 16, __NV_E4M3);
}
__device__ __forceinline__ void widen4(__nv_fp8_e5m2, uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = fp8x2_to_bf16x2(w & 0xFFFFu, __NV_E5M2);
  hi = fp8x2_to_bf16x2(w >> 16, __NV_E5M2);
}

// e^(a - b) for a <= b: the fast exponential, exact 1 at a == b (so a step
// that moves no maximum rescales by exactly 1) and 0 far below
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == b ? 1.f : __expf(a - b);
}

// the one fold of a softmax state (m, l, o) into (M, L, O), used for the
// warps of a split and for the splits of a row alike, every product and sum
// rounded once (no contraction), so its bits do not depend on where it runs
__device__ __forceinline__ void fold_ml(float& M, float& L, float m, float l, float& a,
                                        float& b) {
  const float mn = fmaxf(M, m);
  a = exp_diff(M, mn);
  b = exp_diff(m, mn);
  L = __fadd_rn(__fmul_rn(L, a), __fmul_rn(l, b));
  M = mn;
}
__device__ __forceinline__ float fold_o(float O, float o, float a, float b) {
  return __fadd_rn(__fmul_rn(O, a), __fmul_rn(o, b));
}

// a row tile's walk [first_tok, n_tok) and its live splits [fs, ls] (none
// when ls < fs): up to the tile's last query, from the first in-window page
// of the row's first query (page 0 without a window). The attention kernel
// and the merge kernel both take it from here.
struct Walk {
  int ctx, qs, first_tok, n_tok, fs, ls;
};
__device__ __forceinline__ Walk tile_walk(const Params& p, int b, int row0, int rows) {
  Walk w;
  w.ctx = p.ctx_lens[b];
  if (p.q_pos == nullptr) {
    w.qs = w.ctx - p.Q;
  } else {
    const size_t i = (size_t)b * p.q_pos_stride;
    w.qs = (p.q_pos_i64 ? static_cast<int>(static_cast<const long long*>(p.q_pos)[i])
                        : static_cast<const int*>(p.q_pos)[i]) - p.q_pos_col;
  }
  int max_qi = 0;
  if (rows >= p.Q) {
    max_qi = p.Q - 1;
  } else {
    for (int r = row0; r < row0 + rows; ++r) max_qi = max(max_qi, r % p.Q);
  }
  w.n_tok = min(w.ctx, min(w.qs + max_qi + 1, p.pps * p.S));
  const int n_pages = max(1, (w.ctx + p.S - 1) / p.S);
  const int w_first = w.qs - p.window + 1;
  w.first_tok = min(w_first > 0 ? w_first / p.S : 0, n_pages - 1) * p.S;
  w.fs = w.first_tok / p.split;
  w.ls = w.n_tok > w.first_tok ? (w.n_tok - 1) / p.split : w.fs - 1;
  return w;
}

// T: the cache's entry type; kScaled: per-token scales (int8, fp8_e4m3);
// kD: the head dim; kCap: the logit softcap; kTree: the Medusa tree mask
// (tree_anc / tree_prefix are read only when it is set); kAlibi: the ALiBi
// bias (alibi, [Hq] f32 slopes, read only when it is set)
template <typename T, bool kScaled, int kD, bool kCap, bool kTree, bool kAlibi>
// three blocks an SM at D = 128 (168 registers); the tree's, whose ancestor
// words and window references would spill there, two
__global__ void __launch_bounds__(kThreads, kD == 128 ? (kTree ? 2 : 3) : 1)
paged_attention_kernel(const Params p) {
  using L = Smem<T, kD, kScaled>;
  constexpr int kPer = kD / 8;            // fold / output dims per thread
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int bh = blockIdx.z;
  const int b = bh / p.Hkv;
  const int h = bh % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int G = group * p.Q;
  const int row0 = tile * kRows;
  const int rows = min(kRows, G - row0);
  const int frow = tid >> 3;             // this thread's row in the folds
  const int fd0 = (tid & 7) * kPer;      // and its first dim
  const int sp_lo = blockIdx.y * p.spb;
  const int sp_hi = min(sp_lo + p.spb, p.n_splits);

  // a split's page ids in shared memory: the walk's copies then wait on no
  // read of the block table. The first split's are read before anything
  // else, since they follow from the block's place in the grid alone.
  const int split_pages = p.split / p.S;
  __shared__ int pages_s[kMaxSplitPages];
  auto load_pages = [&](int s) {
    if (tid < split_pages) {
      const int lp = s * split_pages + tid;
      pages_s[tid] = lp < p.pps ? __ldg(p.block_tables + (size_t)b * p.pps + lp) : 0;
    }
  };
  load_pages(sp_lo);
  const Walk wk = tile_walk(p, b, row0, rows);
  const int ctx = wk.ctx, qs = wk.qs, first_tok = wk.first_tok, n_tok = wk.n_tok;
  const int fs = wk.fs, ls = wk.ls;
  const int lo = max(fs, sp_lo);
  const int hi = min(ls + 1, sp_hi);

  auto out_row = [&](int rr) {
    const int r = row0 + rr;
    return p.out + ((size_t)(b * p.Q + r % p.Q) * p.Hq + h * group + r / p.Q) * kD;
  };
  if (lo >= hi) {
    // nothing live in this block's splits; the first block of a tile that
    // sees nothing at all writes its rows' zeros
    if (ls < fs && sp_lo == 0 && frow < rows) {
#pragma unroll
      for (int c = 0; c < kPer; c += 8)
        *reinterpret_cast<uint4*>(out_row(frow) + fd0 + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (lo != sp_lo) load_pages(lo);   // the walk starts past the block's first split
  __syncthreads();                   // the page ids are in

  // per-lane ldmatrix row offsets: Q (A: rows on M), K (B: tokens on N),
  // V (B by .trans: tokens on K)
  const int lm = lane >> 3;
  const int lr = lane & 7;
  unsigned char* q_s = smem + L::kOffQ;
  const uint32_t q_base = smem_u32(q_s);
  const int q_row = lr + 8 * (lm & 1), q_c = lm >> 1;
  const int k_row = lr + 8 * (lm >> 1), k_c = lm & 1;
  const int v_row = lr + 8 * (lm & 1), v_c = lm >> 1;

  const size_t head_stride = (size_t)p.S * kD;
  const size_t page_stride = 2 * (size_t)p.Hkv * head_stride;
  const unsigned char* kv_bytes = static_cast<const unsigned char*>(p.kv);
  constexpr int kSt = kStages<kD>;
  unsigned char* ring = smem + warp * kSt * L::kStage;
  float* scl = reinterpret_cast<float*>(smem + L::kOffScl) + warp * kSt * 2 * kSlice;
  unsigned char* wide = smem + L::kOffWide + warp * L::kWideTile;
  constexpr int kCpr = kD * (int)sizeof(T) / 16;   // 16-byte chunks per token row
  int page0 = lo * split_pages;                    // the logical page of pages_s[0]
  // byte offset of chunk c of token row t in an 8-bit ring tile: the XOR
  // keeps the K fragment reads (rows t and t + 1 at once) off each other's banks
  auto ring8 = [](int t, int c) { return t * kD + ((c ^ ((t & 1) << 2)) << 4); };

  // one slice's copies (16 tokens at t0, within one page) into stage st
  auto issue = [&](int st, int t0) {
    const int page = pages_s[t0 / p.S - page0];
    const int off = t0 % p.S;
    const unsigned char* kb = kv_bytes + ((size_t)page * page_stride + h * head_stride +
                                          (size_t)off * kD) * sizeof(T);
    const unsigned char* vb = kb + (size_t)p.Hkv * head_stride * sizeof(T);
    const uint32_t kd = smem_u32(ring + st * L::kStage);
    const uint32_t vd = kd + L::kTile;
#pragma unroll
    for (int it = 0; it < kSlice * kCpr / 32; ++it) {
      const int idx = it * 32 + lane;
      const int tok = idx / kCpr;
      const int c = idx % kCpr;
      const int n = t0 + tok < ctx ? 16 : 0;   // zeros past ctx_len, never read
      const int so = tok * kD * (int)sizeof(T) + c * 16;
      const int dofs = L::kWide ? ring8(tok, c) : swz<kD>(tok, c);
      cp_async16(kd + dofs, kb + so, n);
      cp_async16(vd + dofs, vb + so, n);
    }
    if (kScaled && lane < 8) {
      const int sel = lane >> 2;     // 0: K's scales, 1: V's
      const int c = lane & 3;        // 4 tokens each
      const float* src = p.kv_scales + (size_t)page * 2 * p.Hkv * p.S +
                         (size_t)sel * p.Hkv * p.S + (size_t)h * p.S + off + 4 * c;
      const int n = 4 * min(4, max(0, ctx - (t0 + 4 * c)));
      cp_async16(smem_u32(scl + (st * 2 + sel) * kSlice + 4 * c), src, n);
    }
  };
  // this warp's slices of split s (t0 = t_begin + 64 i, i < n_sl), and the
  // first kSt - 1 of them issued
  int t_begin = 0, n_sl = 0;
  auto start_split = [&](int s) {
    const int t_lo = max(s * p.split, first_tok);
    const int t_hi = min((s + 1) * p.split, n_tok);
    t_begin = (t_lo / kStep) * kStep + warp * kSlice;
    if (t_begin < t_lo) t_begin += kStep;
    n_sl = t_begin < t_hi ? (t_hi - t_begin + kStep - 1) / kStep : 0;
#pragma unroll
    for (int i = 0; i < kSt - 1; ++i) {
      if (i < n_sl) issue(i, t_begin + i * kStep);
      cp_async_commit();
    }
  };
  start_split(lo);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the query tile, times the scale, rounded to bf16 once (its reads, and
  // those of the rows' tree words and slopes below, overlap the first
  // slices' copies)
#pragma unroll
  for (int idx = tid; idx < kRows * (kD / 8); idx += kThreads) {
    const int rr = idx / (kD / 8);
    const int c = idx % (kD / 8);
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (rr < rows) {
      const int r = row0 + rr;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          p.q + ((size_t)(b * p.Q + r % p.Q) * p.Hq + h * group + r / p.Q) * kD + c * 8));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = pack_bf16x2(__fmul_rn(__bfloat162float(e[2 * i]), p.scale),
                           __fmul_rn(__bfloat162float(e[2 * i + 1]), p.scale));
    }
    if constexpr (L::kWide) {
      // the 8-bit K fragments take dims d0..d0+3 of a 16-byte chunk, d0 =
      // 64 (j / 4) + 16 qd + 4 (j % 4), as k = 2 qd, 2 qd + 1, 2 qd + 8,
      // 2 qd + 9 of k-step j: the query's dims go to those columns
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = c * 8 + i;
        const int j = 4 * (d / 64) + (d % 16) / 4;
        const int kk = 2 * ((d % 64) / 16) + (d % 2) + 8 * ((d % 4) / 2);
        const int col = 16 * j + kk;
        *reinterpret_cast<__nv_bfloat16*>(q_s + swz<kD>(rr, col / 8) + (col % 8) * 2) = v[i];
      }
    } else {
      *reinterpret_cast<uint4*>(q_s + swz<kD>(rr, c)) = packed;
    }
  }
  // this lane's two rows (g and g + 8 of the tile): position, window
  // reference, tree word and slope
  const int g = lane >> 2;
  const int qd = lane & 3;
  int qpos[2], wpos[2];
  bool dead[2];                                // padding rows of the tile (r >= G)
  unsigned long long anc[2];
  float slope[2];
  const int tree_base = qs + p.tree_prefix;   // slot of tree node 0 (root + 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = g + 8 * i;
    const int r = row0 + rr;
    const bool valid = rr < rows;
    dead[i] = !valid;
    qpos[i] = valid ? qs + r % p.Q : -1;     // -1: row never live
    wpos[i] = qpos[i];
    anc[i] = 0ull;
    if (kTree) {
      const int node = r % p.Q - p.tree_prefix;
      if (valid && node >= 0) {
        anc[i] = __ldg(p.tree_anc + node);
        qpos[i] = tree_base - 1;                  // the root bounds a tree row
        wpos[i] = qpos[i] + __popcll(anc[i]);     // its AR position root + depth
      }
    }
    slope[i] = kAlibi && valid ? __ldg(p.alibi + h * group + r / p.Q) : 0.f;
  }
  const float inv_cap = kCap ? 1.f / p.softcap : 0.f;

  // the running state of this thread's fold row (M, L in registers, O in
  // shared memory, this thread's dims only)
  float fold_r[kD == 128 ? kPer : 1];
  float* fold_s = reinterpret_cast<float*>(smem + L::kOffFold) + frow * kD + fd0;
  auto fold_at = [&](int i) -> float& {
    if constexpr (kD == 128) return fold_r[i]; else return fold_s[i];
  };
#pragma unroll
  for (int i = 0; i < kPer; ++i) fold_at(i) = 0.f;
  float fM = kNegInf, fL = 0.f;
  __syncthreads();   // the query tile is in

  for (int s = lo; s < hi; ++s) {
    if (s > lo) {    // a block that takes several splits walks the next
      load_pages(s);
      page0 = s * split_pages;
      __syncthreads();
      start_split(s);
    }
    float o[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    for (int i = 0; i < n_sl; ++i) {
      const int nxt = i + kSt - 1;
      if (nxt < n_sl) issue(nxt % kSt, t_begin + nxt * kStep);
      cp_async_commit();
      cp_async_wait<kSt - 1>();
      __syncwarp();
      const int st = i % kSt;
      const int t0 = t_begin + i * kStep;

      const unsigned char* stage = ring + st * L::kStage;
      uint32_t v_base;
      if constexpr (L::kWide) {
        // widen the stage's V slice into this warp's bf16 tile (P.V reads
        // it by ldmatrix.trans); K is widened in registers below
#pragma unroll
        for (int it = 0; it < kSlice * kCpr / 32; ++it) {
          const int idx = it * 32 + lane;
          const int tok = idx / kCpr;
          const int c = idx % kCpr;
          const uint4 raw = *reinterpret_cast<const uint4*>(stage + L::kTile + ring8(tok, c));
          uint4 w0, w1;
          widen4(T{}, raw.x, w0.x, w0.y);
          widen4(T{}, raw.y, w0.z, w0.w);
          widen4(T{}, raw.z, w1.x, w1.y);
          widen4(T{}, raw.w, w1.z, w1.w);
          *reinterpret_cast<uint4*>(wide + swz<kD>(tok, 2 * c)) = w0;
          *reinterpret_cast<uint4*>(wide + swz<kD>(tok, 2 * c + 1)) = w1;
        }
        v_base = smem_u32(wide);
      } else {
        v_base = smem_u32(stage) + L::kTile;
      }

      // S = Q.K^T: sc[nt] holds rows g, g+8 x tokens 8 nt + 2 qd + {0, 1}
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      if constexpr (L::kWide) {
        // a lane's 16 bytes of its token row hold its B fragments of 4 k-steps
#pragma unroll
        for (int J = 0; J < kD / 64; ++J) {
          uint4 kr[2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            kr[nt] = *reinterpret_cast<const uint4*>(stage + ring8(8 * nt + g, 4 * J + qd));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t a[4];
            ldmatrix_x4(a, q_base + swz<kD>(q_row, 2 * (4 * J + jj) + q_c));
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              uint32_t b0, b1;
              widen4(T{}, reinterpret_cast<const uint32_t*>(&kr[nt])[jj], b0, b1);
              mma_bf16(sc[nt], a, b0, b1);
            }
          }
        }
      } else {
        const uint32_t k_base = smem_u32(stage);
#pragma unroll
        for (int j = 0; j < kD / 16; ++j) {
          uint32_t a[4], bk[4];
          ldmatrix_x4(a, q_base + swz<kD>(q_row, 2 * j + q_c));
          ldmatrix_x4(bk, k_base + swz<kD>(k_row, 2 * j + k_c));
          mma_bf16(sc[0], a, bk[0], bk[1]);
          mma_bf16(sc[1], a, bk[2], bk[3]);
        }
      }

      float ksc[4] = {1.f, 1.f, 1.f, 1.f}, vsc[4] = {1.f, 1.f, 1.f, 1.f};
      if (kScaled) {
        const float* sb = scl + st * 2 * kSlice;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int tok = 8 * (u >> 1) + 2 * qd + (u & 1);
          ksc[u] = sb[tok];
          vsc[u] = sb[kSlice + tok];
        }
      }
      // scale, bias, cap and mask, then this slice's row max. A slice that
      // every live row of the warp sees whole (the common case: below the
      // causal bound, inside the window and ctx_len) skips the mask.
      bool full = t0 + kSlice <= ctx;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int wref = kTree ? wpos[ri] : qpos[ri];
        full = full && (dead[ri] ||
                        (t0 + kSlice - 1 <= qpos[ri] && t0 > wref - p.window));
      }
      bool live[2][4];
      float cm[2] = {kNegInf, kNegInf};
      auto scores = [&](auto masked) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = e >> 1;
            const int kv_pos = t0 + 8 * nt + 2 * qd + (e & 1);
            float s = sc[nt][e];
            if (kScaled) s = __fmul_rn(s, ksc[2 * nt + (e & 1)]);
            if (kAlibi) s = __fmaf_rn(slope[ri], static_cast<float>(kv_pos - qpos[ri]), s);
            if (kCap) s = __fmul_rn(tanhf(__fmul_rn(s, inv_cap)), p.softcap);
            bool lv = true;
            if constexpr (decltype(masked)::value) {
              const int wref = kTree ? wpos[ri] : qpos[ri];
              lv = kv_pos <= qpos[ri] && kv_pos > wref - p.window && kv_pos < ctx;
              if (kTree) {
                // node (kv_pos - root - 1)'s slot, when it is an ancestor or self
                const unsigned t = static_cast<unsigned>(kv_pos - tree_base);
                lv = lv || (t < 64u && ((anc[ri] >> t) & 1ull) && kv_pos < ctx);
              }
            }
            live[nt][e] = lv;
            sc[nt][e] = s;
            if (lv) cm[ri] = fmaxf(cm[ri], s);
          }
        }
      };
      if (__all_sync(0xffffffffu, full)) {
        scores(std::false_type{});
      } else {
        scores(std::true_type{});
      }
      float alpha[2], pf[2][4], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        cm[ri] = fmaxf(cm[ri], __shfl_xor_sync(0xffffffffu, cm[ri], 1));
        cm[ri] = fmaxf(cm[ri], __shfl_xor_sync(0xffffffffu, cm[ri], 2));
        const float m_new = fmaxf(m_run[ri], cm[ri]);
        alpha[ri] = exp_diff(m_run[ri], m_new);
        m_run[ri] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          pf[nt][e] = live[nt][e] ? exp_diff(sc[nt][e], m_run[ri]) : 0.f;
          psum[ri] = __fadd_rn(psum[ri], pf[nt][e]);
        }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        psum[ri] = __fadd_rn(psum[ri], __shfl_xor_sync(0xffffffffu, psum[ri], 1));
        psum[ri] = __fadd_rn(psum[ri], __shfl_xor_sync(0xffffffffu, psum[ri], 2));
        l_run[ri] = __fadd_rn(__fmul_rn(l_run[ri], alpha[ri]), psum[ri]);
      }
      // a slice that moves no row's maximum leaves the sums as they are
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < kD / 8; ++i) {
          o[i][0] = __fmul_rn(o[i][0], alpha[0]);
          o[i][1] = __fmul_rn(o[i][1], alpha[0]);
          o[i][2] = __fmul_rn(o[i][2], alpha[1]);
          o[i][3] = __fmul_rn(o[i][3], alpha[1]);
        }
      }
      if constexpr (L::kWide) __syncwarp();   // every lane's widened V is in
      // P (times V's scale) as the A fragments of P.V, rounded to bf16
      uint32_t pa[4];
      pa[0] = pack_bf16x2(__fmul_rn(pf[0][0], vsc[0]), __fmul_rn(pf[0][1], vsc[1]));
      pa[1] = pack_bf16x2(__fmul_rn(pf[0][2], vsc[0]), __fmul_rn(pf[0][3], vsc[1]));
      pa[2] = pack_bf16x2(__fmul_rn(pf[1][0], vsc[2]), __fmul_rn(pf[1][1], vsc[3]));
      pa[3] = pack_bf16x2(__fmul_rn(pf[1][2], vsc[2]), __fmul_rn(pf[1][3], vsc[3]));
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_base + swz<kD>(v_row, 2 * dp + v_c));
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
      __syncwarp();   // the next issue overwrites a stage this one read
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring, which the dump aliases

    // the warps' states, then this split's fold of them in warp order, then
    // the split folded into the running state
    float* dump = reinterpret_cast<float*>(smem);
    float* dm = reinterpret_cast<float*>(smem + L::kDumpO);
    float* dl = dm + kWarps * kRows;
    {
      float* dw = dump + warp * kRows * L::kDumpStride;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        *reinterpret_cast<float2*>(dw + g * L::kDumpStride + 8 * i + 2 * qd) =
            make_float2(o[i][0], o[i][1]);
        *reinterpret_cast<float2*>(dw + (g + 8) * L::kDumpStride + 8 * i + 2 * qd) =
            make_float2(o[i][2], o[i][3]);
      }
      if (qd == 0) {
        dm[warp * kRows + g] = m_run[0];
        dm[warp * kRows + g + 8] = m_run[1];
        dl[warp * kRows + g] = l_run[0];
        dl[warp * kRows + g + 8] = l_run[1];
      }
    }
    __syncthreads();
    {
      float pm = kNegInf, pl = 0.f, po[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) po[i] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        float a, bb;
        fold_ml(pm, pl, dm[w * kRows + frow], dl[w * kRows + frow], a, bb);
        const float* src = dump + (w * kRows + frow) * L::kDumpStride + fd0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) po[i] = fold_o(po[i], src[i], a, bb);
      }
      float a, bb;
      fold_ml(fM, fL, pm, pl, a, bb);
#pragma unroll
      for (int i = 0; i < kPer; ++i) fold_at(i) = fold_o(fold_at(i), po[i], a, bb);
    }
    __syncthreads();  // the next split's ring overwrites the dump
  }

  const bool covers = lo == fs && hi == ls + 1;
  if (covers) {
    // every live split of the tile is in this block: write its rows
    if (frow < rows) {
#pragma unroll
      for (int c = 0; c < kPer; c += 8) {
        uint4 packed;
        uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = fL > 0.f ? pack_bf16x2(__fdiv_rn(fold_at(c + 2 * i), fL),
                                        __fdiv_rn(fold_at(c + 2 * i + 1), fL))
                          : 0u;
        *reinterpret_cast<uint4*>(out_row(frow) + fd0 + c) = packed;
      }
    }
    return;
  }

  // one split of several (spb == 1): its state, for the merge kernel
  if (frow < rows) {
    const size_t slot = ((size_t)bh * p.n_splits + lo) * G + row0 + frow;
    float* dst = p.ws_o + slot * kD + fd0;
#pragma unroll
    for (int i = 0; i < kPer; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(fold_at(i), fold_at(i + 1), fold_at(i + 2), fold_at(i + 3));
    if ((tid & 7) == 0) *reinterpret_cast<float2*>(p.ws_ml + 2 * slot) = make_float2(fM, fL);
  }
}

// the merge kernel's rows a block: as many whole rows of kD / 4 float4s as
// 128 threads hold (4 at D = 128, 2 at 256), one at the latent dims 384
// and 640 (96 and 160 threads)
template <int kD>
constexpr int kMergeRows = kD / 4 >= kThreads ? 1 : kThreads / (kD / 4);
template <int kD>
constexpr int kMergeThreads = kMergeRows<kD> * (kD / 4);

// The rows of the tiles whose live tokens span several splits: their split
// states folded in ascending order with fold() (from the empty state, as the
// attention kernel folds a block's own splits), then divided by the sum.
// One thread a float4 of one row; kRowsPer rows a block; grid (ceil(G /
// kRowsPer), B * Hkv). Tiles of at most one live split were written by the
// attention kernel and are skipped.
template <int kD>
__global__ void __launch_bounds__(kMergeThreads<kD>)
paged_attention_merge_kernel(const Params p) {
  constexpr int kCols = kD / 4;                 // float4s a row
  constexpr int kRowsPer = kMergeRows<kD>;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv;
  const int h = bh % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int G = group * p.Q;
  const int r = blockIdx.x * kRowsPer + threadIdx.x / kCols;
  if (r >= G) return;
  const int row0 = r / p.tile_rows * p.tile_rows;
  const Walk wk = tile_walk(p, b, row0, min(p.tile_rows, G - row0));
  if (wk.ls <= wk.fs) return;
  // launched early (programmatic dependent launch): the walk above reads
  // only inputs; the split states wait for the attention kernel to finish
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int d = (threadIdx.x % kCols) * 4;
  const size_t row_slot = (size_t)bh * p.n_splits * G + r;
  uint2 packed = make_uint2(0u, 0u);
  if (d < p.dv) {   // past the V lanes read (MLA): zeros, with no state stored
    float M = kNegInf, L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = wk.fs; sp <= wk.ls; ++sp) {
      const size_t sl = row_slot + (size_t)sp * G;
      const float2 ml = __ldg(reinterpret_cast<const float2*>(p.ws_ml + 2 * sl));
      const float4 u = __ldg(reinterpret_cast<const float4*>(p.ws_o + sl * kD + d));
      float a, bb;
      fold_ml(M, L, ml.x, ml.y, a, bb);
      O = make_float4(fold_o(O.x, u.x, a, bb), fold_o(O.y, u.y, a, bb), fold_o(O.z, u.z, a, bb),
                      fold_o(O.w, u.w, a, bb));
    }
    if (L > 0.f && (kD == 384 || kD == 640)) {
      // the MLA kernel's rows are O times the sum's reciprocal
      const float inv = __frcp_rn(L);
      packed = make_uint2(pack_bf16x2(__fmul_rn(O.x, inv), __fmul_rn(O.y, inv)),
                          pack_bf16x2(__fmul_rn(O.z, inv), __fmul_rn(O.w, inv)));
    } else if (L > 0.f) {
      packed = make_uint2(pack_bf16x2(__fdiv_rn(O.x, L), __fdiv_rn(O.y, L)),
                          pack_bf16x2(__fdiv_rn(O.z, L), __fdiv_rn(O.w, L)));
    }
  }
  *reinterpret_cast<uint2*>(
      p.out + ((size_t)(b * p.Q + r % p.Q) * p.Hq + h * group + r / p.Q) * kD + d) = packed;
}

// the launch arguments of one call, as the entry point takes them
struct AttnArgs {
  Params p;
  int B, tiles;
  cudaStream_t stream;
};

// the dynamic shared memory of an attention kernel (above the 48 KB
// default), set once per instantiation
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)   // all of the SM's shared memory, so two D=128 blocks fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// after an attention kernel of split_blocks split blocks: the merge kernel,
// when there is more than one
template <int kD>
int launch_merge(const AttnArgs& a, int split_blocks) {
  if (split_blocks > 1) {   // the split states of multi-split tiles, folded
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows_per = kMergeRows<kD>;
    const int G = (a.p.Hq / a.p.Hkv) * a.p.Q;
    // its launch overlaps the attention kernel's last blocks, which let it
    // start (griddepcontrol.launch_dependents) once their copies are issued
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((G + rows_per - 1) / rows_per, a.B * a.p.Hkv);
    cfg.blockDim = dim3(kMergeThreads<kD>);
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e2 = cudaLaunchKernelEx(&cfg, paged_attention_merge_kernel<kD>, a.p);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kScaled, int kD, bool kCap, bool kTree, bool kAlibi>
int launch(const AttnArgs& a) {
  constexpr int smem = Smem<T, kD, kScaled>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        set_smem(paged_attention_kernel<T, kScaled, kD, kCap, kTree, kAlibi>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int split_blocks = (a.p.n_splits + a.p.spb - 1) / a.p.spb;
  paged_attention_kernel<T, kScaled, kD, kCap, kTree, kAlibi>
      <<<dim3(a.tiles, split_blocks, a.B * a.p.Hkv), kThreads, smem, a.stream>>>(a.p);
  return launch_merge<kD>(a, split_blocks);
}

#ifdef QSPEC_ATTN_MLA
// ---------------------------------------------------------------------------
// The MLA kernel (see the top of the file): head dims 384 and 640, K's first
// p.dk lanes read, V's first p.dv lanes from K's (bf16, fp8_e5m2) or from the
// V plane (int8, fp8_e4m3), no window, softcap, ALiBi or tree.

// an instantiation's shape: the 64-lane chunks of K (kKC) and of V (kVC) it
// reads at most, the 64-row groups of a block (kRG), and the warpgroups of a
// row group (kDS), which split the step's tokens in S = Q.K^T and V's lanes
// in P.V (kRG x kDS = 2; tools/mla_variants_ab.py times 2 x 1 at D = 384)
template <int kD>
struct MlaShape;
template <>
struct MlaShape<640> {
  static constexpr int kKC = 9, kVC = 8, kRG = 1, kDS = 2;
};
template <>
struct MlaShape<384> {
  static constexpr int kKC = 5, kVC = 4, kRG = 1, kDS = 2;
};

// the entry kinds: 0 bf16 (copied straight into the swizzled tiles wgmma
// reads; V = K's first lanes), 1 fp8_e5m2 (K widened to bf16; V = its first
// lanes), 2 int8 / fp8_e4m3 (K and V widened; the per-token scales)
template <typename T>
constexpr int kMlaKind = std::is_same<T, __nv_bfloat16>::value   ? 0
                         : std::is_same<T, __nv_fp8_e5m2>::value ? 1
                                                                 : 2;

// an instantiation's pipeline: tokens a step, the TMA ring's stages, and the
// widened (bf16) stages of the 8-bit kinds
template <int kD, int kKind>
struct MlaPipe {
  static constexpr int kStep = kD == 640 ? (kKind == 0 ? 64 : 32) : (kKind == 2 ? 32 : 64);
  static constexpr int kRing = kD == 640 ? (kKind == 1 ? 4 : 2) : (kKind == 0 ? 3 : 2);
  static constexpr int kWide = kKind == 0 ? 0 : kD == 640 ? (kKind == 1 ? 2 : 1) : 2;
};

constexpr float kDead = -3e38f;   // a masked score (< kNegInf)

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// the shared memory of one MLA block (offsets from a 1024-byte aligned base,
// the alignment of the 128-byte swizzle's 8-row atoms)
template <int kD, int kKind>
struct MlaSmem {
  using Sh = MlaShape<kD>;
  using Pi = MlaPipe<kD, kKind>;
  static constexpr int kN = Pi::kStep;
  static constexpr int kNC = Sh::kRG * Sh::kDS;          // warpgroups
  // two warpgroups and nothing else: an SM sub-partition's 16384 registers
  // then hold up to 255 a thread (a third warp there would cut that to 168)
  static constexpr int kThreads = 128 * kNC;
  static constexpr int kE = kKind == 0 ? 2 : 1;           // bytes an entry as stored
  static constexpr bool kScaled = kKind == 2;             // per-token scales
  // V from its own plane (int8, fp8_e4m3), else from K's first lanes
  static constexpr bool kVPlane = kKind == 2;
  // a TMA stage: K's chunks [kKC][kN tokens][64 entries] (128-byte swizzled
  // at bf16), then V's [kVC][kN][64] (V plane) and the scales f32 [K, V][kN]
  static constexpr int kRawK = Sh::kKC * kN * 64 * kE;
  static constexpr int kRawV = kVPlane ? Sh::kVC * kN * 64 * kE : 0;
  static constexpr int kScl = kScaled ? 2 * kN * 4 : 0;
  static constexpr int kRaw = round1024(kRawK + kRawV + kScl);
  // a widened stage (kinds 1, 2): K's chunks [kKC][kN][64 bf16] swizzled,
  // then V's [kVC][kN][64] and the scales (kind 2)
  static constexpr int kWideK = Sh::kKC * kN * 128;
  static constexpr int kWideV = kVPlane ? Sh::kVC * kN * 128 : 0;
  static constexpr int kWide = kKind == 0 ? 0 : round1024(kWideK + kWideV + kScl);
  static constexpr int kQ = Sh::kKC * 64 * 128;   // a row group's query tile [kKC][64][64 bf16]
  static constexpr int kP = 64 * 128;             // a row group's P [64][kN <= 64 bf16]
  static constexpr int kOffP = Sh::kRG * kQ;
  static constexpr int kOffRing = kOffP + Sh::kRG * kP;
  static constexpr int kOffWide = kOffRing + Pi::kRing * kRaw;
  static constexpr int kOffBar = kOffWide + Pi::kWide * kWide;   // the mbarriers
  static constexpr int kOffMx = kOffBar + 64;             // f32 [kRG][kDS][64]: rows' maxima
  static constexpr int kOffLx = kOffMx + kNC * 64 * 4;    // f32 [kRG][kDS][64]: rows' sums
  static constexpr int kPages = 64;                       // the walk's first page ids
  static constexpr int kOffPages = kOffLx + kNC * 64 * 4;
  static constexpr int kBytes = kOffPages + kPages * 4 + 1024;   // and the base's alignment
  // the output rows staged at the last split in the row group's query tile
  static constexpr int kStg = 64 * Sh::kVC / Sh::kDS * 2 + 16;   // bytes a staged row
  static_assert(Sh::kDS * 64 * kStg <= kQ, "the MLA output's staging");
  static_assert(kBytes <= 232448, "an MLA block's shared memory");
  static_assert(kBytes > 232448 / 2, "one MLA block an SM");
  static_assert(kN % 16 == 0 && kN <= 64 && kN / Sh::kDS >= 16, "an MLA step's tokens");
  static_assert(8 * Pi::kRing <= 64, "the MLA mbarriers");
  static_assert(kNC == 2, "two warpgroups an MLA block");
};

// one MLA launch's parameters: the layer's cache as a 2-D tensor map
struct MlaParams {
  CUtensorMap map;   // [P * 2 * Hkv * S rows, D entries]: (64, box_rows) boxes
  Params p;
  int box_rows;      // tokens a box: gcd(S, the step)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
// (a wait that outlasts 2^26 polls, seconds, traps: a lost phase fails the
// launch instead of hanging the card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1u << 26)) __trap();
  }
}
// one TMA box of the tensor map at (lane c0, row c1) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// a bulk copy of `bytes` (a multiple of 16) contiguous bytes into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// this thread's shared-memory writes, visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving an accumulator's reads or writes across
// the wgmma that owns it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// a wgmma shared-memory descriptor: 128-byte swizzle, lbo / sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// wgmma m64nNk16, bf16 in, f32 accumulate, A and B from shared memory (B
// transposed: kTransB), d += (or, scale_d == 0, =) A.B
template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
  template <int kTransB>
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};
template <>
struct Wgmma<32> {
  template <int kTransB>
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};
template <>
struct Wgmma<64> {
  template <int kTransB>
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};
template <>
struct Wgmma<128> {
  template <int kTransB>
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};
template <>
struct Wgmma<256> {
  template <int kTransB>
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

// T: the cache's entry type; kD: the latent head dim (384, 640)
template <typename T, int kD>
__global__ void __launch_bounds__(MlaSmem<kD, kMlaKind<T>>::kThreads, 1)
paged_attention_mla_kernel(const __grid_constant__ MlaParams mp) {
  constexpr int kKind = kMlaKind<T>;
  using Sh = MlaShape<kD>;
  using Pi = MlaPipe<kD, kKind>;
  using L = MlaSmem<kD, kKind>;
  constexpr int kN = L::kN;
  constexpr int kNS = kN / Sh::kDS;             // a warpgroup's tokens of S
  constexpr int kPV = 64 * Sh::kVC / Sh::kDS;   // and its V lanes of P.V
  constexpr int kAcc = kPV / 2;                 // its P.V accumulators a thread
  constexpr int kRowsB = 64 * Sh::kRG;          // GQA rows a block
  constexpr bool kScaled = kKind == 2;
  constexpr int kRgThreads = 128 * Sh::kDS;     // the threads of a row group
  constexpr int kBarAll = 5;                    // the block's named barrier
  const Params& p = mp.p;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int bh = blockIdx.z;
  const int b = bh / p.Hkv;
  const int h = bh % p.Hkv;
  const int group = p.Hq / p.Hkv;
  const int G = group * p.Q;
  const int row0 = tile * kRowsB;
  const int rows = min(kRowsB, G - row0);
  const int sp_lo = blockIdx.y * p.spb;
  const int sp_hi = min(sp_lo + p.spb, p.n_splits);
  const Walk wk = tile_walk(p, b, row0, rows);
  const int lo = max(wk.fs, sp_lo);
  const int hi = min(wk.ls + 1, sp_hi);
  auto out_row = [&](int r) {
    return p.out + ((size_t)(b * p.Q + r % p.Q) * p.Hq + h * group + r / p.Q) * kD;
  };
  if (lo >= hi) {
    // nothing live in this block's splits; the first block of a tile that
    // sees nothing at all writes its rows' zeros
    if (wk.ls < wk.fs && sp_lo == 0) {
      for (int idx = tid; idx < rows * (kD / 8); idx += L::kThreads)
        *reinterpret_cast<uint4*>(out_row(row0 + idx / (kD / 8)) + 8 * (idx % (kD / 8))) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // a split's live tokens [t_lo, t_hi); its steps start at t_lo rounded down
  // to the step, so every step sits at a multiple of kN
  auto t_lo_of = [&](int s) { return max(s * p.split, wk.first_tok); };
  auto t_hi_of = [&](int s) { return min((s + 1) * p.split, wk.n_tok); };
  // the TMA ring's full barriers (the copies' completion)
  const uint32_t bars = sbase + L::kOffBar;
  auto full = [&](int i) { return bars + 8 * i; };
  // thread 0 issues the copies: of step k (split is, start it0) into stage
  // k % kRing, kRing steps ahead of the block's walk; the page ids of the
  // walk's first kPages pages wait in shared memory
  int is = lo, it0 = t_lo_of(lo) / kN * kN, ik = 0;
  const int pg0 = it0 / p.S;
  int* pages_s = reinterpret_cast<int*>(smem + L::kOffPages);
  auto issue_next = [&](bool direct) {   // direct: read the block table itself
    if (is >= hi) return;
    const int st = ik % Pi::kRing;
    mbar_expect_tx(full(st), L::kRawK + L::kRawV + L::kScl);
    const uint32_t dst = sbase + L::kOffRing + st * L::kRaw;
    const int box = mp.box_rows;
    const int plane = p.Hkv * p.S;   // rows from a page's K plane to its V plane
    // a box's tokens lie in one page (S % box == 0); past the block table
    // the null page (masked). The pages' reads first, all in flight at once
    int krows[kN / 16];
    for (int r = 0; r < kN / box; ++r) {
      const int t = it0 + r * box;
      const int lp = t / p.S;
      const int page = !direct && lp - pg0 < L::kPages ? pages_s[lp - pg0]
                       : lp < p.pps ? __ldg(p.block_tables + (size_t)b * p.pps + lp)
                                    : 0;
      krows[r] = (page * 2 * p.Hkv + h) * p.S + t % p.S;
    }
    for (int r = 0; r < kN / box; ++r) {
      const int krow = krows[r];
      for (int c = 0; c < Sh::kKC; ++c)
        tma_load_2d(dst + (c * kN + r * box) * 64 * L::kE, &mp.map, 64 * c, krow, full(st));
      if constexpr (L::kVPlane) {
        for (int c = 0; c < Sh::kVC; ++c)
          tma_load_2d(dst + L::kRawK + (c * kN + r * box) * 64 * L::kE, &mp.map, 64 * c,
                      krow + plane, full(st));
      }
      if constexpr (L::kScaled) {
        // the scales [P, 2, Hkv, S] sit at the rows' indices
        const float* sk = p.kv_scales + (size_t)krow;
        bulk_load(dst + L::kRawK + L::kRawV + r * box * 4, sk, box * 4, full(st));
        bulk_load(dst + L::kRawK + L::kRawV + (kN + r * box) * 4, sk + plane, box * 4, full(st));
      }
    }
    ++ik;
    it0 += kN;
    if (it0 >= t_hi_of(is)) {
      ++is;
      if (is < hi) it0 = t_lo_of(is) / kN * kN;
    }
  };

  // warpgroup cw: row group rg, part c of its tokens and lanes
  const int cw = tid / 128;
  const int rg = cw / Sh::kDS;
  const int c = cw % Sh::kDS;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q4 = lane & 3;
  const int rt = c * 128 + wt;   // the thread's place in its row group
  const uint32_t q_s = sbase + rg * L::kQ;
  const uint32_t p_s = sbase + L::kOffP + rg * L::kP;
  unsigned char* p_ptr = smem + L::kOffP + rg * L::kP;
  float* mx = reinterpret_cast<float*>(smem + L::kOffMx) + rg * Sh::kDS * 64;
  float* lx = reinterpret_cast<float*>(smem + L::kOffLx) + rg * Sh::kDS * 64;
  const int bar_a = 1 + 2 * rg, bar_b = 2 + 2 * rg;   // the row group's named barriers

  // the query tile, times the scale, rounded to bf16 once, zeros past dk
  // and past G: kTpr threads a row, each every kTpr-th 16-byte piece
  {
    constexpr int kTpr = kRgThreads / 64;
    const int rr = rt / kTpr;
    const int r = row0 + rg * 64 + rr;
    const __nv_bfloat16* qrow =
        p.q + ((size_t)(b * p.Q + r % p.Q) * p.Hq + h * group + r / p.Q) * kD;
    constexpr int kPer = Sh::kKC * 8 / kTpr;   // pieces a thread
    uint4 raws[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int pc = rt % kTpr + k * kTpr;
      raws[k] = r < G && pc * 8 < p.dk ? __ldg(reinterpret_cast<const uint4*>(qrow + pc * 8))
                                       : make_uint4(0, 0, 0, 0);
    }
    // while they are in flight: the ring's barriers and its first copies
    // (thread 0, reading the block table itself), the walk's page ids
    if (tid == 0) {
      for (int i = 0; i < Pi::kRing; ++i) mbar_init(full(i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mp.map))
                   : "memory");
      for (int i = 0; i < Pi::kRing; ++i) issue_next(true);
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    }
    if (tid >= L::kThreads - L::kPages) {   // the last warps, not thread 0's
      const int i = tid - (L::kThreads - L::kPages);
      pages_s[i] = pg0 + i < p.pps ? __ldg(p.block_tables + (size_t)b * p.pps + pg0 + i) : 0;
    }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int pc = rt % kTpr + k * kTpr;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (r < G && pc * 8 < p.dk) {
      const uint4 raw = raws[k];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = pack_bf16x2(__fmul_rn(__bfloat162float(e[2 * i]), p.scale),
                           __fmul_rn(__bfloat162float(e[2 * i + 1]), p.scale));
    }
    *reinterpret_cast<uint4*>(smem + rg * L::kQ + (pc >> 3) * 8192 + rr * 128 +
                              (((pc & 7) ^ (rr & 7)) << 4)) = packed;
  }
  }
  fence_async_smem();
  named_sync(kBarAll, L::kThreads);   // the query tiles, the page ids, the barriers' init

  // this thread's two rows of every accumulator: rr[i] in the row group,
  // their positions (-1: padding, which sees nothing)
  int rr[2], qpos[2];
  __nv_bfloat16* orow[2];   // their output rows (null: padding)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rr[i] = 16 * warp + g + 8 * i;
    const int r = row0 + rg * 64 + rr[i];
    qpos[i] = r < G ? wk.qs + r % p.Q : -1;
    orow[i] = r < G ? out_row(r) : nullptr;
  }
  const bool covers = lo == wk.fs && hi == wk.ls + 1;
  float fM[2] = {kNegInf, kNegInf}, fL[2] = {0.f, 0.f};   // the running fold of the rows
  int n = 0;
  for (int s = lo; s < hi; ++s) {
    const int t_lo = t_lo_of(s), t_hi = t_hi_of(s);
    float o[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // this split's; l over this part's tokens
    for (int t0 = t_lo / kN * kN; t0 < t_hi; t0 += kN, ++n) {
      const int st = n % Pi::kRing;
      mbar_wait(full(st), (n / Pi::kRing) & 1);
      uint32_t kb = sbase + L::kOffRing + st * L::kRaw;   // K's chunks, bf16, swizzled
      if constexpr (kKind != 0) {
        // the block widens the raw stage exactly into a bf16 stage (16
        // entries a unit: 16 bytes in, two swizzled 16-byte pieces out), the
        // scales copied beside them, once every wgmma that read that stage
        // before is done (one stage: the last P.V; two: the one before, done
        // by the time its warpgroup passed the last step's S)
        if constexpr (Pi::kWide == 1) wg_wait<0>();
        named_sync(kBarAll, L::kThreads);
        const unsigned char* raw = smem + L::kOffRing + st * L::kRaw;
        unsigned char* wide = smem + L::kOffWide + (n % Pi::kWide) * L::kWide;
        constexpr int kUnits = (Sh::kKC + (L::kVPlane ? Sh::kVC : 0)) * kN * 4;
#pragma unroll 2
        for (int u = tid; u < kUnits; u += L::kThreads) {
          const int row = u >> 2;   // (chunk, token) over K's chunks, then V's
          const int pc = u & 3;
          const int t = row % kN;
          const uint4 v = *reinterpret_cast<const uint4*>(raw + row * 64 + pc * 16);
          uint4 w0, w1;
          widen4(T{}, v.x, w0.x, w0.y);
          widen4(T{}, v.y, w0.z, w0.w);
          widen4(T{}, v.z, w1.x, w1.y);
          widen4(T{}, v.w, w1.z, w1.w);
          unsigned char* d = wide + row * 128;
          *reinterpret_cast<uint4*>(d + (((2 * pc) ^ (t & 7)) << 4)) = w0;
          *reinterpret_cast<uint4*>(d + (((2 * pc + 1) ^ (t & 7)) << 4)) = w1;
        }
        if constexpr (L::kScaled) {
          const float* src = reinterpret_cast<const float*>(raw + L::kRawK + L::kRawV);
          float* dstf = reinterpret_cast<float*>(wide + L::kWideK + L::kWideV);
          for (int i = tid; i < 2 * kN; i += L::kThreads) dstf[i] = src[i];
        }
        fence_async_smem();
        named_sync(kBarAll, L::kThreads);   // the widened stage is in; the raw one is free
        if (tid == 0) issue_next(false);
        kb = smem_u32(wide);
      }
      // V: its own plane, or K's first lanes
      const uint32_t vb = kb + (!L::kVPlane ? 0 : kKind == 0 ? L::kRawK : L::kWideK);
      const float* scl = reinterpret_cast<const float*>(smem + (kb - sbase) + L::kWideK + L::kWideV);

      // S = Q.K^T over this part's tokens [c kNS, (c + 1) kNS) and all dk lanes
      float sc[kNS / 2];
#pragma unroll
      for (int i = 0; i < kNS / 2; ++i) sc[i] = 0.f;
      reg_fence(sc);
      wg_fence();
      const int nks = p.dk >> 4;
      for (int ks = 0; ks < nks; ++ks) {
        const uint32_t koff = (ks & 3) * 32;
        Wgmma<kNS>::template mma<0>(
            sc, sw128_desc(q_s + (ks >> 2) * 8192 + koff, 16, 1024),
            sw128_desc(kb + (ks >> 2) * (kN * 128) + c * kNS * 128 + koff, 16, 1024), ks > 0);
      }
      wg_commit();
      wg_wait<0>();   // S, and the last step's P.V
      reg_fence(sc);
      reg_fence(o);
      // once every warpgroup is past the last step's P.V (bf16: its stage
      // takes the copies of the step kRing - 1 ahead; at D = 640 the maxima's
      // exchange below is that block-wide barrier)
      constexpr bool kRelAtMax = Sh::kRG == 1 && Sh::kDS == 2;
      if constexpr (kKind == 0 && !kRelAtMax) {
        named_sync(kBarAll, L::kThreads);
        if (tid == 0 && n > 0) issue_next(false);
      }

      // K's scale, the mask (live: in the split, before the row's position)
      // and the rows' maxima over this part
      float cm[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNS / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = c * kNS + 8 * j + 2 * q4 + e;
            const int kv = t0 + tok;
            float v = sc[4 * j + 2 * i + e];
            if (kScaled) v = __fmul_rn(v, scl[tok]);
            const bool live = kv >= t_lo && kv < t_hi && kv <= qpos[i];
            sc[4 * j + 2 * i + e] = live ? v : kDead;
            if (live) cm[i] = fmaxf(cm[i], v);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cm[i] = fmaxf(cm[i], __shfl_xor_sync(0xffffffffu, cm[i], 1));
        cm[i] = fmaxf(cm[i], __shfl_xor_sync(0xffffffffu, cm[i], 2));
      }
      if constexpr (Sh::kDS > 1) {
        // the row group's parts exchange their maxima
        if (q4 == 0) {
          mx[c * 64 + rr[0]] = cm[0];
          mx[c * 64 + rr[1]] = cm[1];
        }
        named_sync(bar_a, kRgThreads);
        if constexpr (kKind == 0 && kRelAtMax) {
          if (tid == 0 && n > 0) issue_next(false);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = mx[rr[i]];
#pragma unroll
          for (int cc = 1; cc < Sh::kDS; ++cc) x = fmaxf(x, mx[cc * 64 + rr[i]]);
          cm[i] = x;
        }
      }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mn = fmaxf(m[i], cm[i]);
        alpha[i] = exp_diff(m[i], mn);
        m[i] = mn;
      }
      // P = e^(s - m) (times V's scale) rounded to bf16 into this part's
      // columns of the row group's P; the row sums over this part unrounded
#pragma unroll
      for (int j = 0; j < kNS / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int tok = c * kNS + 8 * j + 2 * q4;
          const float s0 = sc[4 * j + 2 * i], s1 = sc[4 * j + 2 * i + 1];
          const float p0 = s0 != kDead ? exp_diff(s0, m[i]) : 0.f;
          const float p1 = s1 != kDead ? exp_diff(s1, m[i]) : 0.f;
          ps[i] = __fadd_rn(__fadd_rn(ps[i], p0), p1);
          const uint32_t word = kScaled ? pack_bf16x2(__fmul_rn(p0, scl[kN + tok]),
                                                      __fmul_rn(p1, scl[kN + tok + 1]))
                                        : pack_bf16x2(p0, p1);
          *reinterpret_cast<uint32_t*>(p_ptr + rr[i] * 128 + (((tok >> 3) ^ (rr[i] & 7)) << 4) +
                                       (tok & 7) * 2) = word;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] = __fadd_rn(ps[i], __shfl_xor_sync(0xffffffffu, ps[i], 1));
        ps[i] = __fadd_rn(ps[i], __shfl_xor_sync(0xffffffffu, ps[i], 2));
        l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), ps[i]);
      }
      fence_async_smem();
      named_sync(bar_b, kRgThreads);   // the row group's P is in

      // O = O alpha + P.V over this part's lanes [c kPV, (c + 1) kPV)
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          o[4 * j] = __fmul_rn(o[4 * j], alpha[0]);
          o[4 * j + 1] = __fmul_rn(o[4 * j + 1], alpha[0]);
          o[4 * j + 2] = __fmul_rn(o[4 * j + 2], alpha[1]);
          o[4 * j + 3] = __fmul_rn(o[4 * j + 3], alpha[1]);
        }
      }
      reg_fence(o);
      wg_fence();
#pragma unroll
      for (int kt = 0; kt < kN / 16; ++kt)
        Wgmma<kPV>::template mma<1>(
            o, sw128_desc(p_s + kt * 32, 16, 1024),
            sw128_desc(vb + c * (Sh::kVC / Sh::kDS) * (kN * 128) + kt * 2048, kN * 128, 1024), 1);
      wg_commit();
      reg_fence(o);
    }
    wg_wait<0>();
    reg_fence(o);

    // the split's row sums: the parts' added in order
    float lt[2] = {l[0], l[1]};
    if constexpr (Sh::kDS > 1) {
      if (q4 == 0) {
        lx[c * 64 + rr[0]] = l[0];
        lx[c * 64 + rr[1]] = l[1];
      }
      named_sync(bar_a, kRgThreads);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = lx[rr[i]];
#pragma unroll
        for (int cc = 1; cc < Sh::kDS; ++cc) x = __fadd_rn(x, lx[cc * 64 + rr[i]]);
        lt[i] = x;
      }
    }
    const int r_a = row0 + rg * 64 + rr[0];   // this thread's rows: r_a, r_a + 8
    if (!covers) {
      // one split of several (spb == 1): its state, for the merge kernel
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r_a + 8 * i;
        if (r >= G) continue;
        const size_t slot = ((size_t)bh * p.n_splits + s) * G + r;
        float* dst = p.ws_o + slot * kD + c * kPV;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j)
          if (c * kPV + 8 * j < p.dv)
            *reinterpret_cast<float2*>(dst + 8 * j + 2 * q4) =
                make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
        if (c == 0 && q4 == 0)
          *reinterpret_cast<float2*>(p.ws_ml + 2 * slot) = make_float2(m[i], lt[i]);
      }
      continue;
    }
    // the split folded into the rows' running state (fold_ml / fold_o, as
    // the merge kernel folds): past the first split the running O comes from
    // this warpgroup's slab, and the last writes the rows
    float fa[2], fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) fold_ml(fM[i], fL[i], m[i], lt[i], fa[i], fb[i]);
    const bool first = s == lo, last = s == hi - 1;
    float4* slab = reinterpret_cast<float4*>(p.ws_o) +
                   (((size_t)bh * gridDim.x + tile) * L::kNC + cw) * 32 * kAcc + wt;
    // the last split's rows, times the sums' reciprocal (as the merge kernel
    // takes them), staged as bf16 in the row group's query tile (free after
    // the last step), then written 16 bytes a thread
    unsigned char* stg = smem + rg * L::kQ + c * 64 * L::kStg;
    const float inv[2] = {fL[0] > 0.f ? __frcp_rn(fL[0]) : 0.f,
                          fL[1] > 0.f ? __frcp_rn(fL[1]) : 0.f};
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const float4 prev = first ? make_float4(0.f, 0.f, 0.f, 0.f) : slab[j * 128];
      const float4 f = make_float4(fold_o(prev.x, o[4 * j], fa[0], fb[0]),
                                   fold_o(prev.y, o[4 * j + 1], fa[0], fb[0]),
                                   fold_o(prev.z, o[4 * j + 2], fa[1], fb[1]),
                                   fold_o(prev.w, o[4 * j + 3], fa[1], fb[1]));
      if (!last) {
        slab[j * 128] = f;
        continue;
      }
      const int d = 8 * j + 2 * q4;
      const bool lv = c * kPV + d < p.dv;
      *reinterpret_cast<uint32_t*>(stg + rr[0] * L::kStg + d * 2) =
          lv ? pack_bf16x2(__fmul_rn(f.x, inv[0]), __fmul_rn(f.y, inv[0])) : 0u;
      *reinterpret_cast<uint32_t*>(stg + rr[1] * L::kStg + d * 2) =
          lv ? pack_bf16x2(__fmul_rn(f.z, inv[1]), __fmul_rn(f.w, inv[1])) : 0u;
    }
    if (last) {
      named_sync(6 + cw, 128);   // this warpgroup's rows are staged
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (orow[i] == nullptr) continue;
#pragma unroll
        for (int k = 0; k < kPV / 32; ++k) {
          const int pc = q4 + 4 * k;   // 16-byte pieces of this part's lanes
          *reinterpret_cast<uint4*>(orow[i] + c * kPV + 8 * pc) =
              *reinterpret_cast<const uint4*>(stg + rr[i] * L::kStg + pc * 16);
        }
      }
    }
    if (last && c == Sh::kDS - 1) {
      // the lanes past every part's: zeros, 64 bytes a thread and row
      constexpr int kPast = (kD - 64 * Sh::kVC) / 8;
      static_assert(kPast == 16, "the lanes past V's");
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (orow[i] != nullptr) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            *reinterpret_cast<uint4*>(orow[i] + 64 * Sh::kVC + 8 * (4 * q4 + k)) =
                make_uint4(0, 0, 0, 0);
        }
    }
  }
}

// cuTensorMapEncodeTiled, looked up by cudaGetDriverEntryPoint (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

template <typename T, int kD>
int launch_mla(const AttnArgs& a, int num_pages) {
  using Sh = MlaShape<kD>;
  using L = MlaSmem<kD, kMlaKind<T>>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = set_smem(paged_attention_mla_kernel<T, kD>, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int split_blocks = (a.p.n_splits + a.p.spb - 1) / a.p.spb;
  if (a.p.dk > 64 * Sh::kKC || a.p.dv > 64 * Sh::kVC ||
      (split_blocks == 1 && a.p.n_splits > 1 && a.p.ws_o == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  MlaParams mp;
  mp.p = a.p;
  mp.p.tile_rows = 64 * Sh::kRG;
  int box = a.p.S, step = L::kN;   // gcd(S, the step)
  while (step != 0) {
    const int t = box % step;
    box = step;
    step = t;
  }
  mp.box_rows = box;
  const cuuint64_t dims[2] = {(cuuint64_t)kD, (cuuint64_t)num_pages * 2 * a.p.Hkv * a.p.S};
  const cuuint64_t strides[1] = {(cuuint64_t)kD * sizeof(T)};
  const cuuint32_t boxes[2] = {64, (cuuint32_t)box};
  const cuuint32_t elem[2] = {1, 1};
  const bool bf16 = kMlaKind<T> == 0;
  if (encode(&mp.map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<void*>(a.p.kv), dims, strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (a.p.Hq / a.p.Hkv) * a.p.Q;
  const int tiles = (G + 64 * Sh::kRG - 1) / (64 * Sh::kRG);
  paged_attention_mla_kernel<T, kD>
      <<<dim3(tiles, split_blocks, a.B * a.p.Hkv), L::kThreads, L::kBytes, a.stream>>>(mp);
  AttnArgs merge = a;
  merge.p.tile_rows = mp.p.tile_rows;
  return launch_merge<kD>(merge, split_blocks);
}
#endif  // QSPEC_ATTN_MLA

// the (head dim, softcap) instantiations of one entry type; with ALiBi only
// head dim 128 without the softcap or the tree (where the JAX package takes it)
template <typename T, bool kScaled, bool kTree, bool kAlibi>
int launch_dim(int head_dim, const AttnArgs& a) {
  const bool cap = a.p.softcap > 0.f;
  if constexpr (kAlibi) {
    if (kTree || cap || head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch<T, kScaled, 128, false, false, true>(a);
  } else {
    switch (head_dim) {
      case 128:
        return cap ? launch<T, kScaled, 128, true, kTree, false>(a)
                   : launch<T, kScaled, 128, false, kTree, false>(a);
      case 256:
        return cap ? launch<T, kScaled, 256, true, kTree, false>(a)
                   : launch<T, kScaled, 256, false, kTree, false>(a);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

#ifdef QSPEC_ATTN_KV
// this object's KV entry type (its scales: int8 and fp8_e4m3)
#if QSPEC_ATTN_KV == 0
using KvT = __nv_bfloat16;
constexpr bool kKvScaled = false;
#elif QSPEC_ATTN_KV == 1
using KvT = int8_t;
constexpr bool kKvScaled = true;
#elif QSPEC_ATTN_KV == 2
using KvT = __nv_fp8_e4m3;
constexpr bool kKvScaled = true;
#elif QSPEC_ATTN_KV == 3
using KvT = __nv_fp8_e5m2;
constexpr bool kKvScaled = false;
#else
#error "QSPEC_ATTN_KV is 0, 1, 2 or 3"
#endif
#endif

}  // namespace

#define QSPEC_CAT2(a, b) a##b
#define QSPEC_CAT(a, b) QSPEC_CAT2(a, b)

#ifdef QSPEC_ATTN_MLA
#if QSPEC_ATTN_MLA != 384 && QSPEC_ATTN_MLA != 640
#error "QSPEC_ATTN_MLA is 384 or 640"
#endif
// the MLA instantiations of this object's head dim over the four entry types
// (kv_dtype 0 bf16, 1 int8, 2 fp8_e4m3, 3 fp8_e5m2); args points to the entry
// point's AttnArgs; num_pages: the layer's pages (its tensor map's rows)
extern "C" int QSPEC_CAT(qspec_paged_attention_mla, QSPEC_ATTN_MLA)(int kv_dtype,
                                                                    const void* args,
                                                                    int num_pages) {
  const AttnArgs& a = *static_cast<const AttnArgs*>(args);
  constexpr int kD = QSPEC_ATTN_MLA;
  switch (kv_dtype) {
    case 0: return launch_mla<__nv_bfloat16, kD>(a, num_pages);
    case 1: return launch_mla<int8_t, kD>(a, num_pages);
    case 2: return launch_mla<__nv_fp8_e4m3, kD>(a, num_pages);
    case 3: return launch_mla<__nv_fp8_e5m2, kD>(a, num_pages);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#else
// every instantiation of this object's entry type: with (tree) or without
// the tree mask, with (alibi) or without ALiBi; args points to the entry
// point's AttnArgs (every object compiles the same struct from this file)
extern "C" int QSPEC_CAT(qspec_paged_attention_kv, QSPEC_ATTN_KV)(int tree, int alibi,
                                                                  int head_dim,
                                                                  const void* args) {
  const AttnArgs& a = *static_cast<const AttnArgs*>(args);
  if (alibi) return launch_dim<KvT, kKvScaled, false, true>(head_dim, a);
  if (tree) return launch_dim<KvT, kKvScaled, true, false>(head_dim, a);
  return launch_dim<KvT, kKvScaled, false, false>(head_dim, a);
}
#endif

#if defined(QSPEC_ATTN_KV) && QSPEC_ATTN_KV == 0
extern "C" int qspec_paged_attention_kv1(int tree, int alibi, int head_dim, const void* args);
extern "C" int qspec_paged_attention_kv2(int tree, int alibi, int head_dim, const void* args);
extern "C" int qspec_paged_attention_kv3(int tree, int alibi, int head_dim, const void* args);
extern "C" int qspec_paged_attention_mla384(int kv_dtype, const void* args, int num_pages);
extern "C" int qspec_paged_attention_mla640(int kv_dtype, const void* args, int num_pages);

// q [B, Q, Hq, D] bf16, D = head_dim in {128, 256, 384, 640}; kv = the
// layer's [P, 2, Hkv, S, D] pages of kv_dtype 0 bf16, 1 int8, 2 fp8_e4m3,
// 3 fp8_e5m2; kv_scales = the layer's [P, 2, Hkv, S] f32 scales for int8 and
// fp8_e4m3 (else unused); block_tables [B, pages_per_seq] int32; ctx_lens,
// q_pos: null (the queries are each row's last Q positions), or the
// position of query q_pos_col of row 0, with q_pos_stride elements from a
// row to the next, int32 or (q_pos_i64) int64; out [B, Q, Hq, D] bf16;
// softcap > 0 caps the scores
// (0: no cap); window >= 1 (1 << 30: no window). S % 16 == 0,
// Hq % Hkv == 0. tree_anc: null, or the Medusa tree's [T] ancestor words
// (T <= 64, bit j of word t: node j is an ancestor of node t or t itself);
// the rows with q index >= tree_prefix are then tree nodes, node t at slot
// q_start + tree_prefix + t. alibi: null, or the [Hq] f32 ALiBi slopes (head
// dim 128, no softcap and no tree: else cudaErrorInvalidValue).
// k_dims, v_dims: the lanes of K and of V read, head_dim both at 128 and
// 256; at the MLA head dims 384 and 640 k_dims % 32 == 0 and v_dims % 64 == 0
// (up to head_dim), the output's lanes past v_dims zero, and no window,
// softcap, tree or ALiBi (else cudaErrorInvalidValue); there k_dims is at
// most 576 / 320 and v_dims 512 / 256 (640 / 384), V's lanes come from K's
// over bf16 and fp8_e5m2 (MLA writes them equal), and num_pages, the
// layer's pages, sizes the cache's tensor map.
// The plan (ops/attention_cuda.py:attention_plan): split tokens a split (a
// multiple of S), n_splits = ceil(pages_per_seq * S / split), spb splits a
// block (1, or at least n_splits); with spb < n_splits, ws = [B * Hkv *
// n_splits * G * (D + 2)] f32 (G = Hq / Hkv * Q), the split states that the
// merge kernel, launched after the attention kernel, folds; at the MLA head
// dims with spb >= n_splits > 1, ws = [B * Hkv * tiles * rows * v lanes] f32,
// each block's slab for the running fold of its splits.
extern "C" int qspec_paged_attention(const void* q, const void* kv,
                                     const void* kv_scales,
                                     const void* block_tables,
                                     const void* ctx_lens, const void* q_pos,
                                     int q_pos_stride, int q_pos_i64, int q_pos_col,
                                     void* out, void* ws, int B,
                                     int Q, int Hq, int Hkv, int S, int pages_per_seq,
                                     int split, int n_splits, int spb, int kv_dtype,
                                     int head_dim, int k_dims, int v_dims, float scale,
                                     float softcap, int window, const void* tree_anc,
                                     int tree_prefix, const void* alibi, int num_pages,
                                     void* stream) {
  const int G = (Hq / Hkv) * Q;
  const int tiles = (G + kRows - 1) / kRows;
  const bool mla = head_dim == 384 || head_dim == 640;
  if (split <= 0 || split % S != 0 || (!mla && split / S > kMaxSplitPages) || n_splits <= 0 ||
      (spb != 1 && spb < n_splits) ||
      (long long)n_splits * split < (long long)pages_per_seq * S ||
      (spb < n_splits && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mla ? (k_dims <= 0 || k_dims > head_dim || k_dims % 32 != 0 || v_dims <= 0 ||
             v_dims > head_dim || v_dims % 64 != 0 || window != (1 << 30) ||
             softcap != 0.f || tree_anc != nullptr || alibi != nullptr)
          : (k_dims != head_dim || v_dims != head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ws_o = static_cast<float*>(ws);
  float* ws_ml = ws_o == nullptr ? nullptr : ws_o + (size_t)B * Hkv * n_splits * G * head_dim;
  const Params p{static_cast<const __nv_bfloat16*>(q), kv, static_cast<const float*>(kv_scales),
                 static_cast<const int*>(block_tables), static_cast<const int*>(ctx_lens),
                 q_pos, q_pos_stride, q_pos_i64, q_pos_col, static_cast<__nv_bfloat16*>(out), ws_o,
                 ws_ml, Q, Hq, Hkv, S, pages_per_seq, k_dims, v_dims, split,
                 n_splits, spb, scale, softcap, window,
                 static_cast<const unsigned long long*>(tree_anc), tree_prefix,
                 static_cast<const float*>(alibi), kRows};
  const AttnArgs a{p, B, tiles, static_cast<cudaStream_t>(stream)};
  if (alibi != nullptr && tree_anc != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype < 0 || kv_dtype > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (mla)
    return head_dim == 384 ? qspec_paged_attention_mla384(kv_dtype, &a, num_pages)
                           : qspec_paged_attention_mla640(kv_dtype, &a, num_pages);
  // the object of each entry type: 0 bf16, 1 int8, 2 fp8_e4m3, 3 fp8_e5m2
  int (*const parts[4])(int, int, int, const void*) = {
      qspec_paged_attention_kv0, qspec_paged_attention_kv1, qspec_paged_attention_kv2,
      qspec_paged_attention_kv3};
  return parts[kv_dtype](tree_anc != nullptr, alibi != nullptr, head_dim, &a);
}
#endif
