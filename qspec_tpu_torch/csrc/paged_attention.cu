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
// takes a kernel of its own, paged_attention_mla_kernel below, at the latent
// head dims 384 and 640 (kv_lora_rank + qk_rope_head_dim rounded up to 128),
// over all four entry types: the same causal function, MQA over one latent
// KV row per token, with query groups of 16, 40 or 128 heads and no window,
// softcap, ALiBi or tree (the JAX package passes none of them there). What
// differs from the kernel above, and why:
// - Only the lanes the function needs are read: K's first k_dims (r + dr:
//   576, 288) and V's first v_dims (r: 512, 256) of each stored row; the
//   output's lanes past v_dims are written as zeros. The callers' padding
//   lanes are zero, so this is the full function on their rows.
// - The output accumulator is split over the warps by dims: every warp
//   computes S = Q.K^T for 8 of a step's 32 tokens over all k_dims (the
//   query tile and K read from shared memory by ldmatrix), the block's
//   scores go through shared memory, 128 threads (8 a row) take the online
//   softmax over the step, and warp w then runs P.V for dims [w v_dims / 4,
//   (w + 1) v_dims / 4): at most 20 n8 tiles, 80 f32 registers a thread.
// - One block-wide ring of 2 steps of 32 tokens (K and V of a step: 80 KB in
//   bf16 at D = 640), copied with cp.async, warp w the rows of tokens 8w to
//   8w + 7 (one address a row); 8-bit entries are widened to bf16 in shared
//   memory once a step. The block waits on these copies for about half its
//   time (tools/mla_variants_ab.py on an H100), which more blocks in flight
//   hide. The fold of a row's splits keeps O in shared memory (f32 [16][D +
//   8]). 224-225 KB a block at D = 640, 136-137 KB at 384: one block an SM.
// - Each (sequence, tile of 16 query rows) block reads the KV rows of its
//   live tokens once; a sequence's rows are read once per tile: G / 16
//   times (1 for DeepSeek-V2-Lite's 16 heads at Q = 1, 10 for MiniCPM3's 40
//   at Q = 4, 32 for DeepSeek-V3's 128 at Q = 4), the repeats mostly from L2.
// The numerics and the splits are the kernel above's (q scaled and rounded
// to bf16 once, f32 scores times K's scale, p times V's scale rounded to
// bf16 for P.V, the splits at fixed positions folded in ascending order by
// fold_ml / fold_o, in the block or by the merge kernel; the plan's splits
// are 128 tokens here, and a block takes one of them wherever that fills
// more SMs: ops/attention_cuda.py), and the steps sit at fixed positions
// (multiples of 32), so a row's bits depend on no other row, on Q, on the
// schedule or on its place in the batch.
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
  const int row0 = r / kRows * kRows;
  const Walk wk = tile_walk(p, b, row0, min(kRows, G - row0));
  if (wk.ls <= wk.fs) return;
  // launched early (programmatic dependent launch): the walk above reads
  // only inputs; the split states wait for the attention kernel to finish
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int d = (threadIdx.x % kCols) * 4;
  const size_t row_slot = (size_t)bh * p.n_splits * G + r;
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
  uint2 packed = make_uint2(0u, 0u);
  if (L > 0.f)
    packed = make_uint2(pack_bf16x2(__fdiv_rn(O.x, L), __fdiv_rn(O.y, L)),
                        pack_bf16x2(__fdiv_rn(O.z, L), __fdiv_rn(O.w, L)));
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

// ---------------------------------------------------------------------------
// The MLA kernel (see the top of the file): head dims 384 and 640, K's first
// p.dk lanes and V's first p.dv lanes read, no window, softcap, ALiBi or tree.

constexpr int kMlaStep = 32;     // tokens a step: 8 a warp in S = Q.K^T
constexpr int kMlaStages = 2;    // the block's cp.async ring of steps
constexpr float kDead = -3e38f;   // a masked score in the step's score tile (< kNegInf)

// the shared memory of one MLA block
template <typename T, int kD, bool kScaled>
struct MlaSmem {
  static constexpr bool kWide = sizeof(T) == 1;                // 8-bit entries, widened
  static constexpr int kRow = kD * (int)sizeof(T);             // a token row as stored
  static constexpr int kStage = 2 * kMlaStep * kRow;           // K, then V, of a step
  static constexpr int kRing = kMlaStages * kStage;
  static constexpr int kWideTile = kMlaStep * kD * 2;          // a step's K or V in bf16
  static constexpr int kWideAll = kWide ? 2 * kWideTile : 0;
  static constexpr int kScl = kScaled ? kMlaStages * 2 * kMlaStep * 4 : 0;
  static constexpr int kSStride = kMlaStep + 8;                // floats: the step's scores
  static constexpr int kPStride = kMlaStep + 8;                // bf16: the step's P
  static constexpr int kFStride = kD + 8;                      // floats: the fold's O
  static constexpr int kOffWide = kRing;
  static constexpr int kOffScl = kOffWide + kWideAll;
  static constexpr int kOffQ = kOffScl + kScl;                 // bf16 [16][kD], swizzled
  static constexpr int kOffFold = kOffQ + kRows * kD * 2;      // f32 [16][kFStride]
  static constexpr int kOffS = kOffFold + kRows * kFStride * 4;
  static constexpr int kOffP = kOffS + kRows * kSStride * 4;
  static constexpr int kOffStat = kOffP + kRows * kPStride * 2;   // alpha, fold a, fold b
  static constexpr int kBytes = kOffStat + 3 * kRows * 4;
};

template <typename T, bool kScaled, int kD>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_mla_kernel(const Params p) {
  using L = MlaSmem<T, kD, kScaled>;
  constexpr int kNt = kD / 32;           // n8 tiles of P.V a warp holds at most (dv = kD)
  constexpr int kCh = kD / 8;            // 8-lane chunks of an output row
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
  const int sp_lo = blockIdx.y * p.spb;
  const int sp_hi = min(sp_lo + p.spb, p.n_splits);
  const int dk = p.dk, dv = p.dv;
  // the softmax's and the output's row of this thread, and its part of it
  const int srow = tid >> 3;
  const int part = tid & 7;

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
    if (ls < fs && sp_lo == 0 && srow < rows) {
      for (int c = part; c < kCh; c += 8)
        *reinterpret_cast<uint4*>(out_row(srow) + 8 * c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (lo != sp_lo) load_pages(lo);   // the walk starts past the block's first split
  __syncthreads();                   // the page ids are in

  const int lm = lane >> 3;
  const int lr = lane & 7;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const uint32_t q_base = smem_u32(smem + L::kOffQ);
  const uint32_t p_base = smem_u32(smem + L::kOffP);
  const int a_row = lr + 8 * (lm & 1), a_c = lm >> 1;   // A fragments (Q, P): rows on M
  const int v_row = lr + 8 * (lm & 1), v_c = lm >> 1;   // V by .trans: tokens on K
  float* f_s = reinterpret_cast<float*>(smem + L::kOffFold);
  float* s_s = reinterpret_cast<float*>(smem + L::kOffS);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffP);
  float* alpha_s = reinterpret_cast<float*>(smem + L::kOffStat);
  float* fa_s = alpha_s + kRows;
  float* fb_s = fa_s + kRows;
  float* scl = reinterpret_cast<float*>(smem + L::kOffScl);

  const size_t head_stride = (size_t)p.S * kD;
  const size_t page_stride = 2 * (size_t)p.Hkv * head_stride;
  const unsigned char* kv_bytes = static_cast<const unsigned char*>(p.kv);
  const int kc = dk * (int)sizeof(T) / 16;   // 16-byte chunks of a K row read
  const int vc = dv * (int)sizeof(T) / 16;   // and of a V row
  int page0 = lo * split_pages;              // the logical page of pages_s[0]
  int t_lo = 0, t_hi = 0;                    // the split's live tokens

  // a step's copies (32 tokens at t0, a multiple of 32) into stage st: the
  // tokens of [t_lo, t_hi), zeros for the others (never live, never NaN).
  // Warp w copies tokens 8w..8w+7: lane j < 8 finds token 8w+j's row once
  // (its page, its K and V planes), then every lane copies 16-byte chunks
  // lane, lane + 32, ... of each row, so no chunk divides an index
  const size_t v_plane = (size_t)p.Hkv * head_stride * sizeof(T);
  auto issue = [&](int st, int t0) {
    const uint32_t kd = smem_u32(smem + st * L::kStage);
    const uint32_t vd = kd + kMlaStep * L::kRow;
    const int t_me = t0 + 8 * warp + (lane & 7);
    const int ok_me = t_me >= t_lo && t_me < t_hi;
    unsigned long long row_me = reinterpret_cast<unsigned long long>(kv_bytes);
    if (ok_me)
      row_me += ((size_t)pages_s[t_me / p.S - page0] * page_stride + (size_t)h * head_stride +
                 (size_t)(t_me % p.S) * kD) * sizeof(T);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tok = 8 * warp + j;
      const unsigned char* row =
          reinterpret_cast<const unsigned char*>(__shfl_sync(0xffffffffu, row_me, j));
      const int n = __shfl_sync(0xffffffffu, ok_me, j) ? 16 : 0;
      for (int c = lane; c < kc; c += 32)
        cp_async16(kd + (L::kWide ? tok * L::kRow + c * 16 : swz<kD>(tok, c)), row + c * 16, n);
      for (int c = lane; c < vc; c += 32)
        cp_async16(vd + (L::kWide ? tok * L::kRow + c * 16 : swz<kD>(tok, c)),
                   row + (n ? v_plane : 0) + c * 16, n);
    }
    if (kScaled && tid < 16) {
      const int sel = tid >> 3;      // 0: K's scales, 1: V's
      const int c = tid & 7;         // 4 tokens each
      const int t = t0 + 4 * c;
      const bool ok = t >= t_lo && t < t_hi;
      const float* src = p.kv_scales;
      if (ok)
        src += (size_t)pages_s[t / p.S - page0] * 2 * p.Hkv * p.S +
               (size_t)(sel * p.Hkv + h) * p.S + t % p.S;
      cp_async16(smem_u32(scl + (st * 2 + sel) * kMlaStep + 4 * c), src,
                 ok ? 4 * min(4, t_hi - t) : 0);
    }
  };
  auto split_range = [&](int s) {
    t_lo = max(s * p.split, first_tok);
    t_hi = min((s + 1) * p.split, n_tok);
  };
  split_range(lo);
  const int t_first = t_lo / kMlaStep * kMlaStep;
  issue(0, t_first);
  cp_async_commit();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the query tile, times the scale, rounded to bf16 once (its reads overlap
  // the first step's copies); the fold's O at zero
  for (int idx = tid; idx < kRows * (dk / 8); idx += kThreads) {
    const int rr = idx / (dk / 8);
    const int c = idx - rr * (dk / 8);
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
    *reinterpret_cast<uint4*>(smem + L::kOffQ + swz<kD>(rr, c)) = packed;
  }
  for (int idx = tid; idx < kRows * L::kFStride / 4; idx += kThreads)
    reinterpret_cast<float4*>(f_s)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
  // this lane's two rows of S (g and g + 8): their positions (-1: padding)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = g + 8 * i;
    qpos[i] = rr < rows ? qs + (row0 + rr) % p.Q : -1;
  }
  // this warp's dims of P.V and O
  const int nt_w = dv / 32;
  const int base = warp * (dv / 4);
  float fM = kNegInf, fL = 0.f;   // the running fold of this thread's srow

  for (int s = lo; s < hi; ++s) {
    int t_begin = t_first;
    if (s > lo) {    // a block that takes several splits walks the next
      load_pages(s);
      page0 = s * split_pages;
      split_range(s);
      __syncthreads();
      t_begin = t_lo / kMlaStep * kMlaStep;
      issue(0, t_begin);
      cp_async_commit();
    }
    const int n_steps = (t_hi - t_begin + kMlaStep - 1) / kMlaStep;
    float o[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float m_run = kNegInf, l_run = 0.f;   // srow's softmax state in this split
    for (int i = 0; i < n_steps; ++i) {
      if (i + 1 < n_steps) issue((i + 1) & 1, t_begin + (i + 1) * kMlaStep);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();   // every thread's copies of this step are in
      const int st = i & 1;
      const int t0 = t_begin + i * kMlaStep;
      const unsigned char* stage = smem + st * L::kStage;
      const float* scl_k = scl + st * 2 * kMlaStep;
      uint32_t k_base, v_base;
      if constexpr (L::kWide) {
        // the step's 8-bit K and V widened exactly to bf16 tiles, warp w
        // taking the rows it copied, 16 bytes a lane
        unsigned char* wide = smem + L::kOffWide;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int tok = 8 * warp + j;
          for (int c = lane; c < kc + vc; c += 32) {
            const bool isk = c < kc;
            const int cc = isk ? c : c - kc;
            const uint4 raw = *reinterpret_cast<const uint4*>(
                stage + (isk ? 0 : kMlaStep * L::kRow) + tok * L::kRow + cc * 16);
            uint4 w0, w1;
            widen4(T{}, raw.x, w0.x, w0.y);
            widen4(T{}, raw.y, w0.z, w0.w);
            widen4(T{}, raw.z, w1.x, w1.y);
            widen4(T{}, raw.w, w1.z, w1.w);
            unsigned char* dst = wide + (isk ? 0 : L::kWideTile);
            *reinterpret_cast<uint4*>(dst + swz<kD>(tok, 2 * cc)) = w0;
            *reinterpret_cast<uint4*>(dst + swz<kD>(tok, 2 * cc + 1)) = w1;
          }
        }
        __syncthreads();
        k_base = smem_u32(wide);
        v_base = k_base + L::kWideTile;
      } else {
        k_base = smem_u32(stage);
        v_base = k_base + kMlaStep * L::kRow;
      }

      // S = Q.K^T: warp w takes tokens 8w..8w+7 over all dk lanes, two
      // k-steps an ldmatrix of K; sc holds rows g, g+8 x tokens 2 qd + {0, 1}
      {
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < dk / 32; ++j) {
          uint32_t a0[4], a1[4], bk[4];
          ldmatrix_x4(a0, q_base + swz<kD>(a_row, 4 * j + a_c));
          ldmatrix_x4(a1, q_base + swz<kD>(a_row, 4 * j + 2 + a_c));
          ldmatrix_x4(bk, k_base + swz<kD>(8 * warp + lr, 4 * j + lm));
          mma_bf16(sc, a0, bk[0], bk[1]);
          mma_bf16(sc, a1, bk[2], bk[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1;
          const int tk = 8 * warp + 2 * qd + (e & 1);
          const int kv_pos = t0 + tk;
          float sv = sc[e];
          if (kScaled) sv = __fmul_rn(sv, scl_k[tk]);
          const bool live = kv_pos >= t_lo && kv_pos < t_hi && kv_pos <= qpos[ri];
          s_s[(g + 8 * ri) * L::kSStride + tk] = live ? sv : kDead;
        }
      }
      __syncthreads();   // the step's scores are in

      // the online softmax of the step, 8 threads a row, 4 tokens each; P
      // (times V's scale) rounded to bf16 for P.V, the row sum unrounded
      {
        const float4 s4 = *reinterpret_cast<const float4*>(s_s + srow * L::kSStride + 4 * part);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        float cm = kNegInf;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (sv[k] != kDead) cm = fmaxf(cm, sv[k]);
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
        const float m_new = fmaxf(m_run, cm);
        const float alpha = exp_diff(m_run, m_new);
        m_run = m_new;
        float pf[4], psum = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pf[k] = sv[k] != kDead ? exp_diff(sv[k], m_new) : 0.f;
          psum = __fadd_rn(psum, pf[k]);
        }
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 2));
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 4));
        l_run = __fadd_rn(__fmul_rn(l_run, alpha), psum);
        float vs[4] = {1.f, 1.f, 1.f, 1.f};
        if (kScaled) {
#pragma unroll
          for (int k = 0; k < 4; ++k) vs[k] = scl_k[kMlaStep + 4 * part + k];
        }
        *reinterpret_cast<uint2*>(p_s + srow * L::kPStride + 4 * part) =
            make_uint2(pack_bf16x2(__fmul_rn(pf[0], vs[0]), __fmul_rn(pf[1], vs[1])),
                       pack_bf16x2(__fmul_rn(pf[2], vs[2]), __fmul_rn(pf[3], vs[3])));
        if (part == 0) alpha_s[srow] = alpha;
      }
      __syncthreads();   // P and the rows' rescales are in

      // O = O * alpha + P.V over this warp's dims
      {
        const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
        if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
            if (n < nt_w) {
              o[n][0] = __fmul_rn(o[n][0], a0);
              o[n][1] = __fmul_rn(o[n][1], a0);
              o[n][2] = __fmul_rn(o[n][2], a1);
              o[n][3] = __fmul_rn(o[n][3], a1);
            }
          }
        }
        uint32_t pa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          ldmatrix_x4(pa[kk], p_base + a_row * L::kPStride * 2 + (2 * kk + a_c) * 16);
#pragma unroll
        for (int dp = 0; dp < kNt / 2; ++dp) {
          if (2 * dp < nt_w) {
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, v_base + swz<kD>(16 * kk + v_row, base / 8 + 2 * dp + v_c));
              mma_bf16(o[2 * dp], pa[kk], bv[0], bv[1]);
              mma_bf16(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
            }
          }
        }
      }
      __syncthreads();   // the next step's copies overwrite this stage, S and P
    }
    cp_async_wait<0>();

    // the split's state folded into the running one: each row's (a, b) by
    // its threads, then O by each warp over its dims
    {
      float a, bb;
      fold_ml(fM, fL, m_run, l_run, a, bb);
      if (part == 0) {
        fa_s[srow] = a;
        fb_s[srow] = bb;
      }
    }
    __syncthreads();
    {
      const float a0 = fa_s[g], b0 = fb_s[g], a1 = fa_s[g + 8], b1 = fb_s[g + 8];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n < nt_w) {
          float* f0 = f_s + g * L::kFStride + base + 8 * n + 2 * qd;
          float* f1 = f0 + 8 * L::kFStride;
          f0[0] = fold_o(f0[0], o[n][0], a0, b0);
          f0[1] = fold_o(f0[1], o[n][1], a0, b0);
          f1[0] = fold_o(f1[0], o[n][2], a1, b1);
          f1[1] = fold_o(f1[1], o[n][3], a1, b1);
        }
      }
    }
  }
  __syncthreads();   // every warp's dims of O are in

  const float* f_row = f_s + srow * L::kFStride;
  if (lo == fs && hi == ls + 1) {
    // every live split of the tile is in this block: write its rows (zeros
    // past dv, where O stays 0)
    if (srow < rows) {
      for (int c = part; c < kCh; c += 8) {
        uint4 packed;
        uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = fL > 0.f ? pack_bf16x2(__fdiv_rn(f_row[8 * c + 2 * i], fL),
                                        __fdiv_rn(f_row[8 * c + 2 * i + 1], fL))
                          : 0u;
        *reinterpret_cast<uint4*>(out_row(srow) + 8 * c) = packed;
      }
    }
    return;
  }
  // one split of several (spb == 1): its state, for the merge kernel
  if (srow < rows) {
    const size_t slot = ((size_t)bh * p.n_splits + lo) * G + row0 + srow;
    float* dst = p.ws_o + slot * kD;
    for (int c = part; c < kD / 4; c += 8)
      *reinterpret_cast<float4*>(dst + 4 * c) = *reinterpret_cast<const float4*>(f_row + 4 * c);
    if (part == 0) *reinterpret_cast<float2*>(p.ws_ml + 2 * slot) = make_float2(fM, fL);
  }
}

template <typename T, bool kScaled, int kD>
int launch_mla(const AttnArgs& a) {
  constexpr int smem = MlaSmem<T, kD, kScaled>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = set_smem(paged_attention_mla_kernel<T, kScaled, kD>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int split_blocks = (a.p.n_splits + a.p.spb - 1) / a.p.spb;
  paged_attention_mla_kernel<T, kScaled, kD>
      <<<dim3(a.tiles, split_blocks, a.B * a.p.Hkv), kThreads, smem, a.stream>>>(a.p);
  return launch_merge<kD>(a, split_blocks);
}

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
// point's AttnArgs
extern "C" int QSPEC_CAT(qspec_paged_attention_mla, QSPEC_ATTN_MLA)(int kv_dtype,
                                                                    const void* args) {
  const AttnArgs& a = *static_cast<const AttnArgs*>(args);
  constexpr int kD = QSPEC_ATTN_MLA;
  switch (kv_dtype) {
    case 0: return launch_mla<__nv_bfloat16, false, kD>(a);
    case 1: return launch_mla<int8_t, true, kD>(a);
    case 2: return launch_mla<__nv_fp8_e4m3, true, kD>(a);
    case 3: return launch_mla<__nv_fp8_e5m2, false, kD>(a);
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
extern "C" int qspec_paged_attention_mla384(int kv_dtype, const void* args);
extern "C" int qspec_paged_attention_mla640(int kv_dtype, const void* args);

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
// softcap, tree or ALiBi (else cudaErrorInvalidValue).
// The plan (ops/attention_cuda.py:attention_plan): split tokens a split (a
// multiple of S), n_splits = ceil(pages_per_seq * S / split), spb splits a
// block (1, or at least n_splits); with spb < n_splits, ws = [B * Hkv *
// n_splits * G * (D + 2)] f32 (G = Hq / Hkv * Q), the split states that the
// merge kernel, launched after the attention kernel, folds.
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
                                     int tree_prefix, const void* alibi,
                                     void* stream) {
  const int G = (Hq / Hkv) * Q;
  const int tiles = (G + kRows - 1) / kRows;
  if (split <= 0 || split % S != 0 || split / S > kMaxSplitPages || n_splits <= 0 ||
      (spb != 1 && spb < n_splits) ||
      (long long)n_splits * split < (long long)pages_per_seq * S ||
      (spb < n_splits && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mla = head_dim == 384 || head_dim == 640;
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
                 static_cast<const float*>(alibi)};
  const AttnArgs a{p, B, tiles, static_cast<cudaStream_t>(stream)};
  if (alibi != nullptr && tree_anc != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype < 0 || kv_dtype > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (mla)
    return head_dim == 384 ? qspec_paged_attention_mla384(kv_dtype, &a)
                           : qspec_paged_attention_mla640(kv_dtype, &a);
  // the object of each entry type: 0 bf16, 1 int8, 2 fp8_e4m3, 3 fp8_e5m2
  int (*const parts[4])(int, int, int, const void*) = {
      qspec_paged_attention_kv0, qspec_paged_attention_kv1, qspec_paged_attention_kv2,
      qspec_paged_attention_kv3};
  return parts[kv_dtype](tree_anc != nullptr, alibi != nullptr, head_dim, &a);
}
#endif
