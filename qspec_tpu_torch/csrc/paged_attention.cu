// Paged attention for Hopper: decode (Q=1), QSpec verify (Q=k+1), the draft's
// Q=2 backfill step, chunked prefill and the Medusa tree verify, over the
// paged KV cache with bf16, int8, fp8_e4m3 or fp8_e5m2 entries.
//
// Replaces the TPU kernel qspec_tpu/ops/attention_pallas.py:_paged_attn_kernel
// (entry paged_attention_pallas), its causal core, its sliding window, its
// logit softcap, its ALiBi bias, its 8-bit KV option, its Medusa tree mask and
// head dims 128 and 256 (a template parameter): flash attention with an online
// softmax over the
// sequence's live pages, GQA rows G = (Hq / Hkv) * Q per kv head (Q minor),
// a causal mask by absolute position (query i of row b sits at
// q_start[b] + i) and, under a window W, the mask q_pos - W < kv_pos <= q_pos.
//
// Layouts (D = kD, 128 or 256): q [B, Q, Hq, D] bf16; the layer's cache
// [P, 2, Hkv, S, D] of entries T (K at index 0, V at 1; page 0 is the null
// page); for int8 and fp8_e4m3 the layer's scales [P, 2, Hkv, S] f32, one
// per (k/v, head, token); block_tables [B, PPS] int32; ctx_lens [B] int32
// (tokens including the new ones); out like q.
//
// 8-bit entries, with the Pallas kernel's semantics: K's per-token scale
// multiplies the token's scores, V's multiplies its probabilities before
// P.V (the softmax sum takes the unscaled probabilities); fp8_e5m2 is a bare
// cast. Entries are widened to f32 exactly at the staging load.
//
// The logit softcap (a launch argument, 0 = none; Gemma-2's
// attn_logit_softcapping), s = tanhf(s * (1 / cap)) * cap on the f32 score,
// in the Pallas body's order: after the query scale and K's per-token scale,
// before the causal / window mask. A capped launch takes instantiations of
// its own, so the uncapped ones carry no branch in the score loop. Masked
// tokens still contribute exact zeros, so the cap changes no
// row-independence argument below.
//
// What bounds it on the H100: every live K/V byte is read once per
// (sequence, kv head, query tile) and used for 4 operations per element per
// query row, so at decode and verify widths (G = 4..16 rows) it is bound by
// device-memory bytes; at prefill (G in the hundreds) by operations. 8-bit
// entries halve the bytes.
//
// What the design does about that: one block per (query tile of 8 GQA rows,
// kv head, sequence), so the group's query heads share each K/V read. The
// block's 4 warps split the sequence: warp w takes tokens 16w..16w+15 of
// every 64, stages them in its own slice of shared memory as f32 and keeps
// its own online softmax (max, sum, P.V) for all 8 rows, with no block-wide
// barrier inside the loop; the four partial states are merged at the end in
// a fixed order. Only the pages the tile can see are read (up to its last
// query's position, never past ctx_len). Scores and P.V are f32 on the CUDA
// cores: simple and right first; the tensor-core version is later work.
// Shared memory: K and V are staged as f32, so a block takes about 72 KB at
// D = 128 (three blocks per SM) and 140 KB at D = 256 (one block per SM, of
// the H100's 227 KB); the token slices stay 16 per warp at both widths, so
// the walk, the merge and the bits of a row are the same function of D.
// Which warp takes a token depends only on the token's position, masked
// tokens contribute exact zeros, and the merge order is fixed, so a row's
// result does not depend on Q, on the other rows or on how far the block
// walks. Rows with ctx_len == 0 (padding) read nothing and write zeros.
//
// The sliding window (a launch argument: it may differ per layer; 1 << 30
// means none): a block starts its walk at the row's first in-window page,
// clamp((q_start - W + 1) / S, 0, n_pages - 1) as the Pallas kernel does,
// so a decode reads about W / S pages however long the context. The start
// and each warp's tokens follow from logical positions only (warp w still
// takes the 16-token slices at 16w mod 64 from that page on), so a ring of
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
// 64 nodes. Each lane holds its rows' words in registers; the walk, the
// token split and the merge are those of the plain rows.
//
// ALiBi (a template flag, instantiated only where the JAX package reaches it:
// head dim 128, no softcap, no tree; BLOOM, MPT), with the Pallas body's
// semantics: score += slope[hq] * (kv_pos - q_pos) in f32 after K's scale and
// before the mask, hq the query head of the row (h * group + r / Q). The
// slopes are one [Hq] f32 array per model, read once per lane and row; the
// bias of a masked token is never used, and padded rows (r >= G) carry slope 0
// and see nothing, as without it.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the launch arguments of one call, as the entry point takes them
struct AttnArgs {
  const void* q;
  const void* kv;
  const void* kv_scales;
  const void* block_tables;
  const void* ctx_lens;
  const void* q_start;
  void* out;
  int B, Q, Hq, Hkv, S, pages_per_seq;
  float scale, softcap;
  int window;
  const void* tree_anc;
  int tree_prefix;
  const void* alibi;
  cudaStream_t stream;
};

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                // query rows per block
constexpr int kWarpTok = 16;            // tokens per warp per step
constexpr int kStep = kWarps * kWarpTok;  // tokens per block step
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int kD>                       // head dim (the cache's, 128-padded)
struct Smem {
  float q[kRows][kD + 4];               // pre-scaled queries
  union {
    struct {
      float k[kWarps][kWarpTok][kD + 1];  // +1: conflict-free token-per-lane reads
      float v[kWarps][kWarpTok][kD + 4];  // +4: fewer conflicts on 1-byte staging
    } kv;
    float acc[kWarps][kRows][kD];       // per-warp P.V, for the final merge
  } u;
  float p[kWarps][kRows][kWarpTok];
  float alpha[kWarps][kRows];
  float m[kWarps][kRows];
  float l[kWarps][kRows];
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

// T: the cache's entry type; kScaled: per-token scales (int8, fp8_e4m3);
// kD: the head dim; kCap: the logit softcap (a template flag, so the
// uncapped instantiations carry no branch in the score loop); kTree: the
// Medusa tree mask (tree_anc / tree_prefix are read only when it is set);
// kAlibi: the ALiBi bias (alibi, [Hq] f32 slopes, read only when it is set)
template <typename T, bool kScaled, int kD, bool kCap, bool kTree, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ kv,
                       const float* __restrict__ kv_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ ctx_lens,
                       const int* __restrict__ q_start,
                       __nv_bfloat16* __restrict__ out, int Q, int Hq, int Hkv,
                       int S, int pages_per_seq, float scale, float softcap,
                       int window, const unsigned long long* __restrict__ tree_anc,
                       int tree_prefix, const float* __restrict__ alibi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<kD>& sm = *reinterpret_cast<Smem<kD>*>(smem_raw);
  constexpr int kLaneDims = kD / 32;    // P.V dims per lane: a float4 per 128 dims

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int G = group * Q;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ctx = ctx_lens[b];
  const int qs = q_start[b];

  // query tile, pre-scaled, f32: 8 rows x kD/8 vectors of 8, kD/128 per thread
  for (int idx = threadIdx.x; idx < kRows * (kD / 8); idx += kThreads) {
    const int rl = idx / (kD / 8);
    const int c8 = idx % (kD / 8);
    const int r = row0 + rl;
    float vals[8];
    if (r < G) {
      const int hq = h * group + r / Q;
      const int qi = r % Q;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + ((size_t)(b * Q + qi) * Hq + hq) * kD + c8 * 8));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = __bfloat162float(e[i]) * scale;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.q[rl][c8 * 8 + i] = vals[i];
  }
  __syncthreads();

  // the last query position in this tile bounds the tokens to walk
  int max_qi = -1;
  for (int r = row0; r < row0 + kRows && r < G; ++r) max_qi = max(max_qi, r % Q);
  const int n_tok = min(ctx, min(qs + max_qi + 1, pages_per_seq * S));
  // the first in-window page of the row's first query (0 without a window);
  // warp w starts at its first 16-token slice (16w mod 64) on or after it
  const int n_pages = max(1, (ctx + S - 1) / S);
  const int w_first = qs - window + 1;
  const int first_tok = min(w_first > 0 ? w_first / S : 0, n_pages - 1) * S;
  int t_begin = (first_tok / kStep) * kStep + warp * kWarpTok;
  if (t_begin < first_tok) t_begin += kStep;

  // per lane: score slot (row 2*rr + lane/16, token lane%16), rr = 0..3
  const int tok = lane & 15;
  const int half = lane >> 4;
  int qpos[kRows / 2];
  int wpos[kRows / 2];                  // tree rows' window reference (kTree)
  unsigned long long anc[kRows / 2];    // tree rows' ancestor words (kTree)
  float slope[kRows / 2];               // the rows' ALiBi slopes (kAlibi)
  const int tree_base = qs + tree_prefix;   // slot of tree node 0 (root + 1)
#pragma unroll
  for (int rr = 0; rr < kRows / 2; ++rr) {
    const int r = row0 + 2 * rr + half;
    qpos[rr] = r < G ? qs + r % Q : -1;   // -1: row never live
    if (kTree) {
      const int node = r % Q - tree_prefix;
      const bool tree_row = r < G && node >= 0;
      anc[rr] = tree_row ? __ldg(tree_anc + node) : 0ull;
      wpos[rr] = qpos[rr];
      if (tree_row) {
        qpos[rr] = tree_base - 1;   // the root bounds a tree row
        wpos[rr] = qpos[rr] + __popcll(anc[rr]);   // its AR position root + depth
      }
    }
    if (kAlibi) slope[rr] = r < G ? __ldg(alibi + h * group + r / Q) : 0.f;
  }
  float m_run[kRows / 2], l_run[kRows / 2];
#pragma unroll
  for (int rr = 0; rr < kRows / 2; ++rr) {
    m_run[rr] = kNegInf;
    l_run[rr] = 0.f;
  }
  // lane's P.V dims: 4 consecutive dims in each 128-wide group c
  float acc[kRows][kLaneDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kLaneDims; ++j) acc[i][j] = 0.f;
  const float inv_cap = kCap ? 1.f / softcap : 0.f;

  const size_t head_stride = (size_t)S * kD;
  const size_t page_stride = 2 * (size_t)Hkv * head_stride;
  float (*ks)[kD + 1] = sm.u.kv.k[warp];
  float (*vs)[kD + 4] = sm.u.kv.v[warp];
  constexpr int kVec = 16 / sizeof(T);      // entries per 16-byte load
  constexpr int kVecs = kD / kVec;          // 16-byte loads per token row

  for (int t0 = t_begin; t0 < n_tok; t0 += kStep) {
    const int page = block_tables[(size_t)b * pages_per_seq + t0 / S];
    const int off = t0 % S;   // 16 tokens never straddle a page (S % 16 == 0)
    const T* kb = kv + (size_t)page * page_stride + h * head_stride + (size_t)off * kD;
    const T* vb = kb + (size_t)Hkv * head_stride;
#pragma unroll
    for (int it = 0; it < kWarpTok * kVecs / 32; ++it) {
      const int idx = it * 32 + lane;
      // bf16: a lane walks along a token row; 1-byte entries: neighbouring
      // lanes take neighbouring tokens (conflict-free f32 stores)
      const int tt = sizeof(T) == 2 ? idx / kVecs : idx % kWarpTok;
      const int cv = sizeof(T) == 2 ? idx % kVecs : idx / kWarpTok;
      const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kb + tt * kD + cv * kVec));
      const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vb + tt * kD + cv * kVec));
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        ks[tt][cv * kVec + i] = to_f32(ke[i]);
        vs[tt][cv * kVec + i] = to_f32(ve[i]);
      }
    }
    float k_sc = 1.f, v_sc = 1.f;   // this lane's token's scales
    if (kScaled) {
      const float* sb = kv_scales + (size_t)page * 2 * Hkv * S + (size_t)h * S + off + tok;
      k_sc = __ldg(sb);
      v_sc = __ldg(sb + (size_t)Hkv * S);
    }
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < kRows / 2; ++rr) {
      const int rl = 2 * rr + half;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) s = fmaf(sm.q[rl][d], ks[tok][d], s);
      if (kScaled) s *= k_sc;
      const int kv_pos = t0 + tok;
      if (kAlibi) s += slope[rr] * static_cast<float>(kv_pos - qpos[rr]);
      if (kCap) s = tanhf(s * inv_cap) * softcap;
      const int wref = kTree ? wpos[rr] : qpos[rr];
      bool live = kv_pos <= qpos[rr] && kv_pos > wref - window && kv_pos < ctx;
      if (kTree) {
        // node (kv_pos - root - 1)'s slot, when it is an ancestor or self
        const unsigned t = static_cast<unsigned>(kv_pos - tree_base);
        live = live || (t < 64u && ((anc[rr] >> t) & 1ull) && kv_pos < ctx);
      }
      float cm = live ? s : kNegInf;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      const float m_new = fmaxf(m_run[rr], cm);
      const float alpha = expf(m_run[rr] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run[rr] = l_run[rr] * alpha + psum;
      m_run[rr] = m_new;
      sm.p[warp][rl][tok] = kScaled ? p * v_sc : p;
      if (tok == 0) sm.alpha[warp][rl] = alpha;
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float a = sm.alpha[warp][i];
#pragma unroll
      for (int j = 0; j < kLaneDims; ++j) acc[i][j] *= a;
#pragma unroll
      for (int tt = 0; tt < kWarpTok; ++tt) {
        const float p = sm.p[warp][i][tt];
#pragma unroll
        for (int c = 0; c < kD / 128; ++c) {
          const float4 v4 = *reinterpret_cast<const float4*>(&vs[tt][c * 128 + lane * 4]);
          acc[i][4 * c] = fmaf(p, v4.x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(p, v4.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(p, v4.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(p, v4.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncwarp();   // the next step overwrites this warp's K/V/P slices
  }

  // publish this warp's partial state, then merge the four in a fixed order
  __syncthreads();  // every warp is done with the K/V slices (acc aliases them)
#pragma unroll
  for (int rr = 0; rr < kRows / 2; ++rr) {
    if (tok == 0) {
      sm.m[warp][2 * rr + half] = m_run[rr];
      sm.l[warp][2 * rr + half] = l_run[rr];
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kD / 128; ++c)
      *reinterpret_cast<float4*>(&sm.u.acc[warp][i][c * 128 + lane * 4]) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                      acc[i][4 * c + 3]);
  __syncthreads();

  // 8 rows x kD dims: 8 consecutive dims per thread and pass, kD/128 passes
  for (int idx = threadIdx.x; idx < kRows * (kD / 8); idx += kThreads) {
    const int rl = idx / (kD / 8);
    const int d0 = (idx % (kD / 8)) * 8;
    const int r = row0 + rl;
    if (r >= G) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m[w][rl]);
    float wgt[kWarps];
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wgt[w] = expf(sm.m[w][rl] - mx);
      l += sm.l[w][rl] * wgt[w];
    }
    uint4 packed;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sm.u.acc[w][rl][d0 + i] * wgt[w];
      o[i] = __float2bfloat16_rn(l > 0.f ? v / l : 0.f);
    }
    const int hq = h * group + r / Q;
    const int qi = r % Q;
    *reinterpret_cast<uint4*>(out + ((size_t)(b * Q + qi) * Hq + hq) * kD + d0) = packed;
  }
}

template <typename T, bool kScaled, int kD, bool kCap, bool kTree, bool kAlibi>
int launch(const AttnArgs& a) {
  const int smem = static_cast<int>(sizeof(Smem<kD>));   // above the 48 KB default
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, kScaled, kD, kCap, kTree, kAlibi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int G = (a.Hq / a.Hkv) * a.Q;
  dim3 grid((G + kRows - 1) / kRows, a.Hkv, a.B);
  paged_attention_kernel<T, kScaled, kD, kCap, kTree, kAlibi>
      <<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.kv),
      static_cast<const float*>(a.kv_scales), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.ctx_lens), static_cast<const int*>(a.q_start),
      static_cast<__nv_bfloat16*>(a.out), a.Q, a.Hq, a.Hkv, a.S, a.pages_per_seq,
      a.scale, a.softcap, a.window,
      static_cast<const unsigned long long*>(a.tree_anc), a.tree_prefix,
      static_cast<const float*>(a.alibi));
  return static_cast<int>(cudaGetLastError());
}

// the (head dim, softcap) instantiations of one entry type; with ALiBi only
// head dim 128 without the softcap or the tree (where the JAX package takes it)
template <typename T, bool kScaled, bool kTree, bool kAlibi>
int launch_dim(int head_dim, const AttnArgs& a) {
  const bool cap = a.softcap > 0.f;
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

// every instantiation with (kTree) or without the tree mask, with (kAlibi)
// or without ALiBi, by entry type: 0 bf16, 1 int8, 2 fp8_e4m3, 3 fp8_e5m2
template <bool kTree, bool kAlibi>
int dispatch(int kv_dtype, int head_dim, const AttnArgs& a) {
  switch (kv_dtype) {
    case 0:
      return launch_dim<__nv_bfloat16, false, kTree, kAlibi>(head_dim, a);
    case 1:
      return launch_dim<int8_t, true, kTree, kAlibi>(head_dim, a);
    case 2:
      return launch_dim<__nv_fp8_e4m3, true, kTree, kAlibi>(head_dim, a);
    case 3:
      return launch_dim<__nv_fp8_e5m2, false, kTree, kAlibi>(head_dim, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Q, Hq, D] bf16, D = head_dim in {128, 256}; kv = the layer's
// [P, 2, Hkv, S, D] pages of kv_dtype 0 bf16, 1 int8, 2 fp8_e4m3,
// 3 fp8_e5m2; kv_scales = the layer's [P, 2, Hkv, S] f32 scales for int8 and
// fp8_e4m3 (else unused); block_tables [B, pages_per_seq] int32; ctx_lens,
// q_start [B] int32; out [B, Q, Hq, D] bf16; softcap > 0 caps the scores
// (0: no cap); window >= 1 (1 << 30: no window). S % 16 == 0,
// Hq % Hkv == 0. tree_anc: null, or the Medusa tree's [T] ancestor words
// (T <= 64, bit j of word t: node j is an ancestor of node t or t itself);
// the rows with q index >= tree_prefix are then tree nodes, node t at slot
// q_start + tree_prefix + t. alibi: null, or the [Hq] f32 ALiBi slopes (head
// dim 128, no softcap and no tree: else cudaErrorInvalidValue).
extern "C" int qspec_paged_attention(const void* q, const void* kv,
                                     const void* kv_scales,
                                     const void* block_tables,
                                     const void* ctx_lens, const void* q_start,
                                     void* out, int B, int Q, int Hq, int Hkv,
                                     int S, int pages_per_seq, int kv_dtype,
                                     int head_dim, float scale, float softcap,
                                     int window, const void* tree_anc,
                                     int tree_prefix, const void* alibi,
                                     void* stream) {
  const AttnArgs a{q, kv, kv_scales, block_tables, ctx_lens, q_start, out,
                   B, Q, Hq, Hkv, S, pages_per_seq, scale, softcap, window,
                   tree_anc, tree_prefix, alibi, static_cast<cudaStream_t>(stream)};
  if (alibi != nullptr) {
    if (tree_anc != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<false, true>(kv_dtype, head_dim, a);
  }
  if (tree_anc != nullptr) return dispatch<true, false>(kv_dtype, head_dim, a);
  return dispatch<false, false>(kv_dtype, head_dim, a);
}
