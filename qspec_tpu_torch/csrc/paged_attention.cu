// Paged attention for Hopper: decode (Q=1), QSpec verify (Q=k+1), the draft's
// Q=2 backfill step and chunked prefill, over the bf16 paged KV cache.
//
// Replaces the TPU kernel qspec_tpu/ops/attention_pallas.py:_paged_attn_kernel
// (entry paged_attention_pallas), its bf16 causal core: flash attention with
// an online softmax over the sequence's live pages, GQA rows
// G = (Hq / Hkv) * Q per kv head (Q minor), a causal mask by absolute
// position (query i of row b sits at q_start[b] + i).
//
// Layouts: q [B, Q, Hq, D] bf16; the layer's cache [P, 2, Hkv, S, D] bf16
// (K at index 0, V at 1; page 0 is the null page); block_tables [B, PPS]
// int32; ctx_lens [B] int32 (tokens including the new ones); out like q.
//
// What bounds it on the H100: every live K/V byte is read once per
// (sequence, kv head, query tile) and used for 4 operations per element per
// query row, so at decode and verify widths (G = 4..16 rows) it is bound by
// device-memory bytes; at prefill (G in the hundreds) by operations.
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
// Which warp takes a token depends only on the token's position, masked
// tokens contribute exact zeros, and the merge order is fixed, so a row's
// result does not depend on Q, on the other rows or on how far the block
// walks. Rows with ctx_len == 0 (padding) read nothing and write zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim (the cache's, 128-padded)
constexpr int kWarps = 4;
constexpr int kRows = 8;                // query rows per block
constexpr int kWarpTok = 16;            // tokens per warp per step
constexpr int kStep = kWarps * kWarpTok;  // tokens per block step
constexpr float kNegInf = -1e30f;

struct Smem {
  float q[kRows][kD + 4];               // pre-scaled queries
  union {
    struct {
      float k[kWarps][kWarpTok][kD + 1];  // +1: conflict-free token-per-lane reads
      float v[kWarps][kWarpTok][kD];
    } kv;
    float acc[kWarps][kRows][kD];       // per-warp P.V, for the final merge
  } u;
  float p[kWarps][kRows][kWarpTok];
  float alpha[kWarps][kRows];
  float m[kWarps][kRows];
  float l[kWarps][kRows];
};

__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kv,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ ctx_lens,
                       const int* __restrict__ q_start,
                       __nv_bfloat16* __restrict__ out, int Q, int Hq, int Hkv,
                       int S, int pages_per_seq, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int G = group * Q;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ctx = ctx_lens[b];
  const int qs = q_start[b];

  // query tile, pre-scaled, f32: 8 rows x 16 vectors of 8 = one per thread
  {
    const int rl = threadIdx.x / (kD / 8);
    const int c8 = threadIdx.x % (kD / 8);
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

  // per lane: score slot (row 2*rr + lane/16, token lane%16), rr = 0..3
  const int tok = lane & 15;
  const int half = lane >> 4;
  int qpos[kRows / 2];
#pragma unroll
  for (int rr = 0; rr < kRows / 2; ++rr) {
    const int r = row0 + 2 * rr + half;
    qpos[rr] = r < G ? qs + r % Q : -1;   // -1: row never live
  }
  float m_run[kRows / 2], l_run[kRows / 2];
#pragma unroll
  for (int rr = 0; rr < kRows / 2; ++rr) {
    m_run[rr] = kNegInf;
    l_run[rr] = 0.f;
  }
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const size_t head_stride = (size_t)S * kD;
  const size_t page_stride = 2 * (size_t)Hkv * head_stride;
  float (*ks)[kD + 1] = sm.u.kv.k[warp];
  float (*vs)[kD] = sm.u.kv.v[warp];

  for (int t0 = warp * kWarpTok; t0 < n_tok; t0 += kStep) {
    const int page = block_tables[(size_t)b * pages_per_seq + t0 / S];
    const int off = t0 % S;   // 16 tokens never straddle a page (S % 16 == 0)
    const __nv_bfloat16* kb = kv + (size_t)page * page_stride + h * head_stride + (size_t)off * kD;
    const __nv_bfloat16* vb = kb + (size_t)Hkv * head_stride;
#pragma unroll
    for (int it = 0; it < kWarpTok * (kD / 8) / 32; ++it) {
      const int idx = it * 32 + lane;
      const int tt = idx / (kD / 8);
      const int c8 = idx % (kD / 8);
      const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kb + tt * kD + c8 * 8));
      const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vb + tt * kD + c8 * 8));
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kr);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[tt][c8 * 8 + i] = __bfloat162float(ke[i]);
        vs[tt][c8 * 8 + i] = __bfloat162float(ve[i]);
      }
    }
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < kRows / 2; ++rr) {
      const int rl = 2 * rr + half;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) s = fmaf(sm.q[rl][d], ks[tok][d], s);
      const int kv_pos = t0 + tok;
      const bool live = kv_pos <= qpos[rr] && kv_pos < ctx;
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
      sm.p[warp][rl][tok] = p;
      if (tok == 0) sm.alpha[warp][rl] = alpha;
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float a = sm.alpha[warp][i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a;
#pragma unroll
      for (int tt = 0; tt < kWarpTok; ++tt) {
        const float p = sm.p[warp][i][tt];
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[tt][lane * 4]);
        acc[i][0] = fmaf(p, v4.x, acc[i][0]);
        acc[i][1] = fmaf(p, v4.y, acc[i][1]);
        acc[i][2] = fmaf(p, v4.z, acc[i][2]);
        acc[i][3] = fmaf(p, v4.w, acc[i][3]);
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
    *reinterpret_cast<float4*>(&sm.u.acc[warp][i][lane * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();

  // 8 rows x 128 dims: 8 consecutive dims per thread
  const int rl = threadIdx.x / (kD / 8);
  const int d0 = (threadIdx.x % (kD / 8)) * 8;
  const int r = row0 + rl;
  if (r >= G) return;
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

}  // namespace

// q [B, Q, Hq, 128] bf16; kv = the layer's [P, 2, Hkv, S, 128] bf16 pages;
// block_tables [B, pages_per_seq] int32; ctx_lens, q_start [B] int32;
// out [B, Q, Hq, 128] bf16. S % 16 == 0, Hq % Hkv == 0.
extern "C" int qspec_paged_attention(const void* q, const void* kv,
                                     const void* block_tables,
                                     const void* ctx_lens, const void* q_start,
                                     void* out, int B, int Q, int Hq, int Hkv,
                                     int S, int pages_per_seq, float scale,
                                     void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));   // above the 48 KB default
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int G = (Hq / Hkv) * Q;
  dim3 grid((G + kRows - 1) / kRows, Hkv, B);
  paged_attention_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int*>(block_tables), static_cast<const int*>(ctx_lens),
      static_cast<const int*>(q_start), static_cast<__nv_bfloat16*>(out), Q, Hq,
      Hkv, S, pages_per_seq, scale);
  return static_cast<int>(cudaGetLastError());
}
