"""Dual-scheme Llama: one packed-int4 parameter tree, two forwards.

Port of the dense-Llama path of ``qspec_tpu/models/llama.py``. The QSpec
property, the draft and the W4A16 verify sharing the same weight buffers, is
a ``scheme`` argument: the draft forward and the verify forward read the same
tensors; nothing is copied on a switch.

Per layer of a QuaRot checkpoint (``quant="w4"``, norms weightless):

    x - rmsnorm[+quant] - qkv(w4) - rope - paged KV write - attention
      - head Hadamard - [quant] - o(w4) - +residual
      - rmsnorm[+quant] - gate_up(w4) - silu*up - Hadamard(I) - [quant]
      - down(w4) - +residual

and of an AWQ / GPTQ checkpoint (``quant="w4g"``, W4A16 only: no rotations,
gamma norms, the grouped int4 GEMM ``matmul_w4a16_g``):

    x - rmsnorm(gamma) - qkv - rope - paged KV write - attention - o
      - +residual - rmsnorm(gamma) - gate_up - silu*up - down - +residual

On these rmsnorm graphs each "+residual" runs inside the norm after it
(``rmsnorm`` / ``rmsnorm_quant`` with ``residual``: one kernel forms
x + o, stores it and normalizes it), the last one inside the final norm; a
layer hands its ``down`` to the next unadded.

A float checkpoint (``quant="none"``: BLOOM, MPT, Falcon, JAIS) runs the
bf16 scheme, a plain bf16 GEMM with an f32 result per projection
(``jnp.dot`` in the JAX package, no Pallas kernel there either), with the
GPT-family knobs:

    x - [embed LayerNorm] - LayerNorm(+beta) - qkv(+b) - [clip] - paged KV
      write - attention with ALiBi (no rope) - o(+b) - +residual
      - LayerNorm(+beta) - fc1(+b) - gelu - fc2(+b) - +residual

and the parallel block (``parallel_block``: Falcon, GPT-J, GPT-NeoX, Phi,
Cohere), both branches reading the same residual x:

    x - LayerNorm - qkv - rope - attention - o ---------------+
      - (the same normed x, or under parallel_norms=2 a second  x + o + down
         LayerNorm of x) - fc1 - gelu - fc2 - down -----------+

Rope is neox (half-split pairs) or gptj (interleaved pairs: GPT-J, Cohere,
GLM, Helium) by ``cfg.rope_style``, over the cache's width: the whole head,
or its first ``cfg.rotary_dim`` dims (GPT-NeoX, Phi, GPT-J, StableLM, GLM,
Qwen v1's rotary_pct). A head bias (``params["lm_head_b"]``, Phi and GPT-J)
adds to the f32 logits last, after ``logits_scaling``; Cohere's LayerNorms
have no beta.

Gemma-2 (``arch="gemma2"``, served as ``quant="w4g"``) is the same w4g
graph with its own knobs, as in the JAX package: embeddings times
``embed_scale`` in bf16; the query scale ``query_pre_attn_scalar ** -0.5``
and the attention-logit softcap in the attention kernel; the post-attention
and post-feedforward norms on the block outputs before each residual add
(``layers["post_norm"]`` is then the MLP's pre-norm); GeGLU with the tanh
gelu; the final-logit softcap after the head.

The dense families ride the QuaRot, w4g and bf16 graphs above with their
config knobs: Qwen2's qkv bias, Qwen3's per-head q/k norms, Mistral's
window, Gemma's tanh GeGLU, embedding scale and (1+w) norms (folded at load,
so Gemma v1 takes QuaRot), Phi-3's longrope cache, and Granite's
``residual_multiplier`` on both block outputs (before the add the next norm
does) and ``logits_scaling`` dividing the final logits.

Attention runs under ``cfg.sliding_window`` on every layer, or under
Gemma-2's alternation on the layers ``li % sliding_window_pattern == 0``
(the others are global); the windowed draft's cfg sets a window with pattern
1.

Parameters are a plain dict with the JAX package's layout: ``embed`` [V, H]
bf16; ``lm_head`` by ``ModelConfig.lm_head_quant``: ``{"qw8": int8 [H, V],
"qs": f32 [V]}`` (int8, the default for w4), ``{"qw": int32 [H//8, V],
"qs"}`` (int4) or a dense bf16 [H, V]; ``layers[name] = {"qw": int32 [L, K//8, N],
"qs": f32 [L, N]}`` for qkv / o / gate_up / down; ``rope_cache``;
``hadamards``. A w4g tree has ``layers[name] = {"qw", "qs_g": f32
[L, K//g, N], "qo_g": f32 [L, K//g, N]}`` (model_loader/grouped.py), the
gammas ``layers["input_norm"]``, ``layers["post_norm"]`` bf16 [L, H] (with
``post_norms`` also ``layers["post_attn_norm"]``, ``layers["post_ffw_norm"]``)
and ``final_norm`` bf16 [H], and no Hadamards. A bf16 tree (``quant="none"``)
has ``layers[name] = {"w": bf16 [L, K, N]}`` with ``"b": bf16 [L, N]`` under
``linear_bias`` (BLOOM: every projection; MPT: none), the gammas, under
LayerNorm the betas ``layers["input_norm_b"]`` / ``["post_norm_b"]`` and
``final_norm_b`` where the checkpoint has them, BLOOM's ``embed_norm`` /
``embed_norm_b``, a bf16 head (tied: a view of ``embed``'s storage), its
bias ``lm_head_b`` bf16 [V] (Phi, GPT-J) and, under ALiBi, ``alibi_slopes`` f32 [Hq] and no rope cache. The layer-stacked
weights are read in place by the kernels (``layer_idx``).

A sparse-MoE model (``num_experts > 0``: Mixtral, Qwen2-MoE, Qwen3-MoE,
DeepSeek-MoE) replaces the MLP with :func:`_moe_block`; its layers hold
``router`` bf16 [L, H, E] (``router_bias`` f32 [L, E] under noaux_tc), the
expert stacks ``experts_gate_up`` / ``experts_down`` with a leading
[L, E] (``{"qw": int32 [L, E, K//8, N], "qs": f32 [L, E, N]}`` or
``{"w": bf16 [L, E, K, N]}``), and with a shared expert ``shared_gate_up``,
``shared_down`` and (gated) ``shared_gate`` bf16 [L, H, 1]; DeepSeek's dense
prefix is a stack of its own, ``params["layers_dense"]``. The qkv bias is
``layers["qkv"]["b"]`` under every scheme, Qwen3's per-head q/k gammas
``layers["q_norm"]`` / ``["k_norm"]`` [L, head_dim].

The Hadamard rotations are computed in float64: their ±1 sums of bf16
inputs are then exact, so the result does not depend on how the GEMM library
orders the sums for a given batch size. With the row-independent kernels this
keeps greedy QSpec output bit-identical to greedy AR output when the batch
shrinks in one run and not in the other.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.lora.layers import lora_delta
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.ops.attention import alibi_slopes, paged_attention
from qspec_tpu_torch.ops.hadamard import decompose_dim, hadamard_matrix
from qspec_tpu_torch.ops.linear_kernels import (matmul_w4a4, matmul_w4a16,
                                                matmul_w4a16_g, matmul_w8a16)
from qspec_tpu_torch.ops.packing import (quantize_weight_int4_torch,
                                         quantize_weight_int8_torch)
from qspec_tpu_torch.ops.quant import sym_dequant, sym_quant_int4, sym_quant_int8
from qspec_tpu_torch.ops.rmsnorm_quant import rmsnorm, rmsnorm_quant
from qspec_tpu_torch.ops.rotary import apply_rope, make_rope_cache

SCHEMES = ("w4a4", "w4a8", "w4a16", "bf16")
QUANT_ACT_SCHEMES = ("w4a4", "w4a8")  # draft schemes with quantized activations
PROJECTIONS = ("qkv", "o", "gate_up", "down")


class AttentionBatch(NamedTuple):
    """Attention metadata for one (B, Q) token block. ctx_lens include the
    Q new tokens; padded rows carry ctx_len 0 and slot 0 (the null page)."""

    positions: torch.Tensor     # [B, Q] int
    slot_mapping: torch.Tensor  # [B, Q] int flat kv slots
    block_tables: torch.Tensor  # [B, max_pages] int32
    ctx_lens: torch.Tensor      # [B] int32


def _linear(x, w, scheme, xq=None, li=None):
    """One projection by scheme; ``w`` holds the layer-stacked "qw"/"qs"
    (QuaRot), "qw"/"qs_g"/"qo_g" (grouped int4, W4A16 only), "w8"/"s8"
    (per-channel int8 or float8_e4m3fn, W4A16's slot only) or "w" (bf16:
    a float checkpoint, or ``quantize_float(bits=None)``'s rotated weights
    under W4A16), and a bias "b" where the checkpoint has one. ``li`` is a
    layer, or a (layer, expert) pair of the expert-stacked [L, E, ...]
    weights: the kernels read that slice in place."""
    if "w" in w:
        out = bf16_matmul(x, w["w"][li])
    elif "w8" in w:
        # per-channel byte weights, int8 or fp8 (compressed-tensors, quant="w8")
        out = matmul_w8a16(x, w["w8"], w["s8"], layer_idx=li)
    elif "qo_g" in w:
        out = matmul_w4a16_g(x, w["qw"], w["qs_g"], w["qo_g"], layer_idx=li)
    elif scheme == "w4a16":
        out = matmul_w4a16(x, w["qw"], w["qs"], layer_idx=li)
    else:
        out = matmul_w4a4(xq.values, xq.scales, w["qw"], w["qs"], layer_idx=li)
    if "b" in w:
        out = out + w["b"][li].to(out.dtype)
    return out


def _f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16 @ w [K, N] bf16 with an f32 result, a row's bits
    independent of M. On the card one GEMM with an f32 output (f32
    accumulation), its rows padded to a multiple of 128 so the GEMM library
    sees one shape for every decode and verify batch (these GEMMs are bound
    by their weight bytes, so the padding rows cost little); on the CPU in
    float64, whose sums of bf16 products are exact to far below f32."""
    if not x.is_cuda:
        return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
    m, n = x.shape[0], w.shape[1]
    m_pad = -(-max(m, 1) // 128) * 128
    xp = torch.nn.functional.pad(x, (0, 0, 0, m_pad - m))
    if n % 8:
        # a narrow weight (a router's E columns, the shared expert's gate)
        # padded to 8 columns, a width the GEMM library takes at every M
        w = torch.nn.functional.pad(w, (0, -n % 8))
    return torch.mm(xp, w, out_dtype=torch.float32)[:m, :n]


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 scheme's projection: ``jnp.dot(x, w,
    preferred_element_type=f32).astype(bf16)``."""
    return _f32_matmul(x, w).to(torch.bfloat16)


def layernorm(x, gamma, beta, eps):
    """Mean-subtracting LayerNorm with an optional bias, bf16 out
    (``qspec_tpu/models/llama.py::layernorm``; XLA in f32 there, torch ops
    here). The row statistics are taken in float64, where the mean of bf16
    inputs is exact and the variance within a few units of 2^-53 of it: a
    row's bf16 result then does not depend on how the reduction kernel
    splits its sums for the batch's row count. In float32 it did: on the
    card one GPT-J-6B row normed at 8 rows and at 16 came out a bf16 step
    apart, and greedy n-gram left its oracle."""
    x64 = x.to(torch.float64)
    xc = x64 - x64.mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    out = out.to(torch.float32) * gamma.to(torch.float32)
    if beta is not None:
        out = out + beta.to(torch.float32)
    return out.to(torch.bfloat16)


def _norm_maybe_quant(x, residual, gamma, eps, bits=None, beta=None,
                      norm_type="rmsnorm"):
    """(normed bf16 or None, quantized or None, h): h = x + residual (x
    when ``residual`` is None) is the residual stream, and the norm is h's.
    The rmsnorm kernels add the residual in their own pass; LayerNorm runs
    after a torch add. ``bits`` (4 or 8) quantizes the normed rows: the
    quantized-activation schemes run only on QuaRot checkpoints, whose norms
    are weightless; LayerNorm only on float ones."""
    if norm_type == "layernorm":
        h = x if residual is None else x + residual
        return layernorm(h, gamma, beta, eps), None, h
    if bits is None:
        out = rmsnorm(x, gamma, eps=eps, residual=residual)
    else:
        out = rmsnorm_quant(x, eps=eps, bits=bits, residual=residual)
    normed, h = (out, x) if residual is None else out
    return (None, normed, h) if bits else (normed, None, h)


def _add_lora(out, lora, name, x_fp, ids):
    """``out`` plus the per-token LoRA delta of target ``name``
    (``lora/layers.py``); ``x_fp`` is the projection's float input."""
    if lora is None:
        return out
    return out + lora_delta(x_fp, lora[name]["A"], lora[name]["B"], ids).to(out.dtype)


def _fp_input(xn, xq):
    """A projection's float input: the normed rows, or under the draft
    schemes the dequantized ones, as the JAX package's ``_fp_input``."""
    return xn if xn is not None else sym_dequant(xq)


def _act_quant(x, scheme):
    """Per-token activation quant at the scheme's bit width."""
    return sym_quant_int4(x) if scheme == "w4a4" else sym_quant_int8(x)


def _head_hadamard(attn, h_heads):
    """Mix across the head axis with H_{num_heads} / sqrt(num_heads)."""
    nh = attn.shape[1]
    out = torch.einsum("jh,thd->tjd", h_heads, attn.to(torch.float64))
    return (out * (1.0 / math.sqrt(nh))).to(attn.dtype).contiguous()


def _mlp_hadamard(x, hK, hP):
    """(H_K (x) H_P) / sqrt(n) over the intermediate dim (ops/hadamard.py)."""
    n = x.shape[-1]
    K = hK.shape[0]
    P = n // K
    xf = x.to(torch.float64).reshape(x.shape[0], K, P)
    xf = torch.matmul(xf, hP)
    if K > 1:
        xf = torch.einsum("jk,tkp->tjp", hK, xf)
    return (xf.reshape(x.shape) * (1.0 / math.sqrt(n))).to(x.dtype).contiguous()


def _glu_act(gate, up, hidden_act: str):
    """Gated-MLP activation in f32: silu (llama) or the tanh-approximate
    gelu (gemma's GeGLU)."""
    g32 = gate.to(torch.float32)
    a = (torch.nn.functional.silu(g32) if hidden_act == "silu"
         else torch.nn.functional.gelu(g32, approximate="tanh"))
    return (a * up.to(torch.float32)).to(torch.bfloat16)


def _plain_act(x, hidden_act: str):
    """Non-gated MLP activation in f32, bf16 out: the exact gelu (MPT), the
    tanh-approximate one (BLOOM) or silu."""
    x32 = x.to(torch.float32)
    if hidden_act == "gelu":
        a = torch.nn.functional.gelu(x32)
    elif hidden_act == "gelu_tanh":
        a = torch.nn.functional.gelu(x32, approximate="tanh")
    else:
        a = torch.nn.functional.silu(x32)
    return a.to(torch.bfloat16)


def _head_rmsnorm(x, gamma, eps):
    """Qwen3's per-head RMSNorm of q or k ([T, heads, head_dim], gamma
    [head_dim]) in f32, in x's dtype out: the JAX package's ``rmsnorm_ref``,
    plain ops there too."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * gamma.to(torch.float32)).to(x.dtype)


def _topk(v: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, descending,
    the lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` on the card promises no order on ties)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_combine(logits: torch.Tensor, cfg: ModelConfig, router_bias=None) -> torch.Tensor:
    """The router's combine matrix [T, E] f32 from its logits [T, E] f32:
    each token's weight on each expert, zero off its top k, by
    ``cfg.moe_routing`` (``qspec_tpu/models/llama.py::_moe_block``'s
    router):

    - "topk": top-k of the logits, then a softmax over the winners
      (Mixtral); with ``moe_softmax_before_topk`` a softmax over all experts,
      then the top k, renormalized under ``moe_norm_topk_prob`` (Qwen2-MoE,
      Qwen3-MoE, DeepSeek-MoE);
    - "sparsemixer" (Phi-3.5-MoE, top-2): per pick, the softmax over the
      experts within 2 * 0.01 (relative) of the max, at the argmax; the
      second pick repeats with the first expert removed;
    - "noaux_tc" (DeepSeek-V3): sigmoid scores, plus ``router_bias`` for the
      selection only, top-k inside the ``moe_topk_group`` groups (of
      ``moe_n_group``) with the largest top-2 sums; the weights are the
      unbiased scores, renormalized under ``moe_norm_topk_prob``."""
    T, E = logits.shape
    k = cfg.num_experts_per_tok
    if cfg.moe_routing == "sparsemixer":
        if k != 2:
            raise ValueError("sparsemixer routing is top-2")
        eps = 0.01
        i1 = logits.argmax(dim=-1, keepdim=True)
        mx1 = logits.amax(dim=-1, keepdim=True)
        m1 = ((mx1 - logits) / torch.maximum(logits.abs(), mx1)) > 2 * eps
        w1 = torch.softmax(logits.masked_fill(m1, -math.inf), dim=-1).gather(1, i1)
        masked = logits.scatter(1, i1, -math.inf)
        i2 = masked.argmax(dim=-1, keepdim=True)
        mx2 = masked.amax(dim=-1, keepdim=True)
        m2 = ((mx2 - logits) / torch.maximum(logits.abs(), mx2)) > 2 * eps
        w2 = torch.softmax(masked.masked_fill(m2, -math.inf), dim=-1).gather(1, i2)
        w, topi = torch.cat([w1, w2], dim=-1), torch.cat([i1, i2], dim=-1)
    elif cfg.moe_routing == "noaux_tc":
        scores = torch.sigmoid(logits)
        biased = scores + router_bias.to(torch.float32)[None]
        gsz = E // cfg.moe_n_group
        g_rank = _topk(biased.reshape(T, cfg.moe_n_group, gsz), 2)[0].sum(dim=-1)
        gi = _topk(g_rank, cfg.moe_topk_group)[1]
        gmask = torch.zeros((T, cfg.moe_n_group), dtype=torch.bool, device=logits.device)
        allowed = gmask.scatter(1, gi, True).repeat_interleave(gsz, dim=-1)
        topi = _topk(biased.masked_fill(~allowed, -math.inf), k)[1]
        w = scores.gather(1, topi)
        if cfg.moe_norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    elif cfg.moe_softmax_before_topk:
        w, topi = _topk(torch.softmax(logits, dim=-1), k)
        if cfg.moe_norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
    else:
        topv, topi = _topk(logits, k)
        w = torch.softmax(topv, dim=-1)
    return torch.zeros((T, E), dtype=torch.float32,
                       device=logits.device).scatter_add_(1, topi, w)


def _expert_mlp(xn, xq, gate_up, down, idx, scheme, cfg: ModelConfig, hK, hP):
    """One expert's (or the shared expert's) gated MLP over every token:
    gate_up, GLU, under QuaRot the intermediate Hadamard (``hK``, ``hP``)
    and, under the draft schemes, the activation quant before down.
    ``idx``: (layer, expert) of the expert-stacked weights, or the layer."""
    gu = _linear(xn, gate_up, scheme, xq, idx)
    i_size = gu.shape[-1] // 2
    act = _glu_act(gu[:, :i_size], gu[:, i_size:], cfg.hidden_act)
    if hK is not None:
        act = _mlp_hadamard(act, hK, hP)
    if scheme in QUANT_ACT_SCHEMES:
        return _linear(None, down, scheme, _act_quant(act, scheme), idx)
    return _linear(act, down, scheme, li=idx)


def _moe_block(xn, xq, layers, li: int, cfg: ModelConfig, scheme: str, hadamards):
    """The sparse-MoE MLP (``qspec_tpu/models/llama.py::_moe_block``):
    returns the residual delta [T, H] f32.

    The router and the shared expert's gate read the float hidden: the
    normed rows, or under the draft schemes the dequantized ``xq`` (so a
    draft may route a token otherwise than the verify, as in the JAX
    package); the router GEMM goes through :func:`_f32_matmul`, whose rows
    do not depend on the batch. Every token then goes through every expert,
    in index order, weighted by its column of the combine matrix and summed
    in f32: no expert is skipped and no row gathered, so nothing is read
    back to the host and each GEMM sees the same rows at every routing.
    The expert weights are the stacked [L, E, ...] tensors, read in place
    per (layer, expert). Then ``routed_scaling_factor``, then the shared
    expert, gated by sigmoid(x @ shared_gate) (Qwen2-MoE) or not
    (DeepSeek)."""
    x_fp = xn if xn is not None else sym_dequant(xq)
    logits = _f32_matmul(x_fp, layers["router"][li])
    combine = moe_combine(logits, cfg, layers["router_bias"][li]
                          if cfg.moe_routing == "noaux_tc" else None)
    quarot = cfg.quant == "w4"
    hK, hP = (hadamards["mlp_K"], hadamards["mlp_P"]) if quarot else (None, None)
    delta = torch.zeros((x_fp.shape[0], cfg.hidden_size), dtype=torch.float32,
                        device=x_fp.device)
    for e in range(cfg.num_experts):
        d = _expert_mlp(xn, xq, layers["experts_gate_up"], layers["experts_down"], (li, e),
                        scheme, cfg, hK, hP)
        delta = delta + d.to(torch.float32) * combine[:, e:e + 1]
    if cfg.routed_scaling_factor != 1.0:
        delta = delta * cfg.routed_scaling_factor
    if cfg.shared_expert_intermediate_size:
        sK, sP = (hadamards["shared_K"], hadamards["shared_P"]) if quarot else (None, None)
        se = _expert_mlp(xn, xq, layers["shared_gate_up"], layers["shared_down"], li,
                         scheme, cfg, sK, sP).to(torch.float32)
        if cfg.shared_expert_gated:
            se = torch.sigmoid(_f32_matmul(x_fp, layers["shared_gate"][li])) * se
        delta = delta + se
    return delta


def layer_window(cfg: ModelConfig, li: int) -> Optional[int]:
    """The sliding window of layer ``li``: ``cfg.sliding_window`` on every
    layer, or with Gemma-2's alternation only on the layers
    ``li % sliding_window_pattern == 0`` (None: global attention)."""
    if cfg.sliding_window is None or li % cfg.sliding_window_pattern:
        return None
    return cfg.sliding_window


def _mla_attention(xn, layers, wi: int, li: int, cfg: ModelConfig, cache,
                   batch: AttentionBatch, rope_cache):
    """DeepSeek-V2's multi-head latent attention in the weight-absorbed
    form (``qspec_tpu/models/llama.py::_mla_attention``; DeepSeek-V2 / V3,
    MiniCPM3), bf16 weights: the q projection (direct, or q_a, its RMSNorm
    and q_b: q-LoRA), the latent ``kv_a`` = [c_kv | k_pe] with c_kv's
    RMSNorm (the ``rmsnorm`` kernel), rope on the decoupled dims in the
    gptj pairing, W_UK absorbed into the query (q_nope . W_UK over each
    head) and W_UV applied after the attention, which runs as MQA over one
    latent row a token: K = [c_kv, k_pe, 0...], V = [c_kv, 0...], the query
    [q_abs, q_pe, 0...], scale (qk_nope + qk_rope) ** -0.5, the kernel
    reading only the K lanes r + dr and the V lanes r. The JAX package takes
    the two absorption einsums in f32; here they are float64 sums of the
    bf16 operands, rounded to f32 (exact to far below an f32 step, so a
    row's bits do not depend on the batch, which cuBLAS's f32 algorithm
    choice by M would break). Returns the block's output [T, hidden]."""
    T = xn.shape[0]
    B, Q = batch.positions.shape
    nh, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    eps = cfg.rms_norm_eps
    if cfg.q_lora_rank:
        qa = _linear(xn, layers["mla_q_a"], "bf16", li=wi)
        q = _linear(rmsnorm(qa, layers["mla_q_norm"][wi], eps=eps), layers["mla_q_b"],
                    "bf16", li=wi)
    else:
        q = _linear(xn, layers["mla_q"], "bf16", li=wi)
    q = q.reshape(T, nh, dn + dr)
    kv_a = _linear(xn, layers["mla_kv_a"], "bf16", li=wi)           # [T, r + dr]
    c_kv = rmsnorm(kv_a[:, :r].contiguous(), layers["mla_kv_norm"][wi], eps=eps)
    q_pe, k_pe = apply_rope(q[..., dn:], kv_a[:, None, r:], batch.positions.reshape(-1),
                            rope_cache, "gptj")
    w_kb = layers["mla_kv_b"][wi].to(torch.float64)                 # [r, nh, dn + dv]
    q_abs = torch.einsum("thd,rhd->thr", q[..., :dn].to(torch.float64),
                         w_kb[..., :dn]).to(torch.float32)          # [T, nh, r]
    qk = torch.cat([q_abs, q_pe.to(torch.float32)], dim=-1).to(torch.bfloat16)
    k_row = torch.cat([c_kv, k_pe[:, 0]], dim=-1)[:, None]           # [T, 1, r + dr]
    v_row = torch.nn.functional.pad(c_kv, (0, dr))[:, None]
    kvc.update_layer(cache, li, k_row, v_row, batch.slot_mapping.reshape(-1))
    attn = paged_attention(qk.reshape(B, Q, nh, r + dr).contiguous(), cache, li,
                           batch.block_tables, batch.ctx_lens, (dn + dr) ** -0.5,
                           q_positions=batch.positions, lanes=(r + dr, r))
    lat = attn.reshape(T, nh, r + dr)[..., :r]
    out = torch.einsum("thr,rhd->thd", lat.to(torch.float64), w_kb[..., dn:])
    return _linear(out.reshape(T, nh * dv).to(torch.bfloat16), layers["o"], "bf16", li=wi)


def float_knobs(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` takes a knob of the GPT-family float graph: LayerNorm,
    the non-gated MLP, ALiBi, linear biases, clip_qkv or the parallel
    block."""
    return (cfg.norm_type != "rmsnorm" or not cfg.mlp_gated or cfg.linear_bias
            or cfg.position_embedding != "rope" or cfg.clip_qkv is not None
            or cfg.parallel_block)


def check_served(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not serve: Gemma-2 comes
    only as a grouped-int4 checkpoint (the QuaRot pipeline's gamma folding
    does not compose with its post-block norms, as in the JAX package); the
    float families' knobs come only with bf16 weights (the JAX package
    serves BLOOM and MPT as float checkpoints); an MoE comes as a QuaRot
    (w4) or a float checkpoint, and under QuaRot a dense prefix only of the
    experts' width; multi-head latent attention comes with bf16 weights
    only and under no window, softcap or ALiBi (as the JAX package builds
    it: its _mla_attention passes none of them to the attention)."""
    if cfg.arch == "gemma2" and cfg.quant != "w4g":
        raise NotImplementedError("Gemma-2 is served as an AWQ / GPTQ "
                                  "(quant='w4g') checkpoint only; QuaRot w4 "
                                  "does not compose with its post-block norms")
    if float_knobs(cfg) and cfg.quant != "none":
        raise NotImplementedError("LayerNorm, the non-gated MLP, ALiBi, linear "
                                  "biases, clip_qkv and the parallel block are "
                                  "served with bf16 weights (quant='none') only")
    if cfg.num_experts and cfg.quant == "w4g":
        raise NotImplementedError("an AWQ / GPTQ (quant='w4g') MoE is not ported: the "
                                  "JAX package's grouped loaders have no experts")
    if cfg.quant == "w8" and (cfg.num_experts or cfg.arch == "gemma2"):
        raise NotImplementedError(
            f"a compressed-tensors int8 / fp8 (quant='w8') {cfg.arch} is not ported "
            "(ROADMAP queue 1 item 9): the JAX package's _load_channelwise reads dense "
            "llama-keyed layers only, no expert and no Gemma-2 post-block norm")
    if cfg.attention_type == "mla":
        if cfg.quant != "none":
            raise NotImplementedError(
                f"multi-head latent attention (DeepSeek-V2 / V3, MiniCPM3) at quant="
                f"{cfg.quant!r}: served in bf16 (quant='none') only, as the JAX package "
                "builds it (QuaRot's rotations do not extend to the latent factorization)")
        knobs = {"a sliding window": cfg.sliding_window is not None,
                 "a logit softcap": cfg.attn_logit_softcap is not None,
                 "ALiBi": cfg.position_embedding != "rope"}
        bad = [k for k, on in knobs.items() if on]
        if bad:
            raise NotImplementedError(
                f"multi-head latent attention under {', '.join(bad)}: the JAX package's "
                "_mla_attention passes none to its attention, and the port's MLA kernel "
                "takes none")
    if (cfg.num_experts and cfg.first_k_dense and cfg.quant == "w4"
            and cfg.intermediate_size != cfg.expert_intermediate_size):
        raise NotImplementedError(
            f"QuaRot (quant='w4') with a dense prefix (first_k_dense={cfg.first_k_dense}) "
            f"whose MLP width {cfg.intermediate_size} differs from the experts' "
            f"{cfg.expert_intermediate_size}: one intermediate Hadamard, of the experts' "
            "width, would rotate both (the JAX package's make_hadamards and "
            "quantize_float fail on this shape); serve DeepSeek-MoE in bf16 "
            "(quantization=None)")


def decoder_layer(x, addend, layers, cache, li: int, cfg: ModelConfig,
                  batch: AttentionBatch, rope_cache, hadamards, scheme: str,
                  tree=None, alibi=None, wi: Optional[int] = None, lora=None,
                  lora_ids=None):
    """One decoder layer. x: [T, hidden] bf16, and ``addend`` [T, hidden]
    bf16 or None: the previous layer's MLP output, not yet added to x (the
    layer's input is x + addend, added inside its input norm); ``layers``
    is the layer-stacked param dict and ``li`` selects both the weight layer
    and the KV-cache layer; ``tree``: the Medusa tree mask of the attention
    (ops/attention.py); ``alibi``: the [Hq] f32 ALiBi slopes, in place of
    rope; ``wi``: the weight layer, where ``layers`` is one segment of the
    model (DeepSeek's dense prefix, its MoE rest; default ``li``), ``li``
    still the KV-cache layer; ``lora``: the layer's slice of the adapter
    bank ({target: {"A": [n, in, r], "B": [n, r, out]}}) and ``lora_ids``
    [T] each token's slot, whose deltas add to qkv, o, gate_up and down
    (on their float inputs: the normed or dequantized rows, the
    head-mixed attention, the Hadamard-mixed activation). Returns (x, down,
    cache): the layer's output is x + down (under MoE the routed delta in
    bf16), left for the next norm to add; the cache is written in place."""
    wi = li if wi is None else wi
    B, Q = batch.positions.shape
    T = B * Q
    eps = cfg.rms_norm_eps
    quant_act = scheme in QUANT_ACT_SCHEMES
    bits = {"w4a4": 4, "w4a8": 8}.get(scheme)
    quarot = cfg.quant == "w4"
    gamma_in = None if quarot else layers["input_norm"][wi]
    # a parallel block of one norm has no post-attention norm
    gamma_post = None if quarot or "post_norm" not in layers else layers["post_norm"][wi]
    beta_in, beta_post = (layers[n][wi] if n in layers else None
                          for n in ("input_norm_b", "post_norm_b"))

    xn, xq, x = _norm_maybe_quant(x, addend, gamma_in, eps, bits, beta_in, cfg.norm_type)
    if cfg.attention_type == "mla":
        # DeepSeek-V2's latent attention (bf16 weights; _mla_attention)
        if tree is not None:
            raise NotImplementedError(
                "the Medusa tree mask on multi-head latent attention: the JAX package's "
                "_mla_attention passes no tree to its attention, so its tree verify "
                "would ignore the mask; the port refuses it")
        o = _mla_attention(xn, layers, wi, li, cfg, cache, batch, rope_cache)
    else:
        qkv = _add_lora(_linear(xn, layers["qkv"], scheme, xq, wi), lora, "qkv",
                        _fp_input(xn, xq) if lora is not None else None, lora_ids)
        if cfg.clip_qkv is not None:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], dim=-1)
        q = q.reshape(T, cfg.num_heads, cfg.head_dim)
        k = k.reshape(T, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(T, cfg.num_kv_heads, cfg.head_dim).to(torch.bfloat16)
        if cfg.qk_norm:
            q = _head_rmsnorm(q, layers["q_norm"][wi], eps)
            k = _head_rmsnorm(k, layers["k_norm"][wi], eps)
        if alibi is None:
            q, k = apply_rope(q, k, batch.positions.reshape(-1), rope_cache, cfg.rope_style)
        q = q.to(torch.bfloat16)
        k = k.to(torch.bfloat16)

        kvc.update_layer(cache, li, k, v, batch.slot_mapping.reshape(-1))
        attn = paged_attention(q.reshape(B, Q, cfg.num_heads, cfg.head_dim).contiguous(),
                               cache, li, batch.block_tables, batch.ctx_lens,
                               (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5,
                               q_positions=batch.positions, window=layer_window(cfg, li),
                               softcap=cfg.attn_logit_softcap, alibi=alibi, tree=tree)
        attn = attn.reshape(T, cfg.num_heads, cfg.head_dim)
        if quarot:
            attn = _head_hadamard(attn, hadamards["heads"])
        attn_flat = attn.reshape(T, cfg.q_size)
        if quant_act:
            o = _linear(None, layers["o"], scheme, _act_quant(attn_flat, scheme), wi)
        else:
            o = _linear(attn_flat, layers["o"], scheme, li=wi)
        o = _add_lora(o, lora, "o", attn_flat, lora_ids)
    if cfg.post_norms:
        # Gemma-2's post-attention norm, on the block output before the add
        o = rmsnorm(o.to(torch.bfloat16), layers["post_attn_norm"][wi], eps=eps)
    if cfg.residual_multiplier != 1.0:
        # Granite scales each block's output before the residual add
        o = o * cfg.residual_multiplier

    if cfg.parallel_block:
        # the MLP reads the layer's input too: the attention's normed rows,
        # or its own norm of them (Falcon-40B's ln_mlp); x + o now, the
        # down by the next norm, as the JAX package's (x + o) + down rounds
        if cfg.parallel_norms == 2:
            xn, xq, _ = _norm_maybe_quant(x, None, gamma_post, eps, bits, beta_post,
                                          cfg.norm_type)
        x = x + o.to(x.dtype)
    else:
        xn, xq, x = _norm_maybe_quant(x, o.to(x.dtype), gamma_post, eps, bits, beta_post,
                                      cfg.norm_type)
    if cfg.num_experts:
        delta = _moe_block(xn, xq, layers, wi, cfg, scheme, hadamards)
        if cfg.residual_multiplier != 1.0:
            delta = delta * cfg.residual_multiplier
        return x, delta.to(x.dtype), cache
    gate_up = _add_lora(_linear(xn, layers["gate_up"], scheme, xq, wi), lora, "gate_up",
                        _fp_input(xn, xq) if lora is not None else None, lora_ids)
    if cfg.mlp_gated:
        i_size = gate_up.shape[-1] // 2
        act = _glu_act(gate_up[:, :i_size], gate_up[:, i_size:], cfg.hidden_act)
    else:
        # fc1 -> act -> fc2: "gate_up" holds fc1 [H, I]
        act = _plain_act(gate_up, cfg.hidden_act)
    if quarot:
        act = _mlp_hadamard(act, hadamards["mlp_K"], hadamards["mlp_P"])
    if quant_act:
        down = _linear(None, layers["down"], scheme, _act_quant(act, scheme), wi)
    else:
        down = _linear(act, layers["down"], scheme, li=wi)
    down = _add_lora(down, lora, "down", act, lora_ids)
    if cfg.post_norms:
        down = rmsnorm(down.to(torch.bfloat16), layers["post_ffw_norm"][wi], eps=eps)
    if cfg.residual_multiplier != 1.0:
        down = down * cfg.residual_multiplier
    return x, down.to(x.dtype), cache


def layer_segments(cfg: ModelConfig):
    """(params key, cfg, KV-cache layer, weight layer) of each layer in
    order, by the stacks of :func:`layer_stacks`: DeepSeek-MoE's dense prefix
    (``params["layers_dense"]``, served with the cfg's dense MLP) first, then
    the rest from ``params["layers"]`` (the JAX package's two scan
    segments); one segment for every other model."""
    li = 0
    for key, L, moe in layer_stacks(cfg):
        seg_cfg = cfg if moe == bool(cfg.num_experts) else dataclasses.replace(cfg, num_experts=0)
        for wi in range(L):
            yield key, seg_cfg, li + wi, wi
        li += L


def embed_rows(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of a token tensor [...] -> [..., H] bf16. Gemma
    scales them by sqrt(hidden) in the hidden dtype: the scale is rounded to
    bf16 first, as the JAX package rounds it."""
    x = params["embed"][tokens.reshape(-1).to(torch.int64)].to(torch.bfloat16)
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    return x.reshape(*tokens.shape, x.shape[-1])


def model_forward(params, cfg: ModelConfig, token_ids: torch.Tensor,
                  cache: kvc.PagedKVCache, batch: AttentionBatch, *,
                  scheme: str = "w4a16",
                  logits_indices: Optional[torch.Tensor] = None,
                  return_hidden=False, tree=None, lora_ids: Optional[torch.Tensor] = None,
                  input_embeds: Optional[torch.Tensor] = None,
                  embeds_rows: Optional[torch.Tensor] = None):
    """Full forward. token_ids: [B, Q] -> (logits [B, Q, V] f32, cache).

    ``logits_indices`` [B]: compute logits only at one query index per row
    (prefill needs only the last prompt position); the output is then
    [B, 1, V]. ``return_hidden``: (logits, hidden, cache), the
    post-final-norm hidden state beside the logits (a QuaRot checkpoint's
    stays in the rotated basis; the Medusa heads and the EAGLE net read it),
    at the positions of the logits; ``"all"``: at every position ([B, Q, H])
    even under ``logits_indices`` (EAGLE's prefill; the norm is one row at
    a time, so the rows at ``logits_indices`` are those the gathered form
    gives). ``tree``: an ops.attention.TreeMask; every layer's attention
    runs under the Medusa tree mask (the tree-verify rectangle).

    ``lora_ids`` [B]: each row's adapter slot in ``params["lora"]``
    (``lora/layers.py``; 0 the base), for every token of the row; None
    runs no adapter. ``input_embeds`` [B, Q, H]: embedding rows given by
    the caller (prompt embeddings, soft prompts) in place of the table's,
    at the positions ``embeds_rows`` [B, Q] flags (all of them when None);
    they are taken as they are, after the embedding scale.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {SCHEMES}")
    if (scheme == "bf16") != (cfg.quant == "none"):
        raise ValueError(f"scheme {scheme!r} on a quant={cfg.quant!r} checkpoint: "
                         "the bf16 scheme serves float (quant='none') checkpoints, "
                         "and only it does")
    if scheme in QUANT_ACT_SCHEMES and cfg.quant in ("w4g", "w8"):
        # no QuaRot rotations: quantized activations would be
        # outlier-dominated; only W4A16's slot (weight-only dequant) serves
        raise ValueError("w4a4/w4a8 drafting requires a QuaRot (quant='w4') "
                         "checkpoint; AWQ/GPTQ/compressed-tensors (w4g/w8) models "
                         "are weight-only-quant")
    check_served(cfg)
    B, Q = token_ids.shape
    x = embed_rows(params, cfg, token_ids.reshape(-1))
    if input_embeds is not None:
        ie = input_embeds.reshape(B * Q, -1).to(torch.bfloat16)
        x = ie if embeds_rows is None else torch.where(embeds_rows.reshape(B * Q, 1), ie, x)
    tok_lora = None
    if lora_ids is not None and "lora" in params:
        if cfg.num_experts:
            raise NotImplementedError("LoRA on a mixture-of-experts model is not ported: "
                                      "the JAX package applies no adapter to its experts")
        if cfg.attention_type == "mla":
            raise NotImplementedError("LoRA on a multi-head latent attention model is not "
                                      "ported: the JAX package's _mla_attention applies "
                                      "no adapter")
        tok_lora = lora_ids.to(torch.int64).repeat_interleave(Q)
    if "embed_norm" in params:
        # BLOOM's word_embeddings_layernorm, before layer 0
        x = layernorm(x, params["embed_norm"], params["embed_norm_b"], cfg.rms_norm_eps)
    alibi = params["alibi_slopes"] if cfg.position_embedding == "alibi" else None
    addend = None
    for key, seg_cfg, li, wi in layer_segments(cfg):
        lora = None if tok_lora is None else {
            t: {"A": ab["A"][li], "B": ab["B"][li]}
            for t, ab in params["lora"]["layers"].items()}
        x, addend, cache = decoder_layer(x, addend, params[key], cache, li, seg_cfg, batch,
                                         params.get("rope_cache"), params.get("hadamards"),
                                         scheme, tree, alibi, wi, lora, tok_lora)
    flat = None
    if logits_indices is not None:
        flat = logits_indices.to(torch.int64) + torch.arange(B, device=x.device) * Q
        if return_hidden != "all":
            x, addend = x[flat], addend[flat]
    # the last layer's add, inside the final norm
    x, _, _ = _norm_maybe_quant(x, addend, None if cfg.quant == "w4" else params["final_norm"],
                                cfg.rms_norm_eps, beta=params.get("final_norm_b"),
                                norm_type=cfg.norm_type)
    hidden = x.reshape(B, -1, x.shape[-1])
    if flat is not None and return_hidden == "all":
        x = x[flat]
    logits = compute_logits(x, params["lm_head"], cfg.vocab_size)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    if cfg.logits_scaling:
        # Granite divides the final logits by logits_scaling (Cohere's
        # logit_scale, JAIS's width scale ride it too)
        logits = logits / cfg.logits_scaling
    if "lm_head_b" in params:
        # Phi's and GPT-J's head bias, last, as the JAX package adds it
        logits = logits + params["lm_head_b"].to(torch.float32)
    logits = logits.reshape(B, -1, logits.shape[-1])
    if return_hidden:
        return logits, hidden, cache
    return logits, cache


def compute_logits(x: torch.Tensor, lm_head, vocab: Optional[int] = None) -> torch.Tensor:
    """Vocab projection -> f32 logits. ``lm_head`` is a quantized dict
    (``{"qw8", "qs"}``: int8 by ``matmul_w8a16``; ``{"qw", "qs"}``: packed
    int4 by ``matmul_w4a16``) or a dense bf16 [H, V] array (a tied head:
    a transposed view of the embedding), by :func:`_f32_matmul`, so a row's
    logits do not depend on the batch size. The quantized heads' kernels are
    row-independent by design. A quantized head stored wider than the
    vocabulary (:func:`_make_lm_head`) is sliced back to ``vocab`` columns.
    """
    if isinstance(lm_head, dict):
        if "qw8" in lm_head:
            out = matmul_w8a16(x, lm_head["qw8"], lm_head["qs"], out_dtype=torch.float32)
        else:
            out = matmul_w4a16(x, lm_head["qw"], lm_head["qs"], out_dtype=torch.float32)
        return out if vocab is None or out.shape[-1] == vocab else out[:, :vocab]
    return _f32_matmul(x, lm_head)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def make_hadamards(cfg: ModelConfig, device=None):
    """The constant Hadamard factors (float64, see the module docstring):
    ``mlp_K`` / ``mlp_P`` over the MLP's intermediate width (an MoE's
    expert width), ``shared_K`` / ``shared_P`` over the shared expert's."""
    def t(n):
        return torch.as_tensor(hadamard_matrix(n), dtype=torch.float64,
                               device=device)

    K, P = decompose_dim(cfg.expert_intermediate_size if cfg.num_experts
                         else cfg.intermediate_size)
    h = {"heads": t(cfg.num_heads), "mlp_K": t(K), "mlp_P": t(P)}
    if cfg.shared_expert_intermediate_size:
        Ks, Ps = decompose_dim(cfg.shared_expert_intermediate_size)
        h.update(shared_K=t(Ks), shared_P=t(Ps))
    return h


def _proj_shapes(cfg: ModelConfig):
    """(K, N) of a dense layer's projections; multi-head latent attention's
    in place of qkv: the q projection (``mla_q``, or under q-LoRA
    ``mla_q_a`` and ``mla_q_b``), ``mla_kv_a`` (the latent and the rope
    key) and ``o`` over the heads' v dims."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    mlp = {"gate_up": (H, 2 * I), "down": (I, H)}
    if cfg.attention_type == "mla":
        nh, qd = cfg.num_heads, cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        q = ({"mla_q_a": (H, cfg.q_lora_rank), "mla_q_b": (cfg.q_lora_rank, qd)}
             if cfg.q_lora_rank else {"mla_q": (H, qd)})
        return {**q, "mla_kv_a": (H, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                "o": (nh * cfg.v_head_dim, H), **mlp}
    return {"qkv": (H, cfg.qkv_out), "o": (cfg.q_size, H), **mlp}


def layer_projections(cfg: ModelConfig, moe: bool):
    """name -> (expert dims, K, N) of the projections of a layer: the
    attention's, then a dense layer's MLP (gate_up [H, I] when not gated)
    or an MoE layer's (``moe``): the experts' stacked [E, ...] and the
    shared expert's."""
    shapes = {name: ((), k, n) for name, (k, n) in _proj_shapes(cfg).items()}
    H = cfg.hidden_size
    if moe:
        del shapes["gate_up"], shapes["down"]
        Ie, Is = cfg.expert_intermediate_size, cfg.shared_expert_intermediate_size
        E = (cfg.num_experts,)
        shapes.update(experts_gate_up=(E, H, 2 * Ie), experts_down=(E, Ie, H))
        if Is:
            shapes.update(shared_gate_up=((), H, 2 * Is), shared_down=((), Is, H))
    elif not cfg.mlp_gated:
        shapes["gate_up"] = ((), H, cfg.intermediate_size)
    return shapes


def layer_stacks(cfg: ModelConfig):
    """(params key, layers, MoE) of each layer stack: DeepSeek's dense
    prefix in "layers_dense", the rest in "layers"."""
    kd = cfg.first_k_dense if cfg.num_experts else 0
    out = [("layers", cfg.num_layers - kd, bool(cfg.num_experts))]
    return ([("layers_dense", kd, False)] if kd else []) + out


def resolve_device(device) -> torch.device:
    """The entry points' device: "cuda" unless the caller asks for the CPU;
    a CUDA device with no card present raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


HEAD_KINDS = ("bf16", "int8", "int4")


def _head_kind(cfg: ModelConfig) -> str:
    kind = cfg.resolved_lm_head_quant
    if kind not in HEAD_KINDS:
        raise ValueError(f"lm_head_quant={cfg.lm_head_quant!r}: not one of "
                         f"'auto', {', '.join(map(repr, HEAD_KINDS))}")
    return kind


def pack_lm_head(w, cfg: ModelConfig, device=None):
    """The lm_head per ``cfg.lm_head_quant`` (the JAX package's
    ``pack_lm_head``): w [H, V] float, a numpy array or a tensor (a
    transposed view too), packed on ``device`` (default: the tensor's, or
    the CPU for an array) into contiguous tensors, as the kernels read them."""
    return _make_lm_head(_f32_tensor(w, device).contiguous(), _head_kind(cfg))


def _f32_tensor(w, device=None) -> torch.Tensor:
    """A float32 tensor of ``w`` (numpy array or tensor) on ``device``
    (default: the tensor's own, or the CPU for an array). A tensor moves in
    its own dtype and widens there (exact either way): a bf16 checkpoint
    tensor crosses to the card at half the bytes, and the host does no
    conversion."""
    if not isinstance(w, torch.Tensor):
        w = torch.as_tensor(np.asarray(w, np.float32))
    return w.to(device=w.device if device is None else device).to(torch.float32)


def pack_proj_weight(w, cfg_quant: str, *, col_blocks=None, bias=None,
                     dtype=torch.bfloat16, device=None) -> dict:
    """One projection's parameters from a float [in, out] weight (numpy or
    a tensor, packed on ``device``, default the tensor's): ``cfg_quant``
    "w4" gives ``{"qw": int32 [in // 8, out], "qs": f32 [out]}``
    (per-output-channel int4, ``quantize_weight_int4_torch``), "none" ``{"w":
    bf16 [in, out]}``; ``bias`` adds ``"b"`` in ``dtype``. The JAX package's
    ``pack_proj_weight`` at ``tp_size=1``, where the ``col_blocks`` parts
    (qkv's q, k, v; gate_up's gate, up) stay their plain concatenation; its
    tensor-parallel layouts (``shard_in``, ``tp_size``) are not ported
    (ROADMAP queue 1 items 7 and 11)."""
    w = _f32_tensor(w, device).contiguous()
    if col_blocks is not None and sum(col_blocks) != w.shape[1]:
        raise ValueError(f"col_blocks {tuple(col_blocks)} do not add up to the "
                         f"{w.shape[1]} output columns")
    if cfg_quant == "w4":
        qw, qs = quantize_weight_int4_torch(w)
        d = {"qw": qw, "qs": qs}
    elif cfg_quant == "none":
        d = {"w": w.to(dtype)}
    else:
        raise NotImplementedError(f"pack_proj_weight kind {cfg_quant!r}: the port "
                                  "packs 'w4' and 'none'")
    if bias is not None:
        d["b"] = _f32_tensor(bias, w.device).to(dtype)
    return d


# a quantized head's columns are padded to a multiple of this where the
# vocabulary is not a multiple of 8 (the head kernels' widths: csrc/w8a16.cu
# reads 8 columns of a row at once)
HEAD_PAD = 128


def _make_lm_head(w: torch.Tensor, kind: str):
    """The resolved head from a float [H, V] tensor, on its device (the JAX
    package's ``init_params_device.make_lm_head``). A quantized head of a
    vocabulary that is not a multiple of 8 (Granite-3.0's 49155) gets
    columns of scale 0 up to a multiple of ``HEAD_PAD``, once, here: the
    kernels take that width, the extra logits are 0, and ``compute_logits``
    slices them off."""
    if kind == "bf16":
        return w.to(torch.bfloat16)
    qw, qs = (quantize_weight_int8_torch if kind == "int8" else quantize_weight_int4_torch)(w)
    pad = -w.shape[1] % HEAD_PAD if w.shape[1] % 8 else 0
    if pad:
        qw, qs = torch.nn.functional.pad(qw, (0, pad)), torch.nn.functional.pad(qs, (0, pad))
    return {"qw8": qw, "qs": qs} if kind == "int8" else {"qw": qw, "qs": qs}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                group_size: int = 128):
    """Random parameters made on ``device`` from a torch.Generator: normal
    weights (std 0.02) quantized there, so an 8B-wide model never passes
    through host memory. Same layout as :func:`params_from_numpy`. QuaRot
    (w4): per output channel to packed int4. w4g: an AWQ checkpoint of
    ``group_size`` (model_loader.grouped.make_grouped_state_dict) through
    ``load_awq``. w8: a compressed-tensors int-quantized checkpoint
    (model_loader.ct.make_ct_state_dict) through ``load_ct_int8``."""
    check_served(cfg)
    head_kind = _head_kind(cfg)
    dev = resolve_device(device)
    if cfg.quant == "none":
        return _init_float_params(cfg, seed, dev)
    if cfg.quant == "w4g":
        from qspec_tpu_torch.model_loader.grouped import (load_awq,
                                                          make_grouped_state_dict)
        sd = make_grouped_state_dict(cfg, "awq", group_size, seed, dev)
        return load_awq(sd, cfg, device=dev)[0]
    if cfg.quant == "w8":
        from qspec_tpu_torch.model_loader.ct import load_ct_int8, make_ct_state_dict
        sd = make_ct_state_dict(cfg, "int-quantized", seed, dev)
        return load_ct_int8(sd, cfg, device=dev)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = cfg.hidden_size

    def normal(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=dev) * std

    params = {}
    for key, L, moe in layer_stacks(cfg):
        layers = {}
        for name, (lead, k, n) in layer_projections(cfg, moe).items():
            # one (layer, expert) at a time: an expert stack never exists in
            # float (Mixtral-8x7B's is 22.5 GB of int4)
            qw = torch.empty((L, *lead, k // 8, n), dtype=torch.int32, device=dev)
            qs = torch.empty((L, *lead, n), dtype=torch.float32, device=dev)
            for idx in itertools.product(range(L), *map(range, lead)):
                qw[idx], qs[idx] = quantize_weight_int4_torch(normal(k, n))
            layers[name] = {"qw": qw, "qs": qs}
        params[key] = _extra_layer_params(layers, cfg, L, moe, normal, dev)
    return {
        **params,
        "embed": normal(cfg.vocab_size, H).to(torch.bfloat16),
        "lm_head": _make_lm_head(normal(H, cfg.vocab_size), head_kind),
        "rope_cache": make_rope_cache(cfg.rope_dim, cfg.max_position_embeddings,
                                      cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                                      device=dev),
        "hadamards": make_hadamards(cfg, dev),
    }


def _extra_layer_params(layers: dict, cfg: ModelConfig, L: int, moe: bool, normal,
                        dev) -> dict:
    """The layer-stacked parameters besides the projections' weights, as
    the JAX package's init_params makes them: the qkv bias (normal(0.01),
    bf16), the q/k norms' unit gammas, an MoE layer's bf16 router [L, H, E]
    (normal(0.02)), its zero selection bias under noaux_tc and the shared
    expert's gate [L, H, 1]; multi-head latent attention's unit gammas of
    the latent (and of q-LoRA's q) and its kv_b [L, r, heads, qk_nope + v]
    (normal(0.02), bf16)."""
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    if cfg.attention_type == "mla":
        r = cfg.kv_lora_rank
        layers["mla_kv_norm"] = torch.ones((L, r), **bf16)
        if cfg.q_lora_rank:
            layers["mla_q_norm"] = torch.ones((L, cfg.q_lora_rank), **bf16)
        layers["mla_kv_b"] = normal(L, r, cfg.num_heads,
                                    cfg.qk_nope_head_dim + cfg.v_head_dim).to(torch.bfloat16)
    if cfg.qkv_bias:
        layers["qkv"]["b"] = normal(L, cfg.qkv_out, std=0.01).to(torch.bfloat16)
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, cfg.head_dim), **bf16)
        layers["k_norm"] = torch.ones((L, cfg.head_dim), **bf16)
    if moe:
        H, E = cfg.hidden_size, cfg.num_experts
        layers["router"] = normal(L, H, E).to(torch.bfloat16)
        if cfg.moe_routing == "noaux_tc":
            layers["router_bias"] = torch.zeros((L, E), dtype=torch.float32, device=dev)
        if cfg.shared_expert_intermediate_size and cfg.shared_expert_gated:
            layers["shared_gate"] = normal(L, H, 1).to(torch.bfloat16)
    return layers


def alibi_params(cfg: ModelConfig, device) -> dict:
    """``{"alibi_slopes": f32 [Hq]}`` on ``device`` for an ALiBi model, made
    once per model (the attention kernel indexes them by query head), else
    ``{}``. Falcon (falcon-rw) adds its bias before the 1 / sqrt(d) score
    scale, as Hugging Face's ``FalconAttention`` and vLLM's ``falcon.py``
    do, so its slopes carry that scale (the JAX package's do not: ROADMAP
    §3)."""
    if cfg.position_embedding != "alibi":
        return {}
    slopes = alibi_slopes(cfg.num_heads)
    if cfg.arch == "falcon":
        slopes = slopes * np.float32(1.0 / math.sqrt(cfg.head_dim))
    return {"alibi_slopes": torch.as_tensor(slopes, device=device)}


def _init_float_params(cfg: ModelConfig, seed: int, dev: torch.device):
    """Random bf16 weights made on ``dev`` (the JAX package's init_params
    of a float checkpoint: normal(0.02) weights, normal(0.01) biases, unit
    gammas, zero betas), BLOOM's embedding LayerNorm, a tied head sharing
    the embedding's storage."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = cfg.hidden_size

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    params = {}
    for key, L, moe in layer_stacks(cfg):
        layers = {}
        for name, (lead, k, n) in layer_projections(cfg, moe).items():
            layers[name] = {"w": normal(L, *lead, k, n)}
            if cfg.linear_bias:
                layers[name]["b"] = normal(L, n, std=0.01)
        norms = ("input_norm",) + (() if cfg.parallel_block and cfg.parallel_norms == 1
                                    else ("post_norm",))
        for n in norms:
            layers[n] = ones(L, H)
            if cfg.norm_type == "layernorm":
                layers[n + "_b"] = zeros(L, H)
        params[key] = _extra_layer_params(
            layers, cfg, L, moe, lambda *shape, std=0.02: normal(*shape, std=std).float(), dev)
    params.update(embed=normal(cfg.vocab_size, H), final_norm=ones(H), **alibi_params(cfg, dev))
    if cfg.norm_type == "layernorm":
        params["final_norm_b"] = zeros(H)
    if cfg.arch == "bloom":
        params["embed_norm"], params["embed_norm_b"] = ones(H), zeros(H)
    if cfg.position_embedding == "rope":
        params["rope_cache"] = make_rope_cache(
            cfg.rope_dim, cfg.max_position_embeddings, cfg.rope_theta,
            rope_scaling=cfg.rope_scaling, device=dev)
    params["lm_head"] = (params["embed"].t() if cfg.tie_word_embeddings
                         else normal(H, cfg.vocab_size))
    return params


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through float32
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":   # ml_dtypes fp8: its bytes, bit for bit
        return torch.tensor(np.ascontiguousarray(a).view(np.uint8),
                            device=device).view(torch.float8_e4m3fn)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Carry the JAX package's parameter tree (leaves converted with
    ``np.asarray``) over to the port: ``init_params`` of a QuaRot model,
    ``load_awq`` / ``load_gptq`` of a w4g one, or ``init_params`` /
    ``load_family_float`` of a float one (bf16 weights and biases, the
    gammas and LayerNorm betas, BLOOM's ``embed_norm``, the bf16 head and
    its bias ``lm_head_b``); the rope cache as it is (at a partial rotary
    width too); an MoE's router, expert stacks [L, E, ...], shared expert and gate, and
    DeepSeek's ``layers_dense``; the qkv bias and the q/k norms.
    Packed int4 (plain or grouped, with its scales and offsets), the
    per-channel int8 / fp8 weights of a quant="w8" tree (``"w8"``, ``"s8"``,
    fp8 bit for bit), the gammas and the int8 head stay as they are: the kernels read the interchange
    layouts directly. Multi-head latent attention's projections (``mla_q`` |
    ``mla_q_a`` / ``mla_q_b``, ``mla_kv_a``), its gammas (``mla_q_norm``,
    ``mla_kv_norm``) and ``mla_kv_b`` [L, r, heads, qk_nope + v] come as
    they are. The proposer nets come along: ``"medusa"``
    (``spec_decode/medusa.py``'s heads), ``"mlp_spec"`` (an MLPSpeculator)
    and ``"eagle"`` (EAGLE's fc, layer and rope cache). An ALiBi model gets
    its ``alibi_slopes``."""
    _head_kind(cfg)
    dev = resolve_device(device)
    keys = {"w4": ("qw", "qs", "b"), "w4g": ("qw", "qs_g", "qo_g", "b"),
            "w8": ("w8", "s8", "b"), "none": ("w", "b")}[cfg.quant]
    norms = ("input_norm", "post_norm", "input_norm_b", "post_norm_b") + (
        ("post_attn_norm", "post_ffw_norm") if cfg.post_norms else ())
    params = {
        "embed": _tensor(tree["embed"], dev),
        "lm_head": ({k: _tensor(v, dev) for k, v in tree["lm_head"].items()}
                    if isinstance(tree["lm_head"], dict) else _tensor(tree["lm_head"], dev)),
        **alibi_params(cfg, dev),
    }
    for seg, _, moe in layer_stacks(cfg):
        src = tree[seg]
        layers = {name: {k: _tensor(src[name][k], dev) for k in keys if k in src[name]}
                  for name in layer_projections(cfg, moe)}
        # the router, its selection bias and the shared expert's gate; the
        # q/k norms' gammas (live in every quant mode); the float gammas
        for name in ("router", "router_bias", "shared_gate", "q_norm", "k_norm", "mla_q_norm",
                     "mla_kv_norm", "mla_kv_b") + (() if cfg.quant == "w4" else norms):
            if name in src:
                layers[name] = _tensor(src[name], dev)
        params[seg] = layers
    if cfg.position_embedding == "rope":
        params["rope_cache"] = _tensor(tree["rope_cache"], dev).to(torch.float32)
    if cfg.quant == "w4":
        params["hadamards"] = make_hadamards(cfg, dev)
    else:
        for name in ("final_norm", "final_norm_b", "embed_norm", "embed_norm_b", "lm_head_b"):
            if name in tree:
                params[name] = _tensor(tree[name], dev)

    def subtree(t):
        return {k: subtree(v) for k, v in t.items()} if isinstance(t, dict) else _tensor(t, dev)

    for net in ("medusa", "mlp_spec", "eagle"):
        if net in tree:
            params[net] = subtree(tree[net])
    return params
