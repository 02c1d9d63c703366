"""Dual-scheme QuaRot Llama: one packed-int4 parameter tree, two forwards.

Port of the dense-Llama path of ``qspec_tpu/models/llama.py``. The QSpec
property, W4A4 draft and W4A16 verify sharing the same weight buffers, is a
``scheme`` argument: the draft forward and the verify forward read the same
tensors; nothing is copied on a switch.

Per layer (QuaRot checkpoints, norms weightless):

    x - rmsnorm[+quant] - qkv(w4) - rope - paged KV write - attention
      - head Hadamard - [quant] - o(w4) - +residual
      - rmsnorm[+quant] - gate_up(w4) - silu*up - Hadamard(I) - [quant]
      - down(w4) - +residual

Parameters are a plain dict with the JAX package's layout: ``embed`` [V, H]
bf16; ``lm_head`` [H, V] bf16; ``layers[name] = {"qw": int32 [L, K//8, N],
"qs": f32 [L, N]}`` for qkv / o / gate_up / down; ``rope_cache``;
``hadamards``. The layer-stacked weights are read in place by the kernels
(``layer_idx``).

The Hadamard rotations are computed in float64: their ±1 sums of bf16
inputs are then exact, so the result does not depend on how the GEMM library
orders the sums for a given batch size. With the row-independent kernels this
keeps greedy QSpec output bit-identical to greedy AR output when the batch
shrinks in one run and not in the other.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.ops.attention import paged_attention
from qspec_tpu_torch.ops.hadamard import decompose_dim, hadamard_matrix
from qspec_tpu_torch.ops.linear_kernels import matmul_w4a4, matmul_w4a16
from qspec_tpu_torch.ops.packing import quantize_weight_int4_torch
from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8
from qspec_tpu_torch.ops.rmsnorm_quant import rmsnorm, rmsnorm_quant
from qspec_tpu_torch.ops.rotary import apply_rope, make_rope_cache

SCHEMES = ("w4a4", "w4a8", "w4a16")
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
    """One projection by scheme; ``w`` holds the layer-stacked "qw"/"qs"."""
    if scheme == "w4a16":
        return matmul_w4a16(x, w["qw"], w["qs"], layer_idx=li)
    return matmul_w4a4(xq.values, xq.scales, w["qw"], w["qs"], layer_idx=li)


def _norm_maybe_quant(x, eps, scheme):
    """The weightless QuaRot norm: (normed bf16 or None, quantized or None)."""
    if scheme in QUANT_ACT_SCHEMES:
        return None, rmsnorm_quant(x, eps=eps, bits=4 if scheme == "w4a4" else 8)
    return rmsnorm(x, None, eps=eps), None


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


def _glu_act(gate, up):
    g32 = gate.to(torch.float32)
    return (torch.nn.functional.silu(g32) * up.to(torch.float32)).to(torch.bfloat16)


def decoder_layer(x, layers, cache, li: int, cfg: ModelConfig,
                  batch: AttentionBatch, rope_cache, hadamards, scheme: str):
    """One decoder layer. x: [T, hidden] bf16; ``layers`` is the
    layer-stacked param dict and ``li`` selects both the weight layer and
    the KV-cache layer. Returns (x_out, cache); the cache is written in
    place."""
    B, Q = batch.positions.shape
    T = B * Q
    eps = cfg.rms_norm_eps
    quant_act = scheme in QUANT_ACT_SCHEMES

    xn, xq = _norm_maybe_quant(x, eps, scheme)
    qkv = _linear(xn, layers["qkv"], scheme, xq, li)
    q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], dim=-1)
    q = q.reshape(T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(T, cfg.num_kv_heads, cfg.head_dim).to(torch.bfloat16)
    q, k = apply_rope(q, k, batch.positions.reshape(-1), rope_cache)
    q = q.to(torch.bfloat16)
    k = k.to(torch.bfloat16)

    kvc.update_layer(cache, li, k, v, batch.slot_mapping.reshape(-1))
    attn = paged_attention(q.reshape(B, Q, cfg.num_heads, cfg.head_dim).contiguous(),
                           cache, li, batch.block_tables, batch.ctx_lens,
                           cfg.head_dim ** -0.5, q_positions=batch.positions)
    attn = _head_hadamard(attn.reshape(T, cfg.num_heads, cfg.head_dim),
                          hadamards["heads"])
    attn_flat = attn.reshape(T, cfg.q_size)
    if quant_act:
        o = _linear(None, layers["o"], scheme, _act_quant(attn_flat, scheme), li)
    else:
        o = _linear(attn_flat, layers["o"], scheme, li=li)
    x = x + o.to(x.dtype)

    xn, xq = _norm_maybe_quant(x, eps, scheme)
    gate_up = _linear(xn, layers["gate_up"], scheme, xq, li)
    i_size = gate_up.shape[-1] // 2
    act = _glu_act(gate_up[:, :i_size], gate_up[:, i_size:])
    act = _mlp_hadamard(act, hadamards["mlp_K"], hadamards["mlp_P"])
    if quant_act:
        down = _linear(None, layers["down"], scheme, _act_quant(act, scheme), li)
    else:
        down = _linear(act, layers["down"], scheme, li=li)
    return x + down.to(x.dtype), cache


def model_forward(params, cfg: ModelConfig, token_ids: torch.Tensor,
                  cache: kvc.PagedKVCache, batch: AttentionBatch, *,
                  scheme: str = "w4a16",
                  logits_indices: Optional[torch.Tensor] = None):
    """Full forward. token_ids: [B, Q] -> (logits [B, Q, V] f32, cache).

    ``logits_indices`` [B]: compute logits only at one query index per row
    (prefill needs only the last prompt position); the output is then
    [B, 1, V].
    """
    if scheme not in SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {SCHEMES}")
    if cfg.quant != "w4":
        raise NotImplementedError("only QuaRot w4 checkpoints are ported")
    B, Q = token_ids.shape
    x = params["embed"][token_ids.reshape(-1).to(torch.int64)].to(torch.bfloat16)
    for li in range(cfg.num_layers):
        x, cache = decoder_layer(x, params["layers"], cache, li, cfg, batch,
                                 params["rope_cache"], params["hadamards"],
                                 scheme)
    if logits_indices is not None:
        flat = logits_indices.to(torch.int64) + torch.arange(B, device=x.device) * Q
        x = x[flat]
        Q = 1
    x = rmsnorm(x, None, eps=cfg.rms_norm_eps)
    logits = compute_logits(x, params["lm_head"])
    return logits.reshape(B, Q, -1), cache


def compute_logits(x: torch.Tensor, lm_head) -> torch.Tensor:
    """Vocab projection with a dense bf16 [H, V] head -> f32 logits.

    On the card: one bf16 GEMM with an f32 result, its rows padded to a
    multiple of 128 so the GEMM library sees one shape whatever the batch
    (the head is bound by its 1 GB of weight bytes, so the padding rows cost
    nothing) and a row's logits do not depend on the batch size. On the CPU:
    float64, whose sums of bf16 products are exact.
    """
    if isinstance(lm_head, dict):
        raise NotImplementedError("int8/int4 lm_head (matmul_w8a16) is not "
                                  "ported yet; use lm_head_quant='bf16'")
    if not x.is_cuda:
        return (x.to(torch.float64) @ lm_head.to(torch.float64)).to(torch.float32)
    m = x.shape[0]
    m_pad = -(-max(m, 1) // 128) * 128
    xp = torch.nn.functional.pad(x, (0, 0, 0, m_pad - m))
    return torch.mm(xp, lm_head, out_dtype=torch.float32)[:m]


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def make_hadamards(cfg: ModelConfig, device=None):
    """The constant Hadamard factors (float64, see the module docstring)."""
    K, P = decompose_dim(cfg.intermediate_size)

    def t(n):
        return torch.as_tensor(hadamard_matrix(n), dtype=torch.float64,
                               device=device)

    return {"heads": t(cfg.num_heads), "mlp_K": t(K), "mlp_P": t(P)}


def _proj_shapes(cfg: ModelConfig):
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {"qkv": (H, cfg.qkv_out), "o": (cfg.q_size, H),
            "gate_up": (H, 2 * I), "down": (I, H)}


def resolve_device(device) -> torch.device:
    """The entry points' device: "cuda" unless the caller asks for the CPU;
    a CUDA device with no card present raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def _check_head(cfg: ModelConfig) -> None:
    if cfg.resolved_lm_head_quant != "bf16":
        raise NotImplementedError(
            f"lm_head_quant={cfg.resolved_lm_head_quant!r}: only the bf16 head "
            "is ported (pass lm_head_quant='bf16')")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters made on ``device`` from a torch.Generator: normal
    weights (std 0.02) quantized per output channel to packed int4 there, so
    an 8B-wide model never passes through host memory. Same layout as
    :func:`params_from_numpy`."""
    if cfg.quant != "w4":
        raise NotImplementedError("only QuaRot w4 checkpoints are ported")
    _check_head(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, L = cfg.hidden_size, cfg.num_layers

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    layers = {}
    for name, (k, n) in _proj_shapes(cfg).items():
        qw = torch.empty((L, k // 8, n), dtype=torch.int32, device=dev)
        qs = torch.empty((L, n), dtype=torch.float32, device=dev)
        for li in range(L):
            qw[li], qs[li] = quantize_weight_int4_torch(normal(k, n))
        layers[name] = {"qw": qw, "qs": qs}
    return {
        "embed": normal(cfg.vocab_size, H).to(torch.bfloat16),
        "lm_head": normal(H, cfg.vocab_size).to(torch.bfloat16),
        "layers": layers,
        "rope_cache": make_rope_cache(cfg.head_dim, cfg.max_position_embeddings,
                                      cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                                      device=dev),
        "hadamards": make_hadamards(cfg, dev),
    }


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through float32
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """Carry the JAX package's parameter tree (leaves converted with
    ``np.asarray``) over to the port. Packed int4 stays as it is: the
    kernels read the interchange layout directly."""
    if cfg.quant != "w4":
        raise NotImplementedError("only QuaRot w4 checkpoints are ported")
    _check_head(cfg)
    dev = resolve_device(device)
    layers = {name: {"qw": _tensor(tree["layers"][name]["qw"], dev),
                     "qs": _tensor(tree["layers"][name]["qs"], dev)}
              for name in PROJECTIONS}
    return {
        "embed": _tensor(tree["embed"], dev),
        "lm_head": _tensor(tree["lm_head"], dev),
        "layers": layers,
        "rope_cache": _tensor(tree["rope_cache"], dev).to(torch.float32),
        "hadamards": make_hadamards(cfg, dev),
    }
