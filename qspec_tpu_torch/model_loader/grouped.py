"""AWQ / GPTQ checkpoint ingestion -> grouped-int4 params (quant="w4g").

Port of ``qspec_tpu/model_loader/grouped.py``. Both formats repack into ONE
representation, read by ``ops.linear_kernels.matmul_w4a16_g``:

    qw    int32 [K//8, N]   SWAR nibbles holding the ORIGINAL unsigned q
                            (pack_int4 stores q-8 in excess-8 form, so the
                            stored nibble equals q)
    qs_g  f32  [K//g, N]    per-(group, out-channel) scales
    qo_g  f32  [K//g, N]    precomputed zp*s offsets (dequant w = q*s - zp*s)

Bit layouts handled (the de-facto AutoAWQ / AutoGPTQ packing):

* AWQ (gemm format): qweight int32 [K, N//8], 8 nibbles along N in the
  interleaved order [0, 2, 4, 6, 1, 3, 5, 7]; qzeros int32 [K//g, N//8]
  same order; scales f16 [K//g, N]. Dequant w = (q - zp) * s.
* GPTQ: qweight int32 [K//8, N], 8 nibbles along K in sequential order;
  qzeros int32 [K//g, N//8], nibbles along N sequential, stored as zp - 1;
  scales f16 [K//g, N]; g_idx [K] (only the trivial row -> group map:
  act-order checkpoints need a K permutation that would also permute the
  preceding layer's outputs).

The unpackers, the packer and the loaders are torch ops that run where their
input tensors lie (numpy arrays are taken as CPU tensors), so an 8B-wide
checkpoint made on the card is repacked there. The synthetic-checkpoint
writers (``make_awq_tensors``, ``make_gptq_tensors``) take a tensor and
quantize it on its device, with the JAX package's numpy writers' bits;
``random_state_dict`` makes a whole checkpoint of a config on a device with
any format's writer (``ct.py``'s too). ``_load_grouped`` takes a
``proj_reader`` in place of the AWQ / GPTQ unpacking, as the JAX one does:
compressed-tensors and GGUF feed it their (q, zp, s) triples. Models served this way keep their gamma norms and have no QuaRot
rotations: only the W4A16 scheme applies, so QSpec drafts with the same
weights at ``draft_scheme="w4a16"``, usually under ``draft_kv_window``.

``load_awq`` / ``load_gptq`` take a state dict with its ModelConfig, or a
checkpoint directory (its ``*.safetensors`` through
``model_loader.loader.read_safetensors``, its config.json through
``config_from_hf_dir`` unless a cfg is given), as the JAX loaders do; a
Qwen2's q/k/v biases (``qkv_bias``) come along as ``layers["qkv"]["b"]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.ops.packing import pack_int4

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _t(a, device=None) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t if device is None else t.to(device)


# ---------------------------------------------------------------------------
# format unpacking
# ---------------------------------------------------------------------------


def _nibbles(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., W] -> uint8 [..., W, 8] nibble planes (shift order)."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * torch.arange(8, device=words.device)
    return ((u[..., None] >> shifts) & 0xF).to(torch.uint8)


def _awq_order(n: int, device) -> torch.Tensor:
    """Output column 8j+i holds nibble 8j + AWQ_ORDER[i] (AutoAWQ
    reverse_awq_order)."""
    order = torch.tensor(AWQ_ORDER, device=device)
    return (torch.arange(0, n, 8, device=device)[:, None] + order[None, :]).reshape(-1)


def unpack_awq(qweight, qzeros, scales):
    """AWQ gemm-format tensors -> (q [K, N] uint8, zp [K//g, N] uint8,
    s [K//g, N] f32)."""
    qweight, qzeros = _t(qweight), _t(qzeros)
    K, Wn = qweight.shape
    N = Wn * 8
    order = _awq_order(N, qweight.device)
    q = _nibbles(qweight).reshape(K, N)[:, order]
    zp = _nibbles(qzeros).reshape(qzeros.shape[0], N)[:, order]
    return q, zp, _t(scales).to(torch.float32)


def unpack_gptq(qweight, qzeros, scales, g_idx=None):
    """GPTQ tensors -> (q [K, N] uint8, zp [K//g, N] uint8, s [K//g, N] f32).

    Rejects a non-trivial ``g_idx`` (act-order / desc_act=True): honouring it
    needs a contraction-dim permutation that must also permute the previous
    layer's output.
    """
    qweight, qzeros = _t(qweight), _t(qzeros)
    Wk, N = qweight.shape
    K = Wk * 8
    G = qzeros.shape[0]
    g = K // G
    if g_idx is not None:
        want = torch.arange(K, device=qweight.device) // g
        if not torch.equal(_t(g_idx, qweight.device).to(torch.int64), want):
            raise NotImplementedError(
                "GPTQ act-order (desc_act=True) checkpoints are not "
                "supported; re-quantize with desc_act=False")
    # qweight nibbles run along K: row 8r+i = nibble i of word r
    q = _nibbles(qweight).transpose(1, 2).reshape(K, N)
    # qzeros nibbles run along N, stored as zp - 1
    zp = (_nibbles(qzeros).reshape(G, N) + 1) & 0xF
    return q, zp, _t(scales).to(torch.float32)


# ---------------------------------------------------------------------------
# packing into the kernel's layout
# ---------------------------------------------------------------------------


def pack_grouped_proj(q, zp, s, *, shard_in: bool = False, col_blocks=None,
                      tp_size: int = 1, bias=None) -> Dict[str, torch.Tensor]:
    """One projection's grouped-quant param dict with the JAX package's
    tensor-parallel layouts.

    q [K, N] uint (0..15), zp / s [K//g, N]. ``col_blocks`` rearranges
    heterogeneous output blocks (qkv / gate_up) into per-shard stripes;
    ``shard_in`` (row-parallel) packs each K-chunk on its own so a shard's
    packed rows unpack exactly its local activation slice (needs g | K/tp).
    """
    q, zp, s = _t(q), _t(zp), _t(s)
    K, N = q.shape
    g = K // s.shape[0]
    if col_blocks and tp_size > 1:
        def rearrange(a):
            parts = torch.split(a, list(col_blocks), dim=1)
            return torch.cat([p[:, r * (p.shape[1] // tp_size):(r + 1) * (p.shape[1] // tp_size)]
                              for r in range(tp_size) for p in parts], dim=1)
        q, zp, s = rearrange(q), rearrange(zp), rearrange(s)
        if bias is not None:
            bias = rearrange(_t(bias)[None, :])[0]
    qs = q.to(torch.int16) - 8          # excess-8 storage => nibble == q
    if shard_in and tp_size > 1:
        if (K // tp_size) % max(g, 8) != 0:
            raise ValueError(f"group size {g} must divide K/tp = {K // tp_size}")
        packed = torch.cat([pack_int4(c) for c in torch.chunk(qs, tp_size, dim=0)])
    else:
        packed = pack_int4(qs)
    s = s.to(torch.float32)
    out = {"qw": packed, "qs_g": s, "qo_g": zp.to(torch.float32) * s}
    if bias is not None:
        out["b"] = _t(bias, packed.device).to(torch.float32).to(torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# full-model loaders
# ---------------------------------------------------------------------------


def _load_grouped(sd: dict, cfg: ModelConfig, fmt: str, tp_size: int, device,
                  proj_reader=None):
    """``proj_reader(prefix) -> (q [K, N], zp [G, N], s [G, N])`` on the
    device replaces the AWQ / GPTQ tensor-name unpacking (compressed-tensors
    pack-quantized and GGUF Q4_0 ingestion, ``ct.py`` / ``gguf.py``), as in
    the JAX package. The o / down biases are read where the checkpoint has
    them (``loader.OD_BIAS_KEYS``; the JAX grouped loader reads none)."""
    from qspec_tpu_torch.model_loader.loader import OD_BIAS_KEYS, _od_biases
    from qspec_tpu_torch.models.llama import (_head_kind, _make_lm_head,
                                              resolve_device)
    from qspec_tpu_torch.ops.rotary import make_rope_cache

    cfg = dataclasses.replace(cfg, quant="w4g")
    dev = resolve_device(device)
    unpack = unpack_awq if fmt == "awq" else unpack_gptq
    od_bias = _od_biases(sd, cfg.num_layers)

    def proj(prefix):
        if proj_reader is not None:
            return proj_reader(prefix)
        args = [_t(sd[prefix + n], dev) for n in (".qweight", ".qzeros", ".scales")]
        if fmt == "gptq" and prefix + ".g_idx" in sd:
            args.append(_t(sd[prefix + ".g_idx"], dev))
        return unpack(*args)

    def cat(parts):
        return tuple(torch.cat(xs, dim=1) for xs in zip(*parts))

    def od(ln, i):
        return _t(sd[ln + OD_BIAS_KEYS[i]], dev).to(torch.float32) if od_bias[i] else None

    def norm_w(name):
        # gemma's (1 + w) norms: the offset is folded into the stored gamma
        return (_t(sd[name], dev).to(torch.float32) + cfg.norm_weight_offset
                ).to(torch.bfloat16)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}.self_attn."
        mp = f"model.layers.{i}.mlp."
        ln = f"model.layers.{i}."
        bias = (torch.cat([_t(sd[p + n + ".bias"], dev).to(torch.float32)
                           for n in ("q_proj", "k_proj", "v_proj")]) if cfg.qkv_bias else None)
        layer = {
            "qkv": pack_grouped_proj(
                *cat([proj(p + "q_proj"), proj(p + "k_proj"), proj(p + "v_proj")]),
                col_blocks=(cfg.q_size, cfg.kv_size, cfg.kv_size), tp_size=tp_size,
                bias=bias),
            "o": pack_grouped_proj(*proj(p + "o_proj"), shard_in=True, tp_size=tp_size,
                                   bias=od(ln, 0)),
            "gate_up": pack_grouped_proj(
                *cat([proj(mp + "gate_proj"), proj(mp + "up_proj")]),
                col_blocks=(cfg.intermediate_size, cfg.intermediate_size),
                tp_size=tp_size),
            "down": pack_grouped_proj(*proj(mp + "down_proj"), shard_in=True,
                                      tp_size=tp_size, bias=od(ln, 1)),
            "input_norm": norm_w(ln + "input_layernorm.weight"),
            # the MLP's pre-norm: Gemma-2 names it pre_feedforward_layernorm
            "post_norm": norm_w(ln + ("pre_feedforward_layernorm.weight" if cfg.post_norms
                                      else "post_attention_layernorm.weight")),
        }
        if cfg.post_norms:   # Gemma-2's norms on the block outputs
            layer["post_attn_norm"] = norm_w(ln + "post_attention_layernorm.weight")
            layer["post_ffw_norm"] = norm_w(ln + "post_feedforward_layernorm.weight")
        if cfg.qk_norm:      # Qwen3's per-head q/k norms (the JAX loader reads none)
            layer["q_norm"] = norm_w(p + "q_norm.weight")
            layer["k_norm"] = norm_w(p + "k_norm.weight")
        layers.append(layer)
    stacked = {}
    for name, first in layers[0].items():
        if isinstance(first, dict):
            stacked[name] = {k: torch.stack([lay[name][k] for lay in layers])
                             for k in first}
        else:
            stacked[name] = torch.stack([lay[name] for lay in layers])
    del layers
    embed = _t(sd["model.embed_tokens.weight"], dev)
    # a tied head (Gemma-2) falls back to the embedding
    lm = _t(sd["lm_head.weight"], dev) if "lm_head.weight" in sd else embed
    params = {
        "embed": embed.to(torch.float32).to(torch.bfloat16),
        "lm_head": _make_lm_head(lm.to(torch.float32).t().contiguous(), _head_kind(cfg)),
        "final_norm": norm_w("model.norm.weight"),
        "layers": stacked,
        "rope_cache": make_rope_cache(cfg.rope_dim, cfg.max_position_embeddings,
                                      cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                                      device=dev),
    }
    return params, cfg


def load_awq(path_or_sd, cfg: Optional[ModelConfig] = None, tp_size: int = 1,
             device="cuda"):
    """AWQ (gemm-format) state dict or checkpoint directory -> (grouped-int4
    params on ``device``, cfg with quant="w4g")."""
    return _load_grouped(*_resolve(path_or_sd, cfg), "awq", tp_size, device)


def load_gptq(path_or_sd, cfg: Optional[ModelConfig] = None, tp_size: int = 1,
              device="cuda"):
    """GPTQ (desc_act=False) state dict or checkpoint directory ->
    (grouped-int4 params on ``device``, cfg with quant="w4g")."""
    return _load_grouped(*_resolve(path_or_sd, cfg), "gptq", tp_size, device)


def _resolve(path_or_sd, cfg):
    """(state dict, cfg) of a state dict (its cfg required) or a directory
    (its tensors read once; its config.json unless ``cfg`` is given)."""
    if isinstance(path_or_sd, dict):
        if cfg is None:
            raise ValueError("a state dict needs its ModelConfig")
        return path_or_sd, cfg
    from qspec_tpu_torch.model_loader.loader import config_from_hf_dir, read_safetensors
    sd = read_safetensors(path_or_sd)
    return sd, cfg or config_from_hf_dir(path_or_sd)


# ---------------------------------------------------------------------------
# synthetic-checkpoint writers (tests + tooling; also document the formats)
# ---------------------------------------------------------------------------


def make_awq_tensors(w: torch.Tensor, group_size: int = 128, seed: int = 0):
    """Quantize a float [K, N] weight tensor into AWQ gemm-format tensors
    (asymmetric, per group) on its device. Returns dict(qweight, qzeros,
    scales)."""
    q, zp, s = _group_quantize(w, group_size, seed)
    inv = torch.argsort(_awq_order(w.shape[1], w.device))
    return {"qweight": _pack_words(q[:, inv].reshape(w.shape[0], -1, 8)),
            "qzeros": _pack_words(zp[:, inv].reshape(zp.shape[0], -1, 8)),
            "scales": s.to(torch.float16)}


def make_gptq_tensors(w: torch.Tensor, group_size: int = 128, seed: int = 0,
                      with_g_idx: bool = True):
    """Quantize a float [K, N] weight tensor into GPTQ-format tensors on its
    device."""
    q, zp, s = _group_quantize(w, group_size, seed)
    K, N = w.shape
    out = {"qweight": _pack_words(q.reshape(-1, 8, N).transpose(1, 2)).reshape(K // 8, N),
           "qzeros": _pack_words(((zp.to(torch.int16) - 1) & 0xF
                                  ).reshape(zp.shape[0], -1, 8)),
           "scales": s.to(torch.float16)}
    if with_g_idx:
        out["g_idx"] = (torch.arange(K, device=w.device) // group_size).to(torch.int32)
    return out


def _pack_words(nibbles: torch.Tensor) -> torch.Tensor:
    """uint nibble tensor [..., 8] -> int32 words (shift order)."""
    n = nibbles.to(torch.int64) & 0xF
    word = sum(n[..., i] << (4 * i) for i in range(8))
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _group_quantize(w: torch.Tensor, g: int, seed: int):
    """Asymmetric per-group quantization (AWQ/GPTQ semantics):
    w ~ (q - zp) * s with q, zp in [0, 15]."""
    K, N = w.shape
    if K % g:
        raise ValueError(f"group size {g} must divide K = {K}")
    wg = w.reshape(K // g, g, N)
    lo, hi = wg.amin(dim=1), wg.amax(dim=1)        # [G, N]
    s = ((hi - lo) / 15.0).clamp_min(1e-8)
    zp = torch.clamp(torch.round(-lo / s), 0, 15)
    q = torch.clamp(torch.round(wg / s[:, None]) + zp[:, None], 0, 15)
    return q.reshape(K, N).to(torch.uint8), zp.to(torch.uint8), s.to(torch.float32)


def make_grouped_state_dict(cfg: ModelConfig, fmt: str = "awq",
                            group_size: int = 128, seed: int = 0, device="cuda"):
    """A Hugging Face-named AWQ or GPTQ state dict of a Llama or a Gemma-2
    of ``cfg``'s shapes, made on ``device`` by :func:`random_state_dict`,
    every projection quantized by the format's writer above."""
    make = make_awq_tensors if fmt == "awq" else make_gptq_tensors
    return random_state_dict(cfg, lambda w: make(w, group_size), seed, device)


def random_state_dict(cfg: ModelConfig, make, seed: int = 0, device="cuda") -> dict:
    """A Hugging Face-named state dict of ``cfg``'s shapes made on ``device``
    from a torch.Generator: normal(0.02) float weights, each projection's
    [K, N] given to ``make``, which returns its checkpoint tensors (a
    format's writer), float embeddings and (unless ``tie_word_embeddings``)
    lm_head. Norm gammas are ``norm_weight_offset``-free: 1 + normal(0.05)
    for a Llama, normal(0.05) around 0 for a Gemma-2, whose loader adds the
    offset; a Gemma-2 also gets its pre- and post-feedforward norms, a Qwen2
    its q/k/v biases (normal(0.02), in float32), a Qwen3 its q/k norms. An
    8B-wide checkpoint so never passes through host memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def normal(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=device) * std

    def gamma():
        return 1 - cfg.norm_weight_offset + normal(H, std=0.05)

    sd = {"model.embed_tokens.weight": normal(V, H)}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = normal(V, H)
    sd["model.norm.weight"] = gamma()
    shapes = {"self_attn.q_proj": (H, cfg.q_size), "self_attn.k_proj": (H, cfg.kv_size),
              "self_attn.v_proj": (H, cfg.kv_size), "self_attn.o_proj": (cfg.q_size, H),
              "mlp.gate_proj": (H, I), "mlp.up_proj": (H, I), "mlp.down_proj": (I, H)}
    norms = ("input_layernorm", "post_attention_layernorm") + (
        ("pre_feedforward_layernorm", "post_feedforward_layernorm") if cfg.post_norms else ())
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for name, (k, n) in shapes.items():
            for key, val in make(normal(k, n)).items():
                sd[f"{p}{name}.{key}"] = val
        for name in norms:
            sd[f"{p}{name}.weight"] = gamma()
        if cfg.qkv_bias:
            for n, width in (("q", cfg.q_size), ("k", cfg.kv_size), ("v", cfg.kv_size)):
                sd[f"{p}self_attn.{n}_proj.bias"] = normal(width)
        if cfg.qk_norm:
            for n in "qk":
                sd[f"{p}self_attn.{n}_norm.weight"] = 1 + normal(cfg.head_dim, std=0.05)
    return sd
