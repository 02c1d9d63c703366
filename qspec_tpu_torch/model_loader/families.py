"""Float state-dict converters of the non-llama-keyed families the port
serves, and the key remaps of the llama graph under other key names.

Port of ``qspec_tpu/model_loader/families.py`` for BLOOM, MPT,
DeepSeek-MoE, DeepSeek-V2 / V3 and MiniCPM3 (multi-head latent attention),
Falcon, JAIS and the parallel-residual families GPT-J,
GPT-NeoX / Pythia, Phi, StableLM and Cohere: a family's checkpoint layout
(BLOOM's and GPT-NeoX's head-interleaved fused ``query_key_value``, MPT's
``transformer.blocks.*`` naming, DeepSeek's dense prefix and shared experts,
Falcon's three ``query_key_value`` layouts and its parallel blocks, JAIS's
Conv1D weights and swiglu pair; GPT-J's and Phi's head biases) is
translated into the bf16 parameter tree that ``models/llama.py`` serves
with the family's knobs (LayerNorm, linear biases, the non-gated MLP,
ALiBi, the parallel block, the partial and interleaved rope; the MoE MLP),
the layout of the JAX converters' output.

``LLAMA_KEY_REMAPS`` (Baichuan, InternLM2, Qwen v1, EXAONE, TeleChat2) map
a checkpoint onto llama keys in place, so the llama-keyed loaders
(``loader.py``: ``load_hf_float``, ``quantize_float``) serve it, QuaRot
included. They work on the tensors as they are, on their own device (no
round trip through host float32 as the JAX remaps take): a fused tensor is
split into views or de-interleaved into copies, and the source entry leaves
the dict as it is consumed.

The converters take numpy arrays or torch tensors (of any float dtype, on
any device: a state dict made on the card converts there) and consume the
dict they are given: each source entry is removed as it is converted, and
the layer stacks are filled one at a time, so the peak memory stays near one
copy of the weights plus one stack (a 4 GB MLP stack at BLOOM-7B1). The weights are rounded
to bf16 as the JAX converters round them (from the source's exact float32
value, to nearest even). The rope cache that the JAX ``_finish`` adds, at
the rotated width (``ModelConfig.rope_dim``), is left out of BLOOM's and
MPT's trees: ALiBi has no rope.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models.llama import alibi_params, layer_segments, layer_stacks
from qspec_tpu_torch.ops.rotary import make_rope_cache

# Baichuan2's vocabulary: its NormHead L2-normalizes the head's rows (vLLM's
# baichuan.py tells Baichuan2 from Baichuan by this size, as does the port)
BAICHUAN2_VOCAB = 125696


def _take(sd: Dict, name: str, device) -> torch.Tensor:
    """Remove ``name`` from ``sd``; as a bf16 tensor on ``device``."""
    a = sd.pop(name)
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))
    return t.to(device=device, dtype=torch.bfloat16)


def _device(sd: Dict, device):
    if device is not None:
        return torch.device(device)
    first = next(iter(sd.values()))
    return first.device if isinstance(first, torch.Tensor) else torch.device("cpu")


class _Stacker:
    """Layer-stacked tensors filled one layer at a time, the source of
    each layer freed as it is copied in; the converters fill one stack at a
    time, so the peak holds one copy of the weights plus one stack."""

    def __init__(self, sd: Dict, num_layers: int, device):
        self.sd, self.L, self.device = sd, num_layers, device
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, key: str, li, value, experts: int = 0, out=None) -> None:
        """Copy ``value`` into layer ``li`` of stack ``key``, or with
        ``experts`` into (layer, expert) ``li`` of an [L, experts, ...] one,
        in ``value``'s dtype; a dict of tensors (a packed projection) fills
        a dict of stacks, ``key``'s."""
        out = self.out if out is None else out
        if isinstance(value, dict):
            for k, v in value.items():
                self.put(k, li, v, experts, out.setdefault(key, {}))
            return
        if key not in out:
            lead = (self.L, experts) if experts else (self.L,)
            out[key] = torch.empty((*lead, *value.shape), dtype=value.dtype,
                                   device=self.device)
        out[key][li].copy_(value)

    def weight(self, key: str, li: int, name: str, rows=None) -> None:
        """An HF [out, in] weight, stored [in, out]; ``rows`` reorders its
        output rows first."""
        w = _take(self.sd, name, self.device)
        self.put(key, li, (w if rows is None else rows(w)).t())

    def vector(self, key: str, li: int, name: str, rows=None) -> None:
        b = _take(self.sd, name, self.device)
        self.put(key, li, b if rows is None else rows(b))


def _on_every_layer(sd: Dict, layer, names) -> bool:
    """Whether every layer's prefix in ``layer`` has each of ``names`` in
    ``sd``; where only some layers do, it raises a ValueError naming them (a
    tensor read on some layers only would leave the others' rows unset)."""
    some = [any(p + n in sd for n in names) for p in layer]
    every = [all(p + n in sd for n in names) for p in layer]
    if any(some) and not all(every):
        raise ValueError(f"{' / '.join(names)} on layers {[i for i, h in enumerate(every) if h]} "
                         f"but not on {[i for i, h in enumerate(every) if not h]}")
    return all(every)


def position_params(cfg: ModelConfig, device) -> dict:
    """An ALiBi model's slopes, or a rope model's cache (the JAX package's
    ``_finish``; ALiBi has no rope)."""
    if cfg.position_embedding == "alibi":
        return alibi_params(cfg, device)
    return {"rope_cache": make_rope_cache(cfg.rope_dim, cfg.max_position_embeddings,
                                          cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                                          device=device)}


def _tree(st: _Stacker, cfg: ModelConfig, embed: torch.Tensor, lm_head) -> dict:
    """The served tree from the stacks: projections {"w"[, "b"]}, the norms
    and their betas, the head (the embedding's transposed storage when
    tied), the ALiBi slopes or the rope cache."""
    o = st.out
    layers = {name: {"w": o[f"{name}.w"], **({"b": o[f"{name}.b"]} if f"{name}.b" in o else {})}
              for name in ("qkv", "o", "gate_up", "down")}
    for name in ("input_norm", "post_norm", "input_norm_b", "post_norm_b"):
        if name in o:
            layers[name] = o[name]
    head = embed.t() if lm_head is None else lm_head.t().contiguous()
    return {"embed": embed, "layers": layers, "lm_head": head,
            **position_params(cfg, embed.device)}


def _per_head_qkv(nh: int, dh: int):
    """Rows [nh, 3, dh, ...] (each head's q, k, v together: BLOOM's and
    GPT-NeoX's fused query_key_value) de-interleaved to q|k|v."""
    def rows(t):
        return t.reshape(nh, 3, dh, *t.shape[1:]).transpose(0, 1).reshape(3 * nh * dh,
                                                                          *t.shape[1:])
    return rows


def convert_bloom(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """BLOOM (``qspec_tpu/model_loader/families.py::convert_bloom``):
    ``transformer.*`` names, the embedding LayerNorm, the head-interleaved
    fused ``query_key_value`` (rows [nh, 3, dh], de-interleaved to q|k|v
    with its bias), tanh-gelu MLP with biases, tied head."""
    dev = _device(sd, device)
    st = _Stacker(sd, cfg.num_layers, dev)
    qkv_rows = _per_head_qkv(cfg.num_heads, cfg.head_dim)
    layer = [f"transformer.h.{li}." for li in range(cfg.num_layers)]
    for key, name, rows in (("qkv", "self_attention.query_key_value", qkv_rows),
                            ("o", "self_attention.dense", None),
                            ("gate_up", "mlp.dense_h_to_4h", None),
                            ("down", "mlp.dense_4h_to_h", None)):
        for li, p in enumerate(layer):
            st.weight(f"{key}.w", li, p + name + ".weight", rows)
        for li, p in enumerate(layer):
            st.vector(f"{key}.b", li, p + name + ".bias", rows)
    for key, name in (("input_norm", "input_layernorm"),
                      ("post_norm", "post_attention_layernorm")):
        for li, p in enumerate(layer):
            st.vector(key, li, p + name + ".weight")
            st.vector(key + "_b", li, p + name + ".bias")
    pre = "transformer."
    embed = _take(sd, pre + "word_embeddings.weight", dev)
    head = _take(sd, "lm_head.weight", dev) if "lm_head.weight" in sd else None
    params = _tree(st, cfg, embed, head)
    for key, name in (("embed_norm", "word_embeddings_layernorm"), ("final_norm", "ln_f")):
        params[key] = _take(sd, pre + name + ".weight", dev)
        params[key + "_b"] = _take(sd, pre + name + ".bias", dev)
    return params


def convert_mpt(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """MPT (``qspec_tpu/model_loader/families.py::convert_mpt``):
    ``transformer.blocks.*`` names, the fused Wqkv already in q|k|v order,
    bias-free LayerNorms under no_bias (their betas where the checkpoint
    has them), gelu up/down MLP, the head tied to ``wte``."""
    dev = _device(sd, device)
    st = _Stacker(sd, cfg.num_layers, dev)
    layer = [f"transformer.blocks.{li}." for li in range(cfg.num_layers)]
    for key, name in (("qkv", "attn.Wqkv"), ("o", "attn.out_proj"),
                      ("gate_up", "ffn.up_proj"), ("down", "ffn.down_proj")):
        for li, p in enumerate(layer):
            st.weight(f"{key}.w", li, p + name + ".weight")
        if cfg.linear_bias and _on_every_layer(sd, layer, (name + ".bias",)):
            for li, p in enumerate(layer):
                st.vector(f"{key}.b", li, p + name + ".bias")
    for key, name in (("input_norm", "norm_1"), ("post_norm", "norm_2")):
        beta = _on_every_layer(sd, layer, (name + ".bias",))
        for li, p in enumerate(layer):
            st.vector(key, li, p + name + ".weight")
            if beta:
                st.vector(key + "_b", li, p + name + ".bias")
    pre = "transformer."
    params = _tree(st, cfg, _take(sd, pre + "wte.weight", dev), None)
    params["final_norm"] = _take(sd, pre + "norm_f.weight", dev)
    if pre + "norm_f.bias" in sd:
        params["final_norm_b"] = _take(sd, pre + "norm_f.bias", dev)
    return params


def convert_deepseek(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """DeepSeek-MoE V1 (``qspec_tpu/model_loader/families.py::
    convert_deepseek``): llama attention keys; the first ``first_k_dense``
    layers keep a dense MLP (``layers_dense``), the rest carry the router
    ``mlp.gate``, the experts ``mlp.experts.{e}.*_proj`` stacked [L, E, ...]
    and the ungated shared experts ``mlp.shared_experts.*``; the head
    untied unless the checkpoint has none; the rope cache."""
    dev = _device(sd, device)
    E = cfg.num_experts
    segs = {key: _Stacker(sd, L, dev) for key, L, _ in layer_stacks(cfg)}

    def t(name):
        return _take(sd, name, dev).t()

    for key, seg_cfg, li, wi in layer_segments(cfg):
        p = f"model.layers.{li}."
        st = segs[key]
        st.put("qkv", wi, torch.cat([t(p + f"self_attn.{n}_proj.weight") for n in "qkv"], 1))
        st.put("o", wi, t(p + "self_attn.o_proj.weight"))
        st.vector("input_norm", wi, p + "input_layernorm.weight")
        st.vector("post_norm", wi, p + "post_attention_layernorm.weight")
        m = p + "mlp."
        if not seg_cfg.num_experts:
            st.put("gate_up", wi, torch.cat([t(m + "gate_proj.weight"),
                                             t(m + "up_proj.weight")], 1))
            st.put("down", wi, t(m + "down_proj.weight"))
            continue
        st.put("router", wi, t(m + "gate.weight"))
        for e in range(E):
            x = f"{m}experts.{e}."
            st.put("experts_gate_up", (wi, e), torch.cat([t(x + "gate_proj.weight"),
                                                          t(x + "up_proj.weight")], 1),
                   experts=E)
            st.put("experts_down", (wi, e), t(x + "down_proj.weight"), experts=E)
        if cfg.shared_expert_intermediate_size:
            x = m + "shared_experts."
            st.put("shared_gate_up", wi, torch.cat([t(x + "gate_proj.weight"),
                                                    t(x + "up_proj.weight")], 1))
            st.put("shared_down", wi, t(x + "down_proj.weight"))
    params = {}
    for key, st in segs.items():
        o = st.out
        params[key] = {**{n: {"w": o.pop(n)} for n in PROJ_KEYS if n in o}, **o}
    embed = _take(sd, "model.embed_tokens.weight", dev)
    head = _take(sd, "lm_head.weight", dev) if "lm_head.weight" in sd else None
    params.update(embed=embed, lm_head=embed.t() if head is None else head.t().contiguous(),
                  final_norm=_take(sd, "model.norm.weight", dev), **position_params(cfg, dev))
    return params


def convert_deepseek_v2(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """DeepSeek-V2 / V3 and MiniCPM3 (``qspec_tpu/model_loader/families.py::
    convert_deepseek_v2``): multi-head latent attention's keys, the q
    projection ``q_proj`` (``mla_q``) or its low-rank pair ``q_a_proj`` /
    ``q_a_layernorm`` / ``q_b_proj`` (``mla_q_a``, ``mla_q_norm``,
    ``mla_q_b``), ``kv_a_proj_with_mqa`` (``mla_kv_a``: the latent and the
    rope key), ``kv_a_layernorm`` (``mla_kv_norm``), ``kv_b_proj`` stored
    [kv_lora_rank, heads, qk_nope + v] (``mla_kv_b``) for the absorbed form,
    ``o_proj``; DeepSeek-MoE's MLPs, the dense prefix in ``layers_dense``
    (as ``convert_deepseek``), V3's selection bias
    ``e_score_correction_bias`` in f32 (``router_bias``; zeros under
    noaux_tc where the checkpoint has none); the head untied unless the
    checkpoint has none; the rope cache at the rope key's width."""
    dev = _device(sd, device)
    E = cfg.num_experts
    nh, r = cfg.num_heads, cfg.kv_lora_rank
    segs = {key: _Stacker(sd, L, dev) for key, L, _ in layer_stacks(cfg)}

    def t(name):
        return _take(sd, name, dev).t()

    for key, seg_cfg, li, wi in layer_segments(cfg):
        p = f"model.layers.{li}."
        a = p + "self_attn."
        st = segs[key]
        if cfg.q_lora_rank:
            st.put("mla_q_a", wi, t(a + "q_a_proj.weight"))
            st.vector("mla_q_norm", wi, a + "q_a_layernorm.weight")
            st.put("mla_q_b", wi, t(a + "q_b_proj.weight"))
        else:
            st.put("mla_q", wi, t(a + "q_proj.weight"))
        st.put("mla_kv_a", wi, t(a + "kv_a_proj_with_mqa.weight"))
        st.vector("mla_kv_norm", wi, a + "kv_a_layernorm.weight")
        st.put("mla_kv_b", wi, t(a + "kv_b_proj.weight").reshape(
            r, nh, cfg.qk_nope_head_dim + cfg.v_head_dim))
        st.put("o", wi, t(a + "o_proj.weight"))
        st.vector("input_norm", wi, p + "input_layernorm.weight")
        st.vector("post_norm", wi, p + "post_attention_layernorm.weight")
        m = p + "mlp."
        if not seg_cfg.num_experts:
            st.put("gate_up", wi, torch.cat([t(m + "gate_proj.weight"),
                                             t(m + "up_proj.weight")], 1))
            st.put("down", wi, t(m + "down_proj.weight"))
            continue
        st.put("router", wi, t(m + "gate.weight"))
        bias = sd.pop(m + "gate.e_score_correction_bias", None)
        if bias is not None or cfg.moe_routing == "noaux_tc":
            st.put("router_bias", wi, torch.zeros(E, dtype=torch.float32, device=dev)
                   if bias is None else _tensor(bias).to(device=dev, dtype=torch.float32))
        for e in range(E):
            x = f"{m}experts.{e}."
            st.put("experts_gate_up", (wi, e), torch.cat([t(x + "gate_proj.weight"),
                                                          t(x + "up_proj.weight")], 1),
                   experts=E)
            st.put("experts_down", (wi, e), t(x + "down_proj.weight"), experts=E)
        if cfg.shared_expert_intermediate_size:
            x = m + "shared_experts."
            st.put("shared_gate_up", wi, torch.cat([t(x + "gate_proj.weight"),
                                                    t(x + "up_proj.weight")], 1))
            st.put("shared_down", wi, t(x + "down_proj.weight"))
    params = {}
    for key, st in segs.items():
        o = st.out
        params[key] = {**{n: {"w": o.pop(n)} for n in PROJ_KEYS + MLA_PROJ_KEYS if n in o},
                       **o}
    embed = _take(sd, "model.embed_tokens.weight", dev)
    head = _take(sd, "lm_head.weight", dev) if "lm_head.weight" in sd else None
    params.update(embed=embed, lm_head=embed.t() if head is None else head.t().contiguous(),
                  final_norm=_take(sd, "model.norm.weight", dev), **position_params(cfg, dev))
    return params


def _tied_head(sd: Dict, cfg: ModelConfig, dev, name: str = "lm_head.weight"):
    """The untied head's [V, H] tensor (``name``), or None for a tied model
    (a tied checkpoint's own head, where it has one, is dropped)."""
    head = sd.pop(name, None)
    if cfg.tie_word_embeddings or head is None:
        return None
    return _take({"h": head}, "h", dev)


def convert_falcon(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """Falcon (``qspec_tpu/model_loader/families.py::convert_falcon``):
    ``transformer.h.*`` names, the fused ``query_key_value`` in its three
    layouts, one formula: rows [nkv, q_per_group + 2, dh] de-interleaved to
    q|k|v (multi-query 7B: one group, already q|k|v; new-decoder GQA 40B /
    180B: nkv groups; falcon-rw: nh groups of one, [nh, 3, dh], with its
    bias); exact-gelu MLP; biases under ``linear_bias``; the tied head. The
    norms: ``input_layernorm`` (7B, rw) or ``ln_attn`` (new decoder) as the
    input norm; falcon-rw's ``post_attention_layernorm``, or under
    ``parallel_norms=2`` ``ln_mlp``, as ``post_norm`` (the JAX converter
    reads no ``ln_mlp``: ROADMAP §3)."""
    dev = _device(sd, device)
    nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nh // nkv
    st = _Stacker(sd, cfg.num_layers, dev)

    def qkv_rows(t):
        r = t.reshape(nkv, g + 2, dh, *t.shape[1:])
        return torch.cat([r[:, :g].reshape(nh * dh, *t.shape[1:]),
                          r[:, g].reshape(nkv * dh, *t.shape[1:]),
                          r[:, g + 1].reshape(nkv * dh, *t.shape[1:])])

    layer = [f"transformer.h.{li}." for li in range(cfg.num_layers)]
    for key, name, rows in (("qkv", "self_attention.query_key_value", qkv_rows),
                            ("o", "self_attention.dense", None),
                            ("gate_up", "mlp.dense_h_to_4h", None),
                            ("down", "mlp.dense_4h_to_h", None)):
        for li, p in enumerate(layer):
            st.weight(f"{key}.w", li, p + name + ".weight", rows)
        if cfg.linear_bias:
            for li, p in enumerate(layer):
                st.vector(f"{key}.b", li, p + name + ".bias", rows)
    post = ("ln_mlp" if cfg.parallel_norms == 2 else
            None if cfg.parallel_block else "post_attention_layernorm")
    for li, p in enumerate(layer):
        first = "input_layernorm" if p + "input_layernorm.weight" in sd else "ln_attn"
        for key, name in (("input_norm", first), ("post_norm", post)):
            if name is not None:
                st.vector(key, li, p + name + ".weight")
                st.vector(key + "_b", li, p + name + ".bias")
    pre = "transformer."
    embed = _take(sd, pre + "word_embeddings.weight", dev)
    params = _tree(st, cfg, embed, _tied_head(sd, cfg, dev))
    params["final_norm"] = _take(sd, pre + "ln_f.weight", dev)
    params["final_norm_b"] = _take(sd, pre + "ln_f.bias", dev)
    return params


def convert_jais(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """JAIS (``qspec_tpu/model_loader/families.py::convert_jais``): GPT-2's
    ``transformer.h.*`` names and Conv1D weights, stored [in, out] (no
    transpose), the fused c_attn already q|k|v, biases everywhere, the tied
    head, ALiBi. The swiglu pair: JAIS's MLP is c_fc(x) * silu(c_fc2(x))
    (its SwiGLUActivation(x1, x2) = x1 * silu(x2), x1 = c_fc), so the gate
    is ``c_fc2`` and ``gate_up`` = [c_fc2 | c_fc]; the JAX converter puts
    c_fc first and so applies the silu to the other half (ROADMAP §3)."""
    dev = _device(sd, device)
    st = _Stacker(sd, cfg.num_layers, dev)

    def conv(name):
        return _take(sd, name, dev)

    for li in range(cfg.num_layers):
        p = f"transformer.h.{li}."
        for key, names in (("qkv", ("attn.c_attn",)), ("o", ("attn.c_proj",)),
                           ("gate_up", ("mlp.c_fc2", "mlp.c_fc")), ("down", ("mlp.c_proj",))):
            st.put(f"{key}.w", li, torch.cat([conv(p + n + ".weight") for n in names], 1))
            st.put(f"{key}.b", li, torch.cat([conv(p + n + ".bias") for n in names]))
        for key, name in (("input_norm", "ln_1"), ("post_norm", "ln_2")):
            st.vector(key, li, p + name + ".weight")
            st.vector(key + "_b", li, p + name + ".bias")
    pre = "transformer."
    params = _tree(st, cfg, _take(sd, pre + "wte.weight", dev), None)
    sd.pop("lm_head.weight", None)          # tied
    params["final_norm"] = _take(sd, pre + "ln_f.weight", dev)
    params["final_norm_b"] = _take(sd, pre + "ln_f.bias", dev)
    return params


def _family(sd: Dict, cfg: ModelConfig, device, layer_prefix: str, projections: Dict,
            norms: Dict[str, str], embed: str, final_norm: str,
            head: str = "lm_head.weight") -> dict:
    """One converter of the parallel-residual families' layouts:
    ``projections`` maps qkv / o / gate_up / down to (the HF [out, in]
    weights whose rows it stacks, a row reorder or None), each with its
    bias where every layer has it (some layers only: a ValueError);
    ``norms`` input_norm / post_norm to their LayerNorm names (a beta where
    every layer has one, as for the biases: Cohere's have none); the
    embedding, the final norm and the head (untied unless the config ties
    it; its bias ``lm_head_b`` under ``lm_head_bias``). One stack is filled
    at a time, the state dict consumed."""
    dev = _device(sd, device)
    st = _Stacker(sd, cfg.num_layers, dev)
    layer = [f"{layer_prefix}{li}." for li in range(cfg.num_layers)]

    for key, (names, rows) in projections.items():
        bias = _on_every_layer(sd, layer, [n + ".bias" for n in names])
        for kind in (".weight", ".bias") if bias else (".weight",):
            for li, p in enumerate(layer):
                t = torch.cat([_take(sd, p + n + kind, dev) for n in names])
                t = t if rows is None else rows(t)
                st.put(key + kind[:2], li, t.t() if kind == ".weight" else t)
    for key, name in norms.items():
        beta = _on_every_layer(sd, layer, (name + ".bias",))
        for li, p in enumerate(layer):
            st.vector(key, li, p + name + ".weight")
            if beta:
                st.vector(key + "_b", li, p + name + ".bias")
    params = _tree(st, cfg, _take(sd, embed, dev), _tied_head(sd, cfg, dev, head))
    params["final_norm"] = _take(sd, final_norm + ".weight", dev)
    if final_norm + ".bias" in sd:
        params["final_norm_b"] = _take(sd, final_norm + ".bias", dev)
    if cfg.lm_head_bias:
        params["lm_head_b"] = _take(sd, head[:-len("weight")] + "bias", dev)
    return params


QKV = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")
INPUT_NORM = {"input_norm": "input_layernorm"}
BOTH_NORMS = {**INPUT_NORM, "post_norm": "post_attention_layernorm"}
GATED = {"gate_up": (("mlp.gate_proj", "mlp.up_proj"), None), "down": (("mlp.down_proj",), None)}


def convert_gptj(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """GPT-J (``qspec_tpu/model_loader/families.py::convert_gptj``):
    ``transformer.h.*`` names, unbiased q / k / v / out projections, the
    fc_in / fc_out MLP with biases, ln_1 shared by the parallel block,
    ``ln_f``, the head with its bias."""
    return _family(sd, cfg, device, "transformer.h.", {
        "qkv": (("attn.q_proj", "attn.k_proj", "attn.v_proj"), None),
        "o": (("attn.out_proj",), None), "gate_up": (("mlp.fc_in",), None),
        "down": (("mlp.fc_out",), None)}, {"input_norm": "ln_1"},
        "transformer.wte.weight", "transformer.ln_f")


def convert_gpt_neox(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """GPT-NeoX / Pythia (``...::convert_gpt_neox``): ``gpt_neox.*`` names,
    the fused ``query_key_value`` interleaved per head (rows [nh, 3, dh],
    de-interleaved to q|k|v with its bias), biases everywhere, the
    attention's and the MLP's LayerNorms (each the MLP's own input under
    the parallel residual), the untied ``embed_out`` head."""
    return _family(sd, cfg, device, "gpt_neox.layers.", {
        "qkv": (("attention.query_key_value",), _per_head_qkv(cfg.num_heads, cfg.head_dim)),
        "o": (("attention.dense",), None), "gate_up": (("mlp.dense_h_to_4h",), None),
        "down": (("mlp.dense_4h_to_h",), None)}, BOTH_NORMS,
        "gpt_neox.embed_in.weight", "gpt_neox.final_layer_norm", head="embed_out.weight")


def convert_phi(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """Phi-1 / 1.5 / 2 (``...::convert_phi``): llama-style names with
    biases, ``self_attn.dense``, the fc1 / fc2 MLP, one input LayerNorm a
    block (the parallel block), ``final_layernorm``, the head with its
    bias."""
    return _family(sd, cfg, device, "model.layers.", {
        "qkv": (QKV, None), "o": (("self_attn.dense",), None),
        "gate_up": (("mlp.fc1",), None), "down": (("mlp.fc2",), None)}, INPUT_NORM,
        "model.embed_tokens.weight", "model.final_layernorm")


def convert_stablelm(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """StableLM (``...::convert_stablelm``): llama names, LayerNorms with
    biases, the gated MLP, the qkv bias where the checkpoint has it
    (``use_qkv_bias``), ``model.norm`` with its bias."""
    return _family(sd, cfg, device, "model.layers.", {
        "qkv": (QKV, None), "o": (("self_attn.o_proj",), None), **GATED}, BOTH_NORMS,
        "model.embed_tokens.weight", "model.norm")


def convert_cohere(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """Cohere / Command-R (``...::convert_cohere``): llama names, one
    bias-free LayerNorm a block (the parallel block), the gated MLP, the
    q / k / v (and o) biases where the checkpoint has them
    (``attention_bias``; the JAX converter reads no o bias), a bias-free
    final norm, the head tied to the embedding."""
    return _family(sd, cfg, device, "model.layers.", {
        "qkv": (QKV, None), "o": (("self_attn.o_proj",), None), **GATED}, INPUT_NORM,
        "model.embed_tokens.weight", "model.norm")


# ---------------------------------------------------------------------------
# the llama graph under other key names
# ---------------------------------------------------------------------------


def _tensor(a) -> torch.Tensor:
    """A state dict entry as a tensor, on its own device and in its own
    dtype (a numpy array as float32)."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))


def _rename(sd: Dict, cfg: ModelConfig, layer_prefix: str, layer_names: Dict[str, str],
            top_names: Dict[str, str]) -> None:
    """Move ``{layer_prefix}{li}.{a}`` to ``model.layers.{li}.{b}`` for each
    (a, b) of ``layer_names`` (every one required), and each present
    top-level name of ``top_names`` to its llama name, in place."""
    for li in range(cfg.num_layers):
        for a, b in layer_names.items():
            sd[f"model.layers.{li}.{b}"] = sd.pop(f"{layer_prefix}{li}.{a}")
    for a, b in top_names.items():
        if a in sd:
            sd[b] = sd.pop(a)


def _split_rows(sd: Dict, src: str, dst: str, names, width: int) -> None:
    """Pop the fused ``src`` ([len(names) * width, ...] rows) and store its
    row blocks under ``dst`` + each name (views of the one tensor)."""
    t = _tensor(sd.pop(src))
    for i, n in enumerate(names):
        sd[dst.format(n)] = t[i * width:(i + 1) * width]


def baichuan_to_llama_keys(sd: Dict, cfg: ModelConfig) -> Dict:
    """Baichuan / Baichuan2 (``qspec_tpu/model_loader/families.py::
    baichuan_to_llama_keys``): llama keys but the fused ``W_pack`` ([3H, H]
    rows q|k|v), split here; Baichuan2's NormHead (vocab 125696): the head's
    rows L2-normalized in float32, as its modeling code and vLLM's
    ``baichuan.py`` normalize them (the JAX remap does not: ROADMAP §3)."""
    H = cfg.hidden_size
    for k in [k for k in sd if k.endswith("self_attn.W_pack.weight")]:
        base = k[:-len("W_pack.weight")]
        _split_rows(sd, k, base + "{}_proj.weight", "qkv", H)
    if cfg.vocab_size == BAICHUAN2_VOCAB and "lm_head.weight" in sd:
        head = _tensor(sd.pop("lm_head.weight")).to(torch.float32)
        sd["lm_head.weight"] = torch.nn.functional.normalize(head, dim=1)
        del head
    return sd


def internlm2_to_llama_keys(sd: Dict, cfg: ModelConfig) -> Dict:
    """InternLM2 (``...::internlm2_to_llama_keys``): ``tok_embeddings`` /
    ``output`` naming, ``attention.wqkv`` packed per KV group as rows
    [nkv, q_per_group + 2, dh] (de-interleaved to q|k|v here),
    ``feed_forward.w1 / w3 / w2`` the gate, up and down."""
    nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nh // nkv
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        w = _tensor(sd.pop(p + "attention.wqkv.weight"))
        r = w.reshape(nkv, g + 2, dh, w.shape[-1])
        sd[p + "self_attn.q_proj.weight"] = r[:, :g].reshape(nh * dh, -1)
        sd[p + "self_attn.k_proj.weight"] = r[:, g].reshape(nkv * dh, -1)
        sd[p + "self_attn.v_proj.weight"] = r[:, g + 1].reshape(nkv * dh, -1)
        del w, r
    _rename(sd, cfg, "model.layers.", {
        "attention.wo.weight": "self_attn.o_proj.weight",
        "feed_forward.w1.weight": "mlp.gate_proj.weight",
        "feed_forward.w3.weight": "mlp.up_proj.weight",
        "feed_forward.w2.weight": "mlp.down_proj.weight",
        "attention_norm.weight": "input_layernorm.weight",
        "ffn_norm.weight": "post_attention_layernorm.weight"},
        {"model.tok_embeddings.weight": "model.embed_tokens.weight",
         "output.weight": "lm_head.weight"})
    return sd


def qwen1_to_llama_keys(sd: Dict, cfg: ModelConfig) -> Dict:
    """Qwen v1 (``...::qwen1_to_llama_keys``): ``transformer.h.*`` names,
    the fused ``attn.c_attn`` ([3H, H] rows q|k|v) with its bias, RMSNorm
    ``ln_1`` / ``ln_2``, swiglu with the gate ``w2`` and the up ``w1``."""
    H = cfg.hidden_size
    for li in range(cfg.num_layers):
        p, o = f"transformer.h.{li}.attn.c_attn.", f"model.layers.{li}.self_attn."
        _split_rows(sd, p + "weight", o + "{}_proj.weight", "qkv", H)
        _split_rows(sd, p + "bias", o + "{}_proj.bias", "qkv", H)
    _rename(sd, cfg, "transformer.h.", {
        "attn.c_proj.weight": "self_attn.o_proj.weight",
        "mlp.w2.weight": "mlp.gate_proj.weight", "mlp.w1.weight": "mlp.up_proj.weight",
        "mlp.c_proj.weight": "mlp.down_proj.weight", "ln_1.weight": "input_layernorm.weight",
        "ln_2.weight": "post_attention_layernorm.weight"},
        {"transformer.wte.weight": "model.embed_tokens.weight",
         "transformer.ln_f.weight": "model.norm.weight"})
    return sd


def exaone_to_llama_keys(sd: Dict, cfg: ModelConfig) -> Dict:
    """EXAONE (``...::exaone_to_llama_keys``): the llama graph under
    ``transformer.h.{i}.{ln_1, attn.attention.*, ln_2, mlp.c_fc_0 / c_fc_1
    / c_proj}`` names, the gate ``c_fc_0`` and the up ``c_fc_1``."""
    _rename(sd, cfg, "transformer.h.", {
        **{f"attn.attention.{n}_proj.weight": f"self_attn.{n}_proj.weight" for n in "qkv"},
        "attn.attention.out_proj.weight": "self_attn.o_proj.weight",
        "mlp.c_fc_0.weight": "mlp.gate_proj.weight", "mlp.c_fc_1.weight": "mlp.up_proj.weight",
        "mlp.c_proj.weight": "mlp.down_proj.weight", "ln_1.weight": "input_layernorm.weight",
        "ln_2.weight": "post_attention_layernorm.weight"},
        {"transformer.wte.weight": "model.embed_tokens.weight",
         "transformer.ln_f.weight": "model.norm.weight"})
    return sd


def telechat2_to_llama_keys(sd: Dict, cfg: ModelConfig) -> Dict:
    """TeleChat2 (``...::telechat2_to_llama_keys``): a separate
    ``self_attention.query``, ``key_value`` fused per head as rows [h, 2,
    dh] (de-interleaved here), the o (``dense``) and down projections with
    biases, which the llama-keyed loaders read (and ``quantize_float``
    rotates), qkv and gate / up without."""
    nkv, dh = cfg.num_kv_heads, cfg.head_dim
    for li in range(cfg.num_layers):
        p, o = f"transformer.h.{li}.", f"model.layers.{li}.self_attn."
        kv = _tensor(sd.pop(p + "self_attention.key_value.weight"))
        r = kv.reshape(nkv, 2, dh, kv.shape[-1])
        sd[o + "k_proj.weight"] = r[:, 0].reshape(nkv * dh, -1)
        sd[o + "v_proj.weight"] = r[:, 1].reshape(nkv * dh, -1)
        del kv, r
    _rename(sd, cfg, "transformer.h.", {
        "self_attention.query.weight": "self_attn.q_proj.weight",
        "self_attention.dense.weight": "self_attn.o_proj.weight",
        "self_attention.dense.bias": "self_attn.o_proj.bias",
        **{f"mlp.{n}_proj.weight": f"mlp.{n}_proj.weight" for n in ("gate", "up", "down")},
        "mlp.down_proj.bias": "mlp.down_proj.bias",
        "input_layernorm.weight": "input_layernorm.weight",
        "post_attention_layernorm.weight": "post_attention_layernorm.weight"},
        {"transformer.word_embeddings.weight": "model.embed_tokens.weight",
         "transformer.ln_f.weight": "model.norm.weight"})
    return sd


# arch -> its remap onto llama keys (config.REMAP_ARCHS), applied in place
# by the llama-keyed loaders
LLAMA_KEY_REMAPS: Dict[str, Callable] = {
    "baichuan": baichuan_to_llama_keys, "internlm2": internlm2_to_llama_keys,
    "qwen": qwen1_to_llama_keys, "exaone": exaone_to_llama_keys,
    "telechat2": telechat2_to_llama_keys}


# the projections of a layer-stacked tree: dense, or an MoE's
PROJ_KEYS = ("qkv", "o", "gate_up", "down", "experts_gate_up", "experts_down",
             "shared_gate_up", "shared_down")
# and multi-head latent attention's (models/llama.py _mla_attention)
MLA_PROJ_KEYS = ("mla_q", "mla_q_a", "mla_q_b", "mla_kv_a")

# only the ported converters: a family not here raises in load_family_float
CONVERTERS: Dict[str, Callable] = {"bloom": convert_bloom, "mpt": convert_mpt,
                                   "deepseek": convert_deepseek, "falcon": convert_falcon,
                                   "jais": convert_jais, "gptj": convert_gptj,
                                   "gpt_neox": convert_gpt_neox, "phi": convert_phi,
                                   "stablelm": convert_stablelm, "cohere": convert_cohere,
                                   "deepseek_v2": convert_deepseek_v2,
                                   "deepseek_v3": convert_deepseek_v2}


def load_family_float(sd: Dict, cfg: ModelConfig, device=None):
    """Convert a family state dict (consumed) to (params, the served cfg:
    ``quant="none"``), as ``qspec_tpu/model_loader/families.py::
    load_family_float`` does."""
    cfg = dataclasses.replace(cfg, quant="none")
    fn = CONVERTERS.get(cfg.arch)
    if fn is None:
        raise NotImplementedError(f"no family converter for arch {cfg.arch!r} "
                                  f"(ported: {sorted(CONVERTERS)})")
    return fn(sd, cfg, device=device), cfg
