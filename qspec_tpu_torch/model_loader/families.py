"""Float state-dict converters of the non-llama-keyed families the port serves.

Port of ``qspec_tpu/model_loader/families.py`` for BLOOM, MPT and
DeepSeek-MoE: a family's checkpoint layout (BLOOM's head-interleaved fused
``query_key_value``, MPT's ``transformer.blocks.*`` naming, DeepSeek's dense
prefix and shared experts) is translated into the bf16 parameter tree that
``models/llama.py`` serves with the family's knobs (LayerNorm, linear
biases, the non-gated MLP, ALiBi; the MoE MLP), the layout of the JAX
converters' output.

The converters take numpy arrays or torch tensors (of any float dtype, on
any device: a state dict made on the card converts there) and consume the
dict they are given: each source entry is removed as it is converted, and
the layer stacks are filled one at a time, so the peak memory stays near one
copy of the weights plus one stack (a 4 GB MLP stack at BLOOM-7B1). The weights are rounded
to bf16 as the JAX converters round them (from the source's exact float32
value, to nearest even). The rope cache that the JAX ``_finish`` adds is
left out of BLOOM's and MPT's trees: ALiBi has no rope.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models.llama import alibi_params, layer_segments, layer_stacks
from qspec_tpu_torch.ops.rotary import make_rope_cache


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


def _tree(st: _Stacker, cfg: ModelConfig, embed: torch.Tensor, lm_head) -> dict:
    """The served tree from the stacks: projections {"w"[, "b"]}, the norms
    and their betas, the head (the embedding's transposed storage when
    tied), the ALiBi slopes."""
    o = st.out
    layers = {name: {"w": o[f"{name}.w"], **({"b": o[f"{name}.b"]} if f"{name}.b" in o else {})}
              for name in ("qkv", "o", "gate_up", "down")}
    for name in ("input_norm", "post_norm", "input_norm_b", "post_norm_b"):
        if name in o:
            layers[name] = o[name]
    head = embed.t() if lm_head is None else lm_head.t().contiguous()
    return {"embed": embed, "layers": layers, "lm_head": head,
            **alibi_params(cfg, embed.device)}


def convert_bloom(sd: Dict, cfg: ModelConfig, device=None) -> dict:
    """BLOOM (``qspec_tpu/model_loader/families.py::convert_bloom``):
    ``transformer.*`` names, the embedding LayerNorm, the head-interleaved
    fused ``query_key_value`` (rows [nh, 3, dh], de-interleaved to q|k|v
    with its bias), tanh-gelu MLP with biases, tied head."""
    dev = _device(sd, device)
    nh, dh, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    st = _Stacker(sd, cfg.num_layers, dev)

    def qkv_rows(t):
        return t.reshape(nh, 3, dh, *t.shape[1:]).transpose(0, 1).reshape(3 * H, *t.shape[1:])

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
        for li, p in enumerate(layer):
            if cfg.linear_bias and p + name + ".bias" in sd:
                st.vector(f"{key}.b", li, p + name + ".bias")
    for key, name in (("input_norm", "norm_1"), ("post_norm", "norm_2")):
        for li, p in enumerate(layer):
            st.vector(key, li, p + name + ".weight")
            if p + name + ".bias" in sd:
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
                  final_norm=_take(sd, "model.norm.weight", dev),
                  rope_cache=make_rope_cache(cfg.head_dim, cfg.max_position_embeddings,
                                             cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                                             device=dev))
    return params


# the projections of a layer-stacked tree: dense, or an MoE's
PROJ_KEYS = ("qkv", "o", "gate_up", "down", "experts_gate_up", "experts_down",
             "shared_gate_up", "shared_down")

# only the ported converters: a family not here raises in load_family_float
CONVERTERS: Dict[str, Callable] = {"bloom": convert_bloom, "mpt": convert_mpt,
                                   "deepseek": convert_deepseek}


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
