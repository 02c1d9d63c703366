"""Model registry: Hugging Face architecture names -> ModelConfig.

Port of ``qspec_tpu/models/registry.py::resolve`` for the architectures
whose graph the port has, all the llama graph of ``models/llama.py`` with
its knobs: the dense families ``LlamaForCausalLM`` (and the reference's
QuaRot ``QuarotLlamaForCausalLM`` / ``llama_quarot``),
``MistralForCausalLM`` (the window), ``Phi3ForCausalLM`` (fused q/k/v and
gate/up, longrope), ``Qwen2ForCausalLM`` (and the reference's
``Qwen2QuaRotForCausalLM`` / ``qwen2_quarot``: the qkv bias),
``Qwen3ForCausalLM`` (the q/k norms), ``GemmaForCausalLM`` (tanh GeGLU,
embedding scale, (1+w) norms, head dim 256) and ``GraniteForCausalLM`` (its
four multipliers), QuaRot-quantized at load, read as QSpec or AWQ / GPTQ
checkpoints, or served in bf16; ``Gemma2ForCausalLM`` (softcaps, post-block
norms, alternating window; AWQ / GPTQ); ``BloomForCausalLM`` and
``MPTForCausalLM`` (ALiBi, LayerNorm, non-gated MLP; bf16 checkpoints,
``model_loader/families.py``); and the sparse-MoE families
(``_moe_block``): ``MixtralForCausalLM``, ``Qwen2MoeForCausalLM`` (the
shared expert, the qkv bias), ``Qwen3MoeForCausalLM`` (the q/k norms) and
``DeepseekForCausalLM`` (a dense prefix, ungated shared experts; bf16
checkpoints).

The llama graph under other key names (``LLAMA_KEY_REMAPS``), QuaRot at
load or bf16: ``BaiChuanForCausalLM`` (Baichuan-7B, rope),
``BaichuanForCausalLM`` (rope at hidden 4096: Baichuan2-7B; ALiBi
otherwise: Baichuan-13B, Baichuan2-13B, served in bf16, as vLLM's
``baichuan.py`` picks; the JAX registry gives every one ALiBi),
``InternLM2ForCausalLM`` / ``InternLM2VEForCausalLM``, ``QWenLMHeadModel``
(Qwen v1), ``ExaoneForCausalLM``, ``TeleChat2ForCausalLM``; and in bf16
``FalconForCausalLM`` / ``RWForCausalLM`` (parallel blocks, or falcon-rw's
ALiBi) and ``JAISLMHeadModel``.

The gptj rope and partial rotary: in bf16 the parallel-residual families
``GPTJForCausalLM``, ``GPTNeoXForCausalLM`` (Pythia), ``PhiForCausalLM``
(Phi-1 / 1.5 / 2), ``StableLmForCausalLM`` / ``StableLMEpochForCausalLM``
and ``CohereForCausalLM`` (Command-R), converted by
``model_loader/families.py``; the llama-keyed ``GlmForCausalLM`` (GLM-4:
the qkv bias, the fused gate_up_proj, half-width interleaved rope) and
``HeliumForCausalLM`` (the interleaved rope), through the llama-keyed
loaders, Helium under QuaRot too.

Multi-head latent attention (``models/llama.py _mla_attention``), in bf16
through ``convert_deepseek_v2``: ``DeepseekV2ForCausalLM`` (DeepSeek-V2 /
V2-Lite: the latent cache, direct or low-rank q, the MoE with
``routed_scaling_factor``), ``DeepseekV3ForCausalLM`` (its noaux_tc
routing: sigmoid scores, ``n_group`` / ``topk_group``, the selection bias)
and ``MiniCPM3ForCausalLM`` (dense MLA with q-LoRA and MiniCPM's muP scales,
read as the JAX registry reads it, arch ``deepseek_v2``; its longrope
``rope_scaling`` too, which the JAX package drops: ROADMAP §3). ``Cohere2ForCausalLM`` and
``Glm4ForCausalLM`` are named only to raise, naming ROADMAP queue 1 item 9
(the JAX registry maps them onto Cohere and GLM and drops their other
layers' knobs). A plugin (``plugins.py``) registers more with
``register_model``: its function maps the config.json dict to a
ModelConfig, and comes before the table. Any other architecture raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

from qspec_tpu_torch.config import LLAMA_GRAPH_TYPES, ModelConfig, _rope_scaling

# architecture (or, as in the JAX package's registry, the bare model type)
# -> the model type its config is read as
ARCHITECTURES = {"LlamaForCausalLM": "llama", "QuarotLlamaForCausalLM": "llama",
                 "llama_quarot": "llama", "MistralForCausalLM": "mistral",
                 "Phi3ForCausalLM": "phi3", "phi3": "phi3",
                 "Qwen2ForCausalLM": "qwen2", "Qwen2QuaRotForCausalLM": "qwen2",
                 "qwen2_quarot": "qwen2", "Qwen3ForCausalLM": "qwen3", "qwen3": "qwen3",
                 "GemmaForCausalLM": "gemma", "gemma": "gemma",
                 "GraniteForCausalLM": "granite", "granite": "granite",
                 "Gemma2ForCausalLM": "gemma2",
                 "gemma2": "gemma2", "BloomForCausalLM": "bloom", "bloom": "bloom",
                 "MPTForCausalLM": "mpt", "MptForCausalLM": "mpt", "mpt": "mpt",
                 "MixtralForCausalLM": "mixtral", "mixtral": "mixtral",
                 "Qwen2MoeForCausalLM": "qwen2_moe", "qwen2_moe": "qwen2_moe",
                 "Qwen3MoeForCausalLM": "qwen3_moe", "qwen3_moe": "qwen3_moe",
                 "DeepseekForCausalLM": "deepseek", "deepseek": "deepseek",
                 "BaiChuanForCausalLM": "baichuan", "BaichuanForCausalLM": "baichuan",
                 "baichuan": "baichuan", "InternLM2ForCausalLM": "internlm2",
                 "InternLM2VEForCausalLM": "internlm2", "internlm2": "internlm2",
                 "QWenLMHeadModel": "qwen", "qwen": "qwen",
                 "ExaoneForCausalLM": "exaone", "exaone": "exaone",
                 "TeleChat2ForCausalLM": "telechat2", "telechat2": "telechat2",
                 "FalconForCausalLM": "falcon", "RWForCausalLM": "falcon", "falcon": "falcon",
                 "JAISLMHeadModel": "jais", "jais": "jais",
                 "GPTJForCausalLM": "gptj", "gptj": "gptj",
                 "GPTNeoXForCausalLM": "gpt_neox", "gpt_neox": "gpt_neox",
                 "PhiForCausalLM": "phi", "phi": "phi",
                 "StableLmForCausalLM": "stablelm", "StableLMEpochForCausalLM": "stablelm",
                 "stablelm": "stablelm", "CohereForCausalLM": "cohere", "cohere": "cohere",
                 "Cohere2ForCausalLM": "cohere2", "GlmForCausalLM": "glm", "glm": "glm",
                 "Glm4ForCausalLM": "glm4", "HeliumForCausalLM": "helium", "helium": "helium",
                 "DeepseekV2ForCausalLM": "deepseek_v2", "deepseek_v2": "deepseek_v2"}
# the architectures whose config.json model type the JAX registry keeps (its
# LlamaForCausalLM, MistralForCausalLM and Phi3ForCausalLM entries call
# from_hf_config on the dict as it is; a Qwen2 entry then sets the qwen2
# arch and the qkv bias): a QuaRot checkpoint's "llama_quarot" or
# "qwen2_quarot" model type reads as llama or qwen2 by substring there too;
# a model type that names none of the llama graph's families reads as the
# architecture's own, as the JAX package's llama fallback reads it
KEEP_MODEL_TYPE = {"LlamaForCausalLM", "QuarotLlamaForCausalLM", "llama_quarot",
                   "MistralForCausalLM", "Phi3ForCausalLM", "phi3"}


# architecture -> a function (config.json dict -> ModelConfig), registered by
# plugins (register_model)
_REGISTRY: Dict[str, Callable[[dict], ModelConfig]] = {}


def _deepseek_v3(hf: dict) -> ModelConfig:
    """DeepSeek-V3 / R1 (the JAX registry's ``_deepseek_v3``): DeepSeek-V2's
    MLA and MoE graph read by the deepseek_v2 reader, with noaux_tc routing:
    sigmoid scores, the selection bias, ``n_group`` / ``topk_group``,
    ``norm_topk_prob`` (default true); a ``topk_method`` other than noaux_tc
    or greedy raises."""
    if hf.get("topk_method", "noaux_tc") not in ("noaux_tc", "greedy"):
        raise ValueError(f"deepseek-v3 topk_method {hf['topk_method']!r} unsupported")
    cfg = ModelConfig.from_hf_config(dict(hf, model_type="deepseek_v2", topk_method="greedy"))
    return dataclasses.replace(
        cfg, arch="deepseek_v3", moe_routing="noaux_tc", moe_n_group=hf.get("n_group", 1) or 1,
        moe_topk_group=hf.get("topk_group", 1) or 1,
        moe_norm_topk_prob=hf.get("norm_topk_prob", True), moe_softmax_before_topk=False)


def _minicpm3(hf: dict) -> ModelConfig:
    """MiniCPM3 (the JAX registry's ``_minicpm3``): dense MLA with q-LoRA,
    arch ``deepseek_v2`` (its checkpoint keys), MiniCPM's muP scales
    (``scale_emb`` on the embeddings, ``scale_depth / sqrt(L)`` on each
    block's output, the logits divided by ``hidden_size /
    dim_model_base``), a tied head by default. Past the JAX package, its
    ``rope_scaling`` (MiniCPM3-4B's longrope) is read as Hugging Face reads
    it (``make_rope_cache``'s longrope branch); the JAX registry drops it."""
    nh, L = hf["num_attention_heads"], hf["num_hidden_layers"]
    return ModelConfig(
        arch="deepseek_v2", attention_type="mla", kv_lora_rank=hf["kv_lora_rank"],
        q_lora_rank=hf.get("q_lora_rank"), qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf.get("v_head_dim", hf["hidden_size"] // nh),
        rotary_dim=hf["qk_rope_head_dim"], vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"], intermediate_size=hf["intermediate_size"],
        num_layers=L, num_heads=nh, num_kv_heads=nh,
        head_dim=hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"],
        rope_theta=hf.get("rope_theta", 10000.0), rope_scaling=_rope_scaling(hf),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf.get("max_position_embeddings", 32768), quant="none",
        embed_scale=float(hf.get("scale_emb", 1.0)) or None,
        residual_multiplier=float(hf.get("scale_depth", math.sqrt(L))) / math.sqrt(L),
        logits_scaling=(hf["hidden_size"] / hf["dim_model_base"]
                        if hf.get("dim_model_base") else None),
        tie_word_embeddings=hf.get("tie_word_embeddings", True))


# the architectures (and bare model types) read by a translator of their own,
# as the JAX registry's
TRANSLATORS: Dict[str, Callable[[dict], ModelConfig]] = {
    "DeepseekV3ForCausalLM": _deepseek_v3, "deepseek_v3": _deepseek_v3,
    "MiniCPM3ForCausalLM": _minicpm3, "minicpm3": _minicpm3}


def register_model(arch: str):
    """Decorator: register ``fn(hf_config) -> ModelConfig`` for ``arch``
    (the plugin-facing name of the JAX package's ``register``)."""
    def deco(fn):
        _REGISTRY[arch] = fn
        return fn
    return deco


def supported_architectures():
    return sorted({*ARCHITECTURES, *TRANSLATORS, *_REGISTRY})


def resolve(hf_config: dict) -> ModelConfig:
    """The ModelConfig of a Hugging Face config.json dict, by its first
    ported or registered architecture (the plugins are loaded first)."""
    from qspec_tpu_torch.plugins import load_general_plugins
    load_general_plugins()
    archs = hf_config.get("architectures") or [hf_config.get("model_type", "")]
    for a in archs:
        if a in _REGISTRY:
            return _REGISTRY[a](hf_config)
        if a in TRANSLATORS:
            return TRANSLATORS[a](hf_config)
        if a in ARCHITECTURES:
            mt = hf_config.get("model_type", "") if a in KEEP_MODEL_TYPE else ""
            if not any(f in mt for f, _ in LLAMA_GRAPH_TYPES):
                mt = ARCHITECTURES[a]
            cfg = ModelConfig.from_hf_config({**hf_config, "model_type": mt})
            if a == "BaichuanForCausalLM" and hf_config["hidden_size"] != 4096:
                # Baichuan-13B / Baichuan2-13B
                cfg = dataclasses.replace(cfg, position_embedding="alibi")
            return cfg
    raise NotImplementedError(f"unsupported architectures {archs}; ported: "
                              f"{supported_architectures()}")
