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
loaders, Helium under QuaRot too. ``Cohere2ForCausalLM`` and
``Glm4ForCausalLM`` are named only to raise, naming ROADMAP queue 1 item 9
(the JAX registry maps them onto Cohere and GLM and drops their other
layers' knobs). A plugin (``plugins.py``) registers more with
``register_model``: its function maps the config.json dict to a
ModelConfig, and comes before the table. Any other architecture raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from qspec_tpu_torch.config import LLAMA_GRAPH_TYPES, ModelConfig

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
                 "Glm4ForCausalLM": "glm4", "HeliumForCausalLM": "helium", "helium": "helium"}
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


def register_model(arch: str):
    """Decorator: register ``fn(hf_config) -> ModelConfig`` for ``arch``
    (the plugin-facing name of the JAX package's ``register``)."""
    def deco(fn):
        _REGISTRY[arch] = fn
        return fn
    return deco


def supported_architectures():
    return sorted({*ARCHITECTURES, *_REGISTRY})


def resolve(hf_config: dict) -> ModelConfig:
    """The ModelConfig of a Hugging Face config.json dict, by its first
    ported or registered architecture (the plugins are loaded first)."""
    from qspec_tpu_torch.plugins import load_general_plugins
    load_general_plugins()
    archs = hf_config.get("architectures") or [hf_config.get("model_type", "")]
    for a in archs:
        if a in _REGISTRY:
            return _REGISTRY[a](hf_config)
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
