"""Model registry: Hugging Face architecture names -> ModelConfig.

Port of ``qspec_tpu/models/registry.py::resolve`` for the architectures
whose graph the port has, all the llama graph of ``models/llama.py`` with
its knobs: ``LlamaForCausalLM``, ``Gemma2ForCausalLM`` (softcaps, post-block
norms, alternating window), ``BloomForCausalLM`` and ``MPTForCausalLM``
(ALiBi, LayerNorm, non-gated MLP; bf16 checkpoints,
``model_loader/families.py``), and the sparse-MoE families (``_moe_block``):
``MixtralForCausalLM``, ``Qwen2MoeForCausalLM`` (the shared expert, the qkv
bias), ``Qwen3MoeForCausalLM`` (the q/k norms) and ``DeepseekForCausalLM``
(a dense prefix, ungated shared experts; bf16 checkpoints). Any other
architecture raises.
"""

from __future__ import annotations

from qspec_tpu_torch.config import ModelConfig

# architecture (or, as in the JAX package's registry, the bare model type)
# -> the model type its config is read as
ARCHITECTURES = {"LlamaForCausalLM": "llama", "Gemma2ForCausalLM": "gemma2",
                 "gemma2": "gemma2", "BloomForCausalLM": "bloom", "bloom": "bloom",
                 "MPTForCausalLM": "mpt", "MptForCausalLM": "mpt", "mpt": "mpt",
                 "MixtralForCausalLM": "mixtral", "mixtral": "mixtral",
                 "Qwen2MoeForCausalLM": "qwen2_moe", "qwen2_moe": "qwen2_moe",
                 "Qwen3MoeForCausalLM": "qwen3_moe", "qwen3_moe": "qwen3_moe",
                 "DeepseekForCausalLM": "deepseek", "deepseek": "deepseek"}


def resolve(hf_config: dict) -> ModelConfig:
    """The ModelConfig of a Hugging Face config.json dict, by its first
    ported architecture."""
    archs = hf_config.get("architectures") or [hf_config.get("model_type", "")]
    for a in archs:
        if a in ARCHITECTURES:
            return ModelConfig.from_hf_config({**hf_config, "model_type": ARCHITECTURES[a]})
    raise NotImplementedError(f"unsupported architectures {archs}; ported: "
                              f"{sorted(ARCHITECTURES)}")
