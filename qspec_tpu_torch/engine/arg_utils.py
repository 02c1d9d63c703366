"""EngineArgs: flat arguments -> composed EngineConfig.

``EngineArgs.add_cli_args`` adds one command-line flag a field
(``--num-speculative-tokens``, ``--kv-cache-dtype``, ...; a bool field also
gets its ``--no-`` form, and an Optional one takes "none"), and
``from_cli_args`` reads them back, as in the JAX package.

Port of ``qspec_tpu/engine/arg_utils.py`` for the flags the port serves; the
names are the JAX package's. ``model`` names a preset ("tiny", "llama3-8b",
"llama3-70b", "qwen2-7b" or "gemma2-9b") or a Hugging Face checkpoint
directory, whose config.json gives the ModelConfig
(``model_loader/loader.py::config_from_hf_dir``; the ``LLM`` entry point
loads its weights). ``quantization`` "qspec" is a QuaRot w4 checkpoint, "awq" / "gptq" a grouped-int4 (w4g) one, the only kind a
Gemma-2 is served as, None a float one (bf16 weights, the only kind a
BLOOM, an MPT, a Falcon, a JAIS, a Baichuan-13B, a GPT-J, a GPT-NeoX, a Phi,
a StableLM or a Cohere is served as). A directory whose config.json names an AWQ or GPTQ
``quantization_config.quant_method`` is a w4g checkpoint whatever
``quantization`` says, as in the JAX package (a ``quantization`` naming the
other method raises); a ``compressed-tensors`` one is w4g
(``pack-quantized``) or w8 (``int-quantized``, ``float-quantized``), the
quant its loader (``model_loader.ct``) settles; any other method raises. A
GGUF file raises here, naming its way in: ``model_loader.gguf.load_gguf``
then ``LLMEngine``, as in the JAX package. ``speculative_model=
"[medusa]"`` (heads in ``params["medusa"]``) selects Medusa, ``spec_medusa_tree`` its candidate
tree; ``"[mlp_speculator]"`` (``params["mlp_spec"]``) MLPSpeculator,
``"[eagle]"`` (``params["eagle"]``) EAGLE; a proposer net's ``.npz``
(loaded by the ``LLM`` entry point) selects its method by its arrays, as in
the JAX package: ``w1`` Medusa, ``proj_first`` MLPSpeculator, otherwise
EAGLE. ``"[ngram]"`` selects prompt lookup, ``ngram_prompt_lookup_min/max``
its n-gram lengths; a checkpoint directory is a separate draft model for
QSpec (the ``LLM`` entry point loads it and records its cfg).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
from typing import Optional

import numpy as np

from qspec_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                    SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.model_loader.loader import config_from_hf_dir, quantization_config_of
from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE

PRESETS = {"llama3-8b": ModelConfig.llama3_8b, "llama3-70b": ModelConfig.llama3_70b,
           "qwen2-7b": ModelConfig.qwen2_7b, "gemma2-9b": ModelConfig.gemma2_9b,
           "tiny": ModelConfig.tiny}
# quantization -> ModelConfig.quant
QUANT = {"qspec": "w4", "w4": "w4", "int4": "w4", "awq": "w4g", "gptq": "w4g",
         None: "none"}
# a proposer method -> the method of its oracle (the same rounds with the
# proposals nulled); EAGLE has none: AR is its oracle
ORACLE = {"qspec": "qspec_null", "medusa": "medusa_null",
          "mlp_speculator": "medusa_null", "ngram": "null"}


def proposer_of(path: str) -> str:
    """The speculative method of a proposer net saved as an .npz, by its
    arrays (``qspec_tpu/entrypoints/llm.py``'s routing): Medusa heads carry
    ``w1``, an MLPSpeculator ``proj_first``, anything else is an EAGLE
    net."""
    with np.load(path) as z:
        files = set(z.files)
    return "medusa" if "w1" in files else "mlp_speculator" if "proj_first" in files else "eagle"


def _cli_type(annotation: str):
    """A flag's parser from its field's annotation (a string here): int,
    float or str, and for an Optional field also "none" -> None."""
    base = {"int": int, "float": float, "str": str}[
        annotation.removeprefix("Optional[").removesuffix("]")]
    if not annotation.startswith("Optional["):
        return base
    return lambda v: None if v.lower() in ("none", "") else base(v)


@dataclasses.dataclass
class EngineArgs:
    model: str = "tiny"                  # preset name or checkpoint directory
    # "qspec" (QuaRot w4) | "awq" | "gptq" (w4g) | None (bf16)
    quantization: Optional[str] = "qspec"
    max_model_len: int = 4096
    max_num_seqs: int = 8
    max_num_batched_tokens: int = 2048
    block_size: int = 128
    num_pages: Optional[int] = None      # None -> derive from free memory
    gpu_memory_utilization: float = 0.9
    # swap-mode preemption: preempted sequences park their KV in host RAM
    swap_space: float = 4.0              # GiB
    preemption_mode: str = "recompute"   # recompute|swap
    lm_head_quant: str = "auto"          # auto|bf16|int8|int4
    kv_cache_dtype: str = "bfloat16"     # bfloat16|int8|fp8_e4m3|fp8_e5m2
    enable_chunked_prefill: bool = True
    prefill_chunk_size: int = 512
    enable_prefix_caching: bool = True
    mix_decode_with_prefill: bool = True
    num_speculative_tokens: Optional[int] = None
    speculative_draft_scheme: str = "w4a4"   # w4a4|w4a8|w4a16
    speculative_disable_by_batch_size: Optional[int] = None
    # "rejection_sampler" (lossless) | "typical_acceptance_sampler" (lossy)
    spec_acceptance_method: str = "rejection_sampler"
    spec_rounds_per_step: int = 1
    # MagicDec-style sliding window on the shared-weights draft KV reads
    spec_draft_kv_window: Optional[int] = None
    # "qspec" | "qspec_null" | "medusa" | "medusa_null" | "mlp_speculator" |
    # "eagle" | "ngram" | "null" (the "null" forms: the same rounds,
    # proposals nulled: the AR oracle; "medusa_null" is MLPSpeculator's
    # too); None: "qspec", or what speculative_model names
    speculative_method: Optional[str] = None
    # the reference's --speculative-model: "[medusa]", "[mlp_speculator]" or
    # "[eagle]" select the proposer net that params carry ("medusa",
    # "mlp_spec", "eagle"), a path to a net's .npz loads it (LLM; its
    # arrays name the method), "[ngram]" prompt lookup, a checkpoint
    # directory a separate draft model (QSpec); None: QSpec's
    # shared-weights draft
    speculative_model: Optional[str] = None
    # Medusa candidate tree: "default" (DEFAULT_TREE without the paths deeper
    # than num_speculative_tokens) or a literal choices tuple such as
    # "((0,),(1,),(0,0))"; None: the single top-1 chain
    spec_medusa_tree: Optional[str] = None
    # prompt lookup's n-gram lengths (SpeculativeConfig)
    ngram_prompt_lookup_max: int = 4
    ngram_prompt_lookup_min: int = 1
    seed: int = 0

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        """One flag a field, typed by the field's annotation."""
        for f in dataclasses.fields(EngineArgs):
            name = "--" + f.name.replace("_", "-")
            if f.type == "bool":
                parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                    default=f.default)
            else:
                parser.add_argument(name, type=_cli_type(f.type), default=f.default)
        return parser

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "EngineArgs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in names})

    def model_config(self) -> ModelConfig:
        if self.quantization not in QUANT:
            raise NotImplementedError(f"quantization {self.quantization!r}: only "
                                      f"{sorted(map(str, QUANT))} are ported")
        quant = QUANT[self.quantization]
        if self.model.endswith(".gguf"):
            raise NotImplementedError(
                f"model {self.model!r}: a GGUF file is not a model for EngineArgs / LLM, "
                "as in the JAX package: load it with "
                "qspec_tpu_torch.model_loader.gguf.load_gguf(path) -> (params, cfg), then "
                "LLMEngine(EngineConfig(model=cfg, ...), params)")
        if os.path.isdir(self.model):
            qconfig = quantization_config_of(self.model)
            method = qconfig.get("quant_method")
            if method in ("awq", "gptq", "compressed-tensors"):
                if self.quantization in ("awq", "gptq") and self.quantization != method:
                    raise ValueError(f"quantization={self.quantization!r}, but "
                                     f"{self.model}'s quantization_config names {method!r}")
                # a compressed-tensors format other than pack-quantized is w8;
                # without a format its loader sniffs the tensors and settles it
                quant = ("w8" if method == "compressed-tensors"
                         and qconfig.get("format") != "pack-quantized" else "w4g")
            elif method is not None:
                raise NotImplementedError(
                    f"{self.model}: quantization_config.quant_method {method!r} is not "
                    "ported; AWQ, GPTQ and compressed-tensors directories are")
            elif quant == "w4g":
                raise ValueError(f"quantization={self.quantization!r}, but {self.model}'s "
                                 "config.json has no AWQ / GPTQ quantization_config")
            return dataclasses.replace(config_from_hf_dir(self.model), quant=quant,
                                       lm_head_quant=self.lm_head_quant)
        if self.model not in PRESETS:
            raise NotImplementedError(f"model {self.model!r}: neither a checkpoint "
                                      f"directory nor a preset ({sorted(PRESETS)})")
        return PRESETS[self.model](quant=quant, lm_head_quant=self.lm_head_quant)

    def spec_method(self) -> str:
        """The speculative method: ``speculative_method`` where given (it
        must agree with ``speculative_model``), else what
        ``speculative_model`` names, else "qspec"."""
        net = self.speculative_model
        named = None
        if net is not None:
            if net.startswith("[") and net.endswith("]"):
                named = net.strip("[]").lower()
            elif net.endswith(".npz"):
                named = proposer_of(net)
            elif os.path.isdir(net):
                named = "qspec"    # a separate draft model
            else:
                raise ValueError(f"speculative_model {net!r}: neither a proposer "
                                 "name, a heads .npz nor a checkpoint directory")
        if self.speculative_method is None:
            return named or "qspec"
        if named is not None and self.speculative_method not in (named, ORACLE.get(named)):
            raise ValueError(f"speculative_method={self.speculative_method!r} does "
                             f"not go with speculative_model={net!r}")
        return self.speculative_method

    def medusa_tree(self) -> Optional[tuple]:
        if not self.spec_medusa_tree:
            return None
        if self.spec_medusa_tree.strip().lower() == "default":
            return tuple(p for p in DEFAULT_TREE if len(p) <= self.num_speculative_tokens)
        return tuple(tuple(p) for p in ast.literal_eval(self.spec_medusa_tree))

    def create_engine_config(self) -> EngineConfig:
        spec = None
        if self.speculative_model is not None and not self.num_speculative_tokens:
            raise ValueError("speculative_model needs num_speculative_tokens")
        if self.num_speculative_tokens:
            spec = SpeculativeConfig(
                num_speculative_tokens=self.num_speculative_tokens,
                draft_scheme=self.speculative_draft_scheme,
                disable_by_batch_size=self.speculative_disable_by_batch_size,
                method=self.spec_method(),
                rounds_per_step=self.spec_rounds_per_step,
                draft_kv_window=self.spec_draft_kv_window,
                medusa_tree=self.medusa_tree(),
                ngram_prompt_lookup_max=self.ngram_prompt_lookup_max,
                ngram_prompt_lookup_min=self.ngram_prompt_lookup_min,
                acceptance_method=self.spec_acceptance_method)
        return EngineConfig(
            model=self.model_config(),
            cache=CacheConfig(page_size=self.block_size,
                              num_pages=self.num_pages,
                              kv_cache_dtype=self.kv_cache_dtype,
                              enable_prefix_caching=self.enable_prefix_caching,
                              gpu_memory_utilization=self.gpu_memory_utilization,
                              swap_space_gb=self.swap_space),
            scheduler=SchedulerConfig(
                max_num_seqs=self.max_num_seqs,
                max_num_batched_tokens=self.max_num_batched_tokens,
                max_model_len=self.max_model_len,
                enable_chunked_prefill=self.enable_chunked_prefill,
                prefill_chunk_size=self.prefill_chunk_size,
                mix_decode_with_prefill=self.mix_decode_with_prefill,
                preemption_mode=self.preemption_mode),
            speculative=spec,
        )
