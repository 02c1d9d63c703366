"""EngineArgs: flat arguments -> composed EngineConfig.

Port of ``qspec_tpu/engine/arg_utils.py`` for the flags the port serves; the
names are the JAX package's. ``model`` names a preset ("tiny" or
"llama3-8b"): loading checkpoints is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from qspec_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                    SchedulerConfig, SpeculativeConfig)

PRESETS = {"llama3-8b": ModelConfig.llama3_8b, "tiny": ModelConfig.tiny}


@dataclasses.dataclass
class EngineArgs:
    model: str = "tiny"                  # preset name
    quantization: Optional[str] = "qspec"  # "qspec" (QuaRot w4)
    max_model_len: int = 4096
    max_num_seqs: int = 8
    max_num_batched_tokens: int = 2048
    block_size: int = 128
    num_pages: Optional[int] = None      # None -> derive from free memory
    gpu_memory_utilization: float = 0.9
    lm_head_quant: str = "auto"          # auto|bf16|int8|int4 (bf16 ported)
    enable_chunked_prefill: bool = True
    prefill_chunk_size: int = 512
    enable_prefix_caching: bool = True
    mix_decode_with_prefill: bool = True
    num_speculative_tokens: Optional[int] = None
    speculative_draft_scheme: str = "w4a4"
    speculative_disable_by_batch_size: Optional[int] = None
    spec_rounds_per_step: int = 1
    # "qspec" or "qspec_null" (same rounds, proposals nulled: the AR oracle)
    speculative_method: str = "qspec"
    seed: int = 0

    def model_config(self) -> ModelConfig:
        if self.model not in PRESETS:
            raise NotImplementedError(f"model {self.model!r}: only the presets "
                                      f"{sorted(PRESETS)} are ported")
        if self.quantization not in ("qspec", "w4", "int4"):
            raise NotImplementedError("only QuaRot w4 (quantization='qspec') "
                                      "is ported")
        return PRESETS[self.model](quant="w4", lm_head_quant=self.lm_head_quant)

    def create_engine_config(self) -> EngineConfig:
        spec = None
        if self.num_speculative_tokens:
            spec = SpeculativeConfig(
                num_speculative_tokens=self.num_speculative_tokens,
                draft_scheme=self.speculative_draft_scheme,
                disable_by_batch_size=self.speculative_disable_by_batch_size,
                method=self.speculative_method,
                rounds_per_step=self.spec_rounds_per_step)
        return EngineConfig(
            model=self.model_config(),
            cache=CacheConfig(page_size=self.block_size,
                              num_pages=self.num_pages,
                              enable_prefix_caching=self.enable_prefix_caching,
                              gpu_memory_utilization=self.gpu_memory_utilization),
            scheduler=SchedulerConfig(
                max_num_seqs=self.max_num_seqs,
                max_num_batched_tokens=self.max_num_batched_tokens,
                max_model_len=self.max_model_len,
                enable_chunked_prefill=self.enable_chunked_prefill,
                prefill_chunk_size=self.prefill_chunk_size,
                mix_decode_with_prefill=self.mix_decode_with_prefill),
            speculative=spec,
        )
