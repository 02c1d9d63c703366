"""Configuration dataclasses.

The port's own copy of the parts of ``qspec_tpu/config.py`` that the dense
Llama QSpec path reads, with the same field names and defaults. Fields of
model families, loaders, parallelism and proposers that are not ported yet
are left out rather than accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of one dense Llama-family model."""

    arch: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    # "w4": QuaRot packed int4, per-channel symmetric (dual-scheme QSpec)
    quant: str = "w4"
    # vocab-projection weight dtype; "auto" = int8 for w4 checkpoints. Only
    # "bf16" is ported so far (the int8 head's kernel, matmul_w8a16, is not)
    lm_head_quant: str = "auto"       # "auto" | "bf16" | "int8" | "int4"

    @property
    def resolved_lm_head_quant(self) -> str:
        if self.lm_head_quant != "auto":
            return self.lm_head_quant
        return "int8" if self.quant == "w4" else "bf16"

    @property
    def cache_kv_heads(self) -> int:
        return self.num_kv_heads

    @property
    def cache_head_dim(self) -> int:
        # small head dims are stored 128-padded, as in the JAX package: the
        # attention kernel takes one head dim (128); update_layer zero-pads
        # writes and ops.attention.paged_attention pads q and slices back
        return -(-self.head_dim // 128) * 128

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_out(self) -> int:
        return self.q_size + 2 * self.kv_size

    @staticmethod
    def llama3_8b(**over) -> "ModelConfig":
        return ModelConfig(**over)

    @staticmethod
    def tiny(**over) -> "ModelConfig":
        """Small config for tests: real structure, CPU-sized."""
        d = dict(vocab_size=512, hidden_size=256, intermediate_size=448,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=10000.0, max_position_embeddings=512)
        d.update(over)
        return ModelConfig(**d)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paged KV cache sizing."""

    page_size: int = 128
    num_pages: Optional[int] = None      # None -> derive from free memory
    kv_cache_dtype: str = "bfloat16"     # only "bfloat16" is ported
    enable_prefix_caching: bool = True
    gpu_memory_utilization: float = 0.9


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs."""

    max_num_seqs: int = 8
    max_num_batched_tokens: int = 2048
    max_model_len: int = 4096
    enable_chunked_prefill: bool = True
    prefill_chunk_size: int = 512
    # co-schedule running decodes with prefill chunks
    mix_decode_with_prefill: bool = True
    # "recompute" re-prefills preempted sequences
    preemption_mode: str = "recompute"
    # batch and token buckets: every step runs at a bucketed shape, so the
    # QSpec run and its AR oracle see identical shapes
    decode_batch_buckets: tuple = (1, 2, 4, 8, 16, 32)
    prefill_token_buckets: tuple = (128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """QSpec speculative decoding over shared weights."""

    num_speculative_tokens: int = 3
    # draft scheme; verify is always w4a16. "w4a4" is the QSpec method.
    draft_scheme: str = "w4a4"
    # complete draft+verify rounds per engine step
    rounds_per_step: int = 1
    # disable speculation at or above this batch size
    disable_by_batch_size: Optional[int] = None
    # "qspec": shared-weights draft; "qspec_null": the same rounds with the
    # proposals nulled, which emit exactly the greedy AR tokens (the oracle)
    method: str = "qspec"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    speculative: Optional[SpeculativeConfig] = None
