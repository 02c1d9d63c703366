"""PyTorch/CUDA port of qspec_tpu: QSpec's W4A4-draft / W4A16-verify loop on
one NVIDIA H100 (QuaRot and AWQ / GPTQ checkpoints, Medusa heads) and the
bf16 ALiBi families with n-gram lookup, with the TPU kernels of those paths
written by hand in CUDA.

It imports torch and numpy only, never jax or qspec_tpu.
"""

from qspec_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                    SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.engine.llm_engine import LLMEngine, RequestOutput
from qspec_tpu_torch.entrypoints.llm import LLM
from qspec_tpu_torch.sampling_params import SamplingParams

__all__ = ["LLM", "LLMEngine", "RequestOutput", "SamplingParams", "ModelConfig",
           "CacheConfig", "SchedulerConfig", "SpeculativeConfig", "EngineConfig"]
