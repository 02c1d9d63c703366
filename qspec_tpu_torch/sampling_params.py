"""Sampling parameters: the port's copy of qspec_tpu/sampling_params.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    min_p: float = 0.0
    max_tokens: int = 16
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    seed: Optional[int] = None
    logprobs: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: Optional[List[str]] = field(default=None)
    include_stop_str_in_output: bool = False
    # guided decoding (vocab-mask logits processors)
    allowed_token_ids: Optional[List[int]] = None
    banned_token_ids: Optional[List[int]] = None
    min_tokens: int = 0
    # additive per-token-id logit bias (OpenAI logit_bias semantics)
    logit_bias: Optional[dict] = None
    # grammar-guided decoding (reference vllm/model_executor/guided_decoding):
    # compiled to a token-level FSM whose transition table lives on device
    guided_regex: Optional[str] = None
    guided_json: Optional[object] = None   # schema dict or JSON string
    guided_choice: Optional[List[str]] = None

    def __post_init__(self):
        if isinstance(self.stop, str):
            self.stop = [self.stop]
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0
