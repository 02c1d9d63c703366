"""Offline inference API.

Port of ``qspec_tpu/entrypoints/llm.py`` for token-id prompts:

    from qspec_tpu_torch import LLM, SamplingParams
    llm = LLM(model="llama3-8b", lm_head_quant="bf16", num_speculative_tokens=3)
    outs = llm.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=32))

Without ``params`` the weights are random, made on the device from ``seed``
(``models.llama.init_params``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.engine.llm_engine import LLMEngine, RequestOutput
from qspec_tpu_torch.models.llama import init_params
from qspec_tpu_torch.sampling_params import SamplingParams


class LLM:
    def __init__(self, model: str = "tiny", params=None, seed: int = 0,
                 device="cuda", eos_token_id: Optional[int] = None,
                 **engine_kwargs):
        args = EngineArgs(model=model, seed=seed, **engine_kwargs)
        self.engine_config = args.create_engine_config()
        if params is None:
            params = init_params(self.engine_config.model, seed=seed, device=device)
        self.llm_engine = LLMEngine(self.engine_config, params,
                                    eos_token_id=eos_token_id, device=device,
                                    seed=seed)

    def generate(self, prompts: Sequence[List[int]],
                 sampling_params: Optional[Union[SamplingParams,
                                                 List[SamplingParams]]] = None,
                 ) -> List[RequestOutput]:
        """Each prompt is a list of token ids."""
        if sampling_params is None:
            sampling_params = SamplingParams()
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params] * len(prompts)
        ids = [self.llm_engine.add_request(list(p), sp)
               for p, sp in zip(prompts, sampling_params)]
        results = {}
        while self.llm_engine.has_unfinished_requests():
            for out in self.llm_engine.step():
                if out.finished:
                    results[out.request_id] = out
        return [results[i] for i in ids]

    @property
    def spec_metrics(self):
        return self.llm_engine.spec_metrics
