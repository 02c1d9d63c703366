"""Offline inference API.

Port of ``qspec_tpu/entrypoints/llm.py`` for token-id prompts:

    from qspec_tpu_torch import LLM, SamplingParams
    llm = LLM(model="llama3-8b", num_speculative_tokens=3)
    outs = llm.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=32))

At the JAX package's defaults the head is int8 (``lm_head_quant="auto"``)
and the KV cache bf16; ``kv_cache_dtype="int8"``, ``"fp8_e4m3"`` or
``"fp8_e5m2"`` halves the cache's bytes. A Gemma-2 is served as an AWQ /
GPTQ checkpoint, drafted by its own weights at W4A16:

    llm = LLM(model="gemma2-9b", quantization="awq", num_speculative_tokens=3,
              speculative_draft_scheme="w4a16", spec_draft_kv_window=64)

Medusa heads serve through the same entry point, from ``params["medusa"]``
or from an .npz of trained heads:

    llm = LLM(model="llama3-8b", params={**params, "medusa": heads},
              num_speculative_tokens=4, speculative_model="[medusa]",
              spec_medusa_tree="default")
    llm = LLM(model="tiny", num_speculative_tokens=4,
              speculative_model="heads.npz")

A BLOOM or MPT checkpoint directory (Hugging Face layout: config.json and
``*.safetensors``) is served in bf16 with n-gram prompt lookup, or
autoregressively without ``num_speculative_tokens``:

    llm = LLM(model="/path/to/bloom-7b1", quantization=None,
              num_speculative_tokens=3, speculative_model="[ngram]")

Without ``params`` or a directory the weights are random, made on the
device from ``seed`` (``models.llama.init_params``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Union

import numpy as np

from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.engine.llm_engine import LLMEngine, RequestOutput
from qspec_tpu_torch.model_loader.families import CONVERTERS, load_family_float
from qspec_tpu_torch.model_loader.loader import read_safetensors
from qspec_tpu_torch.models.llama import init_params, resolve_device
from qspec_tpu_torch.sampling_params import SamplingParams
from qspec_tpu_torch.spec_decode.medusa import load_medusa


class LLM:
    def __init__(self, model: str = "tiny", params=None, seed: int = 0,
                 device="cuda", eos_token_id: Optional[int] = None,
                 **engine_kwargs):
        args = EngineArgs(model=model, seed=seed, **engine_kwargs)
        self.engine_config = args.create_engine_config()
        if params is None and os.path.isdir(model):
            params = self._load_dir(model, device)
        elif params is None:
            params = init_params(self.engine_config.model, seed=seed, device=device)
        net = args.speculative_model
        if net is not None and net.endswith(".npz"):
            # a proposer net saved as arrays: Medusa heads carry w1 / b1 / head
            with np.load(net) as z:
                if "w1" not in z.files:
                    raise NotImplementedError(f"speculative_model {net!r}: only Medusa "
                                              "heads (w1 / b1 / head) are ported")
            params = {**params, "medusa": load_medusa(net, device=resolve_device(device))}
        self.llm_engine = LLMEngine(self.engine_config, params,
                                    eos_token_id=eos_token_id, device=device,
                                    seed=seed)

    def _load_dir(self, path: str, device):
        """A float checkpoint directory of a ported family: its safetensors,
        converted on ``device`` (``qspec_tpu/entrypoints/llm.py``'s family
        route). The JAX package's other routes raise."""
        cfg = self.engine_config.model
        if cfg.quant != "none" or cfg.arch not in CONVERTERS:
            raise NotImplementedError(
                f"{path}: only the float checkpoints of {sorted(CONVERTERS)} load "
                "(quantization=None); QuaRot quantization of a float checkpoint "
                "(quantize_float), llama-keyed float checkpoints (load_hf_float) and "
                "QSpec checkpoints (load_qspec) are ROADMAP queue 1 item 1")
        params, cfg = load_family_float(read_safetensors(path), cfg,
                                        device=resolve_device(device))
        self.engine_config = dataclasses.replace(self.engine_config, model=cfg)
        return params

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
