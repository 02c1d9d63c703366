"""Offline inference API.

Port of ``qspec_tpu/entrypoints/llm.py``. Prompts are token-id lists, or
strings given a tokenizer (``tokenizer=``: anything with ``encode`` /
``decode``; for a checkpoint directory a Hugging Face tokenizer is loaded from
it when ``transformers`` imports). With one, ``chat`` takes OpenAI-style
messages, through the tokenizer's chat template or, lacking one, a template
of ``conversation.py``:

    from qspec_tpu_torch import LLM, SamplingParams
    llm = LLM(model="llama3-8b", num_speculative_tokens=3)
    outs = llm.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=32))

At the JAX package's defaults the head is int8 (``lm_head_quant="auto"``)
and the KV cache bf16; ``kv_cache_dtype="int8"``, ``"fp8_e4m3"`` or
``"fp8_e5m2"`` halves the cache's bytes. A Gemma-2 is served as an AWQ /
GPTQ checkpoint, drafted by its own weights at W4A16:

    llm = LLM(model="gemma2-9b", quantization="awq", num_speculative_tokens=3,
              speculative_draft_scheme="w4a16", spec_draft_kv_window=64)

Medusa heads, an MLPSpeculator or an EAGLE net serve through the same
entry point, from ``params["medusa"]``, ``params["mlp_spec"]`` or
``params["eagle"]``, or from a trained net's .npz, whose arrays name the
method (``w1``: Medusa, ``proj_first``: MLPSpeculator, else EAGLE):

    llm = LLM(model="llama3-8b", params={**params, "medusa": heads},
              num_speculative_tokens=4, speculative_model="[medusa]",
              spec_medusa_tree="default")
    llm = LLM(model="llama3-8b", params={**params, "eagle": net},
              num_speculative_tokens=3, speculative_model="[eagle]")
    llm = LLM(model="tiny", num_speculative_tokens=4,
              speculative_model="heads.npz")

A checkpoint directory (Hugging Face layout: config.json and
``*.safetensors``) loads by its kind, as in the JAX package: an AWQ or
GPTQ directory (``quantization_config.quant_method``) through
``load_awq`` / ``load_gptq``, and a compressed-tensors one (pack-quantized
int4, int-quantized int8, float-quantized fp8) through
``load_compressed_tensors``, each drafted by its own weights at W4A16:

    llm = LLM(model="/path/to/Meta-Llama-3-8B-FP8", num_speculative_tokens=3,
              speculative_draft_scheme="w4a16", spec_draft_kv_window=64)

A GGUF file goes through ``model_loader.gguf.load_gguf`` (-> params, cfg)
and ``LLMEngine``, as in the JAX package. Under the
default ``quantization="qspec"`` a reference-format QSpec checkpoint
(``load_qspec``; the reference's ``QuarotLlamaForCausalLM`` and
``qwen2_quarot`` with its q/k/v biases) or, failing that, a float checkpoint
of the llama graph's families (Llama, Mistral, Phi-3, Qwen2, Qwen3, Gemma,
Granite, Mixtral, Qwen2-MoE, Qwen3-MoE, and under other key names
Baichuan-7B / Baichuan2-7B, InternLM2, Qwen v1, EXAONE, TeleChat2) rotated
and quantized at load (QuaRot, ``quantize_float``); with
``quantization=None`` such a float checkpoint in bf16 (``load_hf_float``,
Baichuan-13B's ALiBi too) or a BLOOM / MPT / DeepSeek-MoE / Falcon / JAIS /
DeepSeek-V2 / DeepSeek-V3 / MiniCPM3 one (``load_family_float``), which
speculate by n-gram prompt lookup:

    llm = LLM(model="/path/to/Meta-Llama-3-8B", num_speculative_tokens=3)
    llm = LLM(model="/path/to/Qwen2.5-7B", num_speculative_tokens=3)
    llm = LLM(model="/path/to/Qwen2-7B-Instruct-AWQ", num_speculative_tokens=3,
              speculative_draft_scheme="w4a16")
    llm = LLM(model="/path/to/bloom-7b1", quantization=None,
              num_speculative_tokens=3, speculative_model="[ngram]")
    llm = LLM(model="/path/to/internlm2_5-7b-chat", num_speculative_tokens=3)
    llm = LLM(model="/path/to/falcon-40b", quantization=None,
              num_speculative_tokens=3, speculative_model="[ngram]")
    llm = LLM(model="/path/to/DeepSeek-V2-Lite-Chat", quantization=None,
              num_speculative_tokens=3, speculative_model="[ngram]")

Qwen2-7B at its published widths, random int4 weights made on the card:

    llm = LLM(model="qwen2-7b", num_speculative_tokens=3)

A separate, smaller draft model comes from a directory (quantized by
``quantize_float``), or as a cfg with its parameters:

    llm = LLM(model="/path/to/Meta-Llama-3-8B", num_speculative_tokens=3,
              speculative_model="/path/to/Llama-3.2-1B")
    llm = LLM(model="llama3-8b", num_speculative_tokens=3,
              draft_model=draft_cfg, draft_params=draft_params)

Without ``params`` or a directory the weights are random, made on the
device from ``seed`` (``models.llama.init_params``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Union

from qspec_tpu_torch.beam_search import BeamSearchOutput, BeamSearchParams, beam_search
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.conversation import get_conv_template
from qspec_tpu_torch.engine.arg_utils import EngineArgs, proposer_of
from qspec_tpu_torch.engine.llm_engine import LLMEngine, RequestOutput
from qspec_tpu_torch.model_loader.ct import load_compressed_tensors
from qspec_tpu_torch.model_loader.families import CONVERTERS, load_family_float
from qspec_tpu_torch.model_loader.grouped import load_awq, load_gptq
from qspec_tpu_torch.model_loader.loader import (check_rotatable, config_from_hf_dir,
                                                 load_hf_float, load_qspec,
                                                 quantization_config_of, quantize_float,
                                                 read_safetensors)
from qspec_tpu_torch.models.llama import check_served, init_params, resolve_device
from qspec_tpu_torch.sampling_params import SamplingParams
from qspec_tpu_torch.spec_decode.eagle import load_eagle
from qspec_tpu_torch.spec_decode.medusa import load_medusa
from qspec_tpu_torch.spec_decode.mlp_speculator import load_mlp_speculator


# the files a Hugging Face tokenizer is loaded from
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")


def load_tokenizer(path: str):
    """The Hugging Face tokenizer of a checkpoint directory, or None where
    the directory holds no tokenizer file or ``transformers`` does not
    import (the card's machine has none)."""
    if not any(os.path.isfile(os.path.join(path, f)) for f in TOKENIZER_FILES):
        return None
    try:
        import transformers
    except ImportError:
        return None
    return transformers.AutoTokenizer.from_pretrained(path)


def chat_token_ids(tokenizer, messages: List[dict], chat_template: Optional[str] = None,
                   **template_kw) -> List[int]:
    """One conversation's prompt ids: the tokenizer's own chat template
    (``apply_chat_template``, with ``template_kw`` such as ``tools=``) unless
    a ``conversation.py`` template is named or the tokenizer has none (no
    such method, or a Hugging Face tokenizer whose ``chat_template`` is
    None); the fallback is the "llama-3" template."""
    own = (hasattr(tokenizer, "apply_chat_template")
           and getattr(tokenizer, "chat_template", "") is not None)
    if chat_template is None and own:
        return list(tokenizer.apply_chat_template(messages, tokenize=True,
                                                  add_generation_prompt=True,
                                                  **template_kw))
    conv = get_conv_template(chat_template or "llama-3")
    for msg in messages:
        if msg["role"] == "system":
            conv.system_message = msg["content"]
        else:
            conv.append_message(msg["role"], msg["content"])
    conv.append_message(conv.roles[1], None)
    return list(tokenizer.encode(conv.get_prompt()))


class LLM:
    def __init__(self, model: str = "tiny", params=None, seed: int = 0,
                 device="cuda", eos_token_id: Optional[int] = None,
                 draft_model: Optional[Union[str, ModelConfig]] = None,
                 draft_params=None, tokenizer=None, **engine_kwargs):
        args = EngineArgs(model=model, seed=seed, **engine_kwargs)
        self.tokenizer = tokenizer
        if tokenizer is None and os.path.isdir(model):
            self.tokenizer = load_tokenizer(model)
        if eos_token_id is None and self.tokenizer is not None:
            eos_token_id = getattr(self.tokenizer, "eos_token_id", None)
        self.engine_config = args.create_engine_config()
        if params is None and os.path.isdir(model):
            params = self._load_dir(model, device)
        elif params is None:
            params = init_params(self.engine_config.model, seed=seed, device=device)
        if draft_model is None and args.speculative_model is not None \
                and os.path.isdir(args.speculative_model):
            draft_model = args.speculative_model
        if draft_model is not None or draft_params is not None:
            draft_params = self._draft(draft_model, draft_params, device)
        net = args.speculative_model
        if net is not None and net.endswith(".npz"):
            # a proposer net saved as arrays, loaded by the method its
            # arrays name (EngineArgs.spec_method)
            dev = resolve_device(device)
            method = proposer_of(net)
            if method == "medusa":
                params = {**params, "medusa": load_medusa(net, device=dev)}
            elif method == "mlp_speculator":
                params = {**params, "mlp_spec": load_mlp_speculator(net, device=dev)}
            else:
                params = {**params, "eagle": load_eagle(net, self.engine_config.model,
                                                        device=dev)}
        self.llm_engine = LLMEngine(self.engine_config, params,
                                    eos_token_id=eos_token_id, device=device,
                                    seed=seed, draft_params=draft_params,
                                    tokenizer=self.tokenizer)

    def _load_dir(self, path: str, device):
        """A checkpoint directory, loaded on ``device`` by the routes of
        ``qspec_tpu/entrypoints/llm.py``: an AWQ / GPTQ one (its
        ``quantization_config.quant_method``, which EngineArgs turned into
        ``quant="w4g"``) by ``load_awq`` / ``load_gptq``; under QuaRot
        quantization a QSpec checkpoint (``weight_scales``), else a float one
        quantized at load (any llama-keyed family: Llama, Mistral, Phi-3,
        Qwen2, Qwen3, Gemma, Granite, Mixtral, Qwen2-MoE, Qwen3-MoE, Helium,
        GLM-4, and the remap families, whose keys ``quantize_float`` maps
        first); without quantization the family converter of a BLOOM / MPT /
        DeepSeek-MoE / Falcon / JAIS / GPT-J / GPT-NeoX / Phi / StableLM /
        Cohere / DeepSeek-V2 / DeepSeek-V3 / MiniCPM3 (multi-head latent
        attention, which any other quantization refuses before a weight is
        read), else the llama-keyed float loader (the remap families, GLM-4
        and Helium too); a compressed-tensors one (its ``quant_method``) by
        ``load_compressed_tensors`` with its ``quantization_config``, whose
        cfg (quant "w4g" or "w8") replaces EngineArgs', as in the JAX route.
        A QuaRot config whose widths have no Hadamard raises before the
        checkpoint is read. A GGUF file raises in EngineArgs, naming
        ``model_loader.gguf.load_gguf`` and ``LLMEngine``, the JAX package's
        way in."""
        cfg = self.engine_config.model
        dev = resolve_device(device)
        if cfg.attention_type == "mla":
            # DeepSeek-V2 / V3, MiniCPM3: bf16 only, before a weight is read
            check_served(cfg)
        if cfg.quant == "w4":
            check_rotatable(cfg)
        sd = read_safetensors(path)
        qconfig = quantization_config_of(path)
        method = qconfig.get("quant_method")
        if method == "compressed-tensors":
            params, cfg = load_compressed_tensors(sd, cfg, qconfig=qconfig, device=dev)
        elif cfg.quant == "w4g":
            load = load_awq if method == "awq" else load_gptq
            params, cfg = load(sd, cfg, device=dev)
        elif cfg.quant == "w4":
            # a QSpec checkpoint has weight_scales; without them (the JAX
            # route's KeyError from load_qspec) a float one is quantized
            if any(k.endswith(".weight_scales") for k in sd):
                params, cfg = load_qspec(sd, cfg, device=dev)
            else:
                params, cfg = quantize_float(sd, cfg, device=dev)
        elif cfg.arch in CONVERTERS:
            params, cfg = load_family_float(sd, cfg, device=dev)
        else:
            params, cfg = load_hf_float(sd, cfg, device=dev)
        self.engine_config = dataclasses.replace(self.engine_config, model=cfg)
        return params

    def _draft(self, draft_model, draft_params, device):
        """The separate draft model's parameters, its cfg recorded in the
        speculative config: a directory is loaded (``quantize_float`` for a
        QuaRot cfg, the JAX package's default for a draft directory, else
        ``load_hf_float``); a ModelConfig comes with its ``draft_params``."""
        spec = self.engine_config.speculative
        if spec is None:
            raise ValueError("a separate draft model needs num_speculative_tokens")
        if isinstance(draft_model, str) and draft_params is None:
            if not os.path.isdir(draft_model):
                raise ValueError(f"draft_model {draft_model!r} is not a directory")
            dcfg = config_from_hf_dir(draft_model)
            load = quantize_float if dcfg.quant == "w4" else load_hf_float
            draft_params, dcfg = load(draft_model, dcfg, device=resolve_device(device))
        elif isinstance(draft_model, ModelConfig) and draft_params is not None:
            dcfg = draft_model
        else:
            raise ValueError("a separate draft model is a checkpoint directory, or a "
                             "ModelConfig with its draft_params")
        self.engine_config = dataclasses.replace(
            self.engine_config, speculative=dataclasses.replace(spec, draft_model=dcfg))
        return draft_params

    def _encode(self, prompt: Union[str, List[int]]) -> List[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompts need a tokenizer")
            return list(self.tokenizer.encode(prompt))
        return list(prompt)

    def generate(self, prompts: Sequence[Union[str, List[int]]],
                 sampling_params: Optional[Union[SamplingParams,
                                                 List[SamplingParams]]] = None,
                 lora_name: Optional[str] = None) -> List[RequestOutput]:
        """Each prompt is a list of token ids, or a string (given a
        tokenizer); ``lora_name``: a loaded adapter (``llm_engine.lora``)
        for every prompt."""
        if sampling_params is None:
            sampling_params = SamplingParams()
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params] * len(prompts)
        ids = [self.llm_engine.add_request(self._encode(p), sp, lora_name=lora_name)
               for p, sp in zip(prompts, sampling_params)]
        results = {}
        while self.llm_engine.has_unfinished_requests():
            for out in self.llm_engine.step():
                if out.finished:
                    results[out.request_id] = out
        return [results[i] for i in ids]

    def beam_search(self, prompts: Sequence[Union[str, List[int]]],
                    params: Optional[BeamSearchParams] = None) -> List[BeamSearchOutput]:
        """Deterministic beam search (``beam_search.py``): one
        BeamSearchOutput a prompt, ``beam_width`` sequences best first."""
        return beam_search(self.llm_engine, [self._encode(p) for p in prompts],
                           params or BeamSearchParams())

    def chat(self, messages, sampling_params: Optional[SamplingParams] = None,
             chat_template: Optional[str] = None) -> List[RequestOutput]:
        """``messages``: one conversation (a list of {role, content}) or a
        list of them; each goes through ``chat_token_ids``."""
        if self.tokenizer is None:
            raise ValueError("chat needs a tokenizer")
        if messages and isinstance(messages[0], dict):
            messages = [messages]
        return self.generate([chat_token_ids(self.tokenizer, m, chat_template)
                              for m in messages], sampling_params)

    @property
    def spec_metrics(self):
        return self.llm_engine.spec_metrics
