"""LLMEngine: request lifecycle + continuous-batching event loop.

Port of the prefill / decode / spec-round paths of
``qspec_tpu/engine/llm_engine.py``. ``speculative=None`` gives plain
autoregressive continuous batching (W4A16, or bf16 for a float checkpoint);
a SpeculativeConfig turns every decode step into draft (w4a4, w4a8 or
w4a16, optionally under a sliding window) + verify (w4a16) rounds over
shared weights with per-phase KV caches, or with a separate draft model
(``SpeculativeConfig.draft_model``, its parameters ``draft_params``: its own
KV pool and, for a float draft, the bf16 scheme), with ``method="medusa"`` into
Medusa rounds (the heads ride the verify pass: no draft forward, no draft
cache; a chain or a candidate tree), with ``method="mlp_speculator"`` into
the same chain rounds proposed by MLPSpeculator's recurrent heads, with
``method="eagle"`` into EAGLE rounds (a one-layer draft net over the
target's hidden states, with its own one-layer KV pool, whose prompt pass is
fused into the target's prefill), or with ``method="ngram"`` into
prompt-lookup rounds (proposals matched on the device from the sequence's
own tokens, no draft forward: the proposer of a bf16 checkpoint).

Requests are token ids. With a ``tokenizer`` (anything with ``decode``) the
engine also enforces stop strings (``SamplingParams.stop``, detokenized
incrementally) and fills ``RequestOutput.text``; ``logprobs`` > 1 returns
the top-n alternatives of each position sampled by a prefill or an AR step
(a speculative round's positions get None, as in the JAX package). Every
request carries a ``tracing.RequestTrace``; ``stat_loggers`` receive one
``metrics.Stats`` a step. ``guided_regex`` / ``guided_json`` /
``guided_choice`` compile to a token FSM (``qspec_tpu_torch/guided/``) over
``grammar_vocab`` (token id -> bytes), or over the tokenizer's vocabulary
(``hf_vocab_bytes``), whose table the rounds read on the device (not with
the Medusa candidate tree, as in the JAX package). Still refused:
``repetition_penalty`` and a per-request ``seed`` for sampled requests,
which the JAX package accepts and ignores (no sampler applies them).

The engine surface around the rounds:

- ``preemption_mode="swap"``: a preempted sequence's KV pages (the target
  cache's, the draft cache's or its ring row's, EAGLE's pool, the 8-bit
  scales) park in host RAM (``core/swap.py``, ``CacheConfig.swap_space_gb``)
  and are scattered back into fresh pages on resume; a full pool falls back
  to recompute. The per-sequence rows of the Medusa, n-gram and EAGLE banks
  stay assigned while a sequence is parked; a row taken meanwhile is
  rebuilt from the host's copy, as after any row loss (the proposals of one
  round, never the tokens, change).
- LoRA: ``params["lora"]`` (``lora/layers.py``) is a bank of adapter slots;
  ``add_request(lora_id=)`` or ``lora_name=`` (``LLMEngine.lora``, the
  slot manager) picks a request's, whose deltas ride every forward of its
  rows: prefill, decode, QSpec's shared-weights draft and verify (a
  separate draft model runs none). Where the JAX package drops the ids
  (Medusa, MLPSpeculator, EAGLE and n-gram rounds; an MoE's MLP) a request
  with an adapter is refused.
- ``add_request(prompt_embeds=)``: embedding rows in place of the prompt's
  table rows (refused with a separate draft model, as in the JAX package,
  and under EAGLE, whose prefill the JAX package feeds the placeholder
  ids); ``prompt_adapter=``: a soft prompt of ``LLMEngine.prompt_adapters``
  (``prompt_adapter.py``) prepended through that path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from qspec_tpu_torch.config import EngineConfig
from qspec_tpu_torch.core.block_manager import BlockManager
from qspec_tpu_torch.core.scheduler import ScheduledBatch, Scheduler
from qspec_tpu_torch.core.sequence import Sequence, SequenceStatus
from qspec_tpu_torch.core.swap import HostSwapPool
from qspec_tpu_torch.detokenizer import DetokState, detokenize_incrementally
from qspec_tpu_torch.engine.metrics import Stats
from qspec_tpu_torch.engine.model_runner import (ModelRunner, make_sampling_tensors,
                                                 ring_pages, ring_rows)
from qspec_tpu_torch.guided import GrammarCompiler, hf_vocab_bytes
from qspec_tpu_torch.lora.manager import LoRAManager
from qspec_tpu_torch.models.llama import check_served, resolve_device
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.plugins import load_general_plugins
from qspec_tpu_torch.prompt_adapter import PromptAdapterManager
from qspec_tpu_torch.sampling_params import SamplingParams
from qspec_tpu_torch.spec_decode.eagle import eagle_cfg_for
from qspec_tpu_torch.spec_decode.metrics import SpecDecodeMetrics
from qspec_tpu_torch.tracing import RequestTrace, init_tracer, stage_range


@dataclass
class RequestOutput:
    request_id: int
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None
    text: str = ""
    logprobs: Optional[List[float]] = None
    # per-position {token_id: logprob} dicts when logprobs > 1 was requested
    top_logprobs: Optional[List[Optional[dict]]] = None
    # a finished request's latencies in seconds from its RequestTrace:
    # time_in_queue, time_to_first_token, e2e
    metrics: dict = field(default_factory=dict)


SPEC_METHODS = ("qspec", "qspec_null", "medusa", "medusa_null", "mlp_speculator",
                "ngram", "null", "eagle")
# Medusa's rounds: the heads (or MLPSpeculator's chain) propose, the "_null"
# form nulls the proposals (the oracle of both nets)
MEDUSA_METHODS = ("medusa", "medusa_null", "mlp_speculator")
# prompt lookup's rounds: "null" nulls the proposals (the AR oracle)
NGRAM_METHODS = ("ngram", "null")


def _check_supported(config: EngineConfig) -> None:
    check_served(config.model)
    spec = config.speculative
    if spec is not None:
        if spec.method not in SPEC_METHODS:
            raise NotImplementedError(f"speculative method {spec.method!r} is "
                                      f"not ported ({', '.join(SPEC_METHODS)})")
        if spec.medusa_tree is not None and spec.method not in ("medusa", "medusa_null"):
            raise ValueError("medusa_tree needs method='medusa' or 'medusa_null' (the "
                             "tree of EAGLE or MLPSpeculator proposals is not ported)")
        if spec.method == "eagle" and spec.draft_kv_window is not None:
            raise ValueError("draft_kv_window windows QSpec's shared-weights draft; "
                             "EAGLE's layer attends over the whole context")
        if spec.method in NGRAM_METHODS and not (
                1 <= spec.ngram_prompt_lookup_min <= spec.ngram_prompt_lookup_max):
            raise ValueError("n-gram lookup needs 1 <= ngram_prompt_lookup_min <= "
                             "ngram_prompt_lookup_max")
        if spec.draft_scheme not in ("w4a4", "w4a8", "w4a16"):
            raise NotImplementedError(f"draft_scheme {spec.draft_scheme!r}")
        qspec = spec.method in ("qspec", "qspec_null")
        if spec.draft_model is not None and not qspec:
            raise ValueError("draft_model drafts for method='qspec' / 'qspec_null'")
        if spec.force_accept_len is not None and not (qspec and spec.force_accept_len >= 0):
            raise ValueError("force_accept_len (>= 0) times the QSpec rounds "
                             "(method='qspec' / 'qspec_null')")
        if spec.acceptance_method != "rejection_sampler" and not qspec:
            # the JAX package reads it in the QSpec rounds only
            raise ValueError(f"acceptance_method={spec.acceptance_method!r} decides the "
                             "QSpec rounds (method='qspec' / 'qspec_null')")
    if config.scheduler.preemption_mode not in ("recompute", "swap"):
        raise ValueError(f"preemption_mode={config.scheduler.preemption_mode!r}: "
                         "'recompute' or 'swap'")


def _guided(sp: SamplingParams) -> bool:
    return bool(sp.guided_regex or sp.guided_json is not None or sp.guided_choice)


class LLMEngine:
    def __init__(self, config: EngineConfig, params, num_pages: Optional[int] = None,
                 eos_token_id: Optional[int] = None, device="cuda", seed: int = 0,
                 draft_params=None, tokenizer=None, grammar_vocab=None):
        load_general_plugins()
        _check_supported(config)
        self.config = config
        self.eos_token_id = eos_token_id
        self.tokenizer = tokenizer
        # token id -> emitted bytes, for grammar-guided decoding; derived
        # from the tokenizer at the first guided request if not given
        self._grammar_vocab = grammar_vocab
        self._grammar_compiler = None
        self.device = resolve_device(device)
        self.spec = config.speculative
        lookahead = ((self.spec.num_speculative_tokens + 1)
                     * self.spec.rounds_per_step) if self.spec else 1
        if self.spec is not None and self.spec.medusa_tree is not None:
            # a tree round writes T node slots past the position and
            # advances at most D + 1: the tables must reach the (T - D) more
            lookahead += len(self.spec.medusa_tree) + 1
        # Medusa proposes from the verify pass's hidden state, n-gram lookup
        # from the tokens: neither has a draft cache; EAGLE's one-layer net
        # has one, built by the target's prefill
        self._medusa = self.spec is not None and self.spec.method in MEDUSA_METHODS
        self._ngram = self.spec is not None and self.spec.method in NGRAM_METHODS
        self._eagle = self.spec is not None and self.spec.method == "eagle"
        self._draft_cache = self.spec is not None and not (self._medusa or self._ngram)
        if num_pages is None:
            num_pages = self._derive_num_pages()
        self.runner = ModelRunner(config, params, num_pages,
                                  need_draft_cache=self._draft_cache,
                                  device=self.device, seed=seed,
                                  draft_params=draft_params)
        self.block_manager = BlockManager(
            num_pages, config.cache.page_size,
            enable_prefix_caching=config.cache.enable_prefix_caching)
        self.scheduler = Scheduler(config.scheduler, self.block_manager,
                                   lookahead=lookahead)
        self._lora_manager = None           # built at first use (.lora)
        self._prompt_adapter_manager = None     # (.prompt_adapters)
        # swap-mode preemption: the host pool, its budget in bytes a page of
        # both caches; the bytes parked over the engine's life
        self._swap_pool = None
        self.swap_bytes_out = 0
        if config.scheduler.preemption_mode == "swap":
            self._swap_pool = HostSwapPool(
                max_bytes=int(config.cache.swap_space_gb * (1 << 30)),
                page_bytes=self._swap_page_bytes())
            self.scheduler.swap_ok = self._swap_pool.can_reserve
        self._next_id = 0
        self.spec_metrics = SpecDecodeMetrics()
        self._num_total_pages = num_pages
        self.stat_loggers = []
        self.tracer = None            # set by enable_tracing()
        self._traces: Dict[int, RequestTrace] = {}

    def enable_tracing(self, otlp_endpoint: Optional[str] = None,
                       service_name: str = "qspec_tpu_torch") -> bool:
        """Emit one OpenTelemetry span per finished request; False (and no
        spans) without OpenTelemetry."""
        self.tracer = init_tracer(service_name, otlp_endpoint)
        return self.tracer is not None

    def _swap_page_bytes(self) -> int:
        """Host bytes one parked page takes: a page of every layer of the
        target cache and of the draft cache (a ring parks its R pages
        whatever the sequence's length, counted as one each, as in the JAX
        package)."""
        def page(cache):
            return sum(t[:, :1].numel() * t.element_size()
                       for t in (cache.kv_pages, cache.kv_scales) if t is not None)
        r = self.runner
        return page(r.cache) + (page(r.draft_cache) if r.draft_cache is not None else 0)

    def _derive_num_pages(self) -> int:
        """Size the cache: what the scheduler can address, capped by
        gpu_memory_utilization of the card's free memory."""
        cc = self.config.cache
        if cc.num_pages is not None:
            return cc.num_pages
        sched = self.config.scheduler
        mc = self.config.model
        need = sched.max_num_seqs * (-(-sched.max_model_len // cc.page_size)) + 8
        if self.device.type != "cuda":
            return need
        free, _ = torch.cuda.mem_get_info(self.device)
        # one page of every layer: entries plus, for int8 / e4m3, its scales
        page_bytes = kvc.kv_cache_bytes(kvc.KVCacheConfig(
            num_layers=mc.num_layers, num_kv_heads=mc.cache_kv_heads,
            head_dim=mc.cache_head_dim, num_pages=1, page_size=cc.page_size,
            dtype=cc.kv_cache_dtype))
        budget = free * cc.gpu_memory_utilization
        n_caches = 1
        if self._draft_cache:
            ring = ring_pages(self.config)
            dm = eagle_cfg_for(mc) if self._eagle else self.spec.draft_model
            if ring:
                # the windowed draft's small fixed ring pool
                budget -= (ring_rows(self.config) * ring + 1) * page_bytes
            elif dm is not None:
                # a separate draft's or EAGLE's pool: the same page count at
                # its own (usually much smaller) bytes a page
                n_caches = 1 + kvc.kv_cache_bytes(kvc.KVCacheConfig(
                    num_layers=dm.num_layers, num_kv_heads=dm.cache_kv_heads,
                    head_dim=dm.cache_head_dim, num_pages=1, page_size=cc.page_size,
                    dtype=cc.kv_cache_dtype)) / page_bytes
            else:
                n_caches = 2
        fit = int(budget // (page_bytes * n_caches))
        return max(2, min(need, fit))

    # ------------------------------------------------------------------
    def check_request(self, sp: SamplingParams) -> None:
        """Raise for a request option the port does not serve (what
        ``add_request`` refuses); it changes no state, so a caller on another
        thread may call it while a step runs."""
        if _guided(sp):
            if self.spec is not None and self.spec.medusa_tree is not None:
                raise ValueError("guided decoding does not compose with the "
                                 "medusa candidate tree (medusa_tree); use the "
                                 "single-chain medusa rounds")
            if self._grammar_vocab is None and (self.tokenizer is None or not hasattr(
                    self.tokenizer, "get_vocab")):
                raise ValueError("guided decoding needs a tokenizer or grammar_vocab "
                                 "(token-id -> bytes) at engine construction"
                                 + ("" if self.tokenizer is None else
                                    "; the tokenizer has no get_vocab"))
        if sp.stop and self.tokenizer is None:
            # the token ids cannot be matched against text without one
            raise NotImplementedError("stop strings need a tokenizer (LLMEngine "
                                      "tokenizer=)")
        if sp.repetition_penalty != 1.0:
            raise NotImplementedError("repetition_penalty is not ported: no "
                                      "sampler applies it")
        if sp.seed is not None and not sp.greedy:
            raise NotImplementedError("a per-request seed for sampled decoding "
                                      "is not ported: the engine's generator "
                                      "(LLMEngine seed) samples every request")

    @property
    def lora(self) -> LoRAManager:
        """The adapter manager over ``params["lora"]`` (load, unload, list
        named adapters); raises ``LoRASlotError`` without a bank."""
        if self._lora_manager is None:
            self._lora_manager = LoRAManager(self)
        return self._lora_manager

    @property
    def prompt_adapters(self) -> PromptAdapterManager:
        """The registry of named soft prompts (``prompt_adapter.py``)."""
        if self._prompt_adapter_manager is None:
            self._prompt_adapter_manager = PromptAdapterManager(self)
        return self._prompt_adapter_manager

    def _check_lora(self, lora_id: int) -> None:
        """Raise for an adapter slot the engine cannot serve: no bank, a slot
        past it, or a path whose rounds (or an MoE's MLP) the JAX package
        runs without the adapter."""
        if "lora" not in self.runner.params:
            raise ValueError(f"lora_id={lora_id}, but the engine has no adapter bank "
                             "(params['lora'] = lora.init_lora_params(...))")
        n = self.runner.params["lora"]["layers"]["qkv"]["A"].shape[1]
        if not 0 < lora_id < n:
            raise ValueError(f"lora_id={lora_id}: the bank has slots 1..{n - 1}")
        if self.config.model.num_experts:
            raise ValueError("LoRA on a mixture-of-experts model: the JAX package applies "
                             "no adapter to its experts' MLP (ROADMAP queue 3)")
        if self.spec is not None and (self._medusa or self._ngram or self._eagle):
            raise ValueError(f"LoRA with speculative method {self.spec.method!r}: the JAX "
                             "package runs its rounds without the adapter (ROADMAP queue 3); "
                             "QSpec's rounds serve adapters")

    def _check_embeds(self, prompt_token_ids, prompt_embeds) -> tuple:
        """(token ids, the embeddings as an f32 tensor on the device) of a
        prompt-embeds request; placeholder ids 0 where none are given."""
        if self.spec is not None and self.spec.draft_model is not None:
            raise ValueError("prompt_embeds with a separate draft model: its embedding "
                             "table and width are its own")
        if self._eagle:
            raise ValueError("prompt_embeds with EAGLE: the JAX package feeds EAGLE's "
                             "prefill the placeholder ids (ROADMAP queue 3)")
        pe = torch.as_tensor(np.asarray(prompt_embeds, np.float32)
                             if not isinstance(prompt_embeds, torch.Tensor) else prompt_embeds)
        pe = pe.to(device=self.device, dtype=torch.float32)
        if pe.ndim != 2 or pe.shape[1] != self.config.model.hidden_size:
            raise ValueError(f"prompt_embeds must be [n, {self.config.model.hidden_size}], "
                             f"got {tuple(pe.shape)}")
        ids = list(prompt_token_ids) if prompt_token_ids else [0] * pe.shape[0]
        if len(ids) != pe.shape[0]:
            raise ValueError(f"{pe.shape[0]} prompt_embeds rows for {len(ids)} prompt ids")
        return ids, pe

    def add_request(self, prompt_token_ids: List[int],
                    sampling_params: Optional[SamplingParams] = None,
                    request_id: Optional[int] = None, lora_id: int = 0,
                    lora_name: Optional[str] = None, prompt_embeds=None,
                    prompt_adapter: Optional[str] = None) -> int:
        """Queue a request. ``lora_name`` (an adapter of ``.lora``) or
        ``lora_id`` (a slot of ``params["lora"]``) picks its adapter;
        ``prompt_embeds`` [n, H] gives its prompt's embedding rows (the ids
        placeholders); ``prompt_adapter`` prepends a named soft prompt."""
        sp = sampling_params or SamplingParams()
        self.check_request(sp)
        if lora_name:
            lora_id = self.lora.slot_of(lora_name)
        if lora_id:
            self._check_lora(lora_id)
        if prompt_adapter:
            prompt_token_ids, prompt_embeds = self.prompt_adapters.splice(
                prompt_adapter, list(prompt_token_ids))
        if prompt_embeds is not None:
            prompt_token_ids, prompt_embeds = self._check_embeds(prompt_token_ids,
                                                                 prompt_embeds)
        fsm = None
        if _guided(sp):
            gc = self._get_grammar_compiler()
            if sp.guided_regex:
                fsm = gc.from_regex(sp.guided_regex)
            elif sp.guided_json is not None:
                fsm = gc.from_json_schema(sp.guided_json)
            else:
                fsm = gc.from_choice(sp.guided_choice)
        rid = request_id if request_id is not None else self._next_id
        self._next_id = max(self._next_id, rid + 1)
        self.scheduler.add_seq(Sequence(seq_id=rid, prompt_token_ids=list(prompt_token_ids),
                                        sampling_params=sp, grammar_fsm=fsm,
                                        lora_id=lora_id, prompt_embeds=prompt_embeds))
        self._traces[rid] = RequestTrace()
        return rid

    def _get_grammar_compiler(self) -> GrammarCompiler:
        if self._grammar_compiler is None:
            if self._grammar_vocab is None:
                self._grammar_vocab = hf_vocab_bytes(self.tokenizer)
            self._grammar_compiler = GrammarCompiler(self._grammar_vocab, self.eos_token_id)
        return self._grammar_compiler

    def abort_request(self, request_id: int) -> None:
        """Drop a request wherever it is (waiting, running or swapped out)
        and release its pages, rows and parked KV; no output follows."""
        sch = self.scheduler
        seq = next((s for q in (sch.waiting, sch.running, sch.swapped)
                    for s in q if s.seq_id == request_id), None)
        if seq is None:
            return
        sch.abort_seq(request_id)
        if self._swap_pool is not None:
            self._swap_pool.discard(request_id)
        self.runner.free_rows(seq)
        self._traces.pop(request_id, None)

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished()

    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        batch = self.scheduler.schedule()
        if batch.swap_out or batch.swap_in:
            self._process_swaps(batch)
        for s in self.scheduler.waiting:
            # a preempted sequence re-prefills its draft KV into a new row
            self.runner.free_ring_row(s)
        rejected = [self._to_output(s, trace=self._traces.pop(s.seq_id, None))
                    for s in self.scheduler.rejected]
        self.scheduler.rejected = []
        if batch.is_empty:
            return rejected
        if batch.kind == "prefill":
            with stage_range("prefill"):
                self._run_prefill(batch)
            if batch.decode_seqs:
                # mixed chunked-prefill iteration: running decodes advance in
                # the same engine step so admissions don't stall them
                with stage_range("decode"):
                    self._run_decode_phase(batch.decode_seqs, mixed=True)
        else:
            with stage_range("decode"):
                self._run_decode_phase(batch.seqs)

        outputs = rejected
        touched = (batch.seqs if batch.kind == "decode" else
                   [c.seq for c in batch.chunks
                    if c.seq.num_computed_tokens >= c.seq.prefill_len
                    and c.seq.output_token_ids] + batch.decode_seqs)
        for s in list(self.scheduler.running):
            if s.num_computed_tokens >= s.prefill_len:
                s.check_stop(self.eos_token_id)
                self._check_stop_strings(s)
        for s in (batch.seqs if batch.kind == "decode"
                  else [c.seq for c in batch.chunks] + batch.decode_seqs):
            tr = self._traces.get(s.seq_id)
            if tr is not None:
                tr.mark_scheduled()
                if s.output_token_ids:
                    tr.mark_first_token()
        for s in self.scheduler.free_finished():
            self.runner.free_rows(s)
            outputs.append(self._to_output(s, trace=self._traces.pop(s.seq_id, None)))
        for s in touched:
            if not s.is_finished:
                outputs.append(self._to_output(s, finished=False))
        if self.stat_loggers:
            self._log_stats(batch)
        return outputs

    def _process_swaps(self, batch: ScheduledBatch) -> None:
        """The scheduler's swaps, before the batch runs (the JAX package's
        ``_process_swaps``). Every gather runs before any scatter: a
        victim's pages may have gone to a sequence swapped in by the same
        schedule, and must be read before they are overwritten."""
        r = self.runner
        swapped_in = {s.seq_id for s in batch.swap_in}
        for seq, page_ids in batch.swap_out:
            if seq.seq_id in swapped_in:
                # swapped in and out again by one schedule: its parked copy
                # never left the pool
                continue
            pages, scales = r.gather_pages(page_ids)
            payload = {"n_pages": len(page_ids), "pages": pages, "scales": scales}
            if r.draft_cache is not None:
                if r._ring_pages:
                    # the ring's pages map position lp to lp % R in any row:
                    # they are restored into whatever row the sequence gets
                    ring = r.ring_page_ids(seq)
                    if ring is not None:
                        payload["draft_ring"] = r.gather_pages(ring, draft=True)
                    r.free_ring_row(seq)
                else:
                    payload["draft"] = r.gather_pages(page_ids, draft=True)
            self.swap_bytes_out += sum(t.numel() * t.element_size() for v in payload.values()
                                       for t in (v if isinstance(v, tuple) else (v,))
                                       if isinstance(t, torch.Tensor))
            self._swap_pool.put(seq.seq_id, len(page_ids), payload)
        live = {s.seq_id for s in self.scheduler.running}
        for seq in batch.swap_in:
            if seq.status != SequenceStatus.RUNNING:
                # preempted again by the same schedule: a swapped one keeps
                # its pool entry, a recomputed one restarts from its tokens
                if seq.status == SequenceStatus.WAITING:
                    self._swap_pool.discard(seq.seq_id)
                continue
            payload = self._swap_pool.pop(seq.seq_id)
            ids = seq.page_ids[:payload["n_pages"]]
            r.write_pages(ids, payload["pages"], payload["scales"])
            if "draft" in payload:
                r.write_pages(ids, *payload["draft"], draft=True)
            elif "draft_ring" in payload:
                r.write_pages(r.assign_ring_row(seq, live), *payload["draft_ring"], draft=True)

    def _log_stats(self, batch: ScheduledBatch) -> None:
        m = self.spec_metrics
        stats = Stats(
            num_running=len(self.scheduler.running),
            num_waiting=len(self.scheduler.waiting),
            num_free_pages=self.block_manager.num_free_pages,
            num_total_pages=self._num_total_pages,
            prompt_tokens=sum(c.end - c.start for c in batch.chunks)
            if batch.kind == "prefill" else 0,
            generation_tokens=len(batch.seqs) if batch.kind == "decode" else 0,
            spec_draft_acceptance_rate=m.draft_acceptance_rate
            if m.num_spec_rounds else None,
            spec_system_efficiency=m.system_efficiency
            if m.num_spec_rounds else None)
        for logger in self.stat_loggers:
            logger.record(stats)

    def _check_stop_strings(self, seq: Sequence) -> None:
        """Enforce SamplingParams.stop (stop *strings*), as the JAX package
        does: detokenize incrementally and search only the newly decoded text
        (plus the last len(stop) - 1 characters before it); at a hit, cut the
        output to the shortest token prefix whose text holds the stop string.
        The text excludes the stop string unless include_stop_str_in_output."""
        sp = seq.sampling_params
        if not sp.stop or seq.is_finished:
            return
        if seq.detok is None:
            seq.detok = DetokState()
        old_len = len(seq.detok.text)
        text = detokenize_incrementally(self.tokenizer, seq.output_token_ids, seq.detok)
        # a stop string can only appear in the new text, or straddle the
        # boundary by at most len(stop) - 1 characters of the old text
        search_from = max(0, old_len - max(len(s) for s in sp.stop) + 1)
        if not any(stop in text[search_from:] for stop in sp.stop):
            return
        for m in range(1, len(seq.output_token_ids) + 1):
            t = self.tokenizer.decode(seq.output_token_ids[:m])
            hit = min(((t.find(stop), stop) for stop in sp.stop if stop in t), default=None)
            if hit is None:
                continue
            idx, stop = hit
            seq.output_token_ids = seq.output_token_ids[:m]
            seq.output_logprobs = seq.output_logprobs[:m]
            seq.output_top_logprobs = seq.output_top_logprobs[:m]
            seq.stop_text = t[:idx + len(stop)] if sp.include_stop_str_in_output else t[:idx]
            seq.status = SequenceStatus.FINISHED_STOPPED
            seq.finish_reason = "stop"
            return

    def _spec_disabled(self, batch_size: int) -> bool:
        dbs = self.spec.disable_by_batch_size
        return dbs is not None and batch_size >= dbs

    def _run_decode_phase(self, seqs: List[Sequence], mixed: bool = False) -> None:
        if self.spec is not None and not self._spec_disabled(len(seqs)):
            self._run_spec_decode(seqs, mixed=mixed)
        else:
            self._run_decode(seqs)

    def _run_prefill(self, batch: ScheduledBatch) -> None:
        chunks = [(c.seq, c.start, c.end) for c in (batch.chunks or [batch.chunk])]
        eagle_h = None
        if self._eagle:
            # the target's chunk and, fused, EAGLE's draft KV of it
            logits, eagle_h = self.runner.run_prefill_chunks_eagle(chunks)
        else:
            logits = self.runner.run_prefill_chunks(chunks)
        if self._draft_cache and not self._eagle:
            # the draft keeps its own (draft-scheme) KV of the prompt
            self.runner.run_prefill_chunks(chunks, draft=True)
        # rows that completed a FRESH prompt sample their first token; a
        # resumed preempted sequence (preserved outputs) just finishes
        # recomputing KV — its last token is the next decode step's input
        completing = [i for i, (s, _, end) in enumerate(chunks)
                      if end == s.prefill_len and not s.output_token_ids]
        for s, _, end in chunks:
            s.num_computed_tokens = end
            self.block_manager.mark_computed(s)
        if completing:
            st = self.runner.sampling_tensors(
                make_sampling_tensors([c[0] for c in chunks],
                                      self.config.model.vocab_size,
                                      self.eos_token_id, self.runner.stack_grammars),
                len(chunks), logits.shape[0])
            want_top = self._wants_top([chunks[i][0] for i in completing])
            toks, lps, top = self.runner.sample_tokens(logits, st, want_top=want_top)
            for i in completing:
                s = chunks[i][0]
                s.append_token(int(toks[i]), float(lps[i]),
                               top=self._top_dict(s, top[0][i], top[1][i])
                               if top is not None else None)
        if eagle_h is not None:
            # the span seed: the hidden state at a finished prompt's last
            # position pairs with the token after it (the one just sampled,
            # or a resumed sequence's preserved last token)
            for i, (s, _, end) in enumerate(chunks):
                if end == s.prefill_len:
                    s.eagle_span = (eagle_h[i][None], np.asarray([s.last_token()], np.int32),
                                    end - 1, 1)

    @staticmethod
    def _wants_top(seqs) -> bool:
        return any((s.sampling_params.logprobs or 0) > 1 for s in seqs)

    @staticmethod
    def _top_dict(s: Sequence, topv, topi) -> Optional[dict]:
        """A sequence's first ``logprobs`` alternatives as {token id:
        logprob}; None where it did not ask for more than one."""
        n = min(int(s.sampling_params.logprobs or 0), topi.shape[-1])
        if n <= 1:
            return None
        return {int(topi[j]): float(topv[j]) for j in range(n)}

    def _run_decode(self, seqs: List[Sequence]) -> None:
        if not seqs:
            return
        st = make_sampling_tensors(seqs, self.config.model.vocab_size,
                                   self.eos_token_id, self.runner.stack_grammars)
        tokens, lps, top = self.runner.run_decode(seqs, st, want_top=self._wants_top(seqs))
        for i, s in enumerate(seqs):
            s.append_token(int(tokens[0, i]), float(lps[0, i]),
                           top=self._top_dict(s, top[0][0, i], top[1][0, i])
                           if top is not None else None)
            s.num_computed_tokens = s.num_tokens - 1

    def _chain_for(self, seqs: List[Sequence], per_call: int) -> int:
        """How many fused calls to issue back to back without reading tokens
        in between. Only safe when no host-side control depends on
        mid-chain tokens (EOS, stop tokens or strings, penalties, a grammar,
        whose state the host walks, force 1); overshoot
        past max_tokens is budget-masked on the device. Pages for the whole
        chain must be reservable up front."""
        MAXCHAIN = 8
        rem = 0
        for s in seqs:
            sp = s.sampling_params
            if ((not sp.ignore_eos and self.eos_token_id is not None)
                    or sp.stop or sp.stop_token_ids or s.grammar_fsm is not None
                    or sp.presence_penalty or sp.frequency_penalty):
                return 1
            rem = max(rem, sp.max_tokens - len(s.output_token_ids))
        chain = min(MAXCHAIN, max(1, -(-rem // max(per_call, 1))))
        look = self.scheduler.lookahead
        while chain > 1:
            if all(self.block_manager.append_slots(s, lookahead=chain * look)
                   for s in seqs):
                break
            chain -= 1
        return chain

    def _run_spec_decode(self, seqs: List[Sequence], mixed: bool = False) -> None:
        if not seqs:
            return
        k = self.spec.num_speculative_tokens
        st = make_sampling_tensors(seqs, self.config.model.vocab_size,
                                   self.eos_token_id, self.runner.stack_grammars)
        per_call = (k + 1) * self.spec.rounds_per_step
        chain = 1 if mixed else self._chain_for(seqs, per_call)
        t0 = time.perf_counter()
        # the "_null" methods run the SAME rounds with nulled proposals: the
        # bit-exact AR oracle of their path
        if self._eagle:
            tokens, accepted, lps = self.runner.run_eagle_rounds(seqs, st, chain=chain)
        elif self._medusa:
            tokens, accepted, lps = self.runner.run_medusa_rounds(
                seqs, st, enable=self.spec.method != "medusa_null", chain=chain)
        elif self._ngram:
            tokens, accepted, lps = self.runner.run_ngram_rounds(
                seqs, st, enable=self.spec.method == "ngram", chain=chain)
        else:
            tokens, accepted, lps = self.runner.run_spec_rounds(
                seqs, st, num_rounds=self.spec.rounds_per_step, chain=chain,
                enable=self.spec.method != "qspec_null")
        dt = time.perf_counter() - t0
        for i, s in enumerate(seqs):
            # the emitted rectangle is -1-masked past each round's accepted
            # length: one vectorized mask replaces a per-token loop
            col_t = tokens[:, i, :].reshape(-1)
            valid = col_t >= 0
            toks_list = col_t[valid].tolist()
            s.output_token_ids.extend(toks_list)
            s.output_logprobs.extend(lps[:, i, :].reshape(-1)[valid].tolist())
            s.output_top_logprobs.extend([None] * len(toks_list))
            if s.grammar_fsm is not None and s.grammar_state >= 0:
                # the host's copy of the state the rounds carried
                ns = s.grammar_fsm.next_state
                for t in toks_list:
                    if s.grammar_state < 0:
                        break
                    if 0 <= t < ns.shape[1]:
                        s.grammar_state = int(ns[s.grammar_state, t])
            s.num_computed_tokens = s.num_tokens - 1
            s.truncate_stop_overshoot(self.eos_token_id)
        emitted = int(accepted.sum())
        active_rounds = int((accepted > 0).sum())
        # draft-accepted = emitted - one bonus/recovery per live (round, seq)
        self.spec_metrics.record(
            num_draft_tokens=active_rounds * k, k=k,
            draft_accepted=emitted - active_rounds,
            emitted=emitted, wall_s=dt, per_seq_round=accepted[accepted > 0])

    # ------------------------------------------------------------------
    def _to_output(self, seq: Sequence, finished: bool = True,
                   trace: Optional[RequestTrace] = None) -> RequestOutput:
        """A request's output; a finished one carries its text (the stop
        string's cut, or the decode of its tokens, given a tokenizer) and,
        with its ``trace``, its latencies (the trace's span is emitted)."""
        text = ""
        if finished and seq.stop_text is not None:
            text = seq.stop_text
        elif finished and self.tokenizer is not None:
            text = self.tokenizer.decode(seq.output_token_ids)
        metrics = {}
        if trace is not None:
            trace.mark_finished()
            trace.emit(self.tracer, seq.seq_id, seq.prompt_len,
                       len(seq.output_token_ids), seq.sampling_params)
            metrics = {"time_in_queue": trace.first_scheduled - trace.arrival
                       if trace.first_scheduled is not None else None,
                       "time_to_first_token": trace.first_token - trace.arrival
                       if trace.first_token is not None else None,
                       "e2e": trace.finished - trace.arrival}
        return RequestOutput(
            request_id=seq.seq_id,
            prompt_token_ids=seq.prompt_token_ids,
            output_token_ids=list(seq.output_token_ids),
            finished=finished,
            finish_reason=seq.finish_reason,
            text=text,
            logprobs=list(seq.output_logprobs)
            if seq.sampling_params.logprobs else None,
            top_logprobs=list(seq.output_top_logprobs)
            if (seq.sampling_params.logprobs or 0) > 1 else None,
            metrics=metrics,
        )
