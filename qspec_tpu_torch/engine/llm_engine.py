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
from qspec_tpu_torch.detokenizer import DetokState, detokenize_incrementally
from qspec_tpu_torch.engine.metrics import Stats
from qspec_tpu_torch.engine.model_runner import (ModelRunner, make_sampling_tensors,
                                                 ring_pages, ring_rows)
from qspec_tpu_torch.guided import GrammarCompiler, hf_vocab_bytes
from qspec_tpu_torch.models.llama import check_served, resolve_device
from qspec_tpu_torch.ops import kv_cache as kvc
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
    if config.scheduler.preemption_mode != "recompute":
        raise NotImplementedError("only recompute preemption is ported")


def _guided(sp: SamplingParams) -> bool:
    return bool(sp.guided_regex or sp.guided_json is not None or sp.guided_choice)


class LLMEngine:
    def __init__(self, config: EngineConfig, params, num_pages: Optional[int] = None,
                 eos_token_id: Optional[int] = None, device="cuda", seed: int = 0,
                 draft_params=None, tokenizer=None, grammar_vocab=None):
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

    def add_request(self, prompt_token_ids: List[int],
                    sampling_params: Optional[SamplingParams] = None,
                    request_id: Optional[int] = None) -> int:
        sp = sampling_params or SamplingParams()
        self.check_request(sp)
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
                                        sampling_params=sp, grammar_fsm=fsm))
        self._traces[rid] = RequestTrace()
        return rid

    def _get_grammar_compiler(self) -> GrammarCompiler:
        if self._grammar_compiler is None:
            if self._grammar_vocab is None:
                self._grammar_vocab = hf_vocab_bytes(self.tokenizer)
            self._grammar_compiler = GrammarCompiler(self._grammar_vocab, self.eos_token_id)
        return self._grammar_compiler

    def abort_request(self, request_id: int) -> None:
        """Drop a request wherever it is (waiting or running) and release
        its pages and rows; no output follows."""
        seq = next((s for q in (self.scheduler.waiting, self.scheduler.running)
                    for s in q if s.seq_id == request_id), None)
        if seq is None:
            return
        self.scheduler.abort_seq(request_id)
        self.runner.free_rows(seq)
        self._traces.pop(request_id, None)

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished()

    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        batch = self.scheduler.schedule()
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
