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
own tokens, no draft forward: the proposer of a bf16 checkpoint). Requests
are token ids: the port has no tokenizer, so stop strings and grammar-guided
decoding are not ported and are rejected, as are the sampling knobs no
sampler applies (repetition_penalty, a per-request seed).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from qspec_tpu_torch.config import EngineConfig
from qspec_tpu_torch.core.block_manager import BlockManager
from qspec_tpu_torch.core.scheduler import ScheduledBatch, Scheduler
from qspec_tpu_torch.core.sequence import Sequence
from qspec_tpu_torch.engine.model_runner import (ModelRunner, make_sampling_tensors,
                                                 ring_pages, ring_rows)
from qspec_tpu_torch.models.llama import check_served, resolve_device
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.sampling_params import SamplingParams
from qspec_tpu_torch.spec_decode.eagle import eagle_cfg_for
from qspec_tpu_torch.spec_decode.metrics import SpecDecodeMetrics


@dataclass
class RequestOutput:
    request_id: int
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None
    logprobs: Optional[List[float]] = None


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
    if config.scheduler.preemption_mode != "recompute":
        raise NotImplementedError("only recompute preemption is ported")


class LLMEngine:
    def __init__(self, config: EngineConfig, params, num_pages: Optional[int] = None,
                 eos_token_id: Optional[int] = None, device="cuda", seed: int = 0,
                 draft_params=None):
        _check_supported(config)
        self.config = config
        self.eos_token_id = eos_token_id
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
    def add_request(self, prompt_token_ids: List[int],
                    sampling_params: Optional[SamplingParams] = None,
                    request_id: Optional[int] = None) -> int:
        sp = sampling_params or SamplingParams()
        if sp.stop or sp.guided_regex or sp.guided_json is not None \
                or sp.guided_choice:
            raise NotImplementedError("stop strings and guided decoding are "
                                      "not ported")
        if (sp.logprobs or 0) > 1:
            raise NotImplementedError("top-n logprobs are not ported")
        if sp.repetition_penalty != 1.0:
            raise NotImplementedError("repetition_penalty is not ported: no "
                                      "sampler applies it")
        if sp.seed is not None and not sp.greedy:
            raise NotImplementedError("a per-request seed for sampled decoding "
                                      "is not ported: the engine's generator "
                                      "(LLMEngine seed) samples every request")
        rid = request_id if request_id is not None else self._next_id
        self._next_id = max(self._next_id, rid + 1)
        self.scheduler.add_seq(Sequence(seq_id=rid,
                                        prompt_token_ids=list(prompt_token_ids),
                                        sampling_params=sp))
        return rid

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished()

    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        batch = self.scheduler.schedule()
        for s in self.scheduler.waiting:
            # a preempted sequence re-prefills its draft KV into a new row
            self.runner.free_ring_row(s)
        rejected = [self._to_output(s) for s in self.scheduler.rejected]
        self.scheduler.rejected = []
        if batch.is_empty:
            return rejected
        if batch.kind == "prefill":
            self._run_prefill(batch)
            if batch.decode_seqs:
                # mixed chunked-prefill iteration: running decodes advance in
                # the same engine step so admissions don't stall them
                self._run_decode_phase(batch.decode_seqs, mixed=True)
        else:
            self._run_decode_phase(batch.seqs)

        outputs = rejected
        touched = (batch.seqs if batch.kind == "decode" else
                   [c.seq for c in batch.chunks
                    if c.seq.num_computed_tokens >= c.seq.prefill_len
                    and c.seq.output_token_ids] + batch.decode_seqs)
        for s in list(self.scheduler.running):
            if s.num_computed_tokens >= s.prefill_len:
                s.check_stop(self.eos_token_id)
        for s in self.scheduler.free_finished():
            self.runner.free_rows(s)
            outputs.append(self._to_output(s))
        for s in touched:
            if not s.is_finished:
                outputs.append(self._to_output(s, finished=False))
        return outputs

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
                                      self.eos_token_id),
                len(chunks), logits.shape[0])
            toks, lps = self.runner.sample_tokens(logits, st)
            for i in completing:
                chunks[i][0].append_token(int(toks[i]), float(lps[i]))
        if eagle_h is not None:
            # the span seed: the hidden state at a finished prompt's last
            # position pairs with the token after it (the one just sampled,
            # or a resumed sequence's preserved last token)
            for i, (s, _, end) in enumerate(chunks):
                if end == s.prefill_len:
                    s.eagle_span = (eagle_h[i][None], np.asarray([s.last_token()], np.int32),
                                    end - 1, 1)

    def _run_decode(self, seqs: List[Sequence]) -> None:
        if not seqs:
            return
        st = make_sampling_tensors(seqs, self.config.model.vocab_size,
                                   self.eos_token_id)
        tokens, lps = self.runner.run_decode(seqs, st)
        for i, s in enumerate(seqs):
            s.append_token(int(tokens[0, i]), float(lps[0, i]))
            s.num_computed_tokens = s.num_tokens - 1

    def _chain_for(self, seqs: List[Sequence], per_call: int) -> int:
        """How many fused calls to issue back to back without reading tokens
        in between. Only safe when no host-side control depends on
        mid-chain tokens (EOS / stop tokens / penalties force 1); overshoot
        past max_tokens is budget-masked on the device. Pages for the whole
        chain must be reservable up front."""
        MAXCHAIN = 8
        rem = 0
        for s in seqs:
            sp = s.sampling_params
            if ((not sp.ignore_eos and self.eos_token_id is not None)
                    or sp.stop_token_ids
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
                                   self.eos_token_id)
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
    def _to_output(self, seq: Sequence, finished: bool = True) -> RequestOutput:
        return RequestOutput(
            request_id=seq.seq_id,
            prompt_token_ids=seq.prompt_token_ids,
            output_token_ids=list(seq.output_token_ids),
            finished=finished,
            finish_reason=seq.finish_reason,
            logprobs=list(seq.output_logprobs)
            if seq.sampling_params.logprobs else None,
        )
