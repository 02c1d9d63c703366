"""LLMEngine: request lifecycle + continuous-batching event loop.

Port of the prefill / decode / spec-round paths of
``qspec_tpu/engine/llm_engine.py``. ``speculative=None`` gives plain W4A16
autoregressive continuous batching; a SpeculativeConfig turns every decode
step into draft (w4a4) + verify (w4a16) rounds over shared weights with
per-phase KV caches. Requests are token ids: the port has no tokenizer, so
stop strings and grammar-guided decoding are not ported and are rejected.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from qspec_tpu_torch.config import EngineConfig
from qspec_tpu_torch.core.block_manager import BlockManager
from qspec_tpu_torch.core.scheduler import ScheduledBatch, Scheduler
from qspec_tpu_torch.core.sequence import Sequence
from qspec_tpu_torch.engine.model_runner import ModelRunner, make_sampling_tensors
from qspec_tpu_torch.models.llama import resolve_device
from qspec_tpu_torch.sampling_params import SamplingParams
from qspec_tpu_torch.spec_decode.metrics import SpecDecodeMetrics


@dataclass
class RequestOutput:
    request_id: int
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None
    logprobs: Optional[List[float]] = None


def _check_supported(config: EngineConfig) -> None:
    spec = config.speculative
    if spec is not None:
        if spec.method not in ("qspec", "qspec_null"):
            raise NotImplementedError(f"speculative method {spec.method!r} is "
                                      "not ported (qspec, qspec_null)")
        if spec.draft_scheme not in ("w4a4", "w4a8"):
            raise NotImplementedError(f"draft_scheme {spec.draft_scheme!r}")
    if config.scheduler.preemption_mode != "recompute":
        raise NotImplementedError("only recompute preemption is ported")


class LLMEngine:
    def __init__(self, config: EngineConfig, params, num_pages: Optional[int] = None,
                 eos_token_id: Optional[int] = None, device="cuda", seed: int = 0):
        _check_supported(config)
        self.config = config
        self.eos_token_id = eos_token_id
        self.device = resolve_device(device)
        self.spec = config.speculative
        lookahead = ((self.spec.num_speculative_tokens + 1)
                     * self.spec.rounds_per_step) if self.spec else 1
        if num_pages is None:
            num_pages = self._derive_num_pages()
        self.runner = ModelRunner(config, params, num_pages,
                                  need_draft_cache=self.spec is not None,
                                  device=self.device, seed=seed)
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
        page_bytes = (2 * mc.num_layers * cc.page_size * mc.cache_kv_heads
                      * mc.cache_head_dim * 2)
        n_caches = 2 if self.spec is not None else 1
        fit = int(free * cc.gpu_memory_utilization // (page_bytes * n_caches))
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
        logits = self.runner.run_prefill_chunks(chunks)
        if self.spec is not None:
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
                    or sp.presence_penalty or sp.frequency_penalty
                    or sp.repetition_penalty != 1.0):
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
        # "qspec_null" runs the SAME rounds with nulled proposals: the
        # bit-exact AR oracle of the model-draft path
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
            emitted=emitted, wall_s=dt)

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
