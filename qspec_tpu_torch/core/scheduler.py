"""Iteration-level continuous-batching scheduler.

The port's copy of qspec_tpu/core/scheduler.py (imports rewritten). Analogue of the reference Scheduler (vllm/core/scheduler.py:322):
same queues (waiting / running / preempted-to-recompute), chunked prefill
(_schedule_chunked_prefill:1151), and lookahead slots for speculative decode
(lookahead = k + 1 pages headroom per decode step). The TPU twist: every
batch it emits is a *static-shape rectangle* (B sequences x Q tokens) chosen
from the config's bucket ladder, because each distinct shape costs an XLA
compile. Prefill chunks are scheduled one sequence at a time (B=1, Q=chunk
bucket); decode/spec steps batch all running sequences padded up to a batch
bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from qspec_tpu_torch.config import SchedulerConfig
from qspec_tpu_torch.core.block_manager import BlockManager
from qspec_tpu_torch.core.sequence import Sequence, SequenceStatus


@dataclass
class PrefillChunk:
    seq: Sequence
    start: int  # token index into the prompt
    end: int


@dataclass
class ScheduledBatch:
    kind: str  # "prefill" | "decode"
    seqs: List[Sequence] = field(default_factory=list)
    chunk: Optional[PrefillChunk] = None          # first chunk (compat)
    chunks: List[PrefillChunk] = field(default_factory=list)
    # decode-phase sequences co-scheduled WITH a prefill batch (reference
    # _schedule_chunked_prefill mixes decodes into every prefill iteration,
    # vllm/core/scheduler.py:1151): the engine runs them as a separate Q=1
    # step right after the chunk rectangle, so running decodes never stall
    # behind an admission's prompt processing
    decode_seqs: List[Sequence] = field(default_factory=list)
    # swap-mode preemption actions the engine must execute BEFORE running
    # the batch (reference blocks_to_swap_out/in in SchedulerOutputs):
    # swap_out: (seq, page_ids snapshot) gathered device->host; swap_in:
    # resumed seqs whose parked KV is scattered into their fresh page_ids
    swap_out: List[tuple] = field(default_factory=list)
    swap_in: List[Sequence] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return (not self.seqs and not self.chunks and self.chunk is None
                and not self.swap_out and not self.swap_in)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, block_manager: BlockManager,
                 lookahead: int = 1):
        self.cfg = cfg
        self.bm = block_manager
        self.lookahead = lookahead  # k+1 for spec decode, 1 otherwise
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        # preempted with KV parked in host RAM (swap mode), FIFO resume
        self.swapped: List[Sequence] = []
        # capacity probe set by the engine when preemption_mode == "swap"
        # (HostSwapPool.can_reserve); None keeps pure recompute preemption
        self.swap_ok = None
        # sequences rejected before ever running (e.g. prompt too long);
        # drained by the engine so the client still gets a final output
        self.rejected: List[Sequence] = []

    # ------------------------------------------------------------------
    def add_seq(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def abort_seq(self, seq_id: int) -> None:
        for q in (self.waiting, self.running, self.swapped):
            for s in q:
                if s.seq_id == seq_id:
                    s.status = SequenceStatus.FINISHED_ABORTED
                    s.finish_reason = "abort"
                    if q is self.running:
                        self.bm.free(s)
                    q.remove(s)
                    return

    @property
    def num_unfinished(self) -> int:
        return len(self.waiting) + len(self.running) + len(self.swapped)

    def has_unfinished(self) -> bool:
        return self.num_unfinished > 0

    # ------------------------------------------------------------------
    def free_finished(self, hold=None) -> List[Sequence]:
        """Drop finished seqs from running and free their pages. ``hold``:
        predicate marking seqs whose pages the caller will extract first
        (KV handoff) — they are returned but NOT freed."""
        done = [s for s in self.running if s.is_finished]
        for s in done:
            if hold is None or not hold(s):
                self.bm.free(s)
        self.running = [s for s in self.running if not s.is_finished]
        return done

    def _try_swap_in(self, swap_in: List[Sequence]) -> None:
        """Resume swapped sequences (FIFO) while pages + slots allow. The
        engine scatters their parked KV into the fresh pages before the
        batch runs (reference blocks_to_swap_in)."""
        while self.swapped and len(self.running) < self.cfg.max_num_seqs:
            s = self.swapped[0]
            total = self.bm.pages_needed(s.num_tokens + self.lookahead)
            if self.bm.num_free_pages < total:
                break
            self.swapped.pop(0)
            assert not s.page_ids
            for _ in range(total):
                s.page_ids.append(self.bm.allocator.allocate_page())
            s.status = SequenceStatus.RUNNING
            self.running.append(s)
            swap_in.append(s)

    def _admit(self) -> None:
        """Move waiting -> running while pages + batch slots allow.
        Swapped sequences resume first: new prompts are not admitted while
        preempted work is parked (the reference schedules swapped_in before
        new prefills to avoid starvation)."""
        if self.swapped:
            return
        while self.waiting and len(self.running) < self.cfg.max_num_seqs:
            seq = self.waiting[0]
            if seq.prompt_len > self.cfg.max_model_len:
                seq.status = SequenceStatus.FINISHED_ABORTED
                seq.finish_reason = "prompt_too_long"
                self.waiting.pop(0)
                self.rejected.append(seq)
                continue
            if not self.bm.can_allocate(seq, lookahead=self.lookahead):
                break
            self.waiting.pop(0)
            cached = self.bm.allocate_prompt(seq, lookahead=self.lookahead)
            seq.num_computed_tokens = cached
            seq.status = SequenceStatus.RUNNING
            self.running.append(seq)

    def _preempt_one(self, swap_out: Optional[list] = None,
                     protect: Optional[set] = None) -> bool:
        """Preempt the most recent decode-phase sequence.

        Recompute mode (reference PreemptionMode.RECOMPUTE,
        core/scheduler.py:31): generated tokens are preserved; on resume,
        prefill recomputes KV for prompt+outputs (Sequence.prefill_len).

        Swap mode (reference PreemptionMode.SWAP): the pages holding the
        victim's computed KV are snapshotted into ``swap_out`` for the
        engine to gather device->host before this batch runs; the sequence
        parks in the swapped queue and resumes via _try_swap_in. Falls back
        to recompute when the host pool is full. ``protect``: seq_ids that
        must not be victimized (sequences swapped IN this same step — their
        parked KV has not been restored to the device yet, so there is
        nothing valid to gather)."""
        for s in reversed(self.running):
            if s.num_computed_tokens < s.prefill_len:  # prefer decode-phase victims
                continue
            if protect and s.seq_id in protect:
                continue
            self.running.remove(s)
            n_keep = self.bm.pages_needed(s.num_computed_tokens)
            use_swap = (self.cfg.preemption_mode == "swap"
                        and swap_out is not None and self.swap_ok is not None
                        and self.swap_ok(n_keep))
            if use_swap:
                swap_out.append((s, list(s.page_ids[:n_keep])))
                self.bm.free(s)
                s.status = SequenceStatus.SWAPPED
                self.swapped.append(s)
            else:
                self.bm.free(s)
                s.status = SequenceStatus.WAITING
                s.num_computed_tokens = 0
                self.waiting.insert(0, s)
            return True
        return False

    # ------------------------------------------------------------------
    def schedule(self) -> ScheduledBatch:
        swap_in: List[Sequence] = []
        swap_out: List[tuple] = []
        self._try_swap_in(swap_in)
        self._admit()
        # seqs swapped in THIS step must not be swap-out victims before the
        # engine restores their KV (see _preempt_one)
        protect = {s.seq_id for s in swap_in}

        # prefill first: any running seq with unprefilled prompt tokens.
        # Batch several sequences' chunks into one (B, Q) rectangle as long
        # as they land in the same token bucket (static shapes).
        prefilling = [s for s in self.running if s.num_computed_tokens < s.prefill_len]
        if prefilling:
            budget = self.cfg.prefill_chunk_size if self.cfg.enable_chunked_prefill \
                else self.cfg.max_num_batched_tokens
            chunks = []
            total = 0
            for seq in prefilling:
                start = seq.num_computed_tokens
                end = min(seq.prefill_len, start + budget)
                if chunks and (total + (end - start) > self.cfg.max_num_batched_tokens
                               or len(chunks) >= self.cfg.max_num_seqs):
                    break
                chunks.append(PrefillChunk(seq, start, end))
                total += end - start
            # co-schedule running decodes with the prefill chunks (reference
            # chunked prefill mixes both phases every iteration): only seqs
            # whose lookahead pages are already appendable WITHOUT
            # preempting anyone ride along — page pressure never evicts a
            # sequence just to keep a decode from waiting one chunk
            decode_seqs = []
            if self.cfg.mix_decode_with_prefill:
                chunk_ids = {c.seq.seq_id for c in chunks}
                for s in self.running:
                    if (s.status == SequenceStatus.RUNNING
                            and s.seq_id not in chunk_ids
                            and s.num_computed_tokens >= s.prefill_len
                            and len(decode_seqs) < self.cfg.max_num_seqs
                            and self.bm.append_slots(
                                s, lookahead=self.lookahead)):
                        decode_seqs.append(s)
            return ScheduledBatch(kind="prefill", seqs=[c.seq for c in chunks],
                                  chunk=chunks[0], chunks=chunks,
                                  decode_seqs=decode_seqs,
                                  swap_out=swap_out, swap_in=swap_in)

        # decode: all running seqs; ensure lookahead slots, preempting if needed
        decode_seqs: List[Sequence] = []
        for s in list(self.running):
            # an earlier iteration's page pressure may have preempted s
            # (this snapshot is stale): touching it here would hand pages to
            # a WAITING sequence, which leaks them and double-allocates on
            # its re-admission
            if s.status != SequenceStatus.RUNNING:
                continue
            ok = self.bm.append_slots(s, lookahead=self.lookahead)
            while not ok:
                if not self._preempt_one(swap_out, protect) \
                        or s not in self.running:
                    break
                ok = self.bm.append_slots(s, lookahead=self.lookahead)
            if ok and s in self.running and s.status == SequenceStatus.RUNNING:
                decode_seqs.append(s)
        decode_seqs = decode_seqs[:self.cfg.max_num_seqs]
        return ScheduledBatch(kind="decode", seqs=decode_seqs,
                              swap_out=swap_out, swap_in=swap_in)
