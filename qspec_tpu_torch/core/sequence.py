"""Request / sequence state machine (engine <-> runner contract).

The port's copy of qspec_tpu/core/sequence.py (imports rewritten). Slimmed analogue of the reference's vllm/sequence.py (Sequence:386,
SequenceGroup:624, SequenceGroupMetadata:898, ExecuteModelRequest:1267). We
serve one sequence per request (no beam search fan-out in round 1), so the
Sequence *is* the group. The reference's `w4a4` request flag
(sequence.py:1301) maps to the runner's static scheme choice instead — the
scheduler never needs to thread it through metadata.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import List, Optional

from qspec_tpu_torch.sampling_params import SamplingParams


class SequenceStatus(enum.Enum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    PREEMPTED = enum.auto()
    # preempted with KV parked in host RAM (reference SequenceStatus.SWAPPED)
    SWAPPED = enum.auto()
    FINISHED_STOPPED = enum.auto()
    FINISHED_LENGTH = enum.auto()
    FINISHED_ABORTED = enum.auto()

    @property
    def is_finished(self) -> bool:
        return self in (SequenceStatus.FINISHED_STOPPED, SequenceStatus.FINISHED_LENGTH,
                        SequenceStatus.FINISHED_ABORTED)


@dataclass
class Sequence:
    seq_id: int
    prompt_token_ids: List[int]
    sampling_params: SamplingParams
    arrival_time: float = field(default_factory=time.monotonic)
    output_token_ids: List[int] = field(default_factory=list)
    output_logprobs: List[float] = field(default_factory=list)
    # per-position top-N alternatives {token_id: logprob} when the request
    # set logprobs > 1 (reference Logprob dicts, vllm/sequence.py); None
    # entries when not requested / unavailable (fused spec rounds)
    output_top_logprobs: List[Optional[dict]] = field(default_factory=list)
    status: SequenceStatus = SequenceStatus.WAITING
    # paged-KV bookkeeping
    page_ids: List[int] = field(default_factory=list)
    # tokens whose KV has been computed (prefill progress / decode watermark)
    num_computed_tokens: int = 0
    finish_reason: Optional[str] = None
    # adapter slot in the engine's LoRA table (0 = base model)
    lora_id: int = 0
    # content hashes of this seq's freshly-allocated full prompt pages,
    # registered into the prefix cache only once their KV is computed
    # (reference marks blocks computed post-execution, not at allocation)
    pending_page_hashes: List[tuple] = field(default_factory=list)
    # final text override set when a stop *string* fired mid-token
    stop_text: Optional[str] = None
    # grammar-guided decoding: compiled token FSM (guided/tokenfsm.TokenFSM)
    # and the automaton state after the tokens emitted so far. The device
    # loops advance their own state copies; the host mirror here advances in
    # append_token, so batches can restart mid-generation (preemption,
    # bucket changes) without a device read-back.
    grammar_fsm: Optional[object] = None
    grammar_state: int = 0
    # "generate" | "embed": embed requests finish at end of prefill with a
    # pooled hidden-state vector instead of sampled tokens (reference
    # pooling-model path, vllm/model_executor/layers/pooler.py)
    task: str = "generate"
    embedding: Optional[object] = None
    # pre-computed prompt embeddings [prompt_len, hidden] (reference
    # inputs_embeds / multimodal path): prompt_token_ids then hold
    # placeholders, prefill feeds these vectors instead of the embed-table
    # rows, and the sequence is excluded from prefix caching (its pages
    # cannot be identified by token content)
    prompt_embeds: Optional[object] = None
    # whisper: mel features [T_mel, num_mel] for the audio encoder
    # (models/whisper.py); the prompt_token_ids are the DECODER stream
    audio_features: Optional[object] = None
    # EAGLE's span seed, set by the prompt's prefill: (the hidden state at
    # the prompt's last position [1, H], the token after it [1], that
    # position, 1); the rounds keep the span on the device from there
    # (engine/model_runner.py run_eagle_rounds)
    eagle_span: Optional[tuple] = None
    # watermark of output tokens already scanned for stop conditions
    # (truncate_stop_overshoot): keeps the per-step stop scan O(new tokens)
    # instead of O(all outputs)
    stop_scan_pos: int = 0
    # incremental detokenization state (detokenizer.DetokState), created
    # lazily by the engine's stop-string / streaming-text paths
    detok: Optional[object] = None

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def prefill_len(self) -> int:
        """Tokens that must be (re)computed by prefill before decode can run.

        Fresh sequences: the whole prompt (the last position's logits seed
        the first sampled token). Preempted-and-resumed sequences keep their
        generated tokens (reference RECOMPUTE preemption), so prefill must
        cover prompt + outputs except the final token, which the next decode
        step consumes as input.
        """
        if self.output_token_ids:
            return self.num_tokens - 1
        return len(self.prompt_token_ids)

    @property
    def token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def is_finished(self) -> bool:
        return self.status.is_finished

    def last_token(self) -> int:
        return self.token_ids[-1]

    def append_token(self, token_id: int, logprob: float = 0.0,
                     top: Optional[dict] = None) -> None:
        self.output_token_ids.append(token_id)
        self.output_logprobs.append(logprob)
        self.output_top_logprobs.append(top)
        if self.grammar_fsm is not None and self.grammar_state >= 0:
            ns = self.grammar_fsm.next_state
            if 0 <= token_id < ns.shape[1]:
                self.grammar_state = int(ns[self.grammar_state, token_id])

    def check_stop(self, eos_token_id: Optional[int]) -> None:
        sp = self.sampling_params
        if len(self.output_token_ids) >= sp.max_tokens:
            self.status = SequenceStatus.FINISHED_LENGTH
            self.finish_reason = "length"
            return
        if not self.output_token_ids:
            return
        last = self.output_token_ids[-1]
        if not sp.ignore_eos and eos_token_id is not None and last == eos_token_id:
            self.status = SequenceStatus.FINISHED_STOPPED
            self.finish_reason = "stop"
            return
        if sp.stop_token_ids and last in sp.stop_token_ids:
            self.status = SequenceStatus.FINISHED_STOPPED
            self.finish_reason = "stop"

    def truncate_stop_overshoot(self, eos_token_id: Optional[int]) -> None:
        """After a speculative round appended several tokens, cut anything
        past the first stop condition (the reference handles this in
        _process_model_outputs / stop checking, llm_engine.py:975)."""
        sp = self.sampling_params
        stop_set = set(sp.stop_token_ids or ())
        if not sp.ignore_eos and eos_token_id is not None:
            stop_set.add(eos_token_id)
        # scan only tokens appended since the last check (the fused calls
        # append up to rounds*(k+1)*chain at once; rescanning the full
        # output every step would be O(n^2) over a generation)
        start = self.stop_scan_pos
        if stop_set:
            for i in range(start, len(self.output_token_ids)):
                if self.output_token_ids[i] in stop_set:
                    self.output_token_ids = self.output_token_ids[:i + 1]
                    self.output_logprobs = self.output_logprobs[:i + 1]
                    self.output_top_logprobs = self.output_top_logprobs[:i + 1]
                    self.stop_scan_pos = i + 1
                    self.status = SequenceStatus.FINISHED_STOPPED
                    self.finish_reason = "stop"
                    return
        self.stop_scan_pos = len(self.output_token_ids)
        if len(self.output_token_ids) >= sp.max_tokens:
            self.output_token_ids = self.output_token_ids[:sp.max_tokens]
            self.output_logprobs = self.output_logprobs[:sp.max_tokens]
            self.output_top_logprobs = self.output_top_logprobs[:sp.max_tokens]
            self.stop_scan_pos = min(self.stop_scan_pos, sp.max_tokens)
            self.status = SequenceStatus.FINISHED_LENGTH
            self.finish_reason = "length"
