"""Beam search over the engine (the port of ``qspec_tpu/beam_search.py``).

As in the JAX package (and vLLM's v1 design), beam search lives outside the
engine: each step asks the engine for one token of every live beam with its
top-2W logprobs (``SamplingParams.logprobs``, the engine's top-n
alternatives), then expands and prunes the beams on the host. Prefix
caching makes the repeated prompt + beam prefills incremental: only each
beam's last, partly filled page is computed again.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from qspec_tpu_torch.engine.model_runner import TOPN
from qspec_tpu_torch.sampling_params import SamplingParams


@dataclasses.dataclass
class BeamSearchParams:
    beam_width: int = 4
    max_tokens: int = 16
    ignore_eos: bool = False
    length_penalty: float = 1.0   # score = cumulative logprob / len ** length_penalty
    temperature: float = 0.0      # 0: the classic deterministic search


@dataclasses.dataclass
class BeamSearchSequence:
    tokens: List[int]             # the generated tokens (the prompt excluded)
    cum_logprob: float
    finished: bool = False

    def score(self, length_penalty: float) -> float:
        return self.cum_logprob / (max(len(self.tokens), 1) ** length_penalty)


@dataclasses.dataclass
class BeamSearchOutput:
    sequences: List[BeamSearchSequence]  # best first


def beam_search(engine, prompt_token_ids: List[List[int]], params: BeamSearchParams,
                eos_token_id: Optional[int] = None) -> List[BeamSearchOutput]:
    """``params.beam_width`` sequences for each prompt, best first by the
    length-penalized cumulative logprob."""
    W = params.beam_width
    if not 1 <= 2 * W <= TOPN:
        raise ValueError(f"beam_width={W}: each step reads 2 x beam_width alternatives, "
                         f"and the engine returns at most {TOPN}")
    eos = eos_token_id if eos_token_id is not None else engine.eos_token_id
    sp = SamplingParams(temperature=params.temperature, max_tokens=1, logprobs=2 * W,
                        ignore_eos=True)
    states = [[BeamSearchSequence([], 0.0)] for _ in prompt_token_ids]
    completed: List[List[BeamSearchSequence]] = [[] for _ in prompt_token_ids]

    def best(pool):
        return sorted(pool, key=lambda s: s.score(params.length_penalty), reverse=True)[:W]

    for _ in range(params.max_tokens):
        live = [(pi, b) for pi, beams in enumerate(states) for b in beams if not b.finished]
        if not live:
            break
        rids = {engine.add_request(prompt_token_ids[pi] + b.tokens, sp): (pi, b)
                for pi, b in live}
        tops = {}
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished and out.request_id in rids:
                    tops[out.request_id] = (out.top_logprobs or [None])[0] or {}
        nxt: List[List[BeamSearchSequence]] = [[] for _ in prompt_token_ids]
        for rid, (pi, b) in rids.items():
            for tok, lp in tops.get(rid, {}).items():
                cand = BeamSearchSequence(b.tokens + [int(tok)], b.cum_logprob + float(lp))
                if not params.ignore_eos and eos is not None and int(tok) == eos:
                    cand.finished = True
                    completed[pi].append(cand)
                else:
                    nxt[pi].append(cand)
        for pi in range(len(prompt_token_ids)):
            states[pi] = best(nxt[pi])
            completed[pi] = best(completed[pi])
    return [BeamSearchOutput(sequences=best(completed[pi] + states[pi]))
            for pi in range(len(prompt_token_ids))]
