"""Speculative-decoding metrics (the port's copy of
qspec_tpu/spec_decode/metrics.py).

Mirrors the reference's SpecDecodeWorkerMetrics / AsyncMetricsCollector
(vllm/spec_decode/metrics.py:12,51,172-184): draft_acceptance_rate,
system_efficiency, and the accepted/draft/emitted counters that BASELINE.md
designates as the headline numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SpecDecodeMetrics:
    num_spec_rounds: int = 0
    num_draft_tokens: int = 0
    num_draft_accepted: int = 0
    num_emitted_tokens: int = 0
    total_wall_s: float = 0.0
    per_round_wall: list = field(default_factory=list)

    def record(self, num_seqs: int = 0, k: int = 0, draft_accepted: int = 0,
               emitted: int = 0, wall_s: float = 0.0,
               num_draft_tokens: int = None) -> None:
        self.num_spec_rounds += 1
        if num_draft_tokens is None:
            num_draft_tokens = num_seqs * k
        self.num_draft_tokens += num_draft_tokens
        self.num_draft_accepted += draft_accepted
        self.num_emitted_tokens += emitted
        self.total_wall_s += wall_s
        self.per_round_wall.append(wall_s)

    @property
    def draft_acceptance_rate(self) -> float:
        """accepted draft tokens / proposed draft tokens
        (reference metrics.py:19-22)."""
        if self.num_draft_tokens == 0:
            return 0.0
        return self.num_draft_accepted / self.num_draft_tokens

    @property
    def system_efficiency(self) -> float:
        """emitted tokens / max emittable ((k+1) per round-seq)
        (reference metrics.py:23-27)."""
        denom = self.num_draft_tokens + self.num_spec_rounds_seqs
        if denom == 0:
            return 0.0
        return self.num_emitted_tokens / denom

    @property
    def num_spec_rounds_seqs(self) -> int:
        # draft tokens = rounds * seqs * k, so rounds*seqs = draft/k (k>=1)
        if self.num_draft_tokens == 0:
            return 0
        # recover seqs-rounds from counters; exact because k is constant
        return self.num_emitted_tokens - self.num_draft_accepted

    def summary(self) -> dict:
        return {
            "draft_acceptance_rate": round(self.draft_acceptance_rate, 4),
            "system_efficiency": round(self.system_efficiency, 4),
            "num_spec_rounds": self.num_spec_rounds,
            "num_draft_tokens": self.num_draft_tokens,
            "num_accepted_tokens": self.num_draft_accepted,
            "num_emitted_tokens": self.num_emitted_tokens,
        }
