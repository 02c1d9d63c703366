"""Engine metrics: Prometheus and a periodic stdout line.

The port of ``qspec_tpu/engine/metrics.py``: ``Stats`` is one scheduler
iteration's snapshot, handed by ``LLMEngine.step`` to each of its
``stat_loggers``; ``PrometheusMetrics`` sets the reference's gauges and
counters (it raises ImportError without ``prometheus_client``, which is
imported only when one is built); ``LoggingStatLogger`` prints a rate line
every ``interval_s``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

@dataclass
class Stats:
    """One scheduler-iteration snapshot (reference Stats, engine/metrics.py)."""

    now: float = field(default_factory=time.monotonic)
    num_running: int = 0
    num_waiting: int = 0
    num_free_pages: int = 0
    num_total_pages: int = 0
    prompt_tokens: int = 0
    generation_tokens: int = 0
    spec_draft_acceptance_rate: Optional[float] = None
    spec_system_efficiency: Optional[float] = None

    @property
    def kv_cache_usage(self) -> float:
        if self.num_total_pages == 0:
            return 0.0
        return 1.0 - self.num_free_pages / self.num_total_pages


class PrometheusMetrics:
    """Gauges/counters matching the reference metric names where sensible."""

    def __init__(self, model_name: str = "qspec_tpu_torch", registry=None):
        try:
            import prometheus_client as prom
        except ImportError as e:
            raise ImportError("prometheus_client not available") from e
        if registry is None:
            registry = prom.REGISTRY
        labels = {"model_name": model_name}

        def gauge(name, doc):
            g = prom.Gauge(name, doc, labelnames=list(labels),
                           registry=registry)
            return g.labels(**labels)

        def counter(name, doc):
            c = prom.Counter(name, doc, labelnames=list(labels),
                             registry=registry)
            return c.labels(**labels)

        self.num_running = gauge("qspec_num_requests_running",
                                 "Running sequences")
        self.num_waiting = gauge("qspec_num_requests_waiting",
                                 "Queued sequences")
        self.kv_usage = gauge("qspec_kv_cache_usage_perc",
                              "KV page pool utilization")
        self.prompt_tokens = counter("qspec_prompt_tokens_total",
                                     "Prefilled prompt tokens")
        self.generation_tokens = counter("qspec_generation_tokens_total",
                                         "Generated tokens")
        self.acceptance = gauge("qspec_spec_decode_draft_acceptance_rate",
                                "Draft token acceptance rate")
        self.efficiency = gauge("qspec_spec_decode_efficiency",
                                "Spec decode system efficiency")

    def record(self, stats: Stats) -> None:
        self.num_running.set(stats.num_running)
        self.num_waiting.set(stats.num_waiting)
        self.kv_usage.set(stats.kv_cache_usage)
        if stats.prompt_tokens:
            self.prompt_tokens.inc(stats.prompt_tokens)
        if stats.generation_tokens:
            self.generation_tokens.inc(stats.generation_tokens)
        if stats.spec_draft_acceptance_rate is not None:
            self.acceptance.set(stats.spec_draft_acceptance_rate)
        if stats.spec_system_efficiency is not None:
            self.efficiency.set(stats.spec_system_efficiency)


class LoggingStatLogger:
    """Periodic stdout stats line (reference LoggingStatLogger)."""

    def __init__(self, interval_s: float = 10.0, log_fn=print):
        self.interval_s = interval_s
        self.log_fn = log_fn
        self._last = 0.0
        self._gen_tokens = 0
        self._prompt_tokens = 0

    def record(self, stats: Stats) -> None:
        self._gen_tokens += stats.generation_tokens
        self._prompt_tokens += stats.prompt_tokens
        now = stats.now
        if now - self._last < self.interval_s:
            return
        dt = max(now - self._last, 1e-9)
        spec = ""
        if stats.spec_draft_acceptance_rate is not None:
            spec = (f", accept {stats.spec_draft_acceptance_rate:.1%}"
                    f", eff {stats.spec_system_efficiency:.1%}")
        self.log_fn(
            f"[qspec] gen {self._gen_tokens / dt:.1f} tok/s, "
            f"prefill {self._prompt_tokens / dt:.1f} tok/s, "
            f"running {stats.num_running}, waiting {stats.num_waiting}, "
            f"kv {stats.kv_cache_usage:.1%}{spec}")
        self._last = now
        self._gen_tokens = 0
        self._prompt_tokens = 0
