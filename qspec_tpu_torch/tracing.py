"""Request-level tracing: the port of ``qspec_tpu/tracing.py``.

``RequestTrace`` keeps each request's timing breadcrumbs (arrival, first
scheduled, first token, finished); ``LLMEngine`` marks them every step and,
when a tracer is set (``LLMEngine.enable_tracing``), emits one OpenTelemetry
span per finished request with the reference's attribute names (gen_ai.*,
queue / first-token / end-to-end latencies). Without OpenTelemetry
``init_tracer`` returns None and nothing is emitted. ``stage_range`` names an
engine stage in a ``torch.profiler`` trace and, on a card, in an NVTX range
(the JAX package's ``jax.profiler.TraceAnnotation``).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

SpanAttributes = {
    "GEN_AI_USAGE_PROMPT_TOKENS": "gen_ai.usage.prompt_tokens",
    "GEN_AI_USAGE_COMPLETION_TOKENS": "gen_ai.usage.completion_tokens",
    "GEN_AI_LATENCY_TIME_IN_QUEUE": "gen_ai.latency.time_in_queue",
    "GEN_AI_LATENCY_TIME_TO_FIRST_TOKEN": "gen_ai.latency.time_to_first_token",
    "GEN_AI_LATENCY_E2E": "gen_ai.latency.e2e",
    "GEN_AI_REQUEST_ID": "gen_ai.request.id",
    "GEN_AI_REQUEST_TEMPERATURE": "gen_ai.request.temperature",
    "GEN_AI_REQUEST_MAX_TOKENS": "gen_ai.request.max_tokens",
}


def is_otel_available() -> bool:
    try:
        import opentelemetry.trace  # noqa: F401
        return True
    except ImportError:
        return False


def init_tracer(service_name: str = "qspec_tpu_torch",
                otlp_endpoint: Optional[str] = None):
    """Returns an opentelemetry tracer, or None when OTel isn't usable."""
    if not is_otel_available():
        return None
    from opentelemetry import trace
    from opentelemetry.sdk.resources import Resource
    from opentelemetry.sdk.trace import TracerProvider

    provider = TracerProvider(
        resource=Resource.create({"service.name": service_name}))
    if otlp_endpoint:
        try:
            from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                OTLPSpanExporter)
            from opentelemetry.sdk.trace.export import BatchSpanProcessor
            provider.add_span_processor(
                BatchSpanProcessor(OTLPSpanExporter(endpoint=otlp_endpoint)))
        except ImportError:
            pass
    trace.set_tracer_provider(provider)
    return trace.get_tracer("qspec_tpu_torch")


@dataclass
class RequestTrace:
    """Timing breadcrumbs accumulated per request."""

    arrival: float = field(default_factory=time.monotonic)
    first_scheduled: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None

    def mark_scheduled(self):
        if self.first_scheduled is None:
            self.first_scheduled = time.monotonic()

    def mark_first_token(self):
        if self.first_token is None:
            self.first_token = time.monotonic()

    def mark_finished(self):
        self.finished = time.monotonic()

    def emit(self, tracer, request_id, prompt_tokens: int,
             completion_tokens: int, sampling_params=None):
        if tracer is None or self.finished is None:
            return
        A = SpanAttributes
        span = tracer.start_span("llm_request",
                                 start_time=int(self.arrival * 1e9))
        span.set_attribute(A["GEN_AI_REQUEST_ID"], str(request_id))
        span.set_attribute(A["GEN_AI_USAGE_PROMPT_TOKENS"], prompt_tokens)
        span.set_attribute(A["GEN_AI_USAGE_COMPLETION_TOKENS"], completion_tokens)
        if self.first_scheduled is not None:
            span.set_attribute(A["GEN_AI_LATENCY_TIME_IN_QUEUE"],
                               self.first_scheduled - self.arrival)
        if self.first_token is not None:
            span.set_attribute(A["GEN_AI_LATENCY_TIME_TO_FIRST_TOKEN"],
                               self.first_token - self.arrival)
        span.set_attribute(A["GEN_AI_LATENCY_E2E"], self.finished - self.arrival)
        if sampling_params is not None:
            span.set_attribute(A["GEN_AI_REQUEST_TEMPERATURE"],
                               sampling_params.temperature)
            span.set_attribute(A["GEN_AI_REQUEST_MAX_TOKENS"],
                               sampling_params.max_tokens)
        span.end(end_time=int(self.finished * 1e9))


@contextlib.contextmanager
def stage_range(name: str):
    """Named profiler scope around an engine stage: a
    ``torch.profiler.record_function`` range, and an NVTX range while a card
    is in use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
