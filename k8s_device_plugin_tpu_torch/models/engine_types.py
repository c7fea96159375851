"""Serving-engine types: the request record and its Prometheus series.

The port's own copy of the reference's ``models/engine_types.py``, trimmed
to what this slice fills: the request lifecycle of a single-model engine
(no adapters, priorities, deadlines or tracing yet) and the counters,
gauges and TTFT/ITL histograms the step loop and its overlap round
update.  Metric
names are the reference's, so one dashboard reads both engines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils.metrics import MetricsRegistry


def _pow2_int(text: str) -> int:
    """argparse type: positive power of two."""
    import argparse

    value = int(text)
    if value < 1 or value & (value - 1):
        raise argparse.ArgumentTypeError(f"must be a positive power of two, got {value}")
    return value


class EngineMetrics:
    """Prometheus series for the serving engine."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.requests = registry.counter(
            "tpu_engine_requests_total", "Requests admitted into a decode slot"
        )
        self.tokens = registry.counter(
            "tpu_engine_tokens_total", "Tokens emitted across all requests"
        )
        self.steps = registry.counter("tpu_engine_steps_total", "Decode steps executed")
        self.state_rebuilds = registry.counter(
            "tpu_engine_state_rebuilds_total",
            "Device step-state rebuilds from host lists (admissions, teardowns)",
        )
        self.overlap_hits = registry.counter(
            "tpu_engine_overlap_hits_total",
            "Decode rounds consumed from an overlapped in-flight dispatch",
        )
        self.overlap_discards = registry.counter(
            "tpu_engine_overlap_discards_total",
            "Overlapped dispatches thrown away because a slot event invalidated their inputs",
        )
        self.active_slots = registry.gauge(
            "tpu_engine_active_slots", "Slots currently serving a request"
        )
        self.queued = registry.gauge(
            "tpu_engine_queued_requests", "Requests waiting for slots/pages"
        )
        self.free_pages = registry.gauge("tpu_engine_free_pages", "Unallocated KV-cache pages")
        self.shared_pages = registry.gauge(
            "tpu_engine_shared_pages",
            "Pages currently referenced by more than one request (prefix sharing)",
        )
        self.page_utilization = registry.gauge(
            "tpu_engine_kv_page_utilization",
            "Allocated fraction of the allocatable KV page pool (0..1)",
        )
        self.kernel_enabled = registry.gauge(
            "tpu_engine_kernel_enabled",
            "1 when the paged decode reads the KV pool through the split-K "
            "paged-attention kernel, 0 on the gather path",
        )
        self.step_seconds = registry.histogram(
            "tpu_engine_step_seconds",
            "Wall time of one engine step() call (admission + prefill + decode)",
        )
        self.wait_seconds = registry.histogram(
            "tpu_engine_request_wait_seconds",
            "Queue-to-first-token wait per request",
            buckets=(0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0),
        )
        self.ttft_seconds = registry.histogram(
            "tpu_engine_ttft_seconds",
            "Submit-to-first-token latency per request",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
        )
        self.itl_seconds = registry.histogram(
            "tpu_engine_itl_seconds", "Inter-token latency per emitted decode token"
        )


@dataclasses.dataclass
class Request:
    """One generation request and, when finished, its output tokens.

    ``temperature`` 0 is greedy; > 0 samples at that temperature, with
    ``top_k``/``top_p`` restricting to the k highest logits / the smallest
    nucleus of mass >= p (None = off).  ``stop``: token-id sequences that
    end generation; the matched suffix is excluded from ``tokens``."""

    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    stop: Optional[list[list[int]]] = None
    # Latched when a stop sequence matched (the suffix is truncated away).
    stopped: bool = False
    rid: int = -1
    # monotonic lifecycle stamps (0.0 until reached).
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Set by ServingEngine.cancel(): a queued request finishes at once; an
    # in-flight one is torn down at the next step boundary.
    cancelled: bool = False
