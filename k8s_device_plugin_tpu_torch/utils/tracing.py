"""Profiler hooks of the serving process, on ``torch.profiler``, and the
device plugin's RPC timer.

Counterpart of the reference's ``utils/tracing.py``.  Workload side:
``trace()`` captures a ``torch.profiler`` trace of the enclosed region —
host ops and, on the card, the CUDA kernels the region launched — and
writes it as a Chrome trace (Perfetto or ``chrome://tracing`` load it);
``annotate()`` names a region so host Python lines up with the device
work in that trace.  Daemon side: ``timed_rpc`` decorates the GPU device
plugin's gRPC handlers with wall-time logging, an optional ``observe``
hook and one span per call in the ``utils/spans.py`` ring, under the
reference's ``DAEMON_TRACE`` id (one monotonic pair per call).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time
from typing import Iterator, Optional

from .spans import DAEMON_TRACE

log = logging.getLogger(__name__)

# Traces started through this module, counted so annotate() can tell
# whether naming a region would reach a profiler at all.
_active_traces = 0
_active_lock = threading.Lock()


def default_trace_dir(environ=None) -> Optional[str]:
    """The conventional trace-dir env (TPU_PLUGIN_TRACE_DIR), as the
    reference reads it."""
    environ = os.environ if environ is None else environ
    return environ.get("TPU_PLUGIN_TRACE_DIR") or None


def trace_active() -> bool:
    """True while a trace started via :func:`trace` runs."""
    return _active_traces > 0


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``trace_dir`` as ``trace-<pid>-<time>.json`` (no-op when trace_dir is
    falsy, so callers can wire it straight to an optional flag).  CUDA
    activity is recorded when a card is present."""
    global _active_traces
    if not trace_dir:
        yield
        return
    import torch

    os.makedirs(trace_dir, exist_ok=True)
    log.info("profiler trace -> %s", trace_dir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        with _active_lock:
            _active_traces += 1
        try:
            yield
        finally:
            with _active_lock:
                _active_traces -= 1
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside an active trace (``record_function``); a
    no-op when no trace started via this module is running."""
    if not trace_active():
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def timed_rpc(
    fn=None,
    *,
    observe=None,
    threshold_ms: float = 0.0,
    spans=None,
    name: Optional[str] = None,
):
    """Decorator for daemon RPC handlers: debug-log wall time per call,
    feed ``observe(seconds)`` (e.g. a metrics summary), and record one
    daemon-side span per call into ``spans`` — either a utils/spans.py
    SpanRecorder or a no-arg callable returning one/None (late binding:
    decoration happens before the daemon wires its recorder).  RPC spans
    carry the DAEMON_TRACE trace id, so the one span ring tells
    engine-request and kubelet-RPC timelines apart by trace.
    ``threshold_ms`` promotes slow calls to WARNING."""

    def wrap(f):
        span_name = name or f"rpc.{f.__name__}"

        @functools.wraps(f)
        def inner(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return f(*args, **kwargs)
            finally:
                end = time.monotonic()
                dt = end - t0
                if observe is not None:
                    observe(dt)
                recorder = spans() if callable(spans) else spans
                if recorder is not None:
                    recorder.record_span(
                        span_name,
                        DAEMON_TRACE,
                        start_monotonic=t0,
                        end_monotonic=end,
                    )
                if threshold_ms and dt * 1e3 >= threshold_ms:
                    log.warning("%s took %.1f ms", f.__name__, dt * 1e3)
                else:
                    log.debug("%s took %.2f ms", f.__name__, dt * 1e3)

        return inner

    return wrap if fn is None else wrap(fn)
