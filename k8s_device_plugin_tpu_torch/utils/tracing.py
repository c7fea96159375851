"""Profiler hooks of the serving process, on ``torch.profiler``.

Counterpart of the reference's ``utils/tracing.py`` (workload side only):
``trace()`` captures a ``torch.profiler`` trace of the enclosed region —
host ops and, on the card, the CUDA kernels the region launched — and
writes it as a Chrome trace (Perfetto or ``chrome://tracing`` load it);
``annotate()`` names a region so host Python lines up with the device
work in that trace.  The daemon-side RPC timer of the reference belongs
with the device plugin, which is not ported yet.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Iterator, Optional

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
