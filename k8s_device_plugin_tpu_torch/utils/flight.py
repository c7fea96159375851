"""Flight recorder: a bounded black-box journal of typed events.

The port's own copy of the reference's ``utils/flight.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The daemon and the serving engine have scrapeable gauges and a
request-span ring — good for "how is it doing NOW".  What they could not
answer is the post-mortem question arXiv:2510.16946 frames as the
host-side diagnosis gap (an "accelerator backend dead or hung" with
nothing to dump): *what happened in the last
60 seconds before it went wrong*.  This module is the black box:

- **Typed events**: ``record(kind, **fields)`` appends one timestamped
  dict (registration, ListAndWatch updates, Allocate, health
  transitions, engine step summaries, admission rejects, incidents —
  the catalog lives in docs/operations.md "Forensics").
- **Bounded + drop-accounted**: a ``deque(maxlen=capacity)``; overflow
  evicts the oldest event and counts it, per kind — the snapshot always
  says how much history it is NOT showing.
- **Snapshot-to-JSON**: :meth:`snapshot` is JSON-safe by construction
  (fields are sanitized at record time, never at dump time — a dump
  taken from a signal handler must not be able to fail on a weird
  field).
- **Dump-on-demand**: ``kill -USR2 <pid>`` writes every registered
  recorder to ``TPU_PLUGIN_DUMP_DIR`` (or the system tempdir); an
  atexit hook writes a final dump when a dump dir was explicitly
  configured, so even a crash-exit leaves the last window on disk
  (the DaemonSet/serving yamls mount the dir).

Stdlib-only and cheap enough to leave on: one lock, one deque append,
no I/O until a dump is asked for.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal as _signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Optional

log = logging.getLogger("tpu.flight")

DUMP_DIR_ENV = "TPU_PLUGIN_DUMP_DIR"

_JSON_SCALARS = (str, int, float, bool, type(None))


def _json_safe(value):
    """Coerce one event field to something json.dumps cannot choke on.

    Runs at RECORD time so the dump path (which may run inside a signal
    handler or interpreter teardown) never needs to repr live objects."""
    if isinstance(value, _JSON_SCALARS):
        return value
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    return str(value)


class FlightRecorder:
    """Thread-safe bounded journal of typed events with drop accounting.

    ``name`` keys the recorder in multi-recorder dumps (a serving pod
    has an "engine" box; the plugin daemon a "daemon" box).  The lock is
    reentrant so a SIGUSR2 arriving while the main thread is inside
    :meth:`record` cannot deadlock the dump.
    """

    def __init__(self, capacity: int = 2048, name: str = "flight"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self._lock = threading.RLock()
        self._ring: deque[dict] = deque(maxlen=capacity)  # guarded by: _lock
        self.recorded = 0
        self.dropped = 0
        self._dropped_by_kind: dict[str, int] = {}
        self._recorded_by_kind: dict[str, int] = {}

    def record(self, kind: str, **fields) -> dict:
        """Append one typed event; returns the entry (already JSON-safe)."""
        entry = {"ts": round(time.time(), 6), "kind": str(kind)}
        for key, value in fields.items():
            entry[key] = _json_safe(value)
        with self._lock:
            self.recorded += 1
            k = entry["kind"]
            self._recorded_by_kind[k] = self._recorded_by_kind.get(k, 0) + 1
            if len(self._ring) == self.capacity:
                evicted = self._ring[0]
                self.dropped += 1
                ek = evicted.get("kind", "?")
                self._dropped_by_kind[ek] = self._dropped_by_kind.get(ek, 0) + 1
            self._ring.append(entry)
        return entry

    def count(self, kind: str) -> int:
        """Lifetime count of one event kind — survives ring eviction, so
        a scorer can ask "how many admission.shed decisions happened"
        even after a busy window rolled the events themselves out."""
        with self._lock:
            return self._recorded_by_kind.get(kind, 0)

    def window(
        self,
        seconds: Optional[float] = None,
        last: Optional[int] = None,
        kinds=None,
    ) -> list[dict]:
        """Recent events, oldest first — the slice an incident record
        attaches.  ``seconds`` keeps events newer than now-seconds;
        ``last`` caps the count (applied after the other filters);
        ``kinds`` restricts to an iterable of event kinds."""
        with self._lock:
            events = list(self._ring)
        if seconds is not None:
            horizon = time.time() - seconds
            events = [e for e in events if e["ts"] >= horizon]
        if kinds is not None:
            wanted = set(kinds)
            events = [e for e in events if e["kind"] in wanted]
        if last is not None and len(events) > last:
            events = events[-last:]
        return [dict(e) for e in events]

    def snapshot(self) -> dict:
        """The whole box as one JSON-safe dict: events plus the drop
        accounting that says how truncated the window is."""
        with self._lock:
            return {
                "name": self.name,
                "capacity": self.capacity,
                "recorded": self.recorded,
                "dropped": self.dropped,
                "dropped_by_kind": dict(self._dropped_by_kind),
                "recorded_by_kind": dict(self._recorded_by_kind),
                "events": [dict(e) for e in self._ring],
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.recorded = 0
            self.dropped = 0
            self._dropped_by_kind.clear()
            self._recorded_by_kind.clear()


# ---------------------------------------------------------------- dumping

# Recorders that SIGUSR2/atexit dumps cover.  Explicit registration (the
# daemon/server mains call register()) rather than auto-register in
# __init__: tests construct hundreds of throwaway recorders and a global
# dump must not grow with them.
_registry: list[FlightRecorder] = []
# Span rings (utils/spans.SpanRecorder) dumped ALONGSIDE the flight
# recorders: a post-mortem dump then carries both halves of the
# request story — the typed-event journal AND the span trees the trace
# assembler (tools/trace_assemble.py) joins across processes.  Same
# explicit-registration rule.
_span_registry: list = []
_registry_lock = threading.Lock()


def register(recorder: FlightRecorder) -> FlightRecorder:
    """Add a recorder to the process-wide dump set (idempotent)."""
    with _registry_lock:
        if recorder not in _registry:
            _registry.append(recorder)
    return recorder


def unregister(recorder: FlightRecorder) -> None:
    with _registry_lock:
        if recorder in _registry:
            _registry.remove(recorder)


def registered() -> list[FlightRecorder]:
    with _registry_lock:
        return list(_registry)


def register_spans(recorder):
    """Add a span ring (utils/spans.SpanRecorder) to the process-wide
    dump set (idempotent): SIGUSR2/atexit dumps then embed its spans
    under ``spans.<recorder.name>`` — the offline input to
    ``tools/trace_assemble.py``."""
    with _registry_lock:
        if recorder not in _span_registry:
            _span_registry.append(recorder)
    return recorder


def unregister_spans(recorder) -> None:
    with _registry_lock:
        if recorder in _span_registry:
            _span_registry.remove(recorder)


def registered_spans() -> list:
    with _registry_lock:
        return list(_span_registry)


def default_dump_dir(environ=None) -> Optional[str]:
    """The configured dump directory (``TPU_PLUGIN_DUMP_DIR``) or None."""
    environ = os.environ if environ is None else environ
    return environ.get(DUMP_DIR_ENV) or None


# Process-wide dump-dir retention budget (utils/postmortem.py's shared
# LRU sweeper): when armed (the daemons' --dump-budget-mb flag),
# dump_all prunes oldest-first after each write so SIGUSR2/atexit dumps
# and postmortem bundles never accumulate unbounded.
_dump_budget: dict = {"bytes": None, "entries": None}


def set_dump_budget(
    budget_bytes: Optional[int], max_entries: Optional[int] = None
) -> None:
    """Arm (or clear, with None) the dump-dir retention budget applied
    after every dump_all write."""
    _dump_budget["bytes"] = budget_bytes
    _dump_budget["entries"] = max_entries


def dump_all(
    dump_dir: Optional[str] = None,
    reason: str = "manual",
    recorders=None,
    span_recorders=None,
) -> Optional[str]:
    """Write every registered (or explicitly passed) recorder to one JSON
    file under ``dump_dir`` (env default, tempdir fallback); returns the
    path, or None when there was nothing to dump.  Registered span rings
    ride along under ``spans`` (the trace assembler's offline input).
    Never raises — the callers are signal handlers and atexit hooks,
    where an exception would replace the forensic record with a
    traceback."""
    recs = list(recorders) if recorders is not None else registered()
    span_recs = (
        list(span_recorders)
        if span_recorders is not None
        else registered_spans()
    )
    if not recs and not span_recs:
        return None
    payload = {
        "schema": "tpu-flight-dump/v1",
        "reason": reason,
        "pid": os.getpid(),
        "argv": [str(a) for a in sys.argv],
        "ts": round(time.time(), 3),
        "recorders": {r.name: r.snapshot() for r in recs},
    }
    if span_recs:
        payload["spans"] = {r.name: r.dump() for r in span_recs}
    directory = dump_dir or default_dump_dir() or tempfile.gettempdir()
    path = os.path.join(
        directory,
        f"tpu-flight-{os.getpid()}-{reason}-{int(time.time())}.json",
    )
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, separators=(",", ":"))
        # Atomic publish: a collector tailing the dir never reads a
        # half-written dump.
        os.replace(tmp, path)
    except OSError as e:
        log.error("flight dump to %s failed: %s", path, e)
        return None
    log.info("flight dump (%s) -> %s", reason, path)
    if _dump_budget["bytes"] is not None or _dump_budget["entries"] is not None:
        # Retention sweep (never raises): the just-written dump is
        # protected so a tiny budget cannot eat its own forensics.
        from . import postmortem as _postmortem

        _postmortem.sweep_dump_dir(
            directory,
            _dump_budget["bytes"],
            _dump_budget["entries"],
            protect=(path,),
            flight=recs[0] if recs else None,
        )
    return path


class DumpHandle:
    """Installed dump hooks, with an uninstall for tests/embedders."""

    def __init__(self, prev_handler, signum, atexit_fn):
        self._prev = prev_handler
        self._signum = signum
        self._atexit_fn = atexit_fn

    def uninstall(self) -> None:
        if self._signum is not None:
            try:
                _signal.signal(self._signum, self._prev)
            except (ValueError, OSError):
                pass
            self._signum = None
        if self._atexit_fn is not None:
            atexit.unregister(self._atexit_fn)
            self._atexit_fn = None


def install_dump_handlers(
    dump_dir: Optional[str] = None,
    *,
    signum: int = getattr(_signal, "SIGUSR2", 0),
    on_exit: bool = True,
) -> DumpHandle:
    """Arm the black box: SIGUSR2 dumps every registered recorder on
    demand, and (``on_exit``) an atexit hook writes a final dump WHEN a
    dump dir was configured (argument or ``TPU_PLUGIN_DUMP_DIR``) —
    unconfigured processes must not litter tempdirs on every clean exit.

    Signal installation is skipped quietly off the main thread (hermetic
    tests drive daemon mains from worker threads); the atexit hook still
    arms.  Returns a handle whose ``uninstall()`` restores the previous
    signal disposition."""
    prev = None
    installed_signum = None
    if signum:
        def _on_signal(_signum, _frame):
            dump_all(dump_dir, reason="sigusr2")

        try:
            prev = _signal.signal(signum, _on_signal)
            installed_signum = signum
        except ValueError:
            log.debug("not on main thread; skipping SIGUSR2 dump handler")
    atexit_fn = None
    if on_exit and (dump_dir or default_dump_dir()):
        def _on_exit():
            dump_all(dump_dir, reason="exit")

        atexit.register(_on_exit)
        atexit_fn = _on_exit
    return DumpHandle(prev, installed_signum, atexit_fn)
