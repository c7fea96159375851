"""Request-scoped tracing: trace IDs, nested spans, a bounded span ring.

The port's own copy of the reference's ``utils/spans.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The reference has no observability at all (SURVEY.md §5.5) and the
serving engine until now had per-process counters only — no way to ask
"where did THIS request's 900 ms go?".  This module is the host-side
span layer arXiv:2510.16946 argues accelerator fleets are missing:
stdlib-only (contextvars + deque + logging), cheap enough to leave on,
and readable without any collector — the ring snapshot is served
straight from ``/debug/state``.

Three pieces:

- **Trace IDs**: ``new_trace_id()`` mints one; ``sanitize_trace_id()``
  validates a client-supplied ``X-Request-Id`` (bounded, printable) and
  mints a fresh one otherwise, so a hostile header can never corrupt
  logs or the exposition.
- **Nested spans**: ``SpanRecorder.span()`` is a context manager whose
  parent link follows a contextvar — same-thread nesting needs no
  plumbing.  Cross-thread structure (the serving topology: HTTP handler
  threads submit, ONE owner thread steps) uses ``reserve_id()`` +
  explicit ``parent_id``/``span_id`` on ``record_span`` — the request
  carries its root id across threads.
- **Bounded ring**: a ``deque(maxlen=capacity)`` of finished spans;
  overflow drops the OLDEST and counts ``dropped`` (diagnosis wants the
  recent past, and an unbounded buffer in a serving daemon is a leak).

Every recorded span can also be emitted as one structured JSON event
through utils/logging.py (``emit=True``): the JsonFormatter merges the
``event`` dict into the log line, so `kubectl logs` carries the same
record the ring serves.
"""

from __future__ import annotations

import contextvars
import logging
import os
import re
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

log = logging.getLogger("tpu.spans")

# Engine-scoped (not request-scoped) spans use this trace id.
ENGINE_TRACE = "engine"
# Daemon-side RPC spans (utils/tracing.timed_rpc) use this one: the one
# span ring tells kubelet-RPC and engine-request timelines apart by trace.
DAEMON_TRACE = "daemon"

_MAX_TRACE_ID_LEN = 128
_FORBIDDEN = set('"\\\n\r')


def new_trace_id() -> str:
    """A fresh 16-hex trace id (random, not time-derived: ids must not
    collide across concurrently restarting pods)."""
    return os.urandom(8).hex()


def sanitize_trace_id(raw: object) -> str:
    """A usable trace id from a client-supplied ``X-Request-Id`` header.

    Accepts any printable string up to 128 chars without quotes,
    backslashes, or newlines (the characters that would need escaping in
    log lines and Prometheus label values); anything else — including a
    missing header — gets a fresh generated id, never an error: tracing
    must not add a rejection path to the serving API.
    """
    if isinstance(raw, str):
        rid = raw.strip()
        if (
            0 < len(rid) <= _MAX_TRACE_ID_LEN
            and rid.isprintable()
            and not (_FORBIDDEN & set(rid))
        ):
            return rid
    return new_trace_id()


# --------------------------------------------------------- hop context
#
# Cross-process span propagation (fleet-wide tracing): the router stamps
# one ``X-Trace-Context`` header on EVERY upstream dial — first attempt,
# each retry, each hedge leg, and the failover resubmission all carry a
# DISTINCT attempt span id — and the replica roots its per-request span
# tree under that id instead of floating free.  The format is
# W3C-traceparent-shaped (version-traceid-parentid-tail) but keeps the
# repo's trace-id contract (any printable id the sanitize gate accepts,
# dashes included — parsing splits from the RIGHT so a dashed trace id
# survives) and replaces the W3C flags byte with ``<hop><attempt>``
# (two hex bytes): which edge of the request's journey this dial is,
# and which attempt along that edge.

TRACE_CONTEXT_HEADER = "X-Trace-Context"
_CTX_VERSION = "00"
_SPAN_HEX_RE = re.compile(r"^[0-9a-f]{16}$")
_BYTE_HEX_RE = re.compile(r"^[0-9a-f]{2}$")


class HopContext(NamedTuple):
    """One parsed ``X-Trace-Context``: the sender's trace id, the span
    id of the sending attempt (16 lowercase hex — the cross-process
    parent link the assembler joins on), and the hop/attempt indexes
    (0-255 each; the wire clamps)."""

    trace_id: str
    parent_span: str
    hop: int
    attempt: int


def format_span_id(span_id: int) -> str:
    """A span id as the 16-hex wire form ``X-Trace-Context`` carries
    (process-local ints; the pair (process, id) is globally unique and
    the assembler scopes the join per source)."""
    return f"{int(span_id) & 0xFFFFFFFFFFFFFFFF:016x}"


def format_trace_context(
    trace_id: str, parent_span_id: int, hop: int, attempt: int
) -> str:
    """The ``X-Trace-Context`` value for one outbound dial.  Hop and
    attempt clamp into [0, 255] (a request surviving 255 attempts has
    bigger problems than a saturated counter)."""
    hop = min(max(int(hop), 0), 255)
    attempt = min(max(int(attempt), 0), 255)
    return (
        f"{_CTX_VERSION}-{trace_id}-{format_span_id(parent_span_id)}"
        f"-{hop:02x}{attempt:02x}"
    )


def parse_trace_context(raw: object) -> Optional[HopContext]:
    """Parse a client/router-supplied ``X-Trace-Context``; None on ANY
    malformation (wrong version, bad hex, hostile trace id) — the
    receiver then falls back to the plain ``X-Request-Id`` contract.
    Parsing never raises and never mints ids: a header that fails here
    simply doesn't link, it cannot corrupt the span ring."""
    if not isinstance(raw, str):
        return None
    value = raw.strip()
    # Longest legal header: "00-" + 128-char id + "-" + 16 hex + "-" + 4.
    if not (8 < len(value) <= _MAX_TRACE_ID_LEN + 25):
        return None
    if not value.startswith(_CTX_VERSION + "-"):
        return None
    # Split from the RIGHT: the trace id may itself contain dashes
    # (sanitize_trace_id admits any printable id), so only the two
    # fixed-width trailing fields are separator-addressed.
    body = value[len(_CTX_VERSION) + 1:]
    parts = body.rsplit("-", 2)
    if len(parts) != 3:
        return None
    trace_id, parent_span, tail = parts
    # The embedded trace id must pass the SAME gate a bare X-Request-Id
    # does — compare against the sanitizer instead of re-implementing it
    # (sanitize returns the input verbatim iff it was acceptable).
    if not trace_id or sanitize_trace_id(trace_id) != trace_id:
        return None
    if not _SPAN_HEX_RE.match(parent_span):
        return None
    if len(tail) != 4:
        return None
    hop_hex, attempt_hex = tail[:2], tail[2:]
    if not (_BYTE_HEX_RE.match(hop_hex) and _BYTE_HEX_RE.match(attempt_hex)):
        return None
    return HopContext(
        trace_id, parent_span, int(hop_hex, 16), int(attempt_hex, 16)
    )


# The active span's id and trace id for same-thread nesting.  Module-level
# (not per-recorder): a thread has one active span regardless of which
# recorder it lands in.
_current_span_id: contextvars.ContextVar[int] = contextvars.ContextVar(
    "tpu_span_id", default=0
)
_current_trace_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "tpu_trace_id", default=""
)


def current_trace_id() -> str:
    """The trace id of the innermost active span ("" when none)."""
    return _current_trace_id.get()


class _ActiveSpan:
    """Context-manager handle for one in-flight span (attrs may be added
    mid-flight via ``set``)."""

    def __init__(self, recorder: "SpanRecorder", name: str, trace_id: str, attrs: dict):
        self._recorder = recorder
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs
        self.span_id = recorder.reserve_id()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_ActiveSpan":
        self._parent = _current_span_id.get()
        self._tok_span = _current_span_id.set(self.span_id)
        self._tok_trace = _current_trace_id.set(self.trace_id)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        end = time.monotonic()
        _current_span_id.reset(self._tok_span)
        _current_trace_id.reset(self._tok_trace)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._recorder.record_span(
            self.name,
            self.trace_id,
            start_monotonic=self._t0,
            end_monotonic=end,
            span_id=self.span_id,
            parent_id=self._parent,
            attrs=self.attrs,
        )
        return False


class SpanRecorder:
    """Thread-safe bounded ring of finished spans + span-id allocator.

    ``capacity`` bounds host memory; overflow evicts the oldest span and
    increments ``dropped`` (visible in /debug/state so an operator knows
    the window was truncated).  ``emit=True`` additionally logs each
    span as one structured event through the ``tpu.spans`` logger.
    """

    def __init__(
        self, capacity: int = 512, emit: bool = False, name: str = "spans"
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.emit = emit
        # Keys this recorder in multi-recorder flight dumps and the
        # trace assembler's source labels (a serving pod has an
        # "engine" ring; the router daemon a "router" ring).
        self.name = name
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._next_id = 1
        self.dropped = 0

    def reserve_id(self) -> int:
        """Allocate a span id BEFORE the span is recorded — how a root
        span's id crosses threads (children record against it while the
        root is still open)."""
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def span(self, name: str, trace_id: Optional[str] = None, **attrs) -> _ActiveSpan:
        """Context manager timing the enclosed region; nests under the
        thread's active span (contextvars) and inherits its trace id
        unless one is given."""
        tid = trace_id if trace_id is not None else (current_trace_id() or new_trace_id())
        return _ActiveSpan(self, name, tid, attrs)

    def record_span(
        self,
        name: str,
        trace_id: str,
        *,
        start_monotonic: float,
        end_monotonic: Optional[float] = None,
        span_id: Optional[int] = None,
        parent_id: int = 0,
        attrs: Optional[dict] = None,
    ) -> int:
        """Record a span from explicit monotonic timestamps (the engine's
        post-hoc shape: queue wait is known only at admission, decode
        duration only at finish).  Returns the span id."""
        end = time.monotonic() if end_monotonic is None else end_monotonic
        sid = self.reserve_id() if span_id is None else span_id
        entry = {
            "name": name,
            "trace_id": trace_id,
            "span_id": sid,
            "parent_id": parent_id,
            # Wall-clock start derived from the monotonic pair so ring
            # entries line up with log timestamps and Prometheus scrapes.
            "start": round(time.time() - (time.monotonic() - start_monotonic), 6),
            "duration_ms": round(max(end - start_monotonic, 0.0) * 1e3, 3),
        }
        if attrs:
            entry["attrs"] = dict(attrs)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(entry)
        if self.emit:
            log.info(
                "span %s trace=%s %.3fms",
                name,
                trace_id,
                entry["duration_ms"],
                extra={"event": entry},
            )
        return sid

    def snapshot(self) -> list[dict]:
        """Recent spans, oldest first (JSON-safe copies)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def dump(self, trace_id: Optional[str] = None) -> dict:
        """The ``GET /debug/spans`` body (also what flight dumps embed):
        the ring plus its truncation accounting, optionally filtered to
        ONE request's tree so the assembler's live mode doesn't pull
        whole rings."""
        spans = self.snapshot()
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return {
            "name": self.name,
            "spans": spans,
            "dropped": self.dropped,
            "capacity": self.capacity,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


def monotonic_to_wall(t_monotonic: float) -> float:
    """Convert a ``time.monotonic()`` stamp to approximate wall time."""
    return time.time() - (time.monotonic() - t_monotonic)
