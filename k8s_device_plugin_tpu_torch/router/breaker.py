"""Per-replica circuit breakers and the global retry budget.

The port's own copy of the reference's ``router/breaker.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The failure containment half of the router: a replica that starts
failing must be cut out of the dispatch order BEFORE every request pays
its connect timeout (breaker), and a fleet-wide brownout must not let
retries multiply the load that caused it (budget).

Breaker state machine (the classic three states):

    closed ──(N consecutive failures)──> open
    open   ──(cooldown elapsed)────────> half_open   (one probe allowed)
    half_open ──probe success──> closed
    half_open ──probe failure──> open   (fresh cooldown)

``try_acquire()`` is the dispatch-side gate: it consumes the half-open
probe slot, so exactly one request tests a recovering replica while the
rest keep failing over — a thundering herd against a just-restarted
replica is the failure mode half-open exists to prevent.

The retry budget is a token bucket shared by every retry/hedge/failover
in the process: first attempts are free (clients must not be rejected
because the budget is empty), every EXTRA upstream dispatch spends a
token.  When the bucket is dry the router degrades to
one-attempt-per-request instead of amplifying a brownout — the
"retry storm turns a partial outage into a full one" postmortem shape.

Stdlib-only; clocks are injectable so the tier-1 tests step time instead
of sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding for tpu_router_breaker_state (docs/routing.md).
STATE_VALUE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """One replica's failure gate.  Thread-safe.

    ``on_transition(old, new)`` fires OUTSIDE the lock on every state
    change — the router's flight/metrics hook.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        open_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if open_s <= 0:
            raise ValueError(f"open_s must be > 0, got {open_s}")
        self.failure_threshold = failure_threshold
        self.open_s = open_s
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded by: _lock
        self._failures = 0  # consecutive, closed state only; guarded by: _lock
        self._opened_at = 0.0  # guarded by: _lock
        self._probe_in_flight = False  # guarded by: _lock

    # ---------------------------------------------------------- queries

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "probe_in_flight": self._probe_in_flight,
                "open_remaining_s": (
                    round(
                        max(0.0, self._opened_at + self.open_s - self._clock()),
                        3,
                    )
                    if self._state == OPEN
                    else 0.0
                ),
            }

    # ------------------------------------------------------- transitions

    def _transition(self, new: str) -> Optional[tuple[str, str]]:  # caller holds: _lock
        """Lock-held state change; returns (old, new) for the callback."""
        old = self._state
        if old == new:
            return None
        self._state = new
        return (old, new)

    def _notify(self, change: Optional[tuple[str, str]]) -> None:
        if change is not None and self._on_transition is not None:
            self._on_transition(*change)

    def try_acquire(self) -> bool:
        """May a dispatch go to this replica right now?  Open: no (until
        the cooldown elapses, which flips to half-open).  Half-open: yes
        for exactly ONE in-flight probe.  Closed: yes."""
        change = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.open_s:
                    return False
                change = self._transition(HALF_OPEN)
                self._probe_in_flight = True
                ok = True
            else:  # HALF_OPEN: one probe at a time
                ok = not self._probe_in_flight
                if ok:
                    self._probe_in_flight = True
        self._notify(change)
        return ok

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            change = self._transition(CLOSED)
        self._notify(change)

    def record_failure(self) -> None:
        change = None
        with self._lock:
            if self._state == HALF_OPEN:
                # Probe failed: straight back to open, fresh cooldown.
                self._probe_in_flight = False
                self._opened_at = self._clock()
                change = self._transition(OPEN)
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._opened_at = self._clock()
                    change = self._transition(OPEN)
            # OPEN: failures while open (e.g. a racing dispatch that
            # acquired before the trip) don't extend the cooldown — the
            # half-open probe owns recovery timing.
        self._notify(change)


class RetryBudget:
    """Global token bucket bounding EXTRA upstream dispatches.

    ``capacity`` tokens, refilled continuously at ``refill_per_s``.
    First attempts never touch the budget; every retry, hedge, or
    failover calls :meth:`try_spend` and backs off to single-attempt
    behavior when refused — retries must not amplify a brownout.
    """

    def __init__(
        self,
        capacity: float = 32.0,
        refill_per_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        if refill_per_s < 0:
            raise ValueError(f"refill_per_s must be >= 0, got {refill_per_s}")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = float(capacity)
        self._last = clock()
        self.spent_total = 0
        self.exhausted_total = 0

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.capacity, self._tokens + (now - self._last) * self.refill_per_s
        )
        self._last = now

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                self.spent_total += 1
                return True
            self.exhausted_total += 1
            return False

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens
