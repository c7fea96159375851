"""EWMA/z-score anomaly baselines and structured incident records.

The port's own copy of the reference's ``utils/anomaly.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The flight recorder (utils/flight.py) answers "what happened before it
went wrong" — this module decides WHEN something went wrong, without an
operator watching dashboards: each tracked metric (engine step time,
TTFT, Allocate latency, health-sweep duration) keeps an exponentially
weighted mean/variance baseline, and a SUSTAINED deviation — several
consecutive observations past a z-score threshold, not one outlier —
emits a structured **incident record**: cause metric, baseline,
observed value, z-score, plus the surrounding flight-recorder window.
Incidents go three ways at once: a bounded in-memory list served by
``GET /debug/incidents``, one structured line through the JSON logger
(the ``kubectl logs`` trail), and back into the flight recorder itself
(so a later dump shows the incident in sequence with its causes).

EWMA rather than a windowed mean: O(1) state per metric, no timestamp
bookkeeping, and the baseline adapts to slow drift (a server warming
its caches) while still flagging step changes — the standard host-side
telemetry shape (arXiv:2510.16946 §4's "lightweight online detection").
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Optional

from .flight import FlightRecorder

log = logging.getLogger("tpu.anomaly")


class EwmaBaseline:
    """Exponentially weighted mean/variance with a warmup gate.

    ``score(value)`` returns the z-score of the value against the
    current baseline WITHOUT folding it in (a spike must be scored
    against the past, never against itself), or None until ``warmup``
    samples have been absorbed.  ``update(value)`` folds a sample in;
    ``observe`` is score-then-update for callers without an
    accept/reject policy.  ``alpha`` is the usual smoothing factor
    (small = long memory); variance uses the standard EWMA recurrence
    var' = (1-a) * (var + a * delta^2).
    """

    def __init__(self, alpha: float = 0.05, warmup: int = 30):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.alpha = alpha
        self.warmup = warmup
        self.count = 0
        self.mean = 0.0
        self.var = 0.0

    def score(self, value: float) -> Optional[float]:
        if self.count < self.warmup:
            return None
        std = math.sqrt(self.var)
        # Floor the std at a fraction of the mean so a perfectly steady
        # warmup (var ~ 0) doesn't turn the first normal jitter into an
        # infinite z-score.
        floor = abs(self.mean) * 0.05 + 1e-9
        return (float(value) - self.mean) / max(std, floor)

    def update(self, value: float) -> None:
        v = float(value)
        if self.count == 0:
            self.mean = v
        else:
            delta = v - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.count += 1

    def observe(self, value: float) -> Optional[float]:
        z = self.score(value)
        self.update(value)
        return z


class AnomalyDetector:
    """One metric's sustained-deviation gate over an EWMA baseline.

    Emits (returns) an incident fragment only after ``sustain``
    CONSECUTIVE observations with z >= ``z_threshold`` (one-sided high
    by default — for latencies, fast is never an incident), then holds
    a ``cooldown_s`` refractory window so a long outage is one incident,
    not one per step.  Deviating samples never fold into the baseline
    (they must not drag it up toward themselves, or a slow leak would
    never fire); a persistent level shift therefore keeps re-firing once
    per cooldown — which is the honest report: it IS anomalous against
    all learned history.
    """

    def __init__(
        self,
        metric: str,
        *,
        alpha: float = 0.05,
        warmup: int = 30,
        z_threshold: float = 4.0,
        sustain: int = 3,
        direction: str = "high",
        cooldown_s: float = 30.0,
    ):
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        if direction not in ("high", "low", "both"):
            raise ValueError(f"direction must be high/low/both, got {direction!r}")
        self.metric = metric
        self.z_threshold = float(z_threshold)
        self.sustain = sustain
        self.direction = direction
        self.cooldown_s = float(cooldown_s)
        self.baseline = EwmaBaseline(alpha=alpha, warmup=warmup)
        self._run = 0
        self._run_peak = 0.0
        self._last_incident_t = 0.0
        self.incidents_emitted = 0

    def _deviates(self, z: float) -> bool:
        if self.direction == "high":
            return z >= self.z_threshold
        if self.direction == "low":
            return -z >= self.z_threshold
        return abs(z) >= self.z_threshold

    def observe(self, value: float, now: Optional[float] = None) -> Optional[dict]:
        """Feed one observation; returns an incident fragment (no flight
        window attached yet — the monitor does that) when the sustained
        gate trips, else None."""
        now = time.monotonic() if now is None else now
        z = self.baseline.score(value)
        if z is None or not self._deviates(z):
            # Normal (or warming) sample: learn it, break any run.
            self.baseline.update(value)
            self._run = 0
            self._run_peak = 0.0
            return None
        self._run += 1
        peak = abs(float(value))
        if self._run == 1 or peak > abs(self._run_peak):
            self._run_peak = float(value)
        if self._run < self.sustain:
            return None
        in_cooldown = now - self._last_incident_t < self.cooldown_s
        # Keep the run latched through cooldown so a continuing outage
        # re-arms the moment cooldown expires, but emit nothing now.
        self._run = self.sustain - 1 if self.sustain > 1 else 0
        if in_cooldown and self._last_incident_t > 0.0:
            return None
        self._last_incident_t = now
        self.incidents_emitted += 1
        return {
            "kind": "incident",
            "metric": self.metric,
            "observed": float(value),
            "peak": self._run_peak,
            "baseline_mean": self.baseline.mean,
            "baseline_std": math.sqrt(self.baseline.var),
            "z": round(z, 2),
            "sustained": self.sustain,
            "samples": self.baseline.count,
        }


class AnomalyMonitor:
    """A set of detectors plus the incident fan-out (ring, log, flight).

    ``observe(metric, value)`` lazily creates a default detector per
    metric; ``configure(metric, **kw)`` pre-creates one with explicit
    thresholds (what the engine/daemon wiring does).  ``snapshot()`` is
    the JSON body of ``GET /debug/incidents``.  ``on_incident`` is an
    optional callable (e.g. a Prometheus counter's ``inc``) invoked with
    the metric name per emitted incident.
    """

    def __init__(
        self,
        flight: Optional[FlightRecorder] = None,
        capacity: int = 64,
        window_events: int = 100,
        on_incident=None,
    ):
        self.flight = flight
        self.window_events = window_events
        self._on_incident = on_incident
        self._lock = threading.Lock()
        self._detectors: dict[str, AnomalyDetector] = {}
        self._incidents: deque[dict] = deque(maxlen=capacity)
        self._listeners: list = []
        self.incidents_dropped = 0
        self.incidents_total = 0

    def add_listener(self, fn) -> None:
        """Register a full-record incident listener: ``fn(incident)`` is
        called once per emitted incident with the complete record (flight
        window included), AFTER the ring/log/flight fan-out and the
        ``on_incident`` metric hook.  This is the postmortem-capture
        seam (utils/postmortem.py): a listener that does real work (file
        I/O) runs outside the monitor lock and its exceptions are
        swallowed — a broken listener must never poison detection."""
        with self._lock:
            self._listeners.append(fn)

    def configure(self, metric: str, **kwargs) -> AnomalyDetector:
        with self._lock:
            det = self._detectors.get(metric)
            if det is None:
                det = self._detectors[metric] = AnomalyDetector(metric, **kwargs)
            return det

    def recalibrate(self, metric: str) -> bool:
        """Discard one detector's learned baseline (thresholds retained);
        the next ``warmup`` observations re-learn "normal" from scratch.

        The regime-change seam: deviating samples deliberately never
        fold into the baseline, so a baseline that locked onto the wrong
        regime — startup-compile outliers, a pre-migration traffic
        shape — can never adapt on its own.  The chaos harness uses this
        after its compile warmup so injected-fault precision is measured
        against a baseline warmed on production-shaped load.  Returns
        False when the metric has no detector."""
        with self._lock:
            det = self._detectors.get(metric)
            if det is None:
                return False
            det.baseline = EwmaBaseline(
                alpha=det.baseline.alpha, warmup=det.baseline.warmup
            )
            det._run = 0
            det._run_peak = 0.0
            return True

    def observe(self, metric: str, value: float) -> Optional[dict]:
        """Feed one observation; returns the full incident record (with
        flight window) when one fires.  Thread-safe: detector state
        mutates under the monitor lock (Allocate observes from
        concurrent gRPC worker threads); the rare emission fan-out runs
        after release (it re-takes the lock for the ring)."""
        with self._lock:
            det = self._detectors.get(metric)
            if det is None:
                det = self._detectors[metric] = AnomalyDetector(metric)
            fragment = det.observe(value)
        if fragment is None:
            return None
        return self._emit(fragment)

    def report(self, metric: str, observed: float = 1.0, **fields) -> dict:
        """Directly emit one incident for a DISCRETE fault — a condition
        that is wrong on its first observation (attribution drift, an
        invariant violation), where an EWMA baseline is meaningless.
        Same fan-out as a detector-emitted incident (ring + JSON log +
        flight + ``on_incident`` hook); ``fields`` ride in the record."""
        fragment = {
            "kind": "incident",
            "metric": str(metric),
            "observed": float(observed),
            "baseline_mean": 0.0,
            "baseline_std": 0.0,
            "z": 0.0,
            "direct": True,
        }
        for key, value in fields.items():
            fragment.setdefault(key, value)
        return self._emit(fragment)

    def _emit(self, fragment: dict) -> dict:
        incident = {"ts": round(time.time(), 3), **fragment}
        # Attach the black box BEFORE appending the incident event to it,
        # so the window shows the lead-up, not the incident itself.
        if self.flight is not None:
            incident["flight_window"] = self.flight.window(
                last=self.window_events
            )
        with self._lock:
            self.incidents_total += 1
            if len(self._incidents) == self._incidents.maxlen:
                self.incidents_dropped += 1
            self._incidents.append(incident)
        if self.flight is not None:
            self.flight.record(
                "incident",
                metric=incident["metric"],
                observed=incident["observed"],
                baseline_mean=incident["baseline_mean"],
                z=incident["z"],
            )
        # One structured line through the JSON logger: the same record,
        # minus the bulky window, greppable in `kubectl logs`.
        log.warning(
            "incident: %s observed=%.6g baseline=%.6g z=%.1f",
            incident["metric"],
            incident["observed"],
            incident["baseline_mean"],
            incident["z"],
            extra={
                "event": {k: v for k, v in incident.items() if k != "flight_window"}
            },
        )
        if self._on_incident is not None:
            try:
                self._on_incident(incident["metric"])
            except Exception:
                log.exception("incident hook failed")
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(incident)
            except Exception:
                log.exception("incident listener failed")
        return incident

    def incidents(self) -> list[dict]:
        with self._lock:
            return [dict(i) for i in self._incidents]

    def snapshot(self) -> dict:
        """JSON body for ``GET /debug/incidents``: the bounded incident
        list (newest last) plus per-metric baseline state, so an
        operator can see what "normal" currently means."""
        with self._lock:
            detectors = {
                name: {
                    "mean": det.baseline.mean,
                    "std": math.sqrt(det.baseline.var),
                    "samples": det.baseline.count,
                    "warmed_up": det.baseline.count >= det.baseline.warmup,
                    "z_threshold": det.z_threshold,
                    "sustain": det.sustain,
                    "incidents": det.incidents_emitted,
                }
                for name, det in self._detectors.items()
            }
            return {
                "incidents_total": self.incidents_total,
                "incidents_dropped": self.incidents_dropped,
                "detectors": detectors,
                "incidents": [dict(i) for i in self._incidents],
            }
