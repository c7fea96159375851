"""Active correctness plane — the fleet canary prober.

The port's own copy of the reference's ``router/prober.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

Every observability layer before this one is *passive*: tracing, flight
rings, SLO burn rates all watch traffic that already happened, and none
of them can tell a replica that is **fast but wrong** from a healthy
one.  Silent data corruption on accelerators is a real fleet-scale
failure mode (Exploration of TPUs for AI Applications, PAPERS.md), and
host-side probing is the recommended way to catch it without device
counters (Host-Side Telemetry, PAPERS.md).

:class:`CanaryProber` continuously dials every replica — direct, and
optionally through the router itself — with seeded deterministic greedy
canary prompts.  Because decoding is greedy and the weights are fixed,
the token stream for a canary prompt is a *pure function of the params
fingerprint*: the oracle is captured once from the fleet's own first
clean response per ``(params_fingerprint, prompt)`` pair and every
later probe anywhere in the fleet must reproduce it **bit-exactly**.  A
redeploy with new weights shows up as a new fingerprint on the
``?summary=1`` poll and simply re-captures — no operator-maintained
golden files.

Verdicts per probe:

- ``capture``  — first clean response for this (fingerprint, prompt):
  becomes the oracle.
- ``match``    — bit-exact against the oracle (also feeds the TTFT/ITL
  probe-latency histograms).
- ``mismatch`` — wrong tokens.  One blip NEVER acts: only ``k_mismatch``
  *consecutive* mismatches fire the ``canary.mismatch`` incident and —
  policy on by default, ``fence=False`` to observe-only — auto-fence
  the replica via its existing ``POST /debug/fence`` admin endpoint, so
  the router's fenced-demotion machinery drains it with zero
  client-visible wrong tokens.
- ``stale``    — the replica answers probes but its ``requests_total``
  summary counter stopped advancing (our own probes should bump it):
  zombie telemetry, ``canary.stale`` incident, no fence.
- ``error``    — probe dial failed (the router's breaker/poll plane
  already owns liveness; the prober just records and moves on).
- ``skip_fenced`` — replica reports fenced (by us or anyone): probing
  is pointless until it is unfenced/replaced.

Through-router probes verdict the *serving path* end to end but fire no
incidents and never fence: a wrong answer through the router cannot be
attributed to a replica — attribution is the direct probes' job.

jax-free, compile-free, fake-clock injectable: the unit suite drives
:meth:`CanaryProber.probe_once` sweep by sweep against FakeReplicas
with an injected clock; production wires :meth:`start`'s daemon thread
into RouterServer (``--canary=1``).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from typing import Callable, Optional

VERDICTS = (
    "capture", "match", "mismatch", "stale", "error", "skip_fenced",
)

_CONN_ERRORS = (OSError, http.client.HTTPException, ValueError)

# Default seeded canary prompts: small fixed token ids, disjoint from
# nothing in particular — determinism, not meaning, is the point.
DEFAULT_PROMPTS = ((11, 13, 17, 19), (101, 103, 107))


@dataclasses.dataclass
class CanaryConfig:
    """Tunables for :class:`CanaryProber` (CLI: ``--canary-*``)."""

    # Seconds between sweeps (every replica probed once per sweep).
    interval_s: float = 5.0
    # New tokens per probe — tiny on purpose: the probe budget is the
    # overhead budget (bench pins it at <=1% of serving throughput).
    probe_tokens: int = 4
    # Canary prompt token lists; sweeps rotate through them so one
    # poisoned oracle can't blind the whole plane.
    prompts: tuple = DEFAULT_PROMPTS
    # Consecutive mismatches before the incident + auto-fence.  One
    # blip (a probe racing a restart, a torn read) must never fence.
    k_mismatch: int = 3
    # Consecutive sweeps with a frozen requests_total (while probes
    # land!) before the staleness incident.
    stale_sweeps: int = 5
    # Auto-fence policy: False = observe-only (incidents still fire).
    fence: bool = True
    # Per-dial timeout.
    timeout_s: float = 5.0
    # Also probe THROUGH the router (end-to-end path verdict)?
    via_router: bool = True

    def __post_init__(self):
        if self.k_mismatch < 1:
            raise ValueError("k_mismatch must be >= 1")
        if self.stale_sweeps < 2:
            raise ValueError("stale_sweeps must be >= 2")
        if self.probe_tokens < 1:
            raise ValueError("probe_tokens must be >= 1")
        if not self.prompts:
            raise ValueError("at least one canary prompt required")


class _ReplicaTrack:
    """Per-replica prober state (prober thread owns it; snapshot()
    reads under the lock)."""

    __slots__ = (
        "verdict", "mismatch_streak", "stale_streak", "last_requests",
        "probed_since_requests", "ttft_s", "itl_s", "fingerprint",
        "fenced_by_canary", "stale_reported", "probes", "mismatches",
    )

    def __init__(self):
        self.verdict = None
        self.mismatch_streak = 0
        self.stale_streak = 0
        self.last_requests = None
        self.probed_since_requests = False
        self.ttft_s = None
        self.itl_s = None
        self.fingerprint = None
        self.fenced_by_canary = False
        self.stale_reported = False
        self.probes = 0
        self.mismatches = 0


class CanaryProber:
    """Continuously verdict every replica on *correctness*, not just
    liveness.  ``targets_fn`` returns the current fleet as ``host:port``
    names (the router passes a snapshot of its replica table); the
    prober dials each directly and optionally dials ``router_url`` for
    the end-to-end path.

    Injectables: ``now`` (latency clock), ``metrics`` (RouterMetrics —
    canary families optional via getattr), ``flight``
    (FlightRecorder), ``anomaly`` (AnomalyMonitor for incidents)."""

    def __init__(
        self,
        targets_fn: Callable[[], list],
        *,
        config: Optional[CanaryConfig] = None,
        router_url: Optional[str] = None,
        metrics=None,
        flight=None,
        anomaly=None,
        now=time.monotonic,
    ):
        self.cfg = config or CanaryConfig()
        self._targets_fn = targets_fn
        self._router_url = router_url
        self._metrics = metrics
        self._flight = flight
        self._anomaly = anomaly
        self._now = now
        self._lock = threading.Lock()
        # (params_fingerprint, prompt_index) -> tuple of oracle tokens.
        # Shared across replicas on purpose: same weights, greedy
        # decode => same tokens, so replica B is verdicted against the
        # oracle replica A captured — cross-replica SDC detection.
        self._oracles: dict = {}
        self._tracks: dict[str, _ReplicaTrack] = {}
        self._router_verdict: Optional[str] = None
        self.sweeps = 0
        self.fences_fired = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ dials

    def _split(self, name: str):
        host, _, port = name.rpartition(":")
        return host, int(port)

    def _get_summary(self, name: str) -> dict:
        host, port = self._split(name)
        conn = http.client.HTTPConnection(
            host, port, timeout=self.cfg.timeout_s
        )
        try:
            conn.request("GET", "/debug/state?summary=1")
            resp = conn.getresponse()
            payload = json.loads(resp.read() or b"{}")
            if resp.status != 200:
                raise OSError(f"summary HTTP {resp.status}")
            return payload
        finally:
            conn.close()

    def _probe_dial(self, name: str, prompt) -> tuple:
        """One streamed greedy probe: returns (tokens, ttft_s, itl_s).
        Streaming on purpose — TTFT/ITL are per-probe *latency* SLIs,
        and a unary dial can't see first-token time."""
        host, port = self._split(name)
        body = json.dumps({
            "prompt": list(prompt),
            "max_new_tokens": self.cfg.probe_tokens,
            "stream": True,
        }).encode()
        conn = http.client.HTTPConnection(
            host, port, timeout=self.cfg.timeout_s
        )
        try:
            t0 = self._now()
            conn.request(
                "POST", "/generate", body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            if resp.status != 200:
                raise OSError(f"probe HTTP {resp.status}")
            tokens: list = []
            final = None
            ttft = None
            gaps: list = []
            last = t0
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue
                ev = json.loads(line[5:].strip() or b"{}")
                if ev.get("done"):
                    final = ev.get("tokens")
                    break
                if "token" in ev:
                    t = self._now()
                    if ttft is None:
                        ttft = t - t0
                    else:
                        gaps.append(t - last)
                    last = t
                    tokens.append(int(ev["token"]))
            if final is not None:
                tokens = [int(t) for t in final]
            if not tokens:
                raise OSError("probe stream ended with no tokens")
            itl = sum(gaps) / len(gaps) if gaps else 0.0
            return tokens, (ttft if ttft is not None else 0.0), itl
        finally:
            conn.close()

    def _fence_dial(self, name: str) -> bool:
        host, port = self._split(name)
        body = json.dumps({"reason": "canary-mismatch"}).encode()
        conn = http.client.HTTPConnection(
            host, port, timeout=self.cfg.timeout_s
        )
        try:
            conn.request(
                "POST", "/debug/fence", body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            resp.read()
            return resp.status == 200
        except _CONN_ERRORS:
            return False
        finally:
            conn.close()

    # ---------------------------------------------------------- verdicts

    def _record(self, kind: str, **fields) -> None:
        if self._flight is not None:
            self._flight.record(kind, **fields)

    def _count(self, name: str, verdict: str) -> None:
        m = getattr(self._metrics, "canary_probes", None)
        if m is not None:
            m.inc(replica=name, verdict=verdict)

    def _verdict_one(self, name: str, prompt_idx: int) -> str:
        """Probe one replica, return its verdict (prober thread)."""
        cfg = self.cfg
        prompt = cfg.prompts[prompt_idx]
        with self._lock:
            track = self._tracks.setdefault(name, _ReplicaTrack())

        try:
            summary = self._get_summary(name)
        except _CONN_ERRORS as e:
            return self._finish(track, name, "error", error=str(e))

        if bool(summary.get("fenced", False)):
            # Already fenced (by us, an operator, or a watchdog):
            # probing a fenced replica proves nothing — it answers 503.
            return self._finish(track, name, "skip_fenced")

        fp = summary.get("params_fingerprint")
        raw_requests = summary.get("requests_total")
        requests_total = (
            int(raw_requests) if raw_requests is not None else None
        )

        # Staleness: our OWN probes bump the engine's requests counter,
        # so a summary whose requests_total sat frozen across a sweep
        # in which we landed a probe is lying about its traffic —
        # zombie telemetry (metrics thread wedged, ring detached).
        stale_now = False
        if requests_total is not None:
            if (
                track.last_requests is not None
                and requests_total <= track.last_requests
                and track.probed_since_requests
            ):
                track.stale_streak += 1
            elif requests_total > (track.last_requests or -1):
                track.stale_streak = 0
                track.stale_reported = False
            track.last_requests = requests_total
            stale_now = track.stale_streak >= cfg.stale_sweeps

        try:
            tokens, ttft, itl = self._probe_dial(name, prompt)
        except _CONN_ERRORS as e:
            track.probed_since_requests = False
            return self._finish(track, name, "error", error=str(e))
        track.probed_since_requests = True
        track.ttft_s = ttft
        track.itl_s = itl
        h = getattr(self._metrics, "canary_probe_ttft", None)
        if h is not None:
            h.observe(ttft)
        h = getattr(self._metrics, "canary_probe_itl", None)
        if h is not None:
            h.observe(itl)

        if stale_now and not track.stale_reported:
            track.stale_reported = True
            self._record(
                "canary.stale", replica=name,
                requests_total=requests_total,
                sweeps=track.stale_streak,
            )
            if self._anomaly is not None:
                self._anomaly.report(
                    "canary.stale", observed=float(track.stale_streak),
                    replica=name,
                )
        if stale_now:
            return self._finish(track, name, "stale", fingerprint=fp)

        if fp is None:
            # Pre-contract replica (old build): nothing to key an
            # oracle by — latency histograms still fed above.
            return self._finish(track, name, "error",
                                error="no params_fingerprint")

        key = (fp, prompt_idx)
        with self._lock:
            oracle = self._oracles.get(key)
            if oracle is None:
                # First clean response for this (weights, prompt):
                # becomes the fleet-wide oracle.  A redeploy is a new
                # fingerprint, hence a fresh capture — self-refreshing.
                self._oracles[key] = tuple(tokens)
        if oracle is None:
            track.fingerprint = fp
            self._record(
                "canary.capture", replica=name, fingerprint=fp,
                prompt=prompt_idx, tokens=list(tokens),
            )
            return self._finish(track, name, "capture", fingerprint=fp)

        track.fingerprint = fp
        if tuple(tokens) == oracle:
            track.mismatch_streak = 0
            return self._finish(track, name, "match", fingerprint=fp)

        # Wrong tokens.  Count the streak; act only on K consecutive.
        track.mismatch_streak += 1
        track.mismatches += 1
        self._record(
            "canary.mismatch_observed", replica=name,
            streak=track.mismatch_streak, prompt=prompt_idx,
            got=list(tokens), want=list(oracle),
        )
        if track.mismatch_streak == cfg.k_mismatch:
            # The confirmed-SDC incident: exactly once per episode.
            self._record(
                "canary.mismatch", replica=name, fingerprint=fp,
                streak=track.mismatch_streak,
            )
            if self._anomaly is not None:
                self._anomaly.report(
                    "canary.mismatch",
                    observed=float(track.mismatch_streak),
                    replica=name,
                )
        if track.mismatch_streak >= cfg.k_mismatch and cfg.fence:
            # Auto-fence through the replica's own admin endpoint: the
            # router's summary poll sees fenced=true and demotes it
            # through the PR-10 fenced-demotion path (in-flight streams
            # fail over, new work re-routes).  Retried every sweep the
            # mismatch persists, in case admin was briefly down.
            if self._fence_dial(name):
                track.fenced_by_canary = True
                self.fences_fired += 1
                c = getattr(self._metrics, "canary_fences", None)
                if c is not None:
                    c.inc(replica=name)
                self._record("canary.fence", replica=name, fingerprint=fp)
            else:
                self._record("canary.fence_failed", replica=name)
        return self._finish(track, name, "mismatch", fingerprint=fp)

    def _finish(self, track, name: str, verdict: str, **fields) -> str:
        with self._lock:
            track.verdict = verdict
            track.probes += 1
        self._count(name, verdict)
        return verdict

    def _probe_router(self, prompt_idx: int) -> None:
        """One through-router probe: end-to-end path verdict.  Never an
        incident, never a fence — a wrong answer here cannot be pinned
        on a replica; the direct probes own attribution."""
        prompt = self.cfg.prompts[prompt_idx]
        with self._lock:
            fps = {
                t.fingerprint for t in self._tracks.values()
                if t.fingerprint is not None
            }
        try:
            tokens, ttft, itl = self._probe_dial(self._router_url, prompt)
        except _CONN_ERRORS:
            verdict = "error"
        else:
            if len(fps) != 1:
                # Mixed-fingerprint fleet mid-rollout (or nothing
                # captured yet): no single oracle to hold the router
                # path to — capture-equivalent no-op.
                verdict = "capture"
            else:
                oracle = self._oracles.get((next(iter(fps)), prompt_idx))
                if oracle is None:
                    verdict = "capture"
                elif tuple(tokens) == oracle:
                    verdict = "match"
                else:
                    verdict = "mismatch"
                    self._record(
                        "canary.router_mismatch", prompt=prompt_idx,
                        got=list(tokens), want=list(oracle),
                    )
        with self._lock:
            self._router_verdict = verdict
        self._count("router", verdict)

    # ------------------------------------------------------------ sweeps

    def probe_once(self) -> dict:
        """One full sweep: every current target direct-probed, plus the
        through-router probe.  Returns {name: verdict} (the unit-test
        driving seam — production calls this from the daemon thread)."""
        prompt_idx = self.sweeps % len(self.cfg.prompts)
        verdicts = {}
        for name in list(self._targets_fn()):
            if self._stop.is_set():
                break
            verdicts[str(name)] = self._verdict_one(str(name), prompt_idx)
        if self.cfg.via_router and self._router_url:
            self._probe_router(prompt_idx)
        self.sweeps += 1
        return verdicts

    def snapshot(self) -> dict:
        """The ``GET /debug/canary`` body (any thread)."""
        with self._lock:
            replicas = {
                name: {
                    "verdict": t.verdict,
                    "mismatch_streak": t.mismatch_streak,
                    "stale_streak": t.stale_streak,
                    "probes": t.probes,
                    "mismatches": t.mismatches,
                    "ttft_s": t.ttft_s,
                    "itl_s": t.itl_s,
                    "params_fingerprint": t.fingerprint,
                    "fenced_by_canary": t.fenced_by_canary,
                }
                for name, t in self._tracks.items()
            }
            oracles = [
                {"params_fingerprint": fp, "prompt": idx, "tokens": list(v)}
                for (fp, idx), v in self._oracles.items()
            ]
            router_verdict = self._router_verdict
        return {
            "sweeps": self.sweeps,
            "fences_fired": self.fences_fired,
            "router_verdict": router_verdict,
            "oracles": oracles,
            "replicas": replicas,
            "config": {
                "interval_s": self.cfg.interval_s,
                "probe_tokens": self.cfg.probe_tokens,
                "prompts": [list(p) for p in self.cfg.prompts],
                "k_mismatch": self.cfg.k_mismatch,
                "stale_sweeps": self.cfg.stale_sweeps,
                "fence": self.cfg.fence,
                "via_router": bool(
                    self.cfg.via_router and self._router_url
                ),
            },
        }

    # --------------------------------------------------------- lifecycle

    def start(self) -> "CanaryProber":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="canary-prober", daemon=True
        )
        self._thread.start()
        self._record("canary.started", interval_s=self.cfg.interval_s)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.probe_once()
            except Exception as e:  # pragma: no cover - belt and braces
                self._record("canary.sweep_error", error=str(e))

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self._record("canary.stopped", sweeps=self.sweeps)
