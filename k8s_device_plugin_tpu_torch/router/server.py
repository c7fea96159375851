"""The router daemon: a fault-tolerant prefix-affinity /generate proxy.

The port's own copy of the reference's ``router/server.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

One process fronts K serving replicas (models/http_server.EngineServer)
and owns everything between "client sent a prompt" and "a replica's
engine decoded it":

- **Placement** — `RoutingPolicy` (prefix-affinity consistent hashing +
  queue-depth overflow over poll state from ``/debug/state?summary=1``).
- **Failure containment** — per-replica `CircuitBreaker`s gate every
  dial; a global `RetryBudget` bounds extra dispatches; retries use
  exponential backoff with full jitter and honor ``Retry-After``.
- **Hedging** (unary, opt-in) — when a response hasn't arrived within
  the rolling TTFT p99, a second dispatch races the first along the
  ring; first response wins, the loser's connection is closed.
- **Mid-stream failover** — a streaming request whose replica dies
  mid-decode is transparently resubmitted to the next ring replica as
  ``prompt + already-emitted tokens`` with the remaining budget, under
  the SAME request id (idempotent: the resubmission carries the emitted
  tokens in its prompt, so nothing can double-emit).  On the failover
  replica the content-addressed KV restore (models/engine_kvcache.py)
  turns the re-prefill into a page restore when the prefix is warm.
  The client sees one uninterrupted token stream — zero-drop is the
  contract the chaos suite scores (docs/chaos.md).
- **Drain awareness** — a replica answering 503/draining (or whose
  summary poll says so) takes no NEW assignments immediately, while its
  in-flight proxied streams run to completion; ``Retry-After`` feeds
  the backoff when nothing else is dialable.  A 503 carrying ``X-Shed``
  is overload, not drain: the replica stays in rotation and only this
  request moves on (still flooring its backoff on ``Retry-After``).
- **Deadline propagation** — a client ``X-Request-Deadline`` (remaining
  seconds; body ``deadline_s``) bounds the whole attempt budget: every
  upstream dial re-stamps the REMAINING budget, retry sleeps and hedges
  spend only when the budget still allows an answer, and a deadline no
  replica's queue forecast can meet fails fast with 504 — never
  enqueued anywhere.  ``X-Request-Priority``/``X-Tenant-Id`` fold into
  the upstream body for the engine's priority admission.

- **Planned migration** (``--migrate``) — the proactive
  cousin of failover: a `MigrationPlanner` (router/migration.py) watches
  the host-side queue-wait EWMA / drain-rate signals each summary poll
  already carries, and when a replica runs sustained-hot while a peer
  runs cold, live streams of its hottest prefix-block sessions are
  resubmitted to the cold target through the SAME zero-drop machinery —
  paced by a migration budget, only at paced token boundaries (never
  mid-token-burst), aborted if the target's breaker refuses.

Surfaces: ``POST /generate`` (unary + SSE passthrough), ``GET /healthz``
(503 until a replica is reachable; ``draining`` during shutdown),
``GET /metrics`` (Prometheus), ``GET /debug/router`` (full snapshot),
``GET /debug/fleet`` (per-replica host-side signals + migration planner
state + the scale-up/down recommendation ``tools/fleet_plan.py``
renders), ``GET /debug/slo`` (fleet error budgets + burn-rate alerts
merged from the per-replica SLI counters every summary poll carries),
``GET /debug/fabric`` (the fleet KV fabric's locator views and
replication ledger — router/fabric.py),
``GET /debug/spans`` (the router's request-span ring;
``?rid=`` filters one trace).  Every fault-handling decision is a
flight event (``router.*``, per-request ones carrying ``rid``) so a
chaos run can join injected replica kills against what the router saw.

Distributed tracing: the router records its own span tree
per request — a ``router.request`` root, ``router.route`` selection
children, and one ``router.attempt`` child per upstream leg — and
stamps each leg's span id into the dial's ``X-Trace-Context`` header
(utils/spans.py hop context), so the replica's span tree roots under
exactly the leg that carried it.  ``tools/trace_assemble.py`` joins the
rings into one per-request fleet timeline; the chaos kill scenario
scores that assembly's completeness.

Chaos seam: each upstream dial fires the ``router.replica_conn``
failpoint scoped per replica (``router.replica_conn.<host:port>``) —
error/delay/hang inject dial-level faults without touching sockets.

Stdlib + utils only; jax is never imported here.
"""

from __future__ import annotations

import json
import queue as queue_mod
import random
import socket
import tempfile
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import http.client

from ..utils import failpoints
from ..utils.metrics import MetricsRegistry, write_exposition
from ..utils.slo import SLOTracker
from ..utils.spans import (
    TRACE_CONTEXT_HEADER,
    SpanRecorder,
    format_trace_context,
    sanitize_trace_id,
)
from ..models.handoff_wire import (
    FABRIC_RESIDENT_ONLY_HEADER,
    HANDOFF_LOCAL,
    HANDOFF_SOURCE_HEADER,
    PREFILL_NEEDED_HEADER,
)
from .breaker import STATE_VALUE, CircuitBreaker, RetryBudget
from .disagg import NO_POOL, ROLE_PREFILL, SPLIT, DisaggConfig, DisaggPolicy, pick_prefill
from .fabric import (
    VERDICT_HIT,
    VERDICT_MISS,
    VERDICT_RESIDENT,
    VERDICT_SKIP,
    FabricConfig,
    FabricLocator,
    FabricReplicator,
)
from .migration import (
    MigrationConfig,
    MigrationPlanner,
    replica_pressure,
    scale_recommendation,
)
from .policy import FAILOVER, MIGRATION, ReplicaState, RoutingPolicy
from .prober import CanaryConfig, CanaryProber
from .ring import HashRing

FAILPOINT_CONN = "router.replica_conn"

# Upstream transport failures: everything that means "this replica did
# not answer", as opposed to "this replica answered badly".
_CONN_ERRORS = (OSError, http.client.HTTPException)


class RouterMetrics:
    """The router's Prometheus families (linted live in tier-1)."""

    def __init__(self, registry: MetricsRegistry):
        self.requests = registry.counter(
            "tpu_router_requests_total",
            "Client requests by outcome (ok/error/rejected/timeout/"
            "deadline — deadline = the client's X-Request-Deadline "
            "expired or could not be met, answered 504 without "
            "enqueueing)",
            ("outcome",),
        )
        self.placements = registry.counter(
            "tpu_router_placements_total",
            "Dispatches by placement decision (home/overflow/random/"
            "failover/migration)",
            ("placement",),
        )
        self.migrations = registry.counter(
            "tpu_router_migrations_total",
            "Planned session migrations by outcome (planned: stream "
            "flagged to move off a sustained-hot replica; done: the "
            "move landed on its target; aborted: target "
            "breaker/eligibility or dial refused — the stream stays "
            "put or falls back to ordinary failover)",
            ("outcome",),
        )
        self.retries = registry.counter(
            "tpu_router_retries_total",
            "Upstream re-dispatches after a failed attempt",
        )
        self.disagg_splits = registry.counter(
            "tpu_router_disagg_splits_total",
            "Disaggregation verdicts per request (router/disagg.py): "
            "split = long prompt stamped with an X-Handoff-Source "
            "prefill locator; short = below the (pressure-scaled) "
            "prompt-length threshold, unified dispatch; no_pool = "
            "split-worthy but no healthy prefill replica — degraded to "
            "unified dispatch",
            ("verdict",),
        )
        self.disagg_refusals = registry.counter(
            "tpu_router_disagg_refusals_total",
            "Decode-replica 409 + X-Prefill-Needed refusals observed "
            "on dispatch (the prompt's prefix was not resident and no "
            "locator rode the dial — a misclassified split or a "
            "decode-only fleet without --disagg); the replica is "
            "skipped, not tripped",
        )
        self.failovers = registry.counter(
            "tpu_router_failovers_total",
            "Mid-stream failovers (stream resubmitted to another replica)",
        )
        self.hedges = registry.counter(
            "tpu_router_hedges_total",
            "Hedged dispatches by result (won/lost)",
            ("result",),
        )
        self.breaker_transitions = registry.counter(
            "tpu_router_breaker_transitions_total",
            "Circuit breaker transitions by destination state",
            ("state",),
        )
        self.replica_up = registry.gauge(
            "tpu_router_replica_up",
            "1 when the replica's summary poll succeeds, else 0",
            ("replica",),
        )
        self.replica_queue_depth = registry.gauge(
            "tpu_router_replica_queue_depth",
            "Replica engine queue depth from the last summary poll",
            ("replica",),
        )
        self.replica_draining = registry.gauge(
            "tpu_router_replica_draining",
            "1 while the replica reports draining (no new assignments)",
            ("replica",),
        )
        self.replica_fenced = registry.gauge(
            "tpu_router_replica_fenced",
            "1 while the replica reports fenced (self-fenced on a hung "
            "step / sick chip / operator fence: no new assignments, "
            "in-flight streams fail over)",
            ("replica",),
        )
        self.breaker_state = registry.gauge(
            "tpu_router_breaker_state",
            "Breaker state per replica (0 closed, 1 open, 2 half-open)",
            ("replica",),
        )
        self.retry_budget = registry.gauge(
            "tpu_router_retry_budget",
            "Retry-budget tokens currently available",
        )
        self.ttft_seconds = registry.histogram(
            "tpu_router_ttft_seconds",
            "Client-observed time to first token through the router",
        )
        self.request_seconds = registry.histogram(
            "tpu_router_request_seconds",
            "Client-observed total request latency through the router",
        )
        self.poll_seconds = registry.histogram(
            "tpu_router_poll_seconds",
            "Per-replica summary poll latency",
        )
        # Fleet SLO plane (utils/slo.py, --slo): burn rates over the
        # fleet-merged SLI deltas every summary poll carries, and the
        # alert transitions the multi-window rules fired.  Objective and
        # window are closed label sets (3 objectives x 3 windows), never
        # per-replica or per-tenant.
        self.slo_burn_rate = registry.gauge(
            "tpu_slo_burn_rate",
            "Fleet error-budget burn rate per objective and sliding "
            "window (1.0 = spending exactly the whole budget over the "
            "objective period; the fast-burn page rule fires at 14.4)",
            ("objective", "window"),
        )
        self.slo_burn_alerts = registry.counter(
            "tpu_router_slo_burn_alerts_total",
            "Multi-window burn-rate alerts FIRED per objective and "
            "severity (page: fast burn; ticket: slow burn) — "
            "clears are flight events, not counted here",
            ("objective", "severity"),
        )
        # Active correctness plane (router/prober.py, --canary): the
        # canary prober's verdict counters and probe-latency
        # histograms.  Verdict is a closed set (prober.VERDICTS plus
        # the synthetic "router" replica for the end-to-end path).
        self.canary_probes = registry.counter(
            "tpu_router_canary_probes_total",
            "Canary probe verdicts per replica (capture: oracle "
            "learned; match: bit-exact; mismatch: wrong tokens — K "
            "consecutive fires canary.mismatch + auto-fence; stale: "
            "summary counters frozen while probes land; error: dial "
            "failed; skip_fenced: replica already fenced).  The "
            "synthetic replica \"router\" is the through-router "
            "end-to-end probe",
            ("replica", "verdict"),
        )
        self.canary_fences = registry.counter(
            "tpu_router_canary_fences_total",
            "Auto-fences fired by the canary prober after K "
            "consecutive bit-exactness mismatches (POST /debug/fence "
            "accepted by the replica)",
            ("replica",),
        )
        self.canary_probe_ttft = registry.histogram(
            "tpu_router_canary_probe_ttft_seconds",
            "Canary probe time-to-first-token (direct replica dials; "
            "the active-probing latency SLI, unlabeled on purpose — "
            "per-replica attribution lives in /debug/canary)",
        )
        self.canary_probe_itl = registry.histogram(
            "tpu_router_canary_probe_itl_seconds",
            "Canary probe mean inter-token latency (direct replica "
            "dials)",
        )
        # Fleet KV fabric (router/fabric.py, --fabric): the locator's
        # per-dial resolution verdicts (closed set: hit/resident/miss/
        # skip), the replication plane's pull/drop outcomes (ok/error),
        # and each replica's advertised digest size off the poll.
        self.fabric_resolutions = registry.counter(
            "tpu_router_fabric_resolutions_total",
            "Fabric locator resolutions per upstream dial (hit: a "
            "better owner than the target was stamped as "
            "X-Handoff-Source; resident: the target already advertises "
            "the prompt's prefix; miss: nobody in the fleet advertises "
            "it; skip: adapter prompt — engine-local trie roots the "
            "router cannot address)",
            ("verdict",),
        )
        self.fabric_replications = registry.counter(
            "tpu_router_fabric_replications_total",
            "K-replica hot-prefix replication pulls fired at engines "
            "(POST /debug/fabric/pull) by outcome — an error admits "
            "nothing on the target and self-heals out of the ledger",
            ("outcome",),
        )
        self.fabric_drops = registry.counter(
            "tpu_router_fabric_drops_total",
            "Cold-prefix eviction drops fired at engines "
            "(POST /debug/fabric/drop) by outcome; only router-created "
            "copies are ever dropped, never a traffic-warmed origin",
            ("outcome",),
        )
        self.fabric_advertised_roots = registry.gauge(
            "tpu_router_fabric_advertised_roots",
            "Prefix roots each replica's fabric digest advertised on "
            "its last summary poll (0 = no digest: handoff off, arena "
            "off, or an unparseable advertisement)",
            ("replica",),
        )

    def drop_replica(self, name: str) -> None:
        for gauge in (
            self.replica_up,
            self.replica_queue_depth,
            self.replica_draining,
            self.replica_fenced,
            self.breaker_state,
            self.fabric_advertised_roots,
        ):
            gauge.remove(replica=name)


class _Rolling:
    """Bounded rolling sample for the hedge threshold (TTFT p99): a
    deque of the last N observations, quantile by sort — N is small
    (256), so the sort is nanoseconds next to a network dial."""

    def __init__(self, capacity: int = 256):
        self._values: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._values:
                return None
            ordered = sorted(self._values)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[idx]


class _ReqTrace:
    """Per-request span bookkeeping threaded through the proxy paths.

    The root span id is reserved at arrival (recorded when the request
    resolves — the engine's cross-thread pattern); every upstream leg —
    first attempt, retry, hedge leg, failover resubmission — draws a
    DISTINCT (attempt index, span id) pair through :meth:`begin_attempt`
    (hedge legs run on spawned threads, hence the lock), and that pair
    rides the dial's ``X-Trace-Context`` header so the replica's span
    tree roots under exactly the leg that carried it."""

    __slots__ = ("rec", "trace_id", "root", "t0", "attrs", "_lock",
                 "n_attempts")

    # The router→replica dial is hop 1 of the request's journey
    # (client→router is hop 0 and needs no header: the router IS the
    # entry point).
    HOP = 1

    def __init__(self, rec: SpanRecorder, trace_id: str):
        self.rec = rec
        self.trace_id = trace_id
        self.root = rec.reserve_id()
        self.t0 = time.monotonic()
        self.attrs: dict = {}
        self._lock = threading.Lock()
        self.n_attempts = 0

    def begin_attempt(self) -> tuple[int, int]:
        """(attempt index, reserved span id) for one upstream leg."""
        with self._lock:
            idx = self.n_attempts
            self.n_attempts += 1
        return idx, self.rec.reserve_id()

    def header(self, span_id: int, attempt: int) -> str:
        return format_trace_context(
            self.trace_id, span_id, self.HOP, attempt
        )

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _StreamCtl:
    """One live proxied stream's migration handle (rid-keyed registry).

    ``migrate_to`` is written by :meth:`RouterServer.plan_migration`
    (under the streams lock) and read/cleared by the stream's own relay
    thread at token-event boundaries — plain attribute store/load
    (GIL-atomic); a one-event-stale read is by design.  ``replica`` /
    ``emitted`` are relay-thread-only bookkeeping the planner reads
    racily to rank candidates.  ``prefix_tokens`` is the prompt's
    leading affinity-horizon slice, immutable after registration — the
    fabric replicator's hot-prefix census groups live streams by it
    (the same content addressing the engines' arenas key on)."""

    __slots__ = ("rid", "prefix_key", "prefix_tokens", "replica",
                 "emitted", "migrate_to")

    def __init__(self, rid: str, prefix_key: int, prefix_tokens=()):
        self.rid = rid
        self.prefix_key = prefix_key
        self.prefix_tokens = tuple(prefix_tokens)
        self.replica = ""
        self.emitted = 0
        self.migrate_to: Optional[str] = None


class _Upstream:
    """One dialed upstream attempt: the connection (closable for
    cancel/cleanup) and its response."""

    __slots__ = ("name", "conn", "resp")

    def __init__(self, name, conn, resp):
        self.name = name
        self.conn = conn
        self.resp = resp

    def close(self) -> None:
        try:
            self.conn.close()
        except Exception:  # codelint: ignore[naked-except] best-effort close of a possibly-dead socket; per-close logs would drown failover
            pass


class RouterServer:
    """Threaded HTTP proxy over K serving replicas.  ``port=0`` picks a
    free port (tests); ``.port`` reports it.  ``replicas`` are
    ``"host:port"`` strings (also the ring node names and the `replica`
    metric label values)."""

    def __init__(
        self,
        replicas: list[str],
        host: str = "0.0.0.0",
        port: int = 8100,
        registry: Optional[MetricsRegistry] = None,
        flight=None,
        spans: Optional[SpanRecorder] = None,
        *,
        prefix_block_tokens: int = 16,
        prefix_max_blocks: int = 4,
        vnodes: int = 64,
        poll_interval_s: float = 1.0,
        poll_timeout_s: float = 2.0,
        overflow_depth: int = 4,
        breaker_failures: int = 3,
        breaker_open_s: float = 5.0,
        retry_budget: float = 32.0,
        retry_refill_per_s: float = 2.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        hedge: bool = True,
        hedge_min_s: float = 0.25,
        max_failovers: int = 3,
        request_timeout_s: float = 600.0,
        upstream_timeout_s: float = 30.0,
        policy_mode: str = "affinity",
        seed: int = 0,
        replicas_dns: Optional[str] = None,
        racecheck: bool = False,
        migrate: bool = False,
        migration: Optional[MigrationConfig] = None,
        migration_burst_gap_s: float = 0.005,
        disagg: bool = False,
        disagg_config: Optional[DisaggConfig] = None,
        prefill_replicas: Optional[list[str]] = None,
        slo: bool = False,
        canary: bool = False,
        canary_config: Optional[CanaryConfig] = None,
        fabric: bool = False,
        fabric_config: Optional[FabricConfig] = None,
        postmortem: bool = False,
        postmortem_dir: Optional[str] = None,
        postmortem_plugin_url: Optional[str] = None,
        postmortem_controller_url: Optional[str] = None,
        postmortem_debounce_s: float = 120.0,
        postmortem_budget_bytes: Optional[int] = None,
        postmortem_admin: bool = True,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics = RouterMetrics(self.registry)
        self.flight = flight
        # Router-side request spans (utils/spans.py, always on — the
        # recorder is a lock + deque append per span): route selection,
        # per-attempt dial/TTFB, SSE relay, failover.  Served at
        # GET /debug/spans and embedded in SIGUSR2/atexit flight dumps;
        # tools/trace_assemble.py joins these against the replicas'
        # rings into one fleet timeline per request.
        self.spans = spans if spans is not None else SpanRecorder(
            capacity=2048, name="router"
        )
        # Ring/replica-set membership AND the license to touch replica
        # poll state off the poll thread (see _poll_guard below).
        # Reentrant so OwnerGuard's _is_owned introspection works.
        self._lock = threading.RLock()
        # Poll-state owner discipline (utils/racecheck.py): the poll
        # thread owns ReplicaState's poll-derived fields (reachable /
        # queue_depth / active_slots / draining / fenced / last_poll —
        # annotated `guarded by: owner-thread` in policy.py) off-lock;
        # request/stream threads marking a replica draining or fenced on
        # the failover path must hold self._lock, which serializes them
        # against the owner without stealing ownership
        # (steal_on_lock=False — a transient request thread becoming
        # owner would false-trip the long-lived poll loop).  Opt-in like
        # the engine's racecheck: the contract is free in production,
        # CHECKED in the suites that run with racecheck=True.
        self._poll_guard = None
        if racecheck:
            from ..utils.racecheck import OwnerGuard

            self._poll_guard = OwnerGuard(
                lock=self._lock, name="replica_poll", steal_on_lock=False
            )
        self._stop = threading.Event()
        self._first_poll = threading.Event()
        self._draining = threading.Event()
        self.drained = threading.Event()
        self._active = 0  # in-flight client requests (drain watches this)
        self._active_lock = threading.Lock()
        self.ring = HashRing(vnodes=vnodes)
        self.replicas: dict[str, ReplicaState] = {}
        self.budget = RetryBudget(retry_budget, retry_refill_per_s)
        self._backoff_base = backoff_base_s
        self._backoff_max = backoff_max_s
        self._hedge = hedge
        self._hedge_min_s = hedge_min_s
        self._max_failovers = max_failovers
        self._timeout = request_timeout_s
        self._upstream_timeout = upstream_timeout_s
        self._poll_interval = poll_interval_s
        self._poll_timeout = poll_timeout_s
        self._breaker_failures = breaker_failures
        self._breaker_open_s = breaker_open_s
        self._ttft_rolling = _Rolling()
        self._rng = random.Random(seed)
        self._dns = replicas_dns
        # Proactive planned migration (router/migration.py; library
        # default OFF like the engine's overload controller — the CLI
        # arms it).  The planner runs on the poll thread; live streams
        # register a _StreamCtl here so a plan can flag them to move.
        self.planner = (
            MigrationPlanner(migration) if migrate else None
        )
        self._migration_burst_gap = migration_burst_gap_s
        self._streams: dict[str, _StreamCtl] = {}  # guarded by: _streams_lock
        self._streams_lock = threading.Lock()
        self.policy = RoutingPolicy(
            self.ring,
            self.replicas,
            overflow_depth=overflow_depth,
            prefix_block_tokens=prefix_block_tokens,
            prefix_max_blocks=prefix_max_blocks,
            mode=policy_mode,
            seed=seed,
        )
        # Fleet SLO plane (utils/slo.py; library default OFF like
        # migration — the CLI arms it).  Every summary poll carries each
        # replica's cumulative per-objective [good, total] SLI counters;
        # the poll thread deltas them into this fleet-level tracker and
        # evaluates the multi-window burn-rate rules once per sweep.
        # Alert transitions fan out three ways: slo.burn_alert flight
        # events, direct incidents (the AnomalyMonitor below — the
        # router's first; served at nothing yet, rides flight dumps and
        # the on_incident log), and tpu_slo_burn_rate gauges.  Owner
        # discipline: the tracker and the per-replica baselines are poll
        # state, mutated only on the poll thread.
        self.slo = SLOTracker() if slo else None
        self.slo_anomaly = None
        self.canary_anomaly = None
        if slo:
            from ..utils.anomaly import AnomalyMonitor

            self.slo_anomaly = AnomalyMonitor(flight=flight)
        # Disaggregated prefill/decode split (router/disagg.py; library
        # default OFF like migration — the CLI arms it).  Roles are
        # discovered from each replica's summary poll; --prefill-replicas
        # names replicas that are prefill-role from the start (they are
        # polled like any other but never join the /generate ring).
        self.disagg = (
            DisaggPolicy(disagg_config) if disagg else None
        )
        # Fleet KV fabric (router/fabric.py; library default OFF like
        # migration/disagg — the CLI arms it).  The locator holds each
        # replica's bloom digest off the summary poll; the replicator
        # is poll-thread-owned planning state (MigrationPlanner
        # discipline).  Resolution counters are racy plain ints, the
        # dispatches/failures idiom.
        self.fabric_cfg = fabric_config or FabricConfig()
        self.fabric = (
            FabricLocator(self.fabric_cfg.default_page_size)
            if fabric
            else None
        )
        self.replicator = FabricReplicator(self.fabric_cfg) if fabric else None
        self._fabric_inflight: set = set()  # guarded by: _lock
        self._fabric_resolutions = 0
        self._fabric_hits = 0
        # Statically configured prefill replicas survive DNS
        # reconciliation (they are not in the headless Service's
        # records).
        self._static_prefill = set(prefill_replicas or ())
        for name in replicas:
            self.add_replica(name)
        for name in self._static_prefill:
            self.add_replica(name, role=ROLE_PREFILL)

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                post_path = self.path.split("?")[0]
                if post_path == "/debug/postmortem/capture":
                    # Admin-gated manual capture: an operator forcing a
                    # fleet bundle NOW (synchronous, no debounce) — the
                    # "grab everything before I restart it" button.
                    if server.postmortem is None:
                        self._reply(
                            404,
                            {"error": "postmortem collector off "
                             "(--postmortem)"},
                        )
                        return
                    if not server.postmortem.admin:
                        self._reply(
                            403,
                            {"error": "postmortem admin capture "
                             "disabled (--postmortem-admin)"},
                        )
                        return
                    try:
                        length = int(
                            self.headers.get("Content-Length", "0")
                        )
                        body = json.loads(
                            self.rfile.read(length) or b"{}"
                        )
                    except ValueError:
                        body = {}
                    incident_id = str(
                        body.get("incident_id") or "manual"
                    )
                    bundle = server.postmortem.capture_now(
                        incident_id, trigger="manual"
                    )
                    self._reply(
                        200,
                        {
                            "captured": bundle is not None,
                            "bundle": bundle,
                            "error": (
                                None
                                if bundle is not None
                                else server.postmortem.last_error
                            ),
                        },
                    )
                    return
                if post_path != "/generate":
                    self.send_error(404)
                    return
                trace_id = sanitize_trace_id(self.headers.get("X-Request-Id"))
                if server._draining.is_set():
                    self._reply(
                        503,
                        {"error": "router is draining", "trace_id": trace_id},
                        trace_id,
                        retry_after="1",
                    )
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    prompt = list(body["prompt"])
                    if not prompt:
                        raise ValueError("empty prompt")
                    # Overload contract: the client's deadline/priority/
                    # tenant arrive as headers or body fields; the
                    # router folds headers INTO the body (replicas read
                    # both, but the re-stamped deadline always rides the
                    # header — see _dial).
                    raw_deadline = self.headers.get("X-Request-Deadline")
                    if raw_deadline is None:
                        raw_deadline = body.pop("deadline_s", None)
                    else:
                        body.pop("deadline_s", None)
                    deadline_s = (
                        None if raw_deadline is None else float(raw_deadline)
                    )
                    priority = self.headers.get("X-Request-Priority")
                    if priority is not None:
                        body["priority"] = priority
                    tenant = self.headers.get("X-Tenant-Id")
                    if tenant is not None:
                        body["tenant"] = tenant
                except (KeyError, TypeError, ValueError) as e:
                    server.metrics.requests.inc(outcome="rejected")
                    self._reply(
                        400, {"error": f"bad request: {e}"}, trace_id
                    )
                    return
                if deadline_s is not None and deadline_s <= 0:
                    # Fail fast, never dial: a spent deadline cannot be
                    # served by ANY replica — 504 without spending a
                    # connection, a retry token, or a queue entry.
                    server.metrics.requests.inc(outcome="deadline")
                    server._record(
                        "router.deadline_exceeded",
                        where="arrival",
                        deadline_s=deadline_s,
                    )
                    self._reply(
                        504,
                        {
                            "error": "deadline expired before routing",
                            "trace_id": trace_id,
                        },
                        trace_id,
                    )
                    return
                # Disaggregation verdict (router/disagg.py): a long
                # prompt gets a prefill-pool locator stamped on every
                # upstream dial (failover legs included — the next
                # decode replica can pull the same prefix); everything
                # else rides the unified path byte-for-byte.
                handoff_source = None
                if server.disagg is not None:
                    verdict, handoff_source = server._classify_disagg(
                        prompt
                    )
                    server.metrics.disagg_splits.inc(verdict=verdict)
                    if verdict == SPLIT:
                        server._record(
                            "router.disagg_split",
                            rid=trace_id,
                            source=handoff_source,
                            prompt_tokens=len(prompt),
                        )
                with server._active_lock:
                    server._active += 1
                # Root span reserved NOW; attempt legs parent on it and
                # the finally records it with the request's outcome —
                # the router half of the fleet timeline.
                tr = _ReqTrace(server.spans, trace_id)
                tr.set(stream=bool(body.get("stream")))
                if handoff_source is not None:
                    tr.set(handoff_source=handoff_source)
                try:
                    if body.get("stream"):
                        server._proxy_stream(
                            self, body, prompt, trace_id, deadline_s, tr,
                            handoff=handoff_source,
                        )
                    else:
                        server._proxy_unary(
                            self, body, prompt, trace_id, deadline_s, tr,
                            handoff=handoff_source,
                        )
                finally:
                    with server._active_lock:
                        server._active -= 1
                    tr.set(attempts=tr.n_attempts)
                    server.spans.record_span(
                        "router.request",
                        trace_id,
                        start_monotonic=tr.t0,
                        span_id=tr.root,
                        attrs=tr.attrs,
                    )

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0]
                if path == "/healthz":
                    if server._draining.is_set():
                        self._reply(503, {"status": "draining"})
                        return
                    reachable = sum(
                        1 for s in server.replicas.values() if s.reachable
                    )
                    ok = reachable > 0 and not server._stop.is_set()
                    self._reply(
                        200 if ok else 503,
                        {
                            "status": "ok" if ok else "no reachable replicas",
                            "replicas": len(server.replicas),
                            "reachable": reachable,
                        },
                    )
                elif path == "/metrics":
                    server.metrics.retry_budget.set(server.budget.available())
                    write_exposition(self, server.registry)
                elif path == "/debug/router":
                    self._reply(200, server.snapshot())
                elif path == "/debug/fleet":
                    # Elastic-fleet surface: per-replica host-side
                    # signals, migration planner state, and the
                    # scale-up/down recommendation (tools/fleet_plan.py
                    # renders this; a warm-joining replica reads the
                    # membership keys to pick its snapshot donor).
                    self._reply(200, server.fleet_state())
                elif path == "/debug/slo":
                    # Fleet SLO view (utils/slo.py): the burn rates and
                    # error budgets over the poll-merged SLI deltas,
                    # plus each replica's own cumulative counters — a
                    # single-replica fleet's totals here match that
                    # replica's /debug/slo exactly.
                    self._reply(200, server.slo_state())
                elif path == "/debug/fabric":
                    # Fleet KV fabric (router/fabric.py): per-replica
                    # digest views, locator resolution counters, and
                    # the replication ledger.
                    self._reply(200, server.fabric_state())
                elif path == "/debug/canary":
                    # Active correctness plane (router/prober.py):
                    # per-replica probe verdicts, mismatch streaks,
                    # captured oracles, and fences fired.
                    if server.prober is None:
                        self._reply(
                            404, {"error": "canary prober off (--canary)"}
                        )
                    else:
                        self._reply(200, server.prober.snapshot())
                elif path == "/debug/postmortem":
                    # Fleet postmortem collector (router/postmortem.py):
                    # capture/skip counters and the bundle ledger —
                    # where an operator finds what evidence exists for
                    # tools/postmortem.py to classify.
                    if server.postmortem is None:
                        self._reply(
                            404,
                            {"error": "postmortem collector off "
                             "(--postmortem)"},
                        )
                    else:
                        self._reply(200, server.postmortem.snapshot())
                elif path == "/debug/spans":
                    # ?rid=<trace id>: one request's tree only — the
                    # trace assembler's live mode pulls per-request,
                    # not whole rings.
                    query = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    rid = (query.get("rid") or [None])[0]
                    self._reply(200, server.spans.dump(trace_id=rid))
                else:
                    self.send_error(404)

            def _reply(
                self,
                code: int,
                obj: dict,
                trace_id: Optional[str] = None,
                retry_after: Optional[str] = None,
            ) -> None:
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if trace_id:
                    self.send_header("X-Request-Id", trace_id)
                if retry_after:
                    self.send_header("Retry-After", retry_after)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                try:
                    self.wfile.write(payload)
                except OSError:
                    pass  # client vanished; nothing upstream to cancel

            def log_message(self, *args):  # quiet under load
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        # Active correctness plane (router/prober.py; library default
        # OFF like migration/slo — the CLI arms it).  Built after the
        # HTTP server so the through-router probes can dial our own
        # bound port.  The prober runs its own thread and never touches
        # poll state: it reads each replica's summary itself and acts
        # only through the replica's public /debug/fence endpoint — the
        # poll loop then notices fenced=true and demotes normally.
        self.prober: Optional[CanaryProber] = None
        if canary:
            from ..utils.anomaly import AnomalyMonitor

            self.canary_anomaly = AnomalyMonitor(flight=flight)
            self.prober = CanaryProber(
                lambda: list(self.replicas.keys()),
                config=canary_config,
                router_url=f"127.0.0.1:{self.port}",
                metrics=self.metrics,
                flight=flight,
                anomaly=self.canary_anomaly,
            )
        # Fleet postmortem collector (router/postmortem.py; library
        # default OFF like migration/canary — the CLI arms it).  Two
        # trigger paths: the summary poll's incidents_total cursor
        # (any replica's incident), and the router's OWN monitors (SLO
        # burn alerts, canary mismatches) via the full-record listener
        # seam.  Capture runs on its own worker thread — never the poll
        # thread.
        self.postmortem = None
        if postmortem:
            from ..utils.flight import default_dump_dir
            from .postmortem import FleetPostmortem

            directory = (
                postmortem_dir
                or default_dump_dir()
                or tempfile.gettempdir()
            )

            def _local_state():
                return {
                    "component": "router",
                    "flight": (
                        self.flight.snapshot()
                        if self.flight is not None
                        else None
                    ),
                    "spans": self.spans.dump(),
                    "state": self.snapshot(),
                    "metrics": self.registry.render(),
                }

            self.postmortem = FleetPostmortem(
                directory,
                lambda: list(self.replicas.keys()),
                local_fn=_local_state,
                plugin_url=postmortem_plugin_url,
                controller_url=postmortem_controller_url,
                flight=flight,
                registry=self.registry,
                debounce_s=postmortem_debounce_s,
                budget_bytes=postmortem_budget_bytes,
                admin=postmortem_admin,
            )
            for monitor in (self.slo_anomaly, self.canary_anomaly):
                if monitor is not None:
                    monitor.add_listener(self.postmortem.on_incident)

    # ------------------------------------------------------- membership

    def add_replica(self, name: str, role: str = "unified") -> None:
        """Add one ``host:port`` replica to the replica set — and, for
        decode-capable roles, the affinity ring (idempotent).
        Consistent hashing keeps existing placements for all but ~1/K
        of the keyspace.  Prefill-role replicas are polled and
        breaker-tracked like any other but never own ring segments:
        they serve ``POST /v1/prefill`` pulls, not ``/generate``."""
        with self._lock:
            if name in self.replicas:
                return
            breaker = CircuitBreaker(
                failure_threshold=self._breaker_failures,
                open_s=self._breaker_open_s,
                on_transition=lambda old, new, n=name: self._on_breaker(
                    n, old, new
                ),
            )
            st = ReplicaState(name, breaker)
            st.role = role
            self.replicas[name] = st
            if role != ROLE_PREFILL:
                self.ring.add(name)
        self.metrics.replica_up.set(1, replica=name)
        self.metrics.replica_fenced.set(0, replica=name)
        self.metrics.breaker_state.set(STATE_VALUE["closed"], replica=name)
        self._record("router.replica_added", replica=name)

    def remove_replica(self, name: str) -> None:
        with self._lock:
            if name not in self.replicas:
                return
            self.ring.remove(name)
            del self.replicas[name]
        if self.planner is not None:
            self.planner.forget(name)
        if self.fabric is not None:
            self.fabric.forget(name)
            self.replicator.forget(name)
        self.metrics.drop_replica(name)
        self._record("router.replica_removed", replica=name)

    # ----------------------------------------------------------- wiring

    def _record(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def _on_breaker(self, name: str, old: str, new: str) -> None:
        self.metrics.breaker_transitions.inc(state=new)
        self.metrics.breaker_state.set(STATE_VALUE[new], replica=name)
        self._record(f"router.breaker_{new}", replica=name, previous=old)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -------------------------------------------------------- poll loop

    def _poll_once(self) -> None:
        if self._poll_guard is not None:
            # Poll state is owner-thread-only: the first off-lock caller
            # (the poll thread) owns it; any other thread polling
            # off-lock is a contract violation racecheck raises on.
            self._poll_guard.check("poll_once")
        for name, st in list(self.replicas.items()):
            if self._stop.is_set():
                return
            try:
                with self.metrics.poll_seconds.time():
                    conn = http.client.HTTPConnection(
                        st.host, st.port, timeout=self._poll_timeout
                    )
                    try:
                        conn.request("GET", "/debug/state?summary=1")
                        resp = conn.getresponse()
                        payload = json.loads(resp.read() or b"{}")
                        if resp.status != 200:
                            raise OSError(f"summary poll HTTP {resp.status}")
                    finally:
                        conn.close()
            except (*_CONN_ERRORS, ValueError) as e:
                if st.reachable:
                    st.reachable = False
                    self.metrics.replica_up.set(0, replica=name)
                    self._record(
                        "router.replica_down", replica=name, error=str(e)
                    )
                continue
            if not st.reachable:
                st.reachable = True
                self.metrics.replica_up.set(1, replica=name)
                self._record("router.replica_up", replica=name)
            role = str(payload.get("role") or "unified")
            if role != st.role:
                self._set_role(name, role)
            st.queue_depth = int(payload.get("queue_depth", 0))
            st.active_slots = int(payload.get("active_slots", 0))
            # Host-side overload signals (queue-wait EWMA + drain-rate
            # forecast): what the migration planner and /debug/fleet
            # scale signal read.  Absent on pre-overload replicas.
            raw_wait = payload.get("queue_wait_ewma_s")
            st.queue_wait_ewma_s = (
                float(raw_wait) if raw_wait is not None else None
            )
            raw_drain = payload.get("drain_rate_rps")
            st.drain_rate_rps = (
                float(raw_drain) if raw_drain is not None else None
            )
            # Replica process uptime (replica-minutes accounting for the
            # fleet controller).  Absent on replicas predating the field.
            raw_uptime = payload.get("uptime_s")
            st.uptime_s = (
                float(raw_uptime) if raw_uptime is not None else None
            )
            # Anomaly-incident cursor (fleet postmortem trigger): an
            # advance since the LAST poll means the replica just
            # emitted an incident — capture its forensic state before
            # the rings roll.  The first observation only seeds the
            # cursor (a router joining a fleet with historical
            # incidents must not back-fire on the backlog).
            raw_incidents = payload.get("incidents_total")
            if raw_incidents is not None:
                try:
                    incidents = int(raw_incidents)
                except (TypeError, ValueError):
                    incidents = None
                if incidents is not None:
                    previous = st.incidents_total
                    st.incidents_total = incidents
                    if (
                        self.postmortem is not None
                        and previous is not None
                        and incidents > previous
                    ):
                        self.postmortem.observe_poll(name, incidents)
            draining = bool(payload.get("draining", False))
            if draining != st.draining:
                self._mark_draining(name, draining)
            fenced = bool(payload.get("fenced", False))
            if fenced != st.fenced:
                self._mark_fenced(name, fenced)
            self._merge_slo(st, payload.get("slo"))
            if self.fabric is not None:
                # Fabric digest off the same poll (fleet KV fabric,
                # router/fabric.py): an absent or unparseable digest
                # clears the replica's view — the locator never places
                # on stale advertisements after a restart.
                self.metrics.fabric_advertised_roots.set(
                    self.fabric.update(name, payload.get("fabric_digest")),
                    replica=name,
                )
            st.last_poll = time.monotonic()
            self.metrics.replica_queue_depth.set(
                st.queue_depth, replica=name
            )
        # Proactive migration rides the poll cadence: feed the planner
        # this sweep's signals, then execute at most one plan verdict.
        self._maybe_plan_migrations()
        # The fleet burn-rate rules ride the same cadence: one
        # evaluation per sweep over the freshly merged SLI deltas.
        self._evaluate_slo()
        # K-replica hot-prefix replication rides the same cadence too:
        # host-side pressure signals + the live-stream census, bounded
        # actions per sweep — never device counters.
        self._fabric_tick()

    def _merge_slo(self, st, slo_block) -> None:
        """Delta one replica's cumulative SLI counters into the fleet
        tracker (poll thread only — the tracker is poll state).  A
        counter that SHRANK means the replica restarted: its fresh
        totals ARE the delta (the new process's events), so a restart
        re-baselines without inventing negative traffic."""
        if self.slo is None or not slo_block:
            return
        totals = slo_block.get("objectives")
        if not isinstance(totals, dict):
            return
        previous = st.slo_totals or {}
        clean: dict = {}
        for objective, pair in totals.items():
            try:
                good, total = int(pair[0]), int(pair[1])
            except (TypeError, ValueError, IndexError):
                continue
            clean[objective] = [good, total]
            prev_good, prev_total = previous.get(objective, (0, 0))
            d_good, d_total = good - prev_good, total - prev_total
            if d_good < 0 or d_total < 0:
                d_good, d_total = good, total
            self.slo.ingest(objective, d_good, d_total)
        st.slo_totals = clean

    def _evaluate_slo(self) -> None:
        """Per-sweep burn-rate evaluation (poll thread only): refresh
        the tpu_slo_burn_rate gauges and fan out every alert
        transition — slo.burn_alert flight event, a direct incident on
        fire (page/ticket severity rides both), and the fired counter."""
        if self.slo is None:
            return
        for objective in self.slo.objectives:
            for wname, wsec in self.slo.windows.items():
                self.metrics.slo_burn_rate.set(
                    round(self.slo.burn_rate(objective, wsec), 4),
                    objective=objective,
                    window=wname,
                )
        for transition in self.slo.evaluate():
            self._record("slo.burn_alert", **transition)
            if transition["state"] == "fired":
                self.metrics.slo_burn_alerts.inc(
                    objective=transition["objective"],
                    severity=transition["severity"],
                )
                if self.slo_anomaly is not None:
                    self.slo_anomaly.report(
                        "slo.burn_rate",
                        observed=max(
                            transition["burn_rates"].values(), default=0.0
                        ),
                        objective=transition["objective"],
                        rule=transition["rule"],
                        severity=transition["severity"],
                    )

    def _mark_draining(self, name: str, draining: bool) -> None:
        st = self.replicas.get(name)
        if st is None:
            return
        # Called from the poll thread (summary says draining) AND from
        # request/stream threads (a 503 without X-Shed): the lock is the
        # cross-thread license to touch poll state — the OwnerGuard
        # contract's "other side" (see __init__).  Instruments fire
        # outside the lock: leaf locks only ever nest under this one.
        with self._lock:
            if self._poll_guard is not None:
                self._poll_guard.check("mark_draining")
            if st.draining == draining:
                return
            st.draining = draining
        self.metrics.replica_draining.set(1 if draining else 0, replica=name)
        self._record(
            "router.drain_begin" if draining else "router.drain_end",
            replica=name,
        )

    def _mark_fenced(self, name: str, fenced: bool) -> None:
        """A replica self-fenced (hung-step watchdog, chip-health feed,
        or operator POST /debug/fence): demote it exactly like a
        draining one — no new assignments; its cut streams fail over
        through the ordinary zero-drop path — until the summary clears."""
        st = self.replicas.get(name)
        if st is None:
            return
        with self._lock:  # same cross-thread license as _mark_draining
            if self._poll_guard is not None:
                self._poll_guard.check("mark_fenced")
            if st.fenced == fenced:
                return
            st.fenced = fenced
        self.metrics.replica_fenced.set(1 if fenced else 0, replica=name)
        self._record(
            "router.replica_fenced" if fenced else "router.replica_unfenced",
            replica=name,
        )

    def _set_role(self, name: str, role: str) -> None:
        """A replica's summary poll reported a different role (a
        redeploy flipped --role): reconcile ring membership — prefill
        replicas own no ring segments; a replica becoming
        decode-capable joins the ring (~1/K remap, like any membership
        change)."""
        st = self.replicas.get(name)
        if st is None:
            return
        with self._lock:  # same cross-thread license as _mark_draining
            if self._poll_guard is not None:
                self._poll_guard.check("set_role")
            if st.role == role:
                return
            st.role = role
            if role == ROLE_PREFILL:
                self.ring.remove(name)
            else:
                self.ring.add(name)
        self._record("router.replica_role", replica=name, role=role)

    def _refresh_dns(self) -> None:
        """Re-resolve ``--replicas-dns`` (a headless Service name) and
        reconcile ring membership — replicas scale without a router
        restart, and consistent hashing keeps warm prefixes where they
        are for the survivors."""
        if not self._dns:
            return
        host, _, port = self._dns.rpartition(":")
        try:
            infos = socket.getaddrinfo(
                host, int(port), socket.AF_INET, socket.SOCK_STREAM
            )
        except OSError as e:
            self._record("router.dns_error", target=self._dns, error=str(e))
            return
        resolved = {f"{info[4][0]}:{info[4][1]}" for info in infos}
        if not resolved:
            return
        current = set(self.replicas)
        for name in resolved - current:
            self.add_replica(name)
        for name in current - resolved - self._static_prefill:
            self.remove_replica(name)

    def _poll_loop(self) -> None:
        # The FIRST poll runs here too (not in start()): the poll thread
        # is the single off-lock owner of replica poll state, and
        # start() blocks on _first_poll instead — same no-cold-blind-
        # spot contract, one owner thread.
        self._poll_once()
        self._first_poll.set()
        while not self._stop.wait(self._poll_interval):
            self._refresh_dns()
            self._poll_once()

    # ------------------------------------------------- planned migration

    def _maybe_plan_migrations(self) -> None:
        """Poll-thread tick: feed this sweep's host-side signals to the
        planner and execute at most one plan verdict (flag streams; the
        relay threads perform the actual zero-drop moves at their next
        paced token boundary)."""
        planner = self.planner
        if planner is None:
            return
        for name, st in list(self.replicas.items()):
            planner.observe(
                name,
                wait_ewma_s=st.queue_wait_ewma_s,
                drain_rate_rps=st.drain_rate_rps,
                queue_depth=st.queue_depth,
                eligible=(
                    st.reachable
                    and not st.draining
                    and not st.fenced
                    and st.role != ROLE_PREFILL
                ),
            )
        verdict = planner.plan()
        if verdict is None:
            return
        source, target, n_moves = verdict
        self.plan_migration(source, target=target, max_moves=n_moves)

    def plan_migration(
        self,
        replica: str,
        target: Optional[str] = None,
        max_moves: int = 1,
    ) -> int:
        """Plan moves of the hottest prefix-block sessions off
        ``replica``: flag up to ``max_moves`` live streams to resubmit
        (prompt + emitted tokens, same rid — the failover shape,
        but PLANNED) onto ``target`` (default: the coldest eligible
        peer).  Hotness ranks by live streams sharing the prefix key
        (the shard the KV tiers are sweating for), then by emitted
        length.  Returns how many streams were flagged; the relay
        threads execute at their next paced token boundary and abort if
        the target's breaker refuses."""
        if target is None:
            target = self._coldest_peer(replica)
        if target is None or target == replica:
            return 0
        with self._streams_lock:
            cands = [
                c
                for c in self._streams.values()
                if c.replica == replica and c.migrate_to is None
            ]
            by_key: dict[int, int] = {}
            for c in cands:
                by_key[c.prefix_key] = by_key.get(c.prefix_key, 0) + 1
            cands.sort(
                key=lambda c: (-by_key[c.prefix_key], -c.emitted, c.rid)
            )
            flagged = cands[: max(0, int(max_moves))]
            for c in flagged:
                c.migrate_to = target
        # Instruments OUTSIDE the streams lock (leaf-lock discipline).
        for c in flagged:
            self.metrics.migrations.inc(outcome="planned")
            self._record(
                "router.migration_planned",
                rid=c.rid,
                replica=replica,
                target=target,
                emitted=c.emitted,
            )
        return len(flagged)

    def _coldest_peer(self, source: str) -> Optional[str]:
        """The least-pressured routable replica other than ``source``
        (the default migration target when the caller names none)."""
        best: Optional[tuple[float, str]] = None
        for name, st in self.replicas.items():
            if (
                name == source
                or not st.reachable
                or st.draining
                or st.fenced
                or st.role == ROLE_PREFILL
            ):
                continue
            pressure = replica_pressure(
                st.queue_wait_ewma_s, st.drain_rate_rps, st.queue_depth
            )
            if best is None or (pressure, name) < best:
                best = (pressure, name)
        return best[1] if best is not None else None

    def _acquire_migration_target(self, target: str) -> bool:
        """Planned-move admission: the target must be routable RIGHT
        NOW and its breaker must grant the dial — a migration aborts
        rather than dogpile a tripping or demoted target."""
        st = self.replicas.get(target)
        if (
            st is None
            or st.draining
            or st.fenced
            or not st.reachable
            or st.role == ROLE_PREFILL
        ):
            return False
        return st.breaker.try_acquire()

    def _migration_aborted(self, rid: str, target: str, reason: str) -> None:
        self.metrics.migrations.inc(outcome="aborted")
        self._record(
            "router.migration_aborted", rid=rid, target=target, reason=reason
        )

    def _classify_disagg(
        self, prompt
    ) -> tuple[str, Optional[str]]:
        """(verdict, prefill source): classify one request against the
        split policy (prompt length × decode-pool pressure) and pick
        the least-pressured healthy prefill replica as its
        ``X-Handoff-Source`` locator.  ``no_pool`` (no healthy prefill
        replica) degrades to unified dispatch — the caller stamps
        nothing."""
        prefills: dict[str, float] = {}
        decode_pressure = 0.0
        for name, st in list(self.replicas.items()):
            if not st.reachable or st.draining or st.fenced:
                continue
            pressure = replica_pressure(
                st.queue_wait_ewma_s, st.drain_rate_rps, st.queue_depth
            )
            if st.role == ROLE_PREFILL:
                prefills[name] = pressure
            else:
                decode_pressure = max(decode_pressure, pressure)
        verdict = self.disagg.classify(
            len(prompt), decode_pressure, bool(prefills)
        )
        if verdict != SPLIT:
            # Short prompt or no healthy prefill pool: the LOCAL
            # sentinel tells a decode-role replica to run its own
            # prefill instead of refusing — the unified degradation
            # (a unified replica ignores the header entirely).
            return verdict, HANDOFF_LOCAL
        return verdict, pick_prefill(prefills) or HANDOFF_LOCAL

    def _prefill_needed(self, name: str, trace_id: str, missing) -> None:
        """One decode replica answered 409 + X-Prefill-Needed: the
        prompt's prefix is neither resident nor fetchable there.  Not a
        fault (no breaker hit) — skip the replica and keep walking the
        ring (a unified replica serves it; with --disagg the locator
        normally prevents this entirely)."""
        self.metrics.disagg_refusals.inc()
        self._record(
            "router.prefill_needed",
            replica=name,
            rid=trace_id,
            missing_pages=missing,
        )

    # ------------------------------------------------------- fleet fabric

    def _fabric_source_for(
        self, target: str, payload: dict
    ) -> Optional[str]:
        """Per-dial locator resolution (fleet KV fabric): the best
        owner of this prompt's deepest advertised cumulative prefix,
        or None when the TARGET already advertises it (or nobody
        does).  Called immediately before every upstream dial —
        primary, retry, hedge, failover and migration legs alike — so
        a re-dialed leg re-resolves against CURRENT membership and
        can never be pointed at a dead, fenced, or draining peer."""
        if self.fabric is None:
            return None
        prompt = payload.get("prompt")
        if not prompt:
            return None
        self._fabric_resolutions += 1
        if payload.get("adapter"):
            # Adapter trie roots are engine-local indices the router
            # cannot address; adapter traffic rides affinity + the
            # classic prefill-pool path unchanged.
            self.metrics.fabric_resolutions.inc(verdict=VERDICT_SKIP)
            return None
        resident = self.fabric.coverage(target, prompt)
        candidates = [
            name
            for name, st in list(self.replicas.items())
            if name != target
            and st.reachable
            and not st.draining
            and not st.fenced
        ]
        best = self.fabric.best_owner(prompt, candidates)
        if best is None or best[1] <= resident:
            self.metrics.fabric_resolutions.inc(
                verdict=VERDICT_RESIDENT if resident else VERDICT_MISS
            )
            return None
        owner, covered = best
        self._fabric_hits += 1
        self.metrics.fabric_resolutions.inc(verdict=VERDICT_HIT)
        self._record(
            "router.fabric_locate",
            target=target,
            source=owner,
            covered_tokens=covered,
            prompt_tokens=len(prompt),
        )
        return owner

    def _fabric_tick(self) -> None:
        """Poll-thread sweep: census the live streams' prefixes, feed
        the replicator the fleet's pressure signals, and fire its
        bounded pull/drop verdicts at the engines off-thread."""
        if self.replicator is None:
            return
        with self._streams_lock:
            hot: dict[tuple, int] = {}
            for c in self._streams.values():
                if c.prefix_tokens:
                    hot[c.prefix_tokens] = hot.get(c.prefix_tokens, 0) + 1
        pressures = {
            name: replica_pressure(
                st.queue_wait_ewma_s, st.drain_rate_rps, st.queue_depth
            )
            for name, st in list(self.replicas.items())
            if st.reachable
            and not st.draining
            and not st.fenced
            and st.role != ROLE_PREFILL
        }
        for action in self.replicator.plan(self.fabric, hot, pressures):
            self._fabric_execute(action)

    def _fabric_execute(self, action: dict) -> None:
        """Fire one replication verdict at its target engine on a
        worker thread (a pull streams the whole prefix over the
        handoff wire — the poll loop must not wait on it).  The
        in-flight set keeps one sweep's action from being re-fired
        while a slow transfer is still running."""
        target = action["target"]
        st = self.replicas.get(target)
        if st is None:
            return
        op = action["op"]
        key = (op, target, tuple(action["prompt"]))
        with self._lock:
            if key in self._fabric_inflight:
                return
            self._fabric_inflight.add(key)
        path = "/debug/fabric/pull" if op == "pull" else "/debug/fabric/drop"
        body: dict = {"prompt": action["prompt"]}
        if op == "pull":
            body["source"] = action["source"]

        def run():
            ok = False
            detail: dict = {}
            try:
                conn = http.client.HTTPConnection(
                    st.host, st.port, timeout=self.fabric_cfg.pull_timeout_s
                )
                try:
                    conn.request(
                        "POST",
                        path,
                        json.dumps(body).encode(),
                        {"Content-Type": "application/json"},
                    )
                    resp = conn.getresponse()
                    detail = json.loads(resp.read() or b"{}")
                    ok = resp.status == 200 and bool(detail.get("ok"))
                finally:
                    conn.close()
            except (*_CONN_ERRORS, ValueError) as e:
                detail = {"error": str(e)}
            finally:
                with self._lock:
                    self._fabric_inflight.discard(key)
            outcome = "ok" if ok else "error"
            if op == "pull":
                self.metrics.fabric_replications.inc(outcome=outcome)
            else:
                self.metrics.fabric_drops.inc(outcome=outcome)
            self._record(
                "router.fabric_replicated" if op == "pull"
                else "router.fabric_dropped",
                target=target,
                source=action.get("source"),
                prompt_tokens=len(action["prompt"]),
                ok=ok,
                detail=detail.get("error") or detail.get("outcome"),
            )

        threading.Thread(
            target=run, name="router-fabric", daemon=True
        ).start()

    def fabric_state(self) -> dict:
        """GET /debug/fabric: digest views, locator counters, and the
        replication ledger."""
        if self.fabric is None:
            return {"enabled": False}
        resolutions = self._fabric_resolutions
        hits = self._fabric_hits
        return {
            "enabled": True,
            "replicas": self.fabric.snapshot(),
            "resolutions": resolutions,
            "cross_peer_hits": hits,
            "cross_peer_hit_rate": (
                round(hits / resolutions, 4) if resolutions else 0.0
            ),
            "replication": self.replicator.snapshot(),
        }

    def _fabric_summary(self) -> dict:
        """The /debug/fleet fabric block ``tools/fleet_plan.py``
        renders: per-replica advertised-root counts, the hottest live
        prefixes' current replication factors, and the cross-peer hit
        rate."""
        if self.fabric is None:
            return {"enabled": False}
        with self._streams_lock:
            hot: dict[tuple, int] = {}
            for c in self._streams.values():
                if c.prefix_tokens:
                    hot[c.prefix_tokens] = hot.get(c.prefix_tokens, 0) + 1
        names = list(self.replicas)
        ps = self.fabric.page_size()
        hottest = [
            {
                "prefix_tokens": len(prefix),
                "streams": count,
                "replication_factor": self.replicator.replication_factor(
                    self.fabric, prefix, names
                ),
            }
            for prefix, count in sorted(
                hot.items(),
                key=lambda item: (
                    -(item[1] * (len(item[0]) // ps)),
                    item[0],
                ),
            )[:5]
        ]
        resolutions = self._fabric_resolutions
        hits = self._fabric_hits
        return {
            "enabled": True,
            "advertised_roots": self.fabric.advertised_roots(),
            "hottest_prefixes": hottest,
            "cross_peer_hits": hits,
            "cross_peer_hit_rate": (
                round(hits / resolutions, 4) if resolutions else 0.0
            ),
        }

    def fleet_state(self) -> dict:
        """GET /debug/fleet: per-replica host-side signals, planner
        state, and the fleet scale recommendation — what
        ``tools/fleet_plan.py`` renders and an autoscaler would poll."""
        cfg = self.planner.cfg if self.planner is not None else MigrationConfig()
        now = time.monotonic()
        signals = {}
        for name, st in list(self.replicas.items()):
            eligible = (
                st.reachable
                and not st.draining
                and not st.fenced
                and st.role != ROLE_PREFILL
            )
            pressure = round(
                replica_pressure(
                    st.queue_wait_ewma_s,
                    st.drain_rate_rps,
                    st.queue_depth,
                ),
                4,
            )
            signals[name] = {
                "role": st.role,
                "pressure_s": pressure,
                "queue_depth": st.queue_depth,
                "active_slots": st.active_slots,
                "queue_wait_ewma_s": st.queue_wait_ewma_s,
                "drain_rate_rps": st.drain_rate_rps,
                "slo_totals": st.slo_totals,
                "eligible": eligible,
                "reachable": st.reachable,
                "draining": st.draining,
                "fenced": st.fenced,
                # Replica-minutes accounting: the replica's
                # self-reported process uptime, falling back to
                # age-since-registration for replicas predating the
                # summary field.
                "uptime_s": (
                    st.uptime_s
                    if st.uptime_s is not None
                    else round(now - st.first_seen, 3)
                ),
                # Per-replica scale_recommendation inputs, pre-judged
                # with the SAME thresholds the verdict below uses — a
                # controller decision (including over the prefill pool
                # the recommendation excludes) is explainable from this
                # one snapshot.
                "hot": pressure >= cfg.hot_wait_s,
                "cold": pressure <= cfg.cold_wait_s,
            }
        with self._streams_lock:
            active_streams = len(self._streams)
        return {
            "replicas": signals,
            "active_streams": active_streams,
            "migration": (
                self.planner.snapshot()
                if self.planner is not None
                else {"enabled": False}
            ),
            "recommendation": scale_recommendation(
                signals,
                hot_wait_s=cfg.hot_wait_s,
                cold_wait_s=cfg.cold_wait_s,
            ),
            # Compact fleet SLO view (the full version is /debug/slo):
            # burn rates + active alerts so fleet_plan.py — and, later,
            # the autoscaler — can act on budget burn, not
            # just queue pressure.
            "slo": self._fleet_slo_summary(),
            # Compact fleet KV fabric view (the full version is
            # /debug/fabric): advertised-root counts, hottest-prefix
            # replication factors, cross-peer hit rate.
            "fabric": self._fabric_summary(),
        }

    def _fleet_slo_summary(self) -> dict:
        if self.slo is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "burn_rates": {
                objective: {
                    wname: round(self.slo.burn_rate(objective, wsec), 3)
                    for wname, wsec in self.slo.windows.items()
                }
                for objective in self.slo.objectives
            },
            "budget_remaining": {
                objective: round(self.slo.budget_remaining(objective), 4)
                for objective in self.slo.objectives
            },
            "alerts": self.slo.active_alerts(),
        }

    def slo_state(self) -> dict:
        """GET /debug/slo: the fleet-merged tracker's full snapshot
        plus each replica's own cumulative SLI counters.  For a
        single-replica fleet the fleet totals equal that replica's own
        /debug/slo totals — the aggregation-correctness check the
        chaos suite pins."""
        if self.slo is None:
            return {"enabled": False}
        snap = self.slo.snapshot()
        snap["enabled"] = True
        snap["replicas"] = {
            name: st.slo_totals for name, st in list(self.replicas.items())
        }
        return snap

    # ------------------------------------------------------ dispatching

    def _per_request_s(self) -> float:
        """Router-measured mean request service time (from the
        request_seconds histogram operators already scrape) — the
        multiplier behind every queue-depth wait forecast.  0.0 until
        anything completed (forecasts then read as 'feasible')."""
        hist = self.metrics.request_seconds
        count = hist.count
        if not count:
            return 0.0
        return hist.snapshot()[2] / count

    def _deadline_infeasible(self, remaining_s: Optional[float]) -> bool:
        """True when even the emptiest non-draining replica's queue
        forecast exceeds the remaining deadline — the fail-fast (504,
        never enqueue) gate."""
        if remaining_s is None:
            return False
        if remaining_s <= 0:
            return True
        return (
            self.policy.min_wait_estimate_s(self._per_request_s())
            > remaining_s
        )

    def _dial(
        self,
        name: str,
        payload: dict,
        trace_id: str,
        stream: bool,
        deadline: Optional[float] = None,
        hop_header: Optional[str] = None,
        handoff: Optional[str] = None,
    ) -> _Upstream:
        """One upstream POST /generate.  Fires the per-replica
        ``router.replica_conn`` failpoint first (the chaos seam: an
        armed error here looks exactly like a dial failure).  When the
        request carries a deadline, the REMAINING budget is re-computed
        at dial time and stamped as ``X-Request-Deadline`` — each hop
        subtracts the time it already spent, so the replica's expiry
        sweep judges the same clock the client does.  ``hop_header``
        is this leg's ``X-Trace-Context`` (distinct per attempt) — the
        replica roots its span tree under it.  Raises
        ``_CONN_ERRORS`` / ``FailpointError`` on transport failure."""
        failpoints.fire_scoped(FAILPOINT_CONN, name, replica=name)
        st = self.replicas[name]
        body = dict(payload)
        body["stream"] = stream
        headers = {
            "Content-Type": "application/json",
            "X-Request-Id": trace_id,
        }
        if hop_header is not None:
            headers[TRACE_CONTEXT_HEADER] = hop_header
        if handoff is not None and handoff != HANDOFF_LOCAL:
            # Disaggregation locator: the decode replica pulls this
            # prompt's prefix from the named prefill replica before
            # admitting (models/engine_handoff.py).
            headers[HANDOFF_SOURCE_HEADER] = handoff
        else:
            # Fleet KV fabric: no prefill-pool locator rides this leg
            # (unified fleet, short prompt, or the LOCAL sentinel), so
            # resolve the best advertised owner of the prompt's prefix
            # against current membership and stamp it — resident-only,
            # so a bloom FP or stale digest degrades the TARGET to
            # local prefill instead of moving the prefill to the
            # wrong replica.  Re-resolved on EVERY dial: failover and
            # migration legs never inherit a dead peer.
            fabric_source = self._fabric_source_for(name, payload)
            if fabric_source is not None:
                headers[HANDOFF_SOURCE_HEADER] = fabric_source
                headers[FABRIC_RESIDENT_ONLY_HEADER] = "1"
            elif handoff is not None:
                headers[HANDOFF_SOURCE_HEADER] = handoff
        if deadline is not None:
            headers["X-Request-Deadline"] = (
                f"{max(deadline - time.monotonic(), 0.0):.3f}"
            )
        conn = http.client.HTTPConnection(
            st.host, st.port, timeout=self._upstream_timeout
        )
        try:
            conn.request(
                "POST",
                "/generate",
                json.dumps(body).encode(),
                headers=headers,
            )
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        return _Upstream(name, conn, resp)

    def _span_route(
        self, tr: Optional[_ReqTrace], t0: float, picked, exclude: set
    ) -> None:
        """One ``router.route`` span per candidate selection: the
        placement decision, breaker-gated skips (the exclude set), and
        the retry-budget level at decision time — the
        breaker/budget-decision record of the timeline."""
        if tr is None:
            return
        attrs: dict = {
            "excluded": len(exclude),
            "budget": round(self.budget.available(), 1),
        }
        if picked is None:
            attrs["outcome"] = "none_dialable"
        else:
            attrs["replica"], attrs["placement"] = picked
        self.spans.record_span(
            "router.route",
            tr.trace_id,
            start_monotonic=t0,
            parent_id=tr.root,
            attrs=attrs,
        )

    def _span_attempt(
        self,
        tr: Optional[_ReqTrace],
        span_id: int,
        t0: float,
        replica: str,
        attempt: int,
        kind: str,
        **attrs,
    ) -> None:
        """Record one upstream leg's ``router.attempt`` span under the
        span id its ``X-Trace-Context`` carried — the cross-process
        anchor the replica's tree parents on.  ``kind`` is
        primary/retry/hedge/failover."""
        if tr is None:
            return
        self.spans.record_span(
            "router.attempt",
            tr.trace_id,
            start_monotonic=t0,
            span_id=span_id,
            parent_id=tr.root,
            attrs={
                "replica": replica,
                "attempt": attempt,
                "hop": _ReqTrace.HOP,
                "kind": kind,
                **attrs,
            },
        )

    def _next_candidate(
        self, prompt, exclude: set, attempt_index: int
    ) -> Optional[tuple[str, str]]:
        """(replica, placement) for the next dial, or None when nothing
        is currently dialable.  Breaker acquisition happens HERE (it
        consumes the half-open probe slot)."""
        order, tag = self.policy.candidates(prompt)
        for i, name in enumerate(order):
            if name in exclude:
                continue
            st = self.replicas.get(name)
            if st is None or not st.breaker.try_acquire():
                continue
            placement = tag if (i == 0 and attempt_index == 0) else FAILOVER
            return name, placement
        return None

    def _backoff(self, attempt: int, retry_after: Optional[float]) -> float:
        """Exponential backoff with full jitter, floored at the
        strictest Retry-After a replica sent (the drain/overload
        contract: the fleet told us when to come back)."""
        exp = min(self._backoff_max, self._backoff_base * (2**attempt))
        delay = self._rng.uniform(0, exp)
        if retry_after is not None:
            # Honor the fleet's Retry-After even past the backoff cap —
            # the replicas told us when to come back.
            delay = max(delay, retry_after)
        return delay

    def _classify(self, up: _Upstream) -> tuple[str, bytes, dict]:
        """Read + classify a unary upstream response:
        ``("ok"|"relay"|"draining"|"shed"|"error", body, headers)``."""
        resp = up.resp
        data = resp.read()
        headers = {
            k: v
            for k, v in resp.getheaders()
            if k.lower()
            in (
                "content-type",
                "x-request-id",
                "retry-after",
                "x-shed",
                "x-prefill-needed",
            )
        }
        if resp.status == 200:
            return "ok", data, headers
        if resp.status == 409 and headers.get(PREFILL_NEEDED_HEADER):
            # Decode-role refusal: prefix not resident, no locator.
            # Skip the replica (no breaker hit) and keep walking.
            return "prefill_needed", data, headers
        if resp.status == 503:
            if headers.get("X-Shed"):
                # Overload shed, not drain: the replica is healthy and
                # stays in rotation — honor its Retry-After and try the
                # next candidate instead of ejecting it.
                return "shed", data, headers
            # The begin_drain() contract: not a fault, a polite no.
            return "draining", data, headers
        if resp.status >= 500:
            return "error", data, headers
        # 4xx (validation) and 504 (the replica already timed the
        # request out): deterministic verdicts retrying cannot change.
        return "relay", data, headers

    # ------------------------------------------------------------ unary

    def _proxy_unary(
        self, handler, body, prompt, trace_id, deadline_s=None, tr=None,
        handoff=None,
    ) -> None:
        t0 = time.monotonic()
        # The client's deadline bounds the whole attempt budget: every
        # retry sleep, hedge, and re-dial below checks the remaining
        # budget before spending — a doomed request 504s fast instead
        # of churning through the ring.
        deadline = t0 + (
            self._timeout
            if deadline_s is None
            else min(self._timeout, deadline_s)
        )
        exclude: set = set()
        retry_after: Optional[float] = None
        attempt = 0
        sleeps = 0
        while time.monotonic() < deadline:
            if deadline_s is not None and self._deadline_infeasible(
                deadline - time.monotonic()
            ):
                # Even the emptiest replica's queue forecast outruns the
                # remaining budget: fail fast, never enqueue.
                self.metrics.requests.inc(outcome="deadline")
                if tr:
                    tr.set(outcome="deadline")
                self._record(
                    "router.deadline_exceeded",
                    where="forecast",
                    rid=trace_id,
                    remaining_s=round(deadline - time.monotonic(), 3),
                )
                handler._reply(
                    504,
                    {
                        "error": "deadline cannot be met by any replica",
                        "trace_id": trace_id,
                    },
                    trace_id,
                )
                return
            route_t0 = time.monotonic()
            picked = self._next_candidate(prompt, exclude, attempt)
            self._span_route(tr, route_t0, picked, exclude)
            if picked is None:
                if exclude:
                    # Everything failed (or shed) once: start over — but
                    # when a replica told us WHEN to come back
                    # (Retry-After on an overload shed), honor it before
                    # re-dialing, or the restart degenerates into a
                    # hammer loop against a fleet that just said no.
                    exclude.clear()
                    if retry_after is not None:
                        delay = self._backoff(sleeps, retry_after)
                        sleeps += 1
                        if (
                            time.monotonic() + delay >= deadline
                            or sleeps > 16
                        ):
                            break
                        time.sleep(delay)
                        retry_after = None
                    continue
                delay = self._backoff(sleeps, retry_after)
                sleeps += 1
                if time.monotonic() + delay >= deadline or sleeps > 16:
                    break
                time.sleep(delay)
                retry_after = None
                continue
            name, placement = picked
            if attempt > 0:
                if not self.budget.try_spend():
                    self._record(
                        "router.retry_budget_exhausted",
                        replica=name,
                        rid=trace_id,
                    )
                    break
                self.metrics.retries.inc()
                self._record(
                    "router.retry",
                    replica=name,
                    attempt=attempt,
                    rid=trace_id,
                )
            st = self.replicas[name]
            try:
                result = self._dial_with_hedge(
                    name, body, prompt, trace_id, exclude, deadline=
                    deadline if deadline_s is not None else None,
                    tr=tr, kind="retry" if attempt > 0 else "primary",
                    handoff=handoff,
                )
            except (failpoints.FailpointError, *_CONN_ERRORS) as e:
                st.failures += 1
                st.breaker.record_failure()
                self._record(
                    "router.dispatch_error",
                    replica=name,
                    error=str(e),
                    rid=trace_id,
                )
                exclude.add(name)
                attempt += 1
                continue
            up, winner_placement = result
            kind, data, headers = self._classify(up)
            up.close()
            if kind == "prefill_needed":
                self._prefill_needed(
                    up.name, trace_id, headers.get(PREFILL_NEEDED_HEADER)
                )
                exclude.add(up.name)
                continue
            if kind in ("draining", "shed"):
                ra = headers.get("Retry-After")
                retry_after = float(ra) if ra else retry_after
                if kind == "draining":
                    self._mark_draining(up.name, True)
                else:
                    # Overload shed: the replica is healthy — keep it
                    # in rotation, just not for THIS request.
                    self._record(
                        "router.replica_shed",
                        replica=up.name,
                        shed=headers.get("X-Shed"),
                        retry_after=ra,
                        rid=trace_id,
                    )
                exclude.add(up.name)
                # A polite 503 is not a breaker failure and not a retry:
                # the replica is healthy, just leaving the rotation.
                continue
            if kind == "error":
                st2 = self.replicas.get(up.name)
                if st2 is not None:
                    st2.failures += 1
                    st2.breaker.record_failure()
                self._record(
                    "router.dispatch_error",
                    replica=up.name,
                    status=up.resp.status,
                    rid=trace_id,
                )
                exclude.add(up.name)
                attempt += 1
                continue
            # ok or relay: this is the client's answer.
            st2 = self.replicas.get(up.name)
            if st2 is not None:
                st2.dispatches += 1
                if kind == "ok":
                    st2.breaker.record_success()
            elapsed = time.monotonic() - t0
            if kind == "ok":
                self._ttft_rolling.add(elapsed)
                self.metrics.ttft_seconds.observe(elapsed)
                self.metrics.request_seconds.observe(elapsed)
                self.metrics.placements.inc(
                    placement=winner_placement or placement
                )
                self.metrics.requests.inc(outcome="ok")
            else:
                self.metrics.requests.inc(outcome="error")
            if tr:
                tr.set(
                    outcome="ok" if kind == "ok" else "error",
                    replica=up.name,
                    placement=winner_placement or placement,
                )
            handler.send_response(up.resp.status)
            for key, value in headers.items():
                if key.lower() != "x-request-id":
                    handler.send_header(key, value)
            handler.send_header("X-Request-Id", trace_id)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            try:
                handler.wfile.write(data)
            except OSError:
                pass
            return
        if deadline_s is not None and time.monotonic() >= deadline:
            self.metrics.requests.inc(outcome="deadline")
            if tr:
                tr.set(outcome="deadline")
            self._record(
                "router.deadline_exceeded", where="retry_loop", rid=trace_id
            )
            handler._reply(
                504,
                {"error": "deadline exceeded", "trace_id": trace_id},
                trace_id,
            )
            return
        self.metrics.requests.inc(outcome="timeout")
        if tr:
            tr.set(outcome="timeout")
        handler._reply(
            503,
            {"error": "no replica available", "trace_id": trace_id},
            trace_id,
            retry_after="1",
        )

    def _dial_with_hedge(
        self, name, body, prompt, trace_id, exclude, deadline=None,
        tr=None, kind="primary", handoff=None,
    ) -> tuple[_Upstream, Optional[str]]:
        """Dial ``name``; when hedging is on and no response lands
        within the rolling TTFT p99, race a second dispatch along the
        ring.  Returns the winning upstream (loser closed) and its
        placement override (``failover`` when the hedge won).  Raises
        the primary's error when every leg fails.  With a client
        deadline, the hedge only fires while enough budget remains for
        the second leg to actually answer — a hedge that cannot beat
        the deadline is a wasted retry token.  Every leg — primary AND
        hedge — draws its own attempt index + span id from ``tr``, so
        the two race legs are distinct, separately-linked children in
        the assembled timeline."""
        results: queue_mod.Queue = queue_mod.Queue()

        def leg(leg_name: str, leg_kind: str):
            attempt_idx, span_id = (
                tr.begin_attempt() if tr else (0, 0)
            )
            leg_t0 = time.monotonic()
            try:
                up = self._dial(
                    leg_name, body, trace_id, False, deadline,
                    hop_header=tr.header(span_id, attempt_idx)
                    if tr
                    else None,
                    handoff=handoff,
                )
            except (failpoints.FailpointError, *_CONN_ERRORS) as e:
                self._span_attempt(
                    tr, span_id, leg_t0, leg_name, attempt_idx, leg_kind,
                    outcome="conn_error", error=type(e).__name__,
                )
                results.put((leg_name, None, e))
                return
            # Unary: the response headers are in — dial + TTFB is the
            # leg's span; the body relay happens on the handler thread.
            self._span_attempt(
                tr, span_id, leg_t0, leg_name, attempt_idx, leg_kind,
                status=up.resp.status,
            )
            results.put((leg_name, up, None))

        threading.Thread(
            target=leg, args=(name, kind), name="router-dial", daemon=True
        ).start()
        in_flight = 1
        hedged_name = None
        p99 = self._ttft_rolling.quantile(0.99)
        hedge_after = max(self._hedge_min_s, p99 if p99 else 0.0)
        hedge_deadline = time.monotonic() + hedge_after
        first_error: Optional[Exception] = None
        while in_flight:
            timeout = None
            if self._hedge and hedged_name is None:
                timeout = max(0.0, hedge_deadline - time.monotonic())
            try:
                leg_name, up, err = results.get(
                    timeout=timeout if timeout is not None else self._upstream_timeout
                )
            except queue_mod.Empty:
                if self._hedge and hedged_name is None:
                    if (
                        deadline is not None
                        and deadline - time.monotonic() <= hedge_after
                    ):
                        # Not enough budget left for a second leg to
                        # win: spend nothing.
                        hedged_name = ""
                        continue
                    route_t0 = time.monotonic()
                    picked = self._next_candidate(
                        prompt, exclude | {name}, 1
                    )
                    if picked is not None and self.budget.try_spend():
                        self._span_route(
                            tr, route_t0, picked, exclude | {name}
                        )
                        hedged_name = picked[0]
                        self._record(
                            "router.hedge",
                            replica=hedged_name,
                            primary=name,
                            after_s=round(hedge_after, 3),
                            rid=trace_id,
                        )
                        threading.Thread(
                            target=leg,
                            args=(hedged_name, "hedge"),
                            name="router-hedge",
                            daemon=True,
                        ).start()
                        in_flight += 1
                    else:
                        hedged_name = ""  # nothing to hedge with; stop trying
                continue
            in_flight -= 1
            if err is not None:
                st = self.replicas.get(leg_name)
                if st is not None:
                    st.failures += 1
                    st.breaker.record_failure()
                if leg_name == name:
                    first_error = err
                else:
                    self.metrics.hedges.inc(result="lost")
                continue
            # First response wins; the loser leg (if still in flight)
            # is drained and closed in the background — the losing
            # replica sees a broken pipe and cancels its request.
            if in_flight:
                self._drain_legs(results, in_flight)
            if hedged_name and leg_name == hedged_name:
                self.metrics.hedges.inc(result="won")
                self._record(
                    "router.hedge_won",
                    replica=leg_name,
                    primary=name,
                    rid=trace_id,
                )
                return up, FAILOVER
            if hedged_name and leg_name == name:
                self.metrics.hedges.inc(result="lost")
            return up, None
        raise first_error if first_error is not None else OSError(
            "all hedge legs failed"
        )

    def _drain_legs(self, results: queue_mod.Queue, n: int) -> None:
        """Close the remaining hedge legs off-thread (their sockets must
        not outlive the request, and the handler must not wait)."""

        def drain():
            for _ in range(n):
                try:
                    _, up, _err = results.get(
                        timeout=self._upstream_timeout * 2
                    )
                except queue_mod.Empty:
                    return
                if up is not None:
                    up.close()

        threading.Thread(
            target=drain, name="router-hedge-drain", daemon=True
        ).start()

    # ----------------------------------------------------------- stream

    def _proxy_stream(
        self, handler, body, prompt, trace_id, deadline_s=None, tr=None,
        handoff=None,
    ) -> None:
        """SSE passthrough wrapper: register the stream's migration
        handle (the planner flags it through this registry), relay, and
        always unregister — a dead handler thread must never leave a
        ghost stream for the planner to keep planning against."""
        # The affinity-horizon slice (block x max-blocks leading tokens)
        # is the stream's hot-prefix identity for the fabric replicator:
        # shared system prompts collapse to one census entry.
        horizon = (
            self.policy.prefix_block_tokens * self.policy.prefix_max_blocks
        )
        ctl = _StreamCtl(
            trace_id, self.policy.key_of(prompt), tuple(prompt[:horizon])
        )
        with self._streams_lock:
            self._streams[trace_id] = ctl
        try:
            self._relay_stream(
                handler, body, prompt, trace_id, deadline_s, tr, ctl,
                handoff=handoff,
            )
        finally:
            with self._streams_lock:
                self._streams.pop(trace_id, None)

    def _relay_stream(
        self, handler, body, prompt, trace_id, deadline_s, tr, ctl,
        handoff=None,
    ) -> None:
        """SSE passthrough with zero-drop mid-stream failover AND
        planned migration.

        Token events are re-emitted with a GLOBAL index (continuations
        restart at 0 upstream); the final done event carries every
        token the client was streamed.  A replica dying mid-stream
        triggers resubmission of ``prompt + emitted`` with the
        remaining budget to the next ring replica — the client stream
        never breaks unless every replica is gone or the failover/retry
        budget is spent.  A client deadline bounds the whole attempt
        budget (dial, retry sleeps, failovers) and rides every upstream
        dial as a re-stamped ``X-Request-Deadline``.

        Planned migration rides the same resubmission: when
        the planner flags ``ctl.migrate_to``, the relay — at a PACED
        token boundary only, never mid-token-burst — validates the
        target (eligibility + breaker; abort otherwise), ends the
        current leg cleanly (``migrated``, no breaker failure: the
        source is healthy, just hot), and dials the target with
        ``prompt + emitted`` under the same rid.  The source engine
        sees a client disconnect and frees its slot/pages; the client
        sees one uninterrupted stream."""
        max_new = int(body.get("max_new_tokens", 16))
        emitted: list = []
        headers_sent = False
        exclude: set = set()
        failovers = 0
        attempt = 0
        sleeps = 0
        retry_after: Optional[float] = None
        t0 = time.monotonic()
        deadline = t0 + (
            self._timeout
            if deadline_s is None
            else min(self._timeout, deadline_s)
        )
        upstream_deadline = deadline if deadline_s is not None else None
        first_token_at: Optional[float] = None
        # Planned migration state: `migrate_target` carries a validated
        # (breaker-acquired) target from the event boundary that ended
        # the previous leg into the next loop iteration's dial;
        # `last_token_t` feeds the paced-boundary gate (never move
        # mid-token-burst).
        migrate_target: Optional[str] = None
        last_token_t: Optional[float] = None

        def client_error(message: str) -> None:
            if headers_sent:
                self._sse(handler, {"error": message, "trace_id": trace_id})
            else:
                handler._reply(
                    503, {"error": message, "trace_id": trace_id}, trace_id,
                    retry_after="1",
                )

        while True:
            if time.monotonic() >= deadline:
                if deadline_s is not None:
                    self.metrics.requests.inc(outcome="deadline")
                    if tr:
                        tr.set(outcome="deadline")
                    self._record(
                        "router.deadline_exceeded",
                        where="stream",
                        emitted=len(emitted),
                        rid=trace_id,
                    )
                    client_error("deadline exceeded")
                    return
                self.metrics.requests.inc(outcome="timeout")
                if tr:
                    tr.set(outcome="timeout")
                client_error("generation timed out")
                return
            migration_leg = False
            if migrate_target is not None:
                # Planned move: the target was validated (breaker slot
                # acquired) at the token boundary that ended the old
                # leg — dial it directly.  No candidate walk, and no
                # retry-budget spend: planned moves are paced by the
                # planner's own migration budget, never by the fault
                # budget.
                name, placement = migrate_target, MIGRATION
                migrate_target = None
                migration_leg = True
            else:
                route_t0 = time.monotonic()
                picked = self._next_candidate(prompt, exclude, attempt)
                self._span_route(tr, route_t0, picked, exclude)
                if picked is None:
                    if exclude:
                        # Same Retry-After floor as the unary restart: a
                        # fleet-wide overload shed must back the stream
                        # off, not hammer-loop the ring.
                        exclude.clear()
                        if retry_after is not None:
                            delay = self._backoff(sleeps, retry_after)
                            sleeps += 1
                            if (
                                sleeps > 16
                                or time.monotonic() + delay >= deadline
                            ):
                                self.metrics.requests.inc(outcome="error")
                                client_error("no replica available")
                                return
                            time.sleep(delay)
                            retry_after = None
                        continue
                    delay = self._backoff(sleeps, retry_after)
                    sleeps += 1
                    if sleeps > 16 or time.monotonic() + delay >= deadline:
                        self.metrics.requests.inc(outcome="error")
                        client_error("no replica available")
                        return
                    time.sleep(delay)
                    retry_after = None
                    continue
                name, placement = picked
            if attempt > 0 and not migration_leg:
                if not self.budget.try_spend():
                    self._record(
                        "router.retry_budget_exhausted",
                        replica=name,
                        rid=trace_id,
                    )
                    self.metrics.requests.inc(outcome="error")
                    if tr:
                        tr.set(outcome="error")
                    client_error("retry budget exhausted")
                    return
                if not emitted:
                    self.metrics.retries.inc()
                    self._record(
                        "router.retry",
                        replica=name,
                        attempt=attempt,
                        rid=trace_id,
                    )
            attempt += 1
            st = self.replicas.get(name)
            if st is None:
                # Membership changed under the leg (DNS reconciliation
                # removed it between selection and dial): skip it.
                if migration_leg:
                    self._migration_aborted(trace_id, name, "removed")
                exclude.add(name)
                continue
            upstream_body = dict(body)
            upstream_body["prompt"] = prompt + emitted
            upstream_body["max_new_tokens"] = max_new - len(emitted)
            # One leg = one attempt span; its id rides the dial's
            # X-Trace-Context so the replica's tree roots under it.
            # Every leg after a mid-stream death is a failover
            # resubmission (even one that died before emitting — the
            # resubmitted prompt is just the original); the leg whose
            # relay dies records outcome "died", which is exactly what
            # tpu_router_failovers_total meters — the assembler's
            # attempt-count cross-check.
            leg_kind = (
                "migration"
                if migration_leg
                else "failover"
                if failovers
                else ("retry" if attempt > 1 else "primary")
            )
            attempt_idx, leg_span = (
                tr.begin_attempt() if tr else (0, 0)
            )
            leg_t0 = time.monotonic()
            try:
                up = self._dial(
                    name, upstream_body, trace_id, True, upstream_deadline,
                    hop_header=tr.header(leg_span, attempt_idx)
                    if tr
                    else None,
                    handoff=handoff,
                )
            except (failpoints.FailpointError, *_CONN_ERRORS) as e:
                st.failures += 1
                st.breaker.record_failure()
                self._span_attempt(
                    tr, leg_span, leg_t0, name, attempt_idx, leg_kind,
                    outcome="conn_error", error=type(e).__name__,
                )
                self._record(
                    "router.dispatch_error",
                    replica=name,
                    error=str(e),
                    rid=trace_id,
                )
                if migration_leg:
                    # The planned target refused the dial: the move
                    # aborts and the ordinary machinery resubmits the
                    # stream wherever the ring says — still zero-drop.
                    self._migration_aborted(trace_id, name, "dial_error")
                exclude.add(name)
                continue
            if up.resp.status == 503:
                up_headers = dict(up.resp.getheaders())
                ra = up_headers.get("Retry-After")
                retry_after = float(ra) if ra else retry_after
                up.close()
                shed = up_headers.get("X-Shed")
                self._span_attempt(
                    tr, leg_span, leg_t0, name, attempt_idx, leg_kind,
                    status=503, outcome="shed" if shed else "draining",
                )
                if shed:
                    # Overload shed: healthy replica, keep in rotation.
                    self._record(
                        "router.replica_shed",
                        replica=name,
                        shed=shed,
                        retry_after=ra,
                        rid=trace_id,
                    )
                else:
                    self._mark_draining(name, True)
                if migration_leg:
                    self._migration_aborted(
                        trace_id, name, "shed" if shed else "draining"
                    )
                exclude.add(name)
                continue
            if up.resp.status == 409 and up.resp.getheader(
                PREFILL_NEEDED_HEADER
            ):
                missing = up.resp.getheader(PREFILL_NEEDED_HEADER)
                up.resp.read()
                up.close()
                self._span_attempt(
                    tr, leg_span, leg_t0, name, attempt_idx, leg_kind,
                    status=409, outcome="prefill_needed",
                )
                self._prefill_needed(name, trace_id, missing)
                if migration_leg:
                    self._migration_aborted(trace_id, name, "prefill_needed")
                exclude.add(name)
                continue
            if up.resp.status != 200:
                data = up.resp.read()
                self._span_attempt(
                    tr, leg_span, leg_t0, name, attempt_idx, leg_kind,
                    status=up.resp.status, outcome="error",
                )
                if migration_leg:
                    # The stream was HEALTHY before the planned move —
                    # a target verdict must never kill it.  Abort the
                    # move and resubmit through the ordinary ring walk.
                    up.close()
                    self._migration_aborted(
                        trace_id, name, f"http_{up.resp.status}"
                    )
                    exclude.add(name)
                    continue
                if headers_sent:
                    up.close()
                    self.metrics.requests.inc(outcome="error")
                    if tr:
                        tr.set(outcome="error")
                    client_error(f"replica HTTP {up.resp.status}")
                    return
                handler.send_response(up.resp.status)
                handler.send_header("Content-Type", "application/json")
                handler.send_header("X-Request-Id", trace_id)
                handler.send_header("Content-Length", str(len(data)))
                handler.end_headers()
                try:
                    handler.wfile.write(data)
                except OSError:
                    pass
                up.close()
                self.metrics.requests.inc(outcome="error")
                if tr:
                    tr.set(outcome="error")
                return
            st.dispatches += 1
            ctl.replica = name  # the planner ranks streams by home
            if migration_leg:
                # The move landed: the target accepted the resubmission
                # and the relay continues there.  (A later death on the
                # target is ordinary failover, separately metered.)
                self.metrics.migrations.inc(outcome="done")
                self._record(
                    "router.migration_done",
                    rid=trace_id,
                    target=name,
                    emitted=len(emitted),
                )
            if not headers_sent:
                handler.send_response(200)
                handler.send_header("Content-Type", "text/event-stream")
                handler.send_header("Cache-Control", "no-cache")
                handler.send_header("X-Request-Id", trace_id)
                handler.end_headers()
                headers_sent = True
                self.metrics.placements.inc(placement=placement)
                if tr:
                    tr.set(placement=placement)
            done = False
            leg_tokens = 0  # tokens relayed by THIS leg (attempt attrs)

            def end_leg(outcome: str) -> None:
                # The leg's attempt span covers dial → relay end: TTFB
                # and SSE relay in one timed child, the relayed-token
                # count in its attrs.
                self._span_attempt(
                    tr, leg_span, leg_t0, name, attempt_idx, leg_kind,
                    status=200, outcome=outcome, tokens=leg_tokens,
                )

            try:
                for event in self._iter_sse(up.resp):
                    if event is None:  # heartbeat comment
                        try:
                            handler.wfile.write(b": ping\n\n")
                            handler.wfile.flush()
                        except OSError:
                            up.close()
                            end_leg("client_gone")
                            return  # client vanished; upstream cancels
                        continue
                    if "token" in event:
                        token_t = time.monotonic()
                        if first_token_at is None:
                            first_token_at = token_t
                            self._ttft_rolling.add(first_token_at - t0)
                            self.metrics.ttft_seconds.observe(
                                first_token_at - t0
                            )
                        token_gap = (
                            token_t - last_token_t
                            if last_token_t is not None
                            else None
                        )
                        last_token_t = token_t
                        out = dict(event)
                        out["index"] = len(emitted)
                        out["trace_id"] = trace_id
                        emitted.append(event["token"])
                        leg_tokens += 1
                        ctl.emitted = len(emitted)
                        try:
                            self._sse(handler, out)
                        except OSError:
                            up.close()
                            end_leg("client_gone")
                            return
                        # Planned migration fires ONLY at a paced token
                        # boundary: a measured inter-token gap at/above
                        # the burst threshold means single-token decode
                        # cadence — never mid-token-burst (a blocked
                        # decode round's tokens arrive back-to-back; a
                        # deferred flag is simply re-checked at the
                        # next token).
                        want = ctl.migrate_to
                        if (
                            want is not None
                            and token_gap is not None
                            and token_gap >= self._migration_burst_gap
                            and len(emitted) < max_new
                        ):
                            ctl.migrate_to = None
                            if self._acquire_migration_target(want):
                                migrate_target = want
                                break  # end this leg at the boundary
                            self._migration_aborted(
                                trace_id, want, "target_ineligible"
                            )
                        continue
                    if event.get("done"):
                        fin = dict(event)
                        fin["tokens"] = list(emitted)
                        fin["trace_id"] = trace_id
                        if failovers:
                            # Per-token logprobs cannot be stitched
                            # across a failover; drop rather than lie.
                            fin.pop("logprobs", None)
                        try:
                            self._sse(handler, fin)
                        except OSError:
                            pass
                        done = True
                        break
                    if "error" in event:
                        # The REPLICA gave up (its own request timeout):
                        # a deterministic verdict, relayed not retried.
                        out = dict(event)
                        out["trace_id"] = trace_id
                        try:
                            self._sse(handler, out)
                        except OSError:
                            pass
                        up.close()
                        end_leg("relay_error")
                        self.metrics.requests.inc(outcome="error")
                        if tr:
                            tr.set(outcome="error")
                        return
            except (*_CONN_ERRORS, ValueError):
                pass  # transport death mid-stream; handled below
            up.close()
            if migrate_target is not None:
                # Planned move: this leg ends CLEANLY — "migrated", not
                # "died".  No breaker failure and no failover metric
                # (the source is healthy, just hot); closing the
                # upstream makes the source engine see a client
                # disconnect and cancel, freeing its slot and pages.
                # The loop re-dials `migrate_target` with
                # prompt + emitted under the same rid.
                end_leg("migrated")
                continue
            if done:
                end_leg("done")
                st.breaker.record_success()
                elapsed = time.monotonic() - t0
                self.metrics.request_seconds.observe(elapsed)
                self.metrics.requests.inc(outcome="ok")
                if tr:
                    tr.set(outcome="ok", failovers=failovers)
                return
            # Transport error or EOF before `done`: either way the
            # replica died mid-stream.  Fail the stream over.
            end_leg("died")
            st.failures += 1
            st.breaker.record_failure()
            failovers += 1
            if failovers > self._max_failovers:
                self.metrics.requests.inc(outcome="error")
                if tr:
                    tr.set(outcome="error", failovers=failovers)
                client_error("failover budget exhausted")
                return
            self.metrics.failovers.inc()
            self._record(
                "router.failover",
                replica=name,
                emitted=len(emitted),
                remaining=max_new - len(emitted),
                rid=trace_id,
            )
            if len(emitted) >= max_new:
                # Nothing left to generate: the death landed after the
                # last token — finish the stream ourselves.
                fin = {
                    "done": True,
                    "tokens": list(emitted),
                    "trace_id": trace_id,
                }
                try:
                    self._sse(handler, fin)
                except OSError:
                    pass
                self.metrics.requests.inc(outcome="ok")
                if tr:
                    tr.set(outcome="ok", failovers=failovers)
                return
            exclude.add(name)

    @staticmethod
    def _sse(handler, obj: dict) -> None:
        handler.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
        handler.wfile.flush()

    @staticmethod
    def _iter_sse(resp):
        """Yield parsed ``data:`` events from an upstream SSE response;
        ``None`` for heartbeat comments.  Returns on EOF (the caller
        decides whether that EOF was a clean close or a death)."""
        while True:
            line = resp.readline()
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            if line.startswith(b":"):
                yield None
                continue
            if line.startswith(b"data:"):
                yield json.loads(line[5:].strip())

    # -------------------------------------------------------- lifecycle

    def snapshot(self) -> dict:
        """JSON-safe router state for /debug/router."""
        return {
            "draining": self._draining.is_set(),
            "active_requests": self._active,
            "policy": {
                "mode": self.policy.mode,
                "overflow_depth": self.policy.overflow_depth,
                "prefix_block_tokens": self.policy.prefix_block_tokens,
                "prefix_max_blocks": self.policy.prefix_max_blocks,
            },
            "ring": self.ring.snapshot(),
            "disagg": (
                self.disagg.snapshot()
                if self.disagg is not None
                else {"enabled": False}
            ),
            "retry_budget": round(self.budget.available(), 2),
            "retry_budget_spent": self.budget.spent_total,
            "retry_budget_exhausted": self.budget.exhausted_total,
            "replicas": {
                name: st.snapshot() for name, st in self.replicas.items()
            },
        }

    def start(self) -> "RouterServer":
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="router-poll", daemon=True
        )
        self._poll_thread.start()
        # First poll before serving: no cold blind spot.  It runs ON the
        # poll thread (the poll-state owner); start() just waits for it.
        self._first_poll.wait(
            timeout=self._poll_timeout * (len(self.replicas) + 1) + 2.0
        )
        self._http_thread = threading.Thread(
            # 50ms shutdown poll (vs the 0.5s default): drains and test
            # teardowns should not stall on the accept loop.
            target=lambda: self._httpd.serve_forever(poll_interval=0.05),
            name="router-http",
            daemon=True,
        )
        self._http_thread.start()
        if self.prober is not None:
            self.prober.start()
        return self

    def begin_drain(self, grace_s: float = 10.0) -> None:
        """SIGTERM path: stop admitting (503 + Retry-After, /healthz →
        draining), wait for in-flight proxied requests to finish (at
        most ``grace_s``), then set :attr:`drained`.  Idempotent."""
        if self._draining.is_set():
            return
        self._draining.set()
        self._record("router.drain_begin_self", grace_s=grace_s)

        def watch():
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline:
                with self._active_lock:
                    if self._active == 0:
                        break
                time.sleep(0.05)
            self._record(
                "router.drain_end_self", cut_requests=self._active
            )
            self.drained.set()

        threading.Thread(
            target=watch, name="router-drain", daemon=True
        ).start()

    def stop(self) -> None:
        self._stop.set()
        if self.prober is not None:
            self.prober.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)

    def serve_forever(self) -> None:
        try:
            while not self._stop.is_set():
                self._stop.wait(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def main(argv: Optional[list[str]] = None) -> None:
    """Router daemon entry (`python -m k8s_device_plugin_tpu_torch.router`):
    deploy/k8s-deploy-router-gpu.yaml runs this in front of the serve
    replicas."""
    import argparse
    import sys

    from ..utils import flight as flight_mod

    p = argparse.ArgumentParser(prog="tpu-serving-router")
    p.add_argument(
        "--replicas",
        default="",
        help="comma-separated host:port serving replicas (static set)",
    )
    p.add_argument(
        "--replicas-dns",
        default="",
        help="name:port of a HEADLESS Service over the serving replicas: "
        "A records are re-resolved every poll interval and ring "
        "membership reconciled — replicas scale without a router restart",
    )
    p.add_argument("--http-port", type=int, default=8100)
    p.add_argument(
        "--prefix-block-tokens",
        type=int,
        default=16,
        help="tokens per prefix block in the affinity key (match the "
        "replicas' --page-size so one block is one KV page)",
    )
    p.add_argument(
        "--prefix-blocks",
        type=int,
        default=4,
        help="leading blocks hashed into the affinity key (the shared "
        "system-prompt horizon; the unique tail stays out of the key)",
    )
    p.add_argument("--vnodes", type=int, default=64)
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument(
        "--overflow-depth",
        type=int,
        default=4,
        help="queue-depth gap (home vs least-loaded) beyond which a "
        "request overflows along the ring instead of joining the hot "
        "shard",
    )
    p.add_argument("--breaker-failures", type=int, default=3)
    p.add_argument("--breaker-open-s", type=float, default=5.0)
    p.add_argument("--retry-budget", type=float, default=32.0)
    p.add_argument("--retry-refill", type=float, default=2.0)
    p.add_argument(
        "--hedge",
        type=int,
        choices=[0, 1],
        default=1,
        help="hedged dispatch for unary requests: when no response "
        "lands within the rolling TTFT p99, race a second replica; "
        "first response wins, loser cancelled (costs retry budget)",
    )
    p.add_argument("--hedge-min-s", type=float, default=0.25)
    p.add_argument("--max-failovers", type=int, default=3)
    p.add_argument(
        "--migrate",
        type=int,
        choices=[0, 1],
        default=1,
        help="proactive planned migration (router/migration.py, default "
        "on): when a replica's queue-wait EWMA runs sustained-hot while "
        "a peer runs cold, live streams of its hottest prefix-block "
        "sessions are resubmitted to the cold peer through the zero-drop "
        "failover machinery — paced by a migration budget, never "
        "mid-token-burst, aborted if the target's breaker refuses; 0 "
        "leaves only reactive failover",
    )
    p.add_argument(
        "--migrate-hot-wait",
        type=float,
        default=2.0,
        help="queue-wait pressure (seconds) at/above which a replica "
        "counts as hot for migration/scale planning",
    )
    p.add_argument(
        "--migrate-cold-wait",
        type=float,
        default=0.5,
        help="queue-wait pressure (seconds) at/below which a replica is "
        "a cold migration target",
    )
    p.add_argument(
        "--migrate-sustain",
        type=int,
        default=3,
        help="consecutive hot summary polls before a replica counts as "
        "SUSTAINED hot (one bursty poll never triggers a migration)",
    )
    p.add_argument(
        "--migrate-budget",
        type=float,
        default=4.0,
        help="migration token bucket: burst cap on planned moves "
        "(each flagged stream spends one token)",
    )
    p.add_argument(
        "--migrate-refill",
        type=float,
        default=1.0,
        help="migration budget refill rate (moves per second) — the "
        "sustained pacing knob",
    )
    p.add_argument(
        "--disagg",
        type=int,
        choices=[0, 1],
        default=0,
        help="disaggregated prefill/decode routing (router/disagg.py, "
        "docs/disagg.md): classify requests by prompt-length threshold "
        "x decode-pool pressure, stamp long prompts with an "
        "X-Handoff-Source prefill locator (the decode replica pulls "
        "the KV prefix over POST /v1/prefill), and fall back to "
        "unified dispatch whenever the prefill pool is down; requires "
        "prefill-role replicas (--prefill-replicas, or summary-poll "
        "role discovery)",
    )
    p.add_argument(
        "--disagg-threshold",
        type=int,
        default=256,
        help="prompt length (tokens) at/above which a request's "
        "prefill dispatches to the prefill pool while the decode pool "
        "is calm",
    )
    p.add_argument(
        "--disagg-hot-threshold",
        type=int,
        default=64,
        help="the lower split bar that applies while the decode pool "
        "runs hot (pressure >= --disagg-hot-wait)",
    )
    p.add_argument(
        "--disagg-hot-wait",
        type=float,
        default=0.5,
        help="decode-pool queue-wait pressure (seconds, max over "
        "eligible replicas) at/above which the hot threshold applies",
    )
    p.add_argument(
        "--prefill-replicas",
        default="",
        help="comma-separated host:port replicas that are prefill-role "
        "from the start (polled like any replica, never on the "
        "/generate ring); replicas discovered via --replicas/-dns "
        "whose summary reports role=prefill are reconciled the same "
        "way",
    )
    p.add_argument(
        "--slo",
        type=int,
        choices=[0, 1],
        default=1,
        help="fleet SLO plane (utils/slo.py, default on): merge the "
        "per-replica SLI counters each summary poll carries into "
        "fleet-level sliding-window burn rates, evaluate the "
        "multi-window fast-burn/slow-burn alert rules every sweep "
        "(slo.burn_alert flight events + direct incidents + "
        "tpu_slo_burn_rate gauges), and serve the fleet view at GET "
        "/debug/slo; 0 disables fleet SLO accounting",
    )
    p.add_argument(
        "--canary",
        type=int,
        choices=[0, 1],
        default=0,
        help="active correctness plane (router/prober.py, "
        "docs/operations.md \"Active probing\"): continuously probe "
        "every replica with seeded deterministic canary prompts, "
        "verdict bit-exactness against oracles captured from the "
        "fleet's own first clean response per params fingerprint, "
        "detect summary-counter staleness, and serve GET /debug/canary",
    )
    p.add_argument(
        "--canary-interval",
        type=float,
        default=5.0,
        help="seconds between canary sweeps (every replica probed once "
        "per sweep; the probe budget IS the overhead budget — the "
        "serving bench pins it at <=1%% of throughput)",
    )
    p.add_argument(
        "--canary-tokens",
        type=int,
        default=4,
        help="new tokens per canary probe",
    )
    p.add_argument(
        "--canary-k",
        type=int,
        default=3,
        help="consecutive bit-exactness mismatches before the "
        "canary.mismatch incident and auto-fence (one blip never acts)",
    )
    p.add_argument(
        "--canary-stale-sweeps",
        type=int,
        default=5,
        help="consecutive sweeps with a frozen requests_total summary "
        "counter (while probes land) before the canary.stale incident",
    )
    p.add_argument(
        "--canary-fence",
        type=int,
        choices=[0, 1],
        default=1,
        help="auto-fence policy: 1 = a confirmed mismatch POSTs the "
        "replica's /debug/fence so the fenced-demotion machinery "
        "drains it; 0 = observe-only (incidents still fire)",
    )
    p.add_argument(
        "--fabric",
        type=int,
        choices=[0, 1],
        default=0,
        help="fleet-wide content-addressed KV fabric (router/fabric.py, "
        "docs/routing.md \"Fleet KV fabric\"): parse each replica's "
        "bloom prefix digest off the summary poll, stamp the best "
        "advertised owner as a resident-only X-Handoff-Source on every "
        "dial whose prompt prefix is non-resident at the target (the "
        "target pulls the KV pages peer-to-peer instead of re-running "
        "the prefill), and run the K-replica hot-prefix "
        "replication/eviction sweep each poll tick; requires the "
        "replicas to run with --enable-admin for the replication "
        "pull/drop endpoints",
    )
    p.add_argument(
        "--fabric-k",
        type=int,
        default=2,
        help="target replication factor for hot prefixes (copies are "
        "planned until this many replicas advertise the prefix)",
    )
    p.add_argument(
        "--fabric-hot-wait",
        type=float,
        default=2.0,
        help="owner queue-wait pressure (seconds) at/above which its "
        "hot prefixes are proactively replicated",
    )
    p.add_argument(
        "--fabric-cold-wait",
        type=float,
        default=0.5,
        help="replication-target pressure ceiling (seconds) — copies "
        "only land on replicas with cold headroom",
    )
    p.add_argument(
        "--fabric-hot-score",
        type=float,
        default=2.0,
        help="minimum hotness (live streams x full prefix pages) "
        "before a prefix is worth replicating",
    )
    p.add_argument(
        "--fabric-actions",
        type=int,
        default=2,
        help="replication/eviction actions fired per poll sweep, "
        "fleet-wide (the pacing bound)",
    )
    p.add_argument(
        "--postmortem",
        type=int,
        choices=[0, 1],
        default=0,
        help="fleet postmortem collector (router/postmortem.py, "
        "docs/operations.md \"Postmortem archaeology\"): on any "
        "incident — a replica's incidents_total cursor advancing on "
        "the summary poll, or the router's own SLO/canary monitors "
        "firing — fan out to every replica's (plus the plugin "
        "daemon's and controller's, when given) /debug/flight, "
        "/debug/spans, /debug/state, and /metrics, and write ONE "
        "fleet evidence bundle under --dump-dir for "
        "tools/postmortem.py to classify; served at GET "
        "/debug/postmortem, manual capture via the admin-gated POST "
        "/debug/postmortem/capture",
    )
    p.add_argument(
        "--postmortem-plugin-url",
        default="",
        help="host:port of the plugin daemon's metrics server — its "
        "forensic endpoints join every fleet bundle",
    )
    p.add_argument(
        "--postmortem-controller-url",
        default="",
        help="host:port of the fleet controller's debug server — its "
        "forensic endpoints join every fleet bundle",
    )
    p.add_argument(
        "--postmortem-debounce",
        type=float,
        default=120.0,
        help="per-episode capture debounce (seconds): however many "
        "incidents an episode re-fires, one bundle per window",
    )
    p.add_argument(
        "--postmortem-admin",
        type=int,
        choices=[0, 1],
        default=0,
        help="1 arms the manual POST /debug/postmortem/capture "
        "endpoint (same opt-in posture as the replicas' "
        "--enable-admin)",
    )
    p.add_argument(
        "--dump-budget-mb",
        type=int,
        default=0,
        help="retention budget (MiB) for --dump-dir, shared by flight "
        "dumps and postmortem bundles: after every write the oldest "
        "entries are pruned until the directory fits (0 = unbounded)",
    )
    p.add_argument("--request-timeout", type=float, default=600.0)
    p.add_argument(
        "--policy",
        choices=["affinity", "random"],
        default="affinity",
        help="random = uniform placement control (what the serving "
        "benchmark diffs affinity against)",
    )
    p.add_argument("--drain-grace", type=float, default=10.0)
    p.add_argument("--flight-ring", type=int, default=2048)
    p.add_argument(
        "--span-ring",
        type=int,
        default=2048,
        help="capacity of the router's request-span ring (route "
        "selection, per-attempt dial/TTFB, SSE relay, failover legs) "
        "served at GET /debug/spans and embedded in flight dumps — "
        "tools/trace_assemble.py joins it with the replicas' rings "
        "into per-request fleet timelines",
    )
    p.add_argument(
        "--dump-dir", default=flight_mod.default_dump_dir() or ""
    )
    p.add_argument("--failpoints", default="")
    args = p.parse_args(argv)
    replicas = [r for r in args.replicas.split(",") if r]
    if not replicas and not args.replicas_dns:
        raise SystemExit("need --replicas and/or --replicas-dns")
    box = flight_mod.register(
        flight_mod.FlightRecorder(capacity=args.flight_ring, name="router")
    )
    # The span ring rides the same SIGUSR2/atexit dumps the flight
    # recorder does: a dead router still leaves the per-request
    # timelines tools/trace_assemble.py needs on disk.
    spans = flight_mod.register_spans(
        SpanRecorder(capacity=args.span_ring, name="router")
    )
    flight_mod.install_dump_handlers(args.dump_dir or None)
    if args.dump_budget_mb:
        flight_mod.set_dump_budget(args.dump_budget_mb * 1024 * 1024)
    failpoints.set_flight(box)
    failpoints.arm_from_env()
    if args.failpoints:
        failpoints.arm_spec(args.failpoints)
    server = RouterServer(
        replicas,
        port=args.http_port,
        flight=box,
        spans=spans,
        prefix_block_tokens=args.prefix_block_tokens,
        prefix_max_blocks=args.prefix_blocks,
        vnodes=args.vnodes,
        poll_interval_s=args.poll_interval,
        overflow_depth=args.overflow_depth,
        breaker_failures=args.breaker_failures,
        breaker_open_s=args.breaker_open_s,
        retry_budget=args.retry_budget,
        retry_refill_per_s=args.retry_refill,
        hedge=bool(args.hedge),
        hedge_min_s=args.hedge_min_s,
        max_failovers=args.max_failovers,
        request_timeout_s=args.request_timeout,
        policy_mode=args.policy,
        replicas_dns=args.replicas_dns or None,
        disagg=bool(args.disagg),
        disagg_config=DisaggConfig(
            threshold_tokens=args.disagg_threshold,
            # The hot bar can never sit above the calm bar; clamp so a
            # lone --disagg-threshold below the default hot bar keeps
            # working ("split everything past N, hot or not").
            hot_threshold_tokens=min(
                args.disagg_hot_threshold, args.disagg_threshold
            ),
            hot_wait_s=args.disagg_hot_wait,
        ),
        prefill_replicas=[
            r for r in args.prefill_replicas.split(",") if r
        ],
        slo=bool(args.slo),
        canary=bool(args.canary),
        canary_config=CanaryConfig(
            interval_s=args.canary_interval,
            probe_tokens=args.canary_tokens,
            k_mismatch=args.canary_k,
            stale_sweeps=args.canary_stale_sweeps,
            fence=bool(args.canary_fence),
        ),
        migrate=bool(args.migrate),
        migration=MigrationConfig(
            hot_wait_s=args.migrate_hot_wait,
            cold_wait_s=args.migrate_cold_wait,
            sustain_polls=args.migrate_sustain,
            budget=args.migrate_budget,
            refill_per_s=args.migrate_refill,
        ),
        postmortem=bool(args.postmortem),
        postmortem_dir=args.dump_dir or None,
        postmortem_plugin_url=args.postmortem_plugin_url or None,
        postmortem_controller_url=args.postmortem_controller_url or None,
        postmortem_debounce_s=args.postmortem_debounce,
        postmortem_budget_bytes=(
            args.dump_budget_mb * 1024 * 1024
            if args.dump_budget_mb
            else None
        ),
        postmortem_admin=bool(args.postmortem_admin),
        fabric=bool(args.fabric),
        fabric_config=FabricConfig(
            replicate_k=args.fabric_k,
            hot_wait_s=args.fabric_hot_wait,
            cold_wait_s=args.fabric_cold_wait,
            hot_score=args.fabric_hot_score,
            max_actions_per_sweep=args.fabric_actions,
            default_page_size=args.prefix_block_tokens,
        ),
    ).start()

    import signal

    def _on_signal(signum, _frame):
        print(
            f"received {signal.Signals(signum).name}; draining "
            f"(grace {args.drain_grace:.1f}s)",
            file=sys.stderr,
            flush=True,
        )
        server.begin_drain(args.drain_grace)
        server.drained.wait(args.drain_grace + 1.0)
        server.stop()

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
    except ValueError:
        pass
    print(
        f"routing on :{server.port} over {len(server.replicas)} replicas "
        "(POST /generate, GET /healthz /metrics /debug/router "
        "/debug/fleet /debug/slo /debug/fabric /debug/canary "
        "/debug/postmortem /debug/spans)",
        file=sys.stderr,
        flush=True,
    )
    server.serve_forever()


if __name__ == "__main__":
    main()
