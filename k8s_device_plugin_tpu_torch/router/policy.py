"""Replica state + the placement policy (affinity, overflow, failover).

The port's own copy of the reference's ``router/policy.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The policy answers one question per request: in what order should the
router try the replicas?  The answer composes three signals:

- **ring affinity** (`ring.py`): the prompt's prefix-block key names a
  home replica whose KV tiers likely hold the prefix; the ring order
  after it is the deterministic failover sequence.
- **liveness/drain state** (this module, fed by the poll loop): a
  draining replica takes NO new assignments (its in-flight streams keep
  running — the `begin_drain()` rollout contract), an unreachable one
  sorts last (poll state may be stale; it is still dialed as a final
  resort, where its breaker decides).
- **queue depth** (read from ``/debug/state?summary=1``): affinity is a
  preference, not a law — when the home replica's queue is
  ``overflow_depth`` deeper than the least-loaded eligible replica, the
  request overflows along the ring instead of piling onto a hot shard.

Breaker state is deliberately NOT consulted here: `try_acquire()` has
side effects (it consumes the half-open probe slot), so the dispatch
loop in server.py applies it per dial attempt.

``mode="random"`` is the control policy the serving benchmark uses to
measure what affinity buys (uniform seeded placement over the same
eligible set, same failover semantics).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from .breaker import CircuitBreaker
from .ring import HashRing, prefix_key

# Placement tags (tpu_router_placements_total label values).
HOME = "home"
OVERFLOW = "overflow"
RANDOM = "random"
FAILOVER = "failover"
# Planned migration (router/migration.py): a live stream moved OFF a
# sustained-hot replica by the planner — the proactive cousin of
# `failover`, same zero-drop resubmission, different cause.
MIGRATION = "migration"


class ReplicaState:
    """One replica's router-side view: address, poll-derived load/drain
    state, and its circuit breaker.  Mutable fields are plain scalars
    read racily by dispatch (GIL-atomic; a one-poll-stale read is by
    design).  The poll-derived fields are owner-thread-only by contract
    (annotated ``guarded by: owner-thread``): the router's poll loop
    mutates them off-lock, and any other thread — the request/stream
    paths marking a replica draining or fenced on failover — must hold
    the router lock, which serializes against the owner.
    ``RouterServer(racecheck=True)`` arms a racecheck.OwnerGuard that
    raises at any off-contract toucher (tests/test_router.py pins it)."""

    def __init__(self, name: str, breaker: CircuitBreaker):
        self.name = name  # "host:port" — the ring node AND dial target
        host, _, port = name.rpartition(":")
        self.host = host
        self.port = int(port)
        self.breaker = breaker
        # Disaggregation role off the summary poll (router/disagg.py):
        # prefill-role replicas serve POST /v1/prefill only and take NO
        # /generate assignments (candidates() excludes them; the server
        # keeps them off the affinity ring).
        self.role = "unified"  # guarded by: owner-thread
        self.reachable = True  # optimistic until a poll says otherwise; guarded by: owner-thread
        self.draining = False  # guarded by: owner-thread
        # Replica self-fencing (summary ``fenced``): a sick replica —
        # hung step, unhealthy chip, operator fence — is treated exactly
        # like a draining one (no new assignments, in-flight streams
        # fail over through the ordinary zero-drop path) until its
        # summary clears.
        self.fenced = False  # guarded by: owner-thread
        self.queue_depth = 0  # guarded by: owner-thread
        self.active_slots = 0  # guarded by: owner-thread
        # Host-side overload signals off the summary poll (queue-wait
        # EWMA + drain-rate forecast, engine_overload.py): what the
        # migration planner and the /debug/fleet scale signal read.
        # None until the replica exports them (no controller / no
        # traffic yet) — planners treat None as "no opinion".
        self.queue_wait_ewma_s = None  # guarded by: owner-thread
        self.drain_rate_rps = None  # guarded by: owner-thread
        # Cumulative per-objective [good, total] SLI counters off the
        # summary poll (utils/slo.py): the poll thread deltas them
        # against the previous poll into the router's fleet SLO tracker
        # (a shrunk counter = replica restart -> re-baselined from the
        # fresh totals).  None until the replica exports an SLO block.
        self.slo_totals = None  # guarded by: owner-thread
        # Replica process uptime off the summary poll (``uptime_s``):
        # the fleet controller's replica-minutes accounting and the
        # scale_down victim tie-breaker.  None until the replica
        # exports it; first_seen is the router-side fallback (when the
        # replica predates the field, age-since-registration still
        # bounds the bill).
        self.uptime_s = None  # guarded by: owner-thread
        # Cumulative anomaly-incident counter off the summary poll
        # (``incidents_total``): the fleet postmortem collector's
        # trigger cursor — an advance between polls means the replica
        # emitted an incident and its forensic state is worth
        # capturing NOW, before the rings roll.  None until the
        # replica exports the field (and on the first observation, so
        # joining a fleet with historical incidents never back-fires).
        self.incidents_total = None  # guarded by: owner-thread
        self.first_seen = time.monotonic()
        self.last_poll = 0.0  # last successful poll (monotonic); guarded by: owner-thread
        self.dispatches = 0
        self.failures = 0

    def snapshot(self) -> dict:
        return {
            "role": self.role,
            "reachable": self.reachable,
            "draining": self.draining,
            "fenced": self.fenced,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "queue_wait_ewma_s": self.queue_wait_ewma_s,
            "drain_rate_rps": self.drain_rate_rps,
            "slo_totals": self.slo_totals,
            "uptime_s": self.uptime_s,
            "age_s": round(time.monotonic() - self.first_seen, 3),
            "breaker": self.breaker.snapshot(),
            "dispatches": self.dispatches,
            "failures": self.failures,
            "last_poll_age_s": (
                round(time.monotonic() - self.last_poll, 3)
                if self.last_poll
                else None
            ),
        }


class RoutingPolicy:
    """Turns (prompt, replica states) into a dial order + placement tag.

    Thread-safe for the reads it does; ring membership changes go
    through the owning server's lock.
    """

    def __init__(
        self,
        ring: HashRing,
        replicas: dict[str, ReplicaState],
        *,
        overflow_depth: int = 4,
        prefix_block_tokens: int = 16,
        prefix_max_blocks: int = 4,
        mode: str = "affinity",
        seed: int = 0,
    ):
        if mode not in ("affinity", "random"):
            raise ValueError(f"unknown policy mode {mode!r}")
        if overflow_depth < 1:
            raise ValueError(f"overflow_depth must be >= 1, got {overflow_depth}")
        self.ring = ring
        self.replicas = replicas
        self.overflow_depth = overflow_depth
        self.prefix_block_tokens = prefix_block_tokens
        self.prefix_max_blocks = prefix_max_blocks
        self.mode = mode
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()

    def key_of(self, prompt) -> int:
        return prefix_key(
            prompt, self.prefix_block_tokens, self.prefix_max_blocks
        )

    def candidates(self, prompt) -> tuple[list[str], str]:
        """(ordered replica names, primary placement tag).

        Draining replicas are excluded outright (no new assignments —
        ever); unreachable ones are appended last as a stale-poll
        hedge.  The tag describes position 0 only; the dispatch loop
        tags anything after it ``failover``.
        """
        ring_order = self.ring.order(self.key_of(prompt))

        def _out(st: ReplicaState) -> bool:
            # Draining and fenced replicas take NO new assignments —
            # not even as a stale-poll hedge (a fenced replica answers
            # 503 by contract; dialing it just burns a retry token).
            # Prefill-role replicas never decode (/generate answers
            # 409 by contract — router/disagg.py).
            return st.draining or st.fenced or st.role == "prefill"

        eligible = [
            n
            for n in ring_order
            if not _out(self.replicas[n]) and self.replicas[n].reachable
        ]
        stale = [
            n
            for n in ring_order
            if not _out(self.replicas[n]) and not self.replicas[n].reachable
        ]
        if self.mode == "random":
            with self._rng_lock:
                self._rng.shuffle(eligible)
            return eligible + stale, RANDOM
        if not eligible:
            return stale, FAILOVER
        depths = {n: self.replicas[n].queue_depth for n in eligible}
        home = eligible[0]
        least = min(depths.values())
        if depths[home] - least >= self.overflow_depth:
            # Home is a hot shard: start at the least-loaded eligible
            # replica, keeping ring order after it (rotation preserves
            # the deterministic failover sequence).
            start = min(
                range(len(eligible)), key=lambda i: depths[eligible[i]]
            )
            rotated = eligible[start:] + eligible[:start]
            return rotated + stale, OVERFLOW
        return eligible + stale, HOME

    def min_wait_estimate_s(self, per_request_s: float) -> float:
        """The fleet's BEST-case queue forecast: the smallest
        (queue depth x router-measured per-request service time) over
        the non-draining reachable replicas.  The deadline fast-fail
        gate asks this before dispatching: when even the emptiest
        replica cannot answer inside the remaining budget, 504 now
        beats enqueueing work whose tokens will arrive too late.
        Conservatively 0.0 (always feasible) when nothing is polled or
        the service-time estimate is missing — fail-fast must never
        fire on a guess."""
        if per_request_s <= 0:
            return 0.0
        depths = [
            st.queue_depth
            for st in self.replicas.values()
            if st.reachable
            and not st.draining
            and not st.fenced
            and st.role != "prefill"
        ]
        if not depths:
            return 0.0
        return min(depths) * per_request_s
