"""Proactive planned migration + fleet scale signal.

The port's own copy of the reference's ``router/migration.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The router already REACTS well — breakers, failover, overload backoff —
but every hot session stays pinned to a saturating home replica until
something actually breaks.  This module is the *planning* half: it
watches the host-side overload signals every replica already exports on
its summary poll (queue-wait EWMA and drain-rate forecast — the
Host-Side Telemetry pattern: host-observable signals, not device
counters) and decides

- **when to migrate**: a replica running sustained-hot (queue-wait
  pressure above ``hot_wait_s`` for ``sustain_polls`` consecutive
  polls) while a peer runs cold (pressure at or below ``cold_wait_s``)
  gets its hottest prefix-block sessions PLANNED off — executed by the
  router through the same zero-drop resubmission machinery reactive
  failover uses (server.py), but paced by this planner's migration
  budget and never mid-token-burst; and
- **when to scale**: :func:`scale_recommendation` turns the same
  signals into a fleet-level scale-up/down/hold verdict, served at
  ``GET /debug/fleet`` and rendered by ``tools/fleet_plan.py``.

Pure policy, no I/O, injectable clock — the unit suite drives it with a
fake clock and hand-built signal rows (tests/test_router.py).  The
planner never *executes* anything: the router owns streams and dials;
this object only answers "move N sessions from X to Y now?".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class MigrationConfig:
    """Tunables for :class:`MigrationPlanner` (CLI: ``--migrate-*``)."""

    # A replica whose queue-wait pressure runs at/above this is hot.
    hot_wait_s: float = 2.0
    # A replica at/below this is a cold migration target.
    cold_wait_s: float = 0.5
    # Consecutive hot polls before the replica counts as SUSTAINED hot
    # (one bursty poll must never trigger a migration storm).
    sustain_polls: int = 3
    # Migration budget: a token bucket of planned moves — burst cap and
    # sustained pace.  Dry bucket = no plan, never a queue of plans.
    budget: float = 4.0
    refill_per_s: float = 1.0
    # Moves per plan() verdict (each spends one budget token).
    max_moves_per_plan: int = 2
    # Per-source cooldown between plans: let the last batch land and the
    # EWMA react before planning the same replica again.
    cooldown_s: float = 5.0


def replica_pressure(
    wait_ewma_s: Optional[float],
    drain_rate_rps: Optional[float],
    queue_depth: int,
) -> float:
    """One replica's queue-wait pressure in seconds: the measured
    queue-wait EWMA when the replica exports one, else the queue-depth /
    drain-rate forecast, else 0 (no data reads as cold — planners must
    never act on a guess, matching the overload controller's own
    degrade-to-no-opinion rule)."""
    if wait_ewma_s is not None:
        return float(wait_ewma_s)
    if drain_rate_rps and drain_rate_rps > 0:
        return queue_depth / drain_rate_rps
    return 0.0


class MigrationPlanner:
    """Sustained-hot detection + budget pacing over per-replica signal
    rows.  Feed one :meth:`observe` per replica per poll sweep, then ask
    :meth:`plan` for at most one (source, target, n_moves) verdict.

    Single-threaded by contract: the router's poll thread owns it (the
    same owner-thread discipline as ReplicaState's poll fields)."""

    def __init__(
        self,
        config: Optional[MigrationConfig] = None,
        *,
        now=time.monotonic,
    ):
        self.cfg = config or MigrationConfig()
        if self.cfg.hot_wait_s <= self.cfg.cold_wait_s:
            raise ValueError(
                "hot_wait_s must exceed cold_wait_s "
                f"({self.cfg.hot_wait_s} <= {self.cfg.cold_wait_s})"
            )
        if self.cfg.sustain_polls < 1:
            raise ValueError("sustain_polls must be >= 1")
        self._now = now
        self._tokens = float(self.cfg.budget)
        self._last_refill = now()
        # Per-replica: latest signal row + hot streak + last-planned.
        self._rows: dict[str, dict] = {}
        self._streaks: dict[str, int] = {}
        self._last_plan: dict[str, float] = {}
        self.plans_total = 0
        self.moves_planned_total = 0

    # -------------------------------------------------------- observation

    def observe(
        self,
        name: str,
        *,
        wait_ewma_s: Optional[float],
        drain_rate_rps: Optional[float],
        queue_depth: int,
        eligible: bool,
    ) -> None:
        """One poll row for ``name``.  ``eligible`` is the router's
        routability verdict (reachable, not draining/fenced): an
        ineligible replica is neither a source (its streams already
        fail over) nor a target, and its streak resets."""
        pressure = replica_pressure(
            wait_ewma_s, drain_rate_rps, queue_depth
        )
        self._rows[name] = {
            "pressure": pressure,
            "queue_depth": int(queue_depth),
            "eligible": bool(eligible),
        }
        if eligible and pressure >= self.cfg.hot_wait_s:
            self._streaks[name] = self._streaks.get(name, 0) + 1
        else:
            self._streaks[name] = 0

    def forget(self, name: str) -> None:
        """Membership removal: drop every trace of the replica."""
        self._rows.pop(name, None)
        self._streaks.pop(name, None)
        self._last_plan.pop(name, None)

    # ------------------------------------------------------------ planning

    def _refill(self) -> None:
        now = self._now()
        self._tokens = min(
            float(self.cfg.budget),
            self._tokens
            + (now - self._last_refill) * self.cfg.refill_per_s,
        )
        self._last_refill = now

    def sustained_hot(self, name: str) -> bool:
        return self._streaks.get(name, 0) >= self.cfg.sustain_polls

    def plan(self) -> Optional[tuple[str, str, int]]:
        """At most one (source, target, n_moves) verdict per call: the
        hottest sustained-hot replica paired with the coldest eligible
        target, gated by budget and per-source cooldown.  None when
        nothing should move — the overwhelmingly common answer."""
        self._refill()
        if self._tokens < 1.0:
            return None
        now = self._now()
        hot = [
            (row["pressure"], name)
            for name, row in self._rows.items()
            if row["eligible"]
            and self.sustained_hot(name)
            and now - self._last_plan.get(name, -1e9) >= self.cfg.cooldown_s
        ]
        if not hot:
            return None
        cold = [
            (row["pressure"], name)
            for name, row in self._rows.items()
            if row["eligible"] and row["pressure"] <= self.cfg.cold_wait_s
        ]
        if not cold:
            # Fleet-wide hot: nowhere to move — that is a SCALE signal
            # (scale_recommendation reads the same rows), not a license
            # to shuffle load between two saturated replicas.
            return None
        _, source = max(hot)
        cold = [(p, n) for p, n in cold if n != source]
        if not cold:
            return None
        _, target = min(cold)
        n_moves = min(self.cfg.max_moves_per_plan, int(self._tokens))
        self._tokens -= n_moves
        self._last_plan[source] = now
        self._streaks[source] = 0  # re-arm: re-plan only if STILL hot
        self.plans_total += 1
        self.moves_planned_total += n_moves
        return source, target, n_moves

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        """JSON-safe planner state for GET /debug/fleet."""
        self._refill()
        return {
            "enabled": True,
            "hot_wait_s": self.cfg.hot_wait_s,
            "cold_wait_s": self.cfg.cold_wait_s,
            "sustain_polls": self.cfg.sustain_polls,
            "budget_tokens": round(self._tokens, 2),
            "plans_total": self.plans_total,
            "moves_planned_total": self.moves_planned_total,
            "replicas": {
                name: {
                    "pressure_s": round(row["pressure"], 4),
                    "hot_streak": self._streaks.get(name, 0),
                    "eligible": row["eligible"],
                }
                for name, row in sorted(self._rows.items())
            },
        }


def scale_recommendation(
    signals: dict[str, dict],
    *,
    hot_wait_s: float = MigrationConfig.hot_wait_s,
    cold_wait_s: float = MigrationConfig.cold_wait_s,
) -> dict:
    """Fleet scale verdict from per-replica signal rows.

    ``signals``: ``{name: {"pressure_s", "queue_depth", "eligible"}}``
    (the shape ``RouterServer.fleet_state`` builds from poll state).

    - **scale_up** when a majority of the eligible fleet runs hot and no
      cold headroom exists to migrate into — adding replicas is the only
      move left (suggested count grows by the hot replica count).
    - **scale_down** when EVERY eligible replica is cold with empty
      queues and there is more than one — the fleet is paying for
      headroom nobody uses (suggest dropping one at a time: consistent
      hashing remaps ~1/K per removal, so gentle beats bold).
    - **hold** otherwise (including no data: never scale on a guess).

    Every verdict carries the ``hot_wait_s``/``cold_wait_s`` thresholds
    it was judged with, so a downstream consumer (the fleet controller)
    classifies replicas the recommendation doesn't cover — the prefill
    pool is ineligible here by design — with the SAME knobs and a
    decision stays explainable from one snapshot.
    """
    eligible = {
        name: row for name, row in signals.items() if row.get("eligible")
    }
    n = len(eligible)
    if n == 0:
        return {
            "action": "hold",
            "reason": "no eligible replicas polled — not scaling on a guess",
            "replicas": len(signals),
            "suggested_replicas": len(signals),
            "hot": [],
            "cold": [],
            "hot_wait_s": hot_wait_s,
            "cold_wait_s": cold_wait_s,
        }
    hot = sorted(
        name
        for name, row in eligible.items()
        if row["pressure_s"] >= hot_wait_s
    )
    cold = sorted(
        name
        for name, row in eligible.items()
        if row["pressure_s"] <= cold_wait_s
    )
    if len(hot) * 2 >= n and not cold:
        return {
            "action": "scale_up",
            "reason": (
                f"{len(hot)}/{n} replicas sustained-hot with no cold "
                "headroom to migrate into"
            ),
            "replicas": n,
            "suggested_replicas": n + max(1, len(hot)),
            "hot": hot,
            "cold": cold,
            "hot_wait_s": hot_wait_s,
            "cold_wait_s": cold_wait_s,
        }
    total_queue = sum(row["queue_depth"] for row in eligible.values())
    if len(cold) == n and n > 1 and total_queue == 0:
        return {
            "action": "scale_down",
            "reason": (
                f"all {n} replicas cold with empty queues — paying for "
                "idle headroom"
            ),
            "replicas": n,
            "suggested_replicas": n - 1,
            "hot": hot,
            "cold": cold,
            "hot_wait_s": hot_wait_s,
            "cold_wait_s": cold_wait_s,
        }
    return {
        "action": "hold",
        "reason": (
            f"{len(hot)} hot / {len(cold)} cold of {n} — migration "
            "headroom available" if hot else f"fleet within bounds "
            f"({len(cold)} cold of {n})"
        ),
        "replicas": n,
        "suggested_replicas": n,
        "hot": hot,
        "cold": cold,
        "hot_wait_s": hot_wait_s,
        "cold_wait_s": cold_wait_s,
    }
