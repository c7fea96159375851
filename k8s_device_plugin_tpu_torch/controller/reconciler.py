"""Closed-loop fleet autoscaler — the reconciler.

The port's own copy of the reference's ``controller/reconciler.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

``scale_recommendation`` (router/migration.py) turns host-side pressure
signals into a scale_up/scale_down/hold verdict, and until this module
the verdict dead-ended at ``tools/fleet_plan.py`` exit codes "so a cron
can act".  The :class:`Reconciler` closes the loop: it
polls the router's ``GET /debug/fleet`` snapshot, computes a desired
fleet spec (size x role mix), and converges the live fleet toward it
through a pluggable :class:`~..controller.actuators.Actuator` — warm
scale-up (donor-selected peer warm-join), drain-then-reap scale-down,
and role rebalancing.

Decision discipline — one hot poll must never flap the fleet:

- **Hysteresis**: a non-hold verdict must repeat for ``sustain_ticks``
  consecutive ticks before anything executes (a verdict change resets
  the streak, so an oscillating fleet holds forever — the flap guard).
- **Cooldown**: after any executed (or dry-run, or failed) action the
  controller holds for ``cooldown_s`` — let the last action land and
  the EWMAs react before judging again.
- **Bounded actions**: at most ``max_actions_per_tick`` per tick, and
  scale_up refuses past ``max_replicas``.
- **Role flips before hardware**: when the disagg prefill pool
  saturates while a decode replica idles (or vice versa), the
  controller flips the idle replica's role — the router already
  reconciles role changes off its summary poll — because a flip is
  cheaper than a scale-up.
- **Never the last of a role**: scale_down and role flips refuse to
  empty a role's pool.
- **Degrade to hold**: a failed fleet poll or a raising actuator is a
  held tick plus a flight event, never a crash and never a guess.

Acts on host-side signals only (queue-wait EWMA, drain-rate forecast —
the Host-Side Telemetry pattern, PAPERS.md), jax-free and
fake-clock-injectable: the unit suite drives :meth:`Reconciler.tick`
with a fake clock, a canned-snapshot fetch, and a recording actuator;
production wires :class:`~.server.ControllerServer`'s daemon thread
(``python -m k8s_device_plugin_tpu_torch.controller``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
import urllib.request
from typing import Callable, Optional

from .actuators import Actuator, ActuatorError

ROLE_PREFILL = "prefill"

# Closed decision enums (metrics label sets; tools/metrics_lint.py
# FAMILY_BUDGETS pins their product as the cardinality budget).
ACTIONS = ("hold", "role_flip", "scale_up", "scale_down")
OUTCOMES = (
    "idle",  # hold verdict: nothing to converge
    "executed",  # the actuator applied the action
    "dry_run",  # --dry-run: logged + metered, actuator never called
    "held_hysteresis",  # verdict not yet sustained sustain_ticks
    "held_cooldown",  # a recent action is still settling
    "capped",  # scale_up refused at max_replicas
    "refused_last_replica",  # would empty a role's pool
    "actuator_error",  # actuator raised: degraded to hold
    "poll_error",  # fleet snapshot fetch failed: degraded to hold
)


@dataclasses.dataclass
class ControllerConfig:
    """Tunables for :class:`Reconciler` (CLI: the ``--controller`` knob
    set of ``python -m k8s_device_plugin_tpu_torch.controller``)."""

    # Seconds between reconcile ticks (the daemon loop's cadence).
    interval_s: float = 5.0
    # Consecutive ticks a non-hold verdict must repeat before acting —
    # the hysteresis/flap guard (a verdict change resets the streak).
    sustain_ticks: int = 3
    # Seconds after any action (executed, dry-run, or failed) before
    # the next one: let the fleet settle and the EWMAs react.
    cooldown_s: float = 30.0
    # Actions per tick ceiling (1 = one careful step at a time).
    max_actions_per_tick: int = 1
    # Fleet size bounds for the decode-capable pool.  max_replicas 0 =
    # uncapped (the actuator's own capacity is the cap).
    min_replicas: int = 1
    max_replicas: int = 0
    # Pressure classification for role rebalancing (the prefill pool is
    # outside the router's recommendation, which only judges the
    # decode-capable pool).  Overridden by the thresholds the snapshot's
    # recommendation carries when present, so controller and router
    # always judge with the same knobs.
    hot_wait_s: float = 2.0
    cold_wait_s: float = 0.5
    # Observe-only mode: decisions are computed, logged, metered, and
    # served at /debug/controller — the actuator is never called.
    dry_run: bool = False
    # Decision-log ring capacity (served at /debug/controller and
    # rendered by tools/fleet_plan.py --controller-url).
    decision_log: int = 256

    def __post_init__(self):
        if self.sustain_ticks < 1:
            raise ValueError("sustain_ticks must be >= 1")
        if self.max_actions_per_tick < 1:
            raise ValueError("max_actions_per_tick must be >= 1")
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas and self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be 0 or >= min_replicas")
        if self.hot_wait_s <= self.cold_wait_s:
            raise ValueError(
                "hot_wait_s must exceed cold_wait_s "
                f"({self.hot_wait_s} <= {self.cold_wait_s})"
            )


class ControllerMetrics:
    """The controller's Prometheus families (served on its own
    /metrics — the k8s actuator's external-metrics surface; linted
    live in tier-1 like the router's)."""

    def __init__(self, registry):
        self.ticks = registry.counter(
            "tpu_controller_ticks_total",
            "Reconcile ticks by outcome (ok: fleet snapshot fetched and "
            "judged; error: the /debug/fleet poll failed — the tick "
            "degraded to hold)",
            ("outcome",),
        )
        self.decisions = registry.counter(
            "tpu_controller_decisions_total",
            "Reconciler decisions by action (hold/role_flip/scale_up/"
            "scale_down) and outcome (idle/executed/dry_run/"
            "held_hysteresis/held_cooldown/capped/refused_last_replica/"
            "actuator_error/poll_error) — both closed enums; every tick "
            "lands exactly one decision here",
            ("action", "outcome"),
        )
        self.desired_replicas = registry.gauge(
            "tpu_controller_desired_replicas",
            "Desired replica count per role (unified/prefill/decode) — "
            "the external-metrics surface a Kubernetes adapter scrapes "
            "to scale the serving Deployment "
            "(deploy/k8s-deploy-controller-gpu.yaml)",
            ("role",),
        )
        self.observed_replicas = registry.gauge(
            "tpu_controller_observed_replicas",
            "Observed replica count per role from the last fleet "
            "snapshot (desired vs observed divergence = convergence "
            "in progress or an actuator wedged)",
            ("role",),
        )
        self.replica_minutes = registry.counter(
            "tpu_controller_replica_minutes_total",
            "Accumulated replica-minutes per role (fleet size "
            "integrated over wall time between ticks) — the hardware "
            "bill the autoscaler exists to shrink; the AUTOSCALE bench "
            "row compares it against a static peak-sized fleet",
            ("role",),
        )
        self.tick_seconds = registry.histogram(
            "tpu_controller_tick_seconds",
            "Reconcile tick latency (fleet poll + decision + actuation)",
        )


def fetch_fleet(url: str, timeout_s: float = 10.0) -> dict:
    """One ``GET /debug/fleet`` dial against a router base URL — the
    production fetch the CLI wires into :class:`Reconciler` (tests
    inject canned-snapshot callables instead)."""
    base = url.rstrip("/")
    if not base.startswith("http"):
        base = f"http://{base}"
    with urllib.request.urlopen(base + "/debug/fleet", timeout=timeout_s) as r:
        return json.loads(r.read() or b"{}")


class Reconciler:
    """Poll -> desired spec -> guarded actuation, one :meth:`tick` at a
    time.  Single-threaded by contract: the controller's daemon loop
    (or the driving test) owns it; :meth:`snapshot` reads are plain
    dict/deque reads of already-published values (GIL-atomic, one-tick
    stale at worst — the same discipline as the router's poll state).

    ``fetch`` returns the router's ``/debug/fleet`` dict (raises
    ``OSError``/``ValueError`` on failure); ``actuator`` executes
    decisions (:mod:`.actuators`).  Injectables: ``metrics``
    (:class:`ControllerMetrics`), ``flight`` (FlightRecorder), ``now``
    (fake clock)."""

    def __init__(
        self,
        fetch: Callable[[], dict],
        actuator: Actuator,
        *,
        config: Optional[ControllerConfig] = None,
        metrics: Optional[ControllerMetrics] = None,
        flight=None,
        anomaly=None,
        now=time.monotonic,
    ):
        self.cfg = config or ControllerConfig()
        self._fetch = fetch
        self.actuator = actuator
        self.metrics = metrics
        self.flight = flight
        # Optional AnomalyMonitor (utils/anomaly.py): actuator failures
        # are DISCRETE incidents (wrong on first observation) — the
        # report fans out to the incident ring, the JSON log, and any
        # postmortem-capture listener.
        self.anomaly = anomaly
        self._now = now
        self.ticks = 0
        self.actions_executed = 0
        self.role_flips = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # Replica-minutes ledger: fleet size integrated over the wall
        # time between consecutive ticks, per role and total.
        self.replica_minutes = 0.0
        self.replica_minutes_by_role: dict[str, float] = {}
        self._last_tick_t: Optional[float] = None
        # Hysteresis streak: consecutive ticks proposing the same
        # action kind.  A change (including back to hold) resets it.
        self._streak_action = "hold"
        self._streak = 0
        self._last_action_t: Optional[float] = None
        self._last_error: Optional[str] = None
        self._desired: dict[str, int] = {}
        self._observed: dict[str, int] = {}
        self.decisions: collections.deque = collections.deque(
            maxlen=self.cfg.decision_log
        )
        self._last_recorded: Optional[tuple] = None

    # ------------------------------------------------------------ wiring

    def _record(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def _meter_decision(self, action: str, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.decisions.inc(action=action, outcome=outcome)

    # ------------------------------------------------------- observation

    @staticmethod
    def _pressure(row: dict) -> float:
        return float(row.get("pressure_s") or 0.0)

    @staticmethod
    def _healthy(row: dict) -> bool:
        return (
            bool(row.get("reachable", True))
            and not row.get("draining")
            and not row.get("fenced")
        )

    @staticmethod
    def _pool_role(rows: dict) -> str:
        """The decode-capable pool's role label: "decode" in a split
        fleet, else "unified"."""
        for row in rows.values():
            if row.get("role") == "decode":
                return "decode"
        return "unified"

    def _accrue_minutes(self, counts: dict, t: float) -> None:
        if self._last_tick_t is not None:
            dt_min = max(0.0, t - self._last_tick_t) / 60.0
            for role, n in counts.items():
                self.replica_minutes += n * dt_min
                self.replica_minutes_by_role[role] = (
                    self.replica_minutes_by_role.get(role, 0.0) + n * dt_min
                )
                if self.metrics is not None:
                    self.metrics.replica_minutes.inc(n * dt_min, role=role)
        self._last_tick_t = t

    # --------------------------------------------------------- decisions

    def _candidate(self, rows: dict, rec: dict) -> dict:
        """The unguarded verdict for this snapshot: what the controller
        WOULD do, before hysteresis/cooldown/caps.  Role rebalancing
        outranks hardware in both directions — a flip is cheaper than a
        scale-up and faster than a drain."""
        hot_wait = float(rec.get("hot_wait_s") or self.cfg.hot_wait_s)
        cold_wait = float(rec.get("cold_wait_s") or self.cfg.cold_wait_s)
        prefill = {
            n: r for n, r in rows.items() if r.get("role") == ROLE_PREFILL
        }
        pool = {
            n: r for n, r in rows.items() if r.get("role") != ROLE_PREFILL
        }
        pool_role = self._pool_role(pool)

        # Prefill pool saturated + an idle decode-capable replica ->
        # flip it to prefill (the router reconciles the role change off
        # its next summary poll and lifts it out of the /generate ring).
        hot_prefill = sorted(
            n
            for n, r in prefill.items()
            if self._healthy(r) and self._pressure(r) >= hot_wait
        )
        if hot_prefill:
            idle = sorted(
                (
                    (r.get("active_slots", 0), self._pressure(r), n)
                    for n, r in pool.items()
                    if self._healthy(r)
                    and self._pressure(r) <= cold_wait
                    and not r.get("queue_depth", 0)
                ),
            )
            if idle and len(pool) > 1:
                _, _, name = idle[0]
                return {
                    "action": "role_flip",
                    "replica": name,
                    "from": rows[name].get("role", "unified"),
                    "to": ROLE_PREFILL,
                    "reason": (
                        f"prefill pool saturated ({', '.join(hot_prefill)} "
                        f">= {hot_wait}s) while {name} idles — a flip is "
                        "cheaper than a scale-up"
                    ),
                }
            return {
                "action": "hold",
                "reason": (
                    f"prefill pool saturated ({', '.join(hot_prefill)}) "
                    "but no idle decode-capable replica to flip"
                ),
            }

        action = str(rec.get("action") or "hold")
        if action == "scale_up":
            # Flip-before-buy: an idle prefill replica covers decode
            # pressure without new hardware (never the last prefill).
            idle_prefill = sorted(
                (self._pressure(r), n)
                for n, r in prefill.items()
                if self._healthy(r) and self._pressure(r) <= cold_wait
            )
            if idle_prefill and len(prefill) > 1:
                _, name = idle_prefill[0]
                return {
                    "action": "role_flip",
                    "replica": name,
                    "from": ROLE_PREFILL,
                    "to": pool_role,
                    "reason": (
                        "decode pool hot while prefill replica "
                        f"{name} idles — a flip is cheaper than a "
                        "scale-up"
                    ),
                }
            return {
                "action": "scale_up",
                "role": pool_role,
                "reason": str(rec.get("reason") or "fleet hot"),
            }
        if action == "scale_down":
            victims = sorted(
                (self._pressure(r), n)
                for n, r in pool.items()
                if r.get("eligible")
            )
            if not victims:
                return {"action": "hold", "reason": "no eligible victim"}
            _, victim = victims[0]
            victim_role = pool[victim].get("role", "unified")
            same_role = sum(
                1 for r in pool.values() if r.get("role") == victim_role
            )
            if (
                len(pool) <= self.cfg.min_replicas
                or same_role <= 1
            ):
                return {
                    "action": "scale_down",
                    "replica": victim,
                    "role": victim_role,
                    "refused": True,
                    "reason": (
                        f"{victim} is the last {victim_role} replica "
                        f"(pool {len(pool)}, min {self.cfg.min_replicas}) "
                        "— refusing to reap it"
                    ),
                }
            return {
                "action": "scale_down",
                "replica": victim,
                "role": victim_role,
                "reason": str(rec.get("reason") or "fleet cold"),
            }
        return {
            "action": "hold",
            "reason": str(rec.get("reason") or "fleet within bounds"),
        }

    def _desired_spec(
        self, counts: dict, rec: dict, candidate: dict
    ) -> dict:
        """Desired role mix: observed counts adjusted by the current
        verdict (the recommendation's suggested size for the decode
        pool; +-1 role shifts for a pending flip)."""
        desired = dict(counts)
        pool_role = (
            "decode" if counts.get("decode") else "unified"
        )
        action = candidate.get("action")
        if action == "scale_up":
            n = int(rec.get("replicas") or 0)
            suggested = int(rec.get("suggested_replicas") or (n + 1))
            grow = max(1, suggested - n)
            if self.cfg.max_replicas:
                room = self.cfg.max_replicas - sum(counts.values())
                grow = max(0, min(grow, room))
            desired[pool_role] = counts.get(pool_role, 0) + grow
        elif action == "scale_down" and not candidate.get("refused"):
            role = candidate.get("role", pool_role)
            desired[role] = max(
                self.cfg.min_replicas, counts.get(role, 1) - 1
            )
        elif action == "role_flip":
            src = candidate.get("from", pool_role)
            dst = candidate.get("to", ROLE_PREFILL)
            desired[src] = max(0, counts.get(src, 0) - 1)
            desired[dst] = counts.get(dst, 0) + 1
        return {role: n for role, n in sorted(desired.items())}

    # -------------------------------------------------------------- tick

    def tick(self) -> dict:
        """One reconcile pass: fetch -> judge -> (maybe) act.  Returns
        the decision record appended to the log — the unit-test driving
        seam; production calls this from the daemon loop."""
        t0 = self._now()
        self.ticks += 1
        try:
            fleet = self._fetch()
        except (OSError, ValueError) as e:
            self._last_error = str(e)
            if self.metrics is not None:
                self.metrics.ticks.inc(outcome="error")
                self.metrics.tick_seconds.observe(self._now() - t0)
            self._record("controller.tick_error", error=str(e))
            return self._decide(
                t0, {"action": "hold", "reason": f"fleet poll failed: {e}"},
                outcome="poll_error",
            )
        self._last_error = None
        rows = dict(fleet.get("replicas") or {})
        rec = dict(fleet.get("recommendation") or {})
        counts: dict[str, int] = {}
        for row in rows.values():
            role = str(row.get("role") or "unified")
            counts[role] = counts.get(role, 0) + 1
        self._observed = {r: n for r, n in sorted(counts.items())}
        self._accrue_minutes(counts, t0)
        if self.metrics is not None:
            self.metrics.ticks.inc(outcome="ok")
            for role, n in counts.items():
                self.metrics.observed_replicas.set(n, role=role)

        candidate = self._candidate(rows, rec)
        self._desired = self._desired_spec(counts, rec, candidate)
        if self.metrics is not None:
            for role, n in self._desired.items():
                self.metrics.desired_replicas.set(n, role=role)

        # Hysteresis streak over the *verdict kind* — any change
        # (including back to hold) re-arms it, so an oscillating fleet
        # never acts (the flap guard).
        action = candidate["action"]
        if action == self._streak_action:
            self._streak += 1
        else:
            self._streak_action = action
            self._streak = 1

        if action == "hold":
            decision = self._decide(t0, candidate, outcome="idle")
        elif candidate.get("refused"):
            decision = self._decide(
                t0, candidate, outcome="refused_last_replica"
            )
        elif self._streak < self.cfg.sustain_ticks:
            decision = self._decide(
                t0,
                candidate,
                outcome="held_hysteresis",
                streak=self._streak,
            )
        elif (
            self._last_action_t is not None
            and t0 - self._last_action_t < self.cfg.cooldown_s
        ):
            decision = self._decide(t0, candidate, outcome="held_cooldown")
        elif (
            action == "scale_up"
            and self.cfg.max_replicas
            and sum(counts.values()) >= self.cfg.max_replicas
        ):
            decision = self._decide(t0, candidate, outcome="capped")
        else:
            decision = self._act(t0, rows, candidate)
        if self.metrics is not None:
            self.metrics.tick_seconds.observe(self._now() - t0)
        return decision

    def _act(self, t0: float, rows: dict, candidate: dict) -> dict:
        """Execute one sustained, un-gated verdict (dry-run: log only).
        Cooldown arms on every attempt — executed, dry-run, or failed —
        so even a raising actuator is retried at the settle pace, not
        hammered every tick."""
        action = candidate["action"]
        self._last_action_t = t0
        self._streak = 0
        self._streak_action = "hold"
        if self.cfg.dry_run:
            return self._decide(t0, candidate, outcome="dry_run")
        donors = sorted(
            n
            for n, r in rows.items()
            if r.get("eligible") and r.get("role") != ROLE_PREFILL
        )
        try:
            if action == "role_flip":
                self.actuator.set_role(
                    candidate["replica"], candidate["to"]
                )
                self.role_flips += 1
                self._record(
                    "controller.role_flip",
                    replica=candidate["replica"],
                    previous=candidate["from"],
                    role=candidate["to"],
                )
            elif action == "scale_up":
                result = self.actuator.scale_up(
                    role=candidate.get("role", "unified"), peers=donors
                ) or {}
                candidate = dict(
                    candidate,
                    replica=result.get("replica"),
                    donor=result.get("donor"),
                )
                self.scale_ups += 1
                self._record(
                    "controller.scale_up",
                    replica=candidate.get("replica"),
                    donor=candidate.get("donor"),
                    role=candidate.get("role"),
                )
            elif action == "scale_down":
                self.actuator.scale_down(
                    candidate["replica"], role=candidate.get("role")
                )
                self.scale_downs += 1
                self._record(
                    "controller.scale_down",
                    replica=candidate["replica"],
                    role=candidate.get("role"),
                )
        except (ActuatorError, OSError, ValueError) as e:
            self._record(
                "controller.actuator_error", action=action, error=str(e)
            )
            if self.anomaly is not None:
                self.anomaly.report(
                    "controller.actuator_error",
                    action=action,
                    error=str(e),
                )
            return self._decide(
                t0, candidate, outcome="actuator_error", error=str(e)
            )
        self.actions_executed += 1
        return self._decide(t0, candidate, outcome="executed")

    def _decide(
        self, t0: float, candidate: dict, *, outcome: str, **extra
    ) -> dict:
        decision = {
            "tick": self.ticks,
            "t": round(t0, 3),
            "action": candidate["action"],
            "outcome": outcome,
            "reason": candidate.get("reason", ""),
        }
        for key in ("replica", "from", "to", "role", "donor"):
            if candidate.get(key) is not None:
                decision[key] = candidate[key]
        decision.update(extra)
        self.decisions.append(decision)
        self._meter_decision(candidate["action"], outcome)
        # Every decision is observable; the flight ring gets the
        # *transitions* (a 5s-cadence hold would drown everything else
        # — the full log rides /debug/controller).
        signature = (candidate["action"], outcome)
        if signature != self._last_recorded or outcome in (
            "executed",
            "dry_run",
            "actuator_error",
        ):
            self._record(
                "controller.decision",
                action=candidate["action"],
                outcome=outcome,
                reason=decision["reason"],
            )
        self._last_recorded = signature
        return decision

    # ---------------------------------------------------------- snapshot

    def snapshot(self, last: int = 32) -> dict:
        """The ``GET /debug/controller`` body (any thread; plain reads
        of published values — one tick stale at worst)."""
        return {
            "ticks": self.ticks,
            "dry_run": self.cfg.dry_run,
            "actuator": getattr(self.actuator, "name", "none"),
            "actions": {
                "executed": self.actions_executed,
                "role_flips": self.role_flips,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
            },
            "replica_minutes": round(self.replica_minutes, 3),
            "replica_minutes_by_role": {
                role: round(v, 3)
                for role, v in sorted(self.replica_minutes_by_role.items())
            },
            "desired": self._desired,
            "observed": self._observed,
            "last_error": self._last_error,
            "decisions": list(self.decisions)[-last:],
            "config": {
                "interval_s": self.cfg.interval_s,
                "sustain_ticks": self.cfg.sustain_ticks,
                "cooldown_s": self.cfg.cooldown_s,
                "max_actions_per_tick": self.cfg.max_actions_per_tick,
                "min_replicas": self.cfg.min_replicas,
                "max_replicas": self.cfg.max_replicas,
                "hot_wait_s": self.cfg.hot_wait_s,
                "cold_wait_s": self.cfg.cold_wait_s,
                "dry_run": self.cfg.dry_run,
            },
        }
