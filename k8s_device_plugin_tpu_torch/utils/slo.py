"""Fleet SLO plane: sliding-window SLI accounting, error budgets, and
multi-window multi-burn-rate alerting.

The port's own copy of the reference's ``utils/slo.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The forensic layers (spans, flight events, incidents, histograms)
answer *what happened*; this module answers the operator's questions:
are we inside SLO, how fast is the error budget burning, and who is
consuming the fleet.  Three pieces:

- :class:`SLOTracker` — time-bucketed good/total SLI counters per
  declared :class:`Objective`, summed over sliding windows (5m/30m/6h
  by default).  The clock is injectable (``now=``) so the unit suite
  runs zero-sleep, exactly like ``OverloadController``.
- :class:`BurnRateRule` + the tracker's ``evaluate()`` — Google-SRE
  multi-window multi-burn-rate alerting: a *fast-burn* rule pages when
  the short AND medium windows both burn budget at >= 14.4x the
  sustainable rate; a *slow-burn* rule tickets at >= 3x over the
  medium AND long windows.  Requiring both windows keeps a single bad
  bucket from paging; clearing only after ``clear_evals`` consecutive
  clean evaluations keeps a flapping signal from re-paging.
- :class:`UsageMeter` — per-tenant usage accounting (prompt/decode
  tokens, KV page-seconds, queue-wait seconds) under the same bounded
  16-tenant label map as ``OverloadController`` (the 17th distinct
  tenant folds into ``_other`` so cardinality never grows per tenant).

Thread-safety contract (the ``OverloadController`` precedent): every
mutating method is called by its owner — the engine under the engine
lock, or the router's poll thread — so the classes here add no locking
of their own.

Burn-rate arithmetic: with objective target ``t`` the error budget is
``1 - t``; the burn rate over a window is ``bad_fraction / (1 - t)``.
Burn 1.0 spends exactly the whole budget over the objective period;
14.4x spends a 30-day budget in ~2 days — the canonical page
threshold.

Structured-output validity is a *reserved* objective name
(``structured_validity``): ROADMAP #6's grammar-constrained decoding
will emit its verdicts through the same tracker; declaring it here
reserves the wire name without accounting an objective nobody feeds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# Sliding windows, name -> seconds.  Short confirms an alert is STILL
# happening, long keeps it representative.
DEFAULT_WINDOWS: Dict[str, float] = {"5m": 300.0, "30m": 1800.0, "6h": 21600.0}

# Reserved for ROADMAP #6 (grammar-constrained decoding): the objective
# name structured-output validity verdicts will use.  Not in
# DEFAULT_OBJECTIVES — an objective with no feeder would read as a
# vacuously healthy SLO.
STRUCTURED_VALIDITY = "structured_validity"


@dataclass(frozen=True)
class Objective:
    """One declared service-level objective.

    ``target`` is the good-event ratio promised (0.99 = 1% error
    budget).  ``threshold_s`` is the latency cut for latency-shaped
    objectives (``record_latency`` turns seconds into a verdict);
    ``None`` for pure good/bad objectives like availability.
    """

    name: str
    target: float
    threshold_s: Optional[float] = None
    description: str = ""

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


def default_objectives(
    ttft_target_s: float = 2.0,
    itl_p99_target_s: float = 0.25,
) -> List[Objective]:
    """The serving objectives every engine accounts by default.  The
    latency cuts are CLI-tunable (``--slo-ttft-target`` /
    ``--slo-itl-target``); the ratio targets are the contract."""
    return [
        Objective(
            "ttft",
            target=0.99,
            threshold_s=ttft_target_s,
            description="time to first token <= target for 99% of requests",
        ),
        Objective(
            "itl_p99",
            target=0.99,
            threshold_s=itl_p99_target_s,
            description="per-request p99 inter-token gap <= target "
            "for 99% of requests",
        ),
        Objective(
            "availability",
            target=0.999,
            description="non-shed, non-dropped completion "
            "(client cancels excluded)",
        ),
    ]


@dataclass(frozen=True)
class BurnRateRule:
    """One multi-window burn-rate alert rule: fire when EVERY listed
    window burns at >= ``factor``; severity names the operator action
    (page vs ticket)."""

    name: str
    severity: str
    factor: float
    windows: Tuple[str, ...]


DEFAULT_RULES: Tuple[BurnRateRule, ...] = (
    BurnRateRule("fast_burn", "page", 14.4, ("5m", "30m")),
    BurnRateRule("slow_burn", "ticket", 3.0, ("30m", "6h")),
)


@dataclass
class _AlertState:
    active: bool = False
    since: float = 0.0
    clean_evals: int = 0
    fired_total: int = 0


@dataclass
class _Ring:
    """Per-objective time-bucketed good/total ring.  O(1) record, O(n)
    window sum; n = longest window / bucket width (~2160 at defaults),
    summed only on snapshot/evaluate, never per request."""

    bucket_s: float
    n: int
    ids: List[int] = field(default_factory=list)
    good: List[int] = field(default_factory=list)
    total: List[int] = field(default_factory=list)

    def __post_init__(self):
        self.ids = [-1] * self.n
        self.good = [0] * self.n
        self.total = [0] * self.n

    def add(self, now: float, good: int, total: int) -> None:
        bucket = int(now // self.bucket_s)
        slot = bucket % self.n
        if self.ids[slot] != bucket:
            self.ids[slot] = bucket
            self.good[slot] = 0
            self.total[slot] = 0
        self.good[slot] += good
        self.total[slot] += total

    def window_counts(self, now: float, window_s: float) -> Tuple[int, int]:
        """(good, total) summed over buckets inside the last window_s.
        The current partial bucket counts — freshness beats exactness
        at the bucket-width granularity."""
        newest = int(now // self.bucket_s)
        oldest = int((now - window_s) // self.bucket_s) + 1
        good = total = 0
        for slot in range(self.n):
            if oldest <= self.ids[slot] <= newest:
                good += self.good[slot]
                total += self.total[slot]
        return good, total


class SLOTracker:
    """Sliding-window SLI accounting + burn-rate alerting for a set of
    objectives.  One instance per engine (fed request verdicts under
    the engine lock) and one per router (fed per-replica summary deltas
    on the poll thread); no internal locking — see the module contract.
    """

    def __init__(
        self,
        objectives: Optional[List[Objective]] = None,
        windows: Optional[Dict[str, float]] = None,
        rules: Optional[Tuple[BurnRateRule, ...]] = None,
        bucket_s: float = 10.0,
        clear_evals: int = 3,
        now: Callable[[], float] = time.monotonic,
    ):
        self.objectives: Dict[str, Objective] = {
            o.name: o for o in (objectives or default_objectives())
        }
        self.windows = dict(windows or DEFAULT_WINDOWS)
        self.rules = tuple(rules if rules is not None else DEFAULT_RULES)
        for rule in self.rules:
            for w in rule.windows:
                if w not in self.windows:
                    raise ValueError(
                        f"rule {rule.name!r} references unknown window {w!r}"
                    )
        self.bucket_s = float(bucket_s)
        self.clear_evals = int(clear_evals)
        self._now = now
        n = int(max(self.windows.values()) // self.bucket_s) + 2
        self._rings: Dict[str, _Ring] = {
            name: _Ring(self.bucket_s, n) for name in self.objectives
        }
        # Cumulative lifetime [good, total] per objective — the compact
        # counters ?summary=1 exports for the router's delta merge.
        self._totals: Dict[str, List[int]] = {
            name: [0, 0] for name in self.objectives
        }
        self._alerts: Dict[Tuple[str, str], _AlertState] = {
            (obj, rule.name): _AlertState()
            for obj in self.objectives
            for rule in self.rules
        }

    # ------------------------------------------------------ recording

    def record(self, objective: str, good: bool, n: int = 1) -> None:
        """Account n identical verdicts for one objective."""
        ring = self._rings.get(objective)
        if ring is None or n <= 0:
            return
        ring.add(self._now(), n if good else 0, n)
        totals = self._totals[objective]
        totals[0] += n if good else 0
        totals[1] += n

    def record_latency(self, objective: str, seconds: float) -> bool:
        """Turn a latency sample into a verdict against the objective's
        threshold; returns the verdict (True = good)."""
        obj = self.objectives.get(objective)
        if obj is None or obj.threshold_s is None:
            return True
        good = seconds <= obj.threshold_s
        self.record(objective, good)
        return good

    def ingest(self, objective: str, good: int, total: int) -> None:
        """Merge a (good, total) DELTA from a downstream tracker into
        the current bucket — the router's fleet-aggregation path."""
        if objective not in self._rings or total <= 0:
            return
        good = max(0, min(good, total))
        self.record(objective, True, good)
        self.record(objective, False, total - good)

    # ------------------------------------------------------- querying

    def totals(self) -> Dict[str, List[int]]:
        """Cumulative lifetime [good, total] per objective (the
        ?summary=1 payload)."""
        return {name: list(v) for name, v in self._totals.items()}

    def window_counts(self, objective: str, window_s: float):
        return self._rings[objective].window_counts(self._now(), window_s)

    def bad_fraction(self, objective: str, window_s: float) -> float:
        good, total = self.window_counts(objective, window_s)
        return 0.0 if total == 0 else (total - good) / total

    def burn_rate(self, objective: str, window_s: float) -> float:
        """bad_fraction / error_budget: 1.0 burns exactly the budget
        over the period; 0.0 when the window saw no events (an idle
        engine is not out of SLO)."""
        obj = self.objectives[objective]
        return self.bad_fraction(objective, window_s) / obj.error_budget

    def budget_remaining(self, objective: str) -> float:
        """Error budget left over the LONGEST window, 1.0 (untouched)
        to <= 0.0 (overspent)."""
        longest = max(self.windows.values())
        return 1.0 - self.burn_rate(objective, longest)

    # ----------------------------------------------------- alerting

    def evaluate(self) -> List[dict]:
        """Evaluate every (objective, rule) pair; returns the state
        TRANSITIONS (fired / cleared) since the last call.  An alert
        fires only when every window in the rule burns >= factor with
        nonzero traffic, and clears only after ``clear_evals``
        consecutive clean evaluations — the hysteresis that keeps one
        bad bucket from flapping a page."""
        now = self._now()
        transitions: List[dict] = []
        for obj_name, obj in self.objectives.items():
            for rule in self.rules:
                burns = {}
                firing = True
                for w in rule.windows:
                    good, total = self.window_counts(
                        obj_name, self.windows[w]
                    )
                    burn = (
                        0.0
                        if total == 0
                        else ((total - good) / total) / obj.error_budget
                    )
                    burns[w] = burn
                    if total == 0 or burn < rule.factor:
                        firing = False
                state = self._alerts[(obj_name, rule.name)]
                if firing:
                    state.clean_evals = 0
                    if not state.active:
                        state.active = True
                        state.since = now
                        state.fired_total += 1
                        transitions.append(
                            self._alert_dict(obj_name, rule, burns, "fired")
                        )
                elif state.active:
                    state.clean_evals += 1
                    if state.clean_evals >= self.clear_evals:
                        state.active = False
                        transitions.append(
                            self._alert_dict(obj_name, rule, burns, "cleared")
                        )
        return transitions

    def _alert_dict(self, objective, rule, burns, state_str) -> dict:
        return {
            "objective": objective,
            "rule": rule.name,
            "severity": rule.severity,
            "factor": rule.factor,
            "windows": list(rule.windows),
            "burn_rates": {w: round(b, 3) for w, b in burns.items()},
            "state": state_str,
        }

    def active_alerts(self) -> List[dict]:
        out = []
        for (obj_name, rule_name), state in self._alerts.items():
            if not state.active:
                continue
            rule = next(r for r in self.rules if r.name == rule_name)
            burns = {
                w: round(self.burn_rate(obj_name, self.windows[w]), 3)
                for w in rule.windows
            }
            d = self._alert_dict(obj_name, rule, burns, "active")
            d["since"] = state.since
            out.append(d)
        return out

    # ----------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The full /debug/slo payload: per-objective targets, window
        counts, burn rates, budget remaining, and active alerts."""
        objectives = {}
        for name, obj in self.objectives.items():
            per_window = {}
            for wname, wsec in self.windows.items():
                good, total = self.window_counts(name, wsec)
                per_window[wname] = {
                    "good": good,
                    "total": total,
                    "burn_rate": round(
                        0.0
                        if total == 0
                        else ((total - good) / total) / obj.error_budget,
                        4,
                    ),
                }
            objectives[name] = {
                "target": obj.target,
                "threshold_s": obj.threshold_s,
                "description": obj.description,
                "totals": list(self._totals[name]),
                "windows": per_window,
                "budget_remaining": round(self.budget_remaining(name), 4),
            }
        return {
            "objectives": objectives,
            "rules": [
                {
                    "name": r.name,
                    "severity": r.severity,
                    "factor": r.factor,
                    "windows": list(r.windows),
                }
                for r in self.rules
            ],
            "alerts": self.active_alerts(),
            "alerts_fired_total": sum(
                s.fired_total for s in self._alerts.values()
            ),
        }


class UsageMeter:
    """Per-tenant usage accounting: who consumed the fleet.

    Bounded exactly like ``OverloadController``'s tenant ledger: the
    first ``max_tracked_tenants`` distinct tenants get their own row
    (empty tenant -> ``default``); every later tenant folds into
    ``_other``, so the exported ``tpu_engine_tenant_*`` label sets stay
    under the fleet cardinality budget no matter how many tenants a
    storm invents.  Mutated under the engine lock; no locking here.
    """

    max_tracked_tenants = 16
    FIELDS = (
        "requests",
        "prompt_tokens",
        "decode_tokens",
        "kv_page_seconds",
        "queue_wait_seconds",
    )

    def __init__(self, max_tracked_tenants: Optional[int] = None):
        if max_tracked_tenants is not None:
            self.max_tracked_tenants = int(max_tracked_tenants)
        self._tracked: set = set()
        self._rows: Dict[str, Dict[str, float]] = {}

    def _tenant_label(self, tenant: str) -> str:
        label = tenant or "default"
        if label in self._tracked:
            return label
        if len(self._tracked) < self.max_tracked_tenants:
            self._tracked.add(label)
            return label
        return "_other"

    def record_request(
        self,
        tenant: str,
        prompt_tokens: int = 0,
        decode_tokens: int = 0,
        kv_page_seconds: float = 0.0,
        queue_wait_seconds: float = 0.0,
    ) -> str:
        """Charge one finished request to its tenant; returns the label
        it was charged to (the folded ``_other`` for late tenants) so
        the caller can export the same label to metrics."""
        label = self._tenant_label(tenant)
        row = self._rows.setdefault(
            label, {f: 0.0 for f in self.FIELDS}
        )
        row["requests"] += 1
        row["prompt_tokens"] += max(0, int(prompt_tokens))
        row["decode_tokens"] += max(0, int(decode_tokens))
        row["kv_page_seconds"] += max(0.0, float(kv_page_seconds))
        row["queue_wait_seconds"] += max(0.0, float(queue_wait_seconds))
        return label

    def snapshot(self) -> dict:
        """The /debug/usage payload: per-tenant rows plus the fold
        telemetry (how many distinct tenants the cap absorbed)."""
        return {
            "max_tracked_tenants": self.max_tracked_tenants,
            "tracked_tenants": len(self._tracked),
            "tenants": {
                label: {
                    k: (int(v) if k.endswith("tokens") or k == "requests"
                        else round(v, 4))
                    for k, v in row.items()
                }
                for label, row in self._rows.items()
            },
        }
