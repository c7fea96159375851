"""Overload control for the serving engine: priority admission, deadline
expiry, per-tenant fairness, and an adaptive concurrency limiter.

The port's own copy of the reference's ``models/engine_overload.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The FIFO queue behind a blanket timeout is the overload failure mode the
north star forbids: one hot tenant's long prompts starve everyone, and a
request whose client-side deadline already passed still burns a slot and
KV pages producing tokens nobody will read.  This module is the policy
layer that replaces it — deliberately SEPARATE from the engine mechanics
(engine_admission.py keeps owning slots/pages/prefill) so the policy is
pluggable and the engine stays bit-identical with the controller off:

- **Priority classes** (``high``/``normal``/``low``): admission serves
  the best class first; adaptive shedding sheds the worst class first.
- **Earliest-deadline-first** within a class: a request may carry an
  absolute monotonic ``deadline``; ties (and the no-deadline common
  case) fall back to arrival order, so a controller over
  default-priority deadline-free traffic picks EXACTLY the FIFO head —
  the bit-identical-when-idle property the equivalence tests pin.
- **Per-tenant weighted fair sharing** with token-cost accounting: each
  admission charges its tenant ``prompt + max_new`` tokens of debt
  (decayed over ``tenant_decay_s``); among the best priority class the
  next slot goes to the tenant with the least debt per weight — long
  prompts cost proportionally, so a heavy tenant cannot monopolize by
  volume OR by size.
- **Expiry sweeping**: a queued request whose deadline passed is shed
  without ever holding pages; an in-slot request is preempted the
  moment its deadline passes — or earlier, when the measured per-token
  latency says the remaining budget cannot cover the remaining tokens.
- **AIMD concurrency limiter**: measured queue wait vs a target delay
  drives the admitted-concurrency limit — additive increase while
  under target, multiplicative decrease while over — and admission
  sheds (503 + a Retry-After computed from the measured drain rate)
  when the projected queue wait runs past the class's headroom.

Thread-safety: every mutating method is called by the engine UNDER the
engine lock (submit-side checks and step-side sweeps share it); the
controller itself adds no locking.  Pure host-side Python — nothing
here touches the compiled path.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2
PRIORITY_NAMES = {
    PRIORITY_HIGH: "high",
    PRIORITY_NORMAL: "normal",
    PRIORITY_LOW: "low",
}
_PRIORITY_ALIASES = {
    "high": PRIORITY_HIGH,
    "normal": PRIORITY_NORMAL,
    "low": PRIORITY_LOW,
}

# Shed kinds (flight events, tpu_engine_sheds_total{kind=...}, and the
# runbook table in docs/operations.md all share this vocabulary).
SHED_EXPIRED = "expired"  # queued past its deadline: swept, never held pages
SHED_INFEASIBLE = "infeasible"  # in a slot, but cannot finish in time: preempted
SHED_QUEUE_FULL = "queue_full"  # hard queue cap at submit
SHED_OVERLOAD = "overload"  # projected wait past the class headroom at submit

# Projected-wait headroom multiplier per priority class: low sheds
# first, high holds on 4x longer — the "shed lowest-priority first"
# ordering expressed as thresholds instead of a sort.
_SHED_HEADROOM = {PRIORITY_HIGH: 4.0, PRIORITY_NORMAL: 2.0, PRIORITY_LOW: 1.0}


def parse_priority(value) -> int:
    """Normalize a wire-format priority (int 0..2 or the class name) to
    the internal int; raises ValueError on anything else."""
    if isinstance(value, str):
        text = value.strip().lower()
        if text in _PRIORITY_ALIASES:
            return _PRIORITY_ALIASES[text]
        try:
            value = int(text)
        except ValueError:
            raise ValueError(
                f"priority must be high/normal/low or 0..2, got {value!r}"
            ) from None
    value = int(value)
    if value not in PRIORITY_NAMES:
        raise ValueError(f"priority must be in 0..2, got {value}")
    return value


class ShedError(ValueError):
    """Raised by submit-side admission control when a request is shed
    before it ever enqueues.  A ValueError subclass so call sites that
    meter generic rejects keep working; the HTTP layer special-cases it
    into 503 (load sheds, with ``retry_after_s``) or 504 (deadline
    sheds)."""

    def __init__(self, message: str, kind: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.kind = kind
        self.retry_after_s = max(0.0, float(retry_after_s))


@dataclasses.dataclass
class OverloadConfig:
    """Tunables for :class:`OverloadController` (CLI: ``--overload-*``)."""

    # AIMD setpoint: the queue wait the limiter steers toward.
    target_queue_wait_s: float = 0.5
    # Additive increase (slots per adjustment) / multiplicative decrease.
    aimd_increase: float = 1.0
    aimd_decrease: float = 0.5
    min_concurrency: int = 1
    adjust_interval_s: float = 0.25
    # Submit-side shedding: shed priority p when the projected queue
    # wait exceeds target * shed_wait_factor * headroom[p].
    shed_wait_factor: float = 8.0
    # Hard queue cap (any priority): the backstop against unbounded RAM.
    max_queue: int = 512
    # Token-cost debt half-life for tenant fairness.
    tenant_decay_s: float = 30.0
    # Optional per-tenant weights (share = weight / sum); default 1.0.
    tenant_weights: Optional[dict] = None
    # Safety factor on the measured per-token latency when judging
    # whether an in-slot request can still finish inside its deadline.
    itl_safety: float = 1.0


class OverloadController:
    """The pluggable admission policy: selection order, expiry/feasibility
    predicates, AIMD limit, and shed accounting.

    The ENGINE owns the queue and slots and calls in at its step
    boundaries; this object owns only policy state, so a unit test can
    drive it with a fake clock and hand-built requests."""

    def __init__(
        self,
        max_slots: int,
        config: Optional[OverloadConfig] = None,
        *,
        metrics=None,
        flight=None,
        now=time.monotonic,
    ):
        self.cfg = config or OverloadConfig()
        if self.cfg.target_queue_wait_s <= 0:
            raise ValueError("target_queue_wait_s must be > 0")
        if not 0 < self.cfg.aimd_decrease < 1:
            raise ValueError("aimd_decrease must be in (0, 1)")
        self.max_slots = max_slots
        self.metrics = metrics
        self.flight = flight
        self._now = now
        self.limit = float(max_slots)
        self._last_adjust = now()
        # EWMAs: queue wait (the limiter input), per-token latency (the
        # feasibility input), and request drain rate (the Retry-After
        # input).  None until the first observation — every consumer
        # degrades to "no opinion" rather than acting on a guess.
        self._wait_ewma: Optional[float] = None
        self._itl_ewma: Optional[float] = None
        self._drain_rate: Optional[float] = None
        self._last_finish_t: Optional[float] = None
        # Token-cost debt per tenant (decayed); bounded label mapping
        # for the tenant-labeled shed counter (cardinality budget).
        self._tenant_debt: dict[str, float] = {}
        self._tenant_stats: dict[str, dict] = {}
        self._tenant_labels: dict[str, str] = {}
        self.max_tracked_tenants = 16
        # Shed accounting (also mirrored to metrics/flight).
        self.shed_counts: dict[str, int] = {}
        self.sheds_total = 0
        self.goodput_tokens = 0
        self.raw_tokens = 0
        self.limit_decreases = 0
        self.limit_increases = 0
        if metrics is not None:
            metrics.admission_limit.set(self.limit)

    # ------------------------------------------------------------- helpers

    @staticmethod
    def cost_of(prompt_tokens: int, max_new_tokens: int) -> float:
        """Token-cost of one request: what it charges its tenant's debt
        (prompt AND budgeted generation — long prompts cannot ride free)."""
        return float(prompt_tokens + max_new_tokens)

    def _weight(self, tenant: str) -> float:
        weights = self.cfg.tenant_weights or {}
        return max(float(weights.get(tenant, 1.0)), 1e-6)

    def _tenant_label(self, tenant: str) -> str:
        """Bounded tenant -> metric-label mapping: the first
        ``max_tracked_tenants`` distinct tenants get their own label,
        the rest share ``_other`` (client-supplied strings must never
        mint unbounded series)."""
        label = self._tenant_labels.get(tenant)
        if label is None:
            label = (
                tenant or "default"
                if len(self._tenant_labels) < self.max_tracked_tenants
                else "_other"
            )
            self._tenant_labels[tenant] = label
        return label

    def _tenant_stat(self, tenant: str) -> dict:
        stat = self._tenant_stats.get(tenant)
        if stat is None:
            if len(self._tenant_stats) >= 4 * self.max_tracked_tenants:
                # Snapshot-side bound, matching the label bound in
                # spirit: the oldest-idle entry gives way.
                victim = min(
                    self._tenant_stats, key=lambda t: self._tenant_stats[t]["last_seen"]
                )
                self._tenant_stats.pop(victim, None)
            stat = self._tenant_stats[tenant] = {
                "admitted": 0,
                "shed": 0,
                "cost": 0.0,
                "last_seen": self._now(),
            }
        return stat

    # ----------------------------------------------------------- selection

    def select_index(self, queue) -> int:
        """Index of the request to admit next from ``queue`` (a sequence
        of live Requests; the caller already dropped cancelled heads).

        Order: best (lowest) priority class; within it, the tenant with
        the least debt per weight; within the tenant, earliest deadline
        then arrival order.  With uniform priorities, one tenant, and no
        deadlines this is index 0 — plain FIFO."""
        best = 0
        best_key = None
        for i, req in enumerate(queue):
            if req.cancelled:
                continue
            debt = self._tenant_debt.get(req.tenant, 0.0) / self._weight(
                req.tenant
            )
            key = (
                req.priority,
                debt,
                req.deadline if req.deadline is not None else math.inf,
                i,
            )
            if best_key is None or key < best_key:
                best_key = key
                best = i
        return best

    def concurrency_limit(self) -> int:
        return max(self.cfg.min_concurrency, int(self.limit))

    # --------------------------------------------------------- observations

    def observe_admission(self, req, wait_s: float) -> None:
        """One request left the queue for a slot: feed the limiter and
        charge the tenant's token-cost debt."""
        alpha = 0.3
        self._wait_ewma = (
            wait_s
            if self._wait_ewma is None
            else (1 - alpha) * self._wait_ewma + alpha * wait_s
        )
        cost = self.cost_of(len(req.prompt), req.max_new_tokens)
        self._tenant_debt[req.tenant] = (
            self._tenant_debt.get(req.tenant, 0.0) + cost
        )
        stat = self._tenant_stat(req.tenant)
        stat["admitted"] += 1
        stat["cost"] += cost
        stat["last_seen"] = self._now()

    def observe_itl(self, seconds: float) -> None:
        alpha = 0.2
        self._itl_ewma = (
            seconds
            if self._itl_ewma is None
            else (1 - alpha) * self._itl_ewma + alpha * seconds
        )

    def on_finish(self, req) -> None:
        """A request finished (completed, cancelled, or shed): feed the
        drain-rate estimate and the goodput ledger."""
        now = self._now()
        if self._last_finish_t is not None:
            gap = max(now - self._last_finish_t, 1e-6)
            rate = 1.0 / gap
            alpha = 0.2
            self._drain_rate = (
                rate
                if self._drain_rate is None
                else (1 - alpha) * self._drain_rate + alpha * rate
            )
        self._last_finish_t = now
        tokens = len(req.tokens)
        self.raw_tokens += tokens
        # The goodput METRIC lives with the engine (_maybe_finish: it
        # must count with the controller off too); this ledger feeds the
        # /debug/admission snapshot and the benchmark's goodput ratio.
        if (
            req.shed is None
            and not req.cancelled
            and (req.deadline is None or req.finished_at <= req.deadline)
        ):
            self.goodput_tokens += tokens

    # --------------------------------------------------------------- limiter

    def maybe_adjust(self) -> Optional[float]:
        """AIMD tick (rate-limited to ``adjust_interval_s``): steer the
        admitted-concurrency limit toward the target queue wait.  Also
        decays tenant debt.  Returns the new limit when it changed."""
        now = self._now()
        dt = now - self._last_adjust
        if dt < self.cfg.adjust_interval_s:
            return None
        self._last_adjust = now
        if self.cfg.tenant_decay_s > 0 and self._tenant_debt:
            decay = math.exp(-dt * math.log(2.0) / self.cfg.tenant_decay_s)
            for tenant in list(self._tenant_debt):
                debt = self._tenant_debt[tenant] * decay
                if debt < 1.0:
                    del self._tenant_debt[tenant]
                else:
                    self._tenant_debt[tenant] = debt
        if self._wait_ewma is None:
            return None
        old = self.limit
        if self._wait_ewma > self.cfg.target_queue_wait_s:
            self.limit = max(
                float(self.cfg.min_concurrency),
                self.limit * self.cfg.aimd_decrease,
            )
            if self.limit < old:
                self.limit_decreases += 1
        else:
            self.limit = min(
                float(self.max_slots), self.limit + self.cfg.aimd_increase
            )
            if self.limit > old:
                self.limit_increases += 1
        if self.limit == old:
            return None
        if self.metrics is not None:
            self.metrics.admission_limit.set(self.limit)
        if self.flight is not None:
            self.flight.record(
                "overload.limit",
                limit=round(self.limit, 2),
                previous=round(old, 2),
                wait_ewma_s=round(self._wait_ewma, 4),
                target_s=self.cfg.target_queue_wait_s,
            )
        return self.limit

    # ------------------------------------------------------------- shedding

    def wait_ewma_s(self) -> Optional[float]:
        """The measured queue-wait EWMA (None before any admission) —
        the host-side hot signal the router's summary poll exports for
        proactive migration and scale planning."""
        return self._wait_ewma

    def drain_rate_rps(self) -> Optional[float]:
        """The measured request drain rate (None before two finishes) —
        the second host-side signal the fleet planner reads."""
        return self._drain_rate

    def projected_wait_s(self, queue_depth: int) -> Optional[float]:
        """Queue depth over the measured drain rate — the honest wait
        forecast Retry-After and submit-side shedding both read.  None
        until a drain-rate estimate exists (never shed on a guess)."""
        if self._drain_rate is None or self._drain_rate <= 0:
            return None
        return queue_depth / self._drain_rate

    def retry_after_s(self, queue_depth: int) -> float:
        """An honest Retry-After: when the CURRENT queue should have
        drained at the measured rate, floored at 1s."""
        projected = self.projected_wait_s(queue_depth)
        if projected is None:
            return 1.0
        return max(1.0, round(projected, 1))

    def check_admission(self, priority: int, queue_depth: int) -> None:
        """Submit-side gate (called under the engine lock BEFORE the
        request enqueues): raises :class:`ShedError` when the queue is
        capped or the projected wait runs past the class's headroom —
        lowest priority sheds first, and a shed request never holds a
        queue entry, a slot, or pages."""
        if queue_depth >= self.cfg.max_queue:
            raise ShedError(
                f"queue is full ({queue_depth} >= {self.cfg.max_queue})",
                SHED_QUEUE_FULL,
                self.retry_after_s(queue_depth),
            )
        projected = self.projected_wait_s(queue_depth)
        if projected is None or queue_depth == 0:
            return
        allowed = (
            self.cfg.target_queue_wait_s
            * self.cfg.shed_wait_factor
            * _SHED_HEADROOM[priority]
        )
        if projected > allowed:
            raise ShedError(
                f"projected queue wait {projected:.2f}s exceeds the "
                f"{PRIORITY_NAMES[priority]}-priority bound {allowed:.2f}s",
                SHED_OVERLOAD,
                self.retry_after_s(queue_depth),
            )

    def expired(self, req, now: Optional[float] = None) -> bool:
        if req.deadline is None:
            return False
        return (now if now is not None else self._now()) >= req.deadline

    def infeasible(self, req, now: Optional[float] = None) -> bool:
        """True when an IN-SLOT request's remaining token budget cannot
        fit its remaining deadline at the measured per-token latency —
        the preempt-early signal that stops burning a slot on a decode
        whose tail the client will never accept."""
        if req.deadline is None:
            return False
        now = now if now is not None else self._now()
        if now >= req.deadline:
            return True
        if self._itl_ewma is None:
            return False
        remaining_tokens = req.max_new_tokens - len(req.tokens)
        need = remaining_tokens * self._itl_ewma * self.cfg.itl_safety
        return need > (req.deadline - now)

    def record_shed(self, req_or_none, kind: str, **fields) -> None:
        """Account one shed decision (queued sweep, slot preempt, or a
        submit-side reject that never built a Request): counters,
        metrics, and the flight event chaos scoring joins against."""
        self.sheds_total += 1
        self.shed_counts[kind] = self.shed_counts.get(kind, 0) + 1
        priority = fields.get("priority")
        tenant = fields.get("tenant", "")
        if req_or_none is not None:
            priority = req_or_none.priority
            tenant = req_or_none.tenant
            fields.setdefault("rid", req_or_none.rid)
            fields.setdefault("generated", len(req_or_none.tokens))
        priority = PRIORITY_NORMAL if priority is None else priority
        stat = self._tenant_stat(tenant)
        stat["shed"] += 1
        stat["last_seen"] = self._now()
        if self.metrics is not None:
            self.metrics.sheds.inc(
                kind=kind, priority=PRIORITY_NAMES[priority]
            )
            self.metrics.tenant_sheds.inc(tenant=self._tenant_label(tenant))
        if self.flight is not None:
            # Field is named ``shed`` (not ``kind`` — that's the event
            # type slot in the flight schema).
            self.flight.record(
                "admission.shed",
                shed=kind,
                priority=PRIORITY_NAMES[priority],
                tenant=tenant,
                **{k: v for k, v in fields.items() if k not in ("priority", "tenant")},
            )

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON-safe state for GET /debug/admission: what an operator
        needs DURING an overload — the limit and its inputs, shed
        ledger, and the per-tenant debt/fairness view."""
        return {
            "enabled": True,
            "limit": round(self.limit, 2),
            "max_slots": self.max_slots,
            "target_queue_wait_s": self.cfg.target_queue_wait_s,
            "queue_wait_ewma_s": (
                round(self._wait_ewma, 4) if self._wait_ewma is not None else None
            ),
            "itl_ewma_s": (
                round(self._itl_ewma, 5) if self._itl_ewma is not None else None
            ),
            "drain_rate_rps": (
                round(self._drain_rate, 3) if self._drain_rate is not None else None
            ),
            "limit_increases": self.limit_increases,
            "limit_decreases": self.limit_decreases,
            "sheds_total": self.sheds_total,
            "sheds_by_kind": dict(self.shed_counts),
            "goodput_tokens": self.goodput_tokens,
            "raw_tokens": self.raw_tokens,
            "max_queue": self.cfg.max_queue,
            "tenants": {
                tenant or "default": {
                    "debt": round(self._tenant_debt.get(tenant, 0.0), 1),
                    "weight": self._weight(tenant),
                    "admitted": stat["admitted"],
                    "shed": stat["shed"],
                    "cost": round(stat["cost"], 1),
                }
                for tenant, stat in sorted(self._tenant_stats.items())
            },
        }
