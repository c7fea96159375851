"""Failpoint registry: named, armable fault-injection sites.

The port's own copy of the reference's ``utils/failpoints.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The observability stack (flight recorder, EWMA anomaly incidents,
allocation-drift audit) was built watching one healthy node — its
detectors' precision against *real injected faults* was assumed, never
measured.  This module is the injection half of the chaos harness
(tools/chaos_report.py + tests/test_chaos_scenarios.py score the
detection half): named failpoints are threaded into the real code paths
(health probes, Allocate, ListAndWatch, attribution polls, engine
admission/readback — the catalog lives in docs/chaos.md) and armed per
scenario, by test, by CLI flag, or by environment variable.

Design rules, in priority order:

- **Zero overhead when disarmed.**  ``fire()`` with nothing armed is one
  attribute load and a dict truthiness check — no lock, no allocation.
  The engine calls it on every decode readback; a disarmed registry must
  be invisible in the step-time profile.
- **Forensically replayable.**  Every arm/disarm/trigger is recorded as
  a flight event (``failpoint.armed`` / ``failpoint.trigger`` /
  ``failpoint.disarmed``) when a recorder is wired, so a chaos dump
  shows the injected cause in sequence with the detected effect.
- **Bounded.**  An armed failpoint can carry a trigger budget
  (``*count`` in the spec) after which it disarms itself — a scenario's
  injection window ends deterministically even if the test dies.

Fault modes:

``error[:message]``
    :meth:`FailpointRegistry.fire` raises :class:`FailpointError`; the
    call site translates it into its own failure shape (an RPC abort, a
    submit rejection, a down-marked poll).
``delay:seconds``
    ``fire()`` sleeps — latency injection that flows into the same
    histograms and EWMA baselines real slowness would.
``hang[:max_seconds]``
    ``fire()`` blocks until the failpoint is disarmed (or
    ``max_seconds``, default 30 — a chaos harness must not be able to
    wedge a process beyond recovery).
``flap[:period]``
    ``fire()`` returns a :class:`FailpointHit` whose ``value``
    alternates every ``period`` triggers (default 1) — the transient
    probe-failure shape the health debounce exists for.
``truncate[:fraction]``
    ``fire()`` returns a hit the CALL SITE interprets as "corrupt your
    output": the snapshot writer tears the file to ``fraction`` of its
    bytes (default 0.5), the snapshot reader reads only that prefix —
    the disk-corruption shape the warm-restart degradation contract is
    scored against.  Sites that do not understand truncation ignore the
    hit (non-error hits are advisory by design).
``corrupt[:nbytes]``
    ``fire()`` returns a hit the CALL SITE interprets as "flip bytes of
    your output IN PLACE" — the silent-data-corruption sibling of
    ``truncate``: nothing tears, nothing errors, the payload is simply
    WRONG.  The engine's decode readback (``engine.readback``) flips
    ``nbytes`` bytes (default 1) of the synced token buffer, so the
    stream keeps flowing with a wrong token — the SDC ground truth the
    canary prober's bit-exactness verdict is scored against
    (docs/chaos.md).  Sites that do not understand corruption ignore
    the hit.

Spec grammar (``--failpoints`` on both CLIs, ``TPU_FAILPOINTS`` env)::

    name=mode[:arg][*count][;name2=...]

    TPU_FAILPOINTS='plugin.allocate=error*2;engine.readback=delay:0.25*6'

Stdlib-only, no dependencies on the metrics/flight modules beyond duck
typing (anything with ``.record(kind, **fields)`` works as a flight
sink).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger("tpu.failpoints")

ENV = "TPU_FAILPOINTS"

MODES = ("error", "delay", "hang", "flap", "truncate", "corrupt")

# Hard ceiling on hang-mode blocking: chaos must stay recoverable.
MAX_HANG_S = 30.0


class FailpointError(RuntimeError):
    """Raised by ``fire()`` at a call site whose failpoint is armed in
    ``error`` mode.  Call sites translate it into their own failure
    shape; it must never escape a daemon loop undocumented."""


class FailpointHit:
    """What ``fire()`` returns when an armed (non-error) failpoint
    triggered: which one, in which mode, the per-arm trigger ordinal,
    for ``flap`` whether the fault is currently ACTIVE, and the arm's
    raw ``arg`` (``truncate`` call sites read their fraction off it)."""

    __slots__ = ("name", "mode", "n", "value", "arg")

    def __init__(
        self, name: str, mode: str, n: int, value: bool, arg=None
    ):
        self.name = name
        self.mode = mode
        self.n = n
        self.value = value
        self.arg = arg

    def __repr__(self) -> str:  # debugging/log friendliness
        return (
            f"FailpointHit(name={self.name!r}, mode={self.mode!r}, "
            f"n={self.n}, value={self.value}, arg={self.arg!r})"
        )


class _Armed:
    """One armed failpoint's mutable state (registry-lock guarded)."""

    __slots__ = ("name", "mode", "arg", "remaining", "triggers", "unhang")

    def __init__(self, name: str, mode: str, arg, remaining: Optional[int]):
        self.name = name
        self.mode = mode
        self.arg = arg
        self.remaining = remaining  # None = unlimited
        self.triggers = 0
        self.unhang = threading.Event()


def parse_spec(spec: str) -> list[tuple[str, str, Optional[str], Optional[int]]]:
    """Parse the ``name=mode[:arg][*count]`` grammar into
    (name, mode, arg, count) tuples; raises ValueError on anything
    malformed (a chaos run with a typo'd spec must fail loudly, not run
    fault-free and report perfect SLOs)."""
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"failpoint spec {part!r} must be name=mode[:arg][*count]"
            )
        name, rhs = (s.strip() for s in part.split("=", 1))
        if not name:
            raise ValueError(f"failpoint spec {part!r} has an empty name")
        count: Optional[int] = None
        if "*" in rhs:
            rhs, count_s = rhs.rsplit("*", 1)
            try:
                count = int(count_s)
            except ValueError:
                raise ValueError(
                    f"failpoint {name!r}: trigger count {count_s!r} is not "
                    "an integer"
                ) from None
            if count < 1:
                raise ValueError(
                    f"failpoint {name!r}: trigger count must be >= 1, "
                    f"got {count}"
                )
        mode, _, arg_s = rhs.partition(":")
        mode = mode.strip()
        arg: Optional[str] = arg_s.strip() or None
        if mode not in MODES:
            raise ValueError(
                f"failpoint {name!r}: unknown mode {mode!r} "
                f"(expected one of {', '.join(MODES)})"
            )
        if mode in ("delay", "hang") and arg is not None:
            try:
                seconds = float(arg)
            except ValueError:
                raise ValueError(
                    f"failpoint {name!r}: {mode} argument {arg!r} is not "
                    "a number of seconds"
                ) from None
            if seconds < 0:
                raise ValueError(
                    f"failpoint {name!r}: {mode} seconds must be >= 0"
                )
        if mode == "delay" and arg is None:
            raise ValueError(f"failpoint {name!r}: delay requires :seconds")
        if mode == "flap" and arg is not None:
            try:
                period = int(arg)
            except ValueError:
                raise ValueError(
                    f"failpoint {name!r}: flap period {arg!r} is not an "
                    "integer"
                ) from None
            if period < 1:
                raise ValueError(
                    f"failpoint {name!r}: flap period must be >= 1"
                )
        if mode == "truncate" and arg is not None:
            try:
                fraction = float(arg)
            except ValueError:
                raise ValueError(
                    f"failpoint {name!r}: truncate fraction {arg!r} is not "
                    "a number"
                ) from None
            if not 0.0 <= fraction < 1.0:
                raise ValueError(
                    f"failpoint {name!r}: truncate fraction must be in "
                    f"[0, 1), got {fraction}"
                )
        if mode == "corrupt" and arg is not None:
            try:
                nbytes = int(arg)
            except ValueError:
                raise ValueError(
                    f"failpoint {name!r}: corrupt nbytes {arg!r} is not "
                    "an integer"
                ) from None
            if nbytes < 1:
                raise ValueError(
                    f"failpoint {name!r}: corrupt nbytes must be >= 1, "
                    f"got {nbytes}"
                )
        out.append((name, mode, arg, count))
    return out


class FailpointRegistry:
    """Named fault-injection sites, armed and fired at runtime.

    One process-wide :data:`DEFAULT` instance serves the production call
    sites (the module-level ``fire``/``arm``/``disarm`` aliases bind to
    it); tests needing isolation construct their own and fire it
    explicitly."""

    def __init__(self, name: str = "default"):
        self.name = name
        self._lock = threading.Lock()
        self._armed: dict[str, _Armed] = {}
        self._flight = None
        self.triggers_total = 0
        # Lifetime trigger counts per failpoint name — survives disarm
        # so a scenario can assert "the injection actually ran N times"
        # after its window closed.
        self._history: dict[str, int] = {}

    # ------------------------------------------------------------- wiring

    def set_flight(self, flight) -> None:
        """Wire a flight recorder (utils/flight.py — anything with
        ``record(kind, **fields)``); arms/triggers/disarms become black-
        box events from here on."""
        self._flight = flight

    # ------------------------------------------------------ arm / disarm

    def arm(
        self,
        name: str,
        mode: str,
        arg=None,
        count: Optional[int] = None,
    ) -> None:
        """Arm one failpoint (re-arming replaces, releasing any hung
        waiters of the previous arm).  ``count`` bounds triggers; the
        failpoint disarms itself when the budget is spent."""
        if mode not in MODES:
            raise ValueError(
                f"unknown failpoint mode {mode!r} (expected one of "
                f"{', '.join(MODES)})"
            )
        if count is not None and count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        fp = _Armed(name, mode, arg, count)
        with self._lock:
            old = self._armed.get(name)
            if old is not None:
                old.unhang.set()
            self._armed[name] = fp
        log.warning(
            "failpoint ARMED: %s=%s%s%s",
            name,
            mode,
            f":{arg}" if arg is not None else "",
            f"*{count}" if count is not None else "",
        )
        if self._flight is not None:
            self._flight.record(
                "failpoint.armed",
                name=name,
                mode=mode,
                arg=arg,
                count=count,
            )

    def arm_spec(self, spec: str) -> list[str]:
        """Arm every failpoint in a ``name=mode[:arg][*count];...`` spec
        string; returns the armed names.  Parses the WHOLE spec before
        arming anything, so a malformed entry cannot leave a scenario
        half-armed."""
        parsed = parse_spec(spec)
        for name, mode, arg, count in parsed:
            self.arm(name, mode, arg=arg, count=count)
        return [name for name, _, _, _ in parsed]

    def disarm(self, name: str) -> bool:
        """Disarm one failpoint; releases hung waiters.  True when it
        was armed."""
        with self._lock:
            fp = self._armed.pop(name, None)
        if fp is None:
            return False
        fp.unhang.set()
        log.warning("failpoint disarmed: %s", name)
        if self._flight is not None:
            self._flight.record(
                "failpoint.disarmed", name=name, triggers=fp.triggers
            )
        return True

    def disarm_all(self) -> int:
        """Disarm everything (scenario teardown); returns how many were
        armed."""
        with self._lock:
            names = list(self._armed)
        for name in names:
            self.disarm(name)
        return len(names)

    # ---------------------------------------------------------- queries

    def is_armed(self, name: str) -> bool:
        with self._lock:
            return name in self._armed

    def triggers(self, name: str) -> int:
        """Lifetime trigger count for ``name`` (survives disarm)."""
        with self._lock:
            return self._history.get(name, 0)

    def snapshot(self) -> dict:
        """JSON-safe registry state (armed sites + lifetime counts) —
        debug-endpoint / report material."""
        with self._lock:
            return {
                "registry": self.name,
                "triggers_total": self.triggers_total,
                "armed": {
                    fp.name: {
                        "mode": fp.mode,
                        "arg": fp.arg,
                        "remaining": fp.remaining,
                        "triggers": fp.triggers,
                    }
                    for fp in self._armed.values()
                },
                "triggered": dict(self._history),
            }

    # ------------------------------------------------------------- fire

    def fire(self, name: str, **ctx) -> Optional[FailpointHit]:
        """The call-site hook.  Disarmed (the overwhelmingly common
        case): returns None after one dict truthiness check.  Armed:
        counts the trigger, records a flight event (``ctx`` fields ride
        along), then applies the mode — raising :class:`FailpointError`
        (``error``), sleeping (``delay``), blocking until disarm
        (``hang``), or returning a hit whose ``value`` alternates
        (``flap``)."""
        if not self._armed:  # zero-overhead fast path
            return None
        with self._lock:
            fp = self._armed.get(name)
            if fp is None:
                return None
            fp.triggers += 1
            n = fp.triggers
            self.triggers_total += 1
            self._history[name] = self._history.get(name, 0) + 1
            if fp.remaining is not None:
                fp.remaining -= 1
                if fp.remaining <= 0:
                    # Budget spent: self-disarm (the injection window
                    # closes even if the arming test dies first).
                    self._armed.pop(name, None)
                    fp.unhang.set()
        if self._flight is not None:
            self._flight.record(
                "failpoint.trigger", name=name, mode=fp.mode, n=n, **ctx
            )
        if fp.mode == "error":
            raise FailpointError(
                str(fp.arg) if fp.arg else f"failpoint {name!r} armed (error)"
            )
        if fp.mode == "delay":
            time.sleep(float(fp.arg))
            return FailpointHit(name, "delay", n, True, fp.arg)
        if fp.mode == "hang":
            limit = min(float(fp.arg), MAX_HANG_S) if fp.arg else MAX_HANG_S
            fp.unhang.wait(timeout=limit)
            return FailpointHit(name, "hang", n, True, fp.arg)
        if fp.mode in ("truncate", "corrupt"):
            # Advisory: the call site tears (truncate) or byte-flips
            # (corrupt) its own output — docs/chaos.md catalog; sites
            # that do not understand the advice ignore the hit.
            return FailpointHit(name, fp.mode, n, True, fp.arg)
        # flap: fault value alternates every `period` triggers, starting
        # ACTIVE (the first probe after arming sees the fault).
        period = int(fp.arg) if fp.arg else 1
        return FailpointHit(
            name, "flap", n, ((n - 1) // period) % 2 == 0, fp.arg
        )


# Process-wide registry: the production call sites (plugin, engine,
# attribution) fire this one; cli.py / http_server main() arm it from
# --failpoints / TPU_FAILPOINTS and wire their flight recorders in.
DEFAULT = FailpointRegistry()

fire = DEFAULT.fire
arm = DEFAULT.arm
arm_spec = DEFAULT.arm_spec
disarm = DEFAULT.disarm
disarm_all = DEFAULT.disarm_all
is_armed = DEFAULT.is_armed
set_flight = DEFAULT.set_flight
snapshot = DEFAULT.snapshot


def fire_scoped(name: str, scope: str, **ctx) -> Optional[FailpointHit]:
    """Fire a scoped site then its generic parent on :data:`DEFAULT`.

    Call sites that fan out over dynamic peers (the router dials K
    replicas through ONE code path) need per-peer arming without
    minting K registry constants: ``fire_scoped("router.replica_conn",
    "10.0.0.7:8000")`` fires ``router.replica_conn.10.0.0.7:8000``
    first (arm it to fault ONE replica), then the bare
    ``router.replica_conn`` (arm it to fault every dial).  An ``error``
    arm on either raises before the other fires; ``ctx`` rides on both
    trigger events.  Disarmed both ways it is still just two dict
    truthiness checks."""
    hit = DEFAULT.fire(f"{name}.{scope}", **ctx)
    generic = DEFAULT.fire(name, scope=scope, **ctx)
    return hit if hit is not None else generic


def arm_from_env(environ=None) -> list[str]:
    """Arm :data:`DEFAULT` from ``TPU_FAILPOINTS`` (no-op when unset);
    returns the armed names.  Called by both CLI mains so a DaemonSet /
    serving pod can be chaos-armed via env alone."""
    environ = os.environ if environ is None else environ
    spec = environ.get(ENV, "")
    if not spec:
        return []
    return DEFAULT.arm_spec(spec)
