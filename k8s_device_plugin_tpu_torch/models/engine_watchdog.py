"""Replica self-fencing inputs: hung-step watchdog + chip-health feed.

The port's own copy of the reference's ``models/engine_watchdog.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py, and
:func:`visible_chip_paths` also reads the GPU device plugin's env.

The stack can survive replica *loss* (router failover) and replica
*overload* (admission shedding), but a replica that is merely *sick*
keeps taking traffic: a hung device step (the ``engine.readback`` hang
failpoint models the real shape — a wedged DMA/readback that never
returns) freezes the owner loop with every detector blind (the step-time
anomaly monitor only sees COMPLETED steps), and the plugin daemon
marking a chip Unhealthy for the kubelet does nothing to the serving
engine already running on that chip.  Host-Side Telemetry (PAPERS.md)
argues exactly this: hang/degradation diagnosis must come from
host-side watchdogs that do not require device cooperation.

Two detectors, both stdlib-only and thread-driven so a wedged engine
owner thread cannot take the detector down with it:

- :class:`StepWatchdog` — deadlines every dispatched engine step against
  a rolling baseline of recently COMPLETED step wall times (the same
  walls the per-step profiler windows).  Compile-aware grace: steps that
  build a new jitted program, advance a prefill, or activate an
  admission get the long ``grace_deadline_s`` instead of the tight
  ``factor * baseline`` one, so a first-shape XLA compile (tens of
  seconds) never false-trips; so does everything before ``warmup``
  completed steps.  On breach it calls ``on_fence`` ONCE (re-armed via
  :meth:`rearm` after an operator unfence).
- :class:`ChipHealthFeed` — watches the chips the engine is actually
  decoding on: polls the plugin daemon's ``/debug/devices`` surface
  (authoritative — native probes, flap debounce, unplug detection) and
  falls back to direct ``/dev/accel*`` presence probes when no daemon
  URL is configured or the daemon stops answering.  A chip going
  Unhealthy or vanishing fences the replica instead of letting it serve
  garbage.

The fence itself (admission 503, ``/healthz`` -> fenced, summary
``fenced`` for the router's poll loop, stream cut for zero-drop
failover, KV-arena snapshot) lives on ``models/http_server.EngineServer``
— these classes only decide WHEN.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from typing import Callable, Optional


def visible_chip_paths(environ=None, root: str = "/") -> list[str]:
    """Device-node paths of the chips allocated to THIS pod, from the env
    the device plugin's Allocate response injects: the GPU plugin's
    ``GPU_DEVICE_MINORS`` (``"0,1"`` -> ``[/dev/nvidia0, /dev/nvidia1]``),
    else the TPU plugin's ``TPU_VISIBLE_CHIPS`` (``"0,1"`` ->
    ``[/dev/accel0, /dev/accel1]``); empty off-cluster.  ``root`` is the
    injectable host-tree root the rest of the plugin test surface uses."""
    environ = os.environ if environ is None else environ
    for name, node in (("GPU_DEVICE_MINORS", "nvidia"), ("TPU_VISIBLE_CHIPS", "accel")):
        text = environ.get(name, "") or ""
        if text:
            break
    out: list[str] = []
    for part in text.replace(",", " ").split():
        try:
            idx = int(part)
        except ValueError:
            return []
        out.append(os.path.join(root, f"dev/{node}{idx}"))
    return out


class StepWatchdog:
    """Host-side deadline on every dispatched engine step.

    Protocol (engine owner thread): ``step_started()`` at the top of
    ``ServingEngine.step()``, ``note_grace(reason)`` any time during the
    step that a long stall is LEGITIMATE (new jitted program built,
    prefill chunk advanced, admission activated), ``step_finished(wall)``
    at the end.  A separate daemon thread (or a test calling
    :meth:`check` on a fake clock) compares the in-flight step's age
    against the applicable deadline:

    - grace step, or fewer than ``warmup`` completed steps:
      ``grace_deadline_s`` (a compile may run tens of seconds);
    - otherwise ``max(min_deadline_s, factor * p99(recent walls))``.

    Only non-grace, non-tripped walls feed the baseline, so neither a
    compile outlier nor the hang itself can inflate the deadline.  The
    trip fires ``on_fence(info)`` exactly once per arm; :meth:`rearm`
    (the unfence path) re-enables it.  ``clock`` is injectable so the
    unit suite drives warmup/grace/trip on a fake clock with zero
    sleeps.
    """

    def __init__(
        self,
        on_fence: Callable[[dict], None],
        *,
        clock: Callable[[], float] = time.monotonic,
        window: int = 64,
        warmup: int = 8,
        factor: float = 8.0,
        min_deadline_s: float = 1.0,
        grace_deadline_s: float = 60.0,
        poll_interval_s: float = 0.25,
        observe_deadline: Optional[Callable[[float], None]] = None,
    ):
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        if min_deadline_s <= 0 or grace_deadline_s <= 0:
            raise ValueError("deadlines must be > 0")
        self.on_fence = on_fence
        self._clock = clock
        self._warmup = warmup
        self._factor = factor
        self._min_deadline_s = float(min_deadline_s)
        self._grace_deadline_s = float(grace_deadline_s)
        self._poll_interval_s = float(poll_interval_s)
        self._observe_deadline = observe_deadline
        self._lock = threading.Lock()
        self._walls: list[float] = []
        self._window = int(window)
        self._completed = 0
        self._in_step = False
        self._step_start = 0.0
        self._step_grace: Optional[str] = None
        self._step_tripped = False
        self.tripped = False
        self.trips = 0
        self.grace_steps = 0
        self._last_trip: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------- owner-thread hooks

    def step_started(self) -> None:
        with self._lock:
            self._in_step = True
            self._step_start = self._clock()
            self._step_grace = None
            self._step_tripped = False

    def note_grace(self, reason: str) -> None:
        """Mark the CURRENT step as legitimately slow (compile, prefill,
        activation): its deadline becomes ``grace_deadline_s`` and its
        wall never feeds the baseline."""
        with self._lock:
            if self._step_grace is None:
                self.grace_steps += 1
            self._step_grace = str(reason)

    def step_finished(self, wall_s: float) -> None:
        with self._lock:
            self._in_step = False
            if self._step_grace is None and not self._step_tripped:
                self._walls.append(float(wall_s))
                if len(self._walls) > self._window:
                    del self._walls[0]
                self._completed += 1
            deadline = self._deadline_locked()
        if self._observe_deadline is not None:
            self._observe_deadline(deadline)

    # ---------------------------------------------------------- deadline

    def _baseline_locked(self) -> float:
        """Nearest-rank p99 over the rolling window of completed walls."""
        if not self._walls:
            return 0.0
        walls = sorted(self._walls)
        return walls[min(int(0.99 * len(walls)), len(walls) - 1)]

    def _deadline_locked(self) -> float:
        if self._step_grace is not None or self._completed < self._warmup:
            return self._grace_deadline_s
        return max(self._min_deadline_s, self._factor * self._baseline_locked())

    def deadline_s(self) -> float:
        """The deadline the CURRENT (or next) step is judged against."""
        with self._lock:
            return self._deadline_locked()

    # -------------------------------------------------------------- check

    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """One watchdog poll: trip (and fire ``on_fence``) when the
        in-flight step has outlived its deadline.  Returns the trip info
        dict, or None.  Fires at most once per arm."""
        with self._lock:
            if self.tripped or not self._in_step:
                return None
            now = self._clock() if now is None else now
            deadline = self._deadline_locked()
            age = now - self._step_start
            if age <= deadline:
                return None
            self.tripped = True
            self._step_tripped = True
            self.trips += 1
            info = {
                "kind": "hung_step",
                "observed_s": round(age, 3),
                "deadline_s": round(deadline, 3),
                "baseline_s": round(self._baseline_locked(), 6),
                "grace": self._step_grace,
                "completed_steps": self._completed,
            }
            self._last_trip = info
        self.on_fence(info)
        return info

    def rearm(self) -> None:
        """Re-enable tripping (the unfence path).  The in-flight flag is
        left as-is: if the step is STILL hung the next poll trips again
        — an operator unfencing a wedged replica learns immediately."""
        with self._lock:
            self.tripped = False

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="engine-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            self.check()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "in_step": self._in_step,
                "completed_steps": self._completed,
                "baseline_p99_ms": round(self._baseline_locked() * 1e3, 4),
                "deadline_s": round(self._deadline_locked(), 4),
                "warmup": self._warmup,
                "factor": self._factor,
                "grace_steps": self.grace_steps,
                "tripped": self.tripped,
                "trips": self.trips,
                "last_trip": self._last_trip,
            }


class ChipHealthFeed:
    """Node-local health watch over the chips this replica decodes on.

    Primary source: the plugin daemon's ``GET /debug/devices`` snapshot
    (``url``) — per-chip ``healthy`` verdicts behind the native prober
    and the flap debounce, plus unplug detection (a yanked chip leaves
    the inventory entirely).  Fallback: after
    ``url_failures_to_fallback`` consecutive poll failures (or with no
    URL configured), direct presence probes of ``device_paths`` — the
    daemon being down is a daemon problem, but once it is down the
    devfs node is the only truth left, and a VANISHED node is
    unambiguous.  A daemon outage alone never fences (recorded as a
    ``chip_health.feed_down`` flight event instead).

    ``on_unhealthy(info)`` fires once per arm (``rearm()`` on unfence);
    drive :meth:`check_once` directly in tests, or :meth:`start` the
    poll thread in production.
    """

    def __init__(
        self,
        on_unhealthy: Callable[[dict], None],
        *,
        url: str = "",
        device_paths=(),
        poll_interval_s: float = 1.0,
        url_timeout_s: float = 2.0,
        url_failures_to_fallback: int = 3,
        flight=None,
    ):
        if not url and not device_paths:
            raise ValueError(
                "chip-health feed needs a daemon URL and/or device paths"
            )
        self.on_unhealthy = on_unhealthy
        self.url = url
        self.device_paths = [str(p) for p in device_paths]
        self._poll_interval_s = float(poll_interval_s)
        self._url_timeout_s = float(url_timeout_s)
        self._url_failures_to_fallback = int(url_failures_to_fallback)
        self.flight = flight
        self._url_failures = 0
        self._feed_down_recorded = False
        self.tripped = False
        self.checks = 0
        self._last_fault: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- probes

    def _probe_url(self) -> Optional[dict]:
        """One daemon poll; returns a fault dict, None (all healthy), or
        raises OSError/ValueError on a daemon failure."""
        with urllib.request.urlopen(
            self.url, timeout=self._url_timeout_s
        ) as resp:
            payload = json.loads(resp.read() or b"{}")
        chips = payload.get("chips") or []
        by_base = {
            os.path.basename(c.get("device_path") or ""): c for c in chips
        }
        if self.device_paths:
            for path in self.device_paths:
                base = os.path.basename(path)
                chip = by_base.get(base)
                if chip is None:
                    # Left the daemon's inventory: /dev/accel* is
                    # authoritative for existence — the chip is GONE.
                    return {
                        "kind": "unplugged", "device": base, "probe": "daemon",
                    }
                if not chip.get("healthy", False):
                    return {
                        "kind": "unhealthy", "device": base, "probe": "daemon",
                    }
            return None
        for chip in chips:
            if not chip.get("healthy", False):
                return {
                    "kind": "unhealthy",
                    "device": str(chip.get("id")),
                    "probe": "daemon",
                }
        return None

    def _probe_devfs(self) -> Optional[dict]:
        for path in self.device_paths:
            if not os.path.exists(path):
                return {
                    "kind": "unplugged",
                    "device": os.path.basename(path),
                    "probe": "devfs",
                }
        return None

    def _probe(self) -> Optional[dict]:
        if self.url:
            try:
                fault = self._probe_url()
            except (OSError, ValueError) as e:
                self._url_failures += 1
                if (
                    self.flight is not None
                    and not self._feed_down_recorded
                ):
                    self._feed_down_recorded = True
                    self.flight.record(
                        "chip_health.feed_down", url=self.url, error=str(e)
                    )
                if (
                    self.device_paths
                    and self._url_failures >= self._url_failures_to_fallback
                ):
                    # Daemon gone: devfs presence is the only truth left.
                    return self._probe_devfs()
                return None
            if self._url_failures and self.flight is not None:
                self.flight.record("chip_health.feed_up", url=self.url)
            self._url_failures = 0
            self._feed_down_recorded = False
            return fault
        return self._probe_devfs()

    # --------------------------------------------------------------- check

    def check_once(self) -> Optional[dict]:
        """One health poll; fires ``on_unhealthy(info)`` (once per arm)
        and returns the fault info when a chip is unhealthy/unplugged."""
        self.checks += 1
        fault = self._probe()
        if fault is None or self.tripped:
            return fault if not self.tripped else None
        self.tripped = True
        self._last_fault = fault
        self.on_unhealthy(fault)
        return fault

    def rearm(self) -> None:
        self.tripped = False

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "ChipHealthFeed":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="chip-health-feed", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            self.check_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def snapshot(self) -> dict:
        return {
            "url": self.url or None,
            "device_paths": list(self.device_paths),
            "checks": self.checks,
            "url_failures": self._url_failures,
            "tripped": self.tripped,
            "last_fault": self._last_fault,
        }
