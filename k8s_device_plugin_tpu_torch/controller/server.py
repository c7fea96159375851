"""ControllerServer — the reconciler's daemon shell.

The port's own copy of the reference's ``controller/server.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

Pairs a tick loop (``stop.wait(interval_s)`` cadence, same shape as the
router's CanaryProber) with an HTTP surface reusing the shared
:class:`~..utils.metrics.MetricsServer`:

- ``GET /debug/controller`` — the reconciler's decision log, desired vs
  observed spec, replica-minutes ledger, and config (what
  ``tools/fleet_plan.py --controller-url`` renders).
- ``GET /metrics`` — the ``tpu_controller_*`` families; in the k8s
  shape this exposition IS the actuation surface
  (``tpu_controller_desired_replicas`` scraped by an external-metrics
  adapter — deploy/k8s-deploy-controller-gpu.yaml).
- ``GET /healthz`` — 200 while the tick loop is alive, 503 once it
  dies, so a liveness probe restarts a wedged controller.

A tick that raises is recorded (``controller.tick_error``) and the loop
continues — the controller must outlive any single bad snapshot.
"""

from __future__ import annotations

import threading

from ..utils.metrics import MetricsServer
from .reconciler import Reconciler


class ControllerServer:
    """Own the reconciler's tick thread + HTTP surface.  ``port=0``
    picks a free port (tests); ``.port`` reports it."""

    def __init__(
        self,
        reconciler: Reconciler,
        registry,
        *,
        host: str = "0.0.0.0",
        port: int = 8200,
        spans=None,
    ):
        self.reconciler = reconciler
        self.spans = spans
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Forensics parity with the router and plugin daemon: the
        # controller's flight ring and span ring are pullable surfaces,
        # so the fleet postmortem collector (router/postmortem.py) can
        # join controller decisions into an incident timeline.
        debug = {
            "/debug/controller": self._debug_controller,
            "/debug/state": self._debug_state,
        }
        if reconciler.flight is not None:
            debug["/debug/flight"] = reconciler.flight.snapshot
        if spans is not None:
            debug["/debug/spans"] = lambda query: spans.dump(
                trace_id=(query.get("rid") or [None])[0]
            )
        if reconciler.anomaly is not None:
            debug["/debug/incidents"] = reconciler.anomaly.snapshot
        self._http = MetricsServer(
            registry,
            host=host,
            port=port,
            health=self._loop_alive,
            debug=debug,
        )

    def _loop_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _debug_controller(self, query) -> dict:
        last = 32
        try:
            last = int(query.get("last", ["32"])[0])
        except (TypeError, ValueError):
            pass
        return self.reconciler.snapshot(last=last)

    def _debug_state(self) -> dict:
        """The controller's ``/debug/state``-equivalent — what the fleet
        postmortem collector pulls alongside flight/spans/metrics."""
        return {
            "component": "controller",
            "loop_alive": self._loop_alive(),
            "controller": self.reconciler.snapshot(last=32),
        }

    @property
    def port(self) -> int:
        return self._http.port

    def _run(self) -> None:
        while not self._stop.wait(self.reconciler.cfg.interval_s):
            try:
                self.reconciler.tick()
            except Exception as e:  # the loop must outlive a bad tick
                self.reconciler._record("controller.tick_error", error=str(e))

    def start(self) -> None:
        assert self._thread is None
        self._thread = threading.Thread(
            target=self._run, name="tpu-controller", daemon=True
        )
        self._thread.start()
        self._http.start()
        self.reconciler._record(
            "controller.started",
            interval_s=self.reconciler.cfg.interval_s,
            dry_run=self.reconciler.cfg.dry_run,
            actuator=getattr(self.reconciler.actuator, "name", "none"),
        )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._http.stop()
        self.reconciler._record(
            "controller.stopped", ticks=self.reconciler.ticks
        )
