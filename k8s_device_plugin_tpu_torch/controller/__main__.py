"""CLI for the fleet autoscaler: ``python -m k8s_device_plugin_tpu_torch.controller``.

The port's own copy of the reference's ``controller/__main__.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

Safe by default: ``--dry-run 1`` and ``--actuator none`` — point it at a
router and it observes, logging every decision it WOULD make to its
flight ring and ``GET /debug/controller`` without touching the fleet.
Arming it is two explicit choices: ``--dry-run 0 --actuator k8s``.

The knobs mirror :class:`~.reconciler.ControllerConfig`; the full
decision table and triage runbook live in docs/operations.md ("Fleet
autoscaling").
"""

from __future__ import annotations

import argparse
import sys
import time

from ..utils import flight as flight_mod
from ..utils.anomaly import AnomalyMonitor
from ..utils.flight import FlightRecorder, install_dump_handlers
from ..utils.metrics import MetricsRegistry
from ..utils.spans import SpanRecorder
from .actuators import KubernetesActuator, NullActuator
from .reconciler import (
    ControllerConfig,
    ControllerMetrics,
    Reconciler,
    fetch_fleet,
)
from .server import ControllerServer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m k8s_device_plugin_tpu_torch.controller",
        description=(
            "closed-loop fleet autoscaler: polls a router's /debug/fleet, "
            "computes a desired fleet spec from the host-side pressure "
            "signals, and converges the fleet through an actuator — role "
            "flips before hardware, warm scale-up, drain-down"
        ),
    )
    p.add_argument(
        "--url",
        required=True,
        help="router base URL to reconcile (e.g. http://router:8100)",
    )
    p.add_argument(
        "--host",
        default="0.0.0.0",
        help="bind host for the controller's own HTTP surface",
    )
    p.add_argument(
        "--port",
        type=int,
        default=8200,
        help="controller HTTP port (/metrics, /healthz, /debug/controller)",
    )
    p.add_argument(
        "--interval",
        type=float,
        default=5.0,
        help="seconds between reconcile ticks",
    )
    p.add_argument(
        "--dry-run",
        type=int,
        choices=[0, 1],
        default=1,
        help=(
            "1 (default): observe-only — decisions are computed, logged, "
            "and metered but the actuator is never called; 0 arms actuation"
        ),
    )
    p.add_argument(
        "--actuator",
        choices=["none", "k8s"],
        default="none",
        help=(
            "actuation backend: none refuses every action (pair with "
            "--dry-run 1); k8s exposes desired counts for an "
            "external-metrics adapter and dials replica admin endpoints "
            "for role flips (deploy/k8s-deploy-controller-gpu.yaml)"
        ),
    )
    p.add_argument(
        "--sustain-ticks",
        type=int,
        default=3,
        help=(
            "consecutive ticks a verdict must repeat before acting — the "
            "hysteresis/flap guard"
        ),
    )
    p.add_argument(
        "--cooldown-s",
        type=float,
        default=30.0,
        help="seconds after any action before the next one",
    )
    p.add_argument(
        "--max-actions-per-tick",
        type=int,
        default=1,
        help="ceiling on actions per reconcile tick",
    )
    p.add_argument(
        "--min-replicas",
        type=int,
        default=1,
        help="never drain the decode-capable pool below this",
    )
    p.add_argument(
        "--max-replicas",
        type=int,
        default=0,
        help="never scale the fleet above this (0 = uncapped)",
    )
    p.add_argument(
        "--hot-wait",
        type=float,
        default=2.0,
        help=(
            "queue-wait seconds above which a prefill replica counts as "
            "saturated (fallback when the router snapshot carries no "
            "thresholds)"
        ),
    )
    p.add_argument(
        "--cold-wait",
        type=float,
        default=0.5,
        help=(
            "queue-wait seconds below which a replica counts as idle / "
            "flip-eligible (fallback, as --hot-wait)"
        ),
    )
    p.add_argument(
        "--decision-log",
        type=int,
        default=256,
        help="decision-log ring capacity served at /debug/controller",
    )
    p.add_argument(
        "--dump-dir",
        default=flight_mod.default_dump_dir() or "",
        help="directory for flight dumps and postmortem bundles "
        "(default: $TPU_PLUGIN_DUMP_DIR): SIGUSR2/exit dumps the "
        "flight ring, and every actuator-failure incident snapshots "
        "the controller's forensic state (utils/postmortem.py)",
    )
    p.add_argument(
        "--dump-budget-mb",
        type=int,
        default=0,
        help="retention budget (MiB) for --dump-dir, shared by flight "
        "dumps and postmortem bundles: after every write the oldest "
        "entries are pruned until the directory fits (0 = unbounded)",
    )
    args = p.parse_args(argv)

    try:
        cfg = ControllerConfig(
            interval_s=args.interval,
            sustain_ticks=args.sustain_ticks,
            cooldown_s=args.cooldown_s,
            max_actions_per_tick=args.max_actions_per_tick,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            hot_wait_s=args.hot_wait,
            cold_wait_s=args.cold_wait,
            dry_run=bool(args.dry_run),
            decision_log=args.decision_log,
        )
    except ValueError as e:
        p.error(str(e))

    registry = MetricsRegistry()
    # Registered so SIGUSR2/atexit dumps include the controller's ring;
    # the span ring rides the same dumps (trace-assembler input).
    flight = flight_mod.register(
        FlightRecorder(capacity=2048, name="controller")
    )
    spans = flight_mod.register_spans(
        SpanRecorder(capacity=512, name="controller")
    )
    install_dump_handlers(args.dump_dir or None)
    if args.dump_budget_mb:
        flight_mod.set_dump_budget(args.dump_budget_mb * 1024 * 1024)
    anomaly = AnomalyMonitor(flight=flight)
    actuator = (
        KubernetesActuator() if args.actuator == "k8s" else NullActuator()
    )
    reconciler = Reconciler(
        lambda: fetch_fleet(args.url),
        actuator,
        config=cfg,
        metrics=ControllerMetrics(registry),
        flight=flight,
        anomaly=anomaly,
    )
    server = ControllerServer(
        reconciler, registry, host=args.host, port=args.port, spans=spans
    )
    if args.dump_dir:
        # Incident-triggered local postmortem capture: an actuator
        # failure snapshots the decision log + flight ring before the
        # rings roll (utils/postmortem.py).
        from ..utils.postmortem import PostmortemCapture

        capture = PostmortemCapture(
            "controller",
            args.dump_dir,
            flight=flight,
            spans=spans,
            registry=registry,
            state_fn=server._debug_state,
            budget_bytes=(
                args.dump_budget_mb * 1024 * 1024
                if args.dump_budget_mb
                else None
            ),
        )
        anomaly.add_listener(capture.on_incident)
    server.start()
    print(
        f"controller: reconciling {args.url} every {cfg.interval_s}s "
        f"(dry_run={cfg.dry_run}, actuator={actuator.name}) — "
        f"http on {args.host}:{server.port}",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
