"""gpu-device-plugin entry point.

Counterpart of the JAX package's ``plugin/cli.py``, with its flags
(``--root``, ``--plugin-dir``, ``--pulse``, ``--selftest-*``, ...): parse
flags, wire discovery + health + server + manager, install signal
handlers, block.  ``python -m k8s_device_plugin_tpu_torch.plugin.cli
--root <tree> --plugin-dir <dir> --pulse 0.3`` runs it against a fixture
host tree (see README.md).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from ..kubelet import constants
from ..utils import failpoints
from ..utils import flight as flight_mod
from ..utils.anomaly import AnomalyMonitor
from ..utils.logging import setup_logging
from ..utils.metrics import MetricsServer
from ..utils.spans import SpanRecorder
from . import discovery
from .attribution import AllocationLedger, PodAttributionPoller
from .health import CardHealthChecker
from .manager import DEFAULT_ENDPOINT, PluginManager
from .server import DEFAULT_REGISTRY, RESOURCE, GpuDevicePlugin, default_plugin_metrics

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpu-device-plugin",
        description="Kubernetes device plugin advertising nvidia.com/gpu cards",
    )
    p.add_argument(
        "--pulse",
        type=float,
        default=0.0,
        help="seconds between health polls (0 disables the heartbeat, as in the reference)",
    )
    p.add_argument(
        "--root",
        default="/",
        help="filesystem root for devfs/sysfs/metadata reads (tests/fixtures use a tempdir)",
    )
    p.add_argument(
        "--plugin-dir",
        default=constants.DEVICE_PLUGIN_PATH,
        help="kubelet device-plugin socket directory",
    )
    p.add_argument("--endpoint", default=DEFAULT_ENDPOINT, help="plugin socket filename")
    p.add_argument("--resource", default=RESOURCE, help="resource name to advertise")
    p.add_argument(
        "--resources",
        default="",
        help="comma-separated resource names sharing one namespace (e.g. "
        "'nvidia.com/gpu,nvidia.com/gpu-shared'): serve ALL of them through "
        "the multi-resource lifecycle manager (one plugin server + "
        "registration each, ≙ the reference's generic dpm lister contract). "
        "Overrides --resource/--endpoint.",
    )
    p.add_argument(
        "--require-chips",
        action="store_true",
        help="exit immediately if no NVIDIA cards are discovered (default: serve an empty list; "
        "the reference instead probed /sys/class/kfd before announcing, main.go:211-217)",
    )
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--json-logs", action="store_true", help="emit JSON log lines")
    p.add_argument(
        "--metrics-port",
        type=int,
        default=0,
        help="serve Prometheus /metrics (+ /healthz, /debug/devices, "
        "/debug/incidents, /debug/flight, /debug/spans) on this port "
        "(0 disables; beyond-reference observability, SURVEY.md §5.5/§7)",
    )
    p.add_argument(
        "--flight-ring",
        type=int,
        default=2048,
        help="capacity of the flight-recorder event ring (utils/flight.py: "
        "registrations, ListAndWatch updates, Allocates, health "
        "transitions) dumped on SIGUSR2/exit and served at /debug/flight",
    )
    p.add_argument(
        "--pod-resources-socket",
        default="",
        help="kubelet PodResources socket to poll for per-pod chip "
        "attribution (typically "
        f"{constants.POD_RESOURCES_SOCKET}; the DaemonSet yamls mount "
        "it).  Empty disables; an absent/unresponsive socket degrades "
        "gracefully (gpu_podresources_up 0) and the daemon otherwise "
        "runs exactly as without the flag",
    )
    p.add_argument(
        "--pod-resources-interval",
        type=float,
        default=10.0,
        help="seconds between PodResources attribution polls "
        "(ownership series, /debug/pods, allocation-reconciliation "
        "audit)",
    )
    p.add_argument(
        "--dump-dir",
        default=flight_mod.default_dump_dir() or "",
        help="directory for flight-recorder dumps: `kill -USR2 <pid>` "
        "writes one on demand, and the daemon writes a final one at exit "
        "when this is set (default: $TPU_PLUGIN_DUMP_DIR; the GPU "
        "DaemonSet yaml mounts /run/gpu/dump here)",
    )
    p.add_argument(
        "--dump-budget-mb",
        type=int,
        default=0,
        help="retention budget (MiB) for --dump-dir, shared by flight "
        "dumps and postmortem bundles (utils/postmortem.py): after "
        "every write the oldest entries are pruned until the directory "
        "fits (0 = unbounded)",
    )
    p.add_argument(
        "--health-flap-threshold",
        type=int,
        default=2,
        help="consecutive failed health sweeps before a Healthy chip is "
        "reported Unhealthy (debounce: one transient probe error must "
        "not flap the kubelet's device list and evict workloads; "
        "suppressed flips emit health.flap_suppressed flight events; "
        "1 restores report-on-first-failure)",
    )
    p.add_argument(
        "--selftest-interval",
        type=float,
        default=0.0,
        help="seconds between idle-chip self-test sweeps "
        "(plugin/selftest.py, docs/operations.md \"Active probing\"): "
        "chips the allocation ledger shows unallocated get a "
        "deterministic matmul-checksum probe; fail-threshold "
        "consecutive divergences fire a selftest.fail incident and "
        "quarantine the chip through the health override file before "
        "the kubelet places a pod on it.  0 disables (default)",
    )
    p.add_argument(
        "--selftest-fail-threshold",
        type=int,
        default=2,
        help="consecutive self-test checksum failures before the "
        "incident + quarantine (one blip never quarantines)",
    )
    p.add_argument(
        "--selftest-quarantine",
        type=int,
        choices=[0, 1],
        default=1,
        help="quarantine policy: 1 = a confirmed self-test failure "
        "writes the run/gpu/health/nvidiaN override (next health sweep "
        "reports Unhealthy); 0 = observe-only (incidents still fire)",
    )
    p.add_argument(
        "--failpoints",
        default="",
        help="arm chaos failpoints: 'name=mode[:arg][*count];...' with "
        "modes error/delay/hang/flap (utils/failpoints.py; catalog in "
        "docs/chaos.md).  Adds to any $TPU_FAILPOINTS arming; every "
        "trigger is a flight event, armed state at /debug/failpoints",
    )
    return p


def _build_multi_manager(args, new_plugin):
    """--resources path: every listed name gets its own plugin server and
    registration under one shared kubelet watch (plugin/resources.py)."""
    from .resources import MultiResourceManager, StaticLister

    pairs = []
    for full in args.resources.split(","):
        full = full.strip()
        if "/" not in full:
            raise SystemExit(
                f"--resources entries must be namespace/name, got {full!r}"
            )
        pairs.append(tuple(full.rsplit("/", 1)))
    namespaces = {ns for ns, _ in pairs}
    if len(namespaces) != 1:
        # The dpm lister contract scopes one manager to one namespace
        # (reference dpm/lister.go:13-16).
        raise SystemExit(
            f"--resources must share one namespace, got {sorted(namespaces)}"
        )

    lister = StaticLister(
        [name for _, name in pairs],
        lambda name: new_plugin(),
        namespace=namespaces.pop(),
    )
    return MultiResourceManager(
        lister, plugin_dir=args.plugin_dir, pulse=args.pulse
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, args.json_logs)

    # Forensics layer, one set per process shared by every resource's
    # plugin: the flight-recorder black box (registered so `kill -USR2`
    # and exit dump it — utils/flight.py), the anomaly monitor over
    # Allocate latency and health-sweep duration, and the daemon span
    # ring fed by timed_rpc (utils/tracing.py).
    box = flight_mod.register(
        flight_mod.FlightRecorder(capacity=args.flight_ring, name="daemon")
    )
    flight_mod.install_dump_handlers(args.dump_dir or None)
    if args.dump_budget_mb:
        flight_mod.set_dump_budget(args.dump_budget_mb * 1024 * 1024)
    # Chaos failpoints (utils/failpoints.py): env arming first, then the
    # flag adds/overrides; triggers become flight events in the same box
    # the detectors attach to incidents — injected cause and detected
    # effect land in one forensic timeline.
    failpoints.set_flight(box)
    failpoints.arm_from_env()
    if args.failpoints:
        failpoints.arm_spec(args.failpoints)
    monitor = AnomalyMonitor(
        flight=box,
        on_incident=lambda m: default_plugin_metrics().incidents.inc(metric=m),
    )
    monitor.configure(
        "plugin.health_sweep_seconds", warmup=30, z_threshold=6.0, sustain=3
    )
    spans = SpanRecorder(capacity=512)
    # One allocation ledger per process, shared by every resource's
    # plugin: Allocate grants land here and the attribution poller diffs
    # kubelet PodResources truth against it (plugin/attribution.py).
    ledger = AllocationLedger()

    def observe_sweep(dt: float) -> None:
        # One hook, two sinks: the Prometheus histogram operators scrape
        # and the EWMA baseline that turns a sustained slow sweep (wedged
        # sysfs/devfs) into an incident record.
        default_plugin_metrics().health_sweep_seconds.observe(dt)
        monitor.observe("plugin.health_sweep_seconds", dt)

    def new_plugin() -> GpuDevicePlugin:
        return GpuDevicePlugin(
            discover=lambda: discovery.discover(root=args.root),
            health_checker=CardHealthChecker(
                root=args.root,
                observe_sweep_seconds=observe_sweep,
                flight=box,
                flap_threshold=args.health_flap_threshold,
            ),
            metrics=default_plugin_metrics(),
            flight=box,
            anomaly=monitor,
            spans=spans,
            ledger=ledger,
            root=args.root,
        )

    debug_endpoints = {
        "/debug/incidents": monitor.snapshot,
        "/debug/flight": box.snapshot,
        "/debug/failpoints": failpoints.snapshot,
        # ?rid=<trace id> filters to one request's tree (the trace
        # assembler's live mode; MetricsServer hands query-declaring
        # callables the parsed query dict).
        "/debug/spans": lambda query: spans.dump(
            trace_id=(query.get("rid") or [None])[0]
        ),
    }
    if args.resources:
        # Multi-resource mode builds one plugin per resource inside the
        # manager; probe inventory directly rather than via a throwaway plugin.
        inventory = discovery.discover(root=args.root)
        served = args.resources
    else:
        plugin = new_plugin()
        inventory = plugin.inventory  # discovery already ran once in the ctor
        served = args.resource
        # Device snapshot next to /metrics: what this node is advertising.
        debug_endpoints["/debug/devices"] = plugin.debug_state
    if args.require_chips and inventory.card_count == 0:
        log.error("no NVIDIA cards found under %s and --require-chips is set", args.root)
        return 1
    if args.resources:
        manager = _build_multi_manager(args, new_plugin)
    else:
        manager = PluginManager(
            plugin,
            plugin_dir=args.plugin_dir,
            endpoint=args.endpoint,
            resource=args.resource,
            pulse=args.pulse,
        )
    poller = None
    if args.pod_resources_socket:
        # Per-pod chip attribution + allocation-reconciliation audit.
        # In multi-resource mode the plugins live inside the manager, so
        # the /debug/pods join degrades to device IDs without the
        # discovery/topology fields; the single-resource daemon joins
        # the full chip info.
        resource_names = (
            {p.strip() for p in args.resources.split(",") if p.strip()}
            if args.resources
            else {args.resource}
        )
        poller = PodAttributionPoller(
            args.pod_resources_socket,
            metrics=default_plugin_metrics(),
            ledger=ledger,
            resources=resource_names,
            device_info=None if args.resources else plugin.device_info,
            flight=box,
            anomaly=monitor,
            interval_s=args.pod_resources_interval,
        )
        debug_endpoints["/debug/pods"] = poller.snapshot
    selftest = None
    if args.selftest_interval > 0:
        # Idle-chip self-test sweep (plugin/selftest.py): the plugin
        # half of the active correctness plane.  Discovery re-runs per
        # sweep (chips unplug); the ledger arbitrates idleness.
        from .selftest import SelftestConfig, SelftestSweeper

        selftest = SelftestSweeper(
            lambda: discovery.discover(root=args.root).cards,
            ledger.granted,
            config=SelftestConfig(
                interval_s=args.selftest_interval,
                fail_threshold=args.selftest_fail_threshold,
                quarantine=bool(args.selftest_quarantine),
            ),
            root=args.root,
            metrics=default_plugin_metrics(),
            flight=box,
            anomaly=monitor,
        )
        debug_endpoints["/debug/selftest"] = selftest.snapshot

    def daemon_state() -> dict:
        # The daemon's /debug/state-equivalent: the non-query debug
        # surfaces joined into one snapshot — what the fleet postmortem
        # collector pulls alongside flight/spans/metrics, and what the
        # local capture hook writes as state.json.
        state = {"component": "daemon", "served": served}
        for path, fn in debug_endpoints.items():
            if path in ("/debug/flight", "/debug/spans", "/debug/state"):
                continue  # own evidence files / this aggregate itself
            try:
                state[path.rsplit("/", 1)[-1]] = fn()
            except Exception as e:
                state[path.rsplit("/", 1)[-1]] = {"error": str(e)}
        return state

    debug_endpoints["/debug/state"] = daemon_state
    if args.dump_dir:
        # Incident-triggered local postmortem capture
        # (utils/postmortem.py): every incident the monitor emits —
        # slow health sweeps, attribution drift, self-test failures —
        # snapshots the daemon's forensic state into a content-addressed
        # bundle under --dump-dir, debounced per cause metric.
        from ..utils.postmortem import PostmortemCapture

        capture = PostmortemCapture(
            "daemon",
            args.dump_dir,
            flight=box,
            spans=spans,
            registry=DEFAULT_REGISTRY,
            state_fn=daemon_state,
            budget_bytes=(
                args.dump_budget_mb * 1024 * 1024
                if args.dump_budget_mb
                else None
            ),
        )
        monitor.add_listener(capture.on_incident)
        debug_endpoints["/debug/postmortem"] = capture.snapshot
    metrics_server = None

    def _on_signal(signum, _frame):
        log.info("received %s; shutting down", signal.Signals(signum).name)
        manager.shutdown()

    try:
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGQUIT):
            signal.signal(sig, _on_signal)
    except ValueError:
        # Not on the main interpreter thread (hermetic tests drive main() from
        # a worker thread); shutdown is then delivered via manager.shutdown().
        log.debug("not on main thread; skipping signal handlers")

    log.info(
        "starting %s plugin: %d card(s), plugin_dir=%s, pulse=%.1fs",
        served,
        inventory.card_count,
        args.plugin_dir,
        args.pulse,
    )
    try:
        if args.metrics_port:
            metrics_server = MetricsServer(
                DEFAULT_REGISTRY,
                port=args.metrics_port,
                health=manager.alive,
                debug=debug_endpoints,
            )
            metrics_server.start()
            log.info(
                "metrics on :%d/metrics (+ %s)",
                metrics_server.port,
                " ".join(sorted(debug_endpoints)),
            )
        if poller is not None:
            poller.start()
        if selftest is not None:
            selftest.start()
        manager.run()
    finally:
        if selftest is not None:
            selftest.stop()
        if poller is not None:
            poller.stop()
        if metrics_server is not None:
            metrics_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
