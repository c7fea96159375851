"""The nvidia.com/gpu DevicePlugin gRPC service.

Counterpart of the JAX package's ``plugin/server.py`` (the
``google.com/tpu`` servicer), keeping its fixes over the reference
plugin: ``ListAndWatch`` rebuilds the full device list on every update
and re-runs discovery on each poll (hot-unplug shows), health is per
card, and ``Allocate`` honours the requested IDs.  For NVIDIA cards:

- ``Allocate`` grants exactly the requested ``/dev/nvidiaN`` nodes, the
  shared control nodes the host has (``/dev/nvidiactl``,
  ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools``) and the env of
  ``envs.py``.  :func:`container_grant` builds one container's grant as
  plain data; the servicer wraps it in the protobuf response.
- ``GetPreferredAllocation`` prefers the fewest NUMA nodes
  (``topology.select_numa_local``): the cards meet all to all through
  NVSwitch, so NUMA locality is the placement that matters.  Its
  ``preferred_allocations`` counter keeps the reference's results:
  ``contiguous`` (one NUMA node), ``fragmented`` (more than one) and
  ``unknown_device``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable

import grpc

from ..kubelet import constants
from ..kubelet.api import pb
from ..utils import failpoints, tracing
from ..utils.anomaly import AnomalyMonitor
from ..utils.flight import FlightRecorder
from ..utils.metrics import MetricsRegistry
from ..utils.spans import SpanRecorder
from .discovery import GpuCard, GpuHostInventory
from .envs import allocation_annotations, allocation_envs
from .health import CardHealthChecker
from .topology import numa_nodes_of, select_numa_local

log = logging.getLogger(__name__)

RESOURCE_NAMESPACE = "nvidia.com"
RESOURCE_NAME = "gpu"
RESOURCE = f"{RESOURCE_NAMESPACE}/{RESOURCE_NAME}"

# Driver nodes every CUDA process opens besides its cards' own, granted
# with every allocation where the host has them.
SHARED_DEVICE_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools")


def _chip_index_key(device_id: str) -> tuple[int, str]:
    """Numeric-aware sort key: ``gpu-2`` orders before ``gpu-10``
    (a lexicographic sort would not, on hosts with more than 10 cards)."""
    _, _, tail = device_id.rpartition("-")
    return (int(tail), device_id) if tail.isdigit() else (1 << 30, device_id)

# Process-wide registry: the daemon has exactly one plugin+manager, and a
# single registry keeps the /metrics endpoint wiring trivial.  Tests that need
# isolation construct their own MetricsRegistry and pass it in.
DEFAULT_REGISTRY = MetricsRegistry()

_default_metrics = None
_default_metrics_lock = threading.Lock()


def default_plugin_metrics() -> "PluginMetrics":
    """The PluginMetrics bound to DEFAULT_REGISTRY, created once (metric names
    may only be registered once per registry, and main() may run more than
    once in one process — hermetic tests do)."""
    global _default_metrics
    with _default_metrics_lock:
        if _default_metrics is None:
            _default_metrics = PluginMetrics(DEFAULT_REGISTRY)
        return _default_metrics


class PluginMetrics:
    """The plugin's instrumentation, named in Prometheus conventions.

    Beyond-reference observability (SURVEY.md §5.5 records the reference has
    none); every load-bearing event in the serve/stream/allocate paths gets a
    series here.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.chips = registry.gauge(
            "gpu_plugin_chips", "Discovered NVIDIA cards by health state", ["state"]
        )
        self.device_updates = registry.counter(
            "gpu_plugin_device_updates_total",
            "State versions published to ListAndWatch streams",
        )
        self.health_transitions = registry.counter(
            "gpu_plugin_health_transitions_total",
            "Per-chip Healthy<->Unhealthy flips observed by polling",
            ["direction"],
        )
        self.streams = registry.gauge(
            "gpu_plugin_listandwatch_streams", "Open ListAndWatch streams"
        )
        self.allocations = registry.counter(
            "gpu_plugin_allocations_total",
            "Container allocation requests by outcome",
            ["outcome"],
        )
        self.allocated_chips = registry.counter(
            "gpu_plugin_allocated_chips_total", "Chips handed out by Allocate"
        )
        self.allocation_latency = registry.summary(
            "gpu_plugin_allocation_latency_seconds",
            "Wall time of Allocate RPCs (BASELINE.json secondary metric)",
        )
        self.allocate_seconds = registry.histogram(
            "gpu_plugin_allocate_seconds",
            "Wall time of Allocate RPCs (histogram: the p99 < 50 ms "
            "budget of docs/operations.md needs quantiles, which the "
            "older summary series cannot provide)",
            buckets=(
                0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0,
            ),
        )
        self.device_health = registry.gauge(
            "gpu_plugin_device_health",
            "Per-chip health (1 Healthy, 0 Unhealthy) as streamed to the "
            "kubelet; series are removed when a chip is unplugged",
            ["device"],
        )
        self.health_sweep_seconds = registry.histogram(
            "gpu_plugin_health_sweep_seconds",
            "Wall time of one full-inventory health sweep (the per-pulse "
            "hot path; native-prober sweeps are one FFI crossing)",
        )
        self.poll_failures = registry.counter(
            "gpu_plugin_poll_failures_total",
            "Heartbeat discovery/health polls that raised (the daemon "
            "keeps serving the last good snapshot)",
        )
        self.preferred_allocations = registry.counter(
            "gpu_plugin_preferred_allocations_total",
            "GetPreferredAllocation container requests by result",
            ["result"],
        )
        self.registrations = registry.counter(
            "gpu_plugin_registrations_total", "Successful kubelet registrations"
        )
        self.kubelet_restarts = registry.counter(
            "gpu_plugin_kubelet_restarts_total",
            "kubelet.sock recreations observed by the watcher",
        )
        self.incidents = registry.counter(
            "gpu_plugin_incidents_total",
            "Anomaly incidents emitted by the daemon-side monitor "
            "(utils/anomaly.py: Allocate latency, health-sweep duration); "
            "records served at the MetricsServer's /debug/incidents",
            ["metric"],
        )
        # Idle-chip self-test sweep (plugin/selftest.py, --selftest-*):
        # active correctness probes on chips the allocation ledger shows
        # idle.  Verdict is a closed set (pass/fail/skip_busy/error).
        self.selftests = registry.counter(
            "gpu_chip_selftest_total",
            "Idle-chip self-test probes per chip and verdict (pass: "
            "matmul checksum bit-exact; fail: diverged — "
            "fail_threshold consecutive fires selftest.fail and "
            "quarantines via the health override file; skip_busy: "
            "ledger shows the chip allocated, never probed; error: "
            "probe machinery raised)",
            ["device", "verdict"],
        )
        self.selftest_seconds = registry.histogram(
            "gpu_chip_selftest_seconds",
            "Wall time of one idle-card self-test probe (the seeded "
            "product in float64 on the card, cast to int64, crc32)",
            buckets=(
                0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 1.0,
            ),
        )
        self.selftest_quarantined = registry.gauge(
            "gpu_chip_selftest_quarantined",
            "1 while the chip sits quarantined by a failed self-test "
            "(health override file written; operator removes it to "
            "recover — docs/operations.md triage table)",
            ["device"],
        )
        # --- pod attribution (plugin/attribution.py).  Cardinality is
        # bounded by the host's chip count (<= 16): at most one
        # owner-info series per chip and one gpu_pod_chips series per
        # chip-holding pod; series are removed the poll after their pod
        # goes away (the unplug pattern of device_health).
        self.chip_owner = registry.gauge(
            "gpu_chip_owner_info",
            "Chip ownership joined from the kubelet PodResources API: "
            "constant 1 per (device, namespace, pod, container); series "
            "removed when the pod releases the chip",
            ["device", "namespace", "pod", "container"],
        )
        self.pod_chips = registry.gauge(
            "gpu_pod_chips",
            "Chips the kubelet currently attributes to each pod; series "
            "removed when the pod goes away",
            ["namespace", "pod"],
        )
        self.attribution_attributed = registry.gauge(
            "gpu_attribution_attributed_chips",
            "Chips the kubelet currently attributes to pods (attributed "
            "< allocatable is normal slack; attributed > allocatable is "
            "drift territory)",
        )
        self.attribution_allocatable = registry.gauge(
            "gpu_attribution_allocatable_chips",
            "Allocatable devices reported by the kubelet's "
            "GetAllocatableResources for the plugin's resources",
        )
        self.podresources_up = registry.gauge(
            "gpu_podresources_up",
            "1 when the kubelet PodResources socket answered the last "
            "attribution poll; 0 when unconfigured, absent, or "
            "unresponsive (the daemon degrades gracefully either way)",
        )
        self.attribution_poll_seconds = registry.histogram(
            "gpu_attribution_poll_seconds",
            "Wall time of one PodResources attribution poll (List + "
            "periodic GetAllocatableResources + ownership diff + "
            "reconciliation audit); budget < 1 ms against a local socket",
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 1.0,
            ),
        )
        self.attribution_drift = registry.counter(
            "gpu_attribution_drift_total",
            "Allocation-reconciliation drift: kubelet attributes a chip "
            "the plugin never granted (kind=ungranted) or a granted chip "
            "the kubelet never surfaced within the confirmation grace "
            "(kind=unfulfilled)",
            ["kind"],
        )


class GpuDevicePlugin:
    """DevicePlugin servicer for one node's NVIDIA cards.

    Thread-safe: the manager's heartbeat thread calls :meth:`poll_once` while
    kubelet RPCs arrive on gRPC worker threads; every ListAndWatch stream
    waits on one condition variable and re-sends a full snapshot whenever the
    state version advances.
    """

    def __init__(
        self,
        discover: Callable[[], GpuHostInventory],
        health_checker: CardHealthChecker,
        metrics: PluginMetrics | None = None,
        flight: FlightRecorder | None = None,
        anomaly: AnomalyMonitor | None = None,
        spans: SpanRecorder | None = None,
        ledger=None,
        root: str = "/",
    ):
        self._discover = discover
        self._health_checker = health_checker
        # Where the shared control nodes granted by Allocate are looked up
        # (discovery's root; the granted paths are the real ones).
        self._root = root
        self.metrics = metrics if metrics is not None else PluginMetrics(MetricsRegistry())
        # Allocation ledger (plugin/attribution.py AllocationLedger):
        # every granted device ID lands here so the attribution poller
        # can diff kubelet truth against what we actually handed out.
        # Optional like the forensics hooks — bare test constructions
        # stay ledger-free.
        self.ledger = ledger
        # Forensics (cli.py wires shared instances; all optional here so
        # bare test constructions stay zero-cost): a flight-recorder
        # black box of daemon lifecycle events, an anomaly monitor over
        # Allocate latency, and a daemon span ring fed by timed_rpc.
        self.flight = flight
        self.anomaly = anomaly
        self.spans = spans
        if anomaly is not None:
            anomaly.configure(
                "plugin.allocate_seconds", warmup=20, z_threshold=6.0,
                sustain=2,
            )
        # Route the kubelet-facing RPC surface through timed_rpc (one
        # tracing story, two entry points): every Allocate /
        # GetPreferredAllocation lands in the daemon span ring with the
        # DAEMON_TRACE id.  Instance-level wrap because the recorder is
        # per-instance; the metrics histograms inside Allocate are
        # untouched (observe= stays for callers without a histogram).
        if spans is not None:
            self.Allocate = tracing.timed_rpc(
                self.Allocate, spans=lambda: self.spans, threshold_ms=50.0
            )
            self.GetPreferredAllocation = tracing.timed_rpc(
                self.GetPreferredAllocation, spans=lambda: self.spans
            )
        self._cond = threading.Condition()
        self._version = 0
        self._epoch = 0  # bumped by interrupt_streams(); streams die on change
        self._inventory: GpuHostInventory | None = None
        self._health: dict[str, bool] = {}  # k8s_id -> healthy
        self.poll_once()

    def interrupt_streams(self) -> None:
        """End every open ListAndWatch stream promptly (server shutdown /
        restart); streams opened afterwards are unaffected."""
        with self._cond:
            self._epoch += 1
            self._cond.notify_all()

    # ------------------------------------------------------------------ state

    def poll_once(self) -> bool:
        """Re-discover chips and re-check health; returns True if anything
        changed (and wakes every ListAndWatch stream)."""
        inventory = self._discover()
        health = self._health_checker.check_many(inventory.cards)
        with self._cond:
            changed = (
                self._inventory is None
                or health != self._health
                or [c.k8s_id for c in inventory.cards]
                != [c.k8s_id for c in self._inventory.cards]
            )
            for k8s_id, healthy in health.items():
                was = self._health.get(k8s_id)
                if was is not None and was != healthy:
                    self.metrics.health_transitions.inc(
                        direction="to_unhealthy" if was else "to_healthy"
                    )
                    if self.flight is not None:
                        self.flight.record(
                            "health.transition",
                            device=k8s_id,
                            to="Unhealthy" if was else "Healthy",
                        )
            # Per-device health series track the streamed device list
            # exactly: an unplugged chip's series is removed, not frozen
            # at its last value (a flat 1 for a missing chip would read
            # as healthy on a dashboard).  Inventory membership changes
            # are also flight events BY DEVICE — /dev/nvidia* is
            # authoritative for existence (discovery.py), so a yanked
            # chip leaves the inventory without ever probing Unhealthy,
            # and health.transition alone would never name it.
            for k8s_id in self._health.keys() - health.keys():
                self.metrics.device_health.remove(device=k8s_id)
                if self.flight is not None:
                    self.flight.record("device.unplug", device=k8s_id)
            if self._inventory is not None and self.flight is not None:
                for k8s_id in health.keys() - self._health.keys():
                    self.flight.record("device.plug", device=k8s_id)
            for k8s_id, healthy in health.items():
                self.metrics.device_health.set(
                    1.0 if healthy else 0.0, device=k8s_id
                )
            self._inventory = inventory
            self._health = health
            if changed:
                self._version += 1
                self._cond.notify_all()
            version = self._version
        self.metrics.chips.set(sum(health.values()), state="healthy")
        self.metrics.chips.set(len(health) - sum(health.values()), state="unhealthy")
        if changed:
            self.metrics.device_updates.inc()
            if self.flight is not None:
                self.flight.record(
                    "listandwatch.update",
                    version=version,
                    chips=len(health),
                    healthy=sum(health.values()),
                )
            log.info(
                "device state v%d: %s",
                version,
                {k: ("Healthy" if v else "Unhealthy") for k, v in health.items()},
            )
        return changed

    def _snapshot(self) -> tuple[int, GpuHostInventory, dict[str, bool]]:
        with self._cond:
            assert self._inventory is not None
            return self._version, self._inventory, dict(self._health)

    @property
    def inventory(self) -> GpuHostInventory:
        """Latest discovered inventory (for CLI/observability consumers)."""
        return self._snapshot()[1]

    def debug_state(self) -> dict:
        """JSON-safe daemon snapshot for the MetricsServer's
        ``/debug/devices`` endpoint: the device list as the kubelet sees
        it — ids, device paths, NUMA placement, topology coordinates,
        health — plus the state version, so an operator can confirm what
        a node is ADVERTISING without gRPC-poking the kubelet socket
        (the daemon-side analogue of the engine's /debug/state)."""
        version, inventory, health = self._snapshot()
        return {
            "resource": RESOURCE,
            "state_version": version,
            "chip_count": inventory.card_count,
            "source": inventory.source,
            "chips": [
                {
                    "id": chip.k8s_id,
                    "index": chip.index,
                    "device_path": chip.device_path,
                    "uuid": chip.uuid,
                    "pci_address": chip.pci_address,
                    "numa_node": chip.numa_node,
                    "healthy": bool(health.get(chip.k8s_id)),
                }
                for chip in inventory.cards
            ],
        }

    def device_info(self) -> dict[str, dict]:
        """Per-chip discovery/topology/health join keyed by k8s device ID —
        what the attribution poller merges under each pod's devices in
        ``GET /debug/pods`` (card index, UUID, PCI address, NUMA, health)."""
        _, inventory, health = self._snapshot()
        return {
            chip.k8s_id: {
                "index": chip.index,
                "device_path": chip.device_path,
                "numa_node": chip.numa_node,
                "uuid": chip.uuid,
                "pci_address": chip.pci_address,
                "healthy": bool(health.get(chip.k8s_id)),
            }
            for chip in inventory.cards
        }

    def _device_list(self, inventory: GpuHostInventory, health: dict[str, bool]):
        devices = []
        for chip in inventory.cards:
            dev = pb.Device(
                ID=chip.k8s_id,
                health=constants.HEALTHY if health.get(chip.k8s_id) else constants.UNHEALTHY,
            )
            if chip.numa_node is not None and chip.numa_node >= 0:
                dev.topology.nodes.add(ID=chip.numa_node)
            devices.append(dev)
        return devices

    # ------------------------------------------------------------- RPC: admin

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True,
        )

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()

    # ------------------------------------------------------------ RPC: stream

    def ListAndWatch(self, request, context):
        try:
            # Chaos seam (docs/chaos.md): error refuses the stream (the
            # kubelet's run loop re-dials), delay stalls its opening.
            failpoints.fire("plugin.listandwatch", op="open")
        except failpoints.FailpointError as e:
            if self.flight is not None:
                self.flight.record(
                    "listandwatch.stream", op="failpoint", error=str(e)
                )
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        with self._cond:
            epoch = self._epoch
        version, inventory, health = self._snapshot()
        log.info("ListAndWatch stream opened (v%d, %d chips)", version, inventory.card_count)
        self.metrics.streams.inc()
        if self.flight is not None:
            self.flight.record(
                "listandwatch.stream", op="open", version=version
            )
        try:
            yield pb.ListAndWatchResponse(devices=self._device_list(inventory, health))
            while True:
                with self._cond:
                    # Wake on state change or interrupt; time out periodically to
                    # notice a disconnected kubelet and end the stream cleanly.
                    while self._version == version and self._epoch == epoch:
                        if not self._cond.wait(timeout=5.0):
                            if not context.is_active():
                                log.info("ListAndWatch stream closed by peer")
                                return
                    if self._epoch != epoch:
                        log.info("ListAndWatch stream interrupted (server stopping)")
                        return
                    version = self._version
                    inventory, health = self._inventory, dict(self._health)
                if not context.is_active():
                    return
                try:
                    # Per-update chaos seam: error kills the live stream
                    # mid-flight (the kubelet must notice and re-dial);
                    # delay stalls the device update — detection-latency
                    # injection for the scenario suite.
                    failpoints.fire(
                        "plugin.listandwatch", op="update", version=version
                    )
                except failpoints.FailpointError as e:
                    log.warning("ListAndWatch stream killed by failpoint: %s", e)
                    if self.flight is not None:
                        self.flight.record(
                            "listandwatch.stream", op="failpoint", error=str(e)
                        )
                    return
                yield pb.ListAndWatchResponse(devices=self._device_list(inventory, health))
        finally:
            self.metrics.streams.dec()
            if self.flight is not None:
                self.flight.record("listandwatch.stream", op="close")

    # --------------------------------------------------- RPC: preferred alloc

    def GetPreferredAllocation(self, request, context):
        _, inventory, _ = self._snapshot()
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            preferred = self._prefer(
                inventory,
                available=list(creq.available_deviceIDs),
                must_include=list(creq.must_include_deviceIDs),
                size=creq.allocation_size,
            )
            resp.container_responses.add(deviceIDs=preferred)
        return resp

    def _record_preference(self, contiguous: bool) -> None:
        self.metrics.preferred_allocations.inc(
            result="contiguous" if contiguous else "fragmented"
        )

    def _prefer(
        self,
        inventory: GpuHostInventory,
        available: list[str],
        must_include: list[str],
        size: int,
    ) -> list[str]:
        try:
            avail_idx = {inventory.card_by_k8s_id(d).index for d in available}
            must_idx = {inventory.card_by_k8s_id(d).index for d in must_include}
        except KeyError as e:
            log.warning("GetPreferredAllocation names unknown device %s", e)
            self.metrics.preferred_allocations.inc(result="unknown_device")
            return sorted(available, key=_chip_index_key)[:size]
        by_index = {c.index: c for c in inventory.cards}
        numa_of = {c.index: c.numa_node for c in inventory.cards}
        chosen = select_numa_local(size, avail_idx, numa_of, must_include=must_idx)
        if chosen is None:
            # Too few cards, or more musts than the size: musts first, then
            # the lowest available indices (what the kubelet trims).
            chosen = (sorted(must_idx) + sorted(avail_idx - must_idx))[:size]
        self._record_preference(contiguous=len(numa_nodes_of(chosen, numa_of)) <= 1)
        return [by_index[i].k8s_id for i in chosen]

    # ---------------------------------------------------------- RPC: allocate

    def Allocate(self, request, context):
        t0 = time.monotonic()
        with self.metrics.allocation_latency.time(), \
                self.metrics.allocate_seconds.time():
            try:
                # Chaos seam (docs/chaos.md): error aborts the RPC
                # UNAVAILABLE (the kubelet fails the pod's admission and
                # retries); delay/hang stall INSIDE the latency
                # histograms, so the injected slowness feeds the same
                # Allocate-latency anomaly baseline real slowness would.
                failpoints.fire(
                    "plugin.allocate",
                    containers=len(request.container_requests),
                )
            except failpoints.FailpointError as e:
                self.metrics.allocations.inc(outcome="failpoint")
                if self.flight is not None:
                    self.flight.record(
                        "allocate", outcome="failpoint", error=str(e)
                    )
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            _, inventory, health = self._snapshot()
            resp = pb.AllocateResponse()
            granted_chips = 0
            granted_ids: list[str] = []
            for creq in request.container_requests:
                ids = list(creq.devicesIDs)
                try:
                    chips = [inventory.card_by_k8s_id(d) for d in ids]
                except KeyError as e:
                    self.metrics.allocations.inc(outcome="unknown_device")
                    if self.flight is not None:
                        self.flight.record(
                            "allocate", ids=ids, outcome="unknown_device"
                        )
                    context.abort(
                        grpc.StatusCode.NOT_FOUND, f"unknown device id {e.args[0]!r}"
                    )
                unhealthy = [c.k8s_id for c in chips if not health.get(c.k8s_id)]
                if unhealthy:
                    self.metrics.allocations.inc(outcome="unhealthy_device")
                    if self.flight is not None:
                        self.flight.record(
                            "allocate",
                            ids=ids,
                            outcome="unhealthy_device",
                            unhealthy=unhealthy,
                        )
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION,
                        f"device(s) {unhealthy} are Unhealthy",
                    )
                resp.container_responses.append(self._allocate_one(inventory, chips))
                granted_chips += len(chips)
                granted_ids.extend(ids)
                log.info("allocated %s", ids)
            # Success counters only once the WHOLE response is built: a later
            # container's abort discards the entire AllocateResponse, and the
            # metrics must not claim chips were handed out.  Same rule for
            # the reconciliation ledger: an aborted Allocate granted nothing.
            self.metrics.allocations.inc(
                len(request.container_requests), outcome="ok"
            )
            self.metrics.allocated_chips.inc(granted_chips)
            if self.ledger is not None:
                self.ledger.grant(granted_ids)
        dt = time.monotonic() - t0
        if self.flight is not None:
            self.flight.record(
                "allocate",
                outcome="ok",
                containers=len(request.container_requests),
                chips=granted_chips,
                ms=round(dt * 1e3, 3),
            )
        if self.anomaly is not None:
            # Sustained Allocate-latency blowups (wedged devfs, lock
            # contention) become incident records with the lead-up
            # events attached — the pod-startup-path SLO guard.
            self.anomaly.observe("plugin.allocate_seconds", dt)
        return resp

    def _allocate_one(
        self, inventory: GpuHostInventory, chips: list[GpuCard]
    ) -> pb.ContainerAllocateResponse:
        grant = container_grant(inventory, chips, root=self._root)
        car = pb.ContainerAllocateResponse()
        for container_path, host_path, permissions in grant["devices"]:
            car.devices.add(container_path=container_path, host_path=host_path,
                            permissions=permissions)
        for key, value in grant["envs"].items():
            car.envs[key] = value
        for key, value in grant["annotations"].items():
            car.annotations[key] = value
        return car


def container_grant(inventory: GpuHostInventory, cards: list[GpuCard],
                    root: str = "/") -> dict:
    """One container's grant as plain data (no gRPC): ``devices``, a list
    of (container path, host path, permissions), exactly the requested
    cards' nodes in index order and then the shared control nodes the
    host has (looked up under ``root``); ``envs`` (``envs.py``) and
    ``annotations``."""
    cards = sorted(cards, key=lambda c: c.index)
    devices = [(c.device_path, c.device_path, "rw") for c in cards]
    for node in SHARED_DEVICE_NODES:
        if os.path.exists(os.path.join(root, node.lstrip("/"))):
            devices.append((node, node, "rw"))
    return {
        "devices": devices,
        "envs": allocation_envs(inventory, cards),
        "annotations": allocation_annotations(cards),
    }
