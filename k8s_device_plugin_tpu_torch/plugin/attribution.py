"""Per-pod GPU attribution: kubelet PodResources polling + allocation audit.

The GPU device plugin's own copy of the JAX package's
``plugin/attribution.py`` (the port imports nothing of that package), its
series renamed from ``tpu_*`` to ``gpu_*``.

After PR 1 (tracing/metrics) and PR 2 (flight/incidents) the daemon can
say a chip is healthy and the engine can say a request was slow, but
nothing on the node can say WHICH POD OWNS WHICH CHIP — the join every
fleet dashboard and noisy-neighbor diagnosis needs (the host-side,
workload-attributed telemetry of arXiv:2510.16946).  This module closes
that gap:

- :class:`PodAttributionPoller` dials the kubelet's PodResources
  introspection socket (``pod-resources/kubelet.sock``, the v1
  ``PodResourcesLister`` service — hand-bound in kubelet/api.py, no
  protoc), builds the chip -> (namespace, pod, container) ownership map,
  and joins it with discovery/topology (card index, PCI address, NUMA,
  health) for ``GET /debug/pods``.
- Ownership becomes bounded-cardinality labeled series (at most one per
  chip on the host): ``gpu_chip_owner_info{device,namespace,pod,
  container}`` info-gauges and ``gpu_pod_chips{namespace,pod}`` counts,
  with series REMOVED via ``Gauge.remove`` the poll after a pod goes
  away — the same no-stale-series discipline the per-device health gauge
  applies on unplug.
- **Allocation-reconciliation audit**: the gRPC server records every
  device ID it granted into an :class:`AllocationLedger`; each poll
  diffs kubelet truth against the ledger.  Drift — kubelet attributing a
  chip the plugin never granted (``kind="ungranted"``), or a grant the
  kubelet never surfaced within the confirmation grace
  (``kind="unfulfilled"``) — increments
  ``gpu_attribution_drift_total{kind}``, records an
  ``attribution.drift`` flight event, and raises a direct anomaly
  incident (visible at ``/debug/incidents``).  A confirmed grant the
  kubelet later drops is the NORMAL pod-exit path (the device-plugin API
  has no Deallocate; kubelet truth is how the plugin learns of release).

Degrades gracefully by design: with no socket configured the poller is
never built; with the socket absent/unresponsive every poll sets
``gpu_podresources_up 0``, keeps the last-known (then aged-out) state,
and redials — the daemon otherwise runs exactly as before.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter
from typing import Callable, Iterable, Mapping, Optional

import grpc

from ..kubelet.api import PodResourcesListerStub, prpb
from ..utils import failpoints
from ..utils.anomaly import AnomalyMonitor
from ..utils.flight import FlightRecorder
from ..utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

DRIFT_METRIC = "plugin.attribution_drift"

# Dead pod-resources sockets flap with the kubelet; cap C-core's connect
# backoff so the first poll after a kubelet restart doesn't inherit a
# multi-second stall from the dead incarnation (same rationale as
# manager._register's registration channel).
_CHAN_OPTS = [
    ("grpc.initial_reconnect_backoff_ms", 100),
    ("grpc.max_reconnect_backoff_ms", 2000),
]


class AllocationLedger:
    """Device IDs the DevicePlugin's Allocate handed out, awaiting kubelet
    confirmation.

    The device-plugin API has no Deallocate, so the plugin can never
    observe a release directly — entries move ``granted`` -> ``confirmed``
    (the kubelet's PodResources view attributed the chip to a pod) ->
    gone (the kubelet dropped it: the pod exited), with the attribution
    poller driving both observation-side transitions.  Thread-safe:
    Allocate grants from gRPC worker threads while the poller reconciles.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        # device_id -> {"ts": grant time, "confirmed": bool, "owner": tuple|None}
        self._grants: dict[str, dict] = {}  # guarded by: _lock
        self.granted_total = 0
        self.released_total = 0

    def grant(self, device_ids: Iterable[str]) -> None:
        """Record one Allocate's device IDs (re-granting a released chip
        restarts its entry — pod churn reuses device IDs)."""
        now = self._clock()
        with self._lock:
            for device_id in device_ids:
                self.granted_total += 1
                self._grants[str(device_id)] = {
                    "ts": now, "confirmed": False, "owner": None,
                }

    def confirm(self, device_id: str, owner=None) -> None:
        """The kubelet attributed this grant to a pod."""
        with self._lock:
            entry = self._grants.get(device_id)
            if entry is not None:
                entry["confirmed"] = True
                if owner is not None:
                    entry["owner"] = tuple(owner)

    def release(self, device_id: str) -> bool:
        """Drop one grant (kubelet no longer attributes it — pod exited)."""
        with self._lock:
            if self._grants.pop(device_id, None) is None:
                return False
            self.released_total += 1
            return True

    def entry(self, device_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._grants.get(device_id)
            return dict(entry) if entry is not None else None

    def granted(self) -> set[str]:
        with self._lock:
            return set(self._grants)

    def confirmed(self) -> set[str]:
        with self._lock:
            return {d for d, e in self._grants.items() if e["confirmed"]}

    def pending(self, older_than_s: float = 0.0) -> set[str]:
        """Unconfirmed grants at least ``older_than_s`` old — the audit's
        "granted but kubelet never surfaced it" candidates."""
        horizon = self._clock() - older_than_s
        with self._lock:
            return {
                d
                for d, e in self._grants.items()
                if not e["confirmed"] and e["ts"] <= horizon
            }

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            return {
                "granted_total": self.granted_total,
                "released_total": self.released_total,
                "outstanding": {
                    d: {
                        "age_s": round(now - e["ts"], 3),
                        "confirmed": e["confirmed"],
                        "owner": list(e["owner"]) if e["owner"] else None,
                    }
                    for d, e in sorted(self._grants.items())
                },
            }


class PodAttributionPoller:
    """Polls the kubelet PodResources API into ownership series, the
    ``/debug/pods`` join, and the allocation-reconciliation audit.

    ``metrics`` is a PluginMetrics (the attribution series live there so
    one registry serves /metrics); ``device_info`` is an optional no-arg
    callable returning ``{k8s_id: {...}}`` (GpuDevicePlugin.device_info)
    for the topology/health join.  Drive polls either via
    :meth:`start`/:meth:`stop` (daemon thread every ``interval_s``) or by
    calling :meth:`poll_once` directly (tests).
    """

    def __init__(
        self,
        socket_path: str,
        *,
        metrics=None,
        ledger: Optional[AllocationLedger] = None,
        resources: Iterable[str] = ("nvidia.com/gpu",),
        device_info: Optional[Callable[[], Mapping[str, dict]]] = None,
        flight: Optional[FlightRecorder] = None,
        anomaly: Optional[AnomalyMonitor] = None,
        interval_s: float = 10.0,
        rpc_timeout_s: float = 5.0,
        confirm_grace_s: float = 60.0,
        allocatable_every: int = 30,
        clock: Callable[[], float] = time.monotonic,
    ):
        if metrics is None:
            from .server import PluginMetrics  # lazy: avoids a module cycle

            metrics = PluginMetrics(MetricsRegistry())
        self.socket_path = str(socket_path)
        self.metrics = metrics
        self.ledger = ledger
        self.resources = frozenset(resources)
        self._device_info = device_info
        self.flight = flight
        self.anomaly = anomaly
        self.interval_s = float(interval_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.confirm_grace_s = float(confirm_grace_s)
        self.allocatable_every = max(1, int(allocatable_every))
        self._clock = clock

        self._lock = threading.Lock()
        self._owners: dict[str, tuple[str, str, str]] = {}
        self._pod_counts: dict[tuple[str, str], int] = {}
        self._allocatable: set[str] = set()
        self._drift_active: dict[tuple[str, str], dict] = {}
        self._drift_by_kind: Counter = Counter()
        self._up: Optional[bool] = None  # None = never polled
        self.polls = 0
        self.failures = 0
        self._last_poll_s: Optional[float] = None

        self._channel: Optional[grpc.Channel] = None
        self._stub: Optional[PodResourcesListerStub] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- transport

    def _dial(self) -> PodResourcesListerStub:
        if self._stub is None:
            self._channel = grpc.insecure_channel(
                f"unix://{self.socket_path}", options=_CHAN_OPTS
            )
            self._stub = PodResourcesListerStub(self._channel)
        return self._stub

    def _hangup(self) -> None:
        channel, self._channel, self._stub = self._channel, None, None
        if channel is not None:
            channel.close()

    # ----------------------------------------------------------------- polls

    def poll_once(self) -> bool:
        """One poll: List (+ periodic GetAllocatableResources), apply the
        ownership diff, run the reconciliation audit.  Returns True when
        the kubelet answered; never raises on an absent/unresponsive
        socket (``gpu_podresources_up`` goes 0 instead)."""
        t0 = time.perf_counter()
        refresh_allocatable = self.polls % self.allocatable_every == 0
        self.polls += 1
        try:
            # Chaos seam (docs/chaos.md): error fails the poll exactly
            # like an unreachable socket (down-mark, redial, degraded
            # attribution); delay stretches the poll histogram.
            failpoints.fire("attribution.poll", socket=self.socket_path)
            stub = self._dial()
            listed = stub.List(
                prpb.ListPodResourcesRequest(), timeout=self.rpc_timeout_s
            )
            allocatable = (
                stub.GetAllocatableResources(
                    prpb.AllocatableResourcesRequest(),
                    timeout=self.rpc_timeout_s,
                )
                if refresh_allocatable
                else None
            )
        except (grpc.RpcError, OSError, failpoints.FailpointError) as e:
            self._mark_down(e)
            self.metrics.attribution_poll_seconds.observe(
                time.perf_counter() - t0
            )
            return False
        self._mark_up()
        owned: dict[str, tuple[str, str, str]] = {}
        for pod in listed.pod_resources:
            for container in pod.containers:
                for dev in container.devices:
                    if dev.resource_name not in self.resources:
                        continue
                    for device_id in dev.device_ids:
                        owned[device_id] = (pod.namespace, pod.name, container.name)
        with self._lock:
            if allocatable is not None:
                self._allocatable = {
                    device_id
                    for dev in allocatable.devices
                    if dev.resource_name in self.resources
                    for device_id in dev.device_ids
                }
                self.metrics.attribution_allocatable.set(len(self._allocatable))
            self._apply(owned)
            self._audit(owned)
            dt = time.perf_counter() - t0
            self._last_poll_s = dt
        self.metrics.attribution_poll_seconds.observe(dt)
        return True

    def _mark_down(self, error) -> None:
        self.failures += 1
        self.metrics.podresources_up.set(0)
        if self._up is not False:
            self._up = False
            code = error.code() if isinstance(error, grpc.RpcError) else error
            log.warning(
                "kubelet PodResources socket %s unreachable (%s); "
                "attribution degraded until it returns",
                self.socket_path,
                code,
            )
            if self.flight is not None:
                self.flight.record(
                    "podresources.down", socket=self.socket_path, error=str(code)
                )
        # Redial from scratch next poll: the socket identity changes
        # across kubelet restarts, exactly like kubelet.sock.
        self._hangup()

    def _mark_up(self) -> None:
        self.metrics.podresources_up.set(1)
        if self._up is not True:
            self._up = True
            if self.flight is not None:
                self.flight.record("podresources.up", socket=self.socket_path)

    # ----------------------------------------------------- ownership series

    def _apply(self, owned: Mapping[str, tuple[str, str, str]]) -> None:
        """Diff kubelet ownership against the published series: set on
        bind, remove on release (stale-ownership series must die with
        their pod, mirroring the device-health unplug pattern)."""
        m = self.metrics
        prev = self._owners
        for device_id in prev.keys() - owned.keys():
            ns, pod, container = prev[device_id]
            m.chip_owner.remove(
                device=device_id, namespace=ns, pod=pod, container=container
            )
            if self.flight is not None:
                self.flight.record(
                    "pod.release",
                    device=device_id, namespace=ns, pod=pod, container=container,
                )
        for device_id, owner in owned.items():
            old = prev.get(device_id)
            if old == owner:
                continue
            if old is not None:
                m.chip_owner.remove(
                    device=device_id,
                    namespace=old[0], pod=old[1], container=old[2],
                )
                if self.flight is not None:
                    self.flight.record(
                        "pod.release",
                        device=device_id,
                        namespace=old[0], pod=old[1], container=old[2],
                    )
            m.chip_owner.set(
                1,
                device=device_id,
                namespace=owner[0], pod=owner[1], container=owner[2],
            )
            if self.flight is not None:
                self.flight.record(
                    "pod.bind",
                    device=device_id,
                    namespace=owner[0], pod=owner[1], container=owner[2],
                )
        counts = Counter((ns, pod) for ns, pod, _ in owned.values())
        for ns, pod in self._pod_counts.keys() - counts.keys():
            m.pod_chips.remove(namespace=ns, pod=pod)
        for (ns, pod), n in counts.items():
            m.pod_chips.set(n, namespace=ns, pod=pod)
        self._pod_counts = dict(counts)
        self._owners = dict(owned)
        m.attribution_attributed.set(len(owned))

    # ------------------------------------------------------------ audit

    def _audit(self, owned: Mapping[str, tuple[str, str, str]]) -> None:
        """Diff kubelet truth against the Allocate ledger; meter drift."""
        if self.ledger is None:
            return
        for device_id, owner in owned.items():
            if self.ledger.entry(device_id) is None:
                self._raise_drift(
                    "ungranted",
                    device_id,
                    namespace=owner[0], pod=owner[1], container=owner[2],
                )
            else:
                self.ledger.confirm(device_id, owner=owner)
                self._clear_drift("unfulfilled", device_id)
        # Confirmed grants the kubelet dropped: the NORMAL release path
        # (pod exited) — reconcile the ledger, no drift.
        for device_id in self.ledger.confirmed() - owned.keys():
            self.ledger.release(device_id)
            if self.flight is not None:
                self.flight.record("ledger.release", device=device_id)
        # Grants the kubelet never surfaced within the grace window: the
        # kubelet lost (or never applied) an allocation it asked for.
        for device_id in self.ledger.pending(older_than_s=self.confirm_grace_s):
            if device_id not in owned:
                self._raise_drift("unfulfilled", device_id)
        # An ungranted chip the kubelet stopped reporting is no longer
        # drifting; re-arm so a recurrence fires again.
        for kind, device_id in list(self._drift_active):
            if kind == "ungranted" and device_id not in owned:
                self._clear_drift(kind, device_id)

    def _raise_drift(self, kind: str, device_id: str, **info) -> None:
        """Meter + record + raise ONE incident per (kind, device)
        activation; the counter/incident re-fire only after the
        condition clears and recurs, not every poll."""
        key = (kind, device_id)
        if key in self._drift_active:
            return
        # Field name is "drift", not "kind": flight events and incident
        # records both reserve "kind" for their own record type.
        detail = {"drift": kind, "device": device_id, **info}
        self._drift_active[key] = {"since": round(time.time(), 3), **detail}
        self._drift_by_kind[kind] += 1
        self.metrics.attribution_drift.inc(kind=kind)
        log.warning("attribution drift: %s", detail)
        if self.flight is not None:
            self.flight.record("attribution.drift", **detail)
        if self.anomaly is not None:
            self.anomaly.report(DRIFT_METRIC, observed=1.0, **detail)

    def _clear_drift(self, kind: str, device_id: str) -> None:
        self._drift_active.pop((kind, device_id), None)

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON body of ``GET /debug/pods``: the ownership map joined with
        discovery/topology/health, plus poller/ledger/drift state."""
        info: Mapping[str, dict] = {}
        if self._device_info is not None:
            try:
                info = self._device_info() or {}
            except Exception as e:  # join must not kill the snapshot
                info = {}
                log.debug("device_info join failed: %s", e)
        with self._lock:
            owners = dict(self._owners)
            allocatable = sorted(self._allocatable)
            drift_active = [dict(d) for d in self._drift_active.values()]
            drift_total = dict(self._drift_by_kind)
            last_poll_ms = (
                round(self._last_poll_s * 1e3, 3)
                if self._last_poll_s is not None
                else None
            )
            up = self._up
        pods: dict[tuple[str, str], dict] = {}
        for device_id, (ns, pod, container) in sorted(owners.items()):
            entry = pods.setdefault(
                (ns, pod), {"namespace": ns, "pod": pod, "containers": {}}
            )
            entry["containers"].setdefault(container, []).append(
                {"id": device_id, **info.get(device_id, {})}
            )
        return {
            "socket": self.socket_path,
            "up": up,
            "polls": self.polls,
            "failures": self.failures,
            "interval_s": self.interval_s,
            "last_poll_ms": last_poll_ms,
            "resources": sorted(self.resources),
            "allocatable": allocatable,
            "attributed_chips": len(owners),
            "pods": [
                {
                    "namespace": p["namespace"],
                    "pod": p["pod"],
                    "containers": [
                        {"container": c, "devices": devs}
                        for c, devs in sorted(p["containers"].items())
                    ],
                }
                for p in pods.values()
            ],
            "ledger": self.ledger.snapshot() if self.ledger is not None else None,
            "drift": {"active": drift_active, "total_by_kind": drift_total},
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "PodAttributionPoller":
        assert self._thread is None
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gpu-plugin-attribution", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        log.info(
            "pod attribution: polling %s every %.1fs (resources %s)",
            self.socket_path,
            self.interval_s,
            ",".join(sorted(self.resources)),
        )
        while True:
            try:
                self.poll_once()
            except Exception:
                # poll_once handles transport errors itself; anything
                # else is a bug that must not kill the poller thread.
                self.failures += 1
                log.exception("attribution poll failed")
            if self._stop_evt.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._hangup()
