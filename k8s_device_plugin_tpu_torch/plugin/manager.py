"""Plugin lifecycle: serve, register, survive kubelet restarts.

The GPU device plugin's own copy of the JAX package's ``plugin/manager.py``
(the port imports nothing of that package), serving ``nvidia.com/gpu``.

A threaded re-expression of the reference's DPM framework (reference
dpm/manager.go + dpm/plugin.go), with its sharp edges filed off:

- server start is idempotent and mutex-guarded (≙ dpm/plugin.go:62-90) and
  retried 3×/3s (≙ dpm/manager.go:17-20,204-218),
- registration failure rolls the server back per the protocol's
  "terminate upon registration failure" contract (≙ dpm/plugin.go:83-87),
- kubelet.sock events are LEVEL-triggered, not edge-replayed: watcher
  events (≙ dpm/manager.go:73-84, via watcher.KubeletSocketWatcher) only
  kick a reconciler thread that compares the CURRENT socket identity
  (inode+ctime) against the identity we last registered with — socket
  present with a new identity ⇒ full restart + re-register, absent ⇒
  stop.  A kubelet flapping N times while we were busy costs ONE
  reconcile against its final state, not N replayed restart dances
  (the reference replays each fsnotify event),
- a heartbeat thread drives per-chip health/discovery polls (≙ the reference's
  ticker goroutine at main.go:201-209, minus its duplicate-append bug),
- no 10-second startup stall: the reference's readiness loop waited for a
  service count that could never be reached (dpm/plugin.go:114-120); grpc's
  server.start() needs no such poll.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures

import grpc

from ..kubelet import constants
from ..kubelet.api import RegistrationStub, add_device_plugin_servicer, pb
from .server import RESOURCE, GpuDevicePlugin

log = logging.getLogger(__name__)

DEFAULT_ENDPOINT = "nvidia.com_gpu.sock"


class PluginManager:
    """Owns the gRPC server, kubelet registration, and recovery threads for
    one resource (nvidia.com/gpu)."""

    def __init__(
        self,
        plugin: GpuDevicePlugin,
        plugin_dir: str = constants.DEVICE_PLUGIN_PATH,
        endpoint: str = DEFAULT_ENDPOINT,
        resource: str = RESOURCE,
        pulse: float = 0.0,
        register_retries: int = 3,
        register_retry_delay: float = 3.0,
        watch_poll_interval: float = 1.0,
        watch_kubelet: bool = True,
    ):
        self.plugin = plugin
        self.plugin_dir = plugin_dir
        self.endpoint = endpoint
        self.resource = resource
        self.pulse = pulse
        self._register_retries = register_retries
        self._register_retry_delay = register_retry_delay
        self._watch_poll_interval = watch_poll_interval
        # False when a MultiResourceManager owns the (single, shared) kubelet
        # socket watch and fans events into us via handle_kubelet_* — one
        # inotify watch per process, not per resource (≙ the reference dpm
        # Manager owning fsnotify for all plugins, dpm/manager.go:53-84).
        self._watch_kubelet = watch_kubelet

        self._lock = threading.Lock()  # guards _server lifecycle
        self._server: grpc.Server | None = None
        self._stop = threading.Event()
        self._watcher = None
        self._heartbeat: threading.Thread | None = None
        self.registrations = 0  # observability: how many times we registered
        # Level-triggered recovery: watcher/fan-in events only set this
        # kick; the reconciler thread compares current socket identity to
        # _registered_key and acts on the DELTA (coalescing any number of
        # flaps into one reconcile).
        self._reconcile_kick = threading.Event()
        self._reconciler: threading.Thread | None = None
        self._registered_key: tuple | None = None
        self._counted_key: tuple | None = None  # last incarnation metered

    # ----------------------------------------------------------------- paths

    @property
    def socket_path(self) -> str:
        return os.path.join(self.plugin_dir, self.endpoint)

    @property
    def kubelet_socket(self) -> str:
        return os.path.join(self.plugin_dir, constants.KUBELET_SOCKET_NAME)

    # ------------------------------------------------------------- lifecycle

    def run(self) -> None:
        """Start everything and block until :meth:`shutdown` (or a signal
        handler calling it) fires.  ≙ dpm Manager.Run (dpm/manager.go:41-94)."""
        self.start()
        try:
            self._stop.wait()
        finally:
            self.stop_all()

    def start(self) -> None:
        # Capture the kubelet's identity BEFORE registering: if it restarts
        # mid-registration, the stale key makes the next reconcile register
        # again (conservative — at least one registration per incarnation).
        key = self._kubelet_key()
        self._start_and_register()
        self._registered_key = key
        self._reconciler = threading.Thread(
            target=self._reconcile_loop, name="gpu-plugin-reconcile", daemon=True
        )
        self._reconciler.start()
        if self._watch_kubelet:
            self._watcher = self._make_watcher()
            self._watcher.start()
            # Don't return until the watch is armed, or a kubelet restarting
            # immediately after our startup would go unnoticed.
            if not self._watcher.ready.wait(timeout=10):
                log.warning("socket watcher failed to arm within 10s")
        if self.pulse > 0:
            self._heartbeat = threading.Thread(
                target=self._heartbeat_loop, name="gpu-plugin-heartbeat", daemon=True
            )
            self._heartbeat.start()

    def shutdown(self) -> None:
        """Request an orderly exit of :meth:`run` (signal-handler safe)."""
        self._stop.set()

    def alive(self) -> bool:
        """Liveness (drives /healthz): not shut down and the recovery watcher
        thread is still running.  A stopped gRPC server while the kubelet is
        down is a NORMAL state (we restart on its return), not death — but a
        dead watcher means restarts would go unnoticed, which IS death."""
        if self._stop.is_set():
            return False
        if self._reconciler is not None and not self._reconciler.is_alive():
            # A dead reconciler means kubelet restarts would go unhandled.
            return False
        if not self._watch_kubelet:
            # An owning MultiResourceManager holds the watch; we're alive as
            # long as we haven't been stopped.
            return True
        return self._watcher is not None and self._watcher.is_alive()

    def stop_all(self) -> None:
        # Order matters: mark stopping FIRST so a concurrent watcher callback
        # (kubelet restarting at the same moment as our SIGTERM) cannot
        # resurrect the server after we tear it down.
        self._stop.set()
        self._reconcile_kick.set()  # unblock the reconciler so it can exit
        self.plugin.interrupt_streams()
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher.join(timeout=5)
            self._watcher = None
        if self._reconciler is not None:
            self._reconciler.join(timeout=5)
            self._reconciler = None
        if self._heartbeat is not None:
            self._heartbeat.join(timeout=5)
            self._heartbeat = None
        self._stop_server()

    # --------------------------------------------------------------- serving

    def _start_server(self) -> None:
        """Idempotently bring the DevicePlugin server up on our unix socket."""
        with self._lock:
            if self._server is not None:
                return
            if self._stop.is_set():
                raise RuntimeError("manager is shutting down")
            # Remove a stale socket from a previous incarnation
            # (≙ dpm/plugin.go:96-99).
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass
            server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
            add_device_plugin_servicer(self.plugin, server)
            server.add_insecure_port(f"unix://{self.socket_path}")
            server.start()
            self._server = server
            log.info("DevicePlugin server listening on %s", self.socket_path)

    def _stop_server(self) -> None:
        self.plugin.interrupt_streams()
        with self._lock:
            if self._server is None:
                return
            self._server.stop(grace=1).wait()
            self._server = None
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass
            log.info("DevicePlugin server stopped")

    def _register(self) -> None:
        """Announce ourselves on the kubelet's Registration socket.

        A kubelet that rejects our API version is the first failure mode
        operators hit on version skew (the protocol says plugins must detect
        and handle it — reference api.proto:20-22 "terminate upon
        registration failure"; the reference dpm only logs the raw error,
        dpm/plugin.go:148-153).  We surface a dedicated operator-facing
        message and keep retrying with backoff from _start_and_register —
        the kubelet may be mid-upgrade and come back compatible.
        """
        try:
            # Cap connect backoff: C-core pools subchannels process-wide, so
            # failed dials against a flapping kubelet.sock otherwise push the
            # cached subchannel into exponential backoff (up to minutes) that
            # a FRESH channel to the same target inherits — turning the first
            # re-registration after an outage into a multi-second stall.
            with grpc.insecure_channel(
                f"unix://{self.kubelet_socket}",
                options=[
                    ("grpc.initial_reconnect_backoff_ms", 100),
                    ("grpc.max_reconnect_backoff_ms", 2000),
                ],
            ) as channel:
                RegistrationStub(channel).Register(
                    pb.RegisterRequest(
                        version=constants.VERSION,
                        endpoint=self.endpoint,
                        resource_name=self.resource,
                        options=pb.DevicePluginOptions(
                            pre_start_required=False,
                            get_preferred_allocation_available=True,
                        ),
                    ),
                    timeout=10,
                )
        except grpc.RpcError as e:
            detail = (e.details() or "") if hasattr(e, "details") else ""
            if "version" in detail.lower() or e.code() == grpc.StatusCode.INVALID_ARGUMENT:
                log.error(
                    "kubelet REJECTED registration of %s: %r — likely device-"
                    "plugin API version skew (we speak %s); upgrade the plugin "
                    "or the kubelet. Retrying with backoff in case the kubelet "
                    "is mid-upgrade.",
                    self.resource,
                    detail,
                    constants.VERSION,
                )
            raise
        self.registrations += 1
        self.plugin.metrics.registrations.inc()
        if self.plugin.flight is not None:
            self.plugin.flight.record(
                "registration", resource=self.resource, endpoint=self.endpoint
            )
        log.info("registered %s with kubelet (endpoint %s)", self.resource, self.endpoint)

    def _start_and_register(self) -> None:
        """Server-up + register, with retry; registration failure tears the
        server back down before the next attempt."""
        last_error: Exception | None = None
        for attempt in range(1, self._register_retries + 1):
            if self._stop.is_set():
                raise RuntimeError("manager is shutting down")
            try:
                self._start_server()
                self._register()
                return
            except Exception as e:  # noqa: BLE001 — retry any startup failure
                last_error = e
                log.warning(
                    "start/register attempt %d/%d failed: %s",
                    attempt,
                    self._register_retries,
                    e,
                )
                self._stop_server()
                # Linear backoff: 1×, 2×, 3×… the base delay — a rejecting
                # kubelet (version skew) shouldn't be hammered at a fixed
                # cadence, but must still be re-tried promptly once upgraded.
                if attempt < self._register_retries and not self._stop.wait(
                    self._register_retry_delay * attempt
                ):
                    continue
                break
        raise RuntimeError(
            f"could not register {self.resource} with kubelet at "
            f"{self.kubelet_socket}"
        ) from last_error

    # ------------------------------------------------------------- recovery

    def _make_watcher(self):
        from .watcher import KubeletSocketWatcher

        return KubeletSocketWatcher(
            self.plugin_dir,
            constants.KUBELET_SOCKET_NAME,
            on_create=self._on_kubelet_create,
            on_remove=self._on_kubelet_remove,
            poll_interval=self._watch_poll_interval,
        )

    def _kubelet_key(self) -> tuple | None:
        """Identity of the CURRENT kubelet.sock (None when absent).  A fresh
        kubelet incarnation binds a fresh socket → new inode; ctime guards
        against inode reuse on busy tmpfs."""
        try:
            st = os.stat(self.kubelet_socket)
            return (st.st_ino, st.st_ctime_ns)
        except OSError:
            return None

    def _on_kubelet_create(self) -> None:
        if not self._stop.is_set():
            self._reconcile_kick.set()

    _on_kubelet_remove = _on_kubelet_create

    def _reconcile_loop(self) -> None:
        """Drain kicks into reconciles.  Every watcher event (or fan-in call)
        just sets the kick; this loop then compares observed socket identity
        to the registered one — so a storm of N flaps while a reconcile is in
        flight coalesces into ONE pass against the final state, instead of N
        replayed restart/register dances against states that no longer exist."""
        retry: float | None = None
        while not self._stop.is_set():
            kicked = self._reconcile_kick.wait(timeout=retry)
            if self._stop.is_set():
                return
            if kicked:
                self._reconcile_kick.clear()
            retry = None if self._reconcile_once() else self._register_retry_delay

    def _reconcile_once(self) -> bool:
        """One level-triggered pass; returns False when it should be retried
        (a registration attempt failed against a live socket)."""
        key = self._kubelet_key()
        if key is None:
            # kubelet is down: stop serving until it returns (the create
            # event will kick us again).
            if self._registered_key is not None or self._server is not None:
                log.info("kubelet socket absent; stopping plugin server")
                if self.plugin.flight is not None:
                    self.plugin.flight.record("kubelet.absent")
                self._stop_server()
                self._registered_key = None
            return True
        if key == self._registered_key:
            return True  # already registered with this incarnation
        if key != self._counted_key:
            # Count kubelet INCARNATIONS, not reconcile attempts: a kubelet
            # that rejects registration re-enters here every retry tick and
            # must not inflate the restart metric.
            self._counted_key = key
            self.plugin.metrics.kubelet_restarts.inc()
            if self.plugin.flight is not None:
                self.plugin.flight.record("kubelet.restart")
        log.info("kubelet (re)start detected; re-registering")
        try:
            self._stop_server()
            self._start_and_register()
            self._registered_key = key
            return True
        except Exception:
            if self._stop.is_set():
                log.info("shutdown interrupted re-registration")
                return True
            log.exception(
                "re-registration after kubelet restart failed (will retry)"
            )
            return False

    # Public fan-in points for an owning MultiResourceManager (which holds
    # the single shared kubelet-socket watch; see resources.py).
    handle_kubelet_create = _on_kubelet_create
    handle_kubelet_remove = _on_kubelet_remove

    # ------------------------------------------------------------- heartbeat

    def _heartbeat_loop(self) -> None:
        log.info("health heartbeat every %.1fs", self.pulse)
        while not self._stop.wait(self.pulse):
            try:
                self.plugin.poll_once()
            except Exception:
                # Keep serving the last good snapshot, but meter the
                # failure: a steadily climbing counter with a quiet
                # device_updates series is how a wedged sysfs/devfs
                # surfaces on a dashboard before it pages.
                self.plugin.metrics.poll_failures.inc()
                log.exception("health poll failed")
