"""Multi-resource lifecycle: host N device-plugin resources in one process.

The GPU device plugin's own copy of the JAX package's
``plugin/resources.py`` (the port imports nothing of that package), in the
``nvidia.com`` namespace.

The reference's DPM is a *generic* manager: `ListerInterface.Discover`
streams lists of resource last-names over a channel, and the manager diffs
each list against the running set, starting a plugin server for every new
name and stopping the server of every vanished one (reference
dpm/lister.go:11-26 — GetResourceNamespace/Discover/NewPlugin;
dpm/manager.go:96-136 — handleNewPlugins start/stop set-diff).  Round 1
hardcoded a single `nvidia.com/gpu` plugin; this module supplies the general
contract so the lifecycle layer can host e.g. `nvidia.com/gpu` plus a future
`nvidia.com/gpu-shared` with dynamic add/remove.

Differences from the reference, on purpose:

- ONE kubelet-socket watch for the whole process, fanned into every
  per-resource manager (the reference also holds one fsnotify watch;
  per-resource watches would multiply inotify descriptors for nothing).
- Discovery pushes via a callback instead of a channel — the Python-native
  shape of the same contract; the publisher thread is owned by the manager
  exactly like dpm runs Discover in a goroutine (dpm/manager.go:63).
- Start/stop on diff reuses PluginManager (idempotent start, registration
  rollback, retry w/ backoff) rather than reimplementing it, so single- and
  multi-resource deployments share one battle path.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Iterable, Protocol

from ..kubelet import constants
from .manager import PluginManager
from .server import GpuDevicePlugin

log = logging.getLogger(__name__)

PublishFn = Callable[[Iterable[str]], None]


class ResourceLister(Protocol):
    """≙ dpm ListerInterface (reference dpm/lister.go:11-26).

    `namespace` is the resource-name prefix ("nvidia.com" ⇒ resources
    "nvidia.com/<name>").  `discover` runs on a manager-owned thread and
    calls `publish` with the full current name list whenever it changes
    (publishing the same list twice is harmless); it must return promptly
    once `stop` is set.  `new_plugin` builds the servicer for one name.
    """

    namespace: str

    def discover(self, publish: PublishFn, stop: threading.Event) -> None: ...

    def new_plugin(self, name: str) -> GpuDevicePlugin: ...


class StaticLister:
    """Simplest lister: one fixed name list, published once (≙ the reference
    main.go probe goroutine pushing ["gpu"] a single time, main.go:211-217)."""

    def __init__(
        self,
        names: Iterable[str],
        new_plugin: Callable[[str], GpuDevicePlugin],
        namespace: str = "nvidia.com",
    ):
        self.namespace = namespace
        self._names = list(names)
        self._new_plugin = new_plugin

    def discover(self, publish: PublishFn, stop: threading.Event) -> None:
        publish(self._names)

    def new_plugin(self, name: str) -> GpuDevicePlugin:
        return self._new_plugin(name)


class MultiResourceManager:
    """Owns the discover thread, the shared kubelet watch, and one
    PluginManager per live resource name (≙ dpm Manager, dpm/manager.go)."""

    def __init__(
        self,
        lister: ResourceLister,
        plugin_dir: str = constants.DEVICE_PLUGIN_PATH,
        pulse: float = 0.0,
        register_retries: int = 3,
        register_retry_delay: float = 3.0,
        watch_poll_interval: float = 1.0,
    ):
        self.lister = lister
        self.plugin_dir = plugin_dir
        self.pulse = pulse
        self._register_retries = register_retries
        self._register_retry_delay = register_retry_delay
        self._watch_poll_interval = watch_poll_interval

        self._lock = threading.Lock()  # guards _managers/_starting/_wanted
        self._managers: dict[str, PluginManager] = {}
        self._starting: set[str] = set()  # reserved while a start is in flight
        self._wanted: set[str] = set()  # the most recently published list
        self._stop = threading.Event()
        self._watcher = None
        self._discover_thread: threading.Thread | None = None
        self._retry_thread: threading.Thread | None = None
        self._discover_failed = False

    # ----------------------------------------------------------------- naming

    def resource_name(self, name: str) -> str:
        return f"{self.lister.namespace}/{name}"

    def endpoint(self, name: str) -> str:
        # ≙ dpm/plugin.go:51-58 socket naming: <namespace>_<name>.
        return f"{self.lister.namespace}_{name}.sock"

    # ------------------------------------------------------------- lifecycle

    def run(self) -> None:
        self.start()
        try:
            self._stop.wait()
        finally:
            self.stop_all()

    def start(self) -> None:
        from .watcher import KubeletSocketWatcher

        self._watcher = KubeletSocketWatcher(
            self.plugin_dir,
            constants.KUBELET_SOCKET_NAME,
            on_create=self._on_kubelet_create,
            on_remove=self._on_kubelet_remove,
            poll_interval=self._watch_poll_interval,
        )
        self._watcher.start()
        if not self._watcher.ready.wait(timeout=10):
            log.warning("socket watcher failed to arm within 10s")
        self._discover_thread = threading.Thread(
            target=self._discover_loop, name="resource-discover", daemon=True
        )
        self._discover_thread.start()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, name="resource-retry", daemon=True
        )
        self._retry_thread.start()

    def shutdown(self) -> None:
        self._stop.set()

    def alive(self) -> bool:
        """Same liveness contract as PluginManager: a dead recovery path IS
        death.  A discover thread that *returned* is fine (StaticLister
        publishes once and exits); one that *raised* means add/remove
        reconciliation is gone for good, so /healthz must go red."""
        if self._stop.is_set() or self._discover_failed:
            return False
        if self._retry_thread is not None and not self._retry_thread.is_alive():
            return False  # failed starts would never be retried again
        return self._watcher is not None and self._watcher.is_alive()

    def stop_all(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher.join(timeout=5)
            self._watcher = None
        if self._discover_thread is not None:
            self._discover_thread.join(timeout=5)
            self._discover_thread = None
        if self._retry_thread is not None:
            self._retry_thread.join(timeout=5)
            self._retry_thread = None
        with self._lock:
            managers, self._managers = dict(self._managers), {}
        for name, mgr in managers.items():
            log.info("stopping plugin for %s", self.resource_name(name))
            mgr.stop_all()

    # ------------------------------------------------------------- discovery

    def _discover_loop(self) -> None:
        try:
            self.lister.discover(self.publish, self._stop)
        except Exception:
            self._discover_failed = True
            log.exception("resource discover loop died")

    def _retry_loop(self) -> None:
        """Timer-driven recovery for wanted-but-not-running resources (their
        start failed — e.g. the kubelet rejected registration during a skewed
        upgrade).  The kubelet-create event retries too, but a kubelet that
        stays up emits no further events; like PluginManager's reconciler,
        recovery must not depend on one arriving."""
        period = max(self._register_retry_delay, 0.2) * 3
        while not self._stop.wait(period):
            # The kubelet-down case belongs to _on_kubelet_create (starting
            # servers against an absent socket just burns full registration
            # backoff cycles); the timer covers kubelet-up-but-rejecting.
            if not os.path.exists(os.path.join(self.plugin_dir, constants.KUBELET_SOCKET_NAME)):
                continue
            self._retry_missing("retry timer")

    def publish(self, names: Iterable[str]) -> None:
        """Reconcile the running plugin set against `names` (the full list,
        not a delta) — ≙ dpm handleNewPlugins (dpm/manager.go:96-136).

        Concurrency-safe against duplicate/overlapping publishes: a name is
        *reserved* in `_starting` under the lock before its (slow, lock-free)
        server start, so a second publisher can neither start a twin — whose
        `_start_server` would steal the live socket path — nor observe a
        half-started resource.  A start that completes after the name was
        un-wanted (or after shutdown) is rolled back, not committed.
        """
        wanted = set(names)
        with self._lock:
            self._wanted = set(wanted)
            if self._stop.is_set():
                return
            to_stop: dict[str, PluginManager] = {}
            to_start: list[str] = []
            for name in list(self._managers):
                if name not in wanted:
                    to_stop[name] = self._managers.pop(name)
            for name in sorted(wanted):
                if name not in self._managers and name not in self._starting:
                    self._starting.add(name)
                    to_start.append(name)
        for name, mgr in to_stop.items():
            log.info("resource %s vanished; stopping its plugin", self.resource_name(name))
            mgr.stop_all()
        self._start_names(to_start)

    def _retry_missing(self, why: str) -> None:
        """Start-only reconcile: begin every wanted-but-not-running resource.
        Retry paths must NEVER derive a stop-set from a snapshot of _wanted —
        a concurrent discover publish may have grown it, and stopping from
        the stale view would silently unregister the new resource until the
        next unrelated list change (listers only publish on change)."""
        with self._lock:
            if self._stop.is_set():
                return
            missing = sorted(self._wanted - set(self._managers) - self._starting)
            for name in missing:
                self._starting.add(name)
        if missing:
            log.info(
                "%s; retrying %s",
                why,
                [self.resource_name(n) for n in missing],
            )
            self._start_names(missing)

    def _start_names(self, to_start: list[str]) -> None:
        for name in to_start:
            try:
                mgr = PluginManager(
                    plugin=self.lister.new_plugin(name),
                    plugin_dir=self.plugin_dir,
                    endpoint=self.endpoint(name),
                    resource=self.resource_name(name),
                    pulse=self.pulse,
                    register_retries=self._register_retries,
                    register_retry_delay=self._register_retry_delay,
                    watch_kubelet=False,  # we fan the shared watch into it
                )
                mgr.start()
            except Exception:
                with self._lock:
                    self._starting.discard(name)
                # Not dropped forever: the name stays in _wanted; the
                # kubelet-create event and the retry timer both re-attempt
                # it (see _retry_missing).
                log.exception(
                    "failed to start plugin for %s (will retry)",
                    self.resource_name(name),
                )
                continue
            with self._lock:
                self._starting.discard(name)
                if self._stop.is_set() or name not in self._wanted:
                    undo = True  # raced with shutdown or a removing publish
                else:
                    self._managers[name] = mgr
                    undo = False
            if undo:
                mgr.stop_all()
        log.info(
            "resource set now: %s",
            sorted(self.resource_name(n) for n in self.resources()),
        )

    def resources(self) -> list[str]:
        with self._lock:
            return sorted(self._managers)

    def manager(self, name: str) -> PluginManager | None:
        with self._lock:
            return self._managers.get(name)

    # ------------------------------------------------------------- recovery

    def _snapshot(self) -> list[PluginManager]:
        with self._lock:
            return list(self._managers.values())

    def _on_kubelet_create(self) -> None:
        if self._stop.is_set():
            return
        for mgr in self._snapshot():
            mgr.handle_kubelet_create()
        # Wanted resources with no running manager (their start failed while
        # the kubelet was down) get another chance now that it's back —
        # without this they'd wait for the retry timer's next tick.
        self._retry_missing("kubelet is back")

    def _on_kubelet_remove(self) -> None:
        for mgr in self._snapshot():
            mgr.handle_kubelet_remove()
