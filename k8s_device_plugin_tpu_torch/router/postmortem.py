"""Fleet postmortem collector: one incident, one fleet-wide bundle.

The port's own copy of the reference's ``router/postmortem.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The single-process capture hook (utils/postmortem.py) saves each
component's OWN forensic state — but a fleet incident's evidence is
scattered: the victim replica's flight ring, the router's placement and
failover events, the plugin daemon's device journal, the controller's
decision log.  This collector (armed by the router's ``--postmortem``
flag) watches for incidents two ways:

- **Summary-poll cursor**: every replica's ``?summary=1`` now carries
  its cumulative ``incidents_total``; the poll thread hands advances to
  :meth:`observe_poll`, which fires a capture for the replica's episode.
- **Local incidents**: the router's own AnomalyMonitors (SLO burn
  alerts, canary mismatches) get this collector as a full-record
  listener.

On any trigger it fans out to every replica's (plus, when configured,
the plugin daemon's and the controller's) ``/debug/flight``,
``/debug/spans``, ``/debug/state``, and ``/metrics``, and writes ONE
fleet bundle keyed by the incident id — the input
``tools/postmortem.py`` joins into a causally-ordered timeline and
classifies.  Served at ``GET /debug/postmortem``; a manual capture can
be forced via the admin-gated ``POST /debug/postmortem/capture``.

Bundle layout (``postmortem-fleet-<ts>-<digest12>/``)::

    manifest.json      schema, incident id/trigger, per-component
                       fetch accounting (ok/error per endpoint),
                       per-file digests, bundle digest
    router.json        the router's own flight/spans/state/metrics
    replica-<name>.json one per replica: the four endpoint bodies
    plugin.json        the plugin daemon's four endpoint bodies
    controller.json    the controller's four endpoint bodies

Capture runs on its own daemon thread (never the poll thread — a slow
replica must not stall the summary cadence) and shares the dump dir's
retention budget with the flight-dump writer
(utils/postmortem.sweep_dump_dir).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Optional

from ..utils.postmortem import (
    BUNDLE_PREFIX,
    INPROGRESS_SUFFIX,
    metric_families,
    sweep_dump_dir,
)

log = logging.getLogger("tpu.router.postmortem")

FLEET_SCHEMA = "tpu-postmortem-fleet/v1"
# The forensic surfaces pulled from every component.  A component that
# lacks one (the controller serves no /debug/state) gets an error row in
# the manifest, never a failed capture.
ENDPOINTS = ("/debug/flight", "/debug/spans", "/debug/state", "/metrics")

_CONN_ERRORS = (ConnectionError, OSError, TimeoutError)


def _safe_component(name: str) -> str:
    """A component name as a filename fragment (host:port → host_port)."""
    return "".join(c if (c.isalnum() or c in "._-") else "_" for c in name)


class FleetPostmortem:
    """The router-side fleet collector (``--postmortem``).

    ``targets_fn`` returns the replica ``host:port`` list at capture
    time (membership may have changed since the trigger — capture
    whoever is in the fleet NOW, the victim included while its summary
    still answers).  ``local_fn`` returns the router's own component
    payload (flight/spans/state/metrics) without a self-dial.
    """

    def __init__(
        self,
        directory: str,
        targets_fn,
        *,
        local_fn=None,
        plugin_url: Optional[str] = None,
        controller_url: Optional[str] = None,
        flight=None,
        registry=None,
        debounce_s: float = 120.0,
        timeout_s: float = 5.0,
        budget_bytes: Optional[int] = None,
        max_entries: Optional[int] = None,
        admin: bool = True,
        keep: int = 32,
        now=time.monotonic,
    ):
        self.directory = directory
        self.targets_fn = targets_fn
        self.local_fn = local_fn
        self.plugin_url = plugin_url
        self.controller_url = controller_url
        self.flight = flight
        self.debounce_s = float(debounce_s)
        self.timeout_s = float(timeout_s)
        self.budget_bytes = budget_bytes
        self.max_entries = max_entries
        self.admin = admin
        self._now = now
        self._lock = threading.Lock()
        self._last_capture: dict[str, float] = {}  # guarded by: _lock
        self._digests: set[str] = set()  # guarded by: _lock
        self._bundles: deque[dict] = deque(maxlen=keep)  # guarded by: _lock
        self.captures = 0
        self.skipped = 0
        self.last_bundle: Optional[str] = None
        self.last_error: Optional[str] = None
        self._captures_total = None
        self._bundle_bytes = None
        if registry is not None:
            self._captures_total, self._bundle_bytes = metric_families(
                registry
            )

    # ---------------------------------------------------------- triggers

    def observe_poll(self, replica: str, incidents_total: int) -> None:
        """A replica's summary-poll incident cursor advanced: capture
        its episode (async — never on the poll thread)."""
        self.trigger(
            f"{replica}#{incidents_total}",
            trigger="summary_poll",
            episode=replica,
        )

    def on_incident(self, incident: dict) -> None:
        """Full-record listener for the router's OWN AnomalyMonitors
        (SLO burn alerts, canary mismatches)."""
        metric = str(incident.get("metric", "incident"))
        self.trigger(
            f"router:{metric}", trigger="local_incident", episode=metric
        )

    def trigger(
        self,
        incident_id: str,
        *,
        trigger: str = "manual",
        episode: Optional[str] = None,
    ) -> None:
        """Fire-and-forget capture on a worker thread, debounced per
        episode key (one bundle per episode, however many incidents the
        cooldown re-fires)."""
        key = episode or incident_id
        now = self._now()
        with self._lock:
            last = self._last_capture.get(key)
            if last is not None and now - last < self.debounce_s:
                debounced = True
            else:
                debounced = False
                self._last_capture[key] = now
        if debounced:
            self._skip(trigger, incident_id, "debounced")
            return
        threading.Thread(
            target=self._capture_guarded,
            args=(incident_id, trigger),
            name="postmortem-capture",
            daemon=True,
        ).start()

    def capture_now(
        self, incident_id: str, trigger: str = "manual"
    ) -> Optional[str]:
        """Synchronous capture, NO debounce — the admin POST and the
        test/bench harnesses.  Returns the bundle path (None on
        duplicate evidence or error)."""
        return self._capture_guarded(incident_id, trigger)

    # ----------------------------------------------------------- capture

    def _skip(self, trigger: str, incident_id: str, reason: str) -> None:
        self.skipped += 1
        if self._captures_total is not None:
            self._captures_total.inc(trigger=trigger, outcome=reason)
        if self.flight is not None:
            self.flight.record(
                "postmortem.skipped",
                key=incident_id,
                trigger=trigger,
                reason=reason,
            )

    def _capture_guarded(self, incident_id, trigger) -> Optional[str]:
        try:
            return self._capture(incident_id, trigger)
        except Exception as e:  # never poison the caller
            log.exception("fleet postmortem capture failed")
            self.last_error = str(e)
            self._skip(trigger, incident_id, "error")
            return None

    def _fetch(self, target: str, path: str):
        """One GET against ``host:port``; returns (body, error) — JSON
        decoded when possible, exposition text for /metrics."""
        host, _, port = target.rpartition(":")
        conn = http.client.HTTPConnection(
            host, int(port), timeout=self.timeout_s
        )
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                return None, f"HTTP {resp.status}"
            if path == "/metrics":
                return raw.decode(errors="replace"), None
            return json.loads(raw or b"{}"), None
        except (*_CONN_ERRORS, ValueError) as e:
            return None, str(e)
        finally:
            conn.close()

    def _collect(self, target: str) -> tuple[dict, dict]:
        """All forensic endpoints of one component: (payload, fetch
        accounting).  Endpoint keys are the basenames the classifier
        reads (flight/spans/state/metrics)."""
        payload: dict = {}
        fetched: dict = {}
        for path in ENDPOINTS:
            body, err = self._fetch(target, path)
            name = path.rsplit("/", 1)[-1]
            if err is None:
                payload[name] = body
                fetched[name] = "ok"
            else:
                fetched[name] = f"error: {err}"
        return payload, fetched

    def _capture(self, incident_id: str, trigger: str) -> Optional[str]:
        if not self.directory:
            self._skip(trigger, incident_id, "no_dir")
            return None
        components: dict[str, bytes] = {}
        accounting: dict[str, dict] = {}
        if self.local_fn is not None:
            try:
                local = self.local_fn()
                components["router.json"] = json.dumps(
                    local, separators=(",", ":"), default=str
                ).encode()
                accounting["router"] = {"local": "ok"}
            except Exception as e:
                accounting["router"] = {"local": f"error: {e}"}
        for target in list(self.targets_fn() or ()):
            payload, fetched = self._collect(target)
            accounting[f"replica-{target}"] = fetched
            if payload:
                payload["component"] = f"replica-{target}"
                components[
                    f"replica-{_safe_component(target)}.json"
                ] = json.dumps(
                    payload, separators=(",", ":"), default=str
                ).encode()
        for role, url in (
            ("plugin", self.plugin_url),
            ("controller", self.controller_url),
        ):
            if not url:
                continue
            payload, fetched = self._collect(url)
            accounting[role] = fetched
            if payload:
                payload["component"] = role
                components[f"{role}.json"] = json.dumps(
                    payload, separators=(",", ":"), default=str
                ).encode()
        if not components:
            self._skip(trigger, incident_id, "error")
            self.last_error = "no component answered any forensic endpoint"
            return None

        digest = hashlib.sha256()
        for name in sorted(components):
            digest.update(name.encode())
            digest.update(components[name])
        bundle_digest = digest.hexdigest()
        with self._lock:
            if bundle_digest in self._digests:
                duplicate = True
            else:
                duplicate = False
                self._digests.add(bundle_digest)
        if duplicate:
            self._skip(trigger, incident_id, "duplicate")
            return None

        name = (
            f"{BUNDLE_PREFIX}fleet-{int(time.time())}-{bundle_digest[:12]}"
        )
        final = os.path.join(self.directory, name)
        staging = final + INPROGRESS_SUFFIX
        manifest = {
            "schema": FLEET_SCHEMA,
            "incident_id": incident_id,
            "trigger": trigger,
            "pid": os.getpid(),
            "ts": round(time.time(), 3),
            "digest": bundle_digest,
            "components": accounting,
            "files": {
                n: {
                    "bytes": len(body),
                    "sha256": hashlib.sha256(body).hexdigest(),
                }
                for n, body in components.items()
            },
        }
        os.makedirs(staging, exist_ok=True)
        for fname, body in components.items():
            with open(os.path.join(staging, fname), "wb") as f:
                f.write(body)
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump(manifest, f, separators=(",", ":"))
        os.rename(staging, final)

        bundle_bytes = sum(len(b) for b in components.values())
        record = {
            "incident_id": incident_id,
            "trigger": trigger,
            "bundle": name,
            "path": final,
            "bytes": bundle_bytes,
            "ts": manifest["ts"],
            "components": sorted(accounting),
            "errors": sum(
                1
                for fetched in accounting.values()
                for v in fetched.values()
                if str(v).startswith("error")
            ),
        }
        with self._lock:
            self._bundles.append(record)
        self.captures += 1
        self.last_bundle = final
        if self._captures_total is not None:
            self._captures_total.inc(trigger=trigger, outcome="captured")
        if self._bundle_bytes is not None:
            self._bundle_bytes.set(bundle_bytes)
        if self.flight is not None:
            self.flight.record(
                "postmortem.captured",
                key=incident_id,
                trigger=trigger,
                bundle=name,
                bytes=bundle_bytes,
                digest=bundle_digest[:12],
            )
        sweep_dump_dir(
            self.directory,
            self.budget_bytes,
            self.max_entries,
            protect=(final,),
            flight=self.flight,
        )
        return final

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The ``GET /debug/postmortem`` body."""
        with self._lock:
            bundles = [dict(b) for b in self._bundles]
            keys = len(self._last_capture)
        return {
            "enabled": True,
            "directory": self.directory,
            "debounce_s": self.debounce_s,
            "budget_bytes": self.budget_bytes,
            "plugin_url": self.plugin_url,
            "controller_url": self.controller_url,
            "captures": self.captures,
            "skipped": self.skipped,
            "episodes": keys,
            "last_bundle": self.last_bundle,
            "last_error": self.last_error,
            "bundles": bundles,
        }
