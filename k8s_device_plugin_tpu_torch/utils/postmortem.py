"""Incident-triggered postmortem capture + dump-dir retention.

The port's own copy of the reference's ``utils/postmortem.py`` (the port imports
nothing of the JAX package); its behaviour, names and wire shapes are
the reference's, held by tests/test_torch_admission.py.

The forensics layer so far is *passive*: flight rings and span rings
roll, ``/debug`` surfaces answer while the process lives, and the only
durable record is whatever SIGUSR2/atexit dump happened to be asked
for.  When an anomaly incident fires, the evidence an operator needs is
exactly the state that is about to rot.  This module closes that gap
(arXiv:2510.16946's host-side diagnosis argument, applied at incident
time):

- :class:`PostmortemCapture` — a full-record incident listener
  (``AnomalyMonitor.add_listener``) that atomically snapshots the local
  flight ring, span ring, metrics exposition, and a ``/debug/state``-
  equivalent into a content-addressed bundle directory under the dump
  dir.  Debounced per incident key: one capture per episode, not one
  per cooldown re-fire.  Emits ``postmortem.captured`` /
  ``postmortem.skipped`` flight events and the
  ``tpu_postmortem_captures_total{trigger,outcome}`` /
  ``tpu_postmortem_bundle_bytes`` metrics.
- :func:`sweep_dump_dir` — the byte/count-budgeted LRU pruner shared by
  BOTH dump-dir writers (flight dumps and postmortem bundles):
  oldest-first by mtime, never touching an in-progress bundle (the
  ``.inprogress`` staging suffix) or the entry just written.  Emits
  ``postmortem.pruned`` flight events.

Bundle layout (``postmortem-<component>-<ts>-<digest12>/``)::

    manifest.json   schema, component, incident key/trigger, ts,
                    per-file sha256 digests + sizes, bundle digest
    incident.json   the full incident record (flight window included)
    flight.json     FlightRecorder.snapshot()
    spans.json      SpanRecorder.dump()
    metrics.prom    the Prometheus exposition text at capture time
    state.json      the component's /debug/state-equivalent snapshot

Content addressing: the bundle digest is the sha256 over the evidence
files' bytes; a re-capture producing byte-identical evidence (possible
when nothing moved between two incidents) is deduplicated as outcome
``duplicate`` rather than written twice.  Everything is stdlib-only and
never raises into the caller — a capture failure must not poison
detection (same contract as ``flight.dump_all``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Optional

log = logging.getLogger("tpu.postmortem")


def metric_families(registry):
    """Get-or-create the ``tpu_postmortem_*`` families on ``registry``:
    (captures_total counter, bundle_bytes gauge).  Lookup-first so two
    hooks on one process-wide registry (or a re-built daemon in tests)
    share the families instead of raising on duplicate registration."""
    captures = registry.get("tpu_postmortem_captures_total")
    if captures is None:
        captures = registry.counter(
            "tpu_postmortem_captures_total",
            "postmortem capture attempts by trigger and outcome",
            labelnames=("trigger", "outcome"),
        )
    bundle_bytes = registry.get("tpu_postmortem_bundle_bytes")
    if bundle_bytes is None:
        bundle_bytes = registry.gauge(
            "tpu_postmortem_bundle_bytes",
            "size of the last written postmortem bundle",
        )
    return captures, bundle_bytes

BUNDLE_SCHEMA = "tpu-postmortem-bundle/v1"
BUNDLE_PREFIX = "postmortem-"
# Staging suffix for a bundle being written: rename-published on
# completion, and the sweeper skips anything still carrying it.
INPROGRESS_SUFFIX = ".inprogress"
# The flight-dump file pattern the shared pruner also manages.
FLIGHT_DUMP_PREFIX = "tpu-flight-"

DEFAULT_DEBOUNCE_S = 120.0
DEFAULT_BUDGET_MB = 256


def _entry_bytes(path: str) -> int:
    """Total size of one dump-dir entry (file, or bundle dir walked)."""
    try:
        if os.path.isdir(path):
            total = 0
            for root, _dirs, files in os.walk(path):
                for name in files:
                    try:
                        total += os.path.getsize(os.path.join(root, name))
                    except OSError:
                        pass
            return total
        return os.path.getsize(path)
    except OSError:
        return 0


def _list_entries(directory: str) -> list[dict]:
    """Managed dump-dir entries (flight dumps + published bundles),
    oldest mtime first.  In-progress bundles are invisible to the
    sweeper by construction."""
    entries = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if name.endswith(INPROGRESS_SUFFIX):
            continue
        managed = (
            name.startswith(BUNDLE_PREFIX)
            or (name.startswith(FLIGHT_DUMP_PREFIX) and name.endswith(".json"))
        )
        if not managed:
            continue
        path = os.path.join(directory, name)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        entries.append(
            {"name": name, "path": path, "mtime": mtime,
             "bytes": _entry_bytes(path)}
        )
    entries.sort(key=lambda e: (e["mtime"], e["name"]))
    return entries


def sweep_dump_dir(
    directory: str,
    budget_bytes: Optional[int] = None,
    max_entries: Optional[int] = None,
    *,
    protect=(),
    flight=None,
) -> dict:
    """LRU-prune the dump dir to its byte/count budget; returns the
    sweep accounting ``{entries, bytes, pruned, pruned_bytes}``.

    Oldest-first by mtime, across BOTH writers' artifacts (flight-dump
    files and postmortem bundle dirs).  Never prunes an in-progress
    bundle (``.inprogress`` names are not even listed) or anything in
    ``protect`` (the entry a capture just published).  A ``flight``
    recorder, when given, gets one ``postmortem.pruned`` event per
    removed entry.  Never raises."""
    entries = _list_entries(directory)
    protected = {os.path.basename(p) for p in protect}
    total = sum(e["bytes"] for e in entries)
    count = len(entries)
    pruned = 0
    pruned_bytes = 0
    for entry in entries:
        over_bytes = budget_bytes is not None and total > budget_bytes
        over_count = max_entries is not None and count > max_entries
        if not (over_bytes or over_count):
            break
        if entry["name"] in protected:
            continue
        try:
            if os.path.isdir(entry["path"]):
                shutil.rmtree(entry["path"])
            else:
                os.remove(entry["path"])
        except OSError as e:
            log.warning("dump-dir prune of %s failed: %s", entry["path"], e)
            continue
        total -= entry["bytes"]
        count -= 1
        pruned += 1
        pruned_bytes += entry["bytes"]
        if flight is not None:
            flight.record(
                "postmortem.pruned",
                entry=entry["name"],
                bytes=entry["bytes"],
                age_s=round(max(time.time() - entry["mtime"], 0.0), 1),
            )
    return {
        "entries": count,
        "bytes": total,
        "pruned": pruned,
        "pruned_bytes": pruned_bytes,
    }


class PostmortemCapture:
    """The single-process capture hook: incident in, bundle dir out.

    Wire it into a component's :class:`~.anomaly.AnomalyMonitor` via
    ``monitor.add_listener(capture.on_incident)``; every emitted
    incident then snapshots the component's forensic state to disk —
    once per incident key per ``debounce_s`` episode window.

    ``state_fn`` is the component's ``/debug/state``-equivalent
    snapshot callable (JSON-serializable return); ``registry`` is both
    the exposition that gets bundled AND where this hook's own metrics
    register (pass ``metrics=False`` to skip registration when the
    registry already carries the families — e.g. a second hook on the
    same process).
    """

    def __init__(
        self,
        component: str,
        directory: str,
        *,
        flight=None,
        spans=None,
        registry=None,
        state_fn=None,
        debounce_s: float = DEFAULT_DEBOUNCE_S,
        budget_bytes: Optional[int] = None,
        max_entries: Optional[int] = None,
        metrics: bool = True,
        now=time.monotonic,
    ):
        self.component = str(component)
        self.directory = directory
        self.flight = flight
        self.spans = spans
        self.registry = registry
        self.state_fn = state_fn
        self.debounce_s = float(debounce_s)
        self.budget_bytes = budget_bytes
        self.max_entries = max_entries
        self._now = now
        self._lock = threading.Lock()
        self._last_capture: dict[str, float] = {}  # guarded by: _lock
        self._digests: set[str] = set()  # guarded by: _lock
        self.captures = 0
        self.skipped = 0
        self.last_bundle: Optional[str] = None
        self.last_error: Optional[str] = None
        self._captures_total = None
        self._bundle_bytes = None
        if registry is not None and metrics:
            self._captures_total, self._bundle_bytes = metric_families(
                registry
            )

    # ------------------------------------------------------------ hooks

    def on_incident(self, incident: dict) -> None:
        """The ``AnomalyMonitor.add_listener`` adapter: capture keyed by
        the incident's cause metric (one bundle per episode even while
        the detector re-fires each cooldown)."""
        key = str(incident.get("metric", "incident"))
        self.capture("incident", key=key, incident=incident)

    # ---------------------------------------------------------- capture

    def _account(self, trigger: str, outcome: str) -> None:
        if self._captures_total is not None:
            self._captures_total.inc(trigger=trigger, outcome=outcome)

    def _skip(self, trigger: str, key: str, reason: str) -> None:
        self.skipped += 1
        self._account(trigger, reason)
        if self.flight is not None:
            self.flight.record(
                "postmortem.skipped", key=key, trigger=trigger, reason=reason
            )

    def capture(
        self,
        trigger: str,
        *,
        key: str,
        incident: Optional[dict] = None,
    ) -> Optional[str]:
        """Snapshot the component's forensic state into one bundle dir;
        returns the published path, or None (debounced / duplicate /
        no dir / error — the outcome lands in the metrics and a
        ``postmortem.skipped`` flight event).  Never raises."""
        try:
            return self._capture(trigger, key, incident)
        except Exception as e:  # the listener contract: never poison
            log.exception("postmortem capture failed")
            self.last_error = str(e)
            self._skip(trigger, key, "error")
            return None

    def _capture(
        self, trigger: str, key: str, incident: Optional[dict]
    ) -> Optional[str]:
        if not self.directory:
            self._skip(trigger, key, "no_dir")
            return None
        now = self._now()
        with self._lock:
            last = self._last_capture.get(key)
            if last is not None and now - last < self.debounce_s:
                debounced = True
            else:
                debounced = False
                self._last_capture[key] = now
        if debounced:
            self._skip(trigger, key, "debounced")
            return None

        files: dict[str, bytes] = {}
        if incident is not None:
            files["incident.json"] = json.dumps(
                incident, separators=(",", ":"), default=str
            ).encode()
        if self.flight is not None:
            files["flight.json"] = json.dumps(
                self.flight.snapshot(), separators=(",", ":")
            ).encode()
        if self.spans is not None:
            files["spans.json"] = json.dumps(
                self.spans.dump(), separators=(",", ":")
            ).encode()
        if self.registry is not None:
            files["metrics.prom"] = self.registry.render().encode()
        if self.state_fn is not None:
            try:
                state = self.state_fn()
            except Exception as e:
                state = {"error": str(e)}
            files["state.json"] = json.dumps(
                state, separators=(",", ":"), default=str
            ).encode()

        digest = hashlib.sha256()
        for name in sorted(files):
            digest.update(name.encode())
            digest.update(files[name])
        bundle_digest = digest.hexdigest()
        with self._lock:
            if bundle_digest in self._digests:
                duplicate = True
            else:
                duplicate = False
                self._digests.add(bundle_digest)
        if duplicate:
            self._skip(trigger, key, "duplicate")
            return None

        name = (
            f"{BUNDLE_PREFIX}{self.component}-{int(time.time())}"
            f"-{bundle_digest[:12]}"
        )
        final = os.path.join(self.directory, name)
        staging = final + INPROGRESS_SUFFIX
        manifest = {
            "schema": BUNDLE_SCHEMA,
            "component": self.component,
            "pid": os.getpid(),
            "ts": round(time.time(), 3),
            "trigger": trigger,
            "key": key,
            "digest": bundle_digest,
            "files": {
                n: {
                    "bytes": len(body),
                    "sha256": hashlib.sha256(body).hexdigest(),
                }
                for n, body in files.items()
            },
        }
        os.makedirs(staging, exist_ok=True)
        for fname, body in files.items():
            with open(os.path.join(staging, fname), "wb") as f:
                f.write(body)
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump(manifest, f, separators=(",", ":"))
        # Publish: until this rename the sweeper cannot see the bundle,
        # after it the bundle is complete — no torn reads either way.
        # The digest in the name makes collisions impossible (same
        # digest deduplicated above).
        os.rename(staging, final)

        bundle_bytes = _entry_bytes(final)
        self.captures += 1
        self.last_bundle = final
        self._account(trigger, "captured")
        if self._bundle_bytes is not None:
            self._bundle_bytes.set(bundle_bytes)
        if self.flight is not None:
            self.flight.record(
                "postmortem.captured",
                key=key,
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

    # --------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        with self._lock:
            keys = len(self._last_capture)
        return {
            "component": self.component,
            "directory": self.directory,
            "debounce_s": self.debounce_s,
            "budget_bytes": self.budget_bytes,
            "captures": self.captures,
            "skipped": self.skipped,
            "debounce_keys": keys,
            "last_bundle": self.last_bundle,
            "last_error": self.last_error,
        }
