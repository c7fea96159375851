"""Per-card NVIDIA GPU health checking.

Counterpart of the JAX package's ``plugin/health.py``: each card is probed
on its own with an open() of its ``/dev/nvidiaN``, and the driver's
control node ``/dev/nvidiactl`` must exist too (without it no process can
reach any card, so every card reads Unhealthy).  The operator override
file ``run/gpu/health/nvidiaN`` is read first, as the reference reads
``run/tpu/health/accelN``; the flap debounce and the busy-errno rule
(EBUSY, EACCES and EPERM mean a card that is there but not ours to open)
are the reference's.
"""

from __future__ import annotations

import errno
import logging
import os
import stat
import time

from ..utils import failpoints
from . import native
from .discovery import GpuCard

log = logging.getLogger(__name__)

# Drop-in override directory (relative to the injectable root): writing
# "Unhealthy" to {root}/run/gpu/health/nvidiaN force-fails card N: the
# operator kill-switch, the self-test's quarantine and the tests' fault
# injection.
HEALTH_OVERRIDE_DIR = "run/gpu/health"

# The driver's control node: every CUDA process opens it first.
CONTROL_NODE = "dev/nvidiactl"

# open() errors that mean "the card is there but busy", a healthy
# condition: an exclusive-process card held by a workload, or a node the
# device cgroup keeps for another container.
_BUSY_ERRNOS = {errno.EBUSY, errno.EACCES, errno.EPERM}


def override_path(root: str, card) -> str:
    """The card's override file under ``root``."""
    return os.path.join(root, HEALTH_OVERRIDE_DIR, f"nvidia{card.index}")


class CardHealthChecker:
    """Probes one card at a time; the single-probe path is stateless.

    The probe itself runs through libnvidia_probe.so when available (one C
    call per card, see plugin/native.py) with this file's pure-Python
    sequence as the fallback and the behavioral reference; override files
    and the control node are always handled in Python (cold path).

    ``flap_threshold`` debounces the Healthy→Unhealthy transition on the
    sweep path (:meth:`check_many`): a currently-Healthy chip must fail
    ``flap_threshold`` CONSECUTIVE sweeps before it is reported
    Unhealthy (suppressed probes emit a ``health.flap_suppressed``
    flight event instead) — one transient open() error on a busy devfs
    must not flap the kubelet's device list.  Recovery is never
    debounced: one healthy probe flips a chip back immediately.  The
    default (1) preserves the old report-on-first-failure behavior;
    the CLI defaults to 2 (``--health-flap-threshold``).
    """

    def __init__(
        self,
        root: str = "/",
        prober: native.NativeProber | None | object = "auto",
        observe_sweep_seconds=None,
        flight=None,
        flap_threshold: int = 1,
    ):
        self._root = root
        # "auto" → process-wide shared library; None → force Python path.
        self._prober = native.shared_prober() if prober == "auto" else prober
        # Optional telemetry hook: called with the wall seconds of every
        # check_many sweep (cli.py wires it to the plugin's
        # gpu_plugin_health_sweep_seconds histogram AND the anomaly
        # monitor's sweep-duration baseline) — the ONE place sweep
        # latency is observed, whoever drives the sweep.
        self._observe_sweep = observe_sweep_seconds
        # Optional flight recorder (utils/flight.py): probe open()
        # failures are black-box events — the raw evidence behind a
        # health transition the plugin later streams.
        self._flight = flight
        if flap_threshold < 1:
            raise ValueError(
                f"flap_threshold must be >= 1, got {flap_threshold}"
            )
        self._flap_threshold = int(flap_threshold)
        self._fail_streak: dict[str, int] = {}  # k8s_id -> consecutive fails
        self._last_reported: dict[str, bool] = {}  # k8s_id -> last sweep verdict

    def _inject(self, chip: GpuCard) -> bool | None:
        """The ``health.probe`` failpoint (docs/chaos.md): ``flap``
        forces alternating probe failures (True = fault active →
        Unhealthy probe), ``delay`` slows the sweep (feeding the sweep-
        duration anomaly baseline), ``error`` raises out of the sweep
        (the wedged-sysfs shape — the heartbeat's poll-failure counter
        catches it).  Returns the forced verdict or None."""
        hit = failpoints.fire("health.probe", device=chip.k8s_id)
        if hit is not None and hit.mode == "flap" and hit.value:
            if self._flight is not None:
                self._flight.record(
                    "health.probe_failure",
                    device=chip.device_path,
                    error=f"failpoint health.probe (trigger {hit.n})",
                )
            return False
        return None

    def _override(self, chip: GpuCard) -> bool | None:
        path = override_path(self._root, chip)
        try:
            with open(path, "r") as f:
                text = f.read().strip().lower()
        except OSError:
            return None
        return text not in {"unhealthy", "0", "false"}

    def _control_node_present(self) -> bool:
        return os.path.exists(os.path.join(self._root, CONTROL_NODE))

    def check(self, chip: GpuCard) -> bool:
        """True iff the card's PROBE came back healthy (stateless — the
        sweep-path debounce lives in :meth:`check_many`)."""
        # State transitions are logged once by the caller (poll_once), so the
        # per-probe path stays quiet even at high pulse rates.
        override = self._override(chip)
        if override is not None:
            return override
        injected = self._inject(chip)
        if injected is not None:
            return injected
        if not self._control_node_present():
            return False

        dev_path = os.path.join(self._root, chip.device_path.lstrip("/"))
        if self._prober is not None:
            code, err = self._prober.probe(dev_path)
            return self._classify(dev_path, code, err)
        try:
            st = os.stat(dev_path)
        except OSError:
            return False  # device node vanished
        # On a real node this is a chardev; fixture trees use regular files.
        if not (stat.S_ISCHR(st.st_mode) or stat.S_ISREG(st.st_mode)):
            return False
        try:
            fd = os.open(dev_path, os.O_RDONLY | os.O_NONBLOCK)
        except OSError as e:
            if e.errno in _BUSY_ERRNOS:
                return True  # exclusively held by a workload: alive and in use
            log.warning("open(%s) failed: %s", dev_path, e)
            if self._flight is not None:
                self._flight.record(
                    "health.probe_failure", device=dev_path, error=str(e)
                )
            return False
        else:
            os.close(fd)
            return True

    def _classify(self, dev_path: str, code: int, err: int) -> bool:
        if code == native.PROBE_OPENFAIL:
            log.warning(
                "open(%s) failed: %s", dev_path, os.strerror(err) if err else err
            )
            if self._flight is not None:
                self._flight.record(
                    "health.probe_failure",
                    device=dev_path,
                    error=os.strerror(err) if err else str(err),
                )
        return native.is_healthy_code(code)

    def check_many(self, chips: tuple[GpuCard, ...] | list[GpuCard]) -> dict[str, bool]:
        """Health of a whole inventory, k8s_id -> healthy.  With the native
        prober this is ONE FFI crossing for every non-overridden chip (the
        per-pulse hot path of the daemon); otherwise it loops check()."""
        t0 = time.perf_counter()
        try:
            return self._debounce(self._check_many(chips))
        finally:
            if self._observe_sweep is not None:
                self._observe_sweep(time.perf_counter() - t0)

    def _check_many(self, chips) -> dict[str, bool]:
        result: dict[str, bool] = {}
        if self._prober is None:
            return {chip.k8s_id: self.check(chip) for chip in chips}
        batched: list[tuple[GpuCard, str]] = []
        control = self._control_node_present()
        for chip in chips:
            override = self._override(chip)
            if override is not None:
                result[chip.k8s_id] = override
                continue
            injected = self._inject(chip)
            if injected is not None:
                result[chip.k8s_id] = injected
                continue
            if not control:
                result[chip.k8s_id] = False
                continue
            batched.append(
                (chip, os.path.join(self._root, chip.device_path.lstrip("/")))
            )
        codes = self._prober.probe_many([path for _, path in batched])
        for (chip, path), (code, err) in zip(batched, codes):
            result[chip.k8s_id] = self._classify(path, code, err)
        return result

    def _debounce(self, raw: dict[str, bool]) -> dict[str, bool]:
        """Suppress Healthy→Unhealthy flips until ``flap_threshold``
        consecutive failed sweeps (recovery passes through untouched).
        One transient probe error must not cycle a chip through the
        kubelet's device list — unhealthy devices get their workloads
        evicted, which is far more expensive than one skipped pulse."""
        out: dict[str, bool] = {}
        for k8s_id, healthy in raw.items():
            if healthy:
                self._fail_streak.pop(k8s_id, None)
                self._last_reported[k8s_id] = True
                out[k8s_id] = True
                continue
            streak = self._fail_streak.get(k8s_id, 0) + 1
            self._fail_streak[k8s_id] = streak
            # A never-seen chip debounces from Healthy: its first failing
            # sweep could be the same transient this gate exists for.
            was = self._last_reported.get(k8s_id, True)
            if was and streak < self._flap_threshold:
                out[k8s_id] = True
                log.info(
                    "suppressing health flap of %s (%d/%d consecutive "
                    "failures)",
                    k8s_id, streak, self._flap_threshold,
                )
                if self._flight is not None:
                    self._flight.record(
                        "health.flap_suppressed",
                        device=k8s_id,
                        streak=streak,
                        threshold=self._flap_threshold,
                    )
            else:
                out[k8s_id] = False
                self._last_reported[k8s_id] = False
        # Unplugged chips leave no stale streak state behind.
        for k8s_id in set(self._fail_streak) - raw.keys():
            del self._fail_streak[k8s_id]
        for k8s_id in set(self._last_reported) - raw.keys():
            del self._last_reported[k8s_id]
        return out
