"""Idle-card self-test sweep: the device plugin's half of the active
correctness plane.

Counterpart of the JAX package's ``plugin/selftest.py``.  The health
checker (plugin/health.py) answers "is the card *there*": open() probes
catch a vanished device node, but a card that computes *wrong answers*
opens fine.  :class:`SelftestSweeper` gives the cards the
:class:`~.attribution.AllocationLedger` shows **unallocated** a periodic
deterministic matmul-checksum probe: the expected checksum is
:func:`matmul_checksum`, the reference's seeded int64 product on the host,
bit for bit; the probe (:func:`card_checksum`) computes the same product
on the card it names (``cuda:<ordinal>`` found from its PCI address).
``fail_threshold`` consecutive mismatches quarantine the card by writing
the health checker's own override file (``run/gpu/health/nvidiaN``), so
the next health sweep reports it Unhealthy and the kubelet places no pod
on it.  Recovery is manual: an operator removes the file.

Busy cards are never probed (the ledger is the arbiter).  ``torch`` is
imported only inside the probe, so a daemon with ``--selftest-interval
0`` never creates a CUDA context.  The ``selftest.probe`` failpoint
corrupts or fails probes for chaos scenarios, and ``probe_fn`` is the
unit-test seam.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np

from ..utils import failpoints
from .health import override_path

log = logging.getLogger(__name__)

FAILPOINT_PROBE = "selftest.probe"

# Probe workload shape: big enough that a bad MAC unit has work to
# corrupt, small enough to stay invisible next to a health sweep.
_PROBE_DIM = 64


def matmul_checksum(seed: int = 0, dim: int = _PROBE_DIM) -> int:
    """Deterministic matmul-checksum probe: seeded integer matrices,
    exact int64 product, crc32 of the result bytes.  Integer on
    purpose — bit-exact on every host, no float tolerance to hide a
    flipped bit in."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, size=(dim, dim), dtype=np.int64)
    b = rng.integers(-128, 128, size=(dim, dim), dtype=np.int64)
    return zlib.crc32(np.ascontiguousarray(a @ b).tobytes())


def torch_checksum(seed: int = 0, device="cpu", dim: int = _PROBE_DIM) -> int:
    """:func:`matmul_checksum`'s product computed by torch on ``device``:
    the same seeded int64 inputs as float64 (every partial sum stays
    below 2^21, so float64 is exact; CUDA has no int64 matmul, and float32
    could take TF32 under a process's matmul settings), cast back to
    int64 on the host and crc'd."""
    import torch

    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, size=(dim, dim), dtype=np.int64)
    b = rng.integers(-128, 128, size=(dim, dim), dtype=np.int64)
    ta = torch.from_numpy(a.astype(np.float64)).to(device)
    tb = torch.from_numpy(b.astype(np.float64)).to(device)
    c = (ta @ tb).to(torch.int64).cpu().numpy()
    return zlib.crc32(np.ascontiguousarray(c).tobytes())


def _cuda_uuid(props) -> str:
    """A device's UUID as NVML prints it, without the ``GPU-`` prefix."""
    import uuid

    raw = getattr(props, "uuid", None)
    if raw is None:
        return ""
    data = getattr(raw, "bytes", None)
    return str(uuid.UUID(bytes=bytes(data))) if data is not None else str(raw).lower()


def cuda_ordinal(card) -> int:
    """The CUDA ordinal of ``card`` in this process: the device whose PCI
    address (domain, bus, device) is the card's, or, for a card whose
    driver reported no PCI address, whose UUID is."""
    import torch

    want_uuid = (card.uuid or "").lower().removeprefix("gpu-")
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        if card.pci_address and getattr(props, "pci_domain_id", None) is not None:
            address = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
                       f"{props.pci_device_id:02x}.0")
            if address == card.pci_address.lower():
                return i
        elif want_uuid and _cuda_uuid(props) == want_uuid:
            return i
    raise LookupError(f"{card.k8s_id} ({card.pci_address}, {card.uuid}) is not a CUDA device "
                      "of this process")


def card_checksum(card, seed: int = 0) -> int:
    """The default probe: :func:`torch_checksum` on ``cuda:<ordinal>`` of
    ``card``."""
    import torch

    return torch_checksum(seed, torch.device("cuda", cuda_ordinal(card)))


@dataclasses.dataclass
class SelftestConfig:
    """Tunables for :class:`SelftestSweeper` (CLI: ``--selftest-*``)."""

    # Seconds between idle sweeps.
    interval_s: float = 60.0
    # Consecutive checksum failures before the chip is quarantined.
    fail_threshold: int = 2
    # Quarantine policy: write the health override file (the kubelet
    # stops placing pods) — False = observe-only (incidents still fire).
    quarantine: bool = True
    # Probe workload seed (rotated per sweep so a stuck-at fault that
    # happens to checksum clean on one input still gets caught).
    seeds: tuple = (0, 1, 2, 3)

    def __post_init__(self):
        if self.fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if not self.seeds:
            raise ValueError("at least one probe seed required")


class _ChipTrack:
    __slots__ = (
        "verdict", "fail_streak", "probes", "failures", "quarantined",
    )

    def __init__(self):
        self.verdict = None
        self.fail_streak = 0
        self.probes = 0
        self.failures = 0
        self.quarantined = False


class SelftestSweeper:
    """Periodic idle-card correctness sweep.

    ``inventory_fn`` returns the cards to consider (GpuCard tuples from
    discovery); ``busy_fn`` returns the set of k8s_ids currently
    allocated (cli.py passes ``ledger.granted`` — granted includes
    confirmed); ``probe_fn(card, seed)`` returns the probe checksum
    (defaults to :func:`card_checksum` on the card itself — the
    unit-test seam)."""

    def __init__(
        self,
        inventory_fn: Callable[[], tuple],
        busy_fn: Callable[[], set],
        *,
        config: Optional[SelftestConfig] = None,
        root: str = "/",
        metrics=None,
        flight=None,
        anomaly=None,
        probe_fn=None,
        now=time.perf_counter,
    ):
        self.cfg = config or SelftestConfig()
        self._inventory_fn = inventory_fn
        self._busy_fn = busy_fn
        self._root = root
        self._metrics = metrics
        self._flight = flight
        self._anomaly = anomaly
        self._probe_fn = probe_fn
        self._now = now
        self._lock = threading.Lock()
        self._tracks: dict[str, _ChipTrack] = {}
        # Expected checksum per seed, computed once on first use from
        # the same pure function the probes run — self-golden.
        self._expected: dict[int, int] = {}
        self.sweeps = 0
        self.quarantines = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ probes

    def _record(self, kind: str, **fields) -> None:
        if self._flight is not None:
            self._flight.record(kind, **fields)

    def _count(self, device: str, verdict: str) -> None:
        m = getattr(self._metrics, "selftests", None)
        if m is not None:
            m.inc(device=device, verdict=verdict)

    def _expected_for(self, seed: int) -> int:
        got = self._expected.get(seed)
        if got is None:
            got = matmul_checksum(seed)
            self._expected[seed] = got
        return got

    def _probe(self, chip, seed: int) -> int:
        """One probe checksum, through the chaos seam: arming
        ``selftest.probe.<k8s_id>=corrupt`` (or the bare site) flips
        bits of ONE chip's result — the injected-SDC ground truth the
        chaos scenario scores detection against; ``error`` raises
        (probe machinery broken, not a sick chip)."""
        hit = failpoints.fire_scoped(
            FAILPOINT_PROBE, scope=chip.k8s_id, device=chip.k8s_id
        )
        checksum = int((self._probe_fn or card_checksum)(chip, seed))
        if hit is not None and hit.mode == "corrupt":
            nbytes = int(hit.arg) if hit.arg else 1
            checksum ^= (1 << (8 * nbytes)) - 1
        return checksum

    def _quarantine(self, chip) -> None:
        """Write the health checker's override file: the next health
        sweep reports the chip Unhealthy and the kubelet stops placing
        pods on it — the same kill-switch an operator would use, so
        recovery tooling and triage are identical."""
        path = override_path(self._root, chip)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write("Unhealthy")
        except OSError as e:  # pragma: no cover - bad root in prod only
            log.error("selftest quarantine write failed for %s: %s",
                      chip.k8s_id, e)
            self._record(
                "selftest.quarantine_failed", device=chip.k8s_id,
                error=str(e),
            )
            return
        self.quarantines += 1
        g = getattr(self._metrics, "selftest_quarantined", None)
        if g is not None:
            g.set(1, device=chip.k8s_id)
        self._record("selftest.quarantine", device=chip.k8s_id, path=path)
        log.warning(
            "chip %s quarantined by self-test (override %s)",
            chip.k8s_id, path,
        )

    def poll_once(self) -> dict:
        """One sweep over the currently-idle inventory; returns
        {k8s_id: verdict} (verdicts: pass/fail/skip_busy/error).  The
        unit-test driving seam — production calls it from the daemon
        thread."""
        cfg = self.cfg
        seed = cfg.seeds[self.sweeps % len(cfg.seeds)]
        expected = self._expected_for(seed)
        try:
            chips = tuple(self._inventory_fn())
            busy = set(self._busy_fn())
        except Exception as e:
            self._record("selftest.sweep_error", error=str(e))
            self.sweeps += 1
            return {}
        verdicts: dict[str, str] = {}
        for chip in chips:
            with self._lock:
                track = self._tracks.setdefault(chip.k8s_id, _ChipTrack())
            if chip.k8s_id in busy:
                # The ledger is the arbiter: never race a workload for
                # the device, never charge a busy chip a probe.
                verdicts[chip.k8s_id] = "skip_busy"
                with self._lock:
                    track.verdict = "skip_busy"
                self._count(chip.k8s_id, "skip_busy")
                continue
            t0 = self._now()
            try:
                checksum = self._probe(chip, seed)
            except Exception as e:
                verdicts[chip.k8s_id] = "error"
                with self._lock:
                    track.verdict = "error"
                self._count(chip.k8s_id, "error")
                self._record(
                    "selftest.probe_error", device=chip.k8s_id,
                    error=str(e),
                )
                continue
            h = getattr(self._metrics, "selftest_seconds", None)
            if h is not None:
                h.observe(self._now() - t0)
            with self._lock:
                track.probes += 1
                if checksum == expected:
                    track.fail_streak = 0
                    track.verdict = "pass"
                    verdicts[chip.k8s_id] = "pass"
                else:
                    track.fail_streak += 1
                    track.failures += 1
                    track.verdict = "fail"
                    verdicts[chip.k8s_id] = "fail"
                streak = track.fail_streak
                quarantined = track.quarantined
            self._count(chip.k8s_id, verdicts[chip.k8s_id])
            if verdicts[chip.k8s_id] != "fail":
                continue
            self._record(
                "selftest.checksum_mismatch", device=chip.k8s_id,
                seed=seed, streak=streak, got=checksum, want=expected,
            )
            if streak == cfg.fail_threshold:
                # The confirmed sick-chip incident: once per episode.
                self._record(
                    "selftest.fail", device=chip.k8s_id, streak=streak
                )
                if self._anomaly is not None:
                    self._anomaly.report(
                        "selftest.fail", observed=float(streak),
                        device=chip.k8s_id,
                    )
            if streak >= cfg.fail_threshold and cfg.quarantine \
                    and not quarantined:
                self._quarantine(chip)
                with self._lock:
                    track.quarantined = True
        self.sweeps += 1
        return verdicts

    def snapshot(self) -> dict:
        """The ``GET /debug/selftest`` body (any thread)."""
        with self._lock:
            chips = {
                k8s_id: {
                    "verdict": t.verdict,
                    "fail_streak": t.fail_streak,
                    "probes": t.probes,
                    "failures": t.failures,
                    "quarantined": t.quarantined,
                }
                for k8s_id, t in self._tracks.items()
            }
        return {
            "sweeps": self.sweeps,
            "quarantines": self.quarantines,
            "chips": chips,
            "config": {
                "interval_s": self.cfg.interval_s,
                "fail_threshold": self.cfg.fail_threshold,
                "quarantine": self.cfg.quarantine,
                "seeds": list(self.cfg.seeds),
            },
        }

    # --------------------------------------------------------- lifecycle

    def start(self) -> "SelftestSweeper":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="gpu-plugin-selftest", daemon=True
        )
        self._thread.start()
        self._record("selftest.started", interval_s=self.cfg.interval_s)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.poll_once()
            except Exception as e:  # pragma: no cover - belt and braces
                self._record("selftest.sweep_error", error=str(e))

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self._record("selftest.stopped", sweeps=self.sweeps)
