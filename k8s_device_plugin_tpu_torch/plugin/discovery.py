"""NVIDIA GPU discovery from devfs, the driver's card list and sysfs.

Counterpart of the JAX package's ``plugin/discovery.py`` (``discover``),
which reads ``/dev/accel*``, ``/sys/class/accel`` and vendor ``0x1ae0``.
A card is advertised when the driver lists it and its device node exists:

- ``/dev/nvidia[0-9]+`` are the cards' nodes (``nvidiactl``,
  ``nvidia-uvm`` and the rest are shared control nodes, not cards);
- ``/proc/driver/nvidia/gpus/<pci>/information`` is the driver's list:
  ``Device Minor`` ties a card to its ``/dev/nvidiaN``, ``GPU UUID`` is
  what the NVIDIA container runtime reads from ``NVIDIA_VISIBLE_DEVICES``;
- ``/sys/bus/pci/devices/<pci>/{vendor,device,numa_node}`` give the
  card's PCI identity (vendor ``0x10de``) and its NUMA node.

Where the driver is loaded (``/proc/driver/nvidia`` exists) but lists no
cards there, as in a sandboxed container runtime that shows every card's
device node but lets the container open only its own, the list comes
from NVML through the native probe library (``plugin/native.py``).

A device node's minor number is not CUDA's ordinal, so a card carries its
PCI address and UUID; its kubelet ID is ``gpu-<minor>``.  Slice metadata
for multi-host jobs (this host's worker id and every worker's hostname)
comes from the ``run/gpu`` drop-in files the node bootstrap writes, else
from ``GPU_WORKER_ID`` / ``GPU_WORKER_HOSTNAMES``.

Every path is resolved under an injectable ``root`` (the reference's test
seam), so tests run against a fixture tree instead of the real ``/``.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from dataclasses import dataclass
from typing import Mapping

from . import native

log = logging.getLogger(__name__)

NVIDIA_VENDOR_ID = "0x10de"

# Node-metadata drop-in directory (under the injectable root).
GPU_METADATA_DIR = "run/gpu"
PROC_DRIVER_DIR = "proc/driver/nvidia"
PROC_GPUS_DIR = PROC_DRIVER_DIR + "/gpus"

_NVIDIA_DEV_RE = re.compile(r"nvidia(\d+)$")


@dataclass(frozen=True)
class GpuCard:
    """One discovered card (one /dev/nvidiaN node)."""

    index: int  # the device node's minor: the N in /dev/nvidiaN
    device_path: str  # host devfs path, e.g. "/dev/nvidia0"
    uuid: str = ""  # "GPU-..." as the driver reports it
    pci_address: str | None = None  # "0000:18:00.0"
    vendor_id: str | None = None
    device_id: str | None = None
    numa_node: int | None = None
    model: str | None = None

    @property
    def k8s_id(self) -> str:
        """Stable device ID advertised to the kubelet."""
        return f"gpu-{self.index}"


@dataclass(frozen=True)
class GpuHostInventory:
    """Everything discovery learned about this host's cards."""

    cards: tuple[GpuCard, ...]
    worker_id: int  # index of this host within its multi-host job
    worker_hostnames: tuple[str, ...]  # all hosts of the job, worker order
    source: str  # where the card list came from: "proc", "nvml" or "none"

    @property
    def card_count(self) -> int:
        return len(self.cards)

    def card_by_k8s_id(self, k8s_id: str) -> GpuCard:
        for card in self.cards:
            if card.k8s_id == k8s_id:
                return card
        raise KeyError(k8s_id)


def pci_address(text: str) -> str:
    """A PCI address in sysfs's form (``0000:18:00.0``, lowercase):
    NVML and nvidia-smi print an 8-digit domain (``00000000:18:00.0``)."""
    domain, _, rest = text.strip().lower().rpartition(":")
    domain, _, bus = domain.rpartition(":")
    return f"{int(domain or '0', 16):04x}:{bus}:{rest}"


def _read_text(path: str) -> str | None:
    try:
        with open(path, "r") as f:
            return f.read().strip()
    except OSError:
        return None


def _read_int(path: str) -> int | None:
    text = _read_text(path)
    if text is None:
        return None
    try:
        return int(text, 0)
    except ValueError:
        return None


def _information(path: str) -> dict[str, str]:
    """``Key: value`` lines of a driver information file."""
    out = {}
    for line in (_read_text(path) or "").splitlines():
        key, sep, value = line.partition(":")
        if sep:
            out[key.strip()] = value.strip()
    return out


def _proc_cards(root: str) -> list[dict] | None:
    """The driver's cards from /proc/driver/nvidia/gpus, or None where the
    directory is absent."""
    gpus = os.path.join(root, PROC_GPUS_DIR)
    if not os.path.isdir(gpus):
        return None
    cards = []
    for entry in sorted(os.listdir(gpus)):
        info = _information(os.path.join(gpus, entry, "information"))
        try:
            minor = int(info["Device Minor"])
        except (KeyError, ValueError):
            minor = None
        if minor is None or not info.get("GPU UUID"):
            # Allocate names a card to the container runtime by its UUID.
            log.warning("%s/%s/information names no device minor or UUID; skipping",
                        PROC_GPUS_DIR, entry)
            continue
        cards.append({
            "minor": minor,
            "uuid": info["GPU UUID"],
            "bus_id": info.get("Bus Location") or entry,
            "model": info.get("Model") or None,
        })
    return cards


def _driver_cards(root: str, prober) -> tuple[list[dict], str]:
    """The driver's card list and where it came from."""
    cards = _proc_cards(root)
    if cards is not None:
        return cards, "proc"
    if os.path.isdir(os.path.join(root, PROC_DRIVER_DIR)) and prober is not None:
        cards = prober.nvml_devices()
        if cards is not None:
            return cards, "nvml"
    return [], "none"


def _metadata(root: str, name: str, environ: Mapping[str, str], env_key: str) -> str | None:
    """Node metadata: the run/gpu drop-in file is authoritative; the env var
    is the fallback (a daemon inherits ambient env, so node-level files
    win over whatever leaked into the pod environment)."""
    value = _read_text(os.path.join(root, GPU_METADATA_DIR, name))
    if value:
        return value
    return environ.get(env_key) or None


def device_minors(root: str, prober=None) -> set[int]:
    """Minors of the /dev/nvidiaN nodes under ``root``: one readdir in C
    with the native prober, glob and a regex without."""
    dev = os.path.join(root, "dev")
    scanned = prober.scan_nvidia_minors(dev) if prober is not None else None
    if scanned is not None:
        return set(scanned)
    minors = set()
    for path in glob.glob(os.path.join(dev, "nvidia[0-9]*")):
        m = _NVIDIA_DEV_RE.search(os.path.basename(path))
        if m:
            minors.add(int(m.group(1)))
    return minors


def discover(root: str = "/", environ: Mapping[str, str] | None = None,
             prober="auto") -> GpuHostInventory:
    """Enumerate this host's NVIDIA cards and job metadata.

    ``root`` redirects every devfs/procfs/sysfs/metadata read (the test
    seam); ``environ`` defaults to ``os.environ``; ``prober`` is the native
    probe library ("auto": the process-wide one, None: the Python paths).
    """
    environ = os.environ if environ is None else environ
    prober = native.shared_prober() if prober == "auto" else prober

    minors = device_minors(root, prober)
    listed, source = _driver_cards(root, prober)
    by_minor = {c["minor"]: c for c in listed}
    for missing in sorted(by_minor.keys() - minors):
        log.warning("the driver lists card minor %d but /dev/nvidia%d is absent; "
                    "not advertising it", missing, missing)
    for unlisted in sorted(minors - by_minor.keys()):
        # Normal where a sandboxed runtime shows other containers' nodes:
        # kept out of the per-pulse INFO log.
        log.debug("/dev/nvidia%d is not among the driver's cards; not advertising it",
                  unlisted)

    cards = []
    for minor in sorted(minors & by_minor.keys()):
        listed_card = by_minor[minor]
        address = pci_address(listed_card["bus_id"]) if listed_card.get("bus_id") else None
        sys_dir = os.path.join(root, "sys/bus/pci/devices", address or "")
        vendor = _read_text(os.path.join(sys_dir, "vendor")) if address else None
        vendor = vendor or listed_card.get("vendor_id")
        if vendor is not None and vendor.lower() != NVIDIA_VENDOR_ID:
            log.warning("nvidia%d at %s has non-NVIDIA vendor id %s; skipping",
                        minor, address, vendor)
            continue
        cards.append(GpuCard(
            index=minor,
            # The advertised path is the real devfs path; only reads go
            # through `root`.
            device_path=f"/dev/nvidia{minor}",
            uuid=listed_card["uuid"],
            pci_address=address,
            vendor_id=vendor,
            device_id=(_read_text(os.path.join(sys_dir, "device")) if address else None)
            or listed_card.get("device_id"),
            numa_node=_read_int(os.path.join(sys_dir, "numa_node")) if address else None,
            model=listed_card.get("model"),
        ))

    worker_id_text = _metadata(root, "worker-id", environ, "GPU_WORKER_ID")
    try:
        worker_id = int(worker_id_text) if worker_id_text else 0
    except ValueError:
        worker_id = 0
    hostnames_text = _metadata(root, "worker-hostnames", environ, "GPU_WORKER_HOSTNAMES")
    worker_hostnames = (tuple(h.strip() for h in hostnames_text.split(",") if h.strip())
                        if hostnames_text else ())

    inventory = GpuHostInventory(cards=tuple(cards), worker_id=worker_id,
                                 worker_hostnames=worker_hostnames, source=source)
    log.info("discovered %d NVIDIA card(s) from %s, worker %d/%d", inventory.card_count,
             source, worker_id, max(len(worker_hostnames), 1))
    return inventory
