"""Environment injected into a container by Allocate.

Counterpart of the JAX package's ``plugin/envs.py`` (``allocation_envs``:
``TPU_VISIBLE_CHIPS``, the mesh bounds and the worker envs).  For NVIDIA
cards:

- ``NVIDIA_VISIBLE_DEVICES``: the granted cards' UUIDs, which the NVIDIA
  container runtime reads to mount their device nodes and driver
  libraries into the container (CUDA then numbers them from 0);
- ``GPU_DEVICE_MINORS``: the granted ``/dev/nvidiaN`` minors, host-local
  indices in the order of the UUIDs, which the port's own readers use
  (``models/engine_watchdog.visible_chip_paths`` watches those nodes,
  ``parallel/mesh.allocated_chip_indices`` counts them);
- ``GPU_WORKER_ID`` and, for a host of a multi-host job,
  ``GPU_WORKER_HOSTNAMES``: what ``parallel/distributed.py`` derives the
  process group from.

No bounds are injected: NVSwitch joins every card to every other, so a
mesh over the granted cards needs no order.
"""

from __future__ import annotations

from .discovery import GpuCard, GpuHostInventory

VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
DEVICE_MINORS = "GPU_DEVICE_MINORS"
WORKER_ID = "GPU_WORKER_ID"
WORKER_HOSTNAMES = "GPU_WORKER_HOSTNAMES"


def allocation_envs(inventory: GpuHostInventory, cards: list[GpuCard]) -> dict[str, str]:
    """Environment for one container granted ``cards``."""
    cards = sorted(cards, key=lambda c: c.index)
    envs = {
        VISIBLE_DEVICES: ",".join(c.uuid for c in cards),
        DEVICE_MINORS: ",".join(str(c.index) for c in cards),
    }
    if len(cards) == inventory.card_count and inventory.card_count > 0:
        # The whole host: if it is one host of a multi-host job, the worker
        # coordinates the process group needs across hosts.
        envs[WORKER_ID] = str(inventory.worker_id)
        if inventory.worker_hostnames:
            envs[WORKER_HOSTNAMES] = ",".join(inventory.worker_hostnames)
    else:
        # Part of a host is a job of its own: always worker 0 of one host.
        envs[WORKER_ID] = "0"
    return envs


def allocation_annotations(cards: list[GpuCard]) -> dict[str, str]:
    """Debugging/observability annotations mirrored onto the container."""
    cards = sorted(cards, key=lambda c: c.index)
    return {
        "gpu.nvidia.com/devices": ",".join(c.k8s_id for c in cards),
        "gpu.nvidia.com/pci-addresses": ",".join(c.pci_address or "?" for c in cards),
    }
