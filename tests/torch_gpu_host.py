"""Fixture host trees for the GPU device plugin's tests (no JAX).

:func:`make_fake_gpu_host` lays out what ``plugin/discovery.py`` and
``plugin/health.py`` of ``k8s_device_plugin_tpu_torch`` read on an NVIDIA
node, under a test directory:

- ``dev/nvidiaN`` for each card and the shared ``dev/nvidiactl``,
  ``dev/nvidia-uvm`` and ``dev/nvidia-uvm-tools`` (plain files stand in
  for the character devices);
- ``proc/driver/nvidia/gpus/<pci>/information``, the driver's per-card
  file with ``Model``, ``GPU UUID``, ``Bus Location`` and ``Device Minor``;
- ``sys/bus/pci/devices/<pci>/{vendor,device,numa_node}``;
- the ``run/gpu`` metadata drop-ins for a host of a multi-host job.

The PCI buses descend as the minors rise, so the driver's directory order
is not the minor order and a reader that confuses the two shows it.
"""

from __future__ import annotations

import os


def card_uuid(i: int) -> str:
    return f"GPU-{i:08x}-1111-2222-3333-{0x444400000000 + i:012x}"


def card_pci(i: int, n_cards: int) -> str:
    return f"0000:{0x18 + 0x10 * (n_cards - 1 - i):02x}:00.0"


def make_fake_gpu_host(root, n_cards: int = 4, numa_of=lambda i: i // 2,
                       vendor_id: str = "0x10de", device_id: str = "0x2330",
                       skip_dev_for: tuple = (), control_nodes: bool = True,
                       worker_id: int | None = None,
                       worker_hostnames: str | None = None) -> str:
    """Build a fake NVIDIA host tree under ``root``; returns str(root)."""
    root = str(root)
    dev = os.path.join(root, "dev")
    os.makedirs(dev, exist_ok=True)
    nodes = [f"nvidia{i}" for i in range(n_cards) if i not in skip_dev_for]
    if control_nodes:
        nodes += ["nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"]
    for name in nodes:
        with open(os.path.join(dev, name), "w"):
            pass
    for i in range(n_cards):
        pci = card_pci(i, n_cards)
        info_dir = os.path.join(root, "proc/driver/nvidia/gpus", pci)
        os.makedirs(info_dir, exist_ok=True)
        with open(os.path.join(info_dir, "information"), "w") as f:
            f.write(f"Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t {100 + i}\n"
                    f"GPU UUID: \t {card_uuid(i)}\nVideo BIOS: \t 96.00.99.00.01\n"
                    f"Bus Type: \t PCIe\nDMA Size: \t 52 bits\nDMA Mask: \t 0xfffffffffffff\n"
                    f"Bus Location: \t {pci}\nDevice Minor: \t {i}\nGPU Excluded:\t No\n")
        sys_dir = os.path.join(root, "sys/bus/pci/devices", pci)
        os.makedirs(sys_dir, exist_ok=True)
        for name, value in (("vendor", vendor_id), ("device", device_id),
                            ("numa_node", str(numa_of(i)))):
            with open(os.path.join(sys_dir, name), "w") as f:
                f.write(value + "\n")
    meta = os.path.join(root, "run/gpu")
    os.makedirs(meta, exist_ok=True)
    for name, value in (("worker-id", None if worker_id is None else str(worker_id)),
                        ("worker-hostnames", worker_hostnames)):
        if value is not None:
            with open(os.path.join(meta, name), "w") as f:
                f.write(value + "\n")
    return root
