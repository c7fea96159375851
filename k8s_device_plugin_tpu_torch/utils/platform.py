"""Peak bf16 rate of the card, for MFU (the reference's ``utils/platform.py``).

The reference keys its table by TPU generation; here it is keyed by the
CUDA device's name (``torch.cuda.get_device_name``), first match wins.  The
rates are dense bf16 tensor-core peaks from NVIDIA's H100 data sheet, at the
full power limit: a card set below it runs slower under load, so an MFU
says which card and limit it was measured on.  An unknown card, or the CPU,
gives None and MFU is left out, never guessed.

The reference's other two helpers have no counterpart:
``honor_jax_platforms_env`` overrides JAX's platform pin (the port picks its
device with ``utils/device.resolve_device``), and ``enable_compilation_cache``
persists XLA compilations (the port's kernels are built once per checkout
into ``build/torch_kernels/``, ``ops/_build.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

# (name substring, dense bf16 FLOP/s).  The SXM part reports itself as
# "NVIDIA H100 80GB HBM3"; other H100 parts (NVL, ...) are not listed and
# give None.
PEAK_BF16_FLOPS_BY_NAME: tuple[tuple[str, float], ...] = (
    ("H100 80GB HBM3", 989e12),
    ("H100 PCIe", 756e12),
)


def peak_bf16_flops(device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a torch device, or None if unknown."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in PEAK_BF16_FLOPS_BY_NAME:
        if sub in name:
            return peak
    return None
