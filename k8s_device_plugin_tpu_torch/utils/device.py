"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``cuda``, and without a
card they raise rather than carry on on the CPU.  ``device="cpu"`` is an
explicit request (the CPU tests make it); kernel wrappers then take their
plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, local_rank: int | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as asked, and a CUDA request without a card raises too.  With
    ``local_rank`` (one process per card, ``models/benchmark.py``'s ranks) a
    CUDA request means card ``local_rank`` of the visible ones, modulo their
    count, so ranks can share a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and local_rank is not None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def fp32_reference_precision() -> None:
    """Keep float32 products at full precision on the card: TF32 keeps
    about three decimal digits, and every float32 comparison against a
    reference (the TPU ran f32 at Precision.HIGHEST) assumes full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
