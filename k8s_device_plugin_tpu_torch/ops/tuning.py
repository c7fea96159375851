"""Per-card tuning table for the split-K paged-decode kernel.

The kernel (ops/paged_attention.py, csrc/paged_attention.cu) has one free
parameter: how many blocks share one sequence's page list.  On Hopper the
blocks run in parallel on 132 SMs, so splitting is how a small decode batch
(batch x kv_heads blocks) fills the card; each split costs one partial
triple and a term of the combine.

Rows are keyed by a prefix of ``torch.cuda.get_device_name()``.  No TPU row
is carried over: the TPU's split counts answered a question about
sequential grid steps and VMEM that a GPU does not ask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class DecodeRow:
    """One card's split-K decode tuning row."""

    generation: str
    min_pages_per_split: int
    max_splits: int
    source: str


DECODE_ROWS: tuple[DecodeRow, ...] = (
    # PROVISIONAL: batch 8 x 4 kv heads x 8 splits = 256 blocks covers the
    # 132 SMs about twice.  decode_profile's sweep (1..16 splits) found 8
    # best at that one shape only; other batches and lengths are unswept.
    DecodeRow("NVIDIA H100", 4, 8, "provisional: swept at B8 Hk4 lens 129..241 only (PERF.md)"),
)

# CPU: the plain version gains nothing from splitting; 1 split skips the
# combine.
CPU_ROW = DecodeRow("cpu", 1 << 30, 1, "plain version: no parallel blocks")

# A card with no row: a modest split count so the kernel still fills part
# of the card while the missing row is the visible gap.
FALLBACK_ROW = DecodeRow("unknown-gpu", 8, 2, "no row for this card")


def device_generation(device=None) -> str:
    """The key rows match against: the CUDA device name, or "cpu"."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def decode_row(generation: str) -> tuple[DecodeRow, bool]:
    """The row for ``generation`` and whether it matched exactly (False =
    the fallback row)."""
    if generation == "cpu":
        return CPU_ROW, True
    for row in DECODE_ROWS:
        if generation.startswith(row.generation):
            return row, True
    return FALLBACK_ROW, False


def pick_num_splits(pages_per_seq: int, generation: Optional[str] = None) -> int:
    """Split-K degree for a page table of ``pages_per_seq`` entries: the
    largest power of two within the row's ``max_splits`` that leaves every
    split at least ``min_pages_per_split`` pages.  1 on the CPU row and for
    short tables."""
    if pages_per_seq < 1:
        raise ValueError(f"pages_per_seq must be >= 1, got {pages_per_seq}")
    row, _ = decode_row("cpu" if generation is None else generation)
    splits = 1
    while (
        splits * 2 <= row.max_splits
        and pages_per_seq // (splits * 2) >= row.min_pages_per_split
    ):
        splits *= 2
    return min(splits, pages_per_seq)
