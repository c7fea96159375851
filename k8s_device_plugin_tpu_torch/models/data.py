"""Synthetic training batches, made on the device (the reference's
``models/data.py``): the numbers measure the card, not a loader."""

from __future__ import annotations

import torch


def synthetic_lm_batch(batch: int, seq: int, vocab: int, *, generator: torch.Generator,
                       device=None) -> dict:
    """Causal-LM batch: labels are the inputs shifted by one position.
    Ids are drawn from ``generator`` on its own device, then moved to
    ``device`` (default: the generator's)."""
    ids = torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                        device=generator.device)
    ids = ids.to(generator.device if device is None else device)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
