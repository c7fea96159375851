"""Synthetic training batches, made on the device (the reference's
``models/data.py``): the numbers measure the card, not a loader.  Each is
drawn from ``generator`` on its own device, then moved to ``device``
(default: the generator's).  The draws are torch's, not jax's: a test that
needs the reference's batch makes it with numpy and hands it to both."""

from __future__ import annotations

import torch


def _on(t: torch.Tensor, generator: torch.Generator, device) -> torch.Tensor:
    return t.to(generator.device if device is None else device)


def synthetic_image_batch(batch: int, image_size: int = 224, num_classes: int = 1000, *,
                          generator: torch.Generator, device=None) -> dict:
    """NHWC float32 normal images [batch, size, size, 3] and integer labels."""
    images = torch.randn((batch, image_size, image_size, 3), generator=generator,
                         device=generator.device)
    labels = torch.randint(0, num_classes, (batch,), generator=generator, device=generator.device)
    return {"images": _on(images, generator, device), "labels": _on(labels, generator, device)}


def synthetic_token_batch(batch: int, seq: int = 128, vocab: int = 30522, *,
                          generator: torch.Generator, device=None) -> dict:
    """Token ids and independent per-token labels, both [batch, seq]."""
    shape = (batch, seq)
    ids = torch.randint(0, vocab, shape, generator=generator, device=generator.device)
    labels = torch.randint(0, vocab, shape, generator=generator, device=generator.device)
    return {"input_ids": _on(ids, generator, device), "labels": _on(labels, generator, device)}


def synthetic_lm_batch(batch: int, seq: int, vocab: int, *, generator: torch.Generator,
                       device=None) -> dict:
    """Causal-LM batch: labels are the inputs shifted by one position."""
    ids = torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                        device=generator.device)
    ids = _on(ids, generator, device)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
