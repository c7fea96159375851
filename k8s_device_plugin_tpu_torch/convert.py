"""Flax parameter tree -> the port's state dict.

The port keeps flax's path names and layouts (``layer_0/attn/query/kernel``
becomes ``layer_0.attn.query.kernel``, still [hidden, heads, head_dim];
``attn/out`` stays [heads, head_dim, hidden] and ``lm_head`` [hidden,
vocab]), so a converted tree loads with ``TransformerLM.load_state_dict``
and nothing is transposed.  Leaves arrive as numpy arrays (``np.asarray``
of a JAX array works), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def flax_to_state_dict(params: Mapping) -> dict:
    """Flatten a nested ``{"layer_0": {"attn": {"query": {"kernel": ...}}}}``
    tree into ``{"layer_0.attn.query.kernel": tensor}`` (float32, CPU)."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, name)
            else:
                out[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    walk(params, "")
    return out

