"""Flax parameter tree <-> the port's state dict.

The port keeps flax's path names and layouts (``layer_0/attn/query/kernel``
becomes ``layer_0.attn.query.kernel``, still [hidden, heads, head_dim];
``attn/out`` stays [heads, head_dim, hidden] and ``lm_head`` [hidden,
vocab]), so a converted tree loads with ``TransformerLM.load_state_dict``
and nothing is transposed.  Leaves arrive as numpy arrays (``np.asarray``
of a JAX array works), so this module needs no JAX.  Float leaves become
float32; integer leaves keep their type, so a quantized tree
(``kernel_q`` int8 beside ``kernel_scale`` float32, the names
``ops/quant.py`` ``quantize_lm_params`` gives) loads as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaf(value) -> np.ndarray:
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.integer):
        return np.array(arr)
    return np.array(arr, dtype=np.float32)


def flax_to_state_dict(params: Mapping) -> dict:
    """Flatten a nested ``{"layer_0": {"attn": {"query": {"kernel": ...}}}}``
    tree into ``{"layer_0.attn.query.kernel": tensor}`` on the CPU (float
    leaves as float32, integer leaves in their own type)."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, name)
            else:
                out[name] = torch.from_numpy(_leaf(value))

    walk(params, "")
    return out


def state_dict_to_flax(state: Mapping) -> dict:
    """The inverse of :func:`flax_to_state_dict`: nest
    ``{"layer_0.attn.query.kernel": tensor}`` back into flax's tree, with
    float32 numpy leaves for float tensors and integer leaves in their own
    type (so a trained port model compares with a JAX train state by flax
    path, and a quantized tree round-trips)."""
    tree: dict = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        value = value.detach().to("cpu")
        node[leaf] = (value.float() if value.is_floating_point() else value).numpy()
    return tree



def save_flax_params(directory, params: Mapping, step: int = 0) -> None:
    """Write a flax parameter tree (numpy leaves, ``np.asarray`` of JAX
    arrays) as step ``step`` of a port checkpoint directory
    (``models/checkpoint.py``): what ``--checkpoint-dir`` and ``--adapters``
    of the port's server read."""
    from .models.checkpoint import CheckpointManager

    CheckpointManager(directory).save(flax_to_state_dict(params), step)
