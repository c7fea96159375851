"""Flax trees <-> the port's state dicts and train states.

The port keeps flax's path names and layouts (``layer_0/attn/query/kernel``
becomes ``layer_0.attn.query.kernel``, still [hidden, heads, head_dim];
``attn/out`` stays [heads, head_dim, hidden] and ``lm_head`` [hidden,
vocab]), so a converted tree loads with ``load_state_dict``.  One layout
differs: a conv kernel (a 4-D leaf named ``kernel``) is flax's [kh, kw, in,
out] and torch's [out, in, kh, kw] in the port, and is transposed both
ways.  Leaves arrive as numpy arrays (``np.asarray`` of a JAX array works),
so this module needs no JAX.  Float leaves become float32; integer leaves
keep their type, so a quantized tree (``kernel_q`` int8 beside
``kernel_scale`` float32, the names ``ops/quant.py`` ``quantize_lm_params``
gives) loads as it is.

A training state crosses whole (:func:`load_flax_train_state`,
:func:`train_state_to_flax`): flax's ``params``, its ``batch_stats``
(BatchNorm's ``mean``/``var``, the port's buffers of those names) and
optax's SGD momentum ``trace`` (``opt_state[0].trace`` of ``optax.sgd(lr,
momentum)``), which lands in ``torch.optim.SGD``'s
``state[p]["momentum_buffer"]``; without it SGD would restart the trace
from the gradient.

A ``PipelinedLM`` tree (``parallel/pipeline_lm.py``) maps to the unsharded
LM's names, stage ``s``'s ``block_i`` to ``layer_{s*k+i}``
(:func:`pipelined_flax_to_state_dict`), and back from the ranks' states
(:func:`pipelined_state_dicts_to_flax`).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _leaf(value) -> np.ndarray:
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.integer):
        return np.array(arr)
    return np.array(arr, dtype=np.float32)


def _is_conv_kernel(name: str, ndim: int) -> bool:
    return ndim == 4 and name.rsplit(".", 1)[-1] == "kernel"


def flax_to_state_dict(params: Mapping) -> dict:
    """Flatten a nested ``{"layer_0": {"attn": {"query": {"kernel": ...}}}}``
    tree into ``{"layer_0.attn.query.kernel": tensor}`` on the CPU (float
    leaves as float32, integer leaves in their own type, conv kernels to
    [out, in, kh, kw])."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, name)
            else:
                leaf = _leaf(value)
                if _is_conv_kernel(name, leaf.ndim):
                    leaf = np.ascontiguousarray(leaf.transpose(3, 2, 0, 1))
                out[name] = torch.from_numpy(leaf)

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
        if _is_conv_kernel(name, value.dim()):
            value = value.permute(2, 3, 1, 0)
        node[leaf] = np.ascontiguousarray(
            (value.float() if value.is_floating_point() else value).numpy())
    return tree


def _stage_of(name: str, n_stages: int, layers_per_stage: int) -> int:
    """The pipeline stage that holds LM parameter ``name``: the embedding
    the first, the final norm and head the last, ``layer_j`` stage ``j //
    layers_per_stage``."""
    top = name.split(".", 1)[0]
    if top == "embed":
        return 0
    if top.startswith("layer_"):
        return int(top[len("layer_"):]) // layers_per_stage
    return n_stages - 1


def pipelined_flax_to_state_dict(params: Mapping, stage: Optional[int] = None) -> dict:
    """A ``PipelinedLM`` parameter tree (numpy leaves: ``embed``, ``stages``
    with a leading stage dimension, ``head``) in ``TransformerLM``'s state
    dict names: stage ``s``'s ``block_i`` becomes ``layer_{s*k+i}`` (``k``
    blocks a stage), so the same weights load into the unsharded LM.  With
    ``stage``, only what that stage's rank holds
    (``parallel/pipeline_lm.PipelinedLM``)."""
    blocks = params["stages"]
    k = len(blocks)
    n_stages = len(np.asarray(blocks["block_0"]["attn_norm"]["scale"]))
    tree = {"embed": params["embed"]["embed"], **params["head"]}
    for s in range(n_stages):
        for i in range(k):
            tree[f"layer_{s * k + i}"] = _map(lambda a: np.asarray(a)[s], blocks[f"block_{i}"])
    flat = flax_to_state_dict(tree)
    if stage is None:
        return flat
    return {name: v for name, v in flat.items() if _stage_of(name, n_stages, k) == stage}


def pipelined_state_dicts_to_flax(states: list) -> dict:
    """The inverse of :func:`pipelined_flax_to_state_dict`: every rank's
    state dict, in stage order, gathered into the reference's
    ``PipelinedLM`` tree of float32 numpy leaves (``len(states)`` stages)."""
    merged = {}
    for state in states:
        merged.update(state)
    tree = state_dict_to_flax(merged)
    n_stages = len(states)
    layers = sum(key.startswith("layer_") for key in tree)
    k = layers // n_stages
    stages = {f"block_{i}": _map(lambda *a: np.stack(a),
                                 *[tree[f"layer_{s * k + i}"] for s in range(n_stages)])
              for i in range(k)}
    return {"embed": {"embed": tree["embed"]}, "stages": stages,
            "head": {"final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}}


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], Mapping):
        return {key: _map(fn, *(t[key] for t in trees)) for key in trees[0]}
    return fn(*trees)


def load_flax_train_state(state, params: Mapping, batch_stats: Optional[Mapping] = None,
                          trace: Optional[Mapping] = None, step: int = 0):
    """Load a flax train state into a port ``TrainState`` (``models/train.py``)
    in place and return it: ``params`` and ``batch_stats`` into the model
    (every parameter and buffer must be named), ``trace`` (optax's SGD
    momentum, the tree of ``params``' shape) into the optimizer's momentum
    buffers, and the step counter."""
    model = state.model
    tensors = flax_to_state_dict(params)
    tensors.update(flax_to_state_dict(batch_stats or {}))
    model.load_state_dict(tensors)
    if trace is not None:
        momentum = flax_to_state_dict(trace)
        for name, p in model.named_parameters():
            state.optimizer.state[p]["momentum_buffer"] = (
                momentum[name].to(device=p.device, dtype=p.dtype).clone())
    state.step = int(step)
    return state


def train_state_to_flax(state) -> dict:
    """A port ``TrainState`` as flax trees of float32 numpy leaves:
    ``{"params", "batch_stats", "trace", "step"}`` (``trace`` zero where the
    optimizer has taken no step, as optax's starts)."""
    model = state.model
    params = {name: p for name, p in model.named_parameters()}
    trace = {}
    for name, p in params.items():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        trace[name] = torch.zeros_like(p) if buf is None else buf
    return {
        "params": state_dict_to_flax(params),
        "batch_stats": state_dict_to_flax(dict(model.named_buffers())),
        "trace": state_dict_to_flax(trace),
        "step": int(state.step),
    }


def save_flax_params(directory, params: Mapping, step: int = 0) -> None:
    """Write a flax parameter tree (numpy leaves, ``np.asarray`` of JAX
    arrays) as step ``step`` of a port checkpoint directory
    (``models/checkpoint.py``): what ``--checkpoint-dir`` and ``--adapters``
    of the port's server read."""
    from .models.checkpoint import CheckpointManager

    CheckpointManager(directory).save(flax_to_state_dict(params), step)
