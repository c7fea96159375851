"""Explicit sharding contract for the serving engine's state.

Counterpart of the reference's ``parallel/serving.py``.  Each rank of a
tensor-parallel engine is one process holding its own shard, so the
contract is per rank:

- ``params``: ``tensor.shard_state_dict`` (heads/ffn/vocab over ``tp``);
- ``pool_key`` / ``pool_value`` [num_pages, page_size, kv_heads, head_dim]:
  the kv-heads axis over ``tp`` (each rank holds its head group's pages:
  the paged append writes and the attention reads stay rank-local);
- ``pool_key_scale`` / ``pool_value_scale`` [num_pages, page_size,
  kv_heads] (``quant_kv``): the kv-heads axis over ``tp``, with their
  pools;
- the page table, ``seq_lens``, the chain and the step buffers: whole on
  every rank (host-truth indices and small per-slot vectors).

:func:`assert_explicit_sharding` is the coverage lint: every tensor on the
rank's device, and no pool silently holding every kv head.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import torch

# Leaf name -> the dimension that carries kv heads.  Pools are 4-d [pages,
# page_size, kv_heads, head_dim]; scale pools (quant_kv) 3-d [pages,
# page_size, kv_heads].
_POOL_KV_DIM = {
    "pool_key": 2,
    "pool_value": 2,
    "pool_key_scale": 2,
    "pool_value_scale": 2,
}


def kv_heads_dim(path: str) -> Optional[int]:
    """The dimension of the cache leaf ``path`` that carries kv heads (by
    its last name), None for a leaf that is no pool."""
    return _POOL_KV_DIM.get(path.rsplit("/", 1)[-1])


def cache_leaf_spec(path: str, shape, tp: int, tp_axis: str = "tp") -> tuple:
    """The partition spec of one paged-cache leaf by name (a tuple as
    ``tensor.tp_spec_for`` gives, ``()`` whole): pools split their kv-heads
    dimension over ``tp``, everything else (page tables, seq_lens) is
    whole.  A pool whose kv-heads dimension ``tp`` does not divide raises:
    a silently replicated pool is what this contract rules out (the
    engine checks divisibility at construction; this is the backstop)."""
    dim = kv_heads_dim(path)
    if dim is None or tp <= 1:
        return ()
    shape = tuple(int(s) for s in shape)
    if shape[dim] % tp:
        raise ValueError(
            f"cannot shard {path}: kv-heads dim {shape[dim]} is "
            f"not divisible by {tp_axis}={tp}"
        )
    spec = [None] * len(shape)
    spec[dim] = tp_axis
    return tuple(spec)


def leaf_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict/list tree, paths joined by ``/``."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaf_paths(value, f"{prefix}/{key}" if prefix else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from leaf_paths(value, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def assert_explicit_sharding(
    tree: Any,
    device,
    *,
    tp: int,
    kv_heads: int,
    tp_axis: str = "tp",
) -> int:
    """Coverage lint over one rank's engine state ``tree``: every tensor
    leaf must be on ``device``, and every pool (:func:`kv_heads_dim`) must
    hold ``kv_heads / tp`` heads on its kv-heads dimension when ``tp`` > 1.
    Raises AssertionError naming the offending path; returns the number of
    tensor leaves checked."""
    device = torch.device(device)
    checked = 0
    for path, leaf in leaf_paths(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        checked += 1
        if leaf.device.type != device.type or (
                device.index is not None and leaf.device.index != device.index):
            raise AssertionError(
                f"engine state: leaf {path!r} is on {leaf.device}, not on the rank's "
                f"device {device}: every state leaf must be placed explicitly"
            )
        dim = kv_heads_dim(path)
        if tp <= 1 or dim is None or not leaf.numel():
            continue
        heads = leaf.shape[dim]
        if heads == kv_heads:
            raise AssertionError(
                f"engine state: leaf {path!r} ({tuple(leaf.shape)}, "
                f"{leaf.numel() * leaf.element_size()} bytes) is silently REPLICATED across "
                f"{tp_axis}={tp}: KV pools must shard their kv-heads axis "
                "(parallel/serving.cache_leaf_spec)"
            )
        if heads * tp != kv_heads:
            raise AssertionError(
                f"engine state: leaf {path!r} holds {heads} kv heads, not {kv_heads} / "
                f"{tp_axis}={tp}"
            )
    return checked
