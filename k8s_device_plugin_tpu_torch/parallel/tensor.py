"""Megatron-style tensor parallelism over one process per card.

Counterpart of the reference's ``parallel/tensor.py``.  The reference
annotates parameters with ``NamedSharding`` specs over a ``tp`` mesh axis
and lets XLA insert the collectives.  Here each rank is one process: it
holds its own shard of every parameter the path rules split, and the
model runs the collectives itself (:class:`TensorParallel`):

- attention query/key/value kernels [hidden, heads, head_dim] -> heads
  over tp (column-parallel: each rank owns a head group);
- attention out kernel [heads, head_dim, hidden] -> heads over tp
  (row-parallel: the partial outputs are all-reduced);
- MLP gate/up kernels [hidden, ffn] -> ffn over tp (column-parallel);
- MLP down kernel [ffn, hidden] -> ffn over tp (row-parallel, all-reduced);
- token embedding [vocab, hidden] -> vocab over tp (a masked lookup, then
  an all-reduce: exact, one non-zero row summed with zeros);
- lm_head kernel [hidden, vocab] -> vocab over tp (the float32 logits are
  all-gathered to the full vocabulary);
- norms replicated.

The rules keep the reference's names, order and fall-throughs, written on
the port's state-dict names (``layer_0.attn.query.kernel`` for flax's
``layer_0/attn/query/kernel``).  The reference's ``shard_train_step_tp``
(the MoE dp x ep x tp step) comes with the MoE module (``ROADMAP.md``
queue 1 item 5).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Mapping, Optional

import torch

# (name regex, spec builder) — first match wins.  A spec is a tuple with one
# entry per dimension: the mesh axis that dimension is split over, or None.
# MoE expert kernels first: their names would otherwise suffix-match the
# dense gate/up/down rules below.
_TP_RULES = (
    (r"(^|\.)experts_(gate|up)$", lambda tp: ("ep", None, tp)),
    (r"(^|\.)experts_down$", lambda tp: ("ep", tp, None)),
    (r"(^|\.)(query|key|value)\.kernel$", lambda tp: (None, tp, None)),
    (r"(^|\.)out\.kernel$", lambda tp: (tp, None, None)),
    (r"(^|\.)(gate|up)\.kernel$", lambda tp: (None, tp)),
    (r"(^|\.)down\.kernel$", lambda tp: (tp, None)),
    (r"(^|\.)embed\.embedding$", lambda tp: (tp, None)),
    (r"(^|\.)lm_head\.kernel$", lambda tp: (None, tp)),
)


def tp_spec_for(name: str, shape, axis_sizes: Mapping[str, int], tp_axis: str = "tp") -> tuple:
    """The partition spec of one parameter, by name rule: a tuple with the
    mesh axis each dimension is split over (None: whole), ``()`` for a
    replicated parameter, as the reference's ``PartitionSpec``.

    ``axis_sizes`` maps mesh axis name -> size.  Replicated when no rule
    matches, when the rule names an axis the mesh lacks (expert kernels on
    a tp-only mesh), or when a named dimension is not divisible by its
    axis size (tiny configs on big meshes)."""
    shape = tuple(int(s) for s in shape)
    for pattern, build in _TP_RULES:
        if re.search(pattern, name):
            spec = build(tp_axis)
            for dim, axis in enumerate(spec):
                if axis is None:
                    continue
                if axis not in axis_sizes:
                    return ()
                if dim >= len(shape) or shape[dim] % axis_sizes[axis]:
                    return ()
            return spec
    return ()


def tp_dim(spec: tuple, tp_axis: str = "tp") -> Optional[int]:
    """The dimension ``spec`` splits over ``tp_axis``, or None."""
    return spec.index(tp_axis) if tp_axis in spec else None


def shard_state_dict(params: Mapping[str, torch.Tensor], tp: int, rank: int,
                     tp_axis: str = "tp") -> dict:
    """Rank ``rank``'s shard of a full state dict at degree ``tp`` (the
    reference's ``tp_param_sharding`` plus ``device_put``): each parameter
    the rules split, cut to its ``rank``-th equal chunk on that dimension;
    every other one whole."""
    out = {}
    for name, value in params.items():
        dim = tp_dim(tp_spec_for(name, value.shape, {tp_axis: tp}, tp_axis), tp_axis)
        out[name] = value if dim is None else value.chunk(tp, dim=dim)[rank].contiguous()
    return out


def lm_layout(cfg, tp: int, tp_axis: str = "tp") -> dict:
    """Which parts of a decoder LM ``cfg`` the rules split at degree ``tp``:
    ``attn`` (query/key/value/out), ``mlp`` (gate/up/down) and ``vocab``
    (embed, lm_head).  Raises when the query heads split and the kv heads
    do not: a rank's query head group would need kv heads of others."""
    sizes = {tp_axis: tp}
    d, hd = cfg.hidden_size, cfg.head_dim

    def split(name, shape):
        return tp_dim(tp_spec_for(name, shape, sizes, tp_axis), tp_axis) is not None

    query = split("attn.query.kernel", (d, cfg.num_heads, hd))
    key = split("attn.key.kernel", (d, cfg.kv_heads, hd))
    if query != key:
        raise ValueError(f"{tp_axis}={tp} splits the {cfg.num_heads} query heads but not the "
                         f"{cfg.kv_heads} kv heads: pick a degree dividing both")
    return {
        "attn": query,
        "mlp": split("mlp.gate.kernel", (d, cfg.intermediate_size)),
        "vocab": split("embed.embedding", (cfg.vocab_size, d)),
    }


# c10d's concatenating all-gather (named all_gather_single from PyTorch 2.13).
_all_gather_single = getattr(torch.distributed, "all_gather_single", None) or getattr(
    torch.distributed, "all_gather_into_tensor", None)


class TensorParallel:
    """One rank's view of a ``tp`` group: its size and rank, and the
    collectives the sharded model runs on device tensors (c10d ops on the
    group: NCCL on cards, where a CUDA graph captures them, gloo on the
    CPU or on ranks sharing a card).  A group of one runs the same
    collectives.  ``calls`` counts each kind as it is issued (a graph
    capture counts what its replays run)."""

    def __init__(self, group, *, axis: str = "tp"):
        dist = torch.distributed
        self.group, self.axis = group, axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.src = dist.get_global_rank(group, 0)  # the leader's global rank
        self.calls: Counter = Counter()

    @classmethod
    def from_mesh(cls, mesh, axis: str = "tp") -> "TensorParallel":
        return cls(mesh.get_group(axis), axis=axis)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group, in place, in its own type."""
        self.calls["all_reduce"] += 1
        torch.distributed.all_reduce(x, group=self.group)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined on the last dimension, in rank order."""
        self.calls["all_gather"] += 1
        lead, last = x.shape[:-1], x.shape[-1]
        flat = x.reshape(-1, last).contiguous()
        out = torch.empty((self.size * flat.shape[0], last), dtype=x.dtype, device=x.device)
        _all_gather_single(out, flat, group=self.group)
        out = out.reshape(self.size, flat.shape[0], last).permute(1, 0, 2)
        return out.reshape(*lead, self.size * last)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Overwrite ``x`` with group rank 0's, in place."""
        self.calls["broadcast"] += 1
        torch.distributed.broadcast(x, self.src, group=self.group)
        return x
