"""Sequence-parallel LM training: the ring and Ulysses engines wired into
the decoder LM.

Counterpart of the reference's ``parallel/sequence.py``.  The reference
shards the batch over ``dp`` and the sequence over ``sp`` under GSPMD,
and only attention communicates, through the ``attention_fn`` hook of
``models/transformer.TransformerLM``.  Here each rank is one process over
a ``DeviceMesh`` of ``dp``, ``sp`` and optionally ``tp``: it takes its
rows over ``dp`` and its columns of the sequence over ``sp``
(:func:`sp_batch_sharding`), runs every positionwise op on them, and
attends through :func:`sp_attention_fn`'s engine over its ``sp`` group
(the ranks that share its ``dp`` and ``tp`` coordinates).  The engine
also tells the model where the rank's slice of the sequence starts, so
RoPE rotates at global positions.

Gradients (:func:`shard_train_step_sp`): every rank's loss is the mean over
an equal share of the global batch's tokens, and the engines' collectives
carry each loss's cotangent back to the rank that owns the activations, so
the sum of the ranks' gradients over ``dp x sp`` divided by ``dp x sp`` is
the gradient of the global mean.  ``tp`` composes as in
``tensor.shard_train_step_tp``: parameters are cut by the tp rules and
replicated over ``dp`` and ``sp``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .ring import ring_attention
from .sharding import shard_batch
from .tensor import TensorParallel, shard_lm_step
from .ulysses import ulysses_attention

_ENGINES = {
    "ulysses": ulysses_attention,
    "ring": ring_attention,
}


class SequenceParallelAttention:
    """The ``attention_fn`` :func:`sp_attention_fn` returns: exact causal
    attention over the sequence split on ``sp``'s group, by ``kind``.

    Both engines consume grouped-query k/v natively (``supports_gqa``: the
    model passes kv unexpanded).  ``seq_offset(local_seq)``: where this
    rank's slice of the sequence starts, its group rank x ``local_seq``."""

    supports_gqa = True

    def __init__(self, kind: str, sp: TensorParallel):
        self.engine, self.sp = _ENGINES[kind], sp

    def __call__(self, q, k, v, causal: bool = False):
        return self.engine(q, k, v, self.sp, causal=causal)

    def seq_offset(self, local_seq: int) -> int:
        return self.sp.rank * local_seq


def sp_attention_fn(mesh, axis: str = "sp", kind: str = "ulysses") -> SequenceParallelAttention:
    """Attention for ``TransformerLM(attention_fn=...)`` over ``mesh``'s
    ``axis`` group of this rank (``DeviceMesh.get_group``: the group of
    every rank's coordinates but ``axis``, made on every rank in the same
    order when the mesh was built).

    kind="ulysses": one all-to-all a tensor; heads a rank holds must divide
    by sp; wins when heads are plentiful.  kind="ring": kv shards rotate
    round the ring, any head count; wins for very long sequences or
    head-poor models.  Both are exact."""
    if kind not in _ENGINES:
        raise ValueError(f"unknown sp attention kind {kind!r}; use {sorted(_ENGINES)}")
    return SequenceParallelAttention(kind, TensorParallel.from_mesh(mesh, axis))


def sequence_columns(seq: int, index: int, size: int, axis: str = "sp") -> slice:
    """The columns of a ``seq``-long sequence that rank ``index`` of
    ``size`` holds."""
    if seq % size:
        raise ValueError(f"seq {seq} not divisible by {axis}={size}")
    per = seq // size
    return slice(index * per, (index + 1) * per)


def sp_batch_sharding(batch: Mapping[str, torch.Tensor], mesh, dp_axis: str = "dp",
                      sp_axis: str = "sp") -> dict:
    """This rank's part of a global [batch, seq] token batch in the
    reference's layout ``P(dp, sp)``: its rows over ``dp``
    (``sharding.shard_batch``), then its columns over ``sp``."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    coords = dict(zip(names, mesh.get_coordinate()))
    rows = shard_batch(batch, coords[dp_axis], sizes[dp_axis])
    return {k: v[:, sequence_columns(v.shape[1], coords[sp_axis], sizes[sp_axis], sp_axis)]
            for k, v in rows.items()}


def shard_train_step_sp(train_step, mesh, state, dp_axis: str = "dp", sp_axis: str = "sp",
                        tp_axis: str = "tp"):
    """Shard a fresh LM train state over ``mesh`` (a ``DeviceMesh`` over
    every rank: ``dp``, then ``sp``, then optionally ``tp``:
    ``distributed.make_slice_mesh``) and wrap its step: the reference's
    dp x sp (x tp) step.

    The model must have been built with ``attention_fn=sp_attention_fn(mesh,
    sp_axis, ...)``: without it each rank would attend within its own slice
    of the sequence.  It is rebuilt at this rank's tp widths
    (``tensor.shard_lm_step``, which keeps the hook), and each update first
    averages the gradients over the ``dp x sp`` ranks of this rank's tp
    coordinate.  Returns ``(step, sharded_state)``; ``step(state, batch)``
    takes this rank's part of the batch (:func:`sp_batch_sharding`) and
    returns the global batch's mean loss."""
    dist = torch.distributed
    names = tuple(mesh.mesh_dim_names)
    if names[:2] != (dp_axis, sp_axis) or names[2:] not in ((), (tp_axis,)):
        raise ValueError(f"the mesh's axes must be ({dp_axis!r}, {sp_axis!r}) or "
                         f"({dp_axis!r}, {sp_axis!r}, {tp_axis!r}), got {names}")
    if not isinstance(state.model.attention_fn, SequenceParallelAttention):
        raise ValueError("build the model with attention_fn=sp_attention_fn(mesh, ...)")
    sizes = [int(n) for n in mesh.mesh.shape]
    replicas = sizes[0] * sizes[1]
    if len(sizes) == 2:
        group = dist.group.WORLD
    else:
        # The dp x sp ranks of each tp coordinate (new_group runs on every
        # rank, for every coordinate, in the same order).
        groups = [dist.new_group(mesh.mesh[:, :, t].flatten().tolist()) for t in range(sizes[2])]
        group = groups[mesh.get_coordinate()[2]]
    return shard_lm_step(train_step, mesh, state, ep=None, replicas=replicas,
                         replica_group=group, dp_axis=dp_axis, tp_axis=tp_axis)
