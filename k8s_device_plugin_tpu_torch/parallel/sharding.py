"""Sharding over a (dp, mp) mesh: the reference's GSPMD layout as FSDP2.

Counterpart of the reference's ``parallel/sharding.py``.  The reference
annotates the batch over ``dp`` and large parameters over ``mp`` and lets
XLA insert the collectives.  Here each rank is one process:

- the global batch splits over the ``dp`` replicas (:func:`batch_rows`),
  as the reference's GSPMD splits it over ``dp`` and replicates it over
  ``mp``: the ``mp`` ranks of one replica take the same rows.  Each rank's
  loss is the mean over its rows, and the gradients FSDP averages over the
  world are the mean of the replicas' means, the global batch's;
- parameters follow the reference's per-leaf rule (:func:`shard_dim`):
  ``torch.distributed.fsdp.fully_shard`` over the 2-D mesh replicates over
  ``dp`` and shards over ``mp`` (HSDP), with the rule's ``Shard(dim)``.
  The leaves the rule replicates stay plain tensors outside FSDP
  (``ignored_params``); their gradients are summed over every rank in one
  flat all-reduce per dtype just before each optimizer step and divided
  by the world size, as FSDP averages the sharded ones;
- BatchNorm takes its moments over the global batch and dropout draws the
  global mask's rows (``models/layers.py``): :func:`shard_train_step` hands
  every module with a ``batch_group`` attribute the world group (rows an
  ``mp`` replica repeats scale the sums and the counts alike), and every
  module with a ``batch_rank`` attribute its ``dp`` index (the replicas of
  one index draw one mask).

No FSDP ``mp_policy`` is set: the modules cast their float32 parameters
themselves, so a sharded step computes what the one-card step computes.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

MIN_WEIGHT_SIZE = 2**14


def shard_dim(shape: Sequence[int], axis_size: int) -> Optional[int]:
    """The reference's per-leaf rule on a shape: a leaf with fewer than
    ``MIN_WEIGHT_SIZE`` elements is replicated (None); any other is sharded
    on its largest dimension that ``axis_size`` divides (ties as numpy's
    ``argsort`` orders them, reversed, as the reference); a leaf with no
    such dimension is replicated."""
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) < MIN_WEIGHT_SIZE:
        return None
    for d in np.argsort(shape)[::-1]:
        if shape[d] % axis_size == 0:
            return int(d)
    return None


def batch_rows(n: int, index: int, replicas: int, grad_accum: int = 1) -> torch.Tensor:
    """The global-batch rows ``dp`` replica ``index`` of ``replicas`` takes:
    its part of each of the ``grad_accum`` global microbatches (microbatch
    i is rows [i·n/g, (i+1)·n/g), as the reference's reshape), one after
    the other, so that chunking them in ``grad_accum`` gives the replica's
    part of each."""
    if n % (replicas * grad_accum):
        raise ValueError(f"global batch {n} is not divisible by {replicas} dp replicas x "
                         f"grad_accum {grad_accum}")
    per = n // (grad_accum * replicas)
    return torch.arange(n).reshape(grad_accum, replicas, per)[:, index].reshape(-1)


def dp_coordinate(mesh) -> tuple[int, int]:
    """``(index, size)`` of this rank's replica on ``mesh``'s ``dp`` axis
    (its first)."""
    return int(mesh.get_coordinate()[0]), int(mesh.mesh.shape[0])


def shard_batch(batch: Mapping[str, torch.Tensor], index: int, replicas: int,
                grad_accum: int = 1) -> dict:
    """Every array of ``batch`` at :func:`batch_rows`'s rows."""
    n = next(iter(batch.values())).shape[0]
    rows = batch_rows(n, index, replicas, grad_accum)
    return {k: v.index_select(0, rows.to(v.device)) for k, v in batch.items()}


def _reduce_replicated(params: list, world: int) -> None:
    """Sum the replicated leaves' gradients over every rank, one flat
    all-reduce per dtype, and divide by ``world``."""
    grads: dict = {}
    for p in params:
        if p.grad is not None:
            grads.setdefault(p.grad.dtype, []).append(p.grad)
    for group in grads.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        torch.distributed.all_reduce(flat)
        flat.div_(world)
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))


def shard_train_step(train_step: Callable, mesh, state):
    """Shard a fresh train state over ``mesh`` (a (dp, mp) ``DeviceMesh``
    over every rank in rank order: ``distributed.make_slice_mesh``) and wrap
    its step.

    The model is sharded in place (``fully_shard``), then the optimizer is
    built anew over the sharded parameters, with the same class, groups and
    hyperparameters: one holding the state's old parameters would update
    tensors FSDP no longer uses.  Restore a checkpoint after this
    (``models/checkpoint.py`` reshards it).  Returns ``(step,
    sharded_state)``; ``step(state, batch)`` takes this rank's rows
    (:func:`shard_batch` at its :func:`dp_coordinate`) and returns the global
    batch's mean loss."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..models.train import TrainState

    dist = torch.distributed
    world = dist.get_world_size()
    if mesh.mesh.flatten().tolist() != list(range(world)):
        raise ValueError("the mesh must hold every rank in rank order (make_slice_mesh)")
    if state.optimizer.state:
        raise ValueError("shard a fresh train state; restore a checkpoint after sharding")
    model = state.model
    mp_size = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["mp"]
    dims = {n: shard_dim(p.shape, mp_size) for n, p in model.named_parameters()}
    names = {p: n for n, p in model.named_parameters()}
    by_param = {p: dims[n] for p, n in names.items()}
    replicated = {p for p, d in by_param.items() if d is None}
    groups = [([names[p] for p in g["params"]], {k: v for k, v in g.items() if k != "params"})
              for g in state.optimizer.param_groups]
    with torch.no_grad():
        for p in by_param:
            if p not in replicated and not p.is_contiguous():
                # FSDP2 shards contiguous parameters only: a channels-last
                # conv kernel is gathered in the default layout (cuDNN
                # converts it per call).
                p.data = p.data.contiguous()
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: Shard(by_param[p]),
                ignored_params=replicated or None)
    dp_index = dp_coordinate(mesh)[0]
    for module in model.modules():
        if hasattr(module, "batch_group"):
            module.batch_group = dist.group.WORLD if world > 1 else None
        if hasattr(module, "batch_rank"):
            module.batch_rank = dp_index

    params = dict(model.named_parameters())
    new_groups = []
    for group_names, options in groups:
        sharded = [params[n] for n in group_names if dims[n] is not None]
        plain = [params[n] for n in group_names if dims[n] is None]
        # DTensors and plain tensors in separate groups: a foreach update
        # takes one kind per list.
        new_groups += [dict(options, params=ps) for ps in (sharded, plain) if ps]
    optimizer = type(state.optimizer)(new_groups)
    plain_params = [params[n] for n, d in dims.items() if d is None]
    if world > 1 and plain_params:
        optimizer.register_step_pre_hook(
            lambda *_: _reduce_replicated(plain_params, world))
    sharded_state = TrainState(step=state.step, model=model, optimizer=optimizer)

    def step(state, batch):
        state, loss = train_step(state, batch)
        loss = loss.clone()
        dist.all_reduce(loss)
        return state, loss / world

    return step, sharded_state


def _local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (a plain tensor is its own)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _sharded_dim(t: torch.Tensor) -> Optional[int]:
    """The dimension a tensor of :func:`shard_train_step`'s layout is split
    on over ``mp`` (its mesh's last axis), or None when it is whole."""
    if not hasattr(t, "placements") or not t.placements[-1].is_shard():
        return None
    return t.placements[-1].dim


def local_state_bytes(state) -> int:
    """Bytes of parameters and optimizer state this rank holds (the local
    shard of a sharded tensor)."""
    total = sum(_local(p).numel() * p.element_size() for p in state.model.parameters())
    for per_param in state.optimizer.state.values():
        for value in per_param.values():
            if isinstance(value, torch.Tensor) and value.dim() > 0:
                total += _local(value).numel() * value.element_size()
    return total


def gather_full(tensors: Mapping[str, torch.Tensor]) -> Optional[dict]:
    """``tensors`` (named alike on every rank, in :func:`shard_train_step`'s
    layout) whole, on global rank 0's CPU (None elsewhere); every rank must
    call it.  The ranks of the first ``dp`` replica (ranks 0 .. mp-1) send
    their ``mp`` shards to rank 0 in one ``gather_object`` (a c10d
    collective), which concatenates them along each sharded dimension; a
    whole tensor is rank 0's.  Every other rank sends nothing: it holds
    copies of the first replica's shards.  DTensor's own gather runs
    functional collectives, which gloo does not carry on CUDA tensors."""
    dist = torch.distributed
    rank = dist.get_rank()
    local = {name: (_local(t).detach().cpu(), _sharded_dim(t)) for name, t in tensors.items()
             if rank == 0 or (_sharded_dim(t) is not None
                              and t.device_mesh.get_coordinate()[0] == 0)}
    shards = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(local, shards, dst=0)
    if shards is None:
        return None
    out = {}
    for name, (t, dim) in shards[0].items():
        if dim is not None:
            mp_size = tensors[name].device_mesh.mesh.shape[-1]
            t = torch.cat([shards[r][name][0] for r in range(mp_size)], dim=dim)
        out[name] = t
    return out


def gather_full_state(model: torch.nn.Module) -> Optional[dict]:
    """:func:`gather_full` of the model's parameters and buffers."""
    return gather_full({**dict(model.named_parameters()), **dict(model.named_buffers())})


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``like``: this rank's ``mp`` chunk as a tensor of
    ``like``'s placements when ``like`` is sharded, else ``full`` itself, on
    ``like``'s device.  Every rank holds ``full``, so nothing is sent."""
    full = full.to(like.device)
    if not hasattr(like, "device_mesh"):
        return full
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh
    dim = _sharded_dim(like)
    if dim is not None:
        coordinate = mesh.get_coordinate()[-1]
        full = full.chunk(mesh.mesh.shape[-1], dim=dim)[coordinate].contiguous()
    return DTensor.from_local(full, mesh, like.placements, run_check=False)
