"""Device meshes over the ranks of a ``torch.distributed`` process group.

Counterpart of the reference's ``parallel/mesh.py``.  The reference lays
``jax.devices()`` out as a ``jax.sharding.Mesh``; here one process drives
one card, so a mesh is a ``DeviceMesh`` over process ranks, and a "device"
in the arguments below is a rank.  The axis rules, the TPU plugin's env
(``TPU_VISIBLE_CHIPS``, ``TPU_CHIPS_PER_HOST_BOUNDS``) and the error texts
are the reference's; the GPU device plugin's ``GPU_DEVICE_MINORS``
(``plugin/envs.py``) names the granted cards where it is set, with no
bounds (NVSwitch joins every card to every other, so no order is better).

:func:`mesh_shape` and :func:`allocation_ranks` are the pure halves of
:func:`make_mesh` and :func:`mesh_from_allocation`: they check and order
without a process group.  The ``DeviceMesh`` constructors need one
(``parallel/distributed.py`` forms it) and, like ``torch.distributed``'s
``new_group``, must be called on every rank of it.

A rank's host-local index comes from ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` (torchrun's names, which ``models/benchmark.py``'s
launcher sets); without them every rank is taken as local.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional, Sequence

import torch


def chip_index(coords: tuple[int, int, int], bounds: tuple[int, int, int]) -> int:
    """A chip's index in its host block, x fastest (the port's copy of
    ``plugin/topology.py``'s)."""
    bx, by, _bz = bounds
    x, y, z = coords
    return x + bx * (y + by * z)


def chips_per_host_bounds(environ: Mapping[str, str] | None = None) -> tuple[int, ...] | None:
    environ = os.environ if environ is None else environ
    text = environ.get("TPU_CHIPS_PER_HOST_BOUNDS")
    if not text:
        return None
    try:
        return tuple(int(v) for v in text.split(","))
    except ValueError:
        return None


# The env naming the granted devices: the GPU device plugin's, else the
# TPU plugin's.
ALLOCATION_ENVS = ("GPU_DEVICE_MINORS", "TPU_VISIBLE_CHIPS")


def allocation_env(environ: Mapping[str, str]) -> str:
    """The name of the allocation env this pod got (the first of
    ALLOCATION_ENVS that is set; the TPU plugin's when neither is)."""
    return next((name for name in ALLOCATION_ENVS if environ.get(name)), ALLOCATION_ENVS[-1])


def allocated_chip_indices(environ: Mapping[str, str] | None = None) -> list[int] | None:
    """The host-local device indices the plugin granted this container
    (GPU_DEVICE_MINORS, else TPU_VISIBLE_CHIPS), or None off-cluster /
    unparsable, in the plugin's sorted-index order."""
    environ = os.environ if environ is None else environ
    text = environ.get(allocation_env(environ))
    if not text:
        return None
    try:
        return [int(v) for v in text.split(",")]
    except ValueError:
        return None


def snake_order(bounds: Sequence[int]) -> list[int]:
    """Local chip indices of the ``bounds`` block in boustrophedon order:
    x sweeps alternate direction per row, y per plane, so consecutive
    entries are neighbours along exactly one axis (the ``tp`` ring then
    rides nearest-neighbour links)."""
    bx, by, bz = (tuple(bounds) + (1, 1, 1))[:3]
    order: list[int] = []
    xdir = ydir = 1
    for z in range(bz):
        ys = range(by) if ydir > 0 else range(by - 1, -1, -1)
        for y in ys:
            xs = range(bx) if xdir > 0 else range(bx - 1, -1, -1)
            for x in xs:
                order.append(chip_index((x, y, z), (bx, by, bz)))
            xdir = -xdir
        ydir = -ydir
    return order


def mesh_shape(axes: Mapping[str, int] | None, n: int) -> dict[str, int]:
    """The axis sizes ``axes`` asks for over ``n`` devices, the reference's
    rules: a size of -1 means "whatever is left" (at most one), and the
    sizes must multiply to ``n``.  Default: one data-parallel axis
    ``{"dp": -1}``."""
    axes = dict(axes) if axes else {"dp": -1}
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"axes {axes} do not cover {n} devices")
    return dict(zip(axes, sizes))


def _world() -> int:
    return torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1


def _device_type() -> str:
    """``cuda`` under NCCL, else ``cpu`` (gloo ranks on cards pass
    ``device_type="cuda"``)."""
    nccl = torch.distributed.is_initialized() and torch.distributed.get_backend() == "nccl"
    return "cuda" if nccl else "cpu"


def make_mesh(axes: Mapping[str, int] | None = None, devices: Sequence[int] | None = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over ``devices`` (ranks; default every rank of the
    process group, in rank order) laid out as ``axes`` in declaration
    order, e.g. ``{"dp": 2, "mp": 4}``.  ``device_type`` defaults to
    ``cuda`` when this process drives a card, else ``cpu``."""
    from torch.distributed.device_mesh import DeviceMesh

    devices = list(range(_world())) if devices is None else [int(d) for d in devices]
    shape = mesh_shape(axes, len(devices))
    grid = torch.tensor(devices, dtype=torch.int64).reshape(tuple(shape.values()))
    return DeviceMesh(device_type or _device_type(), grid, mesh_dim_names=tuple(shape))


def _host_ranks() -> list[int]:
    """The ranks on this host: this rank's LOCAL_WORLD_SIZE neighbours."""
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    count = int(os.environ.get("LOCAL_WORLD_SIZE", _world()))
    return list(range(rank - local, rank - local + count))


def allocation_ranks(tp: int, *, environ: Mapping[str, str] | None = None,
                     devices: Sequence[int] | None = None) -> list[int]:
    """The ranks of :func:`mesh_from_allocation`'s ``tp`` axis, in order.

    On-cluster (TPU_VISIBLE_CHIPS injected) the allocation is the mesh:
    ``tp`` must equal the granted chip count, and the axis walks the
    granted block's bounds in snake order.  Off-cluster: the first ``tp``
    of ``devices`` (default every rank).  On-cluster ``devices`` defaults
    to this host's ranks, one per granted chip in TPU_VISIBLE_CHIPS order."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    environ = os.environ if environ is None else environ
    chips = allocated_chip_indices(environ)
    if chips is None:
        devices = list(range(_world())) if devices is None else list(devices)
        if tp > len(devices):
            raise ValueError(
                f"--tp {tp} needs {tp} devices but only {len(devices)} are "
                "visible (no TPU_VISIBLE_CHIPS injected: off-cluster "
                "fallback over every rank)"
            )
        return devices[:tp]
    if len(chips) != tp:
        name = allocation_env(environ)
        raise ValueError(
            f"--tp {tp} does not match the allocation: the plugin injected "
            f"{len(chips)} chip(s) ({name}="
            f"{environ.get(name)!r}).  Request a pod with "
            f"exactly {tp} chips or set --tp {len(chips)}."
        )
    devices = _host_ranks() if devices is None else list(devices)
    if len(devices) < tp:
        raise ValueError(
            f"the allocation grants {tp} chip(s) but only {len(devices)} "
            "rank(s) run on this host: start one rank per granted chip"
        )
    devices = devices[:tp]
    # Only the TPU plugin's grant has a mesh to walk; the GPU plugin's has
    # none, whatever TPU bounds an image leaks into the env.
    tpu = allocation_env(environ) == "TPU_VISIBLE_CHIPS"
    bounds = chips_per_host_bounds(environ) if tpu else None
    if bounds is not None and math.prod(bounds) == tp:
        # Rank i drives the chip at local block index i (x fastest): reorder
        # along the snake walk so the tp ring rides adjacent links.
        devices = [devices[i] for i in snake_order(bounds)]
    return devices


def mesh_from_allocation(tp: int, *, environ: Mapping[str, str] | None = None,
                         devices: Sequence[int] | None = None, tp_axis: str = "tp",
                         device_type: Optional[str] = None):
    """A 1-axis ``tp`` mesh over the chips the plugin allocated
    (:func:`allocation_ranks` orders them)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = allocation_ranks(tp, environ=environ, devices=devices)
    return DeviceMesh(device_type or _device_type(), torch.tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=(tp_axis,))
