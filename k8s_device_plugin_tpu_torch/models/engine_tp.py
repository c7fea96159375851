"""Tensor-parallel serving: one process per card, a leader and followers.

The reference engine is single-controller GSPMD: one process holds the
whole engine and XLA inserts the collectives.  The port runs one process
per card (``parallel/mesh.py``), so the control flow is its own:

- **Rank 0 of the ``tp`` axis is the leader.**  It runs everything the
  engine decides on the host: admission, the overload limiter, paging,
  preemption, the prefix trie, the KV tiers' bookkeeping, SLO, the
  watchdog, HTTP.
- **The other ranks are followers.**  Each builds its own shard of the
  model and pools, then loops in :meth:`TensorParallelMixin.follow`:
  receive one device operation from the leader, run it on its shard.  A
  follower makes no decision and reads no clock.
- **Every write the engine makes to device state is an ``_op_*`` method**
  taking host values (slots, pages, lists, shape keys) and ids of device
  objects (a prefill job's dense cache).  The leader calls it through
  :meth:`TensorParallelMixin._device_op`, which first broadcasts ``(op,
  args)`` to the followers over a gloo group (``broadcast_object_list``;
  c10d only, no DTensor functional collectives), then runs it locally.
  The ops: the step-state rebuild, the decode dispatch (eager or a graph
  replay), the speculative round, ``seq_lens`` repairs, prefill-job
  creation, seeding, chunks and release, the graft, the chain edits and
  slot clears, the KV rows read and written, and the prefill tap's rows of
  a job's dense cache.  Without a mesh the same methods run directly.
- **Identical results on every rank.**  The logits are all-gathered to the
  full vocabulary before sampling, so every rank draws the same token with
  the same threefry key, and each decode step (each speculative round: its
  tokens and acceptance) ends with a broadcast of rank 0's over the ``tp``
  group.  The w8 self-draft is sharded by the target's rules.
- **KV rows at the leader.**  A read gathers each rank's kv-head slice to
  the leader and joins them on the kv-heads axis; a write scatters the
  slices back.  The host arena, snapshots, warm restarts and the split
  roles' handoff wire see full rows, laid out as the unsharded engine's
  (the reference's host rows stay logical too).

:func:`launch` starts the followers (one process per local card, or gloo
ranks sharing the cards), forms the group, orders the ranks
with ``mesh_from_allocation`` and returns a :class:`ServingGroup`, whose
``build`` makes the leader's engine and has every follower build its
shard.  Followers exit when the leader closes the group, exits or dies.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time
from datetime import timedelta
from typing import Callable, Optional

import torch

# A follower waits on the control group for the leader's next operation for
# as long as it serves.
FOLLOW_TIMEOUT = timedelta(days=3650)
# What a device collective, and the leader on the control group (a header,
# a gather of rows, counts or lint results), may wait for the other ranks.
DEVICE_TIMEOUT = timedelta(seconds=600)
# What a closing group waits for its followers to exit before killing them.
FOLLOWER_EXIT_S = 30.0

_channels: dict = {}


class ControlChannel:
    """The leader's operations to the followers: a gloo group over the
    ``tp`` ranks (its own group even under NCCL, host objects only).  A
    gloo timeout is each process's own: a follower's is FOLLOW_TIMEOUT, the
    leader's DEVICE_TIMEOUT, so a follower that lives but stops answering
    fails the leader's next gather or scatter instead of hanging it."""

    def __init__(self, ranks: list[int]):
        dist = torch.distributed
        self.ranks = ranks
        self.leader = ranks[0]
        self.is_leader = dist.get_rank() == self.leader
        self.group = dist.new_group(
            ranks, backend="gloo", timeout=DEVICE_TIMEOUT if self.is_leader else FOLLOW_TIMEOUT)

    def send(self, obj) -> None:
        torch.distributed.broadcast_object_list([obj], src=self.leader, group=self.group)

    def recv(self):
        box = [None]
        torch.distributed.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]

    def gather_object(self, obj) -> Optional[list]:
        out = [None] * len(self.ranks) if self.is_leader else None
        torch.distributed.gather_object(obj, out, dst=self.leader, group=self.group)
        return out

    def gather_bytes(self, flat: torch.Tensor) -> Optional[list]:
        """Every rank's equal-sized uint8 ``flat`` at the leader."""
        out = [torch.empty_like(flat) for _ in self.ranks] if self.is_leader else None
        torch.distributed.gather(flat, out, dst=self.leader, group=self.group)
        return out

    def scatter_bytes(self, parts: Optional[list], nbytes: int) -> torch.Tensor:
        """The leader's ``parts[i]`` (uint8) to rank ``i`` of the group."""
        out = torch.empty(nbytes, dtype=torch.uint8)
        torch.distributed.scatter(out, parts, src=self.leader, group=self.group)
        return out


def control_channel(mesh, axis: str = "tp") -> ControlChannel:
    """The channel over ``mesh``'s ``axis`` ranks, made once per rank set
    (``new_group`` runs on every rank of the world, in the same order)."""
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    key = (tuple(ranks), id(torch.distributed.group.WORLD))
    if key not in _channels:
        _channels[key] = ControlChannel(ranks)
    return _channels[key]


def _pack(tensors: list) -> torch.Tensor:
    """Host tensors as one flat uint8 tensor (see :func:`_unpack`)."""
    if not tensors:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])


def _nbytes(shape, dtype) -> int:
    return int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()


def _unpack(flat: torch.Tensor, like: list) -> list:
    """``flat`` cut back into tensors of ``like``'s ``(shape, dtype)``."""
    out, off = [], 0
    for shape, dtype in like:
        n = _nbytes(shape, dtype)
        out.append(flat[off: off + n].view(dtype).reshape(shape))
        off += n
    return out


class TensorParallelMixin:
    """The engine's ``mesh``: the leader's broadcast of every device write,
    the followers' loop, the KV rows' gather and scatter, and the sharding
    lint.  Mixed into ServingEngine."""

    def _init_tp(self, mesh, tp_axis: str, cfg, *, cuda_graphs: Optional[bool]) -> Optional[bool]:
        """Check and join ``mesh`` (None: no tensor parallelism); returns
        the ``cuda_graphs`` setting the group allows."""
        self.mesh, self._tp_axis = mesh, tp_axis
        self.tp_size, self._tp, self._tp_ctrl = 1, None, None
        self._tp_devices = None
        self._tp_lock = threading.RLock()
        if mesh is None:
            return cuda_graphs
        names = tuple(mesh.mesh_dim_names or ())
        axes = dict(zip(names, list(mesh.mesh.shape)))
        if tp_axis not in axes:
            raise ValueError(f"engine mesh has no {tp_axis!r} axis (axes: {axes})")
        if len(axes) != 1:
            raise ValueError(f"the engine's mesh is one {tp_axis!r} axis, got {axes}")
        self.tp_size = axes[tp_axis]
        if self.tp_size > 1 and cfg.kv_heads % self.tp_size:
            raise ValueError(
                f"tp={self.tp_size} does not divide num_kv_heads={cfg.kv_heads}: KV pools "
                "shard on the kv-heads axis — pick a tp degree dividing the kv head count "
                "(or a config with more kv heads)"
            )
        from ..parallel.tensor import TensorParallel

        self._tp = TensorParallel.from_mesh(mesh, tp_axis)
        self._tp_ctrl = control_channel(mesh, tp_axis)
        if torch.distributed.get_backend(self._tp.group) == "gloo":
            if cuda_graphs:
                raise ValueError("cuda_graphs: gloo collectives cannot be captured in a CUDA "
                                 "graph; a gloo group (ranks sharing a card) runs eagerly")
            cuda_graphs = False
        # Every rank must build the same engine: a mismatch would pair
        # collectives of other sizes.  The leader holds the devices for
        # debug_state (a follower's list stays empty).
        ranks = self._tp_ctrl.gather_object((str(self.device), repr(cfg))) or []
        if any(other != ranks[0][1] for _, other in ranks):
            raise ValueError(f"the tp ranks build different models: {[c for _, c in ranks]}")
        self._tp_devices = [device for device, _ in ranks]
        return cuda_graphs

    @property
    def tp_leader(self) -> bool:
        """True on the leader, and on an engine with no mesh."""
        return self._tp is None or self._tp.rank == 0

    def _tp_params(self, params: dict) -> dict:
        """This rank's shard of a full state dict (the state dict itself
        without a mesh)."""
        if self._tp is None:
            return params
        from ..parallel.tensor import shard_state_dict

        return shard_state_dict(params, self._tp.size, self._tp.rank, self._tp_axis)

    def _device_op(self, name: str, *args, **leader_only):
        """Run device operation ``_op_<name>(*args)``: on the leader of a
        mesh, after broadcasting ``(name, args)`` to the followers (which
        run it with ``args`` alone; ``leader_only`` keyword arguments stay
        here).  Returns the local result."""
        op = getattr(self, "_op_" + name)
        if self._tp is None:
            return op(*args, **leader_only)
        with self._tp_lock:
            self._tp_ctrl.send((name, args))
            return op(*args, **leader_only)

    def follow(self) -> None:
        """A follower's loop: run the leader's device operations in order
        until it sends ``stop``."""
        if self.tp_leader:
            raise RuntimeError("the leader steps the engine; only followers follow")
        while True:
            name, args = self._tp_ctrl.recv()
            if name == "stop":
                return
            getattr(self, "_op_" + name)(*args)

    def stop_followers(self) -> None:
        """The leader: end every follower's :meth:`follow` loop."""
        if self._tp is not None and self.tp_leader:
            with self._tp_lock:
                self._tp_ctrl.send(("stop", ()))

    def _tp_key(self, key):
        """A sampling key as the rebuild op carries it: host ints on a mesh
        (the followers hold no engine key; the leader's is on the host, so
        this waits for no device work), the device tensor otherwise."""
        return key if self._tp is None else key.tolist()

    # ------------------------------------------------------ KV rows

    def _pool_slabs(self, fn) -> list[tuple[str, str, torch.Tensor]]:
        """``(layer, pool, fn(pool tensor))`` over every pool of every
        layer, in one fixed order."""
        return [(name, pool, fn(t)) for i, name in enumerate(self._layer_names)
                for pool, t in self.kv_pools(i).items()]

    def _gather_kv_heads(self, local: list) -> Optional[list]:
        """Every rank's ``local`` host tensors (alike on every rank) joined
        on the kv-heads axis (dim 2) at the leader; None on a follower."""
        parts = self._tp_ctrl.gather_bytes(_pack(local))
        if parts is None:
            return None
        by_rank = [_unpack(part, [(t.shape, t.dtype) for t in local]) for part in parts]
        return [torch.cat(rows, dim=2) for rows in zip(*by_rank)]

    def _op_kv_read(self, pages: list[int]) -> Optional[list[dict]]:
        """Every rank's rows of ``pages`` (every layer and pool), joined on
        the kv-heads axis at the leader; None on a follower."""
        idx = self._kv_index(pages)
        slabs = self._pool_slabs(lambda t: t.index_select(0, idx).cpu())
        joined = self._gather_kv_heads([rows for _, _, rows in slabs])
        if joined is None:
            return None
        out = [{name: {} for name in self._layer_names} for _ in pages]
        for (name, pool, _), full in zip(slabs, joined):
            for j in range(len(pages)):
                out[j][name][pool] = full[j].clone()
        return out

    def _op_kv_write(self, pages: list[int], rows_list: Optional[list] = None) -> None:
        """Write host rows (the leader's ``rows_list``, full kv heads) into
        ``pages``: each rank receives its kv-head slice and copies it in
        place (a captured graph keeps reading the same pools)."""
        slabs = self._pool_slabs(lambda t: t)
        like = [((len(pages), *t.shape[1:]), t.dtype) for _, _, t in slabs]
        parts = None
        if rows_list is not None:
            full = [torch.stack([rows[name][pool] for rows in rows_list])
                    for name, pool, _ in slabs]
            parts = [_pack([f.narrow(2, r * t.shape[2], t.shape[2])
                            for f, (_, _, t) in zip(full, slabs)])
                     for r in range(self.tp_size)]
        nbytes = sum(_nbytes(shape, dtype) for shape, dtype in like)
        mine = _unpack(self._tp_ctrl.scatter_bytes(parts, nbytes), like)
        idx = self._kv_index(pages)
        for (_, _, pool), rows in zip(slabs, mine):
            pool.index_copy_(0, idx, rows.to(self.device))

    def _op_gather_pools(self) -> Optional[dict]:
        """Every rank's pools (every layer), joined on the kv-heads axis at
        the leader; None on a follower."""
        slabs = self._pool_slabs(lambda t: t.cpu())
        joined = self._gather_kv_heads([t for _, _, t in slabs])
        if joined is None:
            return None
        out: dict = {name: {} for name in self._layer_names}
        for (name, pool, _), full in zip(slabs, joined):
            out[name][pool] = full
        return out

    def gathered_pools(self) -> dict:
        """The pools as one unsharded engine holds them: every rank's,
        joined on the kv-heads axis (the engine's own without a mesh), on
        the host."""
        if self._tp is None:
            return {name: {pool: t.cpu() for pool, t in self.kv_pools(i).items()}
                    for i, name in enumerate(self._layer_names)}
        return self._device_op("gather_pools")

    def _op_dense_rows(self, job_id: int, row: int, lo: int, hi: int) -> Optional[dict]:
        """Positions ``[lo, hi)`` (whole pages) of row ``row`` of a prefill
        job's dense cache, every pool of every layer, on the host as
        ``{(layer, pool): [hi - lo, kv_heads, ...]}``: joined on the kv-heads
        axis at the leader over a mesh (None on a follower)."""
        ps = self.paged.page_size
        slabs = []
        for layer, name in enumerate(self._layer_names):
            for pool, slab in zip(("pool_key", "pool_value", "pool_key_scale", "pool_value_scale"),
                                  self._jobs[job_id]["cache"].layer(layer)):
                if slab is not None:
                    rows = slab[row, lo:hi].cpu()
                    slabs.append(((name, pool), rows.reshape(-1, ps, *rows.shape[1:])))
        if self._tp is None:
            full = [rows for _, rows in slabs]
        else:
            full = self._gather_kv_heads([rows for _, rows in slabs])
            if full is None:
                return None
        return {key: t.reshape(hi - lo, *t.shape[2:]) for (key, _), t in zip(slabs, full)}

    def _op_rank_stats(self, reset: bool) -> Optional[list]:
        from ..ops import paged_attention as pa

        stats = {"device_steps": self.device_steps, "graph_replays": self.graph_replays,
                 "paged_launches": dict(pa.paged_attention.launches_by_format)}
        if reset:
            pa.reset_launches()
        return self._tp_ctrl.gather_object(stats)

    def rank_stats(self, reset: bool = False) -> list[dict]:
        """Each rank's dispatched device steps, graph replays and paged
        kernel launches (its process's counts), in rank order; ``reset``
        sets every rank's launch counts to 0 after reading them."""
        if self._tp is None:
            raise ValueError("engine has no mesh: read its own counters")
        return self._device_op("rank_stats", reset)

    # ------------------------------------------------------ the lint

    def _op_lint(self) -> Optional[list]:
        """Every rank's lint result (leaves checked, or the failure text),
        gathered at the leader."""
        from ..parallel.serving import assert_explicit_sharding

        tree = {
            "params": dict(self.model.state_dict()),
            "cache": {name: self.kv_pools(i) for i, name in enumerate(self._layer_names)},
            "page_table": self.cache.page_table,
            "seq_lens": self.cache.seq_lens,
            "chain": self._chain,
            "dev": dict(self._bufs),
        }
        try:
            result = assert_explicit_sharding(tree, self.device, tp=self.tp_size,
                                              kv_heads=self.cfg.kv_heads, tp_axis=self._tp_axis)
        except AssertionError as e:
            result = str(e)
        return self._tp_ctrl.gather_object(result)

    def assert_sharded(self) -> int:
        """Sharding-coverage lint (``parallel/serving.py``) on every rank:
        each rank's parameters, pools, tables and step buffers on its
        device, and each pool holding ``kv_heads / tp`` heads.  Raises
        AssertionError naming the rank and the offending path; returns the
        leaves checked over every rank.  Meaningless without a mesh."""
        if self.mesh is None:
            raise ValueError("engine has no mesh: build it with mesh= to lint sharding")
        results = self._device_op("lint")
        for rank, result in enumerate(results):
            if isinstance(result, str):
                raise AssertionError(f"rank {rank}: {result}")
        return sum(results)

    def tp_state(self) -> dict:
        """``debug_state()["tp"]``: the reference's four keys."""
        if self.mesh is None:
            return {"size": 1, "axis": None, "mesh": None, "devices": None}
        return {"size": self.tp_size, "axis": self._tp_axis,
                "mesh": {self._tp_axis: self.tp_size}, "devices": list(self._tp_devices)}


# ------------------------------------------------------------------ launcher


def _join(tp: int, local_rank: int, backend: str, init_method: str, device_type: str):
    """Join the group as ``local_rank`` and build the ``tp`` mesh; returns
    (mesh, this rank's device)."""
    from ..parallel import distributed
    from ..parallel.mesh import mesh_from_allocation

    device = distributed.join_local(device_type, local_rank, tp, init_method, backend,
                                    environ={}, timeout=DEVICE_TIMEOUT)
    mesh = mesh_from_allocation(tp, device_type=device.type)
    control_channel(mesh)
    return mesh, device


def _exit_with_parent(parent: int) -> None:
    """A follower's guard: exit at once when the leader is gone."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(1)


def _follower_main(local_rank: int, tp: int, backend: str, init_method: str, device_type: str,
                   parent: int) -> None:
    """A follower process: join, then build each engine the leader names
    and follow it, until the leader sends ``exit``.  It ignores SIGINT and
    SIGTERM (a terminal's Ctrl-C reaches the whole process group): the
    leader drains and then releases it, and it exits at once if the
    leader dies."""
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, signal.SIG_IGN)
    threading.Thread(target=_exit_with_parent, args=(parent,), daemon=True).start()
    if device_type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    mesh, device = _join(tp, local_rank, backend, init_method, device_type)
    channel = control_channel(mesh)
    try:
        while True:
            command = channel.recv()
            if command[0] == "exit":
                return
            engine = command[1](mesh=mesh, device=device)
            engine.follow()
            del engine
    finally:
        torch.distributed.destroy_process_group()


class ServingGroup:
    """The leader's side of a launched ``tp`` group: the ``mesh``, this
    rank's ``device``, the follower processes, and :meth:`build`."""

    def __init__(self, mesh, device, procs: list):
        self.mesh, self.device, self.procs = mesh, device, procs
        self.channel = control_channel(mesh)
        self.engine = None

    @property
    def follower_pids(self) -> list[int]:
        return [p.pid for p in self.procs]

    def build(self, factory: Callable, **leader_only):
        """The leader's engine ``factory(mesh=, device=, **leader_only)``;
        every follower builds its own with ``factory(mesh=, device=)``
        (``factory`` must pickle: a ``functools.partial`` of a module-level
        function).  Stops the followers of a previous engine first."""
        if self.engine is not None:
            self.engine.stop_followers()
        self.channel.send(("engine", factory))
        self.engine = factory(mesh=self.mesh, device=self.device, **leader_only)
        return self.engine

    def close(self) -> None:
        """Stop the followers, wait for them (killing any left after
        ``FOLLOWER_EXIT_S``) and leave the group.  Idempotent."""
        if self.channel is None:
            return
        try:
            if self.engine is not None:
                self.engine.stop_followers()
            self.channel.send(("exit",))
        finally:
            self.channel = None
            deadline = time.monotonic() + FOLLOWER_EXIT_S
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
            _kill(self.procs)
            _channels.clear()
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"tensor-parallel follower(s) exited with {bad}")

    def __enter__(self) -> "ServingGroup":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self.abort()

    def abort(self) -> None:
        """Kill every follower and leave the group (a failure path)."""
        self.channel = None
        _kill(self.procs)
        _channels.clear()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _kill(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def launch(tp: int, *, backend: Optional[str] = None, device=None) -> ServingGroup:
    """Start a ``tp``-way serving group with this process as its leader:
    ``tp - 1`` follower processes, rank r on local card r modulo the
    visible cards (as ``models/benchmark.py``'s ``launch``), the group
    formed by ``parallel/distributed.initialize`` and the ranks ordered by
    ``mesh_from_allocation(tp)`` (on-cluster ``TPU_VISIBLE_CHIPS`` must name
    ``tp`` chips; off-cluster the first ``tp`` ranks).  ``backend``: NCCL on
    cards (one rank a card), gloo on the CPU by default; gloo on cards lets
    more ranks than cards share them.  Each device collective may wait
    ``DEVICE_TIMEOUT``.  Use the result as a context manager, or call
    ``close``; on a failure every follower is killed."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and backend == "nccl" and tp > torch.cuda.device_count():
        raise ValueError(f"--tp {tp} needs {tp} cards but only {torch.cuda.device_count()} "
                         "are visible (NCCL takes one rank a card)")
    from ..parallel.distributed import local_init_method

    init_method = local_init_method()
    ctx = multiprocessing.get_context("spawn")
    procs = []
    try:
        for rank in range(1, tp):
            proc = ctx.Process(target=_follower_main, daemon=True, args=(
                rank, tp, backend, init_method, device.type, os.getpid()))
            proc.start()
            procs.append(proc)
        mesh, device = _join(tp, 0, backend, init_method, device.type)
    except BaseException:
        _kill(procs)
        _channels.clear()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        raise
    return ServingGroup(mesh, device, procs)
