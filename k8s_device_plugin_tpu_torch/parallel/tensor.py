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
``layer_0/attn/query/kernel``).  The reference matches no rule on the
leaves of a quantized or multi-LoRA site and lets GSPMD replicate them;
here a rank computes only its shard, so :func:`leaf_spec` splits them with
their site's kernel: ``kernel_q`` as ``kernel``; a column-parallel site's
``kernel_scale`` and ``lora_b(_stack)`` on its features; a row-parallel
site's ``lora_a(_stack)`` on its contraction (its ``kernel_scale`` is per
output feature, whole).  Each split stays exact: the partial sums of a row
site are summed by the site's all-reduce.

Training (:func:`shard_train_step_tp`, the reference's dp x ep x tp step
for the MoE LM) needs the collectives to carry gradients.  Megatron's
conjugate pair does: :meth:`TensorParallel.copy` (f: identity forward,
all-reduce backward) at the input of each column-parallel site and
:meth:`TensorParallel.reduce` (g: all-reduce forward, identity backward)
after each row-parallel one; :meth:`TensorParallel.gather_last` gathers
the lm_head's logits and hands each rank back its own columns' gradient
(every rank computed the same loss from the same gathered logits, so
nothing is summed).  Without gradients (serving) f is the identity and g
the in-place all-reduce.
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


# A site's leaves besides ``kernel``: (suffix, leading stack dims).
_SITE_LEAVES = {"kernel_q": 0, "kernel_scale": 0, "lora_a": 0, "lora_b": 0,
                "lora_a_stack": 1, "lora_b_stack": 1}


def _contract_ndim(site: str, ndim: int) -> int:
    from ..ops.quant import contract_ndim

    return contract_ndim(site, ndim)


def leaf_spec(name: str, shapes: Mapping[str, tuple], axis_sizes: Mapping[str, int],
              tp_axis: str = "tp") -> tuple:
    """The port's partition spec of ``name`` in a state dict of ``shapes``
    (name -> shape): :func:`tp_spec_for` for every leaf the reference's
    rules name, and for a quantized or LoRA site's other leaves the split
    its kernel's spec implies (module docstring).  The kernel's shape is
    read off the site's ``kernel``/``kernel_q`` in ``shapes``."""
    prefix, _, leaf = name.rpartition(".")
    if leaf not in _SITE_LEAVES:
        return tp_spec_for(name, shapes[name], axis_sizes, tp_axis)
    kernel = shapes.get(prefix + ".kernel", shapes.get(prefix + ".kernel_q"))
    if kernel is None:
        return ()
    spec = tp_spec_for(prefix + ".kernel", kernel, axis_sizes, tp_axis)
    dim = tp_dim(spec, tp_axis)
    if dim is None:
        return ()
    k = _contract_ndim(prefix.rpartition(".")[2], len(kernel))
    lead = (None,) * _SITE_LEAVES[leaf]
    ndim = len(shapes[name])
    if leaf == "kernel_q":
        return spec
    if leaf == "kernel_scale":
        return _at(dim - k, ndim, tp_axis) if dim >= k else ()
    if leaf.startswith("lora_a"):  # [*stack, *contract, r]
        return lead + _at(dim, ndim - len(lead), tp_axis) if dim < k else ()
    # lora_b: [*stack, r, *features]
    return lead + (None,) + _at(dim - k, ndim - len(lead) - 1, tp_axis) if dim >= k else ()


def _at(dim: int, ndim: int, axis: str) -> tuple:
    return tuple(axis if d == dim else None for d in range(ndim))


def shard_for_mesh(params: Mapping[str, torch.Tensor], axis_sizes: Mapping[str, int],
                   coords: Mapping[str, int], tp_axis: str = "tp") -> dict:
    """This rank's shard of a full state dict over a mesh of ``axis_sizes``
    at mesh ``coords`` (axis -> this rank's index on it): every dimension
    :func:`leaf_spec` splits over an axis, cut to the rank's equal chunk on
    it; every other leaf whole (the same tensor)."""
    shapes = {name: tuple(v.shape) for name, v in params.items()}
    out = {}
    for name, value in params.items():
        for dim, axis in enumerate(leaf_spec(name, shapes, axis_sizes, tp_axis)):
            if axis is not None:
                value = value.chunk(axis_sizes[axis], dim=dim)[coords[axis]]
        out[name] = value if value is params[name] else value.contiguous()
    return out


def shard_state_dict(params: Mapping[str, torch.Tensor], tp: int, rank: int,
                     tp_axis: str = "tp") -> dict:
    """Rank ``rank``'s shard of a full state dict at degree ``tp`` (the
    reference's ``tp_param_sharding`` plus ``device_put``): each parameter
    :func:`leaf_spec` splits, cut to its ``rank``-th equal chunk on that
    dimension; every other one whole."""
    return shard_for_mesh(params, {tp_axis: tp}, {tp_axis: rank}, tp_axis)


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
    """One rank's view of a ``tp`` group (or of an ``ep`` or ``sp`` one):
    its size and rank, and the collectives the sharded model runs on device
    tensors (c10d ops on the group: NCCL on cards, where a CUDA graph
    captures them, gloo on the CPU or on ranks sharing a card).  A group
    of one runs the same collectives.  ``calls`` counts each kind as it is
    issued (a graph capture counts what its replays run)."""

    def __init__(self, group, *, axis: str = "tp"):
        dist = torch.distributed
        self.group, self.axis = group, axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.src = dist.get_global_rank(group, 0)  # the leader's global rank
        self.backend = dist.get_backend(group)
        self.calls: Counter = Counter()

    @classmethod
    def from_mesh(cls, mesh, axis: str = "tp") -> "TensorParallel":
        return cls(mesh.get_group(axis), axis=axis)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group, in place, in its own type."""
        self.calls["all_reduce"] += 1
        torch.distributed.all_reduce(x, group=self.group)
        return x

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the group, in place."""
        self.calls["all_reduce_max"] += 1
        torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.MAX, group=self.group)
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """g: the sum of ``x`` over the group; its gradient passes through
        whole.  In place when no gradient is tracked."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Reduce.apply(x, self)
        return self.all_reduce(x)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """f: ``x`` itself; its gradient is summed over the group (each
        rank's is the part its shard of the next site contributes)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Copy.apply(x, self)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_gather_last`, whose gradient is this rank's columns of
        the gathered tensor's (every rank holds the same one)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _GatherLast.apply(x, self)
        return self.all_gather_last(x)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined on the last dimension, in rank order."""
        self.calls["all_gather"] += 1
        lead, last = x.shape[:-1], x.shape[-1]
        flat = x.reshape(-1, last).contiguous()
        out = torch.empty((self.size * flat.shape[0], last), dtype=x.dtype, device=x.device)
        _all_gather_single(out, flat, group=self.group)
        out = out.reshape(self.size, flat.shape[0], last).permute(1, 0, 2)
        return out.reshape(*lead, self.size * last)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Overwrite ``x`` with group rank ``root``'s, in place."""
        self.calls["broadcast"] += 1
        src = self.src if root == 0 else torch.distributed.get_global_rank(self.group, root)
        torch.distributed.broadcast(x, src, group=self.group)
        return x

    # The sequence-parallel exchanges (``parallel/ring.py``, ``ulysses.py``).
    # gloo carries neither c10d's all-to-all nor its point-to-point ops on
    # CUDA tensors (ranks sharing a card), so on a gloo group a CUDA
    # tensor's exchange is staged through host memory, chosen by the
    # backend and counted in ``calls["host_staged"]``; NCCL exchanges on
    # the card.

    def _staged(self, x: torch.Tensor) -> bool:
        staged = x.is_cuda and self.backend == "gloo"
        self.calls["host_staged"] += staged
        return staged

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk j of ``x`` (its first dimension, of the group's size) sent
        to group rank j, and what rank j sent this rank in its place: the
        reference's tiled ``lax.all_to_all``.  Its gradient is the same
        exchange of the gradient."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Exchange.apply(x, self)
        return self.all_to_all(x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """c10d's ``all_to_all_single`` of ``x`` (equal chunks over its
        first dimension)."""
        self.calls["all_to_all"] += 1
        staged = self._staged(x)
        send = (x.cpu() if staged else x).contiguous()
        out = torch.empty_like(send)
        torch.distributed.all_to_all_single(out, send, group=self.group)
        return out.to(x.device) if staged else out

    def ring_shift(self, *xs: torch.Tensor) -> tuple:
        """Each of ``xs`` sent to the next rank of the ring, ``(rank + 1) %
        size``, and the previous rank's in its place: the reference's
        ``lax.ppermute`` over ``[(i, (i + 1) % n)]``.  Its gradient goes
        the other way round (ppermute's transpose)."""
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return _Shift.apply(self, *xs)
        return self.shift(xs, 1)

    def shift(self, xs: tuple, step: int) -> tuple:
        """Every tensor of ``xs`` sent ``step`` ranks round the ring in
        one ``batch_isend_irecv`` (a ring of two ranks or more: c10d's
        point-to-point ops refuse a send to oneself)."""
        self.calls["ring_shift"] += 1
        dst, src = (self.rank + step) % self.size, (self.rank - step) % self.size
        return tuple(self._send_recv([(x, dst) for x in xs], [(x, src) for x in xs]))

    def send_recv(self, sends: list, recvs: list) -> list:
        """Point-to-point transfers in one ``batch_isend_irecv``: each
        ``(tensor, group rank)`` of ``sends`` sent there, and for each
        ``(like, group rank)`` of ``recvs`` a tensor shaped and typed as
        ``like`` received from there, returned in order.  Nothing at all
        when both are empty (c10d's point-to-point ops refuse a send to
        oneself, so a group of one never calls this with a transfer)."""
        if not sends and not recvs:
            return []
        self.calls["p2p"] += 1
        return self._send_recv(sends, recvs)

    def _send_recv(self, sends: list, recvs: list) -> list:
        dist = torch.distributed
        like = (sends or recvs)[0][0]
        staged = self._staged(like)
        ops, got = [], []
        for x, peer in sends:
            ops.append(dist.P2POp(dist.isend, (x.cpu() if staged else x).contiguous(),
                                  dist.get_global_rank(self.group, peer), self.group))
        for x, peer in recvs:
            got.append(torch.empty(x.shape, dtype=x.dtype, device="cpu" if staged else x.device))
            ops.append(dist.P2POp(dist.irecv, got[-1], dist.get_global_rank(self.group, peer),
                                  self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [out.to(like.device) if staged else out for out in got]


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad.contiguous().clone()), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_to_all(grad), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tp.shift(xs, 1)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.tp.shift(grads, -1))


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.rank, ctx.width = tp.rank, x.shape[-1]
        return tp.all_gather_last(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width).contiguous(), None


# ------------------------------------------------------------------ training


class MeshSplit:
    """How a parameter of :func:`shard_train_step_tp`'s layout is cut (its
    ``tp_layout`` attribute): its spec over the mesh's axes, the axes'
    sizes and this rank's coordinates on them.  ``sharding.gather_full``
    and ``sharding.shard_like`` read it, so checkpoints move between this
    layout and any other."""

    def __init__(self, spec: tuple, sizes: Mapping[str, int], coords: Mapping[str, int],
                 dp_axis: str = "dp"):
        self.spec, self.sizes, self.coords = tuple(spec), dict(sizes), dict(coords)
        self.dp_axis = dp_axis

    @property
    def first_replica(self) -> bool:
        return self.coords.get(self.dp_axis, 0) == 0

    def key(self) -> tuple:
        """This rank's chunk: its coordinate on each axis the spec splits."""
        return tuple(self.coords[a] for a in self.spec if a is not None)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``full``."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                full = full.chunk(self.sizes[axis], dim=dim)[self.coords[axis]]
        return full.contiguous()

    def join(self, chunks: Mapping[tuple, torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every chunk, keyed by :meth:`key`."""
        split = [(dim, axis) for dim, axis in enumerate(self.spec) if axis is not None]
        pieces = dict(chunks)
        for i in reversed(range(len(split))):
            dim, axis = split[i]
            joined: dict = {}
            for key in sorted(pieces):
                joined.setdefault(key[:i], []).append(pieces[key])
            pieces = {k: torch.cat(v, dim=dim) for k, v in joined.items()}
        return pieces[()]


def tp_state_sharding(state, mesh, tp_axis: str = "tp") -> dict:
    """Each parameter's spec over ``mesh`` (a ``DeviceMesh`` whose axes
    include ``tp`` and, for MoE, ``ep``): :func:`leaf_spec` by name.  The
    optimizer's moments follow their parameters; the step is a host int."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    shapes = {name: tuple(p.shape) for name, p in state.model.named_parameters()}
    return {name: leaf_spec(name, shapes, sizes, tp_axis) for name in shapes}


def shard_train_step_tp(train_step, mesh, state, dp_axis: str = "dp", tp_axis: str = "tp",
                        ep_axis: str = "ep"):
    """Shard a fresh LM train state over ``mesh`` (a ``DeviceMesh`` over
    every rank with ``dp`` first, then ``ep`` and/or ``tp``:
    ``distributed.make_slice_mesh({"dp": .., "ep": .., "tp": ..})``) and
    wrap its step: the reference's dp x ep x tp step.

    The model is rebuilt at this rank's widths (heads, ffn and vocab over
    ``tp``, experts over ``ep``: :func:`tp_state_sharding`) and loaded with
    its chunks of the full parameters, each marked with its
    :class:`MeshSplit`; the optimizer is built anew over it with the same
    class, groups and hyperparameters.  The model runs the collectives
    itself (module docstring; the MoE output over each replica's ``ep x
    tp`` ranks), so every gradient comes out whole for the chunk a rank
    holds, and the pre-step hook averages it over ``dp``.  Returns
    ``(step, sharded_state)``; ``step(state, batch)`` takes this rank's
    rows (``sharding.shard_batch`` at ``sharding.dp_coordinate``: the batch
    splits over ``dp`` alone) and returns the global batch's mean loss."""
    from .moe import ExpertParallel

    dist = torch.distributed
    names = tuple(mesh.mesh_dim_names)
    if names[0] != dp_axis:
        raise ValueError(f"the mesh's first axis must be {dp_axis!r}, got {names}")
    sizes = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    coords = dict(zip(names, mesh.get_coordinate()))
    ep = None
    if ep_axis in sizes:
        # The ep x tp ranks of each dp replica (new_group runs on every rank,
        # for every replica, in the same order).
        replicas = [dist.new_group(mesh.mesh[i].flatten().tolist())
                    for i in range(sizes[dp_axis])]
        ep = ExpertParallel(TensorParallel(replicas[coords[dp_axis]], axis=ep_axis),
                            sizes[ep_axis], coords[ep_axis])
    return shard_lm_step(train_step, mesh, state, ep=ep, replicas=sizes[dp_axis],
                         replica_group=mesh.get_group(dp_axis), dp_axis=dp_axis, tp_axis=tp_axis)


def shard_lm_step(train_step, mesh, state, *, ep, replicas: int, replica_group,
                  dp_axis: str = "dp", tp_axis: str = "tp"):
    """What :func:`shard_train_step_tp` and ``sequence.shard_train_step_sp``
    share: the LM rebuilt at this rank's widths over ``mesh``'s ``tp`` (and
    ``ep``) and loaded with its chunks, keeping the model's MLP factory and
    ``attention_fn``; the optimizer built anew; gradients averaged over the
    ``replicas`` ranks of ``replica_group`` (the ranks that hold the same
    chunks) before each update, and the step's loss their mean."""
    from ..models.train import TrainState
    from ..models.transformer import TransformerLM
    from .sharding import average_grads

    dist = torch.distributed
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the mesh must hold every rank in rank order (make_slice_mesh)")
    if state.optimizer.state:
        raise ValueError("shard a fresh train state; restore a checkpoint after sharding")
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    coords = dict(zip(names, mesh.get_coordinate()))
    model = state.model
    tp = TensorParallel.from_mesh(mesh, tp_axis) if tp_axis in sizes else None
    specs = tp_state_sharding(state, mesh, tp_axis)
    full = {name: p.detach() for name, p in model.named_parameters()}
    local = TransformerLM(model.config, device=model.device, train=True, tp=tp,
                          mlp_factory=model.mlp_factory, ep=ep, attention_fn=model.attention_fn)
    local.load_state_dict(shard_for_mesh(full, sizes, coords, tp_axis))
    for name, p in local.named_parameters():
        p.tp_layout = MeshSplit(specs[name], sizes, coords, dp_axis)
    params = dict(local.named_parameters())
    by_param = {p: n for n, p in model.named_parameters()}
    groups = [dict({k: v for k, v in g.items() if k != "params"},
                   params=[params[by_param[p]] for p in g["params"]])
              for g in state.optimizer.param_groups]
    optimizer = type(state.optimizer)(groups)
    if replicas > 1:
        plist = list(params.values())
        optimizer.register_step_pre_hook(
            lambda *_: average_grads(plist, replicas, replica_group))
    sharded = TrainState(step=state.step, model=local, optimizer=optimizer)

    def step(state, batch):
        state, loss = train_step(state, batch)
        loss = loss.clone()
        dist.all_reduce(loss, group=replica_group)
        return state, loss / replicas

    return step, sharded
