"""GPipe pipeline parallelism over a ``pp`` group of ranks.

Counterpart of the reference's ``parallel/pipeline.py``.  The reference is
a spatial program: one ``lax.scan`` inside ``shard_map`` whose every tick
runs each device's stage on a microbatch and ``ppermute``s the result one
device to the right, round a ring; autodiff of the scan is the GPipe
backward.  Here each stage is one process, a rank of the ``pp`` group (the
ranks of a ``DeviceMesh`` that share every other coordinate:
``DeviceMesh.get_group``), its group rank the stage, and the ticks are a
Python loop:

- at tick ``t`` stage ``s`` runs microbatch ``t - s``, then sends the
  result to stage ``s + 1`` while it receives stage ``s - 1``'s, both in
  one ``batch_isend_irecv`` (``TensorParallel.send_recv``);
- the reference runs every stage at every tick, on clamped or zero data
  outside its window, and masks what it keeps; here a stage runs only the
  microbatches of its window, and a transfer happens only when its sender
  ran one.  Both ends decide from that one predicate, so every send meets
  its receive in the same tick;
- the ring's wrap-around edge (last stage to first) carries nothing the
  reference reads and is not made, so a group of one makes no transfer.

The backward runs the ticks the other way: a stage keeps the graph of
every microbatch it ran (its input, a leaf, and its output), backpropagates
each output with the cotangent the stage to its right sent, and sends its
input's gradient to the left.  Activations stay O(n_micro), as GPipe's do.
On gloo a CUDA tensor travels through host memory, counted in
``calls["host_staged"]``; NCCL sends it from the card.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .tensor import TensorParallel


def stack_stage_params(stage_params: list) -> Any:
    """Stack per-stage parameter trees along a new leading stage axis.

    All stages must share a tree structure and leaf shapes (same layer type
    per stage: the GPipe regime)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *stage_params)


def stage_params(stacked: Any, stage: int) -> Any:
    """Stage ``stage``'s slice of a stacked tree: what its rank holds."""
    return tree_map(lambda leaf: leaf[stage], stacked)


def mse_loss(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Default pipeline objective: the one definition both schedules share."""
    return torch.mean((y.float() - t.float()) ** 2)


def pp_group(mesh, axis: str = "pp") -> TensorParallel:
    """This rank's ``axis`` group, its stage the group rank.  Over NCCL a
    group of several first runs one all-reduce: a ``batch_isend_irecv``
    that is a group's first collective must involve every rank of it, and
    the first tick's transfers involve two."""
    pp = TensorParallel.from_mesh(mesh, axis)
    if pp.size > 1 and pp.backend == "nccl":
        torch.distributed.all_reduce(torch.zeros(1, device="cuda"), group=pp.group)
    return pp


def stage_group(stacked: Any, mesh, axis: str = "pp") -> TensorParallel:
    """:func:`pp_group`, after the reference's error when the stacked
    tree's lead dim is not the group's size."""
    pp = pp_group(mesh, axis)
    lead = tree_flatten(stacked)[0][0].shape[0]
    if lead != pp.size:
        raise ValueError(f"stacked_params lead dim {lead} != mesh axis {axis}={pp.size}")
    return pp


def grads_of(leaves: list) -> list:
    """Each leaf's accumulated gradient, zeros where none arrived."""
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]


def replicate(pp: TensorParallel, x: torch.Tensor, stage: int) -> torch.Tensor:
    """``x`` as stage ``stage`` holds it, on every rank of the group (in
    place; a group of one has it already)."""
    return pp.broadcast(x, stage) if pp.size > 1 else x


def forward_ticks(pp: TensorParallel, n_micro: int, feed: Callable, run: Callable,
                  like: torch.Tensor, track: bool = False) -> list:
    """GPipe's forward on this stage: for microbatch ``m`` of its window,
    ``x`` is ``feed(m)`` on the first stage and what the stage to its left
    sent elsewhere (a leaf that requires grad under ``track``), and ``out =
    run(m, x)`` goes to the stage to its right unless this is the last.
    ``like``: a tensor shaped, typed and placed as a transferred
    activation.  Returns ``[(x, out)]`` by microbatch."""
    s, n = pp.rank, pp.size
    graphs, incoming = [], None
    for t in range(n_micro + n - 1):
        m, sends = t - s, []
        if 0 <= m < n_micro:
            x = feed(m) if s == 0 else incoming.requires_grad_(track)
            out = run(m, x)
            graphs.append((x, out))
            if s < n - 1:
                sends = [(out.detach(), s + 1)]
        receives = s > 0 and 0 <= t - (s - 1) < n_micro  # the left stage ran one
        got = pp.send_recv(sends, [(like, s - 1)] if receives else [])
        incoming = got[0] if receives else None
    return graphs


def backward_ticks(pp: TensorParallel, graphs: list, cotangent: Callable,
                   like: torch.Tensor) -> list:
    """GPipe's backward on this stage over :func:`forward_ticks`'s graphs:
    microbatch ``m``'s output backpropagated with ``cotangent(m)`` on the
    last stage (None: a scalar output) and with what the stage to its right
    sent elsewhere; its input's gradient goes to the stage to its left.
    Each graph is dropped once used.  Returns the first stage's input
    gradients by microbatch where its inputs are leaves that require grad
    (else an empty list)."""
    s, n = pp.rank, pp.size
    n_micro = len(graphs)
    dxs, incoming = [], None
    for u in range(n_micro + n - 1):
        m, sends = u - (n - 1 - s), []
        if 0 <= m < n_micro:
            x, out = graphs[m]
            graphs[m] = None
            torch.autograd.backward(out, cotangent(m) if s == n - 1 else incoming)
            if s > 0:
                sends = [(x.grad, s - 1)]
            elif x.is_leaf and x.requires_grad:
                dxs.append(x.grad)
        receives = s < n - 1 and 0 <= u - (n - 2 - s) < n_micro  # the right stage ran one
        got = pp.send_recv(sends, [(like, s + 1)] if receives else [])
        incoming = got[0] if receives else None
    return dxs


def _last_outputs(pp: TensorParallel, graphs: list, like: torch.Tensor) -> torch.Tensor:
    """The last stage's outputs stacked by microbatch, on every rank."""
    if pp.rank == pp.size - 1:
        out = torch.stack([y.detach() for _, y in graphs])
    else:
        out = torch.empty((len(graphs),) + tuple(like.shape), dtype=like.dtype,
                          device=like.device)
    return replicate(pp, out, pp.size - 1)


class _GPipe(torch.autograd.Function):
    """The schedule as one differentiable call on each rank: its forward
    keeps this stage's graphs, its backward runs :func:`backward_ticks` and
    returns the gradient of this rank's stage parameters and, replicated
    from the first stage, of the microbatches."""

    @staticmethod
    def forward(ctx, stage_fn, spec, pp, microbatches, *params):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
            tree = tree_unflatten(leaves, spec)
            track_input = ctx.needs_input_grad[3]
            graphs = forward_ticks(
                pp, microbatches.shape[0],
                lambda m: microbatches[m].detach().requires_grad_(track_input),
                lambda m, x: stage_fn(tree, x), microbatches[0], track=True)
        ctx.pp, ctx.graphs, ctx.leaves, ctx.like = pp, graphs, leaves, microbatches[0]
        return _last_outputs(pp, graphs, microbatches[0])

    @staticmethod
    def backward(ctx, grad):
        pp = ctx.pp
        dxs = backward_ticks(pp, ctx.graphs, lambda m: grad[m], ctx.like)
        d_micro = None
        if ctx.needs_input_grad[3]:
            d_micro = torch.stack(dxs) if pp.rank == 0 else torch.empty_like(grad)
            replicate(pp, d_micro, 0)
        return (None, None, None, d_micro, *grads_of(ctx.leaves))


def pipeline_apply(stage_fn: Callable, stacked_params: Any, microbatches: torch.Tensor, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run ``microbatches`` through ``n_stages`` chained applications of
    ``stage_fn``, one stage per rank of ``mesh``'s ``axis`` group.

    Args:
      stage_fn: ``(one_stage_params, x) -> y`` with ``y.shape == x.shape``
        (chainable stages; embed and head go outside the pipelined region).
      stacked_params: tree whose leaves have leading dim ``n_stages``
        (:func:`stack_stage_params`); this rank uses its stage's slice.
      microbatches: ``[n_micro, ...]`` activation stream, the same on every
        rank of the group.
      mesh: a ``DeviceMesh`` whose ``axis`` groups have ``n_stages`` ranks;
        its other axes replicate.

    Returns ``[n_micro, ...]`` outputs of the final stage on every rank of
    the group.  Differentiable: the gradient of a stage's parameters lands
    on its rank (zero in the other stages' slices), the microbatches'
    gradient on every rank."""
    pp = stage_group(stacked_params, mesh, axis)
    mine, spec = tree_flatten(stage_params(stacked_params, pp.rank))
    if torch.is_grad_enabled() and (microbatches.requires_grad or any(p.requires_grad
                                                                      for p in mine)):
        return _GPipe.apply(stage_fn, spec, pp, microbatches, *mine)
    tree = tree_unflatten(mine, spec)
    graphs = forward_ticks(pp, microbatches.shape[0], lambda m: microbatches[m],
                           lambda m, x: stage_fn(tree, x), microbatches[0])
    return _last_outputs(pp, graphs, microbatches[0])


def pipelined_loss_fn(stage_fn: Callable, mesh, axis: str = "pp",
                      loss: Optional[Callable] = None) -> Callable:
    """Build ``(stacked_params, microbatches, targets) -> scalar``: pipeline
    forward, then the mean loss over all microbatches (targets shaped like
    the pipeline output); its backward is GPipe's.  Default loss: MSE."""
    if loss is None:
        loss = mse_loss

    def fn(stacked_params, microbatches, targets):
        return loss(pipeline_apply(stage_fn, stacked_params, microbatches, mesh, axis), targets)

    return fn
