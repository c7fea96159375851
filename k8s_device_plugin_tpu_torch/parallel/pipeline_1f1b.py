"""1F1B (one-forward-one-backward) pipeline schedule over a ``pp`` group.

Counterpart of the reference's ``parallel/pipeline_1f1b.py``.  GPipe
(``pipeline.py``) runs every forward, then every backward, so a stage
holds the graphs of every microbatch: activation memory grows with
``n_micro``.  1F1B interleaves: a stage runs the backward of microbatch
``m`` as soon as its cotangent arrives, so at most ``2 * n_stages - 1``
inputs are ever stored on a stage, whatever the microbatch count.

Schedule (stage ``s`` of ``L``, microbatch ``m``), the reference's:

  forward  at tick  t = m + s
  backward at tick  t = m + 2L - 1 - s

over ``n_micro + 2L - 1`` ticks.  The forward unit stores the stage's
input in a ring of :func:`residual_buffer_depth` slots and runs the stage
without autograd; the backward unit reads its microbatch's input back,
recomputes the stage under autograd and pulls the cotangent through it
(per-stage rematerialisation).  Each tick reads the backward's input
before the forward writes its own: the two never concern the same
microbatch in one tick (``2L - 1 - s == s`` has no integer solution), and
that order is what makes ``2L - 1`` slots enough.  :class:`ResidualRing`
raises on a write into a slot that was not read, so the order is checked
on every tick.

As in ``pipeline.py``, each stage is one rank of the ``pp`` group and a
tick's transfers (the activation to the right, the input's gradient to
the left, and their receives) are one ``batch_isend_irecv``; a stage runs
only the units of its window (the reference runs every unit and masks the
stores), a transfer happens only when its sender ran the unit, and the
ring's wrap-around edges (last to first activations, first to last
cotangents), which the reference never reads, are not made.  The skipped
units change no sum; only the active ones launch anything.

Scaling and types, the reference's: the last stage's objective sees the
stage output cast to float32; the seed cotangent is ``dy / n_micro`` cast
back to the stage's type; head gradients are scaled by ``1 / n_micro``;
the loss is summed in float32 and divided by ``n_micro``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .pipeline import grads_of, mse_loss, replicate, stage_group, stage_params
from .tensor import TensorParallel


def residual_buffer_depth(n_micro: int, n_stages: int) -> int:
    """Inputs stored per stage under 1F1B: one written at tick ``m + s`` is
    read at ``m + 2L - 1 - s``, so at most ``2L - 1`` slots are ever in
    use, whatever the microbatch count."""
    return min(n_micro, 2 * n_stages - 1)


class ResidualRing:
    """The forward unit's stored inputs: microbatch ``m`` in slot ``m %
    depth``.  Storing into a slot whose microbatch was not taken back, or
    taking one that is not there, raises."""

    def __init__(self, depth: int):
        self.depth = depth
        self.peak = 0  # the most slots in use at once
        self._slots: list = [None] * depth

    def put(self, m: int, x: torch.Tensor) -> None:
        slot = m % self.depth
        if self._slots[slot] is not None:
            raise RuntimeError(f"1F1B residual slot {slot} still holds microbatch "
                               f"{self._slots[slot][0]} when microbatch {m} is stored")
        self._slots[slot] = (m, x)
        self.peak = max(self.peak, sum(held is not None for held in self._slots))

    def take(self, m: int) -> torch.Tensor:
        held = self._slots[m % self.depth]
        if held is None or held[0] != m:
            raise RuntimeError(f"1F1B residual of microbatch {m} is not in its slot")
        self._slots[m % self.depth] = None
        return held[1]


def _accumulate(p: torch.Tensor, d: torch.Tensor) -> None:
    p.grad = d if p.grad is None else p.grad.add_(d)


def one_f_one_b(pp: TensorParallel, n_micro: int, feed: Callable, run: Callable,
                like: torch.Tensor, objective: Optional[Callable] = None,
                head_params: list = (), input_grads: bool = False) -> tuple:
    """The 1F1B schedule on this stage.

    ``feed(m)``: the first stage's input for microbatch ``m``; ``run(x)``:
    the stage (under autograd in the backward unit, whose gradients land
    in the ``.grad`` of the leaves it reads); ``like``: a tensor shaped,
    typed and placed as a transferred activation.  On the last stage
    ``objective(m, y)`` is microbatch ``m``'s loss of the stage output
    ``y`` (float32), and ``head_params`` the leaves it reads beside ``y``
    (their gradients, scaled by ``1 / n_micro``, land in their ``.grad``).
    ``input_grads``: keep the first stage's input gradients.

    Returns ``(loss, input_grads, ring)``: the mean loss over the
    microbatches (on the last stage; zero elsewhere), the first stage's
    input gradients by microbatch (None elsewhere or without
    ``input_grads``) and the :class:`ResidualRing` it stored into."""
    s, n = pp.rank, pp.size
    last = s == n - 1
    ring = ResidualRing(residual_buffer_depth(n_micro, n))
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    dxs = [None] * n_micro if input_grads and s == 0 else None
    act_in = ct_in = None
    for t in range(n_micro + 2 * n - 1):
        # The backward's input is read before the forward stores its own.
        mb = t - (2 * n - 1 - s)
        x_saved = ring.take(mb) if 0 <= mb < n_micro else None
        mf, y = t - s, None
        if 0 <= mf < n_micro:
            x = feed(mf) if s == 0 else act_in
            ring.put(mf, x)
            with torch.no_grad():
                y = run(x)
        dx = None
        if x_saved is not None:
            x_leaf = x_saved.detach().requires_grad_(s > 0 or dxs is not None)
            with torch.enable_grad():
                y2 = run(x_leaf)
                if last:
                    y2f = y2.detach().float().requires_grad_()
                    value = objective(mb, y2f)
                    *d_head, dy = torch.autograd.grad(value, [*head_params, y2f])
                    for p, d in zip(head_params, d_head):
                        _accumulate(p, d * (1.0 / n_micro))
                    loss += value.detach().float()
                    ct = (dy / n_micro).to(y2.dtype)
                else:
                    ct = ct_in
                torch.autograd.backward(y2, ct)
            dx = x_leaf.grad
            if dxs is not None:
                dxs[mb] = dx
        sends = []
        if y is not None and not last:
            sends.append((y, s + 1))
        if dx is not None and s > 0:
            sends.append((dx, s - 1))
        # What the neighbours ran this tick: the left stage's forward, the
        # right stage's backward.
        from_left = s > 0 and 0 <= t - (s - 1) < n_micro
        from_right = not last and 0 <= t - (2 * n - 2 - s) < n_micro
        got = pp.send_recv(sends, [(like, s - 1)] * from_left + [(like, s + 1)] * from_right)
        act_in = got.pop(0) if from_left else None
        ct_in = got.pop(0) if from_right else None
    return loss / n_micro, dxs, ring


def _identity_head(head_params, y):
    del head_params
    return y


def pipeline_1f1b_train(stage_fn: Callable, stacked_params: Any, microbatches: torch.Tensor,
                        targets: torch.Tensor, mesh, axis: str = "pp",
                        loss: Callable = mse_loss, head_fn: Optional[Callable] = None,
                        head_params: Any = None, collect_input_grads: bool = True,
                        stats: Optional[dict] = None) -> tuple:
    """Pipelined loss and every gradient a full model needs, 1F1B schedule.

    Args:
      stage_fn: ``(one_stage_params, x) -> y`` with ``y.shape == x.shape``.
      stacked_params: tree with leading dim ``n_stages``
        (``pipeline.stack_stage_params``); this rank uses its stage's slice.
      microbatches: ``[n_micro, ...]`` activation stream, the same on every
        rank: the output of whatever (an embedder) runs before the
        pipelined region.
      targets: ``[n_micro, ...]`` per-microbatch targets.
      loss: ``(pred, target) -> scalar``; the objective is its mean over
        microbatches.
      head_fn/head_params: a head applied to the last stage's output inside
        each microbatch's objective (the LM head), the same params on every
        rank; default the identity (targets shaped like the stage output).
      stats: when given, filled with the residual ring's ``buffer_depth``
        and ``buffer_peak`` (the most inputs stored at once) on this rank.

    Returns ``(loss, stage_grads, head_grads, d_microbatches)``: the mean
    loss, the gradients of this rank's stage (its slice of
    ``stacked_params``), of the head (zeros-tree without one) and of the
    microbatches (None under ``collect_input_grads=False``), each the same
    on every rank of the group but the stage gradients."""
    pp = stage_group(stacked_params, mesh, axis)
    leaves, spec = tree_flatten(stage_params(stacked_params, pp.rank))
    mine = [leaf.detach().requires_grad_() for leaf in leaves]
    tree = tree_unflatten(mine, spec)
    h_leaves, h_spec = tree_flatten({} if head_params is None else head_params)
    h_mine = [h.detach().requires_grad_() for h in h_leaves]
    h_tree = tree_unflatten(h_mine, h_spec)
    head_fn = _identity_head if head_fn is None else head_fn
    last = pp.rank == pp.size - 1
    total, dxs, ring = one_f_one_b(
        pp, microbatches.shape[0], lambda m: microbatches[m].detach(),
        lambda x: stage_fn(tree, x), microbatches[0],
        objective=lambda m, y: loss(head_fn(h_tree, y), targets[m]),
        head_params=h_mine if last else [], input_grads=collect_input_grads)
    if stats is not None:
        stats.update(buffer_depth=ring.depth, buffer_peak=ring.peak)
    replicate(pp, total, pp.size - 1)
    head_grads = grads_of(h_mine)
    for g in head_grads:
        replicate(pp, g, pp.size - 1)
    d_micro = None
    if collect_input_grads:
        d_micro = torch.stack(dxs) if pp.rank == 0 else torch.empty_like(microbatches)
        replicate(pp, d_micro, 0)
    return (total, tree_unflatten(grads_of(mine), spec), tree_unflatten(head_grads, h_spec),
            d_micro)


def pipeline_1f1b_grads(stage_fn: Callable, stacked_params: Any, microbatches: torch.Tensor,
                        targets: torch.Tensor, mesh, axis: str = "pp",
                        loss: Callable = mse_loss, stats: Optional[dict] = None) -> tuple:
    """Head-less convenience wrapper: ``(loss, stage_grads)`` (see
    :func:`pipeline_1f1b_train`), without collecting the input gradients
    it would never read."""
    total, grads, _, _ = pipeline_1f1b_train(stage_fn, stacked_params, microbatches, targets,
                                             mesh, axis, loss, collect_input_grads=False,
                                             stats=stats)
    return total, grads
