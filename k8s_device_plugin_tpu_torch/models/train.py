"""Decoder-LM training steps (the reference's ``models/train.py``).

The reference builds pure functions for XLA (state in, state out); here a
step updates the :class:`TrainState`'s model and optimizer in place, since
PyTorch runs eagerly and an in-place update keeps one copy of the weights.
The optimizer is ``torch.optim.SGD(lr, momentum, dampening=0,
nesterov=False)``, the same update as ``optax.sgd(lr, momentum)``: a trace
t = g + momentum * t from zero, then p -= lr * t.

Not ported here: BatchNorm state (the image models' slice) and the MoE
auxiliary loss (the MoE slice).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.fused_xent import fused_linear_xent
from .transformer import GPTConfig, TransformerLM


@dataclass
class TrainState:
    """Steps taken, the training model (float32 parameters) and its
    optimizer."""

    step: int
    model: TransformerLM
    optimizer: torch.optim.Optimizer


def create_train_state(config: GPTConfig, params: dict, lr: float = 0.1, momentum: float = 0.9,
                       *, device=None) -> TrainState:
    """A training model loaded from ``params`` (a state dict: ``init_params``
    or ``convert.flax_to_state_dict``) with zero momentum."""
    model = TransformerLM(config, device=device, train=True)
    model.load_state_dict(params)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum, dampening=0,
                          nesterov=False)
    return TrainState(step=0, model=model, optimizer=opt)


def softmax_xent(logits, labels):
    """Mean token cross-entropy of float32 logits against integer labels."""
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    )


def make_train_step(aux_loss_coeff: float = 0.0, grad_accum: int = 1) -> Callable:
    """``(state, batch) -> (state, loss)``: forward, backward, one
    optimizer update.  ``grad_accum > 1`` splits the batch into that many
    microbatches and averages their float32 gradients before the one
    update (the reference's scanned step; activation memory of one
    microbatch).  The batch's leading dim must divide evenly."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if aux_loss_coeff > 0.0:
        raise NotImplementedError(
            "aux_loss_coeff > 0 trains MoE models: not ported yet (the MoE slice, see ROADMAP.md)"
        )

    def train_step(state: TrainState, batch: dict):
        x, y = batch["input_ids"], batch["labels"]
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = softmax_xent(state.model(x), y)
            loss.backward()
        else:
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch size {x.shape[0]} is not divisible by grad_accum {grad_accum}"
                )
            loss = torch.zeros((), device=x.device)
            for xm, ym in zip(x.chunk(grad_accum), y.chunk(grad_accum)):
                loss_i = softmax_xent(state.model(xm), ym)
                loss_i.backward()  # float32 parameters: the grads sum in float32
                loss = loss + loss_i.detach()
            for p in state.model.parameters():
                p.grad.div_(grad_accum)
            loss = loss / grad_accum
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def make_fused_lm_train_step(chunk: Optional[int] = None) -> Callable:
    """A train step whose loss tail is the fused LM-head + cross-entropy
    (``ops/fused_xent.py``): the model runs with ``output="hidden"`` and
    ``lm_head.kernel`` is applied chunk by chunk inside the loss, so the
    [batch, seq, vocab] float32 logits never exist.  ``chunk=None``
    resolves to ``max(256, vocab // 2)``, the reference's default."""

    def train_step(state: TrainState, batch: dict):
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        hidden = model(batch["input_ids"], output="hidden")
        b, s, d = hidden.shape
        w = model.lm_head.kernel
        loss = fused_linear_xent(
            hidden.reshape(b * s, d).to(w.dtype), w, batch["labels"].reshape(b * s),
            chunk if chunk is not None else max(256, w.shape[1] // 2),
        )
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def make_eval_step() -> Callable:
    """``(state, batch) -> logits`` without gradients."""

    def eval_step(state: TrainState, batch: dict):
        with torch.no_grad():
            return state.model(batch["input_ids"])

    return eval_step
