"""Training steps for every trained model (the reference's ``models/train.py``).

The reference builds pure functions for XLA (state in, state out); here a
step updates the :class:`TrainState`'s model and optimizer in place, since
PyTorch runs eagerly and an in-place update keeps one copy of the weights.
The optimizer is ``torch.optim.SGD(lr, momentum, dampening=0,
nesterov=False)``, the same update as ``optax.sgd(lr, momentum)``: a trace
t = g + momentum * t from zero, then p -= lr * t.

BatchNorm state lives in the model's buffers (``TrainState.batch_stats``
reads them): a training forward updates them, an eval forward reads them
and changes nothing.  Models whose ``forward`` takes ``train`` (the image
models; not BERT or the LM) get it, as the reference's
``_takes_train_kwarg``; those that also take ``dropout_rng`` get the step's
dropout key, the reference's: ``fold_in(PRNGKey(0), step)``, and under
``grad_accum`` microbatch i's ``fold_in(that, i)``, as two ints
(``utils/prng.fold_in_words``).

Over several ranks (``parallel/sharding.shard_train_step``) a step takes
this rank's rows of the global batch, laid out by ``sharding.batch_rows``
so that chunk i under ``grad_accum`` is the rank's share of global
microbatch i (the reference's rows ``[i·B/g, (i+1)·B/g)``): BatchNorm's
statistics then carry microbatch to microbatch as the reference's scan
carries them, and dropout draws microbatch i's global mask under the same
key.  The sharded step all-reduces the loss, so what it returns is the
global batch's mean.

LoRA training (``GPTConfig(lora_rank=r)``) takes the same step: pass
``tx=lora.make_lora_tx(inner)`` to :func:`create_train_state` (or
:func:`state_for`), whose optimizer then holds the adapters alone with the
base frozen.

MoE models (``parallel/moe.py``): ``make_train_step(aux_loss_coeff=c)``
adds ``c`` times the sum of every MoE layer's load-balance loss to the
loss it differentiates and reports (:func:`sown_aux_loss`, the reference's
sown ``moe_aux_loss``), once per microbatch under ``grad_accum``.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.fused_xent import fused_linear_xent
from ..utils import prng
from .transformer import GPTConfig, TransformerLM


@dataclass
class TrainState:
    """Steps taken, the training model (float32 parameters, BatchNorm
    statistics as its buffers) and its optimizer."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def batch_stats(self) -> dict:
        """The model's running statistics by flax path
        (``BatchNorm_0.mean``); empty for a model without BatchNorm."""
        return dict(self.model.named_buffers())


def state_for(model: nn.Module, lr: float = 0.1, momentum: float = 0.9,
              tx: Optional[Callable[[nn.Module], torch.optim.Optimizer]] = None) -> TrainState:
    """A train state at step 0 over ``model`` (float32 parameters): SGD with
    zero momentum, or the optimizer ``tx(model)`` builds (e.g.
    ``lora.make_lora_tx``)."""
    if tx is not None:
        opt = tx(model)
    else:
        opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum, dampening=0,
                              nesterov=False)
    return TrainState(step=0, model=model, optimizer=opt)


def create_train_state(config: GPTConfig, params: dict, lr: float = 0.1, momentum: float = 0.9,
                       *, tx: Optional[Callable[[nn.Module], torch.optim.Optimizer]] = None,
                       device=None, mlp_factory=None) -> TrainState:
    """An LM training model loaded from ``params`` (a state dict:
    ``init_params`` or ``convert.flax_to_state_dict``) with zero momentum,
    or with the optimizer ``tx`` builds (see :func:`state_for`);
    ``mlp_factory``: the blocks' MLP (``parallel/moe.moe_mlp_factory``)."""
    model = TransformerLM(config, device=device, train=True, mlp_factory=mlp_factory)
    model.load_state_dict(params)
    return state_for(model, lr, momentum, tx)


def _forward_args(model: nn.Module) -> set:
    return set(inspect.signature(type(model).forward).parameters)


def _apply(model: nn.Module, x, train: bool, key_words: Optional[tuple]):
    """The model's output on ``x``, with ``train`` (and ``dropout_rng``)
    where its forward takes them."""
    args = _forward_args(model)
    kwargs = {}
    if "train" in args:
        kwargs["train"] = train
    if "dropout_rng" in args:
        kwargs["dropout_rng"] = key_words
    return model(x, **kwargs)


def softmax_xent(logits, labels):
    """Mean token cross-entropy of float32 logits against integer labels."""
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    )


def sown_aux_loss(model: nn.Module):
    """The sum of the auxiliary losses the model's layers kept in their
    last forward (each MoE layer's ``aux_loss``); 0.0 when none did."""
    total = 0.0
    for module in model.modules():
        aux = getattr(module, "aux_loss", None)
        if aux is not None:
            total = total + aux
    return total


def make_train_step(aux_loss_coeff: float = 0.0, grad_accum: int = 1,
                    input_key: str = "input_ids") -> Callable:
    """``(state, batch) -> (state, loss)``: forward, backward, one
    optimizer update; the model reads ``batch[input_key]`` ("images" for
    the image models, the reference's default; "input_ids" for BERT and the
    LM, this module's default).  ``grad_accum > 1`` splits the batch into
    that many microbatches and averages their float32 gradients before the
    one update (the reference's scanned step; activation memory of one
    microbatch); BatchNorm statistics carry from one microbatch to the next,
    as the reference's scan carries them.  The batch's leading dim must
    divide evenly.  ``aux_loss_coeff > 0`` adds that multiple of
    :func:`sown_aux_loss` to every microbatch's loss (MoE models; GShard
    and Switch use about 0.01)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_of(model, x, y, key):
        loss = softmax_xent(_apply(model, x, True, key), y)
        if aux_loss_coeff > 0.0:
            loss = loss + aux_loss_coeff * sown_aux_loss(model)
        return loss

    def train_step(state: TrainState, batch: dict):
        x, y = batch[input_key], batch["labels"]
        root = prng.fold_in_words((0, 0), state.step)  # fold_in(PRNGKey(0), step)
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss = loss_of(state.model, x, y, root)
            loss.backward()
        else:
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch size {x.shape[0]} is not divisible by grad_accum {grad_accum}"
                )
            loss = torch.zeros((), device=x.device)
            for i, (xm, ym) in enumerate(zip(x.chunk(grad_accum), y.chunk(grad_accum))):
                key_i = prng.fold_in_words(root, i)
                loss_i = loss_of(state.model, xm, ym, key_i)
                loss_i.backward()  # float32 parameters: the grads sum in float32
                loss = loss + loss_i.detach()
            for p in state.model.parameters():
                if p.grad is not None:  # frozen parameters have none
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


def make_eval_step(input_key: str = "input_ids") -> Callable:
    """``(state, batch) -> logits`` without gradients; BatchNorm normalizes
    with the running averages and leaves them as they are."""

    def eval_step(state: TrainState, batch: dict):
        with torch.no_grad():
            return _apply(state.model, batch[input_key], False, None)

    return eval_step
