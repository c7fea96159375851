"""The decoder LM run as a pipeline: ``pp`` applied to a real model.

Counterpart of the reference's ``parallel/pipeline_lm.py``.  The
``num_layers`` decoder blocks of ``models/transformer.py`` are divided into
``pp`` equal stages; each rank of the ``pp`` group builds and holds its own
stage alone.  The reference replicates the embedding and the LM head on
every device (they are cheap and shape-changing); here the first stage
holds the embedding and the last the final norm and float32 ``lm_head``,
and the loss is broadcast from the last stage, so every rank returns the
same one.  A rank's modules carry ``TransformerLM``'s names
(``embed.embedding``, ``layer_{s*k+i}`` for stage ``s``'s block ``i`` of
``k``, ``final_norm``, ``lm_head``), so its state dict is the unsharded
LM's restricted to its stage; ``convert.pipelined_flax_to_state_dict`` and
``pipelined_state_dicts_to_flax`` move the reference's tree in and out.

Two schedules train it (:meth:`PipelinedLM.make_train_step`): GPipe
(``pipeline.py``: every microbatch's graph kept on its stage, the whole
batch's mean token cross-entropy) and 1F1B (``pipeline_1f1b.py``: each
microbatch's objective on the last stage, the embedding's gradient from
the first stage's input gradients).  Every stage rotates its microbatch at
positions ``0..seq-1``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.train import TrainState, softmax_xent, state_for
from ..models.transformer import (
    DecoderBlock,
    DenseGeneral,
    Embed,
    GPTConfig,
    RMSNorm,
    init_params,
)
from ..utils.device import resolve_device
from .pipeline import backward_ticks, forward_ticks, pp_group, replicate
from .pipeline_1f1b import one_f_one_b


class DecoderStage(nn.Module):
    """``layers`` consecutive decoder blocks: stage ``stage``, its blocks
    named as ``TransformerLM`` names them.  Under ``config.remat`` each
    block is recomputed in the backward, as the LM's are."""

    def __init__(self, config: GPTConfig, layers: int, stage: int = 0, device=None):
        super().__init__()
        self.config = config
        for i in range(stage * layers, (stage + 1) * layers):
            self.add_module(f"layer_{i}", DecoderBlock(config, device))

    def forward(self, hidden, positions):
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.children():
            if remat:
                hidden = checkpoint(block, hidden, positions, use_reentrant=False)
            else:
                hidden = block(hidden, positions)
        return hidden


class _Embedder(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.embed = Embed(config.vocab_size, config.hidden_size, config.dtype, device)

    def forward(self, ids):
        return self.embed(ids)


class _Head(nn.Module):
    """The final ``RMSNorm`` and the float32 ``lm_head``."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        d = config.hidden_size
        self.final_norm = RMSNorm(d, config.dtype, device=device)
        self.lm_head = DenseGeneral((d,), (config.vocab_size,), torch.float32, device)

    def forward(self, hidden):
        return self.lm_head(self.final_norm(hidden).float())


class StageModules(nn.Module):
    """What one rank trains: the children of its parts under their own
    names, so the state dict is ``TransformerLM``'s for this stage."""

    def __init__(self, *parts):
        super().__init__()
        for part in parts:
            if part is not None:
                for name, child in part.named_children():
                    self.add_module(name, child)


class PipelinedLM:
    """Decoder LM with its blocks split over the ``axis`` groups of
    ``mesh``, this rank holding its group rank's stage.

    Usage (on every rank of the group):
        plm = PipelinedLM(cfg, mesh, n_micro=8)
        plm.init(seed)  # or plm.load_state_dict(state)
        state = plm.create_train_state()
        step = plm.make_train_step(schedule="1f1b")
        state, loss = step(state, batch)

    Parameters are float32 (cast to ``config.dtype`` at every dense site,
    as the training ``TransformerLM``'s).  Runs on ``cuda`` unless
    ``device="cpu"`` is asked for."""

    def __init__(self, config: GPTConfig, mesh, n_micro: int, axis: str = "pp", device=None):
        self.config, self.axis, self.n_micro = config, axis, n_micro
        self.device = resolve_device(device)
        self.pp = pp_group(mesh, axis)
        self.n_stages, self.stage = self.pp.size, self.pp.rank
        if config.num_layers % self.n_stages:
            raise ValueError(f"num_layers {config.num_layers} not divisible by "
                             f"{axis}={self.n_stages} stages")
        self.layers_per_stage = config.num_layers // self.n_stages
        self.first, self.last = self.stage == 0, self.stage == self.n_stages - 1
        dev = self.device
        self._embed = _Embedder(config, dev) if self.first else None
        self._stage = DecoderStage(config, self.layers_per_stage, self.stage, dev)
        self._head = _Head(config, dev) if self.last else None
        self.model = StageModules(self._embed, self._stage, self._head).to(torch.float32)

    # ---------------------------------------------------------- parameters
    def init(self, seed: int = 0) -> dict:
        """Load this stage's share of ``models/transformer.init_params(config,
        seed)``, so every stage count trains the same LM from a seed; returns
        this rank's state dict."""
        self.load_state_dict(init_params(self.config, seed))
        return self.state_dict()

    def load_state_dict(self, state) -> None:
        """Load this stage's entries of ``state`` (the whole LM's, in
        ``TransformerLM``'s names, or this stage's alone)."""
        self.model.load_state_dict({name: state[name] for name in self.model.state_dict()})

    def state_dict(self) -> dict:
        return self.model.state_dict()

    # ------------------------------------------------------------- forward
    def _microbatch(self, ids: torch.Tensor, n_micro: int) -> torch.Tensor:
        b = ids.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        return ids.reshape(n_micro, b // n_micro, *ids.shape[1:])

    def _like(self, micro_ids: torch.Tensor) -> torch.Tensor:
        """A transferred activation's shape, type and place."""
        rows, seq = micro_ids.shape[1:]
        return torch.empty((rows, seq, self.config.hidden_size), dtype=self.config.dtype,
                           device=self.device)

    @staticmethod
    def _positions(micro_ids: torch.Tensor) -> torch.Tensor:
        """[rows, seq] position ids, ``0..seq-1`` in every microbatch."""
        rows, seq = micro_ids.shape[1:]
        return torch.arange(seq, device=micro_ids.device).expand(rows, seq)

    def _forward(self, ids: torch.Tensor, n_micro: int) -> torch.Tensor:
        micro = self._microbatch(ids, n_micro)
        positions = self._positions(micro)

        def run(m, x):
            y = self._stage(x, positions)
            return self._head(y) if self.last else y

        with torch.no_grad():
            graphs = forward_ticks(self.pp, n_micro, lambda m: self._embed(micro[m]), run,
                                   self._like(micro))
        b, s = ids.shape
        if self.last:
            logits = torch.cat([out for _, out in graphs])
        else:
            logits = torch.empty((b, s, self.config.vocab_size), device=self.device)
        return replicate(self.pp, logits, self.n_stages - 1)

    def apply(self, ids: torch.Tensor) -> torch.Tensor:
        """[batch, seq] ids -> [batch, seq, vocab] float32 logits, the same
        on every rank of the group: ``n_micro`` microbatches through the
        GPipe forward."""
        return self._forward(ids, self.n_micro)

    def apply_serial(self, ids: torch.Tensor) -> torch.Tensor:
        """The stages in order on the whole batch, one microbatch (the
        numerics oracle for tests)."""
        return self._forward(ids, 1)

    # ------------------------------------------------------------ training
    def create_train_state(self, lr: float = 0.1, momentum: float = 0.9, tx=None) -> TrainState:
        """A train state over this rank's modules (``models/train.state_for``:
        SGD with zero momentum, or the optimizer ``tx`` builds)."""
        return state_for(self.model, lr, momentum, tx)

    def make_train_step(self, schedule: str = "gpipe",
                        loss_fn: Callable = softmax_xent) -> Callable:
        """``(state, batch) -> (state, loss)`` on every rank of the group,
        the loss the same on each.  ``schedule``: "gpipe" (every forward,
        then every backward: O(n_micro) activation memory) or "1f1b"
        (interleaved: O(n_stages)).  Both optimize the same objective, the
        batch's mean token loss."""
        if schedule == "gpipe":
            run = self._gpipe_grads
        elif schedule == "1f1b":
            run = self._one_f_one_b_grads
        else:
            raise ValueError(f"schedule must be gpipe|1f1b, got {schedule!r}")

        def train_step(state: TrainState, batch: dict):
            state.optimizer.zero_grad(set_to_none=True)
            micro_ids = self._microbatch(batch["input_ids"], self.n_micro)
            micro_labels = self._microbatch(batch["labels"], self.n_micro)
            loss = run(micro_ids, micro_labels, loss_fn)
            state.optimizer.step()
            state.step += 1
            return state, replicate(self.pp, loss, self.n_stages - 1)

        return train_step

    def _gpipe_grads(self, micro_ids, micro_labels, loss_fn) -> torch.Tensor:
        """GPipe: every microbatch's graph kept on its stage, the last
        stage's outputs each microbatch's share of the batch's mean loss;
        returns the loss (zero but on the last stage)."""
        positions, like = self._positions(micro_ids), self._like(micro_ids)

        def run(m, x):
            y = self._stage(x, positions)
            if not self.last:
                return y
            return loss_fn(self._head(y), micro_labels[m]) / self.n_micro

        graphs = forward_ticks(self.pp, self.n_micro, lambda m: self._embed(micro_ids[m]), run,
                               like, track=True)
        loss = torch.zeros((), device=self.device)
        if self.last:
            loss = torch.stack([out.detach() for _, out in graphs]).sum()
        backward_ticks(self.pp, graphs, lambda m: None, like)
        return loss

    def _one_f_one_b_grads(self, micro_ids, micro_labels, loss_fn) -> torch.Tensor:
        """1F1B: the first stage embeds every microbatch (as the
        reference's embedder vjp over the whole stream) and backpropagates
        the input gradients the schedule hands back; returns the loss."""
        positions, like = self._positions(micro_ids), self._like(micro_ids)
        hidden = self._embed(micro_ids) if self.first else None
        loss, dxs, _ = one_f_one_b(
            self.pp, self.n_micro, lambda m: hidden[m].detach(),
            lambda x: self._stage(x, positions), like,
            objective=lambda m, y: loss_fn(self._head(y), micro_labels[m]),
            head_params=list(self._head.parameters()) if self.last else [],
            input_grads=self.first)
        if self.first:
            hidden.backward(torch.stack(dxs))
        return loss
