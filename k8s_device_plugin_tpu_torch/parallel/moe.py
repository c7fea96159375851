"""Mixture-of-experts with expert parallelism, GShard/Switch style.

Counterpart of the reference's ``parallel/moe.py``, with its arithmetic:
a float32 router and softmax; top-k selection in k rounds of ``argmax``
(the first maximum, as jax's); each token's position in its expert's
buffer from a cumsum over the sequence plus the expert's fill from earlier
rounds; capacity ``ceil(capacity_factor * s / e)`` per group (one
sequence), over-capacity tokens falling through the residual; the kept
gates renormalised to sum to 1; a dense one-hot dispatch in ``x.dtype``;
the Switch auxiliary loss ``e * sum(f * P)``; and the dense einsums
``gsec,gsd->egcd`` -> SwiGLU -> ``gsec,egcd->gsd``.  The reference leaves
these products to XLA outside any Pallas kernel, so here they are
``torch.einsum``.

Where flax sows the auxiliary loss into ``intermediates``, the layer keeps
it as ``aux_loss`` (the tensor of its last forward), which
``models/train.sown_aux_loss`` collects.

Each stage runs under a profiler range (``PHASES``: ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a trace can part
the layer's device time by stage.

Expert parallelism (:class:`ExpertParallel`, over a ``(dp, ep, tp)``
mesh): each rank holds ``e / ep`` experts and ``ffn / tp`` of each one's
width (``tensor._TP_RULES``' ``experts_*`` rows).  Routing is whole on
every rank (the router is replicated); a rank dispatches to its own
experts only, so its output is a partial sum over experts and ffn slices
that the group of one dp replica's ``ep x tp`` ranks sums (g).  The
tokens entering the experts and the combine weights pass through f, whose
backward sums every rank's part of their gradients; the router's input
and the auxiliary loss take no reduction, being whole on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from torch.profiler import record_function

from .tensor import TensorParallel, tp_spec_for

# The profiler ranges of a forward's stages, in order.
PHASES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@dataclass
class ExpertParallel:
    """One rank's expert parallelism: ``group`` over the ``ep x tp`` ranks
    of its dp replica (the MoE output's reduction), and its ``ep`` degree
    and index on the ``ep`` axis (the ``tp`` ones are the model's)."""

    group: TensorParallel
    ep: int
    ep_rank: int


def expert_layout(num_experts: int, hidden: int, ffn: int, tp=None, ep=None) -> tuple:
    """``(experts, first expert, ffn, group)`` one rank holds: split by the
    ``experts_*`` rules over ``ep`` and ``tp`` when both axes are there and
    divide, else whole (group None), as the reference's rules fall back."""
    if ep is None:
        return num_experts, 0, ffn, None
    tp_size = 1 if tp is None else tp.size
    sizes = {"ep": ep.ep, "tp": tp_size}
    if tp_spec_for("experts_gate", (num_experts, hidden, ffn), sizes) == ():
        return num_experts, 0, ffn, None
    n = num_experts // ep.ep
    return n, ep.ep_rank * n, ffn // tp_size, ep.group


class MoeMlp(nn.Module):
    """Drop-in replacement for ``SwiGluMlp``.  Parameters (the reference's
    names and shapes): ``router.kernel`` [hidden, experts] (replicated),
    ``experts_gate``/``experts_up`` [experts, hidden, ffn] and
    ``experts_down`` [experts, ffn, hidden] (split over ep and tp)."""

    NAME = "moe"

    def __init__(self, cfg, num_experts: int = 8, experts_per_token: int = 2,
                 capacity_factor: float = 1.25, device=None, tp=None, ep=None):
        super().__init__()
        from ..models.transformer import DenseGeneral

        self.cfg = cfg
        self.num_experts, self.experts_per_token = num_experts, experts_per_token
        self.capacity_factor = capacity_factor
        d = cfg.hidden_size
        n, self.first, f, self.group = expert_layout(num_experts, d, cfg.intermediate_size,
                                                     tp, ep)
        self.local = n
        self.router = DenseGeneral((d,), (num_experts,), torch.float32, device)
        self.experts_gate = nn.Parameter(torch.empty(n, d, f, dtype=cfg.dtype, device=device))
        self.experts_up = nn.Parameter(torch.empty(n, d, f, dtype=cfg.dtype, device=device))
        self.experts_down = nn.Parameter(torch.empty(n, f, d, dtype=cfg.dtype, device=device))
        self.aux_loss: Optional[torch.Tensor] = None
        # The (token, choice) assignments the last forward dropped at
        # capacity (a tensor) and how many it made, for what a step reports.
        self.dropped: Optional[torch.Tensor] = None
        self.assigned = 0

    def capacity(self, seq: int) -> int:
        return max(1, math.ceil(self.capacity_factor * seq / self.num_experts))

    def route(self, x: torch.Tensor) -> tuple:
        """``(combine [g, s, e, c] float32, probs [g, s, e] float32)`` for
        ``x`` [g, s, d]: the reference's k rounds."""
        g, s, _ = x.shape
        e, c = self.num_experts, self.capacity(s)
        probs = torch.softmax(self.router(x.float()), dim=-1)
        combine = x.new_zeros((g, s, e, c), dtype=torch.float32)
        remaining = probs
        fill = torch.zeros((g, e), dtype=torch.int32, device=x.device)
        for _ in range(self.experts_per_token):
            choice = remaining.argmax(dim=-1)
            onehot = nn.functional.one_hot(choice, e).float()
            # Each token's place in its expert's buffer this round: earlier
            # tokens of the sequence fill earlier slots.
            pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
            pos_tok = (pos * onehot).sum(dim=-1).to(torch.int32)
            keep = (pos_tok < c).float()
            weight = (remaining * onehot).sum(dim=-1) * keep
            slot = nn.functional.one_hot(pos_tok.clamp(max=c - 1).long(), c).float()
            combine = combine + weight[..., None, None] * onehot[..., :, None] * slot[..., None, :]
            fill = fill + (onehot * keep[..., None]).sum(dim=1).to(torch.int32)
            remaining = remaining * (1.0 - onehot)
        total = combine.sum(dim=(-2, -1), keepdim=True)
        combine = torch.where(total > 0, combine / total.clamp_min(1e-9), 0.0)
        return combine, probs

    def forward(self, x):
        cfg = self.cfg
        squeeze = x.dim() == 2
        if squeeze:  # tolerate [tokens, hidden] by adding a group dim
            x = x[None]
        with record_function("moe.route"):
            combine, probs = self.route(x)
            dispatch = (combine > 0).to(x.dtype)  # [g, s, e, c]
            # Switch load-balance loss: e * sum over experts of (the mean
            # share of tokens sent there) x (the mean router probability),
            # mean over groups.
            frac_tokens = dispatch.sum(dim=-1).mean(dim=1)
            frac_probs = probs.mean(dim=1)
            self.aux_loss = (frac_tokens * frac_probs).sum(dim=-1).mean() * self.num_experts
            with torch.no_grad():
                self.assigned = x.shape[0] * x.shape[1] * self.experts_per_token
                self.dropped = self.assigned - dispatch.sum(dtype=torch.float32)
            x_in = x
            if self.group is not None:
                combine, x_in = self.group.copy(combine), self.group.copy(x)
            mine = slice(self.first, self.first + self.local)
            combine, dispatch = combine[:, :, mine], dispatch[:, :, mine]
        with record_function("moe.dispatch"):
            expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x_in)
        with record_function("moe.experts"):
            w_gate, w_up, w_down = (w.to(cfg.dtype) for w in
                                    (self.experts_gate, self.experts_up, self.experts_down))
            gate = torch.einsum("egcd,edf->egcf", expert_in, w_gate)
            up = torch.einsum("egcd,edf->egcf", expert_in, w_up)
            expert_out = torch.einsum("egcf,efd->egcd", nn.functional.silu(gate) * up, w_down)
        with record_function("moe.combine"):
            out = torch.einsum("gsec,egcd->gsd", combine.to(expert_out.dtype), expert_out)
            if self.group is not None:
                out = self.group.reduce(out)
            out = out.to(cfg.dtype)
        return out[0] if squeeze else out


def moe_mlp_factory(config, num_experts: int = 8, experts_per_token: int = 2,
                    capacity_factor: float = 1.25):
    """``mlp_factory`` for ``models.transformer.TransformerLM``:
    ``TransformerLM(cfg, mlp_factory=moe_mlp_factory(cfg, 8))`` builds a
    fully MoE decoder."""

    def factory(device=None, tp=None, ep=None):
        return MoeMlp(config, num_experts=num_experts, experts_per_token=experts_per_token,
                      capacity_factor=capacity_factor, device=device, tp=tp, ep=ep)

    factory.num_experts = num_experts
    return factory


def init_moe_params(config, num_experts: int = 8, seed: int = 0) -> dict:
    """Random float32 parameters of the MoE LM (``init_params``' stand-in
    for a checkpoint): the dense LM's from ``seed`` with each block's MLP
    replaced by a router and ``num_experts`` experts, normal with variance
    1/fan_in (fan_in the contracted width)."""
    from ..models.transformer import init_params

    params = {k: v for k, v in init_params(config, seed).items() if ".mlp." not in k}
    gen = torch.Generator().manual_seed(seed + 1)
    d, f, e = config.hidden_size, config.intermediate_size, num_experts
    for i in range(config.num_layers):
        p = f"layer_{i}.moe."
        for name, shape, fan_in in (("router.kernel", (d, e), d), ("experts_gate", (e, d, f), d),
                                    ("experts_up", (e, d, f), d),
                                    ("experts_down", (e, f, d), f)):
            params[p + name] = torch.randn(shape, generator=gen) * fan_in ** -0.5
    return params
