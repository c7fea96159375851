"""LoRA: low-rank adapters on the transformer's dense sites, in PyTorch.

Counterpart of the reference's ``models/lora.py`` for serving:

- :class:`LoRADense` (``GPTConfig(lora_rank=r)``): a base ``kernel`` plus
  ``lora_a`` [*contract, r] and ``lora_b`` [r, *features], computing
  ``x·W + (alpha/r)·(x·A)·B`` in the site's dtype;
- :class:`MultiLoRADense` (``GPTConfig(lora_rank=r, lora_serve=n)``): one
  base ``kernel`` and ``n`` stacked adapters ``lora_a_stack`` [n, *contract,
  r] / ``lora_b_stack`` [n, r, *features]; each row of the batch picks its
  adapter from ``adapter_ids`` [batch] (-1 = the base model alone), so many
  fine-tunes share one set of base weights and one dispatch;
- :func:`stack_lora_adapters`, :func:`lora_rank_of` and
  :func:`merge_lora_params` over the port's flat state dicts (flax path
  names, so ``convert.py`` carries a flax tree in with no transpose).

The per-row delta is the reference's function, ``(x·A_i)·B_i·alpha/rank``
for a row on adapter i and exactly the base result for a -1 row, computed
as two plain products over the stacked adapters instead of the
reference's gather and two batched products: ``x·[A_0 .. A_n-1]`` gives
every adapter's down-projection, a one-hot mask of each row's adapter
zeroes the others, and ``·[B_0; ..; B_n-1]`` sums the row's own rank
columns with exact zeros.  The reason is the card: cuBLAS picks a split-K
for a batched product by its batch count, so a row's delta there depends on
how many requests share its prefill, and two servers of one model would
part on a near-tie; a plain product keeps each row's sums whatever the row
count (measured on the H100 at every bf16 site width; PERF.md §6).  The
reference leaves these products to XLA (no Pallas kernel computes them),
so here they are ``torch`` products.  Their cost: a step reads every
stacked adapter, n·rank·(in+out) weights a site, where the gather reads
rank·(in+out) a row; at the deployed widths a site's dozen small kernels
set its device time, not n (PERF.md §5: 4 to 32 adapters add 5 %, and
32 stacked cost what the gather does).

Training the adapters: :func:`lora_labels` names each parameter ``"lora"``
or ``"frozen"``, and :func:`make_lora_tx` turns an optimizer factory into
one over the adapters alone (the reference's ``optax.multi_transform`` with
``set_to_zero`` on the base), for ``models/train.py``'s step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Sequence

import torch
from torch import nn


def _flat(x: torch.Tensor, n_in: int, dtype) -> torch.Tensor:
    """``x`` [..., *in] as [rows, n_in] in ``dtype``."""
    return x.reshape(-1, n_in).to(dtype)


class LoRADense(nn.Module):
    """DenseGeneral with a base ``kernel`` plus ``lora_a``·``lora_b``."""

    def __init__(self, in_shape: tuple, features: tuple, rank: int, alpha: float, dtype,
                 device=None):
        super().__init__()
        self.in_shape, self.features = tuple(in_shape), tuple(features)
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.features, dtype=dtype,
                                               device=device))
        self.lora_a = nn.Parameter(torch.empty(*self.in_shape, rank, dtype=dtype, device=device))
        self.lora_b = nn.Parameter(torch.empty(rank, *self.features, dtype=dtype, device=device))

    def forward(self, x):
        lead = x.shape[: x.dim() - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.features)
        xd = _flat(x, n_in, self.dtype)
        base = xd @ self.kernel.reshape(n_in, n_out).to(self.dtype)
        down = xd @ self.lora_a.reshape(n_in, self.rank).to(self.dtype)
        up = down @ self.lora_b.reshape(self.rank, n_out).to(self.dtype)
        return (base + (self.alpha / self.rank) * up).reshape(*lead, *self.features)


class MultiLoRADense(nn.Module):
    """A dense site serving ``n_adapters`` stacked adapters side by side;
    ``forward(x, adapter_ids)`` with x [batch, ..., *in] and adapter_ids
    [batch] (-1 = no adapter)."""

    def __init__(self, in_shape: tuple, features: tuple, rank: int, n_adapters: int,
                 alpha: float, dtype, device=None):
        super().__init__()
        self.in_shape, self.features = tuple(in_shape), tuple(features)
        self.rank, self.n_adapters, self.alpha, self.dtype = rank, n_adapters, alpha, dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.features, dtype=dtype,
                                               device=device))
        self.lora_a_stack = nn.Parameter(
            torch.empty(n_adapters, *self.in_shape, rank, dtype=dtype, device=device))
        self.lora_b_stack = nn.Parameter(
            torch.empty(n_adapters, rank, *self.features, dtype=dtype, device=device))

    def forward(self, x, adapter_ids=None):
        if adapter_ids is None:
            raise ValueError(
                "MultiLoRADense needs adapter_ids [batch] (-1 = no adapter); pass "
                "adapter_ids= through the model's forward"
            )
        batch = x.shape[0]
        keep = x.shape[1 : x.dim() - len(self.in_shape)]
        n, r = self.n_adapters, self.rank
        n_in, n_out = math.prod(self.in_shape), math.prod(self.features)
        xd = _flat(x, n_in, self.dtype)
        base = xd @ self.kernel.reshape(n_in, n_out).to(self.dtype)
        a_cat = self.lora_a_stack.reshape(n, n_in, r).permute(1, 0, 2).reshape(n_in, n * r)
        b_cat = self.lora_b_stack.reshape(n * r, n_out)
        # Each row's own adapter block of rank columns (none for a -1 row,
        # whose delta is then exactly zero).
        own = adapter_ids.long()[:, None] == torch.arange(n, device=x.device)[None, :]
        mask = own.to(self.dtype).repeat_interleave(r, dim=1)  # [b, n*r]
        down = (xd @ a_cat.to(self.dtype)).reshape(batch, -1, n * r) * mask[:, None, :]
        up = down.reshape(-1, n * r) @ b_cat.to(self.dtype)  # [rows, n_out]
        out = base + (self.alpha / self.rank) * up
        return out.reshape(batch, *keep, *self.features)


def site_call(mod: nn.Module, x, adapter_ids):
    """Apply a dense site: a multi-LoRA site takes the per-row adapter
    ids, every other kind the plain one-argument call (the reference's
    ``_site_call``)."""
    if isinstance(mod, MultiLoRADense):
        return mod(x, adapter_ids)
    return mod(x)


def _sites(params: Mapping, leaf: str) -> list[str]:
    """The site prefixes (``layer_0.attn.query``) holding ``leaf``."""
    suffix = "." + leaf
    return sorted(name[: -len(suffix)] for name in params if name.endswith(suffix))


def stack_lora_adapters(base_params: Mapping, adapter_trees: Sequence[Mapping]) -> dict:
    """The :class:`MultiLoRADense` serving state dict from ``n`` trained
    LoRA state dicts (``GPTConfig(lora_rank=r)`` layouts) over one base:
    every site gains ``lora_a_stack``/``lora_b_stack`` stacked in
    ``adapter_trees`` order (ids follow that order at submit time), base
    kernels come from ``base_params`` (plain or LoRA layout), and the
    trees must agree on rank."""
    if not adapter_trees:
        raise ValueError("need at least one adapter tree")
    sites = sorted({s for tree in adapter_trees for s in _sites(tree, "lora_a")})
    out = {k: v for k, v in base_params.items() if not k.endswith((".lora_a", ".lora_b"))}
    for site in sites:
        a_s = [tree[f"{site}.lora_a"] for tree in adapter_trees]
        b_s = [tree[f"{site}.lora_b"] for tree in adapter_trees]
        ranks = {int(a.shape[-1]) for a in a_s}
        if len(ranks) != 1:
            raise ValueError(f"adapter ranks disagree: {sorted(ranks)}")
        out[f"{site}.lora_a_stack"] = torch.stack(list(a_s))
        out[f"{site}.lora_b_stack"] = torch.stack(list(b_s))
    return out


def lora_rank_of(params: Mapping) -> int:
    """Rank of the adapters in a LoRA state dict (``lora_a``) or a stacked
    serving one (``lora_a_stack``): the value config flags must agree with
    (a wrong rank mis-scales every delta by alpha/rank)."""
    found = [int(v.shape[-1]) for k, v in params.items()
             if k.endswith((".lora_a", ".lora_a_stack"))]
    if not found:
        raise ValueError("tree has no LoRA adapters (no lora_a leaves)")
    ranks = set(found)
    if len(ranks) != 1:
        raise ValueError(f"adapter ranks disagree across sites: {sorted(ranks)}")
    return found[0]


def merge_lora_params(params: Mapping, *, alpha: float) -> dict:
    """Fold every adapter pair into its base kernel and drop the adapters:
    ``kernel + (alpha/rank)·A·B`` (contracted over rank, in float32, cast
    back to the kernel's type): the plain layout serving, and
    ``ops.quant.quantize_lm_params``, expect.  ``alpha`` is required: rank
    is in the shapes, alpha is not."""
    out = dict(params)
    for site in _sites(params, "lora_a"):
        a, b = out.pop(f"{site}.lora_a"), out.pop(f"{site}.lora_b")
        kernel = params[f"{site}.kernel"]
        rank = a.shape[-1]
        delta = torch.tensordot(a.float(), b.float(), dims=1)
        out[f"{site}.kernel"] = (kernel.float() + (alpha / rank) * delta).to(kernel.dtype)
    return out


ADAPTER_LEAVES = ("lora_a", "lora_b")


def lora_labels(params: Mapping) -> dict[str, str]:
    """Label each parameter by name: ``"lora"`` on adapter leaves
    (``lora_a``/``lora_b``), ``"frozen"`` elsewhere (the reference's
    ``lora_labels`` over a flat state dict or ``named_parameters()``)."""
    return {name: "lora" if name.rsplit(".", 1)[-1] in ADAPTER_LEAVES else "frozen"
            for name in params}


def make_lora_tx(inner: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]
                 ) -> Callable[[nn.Module], torch.optim.Optimizer]:
    """An optimizer factory that trains only the adapters: ``tx(model)``
    builds ``inner`` (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-2,
    weight_decay=1e-4)``) over the ``"lora"`` parameters and freezes the
    rest (``requires_grad`` off), so the base gets no gradient, no update
    and no weight decay: the reference's ``set_to_zero`` on the frozen
    label, not the raw gradient that a plain mask would pass through.
    Optimizer state exists only for the adapters."""

    def tx(model: nn.Module) -> torch.optim.Optimizer:
        labels = lora_labels(dict(model.named_parameters()))
        adapters = []
        for name, param in model.named_parameters():
            if labels[name] == "lora":
                adapters.append(param)
            else:
                param.requires_grad_(False)
        if not adapters:
            raise ValueError("the model has no LoRA adapters (lora_a/lora_b parameters)")
        return inner(adapters)

    return tx
