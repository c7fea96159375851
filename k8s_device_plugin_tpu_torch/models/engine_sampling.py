"""Serving-engine sampling and the single-token decode step.

Counterpart of the reference's ``models/engine_sampling.py``: the per-row
top-k/top-p filter, the page-table view derived from each slot's full page
chain, and the decode step (the reference's ``build_step_fn``) with greedy,
temperature, top-k and top-p sampling.  Random draws come from an explicit
``torch.Generator``: sampled streams are deterministic under a fixed seed
but do not reproduce jax's threefry stream; greedy streams match.
"""

from __future__ import annotations

import torch

from .transformer import NEG_LOGIT, PagedCache


def filter_top_k_top_p(scaled, top_k, top_p):
    """Mask ``scaled`` logits [batch, vocab] to each row's top-k tokens and
    smallest nucleus with mass >= top_p, with per-row ``top_k`` (int, vocab
    = off) and ``top_p`` (float, 1.0 = off).  One descending sort per row:
    the k-th value is the top-k threshold, the smallest value still inside
    the nucleus (computed on the top-k-filtered distribution) the top-p
    one; ``scaled >= threshold`` keeps ties."""
    vocab = scaled.shape[-1]
    s_sorted = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(vocab, device=scaled.device)[None, :]
    k = top_k.clamp(1, vocab)[:, None].long()
    kth = torch.gather(s_sorted, 1, k - 1)
    in_k = ranks < k
    probs = torch.softmax(torch.where(in_k, s_sorted, NEG_LOGIT), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # A rank is in the nucleus while the mass BEFORE it is < p, so the
    # first token is always kept.
    in_p = in_k & ((cum - probs) < top_p[:, None])
    p_min = torch.where(in_p, s_sorted, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled >= torch.maximum(kth, p_min), scaled, NEG_LOGIT)


def _derived_tables(chain, pos, page_size):
    """The visible page table: entries covering positions [0, pos] show the
    slot's real page, later entries scratch page 0, so the kernel never
    reads a generation page before it is written."""
    mpp = chain.shape[1]
    visible = torch.arange(mpp, device=chain.device)[None, :] <= pos[:, 0:1] // page_size
    return torch.where(visible, chain, 0)


def sample(row, temps, generator, topks=None, topps=None):
    """Next token per row of ``row`` [batch, vocab] float32 logits: argmax
    where ``temps`` <= 0, else a categorical draw at that temperature
    (after the top-k/top-p filter when ``topks``/``topps`` are given) by
    the Gumbel-max trick, as jax.random.categorical draws."""
    greedy = row.argmax(dim=-1)
    if temps is None:
        return greedy
    scaled = row / torch.where(temps > 0, temps, 1.0)[:, None]
    if topks is not None:
        scaled = filter_top_k_top_p(scaled, topks, topps)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def decode_step(model, cache: PagedCache, chain, tokens, positions, temps=None,
                generator=None, topks=None, topps=None):
    """One single-token decode step over every slot: derive the visible
    page table from ``chain`` [slots, max_pages_per_seq], run the model on
    ``tokens``/``positions`` [slots, 1] (the append lands at the carried
    ``seq_lens``), and pick each slot's next token.  ``temps`` None = every
    slot greedy (no random draws).  Returns next tokens [slots] int64."""
    cache.page_table = _derived_tables(chain, positions, model.config.paged.page_size)
    row = model(tokens, positions, cache=cache)[:, -1]
    return sample(row, temps, generator, topks, topps)
