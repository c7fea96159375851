"""Serving-engine sampling and the decode dispatch (one step or a block).

Counterpart of the reference's ``models/engine_sampling.py``: the per-row
top-k/top-p filter, the emitted token's logprob under the unscaled
distribution, the page-table view derived from each slot's full page
chain, and the decode dispatch, its ``build_step_fn`` (T = 1) and
``build_block_fn`` (T > 1) in one function, with greedy, temperature and
top-k/top-p sampling, a per-slot sparse logit bias on what is picked, and
logprobs when a slot asks.  Random draws follow the reference's key schedule
through jax's threefry (``utils/prng.py``): a sampled dispatch splits its
key once, samples from the subkey (a step) or from ``split(subkey, T)`` (a
block), and returns the other half as the next dispatch's key.
"""

from __future__ import annotations

import torch

from ..utils import prng
from .transformer import NEG_LOGIT, PagedCache


def token_logprob(row, nxt):
    """The emitted tokens' logprobs under the UNSCALED model distribution
    of ``row`` [batch, vocab] (the sampler settings and the bias change
    what is picked, not what is reported)."""
    lp = torch.log_softmax(row.float(), dim=-1)
    return torch.gather(lp, 1, nxt[:, None].long())[:, 0]


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


def pick(row, key, temps=None, topks=None, topps=None):
    """Next token per row of ``row`` [batch, vocab] float32 logits: argmax
    where ``temps`` <= 0, else ``prng.categorical`` under ``key`` of the
    logits at that temperature (after the top-k/top-p filter when
    ``topks``/``topps`` are given), as the reference's step picks.
    ``temps`` None: every row greedy, and ``key`` is not read."""
    greedy = row.argmax(dim=-1)
    if temps is None:
        return greedy
    scaled = row / torch.where(temps > 0, temps, 1.0)[:, None]
    if topks is not None:
        scaled = filter_top_k_top_p(scaled, topks, topps)
    return torch.where(temps > 0, prng.categorical(key, scaled), greedy)


def decode_tokens(model, cache: PagedCache, chain, tokens, positions, key, T: int = 1,
                  temps=None, topks=None, topps=None, bias_ids=None, bias_vals=None,
                  want_lp: bool = False, adapter_ids=None):
    """T exact single-token decode steps over every slot (T = 1: the
    reference's step; T > 1: its block, a scan of such steps): each step
    derives the visible page table from ``chain`` [slots, max_pages_per_seq]
    at its position, runs the model on ``tokens``/``positions`` [slots, 1]
    (the append lands at the carried ``seq_lens``), and picks each slot's
    next token with a fresh key.  ``temps`` None = every slot greedy.
    ``bias_ids``/``bias_vals`` [slots, MAX_BIAS]: added to the logits the
    pick reads (padding is id 0 with 0.0).  ``want_lp``: also return each
    token's :func:`token_logprob` of the unbiased logits.  ``adapter_ids``
    [slots]: each slot's stacked adapter (multi-LoRA engines; -1 = base).

    Returns ``(out [slots, T], logprobs [slots, T] float32 or None,
    next_tokens [slots, 1], next_positions [slots, 1], next_key)``: the
    tokens, then the next dispatch's inputs.

    A greedy dispatch neither draws nor splits, and returns its key as it
    came: the carried key feeds only sampled dispatches, and the sampler
    variant changes only at a state rebuild, which takes a fresh key from
    the engine's, so the streams are the reference's and the step is spared
    the hash's ~170 small kernels."""
    if temps is None:
        step_keys = [None] * T
    else:
        key, sub = prng.split(key)
        step_keys = [sub] if T == 1 else prng.split(sub, T)
    page_size = model.config.paged.page_size
    out, lps = [], []
    for j in range(T):
        cache.page_table = _derived_tables(chain, positions, page_size)
        row = model(tokens, positions, cache=cache, adapter_ids=adapter_ids)[:, -1]
        picked = row if bias_ids is None else row.scatter_add(1, bias_ids, bias_vals.to(row.dtype))
        nxt = pick(picked, step_keys[j], temps, topks, topps)
        out.append(nxt)
        if want_lp:
            lps.append(token_logprob(row, nxt))
        tokens, positions = nxt[:, None], positions + 1
    logprobs = torch.stack(lps, dim=1) if want_lp else None
    return torch.stack(out, dim=1), logprobs, tokens, positions, key
