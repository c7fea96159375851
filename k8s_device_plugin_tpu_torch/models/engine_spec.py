"""Serving-engine speculative decoding: shared-pool self-speculation.

Counterpart of the reference's ``models/engine_spec.py``.  :func:`spec_round`
is the device half (its ``build_spec_rounds``: the greedy-only round when
``temps`` is None, else the sampled/mixed round), a plain function on
tensors that ``ServingEngine`` runs eagerly or, on the card, replays as a
CUDA graph; :class:`SpeculativeMixin` is the host half.

The draft is the target's own architecture in another weight format (the
``w8`` self-draft), so both address the one page pool: gamma single-token
draft steps (the paged kernel) write approximate K/V at L..L+gamma-1, the
carried ``seq_lens`` is rewound IN PLACE to L, and one (gamma+1)-token
target pass (the gathered page view, as the reference's verify) overwrites
L..L+gamma with exact K/V before any later read.  Acceptance is computed on
the device; only ``[slots, gamma+1]`` tokens and ``a[slots]`` come back.
"""

from __future__ import annotations

import time

import torch

from ..utils import prng
from ..utils.spans import ENGINE_TRACE
from . import speculative
from .engine_sampling import _derived_tables, filter_top_k_top_p
from .engine_types import Request


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` [slots, n, vocab] at row-wise index ``idx`` [slots]: [slots, vocab]."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def spec_round(model, draft_model, cache, chain, tokens, positions, gamma: int, temps=None,
               topks=None, topps=None, key=None):
    """One speculative round for every slot at once.

    ``tokens``/``positions`` [slots, 1] (positions = each row's length L);
    ``chain`` [slots, max_pages_per_seq] the slots' page chains.  gamma
    draft steps propose d_1..d_gamma per slot; one (gamma+1)-token target
    pass scores [last, d_1..d_gamma] at L..L+gamma.  Greedy rows (``temps``
    None, or a row's temperature <= 0) accept the longest prefix agreeing
    with the target's argmax; sampled rows run acceptance-rejection over
    the row's temperature/top-k/top-p filter, with ``kd, ka, kt =
    split(key, 3)`` and ``fold_in(kd, i)`` per draft step (the reference's
    schedule).  Returns ``(emitted [slots, gamma+1], a [slots])``: row s's
    tokens are ``emitted[s, :a[s] + 1]``; the carried ``seq_lens`` is left
    at L+gamma+1 for the host to realign."""
    page_size = model.config.paged.page_size
    sampled = temps is not None
    if sampled:
        kd, ka, kt = prng.split(key, 3)
        sampling = temps > 0
        safe_t = torch.where(sampling, temps, 1.0)[:, None]
    tok, props, qs = tokens, [], []
    for i in range(gamma):
        pos = positions + i
        cache.page_table = _derived_tables(chain, pos, page_size)
        row = draft_model(tok, pos, cache=cache)[:, -1]
        nxt = row.argmax(dim=-1)
        if sampled:
            filt = filter_top_k_top_p(row / safe_t, topks, topps)
            nxt = torch.where(sampling, prng.categorical(prng.fold_in(kd, i), filt), nxt)
            qs.append(torch.softmax(filt, dim=-1))  # the draft's Q_i
        props.append(nxt)
        tok = nxt[:, None]
    props = torch.stack(props, dim=1)  # [slots, gamma]
    # The draft advanced every row's seq_lens to L+gamma: rewind to L in
    # place (a captured graph holds this buffer's address).
    cache.seq_lens.copy_(positions[:, 0])
    block = torch.cat([tokens, props], dim=1)
    steps = torch.arange(gamma + 1, device=tokens.device)
    cache.page_table = _derived_tables(chain, positions + gamma, page_size)
    v_logits = model(block, positions + steps[None, :], cache=cache)  # [slots, gamma+1, V]
    t_greedy = v_logits.argmax(dim=-1)
    match = (props == t_greedy[:, :gamma]).long()
    a = torch.cumprod(match, dim=1).sum(dim=1)
    tail = t_greedy.gather(1, a[:, None])[:, 0]
    if sampled:
        slots, vocab = v_logits.shape[0], v_logits.shape[2]
        v_filt = filter_top_k_top_p(
            (v_logits / safe_t[..., None]).reshape(-1, vocab),
            topks.repeat_interleave(gamma + 1), topps.repeat_interleave(gamma + 1),
        ).reshape(slots, gamma + 1, vocab)
        p = torch.softmax(v_filt, dim=-1)  # the target's P_j
        q = torch.stack(qs, dim=1)  # [slots, gamma, V]
        p_d = p[:, :gamma].gather(2, props[..., None])[..., 0]
        q_d = q.gather(2, props[..., None])[..., 0]
        u = prng.uniform(ka, (slots, gamma))
        a_s = torch.cumprod(speculative.accept_draws(u, q_d, p_d).long(), dim=1).sum(dim=1)
        a = torch.where(sampling, a_s, a)
        # The token at position a: sampled rows draw from the residual
        # max(0, P_a - Q_a) (a full accept: Q_gamma := 0, so P_gamma).
        p_a = _at(p, a)
        q_a = _at(torch.cat([q, torch.zeros_like(q[:, :1])], dim=1), a)
        resid = torch.where((a < gamma)[:, None], (p_a - q_a).clamp_min(0.0), p_a)
        norm = resid.sum(dim=-1, keepdim=True)
        tail_p = torch.where(norm > 0, resid / norm, p_a)
        tail_s = prng.categorical(kt, torch.log(tail_p))
        tail = torch.where(sampling, tail_s, t_greedy.gather(1, a[:, None])[:, 0])
    props_pad = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    emitted = torch.where(steps[None, :] < a[:, None], props_pad, tail[:, None])
    return emitted, a


class SpeculativeMixin:
    """Host half of a speculative round, mixed into ServingEngine (which
    owns every attribute referenced here)."""

    def _spec_body(self, sampled: bool) -> None:
        """One round from the buffers into ``_spec_out``/``_spec_a``: what
        a CUDA graph of the round captures."""
        bufs = self._bufs
        kw = {}
        if sampled:
            kw = dict(temps=bufs["temps"], topks=bufs["topks"], topps=bufs["topps"],
                      key=bufs["key"])
        emitted, a = spec_round(self.model, self.draft_model, self.cache, self._chain,
                                bufs["tokens"], bufs["positions"], self._spec_gamma, **kw)
        self._spec_out.copy_(emitted)
        self._spec_a.copy_(a)
        if self._tp is not None:
            # Every rank decided from the same gathered logits and key; the
            # leader's tokens and acceptance win, as the decode step's do.
            self._tp.broadcast(self._spec_out)
            self._tp.broadcast(self._spec_a)

    def _op_spec(self, tokens: list, positions: list, sampling, key) -> None:
        """One round (:meth:`_spec_body`, eagerly or a graph replay) from
        host truth: each slot's last token and length and, for a sampled
        round, ``sampling`` = (temperatures, top-k, top-p) and the round's
        key (host ints on a mesh)."""
        bufs = self._bufs
        bufs["tokens"].copy_(torch.tensor(tokens)[:, None])
        bufs["positions"].copy_(torch.tensor(positions)[:, None])
        if sampling is not None:
            bufs["temps"].copy_(torch.tensor(sampling[0], dtype=torch.float32))
            bufs["topks"].copy_(torch.tensor(sampling[1]))
            bufs["topps"].copy_(torch.tensor(sampling[2], dtype=torch.float32))
            bufs["key"].copy_(torch.as_tensor(key))
        sampled = sampling is not None
        self._run_graphed(("spec", sampled), lambda: self._spec_body(sampled), "compile:spec_round")
        self.device_steps += self._spec_gamma

    def _spec_step(self, active: list[int], finished: list[Request]) -> list[Request]:
        """One speculative round: gamma draft steps plus one verify pass
        advance every active slot by 1..gamma+1 tokens.  Greedy slots emit
        exactly their non-speculative greedy decode, sampled slots marginally
        exact filtered target samples."""
        gamma = self._spec_gamma
        active = self._ensure_frontier(active, gamma)
        if not active:
            self._update_gauges()
            return finished
        round_t0 = time.monotonic()
        # Every round moves lengths by a data-dependent amount: its inputs
        # come from host truth, written into the buffers the graph reads.
        sampled = any(self.slots[s] is not None and self._slot_temp[s] > 0
                      for s in range(self.max_slots))
        sampling = key = None
        if sampled:
            sampling = (list(self._slot_temp), list(self._slot_topk), list(self._slot_topp))
            self._rng, sub = prng.split(self._rng)
            key = self._tp_key(sub)
        self._device_op("spec", list(self._slot_last), list(self._slot_len), sampling, key)
        self.spec_rounds += 1
        emitted = self._spec_out.tolist()
        a_vec = self._spec_a.tolist()
        self._mark("spec_verify")
        now = time.monotonic()
        if self.spans:
            # One engine-scoped span per round; acceptance beside its wall.
            self.spans.record_span(
                "spec.verify", ENGINE_TRACE, start_monotonic=round_t0, end_monotonic=now,
                attrs={"slots": len(active), "proposed": gamma * len(active),
                       "accepted": int(sum(a_vec[s] for s in active))},
            )
        emitted_total = 0
        for s in active:
            req = self.slots[s]
            a = int(a_vec[s])
            # d_1..d_a, then the target's own token at a.  All a+1 are
            # consumed unless a finish condition truncates the round.
            self.spec_proposed += gamma
            self.spec_accepted += a
            if self.metrics:
                self.metrics.spec_proposed.inc(gamma)
                self.metrics.spec_accepted.inc(a)
                if gamma > a:
                    self.metrics.spec_rejected.inc(gamma - a)
            consumed = 0
            for tok in emitted[s][: a + 1]:
                req.tokens.append(tok)
                self._slot_last[s] = tok
                consumed += 1
                if (
                    len(req.tokens) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self._hit_stop(req)
                ):
                    break
            self._slot_len[s] += consumed
            emitted_total += consumed
            self._observe_itl(s, consumed, now)
            self._maybe_finish(s)
            if req.done:
                finished.append(req)
            elif self.cfg.attention_window is not None:
                self._reclaim_windowed(s)
        # The round left every row's carried length at L+gamma+1: realign
        # all rows to host truth in place (idle and cleared rows are 0).
        self._repair_seq_lens()
        self._mark_state_dirty()
        self._mark("sample")
        self._step_tokens += emitted_total
        if self.metrics:
            self.metrics.steps.inc()
            self.metrics.tokens.inc(emitted_total)
        self._update_gauges()
        return finished
