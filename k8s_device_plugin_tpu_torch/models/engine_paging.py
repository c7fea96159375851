"""Serving-engine page pool, prefix trie and the prefill -> pages graft.

Counterpart of the reference's ``models/engine_paging.py``: under reserve
admission a request's whole page chain is allocated when it is admitted;
under optimistic admission only its prompt pages are, and generation
pages grow on demand (``_ensure_frontier``), a shortage preempting the
newest ready slot, which requeues at the head and resumes by recomputing
its effective prompt.  Page 0 is the scratch page idle rows write into,
full prompt pages are shared through a per-page trie keyed (parent page,
token chunk), and pages are refcounted and freed by their last user, or
retained for a later match when the KV tiers are on (engine_kvcache.py:
a dry pool reclaims them before it blocks or preempts, and a preempted
slot snapshots its tail for a restore-resume).  Every edit of the page
chain is in place, so a captured CUDA graph keeps reading it.  Mixed into
ServingEngine, which owns the state.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class PagingMixin:
    """Page allocation/free, the prefix-sharing trie, windowed
    reclamation, and the graft of prefilled rows into pages."""

    def _graft(self, slot: int, dense, pages: list[int], plen: int, n_shared: int, row_idx: int = 0):
        """Copy a prefilled dense cache's rows [n_shared*page_size, plen)
        into the slot's PRIVATE prompt pages (one indexed write per pool
        per layer) and record the slot's full chain and length.

        Shared prefix pages are never rewritten: another request is reading
        them.  Private pages are written whole; slots past plen carry
        zeros, which later appends overwrite before any read can see them.
        Under ``quant_kv`` the scale rows go with the codes: the prefill
        quantized them once, and nothing later re-derives a scale."""
        ps = self.paged.page_size
        n_cover = math.ceil(plen / ps)
        self._set_chain(slot, pages, plen)
        lo_tok = n_shared * ps
        n_priv = n_cover - n_shared
        if n_priv <= 0:
            return
        cover = torch.tensor(pages[n_shared:n_cover], dtype=torch.long, device=self.device)
        pad = n_cover * ps - plen
        for layer in range(self.cfg.num_layers):
            for pool, slab in zip(self.cache.layer(layer), dense.layer(layer)):
                if pool is None:  # float pools carry no scales
                    continue
                rows = slab[row_idx, lo_tok:plen]
                if pad:  # zero rows after plen, along the token axis
                    rows = torch.nn.functional.pad(rows, (0, 0) * (rows.dim() - 1) + (0, pad))
                pool[cover] = rows.reshape(n_priv, ps, *rows.shape[1:])

    def _set_chain(self, slot: int, pages: list[int], length: int) -> None:
        """Record a slot's full page chain and consumed length on the
        device (the dispatch derives the visible table from the chain)."""
        full = torch.zeros((self.paged.max_pages_per_seq,), dtype=torch.int32)
        full[: len(pages)] = torch.tensor(pages, dtype=torch.int32)
        self._chain[slot] = full.to(self.device)
        self.cache.seq_lens[slot] = length

    def _clear_slot(self, slot: int):
        self._chain[slot] = 0
        self.cache.seq_lens[slot] = 0
        for page in self._slot_pages[slot]:
            self._release_page(page)
        self._slot_pages[slot] = []
        self.slots[slot] = None
        self._slot_last[slot] = 0
        self._slot_len[slot] = 0
        self._slot_temp[slot] = 0.0
        self._slot_aid[slot] = -1
        self._slot_topk[slot] = self.cfg.vocab_size
        self._slot_topp[slot] = 1.0
        self._slot_bias_ids[slot] = [0] * self.MAX_BIAS
        self._slot_bias_vals[slot] = [0.0] * self.MAX_BIAS
        self._slot_page_base[slot] = 0
        self._slot_seq[slot] = 0
        self._slot_ready[slot] = False
        self._slot_emit_t[slot] = 0.0
        # Slot scalars changed: the step state is rebuilt from host truth.
        self._mark_state_dirty()

    def _release_page(self, page: int) -> None:
        """Drop one reference; at zero, either retain the page (trie links
        intact: the KV tier 1, reclaimed lazily when the pool runs dry) or
        tear down every trie link touching it and return it to the pool.
        The one page-free path."""
        with self._lock:
            self._page_refs[page] -= 1
            if self._page_refs[page] > 0:
                return
            if self._kv_retain and self._kv_retain_page(page):
                return  # refcount parks at 0; revived on the next match
            del self._page_refs[page]
            self._teardown_page_links(page)
            self.free_pages.append(page)

    def _teardown_page_links(self, page: int) -> None:  # caller holds: _lock
        """Remove the trie keys registered FOR a dying page and the keys in
        which it is the PARENT: a freed id can be reallocated with other
        content, and a surviving child link would lead a later prompt into
        another request's K/V."""
        for key in self._page_keys.pop(page, []):
            self._prefix_pages.pop(key, None)
            self._trie_version += 1
        for key in self._child_keys.pop(page, []):
            child = self._prefix_pages.pop(key, None)
            if child is not None:
                self._trie_version += 1
                keys = self._page_keys.get(child)
                if keys and key in keys:
                    keys.remove(key)

    @staticmethod
    def _trie_root(adapter: Optional[int]) -> int:
        """Root pseudo-parent of the prefix trie: -1 for the base model,
        -(2+i) for adapter i (the reference's roots; pseudo-roots are never
        real pages)."""
        return -1 if adapter is None else -(2 + adapter)

    def _match_prefix(self, prompt: list[int], bucket: int, burst_pages: dict[int, int],
                      adapter: Optional[int] = None) -> list[int]:
        """Longest chain of registered pages whose token chunks equal this
        prompt's leading FULL pages.  A page still waiting for its owner's
        graft is shared only within the same admission burst and length
        bucket: that job grafts every item before any of them decodes."""
        ps = self.paged.page_size
        pages: list[int] = []
        parent = self._trie_root(adapter)
        for i in range(len(prompt) // ps):
            page = self._prefix_pages.get((parent, tuple(prompt[i * ps : (i + 1) * ps])))
            if page is None:
                break
            if page in burst_pages:
                if burst_pages[page] != bucket:
                    break  # different bucket -> different job -> unsafe
            elif page in self._pending_pages:
                break  # owner's job from an earlier step not grafted yet
            pages.append(page)
            parent = page
        return pages

    def _register_prefix(self, eff: list[int], pages: list[int], n: int,  # caller holds: _lock
                         adapter: Optional[int] = None) -> None:
        """Register ``eff``'s first ``n`` full pages as trie links
        (idempotent: an existing key wins and the walk follows it).
        Callers: admission, the preemption snapshot, restore-resume and
        the handoff admission."""
        ps = self.paged.page_size
        parent = self._trie_root(adapter)
        for i in range(n):
            key = (parent, tuple(eff[i * ps : (i + 1) * ps]))
            if key not in self._prefix_pages:
                self._prefix_pages[key] = pages[i]
                self._page_keys.setdefault(pages[i], []).append(key)
                self._trie_version += 1
                if parent >= 0:
                    self._child_keys.setdefault(parent, []).append(key)
            parent = self._prefix_pages[key]

    def _ensure_frontier(self, active: list[int], lookahead: int) -> list[int]:
        """Make every coming write in [len, len + lookahead] addressable for
        each active slot (lookahead: 0 synchronous, 1 with a step in
        flight, T - 1 for a block, 2T - 1 with a block in flight).  The
        dispatch derives what a slot sees from its chain, so nothing is
        published here (the reference's ``_extend_frontier`` moves only a
        host watermark when tables are derived).

        Reserve admission allocated every page already.  Optimistic
        admission allocates here, oldest admission first; a dry pool
        preempts the newest ready slot newer than the one growing, and a
        slot still short after that is evicted itself (the oldest request
        is never robbed: liveness).  Returns the active slots minus the
        evicted."""
        if not self._optimistic:
            return active
        ps = self.paged.page_size
        for s in sorted(active, key=lambda x: self._slot_seq[x]):
            if self.slots[s] is None or not self._slot_ready[s]:
                continue  # evicted as a victim earlier in this pass
            need = (self._slot_len[s] + lookahead) // ps + 1
            while need > self._slot_page_base[s] + len(self._slot_pages[s]):
                with self._lock:
                    if not self.free_pages and self._kv_retained:
                        # Retained pages are reclaimable on demand: spill
                        # one to the host tier before robbing a newer slot.
                        self._kv_reclaim(1)
                    page = self.free_pages.popleft() if self.free_pages else None
                    if page is not None:
                        self._page_refs[page] = 1
                        self._slot_pages[s].append(page)
                        # The grown chain; the dispatch shows the page once
                        # the frontier reaches it.
                        idx = self._slot_page_base[s] + len(self._slot_pages[s]) - 1
                        self._chain[s, idx] = page
                        continue
                if not self._preempt_newest(newer_than=self._slot_seq[s]):
                    break
            if need > self._slot_page_base[s] + len(self._slot_pages[s]):
                self._evict_slot(s)  # starved even after preempting: resume later
        return [s for s in active if self.slots[s] is not None and self._slot_ready[s]]

    def _preempt_newest(self, newer_than: int) -> bool:
        """Evict the most recently admitted ready slot strictly newer than
        ``newer_than``; False when there is none."""
        cands = [
            s for s in range(self.max_slots)
            if self.slots[s] is not None and self._slot_ready[s] and self._slot_seq[s] > newer_than
        ]
        if not cands:
            return False
        self._evict_slot(max(cands, key=lambda s: self._slot_seq[s]))
        return True

    def _evict_slot(self, slot: int) -> None:
        """Preempt: tear the slot down like a finish, but requeue the
        request at the queue head for recompute-resume, unless its client
        already cancelled it (then eviction is the teardown)."""
        req = self.slots[slot]
        # Snapshot before the teardown: the tail page's rows and the decode
        # state (engine_kvcache.py); the release below then retains the
        # full pages it registers.
        snapshotted = self._kv_snapshot_slot(slot, req) if not req.cancelled else False
        self._clear_slot(slot)
        with self._lock:
            # Atomic with cancel(): a cancel either marked it in its slot
            # (seen here) or finds it back in the queue.
            if req.cancelled:
                if snapshotted:
                    self._kv_drop_snapshot(req.rid)
                req.done = True
                self._update_gauges()
                return
            self.preemptions += 1
            if self.metrics:
                self.metrics.preemptions.inc()
            self.queue.appendleft(req)
            self._update_gauges()
        if self.flight is not None:
            self.flight.record("engine.preempt", rid=req.rid, generated=len(req.tokens),
                               free_pages_after=len(self.free_pages), snapshot=snapshotted)

    def _reclaim_windowed(self, slot: int) -> None:
        """Free pages that scrolled wholly out of the sliding window: a
        query at position p sees keys in (p - window, p], so once a page
        lies below ``len - window`` no later query can see it.  Its chain
        entry goes back to scratch before the page can be reused."""
        ps = self.paged.page_size
        horizon = self._slot_len[slot] - self.cfg.attention_window
        n_dead = max(0, min(horizon // ps - self._slot_page_base[slot], len(self._slot_pages[slot])))
        if n_dead <= 0:
            return
        dead, self._slot_pages[slot] = (
            self._slot_pages[slot][:n_dead],
            self._slot_pages[slot][n_dead:],
        )
        lo = self._slot_page_base[slot]
        self._chain[slot, lo : lo + n_dead] = 0
        self._slot_page_base[slot] += n_dead
        for page in dead:
            self._release_page(page)
