"""Serving-engine page pool, prefix trie and the prefill -> pages graft.

Counterpart of the reference's ``models/engine_paging.py`` for reserve
admission: a request's whole page chain is allocated when it is admitted,
page 0 is the scratch page idle rows write into, full prompt pages are
shared through a per-page trie keyed (parent page, token chunk), and pages
are refcounted and freed by their last user.  Mixed into ServingEngine,
which owns the state.
"""

from __future__ import annotations

import math

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
        full = torch.zeros((self.paged.max_pages_per_seq,), dtype=torch.int32)
        full[: len(pages)] = torch.tensor(pages, dtype=torch.int32)
        self._chain[slot] = full.to(self.device)
        self.cache.seq_lens[slot] = plen
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
        self._slot_topk[slot] = self.cfg.vocab_size
        self._slot_topp[slot] = 1.0
        self._slot_page_base[slot] = 0
        self._slot_ready[slot] = False
        self._slot_emit_t[slot] = 0.0
        # Slot scalars changed: the step state is rebuilt from host truth.
        self._mark_state_dirty()

    def _release_page(self, page: int) -> None:
        """Drop one reference; at zero, tear down every trie link touching
        the page and return it to the pool.  The one page-free path."""
        with self._lock:
            self._page_refs[page] -= 1
            if self._page_refs[page] > 0:
                return
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
        for key in self._child_keys.pop(page, []):
            child = self._prefix_pages.pop(key, None)
            if child is not None:
                keys = self._page_keys.get(child)
                if keys and key in keys:
                    keys.remove(key)

    def _match_prefix(self, prompt: list[int], bucket: int, burst_pages: dict[int, int]) -> list[int]:
        """Longest chain of registered pages whose token chunks equal this
        prompt's leading FULL pages.  A page still waiting for its owner's
        graft is shared only within the same admission burst and length
        bucket: that job grafts every item before any of them decodes."""
        ps = self.paged.page_size
        pages: list[int] = []
        parent = -1  # the trie root
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

    def _register_prefix(self, eff: list[int], pages: list[int], n: int) -> None:  # caller holds: _lock
        """Register ``eff``'s first ``n`` full pages as trie links
        (idempotent: an existing key wins and the walk follows it)."""
        ps = self.paged.page_size
        parent = -1
        for i in range(n):
            key = (parent, tuple(eff[i * ps : (i + 1) * ps]))
            if key not in self._prefix_pages:
                self._prefix_pages[key] = pages[i]
                self._page_keys.setdefault(pages[i], []).append(key)
                if parent >= 0:
                    self._child_keys.setdefault(parent, []).append(key)
            parent = self._prefix_pages[key]

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
