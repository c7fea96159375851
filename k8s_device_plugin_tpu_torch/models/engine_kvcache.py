"""Serving-engine KV cache tiering: retained pages and host-RAM offload.

Counterpart of the reference's ``models/engine_kvcache.py``, with its
counters, LRU and budget decisions.  Two tiers sit under the page
lifecycle (mixed into ServingEngine like the other engine_* files):

- **Tier 1, retained device pages.**  A prefix-registered page whose
  refcount drops to zero moves to an LRU "retained" set instead of the
  free pool; its trie links stay live, so a later same-prefix request (or
  the same request resuming after a preemption) matches it through the
  ordinary ``_match_prefix`` walk.  The allocator reclaims retained pages
  lazily, LRU and leaf-first, only when ``free_pages`` alone cannot
  satisfy a request.

- **Tier 2, host-RAM offload.**  Before a retained page is reclaimed its
  rows (every pool of every layer, the int8 scale pools with their codes)
  are copied into a byte-budgeted LRU arena keyed by the cumulative token
  prefix the page covers, and a trie walk that runs past the device tiers
  continues into it: each hit is restored into a fresh device page.

- **Preemption restore-resume.**  ``_evict_slot`` publishes the victim's
  full pages into the trie (so tier 1 retains them) and snapshots the
  partial tail page plus the decode state (consumed length, last token)
  under the request id; when the victim reaches the queue head again the
  slot is rebuilt exactly as it was and prefill is skipped.

On the card the rows move in bulk and the host does not wait for them: a
read is one gather per pool per layer copied into pinned host memory,
ordered on the stream after the dispatches that wrote the pages; an
offload (and a preemption's tail) records an event and goes on, and the
first reader of host rows (a restore, a snapshot, a handoff serve) waits
for it.  A page freed right after its offload may be reused at once: what
writes it later is enqueued later on the same stream.  A restore is one
in-place ``index_copy_`` per pool per layer from pinned memory.  In place
matters: the decode dispatch replays CUDA graphs that hold the pools'
addresses, so a pool tensor is never rebound.  Over a tensor-parallel mesh
each rank holds its kv heads' slice: a read gathers the slices to the
leader and joins them, a write scatters them back (engine_tp.py), so host
rows are always whole, the unsharded engine's.  Host rows are CPU tensors
(bfloat16 included, which numpy cannot hold); ``_kv_rows_nbytes`` counts
them as the reference counts its arrays, so eviction order and counters
agree.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

import torch


class HostKVArena:
    """Bounded host-RAM store for offloaded KV pages and resume snapshots
    (the reference's ``HostKVArena``).

    One ``OrderedDict`` doubles as storage and LRU order; ``put`` evicts
    oldest-first until the byte budget holds.  Keys are content-shaped
    tuples: ``("prefix", trie_root, tokens)`` for offloaded full pages,
    ``("snap", rid)`` for a preempted request's tail and decode state,
    ``("logits", trie_root, tokens)`` for a handed-off prompt's logits.
    Every access happens under the engine lock."""

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self.bytes = 0
        self.evictions = 0
        # Mutation counter (every put/pop/clear and eviction): the fabric
        # digest caches its bloom against it and the trie version.
        self.version = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def get(self, key: tuple, bump: bool = True) -> Optional[dict]:
        entry = self._entries.get(key)
        if entry is not None and bump:
            self._entries.move_to_end(key)
        return entry

    def put(self, key: tuple, entry: dict, nbytes: int) -> int:
        """Insert (or refresh) one entry; returns how many LRU entries the
        budget evicted.  An entry larger than the whole budget is refused
        rather than wiping the arena for it."""
        if not self.enabled or nbytes > self.budget_bytes:
            return 0
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old["nbytes"]
        entry = {**entry, "nbytes": int(nbytes)}
        self._entries[key] = entry
        self.bytes += entry["nbytes"]
        self.version += 1
        evicted = 0
        while self.bytes > self.budget_bytes:
            _, victim = self._entries.popitem(last=False)
            self.bytes -= victim["nbytes"]
            self.evictions += 1
            self.version += 1
            evicted += 1
        return evicted

    def prefix_keys(self) -> list[tuple]:
        """Content keys of the offloaded full-page entries (the fabric
        digest's arena contribution)."""
        return [key for key in self._entries if key[0] == "prefix"]

    def pop(self, key: tuple) -> Optional[dict]:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.bytes -= entry["nbytes"]
            self.version += 1
        return entry

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0
        self.version += 1


class KVCacheMixin:
    """Tiered KV cache lifecycle, mixed into ServingEngine.

    Hooks into the page lifecycle at the reference's seams: the
    refcount-zero branch of ``_release_page`` (retain instead of free),
    the pool-dry points of ``_admit`` and ``_ensure_frontier`` (reclaim
    before blocking or preempting), and ``_evict_slot``/``_admit`` for the
    preemption snapshot and restore pair.  Everything runs on the owner
    thread under the engine lock except ``kvcache_state``, which takes the
    lock itself for debug readers."""

    def _init_kvcache(self, kv_retain: bool, kv_host_cache_mb: float) -> None:
        if kv_host_cache_mb < 0:
            raise ValueError(f"kv_host_cache_mb must be >= 0, got {kv_host_cache_mb}")
        self._kv_retain = bool(kv_retain)
        self._kv_arena = HostKVArena(int(kv_host_cache_mb * 1024 * 1024))  # guarded by: _lock
        # Retained tier: page id -> None, insertion order = LRU order.
        self._kv_retained: "OrderedDict[int, None]" = OrderedDict()  # guarded by: _lock
        # The card: the event of the last row read the host has not waited
        # for (an offload); readers of host rows wait on it first.
        self._kv_pending = None
        self.kv_retained_hits = 0
        self.kv_host_hits = 0
        self.kv_restores = 0  # host -> device page restores
        self.kv_reclaims = 0  # retained pages returned to the free pool
        self.kv_offloads = 0  # pages copied into the host arena
        self.kv_resumes_restored = 0
        self.kv_resumes_recompute = 0
        self.kv_resume_restored_tokens = 0
        self.kv_resume_recomputed_tokens = 0

    # ------------------------------------------------------------- tier 1

    def _kv_retain_page(self, page: int) -> bool:  # caller holds: _lock
        """Refcount just hit zero: keep the page (trie links intact) when it
        is registered in the trie.  Unregistered pages hold nothing a
        future request could match and fall through to the free pool."""
        if not self._page_keys.get(page):
            return False
        self._kv_retained[page] = None
        self._kv_retained.move_to_end(page)
        return True

    def _kv_revive(self, page: int) -> None:  # caller holds: _lock
        """A retained page was matched and re-referenced (0 -> 1): pin it
        out of the reclaimable set."""
        if page in self._kv_retained:
            del self._kv_retained[page]
            self.kv_retained_hits += 1
            if self.metrics:
                self.metrics.kvcache_hits.inc(tier="retained")

    def _kv_pick_reclaim(self, protect: frozenset) -> Optional[int]:
        """Oldest retained page that parents no other retained page (leaf
        first keeps surviving chains walkable); pure LRU as the fallback."""
        fallback = None
        for page in self._kv_retained:
            if page in protect:
                continue
            if fallback is None:
                fallback = page
            has_retained_child = any(
                self._prefix_pages.get(key) in self._kv_retained
                for key in self._child_keys.get(page, [])
            )
            if not has_retained_child:
                return page
        return fallback

    def _kv_reclaim_page(self, page: int) -> None:  # caller holds: _lock
        """Demote one retained page: offload its rows to the arena when it
        is on, then run the same teardown a free runs, so a reallocated id
        is never reachable through a stale retained link."""
        self._kv_retained.pop(page, None)
        offloaded = self._kv_offload_page(page)
        self._teardown_page_links(page)
        del self._page_refs[page]
        self.free_pages.append(page)
        self.kv_reclaims += 1
        if self.metrics:
            self.metrics.kvcache_evictions.inc(tier="retained")
        if self.flight is not None:
            self.flight.record("kvcache.evict", tier="retained", page=page, offloaded=offloaded,
                               retained_after=len(self._kv_retained))

    def _kv_reclaim(self, need: int, protect: frozenset = frozenset()) -> int:
        """Free up to ``need`` retained pages into the pool (LRU, leaf
        first); returns how many.  ``protect`` pins pages a caller matched
        but has not re-referenced yet.  Caller holds the lock."""
        freed = 0
        while freed < need and self._kv_retained:
            page = self._kv_pick_reclaim(protect)
            if page is None:
                break
            self._kv_reclaim_page(page)
            freed += 1
        return freed

    # ------------------------------------------------- device <-> host rows

    @staticmethod
    def _kv_pool_names(pools: dict) -> list[str]:
        """Every per-page pool of one layer (K/V, plus the scale pools of
        int8 KV)."""
        return [name for name in pools if name.startswith("pool_")]

    def _kv_index(self, pages: list[int]) -> torch.Tensor:
        """``pages`` as a device index, sent without stalling the host."""
        idx = torch.tensor(pages, dtype=torch.long)
        if self.device.type == "cuda":
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def _kv_read_pages_rows(self, pages: list[int], wait: bool = True) -> list[dict]:
        """Rows of ``pages`` across every layer and pool, on the host: one
        gather per pool per layer.  On the card the gathers land in one
        pinned block, ordered after every dispatch enqueued before them;
        with ``wait`` the host waits for them, else the read is pending
        until ``_kv_host_sync``.  Whole pages: rows past a partial tail
        carry whatever was there, masked until an append overwrites them.
        Over a mesh every rank's kv-head slice is gathered to the leader
        and joined (engine_tp.py), and the host waits."""
        if self._tp is not None:
            return self._device_op("kv_read", list(pages))
        idx = self._kv_index(pages)
        gathered = []
        for i, name in enumerate(self._layer_names):
            pools = self.kv_pools(i)
            for pool in self._kv_pool_names(pools):
                gathered.append((name, pool, pools[pool].index_select(0, idx)))
        out = [{name: {} for name in self._layer_names} for _ in pages]
        if self.device.type != "cuda":
            for name, pool, rows in gathered:
                for j in range(len(pages)):
                    out[j][name][pool] = rows[j].clone()
            return out
        offsets, total = [], 0
        for _, _, rows in gathered:
            offsets.append(total)
            total += -(-rows.numel() * rows.element_size() // 16) * 16  # 16-byte aligned
        block = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        for (name, pool, rows), off in zip(gathered, offsets):
            nbytes = rows.numel() * rows.element_size()
            host = block[off : off + nbytes].view(rows.dtype).view(rows.shape)
            host.copy_(rows, non_blocking=True)
            for j in range(len(pages)):
                out[j][name][pool] = host[j]
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        if wait:
            done.synchronize()
        else:
            self._kv_pending = done  # events complete in stream order
        return out

    def _kv_host_sync(self) -> None:
        """Wait for the row reads still in flight (owner thread; no-op off
        the card)."""
        done, self._kv_pending = self._kv_pending, None
        if done is not None:
            done.synchronize()

    def _kv_read_page_rows(self, page: int, wait: bool = True) -> dict:
        """One page's rows across every layer and pool, on the host."""
        return self._kv_read_pages_rows([page], wait=wait)[0]

    @staticmethod
    def _kv_rows_nbytes(rows: dict) -> int:
        return sum(t.numel() * t.element_size() for pools in rows.values() for t in pools.values())

    def _kv_write_page_rows(self, pages: list[int], rows_list: list[dict]) -> None:
        """Restore host rows into device pages: one ``index_copy_`` per pool
        per layer, in place (a captured graph keeps reading the same
        pools), from pinned memory on the card.  Over a mesh each rank gets
        its kv-head slice of the rows (engine_tp.py)."""
        self._kv_host_sync()
        if self._tp is not None:
            self._device_op("kv_write", list(pages), rows_list=rows_list)
            return
        idx = self._kv_index(pages)
        on_card = self.device.type == "cuda"
        for i, name in enumerate(self._layer_names):
            pools = self.kv_pools(i)
            for pool in self._kv_pool_names(pools):
                stacked = torch.stack([rows[name][pool] for rows in rows_list])
                if on_card:
                    stacked = stacked.pin_memory()
                pools[pool].index_copy_(0, idx, stacked.to(self.device, non_blocking=True))

    # ------------------------------------------------------------- tier 2

    def _kv_page_prefix(self, page: int) -> Optional[tuple[int, tuple]]:
        """The cumulative (trie_root, tokens) prefix a registered page
        covers, from its ancestry keys; None when an ancestor lost its
        registration."""
        chunks: list[tuple] = []
        node = page
        for _ in range(self.paged.num_pages):
            keys = self._page_keys.get(node)
            if not keys:
                return None
            parent, chunk = keys[0]
            chunks.append(chunk)
            node = parent
            if node < 0:  # pseudo-root: -1 base model, -(2+i) adapter i
                return node, tuple(t for c in reversed(chunks) for t in c)
        return None

    def _kv_offload_page(self, page: int) -> bool:  # caller holds: _lock
        """Copy one retained page's rows into the arena keyed by its
        cumulative prefix; True when stored."""
        if not self._kv_arena.enabled:
            return False
        prefix = self._kv_page_prefix(page)
        if prefix is None:
            return False
        root, tokens = prefix
        rows = self._kv_read_page_rows(page, wait=False)
        evicted = self._kv_arena.put(("prefix", root, tokens), {"rows": rows},
                                     self._kv_rows_nbytes(rows))
        self.kv_offloads += 1
        if self.metrics and evicted:
            self.metrics.kvcache_evictions.inc(evicted, tier="host")
        if evicted and self.flight is not None:
            self.flight.record("kvcache.evict", tier="host", entries=evicted,
                               host_bytes=self._kv_arena.bytes)
        return True

    def _kv_match_host(self, eff: list[int], adapter: Optional[int], start: int,
                       stop: int) -> list[dict]:
        """Continue a trie walk into the arena: consecutive full-page entries
        for eff's pages [start, stop), stopping at the first miss."""
        if not self._kv_arena.enabled:
            return []
        ps = self.paged.page_size
        root = self._trie_root(adapter)
        out: list[dict] = []
        for i in range(start, stop):
            entry = self._kv_arena.get(("prefix", root, tuple(eff[: (i + 1) * ps])))
            if entry is None:
                break
            out.append(entry)
        return out

    def _kv_restore_pages(self, pages: list[int], rows_list: list[dict]) -> None:
        """Write host-held rows into freshly allocated device pages and
        meter the restore (counters, latency histogram, flight)."""
        self._wd_grace("kv_restore")
        t0 = time.perf_counter()
        self._kv_write_page_rows(pages, rows_list)
        dt = time.perf_counter() - t0
        self.kv_restores += len(pages)
        self.kv_host_hits += len(pages)
        if self.metrics:
            self.metrics.kvcache_hits.inc(len(pages), tier="host")
            self.metrics.kvcache_restores.inc(len(pages))
            self.metrics.kvcache_restore_seconds.observe(dt)
        if self.flight is not None:
            self.flight.record("kvcache.restore", pages=len(pages), ms=round(dt * 1e3, 3),
                               host_bytes=self._kv_arena.bytes)

    # -------------------------------------------- preemption snapshot/resume

    def _kv_snapshot_slot(self, slot: int, req: Any) -> bool:
        """Preemption epilogue: publish the victim's full pages into the
        trie (so the release that follows retains them) and snapshot the
        partial tail page plus the decode state under the request id.
        True when a snapshot was stored."""
        if not self._kv_retain:
            return False
        if self._slot_page_base[slot]:
            return False  # windowed reclaim dropped leading pages: no full chain
        with self._lock:
            L = self._slot_len[slot]
            ps = self.paged.page_size
            n_full = L // ps
            eff = req.prompt + req.tokens
            if self.prefix_sharing and n_full:
                # Published even with the arena off: the release retains
                # them and a recompute-resume still skips their writes.
                self._register_prefix(eff, self._slot_pages[slot], n_full, req.adapter)
            if not self._kv_arena.enabled:
                return False  # no tail or state snapshot: recompute-resume
            tail = None
            nbytes = 256  # state scalars; tail rows dominate when present
            if L % ps and n_full < len(self._slot_pages[slot]):
                tail = self._kv_read_page_rows(self._slot_pages[slot][n_full], wait=False)
                nbytes += self._kv_rows_nbytes(tail)
            evicted = self._kv_arena.put(("snap", req.rid),
                                         {"len": L, "last": self._slot_last[slot], "tail": tail},
                                         nbytes)
            if evicted and self.metrics:
                self.metrics.kvcache_evictions.inc(evicted, tier="host")
            return ("snap", req.rid) in self._kv_arena

    def _kv_drop_snapshot(self, rid: int) -> None:  # caller holds: _lock
        self._kv_arena.pop(("snap", rid))

    def _kv_try_restore_resume(self, slot: int, req: Any) -> bool:
        """Admission fast path for a preempted request at the queue head:
        rebuild the slot from the tiers and skip prefill.  Needs every full
        page live, retained or in the arena, the tail snapshot, and pool
        room after a lazy reclaim; short of that it returns False and the
        recompute-resume runs.  The rebuilt slot is the pre-eviction decode
        state (length, pending last token), so the next step continues
        exactly as if it had never been evicted.  Caller holds the lock."""
        snap = self._kv_arena.get(("snap", req.rid), bump=False)
        if snap is None:
            return False
        L = snap["len"]
        ps = self.paged.page_size
        eff = req.prompt + req.tokens
        if L + 1 != len(eff):  # stale snapshot: recompute
            self._kv_drop_snapshot(req.rid)
            return False
        n_full = L // ps
        n_pages = n_full + 1  # content pages + the page position L writes into
        if n_pages > self.paged.max_pages_per_seq:
            return False
        bucket = self._bucket(len(eff))
        shared = (self._match_prefix(eff, bucket, {}, req.adapter)[:n_full]
                  if self.prefix_sharing else [])
        host = self._kv_match_host(eff, req.adapter, len(shared), n_full)
        if len(shared) + len(host) < n_full:
            self._kv_drop_snapshot(req.rid)  # the arena evicted part of the chain
            return False
        tail = snap["tail"]
        if L % ps and tail is None:
            self._kv_drop_snapshot(req.rid)
            return False
        n_private = n_pages - len(shared)
        if n_private > len(self.free_pages):
            self._kv_reclaim(n_private - len(self.free_pages), protect=frozenset(shared))
        if n_private > len(self.free_pages):
            return False  # pool-blocked: keep the snapshot, retry next step
        self.queue.popleft()
        req.admitted_at = time.monotonic()
        private = [self.free_pages.popleft() for _ in range(n_private)]
        pages = shared + private
        for page in shared:
            self._page_refs[page] += 1
            if self._page_refs[page] == 1:
                self._kv_revive(page)
        for page in private:
            self._page_refs[page] = 1
        restore_pages, restore_rows = [], []
        if host:
            restore_pages += private[: len(host)]
            restore_rows += [e["rows"] for e in host]
        if tail is not None:
            restore_pages.append(pages[n_full])
            restore_rows.append(tail)
        if restore_pages:
            self._kv_restore_pages(restore_pages, restore_rows)
        if self.prefix_sharing and n_full:
            self._register_prefix(eff, pages, n_full, req.adapter)
        self._kv_drop_snapshot(req.rid)

        # The graft's chain and length without its pool writes (the rows
        # are in place) or an admission token (req.tokens carries the
        # pending last token, fed at position L by the next step).
        self._set_chain(slot, pages, L)
        self.slots[slot] = req
        self._slot_pages[slot] = pages
        self._slot_page_base[slot] = 0
        self._slot_len[slot] = L
        self._slot_last[slot] = snap["last"]
        self._slot_seq[slot] = self._seq_counter
        self._seq_counter += 1
        self._set_slot_sampler(slot, req)
        self._slot_ready[slot] = True
        self._slot_emit_t[slot] = time.monotonic()
        self._mark_state_dirty()

        self.kv_resumes_restored += 1
        self.kv_resume_restored_tokens += L
        if self.metrics:
            self.metrics.resumes.inc(mode="restored")
            self.metrics.resume_restored_tokens.inc(L)
        if self.flight is not None:
            self.flight.record("engine.resume", rid=req.rid, mode="restored", restored_tokens=L,
                               recomputed_tokens=0, pages_shared=len(shared),
                               pages_restored=len(restore_pages))
        self._update_gauges()
        return True

    # ------------------------------------------------------------ interface

    def kvcache_clear(self) -> None:
        """Drop both tiers: every retained page back to the free pool (no
        offload) and an empty arena; counters survive."""
        with self._lock:
            for page in list(self._kv_retained):
                self._kv_retained.pop(page, None)
                self._teardown_page_links(page)
                del self._page_refs[page]
                self.free_pages.append(page)
            self._kv_arena.clear()
            self._update_gauges()

    def kvcache_state(self) -> dict:
        """Body of ``GET /debug/kvcache`` and the ``kvcache`` block of
        ``debug_state()``."""
        with self._lock:
            return {
                "retain": self._kv_retain,
                "retained_pages": len(self._kv_retained),
                "host": {
                    "enabled": self._kv_arena.enabled,
                    "budget_bytes": self._kv_arena.budget_bytes,
                    "bytes": self._kv_arena.bytes,
                    "entries": len(self._kv_arena),
                    "evictions": self._kv_arena.evictions,
                },
                "hits": {"retained": self.kv_retained_hits, "host": self.kv_host_hits},
                "restores": self.kv_restores,
                "reclaims": self.kv_reclaims,
                "offloads": self.kv_offloads,
                "resumes": {
                    "restored": self.kv_resumes_restored,
                    "recompute": self.kv_resumes_recompute,
                    "restored_tokens": self.kv_resume_restored_tokens,
                    "recomputed_tokens": self.kv_resume_recomputed_tokens,
                },
            }
