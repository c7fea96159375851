"""The KV-tier, handoff and fabric surfaces of a unified-role engine with
no retained pages and no host arena.

The reference's ``engine_kvcache.py`` (retained pages, the host arena),
``engine_handoff.py`` (prefill/decode roles, the KV handoff) and its fleet
fabric are the KV tiers, which the port has not taken yet.  An engine of
the reference built with ``kv_retain=False``, ``kv_host_cache_mb=0`` and
``role="unified"`` still answers every route those modules serve; this
mixin answers them the same way: the tier and fabric snapshots with their
counters at rest, a role flip that only ``unified`` passes, a fabric pull
refused for want of an arena, and ``POST /v1/prefill`` served from live
trie pages or a prefill probe (the prompt submitted with
``max_new_tokens=1``, its full pages streamed as the chunks land).
Mixed into ServingEngine.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np

ROLES = ("unified", "prefill", "decode")
ROLE_VALUES = {"unified": 0, "prefill": 1, "decode": 2}

PREFILL_ROUTE = "/v1/prefill"
HANDOFF_SOURCE_HEADER = "X-Handoff-Source"
HANDOFF_LOCAL = "local"
PREFILL_NEEDED_HEADER = "X-Prefill-Needed"
FABRIC_RESIDENT_ONLY_HEADER = "X-Fabric-Resident-Only"


class HandoffTap:
    """One prefill probe's entry stream: the owner thread pushes each full
    page's rows as its chunk lands; the ``/v1/prefill`` handler pops them
    (the reference's ``HandoffTap``)."""

    def __init__(self, req, prompt: list, adapter: Optional[int], n_full: int):
        self.req = req
        self.prompt = list(prompt)
        self.adapter = adapter
        self.n_full = n_full
        self.pushed = 0  # guarded by: _cond
        self.logits: Optional[np.ndarray] = None
        self._ready: deque = deque()  # guarded by: _cond
        self._cond = threading.Condition()

    def push(self, key: tuple, rows: dict) -> None:
        with self._cond:
            self._ready.append((key, rows))
            self.pushed += 1
            self._cond.notify_all()

    def pop(self, timeout: float) -> Optional[tuple]:
        with self._cond:
            if not self._ready:
                self._cond.wait(timeout)
            if not self._ready:
                return None
            return self._ready.popleft()

    @property
    def dead(self) -> bool:
        return bool(self.req.done)


class UnifiedRoleMixin:
    """Tier, handoff and fabric state of a unified engine without tiers."""

    def _init_unified(self) -> None:
        self.role = "unified"
        self._handoff_taps: dict[int, HandoffTap] = {}  # guarded by: _lock
        # The reference's counters; only serving a probe moves any here.
        self.kv_resumes_recompute = 0
        self.kv_resume_recomputed_tokens = 0
        self.handoff_serves = 0
        self.handoff_published_entries = 0
        self.handoff_served_entries = 0
        self.fabric_pull_failures = 0
        # Work a handler thread hands the owner thread (which alone
        # touches the card): (fn, done event, result box); step() runs it.
        self._owner_calls: deque = deque()  # guarded by: _lock
        self._owner_thread: Optional[int] = None
        if self.metrics:
            self.metrics.role.set(ROLE_VALUES["unified"])

    # -------------------------------------------------------------- pools

    def kv_pools(self, layer: int) -> dict:
        """Layer ``layer``'s page pools under the reference's cache names."""
        k, v, ks, vs = self.cache.layer(layer)
        pools = {"pool_key": k, "pool_value": v}
        if ks is not None:
            pools.update(pool_key_scale=ks, pool_value_scale=vs)
        return pools

    def on_owner(self, fn, timeout_s: float = 30.0):
        """Run ``fn`` on the owner thread (the one that runs step()) and
        return its result: inline when called there, or when no thread
        owns the engine yet (a caller that steps it itself), else queued
        for the next step() and waited for.  A server names its loop
        thread the owner before it serves (``claim_owner``)."""
        owner = self._owner_thread
        if owner is None or owner == threading.get_ident():
            return fn()
        done, box = threading.Event(), {}
        with self._lock:
            self._owner_calls.append((fn, done, box))
        if not done.wait(timeout_s):
            raise TimeoutError("the engine's owner thread did not run the call in time")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def claim_owner(self, ident: int) -> None:
        """Name thread ``ident`` the owner: from now on on_owner() queues
        every call from another thread for it."""
        self._owner_thread = ident

    def _run_owner_calls(self) -> None:
        """Owner thread, at the start of a step: run the queued calls."""
        self._owner_thread = threading.get_ident()
        while True:
            with self._lock:
                if not self._owner_calls:
                    return
                fn, done, box = self._owner_calls.popleft()
            try:
                box["result"] = fn()
            except Exception as e:  # handed back to the caller
                box["error"] = e
            done.set()

    def _kv_read_page_rows(self, page: int) -> dict:
        """One page's rows across every layer and pool (on the host; runs
        on the owner thread)."""
        return {
            f"layer_{i}": {name: pool[page].cpu() for name, pool in self.kv_pools(i).items()}
            for i in range(self.cfg.num_layers)
        }

    @staticmethod
    def _trie_root(adapter: Optional[int]) -> int:
        return -1 if adapter is None else -(2 + adapter)

    # ------------------------------------------------------------- states

    def kvcache_state(self) -> dict:
        """Body of ``GET /debug/kvcache``: no retained tier, no arena."""
        with self._lock:
            return {
                "retain": False,
                "retained_pages": 0,
                "host": {"enabled": False, "budget_bytes": 0, "bytes": 0, "entries": 0,
                         "evictions": 0},
                "hits": {"retained": 0, "host": 0},
                "restores": 0,
                "reclaims": 0,
                "offloads": 0,
                "resumes": {
                    "restored": 0,
                    "recompute": self.kv_resumes_recompute,
                    "restored_tokens": 0,
                    "recomputed_tokens": self.kv_resume_recomputed_tokens,
                },
            }

    def handoff_state(self) -> dict:
        """Body of ``GET /debug/disagg``."""
        with self._lock:
            return {
                "role": self.role,
                "skip_covered_prefill": False,
                "taps_active": len(self._handoff_taps),
                "serves": self.handoff_serves,
                "served_entries": self.handoff_served_entries,
                "published_entries": self.handoff_published_entries,
                "fetches": 0,
                "fetch_failures": 0,
                "fetched_entries": 0,
                "refusals": 0,
                "skipped_prefill_tokens": 0,
                "noprefill_admits": 0,
            }

    def fabric_digest(self) -> Optional[dict]:
        """None: without an arena the replica advertises nothing."""
        return None

    def fabric_state(self) -> dict:
        """Body of ``GET /debug/fabric``."""
        with self._lock:
            return {
                "enabled": False,
                "digest": None,
                "advertised_roots": 0,
                "digest_builds": 0,
                "arena_version": 0,
                "trie_version": self._trie_version,
                "pulls": 0,
                "pull_failures": self.fabric_pull_failures,
                "drops": 0,
            }

    def set_role(self, role: str) -> bool:
        """``POST /debug/role``: both split roles need the KV tiers."""
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if role != "unified":
            if not self.prefix_sharing:
                raise ValueError(f"role={role!r} requires prefix_sharing")
            raise ValueError(f"role={role!r} requires kv_retain")
        return False

    def fetch_prefill(self, source: str) -> dict:
        """A decode-side pull: refused, there is no arena to admit into."""
        if self.metrics:
            self.metrics.handoff_fetches.inc(outcome="disabled")
        return {"ok": False, "reason": "arena_disabled", "restored": 0, "source": source}

    def fabric_pull(self, source: str, prompt: list, adapter: Optional[int] = None,
                    timeout_s: float = 30.0) -> dict:
        """``POST /debug/fabric/pull``: fails as the reference's does
        without an arena."""
        result = self.fetch_prefill(source)
        with self._lock:
            self.fabric_pull_failures += 1
        if self.metrics:
            self.metrics.fabric_pulls.inc(outcome="error")
        self.flight.record("fabric.pull_failed", source=source, prompt_tokens=len(prompt),
                           restored=0, reason=result["reason"])
        return result

    def fabric_drop(self, prompt: list, adapter: Optional[int] = None) -> dict:
        """``POST /debug/fabric/drop``: an empty arena drops nothing."""
        return {"ok": True, "dropped": 0}

    # ------------------------------------------------ resident prefixes

    def _resident_prefix(self, prompt: list, adapter: Optional[int]) -> list:
        """The leading full pages of ``prompt`` live in the trie (grafted),
        as ``(key, rows)`` entries."""
        ps = self.paged.page_size
        root = self._trie_root(adapter)
        pages = []
        with self._lock:
            parent = root
            for i in range(len(prompt) // ps):
                page = self._prefix_pages.get((parent, tuple(prompt[i * ps : (i + 1) * ps])))
                if page is None or page in self._pending_pages:
                    break
                pages.append(page)
                parent = page
        rows = self.on_owner(lambda: [self._kv_read_page_rows(page) for page in pages])
        return [(("prefix", root, tuple(prompt[: (i + 1) * ps])), r) for i, r in enumerate(rows)]

    def handoff_resident_entries(self, prompt: list, adapter: Optional[int]):
        """Every full page of ``prompt`` as entries, or None when one is
        not resident."""
        out = self._resident_prefix(prompt, adapter)
        return out if len(out) == len(prompt) // self.paged.page_size else None

    def handoff_resident_prefix_entries(self, prompt: list, adapter: Optional[int]) -> list:
        return self._resident_prefix(prompt, adapter)

    def handoff_coverage(self, prompt: list, adapter: Optional[int]) -> tuple[int, int]:
        """(covered, n_full): the leading full pages resident in the trie."""
        ps = self.paged.page_size
        n_full = len(prompt) // ps
        covered = 0
        with self._lock:
            parent = self._trie_root(adapter)
            for i in range(n_full):
                page = self._prefix_pages.get((parent, tuple(prompt[i * ps : (i + 1) * ps])))
                if page is None or page in self._pending_pages:
                    break
                parent = page
                covered += 1
        return covered, n_full

    # ------------------------------------------------------ prefill probe

    def handoff_begin(self, prompt: list, adapter: Optional[int]) -> HandoffTap:
        """Start a prefill probe for ``/v1/prefill`` (raises what submit
        raises)."""
        req = self.submit(list(prompt), 1, adapter=adapter)
        tap = HandoffTap(req, prompt, adapter, len(prompt) // self.paged.page_size)
        with self._lock:
            self._handoff_taps[req.rid] = tap
        return tap

    def handoff_end(self, tap: HandoffTap) -> None:
        with self._lock:
            self._handoff_taps.pop(tap.req.rid, None)
        if not tap.req.done:
            self.cancel(tap.req)

    def _handoff_feed(self, job: dict) -> None:
        """Owner thread, after a prefill chunk: push each tapped request's
        newly covered full pages, read from the job's dense cache."""
        ps = self.paged.page_size
        for row_idx, (slot, req, pages, n_shared) in enumerate(job["items"]):
            tap = self._handoff_taps.get(req.rid)
            if tap is None:
                continue
            plen = len(req.prompt) + len(req.tokens)
            covered = min(job["pos"], plen) // ps
            if tap.logits is None and job["logits"][row_idx] is not None:
                tap.logits = job["logits"][row_idx].float().cpu().numpy()
            for i in range(tap.pushed, min(covered, tap.n_full)):
                rows = {}
                for layer in range(self.cfg.num_layers):
                    k, v, ks, vs = job["cache"].layer(layer)
                    span = slice(i * ps, (i + 1) * ps)
                    rows[f"layer_{layer}"] = {"pool_key": k[row_idx, span].cpu(),
                                              "pool_value": v[row_idx, span].cpu()}
                    if ks is not None:
                        rows[f"layer_{layer}"].update(pool_key_scale=ks[row_idx, span].cpu(),
                                                      pool_value_scale=vs[row_idx, span].cpu())
                with self._lock:
                    self.handoff_published_entries += 1
                if self.metrics:
                    self.metrics.handoff_entries.inc(direction="published")
                tap.push(("prefix", self._trie_root(tap.adapter),
                          tuple(tap.prompt[: (i + 1) * ps])), rows)
            if tap.pushed >= tap.n_full and tap.n_full:
                self.flight.record("handoff.published", rid=req.rid, entries=tap.n_full,
                                   prompt_tokens=plen)
