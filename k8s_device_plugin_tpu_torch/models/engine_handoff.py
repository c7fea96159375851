"""Disaggregated prefill/decode serving: engine roles and the KV-page
handoff, plus the fleet KV fabric's engine half.

Counterpart of the reference's ``models/engine_handoff.py``, byte for
byte on the wire, so a JAX replica and a PyTorch one hand pages to each
other:

- **Roles** (``ServingEngine(role=...)``, CLI ``--role``): ``unified``
  prefills and decodes in one loop; ``prefill`` runs ``POST /v1/prefill``
  probes, publishes each finished full page into the content-addressed
  host arena and streams it to the caller as its chunk lands (its
  ``/generate`` answers 409); ``decode`` admits a request whose full-page
  prefix is resident (live or retained trie pages, arena entries),
  restores those pages and skips the prefill chunks they cover, pulls a
  prefix from the replica the router's ``X-Handoff-Source`` names, and
  refuses (409 + ``X-Prefill-Needed``) one that is neither.
- **Wire** (``POST /v1/prefill``): the snapshot stream's ``MAGIC |
  version | header | entries`` (engine_snapshot's encoders), then an
  optional ``TPUHOLG1`` section with the prefill side's last-position
  logits, from which a decode replica samples the admission token with
  no prefill at all.
- **Degradation**: the decode side parses before it admits, so a prefill
  replica dying mid-transfer, a torn stream or an incompatible peer
  admits nothing and the request prefills locally.

The port's threading rule holds throughout: only the owner thread (the
one that runs ``step()``) touches a CUDA tensor, and handler threads hand
device reads to it with ``on_owner``.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..utils import failpoints
from ..utils.prefixbloom import PrefixBloom
from . import engine_snapshot as snap
from .handoff_wire import (  # noqa: F401  (the wire names, re-exported)
    FABRIC_RESIDENT_ONLY_HEADER,
    HANDOFF_LOCAL,
    HANDOFF_SOURCE_HEADER,
    LOGITS_MAGIC,
    PREFILL_NEEDED_HEADER,
    PREFILL_ROUTE,
    ROLE_VALUES,
    ROLES,
)


class HandoffTap:
    """One in-flight prefill probe's entry stream: the owner thread pushes
    each newly covered full page's rows as its chunk completes; the
    ``/v1/prefill`` handler pops them.  ``_cond`` guards ``_ready`` and
    ``pushed`` (a leaf lock: the handler blocks without the engine's)."""

    def __init__(self, req, prompt: list, adapter: Optional[int], n_full: int):
        self.req = req
        self.prompt = list(prompt)
        self.adapter = adapter
        self.n_full = n_full
        self.pushed = 0  # guarded by: _cond
        # Last-position logits once their chunk computed (written once by
        # the owner before the final push, read by the handler after it).
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
        """The probe finished (or was shed or cancelled)."""
        return bool(self.req.done)


class HandoffMixin:
    """Roles, the owner-thread call queue, the prefill-side tap feed, the
    decode-side admission and the fabric digest, mixed into
    ServingEngine."""

    # ------------------------------------------------------------ roles

    def _validate_role(self, role: str) -> None:
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if role != "unified":
            # Both split roles live on the content-addressed KV tiers.
            if not self.prefix_sharing:
                raise ValueError(f"role={role!r} requires prefix_sharing")
            if not self._kv_retain:
                raise ValueError(f"role={role!r} requires kv_retain")
            if not self._kv_arena.enabled:
                raise ValueError(
                    f"role={role!r} requires kv_host_cache_mb > 0 (the "
                    "content-addressed arena is the handoff medium)"
                )

    def _init_handoff(self, role: str) -> None:
        self._validate_role(role)
        self.role = role
        # Decode-role engines skip the prefill chunks their resident pages
        # cover (engine_admission._start_prefill); unified engines keep
        # the plain prefill schedule.
        self._handoff_skip_covered = role == "decode"
        self._handoff_taps: dict[int, HandoffTap] = {}  # guarded by: _lock
        self.handoff_serves = 0
        self.handoff_fetches = 0
        self.handoff_fetch_failures = 0
        self.handoff_published_entries = 0
        self.handoff_served_entries = 0
        self.handoff_fetched_entries = 0
        self.handoff_refusals = 0
        self.handoff_skipped_tokens = 0  # prefill positions never computed
        self.handoff_noprefill_admits = 0  # zero-compute admissions
        # The fabric advertisement, rebuilt only when the arena or the
        # trie changed (version pair).
        self._fabric_digest_wire: Optional[dict] = None  # guarded by: _lock
        self._fabric_digest_versions = (-1, -1)  # guarded by: _lock
        # Single-flight fabric pulls, keyed by source replica.
        self._handoff_pull_waits: dict = {}  # guarded by: _lock
        self.fabric_digest_builds = 0
        self.fabric_pulls = 0
        self.fabric_pull_failures = 0
        self.fabric_drops = 0
        # Work a handler thread hands the owner thread (which alone
        # touches the card): (fn, done event, result box); step() runs it.
        self._owner_calls: deque = deque()  # guarded by: _lock
        self._owner_thread: Optional[int] = None
        if self.metrics:
            self.metrics.role.set(ROLE_VALUES[role])

    def set_role(self, role: str) -> bool:
        """Runtime role flip (``POST /debug/role``), with the constructor's
        preconditions; in-flight work finishes under the old role.
        Idempotent: False when already there."""
        self._validate_role(role)
        with self._lock:
            if role == self.role:
                return False
            previous = self.role
            self.role = role
            self._handoff_skip_covered = role == "decode"
        if self.metrics:
            self.metrics.role.set(ROLE_VALUES[role])
        self.flight.record("engine.role_changed", previous=previous, role=role)
        return True

    # ----------------------------------------------------- owner thread

    def kv_pools(self, layer: int) -> dict:
        """Layer ``layer``'s page pools under the reference's cache names."""
        k, v, ks, vs = self.cache.layer(layer)
        pools = {"pool_key": k, "pool_value": v}
        if ks is not None:
            pools.update(pool_key_scale=ks, pool_value_scale=vs)
        return pools

    def on_owner(self, fn, timeout_s: float = 30.0):
        """Run ``fn`` on the owner thread and return its result: inline
        when called there or when no thread owns the engine (a caller that
        steps it itself), else queued for the owner's next step() and
        waited for.  A server names its loop thread the owner before it
        serves (``claim_owner``) and releases it when the loop ends
        (``release_owner``)."""
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

    def release_owner(self) -> None:
        """The owner thread stops stepping: later calls run inline on their
        own threads, and what is queued runs now."""
        self._owner_thread = None
        self._run_owner_calls()

    def _run_owner_calls(self) -> None:
        """Owner thread, at the start of a step: run the queued calls."""
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

    # ------------------------------------------------------ prefill side

    def handoff_begin(self, prompt: list, adapter: Optional[int]) -> HandoffTap:
        """Start one prefill probe for ``/v1/prefill``: submit the prompt
        with ``max_new_tokens=1`` (it finishes at activation) and register
        a tap the owner thread feeds as chunks complete.  Raises what
        ``submit`` raises."""
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
        """Owner thread, after a prefill chunk: for every tapped request in
        the job, read the newly covered full pages out of the job's dense
        cache (one slice per pool per layer), publish them into the arena
        and push them to the tap's handler."""
        ps = self.paged.page_size
        for row_idx, (slot, req, pages, n_shared) in enumerate(job["items"]):
            tap = self._handoff_taps.get(req.rid)
            if tap is None:
                continue
            plen = len(req.prompt) + len(req.tokens)
            covered = min(job["pos"], plen) // ps
            if tap.logits is None and job["logits"][row_idx] is not None:
                # Stored before this feed's pushes: the handler streams the
                # logits right after the final entry.
                tap.logits = job["logits"][row_idx].float().cpu().numpy()
                with self._lock:
                    self._kv_arena.put(("logits", self._trie_root(tap.adapter), tuple(tap.prompt)),
                                       {"logits": tap.logits}, tap.logits.nbytes)
            lo, hi = tap.pushed, min(covered, tap.n_full)
            if hi <= lo:
                continue
            # Every kv head: over a mesh each rank's are gathered to the
            # leader (engine_tp.py), so the wire is the unsharded engine's.
            slabs = self._device_op("dense_rows", job["id"], row_idx, lo * ps, hi * ps)
            for i in range(lo, hi):
                rows = {name: {} for name in self._layer_names}
                for (name, pool), rows_host in slabs.items():
                    rows[name][pool] = rows_host[(i - lo) * ps : (i - lo + 1) * ps].clone()
                key = ("prefix", self._trie_root(tap.adapter), tuple(tap.prompt[: (i + 1) * ps]))
                with self._lock:
                    self._kv_arena.put(key, {"rows": rows}, self._kv_rows_nbytes(rows))
                    self.handoff_published_entries += 1
                if self.metrics:
                    self.metrics.handoff_entries.inc(direction="published")
                tap.push(key, rows)
            if tap.pushed >= tap.n_full and self.flight is not None and tap.n_full:
                self.flight.record("handoff.published", rid=req.rid, entries=tap.n_full,
                                   prompt_tokens=plen)

    def _resident_walk(self, prompt: list, adapter: Optional[int], whole: bool):
        """Owner thread: the leading resident full pages of ``prompt`` as
        ``(key, rows)`` entries, live or retained trie pages first (one
        gather for all), then the arena.  With ``whole``, None unless
        every full page is resident."""
        ps = self.paged.page_size
        n_full = len(prompt) // ps
        root = self._trie_root(adapter)
        with self._lock:
            self._kv_host_sync()
            pages: list[int] = []
            parent = root
            for i in range(n_full):
                page = self._prefix_pages.get((parent, tuple(prompt[i * ps : (i + 1) * ps])))
                if page is None or page in self._pending_pages:
                    break
                pages.append(page)
                parent = page
            out = []
            if pages:
                rows = self._kv_read_pages_rows(pages)
                out = [(("prefix", root, tuple(prompt[: (i + 1) * ps])), r)
                       for i, r in enumerate(rows)]
            for i in range(len(pages), n_full):  # device chain broken: arena only
                key = ("prefix", root, tuple(prompt[: (i + 1) * ps]))
                entry = self._kv_arena.get(key)
                if entry is None:
                    return None if whole else out
                out.append((key, entry["rows"]))
        return out

    def handoff_resident_entries(self, prompt: list, adapter: Optional[int]):
        """Every full prefix page of ``prompt`` as ``(key, rows)`` entries
        from the tiers (the no-compute serve path); None when coverage is
        incomplete (the caller runs a probe)."""
        return self.on_owner(lambda: self._resident_walk(prompt, adapter, whole=True))

    def handoff_resident_prefix_entries(self, prompt: list, adapter: Optional[int]) -> list:
        """The leading resident full pages of ``prompt`` (the fabric
        any-peer serve); empty when not even the first is resident."""
        return self.on_owner(lambda: self._resident_walk(prompt, adapter, whole=False))

    # ------------------------------------------------------- decode side

    def handoff_coverage(self, prompt: list, adapter: Optional[int]) -> tuple[int, int]:
        """(covered, n_full): the prompt's leading full pages resident as a
        live or retained trie chain continued into the arena (the coverage
        the admission walk finds)."""
        ps = self.paged.page_size
        n_full = len(prompt) // ps
        root = self._trie_root(adapter)
        covered = 0
        with self._lock:
            parent = root
            for i in range(n_full):
                page = self._prefix_pages.get((parent, tuple(prompt[i * ps : (i + 1) * ps])))
                if page is None or page in self._pending_pages:
                    break
                parent = page
                covered += 1
            for i in range(covered, n_full):
                if ("prefix", root, tuple(prompt[: (i + 1) * ps])) not in self._kv_arena:
                    break
                covered += 1
        return covered, n_full

    def _handoff_try_admit(self, slot: int, req) -> bool:
        """Decode-role fast path for a fresh handed-off request: with the
        prompt page-aligned, every full page resident and the prefill
        side's logits shipped, rebuild the slot with no prefill compute:
        restore the pages, sample the admission token from the shipped
        logits (activation's math, so streams equal a unified engine's)
        and mark the slot ready.  Anything short returns False and the
        ordinary admission runs.  Caller holds the lock."""
        import math

        from .engine_overload import PRIORITY_NAMES

        ps = self.paged.page_size
        eff = req.prompt
        plen = len(eff)
        if plen % ps or plen == 0:
            return False
        n_full = plen // ps
        root = self._trie_root(req.adapter)
        lg = self._kv_arena.get(("logits", root, tuple(eff)))
        if lg is None:
            return False
        bucket = self._bucket(plen)
        shared = (self._match_prefix(eff, bucket, {}, req.adapter)[:n_full]
                  if self.prefix_sharing else [])
        host = self._kv_match_host(eff, req.adapter, len(shared), n_full)
        if len(shared) + len(host) < n_full:
            return False
        if self._optimistic:
            n_pages = math.ceil((plen + 1) / ps)
        else:
            n_pages = math.ceil((plen + req.max_new_tokens) / ps)
        n_private = n_pages - len(shared)
        if n_private > len(self.free_pages):
            self._kv_reclaim(n_private - len(self.free_pages), protect=frozenset(shared))
        if n_private > len(self.free_pages):
            return False  # pool-blocked: stay queued like any head
        self.queue.popleft()
        req.admitted_at = time.monotonic()
        wait_s = req.admitted_at - req.submitted_at
        if self.metrics:
            self.metrics.queue_wait_seconds.observe(wait_s, priority=PRIORITY_NAMES[req.priority])
        if self.overload is not None:
            self.overload.observe_admission(req, wait_s)
        private = [self.free_pages.popleft() for _ in range(n_private)]
        pages = shared + private
        for page in shared:
            self._page_refs[page] += 1
            if self._page_refs[page] == 1:
                self._kv_revive(page)
        for page in private:
            self._page_refs[page] = 1
        if host:
            self._kv_restore_pages(private[: len(host)], [e["rows"] for e in host])
        if self.prefix_sharing:
            self._register_prefix(eff, pages, n_full, req.adapter)

        logits = torch.from_numpy(np.array(lg["logits"])).to(self.device)
        first = self._sample_first_token(req, logits)
        req.tokens.append(first)

        # The graft's chain and length without a graft (every row is in
        # place), as in _kv_try_restore_resume.
        self._set_chain(slot, pages, plen)
        self.slots[slot] = req
        self._slot_pages[slot] = pages
        self._slot_page_base[slot] = 0
        self._slot_len[slot] = plen
        self._slot_last[slot] = first
        self._slot_seq[slot] = self._seq_counter
        self._seq_counter += 1
        self._set_slot_sampler(slot, req)
        self._slot_ready[slot] = True

        now = time.monotonic()
        req.first_token_at = now
        self._slot_emit_t[slot] = now
        self._step_tokens += 1
        self.handoff_noprefill_admits += 1
        self.handoff_skipped_tokens += plen
        if self.metrics:
            self.metrics.requests.inc()
            self.metrics.wait_seconds.observe(now - req.submitted_at)
            self.metrics.ttft_seconds.observe(now - req.submitted_at)
            self.metrics.tokens.inc()
        if self.anomaly is not None:
            self.anomaly.observe("engine.ttft_seconds", now - req.submitted_at)
        if self.flight is not None:
            self.flight.record("handoff.admitted", rid=req.rid, prompt_tokens=plen,
                               pages_shared=len(shared), pages_restored=len(host))
        if self.spans:
            self.spans.record_span(
                "queue", req.trace_id, start_monotonic=req.submitted_at,
                end_monotonic=req.admitted_at, parent_id=req.root_span,
                attrs={"rid": req.rid, "wait_s": round(wait_s, 6)},
            )
            self.spans.record_span(
                "prefill", req.trace_id, start_monotonic=req.admitted_at, end_monotonic=now,
                parent_id=req.root_span,
                attrs={"rid": req.rid, "prompt_tokens": plen, "bucket": 0, "batched_with": 0},
            )
        self._maybe_finish(slot)
        self._mark_state_dirty()
        self._update_gauges()
        return True

    def handoff_state(self) -> dict:
        """Body of ``GET /debug/disagg``."""
        with self._lock:
            return {
                "role": self.role,
                "skip_covered_prefill": self._handoff_skip_covered,
                "taps_active": len(self._handoff_taps),
                "serves": self.handoff_serves,
                "served_entries": self.handoff_served_entries,
                "published_entries": self.handoff_published_entries,
                "fetches": self.handoff_fetches,
                "fetch_failures": self.handoff_fetch_failures,
                "fetched_entries": self.handoff_fetched_entries,
                "refusals": self.handoff_refusals,
                "skipped_prefill_tokens": self.handoff_skipped_tokens,
                "noprefill_admits": self.handoff_noprefill_admits,
            }

    # ------------------------------------------------------- fleet fabric

    def fabric_digest(self) -> Optional[dict]:
        """Wire-form bloom advertisement of every cumulative full-page prefix
        this replica can serve over ``POST /v1/prefill`` (grafted or
        retained trie chains and the arena's entries); None when it cannot
        serve pulls.  The cached dict is read off-lock (the summary poll's
        racy-read contract); a rebuild runs under the lock."""
        if not self.prefix_sharing or not self._kv_arena.enabled:
            return None
        cached = self._fabric_digest_wire
        if cached is not None and self._fabric_digest_versions == (
            self._kv_arena.version, self._trie_version
        ):
            return cached
        with self._lock:
            versions = (self._kv_arena.version, self._trie_version)
            if self._fabric_digest_wire is not None and self._fabric_digest_versions == versions:
                return self._fabric_digest_wire
            bloom = PrefixBloom()
            seen: set = set()
            for key in self._kv_arena.prefix_keys():
                ident = (key[1], key[2])
                if ident not in seen:
                    seen.add(ident)
                    bloom.add(key[1], key[2])
            # Trie-resident chains from the pseudo-roots, pending (not yet
            # grafted) pages left out.
            children: dict[int, list[tuple[tuple, int]]] = {}
            for (parent, chunk), page in self._prefix_pages.items():
                children.setdefault(parent, []).append((chunk, page))
            stack = [(root, (), root) for root in children if root < 0]
            while stack:
                parent, cum, root = stack.pop()
                for chunk, page in children.get(parent, ()):
                    if page in self._pending_pages:
                        continue
                    tokens = cum + chunk
                    ident = (root, tokens)
                    if ident not in seen:
                        seen.add(ident)
                        bloom.add(root, tokens)
                    stack.append((page, tokens, root))
            wire = bloom.to_wire()
            wire["page_size"] = self.paged.page_size
            self._fabric_digest_wire = wire
            self._fabric_digest_versions = versions
            self.fabric_digest_builds += 1
            if self.metrics:
                self.metrics.fabric_digest_roots.set(len(seen))
            return wire

    def fabric_pull(self, source: str, prompt: list, adapter: Optional[int] = None,
                    timeout_s: float = 30.0) -> dict:
        """``POST /debug/fabric/pull``: copy ``prompt``'s covered pages from
        ``source`` into this replica's arena through the request-path
        fetch's parse-before-admit verifier."""
        result = fetch_prefill(self, source, prompt, adapter=adapter, timeout_s=timeout_s,
                               resident_only=True)
        ok = bool(result.get("ok"))
        with self._lock:
            if ok:
                self.fabric_pulls += 1
            else:
                self.fabric_pull_failures += 1
        if self.metrics:
            self.metrics.fabric_pulls.inc(outcome="ok" if ok else "error")
        if self.flight is not None:
            self.flight.record("fabric.pulled" if ok else "fabric.pull_failed", source=source,
                               prompt_tokens=len(prompt), restored=int(result.get("restored", 0)),
                               reason=result.get("reason", ""))
        return result

    def fabric_drop(self, prompt: list, adapter: Optional[int] = None) -> dict:
        """``POST /debug/fabric/drop``: release the arena copies of every
        cumulative full-page key of ``prompt`` (and its shipped logits);
        live and retained device pages stay."""
        ps = self.paged.page_size
        root = self._trie_root(adapter)
        dropped = 0
        with self._lock:
            for i in range(len(prompt) // ps):
                if self._kv_arena.pop(("prefix", root, tuple(prompt[: (i + 1) * ps]))) is not None:
                    dropped += 1
            self._kv_arena.pop(("logits", root, tuple(prompt)))
            if dropped:
                self.fabric_drops += 1
        if dropped and self.metrics:
            self.metrics.fabric_drops.inc()
        if dropped and self.flight is not None:
            self.flight.record("fabric.dropped", prompt_tokens=len(prompt), entries=dropped)
        return {"ok": True, "dropped": dropped}

    def fabric_state(self) -> dict:
        """Body of ``GET /debug/fabric`` on the engine."""
        digest = self.fabric_digest()
        with self._lock:
            return {
                "enabled": digest is not None,
                "digest": digest,
                "advertised_roots": int(digest["count"]) if digest else 0,
                "digest_builds": self.fabric_digest_builds,
                "arena_version": self._kv_arena.version,
                "trie_version": self._trie_version,
                "pulls": self.fabric_pulls,
                "pull_failures": self.fabric_pull_failures,
                "drops": self.fabric_drops,
            }


# ------------------------------------------------- logits wire section


def encode_logits_section(arr: np.ndarray) -> bytes:
    """``TPUHOLG1 | meta | blob``: the optional trailing section of a
    /v1/prefill stream, the prefill side's last-position logits."""
    blob = np.ascontiguousarray(arr).tobytes()
    meta = json.dumps(
        {
            "dtype": str(arr.dtype),
            "shape": [int(d) for d in arr.shape],
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "nbytes": len(blob),
        }
    ).encode()
    return LOGITS_MAGIC + struct.pack("<I", len(meta)) + meta + blob


def read_logits_section(f) -> Optional[np.ndarray]:
    """Parse the optional logits section off ``f`` (right after the last
    entry): None at a clean EOF; raises ``SnapshotError`` on a torn or
    corrupt section (the caller keeps the verified entries)."""
    magic = f.read(len(LOGITS_MAGIC))
    if not magic:
        return None
    if magic != LOGITS_MAGIC:
        raise snap.SnapshotError("bad logits-section magic")
    (meta_len,) = struct.unpack("<I", snap._read_exact(f, 4))
    try:
        meta = json.loads(snap._read_exact(f, meta_len))
    except ValueError as e:
        raise snap.SnapshotError(f"bad logits meta: {e}") from None
    blob = snap._read_exact(f, int(meta["nbytes"]))
    if (zlib.crc32(blob) & 0xFFFFFFFF) != int(meta["crc32"]):
        raise snap.SnapshotError("logits checksum mismatch")
    return np.frombuffer(blob, dtype=np.dtype(meta["dtype"])).reshape(tuple(meta["shape"]))


# --------------------------------------------------------- decode fetch


def fetch_prefill(engine, source: str, prompt: list, adapter: Optional[int] = None,
                  timeout_s: float = 30.0, trace_context: Optional[str] = None,
                  resident_only: bool = False) -> dict:
    """Decode-side pull: ``POST /v1/prefill`` on ``source`` (``host:port``),
    parse the streamed entries through the snapshot verifier (per-entry
    CRC, full layout compare, entry count) and admit them into the host
    arena, so the request's admission restores instead of recomputing.
    Parse happens before admit: any failure admits nothing and leaves the
    arena as it was, and the caller prefills locally.  Meters
    ``tpu_engine_handoff_fetches_total{outcome}``; the
    ``engine.handoff.fetch`` failpoint injects a dial failure (``error``)
    or a truncated read (``truncate[:fraction]``)."""
    import http.client
    import io

    if not engine._kv_arena.enabled:
        if engine.metrics:
            engine.metrics.handoff_fetches.inc(outcome="disabled")
        return {"ok": False, "reason": "arena_disabled", "restored": 0, "source": source}
    t0 = time.perf_counter()
    with engine._lock:
        expected_layout = snap.snapshot_layout(engine)
        expected_fp = engine.params_fingerprint
    host, _, port = source.rpartition(":")
    outcome = "corrupt"
    try:
        hit = failpoints.fire("engine.handoff.fetch", source=source)
        outcome = "unreachable"  # failures below here until parse starts
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
        try:
            headers = {
                "Content-Type": "application/json",
                snap.LAYOUT_HEADER: snap.layout_fingerprint(expected_layout),
                snap.PARAMS_HEADER: expected_fp,
            }
            if resident_only:
                headers[FABRIC_RESIDENT_ONLY_HEADER] = "1"
            if trace_context:
                from ..utils.spans import TRACE_CONTEXT_HEADER

                headers[TRACE_CONTEXT_HEADER] = trace_context
            body = {"prompt": [int(t) for t in prompt]}
            if adapter is not None:
                body["adapter"] = int(adapter)
            conn.request("POST", PREFILL_ROUTE, json.dumps(body).encode(), headers)
            resp = conn.getresponse()
            if resp.status != 200:
                outcome = "refused"
                raise snap.SnapshotError(f"prefill source refused: HTTP {resp.status}")
            outcome = "corrupt"  # transport/parse failures from here on
            reader = resp
            if hit is not None and hit.mode == "truncate":
                data = resp.read()
                frac = float(hit.arg) if hit.arg else 0.5
                reader = io.BytesIO(data[: int(len(data) * frac)])
            _, entries = snap._parse_snapshot(reader, expected_layout, expected_fp)
            # A torn or corrupt logits section is ignored: the entries
            # verified whole, the decode side just runs one tail chunk.
            try:
                logits = read_logits_section(reader)
            except (snap.SnapshotError, OSError, ValueError):
                logits = None
        finally:
            conn.close()
        restored = snap._admit_entries(engine, entries)
        if logits is not None:
            with engine._lock:
                engine._kv_arena.put(
                    ("logits", engine._trie_root(adapter), tuple(int(t) for t in prompt)),
                    {"logits": logits}, logits.nbytes,
                )
    except (failpoints.FailpointError, snap.SnapshotError, OSError, ValueError) as e:
        reason = str(e)
        if reason in ("layout_mismatch", "params_mismatch"):
            outcome = reason
        with engine._lock:
            engine.handoff_fetches += 1
            engine.handoff_fetch_failures += 1
        if engine.metrics:
            engine.metrics.handoff_fetches.inc(outcome=outcome)
        if engine.flight is not None:
            engine.flight.record("handoff.fetch_failed", source=source, reason=reason,
                                 outcome=outcome)
        return {"ok": False, "reason": reason, "outcome": outcome, "restored": 0,
                "source": source}
    with engine._lock:
        engine.handoff_fetches += 1
        engine.handoff_fetched_entries += restored
    if engine.metrics:
        engine.metrics.handoff_fetches.inc(outcome="ok")
        if restored:
            engine.metrics.handoff_entries.inc(restored, direction="fetched")
    result = {
        "ok": True,
        "source": source,
        "restored": restored,
        "logits": logits is not None,
        "ms": round((time.perf_counter() - t0) * 1e3, 3),
    }
    if engine.flight is not None:
        engine.flight.record("handoff.fetched", **result)
    return result
