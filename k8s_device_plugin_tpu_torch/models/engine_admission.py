"""Serving-engine admission: validation, queueing, the overload gate,
batched chunked prefill, activation, SLO accounting and the finish
conditions.

Counterpart of the reference's ``models/engine_admission.py``: ``submit``
takes the reference's arguments (logprobs, logit bias, trace ids,
priority, tenant, deadline, ``adapter`` on a multi-LoRA engine; a
speculative engine refuses logprobs and logit bias, as the reference), the
overload controller gates it and sweeps the queue, reserve admission
allocates a request's whole chain and optimistic admission its prompt
pages plus the first decode write.  A preempted request at the head is
rebuilt from the KV tiers when they cover it (engine_kvcache.py), else it
resumes by recomputing its effective prompt (prompt plus what it had
generated); a decode-role engine admits a handed-off prompt with no
prefill when its pages and logits are resident (engine_handoff.py).  A
prompt's trie walk continues into the host arena, whose pages restore
instead of prefilling.  Prefill runs every prompt through the dense
cached append (``cached_group_attention``) in length buckets: lengths pad
to a power of two <= max_len and batches to a power of two, so an
admission burst costs one forward per chunk; a decode-role engine seeds
the chunks every item's resident pages cover and skips them.  Mixed into
ServingEngine.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..utils import failpoints, prng
from ..utils.spans import new_trace_id
from .engine_overload import (
    PRIORITY_NAMES,
    SHED_EXPIRED,
    SHED_INFEASIBLE,
    ShedError,
    parse_priority,
)
from .engine_sampling import filter_top_k_top_p, token_logprob
from .engine_types import Request
from .transformer import DenseCache


class AdmissionMixin:
    """submit/cancel, the overload sweep, the prefill jobs, admission into
    slots, activation, SLO verdicts, finish."""

    MAX_STOPS = 8
    MAX_STOP_LEN = 32
    MAX_TENANT_LEN = 64

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        adapter: Optional[int] = None,
        logprobs: bool = False,
        stop: Optional[list] = None,
        logit_bias: Optional[dict] = None,
        trace_id: Optional[str] = None,
        trace_parent: str = "",
        trace_hop: int = 0,
        trace_attempt: int = 0,
        priority: int = 1,
        tenant: str = "",
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Queue one request (thread-safe); raises ValueError/TypeError on
        anything inadmissible and ``ShedError`` when the overload gate
        sheds it.  Rejects are flight events."""
        try:
            prompt, stop, logit_bias, priority, tenant, deadline_s = self._validate_submit(
                prompt, max_new_tokens, temperature, top_k, top_p, adapter, logprobs, stop,
                logit_bias, priority, tenant, deadline_s,
            )
        except (TypeError, ValueError) as e:
            if self.flight is not None:
                try:
                    ptoks = len(prompt)
                except TypeError:
                    ptoks = None
                self.flight.record("admission.reject", reason=str(e), prompt_tokens=ptoks,
                                   max_new_tokens=max_new_tokens)
            raise
        try:
            # Chaos seam: error rejects an otherwise valid request at the
            # door (a 422 on the HTTP path); delay stalls admission.
            failpoints.fire("engine.submit", prompt_tokens=len(prompt))
        except failpoints.FailpointError as e:
            if self.flight is not None:
                self.flight.record("admission.reject", reason=str(e), prompt_tokens=len(prompt),
                                   max_new_tokens=max_new_tokens)
            raise ValueError(str(e)) from None
        with self._lock:
            now = time.monotonic()
            deadline = None if deadline_s is None else now + deadline_s
            if self.overload is not None:
                # The submit-side gate: a spent deadline fails fast (504),
                # the adaptive shedder rejects lowest priority first (503
                # with a Retry-After from the measured drain rate).
                try:
                    if deadline is not None and deadline <= now:
                        raise ShedError("deadline expired before admission", SHED_EXPIRED, 0.0)
                    self.overload.check_admission(priority, len(self.queue))
                except ShedError as e:
                    self.overload.record_shed(None, e.kind, priority=priority, tenant=tenant,
                                              prompt_tokens=len(prompt), at="submit")
                    self._slo_observe_submit_shed(tenant)
                    raise
            req = Request(
                prompt, max_new_tokens, temperature, top_k, top_p,
                adapter=adapter, logprobs=logprobs, stop=stop, logit_bias=logit_bias,
                priority=priority, tenant=tenant, deadline=deadline,
                trace_id=trace_id or new_trace_id(),
                trace_parent=str(trace_parent or ""),
                trace_hop=int(trace_hop), trace_attempt=int(trace_attempt),
                rid=self._next_rid, submitted_at=now,
            )
            if self.spans:
                # Reserved now so the owner thread's child spans can parent
                # on it before the root is recorded at finish.
                req.root_span = self.spans.reserve_id()
            self._next_rid += 1
            self.queue.append(req)
            self._update_gauges()
        return req

    def _validate_submit(self, prompt, max_new_tokens, temperature, top_k, top_p, adapter,
                         logprobs, stop, logit_bias, priority=1, tenant="", deadline_s=None):
        """Normalize and validate one submit's arguments (the reference's
        checks and messages); returns (prompt, stop, logit_bias, priority,
        tenant, deadline_s)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        # The port also refuses ids its embedding cannot index.
        if any(not 0 <= t < self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt token ids must be in [0, {self.cfg.vocab_size})")
        priority = parse_priority(priority)
        tenant = str(tenant or "")
        if len(tenant) > self.MAX_TENANT_LEN:
            raise ValueError(f"tenant is capped at {self.MAX_TENANT_LEN} chars, got {len(tenant)}")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not math.isfinite(deadline_s):
                raise ValueError(f"deadline_s must be finite, got {deadline_s}")
        if stop is not None:
            stop = [[int(t) for t in seq] for seq in stop]
            if not stop or any(not seq for seq in stop):
                raise ValueError("stop must be a non-empty list of non-empty token-id sequences")
            if len(stop) > self.MAX_STOPS:
                raise ValueError(f"at most {self.MAX_STOPS} stop sequences, got {len(stop)}")
            too_long = [seq for seq in stop if len(seq) > self.MAX_STOP_LEN]
            if too_long:
                raise ValueError(
                    f"stop sequences are capped at {self.MAX_STOP_LEN} tokens, got one of "
                    f"length {max(len(s) for s in too_long)}"
                )
        if logit_bias is not None:
            logit_bias = {int(t): float(v) for t, v in logit_bias.items()}
            if not logit_bias or len(logit_bias) > self.MAX_BIAS:
                raise ValueError(
                    f"logit_bias must have 1..{self.MAX_BIAS} entries, got {len(logit_bias)}"
                )
            bad = [t for t in logit_bias if not 0 <= t < self.cfg.vocab_size]
            if bad:
                raise ValueError(f"logit_bias ids out of vocab range: {bad}")
            if self._spec_gamma:
                # The round's acceptance scores the unbiased distributions;
                # biasing only the emitted pick would break its exactness.
                raise ValueError("logit_bias is not supported on a speculative engine")
        if logprobs and self._spec_gamma:
            # Accepted draft tokens come back without the target's
            # log-softmax at their positions.
            raise ValueError("logprobs is not supported on a speculative engine (spec_gamma > 0)")
        if adapter is not None:
            if not self.cfg.lora_serve:
                raise ValueError("adapter requires an engine built with cfg.lora_serve")
            if not 0 <= adapter < self.cfg.lora_serve:
                raise ValueError(f"adapter must be in [0, {self.cfg.lora_serve}), got {adapter}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and not 1 <= top_k <= self.cfg.vocab_size:
            raise ValueError(f"top_k must be in [1, vocab_size={self.cfg.vocab_size}], got {top_k}")
        if top_p is not None and not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        need = len(prompt) + max_new_tokens
        if need > self.paged.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds paged max_len "
                f"{self.paged.max_len}"
            )
        # Admissible, not just addressable: page 0 is never allocated, and a
        # request that can never fit would block the queue head forever.
        allocatable = (self.paged.num_pages - 1) * self.paged.page_size
        if need > allocatable:
            raise ValueError(
                f"request needs {need} cache slots but the pool only ever has {allocatable} "
                f"({self.paged.num_pages - 1} allocatable pages x {self.paged.page_size})"
            )
        return prompt, stop, logit_bias, priority, tenant, deadline_s

    def cancel(self, req: Request) -> bool:
        """Stop generating for ``req``.  A queued request finishes here; an
        in-flight one is torn down at the next step boundary.  False if it
        had already finished."""
        with self._lock:
            if req.done:
                return False
            req.cancelled = True
            try:
                self.queue.remove(req)
            except ValueError:
                pass  # admitted: the next step cleans up
            else:
                req.done = True
                # A preempted request dying in the queue never resumes.
                self._kv_drop_snapshot(req.rid)
                if self.overload is not None:
                    self.overload.on_finish(req)
                # Excluded from the SLI verdicts, still metered.
                self._slo_observe_finish(req, time.monotonic())
            self._update_gauges()
            return True

    def _overload_sweep(self) -> list[Request]:
        """Before admission: shed queued requests whose deadline passed,
        mark in-slot requests that can no longer finish in time, tick the
        AIMD limiter.  Returns the queued requests shed here."""
        ctl = self.overload
        now = time.monotonic()
        finished: list[Request] = []
        with self._lock:
            expired = [r for r in self.queue if not r.cancelled and ctl.expired(r, now)]
            for req in expired:
                self.queue.remove(req)
                req.shed = SHED_EXPIRED
                req.done = True
                req.finished_at = now
                self._kv_drop_snapshot(req.rid)
                ctl.record_shed(req, SHED_EXPIRED, waited_s=round(now - req.submitted_at, 3))
                ctl.on_finish(req)
                self._slo_observe_finish(req, now)
                finished.append(req)
            if expired:
                self._update_gauges()
        for s in range(self.max_slots):
            req = self.slots[s]
            if (req is None or req.done or req.cancelled or req.shed is not None
                    or not self._slot_ready[s]):
                continue
            if ctl.infeasible(req, now):
                # The cancel sweep tears it down through the ordinary path.
                req.shed = SHED_INFEASIBLE
                req.cancelled = True
                ctl.record_shed(
                    req, SHED_INFEASIBLE, slot=s,
                    remaining_tokens=req.max_new_tokens - len(req.tokens),
                    remaining_s=round((req.deadline or now) - now, 3),
                )
        ctl.maybe_adjust()
        return finished

    def _bucket(self, plen: int) -> int:
        return min(1 << (plen - 1).bit_length(), self.paged.max_len)

    def _start_prefill(self, items: list[tuple[int, Request, list[int], int]]):
        """One prefill JOB for a same-bucket admission group.  Padding is
        sound: attention is causal, so positions >= plen cannot reach
        logits[plen - 1], and the graft copies only rows [:plen].  A
        resumed request prefills its effective prompt."""
        prompts = [it[1].prompt + it[1].tokens for it in items]
        bucket = self._bucket(max(len(p) for p in prompts))
        chunk = min(self._prefill_chunk or bucket, bucket)
        n = len(prompts)
        batch = 1 << (n - 1).bit_length()
        rows = [p + [0] * (bucket - len(p)) for p in prompts]
        rows += [rows[0]] * (batch - n)  # pad rows are discarded
        last_idx = [len(p) - 1 for p in prompts] + [0] * (batch - n)
        ids = None
        if self.cfg.lora_serve:
            ids = [it[1].adapter if it[1].adapter is not None else -1 for it in items]
            ids += [ids[0]] * (batch - n)  # pad rows are discarded anyway
        job_id, self._job_counter = self._job_counter, self._job_counter + 1
        dev = self._device_op("prefill_new", job_id, batch, bucket, rows, ids)
        skip = 0
        if self._handoff_skip_covered:
            # Chunk-aligned positions every item's shared or restored pages
            # cover, kept below every last position so the chunk whose
            # logits sample the admission token always runs.
            ps = self.paged.page_size
            skip = min(min(it[3] * ps for it in items), min(len(p) for p in prompts) - 1)
            skip -= skip % chunk
        if skip > 0:
            self._seed_dense(job_id, items, skip)
        self._pending.append({
            "id": job_id,
            "items": items,
            "bucket": bucket,
            "chunk": chunk,
            "batch": batch,
            "last_idx": last_idx,
            "cache": dev["cache"],  # the leader's shard (engine_handoff reads it)
            "pos": skip,
            "logits": [None] * n,
        })

    def _op_prefill_new(self, job_id: int, batch: int, bucket: int, rows: list,
                        adapter_ids: Optional[list]) -> dict:
        """A prefill job's device objects: its bucket-sized dense cache (the
        rank's kv heads), token rows and adapter ids, kept under ``job_id``
        until :meth:`_op_prefill_drop`."""
        dev = self._jobs[job_id] = {
            "cache": DenseCache.zeros(self.cfg, batch, self.device, max_seq=bucket, tp=self._tp),
            "rows": torch.tensor(rows, dtype=torch.long, device=self.device),
            "aids": None if adapter_ids is None else torch.tensor(adapter_ids,
                                                                  device=self.device),
        }
        return dev

    def _op_prefill_drop(self, job_id: int) -> None:
        del self._jobs[job_id]

    def _seed_dense(self, job_id: int, items: list, skip: int) -> None:
        """Copy positions [0, skip) of each item's resident pages into the
        job's dense cache and start its write index there: those rows are
        the bytes a recompute at the same bucket writes, so the covered
        chunks need not run.  One gather per pool per layer per item."""
        self._wd_grace("handoff_seed")
        ps = self.paged.page_size
        self._device_op("seed", job_id, [it[2][: -(-skip // ps)] for it in items], skip)
        self.handoff_skipped_tokens += skip * len(items)

    def _op_seed(self, job_id: int, item_pages: list, skip: int) -> None:
        cache = self._jobs[job_id]["cache"]
        for row_idx, pages in enumerate(item_pages):
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            for layer in range(self.cfg.num_layers):
                for pool, slab in zip(self.cache.layer(layer), cache.layer(layer)):
                    if pool is None:  # float pools carry no scales
                        continue
                    rows = pool.index_select(0, idx)
                    slab[row_idx, :skip] = rows.reshape(-1, *rows.shape[2:])[:skip]
        cache.index = skip

    def _advance_prefill(self, job: dict) -> bool:
        """Run ONE chunk of a prefill job (a cached append of ``chunk``
        tokens against the bucket-sized dense cache); True when done."""
        # Prefill dwarfs a decode step, and a new shape may build kernels.
        self._wd_grace("prefill")
        chunk, pos = job["chunk"], job["pos"]
        # Each row's true-last-position logits, from the chunk covering it.
        sel = [i for i, last in enumerate(job["last_idx"][: len(job["items"])]) if pos <= last < pos + chunk]
        logits = self._device_op("prefill_chunk", job["id"], pos, chunk, sel,
                                 [job["last_idx"][i] - pos for i in sel])
        self.prefill_positions += chunk * len(job["items"])
        for j, i in enumerate(sel):
            job["logits"][i] = logits[j]
        job["pos"] = pos + chunk
        # Chunks past every row's last position compute nothing anyone reads.
        if job["pos"] > max(job["last_idx"]):
            job["pos"] = job["bucket"]
        if self._handoff_taps:
            self._handoff_feed(job)
        return job["pos"] >= job["bucket"]

    def _op_prefill_chunk(self, job_id: int, pos: int, chunk: int, sel: list,
                          idx: list) -> Optional[torch.Tensor]:
        """One cached append of ``chunk`` tokens at ``pos`` against the job's
        dense cache; the float32 logits (the full vocabulary) of rows ``sel``
        at their positions ``idx`` in the chunk, or None."""
        job = self._jobs[job_id]
        batch = job["rows"].shape[0]
        tokens = job["rows"][:, pos : pos + chunk]
        positions = (pos + torch.arange(chunk, device=self.device)).expand(batch, chunk)
        aids = job["aids"]
        hidden = self.model(
            tokens, positions, cache=job["cache"], append_mode="cached", output="hidden",
            adapter_ids=aids,
        )
        if not sel:
            return None
        rows = torch.tensor(sel, device=self.device)
        at = torch.tensor(idx, device=self.device)
        return self.model.logits(hidden[rows, at], None if aids is None else aids[rows])

    def _admit(self) -> list[Request]:
        """Admit queued requests into free slots, the queue head first
        (the overload controller picks the head when installed), then
        group the admitted by length bucket into prefill jobs.  The head
        waits for pages rather than being overtaken."""
        admitted: list[tuple[int, Request, list[int], int]] = []
        burst_pages: dict[int, int] = {}  # page -> length bucket, this burst
        was_page_blocked = self._admit_page_blocked
        self._admit_page_blocked = False
        for slot in range(self.max_slots):
            with self._lock:
                # A cancel racing an eviction can leave a cancelled request
                # at the head: finish it here.
                while self.queue and self.queue[0].cancelled:
                    dead = self.queue.popleft()
                    dead.done = True
                    self._kv_drop_snapshot(dead.rid)
                    self._slo_observe_finish(dead, time.monotonic())
                if self.slots[slot] is not None or not self.queue:
                    continue
                if self.overload is not None:
                    # AIMD admitted-concurrency cap: slots past the limit
                    # stay idle while queue wait is past target.
                    if sum(1 for r in self.slots if r is not None) >= self.overload.concurrency_limit():
                        break
                    idx = self.overload.select_index(self.queue)
                    if idx:
                        chosen = self.queue[idx]
                        del self.queue[idx]
                        self.queue.appendleft(chosen)
                req = self.queue[0]
                # A preempted request back at the head: rebuilt from the
                # KV tiers, no prefill, when they cover it.
                if self._kv_retain and self._kv_try_restore_resume(slot, req):
                    continue
                # Decode role: a fresh page-aligned prompt whose pages and
                # shipped logits are resident admits with no prefill.
                if (self._handoff_skip_covered and not req.tokens
                        and self._handoff_try_admit(slot, req)):
                    continue
                eff = req.prompt + req.tokens  # the effective prompt
                plen = len(eff)
                bucket = self._bucket(plen)
                if self._optimistic:
                    # Prompt pages and the first decode write; generation
                    # pages come on demand (_ensure_frontier).
                    n_pages = math.ceil((plen + 1) / self.paged.page_size)
                else:
                    n_pages = math.ceil((plen + req.max_new_tokens) / self.paged.page_size)
                shared = (self._match_prefix(eff, bucket, burst_pages, req.adapter)
                          if self.prefix_sharing else [])
                # The trie walk continues into the host arena: those pages
                # are restored below and count as shared (the graft never
                # rewrites them).
                host = (self._kv_match_host(eff, req.adapter, len(shared),
                                            plen // self.paged.page_size)
                        if self.prefix_sharing and self._kv_retain else [])
                n_private = n_pages - len(shared)
                if n_private > len(self.free_pages):
                    # Retained pages are one reclaim away from free; the
                    # protect set pins this request's own match.
                    self._kv_reclaim(n_private - len(self.free_pages), protect=frozenset(shared))
                if n_private > len(self.free_pages):
                    self._admit_page_blocked = True
                    break
                self.queue.popleft()
                req.admitted_at = time.monotonic()
                if not req.tokens:
                    # A fresh admission: the queue wait, the AIMD input.
                    wait_s = req.admitted_at - req.submitted_at
                    if self.metrics:
                        self.metrics.queue_wait_seconds.observe(
                            wait_s, priority=PRIORITY_NAMES[req.priority])
                    if self.overload is not None:
                        self.overload.observe_admission(req, wait_s)
                private = [self.free_pages.popleft() for _ in range(n_private)]
                pages = shared + private
                for page in shared:
                    self._page_refs[page] += 1
                    if self._page_refs[page] == 1:
                        self._kv_revive(page)  # 0 -> 1: off the retained tier
                n_restored = len(host)
                if n_restored:
                    self._kv_restore_pages(private[:n_restored], [e["rows"] for e in host])
                for page in private[n_restored:]:
                    # Ungrafted until _activate: shareable within this
                    # burst's same-bucket group only (restored pages are
                    # on the device already, shareable at once).
                    burst_pages[page] = bucket
                    self._pending_pages.add(page)
                for page in private:
                    self._page_refs[page] = 1
                if self.prefix_sharing:
                    self._register_prefix(eff, pages, plen // self.paged.page_size, req.adapter)
                self.slots[slot] = req
                self._slot_pages[slot] = pages
                self._slot_seq[slot] = self._seq_counter
                self._seq_counter += 1
                shared = pages[: len(shared) + n_restored]
            if self.spans:
                self.spans.record_span(
                    "pages.alloc", req.trace_id, start_monotonic=req.admitted_at,
                    parent_id=req.root_span,
                    attrs={"rid": req.rid, "pages": len(pages), "shared": len(shared)},
                )
            admitted.append((slot, req, pages, len(shared)))
        if self._admit_page_blocked and not was_page_blocked and self.flight is not None:
            with self._lock:
                qd, free = len(self.queue), len(self.free_pages)
            self.flight.record("admission.page_blocked", queue_depth=qd, free_pages=free)
        groups: dict[int, list] = {}
        for item in admitted:
            groups.setdefault(self._bucket(len(item[1].prompt) + len(item[1].tokens)), []).append(item)
        for items in groups.values():
            self._start_prefill(items)
        return []

    def _set_slot_sampler(self, slot: int, req: Request) -> None:
        """A greedy slot's token is the argmax whatever top_k/top_p say, so
        they normalise to off and keep the batch off the filtered path; a
        logit bias pads to ``MAX_BIAS`` (id 0, value 0.0: a no-op)."""
        if req.temperature > 0:
            topk = req.top_k if req.top_k is not None else self.cfg.vocab_size
            topp = req.top_p if req.top_p is not None else 1.0
        else:
            topk, topp = self.cfg.vocab_size, 1.0
        self._slot_temp[slot] = req.temperature
        self._slot_aid[slot] = req.adapter if req.adapter is not None else -1
        self._slot_topk[slot] = topk
        self._slot_topp[slot] = topp
        ids, vals = list(req.logit_bias or {}), list((req.logit_bias or {}).values())
        pad = self.MAX_BIAS - len(ids)
        self._slot_bias_ids[slot] = ids + [0] * pad
        self._slot_bias_vals[slot] = vals + [0.0] * pad

    def _sample_first_token(self, req: Request, last_logits) -> int:
        """The admission token from the prompt's last-position logits, by
        the decode step's math: the bias changes what is picked, the
        logprob is the unbiased one; a sampled pick takes one split of the
        engine's key (the reference's schedule)."""
        picked = last_logits
        if req.logit_bias:
            ids = torch.tensor(list(req.logit_bias), device=self.device)
            vals = torch.tensor(list(req.logit_bias.values()), dtype=torch.float32,
                                device=self.device)
            picked = last_logits.index_add(0, ids, vals.to(last_logits.dtype))
        if req.temperature > 0:
            topk = req.top_k if req.top_k is not None else self.cfg.vocab_size
            topp = req.top_p if req.top_p is not None else 1.0
            self._rng, sub = prng.split(self._rng)
            row = filter_top_k_top_p(
                (picked / req.temperature)[None, :],
                torch.tensor([topk], device=self.device),
                torch.tensor([topp], dtype=torch.float32, device=self.device),
            )
            first = int(prng.categorical(sub.to(self.device), row[0]))
        else:
            first = int(picked.argmax())
        if req.logprobs:
            # Before the token: a streaming reader never sees a token
            # without its logprob.
            req.token_logprobs.append(float(token_logprob(
                last_logits[None, :], torch.tensor([first], device=self.device))[0]))
        return first

    def _activate(self, job: dict) -> list[Request]:
        """Graft a finished prefill job's K/V into pages, sample each
        request's first token, and mark the slots ready to decode."""
        self._wd_grace("activate")
        finished: list[Request] = []
        for row_idx, (slot, req, pages, n_shared) in enumerate(job["items"]):
            resumed = bool(req.tokens)
            plen = len(req.prompt) + len(req.tokens)
            self._graft(slot, job["id"], pages, plen, n_shared, row_idx=row_idx)
            grafted = self._pending_pages.intersection(pages[n_shared:])
            if grafted:
                self._pending_pages.difference_update(grafted)
                with self._lock:
                    self._trie_version += 1
            first = self._sample_first_token(req, job["logits"][row_idx])
            req.tokens.append(first)
            self._slot_last[slot] = first
            self._slot_len[slot] = plen
            self._set_slot_sampler(slot, req)
            self._slot_ready[slot] = True
            if resumed:
                # Recompute-resume after a preemption.
                self.kv_resumes_recompute += 1
                self.kv_resume_recomputed_tokens += plen
                if self.metrics:
                    self.metrics.resumes.inc(mode="recompute")
                    self.metrics.resume_recomputed_tokens.inc(plen)
                if self.flight is not None:
                    self.flight.record("engine.resume", rid=req.rid, mode="recompute",
                                       restored_tokens=0, recomputed_tokens=plen,
                                       pages_shared=n_shared)
            now = time.monotonic()
            req.first_token_at = now
            self._slot_emit_t[slot] = now
            self._step_tokens += 1  # the admission token counts (profiler)
            if self.metrics:
                if not resumed:
                    self.metrics.requests.inc()
                    self.metrics.wait_seconds.observe(now - req.submitted_at)
                    self.metrics.ttft_seconds.observe(now - req.submitted_at)
                self.metrics.tokens.inc()
            if not resumed and self.anomaly is not None:
                self.anomaly.observe("engine.ttft_seconds", now - req.submitted_at)
            if self.spans and not resumed:
                self.spans.record_span(
                    "queue", req.trace_id, start_monotonic=req.submitted_at,
                    end_monotonic=req.admitted_at, parent_id=req.root_span,
                    attrs={"rid": req.rid, "wait_s": round(req.admitted_at - req.submitted_at, 6)},
                )
                self.spans.record_span(
                    "prefill", req.trace_id, start_monotonic=req.admitted_at,
                    end_monotonic=now, parent_id=req.root_span,
                    attrs={"rid": req.rid, "prompt_tokens": plen, "bucket": job["bucket"],
                           "batched_with": len(job["items"]) - 1},
                )
            self._maybe_finish(slot)
            if req.done:
                finished.append(req)
        self._device_op("prefill_drop", job["id"])
        # Activated slots carry fresh scalars: rebuild the step state.
        self._mark_state_dirty()
        return finished

    @staticmethod
    def _hit_stop(req: Request) -> bool:
        """True when the output's tail equals a stop sequence (or already
        did): truncates the matched suffix (and its logprobs) and latches
        ``req.stopped``."""
        if req.stopped:
            return True
        for seq in req.stop or ():
            n = len(seq)
            if n and len(req.tokens) >= n and req.tokens[-n:] == seq:
                del req.tokens[-n:]
                if req.logprobs:
                    del req.token_logprobs[len(req.tokens):]
                req.stopped = True
                return True
        return False

    def _slo_observe_finish(self, req, now: float, slot=None):
        """SLI verdicts and tenant usage at the end of a request's life
        (caller holds the engine lock; no-op with the SLO plane off): a
        shed is an availability failure, a cancel is excluded, latency
        objectives score requests that emitted tokens."""
        if self.slo is None:
            return
        if req.shed is not None:
            self._slo_emit("availability", False)
        elif not req.cancelled:
            self._slo_emit("availability", True)
            if req.tokens and req.first_token_at > 0.0:
                ttft = self.slo.objectives.get("ttft")
                if ttft is not None and ttft.threshold_s is not None:
                    self._slo_emit("ttft", req.first_token_at - req.submitted_at <= ttft.threshold_s)
                itl = self.slo.objectives.get("itl_p99")
                if itl is not None and itl.threshold_s is not None and req.itl_peak_s > 0.0:
                    self._slo_emit("itl_p99", req.itl_peak_s <= itl.threshold_s)
        if self.usage is not None:
            admitted = req.admitted_at > 0.0
            queue_wait = max(0.0, (req.admitted_at if admitted else now) - req.submitted_at)
            pages = 0
            if slot is not None:
                pages = self._slot_page_base[slot] + len(self._slot_pages[slot])
            kv_page_s = pages * max(0.0, now - req.admitted_at) if admitted else 0.0
            label = self.usage.record_request(
                req.tenant,
                prompt_tokens=len(req.prompt) if admitted else 0,
                decode_tokens=len(req.tokens),
                kv_page_seconds=kv_page_s,
                queue_wait_seconds=queue_wait,
            )
            if self.metrics:
                m = self.metrics
                m.tenant_requests.inc(tenant=label)
                if admitted and req.prompt:
                    m.tenant_prompt_tokens.inc(len(req.prompt), tenant=label)
                if req.tokens:
                    m.tenant_decode_tokens.inc(len(req.tokens), tenant=label)
                if kv_page_s > 0.0:
                    m.tenant_kv_page_seconds.inc(kv_page_s, tenant=label)
                if queue_wait > 0.0:
                    m.tenant_queue_wait_seconds.inc(queue_wait, tenant=label)

    def _slo_emit(self, objective: str, good: bool):
        self.slo.record(objective, good)
        if self.metrics:
            self.metrics.sli_events.inc(objective=objective, verdict="good" if good else "bad")

    def _slo_observe_submit_shed(self, tenant: str):
        """A submit-side shed: one bad availability verdict and one metered
        (empty) usage row."""
        if self.slo is None:
            return
        self._slo_emit("availability", False)
        if self.usage is not None:
            label = self.usage.record_request(tenant)
            if self.metrics:
                self.metrics.tenant_requests.inc(tenant=label)

    def observe_submit_shed(self, tenant: str = ""):
        """For door sheds that never reach submit (the HTTP layer's
        deadline <= 0 fail-fast 504)."""
        tenant = str(tenant or "")[: self.MAX_TENANT_LEN]
        with self._lock:
            self._slo_observe_submit_shed(tenant)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        if (
            req.cancelled
            or len(req.tokens) >= req.max_new_tokens
            or (self.eos_id is not None and req.tokens and req.tokens[-1] == self.eos_id)
            or self._hit_stop(req)
        ):
            req.done = True
            req.finished_at = time.monotonic()
            if self.overload is not None:
                self.overload.on_finish(req)
            # Before _clear_slot, so the page count is still live.
            self._slo_observe_finish(req, req.finished_at, slot=slot)
            if (
                self.metrics
                and req.tokens
                and req.shed is None
                and not req.cancelled
                and (req.deadline is None or req.finished_at <= req.deadline)
            ):
                self.metrics.goodput_tokens.inc(len(req.tokens))
            if self.spans:
                self.spans.record_span(
                    "decode", req.trace_id, start_monotonic=req.first_token_at or req.finished_at,
                    end_monotonic=req.finished_at, parent_id=req.root_span,
                    attrs={"rid": req.rid, "tokens": len(req.tokens)},
                )
                outcome = (f"shed:{req.shed}" if req.shed else "cancelled" if req.cancelled
                           else "stopped" if req.stopped else "completed")
                root_attrs = {"rid": req.rid, "prompt_tokens": len(req.prompt),
                              "new_tokens": len(req.tokens), "outcome": outcome}
                if req.trace_parent:
                    root_attrs.update(parent=req.trace_parent, hop=req.trace_hop,
                                      attempt=req.trace_attempt)
                self.spans.record_span(
                    "request", req.trace_id, start_monotonic=req.submitted_at,
                    end_monotonic=req.finished_at, span_id=req.root_span, attrs=root_attrs,
                )
            self._clear_slot(slot)
