"""Serving-engine admission: validation, queueing, batched chunked
prefill, activation and the finish conditions.

Counterpart of the reference's ``models/engine_admission.py`` for reserve
admission, with no overload, SLO or handoff branches.  Prefill runs every
prompt through the dense cached append (``cached_group_attention``) in
length buckets: lengths pad to a power of two <= max_len and batches to a
power of two, so an admission burst costs one forward per chunk.  Mixed
into ServingEngine.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..utils import prng
from .engine_sampling import filter_top_k_top_p
from .engine_types import Request
from .transformer import DenseCache


class AdmissionMixin:
    """submit/cancel, the prefill jobs, admission into slots, finish."""

    MAX_STOPS = 8
    MAX_STOP_LEN = 32

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               stop: Optional[list] = None) -> Request:
        """Queue one request (thread-safe); raises ValueError/TypeError on
        anything inadmissible."""
        prompt, stop = self._validate_submit(prompt, max_new_tokens, temperature, top_k, top_p, stop)
        with self._lock:
            req = Request(
                prompt, max_new_tokens, temperature, top_k, top_p, stop=stop,
                rid=self._next_rid, submitted_at=time.monotonic(),
            )
            self._next_rid += 1
            self.queue.append(req)
            self._update_gauges()
        return req

    def _validate_submit(self, prompt, max_new_tokens, temperature, top_k, top_p, stop):
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt token ids must be in [0, {self.cfg.vocab_size})")
        if stop is not None:
            stop = [[int(t) for t in seq] for seq in stop]
            if not stop or any(not seq for seq in stop):
                raise ValueError("stop must be a non-empty list of non-empty token-id sequences")
            if len(stop) > self.MAX_STOPS:
                raise ValueError(f"at most {self.MAX_STOPS} stop sequences, got {len(stop)}")
            if any(len(seq) > self.MAX_STOP_LEN for seq in stop):
                raise ValueError(f"stop sequences are capped at {self.MAX_STOP_LEN} tokens")
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
        # request that can never fit would block the FIFO head forever.
        allocatable = (self.paged.num_pages - 1) * self.paged.page_size
        if need > allocatable:
            raise ValueError(
                f"request needs {need} cache slots but the pool only ever has {allocatable}"
            )
        return prompt, stop

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
            self._update_gauges()
            return True

    def _bucket(self, plen: int) -> int:
        return min(1 << (plen - 1).bit_length(), self.paged.max_len)

    def _start_prefill(self, items: list[tuple[int, Request, list[int], int]]):
        """One prefill JOB for a same-bucket admission group.  Padding is
        sound: attention is causal, so positions >= plen cannot reach
        logits[plen - 1], and the graft copies only rows [:plen]."""
        prompts = [it[1].prompt for it in items]
        bucket = self._bucket(max(len(p) for p in prompts))
        chunk = min(self._prefill_chunk or bucket, bucket)
        n = len(prompts)
        batch = 1 << (n - 1).bit_length()
        rows = [p + [0] * (bucket - len(p)) for p in prompts]
        rows += [rows[0]] * (batch - n)  # pad rows are discarded
        last_idx = [len(p) - 1 for p in prompts] + [0] * (batch - n)
        self._pending.append({
            "items": items,
            "bucket": bucket,
            "chunk": chunk,
            "batch": batch,
            "rows": torch.tensor(rows, dtype=torch.long, device=self.device),
            "last_idx": last_idx,
            "cache": DenseCache.zeros(self.cfg, batch, self.device, max_seq=bucket),
            "pos": 0,
            "logits": [None] * n,
        })

    def _advance_prefill(self, job: dict) -> bool:
        """Run ONE chunk of a prefill job (a cached append of ``chunk``
        tokens against the bucket-sized dense cache); True when done."""
        chunk, pos, batch = job["chunk"], job["pos"], job["batch"]
        tokens = job["rows"][:, pos : pos + chunk]
        positions = (pos + torch.arange(chunk, device=self.device)).expand(batch, chunk)
        hidden = self.model(
            tokens, positions, cache=job["cache"], append_mode="cached", output="hidden"
        )
        # Each row's true-last-position logits, from the chunk covering it.
        sel = [i for i, last in enumerate(job["last_idx"][: len(job["items"])]) if pos <= last < pos + chunk]
        if sel:
            idx = torch.tensor([job["last_idx"][i] - pos for i in sel], device=self.device)
            logits = self.model.logits(hidden[torch.tensor(sel, device=self.device), idx])
            for j, i in enumerate(sel):
                job["logits"][i] = logits[j]
        job["pos"] = pos + chunk
        # Chunks past every row's last position compute nothing anyone reads.
        if job["pos"] > max(job["last_idx"]):
            job["pos"] = job["bucket"]
        return job["pos"] >= job["bucket"]

    def _admit(self) -> None:
        """Admit queued requests into free slots (FIFO; the head waits for
        pages rather than being overtaken), then group the admitted by
        length bucket into prefill jobs."""
        admitted: list[tuple[int, Request, list[int], int]] = []
        burst_pages: dict[int, int] = {}  # page -> length bucket, this burst
        # Whether this pass left the head stuck on a page shortage: nothing
        # admits until something frees, so the decode-block gate and the
        # overlap round need not stay fine-grained for it.
        self._admit_page_blocked = False
        for slot in range(self.max_slots):
            with self._lock:
                if self.slots[slot] is not None or not self.queue:
                    continue
                req = self.queue[0]
                plen = len(req.prompt)
                bucket = self._bucket(plen)
                n_pages = math.ceil((plen + req.max_new_tokens) / self.paged.page_size)
                shared = (
                    self._match_prefix(req.prompt, bucket, burst_pages)
                    if self.prefix_sharing
                    else []
                )
                n_private = n_pages - len(shared)
                if n_private > len(self.free_pages):
                    # FIFO: wait for pages rather than starve the head.
                    self._admit_page_blocked = True
                    break
                self.queue.popleft()
                private = [self.free_pages.popleft() for _ in range(n_private)]
                pages = shared + private
                for page in shared:
                    self._page_refs[page] += 1
                for page in private:
                    self._page_refs[page] = 1
                    # Ungrafted until _activate: shareable within this
                    # burst's same-bucket group only.
                    burst_pages[page] = bucket
                    self._pending_pages.add(page)
                if self.prefix_sharing:
                    self._register_prefix(req.prompt, pages, plen // self.paged.page_size)
                self.slots[slot] = req
                self._slot_pages[slot] = pages
            admitted.append((slot, req, pages, len(shared)))
        groups: dict[int, list] = {}
        for item in admitted:
            groups.setdefault(self._bucket(len(item[1].prompt)), []).append(item)
        for items in groups.values():
            self._start_prefill(items)

    def _set_slot_sampler(self, slot: int, req: Request) -> None:
        """A greedy slot's token is the argmax whatever top_k/top_p say, so
        they normalise to off and keep the batch off the filtered path."""
        if req.temperature > 0:
            topk = req.top_k if req.top_k is not None else self.cfg.vocab_size
            topp = req.top_p if req.top_p is not None else 1.0
        else:
            topk, topp = self.cfg.vocab_size, 1.0
        self._slot_temp[slot] = req.temperature
        self._slot_topk[slot] = topk
        self._slot_topp[slot] = topp

    def _sample_first_token(self, req: Request, last_logits) -> int:
        """The admission token from the prompt's last-position logits, by
        the same math as the decode step; a sampled one takes one split of
        the engine's key (the reference's schedule)."""
        if req.temperature <= 0:
            return int(last_logits.argmax())
        topk = req.top_k if req.top_k is not None else self.cfg.vocab_size
        topp = req.top_p if req.top_p is not None else 1.0
        self._rng, sub = prng.split(self._rng)
        row = filter_top_k_top_p(
            (last_logits / req.temperature)[None, :],
            torch.tensor([topk], device=self.device),
            torch.tensor([topp], dtype=torch.float32, device=self.device),
        )
        return int(prng.categorical(sub, row[0]))

    def _activate(self, job: dict) -> list[Request]:
        """Graft a finished prefill job's K/V into pages, sample each
        request's first token, and mark the slots ready to decode."""
        finished: list[Request] = []
        for row_idx, (slot, req, pages, n_shared) in enumerate(job["items"]):
            plen = len(req.prompt)
            self._graft(slot, job["cache"], pages, plen, n_shared, row_idx=row_idx)
            self._pending_pages.difference_update(pages[n_shared:])
            first = self._sample_first_token(req, job["logits"][row_idx])
            req.tokens.append(first)
            self._slot_last[slot] = first
            self._slot_len[slot] = plen
            self._set_slot_sampler(slot, req)
            self._slot_ready[slot] = True
            now = time.monotonic()
            req.first_token_at = now
            self._slot_emit_t[slot] = now
            if self.metrics:
                self.metrics.requests.inc()
                self.metrics.wait_seconds.observe(now - req.submitted_at)
                self.metrics.ttft_seconds.observe(now - req.submitted_at)
                self.metrics.tokens.inc()
            self._maybe_finish(slot)
            if req.done:
                finished.append(req)
        # Activated slots carry fresh scalars: rebuild the step state.
        self._mark_state_dirty()
        return finished

    @staticmethod
    def _hit_stop(req: Request) -> bool:
        """True when the output's tail equals a stop sequence (or already
        did): truncates the matched suffix and latches ``req.stopped``."""
        if req.stopped:
            return True
        for seq in req.stop or ():
            n = len(seq)
            if len(req.tokens) >= n and req.tokens[-n:] == seq:
                del req.tokens[-n:]
                req.stopped = True
                return True
        return False

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
            self._clear_slot(slot)
