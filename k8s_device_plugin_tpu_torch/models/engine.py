"""Continuous-batching serving engine over the paged KV cache, in PyTorch.

Counterpart of the reference's ``models/engine.py`` with reserve
admission:

- device side: a fixed-[slots] decode dispatch over the paged cache, one
  single-token step or, in pure decode, a block of T steps
  (``decode_block``); every slot advances every step and idle slots write
  masked garbage into scratch page 0.  The attention reads the pool
  through the split-K paged-attention kernel (ops/paged_attention.py).
  On the card each dispatch shape is one CUDA graph, captured at its first
  use and replayed after, so a block of T steps is one replay;
- device-resident step state: tokens, positions and the sampling key are
  fed forward on the device from one dispatch to the next, and rebuilt
  from the host lists only when a slot changes (admission, finish, cancel,
  teardown);
- the overlap round (``overlap_steps=1``, the reference's default): the
  next dispatch is enqueued before the current one is read back, so host
  bookkeeping runs while the card computes; an event that changes a slot
  discards the dispatch in flight and repairs the carried ``seq_lens``;
- host side, between steps: admission, page allocation and free, prefix
  sharing, per-slot bookkeeping.

Prefill bridges through the dense cache: an admitted prompt runs the
bucketed cached-append prefill and its K/V rows are grafted into the
allocated pages; decode then proceeds fully paged.  Sampled tokens draw
from jax's threefry (utils/prng.py) on the reference's key schedule, so
they equal the reference engine's under the same ``rng``.

The batch CLI takes the reference CLI's flags, ``--quant w8|w8a8``,
``--quant-kv``, ``--decode-block`` and ``--overlap-steps`` included, plus
``--dtype``, ``--seed`` (the weights), ``--device`` and ``--cuda-graphs
0|1`` (the card only; 1 by default there).  On the CPU, at tiny widths in
float32, a block-16 overlapped run::

    python -m k8s_device_plugin_tpu_torch.models.engine --device cpu \\
        --dtype float32 --hidden 64 --layers 2 --heads 4 --kv-heads 2 \\
        --vocab 512 --page-size 4 --num-pages 64 --decode-block 16 \\
        --overlap-steps 1

(``--quant w8 --quant-kv`` serves int8 weights and KV pools.)

Module layout (this module is the import surface):

- engine_types.py      — ``Request``, ``EngineMetrics``
- engine_sampling.py   — top-k/top-p filter, table view, decode dispatch
- engine_admission.py  — submit/cancel, batched chunked prefill, admission
- engine_paging.py     — page pool, prefix trie, graft, reclamation
- here                 — ``ServingEngine`` wiring, step loop, overlap round,
                         CUDA graphs, batch CLI ``main``
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import torch

from ..ops import paged_attention as pa
from ..utils import prng
from ..utils.device import fp32_reference_precision, resolve_device
from .engine_admission import AdmissionMixin
from .engine_paging import PagingMixin
from .engine_sampling import decode_tokens
from .engine_types import EngineMetrics, Request, _pow2_int
from .transformer import GPTConfig, PagedCache, PagedConfig, TransformerLM, init_params

# Why an overlapped dispatch was thrown away (the reference's reasons).
DISCARD_REASONS = ("state_dirty", "shape_switch", "slot_teardown")


class ServingEngine(AdmissionMixin, PagingMixin):
    """Batch-continuous decoding server (one host, one model, one card).

    ``cfg`` is the model config WITHOUT paging (the engine adds it);
    ``params`` a state dict in the flax names (``init_params`` or
    ``convert.flax_to_state_dict``).  ``rng``: the sampling key
    (``utils.prng.PRNGKey``; default ``PRNGKey(0)``, as the reference).
    ``decode_block``: a power of two, the most tokens one dispatch advances
    every slot in pure decode.  ``overlap_steps``: 1 keeps one dispatch in
    flight ahead of the readback, 0 runs synchronously.  ``cuda_graphs``:
    replay each dispatch shape as a CUDA graph (default on the card; the
    CPU refuses it).  Runs on ``cuda`` unless ``device="cpu"`` is asked
    for."""

    def __init__(
        self,
        cfg: GPTConfig,
        params: dict,
        paged: PagedConfig,
        *,
        max_slots: int = 4,
        eos_id: Optional[int] = None,
        prefix_sharing: bool = True,
        rng: Optional[torch.Tensor] = None,
        metrics: Optional[EngineMetrics] = None,
        prefill_chunk: Optional[int] = None,
        decode_block: int = 1,
        overlap_steps: int = 1,
        cuda_graphs: Optional[bool] = None,
        device=None,
    ):
        if cfg.paged is not None:
            raise ValueError("pass the base config; the engine adds paging")
        if prefill_chunk is not None and (prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two, got {prefill_chunk}")
        if decode_block < 1 or decode_block & (decode_block - 1):
            # Power of two: the block down-buckets to the largest power of
            # two every slot's remaining budget fits, so O(log
            # decode_block) dispatch shapes (graphs) ever exist.
            raise ValueError(f"decode_block must be a power of two >= 1, got {decode_block}")
        if overlap_steps not in (0, 1):
            raise ValueError(f"overlap_steps must be 0 or 1, got {overlap_steps}")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError("cuda_graphs replays on the card; the CPU runs every dispatch eagerly")
        self.cuda_graphs = on_card if cuda_graphs is None else bool(cuda_graphs)
        self._prefill_chunk = prefill_chunk
        self._decode_block = decode_block
        self._overlap_steps = overlap_steps
        self.paged = paged
        self.cfg = dataclasses.replace(cfg, paged=paged)
        self.max_slots = max_slots
        self.eos_id = eos_id
        self.prefix_sharing = prefix_sharing
        self.metrics = metrics

        self.model = TransformerLM(self.cfg, device=self.device)
        self.model.load_state_dict(params)
        self.cache = PagedCache.zeros(self.cfg, paged, max_slots, self.device)
        # Each slot's full allocated page chain; the step derives the
        # visible table from it (engine_sampling._derived_tables).
        self._chain = torch.zeros(
            (max_slots, paged.max_pages_per_seq), dtype=torch.int32, device=self.device
        )
        self._rng = (prng.PRNGKey(0) if rng is None else rng).to(self.device)

        # Page 0 is the idle-slot scratch target — never allocated.
        self.free_pages: deque[int] = deque(range(1, paged.num_pages))  # guarded by: _lock
        self.slots: list[Optional[Request]] = [None] * max_slots  # guarded by: _lock
        self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._slot_last = [0] * max_slots  # last emitted token
        self._slot_len = [0] * max_slots  # consumed positions
        self._slot_temp = [0.0] * max_slots  # 0 = greedy
        self._slot_topk = [cfg.vocab_size] * max_slots
        self._slot_topp = [1.0] * max_slots
        # Logical index of _slot_pages[s][0] (> 0 once a sliding window
        # reclaimed leading pages).
        self._slot_page_base = [0] * max_slots
        # A slot decodes only after its prefill job grafted it.
        self._slot_ready = [False] * max_slots
        self._slot_emit_t = [0.0] * max_slots  # last token's stamp (ITL)
        self._pending: list[dict] = []  # in-flight prefill jobs
        # Private pages of not-yet-grafted requests (see _match_prefix).
        self._pending_pages: set[int] = set()
        self.queue: deque[Request] = deque()  # guarded by: _lock
        # Set by each _admit pass; read by the decode-block gate.
        self._admit_page_blocked = False
        # submit()/cancel() may run on other threads than the step loop.
        self._lock = threading.RLock()
        self._next_rid = 0
        # Prefix trie: (parent page, token chunk) -> page, plus the reverse
        # maps that let a dying page take its links with it.
        self._page_refs: dict[int, int] = {}
        self._prefix_pages: dict[tuple[int, tuple], int] = {}
        self._page_keys: dict[int, list] = {}
        self._child_keys: dict[int, list] = {}
        self.kernel_on = paged.kernel_enabled(cfg.quant_kv)
        if metrics:
            metrics.kernel_enabled.set(int(self.kernel_on))

        # Device-resident step state.  The dispatch reads these buffers and
        # writes its next inputs back into them (tokens, positions, key), so
        # a graph replays on the same addresses; they are rewritten from the
        # host lists only on a rebuild (_device_state).  ``_dev`` holds the
        # variant flags of the state in the buffers, None when dirty; its
        # identity is the overlap round's validity token.
        self._bufs = {
            "tokens": torch.zeros((max_slots, 1), dtype=torch.long, device=self.device),
            "positions": torch.zeros((max_slots, 1), dtype=torch.long, device=self.device),
            "key": torch.zeros(2, dtype=torch.long, device=self.device),
            "temps": torch.zeros(max_slots, dtype=torch.float32, device=self.device),
            "topks": torch.zeros(max_slots, dtype=torch.long, device=self.device),
            "topps": torch.zeros(max_slots, dtype=torch.float32, device=self.device),
        }
        self._outs: dict[int, torch.Tensor] = {}  # [slots, T] tokens per block size
        self._dev: Optional[dict] = None
        # (T, variant) -> (graph, paged launches by format one replay makes)
        self._graphs: dict[tuple, tuple] = {}
        self._inflight: Optional[dict] = None
        self.overlap_hits = 0
        self.overlap_discards = 0
        self.discards_by_reason = dict.fromkeys(DISCARD_REASONS, 0)
        self.state_rebuilds = 0
        self.graph_replays = 0
        self.device_steps = 0  # single-token steps dispatched, discarded ones included

    # ------------------------------------------------- device-resident state

    def _mark_state_dirty(self) -> None:
        """Invalidate the device-resident step state: the next dispatch
        rebuilds every per-slot buffer from the host lists.  Called on any
        event that changes a slot's scalars (activation, teardown)."""
        self._dev = None

    def _device_state(self) -> dict:
        """The flags of the state the next dispatch consumes.  When dirty,
        rebuild the buffers from host truth with one split of the engine's
        key (the reference's schedule); otherwise the buffers hold what the
        previous dispatch fed forward."""
        dev = self._dev
        if dev is None:
            self.state_rebuilds += 1
            if self.metrics:
                self.metrics.state_rebuilds.inc()
            self._rng, sub = prng.split(self._rng)
            bufs = self._bufs
            bufs["tokens"].copy_(torch.tensor(self._slot_last)[:, None])
            bufs["positions"].copy_(torch.tensor(self._slot_len)[:, None])
            bufs["key"].copy_(sub)
            occupied = [s for s in range(self.max_slots) if self.slots[s] is not None]
            sampled = any(self._slot_temp[s] > 0 for s in occupied)
            filtered = any(
                self._slot_topk[s] < self.cfg.vocab_size or self._slot_topp[s] < 1.0
                for s in occupied
            )
            if sampled:
                bufs["temps"].copy_(torch.tensor(self._slot_temp, dtype=torch.float32))
            if filtered:
                bufs["topks"].copy_(torch.tensor(self._slot_topk))
                bufs["topps"].copy_(torch.tensor(self._slot_topp, dtype=torch.float32))
            variant = "filtered" if filtered else "sampled" if sampled else "greedy"
            dev = self._dev = {"variant": variant}
        return dev

    def _feed_forward(self, dev: dict) -> dict:
        """Install the state a dispatch fed forward (already in the buffers)
        as current: a fresh dict, the in-flight validity token."""
        self._dev = dict(dev)
        return self._dev

    def _dispatch_body(self, T: int, variant: str) -> None:
        """One dispatch from the buffers: T decode steps, their tokens into
        ``_outs[T]``, the next inputs back into the buffers.  What a CUDA
        graph of the dispatch captures."""
        bufs = self._bufs
        temps = None if variant == "greedy" else bufs["temps"]
        topks, topps = (bufs["topks"], bufs["topps"]) if variant == "filtered" else (None, None)
        out, tokens, positions, key = decode_tokens(
            self.model, self.cache, self._chain, bufs["tokens"], bufs["positions"], bufs["key"],
            T, temps, topks, topps,
        )
        self._outs[T].copy_(out)
        bufs["tokens"].copy_(tokens)
        bufs["positions"].copy_(positions)
        if key is not bufs["key"]:  # a greedy dispatch returns its key as is
            bufs["key"].copy_(key)

    def _run_dispatch(self, T: int, variant: str) -> None:
        """Enqueue one dispatch: eagerly, or as the replay of its graph.
        A shape's first dispatch runs eagerly (it is also the warm-up
        capture needs: the kernels' first launches set their attributes)
        and is then captured; the paged kernel's launch counts advance by
        what one replay launches."""
        if T not in self._outs:
            self._outs[T] = torch.empty((self.max_slots, T), dtype=torch.long, device=self.device)
        entry = self._graphs.get((T, variant)) if self.cuda_graphs else None
        if entry is None:
            self._dispatch_body(T, variant)
            if self.cuda_graphs:
                self._graphs[(T, variant)] = self._capture(T, variant)
            return
        graph, launches = entry
        graph.replay()
        self.graph_replays += 1
        counts = pa.paged_attention.launches_by_format
        for fmt, n in launches.items():
            counts[fmt] += n

    def _capture(self, T: int, variant: str) -> tuple:
        """Capture the dispatch body as a CUDA graph.  Capture launches
        nothing, so the launch counts the capture advanced are taken back
        and kept as what each replay adds."""
        before = dict(pa.paged_attention.launches_by_format)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._dispatch_body(T, variant)
        counts = pa.paged_attention.launches_by_format
        launches = {fmt: counts[fmt] - before[fmt] for fmt in before}
        counts.update(before)
        return graph, launches

    # ----------------------------------------------- the overlapped pipeline
    #
    # Per step() call on the decode path (the reference's state machine):
    #
    #   no in-flight    -> dispatch N; if overlap allowed, dispatch N+1 from
    #                      N's fed-forward state; consume N.
    #   valid in-flight -> dispatch N+1 from its fed-forward state FIRST,
    #                      then consume N while N+1 computes.
    #   stale in-flight -> discard it: an admission, finish or cancel
    #                      invalidated the state it was dispatched from.
    #                      Its K/V writes are overwritten before any read
    #                      can see them; only the carried seq_lens (the
    #                      append writes there) go back to host truth.

    def _overlap_allowed(self) -> bool:
        """Whether dispatching one round ahead pays off now: not while a
        prefill streams in or the queue head could admit this step (the
        activation would invalidate the round in flight)."""
        if not self._overlap_steps or self._pending:
            return False
        return (
            not self.queue
            or all(s is not None for s in self.slots)
            or self._admit_page_blocked
        )

    def _dispatch_decode(self, active: list[int], T: int = 1) -> dict:
        """Enqueue one dispatch (a step, or a T-step block) from the current
        state and install its fed-forward state.  Returns what consumption
        needs: the tokens' host copy (and, on the card, the event that says
        it landed), and the (slot, request) pairs pinned now so a consumer
        skips lanes evicted since.  ``dev`` is the validity token."""
        dev = self._device_state()
        self._run_dispatch(T, dev["variant"])
        self.device_steps += T
        out = self._outs[T]
        if out.is_cuda:
            # The copy is ordered after this dispatch and before the next
            # one overwrites the buffer; its event lets the consumer wait
            # for this dispatch alone.
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record()
        else:
            host, landed = out.clone(), None
        return {
            "T": T,
            "out": host,
            "landed": landed,
            "active": list(active),
            "reqs": [self.slots[s] for s in active],
            "dev": self._feed_forward(dev),
        }

    def _take_inflight(self, T: int) -> Optional[dict]:
        """Pop the in-flight record if it is still consumable (its state is
        current and it has the shape this step consumes); else discard."""
        inflight, self._inflight = self._inflight, None
        if inflight is None:
            return None
        if self._dev is None or inflight["dev"] is not self._dev:
            self._discard(inflight, "state_dirty")
            return None
        if inflight["T"] != T:
            self._discard(inflight, "shape_switch")
            return None
        return inflight

    def _repair_seq_lens(self) -> None:
        """Set the carried seq_lens back to host truth (after dispatches
        that ran past it were thrown away or cut short)."""
        self.cache.seq_lens.copy_(torch.tensor(self._slot_len, dtype=torch.int32))

    def _discard(self, inflight: dict, reason: str) -> None:
        """Throw away a dispatch in flight: drop the state it fed forward
        (the next dispatch rebuilds) and repair seq_lens."""
        self._dev = None
        self._repair_seq_lens()
        self.overlap_discards += 1
        self.discards_by_reason[reason] += 1
        if self.metrics:
            self.metrics.overlap_discards.inc()

    def _drop_stale_inflight(self, reason: str) -> None:
        inflight, self._inflight = self._inflight, None
        if inflight is not None:
            self._discard(inflight, reason)

    @staticmethod
    def _unpack(rec: dict) -> list[list[int]]:
        """The record's tokens [slots][T] (the step's one synchronisation)."""
        if rec["landed"] is not None:
            rec["landed"].synchronize()
        return rec["out"].tolist()

    def _record_hit(self) -> None:
        self.overlap_hits += 1
        if self.metrics:
            self.metrics.overlap_hits.inc()

    def _block_room(self, active: list[int]) -> int:
        """Smallest remaining token budget over the active slots."""
        return min(self.slots[s].max_new_tokens - len(self.slots[s].tokens) for s in active)

    # ----------------------------------------------------------------- steps

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit what fits, advance each prefill job one chunk, advance
        every ready slot one token (or a block of them); returns every
        request that finished."""
        if self.metrics:
            with self.metrics.step_seconds.time():
                return self._step_inner()
        return self._step_inner()

    def _step_inner(self) -> list[Request]:
        self._admit()
        finished: list[Request] = []
        # Cancelled live slots tear down before the dispatch.
        for s in range(self.max_slots):
            req = self.slots[s]
            if req is not None and req.cancelled and self._slot_ready[s]:
                self._maybe_finish(s)
                finished.append(req)
        for job in list(self._pending):
            if self._advance_prefill(job):
                self._pending.remove(job)
                finished.extend(self._activate(job))
        active = [s for s in range(self.max_slots) if self.slots[s] is not None and self._slot_ready[s]]
        if not active:
            self._update_gauges()
            return finished
        T = 1
        if (
            self._decode_block > 1
            and not self._pending  # no prompt mid-stream: keep chunking
            # Queued work argues for single steps only while the head could
            # admit: a saturated engine or a page-blocked head cannot until
            # something finishes, and a mid-block finish truncates that
            # slot's tail so the next step admits.
            and (
                not self.queue
                or all(s is not None for s in self.slots)
                or self._admit_page_blocked
            )
        ):
            # The largest power-of-two block no slot's remaining budget
            # truncates.
            room = self._block_room(active)
            T = min(self._decode_block, 1 << max(0, room.bit_length() - 1))
        return self._decode_round(active, finished, T)

    def _decode_round(self, active: list[int], finished: list[Request], T: int) -> list[Request]:
        """Advance every active slot T tokens (a step, or a block) in one
        dispatch and consume them.  A round in flight from the previous
        call is consumed if still valid; under overlap the next round goes
        out before this one's readback (a block only when every slot has
        room for both)."""
        overlap = self._overlap_allowed() and (T == 1 or self._block_room(active) >= 2 * T)
        rec = self._take_inflight(T)
        if rec is None:
            rec = self._dispatch_decode(active, T)
        else:
            self._record_hit()
        if overlap:
            self._inflight = self._dispatch_decode(active, T)
        return self._consume(rec, finished)

    def _consume(self, rec: dict, finished: list[Request]) -> list[Request]:
        """Host half of one round: read back, then per slot up to T tokens,
        truncated at EOS, max_new or a stop sequence (a slot that finishes
        mid-block wastes its tail: its writes land past its final length
        and are never read).  Under overlap this runs while the next round
        computes."""
        T = rec["T"]
        toks = self._unpack(rec)
        now = time.monotonic()
        emitted = 0
        for s, req in zip(rec["active"], rec["reqs"]):
            if self.slots[s] is not req or not self._slot_ready[s]:
                continue  # evicted between dispatch and readback
            consumed = 0
            for j in range(T):
                tok = toks[s][j]
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
            emitted += consumed
            self._observe_itl(s, consumed, now)
            self._maybe_finish(s)
            if req.done:
                finished.append(req)
            elif self.cfg.attention_window is not None:
                self._reclaim_windowed(s)
        # Every row's carried length is L+T (L+2T with a round in flight):
        # host truth when every slot consumed T.  A finish tore its slot
        # down (state dirty): then the in-flight discard repairs the
        # lengths, or the direct write does when nothing is in flight.
        if self._dev is None:
            if self._inflight is not None:
                self._drop_stale_inflight("slot_teardown")
            else:
                self._repair_seq_lens()
        self._count_tokens(emitted)
        return finished

    def _count_tokens(self, n: int) -> None:
        if self.metrics:
            self.metrics.steps.inc()
            self.metrics.tokens.inc(n)
        self._update_gauges()

    def _observe_itl(self, slot: int, consumed: int, now: float) -> None:
        """ITL for ``consumed`` tokens that landed at ``now`` on a slot: a
        multi-token dispatch observes the amortized gap once per token."""
        last = self._slot_emit_t[slot]
        self._slot_emit_t[slot] = now
        if consumed <= 0 or last <= 0.0 or not self.metrics:
            return
        per = (now - last) / consumed
        for _ in range(consumed):
            self.metrics.itl_seconds.observe(per)

    def _update_gauges(self) -> None:
        if not self.metrics:
            return
        with self._lock:
            m = self.metrics
            m.active_slots.set(sum(1 for s in self.slots if s is not None))
            m.queued.set(len(self.queue))
            m.free_pages.set(len(self.free_pages))
            m.shared_pages.set(sum(1 for c in self._page_refs.values() if c > 1))
            allocatable = self.paged.num_pages - 1  # page 0 is scratch
            m.page_utilization.set(1.0 - len(self.free_pages) / allocatable if allocatable else 0.0)

    def run(self, requests: list[tuple[list[int], int]], **submit_kw) -> list[Request]:
        """Submit all (``submit_kw`` applies to every request), step until
        drained, return in submission order."""
        subs = [self.submit(p, n, **submit_kw) for p, n in requests]
        guard = 0
        while not all(r.done for r in subs):
            self.step()
            guard += 1
            if guard > 100_000:
                raise RuntimeError("engine failed to drain")
        return subs


def synthetic_jobs(requests: int, prompt_len: int, max_new: int, vocab: int) -> list:
    """The batch CLI's job stream: half the prompts share a prefix."""
    common = list(range(1, prompt_len // 2 + 1))
    jobs = []
    for i in range(requests):
        tail = [(37 * i + j) % vocab for j in range(prompt_len // 2)]
        prompt = (common + tail) if i % 2 == 0 else [(11 * i + j) % vocab for j in range(prompt_len)]
        jobs.append((prompt, max_new))
    return jobs


def parse_args(argv: Optional[list[str]] = None):
    """The batch CLI's flags (the reference CLI's names for what this
    slice serves, plus ``--dtype``, ``--seed``, ``--device`` and
    ``--cuda-graphs``)."""
    import argparse

    def positive(text):
        value = int(text)
        if value < 1:
            raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
        return value

    p = argparse.ArgumentParser(prog="serving-engine-torch")
    p.add_argument("--hidden", type=positive, default=512)
    p.add_argument("--layers", type=positive, default=4)
    p.add_argument("--heads", type=positive, default=8)
    p.add_argument("--kv-heads", type=positive, default=4)
    p.add_argument("--vocab", type=positive, default=32000)
    p.add_argument("--quant", choices=["w8", "w8a8"], default=None,
                   help="int8 weights at every dense site (w8a8: int8 activations too)")
    p.add_argument("--quant-kv", action="store_true",
                   help="int8 KV pools with float32 scales (the paged kernel's int8 format)")
    p.add_argument("--page-size", type=positive, default=16)
    p.add_argument("--num-pages", type=positive, default=128)
    p.add_argument("--max-pages-per-seq", type=positive, default=16)
    p.add_argument("--slots", type=positive, default=4)
    p.add_argument("--requests", type=positive, default=8)
    p.add_argument("--prompt-len", type=positive, default=32)
    p.add_argument("--max-new", type=positive, default=32)
    p.add_argument(
        "--use-kernel", action=argparse.BooleanOptionalAction, default=None,
        help="decode through the split-K paged-attention kernel (default: "
        "yes) or, with --no-use-kernel, through the gathered page view",
    )
    p.add_argument("--kernel-splits", type=positive, default=None,
                   help="pin the kernel's split-K degree (default: ops/tuning.py)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sample every request at this temperature (0 = greedy)")
    p.add_argument("--top-k", type=positive, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--prefill-chunk", type=_pow2_int, default=None,
                   help="stream prompts into the prefill in chunks of this many tokens")
    p.add_argument("--decode-block", type=_pow2_int, default=1,
                   help="in pure decode, advance every slot up to this many tokens per "
                   "dispatch (power of two)")
    p.add_argument("--overlap-steps", type=int, choices=[0, 1], default=1,
                   help="decode dispatches kept in flight ahead of the readback (0: "
                   "synchronous)")
    p.add_argument("--cuda-graphs", type=int, choices=[0, 1], default=None,
                   help="replay each decode dispatch as a CUDA graph (the card only; "
                   "default 1 there)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.cuda_graphs is not None and args.device is not None and \
            torch.device(args.device).type == "cpu":
        p.error("--cuda-graphs is meaningless on the CPU, which runs every dispatch eagerly")
    return args


def build_engine(args) -> "ServingEngine":
    """The engine the batch CLI's flags describe, with random weights from
    ``--seed`` (quantized by ``init_params`` under ``--quant``, as the
    reference CLI quantizes its init) and a fresh metrics registry."""
    device = resolve_device(args.device)
    fp32_reference_precision()
    cfg = GPTConfig(
        vocab_size=args.vocab,
        hidden_size=args.hidden,
        num_layers=args.layers,
        num_heads=args.heads,
        intermediate_size=args.hidden * 3,
        max_seq=args.page_size * args.max_pages_per_seq,
        num_kv_heads=args.kv_heads,
        dtype=getattr(torch, args.dtype),
        quant=args.quant,
        quant_kv=args.quant_kv,
    )
    paged = PagedConfig(
        args.page_size, args.num_pages, args.max_pages_per_seq,
        use_kernel=args.use_kernel, kernel_num_splits=args.kernel_splits,
    )
    from ..utils.metrics import MetricsRegistry

    return ServingEngine(
        cfg, init_params(cfg, args.seed), paged, max_slots=args.slots,
        metrics=EngineMetrics(MetricsRegistry()), prefill_chunk=args.prefill_chunk,
        decode_block=args.decode_block, overlap_steps=args.overlap_steps,
        cuda_graphs=None if args.cuda_graphs is None else bool(args.cuda_graphs),
        device=device,
    )


def benchmark(args) -> tuple[dict, list[Request]]:
    """The reference CLI's synthetic request stream through the engine,
    after a warmup that runs every distinct prompt length once, for
    2 x ``--decode-block`` new tokens, so every block size (each a graph on
    the card) has run once.  Returns the summary (the reference's JSON keys
    plus ``decode_block``, ``cuda_graphs``, ``state_rebuilds``,
    ``graph_replays``, ``device_steps`` and ``device``; the counts cover
    the warmup too) and the timed run's finished requests."""
    eng = build_engine(args)
    device = eng.device
    sample_kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    jobs = synthetic_jobs(args.requests, args.prompt_len, args.max_new, args.vocab)
    warm = {len(prompt): prompt for prompt, _ in jobs}
    eng.run([(prompt, 2 * args.decode_block) for prompt in warm.values()], **sample_kw)
    # Latency quantiles of the timed region only (warmup subtracted).
    ttft_h, itl_h = eng.metrics.ttft_seconds, eng.metrics.itl_seconds
    ttft_snap, itl_snap = ttft_h.snapshot(), itl_h.snapshot()

    def _ms(value):
        return None if value is None else round(value * 1e3, 3)

    t0 = time.perf_counter()
    done = eng.run(jobs, **sample_kw)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in done)
    summary = {
        "metric": "engine_decode_tokens_per_sec",
        "value": round(tokens / dt, 2),
        "unit": "tokens/sec",
        "requests": len(done),
        "slots": args.slots,
        "tp": 1,
        "quant": args.quant,
        "kernel": eng.kernel_on,
        "sampler": "greedy"
        if args.temperature <= 0
        else f"temperature={args.temperature},top_k={args.top_k},top_p={args.top_p}",
        "spec_gamma": 0,
        "spec_acceptance": None,
        "tokens": tokens,
        "wall_s": round(dt, 2),
        "overlap_steps": args.overlap_steps,
        "overlap_hits": eng.overlap_hits,
        "overlap_discards": eng.overlap_discards,
        "decode_block": args.decode_block,
        "cuda_graphs": eng.cuda_graphs,
        "state_rebuilds": eng.state_rebuilds,
        "graph_replays": eng.graph_replays,
        "device_steps": eng.device_steps,
        "kv_retain": False,
        "kv_retained_hits": 0,
        "kv_host_hits": 0,
        "ttft_p50_ms": _ms(ttft_h.quantile(0.5, since=ttft_snap)),
        "ttft_p99_ms": _ms(ttft_h.quantile(0.99, since=ttft_snap)),
        "itl_p50_ms": _ms(itl_h.quantile(0.5, since=itl_snap)),
        "itl_p99_ms": _ms(itl_h.quantile(0.99, since=itl_snap)),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return summary, done


def main(argv: Optional[list[str]] = None) -> None:
    """Batch serving benchmark CLI: prints the summary as one JSON line."""
    import json

    summary, _ = benchmark(parse_args(argv))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
