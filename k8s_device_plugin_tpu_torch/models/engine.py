"""Continuous-batching serving engine over the paged KV cache, in PyTorch.

Counterpart of the reference's ``models/engine.py`` (its synchronous loop,
``overlap_steps=0``, with decode block 1 and reserve admission):

- device side: a fixed-[slots] single-token decode step over the paged
  cache; every slot advances every step and idle slots write masked
  garbage into scratch page 0.  The attention reads the pool through the
  split-K paged-attention kernel (ops/paged_attention.py);
- host side, between steps: admission, page allocation and free, prefix
  sharing, per-slot bookkeeping.

Prefill bridges through the dense cache: an admitted prompt runs the
bucketed cached-append prefill and its K/V rows are grafted into the
allocated pages; decode then proceeds fully paged.

The batch CLI takes the reference CLI's flags, ``--quant w8|w8a8`` and
``--quant-kv`` included, plus ``--dtype``, ``--seed`` and ``--device``; on
the CPU, at tiny widths in float32::

    python -m k8s_device_plugin_tpu_torch.models.engine --device cpu \\
        --dtype float32 --hidden 64 --layers 2 --heads 4 --kv-heads 2 \\
        --vocab 512 --page-size 4 --num-pages 64 --quant w8 --quant-kv

Module layout (this module is the import surface):

- engine_types.py      — ``Request``, ``EngineMetrics``
- engine_sampling.py   — top-k/top-p filter, table view, decode step
- engine_admission.py  — submit/cancel, batched chunked prefill, admission
- engine_paging.py     — page pool, prefix trie, graft, reclamation
- here                 — ``ServingEngine`` wiring, step loop, batch CLI ``main``
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import torch

from ..utils.device import fp32_reference_precision, resolve_device
from .engine_admission import AdmissionMixin
from .engine_paging import PagingMixin
from .engine_sampling import decode_step
from .engine_types import EngineMetrics, Request, _pow2_int
from .transformer import GPTConfig, PagedCache, PagedConfig, TransformerLM, init_params


class ServingEngine(AdmissionMixin, PagingMixin):
    """Batch-continuous decoding server (one host, one model, one card).

    ``cfg`` is the model config WITHOUT paging (the engine adds it);
    ``params`` a state dict in the flax names (``init_params`` or
    ``convert.flax_to_state_dict``).  ``seed`` seeds the sampling
    generator.  Runs on ``cuda`` unless ``device="cpu"`` is asked for."""

    def __init__(
        self,
        cfg: GPTConfig,
        params: dict,
        paged: PagedConfig,
        *,
        max_slots: int = 4,
        eos_id: Optional[int] = None,
        prefix_sharing: bool = True,
        seed: int = 0,
        metrics: Optional[EngineMetrics] = None,
        prefill_chunk: Optional[int] = None,
        device=None,
    ):
        if cfg.paged is not None:
            raise ValueError("pass the base config; the engine adds paging")
        if prefill_chunk is not None and (prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two, got {prefill_chunk}")
        self.device = resolve_device(device)
        self._prefill_chunk = prefill_chunk
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
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

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

    # ----------------------------------------------------------------- steps

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit what fits, advance each prefill job one chunk, advance
        every ready slot one token; returns every request that finished."""
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
        toks = self._decode(active)
        now = time.monotonic()
        for s in active:
            req = self.slots[s]
            req.tokens.append(toks[s])
            self._slot_last[s] = toks[s]
            self._slot_len[s] += 1
            self._observe_itl(s, now)
            self._maybe_finish(s)
            if req.done:
                finished.append(req)
            elif self.cfg.attention_window is not None:
                self._reclaim_windowed(s)
        if self.metrics:
            self.metrics.steps.inc()
            self.metrics.tokens.inc(len(active))
        self._update_gauges()
        return finished

    def _decode(self, active: list[int]) -> list[int]:
        """One decode step over every slot; returns the next token of each
        slot (the host readback is the step's one synchronisation)."""
        host = torch.tensor([self._slot_last, self._slot_len], dtype=torch.long)
        state = host.to(self.device)
        temps = topks = topps = None
        if any(self._slot_temp[s] > 0 for s in active):
            temps = torch.tensor(self._slot_temp, dtype=torch.float32, device=self.device)
            if any(self._slot_topk[s] < self.cfg.vocab_size or self._slot_topp[s] < 1.0 for s in active):
                topks = torch.tensor(self._slot_topk, device=self.device)
                topps = torch.tensor(self._slot_topp, dtype=torch.float32, device=self.device)
        nxt = decode_step(
            self.model, self.cache, self._chain, state[0][:, None], state[1][:, None],
            temps, self._gen, topks, topps,
        )
        return nxt.tolist()

    def _observe_itl(self, slot: int, now: float) -> None:
        last = self._slot_emit_t[slot]
        self._slot_emit_t[slot] = now
        if last <= 0.0:
            return
        if self.metrics:
            self.metrics.itl_seconds.observe(now - last)

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
    slice serves, plus ``--dtype``, ``--seed`` and ``--device``)."""
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
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--seed", type=int, default=0, help="weights and sampling seed")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


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
        seed=args.seed, device=device,
    )


def benchmark(args) -> tuple[dict, list[Request]]:
    """The reference CLI's synthetic request stream through the engine,
    after a warmup that runs every distinct prompt length once.  Returns
    the summary (the reference's JSON keys plus ``device``) and the timed
    run's finished requests."""
    eng = build_engine(args)
    device = eng.device
    sample_kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    jobs = synthetic_jobs(args.requests, args.prompt_len, args.max_new, args.vocab)
    warm = {len(prompt): prompt for prompt, _ in jobs}
    eng.run([(prompt, 2) for prompt in warm.values()], **sample_kw)
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
        "overlap_steps": 0,
        "overlap_hits": 0,
        "overlap_discards": 0,
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
