"""Continuous-batching serving engine over the paged KV cache, in PyTorch.

Counterpart of the reference's ``models/engine.py`` (reserve and
optimistic admission, overload control, the SLO plane, spans, the flight
recorder, the anomaly monitor, the step profiler, the KV tiers, warm
snapshots, the prefill/decode roles, speculative rounds, multi-LoRA
serving and tensor parallelism):

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
- speculative rounds (``spec_gamma``, engine_spec.py): gamma ``w8``
  self-draft steps and one (gamma+1)-token verify over the shared pool,
  synchronous, one CUDA graph per sampler variant on the card;
- multi-LoRA serving (``cfg.lora_serve``): each slot's adapter id lives in
  a device buffer every dispatch reads, written in place when slots change;
- tensor parallelism (``mesh``, engine_tp.py): one process per card, the
  leader deciding and broadcasting each device write to the followers,
  every rank running it on its shard of the model and pools;
- host side, between steps: the overload sweep, admission, page
  allocation and free (on demand under optimistic admission, preempting
  the newest slot when the pool runs dry), prefix sharing, the KV tiers
  (retained pages, the host arena, restore-resume), per-slot bookkeeping,
  SLO verdicts.

Prefill bridges through the dense cache: an admitted prompt runs the
bucketed cached-append prefill and its K/V rows are grafted into the
allocated pages; decode then proceeds fully paged.  Sampled tokens draw
from jax's threefry (utils/prng.py) on the reference's key schedule, so
they equal the reference engine's under the same ``rng``.

The batch CLI takes the reference CLI's flags, ``--quant w8|w8a8``,
``--quant-kv``, ``--decode-block``, ``--overlap-steps``, ``--spec-gamma``,
``--overload``, ``--slo`` (both on by default, as there) and ``--tp``
included, plus
``--dtype``, ``--seed`` (the weights), ``--device`` and ``--cuda-graphs
0|1`` (the card only; 1 by default there).  ``--tp N`` starts N - 1
follower processes (NCCL, one a card; gloo ranks on the CPU) and prints
one record from the leader.  On the CPU, at tiny widths in float32, a
block-16 overlapped run::

    python -m k8s_device_plugin_tpu_torch.models.engine --device cpu \\
        --dtype float32 --hidden 64 --layers 2 --heads 4 --kv-heads 2 \\
        --vocab 512 --page-size 4 --num-pages 64 --decode-block 16 \\
        --overlap-steps 1

(``--quant w8 --quant-kv`` serves int8 weights and KV pools; ``--kv-retain
1 --kv-host-cache-mb 8`` turns the KV tiers on; ``--tp 2`` runs it over two
gloo ranks.)

Module layout (this module is the import surface):

- engine_types.py      — ``Request``, ``EngineMetrics``
- engine_sampling.py   — top-k/top-p filter, logprobs, table view, decode
                         dispatch
- engine_admission.py  — submit/cancel, overload gate and sweep, batched
                         chunked prefill, admission, SLO accounting
- engine_paging.py     — page pool, prefix trie, graft, frontier growth and
                         preemption, reclamation
- engine_kvcache.py    — retained pages, the host arena, restore-resume
- engine_handoff.py    — prefill/decode roles, the KV handoff, the fabric,
                         the owner-thread call queue
- engine_spec.py       — the speculative round and its host consumption
- engine_tp.py         — the mesh: leader/follower device operations, the
                         KV rows' gather and scatter, the launcher
- engine_overload.py, engine_watchdog.py, engine_profiler.py,
  engine_snapshot.py   — the reference's, copied or ported
- here                 — ``ServingEngine`` wiring, step loop, overlap round,
                         CUDA graphs, batch CLI ``main``
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..ops import paged_attention as pa
from ..ops import tuning
from ..utils import failpoints, prng
from ..utils.anomaly import AnomalyMonitor
from ..utils.device import fp32_reference_precision, resolve_device
from ..utils.flight import FlightRecorder
from ..utils.slo import SLOTracker, UsageMeter, default_objectives
from ..utils.spans import ENGINE_TRACE, SpanRecorder
from .engine_admission import AdmissionMixin
from .engine_handoff import HandoffMixin
from .engine_kvcache import KVCacheMixin
from .engine_overload import OverloadConfig, OverloadController
from .engine_paging import PagingMixin
from .engine_profiler import EngineProfiler
from .engine_sampling import decode_tokens
from .engine_snapshot import params_fingerprint
from .engine_spec import SpeculativeMixin
from .engine_tp import TensorParallelMixin
from .engine_types import EngineMetrics, Request, _pow2_int
from .transformer import GPTConfig, PagedCache, PagedConfig, TransformerLM, init_params

# Why an overlapped dispatch was thrown away (the reference's reasons).
DISCARD_REASONS = ("state_dirty", "shape_switch", "slot_teardown")


class ServingEngine(AdmissionMixin, PagingMixin, KVCacheMixin, HandoffMixin, SpeculativeMixin,
                    TensorParallelMixin):
    """Batch-continuous decoding server (one host, one model, one card or a
    tensor-parallel group of them).

    ``cfg`` is the model config WITHOUT paging (the engine adds it);
    ``params`` a state dict in the flax names (``init_params`` or
    ``convert.flax_to_state_dict``), float32 or quantized.  ``rng``: the
    sampling key (``utils.prng.PRNGKey``; default ``PRNGKey(0)``, as the
    reference).  ``decode_block``: a power of two, the most tokens one
    dispatch advances every slot in pure decode.  ``overlap_steps``: 1
    keeps one dispatch in flight ahead of the readback, 0 runs
    synchronously.  ``admission``: ``reserve`` allocates a request's whole
    chain at admission, ``optimistic`` its prompt pages and grows on
    demand, preempting the newest slot when the pool runs dry.
    ``overload``/``slo``: True (defaults), an ``OverloadConfig`` / a dict
    of SLO thresholds or an ``SLOTracker``, or None (off).  ``kv_retain``
    keeps refcount-zero prefix pages for a later match and
    ``kv_host_cache_mb`` > 0 adds the host arena they and preemption
    snapshots spill into (engine_kvcache.py; off by default, as the
    reference's library default).  ``role``: ``unified``, ``prefill`` or
    ``decode`` (engine_handoff.py; the split roles need both tiers).
    ``racecheck``: guard the queue, free pages, page refcounts and the
    in-flight round (utils/racecheck.py).  ``spec_gamma`` > 0: speculative
    rounds of gamma proposals from ``draft_params`` under ``draft_cfg``
    (default: the target's config with ``quant="w8"``; only the weight
    format may differ), synchronous and one token a slot at least per
    round; greedy slots emit exactly the non-speculative stream.  ``spans``,
    ``flight``, ``anomaly``, ``profiler``: shared instances, or None for
    the engine's own (spans stay off).  ``cuda_graphs``: replay each
    dispatch shape as a CUDA graph (default on the card; the CPU refuses
    it).  Runs on ``cuda`` unless ``device="cpu"`` is asked for.
    ``mesh``: a one-axis ``DeviceMesh`` named ``tp_axis`` over the group's
    ranks (``parallel/mesh.mesh_from_allocation``; engine_tp.launch forms
    it), every rank building the engine with the full ``params`` (and
    ``draft_params``): the leader (rank 0) steps it, the followers call
    ``follow()``.  kv heads must divide by the degree, and CUDA graphs over
    gloo are refused.  A mesh of one runs the same collectives; None is no
    tensor parallelism.

    ``MAX_BIAS``: per-request logit bias entries pad to this width, so
    biased requests come and go without new dispatch shapes."""

    MAX_BIAS = 16

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
        spec_gamma: int = 0,
        draft_params: Optional[dict] = None,
        draft_cfg: Optional[GPTConfig] = None,
        prefill_chunk: Optional[int] = None,
        decode_block: int = 1,
        overlap_steps: int = 1,
        admission: str = "reserve",
        overload=None,
        slo=None,
        kv_retain: bool = False,
        kv_host_cache_mb: float = 0,
        role: str = "unified",
        racecheck: bool = False,
        spans: Optional[SpanRecorder] = None,
        flight: Optional[FlightRecorder] = None,
        anomaly: Optional[AnomalyMonitor] = None,
        profiler: Optional[EngineProfiler] = None,
        cuda_graphs: Optional[bool] = None,
        device=None,
        mesh=None,
        tp_axis: str = "tp",
    ):
        if cfg.paged is not None:
            raise ValueError("pass the base config; the engine adds paging")
        if spec_gamma < 0:
            raise ValueError(f"spec_gamma must be >= 0, got {spec_gamma}")
        if prefill_chunk is not None and (prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(f"prefill_chunk must be a power of two, got {prefill_chunk}")
        if decode_block < 1 or decode_block & (decode_block - 1):
            # Power of two: the block down-buckets to the largest power of
            # two every slot's remaining budget fits, so O(log
            # decode_block) dispatch shapes (graphs) ever exist.
            raise ValueError(f"decode_block must be a power of two >= 1, got {decode_block}")
        if decode_block > 1 and spec_gamma > 0:
            # Both advance several tokens a dispatch, on schedules that do
            # not compose (a scan of exact steps vs draft and verify).
            raise ValueError("decode_block > 1 is not supported with spec_gamma")
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or 'optimistic', got {admission!r}")
        if overlap_steps not in (0, 1):
            raise ValueError(f"overlap_steps must be 0 or 1, got {overlap_steps}")
        if cfg.lora_serve and spec_gamma > 0:
            # The self-draft is the model quantized, and quant excludes LoRA:
            # a multi-adapter batch has no coherent draft.
            raise ValueError("lora_serve is not supported with spec_gamma")
        if spec_gamma > 0:
            # Shared-pool speculation: the draft writes approximate K/V that
            # the verify overwrites before any read, so both must address
            # the pool alike; only the weight format may differ (quant_kv
            # is the pool's storage format).
            if draft_params is None:
                raise ValueError("spec_gamma > 0 requires draft_params")
            if draft_cfg is None:
                draft_cfg = dataclasses.replace(cfg, quant="w8")
            if dataclasses.replace(draft_cfg, quant=None) != dataclasses.replace(cfg, quant=None):
                raise ValueError(
                    "engine speculation is shared-pool self-speculation: draft_cfg must match "
                    "the target architecture and cache format (only quant may differ)"
                )
        self.device = resolve_device(device)
        cuda_graphs = self._init_tp(mesh, tp_axis, cfg, cuda_graphs=cuda_graphs)
        on_card = self.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError("cuda_graphs replays on the card; the CPU runs every dispatch eagerly")
        self.cuda_graphs = on_card if cuda_graphs is None else bool(cuda_graphs)
        self._prefill_chunk = prefill_chunk
        self._decode_block = decode_block
        # A round's host consumption decides the next round's inputs: a
        # speculative engine has nothing to dispatch ahead.
        self._overlap_steps = 0 if spec_gamma else overlap_steps
        self._optimistic = admission == "optimistic"
        self.paged = paged
        self.cfg = dataclasses.replace(cfg, paged=paged)
        self.max_slots = max_slots
        self.eos_id = eos_id
        self.prefix_sharing = prefix_sharing
        self.metrics = metrics
        # The canary prober's oracle key, from the tree as it was given.
        self.params_fingerprint = params_fingerprint(params)

        self.model = TransformerLM(self.cfg, device=self.device, tp=self._tp)
        self.model.load_state_dict(self._tp_params(params))
        self._spec_gamma = spec_gamma
        self.draft_model = None
        if spec_gamma:
            self.draft_model = TransformerLM(dataclasses.replace(draft_cfg, paged=paged),
                                             device=self.device, tp=self._tp)
            self.draft_model.load_state_dict(self._tp_params(draft_params))
        # Speculation counters (acceptance = accepted / proposed) and the
        # rounds dispatched.
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rounds = 0
        self.cache = PagedCache.zeros(self.cfg, paged, max_slots, self.device, tp=self._tp)
        # The reference's per-layer cache names: KV rows, snapshots and the
        # handoff wire are keyed by them.
        self._layer_names = [f"layer_{i}" for i in range(self.cfg.num_layers)]
        # Each slot's full allocated page chain; the step derives the
        # visible table from it (engine_sampling._derived_tables).
        self._chain = torch.zeros(
            (max_slots, paged.max_pages_per_seq), dtype=torch.int32, device=self.device
        )
        # On a mesh the key stays on the host: the rebuild carries its split
        # to the followers as ints, with no read of the card's stream.
        self._rng = (prng.PRNGKey(0) if rng is None else rng).to(
            self.device if self._tp is None else "cpu")

        # Page 0 is the idle-slot scratch target — never allocated.
        self.free_pages: deque[int] = deque(range(1, paged.num_pages))  # guarded by: _lock
        self.slots: list[Optional[Request]] = [None] * max_slots  # guarded by: _lock
        self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._slot_last = [0] * max_slots  # last emitted token
        self._slot_len = [0] * max_slots  # consumed positions
        self._slot_temp = [0.0] * max_slots  # 0 = greedy
        self._slot_topk = [cfg.vocab_size] * max_slots
        self._slot_topp = [1.0] * max_slots
        # Each slot's adapter id (-1 = the base model) under lora_serve.
        self._slot_aid = [-1] * max_slots
        # Sparse logit bias per slot, padded with (0, 0.0), a no-op.
        self._slot_bias_ids = [[0] * self.MAX_BIAS for _ in range(max_slots)]
        self._slot_bias_vals = [[0.0] * self.MAX_BIAS for _ in range(max_slots)]
        # Logical index of _slot_pages[s][0] (> 0 once a sliding window
        # reclaimed leading pages).
        self._slot_page_base = [0] * max_slots
        # Admission order: optimistic growth serves the oldest first and
        # preempts the newest.
        self._slot_seq = [0] * max_slots
        self._seq_counter = 0
        self.preemptions = 0
        # A slot decodes only after its prefill job grafted it.
        self._slot_ready = [False] * max_slots
        self._slot_emit_t = [0.0] * max_slots  # last token's stamp (ITL)
        self._pending: list[dict] = []  # in-flight prefill jobs
        # Each prefill job's device objects by id (a follower's too).
        self._jobs: dict[int, dict] = {}
        self._job_counter = 0
        # Private pages of not-yet-grafted requests (see _match_prefix).
        self._pending_pages: set[int] = set()
        self.queue: deque[Request] = deque()  # guarded by: _lock
        # Set by each _admit pass; read by the decode-block gate: the head
        # waits on the page pool.
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
        self._trie_version = 0  # guarded by: _lock
        self.kernel_on = paged.kernel_enabled(cfg.quant_kv)
        if metrics:
            metrics.kernel_enabled.set(int(self.kernel_on))
            metrics.tp_size.set(self.tp_size)

        # Forensics, always on as in the reference: the flight recorder,
        # the anomaly monitor that files incidents with its window, and
        # the per-step phase profiler.
        self.flight = flight if flight is not None else FlightRecorder(capacity=1024, name="engine")
        if anomaly is None:
            anomaly = AnomalyMonitor(
                flight=self.flight,
                on_incident=(lambda m: metrics.incidents.inc(metric=m)) if metrics else None,
            )
        self.anomaly = anomaly
        self.anomaly.configure("engine.step_seconds", warmup=50, z_threshold=6.0, sustain=3)
        self.anomaly.configure("engine.ttft_seconds", warmup=20, z_threshold=6.0, sustain=2)
        if self.kernel_on and spec_gamma > 0:
            # A kernel-on spec engine runs its multi-token verify pass on the
            # gathered pages (the draft's single-token steps keep the
            # kernel), as the reference does: surfaced as it surfaces it.
            if metrics:
                metrics.kernel_fallbacks.inc(reason="spec_verify")
            self.flight.record("kernel.fallback", reason="spec_verify",
                               generation=tuning.device_generation(self.device),
                               splits=paged.kernel_num_splits)
        # The step hook holds the monitor, not the engine: no reference
        # cycle, so a dropped engine (and its CUDA graphs) is freed at once
        # rather than by a later garbage collection.
        self.profiler = profiler if profiler is not None else EngineProfiler(
            flight=self.flight,
            observe_step=functools.partial(self.anomaly.observe, "engine.step_seconds"),
            device=self.device,
        )
        self._prof_timer = None
        self._step_tokens = 0  # tokens emitted by the step in flight
        # The hung-step watchdog, installed by the HTTP server; the engine
        # feeds it step stamps and grace marks (builds, captures, prefill).
        self.watchdog = None
        self.overload = None
        if overload:
            self.overload = OverloadController(
                max_slots, overload if isinstance(overload, OverloadConfig) else None,
                metrics=metrics, flight=self.flight,
            )
        self.slo = None
        self.usage = None
        if slo:
            if isinstance(slo, SLOTracker):
                self.slo = slo
            elif isinstance(slo, dict):
                self.slo = SLOTracker(objectives=default_objectives(**slo))
            else:
                self.slo = SLOTracker()
            self.usage = UsageMeter()
        self.spans = spans
        self._init_kvcache(kv_retain, kv_host_cache_mb)
        self._init_handoff(role)

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
            "bias_ids": torch.zeros((max_slots, self.MAX_BIAS), dtype=torch.long,
                                    device=self.device),
            "bias_vals": torch.zeros((max_slots, self.MAX_BIAS), dtype=torch.float32,
                                     device=self.device),
            "aids": torch.full((max_slots,), -1, dtype=torch.long, device=self.device),
        }
        # A speculative round's outputs: each slot's gamma+1 tokens and a.
        self._spec_out = torch.zeros((max_slots, spec_gamma + 1), dtype=torch.long,
                                     device=self.device)
        self._spec_a = torch.zeros((max_slots,), dtype=torch.long, device=self.device)
        self._outs: dict[int, torch.Tensor] = {}  # [slots, T] tokens per block size
        self._lps: dict[int, torch.Tensor] = {}  # [slots, T] logprobs per block size
        self._dev: Optional[dict] = None
        # (T, variant, biased, want_lp) -> (graph, paged launches by format
        # one replay makes): at most 12 x (log2(decode_block) + 1) graphs.
        self._graphs: dict[tuple, tuple] = {}
        self.captured_collectives: dict[str, dict] = {}  # graph key -> kind -> count
        self._inflight: Optional[dict] = None
        self.overlap_hits = 0
        self.overlap_discards = 0
        self.discards_by_reason = dict.fromkeys(DISCARD_REASONS, 0)
        self.state_rebuilds = 0
        self.graph_replays = 0
        self.device_steps = 0  # single-token steps dispatched, discarded ones included
        # Prompt positions the prefill computed (chunk x requests per
        # chunk): what a restore or a handoff saves shows here.
        self.prefill_positions = 0
        self._inflight_guard = None
        if racecheck:
            # Lock discipline checked at every mutation of the cross-thread
            # state; the in-flight round is the owner thread's alone.
            from ..utils.racecheck import GuardedDeque, GuardedDict, OwnerGuard

            self._inflight_guard = OwnerGuard(lock=self._lock, name="_inflight")
            self.free_pages = GuardedDeque(self.free_pages, lock=self._lock, name="free_pages")
            self.queue = GuardedDeque(self.queue, lock=self._lock, name="queue")
            self._page_refs = GuardedDict(self._page_refs, lock=self._lock, name="_page_refs")

    def _wd_grace(self, reason: str) -> None:
        """Mark the step in flight as legitimately slow for the hung-step
        watchdog (a kernel build, a first launch, a graph capture, a
        prefill).  No-op without a watchdog."""
        if self.watchdog is not None:
            self.watchdog.note_grace(reason)

    def _mark(self, phase: str) -> None:
        """Attribute the time since the previous mark of the current step
        to ``phase`` (engine_profiler.PHASES); no-op outside step()."""
        if self._prof_timer is not None:
            self._prof_timer.mark(phase)

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
            occupied = [s for s in range(self.max_slots) if self.slots[s] is not None]
            sampled = any(self._slot_temp[s] > 0 for s in occupied)
            filtered = any(
                self._slot_topk[s] < self.cfg.vocab_size or self._slot_topp[s] < 1.0
                for s in occupied
            )
            biased = any(self.slots[s].logit_bias for s in occupied)
            want_lp = any(self.slots[s].logprobs for s in occupied)
            self._device_op(
                "rebuild", list(self._slot_last), list(self._slot_len), self._tp_key(sub),
                list(self._slot_aid) if self.cfg.lora_serve else None,
                list(self._slot_temp) if sampled else None,
                (list(self._slot_topk), list(self._slot_topp)) if filtered else None,
                ([list(r) for r in self._slot_bias_ids], [list(r) for r in self._slot_bias_vals])
                if biased else None,
            )
            variant = "filtered" if filtered else "sampled" if sampled else "greedy"
            dev = self._dev = {"variant": variant, "biased": biased, "want_lp": want_lp}
        return dev

    def _op_rebuild(self, tokens, positions, key, aids, temps, filters, bias) -> None:
        """Rewrite the step buffers in place from host lists (a captured
        graph reads their addresses): every slot's last token, position and
        the key; the adapter ids, temperatures, top-k/top-p and logit bias
        when the state uses them (None: left as they are)."""
        bufs = self._bufs
        bufs["tokens"].copy_(torch.tensor(tokens)[:, None])
        bufs["positions"].copy_(torch.tensor(positions)[:, None])
        bufs["key"].copy_(torch.as_tensor(key))
        if aids is not None:
            bufs["aids"].copy_(torch.tensor(aids))
        if temps is not None:
            bufs["temps"].copy_(torch.tensor(temps, dtype=torch.float32))
        if filters is not None:
            bufs["topks"].copy_(torch.tensor(filters[0]))
            bufs["topps"].copy_(torch.tensor(filters[1], dtype=torch.float32))
        if bias is not None:
            bufs["bias_ids"].copy_(torch.tensor(bias[0]))
            bufs["bias_vals"].copy_(torch.tensor(bias[1], dtype=torch.float32))

    def _feed_forward(self, dev: dict) -> dict:
        """Install the state a dispatch fed forward (already in the buffers)
        as current: a fresh dict, the in-flight validity token."""
        self._dev = dict(dev)
        return self._dev

    def _dispatch_body(self, T: int, shape: tuple) -> None:
        """One dispatch from the buffers: T decode steps, their tokens into
        ``_outs[T]`` (and logprobs into ``_lps[T]``), the next inputs back
        into the buffers.  What a CUDA graph of the dispatch captures."""
        variant, biased, want_lp = shape
        bufs = self._bufs
        temps = None if variant == "greedy" else bufs["temps"]
        topks, topps = (bufs["topks"], bufs["topps"]) if variant == "filtered" else (None, None)
        bias_ids, bias_vals = (bufs["bias_ids"], bufs["bias_vals"]) if biased else (None, None)
        out, lps, tokens, positions, key = decode_tokens(
            self.model, self.cache, self._chain, bufs["tokens"], bufs["positions"], bufs["key"],
            T, temps, topks, topps, bias_ids, bias_vals, want_lp,
            adapter_ids=bufs["aids"] if self.cfg.lora_serve else None,
        )
        self._outs[T].copy_(out)
        if want_lp:
            self._lps[T].copy_(lps)
        bufs["tokens"].copy_(tokens)
        bufs["positions"].copy_(positions)
        if key is not bufs["key"]:  # a greedy dispatch returns its key as is
            bufs["key"].copy_(key)

    def _op_dispatch(self, T: int, variant: str, biased: bool, want_lp: bool) -> None:
        """Enqueue one decode dispatch of T steps from the buffers and count
        its device steps."""
        self._run_dispatch(T, (variant, biased, want_lp))
        self.device_steps += T

    def _run_dispatch(self, T: int, shape: tuple) -> None:
        """Enqueue one decode dispatch of T steps (see :meth:`_run_graphed`)."""
        if T not in self._outs:
            self._outs[T] = torch.empty((self.max_slots, T), dtype=torch.long, device=self.device)
            self._lps[T] = torch.empty((self.max_slots, T), dtype=torch.float32, device=self.device)
        self._run_graphed((T, *shape), lambda: self._dispatch_body(T, shape), f"compile:block_{T}")

    def _run_graphed(self, key: tuple, body, grace: str) -> None:
        """Enqueue ``body`` (a dispatch from the buffers): eagerly, or as the
        replay of its graph.  A key's first run is eager (it is also the
        warm-up capture needs: the kernels' first launches set their
        attributes) and is then captured; the paged kernel's launch counts
        advance by what one replay launches."""
        entry = self._graphs.get(key) if self.cuda_graphs else None
        if entry is None:
            if key not in self._graphs:
                # A new shape: its first launches may build kernels (and a
                # capture follows): grace the watchdog.  Eager engines
                # record the shape as seen, with no graph.
                self._wd_grace(grace)
            body()
            before = dict(self._tp.calls) if self._tp is not None else {}
            self._graphs[key] = self._capture(body) if self.cuda_graphs else None
            if self.cuda_graphs and self._tp is not None:
                # The collectives one replay runs: what the capture issued.
                self.captured_collectives[str(key)] = {
                    kind: n - before.get(kind, 0) for kind, n in self._tp.calls.items()}
            return
        graph, launches = entry
        graph.replay()
        self.graph_replays += 1
        for fmt, n in launches.items():
            pa.count_launches(fmt, n)

    def _capture(self, body) -> tuple:
        """Capture ``body`` as a CUDA graph.  Capture launches nothing, so
        the launches it counted are kept apart as what each replay adds.
        The capture restricts this thread only: other engines of the
        process (a router's replicas) go on stepping on theirs."""
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: freeing another graph
        # there (an engine dropped in a reference cycle) is not permitted
        # while a stream captures, and invalidates this capture.
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with pa.capturing() as launches, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                body()
        finally:
            if gc_on:
                gc.enable()
        return graph, launches

    # ----------------------------------------------- the overlapped pipeline
    #
    # Per step() call on the decode path (the reference's state machine):
    #
    #   no in-flight    -> make the coming writes addressable, dispatch N;
    #                      if overlap allowed, dispatch N+1 from N's
    #                      fed-forward state; consume N.
    #   valid in-flight -> grow the frontier for N+1 and dispatch it FIRST,
    #                      then consume N while N+1 computes.
    #   stale in-flight -> discard it: an admission, finish, cancel or
    #                      preemption invalidated the state it was
    #                      dispatched from.  Its K/V writes are overwritten
    #                      before any read can see them; only the carried
    #                      seq_lens (the append writes there) go back to
    #                      host truth.

    def _head_cannot_admit(self) -> bool:
        """Whether the queue head cannot admit at the next step: no queue,
        no free slot, or the head waits on pages (only a finish or
        reclamation frees them)."""
        return (
            not self.queue
            or all(s is not None for s in self.slots)
            or self._admit_page_blocked
        )

    def _overlap_allowed(self) -> bool:
        """Whether dispatching one round ahead pays off now: not while a
        prefill streams in or the queue head could admit this step (the
        activation would invalidate the round in flight)."""
        if not self._overlap_steps or self._pending:
            return False
        return self._head_cannot_admit()

    def _dispatch_decode(self, active: list[int], T: int = 1) -> dict:
        """Enqueue one dispatch (a step, or a T-step block) from the current
        state and install its fed-forward state.  Returns what consumption
        needs: the tokens' (and logprobs') host copy and, on the card, the
        event that says it landed, and the (slot, request) pairs pinned now
        so a consumer skips lanes evicted since.  ``dev`` is the validity
        token."""
        self._guard_inflight("dispatch")
        dev = self._device_state()
        self._device_op("dispatch", T, dev["variant"], dev["biased"], dev["want_lp"])
        outs = [self._outs[T]] + ([self._lps[T]] if dev["want_lp"] else [])
        if self.device.type == "cuda":
            # The copies are ordered after this dispatch and before the next
            # one overwrites the buffers; the event lets the consumer wait
            # for this dispatch alone.
            host = []
            for t in outs:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            landed = torch.cuda.Event()
            landed.record()
        else:
            host, landed = [t.clone() for t in outs], None
        return {
            "T": T,
            "out": host[0],
            "lps": host[1] if dev["want_lp"] else None,
            "landed": landed,
            "active": list(active),
            "reqs": [self.slots[s] for s in active],
            "dev": self._feed_forward(dev),
        }

    def _guard_inflight(self, op: str) -> None:
        if self._inflight_guard is not None:
            self._inflight_guard.check(op)

    def _take_inflight(self, T: int) -> Optional[dict]:
        """Pop the in-flight record if it is still consumable (its state is
        current and it has the shape this step consumes); else discard."""
        inflight = self._inflight
        if inflight is None:
            return None
        self._guard_inflight("consume")
        self._inflight = None
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
        self._device_op("seq_lens", list(self._slot_len))

    def _op_seq_lens(self, lens: list[int]) -> None:
        self.cache.seq_lens.copy_(torch.tensor(lens, dtype=torch.int32))

    def _discard(self, inflight: dict, reason: str) -> None:
        """Throw away a dispatch in flight: drop the state it fed forward
        (the next dispatch rebuilds) and repair seq_lens."""
        self._dev = None
        self._repair_seq_lens()
        self.overlap_discards += 1
        self.discards_by_reason[reason] += 1
        if self.metrics:
            self.metrics.overlap_discards.inc()
        self.flight.record("overlap.discard", reason=reason, T=inflight["T"],
                           slots=len(inflight["active"]))

    def _drop_stale_inflight(self, reason: str) -> None:
        inflight, self._inflight = self._inflight, None
        if inflight is not None:
            self._guard_inflight("discard")
            self._discard(inflight, reason)

    @staticmethod
    def _unpack(rec: dict) -> tuple:
        """The record's tokens [slots][T] and logprobs (or None): the
        step's one synchronisation.  The ``engine.readback`` failpoint
        delays it, raises out of step(), or flips the low bytes of the
        token buffer (the silent corruption the canary prober scores)."""
        hit = failpoints.fire("engine.readback")
        if rec["landed"] is not None:
            rec["landed"].synchronize()
        toks = rec["out"]
        if hit is not None and hit.mode == "corrupt":
            nbytes = int(hit.arg) if hit.arg else 1
            arr = toks.numpy().copy()
            flat = arr.view(np.uint8).reshape(-1)
            flat[: max(1, min(nbytes, flat.size))] ^= 0x01
            toks = torch.from_numpy(arr)
        lps = rec["lps"].tolist() if rec["lps"] is not None else None
        return toks.tolist(), lps

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
        span = (self.spans.span("engine.step", trace_id=ENGINE_TRACE) if self.spans
                else contextlib.nullcontext())
        self._run_owner_calls()
        timer = self._prof_timer = self.profiler.timer()
        self._step_tokens = 0
        hits0, discards0 = self.overlap_hits, self.overlap_discards
        kv_hits0 = self.kv_retained_hits + self.kv_host_hits
        kv_restores0 = self.kv_restores
        wd = self.watchdog
        if wd is not None:
            wd.step_started()
        try:
            with span:
                if self.metrics:
                    with self.metrics.step_seconds.time():
                        return self._step_inner()
                return self._step_inner()
        finally:
            self._prof_timer = None
            with self._lock:
                active = sum(1 for s in self.slots if s is not None)
                queued = len(self.queue)
                allocatable = self.paged.num_pages - 1
                util = 1.0 - len(self.free_pages) / allocatable if allocatable else 0.0
            wall = self.profiler.finish_step(
                timer, active_slots=active, max_slots=self.max_slots, queued=queued,
                kv_page_utilization=util, tokens=self._step_tokens,
                overlap_hits=self.overlap_hits - hits0,
                overlap_discards=self.overlap_discards - discards0,
                kvcache_hits=self.kv_retained_hits + self.kv_host_hits - kv_hits0,
                kvcache_restores=self.kv_restores - kv_restores0,
            )
            if wd is not None:
                wd.step_finished(wall)

    def _step_inner(self) -> list[Request]:
        # Overload sweeps run before admission: an expired queued request
        # sheds without touching pages.
        finished = self._overload_sweep() if self.overload is not None else []
        finished += self._admit()
        # Cancelled live slots tear down before the dispatch.
        for s in range(self.max_slots):
            req = self.slots[s]
            if req is not None and req.cancelled and self._slot_ready[s]:
                self._maybe_finish(s)
                finished.append(req)
        self._mark("schedule")
        for job in list(self._pending):
            if self._advance_prefill(job):
                self._pending.remove(job)
                finished.extend(self._activate(job))
        self._mark("prefill")
        active = [s for s in range(self.max_slots) if self.slots[s] is not None and self._slot_ready[s]]
        if not active:
            self._update_gauges()
            return finished
        if self._spec_gamma:
            return self._spec_step(active, finished)
        T = 1
        if (
            self._decode_block > 1
            and not self._pending  # no prompt mid-stream: keep chunking
            # Queued work argues for single steps only while the head could
            # admit: a saturated engine or a blocked head cannot until
            # something finishes, and a mid-block finish truncates that
            # slot's tail so the next step admits.
            and self._head_cannot_admit()
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
        room for both).  The frontier covers every write dispatched: T - 1
        positions ahead, 2T - 1 with a round in flight; under optimistic
        admission growing it may preempt."""
        overlap = self._overlap_allowed() and (T == 1 or self._block_room(active) >= 2 * T)
        rec = self._take_inflight(T)
        if rec is None:
            active = self._ensure_frontier(active, 2 * T - 1 if overlap else T - 1)
            if not active:
                self._update_gauges()
                return finished
            rec = self._dispatch_decode(active, T)
            if overlap:
                self._inflight = self._dispatch_decode(active, T)
        else:
            self._record_hit()
            if overlap:
                active = self._ensure_frontier(active, 2 * T - 1)
                # A preemption in the ensure dirtied the state: this step
                # consumes what it has and re-primes next call.
                if active and self._dev is rec["dev"]:
                    self._inflight = self._dispatch_decode(active, T)
        self._mark("dispatch")
        return self._consume(rec, finished)

    def _consume(self, rec: dict, finished: list[Request]) -> list[Request]:
        """Host half of one round: read back, then per slot up to T tokens
        (each logprob before its token, so a streaming reader never sees
        one without the other), truncated at EOS, max_new or a stop
        sequence (a slot that finishes mid-block wastes its tail: its
        writes land past its final length and are never read).  Under
        overlap this runs while the next round computes."""
        T = rec["T"]
        toks, lps = self._unpack(rec)
        self._mark("readback")
        now = time.monotonic()
        emitted = 0
        for s, req in zip(rec["active"], rec["reqs"]):
            if self.slots[s] is not req or not self._slot_ready[s]:
                continue  # evicted between dispatch and readback
            consumed = 0
            for j in range(T):
                tok = toks[s][j]
                if req.logprobs:
                    req.token_logprobs.append(lps[s][j])
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
        self._mark("host_gap" if self._inflight is not None else "sample")
        self._step_tokens += emitted
        if self.metrics:
            self.metrics.steps.inc()
            self.metrics.tokens.inc(emitted)
        self._update_gauges()
        return finished

    def _observe_itl(self, slot: int, consumed: int, now: float) -> None:
        """ITL for ``consumed`` tokens that landed at ``now`` on a slot: a
        multi-token dispatch observes the amortized gap once per token;
        the request keeps its peak gap (the SLO plane's ITL p99) and the
        overload controller its per-token latency."""
        last = self._slot_emit_t[slot]
        self._slot_emit_t[slot] = now
        if consumed <= 0 or last <= 0.0:
            return
        per = (now - last) / consumed
        req = self.slots[slot]
        if req is not None and per > req.itl_peak_s:
            req.itl_peak_s = per
        if self.overload is not None:
            self.overload.observe_itl(per)
        if not self.metrics:
            return
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
            m.kvcache_retained_pages.set(len(self._kv_retained))
            m.kvcache_host_bytes.set(self._kv_arena.bytes)

    # -------------------------------------------------------------- states

    def debug_state(self) -> dict:
        """JSON-safe engine snapshot for ``GET /debug/state`` (the
        reference's keys): slot occupancy, queue, pool pressure, the
        overlap round, overload, SLO, tiers and config.  Lengths only,
        never token content."""
        with self._lock:
            slots = []
            for s in range(self.max_slots):
                req = self.slots[s]
                if req is None:
                    slots.append(None)
                    continue
                slots.append({
                    "rid": req.rid,
                    "trace_id": req.trace_id,
                    "prompt_tokens": len(req.prompt),
                    "generated": len(req.tokens),
                    "max_new_tokens": req.max_new_tokens,
                    "ready": self._slot_ready[s],
                    "pages": len(self._slot_pages[s]),
                    "cancelled": req.cancelled,
                })
            allocatable = self.paged.num_pages - 1
            return {
                "slots": slots,
                "queue_depth": len(self.queue),
                "pending_prefills": len(self._pending),
                "free_pages": len(self.free_pages),
                "allocatable_pages": allocatable,
                "page_utilization": round(1.0 - len(self.free_pages) / allocatable, 4)
                if allocatable else 0.0,
                "shared_pages": sum(1 for c in self._page_refs.values() if c > 1),
                "preemptions": self.preemptions,
                "overlap": {
                    "steps": self._overlap_steps,
                    "in_flight": self._inflight is not None,
                    "hits": self.overlap_hits,
                    "discards": self.overlap_discards,
                },
                "tp": self.tp_state(),
                "spec": {"gamma": self._spec_gamma, "proposed": self.spec_proposed,
                         "accepted": self.spec_accepted},
                "overload": self.overload.snapshot() if self.overload is not None
                else {"enabled": False},
                "slo": self.slo.snapshot() if self.slo is not None else {"enabled": False},
                "kvcache": self.kvcache_state(),
                "disagg": self.handoff_state(),
                # The port's own block: what ran on the device, for the
                # launch accounting a caller holds against the steps.
                "device": {
                    "type": self.device.type,
                    "cuda_graphs": self.cuda_graphs,
                    "graph_replays": self.graph_replays,
                    "device_steps": self.device_steps,
                    "spec_rounds": self.spec_rounds,
                    "prefill_positions": self.prefill_positions,
                    "state_rebuilds": self.state_rebuilds,
                    "discards_by_reason": dict(self.discards_by_reason),
                    "paged_launches": dict(pa.paged_attention.launches_by_format),
                    "num_layers": self.cfg.num_layers,
                },
                "config": {
                    "role": self.role,
                    "max_slots": self.max_slots,
                    "page_size": self.paged.page_size,
                    "num_pages": self.paged.num_pages,
                    "max_pages_per_seq": self.paged.max_pages_per_seq,
                    "kernel": self.kernel_on,
                    "kernel_splits": self.paged.kernel_num_splits,
                    "decode_block": self._decode_block,
                    "admission": "optimistic" if self._optimistic else "reserve",
                    "prefix_sharing": self.prefix_sharing,
                },
            }

    def overload_state(self) -> dict:
        """Body of ``GET /debug/admission`` (``{"enabled": False}`` without
        a controller)."""
        with self._lock:
            if self.overload is None:
                return {"enabled": False}
            return self.overload.snapshot()

    def slo_state(self) -> dict:
        """Body of ``GET /debug/slo``."""
        with self._lock:
            if self.slo is None:
                return {"enabled": False}
            snap = self.slo.snapshot()
            snap["enabled"] = True
            return snap

    def usage_state(self) -> dict:
        """Body of ``GET /debug/usage``."""
        with self._lock:
            if self.usage is None:
                return {"enabled": False}
            snap = self.usage.snapshot()
            snap["enabled"] = True
            return snap

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
    """The batch CLI's flags (the reference CLI's names and defaults for
    what the port serves, plus ``--dtype``, ``--seed``, ``--device`` and
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
    p.add_argument("--spec-gamma", type=int, default=0,
                   help="speculative decoding: gamma w8 self-draft proposals per verify pass "
                   "(shared pool; greedy slots emit exactly the greedy decode). Incompatible "
                   "with --quant")
    p.add_argument("--prefill-chunk", type=_pow2_int, default=None,
                   help="stream prompts into the prefill in chunks of this many tokens")
    p.add_argument("--decode-block", type=_pow2_int, default=1,
                   help="in pure decode, advance every slot up to this many tokens per "
                   "dispatch (power of two)")
    p.add_argument("--overlap-steps", type=int, choices=[0, 1], default=1,
                   help="decode dispatches kept in flight ahead of the readback (0: "
                   "synchronous)")
    p.add_argument("--admission", choices=["reserve", "optimistic"], default="reserve",
                   help="optimistic: prompt pages only at admission, grown on demand, the "
                   "newest slot preempted (and recomputed) when the pool runs dry")
    p.add_argument("--overload", type=int, choices=[0, 1], default=1,
                   help="overload control (models/engine_overload.py): priority and "
                   "deadline-aware admission, per-tenant fair sharing, expiry sweeping and "
                   "an AIMD concurrency limiter on measured queue wait (default on; 0: the "
                   "plain FIFO queue)")
    p.add_argument("--overload-target-wait", type=float, default=0.5,
                   help="AIMD setpoint: the queue wait (seconds) the limiter steers "
                   "admitted concurrency toward")
    p.add_argument("--overload-max-queue", type=int, default=512,
                   help="hard queue cap: submits past this depth shed at once")
    p.add_argument("--slo", type=int, choices=[0, 1], default=1,
                   help="SLO plane (utils/slo.py): per-request SLI verdicts into "
                   "sliding-window error budgets with burn-rate alerts, plus per-tenant "
                   "usage meters (default on; 0 disables all accounting)")
    p.add_argument("--slo-ttft-target", type=float, default=2.0,
                   help="TTFT objective threshold (seconds)")
    p.add_argument("--slo-itl-target", type=float, default=0.25,
                   help="per-request ITL p99 objective threshold (seconds)")
    p.add_argument("--kv-retain", type=int, choices=[0, 1], default=1,
                   help="KV cache tier 1: keep dead-but-valid prefix pages on an LRU for a "
                   "later match instead of freeing them (default on)")
    p.add_argument("--kv-host-cache-mb", type=float, default=64,
                   help="KV cache tier 2: byte budget (MiB) of the host arena reclaimed "
                   "pages and preemption snapshots spill into (0 disables; default 64)")
    p.add_argument("--cuda-graphs", type=int, choices=[0, 1], default=None,
                   help="replay each decode dispatch as a CUDA graph (the card only; "
                   "default 1 there)")
    p.add_argument("--tp", type=positive, default=1,
                   help="tensor-parallel degree: shard params (Megatron path rules) and KV "
                   "pools (kv-heads axis) over a mesh built from the chips the plugin "
                   "allocated — TPU_VISIBLE_CHIPS in physical ICI snake order "
                   "(parallel/mesh.mesh_from_allocation); must equal the granted chip count "
                   "on-cluster, and kv-heads must divide by it; off-cluster falls back to the "
                   "first N ranks, one process per card (gloo ranks on the CPU); 1 = "
                   "single-chip (default)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.spec_gamma and args.quant:
        p.error("--spec-gamma uses the w8 SELF-draft against the unquantized target; an "
                "already-quantized target (--quant) leaves nothing to verify against")
    if args.cuda_graphs is not None and args.device is not None and \
            torch.device(args.device).type == "cpu":
        p.error("--cuda-graphs is meaningless on the CPU, which runs every dispatch eagerly")
    return args


def build_engine(args, mesh=None, device=None) -> "ServingEngine":
    """The engine the batch CLI's flags describe, with random weights from
    ``--seed`` (quantized by ``init_params`` under ``--quant``, as the
    reference CLI quantizes its init), a fresh metrics registry, and the
    overload controller and SLO plane unless ``--overload 0`` / ``--slo 0``
    (the reference CLI's wiring).  ``mesh``/``device``: a rank of a
    tensor-parallel group (``engine_tp.launch``; every rank calls this
    with the same ``args``)."""
    device = resolve_device(args.device) if device is None else device
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

    params = init_params(cfg, args.seed)
    spec_kw = {}
    if args.spec_gamma:
        from ..ops.quant import quantize_lm_params

        spec_kw = dict(spec_gamma=args.spec_gamma, draft_params=quantize_lm_params(params))
    overload = None
    if args.overload:
        overload = OverloadConfig(target_queue_wait_s=args.overload_target_wait,
                                  max_queue=args.overload_max_queue)
    slo = None
    if args.slo:
        slo = {"ttft_target_s": args.slo_ttft_target, "itl_p99_target_s": args.slo_itl_target}
    return ServingEngine(
        cfg, params, paged, max_slots=args.slots,
        metrics=EngineMetrics(MetricsRegistry()), prefill_chunk=args.prefill_chunk, **spec_kw,
        decode_block=args.decode_block, overlap_steps=args.overlap_steps,
        admission=args.admission, overload=overload, slo=slo,
        kv_retain=bool(args.kv_retain), kv_host_cache_mb=args.kv_host_cache_mb,
        cuda_graphs=None if args.cuda_graphs is None else bool(args.cuda_graphs),
        device=device, mesh=mesh,
    )


def benchmark(args, eng: Optional["ServingEngine"] = None) -> tuple[dict, list[Request]]:
    """The reference CLI's synthetic request stream through the engine,
    after a warmup that runs every distinct prompt length once, for
    2 x ``--decode-block`` new tokens, so every block size (each a graph on
    the card) has run once, on ``eng`` (default: ``build_engine(args)``, a
    caller that reads the engine afterwards passes its own).  Returns the
    summary (the reference's JSON keys
    plus ``decode_block``, ``cuda_graphs``, ``state_rebuilds``,
    ``graph_replays``, ``device_steps``, ``spec_rounds``, ``admission``,
    ``preemptions`` and ``device``; the counts cover the warmup too) and the timed run's finished requests."""
    eng = build_engine(args) if eng is None else eng
    device = eng.device
    sample_kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    jobs = synthetic_jobs(args.requests, args.prompt_len, args.max_new, args.vocab)
    warm = {len(prompt): prompt for prompt, _ in jobs}
    eng.run([(prompt, 2 * args.decode_block) for prompt in warm.values()], **sample_kw)
    # The acceptance covers the timed run only, as the throughput does.
    eng.spec_proposed = eng.spec_accepted = 0
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
        "tp": eng.tp_size,
        "quant": args.quant,
        "kernel": eng.kernel_on,
        "sampler": "greedy"
        if args.temperature <= 0
        else f"temperature={args.temperature},top_k={args.top_k},top_p={args.top_p}",
        "spec_gamma": args.spec_gamma,
        "spec_acceptance": round(eng.spec_accepted / max(eng.spec_proposed, 1), 3)
        if args.spec_gamma else None,
        "spec_rounds": eng.spec_rounds,
        "tokens": tokens,
        "wall_s": round(dt, 2),
        "overlap_steps": eng._overlap_steps,  # 0 under speculation, whatever the flag
        "overlap_hits": eng.overlap_hits,
        "overlap_discards": eng.overlap_discards,
        "decode_block": args.decode_block,
        "cuda_graphs": eng.cuda_graphs,
        "state_rebuilds": eng.state_rebuilds,
        "graph_replays": eng.graph_replays,
        "device_steps": eng.device_steps,
        "admission": args.admission,
        "preemptions": eng.preemptions,
        "kv_retain": bool(args.kv_retain),
        "kv_retained_hits": eng.kv_retained_hits,
        "kv_host_hits": eng.kv_host_hits,
        "ttft_p50_ms": _ms(ttft_h.quantile(0.5, since=ttft_snap)),
        "ttft_p99_ms": _ms(ttft_h.quantile(0.99, since=ttft_snap)),
        "itl_p50_ms": _ms(itl_h.quantile(0.5, since=itl_snap)),
        "itl_p99_ms": _ms(itl_h.quantile(0.99, since=itl_snap)),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return summary, done


def main(argv: Optional[list[str]] = None) -> None:
    """Batch serving benchmark CLI: prints the summary as one JSON line.
    ``--tp N`` > 1 runs it over N ranks (``engine_tp.launch``), the leader
    printing."""
    import json
    import sys

    args = parse_args(argv)
    if args.tp == 1:
        summary, _ = benchmark(args)
    else:
        from .engine_tp import launch

        try:
            group = launch(args.tp, device=args.device)
        except ValueError as e:
            raise SystemExit(str(e))
        with group:
            eng = group.build(functools.partial(build_engine, args))
            print(f"tensor parallel: tp={args.tp} over {eng.tp_state()['devices']} "
                  f"(follower pids {group.follower_pids})", file=sys.stderr, flush=True)
            summary, _ = benchmark(args, eng)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
