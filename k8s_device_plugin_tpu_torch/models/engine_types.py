"""Serving-engine types: the request record and its Prometheus series.

The port's own copy of the reference's ``models/engine_types.py``: the
request lifecycle (logprobs, logit bias, trace ids, priority, tenant,
deadline, shed and preemption stamps) and every ``EngineMetrics`` series
the reference server exposes, under the reference's names, so one
dashboard and ``tools/metrics_lint.py`` read both engines.  Series of
features the port does not serve yet (adapters, speculation, KV tiers,
handoff) are registered and stay at zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils.metrics import MetricsRegistry


def _pow2_int(text: str) -> int:
    """argparse type: positive power of two (chunk sizes must tile the
    power-of-two length buckets)."""
    import argparse

    value = int(text)
    if value < 1 or value & (value - 1):
        raise argparse.ArgumentTypeError(
            f"must be a positive power of two, got {value}"
        )
    return value


class EngineMetrics:
    """Prometheus series for the serving engine (same registry machinery
    the plugin daemon exposes on its --metrics-port).  Pass a shared
    registry to co-expose with other subsystems, or let each engine own
    one and mount it on a utils.metrics.MetricsServer."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.requests = registry.counter(
            "tpu_engine_requests_total",
            "Requests admitted into a decode slot",
        )
        self.tokens = registry.counter(
            "tpu_engine_tokens_total", "Tokens emitted across all requests"
        )
        self.steps = registry.counter(
            "tpu_engine_steps_total", "Jitted decode steps executed"
        )
        self.active_slots = registry.gauge(
            "tpu_engine_active_slots", "Slots currently serving a request"
        )
        self.queued = registry.gauge(
            "tpu_engine_queued_requests", "Requests waiting for slots/pages"
        )
        self.free_pages = registry.gauge(
            "tpu_engine_free_pages", "Unallocated KV-cache pages"
        )
        self.shared_pages = registry.gauge(
            "tpu_engine_shared_pages",
            "Pages currently referenced by more than one request (prefix sharing)",
        )
        self.spec_proposed = registry.counter(
            "tpu_engine_spec_proposed_total",
            "Draft tokens proposed by speculative rounds",
        )
        self.spec_accepted = registry.counter(
            "tpu_engine_spec_accepted_total",
            "Draft tokens the target accepted (rate = accepted/proposed)",
        )
        self.spec_rejected = registry.counter(
            "tpu_engine_spec_rejected_total",
            "Draft tokens the target rejected (proposed - accepted; a "
            "rising rate says gamma is too high for this traffic)",
        )
        self.preemptions = registry.counter(
            "tpu_engine_preemptions_total",
            "Slots evicted for recompute-resume under optimistic admission",
        )
        self.state_rebuilds = registry.counter(
            "tpu_engine_state_rebuilds_total",
            "Device step-state rebuilds from host lists (admissions, "
            "teardowns); steady decode should add ~2 per request "
            "lifecycle, not per token.  Speculative engines drive every "
            "step through their own host-published state and never "
            "rebuild, so this stays 0 when spec_gamma > 0",
        )
        self.overlap_hits = registry.counter(
            "tpu_engine_overlap_hits_total",
            "Decode rounds consumed from an overlapped in-flight "
            "dispatch (issued before the previous round's readback); "
            "in steady decode with overlap_steps=1 this tracks "
            "steps_total",
        )
        self.overlap_discards = registry.counter(
            "tpu_engine_overlap_discards_total",
            "Overlapped dispatches thrown away because a slot event "
            "(admission, finish, cancel, preemption) invalidated their "
            "inputs — one wasted device lane each; a rate rivalling "
            "overlap_hits says traffic churns too fast for "
            "--overlap-steps 1 to pay off",
        )
        self.step_seconds = registry.histogram(
            "tpu_engine_step_seconds",
            "Wall time of one engine step() call (admission + dispatch + "
            "consume); histogram_quantile() gives serving-step p50/p99",
        )
        self.wait_seconds = registry.histogram(
            "tpu_engine_request_wait_seconds",
            "Queue-to-first-token wait per request (admission latency "
            "under load)",
            # Wider than the step buckets: overload pushes waits far past
            # 10s, and a saturated top bucket would clamp the p99 exactly
            # when the metric matters.
            buckets=(
                0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0, 60.0, 120.0, 300.0,
            ),
        )
        # The two serving-latency numbers operators actually page on.
        # TTFT = submit -> first emitted token (queue wait + batched
        # prefill + admission overhead); ITL = gap between consecutive
        # emitted tokens of one request (decode-block dispatches emit T
        # tokens at once, so each of those T observes dt/T — the sum
        # stays wall-accurate and histogram_quantile() stays meaningful).
        self.ttft_seconds = registry.histogram(
            "tpu_engine_ttft_seconds",
            "Submit-to-first-token latency per request; "
            "histogram_quantile(0.99, ...) is the serving SLO number",
            buckets=(
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0, 120.0,
            ),
        )
        self.itl_seconds = registry.histogram(
            "tpu_engine_itl_seconds",
            "Inter-token latency per emitted decode token "
            "(block dispatches amortize: each of T tokens observes dt/T)",
        )
        self.incidents = registry.counter(
            "tpu_engine_incidents_total",
            "Anomaly incidents emitted by the engine-side monitor "
            "(utils/anomaly.py): sustained deviations of step time or "
            "TTFT from their EWMA baselines; the records themselves are "
            "served at GET /debug/incidents",
            ["metric"],
        )
        self.tp_size = registry.gauge(
            "tpu_engine_tp_size",
            "Tensor-parallel degree of the serving engine (size of the "
            "tp mesh axis built from the plugin's allocation; 1 = "
            "single-chip).  Set once at engine construction",
        )
        # Split-K paged-attention kernel routing (ops/paged_attention.py):
        # whether this engine's decode steps read pages through the
        # kernel, and ctor-time fallback decisions worth surfacing (the
        # speculative verify pass riding gather, an untuned generation
        # running the conservative split row).
        self.kernel_enabled = registry.gauge(
            "tpu_engine_kernel_enabled",
            "1 when the paged decode reads the KV pool through the "
            "split-K flash-decode kernel, 0 on the gather fallback "
            "(PagedConfig.use_kernel; auto resolves to gather until a "
            "hardware round records tuning rows).  Set once at engine "
            "construction",
        )
        self.kernel_fallbacks = registry.counter(
            "tpu_engine_kernel_fallbacks_total",
            "Kernel-path fallback decisions at engine construction, by "
            "reason (spec_verify: the multi-token speculative verify "
            "pass rides the gather path by design while single-token "
            "steps keep the kernel; untuned_generation: no reviewed "
            "ops/tuning.py row for this chip — the kernel runs the "
            "conservative fallback split row until a hardware round "
            "records one).  Each pairs with a kernel.fallback flight "
            "event",
            ["reason"],
        )
        self.page_utilization = registry.gauge(
            "tpu_engine_kv_page_utilization",
            "Allocated fraction of the allocatable KV page pool (0..1; "
            "sustained ~1.0 with queued requests means the pool, not "
            "compute, caps concurrency)",
        )
        # KV cache tiering (models/engine_kvcache.py): tier sizes, hit and
        # demotion flow, and what restore-instead-of-recompute costs.
        self.kvcache_retained_pages = registry.gauge(
            "tpu_engine_kvcache_retained_pages",
            "Dead-but-valid KV pages held on the retained (tier-1) LRU — "
            "trie-reachable at zero refcount, reclaimed lazily under "
            "pool pressure",
        )
        self.kvcache_host_bytes = registry.gauge(
            "tpu_engine_kvcache_host_bytes",
            "Bytes held in the host-RAM KV arena (tier 2, bounded by "
            "--kv-host-cache-mb): offloaded pages plus preemption "
            "snapshots",
        )
        self.kvcache_hits = registry.counter(
            "tpu_engine_kvcache_hits_total",
            "Prefix pages served from a KV cache tier instead of "
            "recomputed (tier=retained: revived device page; tier=host: "
            "restored from the arena)",
            ["tier"],
        )
        self.kvcache_evictions = registry.counter(
            "tpu_engine_kvcache_evictions_total",
            "KV tier demotions/evictions (tier=retained: page reclaimed "
            "into the free pool, offloading first when the arena is on; "
            "tier=host: arena entries dropped to hold the byte budget)",
            ["tier"],
        )
        self.kvcache_restores = registry.counter(
            "tpu_engine_kvcache_restores_total",
            "Pages restored host->device via sliced page writes (no "
            "recompute, no new compiled shapes)",
        )
        self.kvcache_restore_seconds = registry.histogram(
            "tpu_engine_kvcache_restore_seconds",
            "Wall time of one host->device restore batch (all pages of "
            "one admission, every layer); compare against the prefill "
            "it replaced to validate the tier pays off",
        )
        self.resumes = registry.counter(
            "tpu_engine_resumes_total",
            "Preempted requests re-admitted after eviction "
            "(mode=restored: slot rebuilt from the KV tiers, zero "
            "prefill; mode=recompute: full prefill over prompt + "
            "generated tokens) — preemptions_total minus this is the "
            "victims still waiting",
            ["mode"],
        )
        self.resume_restored_tokens = registry.counter(
            "tpu_engine_resume_restored_tokens_total",
            "Tokens whose K/V a preemption resume restored instead of "
            "recomputing",
        )
        self.resume_recomputed_tokens = registry.counter(
            "tpu_engine_resume_recomputed_tokens_total",
            "Tokens re-prefilled by recompute-resumes (the work the KV "
            "tiers exist to avoid; a rising rate says the host arena is "
            "too small for the preemption churn)",
        )
        # Overload control (models/engine_overload.py).  The queue-wait
        # histogram is the AIMD limiter's input signal made scrapeable:
        # submit -> slot-assignment wait per admitted request, split by
        # priority class (a closed 3-value label, never per-tenant).
        self.queue_wait_seconds = registry.histogram(
            "tpu_engine_queue_wait_seconds",
            "Queue wait (submit to slot assignment) per admitted request "
            "by priority class — the overload limiter steers this toward "
            "--overload-target-wait; histogram_quantile() gives the "
            "per-class admission-latency p99",
            buckets=(
                0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0, 60.0, 120.0, 300.0,
            ),
            labelnames=("priority",),
        )
        self.sheds = registry.counter(
            "tpu_engine_sheds_total",
            "Requests shed by overload control, by kind (expired: queued "
            "past deadline; infeasible: preempted from a slot that could "
            "no longer finish in time; queue_full / overload: rejected "
            "at submit) and priority class — shed requests never hold a "
            "slot or KV pages",
            ("kind", "priority"),
        )
        self.tenant_sheds = registry.counter(
            "tpu_engine_tenant_sheds_total",
            "Sheds per tenant (first 16 distinct tenants get their own "
            "label; later ones aggregate under _other so client-supplied "
            "names cannot mint unbounded series)",
            ("tenant",),
        )
        # SLO plane (utils/slo.py, ISSUE 16): one verdict per finished
        # request per objective, plus per-tenant usage meters.  The
        # tenant label rides the SAME bounded map as tenant_sheds (first
        # 16 distinct tenants, later ones fold into _other), so every
        # family stays under the fleet cardinality budget.
        self.sli_events = registry.counter(
            "tpu_engine_sli_events_total",
            "SLI verdicts by objective (ttft, itl_p99, availability) and "
            "verdict (good/bad) — the raw feed behind /debug/slo's error "
            "budgets; rate(verdict=bad) over rate() is the burn input",
            ("objective", "verdict"),
        )
        self.tenant_requests = registry.counter(
            "tpu_engine_tenant_requests_total",
            "Finished requests charged per tenant (16-tenant label cap, "
            "overflow under _other) — the /debug/usage row count",
            ("tenant",),
        )
        self.tenant_prompt_tokens = registry.counter(
            "tpu_engine_tenant_prompt_tokens_total",
            "Prompt tokens prefetched per tenant (charged only for "
            "requests that reached a slot; 16-tenant label cap)",
            ("tenant",),
        )
        self.tenant_decode_tokens = registry.counter(
            "tpu_engine_tenant_decode_tokens_total",
            "Decode tokens emitted per tenant (16-tenant label cap)",
            ("tenant",),
        )
        self.tenant_kv_page_seconds = registry.counter(
            "tpu_engine_tenant_kv_page_seconds_total",
            "KV page-seconds held per tenant: pages at finish x slot "
            "residency — a conservative upper bound (shared prefix pages "
            "charge every sharer; 16-tenant label cap)",
            ("tenant",),
        )
        self.tenant_queue_wait_seconds = registry.counter(
            "tpu_engine_tenant_queue_wait_seconds_total",
            "Seconds spent queued per tenant before a slot (or before "
            "the shed that answered instead; 16-tenant label cap)",
            ("tenant",),
        )
        self.goodput_tokens = registry.counter(
            "tpu_engine_goodput_tokens_total",
            "Tokens of requests that COMPLETED within their deadline "
            "(deadline-free requests count on completion) — compare "
            "against tpu_engine_tokens_total: the gap is work burned on "
            "requests that were shed, cancelled, or finished too late",
        )
        self.admission_limit = registry.gauge(
            "tpu_engine_admission_limit",
            "Current AIMD admitted-concurrency limit (slots the overload "
            "controller lets admission fill; max_slots when overload "
            "control is off or fully recovered)",
        )
        # Replica self-fencing (models/engine_watchdog.py + EngineServer):
        # a fenced replica stops admitting (503), reads fenced on
        # /healthz and the router's summary poll, and its in-flight
        # streams fail over — the metric pair is the rollout/alert
        # surface.
        self.fenced = registry.gauge(
            "tpu_engine_fenced",
            "1 while this replica is fenced (admission closed, router "
            "demoted, streams failing over); 0 otherwise.  Fence reasons "
            "ride tpu_engine_fences_total and GET /debug/state",
        )
        self.fences = registry.counter(
            "tpu_engine_fences_total",
            "Fence activations by source (watchdog: a dispatched step "
            "outlived its deadline; chip_health: a chip in this "
            "replica's mesh went Unhealthy/unplugged; operator: POST "
            "/debug/fence)",
            ["source"],
        )
        self.watchdog_deadline = registry.gauge(
            "tpu_engine_watchdog_deadline_seconds",
            "Current hung-step deadline (grace window during "
            "warmup/compiles, else factor x rolling step p99) — the "
            "wall-clock bound after which the watchdog fences",
        )
        # KV-arena warm restart (models/engine_snapshot.py): save/load
        # outcomes and the on-disk size — a corrupt load shows up as
        # outcome=corrupt with the replica serving cold, never poisoned.
        self.snapshot_saves = registry.counter(
            "tpu_engine_snapshot_saves_total",
            "KV-arena snapshot writes by outcome (ok / error); saves run "
            "on fence, drain, SIGTERM, and the periodic timer",
            ["outcome"],
        )
        self.snapshot_loads = registry.counter(
            "tpu_engine_snapshot_loads_total",
            "KV-arena snapshot restores at startup by outcome (ok / "
            "missing / corrupt / layout_mismatch / params_mismatch / "
            "disabled); anything but ok degrades to a clean cold start",
            ["outcome"],
        )
        self.snapshot_bytes = registry.gauge(
            "tpu_engine_snapshot_bytes",
            "Size of the last successfully written KV-arena snapshot "
            "(size the snapshot volume from this plus headroom)",
        )
        # Elastic warm scale-up (GET /debug/snapshot peer transfer):
        # donor-side serves and joiner-side fetches.  A joiner fetch
        # with anything but outcome=ok cold-started clean.
        self.snapshot_serves = registry.counter(
            "tpu_engine_snapshot_serves_total",
            "Peer snapshot streams served at GET /debug/snapshot by "
            "outcome (ok / refused / client_gone / error); refused = "
            "the joiner's layout/params fingerprint headers mismatched "
            "and no bytes moved",
            ["outcome"],
        )
        self.snapshot_served_bytes = registry.counter(
            "tpu_engine_snapshot_served_bytes",
            "KV-arena snapshot bytes streamed to warm-joining peers "
            "(donor-side transfer volume)",
        )
        self.snapshot_fetches = registry.counter(
            "tpu_engine_snapshot_fetches_total",
            "Peer snapshot fetches at warm join by outcome (ok / "
            "unreachable / refused / corrupt / layout_mismatch / "
            "params_mismatch / disabled); anything but ok degrades to "
            "a clean cold start",
            ["outcome"],
        )
        # Disaggregated prefill/decode serving (models/engine_handoff.py):
        # the replica's role plus the per-request KV handoff flow —
        # prefill-side probe serves, decode-side fetches, and the entry
        # counts moving through the content-addressed arena.
        self.role = registry.gauge(
            "tpu_engine_role",
            "Serving role of this replica (0 unified, 1 prefill, 2 "
            "decode — models/engine_handoff.py).  Set once at engine "
            "construction from --role",
        )
        self.handoff_serves = registry.counter(
            "tpu_engine_handoff_serves_total",
            "POST /v1/prefill probe streams served by outcome (ok / "
            "refused / rejected / error / client_gone / aborted); "
            "refused = fingerprint/role mismatch before any bytes, "
            "rejected = the probe submit was shed/invalid, aborted = "
            "the probe died mid-stream and the transfer was torn",
            ["outcome"],
        )
        self.handoff_fetches = registry.counter(
            "tpu_engine_handoff_fetches_total",
            "Decode-side prefill fetches (X-Handoff-Source pulls) by "
            "outcome (ok / unreachable / refused / corrupt / "
            "layout_mismatch / params_mismatch / disabled); anything "
            "but ok degrades to ordinary LOCAL prefill — existing "
            "arena contents are untouched",
            ["outcome"],
        )
        self.handoff_entries = registry.counter(
            "tpu_engine_handoff_entries_total",
            "Full KV prefix pages moved by the handoff machinery, by "
            "direction (published: prefill side into its own arena; "
            "served: streamed to a /v1/prefill caller; fetched: "
            "admitted into this decode replica's arena)",
            ["direction"],
        )
        self.handoff_refusals = registry.counter(
            "tpu_engine_handoff_refusals_total",
            "Decode-role /generate refusals (409 + X-Prefill-Needed): "
            "the prompt's full-page prefix was neither resident nor "
            "fetchable (no X-Handoff-Source locator) — the router "
            "should have routed the prefill first",
        )
        # Fleet KV fabric (models/engine_handoff.py fabric_digest +
        # the router's locator/replication plane, router/fabric.py).
        self.fabric_digest_roots = registry.gauge(
            "tpu_engine_fabric_digest_roots",
            "Distinct cumulative prefix roots advertised in the last "
            "built fabric bloom digest (trie-resident + host-arena); "
            "what the router's locator believes this replica can serve",
        )
        self.fabric_pulls = registry.counter(
            "tpu_engine_fabric_pulls_total",
            "Router-driven replication pulls (POST /debug/fabric/pull "
            "-> fetch_prefill from the named peer) by outcome (ok / "
            "error); error admits NOTHING and leaves the arena as-is",
            ["outcome"],
        )
        self.fabric_drops = registry.counter(
            "tpu_engine_fabric_drops_total",
            "Router-driven replica-eviction drops (POST "
            "/debug/fabric/drop): host-arena copies of a cold prefix "
            "released; live/retained device pages are never touched",
        )


@dataclasses.dataclass
class Request:
    """One generation request and, when finished, its output tokens.

    ``temperature`` 0 means greedy; > 0 samples that request's tokens at
    that temperature.  ``top_k``/``top_p`` restrict sampling to the k
    highest logits / the smallest nucleus with mass >= p (None = off;
    only meaningful with temperature > 0).  Slots with different sampler
    settings mix freely in one jitted step."""

    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # Multi-LoRA serving (cfg.lora_serve > 0): which stacked adapter this
    # request decodes through; None = base model.
    adapter: Optional[int] = None
    # Sparse logit bias: {token_id: added_logit} applied BEFORE greedy
    # argmax and sampling (OpenAI semantics: -100 bans, +100 forces);
    # capped at ServingEngine.MAX_BIAS entries.  Reported logprobs stay
    # UNBIASED (bias changes what gets picked, not what is scored).
    logit_bias: Optional[dict] = None
    # Stop sequences (token-id lists): generation ends when the output's
    # tail equals any of them; the matched suffix is EXCLUDED from
    # ``tokens`` (eos_id, by contrast, is included — the id itself is the
    # terminator, a stop sequence is a content sentinel).
    stop: Optional[list[list[int]]] = None
    # Latched by the engine when a stop sequence matched (the matched
    # suffix is truncated away, so the flag — not the tail — records it).
    stopped: bool = False
    # Record each emitted token's logprob under the unscaled model
    # distribution in ``token_logprobs`` (parallel to ``tokens``).
    # Sampler settings change what gets picked, never what is reported.
    logprobs: bool = False
    rid: int = -1
    # Overload-control contract (models/engine_overload.py): priority
    # class (0 high / 1 normal / 2 low — lower admits first, sheds
    # last), the tenant the request's token cost is charged to for fair
    # sharing, and an ABSOLUTE monotonic deadline (converted from the
    # wire's remaining-seconds form at submit; None = no deadline).
    # All three are inert when the engine runs without a controller.
    priority: int = 1
    tenant: str = ""
    deadline: Optional[float] = None
    # Set when overload control shed this request (a shed kind from
    # engine_overload.py: expired/infeasible/...); the HTTP layer maps
    # it to 504 (deadline sheds) or 503 + Retry-After (load sheds).
    shed: Optional[str] = None
    # End-to-end trace id: supplied by the client (X-Request-Id) or minted
    # at submit; echoed in responses/SSE events and stamped on every span
    # this request produces (utils/spans.py).
    trace_id: str = ""
    # Reserved root-span id (spans recorder): the queue/prefill/decode
    # child spans parent on it across threads; 0 when tracing is off.
    root_span: int = 0
    # Cross-process parent link (X-Trace-Context, utils/spans.py): the
    # 16-hex span id of the router attempt that carried this request,
    # plus which hop/attempt of the request's journey that dial was.
    # The request root span records them as attrs so
    # tools/trace_assemble.py can root this replica's tree under the
    # router's — "" means no upstream context (a direct client).
    trace_parent: str = ""
    trace_hop: int = 0
    trace_attempt: int = 0
    # monotonic submit time (engine-internal: queue-wait observation).
    submitted_at: float = 0.0
    # monotonic lifecycle stamps (0.0 until reached): slot assignment,
    # first emitted token (TTFT anchor), and finish.
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    # Peak per-token inter-token gap seen on this request (_observe_itl
    # maintains it).  For the short generations this engine serves the
    # per-request p99 ITL equals the max gap, so the SLO plane scores
    # this against the itl_p99 objective without a per-request
    # histogram; 0.0 until a second token lands.
    itl_peak_s: float = 0.0
    tokens: list[int] = dataclasses.field(default_factory=list)
    token_logprobs: list[float] = dataclasses.field(default_factory=list)
    done: bool = False
    # Set via ServingEngine.cancel() (client went away): a queued request
    # finishes immediately; an in-flight one is torn down at the next step
    # boundary, its slot and pages returned to the pool.
    cancelled: bool = False
