"""HTTP serving front-end over the continuous-batching engine, in PyTorch.

The port of the reference's ``models/http_server.py``: the same routes,
headers, SSE framing, status codes, ``Retry-After``/``X-Shed`` and
``?summary=1`` fields, so the router, canary prober, controller and
postmortem collector drive a PyTorch replica unchanged.  HTTP handler
threads call only ``engine.submit()``, ``cancel()`` and host-side
snapshots, never a CUDA tensor; ONE owner thread loops ``engine.step()``
and owns the stream, the CUDA graphs and the kernel builds, and request
completion is broadcast back to the waiting handlers.  The watchdog is
graced around every kernel build, first launch and graph capture.

The KV tiers (retention, the host arena), warm-restart snapshots
(``--snapshot-dir``: saved on fence, drain/SIGTERM and every
``--snapshot-interval`` seconds, loaded before serving), the peer and
fleet warm-ups and the split prefill/decode roles serve as the
reference's do; every read of a device page runs on the loop thread.
Traces are ``torch.profiler`` traces (Chrome-trace JSON).

On the CPU (``--device cpu --dtype float32``, tiny widths)::

    python -m k8s_device_plugin_tpu_torch.models.http_server --device cpu \
        --dtype float32 --hidden 64 --layers 2 --heads 4 --kv-heads 2 \
        --vocab 512 --page-size 4 --num-pages 64 --http-port 8000

API (token-level — the framework is tokenizer-agnostic, matching the
rest of the models/ stack which benchmarks on synthetic ids):

    POST /generate   {"prompt": [int, ...], "max_new_tokens": N,
                      "temperature": t?, "top_k": k?, "top_p": p?,
                      "stream": false?, "logprobs": false?,
                      "stop": [[int, ...], ...]?,
                      "logit_bias": {"token_id": added_logit, ...}?,
                      "n": 1?}
      -> 200 {"tokens": [int, ...], "rid": R}
      -> "n" > 1 (max 8; sampling configs — greedy copies are identical;
         not composable with "stream"): adds "choices": [{"tokens",
         "rid", "logprobs"?}, ...] — n independent samples over ONE
         shared prompt (prefix sharing dedupes the prompt pages).
      -> "stop": token-id sequences ending generation; a matched suffix
         is EXCLUDED from tokens (eos stays included — see engine docs).
      -> with "logprobs": true, adds "logprobs": [float, ...] — each
         emitted token's logprob under the UNSCALED model distribution
         (sampler settings change what gets picked, not what is
         reported); streaming events carry a "logprob" field.
         Unsupported on speculative engines (422).
      -> with "stream": true, 200 text/event-stream: one
         `data: {"token": t, "index": i, "rid": R}` event per generated
         token as the engine emits it, then `data: {"done": true,
         "tokens": [...], "rid": R}` — or, if generation exceeds the
         request timeout, a final `data: {"error": "generation timed
         out", "rid": R}` with NO done event.  `: ping` comment
         heartbeats flow while idle.  Disconnecting mid-stream cancels
         the request (engine.cancel) — its slot and pages return to the
         pool instead of decoding for nobody.
      -> Overload contract (docs/operations.md "Overload control"):
         ``X-Request-Deadline`` (REMAINING seconds; body ``deadline_s``),
         ``X-Request-Priority`` (high/normal/low or 0..2; body
         ``priority``), ``X-Tenant-Id`` (body ``tenant``).  A spent
         deadline answers 504 WITHOUT enqueueing; a request shed by the
         engine answers 504 (deadline sheds) or 503 + Retry-After +
         ``X-Shed`` (load sheds — back off, the replica is healthy);
         every 503 this server emits carries a Retry-After computed
         from the measured drain rate.
    GET /healthz     -> 200 "ok" while the engine loop is alive
    GET /metrics     -> Prometheus exposition (when a registry is wired)
    GET /debug/admission -> 200 JSON overload-control snapshot
         (models/engine_overload.py): AIMD limit + its inputs (queue
         wait EWMA, drain rate), shed ledger by kind, per-tenant
         debt/admissions — {"enabled": false} without a controller.
    GET /debug/state -> 200 JSON engine snapshot (slots, queue, page
         pool, speculation counters) plus the recent span ring
         (utils/spans.py) when the engine was built with a recorder —
         ids and lengths only, never token content.  Top-level
         ``queue_depth`` / ``active_slots`` / ``draining`` / ``fenced``
         plus the host-side overload signals ``queue_wait_ewma_s`` /
         ``drain_rate_rps`` ride along; ``?summary=1`` returns ONLY
         those (no engine lock, no spans) — the shape the router's
         per-second poll loop (and its migration/scale planner) reads.

    GET /debug/spans -> 200 JSON span ring alone ({"spans", "dropped",
         "capacity"}); ``?rid=<trace id>`` returns ONLY that request's
         tree — the trace assembler's live-mode surface
         (tools/trace_assemble.py).  A router dial carries
         ``X-Trace-Context`` (trace id, parent attempt span, hop and
         attempt index, W3C-traceparent-shaped); a valid context is
         adopted — its trace id wins over ``X-Request-Id`` and the
         request root span records the ``parent``/``hop``/``attempt``
         attrs that root this replica's tree under the router's.
    GET /debug/profile -> 200 JSON per-step profiler snapshot
         (models/engine_profiler.py): per-phase breakdown
         (schedule/prefill/dispatch/readback/sample/host_gap/spec_verify
         p50/p99 over the rolling window), batch occupancy, KV-page
         utilization, overlap hit/discard window counts, device-memory
         track.  Always on.
    GET /debug/snapshot -> 200 application/octet-stream: the live KV
         host arena (+ retained device pages) in the engine_snapshot
         wire format — the donor half of elastic peer warm-up.  The
         joiner's ``X-Snapshot-Layout``/``X-Snapshot-Params`` request
         headers are fingerprint-checked first (409 on mismatch, before
         any bytes land); ``Range`` requests answer 416 (whole-blob
         only); the response carries both fingerprints plus
         ``X-Snapshot-Entries``.  NOTE: KV rows ARE token-derived
         content — same trust domain as the snapshot volume.
    GET /debug/kvcache -> 200 JSON KV-cache tiering snapshot
         (models/engine_kvcache.py): retained-tier size, host-arena
         bytes/entries vs budget, hit/evict/restore counters, and
         preemption-resume accounting (restored vs recomputed).
    GET /debug/incidents -> 200 JSON anomaly-monitor snapshot
         (utils/anomaly.py): bounded incident list (cause metric,
         baseline, observed, z-score, attached flight-recorder window)
         plus per-metric baseline state.
    GET /debug/flight -> 200 JSON flight-recorder snapshot
         (utils/flight.py): the typed-event black box with drop
         accounting — same payload a `kill -USR2` dumps to
         TPU_PLUGIN_DUMP_DIR.

    Trace-ID contract: a request may send ``X-Request-Id``; a valid id
    (printable, <= 128 chars, no quotes/backslashes/newlines) is adopted,
    anything else gets a generated one.  The id comes back on the
    response's ``X-Request-Id`` header and ``trace_id`` JSON field, on
    every SSE event, and on every span the request records — one grep
    key from client log to engine telemetry.
    POST /debug/trace {"seconds": s?}   [opt-in: --debug-trace]
      -> 200 {"trace_dir": ...} after capturing a torch.profiler trace of
         the live serving loop (Chrome trace, Perfetto); 409 while one runs;
         404 unless the operator enabled the endpoint.
    POST /debug/profile/capture {"steps": n?, "timeout_s": t?}
         [opt-in: --debug-trace]
      -> 200 {"trace_dir", "steps_captured"} after capturing a
         torch.profiler trace spanning the next n engine steps (default 1)
         — the device-op view of exactly the step(s) the host-side
         profiler summarizes; 409 while any capture runs.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import urllib.parse

from ..utils import flight as flight_mod
from ..utils.metrics import MetricsRegistry, write_exposition
from ..utils.spans import (
    SpanRecorder,
    parse_trace_context,
    sanitize_trace_id,
)
from . import engine_handoff as handoff_mod
from . import engine_snapshot as snap_mod
from .engine import ServingEngine
from .engine_overload import SHED_EXPIRED, SHED_INFEASIBLE, ShedError
from .engine_watchdog import ChipHealthFeed, StepWatchdog, visible_chip_paths

log = logging.getLogger("tpu.serving")


class EngineServer:
    """Threaded HTTP server owning a ServingEngine and its step loop.

    One daemon thread runs the engine (the ONLY thread that calls
    ``step()``); ThreadingHTTPServer handler threads submit and then wait
    on a condition the loop notifies after every step.  ``port=0`` picks
    a free port (tests); ``.port`` reports it.
    """

    def __init__(
        self,
        engine: ServingEngine,
        host: str = "0.0.0.0",
        port: int = 8000,
        registry: Optional[MetricsRegistry] = None,
        request_timeout_s: float = 600.0,
        enable_trace: bool = False,
        enable_admin: bool = True,
        watchdog=None,
        chip_health: Optional[ChipHealthFeed] = None,
        snapshot_dir: str = "",
        snapshot_interval_s: float = 60.0,
        handoff_timeout_s: float = 30.0,
    ):
        self.engine = engine
        # Disaggregated prefill/decode (models/engine_handoff.py): the
        # per-dial budget a decode-role replica spends pulling a prefix
        # from its X-Handoff-Source before degrading to local prefill,
        # and the per-probe budget /v1/prefill waits for chunk progress.
        self._handoff_timeout = float(handoff_timeout_s)
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._loop_alive = False
        # Process birth (monotonic): ?summary=1 exports the age as
        # ``uptime_s`` — the fleet controller's replica-minutes ledger
        # and scale-down tie-breaker read it off the router's poll.
        self._started = time.monotonic()
        self._timeout = request_timeout_s
        self._trace_lock = threading.Lock()
        self._enable_trace = enable_trace
        self._enable_admin = enable_admin
        # Graceful drain (SIGTERM path): admission stops the moment
        # `_draining` is set; the loop keeps stepping until the engine
        # runs dry (or the grace window expires), then `drained` fires
        # and the loop stops — a pod delete finishes in-flight streams
        # instead of cutting them mid-token.
        self._draining = threading.Event()
        self.drained = threading.Event()
        # Replica self-fencing: a fenced replica stops
        # admitting (503 + Retry-After), reads fenced on /healthz and
        # the router's ?summary=1 poll, and CUTS its in-flight streams
        # (no done event) so the router's zero-drop failover resubmits
        # them elsewhere — a sick replica fails out of rotation instead
        # of serving garbage or wedging clients.  Three triggers share
        # this one path: the hung-step watchdog, the chip-health feed,
        # and the POST /debug/fence operator endpoint.
        self._fence = threading.Event()
        self._fence_lock = threading.Lock()
        # Crash-safe warm restart (models/engine_snapshot.py): the KV
        # host arena persists here on fence/drain/SIGTERM and on the
        # periodic timer, and rehydrates via load_snapshot() at startup.
        self._snapshot_dir = snapshot_dir
        self._snapshot_interval_s = float(snapshot_interval_s)
        self._snap_lock = threading.Lock()
        self._snapshot_thread: Optional[threading.Thread] = None
        self.last_snapshot_save: Optional[dict] = None
        self.last_snapshot_load: Optional[dict] = None
        self.fence_reason: Optional[str] = None
        self.fence_source: Optional[str] = None
        self.fence_detail = None
        self.fence_at = 0.0
        self.fences = 0
        # Hung-step watchdog: accept a preconfigured StepWatchdog (tests
        # tune thresholds / inject clocks) or True for defaults; either
        # way the fence callback binds HERE and the engine feeds it.
        self.watchdog: Optional[StepWatchdog] = None
        if watchdog:
            wd = (
                watchdog
                if isinstance(watchdog, StepWatchdog)
                else StepWatchdog(self._watchdog_fence)
            )
            wd.on_fence = self._watchdog_fence
            if engine.metrics and wd._observe_deadline is None:
                wd._observe_deadline = engine.metrics.watchdog_deadline.set
            self.watchdog = wd
            engine.watchdog = wd
        # Chip-health feed: fence when a chip in this replica's mesh
        # goes Unhealthy/unplugged (plugin daemon surface, devfs
        # fallback).  Caller-constructed so tests inject probes.
        self.chip_health = chip_health
        if chip_health is not None:
            chip_health.on_unhealthy = self._chip_fence
            if chip_health.flight is None:
                chip_health.flight = engine.flight
        if engine.metrics:
            engine.metrics.fenced.set(0)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                if path in ("/debug/fence", "/debug/unfence"):
                    if not server._enable_admin:
                        # Operator knob (--admin-endpoints 0): fencing
                        # cancels in-flight work, and the server binds
                        # 0.0.0.0 — an untrusted network gets a 404.
                        self.send_error(404)
                        return
                    if path == "/debug/fence":
                        try:
                            length = int(self.headers.get("Content-Length", "0"))
                            body = json.loads(self.rfile.read(length) or b"{}")
                            reason = str(body.get("reason") or "operator")
                        except (TypeError, ValueError) as e:
                            self._reply(400, {"error": f"bad request: {e}"})
                            return
                        changed = server.begin_fence(reason, source="operator")
                        self._reply(
                            200,
                            {
                                "fenced": True,
                                "reason": server.fence_reason,
                                "changed": changed,
                            },
                        )
                    else:
                        changed = server.unfence()
                        self._reply(200, {"fenced": False, "changed": changed})
                    return
                if path == "/debug/role":
                    # Runtime role flip (fleet controller rebalancing):
                    # same trust domain and gate as fence —
                    # a flip moves this replica on/off the router's
                    # /generate ring at its next summary poll.
                    if not server._enable_admin:
                        self.send_error(404)
                        return
                    try:
                        length = int(self.headers.get("Content-Length", "0"))
                        body = json.loads(self.rfile.read(length) or b"{}")
                        role = str(body["role"])
                    except (KeyError, TypeError, ValueError) as e:
                        self._reply(400, {"error": f"bad request: {e}"})
                        return
                    try:
                        changed = server.set_role(role)
                    except ValueError as e:
                        self._reply(400, {"error": str(e)})
                        return
                    self._reply(
                        200,
                        {"role": server.engine.role, "changed": changed},
                    )
                    return
                if path in ("/debug/trace", "/debug/profile/capture"):
                    if not server._enable_trace:
                        # Off unless the operator opted in (--debug-trace):
                        # the server binds 0.0.0.0 by default, and an open
                        # profiler endpoint is a latency/disk DoS lever.
                        self.send_error(404)
                        return
                    if path == "/debug/trace":
                        self._trace_capture()
                    else:
                        self._step_capture()
                    return
                if path == handoff_mod.PREFILL_ROUTE:
                    # Disaggregated prefill (models/engine_handoff.py):
                    # run (or serve) this prompt's full-page KV prefix
                    # and stream the entries in the snapshot wire
                    # format as chunks finish.
                    self._serve_prefill()
                    return
                if path in ("/debug/fabric/pull", "/debug/fabric/drop"):
                    # Fleet-fabric replication plane (router/fabric.py
                    # drives these on the poll cadence): pull = copy a
                    # hot prefix from the named owner through the
                    # parse-before-admit verifier; drop = release this
                    # replica's host-arena copies of a cold one.  Same
                    # trust domain and gate as the other mutating admin
                    # endpoints.
                    if not server._enable_admin:
                        self.send_error(404)
                        return
                    try:
                        length = int(
                            self.headers.get("Content-Length", "0")
                        )
                        body = json.loads(self.rfile.read(length) or b"{}")
                        fab_prompt = [int(t) for t in body["prompt"]]
                        fab_adapter = (
                            int(body["adapter"])
                            if body.get("adapter") is not None
                            else None
                        )
                        if path.endswith("/pull"):
                            fab_source = str(body["source"])
                    except (KeyError, TypeError, ValueError) as e:
                        self._reply(400, {"error": f"bad request: {e}"})
                        return
                    if path.endswith("/pull"):
                        result = server.engine.fabric_pull(
                            fab_source,
                            fab_prompt,
                            adapter=fab_adapter,
                            timeout_s=server._handoff_timeout,
                        )
                        self._reply(200 if result.get("ok") else 502, result)
                    else:
                        self._reply(
                            200,
                            server.engine.fabric_drop(
                                fab_prompt, adapter=fab_adapter
                            ),
                        )
                    return
                if path != "/generate":
                    self.send_error(404)
                    return
                if server.engine.role == "prefill":
                    # A prefill-role replica emits no decode tokens:
                    # the typed 409 tells a misrouted caller (the
                    # router excludes prefill replicas from /generate
                    # candidates) which surface this replica serves.
                    self._reply(
                        409,
                        {
                            "error": "replica role is prefill; it serves "
                            "POST /v1/prefill, not /generate",
                            "role": "prefill",
                        },
                    )
                    return
                # Trace-ID contract: a valid client X-Request-Id is
                # adopted verbatim; anything else (including no header)
                # gets a generated id.  Either way the SAME id is echoed
                # on the response header, the JSON body, every SSE
                # event, and every span the request produces.  A router
                # dial additionally carries X-Trace-Context (hop
                # context, utils/spans.py): its trace id wins, and its
                # attempt span id roots this replica's span tree under
                # the router's — the fleet-timeline link.  A malformed
                # context simply doesn't link (fall back to the plain
                # X-Request-Id contract); it can never reject a request.
                hop_ctx = parse_trace_context(
                    self.headers.get("X-Trace-Context")
                )
                if hop_ctx is not None:
                    trace_id = hop_ctx.trace_id
                else:
                    trace_id = sanitize_trace_id(
                        self.headers.get("X-Request-Id")
                    )
                if server._fence.is_set():
                    # Fenced: this replica may be decoding on a sick
                    # chip or wedged mid-step — a plain 503 (no X-Shed)
                    # tells the router to take it out of rotation and
                    # retry the request elsewhere.
                    self._reply(
                        503,
                        {
                            "error": "replica is fenced",
                            "reason": server.fence_reason,
                            "trace_id": trace_id,
                        },
                        trace_id,
                        retry_after=server._retry_after(),
                    )
                    return
                if server._draining.is_set():
                    # Draining (SIGTERM): no new admissions; in-flight
                    # requests keep decoding to completion.  503 +
                    # Retry-After is the signal a router/load-balancer
                    # needs to fail the replica out.
                    self._reply(
                        503,
                        {"error": "server is draining", "trace_id": trace_id},
                        trace_id,
                        retry_after=server._retry_after(),
                    )
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    prompt = body["prompt"]
                    max_new = int(body.get("max_new_tokens", 16))
                    kwargs = {}
                    if "temperature" in body:
                        kwargs["temperature"] = float(body["temperature"])
                    if "top_k" in body:
                        kwargs["top_k"] = int(body["top_k"])
                    if "top_p" in body:
                        kwargs["top_p"] = float(body["top_p"])
                    if "adapter" in body and body["adapter"] is not None:
                        # Multi-LoRA serving: pick a stacked adapter by
                        # index (engines built with cfg.lora_serve).
                        kwargs["adapter"] = int(body["adapter"])
                    if body.get("logprobs"):
                        kwargs["logprobs"] = True
                    if body.get("stop") is not None:
                        kwargs["stop"] = body["stop"]
                    n = int(body.get("n", 1) or 0)  # null -> 0 -> 422 below
                    if body.get("logit_bias"):  # {} is a no-op, not a 422
                        # JSON object keys are strings; the engine wants
                        # int token ids.
                        kwargs["logit_bias"] = {
                            int(t): float(v)
                            for t, v in body["logit_bias"].items()
                        }
                    # Overload-control contract (docs/operations.md
                    # "Overload control"): the router stamps headers —
                    # X-Request-Deadline (REMAINING seconds, re-computed
                    # per hop), X-Request-Priority (high/normal/low or
                    # 0..2), X-Tenant-Id — and direct clients may use
                    # the equivalent body fields.  Headers win: the
                    # router already decremented the deadline.
                    raw_deadline = self.headers.get("X-Request-Deadline")
                    if raw_deadline is None:
                        raw_deadline = body.get("deadline_s")
                    deadline_s = (
                        None if raw_deadline is None else float(raw_deadline)
                    )
                    raw_priority = self.headers.get("X-Request-Priority")
                    if raw_priority is None:
                        raw_priority = body.get("priority")
                    if raw_priority is not None:
                        kwargs["priority"] = raw_priority
                    tenant = self.headers.get("X-Tenant-Id")
                    if tenant is None:
                        tenant = body.get("tenant")
                    if tenant is not None:
                        kwargs["tenant"] = str(tenant)
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"}, trace_id)
                    return
                if deadline_s is not None and deadline_s <= 0:
                    # Fail fast, never enqueue: the budget is already
                    # spent, and admitting would burn a slot producing
                    # tokens the caller's own deadline forbids it to use.
                    # Still a client-visible failure — score the
                    # availability verdict + usage row.
                    server.engine.observe_submit_shed(tenant)
                    self._reply(
                        504,
                        {
                            "error": "deadline expired before admission",
                            "shed": SHED_EXPIRED,
                            "trace_id": trace_id,
                        },
                        trace_id,
                    )
                    return
                if deadline_s is not None:
                    kwargs["deadline_s"] = deadline_s
                stream = bool(body.get("stream", False))
                if not 1 <= n <= 8:
                    self._reply(
                        422, {"error": f"n must be in [1, 8], got {n}"}, trace_id
                    )
                    return
                if n > 1 and stream:
                    self._reply(
                        422,
                        {"error": "n > 1 does not compose with stream"},
                        trace_id,
                    )
                    return
                # Handoff admission gate (models/engine_handoff.py): a
                # prompt whose full-page prefix is not resident is
                # PULLED from the router's X-Handoff-Source locator
                # before submit (the fetch rides this handler thread —
                # the step loop keeps decoding others), refused with a
                # typed 409 + X-Prefill-Needed when there is no
                # locator, and degraded to ordinary LOCAL prefill when
                # the fetch fails (prefill replica died mid-transfer,
                # torn stream, refusal) — never a dropped request.
                # Decode-role replicas always run the gate; unified
                # replicas run it only when the router's FABRIC locator
                # stamped a concrete owner (any-peer pull — resident-
                # only on the serving side, so a stale locator costs
                # one refused dial, then local prefill).
                handoff_fetch = None
                fabric_source = self.headers.get(
                    handoff_mod.HANDOFF_SOURCE_HEADER
                )
                fabric_pull = bool(
                    self.headers.get(
                        handoff_mod.FABRIC_RESIDENT_ONLY_HEADER
                    )
                )
                if server.engine.role == "decode" or (
                    server.engine.role == "unified"
                    and fabric_pull
                    and fabric_source
                    and fabric_source != handoff_mod.HANDOFF_LOCAL
                ):
                    try:
                        clean_prompt = [int(t) for t in prompt]
                    except (TypeError, ValueError) as e:
                        self._reply(
                            400, {"error": f"bad prompt: {e}"}, trace_id
                        )
                        return
                    adapter = kwargs.get("adapter")
                    covered, n_full = server.engine.handoff_coverage(
                        clean_prompt, adapter
                    )
                    source = None
                    if covered < n_full:
                        source = self.headers.get(
                            handoff_mod.HANDOFF_SOURCE_HEADER
                        )
                        if source == handoff_mod.HANDOFF_LOCAL:
                            # The router says there is nothing to pull
                            # from (short prompt / prefill pool down):
                            # run the ordinary local prefill.
                            source = None
                        elif not source:
                            eng = server.engine
                            with eng._lock:
                                eng.handoff_refusals += 1
                            if eng.metrics:
                                eng.metrics.handoff_refusals.inc()
                            eng.flight.record(
                                "handoff.refused",
                                trace_id=trace_id,
                                prompt_tokens=len(clean_prompt),
                                missing_pages=n_full - covered,
                            )
                            self._reply(
                                409,
                                {
                                    "error": "prefix not resident on this "
                                    "decode replica and no "
                                    "X-Handoff-Source locator was sent",
                                    "missing_pages": n_full - covered,
                                    "trace_id": trace_id,
                                },
                                trace_id,
                                prefill_needed=str(n_full - covered),
                            )
                            return
                    pull_gate = None  # single-flight claim (fabric)
                    if covered < n_full and source and fabric_pull:
                        # Stampede collapse: concurrent requests all
                        # missing the same source-resident prefix (the
                        # fleet-wide shared system prompt arriving on
                        # every session at once) must not each dial the
                        # owner.  The first handler claims the per-
                        # source gate and pulls; the rest wait on it,
                        # re-read their coverage, and ride whatever the
                        # winner admitted — falling through to ordinary
                        # local prefill for anything still missing (a
                        # failed pull degrades every waiter the same
                        # way it degrades the winner).
                        eng = server.engine
                        waiter = None
                        with eng._lock:
                            waiter = eng._handoff_pull_waits.get(source)
                            if waiter is None:
                                pull_gate = threading.Event()
                                eng._handoff_pull_waits[source] = pull_gate
                        if waiter is not None:
                            waiter.wait(server._handoff_timeout)
                            covered, n_full = eng.handoff_coverage(
                                clean_prompt, adapter
                            )
                            source = None
                    if covered < n_full and source:
                        t_fetch = time.monotonic()
                        fetch_ctx = None
                        if hop_ctx is not None:
                            # One more hop: the prefill replica's serve
                            # span roots under this fetch in the
                            # assembled fleet timeline.
                            from ..utils.spans import format_trace_context

                            fetch_span = (
                                server.engine.spans.reserve_id()
                                if server.engine.spans
                                else 0
                            )
                            fetch_ctx = format_trace_context(
                                trace_id, fetch_span, hop_ctx.hop + 1, 0
                            )
                        else:
                            fetch_span = (
                                server.engine.spans.reserve_id()
                                if server.engine.spans
                                else 0
                            )
                        try:
                            handoff_fetch = handoff_mod.fetch_prefill(
                                server.engine,
                                source,
                                clean_prompt,
                                adapter=adapter,
                                timeout_s=min(
                                    server._handoff_timeout,
                                    deadline_s
                                    if deadline_s is not None
                                    else server._handoff_timeout,
                                ),
                                trace_context=fetch_ctx,
                                resident_only=fabric_pull,
                            )
                        finally:
                            if pull_gate is not None:
                                with server.engine._lock:
                                    server.engine._handoff_pull_waits.pop(
                                        source, None
                                    )
                                pull_gate.set()
                        handoff_fetch["span_id"] = fetch_span
                        handoff_fetch["t0"] = t_fetch
                try:
                    # n samples = n engine requests over ONE shared prompt:
                    # the prefix trie dedupes the prompt pages, so extra
                    # choices cost generation pages only (and each slot
                    # draws its own sampling rows — independent samples).
                    # All n choices share the request's trace id (and
                    # upstream hop context, when a router sent one).
                    if hop_ctx is not None:
                        kwargs["trace_parent"] = hop_ctx.parent_span
                        kwargs["trace_hop"] = hop_ctx.hop
                        kwargs["trace_attempt"] = hop_ctx.attempt
                    reqs = [
                        server.engine.submit(
                            prompt, max_new, trace_id=trace_id, **kwargs
                        )
                        for _ in range(n)
                    ]
                except ShedError as e:
                    # Overload shed at the admission door: deadline
                    # sheds are 504 (the client's budget is the
                    # boundary); load sheds are 503 with the honest
                    # Retry-After the controller computed from the
                    # measured drain rate.  X-Shed tells the router this
                    # is overload, not drain — don't eject the replica.
                    self._shed_reply(e.kind, str(e), e.retry_after_s, trace_id)
                    return
                except ValueError as e:  # validation: capacity, sampler args
                    self._reply(422, {"error": str(e)}, trace_id)
                    return
                except TypeError as e:  # e.g. non-iterable / nested prompt
                    self._reply(400, {"error": f"bad prompt: {e}"}, trace_id)
                    return
                req = reqs[0]
                if handoff_fetch is not None and server.engine.spans:
                    # The fetch leg as a span under the request root —
                    # one request, ONE timeline spanning both replicas
                    # (the prefill side's handoff.serve span roots
                    # under this id via the fetch's X-Trace-Context).
                    server.engine.spans.record_span(
                        "handoff.fetch",
                        trace_id,
                        start_monotonic=handoff_fetch["t0"],
                        span_id=handoff_fetch["span_id"] or None,
                        parent_id=req.root_span,
                        attrs={
                            "rid": req.rid,
                            "source": handoff_fetch.get("source"),
                            "ok": bool(handoff_fetch.get("ok")),
                            "restored": handoff_fetch.get("restored", 0),
                        },
                    )
                if stream:
                    self._stream_reply(req, deadline_s=deadline_s)
                    return
                # The wait never outlives the client's own deadline
                # (plus a small grace so the engine's expiry sweep —
                # which sheds AT the deadline and answers with the typed
                # shed verdict — wins the race against this generic
                # timeout): a request with 2s of budget answers in ~2s,
                # not after the server-wide timeout.
                wait_timeout = server._timeout
                if deadline_s is not None:
                    wait_timeout = min(wait_timeout, deadline_s + 0.5)
                with server._cond:
                    server._cond.notify_all()  # wake an idle loop
                    finished = server._cond.wait_for(
                        lambda: all(r.done for r in reqs)
                        or server._fence.is_set(),
                        timeout=wait_timeout,
                    )
                if server._fence.is_set() and not all(r.done for r in reqs):
                    # Fenced mid-wait (hung step / sick chip): free the
                    # engine side and answer the 503 the router's retry
                    # path turns into a dispatch on a healthy replica.
                    for r in reqs:
                        server.engine.cancel(r)
                    with server._cond:
                        server._cond.notify_all()
                    self._reply(
                        503,
                        {
                            "error": "replica fenced mid-request",
                            "reason": server.fence_reason,
                            "trace_id": trace_id,
                        },
                        trace_id,
                        retry_after=server._retry_after(),
                    )
                    return
                if not finished:
                    # Stop burning chip time on a response nobody reads:
                    # cancel NOW (slot and pages free at the next step
                    # boundary) and wake the loop so the teardown is
                    # immediate, not lazily discovered.
                    for r in reqs:
                        server.engine.cancel(r)
                    with server._cond:
                        server._cond.notify_all()
                    self._reply(
                        504,
                        {"error": "generation timed out", "rid": req.rid},
                        trace_id,
                    )
                    return
                shed = next((r.shed for r in reqs if r.shed), None)
                if shed is not None:
                    # Shed while queued (expired) or preempted from a
                    # slot (infeasible) by the engine's overload sweep.
                    retry_after = 0.0
                    if server.engine.overload is not None:
                        retry_after = server.engine.overload.retry_after_s(
                            len(server.engine.queue)
                        )
                    self._shed_reply(
                        shed, f"request shed: {shed}", retry_after, trace_id,
                        rid=req.rid,
                    )
                    return
                out = {"tokens": req.tokens, "rid": req.rid,
                       "trace_id": trace_id}
                if req.logprobs:
                    out["logprobs"] = req.token_logprobs
                if n > 1:
                    out["choices"] = [
                        {
                            "tokens": r.tokens,
                            **(
                                {"logprobs": r.token_logprobs}
                                if r.logprobs
                                else {}
                            ),
                            "rid": r.rid,
                        }
                        for r in reqs
                    ]
                self._reply(200, out, trace_id)

            def _trace_capture(self) -> None:
                """POST /debug/trace {"seconds": s?}: capture a
                torch.profiler trace of the LIVE serving loop (host ops and
                the card's kernels; a Chrome trace Perfetto loads) for s
                seconds and reply with the server-chosen trace dir.  The
                capture rides this handler thread while the owner loop
                keeps stepping, which is the point; one capture at a time
                (409 while busy), seconds clamped to (0, 30]."""
                import math
                import tempfile

                from ..utils import tracing

                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise TypeError(f"body must be an object, got {body!r}")
                    seconds = float(body.get("seconds", 2.0))
                    if not math.isfinite(seconds):
                        raise ValueError(f"seconds must be finite, got {seconds}")
                    seconds = min(max(seconds, 0.05), 30.0)
                except (TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if not server._trace_lock.acquire(blocking=False):
                    self._reply(409, {"error": "a trace capture is already running"})
                    return
                # Lock first, THEN mkdtemp: a 409 poll loop must not mint
                # an orphan dir per attempt.  The dir is SERVER-chosen —
                # clients must not direct profiler writes at arbitrary
                # paths.
                tdir = tempfile.mkdtemp(prefix="tpu-serving-trace-")
                try:
                    with tracing.trace(tdir):
                        time.sleep(seconds)
                except Exception as e:  # profiler state is global: report, not crash
                    self._reply(500, {"error": f"trace failed: {e}"})
                    return
                finally:
                    server._trace_lock.release()
                self._reply(200, {"trace_dir": tdir, "seconds": seconds})

            def _step_capture(self) -> None:
                """POST /debug/profile/capture {"steps": n?, "timeout_s"?}:
                capture a torch.profiler trace spanning the next n engine
                steps — the device-op (Chrome trace, Perfetto) view of exactly
                what /debug/profile summarizes host-side.  Step
                completion is watched via the profiler's step counter on
                the server condition; an idle engine simply times out
                with steps_captured 0 (capture while traffic flows).
                Shares the one-capture-at-a-time lock with /debug/trace."""
                import tempfile

                from ..utils import tracing

                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise TypeError(f"body must be an object, got {body!r}")
                    steps = int(body.get("steps", 1))
                    if not 1 <= steps <= 64:
                        raise ValueError(f"steps must be in [1, 64], got {steps}")
                    timeout_s = min(max(float(body.get("timeout_s", 10.0)), 0.1), 60.0)
                except (TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if not server._trace_lock.acquire(blocking=False):
                    self._reply(409, {"error": "a trace capture is already running"})
                    return
                tdir = tempfile.mkdtemp(prefix="tpu-step-trace-")
                profiler = server.engine.profiler
                start = profiler.steps
                target = start + steps
                deadline = time.monotonic() + timeout_s
                try:
                    with tracing.trace(tdir):
                        while (
                            profiler.steps < target
                            and time.monotonic() < deadline
                        ):
                            with server._cond:
                                server._cond.wait(timeout=0.05)
                except Exception as e:  # profiler state is global: report
                    self._reply(500, {"error": f"trace failed: {e}"})
                    return
                finally:
                    server._trace_lock.release()
                self._reply(
                    200,
                    {
                        "trace_dir": tdir,
                        "steps_requested": steps,
                        "steps_captured": min(profiler.steps - start, steps),
                    },
                )

            def _shed_reply(
                self,
                kind: str,
                message: str,
                retry_after_s: float,
                trace_id,
                rid=None,
            ) -> None:
                """Answer one overload shed: 504 for deadline sheds
                (expired/infeasible — retrying cannot help, the client's
                budget is gone), 503 + Retry-After + X-Shed for load
                sheds (come back when the queue has drained)."""
                body = {"error": message, "shed": kind, "trace_id": trace_id}
                if rid is not None:
                    body["rid"] = rid
                if kind in (SHED_EXPIRED, SHED_INFEASIBLE):
                    self._reply(504, body, trace_id)
                    return
                self._reply(
                    503,
                    body,
                    trace_id,
                    retry_after=f"{max(retry_after_s, 1.0):g}",
                    shed=kind,
                )

            def _stream_reply(self, req, deadline_s=None) -> None:
                """Server-sent events: one ``data:`` event per generated
                token as the engine emits it, then a final ``done`` event
                with the full sequence.  A client that disconnects
                mid-stream cancels the request (engine.cancel) so its
                slot and pages return to the pool immediately."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if req.trace_id:
                    self.send_header("X-Request-Id", req.trace_id)
                self.end_headers()
                timeout = server._timeout
                if deadline_s is not None:
                    # The stream's own watchdog never outlives the
                    # client's deadline (the engine's overload sweep
                    # normally sheds first and ends the stream with a
                    # typed error event).
                    timeout = min(timeout, deadline_s)
                deadline = time.monotonic() + timeout
                sent = 0
                # Stop sequences truncate the matched suffix at the END:
                # the last longest_stop tokens are provisional.  A lag of
                # longest_stop-1 would cover only post-truncation states;
                # the engine appends the match-completing token and runs
                # _hit_stop a few statements later, so a stream thread
                # waking in that window can see the FULL match still
                # present — hold back one extra token so even that
                # pre-truncation snapshot never leaks a matched-suffix
                # token the final list will exclude.  Without stop, lag 0.
                lag = max(len(s) for s in req.stop) if req.stop else 0
                try:
                    while True:
                        with server._cond:
                            server._cond.notify_all()  # wake an idle loop
                            server._cond.wait_for(
                                lambda: req.done
                                or len(req.tokens) - lag > sent
                                or server._fence.is_set(),
                                timeout=min(1.0, server._timeout),
                            )
                            toks = list(req.tokens)
                            done = req.done
                        if server._fence.is_set():
                            # Fenced: CUT the stream — no done, no error
                            # event.  The fence's cancel sweep races this
                            # wake, so a done observed here may be the
                            # cancel's truncated teardown; emitting it
                            # would hand the client a short stream that
                            # LOOKS complete.  A cut stream is the shape
                            # the router's zero-drop failover resubmits.
                            server.engine.cancel(req)
                            return
                        # Emit up to the lag horizon mid-flight; once done,
                        # everything left (req.tokens is already
                        # stop-truncated, so the held-back suffix that
                        # matched simply never streams).
                        limit = len(toks) if done else max(0, len(toks) - lag)
                        if not done and sent == limit:
                            # Idle (queued / mid-prefill / slow step / all
                            # emittable tokens inside the hold-back): an
                            # SSE comment heartbeat so a vanished client
                            # surfaces as a broken pipe HERE, not after
                            # the full request timeout with the request
                            # decoding for nobody.
                            self.wfile.write(b": ping\n\n")
                            self.wfile.flush()
                        while sent < limit:
                            ev = {"token": toks[sent], "index": sent,
                                  "rid": req.rid, "trace_id": req.trace_id}
                            if req.logprobs and sent < len(req.token_logprobs):
                                ev["logprob"] = req.token_logprobs[sent]
                            self._event(ev)
                            sent += 1
                        if done:
                            if req.shed:
                                # Shed mid-stream by the overload sweep
                                # (deadline expired / infeasible): a
                                # typed error event, never a fake done.
                                self._event(
                                    {"error": f"request shed: {req.shed}",
                                     "shed": req.shed,
                                     "rid": req.rid,
                                     "trace_id": req.trace_id}
                                )
                                return
                            fin = {"done": True, "tokens": toks,
                                   "rid": req.rid, "trace_id": req.trace_id}
                            if req.logprobs:
                                fin["logprobs"] = req.token_logprobs
                            self._event(fin)
                            return
                        if time.monotonic() > deadline:
                            server.engine.cancel(req)
                            self._event(
                                {"error": "generation timed out",
                                 "rid": req.rid, "trace_id": req.trace_id}
                            )
                            return
                except OSError:  # broken pipe & friends: client vanished
                    server.engine.cancel(req)

            def _event(self, obj: dict) -> None:
                self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                self.wfile.flush()

            def _serve_snapshot(self) -> None:
                """GET /debug/snapshot: stream the arena (+ retained
                device pages) in the engine_snapshot wire format — the
                donor half of peer warm-up.  A joiner's layout/params
                fingerprint headers are checked FIRST (409 before any
                bytes land), resumable fetches are refused (416 — the
                blob is verified whole or not at all), and the
                ``engine.snapshot.serve`` failpoint injects refusal
                (``error``), a stalled transfer (``hang``), or a stream
                torn mid-send (``truncate`` — the donor-died shape the
                joiner's degradation contract is scored against).  A
                fence skips device-page reads exactly like a fence-path
                save (rows off a sick chip are not worth shipping)."""
                from ..utils import failpoints

                eng = server.engine
                metrics = eng.metrics
                try:
                    hit = failpoints.fire("engine.snapshot.serve")
                except failpoints.FailpointError as e:
                    if metrics:
                        metrics.snapshot_serves.inc(outcome="error")
                    self._reply(503, {"error": f"snapshot unavailable: {e}"})
                    return
                if self.headers.get("Range"):
                    # Whole-blob only: a resumed partial fetch would
                    # splice bytes from two different arena states —
                    # the CRCs would catch it, but refusing up front is
                    # cheaper than shipping a transfer doomed to parse
                    # as corrupt.
                    self._reply(
                        416,
                        {"error": "resumable fetch refused: snapshot "
                                  "transfers are whole-blob only"},
                    )
                    return
                with eng._lock:
                    layout = snap_mod.snapshot_layout(eng)
                fingerprint = eng.params_fingerprint
                try:
                    # Device pages are read on the owner thread.
                    entries = snap_mod.collect_entries(
                        eng, include_device=not server._fence.is_set()
                    )
                except TimeoutError as e:
                    if metrics:
                        metrics.snapshot_serves.inc(outcome="error")
                    self._reply(503, {"error": f"snapshot unavailable: {e}"})
                    return
                layout_fp = snap_mod.layout_fingerprint(layout)
                want_layout = self.headers.get(snap_mod.LAYOUT_HEADER)
                want_params = self.headers.get(snap_mod.PARAMS_HEADER)
                if (want_layout and want_layout != layout_fp) or (
                    want_params and want_params != fingerprint
                ):
                    # Incompatible peer: refuse BEFORE any bytes land.
                    if metrics:
                        metrics.snapshot_serves.inc(outcome="refused")
                    eng.flight.record(
                        "engine.snapshot.serve_refused",
                        peer=self.client_address[0],
                        layout_ok=(not want_layout
                                   or want_layout == layout_fp),
                        params_ok=(not want_params
                                   or want_params == fingerprint),
                    )
                    self._reply(
                        409,
                        {
                            "error": "snapshot layout/params mismatch",
                            "layout": layout_fp,
                            "params_fingerprint": fingerprint,
                        },
                    )
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header(snap_mod.LAYOUT_HEADER, layout_fp)
                self.send_header(snap_mod.PARAMS_HEADER, fingerprint)
                self.send_header(snap_mod.ENTRIES_HEADER, str(len(entries)))
                # No Content-Length: close-delimited like the SSE path.
                # The format is self-delimiting (entry count in the
                # header, per-entry CRCs), so the joiner never needs the
                # transport to tell it whether the stream was whole.
                self.end_headers()
                chunks = snap_mod.encode_snapshot(
                    layout, fingerprint, entries
                )
                if hit is not None and hit.mode == "truncate":
                    # Tear the stream mid-send: the donor-died-
                    # mid-transfer byte shape, injected without killing
                    # the process.
                    data = b"".join(chunks)
                    frac = float(hit.arg) if hit.arg else 0.5
                    chunks = iter([data[: int(len(data) * frac)]])
                sent = 0
                outcome = "ok"
                try:
                    for chunk in chunks:
                        self.wfile.write(chunk)
                        sent += len(chunk)
                    self.wfile.flush()
                except OSError:
                    outcome = "client_gone"  # joiner vanished mid-pull
                if metrics:
                    metrics.snapshot_serves.inc(outcome=outcome)
                    metrics.snapshot_served_bytes.inc(sent)
                eng.flight.record(
                    "engine.snapshot.served",
                    peer=self.client_address[0],
                    entries=len(entries),
                    bytes=sent,
                    outcome=outcome,
                    torn=bool(hit is not None and hit.mode == "truncate"),
                )

            def _serve_prefill(self) -> None:
                """POST /v1/prefill {"prompt": [...], "adapter": a?}:
                the prefill half of disaggregated serving
                (models/engine_handoff.py).  A resident prefix streams
                straight from the KV tiers; anything else runs a
                prefill probe (max_new=1 — no decode step) and streams
                each full page's entry THE MOMENT its chunk's K/V
                exist, in the exact snapshot wire format (preamble with
                the known entry count, then per-CRC entries), so the
                decode side's transfer overlaps this side's compute.
                Fingerprint headers refuse with 409 before any compute
                or bytes; decode-role replicas (and any request
                carrying X-Fabric-Resident-Only — the fabric any-peer
                pull) serve RESIDENT pages only: full coverage streams
                everything, partial coverage streams just the leading
                resident pages (the shared-system-prompt pull), and
                ZERO coverage answers 409, so a stale locator or a
                bloom false positive degrades the puller to local
                prefill instead of moving the prefill to the wrong
                replica; only prefill/unified roles run probes, and
                only for non-fabric pulls.  The ``engine.handoff.serve``
                failpoint injects refusal (``error``) or a stream torn
                after a fraction of the entries (``truncate`` — the
                prefill-died shape)."""
                from ..utils import failpoints

                eng = server.engine
                metrics = eng.metrics

                def _count(outcome: str) -> None:
                    if metrics:
                        metrics.handoff_serves.inc(outcome=outcome)

                if server._fence.is_set() or server._draining.is_set():
                    _count(outcome="refused")
                    self._reply(
                        503,
                        {"error": "replica is fenced or draining"},
                        retry_after=server._retry_after(),
                    )
                    return
                try:
                    hit = failpoints.fire("engine.handoff.serve")
                except failpoints.FailpointError as e:
                    _count(outcome="error")
                    self._reply(503, {"error": f"prefill unavailable: {e}"})
                    return
                hop_ctx = parse_trace_context(
                    self.headers.get("X-Trace-Context")
                )
                t0 = time.monotonic()
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    prompt = [int(t) for t in body["prompt"]]
                    adapter = (
                        int(body["adapter"])
                        if body.get("adapter") is not None
                        else None
                    )
                except (KeyError, TypeError, ValueError) as e:
                    _count(outcome="rejected")
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                with eng._lock:
                    layout = snap_mod.snapshot_layout(eng)
                    fingerprint = eng.params_fingerprint
                layout_fp = snap_mod.layout_fingerprint(layout)
                want_layout = self.headers.get(snap_mod.LAYOUT_HEADER)
                want_params = self.headers.get(snap_mod.PARAMS_HEADER)
                if (want_layout and want_layout != layout_fp) or (
                    want_params and want_params != fingerprint
                ):
                    _count(outcome="refused")
                    eng.flight.record(
                        "handoff.serve_refused",
                        peer=self.client_address[0],
                        layout_ok=(not want_layout
                                   or want_layout == layout_fp),
                        params_ok=(not want_params
                                   or want_params == fingerprint),
                    )
                    self._reply(
                        409,
                        {
                            "error": "handoff layout/params mismatch",
                            "layout": layout_fp,
                            "params_fingerprint": fingerprint,
                        },
                    )
                    return
                n_full = len(prompt) // eng.paged.page_size
                resident = eng.handoff_resident_entries(prompt, adapter)
                resident_only = eng.role == "decode" or bool(
                    self.headers.get(
                        handoff_mod.FABRIC_RESIDENT_ONLY_HEADER
                    )
                )
                if resident is None and resident_only:
                    # Resident-only serve (decode role / fabric pull):
                    # no probe ever.  A peer sharing only this prompt's
                    # PREFIX (the fleet-wide shared system prompt, or a
                    # bloom FP overclaiming depth) is served exactly
                    # the leading pages this replica holds; zero
                    # coverage answers 409 — the puller's locator was
                    # stale and it must prefill locally.  Arena and
                    # trie are untouched either way.
                    partial = eng.handoff_resident_prefix_entries(
                        prompt, adapter
                    )
                    if partial:
                        resident = partial
                        n_full = len(partial)
                    else:
                        _count(outcome="refused")
                        eng.flight.record(
                            "fabric.serve_refused",
                            peer=self.client_address[0],
                            prompt_tokens=len(prompt),
                            covered=0,
                            of=n_full,
                            role=eng.role,
                        )
                        self._reply(
                            409,
                            {
                                "error": "prefix not resident on this "
                                "replica (resident-only serve)",
                                "missing_pages": n_full,
                            },
                        )
                        return
                tap = None
                if resident is None:
                    try:
                        tap = eng.handoff_begin(prompt, adapter)
                    except ShedError as e:
                        _count(outcome="rejected")
                        self._reply(
                            503,
                            {"error": f"prefill probe shed: {e}"},
                            retry_after=f"{max(e.retry_after_s, 1.0):g}",
                        )
                        return
                    except (TypeError, ValueError) as e:
                        _count(outcome="rejected")
                        self._reply(422, {"error": str(e)})
                        return
                # Preamble first — the entry count is known before any
                # compute, so transfer overlaps prefill.
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header(snap_mod.LAYOUT_HEADER, layout_fp)
                self.send_header(snap_mod.PARAMS_HEADER, fingerprint)
                self.send_header(snap_mod.ENTRIES_HEADER, str(n_full))
                self.end_headers()
                emit_cap = n_full
                if hit is not None and hit.mode == "truncate":
                    # Tear the stream after a fraction of the entries:
                    # the prefill-replica-died-mid-transfer byte shape
                    # (the header still promises n_full, so the decode
                    # side's parse raises on the missing tail).
                    frac = float(hit.arg) if hit.arg else 0.5
                    emit_cap = int(n_full * frac)
                sent = 0
                outcome = "ok"
                deadline = t0 + server._handoff_timeout
                try:
                    self.wfile.write(
                        snap_mod.encode_preamble(layout, fingerprint, n_full)
                    )
                    if resident is not None:
                        for key, rows in resident[:emit_cap]:
                            self.wfile.write(
                                snap_mod.encode_entry(layout, key, rows)
                            )
                            sent += 1
                        self.wfile.flush()
                    else:
                        while sent < emit_cap:
                            with server._cond:
                                server._cond.notify_all()  # wake the loop
                            entry = tap.pop(timeout=0.2)
                            if entry is None:
                                if tap.dead and tap.pushed <= sent:
                                    outcome = "aborted"  # probe shed/cancel
                                    break
                                if time.monotonic() > deadline:
                                    outcome = "aborted"
                                    break
                                continue
                            key, rows = entry
                            self.wfile.write(
                                snap_mod.encode_entry(layout, key, rows)
                            )
                            self.wfile.flush()
                            sent += 1
                    if emit_cap < n_full:
                        outcome = "aborted"  # truncate failpoint tore it
                    elif sent == n_full and n_full:
                        # Trailing logits section: lets the decode side
                        # admit with ZERO prefill compute (absent when
                        # the probe's logits are gone — the decode side
                        # then pays one tail chunk, nothing breaks).
                        logits = (
                            tap.logits if tap is not None else None
                        )
                        if logits is None:
                            with eng._lock:
                                lg = eng._kv_arena.get(
                                    (
                                        "logits",
                                        eng._trie_root(adapter),
                                        tuple(prompt),
                                    )
                                )
                            logits = (
                                lg["logits"] if lg is not None else None
                            )
                        if logits is not None:
                            self.wfile.write(
                                handoff_mod.encode_logits_section(logits)
                            )
                            self.wfile.flush()
                except OSError:
                    outcome = "client_gone"  # decode side vanished
                finally:
                    if tap is not None:
                        eng.handoff_end(tap)
                with eng._lock:
                    eng.handoff_serves += 1
                    eng.handoff_served_entries += sent
                _count(outcome=outcome)
                if metrics and sent:
                    metrics.handoff_entries.inc(sent, direction="served")
                if eng.spans is not None:
                    attrs = {
                        "entries": sent,
                        "outcome": outcome,
                        "resident": resident is not None,
                    }
                    if hop_ctx is not None:
                        # Cross-process link: this serve roots under the
                        # decode replica's handoff.fetch span.
                        attrs["parent"] = hop_ctx.parent_span
                        attrs["hop"] = hop_ctx.hop
                        attrs["attempt"] = hop_ctx.attempt
                    eng.spans.record_span(
                        "handoff.serve",
                        hop_ctx.trace_id
                        if hop_ctx is not None
                        else sanitize_trace_id(
                            self.headers.get("X-Request-Id")
                        ),
                        start_monotonic=t0,
                        attrs=attrs,
                    )
                eng.flight.record(
                    "handoff.served",
                    peer=self.client_address[0],
                    entries=sent,
                    of=n_full,
                    outcome=outcome,
                    resident=resident is not None,
                    ms=round((time.monotonic() - t0) * 1e3, 3),
                )

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0]
                if path == "/healthz":
                    ok = server._loop_alive and not server._stop.is_set()
                    if server._fence.is_set():
                        # Fenced beats draining/ok: the replica must
                        # read as not-ready until an operator (or the
                        # underlying fault clearing + unfence) releases
                        # it.
                        self._reply(
                            503,
                            {
                                "status": "fenced",
                                "reason": server.fence_reason,
                            },
                            retry_after=server._retry_after(),
                        )
                        return
                    if ok and server._draining.is_set():
                        # Draining reads as not-ready: a router/probe must
                        # stop sending traffic while in-flight work finishes.
                        self._reply(
                            503,
                            {"status": "draining"},
                            retry_after=server._retry_after(),
                        )
                        return
                    self._reply(
                        200 if ok else 503,
                        {"status": "ok" if ok else "down"},
                        retry_after=None if ok else "1",
                    )
                elif path == "/debug/state":
                    # Cheap top-level summary a router's poll loop can
                    # afford every second across the fleet: queue depth,
                    # active slot count, and the draining flag (which was
                    # otherwise only visible as a /healthz 503).  Plain
                    # racy scalar reads — no engine lock, no span/profiler
                    # assembly.
                    ov = server.engine.overload
                    wait_ewma = ov.wait_ewma_s() if ov is not None else None
                    drain_rate = (
                        ov.drain_rate_rps() if ov is not None else None
                    )
                    summary = {
                        # Disaggregation role (unified/prefill/decode):
                        # the router's poll loop keeps prefill-role
                        # replicas out of the /generate ring and feeds
                        # the split policy from this field.
                        "role": server.engine.role,
                        "queue_depth": len(server.engine.queue),
                        "active_slots": sum(
                            1 for s in server.engine.slots if s is not None
                        ),
                        "draining": server._draining.is_set(),
                        # The router's poll loop demotes a fenced
                        # replica exactly like a draining one (no new
                        # assignments; streams fail over).
                        "fenced": server._fence.is_set(),
                        "loop_alive": server._loop_alive,
                        # Process age: the fleet controller's
                        # replica-minutes accounting and its
                        # scale-down victim tie-breaker — reap the
                        # youngest-warmed, not the long-lived donor.
                        "uptime_s": round(
                            time.monotonic() - server._started, 3
                        ),
                        # Host-side overload signals (the Host-Side
                        # Telemetry pattern): the router's migration
                        # planner and /debug/fleet scale signal read
                        # THESE — queue-wait EWMA and drain-rate
                        # forecast, not device counters.  None without
                        # an overload controller (or before traffic).
                        "queue_wait_ewma_s": (
                            round(wait_ewma, 4)
                            if wait_ewma is not None
                            else None
                        ),
                        "drain_rate_rps": (
                            round(drain_rate, 3)
                            if drain_rate is not None
                            else None
                        ),
                        # Compact SLI counters (utils/slo.py): cumulative
                        # [good, total] per objective.  The router's poll
                        # loop deltas these between sweeps to aggregate
                        # fleet-level burn rates for free; None when the
                        # SLO plane is off.  Racy lock-free reads like
                        # every other summary scalar — a torn read shows
                        # one verdict's drift.
                        "slo": (
                            {"objectives": server.engine.slo.totals()}
                            if server.engine.slo is not None
                            else None
                        ),
                        # Canary-prober oracle key + staleness feed
                        # (router/prober.py): the weights fingerprint the
                        # token oracle is captured against (computed once,
                        # cached — params never change in-process), and a
                        # cumulative request counter whose freezing while
                        # probes keep landing is the metric-staleness
                        # verdict.
                        # Cumulative anomaly-incident counter: the
                        # router's fleet postmortem collector
                        # (router/postmortem.py) deltas this between
                        # polls — an advance triggers a fleet evidence
                        # capture while this replica's rings still hold
                        # the lead-up.
                        "incidents_total": (
                            server.engine.anomaly.incidents_total
                            if server.engine.anomaly is not None
                            else None
                        ),
                        "params_fingerprint": server.params_fp(),
                        "requests_total": (
                            int(server.engine.metrics.requests.value())
                            if server.engine.metrics is not None
                            else None
                        ),
                        # Fleet KV fabric advertisement: the bloom
                        # digest of every cumulative prefix this
                        # replica can serve over /v1/prefill, cached
                        # against the arena/trie version pair so an
                        # unchanged replica answers from the cache (the
                        # fast path reads it racily like every other
                        # summary field — one poll tick of staleness
                        # degrades to a refused pull, by contract).
                        # None when prefix sharing / the arena is off.
                        "fabric_digest": server.engine.fabric_digest(),
                    }
                    if "summary=1" in (self.path.split("?", 1) + [""])[1]:
                        # ?summary=1: the summary ALONE — skips the
                        # engine-lock snapshot and the span ring
                        # entirely, so a K-replica poll fan-in costs the
                        # fleet ~nothing.
                        self._reply(200, summary)
                        return
                    # Full snapshot: the first endpoint to hit during an
                    # incident.  Contains ids and lengths, never token
                    # content (see ServingEngine.debug_state), so it can
                    # stay as open as /metrics.
                    state = {
                        "engine": server.engine.debug_state(),
                        "fence": server.fence_state(),
                        **summary,
                    }
                    rec = server.engine.spans
                    if rec is not None:
                        state["spans"] = rec.snapshot()
                        state["spans_dropped"] = rec.dropped
                        state["span_capacity"] = rec.capacity
                    self._reply(200, state)
                elif path == "/debug/spans":
                    # The span ring alone (also rides /debug/state);
                    # ?rid=<trace id> filters to ONE request's tree so
                    # the trace assembler's live mode doesn't pull the
                    # whole ring per request.  404s without a recorder.
                    rec = server.engine.spans
                    if rec is None:
                        self.send_error(404)
                        return
                    query = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    rid = (query.get("rid") or [None])[0]
                    self._reply(200, rec.dump(trace_id=rid))
                elif path == "/debug/snapshot":
                    # Peer warm-up: stream the live arena (+
                    # retained device pages) in the snapshot wire format
                    # so a scaling-up replica joins warm instead of
                    # stone-cold.  Token CONTENT does ride this surface
                    # (KV rows are the payload) — same trust domain as
                    # the snapshot volume, served only to peers that
                    # already share the weights (fingerprint handshake).
                    self._serve_snapshot()
                elif path == "/debug/profile":
                    # Per-step phase breakdown over the rolling window —
                    # aggregates only, no request-identifying content, so
                    # it stays as open as /metrics.
                    self._reply(200, server.engine.profiler.snapshot())
                elif path == "/debug/disagg":
                    # Disaggregation snapshot (models/engine_handoff.py):
                    # role, handoff serve/fetch/publish counters, and
                    # the skipped-prefill accounting — counts only,
                    # never token content, so it stays as open as
                    # /metrics.
                    self._reply(200, server.engine.handoff_state())
                elif path == "/debug/fabric":
                    # Fleet KV fabric snapshot (engine_handoff.py
                    # fabric_state): the advertised digest + build/
                    # pull/drop counters — the replica-side half of the
                    # router's /debug/fabric locator view.  Digest bits
                    # are hashes of token tuples, never token content.
                    self._reply(200, server.engine.fabric_state())
                elif path == "/debug/kvcache":
                    # KV tiering snapshot (models/engine_kvcache.py):
                    # tier sizes, hit/evict/restore counters, resume
                    # accounting — counts and bytes only, never token
                    # content, so it stays as open as /metrics.
                    self._reply(200, server.engine.kvcache_state())
                elif path == "/debug/admission":
                    # Overload-control snapshot (engine_overload.py):
                    # the AIMD limit and its inputs, the shed ledger,
                    # and per-tenant debt — the first stop during an
                    # overload incident.  Counts and tenant NAMES only
                    # (tenants are routing identifiers, not content).
                    self._reply(200, server.engine.overload_state())
                elif path == "/debug/slo":
                    # SLO plane (utils/slo.py): objectives, sliding-
                    # window burn rates, budget remaining, active burn
                    # alerts.  Counts and targets only — as open as
                    # /metrics.
                    self._reply(200, server.engine.slo_state())
                elif path == "/debug/usage":
                    # Per-tenant usage meters (prompt/decode tokens, KV
                    # page-seconds, queue-wait seconds) under the
                    # 16-tenant label cap.  Tenant NAMES only (routing
                    # identifiers, not content), like /debug/admission.
                    self._reply(200, server.engine.usage_state())
                elif path == "/debug/incidents":
                    self._reply(200, server.engine.anomaly.snapshot())
                elif path == "/debug/flight":
                    # The black box, on demand (same payload SIGUSR2
                    # dumps): ids/lengths/counts only by construction of
                    # the event catalog — never token content.
                    self._reply(200, server.engine.flight.snapshot())
                elif path == "/metrics" and registry is not None:
                    write_exposition(self, registry)
                else:
                    self.send_error(404)

            def _reply(
                self,
                code: int,
                obj: dict,
                trace_id: Optional[str] = None,
                retry_after: Optional[str] = None,
                shed: Optional[str] = None,
                prefill_needed: Optional[str] = None,
            ) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if trace_id:
                    self.send_header("X-Request-Id", trace_id)
                if retry_after:
                    # Every 503 this server emits carries Retry-After —
                    # the router floors its backoff on it (the
                    # drain/overload contract).
                    self.send_header("Retry-After", retry_after)
                if shed:
                    # Overload, not drain: the router must keep the
                    # replica in rotation (back off, don't eject).
                    self.send_header("X-Shed", shed)
                if prefill_needed:
                    # Decode-role refusal: the prompt needs a prefill
                    # dispatch, not another decode replica (the router's
                    # disagg policy reads this — routing.md).
                    self.send_header(
                        handoff_mod.PREFILL_NEEDED_HEADER, prefill_needed
                    )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet under load tests
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _retry_after(self) -> str:
        """An honest Retry-After for drain/shed 503s: the overload
        controller's drain-rate forecast when one is installed, else the
        constant 1s every pre-overload round sent."""
        eng = self.engine
        if eng.overload is not None:
            return f"{eng.overload.retry_after_s(len(eng.queue)):g}"
        return "1"

    def _loop(self) -> None:
        """The engine owner thread: step while there is work, sleep on the
        condition while idle (a submit notifies)."""
        self._loop_alive = True
        try:
            while not self._stop.is_set():
                with self._cond:
                    has_work = (
                        bool(self.engine.queue)
                        or any(s is not None for s in self.engine.slots)
                        or bool(self.engine._owner_calls)
                    )
                    if not has_work:
                        # Idle: wait for a submit (or shutdown poke).
                        self._cond.wait(timeout=0.1)
                        continue
                self.engine.step()  # outside the lock: submit never blocks on jit
                with self._cond:
                    self._cond.notify_all()
        finally:
            self._loop_alive = False
            # Calls that touch the card run on their callers' threads now
            # (a drain's snapshot, a late debug read).
            self.engine.release_owner()
            with self._cond:
                self._cond.notify_all()  # release any waiters on shutdown

    def start(self) -> "EngineServer":
        self._loop_thread = threading.Thread(
            target=self._loop, name="engine-loop", daemon=True
        )
        self._loop_thread.start()
        # Before the first request: handler threads then hand every call
        # that touches the card to the loop thread (on_owner).
        self.engine.claim_owner(self._loop_thread.ident)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="engine-http", daemon=True
        )
        self._http_thread.start()
        if self.watchdog is not None:
            self.watchdog.start()
        if self.chip_health is not None:
            self.chip_health.start()
        if self._snapshot_dir and self._snapshot_interval_s > 0:
            self._snapshot_thread = threading.Thread(
                target=self._snapshot_loop, name="engine-snapshot", daemon=True
            )
            self._snapshot_thread.start()
        return self

    # ------------------------------------------------------------ fencing

    def _watchdog_fence(self, info: dict) -> None:
        self.begin_fence("hung_step", source="watchdog", detail=info)

    def _chip_fence(self, info: dict) -> None:
        self.begin_fence(
            f"chip_{info.get('kind', 'fault')}", source="chip_health",
            detail=info,
        )

    def params_fp(self) -> str:
        """The engine's weights fingerprint (engine_snapshot CRC sweep of
        the tree it was built from) — the ?summary=1 oracle key the canary
        prober captures token oracles against."""
        return self.engine.params_fingerprint

    def set_role(self, role: str) -> bool:
        """Flip the engine's disaggregation role at runtime (the fleet
        controller's ``POST /debug/role`` rebalancing verb).  Raises
        ``ValueError`` on an invalid or unsupported role; idempotent."""
        return self.engine.set_role(role)

    def begin_fence(
        self, reason: str, source: str = "operator", detail=None
    ) -> bool:
        """Fence this replica: admission answers 503, ``/healthz`` and
        the router's summary poll read fenced, in-flight streams are CUT
        (the router's zero-drop failover resubmits them), the warm KV
        state snapshots to disk, and everything still queued/slotted is
        cancelled.  The step loop keeps running — an unfence resumes
        serving without a restart.  Idempotent (False when already
        fenced); ``source`` is the bounded metrics label
        (watchdog / chip_health / operator)."""
        with self._fence_lock:
            if self._fence.is_set():
                return False
            self.fence_reason = str(reason)
            self.fence_source = str(source)
            self.fence_detail = detail
            self.fence_at = time.monotonic()
            self.fences += 1
            self._fence.set()
        eng = self.engine
        if eng.metrics:
            eng.metrics.fenced.set(1)
            eng.metrics.fences.inc(source=source)
        eng.flight.record(
            "engine.fenced", reason=reason, source=source, detail=detail
        )
        # A fence is a discrete fault, incident-worthy on first
        # observation — same fan-out as every other incident (ring +
        # flight window + counter), so /debug/incidents tells the story.
        eng.anomaly.report(
            "engine.fenced", 1.0, reason=reason, source=source
        )
        # Persist the warm prefix state while the process still can — a
        # fence is often the last stop before a restart.  A chip-health
        # fence skips the device-page reads (rows off a sick chip are
        # not worth trusting), and so does a hung-step fence here: device
        # pages are read on the loop thread, which is the one hung.  The
        # host-RAM arena is still safe.
        if self._snapshot_dir:
            self.save_snapshot(
                trigger=f"fence:{source}",
                include_device=source not in ("chip_health", "watchdog"),
            )
        # Wake every waiter FIRST: streams cut and unary handlers 503
        # before the cancel sweep below can dress a teardown up as a
        # completion.
        with self._cond:
            self._cond.notify_all()
        # In-flight work is being failed over by the router: release
        # the slots/pages rather than keep decoding for nobody (a hung
        # loop applies this at whatever step boundary it next reaches).
        with self._cond:
            leftovers = [r for r in eng.slots if r is not None]
            leftovers += list(eng.queue)
        for req in leftovers:
            eng.cancel(req)
        with self._cond:
            self._cond.notify_all()
        return True

    def unfence(self) -> bool:
        """Release the fence: admission reopens, ``/healthz`` recovers,
        the router's next poll promotes the replica back, and both
        detectors re-arm (a STILL-hung step or still-sick chip re-fences
        on their next check — unfencing a wedged replica tells the
        operator immediately)."""
        with self._fence_lock:
            if not self._fence.is_set():
                return False
            self._fence.clear()
            self.fence_reason = None
            self.fence_source = None
            self.fence_detail = None
        eng = self.engine
        if eng.metrics:
            eng.metrics.fenced.set(0)
        eng.flight.record("engine.unfenced")
        if self.watchdog is not None:
            self.watchdog.rearm()
        if self.chip_health is not None:
            self.chip_health.rearm()
        with self._cond:
            self._cond.notify_all()
        return True

    @property
    def fenced(self) -> bool:
        return self._fence.is_set()

    def fence_state(self) -> dict:
        """JSON-safe fence/watchdog/snapshot block of GET /debug/state."""
        with self._fence_lock:
            fenced = self._fence.is_set()
            state = {
                "fenced": fenced,
                "reason": self.fence_reason,
                "source": self.fence_source,
                "detail": self.fence_detail,
                "since_s": (
                    round(time.monotonic() - self.fence_at, 3)
                    if fenced
                    else None
                ),
                "fences_total": self.fences,
            }
        state["watchdog"] = (
            self.watchdog.snapshot() if self.watchdog is not None else None
        )
        state["chip_health"] = (
            self.chip_health.snapshot()
            if self.chip_health is not None
            else None
        )
        state["snapshot"] = {
            "dir": self._snapshot_dir or None,
            "interval_s": self._snapshot_interval_s,
            "last_save": self.last_snapshot_save,
            "last_load": self.last_snapshot_load,
        }
        return state

    # ----------------------------------------------------- warm snapshots

    def _snapshot_path(self) -> str:
        from .engine_snapshot import SNAPSHOT_NAME

        return os.path.join(self._snapshot_dir, SNAPSHOT_NAME)

    def save_snapshot(
        self, trigger: str = "manual", include_device: bool = True
    ) -> dict:
        """Persist the KV host arena (+ retained device pages) to the
        snapshot dir; one save at a time (periodic vs fence vs drain
        collapse onto the lock, last writer wins the atomic rename)."""
        if not self._snapshot_dir:
            return {"ok": False, "reason": "disabled"}
        from .engine_snapshot import save_arena_snapshot

        with self._snap_lock:
            # Re-check the fence UNDER the save lock: the periodic
            # thread tests the fence BEFORE
            # blocking here, so a fence that lands while its save is
            # queued on the lock would otherwise let the stale periodic
            # save run second and republish device-page rows the
            # fence-path save (chip_health source) deliberately
            # excluded — the fence's safe snapshot, overwritten by a
            # pre-fence view of a now-suspect chip.  Operator/drain
            # saves still run while fenced; only the stale periodic
            # writer is turned away.
            if trigger == "periodic" and self._fence.is_set():
                return {"ok": False, "reason": "fenced", "trigger": trigger}
            result = save_arena_snapshot(
                self.engine,
                self._snapshot_path(),
                include_device=include_device,
                trigger=trigger,
            )
            self.last_snapshot_save = result
        return result

    def load_snapshot(self) -> dict:
        """Rehydrate the KV host arena from the snapshot dir (call once
        BEFORE start(): the first admissions then restore warm).  A
        missing/corrupt snapshot degrades to a clean cold start."""
        if not self._snapshot_dir:
            return {"ok": False, "reason": "disabled"}
        from .engine_snapshot import load_arena_snapshot

        result = load_arena_snapshot(self.engine, self._snapshot_path())
        self.last_snapshot_load = result
        return result

    def warm_from_peer(self, peer: str, timeout_s: float = 30.0) -> dict:
        """Peer warm-up: stream ``peer``'s GET
        /debug/snapshot into this engine's arena — call BEFORE start(),
        like :meth:`load_snapshot`.  Any failure (peer gone mid-stream,
        fingerprint refusal, corruption) degrades to a clean cold
        start; the joiner serves either way."""
        from .engine_snapshot import fetch_peer_snapshot

        result = fetch_peer_snapshot(self.engine, peer, timeout_s=timeout_s)
        self.last_snapshot_load = result
        return result

    def warm_from_fleet(self, router_url: str, self_name: str) -> dict:
        """Resolve the warm-up donor from the router's membership view
        (the neighbor owning the ring segments ``self_name`` is about
        to inherit — engine_snapshot.donor_for) and fetch its snapshot.
        An unreachable router or an empty fleet is an ordinary cold
        join, not an error."""
        from .engine_snapshot import (
            SnapshotError,
            donor_for,
            fleet_members,
        )

        try:
            members = fleet_members(router_url)
        except SnapshotError as e:
            result = {"ok": False, "reason": str(e), "restored": 0}
            self.last_snapshot_load = result
            return result
        donor = donor_for(self_name, members)
        if donor is None:
            result = {"ok": False, "reason": "no_peer", "restored": 0}
            self.last_snapshot_load = result
            return result
        return self.warm_from_peer(donor)

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self._snapshot_interval_s):
            if self._fence.is_set():
                continue  # the fence path already saved
            self.save_snapshot(trigger="periodic")

    # ----------------------------------------------------------- draining

    def _engine_idle(self) -> bool:
        eng = self.engine
        return (
            not eng.queue
            and not eng._pending
            and all(s is None for s in eng.slots)
        )

    def begin_drain(self, grace_s: float = 10.0) -> None:
        """Graceful drain (the SIGTERM path): stop admitting (POST
        /generate answers 503, /healthz flips to draining), keep the
        step loop running until every in-flight request finishes — at
        most ``grace_s`` seconds — then stop the loop and set
        :attr:`drained`.  Requests still alive at the deadline are
        cancelled (their streams end with the cancel, not a cut
        mid-token at process kill).  Idempotent."""
        if self._draining.is_set():
            return
        self._draining.set()
        self.engine.flight.record("server.drain_begin", grace_s=grace_s)
        threading.Thread(
            target=self._drain_watch,
            args=(float(grace_s),),
            name="engine-drain",
            daemon=True,
        ).start()

    def _drain_watch(self, grace_s: float) -> None:
        t0 = time.monotonic()
        with self._cond:
            self._cond.notify_all()  # wake an idle loop to notice work
            completed = self._cond.wait_for(self._engine_idle, timeout=grace_s)
        cut = 0
        if not completed:
            # Grace expired: cancel the stragglers so their slots/pages
            # release and their stream waiters see a definite end.
            with self._cond:
                leftovers = [r for r in self.engine.slots if r is not None]
                leftovers += list(self.engine.queue)
            for req in leftovers:
                self.engine.cancel(req)
                cut += 1
        self.engine.flight.record(
            "server.drain_end",
            completed=completed,
            cut_requests=cut,
            seconds=round(time.monotonic() - t0, 3),
        )
        # The drain is the orderly half of a restart: persist the warm
        # prefix state so the replacement pod's restores hit warm.
        if self._snapshot_dir:
            self.save_snapshot(trigger="drain")
        self._stop.set()
        self.drained.set()
        with self._cond:
            self._cond.notify_all()

    def stop(self) -> None:
        self._stop.set()
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.chip_health is not None:
            self.chip_health.stop()
        with self._cond:
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)

    def serve_forever(self) -> None:
        """Block until interrupted (the in-pod entry point's main loop)."""
        try:
            while not self._stop.is_set():
                self._stop.wait(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def _resolve_decode_block(explicit: Optional[int], spec_gamma: int) -> int:
    """The reference's default decode block: 16, or 1 when speculation is
    on (it steps per token).  An explicit --decode-block always wins."""
    if explicit is not None:
        return explicit
    return 1 if spec_gamma else 16


def _positive_int(text: str) -> int:
    """argparse type: integer >= 1."""
    import argparse

    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def parse_args(argv: Optional[list[str]] = None):
    """The serving CLI: the reference's flags under the reference's names
    and defaults, plus ``--device``, ``--dtype`` and ``--seed`` (the random
    weights, when no ``--checkpoint-dir`` is given).  The reference's
    refused pairs (``--adapters`` or ``--spec-gamma`` with ``--quant``,
    ``--adapters`` with ``--spec-gamma``) raise ``SystemExit`` naming the
    flag.  Every flag is served under ``--tp`` > 1."""
    import argparse

    from .engine import _pow2_int

    p = argparse.ArgumentParser(prog="tpu-serving-http-torch")
    p.add_argument("--hidden", type=_positive_int, default=512)
    p.add_argument("--layers", type=_positive_int, default=4)
    p.add_argument("--heads", type=_positive_int, default=8)
    p.add_argument("--kv-heads", type=_positive_int, default=4)
    p.add_argument("--vocab", type=_positive_int, default=32000)
    p.add_argument("--quant", choices=["w8", "w8a8"], default=None)
    p.add_argument("--quant-kv", action="store_true",
                   help="int8 paged KV pools (the paged kernel's int8 branch)")
    p.add_argument("--page-size", type=_positive_int, default=16)
    p.add_argument("--num-pages", type=_positive_int, default=128)
    p.add_argument("--max-pages-per-seq", type=_positive_int, default=16)
    p.add_argument("--slots", type=_positive_int, default=4)
    p.add_argument("--use-kernel", action=argparse.BooleanOptionalAction, default=None,
                   help="decode through the split-K paged kernel (default) or, with "
                   "--no-use-kernel, through the gathered page view")
    p.add_argument("--kernel-splits", type=_positive_int, default=None,
                   help="pin the paged kernel's split-K degree (default: ops/tuning.py)")
    p.add_argument("--spec-gamma", type=int, default=0,
                   help="speculative decoding: gamma w8 self-draft proposals per verify pass "
                   "(shared pool; decode block 1). Incompatible with --quant and --adapters")
    p.add_argument("--prefill-chunk", type=_pow2_int, default=None,
                   help="stream prompts into the prefill in chunks (power of two)")
    p.add_argument("--decode-block", type=_pow2_int, default=None,
                   help="tokens per dispatch in pure decode (power of two; default 16)")
    p.add_argument("--admission", choices=["reserve", "optimistic"], default="reserve",
                   help="optimistic: prompt-pages-only admission with newest-slot "
                   "recompute preemption under pool pressure")
    p.add_argument("--overlap-steps", type=int, choices=[0, 1], default=1,
                   help="decode dispatches kept in flight ahead of the readback")
    p.add_argument("--overload", type=int, choices=[0, 1], default=1,
                   help="overload control (models/engine_overload.py, default on)")
    p.add_argument("--overload-target-wait", type=float, default=0.5,
                   help="AIMD setpoint: the queue wait (seconds) admitted concurrency "
                   "steers toward")
    p.add_argument("--overload-max-queue", type=int, default=512,
                   help="hard queue cap: submits past this depth shed with 503")
    p.add_argument("--slo", type=int, choices=[0, 1], default=1,
                   help="SLO plane (utils/slo.py, default on)")
    p.add_argument("--slo-ttft-target", type=float, default=2.0)
    p.add_argument("--slo-itl-target", type=float, default=0.25)
    p.add_argument("--kv-retain", type=int, choices=[0, 1], default=1,
                   help="KV cache tier 1 (default on): retain dead-but-valid prefix pages "
                   "on an LRU, so a repeated prefix or a preemption resume restores them "
                   "instead of recomputing; reclaimed lazily, leaf first")
    p.add_argument("--kv-host-cache-mb", type=float, default=64,
                   help="KV cache tier 2: host-RAM arena byte budget (MiB) that reclaimed "
                   "pages and preemption snapshots spill into (0 disables)")
    p.add_argument("--role", choices=["unified", "prefill", "decode"], default="unified",
                   help="disaggregated serving role (models/engine_handoff.py): unified "
                   "prefills and decodes; prefill serves POST /v1/prefill and answers "
                   "/generate 409; decode admits resident (or pulled) prefixes and skips "
                   "their prefill.  Split roles require --kv-retain 1 and "
                   "--kv-host-cache-mb > 0")
    p.add_argument("--handoff-timeout", type=float, default=30.0,
                   help="seconds a decode-role replica spends pulling a prefix from its "
                   "X-Handoff-Source (and a /v1/prefill probe waits for chunk progress) "
                   "before degrading to local prefill")
    p.add_argument("--tp", type=_positive_int, default=1,
                   help="tensor-parallel degree: shard params (Megatron path rules) and KV "
                   "pools (kv-heads axis) over a mesh built from the chips the plugin "
                   "allocated — TPU_VISIBLE_CHIPS in physical ICI snake order "
                   "(parallel/mesh.mesh_from_allocation); must equal the granted chip "
                   "count on-cluster, and kv-heads must divide by it; off-cluster falls "
                   "back to the first N ranks, one process per card; 1 = single-chip "
                   "(default)")
    p.add_argument("--http-port", type=int, default=8000)
    p.add_argument("--compilation-cache-dir",
                   default=os.environ.get("TPU_COMPILATION_CACHE_DIR", ""),
                   help="XLA's persistent compilation cache: accepted and unused here "
                   "(the CUDA kernels build once per checkout under build/)")
    p.add_argument("--span-ring", type=_positive_int, default=512,
                   help="capacity of the request-span ring (GET /debug/state, /debug/spans)")
    p.add_argument("--debug-trace", action="store_true",
                   help="enable POST /debug/trace and /debug/profile/capture "
                   "(torch.profiler captures of the live loop); off by default")
    p.add_argument("--flight-ring", type=_positive_int, default=2048,
                   help="capacity of the flight-recorder event ring")
    p.add_argument("--dump-dir", default=flight_mod.default_dump_dir() or "",
                   help="directory for flight-recorder dumps and postmortem bundles "
                   "(default: $TPU_PLUGIN_DUMP_DIR)")
    p.add_argument("--dump-budget-mb", type=int, default=0,
                   help="retention budget (MiB) for --dump-dir (0 = unbounded)")
    p.add_argument("--drain-grace", type=float, default=10.0,
                   help="graceful-drain window in seconds after SIGTERM")
    p.add_argument("--failpoints", default="",
                   help="arm chaos failpoints: 'name=mode[:arg][*count];...'")
    p.add_argument("--watchdog", type=int, choices=[0, 1], default=1,
                   help="hung-step watchdog (models/engine_watchdog.py, default on)")
    p.add_argument("--watchdog-min-deadline", type=float, default=5.0,
                   help="floor (seconds) of the hung-step deadline")
    p.add_argument("--watchdog-grace", type=float, default=120.0,
                   help="deadline (seconds) for grace steps: kernel builds, first "
                   "launches, graph captures, prefill")
    p.add_argument("--chip-health-url", default="",
                   help="plugin daemon device-health surface to watch")
    p.add_argument("--chip-health-interval", type=float, default=1.0)
    p.add_argument("--snapshot-dir", default="",
                   help="crash-safe warm restart (models/engine_snapshot.py): persist the "
                   "KV host arena here on fence/drain/SIGTERM and every --snapshot-interval "
                   "seconds, and rehydrate it at startup (empty = off)")
    p.add_argument("--snapshot-interval", type=float, default=60.0,
                   help="seconds between periodic KV-arena snapshots (0 disables the timer; "
                   "fence/drain/SIGTERM saves still run)")
    p.add_argument("--warm-from-peer", default="",
                   help="peer warm-up: stream this host:port's GET /debug/snapshot into the "
                   "KV host arena before serving (empty = off)")
    p.add_argument("--warm-from-fleet", default="",
                   help="peer warm-up via the router: pick the donor from this router URL's "
                   "/debug/fleet membership and fetch its snapshot before serving")
    p.add_argument("--warm-self", default="",
                   help="this replica's host:port as the router's ring names it (the "
                   "--warm-from-fleet donor key); default <hostname>:<http-port>")
    p.add_argument("--admin-endpoints", type=int, choices=[0, 1], default=1,
                   help="serve POST /debug/fence, /debug/unfence, /debug/role and the "
                   "fabric verbs")
    p.add_argument("--checkpoint-dir", default="",
                   help="serve the params of this checkpoint directory's newest step "
                   "(models/checkpoint.py, torch.save; not orbax) instead of --seed's")
    p.add_argument("--adapters", default="",
                   help="comma-separated checkpoint dirs of LoRA trees (GPTConfig(lora_rank=r) "
                   'layouts) served as stacked adapters; a request picks one with "adapter": '
                   "i or omits it for the base model")
    p.add_argument("--lora-rank", type=_positive_int, default=None,
                   help="expected rank of the --adapters trees (a cross-check; the served "
                   "rank is read from the trees)")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="LoRA alpha the --adapters trees were trained with (default 16.0)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.spec_gamma < 0:
        raise SystemExit(f"--spec-gamma must be >= 0, got {args.spec_gamma}")
    if args.adapters and args.quant:
        raise SystemExit("--adapters serves the base weights plus LoRA deltas; quantize after "
                         "merging instead (--quant is mutually exclusive)")
    if args.adapters and args.spec_gamma:
        raise SystemExit("--adapters is not supported with --spec-gamma (the w8 self-draft has "
                         "no coherent multi-adapter form)")
    if args.spec_gamma and args.quant:
        raise SystemExit("--spec-gamma uses the w8 SELF-draft against the unquantized target; "
                         "an already-quantized target (--quant) leaves nothing to verify "
                         "against: drop one of the flags")
    return args


def build_engine(args, registry: Optional[MetricsRegistry] = None,
                 flight=None, spans=None, mesh=None, device=None) -> ServingEngine:
    """The engine the serving flags describe: weights from
    ``--checkpoint-dir`` or random from ``--seed``, the ``--adapters`` trees
    stacked over them, the w8 self-draft under ``--spec-gamma``, quantized
    under ``--quant`` (as the reference CLI quantizes its init).
    ``mesh``/``device``: one rank of a ``--tp`` group (every rank builds
    from the same ``args``).  chip_smoke.py builds its in-process twin of
    a served engine through here."""
    import dataclasses
    import sys

    import torch

    from ..utils.device import fp32_reference_precision, resolve_device
    from .engine import EngineMetrics
    from .engine_overload import OverloadConfig
    from .transformer import GPTConfig, PagedConfig, init_params

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
    )
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=args.quant)
    if args.quant_kv:
        cfg = dataclasses.replace(cfg, quant_kv=True)
    paged = PagedConfig(
        args.page_size, args.num_pages, args.max_pages_per_seq,
        use_kernel=args.use_kernel, kernel_num_splits=args.kernel_splits,
    )
    from ..ops.quant import quantize_lm_params
    from .checkpoint import CheckpointManager

    if args.checkpoint_dir:
        params = CheckpointManager(args.checkpoint_dir).restore_params()
        print(f"restored params from {args.checkpoint_dir}", file=sys.stderr)
        if args.quant:
            params = quantize_lm_params(params)
    else:
        params = init_params(cfg, args.seed)
    spec_kw = {}
    if args.spec_gamma:
        spec_kw = dict(spec_gamma=args.spec_gamma, draft_params=quantize_lm_params(params))
    if args.adapters:
        from .lora import lora_rank_of, stack_lora_adapters

        trees = [CheckpointManager(d).restore_params() for d in args.adapters.split(",") if d]
        # The served rank always comes from the trees: a wrong flag would
        # scale every delta by alpha/wrong_rank and still shape-check.
        rank = lora_rank_of(trees[0])
        if args.lora_rank is not None and args.lora_rank != rank:
            raise SystemExit(f"--lora-rank {args.lora_rank} does not match the adapter trees' "
                             f"actual rank {rank}")
        params = stack_lora_adapters(params, trees)
        cfg = dataclasses.replace(cfg, lora_rank=rank, lora_serve=len(trees))
        if args.lora_alpha is not None:
            cfg = dataclasses.replace(cfg, lora_alpha=args.lora_alpha)
        print(f"serving {len(trees)} LoRA adapter(s) over the base weights", file=sys.stderr)
    overload_cfg = None
    if args.overload:
        overload_cfg = OverloadConfig(
            target_queue_wait_s=args.overload_target_wait, max_queue=args.overload_max_queue,
        )
    return ServingEngine(
        cfg, params, paged,
        max_slots=args.slots,
        **spec_kw,
        metrics=EngineMetrics(registry if registry is not None else MetricsRegistry()),
        spans=spans,
        flight=flight,
        prefill_chunk=args.prefill_chunk,
        decode_block=_resolve_decode_block(args.decode_block, args.spec_gamma),
        overlap_steps=args.overlap_steps,
        admission=args.admission,
        overload=overload_cfg,
        slo=(
            {"ttft_target_s": args.slo_ttft_target, "itl_p99_target_s": args.slo_itl_target}
            if args.slo
            else None
        ),
        kv_retain=bool(args.kv_retain),
        kv_host_cache_mb=args.kv_host_cache_mb,
        role=args.role,
        device=device,
        mesh=mesh,
    )


def main(argv: Optional[list[str]] = None, *, tp_backend: Optional[str] = None) -> None:
    """The serving process: engine, owner loop and HTTP on --http-port,
    metrics co-hosted; SIGTERM drains and exits 0.  Under ``--tp N`` > 1
    this process is the group's leader and starts N - 1 followers
    (``engine_tp.launch``, with ``tp_backend`` as its backend: NCCL on
    cards by default, gloo to put ranks on one card); they exit with it."""
    import sys

    args = parse_args(argv)
    group = None
    if args.tp > 1:
        from .engine_tp import launch

        try:
            group = launch(args.tp, backend=tp_backend, device=args.device)
        except ValueError as e:
            raise SystemExit(str(e))
    try:
        _serve(args, group)
    except BaseException:
        if group is not None:
            group.abort()
        raise
    if group is not None:
        group.close()


def _serve(args, group) -> None:
    """:func:`main` after the group (None without ``--tp``) is formed."""
    import sys

    if args.compilation_cache_dir:
        print(
            f"--compilation-cache-dir {args.compilation_cache_dir}: XLA's cache; the PyTorch "
            "port does not use it",
            file=sys.stderr,
        )
    registry = MetricsRegistry()
    # The black box: registered process-wide so `kill -USR2` (and, with a
    # dump dir configured, process exit) writes it to disk.
    box = flight_mod.register(
        flight_mod.FlightRecorder(capacity=args.flight_ring, name="engine")
    )
    flight_mod.install_dump_handlers(args.dump_dir or None)
    from ..utils import failpoints

    failpoints.set_flight(box)
    failpoints.arm_from_env()
    if args.failpoints:
        failpoints.arm_spec(args.failpoints)
    spans = flight_mod.register_spans(SpanRecorder(capacity=args.span_ring, name="engine"))
    if group is None:
        engine = build_engine(args, registry, flight=box, spans=spans)
    else:
        import functools

        engine = group.build(functools.partial(build_engine, args), registry=registry,
                             flight=box, spans=spans)
        print(f"tensor parallel: tp={args.tp} over {engine.tp_state()['devices']} "
              f"(follower pids {group.follower_pids})", file=sys.stderr, flush=True)
    watchdog = None
    if args.watchdog:
        watchdog = StepWatchdog(
            lambda info: None,  # EngineServer binds the fence path
            min_deadline_s=args.watchdog_min_deadline,
            grace_deadline_s=args.watchdog_grace,
        )
    chip_feed = None
    # Off a TPU node visible_chip_paths() is empty: no devfs feed is built
    # (the GPU device nodes' feed waits for the GPU device plugin).
    chip_paths = visible_chip_paths()
    if args.chip_health_url or chip_paths:
        chip_feed = ChipHealthFeed(
            lambda info: None,  # EngineServer binds the fence path
            url=args.chip_health_url,
            device_paths=chip_paths,
            poll_interval_s=args.chip_health_interval,
            flight=box,
        )
        print(
            "chip-health feed: " + (args.chip_health_url or "devfs")
            + f" over {chip_paths or 'daemon inventory'}",
            file=sys.stderr,
        )
    server = EngineServer(
        engine, port=args.http_port, registry=registry,
        enable_trace=args.debug_trace,
        enable_admin=bool(args.admin_endpoints),
        watchdog=watchdog,
        chip_health=chip_feed,
        snapshot_dir=args.snapshot_dir,
        snapshot_interval_s=args.snapshot_interval,
        handoff_timeout_s=args.handoff_timeout,
    )
    if args.snapshot_dir:
        # Rehydrate before serving: the first admissions restore warm.
        restored = server.load_snapshot()
        print(f"kv snapshot restore: {restored}", file=sys.stderr, flush=True)
    if args.warm_from_peer or args.warm_from_fleet:
        # Peer warm-up before serving; a failure is an ordinary cold join.
        if args.warm_from_peer:
            warmed = server.warm_from_peer(args.warm_from_peer)
        else:
            import socket as socket_mod

            self_name = args.warm_self or f"{socket_mod.gethostname()}:{args.http_port}"
            warmed = server.warm_from_fleet(args.warm_from_fleet, self_name)
        print(f"peer warm-up: {warmed}", file=sys.stderr, flush=True)
    if args.dump_budget_mb:
        flight_mod.set_dump_budget(args.dump_budget_mb * 1024 * 1024)
    if args.dump_dir:
        # Local postmortem capture (utils/postmortem.py): every incident
        # snapshots the flight ring, span ring, metrics and debug state
        # into a bundle under --dump-dir, debounced per incident metric.
        from ..utils.postmortem import PostmortemCapture

        capture = PostmortemCapture(
            "engine",
            args.dump_dir,
            flight=box,
            spans=engine.spans,
            registry=registry,
            state_fn=lambda: {"engine": engine.debug_state(), "fence": server.fence_state()},
            budget_bytes=args.dump_budget_mb * 1024 * 1024 if args.dump_budget_mb else None,
        )
        engine.anomaly.add_listener(capture.on_incident)
    server.start()

    import signal

    def _on_signal(signum, _frame):
        print(
            f"received {signal.Signals(signum).name}; draining (grace {args.drain_grace:.1f}s)",
            file=sys.stderr,
            flush=True,
        )
        server.begin_drain(args.drain_grace)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
    except ValueError:
        pass  # not on the main thread (embedded/test use)
    print(
        f"serving on :{server.port} (POST /generate, GET /healthz /metrics "
        "/debug/state /debug/spans /debug/profile /debug/kvcache "
        "/debug/snapshot /debug/admission /debug/incidents /debug/flight)",
        file=sys.stderr,
        flush=True,
    )
    server.serve_forever()


if __name__ == "__main__":
    main()
