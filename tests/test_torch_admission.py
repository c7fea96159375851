"""Optimistic admission with preemption, and the copied serving modules,
against the JAX package.

The engine half runs the reference's optimistic-admission oracles
(``tests/test_engine.py``: oversubscription then exact preemption, shared
prefixes across a preemption, a cancelled victim) and a churn workload on
a pool small enough to preempt, with the JAX engine beside the port on
the same converted weights: greedy and sampled, at decode block 1 and
16, overlap 0 and 1.  The tokens, the preemption count, the overlap
round's hits and discards by reason (the flight recorder's
``overlap.discard`` events) and the overload controller's shed ledger
must be equal.  Tokens are compared exactly: GPTConfig.tiny() in float32,
whose logits differ by summation order only (tests/test_torch_engine.py
holds the top-2 margins).

The module half gives each module the port copied (flight, failpoints,
spans, anomaly, slo, postmortem, engine_overload, engine_watchdog) and
the reference's the same inputs on a fake clock and requires the same
snapshot, wall-clock stamps aside.
"""

import collections
import dataclasses
import importlib
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.utils import prng

PACKAGES = ("k8s_device_plugin_tpu", "k8s_device_plugin_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------------- the engines


def _cfgs(**kw):
    return (dataclasses.replace(jax_tf.GPTConfig.tiny(), max_seq=64, num_kv_heads=2, **kw),
            dataclasses.replace(port_tf.GPTConfig.tiny(), max_seq=64, num_kv_heads=2, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    params = jax_tf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8), jnp.int32))["params"]
    return params, convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


def _oracle(cfg, params, prompt, n):
    out = jax_tf.greedy_generate(cfg, params, jnp.asarray(prompt, jnp.int32)[None, :], n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _pair(weights, paged_kw, **kw):
    """A JAX engine and the port's, alike."""
    jparams, state = weights
    jcfg, pcfg = _cfgs()
    jeng = jax_engine.ServingEngine(jcfg, jparams, jax_tf.PagedConfig(**paged_kw, use_kernel=True),
                                    **kw)
    peng = port_engine.ServingEngine(pcfg, state, port_tf.PagedConfig(**paged_kw), device="cpu",
                                     **kw)
    return jeng, peng


def _drain(eng, reqs, limit=2000):
    guard = 0
    while not all(r.done for r in reqs):
        eng.step()
        guard += 1
        assert guard < limit, "engine failed to drain"


def test_optimistic_oversubscribes_then_preempts_exactly(weights):
    """The reference's oracle: a pool that reserve-fits one worst-case
    chain runs two requests under optimistic admission; their growth
    collides, the newer is preempted and recomputed, and both engines
    return the dense oracle with the same preemption count."""
    paged = dict(page_size=4, num_pages=7, max_pages_per_seq=8)
    jeng, peng = _pair(weights, paged, max_slots=2, admission="optimistic", prefix_sharing=False)
    jcfg, _ = _cfgs()
    pa, pb = [3, 141, 59, 7], [9, 10, 11, 12]
    streams = []
    for eng in (jeng, peng):
        a, b = eng.submit(pa, 12), eng.submit(pb, 12)
        eng.step()
        assert sum(s is not None for s in eng.slots) == 2  # oversubscribed
        _drain(eng, [a, b])
        streams.append((a.tokens, b.tokens))
        assert len(eng.free_pages) == paged["num_pages"] - 1
    assert streams[1] == streams[0] == (_oracle(jcfg, weights[0], pa, 12),
                                        _oracle(jcfg, weights[0], pb, 12))
    assert peng.preemptions == jeng.preemptions > 0
    assert peng.kv_resumes_recompute == jeng.kv_resumes_recompute > 0


def test_optimistic_preemption_preserves_prefix_sharing(weights):
    """A preempted request sharing prompt pages must not free them from
    under its sibling; its resume re-prefills prompt + generated."""
    paged = dict(page_size=2, num_pages=12, max_pages_per_seq=12)
    jeng, peng = _pair(weights, paged, max_slots=2, admission="optimistic")
    jcfg, _ = _cfgs()
    shared = [3, 141, 59, 7]
    streams = []
    for eng in (jeng, peng):
        a, b = eng.submit(shared, 10), eng.submit(shared, 10)
        _drain(eng, [a, b])
        streams.append((a.tokens, b.tokens))
        assert len(eng.free_pages) == paged["num_pages"] - 1
    want = _oracle(jcfg, weights[0], shared, 10)
    assert streams[1] == streams[0] == (want, want)
    assert peng.preemptions == jeng.preemptions


def test_optimistic_cancelled_victim_not_requeued(weights):
    """Eviction of an already-cancelled request is its teardown."""
    paged = dict(page_size=4, num_pages=7, max_pages_per_seq=8)
    jeng, peng = _pair(weights, paged, max_slots=2, admission="optimistic", prefix_sharing=False)
    streams = []
    for eng in (jeng, peng):
        a, b = eng.submit([3, 141, 59, 7], 12), eng.submit([9, 10, 11, 12], 12)
        for _ in range(2):
            eng.step()
        eng.cancel(b)
        _drain(eng, [a, b])
        assert b.done and not eng.queue
        streams.append(a.tokens)
        assert len(eng.free_pages) == paged["num_pages"] - 1
    assert streams[1] == streams[0]
    assert peng.preemptions == jeng.preemptions


CHURN_PAGED = dict(page_size=4, num_pages=14, max_pages_per_seq=16)


def _churn_jobs():
    """Seven requests for three slots on 13 allocatable pages: two share an
    8-token prefix, budgets differ so blocks down-bucket and finishes land
    mid-block, and together they need far more pages than the pool."""
    rs = np.random.RandomState(11)
    common = rs.randint(1, 512, size=8).tolist()
    jobs = []
    for i, n in enumerate((22, 18, 26, 9, 20, 14, 24)):
        tail = rs.randint(1, 512, size=2 + i).tolist()
        jobs.append((common + tail if i < 2 else tail + common[:3], n))
    return jobs


@pytest.fixture(scope="module")
def jax_churn_engine(weights):
    """One optimistic JAX engine for every (block, overlap, sampler) case:
    the flags select host-side scheduling over the same compiled
    programs, and the engine drains to idle between runs."""
    jparams, _ = weights
    jcfg, _ = _cfgs()
    return jax_engine.ServingEngine(
        jcfg, jparams, jax_tf.PagedConfig(**CHURN_PAGED, use_kernel=True), max_slots=3,
        decode_block=16, admission="optimistic",
    )


def _overload(pkg):
    """A controller whose limit cannot move with wall-clock queue waits (a
    setpoint no wait reaches), capped so the last submit is shed."""
    ov = _mod(pkg, "models.engine_overload")
    return ov, ov.OverloadConfig(target_queue_wait_s=1e9, max_queue=6)


def _churn(eng, pkg, jobs, sample_kw):
    """Run ``jobs`` through ``eng`` with a fresh flight recorder and
    overload controller; one request with a spent deadline and one past
    the queue cap are shed at the door.  Returns what must be equal."""
    flight = _mod(pkg, "utils.flight").FlightRecorder(capacity=100_000)
    ov, cfg = _overload(pkg)
    eng.flight = flight
    eng.overload = ov.OverloadController(eng.max_slots, cfg, flight=flight)
    pre, hits, discards = eng.preemptions, eng.overlap_hits, eng.overlap_discards
    sheds, reqs = [], []
    try:
        eng.submit([1, 2, 3], 4, deadline_s=0.0, **sample_kw)
    except ov.ShedError as e:
        sheds.append(e.kind)
    for i, (prompt, n) in enumerate(jobs):
        try:
            reqs.append(eng.submit(prompt, n, priority="high" if i == 3 else 1, tenant="t",
                                   **sample_kw))
        except ov.ShedError as e:
            sheds.append(e.kind)
    _drain(eng, reqs)
    reasons = collections.Counter(
        e["reason"] for e in flight.snapshot()["events"] if e["kind"] == "overlap.discard")
    snap = eng.overload.snapshot()
    return {
        "tokens": [r.tokens for r in reqs],
        "preemptions": eng.preemptions - pre,
        "overlap_hits": eng.overlap_hits - hits,
        "overlap_discards": eng.overlap_discards - discards,
        "discards_by_reason": dict(reasons),
        "sheds": sheds,
        "shed_ledger": (snap["sheds_total"], snap["sheds_by_kind"],
                        {t: (v["admitted"], v["shed"]) for t, v in snap["tenants"].items()}),
        "free_pages": len(eng.free_pages),
    }


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("block, overlap", [(1, 0), (1, 1), (16, 0), (16, 1)])
def test_optimistic_churn_equals_jax(weights, jax_churn_engine, block, overlap, sampled):
    """Tokens, preemptions, overlap hits and discards by reason, and the
    shed ledger equal the JAX engine's under optimistic admission."""
    jobs = _churn_jobs()
    sample_kw = dict(temperature=0.8, top_k=40) if sampled else {}
    jeng = jax_churn_engine
    jeng._decode_block, jeng._overlap_steps = block, overlap
    jeng._rng = jax.random.PRNGKey(5)
    want = _churn(jeng, PACKAGES[0], jobs, sample_kw)
    _, state = weights
    _, pcfg = _cfgs()
    peng = port_engine.ServingEngine(
        pcfg, state, port_tf.PagedConfig(**CHURN_PAGED), max_slots=3, decode_block=block,
        overlap_steps=overlap, admission="optimistic", rng=prng.PRNGKey(5), device="cpu",
    )
    got = _churn(peng, PACKAGES[1], jobs, sample_kw)
    assert got == want
    assert want["preemptions"] > 0, "the pool never forced a preemption"
    assert want["sheds"] == ["expired", "queue_full"]
    assert got["free_pages"] == CHURN_PAGED["num_pages"] - 1
    assert sum(got["discards_by_reason"].values()) == got["overlap_discards"]
    if overlap:
        assert got["overlap_hits"] + got["overlap_discards"] > 0


@pytest.mark.parametrize("block", [1, 16])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_limiter_held_head_equals_jax(weights, block, sampled):
    """With the overload limiter holding the queue head while slots are
    free, the port keeps the reference's decode-block gate (a free slot
    counts as admissible, so it steps one token at a time), and its
    tokens, greedy and sampled, and dispatch shapes equal the JAX
    engine's."""
    paged = dict(page_size=4, num_pages=40, max_pages_per_seq=12)
    jobs = [(p, n) for (p, _), n in zip(_churn_jobs(), (20, 18, 22, 17, 21))]
    sample_kw = dict(temperature=0.8, top_k=40) if sampled else {}
    streams, held = [], []
    for pkg, eng in zip(PACKAGES, _pair(weights, paged, max_slots=3, decode_block=block)):
        eng._rng = jax.random.PRNGKey(5) if pkg == PACKAGES[0] else prng.PRNGKey(5)
        ov = _mod(pkg, "models.engine_overload")
        # A setpoint no wait reaches and no additive increase: the limit
        # stays where it is set.
        eng.overload = ov.OverloadController(
            3, ov.OverloadConfig(target_queue_wait_s=1e9, aimd_increase=0.0))
        eng.overload.limit = 1.0
        reqs = [eng.submit(p, n, **sample_kw) for p, n in jobs]
        steps = 0
        while not all(r.done for r in reqs):
            eng.step()
            steps += 1
            assert steps < 2000, "engine failed to drain"
            if eng.queue and any(s is None for s in eng.slots):
                held.append(pkg)
        streams.append(([r.tokens for r in reqs], steps))
    assert streams[1] == streams[0]
    assert set(held) == set(PACKAGES), "the limiter never held the head"


def test_debug_state_keys_equal_jax(weights):
    """The engine snapshots the HTTP server reads have the reference's
    keys, with overload and the SLO plane on."""
    paged = dict(page_size=4, num_pages=16, max_pages_per_seq=8)
    jeng, peng = _pair(weights, paged, max_slots=2, admission="optimistic", overload=True,
                       slo=True)

    def keys(obj):
        return {k: keys(v) for k, v in obj.items()} if isinstance(obj, dict) else None

    for eng in (jeng, peng):
        eng.run([([1, 2, 3], 3)])
    for name in ("debug_state", "overload_state", "slo_state", "usage_state", "kvcache_state",
                 "handoff_state"):
        got = getattr(peng, name)()
        if name == "debug_state":
            assert got.pop("device")["device_steps"] == peng.device_steps  # the port's own
        assert keys(got) == keys(getattr(jeng, name)()), name
    assert keys(peng.profiler.snapshot()) == keys(jeng.profiler.snapshot())


# ------------------------------------------------------- the copied modules


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _flight(pkg, tmp_path):
    box = _mod(pkg, "utils.flight").FlightRecorder(capacity=4, name="box")
    for i in range(6):
        box.record(f"k{i % 2}", i=i, obj={"a": [1, 2]}, odd=object)
    snap = box.snapshot()
    for e in snap["events"]:
        e.pop("ts")
    return snap


def _failpoints(pkg, tmp_path):
    fp = _mod(pkg, "utils.failpoints")
    reg = fp.FailpointRegistry("t")
    reg.set_flight(_mod(pkg, "utils.flight").FlightRecorder(capacity=64))
    reg.arm_spec("engine.readback=corrupt:2*2;engine.submit=error*1;x.y=delay:0")
    fired = []
    for name in ("engine.readback", "engine.readback", "engine.readback", "x.y"):
        hit = reg.fire(name)
        fired.append(None if hit is None else (hit.mode, hit.arg))
    with pytest.raises(fp.FailpointError) as e:
        reg.fire("engine.submit")
    return {"fired": fired, "error": str(e.value), "snap": reg.snapshot(),
            "parsed": fp.parse_spec("a=error:1*3;b=hang")}


def _spans(pkg, tmp_path):
    sp = _mod(pkg, "utils.spans")
    rec = sp.SpanRecorder(capacity=3, name="engine")
    root = rec.reserve_id()
    for i, name in enumerate(("queue", "prefill", "decode")):
        rec.record_span(name, "trace-a", start_monotonic=10.0 + i, end_monotonic=10.5 + i,
                        parent_id=root, attrs={"rid": 1, "i": i})
    rec.record_span("request", "trace-a", start_monotonic=10.0, end_monotonic=13.0,
                    span_id=root, attrs={"outcome": "completed"})
    dump = rec.dump(trace_id="trace-a")
    # ``start`` converts each span's monotonic start to wall time with a
    # clock reading taken at dump time, so the two packages' values differ
    # by the time between their calls.  Each is held to the wall clock
    # (within 5 s) and to the spans' order instead of being compared.
    wall_now = time.time() - time.monotonic()
    mono = {"queue": 10.0, "prefill": 11.0, "decode": 12.0, "request": 10.0}
    starts = [(mono[s["name"]], s.pop("start")) for s in dump["spans"]]
    assert all(abs(t - (wall_now + m)) < 5.0 for m, t in starts), starts
    assert [t for _, t in sorted(starts)] == sorted(t for _, t in starts)
    for s in dump["spans"]:
        s.pop("start_unix", None)
        s.pop("ts", None)
    ctx = sp.parse_trace_context(sp.format_trace_context("abcd1234abcd1234", 7, 2, 1))
    # A bad id is replaced by a freshly minted one: only its shape compares.
    minted = sp.sanitize_trace_id("bad\nid")
    return {"dump": dump, "ctx": tuple(ctx), "minted": (len(minted), minted != "bad\nid"),
            "ok": sp.sanitize_trace_id("good-id")}


def _anomaly(pkg, tmp_path):
    an = _mod(pkg, "utils.anomaly")
    box = _mod(pkg, "utils.flight").FlightRecorder(capacity=32)
    seen = []
    mon = an.AnomalyMonitor(flight=box, on_incident=seen.append)
    mon.configure("m", warmup=5, z_threshold=3.0, sustain=2)
    for v in [1.0, 1.1, 0.9, 1.0, 1.05, 0.95, 1.0, 50.0, 60.0, 55.0, 1.0]:
        mon.observe("m", v)
    mon.report("engine.fenced", 1.0, reason="operator")
    snap = mon.snapshot()
    for inc in snap["incidents"]:
        for key in ("ts", "at", "flight_window"):
            inc.pop(key, None)
    return {"snap": snap, "seen": seen}


def _slo(pkg, tmp_path):
    slo = _mod(pkg, "utils.slo")
    clock = Clock()
    tracker = slo.SLOTracker(objectives=slo.default_objectives(ttft_target_s=0.5),
                             now=clock)
    for i in range(40):
        clock.t += 7.0
        tracker.record("availability", i % 9 != 0)
        tracker.record("ttft", i % 4 != 0)
    usage = slo.UsageMeter(max_tracked_tenants=2)
    for tenant in ("a", "b", "c", "a", ""):
        usage.record_request(tenant, prompt_tokens=5, decode_tokens=3, kv_page_seconds=0.5,
                             queue_wait_seconds=0.25)
    return {"slo": tracker.snapshot(), "totals": tracker.totals(), "usage": usage.snapshot()}


def _postmortem(pkg, tmp_path):
    pm = _mod(pkg, "utils.postmortem")
    box = _mod(pkg, "utils.flight").FlightRecorder(capacity=16)
    box.record("engine.fenced", reason="x")
    clock = Clock()
    cap = pm.PostmortemCapture("engine", str(tmp_path / pkg), flight=box,
                               state_fn=lambda: {"engine": {"queue_depth": 0}}, metrics=False,
                               now=clock)
    incident = {"metric": "engine.step_seconds", "observed": 9.0, "baseline": 1.0}
    paths = [cap.capture("incident", key="engine.step_seconds", incident=incident)]
    paths.append(cap.capture("incident", key="engine.step_seconds", incident=incident))
    clock.t += 3600.0
    paths.append(cap.capture("incident", key="engine.ttft_seconds", incident=incident))
    snap = cap.snapshot()
    snap["directory"] = os.path.relpath(snap["directory"], tmp_path / pkg)
    bundle = snap.pop("last_bundle")
    # Bundle names carry the wall time and a content digest: compare the
    # bundle's name prefix and its files.
    return {"published": [p is not None for p in paths], "snap": snap,
            "bundle": (os.path.basename(bundle).rsplit("-", 2)[0],
                       sorted(os.listdir(bundle)))}


def _engine_overload(pkg, tmp_path):
    ov = _mod(pkg, "models.engine_overload")
    Request = _mod(pkg, "models.engine_types").Request
    clock = Clock()
    ctl = ov.OverloadController(3, ov.OverloadConfig(max_queue=4, target_queue_wait_s=0.2),
                                now=clock)
    queue = [Request([1, 2], 4, rid=i, priority=p, tenant=t, submitted_at=clock.t,
                     deadline=(clock.t + 5.0) if i == 2 else None)
             for i, (p, t) in enumerate([(1, "a"), (2, "b"), (1, "a"), (0, "b")])]
    order = []
    while queue:
        idx = ctl.select_index(queue)
        req = queue.pop(idx)
        order.append(req.rid)
        clock.t += 0.3
        ctl.observe_admission(req, 0.3 * (len(order)))
        ctl.observe_itl(0.02)
        ctl.maybe_adjust()
        req.tokens = [0] * 4
        ctl.on_finish(req)
    sheds = []
    for depth in (0, 2, 4):
        try:
            ctl.check_admission(2, depth)
        except ov.ShedError as e:
            sheds.append((e.kind, round(e.retry_after_s, 6)))
            ctl.record_shed(None, e.kind, priority=2, tenant="b")
    late = Request([1], 8, rid=9, deadline=clock.t + 0.01, submitted_at=clock.t)
    return {"order": order, "sheds": sheds, "snap": ctl.snapshot(),
            "expired": ctl.expired(late, clock.t + 1.0), "infeasible": ctl.infeasible(late),
            "priorities": [ov.parse_priority(p) for p in ("high", "normal", "low", 0, "2")]}


def _engine_watchdog(pkg, tmp_path):
    wd_mod = _mod(pkg, "models.engine_watchdog")
    clock = Clock()
    fences = []
    wd = wd_mod.StepWatchdog(fences.append, clock=clock, warmup=2, min_deadline_s=1.0,
                             grace_deadline_s=30.0)
    checks = []
    for step, (wall, grace) in enumerate([(0.01, None), (0.02, "compile:block_1"), (0.01, None),
                                          (0.01, None)]):
        wd.step_started()
        if grace:
            wd.note_grace(grace)
            clock.t += 20.0
            checks.append(wd.check())
        clock.t += wall
        wd.step_finished(wall)
    wd.step_started()
    clock.t += 5.0
    checks.append(wd.check())
    snap = wd.snapshot()
    feed = wd_mod.ChipHealthFeed(lambda info: None, url="", device_paths=["/fake/dev/accel9"])
    feed_checks = [feed.check_once(), feed.check_once()]
    return {"checks": checks, "fences": fences, "snap": snap, "feed_checks": feed_checks,
            "feed": feed.snapshot(),
            "paths": wd_mod.visible_chip_paths({"TPU_VISIBLE_CHIPS": "0,2"}, root="/fake")}


MODULE_SCENARIOS = {
    "flight": _flight,
    "failpoints": _failpoints,
    "spans": _spans,
    "anomaly": _anomaly,
    "slo": _slo,
    "postmortem": _postmortem,
    "engine_overload": _engine_overload,
    "engine_watchdog": _engine_watchdog,
}


@pytest.mark.parametrize("name", list(MODULE_SCENARIOS))
def test_copied_module_matches_the_reference(name, tmp_path):
    scenario = MODULE_SCENARIOS[name]
    want, got = (json.loads(json.dumps(scenario(pkg, tmp_path), default=str))
                 for pkg in PACKAGES)
    assert got == want
