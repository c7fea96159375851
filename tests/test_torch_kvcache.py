"""The port's KV cache tiers (k8s_device_plugin_tpu_torch/models/
engine_kvcache.py) against the JAX engine's, on the CPU.

The reference's own suite (tests/test_engine_kvcache.py) runs here on both
engines side by side, from the same flax weights (converted for the port),
GPTConfig.tiny() in float32 at page 4: the JAX engine is this module's,
built as the session's ``shared_engine`` (tests/conftest.py), the port's a
twin built alike, both with ``racecheck`` on.  Token streams must be equal, and equal with the
tiers on and off; the tier counters (retained and host hits, restores,
reclaims, offloads, resumes restored and recomputed) must be equal on the
same traffic.  A churn workload on a pool small enough to preempt repeats
that at decode block 1 and 16, overlap 0 and 1, greedy and sampled under
one key.  Page rows must come back bit-identical from a host round trip,
int8 pools with their scale pools included.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.utils import prng

PAGED = dict(page_size=4, num_pages=32, max_pages_per_seq=8)
PROMPT = [3, 141, 59, 7]  # one full page: registrable


def _drain(eng, subs, guard=4000):
    while not all(r.done for r in subs):
        eng.step()
        guard -= 1
        assert guard > 0, "engine failed to drain"


def counters(eng) -> dict:
    """The tier counters both engines keep, by the reference's names."""
    names = ("kv_retained_hits", "kv_host_hits", "kv_restores", "kv_reclaims", "kv_offloads",
             "kv_resumes_restored", "kv_resumes_recompute", "kv_resume_restored_tokens",
             "kv_resume_recomputed_tokens", "preemptions")
    return {n: getattr(eng, n) for n in names}


@pytest.fixture(scope="module")
def jax_twin():
    """(cfg, params, JAX engine) of this module alone, built as the
    session's ``shared_engine`` (tests/conftest.py) is: GPTConfig.tiny() at
    max_seq 32, page 4, 2 slots, racecheck on.  Its own, so the counters
    the reference's suites read on the session engine stay theirs."""
    cfg = dataclasses.replace(jax_tf.GPTConfig.tiny(), max_seq=32)
    params = jax_tf.TransformerLM(cfg).init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, params, jax_engine.ServingEngine(
        cfg, params, jax_tf.PagedConfig(**PAGED), max_slots=2, racecheck=True)


@pytest.fixture(scope="module")
def port_twin(jax_twin):
    """The port's engine alike ``jax_twin``."""
    cfg, params, _ = jax_twin
    pcfg = dataclasses.replace(port_tf.GPTConfig.tiny(), max_seq=cfg.max_seq)
    state = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return port_engine.ServingEngine(pcfg, state, port_tf.PagedConfig(**PAGED), max_slots=2,
                                     racecheck=True, device="cpu")


@pytest.fixture()
def tiered(jax_twin, port_twin):
    """Both engines with both tiers on for one test, restored to the
    fixture default afterwards (retention off, tiers empty, pool whole)."""
    engines = (jax_twin[2], port_twin)
    for eng in engines:
        eng._kv_retain = True
        eng._kv_arena.budget_bytes = 8 << 20
    try:
        yield engines
    finally:
        for eng in engines:
            eng._kv_retain = False
            eng.kvcache_clear()
            eng._kv_arena.budget_bytes = 0
            eng._optimistic = False
            assert len(eng.free_pages) == eng.paged.num_pages - 1


def _keys(eng):
    """The same sampling key for either engine."""
    if isinstance(eng, jax_engine.ServingEngine):
        return eng._rep(jax.random.PRNGKey(3))
    return prng.PRNGKey(3)


def test_repeated_prefix_equivalence_greedy_and_sampled(tiered):
    """Streams equal with retention on and off, greedy and sampled, over a
    repeated prefix whose lifetimes never overlap; the warm run hits the
    retained tier, and both engines count the same hits."""
    got = []
    for eng in tiered:
        out = []
        for kw in ({}, {"temperature": 1.0}):
            eng.kvcache_clear()
            eng._rng = _keys(eng)
            seed = eng.run([(PROMPT, 6)], **kw)[0].tokens
            assert len(eng._kv_retained) >= 1, "finish did not retain the page"
            hits0 = eng.kv_retained_hits
            eng._rng = _keys(eng)
            warm = eng.run([(PROMPT, 6)], **kw)[0].tokens
            hits = eng.kv_retained_hits - hits0
            assert hits > 0, "warm run never hit the tier"
            eng._kv_retain = False
            eng.kvcache_clear()
            eng._rng = _keys(eng)
            ref = eng.run([(PROMPT, 6)], **kw)[0].tokens
            eng._kv_retain = True
            assert seed == ref == warm, (kw, seed, warm, ref)
            out.append((ref, hits))
        got.append(out)
    assert got[1] == got[0]


def test_host_offload_restore_roundtrip(tiered):
    """A reclaimed retained page offloads its rows; the next same-prefix
    request restores them into a fresh page (same stream, host hit,
    ``kvcache.restore`` flight event) and the restored page re-enters the
    trie.  On the port the restored page's rows equal the arena entry's
    bit for bit."""
    got = []
    for eng in tiered:
        c0 = counters(eng)
        ref = eng.run([(PROMPT, 6)])[0].tokens
        with eng._lock:
            freed = eng._kv_reclaim(len(eng._kv_retained))
        assert freed >= 1 and len(eng._kv_arena) >= 1
        assert len(eng.free_pages) == eng.paged.num_pages - 1
        key = ("prefix", -1, tuple(PROMPT))
        stored = eng._kv_arena.get(key, bump=False)["rows"]
        restores0 = len(eng.flight.window(kinds=["kvcache.restore"]))
        warm = eng.run([(PROMPT, 6)])[0].tokens
        assert len(eng.flight.window(kinds=["kvcache.restore"])) > restores0
        if eng is tiered[1]:
            page = eng._prefix_pages[(-1, tuple(PROMPT))]
            back = eng._kv_read_page_rows(page)
            for layer, pools in stored.items():
                for pool, rows in pools.items():
                    assert torch.equal(back[layer][pool], rows), (layer, pool)
        again = eng.run([(PROMPT, 6)])[0].tokens
        assert ref == warm == again
        got.append((ref, {k: v - c0[k] for k, v in counters(eng).items()}))
    assert got[1] == got[0]
    assert got[1][1]["kv_host_hits"] >= 1 and got[1][1]["kv_retained_hits"] >= 1


@pytest.mark.parametrize("quant_kv", [False, True], ids=["float", "int8"])
def test_page_rows_round_trip_bit_identical(jax_twin, quant_kv):
    """Every pool of every layer, the int8 scale pools included, reads to
    the host and writes back into other pages bit for bit (one gather and
    one in-place ``index_copy_`` per pool per layer), and the pool tensors
    are the same objects afterwards (a captured graph keeps reading
    them)."""
    cfg, params, _ = jax_twin
    pcfg = dataclasses.replace(port_tf.GPTConfig.tiny(), max_seq=cfg.max_seq, quant_kv=quant_kv)
    state = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    eng = port_engine.ServingEngine(pcfg, state, port_tf.PagedConfig(**PAGED), max_slots=2,
                                    kv_retain=True, kv_host_cache_mb=8, device="cpu")
    prompt = list(range(5, 17))  # three full pages
    ref = eng.run([(prompt, 5)])[0].tokens
    pages = [eng._prefix_pages[k] for k in sorted(eng._prefix_pages, key=lambda k: len(k[1]))]
    pools_before = [dict(eng.kv_pools(i)) for i in range(pcfg.num_layers)]
    assert set(pools_before[0]) == ({"pool_key", "pool_value", "pool_key_scale",
                                     "pool_value_scale"} if quant_kv
                                    else {"pool_key", "pool_value"})
    rows = eng._kv_read_pages_rows(pages)
    assert eng._kv_rows_nbytes(rows[0]) == sum(
        t[0].numel() * t.element_size() for p in pools_before for t in p.values())
    targets = [eng.free_pages[i] for i in range(len(pages))]
    eng._kv_write_page_rows(targets, rows)
    back = eng._kv_read_pages_rows(targets)
    for a, b in zip(rows, back):
        for layer in a:
            for pool in a[layer]:
                assert a[layer][pool].dtype == b[layer][pool].dtype
                assert torch.equal(a[layer][pool], b[layer][pool]), (layer, pool)
    for i in range(pcfg.num_layers):
        for name, t in eng.kv_pools(i).items():
            assert t is pools_before[i][name]
    # The offload/restore path proper: the stream is unchanged.
    with eng._lock:
        eng._kv_reclaim(len(eng._kv_retained))
    assert eng.run([(prompt, 5)])[0].tokens == ref
    assert eng.kv_restores >= 3


def _teardown_scenario(eng):
    """The reference's host-bookkeeping scenario: a freed id reallocated
    and re-registered with other content is never reachable through a
    stale trie link.  Returns what both engines must agree on, with the
    page ids as labels (each engine's pool hands out its own ids)."""
    ps = eng.paged.page_size
    toks = list(range(1, 2 * ps + 1))
    chunk2 = tuple(toks[ps:])
    seen = []
    eng._kv_retain = True
    try:
        with eng._lock:
            p1 = eng.free_pages.popleft()
            p2 = eng.free_pages.popleft()
            label = {p1: "p1", p2: "p2"}

            def labels(pages):
                return [label.get(p, p) for p in pages]

            eng._page_refs[p1] = 1
            eng._page_refs[p2] = 1
            eng._register_prefix(toks, [p1, p2], 2, None)
            seen.append(labels(eng._match_prefix(toks, 8, {})))
            eng._release_page(p1)
            eng._release_page(p2)
            seen.append(sorted(labels(eng._kv_retained)))
            seen.append(labels([eng._kv_pick_reclaim(frozenset())]))  # the leaf
            eng._kv_reclaim_page(p1)
            seen.append(labels(eng._match_prefix(toks, 8, {})))
            seen.append(((p1, chunk2) in eng._prefix_pages, bool(eng._page_keys.get(p2))))
            other = [t + 100 for t in toks]
            q1 = eng.free_pages.pop()
            seen.append(q1 == p1)
            eng._page_refs[q1] = 1
            eng._register_prefix(other, [q1], 1, None)
            seen.append((labels(eng._match_prefix(toks, 8, {})),
                         labels(eng._match_prefix(other, 8, {}))))
            eng._kv_retain = False
            eng._release_page(q1)
            seen.append((labels(eng._match_prefix(other, 8, {})), q1 in eng.free_pages))
            eng._kv_retain = True
            eng._kv_reclaim_page(p2)
    finally:
        eng._kv_retain = False
        eng.kvcache_clear()
    assert len(eng.free_pages) == eng.paged.num_pages - 1
    assert not eng._prefix_pages and not eng._page_refs
    return seen


def test_release_teardown_under_page_reallocation(jax_twin, port_twin):
    """Retain, leaf-first pick, parent reclaim killing the child's key, and
    a reallocated id: the same trie states on both engines."""
    want = _teardown_scenario(jax_twin[2])
    got = _teardown_scenario(port_twin)
    assert got == want
    assert want[0] == ["p1", "p2"] and want[2] == ["p2"] and want[3] == []
    assert want[5] is True and want[6] == ([], ["p1"])


def test_preempt_restore_resume_skips_prefill(tiered, monkeypatch):
    """Under optimistic admission with parked pool pages, a preempted
    request resumes by restore: no prefill re-runs, the stream equals the
    never-preempted decode, and the counters and ``engine.resume`` events
    agree on both engines."""
    jobs = [([3, 141, 59], 6), ([9, 10], 6)]
    got = []
    for eng in tiered:
        refs = [eng.run([job])[0].tokens for job in jobs]
        eng.kvcache_clear()
        eng._optimistic = True
        with eng._lock:
            parked = [eng.free_pages.pop() for _ in range(len(eng.free_pages) - 3)]
        calls: list[int] = []
        orig = eng._start_prefill
        monkeypatch.setattr(eng, "_start_prefill", lambda items, orig=orig: (
            calls.extend(r.rid for _, r, _, _ in items), orig(items))[1])
        c0 = counters(eng)
        subs = [eng.submit(p, n) for p, n in jobs]
        try:
            _drain(eng, subs)
        finally:
            monkeypatch.undo()
            eng._optimistic = False
            with eng._lock:
                eng.kvcache_clear()
                for page in parked:
                    eng.free_pages.append(page)
        delta = {k: v - c0[k] for k, v in counters(eng).items()}
        assert delta["preemptions"] > 0 and delta["kv_resumes_restored"] > 0
        assert delta["kv_resumes_recompute"] == 0
        assert all(n == 1 for n in collections.Counter(calls).values())
        assert [r.tokens for r in subs] == refs
        events = eng.flight.window(kinds=["engine.resume"])[-delta["kv_resumes_restored"]:]
        assert all(e["mode"] == "restored" and e["recomputed_tokens"] == 0 for e in events)
        got.append((refs, delta, [e["restored_tokens"] for e in events]))
    assert got[1] == got[0]


# --------------------------------------------------------------- the churn

CHURN_PAGED = dict(page_size=4, num_pages=14, max_pages_per_seq=16)


def _churn_cfgs():
    return (dataclasses.replace(jax_tf.GPTConfig.tiny(), max_seq=64, num_kv_heads=2),
            dataclasses.replace(port_tf.GPTConfig.tiny(), max_seq=64, num_kv_heads=2))


def _churn_jobs():
    """Seven requests for three slots on 13 allocatable pages (the
    admission suite's churn) and three repeats of the shared prefix."""
    rs = np.random.RandomState(11)
    common = rs.randint(1, 512, size=8).tolist()
    jobs = []
    for i, n in enumerate((22, 18, 26, 9, 20, 14, 24)):
        tail = rs.randint(1, 512, size=2 + i).tolist()
        jobs.append((common + tail if i < 2 else tail + common[:3], n))
    return jobs, jobs[:3]


@pytest.fixture(scope="module")
def churn_weights():
    jcfg, _ = _churn_cfgs()
    params = jax_tf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8), jnp.int32))["params"]
    return params, convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_churn_engine(churn_weights):
    """One optimistic JAX engine with both tiers for every case: the
    flags select host-side scheduling over the same compiled programs."""
    jcfg, _ = _churn_cfgs()
    return jax_engine.ServingEngine(
        jcfg, churn_weights[0], jax_tf.PagedConfig(**CHURN_PAGED, use_kernel=True), max_slots=3,
        decode_block=16, admission="optimistic", kv_retain=True, kv_host_cache_mb=8,
        racecheck=True,
    )


def _churn(eng, sample_kw):
    first, again = _churn_jobs()
    c0 = counters(eng)
    reqs = [eng.submit(p, n, **sample_kw) for p, n in first]
    _drain(eng, reqs)
    more = [eng.submit(p, n, **sample_kw) for p, n in again]
    _drain(eng, more)
    return ([r.tokens for r in reqs + more], {k: v - c0[k] for k, v in counters(eng).items()},
            len(eng.free_pages) + len(eng._kv_retained))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("block, overlap", [(1, 0), (1, 1), (16, 0), (16, 1)])
def test_tiered_churn_equals_jax(churn_weights, jax_churn_engine, block, overlap, sampled):
    """Preempting churn with both tiers on, and with them off: tokens and
    every tier counter equal the JAX engine's.  Greedy tokens are the same
    with the tiers on and off; sampled ones need not be (a recompute-resume
    samples its admission token again and splits the key, a restore does
    not), which is the reference's behaviour too."""
    sample_kw = dict(temperature=0.8, top_k=40) if sampled else {}
    jeng = jax_churn_engine
    _, pcfg = _churn_cfgs()
    runs = {}
    for retain, mb in ((True, 8), (False, 0)):
        jeng.kvcache_clear()
        jeng._kv_retain, jeng._kv_arena.budget_bytes = retain, int(mb * 1024 * 1024)
        jeng._decode_block, jeng._overlap_steps = block, overlap
        jeng._rng = jax.random.PRNGKey(5)
        want = _churn(jeng, sample_kw)
        peng = port_engine.ServingEngine(
            pcfg, churn_weights[1], port_tf.PagedConfig(**CHURN_PAGED), max_slots=3,
            decode_block=block, overlap_steps=overlap, admission="optimistic",
            kv_retain=retain, kv_host_cache_mb=mb, rng=prng.PRNGKey(5), racecheck=True,
            device="cpu",
        )
        got = _churn(peng, sample_kw)
        assert got == want, retain
        runs[retain] = want
    on, off = runs[True], runs[False]
    if not sampled:
        assert on[0] == off[0], "greedy tokens changed with the tiers"
    assert on[1]["preemptions"] > 0 and on[1]["kv_resumes_restored"] > 0
    assert on[1]["kv_retained_hits"] > 0
    assert off[1]["kv_resumes_recompute"] > 0 and off[1]["kv_resumes_restored"] == 0
    assert on[2] == off[2] == CHURN_PAGED["num_pages"] - 1
