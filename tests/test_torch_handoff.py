"""The port's prefill/decode handoff and fleet fabric (k8s_device_plugin_
tpu_torch/models/engine_handoff.py) against the JAX package's, on the CPU.

The reference's suite (tests/test_engine_handoff.py) runs on the port: the
wire is the snapshot format, the roles' preconditions, a prefill probe
streaming its pages chunk by chunk, coverage walking the device tiers then
the arena, a decode-role engine skipping the prefill its restored pages
cover with the local-prefill oracle's tokens (greedy and sampled under one
key), the ``/v1/prefill`` and decode-gate HTTP contracts with their
failpoints and degradations, and the fabric digest, partial serve, pull
and drop.  Beside it the packages meet on the wire: a JAX prefill replica
hands a prompt to a PyTorch decode replica and the other way round, each
answering a unified engine's tokens with prefill skipped; fabric pulls run
between a JAX and a PyTorch replica; the digest bits equal the JAX
engine's for the same traffic; and the jax-free router with its
disaggregation policy (router/server.py, router/disagg.py) fronts a port
prefill replica and a port decode replica.  GPTConfig.tiny() in float32
at page 4; the JAX engine is the module's own, built as the
session's ``shared_engine``.
"""

import dataclasses
import io
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import engine_handoff as jax_handoff
from k8s_device_plugin_tpu.models import http_server as jax_http
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import engine_handoff as handoff
from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap
from k8s_device_plugin_tpu_torch.models import http_server as port_http
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.utils import failpoints, prng

PAGED = dict(page_size=4, num_pages=32, max_pages_per_seq=8)
PROMPT = [3, 141, 59, 7, 11, 5, 9, 2]  # two full pages, bucket 8


def _port_cfg_state(jax_twin):
    cfg, params, _ = jax_twin
    pcfg = dataclasses.replace(port_tf.GPTConfig.tiny(), max_seq=cfg.max_seq)
    return pcfg, convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models here run as fast on one CPU thread as on all of
    them, at half the CPU time: the suite's other workers keep the rest."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    pcfg, state = _port_cfg_state(jax_twin)
    return port_engine.ServingEngine(pcfg, state, port_tf.PagedConfig(**PAGED), max_slots=2,
                                     racecheck=True, device="cpu")


def _tiers_on(eng):
    eng._kv_retain = True
    eng._kv_arena.budget_bytes = 8 << 20


def _restore(eng):
    eng.role = "unified"
    eng._handoff_skip_covered = False
    eng._prefill_chunk = None
    eng._kv_retain = False
    eng.kvcache_clear()
    eng._kv_arena.budget_bytes = 0
    assert len(eng.free_pages) == eng.paged.num_pages - 1


@pytest.fixture()
def tiered(port_twin):
    _tiers_on(port_twin)
    try:
        yield port_twin
    finally:
        _restore(port_twin)


@pytest.fixture()
def jax_tiered(jax_twin):
    eng = jax_twin[2]
    _tiers_on(eng)
    try:
        yield eng
    finally:
        _restore(eng)


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _idle(eng):
    assert _wait(lambda: all(s is None for s in eng.slots) and not eng._pending
                 and not eng.queue), "engine never went idle"


def _served(eng, module=port_http, **kw):
    if eng._inflight_guard is not None:
        eng._inflight_guard._owner = None
    return module.EngineServer(eng, host="127.0.0.1", port=0, **kw).start()


def _post(port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.getheaders()), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())


# ------------------------------------------------------------ wire format


def test_wire_format_is_the_snapshot_format():
    """Preamble plus entries is what ``encode_snapshot`` streams and parses
    through the one verifier; the logits section is the reference's bytes
    and each package reads the other's."""
    layout = {"page_size": 4, "layers": {"l0": {"pool_key": {"shape": [2], "dtype": "float32"}}}}
    key = ("prefix", -1, (1, 2, 3, 4))
    entries = {key: {"l0": {"pool_key": torch.tensor([1.5, -2.0])}}}
    whole = b"".join(snap.encode_snapshot(layout, "fp", entries))
    split = snap.encode_preamble(layout, "fp", 1) + snap.encode_entry(layout, key, entries[key])
    for wire in (whole, split):
        header, parsed = snap._parse_snapshot(io.BytesIO(wire), layout, "fp")
        assert header["entries"] == 1 and parsed[0][0] == key
        assert parsed[0][1]["l0"]["pool_key"].tolist() == [1.5, -2.0]
    logits = np.linspace(-3, 3, 11, dtype=np.float32)
    section = handoff.encode_logits_section(logits)
    assert section == jax_handoff.encode_logits_section(logits)
    for reader in (handoff.read_logits_section, jax_handoff.read_logits_section):
        np.testing.assert_array_equal(reader(io.BytesIO(section)), logits)
        assert reader(io.BytesIO(b"")) is None
    with pytest.raises(snap.SnapshotError):
        handoff.read_logits_section(io.BytesIO(section[:-3]))


def test_role_validation(jax_twin):
    """Split roles refuse an engine without the tiers they live on, with
    the reference's messages."""
    pcfg, state = _port_cfg_state(jax_twin)
    paged = port_tf.PagedConfig(**PAGED)

    def build(**kw):
        return port_engine.ServingEngine(pcfg, state, paged, device="cpu", **kw)

    with pytest.raises(ValueError, match="role must be one of"):
        build(role="bogus")
    with pytest.raises(ValueError, match="kv_retain"):
        build(role="prefill")
    with pytest.raises(ValueError, match="kv_host_cache_mb"):
        build(role="decode", kv_retain=True)
    with pytest.raises(ValueError, match="prefix_sharing"):
        build(role="decode", kv_retain=True, kv_host_cache_mb=8, prefix_sharing=False)
    eng = build(role="decode", kv_retain=True, kv_host_cache_mb=8)
    assert eng.handoff_state()["skip_covered_prefill"] is True
    assert eng.set_role("prefill") and not eng.set_role("prefill")
    with pytest.raises(ValueError):
        eng.set_role("bogus")


# --------------------------------------------------- prefill-role streaming


def test_prefill_probe_streams_entries_chunk_by_chunk(tiered):
    """A chunked probe pushes each full page as its chunk completes,
    publishes it into the arena, and the streamed rows are the bytes the
    graft wrote into the device pages."""
    eng = tiered
    eng.role = "prefill"
    eng._prefill_chunk = 4
    tap = eng.handoff_begin(PROMPT, None)
    seen_incremental, entries = False, []
    try:
        for _ in range(50):
            eng.step()
            while True:
                e = tap.pop(0.0)
                if e is None:
                    break
                entries.append(e)
            if entries and not tap.req.done:
                seen_incremental = True
            if tap.req.done and tap.pushed <= len(entries):
                break
    finally:
        eng.handoff_end(tap)
    assert [k for k, _ in entries] == [("prefix", -1, tuple(PROMPT[:4])),
                                      ("prefix", -1, tuple(PROMPT))]
    assert seen_incremental, "entries must stream as chunks land"
    assert all(k in eng._kv_arena for k, _ in entries)
    assert eng.handoff_published_entries >= 2
    assert ("logits", -1, tuple(PROMPT)) in eng._kv_arena
    resident = eng.handoff_resident_entries(PROMPT, None)
    assert resident is not None
    for (key, rows), (rkey, rrows) in zip(entries, resident):
        assert key == rkey
        for layer, pools in rows.items():
            for pool, t in pools.items():
                assert torch.equal(t, rrows[layer][pool])
    assert eng.flight.window(kinds=["handoff.published"])


def test_handoff_coverage_walks_device_then_arena(tiered, jax_tiered):
    got = []
    for eng in (jax_tiered, tiered):
        seen = [eng.handoff_coverage(PROMPT, None)]
        eng.run([(PROMPT, 4)])
        seen.append(eng.handoff_coverage(PROMPT, None))
        with eng._lock:
            eng._kv_reclaim(len(eng._kv_retained))
        seen.append(eng.handoff_coverage(PROMPT, None))
        eng.kvcache_clear()
        seen.append(eng.handoff_coverage(PROMPT, None))
        got.append(seen)
    assert got[1] == got[0] == [(0, 2), (2, 2), (2, 2), (0, 2)]


# ------------------------------------------- decode-role restore + skip


def test_decode_role_skips_covered_prefill_bit_identical(tiered):
    """A decode-role engine admitting a handed-off prefix restores the
    pages, skips the covered chunks (the seeded dense cache stands in for
    them) and emits the local-prefill oracle's tokens, greedy and
    sampled."""
    eng = tiered
    eng._prefill_chunk = 4
    ref = eng.run([(PROMPT, 6)])[0].tokens

    def reseed():
        eng._rng = prng.PRNGKey(42)
        eng._mark_state_dirty()

    reseed()
    ref_sampled = eng.run([(PROMPT, 6)], temperature=0.7, top_k=40)[0].tokens
    with eng._lock:
        eng._kv_reclaim(len(eng._kv_retained))
        layout = snap.snapshot_layout(eng)
    fp = eng.params_fingerprint
    resident = eng.handoff_resident_entries(PROMPT, None)
    wire = snap.encode_preamble(layout, fp, len(resident)) + b"".join(
        snap.encode_entry(layout, k, r) for k, r in resident)
    eng.kvcache_clear()
    _, parsed = snap._parse_snapshot(io.BytesIO(wire), layout, fp)
    assert snap._admit_entries(eng, parsed) == 2
    eng.role = "decode"
    eng._handoff_skip_covered = True
    skipped0, restores0 = eng.handoff_skipped_tokens, eng.kv_restores
    assert eng.run([(PROMPT, 6)])[0].tokens == ref
    assert eng.handoff_skipped_tokens > skipped0, "prefill was not skipped"
    assert eng.kv_restores > restores0, "pages were not restored"
    reseed()
    assert eng.run([(PROMPT, 6)], temperature=0.7, top_k=40)[0].tokens == ref_sampled


def test_decode_role_local_prefill_fallback_unchanged(tiered):
    eng = tiered
    prompt = [9, 8, 7, 6, 5, 4, 3, 2]
    ref = eng.run([(prompt, 5)])[0].tokens
    eng.kvcache_clear()
    eng.role = "decode"
    eng._handoff_skip_covered = True
    skipped0 = eng.handoff_skipped_tokens
    assert eng.run([(prompt, 5)])[0].tokens == ref
    assert eng.handoff_skipped_tokens == skipped0


# ----------------------------------------------------- HTTP surfaces


def test_v1_prefill_serves_wire_and_decode_gate_degrades(tiered):
    """role=prefill: /v1/prefill streams a parse-clean body with the logits
    section (409 on a foreign fingerprint) and /generate answers 409.
    role=decode: /generate with no locator is 409 + X-Prefill-Needed, an
    unreachable locator degrades to local prefill with the oracle tokens,
    the LOCAL sentinel dials nothing, a resident prompt serves and a cold
    one is refused without a probe."""
    eng = tiered
    ref = eng.run([(PROMPT, 5)])[0].tokens
    eng.kvcache_clear()
    eng.role = "prefill"
    server = _served(eng)
    try:
        with eng._lock:
            layout = snap.snapshot_layout(eng)
        fp = eng.params_fingerprint
        status, headers, wire = _post(server.port, "/v1/prefill", {"prompt": PROMPT},
                                      {snap.LAYOUT_HEADER: snap.layout_fingerprint(layout),
                                       snap.PARAMS_HEADER: fp})
        assert status == 200 and headers[snap.ENTRIES_HEADER] == "2"
        buf = io.BytesIO(wire)
        _, entries = snap._parse_snapshot(buf, layout, fp)
        assert len(entries) == 2
        logits = handoff.read_logits_section(buf)
        assert logits is not None and logits.shape == (eng.cfg.vocab_size,)
        assert _wait(lambda: eng.handoff_serves == 1)
        assert eng.handoff_served_entries == 2
        status, _, _ = _post(server.port, "/v1/prefill", {"prompt": PROMPT},
                             {snap.PARAMS_HEADER: "deadbeef"})
        assert status == 409
        status, _, body = _post(server.port, "/generate", {"prompt": PROMPT, "max_new_tokens": 2})
        assert status == 409 and b"prefill" in body

        _idle(eng)
        eng.kvcache_clear()
        eng.role = "decode"
        eng._handoff_skip_covered = True
        status, headers, _ = _post(server.port, "/generate",
                                   {"prompt": PROMPT, "max_new_tokens": 5})
        assert status == 409 and headers.get(handoff.PREFILL_NEEDED_HEADER) == "2"
        assert eng.handoff_refusals == 1
        status, _, body = _post(server.port, "/generate", {"prompt": PROMPT, "max_new_tokens": 5},
                                {handoff.HANDOFF_SOURCE_HEADER: "127.0.0.1:1"})
        assert status == 200 and json.loads(body)["tokens"] == ref
        assert eng.handoff_fetch_failures == 1
        fails = eng.flight.window(kinds=["handoff.fetch_failed"])
        assert fails and fails[-1]["outcome"] == "unreachable"
        status, _, body = _post(server.port, "/generate", {"prompt": PROMPT, "max_new_tokens": 5},
                                {handoff.HANDOFF_SOURCE_HEADER: handoff.HANDOFF_LOCAL})
        assert status == 200 and json.loads(body)["tokens"] == ref
        assert eng.handoff_fetch_failures == 1
        status, _, _ = _post(server.port, "/v1/prefill", {"prompt": PROMPT})
        assert status == 200
        status, _, body = _post(server.port, "/v1/prefill", {"prompt": [5] * len(PROMPT)})
        assert status == 409 and b"resident-only" in body
        refused = eng.flight.window(kinds=["fabric.serve_refused"])
        assert refused and refused[-1]["role"] == "decode"
        state = _get_json(server.port, "/debug/disagg")
        assert state["role"] == "decode"
        assert state["refusals"] == 1 and state["fetch_failures"] == 1
    finally:
        server.stop()
        _idle(eng)


def test_handoff_serve_failpoints_tear_the_stream(tiered):
    """serve=error answers 503; serve=truncate tears the stream so the parse
    raises; a fetch of the torn stream admits nothing and leaves the
    serving arena as it was."""
    eng = tiered
    eng.role = "prefill"
    eng.run([(PROMPT, 4)])
    server = _served(eng)
    try:
        with eng._lock:
            layout = snap.snapshot_layout(eng)
        fp = eng.params_fingerprint
        failpoints.arm("engine.handoff.serve", "error", count=1)
        assert _post(server.port, "/v1/prefill", {"prompt": PROMPT})[0] == 503
        failpoints.arm("engine.handoff.serve", "truncate", arg="0.5", count=1)
        status, _, wire = _post(server.port, "/v1/prefill", {"prompt": PROMPT})
        assert status == 200
        with pytest.raises(snap.SnapshotError):
            snap._parse_snapshot(io.BytesIO(wire), layout, fp)
        failpoints.arm("engine.handoff.serve", "truncate", arg="0.5", count=1)
        arena_before = len(eng._kv_arena)
        res = handoff.fetch_prefill(eng, f"127.0.0.1:{server.port}", PROMPT)
        assert not res["ok"] and res["outcome"] == "corrupt"
        assert len(eng._kv_arena) == arena_before
    finally:
        failpoints.disarm_all()
        server.stop()
        _idle(eng)


def test_summary_and_debug_state_carry_role(tiered):
    eng = tiered
    eng.role = "decode"
    server = _served(eng)
    try:
        assert _get_json(server.port, "/debug/state?summary=1")["role"] == "decode"
        state = _get_json(server.port, "/debug/state")
        assert state["engine"]["config"]["role"] == "decode"
        assert state["engine"]["disagg"]["role"] == "decode"
    finally:
        server.stop()


# ------------------------------------------------------------ fleet fabric


def test_fabric_digest_advertises_resident_prefixes(tiered, jax_tiered):
    """The bloom covers the cumulative full-page prefixes the replica can
    serve, is version-cached, is None when it cannot serve pulls, and its
    bits equal the JAX engine's on the same traffic."""
    from k8s_device_plugin_tpu_torch.utils.prefixbloom import PrefixBloom

    wires = []
    for eng in (jax_tiered, tiered):
        eng.kvcache_clear()
        eng.run([(PROMPT, 3)])
        wires.append(eng.fabric_digest())
    wire = wires[1]
    assert wire == wires[0]
    assert wire["page_size"] == 4 and wire["count"] >= 2
    bloom = PrefixBloom.from_wire(wire)
    assert bloom.contains(-1, tuple(PROMPT[:4])) and bloom.contains(-1, tuple(PROMPT))
    builds = tiered.fabric_digest_builds
    assert tiered.fabric_digest() is wire
    assert tiered.fabric_digest_builds == builds
    tiered.prefix_sharing = False
    try:
        assert tiered.fabric_digest() is None
    finally:
        tiered.prefix_sharing = True


def test_fabric_digest_invalidated_when_graft_unpends_pages(tiered):
    """A digest built mid-prefill sees only pending pages (cached empty);
    the graft invalidates it."""
    from k8s_device_plugin_tpu_torch.utils.prefixbloom import PrefixBloom

    eng = tiered
    eng._prefill_chunk = 4
    prompt = [3, 141, 59, 265, 35, 7, 7, 3, 1, 2, 9, 4]  # three full pages
    req = eng.submit(prompt, 2)
    eng.step()
    mid = eng.fabric_digest()
    assert mid is not None and mid["count"] == 0
    assert eng.fabric_digest() is mid
    for _ in range(200):
        if req.done:
            break
        eng.step()
    assert req.done
    done = eng.fabric_digest()
    assert done is not mid and done["count"] >= 3
    bloom = PrefixBloom.from_wire(done)
    for pages in (1, 2, 3):
        assert bloom.contains(-1, tuple(prompt[: pages * 4]))


def test_fabric_partial_serve_stops_at_resident_coverage(tiered):
    """A resident-only serve of a longer prompt streams exactly the covered
    leading pages and runs no probe."""
    eng = tiered
    eng.run([(PROMPT, 3)])
    server = _served(eng)
    try:
        with eng._lock:
            layout = snap.snapshot_layout(eng)
        fp = eng.params_fingerprint
        serves0, published0 = eng.handoff_serves, eng.handoff_published_entries
        status, headers, wire = _post(server.port, "/v1/prefill",
                                      {"prompt": PROMPT + [13, 2, 5, 8]},
                                      {handoff.FABRIC_RESIDENT_ONLY_HEADER: "1"})
        assert status == 200 and headers[snap.ENTRIES_HEADER] == "2"
        _, entries = snap._parse_snapshot(io.BytesIO(wire), layout, fp)
        assert [e[0] for e in entries] == [("prefix", -1, tuple(PROMPT[:4])),
                                           ("prefix", -1, tuple(PROMPT))]
        assert _wait(lambda: eng.handoff_serves == serves0 + 1)
        assert eng.handoff_published_entries == published0
    finally:
        server.stop()


def test_fabric_pull_and_drop_roundtrip_over_wire(tiered):
    """``fabric_pull`` admits the owner's pages into the arena through the
    /v1/prefill wire; ``fabric_drop`` releases exactly those host copies
    while the trie-resident pages keep serving."""
    eng = tiered
    eng.run([(PROMPT, 3)])
    server = _served(eng)
    try:
        result = eng.fabric_pull(f"127.0.0.1:{server.port}", PROMPT)
        assert result["ok"] and result["restored"] == 2 and eng.fabric_pulls == 1
        assert ("prefix", -1, tuple(PROMPT)) in eng._kv_arena
        pulled = eng.flight.window(kinds=["fabric.pulled"])
        assert pulled and pulled[-1]["restored"] == 2
        assert eng.fabric_drop(PROMPT) == {"ok": True, "dropped": 2}
        assert eng.fabric_drops == 1 and ("prefix", -1, tuple(PROMPT)) not in eng._kv_arena
        status, _, _ = _post(server.port, "/v1/prefill", {"prompt": PROMPT},
                             {handoff.FABRIC_RESIDENT_ONLY_HEADER: "1"})
        assert status == 200
        state = _get_json(server.port, "/debug/fabric")
        assert state["enabled"] and state["advertised_roots"] >= 2
        assert state["pulls"] == 1 and state["drops"] == 1
    finally:
        server.stop()


# ------------------------------------------------------ across packages


@pytest.mark.parametrize("prefill_pkg", ["jax", "port"])
def test_handoff_across_packages(tiered, jax_tiered, prefill_pkg):
    """A prefill replica of one package hands a prompt to a decode replica
    of the other over /v1/prefill: the decode side answers a unified
    engine's tokens with its prefill skipped (the shipped logits admit it
    with no prefill at all)."""
    pre, dec = (jax_tiered, tiered) if prefill_pkg == "jax" else (tiered, jax_tiered)
    ref = dec.run([(PROMPT, 6)])[0].tokens  # unified, local prefill
    assert ref == pre.run([(PROMPT, 6)])[0].tokens
    for eng in (pre, dec):
        eng.kvcache_clear()
    pre.role = "prefill"
    dec.role = "decode"
    dec._handoff_skip_covered = True
    pre_srv = _served(pre, jax_http if pre is jax_tiered else port_http)
    dec_srv = _served(dec, jax_http if dec is jax_tiered else port_http)
    try:
        before = _get_json(dec_srv.port, "/debug/disagg")
        skipped0, admits0 = dec.handoff_skipped_tokens, dec.handoff_noprefill_admits
        status, _, body = _post(dec_srv.port, "/generate", {"prompt": PROMPT, "max_new_tokens": 6},
                                {handoff.HANDOFF_SOURCE_HEADER: f"127.0.0.1:{pre_srv.port}"})
        assert status == 200, body
        assert json.loads(body)["tokens"] == ref
        state = _get_json(dec_srv.port, "/debug/disagg")
        assert {k: state[k] - before[k] for k in ("fetches", "fetch_failures",
                                                   "fetched_entries")} == {
            "fetches": 1, "fetch_failures": 0, "fetched_entries": 2}
        assert dec.handoff_skipped_tokens - skipped0 == len(PROMPT)
        assert dec.handoff_noprefill_admits - admits0 == 1
        assert _wait(lambda: pre.handoff_serves >= 1)
        _idle(pre)
        _idle(dec)
    finally:
        pre_srv.stop()
        dec_srv.stop()


@pytest.mark.parametrize("owner_pkg", ["jax", "port"])
def test_fabric_pull_across_packages(tiered, jax_tiered, owner_pkg):
    """A replica pulls another package's resident prefix into its arena
    (the fabric verb), and the pulled pages replay its own tokens."""
    owner, puller = (jax_tiered, tiered) if owner_pkg == "jax" else (tiered, jax_tiered)
    ref = puller.run([(PROMPT, 4)])[0].tokens
    puller.kvcache_clear()
    owner.run([(PROMPT, 4)])
    srv = _served(owner, jax_http if owner is jax_tiered else port_http)
    try:
        res = puller.fabric_pull(f"127.0.0.1:{srv.port}", PROMPT)
    finally:
        srv.stop()
    assert res["ok"] and res["restored"] == 2
    host0 = puller.kv_host_hits
    assert puller.run([(PROMPT, 4)])[0].tokens == ref
    assert puller.kv_host_hits - host0 == 2


def test_router_splits_long_prompts_across_port_replicas(jax_twin):
    """The jax-free router with its disaggregation policy in front of one
    port prefill replica and one port decode replica: a long prompt splits
    (the decode replica pulls the prefix from the prefill replica), a
    short one runs locally, and both answer a unified port replica's
    tokens."""
    from k8s_device_plugin_tpu.router.disagg import DisaggConfig
    from k8s_device_plugin_tpu.router.server import RouterServer

    pcfg, state = _port_cfg_state(jax_twin)

    def build(role):
        return port_engine.ServingEngine(
            pcfg, state, port_tf.PagedConfig(**PAGED), max_slots=2, kv_retain=True,
            kv_host_cache_mb=8, role=role, device="cpu")

    unified = build("unified")
    long_prompt = list(range(40, 56))  # four full pages
    short = [7, 8, 9]
    refs = {tuple(p): unified.run([(p, 6)])[0].tokens for p in (long_prompt, short)}
    pre, dec = build("prefill"), build("decode")
    pre_srv, dec_srv = _served(pre), _served(dec)
    pre_name, dec_name = f"127.0.0.1:{pre_srv.port}", f"127.0.0.1:{dec_srv.port}"
    router = RouterServer(
        [dec_name], host="127.0.0.1", port=0, poll_interval_s=0.1, breaker_open_s=0.3,
        backoff_base_s=0.02, backoff_max_s=0.2, hedge=False, upstream_timeout_s=30.0,
        request_timeout_s=60.0, disagg=True,
        disagg_config=DisaggConfig(threshold_tokens=8, hot_threshold_tokens=8),
        prefill_replicas=[pre_name],
    ).start()
    try:
        assert _wait(lambda: router.replicas[pre_name].reachable
                     and router.replicas[dec_name].reachable
                     and router.replicas[pre_name].role == "prefill", timeout=20)
        for prompt in (long_prompt, short):
            status, _, body = _post(router.port, "/generate",
                                    {"prompt": prompt, "max_new_tokens": 6})
            assert status == 200, body
            assert json.loads(body)["tokens"] == refs[tuple(prompt)]
        assert pre.handoff_serves == 1 and dec.handoff_fetches == 1
        assert dec.handoff_fetch_failures == 0
        assert dec.handoff_skipped_tokens >= len(long_prompt)
        assert pre_name not in router.ring.nodes
    finally:
        router.stop()
        pre_srv.stop()
        dec_srv.stop()
