"""The port's KV-arena snapshots (k8s_device_plugin_tpu_torch/models/
engine_snapshot.py) against the JAX package's, on the CPU.

The reference's suite (tests/test_engine_snapshot.py) runs on the port:
the file format (round trip, checksum, truncation, layout and params
refusals, bad magic, atomic write over the previous file) and the engine
wiring (save, restart, load, the corrupt and failpoint degradations, the
peer stream and its refusals, the save lock against a fence).  Beside it
the two packages meet: the same entries encode to the same bytes (float32,
int8 and bfloat16, which numpy holds only through ml_dtypes and the port
writes as raw 16-bit patterns under the reference's dtype name), a file
written by either engine loads into the other with the same keys and
rows, a joiner of either package warms from a donor of the other over
``GET /debug/snapshot``, and the warm restart's tokens and tier counters
equal the JAX engine's.  GPTConfig.tiny() in float32 at page 4; the JAX
engine is the module's own, built as the session's ``shared_engine``.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import dataclasses
import http.client
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import engine_snapshot as jax_snap
from k8s_device_plugin_tpu.models import http_server as jax_http
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu.utils import failpoints as jax_failpoints
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap
from k8s_device_plugin_tpu_torch.models import http_server as port_http
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.utils import failpoints

PAGED = dict(page_size=4, num_pages=32, max_pages_per_seq=8)
PROMPT = [3, 141, 59, 7]


# ------------------------------------------------------------- file format

DTYPES = {"float32": (torch.float32, np.float32), "int8": (torch.int8, np.int8),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _layout(dtype="float32"):
    pools = {"pool_key": {"shape": [4, 2, 3], "dtype": dtype},
             "pool_value": {"shape": [4, 2, 3], "dtype": dtype}}
    return {"page_size": 4, "layers": {"layer_0": dict(pools), "layer_1": dict(pools)}}


def _entries(layout, n=3, seed=0):
    """``n`` entries of seeded rows: (port entries of torch tensors, JAX
    entries of numpy arrays) holding the same bits."""
    rng = np.random.default_rng(seed)
    port, ref = {}, {}
    for i in range(n):
        key = ("prefix", -1, tuple(range(4 * (i + 1))))
        port[key], ref[key] = {}, {}
        for layer, pools in layout["layers"].items():
            port[key][layer], ref[key][layer] = {}, {}
            for pool, spec in pools.items():
                tdt, ndt = DTYPES[spec["dtype"]]
                vals = rng.standard_normal(tuple(spec["shape"])) * 40
                arr = vals.astype(np.float32).astype(ndt)
                ref[key][layer][pool] = arr
                t = torch.from_numpy(arr.view(np.int16)).view(tdt) if tdt == torch.bfloat16 \
                    else torch.from_numpy(arr)
                port[key][layer][pool] = t
    return port, ref


def _bits(t) -> bytes:
    return snap.host_bytes(t) if isinstance(t, torch.Tensor) else np.ascontiguousarray(t).tobytes()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_roundtrip_bit_identical(tmp_path, dtype):
    layout, path = _layout(dtype), str(tmp_path / "s.bin")
    entries, _ = _entries(layout)
    assert snap._write_snapshot(path, layout, "fp", entries) > 0
    header, loaded = snap.read_snapshot(path, layout, "fp")
    assert header["entries"] == len(entries)
    assert [k for k, _, _ in loaded] == list(entries)
    for key, rows, nbytes in loaded:
        assert nbytes == sum(t.numel() * t.element_size()
                             for pools in rows.values() for t in pools.values())
        for layer, pools in entries[key].items():
            for pool, t in pools.items():
                assert rows[layer][pool].dtype == t.dtype
                assert _bits(rows[layer][pool]) == _bits(t)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_file_bytes_equal_the_reference(tmp_path, dtype, monkeypatch):
    """One file format: the same entries written by both packages are the
    same bytes (the clock pinned for the header's creation time), and each
    package parses the other's file to the same keys and row bits."""
    layout = _layout(dtype)
    port_entries, ref_entries = _entries(layout)
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    p_path, j_path = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    snap._write_snapshot(p_path, layout, "fp", port_entries)
    jax_snap._write_snapshot(j_path, layout, "fp", ref_entries)
    assert open(p_path, "rb").read() == open(j_path, "rb").read()
    _, from_jax = snap.read_snapshot(j_path, layout, "fp")
    _, from_port = jax_snap.read_snapshot(p_path, layout, "fp")
    assert [k for k, _, _ in from_jax] == [k for k, _, _ in from_port] == list(ref_entries)
    for (key, prow, pn), (_, jrow, jn) in zip(from_jax, from_port):
        assert pn == jn
        for layer, pools in ref_entries[key].items():
            for pool, arr in pools.items():
                assert _bits(prow[layer][pool]) == _bits(jrow[layer][pool]) == _bits(arr)
                assert str(jrow[layer][pool].dtype) == dtype


def test_checksum_reject(tmp_path):
    layout, path = _layout(), str(tmp_path / "s.bin")
    snap._write_snapshot(path, layout, "fp", _entries(layout)[0])
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0xFF  # a bit inside the last entry's blob
    open(path, "wb").write(bytes(data))
    with pytest.raises(snap.SnapshotError, match="checksum"):
        snap.read_snapshot(path, layout, "fp")


def test_truncation_reject(tmp_path):
    layout, path = _layout(), str(tmp_path / "s.bin")
    size = snap._write_snapshot(path, layout, "fp", _entries(layout)[0])
    data = open(path, "rb").read()
    for keep in (size // 2, 7, 0):  # mid-entry, mid-magic, empty
        open(path, "wb").write(data[:keep])
        with pytest.raises(snap.SnapshotError):
            snap.read_snapshot(path, layout, "fp")


def test_layout_and_params_mismatch_refuse(tmp_path):
    layout, path = _layout(), str(tmp_path / "s.bin")
    snap._write_snapshot(path, layout, "fp", _entries(layout)[0])
    other = json.loads(json.dumps(layout))
    other["page_size"] = 8
    with pytest.raises(snap.SnapshotError, match="layout_mismatch"):
        snap.read_snapshot(path, other, "fp")
    with pytest.raises(snap.SnapshotError, match="params_mismatch"):
        snap.read_snapshot(path, layout, "deadbeef")
    _, loaded = snap.read_snapshot(path)
    assert len(loaded) == 3


def test_bad_magic_reject(tmp_path):
    path = str(tmp_path / "s.bin")
    open(path, "wb").write(b"NOTASNAPSHOT" * 4)
    with pytest.raises(snap.SnapshotError):
        snap.read_snapshot(path)


def test_write_is_atomic_over_previous(tmp_path):
    """A write that fails midway leaves the previous snapshot whole and no
    tempfile behind."""
    layout, path = _layout(), str(tmp_path / "s.bin")
    snap._write_snapshot(path, layout, "fp", _entries(layout, n=1)[0])
    bad = {("prefix", -1, (1,)): {"layer_0": {}}}  # missing pools -> KeyError
    with pytest.raises(KeyError):
        snap._write_snapshot(path, layout, "fp", bad)
    _, loaded = snap.read_snapshot(path, layout, "fp")
    assert len(loaded) == 1
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".kv_arena.")]


def test_donor_for_picks_the_reference_donor():
    """The warm-up donor is the one the reference (and the router's ring)
    picks."""
    from k8s_device_plugin_tpu.models.engine_snapshot import donor_for as ref_donor_for

    peers = [f"10.0.0.{i}:8000" for i in range(1, 7)]
    for joiner in ("10.0.0.9:8000", "10.0.0.3:8000", "host-a:1"):
        assert snap.donor_for(joiner, peers) == ref_donor_for(joiner, peers)
    assert snap.donor_for("a:1", ["a:1"]) is None


# --------------------------------------------------- engine integration


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


def _tiers_on(eng):
    eng._kv_retain = True
    eng._kv_arena.budget_bytes = 8 << 20


def _tiers_off(eng):
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
        _tiers_off(port_twin)


@pytest.fixture()
def jax_tiered(jax_twin):
    eng = jax_twin[2]
    _tiers_on(eng)
    try:
        yield eng
    finally:
        _tiers_off(eng)


def _warm(eng, prompt=PROMPT):
    """One request whose full-page prefix parks on the retained tier."""
    ref = eng.run([(prompt, 6)])[0].tokens
    assert len(eng._kv_retained) >= 1
    return ref


def _restart_warm(eng, path, save, load):
    """Warm, save, clear every tier (the restart), load, replay: what the
    two engines must agree on."""
    ref = _warm(eng)
    res = save(eng, path)
    assert res["ok"] and res["entries"] >= 1 and res["bytes"] > 0
    eng.kvcache_clear()
    assert len(eng._kv_arena) == 0
    loaded = load(eng, path)
    assert loaded["ok"] and loaded["restored"] == res["entries"]
    host0, restores0 = eng.kv_host_hits, eng.kv_restores
    warm = eng.run([(PROMPT, 6)])[0].tokens
    assert warm == ref, "restored pages must replay exactly"
    return (ref, res["entries"], eng.kv_host_hits - host0, eng.kv_restores - restores0)


def test_engine_snapshot_warm_restart_roundtrip(tiered, jax_tiered, tmp_path):
    """Save captures the retained device page, the restart clears every
    tier, the load rehydrates the arena, and the replay restores
    host->device: tokens, entries and host hits equal the JAX engine's."""
    got = _restart_warm(tiered, str(tmp_path / "p.snapshot"), snap.save_arena_snapshot,
                        snap.load_arena_snapshot)
    want = _restart_warm(jax_tiered, str(tmp_path / "j.snapshot"), jax_snap.save_arena_snapshot,
                         jax_snap.load_arena_snapshot)
    assert got == want
    assert got[2] >= 1 and got[3] >= 1
    assert tiered.flight.window(kinds=["engine.snapshot.loaded"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_written_by_one_engine_loads_into_the_other(tiered, jax_tiered, tmp_path,
                                                             direction):
    """A snapshot file written by either engine loads into the other with
    the same keys and row bits, and the loading engine replays the prefix
    from the arena with its own tokens."""
    path = str(tmp_path / snap.SNAPSHOT_NAME)
    writer, reader = (jax_tiered, tiered) if direction == "jax_to_port" else (tiered, jax_tiered)
    save = jax_snap.save_arena_snapshot if writer is jax_tiered else snap.save_arena_snapshot
    load = snap.load_arena_snapshot if reader is tiered else jax_snap.load_arena_snapshot
    reader_ref = _warm(reader)
    reader.kvcache_clear()
    _warm(writer)
    assert save(writer, path)["ok"]
    _, written = jax_snap.read_snapshot(path)
    loaded = load(reader, path)
    assert loaded["ok"] and loaded["restored"] == len(written) >= 1
    with reader._lock:
        arena = {k: e["rows"] for k, e in reader._kv_arena._entries.items() if k[0] == "prefix"}
    assert list(arena) == [k for k, _, _ in written]
    for key, rows, _ in written:
        for layer, pools in rows.items():
            for pool, arr in pools.items():
                assert _bits(arena[key][layer][pool]) == _bits(arr), (key, layer, pool)
    host0 = reader.kv_host_hits
    assert reader.run([(PROMPT, 6)])[0].tokens == reader_ref
    assert reader.kv_host_hits > host0


def test_engine_snapshot_corrupt_degrades_to_clean_cold(tiered, tmp_path):
    path = str(tmp_path / "kv_arena.snapshot")
    ref = _warm(tiered)
    assert snap.save_arena_snapshot(tiered, path)["ok"]
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])
    tiered.kvcache_clear()
    loaded = snap.load_arena_snapshot(tiered, path)
    assert not loaded["ok"] and loaded["restored"] == 0
    assert len(tiered._kv_arena) == 0, "a partial load is dropped whole"
    host0 = tiered.kv_host_hits
    assert tiered.run([(PROMPT, 6)])[0].tokens == ref
    assert tiered.kv_host_hits == host0


def test_engine_snapshot_failpoint_sites(tiered, tmp_path):
    """save=error aborts without touching the previous file; save=truncate
    writes the torn file a load degrades on; load=error reads as corrupt."""
    path = str(tmp_path / "kv_arena.snapshot")
    _warm(tiered)
    try:
        assert snap.save_arena_snapshot(tiered, path)["ok"]
        good = open(path, "rb").read()
        failpoints.arm("engine.snapshot.save", "error", count=1)
        assert not snap.save_arena_snapshot(tiered, path)["ok"]
        assert open(path, "rb").read() == good
        failpoints.arm("engine.snapshot.save", "truncate", arg="0.5", count=1)
        assert snap.save_arena_snapshot(tiered, path)["ok"]
        tiered.kvcache_clear()
        loaded = snap.load_arena_snapshot(tiered, path)
        assert not loaded["ok"] and len(tiered._kv_arena) == 0
        open(path, "wb").write(good)
        failpoints.arm("engine.snapshot.load", "error", count=1)
        loaded = snap.load_arena_snapshot(tiered, path)
        assert not loaded["ok"] and len(tiered._kv_arena) == 0
        assert snap.load_arena_snapshot(tiered, path)["ok"]
    finally:
        failpoints.disarm_all()


def test_engine_snapshot_missing_and_disabled(tiered, tmp_path):
    res = snap.load_arena_snapshot(tiered, str(tmp_path / "nope.snapshot"))
    assert not res["ok"] and res["reason"] == "missing"
    path = str(tmp_path / "kv_arena.snapshot")
    _warm(tiered)
    assert snap.save_arena_snapshot(tiered, path)["ok"]
    tiered.kvcache_clear()
    tiered._kv_arena.budget_bytes = 0
    res = snap.load_arena_snapshot(tiered, path)
    assert not res["ok"] and res["reason"] == "arena_disabled"
    tiered._kv_arena.budget_bytes = 8 << 20


# ------------------------------------------------------- peer warm join


def _served(eng, module=port_http, **kw):
    """An EngineServer over the engine; its loop thread owns the engine
    until stop() (the main thread takes it back)."""
    if eng._inflight_guard is not None:
        eng._inflight_guard._owner = None
    return module.EngineServer(eng, host="127.0.0.1", port=0, **kw).start()


def _get(port, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", "/debug/snapshot", headers=headers)
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), resp.read())
    conn.close()
    return out


def test_snapshot_stream_serve_fetch_and_refusals(tiered):
    """GET /debug/snapshot on the port's server: the stream parses through
    the disk verifier with the negotiation headers; a foreign fingerprint
    is refused (409) before any bytes; a Range fetch 416s; the fetch path
    round-trips into the arena and a joiner replays exactly."""
    ref = _warm(tiered)
    server = _served(tiered)
    try:
        with tiered._lock:
            layout = snap.snapshot_layout(tiered)
        fp = tiered.params_fingerprint
        lfp = snap.layout_fingerprint(layout)
        status, headers, wire = _get(server.port, {snap.LAYOUT_HEADER: lfp,
                                                   snap.PARAMS_HEADER: fp})
        assert status == 200
        assert headers[snap.LAYOUT_HEADER] == lfp and headers[snap.PARAMS_HEADER] == fp
        _, entries = snap._parse_snapshot(io.BytesIO(wire), layout, fp)
        assert len(entries) == int(headers[snap.ENTRIES_HEADER]) >= 1
        status, _, body = _get(server.port, {snap.PARAMS_HEADER: "deadbeef"})
        assert status == 409
        refused = json.loads(body)
        assert refused["layout"] == lfp and refused["params_fingerprint"] == fp
        assert _get(server.port, {snap.LAYOUT_HEADER: "00000000"})[0] == 409
        status, _, body = _get(server.port, {"Range": "bytes=100-"})
        assert status == 416 and b"whole-blob" in body
        res = snap.fetch_peer_snapshot(tiered, f"127.0.0.1:{server.port}")
        assert res["ok"] and res["restored"] == len(entries)
        served = tiered.flight.window(kinds=["engine.snapshot.served"])
        assert served and served[-1]["bytes"] == len(wire)
    finally:
        server.stop()
    tiered.kvcache_clear()
    _, parsed = snap._parse_snapshot(io.BytesIO(wire), layout, fp)
    assert snap._admit_entries(tiered, parsed) == len(entries)
    host0 = tiered.kv_host_hits
    assert tiered.run([(PROMPT, 6)])[0].tokens == ref
    assert tiered.kv_host_hits > host0


@pytest.mark.parametrize("donor_pkg", ["jax", "port"])
def test_peer_warm_up_across_packages(tiered, jax_tiered, donor_pkg):
    """A joiner of one package warms from a donor of the other over GET
    /debug/snapshot (the fingerprint negotiation passes), and replays the
    prefix from the arena with its own tokens."""
    donor, joiner = (jax_tiered, tiered) if donor_pkg == "jax" else (tiered, jax_tiered)
    fetch = snap.fetch_peer_snapshot if joiner is tiered else jax_snap.fetch_peer_snapshot
    joiner_ref = _warm(joiner)
    joiner.kvcache_clear()
    _warm(donor)
    server = _served(donor, jax_http if donor is jax_tiered else port_http)
    try:
        res = fetch(joiner, f"127.0.0.1:{server.port}")
    finally:
        server.stop()
    assert res["ok"] and res["restored"] >= 1
    host0 = joiner.kv_host_hits
    assert joiner.run([(PROMPT, 6)])[0].tokens == joiner_ref
    assert joiner.kv_host_hits > host0


def test_snapshot_peer_fetch_degrades_to_clean_cold(tiered):
    """A donor stream torn mid-transfer, a truncated read, a dial error and
    an unreachable peer each leave an empty arena; disarmed, the fetch
    succeeds; cold tokens stay exact."""
    ref = _warm(tiered)
    server = _served(tiered)
    peer = f"127.0.0.1:{server.port}"
    try:
        failpoints.arm("engine.snapshot.serve", "truncate", arg="0.5", count=1)
        res = snap.fetch_peer_snapshot(tiered, peer)
        assert not res["ok"] and res["restored"] == 0 and res["outcome"] == "corrupt"
        assert len(tiered._kv_arena) == 0
        failpoints.arm("engine.snapshot.fetch", "truncate", arg="0.4", count=1)
        res = snap.fetch_peer_snapshot(tiered, peer)
        assert not res["ok"] and len(tiered._kv_arena) == 0
        failpoints.arm("engine.snapshot.fetch", "error", count=1)
        res = snap.fetch_peer_snapshot(tiered, peer)
        assert not res["ok"] and len(tiered._kv_arena) == 0
        fails = tiered.flight.window(kinds=["engine.snapshot.fetch_failed"])
        assert len(fails) >= 3 and fails[-1]["peer"] == peer
        res = snap.fetch_peer_snapshot(tiered, "127.0.0.1:1")
        assert not res["ok"] and res["outcome"] == "unreachable"
        res = snap.fetch_peer_snapshot(tiered, peer)
        assert res["ok"] and res["restored"] >= 1
    finally:
        failpoints.disarm_all()
        jax_failpoints.disarm_all()
        server.stop()
    tiered.kvcache_clear()
    assert tiered.run([(PROMPT, 6)])[0].tokens == ref


def test_fence_and_periodic_save_serialize_on_one_lock(tiered, tmp_path):
    """Saves serialize on one lock (two concurrent saves, each slowed by
    the save failpoint, run back to back and the file parses whole), and a
    stale periodic save queued behind a fence's save is turned away."""
    _warm(tiered)
    if tiered._inflight_guard is not None:
        tiered._inflight_guard._owner = None
    server = port_http.EngineServer(tiered, host="127.0.0.1", port=0,
                                    snapshot_dir=str(tmp_path), snapshot_interval_s=0)
    path = str(tmp_path / snap.SNAPSHOT_NAME)
    try:
        failpoints.arm("engine.snapshot.save", "delay", arg="0.15", count=2)
        results: list = []
        threads = [threading.Thread(target=lambda trig=t: results.append(
            server.save_snapshot(trigger=trig))) for t in ("periodic", "manual")]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert time.monotonic() - t0 >= 0.3, "the saves overlapped"
        assert all(r["ok"] for r in results), results
        snap.read_snapshot(path)
        assert server.begin_fence("sick chip", source="chip_health")
        before = open(path, "rb").read()
        res = server.save_snapshot(trigger="periodic")
        assert not res["ok"] and res["reason"] == "fenced"
        assert open(path, "rb").read() == before
        assert server.save_snapshot(trigger="drain")["ok"]
        server.unfence()
    finally:
        failpoints.disarm_all()
        server._httpd.server_close()
