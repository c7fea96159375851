"""Crash-safe warm restart of the KV host arena, the snapshot wire
format, and the params fingerprint.

Counterpart of the reference's ``models/engine_snapshot.py``, byte for
byte: the ``MAGIC | version | header | entries`` stream is the file
written to ``--snapshot-dir`` (atomically, over the previous one), the
body of ``GET /debug/snapshot`` (peer warm-up) and of ``POST
/v1/prefill`` (the handoff), so a JAX replica loads what a PyTorch one
wrote and the other way round.  What is saved: every ``("prefix", root,
tokens)`` arena entry plus the retained device pages read back by their
cumulative prefix (resume snapshots are keyed to request ids of a dying
process and stay out).  The header pins the page-row layout and the
params fingerprint and each entry carries its CRC32; a corrupt, truncated
or foreign snapshot loads as a clean cold start (``outcome=corrupt`` /
``layout_mismatch`` / ``params_mismatch``), never a poisoned cache.

bfloat16 rows travel as their raw 16-bit patterns under the dtype name
``bfloat16`` (numpy's ml_dtypes name, which the reference writes); rows
are CPU tensors here, so numpy never has to hold one.  Device pages are
read on the engine's owner thread (``on_owner``), never under the engine
lock held by another thread.

Failpoint sites: ``engine.snapshot.save`` (``error`` aborts the save,
``truncate[:fraction]`` tears the written file), ``engine.snapshot.load``
(``error``, ``truncate``), ``engine.snapshot.serve`` (donor side) and
``engine.snapshot.fetch`` (joiner side).

``params_fingerprint`` takes the float32 state dict in flax names
(``convert.flax_to_state_dict`` or ``init_params``) and hashes it as the
reference hashes the flax tree: jax's leaf order (keys sorted at every
level), ``keystr`` paths, shapes and dtypes, plus the first bytes of the
first leaves, so both engines built from one tree answer the same value.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import time
import zlib
from typing import Iterator, Mapping, Optional

import torch

from ..utils import failpoints
from ..utils.ring import donor_for  # noqa: F401  (re-exported: the warm-up donor)

MAGIC = b"TPUKVSN1"
VERSION = 1
SNAPSHOT_NAME = "kv_arena.snapshot"

# Peer-transfer negotiation headers (GET /debug/snapshot, POST /v1/prefill).
LAYOUT_HEADER = "X-Snapshot-Layout"
PARAMS_HEADER = "X-Snapshot-Params"
ENTRIES_HEADER = "X-Snapshot-Entries"

# Per-leaf byte cap on the params fingerprint sample, and how many leaves
# are sampled (the reference's constants).
_FP_SAMPLE_BYTES = 4096
_FP_SAMPLE_LEAVES = 4

_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.int8: "int8", torch.int32: "int32", torch.int64: "int64",
}


_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


class SnapshotError(RuntimeError):
    """Any parse or verify failure; the load call site turns it into the
    clean cold start."""


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under numpy's (and jax's) name."""
    return _DTYPE_NAMES[dtype]


def _resolve_dtype(name: str) -> torch.dtype:
    """A torch dtype from its serialized name (bfloat16 included)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise SnapshotError(f"unsupported dtype {name!r}") from None


def host_bytes(t: torch.Tensor) -> bytes:
    """A tensor's raw little-endian bytes, read on the host (bfloat16 as
    its 16-bit patterns, which is how numpy's ml_dtypes stores it)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def params_fingerprint(params: Mapping[str, torch.Tensor]) -> str:
    """CRC32 over every leaf's (keystr path, shape, dtype) in jax's leaf
    order, plus the first bytes of the first few leaves: the reference's
    ``params_fingerprint`` of the flax tree this state dict flattens."""
    crc = 0
    leaves = sorted(params.items(), key=lambda kv: tuple(kv[0].split(".")))
    for i, (name, leaf) in enumerate(leaves):
        path = "".join(f"[{key!r}]" for key in name.split("."))
        desc = f"{path}|{tuple(leaf.shape)}|{dtype_name(leaf.dtype)}"
        crc = zlib.crc32(desc.encode(), crc)
        if i < _FP_SAMPLE_LEAVES:
            flat = leaf.reshape(-1)
            n = max(1, _FP_SAMPLE_BYTES // flat.element_size())
            crc = zlib.crc32(host_bytes(flat[:n]), crc)
    return f"{crc:08x}"


def snapshot_layout(engine) -> dict:
    """The page-row layout of the engine's pools, under the reference's
    layer and pool names: page size plus, per layer, each pool's shape and
    dtype of ONE page's rows.  A tensor-parallel engine's rows are logical
    (every kv head: its host rows are gathered whole), so the layout is the
    unsharded engine's."""
    layers: dict[str, dict] = {}
    tp = getattr(engine, "tp_size", 1)
    for i, layer in enumerate(engine._layer_names):
        pools = engine.kv_pools(i)
        layers[layer] = {}
        for name in sorted(engine._kv_pool_names(pools)):
            shape = [int(d) for d in pools[name].shape[1:]]
            shape[1] *= tp  # [page_size, kv_heads, ...]
            layers[layer][name] = {"shape": shape, "dtype": dtype_name(pools[name].dtype)}
    return {"page_size": int(engine.paged.page_size), "layers": layers}


def layout_fingerprint(layout: dict) -> str:
    """Short stable fingerprint of a page-row layout (what the negotiation
    headers carry)."""
    blob = json.dumps(layout, sort_keys=True, separators=(",", ":")).encode()
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


def _entry_blob(rows: dict, layout: dict) -> bytes:
    """One entry's arrays concatenated in layout order."""
    parts: list[bytes] = []
    for layer, pools in layout["layers"].items():
        for pool in pools:
            parts.append(host_bytes(rows[layer][pool]))
    return b"".join(parts)


def _split_blob(blob: bytes, layout: dict) -> dict:
    """One entry's blob back into layer -> pool -> tensor, in layout order."""
    rows: dict[str, dict[str, torch.Tensor]] = {}
    offset = 0
    for layer, pools in layout["layers"].items():
        rows[layer] = {}
        for pool, spec in pools.items():
            dtype = _resolve_dtype(spec["dtype"])
            shape = tuple(spec["shape"])
            count = 1
            for d in shape:
                count *= d
            nbytes = count * torch.empty((), dtype=dtype).element_size()
            chunk = blob[offset : offset + nbytes]
            if len(chunk) != nbytes:
                raise SnapshotError("entry blob shorter than its layout")
            rows[layer][pool] = torch.frombuffer(bytearray(chunk), dtype=dtype).reshape(shape)
            offset += nbytes
    if offset != len(blob):
        raise SnapshotError("entry blob longer than its layout")
    return rows


def collect_entries(engine, include_device: bool = True) -> dict[tuple, dict]:
    """Every persistable prefix entry: the arena's ``("prefix", ...)``
    contents plus (with ``include_device``) the retained device pages,
    read back in one gather per pool per layer and keyed by their
    cumulative prefix.  Runs on the engine's owner thread under the engine
    lock; the caller must not hold the lock (the owner takes it).  A
    chip-health fence passes ``include_device=False``."""

    def collect():
        with engine._lock:
            engine._kv_host_sync()
            entries: dict[tuple, dict] = {}
            for key, entry in engine._kv_arena._entries.items():
                if key and key[0] == "prefix":
                    entries[key] = entry["rows"]
            if include_device:
                keyed = []
                for page in list(engine._kv_retained):
                    prefix = engine._kv_page_prefix(page)
                    if prefix is None:
                        continue
                    key = ("prefix", prefix[0], prefix[1])
                    if key not in entries:
                        entries[key] = None  # keeps the reference's key order
                        keyed.append((key, page))
                if keyed:
                    rows = engine._kv_read_pages_rows([page for _, page in keyed])
                    for (key, _), r in zip(keyed, rows):
                        entries[key] = r
            return entries

    return engine.on_owner(collect)


def encode_preamble(layout: dict, fingerprint: str, n_entries: int) -> bytes:
    """The ``MAGIC | version | header`` preamble of a stream of
    ``n_entries`` entries."""
    header = json.dumps(
        {
            "version": VERSION,
            "layout": layout,
            "params_fingerprint": fingerprint,
            "entries": int(n_entries),
            "created_unix_ms": int(time.time() * 1000),
        }
    ).encode()
    return MAGIC + struct.pack("<II", VERSION, len(header)) + header


def encode_entry(layout: dict, key: tuple, rows: dict) -> bytes:
    """One ``meta | blob`` entry record: ``rows`` maps layer -> pool ->
    one page's rows (tensors), per-entry CRC32 over the blob."""
    _, root, tokens = key
    blob = _entry_blob(rows, layout)
    meta = json.dumps(
        {
            "root": int(root),
            "tokens": [int(t) for t in tokens],
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "nbytes": len(blob),
        }
    ).encode()
    return struct.pack("<I", len(meta)) + meta + blob


def encode_snapshot(layout: dict, fingerprint: str, entries: dict) -> Iterator[bytes]:
    """The preamble, then one chunk per entry."""
    yield encode_preamble(layout, fingerprint, len(entries))
    for key, rows in entries.items():
        yield encode_entry(layout, key, rows)


def _write_snapshot(path: str, layout: dict, fingerprint: str, entries: dict,
                    truncate_fraction: Optional[float] = None) -> int:
    """Write the encoded stream to a tempfile in ``path``'s directory and
    atomically rename it over ``path``; returns the byte size.
    ``truncate_fraction`` (the save failpoint's ``truncate``) tears the
    file after the rename."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".kv_arena.", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in encode_snapshot(layout, fingerprint, entries):
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    size = os.path.getsize(path)
    if truncate_fraction is not None:
        keep = int(size * truncate_fraction)
        with open(path, "r+b") as f:
            f.truncate(keep)
        size = keep
    return size


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise SnapshotError("snapshot truncated")
    return data


def read_snapshot(path: str, expected_layout: Optional[dict] = None,
                  expected_fingerprint: Optional[str] = None) -> tuple[dict, list]:
    """Parse and verify one snapshot file: (header, entries) with entries
    ``(("prefix", root, tokens), rows, nbytes)``.  Raises ``SnapshotError``
    on any corruption, truncation or layout/params mismatch.  The
    ``engine.snapshot.load`` failpoint: ``error`` = unreadable file,
    ``truncate[:fraction]`` reads a prefix of the bytes."""
    hit = failpoints.fire("engine.snapshot.load")
    if hit is not None and hit.mode == "truncate":
        import io

        size = os.path.getsize(path)
        with open(path, "rb") as f:
            data = f.read(int(size * (float(hit.arg) if hit.arg else 0.5)))
        return _parse_snapshot(io.BytesIO(data), expected_layout, expected_fingerprint)
    with open(path, "rb") as f:
        return _parse_snapshot(f, expected_layout, expected_fingerprint)


def _parse_snapshot(f, expected_layout, expected_fingerprint):
    if _read_exact(f, len(MAGIC)) != MAGIC:
        raise SnapshotError("bad magic")
    version, header_len = struct.unpack("<II", _read_exact(f, 8))
    if version != VERSION:
        raise SnapshotError(f"unsupported snapshot version {version}")
    try:
        header = json.loads(_read_exact(f, header_len))
    except ValueError as e:
        raise SnapshotError(f"bad header: {e}") from None
    layout = header.get("layout")
    if expected_layout is not None and layout != expected_layout:
        raise SnapshotError("layout_mismatch")
    if expected_fingerprint is not None and header.get("params_fingerprint") != expected_fingerprint:
        raise SnapshotError("params_mismatch")
    entries: list = []
    for _ in range(int(header.get("entries", 0))):
        (meta_len,) = struct.unpack("<I", _read_exact(f, 4))
        try:
            meta = json.loads(_read_exact(f, meta_len))
        except ValueError as e:
            raise SnapshotError(f"bad entry meta: {e}") from None
        blob = _read_exact(f, int(meta["nbytes"]))
        if (zlib.crc32(blob) & 0xFFFFFFFF) != int(meta["crc32"]):
            raise SnapshotError("entry checksum mismatch")
        rows = _split_blob(blob, layout)
        key = ("prefix", int(meta["root"]), tuple(int(t) for t in meta["tokens"]))
        entries.append((key, rows, len(blob)))
    return header, entries


def _admit_entries(engine, entries) -> int:
    """Parsed entries into the arena through ``HostKVArena.put`` (budget
    honoured), under the engine lock."""
    restored = 0
    with engine._lock:
        for key, rows, nbytes in entries:
            engine._kv_arena.put(key, {"rows": rows}, nbytes)
            restored += 1
    return restored


# ----------------------------------------------------------- engine wiring


def save_arena_snapshot(engine, path: str, include_device: bool = True,
                        trigger: str = "manual") -> dict:
    """Persist the engine's warm-prefix state to ``path`` (atomic).  Meters
    ``tpu_engine_snapshot_saves_total{outcome}`` and the
    ``engine.snapshot.saved`` flight event; a failure returns ``ok=False``
    and leaves the previous snapshot as it was."""
    t0 = time.perf_counter()
    try:
        hit = failpoints.fire("engine.snapshot.save")
        truncate_fraction = None
        if hit is not None and hit.mode == "truncate":
            truncate_fraction = float(hit.arg) if hit.arg else 0.5
        with engine._lock:
            layout = snapshot_layout(engine)
        entries = collect_entries(engine, include_device=include_device)
        size = _write_snapshot(path, layout, engine.params_fingerprint, entries,
                               truncate_fraction)
    except (failpoints.FailpointError, OSError, ValueError) as e:
        if engine.metrics:
            engine.metrics.snapshot_saves.inc(outcome="error")
        if engine.flight is not None:
            engine.flight.record("engine.snapshot.save_failed", trigger=trigger, error=str(e))
        return {"ok": False, "reason": str(e), "trigger": trigger}
    result = {
        "ok": True,
        "entries": len(entries),
        "bytes": size,
        "ms": round((time.perf_counter() - t0) * 1e3, 3),
        "trigger": trigger,
    }
    if engine.metrics:
        engine.metrics.snapshot_saves.inc(outcome="ok")
        engine.metrics.snapshot_bytes.set(size)
    if engine.flight is not None:
        engine.flight.record("engine.snapshot.saved", **result)
    return result


def load_arena_snapshot(engine, path: str) -> dict:
    """Rehydrate the host arena from ``path``; every entry re-enters through
    ``HostKVArena.put``.  Any verification failure clears what was
    partially admitted and reports a clean cold start; a missing file is
    the ordinary first boot (``outcome=missing``)."""
    if not os.path.exists(path):
        if engine.metrics:
            engine.metrics.snapshot_loads.inc(outcome="missing")
        return {"ok": False, "reason": "missing", "restored": 0}
    if not engine._kv_arena.enabled:
        if engine.metrics:
            engine.metrics.snapshot_loads.inc(outcome="disabled")
        return {"ok": False, "reason": "arena_disabled", "restored": 0}
    t0 = time.perf_counter()
    with engine._lock:
        expected_layout = snapshot_layout(engine)
    try:
        header, entries = read_snapshot(path, expected_layout, engine.params_fingerprint)
        restored = _admit_entries(engine, entries)
    except (failpoints.FailpointError, SnapshotError, OSError, ValueError) as e:
        reason = str(e)
        outcome = reason if reason in ("layout_mismatch", "params_mismatch") else "corrupt"
        with engine._lock:
            engine._kv_arena.clear()
        if engine.metrics:
            engine.metrics.snapshot_loads.inc(outcome=outcome)
        if engine.flight is not None:
            engine.flight.record("engine.snapshot.load_failed", reason=reason, outcome=outcome)
        return {"ok": False, "reason": reason, "restored": 0}
    result = {
        "ok": True,
        "restored": restored,
        "bytes": engine._kv_arena.bytes,
        "ms": round((time.perf_counter() - t0) * 1e3, 3),
    }
    if engine.metrics:
        engine.metrics.snapshot_loads.inc(outcome="ok")
    if engine.flight is not None:
        engine.flight.record("engine.snapshot.loaded", **result)
    return result


# ------------------------------------------------------ peer warm join


def fetch_peer_snapshot(engine, peer: str, timeout_s: float = 30.0) -> dict:
    """Warm join: stream ``peer``'s (``host:port``) ``GET /debug/snapshot``
    into this engine's arena before the first admission.  The joiner's
    layout and params fingerprints ride the request so an incompatible
    donor refuses (409) before any bytes; the body parses through the disk
    path's verifier, and any failure clears the arena (a clean cold
    start).  Meters ``tpu_engine_snapshot_fetches_total{outcome}``; the
    ``engine.snapshot.fetch`` failpoint injects a dial failure or a
    truncated read."""
    import http.client
    import io

    if not engine._kv_arena.enabled:
        if engine.metrics:
            engine.metrics.snapshot_fetches.inc(outcome="disabled")
        return {"ok": False, "reason": "arena_disabled", "restored": 0, "peer": peer}
    t0 = time.perf_counter()
    with engine._lock:
        expected_layout = snapshot_layout(engine)
    expected_fp = engine.params_fingerprint
    host, _, port = peer.rpartition(":")
    outcome = "corrupt"
    try:
        hit = failpoints.fire("engine.snapshot.fetch", peer=peer)
        outcome = "unreachable"  # failures below here until parse starts
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
        try:
            conn.request("GET", "/debug/snapshot", headers={
                LAYOUT_HEADER: layout_fingerprint(expected_layout),
                PARAMS_HEADER: expected_fp,
            })
            resp = conn.getresponse()
            if resp.status != 200:
                outcome = "refused"
                raise SnapshotError(f"peer refused snapshot: HTTP {resp.status}")
            outcome = "corrupt"  # transport/parse failures from here on
            reader = resp
            if hit is not None and hit.mode == "truncate":
                data = resp.read()
                frac = float(hit.arg) if hit.arg else 0.5
                reader = io.BytesIO(data[: int(len(data) * frac)])
            header, entries = _parse_snapshot(reader, expected_layout, expected_fp)
        finally:
            conn.close()
        restored = _admit_entries(engine, entries)
    except (failpoints.FailpointError, SnapshotError, OSError, ValueError) as e:
        reason = str(e)
        if reason in ("layout_mismatch", "params_mismatch"):
            outcome = reason
        with engine._lock:
            engine._kv_arena.clear()
        if engine.metrics:
            engine.metrics.snapshot_fetches.inc(outcome=outcome)
        if engine.flight is not None:
            engine.flight.record("engine.snapshot.fetch_failed", peer=peer, reason=reason,
                                 outcome=outcome)
        return {"ok": False, "reason": reason, "outcome": outcome, "restored": 0, "peer": peer}
    result = {
        "ok": True,
        "peer": peer,
        "restored": restored,
        "bytes": engine._kv_arena.bytes,
        "ms": round((time.perf_counter() - t0) * 1e3, 3),
    }
    if engine.metrics:
        engine.metrics.snapshot_fetches.inc(outcome="ok")
    if engine.flight is not None:
        engine.flight.record("engine.snapshot.fetched", **result)
    return result


def fleet_members(router_url: str, timeout_s: float = 5.0) -> list[str]:
    """The fleet membership as the router sees it (``GET /debug/fleet``,
    falling back to ``/debug/router``; both carry a ``replicas`` map)."""
    import urllib.request

    base = router_url.rstrip("/")
    if not base.startswith("http"):
        base = f"http://{base}"
    last_error: Optional[Exception] = None
    for path in ("/debug/fleet", "/debug/router"):
        try:
            with urllib.request.urlopen(base + path, timeout=timeout_s) as r:
                payload = json.loads(r.read() or b"{}")
            return sorted((payload.get("replicas") or {}).keys())
        except (OSError, ValueError) as e:
            last_error = e
    raise SnapshotError(f"fleet membership unavailable: {last_error}")

