"""The KV snapshot wire format's headers and encoders, and the params
fingerprint.

The port's own copy of what the serving process needs from the
reference's ``models/engine_snapshot.py``: the ``MAGIC | version | header
| entries`` encoders behind ``GET /debug/snapshot`` and ``POST
/v1/prefill``, the page-row layout and its fingerprint, and the params
fingerprint the canary prober keys its oracle on.  The bytes are the
reference's, so a JAX replica parses what a PyTorch one streams.  The
disk snapshot, its loader and the peer warm-up wait for the KV tiers.

``params_fingerprint`` takes the float32 state dict in flax names
(``convert.flax_to_state_dict`` or ``init_params``) and hashes it as the
reference hashes the flax tree: jax's leaf order (keys sorted at every
level), ``keystr`` paths, shapes and dtypes, plus the first bytes of the
first leaves, so both engines built from one tree answer the same value.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from typing import Iterator, Mapping

import numpy as np
import torch

MAGIC = b"TPUKVSN1"
VERSION = 1

# Peer-transfer negotiation headers (GET /debug/snapshot, POST /v1/prefill).
LAYOUT_HEADER = "X-Snapshot-Layout"
PARAMS_HEADER = "X-Snapshot-Params"
ENTRIES_HEADER = "X-Snapshot-Entries"
# The /v1/prefill stream's trailing logits section.
LOGITS_MAGIC = b"TPUHOLG1"

# Per-leaf byte cap on the params fingerprint sample, and how many leaves
# are sampled (the reference's constants).
_FP_SAMPLE_BYTES = 4096
_FP_SAMPLE_LEAVES = 4

_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.int8: "int8", torch.int32: "int32", torch.int64: "int64",
}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under numpy's (and jax's) name."""
    return _DTYPE_NAMES[dtype]


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
    dtype of ONE page's rows."""
    layers: dict[str, dict] = {}
    for i in range(engine.cfg.num_layers):
        pools = engine.kv_pools(i)
        layers[f"layer_{i}"] = {
            name: {"shape": [int(d) for d in pool.shape[1:]], "dtype": dtype_name(pool.dtype)}
            for name, pool in sorted(pools.items())
        }
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


def encode_logits_section(arr: np.ndarray) -> bytes:
    """``TPUHOLG1 | meta | blob``: the optional trailing section of a
    /v1/prefill stream, the prefill side's last-position logits."""
    blob = np.ascontiguousarray(arr).tobytes()
    meta = json.dumps(
        {
            "dtype": str(arr.dtype),
            "shape": [int(d) for d in arr.shape],
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "nbytes": len(blob),
        }
    ).encode()
    return LOGITS_MAGIC + struct.pack("<I", len(meta)) + meta + blob

