"""Bloom-filter digest of content-addressed KV prefix roots.

The port's own copy of the reference's ``utils/prefixbloom.py`` (the port
imports nothing of the JAX package): the same geometry, hash and wire
form, so a router parses a PyTorch replica's digest as a JAX one's.

The fleet KV fabric needs every replica to advertise WHICH cumulative
token prefixes it could serve over the handoff wire — but the honest
answer (the full key list) is unbounded: a warm replica holds hundreds
of trie-resident and arena-offloaded prefixes, each keyed by its full
token tuple, and the advertisement rides the router's ``?summary=1``
poll, which is deliberately cheap (lock-free on the engine side, one
small JSON object per replica per poll tick).  So the advertisement is
a fixed-size bloom filter over the same content keys the arena and
``donor_for`` already use: ``(trie_root, cumulative_tokens)``.

Semantics the fabric layers on top rely on:

- **No false negatives.**  A prefix the replica advertised is always
  queryable; the router's locator may MISS real owners only through
  digest staleness (one poll interval), never through the filter.
- **False positives are survivable by construction.**  The router may
  stamp an owner that holds nothing; the puller's parse-before-admit
  verifier then admits zero entries and the request degrades to local
  prefill.  A bloom FP costs one wasted fetch, never correctness —
  which is why a probabilistic digest is admissible here at all.
- **Jax-free.**  The router and the test fakes build and query these
  digests; this module must import without the workloads extra.

Wire form is a small JSON-safe dict (``to_wire``/``from_wire``): hex
bit-string plus the (m, k) geometry and an entry count, versioned so a
geometry change never silently mixes filters.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional

# Digest geometry.  1024 bytes / 8192 bits with k=4 holds ~850 prefixes
# at <1% FP; a tiny-page CPU bench fleet advertises tens of roots, real
# fleets hundreds — and an over-full filter only degrades toward wasted
# fetches, never wrong tokens.  The wire form carries (m, k) anyway, so
# geometry can grow without a protocol rev.
DEFAULT_M_BITS = 8192
DEFAULT_K_HASHES = 4
WIRE_VERSION = 1

_MAX_WIRE_BITS = 1 << 20  # refuse absurd advertised geometry (128 KiB)


def prefix_key_bytes(root: int, tokens: Iterable[int]) -> bytes:
    """Canonical byte form of one content key.  Matches the arena's
    ``("prefix", root, tuple(tokens))`` addressing: same root + same
    cumulative token tuple -> same bytes, everywhere in the fleet."""
    return ("%d:" % int(root)).encode() + ",".join(
        str(int(t)) for t in tokens
    ).encode()


class PrefixBloom:
    """Fixed-geometry bloom filter over prefix content keys.

    Not thread-safe: builders fill one privately then publish the wire
    dict atomically (the engine rebuilds under its lock and caches the
    rendered dict; the router parses a fresh instance per poll).
    """

    __slots__ = ("m", "k", "count", "_bits")

    def __init__(self, m: int = DEFAULT_M_BITS, k: int = DEFAULT_K_HASHES):
        if m <= 0 or m % 8 or m > _MAX_WIRE_BITS:
            raise ValueError(f"bloom m must be in (0, {_MAX_WIRE_BITS}] and byte-aligned, got {m}")
        if not 1 <= k <= 16:
            raise ValueError(f"bloom k must be in [1, 16], got {k}")
        self.m = int(m)
        self.k = int(k)
        self.count = 0
        self._bits = bytearray(m // 8)

    def _positions(self, key: bytes) -> list[int]:
        # One blake2b evaluation yields all k positions: 4-byte slices of
        # the 64-byte digest, mod m.  k<=16 always fits one digest.
        digest = hashlib.blake2b(key, digest_size=4 * self.k).digest()
        return [
            int.from_bytes(digest[4 * i : 4 * i + 4], "big") % self.m
            for i in range(self.k)
        ]

    def add(self, root: int, tokens: Iterable[int]) -> None:
        key = prefix_key_bytes(root, tokens)
        for pos in self._positions(key):
            self._bits[pos >> 3] |= 1 << (pos & 7)
        self.count += 1

    def contains(self, root: int, tokens: Iterable[int]) -> bool:
        key = prefix_key_bytes(root, tokens)
        return all(
            self._bits[pos >> 3] & (1 << (pos & 7))
            for pos in self._positions(key)
        )

    def to_wire(self) -> dict:
        """JSON-safe advertisement dict for the ``?summary=1`` payload."""
        return {
            "v": WIRE_VERSION,
            "m": self.m,
            "k": self.k,
            "count": self.count,
            "bits": self._bits.hex(),
        }

    @classmethod
    def from_wire(cls, wire: object) -> Optional["PrefixBloom"]:
        """Parse an advertised digest; ``None`` for anything malformed
        (wrong version, bad geometry, bit-string/geometry mismatch).
        The router treats an unparseable digest exactly like a replica
        with no advertisement — the locator simply cannot place it."""
        if not isinstance(wire, dict):
            return None
        try:
            if int(wire.get("v", -1)) != WIRE_VERSION:
                return None
            m, k = int(wire["m"]), int(wire["k"])
            bits = bytes.fromhex(wire["bits"])
            count = int(wire.get("count", 0))
        except (KeyError, TypeError, ValueError):
            return None
        if m <= 0 or m % 8 or m > _MAX_WIRE_BITS or not 1 <= k <= 16:
            return None
        if len(bits) != m // 8 or count < 0:
            return None
        bloom = cls(m, k)
        bloom._bits = bytearray(bits)
        bloom.count = count
        return bloom
