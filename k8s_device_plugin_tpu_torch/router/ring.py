"""KV-affine consistent hashing: prefix keys + the replica ring.

The port's own copy of the reference's ``router/ring.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

Why a hash ring and not a least-loaded pick: the serving replicas keep
content-addressed KV tiers (models/engine_kvcache.py) — a repeated
system prompt is only cheap on the replica that already holds its prefix
pages.  The router therefore needs a placement function that is (a)
**sticky** — the same prompt prefix always lands on the same replica,
across router restarts and across routers (no shared state), and (b)
**minimally disruptive** — adding or removing one replica must remap
only ~1/K of the keyspace, not reshuffle every session's warm prefix.
Consistent hashing with virtual nodes is exactly that function; the
ring order after the home replica doubles as the deterministic failover
order, so a failed-over stream re-prefills on the SAME replica every
time (where its restore then hits).

Keys are built from the prompt's leading **prefix blocks** (page-sized
token groups, `prefix_key`): requests sharing a system prompt share
their leading blocks, hash to one key, and ride one replica's KV —
while the long unique tail stays out of the key so it cannot scatter a
shared prefix across the fleet.

Stdlib-only and jax-free (hashlib, bisect); deterministic everywhere —
no process-seeded hashing (`hash()` is salted per process and would
desync routers).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional, Sequence

# Page-sized default: matches the serving default --page-size=16, so a
# prefix block is exactly one KV page worth of tokens.
DEFAULT_BLOCK_TOKENS = 16
DEFAULT_MAX_BLOCKS = 4


def _hash64(data: bytes) -> int:
    """Stable 64-bit hash (sha1 prefix): identical across processes,
    platforms, and restarts — the property builtin hash() lacks."""
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def prefix_key(
    prompt: Sequence[int],
    block_tokens: int = DEFAULT_BLOCK_TOKENS,
    max_blocks: int = DEFAULT_MAX_BLOCKS,
) -> int:
    """Hash the prompt's leading prefix blocks into a ring key.

    The first ``min(len, block_tokens * max_blocks)`` tokens, rounded
    DOWN to a block boundary, form the key — so prompts sharing a
    system prefix but differing in their tails (or in trailing partial
    blocks) collapse to one key.  Prompts shorter than one block key on
    their whole content (a 3-token prompt still routes consistently).
    """
    if block_tokens < 1:
        raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
    if max_blocks < 1:
        raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
    take = min(len(prompt), block_tokens * max_blocks)
    if take >= block_tokens:
        take -= take % block_tokens
    head = prompt[:take] if take else prompt[:]
    blob = b",".join(b"%d" % int(t) for t in head)
    return _hash64(blob)


class HashRing:
    """Ketama-style consistent hash ring with virtual nodes.

    Each node owns ``vnodes`` points on a 64-bit ring; a key maps to the
    first point clockwise from its hash.  ``order(key)`` walks the ring
    and returns every DISTINCT node in encounter order — position 0 is
    the affinity home, the rest is the deterministic failover order.

    Not thread-safe by itself; the router mutates it only under its own
    state lock (membership changes are rare — DNS refresh, drain).
    """

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: list[int] = []  # sorted hash points
        self._owner: dict[int, str] = {}  # point -> node
        self._nodes: set[str] = set()
        for node in nodes:
            self.add(node)

    # ------------------------------------------------------- membership

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            point = _hash64(f"{node}#{i}".encode())
            # Point collisions across nodes are astronomically unlikely
            # on a 64-bit ring; first owner wins deterministically.
            if point in self._owner:
                continue
            self._owner[point] = node
            bisect.insort(self._points, point)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        keep = [p for p in self._points if self._owner[p] != node]
        for p in self._points:
            if self._owner[p] == node:
                del self._owner[p]
        self._points = keep

    @property
    def nodes(self) -> set[str]:
        return set(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    # ----------------------------------------------------------- lookup

    def lookup(self, key: int) -> Optional[str]:
        """The node owning ``key`` (None on an empty ring)."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, key % (1 << 64))
        if i == len(self._points):
            i = 0
        return self._owner[self._points[i]]

    def order(self, key: int, limit: Optional[int] = None) -> list[str]:
        """Distinct nodes in ring order starting at ``key``'s owner —
        the affinity-home-then-failover sequence.  ``limit`` caps the
        list (default: every node)."""
        if not self._points:
            return []
        want = len(self._nodes) if limit is None else min(limit, len(self._nodes))
        out: list[str] = []
        seen: set[str] = set()
        start = bisect.bisect_right(self._points, key % (1 << 64))
        n = len(self._points)
        for step in range(n):
            node = self._owner[self._points[(start + step) % n]]
            if node in seen:
                continue
            seen.add(node)
            out.append(node)
            if len(out) >= want:
                break
        return out

    def snapshot(self) -> dict:
        """JSON-safe ring summary for /debug/router."""
        return {
            "vnodes": self.vnodes,
            "nodes": sorted(self._nodes),
            "points": len(self._points),
        }
