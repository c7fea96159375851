"""The consistent-hash ring the router places replicas on.

The part of the reference's ``router/ring.py`` that the port needs: the
stable 64-bit hash and the ketama ring with virtual nodes, copied (the
port imports nothing of the JAX package), and ``donor_for``, the warm-up
donor the router's own ring would remap a joiner's keys from (the
reference's ``engine_snapshot.donor_for``, which the port's
``engine_snapshot`` re-exports).  Free of torch, so the controller that
picks donors loads without it.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional


def _hash64(data: bytes) -> int:
    """Stable 64-bit hash (sha1 prefix): identical across processes,
    platforms and restarts, which builtin ``hash()`` is not."""
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


class HashRing:
    """Ketama-style consistent hash ring: each node owns ``vnodes`` points
    on a 64-bit ring, and a key maps to the first point clockwise from
    it."""

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: list[int] = []  # sorted hash points
        self._owner: dict[int, str] = {}  # point -> node
        self._nodes: set[str] = set()
        for node in nodes:
            self.add(node)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            point = _hash64(f"{node}#{i}".encode())
            if point in self._owner:  # first owner wins a collision
                continue
            self._owner[point] = node
            bisect.insort(self._points, point)

    def lookup(self, key: int) -> Optional[str]:
        """The node owning ``key`` (None on an empty ring)."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, key % (1 << 64))
        if i == len(self._points):
            i = 0
        return self._owner[self._points[i]]


def donor_for(joiner: str, peers, vnodes: int = 64) -> Optional[str]:
    """The warm-up donor: the peer owning the ring segments next to where
    ``joiner`` lands on the router's consistent-hash ring (the same vnode
    scheme and hash), i.e. the replica whose keys the joiner inherits
    most of.  Deterministic; None when no other peer exists."""
    candidates = sorted({p for p in peers if p and p != joiner})
    if not candidates:
        return None
    ring = HashRing(candidates, vnodes=vnodes)
    counts: dict[str, int] = {}
    for i in range(vnodes):
        owner = ring.lookup(_hash64(f"{joiner}#{i}".encode()))
        if owner is not None:
            counts[owner] = counts.get(owner, 0) + 1
    return max(sorted(counts), key=lambda n: counts[n])
