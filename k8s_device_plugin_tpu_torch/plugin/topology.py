"""NUMA locality of the cards on one host.

Counterpart of the JAX package's ``plugin/topology.py``, which models the
host's ICI mesh and picks contiguous sub-meshes (``select_contiguous``).
An H100 SXM host has no such mesh: its cards meet all to all through
NVSwitch, so no subset of them is better connected than another.  The
locality that matters is the NUMA node each card hangs off: a pod whose
cards sit on one node keeps its host-to-device copies off the socket
interconnect.  So the preferred allocation spans the fewest NUMA nodes,
lowest indices first, with the cards the kubelet must include first.
"""

from __future__ import annotations

from typing import Iterable, Mapping


def numa_groups(indices: Iterable[int], numa_of: Mapping[int, int | None]) -> dict:
    """``indices`` grouped by NUMA node, each group sorted; cards without a
    known node share the group ``None``."""
    groups: dict = {}
    for i in sorted(indices):
        groups.setdefault(numa_of.get(i), []).append(i)
    return groups


def select_numa_local(count: int, available: Iterable[int], numa_of: Mapping[int, int | None],
                      must_include: Iterable[int] = ()) -> list[int] | None:
    """``count`` card indices from ``available`` (and ``must_include``) on
    the fewest NUMA nodes, every must included; None when no such set
    exists (too few cards, or more musts than ``count``).

    The musts' nodes are taken first; further nodes join largest first
    (the fewest nodes that hold ``count``), lowest index breaking ties.
    Within the chosen nodes the musts come first, then the lowest
    indices; the result is sorted."""
    avail, must = set(available), set(must_include)
    pool = avail | must
    if count <= 0 or len(pool) < count or len(must) > count:
        return None
    groups = numa_groups(pool, numa_of)
    chosen = {numa_of.get(i) for i in must}
    rest = sorted((n for n in groups if n not in chosen),
                  key=lambda n: (-len(groups[n]), groups[n][0]))
    while sum(len(groups[n]) for n in chosen) < count:
        chosen.add(rest.pop(0))
    candidates = sorted(i for n in chosen for i in groups[n])
    picked = sorted(must) + [i for i in candidates if i not in must]
    return sorted(picked[:count])


def numa_nodes_of(indices: Iterable[int], numa_of: Mapping[int, int | None]) -> set:
    """The NUMA nodes ``indices`` span (``None`` for cards of no known node)."""
    return {numa_of.get(i) for i in indices}
