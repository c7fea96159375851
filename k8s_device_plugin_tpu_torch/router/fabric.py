"""Fleet-wide content-addressed KV fabric: prefix locator + replication.

The port's own copy of the reference's ``router/fabric.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The engines already move KV pages peer-to-peer (``POST /v1/prefill``,
models/engine_handoff.py) and already advertise a bloom digest of their
resident prefix roots on every ``?summary=1`` poll
(``fabric_digest``, utils/prefixbloom.py).  This module is the router
half that turns those digests into fleet behavior:

- **Locator** (:class:`FabricLocator`): per-replica digest views parsed
  off the poll, answering "who in the fleet advertises the deepest
  page-aligned cumulative prefix of THIS prompt?".  The server asks per
  upstream dial — primary, retry, hedge, failover and migration legs
  alike — and stamps the best owner as ``X-Handoff-Source`` (plus
  ``X-Fabric-Resident-Only``) whenever the dial target itself does not
  advertise the prefix.  Candidates are filtered to live, unfenced,
  undraining replicas AT RESOLVE TIME, so a re-dialed leg can never be
  pointed at a dead or fenced peer: every leg re-resolves.
- **Replication/eviction policy** (:class:`FabricReplicator`): the
  poll-thread planner that keeps HOT prefixes (live-stream count x
  prefix depth — the migration planner's hottest-prefix ranking, made
  depth-aware) on up to ``replicate_k`` replicas while their owners run
  hot, and drops the router-created copies back down when the prefix
  goes cold.  Actions are bounded per sweep and ride the engines'
  admin ``POST /debug/fabric/pull`` / ``/debug/fabric/drop`` endpoints;
  both move HOST-ARENA bytes only (pressure-driven, host-observable
  signals — never device counters).

Failure semantics inherited from the layers below: a bloom false
positive or a stale digest stamps an owner that serves nothing — the
puller's parse-before-admit verifier admits ZERO entries and the
request degrades to a local prefill, bit-identical output.  The fabric
can waste a fetch; it cannot corrupt a stream.

Pure stdlib + utils; jax is never imported here.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..utils.prefixbloom import PrefixBloom

# The base model's trie pseudo-root (engine_paging.py).  Adapter
# requests use engine-local negative roots the router cannot know, so
# the locator resolves base-model prompts only and reports ``skip``
# for adapter traffic (which still rides affinity + the classic
# prefill-pool path unchanged).
BASE_ROOT = -1

# Locator verdicts (tpu_router_fabric_resolutions_total label values).
VERDICT_HIT = "hit"            # stamped a better owner than the target
VERDICT_RESIDENT = "resident"  # target already advertises the prefix
VERDICT_MISS = "miss"          # nobody in the fleet advertises it
VERDICT_SKIP = "skip"          # adapter prompt — engine-local roots
VERDICTS = (VERDICT_HIT, VERDICT_RESIDENT, VERDICT_MISS, VERDICT_SKIP)


@dataclasses.dataclass
class FabricConfig:
    """Tunables for the fabric plane (CLI: ``--fabric-*``)."""

    # Target replication factor for hot prefixes: copies are planned
    # until a hot prefix is advertised by this many replicas.
    replicate_k: int = 2
    # An owner whose queue-wait pressure runs at/above this is hot —
    # the trigger for proactive copies of its hot prefixes.
    hot_wait_s: float = 2.0
    # A replication TARGET must sit at/below this pressure: copying
    # into a busy replica trades one hotspot for another.
    cold_wait_s: float = 0.5
    # Minimum hotness score (live streams x full prefix pages) before
    # a prefix is worth replicating at all.
    hot_score: float = 2.0
    # Replication + eviction actions fired per poll sweep, fleet-wide
    # (each is one engine-side pull or drop) — the pacing bound.
    max_actions_per_sweep: int = 2
    # Consecutive zero-stream sweeps before a router-created copy is
    # dropped back (one idle poll tick must never thrash the arena).
    cold_sweeps: int = 3
    # Ledgered copies whose target still does not advertise the prefix
    # after this many sweeps are presumed failed and forgotten (the
    # self-healing path for a pull that errored or was evicted).
    confirm_sweeps: int = 3
    # Engine-side pull deadline (the whole wire transfer).
    pull_timeout_s: float = 30.0
    # Page size assumed until a digest advertises one (fleets are
    # homogeneous; the per-replica advertised value always wins).
    default_page_size: int = 16

    def __post_init__(self):
        if self.replicate_k < 1:
            raise ValueError(
                f"replicate_k must be >= 1, got {self.replicate_k}"
            )
        if self.hot_wait_s <= self.cold_wait_s:
            raise ValueError(
                "hot_wait_s must exceed cold_wait_s "
                f"({self.hot_wait_s} <= {self.cold_wait_s})"
            )
        if self.max_actions_per_sweep < 1:
            raise ValueError("max_actions_per_sweep must be >= 1")


class _DigestView:
    """One replica's parsed advertisement: an immutable-after-publish
    bloom plus the page geometry it was built against."""

    __slots__ = ("bloom", "page_size", "at")

    def __init__(self, bloom: PrefixBloom, page_size: int):
        self.bloom = bloom
        self.page_size = page_size
        self.at = time.monotonic()


class FabricLocator:
    """Per-replica digest views + the best-owner query.

    Views are written by the poll thread (one :meth:`update` per
    replica per sweep) and read by every request/stream thread at dial
    time, so the view dict sits behind a leaf lock; the blooms
    themselves are never mutated after publish and are queried
    lock-free."""

    def __init__(self, default_page_size: int = 16):
        self._default_page_size = int(default_page_size)
        self._views: dict[str, _DigestView] = {}  # guarded by: _lock
        self._lock = threading.Lock()

    # ------------------------------------------------------- poll side

    def update(self, name: str, wire: object) -> int:
        """Parse one replica's advertised digest (poll thread).
        Returns the advertised root count (0 when the replica sent no
        digest or an unparseable one — either way the locator simply
        cannot place that replica until a good poll)."""
        bloom = PrefixBloom.from_wire(wire)
        if bloom is None:
            with self._lock:
                self._views.pop(name, None)
            return 0
        page_size = self._default_page_size
        if isinstance(wire, dict):
            try:
                page_size = max(1, int(wire.get("page_size", page_size)))
            except (TypeError, ValueError):
                pass
        with self._lock:
            self._views[name] = _DigestView(bloom, page_size)
        return bloom.count

    def forget(self, name: str) -> None:
        with self._lock:
            self._views.pop(name, None)

    # ---------------------------------------------------- query side

    def _view(self, name: str) -> Optional[_DigestView]:
        with self._lock:
            return self._views.get(name)

    def page_size(self) -> int:
        """The fleet's advertised page size (first view's; fleets are
        homogeneous by deployment contract), or the default."""
        with self._lock:
            for view in self._views.values():
                return view.page_size
        return self._default_page_size

    def coverage(
        self, name: str, prompt, root: int = BASE_ROOT
    ) -> int:
        """Deepest advertised page-aligned cumulative prefix of
        ``prompt`` on ``name``, in TOKENS (0 = nothing advertised).
        Walks deepest-first: the digest has no false negatives, so the
        first hit is the true depth — or a bloom FP overclaiming, which
        the serving side's resident-only 409 turns into a degraded
        local prefill, never wrong tokens."""
        view = self._view(name)
        if view is None:
            return 0
        ps = view.page_size
        for pages in range(len(prompt) // ps, 0, -1):
            if view.bloom.contains(root, prompt[: pages * ps]):
                return pages * ps
        return 0

    def best_owner(
        self, prompt, candidates, root: int = BASE_ROOT
    ) -> Optional[tuple[str, int]]:
        """(owner, covered tokens) — the candidate advertising the
        deepest cumulative prefix of ``prompt`` (deterministic name
        tie-break), or None when nobody advertises anything.  The
        CALLER filters ``candidates`` to live/unfenced/undraining
        peers at resolve time — the never-a-dead-peer contract."""
        best: Optional[tuple[int, str]] = None
        for name in candidates:
            covered = self.coverage(name, prompt, root)
            if covered <= 0:
                continue
            # Deepest coverage wins; ties break toward the smaller
            # name so repeated resolutions are stable.
            if best is None or (-covered, name) < (-best[0], best[1]):
                best = (covered, name)
        if best is None:
            return None
        return best[1], best[0]

    def owners(
        self, prompt, candidates, root: int = BASE_ROOT
    ) -> list[str]:
        """Candidates advertising the FULL page-aligned prefix of
        ``prompt`` (every complete page — the replication-factor
        census, not the best-effort dial locator)."""
        out = []
        for name in candidates:
            view = self._view(name)
            if view is None:
                continue
            pages = len(prompt) // view.page_size
            if pages < 1:
                continue
            if self.coverage(name, prompt, root) >= pages * view.page_size:
                out.append(name)
        return out

    def advertised_roots(self) -> dict[str, int]:
        """{replica: advertised prefix-root count} — what
        ``tools/fleet_plan.py`` renders per replica."""
        with self._lock:
            return {
                name: view.bloom.count
                for name, view in self._views.items()
            }

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                name: {
                    "advertised_roots": view.bloom.count,
                    "page_size": view.page_size,
                    "age_s": round(now - view.at, 3),
                }
                for name, view in sorted(self._views.items())
            }


class FabricReplicator:
    """K-replica hot-prefix replication + cold eviction planner.

    Single-threaded by contract: the router's poll thread owns it (the
    MigrationPlanner discipline).  Feed one :meth:`plan` per sweep with
    the live hot-prefix census and the eligible replicas' pressures; it
    answers a BOUNDED list of pull/drop actions and keeps the ledger of
    copies the router itself created — eviction only ever drops those,
    never a replica's traffic-warmed working set."""

    def __init__(self, config: Optional[FabricConfig] = None):
        self.cfg = config or FabricConfig()
        # Ledger of router-created copies:
        # (prefix tokens) -> {target: sweeps since the pull was planned}.
        self._ledger: dict[tuple, dict[str, int]] = {}
        # Consecutive zero-stream sweeps per replicated prefix.
        self._cold_streaks: dict[tuple, int] = {}
        self.pulls_planned = 0
        self.drops_planned = 0

    def forget(self, name: str) -> None:
        """Membership removal: a vanished replica's ledger entries are
        moot (its arena died with it)."""
        for targets in self._ledger.values():
            targets.pop(name, None)

    def plan(
        self,
        locator: FabricLocator,
        hot_prefixes: dict[tuple, int],
        pressures: dict[str, float],
    ) -> list[dict]:
        """One sweep's actions (at most ``max_actions_per_sweep``).

        ``hot_prefixes``: {prefix token tuple: live stream count} from
        the router's stream registry.  ``pressures``: {name: queue-wait
        pressure seconds} over the ELIGIBLE decode-capable replicas —
        the same host-side signals migration planning reads.
        """
        cfg = self.cfg
        ps = locator.page_size()
        actions: list[dict] = []
        names = list(pressures)

        # Ledger upkeep: age every entry; forget copies whose target
        # still does not advertise the prefix after the confirm window
        # (failed pull, or the target evicted it under memory pressure).
        for prefix, targets in list(self._ledger.items()):
            pages = len(prefix) // ps
            for target in list(targets):
                targets[target] += 1
                if targets[target] >= cfg.confirm_sweeps and (
                    locator.coverage(target, list(prefix)) < pages * ps
                ):
                    del targets[target]
            if not targets:
                self._ledger.pop(prefix, None)
                self._cold_streaks.pop(prefix, None)

        # --- replication: hottest prefixes first, owners running hot.
        ranked = sorted(
            hot_prefixes.items(),
            key=lambda item: (-(item[1] * (len(item[0]) // ps)), item[0]),
        )
        for prefix, streams in ranked:
            if len(actions) >= cfg.max_actions_per_sweep:
                break
            pages = len(prefix) // ps
            if pages < 1 or streams * pages < cfg.hot_score:
                continue
            owners = locator.owners(list(prefix), names)
            if not owners:
                # Nobody advertises it yet — the next local prefill
                # warms an owner; nothing to copy FROM.
                continue
            # Copies already planned count as owners until confirmed,
            # or one hot prefix would fan out past K while digests lag
            # a poll tick behind the pulls.
            effective = set(owners) | set(self._ledger.get(prefix, ()))
            if len(effective) >= cfg.replicate_k:
                continue
            if max(pressures[o] for o in owners) < cfg.hot_wait_s:
                continue  # owners comfortable; affinity already works
            targets = sorted(
                (pressures[n], n)
                for n in names
                if n not in effective and pressures[n] <= cfg.cold_wait_s
            )
            if not targets:
                continue  # no cold headroom — a scale signal, not a copy
            target = targets[0][1]
            source = min(owners, key=lambda o: (pressures[o], o))
            self._ledger.setdefault(prefix, {})[target] = 0
            self._cold_streaks.pop(prefix, None)
            self.pulls_planned += 1
            actions.append(
                {
                    "op": "pull",
                    "target": target,
                    "source": source,
                    "prompt": list(prefix[: pages * ps]),
                    "streams": streams,
                    "pages": pages,
                }
            )

        # --- eviction: router-created copies of prefixes gone cold are
        # dropped back toward replication factor 1 (the traffic-warmed
        # origin keeps its own copy; we only release what we added).
        for prefix in sorted(self._ledger):
            if len(actions) >= cfg.max_actions_per_sweep:
                break
            if hot_prefixes.get(prefix, 0) > 0:
                self._cold_streaks.pop(prefix, None)
                continue
            streak = self._cold_streaks.get(prefix, 0) + 1
            self._cold_streaks[prefix] = streak
            if streak < cfg.cold_sweeps:
                continue
            targets = self._ledger.get(prefix, {})
            while targets and len(actions) < cfg.max_actions_per_sweep:
                target = sorted(targets)[0]
                del targets[target]
                self.drops_planned += 1
                actions.append(
                    {
                        "op": "drop",
                        "target": target,
                        "prompt": list(prefix),
                    }
                )
            if not targets:
                self._ledger.pop(prefix, None)
                self._cold_streaks.pop(prefix, None)
        return actions

    def replication_factor(
        self, locator: FabricLocator, prefix: tuple, names
    ) -> int:
        """How many replicas advertise this full prefix right now."""
        return len(locator.owners(list(prefix), names))

    def snapshot(self) -> dict:
        """JSON-safe planner state for GET /debug/fabric."""
        return {
            "replicate_k": self.cfg.replicate_k,
            "hot_wait_s": self.cfg.hot_wait_s,
            "cold_wait_s": self.cfg.cold_wait_s,
            "pulls_planned": self.pulls_planned,
            "drops_planned": self.drops_planned,
            "ledger": [
                {
                    "prefix_tokens": len(prefix),
                    "targets": sorted(targets),
                    "cold_streak": self._cold_streaks.get(prefix, 0),
                }
                for prefix, targets in sorted(self._ledger.items())
            ],
        }
