"""Disaggregated prefill/decode split policy: who prefills, who decodes.

The port's own copy of the reference's ``router/disagg.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The router fronts a fleet whose replicas may carry a ROLE
(``--role`` on the serving CLI, read back off each replica's
``/debug/state?summary=1`` poll): ``prefill`` replicas run long-prompt
prefill and stream the finished KV pages over ``POST /v1/prefill``;
``decode`` replicas pull those pages and serve the interactive decode;
``unified`` replicas do both (today's fleet).  This module is the
routing half of that split (models/engine_handoff.py is the engine
half) — a pure, jax-free policy the server feeds with poll state:

- **Classification** (:meth:`DisaggPolicy.classify`): prompt-length
  threshold × decode-pool pressure.  A prompt at/above
  ``threshold_tokens`` splits; when the decode pool runs HOT (max
  queue-wait pressure at/above ``hot_wait_s`` — the same host-side
  signal the migration planner reads) the bar drops to
  ``hot_threshold_tokens``, because a loaded decode pool is exactly
  when a long local prefill hurts interactive ITL most.  No healthy
  prefill replica → ``no_pool`` and the request rides the unified path
  unchanged — zero new failure modes for short chat traffic.
- **Prefill-source pick** (:func:`pick_prefill`): the least-pressured
  healthy prefill replica; its name becomes the ``X-Handoff-Source``
  locator the decode replica pulls from.

The router never touches KV bytes: it classifies, stamps the locator
on the decode dial, and the decode replica pulls the stream directly
from the prefill replica — so the transfer overlaps the prefill
compute and the router thread is never a copy loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# Classification verdicts (tpu_router_disagg_splits_total label values).
SPLIT = "split"
SHORT = "short"
NO_POOL = "no_pool"

# Serving-replica roles as the summary poll reports them.
ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


@dataclass
class DisaggConfig:
    """Split-policy knobs (docs/disagg.md "Split policy")."""

    # Prompt length (tokens) at/above which a request's prefill is
    # dispatched to the prefill pool when the decode pool is calm.
    threshold_tokens: int = 256
    # The lower bar that applies while the decode pool runs hot — a
    # loaded decode pool is when local prefill hurts ITL most.
    hot_threshold_tokens: int = 64
    # Decode-pool pressure (seconds of queue wait, max over eligible
    # decode-capable replicas — replica_pressure) at/above which the
    # hot threshold applies.
    hot_wait_s: float = 0.5

    def __post_init__(self):
        if self.threshold_tokens < 1:
            raise ValueError(
                f"threshold_tokens must be >= 1, got {self.threshold_tokens}"
            )
        if not 1 <= self.hot_threshold_tokens <= self.threshold_tokens:
            raise ValueError(
                "hot_threshold_tokens must be in [1, threshold_tokens], "
                f"got {self.hot_threshold_tokens}"
            )


class DisaggPolicy:
    """Pure verdict function over (prompt length, decode pressure,
    prefill-pool health); the server owns discovery and dial plumbing."""

    def __init__(self, cfg: Optional[DisaggConfig] = None):
        self.cfg = cfg if cfg is not None else DisaggConfig()

    def classify(
        self,
        prompt_tokens: int,
        decode_pressure_s: float,
        prefill_pool_up: bool,
    ) -> str:
        """``split`` / ``short`` / ``no_pool`` for one request."""
        bar = (
            self.cfg.hot_threshold_tokens
            if decode_pressure_s >= self.cfg.hot_wait_s
            else self.cfg.threshold_tokens
        )
        if prompt_tokens < bar:
            return SHORT
        if not prefill_pool_up:
            return NO_POOL
        return SPLIT

    def snapshot(self) -> dict:
        return {
            "threshold_tokens": self.cfg.threshold_tokens,
            "hot_threshold_tokens": self.cfg.hot_threshold_tokens,
            "hot_wait_s": self.cfg.hot_wait_s,
        }


def pick_prefill(candidates: dict[str, float]) -> Optional[str]:
    """The least-pressured prefill replica (name -> pressure seconds);
    deterministic tie-break by name.  None on an empty pool."""
    if not candidates:
        return None
    return min(sorted(candidates), key=lambda name: candidates[name])
