"""Prefix-affinity serving router (the fleet brain).

The port's own copy of the reference's ``router/__init__.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

A fleet of serve replicas (deploy/k8s-pod-serve-gpu.yaml) has
no request placement: a Service round-robins, so the retained/host-arena
KV built by the cache tiers gets shredded across replicas, and a replica
dying mid-decode drops every in-flight stream.  This package is the
standalone daemon that fronts K serving replicas with:

- **prefix affinity** — consistent hashing over the tokenized prompt's
  leading prefix blocks routes a repeated system prompt to the replica
  whose KV tiers already hold it (`ring.py`), with queue-depth-aware
  overflow read from each replica's cheap ``/debug/state?summary=1``;
- **first-class fault handling** — per-replica closed→open→half-open
  circuit breakers and a global retry budget (`breaker.py`), retries
  with exponential backoff + jitter honoring ``Retry-After``, optional
  hedged dispatch when TTFT exceeds the rolling p99, drain awareness
  (the replica ``begin_drain()`` 503 contract), and zero-drop
  mid-stream failover: a replica killed mid-decode gets its stream
  transparently resubmitted — prompt + already-emitted tokens,
  idempotent by request id — to the next ring replica, where the
  content-addressed prefix restore turns re-prefill into a KV restore
  (`server.py`).

Scored, not assumed: the chaos suite kills replicas under burst traffic
and scores the router's flight events against injected ground truth
(docs/routing.md, docs/chaos.md).  Stdlib + utils only — jax-free.
"""

from .breaker import CircuitBreaker, RetryBudget
from .ring import HashRing, prefix_key
from .server import RouterServer

__all__ = [
    "CircuitBreaker",
    "HashRing",
    "RetryBudget",
    "RouterServer",
    "prefix_key",
]
