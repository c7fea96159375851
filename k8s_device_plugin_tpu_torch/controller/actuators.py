"""Actuators — how a :class:`~.reconciler.Reconciler` decision lands.

The port's own copy of the reference's ``controller/actuators.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

The reconciler decides; an actuator executes.  The interface is three
verbs matching the three non-hold actions:

- ``scale_up(role=..., peers=[...])`` — bring up a warm replica for a
  role, donor-selected from ``peers`` (the eligible decode-capable
  fleet) via the snapshot plane's ``donor_for`` ketama walk, and join
  it to the router.
- ``scale_down(replica, role=...)`` — drain, wait for in-flight
  streams to finish, then reap.  Zero client-visible drops is the
  actuator's contract, not the reconciler's hope.
- ``set_role(replica, role)`` — flip a live replica's role via its
  admin ``POST /debug/role``; the router reconciles the change off its
  next summary poll (on/off the /generate ring).

Failures raise :class:`ActuatorError`; the reconciler degrades the
tick to hold, records ``controller.actuator_error``, and retries at
cooldown pace.

Three shapes ship:

- :class:`NullActuator` — the CLI default: every action refuses, so a
  misconfigured controller can never touch a fleet (observe via
  ``--dry-run`` instead).
- :class:`FleetSimActuator` — callable-injected lifecycle for the
  fleet-sim tier (chaos scenario, bench): spawn/warm/join/drain/reap
  as plain functions over in-process replicas.
- :class:`KubernetesActuator` — the k8s shape: desired counts are the
  actuation surface (the controller's ``tpu_controller_desired_replicas``
  gauge, scraped by an external-metrics adapter that scales the serving
  Deployment — deploy/k8s-deploy-controller-gpu.yaml); role flips still
  dial the pod's admin endpoint directly.

All jax-free (stdlib + the numpy-only snapshot helpers).
"""

from __future__ import annotations

import collections
import json
import urllib.request
from typing import Callable, Optional


class ActuatorError(RuntimeError):
    """An actuation failed; the reconciler holds and retries later."""


def post_role(replica: str, role: str, timeout_s: float = 5.0) -> dict:
    """``POST /debug/role`` against a replica's admin surface (the
    engine gates it behind ``--admin-endpoints``)."""
    url = f"http://{replica}/debug/role"
    body = json.dumps({"role": role}).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return json.loads(r.read() or b"{}")
    except OSError as e:
        raise ActuatorError(f"role flip on {replica} failed: {e}") from e


class Actuator:
    """The verb interface.  Subclasses implement all three or raise
    :class:`ActuatorError` for the ones their substrate cannot do."""

    name = "actuator"

    def scale_up(self, *, role: str, peers: list) -> dict:
        """Bring up + warm + join one replica; returns
        ``{"replica": name, "donor": name | None}``."""
        raise NotImplementedError

    def scale_down(self, replica: str, *, role: Optional[str] = None) -> None:
        """Drain then reap ``replica`` (blocking until reaped)."""
        raise NotImplementedError

    def set_role(self, replica: str, role: str) -> None:
        """Flip a live replica's role."""
        raise NotImplementedError


class NullActuator(Actuator):
    """Refuses every action — the safe CLI default when no actuator is
    configured and --dry-run was explicitly disarmed anyway."""

    name = "none"

    def _refuse(self) -> None:
        raise ActuatorError(
            "no actuator configured (--actuator none) — run with "
            "--dry-run 1 to observe, or pick an actuator"
        )

    def scale_up(self, *, role: str, peers: list) -> dict:
        self._refuse()
        return {}

    def scale_down(self, replica: str, *, role: Optional[str] = None) -> None:
        self._refuse()

    def set_role(self, replica: str, role: str) -> None:
        self._refuse()


class FleetSimActuator(Actuator):
    """Lifecycle-by-callables for in-process fleets (the chaos scenario
    and the AUTOSCALE bench phase inject these over FakeReplica /
    sim-fleet objects):

    - ``spawn_fn(role) -> name`` starts a replica process/object and
      returns its ``host:port`` name (not yet joined).
    - ``warm_fn(name, donor)`` streams the donor's snapshot into it
      (optional — skipped when absent or no donor exists).
    - ``join_fn(name, role)`` registers it with the router.
    - ``drain_fn(name)`` begins drain and blocks until in-flight work
      finishes (the zero-drops contract lives here).
    - ``reap_fn(name)`` removes it from the router and stops it.
    - ``set_role_fn(name, role)`` flips a role; defaults to the real
      admin ``POST /debug/role`` dial.

    Donor selection is the real ``donor_for`` ketama walk over
    ``peers`` — the same placement the warm-join CLI path uses, so the
    sim exercises production donor choice."""

    name = "fleet-sim"

    def __init__(
        self,
        *,
        spawn_fn: Callable[[str], str],
        join_fn: Callable[[str, str], None],
        drain_fn: Callable[[str], None],
        reap_fn: Callable[[str], None],
        warm_fn: Optional[Callable[[str, str], None]] = None,
        set_role_fn: Optional[Callable[[str, str], None]] = None,
    ):
        self._spawn = spawn_fn
        self._join = join_fn
        self._drain = drain_fn
        self._reap = reap_fn
        self._warm = warm_fn
        self._set_role = set_role_fn

    def scale_up(self, *, role: str, peers: list) -> dict:
        from ..utils.ring import donor_for

        try:
            name = self._spawn(role)
            donor = donor_for(name, list(peers)) if peers else None
            if donor and self._warm is not None:
                self._warm(name, donor)
            self._join(name, role)
        except (OSError, RuntimeError, ValueError) as e:
            raise ActuatorError(f"scale_up failed: {e}") from e
        return {"replica": name, "donor": donor}

    def scale_down(self, replica: str, *, role: Optional[str] = None) -> None:
        try:
            self._drain(replica)
            self._reap(replica)
        except (OSError, RuntimeError, ValueError) as e:
            raise ActuatorError(f"scale_down of {replica} failed: {e}") from e

    def set_role(self, replica: str, role: str) -> None:
        if self._set_role is not None:
            try:
                self._set_role(replica, role)
            except (OSError, RuntimeError, ValueError) as e:
                raise ActuatorError(
                    f"role flip on {replica} failed: {e}"
                ) from e
        else:
            post_role(replica, role)


class KubernetesActuator(Actuator):
    """The Kubernetes shape: replica *counts* are actuated by the
    platform, not by this process.  ``scale_up``/``scale_down`` record
    an intent and bump the desired count the controller already exposes
    as ``tpu_controller_desired_replicas{role=...}`` — an
    external-metrics adapter (or a thin sidecar watching
    ``/debug/controller``) scales the serving Deployment to match
    (deploy/k8s-deploy-controller-gpu.yaml carries the manifest pair).
    New pods warm themselves via their own ``--warm-from-fleet`` flag,
    so no donor plumbing is needed here; scale_down relies on the pod
    preStop drain hook the serving Deployment already ships.

    Role flips are immediate either way: the pod's admin
    ``POST /debug/role`` is dialed directly.

    ``apply_fn(intent)`` is the seam for a real client-go/kubectl
    binding (and for tests); absent, intents only accumulate for the
    adapter to scrape."""

    name = "k8s"

    def __init__(self, apply_fn: Optional[Callable[[dict], None]] = None):
        self._apply = apply_fn
        self.desired: dict[str, int] = {}
        self.intents: collections.deque = collections.deque(maxlen=64)

    def _intend(self, intent: dict) -> None:
        self.intents.append(intent)
        if self._apply is not None:
            try:
                self._apply(intent)
            except (OSError, RuntimeError, ValueError) as e:
                raise ActuatorError(f"apply failed: {e}") from e

    def scale_up(self, *, role: str, peers: list) -> dict:
        self.desired[role] = self.desired.get(role, 0) + 1
        self._intend(
            {"verb": "scale_up", "role": role, "desired": self.desired[role]}
        )
        # The Deployment brings the pod; its name is the platform's.
        return {"replica": None, "donor": None}

    def scale_down(self, replica: str, *, role: Optional[str] = None) -> None:
        key = role or "unified"
        self.desired[key] = max(0, self.desired.get(key, 1) - 1)
        self._intend(
            {
                "verb": "scale_down",
                "role": key,
                "replica": replica,
                "desired": self.desired[key],
            }
        )

    def set_role(self, replica: str, role: str) -> None:
        self._intend({"verb": "set_role", "replica": replica, "role": role})
        post_role(replica, role)
