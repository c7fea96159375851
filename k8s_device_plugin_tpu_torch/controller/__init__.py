"""Closed-loop fleet autoscaler: a jax-free reconciler that
polls the router's ``/debug/fleet``, computes a desired fleet spec
(size x role mix) from the host-side pressure signals, and converges
the live fleet through a pluggable actuator — warm scale-up, drain-down,
and role rebalancing, with hysteresis/cooldown flap guards.

The port's own copy of the reference's ``controller/__init__.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.

Run it: ``python -m k8s_device_plugin_tpu_torch.controller --url http://router:8100``.
"""

from .actuators import (
    Actuator,
    ActuatorError,
    FleetSimActuator,
    KubernetesActuator,
    NullActuator,
)
from .reconciler import (
    ACTIONS,
    OUTCOMES,
    ControllerConfig,
    ControllerMetrics,
    Reconciler,
    fetch_fleet,
)
from .server import ControllerServer

__all__ = [
    "ACTIONS",
    "OUTCOMES",
    "Actuator",
    "ActuatorError",
    "ControllerConfig",
    "ControllerMetrics",
    "ControllerServer",
    "FleetSimActuator",
    "KubernetesActuator",
    "NullActuator",
    "Reconciler",
    "fetch_fleet",
]
