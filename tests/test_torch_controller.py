"""The port's fleet controller (``k8s_device_plugin_tpu_torch/controller/``)
against the JAX package's, on the same inputs.

The reference's controller is jax-free, so it is the oracle: both
``Reconciler``s run one seeded script on a fake clock and every decision,
snapshot and metric sample must be identical (exactly: the controller's
arithmetic is the same float operations in the same order).

- a scripted fleet through ``FleetSimActuator`` (spawns warmed from the
  donor ``donor_for`` picks, drains, reaps, role flips);
- canned ``/debug/fleet`` snapshots with unhealthy replicas, a failing
  actuator and failed polls, in and out of dry-run;
- the actuators (``NullActuator``, ``KubernetesActuator``, ``post_role``
  against a fake replica), ``ControllerServer``'s HTTP surface, and the
  CLI's refusals.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import json
import random
import urllib.request

import pytest

from k8s_device_plugin_tpu import controller as jctl
from k8s_device_plugin_tpu.controller import __main__ as jcli
from k8s_device_plugin_tpu.controller import actuators as jactuators
from k8s_device_plugin_tpu.router import migration as jmigration
from k8s_device_plugin_tpu.utils.flight import FlightRecorder as JFlightRecorder
from k8s_device_plugin_tpu.utils.metrics import MetricsRegistry as JRegistry
from k8s_device_plugin_tpu_torch import controller as tctl
from k8s_device_plugin_tpu_torch.controller import __main__ as tcli
from k8s_device_plugin_tpu_torch.controller import actuators as tactuators
from k8s_device_plugin_tpu_torch.router import migration as tmigration
from k8s_device_plugin_tpu_torch.utils.flight import FlightRecorder as TFlightRecorder
from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry as TRegistry
from tests.fakes import FakeReplica

SIDES = {"jax": (jctl, jmigration, JRegistry, JFlightRecorder),
         "port": (tctl, tmigration, TRegistry, TFlightRecorder)}


def _samples(registry) -> list:
    """The exposition's sample lines (HELP text names each side's manifest)."""
    return [line for line in registry.render().splitlines() if not line.startswith("# HELP")]


def _reconciler(side, fetch, actuator, clock, **cfg):
    ctl, _, registry_cls, flight_cls = SIDES[side]
    registry = registry_cls()
    rc = ctl.Reconciler(fetch, actuator, config=ctl.ControllerConfig(**cfg),
                        metrics=ctl.ControllerMetrics(registry),
                        flight=flight_cls(capacity=512, name="controller"), now=lambda: clock[0])
    return rc, registry


class _Fleet:
    """A scripted fleet: per-replica pressure from a seeded demand trace,
    changed only through the actuator's verbs."""

    def __init__(self, migration, seed: int):
        self.migration = migration
        self.rng = random.Random(seed)
        self.roles = {"d0:1": "decode", "d1:1": "decode", "p0:1": "prefill", "u0:1": "unified"}
        self.warming: dict = {}  # name -> (ready tick, role)
        self.events: list = []
        self.n = 0
        self.tick = 0

    def spawn(self, role):
        self.n += 1
        name = f"new{self.n}:1"
        self.warming[name] = (self.tick + 2, role)
        self.events.append(("spawn", name, role))
        return name

    def warm(self, name, donor):
        self.events.append(("warm", name, donor))

    def join(self, name, role):
        self.events.append(("join", name, role))

    def drain(self, name):
        self.events.append(("drain", name))

    def reap(self, name):
        self.events.append(("reap", name))
        self.roles.pop(name, None)

    def set_role(self, name, role):
        self.events.append(("role", name, role))
        self.roles[name] = role

    def fleet(self) -> dict:
        for name, (ready, role) in list(self.warming.items()):
            if ready <= self.tick:
                del self.warming[name]
                self.roles[name] = role
        self.tick += 1
        load = 1.5 + 1.4 * ((self.tick // 12) % 3 - 1) + self.rng.uniform(-0.3, 0.3)
        decode = [n for n, r in self.roles.items() if r != "prefill"]
        rows = {}
        for name, role in sorted(self.roles.items()):
            share = load * 3 / max(1, len(decode)) if role != "prefill" else \
                self.rng.choice((0.1, 0.4, 3.0))
            rows[name] = {"role": role, "pressure_s": round(max(0.0, share), 4),
                          "queue_depth": int(share * 4), "active_slots": 2,
                          "eligible": role != "prefill", "reachable": True,
                          "draining": False, "fenced": False}
        for name, (_, role) in self.warming.items():
            rows[name] = {"role": role, "pressure_s": 0.0, "queue_depth": 0,
                          "active_slots": 0, "eligible": False, "reachable": True,
                          "draining": False, "fenced": False}
        return {"replicas": rows, "recommendation": self.migration.scale_recommendation(rows)}


@pytest.mark.parametrize("seed", [0, 1])
def test_reconciler_decisions_equal_over_a_scripted_fleet(seed):
    def run(side):
        ctl, migration = SIDES[side][:2]
        fleet = _Fleet(migration, seed)
        clock = [0.0]
        actuator = ctl.FleetSimActuator(spawn_fn=fleet.spawn, join_fn=fleet.join,
                                        drain_fn=fleet.drain, reap_fn=fleet.reap,
                                        warm_fn=fleet.warm, set_role_fn=fleet.set_role)
        rc, registry = _reconciler(side, fleet.fleet, actuator, clock, sustain_ticks=2,
                                   cooldown_s=6.0, min_replicas=1, max_replicas=8)
        decisions = []
        for _ in range(90):
            decisions.append(rc.tick())
            clock[0] += 2.0
        return decisions, fleet.events, rc.snapshot(last=256), _samples(registry)

    want = run("jax")
    assert run("port") == want
    assert {e[0] for e in want[1]} >= {"spawn", "warm", "join"}  # the script scales


def _recording(ctl, fail_every: int):
    """An actuator over either side's base class: records every verb and
    raises that side's ``ActuatorError`` on every ``fail_every``-th call."""

    class Recording(ctl.Actuator):
        name = "recording"

        def __init__(self):
            self.calls, self.spawned = [], 0

        def _maybe_fail(self):
            if fail_every and (len(self.calls) + 1) % fail_every == 0:
                self.calls.append(("failed",))
                raise ctl.ActuatorError("backend down")

        def scale_up(self, *, role, peers):
            self._maybe_fail()
            self.spawned += 1
            self.calls.append(("scale_up", role, tuple(peers)))
            return {"replica": f"new{self.spawned}:1", "donor": peers[0] if peers else None}

        def scale_down(self, replica, *, role=None):
            self._maybe_fail()
            self.calls.append(("scale_down", replica, role))

        def set_role(self, replica, role):
            self._maybe_fail()
            self.calls.append(("set_role", replica, role))

    return Recording()


@pytest.mark.parametrize("dry_run", [False, True])
def test_reconciler_decisions_equal_over_canned_snapshots(dry_run):
    def run(side):
        ctl, migration = SIDES[side][:2]
        rng = random.Random(7)
        clock = [0.0]

        def fetch():
            if rng.random() < 0.05:
                raise OSError("router unreachable")
            rows = {}
            for i in range(rng.randint(1, 6)):
                role = rng.choice(("decode", "decode", "prefill", "unified"))
                reachable, draining, fenced = (rng.random() < 0.9, rng.random() < 0.1,
                                               rng.random() < 0.05)
                rows[f"r{i}:1"] = {
                    "role": role, "pressure_s": rng.choice((0.0, 0.1, 0.3, 1.0, 2.5, 6.0)),
                    "queue_depth": rng.randrange(6), "active_slots": rng.randrange(4),
                    "eligible": reachable and not draining and not fenced and role != "prefill",
                    "reachable": reachable, "draining": draining, "fenced": fenced}
            return {"replicas": rows, "recommendation": migration.scale_recommendation(rows)}

        actuator = _recording(ctl, fail_every=4)
        rc, registry = _reconciler(side, fetch, actuator, clock, sustain_ticks=2,
                                   cooldown_s=5.0, max_replicas=5, dry_run=dry_run)
        decisions = []
        for _ in range(150):
            decisions.append(rc.tick())
            clock[0] += rng.choice((1.0, 2.0, 7.0))
        return decisions, actuator.calls, rc.snapshot(last=256), _samples(registry)

    want = run("jax")
    assert run("port") == want
    outcomes = {d["outcome"] for d in want[0]}
    assert "poll_error" in outcomes and ("dry_run" if dry_run else "executed") in outcomes


def test_actuators_equal():
    for ctl in (jctl, tctl):
        with pytest.raises(ctl.ActuatorError):
            ctl.NullActuator().scale_up(role="decode", peers=[])
    intents = {}
    for side, ctl in (("jax", jctl), ("port", tctl)):
        applied = []
        k8s = ctl.KubernetesActuator(apply_fn=applied.append)
        out = [k8s.scale_up(role="decode", peers=["a:1"]), k8s.scale_up(role="prefill", peers=[])]
        k8s.scale_down("a:1", role="decode")
        k8s.scale_down("b:1")
        intents[side] = (out, applied, list(k8s.intents), k8s.desired)
    assert intents["port"] == intents["jax"]
    # Donor choice: the port's donor_for walks the same ring.
    donors = {}
    for side, ctl in (("jax", jctl), ("port", tctl)):
        picked = []
        sim = ctl.FleetSimActuator(spawn_fn=lambda role: "joiner:9", join_fn=lambda n, r: None,
                                   drain_fn=lambda n: None, reap_fn=lambda n: None,
                                   warm_fn=lambda n, d: picked.append(d))
        donors[side] = [sim.scale_up(role="decode", peers=[f"p{i}:{j}" for i in range(k)])
                        for k in range(1, 6) for j in (1, 2)], picked
    assert donors["port"] == donors["jax"]
    # post_role: the replica's admin route, the same wire.
    replica = FakeReplica().start()
    try:
        answers = [mod.post_role(replica.name, role)
                   for mod in (jactuators, tactuators) for role in ("prefill", "decode")]
    finally:
        replica.stop()
    assert answers[2:] == answers[:2] and replica.role_flips == 4


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        body = resp.read()
    return json.loads(body) if path.startswith("/debug") else body.decode()


def test_controller_server_surfaces_equal():
    views = {}
    for side in ("jax", "port"):
        ctl, migration = SIDES[side][:2]
        rows = {"d0:1": {"role": "decode", "pressure_s": 3.0, "queue_depth": 4,
                         "eligible": True, "reachable": True, "draining": False,
                         "fenced": False}}
        fleet = {"replicas": rows, "recommendation": migration.scale_recommendation(rows)}
        clock = [0.0]
        rc, registry = _reconciler(side, lambda: fleet, ctl.NullActuator(), clock,
                                   interval_s=3600.0)
        rc.tick()
        server = ctl.ControllerServer(rc, registry, host="127.0.0.1", port=0)
        server.start()
        try:
            state = _get(server.port, "/debug/state")
            views[side] = (_get(server.port, "/healthz"), _get(server.port, "/debug/controller"),
                           sorted(state), [e["kind"] for e in
                                           _get(server.port, "/debug/flight")["events"]],
                           [line for line in _get(server.port, "/metrics").splitlines()
                            if not line.startswith("# HELP")])
        finally:
            server.stop()
    assert views["port"] == views["jax"]


@pytest.mark.parametrize("argv", [["--url", "http://r:1", "--sustain-ticks", "0"],
                                  ["--url", "http://r:1", "--hot-wait", "0.1"], []])
def test_cli_refuses_what_the_reference_refuses(argv):
    codes = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        codes.append(exc.value.code)
    assert codes[0] == codes[1] == 2
