"""The port's router (``k8s_device_plugin_tpu_torch/router/``) against the
JAX package's, on the same inputs.

The reference's router is jax-free (stdlib, numpy and the repository's
``utils``), so its modules are the oracle here, with ``tests/fakes.py``
``FakeReplica`` as the fleet: every check drives both on one seeded
script and asserts identical results, exactly (no tolerance: the router
computes no floating-point value that could part).

- the ring's placements and ``prefix_key`` across membership changes;
- breaker and retry-budget state sequences under a scripted clock;
- ``RoutingPolicy`` picks (both modes, the random one under a seed),
  ``DisaggPolicy``/``pick_prefill``, ``MigrationPlanner`` plans and
  ``scale_recommendation`` on a grid;
- ``FabricLocator`` verdicts and ``FabricReplicator`` plans;
- both ``RouterServer``s in front of fake replicas at the same addresses
  (a fresh fleet for each side, so replica-side counters start equal), on
  one scripted request list with a mid-stream kill: the same placements,
  failovers, retries and response bytes;
- the canary prober's mismatch detection and fence;
- ``FleetPostmortem``'s bundles, classified by ``tools/postmortem.py``;
- the router CLI's flags (by AST) and the GPU manifests' flags.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import argparse
import ast
import contextlib
import http.client
import http.server
import json
import os
import pathlib
import random
import socket
import threading
import time
import urllib.request
from unittest import mock

import pytest

from k8s_device_plugin_tpu.router import breaker as jbreaker
from k8s_device_plugin_tpu.router import disagg as jdisagg
from k8s_device_plugin_tpu.router import fabric as jfabric
from k8s_device_plugin_tpu.router import migration as jmigration
from k8s_device_plugin_tpu.router import policy as jpolicy
from k8s_device_plugin_tpu.router import postmortem as jpostmortem
from k8s_device_plugin_tpu.router import prober as jprober
from k8s_device_plugin_tpu.router import ring as jring
from k8s_device_plugin_tpu.router import server as jserver
from k8s_device_plugin_tpu.utils.anomaly import AnomalyMonitor as JAnomalyMonitor
from k8s_device_plugin_tpu.utils.flight import FlightRecorder as JFlightRecorder
from k8s_device_plugin_tpu.utils.prefixbloom import PrefixBloom as JPrefixBloom
from k8s_device_plugin_tpu_torch.router import breaker as tbreaker
from k8s_device_plugin_tpu_torch.router import disagg as tdisagg
from k8s_device_plugin_tpu_torch.router import fabric as tfabric
from k8s_device_plugin_tpu_torch.router import migration as tmigration
from k8s_device_plugin_tpu_torch.router import policy as tpolicy
from k8s_device_plugin_tpu_torch.router import postmortem as tpostmortem
from k8s_device_plugin_tpu_torch.router import prober as tprober
from k8s_device_plugin_tpu_torch.router import ring as tring
from k8s_device_plugin_tpu_torch.router import server as tserver
from k8s_device_plugin_tpu_torch.utils.anomaly import AnomalyMonitor as TAnomalyMonitor
from k8s_device_plugin_tpu_torch.utils.flight import FlightRecorder as TFlightRecorder
from k8s_device_plugin_tpu_torch.utils.prefixbloom import PrefixBloom as TPrefixBloom
from tests.fakes import FakeReplica, fake_generate
from tools import postmortem as pm_tool

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _wait(pred, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ------------------------------------------------------------------ pure


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_placements_and_prefix_keys_equal(seed):
    rng = random.Random(seed)
    prompts = [[rng.randrange(32000) for _ in range(rng.randint(1, 90))] for _ in range(300)]
    for block, blocks in ((16, 4), (4, 4), (1, 2), (7, 3)):
        assert [tring.prefix_key(p, block, blocks) for p in prompts] == \
            [jring.prefix_key(p, block, blocks) for p in prompts]
    for bad in ((0, 4), (16, 0)):
        for mod in (jring, tring):
            with pytest.raises(ValueError):
                mod.prefix_key([1, 2], *bad)
    blobs = [bytes(rng.randrange(256) for _ in range(rng.randint(0, 40))) for _ in range(50)]
    assert [tring._hash64(b) for b in blobs] == [jring._hash64(b) for b in blobs]
    keys = [jring.prefix_key(p) for p in prompts]
    members = [f"10.0.{seed}.{i}:8000" for i in range(4)]
    rings = [jring.HashRing(members, vnodes=32), tring.HashRing(members, vnodes=32)]
    for step in range(12):  # joins and leaves: the placements follow together
        views = [([r.lookup(k) for k in keys], [r.order(k) for k in keys[:40]],
                  [r.order(k, limit=2) for k in keys[:40]], r.snapshot(), len(r))
                 for r in rings]
        assert views[0] == views[1], step
        if rng.random() < 0.5 and len(rings[0]) > 1:
            gone = rng.choice(sorted(rings[0].nodes))
            for r in rings:
                r.remove(gone)
        else:
            new = f"10.1.{seed}.{step}:{8000 + step}"
            for r in rings:
                r.add(new)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_and_retry_budget_sequences_equal(seed):
    def run(mod):
        rng = random.Random(seed)
        clock = [0.0]
        transitions = []
        cb = mod.CircuitBreaker(failure_threshold=rng.randint(1, 3), open_s=2.0,
                                clock=lambda: clock[0],
                                on_transition=lambda a, b: transitions.append((a, b)))
        budget = mod.RetryBudget(capacity=3.0, refill_per_s=0.5, clock=lambda: clock[0])
        seq = []
        for _ in range(200):
            op = rng.choice(("fail", "ok", "acquire", "spend", "tick"))
            if op == "fail":
                out = cb.record_failure()
            elif op == "ok":
                out = cb.record_success()
            elif op == "acquire":
                out = cb.try_acquire()
            elif op == "spend":
                out = budget.try_spend(rng.choice((1.0, 0.5, 2.0)))
            else:
                clock[0] += rng.choice((0.1, 0.7, 2.5))
                out = None
            seq.append((op, out, cb.state, cb.snapshot(), budget.available(),
                        budget.spent_total, budget.exhausted_total))
        return seq, transitions

    assert run(tbreaker) == run(jbreaker)


@pytest.mark.parametrize("mode", ["affinity", "random"])
def test_routing_policy_picks_equal(mode):
    names = [f"r{i}:80" for i in range(5)]

    def run(ring_mod, breaker_mod, policy_mod):
        rng = random.Random(11)
        states = {n: policy_mod.ReplicaState(n, breaker_mod.CircuitBreaker()) for n in names}
        policy = policy_mod.RoutingPolicy(ring_mod.HashRing(names, vnodes=32), states,
                                          overflow_depth=3, prefix_block_tokens=4,
                                          prefix_max_blocks=4, mode=mode, seed=7)
        picks = []
        for _ in range(150):
            st = states[rng.choice(names)]
            field = rng.choice(("draining", "fenced", "reachable", "queue_depth", "role"))
            if field == "queue_depth":
                st.queue_depth = rng.randrange(8)
            elif field == "role":
                st.role = rng.choice(("unified", "unified", "prefill", "decode"))
            else:
                setattr(st, field, rng.random() < 0.3 if field != "reachable"
                        else rng.random() < 0.8)
            prompt = [rng.randrange(64) for _ in range(rng.randint(1, 24))]
            picks.append((policy.key_of(prompt), policy.candidates(prompt)))
        return picks

    assert run(tring, tbreaker, tpolicy) == run(jring, jbreaker, jpolicy)


def test_disagg_classify_and_pick_prefill_equal():
    grid = [(tokens, pressure, up) for tokens in (0, 1, 63, 64, 65, 255, 256, 4000)
            for pressure in (0.0, 0.49, 0.5, 3.0) for up in (False, True)]
    for cfg in ({}, {"threshold_tokens": 32, "hot_threshold_tokens": 8, "hot_wait_s": 0.1}):
        want = jdisagg.DisaggPolicy(jdisagg.DisaggConfig(**cfg))
        got = tdisagg.DisaggPolicy(tdisagg.DisaggConfig(**cfg))
        assert [got.classify(*g) for g in grid] == [want.classify(*g) for g in grid]
        assert got.snapshot() == want.snapshot()
    for bad in ({"threshold_tokens": 0}, {"threshold_tokens": 8, "hot_threshold_tokens": 9}):
        for mod in (jdisagg, tdisagg):
            with pytest.raises(ValueError):
                mod.DisaggConfig(**bad)
    rng = random.Random(3)
    pools = [{f"p{i}:1": rng.choice((0.0, 0.5, 1.0, rng.random())) for i in range(n)}
             for n in range(6) for _ in range(10)]
    assert [tdisagg.pick_prefill(p) for p in pools] == [jdisagg.pick_prefill(p) for p in pools]


def test_migration_plans_and_scale_recommendation_equal():
    def plans(mod):
        rng = random.Random(5)
        clock = [0.0]
        planner = mod.MigrationPlanner(mod.MigrationConfig(sustain_polls=2, cooldown_s=3.0),
                                       now=lambda: clock[0])
        out = []
        for sweep in range(120):
            for i in range(4):
                planner.observe(f"r{i}:1", wait_ewma_s=rng.choice((None, 0.1, 0.4, 2.5, 6.0)),
                                drain_rate_rps=rng.choice((None, 0.0, 2.0)),
                                queue_depth=rng.randrange(12), eligible=rng.random() < 0.9)
            if sweep % 17 == 16:
                planner.forget("r1:1")
            out.append((planner.plan(), planner.snapshot()))
            clock[0] += rng.choice((0.5, 1.0, 4.0))
        return out

    assert plans(tmigration) == plans(jmigration)
    args = [(w, r, q) for w in (None, 0.0, 0.3, 5.0) for r in (None, 0.0, 1.5) for q in (0, 3)]
    assert [tmigration.replica_pressure(*a) for a in args] == \
        [jmigration.replica_pressure(*a) for a in args]
    rng = random.Random(9)
    for _ in range(200):
        rows = {f"r{i}:1": {"pressure_s": rng.choice((0.0, 0.2, 0.5, 1.0, 2.0, 9.0)),
                            "queue_depth": rng.choice((0, 0, 4)),
                            "eligible": rng.random() < 0.85}
                for i in range(rng.randint(0, 6))}
        for kw in ({}, {"hot_wait_s": 0.2, "cold_wait_s": 0.02}):
            assert tmigration.scale_recommendation(rows, **kw) == \
                jmigration.scale_recommendation(rows, **kw)


def _bloom_wire(bloom_cls, prefixes, page_size: int, root: int = -1) -> dict:
    bloom = bloom_cls()
    for p in prefixes:
        bloom.add(root, p)
    wire = bloom.to_wire()
    wire["page_size"] = page_size
    return wire


def test_fabric_locator_verdicts_and_replicator_plans_equal():
    rng = random.Random(21)
    page = 4
    heads = [[rng.randrange(2, 512) for _ in range(6 * page)] for _ in range(5)]
    names = [f"r{i}:1" for i in range(4)]
    locs = [jfabric.FabricLocator(page), tfabric.FabricLocator(page)]
    cfg = dict(replicate_k=2, hot_wait_s=1.0, cold_wait_s=0.2, hot_score=2.0, cold_sweeps=2,
               confirm_sweeps=2, default_page_size=page)
    reps = [jfabric.FabricReplicator(jfabric.FabricConfig(**cfg)),
            tfabric.FabricReplicator(tfabric.FabricConfig(**cfg))]
    for sweep in range(25):
        for name in names:
            pick = rng.random()
            if pick < 0.15:
                update = None
            elif pick < 0.2:
                update = {"bogus": 1}
            else:
                held = [h[: page * rng.randint(1, 6)] for h in heads if rng.random() < 0.4]
                prefixes = [p[: page * k] for p in held for k in range(1, len(p) // page + 1)]
                update = _bloom_wire(JPrefixBloom, prefixes, page)
                # The port's bloom writes the same wire.
                assert _bloom_wire(TPrefixBloom, prefixes, page) == update
            assert locs[1].update(name, update) == locs[0].update(name, update)
        if sweep % 9 == 8:
            for loc in locs:
                loc.forget(names[sweep % len(names)])
        prompts = [h[: rng.randint(1, len(h))] + [rng.randrange(512)] for h in heads]
        views = [([loc.coverage(n, p) for n in names for p in prompts],
                  [loc.best_owner(p, names) for p in prompts],
                  [loc.owners(p, names) for p in prompts],
                  loc.advertised_roots(), loc.page_size()) for loc in locs]
        assert views[1] == views[0], sweep
        hot = {tuple(h[: page * rng.randint(1, 6)]): rng.randint(0, 3) for h in heads}
        pressures = {n: rng.choice((0.0, 0.1, 0.5, 3.0)) for n in names}
        plans = [rep.plan(loc, hot, pressures) for rep, loc in zip(reps, locs)]
        assert plans[1] == plans[0], sweep
        assert reps[1].snapshot() == reps[0].snapshot()


# --------------------------------------------- the routers over a fleet

ROUTER_KW = dict(host="127.0.0.1", port=0, poll_interval_s=0.1, breaker_failures=1,
                 breaker_open_s=0.3, backoff_base_s=0.02, backoff_max_s=0.2, hedge=False,
                 upstream_timeout_s=10.0, request_timeout_s=30.0, seed=3)


def _post(port: int, prompt, n: int, rid: str) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def _stream(port: int, prompt, n: int, rid: str) -> list:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt, "max_new_tokens": n, "stream": True}).encode(),
                     headers={"Content-Type": "application/json", "X-Request-Id": rid})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        lines = []
        while True:
            line = resp.readline()
            if not line:
                return lines
            if line.strip():
                lines.append(line.strip())
            if line.startswith(b"data:") and (b'"done"' in line or b'"error"' in line):
                return lines
    finally:
        conn.close()


def _home_prompt(router, name: str, base: int) -> list:
    for salt in range(base, base + 2000):
        prompt = [salt % 500 + 2] * 8 + [salt // 500 + 2] * 8
        if router.ring.order(router.policy.key_of(prompt))[0] == name:
            return prompt
    raise AssertionError(f"no prompt homes on {name}")


@contextlib.contextmanager
def _held_ports(n: int):
    """``n`` loopback ports held, for the block's length, by bound sockets
    that never listen (``SO_REUSEPORT``). Fakes started on them in turn
    (reuse-port too, see :func:`_drive`) keep the same names, a killed
    fake's port refuses connections, and no other process can bind a port
    between one fleet and the next."""
    with contextlib.ExitStack() as stack:
        ports = []
        for _ in range(n):
            sock = stack.enter_context(socket.socket())
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
        yield ports


def _drive(server_mod, ports: list) -> dict:
    """One scripted run of ``server_mod.RouterServer`` over a fresh fleet of
    fake replicas on ``ports`` (held by :func:`_held_ports`): a seeded unary
    script (placements read off the replicas' own counters), then a stream
    cut by killing its replica mid-decode, then unary requests homed on the
    dead replica."""
    with mock.patch.object(http.server.ThreadingHTTPServer, "allow_reuse_port", True):
        replicas = [FakeReplica(port=p, token_delay_s=0.004).start() for p in ports]
    router = server_mod.RouterServer([r.name for r in replicas], **ROUTER_KW).start()
    trace = {"unary": [], "after_kill": []}
    try:
        rng = random.Random(4)
        sessions = [[rng.randrange(2, 400) for _ in range(16)] for _ in range(5)]
        for i in range(24):
            prompt = rng.choice(sessions) + [rng.randrange(2, 400) for _ in range(rng.randint(0, 5))]
            before = [r.generate_requests for r in replicas]
            body = _post(router.port, prompt, rng.randint(1, 6), f"unary-{i}")
            served = [j for j, r in enumerate(replicas) if r.generate_requests != before[j]]
            trace["unary"].append((served, body))
        victim = replicas[0]
        prompt = _home_prompt(router, victim.name, 0)
        held = {}
        client = threading.Thread(
            target=lambda: held.setdefault("lines", _stream(router.port, prompt, 24, "cut")))
        client.start()
        assert _wait(lambda: victim.active_streams > 0)
        time.sleep(0.03)  # a few tokens into the decode
        victim.kill()
        client.join(timeout=30)
        assert not client.is_alive()
        trace["stream_tokens"] = [json.loads(line[5:])["token"] for line in held["lines"]
                                  if line.startswith(b"data:") and b'"token"' in line]
        trace["stream_done"] = json.loads(held["lines"][-1][5:])
        assert trace["stream_tokens"] == fake_generate(prompt, 24)
        # The poll's verdict first, so both routers place what follows
        # from the same view of the fleet.
        assert _wait(lambda: not router.replicas[victim.name].reachable)
        for i in range(4):
            prompt = _home_prompt(router, victim.name, 100 * (i + 1))
            trace["after_kill"].append(_post(router.port, prompt, 3, f"dead-home-{i}"))
        metrics = router.metrics
        trace["counters"] = {
            "placements": {k: metrics.placements.value(placement=k)
                           for k in ("home", "overflow", "random", "failover")},
            "failovers": metrics.failovers.value(),
            "retries": metrics.retries.value(),
            "ok": metrics.requests.value(outcome="ok"),
        }
        trace["breakers"] = {i: router.snapshot()["replicas"][r.name]["breaker"]["state"]
                             for i, r in enumerate(replicas)}
    finally:
        router.stop()
        for r in replicas:
            if not r.killed.is_set():
                r.stop()
    return trace


def test_router_servers_equal_over_fake_replicas():
    # The same replica names (ports) for both routers: placements hash them.
    with _held_ports(3) as ports:
        want = _drive(jserver, ports)
        got = _drive(tserver, ports)
    assert got["unary"] == want["unary"]
    assert got["stream_tokens"] == want["stream_tokens"]
    assert got["stream_done"] == want["stream_done"]
    assert got["after_kill"] == want["after_kill"]
    assert got["counters"] == want["counters"]
    assert got["breakers"] == want["breakers"]
    assert got["counters"]["failovers"] == 1


# ------------------------------------------------- prober and postmortem


def test_canary_prober_detection_and_fence_equal():
    def run(prober_mod, flight_cls, anomaly_cls):
        replica = FakeReplica().start()
        replica.corrupt_after = 2  # two clean sweeps, then every answer wrong
        try:
            flight = flight_cls(capacity=256, name="canary")
            monitor = anomaly_cls(flight=flight)
            prober = prober_mod.CanaryProber(
                lambda: [replica.name],
                config=prober_mod.CanaryConfig(interval_s=0.05, prompts=((11, 13, 17, 19),),
                                               k_mismatch=2),
                flight=flight, anomaly=monitor)
            verdicts = [prober.probe_once()[replica.name] for _ in range(6)]
            snap = prober.snapshot()
            row = snap["replicas"][replica.name]
            incidents = [i["metric"] for i in monitor.incidents()]
            return (verdicts, snap["fences_fired"], row["mismatches"], row["probes"],
                    row["fenced_by_canary"], incidents, replica._fenced.is_set(),
                    replica.fence_reason)
        finally:
            replica.stop()

    want = run(jprober, JFlightRecorder, JAnomalyMonitor)
    assert run(tprober, TFlightRecorder, TAnomalyMonitor) == want
    assert "mismatch" in want[0] and want[1] == 1 and want[6] is True


@pytest.mark.parametrize("fault", ["watchdog_fence", "device_unplug"])
def test_fleet_postmortem_bundles_classify_equal(tmp_path, fault):
    def run(pm_mod, flight_cls, sub):
        replica = FakeReplica().start()
        try:
            if fault == "watchdog_fence":
                replica.begin_fence(reason="hung_step", source="watchdog")
            else:
                replica.flight.record("device.unplug", device="gpu-3")
            flight = flight_cls(capacity=256, name="router")
            fleet = pm_mod.FleetPostmortem(
                str(tmp_path / sub), lambda: [replica.name], flight=flight,
                local_fn=lambda: {"component": "router", "flight": flight.snapshot(),
                                  "state": {"replicas": 1}})
            path = fleet.capture_now("ep-1", trigger="summary_poll")
            manifest = json.loads((pathlib.Path(path) / "manifest.json").read_text())
            loaded = pm_tool.load_bundle(path)
            verdict = pm_tool.classify(pm_tool.build_timeline(loaded["components"]))
            names = sorted(p.replace(replica.name.replace(":", "_"), "R")
                           for p in os.listdir(path))
            accounts = {k.replace(replica.name, "R"): v
                        for k, v in manifest["components"].items()}
            return (names, manifest["schema"], manifest["incident_id"], accounts,
                    verdict["root_cause"], fleet.snapshot()["captures"])
        finally:
            replica.stop()

    want = run(jpostmortem, JFlightRecorder, "jax")
    assert run(tpostmortem, TFlightRecorder, "port") == want
    if fault == "watchdog_fence":
        assert want[4] == "watchdog_hang"


# ------------------------------------------------------------ CLI, deploy


def _cli_flags(path: pathlib.Path) -> list:
    """Every ``add_argument`` of the module's ``main``: its option strings
    and its keywords but ``help``, as source."""
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [([ast.literal_eval(a) for a in call.args],
             {k.arg: ast.unparse(k.value) for k in call.keywords if k.arg != "help"})
            for call in ast.walk(main)
            if isinstance(call, ast.Call) and getattr(call.func, "attr", "") == "add_argument"]


@pytest.mark.parametrize("module", ["router/server.py", "controller/__main__.py"])
def test_cli_flags_equal_the_reference(module):
    want = _cli_flags(ROOT / "k8s_device_plugin_tpu" / module)
    assert want and _cli_flags(ROOT / "k8s_device_plugin_tpu_torch" / module) == want


class _Parsed(Exception):
    pass


_PARSE_ARGS = argparse.ArgumentParser.parse_args


def _parsed(monkeypatch, main, argv) -> argparse.Namespace:
    """``main(argv)``'s parsed flags, stopping before it serves."""
    held = {}

    def grab(self, args=None, namespace=None):
        held["args"] = _PARSE_ARGS(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main(argv)
    return held["args"]


def test_chip_smoke_routes_with_the_router_manifests_flags():
    """``chip_smoke.py``'s router runs with the GPU router manifest's flags,
    but the replica list and the port it sets for its own fleet."""
    import yaml

    [router] = [doc["spec"]["template"]["spec"]["containers"][0]
                for doc in yaml.safe_load_all(
                    (ROOT / "deploy" / "k8s-deploy-router-gpu.yaml").read_text())
                if doc["kind"] == "Deployment"]
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    [flags] = [ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and [getattr(t, "id", None) for t in node.targets] == ["ROUTER_FLAGS"]]
    own = ("--replicas-dns=", "--http-port=")
    assert list(flags) == [a for a in router["args"] if not a.startswith(own)]


def test_gpu_manifests_run_the_port_with_flags_its_clis_take(monkeypatch):
    import yaml

    from k8s_device_plugin_tpu_torch.controller.__main__ import main as controller_main

    docs = {name: list(yaml.safe_load_all((ROOT / "deploy" / name).read_text()))
            for name in ("k8s-deploy-router-gpu.yaml", "k8s-deploy-controller-gpu.yaml",
                         "k8s-pod-serve-gpu.yaml")}
    [pod] = docs["k8s-pod-serve-gpu.yaml"]
    containers = {}
    for name in ("k8s-deploy-router-gpu.yaml", "k8s-deploy-controller-gpu.yaml"):
        for doc in docs[name]:
            if doc["kind"] == "Deployment":
                [c] = doc["spec"]["template"]["spec"]["containers"]
                containers[name] = c
                assert "nvidia.com/gpu" not in json.dumps(c)  # host-side only
    router, controller = (containers["k8s-deploy-router-gpu.yaml"],
                          containers["k8s-deploy-controller-gpu.yaml"])
    assert router["command"] == ["python", "-m", "k8s_device_plugin_tpu_torch.router"]
    assert controller["command"] == ["python", "-m", "k8s_device_plugin_tpu_torch.controller"]
    args = _parsed(monkeypatch, tserver.main, router["args"])
    assert args.prefix_block_tokens == 16 and args.prefix_blocks == 4
    # The router fronts the GPU serve pods: its headless Service selects
    # their label, on the port they serve.
    [svc] = [d for d in docs["k8s-deploy-router-gpu.yaml"]
             if d["kind"] == "Service" and d["spec"].get("clusterIP") == "None"]
    assert svc["spec"]["selector"].items() <= pod["metadata"]["labels"].items()
    assert args.replicas_dns == f"{svc['metadata']['name']}:{svc['spec']['ports'][0]['port']}"
    assert "--page-size=16" in pod["spec"]["containers"][0]["args"]
    # The controller polls the router's Service on a port it exposes.
    [front] = [d for d in docs["k8s-deploy-router-gpu.yaml"]
               if d["kind"] == "Service" and d["spec"].get("clusterIP") != "None"]
    cargs = _parsed(monkeypatch, controller_main, controller["args"])
    assert cargs.url in {f"http://{front['metadata']['name']}:{p['port']}"
                         for p in front["spec"]["ports"]}
    assert f":{args.http_port}" in cargs.url
