"""The GPU device plugin daemon against the JAX package's TPU daemon.

Both daemons run as their console entry points would (``python -m
<package>.plugin.cli``), each against ``tests/fakes.py:FakeKubelet`` and a
fixture host of four devices on two NUMA nodes: the JAX package's on a
``make_fake_tpu_host`` tree, the port's on a ``tests/torch_gpu_host.py``
tree.  One script drives both; its records are compared with the names
mapped (``tpu-N``/``gpu-N`` to ``dev-N``, the resource and the socket):
registration, the ListAndWatch lists, the health flip after an override
and its recovery, the abort codes of Allocate, re-registration after the
kubelet restarts, hot-unplug and SIGTERM's exit 0 with the socket gone.

Socket directories come from ``tempfile.mkdtemp(dir="/tmp")``: a unix
socket path longer than 107 bytes cannot be bound, and pytest's own temp
directories under xdist can be that long.  The daemons get an explicit
environment without ``TPU_*`` / ``GPU_*`` variables.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import os
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import grpc
import pytest

from k8s_device_plugin_tpu_torch.kubelet.api import pb
from tests.fakes import FakeKubelet, make_fake_tpu_host
from tests.torch_gpu_host import make_fake_gpu_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 20.0

DAEMONS = {
    "jax": dict(package="k8s_device_plugin_tpu", make=make_fake_tpu_host,
                prefix="tpu-", node="accel", override_dir="run/tpu/health"),
    "port": dict(package="k8s_device_plugin_tpu_torch", make=make_fake_gpu_host,
                 prefix="gpu-", node="nvidia", override_dir="run/gpu/health"),
}


def daemon_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TPU_", "GPU_"))}
    env["PYTHONPATH"] = REPO
    return env


class Stream:
    """One ListAndWatch stream read on a thread: each update as a list of
    (id, health)."""

    def __init__(self, stub):
        self.updates = queue.Queue()
        self.call = stub.ListAndWatch(pb.Empty())
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        try:
            for resp in self.call:
                self.updates.put([(d.ID, d.health) for d in resp.devices])
        except grpc.RpcError:
            pass
        self.updates.put(None)

    def until(self, pred, timeout: float = WAIT_S):
        deadline = time.monotonic() + timeout
        while True:
            item = self.updates.get(timeout=max(deadline - time.monotonic(), 0.01))
            assert item is not None, "stream ended"
            if pred(item):
                return item

    def close(self):
        self.call.cancel()


def _code(fn) -> str:
    try:
        fn()
    except grpc.RpcError as e:
        return e.code().name
    return "OK"


def drive(name: str) -> dict:
    """The kubelet's script against one daemon; returns its record."""
    d = DAEMONS[name]
    base = tempfile.mkdtemp(dir="/tmp", prefix="dp-")
    try:
        root = d["make"](os.path.join(base, "host"), 4)
        plugin_dir = os.path.join(base, "kp")
        os.makedirs(plugin_dir)
        kubelet = FakeKubelet(plugin_dir)
        kubelet.start()
        log = open(os.path.join(base, "daemon.log"), "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{d['package']}.plugin.cli", "--root", root,
             "--plugin-dir", plugin_dir, "--pulse", "0.2"],
            cwd=REPO, env=daemon_env(), stdout=log, stderr=subprocess.STDOUT)
        try:
            return _script(d, root, kubelet, proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            kubelet.stop()
            log.seek(0)
            tail = log.read()[-2000:]
            log.close()
            if proc.returncode not in (0, None):
                print(tail)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _script(d, root, kubelet, proc) -> dict:
    rec = {}
    assert kubelet.registered.wait(WAIT_S)
    req = kubelet.requests[-1]
    rec["register"] = (req.version, req.resource_name, req.endpoint,
                       kubelet.options[-1].pre_start_required,
                       kubelet.options[-1].get_preferred_allocation_available)
    rec["initial"] = [(x.ID, x.health, [n.ID for n in x.topology.nodes])
                      for x in kubelet.initial_lists[-1].devices]
    stub = kubelet.plugin_stub()
    stream = Stream(stub)
    rec["first"] = stream.until(lambda _: True)
    one, unknown = d["prefix"] + "1", d["prefix"] + "9"

    def allocate(*ids):
        return stub.Allocate(pb.AllocateRequest(
            container_requests=[pb.ContainerAllocateRequest(devicesIDs=list(ids))]))

    rec["allocate_ok"] = _code(lambda: allocate(one))
    override = os.path.join(root, d["override_dir"], f"{d['node']}1")
    os.makedirs(os.path.dirname(override), exist_ok=True)
    with open(override, "w") as f:
        f.write("Unhealthy")
    rec["flip"] = stream.until(lambda devs: dict(devs)[one] == "Unhealthy")
    rec["abort_unhealthy"] = _code(lambda: allocate(one))
    rec["abort_unknown"] = _code(lambda: allocate(unknown))
    os.unlink(override)
    rec["recover"] = stream.until(lambda devs: dict(devs)[one] == "Healthy")
    stream.close()

    kubelet.restart()
    assert kubelet.registered.wait(WAIT_S)
    rec["registrations"] = len(kubelet.requests)
    rec["after_restart"] = [(x.ID, x.health) for x in kubelet.initial_lists[-1].devices]
    stream = Stream(kubelet.plugin_stub())
    stream.until(lambda _: True)
    os.unlink(os.path.join(root, "dev", f"{d['node']}3"))
    rec["unplug"] = stream.until(lambda devs: len(devs) == 3)
    stream.close()

    socket = os.path.join(kubelet.plugin_dir, kubelet.requests[-1].endpoint)
    rec["socket_before"] = os.path.exists(socket)
    proc.send_signal(signal.SIGTERM)
    rec["exit"] = proc.wait(timeout=WAIT_S)
    rec["socket_after"] = os.path.exists(socket)
    return rec


def _names_mapped(obj):
    """``obj`` with the two daemons' names made one."""
    if isinstance(obj, str):
        for old, new in (("google.com_tpu.sock", "RESOURCE.sock"),
                         ("nvidia.com_gpu.sock", "RESOURCE.sock"),
                         ("google.com/tpu", "RESOURCE"), ("nvidia.com/gpu", "RESOURCE"),
                         ("tpu-", "dev-"), ("gpu-", "dev-")):
            obj = obj.replace(old, new)
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_names_mapped(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _names_mapped(v) for k, v in obj.items()}
    return obj


@pytest.fixture(scope="module")
def records():
    """Both daemons driven at once, one thread each."""
    out, errors = {}, []

    def run(name):
        try:
            out[name] = drive(name)
        except BaseException as e:  # reported below, with the daemon's name
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=(n,)) for n in DAEMONS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a daemon drive hung"
    if errors:
        raise AssertionError(f"{errors[0][0]} daemon: {errors[0][1]!r}") from errors[0][1]
    return out


KEYS = ["register", "initial", "first", "allocate_ok", "flip", "abort_unhealthy",
        "abort_unknown", "recover", "registrations", "after_restart", "unplug",
        "socket_before", "exit", "socket_after"]


@pytest.mark.parametrize("key", KEYS)
def test_gpu_daemon_answers_the_kubelet_as_the_tpu_daemon(records, key):
    assert _names_mapped(records["port"][key]) == _names_mapped(records["jax"][key])


def test_the_script_saw_what_it_checks(records):
    rec = records["port"]
    assert rec["register"] == ("v1beta1", "nvidia.com/gpu", "nvidia.com_gpu.sock", False, True)
    assert rec["initial"] == [(f"gpu-{i}", "Healthy", [i // 2]) for i in range(4)]
    assert dict(rec["flip"])["gpu-1"] == "Unhealthy"
    assert (rec["abort_unhealthy"], rec["abort_unknown"]) == ("FAILED_PRECONDITION", "NOT_FOUND")
    assert rec["registrations"] == 2
    assert [i for i, _ in rec["unplug"]] == ["gpu-0", "gpu-1", "gpu-2"]
    assert rec["socket_before"] and rec["exit"] == 0 and not rec["socket_after"]
