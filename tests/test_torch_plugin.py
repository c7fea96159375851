"""The port's GPU device plugin, module by module, on NVIDIA fixture trees.

Each module is held against its counterpart in the JAX package where the
two share behaviour (the kubelet copies, logging, ``timed_rpc``, the
health checker's rules, the self-test's checksum and quarantine, the CLI's
flags), and against the NVIDIA host layout where they differ (discovery,
NUMA preference, Allocate's grant, the env the port's own readers take).
Trees come from ``tests/torch_gpu_host.py`` and ``tests/fakes.py``; every
call passes ``environ`` explicitly (this machine's Python may inject
``TPU_*`` variables).
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import ctypes.util
import json
import logging
import os
import pathlib
import tomllib

import grpc
import pytest

from k8s_device_plugin_tpu.kubelet import api as jax_api
from k8s_device_plugin_tpu.kubelet import constants as jax_constants
from k8s_device_plugin_tpu.plugin import cli as jax_cli
from k8s_device_plugin_tpu.plugin import discovery as jax_discovery
from k8s_device_plugin_tpu.plugin import health as jax_health
from k8s_device_plugin_tpu.plugin import selftest as jax_selftest
from k8s_device_plugin_tpu.utils import logging as jax_logging
from k8s_device_plugin_tpu.utils import spans as jax_spans
from k8s_device_plugin_tpu.utils import tracing as jax_tracing
from k8s_device_plugin_tpu_torch import workload_entry
from k8s_device_plugin_tpu_torch.kubelet import api as port_api
from k8s_device_plugin_tpu_torch.kubelet import constants as port_constants
from k8s_device_plugin_tpu_torch.kubelet.api import pb
from k8s_device_plugin_tpu_torch.models import engine_watchdog
from k8s_device_plugin_tpu_torch.parallel import distributed as tdist
from k8s_device_plugin_tpu_torch.parallel import mesh as tmesh
from k8s_device_plugin_tpu_torch.plugin import cli as port_cli
from k8s_device_plugin_tpu_torch.plugin import discovery, health, native, selftest, topology
from k8s_device_plugin_tpu_torch.plugin.server import (
    GpuDevicePlugin,
    PluginMetrics,
    container_grant,
)
from k8s_device_plugin_tpu_torch.utils import failpoints
from k8s_device_plugin_tpu_torch.utils import logging as port_logging
from k8s_device_plugin_tpu_torch.utils import spans as port_spans
from k8s_device_plugin_tpu_torch.utils import tracing as port_tracing
from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry
from tests.fakes import make_fake_tpu_host
from tests.torch_gpu_host import card_pci, card_uuid, make_fake_gpu_host

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def prober():
    """The C probe library, built from the checkout's source."""
    return native.load_prober()


def _discover(root, prober="python", **kw):
    return discovery.discover(root=str(root), environ=kw.pop("environ", {}),
                              prober=None if prober == "python" else prober, **kw)


# ------------------------------------------------------- kubelet copies


@pytest.mark.parametrize("name", ["deviceplugin_pb2.py", "podresources_pb2.py"])
def test_generated_messages_are_the_reference_s_bytes(name):
    assert ((ROOT / "k8s_device_plugin_tpu_torch/kubelet" / name).read_bytes()
            == (ROOT / "k8s_device_plugin_tpu/kubelet" / name).read_bytes())


def test_wire_constants_and_method_paths_are_the_reference_s():
    public = [n for n in dir(jax_constants) if n.isupper()]
    assert public and {n: getattr(port_constants, n) for n in public} == {
        n: getattr(jax_constants, n) for n in public}
    assert port_api.pb.DESCRIPTOR.serialized_pb == jax_api.pb.DESCRIPTOR.serialized_pb
    assert port_api.prpb.DESCRIPTOR.serialized_pb == jax_api.prpb.DESCRIPTOR.serialized_pb

    class Channel:
        def __init__(self):
            self.paths = []

        def unary_unary(self, path, **_):
            self.paths.append(path)

        unary_stream = unary_unary

    for stub in ("RegistrationStub", "DevicePluginStub", "PodResourcesListerStub"):
        mine, theirs = Channel(), Channel()
        getattr(port_api, stub)(mine)
        getattr(jax_api, stub)(theirs)
        assert mine.paths == theirs.paths and mine.paths


def test_json_log_lines_are_the_reference_s():
    record = logging.LogRecord("plugin", logging.WARNING, __file__, 1, "x %d", (3,), None)
    record.event = {"span": "rpc.Allocate", "level": "spoofed"}
    lines = [json.loads(m.JsonFormatter().format(record)) for m in (port_logging, jax_logging)]
    for line in lines:
        line.pop("ts")
    assert lines[0] == lines[1] and lines[0]["level"] == "WARNING"


def test_timed_rpc_records_the_reference_s_daemon_span():
    got = {}
    for name, tracing, spans in (("port", port_tracing, port_spans),
                                 ("jax", jax_tracing, jax_spans)):
        recorder = spans.SpanRecorder(capacity=8)
        seen = []

        def Allocate(x):  # noqa: N802 — the servicer's method name
            return x + 1

        wrapped = tracing.timed_rpc(Allocate, spans=lambda r=recorder: r, observe=seen.append)
        assert wrapped(1) == 2 and len(seen) == 1
        [span] = recorder.dump()["spans"]
        got[name] = (span["name"], span["trace_id"], spans.DAEMON_TRACE)
    assert got["port"] == got["jax"] == ("rpc.Allocate", "daemon", "daemon")


# ------------------------------------------------------------ discovery


@pytest.mark.parametrize("text, want", [
    ("00000000:18:00.0", "0000:18:00.0"), ("0000:3B:00.0", "0000:3b:00.0"),
    ("00000001:9a:00.0", "0001:9a:00.0"), ("18:00.0", "0000:18:00.0"),
])
def test_pci_addresses_take_sysfs_s_form(text, want):
    assert discovery.pci_address(text) == want


@pytest.mark.parametrize("with_prober", [False, True], ids=["python", "native"])
def test_discovery_reads_minor_uuid_pci_and_numa(tmp_path, prober, with_prober):
    root = make_fake_gpu_host(tmp_path, n_cards=4, numa_of=lambda i: 1 - i // 2)
    inv = _discover(root, prober if with_prober else "python")
    assert inv.source == "proc" and inv.card_count == 4
    assert [c.k8s_id for c in inv.cards] == ["gpu-0", "gpu-1", "gpu-2", "gpu-3"]
    for i, card in enumerate(inv.cards):
        assert (card.index, card.device_path, card.uuid, card.pci_address, card.numa_node) == (
            i, f"/dev/nvidia{i}", card_uuid(i), card_pci(i, 4), 1 - i // 2)
        assert (card.vendor_id, card.device_id, card.model) == (
            "0x10de", "0x2330", "NVIDIA H100 80GB HBM3")
    assert inv.card_by_k8s_id("gpu-2").uuid == card_uuid(2)
    with pytest.raises(KeyError):
        inv.card_by_k8s_id("gpu-7")


def test_native_and_python_scans_agree(tmp_path, prober):
    root = make_fake_gpu_host(tmp_path, n_cards=3)
    dev = tmp_path / "dev"
    for extra in ("nvidia-modeset", "nvidia0x", "nvidia-caps", "nvidia12"):
        (dev / extra).write_text("")
    want = {0, 1, 2, 12}
    assert discovery.device_minors(root) == want
    assert discovery.device_minors(root, prober) == want
    assert prober.scan_nvidia_minors(str(tmp_path / "absent")) is None


def test_cards_need_a_node_and_the_driver_s_entry(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=4, skip_dev_for=(2,))
    (tmp_path / "dev" / "nvidia7").write_text("")  # a node the driver does not list
    inv = _discover(root)
    assert [c.index for c in inv.cards] == [0, 1, 3]


def test_foreign_vendor_and_missing_uuid_are_skipped(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=3)
    (tmp_path / "sys/bus/pci/devices" / card_pci(0, 3) / "vendor").write_text("0x1002\n")
    info = tmp_path / "proc/driver/nvidia/gpus" / card_pci(1, 3) / "information"
    info.write_text(info.read_text().replace("GPU UUID", "GPU IDENT"))
    assert [c.index for c in _discover(root).cards] == [2]


def test_no_driver_list_advertises_nothing(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=2)
    os.rename(tmp_path / "proc", tmp_path / "proc.gone")
    inv = _discover(root)
    assert inv.cards == () and inv.source == "none"


def test_a_driver_without_proc_entries_lists_cards_through_nvml(tmp_path):
    """A sandboxed runtime shows every card's node but the driver publishes
    no proc entries: the list is NVML's (here a stand-in prober)."""
    root = make_fake_gpu_host(tmp_path, n_cards=2)
    for p in (tmp_path / "proc/driver/nvidia/gpus").iterdir():
        for f in p.iterdir():
            f.unlink()
        p.rmdir()
    (tmp_path / "proc/driver/nvidia/gpus").rmdir()

    class Nvml:
        def scan_nvidia_minors(self, dev_dir):
            return None

        def nvml_devices(self):
            return [{"index": 0, "minor": 1, "uuid": card_uuid(1),
                     "bus_id": "0000" + card_pci(1, 2), "vendor_id": "0x10de",
                     "device_id": "0x2330"}]

    inv = discovery.discover(root=root, environ={}, prober=Nvml())
    assert inv.source == "nvml"
    [card] = inv.cards
    assert (card.index, card.uuid, card.pci_address, card.numa_node) == (
        1, card_uuid(1), card_pci(1, 2), 0)


def test_nvml_reads_nothing_without_the_driver_library(prober):
    if ctypes.util.find_library("nvidia-ml"):
        pytest.skip("this host has the NVIDIA driver library")
    assert prober.nvml_devices() is None


# A stand-in libnvidia-ml.so.1: two cards (minors 4 and 5, no PCI
# information), each nvmlInit_v2 and nvmlShutdown logged as I and S to
# $FAKE_NVML_LOG, and the count query failing on its $FAKE_NVML_FAIL_AT-th
# call.
FAKE_NVML = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

static void note(const char *what) {
  FILE *f = fopen(getenv("FAKE_NVML_LOG"), "a");
  fputs(what, f);
  fclose(f);
}
int nvmlInit_v2(void) { note("I"); return 0; }
int nvmlShutdown(void) { note("S"); return 0; }
int nvmlDeviceGetCount_v2(unsigned int *n) {
  static int calls = 0;
  if (++calls == atoi(getenv("FAKE_NVML_FAIL_AT"))) return 999;
  *n = 2;
  return 0;
}
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void **dev) {
  *dev = (void *)(uintptr_t)(i + 1);
  return 0;
}
int nvmlDeviceGetMinorNumber(void *dev, unsigned int *minor) {
  *minor = 3 + (unsigned int)(uintptr_t)dev;
  return 0;
}
int nvmlDeviceGetUUID(void *dev, char *uuid, unsigned int len) {
  snprintf(uuid, len, "GPU-fake-%u", (unsigned int)(uintptr_t)dev);
  return 0;
}
int nvmlDeviceGetPciInfo_v3(void *dev, void *pci) { (void)dev; (void)pci; return 3; }
"""

NVML_CALLS = """
import json
from k8s_device_plugin_tpu_torch.plugin import native
prober = native.load_prober()
print(json.dumps([prober.nvml_devices() for _ in range(5)]))
"""


def test_nvml_stays_initialised_across_discoveries(tmp_path):
    """Discovery lists the cards through NVML on every health pulse, so the
    probe library opens one NVML session and keeps it: nvmlInit_v2 once
    over many listings, never nvmlShutdown, until a query fails, which
    closes the session for the next listing to open again."""
    import shutil
    import subprocess
    import sys

    if shutil.which("cc") is None:
        pytest.skip("no C compiler on this host: nothing builds the libraries")
    native.build_probe_library()
    src = tmp_path / "fake_nvml.c"
    src.write_text(FAKE_NVML)
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(tmp_path / "libnvidia-ml.so.1"),
                    str(src)], check=True, capture_output=True)
    log = tmp_path / "nvml.log"
    log.write_text("")
    env = dict(os.environ, LD_LIBRARY_PATH=str(tmp_path), FAKE_NVML_LOG=str(log),
               FAKE_NVML_FAIL_AT="3", PYTHONPATH=str(ROOT))
    env.pop("GPU_PROBE_LIB", None)
    proc = subprocess.run([sys.executable, "-c", NVML_CALLS], env=env, capture_output=True,
                          text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    listings = json.loads(proc.stdout)
    cards = [{"index": i, "minor": 4 + i, "uuid": f"GPU-fake-{i + 1}", "bus_id": None,
              "vendor_id": None, "device_id": None} for i in range(2)]
    assert listings == [cards, cards, None, cards, cards]
    assert "NVML device list unavailable: an NVML query failed (NVML status 999)" in proc.stderr
    assert log.read_text() == "ISI"


def test_worker_metadata_files_win_over_env(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=2, worker_id=1, worker_hostnames="h0,h1")
    env = {"GPU_WORKER_ID": "5", "GPU_WORKER_HOSTNAMES": "x,y,z"}
    inv = _discover(root, environ=env)
    assert (inv.worker_id, inv.worker_hostnames) == (1, ("h0", "h1"))
    bare = make_fake_gpu_host(tmp_path / "bare", n_cards=2)
    inv = _discover(bare, environ=env)
    assert (inv.worker_id, inv.worker_hostnames) == (5, ("x", "y", "z"))


# --------------------------------------------------------------- native


@pytest.mark.parametrize("kind, want", [
    ("file", native.PROBE_OK), ("missing", native.PROBE_MISSING),
    ("dir", native.PROBE_WRONGTYPE),
])
def test_probe_codes(tmp_path, prober, kind, want):
    path = tmp_path / "nvidia0"
    if kind == "file":
        path.write_text("")
    elif kind == "dir":
        path.mkdir()
    assert prober.probe(str(path))[0] == want
    assert prober.probe_many([str(path), str(path)]) == [prober.probe(str(path))] * 2
    assert native.is_healthy_code(want) == (want == native.PROBE_OK)


def test_probe_library_builds_once_under_build(prober):
    path = pathlib.Path(native.build_probe_library())
    assert path == native.library_path() and path.exists()
    assert path.is_relative_to(ROOT / "build" / "gpu_probe")


# --------------------------------------------------------------- health


def _jax_chip(i):
    return jax_discovery.TpuChip(index=i, device_path=f"/dev/accel{i}")


def _gpu_card(i):
    return discovery.GpuCard(index=i, device_path=f"/dev/nvidia{i}", uuid=card_uuid(i))


@pytest.mark.parametrize("use_prober", [False, True], ids=["python", "native"])
def test_health_rules_are_the_reference_s(tmp_path, prober, use_prober):
    """One sequence of host events on a TPU tree and a GPU tree: the two
    checkers give the same verdicts (override first, a vanished node,
    the flap debounce at threshold 2, recovery at once)."""
    tpu = make_fake_tpu_host(tmp_path / "tpu", n_chips=3)
    gpu = make_fake_gpu_host(tmp_path / "gpu", n_cards=3)
    checkers = {
        "jax": (jax_health.ChipHealthChecker(tpu, prober=None, flap_threshold=2),
                [_jax_chip(i) for i in range(3)], tpu, "run/tpu/health", "accel"),
        "port": (health.CardHealthChecker(gpu, prober=prober if use_prober else None,
                                          flap_threshold=2),
                 [_gpu_card(i) for i in range(3)], gpu, "run/gpu/health", "nvidia"),
    }

    def sweep():
        out = {}
        for name, (checker, chips, *_rest) in checkers.items():
            verdicts = checker.check_many(chips)
            out[name] = [verdicts[c.k8s_id] for c in chips]
        assert out["jax"] == out["port"], out
        return out["port"]

    def each(fn):
        for _checker, _chips, root, override_dir, node in checkers.values():
            fn(root, override_dir, node)

    def override(i, text):
        def write(root, override_dir, node):
            os.makedirs(os.path.join(root, override_dir), exist_ok=True)
            with open(os.path.join(root, override_dir, f"{node}{i}"), "w") as f:
                f.write(text)
        return write

    assert sweep() == [True, True, True]
    each(override(0, "Unhealthy"))
    each(lambda root, _o, node: os.unlink(os.path.join(root, "dev", f"{node}1")))
    each(override(2, "healthy"))
    assert sweep() == [True, True, True]    # one failed sweep is a flap
    assert sweep() == [False, False, True]  # the second one is not
    each(lambda root, _o, node: os.unlink(os.path.join(root, "dev", f"{node}2")))
    assert sweep() == [False, False, True]  # the override wins over the node
    each(lambda root, _o, node: open(os.path.join(root, "dev", f"{node}1"), "w").close())
    each(lambda root, o, node: os.unlink(os.path.join(root, o, f"{node}0")))
    assert sweep() == [True, True, True]    # recovery is never debounced


@pytest.mark.parametrize("use_prober", [False, True], ids=["python", "native"])
def test_every_card_is_unhealthy_without_the_control_node(tmp_path, prober, use_prober):
    root = make_fake_gpu_host(tmp_path, n_cards=2)
    checker = health.CardHealthChecker(root, prober=prober if use_prober else None)
    cards = [_gpu_card(0), _gpu_card(1)]
    assert checker.check_many(cards) == {"gpu-0": True, "gpu-1": True}
    os.unlink(tmp_path / "dev" / "nvidiactl")
    assert checker.check_many(cards) == {"gpu-0": False, "gpu-1": False}
    assert not checker.check(cards[0])
    os.makedirs(tmp_path / "run/gpu/health")
    (tmp_path / "run/gpu/health/nvidia1").write_text("Healthy")
    assert checker.check_many(cards) == {"gpu-0": False, "gpu-1": True}


# ------------------------------------------------------------- topology


@pytest.mark.parametrize("count, available, must, want, nodes", [
    (2, range(8), (), [0, 1], 1),
    (3, range(8), (), [0, 1, 2], 1),
    (3, [1, 2, 4, 5, 6], (), [4, 5, 6], 1),
    (4, [1, 2, 3, 4, 5, 6], (), [1, 2, 3, 4], 2),
    (2, [1, 2, 3, 4], (3,), [1, 3], 1),
    (2, [1, 2, 5, 6], (5,), [5, 6], 1),
    (3, [0, 4, 5, 6], (0,), [0, 4, 5], 2),
    (6, range(8), (7,), [0, 1, 2, 3, 4, 7], 2),
    (5, [0, 4, 5, 6], (0,), None, 0),
    (2, [0, 1], (0, 1, 4), None, 0),
    (0, range(8), (), None, 0),
], ids=["pair", "three", "largest-node", "two-needed", "must", "must-node", "must-first",
        "must-and-lowest", "too-few", "too-many-musts", "zero"])
def test_preference_spans_the_fewest_numa_nodes(count, available, must, want, nodes):
    numa_of = {i: i // 4 for i in range(8)}  # two nodes of four cards
    got = topology.select_numa_local(count, available, numa_of, must_include=must)
    assert got == want
    if got is not None:
        assert len(topology.numa_nodes_of(got, numa_of)) == nodes


def test_cards_of_no_known_node_group_together():
    numa_of = {0: None, 1: None, 2: 0, 3: 0}
    assert topology.select_numa_local(2, range(4), numa_of) == [0, 1]
    assert topology.numa_groups(range(4), numa_of) == {None: [0, 1], 0: [2, 3]}


# ----------------------------------------------------- server and grant


class Abort(Exception):
    def __init__(self, code, details):
        super().__init__(details)
        self.code = code


class Context:
    def abort(self, code, details):
        raise Abort(code, details)

    def is_active(self):
        return True


@pytest.fixture
def plugin(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=4, worker_id=1, worker_hostnames="h0,h1")
    metrics = PluginMetrics(MetricsRegistry())
    return GpuDevicePlugin(
        discover=lambda: discovery.discover(root=root, environ={}, prober=None),
        health_checker=health.CardHealthChecker(root, prober=None),
        metrics=metrics, root=root), root


def _allocate(p, *ids):
    return p.Allocate(pb.AllocateRequest(
        container_requests=[pb.ContainerAllocateRequest(devicesIDs=list(ids))]), Context())


def test_allocate_grants_the_cards_the_shared_nodes_and_the_envs(plugin, tmp_path):
    p, root = plugin
    [car] = _allocate(p, "gpu-3", "gpu-1").container_responses
    assert [(d.container_path, d.host_path, d.permissions) for d in car.devices] == [
        ("/dev/nvidia1", "/dev/nvidia1", "rw"), ("/dev/nvidia3", "/dev/nvidia3", "rw"),
        ("/dev/nvidiactl", "/dev/nvidiactl", "rw"), ("/dev/nvidia-uvm", "/dev/nvidia-uvm", "rw"),
        ("/dev/nvidia-uvm-tools", "/dev/nvidia-uvm-tools", "rw")]
    assert dict(car.envs) == {"NVIDIA_VISIBLE_DEVICES": f"{card_uuid(1)},{card_uuid(3)}",
                              "GPU_DEVICE_MINORS": "1,3", "GPU_WORKER_ID": "0"}
    assert dict(car.annotations) == {
        "gpu.nvidia.com/devices": "gpu-1,gpu-3",
        "gpu.nvidia.com/pci-addresses": f"{card_pci(1, 4)},{card_pci(3, 4)}"}
    # The grant as plain data, without gRPC; a host without uvm nodes.
    os.unlink(tmp_path / "dev" / "nvidia-uvm")
    os.unlink(tmp_path / "dev" / "nvidia-uvm-tools")
    grant = container_grant(p.inventory, [p.inventory.card_by_k8s_id("gpu-0")], root=root)
    assert grant["devices"] == [("/dev/nvidia0", "/dev/nvidia0", "rw"),
                                ("/dev/nvidiactl", "/dev/nvidiactl", "rw")]
    assert grant["envs"]["GPU_DEVICE_MINORS"] == "0"


def test_allocate_aborts_and_counts_as_the_reference(plugin, tmp_path):
    p, _ = plugin
    with pytest.raises(Abort) as e:
        _allocate(p, "gpu-0", "gpu-8")
    assert e.value.code == grpc.StatusCode.NOT_FOUND
    os.makedirs(tmp_path / "run/gpu/health")
    (tmp_path / "run/gpu/health/nvidia2").write_text("Unhealthy")
    p.poll_once()
    with pytest.raises(Abort) as e:
        _allocate(p, "gpu-2")
    assert e.value.code == grpc.StatusCode.FAILED_PRECONDITION
    _allocate(p, "gpu-0")
    text = p.metrics.registry.render()
    for outcome, n in (("ok", 1), ("unknown_device", 1), ("unhealthy_device", 1)):
        assert f'gpu_plugin_allocations_total{{outcome="{outcome}"}} {n}' in text
    assert "gpu_plugin_allocated_chips_total 1" in text


def test_preferred_allocation_counts_its_result(plugin):
    p, _ = plugin

    def prefer(available, must, size):
        resp = p.GetPreferredAllocation(pb.PreferredAllocationRequest(container_requests=[
            pb.ContainerPreferredAllocationRequest(available_deviceIDs=available,
                                                   must_include_deviceIDs=must,
                                                   allocation_size=size)]), Context())
        return list(resp.container_responses[0].deviceIDs)

    assert prefer(["gpu-0", "gpu-1", "gpu-2", "gpu-3"], ["gpu-3"], 2) == ["gpu-2", "gpu-3"]
    assert prefer(["gpu-1", "gpu-2", "gpu-3"], [], 2) == ["gpu-2", "gpu-3"]
    assert prefer(["gpu-1", "gpu-2"], [], 2) == ["gpu-1", "gpu-2"]
    assert prefer(["gpu-1", "gpu-10"], [], 1) == ["gpu-1"]
    text = p.metrics.registry.render()
    for result, n in (("contiguous", 2), ("fragmented", 1), ("unknown_device", 1)):
        assert f'gpu_plugin_preferred_allocations_total{{result="{result}"}} {n}' in text


def test_the_whole_host_carries_the_job_s_worker_envs(plugin):
    p, _ = plugin
    [car] = _allocate(p, "gpu-0", "gpu-1", "gpu-2", "gpu-3").container_responses
    assert dict(car.envs)["GPU_WORKER_ID"] == "1"
    assert dict(car.envs)["GPU_WORKER_HOSTNAMES"] == "h0,h1"


# ----------------------------------------------------- envs round trip


def test_allocate_envs_feed_the_port_s_readers(plugin):
    """The env of an Allocate response, as the container would get it,
    straight into the port's readers: the mesh's allocation, the chip
    health feed's device nodes and the multi-host process group."""
    p, _ = plugin
    [car] = _allocate(p, "gpu-1", "gpu-3").container_responses
    env = dict(car.envs)
    assert tmesh.allocated_chip_indices(env) == [1, 3]
    assert tmesh.allocation_ranks(2, environ=env, devices=[0, 1]) == [0, 1]
    with pytest.raises(ValueError, match=r"injected 2 chip\(s\) \(GPU_DEVICE_MINORS='1,3'\)"):
        tmesh.allocation_ranks(4, environ=env, devices=[0, 1, 2, 3])
    assert engine_watchdog.visible_chip_paths(env, root="/host") == [
        "/host/dev/nvidia1", "/host/dev/nvidia3"]
    assert tdist.process_group_from_env(env) is None  # part of one host

    [whole] = _allocate(p, "gpu-0", "gpu-1", "gpu-2", "gpu-3").container_responses
    env = dict(whole.envs)
    assert tmesh.allocation_ranks(4, environ=env, devices=[0, 1, 2, 3]) == [0, 1, 2, 3]
    group = tdist.process_group_from_env(env)
    assert (group.coordinator_address, group.num_processes, group.process_id) == (
        f"h0:{tdist.DEFAULT_COORDINATOR_PORT}", 2, 1)
    # The GPU plugin's names win over a TPU node's leftovers.
    mixed = dict(env, TPU_WORKER_HOSTNAMES="a,b,c", TPU_WORKER_ID="2", TPU_VISIBLE_CHIPS="5",
                 TPU_CHIPS_PER_HOST_BOUNDS="2,2,1")
    assert tdist.process_group_from_env(mixed) == group
    assert tmesh.allocated_chip_indices(mixed) == [0, 1, 2, 3]
    assert tmesh.allocation_ranks(4, environ=mixed, devices=[0, 1, 2, 3]) == [0, 1, 2, 3]
    assert engine_watchdog.visible_chip_paths(mixed, root="/")[0] == "/dev/nvidia0"
    with pytest.raises(ValueError, match="malformed GPU_WORKER_ID"):
        tdist.process_group_from_env(dict(env, GPU_WORKER_ID="x"))


# ------------------------------------------------------------- selftest


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17])
def test_checksum_is_the_reference_s(seed):
    want = jax_selftest.matmul_checksum(seed)
    assert selftest.matmul_checksum(seed) == want
    assert selftest.torch_checksum(seed, "cpu") == want


def _sweeper(root, cards, busy=(), probe_fn=None, **cfg):
    cfg.setdefault("fail_threshold", 2)
    return selftest.SelftestSweeper(lambda: cards, lambda: set(busy),
                                    config=selftest.SelftestConfig(**cfg), root=str(root),
                                    probe_fn=probe_fn)


def test_a_diverging_card_is_quarantined_and_reads_unhealthy(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=3)
    cards = [_gpu_card(i) for i in range(3)]
    checker = health.CardHealthChecker(root, prober=None)

    def probe(card, seed):
        want = selftest.matmul_checksum(seed)
        return want ^ 1 if card.index == 1 else want

    sweeper = _sweeper(root, cards, busy=("gpu-2",), probe_fn=probe)
    assert sweeper.poll_once() == {"gpu-0": "pass", "gpu-1": "fail", "gpu-2": "skip_busy"}
    assert checker.check_many(cards)["gpu-1"]  # one failure never quarantines
    assert sweeper.poll_once() == {"gpu-0": "pass", "gpu-1": "fail", "gpu-2": "skip_busy"}
    assert (tmp_path / "run/gpu/health/nvidia1").read_text() == "Unhealthy"
    assert checker.check_many(cards) == {"gpu-0": True, "gpu-1": False, "gpu-2": True}
    assert sweeper.snapshot()["chips"]["gpu-1"]["quarantined"]


def test_the_corrupt_failpoint_quarantines_one_card(tmp_path):
    root = make_fake_gpu_host(tmp_path, n_cards=2)
    cards = [_gpu_card(0), _gpu_card(1)]
    sweeper = _sweeper(root, cards, probe_fn=lambda c, s: selftest.matmul_checksum(s))
    try:
        failpoints.arm_spec(f"{selftest.FAILPOINT_PROBE}.gpu-0=corrupt")
        assert sweeper.poll_once() == {"gpu-0": "fail", "gpu-1": "pass"}
        assert sweeper.poll_once() == {"gpu-0": "fail", "gpu-1": "pass"}
    finally:
        failpoints.disarm_all()
    assert (tmp_path / "run/gpu/health/nvidia0").exists()
    assert not health.CardHealthChecker(root, prober=None).check(cards[0])


def test_the_default_probe_needs_the_card(tmp_path):
    """Without ``probe_fn`` the probe runs on the card; with no CUDA card
    it raises, which the sweep counts as an error, never a sick card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would run")
    root = make_fake_gpu_host(tmp_path, n_cards=1)
    sweeper = _sweeper(root, [_gpu_card(0)], fail_threshold=1)
    assert sweeper.poll_once() == {"gpu-0": "error"}
    assert not (tmp_path / "run/gpu/health").exists()


# ------------------------------------------------------ CLI, packaging


def test_cli_takes_the_reference_s_flags():
    dests = {a.dest: a.default for a in port_cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_cli.build_parser()._actions}
    assert dests.keys() == theirs.keys()
    differ = {k for k in dests if dests[k] != theirs[k]}
    assert differ == {"resource", "endpoint"}
    assert (dests["resource"], dests["endpoint"]) == ("nvidia.com/gpu", "nvidia.com_gpu.sock")


def test_console_scripts_name_the_port_s_entry_points():
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = project["project"]["scripts"]
    ours = {k: v for k, v in scripts.items() if v.startswith("k8s_device_plugin_tpu_torch.")}
    assert ours == {
        "gpu-device-plugin": "k8s_device_plugin_tpu_torch.plugin.cli:main",
        "gpu-benchmark": "k8s_device_plugin_tpu_torch.workload_entry:benchmark",
        "gpu-serving-engine": "k8s_device_plugin_tpu_torch.workload_entry:serving_engine",
        "gpu-serving-http": "k8s_device_plugin_tpu_torch.workload_entry:serving_http",
    }
    assert all(callable(getattr(workload_entry, v.rsplit(":", 1)[1], None))
               for v in ours.values() if "workload_entry" in v)
    data = project["tool"]["setuptools"]["package-data"]["k8s_device_plugin_tpu_torch"]
    assert "csrc/*.c" in data


def test_manifests_parse_with_the_port_s_parsers():
    """deploy/k8s-ds-gpu-dp.yaml runs the port's daemon with flags its CLI
    takes; deploy/k8s-pod-serve-gpu.yaml asks for one nvidia.com/gpu and
    runs the port's server with flags its CLI takes."""
    import yaml

    from k8s_device_plugin_tpu_torch.models import http_server

    [ds] = yaml.safe_load_all((ROOT / "deploy/k8s-ds-gpu-dp.yaml").read_text())
    [daemon] = ds["spec"]["template"]["spec"]["containers"]
    assert daemon["command"][-1] == "k8s_device_plugin_tpu_torch.plugin.cli"
    args = port_cli.build_parser().parse_args(daemon["args"])
    assert args.resource == "nvidia.com/gpu" and args.selftest_interval > 0
    mounts = {m["mountPath"] for m in daemon["volumeMounts"]}
    assert {"/var/lib/kubelet/device-plugins", "/dev", "/proc/driver/nvidia", "/sys",
            "/run/gpu"} <= mounts
    [pod] = yaml.safe_load_all((ROOT / "deploy/k8s-pod-serve-gpu.yaml").read_text())
    [server] = pod["spec"]["containers"]
    assert server["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert server["command"][-1] == "k8s_device_plugin_tpu_torch.models.http_server"
    served = http_server.parse_args(server["args"])
    assert (served.hidden, served.layers, served.heads, served.kv_heads) == (1024, 8, 16, 4)
