"""Time a health override's way from its file to the kubelet's stream.

Runs the GPU device plugin of ``k8s_device_plugin_tpu_torch`` in this
process (the heartbeat, the health sweep and the ListAndWatch stream of
the real classes, served over gRPC on a unix socket to a minimal kubelet),
flips one card's override file to ``Unhealthy`` and back ``--flips`` times,
and splits each flip's latency into its steps:

- ``wait``: the write until the heartbeat's next poll starts (the pulse
  loop's sleep; negative when a poll was already running);
- ``discover``: the poll's discovery (``poll_once`` until ``check_many``);
- ``sweep``: ``check_many`` (the override read, ``health.py`` ``_override``
  and ``_check_many``);
- ``publish``: the rest of ``poll_once`` (the state swap and the notify);
- ``send``: the stream thread's wake until it builds the list it yields;
- ``deliver``: that yield until the kubelet's reader holds the update.

``--burners N`` runs N processes that spin on a core each meanwhile (0 by
default).  ``--reference`` also times the JAX package's TPU daemon on a TPU
fixture tree, alternating with the port (CPU only; the card's machine runs
the port alone).  ``--root /`` takes the host's real cards (a tree under
/tmp linking the real dev, proc and sys, with its own run/gpu); by default
both daemons read fixture trees from ``tests/``.

    python tools/plugin_flip_timing.py --pulse 0.25 --flips 20 --burners 8 --reference

Prints one JSON object: per daemon, every flip's steps in seconds and each
step's median and maximum.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent import futures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STEPS = ("wait", "discover", "sweep", "publish", "send", "deliver", "total")


class Stamps:
    """Wraps one plugin's poll, sweep, override read and list build on the
    instance, stamping each with ``time.perf_counter``."""

    def __init__(self, plugin, checker, target_id: str):
        self.polls, self.sweeps, self.lists, self.reads = [], [], [], []
        self._wrap(plugin, "poll_once", self.polls)
        self._wrap(checker, "check_many", self.sweeps)
        self._wrap(plugin, "_device_list", self.lists, span=False)
        orig = checker._override

        def override(chip):
            verdict = orig(chip)
            if chip.k8s_id == target_id and verdict is False:
                self.reads.append(time.perf_counter())
            return verdict

        checker._override = override

    @staticmethod
    def _wrap(obj, name: str, into: list, span: bool = True) -> None:
        orig = getattr(obj, name)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                into.append((t0, time.perf_counter()) if span else t0)

        setattr(obj, name, wrapped)

    def split(self, t_write: float, t_recv: float) -> dict:
        """The steps of the flip written at ``t_write`` and received at
        ``t_recv``."""
        t_read = next(t for t in self.reads if t >= t_write)
        poll = next(p for p in self.polls if p[0] <= t_read <= p[1])
        sweep = next(s for s in self.sweeps if s[0] <= t_read <= s[1])
        sent = next(t for t in self.lists if t >= poll[1])
        return {"wait": poll[0] - t_write, "discover": sweep[0] - poll[0],
                "sweep": sweep[1] - sweep[0], "publish": poll[1] - sweep[1],
                "send": sent - poll[1], "deliver": t_recv - sent, "total": t_recv - t_write}


class Kubelet:
    """The kubelet's Registration service; records registrations."""

    def __init__(self, plugin_dir: str):
        self.plugin_dir, self.requests = plugin_dir, []
        self.registered = threading.Event()
        self._server = None

    def Register(self, request, context):  # noqa: N802 — the gRPC method name
        from k8s_device_plugin_tpu_torch.kubelet.api import pb

        self.requests.append(request)
        self.registered.set()
        return pb.Empty()

    def start(self) -> None:
        import grpc

        from k8s_device_plugin_tpu_torch.kubelet.api import add_registration_servicer

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        add_registration_servicer(self, self._server)
        self._server.add_insecure_port(f"unix://{self.plugin_dir}/kubelet.sock")
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=None).wait()


def _port_side(root: str):
    from k8s_device_plugin_tpu_torch.plugin import discovery, health, manager, server

    checker = health.CardHealthChecker(root=root)
    plugin = server.GpuDevicePlugin(
        discover=lambda: discovery.discover(root=root, environ={}), health_checker=checker,
        root=root)
    card = plugin.inventory.cards[0]
    return plugin, checker, card.k8s_id, health.override_path(root, card), manager


def _reference_side(root: str):
    from k8s_device_plugin_tpu.plugin import discovery, health, manager, server

    checker = health.ChipHealthChecker(root=root)
    plugin = server.TpuDevicePlugin(
        discover=lambda: discovery.discover(root=root, environ={}), health_checker=checker)
    chip = plugin.inventory.chips[0]
    return (plugin, checker, chip.k8s_id,
            os.path.join(root, health.HEALTH_OVERRIDE_DIR, f"accel{chip.index}"), manager)


def run_daemon(side, root: str, pulse: float, flips: int, seed: int) -> dict:
    """``flips`` override flips through one daemon of ``side``; returns
    each flip's steps and their median and maximum."""
    import grpc

    from k8s_device_plugin_tpu_torch.kubelet.api import DevicePluginStub, pb

    plugin, checker, target, override, manager = side(root)
    os.makedirs(os.path.dirname(override), exist_ok=True)
    stamps = Stamps(plugin, checker, target)
    plugin_dir = tempfile.mkdtemp(dir="/tmp", prefix="flip-")
    kubelet = Kubelet(plugin_dir)
    kubelet.start()
    mgr = manager.PluginManager(plugin, plugin_dir=plugin_dir, pulse=pulse,
                                watch_kubelet=False)
    updates = queue.Queue()
    rng = random.Random(seed)
    rows = []
    try:
        mgr.start()
        if not kubelet.registered.wait(30):
            raise RuntimeError("the daemon never registered")
        sock = os.path.join(plugin_dir, kubelet.requests[-1].endpoint)
        call = DevicePluginStub(grpc.insecure_channel(f"unix://{sock}")).ListAndWatch(pb.Empty())

        def pump():
            try:
                for resp in call:
                    updates.put((time.perf_counter(),
                                 {d.ID: d.health for d in resp.devices}))
            except grpc.RpcError:
                pass

        threading.Thread(target=pump, daemon=True).start()

        def until(health: str) -> float:
            while True:
                t, devs = updates.get(timeout=30)
                if devs.get(target) == health:
                    return t

        until("Healthy")
        for _ in range(flips):
            time.sleep(pulse * (1 + rng.random()))  # a write at any phase of the pulse
            with open(override, "w") as f:
                f.write("Unhealthy")
            t_write = time.perf_counter()
            rows.append(stamps.split(t_write, until("Unhealthy")))
            os.unlink(override)
            until("Healthy")
        call.cancel()
    finally:
        mgr.stop_all()
        kubelet.stop()
        shutil.rmtree(plugin_dir, ignore_errors=True)
    return {"flips": rows,
            "median": {k: statistics.median(r[k] for r in rows) for k in STEPS},
            "max": {k: max(r[k] for r in rows) for k in STEPS}}


def host_tree() -> str:
    """A tree under /tmp: the real dev, proc and sys through symlinks, and
    its own run/gpu for the override files."""
    root = tempfile.mkdtemp(dir="/tmp", prefix="flip-root-")
    for name in ("dev", "proc", "sys"):
        os.symlink(f"/{name}", os.path.join(root, name))
    os.makedirs(os.path.join(root, "run/gpu/health"))
    return root


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="plugin_flip_timing")
    p.add_argument("--pulse", type=float, default=0.25, help="heartbeat seconds")
    p.add_argument("--flips", type=int, default=20, help="override flips per daemon run")
    p.add_argument("--rounds", type=int, default=1,
                   help="runs of each daemon (alternating with --reference)")
    p.add_argument("--burners", type=int, default=0,
                   help="processes that spin on a core each during the runs")
    p.add_argument("--reference", action="store_true",
                   help="also time the JAX package's TPU daemon on a fixture tree")
    p.add_argument("--root", default="",
                   help="'/' takes the host's real cards; empty uses fixture trees")
    args = p.parse_args(argv)
    burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range(args.burners)]
    trees = []
    try:
        if args.root == "/":
            port_root = host_tree()
        else:
            from tests.torch_gpu_host import make_fake_gpu_host

            port_root = make_fake_gpu_host(tempfile.mkdtemp(prefix="flip-gpu-"), n_cards=4)
        trees.append(port_root)
        sides = [("port", _port_side, port_root)]
        if args.reference:
            from tests.fakes import make_fake_tpu_host

            ref_root = make_fake_tpu_host(tempfile.mkdtemp(prefix="flip-tpu-"), n_chips=4)
            trees.append(ref_root)
            sides.append(("reference", _reference_side, ref_root))
        out = {"pulse_s": args.pulse, "burners": args.burners, "cpus": os.cpu_count(),
               "runs": []}
        for r in range(args.rounds):
            for name, side, root in (sides if r % 2 == 0 else sides[::-1]):
                run = run_daemon(side, root, args.pulse, args.flips, seed=r)
                out["runs"].append({"daemon": name, "round": r, **run})
                print(f"{name} round {r}: median {run['median']}, max {run['max']}",
                      file=sys.stderr, flush=True)
        out["loadavg"] = os.getloadavg()
    finally:
        for b in burners:
            b.kill()
            b.wait()
        for tree in trees:
            shutil.rmtree(tree, ignore_errors=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
