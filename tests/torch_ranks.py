"""Gloo ranks on the CPU for the port's multi-rank tests.

:class:`Ranks` starts one process per rank (``python
tests/torch_ranks.py <spec> <rank>``) on a free localhost port, and its
``wait`` waits for all of them under one time limit, killing every one on
a timeout or a failure, so no group outlives its test.  A rank joins the group through
``parallel/distributed.initialize`` (from the spec's ``env`` when it has
one: the multi-host derivation, one rank per "host"), and runs each case
of ``spec["cases"]`` through ``parallel/sharding.shard_train_step`` over
``make_slice_mesh`` of its mesh; rank 0 saves the results
to ``spec["out"]``.  This file imports no JAX: the test modules hold the
results against the JAX package.

A case: ``kind`` ("gpt", "resnet", "alexnet") and ``kwargs`` of the port's
model (built on the CPU), its starting ``state_dict``, the global
``batch``, ``input_key``, ``steps`` and ``grad_accum``; optionally
``mesh`` (a layout of the same ranks in place of the spec's), ``restore``
(a checkpoint directory restored after sharding), ``save_dir`` and
``save_at`` (a step after which the sharded state is saved).  Each result
holds, among the rest, the names of what every rank sent rank 0 when it
gathered the final state (``received``).

A spec with ``tp_serving`` runs tensor-parallel serving instead
(:func:`_tp_main`): the sharded forward and ``greedy_generate`` on every
rank, then each scenario through a ``ServingEngine`` over the ``tp`` mesh,
rank 0 leading and the others following, and each rank's pools gathered
to rank 0 after it.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` rank processes on ``spec`` (``init_method`` and ``out``
    filled in here), started at once; :meth:`wait` returns rank 0's
    results."""

    def __init__(self, spec: dict, world: int, tmp_dir, timeout: float = 170.0):
        self.spec = dict(spec, world=world, init_method=f"tcp://127.0.0.1:{free_port()}",
                         out=os.path.join(tmp_dir, "results.pt"))
        spec_path = os.path.join(tmp_dir, "spec.pt")
        torch.save(self.spec, spec_path)
        env = dict(os.environ, PYTHONPATH=REPO)
        self.deadline = time.monotonic() + timeout
        self.procs, self.logs = [], []
        try:
            for rank in range(world):
                log = open(os.path.join(tmp_dir, f"rank{rank}.log"), "w+")
                self.logs.append(log)
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, spec_path, str(rank)], cwd=REPO, env=env,
                    stdout=log, stderr=subprocess.STDOUT, start_new_session=True))
        except BaseException:
            self._kill()
            raise

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def wait(self):
        try:
            while any(p.poll() is None for p in self.procs):
                if time.monotonic() > self.deadline or any(
                        p.poll() not in (None, 0) for p in self.procs):
                    break
                time.sleep(0.1)
        finally:
            self._kill()
        failed = []
        for rank, (p, log) in enumerate(zip(self.procs, self.logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0:
                failed.append(f"rank {rank} exit {p.returncode}:\n{text[-3000:]}")
        assert not failed, "\n".join(failed)
        return torch.load(self.spec["out"], weights_only=False)


def _model(kind: str, kwargs: dict):
    if kind == "gpt":
        from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig, TransformerLM

        return TransformerLM(GPTConfig(**kwargs), device="cpu", train=True)
    if kind == "resnet":
        from k8s_device_plugin_tpu_torch.models.resnet import ResNet18Thin

        return ResNet18Thin(device="cpu", **kwargs)
    from k8s_device_plugin_tpu_torch.models.alexnet import AlexNet

    return AlexNet(device="cpu", **kwargs)


def _gather_recorded(model):
    """``sharding.gather_full_state(model)`` and, on rank 0, the names each
    rank's ``gather_object`` payload held (None elsewhere)."""
    from k8s_device_plugin_tpu_torch.parallel import sharding

    dist = torch.distributed
    gather, received = dist.gather_object, []

    def recording(obj, object_gather_list=None, **kwargs):
        gather(obj, object_gather_list, **kwargs)
        if object_gather_list is not None:
            received.append([sorted(payload) for payload in object_gather_list])

    dist.gather_object = recording
    try:
        full = sharding.gather_full_state(model)
    finally:
        dist.gather_object = gather
    return full, (received[0] if received else None)


def _run_case(case: dict, mesh, rank: int, world: int) -> dict:
    from k8s_device_plugin_tpu_torch.models import checkpoint, train
    from k8s_device_plugin_tpu_torch.parallel import sharding

    model = _model(case["kind"], case["kwargs"])
    model.load_state_dict(case["state_dict"])
    state = train.state_for(model, 0.1, 0.9)
    grad_accum = case.get("grad_accum", 1)
    step, state = sharding.shard_train_step(
        train.make_train_step(grad_accum=grad_accum, input_key=case["input_key"]), mesh, state)
    if case.get("restore"):
        state = checkpoint.CheckpointManager(case["restore"]).restore(state)
    batch = sharding.shard_batch(case["batch"], *sharding.dp_coordinate(mesh), grad_accum)
    losses = []
    for _ in range(case["steps"]):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if case.get("save_at") == state.step:
            checkpoint.CheckpointManager(case["save_dir"]).save(state)
    full, received = _gather_recorded(state.model)
    local = {n: (p.to_local() if hasattr(p, "to_local") else p).numel()
             for n, p in state.model.named_parameters()}
    numels = [None] * world
    torch.distributed.all_gather_object(numels, local)
    return {"losses": losses, "state_dict": full, "local_numel": numels, "step": state.step,
            "received": received}


def _tp_engine(sp: dict, mesh, rng):
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
    from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig, PagedConfig
    from k8s_device_plugin_tpu_torch.utils import prng

    return ServingEngine(GPTConfig(**sp["cfg"]), sp["state_dict"], PagedConfig(**sp["paged"]),
                         max_slots=2, mesh=mesh, rng=None if rng is None else prng.PRNGKey(rng),
                         admission="optimistic", kv_retain=True, kv_host_cache_mb=8,
                         device="cpu")


def _tp_scenario(eng, scenario: dict) -> dict:
    """The leader's side of one scenario of ``__graft_entry__.py``'s tp bar."""
    kw = scenario.get("sample", {})
    if scenario.get("park"):
        with eng._lock:
            for _ in range(scenario["park"]):
                eng.free_pages.pop()
    done = eng.run(scenario["jobs"], **kw)
    if scenario.get("reclaim"):
        with eng._lock:
            eng._kv_reclaim(scenario["reclaim"])
        done += eng.run(scenario["jobs"], **kw)
    return {"tokens": [r.tokens for r in done],
            "counters": {"preemptions": eng.preemptions,
                         "kv_resumes_restored": eng.kv_resumes_restored,
                         "overlap_discards": eng.overlap_discards,
                         "kv_host_hits": eng.kv_host_hits, "kv_restores": eng.kv_restores},
            "lint": eng.assert_sharded(), "tp": eng.debug_state()["tp"]}


def _tp_main(sp: dict, rank: int, world: int) -> dict:
    from k8s_device_plugin_tpu_torch.models.transformer import (
        GPTConfig,
        TransformerLM,
        greedy_generate,
    )
    from k8s_device_plugin_tpu_torch.parallel.mesh import mesh_from_allocation
    from k8s_device_plugin_tpu_torch.parallel.tensor import TensorParallel, shard_state_dict

    dist = torch.distributed
    mesh = mesh_from_allocation(world, device_type="cpu")
    tp = TensorParallel.from_mesh(mesh)
    cfg = GPTConfig(**sp["cfg"])
    model = TransformerLM(cfg, device="cpu", tp=tp)
    model.load_state_dict(shard_state_dict(sp["state_dict"], tp.size, tp.rank))
    results = {"logits": model(sp["ids"]),
               "generated": greedy_generate(cfg, sp["state_dict"], sp["prompt"], sp["new"],
                                            device="cpu", tp=tp),
               "scenarios": {}}
    for scenario in sp["scenarios"]:
        eng = _tp_engine(sp, mesh, scenario.get("rng"))
        if rank == 0:
            result = _tp_scenario(eng, scenario)
            eng.stop_followers()
        else:
            eng.follow()
        pools = {f"layer_{i}": {k: v.clone() for k, v in eng.kv_pools(i).items()}
                 for i in range(cfg.num_layers)}
        every = [None] * world if rank == 0 else None
        dist.gather_object(pools, every, dst=0)
        if rank == 0:
            result["pools"] = {layer: {k: torch.cat([p[layer][k] for p in every], dim=2)
                                       for k in every[0][layer]} for layer in every[0]}
            result["rank_kv_heads"] = [p["layer_0"]["pool_key"].shape[2] for p in every]
            results["scenarios"][scenario["name"]] = result
    return results


def main(spec_path: str, rank: int) -> None:
    from datetime import timedelta

    from k8s_device_plugin_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # the ranks share the test machine's cores
    spec = torch.load(spec_path, weights_only=False)
    world = spec["world"]
    timeout = timedelta(seconds=120)
    if spec.get("env"):
        env = dict(spec["env"], TPU_WORKER_ID=str(rank))
        assert distributed.initialize(env, backend="gloo", timeout=timeout)
    else:
        assert distributed.initialize({}, local_rank=rank, local_ranks=world, backend="gloo",
                                      init_method=spec["init_method"], timeout=timeout)
    assert torch.distributed.get_world_size() == world and torch.distributed.get_rank() == rank
    try:
        if spec.get("tp_serving"):
            results = _tp_main(spec["tp_serving"], rank, world)
            if rank == 0:
                torch.save(results, spec["out"])
            torch.distributed.barrier()
            return
        results = [_run_case(case, distributed.make_slice_mesh(case.get("mesh", spec["mesh"])),
                             rank, world) for case in spec["cases"]]
        probe = torch.full((2,), float(rank + 1))
        torch.distributed.all_reduce(probe)
        if rank == 0:
            torch.save({"cases": results, "reduced": probe.tolist()}, spec["out"])
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
