"""Gloo ranks on the CPU for the port's multi-rank tests.

:class:`Ranks` starts one process per rank (``python
tests/torch_ranks.py <spec> <rank>``), and its ``wait`` waits for all of
them under one time limit, killing every one on a timeout or a failure, so
no group outlives its test.  At most :data:`GROUPS_AT_ONCE` groups of
the suite run at a time, whatever the test workers run side by side
(:func:`_take_turn`), and a group's time limit counts from its turn.  A
rank joins the group through ``parallel/distributed.initialize``: through
a file in the test's directory (``file://``), or from the spec's ``env``
(the multi-host derivation, one rank per "host"; rank 0 binds the
coordinator's port when the group's turn comes and holds it open until
its group joins, :func:`_take_turn`).  No port is picked free, closed and
handed out: another process could bind it in between.
Each rank runs each case of ``spec["cases"]`` through
``parallel/sharding.shard_train_step`` over ``make_slice_mesh`` of its
mesh; rank 0 saves the results to ``spec["out"]``.  This file imports no
JAX: the test modules hold the results against the JAX package.

A case: ``kind`` ("gpt", "moe", "sp", "resnet", "alexnet") and ``kwargs``
of the port's model (built on the CPU; "moe" adds ``experts``; "sp" is the
LM attending through ``parallel/sequence.sp_attention_fn`` of the case's
mesh, its engine named by ``sp_kind``, trained through
``shard_train_step_sp`` on ``sp_batch_sharding``'s part), its starting
``state_dict``, the global ``batch``, ``input_key``, ``steps`` and
``grad_accum``; optionally ``mesh`` (a layout of the same ranks in place
of the spec's), ``tp`` (shard through ``parallel/tensor.shard_train_step_tp``
over that mesh instead), ``aux_loss_coeff``, ``restore`` (a checkpoint
directory restored after sharding), ``save_dir`` and ``save_at`` (a step
after which the sharded state is saved).  Each result holds, among the
rest, the names of what every rank sent rank 0 when it gathered the final
state (``received``).

A spec with ``tp_serving`` runs tensor-parallel serving instead
(:func:`_tp_main`): the sharded forward and ``greedy_generate`` on every
rank, then each scenario through a ``ServingEngine`` over the ``tp`` mesh,
rank 0 leading and the others following, and each rank's pools gathered
to rank 0 after it.  Its ``served`` scenarios build their own engines
(config overrides, weights and engine arguments: quantized weights,
stacked adapters, a speculative draft) and drive ``(prompt, n, adapter)``
jobs (:func:`drive_jobs`), or run a prefill -> decode handoff
(:func:`handoff_run`); the test process drives the unsharded engines the
same way.

A spec with ``pipeline`` runs its ``cases`` through the port's
``parallel/pipeline.py``, ``pipeline_1f1b.py`` and ``pipeline_lm.py``
(:func:`_pp_main`) over each case's mesh: the toy stages' forward, GPipe
gradient and 1F1B gradients, ``PipelinedLM``'s forward and one train step
of each schedule, and its layer-count error; rank 0 gets every rank's
results.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Rank groups of the suite that may run at once, each holding one lock
# file: every group's ranks share the machine's cores and memory with the
# test workers.
GROUPS_AT_ONCE = 2
# How long a group may wait for its turn.
TURN_TIMEOUT_S = 600.0
# Rank 0's coordinator store, bound before its port is handed out.
_held = []


def _coordinator_port(world: int) -> str:
    """A port that rank 0's process holds from now on: a c10d store
    listening on a port the kernel chose, kept for the process's life.
    ``init_process_group``'s own store on that port then shares the
    listener (c10d's stores are multi-tenant within a process), so no
    other process can bind the port between its choice and its use."""
    store = torch.distributed.TCPStore("127.0.0.1", 0, world, True, multi_tenant=True,
                                       wait_for_workers=False)
    _held.append(store)
    return str(store.port)


def _lock_fds() -> list:
    """Open (creating) the suite's GROUPS_AT_ONCE lock files in the temp
    dir the test workers share."""
    return [os.open(os.path.join(tempfile.gettempdir(), f"torch_ranks.{i}.lock"),
                    os.O_CREAT | os.O_RDWR, 0o600) for i in range(GROUPS_AT_ONCE)]


def _try_lock(fds: list) -> bool:
    """Take one of ``fds``' flocks if one is free; the kernel drops it when
    its fd closes or its holder exits."""
    for fd in fds:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            continue
        return True
    return False


@contextlib.contextmanager
def group_turn(timeout: float = TURN_TIMEOUT_S):
    """One of the suite's turns for a process that spawns its own ranks
    (the benchmark CLI, ``launch`` from a script), held for the block: the
    caller starts the process inside it and counts its time limit from
    there.  Raises TimeoutError when no turn comes within ``timeout``."""
    fds = _lock_fds()
    try:
        deadline = time.monotonic() + timeout
        while not _try_lock(fds):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no rank-group turn within {timeout:.0f} s")
            time.sleep(0.1)
        yield
    finally:
        for fd in fds:
            os.close(fd)


def _take_turn(spec: dict, rank: int) -> str:
    """Rank 0 takes one of the suite's GROUPS_AT_ONCE lock files (in the
    temp dir the test workers share) and holds it until its process ends
    (the kernel drops an flock with its holder); then, for a spec with
    ``env``, it binds the multi-host derivation's coordinator port
    (:func:`_coordinator_port`), and writes the port ("" without ``env``)
    to ``spec["turn"]``.  Every rank returns it, the others once the file
    is there."""
    turn = spec["turn"]
    if rank == 0:
        fds = _lock_fds()
        while not os.path.exists(turn):
            if _try_lock(fds):
                with open(turn + ".tmp", "w") as f:
                    f.write(_coordinator_port(spec["world"]) if spec.get("env") else "")
                os.replace(turn + ".tmp", turn)
            else:
                time.sleep(0.1)
    while not os.path.exists(turn):
        time.sleep(0.05)
    with open(turn) as f:
        return f.read()


class Ranks:
    """``world`` rank processes on ``spec`` (``init_method``, ``turn`` and
    ``out`` filled in here), started at once; :meth:`wait` returns rank
    0's results."""

    def __init__(self, spec: dict, world: int, tmp_dir, timeout: float = 170.0):
        self.spec = dict(spec, world=world,
                         init_method=f"file://{os.path.join(tmp_dir, 'rendezvous')}",
                         turn=os.path.join(tmp_dir, "turn"),
                         out=os.path.join(tmp_dir, "results.pt"))
        spec_path = os.path.join(tmp_dir, "spec.pt")
        torch.save(self.spec, spec_path)
        env = dict(os.environ, PYTHONPATH=REPO)
        self.timeout = timeout
        self.deadline = time.monotonic() + TURN_TIMEOUT_S + timeout
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
        started = False
        try:
            while any(p.poll() is None for p in self.procs):
                if not started and os.path.exists(self.spec["turn"]):
                    started = True
                    self.deadline = time.monotonic() + self.timeout
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


def _model(kind: str, kwargs: dict, attention_fn=None):
    if kind in ("gpt", "moe", "sp"):
        from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig, TransformerLM
        from k8s_device_plugin_tpu_torch.parallel.moe import moe_mlp_factory

        kwargs = dict(kwargs)
        experts = kwargs.pop("experts", None)
        cfg = GPTConfig(**kwargs)
        factory = moe_mlp_factory(cfg, experts) if kind == "moe" else None
        return TransformerLM(cfg, device="cpu", train=True, mlp_factory=factory,
                             attention_fn=attention_fn)
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
    from k8s_device_plugin_tpu_torch.parallel import sequence, sharding, tensor

    sp = case["kind"] == "sp"
    attention_fn = sequence.sp_attention_fn(mesh, kind=case["sp_kind"]) if sp else None
    model = _model(case["kind"], case["kwargs"], attention_fn)
    model.load_state_dict(case["state_dict"])
    state = train.state_for(model, 0.1, 0.9)
    grad_accum = case.get("grad_accum", 1)
    shard = (sequence.shard_train_step_sp if sp else
             tensor.shard_train_step_tp if case.get("tp") else sharding.shard_train_step)
    step, state = shard(
        train.make_train_step(case.get("aux_loss_coeff", 0.0), grad_accum=grad_accum,
                              input_key=case["input_key"]), mesh, state)
    if case.get("restore"):
        state = checkpoint.CheckpointManager(case["restore"]).restore(state)
    if sp:
        batch = sequence.sp_batch_sharding(case["batch"], mesh)
    else:
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
            "received": received, "sp_calls": dict(attention_fn.sp.calls) if sp else None}


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


def drive_jobs(eng, jobs: list, sample: Optional[dict] = None) -> list:
    """Submit ``(prompt, max_new, adapter)`` jobs (``sample`` applies to
    each), step until drained; the token streams in submission order.
    Takes the JAX package's engine too."""
    subs = [eng.submit(list(p), n, adapter=a, **(sample or {})) for p, n, a in jobs]
    for _ in range(10_000):
        if all(r.done for r in subs):
            return [list(r.tokens) for r in subs]
        eng.step()
    raise RuntimeError("engine failed to drain")


def handoff_prefill(eng, snap, prompt: list) -> tuple:
    """A prefill-role engine's probe of ``prompt`` (chunk by chunk, the
    tap's pushed entries) as the wire's bytes: ``(entries wire, logits
    section)``.  ``snap``: the package's ``engine_snapshot`` module (the
    logits section's encoder is its ``engine_handoff``'s)."""
    import importlib

    handoff = importlib.import_module(snap.__name__.replace("engine_snapshot", "engine_handoff"))
    tap = eng.handoff_begin(list(prompt), None)
    entries = []
    try:
        for _ in range(200):
            eng.step()
            while True:
                e = tap.pop(0.0)
                if e is None:
                    break
                entries.append(e)
            if tap.req.done and tap.pushed <= len(entries):
                break
    finally:
        eng.handoff_end(tap)
    layout = snap.snapshot_layout(eng)
    fp = getattr(eng, "params_fingerprint", None) or snap.params_fingerprint(eng.params)
    wire = snap.encode_preamble(layout, fp, len(entries)) + b"".join(
        snap.encode_entry(layout, k, r) for k, r in entries)
    return wire, handoff.encode_logits_section(tap.logits)


def handoff_decode(eng, snap, wire: bytes, prompt: list, n: int) -> dict:
    """A decode-role engine admitting ``wire``'s entries, then decoding
    ``prompt``: its tokens and the prefill positions it skipped."""
    import io

    layout = snap.snapshot_layout(eng)
    _, parsed = snap._parse_snapshot(io.BytesIO(wire), layout, eng.params_fingerprint)
    admitted = snap._admit_entries(eng, parsed)
    tokens = drive_jobs(eng, [(prompt, n, None)])
    return {"tokens": tokens, "admitted": admitted, "skipped": eng.handoff_skipped_tokens}


def _served_engine(sp: dict, scenario: dict, mesh, role: str = "unified"):
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
    from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig, PagedConfig

    kw = dict(scenario.get("engine", {}))
    if role != "unified":
        kw.update(role=role, kv_retain=True, kv_host_cache_mb=8, prefill_chunk=4)
    return ServingEngine(GPTConfig(**{**sp["cfg"], **scenario.get("cfg", {})}),
                         scenario.get("state", sp["state_dict"]), PagedConfig(**sp["paged"]),
                         max_slots=2, mesh=mesh, device="cpu", **kw)


def _gathered(eng, cfg, rank: int, world: int):
    """Every rank's pools joined on kv heads at rank 0 (None elsewhere),
    and each rank's kv head count."""
    pools = {f"layer_{i}": {k: v.clone() for k, v in eng.kv_pools(i).items()}
             for i in range(cfg.num_layers)}
    every = [None] * world if rank == 0 else None
    torch.distributed.gather_object(pools, every, dst=0)
    if rank:
        return None
    joined = {layer: {k: torch.cat([p[layer][k] for p in every], dim=2) for k in every[0][layer]}
              for layer in every[0]}
    return joined, [p["layer_0"]["pool_key"].shape[2] for p in every]


def _served(sp: dict, scenario: dict, mesh, rank: int, world: int) -> Optional[dict]:
    """One ``served`` scenario on every rank; rank 0's result."""
    from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap
    from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig

    cfg = GPTConfig(**sp["cfg"])
    if "handoff" in scenario:
        prompt, n = scenario["handoff"]
        pre = _served_engine(sp, scenario, mesh, "prefill")
        result = None
        if rank == 0:
            wire, logits = handoff_prefill(pre, snap, prompt)
            result = {"wire": wire, "logits": logits}
            pre.stop_followers()
        else:
            pre.follow()
        dec = _served_engine(sp, scenario, mesh, "decode")
        if rank == 0:
            result.update(handoff_decode(dec, snap, wire, prompt, n))
            dec.stop_followers()
        else:
            dec.follow()
        eng = dec
    else:
        eng = _served_engine(sp, scenario, mesh)
        result = None
        if rank == 0:
            result = {"tokens": drive_jobs(eng, scenario["jobs"], scenario.get("sample")),
                      "rank_stats": eng.rank_stats(), "lint": eng.assert_sharded(),
                      "spec_rounds": eng.spec_rounds}
            eng.stop_followers()
        else:
            eng.follow()
    joined = _gathered(eng, cfg, rank, world)
    if rank == 0:
        result["pools"], result["rank_kv_heads"] = joined
    return result


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
    for scenario in sp.get("served", []):
        result = _served(sp, scenario, mesh, rank, world)
        if rank == 0:
            results["scenarios"][scenario["name"]] = result
    return results


def _pp_stage_fn(kind: str):
    """The toy stages of the JAX package's pipeline tests: "residual" (x +
    tanh(x @ w + b)) and "tanh" (tanh(x @ w + b))."""
    if kind == "residual":
        return lambda p, x: x + torch.tanh(x @ p["w"] + p["b"])
    return lambda p, x: torch.tanh(x @ p["w"] + p["b"])


def _pp_head(p, y):
    return y @ p["w"]


def _pp_lm(case: dict, mesh) -> dict:
    """``PipelinedLM`` on this rank: the forward both ways, then one train
    step of the case's schedule from its weights, with the group's calls
    in that step."""
    from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig
    from k8s_device_plugin_tpu_torch.parallel.pipeline_lm import PipelinedLM

    plm = PipelinedLM(GPTConfig(**case["cfg"]), mesh, case["n_micro"], device="cpu")
    plm.load_state_dict(case["state_dict"])
    ids = case["batch"]["input_ids"]
    out = {"apply": plm.apply(ids), "apply_serial": plm.apply_serial(ids)}
    plm.pp.calls.clear()
    step = plm.make_train_step(case["schedule"])
    _, loss = step(plm.create_train_state(0.1, 0.9), case["batch"])
    return dict(out, loss=float(loss), state_dict=plm.state_dict(), calls=dict(plm.pp.calls))


def _pp_case(case: dict, mesh) -> dict:
    """One case of a ``pipeline`` spec on this rank."""
    from k8s_device_plugin_tpu_torch.parallel import pipeline, pipeline_1f1b
    from k8s_device_plugin_tpu_torch.parallel.pipeline_lm import PipelinedLM

    op = case["op"]
    if op == "lm":
        return _pp_lm(case, mesh)
    if op == "lm_error":
        from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig

        try:
            PipelinedLM(GPTConfig(**case["cfg"]), mesh, 2, device="cpu")
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    fn = _pp_stage_fn(case["stage"])
    stacked, micro = case["stacked"], case["micro"]
    if op == "apply":
        return {"y": pipeline.pipeline_apply(fn, stacked, micro, mesh)}
    if op == "loss_grad":
        params = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        inputs = micro.clone().requires_grad_()
        loss = pipeline.pipelined_loss_fn(fn, mesh)(params, inputs, case["targets"])
        loss.backward()
        return {"loss": float(loss), "grads": {k: v.grad for k, v in params.items()},
                "d_micro": inputs.grad}
    stats: dict = {}
    if "head" in case:
        loss, grads, head_grads, d_micro = pipeline_1f1b.pipeline_1f1b_train(
            fn, stacked, micro, case["targets"], mesh, head_fn=_pp_head,
            head_params=case["head"], stats=stats)
        return {"loss": float(loss), "grads": grads, "head_grads": head_grads,
                "d_micro": d_micro, "stats": stats}
    loss, grads = pipeline_1f1b.pipeline_1f1b_grads(fn, stacked, micro, case["targets"], mesh,
                                                    stats=stats)
    return {"loss": float(loss), "grads": grads, "stats": stats}


def _pp_main(sp: dict, rank: int, world: int) -> dict:
    """Every case of a ``pipeline`` spec over its mesh; rank 0 gets, for
    each, every rank's result with its mesh coordinates, by rank."""
    from k8s_device_plugin_tpu_torch.parallel import distributed

    results = {}
    for case in sp["cases"]:
        mesh = distributed.make_slice_mesh(case["mesh"], device_type="cpu")
        out = dict(_pp_case(case, mesh),
                   coords=dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())))
        every = [None] * world
        torch.distributed.all_gather_object(every, out)
        results[case["name"]] = every
    return results


def main(spec_path: str, rank: int) -> None:
    from datetime import timedelta

    from k8s_device_plugin_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # the ranks share the test machine's cores
    spec = torch.load(spec_path, weights_only=False)
    world = spec["world"]
    port = _take_turn(spec, rank)
    timeout = timedelta(seconds=120)
    if spec.get("env"):
        env = dict(spec["env"], TPU_WORKER_ID=str(rank), JAX_COORDINATOR_PORT=port)
        assert distributed.initialize(env, backend="gloo", timeout=timeout)
    else:
        assert distributed.initialize({}, local_rank=rank, local_ranks=world, backend="gloo",
                                      init_method=spec["init_method"], timeout=timeout)
    assert torch.distributed.get_world_size() == world and torch.distributed.get_rank() == rank
    try:
        if spec.get("tp_serving") or spec.get("pipeline"):
            results = (_tp_main(spec["tp_serving"], rank, world) if spec.get("tp_serving")
                       else _pp_main(spec["pipeline"], rank, world))
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
