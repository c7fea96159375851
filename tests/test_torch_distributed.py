"""The port's multi-host bootstrap (``parallel/distributed.py``) against the
JAX package's.

The env derivation is compared with the reference's over every env dict
that ``tests/test_distributed.py`` uses (and a one-host list of
``localhost``): the same config, or the same exception type and text.  ``initialize`` is checked with ``init_process_group``
replaced: the world is processes x local ranks and the rank host-major.
Then a real two-"host" rendezvous on localhost: two processes, one gloo
rank each, each deriving its group from its own env dict as a pod of
``deploy/k8s-job-resnet50-2host.yaml`` would, reduce a tensor and take two
tiny-GPT steps at ``--dp -1 --mp 1`` (``tests/torch_ranks.py``: a
coordinator port that rank 0 binds and holds, killed 170 s after its
turn), which equal the one-process steps on the same global batch: losses
1e-5 relative, parameters 1e-5 absolute (float32; the two ranks sum the
gradient in another order).  The same spawn then takes
two steps at ``dp 1 x mp 2`` on a batch of 3, which ``dp`` divides and
``dp`` x ``mp`` does not: both ranks take every row, as the reference
replicates the batch over ``mp``.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import dataclasses

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.parallel import distributed as jdist
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.parallel import distributed as tdist
from k8s_device_plugin_tpu_torch.parallel import mesh as tmesh
from k8s_device_plugin_tpu_torch.utils.device import resolve_device
from tests.torch_ranks import Ranks, _model

LOSS_RTOL = 1e-5
ATOL = 1e-5

ENVS = {
    "empty": {},
    "one-host": {"TPU_WORKER_HOSTNAMES": "only-host"},
    "localhost-only": {"TPU_WORKER_HOSTNAMES": "localhost"},
    "plugin-injected": {"TPU_WORKER_HOSTNAMES": "tpu-job-0.headless,tpu-job-1.headless",
                        "TPU_WORKER_ID": "1"},
    "port-override": {"TPU_WORKER_HOSTNAMES": "a,b,c,d", "TPU_WORKER_ID": "2",
                      "JAX_COORDINATOR_PORT": "9999"},
    "explicit-wins": {"JAX_COORDINATOR_ADDRESS": "coord.svc:1234", "JAX_NUM_PROCESSES": "16",
                      "JAX_PROCESS_ID": "5", "TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "0"},
    "explicit-no-port": {"JAX_COORDINATOR_ADDRESS": "coord.svc", "TPU_WORKER_HOSTNAMES": "a,b",
                         "TPU_WORKER_ID": "1"},
    "explicit-no-id": {"JAX_COORDINATOR_ADDRESS": "coord.svc", "JAX_NUM_PROCESSES": "4"},
    "explicit-id-range": {"JAX_COORDINATOR_ADDRESS": "coord.svc", "JAX_NUM_PROCESSES": "2",
                          "JAX_PROCESS_ID": "5"},
    "explicit-no-count": {"JAX_COORDINATOR_ADDRESS": "coord.svc"},
    "explicit-solo": {"JAX_COORDINATOR_ADDRESS": "coord.svc", "JAX_NUM_PROCESSES": "1"},
    "explicit-bad-id": {"JAX_COORDINATOR_ADDRESS": "c", "JAX_NUM_PROCESSES": "2",
                        "JAX_PROCESS_ID": "x"},
    "malformed-id": {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "one"},
    "id-range": {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "7"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_derivation_is_the_reference_s(name):
    env = ENVS[name]
    try:
        want = jdist.process_group_from_env(env)
    except ValueError as e:
        with pytest.raises(type(e)) as got:
            tdist.process_group_from_env(env)
        assert str(got.value) == str(e)
        return
    got = tdist.process_group_from_env(env)
    assert (None if got is None else dataclasses.asdict(got)) == (
        None if want is None else dataclasses.asdict(want))


@pytest.fixture
def fake_group(monkeypatch):
    """``init_process_group`` recorded instead of run; the group then
    counts as formed."""
    calls = []
    formed = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: bool(formed))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: (calls.append(dict(kw, backend=backend)),
                                               formed.append(1)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    return calls


def test_initialize_without_a_group_to_join(fake_group):
    assert tdist.initialize({}) is False
    assert tdist.initialize({"TPU_WORKER_HOSTNAMES": "localhost"}) is False
    assert fake_group == []


def test_initialize_joins_the_slice_host_major_once(fake_group, monkeypatch):
    env = {"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "1"}
    assert tdist.initialize(env, local_rank=1, local_ranks=2, backend="gloo") is True
    assert tdist.initialize(env, local_rank=1, local_ranks=2, backend="gloo") is True
    assert fake_group == [{"init_method": "tcp://h0:8476", "world_size": 4, "rank": 3,
                           "backend": "gloo"}]
    import os

    assert (os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"]) == ("1", "2")


def test_initialize_forms_a_local_group_when_asked(fake_group):
    assert tdist.initialize({}, local_rank=2, local_ranks=3, init_method="tcp://127.0.0.1:1",
                            backend="gloo") is True
    assert fake_group == [{"init_method": "tcp://127.0.0.1:1", "world_size": 3, "rank": 2,
                           "backend": "gloo"}]


def test_world_of_one_meshes():
    """A real gloo group of one: the slice mesh and the allocation mesh."""
    torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(),
                                         world_size=1, rank=0)
    try:
        mesh = tdist.make_slice_mesh({"dp": -1, "mp": 1})
        assert mesh.mesh_dim_names == ("dp", "mp") and tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.device_type == "cpu"
        tp = tmesh.mesh_from_allocation(1, environ={})
        assert tp.mesh_dim_names == ("tp",) and tp.mesh.tolist() == [0]
        with pytest.raises(ValueError, match="do not cover 1 devices"):
            tdist.make_slice_mesh({"dp": 2, "mp": 1})
    finally:
        torch.distributed.destroy_process_group()


def test_ranks_map_to_cards():
    assert resolve_device("cpu", local_rank=3) == torch.device("cpu")


def _one_process_steps(kwargs, state_dict, batch, steps):
    state = ttrain.state_for(_model("gpt", kwargs), 0.1, 0.9)
    state.model.load_state_dict(state_dict)
    step = ttrain.make_train_step()
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, state.model.state_dict()


def _assert_steps_equal(result, want):
    losses, state_dict = want
    np.testing.assert_allclose(result["losses"], losses, rtol=LOSS_RTOL)
    for name, value in state_dict.items():
        np.testing.assert_allclose(result["state_dict"][name].numpy(), value.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    """One spawn of two gloo ranks, one a "host": two tiny-GPT steps at
    ``--dp -1 --mp 1`` on a batch of 4, then at ``dp 1 x mp 2`` on a batch
    of 3 (both ranks take every row, as the reference replicates the batch
    over ``mp``)."""
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=2)
    kwargs = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    state_dict = {k: v.detach().clone() for k, v in _model("gpt", kwargs).state_dict().items()}
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab_size, size=(4, 33)))
    batch = {"input_ids": ids[:, :-1].long(), "labels": ids[:, 1:].long()}
    odd = {k: v[:3] for k, v in batch.items()}
    env = {"TPU_WORKER_HOSTNAMES": "localhost,localhost"}  # the port: bound by rank 0 at its turn
    case = {"kind": "gpt", "kwargs": kwargs, "state_dict": state_dict, "batch": batch,
            "input_key": "input_ids", "steps": 2}
    cases = [case, dict(case, batch=odd, mesh={"dp": 1, "mp": 2})]
    got = Ranks({"env": env, "mesh": {"dp": -1, "mp": 1}, "cases": cases}, 2,
                str(tmp_path_factory.mktemp("two_hosts"))).wait()
    return got, kwargs, state_dict, batch, odd


def test_two_hosts_reduce_and_step_as_one_process(two_hosts):
    got, kwargs, state_dict, batch, _ = two_hosts
    assert got["reduced"] == [3.0, 3.0]
    _assert_steps_equal(got["cases"][0], _one_process_steps(kwargs, state_dict, batch, 2))


def test_dp1_mp2_takes_a_batch_of_three_as_one_process(two_hosts):
    """A batch ``dp`` divides and ``dp`` x ``mp`` does not: each mp rank
    takes all three rows, and the sharded steps equal one rank's within
    1e-5."""
    got, kwargs, state_dict, _, odd = two_hosts
    result = got["cases"][1]
    _assert_steps_equal(result, _one_process_steps(kwargs, state_dict, odd, 2))
    # mp 2 sharded the large leaves.
    assert any(n < state_dict[name].numel() for name, n in result["local_numel"][0].items())
