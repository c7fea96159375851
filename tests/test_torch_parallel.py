"""The port's data parallelism and FSDP (``parallel/``) against the JAX
package's.

The pure parts (the leaf rule, the mesh's axis rules, snake order, the
allocation env readers) are compared case by case with the reference's
functions.  The sharded step runs in one group of 4 gloo ranks for the
whole module (``tests/torch_ranks.py``: a file rendezvous, killed 170 s
after its turn), at dp2 x mp2, and is held against the JAX package's
``shard_train_step`` at the same mesh over 4 of conftest's 8 virtual CPU
devices, from the same flax init (moved over by ``convert``) and the same
numpy batch:

- tiny GPT (``GPTConfig.tiny()``, 2 kv heads), batch 4 x 64 tokens;
- ResNet18Thin (BatchNorm: the global batch's moments and running
  averages), batch 16 at 32 px, and again with ``grad_accum`` 2;
- AlexNet at width 0.125 on 128 px (dropout: each rank draws the global
  mask's rows), batch 8;
- tiny GPT again at dp4 x mp1 over the same ranks, where gathering the
  state to rank 0 takes rank 0's own copy alone.

Tolerances (float32): losses 1e-5 relative, every parameter and BatchNorm
statistic 1e-5 absolute after two SGD-momentum steps (lr 0.1), as the
one-process parity tests (``tests/test_torch_vision.py``): the ranks sum
the gradient in another order, ~1e-7 relative.  A checkpoint saved at dp2
x mp2 after step 1 and resumed in one process, and a one-process
checkpoint resumed on the 4 ranks, each take step 2 to the uninterrupted
run's state within the same tolerance.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import alexnet as jalex
from k8s_device_plugin_tpu.models import resnet as jres
from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.parallel import mesh as jmesh
from k8s_device_plugin_tpu.parallel import sharding as jshard
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import checkpoint as tckpt
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.parallel import mesh as tmesh
from k8s_device_plugin_tpu_torch.parallel import sharding as tshard
from tests.torch_ranks import Ranks, _model

LOSS_RTOL = 1e-5
ATOL = 1e-5
CLASSES = 10
MESH = {"dp": 2, "mp": 2}
WORLD = 4
# Cases laid out otherwise than MESH, over the same ranks.
CASE_MESH = {"gpt-dp4": {"dp": 4, "mp": 1}}


# ---------------------------------------------------------- pure functions


def _jax_tree(kind):
    """The flax parameter tree's shapes (``eval_shape``: nothing runs)."""
    if kind == "resnet":
        model = jres.ResNet18Thin(num_classes=CLASSES, dtype=jnp.float32, norm_dtype=jnp.float32)
        x = jnp.zeros((1, 32, 32, 3))
    else:
        model = jtf.TransformerLM(dataclasses.replace(jtf.GPTConfig.tiny(), num_kv_heads=2))
        x = jnp.zeros((1, 8), jnp.int32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("kind", ["resnet", "gpt"])
def test_leaf_rule_is_the_reference_s(kind, mp):
    """Leaf by leaf, the port's rule on a shape names the dimension the
    reference's ``param_sharding`` shards over ``mp`` (None: replicated)."""
    tree = _jax_tree(kind)
    mesh = jmesh.make_mesh({"dp": 8 // mp, "mp": mp})
    specs = jshard.param_sharding(tree, mesh)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    sharded = 0
    for (path, leaf), spec in zip(leaves, jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))):
        want = next((i for i, a in enumerate(spec.spec) if a == "mp"), None)
        assert tshard.shard_dim(leaf.shape, mp) == want, jax.tree_util.keystr(path)
        sharded += want is not None
    assert 0 < sharded < len(leaves)  # both branches of the rule are taken


@pytest.mark.parametrize("axes, n", [
    (None, 8), ({"dp": 2, "mp": 4}, 8), ({"dp": 2, "mp": -1}, 8), ({"dp": -1, "mp": 2}, 4),
    ({"dp": 3}, 8), ({"dp": -1, "mp": -1}, 8), ({"dp": -1, "mp": 3}, 8), ({"dp": 2, "mp": 2}, 8),
], ids=["default", "2x4", "dp2-rest", "rest-mp2", "uncovered", "two-rest", "indivisible",
        "short"])
def test_mesh_axis_rules_are_the_reference_s(axes, n):
    """The same sizes, or the same error text, for the same axes over n
    devices (ranks)."""
    try:
        want = dict(jmesh.make_mesh(axes, devices=jax.devices()[:n]).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{re.escape(str(e))}$"):
            tmesh.make_mesh(axes, devices=list(range(n)))
        return
    assert tmesh.mesh_shape(axes, n) == want


@pytest.mark.parametrize("bounds", [(1, 1, 1), (2, 2, 1), (2, 4, 1), (4, 2, 1), (2, 2, 2),
                                    (3, 1, 1), (2,), (1, 4)])
def test_snake_order_is_the_reference_s(bounds):
    assert tmesh.snake_order(bounds) == jmesh.snake_order(bounds)


@pytest.mark.parametrize("env", [
    {}, {"TPU_CHIPS_PER_HOST_BOUNDS": "2,4,1"}, {"TPU_CHIPS_PER_HOST_BOUNDS": "x"},
    {"TPU_VISIBLE_CHIPS": "0,1,2,3"}, {"TPU_VISIBLE_CHIPS": "4,5"}, {"TPU_VISIBLE_CHIPS": "a"},
], ids=["none", "bounds", "bad-bounds", "chips", "chips-high", "bad-chips"])
def test_allocation_env_readers_are_the_reference_s(env):
    assert tmesh.chips_per_host_bounds(env) == jmesh.chips_per_host_bounds(env)
    assert tmesh.allocated_chip_indices(env) == jmesh.allocated_chip_indices(env)


@pytest.mark.parametrize("tp, env, n", [
    (4, {}, 8), (9, {}, 8), (0, {}, 8),
    (4, {"TPU_VISIBLE_CHIPS": "0,1,2,3", "TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1"}, 4),
    (8, {"TPU_VISIBLE_CHIPS": ",".join(map(str, range(8))), "TPU_CHIPS_PER_HOST_BOUNDS": "2,4,1"},
     8),
    (4, {"TPU_VISIBLE_CHIPS": "0,1,2,3", "TPU_CHIPS_PER_HOST_BOUNDS": "2,4,1"}, 4),
    (2, {"TPU_VISIBLE_CHIPS": "0,1,2,3"}, 4),
    (4, {"TPU_VISIBLE_CHIPS": "0,1,2,3"}, 2),
], ids=["off-cluster", "too-many", "zero", "block-2x2", "block-2x4", "bounds-mismatch",
        "count-mismatch", "too-few-ranks"])
def test_allocation_order_is_the_reference_s(tp, env, n):
    """``mesh_from_allocation``'s order: the port's ranks are the
    reference's device ids over the same n devices, or the same error (its
    text up to where the reference names jax's devices and the port ranks)."""
    try:
        mesh = jmesh.mesh_from_allocation(tp, environ=env, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.allocation_ranks(tp, environ=env, devices=list(range(n)))
        if "rank(s) run on this host" not in str(got.value):
            assert str(got.value).split(" (")[0] == str(e).split(" (")[0]
        return
    assert tmesh.allocation_ranks(tp, environ=env, devices=list(range(n))) == [
        d.id for d in mesh.devices.flat]


@pytest.mark.parametrize("n, world, grad_accum", [(16, 4, 1), (16, 4, 2), (8, 2, 4), (6, 1, 3)])
def test_batch_rows_split_every_microbatch_over_the_ranks(n, world, grad_accum):
    rows = [tshard.batch_rows(n, r, world, grad_accum) for r in range(world)]
    assert sorted(torch.cat(rows).tolist()) == list(range(n))
    micro = n // grad_accum
    for r, mine in enumerate(rows):
        for i, part in enumerate(mine.chunk(grad_accum)):
            share = micro // world
            assert part.tolist() == list(range(i * micro + r * share, i * micro + (r + 1) * share))
    with pytest.raises(ValueError, match="not divisible"):
        tshard.batch_rows(n + 1, 0, world, grad_accum)


# ------------------------------------------------------------ the sharded step


def _images(n, size, seed):
    rs = np.random.RandomState(seed)
    return {"images": rs.randn(n, size, size, 3).astype(np.float32),
            "labels": rs.randint(0, CLASSES, size=n).astype(np.int32)}


def _tokens(n, seq, vocab, seed):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(n, seq + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cases():
    """(name, JAX model, flax variables, port kind and kwargs, batch,
    input key, grad_accum)."""
    gcfg = dataclasses.replace(jtf.GPTConfig.tiny(), num_kv_heads=2)
    port_cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=2)
    tcfg = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)}
    resnet = jres.ResNet18Thin(num_classes=CLASSES, dtype=jnp.float32, norm_dtype=jnp.float32)
    rkw = {"num_classes": CLASSES, "dtype": torch.float32, "norm_dtype": torch.float32}
    alex = jalex.AlexNet(num_classes=CLASSES, dtype=jnp.float32, width=0.125)
    akw = {"num_classes": CLASSES, "dtype": torch.float32, "width": 0.125, "image_size": 128}
    rbatch = _images(16, 32, seed=0)
    abatch = _images(8, 128, seed=5)
    gbatch = _tokens(4, 64, gcfg.vocab_size, seed=0)
    # flax's init, compiled whole (op by op it takes seconds a model).
    rvars = _np(jax.jit(resnet.init)(jax.random.PRNGKey(1), jnp.asarray(rbatch["images"][:1])))
    avars = _np(jax.jit(alex.init)(jax.random.PRNGKey(6), jnp.asarray(abatch["images"][:1])))
    gvars = _np(jax.jit(jtf.TransformerLM(gcfg).init)(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 8), jnp.int32)))
    return [
        ("gpt", jtf.TransformerLM(gcfg), gvars, "gpt", tcfg, gbatch, "input_ids", 1),
        ("gpt-dp4", jtf.TransformerLM(gcfg), gvars, "gpt", tcfg, gbatch, "input_ids", 1),
        ("resnet", resnet, rvars, "resnet", rkw, rbatch, "images", 1),
        ("resnet-accum2", resnet, rvars, "resnet", rkw, rbatch, "images", 2),
        ("alexnet", alex, avars, "alexnet", akw, abatch, "images", 1),
    ]


def _state_dict(variables):
    sd = convert.flax_to_state_dict(variables["params"])
    sd.update(convert.flax_to_state_dict(variables.get("batch_stats", {})))
    return sd


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_sharded_steps(jmodel, variables, batch, input_key, grad_accum, mesh, steps=2):
    tx = optax.sgd(0.1, momentum=0.9)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params),
                              batch_stats=variables.get("batch_stats", {}))
    mesh = jmesh.make_mesh(mesh, devices=jax.devices()[:WORLD])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step, state, batch_sh = jshard.shard_train_step(
        jtrain.make_train_step(jmodel, tx, input_key=input_key, grad_accum=grad_accum), mesh,
        state, jb)
    jb = jax.device_put(jb, batch_sh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, jb)
        losses.append(float(loss))
    flat = _state_dict({"params": _np(state.params), "batch_stats": _np(state.batch_stats)})
    return losses, flat


def _one_process(kind, kwargs, state_dict, batch, input_key, steps, save_dir=None, restore=None):
    """The port unsharded in this process: ``steps`` steps on the global
    batch (after restoring ``restore``), saving after step 1 to
    ``save_dir``."""
    state = ttrain.state_for(_model(kind, kwargs), 0.1, 0.9)
    state.model.load_state_dict(state_dict)
    if restore is not None:
        state = tckpt.CheckpointManager(restore).restore(state)
    step = ttrain.make_train_step(input_key=input_key)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if save_dir is not None and state.step == 1:
            tckpt.CheckpointManager(save_dir).save(state)
    return losses, {k: v.detach().clone() for k, v in state.model.state_dict().items()}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Rank 0's results of every case, the JAX package's, and the
    one-process runs around the checkpoints."""
    tmp = tmp_path_factory.mktemp("ranks")
    cases = _cases()
    specs = []
    for name, _, variables, kind, kwargs, batch, key, accum in cases:
        spec = {"name": name, "kind": kind, "kwargs": kwargs, "state_dict": _state_dict(variables),
                "batch": _torch_batch(batch), "input_key": key, "steps": 2, "grad_accum": accum,
                "mesh": CASE_MESH.get(name, MESH)}
        if name == "resnet":
            spec.update(save_dir=str(tmp / "ckpt_ranks"), save_at=1)
        specs.append(spec)
    resnet = next(s for s in specs if s["name"] == "resnet")
    # One process, two steps, saving after the first: what the ranks resume.
    one = _one_process("resnet", resnet["kwargs"], resnet["state_dict"], resnet["batch"],
                       "images", 2, save_dir=tmp / "ckpt_one")
    specs.append(dict(resnet, name="resnet-resumed", steps=1, restore=str(tmp / "ckpt_one"),
                      save_dir=None, save_at=None))
    running = Ranks({"mesh": MESH, "cases": specs}, WORLD, str(tmp))
    want = {name: _jax_sharded_steps(jm, v, b, key, accum, CASE_MESH.get(name, MESH))
            for name, jm, v, _, _, b, key, accum in cases}
    ranks = running.wait()
    got = {spec["name"]: result for spec, result in zip(specs, ranks["cases"])}
    return {"got": got, "want": want, "one": one, "specs": {s["name"]: s for s in specs},
            "reduced": ranks["reduced"], "tmp": tmp}


def _assert_state_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=0, atol=ATOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", ["gpt", "gpt-dp4", "resnet", "resnet-accum2", "alexnet"])
def test_sharded_step_is_the_reference_s(sharded, case):
    """Two steps at dp2 x mp2 (dp4 x mp1 for gpt-dp4): the global batch's
    losses, parameters and BatchNorm statistics, as the JAX package's
    sharded step at the same mesh."""
    got, (want_losses, want_state) = sharded["got"][case], sharded["want"][case]
    assert got["step"] == 2
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_state_close(got["state_dict"], {k: torch.as_tensor(v) for k, v in
                                            want_state.items()}, case)


@pytest.mark.parametrize("case", ["gpt", "resnet", "alexnet"])
def test_each_rank_holds_what_the_leaf_rule_gives(sharded, case):
    """At mp 2 a sharded leaf holds half its elements on every rank, a
    replicated one all of them."""
    shapes = {n: t.shape for n, t in sharded["specs"][case]["state_dict"].items()}
    numels = sharded["got"][case]["local_numel"]
    assert len(numels) == WORLD
    halves = 0
    for local in numels:
        for name, n in local.items():
            whole = int(np.prod(shapes[name]))
            split = tshard.shard_dim(shapes[name], MESH["mp"]) is not None
            assert n == (whole // MESH["mp"] if split else whole), name
            halves += split
    assert halves > 0


@pytest.mark.parametrize("case, senders", [("gpt", [0, 1]), ("gpt-dp4", [0])])
def test_only_the_first_replica_sends_its_shards_to_rank_0(sharded, case, senders):
    """Gathering the state, rank 0 receives the shards of the first dp
    replica's ranks (0 .. mp-1) and nothing from the other replicas, which
    hold copies: at dp4 x mp1 its own copy alone."""
    received = sharded["got"][case]["received"]
    assert len(received) == WORLD
    assert [r for r, names in enumerate(received) if names] == senders
    assert received[0] == sorted(sharded["specs"][case]["state_dict"])


def test_group_reduces_across_every_rank(sharded):
    assert sharded["reduced"] == [float(sum(range(1, WORLD + 1)))] * 2


def test_checkpoint_saved_by_the_ranks_resumes_in_one_process(sharded):
    """Saved at dp2 x mp2 after step 1 (the file format of a one-process
    save), restored unsharded: step 2 gives the ranks' step 2."""
    tmp, spec = sharded["tmp"], sharded["specs"]["resnet"]
    ranks_dir, one_dir = tmp / "ckpt_ranks", tmp / "ckpt_one"
    assert tckpt.CheckpointManager(ranks_dir).steps() == [1]
    for name in (tckpt.PARAMS_FILE, tckpt.STATE_FILE):
        a = torch.load(ranks_dir / "1" / name, weights_only=True)
        b = torch.load(one_dir / "1" / name, weights_only=True)
        assert a.keys() == b.keys()
    losses, state = _one_process("resnet", spec["kwargs"], spec["state_dict"], spec["batch"],
                                 "images", 1, restore=ranks_dir)
    got = sharded["got"]["resnet"]
    np.testing.assert_allclose(losses, got["losses"][1:], rtol=LOSS_RTOL)
    _assert_state_close(state, got["state_dict"], "resumed in one process")


def test_one_process_checkpoint_resumes_on_the_ranks(sharded):
    """A one-process checkpoint at step 1, resharded over dp2 x mp2: the
    ranks' step 2 is the uninterrupted one-process run's."""
    one_losses, one_state = sharded["one"]
    got = sharded["got"]["resnet-resumed"]
    assert got["step"] == 2
    np.testing.assert_allclose(got["losses"], one_losses[1:], rtol=LOSS_RTOL)
    _assert_state_close(got["state_dict"], one_state, "resumed on the ranks")
