"""The port's pipeline parallelism (``parallel/pipeline.py``,
``pipeline_1f1b.py``, ``pipeline_lm.py``) against the JAX package's.

One spawn of four gloo ranks for the module (``tests/torch_ranks.py``, a
``pipeline`` spec) runs every multi-rank case, held against the JAX
package on 4 of conftest's 8 virtual CPU devices, from the same numpy
inputs and, for the LM, the same flax init (moved over by
``convert.pipelined_flax_to_state_dict``):

- the residual toy stage of ``tests/test_pipeline.py`` (x + tanh(x @ w +
  b), d 8): ``pipeline_apply`` at pp 4 and at (dp 2, pp 2) against JAX's
  and the serial chain, and ``pipelined_loss_fn``'s gradient at pp 4
  against ``jax.grad`` of JAX's;
- the tanh stage of ``tests/test_pipeline_1f1b.py`` (d 8, b 2):
  ``pipeline_1f1b_grads`` at its (L, n_micro) set, L 2 over (dp 2, pp 2)
  and L 4 over pp 4; the buffer depth at (4, 23); ``pipeline_1f1b_train``
  with a head and the input gradients;
- ``PipelinedLM`` at ``GPTConfig.tiny()`` over (dp 2, pp 2), n_micro 4:
  ``apply`` and ``apply_serial`` against JAX's, one SGD-momentum step
  (lr 0.1, 0.9) of GPipe, of 1F1B and of GPipe under remat against JAX's,
  with their point-to-point calls counted; the layer-count error at pp 4.

In this process, over a gloo group of one (a ``HashStore``): the LM at pp
1 (no point-to-point call), and the lead-dim, batch-split and schedule
errors against the reference's text.

Tolerances (float32): the toys as the JAX tests (forward and GPipe
gradient atol 1e-5; 1F1B loss rtol 1e-5 / atol 1e-6, gradients rtol 1e-4
/ atol 1e-5); the LM's logits atol 1e-5, its losses rtol 1e-5 and every
parameter atol 1e-5 (``tests/test_torch_sequence.py``'s bounds).  The
ranks sum in another order than XLA (~1e-7).  No tokens are compared.
"""

import dataclasses
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.parallel import pipeline as jpipe
from k8s_device_plugin_tpu.parallel import pipeline_1f1b as j1f1b
from k8s_device_plugin_tpu.parallel import pipeline_lm as jlm
from k8s_device_plugin_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.parallel import pipeline as tpipe
from k8s_device_plugin_tpu_torch.parallel import pipeline_1f1b as t1f1b
from k8s_device_plugin_tpu_torch.parallel import pipeline_lm as tlm
from tests.torch_ranks import Ranks

WORLD = 4
ATOL = 1e-5
LOSS_RTOL = 1e-5
D = 8
APPLY_MESHES = {"pp4": {"pp": 4}, "dp2-pp2": {"dp": 2, "pp": 2}}
ONE_F_ONE_B = [(2, 5), (4, 6), (2, 1), (4, 3), (4, 10)]
LM_BATCH, LM_SEQ, N_MICRO = 8, 16, 4
# name: (schedule, remat)
LM_STEPS = {"gpipe": ("gpipe", False), "1f1b": ("1f1b", False), "gpipe-remat": ("gpipe", True)}
# Point-to-point calls a rank makes in one step at pp 2, n_micro 4: GPipe
# sends or receives at 4 forward and 4 backward ticks; 1F1B at ticks 0-5.
LM_P2P = {"gpipe": 8, "1f1b": 6}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _toy(n_stages, d, seed, scale):
    rs = np.random.RandomState(seed)
    return {"w": (rs.randn(n_stages, d, d) * scale).astype(np.float32),
            "b": (rs.randn(n_stages, d) * 0.1).astype(np.float32)}


def _normal(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax_residual(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _jax_tanh(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _serial(stacked, micro):
    y = micro
    for s in range(stacked["w"].shape[0]):
        y = y + np.tanh(y @ stacked["w"][s] + stacked["b"][s])
    return y


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _lm_batch(vocab, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(LM_BATCH, LM_SEQ + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32), "labels": ids[:, 1:].astype(np.int32)}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_lm(n_stages, remat=False):
    cfg = dataclasses.replace(jtf.GPTConfig.tiny(), remat=remat)
    return jlm.PipelinedLM(cfg, jmake_mesh({"pp": n_stages}, devices=jax.devices()[:n_stages]),
                           n_micro=N_MICRO)


def _jax_lm_init(plm, batch):
    return _np(plm.init(jax.random.PRNGKey(1), jnp.asarray(batch["input_ids"][:2])))


def _jax_lm_step(plm, params, batch, schedule):
    tx = optax.sgd(0.1, momentum=0.9)
    state = plm.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, loss = jax.jit(plm.make_train_step(tx, schedule=schedule))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), convert.pipelined_flax_to_state_dict(_np(state.params))


# --------------------------------------------------------------- four ranks


def _cases():
    """The spawn's cases, and the LM's flax weights and batch."""
    cases = []
    micro, stacked = _normal((6, 4, D), 1), _toy(4, D, 0, 0.3)
    for name, axes in APPLY_MESHES.items():
        n = axes["pp"]
        cases.append({"name": f"apply-{name}", "op": "apply", "mesh": axes, "stage": "residual",
                      "stacked": _torch(_toy(n, D, 0, 0.3)), "micro": torch.from_numpy(micro)})
    targets = _normal((6, 4, D), 2)
    cases.append({"name": "loss_grad", "op": "loss_grad", "mesh": {"pp": 4}, "stage": "residual",
                  "stacked": _torch(stacked), "micro": torch.from_numpy(micro),
                  "targets": torch.from_numpy(targets)})
    for n_stages, n_micro in ONE_F_ONE_B + [(4, 23)]:
        d, b = (4, 1) if n_micro == 23 else (D, 2)
        axes = {"pp": 4} if n_stages == 4 else {"dp": 2, "pp": 2}
        cases.append({"name": f"1f1b-{n_stages}-{n_micro}", "op": "1f1b", "mesh": axes,
                      "stage": "tanh", "stacked": _torch(_toy(n_stages, d, 3, d ** -0.5)),
                      "micro": torch.from_numpy(_normal((n_micro, b, d), 4)),
                      "targets": torch.from_numpy(_normal((n_micro, b, d), 5))})
    cases.append({"name": "1f1b-head", "op": "1f1b", "mesh": {"pp": 4}, "stage": "tanh",
                  "stacked": _torch(_toy(4, D, 3, D ** -0.5)),
                  "micro": torch.from_numpy(_normal((6, 2, D), 4)),
                  "targets": torch.from_numpy(_normal((6, 2, 3), 6)),
                  "head": {"w": torch.from_numpy(_normal((D, 3), 7))}})
    tcfg = ttf.GPTConfig.tiny()
    batch = _lm_batch(tcfg.vocab_size)
    params = _jax_lm_init(_jax_lm(2), batch)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    for name, (schedule, remat) in LM_STEPS.items():
        cfg = dataclasses.replace(tcfg, remat=remat)
        cases.append({"name": f"lm-{name}", "op": "lm", "mesh": {"dp": 2, "pp": 2},
                      "cfg": _fields(cfg), "n_micro": N_MICRO, "batch": tb,
                      "state_dict": convert.pipelined_flax_to_state_dict(params),
                      "schedule": schedule})
    cases.append({"name": "lm-layers", "op": "lm_error", "mesh": {"pp": 4},
                  "cfg": _fields(tcfg)})
    return cases, (params, batch)


def _jax_wants(params, batch) -> dict:
    want = {}
    micro, targets = _normal((6, 4, D), 1), _normal((6, 4, D), 2)
    for name, axes in APPLY_MESHES.items():
        n = axes["pp"]
        stacked = _toy(n, D, 0, 0.3)
        mesh = jmake_mesh(axes, devices=jax.devices()[:WORLD])
        want[f"apply-{name}"] = (np.asarray(jpipe.pipeline_apply(_jax_residual, stacked, micro,
                                                                 mesh)), _serial(stacked, micro))
    loss, grads = jax.jit(jax.value_and_grad(
        jpipe.pipelined_loss_fn(_jax_residual, _jax_mesh(4)), argnums=(0, 1)))(
        _toy(4, D, 0, 0.3), jnp.asarray(micro), jnp.asarray(targets))
    want["loss_grad"] = (float(loss), _np(grads[0]), np.asarray(grads[1]))
    for n_stages, n_micro in ONE_F_ONE_B + [(4, 23)]:
        d, b = (4, 1) if n_micro == 23 else (D, 2)
        loss, grads = j1f1b.pipeline_1f1b_grads(
            _jax_tanh, _toy(n_stages, d, 3, d ** -0.5), _normal((n_micro, b, d), 4),
            _normal((n_micro, b, d), 5), _jax_mesh(n_stages))
        want[f"1f1b-{n_stages}-{n_micro}"] = (float(loss), _np(grads))
    loss, grads, head_grads, d_micro = j1f1b.pipeline_1f1b_train(
        _jax_tanh, _toy(4, D, 3, D ** -0.5), _normal((6, 2, D), 4), _normal((6, 2, 3), 6),
        _jax_mesh(4), head_fn=lambda p, y: y @ p["w"], head_params={"w": _normal((D, 3), 7)})
    want["1f1b-head"] = (float(loss), _np(grads), _np(head_grads), np.asarray(d_micro))
    plm, ids = _jax_lm(2), jnp.asarray(batch["input_ids"])
    want["lm-apply"] = (np.asarray(jax.jit(plm.apply)(params, ids)),
                        np.asarray(jax.jit(plm.apply_serial)(params, ids)))
    for name, (schedule, remat) in LM_STEPS.items():
        want[f"lm-{name}"] = _jax_lm_step(_jax_lm(2, remat), params, batch, schedule)
    with pytest.raises(ValueError) as err:
        jlm.PipelinedLM(jtf.GPTConfig.tiny(), _jax_mesh(4), n_micro=2)
    want["lm-layers"] = str(err.value)
    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of every case, and the JAX package's."""
    cases, (params, batch) = _cases()
    running = Ranks({"pipeline": {"cases": cases}}, WORLD, str(tmp_path_factory.mktemp("pp")))
    want = _jax_wants(params, batch)
    return {"got": running.wait(), "want": want}


def _by_stage(results: list, key: str) -> list:
    """Each stage's ``key`` from the first replica's ranks, in stage order."""
    first = sorted((r for r in results if r["coords"].get("dp", 0) == 0),
                   key=lambda r: r["coords"]["pp"])
    return [r[key] for r in first]


def _replicas_agree(results: list, key: str) -> None:
    """The dp replicas computed the same thing, stage by stage."""
    for r in results:
        twin = next(o for o in results if o["coords"]["pp"] == r["coords"]["pp"]
                    and o["coords"].get("dp", 0) == 0)
        for a, b in zip(jax.tree_util.tree_leaves(r[key]), jax.tree_util.tree_leaves(twin[key])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", list(APPLY_MESHES))
def test_pipeline_apply_is_the_reference_s(ranks, mesh):
    """Every rank returns the last stage's outputs: JAX's and the serial
    chain's; other mesh axes replicate."""
    jax_out, serial = ranks["want"][f"apply-{mesh}"]
    for result in ranks["got"][f"apply-{mesh}"]:
        np.testing.assert_allclose(result["y"].numpy(), jax_out, rtol=0, atol=ATOL)
        np.testing.assert_allclose(result["y"].numpy(), serial, rtol=0, atol=ATOL)


def test_pipelined_loss_gradient_is_jax_grad(ranks):
    """Each rank's stage gets its slice of ``jax.grad``'s (zeros in the
    other slices); the microbatches' gradient is on every rank."""
    loss, grads, d_micro = ranks["want"]["loss_grad"]
    results = ranks["got"]["loss_grad"]
    for r in results:
        stage = r["coords"]["pp"]
        np.testing.assert_allclose(r["loss"], loss, rtol=LOSS_RTOL)
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k][stage].numpy(), g[stage], rtol=0, atol=ATOL)
            others = [s for s in range(4) if s != stage]
            assert not r["grads"][k][others].any()
        np.testing.assert_allclose(r["d_micro"].numpy(), d_micro, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_stages,n_micro", ONE_F_ONE_B)
def test_1f1b_grads_are_the_reference_s(ranks, n_stages, n_micro):
    loss, grads = ranks["want"][f"1f1b-{n_stages}-{n_micro}"]
    results = ranks["got"][f"1f1b-{n_stages}-{n_micro}"]
    _replicas_agree(results, "grads")
    for r in results:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5, atol=1e-6)
    for stage, got in enumerate(_by_stage(results, "grads")):
        for k, g in grads.items():
            np.testing.assert_allclose(got[k].numpy(), g[stage], rtol=1e-4, atol=1e-5)
    depth = t1f1b.residual_buffer_depth(n_micro, n_stages)
    assert all(r["stats"]["buffer_depth"] == depth for r in results)
    assert max(r["stats"]["buffer_peak"] for r in results) == depth


def test_1f1b_residual_buffer_is_microbatch_independent(ranks):
    """At L 4 and 23 microbatches every stage stores at most 7 inputs (the
    first stage all 7 at once), and the loss is the reference's."""
    assert t1f1b.residual_buffer_depth(100, 4) == 7
    assert t1f1b.residual_buffer_depth(3, 4) == 3
    loss, grads = ranks["want"]["1f1b-4-23"]
    results = ranks["got"]["1f1b-4-23"]
    assert [r["stats"]["buffer_depth"] for r in results] == [7] * 4
    peaks = _by_stage(results, "stats")
    assert peaks[0]["buffer_peak"] == 7 and all(p["buffer_peak"] <= 7 for p in peaks)
    for r in results:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5, atol=1e-6)
    for stage, got in enumerate(_by_stage(results, "grads")):
        for k, g in grads.items():
            np.testing.assert_allclose(got[k].numpy(), g[stage], rtol=1e-4, atol=1e-5)


def test_1f1b_train_with_a_head_is_the_reference_s(ranks):
    """Loss, stage gradients, the head's (scaled by 1 / n_micro) and the
    microbatches' gradient, the last three on every rank."""
    loss, grads, head_grads, d_micro = ranks["want"]["1f1b-head"]
    results = ranks["got"]["1f1b-head"]
    for r in results:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["head_grads"]["w"].numpy(), head_grads["w"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["d_micro"].numpy(), d_micro, rtol=1e-4, atol=1e-5)
    for stage, got in enumerate(_by_stage(results, "grads")):
        for k, g in grads.items():
            np.testing.assert_allclose(got[k].numpy(), g[stage], rtol=1e-4, atol=1e-5)


def test_pipelined_lm_apply_is_the_reference_s(ranks):
    """Logits on every rank of both replicas: JAX's ``apply`` and
    ``apply_serial``."""
    apply, serial = ranks["want"]["lm-apply"]
    for r in ranks["got"]["lm-gpipe"]:
        assert r["apply"].shape == (LM_BATCH, LM_SEQ, ttf.GPTConfig.tiny().vocab_size)
        np.testing.assert_allclose(r["apply"].numpy(), apply, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["apply_serial"].numpy(), serial, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(LM_STEPS))
def test_pipelined_lm_step_is_the_reference_s(ranks, name):
    """One SGD-momentum step: every rank's loss, and the stages' gathered
    parameters, as the JAX package's step of the same schedule; each rank
    made the schedule's point-to-point calls on its CPU tensors."""
    schedule = LM_STEPS[name][0]
    want_loss, want_state = ranks["want"][f"lm-{name}"]
    results = ranks["got"][f"lm-{name}"]
    for r in results:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
        assert r["calls"] == {"p2p": LM_P2P[schedule], "host_staged": 0, "broadcast": 1}
    got = {}
    for state in _by_stage(results, "state_dict"):
        got.update(state)
    assert set(got) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=ATOL, err_msg=k)


def test_layer_count_error_is_the_reference_s(ranks):
    assert [r["error"] for r in ranks["got"]["lm-layers"]] == [ranks["want"]["lm-layers"]] * 4


# ------------------------------------------------------ a gloo group of one


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one in this process and its pp mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    dist = torch.distributed
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        yield DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("pp",))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def lm_pp1():
    """The JAX package's PipelinedLM at pp 1: its weights, batch, logits and
    one step of each schedule."""
    plm = _jax_lm(1)
    batch = _lm_batch(plm.config.vocab_size, seed=1)
    params = _jax_lm_init(plm, batch)
    ids = jnp.asarray(batch["input_ids"])
    return {"params": params, "batch": batch, "apply": np.asarray(jax.jit(plm.apply)(params, ids)),
            "steps": {s: _jax_lm_step(plm, params, batch, s) for s in ("gpipe", "1f1b")}}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp1_lm_is_the_reference_s(world_of_one, lm_pp1, schedule):
    """A stage of one holds the whole LM: the reference's logits and step,
    and no point-to-point call or broadcast."""
    plm = tlm.PipelinedLM(ttf.GPTConfig.tiny(), world_of_one, N_MICRO, device="cpu")
    plm.load_state_dict(convert.pipelined_flax_to_state_dict(lm_pp1["params"], stage=0))
    batch = {k: torch.from_numpy(v).long() for k, v in lm_pp1["batch"].items()}
    np.testing.assert_allclose(plm.apply(batch["input_ids"]).numpy(), lm_pp1["apply"], rtol=0,
                               atol=ATOL)
    state, loss = plm.make_train_step(schedule)(plm.create_train_state(0.1, 0.9), batch)
    want_loss, want_state = lm_pp1["steps"][schedule]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = plm.state_dict()
    assert set(got) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=ATOL, err_msg=k)
    assert state.step == 1 and dict(plm.pp.calls) == {}


@pytest.mark.parametrize("which", ["apply", "1f1b"])
def test_lead_dim_errors_are_the_reference_s(world_of_one, which):
    """Three stages stacked (``stack_stage_params``, each stage's slice
    back by ``stage_params``) for a group of one."""
    stacked = _toy(3, 4, 0, 0.3)
    tstacked = tpipe.stack_stage_params([tpipe.stage_params(_torch(stacked), s)
                                         for s in range(3)])
    assert all(torch.equal(tstacked[k], torch.from_numpy(v)) for k, v in stacked.items())
    micro = np.zeros((2, 1, 4), np.float32)
    if which == "apply":
        ref = lambda: jpipe.pipeline_apply(_jax_residual, stacked, micro, _jax_mesh(1))
        port = lambda: tpipe.pipeline_apply(lambda p, x: x, tstacked, torch.from_numpy(micro),
                                            world_of_one)
    else:
        ref = lambda: j1f1b.pipeline_1f1b_grads(_jax_tanh, stacked, micro, micro, _jax_mesh(1))
        port = lambda: t1f1b.pipeline_1f1b_grads(lambda p, x: x, tstacked,
                                                 torch.from_numpy(micro),
                                                 torch.from_numpy(micro), world_of_one)
    with pytest.raises(ValueError, match="lead dim") as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)


def test_batch_split_and_schedule_errors_are_the_reference_s(world_of_one):
    cfg = jtf.GPTConfig.tiny()
    jplm = jlm.PipelinedLM(cfg, _jax_mesh(1), n_micro=3)
    params = _np(jplm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32)))
    with pytest.raises(ValueError, match="n_micro") as want_split:
        jplm.apply(params, jnp.zeros((8, 8), jnp.int32))
    with pytest.raises(ValueError, match="schedule") as want_schedule:
        jplm.make_train_step(optax.sgd(0.1), schedule="zb-h1")
    plm = tlm.PipelinedLM(ttf.GPTConfig.tiny(), world_of_one, 3, device="cpu")
    plm.load_state_dict(convert.pipelined_flax_to_state_dict(params))
    with pytest.raises(ValueError) as got_split:
        plm.apply(torch.zeros((8, 8), dtype=torch.long))
    with pytest.raises(ValueError) as got_schedule:
        plm.make_train_step(schedule="zb-h1")
    assert str(got_split.value) == str(want_split.value)
    assert str(got_schedule.value) == str(want_schedule.value)


def test_pipelined_lm_raises_without_a_card():
    """The stage runs on the card unless the CPU is asked for; without one
    it raises before it joins anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.PipelinedLM(ttf.GPTConfig.tiny(), None, N_MICRO)


# ---------------------------------------------------------------- converter


def test_converter_maps_stage_blocks_to_lm_layers():
    """A flax PipelinedLM tree at pp 2 (2 blocks a stage): stage s's block_i
    is the LM's layer_{2s+i}, the unsharded LM loads the whole map, each
    stage takes its share, and the ranks' states gather back to the tree."""
    cfg = dataclasses.replace(jtf.GPTConfig.tiny(), num_layers=4)
    plm = jlm.PipelinedLM(cfg, _jax_mesh(2), n_micro=2)
    tree = _np(plm.init(jax.random.PRNGKey(3), jnp.zeros((2, 8), jnp.int32)))
    flat = convert.pipelined_flax_to_state_dict(tree)
    tcfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_layers=4)
    ttf.TransformerLM(tcfg, device="cpu").load_state_dict(flat)
    for s in range(2):
        for i in range(2):
            np.testing.assert_array_equal(
                flat[f"layer_{2 * s + i}.attn.query.kernel"].numpy(),
                tree["stages"][f"block_{i}"]["attn"]["query"]["kernel"][s])
    shares = [convert.pipelined_flax_to_state_dict(tree, stage=s) for s in range(2)]
    assert set(shares[0]) == {"embed.embedding"} | {k for k in flat if k.startswith(("layer_0.",
                                                                                      "layer_1."))}
    assert "lm_head.kernel" in shares[1] and "final_norm.scale" in shares[1]
    assert set(shares[0]) | set(shares[1]) == set(flat) and not set(shares[0]) & set(shares[1])
    back = convert.pipelined_state_dicts_to_flax(shares)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
