"""The port's mixture of experts (``parallel/moe.py``), its auxiliary loss
(``models/train.py``) and its dp x ep x tp step (``parallel/tensor.py``
``shard_train_step_tp``) against the JAX package's, on the CPU.

At ``GPTConfig.tiny()`` with 4 experts, float32, from flax's own init
moved over by ``convert`` and numpy batches:

- ``MoeMlp`` alone at capacity factors 4.0 (nothing dropped) and 1.0
  (drops): its output and auxiliary loss within 1e-5 of flax's, and its
  routing (each token's experts, its slot in each expert's buffer, the
  dropped assignments) the one the JAX router's probabilities imply, with
  every top-2 probability margin a round decides on above ``MARGIN`` so
  that no near tie decides a test;
- the MoE LM's logits and summed auxiliary loss within 1e-5 of flax's;
- one SGD step (lr 0.1, momentum 0.9) with ``aux_loss_coeff`` 0 and 0.1,
  and with ``grad_accum`` 2: the loss and every parameter within 1e-5 of
  the JAX ``make_train_step``'s; the router kernel moves differently with
  the auxiliary loss than without, as ``tests/test_moe.py`` requires;
- ``shard_train_step_tp`` on one spawn of four gloo ranks
  (``tests/torch_ranks.py``), running the meshes (dp1, ep2, tp2) and
  (dp2, ep2, tp1) in turn for two steps each with ``aux_loss_coeff`` 0.01:
  losses and parameters within rtol 1e-4 (the reference's bound for its
  own sharded-vs-unsharded test) of the JAX unsharded step's; a checkpoint
  saved from the sharded state after step 1 restores into an unsharded
  state that takes step 2 to the same place;
- ``tp_spec_for`` on the expert kernels with and without an ``ep`` axis,
  as ``tests/test_tensor.py``; a flax MoE tree through ``convert`` and back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.parallel import moe as jmoe
from k8s_device_plugin_tpu.parallel import tensor as jtensor
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import checkpoint as tckpt
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.parallel import moe as tmoe
from k8s_device_plugin_tpu_torch.parallel import tensor as ttensor
from tests.torch_ranks import Ranks

ATOL = 1e-5
SHARDED_RTOL = 1e-4
# A routing round is decided when its top-2 probability margin is above
# this: 10x the tolerance.
MARGIN = 1e-4
EXPERTS = 4
MESHES = {"dp1-ep2-tp2": {"dp": 1, "ep": 2, "tp": 2}, "dp2-ep2-tp1": {"dp": 2, "ep": 2, "tp": 1}}
SHARDED_AUX = 0.01


def _cfgs():
    return jtf.GPTConfig.tiny(), ttf.GPTConfig.tiny()


def _flax_lm(jcfg, cf=1.25):
    return jtf.TransformerLM(jcfg, mlp_factory=jmoe.moe_mlp_factory(jcfg, EXPERTS,
                                                                   capacity_factor=cf))


def _port_lm(pcfg, cf=1.25, train=False):
    return ttf.TransformerLM(pcfg, device="cpu", train=train,
                             mlp_factory=tmoe.moe_mlp_factory(pcfg, EXPERTS, capacity_factor=cf))


def _state_dict(params):
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


def _batch(vocab, rows=4, seq=17, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(rows, seq))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


# ------------------------------------------------------------- the layer


def _routing_from_probs(probs, k, capacity):
    """The reference's routing, read off router probabilities [g, s, e]:
    per round each token's expert, its slot and whether it was kept."""
    g, s, e = probs.shape
    remaining, fill = probs.copy(), np.zeros((g, e), np.int64)
    experts, slots, kept, margins = [], [], [], []
    for _ in range(k):
        top2 = np.sort(remaining, axis=-1)[..., -2:]
        margins.append(top2[..., 1] - top2[..., 0])
        choice = remaining.argmax(-1)
        onehot = np.eye(e)[choice]
        pos = (np.cumsum(onehot, axis=1) - onehot + fill[:, None, :])
        pos_tok = (pos * onehot).sum(-1).astype(np.int64)
        keep = pos_tok < capacity
        experts.append(choice)
        slots.append(pos_tok)
        kept.append(keep)
        fill += (onehot * keep[..., None]).sum(1).astype(np.int64)
        remaining = remaining * (1 - onehot)
    return np.stack(experts), np.stack(slots), np.stack(kept), np.stack(margins)


def _routing_from_combine(combine, k):
    """The same three from the port's combine weights [g, s, e, c]: each
    kept assignment is a non-zero (expert, slot); a token's rounds are its
    experts in order of falling weight."""
    g, s, e, c = combine.shape
    nz = combine.reshape(g, s, e * c)
    out = []
    for gi in range(g):
        for si in range(s):
            idx = np.flatnonzero(nz[gi, si])
            out.append(sorted((int(i // c), int(i % c)) for i in idx))
    return out


@pytest.mark.parametrize("cf", [4.0, 1.0], ids=["roomy", "drops"])
def test_moe_layer_output_aux_and_routing_are_the_reference_s(cf):
    jcfg, pcfg = _cfgs()
    x = np.random.RandomState(1).normal(size=(2, 32, jcfg.hidden_size)).astype(np.float32)
    layer = jmoe.MoeMlp(jcfg, num_experts=EXPERTS, capacity_factor=cf)
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    (out, inter) = layer.apply(variables, jnp.asarray(x), mutable=["intermediates"],
                               capture_intermediates=True)
    ours = tmoe.MoeMlp(pcfg, num_experts=EXPERTS, capacity_factor=cf, device="cpu")
    ours.load_state_dict(_state_dict(variables["params"]))
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
        combine, probs = ours.route(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(ours.aux_loss),
                               float(inter["intermediates"]["moe_aux_loss"][0]), rtol=0, atol=ATOL)
    logits = np.asarray(inter["intermediates"]["router"]["__call__"][0])
    jprobs = np.asarray(jax.nn.softmax(logits, axis=-1))
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=0, atol=ATOL)
    experts, slots, kept, margins = _routing_from_probs(jprobs, 2, ours.capacity(32))
    assert margins.min() > MARGIN, margins.min()
    want = [sorted((int(experts[r, gi, si]), int(slots[r, gi, si])) for r in range(2)
                   if kept[r, gi, si]) for gi in range(2) for si in range(32)]
    assert _routing_from_combine(combine.numpy(), 2) == want
    dropped = int((~kept).sum())
    assert float(ours.dropped) == dropped
    assert (dropped > 0) == (cf == 1.0)


def test_moe_lm_logits_and_aux_loss_are_the_reference_s():
    jcfg, pcfg = _cfgs()
    ids = _batch(jcfg.vocab_size)["input_ids"]
    model = _flax_lm(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    logits, inter = model.apply({"params": params}, jnp.asarray(ids), mutable=["intermediates"])
    ours = _port_lm(pcfg)
    ours.load_state_dict(_state_dict(params))
    assert {"layer_0.moe.router.kernel", "layer_0.moe.experts_gate", "layer_0.moe.experts_up",
            "layer_0.moe.experts_down"} <= set(ours.state_dict())
    assert not any(".mlp." in name for name in ours.state_dict())
    got = ours(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(ttrain.sown_aux_loss(ours)),
                               float(jtrain.sown_aux_loss(inter["intermediates"])), rtol=0,
                               atol=ATOL)


def test_lora_serve_is_refused_with_mlp_factory():
    pcfg = dataclasses.replace(ttf.GPTConfig.tiny(), lora_rank=4, lora_serve=2)
    with pytest.raises(ValueError, match="lora_serve is not supported with mlp_factory"):
        _port_lm(pcfg)


# ------------------------------------------------------------ the step


def _jax_steps(jcfg, params, batch, coeff, steps, grad_accum=1):
    model = _flax_lm(jcfg)
    tx = optax.sgd(0.1, 0.9)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={})
    step = jax.jit(jtrain.make_train_step(model, tx, input_key="input_ids",
                                          aux_loss_coeff=coeff, grad_accum=grad_accum))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, _state_dict(state.params)


@pytest.fixture(scope="module")
def lm():
    jcfg, pcfg = _cfgs()
    batch = _batch(jcfg.vocab_size)
    params = _flax_lm(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]))["params"]
    return jcfg, pcfg, params, batch


@pytest.mark.parametrize("coeff, grad_accum", [(0.0, 1), (0.1, 1), (0.1, 2)],
                         ids=["plain", "aux", "aux-accum2"])
def test_train_step_with_and_without_aux_loss_is_the_reference_s(lm, coeff, grad_accum):
    jcfg, pcfg, params, batch = lm
    want_losses, want = _jax_steps(jcfg, params, batch, coeff, 1, grad_accum)
    state = ttrain.state_for(_port_lm(pcfg, train=True), 0.1, 0.9)
    state.model.load_state_dict(_state_dict(params))
    step = ttrain.make_train_step(coeff, grad_accum=grad_accum)
    state, loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), want_losses[0], rtol=0, atol=ATOL)
    got = dict(state.model.named_parameters())
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_aux_loss_changes_the_router_step(lm):
    _, pcfg, params, batch = lm
    routers = []
    for coeff in (0.0, 0.1):
        state = ttrain.state_for(_port_lm(pcfg, train=True), 0.1, 0.0)
        state.model.load_state_dict(_state_dict(params))
        ttrain.make_train_step(coeff)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        routers.append(state.model.layer_0.moe.router.kernel.detach().clone())
    assert not torch.allclose(routers[0], routers[1])
    assert float(ttrain.sown_aux_loss(torch.nn.Linear(2, 2))) == 0.0


# ------------------------------------------------- four ranks, one spawn


@pytest.fixture(scope="module")
def sharded(lm, tmp_path_factory):
    """Rank 0's results of both meshes, and the JAX unsharded steps."""
    jcfg, pcfg, params, batch = lm
    tmp = tmp_path_factory.mktemp("moe_ranks")
    kwargs = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    kwargs["experts"] = EXPERTS
    state = _state_dict(params)
    cases = []
    for name, mesh in MESHES.items():
        cases.append({"name": name, "kind": "moe", "kwargs": kwargs, "state_dict": state,
                      "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                      "input_key": "input_ids", "steps": 2, "mesh": mesh, "tp": True,
                      "aux_loss_coeff": SHARDED_AUX, "save_at": 1,
                      "save_dir": str(tmp / f"ckpt-{name}")})
    spec = {"cases": cases, "mesh": MESHES["dp1-ep2-tp2"]}
    results = Ranks(spec, 4, str(tmp)).wait()["cases"]
    want = _jax_steps(jcfg, params, batch, SHARDED_AUX, 2)
    return dict(zip(MESHES, results)), want, cases


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_steps_are_the_reference_unsharded_step_s(sharded, mesh):
    results, (want_losses, want), _ = sharded
    got = results[mesh]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=SHARDED_RTOL)
    assert set(got["state_dict"]) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got["state_dict"][name].numpy(), value.numpy(),
                                   rtol=SHARDED_RTOL, atol=1e-6, err_msg=name)
    sizes = MESHES[mesh]
    # Each rank held its chunk: the experts over ep, their ffn over tp.
    local = got["local_numel"][0]
    full = np.prod(want["layer_0.moe.experts_gate"].shape)
    assert local["layer_0.moe.experts_gate"] * sizes["ep"] * sizes["tp"] == full
    assert local["layer_0.moe.router.kernel"] == np.prod(want["layer_0.moe.router.kernel"].shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_checkpoint_restores_unsharded_and_continues(lm, sharded, mesh):
    _, (want_losses, want), cases = sharded
    case = next(c for c in cases if c["name"] == mesh)
    _, pcfg, _, batch = lm
    state = ttrain.state_for(_port_lm(pcfg, train=True), 0.1, 0.9)
    state = tckpt.CheckpointManager(case["save_dir"]).restore(state)
    assert state.step == 1
    step = ttrain.make_train_step(SHARDED_AUX)
    state, loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), want_losses[1], rtol=SHARDED_RTOL)
    got = dict(state.model.named_parameters())
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   rtol=SHARDED_RTOL, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- rules


def test_expert_kernel_specs_with_and_without_ep_are_the_reference_s():
    class Leaf:
        def __init__(self, shape):
            self.shape, self.ndim = shape, len(shape)

    for name, shape in (("layer_1.moe.experts_gate", (8, 64, 128)),
                        ("layer_1.moe.experts_up", (8, 64, 128)),
                        ("layer_1.moe.experts_down", (8, 128, 64)),
                        ("layer_1.moe.router.kernel", (64, 8))):
        for sizes in ({"dp": 2, "tp": 2}, {"dp": 2, "tp": 2, "ep": 2}, {"ep": 3, "tp": 2}):
            want = tuple(jtensor.tp_spec_for(name.replace(".", "/"), Leaf(shape), sizes))
            assert ttensor.tp_spec_for(name, shape, sizes) == want, (name, sizes)
    with_ep = {"dp": 2, "tp": 2, "ep": 2}
    assert ttensor.tp_spec_for("layer_1.moe.experts_gate", (8, 64, 128), with_ep) == tuple(
        P("ep", None, "tp"))
    assert ttensor.tp_spec_for("layer_1.moe.experts_gate", (8, 64, 128), {"tp": 2}) == ()


def test_flax_moe_tree_converts_both_ways(lm):
    _, _, params, _ = lm
    tree = jax.tree_util.tree_map(np.asarray, params)
    state = convert.flax_to_state_dict(tree)
    assert state["layer_1.moe.experts_down"].shape == (EXPERTS, 128, 64)
    assert state["layer_1.moe.router.kernel"].shape == (64, EXPERTS)
    back = convert.state_dict_to_flax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
