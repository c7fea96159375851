"""The port's sequence parallelism (``parallel/ring.py``, ``ulysses.py``,
``sequence.py`` and the LM's ``attention_fn`` hook) against the JAX
package's.

The sharded steps run in one group of 4 gloo ranks for the whole module
(``tests/torch_ranks.py``, ``kind: "sp"``), and are held against the JAX
package's ``shard_train_step_sp`` at the same mesh over 4 of conftest's 8
virtual CPU devices, from the same flax init (moved over by ``convert``)
and the same numpy batch (4 x 16 tokens of ``GPTConfig.tiny()``), two
SGD-momentum steps (lr 0.1, 0.9):

- (dp 2, sp 2) Ulysses;
- (dp 1, sp 4) ring with 2 kv heads (``__graft_entry__.py``'s ring case:
  the rotating kv shard stays at 2 heads);
- (dp 1, sp 4) Ulysses with 2 kv heads, which sp does not divide (kv is
  expanded before the all-to-all);
- (dp 1, sp 2, tp 2) ring, sequence and tensor parallel at once;
- (dp 1, sp 4) ring with 2 kv heads again under ``remat``: each block,
  its exchanges included, recomputed in the backward on every rank.

Tolerances (float32), as ``tests/test_torch_parallel.py``: losses 1e-5
relative, every parameter 1e-5 absolute; the ranks sum in another order
(~1e-7).  No tokens are compared, so no top-2 margin is asserted.

In this process: the errors the reference raises, RoPE positions at a
rank's sequence offset, the hook's parameters, and over a gloo group of
one the (1, 1) step against the unsharded one (Ulysses bit for bit) and
each engine against the reference's at sp 1.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.parallel import mesh as jmesh
from k8s_device_plugin_tpu.parallel import ring as jring
from k8s_device_plugin_tpu.parallel import sequence as jseq
from k8s_device_plugin_tpu.parallel import ulysses as jul
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.ops.flash_attention import mha_reference
from k8s_device_plugin_tpu_torch.parallel import ring as tring
from k8s_device_plugin_tpu_torch.parallel import sequence as tseq
from k8s_device_plugin_tpu_torch.parallel import ulysses as tul
from tests.torch_ranks import Ranks

LOSS_RTOL = 1e-5
ATOL = 1e-5
WORLD = 4
BATCH, SEQ = 4, 16
# name: (mesh, engine, kv heads, remat)
CASES = {
    "ulysses-dp2-sp2": ({"dp": 2, "sp": 2}, "ulysses", None, False),
    "ring-sp4-gqa": ({"dp": 1, "sp": 4}, "ring", 2, False),
    "ulysses-sp4-gqa-expand": ({"dp": 1, "sp": 4}, "ulysses", 2, False),
    "ring-sp2-tp2": ({"dp": 1, "sp": 2, "tp": 2}, "ring", None, False),
    "ring-sp4-gqa-remat": ({"dp": 1, "sp": 4}, "ring", 2, True),
}


def _configs(kv_heads, remat=False):
    """The JAX and the port's tiny config with ``kv_heads`` (None: MHA)."""
    return (dataclasses.replace(jtf.GPTConfig.tiny(), num_kv_heads=kv_heads, remat=remat),
            dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=kv_heads, remat=remat))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(vocab, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _init(cfg):
    return _np(jax.jit(jtf.TransformerLM(cfg).init)(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 8), jnp.int32)))


def _jax_sp_steps(cfg, variables, batch, axes, kind, steps=2):
    """The JAX package's dp x sp (x tp) step at ``axes`` over 4 devices."""
    tx = optax.sgd(0.1, momentum=0.9)
    mesh = jmesh.make_mesh(axes, devices=jax.devices()[:WORLD])
    model = jtf.TransformerLM(cfg, attention_fn=jseq.sp_attention_fn(mesh, kind=kind))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step, state, batch_sh = jseq.shard_train_step_sp(
        jtrain.make_train_step(model, tx, input_key="input_ids"), mesh, state, jb)
    jb = jax.device_put(jb, batch_sh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, jb)
        losses.append(float(loss))
    return losses, convert.flax_to_state_dict(_np(state.params))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Rank 0's results of every case and the JAX package's."""
    tmp = tmp_path_factory.mktemp("sp_ranks")
    specs, jax_cases = [], {}
    for name, (axes, kind, kv, remat) in CASES.items():
        jcfg, tcfg = _configs(kv, remat)
        variables = _init(jcfg)
        batch = _tokens(jcfg.vocab_size)
        specs.append({"name": name, "kind": "sp", "sp_kind": kind, "kwargs": _fields(tcfg),
                      "state_dict": convert.flax_to_state_dict(variables["params"]),
                      "batch": _torch_batch(batch), "input_key": "input_ids", "steps": 2,
                      "mesh": axes})
        jax_cases[name] = (jcfg, variables, batch, axes, kind)
    running = Ranks({"mesh": CASES["ring-sp4-gqa"][0], "cases": specs}, WORLD, str(tmp))
    want = {name: _jax_sp_steps(*case) for name, case in jax_cases.items()}
    ranks = running.wait()
    got = {spec["name"]: result for spec, result in zip(specs, ranks["cases"])}
    return {"got": got, "want": want}


@pytest.mark.parametrize("case", list(CASES))
def test_sp_step_is_the_reference_s(sharded, case):
    """Two steps: the global batch's losses and every parameter, as the
    JAX package's ``shard_train_step_sp`` at the same mesh; the engine's
    exchanges ran on the ranks."""
    got, (want_losses, want_state) = sharded["got"][case], sharded["want"][case]
    assert got["step"] == 2
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert set(got["state_dict"]) == set(want_state)
    for name, value in want_state.items():
        np.testing.assert_allclose(got["state_dict"][name].numpy(), np.asarray(value), rtol=0,
                                   atol=ATOL, err_msg=f"{case}: {name}")
    axes, kind, _, remat = CASES[case]
    layers, steps = jtf.GPTConfig.tiny().num_layers, 2
    if kind == "ring":
        # sp - 1 hops a layer forward (again under remat) and backward, each
        # step: the hop after the last block is not made.
        hops = (axes["sp"] - 1) * (3 if remat else 2)
        assert got["sp_calls"]["ring_shift"] == layers * steps * hops
    else:
        # q, k, v and the output forward; each one's gradient backward.
        assert got["sp_calls"]["all_to_all"] == layers * steps * 8
    assert got["sp_calls"].get("host_staged", 0) == 0  # CPU tensors exchange as they are


# ------------------------------------------------------------ one process


def test_sp_unknown_kind_raises():
    with pytest.raises(ValueError) as want:
        jseq.sp_attention_fn(jmesh.make_mesh({"sp": 8}), kind="nope")
    with pytest.raises(ValueError) as got:
        tseq.sp_attention_fn(None, kind="nope")
    assert str(got.value) == str(want.value)


def _fake_sp(size, rank=0):
    """A group's size and rank alone: enough for what is checked before
    any exchange."""
    return types.SimpleNamespace(size=size, rank=rank, axis="sp")


def _sp_attention(kind, sp, engine=None):
    attn = tseq.SequenceParallelAttention(kind, sp)
    if engine is not None:
        attn.engine = engine
    return attn


def test_window_incompatible_with_attention_fn():
    """The reference's error (``tests/test_window.py``), at the port's
    forward."""
    jcfg = dataclasses.replace(jtf.GPTConfig.tiny(), attention_window=4)
    mesh = jmesh.make_mesh({"sp": 2}, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jtf.TransformerLM(jcfg, attention_fn=jseq.sp_attention_fn(mesh)).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))
    tcfg = dataclasses.replace(ttf.GPTConfig.tiny(), attention_window=4)
    model = ttf.TransformerLM(tcfg, device="cpu", attention_fn=_sp_attention("ulysses",
                                                                             _fake_sp(2)))
    with pytest.raises(ValueError) as got:
        model(torch.zeros((2, 8), dtype=torch.long))
    assert str(got.value) == str(want.value)


def _qkv(heads, kv_heads, seq, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, h, seq, 16).astype(np.float32) for h in (heads, kv_heads, kv_heads)]


@pytest.mark.parametrize("engine, heads, kv_heads, sp", [
    ("ring", 4, 3, 2), ("ulysses", 4, 3, 2), ("ulysses", 4, 4, 3),
], ids=["ring-kv", "ulysses-kv", "ulysses-heads"])
def test_engine_shape_errors_are_the_reference_s(engine, heads, kv_heads, sp):
    """The same error for the same heads: q heads that are not a multiple
    of kv heads, and heads that sp does not divide (the reference's
    wrapper says "local heads", the per-rank body "heads")."""
    seq = 4 * sp
    q, k, v = _qkv(heads, kv_heads, seq)
    mesh = jmesh.make_mesh({"sp": sp}, devices=jax.devices()[:sp])
    ref = {"ring": jring.ring_self_attention, "ulysses": jul.ulysses_self_attention}[engine]
    with pytest.raises(ValueError) as want:
        ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, causal=True)
    port = {"ring": tring.ring_attention, "ulysses": tul.ulysses_attention}[engine]
    local = [torch.from_numpy(t[:, :, :4]) for t in (q, k, v)]
    with pytest.raises(ValueError) as got:
        port(*local, _fake_sp(sp), causal=True)
    assert str(want.value).endswith(str(got.value)), (str(got.value), str(want.value))


def test_sequence_split_error_is_the_reference_s():
    q, k, v = (jnp.asarray(t) for t in _qkv(4, 4, 10))
    mesh = jmesh.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    for ref in (jring.ring_self_attention, jul.ulysses_self_attention):
        with pytest.raises(ValueError) as want:
            ref(q, k, v, mesh, causal=True)
        with pytest.raises(ValueError) as got:
            tseq.sequence_columns(10, 0, 4)
        assert str(got.value) == str(want.value)
    assert [tseq.sequence_columns(16, i, 4) for i in range(4)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]


def test_rank_rope_positions_carry_its_sequence_offset():
    """Rank 1 of 2 holds tokens 8..15: its first layer's q and k are the
    unsharded model's at those positions (the engine replaced by one that
    records them and attends locally)."""
    cfg = ttf.GPTConfig.tiny()
    params = ttf.init_params(cfg, 0)
    ids = torch.from_numpy(_tokens(cfg.vocab_size)["input_ids"]).long()

    def run(rank, size, tokens):
        seen = []

        def engine(q, k, v, sp, causal):
            seen.append((q, k))
            return mha_reference(q, k, v, causal=causal)

        model = ttf.TransformerLM(cfg, device="cpu",
                                  attention_fn=_sp_attention("ring", _fake_sp(size, rank), engine))
        model.load_state_dict(params)
        with torch.no_grad():
            model(tokens)
        return seen[0]

    q_all, k_all = run(0, 1, ids)
    q_mine, k_mine = run(1, 2, ids[:, SEQ // 2:])
    torch.testing.assert_close(q_mine, q_all[:, :, SEQ // 2:], rtol=0, atol=1e-6)
    torch.testing.assert_close(k_mine, k_all[:, :, SEQ // 2:], rtol=0, atol=1e-6)


def test_hook_adds_no_parameter():
    """The hook changes no name or shape: a flax tree of the reference's
    sp model converts to what the port's sp model loads."""
    jcfg, tcfg = _configs(2)
    mesh = jmesh.make_mesh({"sp": 2}, devices=jax.devices()[:2])
    tree = jax.eval_shape(jtf.TransformerLM(jcfg, attention_fn=jseq.sp_attention_fn(mesh)).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = ttf.TransformerLM(tcfg, device="cpu", attention_fn=_sp_attention("ring", _fake_sp(2)))
    plain = ttf.TransformerLM(tcfg, device="cpu")
    converted = convert.flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), tree))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in plain.state_dict().items()} == {
        k: tuple(v.shape) for k, v in converted.items()}


# ------------------------------------------------ a gloo group of one here


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one in this process and its (dp, sp) mesh."""
    from datetime import timedelta

    from torch.distributed.device_mesh import DeviceMesh

    dist = torch.distributed
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        yield DeviceMesh("cpu", torch.tensor([[0]]), mesh_dim_names=("dp", "sp"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["ulysses", "ring"])
def test_world_of_one_step_is_the_unsharded_step(world_of_one, kind):
    """At (dp 1, sp 1) the exchanges run over one rank: Ulysses's step is
    the unsharded one bit for bit, the ring's float32 fold within the
    parameter tolerance."""
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=2)
    params = ttf.init_params(cfg, 0)
    batch = _torch_batch(_tokens(cfg.vocab_size))
    plain = ttrain.state_for(ttf.TransformerLM(cfg, device="cpu", train=True), 0.1, 0.9)
    plain.model.load_state_dict(params)
    fn = tseq.sp_attention_fn(world_of_one, kind=kind)
    model = ttf.TransformerLM(cfg, device="cpu", train=True, attention_fn=fn)
    model.load_state_dict(params)
    step, state = tseq.shard_train_step_sp(ttrain.make_train_step(), world_of_one,
                                           ttrain.state_for(model, 0.1, 0.9))
    one = ttrain.make_train_step()
    for _ in range(2):
        plain, want = one(plain, batch)
        state, loss = step(state, tseq.sp_batch_sharding(batch, world_of_one))
        if kind == "ulysses":
            assert torch.equal(loss, want)
        else:
            np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    for name, value in plain.model.state_dict().items():
        got = state.model.state_dict()[name]
        if kind == "ulysses":
            assert torch.equal(got, value), name
        else:
            torch.testing.assert_close(got, value, rtol=0, atol=ATOL)
    if kind == "ulysses":  # q, k, v and the output, and their gradients
        assert fn.sp.calls["all_to_all"] == cfg.num_layers * 2 * 8
    else:  # a ring of one has no hop to make
        assert fn.sp.calls["ring_shift"] == 0


@pytest.mark.parametrize("kind", ["ulysses", "ring"])
def test_engine_at_one_rank_is_the_reference_s(world_of_one, kind):
    """Each engine over a group of one, 6 heads over 3 kv heads passed
    unexpanded, as the reference's over a mesh of sp 1: Ulysses's two
    exchanges of q, k, v and the output, the ring with no hop."""
    q, k, v = _qkv(6, 3, 8)
    mesh = jmesh.make_mesh({"sp": 1}, devices=jax.devices()[:1])
    ref = {"ring": jring.ring_self_attention, "ulysses": jul.ulysses_self_attention}[kind]
    want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, causal=True))
    fn = tseq.sp_attention_fn(world_of_one, kind=kind)
    got = fn(*(torch.from_numpy(t) for t in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert dict(fn.sp.calls) == ({"all_to_all": 4, "host_staged": 0} if kind == "ulysses" else {})
