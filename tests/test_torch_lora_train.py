"""LoRA training in the port against the JAX package's.

The reference trains adapters with ``make_lora_tx(inner)`` =
``optax.multi_transform({"lora": inner, "frozen": set_to_zero()},
lora_labels)``; the port builds ``inner`` over the adapter parameters alone
and freezes the rest (``models/lora.py``), through the same train step as
the plain LM (``models/train.py``).  Both sides start from flax's init of a
tiny LoRA LM (``GPTConfig.tiny()``, 2 kv heads, rank 4), with ``lora_b``
set to seeded non-zero values (zero-init B would leave ``lora_a``'s first
gradient exactly zero), moved to the port through
``convert.flax_to_state_dict``.

Tolerances (float32): the loss within 1e-5 relative and every adapter
within 1e-5 absolute after one step; the base bit for bit unchanged on
both sides.  One AdamW step moves an adapter by about lr x sign(g) (1e-2);
the frameworks' gradients differ by float sum order (~1e-6 relative), far
from flipping a sign at these gradients.  optax's ``adamw`` decays weights
by 1e-4 by default and torch's by 1e-2, so the port's is set to 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import lora as jlora
from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import lora as tlora
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as ttf

BATCH, SEQ, VOCAB, RANK = 2, 32, 512, 4
LOSS_RTOL = 1e-5
ADAPTER_ATOL = 1e-5

# (optax transform, the port's optimizer factory): the same update.
OPTIMIZERS = {
    "adamw": (lambda: optax.adamw(1e-2),
              functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4)),
    "sgd-momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)),
}


def _cfgs():
    base = dict(num_kv_heads=2, lora_rank=RANK)
    return (dataclasses.replace(jtf.GPTConfig.tiny(), **base),
            dataclasses.replace(ttf.GPTConfig.tiny(), **base))


def _flat(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, prefix + (key,)))
        else:
            out[".".join(prefix + (key,))] = value
    return out


@pytest.fixture(scope="module")
def start():
    jcfg, _ = _cfgs()
    params = jtf.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (rs.standard_normal(x.shape).astype(np.float32) * 0.05
                         if path[-1].key == "lora_b" else np.asarray(x)),
        params,
    )
    ids = np.random.RandomState(0).randint(0, VOCAB, size=(BATCH, SEQ + 1)).astype(np.int32)
    return params, {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _jax_step(params, batch, inner):
    jcfg, _ = _cfgs()
    tx = jlora.make_lora_tx(inner())
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                              batch_stats={})
    step = jax.jit(jtrain.make_train_step(jtf.TransformerLM(jcfg), tx, input_key="input_ids"))
    state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), _flat(jax.tree_util.tree_map(np.asarray, state.params))


def _port_state(params, inner):
    _, tcfg = _cfgs()
    return ttrain.create_train_state(tcfg, convert.flax_to_state_dict(params),
                                     tx=tlora.make_lora_tx(inner), device="cpu")


def _port_step(params, batch, inner):
    state = _port_state(params, inner)
    step = ttrain.make_train_step()
    state, loss = step(state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return state, loss


def test_lora_labels_equal_the_reference(start):
    params, _ = start
    want = _flat(jlora.lora_labels(params))
    got = tlora.lora_labels(convert.flax_to_state_dict(params))
    assert got == want
    assert set(got.values()) == {"lora", "frozen"}
    state = _port_state(params, OPTIMIZERS["adamw"][1])
    assert tlora.lora_labels(dict(state.model.named_parameters())) == want


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_one_lora_step_matches_the_reference(start, opt):
    params, batch = start
    jax_inner, port_inner = OPTIMIZERS[opt]
    want_loss, want = _jax_step(params, batch, jax_inner)
    state, loss = _port_step(params, batch, port_inner)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    before = _flat(params)
    got = {name: t.detach().numpy() for name, t in state.model.state_dict().items()}
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        if name.rsplit(".", 1)[-1] in tlora.ADAPTER_LEAVES:
            np.testing.assert_allclose(got[name], value, rtol=0, atol=ADAPTER_ATOL, err_msg=name)
            moved += not np.array_equal(got[name], before[name])
        else:
            # The frozen base: bit for bit, in the reference and the port.
            np.testing.assert_array_equal(value, before[name], err_msg=name)
            np.testing.assert_array_equal(got[name], before[name], err_msg=name)
    assert moved == sum(1 for n in want if n.rsplit(".", 1)[-1] in tlora.ADAPTER_LEAVES)


def test_frozen_base_with_a_gradient_does_not_move_under_adamw(start):
    """The masking trap: a base leaf that holds a non-zero gradient must not
    move, nor decay, while the adapters step."""
    params, _ = start
    state = _port_state(params, OPTIMIZERS["adamw"][1])
    named = dict(state.model.named_parameters())
    base = named["layer_0.attn.query.kernel"]
    adapter = named["layer_0.attn.query.lora_a"]
    assert not base.requires_grad and adapter.requires_grad
    before_base, before_adapter = base.detach().clone(), adapter.detach().clone()
    base.grad = torch.ones_like(base)
    adapter.grad = torch.ones_like(adapter)
    state.optimizer.step()
    assert torch.equal(base.detach(), before_base)
    assert not torch.equal(adapter.detach(), before_adapter)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizer_state_is_the_adapters_only(start, opt):
    params, batch = start
    state, _ = _port_step(params, batch, OPTIMIZERS[opt][1])
    sites = [n for n in state.model.state_dict() if n.endswith(".lora_a")]
    named = {id(p): n for n, p in state.model.named_parameters()}
    held = [named[id(p)] for p in state.optimizer.state]
    assert len(held) == 2 * len(sites) > 0
    assert all(n.rsplit(".", 1)[-1] in tlora.ADAPTER_LEAVES for n in held)
    # The reference's state holds its inner transform's slots for the
    # same leaves: the adapters' labels are as many.
    labels = jlora.lora_labels(params)
    assert sum(v == "lora" for v in jax.tree_util.tree_leaves(labels)) == len(held)


def test_make_lora_tx_refuses_a_model_without_adapters():
    _, tcfg = _cfgs()
    plain = dataclasses.replace(tcfg, lora_rank=None)
    with pytest.raises(ValueError, match="no LoRA adapters"):
        ttrain.create_train_state(plain, ttf.init_params(plain), device="cpu",
                                  tx=tlora.make_lora_tx(torch.optim.SGD))
