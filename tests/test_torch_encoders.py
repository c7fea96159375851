"""The port's encoder models (ViT, BERT) against the JAX package's.

Both sides start from flax's own init (seeded), moved to the port through
``convert.load_flax_train_state``; images and token ids come from numpy
with a seed.  Everything runs in float32 (``dtype=float32`` in both
configs), at 2 layers and narrow widths.  Each model is held on both of
its attention routes:

- the flash route, where the reference runs its Pallas forward in the
  interpreter (and its XLA backward) and the port its flash autograd
  Function (the plain versions of kernels 2-4 on the CPU): ViT at 64 px,
  patch 4 (256 tokens), BERT at 128 tokens with no mask;
- the plain route (``nn.dot_product_attention`` against
  ``layers.dot_product_attention``): ViT tiny's 16 tokens, BERT with an
  ``attention_mask``.

Tolerances (float32): logits 2e-5 absolute (sum order in the products, the
online softmax against the reference's one-pass one, through 2 layers);
two SGD-momentum steps (lr 0.1): losses 1e-5 relative, every parameter
1e-5 absolute.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import bert as jbert
from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu.models import vit as jvit
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import bert as tbert
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import vit as tvit

LOGIT_ATOL = 2e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5

VIT = {  # 64 px / patch 4 = 256 tokens: the flash route
    "flash": dict(image_size=64, patch_size=4, num_classes=10, hidden_size=32, num_layers=2,
                  num_heads=2, intermediate_size=64),
    "plain": {},  # ViTConfig.tiny(): 16 tokens
}
BERT_TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position=128)
BERT_SEQ = 128


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vit_cfgs(route):
    jc = dataclasses.replace(jvit.ViTConfig.tiny(), dtype=jnp.float32, **VIT[route])
    tc = dataclasses.replace(tvit.ViTConfig.tiny(), dtype=torch.float32, **VIT[route])
    return jc, tc


def _bert_cfgs():
    return (jbert.BertConfig(dtype=jnp.float32, **BERT_TINY),
            tbert.BertConfig(dtype=torch.float32, **BERT_TINY))


def _port_state(model, params):
    return convert.load_flax_train_state(ttrain.state_for(model, 0.1, 0.9), params)


@pytest.fixture(scope="module")
def vit_start():
    out = {}
    for route in VIT:
        jc, _ = _vit_cfgs(route)
        rs = np.random.RandomState(len(route))
        batch = {"images": rs.randn(2, jc.image_size, jc.image_size, 3).astype(np.float32),
                 "labels": rs.randint(0, jc.num_classes, size=2).astype(np.int32)}
        params = _np_tree(jvit.ViT(jc).init(jax.random.PRNGKey(2),
                                            jnp.asarray(batch["images"]))["params"])
        out[route] = params, batch
    return out


@pytest.fixture(scope="module")
def bert_start():
    jc, _ = _bert_cfgs()
    rs = np.random.RandomState(3)
    batch = {"input_ids": rs.randint(0, jc.vocab_size, (2, BERT_SEQ)).astype(np.int32),
             "labels": rs.randint(0, jc.vocab_size, (2, BERT_SEQ)).astype(np.int32)}
    mask = np.ones((2, BERT_SEQ), np.int32)
    mask[0, 100:] = 0
    mask[1, 37:] = 0
    params = _np_tree(jbert.Bert(jc).init(jax.random.PRNGKey(4),
                                          jnp.asarray(batch["input_ids"]))["params"])
    return params, batch, mask


def _flax_paths(params):
    return {".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(params)}


def _assert_params_close(state, want):
    got = convert.train_state_to_flax(state)["params"]
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=0, atol=PARAM_ATOL,
                                   err_msg="/".join(k.key for k in path))


def _train_both(jmodel, tmodel, params, batch, input_key):
    tx = optax.sgd(0.1, momentum=0.9)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                               batch_stats={})
    jstep = jax.jit(jtrain.make_train_step(jmodel, tx, input_key=input_key))
    tstate = _port_state(tmodel, params)
    tstep = ttrain.make_train_step(input_key=input_key)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {"labels": torch.from_numpy(batch["labels"]).long(),
          input_key: torch.from_numpy(batch[input_key])}
    if input_key == "input_ids":
        tb[input_key] = tb[input_key].long()
    jl, tl = [], []
    for _ in range(2):
        jstate, loss = jstep(jstate, jb)
        jl.append(float(loss))
        tstate, loss = tstep(tstate, tb)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tstate.step == int(jstate.step) == 2
    _assert_params_close(tstate, jstate.params)


# -------------------------------------------------------------------- ViT


def test_vit_names_are_flax_paths(vit_start):
    params, _ = vit_start["flash"]
    _, tc = _vit_cfgs("flash")
    model = tvit.ViT(tc, device="cpu")
    assert {n for n, _ in model.named_parameters()} == _flax_paths(params)
    assert not list(model.named_buffers())


@pytest.mark.parametrize("route", ["flash", "plain"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vit_forward_matches_the_reference(vit_start, route, train):
    params, batch = vit_start[route]
    jc, tc = _vit_cfgs(route)
    assert (jc.num_tokens % 128 == 0) == (route == "flash")
    want = jvit.ViT(jc).apply({"params": params}, jnp.asarray(batch["images"]), train=train)
    model = tvit.ViT(tc, device="cpu")
    _port_state(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["images"]), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("route", ["flash", "plain"])
def test_vit_two_train_steps_match_the_reference(vit_start, route):
    params, batch = vit_start[route]
    jc, tc = _vit_cfgs(route)
    _train_both(jvit.ViT(jc), tvit.ViT(tc, device="cpu"), params, batch, "images")


def test_vit_patch_tokens_run_row_major():
    """Token t of the port's patch embedding is patch (t // (W/P), t % (W/P))."""
    _, tc = _vit_cfgs("plain")
    model = tvit.ViT(tc, device="cpu")
    images = torch.zeros(1, tc.image_size, tc.image_size, 3)
    images[0, 8:16, 16:24] = 1.0  # patch (row 1, col 2) of a 4 x 4 grid
    with torch.no_grad():
        x = model.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        base = model.patch_embed(torch.zeros_like(images).permute(0, 3, 1, 2))
    changed = (x[0] - base.flatten(2).transpose(1, 2)[0]).abs().sum(-1).nonzero().flatten()
    assert changed.tolist() == [1 * 4 + 2]


def test_vit_refuses_the_wrong_image_size():
    _, tc = _vit_cfgs("plain")
    with pytest.raises(ValueError, match="expected 32x32"):
        tvit.ViT(tc, device="cpu")(torch.zeros(1, 24, 24, 3))


# ------------------------------------------------------------------- BERT


def test_bert_names_are_flax_paths(bert_start):
    params, _, _ = bert_start
    _, tc = _bert_cfgs()
    assert {n for n, _ in tbert.Bert(tc, device="cpu").named_parameters()} == _flax_paths(params)


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "attention-mask"])
def test_bert_forward_matches_the_reference(bert_start, masked):
    params, batch, mask = bert_start
    jc, tc = _bert_cfgs()
    ids = batch["input_ids"]
    want = jbert.Bert(jc).apply({"params": params}, jnp.asarray(ids),
                                attention_mask=jnp.asarray(mask) if masked else None)
    model = tbert.Bert(tc, device="cpu")
    _port_state(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_bert_two_train_steps_match_the_reference(bert_start):
    params, batch, _ = bert_start
    jc, tc = _bert_cfgs()
    _train_both(jbert.Bert(jc), tbert.Bert(tc, device="cpu"), params, batch, "input_ids")


@pytest.mark.parametrize("seq, masked, flash", [
    (128, False, True), (384, False, True), (100, False, True), (200, False, False),
    (128, True, False),
])
def test_bert_takes_the_reference_s_route(seq, masked, flash):
    """Flash exactly when the reference takes it: no mask and a sequence
    that tiles by min(128, seq)."""
    mask = object() if masked else None
    assert tbert.takes_flash(seq, mask) is flash
    block = min(128, seq)
    assert (mask is None and seq % block == 0) is flash


def test_bert_refuses_a_sequence_past_max_position():
    _, tc = _bert_cfgs()
    with pytest.raises(ValueError, match="exceeds max_position"):
        tbert.Bert(tc, device="cpu")(torch.zeros(1, 129, dtype=torch.long))
