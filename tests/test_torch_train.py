"""The port's LM training slice against the JAX package's.

Both sides start from flax's own init (seeded), moved to the port through
``convert.flax_to_state_dict``; token ids come from numpy with a seed.  The
tiny config (``GPTConfig.tiny()`` with 2 kv heads, batch 2, seq 128) sends
the JAX model through its flash path (the Pallas forward in the
interpreter, the chunked backward), and the port through its flash
autograd Function (the plain forward and backward on the CPU).

Tolerances (float32 throughout): losses within 1e-5 relative and every
updated parameter within 1e-5 absolute after two SGD-momentum steps.  The
two frameworks sum in different orders, which moves the float32 gradients
by ~1e-6 relative; two steps of lr 0.1 carry that into the weights at
~1e-7.  The fused cross-entropy is held to 1e-5 against the reference's
op: the same chunked float32 math in another summation order.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.ops import fused_xent as jxent
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import benchmark as tbench
from k8s_device_plugin_tpu_torch.models import data as tdata
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.ops import fused_xent as txent

BATCH, SEQ, VOCAB = 2, 128, 512
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
XENT_TOL = 1e-5


def _cfgs(**kw):
    base = dict(num_kv_heads=2, **kw)
    return (
        dataclasses.replace(jtf.GPTConfig.tiny(), **base),
        dataclasses.replace(ttf.GPTConfig.tiny(), **base),
    )


@pytest.fixture(scope="module")
def start():
    jcfg, _ = _cfgs()
    params = jtf.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(0).randint(0, VOCAB, size=(BATCH, SEQ + 1)).astype(np.int32)
    return params, {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _jax_steps(params, batch, *, fused=False, grad_accum=1, remat=False, n=2):
    jcfg, _ = _cfgs(remat=remat)
    model = jtf.TransformerLM(jcfg)
    tx = optax.sgd(0.1, momentum=0.9)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                              opt_state=tx.init(p), batch_stats={})
    if fused:
        step = jtrain.make_fused_lm_train_step(model, tx, chunk=VOCAB // 4)
    else:
        step = jtrain.make_train_step(model, tx, input_key="input_ids", grad_accum=grad_accum)
    step = jax.jit(step)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(n):
        state, loss = step(state, jb)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _port_steps(params, batch, *, fused=False, grad_accum=1, remat=False, n=2):
    _, tcfg = _cfgs(remat=remat)
    state = ttrain.create_train_state(tcfg, convert.flax_to_state_dict(params), 0.1, 0.9,
                                      device="cpu")
    if fused:
        step = ttrain.make_fused_lm_train_step(chunk=VOCAB // 4)
    else:
        step = ttrain.make_train_step(grad_accum=grad_accum)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    losses = []
    for _ in range(n):
        state, loss = step(state, tb)
        losses.append(loss)
    assert state.step == n
    return losses, state


def _assert_same_training(want, got):
    (want_losses, want_params), (got_losses, state) = want, got
    np.testing.assert_allclose([float(x) for x in got_losses], want_losses, rtol=LOSS_RTOL)
    got_params = convert.state_dict_to_flax(state.model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(want_params)
    assert len(flat) == len(jax.tree_util.tree_leaves(got_params))
    for path, leaf in flat:
        node = got_params
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, leaf, rtol=0, atol=PARAM_ATOL,
                                   err_msg="/".join(k.key for k in path))


def test_two_train_steps_match_the_reference(start):
    _assert_same_training(_jax_steps(*start), _port_steps(*start))


@pytest.mark.parametrize(
    "variant", [{"grad_accum": 2}, {"fused": True}], ids=["grad-accum-2", "fused-xent"]
)
def test_train_step_variants_match_the_reference(start, variant):
    _assert_same_training(_jax_steps(*start, **variant), _port_steps(*start, **variant))


def test_remat_matches_the_reference_and_equals_no_remat(start):
    remat = _port_steps(*start, remat=True)
    _assert_same_training(_jax_steps(*start, remat=True), remat)
    plain = _port_steps(*start)
    assert all(torch.equal(a, b) for a, b in zip(remat[0], plain[0]))
    sd_r, sd_p = remat[1].model.state_dict(), plain[1].model.state_dict()
    assert all(torch.equal(sd_r[k], sd_p[k]) for k in sd_p)


def test_sgd_momentum_equals_optax_sgd_over_two_steps():
    rs = np.random.RandomState(1)
    w0 = rs.randn(5, 3).astype(np.float32)
    grads = [rs.randn(5, 3).astype(np.float32) for _ in range(2)]
    tx = optax.sgd(0.1, momentum=0.9)
    jw, opt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    sgd = torch.optim.SGD([tw], lr=0.1, momentum=0.9, dampening=0, nesterov=False)
    for g in grads:
        updates, opt = tx.update(jnp.asarray(g), opt, jw)
        jw = optax.apply_updates(jw, updates)
        tw.grad = torch.from_numpy(g)
        sgd.step()
    # p - lr*t (torch) and p + (-lr*t) (optax) may round apart by one
    # float32 ulp, which is below 1e-6 at |w| < 8.
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def test_training_model_keeps_float32_params_and_serving_does_not():
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), dtype=torch.bfloat16)
    params = ttf.init_params(cfg, seed=0)
    train = ttf.TransformerLM(cfg, device="cpu", train=True)
    train.load_state_dict(params)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    serve = ttf.TransformerLM(cfg, device="cpu")
    serve.load_state_dict(params)
    assert serve.layer_0.attn.query.kernel.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 24))).long()
    with torch.no_grad():
        # Casting float32 weights at each site gives the serving model's values.
        torch.testing.assert_close(train(ids), serve(ids), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [7, 32, 61])
@pytest.mark.parametrize("vocab", [60, 64])
def test_fused_xent_matches_the_reference(vocab, chunk):
    rs = np.random.RandomState(vocab + chunk)
    h = rs.randn(24, 16).astype(np.float32)
    w = (rs.randn(16, vocab) * 0.5).astype(np.float32)
    labels = rs.randint(0, vocab, size=24).astype(np.int32)
    want_loss, (want_dh, want_dw) = jax.value_and_grad(
        lambda h, w: jxent.fused_linear_xent(h, w, jnp.asarray(labels), chunk), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    loss = txent.fused_linear_xent(th, tw, torch.from_numpy(labels), chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=XENT_TOL, atol=XENT_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), rtol=XENT_TOL, atol=XENT_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), rtol=XENT_TOL, atol=XENT_TOL)
    naive = txent.naive_linear_xent(th, tw, torch.from_numpy(labels))
    np.testing.assert_allclose(naive.item(), float(want_loss), rtol=XENT_TOL, atol=XENT_TOL)


def test_fused_xent_rejects_a_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        txent.fused_linear_xent(torch.zeros(2, 4), torch.zeros(4, 8), torch.zeros(2), 0)


def test_synthetic_lm_batch_shifts_labels_and_is_seeded():
    make = lambda seed: tdata.synthetic_lm_batch(  # noqa: E731
        3, 16, 100, generator=torch.Generator().manual_seed(seed), device="cpu")
    a, b, c = make(0), make(0), make(1)
    assert a["input_ids"].shape == a["labels"].shape == (3, 16)
    assert torch.equal(a["input_ids"][:, 1:], a["labels"][:, :-1])
    assert torch.equal(a["input_ids"], b["input_ids"])
    assert not torch.equal(a["input_ids"], c["input_ids"])
    assert int(a["input_ids"].min()) >= 0 and int(a["input_ids"].max()) < 100


def test_train_step_options_are_checked():
    with pytest.raises(ValueError, match="grad_accum"):
        ttrain.make_train_step(grad_accum=0)
    _, tcfg = _cfgs()
    state = ttrain.create_train_state(tcfg, ttf.init_params(tcfg), device="cpu")
    batch = {k: torch.zeros((3, 8), dtype=torch.long) for k in ("input_ids", "labels")}
    # A dense model sows no auxiliary loss: the coefficient changes nothing
    # (the MoE cases are tests/test_torch_moe.py's).
    twin = ttrain.create_train_state(tcfg, ttf.init_params(tcfg), device="cpu")
    _, plain = ttrain.make_train_step()(twin, batch)
    _, balanced = ttrain.make_train_step(aux_loss_coeff=0.01)(state, batch)
    assert float(balanced) == float(plain) and ttrain.sown_aux_loss(state.model) == 0.0
    state = ttrain.create_train_state(tcfg, ttf.init_params(tcfg), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.make_train_step(grad_accum=2)(state, batch)
    logits = ttrain.make_eval_step()(state, batch)
    assert logits.shape == (3, 8, VOCAB) and not logits.requires_grad


def test_state_dict_to_flax_inverts_flax_to_state_dict(start):
    params, _ = start
    back = convert.state_dict_to_flax(convert.flax_to_state_dict(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [[], ["--fused-xent"], ["--grad-accum=2"]],
                         ids=["standard", "fused-xent", "grad-accum"])
def test_benchmark_cli_trains_on_the_cpu(capsys, extra):
    tbench.main(["--model=gpt", "--tiny", "--device=cpu", "--dtype=float32",
                 "--batch-size=2", "--seq-len=16", "--steps=2", "--warmup=1", *extra])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"model", "chips", "global_batch", "throughput", "throughput_per_chip", "unit",
            "step_time_ms", "final_loss", "final_step", "device"} <= set(record)
    assert record["device"] == "cpu" and record["unit"] == "tokens/sec"
    assert record["final_step"] == 4 * 1 + 2  # warmup, two short runs, one long
    assert np.isfinite(record["final_loss"]) and record["final_loss"] < np.log(VOCAB)


def test_benchmark_refuses_fused_xent_with_grad_accum(capsys):
    with pytest.raises(SystemExit):
        tbench.parse_args(["--model=gpt", "--fused-xent", "--grad-accum=2"])
    assert "--grad-accum does not combine with --fused-xent" in capsys.readouterr().err
