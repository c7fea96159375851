"""The port's speculative decoding (models/engine_spec.py, the shared-pool
engine rounds, and models/speculative.py, the dense batch-1 loop) against
the JAX package's and against the dense greedy oracle, on the CPU.

Weights come from flax's own init (seeded) through ``convert``; the w8
self-draft is the JAX package's ``quantize_lm_params`` of the same tree,
converted, so both engines draft with the same codes.  GPTConfig.tiny() in
float32 (page 2 or 4, small pools).

Tolerances: greedy tokens are compared exactly, with every emitted token's
top-2 logit margin on the port's own dense decode above 1e-4 (f32 sum-order
differences are ~1e-6), so a near-tie cannot flake the equality.  Sampled
tokens are compared exactly under one key, and every draw they rest on
clears 1e-4: the top-2 margin of logits + gumbel of each categorical draw,
and |P(d) - u·Q(d)| of each acceptance test of a sampled row.  Counters,
the ``spec.verify`` span, the ``kernel.fallback`` flight event and
``/debug/state``'s ``spec`` block are compared with the reference's as
values.  The cases follow the reference's tests/test_engine.py (shared-pool
engine: windows on the paged kernel's plain version, EOS mid-round, the
validation, sampled slots, chunked prefill, logprobs refused, optimistic
admission with preemption, int8 KV) and tests/test_speculative.py.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import speculative as jax_spec
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu.ops.quant import quantize_lm_params as jax_quantize
from k8s_device_plugin_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_device_plugin_tpu.utils.spans import SpanRecorder as JaxSpans
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import engine_spec, speculative
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.utils import prng
from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry
from k8s_device_plugin_tpu_torch.utils.spans import SpanRecorder

MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**kw):
    base = dict(max_seq=64, num_kv_heads=2, **kw)
    return (dataclasses.replace(jax_tf.GPTConfig.tiny(), **base),
            dataclasses.replace(port_tf.GPTConfig.tiny(), **base))


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, JAX w8 tree, port state dict, port w8 state dict)."""
    jcfg, _ = _cfgs()
    params = _np(jax_tf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 8), jnp.int32))["params"])
    qparams = _np(jax_quantize(params))
    return params, qparams, convert.flax_to_state_dict(params), convert.flax_to_state_dict(qparams)


def _oracle(tcfg, state, prompt, n):
    """The dense greedy decode of the port (the reference's _oracle)."""
    return port_tf.greedy_generate(tcfg, state, [prompt], n, device="cpu")[0, len(prompt):].tolist()


def _margin_ok(tcfg, state, prompt, tokens):
    """Every token is the argmax of the port's dense cached decode at its
    position and wins by more than MARGIN."""
    model = port_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(state)
    cache = port_tf.DenseCache.zeros(tcfg, 1, "cpu", max_seq=len(prompt) + len(tokens))
    with torch.no_grad():
        rows = [model(torch.tensor([prompt]), cache=cache, append_mode="cached")[0, -1]]
        for i, tok in enumerate(tokens[:-1]):
            rows.append(model(torch.tensor([[tok]]), torch.tensor([[len(prompt) + i]]),
                              cache=cache)[0, -1])
    logits = torch.stack(rows)
    top2 = logits.topk(2, dim=-1).values
    return logits.argmax(-1).tolist() == tokens and float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def _engines(weights, cfg_kw=None, paged=(4, 32, 8), jax_kw=None, **kw):
    """A JAX and a port spec engine on the same weights and flags."""
    params, qparams, state, qstate = weights
    jcfg, tcfg = _cfgs(**(cfg_kw or {}))
    jeng = jax_engine.ServingEngine(jcfg, params, jax_tf.PagedConfig(*paged, use_kernel=True),
                                    draft_params=qparams, **(jax_kw or {}), **kw)
    teng = port_engine.ServingEngine(tcfg, state, port_tf.PagedConfig(*paged),
                                     draft_params=qstate, device="cpu", **kw)
    return jeng, teng, tcfg


CASES = {
    # name: (cfg fields, paged geometry, engine kwargs, jobs)
    "gamma2": ({}, (4, 32, 8), dict(max_slots=2, spec_gamma=2),
               [([3, 141, 59], 8), ([9, 10], 5), ([400, 2, 2, 17], 6)]),
    "window_kernel_gamma3": (dict(attention_window=4), (2, 24, 12), dict(max_slots=2, spec_gamma=3),
                             [([3, 141, 59], 9), ([9, 10], 6)]),
    "chunked_prefill_window": (dict(attention_window=4), (2, 32, 14),
                               dict(max_slots=2, spec_gamma=2, prefill_chunk=4),
                               [([3, 141, 59, 265, 35, 7, 7, 3, 1], 8), ([9, 10], 5)]),
    "int8_kv_window": (dict(quant_kv=True, attention_window=4), (2, 24, 12),
                       dict(max_slots=2, spec_gamma=2), [([3, 141, 59], 9), ([9, 10], 6)]),
    "optimistic": ({}, (4, 16, 8), dict(max_slots=2, spec_gamma=2, admission="optimistic"),
                   [([3, 141, 59], 8), ([9, 10], 5)]),
    # 6 allocatable pages of 4; each request's worst case is 4 pages, so
    # the two collide while growing and the newer one is preempted.
    "optimistic_preempts": ({}, (4, 7, 8),
                            dict(max_slots=2, spec_gamma=2, admission="optimistic",
                                 prefix_sharing=False),
                            [([3, 141, 59, 7], 12), ([9, 10, 11, 12], 12)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_equals_jax_and_dense_oracle(weights, case):
    """Greedy streams equal the JAX spec engine's and the dense greedy
    oracle's, with the same proposed/accepted counts and preemptions, and
    the pool drains clean."""
    cfg_kw, paged, kw, jobs = CASES[case]
    jeng, teng, tcfg = _engines(weights, cfg_kw, paged, **kw)
    want = [r.tokens for r in jeng.run(jobs)]
    got = [r.tokens for r in teng.run(jobs)]
    assert got == want
    state = weights[2]
    for (prompt, n), tokens in zip(jobs, got):
        assert tokens == _oracle(tcfg, state, prompt, n), prompt
        assert _margin_ok(tcfg, state, prompt, tokens)
    assert (teng.spec_proposed, teng.spec_accepted) == (jeng.spec_proposed, jeng.spec_accepted)
    assert 0 < teng.spec_accepted <= teng.spec_proposed
    assert teng.preemptions == jeng.preemptions
    if case == "optimistic_preempts":
        assert teng.preemptions > 0
    if cfg_kw.get("quant_kv"):
        assert teng.cache.pool_k[0].dtype == torch.int8
    assert len(teng.free_pages) == teng.paged.num_pages - 1


def test_spec_engine_eos_stops_mid_round(weights):
    """An EOS accepted mid-round cuts the round's emissions where the dense
    decode stops, in both packages."""
    _, tcfg = _cfgs()
    prompt = [3, 141, 59]
    oracle = _oracle(tcfg, weights[2], prompt, 8)
    eos = oracle[2]
    stop = oracle.index(eos) + 1
    jeng, teng, _ = _engines(weights, paged=(4, 16, 8), max_slots=1, eos_id=eos, spec_gamma=3)
    [want] = jeng.run([(prompt, 8)])
    [got] = teng.run([(prompt, 8)])
    assert got.done and got.tokens == want.tokens == oracle[:stop]
    assert len(teng.free_pages) == teng.paged.num_pages - 1


@pytest.mark.parametrize("kw, match", [
    (dict(spec_gamma=2, draft_params=None), "draft_params"),
    (dict(spec_gamma=2, draft_cfg="one_layer"), "architecture"),
    (dict(spec_gamma=-1), "spec_gamma"),
    (dict(spec_gamma=2, decode_block=4), "decode_block > 1"),
])
def test_spec_engine_validation_equals_the_reference(weights, kw, match):
    params, qparams, state, qstate = weights
    jcfg, tcfg = _cfgs()
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("draft_cfg") == "one_layer":
        jkw["draft_cfg"] = dataclasses.replace(jcfg, num_layers=1)
        tkw["draft_cfg"] = dataclasses.replace(tcfg, num_layers=1)
    jkw.setdefault("draft_params", qparams)
    tkw.setdefault("draft_params", qstate)
    paged = (4, 16, 8)
    with pytest.raises(ValueError, match=match):
        jax_engine.ServingEngine(jcfg, params, jax_tf.PagedConfig(*paged), **jkw)
    with pytest.raises(ValueError, match=match):
        port_engine.ServingEngine(tcfg, state, port_tf.PagedConfig(*paged), device="cpu", **tkw)


@pytest.mark.parametrize("kw, match", [
    (dict(logprobs=True), "logprobs"),
    (dict(logit_bias={5: 1.0}), "logit_bias"),
])
def test_spec_engine_refuses_logprobs_and_logit_bias(weights, kw, match):
    jeng, teng, _ = _engines(weights, paged=(4, 16, 8), max_slots=1, spec_gamma=2)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match=match):
            eng.submit([3], 4, **kw)


@contextlib.contextmanager
def _recorded_draws():
    """Record the top-2 margin of logits + gumbel of every categorical draw,
    and |P(d) - u·Q(d)| of every acceptance test of a sampled row (rows at
    temperature 0 compute a test that the round discards)."""
    margins, real_cat, real_acc = [], prng.categorical, speculative.accept_draws
    real_round = engine_spec.spec_round
    temps = []

    def categorical(key, logits, axis=-1):
        top2 = (prng.gumbel(key, logits.shape) + logits).topk(2, dim=-1).values
        margins.extend((top2[..., 0] - top2[..., 1]).reshape(-1).tolist())
        return real_cat(key, logits, axis)

    def accept(u, q_d, p_d):
        gap = (p_d - u * q_d).abs()
        if temps:
            gap = gap[temps.pop() > 0]
        margins.extend(gap.reshape(-1).tolist())
        return real_acc(u, q_d, p_d)

    def spec_round(*args, **kw):
        if kw.get("temps") is not None:
            temps.append(kw["temps"].clone())
        return real_round(*args, **kw)

    prng.categorical, speculative.accept_draws = categorical, accept
    engine_spec.spec_round = spec_round
    try:
        yield margins
    finally:
        prng.categorical, speculative.accept_draws = real_cat, real_acc
        engine_spec.spec_round = real_round


def test_spec_engine_sampled_slots_equal_jax(weights):
    """Greedy, temperature 9 with top-k 1, hot top-3 and top-k/top-p slots
    in one batch: every slot's tokens equal the JAX spec engine's under the
    same engine key; the greedy and the top-k 1 slots equal the oracle; the
    hot slots leave the greedy trajectory; every draw clears MARGIN."""
    jeng, teng, tcfg = _engines(weights, paged=(4, 32, 8), max_slots=3, spec_gamma=2,
                                rng=None)
    jeng._rng = jax.random.PRNGKey(11)
    teng._rng = prng.PRNGKey(11)
    prompt = [3, 141, 59]
    jobs = [
        (prompt, 6, {}),
        (prompt, 6, dict(temperature=9.0, top_k=1)),
        (prompt, 6, dict(temperature=3.0, top_k=3)),
        ([9, 10], 7, dict(temperature=0.8, top_k=40, top_p=0.95)),
    ]

    def serve(eng):
        subs = [eng.submit(p, n, **kw) for p, n, kw in jobs]
        while not all(r.done for r in subs):
            eng.step()
        return [r.tokens for r in subs]

    want = serve(jeng)
    with _recorded_draws() as margins:
        got = serve(teng)
    assert got == want
    assert min(margins) > MARGIN and len(margins) > 20
    oracle = _oracle(tcfg, weights[2], prompt, 6)
    assert got[0] == oracle and got[1] == oracle
    assert got[2] != oracle
    assert (teng.spec_proposed, teng.spec_accepted) == (jeng.spec_proposed, jeng.spec_accepted)


def test_spec_observability_equals_the_reference(weights):
    """The counters, one ``spec.verify`` span per round with the
    reference's attrs, the ``kernel.fallback`` flight event of a kernel-on
    spec engine, and ``/debug/state``'s ``spec`` block."""
    params, qparams, state, qstate = weights
    jcfg, tcfg = _cfgs()
    paged = (4, 32, 8)
    jm, jspans = jax_engine.EngineMetrics(JaxRegistry()), JaxSpans(capacity=512, name="engine")
    tm, tspans = port_engine.EngineMetrics(MetricsRegistry()), SpanRecorder(capacity=512,
                                                                            name="engine")
    jeng = jax_engine.ServingEngine(jcfg, params, jax_tf.PagedConfig(*paged, use_kernel=True),
                                    max_slots=2, spec_gamma=2, draft_params=qparams, metrics=jm,
                                    spans=jspans)
    teng = port_engine.ServingEngine(tcfg, state, port_tf.PagedConfig(*paged), max_slots=2,
                                     spec_gamma=2, draft_params=qstate, metrics=tm, spans=tspans,
                                     device="cpu")
    jobs = [([3, 141, 59], 8), ([9, 10], 5), ([400, 2, 2, 17], 6)]
    jeng.run(jobs)
    teng.run(jobs)
    assert teng.debug_state()["spec"] == jeng.debug_state()["spec"]
    for name in ("spec_proposed", "spec_accepted", "spec_rejected", "tokens", "steps"):
        assert getattr(tm, name).value() == getattr(jm, name).value(), name
    assert tm.kernel_fallbacks.value(reason="spec_verify") == 1
    assert jm.kernel_fallbacks.value(reason="spec_verify") == 1

    def rounds(spans):
        return [s["attrs"] for s in spans.snapshot() if s["name"] == "spec.verify"]

    assert rounds(tspans) == rounds(jspans) and rounds(tspans)
    assert teng.spec_rounds == len(rounds(tspans))
    for eng in (jeng, teng):
        [event] = [e for e in eng.flight.window(kinds=["kernel.fallback"])]
        assert event["reason"] == "spec_verify"
    # The verify pass reads the gathered pages; only the draft's single-token
    # steps run the paged kernel (its plain version here).
    ds = teng.debug_state()
    assert ds["device"]["spec_rounds"] == teng.spec_rounds
    assert ds["device"]["device_steps"] == 2 * teng.spec_rounds
    assert ds["overlap"]["steps"] == 0


def test_spec_round_counts_the_kernel_once_per_draft_step(weights, monkeypatch):
    """A round launches the paged-attention wrapper once per layer per
    draft step and never in the verify pass (the gathered view)."""
    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

    _, teng, _ = _engines(weights, paged=(4, 32, 8), max_slots=2, spec_gamma=3)
    calls = []
    real = port_tf.paged_attention

    def counting(q, *a, **k):
        calls.append(q.shape)
        return real(q, *a, **k)

    monkeypatch.setattr(port_tf, "paged_attention", counting)
    pa.reset_launches()
    teng.run([([3, 141, 59], 9), ([9, 10], 6)])
    assert len(calls) == teng.cfg.num_layers * 3 * teng.spec_rounds


def test_batch_cli_spec_gamma_json(capsys):
    port_engine.main(["--device", "cpu", "--dtype", "float32", "--hidden", "64", "--layers", "2",
                      "--heads", "4", "--kv-heads", "2", "--vocab", "512", "--page-size", "4",
                      "--num-pages", "64", "--requests", "3", "--prompt-len", "8",
                      "--max-new", "6", "--spec-gamma", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["spec_gamma"] == 2 and 0 <= out["spec_acceptance"] <= 1
    assert out["tokens"] == 18 and out["spec_rounds"] > 0 and out["overlap_hits"] == 0
    with pytest.raises(SystemExit):
        port_engine.parse_args(["--spec-gamma", "2", "--quant", "w8"])


# ------------------------------------------------------- the dense variant


DRAFTS = ["self", "w8", "unrelated"]


def _draft(weights, kind):
    """(JAX cfg, JAX tree, port cfg, port state) of each draft kind."""
    params, qparams, state, qstate = weights
    jcfg, tcfg = _cfgs()
    if kind == "self":
        return jcfg, params, tcfg, state
    if kind == "w8":
        return (dataclasses.replace(jcfg, quant="w8"), qparams,
                dataclasses.replace(tcfg, quant="w8"), qstate)
    jd, td = _cfgs(num_layers=1)
    tree = _np(jax_tf.TransformerLM(jd).init(jax.random.PRNGKey(9),
                                             jnp.zeros((1, 8), jnp.int32))["params"])
    return jd, tree, td, convert.flax_to_state_dict(tree)


@pytest.mark.parametrize("kind", DRAFTS)
def test_speculative_generate_equals_jax_and_greedy(weights, kind):
    params, _, state, _ = weights
    jcfg, tcfg = _cfgs()
    jd, jdp, td, tdp = _draft(weights, kind)
    prompt = np.random.RandomState(4).randint(0, 512, size=(1, 6)).astype(np.int32)
    want, want_acc = jax_spec.speculative_generate(jcfg, params, jd, jdp, jnp.asarray(prompt),
                                                   12, gamma=3)
    got, acc = speculative.speculative_generate(tcfg, state, td, tdp, prompt, 12, gamma=3,
                                                device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    greedy = port_tf.greedy_generate(tcfg, state, prompt, 12, device="cpu")
    assert torch.equal(got, greedy)
    assert _margin_ok(tcfg, state, prompt[0].tolist(), got[0, 6:].tolist())
    assert acc[0] == 0 and set(acc.tolist()) <= {0, 1}
    if kind == "self":
        assert int(acc.sum()) >= len(acc) // 2


@pytest.mark.parametrize("kind", ["w8", "unrelated"])
def test_speculative_sample_generate_equals_jax(weights, kind):
    params, _, state, _ = weights
    jcfg, tcfg = _cfgs()
    jd, jdp, td, tdp = _draft(weights, kind)
    prompt = np.random.RandomState(5).randint(0, 512, size=(1, 5)).astype(np.int32)
    want, want_acc = jax_spec.speculative_sample_generate(
        jcfg, params, jd, jdp, jnp.asarray(prompt), 10, rng=jax.random.PRNGKey(7),
        temperature=0.8, gamma=3)
    with _recorded_draws() as margins:
        got, acc = speculative.speculative_sample_generate(
            tcfg, state, td, tdp, prompt, 10, rng=prng.PRNGKey(7), temperature=0.8, gamma=3,
            device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert min(margins) > MARGIN
    assert got.shape == (1, 15) and int(got.min()) >= 0 and int(got.max()) < 512


@pytest.mark.parametrize("case", ["batch", "gamma", "headroom", "vocab", "temperature"])
def test_speculative_guards_equal_the_reference(weights, case):
    params, _, state, _ = weights
    jcfg, tcfg = _cfgs()
    jd, jdp, td, tdp = jcfg, params, tcfg, state
    prompt, n, kw, match = np.zeros((1, 4), np.int32), 4, dict(gamma=4), None
    if case == "batch":
        prompt, match = np.zeros((2, 4), np.int32), "batch-1"
    elif case == "gamma":
        kw, match = dict(gamma=0), "gamma"
    elif case == "headroom":
        prompt, n, match = np.zeros((1, 40), np.int32), 22, "max_seq"
    elif case == "vocab":
        jd, td = (dataclasses.replace(c, vocab_size=256) for c in (jcfg, tcfg))
        match = "vocab"
    if case == "temperature":
        with pytest.raises(ValueError, match="temperature"):
            jax_spec.speculative_sample_generate(jcfg, params, jcfg, params, jnp.asarray(prompt),
                                                 n, rng=jax.random.PRNGKey(0), temperature=0.0)
        with pytest.raises(ValueError, match="temperature"):
            speculative.speculative_sample_generate(tcfg, state, tcfg, state, prompt, n,
                                                    rng=prng.PRNGKey(0), temperature=0.0,
                                                    device="cpu")
        return
    with pytest.raises(ValueError, match=match):
        jax_spec.speculative_generate(jcfg, params, jd, jdp, jnp.asarray(prompt), n, **kw)
    with pytest.raises(ValueError, match=match):
        speculative.speculative_generate(tcfg, state, td, tdp, prompt, n, device="cpu", **kw)


def test_sample_generate_equals_jax(weights):
    """``sample_generate`` (the dense sampler the speculative sampler is
    held against) draws the reference's tokens under one key."""
    params, _, state, _ = weights
    jcfg, tcfg = _cfgs()
    prompt = np.random.RandomState(6).randint(0, 512, size=(2, 5)).astype(np.int32)
    for top_k in (None, 5):
        want = jax_tf.sample_generate(jcfg, params, jnp.asarray(prompt), 8,
                                      rng=jax.random.PRNGKey(3), temperature=0.7, top_k=top_k)
        with _recorded_draws() as margins:
            got = port_tf.sample_generate(tcfg, state, prompt, 8, rng=prng.PRNGKey(3),
                                          temperature=0.7, top_k=top_k, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert min(margins) > MARGIN
    with pytest.raises(ValueError, match="temperature"):
        port_tf.sample_generate(tcfg, state, prompt, 2, rng=prng.PRNGKey(0), temperature=0,
                                device="cpu")
