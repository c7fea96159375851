"""The PyTorch serving engine against the JAX ServingEngine.

Both engines take the same converted weights and the same jobs; greedy
streams must be token-identical.  The JAX side runs ``use_kernel=True`` so
both sides compute the split-K decode math (the JAX package's XLA lane of
its paged kernel on the CPU; the port's plain version of its CUDA kernel).
Page size 4, prompts sharing a prefix, and more jobs than slots exercise
the prefix trie, the graft, page release and slot reuse.

Tolerances: none — greedy token ids are compared exactly.  The config is
float32 and small, so the logits of the two frameworks differ by float
sum order only (~1e-6); ``test_top2_margins_clear_sum_order`` checks that
no emitted token is a near-tie, so exact equality cannot flake.  The
quantized engine (``w8`` weights from the JAX package's quantize_lm_params,
int8 KV pools) is held the same way, its margins taken on the port's own
int8-cache decode.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models.engine import ServingEngine as JaxEngine
from k8s_device_plugin_tpu.models.transformer import GPTConfig as JaxGPTConfig
from k8s_device_plugin_tpu.models.transformer import PagedConfig as JaxPagedConfig
from k8s_device_plugin_tpu.models.transformer import TransformerLM as JaxLM
from k8s_device_plugin_tpu.ops.quant import quantize_lm_params as jax_quantize_lm_params
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as torch_engine
from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
from k8s_device_plugin_tpu_torch.models.engine_sampling import (
    _derived_tables,
    filter_top_k_top_p,
)
from k8s_device_plugin_tpu_torch.models.transformer import (
    DenseCache,
    GPTConfig,
    PagedConfig,
    TransformerLM,
)
from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

MARGIN = 1e-4  # top-2 logit margin that f32 sum-order differences (~1e-6) cannot cross


def _jobs(n=7, seed=0, vocab=512):
    """Half the prompts share an 8-token (two-page) prefix; lengths vary so
    several prefill buckets and partial last pages occur."""
    rs = np.random.RandomState(seed)
    common = rs.randint(1, vocab, size=8).tolist()
    jobs = []
    for i in range(n):
        tail = rs.randint(1, vocab, size=3 + 2 * i).tolist()
        prompt = common + tail if i % 2 == 0 else tail + common[:2]
        jobs.append((prompt, 6 + i % 3))
    return jobs


def _configs(**kw):
    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), max_seq=64, num_kv_heads=2, **kw)
    tcfg = dataclasses.replace(GPTConfig.tiny(), max_seq=64, num_kv_heads=2, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return params, convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


def _run_both(weights, jobs, *, cfg_kw=None, slots=3, prefill_chunk=None, **paged_kw):
    jparams, state = weights
    jcfg, tcfg = _configs(**(cfg_kw or {}))
    geo = dict(page_size=4, num_pages=40, max_pages_per_seq=12)
    jeng = JaxEngine(
        jcfg, jparams, JaxPagedConfig(**geo, use_kernel=True, **paged_kw),
        max_slots=slots, prefill_chunk=prefill_chunk,
    )
    teng = ServingEngine(
        tcfg, state, PagedConfig(**geo, **paged_kw), max_slots=slots,
        prefill_chunk=prefill_chunk, device="cpu",
    )
    want = [r.tokens for r in jeng.run(jobs)]
    got = [r.tokens for r in teng.run(jobs)]
    return want, got, teng


def test_greedy_streams_equal_jax_engine(weights):
    jobs = _jobs()
    want, got, eng = _run_both(weights, jobs)
    assert got == want
    # Everything went back to the pool: slots reused, pages released.
    assert all(s is None for s in eng.slots)
    assert len(eng.free_pages) == eng.paged.num_pages - 1
    assert not eng._page_refs and not eng._prefix_pages


@pytest.mark.parametrize("splits", [1, 3])
def test_greedy_streams_equal_across_split_counts(weights, splits):
    want, got, _ = _run_both(weights, _jobs(5, seed=1), kernel_num_splits=splits)
    assert got == want


def test_chunked_prefill_streams_equal_jax_engine(weights):
    want, got, _ = _run_both(weights, _jobs(5, seed=2), prefill_chunk=4)
    assert got == want


def test_windowed_streams_equal_jax_engine(weights):
    """Sliding window 6: the kernel masks col >= len - window and the
    engine reclaims pages that scroll out, on both sides."""
    jobs = [(p, 14) for p, _ in _jobs(4, seed=3)]
    want, got, eng = _run_both(weights, jobs, cfg_kw={"attention_window": 6})
    assert got == want
    assert len(eng.free_pages) == eng.paged.num_pages - 1


def test_gather_path_equals_kernel_path(weights):
    _, state = weights
    _, tcfg = _configs()
    jobs = _jobs(5, seed=4)
    streams = []
    for use_kernel in (None, False):
        eng = ServingEngine(
            tcfg, state, PagedConfig(4, 40, 12, use_kernel=use_kernel), max_slots=2,
            device="cpu",
        )
        assert eng.kernel_on is (use_kernel is None)
        streams.append([r.tokens for r in eng.run(jobs)])
    assert streams[0] == streams[1]


def test_top2_margins_clear_sum_order(weights):
    """Every greedy token of the parity jobs wins by more than MARGIN in the
    port's full forward, so the exact comparisons above cannot flake."""
    from k8s_device_plugin_tpu_torch.models.transformer import TransformerLM

    _, state = weights
    _, tcfg = _configs()
    model = TransformerLM(tcfg, device="cpu")
    model.load_state_dict(state)
    eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=3, device="cpu")
    jobs = _jobs()
    for (prompt, _), req in zip(jobs, eng.run(jobs)):
        ids = torch.tensor([prompt + req.tokens[:-1]])
        logits = model(ids)[0, len(prompt) - 1 :]
        top2 = logits.topk(2, dim=-1).values
        assert logits.argmax(-1).tolist() == req.tokens
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def test_decode_runs_the_paged_kernel_wrapper(weights, monkeypatch):
    """The engine's decode goes through ops.paged_attention (on the CPU its
    plain version, so the launch counters stay 0)."""
    _, state = weights
    _, tcfg = _configs()
    calls = []
    real = pa.paged_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    import k8s_device_plugin_tpu_torch.models.transformer as tf

    monkeypatch.setattr(tf, "paged_attention", spy)
    pa.reset_launches()
    eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=2, device="cpu")
    eng.run([([5, 6, 7], 4)])
    assert calls and all(shape == (2, tcfg.num_heads, tcfg.head_dim) for shape in calls)
    assert sum(pa.paged_attention.launches_by_format.values()) == 0


def test_sampled_streams_deterministic_under_seed(weights):
    _, state = weights
    _, tcfg = _configs()
    jobs = _jobs(4, seed=5)

    def run(seed):
        eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=2, seed=seed,
                            device="cpu")
        return [r.tokens for r in eng.run(jobs, temperature=1.5, top_k=50, top_p=0.9)]

    a, b, c = run(7), run(7), run(8)
    assert a == b
    assert a != c
    assert all(0 <= t < tcfg.vocab_size for row in a for t in row)


def test_top_k_one_reduces_to_greedy(weights):
    _, state = weights
    _, tcfg = _configs()
    jobs = _jobs(3, seed=6)
    greedy = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), device="cpu").run(jobs)
    topk1 = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), device="cpu").run(
        jobs, temperature=2.0, top_k=1
    )
    assert [r.tokens for r in greedy] == [r.tokens for r in topk1]


def test_filter_top_k_top_p_matches_jax():
    from k8s_device_plugin_tpu.models.engine_sampling import (
        filter_top_k_top_p as jax_filter,
    )

    rs = np.random.RandomState(0)
    logits = rs.randn(4, 64).astype(np.float32)
    top_k = np.array([1, 5, 64, 64], np.int32)
    top_p = np.array([1.0, 0.5, 0.3, 1.0], np.float32)
    want = np.asarray(jax_filter(jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = filter_top_k_top_p(torch.from_numpy(logits), torch.from_numpy(top_k),
                             torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    np.testing.assert_array_equal(np.where(got > -1e29, got, 0), np.where(want > -1e29, want, 0))


def test_derived_table_hides_unwritten_pages():
    chain = torch.tensor([[3, 4, 5, 6], [7, 8, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([[5], [0]])
    got = _derived_tables(chain, pos, page_size=4)
    assert got.tolist() == [[3, 4, 0, 0], [7, 0, 0, 0]]


def test_eos_and_stop_sequences(weights):
    _, state = weights
    _, tcfg = _configs()
    prompt = [3, 141, 59, 265, 35]
    [ref] = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), device="cpu").run([(prompt, 8)])
    eos = ref.tokens[2]
    [req] = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), eos_id=eos, device="cpu").run(
        [(prompt, 8)]
    )
    assert req.tokens == ref.tokens[: ref.tokens.index(eos) + 1]
    eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), device="cpu")
    [req] = eng.run([(prompt, 8)], stop=[ref.tokens[3:5]])
    assert req.stopped and req.tokens == ref.tokens[:3]


def test_cancel_queued_and_live(weights):
    _, state = weights
    _, tcfg = _configs()
    eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=1, device="cpu")
    live = eng.submit([1, 2, 3], 20)
    queued = eng.submit([4, 5, 6], 20)
    assert eng.cancel(queued) and queued.done
    eng.step()
    eng.step()
    assert eng.cancel(live)
    eng.step()
    assert live.done and eng.slots == [None]
    assert len(eng.free_pages) == eng.paged.num_pages - 1
    assert not eng.cancel(live)


@pytest.mark.parametrize(
    "kw, match",
    [
        ({"prompt": []}, "empty prompt"),
        ({"prompt": [600]}, "token ids"),
        ({"max_new_tokens": 0}, "max_new_tokens"),
        ({"temperature": -1.0}, "temperature"),
        ({"top_k": 0}, "top_k"),
        ({"top_p": 0.0}, "top_p"),
        ({"max_new_tokens": 60}, "max_len"),
    ],
)
def test_submit_validation(weights, kw, match):
    _, state = weights
    _, tcfg = _configs()
    eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), device="cpu")
    args = {"prompt": [1, 2], "max_new_tokens": 4, **kw}
    with pytest.raises(ValueError, match=match):
        eng.submit(args.pop("prompt"), args.pop("max_new_tokens"), **args)


def test_engine_without_device_raises_when_cuda_absent(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, state = weights
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, state, PagedConfig(4, 40, 12))


def test_batch_cli_prints_one_json_line(capsys):
    torch_engine.main([
        "--hidden=32", "--layers=1", "--heads=4", "--kv-heads=2", "--vocab=128",
        "--page-size=4", "--num-pages=32", "--max-pages-per-seq=8", "--slots=2",
        "--requests=3", "--prompt-len=6", "--max-new=4", "--device=cpu", "--dtype=float32",
    ])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    summary = json.loads(out[0])
    assert summary["metric"] == "engine_decode_tokens_per_sec"
    assert summary["requests"] == 3 and summary["tokens"] == 12
    assert summary["kernel"] is True and summary["device"] == "cpu"
    for key in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms"):
        assert summary[key] is not None and summary[key] >= 0


QUANT = {"quant": "w8", "quant_kv": True}  # the deployed pod's weights, int8 KV


@pytest.fixture(scope="module")
def qweights(weights):
    params, _ = weights
    qparams = jax.tree_util.tree_map(np.array, jax_quantize_lm_params(params))
    return qparams, convert.flax_to_state_dict(qparams)


def _decode_margins(model, prompt, tokens):
    """The port's int8-cache greedy decode of ``prompt`` feeding ``tokens``
    (the cached-append prefill the engine runs, then single steps): the
    argmax of every step and its top-2 margin."""
    cache = DenseCache.zeros(model.config, 1, "cpu", max_seq=len(prompt) + len(tokens))
    logits = [model(torch.tensor([prompt]), cache=cache, append_mode="cached")[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        pos = torch.tensor([[len(prompt) + i]])
        logits.append(model(torch.tensor([[tok]]), pos, cache=cache)[0, -1])
    top2 = torch.stack(logits).topk(2, dim=-1).values
    return torch.stack(logits).argmax(-1).tolist(), float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("prefill_chunk", [None, 4], ids=["bucket-prefill", "chunk4"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "gather"])
def test_quantized_streams_equal_jax_engine(qweights, use_kernel, prefill_chunk):
    """w8 weights and int8 KV pools: the port's engine on its kernel path
    (int8 codes and scale pools into the paged kernel's plain version) and
    on its gathered path against the JAX engine on the same path."""
    jparams, state = qweights
    jcfg, tcfg = _configs(**QUANT)
    geo = dict(page_size=4, num_pages=40, max_pages_per_seq=12)
    jobs = _jobs(5, seed=7)
    jeng = JaxEngine(jcfg, jparams, JaxPagedConfig(**geo, use_kernel=use_kernel), max_slots=3,
                     prefill_chunk=prefill_chunk)
    teng = ServingEngine(tcfg, state, PagedConfig(**geo, use_kernel=None if use_kernel else False),
                         max_slots=3, prefill_chunk=prefill_chunk, device="cpu")
    assert teng.cache.pool_k[0].dtype == torch.int8 and teng.cache.scale_k[0].shape == (40, 4, 2)
    want = [r.tokens for r in jeng.run(jobs)]
    got = [r.tokens for r in teng.run(jobs)]
    assert got == want
    assert len(teng.free_pages) == teng.paged.num_pages - 1
    for (prompt, _), tokens in zip(jobs, got):
        argmax, margin = _decode_margins(teng.model, prompt, tokens)
        assert argmax == tokens and margin > MARGIN


def test_quantized_decode_passes_scale_pools_to_the_kernel_wrapper(qweights, monkeypatch):
    """Under quant_kv the decode step hands the paged kernel int8 pools and
    their float32 scale pools."""
    _, state = qweights
    _, tcfg = _configs(**QUANT)
    seen = []
    real = pa.paged_attention

    def spy(q, pool_k, pool_v, *a, **kw):
        seen.append((pool_k.dtype, kw["scale_k"].dtype, kw["scale_v"].shape))
        return real(q, pool_k, pool_v, *a, **kw)

    import k8s_device_plugin_tpu_torch.models.transformer as tf

    monkeypatch.setattr(tf, "paged_attention", spy)
    ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=2, device="cpu").run(
        [([5, 6, 7], 4)])
    assert seen and set(seen) == {(torch.int8, torch.float32, (40, 4, 2))}


@pytest.mark.parametrize("quant", ["w8", "w8a8"])
def test_batch_cli_runs_quantized(capsys, quant):
    torch_engine.main([
        "--hidden=32", "--layers=1", "--heads=4", "--kv-heads=2", "--vocab=128",
        "--page-size=4", "--num-pages=32", "--max-pages-per-seq=8", "--slots=2",
        "--requests=3", "--prompt-len=6", "--max-new=4", "--device=cpu", "--dtype=float32",
        f"--quant={quant}", "--quant-kv",
    ])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["quant"] == quant and summary["tokens"] == 12 and summary["kernel"] is True
    args = torch_engine.parse_args(["--quant=w8", "--quant-kv", "--device=cpu"])
    assert args.quant == "w8" and args.quant_kv
