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

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import contextlib
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
from k8s_device_plugin_tpu_torch.utils import prng

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


@pytest.mark.parametrize("case", ["repeat", "equals-jax"])
def test_sampled_streams_deterministic_under_seed(weights, case):
    """Sampled streams under one ``rng`` key: the same key repeats the
    streams and another key changes them ("repeat"); and they equal the
    JAX engine's under the same key ("equals-jax"), with every draw's
    top-2 margin of logits + gumbel above MARGIN."""
    jparams, state = weights
    jcfg, tcfg = _configs()
    jobs = _jobs(4, seed=5)
    kw = dict(temperature=1.5, top_k=50, top_p=0.9)

    def run(seed):
        eng = ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=2,
                            rng=prng.PRNGKey(seed), device="cpu")
        return [r.tokens for r in eng.run(jobs, **kw)]

    if case == "repeat":
        a, b, c = run(7), run(7), run(8)
        assert a == b
        assert a != c
        assert all(0 <= t < tcfg.vocab_size for row in a for t in row)
        return
    jeng = JaxEngine(jcfg, jparams, JaxPagedConfig(4, 40, 12, use_kernel=True), max_slots=2,
                     rng=jax.random.PRNGKey(7))
    want = [r.tokens for r in jeng.run(jobs, **kw)]
    with _recorded_margins() as margins:
        got = run(7)
    assert got == want
    assert min(margins) > MARGIN


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


# ---------------------------------------------------------------------------
# Decode blocks, the overlap round and the threefry key schedule
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_margins():
    """Record the top-2 margin of logits + gumbel of every row of every
    categorical draw the port makes (decode steps and first tokens)."""
    margins, real = [], prng.categorical

    def recording(key, logits, axis=-1):
        top2 = (prng.gumbel(key, logits.shape) + logits).topk(2, dim=-1).values
        margins.extend((top2[..., 0] - top2[..., 1]).reshape(-1).tolist())
        return real(key, logits, axis)

    prng.categorical = recording
    try:
        yield margins
    finally:
        prng.categorical = real


FLAGS = [(1, 0), (1, 1), (4, 0), (16, 1)]  # (decode_block, overlap_steps)


def _block_jobs():
    """Mixed budgets (so blocks down-bucket and finishes land mid-block)
    and more jobs than slots (admissions while others decode)."""
    jobs = _jobs(6, seed=8)
    return [(p, n) for (p, _), n in zip(jobs, (21, 9, 17, 5, 12, 26))]


@pytest.fixture(scope="module")
def jax_block_engine(weights):
    """One JAX engine for every (block, overlap) case: the flags select
    host-side scheduling over the same compiled programs, and the engine
    drains to idle between runs (as the reference's shared_engine)."""
    jparams, _ = weights
    jcfg, _ = _configs()
    return JaxEngine(jcfg, jparams, JaxPagedConfig(4, 40, 12, use_kernel=True), max_slots=3,
                     decode_block=16)


def _run_jax(eng, jobs, block, overlap, seed, **kw):
    eng._decode_block, eng._overlap_steps = block, overlap
    eng._rng = jax.random.PRNGKey(seed)
    hits, discards = eng.overlap_hits, eng.overlap_discards
    tokens = [r.tokens for r in eng.run(jobs, **kw)]
    return tokens, eng.overlap_hits - hits, eng.overlap_discards - discards


def _port_engine(weights, slots=3, **kw):
    _, state = weights
    _, tcfg = _configs()
    return ServingEngine(tcfg, state, PagedConfig(4, 40, 12), max_slots=slots, device="cpu", **kw)


@pytest.mark.parametrize("block, overlap", FLAGS)
def test_greedy_streams_equal_jax_across_blocks_and_overlap(weights, jax_block_engine, block,
                                                            overlap):
    """Greedy streams equal the JAX engine's under the same decode_block
    and overlap_steps, and so does the overlap round's bookkeeping: as
    many rounds consumed from flight and as many discarded."""
    jobs = _block_jobs()
    want, hits, discards = _run_jax(jax_block_engine, jobs, block, overlap, 0)
    eng = _port_engine(weights, decode_block=block, overlap_steps=overlap)
    assert [r.tokens for r in eng.run(jobs)] == want
    assert (eng.overlap_hits, eng.overlap_discards) == (hits, discards)
    if overlap:
        assert hits + discards > 0  # rounds went out ahead of the readback
    assert eng._inflight is None and len(eng.free_pages) == eng.paged.num_pages - 1


@pytest.mark.parametrize("block, overlap", FLAGS)
def test_sampled_streams_equal_jax_across_blocks_and_overlap(weights, jax_block_engine, block,
                                                             overlap):
    """Sampled streams (temperature, top-k, top-p) equal the JAX engine's
    under the same rng and flags: the same key splits per state rebuild,
    per dispatch, per block token and per sampled first token.  Every
    draw's top-2 margin clears MARGIN, so equality cannot be luck."""
    jobs = _block_jobs()
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    want, hits, discards = _run_jax(jax_block_engine, jobs, block, overlap, 3, **kw)
    eng = _port_engine(weights, decode_block=block, overlap_steps=overlap, rng=prng.PRNGKey(3))
    with _recorded_margins() as margins:
        got = [r.tokens for r in eng.run(jobs, **kw)]
    assert got == want
    assert (eng.overlap_hits, eng.overlap_discards) == (hits, discards)
    assert min(margins) > MARGIN


def test_greedy_streams_identical_across_blocks_and_overlap(weights):
    """Every (block, overlap) pair of 1/4/16 x 0/1 gives the block-1
    synchronous streams."""
    jobs = _block_jobs()
    ref = [r.tokens for r in _port_engine(weights, overlap_steps=0).run(jobs)]
    for block in (1, 4, 16):
        for overlap in (0, 1):
            eng = _port_engine(weights, decode_block=block, overlap_steps=overlap)
            assert [r.tokens for r in eng.run(jobs)] == ref, (block, overlap)


def test_decode_block_eos_and_max_new_mid_block(weights):
    """EOS mid-block truncates there; an odd budget down-buckets the block
    without overrunning it; a stop sequence inside a block truncates
    there; the pool drains clean."""
    prompt = [3, 141, 59]
    [ref] = _port_engine(weights, overlap_steps=0).run([(prompt, 8)])
    want = ref.tokens
    eng = _port_engine(weights, eos_id=want[2], decode_block=4)
    [req] = eng.run([(prompt, 8)])
    assert req.done and req.tokens == want[: want.index(want[2]) + 1]
    assert len(eng.free_pages) == eng.paged.num_pages - 1
    [odd] = _port_engine(weights, decode_block=4).run([(prompt, 5)])
    assert odd.tokens == want[:5]
    eng = _port_engine(weights, decode_block=4)
    [stopped] = eng.run([(prompt, 8)], stop=[[want[2]]])
    first = want.index(want[2])
    assert stopped.stopped and stopped.tokens == want[:first]
    assert len(eng.free_pages) == eng.paged.num_pages - 1


def test_decode_block_composes_with_window_and_small_pages(weights):
    """Page size 2 < T = 4 and a sliding window of 4: blocks cross page
    boundaries and reclamation frees scrolled pages between blocks; the
    streams equal the JAX engine's at the same flags."""
    jparams, state = weights
    jcfg, tcfg = _configs(attention_window=4)
    jobs = [([3, 141, 59], 12), ([9, 10], 9)]
    jeng = JaxEngine(jcfg, jparams, JaxPagedConfig(2, 24, 12, use_kernel=True), max_slots=2,
                     decode_block=4)
    want = [r.tokens for r in jeng.run(jobs)]
    eng = ServingEngine(tcfg, state, PagedConfig(2, 24, 12), max_slots=2, decode_block=4,
                        device="cpu")
    assert [r.tokens for r in eng.run(jobs)] == want
    assert len(eng.free_pages) == eng.paged.num_pages - 1


def test_decode_block_stays_fine_grained_under_churn(weights):
    """With queued work that could admit, the engine single-steps: a late
    submission joins mid-decode and both streams equal their solo runs."""
    eng = _port_engine(weights, slots=2, decode_block=8)
    early = eng.submit([3, 141, 59], 24)
    eng.step()
    assert not early.done
    late = eng.submit([400, 2, 2, 17], 6)
    seen_occupied = False
    for _ in range(1000):
        eng.step()
        seen_occupied = seen_occupied or all(s is not None for s in eng.slots)
        if early.done and late.done:
            break
    assert seen_occupied and early.done and late.done
    solo = _port_engine(weights, overlap_steps=0)
    assert early.tokens == solo.run([([3, 141, 59], 24)])[0].tokens
    assert late.tokens == solo.run([([400, 2, 2, 17], 6)])[0].tokens
    assert len(eng.free_pages) == eng.paged.num_pages - 1


def _count_steps(eng, reqs):
    steps = 0
    while not all(r.done for r in reqs):
        eng.step()
        steps += 1
        assert steps < 500
    return steps


def test_decode_blocks_engage_while_saturated_with_queue(weights):
    """Every slot busy and a request queued: blocks stay on (nothing can
    admit before a finish); 3 x 12 tokens through 2 slots in <= 12 steps."""
    prompts = [[3, 141, 59], [9, 10], [7, 5, 2]]
    eng = _port_engine(weights, slots=2, decode_block=4)
    reqs = [eng.submit(p, 12) for p in prompts]
    assert _count_steps(eng, reqs) <= 12
    solo = _port_engine(weights, overlap_steps=0)
    assert [r.tokens for r in reqs] == [r.tokens for r in solo.run([(p, 12) for p in prompts])]


def test_decode_blocks_engage_while_page_blocked(weights):
    """A free slot but a page-blocked head (reserve admission broke on the
    pool): blocks stay on for the running request, 2 x 28 tokens in <= 24
    steps."""
    _, state = weights
    _, tcfg = _configs()
    eng = ServingEngine(tcfg, state, PagedConfig(4, 10, 8), max_slots=2, decode_block=4,
                        device="cpu")
    p1 = eng.submit([3, 141, 59, 265], 28)
    p2 = eng.submit([9, 10, 2, 4], 28)
    assert _count_steps(eng, [p1, p2]) <= 24
    solo = _port_engine(weights, overlap_steps=0)
    assert p1.tokens == solo.run([([3, 141, 59, 265], 28)])[0].tokens
    assert p2.tokens == solo.run([([9, 10, 2, 4], 28)])[0].tokens


def test_steady_state_feeds_device_outputs_forward(weights, monkeypatch):
    """Pure decode never rebuilds the step state from the host lists: one
    rebuild at the activation, the state advanced by each dispatch, and
    the finish's teardown dirties it."""
    eng = _port_engine(weights, slots=1)
    req = eng.submit([3, 141, 59], 12)
    eng.step()
    first = eng._dev
    assert first is not None and eng.state_rebuilds == 1
    dirty = []
    monkeypatch.setattr(eng, "_mark_state_dirty", lambda: dirty.append(1))
    for _ in range(5):
        eng.step()
    assert not dirty and eng.state_rebuilds == 1
    assert eng._dev is not None and eng._dev is not first
    monkeypatch.undo()
    while not req.done:
        eng.step()
    assert eng._dev is None
    assert req.tokens == _port_engine(weights, overlap_steps=0).run([([3, 141, 59], 12)])[0].tokens


def test_greedy_overlap_equals_sync(weights):
    """overlap_steps 1 and 0 give the same streams; the overlapped run
    consumes rounds from flight, the synchronous one never does."""
    jobs = [([3, 141, 59], 8), ([9, 10], 6)]
    over = _port_engine(weights, slots=2)
    sync = _port_engine(weights, slots=2, overlap_steps=0)
    assert [r.tokens for r in over.run(jobs)] == [r.tokens for r in sync.run(jobs)]
    assert over.overlap_hits > 0 and over._inflight is None
    assert sync.overlap_hits == sync.overlap_discards == 0


def test_overlap_discards_on_cancel_and_admission_churn(weights):
    """An admission and a cancel while a round is in flight each discard
    it (counted, with the carried seq_lens repaired), never a wrong or
    lost token: the survivors' streams equal their solo decode."""
    eng = _port_engine(weights, slots=2)
    survivor = eng.submit([3, 141, 59], 20)
    eng.step()
    eng.step()  # one round in flight
    victim = eng.submit([9, 10], 12)
    eng.step()
    eng.cancel(victim)
    late = eng.submit([9, 10], 6)
    while not all(r.done for r in (survivor, victim, late)):
        eng.step()
    assert victim.cancelled and victim.done
    assert eng.overlap_discards > 0 and eng.discards_by_reason["state_dirty"] > 0
    assert len(eng.free_pages) == eng.paged.num_pages - 1
    assert (eng._chain == 0).all() and (eng.cache.seq_lens == 0).all()
    solo = _port_engine(weights, overlap_steps=0)
    assert survivor.tokens == solo.run([([3, 141, 59], 20)])[0].tokens
    assert late.tokens == solo.run([([9, 10], 6)])[0].tokens


@pytest.mark.parametrize(
    "kw, match",
    [
        ({"decode_block": 3}, "power of two"),
        ({"decode_block": 0}, "power of two"),
        ({"overlap_steps": 2}, "overlap_steps"),
        ({"cuda_graphs": True}, "cuda_graphs"),
    ],
)
def test_decode_block_validation(weights, kw, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(weights, **kw)


def test_batch_cli_block16_overlap_json(capsys):
    """The CLI's block-16 overlapped tiny run reports its flags and the
    overlap round's counts; --cuda-graphs is refused on the CPU."""
    argv = [
        "--hidden=32", "--layers=1", "--heads=4", "--kv-heads=2", "--vocab=128",
        "--page-size=4", "--num-pages=32", "--max-pages-per-seq=12", "--slots=2",
        "--requests=3", "--prompt-len=6", "--max-new=20", "--device=cpu", "--dtype=float32",
        "--decode-block=16", "--overlap-steps=1",
    ]
    torch_engine.main(argv)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["decode_block"] == 16 and summary["overlap_steps"] == 1
    assert summary["tokens"] == 60 and summary["cuda_graphs"] is False
    assert summary["overlap_hits"] + summary["overlap_discards"] > 0
    assert summary["state_rebuilds"] > 0 and summary["graph_replays"] == 0
    with pytest.raises(SystemExit):
        torch_engine.parse_args(["--device=cpu", "--cuda-graphs=1"])
