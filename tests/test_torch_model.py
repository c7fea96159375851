"""The PyTorch TransformerLM against the JAX TransformerLM.

Parameters come from flax's own init (seeded) and reach the port through
``convert.flax_to_state_dict``; token ids come from numpy with a seed.

Tolerances: logits within 2e-4 absolute.  Both models run float32 at
``GPTConfig.tiny()`` widths (hidden 64, 2 layers); the frameworks sum in
different orders, which moves f32 logits of magnitude ~1-10 by ~1e-6 per
layer.  Greedy tokens are compared exactly, with an assertion that every
emitted token's top-2 margin clears 1e-4, so a near-tie cannot flake.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import transformer as ttf

LOGIT_TOL = 2e-4
MARGIN = 1e-4


def _cfgs(**kw):
    base = dict(max_seq=160, num_kv_heads=2, **kw)
    return (
        dataclasses.replace(jtf.GPTConfig.tiny(), **base),
        dataclasses.replace(ttf.GPTConfig.tiny(), **base),
    )


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    params = jtf.TransformerLM(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, convert.flax_to_state_dict(params)


def _torch_model(tcfg, state):
    model = ttf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(state)
    return model


def _ids(batch, seq, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, size=(batch, seq)).astype(np.int32)


def test_config_fields_mirror_the_reference():
    for jcls, tcls in ((jtf.GPTConfig, ttf.GPTConfig), (jtf.PagedConfig, ttf.PagedConfig)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls) if f.name != "dtype"]
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls) if f.name != "dtype"]
        assert tf == jf, tcls.__name__
    j, t = jtf.GPTConfig.tiny(), ttf.GPTConfig.tiny()
    assert {**dataclasses.asdict(j), "dtype": None} == {**dataclasses.asdict(t), "dtype": None}
    assert str(t.dtype) == f"torch.{jnp.dtype(j.dtype).name}"
    assert ttf.PagedConfig().kernel_enabled() is True  # auto -> the kernel
    assert ttf.PagedConfig(use_kernel=False).kernel_enabled() is False


def test_convert_keeps_flax_names_and_layouts(weights):
    params, state = weights
    _, tcfg = _cfgs()
    assert {k: tuple(v.shape) for k, v in state.items()} == ttf.param_shapes(tcfg)
    assert state["layer_0.attn.query.kernel"].shape == (64, 4, 16)
    assert state["layer_1.attn.out.kernel"].shape == (4, 16, 64)
    assert state["lm_head.kernel"].shape == (64, 512)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(state)
    for path, leaf in flat:
        name = ".".join(key.key for key in path)
        np.testing.assert_array_equal(state[name].numpy(), leaf)


def test_rmsnorm_and_rope_match_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 64).astype(np.float32)
    scale = rs.randn(64).astype(np.float32)
    want = jtf.RMSNorm(dtype=jnp.float32).apply({"params": {"scale": scale}}, x)
    norm = ttf.RMSNorm(64, torch.float32)
    norm.scale.data = torch.from_numpy(scale)
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    pos = np.arange(10)[None, :].repeat(2, 0)
    xh = rs.randn(2, 10, 4, 16).astype(np.float32)
    jc, js = jtf.rope_angles(jnp.asarray(pos), 16, 10000.0)
    tc, ts = ttf.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ttf.apply_rope(torch.from_numpy(xh), tc, ts).numpy(),
        np.asarray(jtf.apply_rope(jnp.asarray(xh), jc, js)), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("window", [None, 5])
def test_cached_group_attention_matches_reference(window):
    rs = np.random.RandomState(1)
    q = rs.randn(2, 3, 8, 16).astype(np.float32)
    k = rs.randn(2, 12, 2, 16).astype(np.float32)
    v = rs.randn(2, 12, 2, 16).astype(np.float32)
    pos = np.array([[4, 5, 6], [9, 10, 11]])
    want = jtf.cached_group_attention(*map(jnp.asarray, (q, k, v, pos)), window, 8)
    got = ttf.cached_group_attention(*map(torch.from_numpy, (q, k, v, pos)), window, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "seq, window", [(24, None), (24, 7), (128, None)], ids=["s24", "s24-window7", "s128-flash"]
)
def test_full_forward_logits_match(weights, seq, window):
    """s=128 takes the flash path on both sides (the interpreted Pallas
    kernel vs the port's plain flash version); at s=24 the reference takes
    its mha_reference and the port still its flash version."""
    params, state = weights
    jcfg, tcfg = _cfgs(attention_window=window)
    ids = _ids(2, seq, seed=seq)
    want = np.asarray(jtf.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(ids)))
    got = _torch_model(tcfg, state)(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, seq, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


def _jax_decode(jcfg, params, ids, n_steps, append_mode="auto"):
    """Logits of a bulk prefill over ``ids`` then ``n_steps`` single-token
    steps feeding ids from the prompt's continuation columns."""
    model = jtf.TransformerLM(jcfg, decode=True, append_mode=append_mode)
    spec = jtf.decode_cache_spec(model, ids.shape[0])
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    plen = ids.shape[1] - n_steps
    pos = jnp.broadcast_to(jnp.arange(plen), (ids.shape[0], plen))
    out, mut = model.apply({"params": params, "cache": cache}, jnp.asarray(ids[:, :plen]),
                           pos, mutable=["cache"])
    logits = [np.asarray(out[:, -1])]
    for t in range(plen, ids.shape[1]):
        out, mut = model.apply(
            {"params": params, "cache": mut["cache"]}, jnp.asarray(ids[:, t : t + 1]),
            jnp.full((ids.shape[0], 1), t), mutable=["cache"],
        )
        logits.append(np.asarray(out[:, -1]))
    return np.stack(logits, 1)


@pytest.mark.parametrize("append_mode", ["auto", "cached"])
def test_dense_decode_logits_match(weights, append_mode):
    params, state = weights
    jcfg, tcfg = _cfgs()
    ids = _ids(2, 14, seed=3)
    want = _jax_decode(jcfg, params, ids, 4, append_mode)
    model = _torch_model(tcfg, state)
    cache = ttf.DenseCache.zeros(tcfg, 2, "cpu")
    t_ids = torch.from_numpy(ids).long()
    got = [model(t_ids[:, :10], cache=cache, append_mode=append_mode)[:, -1]]
    for t in range(10, 14):
        got.append(model(t_ids[:, t : t + 1], torch.full((2, 1), t), cache=cache)[:, -1])
    assert cache.index == 14
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("prompt_len", [12, 128], ids=["mha-prefill", "flash-prefill"])
def test_greedy_generate_tokens_equal(weights, prompt_len):
    params, state = weights
    jcfg, tcfg = _cfgs()
    ids = _ids(2, prompt_len, seed=4)
    want = np.asarray(jtf.greedy_generate(jcfg, params, jnp.asarray(ids), 8))
    got = ttf.greedy_generate(tcfg, state, torch.from_numpy(ids), 8, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # No emitted token is a near-tie in the port's full forward.
    logits = _torch_model(tcfg, state)(got[:, :-1])[:, prompt_len - 1 :]
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MARGIN
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want[:, prompt_len:])


@pytest.mark.parametrize("window", [None, 6])
def test_paged_kernel_path_equals_gather_and_dense(weights, window):
    """Paged decode through the kernel wrapper (its plain version on the
    CPU), through the gathered view, and through the dense cache give the
    same logits; the append lands at the carried seq_lens."""
    _, state = weights
    _, tcfg = _cfgs(attention_window=window)
    ids = torch.from_numpy(_ids(2, 6, seed=5)).long()
    results = []
    for use_kernel in (None, False):
        paged = ttf.PagedConfig(page_size=4, num_pages=8, max_pages_per_seq=3,
                                use_kernel=use_kernel, kernel_num_splits=2)
        model = _torch_model(dataclasses.replace(tcfg, paged=paged), state)
        cache = ttf.PagedCache.zeros(model.config, paged, 2, "cpu")
        cache.page_table = torch.tensor([[1, 2, 3], [5, 4, 6]], dtype=torch.int32)
        steps = []
        for t in range(6):
            steps.append(model(ids[:, t : t + 1], torch.full((2, 1), t), cache=cache)[:, -1])
        assert cache.seq_lens.tolist() == [6, 6]
        results.append(torch.stack(steps, 1))
    dense = _torch_model(tcfg, state)
    dcache = ttf.DenseCache.zeros(tcfg, 2, "cpu")
    want = torch.stack(
        [dense(ids[:, t : t + 1], torch.full((2, 1), t), cache=dcache)[:, -1] for t in range(6)], 1
    )
    for got in results:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LOGIT_TOL)


def test_unported_options_raise():
    """Every option of the reference's config builds since LoRA came in:
    the quantized formats, ``lora_rank`` and ``lora_serve``; the reference
    refuses quant with lora_rank and lora_serve without a rank, and so does
    the port."""
    _, tcfg = _cfgs()
    for kw in ({"quant": "w8"}, {"quant": "w8a8"}, {"quant_kv": True},
               {"quant": "w8", "quant_kv": True}, {"lora_rank": 4},
               {"lora_rank": 4, "lora_serve": 2}):
        ttf.TransformerLM(dataclasses.replace(tcfg, **kw), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ttf.TransformerLM(dataclasses.replace(tcfg, quant="w8", lora_rank=4), device="cpu")
    with pytest.raises(ValueError, match="lora_serve requires lora_rank"):
        ttf.TransformerLM(dataclasses.replace(tcfg, lora_serve=2), device="cpu")
    with pytest.raises(ValueError, match="quant must be"):
        ttf.TransformerLM(dataclasses.replace(tcfg, quant="w4"), device="cpu")


@pytest.mark.parametrize("field, value", [("lora_rank", 4), ("lora_serve", 2)])
def test_lora_fields_build_a_model(weights, field, value):
    """``lora_rank`` and ``lora_serve`` (with a rank) build a model whose
    init has zero B, so its logits equal the plain model's on the same base
    weights (every row at adapter -1 for a serving model)."""
    params, state = weights
    jcfg, tcfg = _cfgs()
    kw = {"lora_rank": 4} if field == "lora_rank" else {"lora_rank": 4, "lora_serve": value}
    lcfg = dataclasses.replace(tcfg, **kw)
    lstate = ttf.init_params(lcfg)
    lstate.update(state)
    model = _torch_model(lcfg, lstate)
    ids = _ids(2, 9)
    want = np.asarray(jtf.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(ids)))
    got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_model_without_device_raises_when_cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.TransformerLM(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.greedy_generate(tcfg, ttf.init_params(tcfg), [[1, 2]], 2)


def test_init_params_is_seeded_and_loadable():
    _, tcfg = _cfgs()
    a, b = ttf.init_params(tcfg, seed=3), ttf.init_params(tcfg, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.embedding"], ttf.init_params(tcfg, seed=4)["embed.embedding"])
    _torch_model(tcfg, a)


# ------------------------------------------------------- quantized serving
#
# Weights: the JAX package's quantize_lm_params of the flax init, carried
# across by convert.py.  w8 logits differ by float sum order only (2e-4 as
# above).  KV and w8a8 activation codes are computed from activations that
# differ by ~1e-7 between the frameworks, so a code a hair from a rounding
# boundary may land one step apart; the same 2e-4 holds on these seeds.


@pytest.fixture(scope="module")
def qweights(weights):
    from k8s_device_plugin_tpu.ops.quant import quantize_lm_params

    params, _ = weights
    qparams = jax.tree_util.tree_map(np.array, quantize_lm_params(params))
    return qparams, convert.flax_to_state_dict(qparams)


@pytest.mark.parametrize("quant", ["w8", "w8a8"])
@pytest.mark.parametrize("seq", [24, 128], ids=["s24", "s128-flash"])
def test_quantized_full_forward_logits_match(qweights, quant, seq):
    params, state = qweights
    jcfg, tcfg = _cfgs(quant=quant)
    assert {k: tuple(v.shape) for k, v in state.items()} == ttf.param_shapes(tcfg)
    assert state["lm_head.kernel_q"].dtype == torch.int8
    ids = _ids(2, seq, seed=10)
    want = np.asarray(jtf.TransformerLM(jcfg).apply({"params": params}, jnp.asarray(ids)))
    got = _torch_model(tcfg, state)(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, seq, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("append_mode", ["auto", "cached"])
@pytest.mark.parametrize("quant", [None, "w8"])
def test_quant_kv_dense_decode_logits_match(weights, qweights, quant, append_mode):
    """int8 dense cache: the bulk prefill ("auto") attends over the
    unquantized K/V, the cached append and each decode step over the
    dequantized cache, and the codes and scales equal the reference's."""
    params, state = qweights if quant else weights
    jcfg, tcfg = _cfgs(quant=quant, quant_kv=True)
    ids = _ids(2, 14, seed=11)
    want = _jax_decode(jcfg, params, ids, 4, append_mode)
    model = _torch_model(tcfg, state)
    cache = ttf.DenseCache.zeros(tcfg, 2, "cpu")
    assert cache.keys[0].dtype == torch.int8 and cache.key_scales[0].shape == (2, 160, 2)
    t_ids = torch.from_numpy(ids).long()
    got = [model(t_ids[:, :10], cache=cache, append_mode=append_mode)[:, -1]]
    for t in range(10, 14):
        got.append(model(t_ids[:, t : t + 1], torch.full((2, 1), t), cache=cache)[:, -1])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want, rtol=0, atol=LOGIT_TOL)


def _jax_paged_decode(jcfg, params, ids, table):
    """Per-step logits of single-token paged decode steps in the JAX model,
    every layer's page table set to ``table``."""
    model = jtf.TransformerLM(jcfg, decode=True)
    spec = jtf.decode_cache_spec(model, ids.shape[0])
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    cache = {name: {"attn": {**layer["attn"], "page_table": jnp.asarray(table)}}
             for name, layer in cache.items()}
    logits = []
    for t in range(ids.shape[1]):
        out, mut = model.apply({"params": params, "cache": cache}, jnp.asarray(ids[:, t : t + 1]),
                               jnp.full((ids.shape[0], 1), t), mutable=["cache"])
        cache = mut["cache"]
        logits.append(np.asarray(out[:, -1]))
    return np.stack(logits, 1), cache


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "gather"])
def test_quant_kv_paged_decode_logits_match(qweights, use_kernel):
    """int8 page pools with w8 weights: the kernel path (int8 codes and
    scale pools into the paged kernel's plain version, the reference's XLA
    lane on its side) and the gathered dequantized view, against the JAX
    model; the pools' codes and scales equal the reference's."""
    params, state = qweights
    geo = dict(page_size=4, num_pages=8, max_pages_per_seq=3, kernel_num_splits=2)
    jcfg, tcfg = _cfgs(quant="w8", quant_kv=True)
    jcfg = dataclasses.replace(jcfg, paged=jtf.PagedConfig(**geo, use_kernel=use_kernel))
    tcfg = dataclasses.replace(tcfg, paged=ttf.PagedConfig(**geo, use_kernel=use_kernel))
    ids = _ids(2, 9, seed=12)
    table = np.array([[1, 2, 3], [5, 4, 6]], np.int32)
    want, jcache = _jax_paged_decode(jcfg, params, ids, table)
    model = _torch_model(tcfg, state)
    cache = ttf.PagedCache.zeros(tcfg, tcfg.paged, 2, "cpu")
    cache.page_table = torch.from_numpy(table)
    got = torch.stack([model(torch.from_numpy(ids[:, t : t + 1]).long(), torch.full((2, 1), t),
                             cache=cache)[:, -1] for t in range(9)], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    attn = jcache["layer_1"]["attn"]
    for name, mine in (("pool_key", cache.pool_k[1]), ("pool_value", cache.pool_v[1])):
        theirs = np.asarray(attn[name])
        assert mine.numpy().dtype == theirs.dtype == np.int8
        # A code may sit one step apart where a value lies a hair from a
        # rounding boundary; nearly all are equal.
        assert np.mean(mine.numpy() == theirs) > 0.99
    # Scales are amax / 127 of activations that differ by ~1e-7 relative.
    for name, mine in (("pool_key_scale", cache.scale_k[1]), ("pool_value_scale", cache.scale_v[1])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(attn[name]), rtol=1e-5, atol=0)


def _shaped(head_dim, page_size=None, heads=4, kv_heads=2):
    paged = None if page_size is None else ttf.PagedConfig(page_size, 8, 4)
    return dataclasses.replace(ttf.GPTConfig.tiny(), hidden_size=heads * head_dim,
                               num_heads=heads, num_kv_heads=kv_heads, paged=paged)


def _builds_on_card(monkeypatch, cfg):
    """Building ``cfg`` on "cuda" passes every check of the model and
    reaches its first allocation on the card.  Without a card that
    allocation is torch's own error, which names CUDA (never a
    ValueError); with one, the model builds."""
    monkeypatch.setattr(ttf, "resolve_device", lambda device=None: torch.device("cuda"))
    if torch.cuda.is_available():
        ttf.TransformerLM(cfg)
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ttf.TransformerLM(cfg)
    monkeypatch.undo()


def _dense_decode(q, pool_k, pool_v, table, lens):
    """Single-token attention over each row's first ``lens`` positions,
    its pages gathered and laid end to end: the paged kernel's function
    without pages or splits, float64."""
    batch, heads, head_dim = q.shape
    kv_heads = pool_k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float64)
    for b in range(batch):
        n = int(lens[b])
        k = pool_k[table[b].long()].reshape(-1, kv_heads, head_dim)[:n].double()
        v = pool_v[table[b].long()].reshape(-1, kv_heads, head_dim)[:n].double()
        for h in range(heads):
            hk = h // (heads // kv_heads)
            p = torch.softmax(k[:, hk] @ q[b, h].double() * head_dim ** -0.5, dim=0)
            out[b, h] = p @ v[:, hk]
    return out


@pytest.mark.parametrize("page_size", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("head_dim", list(range(8, 129, 8)))
def test_card_takes_every_head_dim_and_page_size(monkeypatch, head_dim, page_size):
    """The shapes the card's kernels took before they took every shape:
    each still builds on the card, and at each the paged kernel's plain
    version (what the wrapper runs for CPU tensors, at the tuned split
    count) equals dense attention over the rows' pages within 1e-5."""
    from k8s_device_plugin_tpu_torch.ops.paged_attention import paged_attention

    _builds_on_card(monkeypatch, _shaped(head_dim, page_size))
    gen = torch.Generator().manual_seed(head_dim * 1000 + page_size)
    batch, heads, kv_heads, mpp = 2, 4, 2, 4
    q = torch.randn((batch, heads, head_dim), generator=gen)
    pool_k, pool_v = (torch.randn((batch * mpp + 1, page_size, kv_heads, head_dim),
                                  generator=gen) for _ in range(2))
    table = (torch.randperm(batch * mpp, generator=gen) + 1).reshape(batch, mpp).int()
    lens = torch.tensor([1, page_size * mpp - page_size // 2], dtype=torch.int32)
    got = paged_attention(q, pool_k, pool_v, table, lens)
    want = _dense_decode(q, pool_k, pool_v, table, lens)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=1e-5)


# (head_dim, page size, heads, kv heads): the shapes the card's kernels
# refused until they took every shape the reference takes.
OTHER_SHAPES = {
    "d4": (4, 4, 4, 2),
    "d20": (20, 4, 4, 2),
    "d136": (136, 4, 4, 2),
    "d256": (256, 4, 4, 2),
    "page12": (64, 12, 4, 2),
    "page256": (64, 256, 4, 2),
    "group64": (16, 4, 64, 1),
    "d384": (384, 4, 2, 1),
    "group48": (8, 12, 48, 1),
}


@pytest.mark.parametrize("shape", OTHER_SHAPES.values(), ids=OTHER_SHAPES.keys())
def test_card_builds_other_shapes_at_construction(monkeypatch, shape):
    """head_dims that are no multiple of 8 or pass 128, page sizes that are
    no power of two or pass 128, and kv groups past 32 build on the card
    (the reference refuses none of them), and their plain path serves the
    JAX engine's greedy tokens: both engines run float32 on weights from
    flax's init through ``convert.py``, two prompts, page table and split
    math as the kernels'."""
    from k8s_device_plugin_tpu.models.engine import ServingEngine as JaxEngine
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine

    head_dim, page_size, heads, kv_heads = shape
    _builds_on_card(monkeypatch, _shaped(head_dim, page_size, heads=heads, kv_heads=kv_heads))
    kw = dict(hidden_size=heads * head_dim, num_heads=heads, num_kv_heads=kv_heads,
              intermediate_size=128, max_seq=64)
    jcfg = dataclasses.replace(jtf.GPTConfig.tiny(), **kw)
    tcfg = dataclasses.replace(ttf.GPTConfig.tiny(), **kw)
    params = jtf.TransformerLM(jcfg).init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    per_seq = -(-64 // page_size)
    geo = dict(page_size=page_size, num_pages=2 * per_seq + 1, max_pages_per_seq=per_seq,
               kernel_num_splits=2)
    jobs = [(_ids(1, 11, seed=head_dim + page_size)[0].tolist(), 6),
            (_ids(1, 7, seed=heads)[0].tolist(), 5)]
    want = JaxEngine(jcfg, params, jtf.PagedConfig(**geo, use_kernel=True), max_slots=2).run(jobs)
    got = ServingEngine(tcfg, convert.flax_to_state_dict(params), ttf.PagedConfig(**geo),
                        max_slots=2, device="cpu").run(jobs)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [len(r.tokens) for r in got] == [n for _, n in jobs]


def test_gather_engine_needs_no_paged_shape(monkeypatch):
    """With the paged kernel off (use_kernel=False) the gathered view runs
    at any page size, on the card as on the CPU."""
    cfg = dataclasses.replace(_shaped(64), paged=ttf.PagedConfig(12, 8, 4, use_kernel=False))
    _builds_on_card(monkeypatch, cfg)
    ttf.TransformerLM(cfg, device="cpu")


@pytest.mark.parametrize("fmt", ["f32", "int8", "int4"])
def test_gather_pages_matches_reference_dequant(fmt):
    """The gather path's view (``gather_pages``): each row's pages read
    through the table in order, dequantized as the reference's
    ``dequantize_kv`` / ``dequantize_kv4`` do.  Codes and scales come from
    the reference's quantizers; float32 throughout, so the views agree to
    1e-6 (one product a value)."""
    from k8s_device_plugin_tpu.ops import quant as jq

    rng = np.random.RandomState(3)
    pages, page, kv_heads, head_dim, batch, per_row = 9, 4, 2, 8, 2, 4
    pool = rng.randn(pages, page, kv_heads, head_dim).astype(np.float32)
    table = (rng.permutation(pages - 1)[: batch * per_row] + 1).reshape(batch, per_row)
    if fmt == "f32":
        codes, scales, dequant = pool, None, None
    else:
        quantize, dequant = ((jq.quantize_kv, jq.dequantize_kv) if fmt == "int8"
                             else (jq.quantize_kv4, jq.dequantize_kv4))
        codes, scales = (np.asarray(a) for a in quantize(jnp.asarray(pool)))
    rows = codes[table].reshape(batch, per_row * page, kv_heads, -1)
    want = rows if scales is None else np.asarray(dequant(
        jnp.asarray(rows), jnp.asarray(scales[table].reshape(rows.shape[:-1])), jnp.float32))
    got = ttf.gather_pages(torch.from_numpy(codes),
                           None if scales is None else torch.from_numpy(scales),
                           torch.from_numpy(table.astype(np.int32)), torch.float32,
                           int4=fmt == "int4")
    assert got.shape == (batch, per_row * page, kv_heads, head_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
