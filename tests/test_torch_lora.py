"""The port's LoRA (k8s_device_plugin_tpu_torch/models/lora.py) and
multi-LoRA serving against the JAX package's, on the CPU.

Inputs come from numpy with a seed and the weights from flax's own init
(adapters with nonzero ``lora_b``, so each adapter changes the tokens),
carried into the port by ``convert.flax_to_state_dict``.  GPTConfig.tiny()
in float32.

Tolerances: module outputs within 2e-5 absolute and model logits within
2e-4 (f32 sum order over a few hundred terms and two layers, as
tests/test_torch_model.py); merged kernels within 1e-6.  Greedy tokens are compared exactly, and every emitted token's
top-2 logit margin on the port's own decode clears 1e-4, so a near-tie
cannot flake the equality.  The cases follow the reference's
tests/test_lora.py and tests/test_multi_lora.py: the modules with -1 rows,
the stacked tree, the merge, the engine at decode block 1 and 16 with the
overlap round off and on, the per-adapter prefix trie, snapshots and
handoffs carrying adapter roots both ways, and the HTTP server with
``--adapters`` against the JAX server on the same trees (orbax for JAX, the
port's torch.save directories for the port).
"""

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import checkpoint as jax_ckpt
from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import engine_snapshot as jax_snap
from k8s_device_plugin_tpu.models import http_server as jax_http
from k8s_device_plugin_tpu.models import lora as jax_lora
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import checkpoint as port_ckpt
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import engine_handoff as handoff
from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap
from k8s_device_plugin_tpu_torch.models import http_server as port_http
from k8s_device_plugin_tpu_torch.models import lora
from k8s_device_plugin_tpu_torch.models import transformer as port_tf

TOL = 2e-5
LOGIT_TOL = 2e-4
MARGIN = 1e-4
RANK, N_ADAPTERS = 2, 2
PAGED = dict(page_size=4, num_pages=40, max_pages_per_seq=12)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(tree, seed):
    """Fresh seeded ``lora_a`` and ``lora_b`` leaves (init's zero B is a
    no-op, useless for telling adapters apart)."""
    rs = np.random.RandomState(seed)

    def walk(t):
        if not isinstance(t, dict):
            return t
        return {k: (0.1 * rs.standard_normal(v.shape)).astype(np.float32)
                if k in ("lora_a", "lora_b") else walk(v) for k, v in sorted(t.items())}

    return walk(tree)


def _cfgs(**kw):
    """GPTConfig.tiny() at the geometry the serving CLI derives from its
    flags (intermediate 3 x hidden, max_seq = page x pages per sequence)."""
    base = dict(max_seq=48, num_kv_heads=2, intermediate_size=192, **kw)
    return (dataclasses.replace(jax_tf.GPTConfig.tiny(), **base),
            dataclasses.replace(port_tf.GPTConfig.tiny(), **base))


@pytest.fixture(scope="module")
def trees():
    """(base plain tree, adapter LoRA trees, JAX stacked serving tree) as
    numpy, and the port's stacked state dict."""
    jcfg, _ = _cfgs(lora_rank=RANK)
    lora_tree = _np(jax_tf.TransformerLM(jcfg).init(jax.random.PRNGKey(7),
                                                    jnp.zeros((1, 8), jnp.int32))["params"])
    adapters = [_randomize(lora_tree, 100 + i) for i in range(N_ADAPTERS)]
    base = _np(jax_lora.merge_lora_params(lora_tree, alpha=jcfg.lora_alpha))
    stacked = _np(jax_lora.stack_lora_adapters(lora_tree, adapters))
    port_stacked = lora.stack_lora_adapters(
        convert.flax_to_state_dict(base), [convert.flax_to_state_dict(a) for a in adapters])
    return base, adapters, stacked, port_stacked


# ----------------------------------------------------------------- modules

SITES = {  # (input shape past the batch, in_shape, features)
    "qkv": ((3, 64), (64,), (4, 16)),
    "out": ((3, 4, 16), (4, 16), (64,)),
    "mlp": ((3, 64), (64,), (192,)),
}


def _axis(in_shape):
    return tuple(range(-len(in_shape), 0)) if len(in_shape) > 1 else -1


@pytest.mark.parametrize("site", list(SITES))
def test_lora_dense_matches_jax(site):
    shape, in_shape, feats = SITES[site]
    x = np.random.RandomState(1).standard_normal((2, *shape)).astype(np.float32)
    mod = jax_lora.LoRADense(features=feats, rank=RANK, axis=_axis(in_shape), dtype=jnp.float32)
    params = _randomize(_np(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 3)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    port = lora.LoRADense(in_shape, feats, RANK, 16.0, torch.float32)
    port.load_state_dict(convert.flax_to_state_dict(params))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert np.abs(want).max() > 0 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("site", list(SITES))
def test_multi_lora_dense_matches_jax_with_base_rows(site):
    """Rows pick adapters [2, -1, 0, 1]: each row equals the reference's,
    and the -1 row equals the base product exactly."""
    shape, in_shape, feats = SITES[site]
    x = np.random.RandomState(2).standard_normal((4, *shape)).astype(np.float32)
    ids = np.array([2, -1, 0, 1], np.int32)
    mod = jax_lora.MultiLoRADense(features=feats, rank=RANK, n_adapters=3,
                                  axis=_axis(in_shape), dtype=jnp.float32)
    params = _np(mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ids))["params"])
    rs = np.random.RandomState(4)
    params["lora_b_stack"] = (0.3 * rs.standard_normal(params["lora_b_stack"].shape)).astype(
        np.float32)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ids)))
    port = lora.MultiLoRADense(in_shape, feats, RANK, 3, 16.0, torch.float32)
    port.load_state_dict(convert.flax_to_state_dict(params))
    got = port(torch.from_numpy(x), torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    n_in = int(np.prod(in_shape))
    base = (x[1].reshape(-1, n_in) @ params["kernel"].reshape(n_in, -1)).reshape(got[1].shape)
    np.testing.assert_allclose(got[1], base, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="adapter_ids"):
        port(torch.from_numpy(x))


def test_stacked_tree_merge_and_rank_equal_the_reference(trees):
    base, adapters, stacked, port_stacked = trees
    want = convert.flax_to_state_dict(stacked)
    assert set(port_stacked) == set(want)
    for name, value in want.items():
        assert torch.equal(port_stacked[name], value), name
    assert port_stacked["layer_0.attn.query.lora_a_stack"].shape == (N_ADAPTERS, 64, RANK)
    assert port_stacked["layer_0.attn.out.lora_b_stack"].shape == (N_ADAPTERS, RANK, 64)
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in port_stacked)
    assert lora.lora_rank_of(port_stacked) == jax_lora.lora_rank_of(stacked) == RANK
    for adapter in adapters:
        got = lora.merge_lora_params(convert.flax_to_state_dict(adapter), alpha=16.0)
        ref = convert.flax_to_state_dict(_np(jax_lora.merge_lora_params(adapter, alpha=16.0)))
        assert set(got) == set(ref) and not any(".lora_" in k for k in got)
        for name in ref:
            np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="no LoRA"):
        lora.lora_rank_of(convert.flax_to_state_dict(base))
    with pytest.raises(ValueError, match="at least one"):
        lora.stack_lora_adapters(convert.flax_to_state_dict(base), [])
    odd = dict(convert.flax_to_state_dict(adapters[1]))
    odd["layer_0.attn.query.lora_a"] = torch.zeros(64, 3)
    with pytest.raises(ValueError, match="ranks disagree"):
        lora.stack_lora_adapters(convert.flax_to_state_dict(base),
                                 [convert.flax_to_state_dict(adapters[0]), odd])


def test_lora_model_and_init_shapes_equal_the_reference(trees):
    """A ``lora_rank`` model on one adapter tree gives the reference's
    logits; ``init_params`` of a LoRA and a serving config has the
    reference's names and shapes, with zero B as the reference inits it."""
    _, adapters, stacked, _ = trees
    jcfg, tcfg = _cfgs(lora_rank=RANK)
    ids = np.random.RandomState(5).randint(0, 512, size=(2, 9)).astype(np.int32)
    want = np.asarray(jax_tf.TransformerLM(jcfg).apply({"params": adapters[0]}, jnp.asarray(ids)))
    model = port_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(adapters[0]))
    got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    for cfg_kw, tree in ((dict(lora_rank=RANK), adapters[0]),
                         (dict(lora_rank=RANK, lora_serve=N_ADAPTERS), stacked)):
        _, c = _cfgs(**cfg_kw)
        init = port_tf.init_params(c, seed=0)
        assert {k: tuple(v.shape) for k, v in init.items()} == {
            k: tuple(v.shape) for k, v in convert.flax_to_state_dict(tree).items()}
        assert all(not v.any() for k, v in init.items() if ".lora_b" in k)


def test_forward_parity_per_row(trees):
    """One batched forward with adapter_ids [0, 1, -1] equals the JAX
    serving model's and, row by row, the merged single models'."""
    base, adapters, stacked, port_stacked = trees
    jcfg, tcfg = _cfgs(lora_rank=RANK, lora_serve=N_ADAPTERS)
    ids = np.random.RandomState(3).randint(0, 512, size=(3, 8)).astype(np.int32)
    aids = np.array([0, 1, -1], np.int32)
    want = np.asarray(jax_tf.TransformerLM(jcfg).apply(
        {"params": stacked}, jnp.asarray(ids), adapter_ids=jnp.asarray(aids)))
    model = port_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(port_stacked)
    got = model(torch.from_numpy(ids).long(), adapter_ids=torch.from_numpy(aids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    _, plain = _cfgs()
    merged = [lora.merge_lora_params(convert.flax_to_state_dict(a), alpha=16.0)
              for a in adapters] + [convert.flax_to_state_dict(base)]
    for row, state in enumerate(merged):
        single = port_tf.TransformerLM(plain, device="cpu")
        single.load_state_dict(state)
        ref = single(torch.from_numpy(ids[row : row + 1]).long()).numpy()
        np.testing.assert_allclose(got[row], ref[0], rtol=0, atol=LOGIT_TOL)


def test_lora_config_validation():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="lora_serve requires lora_rank"):
        port_tf.TransformerLM(dataclasses.replace(tcfg, lora_serve=2), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_tf.TransformerLM(dataclasses.replace(tcfg, quant="w8", lora_rank=2), device="cpu")


# ------------------------------------------------------------------ engine


def _jobs():
    """Six requests, adapters cycling None, 0, 1; a shared 8-token prefix
    under several adapters; more requests than slots."""
    rs = np.random.RandomState(11)
    common = rs.randint(1, 512, size=8).tolist()
    jobs = []
    for i in range(6):
        tail = rs.randint(1, 512, size=2 + i).tolist()
        jobs.append((common + tail if i % 2 == 0 else tail + common[:3], 7 + 3 * (i % 3),
                     (None, 0, 1)[i % 3]))
    return jobs


def _drive(eng, jobs, **kw):
    reqs = [eng.submit(p, n, adapter=a, **kw) for p, n, a in jobs]
    guard = 0
    while not all(r.done for r in reqs):
        eng.step()
        guard += 1
        assert guard < 2000
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_lora_engine(trees):
    """One JAX multi-LoRA engine for every (block, overlap) case: the flags
    select host-side scheduling over the same programs."""
    _, _, stacked, _ = trees
    jcfg, _ = _cfgs(lora_rank=RANK, lora_serve=N_ADAPTERS)
    return jax_engine.ServingEngine(jcfg, stacked, jax_tf.PagedConfig(**PAGED, use_kernel=True),
                                    max_slots=3, decode_block=16)


def _port_lora_engine(trees, **kw):
    _, tcfg = _cfgs(lora_rank=RANK, lora_serve=N_ADAPTERS)
    return port_engine.ServingEngine(tcfg, trees[3], port_tf.PagedConfig(**PAGED), max_slots=3,
                                     device="cpu", **kw)


def _margins(model, prompt, tokens, aid):
    """Top-2 margin of every greedy token on the port's own dense decode
    under adapter ``aid``, and whether each token is that decode's argmax."""
    cache = port_tf.DenseCache.zeros(model.config, 1, "cpu", max_seq=len(prompt) + len(tokens))
    ids = torch.tensor([-1 if aid is None else aid])
    with torch.no_grad():
        logits = [model(torch.tensor([prompt]), cache=cache, append_mode="cached",
                        adapter_ids=ids)[0, -1]]
        for i, tok in enumerate(tokens[:-1]):
            logits.append(model(torch.tensor([[tok]]), torch.tensor([[len(prompt) + i]]),
                                cache=cache, adapter_ids=ids)[0, -1])
    stacked = torch.stack(logits)
    top2 = stacked.topk(2, dim=-1).values
    return stacked.argmax(-1).tolist() == tokens, float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("block, overlap", [(1, 0), (1, 1), (16, 0), (16, 1)])
def test_engine_multi_lora_tokens_equal_jax(trees, jax_lora_engine, block, overlap):
    """Each request's tokens under its adapter equal the JAX engine's at
    the same decode block and overlap, and the port's own decode's argmax
    with margins that clear MARGIN."""
    jobs = _jobs()
    jax_lora_engine._decode_block, jax_lora_engine._overlap_steps = block, overlap
    want = _drive(jax_lora_engine, jobs)
    eng = _port_lora_engine(trees, decode_block=block, overlap_steps=overlap)
    got = _drive(eng, jobs)
    assert got == want
    assert len(eng.free_pages) == eng.paged.num_pages - 1 and eng._inflight is None
    for (prompt, _, aid), tokens in zip(jobs, got):
        is_argmax, margin = _margins(eng.model, prompt, tokens, aid)
        assert is_argmax and margin > MARGIN
    # Adapters change the tokens: the same prompt under 0 and 1 differs.
    prompt = jobs[0][0]
    assert len({tuple(t) for t in _drive(eng, [(prompt, 8, a) for a in (None, 0, 1)])}) == 3


def test_engine_adapter_tokens_equal_merged_single_models(trees):
    """Adapter i's stream equals greedy_generate on merge_lora_params(i)
    (the base model's for None)."""
    base, adapters, _, _ = trees
    _, plain = _cfgs()
    eng = _port_lora_engine(trees)
    jobs = _jobs()[:3]
    got = _drive(eng, jobs)
    for (prompt, n, aid), tokens in zip(jobs, got):
        tree = convert.flax_to_state_dict(base) if aid is None else lora.merge_lora_params(
            convert.flax_to_state_dict(adapters[aid]), alpha=16.0)
        ref = port_tf.greedy_generate(plain, tree, [prompt], n, device="cpu")[0, len(prompt):]
        assert tokens == ref.tolist()


def test_adapter_validation_equal_the_reference(trees, jax_lora_engine):
    eng = _port_lora_engine(trees)
    for bad in (-1, N_ADAPTERS):
        for e in (eng, jax_lora_engine):
            with pytest.raises(ValueError, match="adapter must be in"):
                e.submit([1, 2, 3], 2, adapter=bad)
    _, plain = _cfgs()
    state = convert.flax_to_state_dict(trees[0])
    plain_eng = port_engine.ServingEngine(plain, state, port_tf.PagedConfig(**PAGED), device="cpu")
    with pytest.raises(ValueError, match="cfg.lora_serve"):
        plain_eng.submit([1, 2, 3], 2, adapter=0)
    with pytest.raises(ValueError, match="lora_serve is not supported with spec_gamma"):
        _port_lora_engine(trees, spec_gamma=2, draft_params=trees[3])


def test_prefix_trie_is_per_adapter(trees):
    """The same two-page prompt under adapters 0, 0, 1 and the base in one
    burst: the second adapter-0 request shares the first's pages, the
    others share nothing, and the trie holds one root per adapter."""
    eng = _port_lora_engine(trees, decode_block=1)
    prompt = list(range(10, 18))
    reqs = [eng.submit(prompt, 4, adapter=a) for a in (0, 0, 1)]
    eng.step()  # one admission burst
    pages = [eng._slot_pages[s] for s in range(3)]
    assert pages[0][:2] == pages[1][:2]
    assert not set(pages[2][:2]) & set(pages[0][:2])
    roots = {parent for parent, _ in eng._prefix_pages if parent < 0}
    assert roots == {eng._trie_root(0), eng._trie_root(1)} == {-2, -3}
    base = eng.submit(prompt, 4)
    while not all(r.done for r in reqs + [base]):
        eng.step()
    assert base.tokens != reqs[0].tokens or reqs[0].tokens != reqs[2].tokens
    assert reqs[0].tokens == reqs[1].tokens


# ---------------------------------------------- snapshots and the handoff


@pytest.fixture(scope="module")
def jax_tiered_lora(trees):
    _, _, stacked, _ = trees
    jcfg, _ = _cfgs(lora_rank=RANK, lora_serve=N_ADAPTERS)
    eng = jax_engine.ServingEngine(jcfg, stacked, jax_tf.PagedConfig(**PAGED), max_slots=2,
                                   kv_retain=True, kv_host_cache_mb=8)
    return eng


@pytest.fixture(scope="module")
def port_tiered_lora(trees):
    return _port_lora_engine(trees, kv_retain=True, kv_host_cache_mb=8)


def _reset(eng):
    eng.role = "unified"
    eng._handoff_skip_covered = False
    eng.kvcache_clear()
    assert len(eng.free_pages) == eng.paged.num_pages - 1


PROMPT = [3, 141, 59, 7, 11, 5, 9, 2]  # two full pages


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_carries_adapter_roots(jax_tiered_lora, port_tiered_lora, tmp_path, direction):
    """A snapshot written by one engine after adapter-1 traffic loads into
    the other under the adapter's trie root: the reader's adapter-1 replay
    restores from the arena with its own tokens, and the base model's
    request of the same prompt finds no entry."""
    jeng, peng = jax_tiered_lora, port_tiered_lora
    writer, reader = (jeng, peng) if direction == "jax_to_port" else (peng, jeng)
    save = jax_snap.save_arena_snapshot if writer is jeng else snap.save_arena_snapshot
    load = snap.load_arena_snapshot if reader is peng else jax_snap.load_arena_snapshot
    try:
        ref = _drive(reader, [(PROMPT, 5, 1)])[0]
        reader.kvcache_clear()
        assert _drive(writer, [(PROMPT, 5, 1)])[0] == ref
        path = str(tmp_path / snap.SNAPSHOT_NAME)
        assert save(writer, path)["ok"]
        _, written = jax_snap.read_snapshot(path)
        assert written and all(key[1] == -(2 + 1) for key, _, _ in written)
        assert load(reader, path)["ok"]
        host0 = reader.kv_host_hits
        _drive(reader, [(PROMPT, 5, None)])
        assert reader.kv_host_hits == host0  # another root: no hit
        assert _drive(reader, [(PROMPT, 5, 1)])[0] == ref
        assert reader.kv_host_hits > host0
    finally:
        _reset(jeng)
        _reset(peng)


def _served(eng, module):
    return module.EngineServer(eng, host="127.0.0.1", port=0).start()


def _post(port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


@pytest.mark.parametrize("prefill_pkg", ["jax", "port"])
def test_handoff_carries_adapter_roots(jax_tiered_lora, port_tiered_lora, prefill_pkg):
    """An adapter-1 prompt handed from a prefill replica of one package to
    a decode replica of the other: the decode side answers the unified
    adapter-1 tokens with its prefill skipped."""
    jeng, peng = jax_tiered_lora, port_tiered_lora
    pre, dec = (jeng, peng) if prefill_pkg == "jax" else (peng, jeng)
    servers = []
    try:
        ref = _drive(dec, [(PROMPT, 5, 1)])[0]
        for eng in (pre, dec):
            eng.kvcache_clear()
        pre.role, dec.role = "prefill", "decode"
        dec._handoff_skip_covered = True
        servers = [_served(pre, jax_http if pre is jeng else port_http),
                   _served(dec, jax_http if dec is jeng else port_http)]
        skipped0 = dec.handoff_skipped_tokens
        status, body = _post(servers[1].port, "/generate",
                             {"prompt": PROMPT, "max_new_tokens": 5, "adapter": 1},
                             {handoff.HANDOFF_SOURCE_HEADER: f"127.0.0.1:{servers[0].port}"})
        assert status == 200, body
        assert json.loads(body)["tokens"] == ref
        assert dec.handoff_skipped_tokens - skipped0 == len(PROMPT)
        with dec._lock:
            roots = {k[1] for k in dec._kv_arena._entries if k[0] == "prefix"}
        assert roots <= {-(2 + 1)} and _wait(lambda: pre.handoff_serves >= 1)
        assert _wait(lambda: all(s is None for s in pre.slots) and not pre._pending)
    finally:
        for srv in servers:
            srv.stop()
        _reset(jeng)
        _reset(peng)


# ------------------------------------------------------------ HTTP server


def _orbax_save(directory, params):
    from k8s_device_plugin_tpu.models.train import TrainState

    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=(),
                       batch_stats={})
    with jax_ckpt.CheckpointManager(directory) as mgr:
        mgr.save(state, force=True)


def test_http_server_adapters_equal_the_jax_server(trees, tmp_path):
    """The port's server built from ``--checkpoint-dir`` and ``--adapters``
    (port checkpoint directories written by ``convert.save_flax_params``)
    against a JAX server over the same trees restored from orbax, as the
    reference's main restores and stacks them: equal tokens for each
    adapter and the base, 422 for an index out of range, and a
    ``--lora-rank`` that differs from the trees' exits."""
    base, adapters, _, _ = trees
    port_dirs = [str(tmp_path / f"port_{i}") for i in range(3)]
    jax_dirs = [str(tmp_path / f"orbax_{i}") for i in range(3)]
    for tree, p_dir, j_dir in zip([base, *adapters], port_dirs, jax_dirs):
        convert.save_flax_params(p_dir, tree)
        _orbax_save(j_dir, tree)
    assert port_ckpt.CheckpointManager(port_dirs[0]).latest_step() == 0
    jcfg, _ = _cfgs()
    jparams = jax_ckpt.CheckpointManager(jax_dirs[0]).restore_params()
    jtrees = [jax_ckpt.CheckpointManager(d).restore_params() for d in jax_dirs[1:]]
    jcfg = dataclasses.replace(jcfg, lora_rank=jax_lora.lora_rank_of(jtrees[0]),
                               lora_serve=len(jtrees))
    jeng = jax_engine.ServingEngine(jcfg, jax_lora.stack_lora_adapters(jparams, jtrees),
                                    jax_tf.PagedConfig(**PAGED), max_slots=2)
    flags = ["--device=cpu", "--dtype=float32", "--hidden=64", "--layers=2", "--heads=4",
             "--kv-heads=2", "--vocab=512", "--page-size=4", "--num-pages=40",
             "--max-pages-per-seq=12", "--slots=2", "--watchdog=0",
             f"--checkpoint-dir={port_dirs[0]}", f"--adapters={port_dirs[1]},{port_dirs[2]}"]
    args = port_http.parse_args(flags + [f"--lora-rank={RANK}"])
    peng = port_http.build_engine(args)
    assert peng.cfg.lora_serve == N_ADAPTERS and peng.cfg.lora_rank == RANK
    with pytest.raises(SystemExit, match="--lora-rank 3"):
        port_http.build_engine(port_http.parse_args(flags + ["--lora-rank=3"]))
    servers = [_served(jeng, jax_http), _served(peng, port_http)]
    try:
        for adapter in (None, 0, 1):
            body = {"prompt": PROMPT, "max_new_tokens": 6}
            if adapter is not None:
                body["adapter"] = adapter
            answers = [_post(srv.port, "/generate", body) for srv in servers]
            assert [a[0] for a in answers] == [200, 200], answers
            assert json.loads(answers[0][1])["tokens"] == json.loads(answers[1][1])["tokens"]
        for srv in servers:
            status, body = _post(srv.port, "/generate",
                                 {"prompt": PROMPT, "max_new_tokens": 2, "adapter": N_ADAPTERS})
            assert status == 422 and b"adapter must be in" in body
    finally:
        for srv in servers:
            srv.stop()


def test_checkpoint_manager_saves_and_restores_steps(tmp_path):
    mgr = port_ckpt.CheckpointManager(tmp_path / "ck")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore_params()
    for step in range(3):
        mgr.save({"w": torch.full((2,), float(step))}, step)
    mgr.save({"w": torch.zeros(2)}, 1)  # a step saved again is replaced whole
    assert mgr.steps() == [0, 1, 2] and mgr.latest_step() == 2
    assert sorted(os.listdir(mgr.directory)) == ["0", "1", "2"]  # no temporary left
    assert torch.equal(mgr.restore_params()["w"], torch.full((2,), 2.0))
    assert torch.equal(mgr.restore_params(1)["w"], torch.zeros(2))
    with mgr:
        mgr.wait()
