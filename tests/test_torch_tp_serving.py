"""Tensor-parallel serving in the port (``models/engine_tp.py``,
``parallel/serving.py``) against the JAX package's, on the CPU.

The sharding contract's units mirror tests/test_tp_serving.py: the cache
specs, the refusal of an indivisible pool naming its path, and the lint
naming a silently replicated pool or a leaf off the rank's device.  The
engine refuses a mesh without its axis and kv heads the degree does not
divide, with the reference's texts; both CLIs take ``--tp`` with every
flag the reference serves under it (``--spec-gamma``, ``--adapters``,
``--role prefill|decode``, ``--quant``).

One spawn of two gloo CPU ranks (tests/torch_ranks.py, float32,
GPTConfig.tiny() with 2 kv heads from flax's init) runs, on every rank,
the sharded forward and ``greedy_generate``, then the two scenarios of
``__graft_entry__.py``'s tp bar through a ``ServingEngine`` over the
``tp`` mesh (rank 0 leading, rank 1 following): greedy under preemption
churn (optimistic admission, KV tiers, a tightened pool, overlap discards)
and sampled under ``PRNGKey(42)`` at temperature 0.8, top-k 8, repeated
after a reclaim so that it restores through the host arena.  Rank 0 saves
the results and every rank's pools.  The logits must be within 1e-5 of the
JAX model's; the tokens must equal the JAX package's (its
``greedy_generate`` and its unsharded engine), with every greedy step's
top-2 margin above ``MARGIN`` so no near-tie decides them; the scheduling
counters must equal the port's unsharded engine's and be above 0; the lint
must pass on both ranks; and the pools, joined on the kv-heads axis, must
equal the unsharded engine's within 1e-5 (no device write bypassed the
leader's operations).  The same spawn then serves what the reference
serves over its mesh (``SERVED``): ``w8`` weights; ``w8a8`` weights with
int8 pools, whose value and up kernels are scaled 4x on the second rank's
half so that each out/down row's absmax lies there (a rank that quantized
its slice with its own absmax would write other codes); two stacked LoRA
adapters beside the base model; gamma-2 speculation with the w8
self-draft; and a prefill -> decode handoff between a prefill-role and a
decode-role engine on the group.  Each stream must equal the port's
unsharded engine's and the JAX engine's on the same converted weights, the
pools must reassemble the unsharded engine's within 1e-5, and the
handoff's wire bytes (entries and logits section) must equal both
unsharded engines'.  Then the batch CLI runs at ``--tp 2 --device cpu``
and the benchmark's tensor-parallel phase over two gloo ranks, each in a
subprocess killed after 150 s with every rank it spawned.
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import engine_snapshot as jax_snap
from k8s_device_plugin_tpu.models import lora as jax_lora
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu.ops import quant as jax_quant
from k8s_device_plugin_tpu.parallel import serving as jserving
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import engine_snapshot as port_snap
from k8s_device_plugin_tpu_torch.models import http_server as port_http
from k8s_device_plugin_tpu_torch.models import lora as port_lora
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.ops import quant as port_quant
from k8s_device_plugin_tpu_torch.parallel import serving as tserving
from k8s_device_plugin_tpu_torch.utils import prng
from tests.torch_ranks import Ranks, drive_jobs, handoff_decode, handoff_prefill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
# A greedy token is taken as decided when its top-2 logit margin is above
# this: 10x the logits' tolerance.
MARGIN = 1e-4
PAGED = dict(page_size=4, num_pages=16, max_pages_per_seq=8)
# __graft_entry__.py's two scenarios.
SCENARIOS = [
    {"name": "greedy-churn", "jobs": [([3, 5, 7], 16), ([9, 10, 11], 16)], "park": 8},
    {"name": "sampled-restore", "rng": 42, "reclaim": 3,
     "sample": {"temperature": 0.8, "top_k": 8},
     "jobs": [([3, 5, 7, 11, 13, 17, 19, 23], 12), ([9, 10, 11, 12, 4, 5, 6, 7], 12)]},
]
COUNTERS = ("preemptions", "kv_resumes_restored", "overlap_discards")
# What the reference serves over its mesh: (name, config overrides, which
# weights, engine arguments, jobs of (prompt, max_new, adapter)).
JOBS = [([3, 5, 7, 11], 8, None), ([9, 10, 11], 8, None)]
SERVED = [
    ("w8", {"quant": "w8"}, "w8", {}, JOBS),
    ("w8a8-skewed", {"quant": "w8a8", "quant_kv": True}, "w8a8", {}, JOBS),
    ("lora", {"lora_rank": 4, "lora_serve": 2}, "lora", {},
     [([3, 5, 7, 11], 8, 0), ([3, 5, 7, 11], 8, 1), ([9, 10, 11], 8, None)]),
    ("spec-gamma2", {}, "float", {"spec_gamma": 2}, JOBS),
]
HANDOFF = ([3, 5, 7, 11, 13, 17, 19, 23], 6)
LORA_RANK = 4


# ---------------------------------------------------------- the contract


def test_cache_leaf_specs_are_the_reference_s():
    pool, scale, table = (8, 4, 2, 16), (8, 4, 2), (2, 8)
    for path, shape in (("layer_0/attn/pool_key", pool), ("layer_0/attn/pool_value", pool),
                        ("layer_0/attn/pool_key_scale", scale),
                        ("layer_0/attn/pool_value_scale", scale),
                        ("layer_0/attn/page_table", table), ("layer_0/attn/seq_lens", table)):
        leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
        for tp in (1, 2):
            assert tserving.cache_leaf_spec(path, shape, tp) == tuple(
                jserving.cache_leaf_spec(path, leaf, tp)), (path, tp)
    assert tserving.cache_leaf_spec("layer_0/attn/pool_key", pool, 2) == (None, None, "tp", None)


def test_cache_leaf_spec_refuses_indivisible_pool():
    shape = (8, 4, 3, 16)
    with pytest.raises(ValueError) as want:
        jserving.cache_leaf_spec("layer_0/attn/pool_key", jax.ShapeDtypeStruct(shape, jnp.float32),
                                 2)
    with pytest.raises(ValueError, match="pool_key") as got:
        tserving.cache_leaf_spec("layer_0/attn/pool_key", shape, 2)
    assert str(got.value) == str(want.value)


def test_coverage_lint_passes_and_names_offenders():
    pool, lens = torch.zeros(8, 4, 1, 16), torch.zeros(2, dtype=torch.int32)
    good = {"cache": {"pool_key": pool, "seq_lens": lens}}
    assert tserving.assert_explicit_sharding(good, "cpu", tp=2, kv_heads=2) == 2
    stray = {"cache": {"pool_key": pool, "seq_lens": torch.zeros(2, device="meta")}}
    with pytest.raises(AssertionError, match="seq_lens"):
        tserving.assert_explicit_sharding(stray, "cpu", tp=2, kv_heads=2)
    fat = {"cache": {"pool_key": torch.zeros(8, 4, 2, 16)}}
    with pytest.raises(AssertionError, match="'cache/pool_key'.*REPLICATED"):
        tserving.assert_explicit_sharding(fat, "cpu", tp=2, kv_heads=2)
    # tp 1 shards nothing.
    assert tserving.assert_explicit_sharding(fat, "cpu", tp=1, kv_heads=2) == 1


class _Mesh:
    """What the engine reads of a mesh before it joins its group."""

    def __init__(self, axes: dict):
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()), dtype=torch.int64)


@pytest.mark.parametrize("axes, kv_heads, message", [
    ({"dp": 2}, 2, "engine mesh has no 'tp' axis (axes: {'dp': 2})"),
    ({"tp": 3}, 2, "tp=3 does not divide num_kv_heads=2: KV pools shard on the kv-heads axis"),
], ids=["no-axis", "indivisible-kv-heads"])
def test_engine_refuses_what_the_reference_refuses(axes, kv_heads, message):
    cfg = dataclasses.replace(port_tf.GPTConfig.tiny(), num_heads=6, num_kv_heads=kv_heads)
    with pytest.raises(ValueError) as exc:
        port_engine.ServingEngine(cfg, {}, port_tf.PagedConfig(**PAGED), mesh=_Mesh(axes),
                                  device="cpu")
    assert message in str(exc.value)


@pytest.mark.parametrize("cli, argv, flag", [
    ("engine", ["--spec-gamma=2"], ("spec_gamma", 2)),
    ("engine", ["--quant=w8"], ("quant", "w8")),
    ("http", ["--spec-gamma=2"], ("spec_gamma", 2)),
    ("http", ["--adapters=a,b"], ("adapters", "a,b")),
    ("http", ["--role=prefill"], ("role", "prefill")),
    ("http", ["--role=decode"], ("role", "decode")),
    ("http", ["--quant=w8a8"], ("quant", "w8a8")),
])
def test_clis_refuse_tp_with_what_it_does_not_shard(cli, argv, flag):
    """Every flag the reference serves over a mesh is taken with ``--tp``
    and reaches the engine's arguments as it would without it."""
    parse = port_engine.parse_args if cli == "engine" else port_http.parse_args
    args = parse(["--tp=2", *argv])
    assert args.tp == 2 and getattr(args, flag[0]) == flag[1]
    assert vars(args) == dict(vars(parse(argv)), tp=2)


# -------------------------------------------------- two ranks, one spawn


def _cfgs():
    jcfg = dataclasses.replace(jax_tf.GPTConfig.tiny(), num_kv_heads=2, max_seq=32)
    pcfg = dataclasses.replace(port_tf.GPTConfig.tiny(), num_kv_heads=2, max_seq=32)
    return jcfg, pcfg


def _port_engine(pcfg, state, rng=None):
    return port_engine.ServingEngine(
        pcfg, state, port_tf.PagedConfig(**PAGED), max_slots=2,
        rng=None if rng is None else prng.PRNGKey(rng), admission="optimistic",
        kv_retain=True, kv_host_cache_mb=8, device="cpu")


def _jax_engine(jcfg, params, rng=None):
    return jax_engine.ServingEngine(
        jcfg, params, jax_tf.PagedConfig(**PAGED), max_slots=2,
        rng=None if rng is None else jax.random.PRNGKey(rng), admission="optimistic",
        kv_retain=True, kv_host_cache_mb=8)


def _scenario(eng, scenario: dict) -> list:
    kw = scenario.get("sample", {})
    if scenario.get("park"):
        with eng._lock:
            for _ in range(scenario["park"]):
                eng.free_pages.pop()
    done = eng.run(scenario["jobs"], **kw)
    if scenario.get("reclaim"):
        with eng._lock:
            eng._kv_reclaim(scenario["reclaim"])
        done += eng.run(scenario["jobs"], **kw)
    return [r.tokens for r in done]


def _skewed(tree):
    """``tree`` with the second half of every value kernel's kv heads and
    every up kernel's ffn columns scaled 4x: the second rank's half of each
    out/down input row then holds the row's absmax."""
    out = jax.tree_util.tree_map(np.array, tree)
    for i in range(len([k for k in out if k.startswith("layer_")])):
        layer = out[f"layer_{i}"]
        value, up = layer["attn"]["value"]["kernel"], layer["mlp"]["up"]["kernel"]
        value[:, value.shape[1] // 2:] *= 4.0
        up[:, up.shape[1] // 2:] *= 4.0
    return out


def _weights(jcfg, params) -> dict:
    """Each SERVED weight set as (JAX tree, port state dict, JAX draft,
    port draft): float, w8, skewed w8a8 and the LoRA stack."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    skewed = _skewed(tree)
    lcfg = dataclasses.replace(jcfg, lora_rank=LORA_RANK)
    lora_tree = jax.tree_util.tree_map(np.asarray, jax_tf.TransformerLM(lcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    rs = np.random.RandomState(3)

    def adapter(t):
        if not isinstance(t, dict):
            return t
        return {k: (0.1 * rs.standard_normal(v.shape)).astype(np.float32)
                if k in ("lora_a", "lora_b") else adapter(v) for k, v in sorted(t.items())}

    adapters = [adapter(lora_tree) for _ in range(2)]
    to_port = convert.flax_to_state_dict
    quantized = jax.tree_util.tree_map(np.asarray, jax_quant.quantize_lm_params(tree))
    return {
        "float": (tree, to_port(tree), quantized,
                  port_quant.quantize_lm_params(to_port(tree))),
        "w8": (quantized, port_quant.quantize_lm_params(to_port(tree)), None, None),
        "w8a8": (jax.tree_util.tree_map(np.asarray, jax_quant.quantize_lm_params(skewed)),
                 port_quant.quantize_lm_params(to_port(skewed)), None, None),
        "lora": (jax.tree_util.tree_map(np.asarray,
                                        jax_lora.stack_lora_adapters(lora_tree, adapters)),
                 port_lora.stack_lora_adapters(to_port(lora_tree),
                                               [to_port(a) for a in adapters]), None, None),
    }


def _served_refs(jcfg, pcfg, weights) -> dict:
    """Every SERVED scenario and the handoff on the port's unsharded engine
    and the JAX engine."""
    refs = {}
    for name, overrides, which, engine_kw, jobs in SERVED:
        jtree, state, jdraft, draft = weights[which]
        jkw, pkw = dict(engine_kw), dict(engine_kw)
        if engine_kw.get("spec_gamma"):
            jkw["draft_params"], pkw["draft_params"] = jdraft, draft
        jeng = jax_engine.ServingEngine(dataclasses.replace(jcfg, **overrides), jtree,
                                        jax_tf.PagedConfig(**PAGED), max_slots=2, **jkw)
        peng = port_engine.ServingEngine(dataclasses.replace(pcfg, **overrides), state,
                                         port_tf.PagedConfig(**PAGED), max_slots=2,
                                         device="cpu", **pkw)
        refs[name] = {"jax": drive_jobs(jeng, jobs), "port": drive_jobs(peng, jobs),
                      "pools": {f"layer_{i}": peng.kv_pools(i) for i in range(pcfg.num_layers)}}
    role_kw = dict(kv_retain=True, kv_host_cache_mb=8, prefill_chunk=4, max_slots=2)
    tree, state = weights["float"][:2]
    wires = []
    for eng_mod, tf, snap, w, kw in ((jax_engine, jax_tf, jax_snap, tree, {}),
                                     (port_engine, port_tf, port_snap, state, {"device": "cpu"})):
        cfg = jcfg if eng_mod is jax_engine else pcfg
        pre = eng_mod.ServingEngine(cfg, w, tf.PagedConfig(**PAGED), role="prefill", **role_kw,
                                    **kw)
        wires.append(handoff_prefill(pre, snap, HANDOFF[0]))
    dec = port_engine.ServingEngine(pcfg, state, port_tf.PagedConfig(**PAGED), role="decode",
                                    device="cpu", **role_kw)
    refs["handoff"] = dict(handoff_decode(dec, port_snap, wires[1][0], *HANDOFF),
                           jax_wire=wires[0], port_wire=wires[1],
                           pools={f"layer_{i}": dec.kv_pools(i) for i in range(pcfg.num_layers)})
    return refs


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Rank 0's results, and this process's references: the JAX model's
    logits and ``greedy_generate``, the JAX engine's streams, and the
    port's unsharded engines (streams, counters, pools)."""
    jcfg, pcfg = _cfgs()
    params = jax_tf.TransformerLM(jcfg).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8), jnp.int32))["params"]
    state = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, jcfg.vocab_size, size=(2, 9))
    prompt = rs.randint(0, jcfg.vocab_size, size=(2, 5))
    kwargs = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    weights = _weights(jcfg, params)
    served = []
    for name, overrides, which, engine_kw, jobs in SERVED:
        engine_kw = dict(engine_kw)
        if engine_kw.get("spec_gamma"):
            engine_kw["draft_params"] = weights[which][3]
        served.append({"name": name, "cfg": overrides, "state": weights[which][1],
                       "engine": engine_kw, "jobs": jobs})
    served.append({"name": "handoff", "handoff": HANDOFF})
    spec = {"tp_serving": {"cfg": kwargs, "state_dict": state, "paged": PAGED,
                           "ids": torch.from_numpy(ids), "prompt": torch.from_numpy(prompt),
                           "new": 6, "scenarios": SCENARIOS, "served": served}}
    running = Ranks(spec, 2, str(tmp_path_factory.mktemp("tp_ranks")))
    ref = {"logits": np.asarray(jax_tf.TransformerLM(jcfg).apply({"params": params}, ids)),
           "generated": np.asarray(jax_tf.greedy_generate(jcfg, params, jnp.asarray(prompt), 6)),
           "scenarios": {}}
    for scenario in SCENARIOS:
        jeng = _jax_engine(jcfg, params, scenario.get("rng"))
        peng = _port_engine(pcfg, state, scenario.get("rng"))
        ref["scenarios"][scenario["name"]] = {
            "jax": _scenario(jeng, scenario), "port": _scenario(peng, scenario),
            "counters": {n: getattr(peng, n) for n in COUNTERS},
            "jax_counters": {n: getattr(jeng, n) for n in COUNTERS},
            "pools": {f"layer_{i}": peng.kv_pools(i) for i in range(pcfg.num_layers)},
        }
    margins = _greedy_margins(pcfg, state, SCENARIOS[0]["jobs"],
                              ref["scenarios"]["greedy-churn"]["jax"])
    ref["served"] = _served_refs(jcfg, pcfg, weights)
    return running.wait(), ref, margins


def _greedy_margins(pcfg, state, jobs, streams) -> list:
    """Each greedy step's top-2 logit margin, from the unsharded model's
    full forward over the prompt and the tokens before it."""
    model = port_tf.TransformerLM(pcfg, device="cpu")
    model.load_state_dict(state)
    margins = []
    for (prompt, _), tokens in zip(jobs, streams):
        seq = torch.tensor([prompt + tokens[:-1]])
        logits = model(seq)[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())
        assert logits.argmax(-1).tolist() == tokens
    return margins


def test_sharded_forward_is_the_reference_s(tp_run):
    got, ref, _ = tp_run
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"], rtol=0, atol=ATOL)


def test_sharded_greedy_generate_is_the_reference_s(tp_run):
    got, ref, _ = tp_run
    np.testing.assert_array_equal(got["generated"].numpy(), ref["generated"])


@pytest.mark.parametrize("name", [s["name"] for s in SCENARIOS])
def test_tp2_streams_and_schedule_are_the_unsharded_engine_s(tp_run, name):
    got, ref, margins = tp_run
    run, want = got["scenarios"][name], ref["scenarios"][name]
    assert want["port"] == want["jax"]
    assert run["tokens"] == want["jax"]
    counters = {n: run["counters"][n] for n in COUNTERS}
    assert counters == want["counters"] == want["jax_counters"]
    if name == "greedy-churn":
        assert counters["preemptions"] > 0 and counters["kv_resumes_restored"] > 0
        assert counters["overlap_discards"] > 0
        assert min(margins) > MARGIN, min(margins)
    else:
        assert run["counters"]["kv_host_hits"] > 0 and run["counters"]["kv_restores"] > 0
    assert run["tp"] == {"size": 2, "axis": "tp", "mesh": {"tp": 2}, "devices": ["cpu", "cpu"]}


@pytest.mark.parametrize("name", [s["name"] for s in SCENARIOS])
def test_every_rank_s_pools_reassemble_the_unsharded_engine_s(tp_run, name):
    got, ref, _ = tp_run
    run, want = got["scenarios"][name], ref["scenarios"][name]
    assert run["rank_kv_heads"] == [1, 1]
    assert run["lint"] > 0  # both ranks' lint passed after the traffic
    for layer, pools in want["pools"].items():
        assert set(run["pools"][layer]) == set(pools)
        for pool, value in pools.items():
            np.testing.assert_allclose(run["pools"][layer][pool].numpy(), value.numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"{layer}.{pool}")


@pytest.mark.parametrize("name", [s[0] for s in SERVED])
def test_tp2_serves_what_the_reference_serves_over_its_mesh(tp_run, name):
    got, ref, _ = tp_run
    run, want = got["scenarios"][name], ref["served"][name]
    assert want["port"] == want["jax"]
    assert run["tokens"] == want["jax"]
    assert run["rank_kv_heads"] == [1, 1] and run["lint"] > 0
    # Both ranks ran every decode step (the card's kernel launches per rank
    # are chip_smoke.py phase 12d's).
    steps = [r["device_steps"] for r in run["rank_stats"]]
    assert steps[0] == steps[1] > 0
    if name == "spec-gamma2":
        assert run["spec_rounds"] > 0
    for layer, pools in want["pools"].items():
        for pool, value in pools.items():
            np.testing.assert_allclose(run["pools"][layer][pool].numpy(), value.numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"{name} {layer}.{pool}")


def _wire(wire: bytes, logits: bytes, snap, handoff_mod) -> tuple:
    """A handoff body as (preamble without its clock, the entries' keys and
    byte counts, their rows, the shipped logits), parsed by ``snap``."""
    import io

    buf = io.BytesIO(wire)
    header, parsed = snap._parse_snapshot(buf, None, None)
    header = {k: v for k, v in header.items() if k != "created_unix_ms"}
    keys = [(k, nbytes) for k, _, nbytes in parsed]
    rows = [rows for _, rows, _ in parsed]
    return header, keys, rows, handoff_mod.read_logits_section(io.BytesIO(logits))


def test_tp2_handoff_wire_and_decode_are_the_unsharded_engines(tp_run):
    """The wire of the prefill role over two ranks is the unsharded
    engines' (the JAX package's and the port's) record for record: the same
    layout (every kv head), fingerprint, keys and byte counts, rows and
    logits within 1e-5; the JAX package's parser takes it."""
    from k8s_device_plugin_tpu.models import engine_handoff as jax_handoff
    from k8s_device_plugin_tpu_torch.models import engine_handoff as port_handoff

    got, ref, _ = tp_run
    run, want = got["scenarios"]["handoff"], ref["served"]["handoff"]
    ours = _wire(run["wire"], run["logits"], port_snap, port_handoff)
    for other, snap, mod in ((want["port_wire"], port_snap, port_handoff),
                             (want["jax_wire"], jax_snap, jax_handoff)):
        theirs = _wire(*other, snap, mod)
        assert ours[0] == theirs[0] and ours[1] == theirs[1]
        assert len(run["logits"]) == len(other[1])
        for mine, them in zip(ours[2], theirs[2]):
            for layer, pools in them.items():
                for pool, value in pools.items():
                    np.testing.assert_allclose(np.asarray(mine[layer][pool]), np.asarray(value),
                                               rtol=0, atol=ATOL)
        np.testing.assert_allclose(ours[3], theirs[3], rtol=0, atol=ATOL)
    assert run["admitted"] == want["admitted"] == 2
    assert run["tokens"] == want["tokens"]
    assert run["skipped"] == want["skipped"] > 0
    for layer, pools in want["pools"].items():
        for pool, value in pools.items():
            np.testing.assert_allclose(run["pools"][layer][pool].numpy(), value.numpy(), rtol=0,
                                       atol=ATOL, err_msg=f"{layer}.{pool}")


# ------------------------------------------------------ the entry points


def _run(cmd):
    """``cmd`` from the repo root, one torch thread a rank (the suite's
    other workers keep the cores), killed with every rank it spawned after
    150 s; returns (returncode, stdout, stderr)."""
    proc = subprocess.Popen(cmd, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err


def test_batch_cli_serves_at_tp2_and_leaves_no_follower():
    rc, out, err = _run([
        sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.engine", "--device=cpu",
        "--dtype=float32", "--hidden=64", "--layers=2", "--heads=4", "--kv-heads=2",
        "--vocab=512", "--page-size=4", "--num-pages=64", "--decode-block=16", "--requests=4",
        "--prompt-len=8", "--max-new=8", "--tp=2"])
    assert rc == 0, err[-3000:]
    [record] = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert record["tp"] == 2 and record["requests"] == 4 and record["tokens"] == 32
    pids = [int(p) for p in re.search(r"follower pids \[([\d, ]+)\]", err).group(1).split(",")]
    assert len(pids) == 1 and not os.path.exists(f"/proc/{pids[0]}")


TP_PHASE = """
import dataclasses, json
from k8s_device_plugin_tpu_torch.models import benchmark as tbench
from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
from k8s_device_plugin_tpu_torch.models.transformer import PagedConfig, init_params

if __name__ == "__main__":
    args = tbench.parse_args(["--model=serving", "--tiny", "--device=cpu", "--dtype=float32",
                              "--requests=4", "--slots=2", "--prompt-len=8",
                              "--decode-tokens=8"])
    paged = PagedConfig(16, num_pages=3, max_pages_per_seq=1)
    cfg = dataclasses.replace(tbench.gpt_config(args), max_seq=paged.max_len)
    eng = ServingEngine(cfg, init_params(cfg, 0), paged, max_slots=2, kv_retain=True,
                        kv_host_cache_mb=64, device="cpu")
    jobs = [([(11 * i + j) % cfg.vocab_size for j in range(8)], 8) for i in range(4)]
    done = eng.run(jobs)
    assert tbench.run_tp_phase(args, cfg, None, paged, jobs, done, 100.0) is None
    print(json.dumps(tbench.run_tp_phase(args, cfg, None, paged, jobs, done, 100.0, tp=2,
                                         backend="gloo")))
"""


def test_serving_benchmark_tp_phase_has_the_reference_s_keys():
    """On one device the block is null, as the reference's; over two gloo
    ranks it carries the reference's seven keys, the tokens matching the
    unsharded run's."""
    rc, out, err = _run([sys.executable, "-c", TP_PHASE])
    assert rc == 0, err[-3000:]
    block = json.loads(out.strip().splitlines()[-1])
    assert list(block) == ["size", "tokens_per_sec", "tp1_tokens_per_sec", "speedup",
                           "scaling_efficiency", "discards", "tokens_match"]
    assert block["size"] == 2 and block["tp1_tokens_per_sec"] == 100.0
    assert block["tokens_match"] is True and block["tokens_per_sec"] > 0
