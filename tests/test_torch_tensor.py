"""The port's tensor-parallel rules (``parallel/tensor.py``) against the
JAX package's, and the sharded model at a group of one.

``tp_spec_for`` must give the reference's ``PartitionSpec`` (as a tuple)
for every parameter name of ``GPTConfig.tiny()``, of its quantized form and
of its LoRA form, at tp 1, 2 and 4 and at a degree that divides nothing
(3), and for the MoE expert names with and without an ``ep`` axis.
``shard_state_dict`` cuts what the rules split into equal chunks that join
back into the full tensor.  A gloo group of one in this process runs the
sharded model's collectives over a single rank: its logits, its
``greedy_generate`` and a serving engine over a ``tp`` mesh of one equal
the unsharded ones exactly (an all-reduce or all-gather over one rank is
the identity).  The two-rank runs are tests/test_torch_tp_serving.py's.
"""

import dataclasses

import jax
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu.parallel import tensor as jtensor
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.parallel import tensor as ttensor


def _names(kind: str) -> dict:
    """Every parameter name and shape of the port's tiny config ``kind``
    ("plain", "quant", "lora"), as ``param_shapes`` lists them."""
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=2)
    if kind == "quant":
        cfg = dataclasses.replace(cfg, quant="w8")
    elif kind == "lora":
        cfg = dataclasses.replace(cfg, lora_rank=4)
    return ttf.param_shapes(cfg)


# The MoE expert kernels ([experts, hidden, ffn] and [experts, ffn, hidden])
# of parallel/moe.py: the rules' first two.
MOE = {"layer_0.mlp.experts_gate": (4, 64, 128), "layer_0.mlp.experts_up": (4, 64, 128),
       "layer_0.mlp.experts_down": (4, 128, 64)}


@pytest.mark.parametrize("kind, axes", [
    (kind, {"tp": tp}) for kind in ("plain", "quant", "lora") for tp in (1, 2, 4, 3)
] + [("moe", {"tp": 2}), ("moe", {"ep": 2, "tp": 2}), ("moe", {"ep": 3, "tp": 2})])
def test_spec_rules_are_the_reference_s(kind, axes):
    names = MOE if kind == "moe" else _names(kind)
    assert names
    for name, shape in names.items():
        leaf = jax.ShapeDtypeStruct(shape, jax.numpy.float32)
        want = tuple(jtensor.tp_spec_for(name.replace(".", "/"), leaf, axes))
        assert ttensor.tp_spec_for(name, shape, axes) == want, name


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_state_dict_cuts_what_the_rules_split(tp):
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=4)
    full = ttf.init_params(cfg, 0)
    shards = [ttensor.shard_state_dict(full, tp, r) for r in range(tp)]
    split = set()
    for name, value in full.items():
        dim = ttensor.tp_dim(ttensor.tp_spec_for(name, value.shape, {"tp": tp}))
        if dim is None:
            assert all(s[name] is value for s in shards), name
            continue
        split.add(name.split(".")[-2])
        assert all(s[name].shape[dim] * tp == value.shape[dim] for s in shards), name
        assert torch.equal(torch.cat([s[name] for s in shards], dim=dim), value), name
    assert split == {"query", "key", "value", "out", "gate", "up", "down", "embed", "lm_head"}


def test_layout_refuses_query_heads_split_without_kv_heads():
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_heads=4, num_kv_heads=1)
    with pytest.raises(ValueError, match="splits the 4 query heads but not the 1 kv heads"):
        ttensor.lm_layout(cfg, 2)
    wide = dataclasses.replace(ttf.GPTConfig.tiny(), vocab_size=511)
    assert ttensor.lm_layout(wide, 2) == {"attn": True, "mlp": True, "vocab": False}
    assert ttf.tp_local(wide, type("TP", (), {"size": 2, "axis": "tp"})()) == (2, 2, 64, 511)


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo group of one in this process and its ``tp`` mesh."""
    from datetime import timedelta

    from torch.distributed.device_mesh import DeviceMesh

    dist = torch.distributed
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        yield DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("tp",))
    finally:
        from k8s_device_plugin_tpu_torch.models import engine_tp

        engine_tp._channels.clear()
        dist.destroy_process_group()


def test_group_of_one_runs_the_collectives_and_changes_nothing(world_of_one):
    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=2, max_seq=32)
    params = ttf.init_params(cfg, 0)
    tp = ttensor.TensorParallel.from_mesh(world_of_one)
    plain = ttf.TransformerLM(cfg, device="cpu")
    plain.load_state_dict(params)
    sharded = ttf.TransformerLM(cfg, device="cpu", tp=tp)
    sharded.load_state_dict(ttensor.shard_state_dict(params, 1, 0))
    ids = torch.from_numpy(__import__("numpy").random.RandomState(0).randint(0, 512, (2, 9)))
    assert torch.equal(sharded(ids), plain(ids))
    # embed + 2 x 2 layers' row-parallel sites; the head's all-gather.
    assert tp.calls == {"all_reduce": 5, "all_gather": 1}
    prompt = ids[:, :5]
    assert torch.equal(ttf.greedy_generate(cfg, params, prompt, 6, device="cpu", tp=tp),
                       ttf.greedy_generate(cfg, params, prompt, 6, device="cpu"))


def test_engine_over_a_mesh_of_one_equals_the_plain_engine(world_of_one):
    """Same streams and counters, every device write through the leader's
    operations (a group of one has no follower to send them to), and the
    reference's ``tp`` block and gauge."""
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
    from k8s_device_plugin_tpu_torch.models.engine_types import EngineMetrics
    from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry

    cfg = dataclasses.replace(ttf.GPTConfig.tiny(), num_kv_heads=2, max_seq=32)
    params = ttf.init_params(cfg, 0)
    runs = []
    for mesh in (None, world_of_one):
        metrics = EngineMetrics(MetricsRegistry())
        eng = ServingEngine(cfg, params, ttf.PagedConfig(4, 16, 8), max_slots=2, mesh=mesh,
                            admission="optimistic", kv_retain=True, kv_host_cache_mb=8,
                            metrics=metrics, decode_block=4, device="cpu")
        with eng._lock:
            for _ in range(8):
                eng.free_pages.pop()
        done = eng.run([([3, 5, 7], 16), ([9, 10, 11], 16)])
        runs.append(([r.tokens for r in done],
                     (eng.preemptions, eng.kv_resumes_restored, eng.overlap_discards),
                     eng.debug_state()["tp"], metrics.tp_size.value()))
    assert runs[1][:2] == runs[0][:2]
    assert runs[0][1][0] > 0 and runs[0][1][2] > 0
    assert runs[0][2:] == ({"size": 1, "axis": None, "mesh": None, "devices": None}, 1)
    assert runs[1][2:] == ({"size": 1, "axis": "tp", "mesh": {"tp": 1}, "devices": ["cpu"]}, 1)
    assert eng.assert_sharded() > 0


def test_jax_model_layout_names_match_the_port_s():
    """The rules are written on the port's names: every flax path of the
    tiny model maps to a port name ``param_shapes`` lists."""
    cfg = dataclasses.replace(jax_tf.GPTConfig.tiny(), num_kv_heads=2)
    shapes = jax.eval_shape(lambda: jax_tf.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 2), jax.numpy.int32)))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    names = {jtensor._path_str(path).replace("/", "."): tuple(leaf.shape) for path, leaf in flat}
    assert names == _names("plain")
