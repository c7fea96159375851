"""Train states across the two packages and across restarts: converted JAX
states that continue training, the port's checkpoints (``restore(target)``,
retention, ``restore_params`` on a train-state directory), the benchmark
CLI for the four image and encoder models and its resume contract, the
input pipeline and the platform table.

A JAX state is carried over with its SGD momentum (optax's ``trace``), its
``batch_stats`` and its step, so the port's next steps are the reference's
next steps (the step counter keys AlexNet's dropout).  Tolerances as in
``tests/test_torch_vision.py``: losses 1e-5 relative, every parameter and
statistic 1e-5 absolute (float32).  A resume inside the port is checked bit
for bit: on the CPU the same steps from the same state give the same bits.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_device_plugin_tpu.models import alexnet as jalex
from k8s_device_plugin_tpu.models import resnet as jres
from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import alexnet as talex
from k8s_device_plugin_tpu_torch.models import benchmark as tbench
from k8s_device_plugin_tpu_torch.models import checkpoint as tckpt
from k8s_device_plugin_tpu_torch.models import data as tdata
from k8s_device_plugin_tpu_torch.models import input_pipeline as tpipe
from k8s_device_plugin_tpu_torch.models import resnet as tres
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.utils import platform as tplatform
from k8s_device_plugin_tpu_torch.utils import prng

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
CLASSES = 10


def _images(n, size, seed):
    rs = np.random.RandomState(seed)
    return {"images": rs.randn(n, size, size, 3).astype(np.float32),
            "labels": rs.randint(0, CLASSES, size=n).astype(np.int32)}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


MODELS = {
    # (JAX model, port model, image size)
    "resnet": (lambda: jres.ResNet18Thin(num_classes=CLASSES, dtype=jnp.float32,
                                         norm_dtype=jnp.float32),
               lambda: tres.ResNet18Thin(num_classes=CLASSES, dtype=torch.float32,
                                         norm_dtype=torch.float32, device="cpu"), 32),
    "alexnet": (lambda: jalex.AlexNet(num_classes=CLASSES, dtype=jnp.float32, width=0.125),
                lambda: talex.AlexNet(num_classes=CLASSES, dtype=torch.float32, width=0.125,
                                      image_size=64, device="cpu"), 64),
}


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_converted_jax_state_continues_as_the_reference(name):
    """2 JAX steps, the state (params, batch_stats, momentum, step) carried
    over, 2 port steps: the same as 4 JAX steps."""
    make_j, make_t, size = MODELS[name]
    batch = _images(8, size, seed=7)
    jm = make_j()
    variables = jm.init(jax.random.PRNGKey(8), jnp.asarray(batch["images"]))
    tx = optax.sgd(0.1, momentum=0.9)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              opt_state=tx.init(variables["params"]),
                              batch_stats=variables.get("batch_stats", {}))
    step = jax.jit(jtrain.make_train_step(jm, tx))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_losses = []
    for i in range(4):
        state, loss = step(state, jb)
        want_losses.append(float(loss))
        if i == 1:
            np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
            tstate = convert.load_flax_train_state(
                ttrain.state_for(make_t(), 0.1, 0.9), np_tree(state.params),
                np_tree(state.batch_stats), np_tree(state.opt_state[0].trace), int(state.step))
    tstep = ttrain.make_train_step(input_key="images")
    got_losses = [tstep(tstate, _torch_batch(batch))[1].item() for _ in range(2)]
    np.testing.assert_allclose(got_losses, want_losses[2:], rtol=LOSS_RTOL)
    got = convert.train_state_to_flax(tstate)
    assert got["step"] == 4
    for tree in ("params", "batch_stats"):
        want = getattr(state, tree)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_allclose(_leaf(got[tree], path), np.asarray(leaf), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{tree} {path}")
    trace = state.opt_state[0].trace
    for path, leaf in jax.tree_util.tree_leaves_with_path(trace):
        np.testing.assert_allclose(_leaf(got["trace"], path), np.asarray(leaf), rtol=0,
                                   atol=PARAM_ATOL * 10, err_msg=f"trace {path}")


def test_without_the_momentum_a_converted_state_trains_otherwise():
    """The momentum is part of the state: dropping it changes the next step."""
    _, make_t, size = MODELS["resnet"]
    tb = _torch_batch(_images(8, size, seed=9))
    step = ttrain.make_train_step(input_key="images")
    state = ttrain.state_for(make_t(), 0.1, 0.9)
    step(state, tb)
    full = convert.train_state_to_flax(state)
    with_m = convert.load_flax_train_state(ttrain.state_for(make_t()), full["params"],
                                           full["batch_stats"], full["trace"], full["step"])
    without = convert.load_flax_train_state(ttrain.state_for(make_t()), full["params"],
                                            full["batch_stats"], None, full["step"])
    step(with_m, tb)
    step(without, tb)
    step(state, tb)
    a, b, c = (s.model.Dense_0.kernel for s in (with_m, without, state))
    assert torch.equal(a, c) and not torch.equal(b, c)


# ------------------------------------------------------------ checkpoints


def _trained(steps=2, seed=0):
    _, make_t, size = MODELS["resnet"]
    state = ttrain.state_for(make_t(), 0.1, 0.9)
    step = ttrain.make_train_step(input_key="images")
    tb = _torch_batch(_images(8, size, seed=seed))
    for _ in range(steps):
        step(state, tb)
    return state, step, tb


def _assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for (na, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        ma = a.optimizer.state[pa]["momentum_buffer"]
        assert torch.equal(ma, b.optimizer.state[pb]["momentum_buffer"]), na


def test_restore_is_bit_for_bit_and_resumes_as_uninterrupted(tmp_path):
    state, step, tb = _trained()
    mgr = tckpt.CheckpointManager(tmp_path / "ck")
    assert mgr.save(state) == 2
    _, make_t, _ = MODELS["resnet"]
    restored = mgr.restore(ttrain.state_for(make_t(), 0.1, 0.9))
    _assert_states_equal(restored, state)
    assert restored.batch_stats.keys() == state.batch_stats.keys()
    for _ in range(2):
        step(state, tb)
        step(restored, tb)
    _assert_states_equal(restored, state)


def test_retention_keeps_the_newest_three_and_restore_params_reads_a_train_state(tmp_path):
    state, step, tb = _trained(steps=1)
    mgr = tckpt.CheckpointManager(tmp_path / "ck")
    for _ in range(5):
        mgr.save(state)
        step(state, tb)
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    params = mgr.restore_params(4)  # what serving reads, from a train-state directory
    assert set(params) == {n for n, _ in state.model.named_parameters()}
    assert not any(name.endswith((".mean", ".var")) for name in params)
    kept = tckpt.CheckpointManager(tmp_path / "one", max_to_keep=1)
    kept.save(state)
    step(state, tb)
    kept.save(state)
    assert kept.steps() == [state.step]
    with pytest.raises(ValueError, match="max_to_keep"):
        tckpt.CheckpointManager(tmp_path / "bad", max_to_keep=0)


def test_save_once_and_restore_latest(tmp_path):
    state, _, _ = _trained()
    tckpt.save_once(tmp_path / "once", state)
    _, make_t, _ = MODELS["resnet"]
    restored = tckpt.restore_latest(tmp_path / "once", ttrain.state_for(make_t()))
    _assert_states_equal(restored, state)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_latest(tmp_path / "empty", ttrain.state_for(make_t()))


def test_restore_refuses_a_parameters_only_step(tmp_path):
    state, _, _ = _trained(steps=0)
    mgr = tckpt.CheckpointManager(tmp_path / "ck")
    mgr.save(dict(state.model.named_parameters()), 3)
    with pytest.raises(FileNotFoundError, match="parameters only"):
        mgr.restore(state)


def test_a_never_stepped_state_round_trips_without_momentum(tmp_path):
    state, _, _ = _trained(steps=0)
    mgr = tckpt.CheckpointManager(tmp_path / "ck")
    mgr.save(state)
    _, make_t, _ = MODELS["resnet"]
    restored = mgr.restore(ttrain.state_for(make_t(), 0.1, 0.9))
    assert restored.step == 0 and not restored.optimizer.state


# ------------------------------------------------------------ the CLI

CPU = ["--device=cpu", "--dtype=float32"]
RECORD_KEYS = {"model", "chips", "global_batch", "throughput", "throughput_per_chip", "unit",
               "step_time_ms", "final_loss", "final_step", "device"}


@pytest.mark.parametrize("model, flags, unit", [
    ("alexnet", ["--batch-size=2", "--image-size=64"], "images/sec"),
    ("resnet50", ["--batch-size=2", "--image-size=32"], "images/sec"),
    ("resnet50", ["--batch-size=2", "--image-size=32", "--stem=space_to_depth"], "images/sec"),
    ("vit", ["--batch-size=2", "--tiny"], "images/sec"),
    ("bert", ["--batch-size=1", "--seq-len=8"], "tokens/sec"),
], ids=["alexnet", "resnet50", "resnet50-s2d", "vit-tiny", "bert"])
def test_benchmark_cli_trains_each_model_on_the_cpu(capsys, model, flags, unit):
    tbench.main([f"--model={model}", *CPU, "--steps=1", "--warmup=1", *flags])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(record) == RECORD_KEYS
    assert record["unit"] == unit and record["device"] == "cpu"
    assert record["final_step"] == 4 * 1 + 1  # warmup, two short runs, one long
    if model == "alexnet":
        # SGD(0.1) diverges on AlexNet at 64 px within these 5 steps, in the
        # reference too (its CLI at batch 8: loss 8.1e4 at step 4), so the
        # loss is only a number here; the vision tests hold the steps.
        assert isinstance(record["final_loss"], float)
    else:
        assert np.isfinite(record["final_loss"])


def test_benchmark_vit_defaults_to_256_pixels_and_bert_to_base():
    args = tbench.parse_args(["--model=vit", *CPU])
    assert tbench.build_model(args, torch.device("cpu")).config.num_tokens == 256
    args = tbench.parse_args(["--model=vit", *CPU, "--image-size=128"])
    assert tbench.build_model(args, torch.device("cpu")).config.image_size == 128
    args = tbench.parse_args(["--model=bert", *CPU, "--seq-len=513"])
    with pytest.raises(SystemExit):
        tbench.build_model(args, torch.device("cpu"))


@pytest.mark.parametrize("flags", [["--dp=2"], ["--mp=2"], ["--pp=2"]])
def test_benchmark_takes_parallel_flags_at_one_card_only(capsys, flags):
    """On one card --dp/--mp past 1 fail the reference's mesh rule, and
    --pp 2 its device count, before anything is built (--pp needs the
    decoder: the reference's refusals;
    tests/test_torch_benchmark_dp.py runs them over several ranks)."""
    if flags == ["--pp=2"]:
        args = tbench.parse_args(["--model=gpt", *flags])
        with pytest.raises(SystemExit, match=r"^--pp 2 but only 1 device\(s\)$"):
            tbench.check_layout(args, local_ranks=1)
        with pytest.raises(SystemExit):
            tbench.parse_args(["--model=resnet50", *flags])
        assert "--pp requires --model gpt (the pipelined decoder)" in capsys.readouterr().err
    else:
        args = tbench.parse_args(["--model=resnet50", *flags])
        with pytest.raises(SystemExit, match="do not cover 1 devices|1 devices not divisible by 2"):
            tbench.check_layout(args, local_ranks=1)
    args = tbench.parse_args(["--model=resnet50", "--dp=1", "--mp=1", "--pp=1"])
    assert tbench.check_layout(args, local_ranks=1) == 1


def test_benchmark_refuses_gpt_only_flags_and_uneven_accumulation(capsys):
    with pytest.raises(SystemExit):
        tbench.parse_args(["--model=vit", "--fused-xent"])
    assert "--fused-xent requires --model gpt" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tbench.parse_args(["--model=vit", "--batch-size=3", "--grad-accum=2"])
    assert "is not divisible by --grad-accum" in capsys.readouterr().err


def test_benchmark_without_a_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.launch(tbench.parse_args(["--model=vit", "--tiny", "--steps=1", "--warmup=1"]))


def _resume_runs(tmp_path, flags, model=None):
    """Through ``launch`` (one gloo rank in this process, the state sharded
    as on a card): steps 4 then a resumed run to 6, and one uninterrupted
    run to 6, each with its final state dict."""
    ck = ["--checkpoint-every=2", "--warmup=1"]
    args = lambda d, *extra: tbench.parse_args([*CPU, *flags, *ck,  # noqa: E731
                                               f"--checkpoint-dir={tmp_path / d}", *extra])
    model_fn = None if model is None else (lambda device: model())
    launch = lambda a: tbench.launch(a, model_fn=model_fn, gather_params=True)  # noqa: E731
    first = launch(args("a", "--steps=4"))
    resumed = launch(args("a", "--resume", "--steps=6"))
    whole = launch(args("b", "--steps=6"))
    again = launch(args("a", "--resume", "--steps=6"))
    return first.record, resumed, whole, again.record


@pytest.mark.parametrize("which", ["vit-tiny-cli", "resnet18thin"])
def test_a_resumed_run_ends_where_an_uninterrupted_one_does(tmp_path, which):
    if which == "vit-tiny-cli":
        runs = _resume_runs(tmp_path, ["--model=vit", "--tiny", "--batch-size=2"])
    else:
        _, make_t, size = MODELS["resnet"]
        runs = _resume_runs(tmp_path, ["--model=resnet50", "--batch-size=4",
                                       f"--image-size={size}"], make_t)
    first, resumed, whole, again = runs
    assert (first["final_step"], first["resumed_from"], first["noop"]) == (4, 0, False)
    assert (resumed.record["final_step"], resumed.record["resumed_from"],
            resumed.record["noop"]) == (6, 4, False)
    assert (again["final_step"], again["resumed_from"], again["noop"]) == (6, 6, True)
    assert whole.record["final_step"] == 6
    assert whole.losses[4:] == resumed.losses
    assert tckpt.CheckpointManager(tmp_path / "a").steps() == [2, 4, 6]
    assert resumed.state_dict.keys() == whole.state_dict.keys()
    for k, v in whole.state_dict.items():
        assert torch.equal(resumed.state_dict[k], v), k
    # Step 6 on disk: parameters, BatchNorm statistics and momentum alike.
    for name in (tckpt.PARAMS_FILE, tckpt.STATE_FILE):
        a, b = (torch.load(tmp_path / d / "6" / name, weights_only=True) for d in "ab")
        for key in (("momentum", "batch_stats") if name == tckpt.STATE_FILE else (None,)):
            ta, tb = (a, b) if key is None else (a[key], b[key])
            assert ta.keys() == tb.keys()
            for k in tb:
                assert torch.equal(ta[k], tb[k]), (name, key, k)


def test_checkpoint_saves_land_at_multiples_and_at_the_end(tmp_path):
    args = tbench.parse_args([*CPU, "--model=vit", "--tiny", "--batch-size=2", "--warmup=2",
                              "--steps=5", "--checkpoint-every=2",
                              f"--checkpoint-dir={tmp_path}"])
    record = tbench.launch(args).record
    assert record["final_step"] == 5
    # 2 and 4 by the cadence, 5 at the end; retention keeps 3.
    assert tckpt.CheckpointManager(tmp_path).steps() == [2, 4, 5]
    assert record["step_time_ms"] > 0


# ------------------------------------------------- data, keys, pipeline


def test_synthetic_batches_are_seeded_and_shaped():
    make = lambda seed: tdata.synthetic_image_batch(  # noqa: E731
        3, 16, 7, generator=torch.Generator().manual_seed(seed))
    a, b = make(0), make(0)
    assert a["images"].shape == (3, 16, 16, 3) and a["images"].dtype == torch.float32
    assert torch.equal(a["images"], b["images"]) and torch.equal(a["labels"], b["labels"])
    assert int(a["labels"].max()) < 7
    t = tdata.synthetic_token_batch(2, 9, 50, generator=torch.Generator().manual_seed(1))
    assert t["input_ids"].shape == t["labels"].shape == (2, 9)
    assert int(t["input_ids"].max()) < 50


def test_host_keys_are_jax_s():
    key = jax.random.PRNGKey(0)
    words = (0, 0)
    for data in (0, 1, 2**31 + 5):
        key = jax.random.fold_in(key, data)
        words = prng.fold_in_words(words, data)
        assert words == tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    want = jax.random.bernoulli(key, 0.5, (5, 7))
    got = prng.bernoulli(prng.key_tensor(words), 0.5, (5, 7))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefetch_yields_every_batch_in_order_on_the_device():
    batches = [{"x": np.full((2, 3), i, np.float32), "y": [np.arange(i + 1)]}
               for i in range(5)]
    got = list(tpipe.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and torch.equal(b["x"], torch.full((2, 3), i * 1.0))
        assert torch.equal(b["y"][0], torch.arange(i + 1))


def test_prefetch_raises_the_source_s_error_in_the_consumer():
    def source():
        yield np.zeros(2)
        raise KeyError("bad record")

    it = tpipe.prefetch_to_device(source(), device="cpu")
    assert torch.equal(next(it), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(KeyError, match="bad record"):
        next(it)


def test_prefetch_close_stops_the_worker_and_closes_the_source():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield np.array([i])
                i += 1
        finally:
            closed.set()

    it = tpipe.prefetch_to_device(endless(), size=1, device="cpu")
    assert int(next(it)[0]) == 0
    it.close()
    assert closed.wait(timeout=5.0), "the source was not closed"
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            t.name == "prefetch-to-device" and t.is_alive() for t in threading.enumerate()):
        time.sleep(0.02)
    assert not any(t.name == "prefetch-to-device" and t.is_alive()
                   for t in threading.enumerate())


def test_prefetch_checks_its_arguments():
    with pytest.raises(ValueError, match="prefetch size"):
        tpipe.prefetch_to_device([], size=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.prefetch_to_device([])
    got = list(tpipe.batches_from(lambda i: i * i, 4))
    assert got == [0, 1, 4, 9]


def test_peak_bf16_flops_by_card_name(monkeypatch):
    assert tplatform.peak_bf16_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA H100 NVL", None), ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert tplatform.peak_bf16_flops("cuda:0") == want, name
