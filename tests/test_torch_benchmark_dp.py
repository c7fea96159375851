"""The port's training CLI past one card: ``--dp``/``--mp``, and ``--pp``,
on gloo ranks.

``--device cpu`` runs dp·mp ranks (``--dp -1`` counting as 1), or ``pp``
under ``--pp`` past 1, spawned by ``models/benchmark.py`` as it spawns one
per card; the record counts them in ``chips`` and prints once.  The
refusals are the reference's mesh rules and its batch rule: a global batch
the ``dp`` replicas do not split evenly (the ``mp`` ranks of one replica
take the same rows); under ``--pp``, the reference's pipeline refusals.
Each run that
spawns ranks (the CLI, and a script calling ``launch``) is a subprocess
with its own time limit (150 s from the turn the suite gives it,
``tests/torch_ranks.py`` ``group_turn``), killed with every rank it spawned
when it passes it.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import json
import math
import os
import signal
import subprocess
import sys

import pytest

from k8s_device_plugin_tpu_torch.models import benchmark as tbench
from tests import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device=cpu", "--dtype=float32"]


def _run(cmd):
    """``cmd`` from the repo root once the suite gives its ranks a turn
    (``torch_ranks.group_turn``: at most GROUPS_AT_ONCE rank groups at a
    time), one torch thread a rank, killed with every rank it spawned 150 s
    after its turn came; returns (returncode, stdout, stderr)."""
    with torch_ranks.group_turn():
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


def test_cli_trains_vit_on_four_gloo_ranks_and_prints_one_record():
    flags = ["--model=vit", "--tiny", *CPU, "--dp=2", "--mp=2", "--batch-size=4", "--steps=1",
             "--warmup=1"]
    rc, out, err = _run([sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.benchmark",
                         *flags])
    assert rc == 0, err[-3000:]
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(records) == 1, out
    record = records[0]
    assert record["chips"] == 4 and record["global_batch"] == 4 and record["device"] == "cpu"
    assert record["throughput_per_chip"] == pytest.approx(record["throughput"] / 4, abs=0.01)
    assert record["final_step"] == 4 * 1 + 1 and math.isfinite(record["final_loss"])
    assert "mesh: {'dp': 2, 'mp': 2} over 4 rank(s), gloo" in err


@pytest.mark.parametrize("flags, local_ranks, message", [
    (["--dp=2", "--mp=2", "--batch-size=7"], 4,
     "--batch-size 7 does not split over dp=2 replicas: "),
    (["--dp=2", "--mp=2", "--batch-size=4", "--grad-accum=4"], 4,
     "--batch-size 4 does not split over dp=2 replicas x --grad-accum 4"),
    (["--dp=-1", "--mp=-1"], 1, "at most one axis size may be -1"),
    (["--dp=3", "--mp=1"], 4, "axes {'dp': 3, 'mp': 1} do not cover 4 devices"),
    (["--dp=-1", "--mp=3"], 4, "4 devices not divisible by 3"),
], ids=["batch", "batch-accum", "two-rest", "uncovered", "indivisible"])
def test_layouts_the_ranks_cannot_take_exit_first(flags, local_ranks, message):
    args = tbench.parse_args(["--model=vit", "--tiny", *CPU, *flags])
    with pytest.raises(SystemExit) as exc:
        tbench.check_layout(args, local_ranks)
    assert message in str(exc.value)


@pytest.mark.parametrize("flags, hosts, local_ranks, world", [
    (["--dp=2", "--mp=4", "--batch-size=64"], None, 8, 8),    # k8s-pod-bert-tpu8.yaml
    (["--batch-size=512"], None, 4, 4),                       # k8s-pod-resnet50-tpu4.yaml
    (["--batch-size=1024"], "h0,h1", 8, 16),                  # k8s-job-resnet50-2host.yaml
    (["--dp=-1", "--mp=2", "--batch-size=8"], "h0,h1", 2, 4),
    # dp divides these, dp·mp does not: the mp ranks of a replica share rows.
    (["--dp=2", "--mp=2", "--batch-size=6"], None, 4, 4),
    (["--dp=2", "--mp=2", "--batch-size=8", "--grad-accum=4"], None, 4, 4),
], ids=["bert-tpu8", "resnet50-tpu4", "resnet50-2host", "two-hosts-mp2", "dp2-mp2-batch6",
        "dp2-mp2-batch8-accum4"])
def test_deployment_layouts_are_taken(monkeypatch, flags, hosts, local_ranks, world):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    if hosts is None:
        monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    else:
        monkeypatch.setenv("TPU_WORKER_HOSTNAMES", hosts)
        monkeypatch.setenv("TPU_WORKER_ID", "1")
    args = tbench.parse_args(["--model=resnet50", *flags])
    assert tbench.check_layout(args, local_ranks) == world


LAUNCH_FROM_PYTHON = """
import functools

import numpy as np
import torch

from k8s_device_plugin_tpu_torch.models import benchmark as tbench
from k8s_device_plugin_tpu_torch.models.alexnet import AlexNet

model_fn = functools.partial(AlexNet, num_classes=10, dtype=torch.float32, width=0.25,
                             image_size=128)
flags = ["--model=alexnet", "--image-size=128", "--device=cpu", "--dtype=float32",
         "--batch-size=16", "--steps=1", "--warmup=1"]
built = tbench.build(tbench.parse_args(flags), model_fn(device=torch.device("cpu")))
state, losses, _ = tbench.timed_steps(built.step, built.state, built.batch, 1, 1)
got = tbench.launch(tbench.parse_args([*flags, "--dp=1", "--mp=2"]), model_fn=model_fn,
                    gather_params=True)
assert got.record["chips"] == 2 and len(got.losses) == len(losses) == 5
np.testing.assert_allclose(got.losses, [float(x) for x in losses], rtol=1e-5)
for name, value in state.model.state_dict().items():
    np.testing.assert_allclose(got.state_dict[name].numpy(), value.numpy(), rtol=0, atol=1e-5,
                               err_msg=name)
whole = sum(p.numel() * 4 * 2 for p in state.model.parameters())  # weights + momentum
assert all(0.45 < b / whole < 0.6 for b in got.rank_bytes), got.rank_bytes
print("LAUNCH_OK")
tbench.main(["--model=gpt", "--tiny", "--device=cpu", "--dtype=float32", "--pp=2",
             "--pp-schedule=1f1b", "--batch-size=8", "--seq-len=32", "--steps=1", "--warmup=1"])
# --pp 2 over a two-"host" slice on localhost (one stage a host, ranks from
# GPU_WORKER_HOSTNAMES/GPU_WORKER_ID) against the one-host run's losses.
import json, os, subprocess, sys
from k8s_device_plugin_tpu_torch.parallel.distributed import local_init_method

pp_flags = ["--model=gpt", "--tiny", "--device=cpu", "--dtype=float32", "--pp=2",
            "--pp-schedule=gpipe", "--batch-size=8", "--seq-len=32", "--steps=2", "--warmup=1"]
one_host = tbench.launch(tbench.parse_args(pp_flags)).losses
port = local_init_method().rsplit(":", 1)[1]
host = ("import json, sys; from k8s_device_plugin_tpu_torch.models import benchmark as b; "
        "a = b.parse_args(sys.argv[1:]); r = b.launch(a); "
        "print('HOST', json.dumps([b.local_rank_count(a), r.record['chips'], r.losses]))")
hosts = [subprocess.Popen([sys.executable, "-c", host, *pp_flags], stdout=subprocess.PIPE,
                          text=True, env=dict(os.environ, GPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                                              GPU_WORKER_ID=str(i), JAX_COORDINATOR_PORT=port))
         for i in range(2)]
for proc in hosts:
    out, _ = proc.communicate(timeout=100)
    assert proc.returncode == 0, out
    stages, chips, losses = json.loads(out.split("HOST ", 1)[1])
    assert (stages, chips, len(losses)) == (1, 2, len(one_host)), (stages, chips, losses)
    np.testing.assert_allclose(losses, one_host, rtol=1e-6)
print("TWO_HOSTS_OK", one_host)
"""


@pytest.fixture(scope="module")
def launched():
    """One subprocess: ``launch`` from Python at mp 2, then the CLI's
    ``main`` at ``--pp 2 --pp-schedule 1f1b`` (two more gloo ranks)."""
    return _run([sys.executable, "-c", LAUNCH_FROM_PYTHON])


def test_launch_from_python_equals_the_one_process_run(launched):
    """``launch`` with a stand-in model (AlexNet cut to width 0.25, 128 px,
    10 classes: dropout draws the global mask's rows) on two gloo ranks at
    mp 2: every step's loss within 1e-5 relative and the gathered state
    within 1e-5 absolute of the one-process run (float32, 5 steps of SGD
    0.1; the ranks sum the gradient in another order), and each rank
    holding about half the parameter and momentum bytes."""
    rc, out, err = launched
    assert rc == 0 and "LAUNCH_OK" in out, err[-3000:]


def test_cli_trains_the_pipelined_lm_on_two_gloo_ranks(launched):
    """``--pp 2 --pp-schedule 1f1b`` at ``GPTConfig.tiny()`` on the CPU: two
    gloo ranks, one record with the reference's gpt-pp keys, printed once."""
    rc, out, err = launched
    assert rc == 0, err[-3000:]
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert len(records) == 1, out
    record = records[0]
    assert set(record) == GPT_PP_KEYS
    assert (record["model"], record["schedule"], record["pp"], record["n_micro"],
            record["chips"], record["global_batch"], record["device"]) == (
        "gpt-pp", "1f1b", 2, 4, 2, 8, "cpu")
    assert record["unit"] == "tokens/sec" and record["throughput"] > 0
    assert math.isfinite(record["final_loss"])
    assert "mesh: {'pp': 2} over 2 rank(s), gloo, schedule 1f1b, 4 microbatches" in err


def test_pipelined_path_spans_a_two_host_slice(launched):
    """``--pp 2`` over a two-"host" slice (two processes on localhost, each
    running one gloo stage, global ranks from ``GPU_WORKER_HOSTNAMES`` and
    ``GPU_WORKER_ID``): each host's losses equal the one-host ``--pp 2``
    run's within 1e-6 relative (the same stages on the same seeded batch,
    only the transport differs), and the record counts both hosts'
    devices."""
    rc, out, err = launched
    assert rc == 0 and "TWO_HOSTS_OK" in out, err[-3000:]


def test_cpu_ranks_count_dp_times_mp():
    for flags, want in ((["--dp=2", "--mp=2"], 4), (["--dp=-1", "--mp=2"], 2), ([], 1),
                        (["--model=gpt", "--pp=2", "--dp=2", "--mp=2"], 2)):
        assert tbench.local_rank_count(tbench.parse_args([*CPU, *flags])) == want


# The reference's gpt-pp record (k8s_device_plugin_tpu/models/benchmark.py
# run_pipelined), plus the port's ``device``.
GPT_PP_KEYS = {"model", "schedule", "chips", "pp", "n_micro", "global_batch", "throughput",
               "unit", "step_time_ms", "final_loss", "device"}


@pytest.mark.parametrize("flags, message", [
    (["--model=gpt", "--tiny", "--pp=4"], "num_layers 2 not divisible by --pp 4"),
    (["--model=gpt", "--tiny", "--pp=2", "--batch-size=6"], "batch 6 not divisible by n_micro=4"),
    (["--model=gpt", "--tiny", "--pp=2", "--grad-accum=2"],
     "--grad-accum applies to the standard train step only (the fused-xent and pipelined "
     "steps manage their own microbatching, and gpt-decode does not train)"),
    (["--model=gpt", "--tiny", "--pp=2", "--fused-xent"],
     "--fused-xent is not supported with --pp (the pipelined LM head runs inside the "
     "1F1B/GPipe objective); drop one of the flags"),
    (["--model=bert", "--pp=2"], "--pp requires --model gpt (the pipelined decoder)"),
], ids=["layers", "n-micro", "grad-accum", "fused-xent", "model"])
def test_pipeline_refusals_are_the_reference_s(capsys, flags, message):
    """The reference's refusals of --pp (and the port's of a batch the
    microbatches do not split), at four CPU ranks, before anything is
    built."""
    with pytest.raises(SystemExit) as exc:
        tbench.check_layout(tbench.parse_args([*CPU, *flags]), local_ranks=4)
    assert message in str(exc.value) + capsys.readouterr().err


def test_pipeline_takes_a_checkpoint_dir_and_says_it_saves_none(monkeypatch, capsys):
    """The reference takes --checkpoint-dir beside --pp and saves nothing on
    the pipelined path: the port takes the pair, passes its layout checks
    and says so on stderr before it launches the stages."""
    flags = [*CPU, "--model=gpt", "--tiny", "--pp=2", "--batch-size=8", "--checkpoint-dir=ck"]
    args = tbench.parse_args(flags)
    assert (args.pp, args.checkpoint_dir) == (2, "ck")
    assert tbench.check_layout(args, local_ranks=2) == 2
    launched = []
    monkeypatch.setattr(tbench, "launch", lambda args: launched.append(args)
                        or tbench.DistributedRun({"model": "gpt-pp"}, [], None, []))
    tbench.main(flags)
    out, err = capsys.readouterr()
    assert [a.checkpoint_dir for a in launched] == ["ck"] and '"gpt-pp"' in out
    assert "--checkpoint-dir ck: the pipelined path (--pp) saves no checkpoint, as in the " \
        "reference" in err


def test_pipelined_path_keeps_the_standard_one_at_pp_0_and_1():
    for pp in ("0", "1"):
        args = tbench.parse_args([*CPU, "--model=gpt", "--tiny", f"--pp={pp}", "--dp=2",
                                  "--batch-size=4"])
        assert tbench.local_rank_count(args) == 2 and tbench.check_layout(args, 2) == 2
