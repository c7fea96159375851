"""The port's batch-engine CLI against the reference CLI's.

The flag sets are read from both sources' ``add_argument`` calls (the
reference builds its parser inside ``main``): they must agree, defaults
included (``--tp`` too, since tensor-parallel serving was ported), except
the port's own ``--dtype``, ``--seed``, ``--device`` and ``--cuda-graphs``.
``build_engine`` must hand the overload and SLO settings to the engine as
the reference's ``main`` does.  Both CLIs then run the same tiny command
line with ``--overload 1`` and ``0``: their JSON lines must carry the same
keys (the port's own additions named below) and the same request and
token counts.  Tokens themselves differ: each CLI draws its own random
weights.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import ast
import json
import pathlib

import pytest

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu_torch.models import engine as torch_engine
from k8s_device_plugin_tpu_torch.models.engine_overload import OverloadController
from k8s_device_plugin_tpu_torch.utils.slo import SLOTracker

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_ONLY_FLAGS = {"--dtype", "--seed", "--device", "--cuda-graphs"}
REFERENCE_ONLY_FLAGS: set = set()
# Keys the port's JSON line adds to the reference's.
PORT_ONLY_KEYS = {"decode_block", "cuda_graphs", "state_rebuilds", "graph_replays",
                  "device_steps", "spec_rounds", "admission", "preemptions", "device"}
OVERLOAD_FLAGS = ("--overload", "--overload-target-wait", "--overload-max-queue", "--slo",
                  "--slo-ttft-target", "--slo-itl-target")
TINY = ["--hidden=32", "--layers=1", "--heads=4", "--kv-heads=2", "--vocab=128",
        "--page-size=4", "--num-pages=32", "--max-pages-per-seq=8", "--slots=2",
        "--requests=3", "--prompt-len=6", "--max-new=4"]


def _flags(path: str, function: str) -> dict:
    """``{flag: default}`` of every ``add_argument`` call in ``function``."""
    tree = ast.parse((ROOT / path).read_text())
    fn = next(node for node in ast.walk(tree)
              if isinstance(node, ast.FunctionDef) and node.name == function)
    flags = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            name = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            if default is None:
                flags[name] = False if ast.dump(kw.get("action", ast.Constant(None))) == \
                    ast.dump(ast.Constant("store_true")) else None
            else:
                flags[name] = ast.literal_eval(default)
    return flags


def test_cli_flags_and_defaults_equal_the_reference_but_tp():
    ref = _flags("k8s_device_plugin_tpu/models/engine.py", "main")
    port = _flags("k8s_device_plugin_tpu_torch/models/engine.py", "parse_args")
    assert set(ref) - set(port) == REFERENCE_ONLY_FLAGS
    assert set(port) - set(ref) == PORT_ONLY_FLAGS
    shared = set(ref) & set(port)
    assert {f: port[f] for f in shared} == {f: ref[f] for f in shared}
    # The parsed namespace carries the same defaults.
    args = vars(torch_engine.parse_args([]))
    for flag in OVERLOAD_FLAGS:
        assert args[flag[2:].replace("-", "_")] == ref[flag], flag


@pytest.mark.parametrize("argv, overload, slo", [
    ([], (0.5, 512), (2.0, 0.25)),
    (["--overload-target-wait=0.3", "--overload-max-queue=7", "--slo-ttft-target=1.5",
      "--slo-itl-target=0.1"], (0.3, 7), (1.5, 0.1)),
    (["--overload=0", "--slo=0"], None, None),
], ids=["defaults", "set", "off"])
def test_build_engine_hands_overload_and_slo_to_the_engine(argv, overload, slo):
    eng = torch_engine.build_engine(torch_engine.parse_args(
        TINY + ["--device=cpu", "--dtype=float32", *argv]))
    if overload is None:
        assert eng.overload is None
    else:
        assert isinstance(eng.overload, OverloadController)
        assert (eng.overload.cfg.target_queue_wait_s, eng.overload.cfg.max_queue) == overload
    if slo is None:
        assert eng.slo is None and eng.usage is None
    else:
        assert isinstance(eng.slo, SLOTracker) and eng.usage is not None
        assert (eng.slo.objectives["ttft"].threshold_s,
                eng.slo.objectives["itl_p99"].threshold_s) == slo


@pytest.mark.parametrize("overload", ["1", "0"])
def test_both_clis_print_json_lines_with_the_same_keys(capsys, overload):
    argv = TINY + [f"--overload={overload}", f"--slo={overload}"]
    jax_engine.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    torch_engine.main(argv + ["--device=cpu", "--dtype=float32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) - set(want) == PORT_ONLY_KEYS
    assert set(want) <= set(got)
    # ``kernel`` differs by design: the reference resolves auto to its
    # gather path, the port to its CUDA kernel (ROADMAP.md).
    assert got["kernel"] is True and want["kernel"] is False
    for key in ("metric", "unit", "requests", "slots", "tokens", "sampler", "overlap_steps",
                "kv_retain"):
        assert got[key] == want[key], key
    assert got["requests"] == 3 and got["tokens"] == 12
