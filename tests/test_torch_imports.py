"""The PyTorch port stands alone: it imports neither JAX/flax nor any module
of the JAX package ``k8s_device_plugin_tpu``, and its entry points run on
the card unless the CPU is asked for.

The name check matches ``k8s_device_plugin_tpu`` and
``k8s_device_plugin_tpu.<x>`` exactly, never the shared prefix of
``k8s_device_plugin_tpu_torch``.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "k8s_device_plugin_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "k8s_device_plugin_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_banned_name_match_is_exact():
    assert _banned("k8s_device_plugin_tpu") and _banned("k8s_device_plugin_tpu.models.engine")
    assert _banned("jax.numpy") and _banned("flax")
    assert not _banned("k8s_device_plugin_tpu_torch")
    assert not _banned("k8s_device_plugin_tpu_torch.ops.tuning")
    assert not _banned("jaxtyping")


def test_no_port_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names if _banned(n)]
    assert not offenders, offenders


def test_every_port_module_imports_with_jax_blocked():
    """A fresh interpreter where importing jax, flax or the JAX package
    fails; every port module must still import."""
    mods = _port_modules()
    assert len(mods) >= 100
    for name in ("ops.fused_xent", "ops.quant", "models.data", "models.train",
                 "models.benchmark", "utils.flight", "utils.failpoints", "utils.spans",
                 "utils.anomaly", "utils.slo", "utils.postmortem", "utils.tracing",
                 "models.engine_overload", "models.engine_watchdog", "models.engine_profiler",
                 "models.engine_snapshot", "models.engine_kvcache", "models.engine_handoff",
                 "models.http_server", "utils.racecheck", "utils.prefixbloom", "utils.ring",
                 "models.lora", "models.speculative", "models.engine_spec",
                 "models.checkpoint", "models.layers", "models.resnet", "models.alexnet",
                 "models.vit", "models.bert", "models.input_pipeline", "utils.platform",
                 "parallel.pipeline", "parallel.pipeline_1f1b", "parallel.pipeline_lm",
                 "kubelet.constants", "kubelet.api", "kubelet.deviceplugin_pb2",
                 "kubelet.podresources_pb2", "utils.logging", "plugin.topology",
                 "plugin.native", "plugin.discovery", "plugin.envs", "plugin.health",
                 "plugin.server", "plugin.watcher", "plugin.manager", "plugin.resources",
                 "plugin.attribution", "plugin.selftest", "plugin.cli", "workload_entry",
                 "router", "router.__main__", "router.ring", "router.breaker", "router.policy",
                 "router.disagg", "router.migration", "router.fabric", "router.prober",
                 "router.postmortem", "router.server", "controller", "controller.__main__",
                 "controller.actuators", "controller.reconciler", "controller.server",
                 "models.traffic", "models.handoff_wire"):
        assert f"k8s_device_plugin_tpu_torch.{name}" in mods
    code = (
        "import sys\n"
        f"for name in {BANNED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {mods!r}:\n"
        "    importlib.import_module(mod)\n"
        "loaded = [m for m in sys.modules if m in "
        f"{BANNED!r} or m.startswith(('jax.', 'flax.', 'k8s_device_plugin_tpu.'))]\n"
        "assert not [m for m in loaded if sys.modules[m] is not None], loaded\n"
        "print('ok', len(" + repr(mods) + "))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_router_and_controller_import_with_torch_blocked():
    """The router and the controller run beside the replicas with no card
    and, like the reference's, load no torch: a fresh interpreter where
    importing torch fails must import both, their CLIs and the donor walk
    the controller's warm joins use."""
    code = (
        "import sys\n"
        f"for name in {BANNED + ('torch',)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        "for mod in ('router', 'router.__main__', 'controller', 'controller.__main__',\n"
        "            'controller.actuators', 'models.handoff_wire', 'utils.ring'):\n"
        "    importlib.import_module('k8s_device_plugin_tpu_torch.' + mod)\n"
        "from k8s_device_plugin_tpu_torch.utils.ring import donor_for\n"
        "assert donor_for('c:1', ['a:1', 'b:1']) in ('a:1', 'b:1')\n"
        "assert not [m for m in sys.modules if m.startswith('torch.')], 'torch loaded'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_resolve_device():
    from k8s_device_plugin_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for asked in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(asked)


def test_fp32_reference_precision_turns_tf32_off():
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        fp32_reference_precision()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_metrics_registry_renders_engine_series():
    from k8s_device_plugin_tpu_torch.models.engine_types import EngineMetrics
    from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry

    m = EngineMetrics(MetricsRegistry())
    m.tokens.inc(3)
    for v in (0.004, 0.02, 0.02, 0.3):
        m.itl_seconds.observe(v)
    snap = m.ttft_seconds.snapshot()
    m.ttft_seconds.observe(0.2)
    text = m.registry.render()
    assert "tpu_engine_tokens_total 3" in text
    assert 'tpu_engine_itl_seconds_bucket{le="0.025"} 3' in text
    assert m.ttft_seconds.quantile(0.5, since=snap) == pytest.approx(0.175)
    assert m.itl_seconds.quantile(0.5) == pytest.approx(0.01 + 0.015 * 1 / 2)
    with pytest.raises(ValueError, match="duplicate"):
        m.registry.counter("tpu_engine_tokens_total", "again")


@pytest.mark.parametrize("model", ["gpt-decode", "serving"])
def test_inference_benchmarks_raise_without_a_card(model):
    """``--model gpt-decode`` and ``--model serving`` run on the card unless
    ``--device cpu`` asks for the CPU; with no card they raise, and never
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from k8s_device_plugin_tpu_torch.models import benchmark

    args = benchmark.parse_args(["--model", model, "--tiny"])
    run = benchmark.run_decode if model == "gpt-decode" else benchmark.run_serving
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)
