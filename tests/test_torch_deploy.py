"""The port's deployment layer against the JAX package's.

- each GPU twin under ``deploy/`` against its TPU reference manifest: the
  same kinds, args (the CPU control pod adds the port's ``--device=cpu``),
  card count, env, volumes and Services, the port's module in place of the
  reference's, and nothing of the TPU image left;
- each twin's args through the port's own CLI parser, and the pre-launch
  layout checks at the card count the twin asks for;
- the GPU serve Deployment's pods under the label the GPU router's
  headless Service selects;
- every flag of the reference's ``benchmark``, ``engine`` and
  ``http_server`` parsers taken by the port's, and the two the port takes
  without acting on them saying so on stderr;
- ``GPU_PROBE_LIB`` in ``plugin/native.py``'s search order, and
  ``deploy/Dockerfile.gpu`` shipping the library it names;
- ``chip_smoke.py`` phase 16e taking its pods from the manifests, and its
  serving flags equal to the GPU Deployment's.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import argparse
import ast
import importlib.util
import logging
import pathlib
import re
import shutil
import subprocess

import pytest
import yaml

from k8s_device_plugin_tpu.models import benchmark as jax_benchmark
from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import http_server as jax_http_server
from k8s_device_plugin_tpu_torch.models import benchmark, engine, http_server
from k8s_device_plugin_tpu_torch.plugin import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy"
CPU_FLAG = "--device=cpu"

# (reference, GPU twin)
PAIRS = [
    ("k8s-pod-example-tpu.yaml", "k8s-pod-example-gpu.yaml"),
    ("k8s-pod-example-cpu.yaml", "k8s-pod-example-cpu-torch.yaml"),
    ("k8s-pod-resnet50-tpu4.yaml", "k8s-pod-resnet50-gpu4.yaml"),
    ("k8s-pod-vit-tpu4.yaml", "k8s-pod-vit-gpu4.yaml"),
    ("k8s-pod-bert-tpu8.yaml", "k8s-pod-bert-gpu8.yaml"),
    ("k8s-pod-gpt-pp-tpu8.yaml", "k8s-pod-gpt-pp-gpu8.yaml"),
    ("k8s-job-resnet50-2host.yaml", "k8s-job-resnet50-2host-gpu.yaml"),
    ("k8s-pod-serve-gpt.yaml", "k8s-pod-serve-gpt-gpu.yaml"),
    ("k8s-deploy-serve-http.yaml", "k8s-deploy-serve-http-gpu.yaml"),
]
TWINS = [twin for _, twin in PAIRS]
PARSERS = {"k8s_device_plugin_tpu_torch.models.benchmark": benchmark.parse_args,
           "k8s_device_plugin_tpu_torch.models.engine": engine.parse_args,
           "k8s_device_plugin_tpu_torch.models.http_server": http_server.parse_args}


def _docs(name: str) -> list:
    return list(yaml.safe_load_all((DEPLOY / name).read_text()))


def _pod_spec(doc: dict) -> dict:
    return doc["spec"] if doc["kind"] == "Pod" else doc["spec"]["template"]["spec"]


def _workload(name: str) -> tuple[dict, dict]:
    """The manifest's one workload document (not a Service) and its one
    container."""
    [doc] = [d for d in _docs(name) if d["kind"] != "Service"]
    [container] = _pod_spec(doc)["containers"]
    return doc, container


def _cards(container: dict, resource: str) -> int | None:
    return container.get("resources", {}).get("limits", {}).get(resource)


def _env(container: dict) -> dict:
    return {e["name"]: e.get("value", e.get("valueFrom")) for e in container.get("env", [])}


@pytest.mark.parametrize("reference, twin", PAIRS, ids=TWINS)
def test_twin_holds_its_reference(reference, twin):
    text = (DEPLOY / twin).read_text()
    for word in ("google.com/tpu", "jax-benchmarks", "JAX_PLATFORMS"):
        assert word not in text, word
    assert [d["kind"] for d in _docs(twin)] == [d["kind"] for d in _docs(reference)]
    ref_doc, ref = _workload(reference)
    doc, got = _workload(twin)
    cpu = reference == "k8s-pod-example-cpu.yaml"
    assert got["args"] == ref["args"] + ([CPU_FLAG] if cpu else [])
    assert got["command"] == [c.replace("k8s_device_plugin_tpu.", "k8s_device_plugin_tpu_torch.")
                              for c in ref["command"]]
    assert got["command"] != ref["command"]
    assert got["image"] == "torch-benchmarks:latest"
    assert _cards(got, "nvidia.com/gpu") == _cards(ref, "google.com/tpu")
    ref_env, env = _env(ref), _env(got)
    if cpu:
        ref_env.pop("JAX_PLATFORMS")  # the port pins the CPU by the flag instead
    assert env.keys() == ref_env.keys()
    for key, value in env.items():
        if key == "JAX_COORDINATOR_ADDRESS":
            # Worker 0 of the twin's own Job through its own headless Service.
            [service] = [d for d in _docs(twin) if d["kind"] == "Service"]
            [port] = service["spec"]["ports"]
            assert value == (f"{doc['metadata']['name']}-0.{service['metadata']['name']}:"
                             f"{port['port']}")
        else:
            assert value == ref_env[key], key
    assert [v["name"] for v in _pod_spec(doc).get("volumes", [])] == [
        v["name"] for v in _pod_spec(ref_doc).get("volumes", [])]
    assert got.get("volumeMounts") == ref.get("volumeMounts")
    assert got.get("ports") == ref.get("ports")
    labels = (doc["spec"]["template"]["metadata"]["labels"] if doc["kind"] != "Pod"
              else doc["metadata"].get("labels", {}))
    for service, ref_service in zip([d for d in _docs(twin) if d["kind"] == "Service"],
                                    [d for d in _docs(reference) if d["kind"] == "Service"]):
        assert service["spec"]["ports"] == ref_service["spec"]["ports"]
        assert service["spec"].get("clusterIP") == ref_service["spec"].get("clusterIP")
        assert service["spec"]["selector"].items() <= labels.items()


@pytest.mark.parametrize("twin", TWINS)
def test_the_ports_cli_takes_the_twins_args(twin):
    _, container = _workload(twin)
    module = container["command"][-1]
    args = PARSERS[module](container["args"])
    if twin == "k8s-pod-example-cpu-torch.yaml":
        assert args.device == "cpu"
    else:
        assert getattr(args, "device", None) is None  # the card


@pytest.fixture
def slice_env(monkeypatch):
    """No host or worker variables of this machine's; the test sets its own."""
    import os

    for key in list(os.environ):
        if key.startswith(("TPU_WORKER", "GPU_WORKER", "JAX_COORDINATOR", "JAX_NUM_PROCESSES",
                           "JAX_PROCESS_ID")):
            monkeypatch.delenv(key)
    return monkeypatch


@pytest.mark.parametrize("twin, env, local_cards, world", [
    ("k8s-pod-resnet50-gpu4.yaml", {}, 4, 4),
    ("k8s-pod-vit-gpu4.yaml", {}, 4, 4),
    ("k8s-pod-bert-gpu8.yaml", {}, 8, 8),
    # Allocate's env for a whole host of the two-host job, or the Job's own
    # coordinator variables (worker 1's completion index).
    ("k8s-job-resnet50-2host-gpu.yaml", {"GPU_WORKER_HOSTNAMES": "h0,h1", "GPU_WORKER_ID": "1"},
     8, 16),
    ("k8s-job-resnet50-2host-gpu.yaml", "manifest", 8, 16),
    ("k8s-pod-gpt-pp-gpu8.yaml", {}, 8, 8),
], ids=["resnet50-gpu4", "vit-gpu4", "bert-gpu8", "2host-allocate-env", "2host-job-env",
        "gpt-pp-gpu8"])
def test_the_twins_layouts_pass_the_ports_checks(slice_env, twin, env, local_cards, world):
    _, container = _workload(twin)
    if env == "manifest":
        env = {k: v for k, v in _env(container).items() if isinstance(v, str)}
        env["JAX_PROCESS_ID"] = "1"
    for key, value in env.items():
        slice_env.setenv(key, value)
    args = benchmark.parse_args(container["args"])
    assert _cards(container, "nvidia.com/gpu") == local_cards
    assert benchmark.check_layout(args, local_cards) == world
    if args.pp > 1:
        assert benchmark.check_pipeline(args, local_cards) == args.pp == world


def test_the_gpu_deployment_is_what_the_gpu_router_selects():
    [deployment] = [d for d in _docs("k8s-deploy-serve-http-gpu.yaml") if d["kind"] == "Deployment"]
    labels = deployment["spec"]["template"]["metadata"]["labels"]
    assert deployment["spec"]["selector"]["matchLabels"].items() <= labels.items()
    [headless] = [d for d in _docs("k8s-deploy-router-gpu.yaml")
                  if d["kind"] == "Service" and d["spec"].get("clusterIP") == "None"]
    assert headless["spec"]["selector"] == {"app": "serve-gpt-http-gpu"}
    assert headless["spec"]["selector"].items() <= labels.items()


# ------------------------------------------------------------ CLI flags


class _Built(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _options(main, monkeypatch) -> set:
    """Every option string of the parser ``main`` builds (caught as it
    parses, before it runs anything)."""
    def grab(self, args=None, namespace=None):
        raise _Built(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Built) as built:
        main([])
    return set(built.value.parser._option_string_actions)


@pytest.mark.parametrize("reference, port", [
    (jax_benchmark.main, benchmark.parse_args),
    (jax_engine.main, engine.parse_args),
    (jax_http_server.main, http_server.parse_args),
], ids=["benchmark", "engine", "http_server"])
def test_the_ports_parsers_take_every_reference_flag(monkeypatch, reference, port):
    assert _options(reference, monkeypatch) - _options(port, monkeypatch) == set()


def test_compilation_cache_dir_is_taken_and_said_unused(monkeypatch, capsys):
    """The reference's default and flag; the port says on stderr that it
    does not use XLA's cache, and runs."""
    monkeypatch.setenv("TPU_COMPILATION_CACHE_DIR", "/var/cache/xla")
    assert benchmark.parse_args(["--model=alexnet"]).compilation_cache_dir == "/var/cache/xla"
    ran = []
    monkeypatch.setattr(benchmark, "launch",
                        lambda args: ran.append(args) or benchmark.DistributedRun({}, [], None, []))
    benchmark.main(["--model=alexnet", CPU_FLAG, "--compilation-cache-dir=/tmp/xla"])
    err = capsys.readouterr().err
    assert ran and ran[0].compilation_cache_dir == "/tmp/xla"
    assert "--compilation-cache-dir /tmp/xla: XLA's cache; the PyTorch port does not use it" in err


# ------------------------------------------------------ GPU_PROBE_LIB


def _cc(tmp_path, name: str, source: str, flags=native.CFLAGS, libs=native.LIBS) -> str:
    out = tmp_path / name
    src = tmp_path / f"{name}.c"
    src.write_text(source)
    subprocess.run(["cc", *flags, "-o", str(out), str(src), *libs], check=True,
                   capture_output=True)
    return str(out)


@pytest.mark.parametrize("named", ["built", "missing", "not-a-library", "foreign"])
def test_load_prober_searches_gpu_probe_lib_then_the_checkout(tmp_path, monkeypatch, caplog,
                                                              named):
    if shutil.which("cc") is None:
        pytest.skip("no C compiler on this host: nothing builds a probe library")
    if named == "built":
        path = _cc(tmp_path, "libnvidia_probe.so", native.SOURCE.read_text())
    elif named == "missing":
        path = str(tmp_path / "absent.so")
    elif named == "not-a-library":
        path = str(tmp_path / "text.so")
        pathlib.Path(path).write_text("not an ELF file")
    else:  # loads, but has none of the probe's symbols
        path = _cc(tmp_path, "libforeign.so", "int unrelated(void) { return 0; }\n")
    monkeypatch.setenv("GPU_PROBE_LIB", path)
    with caplog.at_level(logging.WARNING, logger=native.log.name):
        prober = native.load_prober()
    if named == "built":
        assert prober.path == path and not caplog.records
    else:
        assert prober.path == str(native.library_path())
        assert any(path in r.getMessage() for r in caplog.records)
    assert prober.probe(str(tmp_path))[0] == native.PROBE_WRONGTYPE
    # An explicit path comes first.
    assert native.load_prober(prober.path).path == prober.path


def _dockerfile_stages() -> list[str]:
    text = (DEPLOY / "Dockerfile.gpu").read_text()
    text = re.sub(r"\\\n", " ", text)  # join continued lines
    stages, lines = [], [line for line in text.splitlines()
                         if line.strip() and not line.lstrip().startswith("#")]
    for line in lines:
        if line.startswith("FROM "):
            stages.append([])
        stages[-1].append(line)
    return stages


def test_the_gpu_image_runs_the_gpu_plugin_on_a_prebuilt_probe_library():
    build, runtime = _dockerfile_stages()
    assert any("native.build_probe_library" in line for line in build)
    [entry] = [line for line in runtime if line.startswith("ENTRYPOINT ")]
    argv = ast.literal_eval(entry[len("ENTRYPOINT "):])
    assert argv[0] == "gpu-device-plugin"
    scripts = (ROOT / "pyproject.toml").read_text()
    assert 'gpu-device-plugin = "k8s_device_plugin_tpu_torch.plugin.cli:main"' in scripts
    [env] = [line.split("=", 1)[1] for line in runtime if line.startswith("ENV GPU_PROBE_LIB=")]
    assert any(line.startswith("COPY --from=build ") and line.split()[-1] == env
               for line in runtime)
    installs = {word.strip(";") for line in runtime if "pip install" in line
                for word in line.split()}
    assert {"torch", "numpy", "grpcio", "protobuf"} <= installs
    assert not any("k8s_device_plugin_tpu " in line or "jax" in line for line in build + runtime)


# ----------------------------------------------------------- chip_smoke


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_deploy", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phase_16e_takes_its_pods_from_the_manifests(chip_smoke):
    assert chip_smoke.POD_MANIFESTS == ("k8s-pod-example-gpu.yaml", "k8s-pod-serve-gpt-gpu.yaml")
    for name in chip_smoke.POD_MANIFESTS:
        _, container = _workload(name)
        got = chip_smoke.manifest_container(name)
        assert (got["command"], got["args"], got["cards"]) == (
            container["command"], container["args"], _cards(container, "nvidia.com/gpu"))
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    [phase] = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "run_phase_16e"]
    own = [n.value for n in ast.walk(phase) if isinstance(n, ast.Constant)
           and isinstance(n.value, str)
           and (n.value.startswith("--") or "k8s_device_plugin_tpu_torch." in n.value)]
    assert own == []  # no flag or module of its own: the manifests' only
    assert {n.id for n in ast.walk(phase) if isinstance(n, ast.Name)} >= {"POD_MANIFESTS"}


def test_chip_smoke_serves_with_the_gpu_deployments_flags(chip_smoke):
    _, container = _workload("k8s-deploy-serve-http-gpu.yaml")
    own = ("--snapshot-dir=", "--http-port=")
    assert list(chip_smoke.SERVE_FLAGS) == [a for a in container["args"]
                                            if not a.startswith(own)]
