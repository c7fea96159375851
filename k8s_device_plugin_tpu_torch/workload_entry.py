"""Console-script wrappers for the port's workload CLIs.

Counterpart of the JAX package's ``workload_entry.py``.  The GPU device
plugin installs with no ML dependency; the benchmark and serving CLIs
need the ``torch`` extra (see pyproject.toml).  These wrappers turn a
bare-install invocation into a pointer at the extra instead of an
unhandled ModuleNotFoundError from a module-top ``import torch``.
"""

from __future__ import annotations


def _require_workloads(script: str) -> None:
    try:
        import torch  # noqa: F401
    except ModuleNotFoundError as e:
        raise SystemExit(
            f"{script} needs the PyTorch workload dependencies: "
            f"pip install 'k8s-device-plugin-tpu[torch]' (missing: {e.name})"
        )


def benchmark() -> None:
    _require_workloads("gpu-benchmark")
    from .models.benchmark import main

    main()


def serving_engine() -> None:
    _require_workloads("gpu-serving-engine")
    from .models.engine import main

    main()


def serving_http() -> None:
    _require_workloads("gpu-serving-http")
    from .models.http_server import main

    main()
