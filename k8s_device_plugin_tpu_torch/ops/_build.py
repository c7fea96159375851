"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers and the stream
as ``void*``, sizes as ``int``; every entry returns ``cudaGetLastError()``),
so it compiles in seconds without PyTorch's headers.  The shared library
goes to ``build/torch_kernels/<hash>/lib<name>.so`` under the repository
root, where the hash covers the source, every shared header
(``csrc/*.cuh``) and the flags: a changed source or header builds anew, an
unchanged one loads what is there.  Beside it, ``lib<name>.log`` keeps
nvcc's output, ptxas's registers and spills per kernel included
(:func:`ptxas_report` reads it).

Nothing here runs at import.  A wrapper calls :func:`load` at its first
launch; ``chip_smoke.py`` calls :func:`build_all` first so that every
source compiles at once, one nvcc process each, and lets the slowest build
run on beside the checks that do not need it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = (
    "paged_attention", "flash_attention", "flash_attention_bwd",
    "flash_attention_wgmma", "flash_attention_bwd_wgmma", "flash_attention_bwd_dq_wgmma",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_pending: dict[str, tuple] = {}  # builds build_all left running
_entries: dict[tuple[str, str], object] = {}


class KernelError(RuntimeError):
    """A kernel did not build, load or launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA kernels build on the card's machine")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start one nvcc build (None when the library is already built)."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names=SOURCES, background=()) -> None:
    """Compile every named source in parallel (one nvcc each) and wait for
    them, but those named in ``background``: their builds run on, and
    :func:`load` finishes one when it is first needed."""
    started = {}
    try:
        for name in names:
            started[name] = _start(name)
    finally:
        for name, s in started.items():
            if name in background and s is not None:
                with _lock:
                    _pending[name] = s
            else:
                _finish(name, s)


def ptxas_report(name: str) -> dict[str, dict]:
    """Registers, spill bytes and shared memory per kernel of the built
    ``csrc/<name>.cu``, from ptxas's lines in the build log: {mangled
    kernel name: {"registers", "spill_stores", "spill_loads", "smem"}}."""
    report, kernel = {}, None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            report[kernel] = {"registers": None, "spill_stores": 0, "spill_loads": 0, "smem": 0}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[kernel]["spill_stores"], report[kernel]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            report[kernel]["smem"] = int(m.group(1)) if m else 0
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _pending.pop(name, None) or _start(name))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared (``c_void_p`` for pointers and the stream, or ctypes would
    pass them as 32-bit ints) and an ``int`` status result."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry."""
    if status != 0:
        raise KernelError(f"{what}: CUDA error {status} at launch")
