"""Build and load the native probe helper (``csrc/nvidia_probe.c``).

Counterpart of the JAX package's ``plugin/native.py``.  The daemon's two
hot filesystem paths, the per-pulse health probe of every ``/dev/nvidiaN``
and discovery's ``/dev`` scan, have a C implementation so a fast pulse
costs a fixed few syscalls per card; the same library reads the driver's
card list through NVML where the driver publishes no
``/proc/driver/nvidia/gpus`` entries (``plugin/discovery.py``).

The library builds at first use with the host's C compiler into
``build/gpu_probe/<hash>/libnvidia_probe.so`` under the repository root
(``build/`` is in ``.gitignore``), the hash covering the source and the
flags, as ``ops/_build.py`` builds the kernels.  A daemon on a host
without a compiler takes the Python
sequences in ``plugin/health.py`` and ``plugin/discovery.py``, which stay
the behavioural reference: :func:`shared_prober` returns None there,
while :func:`build_probe_library` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

log = logging.getLogger(__name__)

# Probe result codes: must mirror csrc/nvidia_probe.c.
PROBE_OK = 0
PROBE_BUSY = 1
PROBE_MISSING = 2
PROBE_WRONGTYPE = 3
PROBE_OPENFAIL = 4

_ABI_VERSION = 1
_HEALTHY_CODES = frozenset({PROBE_OK, PROBE_BUSY})

# gpu_nvml_devices' error codes and row widths.
NVML_NO_LIBRARY = -1
NVML_ERRORS = {-1: "no libnvidia-ml.so.1", -2: "NVML lacks a symbol",
               -3: "nvmlInit failed", -4: "an NVML query failed"}
_UUID_LEN = 96
_BUS_ID_LEN = 32

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nvidia_probe.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "gpu_probe"
CFLAGS = ("-O2", "-Wall", "-Wextra", "-std=c11", "-fPIC", "-shared")
LIBS = ("-ldl",)


class NativeProber:
    """Typed wrapper over a loaded libnvidia_probe.so."""

    def __init__(self, lib: ctypes.CDLL, path: str):
        self.path = path
        self._lib = lib
        lib.gpu_probe_abi_version.restype = ctypes.c_int
        lib.gpu_probe_abi_version.argtypes = []
        lib.gpu_probe_device.restype = ctypes.c_int
        lib.gpu_probe_device.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.gpu_probe_devices.restype = None
        lib.gpu_probe_devices.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.gpu_scan_nvidia_minors.restype = ctypes.c_int
        lib.gpu_scan_nvidia_minors.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.gpu_nvml_devices.restype = ctypes.c_int
        lib.gpu_nvml_devices.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint), ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        abi = lib.gpu_probe_abi_version()
        if abi != _ABI_VERSION:
            raise OSError(f"libnvidia_probe ABI {abi} != expected {_ABI_VERSION}")

    def probe(self, device_path: str) -> tuple[int, int]:
        """Probe one device node; returns (code, errno)."""
        err = ctypes.c_int(0)
        code = self._lib.gpu_probe_device(device_path.encode(), ctypes.byref(err))
        return code, err.value

    def probe_many(self, device_paths: list[str]) -> list[tuple[int, int]]:
        """Probe a batch of nodes in one FFI crossing."""
        n = len(device_paths)
        if n == 0:
            return []
        paths = (ctypes.c_char_p * n)(*[p.encode() for p in device_paths])
        codes = (ctypes.c_int * n)()
        errnos = (ctypes.c_int * n)()
        self._lib.gpu_probe_devices(paths, n, codes, errnos)
        return [(codes[i], errnos[i]) for i in range(n)]

    def scan_nvidia_minors(self, dev_dir: str) -> list[int] | None:
        """Minors of the nvidiaN entries under ``dev_dir``; None if
        unreadable."""
        cap = 256
        while True:
            out = (ctypes.c_int * cap)()
            n = self._lib.gpu_scan_nvidia_minors(dev_dir.encode(), out, cap)
            if n < 0:
                return None
            if n <= cap:
                return sorted(out[i] for i in range(n))
            cap = n

    def nvml_devices(self) -> list[dict] | None:
        """The driver's cards as NVML lists them (``index``, ``minor``,
        ``uuid``, ``bus_id``, ``vendor_id``, ``device_id``; the last three
        None where NVML reports no PCI information), or None where NVML
        cannot be read (no driver library, or a call failed: logged)."""
        cap = 64
        while True:
            minors = (ctypes.c_int * cap)()
            uuids = ctypes.create_string_buffer(cap * _UUID_LEN)
            bus_ids = ctypes.create_string_buffer(cap * _BUS_ID_LEN)
            pci_ids = (ctypes.c_uint * cap)()
            status = ctypes.c_int(0)
            n = self._lib.gpu_nvml_devices(minors, uuids, bus_ids, pci_ids, cap,
                                           ctypes.byref(status))
            if n < 0:
                if n != NVML_NO_LIBRARY:
                    log.warning("NVML device list unavailable: %s (NVML status %d)",
                                NVML_ERRORS.get(n, n), status.value)
                return None
            if n <= cap:
                break
            cap = n
        out = []
        for i in range(n):
            raw_uuid = uuids.raw[i * _UUID_LEN:(i + 1) * _UUID_LEN]
            raw_bus = bus_ids.raw[i * _BUS_ID_LEN:(i + 1) * _BUS_ID_LEN]
            pci = pci_ids[i]  # 0 where NVML reports no PCI information
            out.append({
                "index": i,
                "minor": minors[i],
                "uuid": raw_uuid.split(b"\0", 1)[0].decode(),
                "bus_id": raw_bus.split(b"\0", 1)[0].decode() or None,
                "vendor_id": f"0x{pci & 0xFFFF:04x}" if pci else None,
                "device_id": f"0x{pci >> 16:04x}" if pci else None,
            })
        return out


def is_healthy_code(code: int) -> bool:
    """True iff a probe code means the card should be advertised Healthy."""
    return code in _HEALTHY_CODES


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CFLAGS + LIBS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libnvidia_probe.so"


def build_probe_library(source: Path = SOURCE, cc: str | None = None) -> str:
    """Compile ``csrc/nvidia_probe.c`` unless its library is built; returns
    the library's path.  Raises RuntimeError without a C compiler and
    CalledProcessError when the compile fails."""
    out = library_path(source)
    if out.exists():
        return str(out)
    compiler = cc or shutil.which("cc") or shutil.which("gcc")
    if compiler is None:
        raise RuntimeError("no C compiler to build libnvidia_probe")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([compiler, *CFLAGS, "-o", str(tmp), str(source), *LIBS],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return str(out)


def load_prober(lib_path: str | None = None) -> NativeProber:
    """Load the library at ``lib_path``, else the one built from the
    checkout's source (building it now if needed)."""
    path = lib_path or build_probe_library()
    return NativeProber(ctypes.CDLL(path), path)


_shared_lock = threading.Lock()
_shared: tuple[NativeProber | None] | None = None


def shared_prober() -> NativeProber | None:
    """Process-wide prober, loaded once; None (logged, and cached) where
    it cannot be built or loaded, so callers take the Python sequences."""
    global _shared
    with _shared_lock:
        if _shared is None:
            try:
                _shared = (load_prober(),)
            except (OSError, AttributeError, RuntimeError,
                    subprocess.CalledProcessError) as e:
                log.warning("native prober unavailable (%s); using Python probes", e)
                _shared = (None,)
        return _shared[0]
