"""Multi-host bootstrap: plugin-injected env -> ``torch.distributed``
process group.

Counterpart of the reference's ``parallel/distributed.py``, with its env
contract, precedence and error texts: the GPU device plugin injects
``GPU_WORKER_HOSTNAMES`` and ``GPU_WORKER_ID`` (``plugin/envs.py``), the
TPU plugin ``TPU_WORKER_HOSTNAMES`` and ``TPU_WORKER_ID``, read when no
``GPU_WORKER_HOSTNAMES`` is set (so one manifest,
``deploy/k8s-job-resnet50-2host.yaml``, drives either package); the
explicit ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID`` and ``JAX_COORDINATOR_PORT`` win over both.

The reference runs one process per host over every local chip; here each
host runs one process per local card, so :func:`initialize` forms a group
of ``num_processes x local_ranks`` ranks in which rank ``process_id x
local_ranks + local_rank`` drives local card ``local_rank``.  Ranks are
then host-major, the order :func:`make_slice_mesh` lays out.  A
single-host allocation joins a local group when its launcher names one
(``init_method``): one rank per card, or a world of one.
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import torch

from .mesh import make_mesh

log = logging.getLogger(__name__)

# The reference's coordinator port (jax's convention); overridable via env.
DEFAULT_COORDINATOR_PORT = 8476

# The worker envs: the GPU device plugin's pair, else the TPU plugin's.
WORKER_ENVS = (("GPU_WORKER_HOSTNAMES", "GPU_WORKER_ID"),
               ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID"))


@dataclass(frozen=True)
class ProcessGroupConfig:
    """The slice's process group, derived from injected env: one entry per
    host process."""

    coordinator_address: str  # "host:port" of worker 0
    num_processes: int
    process_id: int


def process_group_from_env(
    environ: Mapping[str, str] | None = None,
    coordinator_port: int | None = None,
) -> ProcessGroupConfig | None:
    """Derive the slice's process group from the plugin-injected environment.

    Returns None when this pod is a single-host allocation (no
    GPU_WORKER_HOSTNAMES or TPU_WORKER_HOSTNAMES, or a one-host list).
    Explicit JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    always win over the GPU_* / TPU_* derivation, so operators can override
    without touching the plugin.
    """
    environ = os.environ if environ is None else environ
    port = coordinator_port or int(
        environ.get("JAX_COORDINATOR_PORT", DEFAULT_COORDINATOR_PORT)
    )

    explicit = environ.get("JAX_COORDINATOR_ADDRESS")
    if explicit:
        num = int(environ.get("JAX_NUM_PROCESSES", "0"))
        if num <= 0:
            # Only a multi-host hostname list is a usable implicit count:
            # defaulting to 1 would let worker 0 "succeed" solo while its
            # peers crash or hang.
            hostnames = _hostnames(environ)
            if len(hostnames) <= 1:
                raise ValueError(
                    "JAX_COORDINATOR_ADDRESS is set but JAX_NUM_PROCESSES is "
                    "not, and no multi-host TPU_WORKER_HOSTNAMES to infer from"
                )
            num = len(hostnames)
        pid_text = environ.get("JAX_PROCESS_ID", environ.get(_worker_id_name(environ)))
        if pid_text is None:
            if num > 1:
                # Every worker would claim process 0 and group formation
                # would deadlock.
                raise ValueError(
                    "JAX_COORDINATOR_ADDRESS is set with "
                    f"JAX_NUM_PROCESSES={num} but neither JAX_PROCESS_ID nor "
                    "TPU_WORKER_ID identifies this worker"
                )
            pid = 0
        else:
            try:
                pid = int(pid_text)
            except ValueError:
                raise ValueError(
                    f"malformed JAX_PROCESS_ID/TPU_WORKER_ID {pid_text!r}"
                )
        if not 0 <= pid < num:
            raise ValueError(f"process id {pid} out of range for {num} processes")
        address = explicit if ":" in explicit else f"{explicit}:{port}"
        return ProcessGroupConfig(address, num, pid)

    hostnames = _hostnames(environ)
    if len(hostnames) <= 1:
        return None
    id_name = _worker_id_name(environ)
    worker_id_text = environ.get(id_name, "0")
    try:
        worker_id = int(worker_id_text)
    except ValueError:
        # A malformed id must not silently become process 0.
        raise ValueError(f"malformed {id_name} {worker_id_text!r}")
    if not 0 <= worker_id < len(hostnames):
        raise ValueError(
            f"{id_name}={worker_id} out of range for "
            f"{len(hostnames)} worker hostnames"
        )
    return ProcessGroupConfig(
        coordinator_address=f"{hostnames[0]}:{port}",
        num_processes=len(hostnames),
        process_id=worker_id,
    )


def _worker_envs(environ: Mapping[str, str]) -> tuple[str, str]:
    """The (hostnames, worker id) env names this pod's plugin injected:
    the GPU plugin's where GPU_WORKER_HOSTNAMES or GPU_WORKER_ID is set."""
    gpu = WORKER_ENVS[0]
    return gpu if any(name in environ for name in gpu) else WORKER_ENVS[1]


def _worker_id_name(environ: Mapping[str, str]) -> str:
    return _worker_envs(environ)[1]


def _hostnames(environ: Mapping[str, str]) -> tuple[str, ...]:
    text = environ.get(_worker_envs(environ)[0], "")
    return tuple(h.strip() for h in text.split(",") if h.strip())


def initialize(
    environ: Mapping[str, str] | None = None,
    coordinator_port: int | None = None,
    *,
    local_rank: int = 0,
    local_ranks: int = 1,
    init_method: Optional[str] = None,
    backend: Optional[str] = None,
    **kwargs,
) -> bool:
    """Join the process group: the slice's when the injected env says this
    pod is part of a multi-host slice, else the local one ``init_method``
    names (``tcp://127.0.0.1:<port>``), else none.  Idempotent; returns True
    iff a process group is (now) active.  ``backend`` defaults to NCCL with
    a card and gloo without; ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` are set
    as torchrun sets them.  kwargs pass through to ``init_process_group``
    (e.g. ``timeout``)."""
    dist = torch.distributed
    if dist.is_initialized():
        return True
    config = process_group_from_env(environ, coordinator_port)
    if config is None:
        if init_method is None:
            log.info("single-host allocation: no process group")
            return False
        world, rank = local_ranks, local_rank
    else:
        init_method = f"tcp://{config.coordinator_address}"
        world = config.num_processes * local_ranks
        rank = config.process_id * local_ranks + local_rank
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    log.info("joining process group: %s, rank %d/%d (%s)", init_method, rank, world, backend)
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(local_ranks)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    return True


def local_init_method() -> str:
    """A rendezvous on a free local port, ``tcp://127.0.0.1:<port>``: what a
    launcher of local ranks hands each of them as ``init_method``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def join_local(
    device,
    local_rank: int,
    local_ranks: int,
    init_method: str,
    backend: Optional[str] = None,
    environ: Mapping[str, str] | None = None,
    **kwargs,
) -> torch.device:
    """A launched rank's start: its card (``device`` resolved for
    ``local_rank``, ``utils.device.resolve_device``) made current, then
    :func:`initialize` as ``local_rank`` of ``local_ranks`` with NCCL on a
    card and gloo without unless ``backend`` names one (``environ`` and
    kwargs pass through).  Returns the rank's device."""
    from ..utils.device import resolve_device

    device = resolve_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(environ, local_rank=local_rank, local_ranks=local_ranks, init_method=init_method,
               backend=backend or ("nccl" if device.type == "cuda" else "gloo"), **kwargs)
    return device


def make_slice_mesh(
    axes: Mapping[str, int] | None = None,
    devices: Sequence[int] | None = None,
    device_type: Optional[str] = None,
):
    """Mesh over every rank of the slice (all hosts), host-major, so the
    leading (cross-host) axis carries the batch and trailing ones stay
    within a host.  :func:`initialize` numbers ranks host-major, so this is
    ``make_mesh`` over the ranks in ascending order."""
    devices = None if devices is None else sorted(devices)
    return make_mesh(axes, devices=devices, device_type=device_type)
