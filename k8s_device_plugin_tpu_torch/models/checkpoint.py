"""Checkpoints over ``torch.save``: train states to resume, parameters to
serve.

Counterpart of the reference's ``models/checkpoint.py``.  Each step is a
directory ``<dir>/<step>/`` holding ``params.pt``, the flat parameter state
dict under flax path names (``layer_0.attn.query.kernel``,
``BottleneckBlock_3.Conv_1.kernel``), and, for a saved train state,
``train_state.pt``: the step, the model's buffers (``batch_stats``:
BatchNorm's ``mean``/``var``) and the SGD momentum of every parameter that
has one.  A step appears whole or not at all (written under a temporary
name and renamed); the newest ``max_to_keep`` steps are kept.
``restore_params`` reads ``params.pt`` alone, so serving reads a train
state's directory as it reads a parameter checkpoint.

The reference's directories are orbax's, and orbax needs JAX, so this port
cannot read them: a JAX tree comes over through ``convert.py``
(``save_flax_params``, ``load_flax_train_state``).  Saves are synchronous
(the reference's async save is orbax's mechanism; a step is durable when
``save`` returns), so ``wait`` has nothing to wait for.

A sharded train state (``parallel/sharding.shard_train_step``) keeps the
file format, so checkpoints move between meshes as orbax's restore into any
sharding: ``save`` gathers the whole state to rank 0 (``sharding.gather_full``;
every rank calls it), which writes it; ``restore`` reads the files on every
rank, and each keeps its own chunk of every sharded tensor
(``sharding.shard_like``).  The directory must then be one that every rank
reads.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Mapping, Optional

import torch

from ..parallel.sharding import gather_full, shard_like
from .train import TrainState

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"


def _cpu(tensors: Mapping[str, torch.Tensor]) -> dict:
    return {name: t.detach().to("cpu").contiguous() for name, t in tensors.items()}


def _sharded(model) -> bool:
    """Whether ``model`` holds FSDP-sharded parameters (DTensors)."""
    return any(hasattr(p, "device_mesh") for p in model.parameters())


class CheckpointManager:
    """The steps under ``directory`` (created if missing), keeping the newest
    ``max_to_keep``."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.fspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        """Every complete step under the directory, ascending."""
        found = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, PARAMS_FILE)):
                found.append(int(name))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step

    def save(self, state: TrainState | Mapping[str, torch.Tensor], step: Optional[int] = None) -> int:
        """Write a train state at its own step, or a flat parameter state
        dict at ``step`` (default 0), replacing a step of that number; then
        drop the steps past ``max_to_keep``.  Returns the step written."""
        sharded = isinstance(state, TrainState) and _sharded(state.model)
        if isinstance(state, TrainState):
            step = state.step if step is None else step
            model = state.model
            params = dict(model.named_parameters())
            buffers = dict(model.named_buffers())
            momentum = {}
            for name, p in params.items():
                buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
                if buf is not None:
                    momentum[name] = buf
            if sharded:  # whole, on rank 0 (empty elsewhere): every rank calls this
                params, buffers, momentum = (gather_full(t) or {}
                                             for t in (params, buffers, momentum))
            extra = {"step": int(step), "batch_stats": _cpu(buffers), "momentum": _cpu(momentum)}
        else:
            params, extra = state, None
            step = 0 if step is None else step
        if not sharded or torch.distributed.get_rank() == 0:
            self._write(int(step), params, extra)
        if sharded:
            torch.distributed.barrier()  # the step is on disk for every rank
        return int(step)

    def _write(self, step: int, params, extra) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save(_cpu(params), os.path.join(tmp, PARAMS_FILE))
            if extra is not None:
                torch.save(extra, os.path.join(tmp, STATE_FILE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self, target: TrainState, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default: the newest) into ``target`` in place, on
        its model's device: parameters, buffers, momentum and the step
        counter.  Returns ``target``."""
        step = self._resolve(step)
        path = os.path.join(self.directory, str(step))
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(f"step {step} under {self.directory} holds parameters only, "
                                    "not a train state")
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        model = target.model
        params = self.restore_params(step)
        if _sharded(model):
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(shard_like(params[name], p))
                for name, b in model.named_buffers():
                    b.copy_(saved["batch_stats"][name])
        else:
            model.load_state_dict({**params, **saved["batch_stats"]})
        for name, p in model.named_parameters():
            if name in saved["momentum"]:
                buf = shard_like(saved["momentum"][name], p)
                target.optimizer.state[p]["momentum_buffer"] = buf
            else:
                target.optimizer.state.pop(p, None)
        target.step = int(saved["step"])
        return target

    def restore_params(self, step: Optional[int] = None) -> dict:
        """The parameter state dict of ``step`` (default: the newest), on
        the CPU."""
        path = os.path.join(self.directory, str(self._resolve(step)), PARAMS_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_once(directory: str | os.PathLike, state: TrainState) -> None:
    """One-shot save keeping only this step (benchmark/export convenience)."""
    with CheckpointManager(directory, max_to_keep=1) as mgr:
        mgr.save(state)


def restore_latest(directory: str | os.PathLike, target: TrainState) -> TrainState:
    """One-shot restore of the newest step under ``directory`` into
    ``target``."""
    with CheckpointManager(directory) as mgr:
        return mgr.restore(target)
