"""Parameter checkpoints for serving, over ``torch.save``.

Counterpart of the reference's ``models/checkpoint.py`` with what a serving
process needs: save a parameter state dict at a step, find the newest
step, restore its parameters.  Each step is a directory ``<dir>/<step>/``
holding ``params.pt``, the port's flat state dict under flax path names
(``layer_0.attn.query.kernel``); a step appears whole or not at all (it is
written under a temporary name and renamed).  The reference's directories
are orbax's, and orbax needs JAX, so this port cannot read them: a JAX tree
comes over through ``convert.save_flax_params``.  Resuming a train state
(``restore(target)``) comes with the training slice.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Mapping, Optional

import torch

PARAMS_FILE = "params.pt"


class CheckpointManager:
    """The steps under ``directory`` (created if missing).  Saves are
    synchronous, so ``wait`` has nothing to wait for; it and ``close`` keep
    the reference's call shape."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = os.fspath(directory)
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

    def save(self, params: Mapping[str, torch.Tensor], step: int = 0) -> None:
        """Write ``params`` (a flat state dict; tensors go to the CPU) as
        ``step``, replacing a step of that number."""
        final = os.path.join(self.directory, str(int(step)))
        tmp = tempfile.mkdtemp(prefix=f".{int(step)}.", dir=self.directory)
        try:
            state = {name: t.detach().to("cpu").contiguous() for name, t in params.items()}
            torch.save(state, os.path.join(tmp, PARAMS_FILE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def restore_params(self, step: Optional[int] = None) -> dict:
        """The parameter state dict of ``step`` (default: the newest), on
        the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, str(step), PARAMS_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
