"""Host-to-device input pipeline: a prefetching loader for real (not
synthetic) training data.

Counterpart of the reference's ``models/input_pipeline.py``.  Its job on
the card is the same two things: keep host-side batch production off the
critical path (a worker thread runs the user's iterator), and land batches
on the device ahead of the step that reads them, so the host-to-device copy
of batch N+1 overlaps the compute of batch N.  Copies go through pinned
host memory with ``non_blocking=True``: the copy is queued on the device's
current stream and the worker moves on, and the step that reads the batch
later on that stream runs after it.  The benchmark itself trains on
on-device synthetic batches (``data.py``) and does not use this.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils.device import resolve_device

# Sentinel: a distinct object, never equal to a user batch.
_END = object()


class _Error:
    """Carries a worker exception (with its traceback) across the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def to_device(batch: Any, device: torch.device) -> Any:
    """``batch`` (numpy arrays, tensors, nested dicts, lists or tuples) with
    every array on ``device``: through pinned memory with a non-blocking
    copy to the card, as tensors as they are on the CPU."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor):
        return batch
    if device.type == "cuda":
        host = batch if batch.is_pinned() else batch.pin_memory()
        return host.to(device, non_blocking=True)
    return batch.to(device)


def prefetch_to_device(batches: Iterable[Any], size: int = 2, device=None) -> Iterator[Any]:
    """Iterate ``batches`` with a ``size``-deep prefetch buffer on
    ``device`` (the card unless the CPU is asked for).

    A daemon worker thread pulls from ``batches``, copies each batch to the
    device (:func:`to_device`) and parks it in a bounded queue, so the
    consumer gets batches already on the device; ``size=2`` (double
    buffering) hides the copy whenever one copy is faster than one step.
    An exception in the user's iterator is raised in the consumer at its
    ``next()``; closing the returned generator (or dropping it) stops the
    worker, which closes the source.  The buffer holds device memory:
    ``size`` x the batch's bytes.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def close_source() -> None:
        # Close the user's generator from the worker's every exit path so
        # its with-blocks and finally clauses run now, not at some later GC.
        close = getattr(batches, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # codelint: ignore[naked-except] best-effort generator teardown; the worker is already exiting
                pass

    def worker() -> None:
        try:
            for batch in batches:
                if not put(to_device(batch, dev)):
                    return
            put(_END)
        except BaseException as e:  # delivered to the consumer, not lost
            put(_Error(e))
        finally:
            close_source()

    # Validation above and the thread start here are eager (a plain function
    # returning an inner generator): bad arguments fail at the call site, and
    # the first batches are on their way while the caller finishes set-up.
    thread = threading.Thread(target=worker, name="prefetch-to-device", daemon=True)
    thread.start()

    def consume() -> Iterator[Any]:
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                yield item
        finally:
            # Closed (break, GC, an exception in the consumer): tell the
            # worker to stop instead of blocking on a full queue.
            stop.set()

    return consume()


def batches_from(make_batch: Callable[[int], Any], num_batches: int | None = None) -> Iterator[Any]:
    """Adapter: index-based batch factory -> iterator (``None`` = endless).
    The factory runs on the prefetch worker thread, so host-side work it
    does (decode, augment, pack) is off the training critical path."""
    i = 0
    while num_batches is None or i < num_batches:
        yield make_batch(i)
        i += 1
