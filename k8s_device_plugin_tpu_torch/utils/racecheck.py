"""Lock-discipline race detector for host-side shared state.

The port's own copy of the reference's ``utils/racecheck.py`` (the port
imports nothing of the JAX package); its behaviour and messages are the
reference's.

The serving engine's host side has a threading contract: ``submit()`` and
``cancel()`` run on request-handler threads and the metrics scraper reads
gauges concurrently, so the queue, the free-page pool and the page
refcounts are only ever touched under the engine lock, and the in-flight
overlap round only on the thread that steps the engine.  This module
detects violations of that contract:

- ``GuardedDeque`` / ``GuardedDict`` wrap the shared containers and assert
  on every mutating operation that the declared lock is held by the
  calling thread; a violation raises ``LockDisciplineError`` at the
  faulty call site instead of corrupting state with a probability a
  stress test may or may not hit.
- ``OwnerGuard`` holds owner-thread-only state (the in-flight round) to
  one thread, or to a thread holding the engine lock.
- ``ServingEngine(..., racecheck=True)`` swaps its queue, free pages and
  page refcounts for guarded versions and guards the in-flight round.

Single-threaded fast path: ``_is_owned`` is one C-level call; the guard
adds ~100 ns per container op and is off by default.
"""

from __future__ import annotations

import threading
import warnings
from collections import deque
from typing import Iterable, Optional

# Lock types already warned about on the fail-open path (one warning per
# type, not per call — _owned runs at every mutation site).
_FAIL_OPEN_WARNED: set = set()


class LockDisciplineError(AssertionError):
    """A lock-protected container was touched without its lock held."""


def _owned(lock) -> bool:
    # RLock exposes _is_owned (CPython, PyPy); a plain Lock would need
    # owner tracking we don't use (the engine lock is reentrant).  This
    # is a test-only instrument, so when the introspection hook is
    # absent (exotic lock type, future rename) we FAIL OPEN — no
    # discipline checking — rather than turn every guarded op into an
    # AttributeError on code that may be perfectly correct.
    probe = getattr(lock, "_is_owned", None)
    if probe is None:
        # Warn once per lock type so a silent fail-open can't masquerade
        # as a passing race check (e.g. an RLock->Lock refactor would
        # otherwise turn every stress suite into a no-op detector).
        key = type(lock)
        if key not in _FAIL_OPEN_WARNED:
            _FAIL_OPEN_WARNED.add(key)
            warnings.warn(
                f"racecheck: lock type {key.__name__} has no _is_owned "
                "introspection hook; lock-discipline checking is DISABLED "
                "for containers guarded by it",
                RuntimeWarning,
                # user mutation site -> guarded wrapper -> _check -> _owned
                stacklevel=4,
            )
        return True
    return probe()


class OwnerGuard:
    """Single-owner discipline for state that is NOT lock-protected but
    owner-thread-only by contract — the engine's in-flight overlap
    record: the step loop dispatches and consumes it (no lock — the hot
    path) while ``submit()``/``cancel()`` mutate slots under the engine
    lock.  The dispatch/consume handoff itself must therefore only ever
    run on the ONE owner thread, or (for tests/tools that drive a
    drained engine from elsewhere) with the engine lock held, which
    serializes against the contract's other side.

    The first thread to call :meth:`check` off-lock becomes the owner;
    any other thread doing so afterwards raises
    :class:`LockDisciplineError` at the faulty call site.  A lock-held
    check re-binds ownership to the calling thread (holding the lock IS
    the license to take over — e.g. the stress suites drain on the main
    thread after stopping the server loop).

    ``steal_on_lock=False`` keeps the lock-held license but WITHOUT the
    ownership rebind: a lock-holding thread may touch the state (it is
    serialized against the owner, who also takes the lock for its own
    mutations under this mode's contract) yet does not become the new
    off-lock owner.  This is the router poll-loop shape: the poll thread
    owns the per-replica poll state off-lock, while request/stream
    threads marking a replica draining/fenced on failover must hold the
    router lock — a transient request thread must not steal ownership
    from the long-lived poll loop (its later off-lock poll would then
    false-trip while the request thread is still alive)."""

    def __init__(self, lock, name: str = "owned", steal_on_lock: bool = True):
        self._lock = lock
        self._name = name
        self._steal_on_lock = steal_on_lock
        self._owner: Optional[threading.Thread] = None

    def check(self, op: str) -> None:
        me = threading.current_thread()
        if _owned(self._lock):
            if self._steal_on_lock:
                self._owner = me
            return
        if self._owner is None or not self._owner.is_alive():
            # First toucher (or the previous owner thread exited — a
            # server loop died and another thread inherits the engine).
            self._owner = me
            return
        if self._owner is not me:
            raise LockDisciplineError(
                f"{self._name}.{op} from thread {me.name!r} (owner: "
                f"{self._owner.name!r}) without the engine lock held"
            )


class GuardedDeque(deque):
    """A deque that asserts ``lock`` is held on every mutation.

    Reads (len, iteration, indexing) are deliberately unguarded: the
    engine's contract allows lock-free reads of approximate state (gauge
    snapshots), and guarding them would flag the benign ones.  Mutations
    are never benign off-lock — a deque resize mid-iteration crashes the
    scraper thread.
    """

    _MUTATORS = (
        "append", "appendleft", "pop", "popleft", "extend", "extendleft",
        "remove", "insert", "clear", "rotate", "__setitem__", "__delitem__",
        "__iadd__",
    )

    def __init__(self, iterable: Iterable = (), *, lock, name: str = "deque"):
        super().__init__(iterable)
        self._lock = lock
        self._name = name

    def _check(self, op: str) -> None:
        if not _owned(self._lock):
            raise LockDisciplineError(
                f"{self._name}.{op}() without the engine lock held "
                f"(thread {threading.current_thread().name})"
            )


class GuardedDict(dict):
    """A dict that asserts ``lock`` is held on every mutation (same read
    policy as GuardedDeque)."""

    _MUTATORS = (
        "__setitem__", "__delitem__", "pop", "popitem", "clear", "update",
        "setdefault",
    )

    def __init__(self, *args, lock, name: str = "dict", **kw):
        # Build content first so the initial fill needs no lock.
        super().__init__(*args, **kw)
        self._lock = lock
        self._name = name

    def _check(self, op: str) -> None:
        if not _owned(self._lock):
            raise LockDisciplineError(
                f"{self._name}.{op}() without the engine lock held "
                f"(thread {threading.current_thread().name})"
            )


def _install_guards(cls, mutators):
    """Generate checking overrides for every mutator name: each calls
    _check(op) then the parent implementation.  Done at import time (not
    per instance) so instances carry no per-object closures and each op
    pays one extra attribute check, nothing more."""
    for op in mutators:
        parent = getattr(cls.__mro__[1], op)

        def make(op=op, parent=parent):
            def guarded(self, *a, **kw):
                self._check(op)
                return parent(self, *a, **kw)

            guarded.__name__ = op
            return guarded

        setattr(cls, op, make())


_install_guards(GuardedDeque, GuardedDeque._MUTATORS)
_install_guards(GuardedDict, GuardedDict._MUTATORS)
