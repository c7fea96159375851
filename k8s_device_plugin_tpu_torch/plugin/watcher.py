"""Filesystem watch on the kubelet's Registration socket.

The GPU device plugin's own copy of the JAX package's ``plugin/watcher.py``
(the port imports nothing of that package); platform-free, unchanged.

The reference watches /var/lib/kubelet/device-plugins/ with fsnotify and
restarts/stops its plugin servers when kubelet.sock is created/removed
(reference dpm/manager.go:53-55,73-84) — that re-registration dance is the
entire kubelet-restart recovery story.  Python has no stdlib inotify, so this
module binds the Linux inotify syscalls via ctypes, with a stat-polling
fallback for non-Linux/odd environments.  The polling path additionally
detects in-place socket recreation (inode change without a visible delete),
which the real kubelet is known to produce (reference dpm/manager.go:79-80).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
import select
import struct
import threading
from typing import Callable

log = logging.getLogger(__name__)

IN_CREATE = 0x00000100
IN_MOVED_TO = 0x00000080
IN_DELETE = 0x00000200
IN_DELETE_SELF = 0x00000400
IN_IGNORED = 0x00008000
IN_NONBLOCK = 0x00000800

_EVENT_HEADER = struct.Struct("iIII")  # wd, mask, cookie, len


def _load_libc():
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)
        # Probe the symbols we need.
        libc.inotify_init1
        libc.inotify_add_watch
        return libc
    except (OSError, AttributeError):
        return None


class KubeletSocketWatcher(threading.Thread):
    """Fires callbacks when ``socket_name`` appears/disappears in ``directory``.

    ``on_create`` / ``on_remove`` run on the watcher thread; keep them short
    (the manager just sets events / kicks a restart).
    """

    def __init__(
        self,
        directory: str,
        socket_name: str,
        on_create: Callable[[], None],
        on_remove: Callable[[], None],
        poll_interval: float = 1.0,
    ):
        super().__init__(name="kubelet-sock-watcher", daemon=True)
        self._dir = directory
        self._name = socket_name
        self._path = os.path.join(directory, socket_name)
        self._on_create = on_create
        self._on_remove = on_remove
        self._poll_interval = poll_interval
        self._stopped = threading.Event()
        # Set once the watch is armed; callers that must not miss an event
        # (e.g. a kubelet restarting right after plugin startup) wait on it.
        self.ready = threading.Event()

    def stop(self) -> None:
        self._stopped.set()

    # ------------------------------------------------------------------ run

    def run(self) -> None:
        libc = _load_libc()
        fire_initial = False
        while libc is not None and not self._stopped.is_set():
            try:
                self._run_inotify(libc, fire_initial)
                # Watch lost (e.g. the watched directory itself was deleted
                # and recreated by a kubelet reinstall): poll for the dir to
                # come back, then re-arm inotify.
                if not self._stopped.is_set():
                    log.warning("inotify watch on %s lost; re-arming", self._dir)
                    while not self._stopped.wait(self._poll_interval):
                        if os.path.isdir(self._dir):
                            break
                    # The socket may have been recreated before the new watch
                    # armed; have the next arm treat "already present" as a
                    # create.
                    fire_initial = True
                    continue
                return
            except OSError as e:
                log.warning("inotify unavailable (%s); falling back to polling", e)
                break
        if not self._stopped.is_set():
            self._run_polling()

    def _run_inotify(self, libc, fire_initial: bool = False) -> None:
        fd = libc.inotify_init1(IN_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1")
        try:
            wd = libc.inotify_add_watch(
                fd,
                self._dir.encode(),
                IN_CREATE | IN_MOVED_TO | IN_DELETE | IN_DELETE_SELF,
            )
            if wd < 0:
                raise OSError(ctypes.get_errno(), f"inotify_add_watch({self._dir})")
            log.info("watching %s via inotify", self._dir)
            # Also run the inode-change poll: inotify alone misses an in-place
            # bind over an existing path.
            last_ino = self._stat_ino()
            self.ready.set()
            if fire_initial and last_ino is not None:
                log.info("%s present after watch re-arm; treating as created", self._path)
                self._on_create()
            while not self._stopped.is_set():
                readable, _, _ = select.select([fd], [], [], self._poll_interval)
                if readable:
                    for name, mask in self._drain(fd):
                        if mask & (IN_DELETE_SELF | IN_IGNORED):
                            # The watched directory itself went away; the
                            # kernel has dropped the watch.  Return so run()
                            # can re-arm once the dir reappears.
                            if self._stat_ino() is not None or last_ino is not None:
                                self._on_remove()
                            return
                        if name != self._name:
                            continue
                        if mask & (IN_CREATE | IN_MOVED_TO):
                            log.info("%s created", self._path)
                            last_ino = self._stat_ino()
                            self._on_create()
                        elif mask & IN_DELETE:
                            log.info("%s removed", self._path)
                            last_ino = None
                            self._on_remove()
                else:
                    # Inode poll backstop: catches an in-place re-bind AND a
                    # create that raced the watch arming (None -> inode).
                    ino = self._stat_ino()
                    if ino != last_ino:
                        if ino is None:
                            log.info("%s removed (poll)", self._path)
                            self._on_remove()
                        else:
                            log.info("%s (re)created (poll)", self._path)
                            self._on_create()
                    last_ino = ino
        finally:
            os.close(fd)

    def _drain(self, fd: int):
        try:
            data = os.read(fd, 4096)
        except BlockingIOError:
            return
        offset = 0
        while offset + _EVENT_HEADER.size <= len(data):
            _wd, mask, _cookie, name_len = _EVENT_HEADER.unpack_from(data, offset)
            offset += _EVENT_HEADER.size
            name = data[offset : offset + name_len].split(b"\0", 1)[0].decode()
            offset += name_len
            yield name, mask

    def _run_polling(self) -> None:
        log.info("watching %s via stat polling", self._path)
        last_ino = self._stat_ino()
        self.ready.set()
        while not self._stopped.wait(self._poll_interval):
            ino = self._stat_ino()
            if ino == last_ino:
                continue
            if ino is None:
                log.info("%s removed", self._path)
                self._on_remove()
            else:
                log.info("%s (re)created", self._path)
                self._on_create()
            last_ino = ino

    def _stat_ino(self) -> int | None:
        try:
            return os.stat(self._path).st_ino
        except OSError:
            return None
