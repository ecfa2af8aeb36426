"""mmap'd /dev/shm segments — the plasma arena analog.

The reference's plasma store serves objects out of a dlmalloc arena built on
mmap'd /dev/shm (``src/ray/object_manager/plasma/plasma_allocator.h:41``,
fd-passing in ``fling.cc``).  On Linux a named file in /dev/shm *is* POSIX
shared memory, so we get the same zero-copy cross-process mapping with plain
``open`` + ``mmap`` and none of multiprocessing.SharedMemory's
resource-tracker lifetime hazards.  One segment per object (the reference
allocates objects inside one arena; per-object segments are simpler and the
kernel dedups the page-cache either way).
"""

from __future__ import annotations

import mmap
import os

SHM_DIR = "/dev/shm"
# Per-node override: a cluster node agent points its workers at a private
# tmpfs subdirectory so that two nodes sharing one test host have honestly
# disjoint object namespaces (a remote segment is only reachable through
# the object-transfer plane, never by accidental same-host attach).
_SHM_DIR_ENV = "RAY_TPU_TORCH_SHM_DIR"


def shm_dir() -> str:
    return os.environ.get(_SHM_DIR_ENV, SHM_DIR)


class ShmSegment:
    """A named shared-memory segment holding one sealed object."""

    def __init__(self, name: str, size: int, create: bool):
        self.name = name
        self.size = size
        path = os.path.join(shm_dir(), name)
        if create:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                if size <= 0:
                    size = os.fstat(fd).st_size
                    self.size = size
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)

    @staticmethod
    def path_for(name: str) -> str:
        return os.path.join(shm_dir(), name)

    @classmethod
    def create(cls, name: str, size: int) -> "ShmSegment":
        return cls(name, size, create=True)

    @classmethod
    def attach(cls, name: str, size: int = -1) -> "ShmSegment":
        return cls(name, size, create=False)

    @property
    def buf(self) -> memoryview:
        return memoryview(self._mm)

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            # Exported zero-copy views still alive; mapping will be dropped
            # at process exit (matches plasma clients holding mmaps open).
            pass

    @staticmethod
    def unlink(name: str) -> None:
        try:
            os.unlink(os.path.join(shm_dir(), name))
        except FileNotFoundError:
            pass

    @staticmethod
    def exists(name: str) -> bool:
        return os.path.exists(os.path.join(shm_dir(), name))


# ---------------------------------------------------------------------------
# Session-scoped naming + orphan sweeping
# ---------------------------------------------------------------------------
# Segment names are "{prefix}-{session}-{oid}".  Every session also writes a
# liveness marker "{prefix}-{session}-alive" containing the head PID, so the
# next init() can reclaim segments a SIGKILL'd head left behind without
# touching a concurrently-running session's objects.

_SESSION_ENV = "RAY_TPU_TORCH_SESSION"


def current_session_id() -> str:
    return os.environ.get(_SESSION_ENV, "nosession")


def session_shm_name(oid_hex: str) -> str:
    from ray_tpu_torch._private.config import get_config

    return f"{get_config().shm_prefix}-{current_session_id()}-{oid_hex}"


def write_session_marker(session_id: str, pid: int) -> None:
    from ray_tpu_torch._private.config import get_config

    path = os.path.join(shm_dir(), f"{get_config().shm_prefix}-{session_id}-alive")
    with open(path, "w") as f:
        f.write(str(pid))


def remove_session_marker(session_id: str) -> None:
    from ray_tpu_torch._private.config import get_config

    try:
        os.unlink(os.path.join(shm_dir(), f"{get_config().shm_prefix}-{session_id}-alive"))
    except OSError:
        pass


def sweep_orphaned_segments() -> int:
    """Unlink segments belonging to sessions whose head process is dead
    (no marker, or marker PID not alive).  Returns how many were removed.
    Called at head start — the plasma-store restart cleanup the reference
    gets from deleting its whole arena file."""
    from ray_tpu_torch._private.config import get_config

    prefix = get_config().shm_prefix
    try:
        names = os.listdir(shm_dir())
    except OSError:
        return 0
    sessions: dict = {}
    for n in names:
        if not n.startswith(prefix + "-"):
            continue
        rest = n[len(prefix) + 1:]
        sid = rest.split("-", 1)[0]
        sessions.setdefault(sid, []).append(n)
    removed = 0
    for sid, segs in sessions.items():
        marker = f"{prefix}-{sid}-alive"
        alive = False
        try:
            with open(os.path.join(shm_dir(), marker)) as f:
                pid = int(f.read().strip() or "0")
            os.kill(pid, 0)  # raises if dead
            # a ZOMBIE still answers kill(pid, 0) but owns nothing — in
            # containers whose pid 1 never reaps orphans, a SIGKILL'd
            # head would otherwise pin its segments forever
            with open(f"/proc/{pid}/stat") as f:
                alive = f.read().rsplit(")", 1)[-1].split()[0] != "Z"
        except (OSError, ValueError, IndexError):
            alive = False
        if alive:
            continue
        for n in segs:
            try:
                os.unlink(os.path.join(shm_dir(), n))
                removed += 1
            except OSError:
                pass
    return removed
