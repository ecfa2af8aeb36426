"""Cross-node object transfer — the ObjectManager analog.

The reference moves objects between nodes with chunked gRPC pushes between
per-node ObjectManagers, located through an ownership-based directory
(``src/ray/object_manager/object_manager.h:117``, ``pull_manager.h:48``,
``ownership_based_object_directory.h:37``).  Here every node (head and
agents) runs an :class:`ObjectServer` over its local shm directory, the
head's registry is the location directory, and consumers pull with
:func:`pull_object`: chunked transfer straight into a segment in the
consumer's local shm namespace, attached zero-copy afterwards.

Connections to remote servers are cached per address (the reference pools
its gRPC channels the same way).
"""

from __future__ import annotations

import logging
import mmap
import os
import socket as socket_mod
import threading
from multiprocessing.connection import Client as MPClient, Connection, Listener
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.shm import ShmSegment, shm_dir

logger = logging.getLogger(__name__)

CHUNK = 32 << 20  # 32 MiB sendfile spans (object_manager chunk analog)

Addr = Tuple[str, int]


class ObjectServer:
    """Serves local shm segments to remote pullers (PushManager analog)."""

    def __init__(self, host: str, authkey: bytes):
        self._listener = Listener((host, 0), family="AF_INET", authkey=authkey, backlog=16)
        self.addr: Addr = self._listener.address
        self._shutdown = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="object-server")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except Exception:
                if self._shutdown:
                    return
                continue
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: Connection) -> None:
        try:
            while not self._shutdown:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                if msg.get("arena"):
                    # a slice of the local arena file (native store path)
                    path = os.path.join(shm_dir(), os.path.basename(msg["arena"]))
                    base, size = int(msg["off"]), int(msg["size"])
                else:
                    # names are flat session-scoped identifiers; never
                    # serve a path outside the local shm dir
                    path = os.path.join(shm_dir(), os.path.basename(msg.get("name", "")))
                    base, size = 0, -1
                try:
                    fd = os.open(path, os.O_RDONLY)
                except OSError:
                    conn.send({"ok": False, "error": f"no such segment {path}"})
                    continue
                try:
                    file_size = os.fstat(fd).st_size
                    if size < 0:
                        size = file_size
                    if base < 0 or base + size > file_size:
                        conn.send({"ok": False,
                                   "error": f"range [{base}, {base + size}) "
                                            f"outside file of {file_size}"})
                        continue
                    if msg.get("raw"):
                        # kernel-side file->socket copy: no userspace pread
                        # buffer, no mp framing — on a CPU-starved host the
                        # copy count IS the bandwidth ceiling
                        conn.send({"ok": True, "size": size, "raw": True})
                        cfd = conn.fileno()
                        off = 0
                        while off < size:
                            sent = os.sendfile(
                                cfd, fd, base + off, min(CHUNK, size - off))
                            if sent == 0:  # peer gone / truncation race
                                conn.close()
                                return
                            off += sent
                        continue
                    conn.send({"ok": True, "size": size})
                    off = 0
                    while off < size:
                        data = os.pread(fd, min(CHUNK, size - off), base + off)
                        if not data:  # hole/truncation race: fail the stream
                            conn.close()
                            return
                        conn.send_bytes(data)
                        off += len(data)
                finally:
                    os.close(fd)
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def close(self) -> None:
        self._shutdown = True
        from ray_tpu_torch._private.netutil import unblock_listener

        unblock_listener(self._listener)  # wakes the parked accept loop


# -- pull client -----------------------------------------------------------

# addr -> [connection-or-None, per-connection lock].  The per-connection
# lock serializes the dial and request/response pairs on one wire; pulls
# from different nodes proceed concurrently.
_conns: Dict[Addr, list] = {}
_conns_lock = threading.Lock()
_authkey: Optional[bytes] = None


def configure(authkey: bytes) -> None:
    """Set the cluster authkey used when dialing remote object servers."""
    global _authkey
    _authkey = authkey


def _connection(addr: Addr) -> Tuple[Connection, threading.Lock]:
    import time
    from multiprocessing import AuthenticationError

    # the global lock only guards the dict; the (possibly slow) TCP dial
    # happens under the per-address lock so an unreachable node can't
    # stall pulls from healthy nodes
    with _conns_lock:
        entry = _conns.get(addr)
        if entry is None:
            entry = [None, threading.Lock()]
            _conns[addr] = entry
    conn, lock = entry
    if conn is not None:
        return conn, lock
    with lock:
        if entry[0] is None:
            # the mp handshake occasionally loses a challenge race when
            # several processes dial one listener at once — retry, it is
            # not a credentials problem (same guard as CoreClient)
            for attempt in range(5):
                try:
                    entry[0] = MPClient(tuple(addr), family="AF_INET", authkey=_authkey)
                    break
                except (AuthenticationError, OSError, EOFError):
                    if attempt == 4:
                        with _conns_lock:
                            _conns.pop(addr, None)  # next pull redials
                        raise
                    # redial backoff: waiters need this conn live anyway
                    time.sleep(0.05 * (attempt + 1))  # raylint: disable=R4
        return entry[0], lock


def _evict(addr: Addr, conn: Connection) -> None:
    """Drop a connection whose request/response stream may be desynced (a
    failed mid-transfer pull leaves undrained chunks on the wire)."""
    with _conns_lock:
        entry = _conns.get(addr)
        if entry is not None and entry[0] is conn:
            del _conns[addr]
    try:
        conn.close()
    except Exception:
        pass


def _arena_local_copy(dst_path: str, arena: tuple, size: int) -> bool:
    """Same-HOST fast path: the origin's arena file is visible in this
    host's tmpfs (emulated multi-node, or co-located nodes), so the slice
    copies kernel-side with copy_file_range — no sockets, one copy.  The
    reference gets the same effect from its per-node shared plasma store.
    Returns False (caller takes the socket path) if the arena isn't local
    or the copy fails.  ``RAY_TPU_TORCH_FORCE_REMOTE_PULL=1`` disables it
    (benchmarks that specifically measure the network plane)."""
    if size < 0 or os.environ.get("RAY_TPU_TORCH_FORCE_REMOTE_PULL"):
        return False
    # the origin's arena path is host-absolute; when it exists HERE the
    # origin shares this host (namespaced shm dirs notwithstanding —
    # arena names are session+node scoped, so a hit can't be a stranger)
    src = arena[0] if os.path.isabs(arena[0]) and os.path.exists(arena[0]) \
        else os.path.join(shm_dir(), os.path.basename(arena[0]))
    base = int(arena[1])
    try:
        sfd = os.open(src, os.O_RDONLY)
    except OSError:
        return False
    dfd = -1
    tmp = f"{dst_path}.lcopy.{os.getpid()}.{os.urandom(2).hex()}"
    try:
        if base + size > os.fstat(sfd).st_size:
            return False
        dfd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
        off_in, off_out = base, 0
        while off_out < size:
            n = os.copy_file_range(sfd, dfd, size - off_out,
                                   offset_src=off_in, offset_dst=off_out)
            if n == 0:
                raise OSError("copy_file_range returned 0")
            off_in += n
            off_out += n
        os.rename(tmp, dst_path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    finally:
        os.close(sfd)
        if dfd >= 0:
            os.close(dfd)


def pull_object(name: str, addr: Addr, expected_size: int = -1,
                arena: Optional[tuple] = None) -> None:
    """Fetch segment ``name`` from the object server at ``addr`` into the
    local shm dir (PullManager analog: chunked transfer into local plasma).
    With ``arena=(path, offset)`` the origin payload is an arena slice
    rather than a standalone file; the local copy is still a file named
    ``name``.

    Idempotent: if the local copy already exists, returns immediately.
    """
    addr = tuple(addr)
    path = os.path.join(shm_dir(), name)
    if os.path.exists(path):
        return
    if arena is not None and _arena_local_copy(path, arena, expected_size):
        return
    tmp = f"{path}.pull.{os.getpid()}.{threading.get_ident()}.{os.urandom(2).hex()}"
    conn, req_lock = _connection(addr)
    fd = -1
    try:
        with req_lock:
            if arena is not None:
                conn.send({"arena": arena[0], "off": arena[1],
                           "size": expected_size, "raw": True})
            else:
                conn.send({"name": name, "raw": True})
            # req_lock IS the pull-protocol serializer for this conn —
            # interleaved requests would desync the chunk stream
            hdr = conn.recv()  # raylint: disable=R4
            if not hdr.get("ok"):
                # clean protocol state — no chunks follow an error header
                raise FileNotFoundError(hdr.get("error", f"pull of {name} failed"))
            size = hdr["size"]
            if expected_size >= 0 and size != expected_size:
                _evict(addr, conn)  # chunks are in flight; wire is dirty
                raise IOError(f"pull of {name}: size {size} != expected {expected_size}")
            fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            if hdr.get("raw"):
                # raw payload stream straight into the mmapped destination:
                # one kernel->user copy total (the server side is sendfile)
                if size > 0:
                    os.ftruncate(fd, size)
                    sock = socket_mod.socket(fileno=os.dup(conn.fileno()))
                    try:
                        with mmap.mmap(fd, size) as mm:
                            view = memoryview(mm)
                            try:
                                off = 0
                                while off < size:
                                    n = sock.recv_into(  # raylint: disable=R4
                                        view[off:], min(CHUNK, size - off))
                                    if n == 0:
                                        raise EOFError(
                                            f"pull of {name}: stream ended "
                                            f"at {off}/{size}")
                                    off += n
                            finally:
                                view.release()  # else mmap.close() raises
                    finally:
                        sock.close()  # closes only the dup'd fd
            else:
                off = 0
                while off < size:
                    data = conn.recv_bytes()
                    os.write(fd, data)
                    off += len(data)
    except (OSError, EOFError) as e:
        if not isinstance(e, FileNotFoundError):
            _evict(addr, conn)
        if fd >= 0:
            os.close(fd)
            fd = -1
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    finally:
        if fd >= 0:
            os.close(fd)
    try:
        os.rename(tmp, path)  # atomic publish; concurrent pullers race benignly
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def reset() -> None:
    """Drop cached connections (tests / shutdown)."""
    with _conns_lock:
        for conn, _ in _conns.values():
            try:
                if conn is not None:
                    conn.close()
            except Exception:
                pass
        _conns.clear()
