"""Socket teardown helpers.

On Linux, ``close()`` on a socket fd does NOT wake another thread blocked
in ``accept()``/``recv()`` on it — the thread stays parked forever.  Every
session teardown therefore leaked its accept loops, per-connection reader
threads, and client recv threads (~5 threads + 3 fds per init/shutdown in
one process; a full test suite accumulated ~1500 threads and starved the
scheduler).  ``shutdown(SHUT_RDWR)`` is the call that interrupts blocked
socket syscalls; these helpers apply it through the stdlib's private
attributes with best-effort fallbacks.
"""

from __future__ import annotations

import socket


def force_close_connection(conn) -> None:
    """Shut down + close a multiprocessing.Connection so any thread
    blocked in ``recv`` on it wakes with EOF."""
    try:
        # fromfd DUPS the fd; shutdown() acts on the shared underlying
        # socket, so the blocked thread's recv returns immediately
        dup = socket.fromfd(conn.fileno(), socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            dup.shutdown(socket.SHUT_RDWR)
        finally:
            dup.close()
    except Exception:
        pass
    try:
        conn.close()
    except Exception:
        pass


def unblock_listener(listener) -> None:
    """Wake a thread blocked in ``Listener.accept()`` so its loop can see
    the shutdown flag (call BEFORE/with ``listener.close()``)."""
    try:
        sock = listener._listener._socket  # SocketListener private attr
        sock.shutdown(socket.SHUT_RDWR)
    except Exception:
        pass
    try:
        listener.close()
    except Exception:
        pass
