"""Worker forkserver: sub-100ms worker spawns on slow hosts.

The reference amortizes worker startup with a prestarted pool
(``src/ray/raylet/worker_pool.cc`` StartWorkerProcess + prestart); that
still pays a full CPython boot (~2s on a small host: interpreter + site +
imports) per worker.  This forkserver pays it ONCE: a template process
imports the worker module, then forks on demand — each worker is a fork
of a warm interpreter (~10-20ms), which is what makes hundreds of actors
per node feasible on one core.

Protocol (unix socket, one JSON line per spawn):
    request:  {"env": {full environ}, "cwd": path-or-null}
    response: {"pid": <worker pid>}

Each spawn double-forks so the worker is orphaned toward the nearest
subreaper (the head process sets PR_SET_CHILD_SUBREAPER and reaps —
node.py), and the forkserver itself reaps only the short-lived middle
child.  The template stays single-threaded, so forks are always safe.

The template imports torch (the port's worker chain does), but never
``torch.cuda``: CUDA must not be initialized before a fork, so a worker
creates its CUDA context only in its task, after the head has set its
``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import json
import os
import socket
import sys


def serve(sock_path: str) -> None:
    # die with the head: we inherit its stdio, so outliving it would hold
    # its output pipes open (and leak a warm interpreter) after a crash.
    # The accept loop polls for the parent (PR_SET_PDEATHSIG would fire
    # when the head THREAD that started us ends, and the head starts the
    # template from a short-lived prewarm thread).
    ppid = os.getppid()
    # preload: the expensive part of a worker cold boot.  Everything a
    # worker touches before its first task — the worker module chain,
    # the protobuf wire codec (google.protobuf is ~0.3s cold), pickle
    # machinery — is imported ONCE here; forks inherit the warm modules.
    import warnings

    import ray_tpu_torch._private.worker as worker_mod
    import ray_tpu_torch._private.wire  # noqa: F401  (pulls google.protobuf)
    import cloudpickle  # noqa: F401
    import torch  # noqa: F401  (imported by the package already; never torch.cuda here)

    # importing torch starts its CPU thread pools; torch re-creates them in
    # a forked child (pthread_atfork), as it does for forked data loaders
    warnings.filterwarnings(
        "ignore", message=r".*use of fork\(\) may lead to deadlocks",
        category=DeprecationWarning)

    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX)
    srv.bind(sock_path)
    srv.listen(128)
    srv.settimeout(1.0)
    print("FORKSERVER_READY", flush=True)
    while True:
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            if os.getppid() != ppid:
                os._exit(0)
            continue
        conn.settimeout(None)
        try:
            data = b""
            while not data.endswith(b"\n"):
                chunk = conn.recv(1 << 16)
                if not chunk:
                    break
                data += chunk
            if not data.strip():
                continue
            req = json.loads(data)
            pid = os.fork()
            if pid == 0:
                # middle child: fork the real worker and exit, orphaning
                # it to the subreaper so we never accumulate zombies.
                # EVERY path out of this branch must _exit — falling
                # through would leave a rogue twin racing accepts.
                try:
                    gpid = os.fork()
                except OSError:
                    try:
                        conn.sendall(b'{"error": "fork failed"}\n')
                    except OSError:
                        pass
                    os._exit(1)
                if gpid == 0:
                    srv.close()
                    conn.close()
                    os.environ.clear()
                    os.environ.update(req["env"])
                    # sys.path was computed from the TEMPLATE's env at its
                    # boot; honor this worker's PYTHONPATH + working_dir
                    # the way a fresh interpreter would
                    for p in reversed(
                            (req["env"].get("PYTHONPATH") or "").split(os.pathsep)):
                        if p and p not in sys.path:
                            sys.path.insert(0, p)
                    if req.get("cwd"):
                        try:
                            os.chdir(req["cwd"])
                        except OSError:
                            os._exit(1)
                        if req["cwd"] not in sys.path:
                            sys.path.insert(0, req["cwd"])
                    try:
                        worker_mod.main()
                    finally:
                        os._exit(0)
                try:
                    conn.sendall((json.dumps({"pid": gpid}) + "\n").encode())
                except OSError:
                    pass  # client gone; the worker registers on its own
                os._exit(0)
            os.waitpid(pid, 0)  # the middle child exits immediately
        except (OSError, ValueError, KeyError):
            pass  # bad/truncated request or client death must not kill us
        finally:
            try:
                conn.close()
            except OSError:
                pass


if __name__ == "__main__":
    serve(sys.argv[1])
