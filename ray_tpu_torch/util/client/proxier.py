"""Multi-tenant client proxy server (``proxier.py`` analog of the
reference's ``python/ray/util/client/server/proxier.py``).

One listener, one isolated driver subprocess PER client connection.  The
proxy is only on the handshake path: after ``proxy_hello`` it passes the
accepted socket fd to the spawned ``ray_tpu_torch.util.client.driver`` process
(the reference's ``SpecificServer`` analog) and steps out — tenant
traffic flows client ↔ driver ↔ head with a single extra hop, and a
SIGKILL'd driver takes down exactly one tenant's connection.

Run standalone::

    python -m ray_tpu_torch.util.client.proxier --head auto --port 10001

or embed next to an in-process head (tests, bench)::

    proxy = ProxyServer(head_address, authkey).start()
    ray_tpu_torch.init(f"ray_tpu_torch://{proxy.address[0]}:{proxy.address[1]}")
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Listener
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private import events as events_mod
from ray_tpu_torch._private import wire

SPAWN_TIMEOUT_S = 30.0


class TenantDriver:
    """Bookkeeping for one connection's driver subprocess."""

    def __init__(self, proc: subprocess.Popen, namespace: Optional[str]):
        self.proc = proc
        self.namespace = namespace
        self.started = time.time()

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class ProxyServer:
    def __init__(self, head_address: str, authkey: bytes,
                 host: str = "127.0.0.1", port: int = 0):
        self._head_address = head_address
        self._authkey = authkey
        self._listener = Listener((host, port), family="AF_INET",
                                  authkey=authkey, backlog=16)
        self.address: Tuple[str, int] = self._listener.address
        self.tenants: Dict[int, TenantDriver] = {}  # pid -> driver
        self._lock = threading.Lock()
        self._log_seq = 0  # only grows: no tenant's log is ever reused
        self._stopped = False
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> "ProxyServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="proxy-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                raw = self._listener.accept()
            except Exception:  # noqa: BLE001 — an auth failure or
                # mid-handshake EOF from one peer must not kill the
                # listener; stop() closing it is the real exit
                if self._stopped:
                    return
                continue
            threading.Thread(target=self._serve_conn, args=(raw,),
                             daemon=True, name="proxy-handshake").start()

    def _serve_conn(self, raw) -> None:
        """Handshake one client: read ``proxy_hello``, spawn its driver
        around the socket fd, confirm with ``proxy_ready``, close our fd.
        From then on the proxy holds no piece of the tenant's data path."""
        conn = wire.wrap(raw)
        try:
            try:
                hello = conn.recv()
            except (EOFError, OSError):
                conn.close()
                return
            mtype = hello.get("type")
            if mtype == "proxy_hello":
                namespace = hello.get("namespace")
            else:
                conn.send({"type": "proxy_error",
                           "error": f"expected proxy_hello, got {mtype!r}"})
                conn.close()
                return
            try:
                driver = self._spawn_driver(raw.fileno(), namespace)
            except (OSError, TimeoutError, RuntimeError) as e:
                conn.send({"type": "proxy_error",
                           "error": f"driver spawn failed: {e}"})
                conn.close()
                return
            with self._lock:
                self.tenants[driver.pid] = driver
            # reaper armed BEFORE proxy_ready: if the client vanished
            # mid-handshake the send below raises, and the spawned driver
            # (exiting on its client-fd EOF) must still be wait()ed and
            # dropped from the directory — not left a zombie behind a
            # forever-"alive" tenants row
            threading.Thread(target=self._reap, args=(driver,), daemon=True,
                             name=f"proxy-reap-{driver.pid}").start()
            events_mod.emit(
                "client_proxy", "tenant driver spawned", severity="INFO",
                pid=driver.pid, namespace=namespace)
            conn.send({"type": "proxy_ready"})
        finally:
            # the driver subprocess owns its dup of the socket now; our
            # descriptor must go or the client never sees EOF on driver
            # death (the fd would stay half-open here)
            try:
                conn.close()
            except OSError:
                pass

    def _tenant_log_path(self) -> Optional[str]:
        """Capture file for the next tenant driver, when the head's
        session logs dir is reachable from this host (the common
        proxy-on-head deployment).  The head's log monitor adopts
        ``tenant-*.log`` files there by glob — spawn-time registration
        can't cross processes.  Numbered by a count that only grows, so
        a tenant spawned after another exited never writes into a live
        tenant's file."""
        try:
            sess_dir = _last_session().get("session_dir")
            if not sess_dir:
                return None
            log_dir = os.path.join(sess_dir, "logs")
            if not os.path.isdir(log_dir):
                return None
            with self._lock:
                seq, self._log_seq = self._log_seq, self._log_seq + 1
            return os.path.join(log_dir, f"tenant-{os.getpid()}-{seq}.log")
        except (OSError, ValueError):
            return None

    def _spawn_driver(self, fd: int, namespace: Optional[str]) -> TenantDriver:
        env = dict(os.environ)
        env["RAY_TPU_TORCH_PROXY_CONN_FD"] = str(fd)
        env["RAY_TPU_TORCH_PROXY_HEAD"] = self._head_address
        env["RAY_TPU_TORCH_AUTHKEY"] = self._authkey.hex()
        log_path = self._tenant_log_path()
        if log_path:
            env["RAY_TPU_TORCH_DRIVER_LOG"] = log_path
        # the driver runs this proxy's own package, whatever the cwd
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        if namespace:
            env["RAY_TPU_TORCH_PROXY_NAMESPACE"] = namespace
        else:
            env.pop("RAY_TPU_TORCH_PROXY_NAMESPACE", None)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.util.client.driver"],
            env=env, pass_fds=[fd], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True,
        )
        # the driver prints READY once its head connection is live; a
        # driver that can't reach the head dies before printing and the
        # client gets proxy_error instead of a dead pipe.  EVERY failure
        # path kills + collects the child here — no reaper thread exists
        # for it yet, so skipping the wait() would leave a zombie.
        try:
            line = _readline_with_timeout(proc, SPAWN_TIMEOUT_S)
        except TimeoutError:
            proc.kill()
            proc.wait()
            raise
        if line.strip() != "READY":
            proc.kill()
            proc.wait()
            raise RuntimeError(
                f"driver failed to come up (got {line!r})")
        return TenantDriver(proc, namespace)

    def _reap(self, driver: TenantDriver) -> None:
        """Collect the subprocess when it exits (no zombies) and record
        the departure in the flight recorder."""
        driver.proc.wait()
        with self._lock:
            self.tenants.pop(driver.pid, None)
        events_mod.emit(
            "client_proxy", "tenant driver exited", severity="INFO",
            pid=driver.pid, namespace=driver.namespace,
            returncode=driver.proc.returncode)

    # ------------------------------------------------------------------
    def list_tenants(self) -> list:
        with self._lock:
            return [{"pid": d.pid, "namespace": d.namespace,
                     "alive": d.alive, "started": d.started}
                    for d in self.tenants.values()]

    def stop(self) -> None:
        self._stopped = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            drivers = list(self.tenants.values())
        for d in drivers:
            try:
                d.proc.terminate()
            except OSError:
                pass


def _last_session() -> dict:
    """The discovery record the newest head of this host wrote, under the
    port's ``session_root()``."""
    import json

    from ray_tpu_torch._private.config import session_root

    with open(os.path.join(session_root(), "last_session.json")) as f:
        return json.load(f)


def _readline_with_timeout(proc: subprocess.Popen, timeout: float) -> str:
    """One stdout line from the child, bounded: a wedged driver must fail
    the handshake, not park the proxy's accept thread forever."""
    box = {"line": ""}

    def read():
        try:
            box["line"] = proc.stdout.readline()
        except (OSError, ValueError):
            pass

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"driver produced no READY within {timeout}s")
    return box["line"]


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="multi-tenant ray_tpu_torch client proxy")
    p.add_argument("--head", default="auto",
                   help='head address ("auto" reads the last session file)')
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10001)
    args = p.parse_args(argv)

    head = args.head
    if head == "auto":
        sess = _last_session()
        head = sess["address"]
        authkey = bytes.fromhex(sess["authkey"])
    else:
        if ":" in head and not head.startswith("tcp://") \
                and not head.startswith("/"):
            # bare host:port — the driver treats unprefixed strings as
            # unix socket paths, so normalize here
            head = f"tcp://{head}"
        key = os.environ.get("RAY_TPU_TORCH_AUTHKEY")
        if not key:
            raise SystemExit(
                "RAY_TPU_TORCH_AUTHKEY must be exported when --head is not "
                "'auto' (hex authkey of the target cluster)")
        authkey = bytes.fromhex(key)
    server = ProxyServer(head, authkey, host=args.host, port=args.port)
    server.start()
    print(f"ray_tpu_torch client proxy on {server.address[0]}:{server.address[1]} "
          f"-> {head}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
