"""Per-connection tenant driver subprocess (the reference proxier's
``SpecificServer`` analog).

Spawned by :mod:`ray_tpu_torch.util.client.proxier` with the tenant's accepted
socket fd.  Opens its OWN connection to the head and relays both ways,
so the tenant's whole control-plane presence — job id, namespace, object
pins, flight-recorder origin, and above all the PID — is isolated in
this process.  Kill it and the head sees exactly one client disconnect:
that tenant's non-detached actors and pins are reaped while every other
tenant keeps running.

The relay inspects frames only through the registration handshake: the
client's ``register_client`` is the single frame rewritten in flight
(this process's pid, the proxy-assigned namespace default,
``proxied=True``), and the head's reply is sniffed to learn the job id
this driver ships flight-recorder events under.  After that BOTH
directions degrade to a raw fd-level byte splice — no framing, no
decode, one read+write per chunk — so proxy mode's task-throughput
overhead is two socket hops, not two codec traversals
(``proxy_mode_overhead`` bench gate).  Flight-recorder events ride a
separate head connection so they can never interleave into the spliced
byte stream.
"""

from __future__ import annotations

import os
import threading
from multiprocessing.connection import Connection

from ray_tpu_torch._private import events as events_mod
from ray_tpu_torch._private import wire
from ray_tpu_torch._private.client import connect_control


def _writeall(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def _splice(src_fd: int, dst_fd: int) -> None:
    """Pump bytes until EOF/error.  Only entered once this direction's
    last inspected frame was fully consumed, so chunk boundaries need no
    alignment with frame boundaries."""
    while True:
        try:
            data = os.read(src_fd, 1 << 16)
        except OSError:
            return
        if not data:
            return
        try:
            _writeall(dst_fd, data)
        except OSError:
            return


def main() -> None:
    fd = int(os.environ["RAY_TPU_TORCH_PROXY_CONN_FD"])
    head_address = os.environ["RAY_TPU_TORCH_PROXY_HEAD"]
    authkey = bytes.fromhex(os.environ["RAY_TPU_TORCH_AUTHKEY"])
    namespace = os.environ.get("RAY_TPU_TORCH_PROXY_NAMESPACE")

    down = wire.wrap(Connection(fd))  # the tenant client (auth done by proxy)
    up = connect_control(head_address, authkey)

    # tell the proxy we are live BEFORE any tenant traffic: it answers the
    # client's proxy_ready off this line
    print("READY", flush=True)

    # after the handshake nothing reads this process's stdout/stderr —
    # redirect both into the tenant capture file (set by the proxy when
    # the session logs dir is local) so the log plane sees this driver
    # like any worker
    log_path = os.environ.get("RAY_TPU_TORCH_DRIVER_LOG")
    if log_path:
        from ray_tpu_torch._private.log_plane import redirect_process_output

        redirect_process_output(log_path)

    state = {"reg_req_id": None, "job_id": None, "pusher": None,
             "pusher_conn": None}
    done = threading.Event()

    def client_to_head() -> None:
        while True:
            try:
                buf = down._conn.recv_bytes()
            except Exception:  # noqa: BLE001 — any failure on a dying
                # socket is a disconnect, not a crash
                break
            try:
                msg = wire.decode(buf)
            except Exception:  # noqa: BLE001 — pass opaque frames on
                msg = None
            if msg is not None and msg.get("type") == "register_client":
                # the one enrichment: bind this connection to a tenant
                # identity.  A proxied tenant with no explicit namespace
                # gets an ISOLATED one derived from its pid — tenants
                # collide only when they opt into a shared namespace.
                if not msg.get("namespace"):
                    msg["namespace"] = namespace or f"tenant-{os.getpid()}"
                msg["pid"] = os.getpid()
                msg["proxied"] = True
                state["reg_req_id"] = msg.get("req_id")
                try:
                    up.send(msg)
                except (OSError, ValueError):
                    break
                _splice(down._conn.fileno(), up._conn.fileno())
                break
            try:
                up._conn.send_bytes(buf)
            except (OSError, ValueError):
                break
        done.set()

    def head_to_client() -> None:
        while True:
            try:
                buf = up._conn.recv_bytes()
            except Exception:  # noqa: BLE001 — same: EOF = gone
                break
            if state["reg_req_id"] is not None and state["pusher"] is None:
                try:
                    msg = wire.decode(buf)
                except Exception:  # noqa: BLE001
                    msg = None
                if (msg is not None
                        and msg.get("type") == "reply"
                        and msg.get("req_id") == state["reg_req_id"]
                        and isinstance(msg.get("value"), dict)):
                    _start_pusher(msg["value"])
                    try:
                        down._conn.send_bytes(buf)
                    except (OSError, ValueError):
                        break
                    _splice(up._conn.fileno(), down._conn.fileno())
                    break
            try:
                down._conn.send_bytes(buf)
            except (OSError, ValueError):
                break
        done.set()

    def _start_pusher(ident: dict) -> None:
        """This driver's OWN flight-recorder identity, on its OWN head
        connection (events must never interleave into the spliced
        relay stream)."""
        job_id = ident.get("job_id")
        state["job_id"] = job_id
        try:
            conn = connect_control(head_address, authkey)
        except (OSError, EOFError):
            return  # relay works without events; never kill the tenant
        state["pusher_conn"] = conn
        state["pusher"] = events_mod.EventsPusher(
            conn.send, origin=f"tenant-{job_id}",
            closed_fn=done.is_set).start()
        # proxied drivers profile too — their submit-side stacks are the
        # one part of the task path the head can't see from its own
        # sampler (the pusher's dedicated head conn keeps profile frames
        # out of the spliced relay stream)
        from ray_tpu_torch._private import sampling_profiler as _sp

        if _sp.continuous_enabled():
            state["profiler"] = _sp.ContinuousProfiler(
                f"tenant-{job_id}", send_fn=conn.send,
                closed_fn=done.is_set).start()
        events_mod.emit(
            "client_proxy", "tenant driver online", severity="INFO",
            entity_id=job_id, pid=os.getpid(),
            namespace=ident.get("namespace"))

    threads = [
        threading.Thread(target=client_to_head, daemon=True, name="c2h"),
        threading.Thread(target=head_to_client, daemon=True, name="h2c"),
    ]
    for t in threads:
        t.start()
    done.wait()
    # either side went away: drop both ends.  Closing the head conn is
    # what triggers the head's tenant reap; closing the client conn is
    # what tells the tenant its session died.
    for key in ("profiler", "pusher"):
        stoppable = state.get(key)
        if stoppable is not None:
            try:
                stoppable.stop()
            except Exception:  # noqa: BLE001 — final ship is best-effort
                pass
    for c in (down, up, state["pusher_conn"]):
        if c is None:
            continue
        try:
            c.close()
        except OSError:
            pass
    os._exit(0)


if __name__ == "__main__":
    main()
