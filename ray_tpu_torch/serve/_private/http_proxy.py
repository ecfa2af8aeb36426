"""HTTP ingress: the asyncio front door mapping routes to deployments.

Analog of ``python/ray/serve/_private/http_proxy.py:218`` (HTTPProxy over
uvicorn/starlette) rebuilt on ``asyncio.start_server``: the event loop owns
every connection (accept, parse, keep-alive, response writes — a
connection costs a StreamReader, not a thread), while the blocking data
plane (router assignment + ``ray_tpu_torch.get``) runs on a bounded executor
pool.  That split is the graceful-degradation design: concurrency the pool
can't absorb is *shed* with a fast 503 + Retry-After straight from the
loop instead of queueing unboundedly, so accepted requests keep a bounded
p99 no matter how many clients pile on.

Request-level fault tolerance:

deadline
    Every request carries one — the client's ``X-Serve-Deadline-S``
    header, else the deployment's ``request_timeout_s``, else
    ``INGRESS_DEFAULT_TIMEOUT_S`` — threaded through router admission AND
    replica execution, so a 5s-budget request can never queue for 60s.
    Expiry while queued is capacity (503); expiry while executing is 504.
retry
    A replica death (``RayActorError``) re-assigns idempotent requests
    (GET/HEAD/PUT/DELETE/OPTIONS, or any method carrying
    ``X-Idempotency-Key``) to a live replica with bounded backoff under
    the same deadline — replica SIGKILL is never a client-visible 500 for
    them.  A draining-replica race retries for every method (the request
    was refused before execution).
shed
    The router's ``max_queued_requests`` watermark and the proxy-wide
    in-flight cap (``MAX_INFLIGHT_REQUESTS``) both answer 503 +
    Retry-After.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.client import responses as _HTTP_REASONS
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.serve._private.http_util import (
    Request,
    Response,
    encode_response,
    parse_http_head,
)
from ray_tpu_torch.serve._private.router import Router
from ray_tpu_torch.serve.config import (
    INGRESS_DEFAULT_TIMEOUT_S,
    INGRESS_MAX_RETRIES,
    REFRESH_BACKOFF_BASE_S,
    REFRESH_BACKOFF_CAP_S,
    ROUTE_TABLE_TTL_S,
    SHED_RETRY_AFTER_S,
)
from ray_tpu_torch.serve.exceptions import BackPressureError, ReplicaDrainingError

DEADLINE_HEADER = "x-serve-deadline-s"
IDEMPOTENCY_HEADER = "x-idempotency-key"
# idempotent by HTTP semantics; POST/PATCH opt in via the header
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE", "OPTIONS"})
# request head / body ceilings for the asyncio parser
MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 256 * 1024 * 1024
# request-executor threads (blocking router/get work runs here;
# connections themselves cost no thread)
EXEC_THREADS = 128
# proxy-wide in-flight watermark: requests past it shed 503 straight from
# the event loop
MAX_INFLIGHT_REQUESTS = 2 * EXEC_THREADS

_SHED_BODY = json.dumps(
    {"error": "ingress overloaded, retry later"}).encode()


def _build_response(status: int, body: bytes, ctype: str,
                    extra_headers: Optional[Dict[str, str]] = None,
                    keep_alive: bool = True,
                    omit_body: bool = False) -> bytes:
    """One wire blob: status line + headers + body.  A single write means
    a single packet on loopback — no torn responses on reused keep-alive
    connections, no Nagle/delayed-ACK stall.  ``omit_body`` is the HEAD
    contract: headers (including the Content-Length GET would send) with
    no body — writing one would desync the client's keep-alive parser."""
    reason = _HTTP_REASONS.get(status, "Unknown")
    lines = [
        f"HTTP/1.1 {status} {reason}",
        f"Content-Type: {ctype}",
        f"Content-Length: {len(body)}",
    ]
    if not keep_alive:
        lines.append("Connection: close")
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head if omit_body else head + body


# SLO taps: trailing-window p99 gauge + status-class counter, fed by the
# single request funnel (_execute).  Lazy
# singletons like the router metrics.
_SLO_METRICS = None
P99_WINDOW_REQUESTS = 512
P99_RECOMPUTE_EVERY = 16


def _slo_metrics():
    global _SLO_METRICS
    if _SLO_METRICS is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _SLO_METRICS = {
            "p99": Gauge(
                "ray_tpu_serve_http_p99_s",
                "HTTP p99 latency over the trailing request window (s)"),
            "requests": Counter(
                "ray_tpu_serve_http_requests_total",
                "HTTP requests by status class (2xx/4xx/5xx)",
                tag_keys=("code_class",)),
        }
    return _SLO_METRICS


class _Reply:
    """What ``_execute`` hands back to the transport layer."""

    __slots__ = ("status", "headers", "body", "ctype", "stream")

    def __init__(self, status: int, body: bytes, ctype: str,
                 headers: Optional[Dict[str, str]] = None,
                 stream: Optional[Tuple[Any, Dict]] = None):
        self.status = status
        self.body = body
        self.ctype = ctype
        self.headers = headers or {}
        self.stream = stream  # (replica_handle, meta) for chunked delivery


class HTTPProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 controller_name: Optional[str] = None):
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.controller import (
            CONTROLLER_NAME, SERVE_NAMESPACE)

        self._controller = ray_tpu_torch.get_actor(
            controller_name or CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        self._routers: Dict[str, Router] = {}
        self._routers_lock = threading.Lock()
        self._route_table: Dict[str, str] = {}
        self._route_table_at = 0.0
        self._route_failures = 0
        self._route_next_attempt = 0.0
        # ingress counters (ingress_stats snapshot; tests and the chaos
        # bench read them to assert zero lost idempotent requests)
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "ok": 0, "retries": 0, "shed": 0,
            "replica_deaths": 0, "deadline_504": 0, "errors": 0,
        }
        # trailing latency window behind the p99 SLO gauge
        from collections import deque

        self._lat_window: deque = deque(maxlen=P99_WINDOW_REQUESTS)
        self._lat_n = 0
        self._impl = _AsyncIngress(self, host, port)
        self.host, self.port = self._impl.host, self._impl.port

    # -- actor API -----------------------------------------------------
    def ready(self):
        """(host, port) once the socket is bound (it is, from __init__)."""
        return self.host, self.port

    def ping(self) -> str:
        return "pong"

    def ingress_stats(self) -> Dict[str, Any]:
        """Counter snapshot: requests/ok/retries/shed/replica_deaths/
        deadline_504/errors, plus the ingress mode."""
        with self._stats_lock:
            out = dict(self._stats)
        out["mode"] = "asyncio"
        return out

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    # -- routing table ---------------------------------------------------
    def _refresh_route_table(self, force: bool = False) -> Dict[str, str]:
        """TTL-cached {route_prefix: deployment} pull with the same
        bounded-backoff stale-table behavior as Router._refresh: a
        controller stall must not take routing down with it."""
        import ray_tpu_torch

        now = time.monotonic()
        if not (force or now - self._route_table_at >= ROUTE_TABLE_TTL_S):
            return self._route_table
        if self._route_failures and now < self._route_next_attempt:
            return self._route_table
        try:
            table = ray_tpu_torch.get(
                self._controller.get_route_table.remote(), timeout=5
            )
        except Exception as e:  # noqa: BLE001 — controller stall/restart
            self._route_failures += 1
            self._route_next_attempt = now + min(
                REFRESH_BACKOFF_CAP_S,
                REFRESH_BACKOFF_BASE_S * (2 ** (self._route_failures - 1)))
            if _events.ENABLED:
                _events.emit(
                    "serve", "route table refresh failed",
                    severity="WARNING", entity_id="__proxy__",
                    failures=self._route_failures,
                    error=f"{type(e).__name__}: {e}"[:200])
            return self._route_table
        self._route_failures = 0
        self._route_table = table
        self._route_table_at = now
        return self._route_table

    def _match_route(self, path: str) -> Optional[str]:
        """Longest-prefix route match (http_proxy.py's starlette routing
        analog): '/api' matches '/api' and '/api/x', not '/apix'."""
        for force in (False, True):
            table = self._refresh_route_table(force=force)
            best, best_len = None, -1
            for prefix, name in table.items():
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    if len(prefix) > best_len:
                        best, best_len = name, len(prefix)
            if best is not None:
                return best
            # miss may just be a stale cache (deployment created <TTL ago):
            # force one refresh before 404ing
        return None

    def _router_for(self, name: str) -> Router:
        with self._routers_lock:
            router = self._routers.get(name)
            if router is None:
                router = self._routers[name] = Router(self._controller, name)
        return router

    # -- request path ----------------------------------------------------
    def _execute(self, method: str, raw_path: str,
                 headers: Dict[str, str], body: bytes) -> _Reply:
        """SLO tap around the request funnel — every request routes
        through here, so the trailing-window p99 gauge and the
        status-class counter see every request exactly once (the series
        the serve_p99 / serve_5xx SLOs burn on)."""
        t0 = time.perf_counter()
        reply = self._execute_inner(method, raw_path, headers, body)
        self._observe_slo(time.perf_counter() - t0, reply.status)
        return reply

    def _observe_slo(self, latency_s: float, status: int) -> None:
        code_class = f"{status // 100}xx"
        m = _slo_metrics()
        m["requests"].inc(tags={"code_class": code_class})
        with self._stats_lock:
            self._lat_window.append(latency_s)
            self._lat_n += 1
            snap = (tuple(self._lat_window)
                    if self._lat_n % P99_RECOMPUTE_EVERY == 0 else None)
        if snap:
            # p99 over the trailing window, recomputed every few requests
            # and sorted outside the lock (sorting 512 floats per request
            # would be the expensive way)
            lats = sorted(snap)
            m["p99"].set(lats[min(len(lats) - 1,
                                  int(0.99 * (len(lats) - 1)))])

    def _execute_inner(self, method: str, raw_path: str,
                       headers: Dict[str, str], body: bytes) -> _Reply:
        """Route + execute one request; never raises (transport layers
        only write bytes).  Runs on an executor thread."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        path = raw_path.split("?")[0]
        if path == "/-/routes":
            try:
                table = self._refresh_route_table()
            except Exception as e:  # noqa: BLE001
                return _Reply(500, json.dumps({"error": str(e)}).encode(),
                              "application/json")
            return _Reply(200, json.dumps(table).encode(), "application/json")
        name = self._match_route(path)
        if name is None:
            return _Reply(404, b'{"error": "no route"}', "application/json")
        self._count("requests")
        lc_headers = {k.lower(): v for k, v in headers.items()}
        request = Request.from_raw(method, raw_path, dict(headers), body)
        router = self._router_for(name)
        budget = None
        if DEADLINE_HEADER in lc_headers:
            try:
                budget = float(lc_headers[DEADLINE_HEADER])
            except ValueError:
                return _Reply(
                    400, b'{"error": "bad X-Serve-Deadline-S value"}',
                    "application/json")
        if budget is None:
            if router._last_refresh == 0.0:
                # brand-new router: pull config once BEFORE sizing the
                # deadline, or the first request to a deployment with a
                # tight request_timeout_s gets the 60s default
                router._refresh(force=True)
            budget = router.request_timeout_s or INGRESS_DEFAULT_TIMEOUT_S
        deadline = time.monotonic() + budget
        idempotent = (method.upper() in IDEMPOTENT_METHODS
                      or IDEMPOTENCY_HEADER in lc_headers)
        # each routed request is a trace ROOT: the span tree under it
        # (router admission -> replica task -> nested submissions /
        # compiled-graph nodes) joins the request's trace in the events.
        # Off when the observability layer is off.
        if _events.ENABLED:
            from ray_tpu_torch.util import tracing

            cm = tracing.trace(f"HTTP {method} {path}",
                               {"deployment": name}, phase="http")
        else:
            cm = contextlib.nullcontext()
        try:
            with cm:
                result, replica = self._route_with_policy(
                    router, request, deadline, idempotent, name)
        except BackPressureError as e:
            self._count("shed")
            return _Reply(
                503,
                json.dumps({"error": str(e)}).encode(), "application/json",
                headers={"Retry-After": f"{e.retry_after_s:g}"})
        except GetTimeoutError as e:
            if "no replica" in str(e):
                # never assigned: capacity, safe to retry elsewhere/later
                self._count("shed")
                return _Reply(
                    503, json.dumps({"error": str(e)}).encode(),
                    "application/json",
                    headers={"Retry-After": f"{SHED_RETRY_AFTER_S:g}"})
            # the request is (still) executing — slow, not capacity
            self._count("deadline_504")
            return _Reply(504,
                          b'{"error": "request deadline exceeded while '
                          b'executing"}', "application/json")
        except _ReplicaLost as e:
            # replica died; the retry budget (non-idempotent: zero) is
            # spent.  Idempotent: 503 so the client retries — by
            # construction never a 500.  Non-idempotent: execution state
            # unknown, an honest (structured) 500.
            self._count("errors")
            if e.idempotent:
                return _Reply(
                    503, json.dumps({"error": str(e)}).encode(),
                    "application/json",
                    headers={"Retry-After": f"{SHED_RETRY_AFTER_S:g}"})
            return _Reply(500, json.dumps({"error": str(e)}).encode(),
                          "application/json")
        except Exception as e:  # noqa: BLE001 — user-code errors et al.
            self._count("errors")
            err = json.dumps({"error": str(e),
                              "traceback": traceback.format_exc()})
            return _Reply(500, err.encode(), "application/json")
        if isinstance(result, dict) and "__serve_stream__" in result:
            return _Reply(200, b"", result.get("content_type", "text/plain"),
                          stream=(replica, result))
        self._count("ok")
        if isinstance(result, Response):
            return _Reply(result.status_code, result.body,
                          result.content_type, headers=result.headers)
        payload, ctype = encode_response(result)
        return _Reply(200, payload, ctype)

    def _route_with_policy(self, router: Router, request: Request,
                           deadline: float, idempotent: bool,
                           name: str):
        """Assign + get under the request deadline, re-assigning on
        replica death (idempotent requests, bounded backoff) and on the
        draining-membership race (all requests — a draining replica
        refused before executing)."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import (
            GetTimeoutError,
            RayActorError,
            RayTaskError,
        )

        attempt = 0
        last_death: Optional[BaseException] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if last_death is not None:
                    raise _ReplicaLost(
                        f"replica died and the deadline lapsed during "
                        f"retry: {last_death}", idempotent)
                raise GetTimeoutError(
                    f"no replica of {name!r} available within the request "
                    "deadline")
            ref, replica = router.assign_request(
                "__call__", (request,), {}, return_replica=True,
                deadline=deadline)
            try:
                result = ray_tpu_torch.get(
                    ref, timeout=max(deadline - time.monotonic(), 0.01))
            except RayActorError as e:
                router.on_replica_error(ref)
                self._count("replica_deaths")
                if not (idempotent and attempt < INGRESS_MAX_RETRIES):
                    raise _ReplicaLost(
                        f"replica of {name!r} died mid-request"
                        + ("" if idempotent else
                           " (non-idempotent, not retried)"),
                        idempotent) from e
                attempt += 1
                last_death = e
                self._count("retries")
                if _events.ENABLED:
                    _events.emit(
                        "serve", "request retried after replica death",
                        severity="INFO", entity_id=name, attempt=attempt)
                backoff = min(0.05 * (2 ** (attempt - 1)),
                              max(deadline - time.monotonic(), 0.0))
                if backoff > 0:
                    time.sleep(backoff)
                continue
            except RayTaskError as e:
                router.on_request_done(ref)
                if (isinstance(getattr(e, "cause", None),
                               ReplicaDrainingError)
                        or "ReplicaDrainingError" in str(e)):
                    # membership race: the replica refused BEFORE running
                    # anything, so re-assigning is safe for every method
                    if attempt < INGRESS_MAX_RETRIES * 2:
                        attempt += 1
                        self._count("retries")
                        router._refresh(force=True)
                        continue
                raise
            except GetTimeoutError:
                # request is STILL executing on the replica — the slot is
                # genuinely occupied; prune reclaims it when it finishes
                raise
            except Exception:
                router.on_request_done(ref)  # slot back on app errors
                raise
            router.on_request_done(ref)
            return result, replica


class _ReplicaLost(Exception):
    """Internal: replica death exhausted the retry budget (the transport
    maps idempotent→503, non-idempotent→500)."""

    def __init__(self, msg: str, idempotent: bool):
        super().__init__(msg)
        self.idempotent = idempotent


# ---------------------------------------------------------------------------
# asyncio ingress (the default)
# ---------------------------------------------------------------------------


class _AsyncIngress:
    """``asyncio.start_server`` front door on a dedicated loop thread.

    The loop owns connections; a bounded ThreadPoolExecutor owns the
    blocking per-request work.  ``_inflight`` (loop-confined, no lock) is
    the proxy-wide watermark: past it, 503s are written straight from the
    loop — the overload answer costs no executor slot, which is exactly
    what keeps it fast enough to matter at 1k clients.
    """

    def __init__(self, proxy: HTTPProxyActor, host: str, port: int):
        self._proxy = proxy
        self._pool = ThreadPoolExecutor(
            max_workers=EXEC_THREADS, thread_name_prefix="serve-exec")
        self._max_inflight = MAX_INFLIGHT_REQUESTS
        self._inflight = 0
        self._shedding = False
        self._loop = asyncio.new_event_loop()
        self._startup_error: Optional[BaseException] = None
        started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(host, port, started),
            daemon=True, name="serve-ingress")
        self._thread.start()
        started.wait(timeout=30)
        if self._startup_error is not None:
            raise self._startup_error

    def _run(self, host: str, port: int, started: threading.Event) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            server = self._loop.run_until_complete(
                asyncio.start_server(self._handle_conn, host, port,
                                     backlog=512, limit=MAX_HEAD_BYTES))
            sock = server.sockets[0].getsockname()
            self.host, self.port = sock[0], sock[1]
        except BaseException as e:  # noqa: BLE001 — surfaced to __init__
            self._startup_error = e
            started.set()
            return
        started.set()
        self._loop.run_forever()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        import socket as socket_mod

        proxy = self._proxy
        sock = writer.get_extra_info("socket")
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.setsockopt(socket_mod.IPPROTO_TCP,
                                socket_mod.TCP_NODELAY, 1)
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return  # client closed between requests
                except asyncio.LimitOverrunError:
                    writer.write(_build_response(
                        431, b'{"error": "request head too large"}',
                        "application/json", keep_alive=False))
                    await writer.drain()
                    return
                try:
                    method, raw_path, version, headers = \
                        parse_http_head(head[:-4])
                    # transport-level lookups are case-insensitive; the
                    # original-case dict goes to the deployment
                    lc = {k.lower(): v for k, v in headers.items()}
                    length = int(lc.get("content-length") or 0)
                except ValueError:
                    writer.write(_build_response(
                        400, b'{"error": "malformed request"}',
                        "application/json", keep_alive=False))
                    await writer.drain()
                    return
                if "chunked" in lc.get("transfer-encoding", "").lower():
                    # we don't parse chunked request bodies — answer
                    # honestly instead of desyncing on the unread body
                    writer.write(_build_response(
                        411, b'{"error": "chunked request bodies are not '
                        b'supported; send Content-Length"}',
                        "application/json", keep_alive=False))
                    await writer.drain()
                    return
                if length > MAX_BODY_BYTES:
                    writer.write(_build_response(
                        413, b'{"error": "body too large"}',
                        "application/json", keep_alive=False))
                    await writer.drain()
                    return
                body = await reader.readexactly(length) if length else b""
                keep_alive = (version != "HTTP/1.0"
                              and lc.get("connection", "").lower()
                              != "close")
                if self._inflight >= self._max_inflight:
                    self._shed_from_loop(keep_alive, writer)
                    await writer.drain()
                    if not keep_alive:
                        return
                    continue
                self._inflight += 1
                try:
                    reply = await self._loop.run_in_executor(
                        self._pool, proxy._execute, method, raw_path,
                        headers, body)
                except Exception as e:  # noqa: BLE001 — _execute guards
                    # its own body; this catches pre-route parse errors
                    reply = _Reply(
                        500, json.dumps({"error": str(e)}).encode(),
                        "application/json")
                finally:
                    self._inflight -= 1
                    if self._shedding and \
                            self._inflight <= self._max_inflight // 2:
                        self._shedding = False
                        if _events.ENABLED:
                            _events.emit(
                                "serve", "ingress shedding stopped",
                                severity="INFO", entity_id="__proxy__",
                                inflight=self._inflight)
                if reply.stream is not None:
                    ok = await self._stream_response(writer, reply)
                    if not ok or not keep_alive:
                        return
                    continue
                writer.write(_build_response(
                    reply.status, reply.body, reply.ctype, reply.headers,
                    keep_alive, omit_body=(method == "HEAD")))
                await writer.drain()
                if not keep_alive:
                    return
        except (ConnectionResetError, BrokenPipeError,
                asyncio.CancelledError):
            pass
        except Exception:  # noqa: BLE001 — connection already unusable;
            # nothing left to answer on
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    def _shed_from_loop(self, keep_alive: bool,
                        writer: asyncio.StreamWriter) -> None:
        """Proxy-wide overload answer, written without an executor hop.
        Loop-confined state, so no locks; shedding is recorded as one
        started/stopped pair of events an episode."""
        self._proxy._count("shed")
        if not self._shedding:
            self._shedding = True
            if _events.ENABLED:
                _events.emit(
                    "serve", "ingress shedding started",
                    severity="WARNING", entity_id="__proxy__",
                    inflight=self._inflight,
                    max_inflight=self._max_inflight)
        writer.write(_build_response(
            503, _SHED_BODY, "application/json",
            {"Retry-After": f"{SHED_RETRY_AFTER_S:g}"}, keep_alive))

    async def _stream_response(self, writer: asyncio.StreamWriter,
                               reply: _Reply) -> bool:
        """Chunked-transfer delivery of a StreamingResponse: blocking
        next_chunks pulls ride the executor, writes stay on the loop.
        Returns False when the connection is no longer reusable (producer
        error truncates the body so the client sees an aborted stream,
        not a clean end)."""
        import ray_tpu_torch

        replica, meta = reply.stream
        sid = meta["__serve_stream__"]

        def pull():
            return ray_tpu_torch.get(replica.next_chunks.remote(sid, 16),
                               timeout=120.0)

        try:
            writer.write(
                (f"HTTP/1.1 200 OK\r\nContent-Type: {reply.ctype}\r\n"
                 "Transfer-Encoding: chunked\r\n\r\n").encode("latin-1"))
            while True:
                out = await self._loop.run_in_executor(self._pool, pull)
                buf = b"".join(
                    f"{len(c):x}\r\n".encode() + c + b"\r\n"
                    for c in out["chunks"] if c)
                if buf:
                    writer.write(buf)
                    await writer.drain()
                if out["done"]:
                    if out.get("error"):
                        return False  # truncate: no terminating chunk
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return True
                if not out["chunks"]:
                    await asyncio.sleep(0.02)
        except Exception:  # noqa: BLE001 — client disconnect or replica
            # death; either way the stream (and connection) is done
            with contextlib.suppress(Exception):
                replica.cancel_stream.remote(sid)
            return False
