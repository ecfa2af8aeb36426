"""The asyncio Serve ingress on the port's runtime: ASGI mounting,
deadlines, shedding, retries, graceful draining — mirrored by name from
the JAX package's ``tests/test_serve_ingress.py``.  Its ``doctor`` rules
are left out with ``doctor``; the events and traces those tests read
through the state API are read here from the head's event table (the head
runs in this process), with traces assembled by ``events.TraceTable``.
The trend autoscaler is not ported: its replica scaler is the
controller's ``scale_deployment`` RPC, called directly.

One port head serves the module (``init(num_cpus=16, num_gpus=2)``); no
JAX head starts.
"""

import http.client
import json
import os
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_instance():
    os.environ["RAY_TPU_TORCH_EVENTS_FLUSH_S"] = "0.2"
    ray_tpu_torch.init(num_cpus=16, num_gpus=2)
    client = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    yield client
    serve.shutdown()
    ray_tpu_torch.shutdown()
    os.environ.pop("RAY_TPU_TORCH_EVENTS_FLUSH_S", None)


def _request(port, path, method="GET", body=None, headers=None, timeout=60):
    """One request on a fresh connection; returns (status, headers, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


def _all_events():
    """The head's table of shipped events and this process's own ring
    (the driver and the head share it), as the JAX package's state API
    merges them."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch._private.worker import global_worker

    rows = global_worker.node.events.list(limit=100_000)
    rows += [dict(r, origin="head") for r in events.local_events()]
    return sorted(rows, key=lambda r: r.get("ts", 0.0))


def _events_rows(message=None, source="serve"):
    rows = [e for e in _all_events() if e.get("source") == source]
    if message is not None:
        rows = [e for e in rows if e.get("message") == message]
    return rows


def _traces():
    """Every event row folded into traces, as the JAX package's head does
    for its state API."""
    from ray_tpu_torch._private import events

    table = events.TraceTable()
    for row in _all_events():
        table.add(row["origin"], [row])
    return table


def _wait_for_event(message, pred=lambda rows: bool(rows), timeout=15.0):
    deadline = time.monotonic() + timeout
    rows = []
    while time.monotonic() < deadline:
        rows = _events_rows(message)
        if pred(rows):
            return rows
        time.sleep(0.3)
    return rows


# ---------------------------------------------------------------------------
# the asyncio front door itself
# ---------------------------------------------------------------------------

def test_asyncio_ingress_is_default_and_serves(serve_instance):
    @serve.deployment
    def hello(request):
        return {"hi": request.query_params.get("who", "world")}

    serve.run(hello.bind(), port=0)
    host, port = serve.get_http_address()
    status, headers, body = _request(port, "/hello?who=tpu")
    assert status == 200
    assert json.loads(body) == {"hi": "tpu"}
    stats = ray_tpu_torch.get(serve_instance.proxy.ingress_stats.remote(),
                        timeout=30)
    assert stats["mode"] == "asyncio"
    assert stats["requests"] >= 1 and stats["ok"] >= 1
    # malformed request lines answer 400, and the listener survives
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(b"NONSENSE\r\n\r\n")
        raw = s.recv(4096)
        assert b"400" in raw.split(b"\r\n", 1)[0], raw
    finally:
        s.close()
    status, _, _ = _request(port, "/hello")
    assert status == 200
    serve.delete("hello")


def test_response_status_and_headers_passthrough(serve_instance):
    @serve.deployment
    class Teapot:
        def __call__(self, request):
            return serve.Response(
                {"short": "stout"}, status_code=418,
                headers={"X-Teapot": "yes"})

    serve.run(Teapot.bind(), port=0)
    _, port = serve.get_http_address()
    status, headers, body = _request(port, "/Teapot")
    assert status == 418
    assert headers.get("X-Teapot") == "yes"
    assert json.loads(body) == {"short": "stout"}
    serve.delete("Teapot")


# ---------------------------------------------------------------------------
# @serve.ingress — ASGI adapter
# ---------------------------------------------------------------------------

async def _mini_asgi_app(scope, receive, send):
    """A minimal by-hand ASGI app: routes on path, echoes bodies, sets a
    header — no framework required (none is installed)."""
    assert scope["type"] == "http"
    path = scope["path"]
    if path.endswith("/hello"):
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"x-asgi", b"mini")]})
        await send({"type": "http.response.body",
                    "body": b"hello from asgi"})
        return
    if path.endswith("/echo"):
        message = await receive()
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"application/json")]})
        await send({"type": "http.response.body",
                    "body": json.dumps(
                        {"echo": message.get("body", b"").decode(),
                         "method": scope["method"]}).encode()})
        return
    await send({"type": "http.response.start", "status": 404,
                "headers": []})
    await send({"type": "http.response.body", "body": b"asgi: no route"})


def test_asgi_ingress_mount(serve_instance):
    @serve.deployment
    @serve.ingress(_mini_asgi_app)
    class Mounted:
        def side_channel(self):
            return "direct"

    serve.run(Mounted.bind(), port=0)
    _, port = serve.get_http_address()
    status, headers, body = _request(port, "/Mounted/hello")
    assert (status, body) == (200, b"hello from asgi")
    assert headers.get("x-asgi") == "mini"
    status, _, body = _request(port, "/Mounted/echo", method="POST",
                               body=b"ping")
    assert status == 200
    assert json.loads(body) == {"echo": "ping", "method": "POST"}
    # the app's own 404 (not the proxy's route miss) comes through
    status, _, body = _request(port, "/Mounted/nope")
    assert (status, body) == (404, b"asgi: no route")
    # non-HTTP callers still reach named methods directly
    handle = serve.get_deployment_handle("Mounted")
    assert ray_tpu_torch.get(handle.side_channel.remote(), timeout=60) == "direct"
    serve.delete("Mounted")


def test_asgi_ingress_traced_root_span(serve_instance):
    """ROADMAP acceptance: root traces flow through the new proxy
    unchanged — an HTTP request into a mounted ASGI app yields one trace
    rooted at the proxy with the router admission chained under it."""
    @serve.deployment
    @serve.ingress(_mini_asgi_app)
    class Traced:
        pass

    serve.run(Traced.bind(), port=0)
    _, port = serve.get_http_address()
    status, _, _ = _request(port, "/Traced/hello")
    assert status == 200

    def find_root():
        for s in _traces().list(limit=200):
            if "GET /Traced/hello" in (s.get("name") or ""):
                return s
        return None

    deadline = time.monotonic() + 20
    root = None
    while time.monotonic() < deadline and root is None:
        root = find_root()
        time.sleep(0.3)
    assert root is not None, "no trace rooted at the HTTP request"
    tr = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        tr = _traces().get(root["trace_id"])
        if tr is not None and any(
                s.get("phase") == "router_admission" for s in tr["spans"]):
            break
        time.sleep(0.3)
    phases = {s.get("phase") for s in tr["spans"]}
    assert "http" in phases, phases
    assert "router_admission" in phases, phases
    serve.delete("Traced")


def test_ingress_decorator_rejects_functions():
    with pytest.raises(TypeError, match="decorates a class"):
        serve.ingress(_mini_asgi_app)(lambda request: None)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_header_caps_queueing(serve_instance):
    """A 1s-budget request must not queue behind a busy replica for the
    60s default (the router threads the per-request deadline through)."""

    @serve.deployment(max_concurrent_queries=1)
    class Busy:
        def __call__(self, request=None):
            time.sleep(3.0)
            return "eventually"

    serve.run(Busy.bind(), port=0)
    _, port = serve.get_http_address()
    blocker = threading.Thread(
        target=lambda: _request(port, "/Busy", timeout=120))
    blocker.start()
    time.sleep(0.8)  # let the blocker occupy the only slot
    t0 = time.monotonic()
    status, headers, body = _request(
        port, "/Busy", headers={"X-Serve-Deadline-S": "1"}, timeout=60)
    waited = time.monotonic() - t0
    # never assigned -> capacity answer (503 + Retry-After), fast
    assert status == 503, body
    assert "Retry-After" in headers
    assert waited < 5.0, f"queued {waited:.1f}s past a 1s deadline"
    blocker.join()
    serve.delete("Busy")


def test_deadline_504_while_executing(serve_instance):
    @serve.deployment
    class Slow:
        def __call__(self, request=None):
            time.sleep(4.0)
            return "late"

    serve.run(Slow.bind(), port=0)
    _, port = serve.get_http_address()
    t0 = time.monotonic()
    status, _, body = _request(
        port, "/Slow", headers={"X-Serve-Deadline-S": "1"}, timeout=60)
    waited = time.monotonic() - t0
    assert status == 504, body  # executing, not capacity
    assert waited < 6.0
    status, _, _ = _request(port, "/Slow",
                            headers={"X-Serve-Deadline-S": "0.5"})
    assert status in (503, 504)  # saturated now: either never assigned
    # (503) or assigned and expired (504) — both bounded
    serve.delete("Slow")


def test_router_deadline_overrides_default_timeout(serve_instance):
    """Direct router check: deadline wins over the hardcoded 60s
    default."""
    from ray_tpu_torch.exceptions import GetTimeoutError

    @serve.deployment(max_concurrent_queries=1)
    class OneSlot:
        def __call__(self, request=None):
            time.sleep(2.5)
            return "ok"

    handle = serve.run(OneSlot.bind(), port=0)
    blocked = handle.remote()  # occupy the single slot
    time.sleep(0.5)
    router = handle._get_router()
    t0 = time.monotonic()
    with pytest.raises(GetTimeoutError):
        router.assign_request("__call__", (), {},
                              deadline=time.monotonic() + 0.5)
    assert time.monotonic() - t0 < 4.0
    assert ray_tpu_torch.get(blocked, timeout=60) == "ok"
    serve.delete("OneSlot")


# ---------------------------------------------------------------------------
# load shedding
# ---------------------------------------------------------------------------

def test_backlog_watermark_sheds_503(serve_instance):
    """Backlog past max_queued_requests answers 503 + Retry-After instead
    of queueing unboundedly; the episode opens and closes in the flight
    recorder, then go quiet."""

    @serve.deployment(max_concurrent_queries=1, max_queued_requests=2)
    class Choke:
        def __call__(self, request=None):
            time.sleep(0.45)
            return "served"

    serve.run(Choke.bind(), port=0)
    _, port = serve.get_http_address()
    results = []
    lock = threading.Lock()

    def one():
        out = _request(port, "/Choke", timeout=120)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=one) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    statuses = sorted(s for s, _, _ in results)
    assert 503 in statuses, f"nothing shed: {statuses}"
    assert all(s in (200, 503) for s in statuses), statuses
    shed = [(s, h) for s, h, _ in results if s == 503]
    assert all("Retry-After" in h for _, h in shed)
    # the shedding episode reached the flight recorder and CLOSED (the
    # backlog drained once the burst passed)
    started = _wait_for_event("ingress shedding started")
    assert started, "no shedding-started event shipped"
    # drain fully, then make one more request: admission closes the episode
    time.sleep(1.0)
    status, _, _ = _request(port, "/Choke", timeout=60)
    assert status == 200
    stopped = _wait_for_event("ingress shedding stopped")
    assert stopped, "shedding episode never closed"
    serve.delete("Choke")


# ---------------------------------------------------------------------------
# replica-death retries
# ---------------------------------------------------------------------------

def test_idempotent_requests_survive_replica_death(serve_instance):
    """Replica SIGKILL mid-request: idempotent requests are re-assigned to
    a live replica — never a client-visible 500."""

    import tempfile

    flag = os.path.join(tempfile.mkdtemp(prefix="serve_die_"), "died")

    @serve.deployment(num_replicas=2)
    class DiesOnce:
        def __init__(self, flag_path):
            self.flag = flag_path

        def __call__(self, request=None):
            try:
                # exactly ONE replica dies (first to claim the flag) —
                # no cleanup, no goodbye, like a SIGKILL
                fd = os.open(self.flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                os._exit(1)
            except FileExistsError:
                return "survived"

    serve.run(DiesOnce.bind(flag), port=0)
    _, port = serve.get_http_address()
    statuses = []
    for _ in range(6):
        status, _, body = _request(
            port, "/DiesOnce",
            headers={"X-Serve-Deadline-S": "60"}, timeout=120)
        statuses.append((status, body))
    assert all(s == 200 for s, _ in statuses), statuses
    stats = ray_tpu_torch.get(serve_instance.proxy.ingress_stats.remote(),
                        timeout=30)
    assert stats["replica_deaths"] >= 1
    assert stats["retries"] >= 1
    retried = _wait_for_event("request retried after replica death")
    assert retried
    serve.delete("DiesOnce")


def test_non_idempotent_death_is_structured_500_and_key_opts_in(
        serve_instance):
    import tempfile

    tmp = tempfile.mkdtemp(prefix="serve_die_post_")

    @serve.deployment(num_replicas=2)
    class DiesOnPost:
        def __init__(self, tmpdir):
            self.tmp = tmpdir

        def __call__(self, request, _flag="died-{}"):
            if request.method == "POST":
                n = 1 if "plain" in request.query_params else 2
                try:
                    fd = os.open(os.path.join(self.tmp, _flag.format(n)),
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    os._exit(1)
                except FileExistsError:
                    pass
            return "ok"

    serve.run(DiesOnPost.bind(tmp), port=0)
    _, port = serve.get_http_address()
    status, _, body = _request(port, "/DiesOnPost?plain=1", method="POST",
                               body=b"{}", timeout=120)
    assert status == 500
    assert b"non-idempotent" in body
    # the SAME shape of failure with an idempotency key retries to the
    # surviving replica instead
    status, _, body = _request(
        port, "/DiesOnPost", method="POST", body=b"{}",
        headers={"X-Idempotency-Key": "req-1", "X-Serve-Deadline-S": "60"},
        timeout=120)
    assert status == 200, body
    serve.delete("DiesOnPost")


# ---------------------------------------------------------------------------
# routing-refresh resilience
# ---------------------------------------------------------------------------

def test_refresh_failure_keeps_stale_table_with_backoff(serve_instance):
    """A transient controller stall must not poison routing: failed pulls
    keep the stale routing table and back off, and requests keep landing
    on the stale replica set."""

    @serve.deployment
    class Steady:
        def __call__(self, request=None):
            return "steady"

    handle = serve.run(Steady.bind(), port=0)
    assert ray_tpu_torch.get(handle.remote(), timeout=60) == "steady"
    router = handle._get_router()

    def explode():
        raise OSError("controller unreachable (injected)")

    orig = router._pull_routing_info
    router._pull_routing_info = explode
    try:
        router._refresh(force=True)
        assert router._refresh_failures == 1
        assert router._next_refresh_attempt > time.monotonic() - 1
        assert router._replicas, "stale replica set was dropped"
        # requests still route on the stale table
        assert ray_tpu_torch.get(handle.remote(), timeout=60) == "steady"
        # inside the backoff window the failing pull is NOT retried
        router._refresh(force=True)
        assert router._refresh_failures == 1
        # past the window it is (and fails again, widening the backoff)
        router._next_refresh_attempt = time.monotonic() - 0.01
        router._refresh(force=True)
        assert router._refresh_failures == 2
    finally:
        router._pull_routing_info = orig
    router._next_refresh_attempt = 0.0
    router._refresh(force=True)
    assert router._refresh_failures == 0
    failures = _wait_for_event("routing refresh failed")
    assert failures
    serve.delete("Steady")


# ---------------------------------------------------------------------------
# graceful draining
# ---------------------------------------------------------------------------

def test_graceful_drain_completes_inflight_requests(serve_instance):
    """Deleting (or scaling down) a deployment lets accepted requests
    finish: stop assigning, finish in-flight, then terminate."""

    @serve.deployment
    class Lingering:
        def __call__(self, request=None):
            time.sleep(2.2)
            return "finished cleanly"

    serve.run(Lingering.bind(), port=0)
    _, port = serve.get_http_address()
    result = {}

    def slow_call():
        result["out"] = _request(port, "/Lingering", timeout=120)

    t = threading.Thread(target=slow_call)
    t.start()
    time.sleep(0.8)  # request is in flight on the replica
    serve.delete("Lingering")  # drains, not kills
    t.join(timeout=60)
    status, _, body = result["out"]
    assert (status, body) == (200, b"finished cleanly"), result["out"]

    def mine(rows):
        return [r for r in rows
                if (r.get("data") or {}).get("deployment") == "Lingering"]

    drained = mine(_wait_for_event(
        "replica drained", pred=lambda rows: bool(mine(rows))))
    assert drained, "no drain-completed event for Lingering"
    # the drain WAITED for the in-flight request (not an instant kill)
    assert any((r.get("data") or {}).get("wait_s", 0) > 1.0
               for r in drained), drained
    assert not mine(_events_rows("replica drain timeout"))


def test_drain_timeout_cuts_off_overlong_requests(serve_instance):
    """A handler that outlives the graceful window is cut off — and the
    cutoff is recorded."""
    from ray_tpu_torch.serve.config import ReplicaState

    @serve.deployment(num_replicas=1)
    class Immortal:
        def __call__(self, request=None):
            time.sleep(30.0)
            return "never"

    d = Immortal.bind()
    d.deployment.config.graceful_shutdown_timeout_s = 1.5
    handle = serve.run(d, port=0)
    ref = handle.remote()
    time.sleep(0.8)
    serve.delete("Immortal")
    cut = _wait_for_event("replica drain timeout", timeout=20)
    assert cut, "drain timeout not recorded"
    assert (cut[0].get("data") or {}).get("inflight", 0) >= 1
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=30)
    assert ReplicaState.DRAINING  # state constant exists for status maps


# ---------------------------------------------------------------------------
# externally-driven scaling (trend-autoscaler hook)
# ---------------------------------------------------------------------------

def test_scale_deployment_rpc_and_replica_scaler(serve_instance):
    def serve_replica_scaler(controller):
        def scale(deployment, delta):
            ray_tpu_torch.get(controller.scale_deployment.remote(deployment, delta=delta),
                              timeout=30)

        return scale

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_num_ongoing_requests_per_replica": 100.0,  # stay put
        "upscale_delay_s": 60.0, "downscale_delay_s": 60.0,
    })
    class Scaled:
        def __call__(self, request=None):
            return "ok"

    serve.run(Scaled.bind(), port=0)
    assert serve.status()["Scaled"]["num_replicas_goal"] == 1
    scaler = serve_replica_scaler(serve_instance.controller)
    scaler("Scaled", 2)
    assert serve.status()["Scaled"]["num_replicas_goal"] == 3
    scaler("Scaled", 5)  # clamped to the autoscaling max
    assert serve.status()["Scaled"]["num_replicas_goal"] == 3
    scaled_events = _wait_for_event("deployment scaled")
    assert scaled_events
    assert ray_tpu_torch.get(
        serve_instance.controller.scale_deployment.remote("missing"),
        timeout=30) is None
    serve.delete("Scaled")
