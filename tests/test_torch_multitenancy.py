"""Multi-tenancy on the port: the client proxy's per-connection drivers,
namespace-scoped actors, concurrency groups, the tenants table and the
tenant-kill chaos op, with the JAX package's ``tests/test_multitenancy.py``
cases run on the port's runtime alone (no JAX head).

The doctor's ``tenant_killed`` rule is a pure function of event rows and
is held to the JAX package's rule on the same rows.  One difference from
the JAX head is named here: a driver that calls ``shutdown()`` first sends
``client_leaving``, and its disconnect is reaped as before but recorded as
one "tenant disconnected" (INFO), so ``tenant_killed`` fires only for a
connection that dropped without it (SIGKILL, a crash, the chaos op).  The
JAX head records the died/reaped pair for every disconnect of a driver
that still owned something (``ray_tpu/_private/node.py:1214-1270``).

Every process the module starts runs under a private ``TMPDIR``, and each
test has its own time limit.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: every wait in this file


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its 60 s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def proxy_cluster():
    """An in-process port head (no card) and a proxy in front of it, every
    process under a private TMPDIR."""
    from ray_tpu_torch.util.client import ProxyServer

    with tempfile.TemporaryDirectory(prefix="mt_") as tmp, \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", tmp)
        mp.setattr(tempfile, "tempdir", tmp)
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
        node = global_worker.node
        host, port = node.tcp_address
        proxy = ProxyServer(f"tcp://{host}:{port}", node.authkey).start()
        try:
            yield node, proxy
        finally:
            proxy.stop()
            ray_tpu_torch.shutdown()


def _tenant_env(node, proxy) -> dict:
    env = dict(os.environ)
    env["PROXY_ADDR"] = f"ray_tpu_torch://{proxy.address[0]}:{proxy.address[1]}"
    host, port = node.tcp_address
    env["DIRECT_ADDR"] = f"tcp://{host}:{port}"
    env["RAY_TPU_TORCH_AUTHKEY"] = node.authkey.hex()
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    return env


def _run_tenant(script: str, env: dict, timeout: float = T):
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO_ROOT)
    assert "TENANT_OK" in proc.stdout, (
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-3000:]}")
    return proc


def _spawn_tenant(script: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", script], env=env, cwd=REPO_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            bufsize=1)


def _wait_for_line(proc: subprocess.Popen, token: str, timeout: float) -> str:
    box = {"line": None}

    def read():
        while True:
            line = proc.stdout.readline()
            if not line:
                return
            if token in line:
                box["line"] = line
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    assert box["line"] is not None, (
        f"child never printed {token!r} within {timeout}s (alive={proc.poll() is None})")
    return box["line"]


def _wait_until(fn, timeout: float = 20.0, interval: float = 0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


# -- actor namespaces (in-process driver) -------------------------------------

@ray_tpu_torch.remote
class Named:
    def __init__(self, label="x"):
        self.label = label

    def who(self):
        ctx = ray_tpu_torch.get_runtime_context()
        return {"label": self.label, "namespace": ctx.namespace, "job_id": ctx.job_id}


@ray_tpu_torch.remote
def _ident():
    c = ray_tpu_torch.get_runtime_context()
    return (c.namespace, c.job_id)


def test_runtime_context_identity(proxy_cluster):
    ctx = ray_tpu_torch.get_runtime_context()
    assert ctx.namespace == "default"
    assert ctx.job_id and ctx.job_id.startswith("job-")
    ns, job = ray_tpu_torch.get(_ident.remote(), timeout=T)
    assert ns == "default" and job == ctx.job_id  # tasks inherit the submitting job


def _lookup_missing(name, namespace) -> bool:
    try:
        ray_tpu_torch.get_actor(name, namespace=namespace)
        return False
    except ValueError:
        return True


def test_namespace_scoped_named_actors(proxy_cluster):
    a = Named.options(name="svc", namespace="ns-a").remote("a")
    b = Named.options(name="svc", namespace="ns-b").remote("b")
    got_a = ray_tpu_torch.get(ray_tpu_torch.get_actor("svc", namespace="ns-a").who.remote(),
                              timeout=T)
    got_b = ray_tpu_torch.get(ray_tpu_torch.get_actor("svc", namespace="ns-b").who.remote(),
                              timeout=T)
    assert got_a["label"] == "a" and got_b["label"] == "b"
    with pytest.raises(ValueError):  # cross-namespace lookup: like a missing name
        ray_tpu_torch.get_actor("svc", namespace="ns-c")
    with pytest.raises(ValueError):  # the driver's own namespace sees no tenant names
        ray_tpu_torch.get_actor("svc")
    dup = Named.options(name="svc", namespace="ns-a").remote("dup")
    with pytest.raises(Exception):
        ray_tpu_torch.get(dup.who.remote(), timeout=T)
    ray_tpu_torch.kill(a)
    assert _wait_until(lambda: _lookup_missing("svc", "ns-a")), "name not released after kill"
    c = Named.options(name="svc", namespace="ns-a").remote("a2")
    assert ray_tpu_torch.get(c.who.remote(), timeout=T)["label"] == "a2"
    for h in (b, c):
        ray_tpu_torch.kill(h)


def test_actor_rows_carry_namespace_and_job(proxy_cluster):
    from ray_tpu_torch.experimental.state import api as state

    h = Named.options(name="rowcheck", namespace="ns-rows").remote()
    ray_tpu_torch.get(h.who.remote(), timeout=T)
    rows = [r for r in state.list_actors() if r.get("name") == "rowcheck"]
    assert rows and rows[0]["namespace"] == "ns-rows"
    assert rows[0]["job_id"] == ray_tpu_torch.get_runtime_context().job_id
    me = [t for t in state.list_tenants()
          if t["job_id"] == ray_tpu_torch.get_runtime_context().job_id]
    assert me and me[0]["alive"] and me[0]["namespace"] == "default"
    ray_tpu_torch.kill(h)


def test_option_validation():
    with pytest.raises(ValueError):
        Named.options(lifetime="ephemeral")
    with pytest.raises(ValueError):
        Named.options(namespace="")
    with pytest.raises(ValueError):
        Named.options(concurrency_groups={"io": 0})
    with pytest.raises(ValueError):
        Named.options(concurrency_groups={"_default": 2})


# -- concurrency groups -------------------------------------------------------

@ray_tpu_torch.remote(concurrency_groups={"io": 1, "health": 1}, max_concurrency=2)
class Grouped:
    def slow(self, s):
        time.sleep(s)
        return "done"

    def ping(self):
        return "pong"

    def tag(self, i):
        return i


def test_concurrency_group_starvation_and_fifo(proxy_cluster):
    """The JAX test's scenario with its default lane saturated by 6 calls
    of 1 s (the JAX test: 10 of 3 s) on 2 threads."""
    g = Grouped.remote()
    ray_tpu_torch.get(g.ping.remote(), timeout=T)
    slows = [g.slow.remote(1) for _ in range(6)]
    time.sleep(0.2)
    t0 = time.monotonic()
    assert ray_tpu_torch.get(g.ping.options(concurrency_group="health").remote(),
                             timeout=T) == "pong"
    assert time.monotonic() - t0 < 2.0, "health group starved by the default group"
    refs = [g.tag.options(concurrency_group="io").remote(i) for i in range(25)]
    assert ray_tpu_torch.get(refs, timeout=T) == list(range(25))  # per-group FIFO
    t0 = time.monotonic()
    more_io = [g.tag.options(concurrency_group="io").remote(i) for i in range(5)]
    assert ray_tpu_torch.get(g.ping.options(concurrency_group="health").remote(),
                             timeout=T) == "pong"
    assert time.monotonic() - t0 < 2.0
    ray_tpu_torch.get(slows + more_io, timeout=T)
    ray_tpu_torch.kill(g)


def test_concurrency_groups_async_actor(proxy_cluster):
    import asyncio

    @ray_tpu_torch.remote(concurrency_groups={"side": 1})
    class AsyncGrouped:
        async def block(self, s):
            await asyncio.sleep(s)
            return "slept"

        async def quick(self):
            return "quick"

    a = AsyncGrouped.remote()
    ray_tpu_torch.get(a.quick.remote(), timeout=T)
    blocks = [a.block.remote(2) for _ in range(4)]
    t0 = time.monotonic()
    assert ray_tpu_torch.get(a.quick.options(concurrency_group="side").remote(),
                             timeout=T) == "quick"
    assert time.monotonic() - t0 < 1.5
    ray_tpu_torch.get(blocks, timeout=T)
    ray_tpu_torch.kill(a)


def test_unknown_group_rejected_on_declared_handle(proxy_cluster):
    g = Grouped.remote()
    with pytest.raises(ValueError):
        g.ping.options(concurrency_group="nope")
    ray_tpu_torch.kill(g)


def test_serve_replica_control_group_under_saturation(proxy_cluster):
    """A replica saturated with slow requests answers health pings and
    drains inside its window: both ride its "control" group."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    @serve.deployment(name="slow-mt", max_concurrent_queries=2, num_replicas=1)
    class Slow:
        def __call__(self, request=None):
            time.sleep(2.0)
            return {"ok": True}

    serve.run(Slow.bind())
    node = proxy_cluster[0]
    try:
        controller = serve_api._get_client().controller
        handle = serve.get_deployment_handle("slow-mt")
        futs = [handle.remote() for _ in range(2)]
        time.sleep(0.3)
        info = ray_tpu_torch.get(controller.get_routing_info.remote("slow-mt"), timeout=10)
        assert info["replicas"], "replica dropped from routing under load"
        _, rhandle = info["replicas"][0]
        t0 = time.monotonic()
        assert ray_tpu_torch.get(rhandle.ping.options(concurrency_group="control").remote(),
                                 timeout=10) is not None
        assert time.monotonic() - t0 < 1.5, "health ping starved"
        serve.delete("slow-mt")
        assert _wait_until(lambda: any(
            e.get("source") == "serve" and e.get("message") == "replica drained"
            for e in node._list_state_page("events", 100_000, {"source": "serve"})[0]),
            timeout=15), "drain did not complete cleanly"
        done = ray_tpu_torch.get(futs, timeout=T)
        assert all(r == {"ok": True} for r in done), done
    finally:
        serve.shutdown()


# -- the client proxy: per-connection drivers ---------------------------------

TENANT_BASIC = textwrap.dedent("""
    import os
    import ray_tpu_torch

    ray_tpu_torch.init(os.environ["PROXY_ADDR"], namespace=os.environ.get("TENANT_NS") or None)
    ctx = ray_tpu_torch.get_runtime_context()
    print("IDENT", ctx.job_id, ctx.namespace, flush=True)

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    assert ray_tpu_torch.get(double.remote(21), timeout=60) == 42

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0
        def add(self, k):
            self.n += k
            return self.n
        def who(self):
            c = ray_tpu_torch.get_runtime_context()
            return (c.namespace, c.job_id)

    c = Counter.options(name="svc").remote()
    assert ray_tpu_torch.get(c.add.remote(5), timeout=60) == 5
    h = ray_tpu_torch.get_actor("svc")
    assert ray_tpu_torch.get(h.add.remote(2), timeout=60) == 7
    ns, job = ray_tpu_torch.get(h.who.remote(), timeout=60)
    assert ns == ctx.namespace and job == ctx.job_id, (ns, job)
    print("TENANT_OK", flush=True)
""")


def test_proxy_two_tenants_isolated(proxy_cluster):
    node, proxy = proxy_cluster
    env = _tenant_env(node, proxy)
    p1 = _run_tenant(TENANT_BASIC, env)
    p2 = _run_tenant(TENANT_BASIC, env)
    _, job1, ns1 = [ln for ln in p1.stdout.splitlines() if ln.startswith("IDENT")][0].split()
    _, job2, ns2 = [ln for ln in p2.stdout.splitlines() if ln.startswith("IDENT")][0].split()
    assert job1 != job2 and ns1 != ns2  # distinct jobs, distinct default namespaces
    rows, _ = node._list_state_page("tenants", 100)
    by_job = {r["job_id"]: r for r in rows}
    assert by_job[job1]["proxied"] and by_job[job1]["pid"]
    assert by_job[job2]["namespace"] == ns2
    assert _wait_until(lambda: not any(ns in (ns1, ns2) for ns, _ in node.gcs.named_actors))


def test_the_tenant_driver_imports_no_torch():
    """The proxy waits 30 s for a driver's READY: its modules, those it
    loads after the handshake included, import no torch."""
    code = ("import sys\n"
            "import ray_tpu_torch.util.client.driver\n"
            "from ray_tpu_torch._private import events, log_plane, sampling_profiler, wire\n"
            "from ray_tpu_torch._private.client import connect_control\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=T, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


TENANT_VICTIM = textwrap.dedent("""
    import os, time
    import ray_tpu_torch

    ray_tpu_torch.init(os.environ["PROXY_ADDR"], namespace="tenant-a")

    @ray_tpu_torch.remote
    class Holder:
        def ping(self):
            return "up"

    victim = Holder.options(name="a-live").remote()
    keeper = Holder.options(name="a-keeper", lifetime="detached").remote()
    ray_tpu_torch.get([victim.ping.remote(), keeper.ping.remote()], timeout=60)
    pins = [ray_tpu_torch.put(bytes(256 * 1024)) for _ in range(4)]
    print("VICTIM_READY", flush=True)
    while True:
        time.sleep(0.5)
        ray_tpu_torch.get(victim.ping.remote(), timeout=60)
""")

TENANT_SOAKER = textwrap.dedent("""
    import json, os, time
    import ray_tpu_torch

    ray_tpu_torch.init(os.environ["PROXY_ADDR"], namespace="tenant-b")

    @ray_tpu_torch.remote
    def noop():
        return None

    @ray_tpu_torch.remote
    class BActor:
        def bump(self):
            return "b-alive"

    b = BActor.options(name="b-svc").remote()
    ray_tpu_torch.get([noop.remote(), b.bump.remote()], timeout=60)
    print("SOAKER_READY", flush=True)
    rows = []
    end = time.time() + float(os.environ["SOAK_S"])
    while time.time() < end:
        t0 = time.perf_counter()
        ray_tpu_torch.get(noop.remote(), timeout=60)
        rows.append((time.time(), time.perf_counter() - t0))
    assert ray_tpu_torch.get(ray_tpu_torch.get_actor("b-svc").bump.remote(),
                             timeout=60) == "b-alive"
    print("RESULT " + json.dumps(rows), flush=True)
    print("TENANT_OK", flush=True)
""")


def test_tenant_kill_chaos(proxy_cluster):
    """Two tenants through the proxy; the chaos op SIGKILLs tenant A's
    driver mid-workload.  B runs on; A's non-detached actor and pins are
    reaped, its detached actor survives, and the doctor explains the
    incident, quiet again once it has aged (3 s of soak; the JAX test's
    6 s)."""
    from ray_tpu_torch.devtools.chaos.harness import ChaosMonkey
    from ray_tpu_torch.util import doctor as doctor_mod

    node, proxy = proxy_cluster
    env = _tenant_env(node, proxy)
    victim = _spawn_tenant(TENANT_VICTIM, env)
    soaker = None
    try:
        _wait_for_line(victim, "VICTIM_READY", T)
        soaker = _spawn_tenant(TENANT_SOAKER, dict(env, SOAK_S="3"))
        _wait_for_line(soaker, "SOAKER_READY", T)
        rows, _ = node._list_state_page("tenants", 100)
        arow = [r for r in rows if r["namespace"] == "tenant-a" and r["alive"]][0]
        assert arow["proxied"]
        audit = node._memory_audit(limit=0)
        a_ns = [r for r in audit["by_namespace"] if r["namespace"] == "tenant-a"]
        assert a_ns and a_ns[0]["bytes"] >= 4 * 256 * 1024 and a_ns[0]["actors"] == 2

        rec = ChaosMonkey(node=node).kill_tenant_driver(namespace="tenant-a")
        assert rec["pid"] == arow["pid"] and rec["op"] == "kill_tenant_driver"
        rows, _ = node._list_state_page("tenants", 100)
        brow = [r for r in rows if r["namespace"] == "tenant-b" and r["alive"]][0]
        assert brow["job_id"] != arow["job_id"]

        def a_reaped():
            with node.gcs.lock:
                states = {a.name: a.state for a in node.gcs.actors.values()
                          if a.job_id == arow["job_id"]}
            return states.get("a-live") == "DEAD" and states.get("a-keeper") == "ALIVE"
        assert _wait_until(a_reaped, timeout=30), "tenant A not reaped"
        assert _wait_until(lambda: not any(
            r["namespace"] == "tenant-a" and r["bytes"] > 0
            for r in node._memory_audit(limit=0)["by_namespace"]), timeout=30), \
            "tenant A pins not released"

        out, err = soaker.communicate(timeout=T)
        assert "TENANT_OK" in out, f"stdout:\n{out[-2000:]}\nstderr:\n{err[-3000:]}"
        b_rows = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][0][7:])
        assert [r for r in b_rows if r[0] >= rec["ts"]], "tenant B made no progress after the kill"

        events, _ = node._list_state_page("events", 100_000)
        assert any(e.get("source") == "chaos" and e.get("message") == "inject kill_tenant_driver"
                   and e.get("entity_id") == arow["job_id"] for e in events)
        found = [f for f in doctor_mod.diagnose(events) if f["rule"] == "tenant_killed"]
        assert found and arow["job_id"] in found[0]["summary"]
        assert found[0]["severity"] == "WARNING"  # the reap completed
        assert brow["job_id"] not in found[0]["summary"]
        aged = [dict(e, ts=e.get("ts", 0) - 300) if e.get("source") == "client_proxy" else e
                for e in events]
        assert not [f for f in doctor_mod.diagnose(aged) if f["rule"] == "tenant_killed"]
        keeper = ray_tpu_torch.get_actor("a-keeper", namespace="tenant-a")
        ray_tpu_torch.kill(keeper)
    finally:
        for p in (victim, soaker):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


# -- C15: a driver that calls shutdown() is no tenant death -------------------

TENANT_CLEAN_EXIT = textwrap.dedent("""
    import os
    import ray_tpu_torch

    ray_tpu_torch.init(os.environ[os.environ["WHICH_ADDR"]], namespace=os.environ["TENANT_NS"])

    @ray_tpu_torch.remote
    class Holder:
        def ping(self):
            return "up"

    h = Holder.remote()
    ref = ray_tpu_torch.put(bytes(64 * 1024))
    assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "up"
    print("JOB", ray_tpu_torch.get_runtime_context().job_id, flush=True)
    ray_tpu_torch.shutdown()
    print("TENANT_OK", flush=True)
""")


@pytest.mark.parametrize("which", ["DIRECT_ADDR", "PROXY_ADDR"])
def test_a_driver_that_calls_shutdown_is_no_tenant_death(proxy_cluster, which):
    """A driver (direct, or through the proxy's splice) that made an actor
    and a put, called ``shutdown()`` and exited 0: its actor is reaped and
    its pins released, and the doctor reports no ``tenant_killed``."""
    from ray_tpu_torch.experimental.state import api as state

    node, proxy = proxy_cluster
    ns = f"clean-{which.lower()}"
    out = _run_tenant(TENANT_CLEAN_EXIT, dict(_tenant_env(node, proxy), WHICH_ADDR=which,
                                              TENANT_NS=ns))
    job = [ln for ln in out.stdout.splitlines() if ln.startswith("JOB")][0].split()[1]
    assert out.returncode == 0

    def gone():
        row = [r for r in state.list_tenants() if r["job_id"] == job][0]
        with node.gcs.lock:
            live = [a for a in node.gcs.actors.values() if a.job_id == job and a.state != "DEAD"]
        return not row["alive"] and not live
    assert _wait_until(gone, timeout=30), "the clean driver's actor was not reaped"
    events, _ = node._list_state_page("events", 100_000, {"source": "client_proxy"})
    mine = [e["message"] for e in events if e.get("entity_id") == job]
    assert "tenant disconnected" in mine and "tenant driver died" not in mine, mine
    assert not [f for f in state.doctor_report()
                if f["rule"] == "tenant_killed" and job in f["summary"]]


def test_a_new_tenant_never_takes_a_live_tenants_log(tmp_path, monkeypatch):
    """Tenant logs are numbered by a count that only grows.  The JAX proxy
    numbers them by ``len(self.tenants)``, so after tenant 0 exits the
    next tenant is given tenant 1's live file; the port's never is."""
    from ray_tpu_torch.util.client import ProxyServer, proxier

    (tmp_path / "logs").mkdir()
    monkeypatch.setattr(proxier, "_last_session", lambda: {"session_dir": str(tmp_path)})
    proxy = ProxyServer("tcp://127.0.0.1:1", b"k")
    try:
        first, second = proxy._tenant_log_path(), proxy._tenant_log_path()
        proxy.tenants = {1: None, 2: None}
        proxy.tenants.pop(1)  # tenant 0 exited; tenant 1 lives on
        third = proxy._tenant_log_path()
    finally:
        proxy.tenants.clear()
        proxy.stop()
    assert len({first, second, third}) == 3
    assert all(os.path.dirname(p) == str(tmp_path / "logs") for p in (first, second, third))
    assert os.path.basename(third) == f"tenant-{os.getpid()}-2.log"


def test_doctor_tenant_rule_matches_the_jax_rule():
    """``_rule_tenant_killed`` on the same event rows as the JAX rule:
    stuck reap = open ERROR; death + reap = recent WARNING; aged = quiet;
    a clean "tenant disconnected" alone = nothing."""
    from ray_tpu.util import doctor as jax_doctor

    from ray_tpu_torch.util import doctor

    t = 1_000_000.0
    died = {"source": "client_proxy", "message": "tenant driver died",
            "entity_id": "job-0007", "ts": t}
    reaped = {"source": "client_proxy", "message": "tenant reaped",
              "entity_id": "job-0007", "ts": t + 1}
    clean = {"source": "client_proxy", "message": "tenant disconnected",
             "entity_id": "job-0008", "ts": t + 2, "severity": "INFO"}
    clock = {"source": "node", "message": "tick", "ts": t + 60}
    old_clock = {"source": "node", "message": "tick", "ts": t + 500}
    cases = [[died, clock], [died, reaped, clock], [died, reaped, old_clock],
             [clean, clock], [died, reaped, clean, clock]]
    for rows in cases:
        assert doctor._rule_tenant_killed(rows, ()) == jax_doctor._rule_tenant_killed(rows, ())
    f = doctor._rule_tenant_killed([died, clock], ())
    assert f and f["severity"] == "ERROR"
    f = doctor._rule_tenant_killed([died, reaped, clock], ())
    assert f and f["severity"] == "WARNING" and "job-0007" in f["summary"]
    assert doctor._rule_tenant_killed([died, reaped, old_clock], ()) is None
    assert doctor._rule_tenant_killed([clean, clock], ()) is None
