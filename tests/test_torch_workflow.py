"""Durable workflows on the port (``ray_tpu_torch/workflow/``) against the
JAX package's ``ray_tpu/workflow/``: ``run``, ``run_async``, ``resume``,
``cancel``, ``resume_all``, ``sleep``, ``wait_for_event``,
``continuation``, the step options and the cross-process liveness check.

The cases are ``tests/test_dag_workflow.py``'s workflow cases (its lines
112-470), by name, on a port head.  The step ids, which map a resumed
run onto its checkpoints, start nothing, so they are held to the JAX
package's: the same DAG shapes built in both packages get the same ids.

No JAX head starts.  One port head (``num_cpus=4``) serves the module
under a private ``TMPDIR``; each test keeps its workflows under its own
``RAY_TPU_TORCH_WORKFLOW_STORAGE`` and has its own time limit, and every
wait is bounded.
"""

import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.workflow import api as jax_api
from ray_tpu_torch import workflow
from ray_tpu_torch.workflow import api
from ray_tpu_torch.workflow.api import WorkflowStorage

T = 60  # seconds: every wait in this file
LIMIT = 120  # seconds: each test's own limit


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    tmp_path_factory.getbasetemp()  # pytest's temp root stays outside the private TMPDIR
    with tempfile.TemporaryDirectory(prefix="wf_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        rt.init(num_cpus=4)
        try:
            yield
        finally:
            rt.shutdown()


@pytest.fixture(autouse=True)
def _wf_storage(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_WORKFLOW_STORAGE", str(tmp_path / "wf"))


def _wait_status(wid, status):
    deadline = time.time() + T
    while workflow.get_status(wid) != status:
        assert time.time() < deadline, f"{wid} is {workflow.get_status(wid)}, not {status}"
        time.sleep(0.05)


# -- test_dag_workflow.py's workflow cases -------------------------------------


def test_workflow_run_and_output(runtime):
    @rt.remote
    def fetch():
        return [1, 2, 3]

    @rt.remote
    def total(xs):
        return sum(xs)

    assert workflow.run(total.bind(fetch.bind()), workflow_id="sum-flow") == 6
    assert workflow.get_status("sum-flow") == "SUCCEEDED"
    assert workflow.get_output("sum-flow") == 6
    assert any(m["workflow_id"] == "sum-flow" for m in workflow.list_all())


def test_workflow_resume_skips_completed_steps(runtime, tmp_path):
    """A step that fails mid-flow: resume() re-runs only the failed step,
    and completed steps load from their checkpoints."""
    marker = tmp_path / "fail-once"
    marker.write_text("arm")
    counter_file = tmp_path / "a-runs"
    counter_file.write_text("0")

    @rt.remote
    def step_a():
        n = int(counter_file.read_text()) + 1
        counter_file.write_text(str(n))
        return 10

    @rt.remote
    def step_b(x, marker_path):
        if os.path.exists(marker_path):
            os.unlink(marker_path)
            raise RuntimeError("transient failure")
        return x + 1

    dag = step_b.bind(step_a.bind(), str(marker))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="flaky")
    assert workflow.get_status("flaky") == "FAILED"
    assert counter_file.read_text() == "1"

    assert workflow.resume("flaky") == 11
    assert workflow.get_status("flaky") == "SUCCEEDED"
    assert counter_file.read_text() == "1"  # step_a's checkpoint was reused


def test_workflow_run_async(runtime):
    @rt.remote
    def slow():
        time.sleep(0.5)
        return "done"

    h = workflow.run_async(slow.bind(), workflow_id="async-flow")
    assert h.result(timeout=T) == "done"
    assert workflow.get_status("async-flow") == "SUCCEEDED"


def test_workflow_rejects_actor_nodes(runtime):
    @rt.remote
    class A:
        def go(self):
            return 1

    with pytest.raises(TypeError, match="task DAGs"):
        workflow.run(A.bind().go.bind(), workflow_id="bad")


def test_workflow_continuation(runtime):
    """A step returning a DAG continues the workflow with it; sub-steps
    checkpoint under the parent step's id (recursive factorial)."""
    @rt.remote
    def fact(n, acc=1):
        if n <= 1:
            return acc
        return workflow.continuation(fact.bind(n - 1, acc * n))

    assert workflow.run(fact.bind(5), workflow_id="fact5") == 120
    assert workflow.get_status("fact5") == "SUCCEEDED"
    steps = sorted(workflow.get_metadata("fact5")["steps"])
    assert len(steps) == 5 and all(s.startswith("0000-fact") for s in steps)


def test_workflow_step_retries(runtime, tmp_path):
    marker = tmp_path / "attempts"

    @workflow.options(max_retries=3)
    @rt.remote
    def flaky():
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            raise RuntimeError(f"boom {n}")
        return "ok"

    assert workflow.run(flaky.bind(), workflow_id="retry-flow") == "ok"
    assert int(marker.read_text()) == 3  # 2 failures + 1 success
    step = next(iter(workflow.get_metadata("retry-flow")["steps"].values()))
    assert step["status"] == "SUCCEEDED" and step["attempt"] == 2


def test_workflow_catch_exceptions(runtime):
    @workflow.options(catch_exceptions=True)
    @rt.remote
    def doomed():
        raise ValueError("expected-failure")

    @rt.remote
    def handle(pair):
        value, err = pair
        return "handled" if err is not None else value

    assert workflow.run(handle.bind(doomed.bind()), workflow_id="catch-flow") == "handled"
    assert workflow.get_status("catch-flow") == "SUCCEEDED"


def test_workflow_sleep_checkpoints_wakeup(runtime):
    """workflow.sleep resolves after the duration; the wake TIME is
    checkpointed so resume doesn't restart the clock."""
    @rt.remote
    def after(end_time):
        return time.time() >= end_time - 0.05

    t0 = time.time()
    assert workflow.run(after.bind(workflow.sleep(1.0)), workflow_id="sleepy") is True
    assert time.time() - t0 >= 0.9


def test_workflow_custom_event_listener(runtime, tmp_path):
    """A file-based EventListener: the workflow blocks until the event
    appears, then the commit step runs (checkpointed consumption)."""
    event_file = tmp_path / "evt.txt"
    ack_file = tmp_path / "ack.txt"

    class FileListener(workflow.EventListener):
        async def poll_for_event(self, path):
            import asyncio

            while not os.path.exists(path):
                await asyncio.sleep(0.05)
            with open(path) as f:
                return f.read()

        async def event_checkpointed(self, event):
            with open(str(ack_file), "w") as f:
                f.write(event)

    @rt.remote
    def consume(evt):
        return f"got:{evt}"

    def fire():
        time.sleep(1.0)
        event_file.write_text("payload-7")

    threading.Thread(target=fire, daemon=True).start()
    dag = consume.bind(workflow.wait_for_event(FileListener, str(event_file)))
    assert workflow.run(dag, workflow_id="evt-flow") == "got:payload-7"
    assert ack_file.read_text() == "payload-7"


def test_workflow_cancel(runtime):
    @rt.remote
    def forever():
        time.sleep(600)
        return 1

    h = workflow.run_async(forever.bind(), workflow_id="cancel-flow")
    _wait_status("cancel-flow", "RUNNING")
    time.sleep(0.5)  # let the step task actually submit
    workflow.cancel("cancel-flow")
    with pytest.raises(Exception):
        h.result(timeout=T)
    assert workflow.get_status("cancel-flow") == "CANCELED"


def test_workflow_resume_all(runtime, tmp_path):
    gate = tmp_path / "gate"

    @rt.remote
    def needs_gate():
        if not gate.exists():
            raise RuntimeError("gate closed")
        return "opened"

    with pytest.raises(Exception):
        workflow.run(needs_gate.bind(), workflow_id="gated")
    assert workflow.get_status("gated") == "FAILED"

    gate.write_text("x")
    results = workflow.resume_all(include_failed=True)
    assert [wid for wid, _ in results] == ["gated"]
    assert results[0][1].result(timeout=T) == "opened"
    assert workflow.get_status("gated") == "SUCCEEDED"


def test_workflow_options_validation(runtime):
    with pytest.raises(ValueError, match="unknown workflow options"):
        workflow.options(bogus=1)


def test_workflow_cancel_unknown_and_terminal(runtime):
    with pytest.raises(ValueError, match="no workflow"):
        workflow.cancel("never-existed")
    assert workflow.list_all() == []  # no phantom dir fabricated

    @rt.remote
    def one():
        return 1

    workflow.run(one.bind(), workflow_id="done-flow")
    workflow.cancel("done-flow")  # no-op, never downgrades a terminal status
    assert workflow.get_status("done-flow") == "SUCCEEDED"


def test_workflow_liveness_cross_process(runtime, tmp_path):
    """meta.json records pid+host at RUNNING time; another process's
    cancel()/resume_all() probe that liveness: a LIVE foreign run gets a
    cancel_requested flag (never a status overwrite) and is never
    double-run by resume_all; a DEAD one is safe to cancel/resume."""
    gate = tmp_path / "gate"

    @rt.remote
    def needs_gate():
        if not gate.exists():
            raise RuntimeError("gate closed")
        return "opened"

    with pytest.raises(Exception):
        workflow.run(needs_gate.bind(), workflow_id="live-flow")
    meta = WorkflowStorage("live-flow").read_meta()
    assert meta["status"] == "FAILED" and meta["pid"] is None

    # forge a LIVE foreign owner: a real subprocess whose pid is stamped in
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    try:
        WorkflowStorage("live-flow").write_meta(
            status="RUNNING", pid=proc.pid, host=socket.gethostname(),
            cancel_requested=False)
        assert workflow.resume_all(include_failed=True) == []
        with pytest.raises(ValueError, match="another live process"):
            workflow.resume("live-flow")
        workflow.cancel("live-flow")
        meta = WorkflowStorage("live-flow").read_meta()
        assert meta["status"] == "RUNNING" and meta["cancel_requested"] is True
    finally:
        proc.kill()
        proc.wait()
    # the owner is DEAD now: cancel takes over and marks CANCELED
    workflow.cancel("live-flow")
    assert workflow.get_status("live-flow") == "CANCELED"
    # ...and a CANCELED workflow resumes cleanly (the stale
    # cancel_requested flag must not insta-cancel the new run)
    gate.write_text("x")
    results = workflow.resume_all()
    assert [wid for wid, _ in results] == ["live-flow"]
    assert results[0][1].result(timeout=T) == "opened"
    assert workflow.get_status("live-flow") == "SUCCEEDED"
    assert WorkflowStorage("live-flow").read_meta()["pid"] is None


def test_workflow_meta_records_pid_while_running(runtime):
    @rt.remote
    def forever():
        time.sleep(600)
        return 1

    h = workflow.run_async(forever.bind(), workflow_id="pid-flow")
    _wait_status("pid-flow", "RUNNING")
    assert WorkflowStorage("pid-flow").read_meta()["pid"] == os.getpid()
    workflow.cancel("pid-flow")
    with pytest.raises(Exception):
        h.result(timeout=T)


def test_workflow_cancel_immediately_after_run_async(runtime):
    """cancel() in the window before the runner thread is scheduled is
    not lost: the handle is registered for cancellation from the moment
    run_async returns."""
    @rt.remote
    def forever():
        time.sleep(600)
        return 1

    h = workflow.run_async(forever.bind(), workflow_id="insta-cancel")
    workflow.cancel("insta-cancel")  # no wait: races the runner thread
    with pytest.raises(Exception):
        h.result(timeout=T)
    assert workflow.get_status("insta-cancel") == "CANCELED"


def test_the_default_storage_root_is_under_the_ports_session_root(monkeypatch):
    from ray_tpu_torch._private.config import session_root

    monkeypatch.delenv("RAY_TPU_TORCH_WORKFLOW_STORAGE")
    assert api._root() == os.path.join(session_root(), "workflows")
    assert not api._root().startswith("/tmp/ray_tpu/")


# -- step ids against the JAX package's -----------------------------------------


def _shapes(remote, options, input_node):
    """Four DAG shapes, built with a package's ``remote``, ``options`` and
    ``InputNode``: a chain, a diamond, a named step with options, and an
    input-driven fan-in."""
    @remote
    def load():
        return 1

    @remote
    def double(x):
        return 2 * x

    @remote
    def join(a, b, scale=1):
        return (a + b) * scale

    @options(name="stable-name", max_retries=2)
    @remote
    def named(x):
        return x

    src = load.bind()
    with input_node() as inp:
        fan_in = join.bind(double.bind(inp), double.bind(inp), scale=inp)
    left, right = double.bind(src), double.bind(src)
    return [double.bind(double.bind(src)), join.bind(left, right),
            named.bind(join.bind(src, named.bind(src))), fan_in]


def test_the_same_dag_shapes_get_the_jax_step_ids():
    from ray_tpu.dag import InputNode as JaxInput
    from ray_tpu.workflow import options as jax_options
    from ray_tpu_torch.dag import InputNode

    def ids(mod, dag, prefix=""):
        got = mod._step_ids(dag, prefix)
        return [got[id(n)] for n in dag.topological() if id(n) in got]

    port = _shapes(rt.remote, workflow.options, InputNode)
    ref = _shapes(ray_tpu.remote, jax_options, JaxInput)
    for p, r in zip(port, ref):
        assert ids(api, p) == ids(jax_api, r) and ids(api, p)
        assert ids(api, p, "0003-f~") == ids(jax_api, r, "0003-f~")
    assert ids(api, port[2])[-1].endswith("-stable-name")
