"""Job submission on the port's head: the JobManager starts an entrypoint
as a driver subprocess with the cluster's address in its env, and
``JobSubmissionClient`` drives it (submit, status, logs, stop).

One port head serves the module (in this process); each test has its own
time limit and every wait a timeout.  No JAX head starts: the JAX
package's ``JobInfo`` is compared as a dataclass only.
"""

import dataclasses
import json
import os
import shlex
import signal
import sys
import tempfile
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

T = 60  # seconds: every wait in this file


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its 90 s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(90)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    tmp_path_factory.getbasetemp()  # pytest's temp root stays outside the private TMPDIR
    # a private TMPDIR: the session and the package cache live under it
    with tempfile.TemporaryDirectory(prefix="jobs_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        ray_tpu_torch.init(num_cpus=2)
        try:
            yield JobSubmissionClient()
        finally:
            ray_tpu_torch.shutdown()


def _py(code: str) -> str:
    return f"{sys.executable} -c {shlex.quote(code)}"


def test_a_job_succeeds_and_its_logs_come_back(client):
    job_id = client.submit_job(entrypoint=_py("print('hello from the job')"))
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.SUCCEEDED
    info = client.get_job_info(job_id)
    assert info["returncode"] == 0 and info["end_time"] >= info["start_time"]
    assert client.get_job_logs(job_id) == "hello from the job\n"
    # the log lives under the port's session directory
    assert info["log_path"] == os.path.join(global_worker.node.session_dir, "jobs",
                                            f"{job_id}.log")
    assert any(j["job_id"] == job_id and j["status"] == "SUCCEEDED"
               for j in client.list_jobs())


def test_a_failing_job_reports_its_return_code(client):
    job_id = client.submit_job(entrypoint=_py("import sys; print('bad'); sys.exit(3)"))
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.FAILED
    assert client.get_job_info(job_id)["returncode"] == 3
    assert client.get_job_logs(job_id) == "bad\n"


def _live_members(pgid):
    """Pids of the group's processes that still run (a zombie left to the
    head's reaper counts as gone)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(int(d))
    return out


def test_a_stopped_job_is_stopped_and_its_process_group_gone(client):
    job_id = client.submit_job(entrypoint="sleep 600 & sleep 600")
    assert client.get_job_status(job_id) == JobStatus.RUNNING
    pgid = os.getpgid(global_worker.node.job_manager.procs[job_id].pid)
    deadline = time.monotonic() + T
    while len(_live_members(pgid)) < 2:  # the shell has started its sleeps
        assert time.monotonic() < deadline, f"job group {pgid}: {_live_members(pgid)}"
        time.sleep(0.05)
    assert client.stop_job(job_id)
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.STOPPED
    while _live_members(pgid) or client.stop_job(job_id):
        assert time.monotonic() < deadline, f"process group {pgid} outlived its stop"
        time.sleep(0.1)


def test_a_duplicate_job_id_raises(client):
    job_id = client.submit_job(entrypoint="true", job_id="job-dup")
    assert job_id == "job-dup"
    with pytest.raises(ValueError, match="already exists"):
        client.submit_job(entrypoint="true", job_id="job-dup")
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.SUCCEEDED


def test_env_vars_reach_the_job(client):
    job_id = client.submit_job(
        entrypoint=_py("import os; print(os.environ['GREETING'], "
                       "os.environ['RAY_TPU_TORCH_JOB_ID'], "
                       "os.environ['RAY_TPU_TORCH_ADDRESS'].startswith('tcp://'))"),
        runtime_env={"env_vars": {"GREETING": "hi"}}, metadata={"owner": "tests"})
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.SUCCEEDED
    assert client.get_job_logs(job_id) == f"hi {job_id} True\n"
    assert client.get_job_info(job_id)["metadata"] == {"owner": "tests"}


@pytest.mark.parametrize("key", ["working_dir", "py_modules"])
def test_code_packages_fail_with_the_cut_named(client, key):
    """A code package the head cannot materialise (its URI is in no KV)
    fails the job before its process launches, and the job's log names
    the cause."""
    uri = "gcs://pkg-0000000000000000dead.zip"
    value = uri if key == "working_dir" else [uri]
    job_id = client.submit_job(entrypoint="true", runtime_env={key: value})
    assert client.get_job_status(job_id) == JobStatus.FAILED
    info = client.get_job_info(job_id)
    assert info["returncode"] is None
    log = client.get_job_logs(job_id)
    assert "runtime_env package setup failed" in log and "not found in the cluster KV" in log


def _pkg_entries():
    from ray_tpu_torch._private.runtime_env_packaging import PKG_KV_NAMESPACE

    return sorted(k for k in global_worker.node.gcs.kv_keys(PKG_KV_NAMESPACE)
                  if not k.endswith(b".meta"))


def test_a_job_runs_in_its_working_dir_with_its_py_modules(client, tmp_path):
    """A job's ``working_dir`` is shipped as a package and extracted as
    its cwd (its excluded file left out); its ``py_modules`` go on its
    PYTHONPATH; the same tree submitted again adds no KV entry; the
    job's package pins are gone once it ends."""
    from ray_tpu_torch._private.runtime_env_packaging import default_base_dir

    wd, mods = tmp_path / "job_wd", tmp_path / "mods"
    (wd / "data").mkdir(parents=True)
    (wd / "main.py").write_text(
        "import json, os, sys\n"
        "import job_helper\n"
        "files = sorted(f for f in os.listdir('.') if not f.startswith('.'))\n"
        "print(json.dumps({'cwd': os.getcwd(), 'files': files,\n"
        "                  'prompts': open('prompts.txt').read().split(),\n"
        "                  'helper': job_helper.double(21)}))\n")
    (wd / "prompts.txt").write_text("a b c\n")
    (wd / "data" / "big.bin").write_bytes(b"\0" * 4096)
    (mods / "job_helper").mkdir(parents=True)
    (mods / "job_helper" / "__init__.py").write_text("def double(x):\n    return 2 * x\n")
    env = {"working_dir": str(wd), "py_modules": [str(mods / "job_helper")],
           "excludes": ["data"]}
    job_id = client.submit_job(entrypoint=f"{sys.executable} main.py", runtime_env=env)
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.SUCCEEDED, \
        client.get_job_logs(job_id)
    out = json.loads(client.get_job_logs(job_id).strip().splitlines()[-1])
    assert out["prompts"] == ["a", "b", "c"] and out["helper"] == 42
    assert out["files"] == ["main.py", "prompts.txt"]  # "data" excluded (and the cache's
    # .ready and .pin-<pid> markers hidden)
    assert out["cwd"].startswith(default_base_dir()) and os.path.isdir(out["cwd"])
    entries = _pkg_entries()
    assert len(entries) == 2  # the working_dir and the module
    again = client.submit_job(entrypoint=f"{sys.executable} main.py", runtime_env=env)
    assert client.wait_until_finish(again, timeout=T) == JobStatus.SUCCEEDED
    assert _pkg_entries() == entries
    deadline = time.monotonic() + T
    while any(f.startswith(".pin-") for f in os.listdir(out["cwd"])):
        assert time.monotonic() < deadline, os.listdir(out["cwd"])
        time.sleep(0.05)


def test_a_job_that_calls_init_joins_the_cluster(client):
    code = ("import ray_tpu_torch as rt\n"
            "rt.init()\n"
            "@rt.remote\n"
            "def job_side_task():\n"
            "    return rt.get_runtime_context().node_id\n"
            "print(rt.get(job_side_task.remote(), timeout=60))\n")
    job_id = client.submit_job(entrypoint=_py(code))
    assert client.wait_until_finish(job_id, timeout=T) == JobStatus.SUCCEEDED, \
        client.get_job_logs(job_id)
    assert client.get_job_logs(job_id).strip() == "node-head"
    from ray_tpu_torch.experimental.state import list_tasks

    assert any(t["name"] == "job_side_task" and t["state"] == "FINISHED"
               for t in list_tasks())


def test_job_info_fields_equal_the_jax_dataclass():
    from ray_tpu._private import job_manager as jax_jm

    from ray_tpu_torch._private import job_manager

    def fields(cls):
        return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]

    assert fields(job_manager.JobInfo) == fields(jax_jm.JobInfo)
    assert JobStatus.TERMINAL == {"SUCCEEDED", "FAILED", "STOPPED"}
