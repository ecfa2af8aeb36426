"""The port's usage report against the JAX package's: ``_private/usage.py``
and the head that folds it (reset at its start, the workers' flags read
from its KV and the session's totals written to ``usage_report.json``
at its shutdown).

The cases are ``tests/test_tooling.py::test_usage_report_written``'s on
a port head, with the features that the port's libraries record beside
it: a flag raised inside a worker reaches the head's report,
``data.range`` and ``workflow.run`` record theirs, the report has the
JAX report's keys, and ``RAY_TPU_TORCH_USAGE_STATS_ENABLED=0`` writes
none.  No JAX head starts (the JAX report is written by its module
alone); each case starts its own port head in this process under a
private ``TMPDIR`` and has its own time limit.
"""

import json
import os
import signal
import tempfile

import pytest

import ray_tpu_torch as rt
from ray_tpu._private import usage as jax_usage
from ray_tpu_torch._private import usage
from ray_tpu_torch._private.worker import global_worker

T = 60  # seconds: every get in this file
LIMIT = 90  # seconds: each test's own limit


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture
def private_tmp(tmp_path):
    with tempfile.TemporaryDirectory(prefix="usage_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        mp.setenv("RAY_TPU_TORCH_WORKFLOW_STORAGE", str(tmp_path / "wf"))
        try:
            yield d
        finally:
            if rt.is_initialized():
                rt.shutdown()


def _run_session(record_in_worker=True):
    rt.init(num_cpus=2)
    session_dir = global_worker.node.session_dir

    @rt.remote
    def f():
        if record_in_worker:
            from ray_tpu_torch._private.usage import record_feature

            record_feature("worker-side-feature")
        return 1

    assert rt.get(f.remote(), timeout=T) == 1
    usage.record_feature("unit-test-feature")
    rt.shutdown()
    return os.path.join(session_dir, "usage_report.json")


def test_usage_report_written(private_tmp):
    """A session's report lands in its directory: the driver's flag, a
    worker's flag (through the head's KV) and the task total."""
    with open(_run_session()) as f:
        report = json.load(f)
    assert "unit-test-feature" in report["features_used"]
    assert "worker-side-feature" in report["features_used"]
    assert report["counters"]["tasks_total"] >= 1


def test_the_report_has_the_jax_reports_keys(private_tmp, tmp_path):
    with open(_run_session()) as f:
        report = json.load(f)
    jax_usage.reset()
    try:
        jax_usage.record_feature("unit-test-feature")
        for name in ("tasks_total", "actors_total", "nodes_total"):
            jax_usage.record_set(name, 1)
        with open(jax_usage.write_report(str(tmp_path))) as f:
            ref = json.load(f)
    finally:
        jax_usage.reset()
    assert sorted(report) == sorted(ref)
    assert sorted(report["counters"]) == sorted(ref["counters"])
    assert report["schema_version"] == ref["schema_version"]


def test_the_libraries_record_their_features(private_tmp):
    """``data.range`` (``read_datasource``) and ``workflow.run`` record
    ``data`` and ``workflow``, as their JAX counterparts do."""
    from ray_tpu_torch import data, workflow

    rt.init(num_cpus=2)
    session_dir = global_worker.node.session_dir
    assert data.range(8, parallelism=2).count() == 8

    @rt.remote
    def one():
        return 1

    assert workflow.run(one.bind(), workflow_id="usage-flow") == 1
    rt.shutdown()
    with open(os.path.join(session_dir, "usage_report.json")) as f:
        report = json.load(f)
    assert {"data", "workflow"} <= set(report["features_used"])


def test_usage_stats_disabled_writes_no_report(private_tmp, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "0")
    assert not os.path.exists(_run_session())
