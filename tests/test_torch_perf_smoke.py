"""The port's microbenchmark harness (``ray_tpu_torch/_private/ray_perf.py``)
stays runnable, held to ``tests/test_perf_smoke.py``'s assertions, and
writes nowhere in the checkout.

``main(quick=True)`` runs every core row on the port's runtime (a head
with ``num_gpus=0``, then two real-agent clusters for the broadcast
rows); the CLI's merge by metric name runs with ``main`` stubbed.  Each
test has its own time limit; the processes they start get a private
``TMPDIR``.  No JAX head starts.
"""

import json
import os
import signal
import tempfile

import pytest

from ray_tpu_torch._private import ray_perf

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = {"test_ray_perf_quick": 240}


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = LIMIT_S.get(request.node.name, 60)

    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture
def private_tmp(monkeypatch):
    with tempfile.TemporaryDirectory(prefix="perf_") as d:
        monkeypatch.setenv("TMPDIR", d)
        monkeypatch.setattr(tempfile, "tempdir", d)
        yield d


def test_ray_perf_quick(private_tmp):
    results = ray_perf.main(quick=True)
    by_name = {r["metric"]: r["value"] for r in results}
    assert len(results) >= 9
    assert all(v > 0 for v in by_name.values())
    # the JAX test's floors: order-of-magnitude regressions only
    assert by_name["task_round_trip"] > 20
    assert by_name["actor_call_round_trip"] > 40
    # the JAX harness's rows, by name (sizes of the quick run)
    assert set(by_name) == {
        "put_small_1kb", "get_small_1kb", "put_numpy_64mb_gbps",
        "get_numpy_64mb_gbps", "task_round_trip", "task_throughput",
        "actor_call_round_trip", "actor_call_throughput",
        "threaded_actor_call_throughput", "data_iter_batches_32mb_gbps",
        "wait_8_ready", "watchdog_tick", "broadcast_16mb_to_2_nodes_gbps",
        "broadcast_16mb_to_2_nodes_samehost_gbps"}
    assert "RAY_TPU_TORCH_FORCE_REMOTE_PULL" not in os.environ


def test_default_out_lies_outside_the_checkout(private_tmp):
    out = ray_perf.default_out()
    assert out == os.path.join(private_tmp, "ray_tpu_torch", "bench_core.json")
    assert not os.path.realpath(out).startswith(os.path.realpath(REPO_ROOT) + os.sep)
    assert os.path.basename(out) != "BENCH_core.json"


def test_cli_merges_rows_by_metric_into_its_default_out(private_tmp, monkeypatch):
    """A core-only run replaces the metrics it measured and keeps the
    rest of the file (the JAX CLI's merge), in the default file under the
    session root; nothing is written into the checkout."""
    before = {p: os.stat(os.path.join(REPO_ROOT, p)).st_mtime_ns
              for p in ("BENCH_core.json",)}
    out = ray_perf.default_out()
    os.makedirs(os.path.dirname(out))
    with open(out, "w") as f:
        json.dump({"benchmarks": [{"metric": "queued_tasks_10k", "value": 10000},
                                  {"metric": "task_round_trip", "value": 1.0}]}, f)
    monkeypatch.setattr(ray_perf, "main", lambda quick=False: [
        {"metric": "task_round_trip", "value": 500.0, "unit": "ops/s"},
        {"metric": "put_small_1kb", "value": 900.0, "unit": "ops/s"}])
    payload = ray_perf.cli(["--quick"])
    with open(out) as f:
        assert json.load(f) == payload
    assert {r["metric"]: r["value"] for r in payload["benchmarks"]} == {
        "queued_tasks_10k": 10000, "task_round_trip": 500.0, "put_small_1kb": 900.0}
    assert {p: os.stat(os.path.join(REPO_ROOT, p)).st_mtime_ns for p in before} == before
