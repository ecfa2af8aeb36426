"""The port's Chrome-trace timeline (``ray_tpu_torch/util/timeline.py``):
its renderers give the JAX package's events exactly on the same seeded
rows, and ``timeline_dump`` on a live port head writes the task and
actor-method slices.  No JAX head starts."""

import json
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import timeline

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


def _task_rows(rng, n=60):
    """Task-table rows as the head lists them: some queued, some never
    started, some traced (parents among them), every end time set."""
    rows = []
    for i in range(n):
        start = 1_700_000_000.0 + float(rng.uniform(0, 100))
        ran = rng.uniform() < 0.8
        exec_start = start + float(rng.uniform(0, 0.5)) if ran else None
        row = {"task_id": rng.bytes(16).hex(), "name": f"task_{i % 7}",
               "state": ["FINISHED", "FAILED", "RUNNING"][int(rng.integers(3))],
               "node_id": None if i % 11 == 0 else f"node-{i % 3}",
               "start_time": None if i % 17 == 5 else start,
               "end_time": start + float(rng.uniform(0.5, 2.0)),
               "exec_start": exec_start,
               "exec_end": exec_start + float(rng.uniform(0, 0.5)) if ran else None,
               "worker_pid": int(rng.integers(1000, 2000)) if ran else None,
               "trace_ctx": None, "job_id": "job-0001"}
        if i % 4 == 0:
            row["trace_ctx"] = {"trace_id": f"tr{i % 3}", "span_id": f"sp{i}",
                                "parent_span_id": f"sp{i - 4}" if i >= 4 else "",
                                "name": f"submit_{i}"}
        rows.append(row)
    return rows


def _recorder_rows(rng, n=80):
    sources = ["scheduler", "trace", "compiled_dag", "serve", "collective"]
    rows = []
    for i in range(n):
        source = sources[i % len(sources)]
        row = {"ts": 1_700_000_000.0 + float(rng.uniform(0, 100)), "source": source,
               "severity": ["DEBUG", "INFO", "WARNING"][int(rng.integers(3))],
               "message": f"{source} event {i}", "origin": f"worker-{i % 4}",
               "seq": i + 1}
        if i % 3:
            row["entity_id"] = f"g{i % 2}:{i % 5}"
        if i % 2:
            row["span_dur"] = float(rng.uniform(0, 0.3))
        if source in ("trace", "compiled_dag") or i % 9 == 0:
            row["data"] = {"trace_id": f"tr{i % 3}", "span_id": f"rs{i}",
                           "parent_span_id": f"rs{i - 5}" if i >= 5 else "",
                           "bytes": int(rng.integers(0, 1 << 20))}
        if i % 13 == 0:
            row["ts"] = None  # skipped by the renderer
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_renderers_equal_the_jax_package_on_the_same_rows(seed):
    from ray_tpu.util import timeline as jax_timeline

    rng = np.random.default_rng(seed)
    tasks, recorder = _task_rows(rng), _recorder_rows(rng)
    for fn, args in (("events_from_task_rows", (tasks,)),
                     ("events_from_recorder_rows", (recorder,)),
                     ("merged_timeline", (tasks, recorder))):
        got = getattr(timeline, fn)(*args)
        want = getattr(jax_timeline, fn)(*args)
        assert got and got == want, fn
    merged = timeline.merged_timeline(tasks, recorder)
    assert {e["ph"] for e in merged} == {"X", "i", "s", "f", "M"}


@ray_tpu_torch.remote
def _slice_me():
    time.sleep(0.05)
    return 1


@ray_tpu_torch.remote
class _Sleeper:
    def nap(self):
        time.sleep(0.05)
        return 2


def test_timeline_dump_writes_the_task_and_method_slices(tmp_path):
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert ray_tpu_torch.get([_slice_me.remote() for _ in range(3)], timeout=T) == [1] * 3
        a = _Sleeper.remote()
        assert ray_tpu_torch.get(a.nap.remote(), timeout=T) == 2
        deadline = time.monotonic() + T
        while True:  # the head records a task's end just after its return
            path = timeline.timeline_dump(str(tmp_path / "trace.json"))
            events = json.loads(open(path).read())
            mine = [e for e in events if e["name"] == "_slice_me" and e["cat"] == "task"]
            naps = [e for e in events if e["name"] == "_Sleeper.nap" and e["cat"] == "task"]
            if len(mine) == 3 and naps and all(e["args"]["state"] == "FINISHED"
                                               for e in mine + naps):
                break
            assert time.monotonic() < deadline, (mine, naps)
            time.sleep(0.2)
        assert all(e["ph"] == "X" and e["dur"] >= 0.05e6 for e in mine + naps)
        assert all(e["pid"] == "node-head" and isinstance(e["tid"], int) for e in mine + naps)
        queued = [e for e in events if e["name"] == "_slice_me (queued)"]
        assert len(queued) == 3 and all(e["cat"] == "queue" for e in queued)
        assert any(e["ph"] == "M" and e["pid"] == "node-head" for e in events)
    finally:
        ray_tpu_torch.shutdown()
