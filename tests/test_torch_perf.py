"""``ray_tpu_torch.util.perf`` on the CPU: exact phase sums, the MFU
arithmetic of ``util/flops.py``, first calls billed to ``compile``, and a
``summary()`` shaped as the JAX package's for the same scripted steps."""

import time

import pytest
import torch

from ray_tpu.util import perf as jax_perf
from ray_tpu_torch.util import flops, perf

H100 = "H100 80GB HBM3"


def _script(prof, step_fn):
    """Three steps: ingest and h2d scopes, the wrapped step, a collective;
    the second call of each shape is a hit, a new shape a miss again."""
    for shape in ((4, 8), (4, 8), (2, 8)):
        with prof.step():
            with prof.phase("ingest"):
                time.sleep(0.002)
            with prof.phase("h2d"):
                x = torch.ones(shape)
            step_fn(x)
            with prof.phase("collective"):
                time.sleep(0.001)
            time.sleep(0.001)  # uncovered: billed to "other"


def test_phases_sum_exactly_to_the_step_wall():
    prof = perf.StepProfiler(flops_per_token=6.0e6, tokens_per_step=64,
                             device_kind=H100, rank=3)
    step_fn = prof.wrap_jit(lambda x: (x @ x.T).sum(), name="step")
    _script(prof, step_fn)
    for s in prof.steps:
        assert sum(s["phases"].values()) == pytest.approx(s["wall_s"], rel=0, abs=1e-12)
        assert s["phases"]["other"] >= 0.001 * 0.5
    summ = prof.summary()
    assert summ["steps"] == 3 and summ["rank"] == 3
    assert sum(p["s"] for p in summ["phases"].values()) == pytest.approx(summ["wall_s"], abs=1e-6)
    # first call of each shape signature is billed to compile, the rest to compute
    assert [("compile" in s["phases"], "compute" in s["phases"]) for s in prof.steps] == [
        (True, False), (False, True), (True, False)]
    (entry,) = summ["compiles"]
    assert (entry["fn"], entry["misses"], entry["hits"], entry["n_sigs"]) == ("step", 2, 1, 2)


def test_mfu_is_the_flops_formula():
    fpt = flops.transformer_flops_per_token(124_000_000, 12, 768, 1024)
    prof = perf.StepProfiler(flops_per_token=fpt, tokens_per_step=6 * 1024,
                             device_kind=H100)
    with prof.step():
        time.sleep(0.01)
    s = prof.steps[-1]
    assert s["mfu"] == pytest.approx(flops.mfu(6 * 1024 / s["wall_s"], fpt, H100), rel=1e-12)
    assert prof.summary()["mfu"]["mean"] == pytest.approx(s["mfu"], rel=1e-4)
    # the CPU has no peak in the table: no MFU is made up for it
    cpu = perf.StepProfiler(flops_per_token=fpt, tokens_per_step=64, device="cpu")
    with cpu.step():
        pass
    assert cpu.steps[-1]["mfu"] is None
    explicit = perf.StepProfiler(flops_per_token=fpt, tokens_per_step=64, peak=1e12)
    with explicit.step():
        time.sleep(0.001)
    assert explicit.steps[-1]["mfu"] == pytest.approx(64 / explicit.steps[-1]["wall_s"] * fpt / 1e12)


def _shape(d):
    return {k: (_shape(v) if isinstance(v, dict) and k != "phases" else None)
            for k, v in d.items()}


def test_summary_has_the_jax_packages_keys():
    jp = jax_perf.StepProfiler(flops_per_token=6.0e6, tokens_per_step=64, rank=1)
    tp = perf.StepProfiler(flops_per_token=6.0e6, tokens_per_step=64,
                           device_kind=H100, rank=1)
    for prof in (jp, tp):
        with prof.step():
            with prof.phase("ingest"):
                time.sleep(0.001)
            with prof.phase("collective"):
                pass
    js, ts = jp.summary(), tp.summary()
    assert _shape(ts) == _shape(js)
    assert set(ts["phases"]) == set(js["phases"]) == {"ingest", "collective", "other"}
    assert set(ts["phases"]["ingest"]) == set(js["phases"]["ingest"])


def test_active_profiler_and_memory_sample_on_the_cpu():
    prof = perf.StepProfiler(rank=0).install()
    try:
        assert perf.active_profiler() is prof
        assert perf.local_summary()["steps"] == 0
    finally:
        prof.uninstall()
    assert perf.active_profiler() is None
    sample = perf.sample_device_memory()
    assert sample["kind"] == "host_rss" and sample["bytes_in_use"] > 0
    assert not torch.cuda.is_initialized()


def test_profiling_double_start_guard_and_profile_step(tmp_path):
    """``profile_trace`` degrades to a no-op when a trace is already live,
    and ``profile_step`` arms a one-step trace on the active profiler (the
    JAX package's test by name): False without one; with one, the next
    ``prof.step()`` writes a trace under the directory and the step after
    it runs untraced."""
    from ray_tpu_torch.util import profiling

    outer = tmp_path / "outer"
    with profiling.profile_trace(str(outer)):
        with profiling.profile_trace(str(tmp_path / "inner")):
            torch.ones(3).sum()
    assert outer.exists() and any(outer.rglob("*"))
    assert not (tmp_path / "inner").exists()
    # no active profiler: arming reports False
    assert perf.active_profiler() is None
    assert profiling.profile_step(str(tmp_path / "none")) is False
    prof = perf.StepProfiler(hbm_every=0).install()
    try:
        stepdir = tmp_path / "one-step"
        assert profiling.profile_step(str(stepdir)) is True
        with prof.step():
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        files = {(p, p.stat().st_mtime_ns, p.stat().st_size) for p in stepdir.rglob("*")}
        assert files
        # one-shot: the NEXT step runs untraced
        with prof.step():
            pass
        assert {(p, p.stat().st_mtime_ns, p.stat().st_size) for p in stepdir.rglob("*")} == files
        assert len(prof.steps) == 2
    finally:
        prof.uninstall()
    assert not (tmp_path / "none").exists()


def test_profiling_timed_scope():
    """``timed`` records a histogram ``ray_tpu_torch_timed_<name>_seconds``
    shaped as the JAX package's ``ray_tpu_timed_<name>_seconds`` for the
    same scopes (type, bounds, count), and ``tracing.span`` runs its block
    outside any trace."""
    from ray_tpu.util import metrics as jax_metrics
    from ray_tpu.util import profiling as jax_profiling
    from ray_tpu_torch.util import metrics, profiling, tracing

    def count(reg, name):
        # another test file in the same process may have timed this scope
        # (``test_tooling.py`` times ``unit_scope`` in the JAX package)
        m = reg.snapshot().get(name)
        return sum(v["count"] for v in m["values"].values()) if m else 0

    names = ((metrics, "ray_tpu_torch_timed_unit_scope_seconds"),
             (jax_metrics, "ray_tpu_timed_unit_scope_seconds"))
    before = [count(mod.registry(), name) for mod, name in names]
    for mod in (profiling, jax_profiling):
        for _ in range(2):
            with mod.timed("unit_scope"):
                time.sleep(0.01)
    after = [count(mod.registry(), name) for mod, name in names]
    assert [a - b for a, b in zip(after, before)] == [2, 2]
    snap = metrics.registry().snapshot()["ray_tpu_torch_timed_unit_scope_seconds"]
    jax_snap = jax_metrics.registry().snapshot()["ray_tpu_timed_unit_scope_seconds"]
    (vals,), (jax_vals,) = snap["values"].values(), jax_snap["values"].values()
    assert vals["count"] >= 2 and jax_vals["count"] >= 2 and vals["sum"] >= 0.02
    assert snap["type"] == jax_snap["type"] == "histogram"
    assert tuple(vals["bounds"]) == tuple(jax_vals["bounds"])
    assert sum(vals["buckets"]) == vals["count"]

    with tracing.span("noop-span"):
        pass
