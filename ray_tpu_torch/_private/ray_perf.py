"""Core microbenchmark harness — the ``ray_perf.py`` analog.

The port's copy of ``ray_tpu/_private/ray_perf.py``, run on the port's
runtime.  Mirrors the reference's microbenchmark surface
(``python/ray/_private/ray_perf.py:93`` ``main`` — timed put/get, task
and actor call throughput, run by
``release/microbenchmark/run_microbenchmark.py``): these numbers are the
core runtime's regression surface.  Payloads are numpy arrays and bytes,
as in the JAX harness: no row moves a card tensor, and the runtime
starts with ``num_gpus=0``, so it runs as well on the host that holds
the card.  Run as a module to print one JSON object per metric and merge
them, by metric name, into ``--out`` (default
``$TMPDIR/ray_tpu_torch/bench_core.json``, under the port's session
root, so no run writes into the checkout):

    python -m ray_tpu_torch._private.ray_perf [--quick] [--scale]
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.config import session_root


def default_out() -> str:
    """Where the CLI writes its rows unless told: under the port's
    session root, never the checkout (the JAX harness writes the repo's
    root ``BENCH_core.json``)."""
    return os.path.join(session_root(), "bench_core.json")


def timeit(name: str, fn: Callable[[], Any], multiplier: int = 1,
           min_time_s: float = 1.0, results: List[Dict] | None = None) -> Dict:
    """Run ``fn`` repeatedly for ~min_time_s; report ops/s (x multiplier)."""
    fn()  # warmup
    start = time.perf_counter()
    count = 0
    while time.perf_counter() - start < min_time_s:
        fn()
        count += 1
    dt = time.perf_counter() - start
    rate = count * multiplier / dt
    rec = {"metric": name, "value": round(rate, 2), "unit": "ops/s"}
    print(json.dumps(rec), flush=True)
    if results is not None:
        results.append(rec)
    return rec


def main(quick: bool = False) -> List[Dict]:
    """All core microbenchmarks on a local node.  ``quick`` shrinks the
    large-object sizes and iteration floors for CI."""
    results: List[Dict] = []
    min_t = 0.3 if quick else 1.0
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        # settle: the prestarted worker pool boots concurrently with init;
        # benching against half-booted interpreters starves them of CPU
        # and skews every number
        from ray_tpu_torch._private.worker import global_worker as _gw0

        deadline = time.time() + 20
        while time.time() < deadline:
            rows = _gw0.client.request(
                {"type": "list_state", "what": "workers"}, timeout=10
            )["value"]
            if sum(1 for r in rows if r.get("state") in ("idle", "busy")) >= 4:
                break
            time.sleep(0.3)
        # -------------------------------------------------- put/get small
        small = b"x" * 1024

        def put_small():
            ray_tpu_torch.put(small)

        timeit("put_small_1kb", put_small, min_time_s=min_t, results=results)

        ref_small = ray_tpu_torch.put(small)

        def get_small():
            ray_tpu_torch.get(ref_small)

        timeit("get_small_1kb", get_small, min_time_s=min_t, results=results)

        # ------------------------------------------------- put/get large
        mb = 64 if quick else 256
        arr = np.random.default_rng(0).integers(0, 255, mb << 20, dtype=np.uint8)
        # warmup put/free: the steady-state number is what matters — the
        # arena recycles freed pages, so only the first-ever put pays the
        # kernel's fault-and-zero cost
        import gc

        warm = ray_tpu_torch.put(arr)
        del warm
        gc.collect()
        from ray_tpu_torch._private.worker import global_worker as _gw

        _gw.flush_removals()
        time.sleep(0.2)
        t0 = time.perf_counter()
        ref_big = ray_tpu_torch.put(arr)
        put_dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = ray_tpu_torch.get(ref_big)
        get_dt = time.perf_counter() - t0
        assert out.nbytes == arr.nbytes
        del out
        for name, dt in (("put", put_dt), ("get", get_dt)):
            rec = {"metric": f"{name}_numpy_{mb}mb_gbps",
                   "value": round(mb / 1024 / dt, 3), "unit": "GiB/s"}
            print(json.dumps(rec), flush=True)
            results.append(rec)
        del ref_big

        # -------------------------------------------------- tasks
        @ray_tpu_torch.remote
        def noop():
            return None

        # single in-flight round trip (scheduler+dispatch+seal latency)
        def task_rt():
            ray_tpu_torch.get(noop.remote(), timeout=60)

        timeit("task_round_trip", task_rt, min_time_s=min_t, results=results)

        # pipelined wave (throughput with the pool warm).  Worker boot is
        # ~2s on a small host while one wave is ~100ms, so ramp the pool
        # with un-timed waves first — otherwise the window measures 1-3
        # workers with 2 still booting and underreports ~3x.
        wave = 20 if quick else 100

        def task_wave():
            ray_tpu_torch.get([noop.remote() for _ in range(wave)], timeout=120)

        ramp_until = time.perf_counter() + (1.0 if quick else 3.0)
        while time.perf_counter() < ramp_until:
            task_wave()
        timeit("task_throughput", task_wave, multiplier=wave,
               min_time_s=min_t, results=results)

        # -------------------------------------------------- actors
        @ray_tpu_torch.remote
        class Echo:
            def ping(self):
                return None

        a = Echo.remote()
        ray_tpu_torch.get(a.ping.remote(), timeout=60)

        def actor_rt():
            ray_tpu_torch.get(a.ping.remote(), timeout=60)

        timeit("actor_call_round_trip", actor_rt, min_time_s=min_t, results=results)

        def actor_wave():
            ray_tpu_torch.get([a.ping.remote() for _ in range(wave)], timeout=120)

        timeit("actor_call_throughput", actor_wave, multiplier=wave,
               min_time_s=min_t, results=results)

        # threaded actor: pipelined calls overlap worker-side
        @ray_tpu_torch.remote(max_concurrency=8)
        class EchoMC:
            def ping(self):
                return None

        mc = EchoMC.remote()
        ray_tpu_torch.get(mc.ping.remote(), timeout=60)

        def actor_mc_wave():
            ray_tpu_torch.get([mc.ping.remote() for _ in range(wave)], timeout=120)

        timeit("threaded_actor_call_throughput", actor_mc_wave, multiplier=wave,
               min_time_s=min_t, results=results)

        # -------------------------------------------------- data ingest
        from ray_tpu_torch import data as rd

        mb_data = 32 if quick else 128
        arr2 = np.random.default_rng(1).standard_normal((mb_data << 20) // 8)
        ds = rd.from_numpy(arr2, parallelism=8)
        ds.materialize()
        t0 = time.perf_counter()
        seen = 0
        for batch in ds.iter_batches(batch_size=1 << 16, prefetch_blocks=3):
            seen += np.asarray(batch).nbytes
        dt = time.perf_counter() - t0
        rec = {"metric": f"data_iter_batches_{mb_data}mb_gbps",
               "value": round(seen / (1 << 30) / dt, 3), "unit": "GiB/s"}
        print(json.dumps(rec), flush=True)
        results.append(rec)

        # -------------------------------------------------- wait
        refs = [noop.remote() for _ in range(8)]
        ray_tpu_torch.get(refs, timeout=60)

        def do_wait():
            ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=60)

        timeit("wait_8_ready", do_wait, min_time_s=min_t, results=results)

        # ------------------------------------ watchdog tick (head-local)
        # one full evaluation pass — incremental doctor + trend queries +
        # SLO burn-rate — against the head this run just loaded with
        # tasks/actors/events.  ops/s so bench --check gates it: a
        # full-table pull sneaking back into the tick path shows up as a
        # step-function drop here.
        from ray_tpu_torch._private.worker import global_worker as _gw

        wd = getattr(_gw.node, "watchdog", None)
        if wd is not None:
            wd.tick()  # warm the event cursors / doctor window
            timeit("watchdog_tick", wd.tick, min_time_s=min_t,
                   results=results)
    finally:
        ray_tpu_torch.shutdown()

    # ---------------------------------------------------- broadcast (1->N)
    # real-process 2-agent cluster, measured both ways: the socket object
    # plane (RAY_TPU_TORCH_FORCE_REMOTE_PULL=1 — what distinct hosts would see,
    # sendfile -> mmap) and the same-host copy_file_range fast path
    # (PushManager fan-out analog either way)

    from ray_tpu_torch import experimental
    from ray_tpu_torch.cluster_utils import Cluster

    mb = 16 if quick else 64
    for forced, suffix in ((True, ""), (False, "_samehost")):
        if forced:
            os.environ["RAY_TPU_TORCH_FORCE_REMOTE_PULL"] = "1"
        else:
            os.environ.pop("RAY_TPU_TORCH_FORCE_REMOTE_PULL", None)
        cluster = Cluster(
            initialize_head=True,
            head_node_args={"num_cpus": 2, "num_gpus": 0},
            real_processes=True,
        )
        try:
            for _ in range(2):
                cluster.add_node(num_cpus=1)
            arr = np.random.default_rng(2).integers(
                0, 255, mb << 20, dtype=np.uint8)
            ref = ray_tpu_torch.put(arr)
            t0 = time.perf_counter()
            out = experimental.broadcast_object(ref, timeout=300)
            dt = time.perf_counter() - t0
            assert out["replicas"] == 2, out
            rec = {"metric": f"broadcast_{mb}mb_to_2_nodes{suffix}_gbps",
                   "value": round(mb * 2 / 1024 / dt, 3), "unit": "GiB/s"}
            print(json.dumps(rec), flush=True)
            results.append(rec)
        finally:
            cluster.shutdown()
    return results


def scale_envelope(quick: bool = False) -> List[Dict]:
    """Scalability-envelope proofs — the reference publishes these for its
    release qualification (``release/benchmarks/README.md:8-31``: queued
    tasks per node, live actors, large ``ray.get``, object spilling).
    Sizes scale to a single small host; each scenario records what was
    actually achieved."""
    import gc

    results: List[Dict] = []

    def record(rec):
        print(json.dumps(rec), flush=True)
        results.append(rec)

    # --------------------------- queued tasks (100k and 1M), 1 node
    # BOTH phases under ONE contention regime: dispatch/drain runs
    # concurrently with submission from first submit to last completion
    # (the old row measured submit against a concurrent drain but drain
    # after submit had finished — drain_ops_s was flattered ~15x by the
    # work already done during the submit wall).  sustained_ops_s is the
    # honest end-to-end number: n_tasks over first-submit -> last-
    # completion, plus bucket-estimated p50/p99 dispatch latency from
    # the head's scheduler histogram.
    def queued_tasks_row(n_tasks: int, label: str):
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
        try:
            @ray_tpu_torch.remote
            def noop():
                return None

            ray_tpu_torch.get([noop.remote() for _ in range(50)], timeout=120)
            t0 = time.perf_counter()
            refs = [noop.remote() for _ in range(n_tasks)]
            submit_dt = time.perf_counter() - t0
            for i in range(0, n_tasks, 5000):
                ray_tpu_torch.get(refs[i:i + 5000], timeout=3600)
            total_dt = time.perf_counter() - t0
            from ray_tpu_torch._private.worker import global_worker

            node = global_worker.node
            lat = node._merged_histogram_summary(
                node._merged_metrics_snapshot(),
                "ray_tpu_sched_dispatch_latency_s") or {}
            record({"metric": label, "value": n_tasks, "unit": "tasks",
                    "submit_ops_s": round(n_tasks / submit_dt, 1),
                    "sustained_ops_s": round(n_tasks / total_dt, 1),
                    "drain_wall_s": round(total_dt - submit_dt, 1),
                    "dispatch_p50_est_s": lat.get("p50_est_s"),
                    "dispatch_p99_est_s": lat.get("p99_est_s")})
            del refs
        finally:
            ray_tpu_torch.shutdown()

    queued_tasks_row(10_000 if quick else 100_000,
                     "queued_tasks_10k" if quick else "queued_tasks_100k")
    if not quick:
        # the reference-bar row: 1M queued tasks through one head
        # (release/benchmarks' many_tasks), target >=10k sustained ops/s
        queued_tasks_row(1_000_000, "queued_tasks_1m")

    # --------------------------- typed-wire overhead on task_throughput
    # the proto arm (packed hot-frame codec) vs the raw-pickle arm, same
    # wave benchmark: the acceptance bar is <=3% overhead, recorded here
    # per arm so the default flip stays justified by data.  ALTERNATING
    # repeats + medians: on a 1-core host a single back-to-back pair is
    # dominated by pool-warmup/GC ordering noise (one-shot runs swung
    # +-15% either direction); A/B/A/B with medians is stable.
    import statistics as _stats

    wave = 20 if quick else 100
    reps = 1 if quick else 3
    arms = {"pickle": [], "proto": []}

    def wire_arm(mode: str) -> float:
        saved_wire = os.environ.get("RAY_TPU_TORCH_WIRE")
        os.environ["RAY_TPU_TORCH_WIRE"] = mode
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
        try:
            @ray_tpu_torch.remote
            def noop2():
                return None

            def wavefn():
                ray_tpu_torch.get([noop2.remote() for _ in range(wave)],
                            timeout=120)

            ramp_until = time.perf_counter() + (1.0 if quick else 3.0)
            while time.perf_counter() < ramp_until:
                wavefn()
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < (0.5 if quick else 2.0):
                wavefn()
                n += wave
            return n / (time.perf_counter() - t0)
        finally:
            ray_tpu_torch.shutdown()
            # restore the CALLER's pin (pop would flip the rest of the
            # envelope run to the built-in default mid-bench)
            if saved_wire is None:
                os.environ.pop("RAY_TPU_TORCH_WIRE", None)
            else:
                os.environ["RAY_TPU_TORCH_WIRE"] = saved_wire

    for i in range(reps):
        order = ("proto", "pickle") if i % 2 else ("pickle", "proto")
        for mode in order:
            arms[mode].append(wire_arm(mode))
    p = _stats.median(arms["pickle"])
    q = _stats.median(arms["proto"])
    record({"metric": "task_throughput_wire_pickle",
            "value": round(p, 2), "unit": "ops/s"})
    record({"metric": "task_throughput_wire_proto",
            "value": round(q, 2), "unit": "ops/s"})
    record({"metric": "wire_overhead", "value": round((p - q) / p * 100, 2),
            "unit": "%", "proto_ops_s": round(q, 2),
            "pickle_ops_s": round(p, 2), "reps": reps})

    # ------------------------------------------------- 1k live actors
    # every actor is its own worker process; on a 1-core host the boot
    # storm is the cost, so creation is deadline-bounded and the record
    # says how many came alive
    n_actors = 100 if quick else 1000
    budget_s = 60 if quick else 900
    os.environ["RAY_TPU_TORCH_MAXIMUM_STARTUP_CONCURRENCY"] = "16"
    ray_tpu_torch.init(num_cpus=n_actors + 4, num_gpus=0)
    try:
        @ray_tpu_torch.remote
        class Lite:
            def ping(self):
                return 1

        t0 = time.perf_counter()
        actors = [Lite.remote() for _ in range(n_actors)]
        alive = 0
        pings = [a.ping.remote() for a in actors]
        deadline = time.time() + budget_s
        for i in range(0, len(pings), 100):
            try:
                ray_tpu_torch.get(pings[i:i + 100],
                            timeout=max(5.0, deadline - time.time()))
                alive += min(100, len(pings) - i)
            except Exception:
                break
        dt = time.perf_counter() - t0
        record({"metric": "live_actors", "value": alive, "unit": "actors",
                "target": n_actors, "wall_s": round(dt, 1),
                "actors_per_s": round(alive / dt, 2)})
        del actors
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TORCH_MAXIMUM_STARTUP_CONCURRENCY", None)

    # ------------------- sustained 16-emulated-node envelope, doctor-watched
    # the multi-node head envelope: every node takes dispatches for a
    # sustained window (tasks spread + one actor per node), then the
    # doctor reads the recorded state — the run only counts as healthy
    # with zero ERROR/CRITICAL findings (doctor_clean).
    n_nodes = 4 if quick else 16
    budget_s = 10 if quick else 45
    from ray_tpu_torch.cluster_utils import Cluster as _Cluster

    cluster = _Cluster(initialize_head=True,
                       head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        for _ in range(n_nodes - 1):
            cluster.add_node(num_cpus=2)

        @ray_tpu_torch.remote
        def spread():
            return None

        @ray_tpu_torch.remote
        class PerNode:
            def ping(self):
                return 1

        actors = [PerNode.remote() for _ in range(n_nodes)]
        ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=600)
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget_s:
            refs = [spread.remote() for _ in range(400)]
            refs += [a.ping.remote() for a in actors]
            ray_tpu_torch.get(refs, timeout=600)
            done += len(refs)
        dt = time.perf_counter() - t0
        from ray_tpu_torch.util.doctor import run_doctor

        findings = run_doctor()
        errors = [f for f in findings
                  if f.get("severity") in ("ERROR", "CRITICAL")]
        # watchdog tick against this loaded multi-node head rides along
        # as a field (the --check-gated watchdog_tick row lives in the
        # core run; this is the same tick at envelope scale)
        from ray_tpu_torch._private.worker import global_worker as _gw

        wd = getattr(_gw.node, "watchdog", None)
        wd_tick_ms = None
        if wd is not None:
            wd.tick()  # warm the cursors / doctor window
            n_ticks = 20 if quick else 100
            t1 = time.perf_counter()
            for _ in range(n_ticks):
                wd.tick()
            wd_tick_ms = round(
                (time.perf_counter() - t1) / n_ticks * 1e3, 3)
        record({"metric": "multi_node_envelope", "value": n_nodes,
                "unit": "nodes", "sustained_s": round(dt, 1),
                "ops_s": round(done / dt, 1),
                "doctor_findings": len(findings),
                "doctor_errors": len(errors),
                "doctor_clean": not errors,
                "watchdog_tick_ms": wd_tick_ms})
    finally:
        cluster.shutdown()

    # ------------------------------------------------- 8 GiB single get
    gib = 1 if quick else 8
    os.environ["RAY_TPU_TORCH_OBJECT_STORE_MEMORY"] = str((gib + 2) << 30)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        arr = np.frombuffer(
            bytearray(os.urandom(1 << 20)) * (gib << 10), dtype=np.uint8)
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(arr)
        put_dt = time.perf_counter() - t0
        head, tail = int(arr[5]), int(arr[-5])
        del arr
        gc.collect()
        t0 = time.perf_counter()
        out = ray_tpu_torch.get(ref)
        get_dt = time.perf_counter() - t0
        assert out.nbytes == gib << 30
        assert int(out[5]) == head and int(out[-5]) == tail
        record({"metric": f"single_get_{gib}gib", "value": gib, "unit": "GiB",
                "put_gbps": round(gib / put_dt, 2),
                "get_gbps": round(gib / get_dt, 2)})
        del out, ref
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TORCH_OBJECT_STORE_MEMORY", None)

    # -------------------------------------- spill under pressure + recovery
    # store capped far below the working set: puts must spill, gets must
    # restore every payload intact
    n_obj, mb_obj = (6, 64) if quick else (12, 64)  # working set > cap
    os.environ["RAY_TPU_TORCH_OBJECT_STORE_MEMORY"] = str(256 << 20)
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        rng = np.random.default_rng(7)
        sums, refs2 = [], []
        t0 = time.perf_counter()
        for i in range(n_obj):
            a = rng.integers(0, 255, mb_obj << 20, dtype=np.uint8)
            sums.append(int(a[::4096].sum()))
            refs2.append(ray_tpu_torch.put(a))
            del a
        put_dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = 0
        for ref, want in zip(refs2, sums):
            got = ray_tpu_torch.get(ref, timeout=300)
            assert int(got[::4096].sum()) == want
            ok += 1
            del got
        get_dt = time.perf_counter() - t0
        total_mb = n_obj * mb_obj
        record({"metric": "spill_under_pressure", "value": ok,
                "unit": "objects", "working_set_mb": total_mb,
                "store_cap_mb": 256,
                "put_gbps": round(total_mb / 1024 / put_dt, 2),
                "restore_gbps": round(total_mb / 1024 / get_dt, 2)})
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TORCH_OBJECT_STORE_MEMORY", None)
    return results


def cli(argv: Optional[List[str]] = None) -> Dict:
    """``python -m ray_tpu_torch._private.ray_perf``: run the rows asked
    for and merge them by metric name into ``--out``, so a core-only run
    keeps the file's scale-envelope rows (and the other way round); only
    the metrics measured in this run are replaced."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m ray_tpu_torch._private.ray_perf")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--scale", action="store_true",
                   help="also run the scalability-envelope scenarios")
    p.add_argument("--scale-only", action="store_true")
    p.add_argument("--out", default=default_out())
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    res = [] if args.scale_only else main(quick=args.quick)
    if args.scale or args.scale_only:
        res += scale_envelope(quick=args.quick)
    payload = {"benchmarks": res, "host": "single-node"}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                old = json.load(f)
            merged = {r["metric"]: r for r in old.get("benchmarks", [])}
            merged.update({r["metric"]: r for r in res})
            payload = {"benchmarks": list(merged.values()), "host": "single-node"}
        except Exception:
            pass
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    cli()
