"""The port's Data (``ray_tpu_torch.data``) on its own runtime, on the CPU.

The JAX package's one-node Data tests (``tests/test_data.py`` and
``tests/test_streaming_executor.py``, by name) run here against the port;
the two that need a multi-node cluster have no counterpart (the port's
runtime has one node, ROADMAP A).  The head-free helpers are held to the
JAX package's own functions on the same numpy inputs: ``BlockAccessor``,
the shuffle's map and reduce sides under one seed, the sort's, the fused
one-to-one stage and ``DataConfig.configure``; and a seeded
``random_shuffle`` of the port gives the row order of those JAX functions
chained by hand.

One runtime serves the module (``init(num_cpus=4, num_gpus=2)``: fake
cards, the grants are environment variables only).  The JAX package is
imported inside the tests that compare with it, so the workers that
import this module to run its functions never load it; no JAX head is
started."""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data._streaming import StreamingExecutor
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.plan import ExecutionPlan

T = 120  # seconds: every get in this file


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


def _flat(batches):
    return [int(v) for b in batches for v in np.asarray(b).reshape(-1)]


@ray_tpu_torch.remote(num_cpus=0)
class _Counter:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1

    def value(self):
        return self.n


# ---------------------------------------------------------------------------
# tests/test_data.py, by name


def test_range_and_aggregates(runtime):
    ds = rd.range(100, parallelism=4)
    assert ds.count() == 100
    assert ds.num_blocks() == 4
    assert ds.sum() == 4950
    assert ds.min() == 0 and ds.max() == 99
    assert ds.mean() == 49.5
    assert ds.std() == pytest.approx(np.arange(100).std())


def test_from_items_map_filter(runtime):
    ds = rd.from_items([{"x": i} for i in range(20)], parallelism=2)
    out = ds.map(lambda r: {"x": r["x"] * 2}).filter(lambda r: r["x"] % 4 == 0).take_all()
    assert [r["x"] for r in out] == [0, 4, 8, 12, 16, 20, 24, 28, 32, 36]


def test_map_batches_numpy(runtime):
    out = rd.range(16, parallelism=2).map_batches(lambda batch: batch * 10, batch_size=4)
    np.testing.assert_array_equal(out.to_numpy(), np.arange(16) * 10)


class _AddConst:
    def __init__(self, c):
        self.c = c

    def __call__(self, batch):
        return batch + self.c


def test_map_batches_actor_pool(runtime):
    out = rd.range(12, parallelism=3).map_batches(
        _AddConst, compute=rd.ActorPoolStrategy(size=2), fn_constructor_args=(100,))
    np.testing.assert_array_equal(np.sort(out.to_numpy()), np.arange(12) + 100)


class _Grant:
    def __call__(self, batch):
        from ray_tpu_torch import get_runtime_context

        ids = get_runtime_context().get_gpu_ids()
        return {"value": batch, "cvd": np.asarray([os.environ.get("CUDA_VISIBLE_DEVICES")] * len(batch)),
                "gpu": np.asarray([ids] * len(batch))}


@pytest.mark.parametrize("num_gpus,size,want", [(1, 2, {"0", "1"}), (0.5, 2, {"0"})])
def test_map_batches_actor_pool_on_cards(runtime, num_gpus, size, want):
    """A pool actor asks for ``num_gpus`` of a card: whole cards go to
    separate actors, halves share card 0; each actor's grant is its
    ``CUDA_VISIBLE_DEVICES``.  Once every block is sealed the pool is
    killed and its cards are free; the blocks stay readable."""
    out = rd.range(8, parallelism=4).map_batches(
        _Grant, compute=rd.ActorPoolStrategy(size=size), num_gpus=num_gpus).materialize()
    rows = out.take_all()
    assert sorted(int(r["value"]) for r in rows) == list(range(8))
    assert {r["cvd"] for r in rows} == want
    assert all([int(r["cvd"])] == list(r["gpu"]) for r in rows)
    deadline = time.time() + 30
    while ray_tpu_torch.available_resources().get("GPU") != 2.0 and time.time() < deadline:
        time.sleep(0.1)
    assert ray_tpu_torch.available_resources().get("GPU") == 2.0
    assert sorted(int(r["value"]) for r in out.take_all()) == list(range(8))


def test_flat_map_and_zip(runtime):
    assert rd.from_items([1, 2, 3], parallelism=1).flat_map(lambda x: [x, x]).take_all() == \
        [1, 1, 2, 2, 3, 3]


def test_split_and_union(runtime):
    shards = rd.range(12, parallelism=2).split(3)
    assert [s.count() for s in shards] == [4, 4, 4]
    assert shards[0].union(shards[1], shards[2]).count() == 12


def test_shuffle_sort(runtime):
    shuffled = rd.from_items(list(range(50)), parallelism=2).random_shuffle(seed=0)
    assert shuffled.take_all() != list(range(50))
    assert sorted(shuffled.take_all()) == list(range(50))
    s = rd.from_items([{"k": v} for v in [3, 1, 2]], parallelism=1).sort(key="k")
    assert [r["k"] for r in s.take_all()] == [1, 2, 3]


@pytest.mark.parametrize("n,parallelism,batch_size,prefetch", [(10, 3, 4, 2), (100, 5, 7, 3)])
def test_iter_batches(runtime, n, parallelism, batch_size, prefetch):
    """test_iter_batches and test_iter_batches_prefetch."""
    ds = rd.range(n, parallelism=parallelism)
    batches = list(ds.iter_batches(batch_size=batch_size, prefetch_blocks=prefetch))
    assert [len(b) for b in batches] == [batch_size] * (n // batch_size) + \
        ([n % batch_size] if n % batch_size else [])
    np.testing.assert_array_equal(np.concatenate(batches), np.arange(n))
    dropped = list(ds.iter_batches(batch_size=batch_size, drop_last=True))
    assert [len(b) for b in dropped] == [batch_size] * (n // batch_size)


def test_csv_roundtrip(runtime, tmp_path):
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    p = str(tmp_path / "t.csv")
    df.to_csv(p, index=False)
    ds = rd.read_csv(p)
    assert ds.count() == 3
    assert set(ds.schema()) == {"a", "b"}
    parts = ds.write_csv(str(tmp_path / "out.csv"))  # one part file per block
    back = pd.concat([pd.read_csv(f) for f in sorted(parts)], ignore_index=True)
    pd.testing.assert_frame_equal(back, df)


def test_numpy_json_text_and_binary_readers(runtime, tmp_path):
    arr = np.arange(30, dtype=np.int64).reshape(10, 3)
    parts = rd.from_numpy(arr, parallelism=2).write_numpy(str(tmp_path / "npy"))
    assert len(parts) == 2
    np.testing.assert_array_equal(rd.read_numpy(str(tmp_path / "npy")).to_numpy(), arr)
    rows = [{"a": i, "b": f"s{i}"} for i in range(6)]
    rd.from_items(rows, parallelism=2).write_json(str(tmp_path / "json"))
    back = rd.read_json(str(tmp_path / "json")).take_all()
    assert [(int(r["a"]), r["b"]) for r in back] == [(r["a"], r["b"]) for r in rows]
    (tmp_path / "t.txt").write_text("one\ntwo\nthree\n")
    assert rd.read_text(str(tmp_path / "t.txt")).take_all() == ["one", "two", "three"]
    (tmp_path / "b.bin").write_bytes(b"\x00\x01")
    (got,) = rd.read_binary_files(str(tmp_path / "b.bin")).take_all()
    assert got["bytes"] == b"\x00\x01" and got["path"].endswith("b.bin")


def test_pipeline_window_repeat(runtime):
    pipe = rd.range(8, parallelism=4).window(blocks_per_window=2).map_batches(lambda b: b + 1)
    assert sorted(int(r) for r in pipe.iter_rows()) == list(range(1, 9))
    assert len(list(rd.range(4, parallelism=1).repeat(2).iter_rows())) == 8


def _rows_loop(config):
    from ray_tpu_torch.air import session

    shard = session.get_dataset_shard("train")
    session.report({"rows": shard.count(), "rank": session.get_world_rank()})


def test_dataset_feeds_trainer_shards(runtime):
    """Dataset -> session.get_dataset_shard wiring (datasets= no longer
    raises)."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    result = TorchTrainer(
        _rows_loop, torch_config=TorchConfig(),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        datasets={"train": rd.range(8, parallelism=2)}, train_loop_config={}).fit()
    assert result.error is None, result.error
    assert result.metrics["rows"] == 4


def test_lazy_plan_and_fusion(runtime):
    """Transforms record stages; chains of per-block stages fuse into one
    task per block at execution."""
    out = rd.range(64, parallelism=4).map(lambda x: {"x": x * 2}).filter(
        lambda r: r["x"] % 4 == 0).map(lambda r: {"x": r["x"] + 1})
    assert out._plan._out is None
    assert len(out._plan.stages) == 3
    vals = sorted(r["x"] for r in out.take_all())
    assert vals == [x * 2 + 1 for x in range(64) if (x * 2) % 4 == 0]
    stats = out.stats()
    assert len(stats) == 1 and "map" in stats[0]["stage"] and "filter" in stats[0]["stage"]


def test_distributed_shuffle_no_driver_materialization(runtime):
    shuffled = rd.range(1000, parallelism=8).random_shuffle(seed=7)
    assert sorted(shuffled.to_numpy().tolist()) == list(range(1000))
    assert rd.range(1000, parallelism=8).random_shuffle(seed=7).take(20) != list(range(20))


def test_distributed_sort_by_key(runtime):
    import random as pyrandom

    rows = [{"k": pyrandom.Random(1).randint(0, 10_000), "i": i} for i in range(500)]
    pyrandom.Random(2).shuffle(rows)
    for descending in (False, True):
        out = [r["k"] for r in rd.from_items(rows, parallelism=6).sort(
            key="k", descending=descending).take_all()]
        assert out == sorted(out, reverse=descending)


def test_repartition_counts(runtime):
    ds = rd.range(100, parallelism=3).repartition(5)
    assert ds.num_blocks() == 5
    assert ds.count() == 100
    assert sorted(ds.to_numpy().tolist()) == list(range(100))


def test_groupby(runtime):
    ds = rd.from_items([{"k": i % 3, "v": i} for i in range(30)], parallelism=4)
    assert {r["key"]: r["count"] for r in ds.groupby("k").count().take_all()} == \
        {0: 10, 1: 10, 2: 10}
    sums = {r["key"]: r["sum"] for r in ds.groupby("k").sum("v").take_all()}
    assert sums[0] == sum(i for i in range(30) if i % 3 == 0)
    means = {r["key"]: r["mean"] for r in ds.groupby("k").mean("v").take_all()}
    assert means[1] == sum(i for i in range(30) if i % 3 == 1) / 10


class _SquaresSource(rd.Datasource):
    def prepare_read(self, parallelism, **_):
        per = 10
        return [rd.ReadTask(lambda lo=i * per: {"value": np.arange(lo, lo + per) ** 2},
                            num_rows=per) for i in range(parallelism)]


def test_custom_datasource(runtime):
    ds = rd.read_datasource(_SquaresSource(), parallelism=3)
    assert ds.count() == 30
    assert ds.max() == 29 ** 2


def test_stats_recorded(runtime):
    ds = rd.range(50, parallelism=2).map(lambda x: {"v": x}).random_shuffle(seed=0)
    ds.count()
    names = [s["stage"] for s in ds.stats()]
    assert any("map" in n for n in names) and any("shuffle" in n for n in names)


def test_zip_alignment_unequal_blocks(runtime):
    a = rd.from_items([{"a": i} for i in range(10)], parallelism=2)
    b = rd.from_items([{"b": i * 10} for i in range(8)], parallelism=3)
    rows = a.zip(b).take_all()
    assert len(rows) == 8
    assert all(r["b"] == r["a"] * 10 for r in rows)


def test_empty_dataset_aggregates(runtime):
    ds = rd.from_items([])
    assert ds.sum() == 0
    for op in (ds.min, ds.mean):
        with pytest.raises(ValueError, match="empty"):
            op()


def test_iter_batches_early_break(runtime):
    """Abandoning the iterator mid-epoch must not wedge the prefetcher."""
    import gc

    def prefetchers():
        return [t for t in threading.enumerate() if t.name == "iter-batches-prefetch"]

    for _ in range(5):
        for _batch in rd.range(100, parallelism=10).iter_batches(batch_size=5):
            break
    gc.collect()
    deadline = time.time() + 5
    while prefetchers() and time.time() < deadline:
        time.sleep(0.1)
    assert not prefetchers(), f"leaked prefetch threads: {prefetchers()}"


def test_to_torch_and_iter_torch_batches(runtime):
    """Batches come out as CPU tensors, as in the JAX package; the train
    loop moves them to its own device."""
    import torch

    ds = rd.from_items([{"x": float(i), "y": 2.0 * i} for i in range(16)])
    batches = list(ds.iter_torch_batches(batch_size=8))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in batches)
    assert sorted(torch.cat([b["x"] for b in batches]).tolist()) == [float(i) for i in range(16)]
    feats, labels = next(iter(ds.to_torch(label_column="y", feature_columns=["x"], batch_size=4)))
    assert feats.shape == (4, 1) and feats.dtype == torch.float32
    assert labels.shape[-1] == 1
    torch.testing.assert_close(labels.double(), (feats * 2).double())
    (it,) = rd.from_numpy(np.arange(10), parallelism=2).streaming_split(1)
    assert torch.cat(list(it.iter_torch_batches(batch_size=4))).tolist() == list(range(10))


def test_arrow_blocks_end_to_end(runtime, tmp_path):
    """Arrow blocks from parquet (pyarrow is installed here, not on the
    card's machine): stored and sliced as tables, converted on demand."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pa.table({"x": list(range(100)), "y": [i * 2.0 for i in range(100)]})
    pq.write_table(t.slice(0, 50), str(tmp_path / "a.parquet"))
    pq.write_table(t.slice(50, 50), str(tmp_path / "b.parquet"))
    ds = rd.read_parquet(str(tmp_path))
    assert isinstance(ray_tpu_torch.get(ds._blocks[0], timeout=T), pa.Table)
    assert ds.count() == 100
    assert sum(len(b["x"]) for b in ds.iter_batches(batch_size=30)) == 100
    ab = next(iter(ds.iter_batches(batch_size=32, batch_format="pyarrow")))
    assert isinstance(ab, pa.Table) and ab.num_rows == 32
    out = ds.map_batches(lambda b: {"x": b["x"] + 1, "y": b["y"]}).sort("x").take(3)
    assert [r["x"] for r in out] == [1, 2, 3]
    ds2 = rd.from_arrow(t)
    assert ds2.count() == 100
    assert ray_tpu_torch.get(ds2._blocks[0], timeout=T).column("x").to_pylist() == list(range(100))


def test_streaming_iter_overlaps_map(runtime):
    """The one-to-one suffix streams through iter_batches: the first batch
    comes before the last map task ends."""

    @ray_tpu_torch.remote
    def warm():
        return 0

    ray_tpu_torch.get([warm.remote() for _ in range(8)], timeout=T)

    def slow_inc(batch):
        time.sleep(0.3)
        return np.asarray(batch) + 1

    ds = rd.from_numpy(np.arange(64), parallelism=8).map_batches(slow_inc)
    t0 = time.perf_counter()
    it = ds.iter_batches(batch_size=8)
    first = next(it)
    t_first = time.perf_counter() - t0
    rest = list(it)
    t_all = time.perf_counter() - t0
    got = np.concatenate([np.asarray(first)] + [np.asarray(b) for b in rest])
    assert sorted(got.tolist()) == list(range(1, 65))
    assert t_first < t_all, (t_first, t_all)
    assert t_first < 1.5, f"first batch took {t_first:.2f}s (not streaming)"


# ---------------------------------------------------------------------------
# tests/test_streaming_executor.py, by name


def test_downstream_starts_before_upstream_finishes(runtime):
    @ray_tpu_torch.remote(num_cpus=0)
    class Gate:
        def __init__(self):
            self.open = False

        def release(self):
            self.open = True

        def is_open(self):
            return self.open

    gate = Gate.remote()

    def hold_last(batch):
        batch = np.asarray(batch)
        if batch.max() >= 56:  # the last block of range(64) in 8
            while not ray_tpu_torch.get(gate.is_open.remote()):
                time.sleep(0.02)
        return batch + 1

    it = rd.range(64, parallelism=8).map_batches(hold_last).iter_batches(batch_size=8)
    first = next(it)
    np.testing.assert_array_equal(np.sort(np.asarray(first)), np.arange(1, 9))
    ray_tpu_torch.get(gate.release.remote(), timeout=T)
    got = np.concatenate([np.asarray(first)] + [np.asarray(b) for b in it])
    np.testing.assert_array_equal(np.sort(got), np.arange(64) + 1)
    ray_tpu_torch.kill(gate)


def test_backpressure_budget_honored(runtime):
    budget = 3
    ex = StreamingExecutor(rd.range(240, parallelism=24).map(lambda x: x + 1)._plan,
                           max_in_flight_blocks=budget)
    ex.start()
    seen = 0
    while ex.get_next() is not None:
        time.sleep(0.01)  # a slow consumer: the pump must wait, not flood
        seen += 1
        assert ex.max_in_flight_observed <= budget
    assert seen == 24
    stats = ex.stats()
    assert stats["max_in_flight_observed"] <= budget and stats["produced_blocks"] == 24


def test_backpressure_stalled_consumer_pins_only_window(runtime):
    budget = 2
    ex = StreamingExecutor(rd.range(160, parallelism=16).map(lambda x: x)._plan,
                           max_in_flight_blocks=budget)
    ex.start()
    time.sleep(1.0)
    assert ex.max_in_flight_observed <= budget
    assert ex.stats()["produced_blocks"] <= budget
    ex.shutdown()


def test_backpressure_budget_defaults_to_eight_blocks():
    assert StreamingExecutor(ExecutionPlan([], None, []))._budget == 8
    assert StreamingExecutor(ExecutionPlan([], None, []),
                             max_in_flight_blocks=5)._budget == 5


def test_multi_split_slow_split_does_not_block_fast(runtime):
    ex = StreamingExecutor(rd.range(120, parallelism=12).map(lambda x: x)._plan,
                           num_splits=2, max_in_flight_blocks=2)
    ex.start()
    got = []
    while (ref := ex.get_next(0, timeout=60)) is not None:
        got.append(ref)
    assert got, "the fast split starved behind the stalled one"
    assert ex._in_flight[1] <= 2
    ex.shutdown()


@ray_tpu_torch.remote(num_returns="dynamic")
def _slow_blocks(n):
    for i in range(n):
        time.sleep(0.2)
        yield {"value": np.arange(i * 5, i * 5 + 5)}


def test_stall_and_starved_counters_and_events(runtime):
    """A pump held at its budget by a slow consumer, and a consumer that
    outruns a slow source, reach the ``ray_tpu_torch_streaming_*``
    counters and the ``streaming`` events."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch.data._streaming import executor as ex_mod

    metrics = ex_mod._stream_metrics()
    assert {m._name for m in metrics.values()} == {
        "ray_tpu_torch_streaming_blocks_total", "ray_tpu_torch_streaming_stall_s_total",
        "ray_tpu_torch_streaming_consumer_wait_s_total"}

    def total(key):
        return sum(metrics[key]._m["values"].values())

    def streaming_messages():
        return {r["message"] for r in events.local_events() if r.get("source") == "streaming"}

    before = {k: total(k) for k in metrics}
    ex = StreamingExecutor(rd.range(40, parallelism=8).map(lambda x: x)._plan,
                           max_in_flight_blocks=1)
    n = 0
    while ex.get_next(timeout=60) is not None:
        time.sleep(0.1)  # the pump waits at its budget meanwhile
        n += 1
    assert n == 8 and ex.stats()["stalled_s"] > 0
    assert total("blocks") - before["blocks"] == 8 and total("stall") > before["stall"]
    assert "backpressure stall" in streaming_messages()

    ex = StreamingExecutor(rd.from_block_generator(_slow_blocks.remote(3)).map(lambda x: x)._plan)
    assert sorted(v for r in iter(ex.get_next, None)
                  for v in BlockAccessor(ray_tpu_torch.get(r, timeout=T)).to_rows()) == \
        list(range(15))
    assert total("starved") > before["starved"]
    assert "split starved" in streaming_messages()


@pytest.mark.parametrize("build", [
    lambda: rd.range(100, parallelism=4).map(lambda x: x * 2),
    lambda: rd.range(60, parallelism=5).filter(lambda x: x % 3 == 0),
    lambda: rd.from_items(list(range(30)), parallelism=3).flat_map(lambda x: [x, x + 100]),
    lambda: rd.range(64, parallelism=4).map_batches(lambda b: np.asarray(b) * 10, batch_size=8)
        .map(lambda x: x + 1),
])
def test_iter_batches_parity_with_eager(runtime, build):
    ds_stream, ds_eager = build(), build()
    streamed = _flat(ds_stream.iter_batches(batch_size=7))
    refs, _ = ds_eager._plan.execute()
    eager = [int(v) for ref in refs for v in BlockAccessor(ray_tpu_torch.get(ref, timeout=T)).to_rows()]
    assert streamed == eager


def test_iter_batches_parity_after_shuffle_barrier(runtime):
    ds = rd.range(50, parallelism=5).random_shuffle(seed=7).map(lambda x: x + 5)
    first = _flat(ds.iter_batches(batch_size=9))
    assert sorted(first) == [i + 5 for i in range(50)]
    assert first == _flat(ds.iter_batches(batch_size=9))  # the shuffle ran once


def test_iter_batches_lazy_until_first_batch(runtime):
    ds = rd.range(30, parallelism=3).random_shuffle(seed=3).map(lambda x: x + 1)
    it = ds.iter_batches(batch_size=6)
    assert getattr(ds._plan, "_stream_prefix_out", None) is None, \
        "the shuffle ran when iter_batches() was called"
    assert sorted(_flat(it)) == [i + 1 for i in range(30)]
    assert ds._plan._stream_prefix_out is not None


def test_streaming_iter_caches_plan_result(runtime):
    ds = rd.range(40, parallelism=4).map(lambda x: x + 2)
    out1 = _flat(ds.iter_batches(batch_size=10))
    assert ds._plan._out is not None
    cached = list(ds._plan._out[0])
    assert _flat(ds.iter_batches(batch_size=10)) == out1
    assert list(ds._plan._out[0]) == cached
    assert any("streamed" in s["stage"] for s in ds.stats())


def test_streaming_error_propagates(runtime):
    def boom(x):
        if x >= 30:
            raise ValueError("block exploded")
        return x

    with pytest.raises(Exception, match="block exploded"):
        for _ in rd.range(40, parallelism=4).map(boom).iter_batches(batch_size=10):
            pass


def test_streaming_split_partitions_and_balances(runtime):
    rows, counts = [], []
    for it in rd.range(90, parallelism=9).map(lambda x: x).streaming_split(3):
        mine = _flat(it.iter_batches(batch_size=8))
        counts.append(len(mine))
        rows.extend(mine)
    assert sorted(rows) == list(range(90))
    assert min(counts) >= 10


def test_streaming_split_epoch_replay_no_reexecution(runtime):
    counter = _Counter.remote()

    def counted(x):
        ray_tpu_torch.get(counter.bump.remote())
        return x + 1

    (it,) = rd.range(24, parallelism=4).map(counted).streaming_split(1)
    epoch1 = _flat(it.iter_batches(batch_size=6))
    ran = ray_tpu_torch.get(counter.value.remote(), timeout=T)
    epoch2 = _flat(it.iter_batches(batch_size=6))
    assert sorted(epoch1) == list(range(1, 25))
    assert epoch1 == epoch2
    assert ray_tpu_torch.get(counter.value.remote(), timeout=T) == ran == 24
    ray_tpu_torch.kill(counter)


@ray_tpu_torch.remote(num_cpus=1)
def _drain(it):
    return _flat(it.iter_batches(batch_size=5))


def test_streaming_split_iterators_are_picklable(runtime):
    its = rd.range(40, parallelism=4).map(lambda x: x * 2).streaming_split(2)
    parts = ray_tpu_torch.get([_drain.remote(it) for it in its], timeout=T)
    assert sorted(parts[0] + parts[1]) == [i * 2 for i in range(40)]
    assert parts[0] and parts[1]


def test_streaming_split_validates_args(runtime):
    ds = rd.range(8, parallelism=2)
    with pytest.raises(ValueError):
        ds.streaming_split(0)
    with pytest.raises(ValueError):
        ds.streaming_split(2, locality_hints=["only-one"])


def test_locality_hint_names_the_heads_node(runtime):
    """The port's runtime has one node: a hint naming it is honoured (the
    map task runs there, under a soft node affinity); the multi-node
    placement tests have no counterpart (ROADMAP A)."""

    def tag_node(x):
        return {"v": x, "node": ray_tpu_torch.get_runtime_context().node_id}

    node = ray_tpu_torch.get_runtime_context().node_id
    (it,) = rd.range(20, parallelism=4).map(tag_node).streaming_split(1, locality_hints=[node])
    rows = list(it.iter_rows())
    assert sorted(r["v"] for r in rows) == list(range(20))
    assert {r["node"] for r in rows} == {node}


def _shard_loop(config):
    import json

    from ray_tpu_torch.air import session

    shard = session.get_dataset_shard("train")
    rows = [int(v) for b in shard.iter_batches(batch_size=4) for v in np.asarray(b).reshape(-1)]
    with open(os.path.join(config["dir"], f"rank{session.get_world_rank()}.json"), "w") as f:
        json.dump(rows, f)
    session.report({"rows": len(rows), "done": True})


def test_trainer_shards_route_through_streaming_split(runtime, tmp_path):
    import json

    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    result = TorchTrainer(
        _shard_loop, train_loop_config={"dir": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1}),
        datasets={"train": rd.range(32, parallelism=4).map(lambda x: x + 7)}).fit()
    assert result.error is None, result.error
    per_rank = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert per_rank[0] and per_rank[1]
    assert sorted(per_rank[0] + per_rank[1]) == [i + 7 for i in range(32)]


@pytest.mark.parametrize("shuffled", [False, True])
def test_equal_split_assignment_immune_to_consumer_speed(runtime, shuffled):
    """test_equal_split_assignment_immune_to_consumer_speed and (after a
    barrier, without row counts) test_equal_split_preassigns_even_without_row_counts."""
    ds = rd.range(120, parallelism=12)
    if shuffled:
        ds = ds.random_shuffle(seed=1)
    ex = StreamingExecutor(ds.map(lambda x: x)._plan, num_splits=2, max_in_flight_blocks=2)
    ex.start()
    splits = []
    for split in (0, 1):  # split 0 drains wholly while split 1 takes nothing
        refs = []
        while (ref := ex.get_next(split, timeout=60)) is not None:
            refs.append(ref)
        splits.append(refs)
    assert [len(s) for s in splits] == [6, 6], "the fast split stole the stalled split's blocks"
    rows = [int(v) for r in splits[0] + splits[1]
            for v in BlockAccessor(ray_tpu_torch.get(r, timeout=T)).to_rows()]
    assert sorted(rows) == list(range(120))


def test_concurrent_first_get_next_starts_one_pump(runtime):
    ex = StreamingExecutor(rd.range(60, parallelism=6).map(lambda x: x + 1)._plan, num_splits=3)
    barrier = threading.Barrier(3)
    got = [[] for _ in range(3)]

    def drain(i):
        barrier.wait()
        while (ref := ex.get_next(i, timeout=60)) is not None:
            got[i].append(ref)

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    pumps = [t for t in threading.enumerate()
             if t.name == "streaming-executor-pump" and t.is_alive()]
    assert len(pumps) <= 1, "two pumps over one source"
    rows = [int(v) for refs in got for r in refs
            for v in BlockAccessor(ray_tpu_torch.get(r, timeout=T)).to_rows()]
    assert sorted(rows) == [i + 1 for i in range(60)]


def test_abandoned_iter_batches_stops_pipeline(runtime):
    counter = _Counter.remote()

    def counted(x):
        ray_tpu_torch.get(counter.bump.remote())
        time.sleep(0.05)
        return x

    ds = rd.range(240, parallelism=24).map(counted)
    it = ds.iter_batches(batch_size=5)
    next(it)
    it.close()

    def pump_alive():
        return any(t.name == "streaming-executor-pump" and t.is_alive()
                   for t in threading.enumerate())

    deadline = time.time() + 30
    while time.time() < deadline and pump_alive():
        time.sleep(0.1)
    assert not pump_alive(), "the pump outlived its consumer"
    settled = ray_tpu_torch.get(counter.value.remote(), timeout=T)
    deadline = time.time() + 30
    while time.time() < deadline:
        time.sleep(1.0)
        now = ray_tpu_torch.get(counter.value.remote(), timeout=T)
        if now == settled:
            break
        settled = now
    assert settled <= 150, "the pump kept submitting after abandonment"
    assert ds._plan._out is None
    assert sorted(_flat(ds.iter_batches(batch_size=5))) == list(range(240))
    ray_tpu_torch.kill(counter)


class _Unpicklable:
    def __reduce__(self):
        raise RuntimeError("submission exploded")


def test_stream_error_is_terminal_not_a_hang(runtime):
    poison = _Unpicklable()
    ex = StreamingExecutor(rd.range(20, parallelism=2).map(lambda x, _p=poison: x)._plan)
    for timeout in (60, 10):  # the second poll re-raises at once
        with pytest.raises(Exception, match="submission exploded"):
            ex.get_next(timeout=timeout)


def test_split_reiteration_after_midepoch_abandon_is_full(runtime):
    (it,) = rd.range(60, parallelism=6).map(lambda x: x + 1).streaming_split(
        1, max_in_flight_blocks=2)
    gen = it.iter_batches(batch_size=10)
    next(gen)
    gen.close()
    assert sorted(_flat(it.iter_batches(batch_size=10))) == list(range(1, 61))


@ray_tpu_torch.remote(num_cpus=1)
def _child(x):
    return x * 2


@ray_tpu_torch.remote(num_cpus=1)
def _parent():
    refs = [_child.remote(i) for i in range(4)]
    return sum(ray_tpu_torch.get(refs, timeout=120))


def test_blocked_worker_reclaims_pipelined_child(runtime):
    assert ray_tpu_torch.get(_parent.remote(), timeout=180) == 2 * (0 + 1 + 2 + 3)


def test_arena_fd_write_min_env_guard():
    import subprocess
    import sys

    env = dict(os.environ, RAY_TPU_TORCH_ARENA_FD_WRITE_MIN="64MB")
    out = subprocess.run(
        [sys.executable, "-c", "from ray_tpu_torch._private import object_store as o; "
                               "print(o._ARENA_FD_WRITE_MIN)"],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 64 << 20


def test_object_store_capacity_never_exceeds_shm(monkeypatch):
    from ray_tpu_torch._private.config import Config, resolve_object_store_memory

    class TinyMount:
        f_frsize = 4096
        f_blocks = (64 << 20) // 4096
        f_bavail = (64 << 20) // 4096

    monkeypatch.setattr(os, "statvfs", lambda path: TinyMount())
    assert resolve_object_store_memory(Config(object_store_memory=0)) <= int((64 << 20) * 0.8)
    assert resolve_object_store_memory(Config(object_store_memory=123 << 20)) == 123 << 20


# ---------------------------------------------------------------------------
# the head-free helpers against the JAX package's own, on the same inputs


def _blocks():
    rng = np.random.default_rng(0)
    return {
        "table": {"a": rng.integers(0, 100, 13), "b": rng.normal(size=13)},
        "value": {"value": rng.normal(size=9)},
        "rows": [int(v) for v in rng.integers(0, 50, 11)],
        "dict_rows": [{"k": int(k), "v": float(v)} for k, v in
                      zip(rng.integers(0, 5, 7), rng.normal(size=7))],
        "empty": [],
    }


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("kind", list(_blocks()))
def test_block_accessor_matches_the_jax_packages(kind):
    from ray_tpu.data.block import BlockAccessor as JaxAccessor

    block = _blocks()[kind]
    port, ref = BlockAccessor(block), JaxAccessor(block)
    n = ref.num_rows()
    assert port.num_rows() == n
    _same(port.to_rows(), ref.to_rows())
    _same(port.to_batch(), ref.to_batch())
    _same(port.slice(1, max(1, n - 2)), ref.slice(1, max(1, n - 2)))
    assert port.schema() == ref.schema()
    others = [block, _blocks()[kind]]
    _same(BlockAccessor.concat(others), JaxAccessor.concat(others))
    batch = ref.to_batch()
    _same(BlockAccessor.from_batch(batch), JaxAccessor.from_batch(batch))


@pytest.mark.parametrize("kind", ["table", "value", "rows", "dict_rows"])
@pytest.mark.parametrize("n", [1, 3])
def test_shuffle_map_and_reduce_match_the_jax_packages(kind, n):
    """``_partition_random`` and ``_reduce_concat`` under one seed."""
    from ray_tpu.data import shuffle as jshuffle

    from ray_tpu_torch.data import shuffle as tshuffle

    block = _blocks()[kind]
    got, want = tshuffle._partition_random(block, n, 5), jshuffle._partition_random(block, n, 5)
    _same(got, want)
    parts = list(want) if n > 1 else [want]
    _same(tshuffle._reduce_concat(11, True, *parts), jshuffle._reduce_concat(11, True, *parts))
    _same(tshuffle._reduce_concat(None, False, *parts), jshuffle._reduce_concat(None, False, *parts))


@pytest.mark.parametrize("key,descending", [("k", False), ("k", True), (None, False)])
def test_sort_helpers_match_the_jax_packages(key, descending):
    """``_partition_by_range`` and ``_sort_block``."""
    from ray_tpu.data import shuffle as jshuffle

    from ray_tpu_torch.data import shuffle as tshuffle

    blocks = _blocks()
    block = blocks["dict_rows"] if key else blocks["rows"]
    bounds = [1, 3] if key else [10, 30]
    got = tshuffle._partition_by_range(block, key, bounds)
    want = jshuffle._partition_by_range(block, key, bounds)
    _same(got, want)
    _same(tshuffle._sort_block(key, descending, *want), jshuffle._sort_block(key, descending, *want))
    _same(tshuffle._slice_ranges(block, [2, 5]), jshuffle._slice_ranges(block, [2, 5]))


def test_fuse_one_to_one_matches_the_jax_packages():
    from ray_tpu.data import plan as jplan

    from ray_tpu_torch.data import plan as tplan

    fns = [(lambda b: [x * 2 for x in b], 1.0), (lambda b: [x for x in b if x % 3], 2.0)]
    t_task, t_fns, t_name = tplan.fuse_one_to_one(
        [tplan.OneToOneStage(f"s{i}", f, c) for i, (f, c) in enumerate(fns)])
    j_task, j_fns, j_name = jplan.fuse_one_to_one(
        [jplan.OneToOneStage(f"s{i}", f, c) for i, (f, c) in enumerate(fns)])
    assert t_name == j_name == "s0+s1"
    assert t_fns == j_fns
    block = list(range(20))
    assert tplan._run_fused(block, t_fns) == jplan._run_fused(block, j_fns)
    assert t_task._default_options["num_cpus"] == 2.0


class _FakeStreaming:
    """Records how DataConfig split it; stands for a Dataset in both."""

    def __init__(self):
        self.calls = []

    def iter_batches(self):
        pass

    def streaming_split(self, n, **kw):
        self.calls.append((n, kw))
        return [f"split{i}" for i in range(n)]


class _FakeSplittable:
    def split(self, n):
        return [f"part{i}" for i in range(n)]


@pytest.mark.parametrize("world,to_split,locality,nodes", [
    (1, "all", True, ["n0"]),
    (2, "all", True, ["n0", "n1"]),
    (3, ["train"], False, ["n0", "n1", "n2"]),
    (2, ["other"], True, None),
])
def test_data_config_configure_matches_the_jax_packages(world, to_split, locality, nodes):
    from ray_tpu.train.data_config import DataConfig as JaxDataConfig

    from ray_tpu_torch.train.data_config import DataConfig

    def datasets():
        return {"train": _FakeStreaming(), "seq": list(range(12)), "parts": _FakeSplittable()}

    got_ds, want_ds = datasets(), datasets()
    got = DataConfig(to_split, locality=locality, equal=False, max_in_flight_blocks=3).configure(
        got_ds, world, nodes)
    want = JaxDataConfig(to_split, locality=locality, equal=False,
                         max_in_flight_blocks=3).configure(want_ds, world, nodes)
    norm = {id(got_ds["train"]): "train", id(want_ds["train"]): "train"}
    assert [{k: norm.get(id(v), v) for k, v in s.items()} for s in got] == \
        [{k: norm.get(id(v), v) for k, v in s.items()} for s in want]
    assert got_ds["train"].calls == want_ds["train"].calls
    with pytest.raises(TypeError):
        DataConfig("train")


@pytest.mark.parametrize("seed,parallelism,num_blocks", [(7, 4, None), (3, 3, 5)])
def test_seeded_random_shuffle_gives_the_jax_functions_order(runtime, seed, parallelism, num_blocks):
    """The port's ``random_shuffle(seed=)`` against the JAX package's map
    and reduce sides chained by hand over the same blocks: block ``i``
    partitioned with ``seed + i``, partition ``j`` reduced with
    ``seed * 31 + j``."""
    from ray_tpu.data import shuffle as jshuffle

    ds = rd.from_numpy(np.arange(100) * 3, parallelism=parallelism)
    blocks = [ray_tpu_torch.get(r, timeout=T) for r in ds._blocks]
    got = ds.random_shuffle(seed=seed, num_blocks=num_blocks).take_all()
    n = num_blocks or len(blocks)
    parts = [jshuffle._partition_random(b, n, seed + i) for i, b in enumerate(blocks)]
    parts = [p if n > 1 else (p,) for p in parts]
    want = []
    for j in range(n):
        out = jshuffle._reduce_concat(seed * 31 + j, True, *[p[j] for p in parts])
        want.extend(int(v) for v in BlockAccessor(out).iter_rows())
    assert [int(v) for v in got] == want
