"""Compiled execution graphs on the port's runtime (``dag/compiled.py`` +
``dag/channel.py``), mirrored by name from the JAX package's
``tests/test_compiled_dag.py``: the channel substrate (ring semantics,
overflow, poison, the stream transport on loopback), the compiled-graph
lifecycle, the chaos contract (a SIGKILLed mid-graph actor surfaces as a
typed error, never a hang), the flight recorder, the microbatch
pipeline's schedule and cross-node stream edges over a real agent.  The
prefill→decode graph is held to the JAX package's ``prefill`` +
``decode_chunk`` on the same weights, and a two-stage tiny GPT-2
``MicrobatchPipeline`` to its ``gpt2.apply``.

One port head serves the module (``init(num_cpus=4, num_gpus=2)``) until
the last test, which replaces it with a ``Cluster`` of real agents; no
JAX head starts.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag.channel import (
    ChannelClosedError,
    ChannelTimeoutError,
    ShmChannel,
    StreamReaderChannel,
    StreamWriterChannel,
)
from ray_tpu_torch.exceptions import ActorDiedError, RayTaskError


# ---------------------------------------------------------------------------
# channel substrate (no cluster needed)
# ---------------------------------------------------------------------------


def _chan_name(tag):
    import os

    return f"cdag-test-{tag}-{os.urandom(4).hex()}"


def test_shm_channel_roundtrip_and_backpressure():
    name = _chan_name("ring")
    w = ShmChannel.create(name, n_slots=2, slot_bytes=64)
    r = ShmChannel.attach(name)
    try:
        w.put(b"a")
        w.put(b"b")
        # ring full: the third put must block until a get frees a slot
        with pytest.raises(ChannelTimeoutError):
            w.put(b"c", timeout=0.1)
        assert r.get(timeout=5) == (b"a", 0)
        w.put(b"c", timeout=5)
        assert r.get(timeout=5) == (b"b", 0)
        assert r.get(timeout=5) == (b"c", 0)
        with pytest.raises(ChannelTimeoutError):
            r.get(timeout=0.05)
    finally:
        r.close()
        w.close(unlink=True)


def test_shm_channel_overflow_payload():
    name = _chan_name("ovf")
    w = ShmChannel.create(name, n_slots=2, slot_bytes=64)
    r = ShmChannel.attach(name)
    try:
        big = bytes(range(256)) * 64  # 16 KiB >> 64-byte slots
        w.put(big, flags=0)
        payload, flags = r.get(timeout=5)
        assert payload == big and flags == 0
    finally:
        r.close()
        w.close(unlink=True)


def test_shm_channel_poison_wakes_blocked_reader():
    name = _chan_name("poison")
    w = ShmChannel.create(name, n_slots=2, slot_bytes=64)
    r = ShmChannel.attach(name)
    errs = []

    def blocked_get():
        try:
            r.get(timeout=30)
        except ChannelClosedError as e:
            errs.append(e)

    t = threading.Thread(target=blocked_get)
    t.start()
    time.sleep(0.1)
    w.poison()
    t.join(timeout=10)
    assert not t.is_alive() and len(errs) == 1
    r.close()
    w.close(unlink=True)


def test_stream_channel_roundtrip_credits_poison():
    authkey = b"stream-test-key"
    w = StreamWriterChannel(capacity=2, authkey=authkey)
    r = StreamReaderChannel(w.addr, authkey)
    try:
        w.put(b"x", timeout=10)
        w.put(b"y", flags=1, timeout=10)
        # credits exhausted until the reader acks
        with pytest.raises(ChannelTimeoutError):
            w.put(b"z", timeout=0.2)
        assert r.get(timeout=10) == (b"x", 0)
        assert r.get(timeout=10) == (b"y", 1)
        w.put(b"z", timeout=10)  # acks drained -> credit available
        assert r.get(timeout=10) == (b"z", 0)
        w.poison()
        with pytest.raises(ChannelClosedError):
            r.get(timeout=10)
    finally:
        r.close()
        w.close()


# ---------------------------------------------------------------------------
# compiled graph lifecycle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compiled_cluster():
    """One cluster for every compiled-graph test in this module: graphs
    are isolated by construction (own actors, own channels), and sharing
    the boot keeps the tier-1 wall-clock flat."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Stage:
    def __init__(self, k=0):
        self.k = k
        self.calls = 0

    def fwd(self, x):
        self.calls += 1
        if x == "boom":
            raise ValueError("expected-failure")
        if x == "slow":
            time.sleep(15)
        return x + self.k

    def ncalls(self):
        return self.calls


@ray_tpu_torch.remote
class _Join:
    def join(self, x, y, bias=0):
        return x + y + bias


def test_compiled_chain_basic(compiled_cluster):
    with InputNode() as inp:
        dag = _Stage.bind(10).fwd.bind(_Stage.bind(1).fwd.bind(inp))
    cg = dag.experimental_compile(max_inflight=4)
    try:
        assert cg.execute(5).get(timeout=60) == 16
        # repeated executions reuse the compiled loops + channels
        for i in range(20):
            assert ray_tpu_torch.get(cg.execute(i), timeout=60) == i + 11
        # the graph ran on persistent actors, not fresh submits: the
        # second stage saw every call
        assert ray_tpu_torch.get(cg.actors[1].ncalls.remote(), timeout=60) == 21
    finally:
        cg.teardown()


def test_compiled_diamond_constants_kwargs(compiled_cluster):
    with InputNode() as inp:
        s = _Stage.bind(1)
        j = _Join.bind()
        dag = j.join.bind(s.fwd.bind(inp), s.fwd.bind(inp), bias=100)
    cg = dag.experimental_compile(max_inflight=3)
    try:
        assert cg.execute(2).get(timeout=60) == 106
        assert cg.execute(0).get(timeout=60) == 102
    finally:
        cg.teardown()


def test_compiled_pipelined_inflight_and_order(compiled_cluster):
    with InputNode() as inp:
        dag = _Stage.bind(1).fwd.bind(inp)
    cg = dag.experimental_compile(max_inflight=2)
    try:
        # submit more than max_inflight; execute() drains completed
        # results into the buffer instead of deadlocking on the ring
        refs = [cg.execute(i) for i in range(10)]
        assert [r.get(timeout=60) for r in refs] == list(range(1, 11))
        # out-of-submission-order gets are served from the buffer
        r0 = cg.execute(100)
        r1 = cg.execute(200)
        assert r1.get(timeout=60) == 201
        assert r0.get(timeout=60) == 101
    finally:
        cg.teardown()


def test_compiled_node_error_propagates_and_graph_survives(compiled_cluster):
    with InputNode() as inp:
        dag = _Stage.bind(10).fwd.bind(_Stage.bind(0).fwd.bind(inp))
    cg = dag.experimental_compile(max_inflight=2)
    try:
        with pytest.raises(RayTaskError, match="expected-failure"):
            cg.execute("boom").get(timeout=60)
        # the error flowed through the downstream node as a value: the
        # loops are still alive and the next execution succeeds
        assert cg.execute(1).get(timeout=60) == 11
    finally:
        cg.teardown()


def test_compiled_teardown_idempotent_and_rejects_use(compiled_cluster):
    with InputNode() as inp:
        dag = _Stage.bind(1).fwd.bind(inp)
    cg = dag.experimental_compile(max_inflight=2)
    assert cg.execute(1).get(timeout=60) == 2
    cg.teardown()
    cg.teardown()  # second teardown is a no-op, not an error
    from ray_tpu_torch.dag import CompiledGraphError

    with pytest.raises(CompiledGraphError, match="torn down"):
        cg.execute(1)


def test_compiled_graph_validation(compiled_cluster):
    from ray_tpu_torch.dag import CompiledGraphError

    @ray_tpu_torch.remote
    def plain_task(x):
        return x

    with pytest.raises(CompiledGraphError, match="actor method"):
        plain_task.bind(1).experimental_compile()

    with InputNode() as inp:
        nested = _Stage.bind(0).fwd.bind([inp])  # node inside a container
    with pytest.raises(CompiledGraphError, match="top-level"):
        nested.experimental_compile()


def test_compiled_chaos_actor_kill_types_error_no_hang(compiled_cluster):
    """test_chaos.py-style: SIGKILL a mid-graph actor while an execution
    is in flight — the caller gets a typed error within the channel
    timeout (never a hang) and teardown is clean afterwards."""
    with InputNode() as inp:
        a, b, c = _Stage.bind(0), _Stage.bind(0), _Stage.bind(0)
        dag = c.fwd.bind(b.fwd.bind(a.fwd.bind(inp)))
    cg = dag.experimental_compile(max_inflight=2)
    assert cg.execute(1).get(timeout=60) == 1
    ref = cg.execute("slow")  # wedges the middle stage for 15s
    time.sleep(0.5)
    ray_tpu_torch.kill(cg.actors[1])
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError, match="died or restarted"):
        ref.get(timeout=60)
    assert time.monotonic() - t0 < 30, "death detection took too long"
    cg.teardown()  # must not raise with a dead participant
    cg.teardown()


def test_compiled_mid_chain_poison_cascades_no_hang(compiled_cluster):
    """A mid-chain channel poisoned outside teardown (the loop-death
    shape): every downstream loop must cascade the poison, and the
    driver's get/execute must raise typed errors, never spin."""
    from ray_tpu_torch.dag import CompiledGraphError

    with InputNode() as inp:
        dag = _Stage.bind(1).fwd.bind(_Stage.bind(1).fwd.bind(inp))
    cg = dag.experimental_compile(max_inflight=2)
    try:
        assert cg.execute(1).get(timeout=60) == 3
        mid = next(e for e in cg._edges
                   if e["writer"] == 0 and e["reader"] == 1)
        ch = ShmChannel.attach(mid["name"])
        ch.poison()
        ch.close()
        ref = cg.execute(5)
        with pytest.raises(CompiledGraphError, match="broken"):
            ref.get(timeout=30)
        with pytest.raises(CompiledGraphError, match="broken"):
            for _ in range(20):  # outlast any in-flight channel capacity
                cg.execute(6)
    finally:
        cg.teardown()




def _all_events():
    """The head's table of shipped events and this process's own ring
    (the driver and the head share it)."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch._private.worker import global_worker

    rows = global_worker.node.events.list(limit=100_000)
    rows += [dict(r, origin="head") for r in events.local_events()]
    return rows


def test_compiled_events_reach_the_heads_table(compiled_cluster):
    """The graph's spans reach the head: the driver's compile event and
    result waits in its own ring, each node loop's exec spans shipped from
    the actor's worker."""
    with InputNode() as inp:
        dag = _Stage.bind(1).fwd.bind(inp)
    cg = dag.experimental_compile(max_inflight=2)
    try:
        for i in range(3):
            cg.execute(i).get(timeout=60)
        deadline = time.monotonic() + 20
        rows = []
        while time.monotonic() < deadline:
            rows = [r for r in _all_events() if r.get("source") == "compiled_dag"
                    and (r.get("entity_id") or "").startswith(cg._gid)]
            if any(r.get("message") == "fwd:0" and r.get("span_dur") is not None
                   and r.get("origin") != "head" for r in rows):
                break
            time.sleep(0.3)
        assert any(r.get("message") == "graph compiled" for r in rows), rows
        execs = [r for r in rows if r.get("message") == "fwd:0"]
        assert sorted(r["data"]["seq"] for r in execs) == [0, 1, 2], execs
        assert all(r["origin"] != "head" for r in execs)
    finally:
        cg.teardown()


def test_a_traced_request_after_idle_time_starts_at_the_request(compiled_cluster):
    """A two-stage graph sits idle 0.6 s, then runs one traced request:
    its stages' channel waits (a span where one lasts long enough) start
    no earlier than the request entered the graph, so the trace's wall
    stays within the request's own span (a 250 ms skew headroom, as in
    the JAX package, let an idle stage's wait start that far before the
    request: ROADMAP C11)."""
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util.trace_analysis import analyze

    with InputNode() as inp:
        dag = _Stage.bind(10).fwd.bind(_Stage.bind(1).fwd.bind(inp))
    cg = dag.experimental_compile(max_inflight=2)
    try:
        assert cg.execute(0).get(timeout=60) == 11
        time.sleep(0.6)
        with tracing.trace("after-idle") as ctx:
            assert cg.execute(1).get(timeout=60) == 12
        deadline, trace = time.monotonic() + 30, None
        while time.monotonic() < deadline:
            trace = state.get_trace(ctx["trace_id"])
            names = {s["name"] for s in (trace or {}).get("spans", ())}
            if {"after-idle", "fwd:0", "fwd:1"} <= names:
                break
            time.sleep(0.2)
        # a stage emits its wait before its exec span: both have arrived
        spans = trace["spans"]
        assert {"after-idle", "fwd:0", "fwd:1"} <= {s["name"] for s in spans}
        root = next(s for s in spans if s["name"] == "after-idle")
        early = [(s["name"], root["start"] - s["start"]) for s in spans
                 if s["start"] < root["start"] - 0.01]
        assert not early, early
        assert analyze(trace)["wall_s"] <= root["end"] - root["start"] + 0.05
    finally:
        cg.teardown()


def test_compiled_edges_are_shm_rings_under_the_ports_prefix(compiled_cluster):
    with InputNode() as inp:
        dag = _Stage.bind(10).fwd.bind(_Stage.bind(1).fwd.bind(inp))
    cg = dag.experimental_compile(max_inflight=2)
    try:
        assert cg.execute(1).get(timeout=60) == 12
        assert len(cg._edges) == 3
        assert isinstance(cg._reader, ShmChannel)
        assert all(isinstance(w, ShmChannel) for w in cg._writers.values())
        assert all(e["name"].startswith("rtpt-") for e in cg._edges), cg._edges
    finally:
        cg.teardown()


def test_get_takes_compiled_refs_beside_object_refs(compiled_cluster):
    @ray_tpu_torch.remote
    def plain(x):
        return x * 3

    with InputNode() as inp:
        dag = _Stage.bind(5).fwd.bind(inp)
    cg = dag.experimental_compile(max_inflight=2)
    try:
        assert ray_tpu_torch.get([cg.execute(1), plain.remote(2), cg.execute(3)],
                                 timeout=60) == [6, 6, 8]
        with pytest.raises(TypeError):
            ray_tpu_torch.get([cg.execute(1), "not a ref"], timeout=60)
    finally:
        cg.teardown()


# ---------------------------------------------------------------------------
# the prefill -> decode graph
# ---------------------------------------------------------------------------


def _grant(instance):
    import os

    return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_prefill_decode_compiled_graph(compiled_cluster):
    from ray_tpu_torch.serve.llm import prefill_decode_graph

    g = prefill_decode_graph(max_new_tokens=3, prefill_bucket=8, num_gpus=0, device="cpu")
    try:
        out1 = g.execute([1, 2, 3]).get(timeout=300)
        assert len(out1) == 3 and all(isinstance(t, int) for t in out1)
        # greedy decoding: same prompt -> same tokens
        assert ray_tpu_torch.get(g.execute([1, 2, 3]), timeout=300) == out1
    finally:
        g.teardown()


def _jax_prefill_decode(tparams, prompts, bucket, max_new):
    """The JAX package's ``prefill`` + greedy ``decode_chunk`` on the
    port's weights carried across as numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tpu.models import generate as jgen
    from ray_tpu.models.gpt2 import GPT2Config

    cfg = GPT2Config.tiny(dtype=jnp.float32)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    out = []
    for p in prompts:
        arr = np.zeros((1, bucket), np.int32)
        arr[0, :len(p)] = p
        cache = jgen.init_cache(cfg, 1, bucket + max_new + 1)
        last, cache = jgen.prefill(params, cfg, jnp.asarray(arr),
                                   jnp.asarray([len(p)], jnp.int32), cache, jnp.int32(0))
        first = int(jnp.argmax(last[0]))
        emitted, *_ = jgen.decode_chunk(
            params, cfg, cache, jnp.asarray([first], jnp.int32), jnp.ones((1,), bool),
            jax.random.PRNGKey(0), steps=max_new - 1, temperature=0.0)
        out.append([first] + [int(t) for t in np.asarray(emitted)[0]])
    return out


def test_prefill_decode_graph_matches_jax_prefill_and_decode_chunk(compiled_cluster):
    """f32 tiny GPT-2 from the graph's seed weights: every stream through
    the two stages (the cache crossing the channel as host arrays) equals
    the JAX package's greedy ``prefill`` + ``decode_chunk`` on the same
    weights, token for token.  A prompt over the bucket fails its request
    and the graph keeps serving."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.llm import _default_init, make_config, prefill_decode_graph

    bucket, max_new = 16, 6
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, n).tolist() for n in (3, 9, 16, 1)]
    g = prefill_decode_graph(max_new_tokens=max_new, prefill_bucket=bucket, num_gpus=0,
                             device="cpu", config_kwargs={"dtype": torch.float32})
    try:
        got = ray_tpu_torch.get([g.execute(p) for p in prompts], timeout=300)
        with pytest.raises(RayTaskError, match="exceeds the prefill bucket"):
            g.execute(list(range(1, bucket + 2))).get(timeout=120)
        with pytest.raises(RayTaskError, match="exceeds the graph's budget"):
            g.execute({"tokens": [1, 2], "max_new_tokens": max_new + 1}).get(timeout=120)
        assert g.execute({"tokens": prompts[0], "max_new_tokens": 2}).get(timeout=120) == \
            got[0][:2]
    finally:
        g.teardown()
    cfg = make_config("gpt2", "tiny", dtype=torch.float32)
    want = _jax_prefill_decode(_default_init(cfg, 0, torch.device("cpu")), prompts,
                               bucket, max_new)
    assert got == want


def test_prefill_decode_stages_share_card_zero_on_half_grants(compiled_cluster):
    from ray_tpu_torch.serve.llm import prefill_decode_graph

    g = prefill_decode_graph(max_new_tokens=2, prefill_bucket=8, device="cpu")
    try:
        assert len(g.execute([4, 5]).get(timeout=300)) == 2
        grants = ray_tpu_torch.get([h._submit_compiled_task(_grant, (), name="grant")
                                    for h in g.actors], timeout=60)
        assert grants == ["0", "0"]
        assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    finally:
        g.teardown()


# ---------------------------------------------------------------------------
# workload proofs: the microbatch pipeline between stage actors
# ---------------------------------------------------------------------------


def test_microbatch_pipeline_schedule(compiled_cluster):
    from ray_tpu_torch.parallel.pipeline import MicrobatchPipeline

    @ray_tpu_torch.remote
    class Add:
        def __init__(self, k):
            self.k = k

        def run(self, x):
            time.sleep(0.05)
            return x + self.k

    pipe = MicrobatchPipeline([Add.bind(1), Add.bind(10), Add.bind(100)],
                              n_microbatches=6)
    try:
        assert pipe.n_microbatches == 6 and pipe._dag._max_inflight == 6 + 3
        t0 = time.perf_counter()
        out = pipe.run(list(range(6)), timeout=120)
        wall = time.perf_counter() - t0
        assert out == [i + 111 for i in range(6)]
        # serial = S*M*0.05 = 0.9s; the pipelined schedule is
        # (M+S-1)*0.05 = 0.4s.  Assert the stages actually overlapped.
        assert wall < 0.8, f"no pipeline overlap: wall={wall:.2f}s"
        assert len(pipe.actors) == 3
    finally:
        pipe.teardown()


def test_microbatch_pipeline_gpt2_stages_match_jax_apply(compiled_cluster):
    """Tiny GPT-2 in f32 cut into two stage actors (``chip_smoke.GPT2Stage``,
    the card phase's stage on the CPU here): each microbatch's per-token
    next-token NLL through ``MicrobatchPipeline`` equals the JAX package's
    ``gpt2.apply`` on the same weights (carried across by
    ``convert.from_jax_params``) within 1e-5, absolute and relative, the
    f32 tolerance of ``test_torch_bert.py`` (torch's and XLA's CPU
    reductions differ in order: up to 5e-6 of an NLL of ~6 has been seen
    under the tier-1 run's 6 workers)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from chip_smoke import GPT2Stage
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.pipeline import MicrobatchPipeline

    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    params = jax.tree.map(np.asarray, jgpt2.init(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    mbs = [rng.integers(0, cfg.vocab_size, (2, 17), np.int32) for _ in range(4)]
    stage = ray_tpu_torch.remote(GPT2Stage)
    pipe = MicrobatchPipeline(
        [stage.bind(cfg, 0, 1, params, device="cpu"), stage.bind(cfg, 1, 2, params, device="cpu")],
        n_microbatches=len(mbs))
    try:
        got = pipe.run(mbs, timeout=300)
    finally:
        pipe.teardown()
    for ids, nll in zip(mbs, got):
        logits = jgpt2.apply(params, jnp.asarray(ids[:, :-1]), jcfg)
        want = jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, jnp.asarray(ids[:, 1:])[..., None], -1)[..., 0]
        assert nll.shape == (2, 16) and nll.dtype == np.float32
        np.testing.assert_allclose(nll, np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# cross-node: stream channels over a real agent process
# ---------------------------------------------------------------------------


def test_compiled_graph_cross_node_stream_edges(compiled_cluster):
    """Two stages pinned to different REAL nodes (private shm namespaces):
    the edge between them must come up as a stream channel and the graph
    must still round-trip.  Runs last: it replaces the module's head with a
    ``Cluster``'s."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    ray_tpu_torch.shutdown()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0},
                      real_processes=True)
    try:
        node_b = cluster.add_node(num_cpus=2)
        head = cluster.node_ids[0]

        with InputNode() as inp:
            s1 = _Stage.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(head)
            ).bind(1)
            s2 = _Stage.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(node_b)
            ).bind(10)
            dag = s2.fwd.bind(s1.fwd.bind(inp))
        cg = dag.experimental_compile(max_inflight=2)
        try:
            kinds = [(e["writer"], e["reader"], e["kind"]) for e in cg._edges]
            # the driver and stage 1 share the head's namespace; stage 2's
            # node has its own, so both of its edges are streams
            assert sorted(kinds) == [(-1, 0, "shm"), (0, 1, "stream"), (1, -1, "stream")], kinds
            assert isinstance(cg._reader, StreamReaderChannel)
            for i in range(5):
                assert cg.execute(i).get(timeout=120) == i + 11
        finally:
            cg.teardown()
    finally:
        cluster.shutdown()
