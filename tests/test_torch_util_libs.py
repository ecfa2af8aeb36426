"""The port's util libraries (``ActorPool``, ``Queue``, the
``multiprocessing.Pool``, the joblib backend, pubsub) against the JAX
package's, on the CPU.

The cases are ``tests/test_util_shims.py``'s and
``tests/test_mp_joblib_shims.py``'s, by name.  Each runs the same seeded
inputs through the port's library and through the JAX package's library
(its own module, its own algorithm), and the results are equal.  No JAX
head starts here: a JAX head writes the fixed
``/tmp/ray_tpu/last_session.json`` that another test's cluster reads
under xdist.  So the JAX modules run over the port's runtime: their
``ray_tpu`` global is the port's API for this module's tests, and their
actor classes (``_QueueActor``, ``_PoolWorker``) are the JAX package's
class bodies made remote by the port.

One port runtime (``init(num_cpus=4, num_gpus=2)``, fake cards) serves
the module, under a private ``TMPDIR``; every test has its own time
limit, and every wait is bounded.
"""

import operator
import os
import signal
import tempfile
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import ActorPool, pubsub
from ray_tpu_torch.util.multiprocessing import Pool
from ray_tpu_torch.util.queue import Empty, Full, Queue

T = 60  # seconds: every get and wait in this file
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
def runtime():
    with tempfile.TemporaryDirectory(prefix="utl_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        rt.init(num_cpus=4, num_gpus=2)
        try:
            yield
        finally:
            rt.shutdown()


@pytest.fixture(scope="module")
def jax_libs(runtime):
    """The JAX package's util modules, running over the port's runtime."""
    import ray_tpu.util.actor_pool as jap
    import ray_tpu.util.joblib as jjl
    import ray_tpu.util.multiprocessing as jmp
    import ray_tpu.util.pubsub as jps
    import ray_tpu.util.queue as jq

    from ray_tpu_torch._private.worker import global_worker

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jap, jq, jmp):
            mp.setattr(mod, "ray_tpu", rt)
        mp.setattr(jq, "_QueueActor", rt.remote(jq._QueueActor._cls))
        mp.setattr(jmp, "_PoolWorker", rt.remote(jmp._PoolWorker._cls))
        mp.setattr(jps, "_client", lambda: global_worker.client)
        yield {"actor_pool": jap, "queue": jq, "mp": jmp, "joblib": jjl,
               "pubsub": jps}


def _inputs(seed, n, high=1000):
    return np.random.default_rng(seed).integers(0, high, n).tolist()


@rt.remote
class Doubler:
    def double(self, x):
        return 2 * x

    def slow_double(self, x):
        time.sleep(0.05 * (x % 3))
        return 2 * x

    def grant(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def _both(jax_libs, fn):
    """``fn(ActorPool class)`` through the port's and the JAX package's."""
    return fn(ActorPool), fn(jax_libs["actor_pool"].ActorPool)


# -- ActorPool (test_util_shims.py) ------------------------------------------

def test_actor_pool_map_ordered(jax_libs):
    xs = _inputs(0, 10)
    actors = [Doubler.remote() for _ in range(3)]
    port, ref = _both(jax_libs, lambda cls: list(
        cls(actors).map(lambda a, x: a.slow_double.remote(x), xs)))
    assert port == ref == [2 * x for x in xs]


def test_actor_pool_map_unordered(jax_libs):
    xs = _inputs(1, 10)
    actors = [Doubler.remote() for _ in range(3)]
    port, ref = _both(jax_libs, lambda cls: list(
        cls(actors).map_unordered(lambda a, x: a.slow_double.remote(x), xs)))
    assert sorted(port) == sorted(ref) == sorted(2 * x for x in xs)


def test_actor_pool_submit_get_next(jax_libs):
    xs = _inputs(2, 2)
    actors = [Doubler.remote() for _ in range(2)]

    def run(cls):
        pool = cls(actors)
        for x in xs:
            pool.submit(lambda a, v: a.double.remote(v), x)
        out = [pool.has_free(), pool.get_next(), pool.get_next(), pool.has_next()]
        with pytest.raises(StopIteration):
            pool.get_next()
        return out

    port, ref = _both(jax_libs, run)
    assert port == ref == [False, 2 * xs[0], 2 * xs[1], False]


def test_actor_pool_push_pop(jax_libs):
    def run(cls):
        pool = cls([Doubler.remote()])
        pool.push(Doubler.remote())
        popped = pool.pop_idle()
        pool.submit(lambda a, x: a.double.remote(x), 5)
        out = [popped is not None, pool.get_next_unordered(), pool.has_next()]
        pool.pop_idle()
        with pytest.raises(ValueError):
            pool.pop_idle()
        return out

    port, ref = _both(jax_libs, run)
    assert port == ref == [True, 10, False]


# -- Queue (test_util_shims.py) ----------------------------------------------

def _outcome(fn, *args, **kwargs):
    """A call's value, or the name of what it raised (each package raises
    its own ``Empty``/``Full``)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        return type(e).__name__


def _queues(jax_libs, **kw):
    return Queue(**kw), jax_libs["queue"].Queue(**kw)


def test_queue_basic(jax_libs):
    outs = []
    for q in _queues(jax_libs):
        q.put(1)
        q.put("two")
        outs.append([q.qsize(), q.get(timeout=T), q.get(timeout=T), q.empty()])
        q.shutdown()
    assert outs[0] == outs[1] == [2, 1, "two", True]


def test_queue_nowait_and_batch(jax_libs):
    outs = []
    for q, fresh in zip(_queues(jax_libs, maxsize=2), _queues(jax_libs)):
        outs.append([
            _outcome(q.put_nowait, 1), _outcome(q.put_nowait, 2),
            _outcome(q.put_nowait, 3), _outcome(q.get_nowait),
            # a batch of 2 does not fit next to the 1 left
            _outcome(q.put_nowait_batch, [10, 11]), _outcome(q.get_nowait),
            _outcome(q.put_nowait_batch, [10, 11]), _outcome(fresh.get_nowait),
            _outcome(q.get_nowait_batch, 10)])
        q.shutdown()
        fresh.shutdown()
    assert outs[0] == outs[1] == [None, None, "Full", 1, "Full", 2, None, "Empty",
                                  [10, 11]]


def test_queue_blocking_get(jax_libs):
    outs = []
    for q in _queues(jax_libs):
        t = threading.Thread(target=lambda: (time.sleep(0.3), q.put("late")))
        t.start()
        outs.append(q.get(timeout=5))
        t.join(T)
        q.shutdown()
    assert outs == ["late", "late"]


def test_queue_get_timeout(jax_libs):
    outs = []
    for q in _queues(jax_libs):
        t0 = time.monotonic()
        outs.append((_outcome(q.get, timeout=0.2), time.monotonic() - t0 >= 0.2))
        q.shutdown()
    assert outs == [("Empty", True), ("Empty", True)]
    q = Queue(maxsize=1)  # the port raises its own exception classes
    q.put_nowait(0)
    with pytest.raises(Full):
        q.put(1, timeout=0.1)
    q.get_nowait()
    with pytest.raises(Empty):
        q.get_nowait()
    q.shutdown()


@rt.remote
def _producer(q, xs):
    for x in xs:
        q.put(x)
    return len(xs)


@rt.remote
def _jax_producer(q, xs):
    """The JAX package's ``Queue`` arrives here rebuilt by its own
    ``_rebuild_queue``; its module calls the port's API, as in the
    driver."""
    import ray_tpu.util.queue as jq

    jq.ray_tpu = rt
    for x in xs:
        q.put(x)
    return len(xs)


def test_queue_across_tasks(jax_libs):
    xs = _inputs(3, 5)
    port_q, jax_q = _queues(jax_libs)
    outs = []
    for q, producer in ((port_q, _producer), (jax_q, _jax_producer)):
        assert rt.get(producer.remote(q, xs), timeout=T) == len(xs)
        outs.append([q.get(timeout=T) for _ in xs])
        q.shutdown()
    assert outs[0] == outs[1] == xs


# -- multiprocessing.Pool (test_mp_joblib_shims.py) --------------------------

def _square(x):
    return x * x


def _add(a, b):
    return a + b


def _boom(x):
    raise RuntimeError(f"boom-{x}")


def _init_env(value):
    os.environ["RTPT_POOL_INIT"] = value


def _read_env(_):
    return os.environ.get("RTPT_POOL_INIT")


def _touch_marker(path):
    with open(os.path.join(path, f"{os.getpid()}-{os.urandom(4).hex()}"), "w"):
        pass
    return 1


def _pools(jax_libs, *args, **kw):
    return Pool(*args, **kw), jax_libs["mp"].Pool(*args, **kw)


def test_pool_map_apply_starmap(jax_libs):
    xs = _inputs(4, 10)
    pairs = [tuple(p) for p in np.random.default_rng(5).integers(0, 100, (4, 2)).tolist()]
    outs = []
    for p in _pools(jax_libs, 2):
        with p:
            r = p.apply_async(_square, (9,))
            outs.append([p.map(_square, xs), p.apply(_add, (3, 4)), p.starmap(_add, pairs),
                         r.get(timeout=T), r.ready(), r.successful()])
    assert outs[0] == outs[1] == [[x * x for x in xs], 7, [a + b for a, b in pairs],
                                  81, True, True]


def test_pool_imap_ordering(jax_libs):
    xs = _inputs(6, 20)
    outs = []
    for p in _pools(jax_libs, 2):
        with p:
            outs.append([list(p.imap(_square, xs, chunksize=3)),
                         sorted(p.imap_unordered(_square, xs, chunksize=3))])
    assert outs[0] == outs[1] == [[x * x for x in xs], sorted(x * x for x in xs)]


def test_pool_imap_submits_eagerly(jax_libs, tmp_path):
    """imap/imap_unordered dispatch every chunk AT CALL TIME (the stdlib
    contract): work proceeds even if the caller never touches the
    returned iterator, and a closed pool refuses new calls."""
    outs = []
    for i, p in enumerate(_pools(jax_libs, 2)):
        marker = tmp_path / str(i)
        marker.mkdir()
        with p:
            it = p.imap(_touch_marker, [str(marker)] * 6, chunksize=2)
            it2 = p.imap_unordered(_touch_marker, [str(marker)] * 6, chunksize=2)
            deadline = time.monotonic() + T
            while len(os.listdir(marker)) < 12 and time.monotonic() < deadline:
                time.sleep(0.1)
            n = len(os.listdir(marker))
            outs.append([n, list(it), list(it2)])
        outs[-1].append(_outcome(p.imap, _square, [1]))
    assert outs[0] == outs[1] == [12, [1] * 6, [1] * 6, "ValueError"]


def test_pool_maxtasksperchild_warns(jax_libs):
    outs = []
    for cls in (Pool, jax_libs["mp"].Pool):
        with pytest.warns(UserWarning, match="maxtasksperchild"):
            p = cls(1, maxtasksperchild=5)
        try:
            outs.append(p.map(_square, [3]))
        finally:
            p.terminate()
    assert outs == [[9], [9]]


def test_pool_initializer_and_errors(jax_libs):
    outs = []
    for p in _pools(jax_libs, 2, initializer=_init_env, initargs=("pool-7",)):
        with p:
            got = set(p.map(_read_env, range(4)))
            # surfaces as the task error carrying the worker-side traceback
            with pytest.raises(Exception, match="boom"):
                p.map(_boom, range(3))
            r = p.apply_async(_boom, (1,))
            r.wait(T)
            outs.append([got, r.ready(), r.successful()])
    assert outs[0] == outs[1] == [{"pool-7"}, True, False]


def test_pool_callbacks(jax_libs):
    xs = _inputs(7, 5)
    outs = []
    for p in _pools(jax_libs, 2):
        got = {}
        done = threading.Event()
        with p:
            p.map_async(_square, xs, callback=lambda v: (got.__setitem__("v", v), done.set()))
            assert done.wait(T)
        outs.append(got["v"])
    assert outs[0] == outs[1] == [x * x for x in xs]


def test_pool_lifecycle(jax_libs):
    outs = []
    for p in _pools(jax_libs, 1):
        p.close()
        outs.append(_outcome(p.map, _square, [1]))
        p.join()  # closed: join succeeds
        p.terminate()
    assert outs == ["ValueError", "ValueError"]


def test_pool_chunking_equals_the_jax_packages(jax_libs):
    """The chunk plan (the stdlib's 4 chunks a seat) is the JAX package's
    for every pool size, input length and chunksize."""
    jax_pool = jax_libs["mp"].Pool
    for size in (1, 2, 3, 4):
        for n in (0, 1, 7, 16, 33):
            for chunksize in (None, 1, 5):
                a, b = Pool.__new__(Pool), jax_pool.__new__(jax_pool)
                a._size = b._size = size
                assert a._chunks(range(n), chunksize) == b._chunks(range(n), chunksize)


# -- joblib (test_mp_joblib_shims.py) ----------------------------------------

def _fit_one(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(200, 8))
    w = rng.normal(size=8)
    west, *_ = np.linalg.lstsq(X, X @ w, rcond=None)
    return float(np.abs(west - w).max())


def _joblib_both(jax_libs, calls):
    joblib = pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import register_ray_tpu_torch

    register_ray_tpu_torch()
    jax_libs["joblib"].register_ray_tpu()
    outs = []
    for name in ("ray_tpu_torch", "ray_tpu"):
        with joblib.parallel_backend(name, n_jobs=2):
            outs.append(joblib.Parallel()(joblib.delayed(f)(*a) for f, a in calls))
    return outs


def test_joblib_backend(jax_libs):
    xs = _inputs(8, 12)
    port, ref = _joblib_both(jax_libs, [(operator.mul, (x, x)) for x in xs])
    assert port == ref == [x * x for x in xs]


def test_joblib_backend_sklearn_style(jax_libs):
    """The canonical use: CPU-heavy independent fits in parallel."""
    port, ref = _joblib_both(jax_libs, [(_fit_one, (s,)) for s in range(6)])
    assert port == ref and all(e < 1e-8 for e in port)


def test_joblib_backend_counts_cluster_cpus(jax_libs):
    """``n_jobs`` as the JAX backend reads it: positive counts as given,
    ``None`` as 1, and ``-1``/``-2`` as all the cluster's CPUs / all but
    one (the JAX backend's negative case would start a JAX head, so only
    the port's runs there)."""
    pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import RayTpuTorchBackend

    port, ref = RayTpuTorchBackend(), jax_libs["joblib"].RayTpuBackend()
    assert [port.effective_n_jobs(n) for n in (None, 1, 3)] \
        == [ref.effective_n_jobs(n) for n in (None, 1, 3)] == [1, 1, 3]
    cpus = int(rt.cluster_resources()["CPU"])
    assert [port.effective_n_jobs(n) for n in (-1, -2)] == [cpus, cpus - 1] == [4, 3]
    for backend in (port, ref):
        with pytest.raises(ValueError):
            backend.effective_n_jobs(0)


# -- pubsub and the card grant ----------------------------------------------

@rt.remote
class _Publisher:
    def run(self, channel, tag, n):
        from ray_tpu_torch.util import pubsub as ps

        for i in range(n):
            ps.publish(channel, (tag, i))
        return n


def test_pubsub_delivers_every_message_in_order_per_publisher(jax_libs):
    """Two actors publish 20 messages each on a channel the driver
    subscribed to: all 40 arrive once, in each publisher's order; the
    JAX package's thin layer over the same client delivers the same."""
    outs = []
    for mod, channel in ((pubsub, "port-chan"), (jax_libs["pubsub"], "jax-chan")):
        got, done = [], threading.Event()

        def on(msg, got=got, done=done):
            got.append(tuple(msg))
            if len(got) == 40:
                done.set()

        mod.subscribe(channel, on)
        pubs = [_Publisher.remote() for _ in range(2)]
        assert rt.get([p.run.remote(channel, t, 20) for p, t in zip(pubs, "ab")],
                      timeout=T) == [20, 20]
        assert done.wait(T), len(got)
        time.sleep(0.3)  # nothing more arrives
        mod.unsubscribe(channel, on)
        outs.append(({t: [i for tt, i in got if tt == t] for t in "ab"}, len(got)))
    want = ({"a": list(range(20)), "b": list(range(20))}, 40)
    assert outs[0] == outs[1] == want


def test_pool_and_queue_on_half_card_grants(jax_libs):
    """An ``ActorPool`` over two ``num_gpus=0.5`` actors and a ``Queue``
    whose actor holds half a card: the grants name card ids, the map
    equals the JAX pool's over the same actors, and the queue's card
    share comes back when it shuts down."""
    xs = _inputs(9, 12)
    actors = [Doubler.options(num_gpus=0.5).remote() for _ in range(2)]
    grants = rt.get([a.grant.remote() for a in actors], timeout=T)
    assert all(g in ("0", "1") for g in grants), grants
    port, ref = _both(jax_libs, lambda cls: list(
        cls(actors).map(lambda a, x: a.double.remote(x), xs)))
    assert port == ref == [2 * x for x in xs]
    for a in actors:
        rt.kill(a)
    q = Queue(maxsize=4, actor_options={"num_gpus": 0.5})
    q.put_nowait_batch(xs[:4])
    assert _outcome(q.put_nowait, 0) == "Full"
    assert q.get_nowait_batch(10) == xs[:4]
    q.shutdown()
    deadline = time.monotonic() + T
    while rt.available_resources().get("GPU") != 2.0 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert rt.available_resources().get("GPU") == 2.0
