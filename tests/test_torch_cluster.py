"""The port's multi-node runtime: node agents over TCP, object transfer
between nodes, ``cluster_utils.Cluster`` in both modes and the chaos
``WorkerKiller``.

The five real-process cases mirror the JAX package's
``tests/test_real_cluster.py`` by name: a second node is a real agent
process (``ray_tpu_torch._private.node_agent``) that registers over TCP,
spawns its own workers and serves object pulls from a private shm
directory, so any cross-node read went through the transfer plane.  Then
the emulated mode (node states inside the head), an agent that holds a
card (``--num-gpus 1``) on a CPU host, whose workers see their grant as
``CUDA_VISIBLE_DEVICES`` without touching CUDA, and
``test_chaos.py::test_tasks_survive_worker_kills`` on ``WorkerKiller``.

Each test has its own time limit (``LIMIT_S``); no JAX head starts.
"""

import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private.test_utils import WorkerKiller
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

LIMIT_S = {"test_cross_node_object_transfer": 180, "test_node_death_retries_elsewhere": 180,
           "test_tasks_survive_worker_kills": 180}


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail the test (SIGALRM in the main thread) once it runs past its
    limit: 120 s unless ``LIMIT_S`` names another."""
    limit = LIMIT_S.get(request.node.name, 120)

    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture
def real_cluster():
    cluster = Cluster(
        initialize_head=True,
        head_node_args={"num_cpus": 2, "num_gpus": 0},
        real_processes=True,
    )
    yield cluster
    cluster.shutdown()


def test_remote_node_runs_tasks(real_cluster):
    node_b = real_cluster.add_node(num_cpus=2)

    @ray_tpu_torch.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(node_b))
    def where():
        import os

        return ray_tpu_torch.get_runtime_context().node_id, os.getpid()

    nid, pid = ray_tpu_torch.get(where.remote(), timeout=120)
    assert nid == node_b
    # the worker is a real separate process on "node b"
    assert pid != os.getpid()
    assert pid not in {p.pid for p in real_cluster.agents.values()}


def test_cross_node_object_transfer(real_cluster):
    """An array produced on node B is pulled to the driver, and a
    driver-put array is pulled by node B — both through the object plane
    (disjoint shm namespaces make an accidental local attach impossible)."""
    node_b = real_cluster.add_node(num_cpus=2)
    to_b = NodeAffinitySchedulingStrategy(node_b)

    @ray_tpu_torch.remote(scheduling_strategy=to_b)
    def produce(n):
        return np.arange(n, dtype=np.float32)

    # B -> driver
    n = (64 << 20) // 4  # 64 MiB
    arr = ray_tpu_torch.get(produce.remote(n), timeout=120)
    assert arr.shape == (n,) and float(arr[-1]) == n - 1

    # driver -> B
    payload = np.random.default_rng(0).standard_normal(1 << 20)
    big = ray_tpu_torch.put(payload)

    @ray_tpu_torch.remote(scheduling_strategy=to_b)
    def checksum(x):
        return float(np.sum(x))

    assert ray_tpu_torch.get(checksum.remote(big), timeout=120) == pytest.approx(
        float(np.sum(payload)))

    # B -> B (second task on same node reuses the local segment)
    assert ray_tpu_torch.get(checksum.options(scheduling_strategy=to_b).remote(big),
                             timeout=120) == pytest.approx(float(np.sum(payload)))
    # the agent's segments live in its own directory, with the port's prefix
    shm_dir = real_cluster._agent_dirs[0]
    assert os.path.basename(shm_dir).startswith(f"rtpt-{node_b}-")


def test_actor_on_remote_node(real_cluster):
    node_b = real_cluster.add_node(num_cpus=2)

    @ray_tpu_torch.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(node_b))
    class Counter:
        def __init__(self):
            self.x = 0

        def incr(self):
            self.x += 1
            return self.x

        def node(self):
            return ray_tpu_torch.get_runtime_context().node_id

    c = Counter.remote()
    assert ray_tpu_torch.get(c.node.remote(), timeout=120) == node_b
    assert [ray_tpu_torch.get(c.incr.remote(), timeout=60) for _ in range(3)] == [1, 2, 3]


def test_node_death_retries_elsewhere(real_cluster):
    """SIGKILL the agent: tasks retried on surviving nodes; node marked
    dead (the chaos NodeKiller scenario over a real process boundary)."""
    node_b = real_cluster.add_node(num_cpus=2)

    @ray_tpu_torch.remote(max_retries=4)
    def slow(i):
        time.sleep(0.4)
        return i

    refs = [slow.remote(i) for i in range(8)]
    time.sleep(0.6)  # let some tasks land on node b
    real_cluster.remove_node(node_b)  # SIGKILL agent + wait for head to notice
    assert ray_tpu_torch.get(refs, timeout=120) == list(range(8))

    node = global_worker.node
    with node.lock:
        assert not node.nodes[node_b].alive


def test_spread_across_real_nodes(real_cluster):
    real_cluster.add_node(num_cpus=2)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        time.sleep(0.3)
        return ray_tpu_torch.get_runtime_context().node_id

    nodes = set(ray_tpu_torch.get([where.remote() for _ in range(8)], timeout=120))
    assert len(nodes) == 2, f"tasks never spread: {nodes}"


def test_agent_with_a_card_grants_it_without_touching_cuda(real_cluster):
    """An agent registered with ``--num-gpus 1`` on a host with no card:
    the head counts its GPU, a ``num_gpus=1`` task and actor land there and
    see ``CUDA_VISIBLE_DEVICES == "0"``; a task granted no card on that node
    sees none (the agent's own value never reaches it); and no process
    made a CUDA context (the grants are env vars only)."""
    node_b = real_cluster.add_node(num_cpus=2, num_gpus=1)
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0

    @ray_tpu_torch.remote(num_gpus=1)
    def granted():
        import os
        import sys

        return (ray_tpu_torch.get_runtime_context().node_id,
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_runtime_context().get_gpu_ids(),
                "torch" in sys.modules and sys.modules["torch"].cuda.is_initialized())

    @ray_tpu_torch.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(node_b))
    def bare():
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def grant(self):
            import os

            return (ray_tpu_torch.get_runtime_context().node_id,
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    assert ray_tpu_torch.get(granted.remote(), timeout=120) == (node_b, "0", [0], False)
    assert ray_tpu_torch.get(bare.remote(), timeout=120) == ""
    h = Holder.remote()
    assert ray_tpu_torch.get(h.grant.remote(), timeout=120) == (node_b, "0")
    assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
    ray_tpu_torch.kill(h)


def test_emulated_nodes_share_the_heads_process():
    """The default mode: node states inside the head, with their own
    CPUs and cards; tasks pinned to one run there, and a removed node's
    resources leave the cluster."""
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1, "num_gpus": 0})
    try:
        n1 = cluster.add_node(num_cpus=2, num_gpus=2)
        assert not cluster.agents
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0

        @ray_tpu_torch.remote(num_gpus=1)
        def where():
            import os

            return (ray_tpu_torch.get_runtime_context().node_id,
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        got = ray_tpu_torch.get([where.remote() for _ in range(2)], timeout=120)
        assert {g[0] for g in got} == {n1}
        assert {g[1] for g in got} <= {"0", "1"}
        cluster.remove_node(n1)
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    finally:
        cluster.shutdown()


def test_tasks_survive_worker_kills():
    """``test_chaos.py`` by name: slow tasks with retries complete while
    ``WorkerKiller`` SIGKILLs busy workers on an interval."""
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote(max_retries=10)
        def slow_square(i):
            time.sleep(0.3)
            return i * i

        killer = WorkerKiller(interval_s=0.4, include_actor_workers=False, seed=0).start()
        try:
            out = ray_tpu_torch.get([slow_square.remote(i) for i in range(24)], timeout=150)
        finally:
            killer.stop()
        assert out == [i * i for i in range(24)]
        assert killer.kills > 0, "chaos test never killed anything"
    finally:
        ray_tpu_torch.shutdown()
