"""The port's autoscaler (``ray_tpu_torch/autoscaler/``): the demand-driven
``StandardAutoscaler`` under a ``Monitor`` over a ``LocalNodeProvider``
whose nodes are real node-agent processes.

``test_autoscaler_scales_up_and_down`` is the JAX package's
``tests/test_tooling.py`` case by name.  Then the GPU path: a head with no
card, an actor and a task that each ask for a card stay pending as demand
(nothing raises), the autoscaler launches one ``num_gpus: 1`` agent, both
run there on card 0, and the idle node is reaped.  Its idle timeout is
shorter than an agent takes to join, which also holds the fix that a
launching node is not idle (ROADMAP C).  The bin-pack's demand counts are
held to the JAX package's for the same pending shapes.

Each test has its own time limit (``LIMIT_S``); no JAX head starts.
"""

import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.autoscaler import LocalNodeProvider, Monitor, StandardAutoscaler
from ray_tpu_torch.autoscaler.autoscaler import AutoscalingConfig

LIMIT_S = 180


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail the test (SIGALRM in the main thread) past ``LIMIT_S``."""
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.2)


def test_autoscaler_scales_up_and_down():
    """Unmet demand launches real node_agent workers; idle nodes reap."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    head = global_worker.node
    provider = LocalNodeProvider(head)
    scaler = StandardAutoscaler(
        head, provider,
        AutoscalingConfig(min_workers=0, max_workers=2, idle_timeout_s=3.0,
                          worker_node={"num_cpus": 4}),
    )
    monitor = Monitor(scaler, interval_s=0.5).start()
    try:
        # head has 4 CPUs; each task wants 3, so only one fits at a time —
        # the queued remainder is unmet demand the autoscaler must absorb
        @ray_tpu_torch.remote(num_cpus=3)
        def heavy(i):
            time.sleep(3.0)
            return i

        refs = [heavy.remote(i) for i in range(4)]  # 12 CPUs of demand
        _wait(provider.non_terminated_nodes, 60, "a launched node")
        assert sorted(ray_tpu_torch.get(refs, timeout=120)) == [0, 1, 2, 3]

        # idle nodes terminate after the timeout
        _wait(lambda: not provider.non_terminated_nodes(), 60, "the idle nodes' reaping")
    finally:
        monitor.stop()
        provider.shutdown()
        ray_tpu_torch.shutdown()


def test_gpu_demand_launches_a_card_node_then_reaps_it():
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    head = global_worker.node
    provider = LocalNodeProvider(head)
    scaler = StandardAutoscaler(
        head, provider,
        AutoscalingConfig(min_workers=0, max_workers=1, idle_timeout_s=0.5,
                          worker_node={"num_cpus": 2, "num_gpus": 1}))
    try:
        @ray_tpu_torch.remote(num_gpus=0.5)
        class Half:
            def place(self):
                import os

                return (ray_tpu_torch.get_runtime_context().node_id,
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        @ray_tpu_torch.remote(num_gpus=0.5)
        def task():
            import os

            return (ray_tpu_torch.get_runtime_context().node_id,
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        actor = Half.remote()
        place_ref, task_ref = actor.place.remote(), task.remote()
        # no card anywhere: both wait as demand, nothing raises
        ready, _ = ray_tpu_torch.wait([place_ref, task_ref], num_returns=2, timeout=1.0)
        assert not ready
        unmet = scaler.pending_demand()
        assert sorted(d.get("GPU") for d in unmet) == [0.5, 0.5], unmet
        monitor = Monitor(scaler, interval_s=0.2).start()
        try:
            (agent, grant_a), (where_t, grant_t) = ray_tpu_torch.get(
                [place_ref, task_ref], timeout=120)
            # one node, launched once: the 0.5 s idle clock did not start
            # while its agent was still booting
            assert sorted(provider.procs) == [agent] == provider.non_terminated_nodes()
            assert (where_t, grant_a, grant_t) == (agent, "0", "0")
            assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
            ray_tpu_torch.kill(actor)
            _wait(lambda: not provider.non_terminated_nodes()
                  and not ray_tpu_torch.cluster_resources().get("GPU", 0),
                  60, "the idle card node's reaping")
            assert sorted(provider.procs) == []
        finally:
            monitor.stop()
    finally:
        provider.shutdown()
        ray_tpu_torch.shutdown()


def test_bin_pack_of_gpu_demand_matches_the_jax_package():
    """The same unmet demand through both packages' ``update()`` on a
    stand-in head with no node: the port launches as many card nodes for
    ``"GPU"`` shapes as the JAX package does for ``"TPU"`` ones."""
    import threading
    from collections import deque

    from ray_tpu.autoscaler.autoscaler import AutoscalingConfig as JaxConfig
    from ray_tpu.autoscaler.autoscaler import StandardAutoscaler as JaxScaler

    class Head:
        def __init__(self, key, shapes):
            self.lock = threading.Lock()
            self.nodes, self.workers, self.actors = {}, {}, {}
            self.pending_tasks = deque({"resources": {"CPU": 1.0, key: g}} for g in shapes)

    class Provider:
        def __init__(self):
            self.launched = []

        def non_terminated_nodes(self):
            return []

        def create_node(self, node_config, count):
            self.launched.append((dict(node_config), count))
            return [f"n{i}" for i in range(count)]

    shapes = [1.0, 0.5, 0.5, 1.0, 0.25]
    got = {}
    for name, scaler_cls, cfg_cls, key, gpu_arg in (
            ("jax", JaxScaler, JaxConfig, "TPU", "num_tpus"),
            ("port", StandardAutoscaler, AutoscalingConfig, "GPU", "num_gpus")):
        provider = Provider()
        scaler_cls(Head(key, shapes), provider, cfg_cls(
            max_workers=8, upscaling_speed=8,
            worker_node={"num_cpus": 4, gpu_arg: 1})).update()
        got[name] = [count for _, count in provider.launched]
    # first fit in arrival order: 1 | 0.5 0.5 | 1 | 0.25
    assert got["port"] == got["jax"] == [4]
