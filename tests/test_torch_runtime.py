"""The port's runtime core on the CPU: tasks, actors, objects, and the GPU
as a resource (fake cards: the grants are environment variables only, as
the JAX package's ``ray_start_2_tpus`` does with chips).

One runtime serves the module (``init(num_cpus=4, num_gpus=2)``); every
wait has a timeout."""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import resource_spec
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

T = 60  # seconds: every get/wait in this file


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield global_worker.node
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _double(x):
    return x * 2


@ray_tpu_torch.remote(num_gpus=1)
class _GpuActor:
    def grant(self):
        from ray_tpu_torch import get_runtime_context

        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                get_runtime_context().get_gpu_ids())


@ray_tpu_torch.remote
class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n


def test_tasks_objects_and_wait(runtime):
    assert ray_tpu_torch.get(_double.remote(21), timeout=T) == 42
    assert ray_tpu_torch.get([_double.remote(i) for i in range(5)], timeout=T) == [0, 2, 4, 6, 8]
    big = np.arange(1 << 18, dtype=np.float32)  # past the inline limit: the object store
    ref = ray_tpu_torch.put(big)
    np.testing.assert_array_equal(ray_tpu_torch.get(ref, timeout=T), big)
    np.testing.assert_array_equal(ray_tpu_torch.get(_double.remote(ref), timeout=T), 2 * big)
    refs = [_double.remote(i) for i in range(3)]
    ready, rest = ray_tpu_torch.wait(refs, num_returns=3, timeout=T)
    assert len(ready) == 3 and not rest


def test_actors_state_and_kill(runtime):
    c = _Counter.remote(10)
    assert ray_tpu_torch.get([c.add.remote(1), c.add.remote(2)], timeout=T) == [11, 13]
    ray_tpu_torch.kill(c)
    with pytest.raises(ray_tpu_torch.exceptions.RayActorError):
        ray_tpu_torch.get(c.add.remote(1), timeout=T)
    named = _Counter.options(name="counter").remote(0)
    assert ray_tpu_torch.get(ray_tpu_torch.get_actor("counter").add.remote(5), timeout=T) == 5
    ray_tpu_torch.kill(named)


def test_gpu_grants_are_disjoint_pend_and_are_released(runtime):
    a, b = _GpuActor.remote(), _GpuActor.remote()
    grants = ray_tpu_torch.get([a.grant.remote(), b.grant.remote()], timeout=T)
    assert sorted(grants) == [("0", [0]), ("1", [1])]
    c = _GpuActor.remote()
    pending = c.grant.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3)
    assert not ready  # both cards are held
    freed = dict((v[0], h) for v, h in zip(grants, (a, b)))["0"]
    ray_tpu_torch.kill(freed)
    assert ray_tpu_torch.get(pending, timeout=T) == ("0", [0])  # card 0 came back
    for h in (a, b, c):
        ray_tpu_torch.kill(h)


def test_tasks_get_per_task_grants(runtime):
    @ray_tpu_torch.remote(num_gpus=1)
    def on_card():
        from ray_tpu_torch import get_runtime_context

        return os.environ["CUDA_VISIBLE_DEVICES"], get_runtime_context().get_gpu_ids()

    @ray_tpu_torch.remote
    def off_card():
        from ray_tpu_torch import get_runtime_context

        return os.environ["CUDA_VISIBLE_DEVICES"], get_runtime_context().get_gpu_ids()

    vis, ids = ray_tpu_torch.get(on_card.remote(), timeout=T)
    assert len(ids) == 1 and vis == str(ids[0])
    assert ray_tpu_torch.get(off_card.remote(), timeout=T) == ("", [])
    assert ray_tpu_torch.get_runtime_context().get_gpu_ids() == []  # the driver holds none
    with pytest.raises(ValueError, match="whole number"):
        on_card.options(num_gpus=1.5).remote()


def test_two_half_card_actors_share_card_zero(runtime):
    a, b = (_GpuActor.options(num_gpus=0.5).remote() for _ in range(2))
    try:
        grants = ray_tpu_torch.get([a.grant.remote(), b.grant.remote()], timeout=T)
        assert grants == [("0", [0]), ("0", [0])]
    finally:
        for h in (a, b):
            ray_tpu_torch.kill(h)


def test_a_full_card_waits_for_shares_and_a_whole_actor_takes_the_other(runtime):
    a, b = (_GpuActor.options(num_gpus=0.5).remote() for _ in range(2))
    whole = _GpuActor.remote()
    third = _GpuActor.options(num_gpus=0.5).remote()
    try:
        assert ray_tpu_torch.get([a.grant.remote(), b.grant.remote()], timeout=T) == [
            ("0", [0]), ("0", [0])]
        assert ray_tpu_torch.get(whole.grant.remote(), timeout=T) == ("1", [1])
        pending = third.grant.remote()
        ready, _ = ray_tpu_torch.wait([pending], timeout=3)
        assert not ready  # card 0 is shared out in full and card 1 is held whole
        ray_tpu_torch.kill(a)
        assert ray_tpu_torch.get(pending, timeout=T) == ("0", [0])
    finally:
        for h in (a, b, whole, third):
            ray_tpu_torch.kill(h)


def test_fractional_tasks_get_a_card_id_and_non_whole_counts_above_one_raise(runtime):
    @ray_tpu_torch.remote(num_gpus=0.25)
    def share():
        from ray_tpu_torch import get_runtime_context

        return os.environ["CUDA_VISIBLE_DEVICES"], get_runtime_context().get_gpu_ids()

    results = ray_tpu_torch.get([share.remote() for _ in range(4)], timeout=T)
    for vis, ids in results:
        assert len(ids) == 1 and ids[0] in (0, 1) and vis == str(ids[0])
    for bad in (1.5, 2.25):
        with pytest.raises(ValueError, match="whole number"):
            _GpuActor.options(num_gpus=bad).remote()
    both = _GpuActor.options(num_gpus=2).remote()
    try:
        assert ray_tpu_torch.get(both.grant.remote(), timeout=T) == ("0,1", [0, 1])
    finally:
        ray_tpu_torch.kill(both)


@ray_tpu_torch.remote(num_gpus=1)
class _FailingGpuActor:
    def __init__(self):
        raise ValueError("no model here")

    def ping(self):
        return "pong"


def test_an_actor_whose_constructor_raises_fails_its_calls_and_frees_its_card(runtime):
    """Calls queued behind a failed constructor raise (a Data pool whose
    predictor cannot load fails its stream instead of hanging), later calls
    raise, and the worker ends, so its card returns to the head."""
    from ray_tpu_torch.exceptions import RayActorError

    a = _FailingGpuActor.remote()
    with pytest.raises(RayActorError, match="creation failed: ValueError: no model here"):
        ray_tpu_torch.get(a.ping.remote(), timeout=T)
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(a.ping.remote(), timeout=T)
    deadline = time.time() + T
    while ray_tpu_torch.available_resources().get("GPU") != 2.0 and time.time() < deadline:
        time.sleep(0.05)
    assert ray_tpu_torch.available_resources().get("GPU") == 2.0


def test_placement_group_bundles_hold_gpus(runtime):
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    pg = placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}], strategy="PACK")
    ray_tpu_torch.get(pg.ready(), timeout=T)
    try:
        actors = [_GpuActor.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote() for i in range(2)]
        grants = ray_tpu_torch.get([x.grant.remote() for x in actors], timeout=T)
        assert sorted(g[1] for g in grants) == [[0], [1]]
        for x in actors:
            ray_tpu_torch.kill(x)
    finally:
        remove_placement_group(pg)


def test_workers_fork_from_a_template_that_never_touched_cuda(runtime):
    @ray_tpu_torch.remote
    def cuda_state():
        import sys

        import torch

        return "torch" in sys.modules, torch.cuda.is_initialized()

    assert ray_tpu_torch.get(cuda_state.remote(), timeout=T) == (True, False)


def test_runs_beside_the_jax_packages_runtime(runtime):
    """The two runtimes can never meet on one machine: the port keeps its
    session directory (and the forkserver socket in it) outside the JAX
    package's fixed ``/tmp/ray_tpu``, prefixes its ``/dev/shm`` segments
    ``rtpt`` where the JAX package uses ``rtpu``, and reads and exports
    only ``RAY_TPU_TORCH_*`` variables.  Nothing here starts the JAX
    package's head, which writes a fixed path outside any checkout."""
    import re

    from ray_tpu._private import shm as jax_shm
    from ray_tpu._private.config import get_config as jax_config
    from ray_tpu_torch._private import shm
    from ray_tpu_torch._private.config import get_config, session_root

    jax_root = "/tmp/ray_tpu"  # ray_tpu/_private/node.py: sessions and last_session.json
    assert os.path.commonpath([session_root(), jax_root]) != jax_root
    assert os.path.dirname(runtime.session_dir) == session_root()
    assert os.path.dirname(runtime._forkserver._sock_path) == runtime.session_dir
    assert (jax_config().shm_prefix, get_config().shm_prefix) == ("rtpu", "rtpt")
    assert (jax_shm._SESSION_ENV, shm._SESSION_ENV) == ("RAY_TPU_SESSION", "RAY_TPU_TORCH_SESSION")
    assert os.environ["RAY_TPU_TORCH_SESSION"] == runtime.session_id
    # the live session's segments carry the port's prefix
    ref = ray_tpu_torch.put(np.zeros(1 << 18, np.float32))
    ours = [f for f in os.listdir(shm.shm_dir()) if runtime.session_id in f]
    assert ours and all(f.startswith("rtpt-") for f in ours)
    del ref
    # no variable of the JAX package's runtime is read or set by the port
    root = os.path.dirname(ray_tpu_torch.__file__)
    foreign = {m for d, _, files in os.walk(root) for f in files if f.endswith(".py")
               for m in re.findall(r"RAY_TPU_(?!TORCH_)[A-Z_]+", open(os.path.join(d, f)).read())}
    assert not foreign, foreign


def test_autodetect_gpus_reads_visible_devices_without_a_context(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert resource_spec.autodetect_gpus() == (2, [2, 3])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,-1,3")  # CUDA stops at -1
    assert resource_spec.autodetect_gpus() == (1, [1])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert resource_spec.autodetect_gpus() == (0, [])
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(resource_spec, "_nvidia_smi_count", lambda: 4)
    assert resource_spec.autodetect_gpus() == (4, [0, 1, 2, 3])
    total, ids = resource_spec.autodetect_resources(2, None, {"x": 1.0})
    assert (total["CPU"], total["GPU"], total["x"], ids) == (2.0, 4.0, 1.0, [0, 1, 2, 3])
