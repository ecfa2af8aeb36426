"""``ray_tpu_torch.util.collective`` on the CPU: the ``shm`` group over 2
actor ranks of the port's runtime, and the ``torch`` group over a 2-rank
gloo world (``parallel/spawn.py``), each op against numpy."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.parallel.spawn import run_world
from ray_tpu_torch.util import collective
from torch_world_cases import collective_group_inputs, collective_group_ops

WORLD = 2
T = 60


def _expected(inputs):
    x = np.stack([i["x"] for i in inputs])
    total = x.sum(0)
    return {
        "allreduce_sum": [total] * WORLD,
        "allreduce_mean": [x.mean(0)] * WORLD,
        "allreduce_max": [x.max(0)] * WORLD,
        "allreduce_min": [x.min(0)] * WORLD,
        "allgather": [x] * WORLD,
        # 5 rows over 2 ranks: 3 and 2, as np.array_split splits them
        "reducescatter": np.array_split(total, WORLD, axis=0),
        "broadcast": [inputs[1]["x"]] * WORLD,
        "recv": [inputs[1]["p2p"], inputs[0]["p2p"]],
    }


def _check(got_by_rank, inputs):
    for op, want in _expected(inputs).items():
        for rank in range(WORLD):
            np.testing.assert_allclose(got_by_rank[rank][op], want[rank], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{op} on rank {rank}")


@ray_tpu_torch.remote(num_cpus=1)
class _Rank:
    def join_collective_group(self, world_size, rank, group_name):
        collective.init_collective_group(world_size, rank, group_name=group_name)
        self.rank = rank
        return True

    def run(self, group_name):
        col = collective
        inp = collective_group_inputs(self.rank)
        assert col.get_group_backend(group_name) == "shm"
        out = {f"allreduce_{op}": col.allreduce(inp["x"], group_name, op=op)
               for op in ("sum", "mean", "max", "min")}
        out["allgather"] = np.stack(col.allgather(inp["x"], group_name))
        out["reducescatter"] = col.reducescatter(inp["x"], group_name)
        out["broadcast"] = col.broadcast(inp["x"], src_rank=1, group_name=group_name)
        other = 1 - self.rank
        col.send(inp["p2p"], other, group_name)
        out["recv"] = col.recv((2, 4), np.float32, other, group_name, timeout=T)
        col.barrier(group_name)
        return out


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_shm_group_over_two_actor_ranks(runtime):
    ranks = [_Rank.remote() for _ in range(WORLD)]
    try:
        collective.create_collective_group(ranks, WORLD, list(range(WORLD)), group_name="shm2")
        got = ray_tpu_torch.get([r.run.remote("shm2") for r in ranks], timeout=T)
        _check(got, [collective_group_inputs(r) for r in range(WORLD)])
    finally:
        for r in ranks:
            ray_tpu_torch.kill(r)


def test_torch_group_over_a_gloo_world():
    got = run_world(collective_group_ops, WORLD, device="cpu", deadline=120)
    _check(got, [collective_group_inputs(r) for r in range(WORLD)])
    # torch_utils.global_mesh: one "dp" axis over every rank of the world
    assert [g["global_mesh"] for g in got] == [(("dp",), (WORLD,))] * WORLD
    inputs = [collective_group_inputs(r) for r in range(WORLD)]
    for g in got:
        np.testing.assert_allclose(g["grads_w"], np.mean([i["x"] for i in inputs], 0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g["grads_b"], np.mean([i["p2p"] for i in inputs], 0),
                                   rtol=1e-6, atol=1e-6)
        assert g["grads_phases"] == ["collective", "other"]


def test_group_errors():
    with pytest.raises(ValueError, match="unknown collective backend"):
        collective.init_collective_group(2, 0, backend="xla", group_name="bad")
    with pytest.raises(RuntimeError, match="process group"):
        collective.init_collective_group(2, 0, backend="torch", group_name="bad")
    with pytest.raises(RuntimeError, match="not initialized"):
        collective.allreduce(np.zeros(2), group_name="never-joined")
