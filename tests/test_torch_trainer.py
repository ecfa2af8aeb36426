"""The port's Train layer on its own runtime, on the CPU: ``WorkerGroup``,
``TorchTrainer`` with 2 gloo/``shm`` ranks held to the JAX package's math,
checkpoint ranking, a whole-gang restart, and a cluster with no GPU.

One runtime serves the module (``init(num_cpus=4, num_gpus=0)``); the
JAX reference math runs in this process on the CPU."""

import os

import jax
import numpy as np
import optax
import pytest

import ray_tpu_torch
from ray_tpu.models import mlp as jax_mlp
from ray_tpu_torch.air import Checkpoint, CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train import TorchConfig, TorchTrainer, WorkerGroup

CFG = jax_mlp.MLPConfig(in_dim=8, hidden=(16,), num_classes=2)
STEPS = 6


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def _rank_batch(rank):
    rng = np.random.default_rng(rank)  # each rank draws its own shard
    x = np.asarray(rng.normal(size=(64, 8)), np.float32)
    return {"x": x, "y": (x.sum(-1) > 0).astype(np.int32)}


def _train_loop(config):
    """``tests/test_train.py``'s loop in the port: SGD(0.5) on the MLP,
    gradients mean-all-reduced over the gang in one round a step."""
    import numpy as np
    import torch

    from ray_tpu_torch import convert
    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.util import collective

    dev = torch_utils.get_device("cpu")
    torch.set_num_threads(1)
    cfg = mlp.MLPConfig(in_dim=8, hidden=(16,), num_classes=2)
    params = convert.from_jax_params(config["init"], device=dev)
    rank = session.get_world_rank()
    assert session.get_world_size() == config["num_workers"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in config["batches"][rank].items()}
    losses = []
    for step in range(config["steps"]):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = mlp.loss_fn(leaves, batch, cfg)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        grads = torch_utils.allreduce_grads(grads)
        params = {k: leaves[k].detach() - 0.5 * grads[k] for k in params}
        # CPU ranks under the default TorchConfig: the shm group
        assert collective.get_group_backend(os.environ["RAY_TRAIN_COLLECTIVE_GROUP"]) == "shm"
        losses.append(float(loss))
        session.report({"loss": losses[-1], "step": step})
    session.report(
        {"loss": losses[-1], "final": True, "rank": rank},
        checkpoint=Checkpoint.from_dict(
            {"params": {k: v.numpy() for k, v in params.items()},
             "rank": rank, "losses": losses}))


def _jax_reference(init, batches, steps):
    """The JAX package's math: per-rank ``value_and_grad`` of its
    ``mlp.loss_fn``, the mean over ranks, ``optax.sgd(0.5)``."""
    params = jax.tree.map(jax.numpy.asarray, init)
    opt = optax.sgd(0.5)
    opt_state = opt.init(params)
    grad_fn = jax.jit(lambda p, b: jax.value_and_grad(jax_mlp.loss_fn)(p, b, CFG))
    losses = [[] for _ in batches]
    for _ in range(steps):
        outs = [grad_fn(params, b) for b in batches]
        for r, (loss, _) in enumerate(outs):
            losses[r].append(float(loss))
        grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in outs])
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params), losses


def test_worker_group_execute(runtime):
    wg = WorkerGroup(2, {"CPU": 1.0})
    try:
        assert wg.execute(lambda: 7) == [7, 7]
        assert wg.execute_single(1, lambda x: x * 2, 21) == 42
        # CPU ranks see no card: CUDA_VISIBLE_DEVICES is their (empty) grant
        assert wg.execute(lambda: os.environ.get("CUDA_VISIBLE_DEVICES")) == ["", ""]
    finally:
        wg.shutdown()


def test_torch_trainer_matches_the_jax_math(runtime, tmp_path):
    init = jax.tree.map(np.asarray, jax_mlp.init(CFG, jax.random.PRNGKey(0)))
    batches = [_rank_batch(r) for r in range(2)]
    trainer = TorchTrainer(
        _train_loop,
        train_loop_config={"steps": STEPS, "num_workers": 2, "init": init,
                           "batches": batches},
        torch_config=TorchConfig(),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="dp", storage_path=str(tmp_path),
                             checkpoint_config=CheckpointConfig(num_to_keep=2)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["final"] is True
    want_params, want_losses = _jax_reference(init, batches, STEPS)
    states = {c.to_dict()["rank"]: c.to_dict() for c in result.best_checkpoints}
    assert sorted(states) == [0, 1]
    for rank, state in states.items():
        np.testing.assert_allclose(state["losses"], want_losses[rank], rtol=0, atol=1e-5)
        for k, v in want_params.items():
            np.testing.assert_allclose(state["params"][k], v, rtol=0, atol=1e-5)
    assert want_losses[0][-1] < want_losses[0][0]


def _ranked_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint

    for step, score in enumerate(config["scores"]):
        session.report({"score": score, "step": step},
                       checkpoint=Checkpoint.from_dict({"step": step}))


def test_checkpoints_ranked_and_two_kept(runtime, tmp_path):
    result = TorchTrainer(
        _ranked_loop, train_loop_config={"scores": [3.0, 9.0, 1.0, 7.0, 5.0]},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(
            name="ranked", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score")),
    ).fit()
    assert result.error is None
    assert [c.to_dict()["step"] for c in result.best_checkpoints] == [1, 3]
    assert result.checkpoint.to_dict()["step"] == 1
    kept = sorted(p for p in os.listdir(tmp_path / "ranked") if p.startswith("checkpoint_"))
    assert kept == ["checkpoint_000001", "checkpoint_000003"]
    # the object-store forms of a checkpoint go through put/get
    ref = Checkpoint.from_dict({"a": np.arange(3)}).to_object_ref()
    np.testing.assert_array_equal(Checkpoint.from_object_ref(ref).to_dict()["a"], np.arange(3))


def _flaky_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint

    start = session.get_checkpoint()
    step0 = start.to_dict()["step"] + 1 if start is not None else 0
    marker = config["marker"]
    for step in range(step0, 4):
        if step == 2 and session.get_world_rank() == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("rank 1 fails once")
        session.report({"step": step, "resumed_from": step0},
                       checkpoint=Checkpoint.from_dict({"step": step}))


def test_whole_gang_restarts_once_from_the_last_checkpoint(runtime, tmp_path):
    result = TorchTrainer(
        _flaky_loop, train_loop_config={"marker": str(tmp_path / "failed_once")},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="flaky", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    assert result.metrics["resumed_from"] > 0  # the second gang resumed
    assert (tmp_path / "failed_once").exists()


@pytest.mark.parametrize("asked, resources, want", [
    (None, {"CPU": 1.0, "GPU": 1.0}, True),   # GPU workers: NCCL by default
    (None, {"CPU": 1.0}, False),              # CPU ranks: the shm group
    (False, {"CPU": 1.0, "GPU": 1.0}, False),
    (True, {"CPU": 1.0}, True),               # a gloo world
])
def test_the_collective_group_follows_the_grant(asked, resources, want):
    from ray_tpu_torch.train.backend import _uses_torch_group

    assert _uses_torch_group(TorchConfig(use_torch_distributed=asked), resources) is want


def test_use_gpu_on_a_cluster_without_gpus_raises_at_once(runtime):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="0 GPU"):
        TorchTrainer(lambda: None, scaling_config=ScalingConfig(num_workers=1)).fit()
    assert time.monotonic() - t0 < 10
    # datasets= is taken now (Data is ported); the gang still fails at once
    with pytest.raises(RuntimeError, match="0 GPU"):
        TorchTrainer(lambda: None, datasets={"train": [1, 2]},
                     scaling_config=ScalingConfig(num_workers=1)).fit()


def test_worker_without_a_grant_refuses_the_card(runtime):
    from ray_tpu_torch.train import torch_utils

    def probe():
        try:
            torch_utils.get_device()
        except RuntimeError as e:
            return str(e)
        return "no error"

    wg = WorkerGroup(1, {"CPU": 1.0})
    try:
        assert "holds no GPU" in wg.execute_single(0, probe)
        assert wg.execute_single(0, lambda: str(torch_utils.get_device("cpu"))) == "cpu"
    finally:
        wg.shutdown()


def test_shard_batch_slices_the_leading_axis_by_rank():
    import torch

    from ray_tpu_torch.train import torch_utils

    batch = {"x": torch.arange(12).reshape(6, 2), "y": [np.arange(6), torch.arange(6)]}
    parts = [torch_utils.shard_batch(batch, rank=r, world_size=3) for r in range(3)]
    assert [p["x"].tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                                [[8, 9], [10, 11]]]
    assert [p["y"][0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert parts[2]["y"][1].tolist() == [4, 5]
