"""``BatchPredictor`` and ``TorchTrainer(datasets=...)`` on the port's
runtime, on the CPU, against the JAX package's math.

- ``BatchPredictor(TorchPredictor)`` over a two-layer, narrow BERT in f32
  (``device="cpu"``), from a dict checkpoint and from a directory one,
  against ``JaxPredictor.predict`` in this process on the same batches:
  logits within 1e-5 (absolute and relative), labels equal; feature and
  kept columns; two actors at ``num_gpus_per_worker=0.5`` share fake
  card 0 and give it back.
- ``TorchTrainer(datasets={"train": ...})`` with a tiny GPT-2: the worker
  reads its batches from ``session.get_dataset_shard("train")``; its losses
  equal the port's own step in this process over the same rows bit for
  bit (one torch thread on both sides), and the first equals the JAX
  package's ``make_train_step`` within 1e-5.

One runtime serves the module (``init(num_cpus=4, num_gpus=2)``, fake
cards); the JAX package is imported inside the tests, so the workers that
import this module never load it; no JAX head is started."""

import functools
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.air import Checkpoint, ScalingConfig
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.train import BatchPredictor, TorchConfig, TorchPredictor, TorchTrainer

T = 120
TOL = 1e-5
N_ROWS, SEQ, BLOCKS, BATCH = 20, 24, 4, 4
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
GPT_B, GPT_T, GPT_STEPS = 2, 16, 3


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


def _bert():
    """The JAX package's tiny BERT (2 layers, width 64) in f32: its config,
    numpy params, the port's config, and the token rows."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import bert as jbert

    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jbert.init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (N_ROWS, SEQ)).astype(np.int32)
    return jcfg, params, tbert.BertConfig.tiny(dtype=torch.float32), toks


def _jax_logits(jcfg, params, toks):
    """JaxPredictor over the batches the pool sees: each block of
    ``N_ROWS / BLOCKS`` rows cut into batches of ``BATCH``."""
    import jax.numpy as jnp

    from ray_tpu.air import Checkpoint as JaxCheckpoint
    from ray_tpu.models import bert as jbert
    from ray_tpu.train.predictor import JaxPredictor

    pred = JaxPredictor.from_checkpoint(JaxCheckpoint.from_dict({"params": params}),
                                        lambda p, t: jbert.apply(p, t, jcfg))
    per = N_ROWS // BLOCKS
    out = []
    for lo in range(0, N_ROWS, per):
        block = toks[lo:lo + per]
        out += [pred.predict(jnp.asarray(block[i:i + BATCH])) for i in range(0, per, BATCH)]
    return np.concatenate(out)


def _wait_for_cards(n):
    import time

    deadline = time.time() + 30
    while ray_tpu_torch.available_resources().get("GPU") != n and time.time() < deadline:
        time.sleep(0.1)
    return ray_tpu_torch.available_resources().get("GPU")


@pytest.mark.parametrize("form", ["dict", "directory"])
def test_batch_predictor_matches_jax_predictor_on_bert(runtime, tmp_path, form):
    """Two actors at half a card each score the rows; the checkpoint
    crosses to them as its data or as its path."""
    from ray_tpu.air import Checkpoint as JaxCheckpoint

    jcfg, params, tcfg, toks = _bert()
    tbert.check_tokens(toks, tcfg)
    if form == "dict":
        ckpt = Checkpoint.from_dict({"params": params})
    else:  # written by the JAX package, read by the port
        ckpt = Checkpoint.from_directory(
            JaxCheckpoint.from_dict({"params": params}).to_directory(str(tmp_path / "bert")))
    ds = rd.from_items([{"tokens": toks[i], "id": i} for i in range(N_ROWS)], parallelism=BLOCKS)
    out = BatchPredictor.from_checkpoint(
        ckpt, TorchPredictor, apply_fn=functools.partial(tbert.apply, cfg=tcfg), device="cpu",
    ).predict(ds, batch_size=BATCH, max_scoring_workers=2, num_gpus_per_worker=0.5,
              feature_columns=["tokens"], keep_columns=["id"])
    rows = out.take_all()
    assert [int(r["id"]) for r in rows] == list(range(N_ROWS))
    assert set(rows[0]) == {"predictions", "id"}
    got = np.stack([r["predictions"] for r in rows])
    want = _jax_logits(jcfg, params, toks)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert _wait_for_cards(2.0) == 2.0


class _GrantPredictor(TorchPredictor):
    """TorchPredictor that also returns, per row, the actor's grant and
    the cards the head has free while it scores."""

    def predict(self, batch, **kwargs):
        from ray_tpu_torch import available_resources, get_runtime_context

        n = len(batch)
        return {"predictions": super().predict(batch),
                "cvd": np.asarray([os.environ["CUDA_VISIBLE_DEVICES"]] * n),
                "gpu_ids": np.asarray([get_runtime_context().get_gpu_ids()] * n),
                "pid": np.full(n, os.getpid()),
                "free_gpus": np.full(n, available_resources().get("GPU", 0.0))}


def test_two_half_card_actors_share_card_0(runtime):
    """``num_gpus_per_worker=0.5``: both actors are granted card 0, the
    head holds one card for them while they run, and both halves come
    back when the last block is sealed.  A plain array dataset (no
    columns) is scored whole."""
    _, params, tcfg, toks = _bert()
    ds = rd.from_numpy(toks, parallelism=BLOCKS)
    out = BatchPredictor(Checkpoint.from_dict({"params": params}), _GrantPredictor,
                         apply_fn=functools.partial(tbert.apply, cfg=tcfg), device="cpu",
                         ).predict(ds, batch_size=BATCH, max_scoring_workers=2,
                                   num_gpus_per_worker=0.5)
    (batch,) = list(out.iter_batches(batch_size=N_ROWS))
    assert len(batch["predictions"]) == N_ROWS
    assert set(batch["cvd"].tolist()) == {"0"}
    assert batch["gpu_ids"].reshape(-1).tolist() == [0] * N_ROWS
    assert len(set(batch["pid"].tolist())) == 2
    assert set(batch["free_gpus"].tolist()) == {1.0}  # card 1 free, card 0 held by the halves
    assert _wait_for_cards(2.0) == 2.0


def test_batch_predictor_argument_checks(runtime):
    _, params, tcfg, toks = _bert()
    bp = BatchPredictor(Checkpoint.from_dict({"params": params}), TorchPredictor,
                        apply_fn=functools.partial(tbert.apply, cfg=tcfg), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        bp.predict(rd.from_numpy(toks), min_scoring_workers=3, max_scoring_workers=2)
    with pytest.raises(TypeError, match="Predictor subclass"):
        BatchPredictor(Checkpoint.from_dict({"params": params}), dict)


def _gpt2_state(init_state):
    from ray_tpu_torch.convert import from_jax_train_state

    return from_jax_train_state(init_state, tgpt2.GPT2Config.tiny(dtype=torch.float32),
                                tgpt2.make_optimizer(**OPT), device="cpu")


def _gpt2_steps(state, batches):
    """The port's step over ``[B, T + 1]`` id rows: inputs and targets are
    the rows less their last and first id."""
    step = tgpt2.make_train_step(tgpt2.GPT2Config.tiny(dtype=torch.float32),
                                 tgpt2.make_optimizer(**OPT))
    losses = []
    for rows in batches:
        rows = torch.from_numpy(np.asarray(rows)).long()
        state, m = step(state, {"inputs": rows[:, :-1], "targets": rows[:, 1:]})
        losses.append(m["loss"].item())
    return losses


def _dataset_train_loop(config):
    from ray_tpu_torch.air import session

    torch.set_num_threads(1)
    shard = session.get_dataset_shard("train")
    losses = _gpt2_steps(_gpt2_state(config["init"]),
                         shard.iter_batches(batch_size=config["batch"]))
    session.report({"losses": losses})


def test_torch_trainer_reads_its_batches_from_a_dataset(runtime):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2

    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    opt = jgpt2.make_optimizer(**OPT)
    jstate = jgpt2.init_state(jcfg, jax.random.PRNGKey(0), opt)
    init = jax.tree.map(np.asarray, jstate)
    rows = np.random.default_rng(0).integers(0, jcfg.vocab_size, (GPT_B * GPT_STEPS, GPT_T + 1),
                                             np.int32)
    result = TorchTrainer(
        _dataset_train_loop, train_loop_config={"init": init, "batch": GPT_B},
        torch_config=TorchConfig(), scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        datasets={"train": rd.from_numpy(rows, parallelism=3)}).fit()
    assert result.error is None, result.error
    got = result.metrics["losses"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _gpt2_steps(_gpt2_state(init), [rows[i:i + GPT_B] for i in range(0, len(rows), GPT_B)])
    finally:
        torch.set_num_threads(threads)
    assert got == want  # bit for bit
    _, m = jax.jit(jgpt2.make_train_step(jcfg, opt))(
        jstate, {"inputs": jnp.asarray(rows[:GPT_B, :-1]), "targets": jnp.asarray(rows[:GPT_B, 1:])})
    np.testing.assert_allclose(got[0], float(m["loss"]), atol=TOL, rtol=0)
