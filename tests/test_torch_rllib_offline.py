"""The port's offline IO, on the CPU.

``test_rllib.py``'s two offline tests by name; the files themselves held
to the JAX package's: what either package's ``JsonWriter`` writes (names,
the roll at ``max_file_size``, every byte) the other writes too, and
either ``JsonReader`` reads the other's with equal columns and dtypes; a
rollout worker with ``output`` writes each fragment; and DQN trained
offline from one file, from the JAX package's weights, takes the JAX
DQN's ``training_step``s (the replay draws come from seeded numpy in
both): learner metrics, weights and the target net within 1e-5 (f32).
No runtime.  JAX is imported inside the tests only.
"""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import DQNConfig, JsonReader, JsonWriter, RolloutWorker, SampleBatch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The learners' tensors are tiny: torch's intra-op threads only
    contend, with each other and with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_offline_write_read_roundtrip(tmp_path):
    w = JsonWriter(str(tmp_path))
    b = SampleBatch({
        "obs": np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32),
        "actions": np.arange(5),
        "terminateds": np.array([False, False, True, False, True]),
    })
    w.write(b)
    w.write(b)
    r = JsonReader(str(tmp_path))
    all_b = r.read_all()
    assert all_b.count == 10
    np.testing.assert_allclose(all_b["obs"][:5], b["obs"], rtol=1e-6)
    assert all_b["terminateds"].dtype == np.bool_
    nxt = r.next()
    assert nxt.count == 5


def _batches():
    rng = np.random.default_rng(1)
    for n in (3, 7, 2, 9, 4):
        yield {"obs": rng.standard_normal((n, 4)).astype(np.float32),
               "actions": rng.integers(0, 3, n),
               "rewards": rng.random(n).astype(np.float32),
               "terminateds": rng.random(n) < 0.3,
               "eps_id": rng.integers(0, 1 << 40, n),
               "frames": rng.integers(0, 256, (n, 2, 2), dtype=np.uint8)}


def test_files_are_the_jax_packages(tmp_path):
    """Each package's writer, given the same batches and a small
    ``max_file_size``, writes the same files byte for byte (worker 1,
    so the name carries the index); each reader reads the other's files
    back with equal columns and dtypes.  A tensor column is written from a
    host copy."""
    import ray_tpu.rllib as jrl

    ours, theirs = tmp_path / "port", tmp_path / "jax"
    tw = JsonWriter(str(ours), worker_index=1, max_file_size=1500)
    jw = jrl.JsonWriter(str(theirs), worker_index=1, max_file_size=1500)
    for cols in _batches():
        tw.write(SampleBatch({**cols, "obs": torch.from_numpy(cols["obs"])}))
        jw.write(jrl.SampleBatch(cols))
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert len(names) >= 3 and all(n.startswith("output-worker_1-") for n in names)
    for n in names:
        assert (ours / n).read_bytes() == (theirs / n).read_bytes(), n
    want = list(_batches())
    for reader in (jrl.JsonReader(str(ours)), JsonReader(str(theirs))):
        got = reader.read_all()
        for k in want[0]:
            col = np.concatenate([b[k] for b in want])
            assert got[k].dtype == col.dtype, k
            np.testing.assert_array_equal(got[k], col, err_msg=k)
    # a second writer on the same directory resumes after the last file
    JsonWriter(str(ours), worker_index=1, max_file_size=1500).write(
        SampleBatch(next(_batches())))
    assert sorted(os.listdir(ours))[:len(names)] == names


def test_rollout_worker_output_writes_each_fragment(tmp_path):
    from ray_tpu_torch.rllib import synthetic_atari_creator

    w = RolloutWorker({"env_creator": synthetic_atari_creator,
                       "env_config": {"episode_len": 4}, "fcnet_hiddens": (8,),
                       "rollout_fragment_length": 3, "output": str(tmp_path)},
                      worker_index=2, device="cpu")
    batches = [w.sample() for _ in range(2)]
    assert os.listdir(tmp_path) == ["output-worker_2-0.json"]
    got = JsonReader(str(tmp_path)).read_all()
    for k in batches[0]:
        np.testing.assert_array_equal(got[k], np.concatenate([b[k] for b in batches]))
    assert got[SampleBatch.OBS].dtype == np.uint8


def test_dqn_offline_training(tmp_path):
    """Record CartPole transitions with one DQN, train a second purely
    offline from the files."""
    rec = (
        DQNConfig()
        .environment("CartPole-v1")
        .offline_data(output=str(tmp_path))
        .training(timesteps_per_iteration=500, updates_per_iteration=20,
                  learning_starts=100)
        .resources(device="cpu")
        .build()
    )
    for _ in range(3):
        rec.train()
    rec.cleanup()

    offline = (
        DQNConfig()
        .environment("CartPole-v1")
        .offline_data(input_=str(tmp_path))
        .training(timesteps_per_iteration=400, updates_per_iteration=50,
                  learning_starts=100)
        .resources(device="cpu")
        .build()
    )
    r = offline.train()
    assert r["info"]["learner"]["replay_size"] >= 400
    assert np.isfinite(r["info"]["learner"].get("mean_td_error", 0.0))
    offline.cleanup()


def test_dqn_offline_training_step_matches_jax(tmp_path):
    """The JAX package records CartPole transitions; both packages' DQN,
    from the same weights and target net, train offline from that file:
    three ``training_step``s agree (metrics, replay size, weights and
    target within 1e-5)."""
    import jax

    import ray_tpu.rllib as jrl
    from ray_tpu_torch.convert import from_jax_rl_state
    from ray_tpu_torch.util.tree import tree_map

    rec = (jrl.DQNConfig().environment("CartPole-v1")
           .rollouts(rollout_fragment_length=60).offline_data(output=str(tmp_path))
           .training(timesteps_per_iteration=60, learning_starts=10_000)
           .debugging(seed=2).build())
    for _ in range(3):
        rec.train()
    rec.cleanup()

    def build(cfg):
        return (cfg.environment("CartPole-v1").offline_data(input_=str(tmp_path))
                .training(timesteps_per_iteration=50, learning_starts=60,
                          updates_per_iteration=5, target_network_update_freq=4,
                          train_batch_size=16, fcnet_hiddens=(16,))
                .debugging(seed=3))

    jalgo = build(jrl.DQNConfig()).build()
    talgo = build(DQNConfig()).resources(device="cpu").build()
    jpol, tpol = jalgo.get_policy(), talgo.get_policy()
    tpol.set_state(from_jax_rl_state(jpol.get_state(), device="cpu"))
    tpol.update_target()

    def close(got, want, what):
        tree_map(lambda g, w: np.testing.assert_allclose(np.asarray(g), w, atol=1e-5,
                                                         err_msg=what),
                 got, jax.tree_util.tree_map(np.asarray, want))

    learned = 0
    for step in range(3):
        want = jalgo.training_step()["info"]["learner"]
        got = talgo.training_step()["info"]["learner"]
        assert talgo._timesteps_total == jalgo._timesteps_total
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"step {step}: {k}")
        learned += "total_loss" in want
        close(tpol.get_weights(), jpol.get_weights(), f"step {step}: weights")
        close(tpol.target_params, jpol.target_params, f"step {step}: target")
    assert learned >= 2
    jalgo.cleanup()
    talgo.cleanup()
