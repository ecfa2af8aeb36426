"""The port's PolicyServer and RemotePolicy on its runtime, on the CPU.

Counterparts by name of ``test_rllib_policy_server.py``'s five tests and
of ``test_rllib_connectors.py``'s two that need remote workers (the
pipeline pickled to them with the server, the running-stat sync), with
the server on the CPU (``serve_policy(num_gpus=0)``) and the learner's
device named.  Held to the JAX package's ``PolicyServer`` in this
process, from the same weights (``convert.from_jax_rl_params``): the
frame-stack update ``advance`` byte for byte over random frames and
reset masks, and ``train_on_batch`` on one fixed batch and seed, from
pixels and from the cached snapshots, with losses and updated params
within ``test_torch_rllib_policy.py``'s f32 tolerance (1e-5) after 6
clipped Adam updates (2 epochs of 3 minibatches; Adam's normalisation
turns f32 reordering into drift that grows with the updates).
``serve_policy`` with no ``num_gpus`` asks for a card and raises on a
host without one.

One runtime serves the module (``init(num_cpus=8, num_gpus=2)``, fake
cards); every wait has a timeout.  JAX is imported inside the tests only.
"""

import pickle

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.convert import from_jax_rl_params
from ray_tpu_torch.rllib import (
    PolicyServer,
    PPOConfig,
    SampleBatch,
    SyntheticAtariEnv,
    serve_policy,
    synthetic_atari_creator,
)
from ray_tpu_torch.rllib.connectors import (
    AgentConnectorPipeline,
    ConnectorContext,
    FlattenObs,
    NormalizeObs,
)
from ray_tpu_torch.rllib.policy_server import advance
from ray_tpu_torch.util.tree import tree_map

T = 120  # seconds: every get in this file
TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = (36, 36, 4)  # the CNN's frames for the in-process parity tests


@pytest.fixture(scope="module")
def ray_instance():
    ray_tpu_torch.init(num_cpus=8, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_synthetic_atari_env_shapes():
    env = SyntheticAtariEnv({"episode_len": 20})
    obs, _ = env.reset(seed=3)
    assert obs.shape == (84, 84, 4) and obs.dtype == np.uint8
    steps, terminated = 0, False
    while not terminated:
        obs, r, terminated, truncated, _ = env.step(steps % 6)
        steps += 1
        assert obs.dtype == np.uint8
    assert steps == 20 and not truncated
    obs2, _ = env.reset(seed=3)
    env.step(0)
    obs3, *_ = env.step(0)
    assert not np.array_equal(obs2, obs3)


def _atari_ppo(**rollouts):
    return (PPOConfig()
            .environment(env_creator=synthetic_atari_creator, env_config={"episode_len": 24})
            .rollouts(num_rollout_workers=2, num_envs_per_worker=2, **rollouts)
            .training(sgd_minibatch_size=16, num_sgd_iter=2, fcnet_hiddens=(32,))
            .debugging(seed=0))


def test_ppo_with_policy_server(ray_instance):
    """PPO where every rollout worker's policy is the shared PolicyServer:
    sampling, batched bootstraps, SGD on the server, weight sync by token."""
    cfg = _atari_ppo(rollout_fragment_length=12).training(train_batch_size=48).to_dict()
    server, overrides = serve_policy(cfg, obs_dim=84 * 84 * 4, num_actions=6,
                                     obs_shape=(84, 84, 4), num_gpus=0, max_concurrency=8)
    cfg.update(overrides)
    algo = cfg.pop("_algo_class")(config=cfg)
    try:
        r1 = algo.step()
        assert r1["timesteps_total"] >= 48
        assert "learner" in r1["info"] and "total_loss" in r1["info"]["learner"]
        # uint8 observations rode the whole pipeline
        assert algo.workers.local_worker.sample()["obs"].dtype == np.uint8
        # weight sync is a token exchange, not a tensor ship
        assert algo.workers.local_worker.get_weights().get("__policy_server_weights__")
        # a checkpoint carries the server's real state
        state = algo.save_checkpoint()
        leaves = state["policy_state"]["weights"]
        assert isinstance(leaves, dict) and "conv" in leaves
        assert ray_tpu_torch.get(server.describe.remote(), timeout=T)["device"] == "cpu"
        algo.load_checkpoint(state)
        r2 = algo.step()
        assert r2["timesteps_total"] > r1["timesteps_total"]
    finally:
        algo.cleanup()
        ray_tpu_torch.kill(server)


def test_frame_stack_transport_equivalence(ray_instance):
    """The server's stacks are bit-identical to the env's own frame stacks
    across steps and resets."""
    cfg = PPOConfig().training(fcnet_hiddens=(16,)).to_dict()
    server, _ = serve_policy(cfg, obs_dim=84 * 84 * 4, num_actions=6, obs_shape=(84, 84, 4),
                             num_gpus=0, max_concurrency=4)
    envs = [SyntheticAtariEnv({"episode_len": 5}) for _ in range(3)]
    obs = [e.reset(seed=i)[0] for i, e in enumerate(envs)]
    reset_mask = np.ones(3, bool)
    ray_tpu_torch.get(server.start_rollout.remote(7, 3), timeout=T)
    for t in range(12):
        new_frames = np.stack([o[..., -1] for o in obs])
        a, lp, v, tick = ray_tpu_torch.get(server.compute_actions_stacked.remote(
            7, new_frames, reset_mask), timeout=T)
        assert tick == t
        server_obs = ray_tpu_torch.get(server.peek_obs.remote(7), timeout=T)
        np.testing.assert_array_equal(server_obs, np.stack(obs))
        reset_mask = np.zeros(3, bool)
        for i, e in enumerate(envs):
            o, r, term, trunc, _ = e.step(int(a[i]))
            if term or trunc:
                o, _ = e.reset()
                reset_mask[i] = True
            obs[i] = o
    ray_tpu_torch.kill(server)


def test_ppo_frame_stack_transport_end_to_end(ray_instance):
    """PPO through the frame-stack transport: observation references in
    the sample batch, training resolved from the server's snapshots."""
    cfg = (_atari_ppo(rollout_fragment_length=10)
           .environment(env_config={"episode_len": 16})
           .training(train_batch_size=40).to_dict())
    server, overrides = serve_policy(cfg, obs_dim=84 * 84 * 4, num_actions=6,
                                     obs_shape=(84, 84, 4), num_gpus=0, max_concurrency=8,
                                     frame_stack_transport=True)
    cfg.update(overrides)
    algo = cfg.pop("_algo_class")(config=cfg)
    try:
        r1 = algo.step()
        assert r1["timesteps_total"] >= 40
        assert np.isfinite(r1["info"]["learner"]["total_loss"])
        probe = algo.workers.local_worker.sample()
        assert probe["obs"].dtype == np.int32 and probe["obs"].shape[1] == 3
        r2 = algo.step()
        assert r2["timesteps_total"] > r1["timesteps_total"]
    finally:
        algo.cleanup()
        ray_tpu_torch.kill(server)


def test_policy_server_concurrent_inference(ray_instance):
    """Concurrent compute_actions calls (several rollout workers in
    flight) return the right shapes and valid actions."""
    cfg = PPOConfig().training(fcnet_hiddens=(32,)).to_dict()
    server, _ = serve_policy(cfg, obs_dim=84 * 84 * 4, num_actions=6, obs_shape=(84, 84, 4),
                             num_gpus=0, max_concurrency=8)
    obs = np.zeros((4, 84, 84, 4), np.uint8)
    outs = ray_tpu_torch.get([server.compute_actions.remote(obs) for _ in range(6)], timeout=T)
    for a, lp, v in outs:
        assert a.shape == (4,) and lp.shape == (4,) and v.shape == (4,)
        assert np.all((0 <= a) & (a < 6))
    ray_tpu_torch.kill(server)


def test_pipeline_pickles_and_rides_policy_server(ray_instance):
    """Connector pipelines (with learned state) pickle; a config carrying
    them reaches remote rollout workers whose policy is the shared
    PolicyServer, and sampling goes through the pipeline on every worker."""
    ctx = ConnectorContext(obs_shape=(4,), obs_dim=4)
    pipe = AgentConnectorPipeline(ctx, [FlattenObs(), NormalizeObs()])
    pipe(np.arange(4.0))
    restored = pickle.loads(pickle.dumps(pipe))
    orig_state, rest_state = pipe.to_state(), restored.to_state()
    assert [n for n, _ in rest_state] == [n for n, _ in orig_state]
    assert rest_state[1][1]["n"] == orig_state[1][1]["n"] == 1
    np.testing.assert_array_equal(rest_state[1][1]["mean"], orig_state[1][1]["mean"])

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, rollout_fragment_length=20)
        .connectors(agent_connectors=[("flatten_obs", {}), ("normalize_obs", {})])
        .training(train_batch_size=80, sgd_minibatch_size=32, num_sgd_iter=2,
                  fcnet_hiddens=(16,))
        .debugging(seed=0)
    ).to_dict()
    server, overrides = serve_policy(cfg, obs_dim=4, num_actions=2, num_gpus=0,
                                     max_concurrency=8)
    cfg.update(overrides)
    algo = cfg.pop("_algo_class")(config=cfg)
    try:
        r = algo.step()
        assert r["timesteps_total"] >= 80
        assert "total_loss" in r["info"]["learner"]
        name, params = algo.workers.local_worker.get_connector_state()["agent"][-1]
        assert name == "normalize_obs" and params["n"] > 0
        remote_states = ray_tpu_torch.get(
            [w.get_connector_state.remote() for w in algo.workers.remote_workers], timeout=T)
        for rs in remote_states:
            rname, rparams = rs["agent"][-1]
            assert rname == "normalize_obs" and rparams["n"] > 0
    finally:
        algo.cleanup()
        ray_tpu_torch.kill(server)


def test_filter_stats_sync_from_remote_workers(ray_instance):
    """MeanStdFilter with remote rollout workers: their running statistics
    reach the local (learner) worker each sampling round, and the
    checkpoint keeps them."""
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=32)
            .training(train_batch_size=64, num_sgd_iter=1)
            .connectors(observation_filter="MeanStdFilter")
            .resources(device="cpu")
            .build())
    algo.train()
    local_stats = [s for s in algo.workers.local_worker.get_connector_stat_states()
                   if s is not None]
    assert local_stats and local_stats[0]["n"] >= 64, \
        "remote filter statistics never reached the local worker"
    name, params = algo.save_checkpoint()["connector_state"]["agent"][-1]
    assert name == "normalize_obs" and params["n"] >= 64, \
        "checkpoint persisted empty filter statistics"
    algo.stop()


def test_serve_policy_defaults_to_the_card_and_raises_without_one(ray_instance):
    """With no ``num_gpus`` the server asks for a card and builds its
    policy there: on a host without CUDA it raises (no CPU fallback), and
    the card it was granted comes back."""
    free = ray_tpu_torch.available_resources()["GPU"]
    with pytest.raises(Exception, match="no CUDA device"):
        serve_policy(PPOConfig().training(fcnet_hiddens=(8,)).to_dict(), obs_dim=4,
                     num_actions=2)
    import time

    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources()["GPU"] != free:
        assert time.monotonic() < deadline
        time.sleep(0.1)


# -- the JAX package's server, in this process -----------------------------

def _servers(frame_shape=SMALL):
    """The JAX ``PolicyServer`` and the port's, on the CPU, with PPO's loss
    and the same weights."""
    from ray_tpu.rllib import PPOConfig as JaxPPOConfig
    from ray_tpu.rllib.policy_server import PolicyServer as JaxPolicyServer

    over = dict(fcnet_hiddens=(32,), grad_clip=0.05, lr=1e-3, entropy_coeff=0.01)
    dim = int(np.prod(frame_shape))
    kw = {"obs_shape": frame_shape}
    jserver = JaxPolicyServer(dim, 6, dict(kw), JaxPPOConfig().training(**over).to_dict())
    tserver = PolicyServer(dim, 6, dict(kw), PPOConfig().training(**over).to_dict(),
                           device="cpu")
    tserver.set_weights(from_jax_rl_params(jserver.get_weights(), device="cpu"))
    return jserver, tserver


def _ppo_cols(rng, n, obs=None):
    return {SampleBatch.OBS: rng.integers(0, 256, (n, *SMALL), dtype=np.uint8) if obs is None
            else obs,
            SampleBatch.ACTIONS: rng.integers(0, 6, n),
            SampleBatch.ACTION_LOGP: (np.log(1 / 6) + rng.normal(0, 0.1, n)).astype(np.float32),
            SampleBatch.ADVANTAGES: rng.normal(size=n).astype(np.float32),
            SampleBatch.VALUE_TARGETS: rng.normal(0, 3, n).astype(np.float32)}


def _weights_close(tserver, jserver):
    tree_map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=1e-5),
             tserver.get_weights(), jserver.get_weights())


def test_advance_matches_the_jax_servers_byte_for_byte():
    """``advance`` over 6 ticks of random frames and reset masks gives the
    JAX server's stacks, byte for byte."""
    from ray_tpu.rllib.policy_server import PolicyServer as JaxPolicyServer

    jadvance = JaxPolicyServer._build_advance(None)
    rng = np.random.default_rng(4)
    state = rng.integers(0, 256, (5, 12, 10, 4), dtype=np.uint8)
    jstate, tstate = state, torch.from_numpy(state.copy())
    for _ in range(6):
        frames = rng.integers(0, 256, (5, 12, 10), dtype=np.uint8)
        mask = rng.random(5) < 0.4
        jstate = np.asarray(jadvance(jstate, frames, mask))
        tstate = advance(tstate, torch.from_numpy(frames), torch.from_numpy(mask))
        assert tstate.dtype == torch.uint8
        np.testing.assert_array_equal(tstate.numpy(), jstate)


def test_train_on_batch_matches_the_jax_server():
    """One batch of 48 frames, 2 epochs of minibatches of 16 from seed 3:
    the mean losses and the updated params as the JAX server's."""
    jserver, tserver = _servers()
    cols = _ppo_cols(np.random.default_rng(0), 48)
    kw = dict(num_sgd_iter=2, sgd_minibatch_size=16, seed=3)
    got, want = tserver.train_on_batch(cols, **kw), jserver.train_on_batch(cols, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    _weights_close(tserver, jserver)


def test_train_on_cached_snapshots_matches_the_jax_server():
    """Two workers' ticks through ``compute_actions_stacked`` on both
    servers, then ``train_on_batch`` on (worker, tick, env) references:
    the losses and params as the JAX server's, trained from its own
    snapshots; the snapshots the batch names are consumed, and a batch
    naming them again raises."""
    jserver, tserver = _servers()
    rng = np.random.default_rng(1)
    refs = []
    for w in (1, 2):
        for server in (jserver, tserver):
            server.start_rollout(w, 3)
        for tick in range(4):
            frames = rng.integers(0, 256, (3, *SMALL[:2]), dtype=np.uint8)
            mask = np.zeros(3, bool) if tick else np.ones(3, bool)
            mask[rng.integers(0, 3)] |= tick == 2
            for server in (jserver, tserver):
                assert server.compute_actions_stacked(w, frames, mask)[3] == tick
            refs += [(w, tick, e) for e in range(3)]
    np.testing.assert_array_equal(tserver.peek_obs(2), jserver.peek_obs(2))
    cols = _ppo_cols(rng, len(refs), obs=np.asarray(refs, np.int32))
    kw = dict(num_sgd_iter=2, sgd_minibatch_size=12, seed=5)
    got, want = tserver.train_on_batch(cols, **kw), jserver.train_on_batch(cols, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    _weights_close(tserver, jserver)
    assert not tserver._obs_cache and tserver._obs_cache_bytes == 0
    with pytest.raises(RuntimeError, match="evicted"):
        tserver.train_on_batch(cols, **kw)


def test_snapshot_cache_evicts_oldest_first_under_its_byte_cap():
    _, tserver = _servers()
    n, (h, w, c) = 2, SMALL
    tserver._obs_cache_cap_bytes = 3 * n * h * w * c
    frames = np.zeros((n, h, w), np.uint8)
    for _ in range(5):
        tserver.compute_actions_stacked(0, frames, np.ones(n, bool))
    assert list(tserver._obs_cache) == [(0, 2), (0, 3), (0, 4)]
    assert tserver._obs_cache_bytes == 3 * n * h * w * c
    tserver.start_rollout(0, n)  # a restarted worker drops its snapshots
    assert not tserver._obs_cache and tserver._obs_cache_bytes == 0
