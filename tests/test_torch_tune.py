"""The port's Tune on its runtime, on the CPU.

Held to the JAX package without a runtime: ``BasicVariantGenerator``'s
variants, ``TPESearcher``'s suggestions, and the ASHA, median-stopping
and PBT decisions (PBT's exploit choices and mutated configs too) are
equal to the JAX package's for the same seed and result stream.  On the
runtime: ``test_tune.py``'s tests by name, ``test_rllib.py``'s
``test_ppo_under_tuner`` and ``test_tooling_round4.py``'s storage-URI
sync; ``TorchTrainer.as_trainable`` over a grid of two learning rates,
each trial's losses bit-equal to a direct ``fit()``; a stopped trainer
trial gives its gang back; PBT through the trial hosts; and the devices:
a trial asking for a card on a runtime without one fails at once, as
does a PPO trial whose learner defaults to the card in a host with no
grant, and a checkpoint made from card tensors keeps them on the host.

One runtime serves the module (``init(num_cpus=4)``, no cards), its
workers on one intra-op thread.  JAX is imported inside the tests only: a
trial host that unpickles this module's trainables imports the module.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import Checkpoint, RunConfig, ScalingConfig, session
from ray_tpu_torch.tune import ASHAScheduler, TuneConfig, Tuner
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's intra-op threads only contend here, in this process and
    (through the env the runtime's workers inherit) in the trial hosts."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


# -- parity with the JAX package, no runtime ---------------------------------

def _space(t):
    return {"lr": t.grid_search([0.1, 0.01]), "wd": t.uniform(0.0, 1.0),
            "eps": t.loguniform(1e-8, 1e-4),
            "net": {"units": t.choice([32, 64, 128]), "depth": t.randint(1, 6),
                    "act": t.grid_search(["relu", "tanh"])},
            "fixed": 7}


def test_variants_match_jax():
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search.basic_variant import BasicVariantGenerator as JaxGenerator

    got = list(BasicVariantGenerator(seed=5).variants(_space(tune), num_samples=3))
    want = list(JaxGenerator(seed=5).variants(_space(jtune), num_samples=3))
    assert len(got) == 12
    assert got == want


def _tpe_score(cfg):
    return ((np.log10(cfg["lr"]) + 2.5) ** 2 + (cfg["x"] - 1.0) ** 2
            + (0.0 if cfg["opt"] == "adam" else 0.5) + 0.1 * abs(cfg["n"] - 7))


def test_tpe_suggestions_match_jax():
    from ray_tpu import tune as jtune

    def searcher(t):
        space = {"lr": t.loguniform(1e-4, 1e-1), "x": t.uniform(-3.0, 3.0),
                 "opt": t.choice(["adam", "sgd", "rmsprop"]), "n": t.randint(0, 10)}
        return t.TPESearcher(space, metric="loss", mode="min", n_initial_points=4, seed=3)

    ours, theirs = searcher(tune), searcher(jtune)
    for i in range(16):
        got, want = ours.suggest(f"t{i}"), theirs.suggest(f"t{i}")
        assert got == want, i
        # every third trial ends without the metric; the searcher skips it
        result = None if i % 3 == 2 else {"loss": _tpe_score(got)}
        ours.on_trial_complete(f"t{i}", result)
        theirs.on_trial_complete(f"t{i}", result)


class _StubTrial:
    def __init__(self, trial_id, config):
        self.trial_id, self.config = trial_id, config


class _StubRunner:
    """The two services a scheduler asks of the trial runner."""

    def __init__(self, trials):
        self.trials = {t.trial_id: t for t in trials}
        self.exploits = []

    def get_trial(self, trial_id):
        return self.trials.get(trial_id)

    def exploit_trial(self, trial, donor, new_config):
        self.exploits.append((trial.trial_id, donor.trial_id, new_config))
        trial.config = new_config


def _result_stream(n_trials, n_iters, seed):
    """Interleaved results: each trial's loss falls at its own rate, with
    noise; some results lack the metric."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.05, 0.5, n_trials)
    for it in range(1, n_iters + 1):
        for k in rng.permutation(n_trials):
            res = {"training_iteration": it}
            if rng.random() > 0.1:
                res["loss"] = float(np.exp(-rates[k] * it) + rng.normal(0, 0.02))
            yield f"t{k}", res


@pytest.mark.parametrize("name", ["ASHAScheduler", "MedianStoppingRule",
                                  "PopulationBasedTraining"])
def test_scheduler_decisions_match_jax(name):
    """The same result stream into both packages' scheduler: the same
    CONTINUE/STOP decision for every result, and for PBT the same
    exploits (trial, donor and mutated config)."""
    from ray_tpu import tune as jtune

    def make(t):
        if name == "ASHAScheduler":
            return t.ASHAScheduler(metric="loss", mode="min", max_t=12, grace_period=1,
                                   reduction_factor=2)
        if name == "MedianStoppingRule":
            return t.MedianStoppingRule(metric="loss", mode="min", grace_period=2,
                                        min_samples_required=3)
        return t.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2, quantile_fraction=0.25,
            seed=11, hyperparam_mutations={"lr": [0.1, 0.01, 0.001],
                                           "momentum": t.uniform(0.0, 1.0)})

    decided = []
    for t in (tune, jtune):
        trials = [_StubTrial(f"t{k}", {"lr": 0.01, "momentum": 0.9, "k": k}) for k in range(8)]
        runner, sched, stopped, out = _StubRunner(trials), make(t), set(), []
        for tid, res in _result_stream(8, 12, seed=4):
            if tid in stopped:
                continue
            d = sched.on_trial_result(runner, runner.get_trial(tid), res)
            out.append((tid, res["training_iteration"], d))
            if d == "STOP":
                stopped.add(tid)
        decided.append((out, runner.exploits, {k: v.config for k, v in runner.trials.items()}))
    (got, got_exploits, got_cfgs), (want, want_exploits, want_cfgs) = decided
    assert got == want
    assert got_exploits == want_exploits
    assert got_cfgs == want_cfgs
    if name == "PopulationBasedTraining":
        assert got_exploits  # the stream does exploit
    else:
        assert any(d == "STOP" for _, _, d in got)


# -- test_tune.py by name -------------------------------------------------------

def test_variant_generation():
    gen = BasicVariantGenerator(seed=0)
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0.0, 1.0),
        "nested": {"units": tune.choice([32, 64])},
        "fixed": 7,
    }
    variants = list(gen.variants(space, num_samples=2))
    assert len(variants) == 4  # 2 grid x 2 samples
    assert {v["lr"] for v in variants} == {0.1, 0.01}
    for v in variants:
        assert 0.0 <= v["wd"] <= 1.0
        assert v["nested"]["units"] in (32, 64)
        assert v["fixed"] == 7


def _objective(config):
    # quadratic bowl: best at x = 3
    for step in range(8):
        loss = (config["x"] - 3.0) ** 2 + 0.1 * step
        session.report({"loss": loss, "training_iteration": step + 1})


def test_tuner_grid(runtime, tmp_path):
    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([0.0, 3.0, 5.0])},
        tune_config=TuneConfig(metric="loss", mode="min", max_concurrent_trials=2),
        run_config=RunConfig(name="grid", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 3
    assert not grid.errors
    best = grid.get_best_result()
    assert best.metrics["config"]["x"] == 3.0


def test_asha_stops_bad_trials(runtime, tmp_path):
    sched = ASHAScheduler(metric="loss", mode="min", max_t=8,
                          grace_period=2, reduction_factor=2)
    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 10.0])},
        tune_config=TuneConfig(metric="loss", mode="min", scheduler=sched,
                               max_concurrent_trials=2),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["config"]["x"] == 3.0
    # at least one bad trial stopped before max_t
    iters = [grid[i].metrics.get("training_iteration", 0) for i in range(len(grid))]
    assert min(iters) < 8


class _Counter(tune.Trainable):
    def setup(self, config):
        self.count = config.get("start", 0)

    def step(self):
        self.count += 1
        return {"count": self.count, "done": self.count >= 5}

    def save_checkpoint(self):
        return {"count": self.count}

    def load_checkpoint(self, state):
        self.count = state["count"]


def test_class_trainable_and_checkpoint(runtime, tmp_path):
    tuner = Tuner(
        _Counter,
        param_space={"start": tune.grid_search([0, 10])},
        tune_config=TuneConfig(metric="count", mode="max"),
        run_config=RunConfig(name="cls", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert not grid.errors
    best = grid.get_best_result()
    assert best.metrics["count"] >= 10
    assert best.checkpoint is not None
    assert best.checkpoint.to_dict()["count"] == best.metrics["count"]


def test_tuner_restore(runtime, tmp_path):
    tuner = Tuner(
        _Counter,
        param_space={"start": tune.grid_search([0])},
        tune_config=TuneConfig(metric="count", mode="max"),
        run_config=RunConfig(name="resume", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert grid[0].metrics["count"] == 5
    restored = Tuner.restore(
        str(tmp_path / "resume"), _Counter,
        tune_config=TuneConfig(metric="count", mode="max"),
    )
    grid2 = restored.fit()  # everything terminated: results survive
    assert grid2[0].metrics["count"] == 5


def test_trial_timeout_kills_hung_trial(runtime):
    """A wedged trial must not stall the experiment (trial_timeout_s)."""

    def loop(config):
        from ray_tpu_torch.air import session

        if config["hang"]:
            time.sleep(3600)
        for i in range(2):
            session.report({"score": i})

    tuner = tune.Tuner(
        loop,
        param_space={"hang": tune.grid_search([False, True])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    trial_timeout_s=8.0, stop={"score": 1}),
    )
    t0 = time.time()
    grid = tuner.fit()
    assert time.time() - t0 < 240
    statuses = sorted(r.error is not None for r in grid)
    assert statuses == [False, True], "expected one ok trial and one timed-out"


def test_tpe_searcher_converges(runtime, tmp_path):
    """TPE should concentrate samples near the optimum of a quadratic."""

    def objective(config):
        session.report({"loss": (config["x"] - 3.0) ** 2, "training_iteration": 1})

    space = {"x": tune.uniform(-10.0, 10.0)}
    searcher = tune.TPESearcher(space, metric="loss", mode="min",
                                n_initial_points=6, seed=0)
    tuner = Tuner(
        objective,
        tune_config=TuneConfig(
            metric="loss", mode="min", num_samples=24,
            max_concurrent_trials=2, search_alg=searcher,
            stop={"training_iteration": 1},
        ),
        run_config=RunConfig(storage_path=str(tmp_path), name="tpe"),
    )
    grid = tuner.fit()
    assert len(grid) == 24
    best = grid.get_best_result()
    assert best.metrics["loss"] < 1.5, best.metrics
    # the last half of suggestions should be much closer to 3 on average
    xs = [t.config["x"] for t in grid._trials]
    early = np.mean([abs(x - 3.0) for x in xs[:8]])
    late = np.mean([abs(x - 3.0) for x in xs[-8:]])
    assert late < early


def test_tpe_categorical_and_integer():
    space = {"c": tune.choice(["a", "b"]), "n": tune.randint(0, 10)}
    s = tune.TPESearcher(space, metric="m", mode="max", n_initial_points=4, seed=1)
    # feed it results where c="b", n>=7 is best
    for i in range(20):
        cfg = s.suggest(f"t{i}")
        score = (1.0 if cfg["c"] == "b" else 0.0) + (cfg["n"] >= 7)
        s.on_trial_complete(f"t{i}", {"m": score})
    tail = [s.suggest(f"z{i}") for i in range(10)]
    assert sum(1 for c in tail if c["c"] == "b") >= 7
    assert np.mean([c["n"] for c in tail]) > 5


def test_logger_callbacks(runtime, tmp_path):
    import csv
    import json

    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=TuneConfig(metric="loss", mode="min",
                               stop={"training_iteration": 3}),
        run_config=RunConfig(
            storage_path=str(tmp_path), name="logs",
            callbacks=[tune.CSVLoggerCallback, tune.JSONLoggerCallback],
        ),
    )
    tuner.fit()
    exp = os.path.join(str(tmp_path), "logs")
    trial_dirs = [d for d in os.listdir(exp) if d.startswith("trial_")]
    assert len(trial_dirs) == 2
    for d in trial_dirs:
        with open(os.path.join(exp, d, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 3
        assert "loss" in rows[0]
        with open(os.path.join(exp, d, "result.json")) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == 3


# -- test_rllib.py and test_tooling_round4.py by name ---------------------------

def _fast_ppo_config():
    from ray_tpu_torch.rllib import PPOConfig

    return (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=0, rollout_fragment_length=400)
        .training(train_batch_size=2000, sgd_minibatch_size=128, num_sgd_iter=8, lr=3e-4,
                  entropy_coeff=0.01)
        .resources(device="cpu")
        .debugging(seed=0)
    )


def test_ppo_under_tuner(runtime):
    """BASELINE config 4's shape: PPO as a Tune trainable reaching the
    reward target under Tuner.fit, its learner on the CPU of the trial
    host (``device="cpu"`` in the param space)."""
    from ray_tpu_torch.rllib import PPO

    tuner = Tuner(
        PPO,
        param_space=_fast_ppo_config().to_dict(),
        tune_config=TuneConfig(
            metric="episode_reward_mean",
            mode="max",
            num_samples=1,
            stop={"episode_reward_mean": 195, "training_iteration": 30},
        ),
        run_config=RunConfig(name="ppo_cartpole_test"),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert best.metrics["episode_reward_mean"] >= 195


def test_tune_syncs_experiment_to_storage_uri(runtime, tmp_path):
    from ray_tpu_torch.air import remote_storage

    root = str(tmp_path / "cloud")
    remote_storage.register_filesystem(
        "mock", remote_storage.DirBackedFilesystem(root))

    def trainable(config):
        from ray_tpu_torch.air import session

        session.report({"score": config["x"] * 2, "done": True})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        run_config=RunConfig(storage_path="mock://bucket/exps", name="e1"),
    )
    results = tuner.fit()
    assert len(results) == 2
    synced = os.path.join(root, "bucket", "exps", "e1")
    assert os.path.isfile(os.path.join(synced, "experiment_state.pkl"))

    state_file = os.path.join(synced, "experiment_state.pkl")
    mtime = os.path.getmtime(state_file)
    time.sleep(0.05)
    restored = tune.Tuner.restore("mock://bucket/exps/e1", trainable)
    grid = restored.fit()  # all trials terminal: returns immediately
    assert sorted(r.metrics["score"] for r in grid) == [2, 4]
    # a resumed run keeps syncing to the ORIGINAL URI (not just locally)
    assert os.path.getmtime(state_file) > mtime


# -- Train on Tune --------------------------------------------------------------

def _mlp_loop(config):
    """SGD at ``config["lr"]`` on the MNIST MLP's shape, cut small, from a
    fixed init and batch: each step reports its loss; the last report
    carries every loss, the trial name and the params as a checkpoint."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.train import torch_utils

    torch.set_num_threads(1)
    dev = torch_utils.get_device("cpu")
    cfg = mlp.MLPConfig(in_dim=8, hidden=(16,), num_classes=2)
    params = mlp.init(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    batch = {"x": x, "y": (x.sum(-1) > 0).long()}
    losses = []
    for step in range(config["steps"]):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = mlp.loss_fn(leaves, batch, cfg)
        grads = torch_utils.allreduce_grads(
            dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
        params = {k: leaves[k].detach() - config["lr"] * grads[k] for k in params}
        losses.append(loss.item())
        session.report({"loss": losses[-1], "step": step})
    session.report({"loss": losses[-1], "losses": losses, "trial": session.get_trial_name()},
                   checkpoint=Checkpoint.from_dict({"params": params}))


def test_as_trainable_grid_matches_direct_fit(runtime, tmp_path):
    """Two learning rates through ``Tuner(TorchTrainer(...))``: each trial's
    losses are bit-equal to a direct ``fit()`` with the trial's config
    merged into ``train_loop_config``; each trial kept its own storage
    directory, and the best result is the lower last loss."""
    from ray_tpu_torch.train import TorchTrainer

    def trainer(**loop_config):
        return TorchTrainer(_mlp_loop, train_loop_config={"steps": 5, **loop_config},
                            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
                            run_config=RunConfig(name="mlp", storage_path=str(tmp_path)))

    lrs = [0.5, 0.05]
    grid = Tuner(trainer(), param_space={"lr": tune.grid_search(lrs)},
                 tune_config=TuneConfig(metric="loss", mode="min", max_concurrent_trials=2),
                 run_config=RunConfig(name="tune_mlp", storage_path=str(tmp_path))).fit()
    assert not grid.errors
    by_lr = {grid[i].metrics["config"]["lr"]: grid[i] for i in range(len(grid))}
    assert sorted(by_lr) == sorted(lrs)
    for lr in lrs:
        direct = trainer(lr=lr).fit()
        assert direct.error is None
        assert by_lr[lr].metrics["losses"] == direct.metrics["losses"]
        assert len(direct.metrics["losses"]) == 5
        ckpt = by_lr[lr].checkpoint.to_dict()["params"]
        want = direct.checkpoint.to_dict()["params"]
        assert all(torch.equal(ckpt[k], want[k]) for k in want)
    trials = {r.metrics["trial"] for r in by_lr.values()}
    assert len(trials) == 2 and all(t.startswith("mlp_") for t in trials)
    assert all((tmp_path / t).is_dir() for t in trials)
    losses = {lr: r.metrics["loss"] for lr, r in by_lr.items()}
    assert grid.get_best_result().metrics["config"]["lr"] == min(losses, key=losses.get)


def _reporting_forever(config):
    from ray_tpu_torch.air import session

    step = 0
    while True:
        session.report({"step": step})
        step += 1
        time.sleep(config["period_s"])


def test_stopped_trainer_trial_gives_its_gang_back(runtime):
    """A trainer trial told to stop while its ``fit()`` runs (a PBT
    ``reset``, an early stop) ends its thread within ``stop()``, and its
    Train gang is gone by then: no stale thread keeps a worker's CPU."""
    from ray_tpu_torch.train import TorchTrainer

    _wait_for_cpus(4)  # the earlier tests' actors are gone
    cls = TorchTrainer(_reporting_forever, scaling_config=ScalingConfig(
        num_workers=1, use_gpu=False)).as_trainable()
    trial = cls({"period_s": 0.05})
    # fit() runs on the trial's thread (train() would wait for its end)
    trial._ensure_started()
    deadline = time.monotonic() + 60
    while ray_tpu_torch.available_resources().get("CPU") != 3:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)
    t0 = time.monotonic()
    trial.stop()
    assert not trial._thread.is_alive()
    assert time.monotonic() - t0 < tune.trainable.STOP_JOIN_S
    _wait_for_cpus(4, timeout=10)


def _wait_for_cpus(n, timeout=30):
    deadline = time.monotonic() + timeout
    while ray_tpu_torch.available_resources().get("CPU") != n:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)


class _Quality(tune.Trainable):
    """A trial whose score grows by its ``rate`` each half-second step (so
    the trials overlap however their hosts' starts differ); its state is
    the score, so an exploit carries the donor's score over."""

    def setup(self, config):
        self.score = 0.0

    def step(self):
        time.sleep(0.5)
        self.score += self.config["rate"]
        return {"score": self.score}

    def save_checkpoint(self):
        return {"score": self.score}

    def load_checkpoint(self, state):
        self.score = state["score"]


def test_pbt_exploits_through_the_trial_hosts(runtime, tmp_path):
    """PBT's exploit runs on the trial hosts: the donor's ``save``, then
    the host's ``reset`` (a new trainable with the explored config and
    the donor's checkpoint).  The slowest trial ends with a rate of the
    mutation list and a score above what its own rate gives."""
    from ray_tpu_torch.tune import PopulationBasedTraining

    pbt = PopulationBasedTraining(metric="score", mode="max", perturbation_interval=2,
                                  quantile_fraction=0.5, seed=0,
                                  hyperparam_mutations={"rate": [2.0, 3.0]})
    grid = Tuner(_Quality, param_space={"rate": tune.grid_search([0.1, 1.0])},
                 tune_config=TuneConfig(metric="score", mode="max", scheduler=pbt,
                                        stop={"training_iteration": 8}),
                 run_config=RunConfig(name="pbt", storage_path=str(tmp_path))).fit()
    assert not grid.errors
    slow = next(t for t in grid._trials if t.config["rate"] in (2.0, 3.0))
    assert slow.last_result["score"] > 8 * 0.1 + 1.0


# -- devices ---------------------------------------------------------------------

def test_gpu_trial_on_a_cardless_runtime_fails_at_once(runtime):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="GPU"):
        Tuner(_objective, param_space={"x": 1.0},
              tune_config=TuneConfig(resources_per_trial={"CPU": 1, "GPU": 1})).fit()
    assert time.monotonic() - t0 < 10


def test_ppo_trial_without_a_card_grant_raises_at_once(runtime):
    """A PPO trial whose learner is left on its default, the card, in a
    trial host granted none: the trial fails at once with the device error
    (it neither trains on the CPU nor waits)."""
    from ray_tpu_torch.rllib import PPO

    cfg = _fast_ppo_config().to_dict()
    cfg["device"] = None
    t0 = time.monotonic()
    grid = Tuner(PPO, param_space=cfg,
                 tune_config=TuneConfig(stop={"training_iteration": 1})).fit()
    assert time.monotonic() - t0 < 60
    assert len(grid.errors) == 1 and "no CUDA device" in grid.errors[0]


class _OnCard(torch.Tensor):
    """A host tensor that says it lies on the card (this host has none)."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    def to(self, *args, **kwargs):
        return self.as_subclass(torch.Tensor).to(*args, **kwargs)


def test_checkpoint_keeps_card_tensors_on_the_host():
    """A dict checkpoint made from card tensors holds host copies, so it
    unpickles where no card is; host tensors and numpy leaves are kept as
    they are."""
    card = torch.arange(6.0).reshape(2, 3).as_subclass(_OnCard)
    assert card.device.type == "cuda"
    host, arr = torch.ones(2), np.arange(3)
    ckpt = Checkpoint.from_dict({"params": {"w": card, "b": [host]}, "arr": arr, "step": 3})
    data = pickle.loads(pickle.dumps(ckpt)).to_dict()
    w = data["params"]["w"]
    assert type(w) is torch.Tensor and w.device.type == "cpu"
    assert torch.equal(w, torch.arange(6.0).reshape(2, 3))
    assert ckpt.to_dict()["params"]["b"][0] is host and ckpt.to_dict()["arr"] is arr
    plain = {"w": host}
    assert Checkpoint.from_dict(plain).to_dict()["w"] is host
