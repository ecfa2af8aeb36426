"""The port's ``SklearnTrainer`` / ``SklearnPredictor``
(``ray_tpu_torch/train/sklearn_trainer.py``) against the JAX package's.

``tests/test_predictor.py::test_sklearn_trainer_and_predictor`` by name
on the port's runtime: the estimator fits inside a Tune trial actor on
Datasets and its checkpoint scores a Dataset through ``BatchPredictor``.
Beside it, parity on the same seeded numpy rows, the same estimator and
the same split: the JAX trainer's train loop (run in this process with
its ``session.report`` captured, on stand-in datasets that hold the same
rows, so no JAX head starts) reports the same validation score to 1e-12
and a model that predicts the same labels; the JAX ``SklearnPredictor``,
through the JAX ``BatchPredictor``'s scoring wrapper on the same
batches, gives the predictions the port's ``BatchPredictor`` gives.

One port head for the module (``num_gpus=0``, its processes under a
private ``TMPDIR``, one OpenMP thread a process); each test has its own
time limit.  scikit-learn is imported inside the tests only: its import
costs ~5 s a process, and the trial actor and the scoring actor each pay
it once.
"""

import signal
import tempfile

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.data import read_api
from ray_tpu_torch.train import BatchPredictor, SklearnPredictor, SklearnTrainer

LIMIT_S = {"test_sklearn_trainer_and_predictor": 150}
N_ROWS, N_TRAIN, N_SCORE, BATCH = 300, 240, 40, 16


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = LIMIT_S.get(request.node.name, 60)

    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N_ROWS, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    rows = [{"f0": a, "f1": b, "f2": c, "f3": d, "label": int(t)}
            for (a, b, c, d), t in zip(X, y)]
    return X, y, rows


def _estimator():
    from sklearn.ensemble import HistGradientBoostingClassifier

    return HistGradientBoostingClassifier(max_iter=30, random_state=0)


@pytest.fixture(scope="module")
def port_run():
    """The port's fit under Tune and its BatchPredictor's scores, once."""
    X, y, rows = _data()
    with tempfile.TemporaryDirectory(prefix="skl_") as d, \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        try:
            trainer = SklearnTrainer(
                estimator=_estimator(),
                datasets={"train": read_api.from_items(rows[:N_TRAIN]),
                          "valid": read_api.from_items(rows[N_TRAIN:])},
                label_column="label",
            )
            result = trainer.fit()
            bp = BatchPredictor.from_checkpoint(result.checkpoint, SklearnPredictor)
            score_ds = read_api.from_items(
                [{"f0": a, "f1": b, "f2": c, "f3": d} for a, b, c, d in X[:N_SCORE]])
            out = bp.predict(score_ds, batch_size=BATCH, max_scoring_workers=1)
            preds = np.concatenate(
                [np.atleast_1d(r["predictions"]) for r in out.take_all()])
            yield {"result": result, "preds": preds}
        finally:
            ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's train loop in this process, its report captured."""
    from ray_tpu.air import session as jax_session
    from ray_tpu.train import SklearnTrainer as JaxSklearnTrainer

    class Rows:
        """What the train loop reads of a Dataset: ``take_all()``."""

        def __init__(self, rows):
            self._rows = rows

        def take_all(self):
            return list(self._rows)

    _, _, rows = _data()
    reports = []
    trainer = JaxSklearnTrainer(estimator=_estimator(),
                                datasets={"train": Rows(rows[:N_TRAIN]),
                                          "valid": Rows(rows[N_TRAIN:])},
                                label_column="label")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_session, "report",
                   lambda metrics, checkpoint=None: reports.append((metrics, checkpoint)))
        trainer._train_loop()
    assert len(reports) == 1
    return reports[0]


def test_sklearn_trainer_and_predictor(port_run):
    """The JAX test's assertions on the port: the fit's rows and
    validation score, the model out of the checkpoint, and the
    BatchPredictor's scores."""
    X, y, _ = _data()
    result = port_run["result"]
    assert result.metrics["fit_rows"] == N_TRAIN
    assert result.metrics["valid_score"] > 0.85
    est = SklearnTrainer.get_model(result.checkpoint)
    assert est.predict(X[:5]).shape == (5,)
    preds = port_run["preds"]
    assert preds.shape == (N_SCORE,)
    assert (preds == y[:N_SCORE]).mean() > 0.8


def test_validation_score_and_model_equal_the_jax_trainers(port_run, jax_run):
    from ray_tpu.train import SklearnTrainer as JaxSklearnTrainer

    X, _, _ = _data()
    metrics, jax_ckpt = jax_run
    ours = port_run["result"]
    assert ours.metrics["fit_rows"] == metrics["fit_rows"] == N_TRAIN
    assert abs(ours.metrics["valid_score"] - metrics["valid_score"]) <= 1e-12
    mine = SklearnTrainer.get_model(ours.checkpoint)
    theirs = JaxSklearnTrainer.get_model(jax_ckpt)
    np.testing.assert_array_equal(mine.predict(X), theirs.predict(X))
    np.testing.assert_allclose(mine.predict_proba(X), theirs.predict_proba(X),
                               rtol=0, atol=1e-12)
    assert ours.checkpoint.to_dict()["feature_columns"] == \
        jax_ckpt.to_dict()["feature_columns"] == ["f0", "f1", "f2", "f3"]


def test_batch_predictions_equal_the_jax_predictors(port_run, jax_run):
    """The JAX ``SklearnPredictor`` from the JAX checkpoint, through the
    JAX ``BatchPredictor``'s scoring wrapper, batch by batch of the same
    size, gives the port's BatchPredictor's predictions."""
    import cloudpickle

    from ray_tpu.train.predictor import _ScoringWrapper as JaxScoringWrapper
    from ray_tpu.train.sklearn_trainer import SklearnPredictor as JaxSklearnPredictor

    X = _data()[0][:N_SCORE]
    wrapper = JaxScoringWrapper(cloudpickle.dumps(jax_run[1]), JaxSklearnPredictor, {},
                                None, None)
    theirs = np.concatenate([
        wrapper({f"f{j}": X[i:i + BATCH, j] for j in range(4)})["predictions"]
        for i in range(0, N_SCORE, BATCH)])
    np.testing.assert_array_equal(port_run["preds"], theirs)


def test_predictor_refuses_what_the_jax_predictor_refuses():
    """A dict batch needs the checkpoint's column order, and every trained
    column: both packages raise the same error; plain arrays score."""
    from ray_tpu.train.sklearn_trainer import SklearnPredictor as JaxSklearnPredictor

    class RowSum:
        def predict(self, X):
            return X.sum(axis=1)

    for cls in (SklearnPredictor, JaxSklearnPredictor):
        with pytest.raises(ValueError, match="no feature-column"):
            cls(RowSum()).predict({"a": np.ones(2)})
        with pytest.raises(ValueError, match=r"lacks trained feature columns \['b'\]"):
            cls(RowSum(), ["a", "b"]).predict({"a": np.ones(2)})
        got = cls(RowSum(), ["b", "a"]).predict({"a": np.array([1.0, 2.0]),
                                               "b": np.array([10.0, 20.0])})
        np.testing.assert_array_equal(got, [11.0, 22.0])
        np.testing.assert_array_equal(cls(RowSum()).predict(np.ones((2, 3))), [3.0, 3.0])


def test_trainer_refuses_what_the_jax_trainer_refuses():
    from ray_tpu.train import SklearnTrainer as JaxSklearnTrainer

    for cls in (SklearnTrainer, JaxSklearnTrainer):
        with pytest.raises(ValueError, match="'train' split"):
            cls(estimator=None, datasets={"valid": None}, label_column="y")

