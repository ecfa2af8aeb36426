"""SklearnTrainer + SklearnPredictor: CPU estimator training under the
Train/Tune umbrella (the port's copy of ``ray_tpu/train/sklearn_trainer.py``).

Analog of the reference's ``python/ray/train/sklearn/sklearn_trainer.py``
and the GBDT trainer family (``train/gbdt_trainer.py``, xgboost/lightgbm —
not in this image; sklearn's HistGradientBoosting* covers the gradient-
boosted-trees role).  The fit runs inside a Tune trial actor like every
other trainer, consumes ``ray_tpu_torch.data`` Datasets, reports validation
metrics through ``session.report``, and checkpoints the fitted estimator
as the standard AIR Checkpoint currency (so :class:`BatchPredictor` scores
Datasets with it).

Neither class imports scikit-learn: the caller brings a fitted-or-not
estimator, and unpickling a checkpoint's estimator imports it only then,
so ``import ray_tpu_torch.train`` works on a machine without it.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.train.predictor import Predictor

_ESTIMATOR_KEY = "estimator_pkl"
_COLUMNS_KEY = "feature_columns"


def _to_xy(ds, label_column: str, feature_columns: Optional[List[str]]):
    """Returns (X, y, columns-in-training-order) — the column order is
    persisted in the checkpoint so prediction can never permute features."""
    rows = ds.take_all()
    if not rows:
        raise ValueError("empty dataset")
    if isinstance(rows[0], dict):
        cols = list(feature_columns or [c for c in rows[0] if c != label_column])
        X = np.asarray([[r[c] for c in cols] for r in rows], np.float64)
        y = np.asarray([r[label_column] for r in rows])
        return X, y, cols
    raise ValueError("SklearnTrainer needs datasets of dict rows "
                     "(use from_items / read_csv)")


class SklearnTrainer:
    """Fit an sklearn estimator on Datasets as a Train trainer.

    Example::

        trainer = SklearnTrainer(
            estimator=HistGradientBoostingClassifier(),
            datasets={"train": train_ds, "valid": valid_ds},
            label_column="y",
        )
        result = trainer.fit()
        est = SklearnTrainer.get_model(result.checkpoint)
    """

    def __init__(
        self,
        *,
        estimator: Any,
        datasets: Dict[str, Any],
        label_column: str,
        feature_columns: Optional[List[str]] = None,
        scaling_config: Any = None,
        run_config: Any = None,
    ):
        if "train" not in datasets:
            raise ValueError("datasets must include a 'train' split")
        self.estimator = estimator
        self.datasets = datasets
        self.label_column = label_column
        self.feature_columns = feature_columns
        self.scaling_config = scaling_config
        self.run_config = run_config

    # -- Trainable seam -------------------------------------------------
    def _train_loop(self, config: Optional[dict] = None) -> None:
        from ray_tpu_torch.air import session

        est = self.estimator
        X, y, cols = _to_xy(self.datasets["train"], self.label_column,
                            self.feature_columns)
        est.fit(X, y)
        metrics: Dict[str, Any] = {"fit_rows": int(len(y))}
        for split, ds in self.datasets.items():
            if split == "train":
                continue
            Xv, yv, _ = _to_xy(ds, self.label_column, cols)
            metrics[f"{split}_score"] = float(est.score(Xv, yv))
        session.report(
            metrics,
            checkpoint=Checkpoint.from_dict({
                _ESTIMATOR_KEY: pickle.dumps(est),
                _COLUMNS_KEY: cols,
            }),
        )

    def fit(self):
        """Run under Tune like every trainer (one trial, one actor)."""
        from ray_tpu_torch.air import RunConfig
        from ray_tpu_torch.tune import TuneConfig, Tuner

        tuner = Tuner(
            self._train_loop,
            tune_config=TuneConfig(num_samples=1, max_concurrent_trials=1),
            run_config=self.run_config or RunConfig(),
        )
        grid = tuner.fit()
        result = grid[0]
        if result.error is not None:
            raise result.error
        return result

    @staticmethod
    def get_model(checkpoint: Checkpoint):
        """Fitted estimator out of a trainer checkpoint."""
        return pickle.loads(checkpoint.to_dict()[_ESTIMATOR_KEY])


class SklearnPredictor(Predictor):
    """Score batches with a fitted estimator (``train/sklearn/
    sklearn_predictor.py`` analog); plugs into BatchPredictor.  Dict
    batches are ordered by the TRAINING column order saved in the
    checkpoint — never by dict/sort order, which would silently permute
    features."""

    def __init__(self, estimator: Any, feature_columns: Optional[List[str]] = None):
        self._est = estimator
        self._cols = feature_columns

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **_kw) -> "SklearnPredictor":
        data = checkpoint.to_dict()
        return cls(pickle.loads(data[_ESTIMATOR_KEY]), data.get(_COLUMNS_KEY))

    def predict(self, batch: Union[np.ndarray, Dict[str, np.ndarray]], **_kw):
        if isinstance(batch, dict):
            if self._cols is None:
                raise ValueError(
                    "dict batch but the checkpoint carries no feature-column "
                    "order; pass feature_columns or score plain arrays"
                )
            missing = [c for c in self._cols if c not in batch]
            if missing:
                raise ValueError(f"batch lacks trained feature columns {missing}")
            X = np.stack(
                [np.asarray(batch[c], np.float64) for c in self._cols], axis=1
            )
        else:
            X = np.asarray(batch, np.float64)
        return np.asarray(self._est.predict(X))
