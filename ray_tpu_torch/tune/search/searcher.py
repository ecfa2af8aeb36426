"""Adaptive searchers: suggest-on-demand with result feedback.

Analog of the reference's ``python/ray/tune/search/searcher.py`` (Searcher:
``suggest``/``on_trial_complete``) plus an independent TPE implementation in
the spirit of the hyperopt integration (``tune/search/hyperopt``) — written
from the TPE recipe (good/bad split at a quantile, propose from the good
set's density, rank by the density ratio) with no external dependency.

The port's own copy of ``ray_tpu/tune/search/searcher.py``.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer


class Searcher:
    """Adaptive search interface (``search/searcher.py`` analog).  The
    TrialRunner calls :meth:`suggest` when it has a free slot and
    :meth:`on_trial_complete` when a trial finishes."""

    def __init__(self, metric: str, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None
    ) -> None:
        pass


def _flatten(space: Dict, prefix: Tuple = ()) -> Dict[Tuple, Domain]:
    out: Dict[Tuple, Domain] = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[prefix + (k,)] = v
        elif isinstance(v, dict) and "grid_search" not in v:
            out.update(_flatten(v, prefix + (k,)))
    return out


def _assemble(space: Dict, values: Dict[Tuple, Any], prefix: Tuple = ()) -> Dict:
    out = {}
    for k, v in space.items():
        path = prefix + (k,)
        if isinstance(v, Domain):
            out[k] = values[path]
        elif isinstance(v, dict) and "grid_search" not in v:
            out[k] = _assemble(v, values, path)
        else:
            out[k] = v
    return out


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator over independent dimensions.

    For each dimension: observations are split into the best ``gamma``
    fraction ("good") and the rest; candidates are drawn from a mixture of
    Gaussians centered on good observations (categorical: reweighted
    counts) and scored by the good/bad density ratio; the best of
    ``n_candidates`` wins.  The first ``n_initial_points`` suggestions are
    random (the startup phase every TPE needs).
    """

    def __init__(
        self,
        space: Dict[str, Any],
        metric: str,
        mode: str = "min",
        n_initial_points: int = 5,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: int = 0,
    ):
        super().__init__(metric, mode)
        self.space = space
        self.dims = _flatten(space)
        if not self.dims:
            raise ValueError("TPESearcher needs at least one Domain in the space")
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._live: Dict[str, Dict[Tuple, Any]] = {}  # trial -> dim values
        self._obs: List[Tuple[Dict[Tuple, Any], float]] = []  # (values, score)

    # -- Searcher interface -------------------------------------------
    def suggest(self, trial_id: str) -> Dict[str, Any]:
        if len(self._obs) < self.n_initial:
            values = {p: d.sample(self.rng) for p, d in self.dims.items()}
        else:
            values = {p: self._suggest_dim(p, d) for p, d in self.dims.items()}
        self._live[trial_id] = values
        return _assemble(self.space, values)

    def on_trial_complete(self, trial_id: str, result=None) -> None:
        values = self._live.pop(trial_id, None)
        if values is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score  # internally always minimize
        self._obs.append((values, score))

    # -- TPE internals ------------------------------------------------
    def _split(self) -> Tuple[list, list]:
        ranked = sorted(self._obs, key=lambda o: o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_dim(self, path: Tuple, dom: Domain) -> Any:
        good, bad = self._split()
        gv = [o[0][path] for o in good]
        bv = [o[0][path] for o in bad]
        if isinstance(dom, Categorical):
            return self._categorical(dom, gv, bv)
        return self._numeric(dom, gv, bv)

    def _categorical(self, dom: Categorical, gv: list, bv: list) -> Any:
        k = len(dom.categories)
        # Laplace-smoothed counts; score = p_good / p_bad
        def probs(vals):
            c = {cat: 1.0 for cat in dom.categories}
            for v in vals:
                c[v] = c.get(v, 1.0) + 1.0
            tot = sum(c.values())
            return {cat: c[cat] / tot for cat in dom.categories}

        pg, pb = probs(gv), probs(bv)
        # sample candidates from pg, keep the best ratio
        cats = list(dom.categories)
        weights = [pg[c] for c in cats]
        best, best_score = None, -1.0
        for _ in range(min(self.n_candidates, 4 * k)):
            cand = self.rng.choices(cats, weights=weights)[0]
            score = pg[cand] / pb[cand]
            if score > best_score:
                best, best_score = cand, score
        return best

    def _numeric(self, dom: Domain, gv: list, bv: list) -> Any:
        log = isinstance(dom, Float) and dom.log
        lo = math.log(dom.low) if log else float(dom.low)
        hi = math.log(dom.high) if log else float(dom.high)
        to_x = (lambda v: math.log(v)) if log else float
        gx, bx = [to_x(v) for v in gv], [to_x(v) for v in bv]
        span = hi - lo
        # Parzen bandwidth: span scaled down with observation count
        bw_g = max(span / (1 + len(gx)), span * 0.03)
        bw_b = max(span / (1 + len(bx)), span * 0.03)

        def density(x: float, centers: list, bw: float) -> float:
            if not centers:
                return 1.0 / span
            s = 0.0
            for c in centers:
                z = (x - c) / bw
                s += math.exp(-0.5 * z * z)
            return s / (len(centers) * bw * math.sqrt(2 * math.pi)) + 1e-12

        best, best_score = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(gx) if gx else self.rng.uniform(lo, hi)
            x = self.rng.gauss(center, bw_g)
            x = min(hi, max(lo, x))
            score = density(x, gx, bw_g) / density(x, bx, bw_b)
            if score > best_score:
                best, best_score = x, score
        v = math.exp(best) if log else best
        if isinstance(dom, Integer):
            return max(dom.low, min(dom.high - 1, int(round(v))))
        return v
