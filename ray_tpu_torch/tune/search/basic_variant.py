"""Basic variant generation: grid cross-product x random sampling.

Analog of ``python/ray/tune/search/basic_variant.py``: every
``grid_search`` key expands combinatorially; ``Domain`` leaves are sampled
``num_samples`` times per grid point.

The port's own copy of ``ray_tpu/tune/search/basic_variant.py``.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Tuple

from ray_tpu_torch.tune.search.sample import Domain


def _split(space: Dict, prefix: Tuple = ()) -> Tuple[List, List]:
    """-> ([(path, grid values)], [(path, domain)])"""
    grids, domains = [], []
    for k, v in space.items():
        path = prefix + (k,)
        if isinstance(v, dict) and set(v) == {"grid_search"}:
            grids.append((path, v["grid_search"]))
        elif isinstance(v, dict):
            g, d = _split(v, path)
            grids += g
            domains += d
        elif isinstance(v, Domain):
            domains.append((path, v))
    return grids, domains


def _set(config: Dict, path: Tuple, value: Any) -> None:
    for k in path[:-1]:
        config = config.setdefault(k, {})
    config[path[-1]] = value


def _base(space: Dict) -> Dict:
    out = {}
    for k, v in space.items():
        if isinstance(v, dict) and set(v) == {"grid_search"}:
            continue
        if isinstance(v, Domain):
            continue
        out[k] = _base(v) if isinstance(v, dict) else v
    return out


class BasicVariantGenerator:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def variants(self, space: Dict, num_samples: int = 1) -> Iterator[Dict]:
        grids, domains = _split(space)
        grid_values = [vals for _, vals in grids] or [[None]]
        grid_paths = [p for p, _ in grids]
        for combo in itertools.product(*grid_values):
            for _ in range(num_samples):
                cfg = _base(space)
                for path, val in zip(grid_paths, combo):
                    _set(cfg, path, val)
                for path, dom in domains:
                    _set(cfg, path, dom.sample(self.rng))
                yield cfg
