"""Search-space primitives (``python/ray/tune/search/sample.py`` analog).

The port's own copy of ``ray_tpu/tune/search/sample.py``. Its draws use the
same seeded ``random.Random`` as the JAX package's, so the variants are
equal to its.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, low: float, high: float, log: bool = False):
        self.low, self.high, self.log = low, high, log

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        return rng.uniform(self.low, self.high)


class Integer(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.low, self.high)


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


def uniform(low: float, high: float) -> Float:
    return Float(low, high)


def loguniform(low: float, high: float) -> Float:
    return Float(low, high, log=True)


def randint(low: int, high: int) -> Integer:
    return Integer(low, high)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}
