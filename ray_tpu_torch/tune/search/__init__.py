"""Search: grid and random variants, and the adaptive ``TPESearcher``
(the port's own copy of ``ray_tpu/tune/search/``)."""

from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import Searcher, TPESearcher
from ray_tpu_torch.tune.search.sample import (
    Categorical,
    Domain,
    Float,
    Integer,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)

__all__ = [
    "BasicVariantGenerator",
    "Searcher",
    "TPESearcher",
    "Domain",
    "Float",
    "Integer",
    "Categorical",
    "uniform",
    "loguniform",
    "choice",
    "randint",
    "grid_search",
]
