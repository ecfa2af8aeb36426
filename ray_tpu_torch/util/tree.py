"""Trees of dicts, lists and tuples with array leaves.

The port's counterpart of ``jax.tree_util.tree_map`` and ``tree_leaves``
for what it carries: model params (a dict of lists of dicts for the RL
nets, a 0-d ``log_alpha`` for SAC), optimizer moments, predictor batches
and outputs.  A leaf is a ``torch.Tensor``, a numpy array or a numpy
scalar.  Anything else (a ``ConvSpec``, a string, ``None``) is metadata:
it is kept as it is and never given to ``fn``, as a static node of a JAX
pytree is.  Named tuples (optax's states) keep their type.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping

import numpy as np
import torch

LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic)


def is_leaf(x: Any) -> bool:
    return isinstance(x, LEAF_TYPES)


def _rebuild(node, children):
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a named tuple
        return type(node)(*children)
    return type(node)(children)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree``, with the matching leaves of the
    trees in ``rest`` as further arguments; the result has ``tree``'s
    structure and metadata (a mapping comes back as a dict).  ``rest``
    must hold the same containers (dict keys are looked up by name, so
    their order may differ); a leaf of ``tree`` matched by a non-leaf
    raises ``ValueError``."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"tree_map: a sequence of {len(tree)} against {type(r).__name__}")
        return _rebuild(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if is_leaf(tree):
        bad = [type(r).__name__ for r in rest if not is_leaf(r)]
        if bad:
            raise ValueError(f"tree_map: a leaf against {bad}")
        return fn(tree, *rest)
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``tree_map``'s order: dicts in their own key order,
    sequences by position."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
