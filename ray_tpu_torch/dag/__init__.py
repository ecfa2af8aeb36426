"""Lazy task/actor DAGs — the ``ray.dag`` analog.

Reference: ``python/ray/dag/`` (``dag_node.py``, ``function_node.py``,
``class_node.py``, ``input_node.py``) — the substrate of Serve deployment
graphs.  ``fn.bind(...)`` builds nodes instead of submitting; ``execute``
walks the graph, submits every task once, and returns the root's ref.
"""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
)

__all__ = [
    "DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode", "InputNode",
    "CompiledDAG", "CompiledDAGRef", "CompiledGraphError",
]


def __getattr__(name):
    # compiled-graph types load lazily: the channel/compile machinery is
    # only paid for by processes that actually compile a graph
    if name in ("CompiledDAG", "CompiledDAGRef", "CompiledGraphError"):
        from ray_tpu_torch.dag import compiled

        return getattr(compiled, name)
    raise AttributeError(name)
