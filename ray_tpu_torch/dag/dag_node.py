"""DAG node types.

A node records a bound computation (``dag_node.py:DAGNode`` in the
reference); nothing runs until ``execute``.  During execution each node
submits exactly once per call (diamond dependencies share the result —
the upstream task's ObjectRef is passed straight into downstream task
args, so the object plane does all data movement).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: bound args may contain other DAGNodes (the graph edges)."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal -----------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for a in self._bound_kwargs.values():
            scan(a)
        return out

    def topological(self) -> List["DAGNode"]:
        """Dependencies-first ordering of the reachable graph.

        Iterative post-order DFS: a recursive visit overflows Python's
        recursion limit around 1k-node chains, and compiled pipeline
        graphs legitimately get that deep."""
        seen: Dict[int, DAGNode] = {}  # keeps nodes alive so ids stay unique
        order: List[DAGNode] = []
        stack: List[Tuple[DAGNode, bool]] = [(self, False)]
        while stack:
            n, emit = stack.pop()
            if emit:
                order.append(n)
                continue
            if id(n) in seen:
                continue
            seen[id(n)] = n
            stack.append((n, True))
            # reversed: the stack pops right-to-left, so this preserves the
            # recursive left-to-right sibling order — workflow checkpoint
            # step ids are keyed on the topological index and must not
            # shift across this rewrite
            for c in reversed(n._children()):
                if id(c) not in seen:
                    stack.append((c, False))
        return order

    # -- execution -----------------------------------------------------
    def _resolve(self, v, results: Dict[int, Any]):
        if isinstance(v, DAGNode):
            return results[id(v)]
        if isinstance(v, list):
            return [self._resolve(x, results) for x in v]
        if isinstance(v, tuple):
            return tuple(self._resolve(x, results) for x in v)
        if isinstance(v, dict):
            return {k: self._resolve(x, results) for k, x in v.items()}
        return v

    def _execute_impl(self, args: tuple, kwargs: dict):
        raise NotImplementedError

    def experimental_compile(self, **kwargs) -> "CompiledDAG":
        """Compile this static DAG once: actors get persistent execution
        loops, edges become pre-allocated channels, and repeated
        ``execute()`` calls bypass the scheduler entirely.  See
        :mod:`ray_tpu_torch.dag.compiled` for semantics and limitations."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def execute(self, *input_args, **input_kwargs):
        """Run the DAG; returns whatever the root node produces (an
        ObjectRef for function/method nodes, an actor handle for a
        ClassNode root)."""
        results: Dict[int, Any] = {}
        for node in self.topological():
            if isinstance(node, InputNode):
                if len(input_args) == 1 and not input_kwargs:
                    results[id(node)] = input_args[0]
                else:
                    results[id(node)] = _DAGInput(input_args, input_kwargs)
                continue
            args = tuple(node._resolve(a, results) for a in node._bound_args)
            kwargs = {k: node._resolve(v, results) for k, v in node._bound_kwargs.items()}
            results[id(node)] = node._execute_impl(args, kwargs)
        return results[id(self)]


class _DAGInput:
    """Multi-arg DAG input (InputNode with several values)."""

    def __init__(self, args: tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs


class InputNode(DAGNode):
    """Placeholder for the value passed to ``dag.execute(...)``
    (``input_node.py`` analog).  Usable as a context manager::

        with InputNode() as inp:
            dag = f.bind(inp)
        dag.execute(5)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def _execute_impl(self, args, kwargs):  # replaced by execute()
        raise RuntimeError("InputNode executed without an input")


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args: tuple, kwargs: dict,
                 options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = options or {}

    def _execute_impl(self, args, kwargs):
        fn = self._remote_fn.options(**self._options) if self._options else self._remote_fn
        return fn.remote(*args, **kwargs)

    def options(self, **opts) -> "FunctionNode":
        merged = dict(self._options)
        merged.update(opts)
        return FunctionNode(self._remote_fn, self._bound_args,
                            self._bound_kwargs, merged)


class ClassNode(DAGNode):
    """A bound actor constructor; ``.method.bind(...)`` chains calls."""

    def __init__(self, actor_cls, args: tuple, kwargs: dict,
                 options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._options = options or {}
        self._lock = threading.Lock()
        self._handle = None  # one actor per DAG instance

    def _execute_impl(self, args, kwargs):
        with self._lock:
            if self._handle is None:
                cls = (self._actor_cls.options(**self._options)
                       if self._options else self._actor_cls)
                self._handle = cls.remote(*args, **kwargs)
            return self._handle

    def options(self, **opts) -> "ClassNode":
        """Override actor options on the bound constructor (parity with
        ``FunctionNode.options``): returns a NEW ClassNode, so methods
        bound from this one keep targeting the original node/actor."""
        merged = dict(self._options)
        merged.update(opts)
        return ClassNode(self._actor_cls, self._bound_args,
                         self._bound_kwargs, merged)

    def __getattr__(self, name: str) -> "_ClassMethodBinder":
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str,
                 args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self) -> List[DAGNode]:
        return [self._class_node] + super()._children()

    def _execute_impl(self, args, kwargs):
        # the class node ran first (topological order) -> handle exists
        handle = self._class_node._handle
        return getattr(handle, self._method_name).remote(*args, **kwargs)
