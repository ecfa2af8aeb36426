"""``@remote`` functions (analog of ``python/ray/remote_function.py``).

``RemoteFunction._remote`` (reference ``remote_function.py:239``) builds a
task spec and submits it through the core client; ``.options(...)`` returns
a shallow override wrapper, same surface as the reference.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch._private import ray_option_utils
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import global_worker


class RemoteFunction:
    def __init__(self, fn, default_options: Dict[str, Any]):
        self._function = fn
        self._default_options = ray_option_utils.validate_options(default_options, for_actor=False)
        self._fn_blob: Optional[bytes] = None
        self._fn_id: Optional[bytes] = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function.__name__} cannot be called directly; "
            f"use {self._function.__name__}.remote(...)"
        )

    def options(self, **options) -> "_RemoteFunctionWrapper":
        merged = dict(self._default_options)
        merged.update(ray_option_utils.validate_options(options, for_actor=False))
        return _RemoteFunctionWrapper(self, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of submitting (``ray.dag``)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def _remote(self, args, kwargs, options: Dict[str, Any]):
        w = global_worker
        if not w.connected:
            import threading

            if threading.current_thread() is not threading.main_thread():
                # a BACKGROUND thread submitting after shutdown (e.g. a
                # stale poller from a torn-down session) must never boot a
                # fresh default session — that zombie head silently absorbs
                # every later init() in the process
                raise RuntimeError(
                    "ray_tpu_torch is not initialized (auto-init only runs on "
                    "the main thread)")
            import ray_tpu_torch

            ray_tpu_torch.init()
        if self._fn_id is None:
            self._fn_blob = cloudpickle.dumps(self._function)
        self._fn_id = w.register_function(self._fn_blob)
        num_returns = options.get("num_returns", 1)
        dynamic = num_returns == "dynamic"
        resources = ray_option_utils.resources_from_options(options, default_num_cpus=1)
        strategy = _strategy_to_dict(options.get("scheduling_strategy"))
        spec, return_refs = w.build_task_spec(
            name=options.get("name") or self._function.__name__,
            fn_id=self._fn_id,
            args=args,
            kwargs=kwargs,
            num_returns=1 if dynamic else num_returns,
            resources=resources,
            scheduling_strategy=strategy,
            max_retries=options.get("max_retries", 3),
            runtime_env=options.get("runtime_env"),
        )
        if dynamic:
            spec["dynamic_returns"] = True
        w.client.submit_task(spec)
        if dynamic:
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(
                task_id=spec["task_id"], primary=return_refs[0])
        if num_returns == 1:
            return return_refs[0]
        return return_refs


class _RemoteFunctionWrapper:
    def __init__(self, rf: RemoteFunction, options: Dict[str, Any]):
        self._rf = rf
        self._options = options

    def remote(self, *args, **kwargs):
        return self._rf._remote(args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self._rf, args, kwargs, self._options)


def _strategy_to_dict(strategy) -> Optional[dict]:
    """Convert public scheduling-strategy objects to the wire dict."""
    if strategy is None:
        return None
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return {
            "kind": "placement_group",
            "pg_id": strategy.placement_group.id,
            "bundle_index": strategy.placement_group_bundle_index,
        }
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return {"kind": "node_affinity", "node_id": strategy.node_id, "soft": strategy.soft}
    if isinstance(strategy, str):
        return {"kind": strategy}
    raise ValueError(f"Unknown scheduling strategy: {strategy!r}")
