"""Actors: ``ActorClass``, ``ActorHandle``, ``ActorMethod``.

Analog of ``python/ray/actor.py`` (``ActorClass._remote`` at ``actor.py:657``,
``ActorMethod`` at ``:92``, ``ActorHandle`` at ``:1020``).  Creation goes
through the head's GCS-style actor FSM; method calls are ordered per-actor
(the reference orders per-caller via sequence numbers in
``CoreWorkerDirectActorTaskSubmitter``; routing everything through the head
gives a single total order, which is strictly stronger).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import ray_option_utils
from ray_tpu_torch._private.object_ref import ObjectRef, new_id
from ray_tpu_torch._private.worker import global_worker


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs, self._num_returns,
            concurrency_group=self._concurrency_group,
        )

    def options(self, num_returns: int = 1,
                concurrency_group: Optional[str] = None, **_):
        if num_returns == "dynamic":
            raise ValueError('num_returns="dynamic" is not supported for '
                             "actor methods")
        if not isinstance(num_returns, int) or num_returns < 1:
            raise ValueError(f"num_returns must be an int >= 1, got {num_returns!r}")
        if concurrency_group is not None:
            declared = self._handle._concurrency_groups
            # validated only when the handle carries the declaration (a
            # deserialized handle may not); the worker routes unknown
            # groups to the default pool
            if declared and concurrency_group not in declared:
                raise ValueError(
                    f"unknown concurrency group {concurrency_group!r}; "
                    f"declared: {sorted(declared)}")
        return ActorMethod(self._handle, self._method_name, num_returns,
                           concurrency_group=concurrency_group)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} must be invoked with .remote()"
        )


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str, method_num_returns: Optional[Dict[str, int]] = None,
                 concurrency_groups: Optional[Tuple[str, ...]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_num_returns = method_num_returns or {}
        # declared concurrency-group NAMES (for method.options validation);
        # the sizes live head-side in the creation spec
        self._concurrency_groups = tuple(concurrency_groups or ())

    @property
    def _id_hex(self) -> str:
        return self._actor_id.hex()

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item, self._method_num_returns.get(item, 1))

    def _submit_method(self, method_name: str, args, kwargs, num_returns: int,
                       concurrency_group: Optional[str] = None):
        w = global_worker
        spec, return_refs = w.build_task_spec(
            name=f"{self._class_name}.{method_name}",
            fn_id=None,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources={},
            actor_id=self._actor_id,
            method_name=method_name,
            concurrency_group=concurrency_group,
        )
        w.client.submit_actor_task(spec)
        return return_refs[0] if num_returns == 1 else return_refs

    def _submit_compiled_task(self, fn, args: tuple, name: str) -> ObjectRef:
        """Submit a compiled-graph control task: a module-level ``fn`` that
        the worker runs with the actor INSTANCE as first argument (spec flag
        ``compiled_graph``; see ``_private/worker.py``).  Rides the normal
        per-actor FIFO lane but returns fast — the graph's execution loop
        itself runs on a dedicated thread the installed op spawns, so
        repeated ``execute()`` calls never touch this lane again."""
        w = global_worker
        blob = cloudpickle.dumps(fn)
        fn_id = w.register_function(blob)
        spec, return_refs = w.build_task_spec(
            name=f"{self._class_name}.{name}",
            fn_id=fn_id,
            args=args,
            kwargs={},
            num_returns=1,
            resources={},
            actor_id=self._actor_id,
        )
        spec["compiled_graph"] = True
        w.client.submit_actor_task(spec)
        return return_refs[0]

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id, self._class_name,
                                  self._method_num_returns,
                                  self._concurrency_groups))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]})"


def _rebuild_handle(actor_id, class_name, mnr, concurrency_groups=()):
    return ActorHandle(actor_id, class_name, mnr,
                       concurrency_groups=concurrency_groups)


class ActorClass:
    def __init__(self, cls: type, default_options: Dict[str, Any]):
        self._cls = cls
        self._default_options = ray_option_utils.validate_options(default_options, for_actor=True)
        self._class_blob: Optional[bytes] = None
        self.__name__ = cls.__name__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote(...)"
        )

    def options(self, **options) -> "_ActorClassWrapper":
        merged = dict(self._default_options)
        merged.update(ray_option_utils.validate_options(options, for_actor=True))
        return _ActorClassWrapper(self, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def bind(self, *args, **kwargs):
        """Build a lazy actor DAG node (``ray.dag`` ClassNode)."""
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def _remote(self, args, kwargs, options: Dict[str, Any]) -> ActorHandle:
        from ray_tpu_torch.remote_function import _strategy_to_dict

        w = global_worker
        if not w.connected:
            import threading

            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError(
                    "ray_tpu_torch is not initialized (auto-init only runs on "
                    "the main thread)")
            import ray_tpu_torch

            ray_tpu_torch.init()
        if self._class_blob is None:
            self._class_blob = cloudpickle.dumps(self._cls)
        fn_id = w.register_function(self._class_blob)
        actor_id = new_id()
        # async actors default to high concurrency (the reference's asyncio
        # actor default); sync actors serialize unless max_concurrency is set
        max_concurrency = options.get("max_concurrency")
        if max_concurrency is None:
            import inspect

            is_async = any(
                inspect.iscoroutinefunction(m)
                for _, m in inspect.getmembers(self._cls, inspect.isfunction)
            )
            max_concurrency = 1000 if is_async else 1
        # Actors default to 1 CPU for placement but occupy 0 once created
        # (reference semantics); an explicit num_cpus is held for life.
        cpu_defaulted = options.get("num_cpus") is None
        resources = ray_option_utils.resources_from_options(options, default_num_cpus=1)
        concurrency_groups = options.get("concurrency_groups")
        spec, return_refs = w.build_task_spec(
            name=f"{self._cls.__name__}.__init__",
            fn_id=fn_id,
            args=args,
            kwargs=kwargs,
            num_returns=1,
            resources=resources,
            scheduling_strategy=_strategy_to_dict(options.get("scheduling_strategy")),
            actor_id=actor_id,
            is_actor_creation=True,
            max_restarts=options.get("max_restarts", 0),
            max_task_retries=options.get("max_task_retries", 0),
            actor_name=options.get("name"),
            runtime_env=options.get("runtime_env"),
            max_concurrency=max_concurrency,
            release_cpu_after_start=cpu_defaulted,
            concurrency_groups=concurrency_groups,
            lifetime=options.get("lifetime"),
            namespace=options.get("namespace"),
        )
        w.client.create_actor(spec)
        return ActorHandle(
            actor_id, self._cls.__name__,
            concurrency_groups=tuple(concurrency_groups or ()),
        )


class _ActorClassWrapper:
    def __init__(self, ac: ActorClass, options: Dict[str, Any]):
        self._ac = ac
        self._options = options

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._ac._remote(args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self._ac, args, kwargs, self._options)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor (``ray.get_actor`` analog).

    Lookups are namespace-scoped: with no ``namespace`` the caller's own
    is used (the driver's, or — inside a task/actor — the submitting
    job's), so one tenant's names never resolve to another tenant's
    actors.  A name that only exists in a different namespace raises
    ``ValueError`` exactly like a missing one."""
    w = global_worker
    ns = (namespace or w.current_namespace or w.namespace or "default")
    aid, _ = w.client.get_actor_by_name(name, namespace=ns)
    if aid is None:
        raise ValueError(
            f"Failed to look up actor with name '{name}' in namespace "
            f"'{ns}'")
    return ActorHandle(aid, name)
