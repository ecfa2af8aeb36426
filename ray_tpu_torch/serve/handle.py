"""DeploymentHandle: call a deployment from Python.

Analog of the reference's ``serve/handle.py`` (RayServeHandle /
RayServeSyncHandle): ``handle.remote(*args)`` routes a ``__call__`` request
through a Router and returns an ObjectRef; ``handle.method.remote(...)``
targets a named method.  Handles pickle (deployment composition passes them
into other replicas' constructors) and rebuild their Router lazily in the
destination process.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Optional, Tuple

# weak values: a Router lives only while some handle references it, so a
# deleted deployment's router (and its background threads, which hold only a
# weakref) unwinds once its handles are dropped
_router_cache: "weakref.WeakValueDictionary[Tuple[str, str], Any]" = (
    weakref.WeakValueDictionary()
)
_router_cache_lock = threading.Lock()


class _MethodCaller:
    __slots__ = ("_handle", "_method")

    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._remote(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller_handle=None,
                 method_name: Optional[str] = None):
        self.deployment_name = deployment_name
        self._controller = controller_handle
        self._router = None
        self._method_name = method_name  # options(method_name=...) override

    # -- plumbing ------------------------------------------------------
    def _get_router(self):
        if self._router is None:
            from ray_tpu_torch.serve._private.router import Router

            if self._controller is None:
                import ray_tpu_torch
                from ray_tpu_torch.serve._private.controller import (
                    CONTROLLER_NAME, SERVE_NAMESPACE)

                self._controller = ray_tpu_torch.get_actor(
                    CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
            # one Router per (controller, deployment) per process: handles
            # are cheap to churn, and each Router owns background
            # listener/metrics threads that must stay bounded
            key = (self._controller._id_hex, self.deployment_name)
            with _router_cache_lock:
                router = _router_cache.get(key)
                if router is None:
                    router = Router(self._controller, self.deployment_name)
                    _router_cache[key] = router
            self._router = router
        return self._router

    def _remote(self, method: str, args, kwargs):
        return self._get_router().assign_request(method, args, kwargs)

    # -- public --------------------------------------------------------
    def remote(self, *args, **kwargs):
        """Route one request to ``__call__`` (or the ``options``-selected
        method); returns an ObjectRef."""
        return self._remote(self._method_name or "__call__", args, kwargs)

    def __getattr__(self, item: str) -> _MethodCaller:
        if item.startswith("_") or item in ("deployment_name",):
            raise AttributeError(item)
        return _MethodCaller(self, item)

    def options(self, *, method_name: Optional[str] = None,
                **kwargs) -> "DeploymentHandle":
        """A copy of this handle with options applied.  ``method_name``
        retargets ``.remote()`` at a named replica method (equivalent to
        attribute access, but composable — the reference's
        ``handle.options(method_name=...)``).  Unknown options raise
        instead of being silently dropped."""
        if kwargs:
            raise ValueError(
                f"unknown DeploymentHandle options: {sorted(kwargs)} "
                f"(supported: method_name)")
        h = DeploymentHandle(self.deployment_name, self._controller,
                             method_name=method_name)
        h._router = self._router  # share the cached per-process router
        return h

    def __reduce__(self):
        # Router state is per-process; rebuild lazily on the other side.
        return (DeploymentHandle,
                (self.deployment_name, self._controller, self._method_name))

    # Handles to the same deployment (with the same options) are
    # interchangeable; the controller's code-change diff relies on this
    # (fresh handle instances are created on every deploy of a composed
    # app — those carry no method override, so its comparisons are
    # unchanged).  A method-retargeted handle is behaviorally different
    # and must not dedup against the plain one.
    def __eq__(self, other):
        return (
            isinstance(other, DeploymentHandle)
            and other.deployment_name == self.deployment_name
            and other._method_name == self._method_name
        )

    def __hash__(self):
        return hash(("DeploymentHandle", self.deployment_name,
                     self._method_name))

    def __repr__(self) -> str:
        return f"DeploymentHandle({self.deployment_name!r})"
