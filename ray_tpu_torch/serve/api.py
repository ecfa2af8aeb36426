"""serve public API: @deployment, run, status, delete, shutdown.

Analog of ``python/ray/serve/api.py`` (``@serve.deployment`` ``:251-277``,
``serve.run`` ``:455``) + ``serve/deployment.py:35`` (Deployment): the
declarative surface users touch.  ``Deployment.bind`` builds an
``Application`` graph (nested bound deployments become DeploymentHandles in
the parent's constructor — the deployment-graph composition path); ``run``
ships it to the controller and blocks until every deployment is healthy.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import cloudpickle

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from ray_tpu_torch.serve.handle import DeploymentHandle

_client: Optional["_ServeClient"] = None


def _coerce_autoscaling(v) -> Optional[AutoscalingConfig]:
    if v is None or isinstance(v, AutoscalingConfig):
        return v
    if isinstance(v, dict):
        return AutoscalingConfig(**v)
    raise TypeError(f"autoscaling_config must be a dict or AutoscalingConfig, got {type(v)}")


class Deployment:
    """A deployment definition (``serve/deployment.py:35`` analog).
    Immutable; ``options()`` returns a modified copy."""

    def __init__(
        self,
        func_or_class: Union[Callable, type],
        name: str,
        config: Optional[DeploymentConfig] = None,
        route_prefix: Optional[str] = "__auto__",
    ):
        self._func_or_class = func_or_class
        self.name = name
        self.config = config or DeploymentConfig()
        # "__auto__" -> "/<name>"; None -> not HTTP-exposed
        self.route_prefix = f"/{name}" if route_prefix == "__auto__" else route_prefix

    def options(
        self,
        name: Optional[str] = None,
        num_replicas: Optional[int] = None,
        max_concurrent_queries: Optional[int] = None,
        user_config: Optional[Any] = None,
        ray_actor_options: Optional[Dict] = None,
        route_prefix: Optional[str] = "__unset__",
        autoscaling_config: Optional[Any] = "__unset__",
        max_queued_requests: Optional[int] = None,
        request_timeout_s: Optional[Any] = "__unset__",
    ) -> "Deployment":
        cfg = copy.deepcopy(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if autoscaling_config != "__unset__":
            cfg.autoscaling_config = _coerce_autoscaling(autoscaling_config)
        if max_concurrent_queries is not None:
            cfg.max_concurrent_queries = max_concurrent_queries
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if request_timeout_s != "__unset__":
            cfg.request_timeout_s = request_timeout_s
        d = Deployment(
            self._func_or_class,
            name or self.name,
            cfg,
            route_prefix="__auto__",
        )
        d.route_prefix = (
            self.route_prefix if route_prefix == "__unset__" else route_prefix
        )
        if name and d.route_prefix == f"/{self.name}":
            d.route_prefix = f"/{name}"
        return d

    def bind(self, *args, **kwargs) -> "Application":
        """Bind constructor args, producing an Application DAG node
        (``deployment.py`` bind / DAG build analog).  Args may contain other
        Applications — they deploy first and arrive as handles."""
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment(name={self.name!r}, num_replicas={self.config.num_replicas})"


class Application:
    """A bound deployment graph node (``serve.built_application`` analog)."""

    def __init__(self, deployment: Deployment, args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


def deployment(
    _func_or_class: Optional[Union[Callable, type]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_concurrent_queries: int = 100,
    user_config: Optional[Any] = None,
    ray_actor_options: Optional[Dict] = None,
    route_prefix: Optional[str] = "__auto__",
    autoscaling_config: Optional[Any] = None,
    max_queued_requests: int = -1,
    request_timeout_s: Optional[float] = None,
) -> Union[Deployment, Callable[[Callable], Deployment]]:
    """``@serve.deployment`` decorator (``api.py:251`` analog)."""

    def make(func_or_class):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling_config=_coerce_autoscaling(autoscaling_config),
            max_queued_requests=max_queued_requests,
            request_timeout_s=request_timeout_s,
        )
        return Deployment(
            func_or_class,
            name or func_or_class.__name__,
            cfg,
            route_prefix=route_prefix,
        )

    if _func_or_class is not None:
        return make(_func_or_class)
    return make


def ingress(app) -> Callable[[type], type]:
    """Mount an ASGI application as a deployment class's HTTP surface
    (``@serve.ingress(fastapi_app)`` analog, ``serve/api.py`` ingress).

    The wrapped class's ``__call__`` feeds every routed HTTP request
    through the ASGI protocol (scope/receive/send — see
    ``http_util.run_asgi_app``) and returns the app's reply as a
    :class:`Response`, so status codes and headers survive to the client.
    The app sees the FULL request path in ``scope["path"]`` (with
    ``root_path=""``) and can route on it; non-HTTP callers (plain
    ``handle.remote(...)``) still reach the class's other methods
    directly.

    Usage::

        @serve.deployment
        @serve.ingress(asgi_app)
        class MyApp:
            def health(self):   # handle.health.remote() still works
                return "ok"
    """

    def decorator(cls: type) -> type:
        if not isinstance(cls, type):
            raise TypeError(
                "@serve.ingress decorates a class (put it UNDER "
                "@serve.deployment); got " + repr(cls))

        class ASGIIngressWrapper(cls):
            __serve_asgi_app__ = staticmethod(app)

            def __call__(self, request):
                from ray_tpu_torch.serve._private.http_util import (
                    Request as _HttpRequest,
                    run_asgi_app,
                )

                if not isinstance(request, _HttpRequest):
                    raise TypeError(
                        "@serve.ingress deployments serve HTTP requests; "
                        "call named methods via handle.<method>.remote() "
                        "for direct access")
                return run_asgi_app(app, request)

        ASGIIngressWrapper.__name__ = cls.__name__
        ASGIIngressWrapper.__qualname__ = cls.__qualname__
        ASGIIngressWrapper.__module__ = cls.__module__
        return ASGIIngressWrapper

    return decorator


# ---------------------------------------------------------------------------
# client / lifecycle
# ---------------------------------------------------------------------------


class _ServeClient:
    """Driver-side connection to the serve control plane
    (``_private/client.py`` ServeControllerClient analog)."""

    def __init__(self, controller, proxy=None, http=None):
        self.controller = controller
        self.proxy = proxy
        self.http = http  # (host, port) or None


def start(http_options: Optional[HTTPOptions] = None, _http: bool = True) -> _ServeClient:
    """Start (or connect to) the serve instance: controller + HTTP proxy
    (``serve.start`` analog)."""
    global _client
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import (
        CONTROLLER_NAME, HTTP_PROXY_NAME, SERVE_NAMESPACE, ServeController)
    from ray_tpu_torch.serve._private.http_proxy import HTTPProxyActor

    ray_tpu_torch.init()
    if _client is not None:
        try:
            ray_tpu_torch.get(_client.controller.ping.remote(), timeout=10)
            return _client
        except Exception:
            _client = None  # stale (previous ray session); rebuild

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                       namespace=SERVE_NAMESPACE)
        ray_tpu_torch.get(controller.ping.remote(), timeout=10)
    except Exception:
        controller = (
            ray_tpu_torch.remote(ServeController)
            # threaded executor: every router parks one 30 s long-poll here,
            # so headroom must exceed any realistic router count or the
            # control plane wedges behind parked listeners.  Detached:
            # the serve instance is cluster infrastructure — it must
            # survive the deploying driver's disconnect (multi-tenancy
            # reaps a job's non-detached actors when its driver dies)
            .options(name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE,
                     max_concurrency=512, lifetime="detached")
            .remote()
        )
        ray_tpu_torch.get(controller.ping.remote(), timeout=60)

    proxy = None
    http = None
    if _http:
        opts = http_options or HTTPOptions()
        # get-or-create like the controller: a second driver's start()
        # must REUSE the live proxy, not bind a second one to the same
        # port (named + detached in the serve system namespace so it is
        # findable across tenants and survives its creator)
        try:
            proxy = ray_tpu_torch.get_actor(HTTP_PROXY_NAME,
                                      namespace=SERVE_NAMESPACE)
            http = tuple(ray_tpu_torch.get(proxy.ready.remote(), timeout=10))
        except Exception:
            proxy = ray_tpu_torch.remote(HTTPProxyActor).options(
                name=HTTP_PROXY_NAME, namespace=SERVE_NAMESPACE,
                lifetime="detached").remote(
                opts.host, opts.port)
            http = tuple(ray_tpu_torch.get(proxy.ready.remote(), timeout=60))
    _client = _ServeClient(controller, proxy, http)
    return _client


def _get_client() -> _ServeClient:
    if _client is None:
        raise RuntimeError("serve not started — call serve.run()/serve.start() first")
    return _client


def _deploy_application(
    client: _ServeClient, app: Application, deployed_names: Optional[list] = None
) -> DeploymentHandle:
    """Depth-first deploy: nested Applications become handles in the
    parent's init args (deployment-graph build analog)."""
    import ray_tpu_torch

    def resolve(v):
        if isinstance(v, Application):
            return _deploy_application(client, v, deployed_names)
        return v

    args = tuple(resolve(a) for a in app.args)
    kwargs = {k: resolve(v) for k, v in app.kwargs.items()}
    from ray_tpu_torch.serve.batching import uses_batching

    d = app.deployment
    goal = {
        "serialized_def": cloudpickle.dumps(d._func_or_class),
        "init_args": args,
        "init_kwargs": kwargs,
        "config": d.config,
        "route_prefix": d.route_prefix,
        # @serve.batch needs concurrent request threads to form batches;
        # plain deployments keep serialized execution (no surprise races)
        "uses_batching": uses_batching(d._func_or_class),
    }
    ray_tpu_torch.get(client.controller.deploy.remote(d.name, goal), timeout=60)
    if deployed_names is not None:
        deployed_names.append(d.name)
    return DeploymentHandle(d.name, client.controller)


def run(
    target: Union[Application, Deployment],
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    _blocking: bool = True,
    timeout_s: float = 180.0,
) -> DeploymentHandle:
    """Deploy an application and wait until healthy (``api.py:455``).
    Returns a handle to the root deployment."""
    from ray_tpu_torch._private.usage import record_feature
    record_feature("serve")
    import ray_tpu_torch

    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"serve.run expects an Application or Deployment, got {type(target)}")
    client = start(HTTPOptions(host=host, port=port))
    deployed_names: list = []
    handle = _deploy_application(client, target, deployed_names)
    if _blocking:
        deadline = time.monotonic() + timeout_s
        while True:
            status_map = ray_tpu_torch.get(client.controller.get_status.remote(), timeout=30)
            # only THIS app's deployments gate the wait — an unrelated
            # unhealthy deployment must not fail this run
            mine = {n: status_map[n] for n in deployed_names if n in status_map}
            bad = [n for n, s in mine.items() if s["status"] == "UNHEALTHY"]
            if bad:
                raise RuntimeError(
                    f"deployment(s) {bad} unhealthy: "
                    + "; ".join(mine[n].get("message", "") for n in bad)
                )
            if all(s["status"] == "HEALTHY" for s in mine.values()):
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"deployments not healthy after {timeout_s}s: {mine}"
                )
            time.sleep(0.2)
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _get_client().controller)


def status() -> Dict[str, dict]:
    import ray_tpu_torch

    return ray_tpu_torch.get(_get_client().controller.get_status.remote(), timeout=30)


def get_http_address() -> Optional[Tuple[str, int]]:
    """(host, port) of the running HTTP proxy."""
    return _get_client().http


def delete(name: str) -> None:
    import ray_tpu_torch

    ray_tpu_torch.get(_get_client().controller.delete_deployment.remote(name), timeout=30)


def shutdown() -> None:
    """Tear down all deployments, the proxy, and the controller."""
    global _client
    import ray_tpu_torch

    if _client is None:
        return
    try:
        ray_tpu_torch.get(_client.controller.graceful_shutdown.remote(), timeout=30)
    except Exception:
        pass
    for h in (_client.proxy, _client.controller):
        if h is not None:
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass
    _client = None
