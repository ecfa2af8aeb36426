"""Declarative Serve config schema.

Analog of ``python/ray/serve/schema.py:1`` (ServeDeploySchema /
ServeApplicationSchema / DeploymentSchema, pydantic there): a validated
JSON/YAML shape for deploying applications from config instead of code::

    applications:
      - name: default
        import_path: my_pkg.app:graph        # module:attr -> Application
        route_prefix: /api
        deployments:                          # per-deployment overrides
          - name: Model
            num_replicas: 2
            max_concurrent_queries: 32
            user_config: {threshold: 0.5}

Handed to the controller's ``apply_deploy_config``; the controller
reconciles live state to it and ``serve.status()`` reports goal vs actual.

Validation is plain dataclasses + explicit checks (no pydantic in the
image); errors carry the offending path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

_UNSET = "__unset__"


class SchemaError(ValueError):
    pass


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_concurrent_queries: Optional[int] = None
    user_config: Any = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    route_prefix: Any = _UNSET


@dataclasses.dataclass
class ServeApplicationSchema:
    import_path: str
    name: str = "default"
    route_prefix: Any = _UNSET
    runtime_env: Dict[str, Any] = dataclasses.field(default_factory=dict)
    deployments: List[DeploymentSchema] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeDeploySchema:
    applications: List[ServeApplicationSchema] = dataclasses.field(
        default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _expect(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise SchemaError(f"{path}: {msg}")


def parse_deploy_config(raw: Dict[str, Any]) -> ServeDeploySchema:
    """Validate a config dict into a ServeDeploySchema (raises
    :class:`SchemaError` naming the offending field)."""
    _expect(isinstance(raw, dict), "$", f"expected an object, got {type(raw).__name__}")
    apps_raw = raw.get("applications")
    _expect(isinstance(apps_raw, list),
            "applications", "required list (empty = delete all config apps)")
    apps: List[ServeApplicationSchema] = []
    seen_names: set = set()
    for i, app_raw in enumerate(apps_raw):
        path = f"applications[{i}]"
        _expect(isinstance(app_raw, dict), path, "expected an object")
        unknown = set(app_raw) - {
            "import_path", "name", "route_prefix", "runtime_env", "deployments"}
        _expect(not unknown, path, f"unknown fields {sorted(unknown)}")
        import_path = app_raw.get("import_path")
        _expect(isinstance(import_path, str) and ":" in import_path,
                f"{path}.import_path",
                "required 'module.sub:attr' string")
        name = app_raw.get("name", "default")
        _expect(isinstance(name, str) and name, f"{path}.name", "non-empty string")
        _expect(name not in seen_names, f"{path}.name", f"duplicate app name {name!r}")
        seen_names.add(name)
        route_prefix = app_raw.get("route_prefix", _UNSET)
        if route_prefix not in (_UNSET, None):
            _expect(isinstance(route_prefix, str) and route_prefix.startswith("/"),
                    f"{path}.route_prefix", "must start with '/' (or be null)")
        runtime_env = app_raw.get("runtime_env") or {}
        _expect(isinstance(runtime_env, dict), f"{path}.runtime_env", "expected object")
        deployments: List[DeploymentSchema] = []
        for j, d_raw in enumerate(app_raw.get("deployments") or []):
            dpath = f"{path}.deployments[{j}]"
            _expect(isinstance(d_raw, dict), dpath, "expected an object")
            unknown = set(d_raw) - {
                "name", "num_replicas", "max_concurrent_queries", "user_config",
                "ray_actor_options", "autoscaling_config", "route_prefix"}
            _expect(not unknown, dpath, f"unknown fields {sorted(unknown)}")
            dname = d_raw.get("name")
            _expect(isinstance(dname, str) and dname, f"{dpath}.name",
                    "required non-empty string")
            nr = d_raw.get("num_replicas")
            _expect(nr is None or (isinstance(nr, int) and nr >= 0),
                    f"{dpath}.num_replicas", "must be an int >= 0")
            mcq = d_raw.get("max_concurrent_queries")
            _expect(mcq is None or (isinstance(mcq, int) and mcq >= 1),
                    f"{dpath}.max_concurrent_queries", "must be an int >= 1")
            rao = d_raw.get("ray_actor_options")
            _expect(rao is None or isinstance(rao, dict),
                    f"{dpath}.ray_actor_options", "expected object")
            asc = d_raw.get("autoscaling_config")
            _expect(asc is None or isinstance(asc, dict),
                    f"{dpath}.autoscaling_config", "expected object")
            deployments.append(DeploymentSchema(
                name=dname, num_replicas=nr, max_concurrent_queries=mcq,
                user_config=d_raw.get("user_config"),
                ray_actor_options=rao, autoscaling_config=asc,
                route_prefix=d_raw.get("route_prefix", _UNSET)))
        apps.append(ServeApplicationSchema(
            import_path=import_path, name=name, route_prefix=route_prefix,
            runtime_env=runtime_env, deployments=deployments))
    return ServeDeploySchema(applications=apps)


def import_target(import_path: str):
    """Resolve 'module.sub:attr' to the bound Application (or Deployment,
    which is bound with no args)."""
    import importlib

    mod_name, _, attr = import_path.partition(":")
    target = getattr(importlib.import_module(mod_name), attr)
    from ray_tpu_torch.serve.api import Application, Deployment

    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise SchemaError(
            f"{import_path} resolved to {type(target).__name__}; expected a "
            "bound Application (call .bind()) or a Deployment")
    return target
