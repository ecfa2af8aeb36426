"""Validation of ``@remote``/``.options`` arguments.

Single source of truth for task/actor options, mirroring
``python/ray/_private/ray_option_utils.py:118-184`` (num_cpus/num_gpus/
max_retries/max_restarts/num_returns/resources/...).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

TASK_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "num_returns", "max_retries",
    "scheduling_strategy", "name", "runtime_env", "memory",
}
ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "max_restarts", "max_task_retries",
    "scheduling_strategy", "name", "lifetime", "runtime_env", "memory",
    "max_concurrency", "namespace", "concurrency_groups",
}

# env_vars/working_dir apply at spawn; pip/conda build hash-keyed cached
# envs in the worker's bootstrap (``runtime_env_setup.py``; reference
# ``python/ray/_private/runtime_env/{pip,conda}.py``); working_dir and
# py_modules local paths are zipped into content-addressed ``gcs://``
# packages shipped through the cluster KV
# (``runtime_env_packaging.py``; reference ``runtime_env/packaging.py``).
# ``container`` (podman rootless containers) is rejected loudly instead
# of silently dropped — the card hosts run no container runtime.
SUPPORTED_RUNTIME_ENV_KEYS = {
    "env_vars", "working_dir", "pip", "conda", "py_modules", "excludes",
}


def validate_runtime_env(runtime_env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if runtime_env is None:
        return None
    if not isinstance(runtime_env, dict):
        raise TypeError(f"runtime_env must be a dict, got {type(runtime_env)}")
    unsupported = set(runtime_env) - SUPPORTED_RUNTIME_ENV_KEYS
    if unsupported:
        hint = (" ('container' needs a container runtime, absent from the "
                "card hosts — use 'pip'/'conda' + 'py_modules' instead)"
                if "container" in unsupported else "")
        raise ValueError(
            f"Unsupported runtime_env keys {sorted(unsupported)}; this build "
            f"supports {sorted(SUPPORTED_RUNTIME_ENV_KEYS)}{hint}"
        )
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None:
        if not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()
        ):
            raise TypeError("runtime_env['env_vars'] must be a Dict[str, str]")
    working_dir = runtime_env.get("working_dir")
    if working_dir is not None:
        ok = isinstance(working_dir, str) and (
            working_dir.startswith("gcs://")  # already-packaged URI
            or os.path.isdir(working_dir)
            or (working_dir.endswith(".zip") and os.path.isfile(working_dir)))
        if not ok:
            raise ValueError(
                f"runtime_env['working_dir'] must be an existing local "
                f"directory, a .zip file, or a gcs:// package URI, "
                f"got {working_dir!r}"
            )
    py_modules = runtime_env.get("py_modules")
    if py_modules is not None:
        if not isinstance(py_modules, list):
            raise TypeError("runtime_env['py_modules'] must be a list of "
                            "local dirs / .zip files / gcs:// URIs")
        for m in py_modules:
            ok = isinstance(m, str) and (
                m.startswith("gcs://") or os.path.isdir(m)
                or (m.endswith(".zip") and os.path.isfile(m)))
            if not ok:
                raise ValueError(
                    f"runtime_env['py_modules'] entry {m!r} is not an "
                    f"existing local directory, .zip file, or gcs:// URI")
    excludes = runtime_env.get("excludes")
    if excludes is not None and not (
            isinstance(excludes, list)
            and all(isinstance(e, str) for e in excludes)):
        raise TypeError("runtime_env['excludes'] must be List[str] of "
                        "glob patterns")
    conda = runtime_env.get("conda")
    if conda is not None:
        if runtime_env.get("pip"):
            raise ValueError(
                "runtime_env cannot specify both 'pip' and 'conda' "
                "(build one env: put pip packages under the conda spec)")
        if not isinstance(conda, (str, dict)):
            raise TypeError(
                "runtime_env['conda'] must be an env NAME (str) or an "
                "environment.yml dict")
    pip = runtime_env.get("pip")
    if pip is not None:
        # list of requirements, or {"packages": [...], "pip_install_options":
        # [...]} (reference python/ray/_private/runtime_env/pip.py surface)
        if isinstance(pip, dict):
            unknown = set(pip) - {"packages", "pip_install_options"}
            if unknown:
                raise ValueError(
                    f"unsupported runtime_env['pip'] keys {sorted(unknown)}; "
                    f"supported: ['packages', 'pip_install_options']")
            pkgs = pip.get("packages")
            opts_ = pip.get("pip_install_options", [])
            if not isinstance(pkgs, list) or not all(isinstance(p, str) for p in pkgs):
                raise TypeError("runtime_env['pip']['packages'] must be List[str]")
            if not isinstance(opts_, list) or not all(isinstance(o, str) for o in opts_):
                raise TypeError(
                    "runtime_env['pip']['pip_install_options'] must be List[str]")
        elif not (isinstance(pip, list) and all(isinstance(p, str) for p in pip)):
            raise TypeError(
                "runtime_env['pip'] must be a List[str] of requirements or a "
                "dict with 'packages'")
    return runtime_env


def validate_options(opts: Dict[str, Any], for_actor: bool) -> Dict[str, Any]:
    allowed = ACTOR_OPTIONS if for_actor else TASK_OPTIONS
    for k in opts:
        if k not in allowed:
            raise ValueError(
                f"Invalid option {k!r} for {'actor' if for_actor else 'task'}; "
                f"allowed: {sorted(allowed)}"
            )
    for k in ("num_cpus", "num_gpus", "memory"):
        v = opts.get(k)
        if v is not None and (not isinstance(v, (int, float)) or v < 0):
            raise ValueError(f"{k} must be a non-negative number, got {v!r}")
    nr = opts.get("num_returns")
    if nr is not None and nr != "dynamic" and (not isinstance(nr, int) or nr < 1):
        raise ValueError(
            f"num_returns must be an int >= 1 or \"dynamic\", got {nr!r}")
    if nr == "dynamic" and for_actor:
        raise ValueError("num_returns=\"dynamic\" is not supported for actors")
    mc = opts.get("max_concurrency")
    if mc is not None and (not isinstance(mc, int) or mc < 1):
        raise ValueError(f"max_concurrency must be an int >= 1, got {mc!r}")
    lt = opts.get("lifetime")
    if lt not in (None, "detached"):
        raise ValueError(
            f'lifetime must be None or "detached", got {lt!r}')
    ns = opts.get("namespace")
    if ns is not None and (not isinstance(ns, str) or not ns):
        raise ValueError(f"namespace must be a non-empty string, got {ns!r}")
    cg = opts.get("concurrency_groups")
    if cg is not None:
        if (not isinstance(cg, dict) or not cg or not all(
                isinstance(k, str) and k and isinstance(v, int) and v >= 1
                for k, v in cg.items())):
            raise ValueError(
                "concurrency_groups must be a non-empty Dict[str, int>=1] "
                f"of group name -> max concurrency, got {cg!r}")
        if "_default" in cg:
            raise ValueError(
                '"_default" is reserved (the unnamed max_concurrency pool)')
    if "runtime_env" in opts:
        validate_runtime_env(opts["runtime_env"])
    return opts


def resources_from_options(opts: Dict[str, Any], default_num_cpus: float) -> Dict[str, float]:
    # coerce custom amounts at the source: a str amount (e.g. {"accel":
    # "1"}) must become a float HERE, or the head's scheduler compares
    # float >= str and dies; a non-numeric amount errors at submission
    try:
        res: Dict[str, float] = {
            k: float(v) for k, v in (opts.get("resources") or {}).items()
        }
    except (TypeError, ValueError) as e:
        raise TypeError(
            f"resources amounts must be numeric: {opts.get('resources')!r}"
        ) from e
    if "CPU" in res or "GPU" in res:
        raise ValueError("Use num_cpus/num_gpus instead of resources={'CPU': ...}")
    num_cpus = opts.get("num_cpus")
    res["CPU"] = float(default_num_cpus if num_cpus is None else num_cpus)
    num_gpus = opts.get("num_gpus")
    if num_gpus:
        # a share of one card (0 < num_gpus < 1) or whole cards, as the
        # reference Ray grants them
        if num_gpus > 1 and num_gpus != int(num_gpus):
            raise ValueError(
                f"num_gpus above 1 must be a whole number of cards, got {num_gpus!r}")
        res["GPU"] = float(num_gpus)
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    return {k: v for k, v in res.items() if v != 0}
