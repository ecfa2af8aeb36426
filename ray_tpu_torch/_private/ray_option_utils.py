"""Validation of ``@remote``/``.options`` arguments.

Single source of truth for task/actor options, mirroring
``python/ray/_private/ray_option_utils.py:118-184`` (num_cpus/num_gpus/
max_retries/max_restarts/num_returns/resources/...).
"""

from __future__ import annotations

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

# The port's runtime applies ``env_vars`` at spawn and takes no other
# runtime_env key: the JAX package's pip, conda, working_dir and
# py_modules environments are left out of the port's runtime core.
SUPPORTED_RUNTIME_ENV_KEYS = {"env_vars"}


def validate_runtime_env(runtime_env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if runtime_env is None:
        return None
    if not isinstance(runtime_env, dict):
        raise TypeError(f"runtime_env must be a dict, got {type(runtime_env)}")
    unsupported = set(runtime_env) - SUPPORTED_RUNTIME_ENV_KEYS
    if unsupported:
        raise ValueError(
            f"Unsupported runtime_env keys {sorted(unsupported)}; the port's "
            f"runtime supports {sorted(SUPPORTED_RUNTIME_ENV_KEYS)}")
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None:
        if not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()
        ):
            raise TypeError("runtime_env['env_vars'] must be a Dict[str, str]")
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
