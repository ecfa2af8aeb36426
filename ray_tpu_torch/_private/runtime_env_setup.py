"""runtime_env pip plugin: hash-keyed cached virtualenvs at worker spawn.

Reference counterpart: ``python/ray/_private/runtime_env/pip.py`` (venv
per requirements hash, installed by the per-node agent before the worker
starts).  Here the slow work runs in the WORKER's own bootstrap process —
``python -m ray_tpu_torch._private.runtime_env_setup --pip-spec ... `` creates or
reuses the venv, then ``exec``s the venv's interpreter into the normal
worker entrypoint — so the head's scheduler thread never blocks on an
install.  A boot-looping pip spec trips the existing 3-strikes
runtime_env circuit breaker (``node.py`` spawn_failures) and fails the
task with an actionable error.

Venvs are created with ``--system-site-packages``, and the worker gets
the head's ``PYTHONPATH`` (``node._worker_pythonpath``), so torch and
numpy stay importable wherever the base interpreter keeps them.  Envs
are keyed by the sha1 of the canonicalized spec, live under
``default_base_dir()`` (the port's session root), and are marked ready
atomically; concurrent creators serialize on an ``fcntl`` lock.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import subprocess
import sys
import venv
from typing import Any, Dict, List, Tuple, Union

from ray_tpu_torch._private.runtime_env_packaging import default_base_dir

PipSpec = Union[List[str], Dict[str, Any]]


def parse_pip_spec(pip: PipSpec) -> Tuple[List[str], List[str]]:
    if isinstance(pip, dict):
        return list(pip.get("packages") or []), list(
            pip.get("pip_install_options") or [])
    return list(pip), []


def pip_env_key(pip: PipSpec) -> str:
    packages, options = parse_pip_spec(pip)
    blob = json.dumps({"packages": sorted(packages), "options": options},
                      sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def ensure_pip_env(pip: PipSpec) -> Tuple[str, bool]:
    """Create (or reuse) the venv for ``pip``; returns ``(python_exe,
    created)``.  Raises on install failure."""
    base_dir = default_base_dir()
    packages, options = parse_pip_spec(pip)
    key = pip_env_key(pip)
    env_dir = os.path.join(base_dir, f"pip-{key}")
    python = os.path.join(env_dir, "bin", "python")
    ready = os.path.join(env_dir, ".ready")
    if os.path.exists(ready):
        return python, False
    os.makedirs(base_dir, exist_ok=True)
    lock_path = os.path.join(base_dir, f"pip-{key}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):  # another process won the race
                return python, False
            venv.EnvBuilder(
                system_site_packages=True, with_pip=True, clear=True
            ).create(env_dir)
            if packages:
                proc = subprocess.run(
                    [python, "-m", "pip", "install", "--no-input",
                     *options, *packages],
                    capture_output=True, text=True, timeout=600,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"pip install {packages} failed:\n"
                        f"{proc.stderr[-2000:]}")
            with open(ready, "w") as f:
                f.write(json.dumps({"packages": packages, "options": options}))
            return python, True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# ---------------------------------------------------------------------------
# conda (reference python/ray/_private/runtime_env/conda.py)

CondaSpec = Union[str, Dict[str, Any]]


def conda_env_key(conda: CondaSpec) -> str:
    blob = json.dumps(conda, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _conda_exe() -> str:
    import shutil as _shutil

    exe = os.environ.get("RAY_TPU_TORCH_CONDA_EXE") or _shutil.which("conda")
    if not exe:
        raise RuntimeError(
            "runtime_env['conda'] requires a conda binary on this node's "
            "PATH (or RAY_TPU_TORCH_CONDA_EXE); none found. Use "
            "runtime_env['pip'] for venv-based isolation instead.")
    return exe


def ensure_conda_env(conda: CondaSpec) -> Tuple[str, bool]:
    """Resolve (or create) the conda env for ``conda``; returns
    ``(python_exe, created)``.

    - str: the NAME of a pre-existing conda env — resolved, never built
      (the reference's named-env path).
    - dict: an environment.yml body — materialized under a hash-keyed
      prefix exactly once per node, flock-serialized like the pip cache.
    """
    base_dir = default_base_dir()
    exe = _conda_exe()
    if isinstance(conda, str):
        proc = subprocess.run(
            [exe, "run", "-n", conda, "python", "-c",
             "import sys; print(sys.executable)"],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"conda env {conda!r} not usable:\n{proc.stderr[-2000:]}")
        return proc.stdout.strip().splitlines()[-1], False
    key = conda_env_key(conda)
    prefix = os.path.join(base_dir, f"conda-{key}")
    python = os.path.join(prefix, "bin", "python")
    ready = os.path.join(base_dir, f"conda-{key}.ready")
    if os.path.exists(ready):
        return python, False
    os.makedirs(base_dir, exist_ok=True)
    with open(os.path.join(base_dir, f"conda-{key}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):
                return python, False
            spec_path = os.path.join(base_dir, f"conda-{key}.yml")
            with open(spec_path, "w") as f:
                json.dump(conda, f)  # YAML is a JSON superset
            # a prior failed create leaves a partial prefix that conda
            # refuses to reuse — clear it (EnvBuilder(clear=True) analog)
            import shutil

            shutil.rmtree(prefix, ignore_errors=True)
            proc = subprocess.run(
                [exe, "env", "create", "--prefix", prefix, "--file",
                 spec_path, "--yes"],
                capture_output=True, text=True, timeout=1800,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"conda env create failed:\n{proc.stderr[-2000:]}")
            open(ready, "w").close()
            return python, True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def worker_argv(pip: Union[PipSpec, None],
                conda: Union[CondaSpec, None] = None) -> List[str]:
    """Worker process argv — shared by the head and node agents so local
    and remote spawns can never drift.  A pip/conda spec boots through
    this module's shim (env build in the worker process), which then
    execs that env's python into the normal entrypoint."""
    if pip:
        return [sys.executable, "-m", "ray_tpu_torch._private.runtime_env_setup",
                "--pip-spec", json.dumps(pip)]
    if conda:
        return [sys.executable, "-m", "ray_tpu_torch._private.runtime_env_setup",
                "--conda-spec", json.dumps(conda)]
    return [sys.executable, "-m", "ray_tpu_torch._private.worker"]


def main() -> None:
    """Worker bootstrap: materialize the env, then exec the env's python
    into the worker entrypoint."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--pip-spec", help="JSON pip spec")
    p.add_argument("--conda-spec", help="JSON conda spec (name or env dict)")
    args = p.parse_args()
    try:
        if args.pip_spec:
            python, _ = ensure_pip_env(json.loads(args.pip_spec))
        elif args.conda_spec:
            python, _ = ensure_conda_env(json.loads(args.conda_spec))
        else:
            raise ValueError("one of --pip-spec/--conda-spec is required")
    except Exception as e:  # noqa: BLE001 — the exit code IS the signal
        print(f"runtime_env setup failed: {e}", file=sys.stderr)
        raise SystemExit(77)
    os.execv(python, [python, "-m", "ray_tpu_torch._private.worker"])


if __name__ == "__main__":
    main()
