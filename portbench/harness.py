"""What every cell shares: finding its files by name, the run's
environment, the device checks, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<mix>.json``, its own settings (the entry that drives the port,
the engine's sizes, the limits of the output check) ``cells/<cell>.json``
and each metric ``metrics/<metric>.py``.  A later cell, configuration or
metric is a new file and a new entry of ``BENCHMARK.json``; no file here
changes for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
# top-level module names that no process of the benchmark may hold: the
# JAX package and JAX itself (compared whole: the port's name starts with
# the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def check_name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return read_json(ROOT / "BENCHMARK.json")


def cell_spec(workload: str, bench: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Everything one cell needs, by its name: the ``BENCHMARK.json``
    entry, its configuration, its traffic mix, its own settings and the
    names of the metrics it reports."""
    bench = bench if bench is not None else benchmark()
    check_name(workload)
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    spec = {
        "workload": w,
        "config": read_json(ROOT / cfg_entry["file"]),
        "traffic": read_json(HERE / "traffic" / f"{check_name(w['traffic'])}.json"),
        "cell": read_json(HERE / "cells" / f"{workload}.json"),
    }
    spec["end_to_end"] = _metrics_of(bench["end_to_end"], workload, None)
    spec["per_layer"] = _metrics_of(bench["per_layer"], workload,
                                    [m["name"] for m in spec["end_to_end"]])
    return spec


def _metrics_of(metrics: List[Dict[str, Any]], workload: str,
                reported: Optional[List[str]]) -> List[Dict[str, Any]]:
    """The metrics a cell reports: those that list it under ``workloads``;
    a metric with no such list goes to every cell (an end-to-end metric)
    or to every cell that reports the metric it ``moves`` (a per-layer
    one)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def load_entry(name: str):
    """``entries/<name>.py``, whose ``run(spec, seed=, seconds=, trace=,
    t_start=)`` returns the run's record: ``attempted``, ``failed``,
    ``ctx`` for the readers, ``device``, ``checks``, and ``held``, what
    ``forbidden_modules`` gave in the process that held the card once the
    window had closed."""
    return importlib.import_module(f"portbench.entries.{check_name(name)}")


def load_reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``metrics/<metric>.py``'s ``read(record)``: the metric's value, or
    None where the run gave it nothing to read."""
    path = HERE / "metrics" / f"{check_name(metric)}.py"
    mod_name = "portbench.metrics." + metric.replace(".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_env(tmp: Optional[str] = None) -> Dict[str, str]:
    """The environment every process of a run inherits: caches at fixed
    paths inside the checkout, the runtime's shared memory under the run's
    own ``TMPDIR``, and no library that would load JAX by itself."""
    tmp = tmp or os.environ.get("TMPDIR") or "/tmp"
    cache = HERE / ".cache"
    return {
        "PYTHONPATH": os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        "RAY_TPU_TORCH_SHM_DIR": os.path.join(tmp, "portbench-shm"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
        "USE_TF": "0",
    }


def apply_env() -> None:
    env = run_env()
    os.makedirs(env["RAY_TPU_TORCH_SHM_DIR"], exist_ok=True)
    os.environ.update(env)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell asks for {n} cards, {torch.cuda.device_count()} present")


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def card_power_limit() -> Optional[str]:
    """``name, power limit`` of the first card as ``nvidia-smi`` reads
    them (None where it cannot): the rates and shares are against the
    published peaks at 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def quartile_spread(values: List[float]) -> float:
    """(Q3 - Q1) / median, by ``statistics.quantiles(values, n=4)``."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics, as numpy's default does."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)
