"""Node resource detection, with the GPU first-class.

The port's counterpart of ``ray_tpu/_private/resource_spec.py``, which
counts TPU chips; here the node's ``"GPU"`` resource counts NVIDIA cards,
as the reference's ``_autodetect_num_gpus`` (``resource_spec.py:268``)
does.  The ids it returns are what the head grants a worker as
``CUDA_VISIBLE_DEVICES``.

Detection never creates a CUDA context in the head: it reads
``CUDA_VISIBLE_DEVICES``, then asks ``nvidia-smi -L`` (a separate
process), and only where that tool is missing falls back to
``torch.cuda.device_count()``, which counts through NVML or the driver
without making a context.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple


def _nvidia_smi_count() -> Optional[int]:
    """Cards ``nvidia-smi -L`` lists (it ignores ``CUDA_VISIBLE_DEVICES``);
    None where the tool is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "-L"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def autodetect_gpus() -> Tuple[int, List[int]]:
    """(card count, card ids) from one consistent source: the ids become
    the workers' ``CUDA_VISIBLE_DEVICES`` grants, so the two never disagree.

    ``CUDA_VISIBLE_DEVICES`` wins where it is set (its entries are the ids,
    as CUDA reads them); otherwise every card ``nvidia-smi -L`` lists, or
    where it is missing ``torch.cuda.device_count()``."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [c.strip() for c in visible.split(",") if c.strip()]
        # CUDA stops at the first invalid entry ("-1" hides every card)
        kept: List[int] = []
        for c in ids:
            if not c.isdigit():
                break
            kept.append(int(c))
        return len(kept), kept
    n = _nvidia_smi_count()
    if n is None:
        import torch

        n = torch.cuda.device_count()
    return n, list(range(n))


def autodetect_resources(
    num_cpus: Optional[int],
    num_gpus: Optional[int],
    resources: Optional[Dict[str, float]],
) -> Tuple[Dict[str, float], List[int]]:
    """Returns (resource totals, GPU ids).  An explicit ``num_gpus`` takes
    ids ``0..num_gpus-1``: the tests declare cards a CPU host does not have,
    and get the env grants alone."""
    total: Dict[str, float] = dict(resources or {})
    total["CPU"] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    if num_gpus is not None:
        n_gpus, ids = num_gpus, list(range(num_gpus))
    else:
        n_gpus, ids = autodetect_gpus()
    total["GPU"] = float(n_gpus)
    try:
        import psutil  # type: ignore

        total.setdefault("memory", float(psutil.virtual_memory().available))
    except ImportError:
        total.setdefault("memory", 8.0 * 1024**3)
    return total, ids


def host_stats() -> Dict[str, float]:
    """Live host utilization for node heartbeats (the per-node metrics
    the reference's dashboard agent reports,
    ``dashboard/modules/reporter/reporter_agent.py:253``).  /proc reads
    only — no psutil dependency on the hot heartbeat path."""
    stats: Dict[str, float] = {"cpu_count": float(os.cpu_count() or 1)}
    try:
        with open("/proc/loadavg") as f:
            stats["load_1m"] = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    try:
        mem: Dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                if k in ("MemTotal", "MemAvailable"):
                    mem[k] = int(rest.split()[0])  # kB
        if mem:
            stats["mem_total_mb"] = round(mem.get("MemTotal", 0) / 1024, 1)
            stats["mem_available_mb"] = round(
                mem.get("MemAvailable", 0) / 1024, 1)
    except (OSError, ValueError):
        pass
    return stats
