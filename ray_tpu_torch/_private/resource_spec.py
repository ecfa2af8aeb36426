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

``host_stats`` and ``ProcSampler`` read ``/proc`` alone (no psutil): the
node heartbeat's host figures, and the RSS, CPU% and open fds of each
process the head or a node agent samples, as registry-shaped gauges
(``resource_metrics_snapshot``) that ride the ``metrics_report`` path.
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


# ---------------------------------------------------------------------------
# per-process resource sampling (reporter_agent's per-worker stats analog)
# ---------------------------------------------------------------------------

# gauge names the sampler emits; the head's top view, the TSDB trend rules
# (doctor RSS-growth), and the Grafana factory all key off these
PROC_RSS_MB = "ray_tpu_proc_rss_mb"
PROC_CPU_PCT = "ray_tpu_proc_cpu_percent"
PROC_OPEN_FDS = "ray_tpu_proc_open_fds"

_PROC_METRIC_HELP = {
    PROC_RSS_MB: "resident set size per tracked process (MB)",
    PROC_CPU_PCT: "CPU utilization per tracked process (%)",
    PROC_OPEN_FDS: "open file descriptors per tracked process",
}


class ProcSampler:
    """Reads RSS, CPU%, and open-fd counts for a set of pids from /proc.

    CPU% needs a delta between consecutive samples (utime+stime ticks over
    wall time), so one sampler instance persists across a sampling loop's
    lifetime; pids that vanish between samples simply drop out.  /proc
    only — no psutil on a 5 s always-on path."""

    def __init__(self):
        self._prev: Dict[int, Tuple[float, float]] = {}  # pid -> (ticks_s, t)
        try:
            self._hz = float(os.sysconf("SC_CLK_TCK")) or 100.0
        except (ValueError, OSError, AttributeError):
            self._hz = 100.0
        self._page_kb = (os.sysconf("SC_PAGE_SIZE") // 1024
                         if hasattr(os, "sysconf") else 4)

    def sample(self, pid: int) -> Optional[Dict[str, float]]:
        """One process's stats, or None when the pid is gone."""
        import time as _time

        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            self._prev.pop(pid, None)
            return None
        # comm may contain spaces/parens: fields start after the LAST ')'
        fields = stat[stat.rfind(")") + 2:].split()
        # fields[11]=utime, fields[12]=stime (0-based after comm/state),
        # fields[21]=rss pages
        try:
            cpu_s = (float(fields[11]) + float(fields[12])) / self._hz
            rss_mb = float(fields[21]) * self._page_kb / 1024.0
        except (IndexError, ValueError):
            return None
        now = _time.monotonic()
        cpu_pct = 0.0
        prev = self._prev.get(pid)
        if prev is not None and now > prev[1]:
            cpu_pct = max(0.0, (cpu_s - prev[0]) / (now - prev[1]) * 100.0)
        self._prev[pid] = (cpu_s, now)
        out = {"rss_mb": round(rss_mb, 2), "cpu_pct": round(cpu_pct, 2)}
        try:
            out["open_fds"] = float(len(os.listdir(f"/proc/{pid}/fd")))
        except OSError:
            pass
        return out

    def forget_missing(self, live_pids) -> None:
        """Drop CPU baselines for pids no longer tracked."""
        live = set(live_pids)
        for pid in [p for p in self._prev if p not in live]:
            del self._prev[pid]


def resource_metrics_snapshot(sampler: ProcSampler,
                              entities: List[Tuple[Dict[str, str], int]],
                              ) -> Tuple[Dict[str, dict], List[tuple]]:
    """Sample ``entities`` ((tags, pid) pairs) into a registry-snapshot-
    shaped dict, so the result rides the existing ``metrics_report`` path
    and folds into the head's merged registry AND its TSDB unchanged.
    Also returns the per-entity raw stats as (tags, pid, stats) for
    callers that keep a live cache (the head's top view)."""
    values_by_metric: Dict[str, Dict[tuple, float]] = {
        PROC_RSS_MB: {}, PROC_CPU_PCT: {}, PROC_OPEN_FDS: {}}
    raw: List[Tuple[Dict[str, str], int, Dict[str, float]]] = []
    seen_pids = []
    for tags, pid in entities:
        stats = sampler.sample(pid)
        if stats is None:
            continue
        seen_pids.append(pid)
        key = tuple(sorted({**tags, "pid": str(pid)}.items()))
        values_by_metric[PROC_RSS_MB][key] = stats["rss_mb"]
        values_by_metric[PROC_CPU_PCT][key] = stats["cpu_pct"]
        if "open_fds" in stats:
            values_by_metric[PROC_OPEN_FDS][key] = stats["open_fds"]
        raw.append((tags, pid, stats))
    sampler.forget_missing(seen_pids)
    snap = {
        name: {"type": "gauge", "help": _PROC_METRIC_HELP[name],
               "values": values}
        for name, values in values_by_metric.items() if values
    }
    return snap, raw
