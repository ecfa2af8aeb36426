"""Flag/config system for the runtime.

Analog of the reference's ``RAY_CONFIG(type, name, default)`` macro
table (``src/ray/common/ray_config_def.h:22-728`` materialized as the
``RayConfig`` singleton in ``src/ray/common/ray_config.h``).  Every flag is
overridable with a ``RAY_TPU_TORCH_<NAME>`` environment variable, mirroring the
reference's ``RAY_<name>`` env override path.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any


def session_root() -> str:
    """Where sessions keep their directories and the last session's
    discovery record: ``$TMPDIR/ray_tpu_torch`` (the JAX package uses
    ``/tmp/ray_tpu``, so neither runtime finds the other's sessions)."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def _env(name: str, default: Any, typ: type) -> Any:
    raw = os.environ.get(f"RAY_TPU_TORCH_{name.upper()}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return typ(raw)


@dataclasses.dataclass
class Config:
    # -- object store ------------------------------------------------------
    # Objects at or below this size are carried inline in RPC messages
    # (analog of the reference's in-process memory store for small/direct
    # returns, src/ray/core_worker/store_provider/memory_store/).
    max_direct_call_object_size: int = 100 * 1024
    # Object store capacity (bytes); analog of plasma's arena size.  0 =
    # auto: a fraction of system RAM bounded by the shm mount (the
    # reference's default_object_store_memory sizing) — checkpoint-sized
    # multi-GiB values must fit the arena to take its single-pass write +
    # page-recycling path instead of a fresh per-object file.
    object_store_memory: int = 0
    # Auto sizing: this fraction of total RAM (reference
    # ray_constants.DEFAULT_OBJECT_STORE_MEMORY_PROPORTION).
    object_store_memory_fraction: float = 0.3
    # Task specs retained for object reconstruction (lineage); analog of
    # the reference's max_lineage_bytes bound (task_manager.h:94).
    max_lineage_entries: int = 10_000
    # Host memory fraction above which the OOM killer fires (reference
    # memory_usage_threshold, memory_monitor.h:52); refresh <= 0 disables.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 2000
    # Prefix for named shared-memory segments (the JAX package uses
    # "rtpu": neither runtime sweeps the other's segments).
    shm_prefix: str = "rtpt"

    # -- scheduler ---------------------------------------------------------
    # Pack nodes until utilization crosses this, then prefer spreading
    # (reference HybridSchedulingPolicy spread_threshold,
    # ray_config_def.h scheduler_spread_threshold).
    scheduler_spread_threshold: float = 0.5
    # Max workers a node will keep warm beyond its CPU count.
    # Simultaneous worker spawns per runtime-env key (the reference's
    # maximum_startup_concurrency role): python boots are expensive on
    # small hosts, so starts are staggered.
    maximum_startup_concurrency: int = 2
    # Plain workers forked at head start (WorkerPool prestart,
    # num_prestart_python_workers analog); -1 = min(num_cpus, 4).  Booting
    # them while the session is idle matters: under load, forked
    # interpreters are starved and the pool never ramps.
    num_prestart_workers: int = -1
    # Seconds an idle worker is kept before being reaped.
    idle_worker_killing_time_threshold_s: float = 300.0
    # Extra actor method calls pushed to a worker beyond max_concurrency so
    # its local queue is never empty between completions (the reference's
    # pipelined actor submitter window, direct_actor_task_submitter.h:67).
    # On a small host this converts one context switch per call into one
    # per burst.
    actor_pipeline_depth: int = 8
    # Same idea for plain tasks: follow-on tasks with an identical resource
    # shape ride to a busy worker's local queue ahead of completion (the
    # reference's worker-lease reuse, direct_task_transport.cc:174); they
    # hold no resources until promoted at the predecessor's completion.
    task_pipeline_depth: int = 8
    # Agent liveness probing (GcsHealthCheckManager analog): ping period
    # and the silence window after which a node is declared dead.
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 15.0

    # -- fault tolerance ---------------------------------------------------
    task_max_retries: int = 3
    actor_max_restarts: int = 0
    # -- timeouts ----------------------------------------------------------
    get_timeout_warning_s: float = 60.0
    worker_register_timeout_s: float = 30.0

    # -- logging -----------------------------------------------------------
    log_to_driver: bool = True

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env(f.name, getattr(self, f.name), f.type_ if hasattr(f, "type_") else type(getattr(self, f.name))))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def resolve_object_store_memory(cfg: Config | None = None) -> int:
    """The effective object-store capacity: the configured value, or (at 0)
    ``object_store_memory_fraction`` of system RAM clamped to [2 GiB, 80% of
    the shm mount].  The shm bound matters because the arena file lives
    there — a capacity past the mount would let puts fail with ENOSPC
    mid-write instead of falling back cleanly at allocation time."""
    cfg = cfg or get_config()
    if cfg.object_store_memory:
        return int(cfg.object_store_memory)
    try:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return 2 * 1024**3
    # floor BEFORE the shm clamp: the clamp is the ENOSPC protection and
    # must win on small shm mounts (e.g. docker's 64 MB default), or the
    # arena outgrows its tmpfs and puts die with SIGBUS mid-write
    want = max(2 * 1024**3, int(total * cfg.object_store_memory_fraction))
    try:
        from ray_tpu_torch._private.shm import shm_dir

        st = os.statvfs(shm_dir())
        # clamp to FREE space, not mount size: tmpfs pages are allocated
        # lazily, so an arena sized past what's actually available dies
        # with SIGBUS/ENOSPC mid-write once puts catch up with it
        want = min(want, int(st.f_frsize * st.f_bavail * 0.8))
    except OSError:
        pass
    return want
