"""Per-step performance attribution: phases, live MFU, first calls, memory.

The port's copy of ``ray_tpu/util/perf.py``.  A :class:`StepProfiler`
lives inside a train loop and splits every step into phases
(ingest / h2d / compile / compute / collective / other) that sum EXACTLY
to the measured step wall: the residual no explicit scope covers is
billed to ``other``, never dropped.  Each step also yields a live MFU
(``util/flops.py``, the same arithmetic ``chip_smoke.py`` uses) and a
device-memory sample (``torch.cuda.memory_stats``).

**Card time.** PyTorch returns before the card has run what a call
enqueued, so a host clock alone would bill a step's device work to
whatever phase happens to wait for it next.  On a CUDA device every phase
scope, every wrapped call and the step itself end with
``torch.cuda.synchronize(device)`` before the clock is read: each phase
holds the device work it enqueued, and the host cannot run ahead of the
card inside a profiled step (that is the profiler's cost; an unprofiled
loop keeps its overlap).

:meth:`StepProfiler.wrap_jit` keeps the JAX package's name: there is no
compile cache to ask in eager PyTorch, so the first call of each shape
signature (the call that builds kernels, autotunes and fills the caching
allocator) is billed to ``compile`` and later calls to ``compute``.

Everything publishes through the flight recorder (``perf`` span events)
and the metrics registry, and ``summary()`` is what
``BackendExecutor.perf_summaries()`` hands back.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.util import flops as flops_mod
from ray_tpu_torch.util.tree import tree_leaves

# phase names the step profiler bills; anything else the loop invents is
# carried through verbatim (the breakdown renders whatever it sees)
KNOWN_PHASES = ("ingest", "h2d", "compile", "compute", "collective", "other")

_PERF_METRICS = None
_METRICS_LOCK = threading.Lock()


def _perf_metrics():
    global _PERF_METRICS
    if _PERF_METRICS is None:
        # import BEFORE taking the lock: the first import pays the global
        # import lock + disk I/O, and holding our lock across it would
        # stall every concurrent profiler step on it (raylint R4)
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        with _METRICS_LOCK:
            if _PERF_METRICS is None:
                _PERF_METRICS = {
                    "phase": Histogram(
                        "ray_tpu_train_phase_seconds",
                        "per-step wall seconds billed to each phase "
                        "(ingest/h2d/compile/compute/collective/other)",
                        boundaries=[1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05,
                                    0.1, 0.5, 1, 5, 30],
                        tag_keys=("phase", "rank")),
                    "step_wall": Histogram(
                        "ray_tpu_train_step_wall_seconds",
                        "profiled train-step wall time (s)",
                        boundaries=[1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                                    1, 5, 30, 120],
                        tag_keys=("rank",)),
                    "mfu": Gauge(
                        "ray_tpu_train_step_mfu",
                        "live per-step model-FLOPs utilization "
                        "(util/flops.py roofline)",
                        tag_keys=("rank",)),
                    "jit_hits": Counter(
                        "ray_tpu_jit_cache_hits_total",
                        "wrapped-jit calls served from the compile cache",
                        tag_keys=("fn",)),
                    "jit_misses": Counter(
                        "ray_tpu_jit_cache_misses_total",
                        "wrapped-jit calls that compiled (new shape "
                        "signature)",
                        tag_keys=("fn",)),
                    "jit_compile": Histogram(
                        "ray_tpu_jit_compile_seconds",
                        "wall time of compiling jit calls",
                        boundaries=[0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120],
                        tag_keys=("fn",)),
                    "hbm_used": Gauge(
                        "ray_tpu_hbm_bytes_in_use",
                        "device memory in use (host RSS on CPU fallback)",
                        tag_keys=("device", "kind")),
                    "hbm_limit": Gauge(
                        "ray_tpu_hbm_bytes_limit",
                        "device memory capacity (absent on CPU fallback)",
                        tag_keys=("device", "kind")),
                    "hbm_peak": Gauge(
                        "ray_tpu_hbm_peak_bytes_in_use",
                        "high-water device memory since process start",
                        tag_keys=("device", "kind")),
                }
    return _PERF_METRICS


def sample_device_memory(device: Any = None) -> Optional[dict]:
    """One device-memory sample: ``torch.cuda.memory_stats(device)`` for a
    CUDA device (the current one when None and CUDA is initialised in this
    process; a process that never touched CUDA is not made to), host RSS
    otherwise (keyed ``kind=host_rss`` so it is never mistaken for device
    memory).  Returns None only when both paths fail; never raises."""
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        try:
            ms = torch.cuda.memory_stats(dev)
            return {
                "device": str(dev.index if dev.index is not None
                              else torch.cuda.current_device()),
                "kind": "hbm",
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
                "peak_bytes_in_use":
                    int(ms.get("allocated_bytes.all.peak", 0)) or None,
            }
        except RuntimeError:
            pass
    try:
        import os

        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return {
            "device": "cpu", "kind": "host_rss",
            "bytes_in_use": rss_pages * os.sysconf("SC_PAGE_SIZE"),
            "bytes_limit": None, "peak_bytes_in_use": None,
        }
    except (OSError, ValueError):
        return None


def publish_device_memory(device: Any = None) -> Optional[dict]:
    """Sample + set the HBM gauges (what the step profiler and the serve
    engine call; also usable standalone from any device-holding actor)."""
    sample = sample_device_memory(device)
    if sample is None:
        return None
    m = _perf_metrics()
    tags = {"device": sample["device"], "kind": sample["kind"]}
    m["hbm_used"].set(float(sample["bytes_in_use"]), tags=tags)
    if sample.get("bytes_limit"):
        m["hbm_limit"].set(float(sample["bytes_limit"]), tags=tags)
    if sample.get("peak_bytes_in_use"):
        m["hbm_peak"].set(float(sample["peak_bytes_in_use"]), tags=tags)
    return sample


def _signature(args, kwargs) -> str:
    """Short stable shape-signature for a call: a digest over every tensor
    or array leaf's (shape, dtype) plus a human hint (the few distinct
    shapes involved); a train step carries a many-hundred-leaf state, so
    the full shape list would be kilobytes per event."""
    leaves = tree_leaves((list(args), dict(sorted(kwargs.items()))))
    parts: List[str] = []
    hint: List[str] = []
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is not None:
            s = f"{tuple(shape)}:{getattr(leaf, 'dtype', '?')}"
        else:
            s = type(leaf).__name__
        parts.append(s)
        if shape is not None and s not in hint and len(hint) < 3:
            hint.append(s)
    # blake2b: in-interpreter implementation, so FIPS-enforcing OpenSSL
    # builds (where md5() raises) can't crash the compile path
    digest = hashlib.blake2b("|".join(parts).encode(),
                             digest_size=6).hexdigest()
    return f"{digest}[{','.join(hint)}]" if hint else digest


class CompileTracker:
    """Per-function first-call accounting (hit/miss counters per shape
    signature, first-call wall time) — usable standalone; the step
    profiler embeds one.  A call whose shape signature the function has
    not seen before is a miss (eager PyTorch has no compile cache to ask:
    the first call of a shape is the one that builds and tunes)."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"sigs": [sig...], "hits": n, "misses": n, "compile_s": s}
        self.fns: Dict[str, dict] = {}

    def _entry(self, name: str) -> dict:
        with self._lock:
            e = self.fns.get(name)
            if e is None:
                e = self.fns[name] = {"sigs": [], "hits": 0, "misses": 0,
                                      "compile_s": 0.0}
            return e

    def record(self, name: str, miss: bool, wall_s: float,
               sig: Optional[str] = None) -> dict:
        """Fold one call in; returns the function's entry (callers read
        ``n_sigs`` off it for the event payload)."""
        e = self._entry(name)
        with self._lock:
            if miss:
                e["misses"] += 1
                e["compile_s"] += wall_s
                if sig is not None and sig not in e["sigs"]:
                    e["sigs"].append(sig)
            else:
                e["hits"] += 1
        if _events.ENABLED:
            m = _perf_metrics()
            if miss:
                m["jit_misses"].inc(tags={"fn": name})
                m["jit_compile"].observe(wall_s, tags={"fn": name})
                _events.emit(
                    "perf", "jit compile", severity="DEBUG",
                    entity_id=name, span_dur=wall_s, fn=name,
                    signature=sig, n_sigs=len(e["sigs"]),
                    misses=e["misses"], hits=e["hits"])
            else:
                m["jit_hits"].inc(tags={"fn": name})
        return e

    def wrap(self, fn, name: Optional[str] = None,
             profiler: Optional["StepProfiler"] = None):
        """Wrap a callable: every call is classified hit/miss by its shape
        signature, misses billed to the ``compile`` phase of the hosting
        profiler step (hits to ``compute``) and recorded per signature.
        Under a profiler on a CUDA device the call ends on the card's time
        (``torch.cuda.synchronize``) before it is billed."""
        name = name or getattr(fn, "__name__", None) or "step_fn"
        tracker = self
        seen = set()

        def wrapped(*args, **kwargs):
            sig = _signature(args, kwargs)
            miss = sig not in seen
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if profiler is not None:
                profiler._sync()
            dt = time.perf_counter() - t0
            seen.add(sig)
            tracker.record(name, miss, dt, sig if miss else None)
            if profiler is not None:
                profiler._bill("compile" if miss else "compute", dt)
            return out

        wrapped.__name__ = name
        return wrapped

    def table(self) -> List[dict]:
        with self._lock:  # snapshot only; sort after release
            items = [(name, dict(e, sigs=list(e["sigs"])))
                     for name, e in self.fns.items()]
        return [{
            "fn": name, "hits": e["hits"], "misses": e["misses"],
            "compile_s": round(e["compile_s"], 6),
            "n_sigs": len(e["sigs"]), "signatures": e["sigs"],
        } for name, e in sorted(items)]


# process-global active profiler: helpers that sit below the train loop
# (torch_utils.allreduce_grads billing the collective phase) reach it here
_ACTIVE: Optional["StepProfiler"] = None
_ACTIVE_LOCK = threading.Lock()


def active_profiler() -> Optional["StepProfiler"]:
    return _ACTIVE


def local_summary() -> Optional[dict]:
    """The installed profiler's summary, or None (what
    ``BackendExecutor.perf_summaries`` runs on each rank)."""
    p = _ACTIVE
    return p.summary() if p is not None else None


class StepProfiler:
    """Attribute every step of a device loop to phases + live MFU.

    ::

        prof = StepProfiler(flops_per_token=fpt, tokens_per_step=B * T,
                            rank=rank).install()
        step_fn = prof.wrap_jit(train_step, name="train_step")
        for batch in batches:
            with prof.step():
                with prof.phase("ingest"):
                    host = next(it)
                with prof.phase("h2d"):
                    dev = host.to(device, non_blocking=True)
                loss = step_fn(model, dev)   # compile | compute

    Phase scopes are sequential within a step (the loop IS sequential);
    the residual between their sum and the step wall is billed to
    ``other`` so ``sum(phases) == wall`` holds exactly per step and in
    aggregate.  A step that raises is not recorded (a partial phase set
    would skew every fraction).

    ``device`` is the device the step runs on: on a CUDA device each
    phase, wrapped call and step ends in ``torch.cuda.synchronize`` (see
    the module docstring), and the MFU's peak is the card's
    (``util/flops.py``; a device the table does not know, or the CPU,
    gives no MFU unless ``peak`` is passed)."""

    def __init__(self, *, flops_per_token: Optional[float] = None,
                 tokens_per_step: Optional[int] = None,
                 device: Any = None, device_kind: Optional[str] = None,
                 peak: Optional[float] = None, rank: int = 0,
                 hbm_every: int = 1, keep_steps: int = 512):
        self.flops_per_token = flops_per_token
        self.tokens_per_step = tokens_per_step
        self.rank = int(rank)
        self._device = torch.device(device) if device is not None else None
        self._peak = peak
        self._device_kind = device_kind
        self.hbm_every = max(0, int(hbm_every))
        self.compiles = CompileTracker()
        self._lock = threading.Lock()
        self.steps: deque = deque(maxlen=max(1, int(keep_steps)))
        self._phase_totals: Dict[str, float] = {}
        self._wall_total = 0.0
        self._tokens_total = 0
        self._n_steps = 0
        self._last_mfu: Optional[float] = None
        self._last_hbm: Optional[dict] = None
        # per-open-step state (one step open at a time, loop-thread owned)
        self._open = False
        self._t0 = 0.0
        self._cur_phases: Dict[str, float] = {}
        self._cur_tokens: Optional[int] = None
        self._trace_dir: Optional[str] = None

    # -- wiring --------------------------------------------------------
    def install(self) -> "StepProfiler":
        """Publish as the process's active profiler (``active_profiler``
        / ``local_summary`` / collective-phase billing find it here)."""
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def wrap_jit(self, fn, name: Optional[str] = None):
        return self.compiles.wrap(fn, name=name, profiler=self)

    def arm_trace(self, logdir: str) -> None:
        """Capture ONE ``torch.profiler`` trace around the next step
        (``util/profiling.profile_trace``)."""
        self._trace_dir = logdir

    def _sync(self) -> None:
        """End on the card's time: wait for what the step enqueued."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # -- step/phase scopes ---------------------------------------------
    @contextlib.contextmanager
    def step(self, tokens: Optional[int] = None):
        trace_cm = None
        if self._trace_dir is not None:
            from ray_tpu_torch.util import profiling

            trace_cm = profiling.profile_trace(self._trace_dir)
            self._trace_dir = None
            trace_cm.__enter__()
        self._open = True
        self._cur_phases = {}
        self._cur_tokens = tokens
        self._t0 = time.perf_counter()
        try:
            yield self
            self._sync()
            self._finish_step(time.perf_counter() - self._t0)
        finally:
            self._open = False
            if trace_cm is not None:
                trace_cm.__exit__(None, None, None)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
            self._sync()
        finally:
            self._bill(name, time.perf_counter() - t0)

    def _bill(self, name: str, dur_s: float) -> None:
        if not self._open:
            return  # helper ran outside a step: nothing to attribute to
        self._cur_phases[name] = self._cur_phases.get(name, 0.0) + dur_s

    # -- recording -----------------------------------------------------
    def _finish_step(self, raw_wall: float) -> None:
        phases = dict(self._cur_phases)
        covered = sum(phases.values())
        # exact-sum invariant: the residual is billed to "other"; if
        # float error puts covered a hair past the raw wall, the wall is
        # the covered sum (phases can never exceed the step they're in)
        wall = max(raw_wall, covered)
        phases["other"] = wall - covered
        tokens = self._cur_tokens if self._cur_tokens is not None \
            else self.tokens_per_step
        mfu = None
        if tokens and self.flops_per_token and wall > 0:
            mfu = self._mfu(tokens / wall)
        with self._lock:
            self._n_steps += 1
            n = self._n_steps
            self._wall_total += wall
            self._tokens_total += int(tokens or 0)
            for k, v in phases.items():
                self._phase_totals[k] = self._phase_totals.get(k, 0.0) + v
            self._last_mfu = mfu if mfu is not None else self._last_mfu
            self.steps.append({"step": n, "wall_s": wall,
                               "phases": phases, "mfu": mfu,
                               "tokens": tokens})
        if not _events.ENABLED:
            return
        m = _perf_metrics()
        rank_tag = {"rank": str(self.rank)}
        m["step_wall"].observe(wall, tags=rank_tag)
        for k, v in phases.items():
            m["phase"].observe(v, tags={"phase": k, "rank": str(self.rank)})
        if mfu is not None:
            m["mfu"].set(mfu, tags=rank_tag)
        if self.hbm_every and n % self.hbm_every == 0:
            self._last_hbm = publish_device_memory(self._device) \
                or self._last_hbm
        _events.emit(
            "perf", "step phases", severity="DEBUG",
            entity_id=f"rank{self.rank}", span_dur=wall, step=n,
            phases={k: round(v, 6) for k, v in phases.items()},
            wall_s=round(wall, 6),
            **({"mfu": round(mfu, 5)} if mfu is not None else {}),
            **({"tokens": int(tokens)} if tokens else {}))

    def _resolve_device_kind(self) -> str:
        if self._device_kind is None:
            dev = self._device
            self._device_kind = (torch.cuda.get_device_name(dev)
                                 if dev is not None and dev.type == "cuda" else "")
        return self._device_kind

    def _mfu(self, tokens_per_s: float) -> Optional[float]:
        """``util/flops.py``'s MFU over ``peak`` or the card's bf16 peak;
        None on a device whose peak the table does not know."""
        peak = self._peak
        if peak is None:
            try:
                peak = flops_mod.peak_flops(self._resolve_device_kind())
            except KeyError:
                return None
        return tokens_per_s * self.flops_per_token / peak

    # -- aggregate -----------------------------------------------------
    def summary(self) -> dict:
        """The in-process aggregate: phase totals (summing exactly to
        the summed step walls), time-weighted mean + last MFU, the
        compile table, the last HBM sample."""
        with self._lock:  # snapshot only; sort/derive after release
            wall = self._wall_total
            phase_totals = dict(self._phase_totals)
            tokens_total = self._tokens_total
            n_steps = self._n_steps
            last_mfu = self._last_mfu
            last_hbm = self._last_hbm
        phases = {
            k: {"s": round(v, 9),
                "frac": round(v / wall, 4) if wall > 0 else 0.0}
            for k, v in sorted(phase_totals.items(),
                               key=lambda kv: -kv[1])}
        mean_mfu = None
        if tokens_total and self.flops_per_token and wall > 0:
            mean_mfu = self._mfu(tokens_total / wall)
        return {
            "rank": self.rank,
            "steps": n_steps,
            "wall_s": round(wall, 9),
            "tokens": tokens_total,
            "phases": phases,
            "mfu": {
                "last": round(last_mfu, 5)
                if last_mfu is not None else None,
                "mean": round(mean_mfu, 5)
                if mean_mfu is not None else None,
            },
            "hbm": last_hbm,
            "compiles": self.compiles.table(),
        }
