"""The port's own spans, joined to the device trace of a stretch.

While a stretch is traced the process is armed (``ray_tpu_torch.util.
tracing.arm``): every ``tracing.span`` the port passes through leaves a
row in the process's flight recorder, with its start on the epoch clock
(the trace's clock), its length and the thread it ran on.  Joined to the
trace, each span name gets:

- ``count``: its spans that overlap the stretch;
- ``host_s``: the union of their host ranges, cut to the stretch;
- ``device_s``: the union of the device operations launched from a
  span's thread inside its host range, cut to the stretch.  CUPTI records
  each runtime call (a launch, a copy, a set) with the thread that made it
  (the low 32 bits of ``pthread_self``, which is ``threading.get_ident()``)
  and a correlation id that its device operation carries too;
- ``extent_s``: from the first span's start to the last one's end, cut to
  the stretch.

The spans also join the host operations by which ``trace.summarize``
names idle gaps: a gap in no CUDA call is put down to the innermost span
around its middle.

:func:`summary` is what a traced stretch reports with the spans; the
readers below read its ``regions``, and each returns None where the
summary has none (a trace taken without the spans).
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from portbench import flops
from portbench.trace import MARK, _union, summarize

Ctx = Dict[str, Any]
# CUPTI's thread id of a runtime call: the low 32 bits of pthread_self
THREAD_BITS = 0xFFFFFFFF
# the cache's bytes per element (the configurations' bfloat16)
KV_ELEM_BYTES = 2


def arm() -> int:
    """Arm the process's spans; the flight recorder's last sequence number
    before the stretch, for :func:`recorded`."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch.util import tracing

    since = events.buffer().last_seq()
    tracing.arm(True)
    return since


def disarm() -> None:
    from ray_tpu_torch.util import tracing

    tracing.arm(False)


def recorded(since: int) -> Tuple[List[Dict[str, Any]], int]:
    """The armed spans the flight recorder holds from after ``since``
    (name, start, end in epoch ns, thread), and how many rows of that
    stretch the ring has dropped already (0 while it holds them all)."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch.util.tracing import TRACE_SOURCE

    rows = [r for r in events.local_events() if r["seq"] > since]
    lost = rows[0]["seq"] - since - 1 if rows else events.buffer().last_seq() - since
    out = []
    for r in rows:
        d = r.get("data") or {}
        if r["source"] == TRACE_SOURCE and "start_ns" in d:
            out.append({"name": r["message"], "start": d["start_ns"],
                        "end": d["start_ns"] + round(r["span_dur"] * 1e9),
                        "thread": d["thread"]})
    return out, max(0, lost)


class _HostOp:
    """A span as ``trace.summarize`` reads a host operation."""

    __slots__ = ("_name", "_start", "_dur")

    def __init__(self, span: Dict[str, Any]):
        self._name, self._start, self._dur = span["name"], span["start"], span["end"] - span["start"]

    def name(self) -> str:
        return self._name

    def start_ns(self) -> int:
        return self._start

    def duration_ns(self) -> int:
        return self._dur

    def device_type(self):
        return torch.autograd.DeviceType.CPU

    def is_user_annotation(self) -> bool:
        return False


def _stretch(events, lo: int, hi: int) -> Tuple[int, int]:
    """``[lo, hi]``, or the ``MARK`` range where the trace holds it on the
    host, as ``summarize`` takes it."""
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA and e.name() == MARK:
            return e.start_ns(), e.start_ns() + e.duration_ns()
    return lo, hi


def regions(events, lo: int, hi: int, spans: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """By span name: ``count``, ``host_s``, ``device_s`` and ``extent_s``
    over the stretch ``[lo, hi]`` (epoch ns)."""
    lo, hi = _stretch(events, lo, hi)
    dev: Dict[int, List[Tuple[int, int]]] = {}  # correlation id -> device intervals
    calls = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() != MARK:
                dev.setdefault(e.correlation_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.correlation_id():
            calls.append(e)
    launches: Dict[int, List[Tuple[int, int]]] = {}  # thread -> (start, correlation id)
    for e in calls:
        if e.correlation_id() in dev:
            launches.setdefault(e.device_resource_id() & THREAD_BITS, []).append(
                (e.start_ns(), e.correlation_id()))
    for v in launches.values():
        v.sort()
    by_name: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if s["end"] <= lo or s["start"] >= hi:
            continue
        r = by_name.setdefault(s["name"], {"count": 0, "host": [], "dev": [],
                                           "first": s["start"], "last": s["end"]})
        r["count"] += 1
        r["first"], r["last"] = min(r["first"], s["start"]), max(r["last"], s["end"])
        r["host"].append((max(s["start"], lo), min(s["end"], hi)))
        mine = launches.get(s["thread"] & THREAD_BITS, [])
        i = bisect.bisect_left(mine, (s["start"], -1))
        while i < len(mine) and mine[i][0] <= s["end"]:
            r["dev"].extend((max(a, lo), min(b, hi)) for a, b in dev[mine[i][1]] if b > lo and a < hi)
            i += 1
    seconds = lambda iv: sum(b - a for a, b in _union(iv)) / 1e9
    return {name: {"count": r["count"], "host_s": seconds(r["host"]), "device_s": seconds(r["dev"]),
                   "extent_s": (min(r["last"], hi) - max(r["first"], lo)) / 1e9}
            for name, r in by_name.items()}


def join(events, lo: int, hi: int, spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """``trace.summarize`` of the stretch with ``spans`` among its host
    operations, and their ``regions``."""
    events = list(events)
    out = summarize(events + [_HostOp(s) for s in spans], lo, hi)
    out["regions"] = regions(events, lo, hi, spans)
    return out


def summary(events, lo: int, hi: int, since: int) -> Dict[str, Any]:
    """:func:`join` with the spans recorded after ``since``, the rows read
    (``span_rows``) and those the flight recorder dropped
    (``span_rows_lost``)."""
    spans, lost = recorded(since)
    return dict(join(events, lo, hi, spans), span_rows=len(spans), span_rows_lost=lost)


# -- readers: each returns None where the trace holds no regions ----------

def _regions(ctx: Ctx) -> Optional[Dict[str, Dict[str, float]]]:
    tr = ctx.get("trace") or {}
    if "regions" not in tr or tr.get("span_rows_lost"):
        return None
    return tr["regions"]


def prefill_share_decode(ctx: Ctx) -> Optional[float]:
    """Percent of the stretch's busy device seconds that the engine's
    prefills (``engine.prefill``: the admission's prefill and its first
    tokens' sample) launched."""
    reg = _regions(ctx)
    if reg is None or ctx["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * reg.get("engine.prefill", {}).get("device_s", 0.0) / ctx["trace"]["busy_s"]


def decode_attend_roofline_decode(ctx: Ctx) -> Optional[float]:
    """Percent: the least seconds of one layer's decode attention over the
    device seconds it took (``gen.decode_attend``, per span).  The least
    reads the K and V of the positions the active rows attend once, at
    the cache's bytes, at the card's bandwidth; the positions a step are
    the engine's ``kv_positions_attended`` over its ``decode_steps``
    across the untraced part of the window."""
    reg = (_regions(ctx) or {}).get("gen.decode_attend")
    peak = flops.peak(ctx.get("kind", ""))
    c = (ctx.get("untraced") or {}).get("counters", {})
    if not reg or not reg["count"] or reg["device_s"] <= 0 or peak is None or "open" not in c:
        return None
    a, b = c["open"]["stats"], c["close"]["stats"]
    if "decode_steps" not in a:
        return None
    steps = b["decode_steps"] - a["decode_steps"]
    if steps <= 0:
        return None
    positions = (b["kv_positions_attended"] - a["kv_positions_attended"]) / steps
    d = ctx["dims"]
    dh = d["d_model"] // d["n_heads"]
    least = positions * d.get("n_kv_heads", d["n_heads"]) * dh * 2 * KV_ELEM_BYTES / peak["hbm_bytes"]
    return 100.0 * least / (reg["device_s"] / reg["count"])


def batch_wait_share_score(ctx: Ctx) -> Optional[float]:
    """Percent of the scoring actor's time outside every ``predict.batch``
    span, from the first one's start to the last one's end in the stretch
    (the stretch starts and stops inside a batch: its first batch's span
    began unarmed)."""
    reg = (_regions(ctx) or {}).get("predict.batch")
    if not reg or reg["extent_s"] <= 0:
        return None
    return 100.0 * (1.0 - reg["host_s"] / reg["extent_s"])
