"""Per-trace critical-path analysis over assembled span trees (the
port's copy of ``ray_tpu/util/trace_analysis.py``).

Input is what ``experimental.state.api.get_trace`` returns: a flat list of
spans (``{name, span_id, parent_span_id, phase, source, start, end}``)
assembled by the head's TraceTable from flight-recorder span events plus
task-table rows.  This module answers the question the trace exists for:
*where did the wall time of this request go* — router admission vs
scheduler queue vs execution vs channel wait vs object transfer.

Method: a time sweep over the trace window attributing every instant to
the DEEPEST span covering it (nesting depth via the parent chain; ties go
to the later-started span).  That yields

- ``phases``: seconds per phase, summing exactly to the trace wall time
  (instants no span covers are ``idle`` — uninstrumented gaps), and
- ``critical_path``: the deepest-span sequence in time order — the chain
  of operations that actually gated completion; shortening anything OFF
  this path cannot shorten the request.

O(B * S) for B interval boundaries over S spans — traces are capped at
``RAY_TPU_TORCH_TRACE_SPANS`` spans, so this stays interactive.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _depths(spans: List[dict]) -> Dict[int, int]:
    """Nesting depth per span (id() keyed — span_ids may collide across
    malformed inputs and synthetic task sub-spans must stay distinct)."""
    by_id: Dict[str, dict] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid:
            by_id.setdefault(sid, s)
    depths: Dict[int, int] = {}
    for s in spans:
        d = 0
        seen = set()
        cur = s
        while True:
            pid = cur.get("parent_span_id")
            if not pid or pid in seen or pid not in by_id:
                break
            seen.add(pid)
            cur = by_id[pid]
            d += 1
        depths[id(s)] = d
    return depths


def analyze(trace: Optional[dict]) -> dict:
    """Phase attribution + critical path for one assembled trace."""
    import heapq

    spans = [s for s in (trace or {}).get("spans", [])
             if s.get("start") is not None and s.get("end") is not None
             and s["end"] >= s["start"]]
    if not spans:
        return {"wall_s": 0.0, "num_spans": 0, "phases": {},
                "critical_path": []}
    depths = _depths(spans)
    start = min(s["start"] for s in spans)
    end = max(s["end"] for s in spans)
    bounds = sorted({s["start"] for s in spans} | {s["end"] for s in spans})
    # Sorted sweep with a lazy-deletion max-heap: O((S+B) log S), where a
    # per-interval covering rescan would be O(B*S) — a traced 10k-task job
    # joins ~30k spans and must stay interactive on the head's HTTP
    # thread.  Every span start/end is itself a boundary, so a span with
    # end > a covers the whole interval [a, b).
    by_start = sorted(spans, key=lambda s: s["start"])
    heap: List[tuple] = []  # (-depth, -start, end, tiebreak, span)
    si = 0
    phases: Dict[str, float] = {}
    segments: List[dict] = []
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        while si < len(by_start) and by_start[si]["start"] <= a:
            s = by_start[si]
            heapq.heappush(
                heap, (-depths[id(s)], -s["start"], s["end"], si, s))
            si += 1
        while heap and heap[0][2] <= a:  # ended at/before this interval
            heapq.heappop(heap)
        if not heap:
            phases["idle"] = phases.get("idle", 0.0) + (b - a)
            continue
        deepest = heap[0][4]
        phase = deepest.get("phase") or "span"
        phases[phase] = phases.get(phase, 0.0) + (b - a)
        if segments and segments[-1]["_span"] is deepest:
            segments[-1]["end"] = b
        else:
            segments.append({"_span": deepest, "start": a, "end": b})
    critical = [
        {
            "name": seg["_span"].get("name", ""),
            "phase": seg["_span"].get("phase") or "span",
            "source": seg["_span"].get("source"),
            "span_id": seg["_span"].get("span_id"),
            "start": seg["start"],
            "duration_s": round(seg["end"] - seg["start"], 6),
        }
        for seg in segments
    ]
    return {
        "wall_s": round(end - start, 6),
        "num_spans": len(spans),
        "phases": {k: round(v, 6) for k, v in
                   sorted(phases.items(), key=lambda kv: -kv[1])},
        "critical_path": critical,
    }


def span_tree_lines(trace: dict) -> List[str]:
    """The span tree as indented text lines (children under parents,
    both in start order; orphaned parents render at the root level)."""
    spans = sorted((trace or {}).get("spans", []),
                   key=lambda s: (s.get("start") or 0.0))
    ids = {s.get("span_id") for s in spans if s.get("span_id")}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        pid = s.get("parent_span_id")
        if pid and pid in ids and pid != s.get("span_id"):
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    t0 = min((s.get("start") or 0.0) for s in spans) if spans else 0.0
    lines: List[str] = []

    def walk(s: dict, depth: int) -> None:
        dur_ms = ((s.get("end") or 0.0) - (s.get("start") or 0.0)) * 1e3
        off_ms = ((s.get("start") or 0.0) - t0) * 1e3
        lines.append(
            f"{'  ' * depth}{s.get('name', '?'):<40.40s} "
            f"+{off_ms:9.2f}ms {dur_ms:9.2f}ms  "
            f"[{s.get('phase', 'span')}] {s.get('source') or ''}")
        for c in children.get(s.get("span_id"), ()):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return lines


def render_trace(trace: dict, analysis: Optional[dict] = None) -> str:
    """Human-readable report for ``ray_tpu_torch trace <id>``: the span tree,
    the phase attribution table, and the critical path."""
    if not trace or not trace.get("spans"):
        return "(trace unknown or empty)"
    a = analysis or analyze(trace)
    out = [f"trace {trace.get('trace_id', '?')} — "
           f"{a['num_spans']} spans, wall {a['wall_s'] * 1e3:.2f}ms"]
    if trace.get("dropped_spans"):
        out.append(f"  ({trace['dropped_spans']} spans dropped at the "
                   f"per-trace cap)")
    out.append("")
    out.extend(span_tree_lines(trace))
    out.append("")
    out.append("phase attribution (critical-path share of wall time):")
    wall = a["wall_s"] or 1.0
    for phase, secs in a["phases"].items():
        out.append(f"  {phase:<18s} {secs * 1e3:9.2f}ms  "
                   f"{100.0 * secs / wall:5.1f}%")
    out.append("")
    out.append("critical path:")
    for seg in a["critical_path"]:
        out.append(f"  {seg['duration_s'] * 1e3:9.2f}ms  "
                   f"[{seg['phase']}] {seg['name']}")
    return "\n".join(out)
