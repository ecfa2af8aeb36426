"""Grafana dashboard-as-code from the live metrics registry.

Analog of the reference's ``dashboard/modules/metrics/
grafana_dashboard_factory.py``: instead of hand-maintaining dashboard
JSON, the panel list is generated from what the registry actually
exports — every Counter becomes a rate panel, every Gauge a value panel,
every Histogram a p50/p99 quantile panel — so a metric added anywhere in
the codebase shows up on the next generation with zero dashboard work.

Served from the head (``GET /api/grafana_dashboard``); import it into
Grafana against a Prometheus scraping the head's ``/metrics``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Metrics the dashboard always charts, even before anything observes them
# (name -> (type, help)).  Keeps the core cluster row stable across
# restarts when the registry is still cold.
CORE_METRICS: Dict[str, tuple] = {
    "ray_tpu_tasks": ("gauge", "tasks by state"),
    "ray_tpu_num_workers": ("gauge", "live workers"),
    "ray_tpu_num_nodes": ("gauge", "alive nodes"),
    "ray_tpu_sched_queue_depth": ("gauge", "tasks pending cluster-wide"),
    "ray_tpu_sched_dispatch_latency_s": ("histogram", "submit -> dispatch latency"),
    "ray_tpu_object_store_bytes": ("gauge", "head-local shm bytes"),
    "ray_tpu_object_put_latency_s": ("histogram", "object put latency"),
    "ray_tpu_object_get_latency_s": ("histogram", "object get latency"),
    "ray_tpu_torch_streaming_blocks_total": ("counter", "blocks submitted per operator"),
    "ray_tpu_torch_streaming_stall_s_total": ("counter", "pump backpressure stall seconds"),
    "ray_tpu_serve_admission_latency_s": ("histogram", "serve admission latency"),
    "ray_tpu_serve_router_queue_len": ("gauge", "router queue length"),
    "ray_tpu_llm_generated_tokens_total": ("counter", "LLM tokens generated"),
    "ray_tpu_llm_slot_admission_latency_s": ("histogram", "decode-slot admission latency"),
    "ray_tpu_train_step_time_s": ("histogram", "train step time"),
    "ray_tpu_torch_data_ingest_wait_s_total": ("counter", "train ingest-wait seconds"),
    # perf observability (util/perf.py + serve/llm.py decode attribution)
    "ray_tpu_train_phase_seconds": ("histogram", "step-phase wall seconds"),
    "ray_tpu_train_step_mfu": ("gauge", "live per-step MFU"),
    "ray_tpu_jit_cache_misses_total": ("counter", "jit compiles (cache misses)"),
    "ray_tpu_hbm_bytes_in_use": ("gauge", "device memory in use"),
    "ray_tpu_llm_ttft_s": ("histogram", "LLM time-to-first-token"),
    "ray_tpu_llm_itl_s": ("histogram", "LLM inter-token latency"),
    "ray_tpu_llm_prefill_interference_s_total":
        ("counter", "decode-tick seconds billed to prefill"),
    # continuous-profiling plane (sampling_profiler + locks)
    "ray_tpu_profiler_duty_frac": ("gauge", "profiler duty cycle fraction"),
    "ray_tpu_gil_lateness_frac": ("gauge", "GIL pressure (tick lateness)"),
    "ray_tpu_lock_wait_s": ("gauge", "named-lock wait seconds (ewma)"),
    "ray_tpu_lock_hold_s": ("gauge", "named-lock hold seconds (ewma)"),
    "ray_tpu_profile_serialization_frac":
        ("gauge", "profiled time in serialization"),
    # cluster log plane (log ship / suppression pressure)
    "ray_tpu_log_records_total": ("counter", "log records ingested"),
    "ray_tpu_log_suppressed_total":
        ("counter", "log records dropped by rate suppression"),
    # serve SLO taps (watchdog plane)
    "ray_tpu_serve_http_p99_s": ("gauge", "serve HTTP p99 (trailing window)"),
    "ray_tpu_serve_http_requests_total":
        ("counter", "serve HTTP requests by status class"),
}

_PANEL_W = 12  # two panels per 24-unit grafana row
_PANEL_H = 8


def _target(expr: str, legend: str) -> dict:
    return {"expr": expr, "legendFormat": legend, "refId": "A"}


def _targets_for(name: str, mtype: str) -> List[dict]:
    if mtype == "counter":
        return [_target(f"sum(rate({name}[5m]))", f"{name}/s")]
    if mtype == "histogram":
        return [
            {"expr": (f"histogram_quantile(0.5, "
                      f"sum(rate({name}_bucket[5m])) by (le))"),
             "legendFormat": "p50", "refId": "A"},
            {"expr": (f"histogram_quantile(0.99, "
                      f"sum(rate({name}_bucket[5m])) by (le))"),
             "legendFormat": "p99", "refId": "B"},
        ]
    return [_target(name, name)]  # gauge


def _panel(panel_id: int, name: str, mtype: str, help_: str,
           x: int, y: int) -> dict:
    return {
        "id": panel_id,
        "title": help_ or name,
        "description": f"{name} ({mtype})",
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"x": x, "y": y, "w": _PANEL_W, "h": _PANEL_H},
        "targets": _targets_for(name, mtype),
        "fieldConfig": {"defaults": {"custom": {"fillOpacity": 10}},
                        "overrides": []},
    }


def _apply_slo_threshold(panel: dict, slo: dict) -> None:
    """Render a declared SLO as a Grafana threshold line on its metric's
    panel — the same objective the watchdog alerts on, drawn where the
    operator looks."""
    # ">=" objectives (floors) alarm BELOW the threshold; "<=" above
    floor = slo.get("op") == ">="
    steps = [{"color": "red" if floor else "green", "value": None},
             {"color": "green" if floor else "red",
              "value": slo["threshold"]}]
    defaults = panel["fieldConfig"]["defaults"]
    defaults["thresholds"] = {"mode": "absolute", "steps": steps}
    defaults.setdefault("custom", {})["thresholdsStyle"] = {"mode": "line"}
    panel["description"] = (panel.get("description", "") +
                            f" | SLO {slo['name']}: {slo.get('op', '<=')} "
                            f"{slo['threshold']}")


def generate_grafana_dashboard(snapshot: Optional[Dict[str, dict]] = None,
                               tsdb=None,
                               slos: Optional[List[dict]] = None) -> dict:
    """Build the dashboard dict from a registry snapshot (defaults to this
    process's registry).  Deterministic layout: core metrics first in
    their declared order, then any extra registered metric sorted by name.

    ``tsdb`` (a ``util.tsdb.TimeSeriesStore``) widens the panel set to
    every metric with retained HISTORY — including series whose origin
    (a dead worker, a drained node) already expired from the live
    registry, which is exactly when an operator builds the dashboard to
    investigate.

    ``slos`` (rows shaped like ``watchdog.Watchdog.slos()``) draw each
    declared objective as a threshold line on its metric's panel, so the
    alerting objective and the dashboard can never disagree."""
    if snapshot is None:
        from ray_tpu_torch.util import metrics as metrics_mod

        snapshot = metrics_mod.registry().snapshot()
    metrics: Dict[str, tuple] = dict(CORE_METRICS)
    extra: Dict[str, tuple] = {}
    for name, m in snapshot.items():
        extra[name] = (m["type"], m.get("help", ""))
    if tsdb is not None:
        for row in tsdb.list_metrics():
            extra.setdefault(row["name"], (row["type"], row.get("help", "")))
    for name in sorted(extra):
        metrics[name] = extra[name]
    # threshold-kind SLOs attach to their metric's panel (ratio SLOs
    # have no single-series threshold to draw)
    slo_by_metric = {s["metric"]: s for s in (slos or [])
                     if s.get("kind", "threshold") == "threshold"}
    panels = []
    for i, (name, (mtype, help_)) in enumerate(metrics.items()):
        x = (i % 2) * _PANEL_W
        y = (i // 2) * _PANEL_H
        panel = _panel(i + 1, name, mtype, help_, x, y)
        if name in slo_by_metric:
            _apply_slo_threshold(panel, slo_by_metric[name])
        panels.append(panel)
    return {
        "uid": "ray-tpu-torch-default",
        "title": "ray_tpu_torch cluster",
        "description": "generated by ray_tpu_torch.dashboard.grafana_dashboard_factory",
        "tags": ["ray_tpu_torch", "generated"],
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource", "type": "datasource", "query": "prometheus",
            "label": "Data source",
        }]},
        "panels": panels,
        "schemaVersion": 39,
        "version": 1,
    }

