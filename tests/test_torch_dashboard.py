"""The port's dashboard (``ray_tpu_torch.dashboard``) against the JAX
package's: the Prometheus text of one registry, the Grafana factory's
JSON, the Serve config schema's errors, and on the port's runtime alone
(no JAX head) the routes of ``tests/test_observability.py``, the REST
config deploy of ``tests/test_serve_config_deploy.py``, on-demand
profiles of the head and of a worker, and the CLI's ``serve-deploy`` and
``profile --worker-id`` through the dashboard.

The Grafana JSON differs from the JAX package's only by the port's
renames: its ``uid`` (``ray-tpu-torch-default``), title, description and
tags, and three core metrics the port names ``ray_tpu_torch_*`` (its
streaming and ingest counters); every other metric keeps its
``ray_tpu_*`` name.  The head's dashboard binds 127.0.0.1 on a port the
kernel picks.  Every process runs under a private ``TMPDIR`` and each
test has its own time limit.
"""

import contextlib
import io
import json
import os
import signal
import sys
import tempfile
import textwrap
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker

T = 60  # seconds: every wait in this file
RENAMED_CORE = ("streaming_blocks_total", "streaming_stall_s_total",
                "data_ingest_wait_s_total")


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its 90 s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(90)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


# -- pure functions, against the JAX package ----------------------------------

def _fill(metrics_mod, reg, tag):
    """One counter, gauge and histogram, with and without labels."""
    c = metrics_mod.Counter(f"dash_{tag}_requests_total", "requests", tag_keys=("route",))
    c.inc(3, tags={"route": "/a"})
    c.inc(1, tags={"route": 'q"uote\\'})
    g = metrics_mod.Gauge(f"dash_{tag}_depth", "queue depth")
    g.set(7.5)
    h = metrics_mod.Histogram(f"dash_{tag}_latency_s", "latency", boundaries=[0.01, 0.1, 1.0])
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    return {k: v for k, v in reg.snapshot().items() if k.startswith(f"dash_{tag}_")}


def test_prometheus_text_of_the_same_registry_matches_the_jax_packages():
    from ray_tpu.util import metrics as jax_metrics

    from ray_tpu_torch.util import metrics

    ours = _fill(metrics, metrics.registry(), "p")
    ref = _fill(jax_metrics, jax_metrics.registry(), "p")
    assert ours == ref
    text = metrics.prometheus_text(ours)
    assert text == jax_metrics.prometheus_text(ref)
    assert 'dash_p_latency_s_bucket{le="0.1"} 2' in text and "dash_p_depth 7.5" in text


def _renamed(dash):
    """The JAX package's dashboard JSON with the port's renames applied."""
    out = json.loads(json.dumps(dash))
    out.update(uid="ray-tpu-torch-default", title="ray_tpu_torch cluster",
               description="generated by ray_tpu_torch.dashboard.grafana_dashboard_factory",
               tags=["ray_tpu_torch", "generated"])
    text = json.dumps(out)
    for name in RENAMED_CORE:
        text = text.replace(f"ray_tpu_{name}", f"ray_tpu_torch_{name}")
    return json.loads(text)


def test_grafana_factory_matches_the_jax_packages_with_the_renames():
    from ray_tpu.dashboard.grafana_dashboard_factory import (
        generate_grafana_dashboard as jax_generate,
    )

    from ray_tpu_torch.dashboard.grafana_dashboard_factory import (
        generate_grafana_dashboard,
    )

    snap = {"my_counter_total": {"type": "counter", "help": "c", "values": {}},
            "my_hist_s": {"type": "histogram", "help": "h", "values": {}},
            "my_gauge": {"type": "gauge", "help": "g", "values": {}}}
    slos = [{"name": "p99", "metric": "my_gauge", "op": "<=", "threshold": 0.5},
            {"name": "floor", "metric": "my_counter_total", "op": ">=", "threshold": 2.0}]
    for s in (None, slos):
        ours = generate_grafana_dashboard(snap, slos=s)
        assert ours == _renamed(jax_generate(snap, slos=s))
    panels = {p["description"].split(" ")[0]: p for p in ours["panels"]}
    assert "rate(my_counter_total[5m])" in panels["my_counter_total"]["targets"][0]["expr"]
    assert any("histogram_quantile(0.99" in t["expr"] and "my_hist_s_bucket" in t["expr"]
               for t in panels["my_hist_s"]["targets"])
    assert panels["my_gauge"]["targets"][0]["expr"] == "my_gauge"
    assert any("ray_tpu_sched_queue_depth" in p["description"] for p in ours["panels"])


BAD_CONFIGS = [
    {},
    {"applications": [{"name": "a"}]},
    {"applications": [{"import_path": "m:x", "route_prefix": "noslash"}]},
    {"applications": [{"import_path": "m:x", "deployments": [{"name": "d",
                                                              "num_replicas": -1}]}]},
    {"applications": [{"import_path": "m:x", "bogus": 1}]},
    {"applications": "nope"},
]


@pytest.mark.parametrize("raw", BAD_CONFIGS, ids=range(len(BAD_CONFIGS)))
def test_parse_deploy_config_errors_match_the_jax_packages(raw):
    from ray_tpu.serve.schema import SchemaError as JaxSchemaError
    from ray_tpu.serve.schema import parse_deploy_config as jax_parse

    from ray_tpu_torch.serve.schema import SchemaError, parse_deploy_config

    with pytest.raises(JaxSchemaError) as ref:
        jax_parse(raw)
    with pytest.raises(SchemaError) as ours:
        parse_deploy_config(raw)
    assert str(ours.value) == str(ref.value)


# -- the routes on a live head ------------------------------------------------

APP_MODULE = """
from ray_tpu_torch import serve

@serve.deployment
class ConfigApp:
    def __init__(self, greeting="hello"):
        self.greeting = greeting
        self.threshold = 0.0

    def reconfigure(self, cfg):
        self.threshold = cfg.get("threshold", 0.0)

    def __call__(self, request=None):
        return {"greeting": self.greeting, "threshold": self.threshold}

app = ConfigApp.bind()
"""


@pytest.fixture(scope="module")
def head():
    """A port head (4 CPUs, no card) with workers pushing every 0.25 s,
    the app module of the config deploy on every process's import path."""
    with tempfile.TemporaryDirectory(prefix="dash_") as tmp, \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", tmp)
        mp.setattr(tempfile, "tempdir", tmp)
        mp.setenv("RAY_TPU_TORCH_METRICS_PUSH_S", "0.25")
        with open(os.path.join(tmp, "serve_cfg_torchmod.py"), "w") as f:
            f.write(textwrap.dedent(APP_MODULE))
        mp.setenv("PYTHONPATH", os.pathsep.join(p for p in (tmp, os.environ.get("PYTHONPATH"))
                                                if p))
        mp.syspath_prepend(tmp)
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
        try:
            yield global_worker.node, tmp
        finally:
            from ray_tpu_torch import serve

            serve.shutdown()
            ray_tpu_torch.shutdown()
            sys.modules.pop("serve_cfg_torchmod", None)


def _get(node, path, raw=False):
    host, port = node.dashboard.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=T) as r:
        body = r.read().decode()
    return body if raw else json.loads(body)


def _until(fn, desc, timeout=T):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, f"timed out on {desc}"
        time.sleep(0.1)


@ray_tpu_torch.remote
def _tick():
    from ray_tpu_torch.util.metrics import Gauge

    Gauge("dash_worker_pushed_gauge", "a gauge a task sets").set(42.0)
    return 1


@ray_tpu_torch.remote
class _Spinner:
    def whoami(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"]

    def spin(self, s):
        t = time.monotonic()
        while time.monotonic() - t < s:
            sum(range(1000))
        return True


def test_the_head_starts_its_dashboard_and_records_it(head):
    node, tmp = head
    host, port = node.dashboard.address
    assert host == "127.0.0.1" and port > 0
    with open(os.path.join(tmp, "ray_tpu_torch", "last_session.json")) as f:
        assert json.load(f)["dashboard"] == [host, port]
    snap = global_worker.client.request({"type": "state_snapshot"})["value"]
    assert snap["dashboard"] == [host, port]


def test_state_and_metrics_routes(head):
    node, _ = head
    assert ray_tpu_torch.get([_tick.remote() for _ in range(4)], timeout=T) == [1] * 4
    assert "<title>ray_tpu_torch dashboard</title>" in _get(node, "/", raw=True)
    status = _get(node, "/api/cluster_status")
    assert status["cluster_resources"]["node-head"]["GPU"] == 0.0
    assert status["num_nodes"] == 1 and status["num_workers"] >= 1
    assert _get(node, "/api/nodes")[0]["node_id"] == "node-head"
    rows = _get(node, "/api/events?limit=500")
    assert isinstance(rows, list) and rows
    assert _get(node, "/api/grafana_dashboard")["panels"]
    metrics = _until(lambda: (lambda m: m if "dash_worker_pushed_gauge" in m else None)(
        _get(node, "/metrics", raw=True)), "the worker's pushed gauge in /metrics")
    assert "ray_tpu_sched_dispatch_latency_s_bucket" in metrics
    assert "# TYPE dash_worker_pushed_gauge gauge" in metrics
    tl = _get(node, "/api/timeline")
    assert any(e.get("ph") == "M" for e in tl) and any(e.get("cat") == "task" for e in tl)
    names = {m["name"] for m in _until(lambda: _get(node, "/api/metrics/list"), "a series")}
    assert "ray_tpu_proc_rss_mb" in names
    q = _get(node, "/api/metrics/query?name=ray_tpu_proc_rss_mb&window=600")
    assert q["series"]
    host, port = node.dashboard.address
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{host}:{port}/api/metrics/query", timeout=T)
    assert e.value.code == 400
    assert "by_owner" in _get(node, "/api/memory?limit=5")
    assert "workers" in _get(node, "/api/top")
    assert isinstance(_get(node, "/api/perf"), dict)
    assert isinstance(_get(node, "/api/logs"), list)
    assert "folded" in _get(node, "/api/profile/continuous?window=60")
    tenants = _get(node, "/api/tenants")
    assert [t for t in tenants if t["job_id"] == global_worker.job_id][0]["alive"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{host}:{port}/api/no_such_table", timeout=T)
    assert e.value.code == 404


def test_on_demand_profiles_of_the_head_and_of_a_worker(head):
    node, _ = head
    out = _get(node, "/api/profile?duration=0.3")
    assert out["target"] == "head" and isinstance(out["report"], list)
    a = _Spinner.remote()
    wid = ray_tpu_torch.get(a.whoami.remote(), timeout=T)
    spin = a.spin.remote(3.0)
    out = _get(node, f"/api/profile?duration=1.0&worker_id={wid}")
    assert out["target"] == wid and out["report"], out
    assert any("spin" in json.dumps(row) for row in out["report"]), out["report"][:5]
    folded = _get(node, f"/api/profile?duration=0.3&worker_id={wid}&format=collapsed",
                  raw=True)
    assert folded.strip()
    assert "error" in _get(node, "/api/profile?duration=0.1&worker_id=00ff")
    assert ray_tpu_torch.get(spin, timeout=T)
    from ray_tpu_torch.scripts import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["profile", "--duration", "0.3", "--worker-id", wid])
    assert json.loads(buf.getvalue())["target"] == wid
    ray_tpu_torch.kill(a)


def _put_config(node, config):
    host, port = node.dashboard.address
    req = urllib.request.Request(f"http://{host}:{port}/api/serve/applications",
                                 data=json.dumps(config).encode(),
                                 headers={"Content-Type": "application/json"}, method="PUT")
    try:
        with urllib.request.urlopen(req, timeout=T) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_rest_config_deploy_update_delete(head):
    """``tests/test_serve_config_deploy.py``'s scenario: a bad config is a
    400 naming its path; a config deploys the app module, serves its
    route with the user config, reads back, scales to 2 and is deleted by
    an empty config.  The update goes through ``serve-deploy``."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.scripts import cli

    node, tmp = head
    code, out = _put_config(node, {"applications": [{"name": "x"}]})
    assert code == 400 and "import_path" in out["error"]
    config = {"applications": [{
        "name": "cfgapp", "import_path": "serve_cfg_torchmod:app", "route_prefix": "/cfg",
        "deployments": [{"name": "ConfigApp", "num_replicas": 1,
                         "user_config": {"threshold": 0.25}}]}]}
    code, out = _put_config(node, config)
    assert code == 200 and out["deployed"] == ["ConfigApp"], out
    host, hport = serve.get_http_address()

    def served():
        try:
            with urllib.request.urlopen(f"http://{host}:{hport}/cfg", timeout=T) as r:
                return json.loads(r.read())
        except (OSError, ValueError):
            return None
    assert _until(served, "the config app's route") == {"greeting": "hello", "threshold": 0.25}
    assert _get(node, "/api/serve/config")["applications"][0]["name"] == "cfgapp"
    apps = _get(node, "/api/serve/applications")
    assert apps["ConfigApp"]["num_replicas_goal"] == 1 and "autoscaling_metrics" in apps["ConfigApp"]

    config["applications"][0]["deployments"][0]["num_replicas"] = 2
    path = os.path.join(tmp, "serve_config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["serve-deploy", path])
    assert json.loads(buf.getvalue())["deployed"] == ["ConfigApp"]
    _until(lambda: serve.status()["ConfigApp"]["num_replicas_goal"] == 2, "2 replicas")
    code, out = _put_config(node, {"applications": []})
    assert code == 200, out
    _until(lambda: "ConfigApp" not in serve.status(), "the app's deletion")
    with open(path, "w") as f:
        json.dump({"applications": [{"name": "x"}]}, f)
    with pytest.raises(SystemExit, match="import_path"):
        cli.main(["serve-deploy", path])
