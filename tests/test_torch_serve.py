"""Serve on the port's runtime: controller reconciliation, routing, the
HTTP proxy, ``@serve.batch`` and fault tolerance, mirrored by name from the
JAX package's ``tests/test_serve.py`` and ``tests/test_serve_streaming.py``
(its dashboard REST and ``serve status`` CLI tests are left out with those
surfaces), plus replicas on fractional GPU grants, BERT labels over HTTP
against the JAX package's ``bert.apply``, and ``schema``/``http_util``
results against the JAX package's on the same inputs.

One port head serves the module (``init(num_cpus=16, num_gpus=2)``: fake
cards, the grants are environment variables only); no JAX head starts.
"""

import http.client
import json
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_instance():
    ray_tpu_torch.init(num_cpus=16, num_gpus=2)
    client = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    yield client
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _http(path, payload=None, port=None, method=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_deploy_and_handle_call(serve_instance):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def double(self, x):
            return 2 * x

    handle = serve.run(Echo.bind(), port=0)
    assert ray_tpu_torch.get(handle.remote("hi"), timeout=60) == {"echo": "hi"}
    assert ray_tpu_torch.get(handle.double.remote(21), timeout=60) == 42
    # handle.options(method_name=...) retargets .remote() (equivalent to
    # attribute access, but composable); options survive pickling
    doubler = handle.options(method_name="double")
    assert ray_tpu_torch.get(doubler.remote(5), timeout=60) == 10
    assert ray_tpu_torch.get(handle.remote("x"), timeout=60) == {"echo": "x"}
    import cloudpickle

    revived = cloudpickle.loads(cloudpickle.dumps(doubler))
    assert ray_tpu_torch.get(revived.remote(7), timeout=60) == 14
    # unknown options raise instead of being silently dropped
    with pytest.raises(ValueError, match="unknown DeploymentHandle options"):
        handle.options(stream=True)


def test_function_deployment(serve_instance):
    @serve.deployment
    def square(x):
        return x * x

    handle = serve.run(square.bind(), port=0)
    assert ray_tpu_torch.get(handle.remote(7), timeout=60) == 49


def test_composition_child_handle(serve_instance):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, child):
            self.child = child

        def __call__(self, x):
            y = ray_tpu_torch.get(self.child.remote(x), timeout=60)
            return y * 10

    handle = serve.run(Model.bind(Preprocess.bind()), port=0)
    assert ray_tpu_torch.get(handle.remote(4), timeout=120) == 50


def test_scale_up_down(serve_instance):
    @serve.deployment(num_replicas=1)
    class Who:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, request=None):
            return self.pid

    serve.run(Who.bind(), port=0)
    handle = serve.get_deployment_handle("Who")
    pids = {ray_tpu_torch.get(handle.remote(), timeout=60) for _ in range(6)}
    assert len(pids) == 1

    serve.run(Who.options(num_replicas=3).bind(), port=0)
    deadline = time.monotonic() + 90
    pids = set()
    while time.monotonic() < deadline and len(pids) < 3:
        pids.add(ray_tpu_torch.get(handle.remote(), timeout=60))
    assert len(pids) == 3

    serve.run(Who.options(num_replicas=1).bind(), port=0)
    info = serve.status()["Who"]
    assert info["num_replicas_goal"] == 1


def test_replica_death_replacement(serve_instance):
    @serve.deployment(num_replicas=2)
    class Fragile:
        def __call__(self, request=None):
            return "ok"

        def die(self):
            import os

            os._exit(1)

    serve.run(Fragile.bind(), port=0)
    handle = serve.get_deployment_handle("Fragile")
    assert ray_tpu_torch.get(handle.remote(), timeout=60) == "ok"

    # kill one replica out from under the controller
    info = ray_tpu_torch.get(
        serve_instance.controller.get_routing_info.remote("Fragile"), timeout=30
    )
    assert len(info["replicas"]) == 2
    _, victim = info["replicas"][0]
    victim.die.remote()

    # the health loop replaces it; requests keep succeeding throughout
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        assert ray_tpu_torch.get(handle.remote(), timeout=60) == "ok"
        st = serve.status()["Fragile"]
        if st["status"] == "HEALTHY" and st["replica_states"].get("RUNNING") == 2:
            break
        time.sleep(0.5)
    st = serve.status()["Fragile"]
    assert st["replica_states"].get("RUNNING") == 2


def test_user_config_reconfigure(serve_instance):
    @serve.deployment(user_config={"threshold": 1})
    class Configurable:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, request=None):
            return self.threshold

    serve.run(Configurable.bind(), port=0)
    handle = serve.get_deployment_handle("Configurable")
    assert ray_tpu_torch.get(handle.remote(), timeout=60) == 1

    serve.run(Configurable.options(user_config={"threshold": 9}).bind(), port=0)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if ray_tpu_torch.get(handle.remote(), timeout=60) == 9:
            break
        time.sleep(0.2)
    assert ray_tpu_torch.get(handle.remote(), timeout=60) == 9


def test_http_proxy_end_to_end(serve_instance):
    @serve.deployment
    class Classifier:
        def __call__(self, request):
            data = request.json()
            return {"label": "long" if len(data["text"]) > 5 else "short",
                    "method": request.method}

    serve.run(Classifier.bind(), port=0)
    host, port = serve.get_http_address()

    status_code, body = _http("/Classifier", {"text": "hello world"}, port=port)
    assert status_code == 200
    assert json.loads(body) == {"label": "long", "method": "POST"}

    status_code, body = _http("/-/routes", port=port)
    assert status_code == 200
    assert "/Classifier" in json.loads(body)


def test_crash_looping_deployment_marked_unhealthy(serve_instance):
    """A deployment whose __init__ raises must not churn workers forever:
    after a few consecutive start failures the controller gives up and
    serve.run surfaces the failure."""

    @serve.deployment
    class Broken:
        def __init__(self):
            raise RuntimeError("boom at init")

        def __call__(self):
            return "unreachable"

    with pytest.raises((RuntimeError, TimeoutError)) as exc:
        serve.run(Broken.bind(), port=0, timeout_s=60)
    assert "unhealthy" in str(exc.value).lower() or "Broken" in str(exc.value)
    assert serve.status()["Broken"]["status"] == "UNHEALTHY"
    serve.delete("Broken")


def test_a_replica_that_fails_to_start_gives_back_its_cards(serve_instance):
    """A replica whose constructor raises is ended, so the cards it was
    granted return and each replacement can start (and fail) in turn:
    the deployment is marked unhealthy instead of waiting for cards."""

    @serve.deployment(ray_actor_options={"num_gpus": 2})
    class NoStart:
        def __init__(self):
            raise RuntimeError("boom at init")

        def __call__(self, request=None):
            return "unreachable"

    with pytest.raises(RuntimeError, match="unhealthy"):
        serve.run(NoStart.bind(), port=0, timeout_s=60)
    assert serve.status()["NoStart"]["status"] == "UNHEALTHY"
    serve.delete("NoStart")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and ray_tpu_torch.available_resources().get("GPU") != 2.0:
        time.sleep(0.2)
    assert ray_tpu_torch.available_resources()["GPU"] == 2.0


def test_http_404_and_delete(serve_instance):
    @serve.deployment
    def ping(request):
        return "pong"

    serve.run(ping.bind(), port=0)
    host, port = serve.get_http_address()
    code, body = _http("/ping", port=port)
    assert code == 200 and body == b"pong"

    with pytest.raises(urllib.error.HTTPError) as exc:
        _http("/nonexistent", port=port)
    assert exc.value.code == 404

    serve.delete("ping")
    assert "ping" not in serve.status()


def test_autoscaling_up_and_down(serve_instance):
    """Router-reported load drives replica count between min and max
    (autoscaling_policy analog)."""

    @serve.deployment(
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 3,
            "target_num_ongoing_requests_per_replica": 1.0,
            "upscale_delay_s": 0.5,
            "downscale_delay_s": 1.5,
            "look_back_period_s": 4.0,
        },
        max_concurrent_queries=2,
    )
    class Slow:
        def __call__(self, request=None):
            time.sleep(0.4)
            return "done"

    serve.run(Slow.bind(), port=0)
    assert serve.status()["Slow"]["num_replicas_goal"] == 1
    handle = serve.get_deployment_handle("Slow")

    # sustained burst: keep ~6 requests in flight until the controller
    # scales past 1 replica
    deadline = time.monotonic() + 60
    goal = 1
    inflight = [handle.remote() for _ in range(6)]
    while time.monotonic() < deadline:
        done, pending = ray_tpu_torch.wait(inflight, num_returns=1, timeout=5)
        for r in done:
            ray_tpu_torch.get(r, timeout=60)
        inflight = list(pending) + [handle.remote() for _ in range(len(done))]
        goal = serve.status()["Slow"]["num_replicas_goal"]
        if goal >= 2:
            break
    for r in inflight:
        ray_tpu_torch.get(r, timeout=120)
    assert goal >= 2, f"never scaled up (goal={goal})"

    # idle: scales back down to min_replicas
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["num_replicas_goal"] == 1:
            break
        time.sleep(0.5)
    assert serve.status()["Slow"]["num_replicas_goal"] == 1
    serve.delete("Slow")


def test_long_poll_membership_propagation(serve_instance):
    """A scale-up reaches existing handles without waiting out the TTL
    (LongPollHost/Client analog)."""

    @serve.deployment(num_replicas=1)
    class Pid:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, request=None):
            return self.pid

    serve.run(Pid.bind(), port=0)
    handle = serve.get_deployment_handle("Pid")
    assert isinstance(ray_tpu_torch.get(handle.remote(), timeout=60), int)

    serve.run(Pid.options(num_replicas=2).bind(), port=0)
    deadline = time.monotonic() + 90
    pids = set()
    while time.monotonic() < deadline and len(pids) < 2:
        pids.add(ray_tpu_torch.get(handle.remote(), timeout=60))
    assert len(pids) == 2
    serve.delete("Pid")


def test_serve_batch_decorator(serve_instance):
    """@serve.batch: concurrent handle calls coalesce into one model
    invocation (serve/batching.py analog — the TPU-shaped inference path)."""

    @serve.deployment(max_concurrent_queries=32)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def __call__(self, requests):
            self.batch_sizes.append(len(requests))
            return [r * 2 for r in requests]

        def seen(self):
            return self.batch_sizes

    serve.run(Batched.bind(), port=0)
    handle = serve.get_deployment_handle("Batched")
    refs = [handle.remote(i) for i in range(24)]
    out = ray_tpu_torch.get(refs, timeout=120)
    assert out == [i * 2 for i in range(24)]
    sizes = ray_tpu_torch.get(handle.seen.remote(), timeout=60)
    assert sum(sizes) == 24
    assert max(sizes) > 1, f"no batching happened: {sizes}"
    serve.delete("Batched")


def test_serve_batch_function_deployment(serve_instance):
    """@serve.batch on a function deployment (not just methods)."""

    @serve.deployment(max_concurrent_queries=16)
    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    def triple(requests):
        return [r * 3 for r in requests]

    serve.run(triple.bind(), port=0)
    handle = serve.get_deployment_handle("triple")
    out = ray_tpu_torch.get([handle.remote(i) for i in range(12)], timeout=120)
    assert out == [i * 3 for i in range(12)]
    serve.delete("triple")


def test_serve_batch_sustained_load(serve_instance):
    """Sustained arrivals never starve early callers (batcher-thread
    design: no leader recursion)."""

    @serve.deployment(max_concurrent_queries=32)
    class Slowish:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
        def __call__(self, requests):
            time.sleep(0.02)  # service slower than arrivals
            return [r + 1 for r in requests]

    serve.run(Slowish.bind(), port=0)
    handle = serve.get_deployment_handle("Slowish")
    refs = [handle.remote(i) for i in range(60)]
    out = ray_tpu_torch.get(refs, timeout=180)
    assert out == [i + 1 for i in range(60)]
    serve.delete("Slowish")


def test_serve_batch_concurrent_batches(serve_instance):
    """max_concurrent_batches>1: batch N+1 executes while batch N is still
    in its (slow) run_fn — overlap is the round-trip-dominated TPU serving
    lever — and results still route back to the right callers."""

    @serve.deployment(max_concurrent_queries=64)
    class Overlap:
        def __init__(self):
            import threading

            self.lock = threading.Lock()
            self.active = 0
            self.max_active = 0

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01,
                     max_concurrent_batches=4)
        def __call__(self, requests):
            with self.lock:
                self.active += 1
                self.max_active = max(self.max_active, self.active)
            time.sleep(0.1)  # a "readback RTT" long enough to overlap
            with self.lock:
                self.active -= 1
            return [r * 10 for r in requests]

        def peak(self):
            return self.max_active

    serve.run(Overlap.bind(), port=0)
    handle = serve.get_deployment_handle("Overlap")
    refs = [handle.remote(i) for i in range(32)]
    out = ray_tpu_torch.get(refs, timeout=180)
    assert out == [i * 10 for i in range(32)]
    assert ray_tpu_torch.get(handle.peak.remote(), timeout=60) > 1, \
        "batches never overlapped despite max_concurrent_batches=4"
    serve.delete("Overlap")


def test_serve_batch_concurrent_batches_error_propagation(serve_instance):
    """Exceptions raised on pool-executed batches reach every caller of
    that batch (and only that batch)."""

    @serve.deployment(max_concurrent_queries=32)
    class Flaky:
        @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.01,
                     max_concurrent_batches=2)
        def __call__(self, requests):
            if any(r < 0 for r in requests):
                raise ValueError("negative")
            return [r + 1 for r in requests]

    serve.run(Flaky.bind(), port=0)
    handle = serve.get_deployment_handle("Flaky")
    ok = ray_tpu_torch.get([handle.remote(i) for i in range(4)], timeout=120)
    assert ok == [1, 2, 3, 4]
    with pytest.raises(Exception, match="negative"):
        ray_tpu_torch.get([handle.remote(-1), handle.remote(-2)], timeout=120)
    serve.delete("Flaky")


# ---------------------------------------------------------------------------
# the HTTP data plane (tests/test_serve_streaming.py)
# ---------------------------------------------------------------------------


def test_keep_alive_connection_reuse(serve_instance):
    @serve.deployment
    def echo(request):
        return {"n": request.json()["n"]}

    serve.run(echo.bind(), port=0)
    host, port = serve.get_http_address()
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        for i in range(3):  # same socket, three request/response cycles
            body = json.dumps({"n": i})
            conn.request("POST", "/echo", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read())["n"] == i
    finally:
        conn.close()
    serve.delete("echo")


def test_streaming_response_chunks_arrive_incrementally(serve_instance):
    @serve.deployment
    class Streamer:
        def __call__(self, request):
            def chunks():
                for i in range(4):
                    yield f"chunk-{i}\n"
                    time.sleep(0.8)

            return serve.StreamingResponse(chunks())

    serve.run(Streamer.bind(), port=0)
    host, port = serve.get_http_address()
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        t0 = time.time()
        conn.request("GET", "/Streamer")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.headers.get("Transfer-Encoding") == "chunked"
        first_at = None
        data = b""
        while True:
            piece = resp.read(16)
            if not piece:
                break
            if first_at is None:
                first_at = time.time() - t0
            data += piece
        total = time.time() - t0
        assert data.decode().splitlines() == [f"chunk-{i}" for i in range(4)]
        # the producer sleeps 0.8 s a chunk (~3.2 s in all); the first chunk
        # must arrive long before the stream ends
        assert first_at is not None and first_at < total - 1.5, (first_at, total)
    finally:
        conn.close()
    serve.delete("Streamer")


# ---------------------------------------------------------------------------
# GPU replicas
# ---------------------------------------------------------------------------


def test_replicas_share_a_card_on_half_grants(serve_instance):
    """Two replicas at ``num_gpus=0.5`` share card 0: each sees it as its
    ``CUDA_VISIBLE_DEVICES`` and ``get_gpu_ids()``; a whole-card replica
    of another deployment takes card 1."""

    @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
    class Half:
        def __call__(self, request=None):
            import os

            return (os.getpid(), os.environ["CUDA_VISIBLE_DEVICES"],
                    ray_tpu_torch.get_runtime_context().get_gpu_ids())

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    def whole(request=None):
        import os

        return os.environ["CUDA_VISIBLE_DEVICES"]

    handle = serve.run(Half.bind(), port=0)
    seen = {}
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and len(seen) < 2:
        pid, vis, ids = ray_tpu_torch.get(handle.remote(), timeout=60)
        seen[pid] = (vis, ids)
    assert sorted(seen.values()) == [("0", [0]), ("0", [0])]
    assert ray_tpu_torch.get(serve.run(whole.bind(), port=0).remote(), timeout=60) == "1"
    serve.delete("Half")
    serve.delete("whole")


def _jax_bert(seed=0):
    import jax
    import numpy as np

    from ray_tpu.models import bert as jbert

    cfg = jbert.BertConfig.tiny(dtype=jax.numpy.float32)
    params = jbert.init(cfg, jax.random.PRNGKey(seed))
    return jbert, cfg, params, jax.tree.map(np.asarray, params)


def test_bert_labels_over_http_match_jax_bert_apply(serve_instance):
    """BASELINE config 5 at tiny size: the port's BERT in a replica with
    ``@serve.batch`` (padded to one batch shape, concurrent batches)
    behind the proxy, fed the JAX package's weights as numpy; each
    sequence's logits equal JAX ``bert.apply``'s within 1e-5 (f32, another
    summation order) and its label equals JAX's argmax."""
    import threading

    import numpy as np

    jbert, jcfg, jparams, np_params = _jax_bert()
    batch, seq = 4, 16

    @serve.deployment(max_concurrent_queries=16)
    class TinyBert:
        def __init__(self, np_params):
            from ray_tpu_torch.convert import from_jax_params
            from ray_tpu_torch.models import bert

            self.bert = bert
            self.cfg = bert.BertConfig.tiny(dtype=torch.float32)
            self.params = from_jax_params(np_params, self.cfg, device="cpu")

        @serve.batch(max_batch_size=batch, batch_wait_timeout_s=0.02,
                     max_concurrent_batches=2)
        def __call__(self, requests):
            toks = np.stack([r.json()["tokens"] for r in requests])
            n = len(toks)
            if n < batch:  # one batch shape for every arrival pattern
                toks = np.concatenate([toks, np.zeros((batch - n, seq), toks.dtype)])
            self.bert.check_tokens(toks, self.cfg)
            with torch.inference_mode():  # grad mode is per thread
                logits = self.bert.apply(self.params, torch.from_numpy(toks), self.cfg)[:n]
            return [{"label": int(l.argmax()), "logits": l.tolist()} for l in logits]

    serve.run(TinyBert.bind(np_params), port=0, timeout_s=120)
    _, port = serve.get_http_address()
    rng = np.random.default_rng(5)
    toks = rng.integers(1, jcfg.vocab_size, (10, seq))
    out = [None] * len(toks)

    def client(i):
        out[i] = json.loads(_http("/TinyBert", {"tokens": toks[i].tolist()}, port=port)[1])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(toks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = np.asarray(jbert.apply(jparams, toks, jcfg))
    got = np.array([o["logits"] for o in out])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert [o["label"] for o in out] == want.argmax(-1).tolist()
    serve.delete("TinyBert")


# ---------------------------------------------------------------------------
# schema and http_util against the JAX package's
# ---------------------------------------------------------------------------

DEPLOY_CONFIGS = [
    {},
    {"applications": "nope"},
    {"applications": [{"name": "a"}]},
    {"applications": [{"import_path": "m:x", "route_prefix": "noslash"}]},
    {"applications": [{"import_path": "m:x", "deployments": [{"name": "d", "num_replicas": -1}]}]},
    {"applications": [{"import_path": "m:x", "bogus": 1}]},
    {"applications": [{"import_path": "m:x", "name": "a"}, {"import_path": "m:y", "name": "a"}]},
    {"applications": [{"import_path": "m:x", "deployments": [{"name": "d",
                                                               "max_concurrent_queries": 0}]}]},
    {"applications": [{"import_path": "m:x", "name": "app", "route_prefix": "/api",
                       "deployments": [{"name": "d", "num_replicas": 2,
                                        "max_concurrent_queries": 8,
                                        "user_config": {"t": 0.5},
                                        "ray_actor_options": {"num_gpus": 0.5},
                                        "autoscaling_config": {"min_replicas": 1}}]}]},
    {"applications": []},
]


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the outcome is what is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("config", DEPLOY_CONFIGS, ids=range(len(DEPLOY_CONFIGS)))
def test_parse_deploy_config_matches_jax(config):
    from ray_tpu.serve import schema as jschema
    from ray_tpu_torch.serve import schema as tschema

    want = _outcome(lambda c: jschema.parse_deploy_config(c).to_dict(), config)
    assert _outcome(lambda c: tschema.parse_deploy_config(c).to_dict(), config) == want


HTTP_HEADS = [
    b"GET /a?b=1 HTTP/1.1\r\nHost: x\r\nX-Serve-Deadline-S: 2",
    b"POST /llm HTTP/1.1\r\nContent-Type: application/json\r\n\r\nContent-Length: 7",
    b"NONSENSE",
    b"GET / HTTP/1.1\r\nno-colon-here",
    b"\xff\xfe / HTTP/1.1",
]
RESULTS = [b"\x00raw", "text", {"a": [1, 2]}, [1, "x"], None, 3.5]


@pytest.mark.parametrize("head", HTTP_HEADS, ids=range(len(HTTP_HEADS)))
def test_parse_http_head_matches_jax(head):
    from ray_tpu.serve._private import http_util as jhttp
    from ray_tpu_torch.serve._private import http_util as thttp

    assert _outcome(thttp.parse_http_head, head) == _outcome(jhttp.parse_http_head, head)


def test_encode_response_and_chunk_match_jax():
    from ray_tpu.serve._private import http_util as jhttp
    from ray_tpu_torch.serve._private import http_util as thttp

    for r in RESULTS:
        assert thttp.encode_response(r) == jhttp.encode_response(r)
        assert thttp.encode_chunk(r) == jhttp.encode_chunk(r)


def test_controller_rejects_a_bad_deploy_config(serve_instance):
    from ray_tpu_torch.serve.schema import SchemaError

    with pytest.raises(Exception, match="import_path") as exc:
        ray_tpu_torch.get(serve_instance.controller.apply_deploy_config.remote(
            {"applications": [{"name": "x"}]}), timeout=60)
    assert "SchemaError" in repr(exc.value) or isinstance(exc.value, SchemaError)


def _cuda_state(instance):
    import os
    import sys

    import torch

    return (os.environ.get("CUDA_VISIBLE_DEVICES"), "torch" in sys.modules,
            torch.cuda.is_initialized())


def test_controller_and_proxy_hold_no_card(serve_instance):
    """The controller and the proxy hold no GPU: each sees no card
    (``CUDA_VISIBLE_DEVICES`` empty) and never made a CUDA context."""
    for actor in (serve_instance.controller, serve_instance.proxy):
        vis, has_torch, cuda_up = ray_tpu_torch.get(
            actor._submit_compiled_task(_cuda_state, (), name="cuda_state"), timeout=60)
        assert (vis, cuda_up) == ("", False), (actor, vis, has_torch, cuda_up)
