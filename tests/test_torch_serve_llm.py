"""``llm_deployment`` on the port's runtime, held to the JAX package.

Mirrors by name ``tests/test_llm_serve.py::test_llm_deployment_behind_serve``
and ``tests/test_serve_streaming.py::test_llm_token_streaming_over_http``;
holds the replica's greedy streams to the JAX package's in-process
``GenerationEngine`` on the same weights (tiny GPT-2, f32, token for
token); checks the replica's card grant, that a replica with no card and
no ``device`` fails rather than run on the CPU, and the engine's exports
to the metrics registry, the events and a trace.

One port head serves the module (``init(num_cpus=16, num_gpus=2)``: fake
cards, so every engine here runs with ``device="cpu"``); no JAX head
starts.
"""

import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.llm import llm_deployment

TINY = dict(n_slots=2, max_new_tokens=6, decode_chunk_steps=3, prefill_buckets=(8,))


@pytest.fixture(scope="module")
def serve_instance():
    ray_tpu_torch.init(num_cpus=16, num_gpus=2)
    client = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    yield client
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _replica_handles(client, name):
    info = ray_tpu_torch.get(client.controller.get_routing_info.remote(name), timeout=30)
    return [h for _, h in info["replicas"]]


def _grant(instance):
    import os

    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            ray_tpu_torch.get_runtime_context().get_gpu_ids())


def test_llm_deployment_behind_serve(serve_instance):
    dep = llm_deployment(
        "gpt2", "tiny", num_gpus=0,
        engine_kwargs=dict(TINY, device="cpu"),
        config_kwargs=dict(dtype=torch.float32),
    )
    handle = serve.run(dep.bind(), port=0)
    refs = [handle.remote({"tokens": [3, 5, 7], "max_new_tokens": 6})
            for _ in range(4)]
    outs = ray_tpu_torch.get(refs, timeout=300)
    assert all(o == outs[0] for o in outs)  # greedy: identical prompts agree
    assert len(outs[0]["tokens"]) == 6
    stats = ray_tpu_torch.get(handle.stats.remote(), timeout=60)
    assert stats["total_requests"] == 4
    serve.delete("llm")


def test_llm_token_streaming_over_http(serve_instance):
    dep = llm_deployment(
        "gpt2", "tiny", num_gpus=0,
        engine_kwargs=dict(TINY, device="cpu"),
        config_kwargs=dict(dtype=torch.float32),
    )
    serve.run(dep.bind(), port=0, timeout_s=300)
    host, port = serve.get_http_address()

    def post(payload):
        conn = http.client.HTTPConnection(host, port, timeout=300)
        try:
            conn.request("POST", "/llm", body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            return resp.read()
        finally:
            conn.close()

    plain = json.loads(post({"tokens": [3, 5, 7], "max_new_tokens": 6}))
    streamed = post({"tokens": [3, 5, 7], "max_new_tokens": 6, "stream": True})
    toks = [int(x) for x in streamed.decode().split()]
    assert toks == plain["tokens"]  # greedy: identical either way
    serve.delete("llm")


def test_llm_deployment_matches_the_jax_engine(serve_instance):
    """Tiny GPT-2 in f32 with the JAX package's weights (numpy, through
    ``convert.from_jax_params`` into ``engine_kwargs["params"]``): eight
    concurrent requests through the replica (two slots, so admissions
    interleave with decode) give the greedy streams of the JAX package's
    in-process ``GenerationEngine`` on the same weights, token for token."""
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.serve.llm import GenerationEngine as JaxEngine
    from ray_tpu_torch.convert import from_jax_params
    from ray_tpu_torch.models import gpt2 as tgpt2

    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    jp = jgpt2.init(jcfg, jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tgpt2.GPT2Config.tiny(dtype=torch.float32),
                         device="cpu")
    engine = dict(n_slots=2, max_new_tokens=8, decode_chunk_steps=3, prefill_buckets=(8, 16))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (3, 12, 1, 7, 16, 5, 9, 2)]
    dep = llm_deployment("gpt2", "tiny", num_gpus=0,
                         engine_kwargs=dict(engine, params=tp, device="cpu"),
                         config_kwargs=dict(dtype=torch.float32))
    handle = serve.run(dep.bind(), port=0, timeout_s=300)
    got = ray_tpu_torch.get([handle.remote({"tokens": p, "max_new_tokens": 8})
                             for p in prompts], timeout=300)
    serve.delete("llm")
    ref = JaxEngine(jcfg, jp, **engine).start()
    try:
        want = [f.result(timeout=300) for f in [ref.submit(p, 8) for p in prompts]]
    finally:
        ref.stop()
    assert [g["tokens"] for g in got] == want


def test_llm_replica_holds_a_card_by_default(serve_instance):
    dep = llm_deployment("gpt2", "tiny", name="llm_card",
                         engine_kwargs=dict(TINY, device="cpu"))
    handle = serve.run(dep.bind(), port=0, timeout_s=300)
    assert len(ray_tpu_torch.get(handle.remote([1, 2]), timeout=300)["tokens"]) == 6
    (replica,) = _replica_handles(serve_instance, "llm_card")
    vis, ids = ray_tpu_torch.get(replica._submit_compiled_task(_grant, (), name="grant"),
                                 timeout=60)
    assert len(ids) == 1 and vis == str(ids[0])
    assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    serve.delete("llm_card")


def test_llm_replica_without_a_card_or_device_fails(serve_instance):
    """``num_gpus=0`` and no ``device``: the engine in the replica raises
    as every entry point does without a card (no CPU fallback), so the
    deployment is marked unhealthy."""
    dep = llm_deployment("gpt2", "tiny", name="llm_nocard", num_gpus=0,
                         engine_kwargs=dict(TINY))
    with pytest.raises((RuntimeError, TimeoutError)) as exc:
        serve.run(dep.bind(), port=0, timeout_s=60)
    assert "unhealthy" in str(exc.value).lower() or "llm_nocard" in str(exc.value)
    assert serve.status()["llm_nocard"]["status"] == "UNHEALTHY"
    serve.delete("llm_nocard")


def test_engine_exports_metrics_events_and_trace():
    """The engine's runtime exports (the JAX engine's): the ``ray_tpu_llm_*``
    metrics in the process registry, ``serve_llm`` admission and
    completion events, and a completion span in the submitter's trace."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config
    from ray_tpu_torch.util import metrics, tracing

    cfg = make_config("gpt2", "tiny", dtype=torch.float32)
    eng = GenerationEngine(cfg, device="cpu", **dict(TINY, n_slots=1)).start()
    try:
        before = events.buffer().last_seq()
        with tracing.trace("client") as ctx:
            fut = eng.submit([4, 2, 9], 6)
        assert len(fut.result(timeout=120)) == 6
        eng.generate([7], 4, timeout=120)
    finally:
        eng.stop()
    snap = metrics.registry().snapshot()
    for name in ("ray_tpu_llm_requests_total", "ray_tpu_llm_generated_tokens_total",
                 "ray_tpu_llm_ttft_s", "ray_tpu_llm_slot_admission_latency_s",
                 "ray_tpu_llm_decode_tick_s"):
        assert snap[name]["values"], name
    assert sum(snap["ray_tpu_llm_requests_total"]["values"].values()) >= 2
    rows = [r for r in events.buffer().since(before) if r["source"] == "serve_llm"]
    done = [r for r in rows if r["message"] == "request complete"]
    assert len(done) == 2 and {r["data"]["tokens"] for r in done} == {6, 4}
    assert any(r["message"].startswith("admitted") for r in rows)
    traced = [r for r in done if r["data"].get("trace_id") == ctx["trace_id"]]
    assert len(traced) == 1 and traced[0]["data"]["phase"] == "llm_generate"


def test_shutdown_ends_every_replica_and_frees_the_cards(serve_instance):
    """serve.shutdown() ends the replicas before it kills the controller
    (replicas are detached: one left draining would live on and keep its
    cards).  Runs last: it shuts down the module's Serve instance."""
    dep = llm_deployment("gpt2", "tiny", name="llm_last", num_gpus=2,
                         engine_kwargs=dict(TINY, device="cpu"))
    handle = serve.run(dep.bind(), port=0, timeout_s=300)
    assert len(ray_tpu_torch.get(handle.remote([3]), timeout=300)["tokens"]) == 6
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0
    serve.shutdown()
    assert ray_tpu_torch.available_resources()["GPU"] == 2.0
