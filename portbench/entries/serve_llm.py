"""Serving cells: a Serve deployment over the port's ``GenerationEngine``,
called through a ``DeploymentHandle`` by a closed loop of clients.

The deployment is the benchmark's own few-line class, as the port's
``llm_deployment`` builds one: one replica holding the card, the engine
built in its constructor over weights the benchmark makes there from the
seed, and every shape the traffic uses warmed up before the replica
reports healthy.  The driver holds no CUDA context until the runtime has
shut down; it then runs the reference on the card.

Record for the readers (``ctx``): the window's replies (when each came,
its prompt's and its output's lengths), the engine's counters and the
tokens delivered so far at the window's two ends, the device trace of a
stretch inside the replica (``--trace 1``), and the model's sizes.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import numpy as np

from portbench import traffic, weights

REPLY_TIMEOUT_S = 120.0
# the profiler takes about two seconds to start in a busy replica: a
# traced stretch is asked for this long before it should begin
TRACE_LEAD_S = 3.0


class BenchLLM:
    """The replica: ``__call__({"tokens", "max_new"}) -> generated ids``."""

    def __init__(self, config: Dict[str, Any], cell: Dict[str, Any], seed: int,
                 device: str, fault: str = ""):
        import torch

        from ray_tpu_torch.models.gpt2 import GPT2Config
        from ray_tpu_torch.serve.llm import GenerationEngine

        self.device = torch.device(device)
        d = weights.dims(config)
        cfg = GPT2Config(**d, dtype=getattr(torch, config["assumed"]["dtype"]), remat=False)
        params = weights.gpt2(config, seed, self.device, dtype=cfg.dtype)
        ekw = dict(cell["engine"])
        ekw["prefill_buckets"] = tuple(ekw["prefill_buckets"])
        self.engine = GenerationEngine(cfg, params, device=self.device, seed=seed, **ekw)
        self._lock = threading.Lock()
        self._live = set()  # the requests of __call__ not yet returned
        self._done_tokens, self._done_t = 0, 0.0
        if fault:
            _plant(fault)
        self.engine.start()
        self._warm(cell["engine"], d["vocab_size"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def _warm(self, ekw: Dict[str, Any], vocab: int) -> None:
        """One prefill at each bucket, one at a time (an admission takes
        the bucket of its longest prompt, ``n_slots`` rows wide whatever it
        holds), and a decode chunk behind each."""
        steps = int(ekw["decode_chunk_steps"])
        for i, b in enumerate(ekw["prefill_buckets"]):
            self.engine.generate([(7 * i + j) % vocab for j in range(b)], steps + 1, timeout=1200)

    def __call__(self, request):
        """``{"tokens", "max_new"}`` from a handle: the generated ids,
        whole, as the engine's ``generate`` returns them.  The request is
        held while it runs, so that ``delivered`` can count the tokens the
        engine has handed it so far (the engine's ``stream`` does the same
        by polling every 20 ms, which in 288 threads slows the engine)."""
        req = self.engine._submit_req(request["tokens"], request["max_new"])
        with self._lock:
            self._live.add(req)
        try:
            return req.future.result(REPLY_TIMEOUT_S * 5)
        finally:
            with self._lock:
                self._live.discard(req)
                self._done_tokens += len(req.emitted)
                self._done_t = max(self._done_t, req.last_emit_t or 0.0)

    def _delivered_once(self):
        with self._lock:
            live = list(self._live)
            n, t = self._done_tokens, self._done_t
        for r in live:
            n += len(r.emitted)
            t = max(t, r.last_emit_t or 0.0)
        return n, t

    def delivered(self):
        """Tokens the engine has handed to the requests of ``__call__``
        so far, and when it last handed any (the replica's clock).  A drain
        hands a chunk's tokens to every slot in turn: the reading is taken
        between drains, where two readings 10 ms apart agree."""
        prev = self._delivered_once()
        for _ in range(100):
            time.sleep(0.01)
            now = self._delivered_once()
            if now == prev:
                break
            prev = now
        return prev

    def counters(self) -> Dict[str, Any]:
        """The engine's own counters, and the tokens delivered so far."""
        p = self.engine.perf_stats()
        n, t = self.delivered()
        return {"stats": self.engine.stats(), "ticks": p["ticks"], "tick_s": p["tick_s"],
                "delivered": n, "delivered_t": t}

    def trace_start(self, seconds: float) -> None:
        """Trace ``seconds`` of what the replica does, from when the
        profiler runs."""
        from portbench.trace import BackgroundTrace

        self._trace = BackgroundTrace(seconds)
        self._trace.start()

    def trace_summary(self) -> Dict[str, Any]:
        return self._trace.summary()

    def held_modules(self):
        """What of JAX or the JAX package this process (the one that holds
        the card) has loaded."""
        from portbench.harness import forbidden_modules

        return forbidden_modules()

    def device_info(self) -> Dict[str, Any]:
        import torch

        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _plant(fault: str) -> None:
    """A fault under the timed path, for the harness's own tests: the
    sampled token altered where it is produced, or a module named ``jax``
    loaded in the replica."""
    from ray_tpu_torch.models import generate as gen

    if fault == "loads_jax":
        import sys
        import types

        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return
    if fault != "token_altered":
        raise ValueError(f"no such fault for a serving cell: {fault!r}")
    sample = gen.sample_logits

    def altered(logits, *a, **kw):
        return (sample(logits, *a, **kw) + 1) % logits.shape[-1]

    gen.sample_logits = altered


def deploy(spec: Dict[str, Any], seed: int, concurrency: int):
    """The deployment, one replica, running and warm; its handle."""
    from ray_tpu_torch import serve

    on_card = spec.get("device", "cuda") == "cuda"
    dep = serve.deployment(
        BenchLLM, name="bench_llm", max_concurrent_queries=concurrency,
        ray_actor_options={"num_gpus": 1 if on_card else 0, "max_concurrency": concurrency + 8})
    return serve.run(dep.bind(spec["config"], spec["cell"], seed, spec.get("device", "cuda"),
                              spec.get("fault", "")), port=0, timeout_s=1200)


def finish(rec: Dict[str, Any], spec: Dict[str, Any], replies, seed: int, trace: bool,
           t_start: float) -> Dict[str, Any]:
    """The record's common tail, once the runtime is down: set-up, sizes,
    the trace's numbers, and the output check."""
    rec["ctx"]["setup_s"] = rec.pop("t_open_epoch") - t_start
    rec["ctx"]["dims"] = weights.dims(spec["config"])
    rec["ctx"]["kind"] = rec["device"]["kind"]
    if trace:
        tr = rec["ctx"]["trace"]
        rec["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        rec["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    rec["checks"], control = _check(spec, replies, seed, spec.get("device", "cuda"))
    if control:
        rec["control"] = control
    return rec


def run(spec: Dict[str, Any], *, seed: int, seconds: float, trace: bool,
        t_start: float) -> Dict[str, Any]:
    import ray_tpu_torch
    from ray_tpu_torch import serve

    cell, mix = spec["cell"], spec["traffic"]
    on_card = spec.get("device", "cuda") == "cuda"
    first, pool = traffic.closed_loop(mix, seed)
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if on_card else 0)
    try:
        handle = deploy(spec, seed, 2 * int(mix["clients"]))
        rec = _drive(handle, first, pool, cell, seconds, trace)
        rec["device"] = ray_tpu_torch.get(handle.device_info.remote(), timeout=60)
        rec["held"] = ray_tpu_torch.get(handle.held_modules.remote(), timeout=60)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    return finish(rec, spec, rec.pop("replies"), seed, trace, t_start)


def _drive(handle, first, pool, cell, seconds: float, trace: bool) -> Dict[str, Any]:
    """The closed loop: every client sends its first request, then its
    next one as each reply comes.  ``settle_s`` unmeasured, then the
    window; a reply belongs to the window if it came inside it.  With
    ``trace``, the counters are also read just before the profiler is
    asked to start: the window up to there is the untraced part."""
    import ray_tpu_torch

    inflight: Dict[Any, Any] = {}
    nxt = [0]

    def send(req):
        inflight[handle.remote(req)] = req

    for req in first:
        send(req)
    t0 = time.perf_counter()
    t_open = t0 + float(cell["settle_s"])
    t_close = t_open + seconds
    opened = False
    replies, failed = [], 0
    counters = {}
    trace_ref = None
    def read_counters():
        """The replica's counters, stamped at the middle of the call."""
        t_a = time.perf_counter()
        c = ray_tpu_torch.get(handle.counters.remote(), timeout=60)
        return c, (t_a + time.perf_counter()) / 2

    while True:
        now = time.perf_counter()
        if not opened and now >= t_open:
            opened = True
            t_open_epoch = time.time()
            counters["open"], t_open = read_counters()
            t_close = t_open + seconds
        if trace and opened and trace_ref is None and now >= t_close - TRACE_LEAD_S - float(cell["trace_s"]):
            # the stretch ends about a second before the window does
            counters["untraced"], t_untraced = read_counters()
            trace_ref = handle.trace_start.remote(float(cell["trace_s"]))
        if opened and now >= t_close:
            break
        ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1, timeout=0.05)
        if not ready:
            continue
        ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=len(inflight), timeout=0)
        t_done = time.perf_counter()
        for ref in ready:
            req = inflight.pop(ref)
            try:
                out = ray_tpu_torch.get(ref, timeout=REPLY_TIMEOUT_S)
                ok = len(out) == req["max_new"]
            except Exception:  # noqa: BLE001 — a failed request counts as failed
                out, ok = None, False
            if opened:
                if ok:
                    replies.append({"t": t_done - t_open, "prompt": req["tokens"], "out": out})
                else:
                    failed += 1
            send(pool[nxt[0] % len(pool)])
            nxt[0] += 1
    counters["close"], t_end = read_counters()
    window_s = t_end - t_open
    landed = [{"t": r["t"], "prompt_len": len(r["prompt"]), "tokens": len(r["out"])}
              for r in replies]
    ctx = {"window_s": window_s, "seconds": seconds, "replies": landed,
           "counters": {"open": counters["open"], "close": counters["close"]},
           "chunk": int(cell["engine"]["decode_chunk_steps"])}
    if trace_ref is not None:
        cut = t_untraced - t_open
        ctx["untraced"] = {"window_s": cut, "replies": [r for r in landed if r["t"] < cut],
                           "counters": {"open": counters["open"],
                                        "close": counters["untraced"]}}
        ray_tpu_torch.get(trace_ref, timeout=600)
        ctx["trace"] = ray_tpu_torch.get(handle.trace_summary.remote(), timeout=600)
    return {"attempted": len(replies) + failed, "failed": failed, "ctx": ctx,
            "replies": replies, "t_open_epoch": t_open_epoch}


def sample_replies(replies: List[Dict[str, Any]], n: int, seed: int) -> List[Dict[str, Any]]:
    """``n`` replies drawn from the seed, the longest among them."""
    if not replies:
        return []
    longest = max(range(len(replies)), key=lambda i: len(replies[i]["prompt"]) + len(replies[i]["out"]))
    rest = [i for i in range(len(replies)) if i != longest]
    pick = traffic.rng(seed, 7).permutation(len(rest))[:max(0, n - 1)]
    return [replies[longest]] + [replies[rest[i]] for i in sorted(pick)]


def served_gaps(ref_logits, prompt_len: int, out: List[int]) -> np.ndarray:
    """How far below the reference's best logit each served token's lies:
    token ``i`` is read at position ``prompt_len - 1 + i``."""
    import torch

    pos = torch.arange(prompt_len - 1, prompt_len - 1 + len(out), device=ref_logits.device)
    rows = ref_logits[pos]
    toks = torch.tensor(out, device=ref_logits.device)
    return (rows.max(dim=-1).values - rows.gather(1, toks[:, None])[:, 0]).cpu().numpy()


def gap_readings(spec, picked, seed: int, device: str, control: bool = False) -> Dict[str, float]:
    """Over the replies ``picked``, the widest gap below the float32
    reference's best logit of: each served token (``program``); with
    ``control``, the token the float8 reference puts first at each of the
    same positions (``control``: float8 products, bfloat16 elsewhere), and
    each served token altered by one
    (``token_altered``)."""
    import torch

    from portbench import reference

    config = spec["config"]
    reference.no_tf32()
    dev = torch.device(device)
    dtype = getattr(torch, config["assumed"]["dtype"])
    params = reference.f32(weights.gpt2(config, seed, dev, dtype=dtype))
    n_heads = weights.dims(config)["n_heads"]
    worst = {"program": 0.0, "tokens": 0}
    if control:
        worst.update(control=0.0, token_altered=0.0)
    with torch.no_grad():
        for r in picked:
            seq = torch.tensor(r["prompt"] + r["out"][:-1], device=dev)[None]
            logits = reference.gpt2_logits(params, seq, n_heads)[0]
            p, out = len(r["prompt"]), r["out"]
            worst["program"] = max(worst["program"], float(served_gaps(logits, p, out).max()))
            worst["tokens"] += len(out)
            if control:
                low = reference.gpt2_logits(params, seq, n_heads, quant=reference.fp8,
                                            dtype=torch.bfloat16)[0]
                firsts = low[p - 1:p - 1 + len(out)].argmax(dim=-1).tolist()
                worst["control"] = max(worst["control"], float(served_gaps(logits, p, firsts).max()))
                altered = [(t + 1) % logits.shape[-1] for t in out]
                worst["token_altered"] = max(worst["token_altered"],
                                             float(served_gaps(logits, p, altered).max()))
    return worst


def _check(spec, replies, seed: int, device: str):
    """The widest gap between a served token's reference logit and the
    reference's best, over a sample of the window's replies drawn from
    the seed, the longest among them."""
    cell = spec["cell"]
    limit = float(cell["check"]["logit_gap_max"])
    picked = sample_replies(replies, int(cell["check"]["sample"]), seed)
    if not picked:
        return {"logit_gap_max": {"value": None, "limit": limit}}, None
    g = gap_readings(spec, picked, seed, device, control=bool(spec.get("control")))
    checks = {"logit_gap_max": {"value": g["program"], "limit": limit,
                                "over": f"{len(picked)} replies, {g['tokens']} served tokens"}}
    return checks, ({k: g[k] for k in ("control", "token_altered")} if spec.get("control") else None)
