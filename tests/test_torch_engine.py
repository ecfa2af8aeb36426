"""The port's continuous-batching engine against the JAX package.

The cases of tests/test_llm_serve.py that need no runtime: requests
admitted and freed mid-stream reproduce one-shot greedy generation
exactly, and the engine stops at EOS and at max_new.  Every engine stream
must equal the JAX package's one-shot stream for the same weights (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.convert import from_jax_params
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.serve.llm import GenerationEngine, make_config


def _pair(seed):
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    tcfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    jp = jgpt2.init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _one_shot(jp, jcfg, prompt, n):
    out = jgen.generate(jp, jcfg, jnp.asarray([prompt]), jnp.asarray([len(prompt)]),
                        max_new_tokens=n)
    return [int(t) for t in out[0]]


def test_engine_matches_one_shot_under_continuous_batching():
    jcfg, jp, tcfg, tp = _pair(0)
    eng = GenerationEngine(tcfg, tp, n_slots=2, max_new_tokens=8, decode_chunk_steps=3,
                           prefill_buckets=(8, 16), device="cpu").start()
    try:
        prompts = [[3, 17, 5], [9, 2], [11, 4, 7, 1], [6], [8, 8, 3, 2, 1]]
        futs = [eng.submit(p, 8) for p in prompts]  # 5 requests, 2 slots
        got = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    for p, g in zip(prompts, got):
        assert g == _one_shot(jp, jcfg, p, 8), f"prompt {p}"
    stats = eng.stats()
    assert stats["total_requests"] == 5 and stats["total_generated_tokens"] == 40
    perf = eng.perf_stats()
    assert perf["ttft"]["count"] == 5 and perf["itl"]["count"] > 0
    assert 1 <= perf["itl"]["tokens_per_sample"] <= 8
    b2b = perf["itl"]["back_to_back"]
    assert (b2b is None) == (perf["decode_tick_baseline_s"] is None)
    assert b2b is None or 0 <= b2b <= perf["itl"]["count"]


def test_engine_eos_and_max_new():
    jcfg, jp, tcfg, tp = _pair(1)
    ref = _one_shot(jp, jcfg, [5, 9, 2, 4], 12)
    eos = ref[-1]
    idx = ref.index(eos)
    eng = GenerationEngine(tcfg, tp, n_slots=1, max_new_tokens=12, decode_chunk_steps=5,
                           prefill_buckets=(8,), eos_id=eos, device="cpu").start()
    try:
        out = eng.generate([5, 9, 2, 4], timeout=120)
    finally:
        eng.stop()
    assert out == ref[:idx + 1]  # stops AT the eos token
    eng2 = GenerationEngine(tcfg, tp, n_slots=1, max_new_tokens=3, decode_chunk_steps=5,
                            prefill_buckets=(8,), device="cpu").start()
    try:
        out2 = eng2.generate([5, 9, 2, 4], timeout=120)
    finally:
        eng2.stop()
    assert out2 == ref[:3]


def test_engine_stream_yields_the_generated_tokens():
    jcfg, jp, tcfg, tp = _pair(2)
    eng = GenerationEngine(tcfg, tp, n_slots=2, max_new_tokens=7, decode_chunk_steps=2,
                           prefill_buckets=(8,), device="cpu").start()
    try:
        streamed = list(eng.stream([4, 4, 9], timeout=120))
    finally:
        eng.stop()
    assert streamed == _one_shot(jp, jcfg, [4, 4, 9], 7)


def test_engine_rejects_bad_prompts_and_oversized_cache():
    cfg = make_config("gpt2", "tiny", dtype=torch.float32)
    eng = GenerationEngine(cfg, n_slots=1, max_new_tokens=4, prefill_buckets=(8,),
                           device="cpu")
    for bad in ([], [1] * 9, [cfg.vocab_size]):
        with pytest.raises(ValueError):
            eng.submit(bad)
    # the engine's cache would need more positions than GPT-2's wpe holds
    with pytest.raises(ValueError, match="positions"):
        GenerationEngine(cfg, n_slots=1, max_new_tokens=100, prefill_buckets=(64,),
                         device="cpu")


def _scheduled_work(reqs, n_slots, chunk):
    """The decode steps and attended positions of the engine's schedule,
    worked out from the requests' (prompt length, max_new) alone: each
    iteration fills the free slots in queue order, decodes a chunk for
    every occupied slot (a row at step s attends len + steps so far + s +
    1 positions), and frees the slots whose request is then scheduled to
    its cap (the prefill gave the first token)."""
    queue, slots = list(reqs), [None] * n_slots
    steps = positions = 0
    while queue or any(slots):
        for i in range(n_slots):
            if slots[i] is None and queue:
                n, m = queue.pop(0)
                slots[i] = [n, m, 1, 0]  # length, cap, scheduled, decode steps
        steps += chunk
        for i, row in enumerate(slots):
            if row is None:
                continue
            n, m, sched, done = row
            positions += sum(n + done + s + 1 for s in range(chunk))
            row[2], row[3] = min(m, sched + chunk), done + chunk
            if row[2] >= m:
                slots[i] = None
    return steps, positions


def test_engine_counts_decode_steps_and_the_positions_they_attend():
    """Across admissions mid-stream (five requests on two slots, queued
    before the engine starts), ``decode_steps`` and
    ``kv_positions_attended`` equal the schedule's, recomputed from the
    requests' lengths."""
    cfg = make_config("gpt2", "tiny", dtype=torch.float32)
    reqs = [(3, 8), (2, 4), (5, 6), (1, 7), (4, 2)]
    eng = GenerationEngine(cfg, n_slots=2, max_new_tokens=8, decode_chunk_steps=3,
                           prefill_buckets=(8,), device="cpu")
    futs = [eng.submit([7 + j for j in range(n)], m) for n, m in reqs]
    eng.start()
    try:
        assert [len(f.result(timeout=120)) for f in futs] == [m for _, m in reqs]
    finally:
        eng.stop()
    stats = eng.stats()
    assert (stats["decode_steps"], stats["kv_positions_attended"]) == _scheduled_work(reqs, 2, 3)
    assert stats["decode_steps"] == 3 * sum(eng.perf_stats()["ticks"].values())
