"""The port's KV-cache generation against ray_tpu.models.generate.

The cases of tests/test_generate.py, run on both packages from the same
weights: cached greedy decode equals full-recompute greedy decode, slots
of different lengths decode as they would alone, EOS freezes a slot, and
prefill plus chunked decode equals one-shot generation.  Every port
stream must also equal the JAX package's stream.  f32 configs, so argmax
never flips on accumulation-order noise; logits are compared at atol
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.convert import from_jax_params
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama


def _pair(family, seed):
    if family == "gpt2":
        jcfg, tcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32), tgpt2.GPT2Config.tiny(dtype=torch.float32)
        jp = jgpt2.init(jcfg, jax.random.PRNGKey(seed))
        apply_fn = tgpt2.apply
    else:
        jcfg, tcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32), tllama.LlamaConfig.tiny(dtype=torch.float32)
        jp = jllama.init(jcfg, jax.random.PRNGKey(seed))
        apply_fn = tllama.apply
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp, apply_fn


def _jax_generate(jp, jcfg, prompts, lengths, n, eos_id=None):
    out = jgen.generate(jp, jcfg, jnp.asarray(prompts), jnp.asarray(lengths),
                        max_new_tokens=n, eos_id=eos_id)
    return np.asarray(out).tolist()


def _torch_generate(tp, tcfg, prompts, lengths, n, eos_id=None):
    out = tgen.generate(tp, tcfg, torch.tensor(prompts), torch.tensor(lengths),
                        max_new_tokens=n, eos_id=eos_id)
    return out.tolist()


def _greedy_reference(apply_fn, params, cfg, prompt, n_new):
    """Teacher forcing: the full forward each step, argmax of the last
    logit."""
    toks = list(prompt)
    for _ in range(n_new):
        logits = apply_fn(params, torch.tensor([toks]), cfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_cached_decode_matches_full_forward_and_jax(family):
    jcfg, jp, tcfg, tp, apply_fn = _pair(family, 0)
    prompt = [3, 17, 5, 9, 2, 11]
    got = _torch_generate(tp, tcfg, [prompt], [len(prompt)], 8)[0]
    assert got == _greedy_reference(apply_fn, tp, tcfg, prompt, 8)
    assert got == _jax_generate(jp, jcfg, [prompt], [len(prompt)], 8)[0]


def test_batched_slots_with_different_lengths():
    jcfg, jp, tcfg, tp, _ = _pair("llama", 1)
    p_a, p_b = [5, 9, 2], [7, 1, 4, 8, 3, 6, 12]
    solo = [_torch_generate(tp, tcfg, [p], [len(p)], 6)[0] for p in (p_a, p_b)]
    pad = max(len(p_a), len(p_b))
    batch = [p_a + [0] * (pad - len(p_a)), p_b]
    lengths = [len(p_a), len(p_b)]
    got = _torch_generate(tp, tcfg, batch, lengths, 6)
    assert got == solo
    assert got == _jax_generate(jp, jcfg, batch, lengths, 6)


def test_eos_freezes_slot():
    jcfg, jp, tcfg, tp, _ = _pair("gpt2", 2)
    prompt = [[3, 17, 5, 9]]
    toks = _torch_generate(tp, tcfg, prompt, [4], 10)[0]
    eos = toks[2]
    toks2 = _torch_generate(tp, tcfg, prompt, [4], 10, eos_id=eos)[0]
    assert toks2[:3] == toks[:3]
    assert all(t == eos for t in toks2[2:])
    assert toks2 == _jax_generate(jp, jcfg, prompt, [4], 10, eos_id=eos)[0]


def test_prefill_then_chunked_decode_equals_one_shot():
    """The serving path (prefill, then several decode_chunk calls on a
    cache written in place) equals one-shot generate."""
    jcfg, jp, tcfg, tp, _ = _pair("llama", 3)
    prompt = [9, 4, 7, 2, 5]
    one = _torch_generate(tp, tcfg, [prompt], [len(prompt)], 9)[0]
    cache = tgen.init_cache(tcfg, 1, len(prompt) + 9, device="cpu")
    last, cache2 = tgen.prefill(tp, tcfg, torch.tensor([prompt]),
                                torch.tensor([len(prompt)]), cache, 0)
    assert cache2 is cache and int(cache["pos"][0]) == len(prompt)
    tok = tgen.sample_logits(last)
    emitted = [int(tok[0])]
    active = torch.ones(1, dtype=torch.bool)
    for _ in range(2):  # 2 chunks of 4 = the remaining 8 tokens
        chunk, cache, active = tgen.decode_chunk(tp, tcfg, cache, tok, active, steps=4)
        emitted.extend(int(t) for t in chunk[0])
        tok = chunk[:, -1]
    assert emitted == one == _jax_generate(jp, jcfg, [prompt], [len(prompt)], 9)[0]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_prefill_and_decode_step_logits_match_jax(family):
    """Logit-level parity of the cache path, with slots at different
    positions and one slot inactive (its pos must not advance)."""
    jcfg, jp, tcfg, tp, _ = _pair(family, 4)
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, jcfg.vocab_size, (3, 7))
    lengths = np.array([7, 3, 5])
    slots = np.array([2, 0, 1])
    jcache = jgen.init_cache(jcfg, 3, 16)
    jlast, jcache = jgen.prefill_at(jp, jcfg, jnp.asarray(prompts), jnp.asarray(lengths),
                                    jcache, jnp.asarray(slots))
    tcache = tgen.init_cache(tcfg, 3, 16, device="cpu")
    tlast, tcache = tgen.prefill_at(tp, tcfg, torch.from_numpy(prompts),
                                    torch.from_numpy(lengths), tcache, torch.from_numpy(slots))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4, rtol=0)
    toks = np.array([11, 12, 13])
    active = np.array([True, False, True])
    for _ in range(3):
        jlog, jcache = jgen.decode_step(jp, jcfg, jcache, jnp.asarray(toks), jnp.asarray(active))
        tlog, tcache = tgen.decode_step(tp, tcfg, tcache, torch.from_numpy(toks),
                                        torch.from_numpy(active))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
        toks = np.array(jnp.argmax(jlog, -1))
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("top_k", [1, 3])
def test_sampling_draws_only_from_the_top_k(top_k):
    """Temperature sampling with a torch.Generator (its draws cannot match
    jax.random's, so the support is checked, not the stream)."""
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 50)).astype(np.float32))
    allowed = torch.topk(logits, top_k, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        toks = tgen.sample_logits(logits, g, temperature=0.8, top_k=top_k)
        assert bool((allowed == toks[:, None]).any(-1).all())
    if top_k == 1:
        assert torch.equal(toks, tgen.sample_logits(logits))  # top-1 is greedy


def test_prefill_wider_than_cache_raises():
    _, _, tcfg, tp, _ = _pair("gpt2", 5)
    cache = tgen.init_cache(tcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cache length"):
        tgen.prefill(tp, tcfg, torch.ones(1, 6, dtype=torch.long), torch.tensor([6]), cache, 0)


def _attend_inputs(h, kv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return mk(3, h, 1, d), mk(3, kv, s, d), mk(3, kv, s, d), torch.tensor([0, s - 1, s // 2])


# (query heads, KV heads, dtype): MHA, GQA g = 3 and 2, MQA g = 8
ATTEND_CASES = [(4, 4, torch.float32), (6, 2, torch.float32), (4, 2, torch.bfloat16),
                (8, 1, torch.float16), (4, 4, torch.bfloat16)]


@pytest.mark.parametrize("h,kv,dtype", ATTEND_CASES)
def test_decode_attend_reads_the_cache_only_up_to_pos(h, kv, dtype):
    """On CPU tensors ``decode_attention_reference`` is the plain version:
    each slot's result is attention over ``cache[b, :, :pos+1]`` alone
    (query head ``i`` on KV head ``i // (h // kv)``), and a tail of large
    values past ``pos`` changes nothing."""
    from ray_tpu_torch.ops import attention as ta

    q, k, v, pos = _attend_inputs(h, kv, 9, 16, dtype, seed=7)
    got = ta.decode_attention_reference(q, k, v, pos)
    assert got.shape == (3, h, 1, 16) and got.dtype == torch.float32
    past = (torch.arange(9) > pos[:, None])[:, None, :, None].expand_as(k)
    big_k, big_v = k.masked_fill(past, 1e4), v.masked_fill(past, -1e4)
    assert torch.equal(ta.decode_attention_reference(q, big_k, big_v, pos), got)
    for b in range(3):
        n = int(pos[b]) + 1
        kb = k[b, :, :n].repeat_interleave(h // kv, dim=0).float()
        vb = v[b, :, :n].repeat_interleave(h // kv, dim=0).float()
        w = torch.softmax(q[b].float() @ kb.transpose(-1, -2) * 16 ** -0.5, dim=-1)
        want = w.to(dtype).float() @ vb
        torch.testing.assert_close(got[b], want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("h,kv,dtype", ATTEND_CASES)
def test_decode_attention_on_cpu_is_the_plain_version_rounded_once(h, kv, dtype):
    """``decode_attention`` on CPU tensors: the plain version with the
    heads merged and rounded once to the cache's dtype, no kernel
    launched."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as ta

    q, k, v, pos = _attend_inputs(h, kv, 9, 16, dtype, seed=8)
    before = _build.launches.get(ta.DECODE_KERNEL, 0)
    got = ta.decode_attention(q, k, v, pos)
    assert _build.launches.get(ta.DECODE_KERNEL, 0) == before
    want = ta.decode_attention_reference(q, k, v, pos).transpose(1, 2).reshape(3, 1, h * 16)
    assert got.dtype == dtype and torch.equal(got, want.to(dtype))


@pytest.mark.parametrize("shape,match", [
    (dict(q=(3, 4, 2, 16)), "q \\[B, H, 1, dh\\]"),
    (dict(k=(2, 4, 9, 16)), "shapes disagree"),
    (dict(k=(3, 3, 9, 16)), "shapes disagree"),
    (dict(pos=(2,)), "shapes disagree"),
])
def test_decode_attention_rejects_shapes_that_disagree(shape, match):
    """On any device: q one row a slot, caches of q's batch and head dim
    whose KV heads divide q's heads, one position a slot."""
    from ray_tpu_torch.ops import attention as ta

    sizes = {"q": (3, 4, 1, 16), "k": (3, 4, 9, 16), "pos": (3,), **shape}
    q, k = torch.zeros(sizes["q"]), torch.zeros(sizes["k"])
    with pytest.raises(ValueError, match=match):
        ta.decode_attention(q, k, k.clone(), torch.zeros(sizes["pos"], dtype=torch.long))
