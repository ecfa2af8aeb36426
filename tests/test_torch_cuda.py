"""The port's CUDA kernels on the card.  Every test here is marked ``cuda``
and skips on a host with no card.

This file imports neither JAX nor ray_tpu, so it also runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 1e-5 (only the summation order differs from the plain
version); bf16 1e-2 absolute and relative (one bf16 ulp is 2^-8 relative,
and the kernel rounds P before normalising where the plain version rounds
after); lse 1e-4 (f32 on both sides).  The backward kernels: f32 1e-4
absolute and relative (each gradient sums up to Tk or Tq products in
another order, and dS = P·(dP − Δ) cancels); bf16 1e-2 as above (both
sides round P and dS to bf16 at the same places; an f32 ulp of difference
before a rounding can move it by one bf16 ulp).  bf16 at D 64 and 128 runs
the tensor-core forward, dQ and dK/dV (``ta.uses_tensor_cores``), with the
same tolerances.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel; no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, dtype, t_q, t_k, d, b=2, h=3, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
                 .to(device, dtype) for t in (t_q, t_k, t_k))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t_q,t_k,d,causal", [(128, 128, 64, True), (97, 131, 16, True),
                                             (128, 256, 128, False), (1, 77, 32, True)])
def test_flash_kernel_matches_plain_version(cuda, dtype, tol, t_q, t_k, d, causal):
    q, k, v = _qkv(cuda, dtype, t_q, t_k, d)
    before = _build.launches.get(ta.KERNEL, 0)
    out, lse = ta.flash_attention(q, k, v, causal)
    assert _build.launches[ta.KERNEL] == before + 1
    ref_out, ref_lse = ta.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_flash_kernel_takes_strided_views(cuda):
    """q/k/v as the models make them: views into one fused qkv tensor."""
    b, t, h, d = 2, 40, 3, 32
    qkv = torch.randn(b, t, 3 * h * d, device=cuda)
    q, k, v = (x.reshape(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    out, lse = ta.flash_attention(q, k, v, True)
    ref_out, ref_lse = ta.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_attention_dispatch_on_card_takes_the_kernel(cuda):
    q, k, v = _qkv(cuda, torch.float32, 64, 64, 32)
    before = _build.launches.get(ta.KERNEL, 0)
    out = ta.attention(q, k, v, causal=True)
    assert _build.launches[ta.KERNEL] == before + 1
    torch.testing.assert_close(out, ta.mha_reference(q, k, v, causal=True), atol=1e-5, rtol=1e-5)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_q,t_k,d,causal", [(128, 128, 64, True), (97, 131, 16, True),
                                             (128, 256, 128, False), (1, 77, 32, True),
                                             (64, 64, 32, False)])
def test_flash_backward_kernels_match_plain_versions(cuda, dtype, t_q, t_k, d, causal):
    """Each backward kernel against its plain version, given the same lse
    and delta."""
    q, k, v = _qkv(cuda, dtype, t_q, t_k, d)
    do = _qkv(cuda, dtype, t_q, t_q, d, seed=1)[0]
    out, lse = ta.flash_attention_reference(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    before = {n: _build.launches.get(n, 0) for n in (ta.DQ_KERNEL, ta.DKV_KERNEL)}
    dq = ta.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = ta.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert {n: _build.launches[n] - before[n] for n in before} == {ta.DQ_KERNEL: 1,
                                                                    ta.DKV_KERNEL: 1}
    want = (ta.flash_dq_reference(q, k, v, do, lse, delta, causal),
            *ta.flash_dkv_reference(q, k, v, do, lse, delta, causal))
    tol = BWD_TOL[dtype]
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol, msg=name)


def _grads_on(device, q, k, v, w, causal, kv_repeat=1):
    """Gradients of sum(w * merged heads of flash_attn) on ``device``:
    q/k/v leaves copied there; k and v are repeated per query head first
    when ``kv_repeat`` > 1 (GQA), and the output goes through the models'
    head merge, so dO reaches the backward as a strided view."""
    leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
    qd, kd, vd = leaves
    if kv_repeat > 1:
        kd, vd = (t.repeat_interleave(kv_repeat, dim=1) for t in (kd, vd))
    out = ta.flash_attn(qd, kd, vd, causal=causal)
    b, h, t, dh = out.shape
    merged = out.transpose(1, 2).reshape(b, t, h * dh)
    (merged.float() * w.to(device)).sum().backward()
    return [t.grad for t in leaves]


def _check_flash_attn_gradients(cuda, dtype, kv_repeat, d):
    """Gradients through FlashAttention on the card against the plain
    versions on CPU copies; each kernel launched once, on the design
    ``ta.uses_tensor_cores`` picks."""
    b, t, h = 2, 80, 6
    kv = h // kv_repeat
    qkv = torch.randn(b, t, (h + 2 * kv) * d, device=cuda, dtype=torch.float32).to(dtype)
    q, k, v = (x.reshape(b, t, -1, d).transpose(1, 2)
               for x in qkv.split([h * d, kv * d, kv * d], dim=-1))
    assert not q.is_contiguous()
    w = torch.randn(b, t, h * d, device=cuda)
    tc = ta.uses_tensor_cores(dtype, d)
    want_launches = {n: 1 for n in ta.TENSOR_CORE_COUNTER}
    want_launches.update({c: int(tc) for c in ta.TENSOR_CORE_COUNTER.values()})
    before = {n: _build.launches.get(n, 0) for n in want_launches}
    got = _grads_on(cuda, q, k, v, w, True, kv_repeat)
    torch.cuda.synchronize()
    assert {n: _build.launches.get(n, 0) - before[n] for n in before} == want_launches
    want = _grads_on("cpu", q.float(), k.float(), v.float(), w, True, kv_repeat)
    for name, g, r in zip("qkv", got, want):
        assert g.shape == r.shape and g.dtype == dtype
        atol, rtol = ((1e-4, 1e-4) if dtype == torch.float32
                      else (1e-2 * r.abs().max().item(), 0.0))
        torch.testing.assert_close(g.float().cpu(), r, atol=atol, rtol=rtol, msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_repeat", [1, 3])
def test_flash_attn_gradients_match_the_plain_versions(cuda, dtype, kv_repeat):
    """Gradients through FlashAttention on the card (forward and both
    backward kernels, at D 32: the CUDA-core designs) against the same
    function in f32 on CPU copies (the plain versions): q/k/v as strided
    views of one fused projection, a strided dO, and GQA's repeated KV
    heads.  f32: 1e-4 absolute and relative.  bf16: within 1e-2 of each
    gradient's largest entry.  P, dS and the outputs are rounded to bf16
    (2^-8 relative each), and the forward's bf16 output feeds Δ, where
    dP − Δ cancels; the plain version run in bf16 is as far from the f32
    gradients as the kernels are."""
    _check_flash_attn_gradients(cuda, dtype, kv_repeat, d=32)


@pytest.mark.parametrize("kv_repeat", [1, 3])
def test_flash_attn_gradients_cross_the_tensor_core_kernels(cuda, kv_repeat):
    """The same in bf16 at D 64, the models' head dim: all three kernels
    run their tensor-core designs, GQA's repeated KV heads included."""
    _check_flash_attn_gradients(cuda, torch.bfloat16, kv_repeat, d=64)


TC_SHAPES = [(97, 131, 64, True), (97, 131, 128, True), (97, 131, 64, False),
             (128, 256, 64, True), (1, 77, 64, True), (1, 77, 128, False), (200, 200, 128, True)]


def _check_tensor_core_backward(q, k, v, do, lse, delta, causal):
    """dQ, dK and dV against their plain versions within 1e-2 + 1e-2·|ref|,
    each kernel launched once and on its tensor-core design."""
    names = (ta.DQ_KERNEL, ta.DQ_TC, ta.DKV_KERNEL, ta.DKV_TC)
    before = {n: _build.launches.get(n, 0) for n in names}
    dq = ta.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = ta.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert {n: _build.launches[n] - before[n] for n in names} == dict.fromkeys(names, 1)
    want = (ta.flash_dq_reference(q, k, v, do, lse, delta, causal),
            *ta.flash_dkv_reference(q, k, v, do, lse, delta, causal))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2, msg=name)


@pytest.mark.parametrize("t_q,t_k,d,causal", TC_SHAPES)
def test_tensor_core_kernels_match_plain_versions(cuda, t_q, t_k, d, causal):
    """bf16 at D 64 and 128 takes the tensor-core forward, dQ and dK/dV:
    ragged tiles, the bottom-right causal diagonal with Tq < Tk, one query
    row.  Tolerances as above; each launch counts on the design's
    counter."""
    q, k, v = _qkv(cuda, torch.bfloat16, t_q, t_k, d)
    do = _qkv(cuda, torch.bfloat16, t_q, t_q, d, seed=1)[0]
    names = (ta.KERNEL, ta.FWD_TC)
    before = {n: _build.launches.get(n, 0) for n in names}
    out, lse = ta.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert {n: _build.launches[n] - before[n] for n in names} == dict.fromkeys(names, 1)
    ref_out, ref_lse = ta.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = (do.float() * out.float()).sum(-1)
    _check_tensor_core_backward(q, k, v, do, lse, delta, causal)


def test_tensor_core_kernels_take_the_fused_projection_layout(cuda):
    """q/k/v as head-split views of one fused bf16 projection (time stride
    3·H·D, as GPT-2's blocks give them), dO a head-merge view."""
    b, t, h, d = 2, 150, 4, 64
    qkv = torch.randn(b, t, 3 * h * d, device=cuda).to(torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, t, h * d, device=cuda).to(torch.bfloat16).reshape(b, t, h, d).transpose(1, 2)
    before = _build.launches.get(ta.FWD_TC, 0)
    out, lse = ta.flash_attention(q, k, v, True)
    assert _build.launches[ta.FWD_TC] == before + 1
    ref_out, ref_lse = ta.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = (do.float() * out.float()).sum(-1)
    _check_tensor_core_backward(q, k, v, do, lse, delta, True)


def _bwd_inputs_256(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 256, 256, 64)
    do = _qkv(cuda, torch.bfloat16, 256, 256, 64, seed=1)[0]
    out, lse = ta.flash_attention(q, k, v, True)
    return q, k, v, do, lse, (do.float() * out.float()).sum(-1)


def test_tensor_core_dq_is_deterministic(cuda):
    """Each block owns its dQ tile and loops over K/V in a fixed order: no
    atomics, the same bits on every call."""
    args = _bwd_inputs_256(cuda)
    first = ta.flash_bwd_dq(*args, True)
    second = ta.flash_bwd_dq(*args, True)
    assert torch.equal(first, second)


def test_tensor_core_dkv_is_deterministic(cuda):
    """Each block owns its dK/dV tile and loops over Q/dO in a fixed order:
    the same bits on every call."""
    args = _bwd_inputs_256(cuda)
    first = ta.flash_bwd_dkv(*args, True)
    second = ta.flash_bwd_dkv(*args, True)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_tensor_core_kernels_reject_misaligned_rows(cuda):
    """A bf16 view that the CUDA-core design took (D 64, unit stride) but
    whose rows are off 16-byte boundaries raises; it is neither copied nor
    sent to the other design."""
    x = torch.randn(2, 3, 40, 68, device=cuda).to(torch.bfloat16)[..., 4:]
    q, k, v = _qkv(cuda, torch.bfloat16, 40, 40, 64)
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="16-byte"):
        ta.flash_attention(x, k, v, True)
    with pytest.raises(ValueError, match="16-byte"):
        ta.flash_attention(q, x, v, True)
    lse = torch.zeros(2, 3, 40, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        ta.flash_bwd_dq(q, k, v, x, lse, lse, True)
    with pytest.raises(ValueError, match="flash_bwd_dkv.*16-byte"):
        ta.flash_bwd_dkv(q, k, v, x, lse, lse, True)
    assert dict(_build.launches) == before


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, torch.float16, 16, 16, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ta.flash_attention(q, k, v, False)
    q, k, v = _qkv(cuda, torch.float32, 16, 16, 48)
    with pytest.raises(ValueError, match="head dim"):
        ta.flash_attention(q, k, v, False)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype,d_model,n_heads", [(torch.float32, 64, 4),
                                                   (torch.bfloat16, 128, 2)])
def test_bert_forward_on_card_matches_cpu(cuda, dtype, d_model, n_heads):
    """Tiny BERT's logits on the card against the CPU in f32 from the same
    weights: non-causal flash attention, once per layer, at D 16 (the
    CUDA-core design) and in bf16 at D 64 (the tensor cores).  f32 1e-4;
    bf16 2e-2 (the blocks round to bf16; the pooler and classifier are
    f32)."""
    from ray_tpu_torch.models import bert

    cfg = bert.BertConfig.tiny(dtype=dtype, d_model=d_model, n_heads=n_heads)
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 40)))
    types = torch.from_numpy(rng.integers(0, cfg.type_vocab_size, (3, 40)))
    before = {n: _build.launches.get(n, 0) for n in (ta.KERNEL, ta.FWD_TC)}
    with torch.inference_mode():
        got = bert.apply(_to(params, cuda), toks.to(cuda), cfg, types.to(cuda))
        want = bert.apply(params, toks, bert.BertConfig.tiny(
            dtype=torch.float32, d_model=d_model, n_heads=n_heads), types)
    torch.cuda.synchronize()
    tc = ta.uses_tensor_cores(dtype, cfg.head_dim)
    assert {n: _build.launches.get(n, 0) - before[n] for n in before} == \
        {ta.KERNEL: cfg.n_layers, ta.FWD_TC: cfg.n_layers * tc}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=0)


def test_moe_on_card_matches_cpu(cuda):
    """moe_ffn on the card against the CPU, f32 (TF32 off), with tokens
    dropped (cf 0.5): the output, the aux loss and every gradient within
    1e-4 absolute and relative; then tiny MoE GPT-2's loss and gradients
    (the flash kernels in its attention) within 1e-4 of each leaf's
    largest entry."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import named_leaves
    from ray_tpu_torch.ops import moe

    rng = np.random.default_rng(0)
    shapes = {"x": (2, 48, 32), "router": (32, 4), "w1": (4, 32, 64), "b1": (4, 64),
              "w2": (4, 64, 32), "b2": (4, 32)}
    base = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
            for k, s in shapes.items()}
    out = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev, copy=True).requires_grad_(True) for k, v in base.items()}
        y, aux = moe.moe_ffn(*p.values(), capacity_factor=0.5)
        ((y * y).mean() + y.mean() + 0.1 * aux).backward()
        out[str(dev)] = (y.detach().cpu(), aux.item(), {k: t.grad.cpu() for k, t in p.items()})
    (y0, a0, g0), (y1, a1, g1) = out["cpu"], out["cuda"]
    torch.testing.assert_close(y1, y0, atol=1e-4, rtol=1e-4)
    assert abs(a1 - a0) <= 1e-5
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-4, rtol=1e-4, msg=k)

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, n_experts=4)
    params = gpt2.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33)))
    res = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        for _, t in named_leaves(p):
            t.requires_grad_(True)
        loss = gpt2.loss_fn(p, {"tokens": toks.to(dev)}, cfg)
        loss.backward()
        res[str(dev)] = (loss.item(), {n: t.grad.cpu() for n, t in named_leaves(p)})
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5
    for n, g in res["cpu"][1].items():
        scale = max(g.abs().max().item(), 1e-30)
        assert (res["cuda"][1][n] - g).abs().max().item() / scale <= 1e-4, n


def test_rl_policy_on_card_matches_cpu(cuda):
    """A CNN ``TorchPolicy`` with PPO's loss, the same weights on the CPU
    and the card, f32 with TF32 off for cuDNN too: values and action
    log-probs within 1e-5, the weights after one update within 1e-5."""
    from ray_tpu_torch.rllib import TorchPolicy, ppo

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(0)
        obs = rng.integers(0, 256, (32, 36, 36, 4), dtype=np.uint8)
        acts = rng.integers(0, 6, 32)
        batch = {"obs": obs, "actions": acts,
                 "action_logp": np.full(32, np.log(1 / 6), np.float32),
                 "advantages": rng.normal(size=32).astype(np.float32),
                 "value_targets": rng.normal(size=32).astype(np.float32)}
        pols = [TorchPolicy(36 * 36 * 4, 6, hiddens=(32,), obs_shape=(36, 36, 4), device=dev,
                            loss_fn=ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01)) for dev in ("cpu", cuda)]
        pols[1].set_weights(pols[0].get_weights())
        np.testing.assert_allclose(pols[1].value(obs), pols[0].value(obs), atol=1e-5)
        np.testing.assert_allclose(pols[1].action_logp(obs, acts), pols[0].action_logp(obs, acts),
                                   atol=1e-5)
        for p in pols:
            p.learn_on_minibatch(batch)
        for w1, w0 in zip(*(p.get_weights()["pi"] for p in pols)):
            np.testing.assert_allclose(w1["w"], w0["w"], atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_rollout_worker_runs_on_the_card_by_default(cuda):
    from ray_tpu_torch.rllib import RolloutWorker, ppo, synthetic_atari_creator

    w = RolloutWorker(dict(ppo.PPO_DEFAULTS, env_creator=synthetic_atari_creator,
                           env_config={"episode_len": 6}, num_envs_per_worker=3,
                           rollout_fragment_length=4, fcnet_hiddens=(16,),
                           _loss_factory=ppo._ppo_loss_factory))
    assert all(t.is_cuda for layer in w.policy.params["conv"] for t in layer.values())
    batch = w.sample()
    assert batch["obs"].shape == (12, 84, 84, 4) and batch["obs"].dtype == np.uint8
    assert np.isfinite(batch["advantages"]).all()
