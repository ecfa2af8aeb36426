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
same tolerances.  The decode kernel's tolerances are stated at its
tests.
"""

import os

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


# ---------------------------------------------------------------------------
# decode attention: the decode_attend kernel
# ---------------------------------------------------------------------------

# (B, H, KV, S, dh, dtype)
DECODE_CASES = [
    (257, 12, 12, 912, 64, torch.bfloat16),  # the decode-long cell: 256 slots and the scratch one
    (6, 16, 4, 700, 128, torch.bfloat16),    # GQA, g = 4
    (6, 16, 4, 700, 128, torch.float32),     # the same in f32
    (5, 4, 4, 40, 16, torch.float32),        # the tiny configs chip_smoke.py decodes in f32
    (3, 24, 3, 300, 96, torch.float16),      # g = 8, a head dim off a power of two
    (4, 6, 2, 530, 256, torch.float32),      # g = 3, two 16-byte chunks a lane
    (2, 2, 1, 1, 8, torch.bfloat16),         # one position
]

# the kernel's f32 result against f32 attention: only the order of the sums
# and exp2 against exp differ (1e-4 relative, 1e-5 absolute); a bf16 or
# f16 output adds one rounding, at most half a unit in the last place
# (2^-8 and 2^-11 relative)
DECODE_F32_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 1e-4 + 2 ** -8),
                  torch.float16: (1e-5, 1e-4 + 2 ** -11)}


def _decode_inputs(device, b, h, kv, s, d, dtype, seed=0):
    """q [B, H, 1, dh] and caches [B, KV, S, dh] drawn on the card; pos
    with 0 and S - 1 among random positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, generator=g, device=device).to(dtype)
    pos = torch.randint(0, s, (b,), generator=g, device=device)
    pos[0], pos[-1] = 0, s - 1
    return mk(b, h, 1, d), mk(b, kv, s, d), mk(b, kv, s, d), pos


def _decode_f32(q, k, v, pos):
    """Attention over positions 0..pos in f32 from the same cache, P kept
    in f32 as the kernel keeps it: ``[B, 1, H·dh]``."""
    b, h, _, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    scores = torch.einsum("bkgd,bksd->bkgs", q.float().reshape(b, kv, h // kv, d),
                          k.float()) * d ** -0.5
    mask = torch.arange(s, device=q.device) <= pos[:, None, None, None]
    w = torch.softmax(torch.where(mask, scores, ta.NEG_INF), dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", w, v.float()).reshape(b, 1, h * d)


@pytest.mark.parametrize("b,h,kv,s,d,dtype", DECODE_CASES)
def test_decode_kernel_matches_f32_attention(cuda, b, h, kv, s, d, dtype):
    """Against f32 attention from the same cache, at ``DECODE_F32_TOL``:
    f32 caches hold the kernel's arithmetic to 1e-4, the others add the
    output's one rounding."""
    q, k, v, pos = _decode_inputs(cuda, b, h, kv, s, d, dtype)
    before = _build.launches.get(ta.DECODE_KERNEL, 0)
    out = ta.decode_attention(q, k, v, pos)
    assert _build.launches[ta.DECODE_KERNEL] == before + 1
    assert out.shape == (b, 1, h * d) and out.dtype == dtype
    atol, rtol = DECODE_F32_TOL[dtype]
    torch.testing.assert_close(out.float(), _decode_f32(q, k, v, pos), atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,h,kv,s,d,dtype", DECODE_CASES)
def test_decode_kernel_matches_the_plain_version(cuda, b, h, kv, s, d, dtype):
    """Against ``decode_attention_reference``, which rounds the normalised
    weights to the cache's dtype before P·V (the kernel keeps them f32) and
    leaves its result f32: bf16 1e-2 absolute and relative (2^-9 of each
    weight, then 2^-9 of the kernel's result), f16 2e-3 (2^-12 each), f32
    1e-5 and 1e-4."""
    q, k, v, pos = _decode_inputs(cuda, b, h, kv, s, d, dtype, seed=1)
    out = ta.decode_attention(q, k, v, pos)
    plain = ta.decode_attention_reference(q, k, v, pos).transpose(1, 2).reshape(b, 1, h * d)
    atol, rtol = {torch.bfloat16: (1e-2, 1e-2), torch.float16: (2e-3, 2e-3),
                  torch.float32: (1e-5, 1e-4)}[dtype]
    torch.testing.assert_close(out.float(), plain, atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,h,kv,s,d,dtype", [DECODE_CASES[0], DECODE_CASES[5]])
def test_decode_kernel_never_reads_past_pos(cuda, b, h, kv, s, d, dtype):
    """NaN written past every slot's position changes no bit of the
    result: those positions are never read."""
    q, k, v, pos = _decode_inputs(cuda, b, h, kv, s, d, dtype, seed=3)
    clean = ta.decode_attention(q, k, v, pos)
    past = torch.arange(s, device=cuda) > pos[:, None]  # [B, S]
    k[past[:, None, :, None].expand_as(k)] = float("nan")
    v[past[:, None, :, None].expand_as(v)] = float("nan")
    assert torch.equal(ta.decode_attention(q, k, v, pos), clean)


def test_decode_kernel_makes_no_copy_of_the_cache(cuda):
    """At the cell's shape (two 359 MB bf16 caches) the call allocates its
    output and nothing else: an f32 copy of either cache would be 718 MB."""
    q, k, v, pos = _decode_inputs(cuda, *DECODE_CASES[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = ta.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= out.numel() * out.element_size() + 512


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_decode_step_on_card_launches_the_kernel_once_a_layer(cuda, family):
    """Tiny GPT-2 and tiny Llama (GQA, g = 2) in f32: one ``decode_step``
    on the card launches ``decode_attend`` once a layer, and its logits and
    positions match the CPU's (the plain version) within 1e-4."""
    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.models import gpt2, llama

    mod = gpt2 if family == "gpt2" else llama
    cfg = (gpt2.GPT2Config if family == "gpt2" else llama.LlamaConfig).tiny(dtype=torch.float32)
    params = mod.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 7)))
    lengths = torch.tensor([7, 2, 5])
    toks, active = torch.tensor([5, 6, 7]), torch.tensor([True, False, True])
    got = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        cache = gen.init_cache(cfg, 3, 24, device=dev)
        with torch.inference_mode():
            gen.prefill(p, cfg, prompts.to(dev), lengths.to(dev), cache, 0)
            before = _build.launches.get(ta.DECODE_KERNEL, 0)
            logits, cache = gen.decode_step(p, cfg, cache, toks.to(dev), active.to(dev))
        got[str(dev)] = (logits.cpu(), cache["pos"].cpu(),
                         _build.launches.get(ta.DECODE_KERNEL, 0) - before)
    assert got["cpu"][2] == 0 and got["cuda"][2] == cfg.n_layers
    torch.testing.assert_close(got["cuda"][0], got["cpu"][0], atol=1e-4, rtol=0)
    assert torch.equal(got["cuda"][1], got["cpu"][1])


def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    before = dict(_build.launches)
    for (b, h, kv, s, d, dtype), match in (
            ((2, 4, 4, 16, 12, torch.bfloat16), "head dim 12"),
            ((2, 4, 4, 16, 264, torch.float32), "head dim 264"),
            ((2, 16, 1, 16, 64, torch.bfloat16), "1 to 8 query heads"),
            ((2, 4, 4, 16, 64, torch.float64), "float32, bfloat16 or float16")):
        q, k, v, pos = _decode_inputs(cuda, b, h, kv, s, d, dtype)
        with pytest.raises(ValueError, match=match):
            ta.decode_attention(q, k, v, pos)
    q, k, v, pos = _decode_inputs(cuda, 2, 4, 4, 16, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="int64"):
        ta.decode_attention(q, k, v, pos.int())
    with pytest.raises(ValueError, match="one CUDA device"):
        ta.decode_attention(q, k, v, pos.cpu())
    padded = torch.zeros(2, 4, 16, 68, dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        ta.decode_attention(q, padded, v, pos)
    assert dict(_build.launches) == before


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


@pytest.fixture
def world_of_one(cuda, tmp_path):
    """A one-rank NCCL world on the card and a mesh of six unit axes."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec, create_mesh, init_world

    init_world("nccl", 0, 1, f"file://{tmp_path}/rendezvous")
    try:
        yield create_mesh(MeshSpec(), keep_unit_axes=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n_experts", [0, 4])
def test_sharded_step_on_a_world_of_one_matches_unsharded(world_of_one, n_experts):
    """The sharded step (DTensor params on the card, the flash kernels per
    rank) against the unsharded one from the same init, f32: 2 steps'
    losses and the params after them within 1e-5, and the same flash
    launches."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import named_leaves, train_state
    from ray_tpu_torch.parallel import shard_params
    from ray_tpu_torch.parallel.sharding import rules_for_mesh

    mesh = world_of_one
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, n_experts=n_experts)
    opt = gpt2.make_optimizer(lr=1e-3, warmup=0, total_steps=10)
    batch = {k: torch.from_numpy(np.random.default_rng(3).integers(0, 512, (4, 64))).cuda()
             for k in ("inputs", "targets")}
    runs = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        params = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cuda")
        if m is not None:
            params = shard_params(params, m, rules_for_mesh(m), gpt2.logical_axes(cfg))
        state, step = train_state(params, opt), gpt2.make_train_step(cfg, opt, m)
        _build.reset_launches()
        losses = [step(state, batch)[1]["loss"].item() for _ in range(2)]
        leaves = {n: (t.full_tensor() if m is not None else t).detach()
                  for n, t in named_leaves(state["params"])}
        runs[name] = (losses, leaves, dict(_build.launches))
    (ls, ps, ns), (lu, pu, nu) = runs["sharded"], runs["unsharded"]
    np.testing.assert_allclose(ls, lu, rtol=1e-5)
    for n in pu:
        torch.testing.assert_close(ps[n], pu[n], atol=1e-5, rtol=1e-5)
    assert ns == nu and ns[ta.KERNEL] == 2 * cfg.n_layers


def test_ring_attention_on_a_world_of_one_matches_flash(world_of_one):
    from ray_tpu_torch.ops.ring_attention import ring_attention

    q, k, v = _qkv(torch.device("cuda"), torch.float32, 96, 96, 32)
    for causal in (False, True):
        torch.testing.assert_close(ring_attention(q, k, v, world_of_one, causal=causal),
                                   ta.flash_attn(q, k, v, causal), atol=1e-5, rtol=1e-5)


def _tiny_gpt2_trainer_loop(config):
    """A tiny GPT-2's steps in a Train worker on its granted card, the
    gradients all-reduced over the gang's ``torch`` group (NCCL)."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.util import collective
    from ray_tpu_torch.util.tree import tree_map

    dev = torch_utils.get_device()
    cfg = gpt2.GPT2Config.tiny(dtype=torch.bfloat16, d_model=128, n_heads=2)
    opt = gpt2.make_optimizer(lr=1e-3, warmup=0)
    state = gpt2.init_state(cfg, torch.Generator().manual_seed(0), opt, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len + 1),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    _build.reset_launches()
    for _ in range(config["steps"]):
        gpt2.AdamW.zero_grad(state["opt_state"])
        loss = gpt2.loss_fn(state["params"], {"tokens": tokens}, cfg)
        loss.backward()
        grads = torch_utils.allreduce_grads(tree_map(lambda p: p.grad, state["params"]))
        tree_map(lambda p, g: setattr(p, "grad", g), state["params"], grads)
        gpt2.AdamW.update(state["opt_state"])
        session.report({"loss": loss.item(), "device": str(dev),
                        "flash_fwd": _build.launches.get(ta.KERNEL, 0),
                        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "group": (collective.get_group_backend(
                            os.environ["RAY_TRAIN_COLLECTIVE_GROUP"]),
                            torch.distributed.get_backend())})


def test_gpu_actor_and_trainer_on_the_card(cuda):
    """The port's runtime on the card: a ``num_gpus=1`` actor gets the card
    as its ``CUDA_VISIBLE_DEVICES``, and a ``TorchTrainer`` worker in an NCCL
    world of one, which the default ``TorchConfig`` chooses for a worker
    that holds a card, trains through the flash kernels."""
    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        class OnCard:
            def probe(self):
                x = torch.ones(256, 256, dtype=torch.bfloat16, device="cuda")
                return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                        ray_tpu_torch.get_runtime_context().get_gpu_ids(),
                        float((x @ x).float().sum()))

        a = OnCard.remote()
        visible, ids, total = ray_tpu_torch.get(a.probe.remote(), timeout=120)
        assert (visible, ids, total) == (str(ids[0]), [ids[0]], 256.0 ** 3)
        ray_tpu_torch.kill(a)
        result = TorchTrainer(_tiny_gpt2_trainer_loop, train_loop_config={"steps": 2},
                              torch_config=TorchConfig(),
                              scaling_config=ScalingConfig(num_workers=1)).fit()
        assert result.error is None
        m = result.metrics
        assert m["device"] == "cuda:0" and m["visible"] == str(ids[0])
        assert np.isfinite(m["loss"]) and m["flash_fwd"] > 0
        assert m["group"] == ("torch", "nccl")
    finally:
        ray_tpu_torch.shutdown()


def test_serve_replicas_on_the_card(cuda):
    """Serve on the card: a ``num_gpus=1`` replica holding tiny BERT in
    f32 answers one ``@serve.batch`` batch with the labels of the same
    weights applied in this process; then ``llm_deployment``'s replica
    (a card by default) answers one request with the greedy stream of an
    in-process engine of the same settings and seed."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.serve.llm import GenerationEngine, llm_deployment, make_config

    cfg = bert.BertConfig.tiny(dtype=torch.float32)
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (4, 32))
    with torch.inference_mode():
        want = bert.apply({k: (v.cuda() if torch.is_tensor(v) else
                               {n: t.cuda() for n, t in v.items()}) for k, v in params.items()},
                          torch.from_numpy(toks).cuda(), cfg).argmax(-1).tolist()

    @serve.deployment(ray_actor_options={"num_gpus": 1}, max_concurrent_queries=8)
    class Bert:
        def __init__(self, params):
            self.params = {k: (v.cuda() if torch.is_tensor(v) else
                               {n: t.cuda() for n, t in v.items()}) for k, v in params.items()}

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
        def __call__(self, requests):
            with torch.inference_mode():
                logits = bert.apply(self.params, torch.tensor(requests, device="cuda"), cfg)
            return logits.argmax(-1).tolist()

    ray_tpu_torch.init(num_cpus=4)
    try:
        serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
        handle = serve.run(Bert.bind(params), port=0, timeout_s=300)
        got = ray_tpu_torch.get([handle.remote(t.tolist()) for t in toks], timeout=300)
        assert got == want
        serve.delete("Bert")
        engine = dict(n_slots=2, max_new_tokens=8, decode_chunk_steps=4, prefill_buckets=(16,))
        handle = serve.run(llm_deployment("gpt2", "tiny", engine_kwargs=engine).bind(),
                           port=0, timeout_s=300)
        out = ray_tpu_torch.get(handle.remote({"tokens": [5, 3, 9]}), timeout=300)["tokens"]
        ref = GenerationEngine(make_config("gpt2", "tiny"), **engine).start()
        try:
            assert out == ref.generate([5, 3, 9], timeout=300)
        finally:
            ref.stop()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_a_card_tensor_reaches_a_thin_client_with_no_card_on_the_cpu(cuda, tmp_path):
    """A task returns a tensor on the card; a ``client://`` process that
    sees no card (``CUDA_VISIBLE_DEVICES=""``) gets it as a CPU tensor
    with the same values, while this process, which has the card, gets
    it back on the card."""
    import subprocess
    import sys
    import textwrap

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker

    @ray_tpu_torch.remote(num_gpus=0.25)
    def on_card(n):
        return torch.arange(n, dtype=torch.float32, device="cuda").reshape(4, -1) * 0.5

    client = textwrap.dedent("""
        import os, sys, torch
        import ray_tpu_torch
        ray_tpu_torch.init(address=sys.argv[1], _authkey=bytes.fromhex(sys.argv[2]))
        t = ray_tpu_torch.get(ray_tpu_torch.get_actor("keeper", namespace="cuda-thin")
                              .tensor.remote(), timeout=120)
        assert not torch.cuda.is_available()
        assert t.device.type == "cpu", t.device
        assert torch.equal(t, torch.arange(64, dtype=torch.float32).reshape(4, -1) * 0.5)
        print("CPU_TENSOR_OK")
    """)

    @ray_tpu_torch.remote(num_gpus=0.25)
    class Keeper:
        def tensor(self):
            return torch.arange(64, dtype=torch.float32, device="cuda").reshape(4, -1) * 0.5

    ray_tpu_torch.init(num_cpus=2)
    try:
        here = ray_tpu_torch.get(on_card.remote(64), timeout=300)
        assert here.device.type == "cuda"
        k = Keeper.options(name="keeper", namespace="cuda-thin").remote()
        assert ray_tpu_torch.get(k.tensor.remote(), timeout=300).device.type == "cuda"
        host, port = global_worker.node.tcp_address
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
        out = subprocess.run([sys.executable, "-c", client, f"client://{host}:{port}",
                              global_worker.node.authkey.hex()], capture_output=True, text=True,
                             timeout=300, env=env,
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert "CPU_TENSOR_OK" in out.stdout, out.stderr[-3000:]
    finally:
        ray_tpu_torch.shutdown()
