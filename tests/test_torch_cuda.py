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
before a rounding can move it by one bf16 ulp).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_repeat", [1, 3])
def test_flash_attn_gradients_match_the_plain_versions(cuda, dtype, kv_repeat):
    """Gradients through FlashAttention on the card (forward and both
    backward kernels) against the same function in f32 on CPU copies (the
    plain versions): q/k/v as strided views of one fused projection, a
    strided dO, and GQA's repeated KV heads.  f32: 1e-4 absolute and
    relative.  bf16: within 1e-2 of each gradient's largest entry.  P, dS
    and the outputs are rounded to bf16 (2^-8 relative each), and the
    forward's bf16 output feeds Δ, where dP − Δ cancels; the plain version
    run in bf16 is as far from the f32 gradients as the kernels are."""
    b, t, h, d = 2, 80, 6, 32
    kv = h // kv_repeat
    qkv = torch.randn(b, t, (h + 2 * kv) * d, device=cuda, dtype=torch.float32).to(dtype)
    q, k, v = (x.reshape(b, t, -1, d).transpose(1, 2)
               for x in qkv.split([h * d, kv * d, kv * d], dim=-1))
    assert not q.is_contiguous()
    w = torch.randn(b, t, h * d, device=cuda)
    before = {n: _build.launches.get(n, 0) for n in (ta.KERNEL, ta.DQ_KERNEL, ta.DKV_KERNEL)}
    got = _grads_on(cuda, q, k, v, w, True, kv_repeat)
    torch.cuda.synchronize()
    assert all(_build.launches[n] == before[n] + 1 for n in before)
    want = _grads_on("cpu", q.float(), k.float(), v.float(), w, True, kv_repeat)
    for name, g, r in zip("qkv", got, want):
        assert g.shape == r.shape and g.dtype == dtype
        atol, rtol = ((1e-4, 1e-4) if dtype == torch.float32
                      else (1e-2 * r.abs().max().item(), 0.0))
        torch.testing.assert_close(g.float().cpu(), r, atol=atol, rtol=rtol, msg=f"d{name}")


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, torch.float16, 16, 16, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ta.flash_attention(q, k, v, False)
    q, k, v = _qkv(cuda, torch.float32, 16, 16, 48)
    with pytest.raises(ValueError, match="head dim"):
        ta.flash_attention(q, k, v, False)
