"""The port's flash-attention backward against ray_tpu.ops.attention.

The plain versions of the two backward kernels (``flash_dq_reference``,
``flash_dkv_reference``) are held against the TPU kernels themselves,
``_flash_backward`` run in interpret mode, from the same q, k, v, dO and
the same forward residuals (out, lse).  ``FlashAttention`` (the port's
counterpart of the ``flash_attention_tpu`` custom VJP) is held against
torch autograd through ``mha_reference`` and against ``jax.grad`` of
``flash_attention_tpu`` in interpret mode.  f32 throughout.  Tolerances
are the JAX package's own for these kernels (``tests/test_ops.py``):
2e-5 for square shapes, 2e-4 for rectangular ones, 3e-5 for gradients
through the whole function; only the order of f32 sums differs.

The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as ta

ja = importlib.import_module("ray_tpu.ops.attention")


def _arrays(t_q, t_k, b=2, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, h, t_q, d), f(b, h, t_k, d), f(b, h, t_k, d), f(b, h, t_q, d)


@pytest.mark.parametrize("t_q,t_k,atol", [(128, 128, 2e-5), (64, 128, 2e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret(t_q, t_k, atol, causal):
    """dq, dk and dv of the plain versions against ``_flash_backward`` with
    blocks of 64, given the same forward residuals."""
    q, k, v, do = _arrays(t_q, t_k)
    scale = q.shape[-1] ** -0.5
    out, lse = ja._flash_forward(*map(jnp.asarray, (q, k, v)), causal=causal, scale=scale,
                                 block_q=64, block_k=64, interpret=True)
    want = ja._flash_backward(*map(jnp.asarray, (q, k, v)), out, lse, jnp.asarray(do),
                              causal=causal, scale=scale, block_q=64, block_k=64,
                              interpret=True)
    tq, tk, tv, tdo, tout, tlse = (torch.from_numpy(np.array(a))
                                   for a in (q, k, v, do, out, lse))
    delta = (tdo * tout).sum(-1)
    dq = ta.flash_dq_reference(tq, tk, tv, tdo, tlse, delta, causal, scale)
    dk, dv = ta.flash_dkv_reference(tq, tk, tv, tdo, tlse, delta, causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=atol,
                                   err_msg=name)
    # the backward wrapper on CPU tensors is exactly the two plain versions
    for got, ref in zip(ta.flash_attention_backward(tq, tk, tv, tout, tlse, tdo, causal, scale),
                        (dq, dk, dv)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("t_q,t_k,causal", [(128, 128, True), (128, 128, False),
                                            (64, 128, True), (97, 131, True)])
@pytest.mark.parametrize("strided_do", [False, True])
def test_flash_attention_function_matches_autograd_and_jax(t_q, t_k, causal, strided_do):
    """Gradients of ``FlashAttention`` on CPU tensors against torch
    autograd through ``mha_reference``, and (block-divisible shapes)
    against ``jax.grad`` of ``flash_attention_tpu(..., interpret=True)``.
    With ``strided_do`` the output goes through the models' head merge
    (``transpose(1, 2).reshape``), so the dO autograd hands the backward is
    a strided view."""
    q, k, v, w = _arrays(t_q, t_k, seed=1)
    b, h, _, d = q.shape

    def weigh(out, wt):
        if strided_do:  # [B, H, T, D] -> [B, T, H*D], as transformer.py merges heads
            swap = lambda x: (x.permute(0, 2, 1, 3) if isinstance(x, torch.Tensor)
                              else x.transpose(0, 2, 1, 3))
            out, wt = (swap(x).reshape(b, t_q, h * d) for x in (out, wt))
        return (out * wt).sum()

    def torch_grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        weigh(fn(*ts), torch.from_numpy(w)).backward()
        return [t.grad for t in ts]

    got = torch_grads(lambda *ts: ta.flash_attn(*ts, causal=causal))
    want = torch_grads(lambda *ts: ta.mha_reference(*ts, causal=causal))
    for name, g, r in zip("qkv", got, want):
        torch.testing.assert_close(g, r, atol=3e-5, rtol=3e-5, msg=f"d{name}")
    if t_q % 64 or t_k % 64:
        return  # the Pallas kernel takes block-divisible lengths only
    jgrads = jax.grad(
        lambda *xs: weigh(ja.flash_attention_tpu(*xs, causal, None, 64, 64, True),
                          jnp.asarray(w)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, g, r in zip("qkv", got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5, rtol=3e-5,
                                   err_msg=f"d{name}")


def test_backward_on_cpu_counts_no_launch_and_runs_under_inference_mode():
    q, k, v, _ = map(torch.from_numpy, _arrays(16, 16, d=16))
    before = dict(_build.launches)
    qg = q.clone().requires_grad_()
    ta.flash_attn(qg, k, v, causal=True).sum().backward()
    assert qg.grad is not None and dict(_build.launches) == before
    with torch.inference_mode():
        out = ta.flash_attn(q, k, v, causal=True)
    torch.testing.assert_close(out, ta.mha_reference(q, k, v, causal=True), atol=2e-5, rtol=2e-5)
    assert dict(_build.launches) == before


def test_causal_with_more_queries_than_keys_still_raises():
    q, k, v, do = map(torch.from_numpy, _arrays(64, 32, d=16))
    with pytest.raises(ValueError, match="t_q <= t_k"):
        ta.flash_attn(q, k, v, causal=True)
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="t_q <= t_k"):
        ta.flash_bwd_dq(q, k, v, do, lse, lse, causal=True)
    with pytest.raises(ValueError, match="t_q <= t_k"):
        ta.flash_bwd_dkv(q, k, v, do, lse, lse, causal=True)
