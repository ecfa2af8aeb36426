"""The port's attention against ray_tpu.ops.attention, same numpy inputs.

Each plain path is held against its JAX counterpart, including prime
lengths and t_k != t_q (bottom-right causal diagonal).  The flash kernel's
plain version is held against the Pallas kernel run in interpret mode,
for out AND the logsumexp.  f32 throughout, atol 2e-5 (the tolerance of
the JAX package's own attention tests: the same f32 arithmetic in another
summation order).

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py
and ``python3 chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as ta

ATOL = 2e-5
# the ray_tpu.ops package attribute `attention` is the function, not the module
ja = importlib.import_module("ray_tpu.ops.attention")


def _qkv(b=2, h=2, t_q=256, t_k=None, d=32, seed=0):
    rng = np.random.default_rng(seed)
    t_k = t_q if t_k is None else t_k
    q = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h, t_k, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t_k, d)).astype(np.float32)
    return q, k, v


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    got = fn_t(*map(torch.from_numpy, arrays), **kw)
    return np.asarray(want), got


@pytest.mark.parametrize("t_q,t_k", [(64, 64), (48, 80), (97, 97)])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(t_q, t_k, causal):
    want, got = _both(ja.mha_reference, ta.mha_reference,
                      _qkv(t_q=t_q, t_k=t_k), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("t_q,t_k", [(256, 256), (127, 127), (96, 192), (64, 131)])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_jax(t_q, t_k, causal):
    """Ragged lengths are padded and masked; block_k 64 forces several
    blocks and a padded last one."""
    want, got = _both(ja.blockwise_attention, ta.blockwise_attention,
                      _qkv(t_q=t_q, t_k=t_k, seed=1), causal=causal, block_k=64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("t_q,t_k", [(128, 128), (64, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(t_q, t_k, causal):
    want, got = _both(ja.full_attention, ta.full_attention,
                      _qkv(t_q=t_q, t_k=t_k, seed=2), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_causal_skip_matches_jax():
    want, got = _both(ja.causal_skip_attention, ta.causal_skip_attention,
                      _qkv(t_q=512, seed=3), block=128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("t", [192, 320, 96, 127, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_dispatch_on_cpu_matches_jax(t, causal):
    """CPU tensors keep the JAX dispatch (512 causal takes causal-skip)."""
    want, got = _both(ja.attention, ta.attention, _qkv(t_q=t, seed=4), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_attention_dispatch_long_seq_uses_blockwise(monkeypatch):
    q, k, v = _qkv(b=1, h=1, t_q=256, d=16, seed=5)
    monkeypatch.setattr(ta, "_MAX_MATERIALIZED_T", 128)  # the long-T path at test size
    got = ta.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    want = ja.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("t_q,t_k,d", [(256, 256, 32), (128, 256, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_matches_pallas_interpret(t_q, t_k, d, causal):
    """The kernel's contract, (out, lse), against the TPU kernel itself
    run in interpret mode at the shapes of the JAX package's kernel tests."""
    q, k, v = _qkv(t_q=t_q, t_k=t_k, d=d, seed=6)
    want_out, want_lse = ja._flash_forward(
        *map(jnp.asarray, (q, k, v)), causal=causal, scale=d ** -0.5,
        block_q=128, block_k=128, interpret=True)
    out, lse = ta.flash_attention_reference(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("t_q,t_k,causal", [(97, 131, True), (97, 131, False), (1, 64, True)])
def test_flash_on_cpu_tensor_is_the_plain_version(t_q, t_k, causal):
    """On the CPU the wrapper takes the plain version (ragged and
    rectangular lengths included) and launches nothing."""
    q, k, v = map(torch.from_numpy, _qkv(t_q=t_q, t_k=t_k, d=16, seed=7))
    before = _build.launches.get(ta.KERNEL, 0)
    out, lse = ta.flash_attention(q, k, v, causal)
    assert _build.launches.get(ta.KERNEL, 0) == before
    ref = ta.mha_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)
    s = (q @ k.transpose(-1, -2)) * 16 ** -0.5
    if causal:
        s = torch.where(torch.ones(t_q, t_k, dtype=torch.bool).tril(t_k - t_q), s, ta.NEG_INF)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=ATOL)


def test_flash_rejects_causal_with_more_queries_than_keys():
    q, k, v = map(torch.from_numpy, _qkv(t_q=64, t_k=32, d=16))
    with pytest.raises(ValueError, match="t_q <= t_k"):
        ta.flash_attention(q, k, v, True)


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 16, False), (torch.bfloat16, 32, False),
    (torch.float32, 64, False), (torch.float32, 128, False), (torch.float16, 64, False)])
def test_design_is_chosen_by_dtype_and_head_dim(dtype, d, tc):
    """bf16 at D 64 or 128 takes the tensor-core kernels; f32 (whose
    1e-5 tolerance TF32 would break) and the small head dims keep the
    CUDA-core ones.  The rule covers all three kernels, dK/dV included:
    each has its tensor-core counter."""
    assert ta.uses_tensor_cores(dtype, d) is tc
    assert ta.TENSOR_CORE_COUNTER == {ta.KERNEL: ta.FWD_TC, ta.DQ_KERNEL: ta.DQ_TC,
                                      ta.DKV_KERNEL: ta.DKV_TC}


@pytest.mark.parametrize("ptr,sizes,strides,why", [
    (1 << 20, (6, 12, 1024, 64), (2304 * 1024, 64, 2304, 1), None),   # GPT-2's fused qkv
    ((1 << 20) + 1536, (6, 12, 1024, 64), (2304 * 1024, 64, 2304, 1), None),  # its k view
    (1 << 20, (2, 12, 2048, 64), (12 * 2048 * 64, 2048 * 64, 64, 1), None),   # contiguous
    ((1 << 20) + 8, (2, 3, 40, 64), (3 * 40 * 68, 40 * 68, 68, 1), "base address"),
    (1 << 20, (2, 3, 40, 64), (3 * 40 * 68, 40 * 68, 68, 1), "time stride is 136"),
    (1 << 20, (2, 3, 40, 64), (3 * 40 * 64 + 4, 40 * 64, 64, 1), "batch stride"),
    (1 << 20, (2, 3, 40, 64), (3 * 40 * 64, 40 * 64 + 4, 64, 1), "head stride"),
    (1 << 20, (1, 1, 1, 64), (3, 5, 7, 1), None),                      # size-1 dims: unused
])
def test_tensor_core_alignment_rule(ptr, sizes, strides, why):
    """Every row of a tensor-core operand starts on a 16-byte boundary:
    the base pointer and each batch/head/time stride of a dim longer than
    1, in bf16 bytes."""
    got = ta.tensor_core_misalignment(ptr, sizes, strides)
    assert (got is None) if why is None else (why in got)


def test_misaligned_view_is_named_by_the_rule():
    """The view the card test feeds the kernel: D 64 with a unit stride,
    base 8 bytes off and a 136-byte time stride (CPU storage here)."""
    x = torch.zeros(2, 3, 40, 68, dtype=torch.bfloat16)[..., 4:]
    assert x.stride(-1) == 1 and x.shape[-1] == 64
    assert x.storage_offset() * x.element_size() == 8
    why = ta.tensor_core_misalignment(4096 + 8, x.shape, x.stride(), x.element_size())
    assert "base address is 8 bytes past" in why
    why = ta.tensor_core_misalignment(4096, x.shape, x.stride(), x.element_size())
    assert "time stride is 136 bytes" in why
