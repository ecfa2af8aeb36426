"""Attention with one contract — ``[B, H, T, D]`` q/k/v — in PyTorch.

Counterpart of ``ray_tpu/ops/attention.py``.  :func:`attention` dispatches
by the tensors' device:

- a CUDA tensor goes to :func:`flash_attn`, the counterpart of
  ``flash_attention_tpu``: the hand-written flash-attention forward kernel
  (``csrc/flash_fwd.cu``, the port of ``_flash_kernel``) under a
  ``torch.autograd.Function`` whose backward launches the two hand-written
  backward kernels (``csrc/flash_bwd.cu``, the ports of ``_flash_dq_kernel``
  and ``_flash_dkv_kernel``).  Flash attention is the ordinary design on a
  GPU at every length, for prefill and for training.  Each of the three
  kernels has two designs, chosen by :func:`uses_tensor_cores` from the
  dtype and head dim alone: bf16 at D 64 or 128 runs on the tensor cores
  (wgmma), everything else on the CUDA cores in f32.
- a CPU tensor keeps the JAX package's rules, so the CPU tests compare
  like with like: :func:`causal_skip_attention` or :func:`full_attention`
  up to ``_MAX_MATERIALIZED_T``, :func:`blockwise_attention` above it.

Decoding takes another entry, :func:`decode_attention`: one query row a
slot against that slot's KV cache, dispatched by device in the same way.
A CUDA tensor launches the hand-written ``decode_attend`` kernel
(``csrc/decode_attend.cu``), which reads the cache in its own dtype in
place, and only up to each slot's position; it replaces no TPU kernel (the
JAX package decodes with XLA einsums).  A CPU tensor takes its plain
version, :func:`decode_attention_reference`, those einsums.

The causal diagonal is aligned bottom-right (``q_offset = t_k - t_q``)
everywhere.  Masked scores are ``NEG_INF = -1e30``, not ``-inf``, as in
the reference.  :func:`mha_reference` is the naive ground truth and is not
in the dispatch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

# The CPU dispatch keeps the JAX package's limit; it is a TPU-measured
# figure and says nothing about the card, where the kernel takes every T.
_MAX_MATERIALIZED_T = 4096


def _causal_mask(t_q: int, t_k: int, device) -> torch.Tensor:
    return torch.ones(t_q, t_k, dtype=torch.bool, device=device).tril(t_k - t_q)


def mha_reference(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(T²) attention, the numerical ground truth."""
    *_, t_q, d = q.shape
    t_k = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if causal:
        s = torch.where(_causal_mask(t_q, t_k, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


def _block_update(carry, s, v_blk):
    """One online-softmax step: fold scores ``s`` (f32, [..., q, kb]) and
    values ``v_blk`` into the running (out, max, denom)."""
    o, m, l = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + p @ v_blk.float()
    return o_new, m_new, l_new


def blockwise_attention(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention as a loop over k/v blocks: O(block) memory
    per step, any length (a ragged last block is padded and its keys
    masked), correct when ``t_k != t_q``."""
    *_, t_q, d = q.shape
    t_k = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    block_k = min(block_k, t_k)
    pad = (-t_k) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    n_blocks = (t_k + pad) // block_k

    qf = q.float() * scale
    q_pos = torch.arange(t_q, device=q.device) + (t_k - t_q)
    o = torch.zeros(*q.shape[:-1], d, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    for idx in range(n_blocks):
        sl = slice(idx * block_k, (idx + 1) * block_k)
        k_blk, v_blk = k[..., sl, :], v[..., sl, :]
        s = qf @ k_blk.float().transpose(-1, -2)
        k_pos = idx * block_k + torch.arange(block_k, device=q.device)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if pad:
            valid = (k_pos < t_k)[None, :]
            mask = valid if mask is None else mask & valid
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        o, m, l = _block_update((o, m, l), s, v_blk)
    return (o / l[..., None]).to(q.dtype)


def _scores(q, k, scale: float) -> torch.Tensor:
    """Q·Kᵀ with f32 accumulation (bf16 products are exact in f32)."""
    return (q.float() @ k.float().transpose(-1, -2)) * scale


def _weighted_values(p, v) -> torch.Tensor:
    """softmax(P)·V with P cast to V's dtype, output in V's dtype."""
    return p.to(v.dtype) @ v


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Materialized-scores attention: f32 scores and softmax, P·V in the
    input dtype."""
    *_, t_q, d = q.shape
    t_k = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, scale)
    if causal:
        s = torch.where(_causal_mask(t_q, t_k, q.device), s, NEG_INF)
    return _weighted_values(torch.softmax(s, dim=-1), v)


def causal_skip_attention(q, k, v, *, scale: Optional[float] = None,
                          block: int = 256) -> torch.Tensor:
    """Causal attention that skips fully masked key blocks: q block ``i``
    contracts only keys ``[0:(i+1)*block]``.  Requires ``t_q == t_k``
    divisible by ``block``."""
    *_, t, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    outs = []
    for i in range(t // block):
        qi = q[..., i * block:(i + 1) * block, :]
        kv_len = (i + 1) * block
        q_pos = i * block + torch.arange(block, device=q.device)
        mask = q_pos[:, None] >= torch.arange(kv_len, device=q.device)[None, :]
        s = torch.where(mask, _scores(qi, k[..., :kv_len, :], scale), NEG_INF)
        outs.append(_weighted_values(torch.softmax(s, dim=-1), v[..., :kv_len, :]))
    return torch.cat(outs, dim=-2)


# ---------------------------------------------------------------------------
# flash-attention forward: the hand-written kernel and its plain version
# ---------------------------------------------------------------------------

KERNEL = "flash_fwd"
FWD_TC = "flash_fwd_tc"         # the launches of KERNEL that ran the tensor-core design
_HEAD_DIMS = (16, 32, 64, 128)
_TC_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def uses_tensor_cores(dtype: torch.dtype, d: int) -> bool:
    """Which design ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
    launch, by dtype and head dim only (``csrc/flash_fwd.cu`` and
    ``csrc/flash_bwd.cu`` apply the same rule): bf16 at D 64 or 128 takes
    the tensor-core kernels (wgmma on bf16 tiles in shared memory, f32
    accumulation); f32 at any D and bf16 at D 16 or 32 take the CUDA-core
    kernels (f32 arithmetic; TF32 would round f32 inputs to 10 mantissa
    bits)."""
    return dtype == torch.bfloat16 and d in _TC_HEAD_DIMS


def tensor_core_misalignment(data_ptr: int, sizes, strides, itemsize: int = 2
                             ) -> Optional[str]:
    """Why a ``[B, H, T, D]`` operand cannot go to the tensor-core kernels,
    or None when it can.  They copy 16-byte chunks of each row with
    ``cp.async``, so every row has to start on a 16-byte boundary: the base
    pointer, and the batch, head and time strides (in elements, scaled by
    ``itemsize``) of every dim longer than 1 (a size-1 dim's stride is never
    multiplied by a nonzero index)."""
    if data_ptr % 16:
        return f"its base address is {data_ptr % 16} bytes past a 16-byte boundary"
    for name, size, stride in zip(("batch", "head", "time"), sizes[:3], strides[:3]):
        if size > 1 and (stride * itemsize) % 16:
            return f"its {name} stride is {stride * itemsize} bytes, not a multiple of 16"
    return None


def _check_tensor_core_rows(fn: str, **ts: torch.Tensor) -> None:
    """Raises ``ValueError`` for an operand the tensor-core design cannot
    take; it never copies it or reroutes it to the other design."""
    for name, t in ts.items():
        why = tensor_core_misalignment(t.data_ptr(), t.shape, t.stride(), t.element_size())
        if why is not None:
            raise ValueError(f"{fn}: bf16 {name} with head dim {t.shape[-1]} runs on the "
                             f"tensor-core kernel, which needs 16-byte aligned rows, but {why}")


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel, with materialized scores:
    ``(out [B,H,Tq,D] in q's dtype, lse [B,H,Tq] f32)``."""
    *_, t_q, d = q.shape
    t_k = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    s = _scores(q, k, scale)
    if causal:
        s = torch.where(_causal_mask(t_q, t_k, q.device), s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = p.to(v.dtype).float() @ v.float()
    return out.to(q.dtype), lse


def _check_flash_args(q, k, v, causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, H, T, D] q, k and v")
    b, h, t_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if t_q == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention needs t_q > 0 and t_k > 0")
    if causal and t_q > k.shape[2]:
        # bottom-right alignment would leave the first rows no visible key
        raise ValueError(f"causal flash_attention needs t_q <= t_k, got "
                         f"({t_q}, {k.shape[2]})")


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(out [B,H,Tq,D] in q's dtype, lse
    [B,H,Tq] f32)``, the contract of the TPU kernel's ``_flash_forward``
    for any ``t_q`` and ``t_k``.

    A CUDA tensor launches the kernel (bf16 or f32, D in 16/32/64/128; q,
    k and v may be strided views with a unit stride on D) or raises; the
    design follows :func:`uses_tensor_cores`, and the tensor-core one
    raises ``ValueError`` unless every row of q, k and v starts on a
    16-byte boundary (:func:`tensor_core_misalignment`).  A CPU tensor
    takes :func:`flash_attention_reference`.  No gradient flows through
    this function itself: :func:`flash_attn` is the differentiable entry
    point.  Counts one launch of ``KERNEL``, and one of ``FWD_TC`` too
    when the tensor-core design ran."""
    _check_flash_args(q, k, v, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _check_cuda_args("flash_attention", q, k, v)
    tc = uses_tensor_cores(q.dtype, q.shape[-1])
    if tc:
        _check_tensor_core_rows("flash_attention", q=q, k=k, v=v)
    b, h, t_q, d = q.shape
    lib = _flash_lib()
    out = torch.empty(b, h, t_q, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, t_q, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, t_q, k.shape[2], d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        scale, int(causal), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    _count_launch(KERNEL, tc)
    return out, lse


def _count_launch(kernel: str, tc: bool) -> None:
    """One launch of ``kernel``, and one on its ``TENSOR_CORE_COUNTER``
    too when the tensor-core design ran."""
    _build.count_launch(kernel)
    if tc:
        _build.count_launch(TENSOR_CORE_COUNTER[kernel])


def _check_cuda_args(fn: str, *ts: torch.Tensor) -> None:
    """What the CUDA kernels take: one CUDA device, one dtype of
    ``_DTYPE_CODE``, a head dim of ``_HEAD_DIMS``, a unit stride on it."""
    q = ts[0]
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{fn} needs its tensors on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{fn} takes float32 or bfloat16 tensors of one dtype, "
                         f"got {[t.dtype for t in ts]}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{fn} head dim {q.shape[-1]} not in {_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError(f"{fn} needs a unit stride on the head dim")


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _flash_lib():
    lib = _build.load(KERNEL)
    if not lib.flash_fwd.argtypes:
        lib.flash_fwd.argtypes = [_P] * 5 + [_I] * 5 + [_I64] * 9 + [
            ctypes.c_float, _I, _I, _P]
        lib.flash_fwd.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# flash-attention backward: the two hand-written kernels and their plain
# versions
# ---------------------------------------------------------------------------

BWD_SOURCE = "flash_bwd"        # csrc/flash_bwd.cu, one library, two kernels
DQ_KERNEL = "flash_bwd_dq"
DQ_TC = "flash_bwd_dq_tc"       # the launches of DQ_KERNEL that ran the tensor-core design
DKV_KERNEL = "flash_bwd_dkv"
DKV_TC = "flash_bwd_dkv_tc"     # the launches of DKV_KERNEL that ran the tensor-core design

# each kernel's count of the launches that ran its tensor-core design
TENSOR_CORE_COUNTER = {KERNEL: FWD_TC, DQ_KERNEL: DQ_TC, DKV_KERNEL: DKV_TC}


def _probs(q, k, lse, causal: bool, scale: float) -> torch.Tensor:
    """P = exp(scale·QKᵀ − LSE) in f32 with materialized scores; masked
    pairs at ``NEG_INF`` give P = 0, as in the kernels' contract."""
    s = _scores(q, k, scale)
    if causal:
        s = torch.where(_causal_mask(q.shape[-2], k.shape[-2], q.device), s, NEG_INF)
    return torch.exp(s - lse[..., None])


def _dscores(p, v, do, delta, scale: float) -> torch.Tensor:
    """dS = P ∘ (dO·Vᵀ − Δ) · scale, in f32."""
    dp = do.float() @ v.float().transpose(-1, -2)
    return p * (dp - delta[..., None]) * scale


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of ``flash_bwd_dq``: dQ = Σ_k dS·K, with dS rounded
    to K's dtype before the product (``_flash_dq_kernel``); dq in q's
    dtype.  ``lse`` and ``delta`` are f32 ``[B, H, Tq]``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ds = _dscores(_probs(q, k, lse, causal, scale), v, do, delta, scale)
    return (ds.to(k.dtype).float() @ k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``flash_bwd_dkv``: dV = Σ_q Pᵀ·dO with P rounded
    to dO's dtype, dK = Σ_q dSᵀ·Q with dS rounded to Q's dtype
    (``_flash_dkv_kernel``); dk and dv in k's and v's dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p = _probs(q, k, lse, causal, scale)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ do.float()
    ds = _dscores(p, v, do, delta, scale)
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_lib():
    lib = _build.load(BWD_SOURCE)
    if not lib.flash_bwd_dq.argtypes:
        tail = [_I] * 5 + [_I64] * 12 + [ctypes.c_float, _I, _I, _P]
        lib.flash_bwd_dq.argtypes = [_P] * 7 + tail
        lib.flash_bwd_dkv.argtypes = [_P] * 8 + tail
        lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = ctypes.c_int
    return lib


def _bwd_args(q, k, v, do, lse, delta, causal: bool):
    """Checks shared by the two backward kernels.  Returns the 12 element
    strides (batch, head, time of q, k, v, dO) the kernels take, or None
    for CPU tensors (the plain versions)."""
    _check_flash_args(q, k, v, causal)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError("lse and delta must be [B, H, Tq]")
    if q.device.type == "cpu":
        return None
    _check_cuda_args("flash attention backward", q, k, v, do)
    for t in (lse, delta):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError("lse and delta must be contiguous float32 on q's device")
    return [s for t in (q, k, v, do) for s in t.stride()[:3]]


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dQ of flash attention from the forward's ``lse`` and Δ =
    rowsum(dO∘O), the contract of ``_flash_dq_kernel``.  A CUDA tensor
    launches the kernel or raises, in the design :func:`uses_tensor_cores`
    picks (the tensor-core one needs 16-byte aligned rows of q, k, v and
    dO, as :func:`flash_attention` does); a CPU tensor takes
    :func:`flash_dq_reference`.  Counts one launch of ``DQ_KERNEL``, and
    one of ``DQ_TC`` too when the tensor-core design ran."""
    strides = _bwd_args(q, k, v, do, lse, delta, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if strides is None:
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    tc = uses_tensor_cores(q.dtype, q.shape[-1])
    if tc:
        _check_tensor_core_rows("flash_bwd_dq", q=q, k=k, v=v, do=do)
    b, h, t_q, d = q.shape
    dq = torch.empty(b, h, t_q, d, dtype=q.dtype, device=q.device)
    err = _bwd_lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, h, t_q, k.shape[2], d, *strides,
        scale, int(causal), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{DQ_KERNEL} launch failed: cudaError {err}")
    _count_launch(DQ_KERNEL, tc)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention, the contract of ``_flash_dkv_kernel``.
    A CUDA tensor launches the kernel or raises, in the design
    :func:`uses_tensor_cores` picks (the tensor-core one needs 16-byte
    aligned rows of q, k, v and dO); a CPU tensor takes
    :func:`flash_dkv_reference`.  Counts one launch of ``DKV_KERNEL``, and
    one of ``DKV_TC`` too when the tensor-core design ran."""
    strides = _bwd_args(q, k, v, do, lse, delta, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if strides is None:
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    tc = uses_tensor_cores(q.dtype, q.shape[-1])
    if tc:
        _check_tensor_core_rows("flash_bwd_dkv", q=q, k=k, v=v, do=do)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    dk = torch.empty(b, h, t_k, d, dtype=k.dtype, device=k.device)
    dv = torch.empty(b, h, t_k, d, dtype=v.dtype, device=v.device)
    err = _bwd_lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t_q, t_k, d, *strides,
        scale, int(causal), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{DKV_KERNEL} launch failed: cudaError {err}")
    _count_launch(DKV_KERNEL, tc)
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, do, causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention, the contract of ``_flash_backward``:
    Δ = rowsum(dO∘O) in f32 (one torch expression, as the JAX package
    leaves it to XLA), then dQ, then dK/dV.  A dO without a unit stride on
    D (an expanded gradient, say) is copied first; a strided view with one
    is taken as it is."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward, the counterpart of the
    ``custom_vjp`` of ``flash_attention_tpu``: the forward saves (q, k, v,
    out, lse) and the backward rebuilds P from the LSE, never from a saved
    score matrix.  Saved q, k and v stay the caller's (possibly strided)
    views.  On CUDA tensors both directions launch the hand-written
    kernels; on CPU tensors they take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attn(q, k, v, causal: bool = False,
               scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention, ``[B, H, T, D]`` q/k/v -> out in q's
    dtype: the counterpart of ``flash_attention_tpu``.  Both the forward
    and the backward run the hand-written kernels on CUDA tensors."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return FlashAttention.apply(q, k, v, causal, scale)


def attention(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """The models' single entry point.  CUDA tensors take
    :func:`flash_attn` (the flash kernels, forward and backward); CPU
    tensors take the JAX package's dispatch (materialized scores up to
    ``_MAX_MATERIALIZED_T``, causal-skip for long square block-divisible
    causal inputs, blockwise beyond), differentiated by autograd."""
    if q.device.type == "cuda":
        return flash_attn(q, k, v, causal, scale)
    t_q, t_k = q.shape[-2], k.shape[-2]
    if t_q <= _MAX_MATERIALIZED_T and t_k <= _MAX_MATERIALIZED_T:
        if causal and t_q == t_k and t_q % 256 == 0 and t_q >= 512:
            return causal_skip_attention(q, k, v, scale=scale, block=256)
        return full_attention(q, k, v, causal=causal, scale=scale)
    return blockwise_attention(q, k, v, causal=causal, scale=scale, block_k=128)


# ---------------------------------------------------------------------------
# decode attention: one query row a slot against its KV cache
# ---------------------------------------------------------------------------

DECODE_KERNEL = "decode_attend"
_DECODE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DECODE_MAX_GROUP = 8         # query heads per KV head one block serves


def decode_attention_reference(q, k_cache, v_cache, pos) -> torch.Tensor:
    """The plain version of the kernel: q ``[B, H, 1, dh]`` against the
    full cache ``[B, KV, S, dh]`` with a per-slot length mask ``j <= pos``;
    returns f32 ``[B, H, 1, dh]``.  GQA folds the query heads onto their KV
    head by reshape.  Scores and the P·V product are f32 over the cache's
    values (bf16 products are exact in f32), as the reference's
    f32-accumulating einsums are; the weights are rounded to the cache's
    dtype before P·V, as there."""
    B, H, _, dh = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    q = q.reshape(B, KV, H // KV, dh)
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(), k_cache.float()) / (dh ** 0.5)
    mask = torch.arange(S, device=q.device)[None, None, None, :] <= pos[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, H, 1, dh)


def _check_decode_shapes(q, k_cache, v_cache, pos) -> None:
    qs, ks = q.shape, k_cache.shape
    if len(qs) != 4 or qs[2] != 1 or len(ks) != 4 or v_cache.shape != ks:
        raise ValueError(f"decode_attention takes q [B, H, 1, dh] and caches [B, KV, S, dh], "
                         f"got q {tuple(qs)}, k {tuple(ks)}, v {tuple(v_cache.shape)}")
    if ks[0] != qs[0] or ks[3] != qs[3] or pos.shape != (qs[0],) or qs[1] % ks[1]:
        raise ValueError(f"decode_attention shapes disagree: q {tuple(qs)}, "
                         f"caches {tuple(ks)}, pos {tuple(pos.shape)}")


def _check_decode_cuda_args(q, k_cache, v_cache, pos):
    """Raises ``ValueError`` for what ``decode_attend`` does not take;
    returns the card's index and the caches' strides.  Called once a layer
    a decode step, while the card waits for the host: every check reads
    each property once."""
    dev = q.get_device()
    if not k_cache.get_device() == v_cache.get_device() == pos.get_device() == dev:
        raise ValueError("decode_attention needs its tensors on one CUDA device")
    dtype = q.dtype
    if dtype not in _DECODE_DTYPE_CODE or k_cache.dtype != dtype or v_cache.dtype != dtype:
        raise ValueError(f"decode_attention takes float32, bfloat16 or float16 q and caches of "
                         f"one dtype, got {dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if pos.dtype != torch.int64 or pos.stride(0) != 1:
        raise ValueError("decode_attention takes pos as a unit-stride int64 [B]")
    h, d, kv = q.shape[1], q.shape[3], k_cache.shape[1]
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"decode_attention head dim {d} is not a multiple of 8 up to 256")
    if h // kv > _DECODE_MAX_GROUP:
        raise ValueError(f"decode_attention serves 1 to {_DECODE_MAX_GROUP} query heads per "
                         f"KV head, got {h} query heads on {kv}")
    kst, vst = k_cache.stride(), v_cache.stride()
    if q.stride(3) != 1 or kst[3] != 1 or vst[3] != 1:
        raise ValueError("decode_attention needs a unit stride on the head dim")
    elt = k_cache.element_size()
    if ((k_cache.data_ptr() | v_cache.data_ptr()) % 16
            or any(st * elt % 16 for st in kst[:3] + vst[:3])):
        for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
            why = tensor_core_misalignment(t.data_ptr(), t.shape, t.stride(), elt)
            if why is not None:
                raise ValueError(f"decode_attention reads 16-byte chunks of each {name} row, "
                                 f"but {why}")
    return dev, kst, vst


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One decode step's attention: ``q [B, H, 1, dh]`` of each slot
    against its own cache ``k_cache``/``v_cache [B, KV, S, dh]`` over the
    positions ``0..pos[b]`` (``pos`` int64 ``[B]``), query head ``h`` on KV
    head ``h // (H // KV)``.  Returns ``[B, 1, H·dh]``, the heads merged as
    the output projection takes them, in the cache's dtype, rounded once
    from f32.

    A CUDA tensor launches the ``decode_attend`` kernel: the cache is read
    in its own dtype in place, never copied or upcast, and never past
    ``pos[b]``; scores, softmax, P and P·V are float32.  ``pos`` is read on
    the card, so nothing waits for the device.  The kernel takes float32,
    bfloat16 and float16 caches, head dims that are a multiple of 8 up to
    256, 1 to 8 query heads per KV head, ``q`` as any view with a unit
    stride on dh, caches whose rows start on 16-byte boundaries; anything
    else raises ``ValueError``.  Counts one launch of ``DECODE_KERNEL``.  A
    CPU tensor takes :func:`decode_attention_reference`."""
    _check_decode_shapes(q, k_cache, v_cache, pos)
    b, h, _, d = q.shape
    if q.device.type == "cpu":
        out = decode_attention_reference(q, k_cache, v_cache, pos)
        return out.transpose(1, 2).reshape(b, 1, h * d).to(k_cache.dtype)
    dev, kst, vst = _check_decode_cuda_args(q, k_cache, v_cache, pos)
    _, kv, s, _ = k_cache.shape
    out = torch.empty(b, 1, h * d, dtype=q.dtype, device=q.device)
    qst = q.stride()
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object, ~11 us a call on an H100's host, once a layer
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = _decode_lib().decode_attend(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, kv, s, d, qst[0], qst[1], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
        d ** -0.5, _DECODE_DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{DECODE_KERNEL} launch failed: cudaError {err}")
    _build.count_launch(DECODE_KERNEL)
    return out


def _decode_lib():
    lib = _build.load(DECODE_KERNEL)
    if not lib.decode_attend.argtypes:
        lib.decode_attend.argtypes = [_P] * 5 + [_I] * 5 + [_I64] * 8 + [
            ctypes.c_float, _I, _P]
        lib.decode_attend.restype = ctypes.c_int
    return lib
