"""Operations and bytes that the shapes need, and the card's peaks.

The counts depend only on the shapes, so they stay the same work whatever
later implements it.  A matrix product of [m, k] by [k, n] is 2 m k n
operations; attention counts only the (query, key) pairs a mask keeps
(T (T + 1) / 2 a causal row block); each input byte is read once and
each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(kind: str) -> Optional[Dict[str, float]]:
    """The card's peaks by its name, None for a card not in the table."""
    return PEAKS.get(kind)


def attn_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs one head of one sequence computes."""
    if not causal:
        return tq * tk
    if tq != tk:
        raise ValueError("a causal count here takes a square block")
    return tq * (tq + 1) // 2


def dense_flops_per_token(d: Dict[str, int], head: bool = True) -> int:
    """The block products (qkv, output, two FFN) of every layer, and the
    tied LM head where ``head``, for one token's forward."""
    D, Fd, L = d["d_model"], d["d_ff"], d["n_layers"]
    per_layer = 2 * D * 3 * D + 2 * D * D + 2 * 2 * D * Fd
    return L * per_layer + (2 * D * d["vocab_size"] if head else 0)


def decode_token_flops(d: Dict[str, int], context: int) -> int:
    """One generated token's forward with ``context`` positions in the
    cache (itself included)."""
    return dense_flops_per_token(d) + d["n_layers"] * 4 * d["d_model"] * context


def prefill_flops(d: Dict[str, int], prompt: int) -> int:
    """A prompt's forward, causal, with the head on its last position."""
    return (dense_flops_per_token(d, head=False) * prompt + 2 * d["d_model"] * d["vocab_size"]
            + d["n_layers"] * 4 * d["d_model"] * attn_pairs(prompt, prompt, True))


def train_step_flops(d: Dict[str, int], batch: int, seq: int) -> int:
    """A training step's model operations: three times the forward (the
    backward is two), recomputation not credited."""
    fwd = (dense_flops_per_token(d) * seq
           + d["n_layers"] * 4 * d["d_model"] * attn_pairs(seq, seq, True))
    return 3 * batch * fwd


def encoder_flops(d: Dict[str, int], batch: int, seq: int, n_classes: int) -> int:
    """A BERT forward of ``batch`` sequences, non-causal, with its pooler
    and classifier on [CLS]."""
    D = d["d_model"]
    per_seq = (dense_flops_per_token(d, head=False) * seq
               + d["n_layers"] * 4 * D * attn_pairs(seq, seq, False)
               + 2 * D * D + 2 * D * n_classes)
    return batch * per_seq


def flash_cost(kernel: str, batch: int, heads: int, tq: int, tk: int, dh: int,
               causal: bool, elem_bytes: int = 2) -> Dict[str, int]:
    """Operations and bytes of one flash kernel's launch.

    - ``fwd``: S = Q K^T and O = P V; reads q, k, v, writes o and the f32
      log-sum-exp;
    - ``dq``: S, dP = dO V^T, dQ = dS K; reads q, k, v, do, lse and the
      f32 row sums of dO O, writes dq;
    - ``dkv``: S, dP, dV = P^T dO, dK = dS^T Q; reads the same, writes dk
      and dv.
    The backward's least work is five products, not the kernels' seven
    (each recomputes S and dP): ``dq`` is given two and ``dkv`` three,
    so their sum is the backward's least."""
    bh = batch * heads
    pair_flops = 2 * dh * attn_pairs(tq, tk, causal) * bh
    q_bytes, kv_bytes = bh * tq * dh * elem_bytes, bh * tk * dh * elem_bytes
    rows_f32 = bh * tq * 4
    if kernel == "fwd":
        return {"flops": 2 * pair_flops, "bytes": q_bytes + 2 * kv_bytes + q_bytes + rows_f32}
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * rows_f32  # q, do, k, v, lse, delta
    if kernel == "dq":
        return {"flops": 2 * pair_flops, "bytes": reads + q_bytes}
    if kernel == "dkv":
        return {"flops": 3 * pair_flops, "bytes": reads + 2 * kv_bytes}
    raise ValueError(f"unknown flash kernel {kernel!r}")


def least_seconds(cost: Dict[str, int], kind: str) -> float:
    """The roofline: the larger of operations over the peak rate and bytes
    over the peak bandwidth."""
    p = PEAKS[kind]
    return max(cost["flops"] / p["bf16_flops"], cost["bytes"] / p["hbm_bytes"])
