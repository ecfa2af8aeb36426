"""Analytical FLOPs and MFU, the port's copy of ``ray_tpu/util/flops.py``.

The formulas are the JAX package's, so the port's MFU and the JAX
package's are the same arithmetic: ``transformer_flops_per_token`` counts
model FLOPs only (``6N`` for the matrix products forward and backward plus
``12·L·D·T`` for attention; remat's recomputation is never credited).

The peak table is the card's own, keyed on ``torch.cuda.get_device_name()``.
A kind the table does not know raises: an MFU over a guessed peak is no
measurement.
"""

from __future__ import annotations

from typing import Any

# dense bf16 tensor-core peak FLOP/s, from NVIDIA's data sheet ("H100 80GB
# HBM3" is the name the H100 SXM reports)
PEAK_FLOPS_BF16 = {
    "H100 80GB HBM3": 989e12,
}


def peak_flops(device_kind: str) -> float:
    """bf16 peak FLOP/s for a device name (``torch.cuda.get_device_name()``);
    raises ``KeyError`` for a name the table does not know."""
    for key, peak in PEAK_FLOPS_BF16.items():
        if key in (device_kind or ""):
            return peak
    raise KeyError(f"no bf16 peak known for device {device_kind!r}; "
                   f"known: {sorted(PEAK_FLOPS_BF16)}")


def transformer_flops_per_token(n_params: int, n_layers: int,
                                d_model: int, seq_len: int) -> float:
    """Training FLOPs per token of a decoder transformer: ``6N`` matmul
    (forward 2N + backward 4N) + ``12·L·D·T`` attention."""
    return 6.0 * n_params + 12.0 * n_layers * d_model * seq_len


def model_flops_per_token(cfg: Any, n_params: int) -> float:
    """``transformer_flops_per_token`` off a model config (anything with
    ``n_layers``, ``d_model`` and ``max_seq_len``)."""
    return transformer_flops_per_token(
        int(n_params), int(cfg.n_layers), int(cfg.d_model), int(cfg.max_seq_len))


def mfu(tokens_per_sec: float, flops_per_token: float, device_kind: str) -> float:
    """Model FLOPs utilization: model FLOP/s over the card's bf16 peak."""
    return tokens_per_sec * flops_per_token / peak_flops(device_kind)
