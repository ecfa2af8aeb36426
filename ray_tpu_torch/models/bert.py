"""BERT-style bidirectional encoder classifier (BASELINE config 5).

Counterpart of ``ray_tpu/models/bert.py``: sequence classification with a
pooled [CLS] head over the shared stacked-layer core, non-causal and
post-LN.  The embedding sum and its norm, the pooler and the classifier
read their params in f32, as the JAX package's do; the blocks run in
``cfg.dtype``.  ``from_hf`` (loading ``bert-base-uncased`` through
``transformers``) is not ported: it needs a local checkpoint and
``transformers``, and the port runs on random weights from a seed.

Token ids that index past the embedding tables are a device-side assert on
the card, which ends the process; :func:`check_tokens` checks a numpy
batch on the host, where it arrives, before it is moved to the card.
:func:`apply` reads nothing back from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, apply_stack, init_block_params
from ray_tpu_torch.ops.layers import layernorm


@dataclasses.dataclass(frozen=True)
class BertConfig(TransformerConfig):
    vocab_size: int = 30592  # 30522 padded to a multiple of 128
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 512
    causal: bool = False
    post_ln: bool = True  # original BERT's order
    num_classes: int = 2
    type_vocab_size: int = 2

    @staticmethod
    def base(**kw) -> "BertConfig":
        """BERT-base (any field overridable)."""
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """Test sized (any field overridable)."""
        base = dict(vocab_size=512, n_layers=2, n_heads=4, d_model=64, d_ff=256,
                    max_seq_len=128, remat=False)
        base.update(kw)
        return BertConfig(**base)


def init(cfg: BertConfig, generator: Optional[torch.Generator] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """f32 params drawn on the CPU from ``generator`` (seed 0 when None),
    then moved to ``device`` (the card when None)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    D = cfg.d_model

    def normal(*shape):
        return torch.randn(shape, generator=g) * 0.02

    p = {
        "wte": normal(cfg.vocab_size, D),
        "wpe": normal(cfg.max_seq_len, D),
        "wtype": normal(cfg.type_vocab_size, D),
        "ln_emb_w": torch.ones(D), "ln_emb_b": torch.zeros(D),
        "blocks": init_block_params(cfg, g, "cpu"),
        "pool_w": normal(D, D), "pool_b": torch.zeros(D),
        "cls_w": normal(D, cfg.num_classes), "cls_b": torch.zeros(cfg.num_classes),
    }
    return {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
            for k, v in p.items()}


def check_tokens(tokens: np.ndarray, cfg: BertConfig,
                 token_types: Optional[np.ndarray] = None) -> None:
    """Raise ``ValueError`` unless ``tokens`` ``[B, T]`` (and ``token_types``)
    are ids the embedding tables hold and T fits ``max_seq_len``.  On the
    host, on numpy: the card would assert instead."""
    for name, ids, n in (("token", tokens, cfg.vocab_size),
                         ("token type", token_types, cfg.type_vocab_size)):
        if ids is None:
            continue
        ids = np.asarray(ids)
        if ids.ndim != 2 or ids.shape[1] > cfg.max_seq_len:
            raise ValueError(f"{name} ids of shape {ids.shape}: want [B, T] "
                             f"with T <= max_seq_len {cfg.max_seq_len}")
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"{name} id outside [0, {n})")


def apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: BertConfig,
          token_types: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, T] int -> class logits [B, num_classes] (f32)."""
    B, T = tokens.shape
    if T > cfg.max_seq_len:
        raise ValueError(f"sequence length {T} exceeds max_seq_len {cfg.max_seq_len}")
    x = params["wte"][tokens] + params["wpe"][:T]
    if token_types is not None:
        x = x + params["wtype"][token_types]
    x = layernorm(x, params["ln_emb_w"], params["ln_emb_b"]).to(cfg.dtype)
    x, _ = apply_stack(x, params["blocks"], cfg)
    cls = torch.tanh(x[:, 0].float() @ params["pool_w"] + params["pool_b"])
    return cls @ params["cls_w"] + params["cls_b"]
