"""BERT-style bidirectional encoder classifier (BASELINE config 5).

Counterpart of ``ray_tpu/models/bert.py``: sequence classification with a
pooled [CLS] head over the shared stacked-layer core, non-causal and
post-LN.  The embedding sum and its norm, the pooler and the classifier
read their params in f32, as the JAX package's do; the blocks run in
``cfg.dtype``.  :func:`from_hf` loads a Hugging Face BERT checkpoint from a
local directory into this layout (it needs ``transformers``, which it
imports only when called).

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
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_stack,
    block_logical_axes,
    init_block_params,
)
from ray_tpu_torch.ops.layers import layernorm
from ray_tpu_torch.parallel.sharding import ShardingRules, logical_to_sharding


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


def logical_axes(cfg: Optional[BertConfig] = None) -> Dict[str, Any]:
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "wtype": (None, "embed"),
        "ln_emb_w": ("embed",), "ln_emb_b": ("embed",),
        "blocks": block_logical_axes(cfg.n_experts if cfg else 0),
        "pool_w": ("embed", "embed"),
        "pool_b": ("embed",),
        "cls_w": ("embed", None),
        "cls_b": (None,),
    }


def param_shardings(mesh, rules: ShardingRules, cfg: Optional[BertConfig] = None):
    """The DTensor placements of every leaf (see ``parallel.shard_params``)."""
    return logical_to_sharding(logical_axes(cfg), mesh, rules)


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
          token_types: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> class logits [B, num_classes] (f32); ``mesh``
    as ``gpt2.apply`` takes it."""
    B, T = tokens.shape
    if T > cfg.max_seq_len:
        raise ValueError(f"sequence length {T} exceeds max_seq_len {cfg.max_seq_len}")
    x = params["wte"][tokens] + params["wpe"][:T]
    if token_types is not None:
        x = x + params["wtype"][token_types]
    x = layernorm(x, params["ln_emb_w"], params["ln_emb_b"]).to(cfg.dtype)
    x, _ = apply_stack(x, params["blocks"], cfg, mesh)
    cls = torch.tanh(x[:, 0].float() @ params["pool_w"] + params["pool_b"])
    return cls @ params["cls_w"] + params["cls_b"]


def from_hf(model_name: str = "bert-base-uncased", num_classes: int = 2, *,
            device: DeviceLike = None):
    """``(cfg, params)`` from a Hugging Face BERT checkpoint (a local
    directory or a name already in the local cache: ``local_files_only``,
    so there is no download), as the JAX
    package's ``from_hf`` lays them out: query, key and value stacked side
    by side into ``wqkv``, weights transposed to ``(in, out)``, and a
    classifier of zeros.  Like the reference it builds ``BertConfig``'s
    12 x 768 stack and reads only the vocabulary size from the checkpoint.
    The blocks' tanh GELU and LayerNorm eps 1e-5 are the port's, not HF's
    erf GELU and 1e-12, so the outputs are not HF's own.  Params are f32
    on ``device`` (the card when None)."""
    dev = resolve_device(device)
    from transformers import AutoModel

    hf = AutoModel.from_pretrained(model_name, local_files_only=True)
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    cfg = BertConfig(num_classes=num_classes,
                     vocab_size=sd["embeddings.word_embeddings.weight"].shape[0])
    L, D = cfg.n_layers, cfg.d_model

    def stack(fmt: str, t: bool = False) -> torch.Tensor:
        return torch.stack([sd[fmt.format(i)].T if t else sd[fmt.format(i)]
                            for i in range(L)])

    attn = "encoder.layer.{}.attention."
    params = {
        "wte": sd["embeddings.word_embeddings.weight"],
        "wpe": sd["embeddings.position_embeddings.weight"],
        "wtype": sd["embeddings.token_type_embeddings.weight"],
        "ln_emb_w": sd["embeddings.LayerNorm.weight"],
        "ln_emb_b": sd["embeddings.LayerNorm.bias"],
        "blocks": {
            "ln1_w": stack(attn + "output.LayerNorm.weight"),
            "ln1_b": stack(attn + "output.LayerNorm.bias"),
            "wqkv": torch.cat([stack(attn + f"self.{n}.weight", t=True)
                               for n in ("query", "key", "value")], dim=-1),
            "bqkv": torch.cat([stack(attn + f"self.{n}.bias")
                               for n in ("query", "key", "value")], dim=-1),
            "wo": stack(attn + "output.dense.weight", t=True),
            "bo": stack(attn + "output.dense.bias"),
            "ln2_w": stack("encoder.layer.{}.output.LayerNorm.weight"),
            "ln2_b": stack("encoder.layer.{}.output.LayerNorm.bias"),
            "w1": stack("encoder.layer.{}.intermediate.dense.weight", t=True),
            "b1": stack("encoder.layer.{}.intermediate.dense.bias"),
            "w2": stack("encoder.layer.{}.output.dense.weight", t=True),
            "b2": stack("encoder.layer.{}.output.dense.bias"),
        },
        "pool_w": sd["pooler.dense.weight"].T,
        "pool_b": sd["pooler.dense.bias"],
        "cls_w": torch.zeros(D, num_classes),
        "cls_b": torch.zeros(num_classes),
    }
    return cfg, {k: ({n: t.contiguous().to(dev) for n, t in v.items()} if isinstance(v, dict)
                     else v.contiguous().to(dev)) for k, v in params.items()}
