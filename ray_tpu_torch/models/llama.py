"""Llama-family decoder LM: RMSNorm, RoPE, SwiGLU and grouped-query
attention, for inference and training.

Counterpart of ``ray_tpu/models/llama.py``.  GQA shares each KV head
across ``n_heads // n_kv_heads`` query heads: query head ``h`` reads KV
head ``h // q_per_kv`` (``repeat_interleave`` on the head axis, as
``jnp.repeat`` does in the reference; its backward sums the repeated
heads' dK/dV into each KV head, as ``jnp.repeat``'s VJP does).  Training
uses GPT-2's AdamW recipe and the shared train step; each layer runs
under ``transformer.remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import make_optimizer, num_params  # same recipe
from ray_tpu_torch.models.transformer import (
    _attend,
    constrain_activations,
    layers,
    make_train_step_from_loss,
    remat,
    split_batch,
    train_state,
)
from ray_tpu_torch.ops.layers import cross_entropy_loss, rmsnorm, rope
from ray_tpu_torch.parallel.sharding import ShardingRules, logical_to_sharding

__all__ = ["LlamaConfig", "init", "apply", "loss_fn", "make_train_step",
           "init_state", "num_params", "logical_axes", "param_shardings",
           "make_optimizer"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 4
    d_model: int = 768
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_base: float = 10_000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "dots"  # as in TransformerConfig

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        return self.n_heads // self.n_kv_heads

    @staticmethod
    def llama_125m(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    d_model=64, d_ff=128, max_seq_len=128, remat=False)
        base.update(kw)
        return LlamaConfig(**base)


def init(cfg: LlamaConfig, generator: Optional[torch.Generator] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked f32 block params (every leaf has a leading [L] axis), drawn
    on the CPU from ``generator`` (seed 0 when None), then moved to
    ``device`` (the card when None)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    L, D, H, KV, hd, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)

    def dense(n_in, n_out, scale=1.0):
        return torch.randn(L, n_in, n_out, generator=g) * scale / n_in ** 0.5

    tok_emb = torch.randn(cfg.vocab_size, D, generator=g) * 0.02
    blocks = {
        "wq": dense(D, H * hd),
        "wk": dense(D, KV * hd),
        "wv": dense(D, KV * hd),
        "wo": dense(H * hd, D, scale=0.02),
        "w_gate": dense(D, Fd),
        "w_up": dense(D, Fd),
        "w_down": dense(Fd, D, scale=0.02),
        "attn_norm": torch.ones(L, D),
        "ffn_norm": torch.ones(L, D),
    }
    return {
        "tok_emb": tok_emb.to(dev),
        "blocks": {k: v.to(dev) for k, v in blocks.items()},
        "final_norm": torch.ones(D, device=dev),
    }


def logical_axes(cfg: Optional[LlamaConfig] = None) -> Dict[str, Any]:
    return {
        "tok_emb": ("vocab", "embed"),
        "blocks": {
            "wq": (None, "embed", "heads"),
            "wk": (None, "embed", "heads"),
            "wv": (None, "embed", "heads"),
            "wo": (None, "heads", "embed"),
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
            "attn_norm": (None, "embed"),
            "ffn_norm": (None, "embed"),
        },
        "final_norm": ("embed",),
    }


def param_shardings(mesh, rules: ShardingRules, cfg: Optional[LlamaConfig] = None):
    """The DTensor placements of every leaf (see ``parallel.shard_params``)."""
    return logical_to_sharding(logical_axes(cfg), mesh, rules)


def _block(x, p, cfg: LlamaConfig, positions):
    x = constrain_activations(x)
    B, T, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    h = rmsnorm(x, p["attn_norm"].to(dt), eps=cfg.rms_eps)
    q = (h @ p["wq"].to(dt)).reshape(B, T, H, hd).transpose(1, 2)
    k = (h @ p["wk"].to(dt)).reshape(B, T, KV, hd).transpose(1, 2)
    v = (h @ p["wv"].to(dt)).reshape(B, T, KV, hd).transpose(1, 2)
    q = rope(q, positions, base=cfg.rope_base)  # [B, H, T, hd]
    k = rope(k, positions, base=cfg.rope_base)  # [B, KV, T, hd]
    if KV != H:
        k = k.repeat_interleave(cfg.q_per_kv, dim=1)
        v = v.repeat_interleave(cfg.q_per_kv, dim=1)
    o = _attend(q, k, v, causal=True)  # per rank on DTensors (ring over sp)
    o = o.transpose(1, 2).reshape(B, T, H * hd)
    x = x + o @ p["wo"].to(dt)
    h = rmsnorm(x, p["ffn_norm"].to(dt), eps=cfg.rms_eps)
    gated = F.silu(h @ p["w_gate"].to(dt)) * (h @ p["w_up"].to(dt))
    return x + gated @ p["w_down"].to(dt)


def apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig
          ) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, V] f32 (tied embeddings)."""
    B, T = tokens.shape
    x = params["tok_emb"][tokens].to(cfg.dtype)
    positions = torch.arange(T, device=tokens.device)
    body = remat(lambda h, p: _block(h, p, cfg, positions), cfg)
    for p in layers(params["blocks"]):
        x = body(x, p)
    x = rmsnorm(x, params["final_norm"].to(cfg.dtype), eps=cfg.rms_eps)
    return (x @ params["tok_emb"].T.to(cfg.dtype)).float()


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: LlamaConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy; batch as ``gpt2.loss_fn`` takes it.  A
    sharded step passes its ``mesh``; the stack does not pipeline, so the
    DTensors' own layouts are all it reads."""
    inputs, targets = split_batch(batch)
    return cross_entropy_loss(apply(params, inputs, cfg), targets)


def make_train_step(cfg: LlamaConfig, optimizer, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``, in place."""
    return make_train_step_from_loss(loss_fn, cfg, optimizer, mesh)


def init_state(cfg: LlamaConfig, generator: Optional[torch.Generator], optimizer,
               *, device: DeviceLike = None) -> Dict[str, Any]:
    """The train state at step 0 over f32 params from :func:`init`, on the
    card when ``device`` is None."""
    return train_state(init(cfg, generator, device=device), optimizer)
