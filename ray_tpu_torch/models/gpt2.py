"""GPT-2: the flagship decoder LM (GPT-2 125M), for inference and training.

Counterpart of ``ray_tpu/models/gpt2.py``: the config, ``init``, the
forward ``apply`` with the tied LM head in f32, the next-token loss (plus
``moe_aux_weight`` times the load-balance loss with experts), the
AdamW recipe (:func:`make_optimizer`, the port's own copy of the optax
chain the JAX package builds), ``make_train_step`` and ``init_state``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_stack,
    init_block_params,
    make_train_step_from_loss,
    named_leaves,
    split_batch,
    train_state,
)
from ray_tpu_torch.ops.layers import cross_entropy_loss, layernorm


@dataclasses.dataclass(frozen=True)
class GPT2Config(TransformerConfig):
    causal: bool = True

    @staticmethod
    def gpt2_small(**kw) -> "GPT2Config":
        """The 124M-parameter headline model (any field overridable)."""
        base = dict(vocab_size=50304, n_layers=12, n_heads=12, d_model=768,
                    d_ff=3072, max_seq_len=1024)
        base.update(kw)
        return GPT2Config(**base)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """Test sized (any field overridable)."""
        base = dict(vocab_size=512, n_layers=2, n_heads=4, d_model=64,
                    d_ff=256, max_seq_len=128, remat=False)
        base.update(kw)
        return GPT2Config(**base)


def init(cfg: GPT2Config, generator: Optional[torch.Generator] = None, *,
         device: DeviceLike = None) -> Dict[str, Any]:
    """f32 params drawn on the CPU from ``generator`` (seed 0 when None),
    then moved to ``device`` (the card when None)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    wte = torch.randn(cfg.vocab_size, cfg.d_model, generator=g) * 0.02
    wpe = torch.randn(cfg.max_seq_len, cfg.d_model, generator=g) * 0.01
    return {
        "wte": wte.to(dev),
        "wpe": wpe.to(dev),
        "blocks": init_block_params(cfg, g, dev),
        "lnf_w": torch.ones(cfg.d_model, device=dev),
        "lnf_b": torch.zeros(cfg.d_model, device=dev),
    }


def apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: GPT2Config, *,
          return_aux: bool = False):
    """tokens [B, T] int -> logits [B, T, V] (f32); with ``return_aux``,
    ``(logits, aux)``, aux the MoE load-balance loss (0 when dense)."""
    B, T = tokens.shape
    x = params["wte"][tokens] + params["wpe"][:T]
    x = x.to(cfg.dtype)
    x, aux = apply_stack(x, params["blocks"], cfg)
    x = layernorm(x, params["lnf_w"].to(cfg.dtype), params["lnf_b"].to(cfg.dtype))
    logits = (x @ params["wte"].T.to(cfg.dtype)).float()  # tied LM head
    return (logits, aux) if return_aux else logits


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: GPT2Config
            ) -> torch.Tensor:
    """Next-token cross entropy (f32 scalar).  batch: ``{"tokens": [B,
    T+1]}`` or ``{"inputs": [B, T], "targets": [B, T]}``."""
    inputs, targets = split_batch(batch)
    logits, aux = apply(params, inputs, cfg, return_aux=True)
    loss = cross_entropy_loss(logits, targets)
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# the optimizer: optax's clip_by_global_norm(1.0) then adamw under a
# warmup-cosine schedule, in torch
# ---------------------------------------------------------------------------

_BETAS, _EPS, _MAX_GRAD_NORM = (0.9, 0.95), 1e-8, 1.0


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """The port's copy of ``optax.warmup_cosine_decay_schedule`` (exponent
    1): a linear ramp from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine from ``peak_value`` down to
    ``end_value`` at ``decay_steps`` (which counts the warm-up), flat
    after.  Evaluated in f64 where optax computes in f32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return (init_value - peak_value) * (1.0 - count / warmup_steps) + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The JAX package's training recipe (``gpt2.make_optimizer``) in
    torch: the gradients clipped to a global norm of 1.0, then AdamW with
    betas (0.9, 0.95), eps 1e-8 and ``weight_decay``, its learning rate
    from the warmup-cosine schedule.  Weight decay goes to every leaf with
    ``ndim >= 2`` on the stacked tree, as optax's mask reads it: the
    stacked block norms and biases are decayed, and so is every MoE leaf
    (router, expert weights and biases); the final norm is not.

    Where it differs from optax, and by how much: ``clip_grad_norm_``
    scales by ``1 / (norm + 1e-6)`` where optax scales by ``1 / norm``, a
    relative change of 1e-6 / norm to a clipped gradient, which Adam's
    normalised update all but cancels; the schedule is evaluated in f64
    where optax uses f32 (relative 6e-8)."""

    lr: float
    weight_decay: float
    warmup: int
    total_steps: int

    def schedule(self, count: int) -> float:
        """The learning rate of the update made at step ``count`` (from 0).
        Optax evaluates its schedule at the count before it increments
        it, so the first update runs at ``schedule(0) = 0``."""
        return warmup_cosine_decay_schedule(
            0.0, self.lr, self.warmup, max(self.total_steps, self.warmup + 1),
            self.lr * 0.1)(count)

    def init(self, params: Dict[str, Any], count: int = 0) -> Dict[str, Any]:
        """``{"adamw": torch.optim.AdamW, "lr_schedule": LambdaLR}`` over the
        leaves of ``params``, in two groups (decayed, not decayed).  A
        group's lr is the schedule's value itself (base lr 1.0).  ``count``
        > 0 starts the schedule at that step."""
        leaves = [t for _, t in named_leaves(params)]
        groups = [{"params": [t for t in leaves if t.ndim >= 2],
                   "weight_decay": self.weight_decay},
                  {"params": [t for t in leaves if t.ndim < 2], "weight_decay": 0.0}]
        groups = [g for g in groups if g["params"]]
        if count:
            for g in groups:
                g["initial_lr"] = 1.0  # what LambdaLR reads to resume
        adamw = torch.optim.AdamW(groups, lr=1.0, betas=_BETAS, eps=_EPS)
        sched = torch.optim.lr_scheduler.LambdaLR(adamw, self.schedule,
                                                  last_epoch=count - 1)
        return {"adamw": adamw, "lr_schedule": sched}

    @staticmethod
    def zero_grad(opt_state: Dict[str, Any]) -> None:
        opt_state["adamw"].zero_grad(set_to_none=True)

    @staticmethod
    def update(opt_state: Dict[str, Any]) -> None:
        """One update from the params' ``.grad``, in place: clip, the AdamW
        step, then the schedule's step."""
        adamw = opt_state["adamw"]
        torch.nn.utils.clip_grad_norm_(
            [p for g in adamw.param_groups for p in g["params"]], _MAX_GRAD_NORM)
        adamw.step()
        opt_state["lr_schedule"].step()


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = 100, total_steps: int = 10000) -> AdamW:
    return AdamW(lr, weight_decay, warmup, total_steps)


def make_train_step(cfg: GPT2Config, optimizer: AdamW, mesh: Optional[object] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place (see ``make_train_step_from_loss``)."""
    return make_train_step_from_loss(loss_fn, cfg, optimizer, mesh)


def init_state(cfg: GPT2Config, generator: Optional[torch.Generator], optimizer: AdamW,
               *, device: DeviceLike = None) -> Dict[str, Any]:
    """The train state at step 0 over f32 params from :func:`init`, on the
    card when ``device`` is None."""
    return train_state(init(cfg, generator, device=device), optimizer)


def num_params(params: Dict[str, Any]) -> int:
    return sum(t.numel() for _, t in named_leaves(params))
