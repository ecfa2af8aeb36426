"""Shared transformer core: config, stacked block params, dense forward,
remat and the train step.

Counterpart of ``ray_tpu/models/transformer.py``.  Block params keep the
JAX package's layout: a dict of tensors, each with a leading ``[L, ...]``
layer axis, and weights stored ``(in, out)`` so a layer computes
``x @ W``.  The forward is a Python loop over that axis (the JAX package
scans it); when gradients are being recorded and ``cfg.remat`` is set,
each layer runs under ``torch.utils.checkpoint`` (:func:`remat`).  A config
with experts (MoE) or a mesh (pipeline or sequence parallel) raises
``NotImplementedError``, and the post-LN order (BERT) comes with the BERT
slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import layernorm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304  # GPT-2's 50257 padded up to a multiple of 128
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 1024
    causal: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "dots": save the weight products, recompute the rest; "full":
    # recompute everything (see remat())
    remat_policy: str = "dots"
    n_experts: int = 0  # >0 (Switch MoE) is not ported yet

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_block_params(cfg: TransformerConfig, generator: torch.Generator,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stacked f32 block params, GPT-2 init (normal 0.02, residual
    projections scaled by 1/sqrt(2L)).  Drawn on the CPU from
    ``generator``, so a seed gives the same weights on every device."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE blocks are not ported yet")
    dev = resolve_device(device)
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    std, res_std = 0.02, 0.02 / (2 * L) ** 0.5

    def normal(shape, s):
        return torch.randn(shape, generator=generator) * s

    p = {
        "ln1_w": torch.ones(L, D), "ln1_b": torch.zeros(L, D),
        "wqkv": normal((L, D, 3 * D), std),
        "bqkv": torch.zeros(L, 3 * D),
        "wo": normal((L, D, D), res_std),
        "bo": torch.zeros(L, D),
        "ln2_w": torch.ones(L, D), "ln2_b": torch.zeros(L, D),
        "w1": normal((L, D, Fd), std),
        "b1": torch.zeros(L, Fd),
        "w2": normal((L, Fd, D), res_std),
        "b2": torch.zeros(L, D),
    }
    return {k: v.to(dev) for k, v in p.items()}


def _check_dense(cfg: TransformerConfig, mesh) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE blocks are not ported yet")
    if mesh is not None:
        raise NotImplementedError(
            "pipeline- and sequence-parallel forwards are not ported yet")


def named_leaves(tree: Dict[str, Any], prefix: str = ""):
    """``(path, tensor)`` for every leaf of a params tree, paths joined
    with ``/`` (``"blocks/wqkv"``), in the tree's own order."""
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", v


def layer(blocks: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s params: views into the stacked leaves."""
    return {k: v[l] for k, v in blocks.items()}


def apply_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                cfg: TransformerConfig, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN (GPT-2) transformer block.  x: [B, T, D] in cfg.dtype.
    Returns ``(x, aux)``; aux is 0 for a dense block."""
    _check_dense(cfg, mesh)
    B, T, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    c = lambda w: w.to(cfg.dtype)

    def attn(h):
        qkv = h @ c(p["wqkv"]) + c(p["bqkv"])
        q, k, v = qkv.split(D, dim=-1)
        to_heads = lambda t: t.reshape(B, T, H, dh).transpose(1, 2)
        out = attention(to_heads(q), to_heads(k), to_heads(v), causal=cfg.causal)
        out = out.transpose(1, 2).reshape(B, T, D)
        return out @ c(p["wo"]) + c(p["bo"])

    def ffn(h):
        h = F.gelu(h @ c(p["w1"]) + c(p["b1"]), approximate="tanh")
        return h @ c(p["w2"]) + c(p["b2"])

    x = x + attn(layernorm(x, c(p["ln1_w"]), c(p["ln1_b"])))
    x = x + ffn(layernorm(x, c(p["ln2_w"]), c(p["ln2_b"])))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# The counterpart of jax.checkpoint_policies.dots_with_no_batch_dims_saveable:
# the products of activations with weight matrices (x @ W folds to mm) are
# saved; batched products (attention's) and everything elementwise are
# recomputed.  The flash kernels are launched through ctypes, out of the
# dispatcher's sight, so the FlashAttention forward is recomputed too, as a
# pallas_call is under the JAX policy.
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def remat(fn: Callable, cfg: Any) -> Callable:
    """``fn`` run under ``torch.utils.checkpoint`` per ``cfg.remat`` and
    ``cfg.remat_policy`` ("dots" or "full"; any other policy raises
    ``ValueError``, as the JAX package does).  Only while gradients are
    recorded: an inference forward runs ``fn`` as it is."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots":
        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _DOTS)}
    elif cfg.remat_policy == "full":
        kw = {}
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (use 'dots' or 'full')")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def apply_stack(x: torch.Tensor, blocks: Dict[str, torch.Tensor],
                cfg: TransformerConfig, mesh: Optional[object] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked layers in order, each under :func:`remat`; returns
    ``(x, aux)``."""
    _check_dense(cfg, mesh)
    body = remat(lambda h, p: apply_block(h, p, cfg), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_layers):
        x, a = body(x, layer(blocks, l))
        aux = aux + a
    return x, aux


def split_batch(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(inputs, targets)`` of a next-token batch: ``{"tokens": [B,
    T+1]}`` or ``{"inputs": [B, T], "targets": [B, T]}``."""
    if "tokens" in batch:
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    return batch["inputs"], batch["targets"]


def make_train_step_from_loss(loss_fn: Callable, cfg: Any, optimizer,
                              mesh: Optional[object] = None) -> Callable:
    """The train step shared by the model families: the loss
    ``loss_fn(params, batch, cfg)`` and its gradients by autograd, then
    ``optimizer.update``.  Returns ``train_step(state, batch) -> (state,
    metrics)``.

    Unlike the JAX package's pure step, it updates ``state`` in place: the
    param tensors and the optimizer's moments are written over (no second
    copy of either), ``state["step"]`` is advanced, and the same dict is
    returned.  ``metrics["loss"]`` is a detached device tensor, so a step
    does not wait for the card."""
    if mesh is not None:
        raise NotImplementedError("sharded train steps are not ported yet")

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        opt_state = state["opt_state"]
        optimizer.zero_grad(opt_state)
        loss = loss_fn(state["params"], batch, cfg)
        loss.backward()
        optimizer.update(opt_state)
        state["step"] += 1
        return state, {"loss": loss.detach(), "step": state["step"]}

    return train_step


def train_state(params: Dict[str, Any], optimizer, step: int = 0) -> Dict[str, Any]:
    """``{"params", "opt_state", "step"}`` over ``params``: each leaf made
    to require grad, and ``optimizer.init`` over them with its schedule at
    ``step``."""
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params, step), "step": step}
