"""Shared transformer core: config, stacked block params, dense forward,
remat and the train step.

Counterpart of ``ray_tpu/models/transformer.py``.  Block params keep the
JAX package's layout: a dict of tensors, each with a leading ``[L, ...]``
layer axis, and weights stored ``(in, out)`` so a layer computes
``x @ W``.  The forward is a Python loop over that axis (the JAX package
scans it); when gradients are being recorded and ``cfg.remat`` is set,
each layer runs under ``torch.utils.checkpoint`` (:func:`remat`).  A block
is pre-LN (GPT-2) or post-LN (``post_ln``, BERT), and its FFN dense or a
Switch MoE of ``n_experts`` experts (:mod:`ray_tpu_torch.ops.moe`).

Sharded, the same code runs on DTensor params from
:func:`ray_tpu_torch.parallel.shard_params` (the layouts of
:func:`block_logical_axes`) and a DTensor batch, and DTensor's sharding
propagation inserts the collectives, as GSPMD does for the JAX package.
Two regions are per-rank code, as they are ``shard_map`` there:
attention (:func:`_attend`: the flash kernel on each rank's heads, or ring
attention over ``sp``) and the ``pp`` pipeline (:func:`apply_stack` hands
the stack to :func:`ray_tpu_torch.parallel.gpipe`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.layers import layernorm
from ray_tpu_torch.ops.moe import init_moe_params, moe_ffn, moe_logical_axes
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.pipeline import gpipe, pp_size
from ray_tpu_torch.parallel.sharding import (
    P,
    from_local,
    local_tensor,
    rules_for_mesh,
    shard_batch,
    spec_to_placements,
)


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
    # pre-LN (GPT-2) by default; post-LN is original BERT's order
    post_ln: bool = False
    # MoE: >0 replaces every block's FFN with a Switch (top-1) MoE of this
    # many experts, each holding capacity_factor * tokens / n_experts
    # tokens; the loss adds moe_aux_weight * the load-balance loss
    n_experts: int = 0
    capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    # pipeline parallelism: microbatch count when the mesh has pp > 1
    # (0 = one microbatch per stage)
    pp_microbatches: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_block_params(cfg: TransformerConfig, generator: torch.Generator,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stacked f32 block params, GPT-2 init (normal 0.02, residual
    projections scaled by 1/sqrt(2L)); with experts, the MoE leaves of
    :func:`init_moe_params` in place of ``w1``/``b1``/``w2``/``b2``.  Drawn
    on the CPU from ``generator``, so a seed gives the same weights on
    every device."""
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
    }
    if cfg.n_experts > 0:
        p.update(init_moe_params(generator, L, D, Fd, cfg.n_experts,
                                 std=std, res_std=res_std, device="cpu"))
    else:
        p.update({
            "w1": normal((L, D, Fd), std),
            "b1": torch.zeros(L, Fd),
            "w2": normal((L, Fd, D), res_std),
            "b2": torch.zeros(L, D),
        })
    return {k: v.to(dev) for k, v in p.items()}


def block_logical_axes(n_experts: int = 0) -> Dict[str, Tuple]:
    """Logical axis names for the stacked block params.  The leading
    ``layers`` axis shards over ``pp`` (and only ``pp``) when the mesh
    pipelines."""
    axes = {
        "ln1_w": ("layers", "embed"), "ln1_b": ("layers", "embed"),
        "wqkv": ("layers", "embed", "heads"),
        "bqkv": ("layers", "heads"),
        "wo": ("layers", "heads", "embed"),
        "bo": ("layers", "embed"),
        "ln2_w": ("layers", "embed"), "ln2_b": ("layers", "embed"),
    }
    if n_experts > 0:
        axes.update(moe_logical_axes())
    else:
        axes.update({
            "w1": ("layers", "embed", "mlp"),
            "b1": ("layers", "mlp"),
            "w2": ("layers", "mlp", "embed"),
            "b2": ("layers", "embed"),
        })
    return axes


def named_leaves(tree: Dict[str, Any], prefix: str = ""):
    """``(path, tensor)`` for every leaf of a params tree, paths joined
    with ``/`` (``"blocks/wqkv"``), in the tree's own order."""
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", v


def layers(blocks: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every layer's params, from one ``unbind`` of each stacked leaf.

    The backward of an ``unbind`` is one ``stack``, which writes each
    layer's gradient into its own slice once, as the JAX package's
    ``lax.scan`` does; indexing ``v[l]`` per layer would zero-fill a
    whole ``[L, ...]`` gradient for each layer and add the L of them."""
    cols = {k: _unbind_layers(v) for k, v in blocks.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[l] for k, c in cols.items()} for l in range(n)]


def _unbind_layers(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``v``'s layers.  A DTensor is unbound on its local tensor, and each
    layer wrapped back on the leaf's placements, one dim lower: DTensor
    has no rule to unbind the dim a placement shards, and the layer axis
    lies ``Shard(0)`` over ``pp`` (of size 1 here: a longer ``pp`` runs
    the stack through ``gpipe``, which hands its stages local blocks)."""
    if not isinstance(v, DTensor):
        return torch.unbind(v, 0)
    mesh = v.device_mesh
    pl = []
    for i, p in enumerate(v.placements):
        if p.is_shard(0) and mesh.size(i) > 1:
            raise ValueError(f"the layer axis of {tuple(v.shape)} is split over mesh dim {i}: "
                             "pipeline the stack (gpipe)")
        pl.append(Replicate() if p.is_shard(0) else Shard(p.dim - 1) if p.is_shard() else p)
    return tuple(from_local(t, mesh, pl) for t in torch.unbind(v.to_local(), 0))


def _batch_axes(names) -> Optional[Tuple[str, ...]]:
    return tuple(a for a in ("dp", "fsdp") if a in names) or None


def constrain_activations(x: torch.Tensor) -> torch.Tensor:
    """A ``[B, T, ...]`` DTensor laid out batch over (dp, fsdp) and
    sequence over sp of its mesh, the rest replicated: the residual
    stream's layout at each block's input (a plain tensor is returned as
    it is).  Left to itself, DTensor's propagation picks a layout per op,
    and some are wrong after a reshape: in torch 2.13, under tp x sp,
    Llama's ``h @ wq`` came out ``_StridedShard`` over sp, and its reshape
    to heads gave wrong values."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    spec = P(_batch_axes(names), "sp" if "sp" in names else None, *(None,) * (x.ndim - 2))
    return x.redistribute(x.device_mesh, spec_to_placements(spec, x.device_mesh))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
            ) -> torch.Tensor:
    """Attention on ``[B, H, T, D]`` q/k/v.  Plain tensors take
    :func:`~ray_tpu_torch.ops.attention.attention`.  DTensors are laid out
    batch over (dp, fsdp), heads over tp and sequence over sp of their
    mesh, and each rank runs per-rank code on its own tensors: ring
    attention over ``sp`` when that axis is longer than 1, else
    ``attention`` on its heads and rows (the flash kernel on the card)."""
    if not isinstance(q, DTensor):
        return attention(q, k, v, causal=causal)
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    pl = spec_to_placements(P(_batch_axes(names), "tp" if "tp" in names else None,
                              "sp" if "sp" in names else None, None), mesh)
    ql, kl, vl = (local_tensor(t, pl) for t in (q, k, v))
    if "sp" in names and mesh.size(names.index("sp")) > 1:
        out = ring_attention(ql, kl, vl, mesh, axis_name="sp", causal=causal)
    else:
        out = attention(ql, kl, vl, causal=causal)
    return from_local(out, mesh, pl)


def apply_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block, pre-LN (GPT-2) or post-LN (``cfg.post_ln``,
    BERT).  x: [B, T, D] in cfg.dtype.  Returns ``(x, aux)``: aux is the
    MoE load-balance loss (f32), 0 for a dense block."""
    x = constrain_activations(x)
    B, T, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    c = lambda w: w.to(cfg.dtype)

    def attn(h):
        qkv = h @ c(p["wqkv"]) + c(p["bqkv"])
        q, k, v = qkv.split(D, dim=-1)
        to_heads = lambda t: t.reshape(B, T, H, dh).transpose(1, 2)
        out = _attend(to_heads(q), to_heads(k), to_heads(v), causal=cfg.causal)
        out = out.transpose(1, 2).reshape(B, T, D)
        return out @ c(p["wo"]) + c(p["bo"])

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_experts > 0:
        def ffn(h):
            nonlocal aux
            # the router stays f32, as the JAX package passes it uncast
            y, aux = moe_ffn(h, p["router"], c(p["ew1"]), c(p["eb1"]), c(p["ew2"]),
                             c(p["eb2"]), capacity_factor=cfg.capacity_factor)
            return y
    else:
        def ffn(h):
            h = F.gelu(h @ c(p["w1"]) + c(p["b1"]), approximate="tanh")
            return h @ c(p["w2"]) + c(p["b2"])

    if cfg.post_ln:  # original BERT: residual, then norm
        x = layernorm(x + attn(x), c(p["ln1_w"]), c(p["ln1_b"]))
        x = layernorm(x + ffn(x), c(p["ln2_w"]), c(p["ln2_b"]))
    else:
        x = x + attn(layernorm(x, c(p["ln1_w"]), c(p["ln1_b"])))
        x = x + ffn(layernorm(x, c(p["ln2_w"]), c(p["ln2_b"])))
    return x, aux


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
                cfg: TransformerConfig, mesh: Optional[DeviceMesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked layers in order, each under :func:`remat`; returns
    ``(x, aux)``, aux summed over the layers.  With a ``mesh`` the blocks
    must be DTensors on it; a ``pp`` axis longer than 1 runs the stack as
    :func:`~ray_tpu_torch.parallel.gpipe` stages of ``cfg.pp_microbatches``
    microbatches (same math, microbatched)."""
    if mesh is not None and not all(isinstance(v, DTensor) for v in blocks.values()):
        raise ValueError("apply_stack with a mesh takes DTensor blocks "
                         "(see parallel.shard_params)")
    body = remat(lambda h, p: apply_block(h, p, cfg), cfg)

    def stage(local_blocks, h):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p in layers(local_blocks):
            h, a = body(h, p)
            aux = aux + a
        return h, aux

    if pp_size(mesh) > 1:
        return gpipe(stage, blocks, x, mesh=mesh, n_microbatches=cfg.pp_microbatches)
    return stage(blocks, x)


def split_batch(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(inputs, targets)`` of a next-token batch: ``{"tokens": [B,
    T+1]}`` or ``{"inputs": [B, T], "targets": [B, T]}``."""
    if "tokens" in batch:
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    return batch["inputs"], batch["targets"]


def make_train_step_from_loss(loss_fn: Callable, cfg: Any, optimizer,
                              mesh: Optional[DeviceMesh] = None) -> Callable:
    """The train step shared by the model families: the loss
    ``loss_fn(params, batch, cfg)`` and its gradients by autograd, then
    ``optimizer.update``.  Returns ``train_step(state, batch) -> (state,
    metrics)``.

    Unlike the JAX package's pure step, it updates ``state`` in place: the
    param tensors and the optimizer's moments are written over (no second
    copy of either), ``state["step"]`` is advanced, and the same dict is
    returned.  ``metrics["loss"]`` is a detached device tensor, so a step
    does not wait for the card.

    With a ``mesh`` the params must be DTensors on it
    (:func:`ray_tpu_torch.parallel.shard_params`); a batch of plain
    tensors (the whole batch, the same on every rank) is laid out
    ``(batch, seq)`` under ``rules_for_mesh(mesh)``, the loss is
    ``loss_fn(params, batch, cfg, mesh)`` (plain tensors the model makes,
    such as masks and positions, count as replicated), and the update
    reads the global gradient norm.  The loss comes back whole on every
    rank."""
    rules = rules_for_mesh(mesh) if mesh is not None else None

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        opt_state = state["opt_state"]
        optimizer.zero_grad(opt_state)
        if mesh is None:
            loss = loss_fn(state["params"], batch, cfg)
            loss.backward()
        else:
            with implicit_replication():
                loss = loss_fn(state["params"], shard_batch(batch, mesh, rules), cfg, mesh)
                loss.backward()
            loss = loss.full_tensor()
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
