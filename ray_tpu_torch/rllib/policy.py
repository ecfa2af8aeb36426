"""TorchPolicy: params, sampling and the SGD update of an RL learner.

Counterpart of ``ray_tpu/rllib/policy.py`` (``JaxPolicy``'s surface:
``compute_actions``, ``value``, ``greedy_action``, ``action_logp``,
``learn_on_minibatch``, ``get_weights``/``set_weights``,
``get_state``/``set_state``).  Every forward goes through the policy's
:class:`~ray_tpu_torch.rllib.rl_module.RLModule`.  The params tree's
tensors live on ``device`` (the card when None; raises when there is
none); numpy goes in and numpy comes out, with one read back per call.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
adam(lr))`` on ``torch.optim.Adam``: the clip scales every gradient by
``grad_clip / max(norm, grad_clip)`` as optax does (not by
``clip_grad_norm_``'s ``grad_clip / (norm + 1e-6)``), and a leaf the loss
does not reach gets a zero gradient and its Adam step, as in optax.
Sampled actions come from a ``torch.Generator`` on the device seeded from
``seed``; they cannot match ``jax.random``'s draws.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.rl_module import Columns, DefaultActorCriticModule, RLModule
from ray_tpu_torch.util.tree import tree_leaves, tree_map


def bind_loss(loss_fn: Callable, module: RLModule) -> Callable:
    """Normalize a loss to ``(params, batch)``: the loss makers produce
    ``loss(module, params, batch)``; two-argument ``loss(params, batch)``
    closures pass through."""
    try:
        n = len([p for p in inspect.signature(loss_fn).parameters.values()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
    except (TypeError, ValueError):
        n = 2
    if n >= 3:
        return lambda params, batch: loss_fn(module, params, batch)
    return loss_fn


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """A numpy array (or a tensor) as a tensor on ``device``, in its own
    dtype: uint8 frames cross as one byte a pixel."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(device)


def to_numpy(tree: Any) -> Any:
    """Every tensor of ``tree`` as a numpy copy on the host."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def _shaped_like(p: torch.Tensor, v: Any) -> torch.Tensor:
    """``v`` (numpy or a tensor) as a tensor, which must have ``p``'s shape."""
    v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    if tuple(v.shape) != tuple(p.shape):
        raise ValueError(f"a leaf of shape {tuple(v.shape)} for one of {tuple(p.shape)}")
    return v


def copy_into(params: Any, values: Any) -> None:
    """Copy ``values`` (numpy or tensors, the same tree; metadata such as
    a ``ConvSpec`` is not read) into ``params`` in place, so an optimizer
    over ``params`` keeps its leaves."""
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(_shaped_like(p, v)), params, values)


def make_adam(params: Any, lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over the params' leaves in ``tree_leaves``
    order, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam([t.requires_grad_(True) for t in tree_leaves(params)],
                            lr=lr, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: every gradient times
    ``max_norm / max(norm, max_norm)``, with no read back."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))


def adam_update(optimizer: torch.optim.Optimizer, grad_clip: Optional[float]) -> None:
    """One optax ``chain(clip, adam)`` update from the leaves' gradients;
    a leaf without a gradient gets zeros, as ``jax.grad`` gives it."""
    leaves = optimizer.param_groups[0]["params"]
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_clip:
        clip_by_global_norm_([p.grad for p in leaves], grad_clip)
    optimizer.step()


def adam_state(optimizer: torch.optim.Optimizer, params: Any) -> Dict[str, Any]:
    """The Adam state as numpy trees shaped like ``params``: ``step`` (the
    update count), ``exp_avg`` and ``exp_avg_sq`` (zeros before the first
    update)."""
    def moment(name):
        return to_numpy(tree_map(
            lambda p: optimizer.state[p][name] if p in optimizer.state else torch.zeros_like(p),
            params))

    steps = [float(optimizer.state[p]["step"]) for p in tree_leaves(params)
             if p in optimizer.state]
    return {"step": int(max(steps, default=0)), "exp_avg": moment("exp_avg"),
            "exp_avg_sq": moment("exp_avg_sq")}


def load_adam_state(optimizer: torch.optim.Optimizer, params: Any,
                    opt_state: Dict[str, Any]) -> None:
    """Load ``adam_state``'s form (or ``convert.from_jax_rl_state``'s) into
    ``optimizer``: the moments are matched to ``params`` by their place in
    the tree and must have the leaves' shapes."""
    mu = tree_leaves(tree_map(_shaped_like, params, opt_state["exp_avg"]))
    nu = tree_leaves(tree_map(_shaped_like, params, opt_state["exp_avg_sq"]))
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(opt_state["step"])), "exp_avg": m,
                       "exp_avg_sq": v} for i, (m, v) in enumerate(zip(mu, nu))}
    optimizer.load_state_dict(sd)


def gather_logp(logits: torch.Tensor, actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-softmax of ``logits``, its entry at each action)."""
    logp_all = F.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions.long()[:, None])[:, 0]


class TorchPolicy:
    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        *,
        lr: float = 5e-4,
        hiddens=(64, 64),
        seed: int = 0,
        loss_fn: Optional[Callable] = None,
        grad_clip: Optional[float] = 0.5,
        obs_shape: Optional[tuple] = None,
        module: Optional[RLModule] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        if module is None:
            # catalog default: MLP, or CNN when an image obs_shape is given
            module = DefaultActorCriticModule(
                obs_dim, num_actions, hiddens=tuple(hiddens),
                obs_shape=obs_shape if obs_shape and len(obs_shape) == 3 else None)
        self.module = module
        self.params = module.init(torch.Generator().manual_seed(seed + 1), device=self.device)
        self.grad_clip = grad_clip
        self.optimizer = make_adam(self.params, lr)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._loss_fn = bind_loss(loss_fn, module) if loss_fn else None

    def _obs(self, obs) -> torch.Tensor:
        return to_device(obs, self.device)

    # -- acting --------------------------------------------------------
    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """obs [B, ...] -> (actions int64, action_logp, vf_preds), numpy."""
        out = self.module.forward_exploration(self.params, self._obs(obs))
        logp_all = F.log_softmax(out[Columns.ACTION_DIST_INPUTS], dim=-1)
        action = torch.multinomial(logp_all.exp(), 1, generator=self.generator)
        logp = logp_all.gather(-1, action)[:, 0]
        a, lp, v = torch.stack([action[:, 0].to(logp.dtype), logp,
                                out[Columns.VF_PREDS]]).cpu().numpy()
        return a.astype(np.int64), lp, v

    @torch.no_grad()
    def value(self, obs: np.ndarray) -> np.ndarray:
        return self.module.forward_train(self.params, self._obs(obs))[Columns.VF_PREDS].cpu().numpy()

    @torch.no_grad()
    def greedy_action(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic action (evaluation / explore=False path)."""
        out = self.module.forward_inference(self.params, self._obs(obs))
        return out[Columns.ACTION_DIST_INPUTS].argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def action_logp(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        """Current-policy log-prob of given actions (V-trace ratios)."""
        out = self.module.forward_train(self.params, self._obs(obs))
        return gather_logp(out[Columns.ACTION_DIST_INPUTS],
                           self._obs(actions))[1].cpu().numpy()

    # -- learning ------------------------------------------------------
    def learn_on_minibatch(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One optimizer step on ``batch`` (numpy arrays, or tensors already
        on the device); returns the loss and the loss's metrics."""
        if self._loss_fn is None:
            raise RuntimeError("policy constructed without a loss_fn")
        tb = {k: self._obs(v) for k, v in batch.items()}
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._loss_fn(self.params, tb)
        loss.backward()
        adam_update(self.optimizer, self.grad_clip)
        vals = torch.stack([loss.detach(), *(m.detach() for m in metrics.values())]).tolist()
        return dict(zip(["total_loss", *metrics], vals))

    # -- weights -------------------------------------------------------
    def get_weights(self) -> Any:
        return to_numpy(self.params)

    def set_weights(self, weights: Any) -> None:
        """Copy ``weights`` (this policy's or a ``JaxPolicy``'s
        ``get_weights()``) into the params in place."""
        copy_into(self.params, weights)

    def get_state(self) -> Dict[str, Any]:
        """Weights + Adam state, so a restored learner resumes with the
        exact moments (``convert.from_jax_rl_state`` gives this form from
        a ``JaxPolicy``'s state)."""
        return {"weights": self.get_weights(),
                "opt_state": adam_state(self.optimizer, self.params)}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        if state.get("opt_state") is not None:
            load_adam_state(self.optimizer, self.params, state["opt_state"])
