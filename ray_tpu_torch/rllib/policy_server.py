"""Card-resident policy service: batched inference and the learner in one
actor.

Counterpart of ``ray_tpu/rllib/policy_server.py``.  One actor owns the
card and the whole policy surface:

- ``compute_actions``: rollout workers ship uint8 observation batches and
  get (actions, logp, vf) back;
- the frame-stack transport: ``start_rollout`` and
  ``compute_actions_stacked``, where a worker ships only each env's
  newest frame a tick; the server keeps the stacks on its device
  (:func:`advance`), and snapshots them for training under a byte cap;
- ``train_on_batch``, the learner: a batch crosses once and every SGD
  minibatch update runs here; ``(worker, tick, env)`` references in its
  ``obs`` column are resolved from the snapshots, so training ships no
  pixels.

Rollout workers plug in through :class:`RemotePolicy`, which has the
``TorchPolicy`` calling convention over the actor handle (the
``_policy_class`` config seam).  The actor runs threaded: one lock guards
the policy (its params, Adam state and ``torch.Generator``) and the
snapshot cache.  Inference and training spans go to the port's events
plane (``rllib``/``policy inference``, ``policy train``), each with the
bytes its call received (``bytes_in``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch._private import events
from ray_tpu_torch.rllib.policy import TorchPolicy, to_device

# frames a stacked observation holds (the DeepMind Atari contract)
STACK = 4


def advance(state: torch.Tensor, new_frames: torch.Tensor, reset_mask: torch.Tensor
            ) -> torch.Tensor:
    """The stacks after one tick: ``state`` [n, H, W, C] uint8 rolls and
    appends ``new_frames`` [n, H, W]; a row whose ``reset_mask`` is set
    becomes C copies of its fresh frame (the frame-stack reset)."""
    rolled = torch.cat([state[..., 1:], new_frames[..., None]], dim=-1)
    stacked = new_frames[..., None].expand_as(state)
    return torch.where(reset_mask[:, None, None, None], stacked, rolled)


class PolicyServer:
    """Actor hosting the real ``TorchPolicy`` on ``device`` (the card when
    None).  ``serve_policy`` starts it with ``num_gpus`` and
    ``max_concurrency`` above the number of rollout workers, so their
    calls overlap."""

    def __init__(self, obs_dim: int, num_actions: int,
                 policy_kwargs: Optional[Dict[str, Any]] = None,
                 algo_config: Optional[Dict[str, Any]] = None, *, device: DeviceLike = None):
        kwargs = dict(policy_kwargs or {})
        if algo_config is not None:
            # the policy a RolloutWorker would build from the config
            factory = algo_config.get("_loss_factory")
            if factory is not None and "loss_fn" not in kwargs:
                kwargs["loss_fn"] = factory(algo_config)
            kwargs.setdefault("lr", algo_config.get("lr", 5e-4))
            kwargs.setdefault("hiddens", tuple(algo_config.get("fcnet_hiddens", (64, 64))))
            kwargs.setdefault("grad_clip", algo_config.get("grad_clip", 0.5))
            kwargs.setdefault("seed", int(algo_config.get("seed") or 0))
            module_factory = algo_config.get("_rl_module_factory")
            if module_factory is not None and "module" not in kwargs:
                from ray_tpu_torch.rllib.connectors import ConnectorContext

                obs_shape = tuple(kwargs.get("obs_shape") or (obs_dim,))
                kwargs["module"] = module_factory(ConnectorContext(
                    obs_shape=obs_shape, obs_dim=obs_dim, num_actions=num_actions,
                    config=dict(algo_config)))
        self.policy = TorchPolicy(obs_dim, num_actions, device=device, **kwargs)
        self.device = self.policy.device
        self._lock = threading.Lock()
        # the frame-stack transport: each worker's stacks on the device,
        # advanced from single new frames; snapshots cached for training
        self._rollouts: Dict[int, Dict[str, Any]] = {}
        # insertion-ordered: eviction is FIFO, oldest first
        self._obs_cache: Dict[Tuple[int, int], torch.Tensor] = {}
        self._obs_cache_bytes = 0
        # a backstop if training never consumes the cache, in bytes so the
        # number of envs does not change the memory it may take
        self._obs_cache_cap_bytes = 2 << 30

    def describe(self) -> Dict[str, Any]:
        return {"has_conv": "conv" in self.policy.params, "device": str(self.device)}

    def _span(self, message: str, t0: float, **data) -> None:
        events.emit("rllib", message, entity_id="policy-server",
                    span_dur=time.perf_counter() - t0, **data)

    # -- inference ------------------------------------------------------
    def compute_actions(self, obs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        with self._lock:
            out = self.policy.compute_actions(obs)
        # a rollout worker's inference wait minus these spans is transport
        self._span("policy inference", t0, batch=len(out[0]), bytes_in=obs.nbytes)
        return out

    # -- frame-stack transport -----------------------------------------
    def start_rollout(self, worker_id: int, n_envs: int) -> bool:
        """(Re)start a worker's stacks on the device; drops its cached
        snapshots (a restarted worker)."""
        with self._lock:
            self._rollouts[worker_id] = {"state": None, "n_envs": n_envs, "tick": -1}
            for k in [k for k in self._obs_cache if k[0] == worker_id]:
                self._obs_cache_bytes -= self._obs_cache.pop(k).numel()
        return True

    def compute_actions_stacked(self, worker_id: int, new_frames: np.ndarray,
                                reset_mask: np.ndarray):
        """One rollout tick from each env's newest frame [n, H, W] uint8
        and a reset mask: the stacks advance on the device, the policy acts
        on them, and they are kept for training.  Returns (actions, logp,
        vf, tick); ``(worker, tick, env)`` stands for the pixels in the
        sample batch."""
        t0 = time.perf_counter()
        with self._lock:
            ro = self._rollouts.get(worker_id)
            if ro is None:
                ro = self._rollouts[worker_id] = {"state": None, "n_envs": len(new_frames),
                                                  "tick": -1}
            if ro["state"] is None:
                n, h, w = new_frames.shape
                ro["state"] = torch.zeros((n, h, w, STACK), dtype=torch.uint8, device=self.device)
            ro["state"] = advance(ro["state"], to_device(new_frames, self.device),
                                  to_device(reset_mask.astype(bool), self.device))
            ro["tick"] += 1
            tick = ro["tick"]
            self._obs_cache[(worker_id, tick)] = ro["state"]
            self._obs_cache_bytes += ro["state"].numel()
            while self._obs_cache_bytes > self._obs_cache_cap_bytes and len(self._obs_cache) > 1:
                oldest = next(iter(self._obs_cache))
                self._obs_cache_bytes -= self._obs_cache.pop(oldest).numel()
            a, lp, v = self.policy.compute_actions(ro["state"])
        self._span("policy inference", t0, batch=len(new_frames), stacked=True,
                   bytes_in=new_frames.nbytes + reset_mask.nbytes)
        return a, lp, v, tick

    def peek_obs(self, worker_id: int) -> Optional[np.ndarray]:
        """A worker's current stacks (tests and debugging)."""
        with self._lock:
            ro = self._rollouts.get(worker_id)
            if ro is None or ro["state"] is None:
                return None
            return ro["state"].cpu().numpy()

    def value(self, obs: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        with self._lock:
            out = self.policy.value(obs)
        # the bootstrap values count into the workers' inference wait too
        self._span("policy inference", t0, batch=len(out), bytes_in=obs.nbytes)
        return out

    def greedy_action(self, obs: np.ndarray) -> np.ndarray:
        with self._lock:
            return self.policy.greedy_action(obs)

    def action_logp(self, obs: np.ndarray, actions: np.ndarray) -> np.ndarray:
        with self._lock:
            return self.policy.action_logp(obs, actions)

    # -- learning -------------------------------------------------------
    def train_on_batch(self, cols: Dict[str, np.ndarray], *, num_sgd_iter: int,
                       sgd_minibatch_size: int, seed: int = 0) -> Dict[str, float]:
        """Minibatch SGD epochs on the server: the batch crosses once, and
        the minibatches are ``np.random.default_rng(seed)``'s permutations,
        as in the JAX package's server.  An ``obs`` column of [N, 3]
        integer (worker, tick, env) references (the frame-stack transport)
        is resolved from the cached snapshots, which training consumes; a
        missing snapshot raises."""
        from ray_tpu_torch.rllib.algorithm import sgd_epochs

        t0 = time.perf_counter()
        bytes_in = sum(np.asarray(v).nbytes for v in cols.values())
        cols = dict(cols)
        obs = cols.get("obs")
        refs = (obs if isinstance(obs, np.ndarray) and obs.ndim == 2 and obs.shape[1] == 3
                and np.issubdtype(obs.dtype, np.integer) else None)
        with self._lock:
            if refs is not None:
                cols["obs"], needed = self._resolve(refs)
            dev = {k: to_device(v, self.device) for k, v in cols.items()}
            out = sgd_epochs(self.policy, dev, num_sgd_iter=num_sgd_iter,
                             sgd_minibatch_size=sgd_minibatch_size,
                             rng=np.random.default_rng(seed))
            if refs is not None:  # consumed; other entries wait for their batch
                for k in needed:
                    self._obs_cache_bytes -= self._obs_cache.pop(k).numel()
        self._span("policy train", t0, env_steps=len(next(iter(cols.values()))),
                   cached=refs is not None, bytes_in=bytes_in)
        return out

    def _resolve(self, refs: np.ndarray):
        """The observations that ``refs`` point at, gathered on the device
        from only the snapshots they name, and those snapshots' keys."""
        needed = sorted({(int(w), int(t)) for w, t, _ in refs})
        missing = [k for k in needed if k not in self._obs_cache]
        if missing:
            raise RuntimeError(
                f"observation snapshots {missing[:3]} (of {len(missing)}) were evicted "
                "before training: raise the PolicyServer's cache cap or train sooner")
        offsets, off = {}, 0
        for k in needed:
            offsets[k] = off
            off += self._obs_cache[k].shape[0]
        flat = torch.cat([self._obs_cache[k] for k in needed])
        rows = np.array([offsets[(int(w), int(t))] + int(e) for w, t, e in refs], np.int64)
        return flat[torch.from_numpy(rows).to(self.device)], needed

    # -- weights / state ------------------------------------------------
    def get_weights(self):
        with self._lock:
            return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        with self._lock:
            self.policy.set_weights(weights)

    def get_state(self) -> Dict[str, Any]:
        with self._lock:
            return self.policy.get_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.policy.set_state(state)


_SERVER_WEIGHTS_SENTINEL = "__policy_server_weights__"
# the longest a RemotePolicy waits for one server call
_CALL_TIMEOUT_S = 300.0


class RemotePolicy:
    """``TorchPolicy``-shaped client over a PolicyServer handle.

    It takes (and ignores) the local policy's construction kwargs, the
    device among them: it holds no tensor.  Every worker's policy is the
    same server, so weight sync is a token: ``get_weights`` returns one
    and ``set_weights`` with it does nothing."""

    def __init__(self, obs_dim: int, num_actions: int, *, server=None, **_ignored):
        if server is None:
            raise ValueError("RemotePolicy needs a PolicyServer actor handle: pass "
                             "config['_policy_kwargs'] = {'server': handle}")
        import ray_tpu_torch

        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self._server = server
        self._get = lambda ref: ray_tpu_torch.get(ref, timeout=_CALL_TIMEOUT_S)
        desc = self._get(server.describe.remote())
        # RolloutWorker reads "conv" in policy.params to keep image
        # observations [H, W, C]: mirror the server's architecture
        self.params: Dict[str, Any] = {"conv": True} if desc["has_conv"] else {}

    # -- acting ---------------------------------------------------------
    def compute_actions(self, obs):
        return self._get(self._server.compute_actions.remote(obs))

    def start_rollout(self, worker_id: int, n_envs: int):
        return self._get(self._server.start_rollout.remote(worker_id, n_envs))

    def compute_actions_stacked(self, worker_id, new_frames, reset_mask):
        return self._get(self._server.compute_actions_stacked.remote(
            worker_id, new_frames, reset_mask))

    def value(self, obs):
        return self._get(self._server.value.remote(obs))

    def greedy_action(self, obs):
        return self._get(self._server.greedy_action.remote(obs))

    def action_logp(self, obs, actions):
        return self._get(self._server.action_logp.remote(obs, actions))

    # -- learning -------------------------------------------------------
    def train_on_batch(self, batch, *, num_sgd_iter: int, sgd_minibatch_size: int,
                       required_keys: tuple, seed: int = 0) -> Dict[str, float]:
        cols = {k: batch[k] for k in required_keys}
        return self._get(self._server.train_on_batch.remote(
            cols, num_sgd_iter=num_sgd_iter, sgd_minibatch_size=sgd_minibatch_size, seed=seed))

    def learn_on_minibatch(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self._get(self._server.train_on_batch.remote(
            dict(batch), num_sgd_iter=1, sgd_minibatch_size=1 << 62))

    # -- weights --------------------------------------------------------
    def get_weights(self):
        return {_SERVER_WEIGHTS_SENTINEL: True}

    def set_weights(self, weights) -> None:
        if isinstance(weights, dict) and weights.get(_SERVER_WEIGHTS_SENTINEL):
            return  # every worker shares the server: nothing to ship
        self._get(self._server.set_weights.remote(weights))

    def get_state(self):
        return self._get(self._server.get_state.remote())

    def set_state(self, state):
        self._get(self._server.set_state.remote(state))


def serve_policy(algo_config: Dict[str, Any], obs_dim: int, num_actions: int, *,
                 obs_shape: Optional[tuple] = None, num_gpus: float = 1,
                 max_concurrency: int = 16, frame_stack_transport: bool = False):
    """Start a PolicyServer actor for ``algo_config`` and return its handle
    with the config entries that point rollout workers at it::

        handle, overrides = serve_policy(cfg, obs_dim, n_act, obs_shape=(84, 84, 4))
        cfg.update(overrides)

    The server holds ``num_gpus`` of a card (default 1) and its policy
    lives there; ``num_gpus=0`` asks for a server on the CPU.  It returns
    once the server is up, and raises when the runtime has no card to
    grant or the server sees none.

    ``frame_stack_transport=True`` (channel-stacked uint8 image envs whose
    reset stacks copies of the first frame, the DeepMind Atari contract):
    workers ship only each env's newest frame a tick, the server keeps the
    stacks on its device, and training reads the observations from its
    snapshots, so pixels cross to the card once instead of five times."""
    import ray_tpu_torch

    if num_gpus and ray_tpu_torch.cluster_resources().get("GPU", 0) < num_gpus:
        raise RuntimeError(f"serve_policy: num_gpus={num_gpus} and the runtime has no card "
                           "to grant; pass num_gpus=0 for a server on the CPU")
    policy_kwargs: Dict[str, Any] = {}
    if obs_shape is not None and len(obs_shape) == 3:
        policy_kwargs["obs_shape"] = tuple(obs_shape)
    opts: Dict[str, Any] = {"max_concurrency": max_concurrency}
    if num_gpus:
        opts["num_gpus"] = num_gpus
    handle = ray_tpu_torch.remote(PolicyServer).options(**opts).remote(
        obs_dim, num_actions, policy_kwargs, algo_config,
        device="cuda" if num_gpus else "cpu")
    try:
        ray_tpu_torch.get(handle.describe.remote(), timeout=_CALL_TIMEOUT_S)
    except Exception:
        ray_tpu_torch.kill(handle)
        raise
    overrides = {
        "_policy_class": RemotePolicy,
        "_policy_kwargs": {"server": handle},
        "_frame_stack_transport": bool(frame_stack_transport),
    }
    return handle, overrides
