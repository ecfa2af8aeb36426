"""Built-in benchmark environments.

The port's own copy of ``ray_tpu/rllib/envs.py`` (pure numpy, so it runs
where ``gymnasium`` is not installed).  Emulated Atari ROMs are not
available, so the north-star "PPO Atari env-steps/s" (BASELINE config 4)
is measured on :class:`SyntheticAtariEnv`: the observation and action
interface and per-step host cost of a DeepMind-wrapped Atari env (uint8
[84, 84, 4] frames, 6 discrete actions, episodic resets) with
deterministic synthetic dynamics: a moving sprite whose position the
agent is rewarded for tracking, so policies can learn and reward curves
move.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class _Box:
    """Minimal observation-space shim (gymnasium.spaces.Box interface
    subset the framework reads: shape + dtype)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


class _Discrete:
    def __init__(self, n):
        self.n = int(n)


class SyntheticAtariEnv:
    """Atari-shaped synthetic env: obs uint8 [84, 84, 4], 6 actions.

    Dynamics: a bright 6x6 sprite drifts horizontally across a textured
    background; actions 0..5 name the horizontal sixth of the screen the
    agent believes the sprite occupies.  Reward 1 for a correct call, 0
    otherwise.  Episodes end (terminated) after ``episode_len`` steps.
    Frame stacking is emulated by rolling the channel axis each step, as
    the DeepMind wrapper does with its frame deque.
    """

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = dict(config or {})
        self.h = int(config.get("height", 84))
        self.w = int(config.get("width", 84))
        self.episode_len = int(config.get("episode_len", 400))
        self.observation_space = _Box((self.h, self.w, 4), np.uint8)
        self.action_space = _Discrete(6)
        self._rng = np.random.default_rng(0)
        self._frame = np.zeros((self.h, self.w, 4), np.uint8)
        self._background = np.zeros((self.h, self.w), np.uint8)
        self._t = 0
        self._x = 0
        self._dx = 1

    # -- gym API --------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        # a fixed per-episode texture so frames aren't trivially blank
        self._background = (
            self._rng.integers(0, 48, (self.h, self.w)).astype(np.uint8))
        self._t = 0
        self._x = int(self._rng.integers(0, self.w - 6))
        self._dx = int(self._rng.choice((-2, -1, 1, 2)))
        self._frame[:] = 0
        for c in range(4):
            self._render(c)
        return self._frame.copy(), {}

    def _render(self, channel: int) -> None:
        f = self._frame[:, :, channel]
        f[:] = self._background
        y = self.h // 2 - 3
        f[y:y + 6, self._x:self._x + 6] = 255

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        self._t += 1
        self._x += self._dx
        if self._x <= 0 or self._x >= self.w - 6:
            self._dx = -self._dx
            self._x = max(0, min(self.w - 6, self._x))
        # stack roll: oldest channel becomes the new frame
        self._frame = np.roll(self._frame, -1, axis=2)
        self._render(3)
        sixth = min(5, self._x * 6 // self.w)
        reward = 1.0 if int(action) == sixth else 0.0
        terminated = self._t >= self.episode_len
        return self._frame.copy(), reward, terminated, False, {}


def synthetic_atari_creator(env_config: Dict[str, Any]) -> SyntheticAtariEnv:
    """``env_creator`` hook for AlgorithmConfig.environment()."""
    return SyntheticAtariEnv(env_config)
