"""Agent (observation-path) connector library: the port's own copy of
``ray_tpu/rllib/connectors/agent.py`` (numpy only).  Flatten and cast,
plus two stateful transforms: running-stat normalization (RLlib's
``MeanStdFilter``) and frame stacking with episode-boundary resets.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.connectors.connector import (
    AgentConnector,
    ConnectorContext,
    register_connector,
)


class FlattenObs(AgentConnector):
    """Flat float32 vector — the MLP policy's input contract.  Always
    produces a fresh array, so envs that hand out their internal buffers
    never alias stored sample rows."""

    NAME = "flatten_obs"

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        # np.array (not asarray): already-flat contiguous float32 input
        # would come back as a VIEW of the env's buffer otherwise
        return np.array(x, np.float32).reshape(-1)


class CastObs(AgentConnector):
    """Copy (and optionally cast) keeping the array's shape — the CNN
    path, where uint8 pixels must stay uint8 ([H, W, C] layout) so
    transport ships 1-byte pixels and the model casts device-side."""

    NAME = "cast_obs"

    def __init__(self, dtype: Optional[str] = None):
        self.dtype = np.dtype(dtype).name if dtype is not None else None

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        return np.array(x, dtype=self.dtype)

    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {"dtype": self.dtype}


class NormalizeObs(AgentConnector):
    """Running mean/std normalization (``MeanStdFilter`` analog).

    Welford accumulators in float64 so the statistics — and therefore the
    transformed observations — are bit-stable under a ``to_state`` /
    ``from_state`` round trip mid-stream.  ``training=False`` normalizes
    with frozen statistics (evaluation / serving inference)."""

    NAME = "normalize_obs"

    def __init__(self, clip: float = 10.0, eps: float = 1e-8,
                 n: int = 0, mean=None, m2=None):
        self.clip = float(clip)
        self.eps = float(eps)
        self._n = int(n)
        self._mean = None if mean is None else np.asarray(mean, np.float64)
        self._m2 = None if m2 is None else np.asarray(m2, np.float64)
        # accumulation since the last ``pop_sync_delta`` — the worker half
        # of distributed filter sync (FilterManager.synchronize analog)
        self._dn = 0
        self._dmean = None
        self._dm2 = None

    @staticmethod
    def _welford(n: int, mean, m2, x: np.ndarray):
        if mean is None:
            mean = np.zeros(x.shape, np.float64)
            m2 = np.zeros(x.shape, np.float64)
        n += 1
        delta = x - mean
        mean = mean + delta / n
        m2 = m2 + delta * (x - mean)
        return n, mean, m2

    def _update(self, x: np.ndarray) -> None:
        self._n, self._mean, self._m2 = self._welford(
            self._n, self._mean, self._m2, x)
        self._dn, self._dmean, self._dm2 = self._welford(
            self._dn, self._dmean, self._dm2, x)

    # -- distributed running-stat sync ---------------------------------
    def pop_sync_delta(self):
        """Statistics accumulated since the last pop (None if nothing new);
        clears the buffer.  Remote workers are polled with this so their
        counts can be folded into the learner's filter."""
        if self._dn == 0:
            return None
        d = {"n": self._dn, "mean": self._dmean, "m2": self._dm2}
        self._dn, self._dmean, self._dm2 = 0, None, None
        return d

    def apply_sync_delta(self, d) -> None:
        """Fold a worker's delta in (Chan et al. parallel Welford merge)."""
        nb = int(d["n"])
        bmean = np.asarray(d["mean"], np.float64)
        bm2 = np.asarray(d["m2"], np.float64)
        if self._mean is None:
            self._n, self._mean, self._m2 = nb, bmean.copy(), bm2.copy()
            return
        na = self._n
        n = na + nb
        delta = bmean - self._mean
        self._mean = self._mean + delta * (nb / n)
        self._m2 = self._m2 + bm2 + delta * delta * (na * nb / n)
        self._n = n

    def get_sync_state(self):
        return {"n": self._n, "mean": self._mean, "m2": self._m2}

    def set_sync_state(self, s) -> None:
        """Replace statistics with the learner's merged copy (broadcast
        half of the sync); the delta buffer restarts empty."""
        self._n = int(s["n"])
        self._mean = (None if s["mean"] is None
                      else np.asarray(s["mean"], np.float64).copy())
        self._m2 = (None if s["m2"] is None
                    else np.asarray(s["m2"], np.float64).copy())
        self._dn, self._dmean, self._dm2 = 0, None, None

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        x = np.asarray(x, np.float64)
        if training:
            self._update(x)
        if self._n < 2:
            return np.asarray(np.clip(x, -self.clip, self.clip), np.float32)
        std = np.sqrt(self._m2 / (self._n - 1)) + self.eps
        out = np.clip((x - self._mean) / std, -self.clip, self.clip)
        return np.asarray(out, np.float32)

    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {
            "clip": self.clip, "eps": self.eps, "n": self._n,
            "mean": None if self._mean is None else self._mean.copy(),
            "m2": None if self._m2 is None else self._m2.copy(),
        }


class FrameStackObs(AgentConnector):
    """Stack the last ``num_frames`` observations along the last axis,
    per env: flat [D] obs become [D * k], image [H, W, C] obs become
    [H, W, C * k] (the DeepMind channel-stack).  The first observation of
    an episode is repeated k times (the wrapper-deque reset semantic);
    ``reset(env_id)`` at the episode boundary is what makes that happen —
    stacks never leak across episodes.

    Episode buffers are transient by design and do NOT serialize: a
    restored pipeline starts with empty stacks, exactly like a freshly
    reset env."""

    NAME = "frame_stack_obs"

    def __init__(self, num_frames: int = 4):
        self.num_frames = int(num_frames)
        self._frames: Dict[Any, list] = {}

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        # copy: an env may mutate and re-return one internal obs buffer,
        # which would alias every buffered frame (the old hardwired prep
        # copied too; upstream connectors usually do, but this connector
        # can be FIRST in an explicit pipeline)
        x = np.array(x, copy=True)
        buf = self._frames.get(env_id)
        if buf is None:
            buf = self._frames[env_id] = []
        buf.append(x)
        del buf[:-self.num_frames]
        frames = [buf[0]] * (self.num_frames - len(buf)) + buf
        return np.concatenate(frames, axis=-1)

    def reset(self, env_id: Any = None) -> None:
        if env_id is None:
            self._frames.clear()
        else:
            self._frames.pop(env_id, None)

    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {"num_frames": self.num_frames}


class ClipObs(AgentConnector):
    """Elementwise clip — cheap guard for envs with unbounded spikes."""

    NAME = "clip_obs"

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        return np.clip(np.asarray(x, np.float32), self.low, self.high)

    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {"low": self.low, "high": self.high}


def default_agent_connectors(ctx: ConnectorContext, conv: bool):
    """What the hardwired ``_prep_obs`` used to do, as a pipeline: image
    observations for a conv-bearing policy keep [H, W, C] uint8; flat
    observations flatten to float32."""
    return [CastObs()] if conv else [FlattenObs()]


register_connector(FlattenObs.NAME, FlattenObs)
register_connector(CastObs.NAME, CastObs)
register_connector(NormalizeObs.NAME, NormalizeObs)
register_connector(FrameStackObs.NAME, FrameStackObs)
register_connector(ClipObs.NAME, ClipObs)
