"""Action (policy-output -> env) connector library: the port's own copy
of ``ray_tpu/rllib/connectors/action.py`` (numpy only).  Continuous
policies act in the canonical [-1, 1] box (tanh squash) and the connector
rescales to the env's bounds; discrete policies emit array scalars the
env wants as ints.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.connectors.connector import (
    ActionConnector,
    ConnectorContext,
    register_connector,
)


class DiscreteAction(ActionConnector):
    """Policy's array scalar -> plain int (what discrete envs accept)."""

    NAME = "discrete_action"

    def __call__(self, a, env_id: Any = 0, training: bool = True):
        return int(a)


class UnsquashAction(ActionConnector):
    """Canonical [-1, 1] action -> the env's finite Box bounds, so
    full-range actions are reachable.  ``squash`` is the exact inverse
    (offline data recorded in env units re-enters policy space with it)."""

    NAME = "unsquash_action"

    def __init__(self, ctx: Optional[ConnectorContext] = None,
                 low=None, high=None):
        low = ctx.action_low if low is None and ctx is not None else low
        high = ctx.action_high if high is None and ctx is not None else high
        if low is None or high is None:
            raise ValueError("UnsquashAction needs bounds (ctx or low/high)")
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, a, env_id: Any = 0, training: bool = True):
        a = np.clip(np.asarray(a, np.float32), -1.0, 1.0)
        return self.low + (a + 1.0) * (self.high - self.low) / 2.0

    def squash(self, x) -> np.ndarray:
        """Env units -> canonical [-1, 1] (inverse of ``__call__``)."""
        x = np.asarray(x, np.float32)
        return np.clip(
            2.0 * (x - self.low) / (self.high - self.low) - 1.0, -1.0, 1.0)

    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {"low": self.low.copy(), "high": self.high.copy()}


class ClipAction(ActionConnector):
    """Clip to bounds — the fallback when a bound is infinite and
    rescaling is undefined."""

    NAME = "clip_action"

    def __init__(self, ctx: Optional[ConnectorContext] = None,
                 low=None, high=None):
        low = ctx.action_low if low is None and ctx is not None else low
        high = ctx.action_high if high is None and ctx is not None else high
        if low is None or high is None:
            raise ValueError("ClipAction needs bounds (ctx or low/high)")
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, a, env_id: Any = 0, training: bool = True):
        return np.clip(np.asarray(a, np.float32), self.low, self.high)

    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {"low": self.low.copy(), "high": self.high.copy()}


def default_action_connectors(ctx: ConnectorContext):
    """What the hardwired ``_env_action`` used to do, as a pipeline."""
    if ctx.discrete:
        return [DiscreteAction()]
    if (ctx.action_low is not None and ctx.action_high is not None
            and np.all(np.isfinite(ctx.action_low))
            and np.all(np.isfinite(ctx.action_high))):
        return [UnsquashAction(low=ctx.action_low, high=ctx.action_high)]
    return [ClipAction(low=ctx.action_low, high=ctx.action_high)]


register_connector(DiscreteAction.NAME, DiscreteAction)
register_connector(UnsquashAction.NAME, UnsquashAction)
register_connector(ClipAction.NAME, ClipAction)
