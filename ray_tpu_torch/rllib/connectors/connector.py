"""Connector core: typed env<->policy transform pipelines.

The port's own copy of ``ray_tpu/rllib/connectors/connector.py`` (numpy
only).  The preprocessing of a rollout worker is a pipeline of small
composable transforms that

- is THE sample path (RolloutWorker owns one agent pipeline and one
  action pipeline; there is no parallel hardwired path),
- serializes (``to_state``/``from_state`` through a name registry), so
  stateful transforms like running-stat normalization ride checkpoints
  and pickle cleanly through config dicts,
- carries per-env episode state (frame stacks) keyed by ``env_id`` with
  an explicit ``reset(env_id)`` at episode boundaries.

``training=False`` transforms without updating persistent statistics
(the evaluation / single-obs inference path); per-env episode state is
NOT gated by it: a frame stack must track the episode it is in either
way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ConnectorContext:
    """What a connector may need to size itself: the env's spaces (as
    plain shapes/bounds so contexts pickle without gym), plus the
    algorithm config for free-form knobs.

    ``from_env`` probes a live (gymnasium-like) env; workers build one at
    construction and hand it to every connector they instantiate.
    """

    obs_shape: Tuple[int, ...] = ()
    obs_dim: int = 0
    num_actions: int = 0
    discrete: bool = True
    action_low: Optional[np.ndarray] = None
    action_high: Optional[np.ndarray] = None
    config: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_env(cls, env, config: Optional[Dict[str, Any]] = None
                 ) -> "ConnectorContext":
        obs_shape = tuple(env.observation_space.shape)
        space = env.action_space
        discrete = hasattr(space, "n")
        if discrete:
            num_actions, low, high = int(space.n), None, None
        else:
            num_actions = int(np.prod(space.shape))
            low = np.asarray(space.low, np.float32)
            high = np.asarray(space.high, np.float32)
        return cls(obs_shape=obs_shape, obs_dim=int(np.prod(obs_shape)),
                   num_actions=num_actions, discrete=discrete,
                   action_low=low, action_high=high,
                   config=dict(config or {}))


# ---------------------------------------------------------------------------
# registry: connector NAME -> class, so pipeline state is restorable
# across processes without pickling classes (``register_connector`` in the
# RLlib's connector.py)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def register_connector(name: str, cls: type) -> None:
    """Register a connector class under a stable name (custom connectors
    call this once at import time so ``from_state`` can rebuild them)."""
    _REGISTRY[name] = cls


def get_connector_class(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown connector {name!r}; custom connectors must be "
            f"register_connector()'d before restoring a pipeline "
            f"(known: {sorted(_REGISTRY)})") from None


class Connector:
    """One transform step.  Subclasses set ``NAME``, implement
    ``__call__``, and override ``to_state``/``from_state`` when they carry
    constructor params or learned statistics."""

    NAME = "connector"

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        raise NotImplementedError

    def reset(self, env_id: Any = None) -> None:
        """Drop per-env episode state (``env_id=None`` drops all)."""

    # -- serialization --------------------------------------------------
    def to_state(self) -> Tuple[str, Dict[str, Any]]:
        return self.NAME, {}

    @classmethod
    def from_state(cls, ctx: ConnectorContext,
                   params: Dict[str, Any]) -> "Connector":
        return cls(ctx, **params) if _wants_ctx(cls) else cls(**params)


def _wants_ctx(cls: type) -> bool:
    """Connector constructors take (ctx, **params) or just (**params);
    sniff once so both styles restore through the same ``from_state``."""
    import inspect

    try:
        sig = inspect.signature(cls.__init__)
    except (TypeError, ValueError):
        return False
    params = [p for n, p in sig.parameters.items() if n != "self"]
    return bool(params) and params[0].name == "ctx"


class AgentConnector(Connector):
    """Observation-path transform: raw env obs -> policy input.  Stateful
    subclasses key episode state by ``env_id`` and honor ``reset``."""

    NAME = "agent_connector"


class ActionConnector(Connector):
    """Action-path transform: policy output -> what ``env.step`` accepts.
    Stateless by convention (actions carry no episode state)."""

    NAME = "action_connector"


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


class ConnectorPipeline:
    """Ordered composition; applies left to right.  ``to_state`` captures
    the full recipe (names + per-connector params/statistics) as plain
    dicts/arrays, so it pickles, rides checkpoints, and restores through
    the registry on any process."""

    def __init__(self, ctx: ConnectorContext,
                 connectors: Sequence[Connector] = ()):
        self.ctx = ctx
        self.connectors: List[Connector] = list(connectors)

    def __call__(self, x, env_id: Any = 0, training: bool = True):
        for c in self.connectors:
            x = c(x, env_id=env_id, training=training)
        return x

    def reset(self, env_id: Any = None) -> None:
        for c in self.connectors:
            c.reset(env_id)

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def __len__(self) -> int:
        return len(self.connectors)

    def __repr__(self) -> str:
        names = " -> ".join(c.NAME for c in self.connectors) or "identity"
        return f"{type(self).__name__}({names})"

    # -- distributed running-stat sync ---------------------------------
    # Stats-only (never touches per-env episode state like frame stacks):
    # remote workers pop Welford deltas, the learner folds them in and
    # broadcasts merged statistics back.  Entries align positionally with
    # ``connectors``; stateless connectors contribute None.
    def pop_stat_deltas(self) -> List[Any]:
        return [c.pop_sync_delta() if hasattr(c, "pop_sync_delta") else None
                for c in self.connectors]

    def apply_stat_deltas(self, deltas: Sequence[Any]) -> None:
        for c, d in zip(self.connectors, deltas or ()):
            if d is not None and hasattr(c, "apply_sync_delta"):
                c.apply_sync_delta(d)

    def get_stat_states(self) -> List[Any]:
        return [c.get_sync_state() if hasattr(c, "get_sync_state") else None
                for c in self.connectors]

    def set_stat_states(self, states: Sequence[Any]) -> None:
        for c, s in zip(self.connectors, states or ()):
            if s is not None and hasattr(c, "set_sync_state"):
                c.set_sync_state(s)

    # -- serialization --------------------------------------------------
    def to_state(self) -> List[Tuple[str, Dict[str, Any]]]:
        return [c.to_state() for c in self.connectors]

    @classmethod
    def from_state(cls, ctx: ConnectorContext,
                   state: Sequence[Tuple[str, Dict[str, Any]]]
                   ) -> "ConnectorPipeline":
        return cls(ctx, [
            get_connector_class(name).from_state(ctx, dict(params))
            for name, params in state
        ])

    def set_state(self, state: Sequence[Tuple[str, Dict[str, Any]]]) -> None:
        """In-place restore (checkpoint load): rebuild the connector list
        from ``state`` under the pipeline's own ctx."""
        self.connectors = type(self).from_state(self.ctx, state).connectors


class AgentConnectorPipeline(ConnectorPipeline):
    """The observation path."""


class ActionConnectorPipeline(ConnectorPipeline):
    """The action path.  Calls ignore env state by convention, but the
    signature stays uniform so pipelines compose the same way."""


# spec: what configs may carry under "agent_connectors"/"action_connectors"
# — instances, (name, kwargs) pairs, or a factory over the ctx
ConnectorSpec = Any


def build_pipeline(pipeline_cls, ctx: ConnectorContext,
                   spec: ConnectorSpec) -> ConnectorPipeline:
    """Materialize a pipeline from a config spec:

    - ``None``: empty pipeline (callers install defaults),
    - a callable: ``spec(ctx) -> sequence of connectors``,
    - a sequence of connector instances and/or ``(name, kwargs)`` pairs
      (the picklable form configs should prefer — instances with learned
      state ship their state, pairs rebuild fresh through the registry).
    """
    if spec is None:
        return pipeline_cls(ctx, [])
    if callable(spec):
        return pipeline_cls(ctx, list(spec(ctx)))
    connectors: List[Connector] = []
    for item in spec:
        if isinstance(item, Connector):
            connectors.append(item)
        elif isinstance(item, (tuple, list)) and len(item) == 2 \
                and isinstance(item[0], str):
            connectors.append(
                get_connector_class(item[0]).from_state(ctx, dict(item[1])))
        else:
            raise TypeError(
                f"connector spec items must be Connector instances or "
                f"(name, kwargs) pairs, got {item!r}")
    return pipeline_cls(ctx, connectors)
