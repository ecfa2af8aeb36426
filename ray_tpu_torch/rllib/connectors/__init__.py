"""ray_tpu_torch.rllib.connectors: composable env<->policy transform pipelines.

The port's own copy of ``ray_tpu/rllib/connectors/`` (numpy only):
``AgentConnector`` pipelines on the observation path, ``ActionConnector``
pipelines on the action path, a ``ConnectorContext`` carrying spaces and
config, a transform library (flatten / cast / running-stat normalize /
frame-stack / clip / unsquash), and ``to_state``/``from_state``
serialization through a name registry so pipelines ride checkpoints and
pickle through configs.  With no spec the rollout worker installs the
defaults.
"""

from ray_tpu_torch.rllib.connectors.action import (
    ClipAction,
    DiscreteAction,
    UnsquashAction,
    default_action_connectors,
)
from ray_tpu_torch.rllib.connectors.agent import (
    CastObs,
    ClipObs,
    FlattenObs,
    FrameStackObs,
    NormalizeObs,
    default_agent_connectors,
)
from ray_tpu_torch.rllib.connectors.connector import (
    ActionConnector,
    ActionConnectorPipeline,
    AgentConnector,
    AgentConnectorPipeline,
    Connector,
    ConnectorContext,
    ConnectorPipeline,
    build_pipeline,
    get_connector_class,
    register_connector,
)

__all__ = [
    "Connector",
    "AgentConnector",
    "ActionConnector",
    "ConnectorContext",
    "ConnectorPipeline",
    "AgentConnectorPipeline",
    "ActionConnectorPipeline",
    "build_pipeline",
    "register_connector",
    "get_connector_class",
    "FlattenObs",
    "CastObs",
    "NormalizeObs",
    "FrameStackObs",
    "ClipObs",
    "DiscreteAction",
    "UnsquashAction",
    "ClipAction",
    "default_agent_connectors",
    "default_action_connectors",
]
