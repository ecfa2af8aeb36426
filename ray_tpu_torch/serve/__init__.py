"""ray_tpu_torch.serve — model serving on GPU-backed replicas.

Analog of ``python/ray/serve`` (SURVEY §3.6): a controller actor reconciles
declarative deployment state into replica actors (``num_gpus=1`` replicas
for BASELINE config 5), handles route through a least-loaded router under a
max-concurrent-queries cap, and an HTTP proxy actor exposes deployments
over REST.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_deployment_handle,
    get_http_address,
    ingress,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from ray_tpu_torch.serve.exceptions import (
    BackPressureError,
    RayServeException,
    ReplicaDrainingError,
)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve._private.http_util import Request, Response, StreamingResponse

__all__ = [
    "StreamingResponse",
    "Response",
    "deployment",
    "Deployment",
    "DeploymentConfig",
    "AutoscalingConfig",
    "batch",
    "Application",
    "ingress",
    "run",
    "start",
    "delete",
    "status",
    "shutdown",
    "get_deployment_handle",
    "get_http_address",
    "DeploymentHandle",
    "HTTPOptions",
    "Request",
    "RayServeException",
    "BackPressureError",
    "ReplicaDrainingError",
]
