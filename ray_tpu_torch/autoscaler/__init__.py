"""ray_tpu_torch.autoscaler — demand- and trend-driven cluster scaling.

The port's copy of ``ray_tpu/autoscaler`` (analog of
``python/ray/autoscaler``): the ``StandardAutoscaler`` reconcile loop
(``_private/autoscaler.py:167``) over pluggable ``NodeProvider``s
(``autoscaler/node_provider.py:13``), with a local provider whose nodes
are real node-agent subprocesses holding ``node_config["num_gpus"]``
cards, and a GCP provider of card hosts (``gcp_gpu.py``
``GCPGPUNodeProvider``, the counterpart of the JAX package's
``gcp_tpu.py`` ``GCPTPUNodeProvider``: Compute Engine VMs with cards in
place of TPU VMs, imported by its full name as the JAX one is).  Demand counts ``"GPU"``: a pending actor or task that asks for a
card the cluster lacks waits as demand until a node with one joins.
``TrendAutoscaler`` adds TSDB-trend decisions (scale before the doctor
flags an incident) and slice-atomic replacement of degraded slices
(``policy.py``).
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalingConfig,
    Monitor,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.local_node_provider import LocalNodeProvider
from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.autoscaler.policy import (
    Decision,
    TrendAutoscaler,
    TrendPolicy,
    TrendPolicyConfig,
)

__all__ = [
    "AutoscalingConfig", "StandardAutoscaler", "Monitor", "NodeProvider",
    "LocalNodeProvider",
    "TrendAutoscaler", "TrendPolicy", "TrendPolicyConfig", "Decision",
]
