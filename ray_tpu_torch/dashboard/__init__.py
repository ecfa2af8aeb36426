"""ray_tpu_torch.dashboard — cluster observability HTTP server.

Analog of the reference dashboard head (``dashboard/head.py:69``): JSON
state endpoints + Prometheus ``/metrics``, served from the head process.
"""

from ray_tpu_torch.dashboard.dashboard import Dashboard

__all__ = ["Dashboard"]
