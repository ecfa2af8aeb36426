"""Multi-tenant client proxy (reference ``ray.util.client`` +
``util/client/server/proxier.py`` analog).

``ProxyServer`` (``proxier.py``) is a head-adjacent server that accepts
``ray_tpu_torch.init("ray_tpu_torch://host:port", namespace=...)`` connections and
spawns one ISOLATED driver subprocess per connection (``driver.py``).
The subprocess owns the tenant's whole control-plane presence: its own
job id, namespace, flight-recorder identity, and — critically — its own
pid, so one tenant's driver can die (or be chaos-killed) without touching
the proxy or any other tenant.  Driver death or client disconnect reaps
the subprocess, and the head releases everything the job owned
(non-detached actors, named-actor entries, object pins).
"""

from ray_tpu_torch.util.client.proxier import ProxyServer

__all__ = ["ProxyServer"]
