"""GCP card-host node provider — the cloud path.

The port's counterpart of ``ray_tpu/autoscaler/gcp_tpu.py``
(``GCPTPUNodeProvider``).  Where the JAX provider creates TPU VMs through
``gcloud compute tpus tpu-vm``, this one manages plain Compute Engine VMs
that carry cards, through ``gcloud compute instances`` with
``--machine-type`` and ``--accelerator type=<accelerator_type>,count=<n>``
(the reference's ``GCPCompute`` node, ``autoscaler/_private/gcp/node.py``,
with ``guestAccelerators``).  One VM is one provider node; its agent
registers the cards it sees.

The contract is the JAX provider's: it needs the ``gcloud`` CLI and
credentials on the head and raises at construction without them (or
without a required key) rather than failing mid-scale; nodes are named
``ray-tpu-torch-<cluster>-<n>``; a batch is created all or nothing; a
delete that fails is swallowed; the startup script exports the node's
name as ``RAY_TPU_TORCH_SLICE_ID``, which the node agent reports as its
slice, so the autoscaler's slice index keys on the provider node.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Dict, List

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

# instance states that hold (or will hold) capacity; STOPPING, SUSPENDED
# and TERMINATED ones do not
_LIVE_STATES = ("PROVISIONING", "STAGING", "RUNNING")


class GCPGPUNodeProvider(NodeProvider):
    """provider_config: {project, zone, machine_type (e.g.
    "a3-highgpu-1g"), accelerator_type (e.g. "nvidia-h100-80gb"),
    accelerator_count (default 1), image_family, image_project (both
    optional), startup_script}."""

    def __init__(self, provider_config: dict, cluster_name: str = "default"):
        super().__init__(provider_config, cluster_name)
        if shutil.which("gcloud") is None:
            raise RuntimeError(
                "GCPGPUNodeProvider needs the gcloud CLI with Compute Engine "
                "access; use LocalNodeProvider for single-host clusters"
            )
        for key in ("project", "zone", "machine_type", "accelerator_type"):
            if key not in provider_config:
                raise ValueError(f"provider_config missing {key!r}")
        self._counter = 0

    def _gcloud(self, verb: str, *args: str) -> str:
        # ``instances list`` scopes by ``--zones``; the per-instance verbs
        # take ``--zone``
        zone_flag = "--zones" if verb == "list" else "--zone"
        cmd = [
            "gcloud", "compute", "instances", verb, *args,
            "--project", self.provider_config["project"],
            zone_flag, self.provider_config["zone"],
            "--format", "json",
        ]
        return subprocess.check_output(cmd, text=True)

    def _prefix(self) -> str:
        return f"ray-tpu-torch-{self.cluster_name}-"

    def non_terminated_nodes(self) -> List[str]:
        out = json.loads(self._gcloud("list"))
        return [
            n["name"].rsplit("/", 1)[-1]
            for n in out
            if n["name"].rsplit("/", 1)[-1].startswith(self._prefix())
            and n.get("status") in _LIVE_STATES
        ]

    def is_running(self, node_id: str) -> bool:
        try:
            n = json.loads(self._gcloud("describe", node_id))
        except subprocess.CalledProcessError:
            return False
        return n.get("status") == "RUNNING"

    def create_node(self, node_config: Dict, count: int = 1) -> List[str]:
        """All-or-nothing batch: if the i-th VM's creation fails (quota,
        no cards in the zone), the i−1 already-created VMs of THIS batch
        are deleted and the error propagates — a partial provision would
        read as fleet capacity that can't actually hold the demand that
        triggered the launch.  The failed name itself is also deleted
        best-effort (the API can leave a half-created instance behind)."""
        cfg = self.provider_config
        created: List[str] = []
        for _ in range(count):
            self._counter += 1
            name = f"{self._prefix()}{self._counter}"
            args = [
                name,
                "--machine-type", cfg["machine_type"],
                "--accelerator",
                f"type={cfg['accelerator_type']},"
                f"count={int(cfg.get('accelerator_count', 1))}",
                # a VM with cards cannot live-migrate
                "--maintenance-policy", "TERMINATE",
            ]
            for key, flag in (("image_family", "--image-family"),
                              ("image_project", "--image-project")):
                if cfg.get(key):
                    args += [flag, cfg[key]]
            script = cfg.get("startup_script")
            if script:
                # the node's agent joins the head tagged with this provider
                # node as its slice_id — the autoscaler's head-side slice
                # index (idle reasoning, repair) keys on it
                script = f"export RAY_TPU_TORCH_SLICE_ID={name}\n{script}"
                args += ["--metadata", f"startup-script={script}"]
            try:
                self._gcloud("create", *args)
            except subprocess.CalledProcessError:
                for partial in (*created, name):  # rollback, newest last
                    self.terminate_node(partial)
                raise
            created.append(name)
        return created

    def terminate_node(self, node_id: str) -> None:
        try:
            self._gcloud("delete", node_id, "--quiet")
        except subprocess.CalledProcessError:
            pass
