"""Local provider: worker "nodes" are node_agent subprocesses on this host.

The port's copy of ``ray_tpu/autoscaler/local_node_provider.py``: each
agent holds ``node_config["num_gpus"]`` cards (``--num-gpus``, 0 by
default) and a private shm directory (prefix ``rtpt-``).

The testing role of the reference's ``FakeMultiNodeProvider``
(``autoscaler/_private/fake_multi_node/node_provider.py:237``) — but the
nodes are *real* processes joining over TCP with private shm namespaces,
so the whole autoscaler loop runs against the production join path.

Slice mode (``provider_config={"slice_hosts": N}`` or per-call
``node_config["slice_hosts"]``): one provider node is a whole emulated
slice — N agent processes sharing a ``slice_id``, provisioned
and terminated as ONE unit.  A spawn failure mid-slice rolls back the
hosts already started (a half slice can never hold a gang) and raises.
"""

from __future__ import annotations

import itertools
import subprocess
from typing import Dict, List, Optional

from ray_tpu_torch._private.node_agent import start_agent
from ray_tpu_torch.autoscaler.node_provider import NodeProvider


class LocalNodeProvider(NodeProvider):
    def __init__(self, head_node, provider_config=None, cluster_name="default"):
        super().__init__(provider_config, cluster_name)
        self.head = head_node
        self._counter = itertools.count(1)
        self.procs: Dict[str, subprocess.Popen] = {}  # host node id -> proc
        self.slices: Dict[str, List[str]] = {}        # slice id -> host ids
        self._dirs: List[str] = []

    def non_terminated_nodes(self) -> List[str]:
        plain = [nid for nid, p in self.procs.items()
                 if p.poll() is None and not self._slice_of(nid)]
        # a slice counts as non-terminated while ANY member lives: a
        # degraded slice still holds fleet capacity (and is exactly what
        # replace_slice exists for) — it vanishes only when terminated
        slices = [sid for sid, members in self.slices.items()
                  if any(self.procs[m].poll() is None
                         for m in members if m in self.procs)]
        return plain + slices

    def _slice_of(self, host_id: str) -> Optional[str]:
        for sid, members in self.slices.items():
            if host_id in members:
                return sid
        return None

    def is_running(self, node_id: str) -> bool:
        members = self.slice_members(node_id)
        return bool(members) and all(
            m in self.procs and self.procs[m].poll() is None
            for m in members)

    def slice_members(self, node_id: str) -> List[str]:
        return list(self.slices.get(node_id, [node_id]))

    def create_node(self, node_config: Dict, count: int = 1) -> List[str]:
        out = []
        hosts = int(node_config.get(
            "slice_hosts", self.provider_config.get("slice_hosts", 1)))
        for _ in range(count):
            n = next(self._counter)
            if hosts <= 1:
                node_id = f"auto-{self.cluster_name}-{n}"
                self.procs[node_id] = self._spawn_agent(node_id, node_config)
                out.append(node_id)
                continue
            # one provider node = one slice of `hosts` agents that live
            # and die together
            slice_id = f"slice-{self.cluster_name}-{n}"
            members: List[str] = []
            try:
                for h in range(hosts):
                    host_id = f"{slice_id}-h{h}"
                    self.procs[host_id] = self._spawn_agent(
                        host_id, node_config, slice_id=slice_id)
                    members.append(host_id)
            except OSError:
                # partial provision: a half slice can never hold the
                # gang — roll the started hosts back and surface the
                # failure instead of leaking a useless fragment
                for host_id in members:
                    self._kill_host(host_id)
                raise
            self.slices[slice_id] = members
            out.append(slice_id)
        return out

    def _spawn_agent(self, node_id: str, node_config: Dict,
                     slice_id: Optional[str] = None) -> subprocess.Popen:
        proc, shm_sub = start_agent(
            self.head, node_id, num_cpus=int(node_config.get("num_cpus", 1)),
            num_gpus=int(node_config.get("num_gpus", 0)), slice_id=slice_id)
        self._dirs.append(shm_sub)
        return proc

    def _kill_host(self, host_id: str) -> None:
        p = self.procs.pop(host_id, None)
        if p is not None:
            try:
                p.kill()
                p.wait()
            except Exception:
                pass

    def terminate_node(self, node_id: str) -> None:
        # slice-atomic: ALL member hosts die together, never a subset
        for host_id in self.slice_members(node_id):
            self._kill_host(host_id)
        self.slices.pop(node_id, None)

    def shutdown(self) -> None:
        super().shutdown()
        import shutil

        for d in self._dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._dirs.clear()
