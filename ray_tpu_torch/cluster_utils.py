"""Multi-node cluster harness for tests.

The port's copy of ``ray_tpu/cluster_utils.py``, analog of the
reference's ``python/ray/cluster_utils.py:99`` ``Cluster`` (``add_node``
at ``:165``):

- default mode: multiple raylet node-states with distinct ids/resources
  inside one head process, so scheduling spread, placement-group
  strategies, node affinity and node-death behavior are testable on one
  machine;
- ``real_processes=True``: each added node is a real
  :mod:`ray_tpu_torch._private.node_agent` subprocess joining over TCP
  with its own worker pool and a private shm directory under ``/dev/shm``
  (prefix ``rtpt-``) — objects move between nodes only through the
  object-transfer plane.

A node holds ``num_gpus`` cards (ids ``0..num_gpus-1``, 0 by default).  On
a host with one card, give it to one node only: the head and an agent
that both count card 0 would both grant it.
"""

from __future__ import annotations

import itertools
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
        real_processes: bool = False,
    ):
        self._node_counter = itertools.count(1)
        self.node_ids: List[str] = []
        self.real_processes = real_processes
        self.agents: Dict[str, subprocess.Popen] = {}
        self._agent_dirs: List[str] = []
        if initialize_head:
            ray_tpu_torch.init(**dict(head_node_args or {}))
            self.node_ids.append(global_worker.node._head_node_id)

    def add_node(
        self,
        num_cpus: int = 1,
        num_gpus: int = 0,
        resources: Optional[Dict[str, float]] = None,
        env: Optional[Dict[str, str]] = None,
        wait: bool = True,
        slice_id: Optional[str] = None,
    ) -> str:
        node = global_worker.node
        node_id = f"node-{next(self._node_counter)}"
        if not self.real_processes:
            total = dict(resources or {})
            total["CPU"] = float(num_cpus)
            total["GPU"] = float(num_gpus)
            node.add_node_state(node_id, total, gpu_ids=list(range(num_gpus)),
                                env=env, slice_id=slice_id)
            self.node_ids.append(node_id)
            return node_id

        from ray_tpu_torch._private.node_agent import start_agent

        proc, shm_sub = start_agent(node, node_id, num_cpus=num_cpus,
                                    num_gpus=num_gpus, resources=resources,
                                    env=env, slice_id=slice_id)
        self._agent_dirs.append(shm_sub)
        self.agents[node_id] = proc
        if wait:
            deadline = time.time() + 30
            while time.time() < deadline:
                with node.lock:
                    if node_id in node.nodes and node.nodes[node_id].alive:
                        break
                if proc.poll() is not None:
                    raise RuntimeError(f"node agent {node_id} exited with "
                                       f"code {proc.returncode}")
                time.sleep(0.05)
            else:
                raise TimeoutError(f"node agent {node_id} did not register")
        self.node_ids.append(node_id)
        return node_id

    def remove_node(self, node_id: str) -> None:
        proc = self.agents.pop(node_id, None)
        if proc is not None:
            proc.kill()  # head notices the dropped agent connection
            proc.wait()
            deadline = time.time() + 15
            node = global_worker.node
            while time.time() < deadline:
                with node.lock:
                    ns = node.nodes.get(node_id)
                    if ns is None or not ns.alive:
                        return
                time.sleep(0.05)
            return
        global_worker.node.remove_node_state(node_id)

    def shutdown(self) -> None:
        ray_tpu_torch.shutdown()
        for proc in self.agents.values():
            try:
                proc.kill()
                proc.wait()
            except Exception:
                pass
        self.agents.clear()
        for d in self._agent_dirs:
            shutil.rmtree(d, ignore_errors=True)
