"""Cluster launcher: ``ray_tpu_torch up / down`` from a YAML spec.

Analog of the reference's ``ray up`` (``python/ray/autoscaler/_private/
commands.py`` + ``command_runner.py``): a cluster YAML names the head and
worker hosts; ``up`` starts the head there, reads its ``tcp://`` address,
and joins every worker host as a node agent; ``down`` tears everything
back down.  Command execution goes through a pluggable runner:

- ``SSHCommandRunner`` — real multi-host clusters over ``ssh`` (the
  reference's path),
- ``LocalCommandRunner`` — runs the same commands through a local shell
  (single-host bring-up and the hermetic test double, the
  ``fake_multi_node`` role).

YAML shape::

    cluster_name: demo
    provider: {type: local}          # or ssh
    auth: {ssh_user: ubuntu, ssh_private_key: ~/.ssh/key.pem}
    head_node: {address: 10.0.0.1, num_cpus: 8, num_gpus: 0}
    worker_nodes:
      - {address: 10.0.0.2, num_cpus: 8, num_gpus: 8}

A head with no ``num_gpus`` counts the cards it sees; on a host that
holds a worker node's cards too, give the head ``num_gpus: 0`` so the two
never claim the same card.  The session record and the logs live under
the temp directory (``$TMPDIR``): ``<tmp>/ray_tpu_torch/last_session.json``
and ``<tmp>/ray_tpu_torch_<cluster>_{head,worker<i>}.log``.  ``down``
kills this cluster's agents (by their ``node-<cluster>-<i>`` ids) and the
head named in this temp directory's session record, nothing else: a
``ray_tpu`` (JAX) head or agent on the same host is left alone, and so is
another port cluster's head; that package's ``down`` leaves these.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional


class CommandRunner:
    """Run a shell command 'on' a host; subclasses decide transport."""

    def run(self, address: str, cmd: str, timeout: float = 300.0) -> str:
        raise NotImplementedError


class LocalCommandRunner(CommandRunner):
    """Execute on this machine (single-host clusters + hermetic tests)."""

    def run(self, address: str, cmd: str, timeout: float = 300.0) -> str:
        proc = subprocess.run(
            ["bash", "-lc", cmd], capture_output=True, text=True,
            timeout=timeout,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"[{address}] command failed ({proc.returncode}): "
                f"{cmd}\n{proc.stderr[-2000:]}")
        return proc.stdout


class SSHCommandRunner(CommandRunner):
    """ssh into each host (the reference's default transport)."""

    def __init__(self, ssh_user: Optional[str] = None,
                 ssh_private_key: Optional[str] = None,
                 ssh_options: Optional[List[str]] = None):
        self.ssh_user = ssh_user
        self.ssh_private_key = ssh_private_key
        self.ssh_options = list(ssh_options or [
            "-o", "StrictHostKeyChecking=no",
            "-o", "ConnectTimeout=15",
        ])

    def run(self, address: str, cmd: str, timeout: float = 300.0) -> str:
        target = f"{self.ssh_user}@{address}" if self.ssh_user else address
        argv = ["ssh", *self.ssh_options]
        if self.ssh_private_key:
            argv += ["-i", self.ssh_private_key]
        argv += [target, cmd]
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"[{address}] ssh command failed ({proc.returncode}): "
                f"{cmd}\n{proc.stderr[-2000:]}")
        return proc.stdout


def _runner_for(config: Dict[str, Any]) -> CommandRunner:
    provider = (config.get("provider") or {}).get("type", "ssh")
    if provider == "local":
        return LocalCommandRunner()
    if provider == "ssh":
        auth = config.get("auth") or {}
        return SSHCommandRunner(
            ssh_user=auth.get("ssh_user"),
            ssh_private_key=auth.get("ssh_private_key"),
            ssh_options=auth.get("ssh_options"),
        )
    raise ValueError(f"unknown provider type {provider!r} (local|ssh)")


def _node_flags(node: Dict[str, Any]) -> str:
    parts = []
    if node.get("num_cpus") is not None:
        parts += ["--num-cpus", str(node["num_cpus"])]
    if node.get("num_gpus") is not None:
        parts += ["--num-gpus", str(node["num_gpus"])]
    return " ".join(parts)


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    if not isinstance(config, dict) or "head_node" not in config:
        raise ValueError(f"{path}: cluster YAML needs at least a head_node")
    return config


def _paths(name: str):
    """(session record, log prefix) under the temp directory."""
    tmp = tempfile.gettempdir()
    return (os.path.join(tmp, "ray_tpu_torch", "last_session.json"),
            os.path.join(tmp, f"ray_tpu_torch_{name}"))


def up(config: Dict[str, Any], runner: Optional[CommandRunner] = None,
       python: str = sys.executable) -> Dict[str, Any]:
    """Start the head, read its session record, join every worker host.
    Returns {"address", "authkey", "workers": [...]} for status/down."""
    runner = runner or _runner_for(config)
    head = config["head_node"]
    head_addr = head.get("address", "127.0.0.1")
    name = config.get("cluster_name", "cluster")
    record, log = _paths(name)

    remote_head = head_addr not in ("127.0.0.1", "localhost")
    # a multi-host head must bind its control plane on all interfaces, or
    # remote workers' dials are refused (the default bind is loopback)
    env_prefix = "RAY_TPU_TORCH_HOST=0.0.0.0 " if remote_head else ""
    head_cmd = (
        # clear any stale session record first — the poll below must see
        # THIS head's record, not a dead predecessor's
        f"rm -f {record}; "
        f"{env_prefix}nohup {shlex.quote(python)} -m ray_tpu_torch start --head "
        f"{_node_flags(head)} {config.get('head_start_extra', '')} "
        f"> {log}_head.log 2>&1 & echo started"
    )
    runner.run(head_addr, head_cmd)

    # the head writes its tcp:// address + authkey to the session record
    session = None
    deadline = time.time() + float(config.get("start_timeout_s", 120))
    while time.time() < deadline:
        try:
            out = runner.run(
                head_addr, f"cat {record}", timeout=30)
            session = json.loads(out)
            break
        except Exception:
            time.sleep(1.0)
    if session is None:
        raise RuntimeError(
            f"head on {head_addr} did not write a session record; see "
            f"{log}_head.log there")
    address = session["address"]
    if remote_head and (address.startswith("tcp://127.")
                        or address.startswith("tcp://0.0.0.0")):
        # the record names a non-routable bind; workers dial the head host
        address = f"tcp://{head_addr}:{address.rsplit(':', 1)[1]}"

    joined = []
    for i, node in enumerate(config.get("worker_nodes") or []):
        addr = node["address"]
        join_cmd = (
            f"nohup {shlex.quote(python)} -m ray_tpu_torch._private.node_agent "
            f"--address {shlex.quote(address[len('tcp://'):])} "
            f"--authkey {session['authkey']} {_node_flags(node)} "
            f"--node-id node-{name}-{i} "
            f"> {log}_worker{i}.log 2>&1 & echo joined"
        )
        runner.run(addr, join_cmd)
        joined.append({"address": addr, "node_id": f"node-{name}-{i}"})
    return {"address": address, "authkey": session["authkey"],
            "workers": joined, "head_address": head_addr}


def down(config: Dict[str, Any], runner: Optional[CommandRunner] = None) -> None:
    """Stop agents and the head on every host in the YAML.  Patterns use
    the ``[.]`` char-class trick so the kill command's own shell never
    matches them; the head is killed by the pid in its session record
    only, never by a pattern, so another port cluster's head on the host
    (another temp directory, another checkout) survives."""
    runner = runner or _runner_for(config)
    name = config.get("cluster_name", "cluster")
    record, _ = _paths(name)
    # scope the kill to THIS cluster's agents (up() names them
    # node-<cluster>-<i>) so co-hosted clusters survive a neighbor's down
    kill_agents = (
        f"pkill -f 'ray_tpu_torch[.]_private[.]node_agent.*node-{name}-' || true"
    )
    # kill by the session-record pid, but ONLY if that pid's cmdline is
    # really a launched head — a stale record can name an unrelated (or
    # the calling!) process, and `ray down` must never kill those
    kill_head = (
        "kill $(python3 - <<'PYEOF'\n"
        "import json\n"
        "try:\n"
        f"    pid = json.load(open({record!r}))['pid']\n"
        "    cmd = open(f'/proc/{pid}/cmdline', 'rb').read().decode()\n"
        "    cmd = cmd.replace(chr(0), ' ')\n"
        "    if 'ray_tpu_torch' in cmd and '--head' in cmd:\n"
        "        print(pid)\n"
        "except Exception:\n"
        "    pass\n"
        "PYEOF\n"
        ") 2>/dev/null || true"
    )
    for node in config.get("worker_nodes") or []:
        try:
            runner.run(node["address"], kill_agents, timeout=60)
        except Exception:
            pass
    head_addr = config["head_node"].get("address", "127.0.0.1")
    try:
        runner.run(head_addr, f"{kill_agents}; {kill_head}", timeout=60)
    except Exception:
        pass
