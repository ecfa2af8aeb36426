"""The port's card-host provider (``ray_tpu_torch/autoscaler/gcp_gpu.py``
``GCPGPUNodeProvider``) against a FAKE ``gcloud``, and against the JAX
package's ``GCPTPUNodeProvider`` under the same scripted failures.

A stub ``gcloud`` on ``PATH`` (this file's own copy of the recording
runner of ``tests/test_gcp_tpu_provider.py``, taught both command
surfaces: ``compute instances`` for the port, ``compute tpus tpu-vm``
for the JAX provider) records every invocation and plays the VMs back
from a JSON file, so no cloud call is ever made.  The five JAX cases by
name, then parity: the sequences of verbs and node names each provider
sends are the same, with the port's names in place of the JAX ones.

Each test has its own time limit; one port head (``num_gpus=0``) for
the autoscaler case, under a private ``TMPDIR``.  No JAX head starts.
"""

import json
import os
import signal
import stat
import subprocess
import tempfile

import pytest

FAKE_GCLOUD = r'''#!/usr/bin/env python3
import json, os, sys

STATE = os.environ["FAKE_GCLOUD_STATE"]


def load():
    try:
        with open(STATE) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"nodes": {}, "calls": []}


def save(s):
    with open(STATE, "w") as f:
        json.dump(s, f)


s = load()
args = sys.argv[1:]
s["calls"].append(args)
if args[:2] == ["compute", "instances"]:       # Compute Engine VMs
    verb, rest, state_key = args[2], args[3:], "status"
    live, path = "RUNNING", "{}"
else:                                          # TPU VMs
    assert args[:3] == ["compute", "tpus", "tpu-vm"], args
    verb, rest, state_key = args[3], args[4:], "state"
    live, path = "READY", "projects/p/zones/z/nodes/{}"
if verb == "create":
    name = rest[0]
    if name in s.get("fail_create", []):
        # injected quota/capacity failure for THIS node name
        save(s)
        sys.exit(1)
    s["nodes"][name] = {"name": path.format(name), state_key: live}
    out = s["nodes"][name]
elif verb == "list":
    out = list(s["nodes"].values())
elif verb == "describe":
    name = rest[0]
    if name not in s["nodes"]:
        save(s)
        sys.exit(1)
    out = s["nodes"][name]
elif verb == "delete":
    s["nodes"].pop(rest[0], None)
    out = {}
else:
    sys.exit(2)
save(s)
print(json.dumps(out))
'''

CONFIG = {"project": "p", "zone": "us-central1-a", "machine_type": "a3-highgpu-1g",
          "accelerator_type": "nvidia-h100-80gb", "accelerator_count": 1}


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = 90

    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture
def fake_gcloud(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "gcloud"
    exe.write_text(FAKE_GCLOUD)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    state = tmp_path / "state.json"
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_GCLOUD_STATE", str(state))
    return state


def _provider(**extra):
    from ray_tpu_torch.autoscaler.gcp_gpu import GCPGPUNodeProvider

    return GCPGPUNodeProvider(dict(CONFIG, **extra), cluster_name="t")


def _jax_provider():
    from ray_tpu.autoscaler.gcp_tpu import GCPTPUNodeProvider

    return GCPTPUNodeProvider(
        {"project": "p", "zone": "us-central2-b",
         "accelerator_type": "v5e-8", "runtime_version": "tpu-vm-v5e"},
        cluster_name="t")


def _calls(state_path):
    return json.loads(state_path.read_text())["calls"]


def _ops(state_path):
    """(verb, name) of every create/delete, either command surface."""
    out = []
    for c in _calls(state_path):
        verb, rest = (c[2], c[3:]) if c[1] == "instances" else (c[3], c[4:])
        if verb in ("create", "delete"):
            out.append((verb, rest[0]))
    return out


def test_pod_slice_create_list_describe_delete(fake_gcloud):
    prov = _provider()
    assert prov.non_terminated_nodes() == []
    created = prov.create_node({}, count=2)
    assert created == ["ray-tpu-torch-t-1", "ray-tpu-torch-t-2"]
    assert sorted(prov.non_terminated_nodes()) == created
    assert prov.is_running("ray-tpu-torch-t-1")
    prov.terminate_node("ray-tpu-torch-t-1")
    assert prov.non_terminated_nodes() == ["ray-tpu-torch-t-2"]
    assert not prov.is_running("ray-tpu-torch-t-1")
    # the stub recorded the exact CLI surface the real cloud would see
    calls = _calls(fake_gcloud)
    create = next(c for c in calls if c[2] == "create")
    assert create[:4] == ["compute", "instances", "create", "ray-tpu-torch-t-1"]
    assert create[create.index("--machine-type") + 1] == "a3-highgpu-1g"
    assert create[create.index("--accelerator") + 1] == "type=nvidia-h100-80gb,count=1"
    assert create[create.index("--maintenance-policy") + 1] == "TERMINATE"
    assert create[create.index("--project") + 1] == "p"
    assert create[create.index("--zone") + 1] == "us-central1-a"
    assert "--image-family" not in create and "--metadata" not in create
    listing = next(c for c in calls if c[2] == "list")
    assert listing[listing.index("--zones") + 1] == "us-central1-a"
    delete = next(c for c in calls if c[2] == "delete")
    assert "--quiet" in delete


def test_autoscaler_scales_tpu_slices(fake_gcloud, monkeypatch):
    """The reconcile loop launches and terminates card hosts through the
    provider when ``"GPU"`` demand appears and disappears.  The VM's
    agent joins tagged with its slice id (what the startup script
    exports); before it joins, the host is launching and is not reaped
    (the port's autoscaler; the JAX one reaps a host that never joined)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.autoscaler.autoscaler import AutoscalingConfig, StandardAutoscaler

    with tempfile.TemporaryDirectory(prefix="gcp_") as d:
        monkeypatch.setenv("TMPDIR", d)
        monkeypatch.setattr(tempfile, "tempdir", d)
        ray_tpu_torch.init(num_cpus=1, num_gpus=0)
        try:
            node = global_worker.node
            prov = _provider()
            scaler = StandardAutoscaler(
                node, prov,
                AutoscalingConfig(min_workers=0, max_workers=2, idle_timeout_s=0.0,
                                  worker_node={"num_gpus": 8}),
            )
            # synthetic pending demand: a card task the head cannot place
            with node.lock:
                node.pending_tasks.append({
                    "task_id": b"x" * 16, "name": "gpu_task", "return_ids": [],
                    "num_returns": 0, "resources": {"GPU": 8.0},
                })
            scaler.update()
            assert prov.non_terminated_nodes(), "no card host launched for GPU demand"
            with node.lock:
                node.pending_tasks.clear()
                node._starved.clear()
            scaler.update()  # demand gone, but the host has not joined yet
            (name,) = prov.non_terminated_nodes()
            node.add_node_state("node-gcp-1", {"CPU": 1.0, "GPU": 8.0},
                                gpu_ids=list(range(8)), slice_id=name)
            scaler.update()  # joined and idle + idle_timeout 0 -> scale back down
            assert prov.non_terminated_nodes() == []
        finally:
            ray_tpu_torch.shutdown()


def test_replace_slice_creates_before_terminating(fake_gcloud):
    prov = _provider()
    old = prov.create_node({}, count=1)[0]
    new = prov.replace_slice(old)
    assert new != old
    assert prov.non_terminated_nodes() == [new]
    ops = _ops(fake_gcloud)
    assert ops.index(("create", new)) < ops.index(("delete", old)), ops


def test_replace_slice_failure_leaves_old_slice_untouched(fake_gcloud):
    prov = _provider()
    old = prov.create_node({}, count=1)[0]
    state = json.loads(fake_gcloud.read_text())
    state["fail_create"] = [f"ray-tpu-torch-t-{prov._counter + 1}"]
    fake_gcloud.write_text(json.dumps(state))

    with pytest.raises(subprocess.CalledProcessError):
        prov.replace_slice(old)
    assert prov.non_terminated_nodes() == [old]
    assert ("delete", old) not in _ops(fake_gcloud)


def test_partial_provision_rolls_back_whole_batch(fake_gcloud):
    prov = _provider()
    fake_gcloud.write_text(json.dumps(
        {"nodes": {}, "calls": [], "fail_create": ["ray-tpu-torch-t-2"]}))

    with pytest.raises(subprocess.CalledProcessError):
        prov.create_node({}, count=3)
    assert prov.non_terminated_nodes() == []
    ops = _ops(fake_gcloud)
    assert ("create", "ray-tpu-torch-t-1") in ops
    assert ("delete", "ray-tpu-torch-t-1") in ops          # rollback
    assert ("delete", "ray-tpu-torch-t-2") in ops          # half-created victim
    assert ("create", "ray-tpu-torch-t-3") not in ops      # stopped at failure


# -- parity with the JAX provider -------------------------------------------

def _script(prov, state_path, fail):
    """One scripted session: a batch of 3 with ``fail`` names failing,
    then a batch of 2, a replace, a replace that fails, a terminate."""
    state = {"nodes": {}, "calls": [], "fail_create": [f"{fail}-2"]}
    state_path.write_text(json.dumps(state))
    try:
        prov.create_node({}, count=3)
    except subprocess.CalledProcessError:
        pass
    state = json.loads(state_path.read_text())
    state["fail_create"] = [f"{fail}-6"]
    state_path.write_text(json.dumps(state))
    a, b = prov.create_node({}, count=2)
    c = prov.replace_slice(a)
    try:
        prov.replace_slice(b)
    except subprocess.CalledProcessError:
        pass
    prov.terminate_node(c)
    prov.terminate_node("never-created")
    return sorted(prov.non_terminated_nodes()), _ops(state_path)


def test_verbs_and_names_equal_the_jax_providers(fake_gcloud):
    ours = _script(_provider(), fake_gcloud, "ray-tpu-torch-t")
    theirs = _script(_jax_provider(), fake_gcloud, "ray-tpu-t")
    rename = lambda n: n.replace("ray-tpu-t-", "ray-tpu-torch-t-")  # noqa: E731
    assert ours[0] == [rename(n) for n in theirs[0]] == ["ray-tpu-torch-t-4"]
    assert ours[1] == [(v, rename(n)) for v, n in theirs[1]]


def test_startup_script_exports_the_slice_id(fake_gcloud):
    """The provider prepends the node's name as its slice id, as the JAX
    one does under its own variable (the port's agent reads
    ``RAY_TPU_TORCH_SLICE_ID``); the boot image is passed when given."""
    _provider(startup_script="echo up", accelerator_count=2, image_family="fam",
              image_project="proj").create_node({}, count=1)
    create = next(c for c in _calls(fake_gcloud) if c[2] == "create")
    assert create[create.index("--metadata") + 1] == (
        "startup-script=export RAY_TPU_TORCH_SLICE_ID=ray-tpu-torch-t-1\necho up")
    assert create[create.index("--accelerator") + 1] == "type=nvidia-h100-80gb,count=2"
    assert create[create.index("--image-family") + 1] == "fam"
    assert create[create.index("--image-project") + 1] == "proj"


def test_construction_raises_like_the_jax_providers(fake_gcloud, monkeypatch):
    from ray_tpu.autoscaler.gcp_tpu import GCPTPUNodeProvider
    from ray_tpu_torch.autoscaler.gcp_gpu import GCPGPUNodeProvider

    for key in ("project", "zone", "machine_type", "accelerator_type"):
        with pytest.raises(ValueError, match=repr(key)):
            GCPGPUNodeProvider({k: v for k, v in CONFIG.items() if k != key})
    monkeypatch.setenv("PATH", "/nonexistent")
    for cls, cfg in ((GCPGPUNodeProvider, CONFIG),
                     (GCPTPUNodeProvider, {"project": "p", "zone": "z",
                                           "accelerator_type": "v5e-8",
                                           "runtime_version": "v"})):
        with pytest.raises(RuntimeError, match="needs the gcloud CLI"):
            cls(cfg)
