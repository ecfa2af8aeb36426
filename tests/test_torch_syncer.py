"""The P2P resource/health sync mesh on the port's runtime
(``ray_tpu_torch/_private/syncer.py`` and the head's ``_on_syncer_report``),
mirrored by name from the JAX package's ``tests/test_syncer.py``.

Unit half: the versioned-snapshot store's merge invariants and the signed
framed transport, each case fed the same inputs through
``ray_tpu._private.syncer`` (no JAX in it) and the port's module, with the
results asserted equal.  Mesh half: real in-process syncers converging
over sockets.  Cluster half: agents of a port ``Cluster`` run the mesh
without opt-in, a SIGSTOPPED agent is removed by peer suspect quorum well
before the missed-pong timeout, and a node whose head link drops every
message survives through its peers' reports.

Each test has its own time limit (``LIMIT_S``): a test past it fails
instead of holding up the run.  No JAX head starts.
"""

import os
import signal
import socket
import time

import pytest

from ray_tpu_torch._private import events
from ray_tpu_torch._private import syncer as port_syncer
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.cluster_utils import Cluster

AUTHKEY = b"test-authkey"
T0 = 1_700_000_000.0

LIMIT_S = {"test_mesh_on_by_default_and_head_folds_reports": 90,
           "test_sigstop_removed_by_suspect_quorum_before_pong_timeout": 120,
           "test_lossy_head_link_survives_via_peer_reports": 120}


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail the test (SIGALRM in the main thread) once it runs past its
    limit: 60 s unless ``LIMIT_S`` names another."""
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its "
                           f"{LIMIT_S.get(request.node.name, 60)} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S.get(request.node.name, 60))
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(params=["jax_package", "port"])
def syncer_mod(request):
    if request.param == "port":
        return port_syncer
    from ray_tpu._private import syncer

    return syncer


def _both(fn):
    """``fn(module)`` through the JAX package's syncer and the port's."""
    from ray_tpu._private import syncer as jax_syncer

    return fn(jax_syncer), fn(port_syncer)


# ---------------------------------------------------------------------------
# store invariants
# ---------------------------------------------------------------------------

def _version_gating(m):
    a = m.SyncerStore("a")
    a.local_update({"x": 1})
    a.local_update({"x": 2})
    out = [a.get("a")["version"]]
    b = m.SyncerStore("b")
    out.append(b.merge({"a": dict(a.get("a"))}))
    stale = dict(a.get("a"))
    stale["version"] = 1
    stale["x"] = 99
    out.append(b.merge({"a": stale}))
    out.append(b.get("a")["x"])
    b.merge({"b": {"node_id": "b", "version": 100, "ts": T0}})
    out.append(b.get("b"))
    return out


def test_store_version_gating():
    jax_out, port_out = _both(_version_gating)
    assert port_out == jax_out
    # v2 folded once, a stale v1 replay not applied, and nobody but the
    # node itself authors its own snapshot
    assert port_out == [2, 1, 0, 2, None]


def _rumors(m):
    s = m.SyncerStore("w")
    out = [s.mark_dead("x", by="a", ts=T0 + 5), s.mark_dead("x", by="b", ts=T0 + 1),
           s.mark_dead("x", by="c", ts=T0 + 9), s.snapshot()[1]]
    s.merge({"x": {"node_id": "x", "version": 7, "ts": T0 + 30}})
    out.append(s.snapshot()[1])
    s.mark_dead("x", by="a", ts=T0 + 60)
    s.merge(None, deaths={"x": {"ts": T0 + 60, "by": "a"}})
    out.append(s.snapshot()[1])
    return out


def test_death_rumor_first_observer_wins_and_resurrection_erases():
    jax_out, port_out = _both(_rumors)
    assert port_out == jax_out
    news5, news1, news9, first, resurrected, again = port_out
    assert (news5, news1, news9) == (True, True, False)
    assert first["x"] == {"ts": T0 + 1, "by": "b"}  # the earliest observation
    assert "x" not in resurrected  # a snapshot authored after the rumor
    assert again["x"]["by"] == "a"  # an older snapshot does not erase it


def _suspects(m):
    s = m.SyncerStore("w")
    s.mark_suspect("x", by="a", ts=1.0)
    s.merge(None, suspects={"x": {"b": 2.0, "a": 0.5}})
    out = [s.snapshot()[2]]
    s.merge({"x": {"node_id": "x", "version": 3, "ts": T0}})
    out.append(s.snapshot()[2])
    return out


def test_suspect_union_and_clear_on_progress():
    jax_out, port_out = _both(_suspects)
    assert port_out == jax_out
    union, cleared = port_out
    assert union == {"x": {"a": 1.0, "b": 2.0}}  # freshest per observer
    assert "x" not in cleared


def _prune(m):
    s = m.SyncerStore("w")
    s.merge({"x": {"node_id": "x", "version": 1, "ts": 1.0}})
    s.mark_dead("y", by="w")
    s.mark_suspect("z", by="w")
    s.local_update()
    s.prune({"x"})
    snaps, deaths, suspects = s.snapshot()
    return sorted(snaps), deaths, suspects


def test_store_prune_to_membership():
    jax_out, port_out = _both(_prune)
    assert port_out == jax_out
    assert port_out == (["w", "x"], {}, {})  # own entry always kept


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

def test_frame_signature_rejects_tamper_and_wrong_key(syncer_mod):
    """Frames pass between the two packages' modules in both directions
    (the same wire), and a frame under another key is refused."""
    from ray_tpu._private import syncer as jax_syncer

    a, b = socket.socketpair()
    try:
        syncer_mod.send_frame(a, AUTHKEY, {"type": "syncer_sync", "n": 1})
        assert jax_syncer.recv_frame(b, AUTHKEY)["n"] == 1
        jax_syncer.send_frame(a, AUTHKEY, {"type": "syncer_sync", "n": 2})
        assert syncer_mod.recv_frame(b, AUTHKEY)["n"] == 2

        syncer_mod.send_frame(a, b"wrong-key", {"type": "syncer_sync"})
        with pytest.raises(OSError, match="authentication"):
            syncer_mod.recv_frame(b, AUTHKEY)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# in-process mesh (no cluster)
# ---------------------------------------------------------------------------

def _mesh(n, tick_s=0.05):
    syncers = [
        port_syncer.ResourceSyncer(f"m{i}", AUTHKEY, state_fn=lambda i=i: {"i": i},
                                   tick_s=tick_s, seed=i).start()
        for i in range(n)
    ]
    directory = {s.node_id: s.addr for s in syncers}
    for s in syncers:
        s.set_peers(directory)
    return syncers


def _stop_all(syncers):
    for s in syncers:
        s.stop()


def test_mesh_converges_to_full_view():
    syncers = _mesh(8)
    try:
        deadline = time.time() + 20
        while time.time() < deadline:
            views = [set(s.store.snapshot()[0]) for s in syncers]
            if all(len(v) == 8 for v in views):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"mesh never converged: {[len(v) for v in views]}")
        assert all(s.store.get("m3")["i"] == 3 for s in syncers)
    finally:
        _stop_all(syncers)


def test_dead_peer_detected_by_refused_dials_and_rumor_gossips():
    syncers = _mesh(4)
    try:
        victim = syncers[0]
        deadline = time.time() + 20
        while time.time() < deadline:  # converge first
            if all(len(s.store.snapshot()[0]) == 4 for s in syncers):
                break
            time.sleep(0.05)
        victim.stop()  # closes the listener: dials now get ECONNREFUSED
        # first-observer-wins: every store ends with the single EARLIEST
        # observation time
        deadline = time.time() + 20
        while time.time() < deadline:
            deaths = [s.store.snapshot()[1] for s in syncers[1:]]
            ts = {round(d["m0"]["ts"], 6) for d in deaths if "m0" in d}
            if all("m0" in d for d in deaths) and len(ts) == 1:
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"death rumor never converged: {deaths}")
    finally:
        _stop_all(syncers)


# ---------------------------------------------------------------------------
# real agent clusters (the mesh as deployed)
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh_cluster():
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 1, "num_gpus": 0},
                      real_processes=True)
    yield cluster
    cluster.shutdown()


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}")


def test_mesh_on_by_default_and_head_folds_reports(mesh_cluster):
    """Agents register syncer listeners without any opt-in, and the head
    folds their converged views, version-gated."""
    n1 = mesh_cluster.add_node(num_cpus=1, slice_id="sl-a")
    n2 = mesh_cluster.add_node(num_cpus=1)
    node = global_worker.node
    with node.lock:
        assert node.nodes[n1].syncer_addr is not None
        assert node.nodes[n2].syncer_addr is not None
        assert node.nodes[n1].slice_id == "sl-a"

    _wait(lambda: set(node._syncer_versions) >= {n1, n2},
          30, "mesh reports folding at the head")
    v1 = node._syncer_versions[n1]
    _wait(lambda: node._syncer_versions[n1] > v1,
          30, "version advance (liveness through the mesh)")


def test_sigstop_removed_by_suspect_quorum_before_pong_timeout(mesh_cluster):
    """A paused host keeps its TCP sockets open, so only timeout paths can
    see it.  Peer suspect quorum must beat the head's own 15 s missed-pong
    window."""
    nodes = [mesh_cluster.add_node(num_cpus=1) for _ in range(3)]
    node = global_worker.node
    _wait(lambda: set(node._syncer_versions) >= set(nodes),
          30, "mesh convergence before the pause")

    victim = nodes[0]
    pid = mesh_cluster.agents[victim].pid
    os.kill(pid, signal.SIGSTOP)
    t0 = time.time()
    try:
        _wait(lambda: not node.nodes[victim].alive, 13,
              "suspect-quorum removal")
        elapsed = time.time() - t0
    finally:
        os.kill(pid, signal.SIGCONT)
    timeout_s = node.cfg.health_check_timeout_s
    assert elapsed < timeout_s, (
        f"removal took {elapsed:.1f}s — not faster than the "
        f"{timeout_s:.0f}s heartbeat timeout path")
    # the head emits the removal into its own ring (this process's), the
    # agents their suspicions into the head's table
    evs = [e for e in events.local_events() + node.events.list(limit=5000)
           if e.get("source") == "syncer"]
    assert any(e.get("entity_id") == victim
               and "unresponsive" in e.get("message", "")
               for e in evs), "no syncer suspect/removal event at the head"


def test_lossy_head_link_survives_via_peer_reports(mesh_cluster):
    """Drop every outbound control message of one agent for longer than
    the heartbeat timeout: its pongs and reports vanish, but its gossip
    keeps flowing P2P and its PEERS' reports carry its advancing snapshots
    to the head — so the head keeps it alive."""
    n1 = mesh_cluster.add_node(num_cpus=1)
    n2 = mesh_cluster.add_node(num_cpus=1)
    node = global_worker.node
    _wait(lambda: set(node._syncer_versions) >= {n1, n2},
          30, "mesh convergence before the drop")

    old_timeout = node.cfg.health_check_timeout_s
    node.cfg.health_check_timeout_s = 4.0
    try:
        with node.lock:
            ns = node.nodes[n1]
        ns.agent_send({"type": "chaos_drop", "frac": 1.0, "duration_s": 10.0,
                       "seed": 0})
        # ride out > 2x the (shrunk) timeout inside the drop window
        time.sleep(9.0)
        with node.lock:
            assert node.nodes[n1].alive, (
                "node died during the drop window — the mesh failed to "
                "vouch for it")
    finally:
        node.cfg.health_check_timeout_s = old_timeout
