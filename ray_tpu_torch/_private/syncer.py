"""P2P resource/health sync mesh (RaySyncer analog).

The port's copy of ``ray_tpu/_private/syncer.py``: every node agent runs
one, and the head folds the agents' reports
(``_private/node.py`` ``_on_syncer_report``).  Analog of the reference's ``src/ray/common/ray_syncer/ray_syncer.h:88``:
each node keeps a **versioned snapshot** of its own resource view +
liveness and gossips it to a few peers per tick; received snapshots merge
**version-gated** (only a strictly newer version of a node's state is
applied, and only the node itself ever authors its own snapshot).  The
head then consumes a *converged mesh view* — every agent's periodic
``syncer_report`` carries the whole map it has converged on, so the head
is no longer the sole fan-in for every heartbeat: any one agent's report
refreshes the head's liveness/utilization picture of ALL nodes it has
gossiped with, and a broken agent→head link no longer makes that agent
invisible.

Failure detection rides the same exchanges, with two distinct signals:

- **connection refused** while dialing a peer: the peer's listener socket
  is gone, i.e. the process is dead (a SIGKILL closes the socket).  After
  ``REFUSED_DEATH_COUNT`` consecutive refusals the observer records a
  *death* — an objective fact that gossips to everyone and reaches the
  head on the next report, far faster than the head's missed-pong
  timeout.
- **exchange timeout**: the peer accepted TCP (kernel backlog) but never
  answered — a hung/paused (SIGSTOP) process.  After
  ``TIMEOUT_SUSPECT_COUNT`` consecutive timeouts the observer records a
  *suspicion* tagged with its own id; suspicions union as they gossip, so
  the head sees how many distinct peers agree before acting (quorum).

Transport: one-shot TCP exchanges with HMAC-SHA256-signed pickle frames
(the cluster authkey, ``RAY_TPU_TORCH_AUTHKEY``, signs every frame; an unauthenticated or torn frame
is treated as a failed exchange, never a crash).  ``multiprocessing``'s
``Client`` is deliberately not used here — its handshake has no timeout,
and a timeout IS the suspect signal.
"""

from __future__ import annotations

import hmac
import logging
import pickle
import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as events_mod
from ray_tpu_torch._private.locks import make_lock

logger = logging.getLogger(__name__)

# The mesh runs in every node agent (an agent IS the multi-node case);
# single-node sessions never construct a syncer.
DEFAULT_TICK_S = 0.5
DEFAULT_FANOUT = 2
# dial/exchange deadline; also the longest one accept-handler can stall
DEFAULT_TIMEOUT_S = 1.0
# consecutive ECONNREFUSED dials before an observer declares a peer dead
REFUSED_DEATH_COUNT = 2
# consecutive exchange timeouts before an observer suspects a peer hung
TIMEOUT_SUSPECT_COUNT = 3
# head-side: distinct observers that must agree before a suspect is acted on
SUSPECT_QUORUM = 2

_SIG_LEN = 32  # sha256 digest
_MAX_FRAME = 8 << 20


# ---------------------------------------------------------------------------
# framed transport (authkey-signed pickle over a plain socket)
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("syncer peer closed mid-frame")
        buf += chunk
    return buf


def send_frame(sock: socket.socket, authkey: bytes, obj: dict) -> None:
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sig = hmac.new(authkey, body, "sha256").digest()
    sock.sendall(struct.pack("!I", len(body)) + sig + body)


def recv_frame(sock: socket.socket, authkey: bytes) -> dict:
    header = _recv_exact(sock, 4 + _SIG_LEN)
    (n,) = struct.unpack("!I", header[:4])
    if n > _MAX_FRAME:
        raise OSError(f"oversized syncer frame ({n} bytes)")
    body = _recv_exact(sock, n)
    want = hmac.new(authkey, body, "sha256").digest()
    if not hmac.compare_digest(want, header[4:]):
        raise OSError("syncer frame failed authentication")
    return pickle.loads(body)


# ---------------------------------------------------------------------------
# the versioned store
# ---------------------------------------------------------------------------

class SyncerStore:
    """Per-node map of versioned snapshots + death/suspect rumors.

    Merge rules (the RaySyncer invariants):

    - a node's snapshot only ever advances to a strictly NEWER version,
      and only the node itself bumps its own version (``local_update``);
    - a death rumor keeps the EARLIEST observation (first observer wins —
      that timestamp is the detection-latency measurement) and is erased
      by any snapshot authored after it (resurrection-proof);
    - suspicions union per-observer with the freshest timestamp, and are
      erased when the suspect's snapshot advances (it answered someone).
    """

    def __init__(self, node_id: str):
        self.node_id = node_id
        self._lock = make_lock("syncer.store")
        self._snaps: Dict[str, dict] = {}
        self._deaths: Dict[str, dict] = {}       # node -> {"ts", "by"}
        self._suspects: Dict[str, Dict[str, float]] = {}  # node -> {observer: ts}
        self._version = 0

    def local_update(self, payload: Optional[dict] = None) -> dict:
        with self._lock:
            self._version += 1
            snap = dict(payload or {})
            snap.update(node_id=self.node_id, version=self._version,
                        ts=time.time())
            self._snaps[self.node_id] = snap
            # our own liveness trumps any stale rumor about us
            self._deaths.pop(self.node_id, None)
            self._suspects.pop(self.node_id, None)
            return snap

    def get(self, node_id: str) -> Optional[dict]:
        with self._lock:
            snap = self._snaps.get(node_id)
            return dict(snap) if snap else None

    def mark_dead(self, node_id: str, by: str,
                  ts: Optional[float] = None) -> bool:
        """Record a refused-connection death observation; returns True if
        this is news (first observation or earlier than the known one)."""
        if node_id == self.node_id:
            return False
        if ts is None:
            ts = time.time()
        with self._lock:
            cur = self._deaths.get(node_id)
            if cur is not None and cur["ts"] <= ts:
                return False
            self._deaths[node_id] = {"ts": ts, "by": by}
            return True

    def mark_suspect(self, node_id: str, by: str,
                     ts: Optional[float] = None) -> None:
        if node_id == self.node_id:
            return
        if ts is None:
            ts = time.time()
        with self._lock:
            obs = self._suspects.setdefault(node_id, {})
            obs[by] = max(obs.get(by, 0.0), ts)

    def merge(self, snaps: Optional[dict], deaths: Optional[dict] = None,
              suspects: Optional[dict] = None) -> int:
        """Fold a peer's view in; returns how many snapshots advanced."""
        applied = 0
        with self._lock:
            for nid, snap in (snaps or {}).items():
                if nid == self.node_id:
                    continue  # only we author our own state
                cur = self._snaps.get(nid)
                if cur is not None and snap.get("version", 0) <= cur.get("version", 0):
                    continue
                self._snaps[nid] = snap
                applied += 1
                d = self._deaths.get(nid)
                if d is not None and snap.get("ts", 0.0) > d["ts"]:
                    del self._deaths[nid]  # authored after the rumor
                    self._suspects.pop(nid, None)
                elif d is None and nid in self._suspects:
                    self._suspects.pop(nid, None)
            for nid, d in (deaths or {}).items():
                if nid == self.node_id:
                    continue
                snap = self._snaps.get(nid)
                if snap is not None and snap.get("ts", 0.0) > d.get("ts", 0.0):
                    continue  # seen alive after the rumor
                cur = self._deaths.get(nid)
                if cur is None or d["ts"] < cur["ts"]:
                    self._deaths[nid] = dict(d)
            for nid, obs in (suspects or {}).items():
                if nid == self.node_id:
                    continue
                mine = self._suspects.setdefault(nid, {})
                for by, ts in obs.items():
                    mine[by] = max(mine.get(by, 0.0), ts)
        return applied

    def snapshot(self) -> Tuple[dict, dict, dict]:
        """(snaps, deaths, suspects) copies — what gossip/report ships."""
        with self._lock:
            return (
                {k: dict(v) for k, v in self._snaps.items()},
                {k: dict(v) for k, v in self._deaths.items()},
                {k: dict(v) for k, v in self._suspects.items()},
            )

    def prune(self, keep: set) -> None:
        """Drop entries for nodes no longer in the peer directory — the
        head's membership view bounds the store (no unbounded rumor
        accumulation as nodes churn)."""
        keep = set(keep) | {self.node_id}
        with self._lock:
            for table in (self._snaps, self._deaths, self._suspects):
                for nid in [n for n in table if n not in keep]:
                    del table[nid]


# ---------------------------------------------------------------------------
# the per-node syncer
# ---------------------------------------------------------------------------

class ResourceSyncer:
    """One node's corner of the mesh: a listener serving push-pull gossip
    exchanges, a gossip loop dialing ``fanout`` random peers per tick,
    and (optionally) a per-tick ``report_fn`` shipping the converged view
    to the head.

    ``state_fn`` builds this node's own snapshot payload each tick
    (resources + host stats); it must be cheap — it runs at tick cadence.
    """

    def __init__(
        self,
        node_id: str,
        authkey: bytes,
        state_fn: Callable[[], dict],
        report_fn: Optional[Callable[[dict], None]] = None,
        host: str = "127.0.0.1",
        tick_s: Optional[float] = None,
        fanout: Optional[int] = None,
        timeout_s: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        self.node_id = node_id
        self.authkey = authkey
        self.store = SyncerStore(node_id)
        self._state_fn = state_fn
        self._report_fn = report_fn
        self._tick = tick_s if tick_s is not None else DEFAULT_TICK_S
        self._fanout = fanout if fanout is not None else DEFAULT_FANOUT
        self._timeout = timeout_s if timeout_s is not None else DEFAULT_TIMEOUT_S
        # seeded per-instance: gossip partner choice must be reproducible
        # under a chaos schedule's seed (and never touches urandom per tick)
        self._rng = random.Random(seed if seed is not None
                                  else sum(node_id.encode()))
        self._peers_lock = make_lock("syncer.peers")
        self._peers: Dict[str, Tuple[str, int]] = {}
        self._fail: Dict[str, Dict[str, int]] = {}
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(16)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ResourceSyncer":
        self.store.local_update(self._safe_state())
        for name, target in (("syncer-accept", self._accept_loop),
                             ("syncer-gossip", self._gossip_loop)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- membership ----------------------------------------------------
    def set_peers(self, peers: Dict[str, Tuple[str, int]]) -> None:
        """Replace the peer directory (the head broadcasts it on every
        membership change); the store prunes to the new membership."""
        peers = {nid: tuple(addr) for nid, addr in peers.items()
                 if nid != self.node_id}
        with self._peers_lock:
            self._peers = peers
            for nid in [n for n in self._fail if n not in peers]:
                del self._fail[nid]
        self.store.prune(set(peers))

    def peers(self) -> Dict[str, Tuple[str, int]]:
        with self._peers_lock:
            return dict(self._peers)

    # -- serving side --------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed (stop)
            t = threading.Thread(target=self._serve_exchange, args=(conn,),
                                 daemon=True, name="syncer-exchange")
            t.start()

    def _serve_exchange(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(self._timeout)
                msg = recv_frame(conn, self.authkey)
                mtype = msg.get("type")
                if mtype == "syncer_sync":
                    self.store.merge(msg.get("snaps"), msg.get("deaths"),
                                     msg.get("suspects"))
                    snaps, deaths, suspects = self.store.snapshot()
                    send_frame(conn, self.authkey, {
                        "type": "syncer_sync_reply", "from": self.node_id,
                        "snaps": snaps, "deaths": deaths,
                        "suspects": suspects,
                    })
                else:
                    logger.warning("syncer: unknown exchange type %s", mtype)
        except (OSError, EOFError, pickle.UnpicklingError):
            pass  # torn/unauthenticated exchange: the dialer's problem

    # -- dialing side --------------------------------------------------
    def _gossip_loop(self) -> None:
        while not self._stop.wait(self._tick):
            try:
                self.store.local_update(self._safe_state())
                for nid, addr in self._pick_partners():
                    self._gossip_once(nid, addr)
                if self._report_fn is not None:
                    snaps, deaths, suspects = self.store.snapshot()
                    self._report_fn({"snaps": snaps, "deaths": deaths,
                                     "suspects": suspects})
            except Exception:
                logger.exception("syncer gossip tick failed")

    def _safe_state(self) -> dict:
        try:
            return dict(self._state_fn() or {})
        except Exception:
            return {}

    def _pick_partners(self) -> List[Tuple[str, Tuple[str, int]]]:
        with self._peers_lock:
            items = list(self._peers.items())
        if len(items) <= self._fanout:
            return items
        return self._rng.sample(items, self._fanout)

    def _gossip_once(self, nid: str, addr: Tuple[str, int]) -> None:
        try:
            sock = socket.create_connection(addr, timeout=self._timeout)
        except ConnectionRefusedError:
            self._on_refused(nid)
            return
        except OSError:
            self._on_timeout(nid)
            return
        try:
            with sock:
                sock.settimeout(self._timeout)
                snaps, deaths, suspects = self.store.snapshot()
                send_frame(sock, self.authkey, {
                    "type": "syncer_sync", "from": self.node_id,
                    "snaps": snaps, "deaths": deaths, "suspects": suspects,
                })
                reply = recv_frame(sock, self.authkey)
                self.store.merge(reply.get("snaps"), reply.get("deaths"),
                                 reply.get("suspects"))
        except (OSError, EOFError, pickle.UnpicklingError):
            self._on_timeout(nid)
            return
        with self._peers_lock:
            self._fail.pop(nid, None)

    def _fail_slot(self, nid: str) -> Dict[str, int]:
        with self._peers_lock:
            return self._fail.setdefault(nid, {"refused": 0, "timeout": 0})

    def _on_refused(self, nid: str) -> None:
        # >= not ==: counters only reset on a successful exchange, and a
        # flappy peer can erase the rumor (one authored snapshot) without
        # ever answering THIS observer's dial — at == the counter sails
        # past the threshold once and the observer can never re-detect
        slot = self._fail_slot(nid)
        slot["refused"] += 1
        if slot["refused"] >= REFUSED_DEATH_COUNT:
            if self.store.mark_dead(nid, by=self.node_id):
                events_mod.emit(
                    "syncer", "peer connection refused; marking dead",
                    severity="WARNING", entity_id=nid,
                    observer=self.node_id, refusals=slot["refused"])

    def _on_timeout(self, nid: str) -> None:
        slot = self._fail_slot(nid)
        slot["timeout"] += 1
        if slot["timeout"] >= TIMEOUT_SUSPECT_COUNT:
            # mark every tick past the threshold (re-establishes a
            # suspicion the suspect's own gossip erased); emit only on
            # the first crossing so the recorder isn't spammed per tick
            self.store.mark_suspect(nid, by=self.node_id)
            if slot["timeout"] == TIMEOUT_SUSPECT_COUNT:
                events_mod.emit(
                    "syncer", "peer unresponsive; marking suspect",
                    severity="WARNING", entity_id=nid,
                    observer=self.node_id, timeouts=slot["timeout"])
