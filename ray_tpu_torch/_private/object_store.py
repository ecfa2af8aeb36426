"""Object store: registry + producer/consumer helpers.

Splits the reference's design across the same seams:

- ``ObjectRegistry`` lives in the head process and plays the role of the
  plasma store's directory + ``ObjectLifecycleManager``
  (``src/ray/object_manager/plasma/store.h:55``,
  ``object_lifecycle_manager.h:101``) plus the owner-side
  ``ReferenceCounter`` (``src/ray/core_worker/reference_count.h:61``):
  object id -> location, sealing, sizes, reference counts (handle refs +
  contained-in-object refs + task-spec pins), eviction-by-spilling at the
  ``object_store_memory`` cap (``local_object_manager.h:41`` analog), and
  segment unlinking when the count hits zero.
- Producers (workers/driver) serialize into a fresh shm segment themselves
  and then *seal* it with the registry — the plasma create/seal protocol
  without copying payloads through a socket.
- Small objects are carried inline, the analog of the core worker's
  in-process memory store for direct returns
  (``src/ray/core_worker/store_provider/memory_store/memory_store.h``).

Each consumer process keeps attached segments alive in ``_ATTACHED`` for the
life of the process, like plasma clients holding their mmaps (zero-copy
views of values alias the mapping, so it cannot be unmapped eagerly).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.locks import make_lock
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.shm import ShmSegment, session_shm_name

# Lazy put/get latency histograms (registered on first use; observation is
# skipped entirely when the observability layer is disabled).
_STORE_METRICS = None
# shm puts at least this big get a flight-recorder event (arena/ingest
# pressure visibility without an event per small put)
_PUT_EVENT_MIN_BYTES = 1 << 20
# Payloads below this observe their latency 1:_SMALL_SAMPLE (a histogram
# lock on EVERY inline return/get rides the task hot path; big payloads —
# the interesting tail — always record).  Unlocked counters: a lost race
# just shifts which call samples.
_SMALL_SAMPLE_MAX_BYTES = 64 << 10
_SMALL_SAMPLE = 8
_put_n = 0
_get_n = 0


def _store_metrics():
    global _STORE_METRICS
    if _STORE_METRICS is None:
        from ray_tpu_torch.util.metrics import Histogram

        bounds = [0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5]
        note = " (payloads <64KiB sampled 1:8)"
        _STORE_METRICS = {
            "put": Histogram("ray_tpu_object_put_latency_s",
                             "serialize+store latency per object (s)" + note,
                             boundaries=bounds),
            "get": Histogram("ray_tpu_object_get_latency_s",
                             "attach+deserialize latency per object (s)" + note,
                             boundaries=bounds),
        }
    return _STORE_METRICS


@dataclass
class ObjectLocation:
    """Where an object's payload lives.  Exactly one of inline/shm_name/
    spilled_path is set."""

    inline: Optional[bytes] = None
    shm_name: Optional[str] = None
    spilled_path: Optional[str] = None
    size: int = 0
    # Serialized error objects raise on get (RayTaskError analog).
    is_error: bool = False
    # Which cluster node holds the shm segment ("" = head) and that node's
    # object-server address — consumers on other nodes pull through it
    # (the head fills fetch_addr when serving locations cross-node).
    node_id: str = ""
    fetch_addr: Optional[tuple] = None
    # Native arena backing (plasma analog): the payload is the
    # [arena_off, arena_off+size) slice of the arena file.  shm_name is
    # still set — it names the pulled copy on remote consumers.
    arena_path: Optional[str] = None
    arena_off: int = 0
    # the arena index key (== oid normally; a fresh key when a retried
    # task re-produced a return whose first attempt left an allocation)
    arena_key: Optional[bytes] = None

    def __post_init__(self):
        if self.inline is not None:
            self.size = len(self.inline)

    def __reduce__(self):
        # Locations ride in every seal/location-reply message; positional
        # reconstruction skips dataclass-by-__dict__ pickling (~3x faster,
        # and the common inline case pickles only two live fields).
        return (ObjectLocation, (
            self.inline, self.shm_name, self.spilled_path, self.size,
            self.is_error, self.node_id, self.fetch_addr, self.arena_path,
            self.arena_off, self.arena_key,
        ))


@dataclass
class _Entry:
    """COLD per-object metadata (payload location, owner attribution,
    containment, the waiters' Event).  The HOT per-object state —
    ref_count, per-reason pin counts, the replica location set — lives in
    the session's ref index (C++ ``RefIndex`` in src/store_core, or the
    pure-Python ``_PyRefs`` twin), keyed by the same oid."""

    loc: Optional[ObjectLocation] = None
    sealed: threading.Event = field(default_factory=threading.Event)
    contained: List[bytes] = field(default_factory=list)
    last_access: float = field(default_factory=time.monotonic)
    # ownership audit (`ray memory` analog): who sealed the payload —
    # "driver", a worker id hex, or an actor id hex — plus wall-clock
    # creation time for age.
    owner: Optional[str] = None
    owner_kind: str = "unknown"  # driver | worker | actor | head
    created: float = field(default_factory=time.time)


# ---------------------------------------------------------------------------
# Ref index: the registry's hot maps (refcounts, pin reasons, location sets)
# ---------------------------------------------------------------------------
#
# Pin-reason slots are fixed across the C and Python implementations; the
# audit's pins breakdown is rebuilt from them (an unknown reason folds
# into "other" — lifetime accounting is reason-agnostic either way).
PIN_REASONS = ("handle", "task_arg", "contained", "lineage",
               "pending_demand", "reserved5", "reserved6", "other")
_REASON_IDX = {name: i for i, name in enumerate(PIN_REASONS)}
_OTHER_IDX = len(PIN_REASONS) - 1


def _reason_idx(reason: str) -> int:
    return _REASON_IDX.get(reason, _OTHER_IDX)


def _pins_dict(pins) -> Dict[str, int]:
    return {PIN_REASONS[i]: v for i, v in enumerate(pins) if v > 0}


class _PyRefs:
    """Pure-Python twin of the native RefIndex (store_core.cc) — same
    contract, same slot semantics, used when the toolchain can't build
    the .so or ``RAY_TPU_TORCH_NATIVE_REFS=0`` forces it.  One lock, batch
    methods, erase-at-zero atomic with the decrement."""

    MAX_SLOTS = 64

    def __init__(self):
        self._lock = make_lock("object_store.refs")
        # oid -> [count, pins(list[8]), sealed, origin_slot, replica_mask, rr]
        self._m: Dict[bytes, list] = {}

    def ensure(self, oids, reason: str = "handle") -> None:
        ridx = _reason_idx(reason)
        with self._lock:
            m = self._m
            for oid in oids:
                if oid not in m:
                    pins = [0] * len(PIN_REASONS)
                    pins[ridx] = 1
                    m[oid] = [1, pins, False, -1, 0, 0]

    def contains(self, oid: bytes) -> bool:
        with self._lock:
            return oid in self._m

    def add(self, oids, reason: str, delta: int) -> None:
        ridx = _reason_idx(reason)
        with self._lock:
            m = self._m
            for oid in oids:
                e = m.get(oid)
                if e is not None:
                    e[0] += delta
                    e[1][ridx] += delta

    def remove(self, oids, reason: str, delta: int) -> List[bytes]:
        ridx = _reason_idx(reason)
        dead: List[bytes] = []
        with self._lock:
            m = self._m
            for oid in oids:
                e = m.get(oid)
                if e is None:
                    continue
                e[0] -= delta
                left = e[1][ridx] - delta
                e[1][ridx] = left if left > 0 else 0
                if e[0] <= 0 and e[2]:
                    dead.append(oid)
                    del m[oid]
        return dead

    def seal(self, oid: bytes) -> int:
        with self._lock:
            e = self._m.get(oid)
            if e is None:
                return -1
            e[2] = True
            if e[0] <= 0:
                del self._m[oid]
                return 1
            return 0

    def unseal(self, oid: bytes) -> int:
        with self._lock:
            e = self._m.get(oid)
            if e is None:
                return -1
            e[2] = False
            e[3] = -1
            e[4] = 0
            return 0

    def erase(self, oid: bytes) -> int:
        with self._lock:
            return 0 if self._m.pop(oid, None) is not None else -1

    def get(self, oid: bytes):
        with self._lock:
            e = self._m.get(oid)
            if e is None:
                return None
            return e[0], e[2], list(e[1])

    def get_batch(self, oids):
        counts, pins = [], []
        with self._lock:
            for oid in oids:
                e = self._m.get(oid)
                if e is None:
                    counts.append(None)
                    pins.append([0] * len(PIN_REASONS))
                else:
                    counts.append(e[0])
                    pins.append(list(e[1]))
        return counts, pins

    def size(self) -> int:
        with self._lock:
            return len(self._m)

    # -- location sets --
    def set_origin(self, oid: bytes, slot: int) -> int:
        with self._lock:
            e = self._m.get(oid)
            if e is None:
                return -1
            e[3] = slot
            return 0

    def add_replica(self, oid: bytes, slot: int) -> int:
        if not 0 <= slot < self.MAX_SLOTS:
            return -2
        with self._lock:
            e = self._m.get(oid)
            if e is None:
                return -1
            if slot == e[3] or e[4] & (1 << slot):
                return 0
            e[4] |= 1 << slot
            return 1

    def pop_replica(self, oid: bytes) -> int:
        with self._lock:
            e = self._m.get(oid)
            if e is None or not e[4]:
                return -1
            slot = (e[4] & -e[4]).bit_length() - 1
            e[4] &= e[4] - 1
            return slot

    def num_replicas(self, oid: bytes) -> int:
        with self._lock:
            e = self._m.get(oid)
            return -1 if e is None else bin(e[4]).count("1")

    def replica_mask(self, oid: bytes) -> int:
        with self._lock:
            e = self._m.get(oid)
            return 0 if e is None else e[4]

    def clear_replicas(self, oid: bytes) -> int:
        with self._lock:
            e = self._m.get(oid)
            if e is None:
                return -1
            e[4] = 0
            return 0

    def drop_slot(self, slot: int) -> None:
        mask = ~(1 << slot)
        with self._lock:
            for e in self._m.values():
                e[4] &= mask

    def locate(self, oids, prefer_slot: int) -> List[int]:
        out = []
        with self._lock:
            for oid in oids:
                e = self._m.get(oid)
                if e is None:
                    out.append(-2)
                    continue
                mask = e[4]
                if not mask:
                    out.append(-1)
                    continue
                if prefer_slot >= 0:
                    if prefer_slot == e[3]:
                        out.append(-1)
                        continue
                    if mask & (1 << prefer_slot):
                        out.append(prefer_slot)
                        continue
                n_rep = bin(mask).count("1")
                idx = e[5] % (1 + n_rep)
                e[5] += 1
                if idx == 0:
                    out.append(-1)
                    continue
                m = mask
                for _ in range(idx - 1):
                    m &= m - 1
                out.append((m & -m).bit_length() - 1)
        return out

    def clear(self) -> None:
        with self._lock:
            self._m.clear()


class _NativeRefs:
    """GIL-released C ref index.  Batch calls pack 16-byte oids into one
    contiguous buffer (one mutex hop per message); the rare odd-size id
    (tests, fixed sentinel ids) routes to an embedded pure-Python twin so
    the contract holds for every key."""

    def __init__(self):
        from ray_tpu_torch._private import native

        self._ix = native.RefIndex()
        self._odd = _PyRefs()

    @staticmethod
    def _split(oids):
        """(packed-16B-bytes, n16, odd-list) preserving per-group order."""
        n = len(oids)
        if all(len(o) == 16 for o in oids):
            # total-length alone can't gate this: a mixed batch (8B+24B)
            # sums to n*16 and would re-chunk into garbage keys
            return b"".join(oids), n, ()
        std = [o for o in oids if len(o) == 16]
        odd = [o for o in oids if len(o) != 16]
        return b"".join(std), len(std), odd

    def ensure(self, oids, reason: str = "handle") -> None:
        packed, n, odd = self._split(oids)
        if n:
            self._ix.ensure(packed, n, _reason_idx(reason))
        if odd:
            self._odd.ensure(odd, reason)

    def contains(self, oid: bytes) -> bool:
        if len(oid) == 16:
            return self._ix.contains(oid)
        return self._odd.contains(oid)

    def add(self, oids, reason: str, delta: int) -> None:
        packed, n, odd = self._split(oids)
        if n:
            self._ix.add(packed, n, _reason_idx(reason), delta)
        if odd:
            self._odd.add(odd, reason, delta)

    def remove(self, oids, reason: str, delta: int) -> List[bytes]:
        packed, n, odd = self._split(oids)
        dead: List[bytes] = []
        if n:
            dead = self._ix.remove(packed, n, _reason_idx(reason), delta)
        if odd:
            dead.extend(self._odd.remove(odd, reason, delta))
        return dead

    def seal(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.seal(oid)
        return self._odd.seal(oid)

    def unseal(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.unseal(oid)
        return self._odd.unseal(oid)

    def erase(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.erase(oid)
        return self._odd.erase(oid)

    def get(self, oid: bytes):
        if len(oid) == 16:
            return self._ix.get(oid)
        return self._odd.get(oid)

    def get_batch(self, oids):
        packed, n, odd = self._split(oids)
        if not odd:
            return self._ix.get_batch(packed, n) if n else ([], [])
        # mixed batch (audit pages): per-oid lookups keep row order
        counts, pins = [], []
        for oid in oids:
            got = self.get(oid)
            if got is None:
                counts.append(None)
                pins.append([0] * len(PIN_REASONS))
            else:
                counts.append(got[0])
                pins.append(got[2])
        return counts, pins

    def size(self) -> int:
        return self._ix.size() + self._odd.size()

    def set_origin(self, oid: bytes, slot: int) -> int:
        if len(oid) == 16:
            return self._ix.set_origin(oid, slot)
        return self._odd.set_origin(oid, slot)

    def add_replica(self, oid: bytes, slot: int) -> int:
        if len(oid) == 16:
            return self._ix.add_replica(oid, slot)
        return self._odd.add_replica(oid, slot)

    def pop_replica(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.pop_replica(oid)
        return self._odd.pop_replica(oid)

    def num_replicas(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.num_replicas(oid)
        return self._odd.num_replicas(oid)

    def replica_mask(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.replica_mask(oid)
        return self._odd.replica_mask(oid)

    def clear_replicas(self, oid: bytes) -> int:
        if len(oid) == 16:
            return self._ix.clear_replicas(oid)
        return self._odd.clear_replicas(oid)

    def drop_slot(self, slot: int) -> None:
        self._ix.drop_slot(slot)
        self._odd.drop_slot(slot)

    def locate(self, oids, prefer_slot: int) -> List[int]:
        packed, n, odd = self._split(oids)
        if not odd:
            return self._ix.locate(packed, n, prefer_slot) if n else []
        # mixed batch: per-oid dispatch keeps result order (odd-size ids
        # go to the Python twin, same as every other method here)
        return [
            (self._ix.locate(oid, 1, prefer_slot)[0] if len(oid) == 16
             else self._odd.locate((oid,), prefer_slot)[0])
            for oid in oids
        ]

    def clear(self) -> None:
        self._ix.clear()
        self._odd.clear()


def _make_refs():
    """The session ref index: native unless unavailable or disabled."""
    if os.environ.get("RAY_TPU_TORCH_NATIVE_REFS", "1") != "0":
        try:
            from ray_tpu_torch._private import native

            if native.available():
                return _NativeRefs()
        except Exception:
            pass
    return _PyRefs()


# Objects touched within this window are not spill candidates — closes the
# race where a get reply carrying an shm location is in flight while the
# head spills the segment out from under the consumer.
#
# Why eviction candidate selection is safe PYTHON-side (vs the reference's
# in-store eviction_policy.h): the native arena is single-writer — only
# the head process allocates/frees (store_core.cc's contract), and every
# registry mutation (create/seal/pin/spill) happens under this registry's
# lock in that same process.  A concurrent seal therefore cannot race a
# spill decision: both serialize on self._lock, and the C layer is only
# ever called while it is held.  Readers in other processes see sealed
# slices via control-plane locations and are protected by the idle window
# + pin counts, not by store-internal locking.
_SPILL_MIN_IDLE_S = 5.0


class ObjectRegistry:
    """Head-process directory of all objects in the session."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self._lock = make_lock("object_store.registry")
        self._objects: Dict[bytes, _Entry] = {}
        self._bytes_used = 0  # head-local shm bytes (spilled/inline/remote don't count)
        self._capacity = capacity_bytes
        self._spill_dir = spill_dir
        self._num_spilled = 0
        # HOT maps (refcounts, pin reasons, location sets) live here —
        # native C++ with the GIL released, or the pure-Python twin.
        # add_refs/remove_refs never take self._lock: the ref index has
        # its own mutex, and only the oids it reports dead come back to
        # Python for metadata/payload reaping.
        self._refs = _make_refs()
        # node slot table for the location sets: slot <-> (node_id, addr).
        # The index speaks small ints; Python owns the mapping.
        self._node_slots: Dict[str, int] = {}
        self._slot_info: List[tuple] = []
        # fast path: until the first replica is ever recorded (single-node
        # sessions, i.e. almost always), get_location skips the index
        self._any_replicas = False
        # incrementally-maintained ownership aggregate: (owner, kind) ->
        # [bytes, objects] over SEALED entries, adjusted at seal /
        # node-loss unseal / delete.  owner_summary() reads it in
        # O(owners) — the every-5s gauge refresh and /metrics scrape must
        # never scan the full object table under this lock.
        self._owner_agg: Dict[Tuple[str, str], list] = {}
        # set by the head Node: shm_name -> ask every node agent to unlink.
        # Any node may hold the origin segment OR a pulled replica, so
        # deletion broadcasts (the head's own copy/replica is unlinked
        # locally either way).
        self.broadcast_unlink = None
        # set by the head Node when the native arena backs local objects:
        # oid -> free the arena allocation
        self.arena_delete = None
        # set by the head Node: called (without the registry lock) for each
        # fully-deleted object so lineage entries die with the object
        self.on_delete = None

    # -- creation / sealing --------------------------------------------
    def create_pending(self, oid: bytes) -> None:
        """Declare an object that a task will produce (return slot)."""
        with self._lock:
            if oid not in self._objects:
                self._objects[oid] = _Entry()
                self._refs.ensure((oid,))

    def create_pending_batch(self, oids) -> None:
        """One lock hop + one index call for a whole spec's return slots
        (a 1M-task submission wave creates 1M entries through here)."""
        with self._lock:
            new = [oid for oid in oids if oid not in self._objects]
            for oid in new:
                self._objects[oid] = _Entry()
            if new:
                self._refs.ensure(new)

    def seal(self, oid: bytes, loc: ObjectLocation,
             contained: Optional[List[bytes]] = None,
             only_if_live: bool = False, owner: Optional[str] = None,
             owner_kind: Optional[str] = None) -> bool:
        """Seal ``oid`` with ``loc``.  With ``only_if_live``, a concurrent
        deletion wins atomically: the prepared payload is discarded instead
        of resurrecting the entry (returns False).  Plain seal returns True."""
        unlink = None
        dead: List[tuple] = []
        missed = False
        fresh = False
        with self._lock:
            e = self._objects.get(oid)
            if e is None and not only_if_live:
                e = self._objects[oid] = _Entry()
                self._refs.ensure((oid,))
            if e is None:
                # entry died between the caller's decision and this seal:
                # reap the orphaned payload (outside the lock — reap
                # callbacks may take the node lock), don't resurrect
                missed = True
                if loc.arena_path:
                    dead.append(("arena", (loc.arena_key, loc.shm_name)))
                elif loc.shm_name:
                    dead.append(("shm", loc.shm_name))
                elif loc.spilled_path:
                    dead.append(("file", loc.spilled_path))
            elif e.loc is not None:
                # First seal wins (objects are immutable).  A re-seal happens
                # when a task retried after its worker sealed a return and
                # then crashed — drop the duplicate payload.  Checked and
                # set under the lock so two concurrent seals can't both win.
                if loc.arena_path:
                    dead.append(("arena", (loc.arena_key, None)))
                    unlink = None
                elif loc.shm_name == e.loc.shm_name:
                    unlink = None  # same segment as the winner: never unlink
                else:
                    unlink = loc.shm_name
            else:
                fresh = True
                e.loc = loc
                e.contained = list(contained or [])
                # first seal records the producer as owner; a re-seal after
                # lineage reconstruction keeps the original attribution
                if owner is not None and e.owner is None:
                    e.owner = owner
                    e.owner_kind = owner_kind or "unknown"
                e.created = time.time()
                self._owner_agg_add(e, 1)
                if loc.shm_name and not loc.node_id:
                    self._bytes_used += loc.size
            # The containment pins, Event set, and index sealed flag stay
            # UNDER the registry lock (the index mutex nests inside it,
            # never the reverse): a concurrent mark_node_lost must never
            # observe e.contained populated while the +1s are missing, or
            # replace the Event between the loc write and the set.
            dead_at_seal = False
            if not missed:
                if fresh and e.contained:
                    # +1 per child; no-op for already-deleted children,
                    # same as the old existing-entry check
                    self._refs.add(e.contained, "contained", 1)
                e.sealed.set()
                # the index's sealed flag is the delete-at-zero gate: a 1
                # return means every handle died before the producer
                # finished (fire-and-forget) — reclaim below
                dead_at_seal = self._refs.seal(oid) == 1
        if missed:
            self._reap(dead)
            self._maybe_spill()
            return False
        if dead_at_seal:
            self._reap_dead_entries([oid])
        if unlink:
            self._reap([("shm", unlink)])
        self._reap(dead)
        self._maybe_spill()
        return True

    def mark_node_lost(self, node_id: str) -> List[bytes]:
        """Un-seal every object whose only copy lived on a dead node, so
        lineage reconstruction (or an ObjectLostError seal) can refill the
        slot; consumers block on the cleared event meanwhile.  Returns the
        lost oids (reference: ObjectRecoveryManager's lost-object scan,
        ``object_recovery_manager.h:41``)."""
        if not node_id:
            return []  # head-local objects die with the session, not here
        lost: List[bytes] = []
        orphaned_children: List[bytes] = []
        with self._lock:
            slot = self._node_slots.get(node_id, -1)
            if slot >= 0:
                # the dead node's pulled copies leave every location set
                self._refs.drop_slot(slot)
            for oid, e in list(self._objects.items()):
                if e.loc is None or e.loc.node_id != node_id:
                    continue
                surv = self._refs.pop_replica(oid)
                if surv >= 0:
                    # a surviving copy exists: promote it to primary —
                    # no un-seal, no lineage reconstruction (the payoff
                    # of the location set)
                    nid, addr = self._slot_info[surv]
                    e.loc = ObjectLocation(
                        shm_name=e.loc.shm_name, size=e.loc.size,
                        is_error=e.loc.is_error, node_id=nid,
                        fetch_addr=tuple(addr))
                    continue
                # drop contained-ref increments this payload made; a
                # successful re-seal will re-add them
                orphaned_children.extend(e.contained)
                e.contained = []
                self._owner_agg_add(e, -1)  # a re-seal re-adds
                e.loc = None
                e.sealed = threading.Event()  # fresh event: old waiters
                # saw the sealed one; new waiters block until refill
                self._refs.unseal(oid)
                lost.append(oid)
        if orphaned_children:
            self.remove_refs(orphaned_children, reason="contained")
        return lost

    def contains(self, oid: bytes) -> bool:
        with self._lock:
            return oid in self._objects

    # -- lookup --------------------------------------------------------
    def is_sealed(self, oid: bytes) -> bool:
        with self._lock:
            e = self._objects.get(oid)
        return e is not None and e.sealed.is_set()

    def wait_sealed_existing(
        self, oid: bytes, timeout: Optional[float]
    ) -> Union[ObjectLocation, None, str]:
        """Like :meth:`wait_sealed` but never creates an entry: returns the
        sentinel ``"missing"`` for unknown/deleted oids instead of parking a
        phantom _Entry nobody owns (thin-client get path)."""
        with self._lock:
            e = self._objects.get(oid)
        if e is None:
            return "missing"
        if not e.sealed.wait(timeout):
            return None
        e.last_access = time.monotonic()
        return e.loc

    def wait_sealed(self, oid: bytes, timeout: Optional[float]) -> Optional[ObjectLocation]:
        with self._lock:
            e = self._objects.get(oid)
            if e is None:
                e = self._objects[oid] = _Entry()
                self._refs.ensure((oid,))
        if not e.sealed.wait(timeout):
            return None
        e.last_access = time.monotonic()
        return e.loc

    def get_location(self, oid: bytes,
                     prefer_node: Optional[str] = None) -> Optional[ObjectLocation]:
        """Location for a consumer.  ``prefer_node`` is the consumer's node
        ("" = head / emulated): a copy on the consumer's own node wins
        (zero-copy attach); otherwise the pull source round-robins across
        origin + replicas (the location-set payoff: reads spread over every
        node holding a copy)."""
        with self._lock:
            e = self._objects.get(oid)
            if e is None or not e.sealed.is_set():
                return None
            e.last_access = time.monotonic()
            loc = e.loc
        if not (self._any_replicas and loc is not None and loc.shm_name
                and loc.fetch_addr):
            return loc
        return self._choose_source(oid, loc, prefer_node)

    def get_locations_batch(
        self, oids, prefer_node: Optional[str] = None,
    ) -> Dict[bytes, Optional[ObjectLocation]]:
        """One lock hop for a whole dep set (the dispatch path resolves
        every argument location through here)."""
        out: Dict[bytes, Optional[ObjectLocation]] = {}
        now = time.monotonic()
        with self._lock:
            for oid in oids:
                e = self._objects.get(oid)
                if e is None or not e.sealed.is_set():
                    out[oid] = None
                    continue
                e.last_access = now
                out[oid] = e.loc
        if self._any_replicas:
            for oid, loc in out.items():
                if loc is not None and loc.shm_name and loc.fetch_addr:
                    out[oid] = self._choose_source(oid, loc, prefer_node)
        return out

    def _choose_source(self, oid: bytes, loc: ObjectLocation,
                       prefer_node: Optional[str]) -> ObjectLocation:
        """Replica-set pull spreading: ask the ref index which copy this
        consumer should read (own node wins, else round-robin)."""
        prefer_slot = -1
        if prefer_node is not None:
            if prefer_node == (loc.node_id or ""):
                return loc  # own-node origin (incl. head arena payloads)
            prefer_slot = self._node_slots.get(prefer_node, -1)
        choice = self._refs.locate((oid,), prefer_slot)[0]
        if choice < 0:
            return loc
        nid, addr = self._slot_info[choice]
        if nid == (loc.node_id or "") or addr is None:
            return loc
        return self._replica_loc(loc, nid, addr)

    @staticmethod
    def _replica_loc(loc: ObjectLocation, node_id: str, addr) -> ObjectLocation:
        # replicas are plain files — no arena fields
        return ObjectLocation(
            shm_name=loc.shm_name, size=loc.size, is_error=loc.is_error,
            node_id=node_id, fetch_addr=tuple(addr))

    def _node_slot_locked(self, node_id: str, addr=None) -> int:
        """Slot for ``node_id`` (lock held), assigning one on first use;
        a provided address refreshes the slot's pull endpoint."""
        slot = self._node_slots.get(node_id)
        if slot is None:
            slot = len(self._slot_info)
            self._node_slots[node_id] = slot
            self._slot_info.append((node_id, tuple(addr) if addr else None))
        elif addr:
            self._slot_info[slot] = (node_id, tuple(addr))
        return slot

    def add_replica(self, oid: bytes, node_id: str, fetch_addr) -> None:
        """Record that ``node_id`` now holds a pulled copy (location-set
        update; reported by consumers after a successful pull or by the
        broadcast fan-out)."""
        if not node_id or not fetch_addr:
            return
        with self._lock:
            e = self._objects.get(oid)
            if not (
                e is not None and e.loc is not None and e.loc.shm_name
                and node_id != e.loc.node_id
            ):
                return
            slot = self._node_slot_locked(node_id, fetch_addr)
            origin = self._node_slot_locked(e.loc.node_id or "",
                                            e.loc.fetch_addr)
        self._refs.set_origin(oid, origin)
        if self._refs.add_replica(oid, slot) == 1:
            self._any_replicas = True

    def replica_nodes(self, oid: bytes) -> List[str]:
        mask = self._refs.replica_mask(oid)
        if not mask:
            return []
        with self._lock:
            return [info[0] for i, info in enumerate(self._slot_info)
                    if mask & (1 << i)]

    # -- reference counting --------------------------------------------
    # These never take the registry lock: the ref index has its own
    # (GIL-released, in the native case) mutex, and batch calls make one
    # hop per MESSAGE.  Only the oids the index erased (count<=0 while
    # sealed, atomic with the decrement) come back for metadata reaping.
    def add_ref(self, oid: bytes, n: int = 1, reason: str = "handle") -> None:
        """``reason`` feeds the audit's pin breakdown ("handle" = a live
        ObjectRef somewhere, "task_arg" = pinned by a pending task's spec,
        "contained" = referenced inside another sealed object)."""
        self._refs.add((oid,), reason, n)

    def add_refs(self, oids, n: int = 1, reason: str = "handle") -> None:
        self._refs.add(oids, reason, n)

    def remove_ref(self, oid: bytes, n: int = 1,
                   reason: str = "handle") -> None:
        """Owner-side count decrement; deletes (and cascades to contained
        refs) at zero.  Unsealed entries linger at count<=0 until their
        producer seals, then reclaim immediately."""
        self.remove_refs((oid,), n=n, reason=reason)

    def remove_refs(self, oids, n: int = 1, reason: str = "handle") -> None:
        dead = self._refs.remove(oids, reason, n)
        if dead:
            self._reap_dead_entries(dead)

    def _reap_dead_entries(self, dead_oids: List[bytes]) -> None:
        """Finish deletion for oids the ref index just erased: reap
        payloads, cascade containment pins (which can erase more entries),
        fire the on_delete hooks — the cold half of the old delete path."""
        reap: List[tuple] = []
        pending = list(dead_oids)
        while pending:
            children: List[bytes] = []
            with self._lock:
                for oid in pending:
                    e = self._objects.pop(oid, None)
                    if e is None:
                        continue
                    if e.loc is not None and e.sealed.is_set():
                        self._owner_agg_add(e, -1)
                    if e.loc is not None:
                        if e.loc.arena_path:
                            reap.append(("arena", (e.loc.arena_key,
                                                   e.loc.shm_name)))
                            if not e.loc.node_id:
                                self._bytes_used -= e.loc.size
                        elif e.loc.shm_name:
                            reap.append(("shm", e.loc.shm_name))
                            if not e.loc.node_id:
                                self._bytes_used -= e.loc.size
                        elif e.loc.spilled_path:
                            reap.append(("file", e.loc.spilled_path))
                    children.extend(e.contained)
                    if self.on_delete is not None:
                        reap.append(("hook", oid))
            pending = (self._refs.remove(children, "contained", 1)
                       if children else [])
        self._reap(reap)

    def _owner_agg_add(self, e: "_Entry", n: int) -> None:
        """Adjust the sealed-bytes-per-owner aggregate by ``n`` objects
        of the entry's current size (lock held; n is +1 on seal, -1 on
        unseal/delete — explicit, never inferred from a size sign that a
        zero-byte payload would break).  An object counts exactly while
        it is sealed with a location — the same filter a full
        owner_summary() scan would apply."""
        key = (e.owner or "unknown", e.owner_kind)
        agg = self._owner_agg.get(key)
        if agg is None:
            agg = self._owner_agg[key] = [0, 0]
        agg[0] += n * e.loc.size
        agg[1] += n
        if agg[1] <= 0:
            del self._owner_agg[key]

    def _reap(self, dead: List[tuple]) -> None:
        for kind, name in dead:
            if kind == "hook":
                if self.on_delete is not None:
                    self.on_delete(name)
            elif kind == "file":
                try:
                    os.unlink(name)
                except OSError:
                    pass
            elif kind == "arena":
                arena_key, copy_name = name
                if self.arena_delete is not None and arena_key:
                    self.arena_delete(arena_key)
                if copy_name:  # remote pulled copies use the shm name
                    ShmSegment.unlink(copy_name)
                    if self.broadcast_unlink is not None:
                        self.broadcast_unlink(copy_name)
            else:
                # origin copy or pulled replica in this process's namespace
                ShmSegment.unlink(name)
                if self.broadcast_unlink is not None:
                    self.broadcast_unlink(name)

    # -- capacity / spilling -------------------------------------------
    def _maybe_spill(self) -> None:
        """Move least-recently-accessed shm objects to disk until under the
        capacity (plasma eviction + LocalObjectManager spill analog).
        Spilled objects stay gettable — consumers read the file."""
        if self._capacity is None or self._spill_dir is None:
            return
        while True:
            with self._lock:
                if self._bytes_used <= self._capacity:
                    return
                now = time.monotonic()
                candidates = [
                    (e.last_access, oid, e)
                    for oid, e in self._objects.items()
                    if e.sealed.is_set() and e.loc is not None and e.loc.shm_name
                    and not e.loc.node_id  # remote segments aren't local files
                    and not e.loc.arena_path  # arena slices spill via delete
                    and now - e.last_access >= _SPILL_MIN_IDLE_S
                ]
                if not candidates:
                    return  # everything hot; stay over cap rather than race
                candidates.sort()
                _, oid, e = candidates[0]
                shm_name, size = e.loc.shm_name, e.loc.size
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir, oid.hex())
            try:
                seg = ShmSegment.attach(shm_name, size)
                try:
                    with open(path, "wb") as f:
                        f.write(seg.buf)
                finally:
                    seg.close()
            except OSError:
                return
            with self._lock:
                e2 = self._objects.get(oid)
                if e2 is None or e2.loc is None or e2.loc.shm_name != shm_name:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue  # deleted concurrently
                e2.loc.shm_name = None
                e2.loc.spilled_path = path
                had_replicas = self._refs.num_replicas(oid) > 0
                if had_replicas:
                    self._refs.clear_replicas(oid)
                self._bytes_used -= size
                self._num_spilled += 1
                bytes_used = self._bytes_used
            _events.emit("object_store", "spilled object to disk",
                         severity="WARNING", entity_id=oid.hex(),
                         size_mb=round(size / (1 << 20), 2),
                         bytes_used=bytes_used, capacity=self._capacity)
            ShmSegment.unlink(shm_name)
            if had_replicas and self.broadcast_unlink is not None:
                # replica copies share the segment name on other nodes;
                # after the spill nothing would ever reap them (delete only
                # sees the spilled file) — unlink them with the original
                self.broadcast_unlink(shm_name)

    @staticmethod
    def _where(e: "_Entry") -> str:
        loc = e.loc
        if loc is None:
            return "pending"
        if loc.inline is not None:
            return "inline"
        if loc.spilled_path:
            return "spilled"
        return loc.node_id or "head"

    @staticmethod
    def _pin_reason(pins) -> str:
        """The dominant reason this object is still alive, in pin-strength
        order: a task-spec pin outlives handles, containment outlives a
        dropped handle.  ``pins`` is the ref index's slot list."""
        for reason in ("task_arg", "lineage", "contained", "handle"):
            if pins[_REASON_IDX[reason]] > 0:
                return reason
        return "unknown"

    # -- admin ---------------------------------------------------------
    def list_objects(self, limit: int = 1000) -> List[dict]:
        """State-API view of the object directory (list_objects analog)."""
        import itertools

        now = time.time()
        with self._lock:
            page = [
                (oid, e.sealed.is_set(), e.loc, self._where(e), e.owner,
                 e.owner_kind, e.created)
                for oid, e in itertools.islice(self._objects.items(), limit)
            ]
        counts, pins = self._refs.get_batch([row[0] for row in page])
        return [{
            "object_id": oid.hex(),
            "sealed": sealed,
            "ref_count": counts[i] if counts[i] is not None else 0,
            "size": loc.size if loc else None,
            "where": where,
            "owner": owner,
            "owner_kind": owner_kind,
            "pin_reason": self._pin_reason(pins[i]),
            "age_s": round(now - created, 1),
        } for i, (oid, sealed, loc, where, owner, owner_kind, created)
            in enumerate(page)]

    def memory_audit(self) -> List[dict]:
        """Every SEALED object with ownership/pin detail — the raw rows of
        the ``ray memory`` table.  Row fields snapshot under the lock;
        counts/pins come from one batch index call (its own mutex), so a
        full-table audit costs two lock hops, not one per row."""
        now = time.time()
        with self._lock:
            snap = [
                (oid, e.loc.size, self._where(e), e.owner or "unknown",
                 e.owner_kind, e.created)
                for oid, e in self._objects.items()
                if e.sealed.is_set() and e.loc is not None]
        counts, pins = self._refs.get_batch([row[0] for row in snap])
        rows = [{
            "object_id": oid.hex(),
            "size": size,
            "where": where,
            "owner": owner,
            "owner_kind": owner_kind,
            "ref_count": counts[i] if counts[i] is not None else 0,
            "pins": _pins_dict(pins[i]),
            "pin_reason": self._pin_reason(pins[i]),
            "age_s": round(now - created, 1),
        } for i, (oid, size, where, owner, owner_kind, created)
            in enumerate(snap)]
        rows.sort(key=lambda r: -r["size"])
        return rows

    def owner_summary(self) -> Dict[tuple, dict]:
        """Sealed bytes/objects by (owner, kind) from the incrementally-
        maintained aggregate — O(owners), never a table scan.  The shape
        the every-5s gauge refresh and ``top`` need; per-object rows and
        the pin-reason breakdown come from :meth:`memory_audit` (the
        explicit ``ray_tpu_torch memory`` ask)."""
        with self._lock:
            return {key: {"bytes": agg[0], "objects": agg[1]}
                    for key, agg in self._owner_agg.items()}

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "bytes_used": self._bytes_used,
                "num_spilled": self._num_spilled,
            }

    def all_shm_names(self) -> List[str]:
        with self._lock:
            return [e.loc.shm_name for e in self._objects.values() if e.loc and e.loc.shm_name]

    def shutdown(self) -> None:
        for name in self.all_shm_names():
            ShmSegment.unlink(name)
        with self._lock:
            spilled = [e.loc.spilled_path for e in self._objects.values()
                       if e.loc and e.loc.spilled_path]
            self._objects.clear()
            self._refs.clear()
        for p in spilled:
            try:
                os.unlink(p)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Producer / consumer helpers (run in any process)
# ---------------------------------------------------------------------------

_ATTACHED: Dict[str, ShmSegment] = {}
_ATTACHED_LOCK = make_lock("object_store.attached")


# Owner-side native arena (plasma analog); the head process sets this at
# Node init.  Worker processes keep the per-object-file path.
_OWNED_ARENA = None

# Above this size an arena put writes through the arena fd (os.pwrite,
# one kernel pass per page) instead of memcpy into the mapping: on
# never-faulted arena pages the mmap path pays fault+zero+copy per 4 KiB
# page, which is the 45x cliff multi-GiB (checkpoint-sized) values hit.
# Recycled (already-faulted) pages favor memcpy, and sub-64 MB objects
# mostly land on recycled slots, so the threshold keeps them there.
try:
    _ARENA_FD_WRITE_MIN = int(os.environ.get(
        "RAY_TPU_TORCH_ARENA_FD_WRITE_MIN", str(64 << 20)))
except ValueError:  # malformed override: keep the default, don't die at import
    _ARENA_FD_WRITE_MIN = 64 << 20
# reader-side cache: arena path -> memoryview over its mmap
_ARENA_MAPS: Dict[str, memoryview] = {}
_ARENA_MAPS_LOCK = make_lock("object_store.arena_maps")


def set_owned_arena(arena) -> None:
    global _OWNED_ARENA
    _OWNED_ARENA = arena


class _ArenaPin:
    """Holds one head-side reference on an arena object for as long as any
    zero-copy view of it is alive (the plasma client-pin analog: the slot
    cannot be recycled under a live numpy array)."""

    __slots__ = ("_oid",)

    def __init__(self, oid: bytes):
        self._oid = oid

    def __del__(self):
        try:
            from ray_tpu_torch._private.worker import global_worker

            client = global_worker.client
            if client is not None and not client.closed:
                client.remove_refs([self._oid])
        except Exception:
            pass


class _PinnedArenaMap(__import__("mmap").mmap):
    """mmap subclass that can carry attributes — see
    :func:`_pinned_arena_slice`."""


def _pinned_arena_slice(path: str, off: int, size: int,
                        pin: _ArenaPin) -> memoryview:
    """A zero-copy view of ``[off, off+size)`` of the arena file whose
    buffer chain owns ``pin``: a private mmap subclass instance carries the
    pin as an attribute, every exported memoryview keeps its exporting
    mmap alive, and the mmap's deallocation drops the pin — so the
    head-side reference lives exactly as long as any deserialized view
    (numpy array, bytes slice) over this object.  Works on every CPython
    (no PEP 688 ``__buffer__`` needed; plain classes can't export buffers
    before 3.12)."""
    import mmap as mmap_mod

    gran = mmap_mod.ALLOCATIONGRANULARITY
    base = (off // gran) * gran
    delta = off - base
    fd = os.open(path, os.O_RDONLY)
    try:
        mm = _PinnedArenaMap(fd, delta + size, prot=mmap_mod.PROT_READ,
                             offset=base)
    finally:
        os.close(fd)  # the mapping outlives the fd
    mm._pin = pin
    return memoryview(mm)[delta:delta + size]


def _arena_view(path: str) -> memoryview:
    import mmap as mmap_mod

    with _ARENA_MAPS_LOCK:
        view = _ARENA_MAPS.get(path)
        if view is None:
            if _OWNED_ARENA is not None and _OWNED_ARENA.path == path:
                view = _OWNED_ARENA.buf
            else:
                fd = os.open(path, os.O_RDONLY)
                try:
                    size = os.fstat(fd).st_size
                    mm = mmap_mod.mmap(fd, size, prot=mmap_mod.PROT_READ)
                finally:
                    os.close(fd)
                view = memoryview(mm)
            _ARENA_MAPS[path] = view
        return view


def store_value(ref: ObjectRef, value: Any, is_error: bool = False) -> Tuple[ObjectLocation, list]:
    """Serialize ``value``; write big payloads to shm. Returns (location, contained_refs)."""
    if not _events.ENABLED:
        return _store_value(ref, value, is_error)
    global _put_n
    t0 = time.perf_counter()
    out = _store_value(ref, value, is_error)
    size = out[0].size
    _put_n += 1
    if size > _SMALL_SAMPLE_MAX_BYTES or _put_n % _SMALL_SAMPLE == 1:
        _store_metrics()["put"].observe(time.perf_counter() - t0)
    if size >= _PUT_EVENT_MIN_BYTES:
        _events.emit("object_store", "large shm put", severity="DEBUG",
                     entity_id=ref.hex(), size_mb=round(size / (1 << 20), 2))
    return out


def _store_value(ref: ObjectRef, value: Any, is_error: bool = False) -> Tuple[ObjectLocation, list]:
    cfg = get_config()
    meta, buffers, refs = serialization.serialize(value)
    total = serialization.total_size(meta, buffers)
    if total <= cfg.max_direct_call_object_size:
        blob = serialization.to_bytes(meta, buffers)
        return ObjectLocation(inline=blob, is_error=is_error), refs
    name = session_shm_name(ref.hex())
    if _OWNED_ARENA is not None:
        # native path: allocate a slice of the session arena and write in
        # place (recycled pages skip the fresh-file fault-and-zero cost)
        key = ref.binary()
        off = _OWNED_ARENA.put(key, total)
        if off is None and _OWNED_ARENA.get(key) is not None:
            # a prior attempt of this task left an allocation (it may be
            # SEALED and live — never touch it); index this attempt under
            # a fresh key and let first-seal-wins pick the survivor
            key = os.urandom(16)  # raylint: disable=R3 (retry-only path)
            off = _OWNED_ARENA.put(key, total)
        if off is not None:
            if total >= _ARENA_FD_WRITE_MIN:
                # single-pass write for multi-GiB values (see threshold
                # comment above); coherent with every reader's arena mmap
                written = serialization.write_to_fd_at(
                    _OWNED_ARENA.fd, off, meta, buffers)
                assert written == total, (written, total)
            else:
                serialization.write_into(
                    _OWNED_ARENA.buf[off:off + total], meta, buffers)
            _OWNED_ARENA.seal(key)
            return ObjectLocation(
                shm_name=name, size=total, is_error=is_error,
                arena_path=_OWNED_ARENA.path, arena_off=off, arena_key=key,
            ), refs
        # arena full: fall through to the per-object-file path
        _events.emit("object_store", "arena full; per-object segment fallback",
                     severity="WARNING", entity_id=ref.hex(), size=total)
    # producer side writes through the fd (page-allocation path, ~2.4x the
    # mmap-memcpy bandwidth on tmpfs); consumers still mmap zero-copy
    name = _write_segment(
        name, lambda fd: serialization.write_to_fd(fd, meta, buffers), total
    )
    return ObjectLocation(shm_name=name, size=total, is_error=is_error), refs


def _write_segment(name: str, write_fn, expected: int) -> str:
    """Exclusive-create a named shm segment and fill it via ``write_fn(fd)``.

    A name collision means a prior attempt of the same task created the
    segment; it may be a SEALED live object — never unlink or rewrite it.
    This attempt publishes under a unique name and first-seal-wins reaps
    the loser.  Any write failure unlinks the partial file."""
    path = ShmSegment.path_for(name)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    except FileExistsError:
        name = f"{name}-r{os.urandom(3).hex()}"  # raylint: disable=R3 (collision retry)
        path = ShmSegment.path_for(name)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        written = write_fn(fd)
        assert written == expected, f"wrote {written}, expected {expected}"
    except BaseException:
        os.close(fd)
        os.unlink(path)
        raise
    os.close(fd)
    return name


def store_blob(ref: ObjectRef, blob: bytes, is_error: bool = False) -> ObjectLocation:
    """Store an already-serialized payload (thin-client put: the client
    shipped the bytes over the control socket because it shares no shm with
    this host).  Small blobs stay inline; big ones land in local shm."""
    cfg = get_config()
    if len(blob) <= cfg.max_direct_call_object_size:
        return ObjectLocation(inline=bytes(blob), is_error=is_error)

    def write_all(fd: int) -> int:
        view = memoryview(blob)
        total = 0
        while view:  # os.write caps single writes (~2 GiB on Linux)
            n = os.write(fd, view)
            view = view[n:]
            total += n
        return total

    name = _write_segment(session_shm_name(ref.hex()), write_all, len(blob))
    return ObjectLocation(shm_name=name, size=len(blob), is_error=is_error)


def payload_bytes(loc: ObjectLocation) -> bytes:
    """The serialized payload at ``loc`` as bytes (thin-client get: the
    caller can't attach this host's shm, so the head reads the bytes out
    and ships them over the socket).  Remote-node segments are pulled into
    the local namespace first, exactly like :func:`read_value`."""
    if loc.inline is not None:
        return loc.inline
    if loc.spilled_path is not None:
        with open(loc.spilled_path, "rb") as f:
            return f.read()
    arena_src = None
    if loc.arena_path is not None:
        try:
            view = _arena_view(loc.arena_path)
            return bytes(view[loc.arena_off:loc.arena_off + loc.size])
        except FileNotFoundError:
            if not loc.fetch_addr:
                raise
            # remote arena-backed object: the origin serves the arena slice
            # under the object's shm name (same pull read_value does)
            arena_src = (loc.arena_path, loc.arena_off)
    with _ATTACHED_LOCK:
        seg = _ATTACHED.get(loc.shm_name)
    if seg is None:
        try:
            seg = ShmSegment.attach(loc.shm_name, loc.size)
        except FileNotFoundError:
            if not loc.fetch_addr:
                raise
            from ray_tpu_torch._private import object_transfer

            object_transfer.pull_object(
                loc.shm_name, loc.fetch_addr, loc.size, arena=arena_src
            )
            seg = ShmSegment.attach(loc.shm_name, loc.size)
        with _ATTACHED_LOCK:
            seg = _ATTACHED.setdefault(loc.shm_name, seg)
    return bytes(seg.buf)


def _report_replica(oid: Optional[bytes]) -> None:
    """Tell the head this node now holds a copy (location-set update; the
    head records it only for real agent nodes)."""
    if oid is None:
        return
    try:
        from ray_tpu_torch._private.worker import global_worker

        client = global_worker.client
        if client is not None and not client.closed:
            client.send({"type": "replica_added", "oid": oid})
    except Exception:
        pass  # best-effort: the directory just misses one source


def read_value(loc: ObjectLocation, oid: Optional[bytes] = None) -> Any:
    """Deserialize an object from its location (zero-copy for shm payloads;
    spilled objects are read back from disk; remote segments are pulled
    into the local shm namespace first — ``ray.get`` step 3 in SURVEY §3.3).

    ``oid`` enables zero-copy reads of arena-backed objects: the views are
    pinned with a head-side reference so the slot can't be recycled under
    them.  Without an oid, arena payloads are copied out for safety."""
    if not _events.ENABLED:
        return _read_value(loc, oid)
    global _get_n
    t0 = time.perf_counter()
    value = _read_value(loc, oid)
    _get_n += 1
    if loc.size > _SMALL_SAMPLE_MAX_BYTES or _get_n % _SMALL_SAMPLE == 1:
        _store_metrics()["get"].observe(time.perf_counter() - t0)
    return value


def _read_value(loc: ObjectLocation, oid: Optional[bytes] = None) -> Any:
    if loc.inline is not None:
        value = serialization.deserialize(memoryview(loc.inline))
    elif loc.spilled_path is not None:
        with open(loc.spilled_path, "rb") as f:
            value = serialization.deserialize(memoryview(f.read()))
    elif loc.arena_path is not None:
        try:
            payload = None
            if oid is not None:
                from ray_tpu_torch._private.worker import global_worker

                client = global_worker.client
                if client is not None and not client.closed:
                    # the caller's handle is live right now, so this
                    # add_ref cannot race the object's deletion
                    client.add_refs([oid])
                    payload = _pinned_arena_slice(
                        loc.arena_path, loc.arena_off, loc.size,
                        _ArenaPin(oid))
            if payload is None:
                view = _arena_view(loc.arena_path)
                payload = memoryview(
                    bytes(view[loc.arena_off:loc.arena_off + loc.size]))
            value = serialization.deserialize(payload)
        except FileNotFoundError:
            # remote node: pull a private copy named loc.shm_name
            if not loc.fetch_addr:
                raise
            from ray_tpu_torch._private import object_transfer

            object_transfer.pull_object(
                loc.shm_name, loc.fetch_addr, loc.size,
                arena=(loc.arena_path, loc.arena_off),
            )
            _report_replica(oid)
            seg = ShmSegment.attach(loc.shm_name, loc.size)
            with _ATTACHED_LOCK:
                seg = _ATTACHED.setdefault(loc.shm_name, seg)
            value = serialization.deserialize(seg.buf)
    else:
        with _ATTACHED_LOCK:
            seg = _ATTACHED.get(loc.shm_name)
        if seg is None:
            try:
                seg = ShmSegment.attach(loc.shm_name, loc.size)
            except FileNotFoundError:
                if not loc.fetch_addr:
                    raise
                from ray_tpu_torch._private import object_transfer

                object_transfer.pull_object(loc.shm_name, loc.fetch_addr, loc.size)
                _report_replica(oid)
                seg = ShmSegment.attach(loc.shm_name, loc.size)
            with _ATTACHED_LOCK:
                seg = _ATTACHED.setdefault(loc.shm_name, seg)
        value = serialization.deserialize(seg.buf)
    if loc.is_error:
        raise value
    return value
