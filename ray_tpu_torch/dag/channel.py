"""Pre-allocated channels for compiled execution graphs.

The data plane of ``dag/compiled.py`` (reference: Ray Compiled Graphs'
``experimental/channel/`` — ``shared_memory_channel.py``'s single-reader
ring over plasma mutable objects).  Two transports behind one interface:

- :class:`ShmChannel` — a fixed-slot SPSC ring living in ONE shm segment
  (the PR-1 pinned-arena mmap substrate, ``_private/shm.py``).  Writer and
  reader are different processes on the same node; publication is a
  per-slot sequence store after the payload bytes, consumption advances a
  shared read cursor, so steady-state transfer is two memcpys and zero
  syscalls — no scheduler, no head round trip, no object sealing.
- :class:`StreamWriterChannel` / :class:`StreamReaderChannel` — cross-node
  edges as an authenticated socket stream (the ``object_transfer.py``
  transfer-plane idiom) with credit-based backpressure: at most
  ``capacity`` unacknowledged messages in flight, acks ride the same
  duplex connection.  ``compiled.py`` does not use it yet: the port runs
  one node per head, so every edge of a graph is a shm ring until a node
  agent brings edges between hosts.

Capacity IS the backpressure: a full ring (or exhausted credits) blocks
``put`` until the consumer catches up, which is what bounds a compiled
graph's in-flight executions.  ``poison()`` works from either end and
wakes any blocked peer with :class:`ChannelClosedError` — teardown and
actor-death propagation both ride it.

Values larger than a slot overflow into a one-shot side segment whose
name rides in the slot (flag ``FLAG_OVERFLOW``); the reader unlinks it
after consumption, and orphans die with the session sweep because the
names keep the session prefix.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Callable, Optional, Tuple

from ray_tpu_torch._private.shm import ShmSegment

# message flags (bitfield in the slot/frame header)
FLAG_ERROR = 1      # payload is a serialized exception (propagates downstream)
FLAG_OVERFLOW = 2   # payload is the name of a one-shot overflow segment

_MAGIC = b"CDG1"
_HDR = 64               # channel header bytes
_SLOT_HDR = 24          # per-slot header: seq u64, length u64, flags u64
_OFF_NSLOTS = 8
_OFF_SLOT_BYTES = 16
_OFF_WRITE_SEQ = 24
_OFF_READ_SEQ = 32
_OFF_STATE = 40         # u8: 0 open, 1 closed/poisoned

_U64 = struct.Struct("<Q")
_SLOT = struct.Struct("<QQQ")


class ChannelError(Exception):
    """Base class for compiled-graph channel errors."""


class ChannelClosedError(ChannelError):
    """The channel was poisoned/torn down while waiting on it."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    """A put/get exceeded its timeout with the peer making no progress."""


def _wait(cond: Callable[[], bool], deadline: Optional[float],
          closed: Callable[[], bool], what: str) -> None:
    """Adaptive wait: spin briefly (the common sub-100us handoff), then
    yield, then sleep — cross-process progress comes from the peer's mmap
    stores, so there is nothing to block on but time."""
    n = 0
    while True:
        if cond():
            return
        if closed():
            raise ChannelClosedError(f"channel closed while waiting to {what}")
        if deadline is not None and time.monotonic() >= deadline:
            raise ChannelTimeoutError(f"channel {what} timed out")
        n += 1
        if n < 1000:
            continue  # ~50-100us pure spin covers the in-flight handoff
        time.sleep(0 if n < 2000 else 0.0003)


class ShmChannel:
    """Fixed-slot SPSC ring in a shared-memory segment.

    Exactly one writer process and one reader process; each end keeps its
    own message counter, the shared header carries the published/consumed
    cursors.  ``create`` is the writer side, ``attach`` the reader side
    (either end may also attach purely to :meth:`poison`).
    """

    def __init__(self, seg: ShmSegment, owner: bool):
        self._seg = seg
        self._buf = seg.buf
        self._owner = owner  # creator unlinks the segment on close(unlink=True)
        self.n_slots = _U64.unpack_from(self._buf, _OFF_NSLOTS)[0]
        self.slot_bytes = _U64.unpack_from(self._buf, _OFF_SLOT_BYTES)[0]
        self._seq = 0  # this end's next message index
        self._closed_locally = False

    # -- construction --------------------------------------------------
    @classmethod
    def create(cls, name: str, n_slots: int, slot_bytes: int) -> "ShmChannel":
        size = _HDR + n_slots * (_SLOT_HDR + slot_bytes)
        seg = ShmSegment.create(name, size)
        buf = seg.buf
        buf[0:4] = _MAGIC
        _U64.pack_into(buf, _OFF_NSLOTS, n_slots)
        _U64.pack_into(buf, _OFF_SLOT_BYTES, slot_bytes)
        return cls(seg, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmChannel":
        seg = ShmSegment.attach(name)
        if bytes(seg.buf[0:4]) != _MAGIC:
            raise ChannelError(f"segment {name} is not a compiled-graph channel")
        return cls(seg, owner=False)

    @property
    def name(self) -> str:
        return self._seg.name

    # -- state ---------------------------------------------------------
    def _state_closed(self) -> bool:
        return self._closed_locally or self._buf[_OFF_STATE] != 0

    def poison(self) -> None:
        """Mark the channel closed; both ends' blocked waits wake with
        :class:`ChannelClosedError`.  Idempotent, callable from either
        end (or from a third process that attached by name)."""
        try:
            self._buf[_OFF_STATE] = 1
        except (ValueError, IndexError):
            pass  # mapping already closed

    def close(self, unlink: bool = False) -> None:
        self._closed_locally = True
        name = self._seg.name
        self._buf = None
        self._seg.close()
        if unlink:
            ShmSegment.unlink(name)

    # -- data plane ----------------------------------------------------
    def _slot_off(self, k: int) -> int:
        return _HDR + (k % self.n_slots) * (_SLOT_HDR + self.slot_bytes)

    def can_put(self) -> bool:
        """True when a put would not block (slot free).  Single-writer, so
        a True answer cannot be invalidated by anyone but this caller."""
        buf = self._buf
        if buf is None or self._state_closed():
            return False
        return _U64.unpack_from(buf, _OFF_READ_SEQ)[0] + self.n_slots > self._seq

    def put(self, payload: bytes, flags: int = 0,
            timeout: Optional[float] = None) -> None:
        """Write one message; blocks while the ring is full (backpressure)."""
        buf = self._buf
        if buf is None or self._state_closed():
            raise ChannelClosedError("put on closed channel")
        k = self._seq
        deadline = None if timeout is None else time.monotonic() + timeout
        # wait for the slot BEFORE any side effect: a timed-out put must be
        # retryable with the same payload (the overflow spill below creates
        # an O_EXCL-named segment keyed by k)
        _wait(lambda: _U64.unpack_from(buf, _OFF_READ_SEQ)[0] + self.n_slots > k,
              deadline, self._state_closed, "put")
        if len(payload) > self.slot_bytes:
            payload, flags = self._spill_overflow(payload, k, flags)
        off = self._slot_off(k)
        data_off = off + _SLOT_HDR
        buf[data_off:data_off + len(payload)] = payload
        # publish: length+flags first, then the slot seq store the reader
        # spins on, then the aggregate write cursor (introspection only)
        struct.pack_into("<QQ", buf, off + 8, len(payload), flags)
        _U64.pack_into(buf, off, k + 1)
        _U64.pack_into(buf, _OFF_WRITE_SEQ, k + 1)
        self._seq = k + 1

    def _spill_overflow(self, payload: bytes, k: int, flags: int):
        name = f"{self._seg.name}-ovf{k}"
        try:
            seg = ShmSegment.create(name, len(payload))
        except FileExistsError:
            # a prior attempt of this same (channel, k) spilled but never
            # published (it can only have failed before the slot write) —
            # the orphan is ours to replace
            ShmSegment.unlink(name)
            seg = ShmSegment.create(name, len(payload))
        try:
            seg.buf[:] = payload
        finally:
            seg.close()
        return name.encode(), flags | FLAG_OVERFLOW

    def get(self, timeout: Optional[float] = None) -> Tuple[bytes, int]:
        """Read the next message; blocks until the writer publishes it."""
        buf = self._buf
        if buf is None:
            raise ChannelClosedError("get on closed channel")
        k = self._seq
        off = self._slot_off(k)
        deadline = None if timeout is None else time.monotonic() + timeout
        _wait(lambda: _U64.unpack_from(buf, off)[0] == k + 1,
              deadline, self._state_closed, "get")
        _, length, flags = _SLOT.unpack_from(buf, off)
        data_off = off + _SLOT_HDR
        payload = bytes(buf[data_off:data_off + length])
        _U64.pack_into(buf, _OFF_READ_SEQ, k + 1)  # frees the slot
        self._seq = k + 1
        if flags & FLAG_OVERFLOW:
            name = payload.decode()
            seg = ShmSegment.attach(name)
            try:
                payload = bytes(seg.buf)
            finally:
                seg.close()
                ShmSegment.unlink(name)
            flags &= ~FLAG_OVERFLOW
        return payload, flags


# ---------------------------------------------------------------------------
# Cross-node stream channels
# ---------------------------------------------------------------------------


def advertise_host() -> str:
    """Routable address for this node's stream listeners.  Follows the
    transfer plane's convention (``node.py`` object server): the operator-
    configured ``RAY_TPU_TORCH_HOST`` wins; hostname resolution is only a
    fallback (on Debian-style hosts it maps to 127.0.1.1, and on
    multi-homed hosts it may pick a non-routable interface)."""
    import socket

    host = os.environ.get("RAY_TPU_TORCH_HOST")
    if host:
        return host
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class StreamWriterChannel:
    """Writer end of a cross-node edge: owns a Listener, accepts the one
    reader in the background, sends ``(seq, flags, payload)`` frames with
    at most ``capacity`` unacknowledged (credit backpressure)."""

    def __init__(self, capacity: int, authkey: bytes):
        from multiprocessing.connection import Listener

        self.capacity = capacity
        self._listener = Listener(("0.0.0.0", 0), family="AF_INET",
                                  authkey=authkey)
        self.addr = (advertise_host(), self._listener.address[1])
        self._conn = None
        self._conn_ready = threading.Event()
        self._closed = False
        self._seq = 0
        self._acked = 0
        threading.Thread(target=self._accept, daemon=True,
                         name="cdag-stream-accept").start()

    def _accept(self) -> None:
        try:
            self._conn = self._listener.accept()
        except Exception:
            self._closed = True
        self._conn_ready.set()

    def _drain_acks(self, block_timeout: float) -> None:
        conn = self._conn
        if conn is None:
            return
        try:
            while conn.poll(block_timeout):
                msg = conn.recv()
                if isinstance(msg, tuple) and msg and msg[0] == "ack":
                    self._acked = max(self._acked, int(msg[1]))
                elif isinstance(msg, tuple) and msg and msg[0] == "poison":
                    self._closed = True
                    return
                block_timeout = 0.0
        except (EOFError, OSError):
            self._closed = True

    def can_put(self) -> bool:
        """True when a put would not block: reader connected and a credit
        is available (acks drained opportunistically)."""
        if self._closed or not self._conn_ready.is_set():
            return False
        if self._seq - self._acked >= self.capacity:
            self._drain_acks(0.0)
        return (not self._closed
                and self._seq - self._acked < self.capacity)

    def put(self, payload: bytes, flags: int = 0,
            timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        _wait(self._conn_ready.is_set, deadline, lambda: self._closed,
              "put (await reader)")
        while self._seq - self._acked >= self.capacity:
            if self._closed:
                raise ChannelClosedError("put on closed stream channel")
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelTimeoutError("stream put timed out awaiting acks")
            self._drain_acks(0.02)
        if self._closed:
            raise ChannelClosedError("put on closed stream channel")
        try:
            self._conn.send((self._seq, flags, payload))
        except (OSError, ValueError, BrokenPipeError):
            self._closed = True
            raise ChannelClosedError("stream reader went away") from None
        self._seq += 1
        self._drain_acks(0.0)

    def poison(self) -> None:
        self._closed = True
        conn = self._conn
        if conn is not None:
            try:
                conn.send(("poison",))
            except Exception:
                pass
        self.close()

    def close(self, unlink: bool = False) -> None:
        self._closed = True
        for c in (self._conn, self._listener):
            try:
                if c is not None:
                    c.close()
            except Exception:
                pass


class StreamReaderChannel:
    """Reader end: dials the writer's listener, receives frames in order,
    acks after consumption so the writer's credit window advances."""

    def __init__(self, addr, authkey: bytes):
        from multiprocessing import AuthenticationError
        from multiprocessing.connection import Client as MPClient

        # same challenge-race retry as CoreClient/object_transfer
        for attempt in range(5):
            try:
                self._conn = MPClient(tuple(addr), family="AF_INET",
                                      authkey=authkey)
                break
            except (AuthenticationError, OSError, EOFError):
                if attempt == 4:
                    raise
                time.sleep(0.05 * (attempt + 1))
        self._closed = False
        self._seq = 0

    def get(self, timeout: Optional[float] = None) -> Tuple[bytes, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                raise ChannelClosedError("get on closed stream channel")
            if deadline is None:
                poll_t = 0.02
            else:
                poll_t = max(0.0, min(0.02, deadline - time.monotonic()))
            # NOTE the timeout raise lives OUTSIDE the try: TimeoutError is
            # an OSError subclass, so raising it inside would trip the
            # peer-went-away handler and wrongly close the channel
            try:
                ready = self._conn.poll(poll_t)
            except (EOFError, OSError):
                self._closed = True
                raise ChannelClosedError("stream writer went away") from None
            if not ready:
                if deadline is not None and time.monotonic() >= deadline:
                    raise ChannelTimeoutError("stream get timed out")
                continue
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                self._closed = True
                raise ChannelClosedError("stream writer went away") from None
            if isinstance(msg, tuple) and msg and msg[0] == "poison":
                self._closed = True
                raise ChannelClosedError("stream channel poisoned")
            seq, flags, payload = msg
            self._seq = seq + 1
            try:
                self._conn.send(("ack", self._seq))
            except (OSError, ValueError, BrokenPipeError):
                self._closed = True  # writer gone; deliver the frame anyway
            return payload, flags

    def poison(self) -> None:
        self._closed = True
        try:
            self._conn.send(("poison",))
        except Exception:
            pass
        self.close()

    def close(self, unlink: bool = False) -> None:
        self._closed = True
        try:
            self._conn.close()
        except Exception:
            pass
