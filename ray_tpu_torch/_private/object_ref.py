"""ObjectRef — the future/handle for an object in the store.

Analog of the reference's binary ``ObjectID`` (``src/ray/common/id.h``) plus
the Python ``ObjectRef`` exposed by the Cython binding
(``python/ray/_raylet.pyx``).  IDs are 16 random bytes; task IDs embed a
per-task counter the way the reference embeds lineage in object IDs.
"""

from __future__ import annotations

import itertools
import os
import struct


class ObjectRef:
    # __weakref__ lets the runtime attach a finalizer per handle so garbage-
    # collected refs decrement the owner-side count (ReferenceCounter's
    # local-handle tracking seam).
    __slots__ = ("_id", "__weakref__")

    def __init__(self, id_bytes: bytes):
        assert isinstance(id_bytes, bytes) and len(id_bytes) == 16
        self._id = id_bytes

    @classmethod
    def random(cls) -> "ObjectRef":
        return cls(new_id())

    @classmethod
    def from_hex(cls, h: str) -> "ObjectRef":
        return cls(bytes.fromhex(h))

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def future(self):
        """concurrent.futures-style future resolving to the object's value."""
        import concurrent.futures

        import ray_tpu_torch

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _wait():
            try:
                fut.set_result(ray_tpu_torch.get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        import threading

        threading.Thread(target=_wait, daemon=True).start()
        return fut

    def __reduce__(self):
        # Plain pickling path (e.g. inside nested containers serialized by
        # third-party code). The runtime's serializer also special-cases us
        # to track borrowed refs.
        return (ObjectRef, (self._id,))


class ObjectRefGenerator:
    """Stream of ObjectRefs from a ``num_returns="dynamic"`` task
    (reference ``python/ray/_private/worker.py:2924`` ObjectRefGenerator).

    Returned directly by ``.remote()`` on a dynamic task: iterating yields
    each value's ObjectRef AS THE TASK PRODUCES IT (streamed through the
    head's yield directory), so a consumer can start on the first block
    while later ones are still being generated.  ``ray_tpu_torch.get`` of the
    task's terminal return gives the materialized (list-backed) form.
    """

    def __init__(self, refs=None, task_id: bytes = None, primary=None):
        self._refs = list(refs) if refs is not None else None
        self._task_id = task_id
        self._primary = primary  # terminal return: errors surface via get

    def __iter__(self):
        if self._refs is not None:
            return iter(self._refs)
        return self._stream()

    def __len__(self):
        if self._refs is None:
            raise TypeError("length unknown until the task finishes; "
                            "iterate, or get() the materialized generator")
        return len(self._refs)

    def _stream(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.exceptions import WorkerCrashedError

        seen = 0
        attempt = 0
        while True:
            # long-poll: the head parks this request until a new yield
            # lands, the task ends, or ~20s pass (no busy polling)
            reply = global_worker.client.request({
                "type": "dynamic_yields", "task_id": self._task_id,
                "after": seen, "attempt": attempt,
            }, timeout=300)["value"]
            if reply.get("attempt", 0) != attempt:
                if seen:
                    # a retry re-yields from the start; duplicates must not
                    # flow into a half-consumed stream
                    raise WorkerCrashedError(
                        "dynamic-return task was retried mid-stream; "
                        "restart the iteration")
                attempt = reply.get("attempt", 0)
            for oid in reply["oids"]:
                seen += 1
                yield global_worker.track_ref(ObjectRef(oid), owned=False)
            if reply["done"] and not reply["oids"]:
                if self._primary is not None:
                    # raises the task's error, if it failed mid-stream;
                    # also recovers yields the head may have pruned
                    gen = ray_tpu_torch.get(self._primary)
                    self._refs = gen._refs
                    for r in (gen._refs or [])[seen:]:
                        yield r
                return

    def completed(self):
        """ObjectRef of the terminal return (sealed when the task ends)."""
        return self._primary

    def __reduce__(self):
        return (ObjectRefGenerator, (self._refs, self._task_id, self._primary))


# IDs are a per-process random prefix + a monotonically increasing counter
# (the reference also derives object IDs from the task counter, id.h).  One
# urandom syscall per PROCESS instead of per id — new_id was the single
# hottest driver-side frame in a submission wave.  ``next()`` on an
# itertools.count is a single C call, so it is atomic under the GIL.
_prefix: bytes = os.urandom(8)
_counter = itertools.count(1)


def _reseed_after_fork() -> None:
    global _prefix, _counter
    _prefix = os.urandom(8)  # raylint: disable=R3 (one-shot, off the per-task path)
    _counter = itertools.count(1)


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed_after_fork)


def new_id(n: int = 16) -> bytes:
    if n != 16:
        return os.urandom(n)  # raylint: disable=R3 (rare non-16-byte ids)
    return _prefix + struct.pack(">Q", next(_counter))
