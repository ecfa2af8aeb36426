"""ctypes bindings for the native store core (src/store_core/).

The native layer of the framework (SURVEY §2.1 expects C++ equivalents of
the plasma/runtime components).  The library builds on demand with the
baked-in toolchain (g++); everything degrades to the pure-Python
per-object-file path when a compiler is unavailable, so the native layer
is an accelerator, never a dependency.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

# the port's own copy of the store core's source, built at first use
# into the package's git-ignored build directory
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build")
_LIB_NAME = "libray_tpu_torch_store.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[str]:
    """Compile the .so into ``_build/`` (cached across sessions).  Each
    process compiles to a name of its own and renames it into place, so
    workers that build at once never load half a file."""
    out = os.path.join(_BUILD_DIR, _LIB_NAME)
    src = os.path.join(_SRC_DIR, "store_core.cc")
    if not os.path.exists(src):
        return None
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-std=c++17"]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(cmd + ["-shared", "-o", tmp, src],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native store core unavailable (build failed: %s)", e)
        return None


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it on first use; None when impossible."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.info("native store core failed to load: %s", e)
            _build_failed = True
            return None
        lib.rtpu_store_create.restype = ctypes.c_void_p
        lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_store_put.restype = ctypes.c_int
        lib.rtpu_store_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rtpu_store_seal.restype = ctypes.c_int
        lib.rtpu_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_store_get.restype = ctypes.c_int
        lib.rtpu_store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rtpu_store_delete.restype = ctypes.c_int
        lib.rtpu_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        for fn in ("rtpu_store_bytes_used", "rtpu_store_capacity",
                   "rtpu_store_num_objects", "rtpu_store_num_free_blocks"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.rtpu_store_close.restype = None
        lib.rtpu_store_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        # RefIndex (head registry hot maps; see store_core.cc)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rtpu_refs_create.restype = ctypes.c_void_p
        lib.rtpu_refs_create.argtypes = []
        lib.rtpu_refs_ensure.restype = None
        lib.rtpu_refs_ensure.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
        lib.rtpu_refs_contains.restype = ctypes.c_int
        lib.rtpu_refs_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_refs_add.restype = None
        lib.rtpu_refs_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64]
        lib.rtpu_refs_remove.restype = ctypes.c_int64
        lib.rtpu_refs_remove.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, u8p]
        for fn in ("rtpu_refs_seal", "rtpu_refs_unseal", "rtpu_refs_erase"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_refs_get.restype = ctypes.c_int
        lib.rtpu_refs_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.rtpu_refs_get_batch.restype = None
        lib.rtpu_refs_get_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.rtpu_refs_size.restype = ctypes.c_uint64
        lib.rtpu_refs_size.argtypes = [ctypes.c_void_p]
        for fn in ("rtpu_refs_set_origin", "rtpu_refs_add_replica"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
        for fn in ("rtpu_refs_pop_replica", "rtpu_refs_num_replicas",
                   "rtpu_refs_clear_replicas"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_refs_replica_mask.restype = ctypes.c_uint64
        lib.rtpu_refs_replica_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_refs_drop_slot.restype = None
        lib.rtpu_refs_drop_slot.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.rtpu_refs_locate.restype = None
        lib.rtpu_refs_locate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.rtpu_refs_clear.restype = None
        lib.rtpu_refs_clear.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeArena:
    """Owner-side handle over one arena file (single-writer: the head).

    Consumers never need this class — they mmap the arena file directly
    and slice at the offsets the control plane hands them."""

    def __init__(self, path: str, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native store core unavailable")
        self._lib = lib
        self.path = path
        self.capacity = capacity
        self._h = lib.rtpu_store_create(path.encode(), capacity)
        if not self._h:
            raise OSError(f"could not create arena at {path}")
        import mmap as mmap_mod

        # the fd stays open for the session: big-object puts write through
        # it (pwrite — the single-pass path that skips the mmap fault+zero
        # loop on fresh pages) while small puts memcpy into the mapping
        self.fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap_mod.mmap(self.fd, capacity)
        except BaseException:
            os.close(self.fd)
            raise
        self.buf = memoryview(self._mm)
        self._closed = False

    def put(self, oid: bytes, size: int) -> Optional[int]:
        """Allocate+index; returns the offset or None when full."""
        off = ctypes.c_uint64()
        rc = self._lib.rtpu_store_put(self._h, oid, size, ctypes.byref(off))
        if rc != 0:
            return None
        return off.value

    def seal(self, oid: bytes) -> None:
        self._lib.rtpu_store_seal(self._h, oid)

    def get(self, oid: bytes):
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        sealed = ctypes.c_int()
        rc = self._lib.rtpu_store_get(self._h, oid, ctypes.byref(off),
                                      ctypes.byref(size), ctypes.byref(sealed))
        if rc != 0:
            return None
        return off.value, size.value, bool(sealed.value)

    def delete(self, oid: bytes) -> bool:
        return self._lib.rtpu_store_delete(self._h, oid) == 0

    def stats(self) -> dict:
        return {
            "bytes_used": self._lib.rtpu_store_bytes_used(self._h),
            "capacity": self._lib.rtpu_store_capacity(self._h),
            "num_objects": self._lib.rtpu_store_num_objects(self._h),
            "free_blocks": self._lib.rtpu_store_num_free_blocks(self._h),
        }

    def close(self, unlink: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.buf.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass  # exported zero-copy views still alive
        try:
            os.close(self.fd)
        except OSError:
            pass
        self._lib.rtpu_store_close(self._h, 1 if unlink else 0)


class RefIndex:
    """Thin handle over the C RefIndex (head registry hot maps).

    All batch calls take a single packed ``bytes`` of concatenated
    16-byte oids and run with the GIL released — one mutex hop per
    MESSAGE instead of one Python-lock hop per oid.  Callers own the
    16-byte-oid invariant (``object_store`` routes rare odd-size ids to
    the pure-Python twin)."""

    OID = 16
    NUM_REASONS = 8
    MAX_SLOTS = 64

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("native store core unavailable")
        self._lib = lib
        self._h = lib.rtpu_refs_create()
        if not self._h:
            raise OSError("could not create native ref index")

    def ensure(self, packed: bytes, n: int, reason: int) -> None:
        self._lib.rtpu_refs_ensure(self._h, packed, n, reason)

    def contains(self, oid: bytes) -> bool:
        return self._lib.rtpu_refs_contains(self._h, oid) == 1

    def add(self, packed: bytes, n: int, reason: int, delta: int) -> None:
        self._lib.rtpu_refs_add(self._h, packed, n, reason, delta)

    def remove(self, packed: bytes, n: int, reason: int,
               delta: int) -> list:
        """Returns the oids erased by this decrement (count<=0 while
        sealed) — the caller reaps exactly those."""
        buf = (ctypes.c_uint8 * (n * self.OID))()
        dead = self._lib.rtpu_refs_remove(
            self._h, packed, n, reason, delta, buf)
        raw = bytes(buf)
        return [raw[i * self.OID:(i + 1) * self.OID] for i in range(dead)]

    def seal(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_seal(self._h, oid)

    def unseal(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_unseal(self._h, oid)

    def erase(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_erase(self._h, oid)

    def get(self, oid: bytes):
        """(count, sealed, pins[8]) or None."""
        count = ctypes.c_int64()
        sealed = ctypes.c_int32()
        pins = (ctypes.c_int32 * self.NUM_REASONS)()
        rc = self._lib.rtpu_refs_get(self._h, oid, ctypes.byref(count),
                                     ctypes.byref(sealed), pins)
        if rc != 0:
            return None
        return count.value, bool(sealed.value), list(pins)

    def get_batch(self, packed: bytes, n: int):
        """Parallel (counts, pins-rows); missing oids have count None."""
        counts = (ctypes.c_int64 * n)()
        pins = (ctypes.c_int32 * (n * self.NUM_REASONS))()
        self._lib.rtpu_refs_get_batch(self._h, packed, n, counts, pins)
        missing = -(1 << 63)
        out_counts = [None if c == missing else c for c in counts]
        out_pins = [pins[i * self.NUM_REASONS:(i + 1) * self.NUM_REASONS]
                    for i in range(n)]
        return out_counts, out_pins

    def size(self) -> int:
        return self._lib.rtpu_refs_size(self._h)

    def set_origin(self, oid: bytes, slot: int) -> int:
        return self._lib.rtpu_refs_set_origin(self._h, oid, slot)

    def add_replica(self, oid: bytes, slot: int) -> int:
        return self._lib.rtpu_refs_add_replica(self._h, oid, slot)

    def pop_replica(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_pop_replica(self._h, oid)

    def num_replicas(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_num_replicas(self._h, oid)

    def replica_mask(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_replica_mask(self._h, oid)

    def clear_replicas(self, oid: bytes) -> int:
        return self._lib.rtpu_refs_clear_replicas(self._h, oid)

    def drop_slot(self, slot: int) -> None:
        self._lib.rtpu_refs_drop_slot(self._h, slot)

    def locate(self, packed: bytes, n: int, prefer_slot: int) -> list:
        out = (ctypes.c_int32 * n)()
        self._lib.rtpu_refs_locate(self._h, packed, n, prefer_slot, out)
        return list(out)

    def clear(self) -> None:
        self._lib.rtpu_refs_clear(self._h)


def available() -> bool:
    return load() is not None
