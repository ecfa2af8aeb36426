"""Packed codec for the hot control-plane frames.

The protobuf Envelope arm (wire.py) is the versioned IDL, but its pure-
Python message construction costs ~50-90us/task — measured at ~19% of
no-op task throughput on a 1-core head (VERDICT Weak #3).  This module
is the same schema (field-for-field from ``ray_tpu_torch/protocol/
ray_tpu_torch.proto``; test_wire pins the tables against the generated
descriptors so codec and IDL cannot drift) hand-lowered to struct-packed
fixed headers + length-prefixed blobs: no per-field reflection, no
message-object allocation — just ``struct.pack_into``-grade appends and
one ``b"".join``.  That takes the typed arm's overhead to low single
digits, which is what lets ``RAY_TPU_TORCH_WIRE=proto`` be the DEFAULT.

Only the frame types that dominate a task wave are packed —
submit_batch, execute, task_done, seal, add_ref, remove_ref,
metrics_report, plus the get/wait request/reply RTT path (one location
per ref: per-field protobuf construction there was the single largest
typed-arm cost of a wave).  Everything else keeps the Envelope arm
(typed, slower, rare) or the raw-pickle long tail.  Wire interop is by first-byte
sniffing, same as the other two encodings: raw pickle starts ``0x80``,
an Envelope starts with the version tag ``0x08``, a packed frame starts
with the magic ``0xB1`` — receivers accept all three at any time, so
mixed clusters and rolling flag flips just work.

Frame layout::

    0xB1 | version u8 | frame-id u8 | frame-specific payload

Size gate: any frame that would reach the 2 GiB interop cap returns
``None`` (encode() in wire.py then falls through to the Envelope arm and
its own gates, landing on raw pickle which has no cap).  u32 length
prefixes additionally hard-fail past 4 GiB via struct.error, which the
same ``None`` path absorbs — an oversize payload can never produce a
frame a peer cannot parse.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Dict, Optional

from ray_tpu_torch._private.object_store import ObjectLocation

MAGIC = 0xB1
MAGIC_BYTE = b"\xb1"
PACKED_VERSION = 1

_PICKLE_PROTO = pickle.HIGHEST_PROTOCOL
# same interop cap as wire._PB_MAX_FRAME (tests monkeypatch this one)
_MAX_FRAME = (1 << 31) - (1 << 20)

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_pu8 = _U8.pack
_pu16 = _U16.pack
_pu32 = _U32.pack
_pi64 = _I64.pack
_pf64 = _F64.pack


class _TooBig(ValueError):
    """A blob at/past the interop cap: take the fallback arm."""


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _ab(parts, b) -> None:  # bytes, u32 length prefix
    if len(b) >= _MAX_FRAME:
        raise _TooBig
    parts.append(_pu32(len(b)))
    parts.append(bytes(b))


def _as(parts, s: str) -> None:  # str
    b = s.encode("utf-8")
    parts.append(_pu32(len(b)))
    parts.append(b)


def _albytes(parts, items) -> None:  # list of bytes
    parts.append(_pu32(len(items)))
    for b in items:
        parts.append(_pu32(len(b)))
        parts.append(bytes(b))


def _gb(data, off):  # -> (bytes, off)
    (n,) = _U32.unpack_from(data, off)
    off += 4
    return data[off:off + n], off + n


def _gs(data, off):  # -> (str, off)
    (n,) = _U32.unpack_from(data, off)
    off += 4
    return str(data[off:off + n], "utf-8"), off + n


def _glbytes(data, off):  # -> (list[bytes], off)
    (n,) = _U32.unpack_from(data, off)
    off += 4
    out = []
    u32 = _U32.unpack_from
    for _ in range(n):
        (m,) = u32(data, off)
        off += 4
        out.append(data[off:off + m])
        off += m
    return out, off


# ---------------------------------------------------------------------------
# ObjectLocation <-> packed (presence bitmask + values in bit order)
# ---------------------------------------------------------------------------

_L_INLINE, _L_SHM, _L_SPILL, _L_SIZE, _L_ERR, _L_NODE, _L_FETCH, \
    _L_APATH, _L_AOFF, _L_AKEY = (1 << i for i in range(10))


def _pack_loc(parts, loc: ObjectLocation) -> None:
    # None is NOT accepted: the TypeError falls back to the pickle arm,
    # which preserves None exactly (a dep can unseal between scheduling
    # and dispatch) — the same contract as the Envelope arm's _loc_to_pb.
    # Straight-line, helpers inlined: locations ride in every seal /
    # execute / task_done frame.
    ap = parts.append
    pu32 = _pu32
    flag_slot = len(parts)
    ap(b"")
    flags = 0
    v = loc.inline
    if v is not None:
        if len(v) >= _MAX_FRAME:
            raise _TooBig
        flags = _L_INLINE
        ap(pu32(len(v)))
        ap(bytes(v))
    v = loc.shm_name
    if v is not None:
        flags |= _L_SHM
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    v = loc.spilled_path
    if v is not None:
        flags |= _L_SPILL
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    if loc.size:
        flags |= _L_SIZE
        ap(_pi64(loc.size))
    if loc.is_error:
        flags |= _L_ERR
    v = loc.node_id
    if v:
        flags |= _L_NODE
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    v = loc.fetch_addr
    if v is not None:
        flags |= _L_FETCH
        b = str(v[0]).encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
        ap(pu32(int(v[1])))
    v = loc.arena_path
    if v is not None:
        flags |= _L_APATH
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    if loc.arena_off:
        flags |= _L_AOFF
        ap(_pi64(loc.arena_off))
    v = loc.arena_key
    if v is not None:
        flags |= _L_AKEY
        ap(pu32(len(v)))
        ap(v)
    parts[flag_slot] = _pu16(flags)


def _unpack_loc(data, off):
    (flags,) = _U16.unpack_from(data, off)
    off += 2
    u32 = _U32.unpack_from
    inline = shm = spill = apath = akey = fetch = None
    size = aoff = 0
    node = ""
    if flags & _L_INLINE:
        (n,) = u32(data, off)
        off += 4
        inline = data[off:off + n]
        off += n
    if flags & _L_SHM:
        (n,) = u32(data, off)
        off += 4
        shm = str(data[off:off + n], "utf-8")
        off += n
    if flags & _L_SPILL:
        (n,) = u32(data, off)
        off += 4
        spill = str(data[off:off + n], "utf-8")
        off += n
    if flags & _L_SIZE:
        (size,) = _I64.unpack_from(data, off)
        off += 8
    if flags & _L_NODE:
        (n,) = u32(data, off)
        off += 4
        node = str(data[off:off + n], "utf-8")
        off += n
    if flags & _L_FETCH:
        (n,) = u32(data, off)
        off += 4
        host = str(data[off:off + n], "utf-8")
        off += n
        (port,) = u32(data, off)
        off += 4
        fetch = (host, port)
    if flags & _L_APATH:
        (n,) = u32(data, off)
        off += 4
        apath = str(data[off:off + n], "utf-8")
        off += n
    if flags & _L_AOFF:
        (aoff,) = _I64.unpack_from(data, off)
        off += 8
    if flags & _L_AKEY:
        (n,) = u32(data, off)
        off += 4
        akey = data[off:off + n]
        off += n
    return ObjectLocation(
        inline=inline, shm_name=shm, spilled_path=spill, size=size,
        is_error=bool(flags & _L_ERR), node_id=node, fetch_addr=fetch,
        arena_path=apath, arena_off=aoff, arena_key=akey,
    ), off


# ---------------------------------------------------------------------------
# TaskSpec <-> packed (presence-mask u32; bit = .proto field number - 1)
# ---------------------------------------------------------------------------
# The codec is STRAIGHT-LINE on both sides — no per-field dispatch, no
# message objects; one u32 presence mask, then values in field order.
# kinds: b bytes, s str, i int(i64), f bool-flag, L bytes-list,
#        P pickled, R resources map
_SPEC_FIELDS = {
    "task_id": (1, "b"), "name": (2, "s"), "fn_id": (3, "b"),
    "args_blob": (4, "b"), "args_oid": (5, "b"), "dep_ids": (6, "L"),
    "pinned_refs": (7, "L"), "owned_oids": (8, "L"), "return_ids": (9, "L"),
    "num_returns": (10, "i"), "resources": (11, "R"),
    "scheduling_strategy": (12, "P"), "retries_left": (13, "i"),
    "actor_id": (14, "b"), "method_name": (15, "s"),
    "is_actor_creation": (16, "f"), "max_restarts": (17, "i"),
    "max_task_retries": (18, "i"), "actor_name": (19, "s"),
    "runtime_env": (20, "P"), "max_concurrency": (21, "i"),
    "release_cpu_after_start": (22, "f"), "parent_task_id": (23, "b"),
}
_EXTRA_FIELD = 24  # pickled dict of spec keys not covered above
_EXTRA_BIT = 1 << (_EXTRA_FIELD - 1)
_SPEC_KEYSET = frozenset(_SPEC_FIELDS)


def _pack_spec(parts, spec: Dict[str, Any]) -> None:
    # Mirrors wire._spec_to_pb's normalization: absent/None scalars and
    # proto3-zero values are dropped, pickled fields keep None exactly,
    # unknown keys ride one pickled "extra" blob.  Field access is
    # explicit (one dict.get per field): measured ~4x faster than
    # iterate-and-dispatch for a 17-field spec.
    ap = parts.append
    pu32 = _pu32
    mask_slot = len(parts)
    ap(b"")  # presence-mask placeholder, patched at the end
    mask = 0
    get = spec.get
    v = get("task_id")
    if v is not None:
        mask |= 1
        ap(pu32(len(v)))
        ap(v)
    v = get("name")
    if v is not None:
        mask |= 2
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    v = get("fn_id")
    if v is not None:
        mask |= 4
        ap(pu32(len(v)))
        ap(v)
    v = get("args_blob")
    if v is not None:
        if len(v) >= _MAX_FRAME:
            raise _TooBig
        mask |= 8
        ap(pu32(len(v)))
        ap(v)
    v = get("args_oid")
    if v is not None:
        mask |= 16
        ap(pu32(len(v)))
        ap(v)
    v = get("dep_ids")
    if v:
        mask |= 32
        ap(pu32(len(v)))
        for b in v:
            ap(pu32(len(b)))
            ap(b)
    v = get("pinned_refs")
    if v:
        mask |= 64
        ap(pu32(len(v)))
        for b in v:
            ap(pu32(len(b)))
            ap(b)
    v = get("owned_oids")
    if v:
        mask |= 128
        ap(pu32(len(v)))
        for b in v:
            ap(pu32(len(b)))
            ap(b)
    v = get("return_ids")
    if v:
        mask |= 256
        ap(pu32(len(v)))
        for b in v:
            ap(pu32(len(b)))
            ap(b)
    v = get("num_returns")
    if v:
        mask |= 512
        ap(_pi64(v))
    v = get("resources")
    if v:
        mask |= 1024
        ap(pu32(len(v)))
        for rk, rv in v.items():
            b = rk.encode("utf-8")
            ap(pu32(len(b)))
            ap(b)
            # validate_options doesn't type-check custom resource
            # amounts; coerce so e.g. {"accel": "1"} stays schedulable
            ap(_pf64(float(rv)))
    if "scheduling_strategy" in spec:
        mask |= 2048
        b = pickle.dumps(spec["scheduling_strategy"], _PICKLE_PROTO)
        ap(pu32(len(b)))
        ap(b)
    v = get("retries_left")
    if v:
        mask |= 4096
        ap(_pi64(v))
    v = get("actor_id")
    if v is not None:
        mask |= 8192
        ap(pu32(len(v)))
        ap(v)
    v = get("method_name")
    if v is not None:
        mask |= 16384
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    if get("is_actor_creation"):
        mask |= 32768
    v = get("max_restarts")
    if v:
        mask |= 65536
        ap(_pi64(v))
    v = get("max_task_retries")
    if v:
        mask |= 131072
        ap(_pi64(v))
    v = get("actor_name")
    if v is not None:
        mask |= 262144
        b = v.encode("utf-8")
        ap(pu32(len(b)))
        ap(b)
    if "runtime_env" in spec:
        mask |= 524288
        b = pickle.dumps(spec["runtime_env"], _PICKLE_PROTO)
        ap(pu32(len(b)))
        ap(b)
    v = get("max_concurrency")
    if v:
        mask |= 1048576
        ap(_pi64(v))
    if get("release_cpu_after_start"):
        mask |= 2097152
    v = get("parent_task_id")
    if v is not None:
        mask |= 4194304
        ap(pu32(len(v)))
        ap(v)
    # unknown long tail -> one pickled blob (forward compat: trace_ctx,
    # dynamic_returns, concurrency_group, ...)
    if not (spec.keys() <= _SPEC_KEYSET):
        extra = {k: spec[k] for k in spec if k not in _SPEC_KEYSET}
        mask |= _EXTRA_BIT
        b = pickle.dumps(extra, _PICKLE_PROTO)
        ap(pu32(len(b)))
        ap(b)
    parts[mask_slot] = pu32(mask)


def _unpack_spec(mv, off):
    (mask,) = _U32.unpack_from(mv, off)
    off += 4
    spec: Dict[str, Any] = {}
    u32 = _U32.unpack_from
    i64 = _I64.unpack_from
    if mask & 1:
        (n,) = u32(mv, off)
        off += 4
        spec["task_id"] = mv[off:off + n]
        off += n
    if mask & 2:
        (n,) = u32(mv, off)
        off += 4
        spec["name"] = str(mv[off:off + n], "utf-8")
        off += n
    if mask & 4:
        (n,) = u32(mv, off)
        off += 4
        spec["fn_id"] = mv[off:off + n]
        off += n
    if mask & 8:
        (n,) = u32(mv, off)
        off += 4
        spec["args_blob"] = mv[off:off + n]
        off += n
    if mask & 16:
        (n,) = u32(mv, off)
        off += 4
        spec["args_oid"] = mv[off:off + n]
        off += n
    for bit, key in ((32, "dep_ids"), (64, "pinned_refs"),
                     (128, "owned_oids"), (256, "return_ids")):
        if mask & bit:
            (cnt,) = u32(mv, off)
            off += 4
            items = []
            for _ in range(cnt):
                (n,) = u32(mv, off)
                off += 4
                items.append(mv[off:off + n])
                off += n
            spec[key] = items
    if mask & 512:
        (spec["num_returns"],) = i64(mv, off)
        off += 8
    if mask & 1024:
        (cnt,) = u32(mv, off)
        off += 4
        res = {}
        for _ in range(cnt):
            (n,) = u32(mv, off)
            off += 4
            rk = str(mv[off:off + n], "utf-8")
            off += n
            (res[rk],) = _F64.unpack_from(mv, off)
            off += 8
        spec["resources"] = res
    if mask & 2048:
        (n,) = u32(mv, off)
        off += 4
        spec["scheduling_strategy"] = pickle.loads(mv[off:off + n])
        off += n
    if mask & 4096:
        (spec["retries_left"],) = i64(mv, off)
        off += 8
    if mask & 8192:
        (n,) = u32(mv, off)
        off += 4
        spec["actor_id"] = mv[off:off + n]
        off += n
    if mask & 16384:
        (n,) = u32(mv, off)
        off += 4
        spec["method_name"] = str(mv[off:off + n], "utf-8")
        off += n
    if mask & 32768:
        spec["is_actor_creation"] = True
    if mask & 65536:
        (spec["max_restarts"],) = i64(mv, off)
        off += 8
    if mask & 131072:
        (spec["max_task_retries"],) = i64(mv, off)
        off += 8
    if mask & 262144:
        (n,) = u32(mv, off)
        off += 4
        spec["actor_name"] = str(mv[off:off + n], "utf-8")
        off += n
    if mask & 524288:
        (n,) = u32(mv, off)
        off += 4
        spec["runtime_env"] = pickle.loads(mv[off:off + n])
        off += n
    if mask & 1048576:
        (spec["max_concurrency"],) = i64(mv, off)
        off += 8
    if mask & 2097152:
        spec["release_cpu_after_start"] = True
    if mask & 4194304:
        (n,) = u32(mv, off)
        off += 4
        spec["parent_task_id"] = mv[off:off + n]
        off += n
    if mask & _EXTRA_BIT:
        (n,) = u32(mv, off)
        off += 4
        spec.update(pickle.loads(mv[off:off + n]))
        off += n
    # the four always-present keys (stripped-dict form invariant)
    spec.setdefault("task_id", b"")
    spec.setdefault("name", "")
    spec.setdefault("return_ids", [])
    spec.setdefault("num_returns", 0)
    return spec, off


def _pack_seal_entry(parts, oid, loc, contained) -> None:
    _ab(parts, oid)
    _pack_loc(parts, loc)
    _albytes(parts, list(contained or ()))


def _unpack_seal_entry(mv, off):
    oid, off = _gb(mv, off)
    loc, off = _unpack_loc(mv, off)
    contained, off = _glbytes(mv, off)
    return oid, loc, contained, off


# ---------------------------------------------------------------------------
# frame packers: msg dict -> parts (raise to fall back)
# ---------------------------------------------------------------------------

def _pack_submit_batch(parts, msg) -> None:
    batch = msg["batch"]
    if len(msg) != 2:
        raise ValueError("extra keys")
    parts.append(_pu32(len(batch)))
    for kind, spec in batch:
        _as(parts, kind)
        _pack_spec(parts, spec)


def _unpack_submit_batch(mv, off):
    (n,) = _U32.unpack_from(mv, off)
    off += 4
    batch = []
    for _ in range(n):
        kind, off = _gs(mv, off)
        spec, off = _unpack_spec(mv, off)
        batch.append((kind, spec))
    return {"type": "submit_batch", "batch": batch}


_EXECUTE_KEYS = frozenset(("type", "spec", "dep_locs", "gpu_ids"))


def _pack_execute(parts, msg) -> None:
    if not (msg.keys() <= _EXECUTE_KEYS):
        raise ValueError("extra keys")
    _pack_spec(parts, msg["spec"])
    dep_locs = msg.get("dep_locs") or {}
    parts.append(_pu32(len(dep_locs)))
    for oid, loc in dep_locs.items():
        _ab(parts, oid)
        _pack_loc(parts, loc)  # None dep -> TypeError -> pickle arm
    gpu_ids = msg.get("gpu_ids") or ()
    parts.append(_pu32(len(gpu_ids)))
    for t in gpu_ids:
        parts.append(_pi64(t))


def _unpack_execute(mv, off):
    spec, off = _unpack_spec(mv, off)
    out: Dict[str, Any] = {"type": "execute", "spec": spec}
    (n,) = _U32.unpack_from(mv, off)
    off += 4
    if n:
        dep_locs = {}
        for _ in range(n):
            oid, off = _gb(mv, off)
            dep_locs[oid], off = _unpack_loc(mv, off)
        out["dep_locs"] = dep_locs
    (n,) = _U32.unpack_from(mv, off)
    off += 4
    if n:
        gpus = []
        for _ in range(n):
            (t,) = _I64.unpack_from(mv, off)
            off += 8
            gpus.append(t)
        out["gpu_ids"] = gpus
    return out


_TD_CREATION, _TD_ACTOR, _TD_NAME, _TD_FAILED, _TD_ERRSTR, _TD_EXTRA = (
    1, 2, 4, 8, 16, 32)
_TASK_DONE_KEYS = frozenset((
    "type", "seals", "spec_ref", "failed", "error_str", "exec_start",
    "exec_end", "worker_pid",
))
_TASK_DONE_REF_KEYS = frozenset((
    "task_id", "return_ids", "is_actor_creation", "actor_id", "name",
))


def _pack_task_done(parts, msg) -> None:
    parts.append(b"")  # seal-count placeholder patched below
    slot = len(parts) - 1
    n = 0
    for oid, loc, contained in msg.get("seals", ()):
        _pack_seal_entry(parts, oid, loc, contained)
        n += 1
    parts[slot] = _pu32(n)
    ref = msg["spec_ref"]
    if not (ref.keys() <= _TASK_DONE_REF_KEYS):
        raise ValueError("extra spec_ref keys")  # -> pickle arm
    _ab(parts, ref["task_id"])
    _albytes(parts, ref.get("return_ids", ()))
    if msg.keys() <= _TASK_DONE_KEYS:  # the common shape: no long tail
        rest = None
    else:
        rest = {k: v for k, v in msg.items() if k not in _TASK_DONE_KEYS}
    flags = 0
    if ref.get("is_actor_creation"):
        flags |= _TD_CREATION
    if ref.get("actor_id") is not None:
        flags |= _TD_ACTOR
    if ref.get("name") is not None:
        flags |= _TD_NAME
    if msg.get("failed"):
        flags |= _TD_FAILED
    if msg.get("error_str") is not None:
        flags |= _TD_ERRSTR
    if rest:
        flags |= _TD_EXTRA
    parts.append(_pu8(flags))
    if flags & _TD_ACTOR:
        _ab(parts, ref["actor_id"])
    if flags & _TD_NAME:
        _as(parts, ref["name"])
    if flags & _TD_ERRSTR:
        _as(parts, msg["error_str"])
    parts.append(_pf64(msg.get("exec_start", 0.0)))
    parts.append(_pf64(msg.get("exec_end", 0.0)))
    parts.append(_pi64(msg.get("worker_pid", 0)))
    if flags & _TD_EXTRA:
        _ab(parts, pickle.dumps(rest, _PICKLE_PROTO))


def _unpack_task_done(mv, off):
    (n,) = _U32.unpack_from(mv, off)
    off += 4
    seals = []
    for _ in range(n):
        oid, loc, contained, off = _unpack_seal_entry(mv, off)
        seals.append((oid, loc, contained))
    task_id, off = _gb(mv, off)
    return_ids, off = _glbytes(mv, off)
    (flags,) = _U8.unpack_from(mv, off)
    off += 1
    actor_id = name = error_str = None
    if flags & _TD_ACTOR:
        actor_id, off = _gb(mv, off)
    if flags & _TD_NAME:
        name, off = _gs(mv, off)
    if flags & _TD_ERRSTR:
        error_str, off = _gs(mv, off)
    (exec_start,) = _F64.unpack_from(mv, off)
    off += 8
    (exec_end,) = _F64.unpack_from(mv, off)
    off += 8
    (worker_pid,) = _I64.unpack_from(mv, off)
    off += 8
    out = {
        "type": "task_done",
        "seals": seals,
        "spec_ref": {
            "task_id": task_id,
            "return_ids": return_ids,
            "is_actor_creation": bool(flags & _TD_CREATION) or None,
            "actor_id": actor_id,
            "name": name,
        },
        "failed": bool(flags & _TD_FAILED),
        "error_str": error_str,
        "exec_start": exec_start,
        "exec_end": exec_end,
        "worker_pid": worker_pid,
    }
    if flags & _TD_EXTRA:
        blob, off = _gb(mv, off)
        out.update(pickle.loads(blob))
    return out


_SEAL_KEYS = frozenset(("type", "oid", "loc", "contained"))


def _pack_seal(parts, msg) -> None:
    if not (msg.keys() <= _SEAL_KEYS):
        raise ValueError("extra keys")
    _pack_seal_entry(parts, msg["oid"], msg["loc"], msg.get("contained", ()))


def _unpack_seal(mv, off):
    oid, loc, contained, off = _unpack_seal_entry(mv, off)
    return {"type": "seal", "oid": oid, "loc": loc, "contained": contained}


_REF_KEYS = frozenset(("type", "oids", "reason"))


def _pack_ref(parts, msg) -> None:
    # carries the pin reason (the Envelope RefUpdate arm predates it and
    # falls back to pickle for non-handle reasons)
    if not (msg.keys() <= _REF_KEYS):
        raise ValueError("extra keys")
    ap = parts.append
    pu32 = _pu32
    b = msg.get("reason", "handle").encode("utf-8")
    ap(pu32(len(b)))
    ap(b)
    oids = msg["oids"]
    ap(pu32(len(oids)))
    for o in oids:
        ap(pu32(len(o)))
        ap(o)


def _unpack_add_ref(mv, off):
    reason, off = _gs(mv, off)
    oids, off = _glbytes(mv, off)
    return {"type": "add_ref", "oids": oids, "reason": reason}


def _unpack_remove_ref(mv, off):
    reason, off = _gs(mv, off)
    oids, off = _glbytes(mv, off)
    return {"type": "remove_ref", "oids": oids, "reason": reason}


_GETLOC_KEYS = frozenset(("type", "oids", "timeout", "req_id"))
_WAIT_KEYS = frozenset(("type", "oids", "num_returns", "timeout", "req_id"))


def _pack_get_locations(parts, msg) -> None:
    if not (msg.keys() <= _GETLOC_KEYS):
        raise ValueError("extra keys")
    ap = parts.append
    pu32 = _pu32
    oids = msg["oids"]
    ap(pu32(len(oids)))
    for o in oids:
        ap(pu32(len(o)))
        ap(o)
    t = msg.get("timeout")
    if t is None:
        ap(b"\x00")
    else:
        ap(b"\x01")
        ap(_pf64(t))
    ap(_pi64(msg["req_id"]))


def _unpack_get_locations(data, off):
    oids, off = _glbytes(data, off)
    has_t = data[off]
    off += 1
    timeout = None
    if has_t:
        (timeout,) = _F64.unpack_from(data, off)
        off += 8
    (req_id,) = _I64.unpack_from(data, off)
    return {"type": "get_locations", "oids": oids, "timeout": timeout,
            "req_id": req_id}


def _pack_wait(parts, msg) -> None:
    if not (msg.keys() <= _WAIT_KEYS):
        raise ValueError("extra keys")
    ap = parts.append
    pu32 = _pu32
    oids = msg["oids"]
    ap(pu32(len(oids)))
    for o in oids:
        ap(pu32(len(o)))
        ap(o)
    ap(_pi64(msg["num_returns"]))
    t = msg.get("timeout")
    if t is None:
        ap(b"\x00")
    else:
        ap(b"\x01")
        ap(_pf64(t))
    ap(_pi64(msg["req_id"]))


def _unpack_wait(data, off):
    oids, off = _glbytes(data, off)
    (num_returns,) = _I64.unpack_from(data, off)
    off += 8
    has_t = data[off]
    off += 1
    timeout = None
    if has_t:
        (timeout,) = _F64.unpack_from(data, off)
        off += 8
    (req_id,) = _I64.unpack_from(data, off)
    return {"type": "wait", "oids": oids, "num_returns": num_returns,
            "timeout": timeout, "req_id": req_id}


# reply shapes (the ray.get/ray.wait RTT path — one location per ref, so
# per-field protobuf construction here was the dominant typed-arm cost
# of a task wave); only the three get/wait shapes are typed, like the
# Envelope arm — anything else falls back to pickle
_REPLY_GET = frozenset(("type", "req_id", "locations"))
_REPLY_TIMEOUT = frozenset(("type", "req_id", "timeout"))
_REPLY_WAIT = frozenset(("type", "req_id", "ready", "locations"))
_RP_TIMEOUT, _RP_WAIT = 1, 2


def _pack_reply(parts, msg) -> None:
    keys = msg.keys()
    ap = parts.append
    if keys == _REPLY_TIMEOUT and msg["timeout"] is True:
        ap(_pu8(_RP_TIMEOUT))
        ap(_pi64(msg["req_id"]))
        return
    if keys == _REPLY_GET:
        ap(_pu8(0))
    elif keys == _REPLY_WAIT:
        ap(_pu8(_RP_WAIT))
    else:
        raise ValueError("untyped reply shape")  # -> pickle arm
    ap(_pi64(msg["req_id"]))
    locs = msg["locations"]
    ap(_pu32(len(locs)))
    pu32 = _pu32
    for oid, loc in locs.items():
        ap(pu32(len(oid)))
        ap(oid)
        _pack_loc(parts, loc)  # None -> TypeError -> pickle (exactness)
    if keys == _REPLY_WAIT:
        ready = msg["ready"]
        ap(pu32(len(ready)))
        for o in ready:
            ap(pu32(len(o)))
            ap(o)


def _unpack_reply(data, off):
    flags = data[off]
    off += 1
    (req_id,) = _I64.unpack_from(data, off)
    off += 8
    if flags & _RP_TIMEOUT:
        return {"type": "reply", "req_id": req_id, "timeout": True}
    (n,) = _U32.unpack_from(data, off)
    off += 4
    locations = {}
    u32 = _U32.unpack_from
    for _ in range(n):
        (m,) = u32(data, off)
        off += 4
        oid = data[off:off + m]
        off += m
        locations[oid], off = _unpack_loc(data, off)
    out = {"type": "reply", "req_id": req_id, "locations": locations}
    if flags & _RP_WAIT:
        out["ready"], off = _glbytes(data, off)
    return out


def _pack_metrics_report(parts, msg) -> None:
    # header typed, metrics payload opaque (a deeply dynamic snapshot
    # dict — same role as the IDL's bytes fields for language-serialized
    # payloads); the win over the Envelope arm is skipping the message
    # build entirely on the every-2s per-process push path
    if msg.keys() != {"type", "origin", "metrics"}:
        raise ValueError("extra keys")
    _as(parts, msg["origin"])
    _ab(parts, pickle.dumps(msg["metrics"], _PICKLE_PROTO))


def _unpack_metrics_report(mv, off):
    origin, off = _gs(mv, off)
    blob, off = _gb(mv, off)
    return {"type": "metrics_report", "origin": origin,
            "metrics": pickle.loads(blob)}


# ---------------------------------------------------------------------------
# dispatch tables — raylint R1 checks these three stay in lockstep
# ---------------------------------------------------------------------------

_FRAME_IDS = {
    "submit_batch": 1,
    "execute": 2,
    "task_done": 3,
    "seal": 4,
    "add_ref": 5,
    "remove_ref": 6,
    "metrics_report": 7,
    "get_locations": 8,
    "wait": 9,
    "reply": 10,
}

_PACK = {
    "submit_batch": _pack_submit_batch,
    "execute": _pack_execute,
    "task_done": _pack_task_done,
    "seal": _pack_seal,
    "add_ref": _pack_ref,
    "remove_ref": _pack_ref,
    "metrics_report": _pack_metrics_report,
    "get_locations": _pack_get_locations,
    "wait": _pack_wait,
    "reply": _pack_reply,
}

_UNPACK = {
    "submit_batch": _unpack_submit_batch,
    "execute": _unpack_execute,
    "task_done": _unpack_task_done,
    "seal": _unpack_seal,
    "add_ref": _unpack_add_ref,
    "remove_ref": _unpack_remove_ref,
    "metrics_report": _unpack_metrics_report,
    "get_locations": _unpack_get_locations,
    "wait": _unpack_wait,
    "reply": _unpack_reply,
}

_BY_ID = {fid: _UNPACK[name] for name, fid in _FRAME_IDS.items()}


def encode(msg: Dict[str, Any]) -> Optional[bytes]:
    """Packed frame for a hot message, or None (caller falls back to the
    Envelope arm).  Never raises: any unexpected shape, oversize blob, or
    u32 overflow lands on None — the fallback arms are always valid."""
    packer = _PACK.get(msg.get("type"))
    if packer is None:
        return None
    parts = [MAGIC_BYTE, _pu8(PACKED_VERSION), _pu8(_FRAME_IDS[msg["type"]])]
    try:
        packer(parts, msg)
        out = b"".join(parts)
    except (KeyError, TypeError, ValueError, struct.error, OverflowError,
            AttributeError):
        return None
    if len(out) >= _MAX_FRAME:
        # the whole-frame gate (many small blobs can add up past the cap
        # even when no single one trips _ab's per-blob gate)
        return None
    return out


def decode(data: bytes) -> Dict[str, Any]:
    """Decode a packed frame (caller checked the magic byte)."""
    version = data[1]
    if version != PACKED_VERSION:
        raise ValueError(f"packed wire version {version} != {PACKED_VERSION}")
    unpacker = _BY_ID.get(data[2])
    if unpacker is None:
        raise ValueError(f"unknown packed frame id {data[2]}")
    return unpacker(data, 3)
