"""Typed wire codec for the control plane.

Every control-plane frame is one ``protocol.Envelope`` (see
``ray_tpu_torch/protocol/ray_tpu_torch.proto``) carried over the existing
length-prefixed connection framing.  Hot-path messages — task
submission batches, execute dispatches, task completions, seals,
refcount updates, KV ops, get/wait and their replies — encode as typed
protobuf; the long tail rides the ``pickled`` fallback arm unchanged.
This is the reference's protobuf-over-gRPC L0 re-shaped for a
socket-multiplexed control plane (``src/ray/protobuf/common.proto``
TaskSpec: typed spec, language-serialized arg blobs as bytes).

Handlers keep their dict interface: ``encode``/``decode`` translate
dict <-> Envelope, and ``WireConnection`` swaps the codec in under any
``multiprocessing.connection.Connection`` via send_bytes/recv_bytes.

Interop: a pickle frame starts with opcode 0x80; an Envelope always
starts with the version varint tag 0x08; a PACKED frame (packed_wire.py
— the hot ~7 frame types lowered to struct-packed headers, no protobuf
reflection) starts with the magic 0xB1 — receivers sniff the first
byte, so all three encodings are always accepted.  Untyped long-tail
messages are sent as RAW pickle frames (no envelope wrap): that avoids
double-copying the payload and protobuf's 2 GiB message cap.

Encoding selection (``RAY_TPU_TORCH_WIRE``): every connection RECEIVES
through the sniffing decoder — mixed clusters interoperate — and the
flag selects only what a process SENDS.  The DEFAULT is ``proto``: hot
frames take the packed codec (low-single-digit % overhead vs raw
pickle — the packed headers cost ~2-6us/frame where the pure-Python
protobuf Envelope cost ~50-90us/task, ~19% of no-op throughput on a
1-core head), other typed frames take the Envelope arm, and the long
tail rides raw pickle.  ``envelope`` forces the protobuf arm for every
typed frame (the packed codec off — the IDL-conformance arm a
cross-language peer would speak); ``pickle`` restores the raw-pickle
fast path everywhere (the pre-flip default, still fully supported).
The suite pins RAY_TPU_TORCH_WIRE=proto in tests/conftest.py (redundant with
the default, but explicit), and test_wire.py cluster-tests the pickle
and mixed-mode arms via subprocess drivers.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

from ray_tpu_torch._private import packed_wire
from ray_tpu_torch._private.object_store import ObjectLocation
from ray_tpu_torch.protocol import ray_tpu_torch_pb2 as pb

WIRE_VERSION = 1

_PICKLE_PROTO = pickle.HIGHEST_PROTOCOL

# Largest Envelope a peer is guaranteed to parse: protobuf's 2 GiB message
# cap, with headroom for field tags/framing around the payload.  Frames at
# or past this take the raw-pickle arm (no cap there).
_PB_MAX_FRAME = (1 << 31) - (1 << 20)

try:
    from google.protobuf.message import EncodeError as _EncodeError
except Exception:  # pragma: no cover — protobuf always present in-image
    class _EncodeError(Exception):
        pass


class WireDecodeError(pickle.UnpicklingError):
    """Bad frame.  Subclasses UnpicklingError so every existing
    reader-loop ``except`` clause treats it as a broken connection."""


# ---------------------------------------------------------------------------
# field helpers

def _loc_to_pb(loc: ObjectLocation) -> pb.ObjectLocation:
    # None is NOT accepted: encoders catch the TypeError and fall back
    # to the pickle arm, which preserves None exactly (a dep can unseal
    # between scheduling and dispatch).  Single constructor call — these
    # ride in every seal/location-reply message.
    if loc is None:
        raise TypeError("ObjectLocation is None")
    kw: Dict[str, Any] = {}
    if loc.inline is not None:
        kw["inline"] = bytes(loc.inline)
    if loc.shm_name is not None:
        kw["shm_name"] = loc.shm_name
    if loc.spilled_path is not None:
        kw["spilled_path"] = loc.spilled_path
    if loc.size:
        kw["size"] = loc.size
    if loc.is_error:
        kw["is_error"] = True
    if loc.node_id:
        kw["node_id"] = loc.node_id
    if loc.fetch_addr is not None:
        kw["fetch_host"] = str(loc.fetch_addr[0])
        kw["fetch_port"] = int(loc.fetch_addr[1])
    if loc.arena_path is not None:
        kw["arena_path"] = loc.arena_path
    if loc.arena_off:
        kw["arena_off"] = loc.arena_off
    if loc.arena_key is not None:
        kw["arena_key"] = loc.arena_key
    return pb.ObjectLocation(**kw)


def _loc_from_pb(m: pb.ObjectLocation) -> ObjectLocation:
    return ObjectLocation(
        inline=m.inline if m.HasField("inline") else None,
        shm_name=m.shm_name if m.HasField("shm_name") else None,
        spilled_path=m.spilled_path if m.HasField("spilled_path") else None,
        size=m.size,
        is_error=m.is_error,
        node_id=m.node_id,
        fetch_addr=((m.fetch_host, m.fetch_port)
                    if m.HasField("fetch_host") else None),
        arena_path=m.arena_path if m.HasField("arena_path") else None,
        arena_off=m.arena_off,
        arena_key=m.arena_key if m.HasField("arena_key") else None,
    )


# TaskSpec scalar/bytes/string fields copied 1:1 between dict key and
# proto field; repeated and special fields handled explicitly.
_SPEC_SCALARS = (
    "task_id", "name", "fn_id", "args_blob", "args_oid", "num_returns",
    "retries_left", "actor_id", "method_name", "is_actor_creation",
    "max_restarts", "max_task_retries", "actor_name", "max_concurrency",
    "release_cpu_after_start", "parent_task_id",
)
_SPEC_REPEATED = ("dep_ids", "pinned_refs", "owned_oids", "return_ids")
_SPEC_PICKLED = ("scheduling_strategy", "runtime_env")
_SPEC_KEYS = frozenset(_SPEC_SCALARS + _SPEC_REPEATED + _SPEC_PICKLED
                       + ("resources",))


def _spec_to_pb(spec: Dict[str, Any]) -> pb.TaskSpec:
    # one constructor call (a single C roundtrip under upb — per-field
    # setattr was ~10x slower on the submit hot path); repeated fields
    # take lists and the resources map takes a dict directly
    known: Dict[str, Any] = {}
    extra = None
    for k, v in spec.items():
        if k in _SPEC_KEYS:
            if k in _SPEC_PICKLED:
                known[k] = pickle.dumps(v, _PICKLE_PROTO)
            elif k == "resources":
                # validate_options doesn't type-check custom resource
                # amounts; coerce so e.g. {"accel": "1"} stays schedulable
                known[k] = {rk: float(rv) for rk, rv in v.items()}
            elif v is not None:
                known[k] = v
        else:
            # forward-compat long tail (trace_ctx, dynamic_returns, ...)
            if extra is None:
                extra = {}
            extra[k] = v
    if extra:
        known["extra"] = pickle.dumps(extra, _PICKLE_PROTO)
    return pb.TaskSpec(**known)


_SPEC_REPEATED_SET = frozenset(_SPEC_REPEATED)
_SPEC_PICKLED_SET = frozenset(_SPEC_PICKLED)


def _spec_from_pb(m: pb.TaskSpec) -> Dict[str, Any]:
    # Reconstruct the stripped-dict form: proto default => key absent
    # (build_task_spec drops None/0/False/[] keys), except the four
    # always-present keys.  ListFields() walks only the SET fields — one
    # pass instead of probing all 24.
    spec: Dict[str, Any] = {}
    for fd, v in m.ListFields():
        k = fd.name
        if k in _SPEC_REPEATED_SET:
            spec[k] = list(v)
        elif k in _SPEC_PICKLED_SET or k == "extra":
            if k == "extra":
                spec.update(pickle.loads(v))
            else:
                spec[k] = pickle.loads(v)
        elif k == "resources":
            spec[k] = dict(v)
        else:
            spec[k] = v
    # the four always-present keys (proto3 omits zero-valued scalars)
    spec.setdefault("task_id", m.task_id)
    spec.setdefault("name", m.name)
    spec.setdefault("return_ids", [])
    spec.setdefault("num_returns", m.num_returns)
    return spec


def _seal_to_pb(oid: bytes, loc, contained) -> pb.SealEntry:
    return pb.SealEntry(oid=oid, loc=_loc_to_pb(loc),
                        contained=list(contained or ()))


# ---------------------------------------------------------------------------
# per-type encoders: dict -> Envelope (return None to fall back to pickle)

def _enc_submit_batch(msg, env) -> bool:
    env.submit_batch.items.extend(
        pb.Submit(kind=kind, spec=_spec_to_pb(spec))
        for kind, spec in msg["batch"])
    return True


def _enc_execute(msg, env) -> bool:
    env.execute.MergeFrom(pb.Execute(
        spec=_spec_to_pb(msg["spec"]),
        dep_locs=[pb.LocEntry(oid=oid, loc=_loc_to_pb(loc))
                  for oid, loc in msg.get("dep_locs", {}).items()],
        gpu_ids=msg.get("gpu_ids", ()),
    ))
    return True


_TASK_DONE_KEYS = frozenset((
    "type", "seals", "spec_ref", "failed", "error_str", "exec_start",
    "exec_end", "worker_pid",
))


def _enc_task_done(msg, env) -> bool:
    m = env.task_done
    for oid, loc, contained in msg.get("seals", ()):
        m.seals.append(_seal_to_pb(oid, loc, contained))
    ref = msg["spec_ref"]
    m.task_id = ref["task_id"]
    m.return_ids.extend(ref.get("return_ids", ()))
    if ref.get("is_actor_creation"):
        m.is_actor_creation = True
    if ref.get("actor_id") is not None:
        m.actor_id = ref["actor_id"]
    if ref.get("name") is not None:
        m.name = ref["name"]
    if msg.get("failed"):
        m.failed = True
    if msg.get("error_str") is not None:
        m.error_str = msg["error_str"]
    m.exec_start = msg.get("exec_start", 0.0)
    m.exec_end = msg.get("exec_end", 0.0)
    m.worker_pid = msg.get("worker_pid", 0)
    rest = {k: v for k, v in msg.items() if k not in _TASK_DONE_KEYS}
    if rest:
        m.extra = pickle.dumps(rest, _PICKLE_PROTO)
    return True


def _enc_seal(msg, env) -> bool:
    env.seal.CopyFrom(
        _seal_to_pb(msg["oid"], msg["loc"], msg.get("contained", ())))
    return True


def _enc_add_ref(msg, env) -> bool:
    if msg.get("reason", "handle") != "handle":
        # the RefUpdate schema predates pin reasons: encoding here would
        # silently drop the reason and skew the head's pin-reason audit.
        # The packed arm carries it; this Envelope fallback preserves it
        # via the pickle arm.
        return False
    env.add_ref.oids.extend(msg["oids"])
    return True


def _enc_remove_ref(msg, env) -> bool:
    if msg.get("reason", "handle") != "handle":
        return False  # see _enc_add_ref
    env.remove_ref.oids.extend(msg["oids"])
    return True


def _enc_kv_put(msg, env) -> bool:
    if len(msg["value"]) >= _PB_MAX_FRAME:
        # size-gate the one arm that carries unbounded bytes BEFORE
        # copying them into the Envelope: a near-/over-2 GiB value would
        # serialize (upb has no encode cap) into a frame no receiving
        # backend can parse — the raw-pickle frame has no such cap
        return False
    env.kv_put.ns = msg["ns"]
    env.kv_put.key = msg["key"]
    env.kv_put.value = msg["value"]
    return True


def _enc_kv_get(msg, env) -> bool:
    env.kv_get.ns = msg["ns"]
    env.kv_get.key = msg["key"]
    env.kv_get.req_id = msg["req_id"]
    return True


def _enc_get_locations(msg, env) -> bool:
    m = env.get_locations
    m.oids.extend(msg["oids"])
    if msg.get("timeout") is not None:
        m.timeout = msg["timeout"]
    m.req_id = msg["req_id"]
    return True


def _enc_wait(msg, env) -> bool:
    m = env.wait
    m.oids.extend(msg["oids"])
    m.num_returns = msg["num_returns"]
    if msg.get("timeout") is not None:
        m.timeout = msg["timeout"]
    m.req_id = msg["req_id"]
    return True


_REPLY_GET = frozenset(("type", "req_id", "locations"))
_REPLY_TIMEOUT = frozenset(("type", "req_id", "timeout"))
_REPLY_WAIT = frozenset(("type", "req_id", "ready", "locations"))


def _enc_reply(msg, env) -> bool:
    # Only the three get/wait reply shapes are typed; every other reply
    # carries arbitrary Python values and falls back to pickle.
    keys = frozenset(msg)
    m = env.locations_reply
    if keys == _REPLY_TIMEOUT and msg["timeout"] is True:
        m.req_id = msg["req_id"]
        m.timeout = True
        return True
    if keys == _REPLY_GET or keys == _REPLY_WAIT:
        locs = msg["locations"]
        if not all(isinstance(l, ObjectLocation) for l in locs.values()):
            return False  # a None slipped in: pickle preserves it exactly
        m.req_id = msg["req_id"]
        for oid, loc in locs.items():
            m.locations.append(pb.LocEntry(oid=oid, loc=_loc_to_pb(loc)))
        if keys == _REPLY_WAIT:
            m.is_wait = True
            m.ready.extend(msg["ready"])
        return True
    return False


_SIMPLE_TYPES = frozenset((
    "ping", "pong", "blocked", "unblocked", "exit", "register_client",
    "flush",
))

_ENCODERS = {
    "submit_batch": _enc_submit_batch,
    "execute": _enc_execute,
    "task_done": _enc_task_done,
    "seal": _enc_seal,
    "add_ref": _enc_add_ref,
    "remove_ref": _enc_remove_ref,
    "kv_put": _enc_kv_put,
    "kv_get": _enc_kv_get,
    "get_locations": _enc_get_locations,
    "wait": _enc_wait,
    "reply": _enc_reply,
}


def encode(msg: Dict[str, Any], packed: bool = True) -> bytes:
    if packed:
        # hot frames take the struct-packed codec; None means "not a
        # packed type / oversize / unexpected shape" and falls through to
        # the Envelope arm (whose own gates land on raw pickle)
        out = packed_wire.encode(msg)
        if out is not None:
            return out
    env = pb.Envelope(version=WIRE_VERSION)
    enc = _ENCODERS.get(msg.get("type"))
    done = False
    if enc is not None:
        try:
            done = enc(msg, env)
        except (KeyError, TypeError, ValueError):
            done = False  # unexpected shape: the pickle arm is always valid
    if not done:
        if msg.get("type") in _SIMPLE_TYPES and len(msg) == 1:
            env.simple.type = msg["type"]
        else:
            # Long-tail fallback: a RAW pickle frame, not pickle-inside-
            # Envelope.  decode() sniffs it by the 0x80 opcode, so this
            # costs nothing in interop and (a) skips a full extra copy of
            # the payload, (b) dodges protobuf's 2 GiB message cap — thin
            # client put_blob/get_blob legitimately ship multi-GiB frames
            # over this connection.
            return pickle.dumps(msg, _PICKLE_PROTO)
    try:
        out = env.SerializeToString()
    except (ValueError, _EncodeError):
        # A typed arm can build an Envelope that protobuf then refuses to
        # serialize — the C++ backend raises only at SerializeToString
        # time for a > 2 GiB message, never in the encoder itself.  The
        # raw pickle frame has no size cap and decode() sniffs it by
        # opcode, so falling back is always correct; leaking the raise
        # would poison every send() call site.
        return pickle.dumps(msg, _PICKLE_PROTO)
    if len(out) >= _PB_MAX_FRAME:
        # the upb backend SERIALIZES oversized messages happily, but no
        # receiving backend can PARSE a > 2 GiB frame (DecodeError at the
        # peer — a silent wire break).  Catches any typed arm that grew
        # past the cap (big inline task args, batched seals), not just
        # the kv_put arm gated above.
        return pickle.dumps(msg, _PICKLE_PROTO)
    return out


# ---------------------------------------------------------------------------
# per-type decoders: Envelope -> dict

def _dec_submit_batch(m) -> dict:
    return {"type": "submit_batch",
            "batch": [(s.kind, _spec_from_pb(s.spec)) for s in m.items]}


def _dec_execute(m) -> dict:
    out = {"type": "execute", "spec": _spec_from_pb(m.spec)}
    if m.dep_locs:
        out["dep_locs"] = {e.oid: _loc_from_pb(e.loc) for e in m.dep_locs}
    if m.gpu_ids:
        out["gpu_ids"] = list(m.gpu_ids)
    return out


def _dec_task_done(m) -> dict:
    out = {
        "type": "task_done",
        "seals": [(e.oid, _loc_from_pb(e.loc), list(e.contained))
                  for e in m.seals],
        "spec_ref": {
            "task_id": m.task_id,
            "return_ids": list(m.return_ids),
            "is_actor_creation": m.is_actor_creation or None,
            "actor_id": m.actor_id if m.HasField("actor_id") else None,
            "name": m.name if m.HasField("name") else None,
        },
        "failed": m.failed,
        "error_str": m.error_str if m.HasField("error_str") else None,
        "exec_start": m.exec_start,
        "exec_end": m.exec_end,
        "worker_pid": m.worker_pid,
    }
    if m.HasField("extra"):
        out.update(pickle.loads(m.extra))
    return out


def _dec_seal(m) -> dict:
    return {"type": "seal", "oid": m.oid, "loc": _loc_from_pb(m.loc),
            "contained": list(m.contained)}


def _dec_reply(m) -> dict:
    out: Dict[str, Any] = {"type": "reply", "req_id": m.req_id}
    if m.timeout:
        out["timeout"] = True
        return out
    out["locations"] = {e.oid: _loc_from_pb(e.loc) for e in m.locations}
    if m.is_wait:
        out["ready"] = list(m.ready)
    return out


_DECODERS = {
    "submit_batch": _dec_submit_batch,
    "execute": _dec_execute,
    "task_done": _dec_task_done,
    "seal": _dec_seal,
    # the Envelope RefUpdate arm only ever carries handle-reason updates
    # (non-handle reasons fall back to pickle — see _enc_add_ref);
    # materializing the default keeps decode(encode(x)) == x
    "add_ref": lambda m: {"type": "add_ref", "oids": list(m.oids),
                          "reason": "handle"},
    "remove_ref": lambda m: {"type": "remove_ref", "oids": list(m.oids),
                             "reason": "handle"},
    "kv_put": lambda m: {"type": "kv_put", "ns": m.ns, "key": m.key,
                         "value": m.value},
    "kv_get": lambda m: {"type": "kv_get", "ns": m.ns, "key": m.key,
                         "req_id": m.req_id},
    "get_locations": lambda m: {
        "type": "get_locations", "oids": list(m.oids),
        "timeout": m.timeout if m.HasField("timeout") else None,
        "req_id": m.req_id},
    "wait": lambda m: {
        "type": "wait", "oids": list(m.oids), "num_returns": m.num_returns,
        "timeout": m.timeout if m.HasField("timeout") else None,
        "req_id": m.req_id},
    "locations_reply": _dec_reply,
    "simple": lambda m: {"type": m.type},
}


def decode(data: bytes) -> Dict[str, Any]:
    head = data[:1]
    if head == b"\x80":
        # raw pickle frame — RAY_TPU_TORCH_WIRE=pickle senders and the untyped
        # long-tail of proto-mode senders.  This arm is load-bearing,
        # not legacy: removing it breaks every pickle-mode cluster.
        return pickle.loads(data)
    if head == packed_wire.MAGIC_BYTE:
        # packed hot frame (the proto-mode default for ~7 frame types)
        try:
            return packed_wire.decode(data)
        except Exception as e:
            raise WireDecodeError(f"bad packed frame: {e}") from e
    try:
        env = pb.Envelope.FromString(data)
    except Exception as e:
        raise WireDecodeError(f"bad wire frame: {e}") from e
    if env.version != WIRE_VERSION:
        raise WireDecodeError(
            f"wire version {env.version} != {WIRE_VERSION}")
    body = env.WhichOneof("body")
    if body == "pickled":
        return pickle.loads(env.pickled)
    dec = _DECODERS.get(body)
    if dec is None:
        raise WireDecodeError(f"unknown envelope body {body!r}")
    return dec(getattr(env, body))


# ---------------------------------------------------------------------------
# connection wrapper

class WireConnection:
    """Drop-in ``Connection`` facade.  The RECEIVE path always accepts
    every encoding (decode() sniffs the first byte — raw pickle, packed,
    and Envelope frames share the same length-prefixed transport
    framing); ``typed``/``packed`` gate only what THIS side emits."""

    __slots__ = ("_conn", "_typed", "_packed")

    def __init__(self, conn, typed: bool, packed: bool = True):
        self._conn = conn
        self._typed = typed
        self._packed = packed

    def send(self, msg: Dict[str, Any]) -> None:
        if self._typed:
            self._conn.send_bytes(encode(msg, packed=self._packed))
        else:
            self._conn.send_bytes(pickle.dumps(msg, _PICKLE_PROTO))

    def recv(self) -> Dict[str, Any]:
        return decode(self._conn.recv_bytes())

    def poll(self, timeout: float = 0.0) -> bool:
        return self._conn.poll(timeout)

    def fileno(self) -> int:
        return self._conn.fileno()

    def close(self) -> None:
        self._conn.close()

    @property
    def closed(self) -> bool:
        return self._conn.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wrap(conn):
    """Wrap a freshly connected/accepted control connection.  EVERY
    connection receives through the sniffing decoder, so any peer can
    speak any encoding at any time (mixed clusters and rolling flag
    changes just work); ``RAY_TPU_TORCH_WIRE=proto|envelope|pickle`` selects
    only what this process SENDS (see the module docstring).  The
    default is ``proto`` — the typed wire with the packed hot-frame
    codec.  Caveat: a peer from a release that predates the packed
    codec cannot sniff its 0xB1 magic — when rolling such a fleet, pin
    ``RAY_TPU_TORCH_WIRE=envelope`` (or ``pickle``) on upgraded processes
    until every node is current, then drop the pin."""
    mode = os.environ.get("RAY_TPU_TORCH_WIRE", "proto")
    return WireConnection(
        conn,
        typed=mode in ("proto", "envelope"),
        packed=mode == "proto")
