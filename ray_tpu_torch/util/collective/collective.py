"""Host-side collective communication between tasks/actors.

API surface of the reference's ``ray.util.collective``
(``python/ray/util/collective/collective.py:120-615`` —
``init_collective_group / allreduce / allgather / reducescatter /
broadcast / send / recv``) with two backends:

- ``backend="shm"`` (default, gloo's role): host arrays rendezvous
  through an **async coordinator actor** — every rank's single
  ``collect`` call parks on the actor's event loop until the round
  completes, so a round costs one actor round-trip per rank (no
  polling), with array payloads moving through the shared-memory object
  store.
- ``backend="torch"`` (nccl's role; the JAX package's ``"xla"`` group):
  ops are ``torch.distributed`` collectives over the gang's default
  process group (``TorchConfig(use_torch_distributed=True)`` or
  ``parallel.mesh.init_world`` makes it): NCCL on the card, gloo on the
  CPU, whichever backend the world was made with and never the other.
  Tensors move device to device, never through Python or the object
  store.  Code inside a model step should use
  :mod:`ray_tpu_torch.parallel.collective` directly.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch

# Process-global: a worker joins a group once and may drive it from any
# thread (train loops run on their own thread inside the hosting actor).
_GROUPS: Dict[str, object] = {}

_COLLECTIVE_HIST = None


def _record_collective(group: str, op: str, rank: int, round_id: int,
                       dur_s: float) -> None:
    """Flight-recorder span + latency histogram for one collective round
    (the timeline merges these next to task slices)."""
    from ray_tpu_torch._private import events as _events

    if not _events.ENABLED:
        return
    global _COLLECTIVE_HIST
    if _COLLECTIVE_HIST is None:
        from ray_tpu_torch.util.metrics import Histogram

        _COLLECTIVE_HIST = Histogram(
            "ray_tpu_collective_latency_s",
            "host-collective round latency (s)",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30],
            tag_keys=("op",))
    _COLLECTIVE_HIST.observe(dur_s, tags={"op": op})
    _events.emit("collective", f"{op} ({group})", severity="DEBUG",
                 entity_id=f"rank-{rank}", span_dur=dur_s, round=round_id)


def _groups() -> Dict[str, object]:
    return _GROUPS


class _Coordinator:
    """Async rendezvous actor: one ``collect`` per rank per round.

    Analog of the NCCL communicator bootstrap store
    (``nccl_collective_group.py:127``), but it also executes the
    host-side reduction.  Async methods multiplex on the actor's event
    loop, so all ranks of a round park here concurrently and return the
    moment the last one arrives — no poll loops, no separate fetch."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: Dict[int, dict] = {}
        # (src, dst) -> fifo of in-flight point-to-point tensors
        self.mailbox: Dict[tuple, list] = {}
        self.mailbox_events: Dict[tuple, object] = {}

    async def collect(self, round_id: int, rank: int, value, op: str):
        import asyncio

        r = self.rounds.setdefault(
            round_id,
            {"parts": {}, "op": op, "result": None,
             "event": asyncio.Event(), "fetched": set()},
        )
        r["parts"][rank] = value
        if len(r["parts"]) == self.world_size:
            r["result"] = self._finish(r)
            r["event"].set()
        else:
            await r["event"].wait()
        out = r["result"]
        r["fetched"].add(rank)
        if len(r["fetched"]) == self.world_size:
            self.rounds.pop(round_id, None)
        if isinstance(out, dict):  # per-rank outputs (reducescatter)
            return out[rank]
        return out

    async def p2p_put(self, src: int, dst: int, value) -> None:
        import asyncio

        key = (src, dst)
        self.mailbox.setdefault(key, []).append(value)
        ev = self.mailbox_events.setdefault(key, asyncio.Event())
        ev.set()

    async def p2p_take(self, src: int, dst: int, timeout: float = 60.0):
        """Returns (ok, value).  The deadline lives SERVER-side so a
        timed-out receive leaves no orphaned waiter that would steal the
        next message for this (src, dst) pair."""
        import asyncio

        key = (src, dst)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            q = self.mailbox.get(key)
            if q:
                return True, q.pop(0)
            remaining = deadline - loop.time()
            if remaining <= 0:
                return False, None
            ev = self.mailbox_events.setdefault(key, asyncio.Event())
            ev.clear()
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                return False, None

    def _finish(self, r: dict):
        op = r["op"]
        parts = [r["parts"][i] for i in sorted(r["parts"])]
        if op == "barrier":
            return True
        if op in ("sum", "mean", "max", "min", "product"):
            acc = np.stack([np.asarray(p) for p in parts])
            fn = {"sum": np.sum, "mean": np.mean, "max": np.max,
                  "min": np.min, "product": np.prod}[op]
            return fn(acc, axis=0)
        if op == "allgather":
            return [np.asarray(p) for p in parts]
        if op == "broadcast":
            root, vals = parts[0][0], {i: v for i, (_, v) in enumerate(parts)}
            return vals[root]
        if op == "reducescatter":
            acc = np.sum(np.stack([np.asarray(p) for p in parts]), axis=0)
            chunks = np.array_split(acc, self.world_size, axis=0)
            return {i: chunks[i] for i in range(self.world_size)}
        raise ValueError(f"unknown op {op}")


class _GroupHandle:
    backend = "shm"

    def __init__(self, name: str, world_size: int, rank: int, coordinator):
        import threading

        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self.round_id = 0
        self._round_lock = threading.Lock()

    def _run(self, value, op: str, timeout: float = 120.0):
        if op == "broadcast":
            value = (value[0], np.asarray(value[1]))
        elif value is not None:
            value = np.asarray(value)
        with self._round_lock:
            rid = self.round_id
            self.round_id += 1
        t0 = time.perf_counter()
        out = ray_tpu_torch.get(
            self.coordinator.collect.remote(rid, self.rank, value, op),
            timeout=timeout,
        )
        _record_collective(self.name, op, self.rank, rid,
                           time.perf_counter() - t0)
        return out

    def send(self, tensor, dst_rank: int) -> None:
        ray_tpu_torch.get(self.coordinator.p2p_put.remote(
            self.rank, dst_rank, np.asarray(tensor)))

    def recv(self, shape, dtype, src_rank: int, timeout: float = 120.0):
        ok, val = ray_tpu_torch.get(
            self.coordinator.p2p_take.remote(src_rank, self.rank, timeout),
            timeout=timeout + 30,  # server-side deadline fires first
        )
        if not ok:
            raise TimeoutError(
                f"recv from rank {src_rank} timed out after {timeout}s"
            )
        return np.asarray(val, dtype=dtype).reshape(shape)


class _TorchGroup:
    """Collectives over the gang's ``torch.distributed`` world (the "nccl"
    slot; the JAX package's ``_XlaGroup``).

    Every rank must already be a member of one initialised default process
    group whose size and rank match the group's.  The group's device
    follows the world's backend: the current CUDA device under NCCL, the
    CPU under gloo.  A tensor already on that device and contiguous is
    reduced in place and returned, as ``torch.distributed`` does; other
    inputs (numpy arrays, tensors elsewhere) are copied there first."""

    backend = "torch"

    def __init__(self, name: str, world_size: int, rank: int):
        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "a torch collective group needs the gang's process group: "
                "TorchConfig(use_torch_distributed=True) or "
                "parallel.mesh.init_world makes it")
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise ValueError(
                f"torch groups span the default process group: (world_size, "
                f"rank)=({world_size}, {rank}) != ({dist.get_world_size()}, "
                f"{dist.get_rank()})")
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl" else torch.device("cpu"))

    def _tensor(self, value):
        import torch

        if not isinstance(value, torch.Tensor):
            return torch.tensor(np.asarray(value), device=self.device)  # a copy
        return value.to(self.device).contiguous()

    def _run(self, value, op: str, timeout: float = 120.0):
        t0 = time.perf_counter()
        try:
            return self._run_inner(value, op)
        finally:
            _record_collective(self.name, op, self.rank, -1,
                               time.perf_counter() - t0)

    def _run_inner(self, value, op: str):
        import torch
        import torch.distributed as dist

        if op == "barrier":
            dist.barrier()
            return True
        if op == "broadcast":
            root, tensor = value
            out = self._tensor(tensor)
            dist.broadcast(out, src=root)
            return out
        t = self._tensor(value)
        if op in ("sum", "mean", "max", "min", "product"):
            red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
                   "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                   "product": dist.ReduceOp.PRODUCT}[op]
            dist.all_reduce(t, op=red)
            if op == "mean":
                t.div_(self.world_size)
            return t
        if op == "allgather":
            out = [torch.empty_like(t) for _ in range(self.world_size)]
            dist.all_gather(out, t)
            return out
        if op == "reducescatter":
            # gloo has no reduce_scatter, and the shm group splits unequal
            # rows as np.array_split does: a sum, then this rank's rows
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            return torch.tensor_split(t, self.world_size, dim=0)[self.rank].clone()
        raise ValueError(f"unknown op {op}")

    def send(self, tensor, dst_rank: int) -> None:
        import torch.distributed as dist

        dist.send(self._tensor(tensor), dst=dst_rank)

    def recv(self, shape, dtype, src_rank: int, timeout: float = 120.0):
        import torch
        import torch.distributed as dist

        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        dist.recv(out, src=src_rank)
        return out


def init_collective_group(
    world_size: int, rank: int, backend: str = "shm", group_name: str = "default"
) -> None:
    """Join a collective group from inside a task/actor (collective.py:120).

    shm backend: rank 0 creates the coordinator; other ranks poll for it —
    a deterministic rendezvous with no named-actor creation race.
    torch backend: the gang's process group is the rendezvous."""
    if backend == "torch":
        _groups()[group_name] = _TorchGroup(group_name, world_size, rank)
        return
    if backend != "shm":
        raise ValueError(f"unknown collective backend {backend!r} (shm or torch)")
    if rank == 0:
        coord = _get_or_create_coordinator(group_name, world_size)
    else:
        import time

        deadline = time.monotonic() + 30.0
        while True:
            try:
                coord = ray_tpu_torch.get_actor(f"__collective_{group_name}")
                break
            except ValueError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {rank} timed out waiting for collective group "
                        f"{group_name!r} to be created by rank 0"
                    )
                time.sleep(0.01)
    _groups()[group_name] = _GroupHandle(group_name, world_size, rank, coord)


def create_collective_group(
    actors: List, world_size: int, ranks: List[int],
    backend: str = "shm", group_name: str = "default",
) -> None:
    """Driver-side declarative setup (collective.py:151): tells each actor
    to join the group with its rank.  The actor class must expose a
    ``join_collective_group(world_size, rank, group_name)`` method that
    calls :func:`init_collective_group`."""
    _get_or_create_coordinator(group_name, world_size)
    ray_tpu_torch.get([
        a.join_collective_group.remote(world_size, rank, group_name)
        for a, rank in zip(actors, ranks)
    ])


def destroy_collective_group(group_name: str = "default") -> None:
    _groups().pop(group_name, None)


def get_rank(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return g.rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return g.world_size if g else -1


def get_group_backend(group_name: str = "default") -> str:
    """``"shm"`` or ``"torch"``: what the group's ops take and return
    (numpy arrays, or tensors on the group's device)."""
    return _group(group_name).backend


def _group(group_name: str):
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this worker; "
            "call init_collective_group() first"
        )
    return g


def _get_or_create_coordinator(group_name: str, world_size: int):
    name = f"__collective_{group_name}"
    try:
        return ray_tpu_torch.get_actor(name)
    except ValueError:
        pass
    Coord = ray_tpu_torch.remote(num_cpus=0)(_Coordinator)
    try:
        return Coord.options(name=name).remote(world_size)
    except Exception:
        return ray_tpu_torch.get_actor(name)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """Reduce ``tensor`` over the group (sum, mean, max, min, product).
    The shm group returns a numpy array, the torch group a tensor on its
    device."""
    return _group(group_name)._run(tensor, op)


def allgather(tensor, group_name: str = "default") -> List:
    return _group(group_name)._run(tensor, "allgather")


def reducescatter(tensor, group_name: str = "default"):
    """The sum over the group, split along axis 0 as ``np.array_split``
    does; each rank gets its own part."""
    return _group(group_name)._run(tensor, "reducescatter")


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name)._run((src_rank, tensor), "broadcast")


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send — NOT a group round, so only the (src, dst)
    pair participates (collective.py:531)."""
    _group(group_name).send(tensor, dst_rank)


def recv(shape, dtype, src_rank: int, group_name: str = "default",
         timeout: float = 120.0):
    """Blocking point-to-point receive from ``src_rank`` (collective.py:594)."""
    return _group(group_name).recv(shape, dtype, src_rank, timeout)


def barrier(group_name: str = "default") -> None:
    _group(group_name)._run(None, "barrier")
