"""Run a function on every rank of a fresh process group.

The port's stand-in for the JAX package's virtual devices: where its
tests and its multi-chip dry run put ``n`` CPU devices in one process, the
port starts ``n`` processes (``torch.multiprocessing``'s spawn), joins
them into a world by a ``file://`` rendezvous in a temporary directory,
and runs ``fn(*args)`` on each.  Every rank uses one thread, the process
group times out after 60 seconds, and the parent gives the world
``deadline`` seconds in all: a rank that fails, dies or hangs fails the
call, and the other ranks are killed rather than left waiting.
"""

from __future__ import annotations

import logging
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.mesh import init_world


# A collective that one rank never reaches fails the world after this long.
_PG_TIMEOUT = timedelta(seconds=60)


def _rank_main(fn, rank, world_size, init_method, device, args, results):
    try:
        torch.set_num_threads(1)
        # DTensor logs a warning for every multi-step redistribution
        logging.getLogger("torch.distributed").setLevel(logging.ERROR)
        init_world(None, rank, world_size, init_method, _PG_TIMEOUT, device=device)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
              device: DeviceLike = None, deadline: float = 300.0) -> List[Any]:
    """``fn(*args)`` on ranks ``0 .. world_size - 1`` of a new world (NCCL
    on the cards when ``device`` is None, gloo with ``device="cpu"``);
    returns each rank's result, in rank order.  ``fn`` must be importable
    by name (a module-level function) and its result picklable.  Raises
    ``RuntimeError`` with the rank's traceback when a rank fails, and when
    the world outlives ``deadline``."""
    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, dev.type,
                                   tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, end = {}, time.monotonic() + deadline
        try:
            while len(out) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}")
                    if time.monotonic() > end:
                        raise RuntimeError(f"the world of {world_size} ranks did not "
                                           f"finish within {deadline} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
