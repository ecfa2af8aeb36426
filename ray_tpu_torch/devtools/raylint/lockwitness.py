"""The dynamic half of raylint: a lock acquisition-order witness.

Static rules can't prove lock ORDER.  With ``RAY_TPU_TORCH_LOCKWITNESS=1``
the named locks in ``_private/node.py``, ``object_store.py``,
``util/metrics.py``, ``util/tsdb.py`` and ``dag/compiled.py`` are
wrapped (via :func:`ray_tpu_torch._private.locks.make_lock`) so every acquire
records, per thread, the set of witness locks already held and adds
``held -> acquired`` edges to a global order graph.  A cycle in that
graph is a potential deadlock that needs only the right interleaving —
the witness reports it with BOTH closing stacks even when the run never
actually deadlocks (the lockdep/TSan idea; the reference gets this from
clang thread-safety annotations + TSan, SURVEY §7).

Reports go to stderr and — when ``RAY_TPU_TORCH_LOCKWITNESS_DIR`` is set — to
``lockwitness-<pid>-<n>.json`` in that directory, so a multi-process
cluster test can assert the whole run stayed cycle-free by globbing one
directory.  Same-name edges are skipped: instances sharing a name (e.g.
per-connection locks) have no defined order between themselves.

Overhead is irrelevant by design: nothing here imports or runs unless
the env flag is set.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

_STACK_DEPTH = 14


class _Witness:
    """Global order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        # a -> {b}: lock a was held while b was acquired
        self._edges: Dict[str, Set[str]] = {}
        # (a, b) -> stack captured when the edge was first observed
        self._edge_stacks: Dict[Tuple[str, str], str] = {}
        self._cycles: List[dict] = []
        self._n_reports = 0

    # -- per-thread held stack --------------------------------------------
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- events ------------------------------------------------------------
    def acquired(self, name: str) -> None:
        held = self._held()
        if name in held:
            # re-entrant RLock acquire: it can never block (the thread
            # already owns the lock), so it must create NO order edges —
            # `with A: with B: with A:` would otherwise record a bogus
            # B->A edge and report a false A->B->A cycle
            held.append(name)
            return
        if held:
            with self._mu:
                fresh = [h for h in held
                         if h != name and name not in self._edges.get(h, ())]
                if fresh:
                    # capture the stack only for a first-seen edge: the
                    # steady state (same nesting, thousands of times in a
                    # live-cluster run) pays a set lookup, not a
                    # 14-frame format_stack
                    stack = "".join(
                        traceback.format_stack(limit=_STACK_DEPTH)[:-2])
                    for h in fresh:
                        self._add_edge(h, name, stack)
        held.append(name)

    def released(self, name: str) -> None:
        held = self._held()
        # release order need not be LIFO; drop the most recent occurrence
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # -- graph (callers hold self._mu) -------------------------------------
    def _add_edge(self, a: str, b: str, stack: str) -> None:
        if b in self._edges.get(a, ()):
            return
        self._edges.setdefault(a, set()).add(b)
        self._edge_stacks[(a, b)] = stack
        path = self._find_path(b, a)
        if path is not None:
            cycle = {
                "locks": path + [b],
                "closing_edge": [a, b],
                "closing_stack": stack,
                "edges": {
                    f"{x}->{y}": self._edge_stacks.get((x, y), "")
                    for x, y in zip(path, path[1:] + [b])
                },
                "pid": os.getpid(),
                "thread": threading.current_thread().name,
            }
            self._cycles.append(cycle)
            self._report(cycle)

    def _find_path(self, start: str, goal: str) -> Optional[List[str]]:
        """DFS path start -> goal over the edge graph (None if absent)."""
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _report(self, cycle: dict) -> None:
        import sys

        msg = (f"raylint lockwitness: POTENTIAL DEADLOCK — lock order "
               f"cycle {' -> '.join(cycle['locks'])} (pid {cycle['pid']}, "
               f"thread {cycle['thread']})")
        print(msg, file=sys.stderr)
        out_dir = os.environ.get("RAY_TPU_TORCH_LOCKWITNESS_DIR")
        if out_dir:
            try:
                os.makedirs(out_dir, exist_ok=True)
                self._n_reports += 1
                path = os.path.join(
                    out_dir,
                    f"lockwitness-{os.getpid()}-{self._n_reports}.json")
                with open(path, "w") as f:
                    json.dump(cycle, f, indent=1)
            except OSError:
                pass  # the stderr line already carries the verdict

    # -- inspection ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            return {
                "edges": sorted(f"{a}->{b}"
                                for a, bs in self._edges.items()
                                for b in bs),
                "cycles": list(self._cycles),
            }

    def assert_cycle_free(self) -> None:
        with self._mu:
            if self._cycles:
                locks = [" -> ".join(c["locks"]) for c in self._cycles]
                raise AssertionError(
                    f"lock-order cycles observed: {locks}")

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._edge_stacks.clear()
            self._cycles.clear()


WITNESS = _Witness()


class WitnessLock:
    """Transparent Lock/RLock proxy that reports to :data:`WITNESS`.

    Implements the private Condition protocol (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so ``threading.Condition``
    built over a wrapped lock keeps working — and keeps the held-set
    accurate across ``cond.wait()``'s release/reacquire."""

    def __init__(self, name: str, lock) -> None:
        self._name = name
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            WITNESS.acquired(self._name)
        return got

    def release(self) -> None:
        self._lock.release()
        WITNESS.released(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    # Condition protocol ----------------------------------------------------
    def _release_save(self):
        state = self._lock._release_save() if hasattr(
            self._lock, "_release_save") else self._lock.release()
        WITNESS.released(self._name)
        return state

    def _acquire_restore(self, state) -> None:
        if hasattr(self._lock, "_acquire_restore"):
            self._lock._acquire_restore(state)
        else:
            self._lock.acquire()
        WITNESS.acquired(self._name)

    def _is_owned(self) -> bool:
        if hasattr(self._lock, "_is_owned"):
            return self._lock._is_owned()
        # plain Lock heuristic (what threading.Condition itself does)
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<WitnessLock {self._name} {self._lock!r}>"


def wrap_lock(name: str, lock) -> WitnessLock:
    return WitnessLock(name, lock)
