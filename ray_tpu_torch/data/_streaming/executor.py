"""StreamingExecutor: pump a plan's operator pipeline under a block budget.

The executor owns a background pump thread that walks the input source,
submits the fused map task for each block (with a locality hint toward the
split that will consume it), and routes output refs into per-split
queues.  Backpressure is the core contract: per split, at most
``max_in_flight_blocks`` blocks may be submitted-but-unconsumed at any
moment — a slow consumer stalls its own submissions (and only its own; a
multi-split pump skips stalled splits) instead of flooding the cluster
with materialized blocks, the bounded-resource loop of the reference's
``streaming_executor.py``.

Consumption can begin as soon as the FIRST task is submitted — the
consumer's ``get`` blocks on the seal, so transform execution overlaps
batch consumption end to end.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Iterator, List, Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.data._streaming.operators import (
    build_streaming_topology,
    pick_split,
)

# Lazy streaming metric singletons (Counter tags: op).
_STREAM_METRICS = None
# flight-recorder stall events are throttled to one per this window per
# executor — the stall-time counter carries the exact accounting
_STALL_EVENT_MIN_INTERVAL_S = 1.0


def _stream_metrics():
    global _STREAM_METRICS
    if _STREAM_METRICS is None:
        from ray_tpu_torch.util.metrics import Counter

        _STREAM_METRICS = {
            "blocks": Counter("ray_tpu_torch_streaming_blocks_total",
                              "blocks submitted per operator",
                              tag_keys=("op",)),
            "stall": Counter("ray_tpu_torch_streaming_stall_s_total",
                             "pump seconds stalled on backpressure",
                             tag_keys=("op",)),
            "starved": Counter("ray_tpu_torch_streaming_consumer_wait_s_total",
                               "consumer seconds blocked on an empty split",
                               tag_keys=("op",)),
        }
    return _STREAM_METRICS

# Per-split in-flight block budget.  8 blocks of a typical 32 MB block is
# a 256 MB window per consumer: deep enough to hide task latency, bounded
# enough that a stalled trainer pins O(window), not O(dataset).
DEFAULT_BLOCK_BUDGET = 8

_EOF = object()


class StreamingExecutor:
    """Run one plan as a streaming pipeline feeding ``num_splits`` consumers."""

    def __init__(
        self,
        plan,
        *,
        num_splits: int = 1,
        locality_hints: Optional[List[Optional[str]]] = None,
        max_in_flight_blocks: Optional[int] = None,
        preassign: bool = True,
    ):
        self._plan = plan
        self._n = max(1, num_splits)
        # equal-mode splits pre-assign blocks up front (deterministic,
        # consumption-speed-independent); preassign=False (equal=False)
        # keeps drain-rate assignment to whichever split has room
        self._preassign = preassign
        self._hints = list(locality_hints or [])
        if self._hints and len(self._hints) != self._n:
            raise ValueError(
                f"locality_hints has {len(self._hints)} entries for "
                f"{self._n} splits")
        self._budget = max_in_flight_blocks or DEFAULT_BLOCK_BUDGET
        # topology (incl. any barrier-prefix execution) is built LAZILY on
        # the pump thread: constructing an executor — e.g. calling
        # iter_batches() on a shuffled dataset — must not run the shuffle;
        # that happens on first consumption, and build errors surface on
        # the consumer like any stream error
        self._source: Any = None
        self._counts: Optional[List[int]] = None
        self._map_op = None
        self._queues = [queue_mod.Queue() for _ in range(self._n)]
        self._in_flight = [0] * self._n
        self._assigned_rows = [0] * self._n
        self._assigned_blocks = [0] * self._n
        self._out_refs: List[List[Any]] = [[] for _ in range(self._n)]
        self._delivered = [0] * self._n
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._started = False
        self._t0 = 0.0
        # set ONLY when the full source was produced, strictly BEFORE the
        # final _EOF is queued: _maybe_finalize keys off it, so a partial
        # (abandoned) run can never cache itself as the plan's result
        self._produced_all = threading.Event()
        self._finalized = False
        # observability: the largest in-flight total ever observed, so the
        # backpressure contract is assertable from the outside
        self.max_in_flight_observed = 0
        # flight recorder: per-ref submit times (operator span = submit ->
        # consumer delivery), bounded by the in-flight budget; plus stall
        # accounting and event throttling
        self._span_t0: dict = {}
        self._stall_s = 0.0
        self._last_stall_event = 0.0
        # a consumer inside a trace() block: the pump thread adopts the
        # context (map-task submissions chain under it) and operator/stall
        # spans carry the trace lineage
        self._trace_ctx = None
        if _events.ENABLED:
            from ray_tpu_torch.util import tracing

            self._trace_ctx = tracing.current_context()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "StreamingExecutor":
        with self._cond:
            # check-and-set under the lock: the coordinator actor's first
            # get_next can arrive on N threads at once, and two pumps
            # would race each other over the one source iterator
            if self._started:
                return self
            self._started = True
            self._t0 = time.perf_counter()
        threading.Thread(target=self._pump, daemon=True,
                         name="streaming-executor-pump").start()
        return self

    def shutdown(self) -> None:
        """Stop the pump (consumer abandoned the stream).  Idempotent;
        also wakes any consumer blocked in ``get_next`` (it sees end of
        stream) so abandonment never strands a blocked thread."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for q in self._queues:
            q.put(_EOF)

    # -- consumer side -------------------------------------------------
    def _op_name(self) -> str:
        return self._map_op.name if self._map_op is not None else "source"

    def get_next(self, split: int = 0, timeout: Optional[float] = None):
        """Next output ref for ``split``; ``None`` at end of stream."""
        self.start()
        # captured ONCE: ENABLED is mutable module state (the overhead
        # bench flips it at runtime) and an off->on flip mid-get must not
        # turn t0==0.0 into hours of bogus recorded wait
        enabled = _events.ENABLED
        t0 = time.perf_counter() if enabled else 0.0
        item = self._queues[split].get(timeout=timeout)
        if enabled:
            waited = time.perf_counter() - t0
            if waited > 0.05:
                # split starvation: the consumer outran the pipeline
                _stream_metrics()["starved"].inc(
                    waited, tags={"op": self._op_name()})
                _events.emit("streaming", "split starved",
                             severity="DEBUG", entity_id=str(split),
                             wait_s=round(waited, 4), op=self._op_name())
        if item is _EOF:
            self._queues[split].put(_EOF)  # repeated polls stay terminal
            self._maybe_finalize()
            return None
        if isinstance(item, BaseException):
            self._queues[split].put(item)  # stays terminal, like _EOF
            raise item
        with self._cond:
            self._in_flight[split] -= 1
            self._delivered[split] += 1
            self._cond.notify_all()
        if enabled:
            sub_t = self._span_t0.pop(id(item), None)
            if sub_t is not None:
                # operator span: submit -> delivery, a timeline slice
                # (trace-tagged when the consumer runs inside a trace)
                _events.emit("streaming", self._op_name(), severity="DEBUG",
                             entity_id=str(split),
                             span_dur=time.perf_counter() - sub_t,
                             **self._trace_fields("operator"))
        return item

    def _trace_fields(self, phase: str) -> dict:
        """Span-lineage kwargs for an emit when a trace context was
        captured (else empty — untraced emits stay byte-identical)."""
        from ray_tpu_torch.util.tracing import span_fields

        return span_fields(self._trace_ctx, phase)

    def iter_refs(self, split: int = 0) -> Iterator[Any]:
        """Blocking iterator over one split's output refs."""
        self.start()
        try:
            while True:
                ref = self.get_next(split)
                if ref is None:
                    return
                yield ref
        finally:
            self.shutdown()

    # -- pump ----------------------------------------------------------
    def _acquire_split(self, block_rows: Optional[int]) -> Optional[int]:
        """Block until some split has budget room; returns it (or None on
        stop).  A stalled split never blocks the others."""
        t0 = time.perf_counter()
        with self._cond:
            while not self._stop.is_set():
                room = [i for i in range(self._n)
                        if self._in_flight[i] < self._budget]
                if room:
                    split = pick_split(self._assigned_rows,
                                       self._assigned_blocks, room,
                                       block_rows)
                    self._in_flight[split] += 1
                    self._assigned_blocks[split] += 1
                    if block_rows is not None:
                        self._assigned_rows[split] += block_rows
                    total = sum(self._in_flight)
                    if total > self.max_in_flight_observed:
                        self.max_in_flight_observed = total
                    if _events.ENABLED:
                        waited = time.perf_counter() - t0
                        if waited > 0.001:
                            self._record_stall(waited)
                    return split
                self._cond.wait(timeout=0.2)
        return None

    def _record_stall(self, waited: float) -> None:
        """Backpressure accounting: the pump sat blocked on every split's
        budget for ``waited`` seconds (cond lock held)."""
        self._stall_s += waited
        _stream_metrics()["stall"].inc(waited, tags={"op": self._op_name()})
        now = time.perf_counter()
        if now - self._last_stall_event >= _STALL_EVENT_MIN_INTERVAL_S:
            self._last_stall_event = now
            _events.emit(
                "streaming", "backpressure stall", severity="DEBUG",
                op=self._op_name(), stalled_s=round(waited, 4),
                total_stalled_s=round(self._stall_s, 3),
                in_flight=list(self._in_flight), budget=self._budget,
                **self._trace_fields("backpressure"))

    def _pump(self) -> None:
        try:
            if self._trace_ctx is not None:
                # the pump thread submits the map tasks: adopting the
                # consumer's context makes their specs (and so the task
                # table) part of the trace
                from ray_tpu_torch.util import tracing

                tracing.adopt(self._trace_ctx)
            self._source, self._counts, self._map_op = \
                build_streaming_topology(self._plan)
            # preassignment needs a static source; a generator source
            # (unknown length) falls back to dynamic assignment
            if self._n > 1 and self._preassign \
                    and isinstance(self._source, list):
                self._pump_preassigned()
            else:
                if not self._pump_dynamic():
                    return  # abandoned
        except BaseException as e:  # surfaced on every consumer
            for q in self._queues:
                q.put(e)

    def _submit(self, split: int, ref) -> None:
        hint = self._hints[split] if self._hints else None
        out = (self._map_op.submit(ref, hint)
               if self._map_op is not None else ref)
        if _events.ENABLED:
            _stream_metrics()["blocks"].inc(tags={"op": self._op_name()})
            self._span_t0[id(out)] = time.perf_counter()
        self._out_refs[split].append(out)
        self._queues[split].put(out)

    def _pump_dynamic(self) -> bool:
        """Arrival-order assignment to whichever split has budget room —
        the single-split and unknown-row-count (generator / ``equal=False``)
        path.  Returns False if the stream was abandoned mid-pump."""
        for idx, ref in enumerate(self._source):
            rows = None
            if self._counts is not None and idx < len(self._counts):
                rows = self._counts[idx]
            split = self._acquire_split(rows)
            if split is None:
                return False  # abandoned
            self._submit(split, ref)
        self._produced_all.set()
        for q in self._queues:
            q.put(_EOF)
        return True

    def _pump_preassigned(self) -> None:
        """Deterministic row-balanced assignment, decided UP FRONT over all
        splits — never by which consumer drains fastest.  Equal-mode gangs
        run a collective per batch: if a rank that stalls at its budget
        (checkpointing, say) lost its blocks to faster ranks, the ranks
        would finish the epoch with different batch counts and deadlock.
        Each split's submissions still stall independently on its own
        budget, so a slow split never blocks a fast one."""
        from collections import deque

        refs = list(self._source)
        counts = self._counts or []
        pending = [deque() for _ in range(self._n)]
        rows = [0] * self._n
        blocks = [0] * self._n
        for idx, ref in enumerate(refs):
            r = counts[idx] if idx < len(counts) else 0
            s = min(range(self._n), key=lambda i: (rows[i], blocks[i], i))
            pending[s].append(ref)
            rows[s] += r
            blocks[s] += 1
        with self._cond:
            self._assigned_rows[:] = rows
            self._assigned_blocks[:] = blocks
        if not any(pending):  # empty source
            self._produced_all.set()
        for i in range(self._n):
            if not pending[i]:
                self._queues[i].put(_EOF)  # more splits than blocks
        while True:
            with self._cond:
                while True:
                    if self._stop.is_set():
                        return  # abandoned
                    ready = [i for i in range(self._n)
                             if pending[i]
                             and self._in_flight[i] < self._budget]
                    if ready or not any(pending):
                        break
                    self._cond.wait(timeout=0.2)
                if not ready:
                    return  # fully drained; per-split _EOFs already sent
                picks = [(i, pending[i].popleft()) for i in ready]
                for i, _ in picks:
                    self._in_flight[i] += 1
                total = sum(self._in_flight)
                if total > self.max_in_flight_observed:
                    self.max_in_flight_observed = total
            for i, ref in picks:
                self._submit(i, ref)
                if not pending[i]:
                    if not any(pending):  # that was the final block
                        self._produced_all.set()
                    self._queues[i].put(_EOF)

    # -- completion bookkeeping ----------------------------------------
    def _maybe_finalize(self) -> None:
        """After a FULL single-split drain, cache the result on the plan
        (re-iteration / count() reuse these refs instead of re-running)
        and record the streamed stage's stats."""
        if not self._produced_all.is_set():
            return
        with self._cond:
            # check-and-set under the lock: multiple splits' consumers can
            # hit their _EOF simultaneously on separate actor threads
            if self._finalized:
                return
            self._finalized = True
        produced = sum(len(r) for r in self._out_refs)
        name = self._map_op.name if self._map_op is not None else None
        if self._n == 1:
            if sum(self._delivered) == produced and name is not None \
                    and self._plan._out is None:
                self._plan._out = (self._out_refs[0], None)
        if name is not None:
            suffix = ("streamed" if self._n == 1
                      else f"streaming_split={self._n}")
            self._plan._stats.append({
                "stage": f"{name} ({suffix})",
                "wall_s": round(time.perf_counter() - self._t0, 4),
                "blocks": produced,
            })

    def stats(self) -> dict:
        return {
            "num_splits": self._n,
            "budget_per_split": self._budget,
            "max_in_flight_observed": self.max_in_flight_observed,
            "produced_blocks": sum(len(r) for r in self._out_refs),
            "delivered_blocks": sum(self._delivered),
            "stalled_s": round(self._stall_s, 4),
        }
