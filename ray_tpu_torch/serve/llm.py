"""LLM serving: iteration-level continuous batching over the KV-cache
decode functions.

Counterpart of ``GenerationEngine`` in ``ray_tpu/serve/llm.py``, with the
same design:

- a fixed set of cache slots plus one scratch slot (index ``n_slots``);
  queued prompts are prefilled into all free slots by one call padded to
  the fixed admission width ``n_slots``, padding rows parked on the
  scratch slot;
- prompts are padded to a bucket length, so prefill runs at a few fixed
  shapes;
- one ``decode_chunk`` of ``decode_chunk_steps`` steps advances every
  active slot per iteration; a slot whose request will reach its token
  cap within the chunk is freed when the chunk is dispatched, so the next
  admission reuses it at once;
- software pipelining: chunk N is dispatched before chunk N-1 is drained.
  Its tokens travel to pinned host memory by a ``non_blocking`` copy with
  a recorded CUDA event, and the drain waits on that event, so the host
  bookkeeping of N-1 overlaps the device work of N.

The JAX engine's exports to the runtime's metrics, events and tracing are
not carried over: the engine keeps its own counters (``stats()``,
``perf_stats()``: TTFT and inter-token latency reservoirs and the
prefill-interference tick meter).  The Serve deployment and the
disaggregated prefill/decode graph need the runtime and are not ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import generate as gen


class _TickMeter:
    """Prefill-interference meter: classifies every engine iteration as
    ``decode_only`` / ``interleaved`` (a prefill admitted while other
    slots were mid-decode) / ``prefill_only``, keeps an EMA of the
    decode-only tick wall as the no-interference baseline, and bills each
    interleaved tick's admission span plus its excess over that baseline
    to prefill interference.  Owned by the engine thread."""

    EMA_ALPHA = 0.1

    def __init__(self):
        self.ticks = {"decode_only": 0, "interleaved": 0, "prefill_only": 0}
        self.tick_s = {"decode_only": 0.0, "interleaved": 0.0, "prefill_only": 0.0}
        self.ema_decode_s: Optional[float] = None
        self.interference_s = 0.0
        self.excess_s = 0.0  # total tick wall above the decode baseline

    def record(self, wall: float, admit_s: float, n_admitted: int, n_rows: int) -> None:
        if n_rows == 0 and n_admitted == 0:
            return  # drain-only or idle iteration: nothing to attribute
        if n_admitted and n_rows > n_admitted:
            mode = "interleaved"
        elif n_admitted:
            mode = "prefill_only"
        else:
            mode = "decode_only"
        self.ticks[mode] += 1
        self.tick_s[mode] += wall
        if mode == "decode_only":
            if self.ema_decode_s is None:
                self.ema_decode_s = wall
            else:
                if self.ema_decode_s > 0:
                    self.excess_s += max(0.0, wall - self.ema_decode_s)
                self.ema_decode_s += self.EMA_ALPHA * (wall - self.ema_decode_s)
        elif mode == "interleaved":
            # with no decode-only baseline yet only the admission span is
            # billed, so the billed share cannot read 100% by construction
            interference = admit_s
            if self.ema_decode_s is not None:
                interference += max(0.0, wall - admit_s - self.ema_decode_s)
                self.excess_s += max(0.0, wall - self.ema_decode_s)
            self.interference_s += interference

    def snapshot(self) -> Dict[str, Any]:
        decode_wall = self.tick_s["decode_only"] + self.tick_s["interleaved"]
        return {
            "ticks": dict(self.ticks),
            "tick_s": dict(self.tick_s),
            "decode_tick_baseline_s": self.ema_decode_s,
            "interference_s": self.interference_s,
            "interference_frac":
                self.interference_s / decode_wall if decode_wall > 0 else 0.0,
            "tick_excess_s": self.excess_s,
            # None until a decode-only baseline exists: an unmeasurable
            # share must not pass for a measured one
            "excess_billed_to_prefill":
                min(1.0, self.interference_s / self.excess_s)
                if self.excess_s > 0 and self.ema_decode_s is not None else None,
        }


class _Request:
    __slots__ = ("tokens", "max_new", "future", "emitted", "scheduled",
                 "decode_steps", "submitted_at", "first_token_t", "last_emit_t")

    def __init__(self, tokens: List[int], max_new: int):
        self.tokens = list(tokens)
        self.max_new = int(max_new)
        self.future: Future = Future()
        self.emitted: List[int] = []
        # tokens DISPATCHED (prefill + chunks, capped at max_new): emitted
        # lags one chunk behind in the pipeline, so completion prediction
        # counts scheduled, not emitted
        self.scheduled = 0
        # decode steps dispatched for this request: its slot's pos is
        # len(tokens) + decode_steps, which the host keeps inside the cache
        self.decode_steps = 0
        self.submitted_at = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.last_emit_t: Optional[float] = None


class _HostCopy:
    """A device tensor on its way into host memory: a ``non_blocking``
    copy into pinned memory plus a CUDA event recorded after it.
    ``numpy()`` waits on the event, not on the whole device."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.clone()
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _PendingChunk:
    """One dispatched, not yet drained engine iteration."""

    __slots__ = ("chunk", "rows", "admissions", "firsts")

    def __init__(self, chunk: _HostCopy, rows, admissions, firsts: Optional[_HostCopy]):
        self.chunk = chunk            # [n_slots+1, steps] tokens
        self.rows = rows              # [(slot, _Request)] active in the chunk
        self.admissions = admissions  # [(row_j, slot, _Request)] admitted this iteration
        self.firsts = firsts          # [n_slots] first tokens, or None


class GenerationEngine:
    """Continuous-batching decode engine over
    :mod:`ray_tpu_torch.models.generate`.

    One background thread owns the device state (cache, last tokens); the
    public :meth:`submit` is thread-safe and returns a Future of the
    generated token list.  Runs on ``device`` (the card when None; raises
    when there is no card and none was asked for).
    """

    def __init__(
        self,
        cfg,
        params=None,
        *,
        n_slots: int = 4,
        max_new_tokens: int = 128,
        decode_chunk_steps: int = 16,
        prefill_buckets: tuple = (32, 64, 128, 256),
        temperature: float = 0.0,
        top_k: int = 0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        family = gen.family_of(cfg)  # raises for a config it cannot generate with
        if params is None:
            params = _default_init(cfg, seed, self.device)
        # inference-only params: f32 master weights cast to the compute
        # dtype once, not re-read in f32 on every decode step
        self.params = _cast_params(params, cfg.dtype, self.device)
        self.n_slots = n_slots
        self.max_new_tokens = max_new_tokens
        self.chunk = decode_chunk_steps
        self.buckets = tuple(sorted(prefill_buckets))
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id

        self._max_len = self.buckets[-1] + max_new_tokens + decode_chunk_steps
        if family == "gpt2" and self._max_len > cfg.max_seq_len:
            raise ValueError(
                f"largest bucket + max_new_tokens + decode_chunk_steps = "
                f"{self._max_len} exceeds the model's {cfg.max_seq_len} positions")
        # one extra SCRATCH slot (index n_slots) takes the padding rows of
        # a batched admission
        self.cache = gen.init_cache(cfg, n_slots + 1, self._max_len, self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # device-resident last token per slot: chunk N+1 chains off chunk
        # N's output on the device, so dispatching N+1 never waits for N
        self._last_tok = torch.zeros(n_slots + 1, dtype=torch.long, device=self.device)

        self._slots: List[Optional[_Request]] = [None] * n_slots
        self._pending: Optional[_PendingChunk] = None
        self._draining: Optional[_PendingChunk] = None  # mid-_drain record
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.total_generated = 0
        self.total_requests = 0
        self.prefills = 0  # admission calls (each one prefill of width n_slots)
        self._ticks = _TickMeter()
        self._ttft_samples: "deque[float]" = deque(maxlen=4096)
        self._itl_samples: "deque[float]" = deque(maxlen=4096)

    # -- public API ----------------------------------------------------
    def _submit_req(self, tokens: List[int], max_new: Optional[int]) -> _Request:
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(tokens)} exceeds the largest prefill "
                f"bucket {self.buckets[-1]}")
        if min(tokens) < 0 or max(tokens) >= self.cfg.vocab_size:
            raise ValueError(f"prompt token outside [0, {self.cfg.vocab_size})")
        req = _Request(tokens, min(max_new or self.max_new_tokens, self.max_new_tokens))
        with self._lock:
            self._queue.append(req)
            self.total_requests += 1
        self._work.set()
        return req

    def submit(self, tokens: List[int], max_new: Optional[int] = None) -> Future:
        return self._submit_req(tokens, max_new).future

    def generate(self, tokens: List[int], max_new: Optional[int] = None,
                 timeout: float = 300.0) -> List[int]:
        return self.submit(tokens, max_new).result(timeout)

    def stream(self, tokens: List[int], max_new: Optional[int] = None,
               timeout: float = 300.0):
        """Yield token ids as the engine emits them.  Raises the request's
        error, if any."""
        req = self._submit_req(tokens, max_new)
        n = 0
        deadline = time.perf_counter() + timeout
        while True:
            emitted = req.emitted  # list append is atomic; len-snapshot safe
            m = len(emitted)
            while n < m:
                yield emitted[n]
                n += 1
            if req.future.done():
                for t in req.emitted[n:]:
                    yield t
                req.future.result()  # surface engine errors
                return
            if time.perf_counter() > deadline:
                raise TimeoutError("token stream timed out")
            time.sleep(0.02)

    def start(self) -> "GenerationEngine":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="generation-engine")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            # cap prediction frees slots at dispatch, so in-flight work also
            # lives in the undrained pipeline records
            inflight = {id(s): s for s in self._slots if s is not None}
            for rec in (self._pending, self._draining):
                if rec is not None:
                    inflight.update((id(r), r) for _, r in rec.rows if not r.future.done())
            return {
                "active_slots": sum(s is not None for s in self._slots),
                "inflight_requests": len(inflight),
                "queued": len(self._queue),
                "total_requests": self.total_requests,
                "total_generated_tokens": self.total_generated,
                "prefills": self.prefills,
            }

    @staticmethod
    def _pctiles(samples) -> Dict[str, Any]:
        vals = sorted(samples)
        n = len(vals)
        if not n:
            return {"count": 0, "p50_s": None, "p99_s": None, "mean_s": None}
        return {
            "count": n,
            "p50_s": vals[n // 2],
            "p99_s": vals[min(n - 1, int(n * 0.99))],
            "mean_s": sum(vals) / n,
        }

    def perf_stats(self) -> Dict[str, Any]:
        """TTFT and inter-token-latency percentiles over the recent sample
        reservoirs, plus the prefill-interference meter."""
        with self._lock:
            ttft = list(self._ttft_samples)
            itl = list(self._itl_samples)
        return {"ttft": self._pctiles(ttft), "itl": self._pctiles(itl),
                **self._ticks.snapshot()}

    # -- engine loop ---------------------------------------------------
    def _loop(self) -> None:
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    worked = self.step()
                except Exception as e:  # noqa: BLE001 — an engine error must
                    # fail the affected requests, not kill the thread silently
                    self._fail_all(e)
                    worked = False
                if not worked:
                    self._work.wait(timeout=0.05)
                    self._work.clear()

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            victims = [s for s in self._slots if s is not None] + self._queue
            for rec in (self._pending, self._draining):
                if rec is not None:
                    victims += [r for _, r in rec.rows]
            self._slots = [None] * self.n_slots
            self._queue = []
            self._pending = None
            self._draining = None
        for req in dict.fromkeys(victims):
            if not req.future.done():
                req.future.set_exception(exc)
        # the cache may be half written: restart from a fresh one
        self.cache = gen.init_cache(self.cfg, self.n_slots + 1, self._max_len, self.device)
        self._last_tok = torch.zeros(self.n_slots + 1, dtype=torch.long, device=self.device)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":  # pinned + non_blocking: no host stall
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _admit(self):
        """Prefill queued prompts into all free slots with one call (width
        fixed at n_slots; padding rows target the scratch slot).  The
        sampled first tokens stay on the device (merged into the last-token
        row there) and reach the host with the next drain."""
        with self._lock:
            free = [i for i, s in enumerate(self._slots) if s is None]
            take = min(len(free), len(self._queue))
            if take == 0:
                return [], None
            batch = [(free[j], self._queue.pop(0)) for j in range(take)]
            for slot, req in batch:
                self._slots[slot] = req
        b = self._bucket(max(len(r.tokens) for _, r in batch))
        n = self.n_slots
        toks = np.zeros((n, b), np.int64)
        toks[:, 0] = 1  # padding rows: a 1-token dummy prompt
        lens = np.ones((n,), np.int64)
        slots = np.full((n,), self.n_slots, np.int64)  # scratch slot
        for j, (slot, req) in enumerate(batch):
            toks[j, :len(req.tokens)] = req.tokens
            lens[j] = len(req.tokens)
            slots[j] = slot
        slots_dev = self._to_device(slots)
        last_logits, self.cache = gen.prefill_at(
            self.params, self.cfg, self._to_device(toks), self._to_device(lens),
            self.cache, slots_dev)
        self.prefills += 1
        firsts = gen.sample_logits(last_logits, self._generator,
                                   temperature=self.temperature, top_k=self.top_k)
        self._last_tok[slots_dev] = firsts
        for _, req in batch:
            req.scheduled = 1  # the prefill's sampled first token
        admissions = [(j, slot, req) for j, (slot, req) in enumerate(batch)]
        return admissions, _HostCopy(firsts)

    def _check_cache_bound(self, rows) -> None:
        """This chunk writes a slot's K/V at ``len + decode_steps`` up to
        ``+ chunk - 1`` and leaves its pos one past that; all of it must
        stay inside the cache (PyTorch raises on an out-of-range index,
        on the card as a device-side assert)."""
        for i, req in rows:
            if len(req.tokens) + req.decode_steps + self.chunk >= self._max_len:
                raise RuntimeError(
                    f"slot {i} would decode past the cache length {self._max_len}")

    def step(self) -> bool:
        """One engine iteration, pipelined against the device:

        1. admit queued prompts into free slots (prefill, no readback)
        2. dispatch decode chunk N (chains off device-side last tokens)
        3. free the slots whose request reaches its cap in chunk N, so the
           next admission reuses them at once
        4. drain chunk N-1 (its copy to the host started an iteration
           ago) and resolve finished futures"""
        t_tick0 = time.perf_counter()
        admissions, firsts = self._admit()
        admit_s = time.perf_counter() - t_tick0
        with self._lock:
            rows = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        dispatched = None
        if rows:
            self._check_cache_bound(rows)
            active = np.zeros((self.n_slots + 1,), bool)  # scratch inactive
            active[[i for i, _ in rows]] = True
            emitted, self.cache, _ = gen.decode_chunk(
                self.params, self.cfg, self.cache, self._last_tok,
                self._to_device(active), self._generator, steps=self.chunk,
                temperature=self.temperature, top_k=self.top_k, eos_id=self.eos_id)
            # inactive slots carry their token through, so the last column
            # is every slot's next input
            self._last_tok = emitted[:, -1]
            dispatched = _PendingChunk(_HostCopy(emitted), rows, admissions, firsts)
            with self._lock:
                for i, req in rows:
                    req.decode_steps += self.chunk
                    req.scheduled = min(req.max_new, req.scheduled + self.chunk)
                    if req.scheduled >= req.max_new:
                        self._slots[i] = None
        prev, self._pending = self._pending, dispatched
        if prev is not None:
            self._draining = prev  # visible to the error path
            self._drain(prev)
            self._draining = None
        self._ticks.record(time.perf_counter() - t_tick0,
                           admit_s if admissions else 0.0, len(admissions), len(rows))
        return dispatched is not None or prev is not None

    def _finished(self, req: _Request) -> bool:
        return len(req.emitted) >= req.max_new or (
            self.eos_id is not None and bool(req.emitted)
            and req.emitted[-1] == self.eos_id)

    def _drain(self, pending: _PendingChunk) -> None:
        """Route a landed chunk's tokens (and its admissions' first tokens)
        to their requests and resolve the finished ones."""
        firsts = pending.firsts.numpy() if pending.firsts is not None else None
        chunk = pending.chunk.numpy()
        drain_t = time.perf_counter()
        if firsts is not None:
            for j, _slot, req in pending.admissions:
                req.emitted.append(int(firsts[j]))
                req.first_token_t = req.last_emit_t = drain_t
                with self._lock:
                    self._ttft_samples.append(drain_t - req.submitted_at)
        for i, req in pending.rows:
            if req.future.done():
                continue
            n_before = len(req.emitted)
            for t in chunk[i]:
                # check BEFORE append: the prefill's first token may already
                # have met max_new (or been EOS)
                if self._finished(req):
                    break
                req.emitted.append(int(t))
            k = len(req.emitted) - n_before
            if k > 0 and req.last_emit_t is not None and req.last_emit_t != drain_t:
                # per-drain mean gap: chunked decode lands tokens in bursts
                with self._lock:
                    self._itl_samples.append((drain_t - req.last_emit_t) / k)
            if k > 0:
                req.last_emit_t = drain_t
            if self._finished(req):
                with self._lock:
                    if self._slots[i] is req:  # EOS: not freed by cap prediction
                        self._slots[i] = None
                    self.total_generated += len(req.emitted)
                req.future.set_result(req.emitted)


def _cast_params(tree, dtype: torch.dtype, device: torch.device):
    if isinstance(tree, dict):
        return {k: _cast_params(v, dtype, device) for k, v in tree.items()}
    if tree.dtype == torch.float32:
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def _default_init(cfg, seed: int, device: torch.device):
    from ray_tpu_torch.models import gpt2, llama

    m = gpt2 if gen.family_of(cfg) == "gpt2" else llama
    return m.init(cfg, torch.Generator().manual_seed(seed), device=device)


def make_config(family: str = "gpt2", size: str = "tiny", **kw):
    if family == "gpt2":
        from ray_tpu_torch.models.gpt2 import GPT2Config as C

        return C.gpt2_small(**kw) if size in ("small", "125m") else C.tiny(**kw)
    if family == "llama":
        from ray_tpu_torch.models.llama import LlamaConfig as C

        return C.llama_125m(**kw) if size in ("small", "125m") else C.tiny(**kw)
    raise ValueError(f"unknown model family {family!r}")
