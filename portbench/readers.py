"""What the metric readers share.  Each file of ``metrics/`` names its
metric and binds ``read(ctx)`` to one of these; a reader that finds
nothing to read returns None and the metric is left out of the line.

``ctx`` is what an entry recorded: the window's length on the host's
clock and what landed in it, the set-up seconds, the model's sizes, the
card's name, and with ``--trace 1`` the summary of a traced stretch
(``trace.summarize``) and, under ``untraced``, the window's length and
what landed in it up to the profiler's start.  The step's share of peak
and the engine's tick are read over that untraced part, so that they
measure the program and not the profiler.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from portbench import flops
from portbench.trace import kernel_seconds

Ctx = Dict[str, Any]


def setup_s(ctx: Ctx) -> Optional[float]:
    return ctx.get("setup_s")


def serve_tokens_per_s(ctx: Ctx) -> Optional[float]:
    """Generated tokens the engine handed to the clients' requests between
    its last delivery before the window opened and its last delivery
    before it closed, over the time between those two deliveries (the
    replica's clock).  The tokens of requests still running count as they
    are handed over, not when the whole reply lands; the window's ends sit
    on deliveries because the engine hands a chunk of tokens to every slot
    at once (a chunk more or less in a window of fixed length would move
    the rate by a chunk's share)."""
    c = ctx.get("counters", {})
    if "delivered" not in c.get("open", {}) or "delivered" not in c.get("close", {}):
        return None
    secs = c["close"]["delivered_t"] - c["open"]["delivered_t"]
    if secs <= 0:
        return None
    return (c["close"]["delivered"] - c["open"]["delivered"]) / secs


def train_tokens_per_s(ctx: Ctx) -> Optional[float]:
    """Batch times sequence tokens of the steps finished in the window,
    over the window (which ends in a synchronise)."""
    if "steps" not in ctx:
        return None
    return ctx["steps"] * ctx["batch"] * ctx["seq"] / ctx["window_s"]


def score_seqs_per_s(ctx: Ctx) -> Optional[float]:
    """Sequences whose logits reached the driver in the window, over the
    window."""
    if "rows" not in ctx:
        return None
    return ctx["rows"] / ctx["window_s"]


def idle_share(ctx: Ctx) -> Optional[float]:
    """Percent of the traced stretch in which no operation ran on the
    device."""
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def untraced(ctx: Ctx) -> Ctx:
    """``ctx`` with the window cut where the profiler started, if it did."""
    return {**ctx, **ctx["untraced"]} if ctx.get("untraced") else ctx


def _peak_flops(ctx: Ctx) -> Optional[float]:
    p = flops.peak(ctx.get("kind", ""))
    return p["bf16_flops"] if p else None


def mfu_decode(ctx: Ctx) -> Optional[float]:
    """Percent of the card's bf16 peak: the rate of tokens delivered
    (``serve_tokens_per_s``) times the model operations a token took on
    average over the window's replies (each prompt's prefill, then each
    token at its own context)."""
    ctx = untraced(ctx)
    peak, rate = _peak_flops(ctx), serve_tokens_per_s(ctx)
    if peak is None or rate is None or not ctx.get("replies"):
        return None
    d = ctx["dims"]
    total, tokens = 0, 0
    for r in ctx["replies"]:
        p, n = r["prompt_len"], r["tokens"]
        contexts = (n - 1) * p + n * (n - 1) // 2  # decode tokens at p+1 .. p+n-1
        total += (flops.prefill_flops(d, p) + (n - 1) * flops.dense_flops_per_token(d)
                  + d["n_layers"] * 4 * d["d_model"] * contexts)
        tokens += n
    return 100.0 * rate * (total / tokens) / peak


def mfu_train(ctx: Ctx) -> Optional[float]:
    """Percent of the card's bf16 peak: the model operations of the steps
    finished in the window (three forwards a step, recomputation not
    credited), over the window."""
    ctx = untraced(ctx)
    peak = _peak_flops(ctx)
    if peak is None or "steps" not in ctx:
        return None
    f = flops.train_step_flops(ctx["dims"], ctx["batch"], ctx["seq"])
    return 100.0 * ctx["steps"] * f / ctx["window_s"] / peak


def mfu_score(ctx: Ctx) -> Optional[float]:
    """Percent of the card's bf16 peak: the encoder's operations on the
    sequences scored in the window, over the window."""
    ctx = untraced(ctx)
    peak = _peak_flops(ctx)
    if peak is None or not ctx.get("rows"):
        return None
    f = flops.encoder_flops(ctx["dims"], ctx["rows"], ctx["seq"], ctx["n_classes"])
    return 100.0 * f / ctx["window_s"] / peak


def decode_tick_ms(ctx: Ctx) -> Optional[float]:
    """The engine's milliseconds a decode step over the window: the tick
    meter's seconds of the ticks that decoded (with an admission or
    without), over their ticks times the chunk's steps."""
    c = untraced(ctx).get("counters", {})
    if "open" not in c or "close" not in c:
        return None
    modes = ("decode_only", "interleaved")
    ticks = sum(c["close"]["ticks"][m] - c["open"]["ticks"][m] for m in modes)
    secs = sum(c["close"]["tick_s"][m] - c["open"]["tick_s"][m] for m in modes)
    if ticks <= 0:
        return None
    return 1e3 * secs / ticks / ctx["chunk"]


def flash_roofline(ctx: Ctx, kernels: Dict[str, Dict[str, Any]]) -> Optional[float]:
    """Percent: the least seconds of the traced launches of ``kernels``
    (name fragment -> shape of one launch), from their operations and
    bytes at the card's peaks, over the seconds they took."""
    tr = ctx.get("trace")
    if not tr or flops.peak(ctx.get("kind", "")) is None:
        return None
    least, took = 0.0, 0.0
    for needle, shape in kernels.items():
        n, secs = kernel_seconds(tr, needle)
        least += n * flops.least_seconds(flops.flash_cost(**shape), ctx["kind"])
        took += secs
    return 100.0 * least / took if took > 0 else None


def flash_roofline_train(ctx: Ctx) -> Optional[float]:
    """The forward (with its recomputation), dq and dkv kernels of the
    training step, summed."""
    d = ctx["dims"]
    shape = dict(batch=ctx["batch"], heads=d["n_heads"], tq=ctx["seq"], tk=ctx["seq"],
                 dh=d["d_model"] // d["n_heads"], causal=True)
    return flash_roofline(ctx, {"flash_fwd_kernel": dict(shape, kernel="fwd"),
                                "flash_bwd_dq_kernel": dict(shape, kernel="dq"),
                                "flash_bwd_dkv_kernel": dict(shape, kernel="dkv")})


def flash_fwd_roofline_score(ctx: Ctx) -> Optional[float]:
    """The encoder's non-causal forward kernel at the batch's shape."""
    d = ctx["dims"]
    return flash_roofline(ctx, {"flash_fwd_kernel": dict(
        kernel="fwd", batch=ctx["batch"], heads=d["n_heads"], tq=ctx["seq"], tk=ctx["seq"],
        dh=d["d_model"] // d["n_heads"], causal=False)})
