#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each (``kernel_case`` lines too, one per shape of
the backward kernels):

1. ``device``: the card, its power limit, and the kernels' build time
   (``nvcc``, one process per source, all started together).
2. ``kernels``: every hand-written kernel against its plain PyTorch
   version on the card, within stated tolerances: the forward at the
   serving shapes, at small f32 shapes and at both training paths' shapes
   and layouts (GPT-2 B 6 x T 1024; Llama's GQA, B 2 x T 2048), the two
   backward kernels at those training shapes and at small f32,
   rectangular and ragged shapes; each
   kernel's time beside the plain version's, one library call's and the
   bound the card sets, at the shapes the main paths give it.
3. ``parity``: tiny GPT-2 and Llama in f32 (and GPT-2 at full width, two
   layers) with the same weights on the CPU and on the card: the prefill
   logits agree and the greedy token streams are equal.
4. ``train_parity``: tiny GPT-2 and Llama in f32, 5 train steps from the
   same weights on the CPU and on the card (remat "dots" on the card):
   per-step losses and final params agree; GPT-2 at full width with two
   layers: the loss and every gradient leaf agree.
5. ``serve_gpt2``: GPT-2 125M in bf16 through ``GenerationEngine``: 16
   slots, 32 requests of 16-99 random prompt tokens (numpy
   ``default_rng(0)``), 128 new tokens each.  Launch counts are set to 0
   just before the requests and read just after.
6. ``decode_profile``: one eager decode step of GPT-2 125M at 17 slots:
   host enqueue time, device time and kernels per step.
7. ``serve_llama``: Llama 125M, the same traffic.
8. ``train_gpt2``: the training path, GPT-2 125M at full width (bf16
   compute over f32 master weights, remat "dots"), B 6 x T 1024,
   ``make_optimizer(lr=3e-4)``: 3 warm-up steps, then 20 timed steps in
   3 windows (the shape of ``bench.py``'s train loop).  Launch counts are
   set to 0 just before the first step and read just after the last.
9. ``train_profile``: one such step under ``torch.profiler``: device busy
   and idle share, the three kernels' share of the step, top kernels.
10. ``train_llama``: Llama 125M, B 2 x T 2048, 2 warm-up and 5 timed steps.

Then a ``{"kernels": [...]}`` line (launches summed over the serving and
training runs, and per run), the card's name and power limit as ``nvidia-smi``
prints them, and last ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (the dense bf16 tensor-core
# peak is ray_tpu_torch.util.flops.peak_flops)
PEAK_BYTES_PER_S = 3.35e12

# H100 SXM data sheet: float32 outside the tensor cores (the f32 kernels'
# and plain versions' rate with TF32 off)
PEAK_F32_FLOPS = 67e12

N_REQUESTS = 32
NEW_TOKENS = 128
SERVE = dict(n_slots=16, max_new_tokens=NEW_TOKENS, decode_chunk_steps=64,
             prefill_buckets=(128,))

# bench.py's train loop: B 6, T 1024, N_STEPS 20 timed after 3 warm-up steps
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_WINDOWS = 6, 3, (7, 7, 6)
# Llama 125M at its T 2048: B 2, 2 warm-up and 5 timed steps
LLAMA_BATCH, LLAMA_WARMUP, LLAMA_WINDOWS = 2, 2, (5,)


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "elapsed_s": time.perf_counter() - _T0}),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """SM clock, its maximum and the power draw now, as nvidia-smi prints
    them: a slow card shows here, not as a slow kernel."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, calls: int = 10, warmup: int = 3, tries: int = 3) -> float:
    """Device time of one call of ``fn`` in ms as the sum of its kernels'
    own durations under torch.profiler (user annotations excluded), over
    ``calls`` calls after a warm-up (a warm L2).  Host time between
    launches does not count: CUDA events around back-to-back calls time a
    short call at the host's pace when its host cost (Python checks,
    autograd, dispatch) exceeds its device work, and the host's speed
    differs from call to call of this script.  Every kernel, plain and
    library time this script prints is taken this way.

    Each call launches the same kernels, so a session whose kernel count
    is not a positive multiple of ``calls`` lost records (one session of
    a run once came back with none); it is run again, up to ``tries``
    times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        if kernels and len(kernels) % calls == 0:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
        counts.append(len(kernels))
    raise RuntimeError(f"device_ms: the profiler recorded {counts} device events "
                       f"for {calls} calls in {tries} sessions")


def num_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(num_params(v) for v in tree.values())
    return tree.numel()


def pct(vals, q: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(len(vals) * q))]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(build):
    t0 = time.perf_counter()
    builds = build.build([attn.KERNEL, attn.BWD_SOURCE], ptxas_verbose=True)
    for name, b in builds.items():
        print(f"--- nvcc {name}.cu ---\n{b['log']}", file=sys.stderr, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s={n: b["seconds"] for n, b in builds.items()},
         build_wall_s=time.perf_counter() - t0)


def _qkv(b, h, tq, tk, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda t: torch.randn(b, h, t, d, generator=g, device="cuda", dtype=torch.float32).to(dtype)
    return mk(tq), mk(tk), mk(tk)


def train_attn_shapes():
    """What each training path gives the three kernels per attention call,
    ``{path: (B, H, KV heads, T, D)}``, from the configs ``main`` trains."""
    from ray_tpu_torch.models import gpt2, llama

    g, lc = gpt2.GPT2Config.gpt2_small(), llama.LlamaConfig.llama_125m()
    return {"train_gpt2": (TRAIN_BATCH, g.n_heads, g.n_heads, g.max_seq_len, g.head_dim),
            "train_llama": (LLAMA_BATCH, lc.n_heads, lc.n_kv_heads, lc.max_seq_len, lc.head_dim)}


def _model_qkv(b, h, kv, t, d, seed):
    """bf16 (q, k, v, dO) laid out as a train step hands them to the kernels:
    head-split views ``[B, T, heads, D] -> [B, heads, T, D]`` of one fused
    projection (unit stride on D only), k and v repeated to H heads by
    ``repeat_interleave`` when KV < H (GQA), dO a strided view as well."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn(b, t, n, d, generator=g, device="cuda").to(torch.bfloat16)
    fused = mk(h + 2 * kv)
    q, k, v = (fused[:, :, a:a + n].transpose(1, 2)
               for a, n in ((0, h), (h, kv), (h + kv, kv)))
    if kv != h:
        k, v = (x.repeat_interleave(h // kv, dim=1) for x in (k, v))
    return q, k, v, mk(h).transpose(1, 2)


# per kernel: [B,H,Tq,D] tensors moved, [B,H,Tk,D] tensors moved, f32 [B,H,Tq]
# rows moved, products over the visible pairs
_FLASH_WORK = {
    "flash_fwd": (2, 2, 1, 2),      # q, o | k, v | lse | S, P·V
    "flash_bwd_dq": (3, 2, 2, 3),   # q, dO, dq | k, v | lse, Δ | S, dP, dS·K
    "flash_bwd_dkv": (2, 4, 2, 4),  # q, dO | k, v, dk, dv | lse, Δ | S, Pᵀ·dO, dP, dSᵀ·Q
}


def flash_bound_ms(kernel, b, h, tq, tk, d, causal, dtype=torch.bfloat16):
    """The least time the card could take for a flash kernel's work: each
    input read once and each output written once over HBM bandwidth,
    against the products of the visible pairs (2·D operations each) over
    the card's peak for the dtype (the tensor-core bf16 peak; for f32, the
    non-tensor-core f32 peak, TF32 being off).  Returns (ms, bound_by)."""
    from ray_tpu_torch.util.flops import peak_flops

    n_q, n_k, n_rows, n_products = _FLASH_WORK[kernel]
    elt = torch.finfo(dtype).bits // 8
    nbytes = b * h * ((n_q * tq + n_k * tk) * d * elt + n_rows * tq * 4)
    if causal:
        off = tk - tq
        pairs = sum(min(tk, off + i + 1) for i in range(tq))
    else:
        pairs = tq * tk
    flops = n_products * 2 * d * pairs * b * h
    peak = (peak_flops(torch.cuda.get_device_name(0)) if dtype == torch.bfloat16
            else PEAK_F32_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    """flash_fwd against flash_attention_reference, out and lse.
    Tolerances: f32 |err| <= 1e-5 + 1e-5|ref| (only the summation order
    differs); bf16 |err| <= 1e-2 + 1e-2|ref| (one bf16 ulp is 2^-8
    relative, and the kernel rounds P to bf16 before normalising where the
    plain version rounds after); lse |err| <= 1e-4 in both (f32 on both
    sides)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(16, 12, t, t, 64, True, torch.bfloat16) for t in (32, 64, 128, 256)]
    cases += [(2, 4, 128, 128, d, c, torch.float32) for d in (16, 64) for c in (False, True)]
    cases += [(2, 4, 128, 256, 64, c, torch.float32) for c in (False, True)]
    cases += [(2, 3, 97, 97, 32, True, torch.float32), (2, 3, 97, 131, 128, False, torch.bfloat16)]
    results = []
    for i, (b, h, tq, tk, d, causal, dtype) in enumerate(cases):
        q, k, v = _qkv(b, h, tq, tk, d, dtype, seed=i)
        out, lse = attn.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, causal)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        diff = (out.float() - ref_out.float()).abs()
        err_out = diff.max().item()
        excess = (diff - (tol + tol * ref_out.float().abs())).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        shape = f"{b}x{h}x{tq}x{tk}x{d}"
        check(bool(torch.isfinite(out).all()), f"flash_fwd non-finite output at {shape}")
        check(excess <= 0, f"flash_fwd out disagrees at {shape} {dtype}: max err {err_out}")
        check(err_lse <= 1e-4, f"flash_fwd lse disagrees at {shape} {dtype}: max err {err_lse}")
        results.append({"shape": shape, "causal": causal, "dtype": str(dtype).split(".")[-1],
                        "max_abs_err_out": err_out, "max_abs_err_lse": err_lse})

    # the serving shape: one admission of 16 slots x 12 heads x 128 tokens
    b, h, t, d, dtype = 16, 12, 128, 64, torch.bfloat16
    q, k, v = _qkv(b, h, t, t, d, dtype, seed=100)
    out, lse = attn.flash_attention(q, k, v, True)
    ref_out, _ = attn.flash_attention_reference(q, k, v, True)
    main_err = (out.float() - ref_out.float()).abs().max().item()
    sdpa = torch.nn.functional.scaled_dot_product_attention  # a yardstick: the port never calls it
    timed = {"kernel": device_ms(lambda: attn.flash_attention(q, k, v, True)),
             "plain": device_ms(lambda: attn.flash_attention_reference(q, k, v, True)),
             "library": device_ms(lambda: sdpa(q, k, v, is_causal=True))}
    clocks = gpu_clocks()
    bound_ms, bound_by = flash_bound_ms(attn.KERNEL, b, h, t, t, d, True)
    main = {"name": attn.KERNEL, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/attention.py:161",
            "max_abs_err": main_err, "ms": timed["kernel"], "plain_ms": timed["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": timed["library"]}
    # the training paths' shapes and layouts, where the forward runs 24
    # times a step
    main["at_train_shapes"] = {}
    for i, (path, (b, h, kv, t, d)) in enumerate(train_attn_shapes().items()):
        q, k, v, _ = _model_qkv(b, h, kv, t, d, seed=101 + i)
        out, _ = attn.flash_attention(q, k, v, True)
        train_err = (out.float() - attn.flash_attention_reference(q, k, v, True)[0].float()
                     ).abs().max().item()
        check(train_err <= 2e-2, f"flash_fwd at the {path} shape: max err {train_err}")
        train = {"kernel": device_ms(lambda: attn.flash_attention(q, k, v, True)),
                 "plain": device_ms(lambda: attn.flash_attention_reference(q, k, v, True)),
                 "library": device_ms(lambda: sdpa(q, k, v, is_causal=True))}
        t_bound, t_by = flash_bound_ms(attn.KERNEL, b, h, t, t, d, True)
        main["at_train_shapes"][path] = {
            "shape": f"{b}x{h}x{t}x{t}x{d} bf16 causal, {kv} KV heads",
            "max_abs_err": train_err, "ms": train["kernel"], "plain_ms": train["plain"],
            "bound_ms": t_bound, "bound_by": t_by, "library_ms": train["library"]}
    emit("kernels", cases=results, main_shape="16x12x128x128x64 bf16 causal",
         tolerance={"f32_out": "1e-5 + 1e-5|ref|", "bf16_out": "1e-2 + 1e-2|ref|",
                    "bf16_out_train_shapes": "2e-2 (one bf16 ulp below |out| 4)",
                    "lse": 1e-4},
         kernel_ms=main["ms"], bound_us=bound_ms * 1e3,
         clocks_sm_max_power_after_timing=clocks, **main)
    return main


# the backward kernels' tolerances against their plain versions: f32, each
# gradient sums up to Tk (dQ) or Tq (dK, dV) products in another order and
# dS = P·(dP − Δ) cancels; bf16, both sides round P and dS to bf16 at the
# same places, and an f32 ulp of difference before a rounding moves it by
# one bf16 ulp (2^-8 relative)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _bwd_inputs(b, h, tq, tk, d, causal, dtype, seed, kv=None):
    """(q, k, v, dO, lse, Δ): contiguous heads, or with ``kv`` KV heads the
    layout a train step gives (``_model_qkv``; bf16, Tq = Tk)."""
    if kv is None:
        q, k, v = _qkv(b, h, tq, tk, d, dtype, seed)
        do = _qkv(b, h, tq, tq, d, dtype, seed + 1000)[0]
    else:
        q, k, v, do = _model_qkv(b, h, kv, tq, d, seed)
    out, lse = attn.flash_attention(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


def _excess(got, ref, tol):
    """(max |err|, the most it exceeds tol + tol·|ref| by, ≤ 0 when within)."""
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff - (tol + tol * ref.float().abs())).max().item()


def phase_bwd_kernels():
    """flash_bwd_dq and flash_bwd_dkv against flash_dq_reference and
    flash_dkv_reference, given the same lse and Δ (from the forward
    kernel), at the training paths' shapes and layouts (bf16: GPT-2 at
    T 256 and 1024, Llama's GQA at T 2048) and at small f32 (TF32 off),
    rectangular and ragged shapes.  One ``kernel_case`` line per shape
    with errors, times, bounds and launch counts; returns the two kernels'
    rows at the GPT-2 training shape."""
    shapes = train_attn_shapes()
    b, h, kv, t, d = shapes["train_gpt2"]
    main_case = (b, h, t, t, d, True, torch.bfloat16, kv)
    cases = [(b, h, 256, 256, d, True, torch.bfloat16, kv), main_case]
    lb, lh, lkv, lt, ld = shapes["train_llama"]
    llama_case = (lb, lh, lt, lt, ld, True, torch.bfloat16, lkv)
    cases.append(llama_case)
    cases += [(2, 4, 128, 128, dd, c, torch.float32, None) for dd in (16, 64) for c in (False, True)]
    cases += [(2, 4, 128, 256, 64, c, torch.float32, None) for c in (False, True)]
    cases += [(2, 3, 97, 97, 32, True, torch.float32, None),
              (2, 3, 97, 131, 128, False, torch.bfloat16, None)]
    rows = {}
    for i, case in enumerate(cases):
        b_, h_, tq, tk, d_, causal, dtype, kv_ = case
        args = _bwd_inputs(b_, h_, tq, tk, d_, causal, dtype, seed=200 + i, kv=kv_)
        build.reset_launches()
        dq = attn.flash_bwd_dq(*args, causal)
        dk, dv = attn.flash_bwd_dkv(*args, causal)
        torch.cuda.synchronize()
        launches = {n: build.launches.get(n, 0) for n in (attn.DQ_KERNEL, attn.DKV_KERNEL)}
        check(launches == {attn.DQ_KERNEL: 1, attn.DKV_KERNEL: 1},
              f"backward launches {launches}, want one of each")
        ref_dq = attn.flash_dq_reference(*args, causal)
        ref_dk, ref_dv = attn.flash_dkv_reference(*args, causal)
        tol = BWD_TOL[dtype]
        shape = f"{b_}x{h_}x{tq}x{tk}x{d_}" + (f", {kv_} KV heads" if kv_ else "")
        errs = {}
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            check(bool(torch.isfinite(got).all()), f"{name} non-finite at {shape}")
            errs[name], excess = _excess(got, ref, tol)
            check(excess <= 0, f"{name} disagrees at {shape} {dtype}: max err {errs[name]}")
        main = case == main_case
        timed = {name: device_ms(fn) for name, fn in (
            (attn.DQ_KERNEL, lambda: attn.flash_bwd_dq(*args, causal)),
            ("plain_dq", lambda: attn.flash_dq_reference(*args, causal)),
            (attn.DKV_KERNEL, lambda: attn.flash_bwd_dkv(*args, causal)),
            ("plain_dkv", lambda: attn.flash_dkv_reference(*args, causal)))}
        row = {"shape": shape, "causal": causal, "dtype": str(dtype).split(".")[-1],
               "tolerance": f"{tol} + {tol}|ref|", "max_abs_err": errs, "launches": launches}
        for kern, plain, err in ((attn.DQ_KERNEL, "plain_dq", errs["dq"]),
                                 (attn.DKV_KERNEL, "plain_dkv", max(errs["dk"], errs["dv"]))):
            bound_ms, bound_by = flash_bound_ms(kern, b_, h_, tq, tk, d_, causal, dtype)
            row[kern] = {"kernel_ms": timed[kern], "plain_ms": timed[plain],
                         "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            if main:
                rows[kern] = {"name": kern, "route": "cuda",
                              "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                              "replaces": ("ray_tpu/ops/attention.py:250" if kern == attn.DQ_KERNEL
                                           else "ray_tpu/ops/attention.py:292"),
                              "max_abs_err": err, "ms": timed[kern], "plain_ms": timed[plain],
                              "bound_ms": bound_ms, "bound_by": bound_by}
        if case in (main_case, llama_case):
            row["library_dq_dk_dv_ms"] = library_backward_ms(*args[:4])
            row["kernels_dq_plus_dkv_ms"] = timed[attn.DQ_KERNEL] + timed[attn.DKV_KERNEL]
        if main:
            for kern in rows:
                rows[kern]["library_ms"] = row["library_dq_dk_dv_ms"]
        emit("kernel_case", **row)
    check(set(rows) == {attn.DQ_KERNEL, attn.DKV_KERNEL}, "no training-shape backward rows")
    emit("kernels_bwd", main_shape=f"{b}x{h}x{t}x{t}x{d} bf16 causal",
         library_note="library_ms is F.scaled_dot_product_attention's backward "
                      "(the kernels of forward+backward minus those of the forward, "
                      "profiler device time): dQ, dK and dV together, on both rows; "
                      "the port never calls it",
         clocks_sm_max_power_after_timing=gpu_clocks(), rows=list(rows.values()))
    return rows


def library_backward_ms(q, k, v, do):
    """The device time of ``F.scaled_dot_product_attention``'s backward
    (dQ, dK and dV together) at these inputs: the kernels of forward plus
    backward, minus those of the forward (``device_ms``).  A yardstick
    only."""
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_bwd = device_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True),
                                                    (qg, kg, vg), do))
    return fwd_bwd - device_ms(lambda: sdpa(qg, kg, vg, is_causal=True))


def _to(params, device):
    """A copy of a params tree on ``device``."""
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device, copy=True)
            for k, v in params.items()}


def phase_parity():
    """The same weights on the CPU and on the card (f32, TF32 off)."""
    from ray_tpu_torch.models import generate as gen, gpt2, llama

    rows = []
    specs = [("gpt2_tiny", gpt2, gpt2.GPT2Config.tiny(dtype=torch.float32), 1e-4),
             ("llama_tiny", llama, llama.LlamaConfig.tiny(dtype=torch.float32), 1e-4),
             ("gpt2_125m_2layers", gpt2,
              gpt2.GPT2Config.gpt2_small(n_layers=2, dtype=torch.float32), 1e-3)]
    rng = np.random.default_rng(0)
    for name, mod, cfg, atol in specs:
        p_cpu = mod.init(cfg, torch.Generator().manual_seed(1), device="cpu")
        p_gpu = _to(p_cpu, "cuda")
        lengths = [5, 11, 8]
        prompts = np.zeros((3, max(lengths)), np.int64)
        for j, n in enumerate(lengths):
            prompts[j, :n] = rng.integers(1, cfg.vocab_size, n)
        streams, logits = {}, {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            toks = torch.from_numpy(prompts).to(dev)
            lens = torch.tensor(lengths, device=dev)
            cache = gen.init_cache(cfg, 3, max(lengths), device=dev)
            before = build.launches.get(attn.KERNEL, 0)
            with torch.inference_mode():
                logits[dev], _ = gen.prefill(params, cfg, toks, lens, cache, 0)
                streams[dev] = gen.generate(params, cfg, toks, lens, max_new_tokens=16).tolist()
            grew = build.launches.get(attn.KERNEL, 0) - before
            if dev == "cuda":
                check(grew == 2 * cfg.n_layers,
                      f"{name}: {grew} flash launches on the card, want {2 * cfg.n_layers}")
        err = (logits["cpu"] - logits["cuda"].cpu()).abs().max().item()
        check(err <= atol, f"{name}: prefill logits differ by {err} > {atol}")
        check(streams["cpu"] == streams["cuda"], f"{name}: greedy streams differ\n"
              f"cpu  {streams['cpu']}\ncuda {streams['cuda']}")
        rows.append({"model": name, "logits_max_abs_err": err, "atol": atol,
                     "streams_equal": True, "tokens": len(streams["cuda"][0])})
    emit("parity", models=rows)


def phase_train_parity():
    """The same weights and batches on the CPU and on the card, f32 with
    TF32 off.  Tiny GPT-2 and Llama: 5 train steps of
    ``make_optimizer(lr=1e-3, warmup=2, total_steps=10)``, remat "dots" on
    the card and none on the CPU; per-step losses within 1e-4 and final
    params within 2e-4 (a fifth of one Adam step at lr 1e-3).  The sums
    run in another order on the card, and the embedding backward
    accumulates with atomics there, in an order that changes from run to
    run; Adam divides whatever differs by sqrt(v) + eps.  GPT-2 at full
    width, two layers: the loss within 1e-5 and every gradient leaf within
    1e-4 of that leaf's largest entry."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.models.transformer import named_leaves, train_state

    rows = []
    rng = np.random.default_rng(1)
    for name, mod, cfg_fn in (("gpt2_tiny", gpt2, gpt2.GPT2Config.tiny),
                              ("llama_tiny", llama, llama.LlamaConfig.tiny)):
        cfgs = {"cpu": cfg_fn(dtype=torch.float32),
                "cuda": cfg_fn(dtype=torch.float32, remat=True, remat_policy="dots")}
        params = mod.init(cfgs["cpu"], torch.Generator().manual_seed(2), device="cpu")
        toks = torch.from_numpy(rng.integers(0, cfgs["cpu"].vocab_size, (4, 65)))
        losses, finals = {}, {}
        for dev, cfg in cfgs.items():
            opt = mod.make_optimizer(lr=1e-3, warmup=2, total_steps=10)
            state, step = train_state(_to(params, dev), opt), mod.make_train_step(cfg, opt)
            build.reset_launches()
            ls = []
            for _ in range(5):
                state, m = step(state, {"tokens": toks.to(dev)})
                ls.append(m["loss"])
            losses[dev] = [x.item() for x in ls]
            finals[dev] = dict(named_leaves(state["params"]))
            launches = dict(build.launches)
        per_step = 5 * cfgs["cuda"].n_layers
        check(launches.get(attn.DQ_KERNEL) == per_step and launches.get(attn.DKV_KERNEL) == per_step,
              f"{name}: backward launches {launches} on the card, want {per_step} each")
        loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        param_err = max((finals["cuda"][n].detach().cpu() - t.detach()).abs().max().item()
                        for n, t in finals["cpu"].items())
        check(loss_err <= 1e-4, f"{name}: losses differ by {loss_err}")
        check(param_err <= 2e-4, f"{name}: params differ by {param_err} after 5 steps")
        rows.append({"model": name, "steps": 5, "losses_cpu": losses["cpu"],
                     "losses_cuda": losses["cuda"], "loss_max_abs_err": loss_err,
                     "param_max_abs_err": param_err, "launches_cuda": launches})

    cfgs = {"cpu": gpt2.GPT2Config.gpt2_small(n_layers=2, dtype=torch.float32, remat=False),
            "cuda": gpt2.GPT2Config.gpt2_small(n_layers=2, dtype=torch.float32)}
    params = gpt2.init(cfgs["cpu"], torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(rng.integers(0, 50257, (2, 129)))
    loss, grads = {}, {}
    for dev, cfg in cfgs.items():
        p = _to(params, dev)
        for _, t in named_leaves(p):
            t.requires_grad_(True)
        out = gpt2.loss_fn(p, {"tokens": toks.to(dev)}, cfg)
        out.backward()
        loss[dev] = out.item()
        grads[dev] = {n: t.grad.cpu() for n, t in named_leaves(p)}
    loss_err = abs(loss["cpu"] - loss["cuda"])
    check(loss_err <= 1e-5, f"gpt2_125m_2layers: loss differs by {loss_err}")
    worst = 0.0
    for n, g in grads["cpu"].items():
        rel = (grads["cuda"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        check(rel <= 1e-4, f"gpt2_125m_2layers: grad {n} differs by {rel} of its largest entry")
        worst = max(worst, rel)
    rows.append({"model": "gpt2_125m_2layers", "loss_cpu": loss["cpu"], "loss_cuda": loss["cuda"],
                 "loss_abs_err": loss_err, "grad_max_err_over_leaf_max": worst,
                 "leaves": len(grads["cpu"])})
    emit("train_parity", models=rows)


def _train_batch(vocab, b, t):
    """Inputs and targets as ``bench.py`` makes them (numpy default_rng(0))."""
    rng = np.random.default_rng(0)
    return {"inputs": torch.from_numpy(rng.integers(0, vocab, (b, t), np.int32)).long().cuda(),
            "targets": torch.from_numpy(rng.integers(0, vocab, (b, t), np.int32)).long().cuda()}


def train(family: str, cfg, batch_size: int, warmup: int, windows):
    """The training path through the port's entry points: ``init_state``,
    ``make_optimizer(lr=3e-4)``, ``make_train_step``; ``warmup`` steps,
    then timed windows of steps (host clock, each ending in a loss read).
    Launch counts are set to 0 just before the first step and read just
    after the last."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.util import flops

    mod = {"gpt2": gpt2, "llama": llama}[family]
    opt = mod.make_optimizer(lr=3e-4)
    t0 = time.perf_counter()
    state = mod.init_state(cfg, torch.Generator().manual_seed(0), opt, device="cuda")
    step = mod.make_train_step(cfg, opt)
    batch = _train_batch(cfg.vocab_size, batch_size, cfg.max_seq_len)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(warmup):
        state, m = step(state, batch)
    first_loss = m["loss"].item() if warmup else None
    warmup_s = time.perf_counter() - t0
    ms_per_step, losses = [], []
    for n in windows:
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
        losses.append(m["loss"].item())
        ms_per_step.append((time.perf_counter() - t0) * 1e3 / n)
    launches = dict(build.launches)
    n_steps = warmup + sum(windows)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(x) for x in [first_loss or 0.0] + losses), f"{family}: non-finite loss")
    per_step = {n: launches.get(n, 0) / n_steps
                for n in (attn.KERNEL, attn.DQ_KERNEL, attn.DKV_KERNEL)}
    want = {attn.KERNEL: (2 if cfg.remat else 1) * cfg.n_layers,  # remat recomputes it
            attn.DQ_KERNEL: cfg.n_layers, attn.DKV_KERNEL: cfg.n_layers}
    check(per_step == want, f"{family}: {per_step} launches per step, want {want}")
    tokens = batch_size * cfg.max_seq_len
    tok_s = sorted(tokens / (ms / 1e3) for ms in ms_per_step)
    n_params = mod.num_params(state["params"])
    fpt = flops.model_flops_per_token(cfg, n_params)
    kind = torch.cuda.get_device_name(0)
    row = {"model": f"{family} 125M bf16 (f32 master weights), remat {cfg.remat_policy}",
           "params": n_params, "batch": batch_size, "seq_len": cfg.max_seq_len,
           "steps": n_steps, "warmup_steps": warmup, "windows": list(windows),
           "setup_s": setup_s, "warmup_s": warmup_s, "ms_per_step_by_window": ms_per_step,
           "tokens_per_s_median": tok_s[len(tok_s) // 2], "tokens_per_s_best": tok_s[-1],
           "flops_per_token": fpt, "peak_flops": flops.peak_flops(kind),
           "mfu_median": flops.mfu(tok_s[len(tok_s) // 2], fpt, kind),
           "mfu_best": flops.mfu(tok_s[-1], fpt, kind),
           "peak_mem_bytes": peak, "first_loss": first_loss, "window_last_losses": losses,
           "launches": launches, "launches_per_step": per_step}
    emit(f"train_{family}", **row)
    return state, step, batch, launches, row


# the device work of a step by kind, matched on the kernel's name in order
_KINDS = (("flash attention", ("flash_fwd_kernel", "flash_bwd_")),
          ("matrix products", ("nvjet", "gemm", "cutlass", "xmma")),
          ("optimizer (foreach)", ("multi_tensor_apply",)),
          ("reductions", ("reduce_kernel",)),
          ("copies and casts", ("copy", "Memcpy", "Memset")),
          ("elementwise", ("elementwise",)))


def phase_train_profile(state, step, batch, ms_per_step):
    """Where one training step's device time goes.  Device wall per step
    from CUDA events around 3 unprofiled steps; then one step under
    torch.profiler: kernel time (user annotations excluded, they overlap
    the kernels), the three flash kernels' time and share, the time by
    kind of kernel, and the top kernels.  The profiler slows the host, so
    the idle share is taken against the unprofiled device wall; the
    profiled step's own wall is printed beside it."""
    ev = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start, end = ev(), ev()
    start.record()
    for _ in range(3):
        state, m = step(state, batch)
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = ev(), ev()
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
    profiled_ms = start.elapsed_time(end)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    check(bool(dev_events), "train_profile: the profiler saw no device time")
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    flash = {}
    for kern in (attn.KERNEL, attn.DQ_KERNEL, attn.DKV_KERNEL):
        hits = [(c, us) for n, (c, us) in by_name.items() if f"{kern}_kernel" in n]
        flash[kern] = {"launches": sum(c for c, _ in hits),
                       "device_ms": sum(us for _, us in hits) / 1e3}
        flash[kern]["share_of_step"] = flash[kern]["device_ms"] / wall_ms
    kinds = {}
    for n, (c, us) in by_name.items():
        kind = next((k for k, keys in _KINDS if any(key in n for key in keys)), "other")
        kc, kms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (kc + c, kms + us / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    emit("train_profile", model="gpt2 125M bf16, B 6 x T 1024, remat dots",
         step_device_wall_ms=wall_ms, host_ms_per_step=ms_per_step,
         profiled_step_device_wall_ms=profiled_ms, device_busy_ms=busy_ms,
         busy_share=busy_ms / wall_ms, idle_share=1 - busy_ms / wall_ms,
         kernels_in_step=len(dev_events), flash=flash,
         flash_share_of_step=sum(f["share_of_step"] for f in flash.values()),
         by_kind=[{"kind": k, "kernels": c, "ms": ms, "share_of_step": ms / wall_ms}
                  for k, (c, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1])],
         top_kernels=[{"name": n[:100], "count": c, "ms": us / 1e3, "share_of_step": us / 1e3 / wall_ms}
                      for n, (c, us) in top],
         loss=m["loss"].item())


def serve(family: str):
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config

    cfg = make_config(family, "125m")
    t0 = time.perf_counter()
    warm = GenerationEngine(cfg, seed=0, device="cuda", **SERVE).start()
    try:  # first calls of every shape, on an engine whose numbers are dropped
        warm.generate([1] * 8, 4, timeout=600)
    finally:
        warm.stop()
    params = warm.params
    del warm
    setup_s = time.perf_counter() - t0
    eng = GenerationEngine(cfg, params, device="cuda", **SERVE).start()
    rng = np.random.default_rng(0)
    vocab = min(50000, cfg.vocab_size)
    prompts = [rng.integers(1, vocab, rng.integers(16, 100)).tolist()
               for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    done_at = {}
    try:
        build.reset_launches()
        t_start = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            f = eng.submit(p, NEW_TOKENS)
            f.add_done_callback(lambda _f, i=i: done_at.__setitem__(i, time.perf_counter()))
            futs.append(f)
        outs = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t_start
        launches = dict(build.launches)
    finally:
        eng.stop()
    peak = torch.cuda.max_memory_allocated()
    for i, o in enumerate(outs):
        check(len(o) == NEW_TOKENS, f"{family}: request {i} returned {len(o)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o), f"{family}: token out of range")
    stats, perf = eng.stats(), eng.perf_stats()
    flash = launches.get(attn.KERNEL, 0)
    check(flash > 0, f"{family}: the serving run launched no flash_fwd kernel")
    check(flash == cfg.n_layers * stats["prefills"],
          f"{family}: {flash} flash launches for {stats['prefills']} admissions")
    lats = [done_at[i] - t_start for i in range(N_REQUESTS)]
    ms = lambda s: None if s is None else s * 1e3
    row = {
        "model": f"{family} 125M bf16", "params": num_params(params),
        "requests": N_REQUESTS, "new_tokens_per_req": NEW_TOKENS, "setup_s": setup_s,
        "wall_s": wall, "tokens_per_s": sum(len(o) for o in outs) / wall,
        "req_p50_ms": pct(lats, 0.5) * 1e3, "req_p99_ms": pct(lats, 0.99) * 1e3,
        "ttft_p50_ms": ms(perf["ttft"]["p50_s"]), "ttft_p99_ms": ms(perf["ttft"]["p99_s"]),
        "itl_p50_ms": ms(perf["itl"]["p50_s"]), "itl_p99_ms": ms(perf["itl"]["p99_s"]),
        "peak_mem_bytes": peak, "flash_launches": flash, "admissions": stats["prefills"],
        "ticks": perf["ticks"], "decode_tick_baseline_ms": ms(perf["decode_tick_baseline_s"]),
        "interference_frac": perf["interference_frac"], **{k: v for k, v in SERVE.items()
                                                          if k != "prefill_buckets"},
    }
    emit(f"serve_{family}", **row)
    return flash, params, cfg


def phase_decode_profile(params, cfg, n_slots: int, max_len: int):
    """Where a decode step's time goes: host enqueue time against device
    time, and kernels launched per step (torch.profiler)."""
    from ray_tpu_torch.models import generate as gen

    steps = 20
    cache = gen.init_cache(cfg, n_slots, max_len, device="cuda")
    toks = torch.ones(n_slots, dtype=torch.long, device="cuda")
    active = torch.zeros(n_slots, dtype=torch.bool, device="cuda")  # pos stays 0
    with torch.inference_mode():
        for _ in range(3):
            gen.decode_step(params, cfg, cache, toks, active)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            gen.decode_step(params, cfg, cache, toks, active)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        device_ms = start.elapsed_time(end) / steps
        # a whole chunk as the engine runs it (sampling included), from
        # this thread: tells the chunk's own cost from the engine's
        t0 = time.perf_counter()
        gen.decode_chunk(params, cfg, cache, toks, active, steps=steps)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3 / steps

    def in_thread(out):  # the same steps from a second thread, as the engine runs them
        with torch.inference_mode():
            t1 = time.perf_counter()
            for _ in range(steps):
                gen.decode_step(params, cfg, cache, toks, active)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1e3 / steps)

    thread_ms = []
    worker = threading.Thread(target=in_thread, args=(thread_ms,))
    worker.start()
    worker.join()
    check(len(thread_ms) == 1, "decode_profile: the threaded run failed")
    with torch.inference_mode():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                gen.decode_step(params, cfg, cache, toks, active)
            torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / 5
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("decode_profile", model="gpt2 125M bf16", slots=n_slots, cache_len=max_len,
         host_enqueue_ms_per_step=host_ms, wall_ms_per_step=wall_ms,
         device_ms_per_step=device_ms, decode_chunk_ms_per_step=chunk_ms,
         thread_ms_per_step=thread_ms[0],
         device_kernels_per_step=len(dev_events) / 5,
         device_busy_ms_per_step=busy_ms if dev_events else None,
         idle_share=(1 - busy_ms / device_ms) if dev_events else None,
         kernels_per_step_by_name=[{"name": n[:80], "per_step": c / 5, "us_per_step": us / 5}
                                   for n, (c, us) in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    global attn, build
    from ray_tpu_torch.ops import _build as build
    from ray_tpu_torch.ops import attention as attn

    phase_device(build)
    fwd = phase_kernels()
    bwd = phase_bwd_kernels()
    phase_parity()
    phase_train_parity()
    serve_launches, params, cfg = serve("gpt2")
    n_slots = SERVE["n_slots"] + 1
    max_len = SERVE["prefill_buckets"][-1] + NEW_TOKENS + SERVE["decode_chunk_steps"]
    phase_decode_profile(params, cfg, n_slots, max_len)
    del params
    serve_llama_launches = serve("llama")[0]

    from ray_tpu_torch.models import gpt2, llama
    state, step, batch, train_launches, row = train(
        "gpt2", gpt2.GPT2Config.gpt2_small(), TRAIN_BATCH, TRAIN_WARMUP, TRAIN_WINDOWS)
    phase_train_profile(state, step, batch, sorted(row["ms_per_step_by_window"])[1])
    del state, step, batch
    torch.cuda.empty_cache()
    _, _, _, llama_launches, _ = train("llama", llama.LlamaConfig.llama_125m(), LLAMA_BATCH,
                                       LLAMA_WARMUP, LLAMA_WINDOWS)

    fwd["launches_by_path"] = {"serve_gpt2": serve_launches,
                               "serve_llama": serve_llama_launches,
                               "train_gpt2": train_launches[attn.KERNEL],
                               "train_llama": llama_launches[attn.KERNEL]}
    fwd["launches"] = sum(fwd["launches_by_path"].values())
    for kern, r in bwd.items():
        r["launches_by_path"] = {"train_gpt2": train_launches[kern],
                                 "train_llama": llama_launches[kern]}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": [fwd, *bwd.values()]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
