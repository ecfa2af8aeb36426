#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each (``kernel_case`` lines too, one per shape of
the backward kernels):

1. ``device``: the card, its power limit, the kernels' build time
   (``nvcc``, one process per source, all started together), and each
   kernel's count of tensor-core instructions (``HGMMA``, ``HMMA``) in
   ``cuobjdump -sass`` of the built libraries.
2. ``kernels``: every hand-written kernel against its plain PyTorch
   version on the card, within stated tolerances: the forward at the
   serving shapes, at small f32 shapes, at the tensor-core design's
   edges (bf16 at D 64 and 128: ragged 97 x 131, causal 128 x 256 with
   the diagonal at the bottom right, one query row, the fused-projection
   layout; ragged and fused non-causal at D 64), at both training paths'
   shapes and layouts (GPT-2 B 6 x T 1024; Llama's GQA, B 2 x T 2048)
   and non-causal at BERT's (16 x 128 and 4 x 512), the two backward
   kernels at those training shapes and edges and at small f32,
   rectangular and ragged shapes (dQ, dK and dV bit-identical across two
   calls); each kernel's time beside the plain version's, one library
   call's and the bound the card sets, at the shapes the main paths give
   it.
3. ``parity``: tiny GPT-2 and Llama in f32 (and GPT-2 at full width, two
   layers) with the same weights on the CPU and on the card: the prefill
   logits agree and the greedy token streams are equal.
4. ``bert_parity``: tiny BERT and BERT-base's width with two layers, f32,
   CPU and card, with and without token types: logits and labels.
5. ``train_parity``: tiny GPT-2, Llama and GPT-2 with 4 experts in f32,
   5 train steps from the same weights on the CPU and on the card (remat
   "dots" on the card): per-step losses and final params agree; GPT-2 at
   full width with two layers: the loss and every gradient leaf agree.
6. ``mlp``: the MNIST MLP in f32, CPU and card: loss, gradients,
   accuracy, and ``TorchPredictor`` labels of 10,000 inputs.
7. ``rl_parity``: the RL learner stack in f32 (TF32 off for matmul and
   cuDNN), the same weights on the CPU and the card: the Nature-CNN
   actor-critic's logits and values at 84 x 84 x 4 uint8, the PPO, A2C,
   IMPALA and DQN losses and every gradient leaf, one PPO
   ``learn_on_minibatch``, DQN's TD targets and one SAC update given the
   same noise.
8. ``rl_ppo_atari``: BASELINE config 4's shape (``bench.py``'s RL row):
   PPO on ``SyntheticAtariEnv`` through a ``RolloutWorker`` (64 envs,
   fragments of 16, 4 fragments an iteration) and ``train_one_step``
   (minibatches of 256, 4 epochs); 1 warm-up and 3 timed iterations:
   env-steps/s, sample/GAE/learn seconds, one SGD minibatch and one
   64-frame ``compute_actions`` under the profiler.  No kernel of the
   repo lies on this path; its launch counts are set to 0 just before
   the first iteration and read just after the last.
9. ``serve_gpt2``: GPT-2 125M in bf16 through ``GenerationEngine``: 16
   slots, 32 requests of 16-99 random prompt tokens (numpy
   ``default_rng(0)``), 128 new tokens each.  Launch counts are set to 0
   just before the requests and read just after.
10. ``decode_profile``: one eager decode step of GPT-2 125M at 17 slots:
    host enqueue time, device time and kernels per step.
11. ``serve_llama``: Llama 125M, the same traffic.
12. ``serve_bert``: BERT-base in bf16 through ``Checkpoint`` and
    ``TorchPredictor``, ``bench.py``'s config-5 traffic (768 sequences
    of 128 ids in batches of 16): sequences/s, batch latency, device
    work and idle share of one profiled batch.  Launch counts are set to
    0 just before the batches and read just after.
13. ``train_gpt2``: the training path, GPT-2 125M at full width (bf16
    compute over f32 master weights, remat "dots"), B 6 x T 1024,
    ``make_optimizer(lr=3e-4)``: 3 warm-up steps, then 20 timed steps in
    3 windows (the shape of ``bench.py``'s train loop).  Launch counts are
    set to 0 just before the first step and read just after the last.
14. ``train_profile``: one such step under ``torch.profiler``: device busy
    and idle share, the three kernels' share of the step, time by kind,
    top kernels.
15. ``train_llama``: Llama 125M, B 2 x T 2048, 2 warm-up and 5 timed steps.
16. ``train_gpt2_moe``: GPT-2 125M's width with 4 Switch experts, B 6 x
    T 1024, 2 warm-up and 5 timed steps; ``train_gpt2_moe_profile``, one
    step under the profiler; ``train_gpt2_moe_layer``, one layer's MoE
    FFN against the dense FFN (device time) and the MoE's share of the
    step.

Every bf16 launch of ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
on the serving and training paths has to run the tensor-core design
(their ``_tc`` launch counts equal their totals; the profiled steps find
only the ``_tc`` kernels by name). Then a ``{"kernels": [...]}`` line (launches
summed over the serving, training and RL runs, and per run), the card's name
and power limit as ``nvidia-smi`` prints them, and last ``{"ok": true,
"device": {...}}``.  Exits non-zero,
printing no result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import os
import re
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
# GPT-2 125M's width with 4 Switch experts (cf 2.0, aux 0.01), GPT-2's
# batch: 2 warm-up and 5 timed steps
MOE_EXPERTS, MOE_WARMUP, MOE_WINDOWS = 4, 2, (5,)
# bench.py's serve_bert traffic (BASELINE config 5): 64 clients x 12
# requests of 128 token ids in [1, 30522), @serve.batch(max_batch_size=16)
# batches padded to 16; 3 warm-up batches first
BERT_REQUESTS, BERT_SEQ, BERT_BATCH, BERT_WARMUP, BERT_ID_HIGH = 64 * 12, 128, 16, 3, 30522


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


def device_ms(fn, calls: int = 10, warmup: int = 3, tries: int = 6, counts=None) -> float:
    """Device time of one call of ``fn`` in ms as the sum of its kernels'
    own durations under torch.profiler (user annotations excluded), over
    ``calls`` calls after a warm-up (a warm L2).  Host time between
    launches does not count: CUDA events around back-to-back calls time a
    short call at the host's pace when its host cost (Python checks,
    autograd, dispatch) exceeds its device work, and the host's speed
    differs from call to call of this script.  Every kernel, plain and
    library time this script prints is taken this way.

    Each call launches the same kernels, so a session whose kernel count
    is not a positive multiple of ``calls`` lost records (on an H100,
    sessions have come back with none, and three in a row with 0, 0 and
    9 events for 10 calls of one kernel); it is run again, up to
    ``tries`` times.  Given a list ``counts``, ``fn`` may launch a number
    of kernels that is no multiple of ``calls`` or varies (on an H100: the
    MoE's forward, 405-427 in 10 calls from session to session; the dense
    FFN's forward and backward, 237 in every session): all ``tries``
    sessions run, their counts go into ``counts``, and the session with
    the most events is taken, as a lost record can only lower the count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    varying, sessions = counts is not None, []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
        if kernels and len(kernels) % calls == 0 and not varying:
            return ms
        sessions.append((len(kernels), ms))
    if varying and max(sessions)[0]:
        counts.extend(n for n, _ in sessions)
        return max(sessions)[1]
    raise RuntimeError(f"device_ms: the profiler recorded {[n for n, _ in sessions]} device "
                       f"events for {calls} calls in {tries} sessions")


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

def sass_mma_counts(lib_path) -> dict:
    """``{kernel<dtype,D>: {"HGMMA": n, "HMMA": m}}``: the tensor-core
    instructions in each kernel of a built library, from ``cuobjdump
    -sass`` (next to ``nvcc``)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?\d+(flash_\w+?_kernel(?:_tc)?)I(\S*)", line)
        if m:  # template args: "ILi64E" (bf16 only), "I13__nv_bfloat16Li32E", "IfLi128E"
            dtype = "f32" if m.group(2).startswith("f") else "bf16"
            d = re.search(r"Li(\d+)E", m.group(2)).group(1)
            fn = f"{m.group(1)}<{dtype},{d}>"
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += bool(re.search(rf"\b{op}\.", line))
    return counts


def phase_device(build):
    t0 = time.perf_counter()
    builds = build.build([attn.KERNEL, attn.BWD_SOURCE], ptxas_verbose=True)
    for name, b in builds.items():
        print(f"--- nvcc {name}.cu ---\n{b['log']}", file=sys.stderr, flush=True)
    build_wall_s = time.perf_counter() - t0
    sass = {}
    for name in builds:
        sass.update(sass_mma_counts(build.library_path(name)))
    for kern in ("flash_fwd_kernel_tc", "flash_bwd_dq_kernel_tc", "flash_bwd_dkv_kernel_tc"):
        for d in attn._TC_HEAD_DIMS:
            check(sass.get(f"{kern}<bf16,{d}>", {}).get("HGMMA", 0) > 0,
                  f"{kern}<{d}> has no HGMMA instruction: {sass}")
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s={n: b["seconds"] for n, b in builds.items()}, build_wall_s=build_wall_s,
         sass_tensor_core_instructions=sass)


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


# the design each kernel runs at the main paths' bf16, D 64 inputs
DESIGN = {"flash_fwd": "flash_fwd_kernel_tc: wgmma tensor cores, cp.async K/V ring",
          "flash_bwd_dq": "flash_bwd_dq_kernel_tc: wgmma tensor cores, cp.async K/V ring",
          "flash_bwd_dkv": "flash_bwd_dkv_kernel_tc: wgmma tensor cores on the transposed "
                           "scores, cp.async Q/dO ring"}

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


# bf16 cases at the edges of the tensor-core design (D 64 and 128): ragged
# tiles, the causal diagonal at the bottom right with Tq < Tk, one query
# row, and (a 9th field) the fused projection's strided layout
TC_EDGE_CASES = [(2, 3, 97, 131, 64, True, torch.bfloat16), (2, 3, 97, 131, 128, True, torch.bfloat16),
                 (2, 3, 128, 256, 64, True, torch.bfloat16), (2, 3, 1, 77, 64, True, torch.bfloat16),
                 (2, 4, 150, 150, 64, True, torch.bfloat16, "fused"),
                 # non-causal (BERT): ragged at D 64, and the fused layout
                 (2, 3, 97, 131, 64, False, torch.bfloat16),
                 (2, 4, 150, 150, 64, False, torch.bfloat16, "fused")]

# BERT-base's attention (non-causal, bf16, D 64, q/k/v views of one fused
# projection): serve_bert's 16 x 128 batch, and a 4 x 512 one at the
# model's longest sequence
BERT_ATTN_SHAPES = {"serve_bert 16x128": (16, 12, 128, 64), "bert 4x512": (4, 12, 512, 64)}


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
    cases += TC_EDGE_CASES
    results = []
    for i, (b, h, tq, tk, d, causal, dtype, *fused) in enumerate(cases):
        if fused:  # head-split views of one fused bf16 projection (tq == tk)
            q, k, v, _ = _model_qkv(b, h, h, tq, d, seed=i)
        else:
            q, k, v = _qkv(b, h, tq, tk, d, dtype, seed=i)
        build.reset_launches()
        out, lse = attn.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        tc = int(attn.uses_tensor_cores(dtype, d))
        launched = (build.launches.get(attn.KERNEL, 0), build.launches.get(attn.FWD_TC, 0))
        check(launched == (1, tc), f"flash_fwd launches (all, tensor-core) {launched}, want (1, {tc})")
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, causal)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        diff = (out.float() - ref_out.float()).abs()
        err_out = diff.max().item()
        excess = (diff - (tol + tol * ref_out.float().abs())).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        shape = f"{b}x{h}x{tq}x{tk}x{d}" + (", fused qkv" if fused else "")
        check(bool(torch.isfinite(out).all()), f"flash_fwd non-finite output at {shape}")
        check(excess <= 0, f"flash_fwd out disagrees at {shape} {dtype}: max err {err_out}")
        check(err_lse <= 1e-4, f"flash_fwd lse disagrees at {shape} {dtype}: max err {err_lse}")
        results.append({"shape": shape, "causal": causal, "dtype": str(dtype).split(".")[-1],
                        "design": "tensor cores" if tc else "CUDA cores",
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
            "replaces": "ray_tpu/ops/attention.py:161", "design": DESIGN[attn.KERNEL],
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
    # BERT's shapes, non-causal: the serving path of bert runs it 12 times a
    # batch
    main["at_bert_shapes"] = {}
    for i, (name, (b, h, t, d)) in enumerate(BERT_ATTN_SHAPES.items()):
        q, k, v, _ = _model_qkv(b, h, h, t, d, seed=111 + i)
        build.reset_launches()
        out, lse = attn.flash_attention(q, k, v, False)
        torch.cuda.synchronize()
        check(build.launches.get(attn.FWD_TC, 0) == 1, f"flash_fwd at {name}: not on the tensor cores")
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, False)
        err, excess = _excess(out, ref_out, 1e-2)
        err_lse = (lse - ref_lse).abs().max().item()
        check(excess <= 0 and err_lse <= 1e-4,
              f"flash_fwd non-causal at {name}: max err {err}, lse {err_lse}")
        timed = {"kernel": device_ms(lambda: attn.flash_attention(q, k, v, False)),
                 "plain": device_ms(lambda: attn.flash_attention_reference(q, k, v, False)),
                 "library": device_ms(lambda: sdpa(q, k, v, is_causal=False))}
        t_bound, t_by = flash_bound_ms(attn.KERNEL, b, h, t, t, d, False)
        main["at_bert_shapes"][name] = {
            "shape": f"{b}x{h}x{t}x{t}x{d} bf16 non-causal, fused qkv views",
            "max_abs_err": err, "max_abs_err_lse": err_lse, "ms": timed["kernel"],
            "plain_ms": timed["plain"], "bound_ms": t_bound, "bound_by": t_by,
            "library_ms": timed["library"]}
    emit("kernels", cases=results, main_shape="16x12x128x128x64 bf16 causal",
         tolerance={"f32_out": "1e-5 + 1e-5|ref|", "bf16_out": "1e-2 + 1e-2|ref|",
                    "bf16_out_train_shapes": "2e-2 (one bf16 ulp below |out| 4)",
                    "bf16_out_bert_shapes": "1e-2 + 1e-2|ref|",
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
    cases += [(*c[:7], c[1] if len(c) > 7 else None) for c in TC_EDGE_CASES]  # fused: KV = H
    rows = {}
    for i, case in enumerate(cases):
        b_, h_, tq, tk, d_, causal, dtype, kv_ = case
        args = _bwd_inputs(b_, h_, tq, tk, d_, causal, dtype, seed=200 + i, kv=kv_)
        build.reset_launches()
        dq = attn.flash_bwd_dq(*args, causal)
        dk, dv = attn.flash_bwd_dkv(*args, causal)
        torch.cuda.synchronize()
        tc = int(attn.uses_tensor_cores(dtype, d_))
        want = {attn.DQ_KERNEL: 1, attn.DQ_TC: tc, attn.DKV_KERNEL: 1, attn.DKV_TC: tc}
        launches = {n: build.launches.get(n, 0) for n in want}
        check(launches == want, f"backward launches {launches}, want {want}")
        check(torch.equal(dq, attn.flash_bwd_dq(*args, causal)),
              f"flash_bwd_dq gave other bits on a second call at {case}")
        dk2, dv2 = attn.flash_bwd_dkv(*args, causal)
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash_bwd_dkv gave other bits on a second call at {case}")
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
               "tolerance": f"{tol} + {tol}|ref|", "max_abs_err": errs, "launches": launches,
               "dq_dk_dv_bit_identical_on_a_second_call": True}
        for kern, plain, err in ((attn.DQ_KERNEL, "plain_dq", errs["dq"]),
                                 (attn.DKV_KERNEL, "plain_dkv", max(errs["dk"], errs["dv"]))):
            bound_ms, bound_by = flash_bound_ms(kern, b_, h_, tq, tk, d_, causal, dtype)
            row[kern] = {"kernel_ms": timed[kern], "plain_ms": timed[plain],
                         "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            if main:
                rows[kern] = {"name": kern, "route": "cuda", "design": DESIGN[kern],
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
    TF32 off.  Tiny GPT-2, Llama and GPT-2 with 4 Switch experts: 5 train
    steps of
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
    moe_tiny = lambda **kw: gpt2.GPT2Config.tiny(n_experts=MOE_EXPERTS, **kw)
    for name, mod, cfg_fn in (("gpt2_tiny", gpt2, gpt2.GPT2Config.tiny),
                              ("llama_tiny", llama, llama.LlamaConfig.tiny),
                              ("gpt2_moe_tiny", gpt2, moe_tiny)):
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


def train(family: str, cfg, batch_size: int, warmup: int, windows, phase: str = None):
    """The training path through the port's entry points: ``init_state``,
    ``make_optimizer(lr=3e-4)``, ``make_train_step``; ``warmup`` steps,
    then timed windows of steps (host clock, each ending in a loss read).
    Launch counts are set to 0 just before the first step and read just
    after the last.  Emits ``phase`` (``train_<family>`` when None)."""
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
    tc = {c: launches.get(c, 0) for c in attn.TENSOR_CORE_COUNTER.values()}
    check(tc == {c: launches[k] for k, c in attn.TENSOR_CORE_COUNTER.items()},
          f"{family}: tensor-core launches {tc} of {launches}: every bf16 one should be")
    tokens = batch_size * cfg.max_seq_len
    tok_s = sorted(tokens / (ms / 1e3) for ms in ms_per_step)
    n_params = mod.num_params(state["params"])
    fpt = flops.model_flops_per_token(cfg, n_params)
    kind = torch.cuda.get_device_name(0)
    experts = (f", {cfg.n_experts} experts (cf {cfg.capacity_factor}, aux "
               f"{cfg.moe_aux_weight})" if getattr(cfg, "n_experts", 0) else "")
    row = {"model": f"{family} 125M{experts} bf16 (f32 master weights), remat {cfg.remat_policy}",
           "params": n_params, "batch": batch_size, "seq_len": cfg.max_seq_len,
           "steps": n_steps, "warmup_steps": warmup, "windows": list(windows),
           "setup_s": setup_s, "warmup_s": warmup_s, "ms_per_step_by_window": ms_per_step,
           "tokens_per_s_median": tok_s[len(tok_s) // 2], "tokens_per_s_best": tok_s[-1],
           "flops_per_token": fpt, "peak_flops": flops.peak_flops(kind),
           "mfu_median": flops.mfu(tok_s[len(tok_s) // 2], fpt, kind),
           "mfu_best": flops.mfu(tok_s[-1], fpt, kind),
           "peak_mem_bytes": peak, "first_loss": first_loss, "window_last_losses": losses,
           "launches": launches, "launches_per_step": per_step}
    emit(phase or f"train_{family}", **row)
    return state, step, batch, launches, row


# the device work of a step by kind, matched on the kernel's name in order
_KINDS = (("flash attention", ("flash_fwd_kernel", "flash_bwd_")),
          ("matrix products", ("nvjet", "gemm", "cutlass", "xmma")),
          ("indexing and scans (MoE routing, embeddings)",
           ("index", "Index", "gather", "scatter", "scan", "embedding")),
          ("optimizer (foreach)", ("multi_tensor_apply",)),
          ("reductions", ("reduce_kernel",)),
          ("copies and casts", ("copy", "Memcpy", "Memset")),
          ("elementwise", ("elementwise",)))


def phase_train_profile(state, step, batch, ms_per_step, phase="train_profile",
                        model="gpt2 125M bf16, B 6 x T 1024, remat dots"):
    """Where one training step's device time goes.  Device wall per step
    from CUDA events around 3 unprofiled steps; then one step under
    torch.profiler: kernel time (user annotations excluded, they overlap
    the kernels), the three flash kernels' time and share, the time by
    kind of kernel, and the top kernels.  The profiler slows the host, so
    the idle share is taken against the unprofiled device wall; the
    profiled step's own wall is printed beside it.  Returns the step's
    device work in ms."""
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
    check(bool(dev_events), f"{phase}: the profiler saw no device time")
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    flash = {}
    for kern in (attn.KERNEL, attn.DQ_KERNEL, attn.DKV_KERNEL):
        hits = [(n, c, us) for n, (c, us) in by_name.items() if f"{kern}_kernel" in n]
        flash[kern] = {"launches": sum(c for _, c, _ in hits),
                       "tensor_core_launches": sum(c for n, c, _ in hits if f"{kern}_kernel_tc" in n),
                       "device_ms": sum(us for _, _, us in hits) / 1e3}
        flash[kern]["share_of_step"] = flash[kern]["device_ms"] / wall_ms
    for kern in flash:
        check(flash[kern]["launches"] > 0
              and flash[kern]["tensor_core_launches"] == flash[kern]["launches"],
              f"{phase}: {kern} ran other kernels than the tensor-core design: {flash}")
    kinds = {}
    for n, (c, us) in by_name.items():
        kind = next((k for k, keys in _KINDS if any(key in n for key in keys)), "other")
        kc, kms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (kc + c, kms + us / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    emit(phase, model=model, step_device_wall_ms=wall_ms, host_ms_per_step=ms_per_step,
         profiled_step_device_wall_ms=profiled_ms, device_busy_ms=busy_ms,
         busy_share=busy_ms / wall_ms, idle_share=1 - busy_ms / wall_ms,
         kernels_in_step=len(dev_events), flash=flash,
         flash_share_of_step=sum(f["share_of_step"] for f in flash.values()),
         by_kind=[{"kind": k, "kernels": c, "ms": ms, "share_of_step": ms / wall_ms}
                  for k, (c, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1])],
         top_kernels=[{"name": n[:100], "count": c, "ms": us / 1e3, "share_of_step": us / 1e3 / wall_ms}
                      for n, (c, us) in top],
         loss=m["loss"].item())
    return busy_ms


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
    check(launches.get(attn.FWD_TC, 0) == flash,
          f"{family}: {launches.get(attn.FWD_TC, 0)} of {flash} prefill launches on the tensor cores")
    lats = [done_at[i] - t_start for i in range(N_REQUESTS)]
    ms = lambda s: None if s is None else s * 1e3
    row = {
        "model": f"{family} 125M bf16", "params": num_params(params),
        "requests": N_REQUESTS, "new_tokens_per_req": NEW_TOKENS, "setup_s": setup_s,
        "wall_s": wall, "tokens_per_s": sum(len(o) for o in outs) / wall,
        "req_p50_ms": pct(lats, 0.5) * 1e3, "req_p99_ms": pct(lats, 0.99) * 1e3,
        "ttft_p50_ms": ms(perf["ttft"]["p50_s"]), "ttft_p99_ms": ms(perf["ttft"]["p99_s"]),
        "itl_p50_ms": ms(perf["itl"]["p50_s"]), "itl_p99_ms": ms(perf["itl"]["p99_s"]),
        "peak_mem_bytes": peak, "flash_launches": flash,
        "flash_launches_tensor_core": launches.get(attn.FWD_TC, 0), "admissions": stats["prefills"],
        "ticks": perf["ticks"], "decode_tick_baseline_ms": ms(perf["decode_tick_baseline_s"]),
        "interference_frac": perf["interference_frac"], **{k: v for k, v in SERVE.items()
                                                          if k != "prefill_buckets"},
    }
    emit(f"serve_{family}", **row)
    return launches, params, cfg


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


def phase_bert_parity():
    """Tiny BERT, and BERT-base's width with two layers, in f32 (TF32 off):
    the same weights and tokens on the CPU and on the card, with and
    without token types.  The logits agree within 1e-4 (post-LN keeps
    them small: the pooler's tanh, then a 0.02-scale classifier) and the
    argmax labels are equal.  The card runs the non-causal CUDA-core
    forward (f32), once per layer per call."""
    from ray_tpu_torch.models import bert

    rows, atol = [], 1e-4
    rng = np.random.default_rng(3)
    for name, cfg in (("bert_tiny", bert.BertConfig.tiny(dtype=torch.float32)),
                      ("bert_base_2layers", bert.BertConfig.base(n_layers=2, dtype=torch.float32))):
        params = bert.init(cfg, torch.Generator().manual_seed(4), device="cpu")
        toks = rng.integers(0, cfg.vocab_size, (4, 96))
        types = rng.integers(0, cfg.type_vocab_size, (4, 96))
        bert.check_tokens(toks, cfg, types)
        out = {}
        for dev, p in (("cpu", params), ("cuda", _to(params, "cuda"))):
            build.reset_launches()
            with torch.inference_mode():
                for with_types in (False, True):
                    tt = torch.from_numpy(types).to(dev) if with_types else None
                    out[dev, with_types] = bert.apply(p, torch.from_numpy(toks).to(dev), cfg,
                                                      tt).cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                check(build.launches.get(attn.KERNEL, 0) == 2 * cfg.n_layers,
                      f"{name}: {dict(build.launches)} flash launches, want {2 * cfg.n_layers}")
        errs = {}
        for with_types in (False, True):
            cpu, card = out["cpu", with_types], out["cuda", with_types]
            check(bool(torch.isfinite(card).all()), f"{name}: non-finite logits on the card")
            errs[with_types] = (card - cpu).abs().max().item()
            check(errs[with_types] <= atol, f"{name}: logits differ by {errs[with_types]}")
            check(torch.equal(card.argmax(-1), cpu.argmax(-1)), f"{name}: labels differ")
        rows.append({"model": name, "batch": "4 x 96", "atol": atol,
                     "logits_max_abs_err": errs[False],
                     "logits_max_abs_err_with_token_types": errs[True], "labels_equal": True})
    emit("bert_parity", models=rows)


def serve_bert():
    """BASELINE config 5's replica body (``bench.py`` ``run_serve_bench``'s
    ``Bert``) without the Serve runtime: BERT-base at full width in bf16,
    random weights from seed 0, loaded as a user would,
    ``Checkpoint.from_dict`` -> ``to_directory`` -> ``from_directory`` ->
    ``TorchPredictor.from_checkpoint``.  The blocks are cast to bf16 once
    before the checkpoint is written (``serve/llm.py``'s ``_cast_params``);
    the embeddings, their norm, the pooler and the classifier stay f32, as
    ``bert.apply`` reads them.  Traffic: ``BERT_REQUESTS`` sequences of
    ``BERT_SEQ`` ids in batches of ``BERT_BATCH`` (a short batch padded
    with zeros), each batch checked on the host, predicted, labels read
    back; ``BERT_WARMUP`` batches first.  Launch counts are set to 0 just
    before the batches and read just after: ``flash_fwd`` runs once per
    layer per batch, on the tensor cores.  Then one batch under
    torch.profiler (device work, kernels per batch, idle share against
    the median batch's host wall), and batch 0's logits against the same
    weights in f32 on the card (CUDA-core attention), within 5e-2 (bf16
    through 12 blocks), with equal labels wherever the f32 logits' margin
    exceeds twice that."""
    import dataclasses
    import tempfile

    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train import TorchPredictor

    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    served = dict(params, blocks={k: v.to(cfg.dtype) for k, v in params["blocks"].items()})
    with tempfile.TemporaryDirectory() as tmp:
        path = Checkpoint.from_dict({"params": served}).to_directory(os.path.join(tmp, "bert"))
        ckpt_bytes = sum(e.stat().st_size for e in os.scandir(path))
        pred = TorchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                              lambda p, toks: bert.apply(p, toks, cfg),
                                              device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def replica(toks):  # bench.py's Bert.__call__
        n = len(toks)
        if n < BERT_BATCH:  # one static batch shape for every arrival pattern
            toks = np.concatenate([toks, np.zeros((BERT_BATCH - n, toks.shape[1]), toks.dtype)])
        bert.check_tokens(toks, cfg)
        logits = pred.predict(toks)
        return logits[:n].argmax(-1), logits[:n]

    requests = np.random.default_rng(0).integers(1, BERT_ID_HIGH, (BERT_REQUESTS, BERT_SEQ))
    batches = [requests[i:i + BERT_BATCH] for i in range(0, BERT_REQUESTS, BERT_BATCH)]
    for b in batches[:BERT_WARMUP]:
        replica(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, labels, logits = [], [], []
    build.reset_launches()
    t_start = time.perf_counter()
    for b in batches:
        t0 = time.perf_counter()
        lab, lg = replica(b)
        lat.append(time.perf_counter() - t0)
        labels.append(lab)
        logits.append(lg)
    wall = time.perf_counter() - t_start
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * len(batches)
    got = (launches.get(attn.KERNEL, 0), launches.get(attn.FWD_TC, 0))
    check(got == (want, want), f"serve_bert: flash_fwd launches (all, tensor-core) {got}, "
                               f"want {want} each")
    logits = np.concatenate(logits)
    check(logits.shape == (BERT_REQUESTS, cfg.num_classes) and bool(np.isfinite(logits).all()),
          f"serve_bert: logits of shape {logits.shape}, finite {np.isfinite(logits).all()}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        replica(batches[0])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    check(bool(dev_events), "serve_bert: the profiler saw no device time")
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    flash_ms = sum(us for n, (_, us) in by_name.items() if "flash_fwd_kernel" in n) / 1e3

    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.inference_mode():
        ref = bert.apply(_to(params, "cuda"), torch.from_numpy(batches[0]).cuda(), ref_cfg).cpu().numpy()
    tol = 5e-2
    err = float(np.abs(logits[:BERT_BATCH] - ref).max())
    check(err <= tol, f"serve_bert: bf16 logits differ from f32 by {err}")
    sure = np.abs(ref[:, 0] - ref[:, 1]) > 2 * tol
    check(bool((labels[0][sure] == ref.argmax(-1)[sure]).all()),
          "serve_bert: a bf16 label differs from f32 where the margin is clear")
    p50 = pct(lat, 0.5) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit("serve_bert", model="bert-base bf16 (blocks bf16; embeddings, pooler, classifier f32)",
         params=num_params(params), checkpoint_bytes=ckpt_bytes, load_s=load_s,
         requests=BERT_REQUESTS, seq_len=BERT_SEQ, batch=BERT_BATCH, batches=len(batches),
         warmup_batches=BERT_WARMUP, wall_s=wall, sequences_per_s=BERT_REQUESTS / wall,
         batch_p50_ms=p50, batch_p99_ms=pct(lat, 0.99) * 1e3, batch_max_ms=max(lat) * 1e3,
         device_ms_per_batch=busy_ms, kernels_per_batch=len(dev_events),
         flash_ms_per_batch=flash_ms, idle_share_vs_p50=1 - busy_ms / p50,
         peak_mem_bytes=peak, launches=launches, flash_launches_per_batch=want / len(batches),
         label_counts=np.bincount(np.concatenate(labels), minlength=cfg.num_classes).tolist(),
         batch0_logits_max_abs_err_vs_f32=err, tolerance_vs_f32=tol,
         batch0_labels_checked=int(sure.sum()),
         top_kernels=[{"name": n[:100], "count": c, "ms": us / 1e3} for n, (c, us) in top])
    return launches


def moe_layer_ms(cfg, b: int, t: int) -> dict:
    """The device time of one layer's FFN at a train step's shape, as the
    step runs it (f32 master weights cast to bf16 inside, the router f32):
    the Switch MoE and, beside it, the dense FFN of the same width;
    forward, and forward with backward (``device_ms``, each session's
    kernel count beside it)."""
    from ray_tpu_torch.ops import moe

    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator().manual_seed(5)
    mp = {k: v[0].clone().requires_grad_(True)
          for k, v in moe.init_moe_params(g, 1, D, Fd, E, device="cuda").items()}
    dp = {"w1": (torch.randn(D, Fd, generator=g) * 0.02).cuda().requires_grad_(True),
          "b1": torch.zeros(Fd, device="cuda", requires_grad=True),
          "w2": (torch.randn(Fd, D, generator=g) * 0.02).cuda().requires_grad_(True),
          "b2": torch.zeros(D, device="cuda", requires_grad=True)}
    x = torch.randn(b, t, D, device="cuda").to(cfg.dtype).requires_grad_(True)
    dy = torch.randn(b, t, D, device="cuda").to(cfg.dtype)
    c = lambda w: w.to(cfg.dtype)

    def moe_fwd():
        return moe.moe_ffn(x, mp["router"], c(mp["ew1"]), c(mp["eb1"]), c(mp["ew2"]),
                           c(mp["eb2"]), capacity_factor=cfg.capacity_factor)

    def dense_fwd():
        h = torch.nn.functional.gelu(x @ c(dp["w1"]) + c(dp["b1"]), approximate="tanh")
        return h @ c(dp["w2"]) + c(dp["b2"])

    def moe_fwd_bwd():
        y, aux = moe_fwd()
        torch.autograd.grad((y, aux), [x, *mp.values()], (dy, torch.ones_like(aux)))

    def dense_fwd_bwd():
        torch.autograd.grad(dense_fwd(), [x, *dp.values()], dy)

    fns = {"moe_fwd": moe_fwd, "moe_fwd_bwd": moe_fwd_bwd, "dense_fwd": dense_fwd,
           "dense_fwd_bwd": dense_fwd_bwd}
    counts = {name: [] for name in fns}
    out = {f"{name}_ms": device_ms(fn, counts=counts[name]) for name, fn in fns.items()}
    return {**out, "kernels_in_10_calls_by_session": counts}


def phase_mlp():
    """BASELINE config 2's MLP (784-512-256-10) in f32, TF32 off: the same
    weights and batch on the CPU and on the card.  The loss within 1e-5,
    every gradient leaf within 1e-4 of its largest entry, accuracy equal;
    then ``TorchPredictor`` labels of 10,000 synthetic inputs on the card
    equal the CPU's."""
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.train import TorchPredictor

    cfg = mlp.MLPConfig()
    params = mlp.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, cfg.in_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 256)
    res = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, copy=True).requires_grad_(True) for k, v in params.items()}
        batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
        loss = mlp.loss_fn(p, batch, cfg)
        loss.backward()
        res[dev] = (loss.item(), {k: t.grad.cpu() for k, t in p.items()},
                    mlp.accuracy(p, batch, cfg).item())
    loss_err = abs(res["cpu"][0] - res["cuda"][0])
    check(loss_err <= 1e-5, f"mlp: loss differs by {loss_err}")
    worst = max((res["cuda"][1][k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for k, g in res["cpu"][1].items())
    check(worst <= 1e-4, f"mlp: a gradient differs by {worst} of its largest entry")
    check(res["cpu"][2] == res["cuda"][2], f"mlp: accuracy {res['cpu'][2]} vs {res['cuda'][2]}")
    images = rng.standard_normal((10_000, cfg.in_dim)).astype(np.float32)
    apply = lambda p, xb: mlp.apply(p, xb, cfg)
    labels = {dev: TorchPredictor(params, apply, device=dev).predict(images).argmax(-1)
              for dev in ("cpu", "cuda")}
    check(bool((labels["cpu"] == labels["cuda"]).all()), "mlp: predictor labels differ")
    emit("mlp", model="mlp 784-512-256-10 f32", batch=256, loss_cpu=res["cpu"][0],
         loss_cuda=res["cuda"][0], loss_abs_err=loss_err, grad_max_err_over_leaf_max=worst,
         accuracy=res["cuda"][2], predictor_inputs=len(images), predictor_labels_equal=True,
         label_counts=np.bincount(labels["cuda"], minlength=cfg.num_classes).tolist())


# BASELINE config 4 as bench.py runs it on a chip (run_rl_bench): PPO on
# SyntheticAtariEnv(episode_len=400), 64 envs a worker, fragments of 16,
# a train batch of 4 workers' fragments (4,096 env steps), minibatches of
# 256, 4 SGD epochs, fcnet_hiddens (256,), entropy 0.01, seed 0; 1 warm-up
# iteration, then 3 timed.  The port has no runtime: one local worker
# samples the 4 fragments in turn.
RL_OBS, RL_ACTIONS, RL_HIDDENS = (84, 84, 4), 6, (256,)
RL_ENVS, RL_FRAGMENT, RL_FRAGMENTS = 64, 16, 4
RL_MINIBATCH, RL_SGD_ITERS, RL_WARMUP, RL_ITERS = 256, 4, 1, 3
# rl_parity's tolerances, CPU against card in f32 (TF32 off): forwards,
# losses and TD targets absolute; gradients of each leaf's largest entry;
# weights after one update absolute, a tenth of one Adam step (lr 3e-4)
RL_TOL = {"forward": 1e-4, "loss": 1e-4, "grad": 1e-3, "weights": 3e-5}


def _ppo_columns(rng, n):
    """PPO's train columns over ``n`` random frames (numpy default_rng)."""
    from ray_tpu_torch.rllib import SampleBatch

    return {SampleBatch.OBS: rng.integers(0, 256, (n, *RL_OBS), dtype=np.uint8),
            SampleBatch.ACTIONS: rng.integers(0, RL_ACTIONS, n),
            SampleBatch.ACTION_LOGP: (np.log(1 / RL_ACTIONS)
                                      + rng.normal(0, 0.2, n)).astype(np.float32),
            SampleBatch.ADVANTAGES: rng.normal(0.3, 1.5, n).astype(np.float32),
            SampleBatch.VALUE_TARGETS: rng.normal(0, 1.5, n).astype(np.float32)}


def _tree_err(a, b) -> float:
    """The largest absolute difference between two trees of arrays."""
    from ray_tpu_torch.util.tree import tree_map

    errs = []
    tree_map(lambda x, y: errs.append(float(np.abs(np.asarray(x) - y).max())), a, b)
    return max(errs)


def phase_rl_parity():
    """The RL learner stack with the same weights on the CPU and on the
    card, f32 with TF32 off for matmul and cuDNN: the Nature-CNN
    actor-critic (84 x 84 x 4 uint8, hiddens (256,), 6 actions) logits and
    values; the PPO, A2C, IMPALA and DQN losses, their metrics and every
    gradient leaf; one ``TorchPolicy.learn_on_minibatch`` (weights after
    it); ``DQNPolicy.compute_td_targets``; one ``SACPolicy`` update at its
    default (64, 64) with the same noise on both devices; and, on the card,
    the log-prob of drawn actions against ``action_logp``.  Tolerances:
    ``RL_TOL``."""
    from ray_tpu_torch.rllib import (DQNPolicy, SACPolicy, SampleBatch, TorchPolicy, a2c, dqn,
                                     impala, ppo)
    from ray_tpu_torch.rllib.models import apply_model
    from ray_tpu_torch.rllib.policy import to_device
    from ray_tpu_torch.util.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n, devs = 64, ("cpu", "cuda")
    cols = _ppo_columns(rng, n)
    kw = dict(hiddens=RL_HIDDENS, obs_shape=RL_OBS, lr=3e-4, seed=0,
              loss_fn=ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01))
    pol = {dev: TorchPolicy(int(np.prod(RL_OBS)), RL_ACTIONS, device=dev, **kw) for dev in devs}
    pol["cuda"].set_weights(pol["cpu"].get_weights())
    errs = {}
    with torch.no_grad():
        fwd = {dev: [t.cpu() for t in apply_model(p.params, to_device(cols[SampleBatch.OBS], dev))]
               for dev, p in pol.items()}
    errs["logits"], errs["values"] = [(c - g).abs().max().item()
                                      for c, g in zip(fwd["cpu"], fwd["cuda"])]
    check(max(errs["logits"], errs["values"]) <= RL_TOL["forward"], f"rl_parity: forward {errs}")
    losses = {"ppo": ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), "a2c": a2c.make_a2c_loss(0.5, 0.01),
              "impala": impala.make_impala_loss(0.5, 0.01), "dqn": dqn.make_dqn_loss()}
    for name, loss in losses.items():
        res = {}
        for dev, p in pol.items():
            p.optimizer.zero_grad(set_to_none=True)
            total, metrics = loss(p.module, p.params, {k: to_device(v, dev) for k, v in cols.items()})
            total.backward()
            res[dev] = ({"total": total.item(), **{k: v.item() for k, v in metrics.items()}},
                        [t.grad.cpu() if t.grad is not None else torch.zeros(t.shape)
                         for t in tree_leaves(p.params)])
        errs[f"{name}_loss"] = max(abs(res["cpu"][0][k] - res["cuda"][0][k]) for k in res["cpu"][0])
        errs[f"{name}_grad_over_leaf_max"] = max(
            (g - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
            for c, g in zip(res["cpu"][1], res["cuda"][1]))
        check(errs[f"{name}_loss"] <= RL_TOL["loss"]
              and errs[f"{name}_grad_over_leaf_max"] <= RL_TOL["grad"], f"rl_parity {name}: {errs}")
    learn = {dev: p.learn_on_minibatch(cols) for dev, p in pol.items()}
    errs["learn_metrics"] = max(abs(learn["cpu"][k] - learn["cuda"][k]) for k in learn["cpu"])
    errs["weights_after_update"] = _tree_err(pol["cuda"].get_weights(), pol["cpu"].get_weights())
    check(errs["learn_metrics"] <= RL_TOL["loss"]
          and errs["weights_after_update"] <= RL_TOL["weights"], f"rl_parity learn: {errs}")
    a, logp, _ = pol["cuda"].compute_actions(cols[SampleBatch.OBS])
    errs["sampled_logp"] = float(np.abs(logp - pol["cuda"].action_logp(cols[SampleBatch.OBS], a)).max())
    check(a.dtype == np.int64 and 0 <= a.min() and a.max() < RL_ACTIONS
          and errs["sampled_logp"] <= RL_TOL["forward"], f"rl_parity: sampled actions {errs}")

    q = {dev: DQNPolicy(int(np.prod(RL_OBS)), RL_ACTIONS, hiddens=RL_HIDDENS, obs_shape=RL_OBS,
                        seed=0, device=dev) for dev in devs}
    q["cuda"].set_weights(q["cpu"].get_weights())
    q["cuda"].update_target()
    mb = SampleBatch({SampleBatch.NEXT_OBS: cols[SampleBatch.OBS],
                      SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
                      SampleBatch.TERMINATEDS: rng.random(n) < 0.2})
    td = {dev: p.compute_td_targets(mb, 0.99) for dev, p in q.items()}
    errs["dqn_td_targets"] = float(np.abs(td["cpu"] - td["cuda"]).max())
    check(errs["dqn_td_targets"] <= RL_TOL["forward"], f"rl_parity dqn: {errs}")

    obs_dim, act_dim, b = 17, 6, 256  # HalfCheetah's shapes, SACConfig's batch
    sac = {dev: SACPolicy(obs_dim, act_dim, seed=0, device=dev) for dev in devs}
    sac["cuda"].set_state(sac["cpu"].get_state())
    batch = {SampleBatch.OBS: rng.standard_normal((b, obs_dim)).astype(np.float32),
             SampleBatch.ACTIONS: rng.uniform(-1, 1, (b, act_dim)).astype(np.float32),
             SampleBatch.REWARDS: rng.normal(size=b).astype(np.float32),
             SampleBatch.TERMINATEDS: rng.random(b) < 0.1,
             SampleBatch.NEXT_OBS: rng.standard_normal((b, obs_dim)).astype(np.float32)}
    noise = tuple(rng.standard_normal((b, act_dim)).astype(np.float32) for _ in range(2))
    upd = {dev: p.learn_on_minibatch(batch, noise=noise) for dev, p in sac.items()}
    errs["sac_metrics"] = max(abs(upd["cpu"][k] - upd["cuda"][k]) for k in upd["cpu"])
    errs["sac_weights_after_update"] = _tree_err(sac["cuda"].get_weights(), sac["cpu"].get_weights())
    errs["sac_target_q"] = _tree_err(sac["cuda"].get_state()["target_q"],
                                     sac["cpu"].get_state()["target_q"])
    check(errs["sac_metrics"] <= RL_TOL["loss"]
          and max(errs["sac_weights_after_update"], errs["sac_target_q"]) <= RL_TOL["weights"],
          f"rl_parity sac: {errs}")
    emit("rl_parity", model=f"nature-cnn actor-critic {RL_OBS} uint8, hiddens {RL_HIDDENS}, "
         f"{RL_ACTIONS} actions, batch {n}; SAC ({obs_dim}, {act_dim}) hiddens (64, 64), batch {b}",
         params=sum(t.numel() for t in tree_leaves(pol["cuda"].params)),
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         tolerances=RL_TOL, max_abs_err=errs)


def profile_call(fn, reps: int = 20, top_n: int = 8) -> dict:
    """One call of ``fn`` (which reads its result back): its host wall
    (median of ``reps`` calls, each ending in a synchronize), then one
    call under torch.profiler: device work (kernels and copies, user
    annotations excluded), kernel and copy counts, the idle share of the
    median wall, and the ``top_n`` kernels by device time."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    check(bool(dev), "profile_call: the profiler saw no device time")
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    wall = pct(walls, 0.5)
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    return {"host_wall_ms_p50": wall, "host_wall_ms_min": min(walls), "device_ms": busy,
            "kernels": len(dev) - len(copies), "copies": len(copies),
            "copy_ms": sum(e.time_range.elapsed_us() for e in copies) / 1e3,
            "idle_share": 1 - busy / wall,
            "top_kernels": [{"name": n[:100], "count": c, "ms": us / 1e3} for n, (c, us) in top]}


def phase_rl_ppo_atari():
    """BASELINE config 4's main path on the card: a ``RolloutWorker`` on
    ``SyntheticAtariEnv`` with a ``TorchPolicy`` carrying PPO's loss
    (``PPOConfig``'s defaults, entropy 0.01), sampling 4 fragments of 64
    envs x 16 steps in turn, then ``train_one_step`` (4 epochs of 256-row
    minibatches); 1 warm-up and 3 timed iterations.  Launch counts are set
    to 0 just before the first iteration and read just after the last.
    Prints env-steps/s, each iteration's seconds split into sample (env
    steps, inference, connectors), GAE and learn, one SGD minibatch and one
    64-observation ``compute_actions`` under the profiler, peak memory and
    the mean loss terms."""
    from ray_tpu_torch.rllib import RolloutWorker, SampleBatch, ppo, synthetic_atari_creator
    from ray_tpu_torch.rllib import train_one_step
    from ray_tpu_torch.rllib.policy import to_device
    from ray_tpu_torch.util.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch_size = RL_ENVS * RL_FRAGMENT * RL_FRAGMENTS
    cfg = dict(ppo.PPO_DEFAULTS, env_creator=synthetic_atari_creator,
               env_config={"episode_len": 400}, num_envs_per_worker=RL_ENVS,
               rollout_fragment_length=RL_FRAGMENT, train_batch_size=batch_size,
               sgd_minibatch_size=RL_MINIBATCH, num_sgd_iter=RL_SGD_ITERS,
               fcnet_hiddens=RL_HIDDENS, entropy_coeff=0.01, gamma=0.99, seed=0,
               _loss_factory=ppo._ppo_loss_factory)
    t0 = time.perf_counter()
    worker = RolloutWorker(cfg)  # the card: the entry point's default
    policy = worker.policy
    sgd_rng = np.random.default_rng(cfg["seed"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    iters = []
    for _ in range(RL_WARMUP + RL_ITERS):
        t0 = time.perf_counter()
        fragments, phases = [], {}
        for _ in range(RL_FRAGMENTS):
            fragments.append(worker.sample())
            for k, v in worker.last_sample_phases.items():
                phases[k] = phases.get(k, 0.0) + v
        batch = SampleBatch.concat_samples(fragments)
        t1 = time.perf_counter()
        metrics = train_one_step(policy, batch, num_sgd_iter=RL_SGD_ITERS,
                                 sgd_minibatch_size=RL_MINIBATCH, rng=sgd_rng,
                                 required_keys=ppo.PPO_KEYS)
        t2 = time.perf_counter()
        iters.append({"wall_s": t2 - t0, "sample_s": t1 - t0 - phases["postprocess_s"],
                      "gae_s": phases["postprocess_s"], "learn_s": t2 - t1,
                      "env_s": phases["env_s"], "infer_s": phases["infer_s"],
                      "connector_s": phases["connector_s"], "env_steps": batch.count,
                      "loss_terms": metrics})
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    timed = iters[RL_WARMUP:]
    wall = sum(r["wall_s"] for r in timed)
    steps = sum(r["env_steps"] for r in timed)
    check(all(r["env_steps"] == batch_size for r in iters), f"rl_ppo_atari: {iters}")
    terms = {k: float(np.mean([r["loss_terms"][k] for r in timed])) for k in timed[0]["loss_terms"]}
    check(set(terms) == {"total_loss", "policy_loss", "vf_loss", "entropy", "kl"}
          and all(np.isfinite(v) for r in iters for v in r["loss_terms"].values()),
          f"rl_ppo_atari: loss terms {[r['loss_terms'] for r in iters]}")
    tensors = tree_leaves(policy.params) + [v for st in policy.optimizer.state.values()
                                            for k, v in st.items() if k != "step"]
    check(all(t.is_cuda for t in tensors) and len(policy.optimizer.state) == 14,
          "rl_ppo_atari: a policy tensor is not on the card")
    check(not any(launches.values()), f"rl_ppo_atari: kernel launches {launches}")
    mb = {k: to_device(batch[k][:RL_MINIBATCH], policy.device) for k in ppo.PPO_KEYS}
    sgd = profile_call(lambda: policy.learn_on_minibatch(mb))
    obs = batch[SampleBatch.OBS][:RL_ENVS]
    act = profile_call(lambda: policy.compute_actions(obs))
    act["bytes_to_card"] = obs.nbytes
    act["bytes_from_card"] = 3 * RL_ENVS * 4
    emit("rl_ppo_atari",
         model=f"PPO, nature-cnn actor-critic {RL_OBS} uint8, hiddens {RL_HIDDENS}, "
               f"{RL_ACTIONS} actions, f32",
         cut=f"bench.py's {RL_FRAGMENTS} remote rollout workers are one local RolloutWorker "
             f"sampling {RL_FRAGMENTS} fragments in turn: the runtime is not ported",
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         params=sum(t.numel() for t in tree_leaves(policy.params)),
         envs=RL_ENVS, fragment=RL_FRAGMENT, fragments_per_iter=RL_FRAGMENTS,
         train_batch=batch_size, minibatch=RL_MINIBATCH, sgd_iters=RL_SGD_ITERS,
         minibatches_per_iter=RL_SGD_ITERS * (batch_size // RL_MINIBATCH),
         warmup_iters=RL_WARMUP, timed_iters=RL_ITERS, setup_s=setup_s,
         env_steps_per_s=steps / wall, wall_s=wall,
         s_per_iter={k: float(np.mean([r[k] for r in timed]))
                     for k in ("wall_s", "sample_s", "gae_s", "learn_s", "env_s", "infer_s",
                               "connector_s")},
         iters=[{k: v for k, v in r.items() if k != "loss_terms"} for r in iters],
         sgd_minibatch=sgd, compute_actions=act, peak_mem_bytes=peak,
         mean_loss_terms=terms, loss_terms_finite=True, policy_tensors_on="cuda",
         episodes_total=worker.get_metrics()["episodes_total"], launches=launches)
    return launches


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
    phase_bert_parity()
    phase_train_parity()
    phase_mlp()
    build.reset_launches()
    phase_rl_parity()
    rl_parity_launches = dict(build.launches)
    rl_launches = phase_rl_ppo_atari()
    torch.cuda.empty_cache()
    serve_gpt2, params, cfg = serve("gpt2")
    n_slots = SERVE["n_slots"] + 1
    max_len = SERVE["prefill_buckets"][-1] + NEW_TOKENS + SERVE["decode_chunk_steps"]
    phase_decode_profile(params, cfg, n_slots, max_len)
    del params
    serve_llama = serve("llama")[0]
    bert_launches = serve_bert()
    torch.cuda.empty_cache()

    from ray_tpu_torch.models import gpt2, llama
    state, step, batch, train_launches, row = train(
        "gpt2", gpt2.GPT2Config.gpt2_small(), TRAIN_BATCH, TRAIN_WARMUP, TRAIN_WINDOWS)
    phase_train_profile(state, step, batch, sorted(row["ms_per_step_by_window"])[1])
    del state, step, batch
    torch.cuda.empty_cache()
    _, _, _, llama_launches, _ = train("llama", llama.LlamaConfig.llama_125m(), LLAMA_BATCH,
                                       LLAMA_WARMUP, LLAMA_WINDOWS)
    torch.cuda.empty_cache()
    moe_cfg = gpt2.GPT2Config.gpt2_small(n_experts=MOE_EXPERTS)
    state, step, batch, moe_launches, row = train(
        "gpt2", moe_cfg, TRAIN_BATCH, MOE_WARMUP, MOE_WINDOWS, phase="train_gpt2_moe")
    busy_ms = phase_train_profile(state, step, batch, row["ms_per_step_by_window"][0],
                                  phase="train_gpt2_moe_profile",
                                  model=f"{row['model']}, B {TRAIN_BATCH} x T {moe_cfg.max_seq_len}")
    del state, step, batch
    torch.cuda.empty_cache()
    layer = moe_layer_ms(moe_cfg, TRAIN_BATCH, moe_cfg.max_seq_len)
    # under remat "dots" each layer's MoE FFN runs forward, then forward
    # again and backward (its bmm outputs are not saved); the dense FFN's
    # mm outputs are saved, so the same sum is an upper bound for it
    per_step = {k: moe_cfg.n_layers * (layer[f"{k}_fwd_bwd_ms"] + layer[f"{k}_fwd_ms"])
                for k in ("moe", "dense")}
    emit("train_gpt2_moe_layer", shape=f"B {TRAIN_BATCH} x T {moe_cfg.max_seq_len} x D "
         f"{moe_cfg.d_model}, {moe_cfg.n_experts} experts of d_ff {moe_cfg.d_ff}", **layer,
         moe_ms_per_step=per_step["moe"], dense_ffn_ms_per_step=per_step["dense"],
         moe_share_of_step_device_work=per_step["moe"] / busy_ms,
         step_device_work_ms=busy_ms)

    runs = {"serve_gpt2": serve_gpt2, "serve_llama": serve_llama, "serve_bert": bert_launches,
            "train_gpt2": train_launches, "train_llama": llama_launches,
            "train_gpt2_moe": moe_launches, "rl_parity": rl_parity_launches,
            "rl_ppo_atari": rl_launches}
    for r in (fwd, *bwd.values()):
        kern = r["name"]
        r["launches_by_path"] = {path: n.get(kern, 0) for path, n in runs.items()
                                 if kern == attn.KERNEL or path.startswith(("train", "rl_"))}
        r["launches"] = sum(r["launches_by_path"].values())
        # equal to launches: train() and serve() checked it
        tc = attn.TENSOR_CORE_COUNTER[kern]
        r["launches_tensor_core"] = sum(n.get(tc, 0) for n in runs.values())
    print(json.dumps({"kernels": [fwd, *bwd.values()]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
