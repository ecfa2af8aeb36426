"""Training cells: ``TorchTrainer`` with one worker on the card, whose
loop (the benchmark's own) builds the port's GPT-2 train step with its
AdamW recipe and runs it on batches drawn from the seed on the card.

Set-up builds the one step object and its state, and drives them through
the first three steps, on the window's own call and feed; their losses,
the first gradient's norms (from the optimizer's first moment after one
step) and the params' change after the three are what the reference is
held to.  The window then runs the same object on: steps finished in it,
the window closed by a synchronise.  The driver holds no CUDA context
until the runtime has shut down; it then runs the reference on the card.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from typing import Any, Dict

from portbench import traffic, weights
from portbench.reference import leaves

CHECKED_STEPS = 3
# the change is compared over blocks of this many contiguous elements of
# a leaf, so that a rule on the reference's gradient can leave out the
# parts of a leaf that move by round-off alone (a key's bias under the
# softmax, inside the stacked qkv bias)
BLOCK = 64


def block_norms(t):
    """The norms of ``t``'s consecutive blocks of ``BLOCK`` elements
    (the last one padded with zeros), as a float32 numpy array."""
    import torch

    flat = t.detach().float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, BLOCK).norm(dim=1).cpu().numpy()


def train_loop(conf: Dict[str, Any]) -> None:
    """The worker's loop: everything it measures goes out in one report."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import train_state
    from ray_tpu_torch.train.torch_utils import get_device

    config, cell, mix, seed = conf["config"], conf["cell"], conf["mix"], conf["seed"]
    dev = get_device(None if conf["device"] == "cuda" else conf["device"])
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = gpt2.GPT2Config(**weights.dims(config), dtype=getattr(torch, config["assumed"]["dtype"]),
                          remat=True, remat_policy=cell["remat_policy"])
    params = weights.gpt2(config, seed, dev, dtype=torch.float32)
    start = {n: t.detach().clone() for n, t in leaves(params)}
    o = cell["optimizer"]
    opt = gpt2.make_optimizer(o["lr"], o["weight_decay"], o["warmup"], o["total_steps"])
    state = train_state(params, opt)
    step = _faulty(gpt2.make_train_step(cfg, opt), conf.get("fault", ""))
    by_tensor = {id(t): n for n, t in leaves(params)}
    beta1 = o["betas"][0]

    losses, grad_norms, grad_blocks = [], None, None
    for i in range(CHECKED_STEPS):
        state, m = step(state, traffic.train_batch(mix, seed, i, dev))
        losses.append(float(m["loss"]))
        if grad_norms is None:
            adamw = state["opt_state"]["adamw"]
            first = {by_tensor[id(p)]: adamw.state[p]["exp_avg"] / (1 - beta1)
                     for g in adamw.param_groups for p in g["params"] if p in adamw.state}
            grad_norms = {n: float(g.norm()) for n, g in first.items()}
            grad_blocks = {n: block_norms(g) for n, g in first.items()}
            del first
    change = {n: block_norms(t.detach() - start[n]) for n, t in leaves(state["params"])}
    del start
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # the traced stretch is the window's last ``trace_s``, stopped once
    # the window has closed
    trace_at = conf["seconds"] - float(cell["trace_s"]) if conf["trace"] else None
    tr = untraced = None
    t_open_epoch = time.time()
    t0 = time.perf_counter()
    n, i = 0, CHECKED_STEPS
    while time.perf_counter() - t0 < conf["seconds"]:
        if trace_at is not None and tr is None and time.perf_counter() - t0 >= trace_at:
            from portbench.trace import DeviceTrace

            sync()  # the steps so far, finished: the untraced part of the window
            untraced = {"window_s": time.perf_counter() - t0, "steps": n}
            tr = DeviceTrace()
            tr.start()
        state, m = step(state, traffic.train_batch(mix, seed, i, dev))
        i += 1
        n += 1
    last_loss = float(m["loss"])  # waits for the last step
    sync()
    window_s = time.perf_counter() - t0
    trace_summary = None
    if tr is not None:
        tr.stop()
        trace_summary = tr.summary()
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if on_card:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    from portbench.harness import forbidden_modules

    session.report({"steps": n, "window_s": window_s, "t_open_epoch": t_open_epoch,
                    "losses": losses, "grad_norms": grad_norms, "grad_blocks": grad_blocks,
                    "change": change, "last_loss": last_loss, "device": device,
                    "trace": trace_summary, "untraced": untraced,
                    "held": forbidden_modules()})


def _faulty(step, fault: str):
    """A fault under the timed path, for the harness's own tests: the
    update left out (the state comes back unchanged), half of each batch
    left out and the mean taken over the rest, or a module named ``jax``
    loaded in the worker."""
    if not fault:
        return step
    if fault == "loads_jax":
        import sys
        import types

        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return step
    if fault == "state_unchanged":
        from ray_tpu_torch.models import gpt2

        gpt2.AdamW.update = staticmethod(lambda opt_state: None)
        return step
    if fault == "half_batch":
        def half(state, batch):
            return step(state, {"tokens": batch["tokens"][: batch["tokens"].shape[0] // 2]})
        return half
    raise ValueError(f"no such fault for a training cell: {fault!r}")


def run(spec: Dict[str, Any], *, seed: int, seconds: float, trace: bool,
        t_start: float) -> Dict[str, Any]:
    import ray_tpu_torch
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    device = spec.get("device", "cuda")
    conf = {"config": spec["config"], "cell": spec["cell"], "mix": spec["traffic"],
            "seed": seed, "seconds": seconds, "trace": trace, "device": device,
            "fault": spec.get("fault", "")}
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if device == "cuda" else 0)
    try:
        trainer = TorchTrainer(
            train_loop, train_loop_config=conf,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=device == "cuda"),
            run_config=RunConfig(name="portbench",
                                 storage_path=os.path.join(tempfile.gettempdir(), "portbench-train")))
        result = trainer.fit()
    finally:
        ray_tpu_torch.shutdown()
    if result.error is not None:
        raise RuntimeError(f"the training run failed: {result.error!r}")
    r = result.metrics
    d = weights.dims(spec["config"])
    mix = spec["traffic"]
    ctx = {"setup_s": r["t_open_epoch"] - t_start, "window_s": r["window_s"], "steps": r["steps"],
           "batch": int(mix["batch"]), "seq": int(mix["seq"]), "dims": d,
           "kind": r["device"]["kind"], "trace": r["trace"], "untraced": r["untraced"]}
    rec = {"attempted": r["steps"] + CHECKED_STEPS, "failed": 0, "ctx": ctx, "device": r["device"],
           "held": r["held"]}
    if trace:
        tr = r["trace"]
        rec["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        rec["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    rec["checks"] = check(spec, r, seed, device)
    return rec


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers held to the reference.

    - ``loss_gap``: the worst of the checked steps' loss gaps;
    - ``grad_norm_gap`` and ``change_norm_gap``: by the worst leaf, the gap
      between the program's norm and the reference's, over the larger of
      that leaf's reference norm and the median leaf's, for the first
      gradient and for the change over the checked steps;
    - ``grad_block_gap``: the median, over 64-element blocks of every
      leaf, of the first gradient's relative gap of block norms: where a
      leaf's norm hides a lower precision, its blocks show it.

    Blocks whose reference gradient is under a thousandth of the median
    block's move by round-off alone (Adam scales any gradient to the
    learning rate, as it does a key's bias under the softmax) and are left
    out of the change and of ``grad_block_gap``."""
    import numpy as np

    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"].values())
    grad_gap = max(abs(prog["grad_norms"].get(n, 0.0) - g) / max(g, g_med)
                   for n, g in ref["grad_norms"].items())
    block_med = float(np.median(np.concatenate(list(ref["grad_blocks"].values()))))
    keep = {n: b >= 1e-3 * block_med for n, b in ref["grad_blocks"].items()}
    norm = lambda blocks, n: float(np.sqrt(np.sum(np.square(blocks[n][keep[n]]))))
    moved = {n: norm(ref["change"], n) for n in ref["change"] if keep[n].any()}
    c_med = statistics.median(moved.values())
    change_gap = max(abs(norm(prog["change"], n) - c) / max(c, c_med) for n, c in moved.items())
    rel = [np.abs(prog["grad_blocks"][n][keep[n]] - r[keep[n]]) / r[keep[n]]
           if n in (prog.get("grad_blocks") or {}) else np.ones(int(keep[n].sum()))
           for n, r in ref["grad_blocks"].items()]
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
            "grad_block_gap": float(np.median(np.concatenate(rel)))}


def reference_readings(spec: Dict[str, Any], seed: int, device: str, quant=None,
                       half_batch: bool = False, dtype=None) -> Dict[str, Any]:
    """The reference's losses, first-gradient norms and change norms over
    the checked steps, from the same weights and batches (with
    ``half_batch``, the first half of each: the fault of that name put in
    the program's place)."""
    import torch

    from portbench import reference

    reference.no_tf32()
    dev = torch.device(device)
    params = reference.f32(weights.gpt2(spec["config"], seed, dev, dtype=torch.float32))
    start = {n: t.clone() for n, t in reference.leaves(params)}
    batches = [traffic.train_batch(spec["traffic"], seed, i, dev)["tokens"]
               for i in range(CHECKED_STEPS)]
    if half_batch:
        batches = [b[: b.shape[0] // 2] for b in batches]
    out = reference.train_steps(params, batches, weights.dims(spec["config"])["n_heads"],
                                spec["cell"]["optimizer"], int(spec["cell"]["reference_rows"]),
                                quant, dtype or torch.float32)
    change = {n: block_norms(t - start[n]) for n, t in reference.leaves(out["params"])}
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "grad_blocks": {n: block_norms(g) for n, g in out["first_grads"].items()},
            "change": change}


def check(spec, prog, seed: int, device: str) -> Dict[str, Any]:
    """The numbers the cell's limits name, each beside its limit."""
    ref = reference_readings(spec, seed, device)
    gaps = compare(prog, ref)
    limits = spec["cell"]["check"]
    return {k: {"value": gaps[k], "limit": float(v)} for k, v in limits.items()}
