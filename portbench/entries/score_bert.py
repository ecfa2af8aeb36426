"""Scoring cells: ``BatchPredictor.predict`` with the benchmark's own
``TorchPredictor`` over the port's ``bert.apply``, one actor holding the
card, over a Dataset of token-id rows made lazily, block by block, from
the seed; the driver iterates the predictions as they come.

The predictor builds its weights on the card from the seed and scores
one batch before the first real one, so every shape is warm.  With
``--trace 1`` it traces a stretch of its own calls (the process that
holds the card) and leaves the summary in a file of the run's
``TMPDIR``.  The driver keeps the block index of every row, and checks a
sample of the window's rows, drawn from the seed, against the reference
once the runtime has shut down.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict

import numpy as np

from portbench import traffic, weights


def _apply(cfg, params, tokens):
    """Every row one segment: token type 0, as BERT reads a lone text."""
    import torch

    from ray_tpu_torch.models import bert

    return bert.apply(params, tokens, cfg, token_types=torch.zeros_like(tokens))


def make_predictor_cls():
    """The predictor class, made at run time: the port's ``TorchPredictor``
    is imported only in the processes that use it."""
    import torch

    from ray_tpu_torch.models.bert import BertConfig
    from ray_tpu_torch.train.predictor import TorchPredictor

    class BenchBertPredictor(TorchPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            c = checkpoint.to_dict()
            config, dev = c["config"], torch.device(c["device"])
            d = weights.dims(config)
            cfg = BertConfig(**d, dtype=getattr(torch, config["assumed"]["dtype"]), remat=False,
                             num_classes=int(config["assumed"]["num_labels"]),
                             type_vocab_size=int(config["type_vocab_size"]))
            params = weights.bert(config, c["seed"], dev, block_dtype=cfg.dtype)
            obj = cls(params, functools.partial(_apply, cfg), device=dev)
            obj._run, obj._fault = c, c.get("fault", "")
            if obj._fault == "loads_jax":  # for the harness's own tests
                import sys
                import types

                sys.modules.setdefault("jax", types.ModuleType("jax"))
            obj._t_first = obj._trace = obj._trace_left = None
            obj.predict(np.zeros((int(c["batch"]), int(c["seq"])), np.int64), warm=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            return obj

        def predict(self, batch, warm: bool = False, **kwargs):
            c = self._run
            if not warm:
                now = time.perf_counter()
                if self._t_first is None:
                    self._t_first = now
                if (c.get("trace_file") and self._trace is None
                        and now - self._t_first >= c["trace_after_s"]):
                    from portbench.trace import DeviceTrace

                    self._trace = DeviceTrace()
                    self._trace.start()
                    self._trace_left = int(c["trace_batches"])
            out = super().predict(batch, **kwargs)
            if self._fault == "answer_altered":
                out = out[:, ::-1].copy()
            if not warm and self._trace_left is not None:
                self._trace_left -= 1
                if self._trace_left == 0:
                    self._trace.stop()
                    self._trace_left = None
                    threading.Thread(target=self._write_summary, daemon=True).start()
            if not warm:  # as of this batch, for the driver to read at the end
                from portbench.harness import forbidden_modules

                with open(c["device_file"], "w") as f:
                    json.dump({"device": _device_info(c["device"]),
                               "held": forbidden_modules()}, f)
            return out

        def _write_summary(self):
            """Once the driver's window has closed (its clock starts a
            little after this actor's), the trace's summary to its file."""
            c = self._run
            time.sleep(max(0.0, c["summary_after_s"] - (time.perf_counter() - self._t_first)))
            summary = self._trace.summary()
            tmp = c["trace_file"] + ".part"
            with open(tmp, "w") as f:
                json.dump(summary, f)
            os.replace(tmp, c["trace_file"])

    return BenchBertPredictor


def _device_info(device: str) -> Dict[str, Any]:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _rows(mix, seed, batch):
    """A block of the source: its index in, its rows of ids out."""
    index = int(np.asarray(batch["value"] if isinstance(batch, dict) else batch).reshape(-1)[0])
    ids = traffic.score_block(mix, seed, index)
    return {"tokens": ids, "block": np.full((ids.shape[0],), index, np.int64),
            "row": np.arange(ids.shape[0], dtype=np.int64)}


def run(spec: Dict[str, Any], *, seed: int, seconds: float, trace: bool,
        t_start: float) -> Dict[str, Any]:
    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.train.predictor import BatchPredictor

    cell, mix, config = spec["cell"], spec["traffic"], spec["config"]
    device = spec.get("device", "cuda")
    on_card = device == "cuda"
    run_dir = tempfile.mkdtemp(prefix="portbench-score-")
    run_conf = {"config": config, "seed": seed, "device": device, "batch": mix["batch"],
                "seq": mix["seq"], "fault": spec.get("fault", ""),
                "device_file": os.path.join(run_dir, "device.json"),
                "trace_file": os.path.join(run_dir, "trace.json") if trace else None,
                # the stretch ends about as the window does (this actor's
                # clock starts a little before the driver's)
                "trace_after_s": float(cell["settle_s"]) + seconds - float(cell["trace_s"]),
                "trace_batches": int(cell["trace_batches"]),
                "summary_after_s": float(cell["settle_s"]) + seconds + 2.0}
    # enough blocks to outlast the window at the fastest rate the cell allows
    n_blocks = int(cell["blocks"])
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if on_card else 0)
    try:
        ds = data.range(n_blocks, parallelism=n_blocks).map_batches(
            functools.partial(_rows, mix, seed), batch_size=1)
        preds = BatchPredictor.from_checkpoint(
            Checkpoint.from_dict(run_conf), make_predictor_cls()
        ).predict(ds, batch_size=int(mix["batch"]), min_scoring_workers=1,
                  max_scoring_workers=1, num_gpus_per_worker=1 if on_card else 0,
                  feature_columns=["tokens"], keep_columns=["block", "row"])
        rec = _drive(preds, cell, mix, seconds)
        if trace:
            _wait_for(run_conf["trace_file"], run_conf["summary_after_s"] + 120.0)
    finally:
        ray_tpu_torch.shutdown()
    with open(run_conf["device_file"]) as f:
        actor = json.load(f)
    rec["device"], rec["held"] = actor["device"], actor["held"]
    rec["ctx"].update(setup_s=rec.pop("t_open_epoch") - t_start, dims=weights.dims(config),
                      kind=rec["device"]["kind"], batch=int(mix["batch"]), seq=int(mix["seq"]),
                      n_classes=int(config["assumed"]["num_labels"]))
    if trace:
        with open(run_conf["trace_file"]) as f:
            tr = json.load(f)
        rec["ctx"]["trace"] = tr
        # the window up to a second before the actor's profiler started
        cut = seconds - float(cell["trace_s"]) - 1.0
        if cut > 0:
            rec["ctx"]["untraced"] = {"window_s": cut,
                                      "rows": sum(n for t, n in rec["ctx"]["landed"] if t < cut)}
        rec["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        rec["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    rec["checks"], control = check(spec, rec.pop("kept"), seed, device)
    if control:
        rec["control"] = control
    return rec


def _wait_for(path: str, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the scoring actor wrote no trace to {path}")
        time.sleep(0.2)


def _drive(preds, cell, mix, seconds: float) -> Dict[str, Any]:
    """Iterate the predictions: ``settle_s`` after the first batch
    unmeasured, then the window; a batch belongs to the window if it
    reached the driver inside it."""
    it = preds.iter_batches(batch_size=int(mix["batch"]))
    batches, landed, t_open, t_open_epoch = [], [], None, None
    t_first = None
    for b in it:
        now = time.perf_counter()
        if t_first is None:
            t_first = now
        if t_open is None and now - t_first >= float(cell["settle_s"]):
            t_open, t_open_epoch = now, time.time()
            continue  # the window opens at this batch's arrival
        if t_open is not None:
            if now - t_open >= seconds:
                break
            batches.append((np.asarray(b["block"]), np.asarray(b["row"]),
                            np.asarray(b["predictions"], np.float32)))
            landed.append((now - t_open, len(batches[-1][0])))
    else:
        raise RuntimeError("the Dataset ran out before the window closed: more blocks")
    window_s = time.perf_counter() - t_open
    rows = sum(len(blk) for blk, _, _ in batches)
    return {"attempted": rows, "failed": 0, "t_open_epoch": t_open_epoch,
            "ctx": {"window_s": window_s, "rows": rows, "landed": landed}, "kept": batches}


def logit_readings(spec, kept, seed: int, device: str, control: bool = False) -> Dict[str, float]:
    """The widest gap between the program's class logits and the float32
    reference's over the rows of ``kept`` (block, row in it, logits); with
    ``control``, the float8 reference's widest gap on the same rows, and
    the program's with its two classes swapped (an answer altered)."""
    import torch

    from portbench import reference

    config, mix = spec["config"], spec["traffic"]
    reference.no_tf32()
    dev = torch.device(device)
    dtype = getattr(torch, config["assumed"]["dtype"])
    params = reference.f32(weights.bert(config, seed, dev, block_dtype=dtype))
    n_heads = weights.dims(config)["n_heads"]
    by_block: Dict[int, Any] = {}
    out = {"program": 0.0, "rows": 0}
    if control:
        out.update(control=0.0, answer_altered=0.0)
    with torch.no_grad():
        for blocks, rows, logits in kept:
            for index in np.unique(blocks):
                if int(index) not in by_block:
                    by_block[int(index)] = traffic.score_block(mix, seed, int(index))
            ids = np.stack([by_block[int(i)][int(j)] for i, j in zip(blocks, rows)])
            tok = torch.from_numpy(ids).to(dev)
            for r in range(0, len(ids), 16):
                ref = reference.bert_logits(params, tok[r:r + 16], n_heads)
                prog = torch.tensor(logits[r:r + 16], device=dev)
                out["program"] = max(out["program"], float((prog - ref).abs().max()))
                if control:
                    low = reference.bert_logits(params, tok[r:r + 16], n_heads, quant=reference.fp8,
                                                dtype=torch.bfloat16)
                    out["control"] = max(out["control"], float((low - ref).abs().max()))
                    swapped = prog.flip(-1)
                    out["answer_altered"] = max(out["answer_altered"],
                                                float((swapped - ref).abs().max()))
            out["rows"] += len(ids)
    return out


def check(spec, batches, seed: int, device: str):
    cell = spec["cell"]
    limit = float(cell["check"]["logit_gap_max"])
    if not batches:
        return {"logit_gap_max": {"value": None, "limit": limit}}, None
    pick = sorted(traffic.rng(seed, 9).permutation(len(batches))[:int(cell["check"]["batches"])])
    kept = [batches[i] for i in pick]
    g = logit_readings(spec, kept, seed, device, control=bool(spec.get("control")))
    checks = {"logit_gap_max": {"value": g["program"], "limit": limit,
                                "over": f"{g['rows']} rows"}}
    return checks, ({k: g[k] for k in ("control", "answer_altered")} if spec.get("control")
                    else None)
