"""The sharded train-step gate: the port's copy of
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` starts a world of ``n`` ranks
(:func:`~ray_tpu_torch.parallel.spawn.run_world`: gloo with
``device="cpu"``, NCCL on ``n`` cards by default), builds meshes that
carry every parallelism axis, and runs one full sharded train step
(forward, ring attention, GPipe, expert parallelism, backward, the AdamW
update) on each.  It is a correctness gate, not a smoke test:

- GPT-2 (fsdp x sp x tp), the Switch-MoE GPT-2 (pp x ep x dp) and Llama
  with GQA (tp x sp x fsdp), in f32, each hold their loss to a plain run of
  the same init and batch with no mesh, within ``PARITY_ATOL``;
- GPT-2 125M's widths (d_model 768, 12 heads and layers, vocab 50304) in
  bf16 at ``max_seq_len`` 128 must give a finite loss: layout and
  divisibility faults that tiny widths hide show there.

Mesh sizes come from :func:`factor`, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

PARITY_ATOL = 2e-3


def factor(axes_pref: Sequence[str], n_devices: int) -> Dict[str, int]:
    """Give each preferred axis a factor of 2 while divisible; the rest goes
    on the last axis."""
    sizes = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    remaining = n_devices
    for axis in axes_pref[:-1]:
        if remaining % 2 == 0:
            sizes[axis] = 2
            remaining //= 2
    sizes[axes_pref[-1]] = remaining
    return sizes


def _dryrun_one(model, cfg, sizes: Dict[str, int], n_devices: int, device: torch.device,
                *, parity_atol=None, label: str = "") -> Dict:
    """One sharded train step on the mesh ``sizes``; with ``parity_atol``
    rank 0 also runs the same init and batch with no mesh and the losses
    must agree."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import train_state
    from ray_tpu_torch.parallel import MeshSpec, create_mesh, get_abstract_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import rules_for_mesh

    mesh = create_mesh(MeshSpec(**sizes), device=device, keep_unit_axes=True)
    rules = rules_for_mesh(mesh)
    optimizer = gpt2.make_optimizer(lr=1e-3)
    params = model.init(cfg, torch.Generator().manual_seed(0), device=device)
    state = train_state(shard_params(params, mesh, rules, model.logical_axes(cfg)), optimizer)
    del params
    step = model.make_train_step(cfg, optimizer, mesh)

    B, T = max(8, n_devices), cfg.max_seq_len
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))).to(device)
             for k in ("inputs", "targets")}
    _, metrics = step(state, batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"[{label}] non-finite loss {loss}")
    out = {"label": label, "mesh": get_abstract_mesh(mesh), "loss": loss, "ref_loss": None}
    if parity_atol is not None and dist.get_rank() == 0:
        # golden: the same math with no mesh and no sharding
        ref = train_state(model.init(cfg, torch.Generator().manual_seed(0), device=device),
                          optimizer)
        _, ref_metrics = model.make_train_step(cfg, optimizer)(ref, batch)
        out["ref_loss"] = ref_loss = float(ref_metrics["loss"])
        if abs(loss - ref_loss) > parity_atol:
            raise AssertionError(f"[{label}] sharded loss {loss:.6f} != single-device "
                                 f"{ref_loss:.6f} (atol {parity_atol})")
    return out


def _run_cases(n_devices: int, device: str) -> List[Dict]:
    from ray_tpu_torch.models import gpt2, llama

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    f32 = torch.float32
    dense = factor(("tp", "sp", "fsdp", "dp"), n_devices)
    moe = factor(("pp", "ep", "dp"), n_devices)
    return [
        _dryrun_one(gpt2, gpt2.GPT2Config.tiny(dtype=f32), dense, n_devices, dev,
                    parity_atol=PARITY_ATOL, label="gpt2 fsdp*sp*tp"),
        _dryrun_one(gpt2, gpt2.GPT2Config.tiny(n_experts=max(2, moe["ep"]), pp_microbatches=2,
                                               dtype=f32),
                    moe, n_devices, dev, parity_atol=PARITY_ATOL, label="gpt2-moe pp*ep*dp"),
        _dryrun_one(llama, llama.LlamaConfig.tiny(dtype=f32), dense, n_devices, dev,
                    parity_atol=PARITY_ATOL, label="llama tp*sp*fsdp"),
        # real 125M widths at a short sequence, bf16, no parity
        _dryrun_one(gpt2, gpt2.GPT2Config.gpt2_small(max_seq_len=128), dense, n_devices, dev,
                    label="gpt2-125m-shape fsdp*sp*tp"),
    ]


def dryrun_multichip(n_devices: int, device: DeviceLike = None, *,
                     deadline: float = 600.0) -> List[Dict]:
    """Run the four cases on a new world of ``n_devices`` ranks (the cards
    when ``device`` is None, gloo ranks with ``device="cpu"``); prints one
    line a case and returns rank 0's results.  Raises when a case fails."""
    from ray_tpu_torch.parallel.spawn import run_world

    dev = resolve_device(device)
    results = run_world(_run_cases, n_devices, (n_devices, dev.type), device=dev,
                        deadline=deadline)[0]
    for r in results:
        parity = "" if r["ref_loss"] is None else (
            f" parity_ok(ref={r['ref_loss']:.4f}, atol={PARITY_ATOL})")
        print(f"dryrun_multichip OK [{r['label']}]: mesh={r['mesh']} "
              f"loss={r['loss']:.4f}{parity}")
    return results


if __name__ == "__main__":
    dryrun_multichip(4, device="cpu")
