"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 20]

For each seed, one line of JSON:

- a serving cell: the entry runs a short window at the cell's own load,
  then over the same sample of replies reads the program's widest gap,
  the control's (the float8 reference's first token at each position)
  and a token altered by one where it is produced;
- a scoring cell: the same, over its sample of rows, with the control's
  class logits and the program's with its classes swapped;
- a training cell: the control (float8 products, bfloat16 elsewhere) in
  the program's place, and the
  float32 reference on half of each batch (the mean over the rest), each
  held to the float32 reference by the cell's three numbers.  No window:
  these readings come from the first steps alone.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def windowed(spec, seed: int, seconds: float) -> dict:
    entry = harness.load_entry(spec["cell"]["entry"])
    rec = entry.run(dict(spec, control=True), seed=seed, seconds=seconds, trace=False,
                    t_start=time.time())
    return {"program": rec["checks"]["logit_gap_max"]["value"],
            "over": rec["checks"]["logit_gap_max"].get("over"), **rec["control"]}


def training(spec, seed: int) -> dict:
    import torch

    from portbench import reference
    from portbench.entries import train_lm

    ref = train_lm.reference_readings(spec, seed, "cuda")
    low = train_lm.reference_readings(spec, seed, "cuda", quant=reference.fp8, dtype=torch.bfloat16)
    return {"control": train_lm.compare(low, ref),
            "half_batch": train_lm.compare(train_lm.reference_readings(spec, seed, "cuda",
                                                                       half_batch=True), ref)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    harness.apply_env()
    spec = harness.cell_spec(args.workload)
    harness.require_cards(spec["workload"]["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = (training(spec, seed) if spec["cell"]["entry"] == "train_lm"
               else windowed(spec, seed, args.seconds))
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
