"""Run a cell several times, each run a process of its own as the check
runs it, and give each metric's median and quartile spread.

    python3 portbench/repeat.py --workload <cell> --seeds 1,2,3 --seconds 30 \
        [--trace 0] [--out results.jsonl]

Each run's last line goes to ``--out`` with its seed, exit code and wall;
the summary (per metric: values, median, (Q3 - Q1) / median) is printed
last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--out", default=None)
    p.add_argument("--logdir", default=None, help="each run's standard error goes here")
    args = p.parse_args()
    values = {}
    for seed in args.seeds.split(","):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
             "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True)
        wall = time.time() - t0
        if args.logdir:
            os.makedirs(args.logdir, exist_ok=True)
            with open(os.path.join(args.logdir, f"{args.workload}-{seed}-t{args.trace}.err"), "w") as f:
                f.write(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        row = {"seed": int(seed), "rc": proc.returncode, "wall_s": wall}
        try:
            row.update(json.loads(lines[-1]))
        except (IndexError, ValueError):
            row["stderr_tail"] = proc.stderr[-3000:]
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        for k, m in row.get("metrics", {}).items():
            values.setdefault(k, []).append(m["value"])
    summary = {}
    for k, v in values.items():
        s = {"values": v, "median": statistics.median(v)}
        if len(v) >= 2:
            s["spread"] = harness.quartile_spread(v)
        summary[k] = s
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
