"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets the cell up from the seed, warms up its shapes, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit.
Exits non-zero and prints no result where the card is missing, the run
fails, or this process or the one that held the card (the replica, the
Train worker, the scoring actor) holds JAX or the JAX package once the
window has closed.

Everything the run writes outside the checkout (the runtime's session
and shared memory, the trainer's storage, the actor's files) goes under
a directory of its own inside ``TMPDIR``, removed when the run ends.
"""

import time

T_START = time.time()  # noqa: E402 — set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(spec, record, trace: bool) -> dict:
    """The contract's last line from an entry's record: the metrics by
    their readers (a reader with nothing to read leaves its metric out),
    ``correct`` from the output checks, and the checks last."""
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = harness.load_reader(m["name"])(record["ctx"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = record["checks"]
    correct = (record["failed"] == 0 and bool(checks)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    line = {"correct": correct, "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics, "device": record["device"]}
    if trace and record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    line["checks"] = checks
    return line


def report(spec, record, trace: bool) -> int:
    """Print the checks and the result line, or, where this process or the
    card's process holds JAX or the JAX package, say so and print no
    result.  The exit code."""
    line = result_line(spec, record, trace)
    if line["device"].get("platform") == "gpu":
        line["device"]["card"] = harness.card_power_limit()  # name and power limit
    held = {"this process": harness.forbidden_modules(), "the card's process": record["held"]}
    if any(held.values()):
        print(f"portbench: after the window, {held}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    run_tmp = tempfile.mkdtemp(prefix="portbench-run-")
    os.environ["TMPDIR"] = run_tmp
    tempfile.tempdir = None
    try:
        harness.apply_env()
        spec = harness.cell_spec(args.workload)
        try:
            harness.require_cards(spec["workload"]["chips"])
        except harness.NoDevice as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 3
        entry = harness.load_entry(spec["cell"]["entry"])
        try:
            record = entry.run(spec, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), t_start=T_START)
        except Exception:  # noqa: BLE001 — a failed run prints no result
            traceback.print_exc()
            return 1
        return report(spec, record, bool(args.trace))
    finally:
        shutil.rmtree(run_tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
