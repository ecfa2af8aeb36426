"""Each cell's whole run at a CPU size, through the same entry, output
check and readers: ``correct`` comes out true on the port as it is, and
false with the timed path broken underneath, once for each fault the cell
can have.  The command itself exits non-zero, printing no result, on a
host with no card."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench import run as run_mod
from portbench.tests import tiny

SEED = 2 ** 31 + 11
FAULTS = [("gpt2-125m.decode-long", "token_altered"),
          ("gpt2-125m.train-b32", "state_unchanged"),
          ("gpt2-125m.train-b32", "half_batch"),
          ("bert-base.score-512", "answer_altered")]


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    harness.apply_env()


WORKLOADS = [w["name"] for w in harness.benchmark()["workloads"]]


def _record(workload, fault=""):
    spec = tiny.spec(workload)
    if fault:
        spec["fault"] = fault
    entry = harness.load_entry(spec["cell"]["entry"])
    return spec, entry.run(spec, seed=SEED, seconds=2.0, trace=False, t_start=time.time())


def _line(workload, fault=""):
    spec, rec = _record(workload, fault)
    return spec, run_mod.result_line(spec, rec, False)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cell_runs_correct_at_a_cpu_size(workload, capsys):
    spec, rec = _record(workload)
    assert run_mod.report(spec, rec, False) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    c = rec["ctx"].get("counters")
    if c:  # a serving cell: the tokens of every landed reply were delivered
        landed = sum(r["tokens"] for r in rec["ctx"]["replies"])
        assert c["close"]["delivered"] - c["open"]["delivered"] > 0
        assert c["close"]["delivered"] >= landed
        assert c["close"]["delivered_t"] > c["open"]["delivered_t"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(workload, fault):
    _, line = _line(workload, fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_jax_loaded_where_the_card_is_held_leaves_no_result(workload, capsys):
    """A module named ``jax`` loaded in the replica, the Train worker or
    the scoring actor: the run prints no result and names it."""
    assert "jax" not in sys.modules
    spec, rec = _record(workload, "loads_jax")
    assert rec["held"] == ["jax"]
    assert run_mod.report(spec, rec, False) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_the_command_exits_non_zero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "gpt2-125m.decode-long", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
