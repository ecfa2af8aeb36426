"""The harness finds every cell's files by name, ``BENCHMARK.json`` keeps
to the contract's shape, the traffic repeats for a seed, the operation
and byte counts match hand counts, and nothing the benchmark loads is
JAX or the JAX package."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest

from portbench import flops, harness, readers, traffic

BENCH = harness.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    spec = harness.cell_spec(workload)
    harness.load_entry(spec["cell"]["entry"])
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["file"].startswith("portbench/")
        assert json.load(open(harness.ROOT / c["file"]))["source"] == c["source"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_closed_loop_repeats_for_a_seed_and_replays_its_lengths_across_seeds():
    mix = harness.read_json(harness.HERE / "traffic" / "decode-long.json")
    a, b = traffic.closed_loop(mix, 2 ** 31 + 5), traffic.closed_loop(mix, 2 ** 31 + 5)
    c = traffic.closed_loop(mix, 7)
    assert a == b and a != c
    lens = lambda reqs: [(len(r["tokens"]), r["max_new"]) for r in reqs[0] + reqs[1]]
    assert lens(a) == lens(c)
    for r in a[0] + a[1]:
        assert 32 <= len(r["tokens"]) <= 128 and 1 <= r["max_new"] <= 768
        assert max(r["tokens"]) < mix["vocab"]
    assert all(384 <= r["max_new"] <= 768 for r in a[1])
    assert len(a[0]) == mix["clients"] and sorted(r["max_new"] for r in a[0]) != sorted(
        r["max_new"] for r in a[1][:mix["clients"]])


def test_row_and_batch_generators_repeat_for_a_seed():
    import torch

    mix = harness.read_json(harness.HERE / "traffic" / "score-512.json")
    small = dict(mix, block_rows=4, seq=16)
    assert np.array_equal(traffic.score_block(small, 9, 3), traffic.score_block(small, 9, 3))
    assert not np.array_equal(traffic.score_block(small, 9, 3), traffic.score_block(small, 9, 4))
    tmix = dict(harness.read_json(harness.HERE / "traffic" / "train-b32.json"), batch=2, seq=8)
    x = traffic.train_batch(tmix, 2 ** 31 + 1, 4, "cpu")["tokens"]
    assert torch.equal(x, traffic.train_batch(tmix, 2 ** 31 + 1, 4, "cpu")["tokens"])
    assert not torch.equal(x, traffic.train_batch(tmix, 2 ** 31 + 1, 5, "cpu")["tokens"])
    assert x.shape == (2, 9)


def test_lognormal_lengths_stay_in_range_and_centre_on_the_median():
    u = (np.arange(1001) + 0.5) / 1001
    out = traffic.quantile({"dist": "lognormal", "median": 192, "sigma": 0.6, "lo": 64, "hi": 512}, u)
    assert out.min() >= 64 and out.max() <= 512 and out[500] == 192


def test_the_serve_rate_counts_delivered_tokens_between_two_deliveries():
    c = {"open": {"delivered": 1000, "delivered_t": 10.0},
         "close": {"delivered": 1000 + 3 * 4096, "delivered_t": 11.5}}
    assert readers.serve_tokens_per_s({"counters": c}) == pytest.approx(3 * 4096 / 1.5)
    assert readers.serve_tokens_per_s({"replies": [{"tokens": 5}], "window_s": 1.0}) is None
    same = {"open": c["open"], "close": dict(c["open"])}
    assert readers.serve_tokens_per_s({"counters": same}) is None


def test_flop_and_byte_counts_match_hand_counts():
    d = {"d_model": 4, "d_ff": 8, "n_layers": 2, "n_heads": 2, "vocab_size": 10}
    # per layer: qkv 2*4*12, out 2*4*4, ffn 2*(2*4*8); head 2*4*10
    assert flops.dense_flops_per_token(d) == 2 * (96 + 32 + 128) + 80
    assert flops.attn_pairs(3, 3, True) == 6 and flops.attn_pairs(3, 5, False) == 15
    assert flops.decode_token_flops(d, 5) == 2 * 256 + 80 + 2 * 4 * 4 * 5
    assert flops.prefill_flops(d, 3) == 2 * 256 * 3 + 80 + 2 * 16 * 6
    assert flops.train_step_flops(d, 2, 3) == 3 * 2 * (592 * 3 + 2 * 16 * 6)
    assert flops.encoder_flops(d, 1, 3, 2) == 2 * 256 * 3 + 2 * 16 * 9 + 32 + 16
    # one head of one sequence, causal T=2 (3 pairs), dh=4: fwd 2 products
    f = flops.flash_cost("fwd", batch=1, heads=1, tq=2, tk=2, dh=4, causal=True)
    assert f == {"flops": 2 * 2 * 4 * 3, "bytes": 2 * 8 * 2 + 2 * 8 * 2 + 2 * 4}
    dq = flops.flash_cost("dq", batch=1, heads=1, tq=2, tk=2, dh=4, causal=True)
    dkv = flops.flash_cost("dkv", batch=1, heads=1, tq=2, tk=2, dh=4, causal=True)
    assert dq["flops"] + dkv["flops"] == 5 * 2 * 4 * 3
    assert dq["bytes"] == 4 * 16 + 2 * 8 + 16 and dkv["bytes"] == 4 * 16 + 2 * 8 + 32
    kind = "NVIDIA H100 80GB HBM3"
    assert flops.least_seconds({"flops": 989e12, "bytes": 1}, kind) == pytest.approx(1.0)
    assert flops.least_seconds({"flops": 1, "bytes": 3.35e12}, kind) == pytest.approx(1.0)


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    code = (
        "import sys, importlib, pkgutil, runpy\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "import portbench, portbench.entries\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from portbench import harness\n"
        "for w in harness.benchmark()['workloads']:\n"
        "    spec = harness.cell_spec(w['name'])\n"
        "    harness.load_entry(spec['cell']['entry'])\n"
        "    [harness.load_reader(m['name']) for m in spec['end_to_end'] + spec['per_layer']]\n"
        "import ray_tpu_torch, ray_tpu_torch.serve, ray_tpu_torch.train, ray_tpu_torch.data\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'ray_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(harness.run_env(), PATH="/usr/bin:/bin"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [] or "ray_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


class _Ev:
    def __init__(self, name, start, end, dev, note=False):
        import torch

        self._n, self._s, self._e, self._note = name, start, end, note
        self._d = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._note


def test_a_trace_summary_counts_overlaps_once_and_only_inside_the_stretch():
    """The marked range wins over the host's own stamps where the trace
    holds it."""
    from portbench.trace import MARK, kernel_seconds, summarize

    ev = [_Ev(MARK, 100, 1100, False), _Ev(MARK, 100, 1100, True, note=True),
          _Ev("k_a", 50, 200, True),     # in flight at the start: 100 ns of it count
          _Ev("k_b", 300, 500, True), _Ev("k_c", 400, 600, True),  # overlap: 300 busy
          _Ev("k_a", 900, 1000, True), _Ev("host_op", 600, 900, False)]
    s = summarize(ev, 0, 5000)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx((100 + 300 + 100) / 1e9)
    assert kernel_seconds(s, "k_a") == (1, pytest.approx(100 / 1e9))  # whole launches only
    assert dict(s["idle_gaps"])["host_op"] == pytest.approx(300 / 1e9)
