"""The port's raylint (``ray_tpu_torch/devtools/raylint``) against the
JAX package's.

Every test of ``tests/test_raylint.py`` by name, run through the port's
copy: each rule fires exactly on the seeded lines of its fixture in
``tests/raylint_fixtures/`` (read as data) and stays silent on the clean
twin; R1 catches a dispatch arm removed from a copy of the port's
``node.py``; the suppression forms, the multiset baseline and
``--update-baseline``'s refusal of a rule subset; the full-tree gate over
``ray_tpu_torch/`` against the port's own ``baseline.json``; ``lint
--json``; the lock witness's three unit cases and a live witnessed
cluster in a subprocess.  Beside them, parity: the port's ``analyze`` and
the JAX ``analyze`` give the same findings (rule, path, line, message)
over every fixture, and over the port's tree once the JAX config's paths
are renamed ``ray_tpu/`` -> ``ray_tpu_torch/``.

Each test has its own time limit (``LIMIT_S``); no JAX head starts, and
the witnessed drive runs under a private ``TMPDIR``.
"""

import dataclasses
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import threading

import pytest

from ray_tpu_torch.devtools.raylint import (
    LintConfig, analyze, run_gate, split_new,
)
from ray_tpu_torch.devtools.raylint.core import (
    BASELINE_RELPATH, Project, SourceFile, baseline_path,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "raylint_fixtures")
LIMIT_S = {"test_lockwitness_live_cluster_cycle_free": 240}


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fail the test (SIGALRM in the main thread) once it runs past its
    limit: 120 s unless ``LIMIT_S`` names another."""
    limit = LIMIT_S.get(request.node.originalname, 120)

    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(limit)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def repo_project():
    """The port's tree parsed ONCE for every tree-wide test here."""
    cfg = LintConfig(root=REPO_ROOT)
    return cfg, Project(cfg.root, cfg.iter_paths())


def _expected_lines(relpath):
    """{line: count} from ``# EXPECT:<rule>`` markers (``x2`` = two)."""
    out = {}
    with open(os.path.join(FIXTURES, relpath)) as f:
        for i, line in enumerate(f, start=1):
            m = re.search(r"# EXPECT:R\d(?: x(\d+))?", line)
            if m:
                out[i] = int(m.group(1) or 1)
    return out


_FIXTURE_DEFAULTS = dict(
    root=FIXTURES,
    head_handler_modules=(), clientbound_handler_modules=(),
    clientbound_sender_modules=(), protocol_exclude=(),
    hot_path_modules=(), head_container_modules=(),
    events_module="", state_api_module="", state_surface_modules=(),
)


def _fixture_config(**overrides):
    return LintConfig(**dict(_FIXTURE_DEFAULTS, **overrides))


def _assert_rule_matches(config, rule, violation_files, clean_files):
    findings = analyze(config, rules=[rule])
    by_file = {}
    for f in findings:
        by_file.setdefault(f.path, {}).setdefault(f.line, 0)
        by_file[f.path][f.line] += 1
    for rel in clean_files:
        assert rel not in by_file, (
            f"{rule} false positive(s) on clean fixture {rel}: "
            f"{by_file.get(rel)}")
    for rel in violation_files:
        expected = _expected_lines(rel)
        got = by_file.get(rel, {})
        assert got == expected, (
            f"{rule} on {rel}: expected findings at {expected}, "
            f"got {got}\n" + "\n".join(f.render() for f in findings))


def test_r1_protocol_fixture():
    cfg = _fixture_config(
        package="r1_bad", head_handler_modules=("r1_bad/node.py",))
    _assert_rule_matches(cfg, "R1",
                         ["r1_bad/client.py", "r1_bad/node.py"], [])
    cfg = _fixture_config(
        package="r1_good", head_handler_modules=("r1_good/node.py",))
    assert analyze(cfg, rules=["R1"]) == []


def test_r1_packed_codec_table_skew():
    cfg = _fixture_config(
        package="r1_packed",
        head_handler_modules=("r1_packed/hub.py",),
        packed_codec_module="r1_packed/codec.py")
    findings = analyze(cfg, rules=["R1"])
    packed = [f for f in findings if f.detail.startswith("packed-")]
    assert [f.detail for f in packed] == ["packed-table-skew:_UNPACK:beta"], \
        "\n".join(f.render() for f in findings)
    _assert_rule_matches(cfg, "R1", ["r1_packed/codec.py"], [])


def test_r1_catches_removed_handler(repo_project):
    """The acceptance mutation on the port's own ``node.py``: delete one
    dispatch arm from a copy and R1 flags every sender of that type."""
    cfg, project = repo_project
    assert analyze(cfg, rules=["R1"], project=project) == [], \
        "R1 must be clean before the mutation"
    rel = "ray_tpu_torch/_private/node.py"
    original = project.files[rel]
    mutated = original.source.replace('elif mtype == "seal":',
                                      'elif mtype == "seal_disabled":', 1)
    assert mutated != original.source, \
        "node.py no longer dispatches on seal?"
    project.files[rel] = SourceFile(rel, mutated)
    try:
        findings = analyze(cfg, rules=["R1"], project=project)
    finally:
        project.files[rel] = original
    unhandled = [f for f in findings if "seal" in f.detail
                 and f.detail.startswith("unhandled-headbound")]
    assert unhandled, (
        "removing the seal arm must surface unhandled senders, got: "
        + "\n".join(f.render() for f in findings))


def test_r1_no_phantom_send_across_functions(tmp_path):
    pkg = tmp_path / "mini"
    pkg.mkdir()
    (pkg / "client.py").write_text(
        'class C:\n'
        '    def build_only(self):\n'
        '        msg = {"type": "ghost"}\n'
        '        return msg  # never sent\n'
        '\n'
        '    def send_other(self, conn, msg):\n'
        '        conn.send(msg)  # msg is a parameter, type unknown\n')
    (pkg / "node.py").write_text(
        'def dispatch(conn, msg):\n'
        '    mtype = msg.get("type")\n'
        '    if mtype == "ghost":\n'
        '        pass\n')
    cfg = _fixture_config(root=str(tmp_path), package="mini",
                          head_handler_modules=("mini/node.py",))
    findings = analyze(cfg, rules=["R1"])
    dead = [f for f in findings if f.detail == "dead-head-handler:ghost"]
    assert dead, (
        "the ghost arm has no live sender and must be reported dead; "
        "got: " + "\n".join(f.render() for f in findings))


def test_r2_exception_shadow_fixture():
    cfg = _fixture_config(package="r2")
    _assert_rule_matches(cfg, "R2", ["r2/violation.py"], ["r2/clean.py"])


def test_r3_hot_path_entropy_fixture():
    cfg = _fixture_config(
        package="r3",
        hot_path_modules=("r3/violation.py", "r3/clean.py"))
    _assert_rule_matches(cfg, "R3", ["r3/violation.py"], ["r3/clean.py"])


def test_r4_lock_scope_weight_fixture():
    cfg = _fixture_config(package="r4")
    _assert_rule_matches(cfg, "R4", ["r4/violation.py"], ["r4/clean.py"])


def test_r5_unbounded_container_fixture():
    cfg = _fixture_config(
        package="r5",
        head_container_modules=("r5/violation.py", "r5/clean.py"))
    _assert_rule_matches(cfg, "R5", ["r5/violation.py"], ["r5/clean.py"])


def test_r6_event_source_fixture():
    cfg = _fixture_config(
        package="r6_bad", events_module="r6_bad/events.py")
    _assert_rule_matches(cfg, "R6", ["r6_bad/emitter.py"], [])
    cfg = _fixture_config(
        package="r6_good", events_module="r6_good/events.py")
    assert analyze(cfg, rules=["R6"]) == []


def test_r7_state_parity_fixture():
    cfg = _fixture_config(
        package="r7_bad", state_api_module="r7_bad/api.py",
        head_handler_modules=("r7_bad/node.py",),
        state_surface_modules=("r7_bad/cli.py",))
    _assert_rule_matches(cfg, "R7", ["r7_bad/api.py"], ["r7_bad/node.py"])
    cfg = _fixture_config(
        package="r7_good", state_api_module="r7_good/api.py",
        head_handler_modules=("r7_good/node.py",),
        state_surface_modules=("r7_good/cli.py",))
    assert analyze(cfg, rules=["R7"]) == []


def test_r8_bare_thread_fixture():
    cfg = _fixture_config(package="r8")
    _assert_rule_matches(cfg, "R8", ["r8/violation.py"], ["r8/clean.py"])


# -- parity with the JAX package's raylint ------------------------------------

# every fixture project with the config its JAX test gives it
FIXTURE_PROJECTS = {
    "r1_bad": dict(head_handler_modules=("r1_bad/node.py",)),
    "r1_good": dict(head_handler_modules=("r1_good/node.py",)),
    "r1_packed": dict(head_handler_modules=("r1_packed/hub.py",),
                      packed_codec_module="r1_packed/codec.py"),
    "r2": {}, "r4": {}, "r8": {},
    "r3": dict(hot_path_modules=("r3/violation.py", "r3/clean.py")),
    "r5": dict(head_container_modules=("r5/violation.py", "r5/clean.py")),
    "r6_bad": dict(events_module="r6_bad/events.py"),
    "r6_good": dict(events_module="r6_good/events.py"),
    "r7_bad": dict(state_api_module="r7_bad/api.py",
                   head_handler_modules=("r7_bad/node.py",),
                   state_surface_modules=("r7_bad/cli.py",)),
    "r7_good": dict(state_api_module="r7_good/api.py",
                    head_handler_modules=("r7_good/node.py",),
                    state_surface_modules=("r7_good/cli.py",)),
}


# the one wording that differs: R3's message says what its ~30% cost
# came before, in each package's own words; the rest of it is compared
_R3_DATING = re.compile(r"(of throughput before )[^)]*")


def _rows(findings):
    return [(f.rule, f.path, f.line, _R3_DATING.sub(r"\1...", f.message))
            for f in findings]


def _rename(value):
    if isinstance(value, str):
        return re.sub(r"^ray_tpu/", "ray_tpu_torch/", value)
    if isinstance(value, tuple):
        return tuple(_rename(v) for v in value)
    return value


@pytest.mark.parametrize("package", sorted(FIXTURE_PROJECTS))
def test_fixture_findings_equal_the_jax_raylints(package):
    """All eight rules over one fixture project: the same findings from
    both packages' ``analyze``."""
    from ray_tpu.devtools import raylint as jax_raylint

    overrides = dict(_FIXTURE_DEFAULTS, package=package,
                     **FIXTURE_PROJECTS[package])
    ours = analyze(LintConfig(**overrides))
    theirs = jax_raylint.analyze(jax_raylint.LintConfig(**overrides))
    assert _rows(ours) == _rows(theirs)
    assert bool(ours) != package.endswith("_good"), _rows(ours)


def test_port_tree_findings_equal_the_jax_raylints_with_its_paths_renamed(repo_project):
    """Over the port's tree, the JAX raylint whose config names each
    ``ray_tpu/...`` module as ``ray_tpu_torch/...`` finds exactly what
    the port's raylint finds: the port's defaults are the JAX defaults
    renamed, and the rules are the same rules."""
    from ray_tpu.devtools import raylint as jax_raylint

    cfg, project = repo_project
    jax_defaults = jax_raylint.LintConfig(root=REPO_ROOT)
    renamed = {f.name: _rename(getattr(jax_defaults, f.name))
               for f in dataclasses.fields(jax_defaults)
               if f.name not in ("root", "extras")}
    renamed["package"] = "ray_tpu_torch"
    assert renamed == {k: getattr(cfg, k) for k in renamed}
    theirs = jax_raylint.analyze(jax_raylint.LintConfig(root=REPO_ROOT, **renamed))
    assert _rows(analyze(cfg, project=project)) == _rows(theirs)


# -- suppressions + baseline mechanics ----------------------------------------

def test_suppression_forms():
    sf = SourceFile("x.py", "\n".join([
        "import time",                                   # 1
        "a = 1  # raylint: disable=R3",                  # 2
        "b = 2  # raylint: disable=R3 (rationale here)",  # 3
        "c = 3  # raylint: disable=R3,R4",               # 4
        "# raylint: disable=R5",                         # 5 -> covers 6
        "d = 4",                                         # 6
        "e = 5  # raylint: disable",                     # 7 (all rules)
        "f = 6",                                         # 8
        "g = 7  # raylint: disable=R3 (see R4, R5 below)",  # 9
        "h = 8  # raylint: disable=R3 one-shot, cold R4 path",  # 10
    ]))
    assert sf.suppressed(2, "R3") and not sf.suppressed(2, "R4")
    assert sf.suppressed(3, "R3")
    assert sf.suppressed(4, "R3") and sf.suppressed(4, "R4")
    assert sf.suppressed(6, "R5") and not sf.suppressed(5, "R5")
    assert sf.suppressed(7, "R1") and sf.suppressed(7, "R8")
    assert not sf.suppressed(8, "R3")
    assert sf.suppressed(9, "R3")
    assert not sf.suppressed(9, "R4") and not sf.suppressed(9, "R5")
    assert sf.suppressed(10, "R3") and not sf.suppressed(10, "R4")


def test_baseline_multiset_semantics():
    from ray_tpu_torch.devtools.raylint.core import Finding

    def mk(detail):
        return Finding(rule="R4", path="m.py", line=1, message="m",
                       remedy="r", detail=detail, scope="f")

    baseline = {}
    for f in [mk("a"), mk("a"), mk("b")]:
        baseline[f.baseline_key()] = baseline.get(f.baseline_key(), 0) + 1
    new, old = split_new([mk("a"), mk("a"), mk("a"), mk("b")], baseline)
    assert len(old) == 3 and len(new) == 1


def test_update_baseline_rejects_rule_subset(tmp_path):
    """Against a throwaway root holding a copy of the port's baseline: if
    the guard ever regresses, the rewrite hits the copy, never the
    package's file (nor the JAX package's ``raylint_baseline.json``)."""
    dst = tmp_path / BASELINE_RELPATH
    dst.parent.mkdir(parents=True)
    shutil.copy(baseline_path(REPO_ROOT), dst)
    before = dst.read_text()
    with pytest.raises(ValueError):
        run_gate(str(tmp_path), rules=["R3"], update_baseline=True)
    assert dst.read_text() == before
    assert not (tmp_path / "raylint_baseline.json").exists()


def test_the_baseline_is_the_ports_own_file():
    """The port's baseline lives in its package, and keys only the
    port's paths."""
    path = baseline_path(REPO_ROOT)
    assert path == os.path.join(REPO_ROOT, "ray_tpu_torch", "devtools",
                                "raylint", "baseline.json")
    with open(path) as f:
        keys = json.load(f)["findings"]
    assert all(k.split("|")[1].startswith("ray_tpu_torch/") for k in keys)


# -- the tier-1 gate itself ----------------------------------------------------

def test_full_repo_gate_is_green(repo_project):
    """THE gate over ``ray_tpu_torch/``: a new finding beyond the port's
    baseline fails tier-1, and so does a stale key."""
    cfg, project = repo_project
    result = run_gate(REPO_ROOT, config=cfg, project=project)
    assert result.new == [], (
        "new raylint findings:\n" + "\n".join(f.render() for f in result.new))
    assert result.stale_keys == [], (
        "stale baseline entries (rerun --update-baseline): "
        f"{result.stale_keys}")


def test_lint_cli_json(capsys):
    """``python -m ray_tpu_torch lint --json`` through the real argparse
    entry, in-process."""
    from ray_tpu_torch.scripts import cli

    cli.main(["lint", "--json"])  # green tree: must NOT SystemExit
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True
    assert payload["new"] == []
    assert [f["key"] for f in payload["baselined"]] == json.load(
        open(baseline_path(REPO_ROOT)))["findings"]


def test_doctor_static_against_a_live_head_names_no_raylint_finding(capsys, monkeypatch):
    """``doctor --static --json`` against an in-process port head: the
    raylint gate joins the doctor's report, and on this tree it adds no
    ``raylint/`` row (whatever the head's own rules say)."""
    import ray_tpu_torch
    from ray_tpu_torch.scripts import cli

    monkeypatch.setenv("RAY_TPU_TORCH_CONT_PROFILE", "0")
    ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        try:
            cli.main(["doctor", "--static", "--json"])
        except SystemExit as e:
            assert e.code == 1  # the head's own findings, if any
        findings = json.loads(capsys.readouterr().out)
    finally:
        ray_tpu_torch.shutdown()
    assert not [f for f in findings if f["rule"].startswith("raylint/")], findings


def test_lint_takes_the_jax_packages_flags(capsys):
    from ray_tpu.scripts import cli as jax_cli
    from ray_tpu_torch.scripts import cli

    def flags(main):
        with pytest.raises(SystemExit) as e:
            main(["lint", "--help"])
        assert e.value.code == 0
        return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out)) - {"--help"}

    assert flags(cli.main) == flags(jax_cli.main) == {
        "--rule", "--json", "--verbose", "--update-baseline", "--root"}


def test_rule_subset_api(repo_project):
    cfg, project = repo_project
    r3 = analyze(cfg, rules=["R3"], project=project)
    assert all(f.rule == "R3" for f in r3)
    with pytest.raises(ValueError):
        analyze(cfg, rules=["R99"], project=project)


# -- lock-order witness (the dynamic sanitizer) --------------------------------

def test_lockwitness_abba_cycle(monkeypatch):
    from ray_tpu_torch.devtools.raylint.lockwitness import WITNESS, wrap_lock

    monkeypatch.delenv("RAY_TPU_TORCH_LOCKWITNESS_DIR", raising=False)
    WITNESS.reset()
    A = wrap_lock("fixA", threading.Lock())
    B = wrap_lock("fixB", threading.Lock())

    def ab():
        with A:
            with B:
                pass

    def ba():
        with B:
            with A:
                pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        t.join()
    snap = WITNESS.snapshot()
    assert "fixA->fixB" in snap["edges"] and "fixB->fixA" in snap["edges"]
    assert len(snap["cycles"]) == 1
    cyc = snap["cycles"][0]
    assert cyc["locks"][0] == cyc["locks"][-1]
    assert cyc["closing_stack"]
    assert all(stk for stk in cyc["edges"].values())
    with pytest.raises(AssertionError):
        WITNESS.assert_cycle_free()
    WITNESS.reset()
    WITNESS.assert_cycle_free()


def test_lockwitness_rlock_reentry_no_false_cycle():
    from ray_tpu_torch.devtools.raylint.lockwitness import WITNESS, wrap_lock

    WITNESS.reset()
    A = wrap_lock("reA", threading.RLock())
    B = wrap_lock("reB", threading.Lock())
    with A:
        with A:
            with B:
                pass
    with A:
        with B:
            pass
    snap = WITNESS.snapshot()
    assert snap["edges"] == ["reA->reB"]
    WITNESS.assert_cycle_free()


def test_lockwitness_condition_over_wrapped_rlock():
    import time

    from ray_tpu_torch.devtools.raylint.lockwitness import WITNESS, wrap_lock

    WITNESS.reset()
    L = wrap_lock("condL", threading.RLock())
    cond = threading.Condition(L)
    hits = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hits.append(1)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.2)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert hits == [1]
    WITNESS.assert_cycle_free()


def test_make_lock_is_timed_with_the_witness_off(monkeypatch):
    """Without the flag ``make_lock`` keeps the timing proxy (and the
    untimed names stay bare); with it, every name is witnessed and
    untimed, as in the JAX package."""
    from ray_tpu_torch._private import locks
    from ray_tpu_torch.devtools.raylint.lockwitness import WitnessLock

    monkeypatch.delenv("RAY_TPU_TORCH_LOCKWITNESS", raising=False)
    assert isinstance(locks.make_lock("node.registry", rlock=True), locks._TimedLock)
    assert not isinstance(locks.make_lock("metrics.registry"), (locks._TimedLock, WitnessLock))
    monkeypatch.setenv("RAY_TPU_TORCH_LOCKWITNESS", "1")
    for name in ("node.registry", "metrics.registry"):
        lock = locks.make_lock(name)
        assert isinstance(lock, WitnessLock) and not isinstance(lock._lock, locks._TimedLock)


def test_lockwitness_live_cluster_cycle_free(tmp_path):
    """A port head with workers, actors, a kill, puts and metrics, driven
    with every named lock witnessed, stays lock-order-cycle-free in the
    head and in every worker (workers report into
    ``RAY_TPU_TORCH_LOCKWITNESS_DIR``).  The flag is set before the
    interpreter starts, so the module-level locks made at import (the
    metrics registry, ``object_store``'s attached and arena-map locks)
    are witnessed too."""
    report_dir = str(tmp_path / "lockwitness")
    # a short private TMPDIR: the head's unix socket lives under it
    private_tmp = tempfile.mkdtemp(prefix="rlw_")
    drive = tmp_path / "drive.py"
    drive.write_text(textwrap.dedent("""\
        import json
        import ray_tpu_torch
        from ray_tpu_torch.devtools.raylint.lockwitness import WITNESS, WitnessLock

        from ray_tpu_torch._private import object_store
        from ray_tpu_torch.util import metrics
        assert isinstance(metrics._global.lock, WitnessLock), \\
            "metrics registry lock unwitnessed"
        assert isinstance(object_store._ATTACHED_LOCK, WitnessLock), \\
            "object_store attached lock unwitnessed"
        assert isinstance(object_store._ARENA_MAPS_LOCK, WitnessLock), \\
            "object_store arena-maps lock unwitnessed"

        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        try:
            @ray_tpu_torch.remote
            def f(x):
                return x + 1

            @ray_tpu_torch.remote
            class Counter:
                def __init__(self):
                    self.n = 0

                def inc(self):
                    self.n += 1
                    return self.n

            assert ray_tpu_torch.get([f.remote(i) for i in range(12)]) == \\
                [i + 1 for i in range(12)]
            actors = [Counter.remote() for _ in range(3)]
            for c in actors:
                assert ray_tpu_torch.get([c.inc.remote() for _ in range(5)])[-1] == 5
            ray_tpu_torch.kill(actors[0])
            ref = ray_tpu_torch.put(b"x" * (1 << 18))
            assert len(ray_tpu_torch.get(ref)) == 1 << 18
            metrics.Counter("raylint_witness_test_total", "coverage").inc()
        finally:
            ray_tpu_torch.shutdown()
        snap = WITNESS.snapshot()
        WITNESS.assert_cycle_free()
        print("WITNESS_SNAPSHOT " + json.dumps({"edges": snap["edges"]}))
    """))
    env = dict(os.environ,
               RAY_TPU_TORCH_LOCKWITNESS="1",
               RAY_TPU_TORCH_LOCKWITNESS_DIR=report_dir,
               TMPDIR=str(private_tmp))
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, str(drive)], cwd=REPO_ROOT, env=env,
            capture_output=True, text=True, timeout=200)
    finally:
        shutil.rmtree(private_tmp, ignore_errors=True)
    assert proc.returncode == 0, (
        f"witnessed drive failed (rc={proc.returncode}):\n"
        f"{proc.stdout}\n{proc.stderr}")
    marked = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("WITNESS_SNAPSHOT ")]
    assert marked, f"no snapshot line in drive output:\n{proc.stdout}"
    edges = json.loads(marked[-1].split(" ", 1)[1])["edges"]
    assert edges, "witness saw no nested acquisitions — is it on?"
    assert any("node.shard" in e for e in edges), edges
    reports = glob.glob(os.path.join(report_dir, "*.json"))
    assert reports == [], (
        f"lock-order cycles reported: "
        f"{[open(p).read() for p in reports]}")
