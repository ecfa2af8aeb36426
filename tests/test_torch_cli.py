"""The port's operator plane from the command line: ``python -m
ray_tpu_torch`` (``scripts/cli.py``) against a head it started, and
``autoscaler/commands.py``'s ``up``/``down`` with ``LocalCommandRunner``.

Every process this file starts gets a private temp directory
(``TMPDIR``), so the session record that ``up``, ``status`` and ``stop``
read is this file's own and no other test's head can overwrite it.  The
JAX package's ``up``/``down`` run only against a recording runner: no JAX
process starts.  Each test has its own time limit.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import commands
from ray_tpu_torch.scripts import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: every wait in this file


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its 150 s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(150)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def private_tmp():
    """TMPDIR for every process the module starts, and this process's
    ``tempfile.gettempdir()``."""
    with tempfile.TemporaryDirectory(prefix="cli_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        yield d


def _run_cli(*args, env=None, timeout=T):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})


def _in_process(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(list(argv))
    return out.getvalue()


def _until(fn, what, timeout=T):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, f"timed out on {what}"
        time.sleep(0.1)


def _running(pid):
    """True while ``pid`` runs (a zombie awaiting its reaper has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _pids_matching(*needles):
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if all(n in cmd for n in needles) and _running(int(d)):
            out.append(int(d))
    return out


def _stand_in(*argv_tail):
    """A sleeping process whose cmdline ends with ``argv_tail`` (what a
    head's or agent's cmdline looks like to ``pkill -f``)."""
    return subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)", *argv_tail])


def test_cli_drives_a_head_it_started(private_tmp):
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--num-cpus", "2",
         "--num-gpus", "0"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(head.stdout), daemon=True).start()
    try:
        address = _until(lambda: next((ln.split()[-1] for ln in list(lines)
                                       if "head running: tcp://" in ln), None), "the head")
        authkey = _until(lambda: next((ln.split()[-1] for ln in list(lines)
                                       if ln.startswith("authkey:")), None), "the authkey")
        # status through the session record, in a process of its own
        out = _run_cli("status")
        assert out.returncode == 0, out.stderr
        status = json.loads(out.stdout)
        assert status["nodes"] == 1 and status["cluster_resources"]["node-head"]["CPU"] == 2.0
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RAY_TPU_TORCH_ADDRESS", address)
            mp.setenv("RAY_TPU_TORCH_AUTHKEY", authkey)
            _drive(address, authkey)
        assert "sent SIGTERM to head pid" in _in_process("stop")
        assert head.wait(timeout=T) == 0  # SIGTERM unwinds through shutdown()
    finally:
        if head.poll() is None:
            head.kill()
            head.wait(timeout=T)


def _drive(address, authkey):
    from ray_tpu_torch.util import tracing

    try:
        @ray_tpu_torch.remote
        class Pinger:
            def ping(self):
                return "pong"

        _in_process("list", "nodes")  # connects this process as a driver
        pinger = Pinger.remote()
        assert ray_tpu_torch.get(pinger.ping.remote(), timeout=T) == "pong"
        actors = json.loads(_in_process("list", "actors"))
        assert [(a["class_name"], a["state"]) for a in actors] == [("Pinger", "ALIVE")]

        out = _in_process("submit", "--", sys.executable, "-c", "print('from the cli job')")
        job_id = out.split()[1].rstrip(":")
        from ray_tpu_torch.job_submission import JobSubmissionClient

        jobs = JobSubmissionClient(address, bytes.fromhex(authkey))
        assert jobs.wait_until_finish(job_id, timeout=T) == "SUCCEEDED"
        assert _in_process("job-logs", job_id) == "from the cli job\n"

        sleeper = _in_process("submit", "--", "sleep", "600").split()[1].rstrip(":")
        out = _run_cli("job-stop", sleeper)
        assert out.returncode == 0 and out.stdout == "stopped\n", out.stderr
        assert jobs.wait_until_finish(sleeper, timeout=T) == "STOPPED"
        assert {j["job_id"]: j["status"] for j in json.loads(_in_process("list", "jobs"))} == {
            job_id: "SUCCEEDED", sleeper: "STOPPED"}
        jobs.close()

        with tracing.trace("cli-request") as ctx:
            assert ray_tpu_torch.get(pinger.ping.remote(), timeout=T) == "pong"
        trace = json.loads(_in_process("trace", ctx["trace_id"], "--json"))
        assert any(s["name"] == "Pinger.ping" for s in trace["spans"])
        listed = _until(lambda: [r for r in json.loads(_in_process("trace", "--json"))
                                 if r["trace_id"] == ctx["trace_id"]], "the trace listing")
        assert listed[0]["name"] == "cli-request"
        from ray_tpu.util.trace_analysis import analyze as jax_analyze
        from ray_tpu.util.trace_analysis import render_trace as jax_render_trace

        def rendered_alike():
            # the driver's own spans reach the head on its next event push
            trace = json.loads(_in_process("trace", ctx["trace_id"], "--json"))
            rendered = _in_process("trace", ctx["trace_id"])
            want = jax_render_trace(trace, jax_analyze(trace))
            return rendered if rendered.startswith(want) else None
        rendered = _until(rendered_alike, "the rendered trace to settle")
        assert "critical path:" in rendered and "Pinger.ping" in rendered

        path = os.path.join(tempfile.gettempdir(), "cli_timeline.json")
        assert path in _in_process("timeline", "--out", path)
        events = json.load(open(path))
        assert any(e["name"] == "Pinger.ping" and e["ph"] == "X" for e in events)
        rows = [json.loads(ln) for ln in _in_process("events", "--limit", "5").splitlines()]
        assert 0 < len(rows) <= 5 and all("source" in r for r in rows)
        assert json.loads(_in_process("events", "--summary"))["actor"]
        assert json.loads(_in_process("serve-status")) == {}  # serve is not running
    finally:
        ray_tpu_torch.shutdown()


def test_up_and_down_with_the_local_runner(private_tmp):
    config = {"cluster_name": "clitest", "provider": {"type": "local"},
              "head_node": {"address": "127.0.0.1", "num_cpus": 1, "num_gpus": 0},
              "worker_nodes": [{"address": "127.0.0.1", "num_cpus": 1, "num_gpus": 1}]}
    # a stand-in for the JAX package's agent of a same-named cluster (no
    # stand-in JAX head: a JAX test's own `down` would kill it; the head
    # patterns are held apart below), and one for another port cluster's
    # head, which this cluster's record does not name
    bystanders = [_stand_in("ray_tpu._private.node_agent", "--node-id", "node-clitest-0"),
                  _stand_in("-m", "ray_tpu_torch", "start", "--head")]
    try:
        out = commands.up(config)
        try:
            assert out["address"].startswith("tcp://") and out["workers"] == [
                {"address": "127.0.0.1", "node_id": "node-clitest-0"}]
            record = json.load(open(os.path.join(private_tmp, "ray_tpu_torch",
                                                 "last_session.json")))
            ray_tpu_torch.init(address=out["address"], _authkey=bytes.fromhex(out["authkey"]))
            try:
                _until(lambda: ray_tpu_torch.cluster_resources().get("GPU") == 1.0,
                       "the agent's card")
                assert len(ray_tpu_torch.nodes()) == 2

                @ray_tpu_torch.remote(num_gpus=1)
                def where():
                    return (ray_tpu_torch.get_runtime_context().node_id,
                            os.environ.get("CUDA_VISIBLE_DEVICES"))

                assert ray_tpu_torch.get(where.remote(), timeout=T) == ("node-clitest-0", "0")
            finally:
                ray_tpu_torch.shutdown()
            agents = _pids_matching("ray_tpu_torch._private.node_agent", "node-clitest-0")
            assert len(agents) == 1
        finally:
            commands.down(config)
        _until(lambda: not _running(record["pid"]) and not _pids_matching(
            "ray_tpu_torch._private.node_agent", "node-clitest-0"), "the cluster's exit")
        assert all(p.poll() is None for p in bystanders), "down killed another cluster's process"
    finally:
        for p in bystanders:
            p.kill()
            p.wait(timeout=T)


class _Recorder(commands.CommandRunner):
    """Records each command; ``cat`` of the session record answers with
    a fixed record."""

    def __init__(self):
        self.calls = []

    def run(self, address, cmd, timeout=300.0):
        self.calls.append((address, cmd))
        if cmd.startswith("cat "):
            return json.dumps({"address": "tcp://127.0.0.1:6380", "authkey": "ab" * 16,
                               "pid": 4321})
        return ""


def _configs(gpu_key):
    local = {"cluster_name": "lt", "provider": {"type": "local"},
             "head_node": {"address": "127.0.0.1", "num_cpus": 2, gpu_key: 0},
             "worker_nodes": [{"address": "127.0.0.1", "num_cpus": 1, gpu_key: 1}]}
    remote = {"cluster_name": "far", "head_node": {"address": "10.0.0.1", "num_cpus": 8},
              "worker_nodes": [{"address": "10.0.0.2", gpu_key: 8},
                               {"address": "10.0.0.3", "num_cpus": 4, gpu_key: 8}],
              "head_start_extra": "--num-cpus 8"}
    return [local, remote]


def _recorded(mod, config):
    up_rec, down_rec = _Recorder(), _Recorder()
    out = mod.up(config, runner=up_rec, python="python3")
    mod.down(config, runner=down_rec)
    return out, up_rec.calls, down_rec.calls


def _jax_renamed(text):
    return (text.replace("ray_tpu", "ray_tpu_torch").replace("RAY_TPU_", "RAY_TPU_TORCH_")
            .replace("--num-tpus", "--num-gpus"))


# the JAX package's `down` ends its head kill with a pattern that matches
# every CLI-started head on the host (commands.py:205); the port's kills
# the head by its session record's pid only
JAX_HEAD_FALLBACK = "; pkill -f 'ray_tpu start [-][-]head' || true"


@pytest.mark.parametrize("which", [0, 1], ids=["local", "remote"])
def test_up_and_down_commands_equal_the_jax_packages(private_tmp, which):
    from ray_tpu.autoscaler import commands as jax_commands

    got = _recorded(commands, _configs("num_gpus")[which])
    want = _recorded(jax_commands, _configs("num_tpus")[which])
    tmp = tempfile.gettempdir()
    assert [JAX_HEAD_FALLBACK in c for _, c in want[2]] == [False] * (len(want[2]) - 1) + [True]
    assert not any("start [-][-]head" in c for _, c in got[2])
    want_down = [(a, c.replace(JAX_HEAD_FALLBACK, " || true")) for a, c in want[2]]
    for g, w in zip(got[1] + got[2], want[1] + want_down):
        assert g[0] == w[0]
        assert g[1].replace(tmp + "/", "/tmp/") == _jax_renamed(w[1])
    assert len(got[1]) == len(want[1]) and len(got[2]) == len(want[2])
    assert got[0] == want[0]
    assert any("--num-gpus 1" in c or "--num-gpus 8" in c for _, c in got[1])


def _down_patterns(mod, gpu_key):
    _, _, down_calls = _recorded(mod, _configs(gpu_key)[0])
    return sorted({p for _, c in down_calls for p in re.findall(r"pkill -f '([^']+)'", c)})


CMDLINES = {
    "port_head": "python3 -m ray_tpu_torch start --head --num-cpus 2 --num-gpus 0",
    "port_agent": "python3 -m ray_tpu_torch._private.node_agent --address 127.0.0.1:6380 "
                  "--authkey abab --num-cpus 1 --num-gpus 1 --node-id node-lt-0",
    "jax_head": "python3 -m ray_tpu start --head --num-cpus 2 --num-tpus 0",
    "jax_agent": "python3 -m ray_tpu._private.node_agent --address 127.0.0.1:6380 "
                 "--authkey abab --num-cpus 1 --num-tpus 1 --node-id node-lt-0",
}


@pytest.mark.parametrize("side", ["port", "jax"])
def test_down_patterns_match_only_their_own_package(private_tmp, side):
    from ray_tpu.autoscaler import commands as jax_commands

    mod, key = (commands, "num_gpus") if side == "port" else (jax_commands, "num_tpus")
    patterns = _down_patterns(mod, key)
    # the cluster's agents; the JAX package's down adds one for any head,
    # the port's finds its head by the session record alone
    assert len(patterns) == (1 if side == "port" else 2)
    for name, cmdline in CMDLINES.items():
        hits = [p for p in patterns if re.search(p, cmdline)]
        own = name.startswith(side) and (side == "jax" or name.endswith("_agent"))
        assert (len(hits) == 1) == own, (name, hits)


def test_down_kills_a_head_by_its_record_only_if_it_is_the_ports(private_tmp):
    """The head check of ``down`` (the python between the ``PYEOF``
    markers), run against stand-in processes named in the port's record:
    a port head's pid is printed (to be killed), a JAX head's is not, and
    the JAX package's check reads its own record, never the port's."""
    from ray_tpu.autoscaler import commands as jax_commands

    _, _, calls = _recorded(commands, _configs("num_gpus")[0])
    script = re.search(r"<<'PYEOF'\n(.*?)PYEOF", calls[-1][1], re.S).group(1)
    record = os.path.join(private_tmp, "ray_tpu_torch", "last_session.json")
    assert repr(record) in script
    _, _, jax_calls = _recorded(jax_commands, _configs("num_tpus")[0])
    assert "/tmp/ray_tpu/last_session.json" in jax_calls[-1][1] and record not in jax_calls[-1][1]
    os.makedirs(os.path.dirname(record), exist_ok=True)
    for tail, killed in ((("ray_tpu_torch", "start", "--head"), True),
                         (("ray_tpu", "start", "--head"), False)):
        p = _stand_in(*tail)
        try:
            with open(record, "w") as f:
                json.dump({"pid": p.pid}, f)
            out = subprocess.run([sys.executable, "-"], input=script, capture_output=True,
                                 text=True, timeout=T).stdout.split()
            assert out == ([str(p.pid)] if killed else []), tail
        finally:
            p.kill()
            p.wait(timeout=T)
    os.remove(record)


@pytest.mark.parametrize("name", ["no_such_command"])
def test_unregistered_subcommands_exit_with_argparses_error(name, capsys):
    """Every JAX subcommand is registered now (``lint`` was the last);
    a name neither CLI knows exits with argparse's error in both."""
    from ray_tpu.scripts import cli as jax_cli

    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main([name])
        assert e.value.code == 2
        assert f"invalid choice: '{name}'" in capsys.readouterr().err


@pytest.mark.parametrize("name,flags", [("doctor", ["--json", "--live", "--static", "--root"]),
                                        ("top", ["--interval", "--iterations", "--sort"]),
                                        ("memory", ["--limit", "--json"]),
                                        ("metrics", ["--window", "--step", "--agg"]),
                                        ("perf", ["--window", "--json"])])
def test_accounting_subcommands_take_the_jax_packages_flags(name, flags, capsys):
    """``doctor``, ``top``, ``memory``, ``metrics`` and ``perf`` are
    registered with the JAX package's flags (``doctor`` with its
    ``--static``, which runs the port's raylint)."""
    with pytest.raises(SystemExit) as e:
        cli.main([name, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(f in out for f in flags), out
    assert set(re.findall(r"(--[a-z][a-z-]*)", out)) - {"--help"} == _jax_parser_flags(name)


def test_list_takes_only_the_tables_the_head_keeps(capsys):
    """``list`` takes the JAX package's tables (``tenants`` among them,
    now that the head keeps it) and refuses any other."""
    from ray_tpu.scripts import cli as jax_cli

    def choices(main):
        with pytest.raises(SystemExit):
            main(["list", "no_such_table"])
        err = capsys.readouterr().err
        assert "invalid choice: 'no_such_table'" in err
        return set(re.findall(r"[a-z_]+", err.split("choose from", 1)[1]))

    ours = choices(cli.main)
    assert "tenants" in ours and ours == choices(jax_cli.main)


# -- the store commands, held to the JAX package's CLI on the same head --------

def _jax_parser_flags(name):
    """The flags of one JAX subcommand, from its parser's help."""
    from ray_tpu.scripts import cli as jax_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        jax_cli.main([name, "--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", buf.getvalue())) - {"--help"}


@pytest.mark.parametrize("name,cut", [("logs", set()), ("incidents", set()), ("slo", set()),
                                      ("debug", set()), ("slices", set()),
                                      ("profile", set())])
def test_store_subcommands_take_the_jax_packages_flags(name, cut, capsys):
    """``logs``, ``incidents``, ``slo``, ``debug``, ``slices`` and
    ``profile`` take the JAX package's flags (``profile`` with the two of
    on-demand sampling through the dashboard)."""
    with pytest.raises(SystemExit) as e:
        cli.main([name, "--help"])
    assert e.value.code == 0
    ours = set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out)) - {"--help"}
    assert ours == _jax_parser_flags(name) - cut


@pytest.fixture(scope="module")
def store_head(private_tmp):
    """An in-process port head whose stores hold only what the tests put
    there: no continuous profiler, a watchdog that never ticks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_CONT_PROFILE", "0")
        mp.setenv("RAY_TPU_TORCH_WATCHDOG_S", "3600")
        ray_tpu_torch.init(num_cpus=1)
        try:
            from ray_tpu_torch._private.worker import global_worker

            node = global_worker.node
            now = time.time()
            node.profile_store.ingest("head", [{"ts": now, "ticks": 100.0, "busy_ticks": 60.0,
                                                "folded": {"node.py:_handle": 40,
                                                           "pickle.py:dumps": 20,
                                                           "a.py:f|selectors.py:select": 40}}],
                                      {"lateness_frac": 0.1, "interval_s": 2.0,
                                       "period_s": 0.005}, now=now)
            node.profile_store.ingest("w1", [{"ts": now - 120.0, "ticks": 50.0,
                                              "busy_ticks": 50.0,
                                              "folded": {"worker.py:_execute_task|u.py:g": 50}}],
                                      {"interval_s": 2.0, "period_s": 0.005}, now=now)
            node.log_store.ingest("node-x", [
                (now, "worker-aa", "o", "job-0001", "t1", "", "", "alpha line"),
                (now, "worker-aa", "e", "job-0001", "t2", "", "", "beta error"),
                (now, "worker-bb", "W", "job-0002", "", "a9", "tr1", "gamma warning"),
                (now, "job-x", "o", "x", "", "", "", "the job's own line")],
                metas={"worker-aa": {"pid": 11}, "worker-bb": {"pid": 22}}, now=now)
            node.log_store.retire("worker-bb")
            node.watchdog.incidents.observe([
                {"rule": "worker_stderr_at_death", "entity": "cluster", "severity": "ERROR",
                 "summary": "1 worker(s) died", "remedy": "read its tail", "count": 1,
                 "evidence": [{"entity_id": "aa"}]},
                {"rule": "slo:p99", "entity": "p99", "severity": "WARNING",
                 "summary": "SLO p99 burning", "remedy": "", "count": 2, "evidence": []}],
                now=1000.0)
            node.watchdog.incidents.ack("slo:p99--p99", now=1001.0)
            node.add_node_state("s1-h0", {"CPU": 1.0}, slice_id="slice-1")
            node.add_node_state("s1-h1", {"CPU": 1.0}, slice_id="slice-1")
            with node.lock:
                node.nodes["s1-h1"].alive = False
            yield node
        finally:
            ray_tpu_torch.shutdown()


def _jax_cli_over_the_port_head(monkeypatch):
    """The JAX package's CLI, its state API reading the port head through
    the port's client (the wire messages are the same)."""
    from ray_tpu.experimental.state import api as jax_state
    from ray_tpu.scripts import cli as jax_cli
    from ray_tpu_torch.experimental.state import api as state

    monkeypatch.setattr(jax_cli, "_connect", lambda: None)
    monkeypatch.setattr(jax_state, "_client", state._client)
    return jax_cli


def _run(main, argv):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def _drop_ages(text):
    """``profile list``'s rows with their push age (a clock reading) out."""
    rows = json.loads(text)
    return [{k: v for k, v in r.items() if k != "age_s"} for r in rows]


@pytest.mark.parametrize("argv", [
    ["logs"], ["logs", "worker-aa"], ["logs", "--errors"], ["logs", "--grep", "GAMMA"],
    ["logs", "--job", "job-0001"], ["logs", "--actor", "a9"], ["logs", "--pid", "11"],
    ["job-logs", "x"], ["list", "logs"], ["list", "incidents"], ["list", "slos"],
    ["list", "slices"], ["incidents"], ["incidents", "--json"],
    ["incidents", "--history", "worker_stderr_at_death--cluster"], ["slo"], ["slo", "--json"],
    ["slices"], ["slices", "--json"], ["doctor", "--live", "--json"], ["profile", "list"],
    ["profile", "--live"], ["profile", "--live", "--format", "json", "--origin", "w1"],
    ["profile", "diff", "600", "60"], ["profile", "ledger"],
    ["profile", "ledger", "--format", "json"]], ids=lambda a: "_".join(a).replace("-", ""))
def test_store_commands_print_what_the_jax_cli_prints(store_head, monkeypatch, argv):
    """Each command prints what the JAX package's prints, and exits with
    its code, on the same head state."""
    jax_cli = _jax_cli_over_the_port_head(monkeypatch)
    for _ in range(3):  # a time-derived column may tick between the two reads
        ours, ref = _run(cli.main, argv), _run(jax_cli.main, argv)
        if argv[:2] == ["profile", "list"]:
            ours, ref = (ours[0], _drop_ages(ours[1])), (ref[0], _drop_ages(ref[1]))
        if ours == ref:
            break
    assert ours == ref
    assert ours[1], argv


def test_profile_without_a_mode_names_the_dashboard(store_head, monkeypatch):
    """``profile`` without a mode samples on demand through the head's
    dashboard; a head without one is named in the exit."""
    code, out = _run(cli.main, ["profile", "--duration", "0.2"])
    assert code == 0 and json.loads(out)["target"] == "head"
    real = store_head._state_snapshot
    monkeypatch.setattr(store_head, "_state_snapshot", lambda: dict(real(), dashboard=None))
    with pytest.raises(SystemExit, match="dashboard"):
        cli.main(["profile"])


def test_debug_dump_writes_under_the_session(store_head):
    code, out = _run(cli.main, ["debug", "dump", "--label", "cli-dump"])
    path = out.strip()
    assert code == 0 and path == os.path.join(store_head.session_dir, "incidents", "cli-dump")
    assert {"incident.json", "events.json", "memory.json", "logs", "tsdb"} <= set(
        os.listdir(path))
