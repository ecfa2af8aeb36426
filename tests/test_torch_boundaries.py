"""The port's boundaries: it imports neither JAX nor ray_tpu, its entry
points run on the card unless asked for the CPU, and a CPU call never
counts as a kernel launch."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as ta

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "ray_tpu")


def _port_sources():
    return sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_ray_tpu():
    sources = _port_sources()
    assert len(sources) >= 12
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in sources
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.convert, ray_tpu_torch.serve.llm\n"
        "import ray_tpu_torch.models.generate, ray_tpu_torch.ops.attention\n"
        "import ray_tpu_torch.models.bert, ray_tpu_torch.models.mlp, ray_tpu_torch.ops.moe\n"
        "import ray_tpu_torch.air, ray_tpu_torch.train\n"
        "import ray_tpu_torch.data, ray_tpu_torch.train.data_config\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_importing_tune_and_rllib_loads_neither_jax_nor_ray_tpu():
    """Tune and RLlib with APPO, offline IO and multi-agent load neither
    JAX nor ray_tpu, and start no runtime."""
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.tune, ray_tpu_torch.tune.search\n"
        "import ray_tpu_torch.rllib, ray_tpu_torch.rllib.appo, ray_tpu_torch.rllib.offline\n"
        "import ray_tpu_torch.rllib.multi_agent, ray_tpu_torch.air.remote_storage\n"
        "from ray_tpu_torch.tune import Tuner, TPESearcher, PopulationBasedTraining\n"
        "from ray_tpu_torch.rllib import APPO, JsonReader, JsonWriter, MultiAgentPPO\n"
        "from ray_tpu_torch._private import worker\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert not ray_tpu_torch.is_initialized()\n"
        "assert worker.global_worker.client is None\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_node_agent_and_its_workers_load_neither_jax_nor_ray_tpu():
    """A subprocess starts a port head and a real node agent
    (``python -m ray_tpu_torch._private.node_agent`` through
    ``cluster_utils.Cluster``), runs a task on the agent's node and an
    autoscaler pass: with ``PYTHONPROFILEIMPORTTIME`` in the agent's env,
    every module the agent imports is listed on stderr, and none is JAX's
    or ray_tpu's; the task's worker reports its own modules, and the
    subprocess itself loads neither."""
    code = (
        "import sys\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch.autoscaler import LocalNodeProvider, StandardAutoscaler\n"
        "from ray_tpu_torch._private.worker import global_worker\n"
        "from ray_tpu_torch.cluster_utils import Cluster\n"
        "from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy\n"
        "c = Cluster(head_node_args={'num_cpus': 1, 'num_gpus': 0}, real_processes=True)\n"
        "try:\n"
        "    b = c.add_node(num_cpus=1, env={'PYTHONPROFILEIMPORTTIME': '1'})\n"
        "    f = ray_tpu_torch.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(b))(\n"
        "        lambda: (ray_tpu_torch.get_runtime_context().node_id,\n"
        "                 [m for m in sys.modules if m.split('.')[0] in %r]))\n"
        "    assert ray_tpu_torch.get(f.remote(), timeout=120) == (b, [])\n"
        "    head = global_worker.node\n"
        "    StandardAutoscaler(head, LocalNodeProvider(head)).update()\n"
        "finally:\n"
        "    c.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=240,
                         capture_output=True, text=True)
    loaded = {line.rsplit("|", 1)[1].strip() for line in out.stderr.splitlines()
              if line.startswith("import time:") and "|" in line}
    # the agent's own modules were listed
    assert {"ray_tpu_torch._private.syncer", "ray_tpu_torch._private.object_transfer",
            "ray_tpu_torch._private.log_plane"} <= loaded, sorted(loaded)[:50]
    bad = sorted(m for m in loaded if m.split(".")[0] in FORBIDDEN)
    assert not bad, bad


def _module_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_rllib_port_needs_no_gymnasium():
    """The card's machine has no gymnasium: no file of the port imports it
    at module level (``RolloutWorker`` imports it only to make a named
    env), and importing every RL module and chip_smoke.py loads neither
    it nor JAX nor ray_tpu."""
    rl = sorted((ROOT / "ray_tpu_torch" / "rllib").rglob("*.py"))
    assert len(rl) >= 17
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in _port_sources()
           for m in _module_level_imports(p) if m.split(".")[0] in (*FORBIDDEN, "gymnasium")]
    assert not bad, bad
    mods = ["ray_tpu_torch.rllib." + p.relative_to(ROOT / "ray_tpu_torch" / "rllib")
            .with_suffix("").as_posix().replace("/", ".").replace(".__init__", "")
            for p in rl if p.name != "__init__.py" or p.parent.name == "connectors"]
    code = (
        "import sys, importlib\n"
        "sys.path.insert(0, '.')\n"
        "for m in %r + ['chip_smoke', 'ray_tpu_torch.util.tree']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (mods, (*FORBIDDEN, "gymnasium")))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_the_card_and_never_falls_back(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(no_cuda):
    from ray_tpu_torch.convert import from_jax_params
    from ray_tpu_torch.models import bert, generate, gpt2, llama, mlp
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config
    from ray_tpu_torch.train import TorchPredictor

    cfg = make_config("gpt2", "tiny")
    calls = [lambda: GenerationEngine(cfg),
             lambda: gpt2.init(cfg),
             lambda: llama.init(llama.LlamaConfig.tiny()),
             lambda: generate.init_cache(cfg, 2, 8),
             lambda: from_jax_params({}, cfg),
             lambda: bert.init(bert.BertConfig.tiny()),
             lambda: mlp.init(mlp.MLPConfig()),
             lambda: TorchPredictor({}, lambda p, b: b),
             lambda: moe.init_moe_params(torch.Generator(), 1, 8, 16, 2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


class _Space:
    shape, n = (3,), 2


def _two_agent_env(config):
    """A MultiAgentEnv stub: spaces and agent ids are all a worker reads
    before it builds its policies."""
    from ray_tpu_torch.rllib import MultiAgentEnv

    env = MultiAgentEnv()
    env.agents = ["a"]
    env.observation_space = env.action_space = lambda agent: _Space()
    env.reset = lambda **kw: ({"a": torch.zeros(3).numpy()}, {})
    return env


def test_rl_entry_points_raise_without_a_card(no_cuda):
    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib import DQNPolicy, RolloutWorker, SACPolicy, TorchPolicy, models
    from ray_tpu_torch.rllib import (APPOConfig, DefaultActorCriticModule,
                                     MultiAgentPPOConfig, MultiAgentRolloutWorker,
                                     synthetic_atari_creator)

    ma = dict(MultiAgentPPOConfig().environment(env_creator=_two_agent_env)
              .multi_agent(policies=["p"], policy_mapping_fn=lambda a: "p").to_dict())

    g = torch.Generator()
    calls = [lambda: TorchPolicy(4, 2),
             lambda: DQNPolicy(4, 2),
             lambda: SACPolicy(3, 1),
             lambda: RolloutWorker({"env_creator": synthetic_atari_creator}),
             lambda: DefaultActorCriticModule(4, 2).init(g),
             lambda: models.init_actor_critic(g, 4, 2),
             lambda: models.init_conv_actor_critic(g, (84, 84, 4), 6),
             lambda: models.init_gaussian_actor(g, 3, 1),
             lambda: models.init_q_network(g, 3, 1),
             lambda: convert.from_jax_rl_params({}),
             lambda: convert.from_jax_rl_state({"weights": {}}),
             lambda: APPOConfig().environment(env_creator=synthetic_atari_creator).build(),
             lambda: ma["_algo_class"](config=ma),
             lambda: MultiAgentRolloutWorker(ma)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_flash_wrapper_on_cpu_counts_no_launch():
    """Neither design counts on a CPU tensor: f32 at D 16, and bf16 at
    D 64, which the card runs on the tensor cores (``DKV_TC`` and the
    other tensor-core counters)."""
    before = dict(_build.launches)
    for dtype, d in ((torch.float32, 16), (torch.bfloat16, 64)):
        q = torch.randn(1, 2, 8, d).to(dtype)
        out, lse = ta.flash_attention(q, q, q, True)
        ta.attention(q, q, q, causal=True)
        delta = (out.float() * q.float()).sum(-1)
        dq = ta.flash_bwd_dq(q, q, q, q, lse, delta, True)
        dk, dv = ta.flash_bwd_dkv(q, q, q, q, lse, delta, True)
        assert out.shape == dq.shape == dk.shape == dv.shape == q.shape
        assert lse.shape == q.shape[:3]
    assert dict(_build.launches) == before


def test_reset_launches_zeroes_every_count():
    names = ("probe", *ta.TENSOR_CORE_COUNTER, *ta.TENSOR_CORE_COUNTER.values())
    assert ta.DKV_TC in names
    for name in names:
        _build.count_launch(name)
        assert _build.launches[name] >= 1
    _build.reset_launches()
    assert all(n == 0 for n in _build.launches.values())
    del _build.launches["probe"]


def test_kernel_sources_are_named_by_their_hash():
    """A build is keyed on the source and the flags, so an edited kernel
    is rebuilt and an unchanged one reused (nothing is compiled here)."""
    path = _build.library_path(ta.KERNEL)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{ta.KERNEL}_") and path.suffix == ".so"
    assert (_build.CSRC / f"{ta.KERNEL}.cu").exists()


def test_an_edited_header_names_a_new_library(tmp_path, monkeypatch):
    """Every source may include any header under csrc/, so the library's
    name covers the headers too: editing one builds anew instead of
    reusing a stale library (nothing is compiled here)."""
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("kern")
    assert _build.library_path("kern") == first
    header.write_text("// v2\n")
    assert _build.library_path("kern") != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert len({first, _build.library_path("kern")}) == 2


def test_parallel_layer_loads_neither_jax_nor_ray_tpu():
    """Nor ``transformers``, which only ``bert.from_hf`` imports, when
    called (the card's machine has none); chip_smoke.py included."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.collective\n"
        "import ray_tpu_torch.parallel.dryrun, ray_tpu_torch.parallel.spawn\n"
        "import ray_tpu_torch.ops.ring_attention, ray_tpu_torch.util.profiling\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r + ('transformers',)]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_parallel_entry_points_raise_without_a_card(no_cuda):
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.parallel import MeshSpec, create_mesh, init_world, local_mesh
    from ray_tpu_torch.parallel.dryrun import dryrun_multichip
    from ray_tpu_torch.parallel.spawn import run_world

    calls = [lambda: init_world(), lambda: create_mesh(MeshSpec()), lambda: local_mesh(),
             lambda: run_world(print, 2), lambda: dryrun_multichip(2),
             lambda: bert.from_hf("no-such-checkpoint")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_two_processes_build_a_library_once(tmp_path):
    """Two processes that load the same kernel at once (Train workers
    beside their driver) compile it once: the build holds a lock on the
    build directory, and the second finds the library built.  A stand-in
    compiler takes nvcc's place (none here): it counts its runs, sleeps,
    and writes the ``-o`` file."""
    csrc, build_dir, runs = tmp_path / "csrc", tmp_path / "build", tmp_path / "runs"
    csrc.mkdir()
    (csrc / "kern.cu").write_text("// kernel\n")
    fake_nvcc = tmp_path / "fake_nvcc"
    fake_nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(runs)!r}, 'a').write('run\\n')\n"
        "time.sleep(1.0)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    fake_nvcc.chmod(0o755)
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from ray_tpu_torch.ops import _build\n"
        "_build.CSRC, _build.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])\n"
        "_build._nvcc = lambda: sys.argv[3]\n"
        "out = _build.build(['kern'])['kern']\n"
        "print(out['seconds'] > 0, _build.library_path('kern'))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(csrc), str(build_dir),
                               str(fake_nvcc)], cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert sorted(o[0] for o in outs) == ["False", "True"]  # one compiled, one waited
    assert outs[0][1] == outs[1][1] and pathlib.Path(outs[0][1]).read_bytes() == b"lib"
    assert runs.read_text() == "run\n"
    assert [p.name for p in build_dir.iterdir() if p.suffix == ".so"] == [pathlib.Path(outs[0][1]).name]


def test_runtime_core_loads_neither_jax_nor_ray_tpu_and_starts_nothing():
    """The copied runtime (``_private/``, the core API, Train, the
    collective group, the step profiler) imports no JAX and nothing of
    ``ray_tpu``, and importing it starts no thread and no process."""
    code = (
        "import sys, threading\n"
        "import ray_tpu_torch\n"
        "assert 'ray_tpu_torch._api' not in sys.modules  # the core API loads on first use\n"
        "ray_tpu_torch.remote\n"
        "import ray_tpu_torch._private.node, ray_tpu_torch._private.worker\n"
        "import ray_tpu_torch._private.forkserver, ray_tpu_torch._private.native\n"
        "import ray_tpu_torch.protocol, ray_tpu_torch.util.metrics\n"
        "import ray_tpu_torch.train, ray_tpu_torch.train.torch_utils, ray_tpu_torch.air\n"
        "import ray_tpu_torch.util.perf, ray_tpu_torch.util.collective\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_serve_and_dag_load_neither_jax_nor_ray_tpu_and_start_nothing():
    """Serve (the controller, router, replica, proxy, batching, the LLM
    deployment) and the compiled graph import no JAX and nothing of
    ``ray_tpu``; importing them starts no thread and makes no CUDA
    context."""
    code = (
        "import sys, threading, torch\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.llm, ray_tpu_torch.serve.schema\n"
        "import ray_tpu_torch.serve._private.controller, ray_tpu_torch.serve._private.router\n"
        "import ray_tpu_torch.serve._private.replica, ray_tpu_torch.serve._private.http_proxy\n"
        "import ray_tpu_torch.dag, ray_tpu_torch.dag.compiled, ray_tpu_torch.dag.channel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_data_loads_neither_jax_nor_arrow_and_starts_nothing():
    """Data (blocks, the plan, the readers, the shuffles, the streaming
    executor, ``DataConfig``, ``BatchPredictor``) imports no JAX and
    nothing of ``ray_tpu``, loads neither pyarrow nor pandas (the card's
    machine has neither), and importing it starts no thread and makes no
    CUDA context."""
    code = (
        "import sys, threading, torch\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.shuffle, ray_tpu_torch.data.datasource\n"
        "import ray_tpu_torch.data._streaming, ray_tpu_torch.data.dataset_pipeline\n"
        "import ray_tpu_torch.train.data_config, ray_tpu_torch.train.predictor\n"
        "from ray_tpu_torch.data import BlockAccessor\n"
        "BlockAccessor({'value': [1, 2]}).to_rows(); BlockAccessor.concat([[1], [2]])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r + ('pyarrow', 'pandas')]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_operator_plane_loads_neither_jax_nor_ray_tpu_and_starts_nothing():
    """The CLI, the job manager and client, the state API, the timeline
    and ``up``/``down`` import no JAX and nothing of ``ray_tpu``;
    importing them starts no thread and makes no CUDA context, and
    ``python -m ray_tpu_torch --help`` prints its subcommands the same
    way."""
    code = (
        "import sys, threading, torch\n"
        "import ray_tpu_torch.scripts.cli, ray_tpu_torch.job_submission\n"
        "import ray_tpu_torch._private.job_manager, ray_tpu_torch.experimental\n"
        "import ray_tpu_torch.experimental.state, ray_tpu_torch.experimental.state.api\n"
        "import ray_tpu_torch.util.timeline, ray_tpu_torch.autoscaler.commands\n"
        "import runpy\n"
        "sys.argv = ['ray_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('ray_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                         capture_output=True, text=True)
    assert "{start,up,down,stop,status,list,submit,job-logs,logs,job-stop,timeline," \
           "events,trace,serve-status,serve-deploy,doctor,incidents,slo,debug,lint,top,slices,memory," \
           "metrics,perf,profile}" in out.stdout


NEW_STORE_MODULES = ("ray_tpu_torch._private.sampling_profiler", "ray_tpu_torch.util.profile_store",
                     "ray_tpu_torch.util.log_store", "ray_tpu_torch.util.trace_analysis",
                     "ray_tpu_torch.util.incidents", "ray_tpu_torch.util.watchdog",
                     "ray_tpu_torch.autoscaler.policy")


def test_observability_stores_load_neither_jax_nor_ray_tpu_and_start_nothing():
    """The sampling profiler, the profile, log and incident stores, the
    trace analysis, the watchdog and the trend autoscaler (and the timed
    locks under them) import no JAX and nothing of ``ray_tpu``; importing
    them, and making a lock, starts no thread and makes no CUDA context.
    Each has a counterpart of the same name in the JAX package."""
    for mod in NEW_STORE_MODULES:
        rel = mod.replace(".", "/") + ".py"
        assert (ROOT / rel).is_file() and (ROOT / rel.replace("ray_tpu_torch/", "ray_tpu/", 1)
                                           ).is_file(), rel
    code = (
        "import sys, threading, torch\n"
        "import %s\n"
        "from ray_tpu_torch._private.locks import make_lock\n"
        "make_lock('a.b'), make_lock('c.d', rlock=True)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n" % (", ".join(NEW_STORE_MODULES), FORBIDDEN))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_util_libraries_and_accounting_load_neither_jax_nor_ray_tpu_and_start_nothing():
    """The util libraries (``ActorPool``, ``queue``, ``multiprocessing``,
    ``pubsub``), the metrics store, the doctor and the ``/proc`` sampler
    import no JAX and nothing of ``ray_tpu``; importing them starts no
    thread, no process and no runtime, and makes no CUDA context.  The
    joblib backend raises ``ImportError`` where joblib is missing, as
    the JAX package's does (the card's machine has none)."""
    code = (
        "import sys, threading, torch\n"
        "import ray_tpu_torch.util, ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.queue\n"
        "import ray_tpu_torch.util.multiprocessing, ray_tpu_torch.util.pubsub\n"
        "import ray_tpu_torch.util.tsdb, ray_tpu_torch.util.doctor, ray_tpu_torch.util.metrics\n"
        "from ray_tpu_torch.util import ActorPool\n"
        "from ray_tpu_torch._private.resource_spec import ProcSampler, host_stats\n"
        "from ray_tpu_torch._private import worker\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert worker.global_worker.client is None\n"
        "sys.modules['joblib'] = None\n"
        "try:\n"
        "    import ray_tpu_torch.util.joblib\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('the joblib backend imported without joblib')\n"
        % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


DURABILITY_MODULES = ("ray_tpu_torch._private.gcs_storage", "ray_tpu_torch._private.usage",
                      "ray_tpu_torch._private.runtime_env_packaging",
                      "ray_tpu_torch._private.runtime_env_setup", "ray_tpu_torch.workflow",
                      "ray_tpu_torch.workflow.api")


def test_runtime_envs_persistence_usage_and_workflows_load_nothing_and_start_nothing(tmp_path):
    """The GCS store, the usage report, the runtime-env packaging and
    setup, and workflows import no JAX and nothing of ``ray_tpu``;
    importing them starts no thread, makes no CUDA context and writes no
    file (their caches and roots are made at first use, under the port's
    session root).  Each has a counterpart of the same name in the JAX
    package."""
    for mod in DURABILITY_MODULES:
        rel = mod.replace(".", "/")
        rel = rel + "/__init__.py" if (ROOT / rel).is_dir() else rel + ".py"
        assert (ROOT / rel).is_file() and (ROOT / rel.replace("ray_tpu_torch/", "ray_tpu/", 1)
                                           ).is_file(), rel
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = (
        "import sys, threading, torch\n"
        "import %s\n"
        "from ray_tpu_torch._private import runtime_env_packaging as p\n"
        "from ray_tpu_torch.workflow import api\n"
        "assert p.default_base_dir().startswith(%r) and api._root().startswith(%r)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        % (", ".join(DURABILITY_MODULES), str(tmp), str(tmp), FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "RAY_TPU_TORCH_WORKFLOW_STORAGE"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**env, "TMPDIR": str(tmp)})
    assert list(tmp.iterdir()) == []


FRONT_DOOR_MODULES = ("ray_tpu_torch.util.client", "ray_tpu_torch.util.client.driver",
                      "ray_tpu_torch.util.client.proxier", "ray_tpu_torch.devtools",
                      "ray_tpu_torch.devtools.chaos", "ray_tpu_torch.devtools.chaos.harness",
                      "ray_tpu_torch.dashboard", "ray_tpu_torch.dashboard.dashboard",
                      "ray_tpu_torch.dashboard.grafana_dashboard_factory")


def test_front_doors_load_nothing_and_start_nothing(tmp_path):
    """The thin client's proxy and tenant driver, the chaos harness and
    the dashboard import no JAX and nothing of ``ray_tpu``; importing
    them starts no thread, binds no socket, makes no CUDA context and
    writes no file.  Each has a counterpart of the same name in the JAX
    package."""
    for mod in FRONT_DOOR_MODULES:
        rel = mod.replace(".", "/")
        rel = rel + "/__init__.py" if (ROOT / rel).is_dir() else rel + ".py"
        assert (ROOT / rel).is_file() and (ROOT / rel.replace("ray_tpu_torch/", "ray_tpu/", 1)
                                           ).is_file(), rel
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = (
        "import sys, threading, torch\n"
        "import %s\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        % (", ".join(FRONT_DOOR_MODULES), FORBIDDEN))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "TMPDIR": str(tmp)})
    assert list(tmp.iterdir()) == []


LAST_SLICE_MODULES = ("ray_tpu_torch._private.ray_perf", "ray_tpu_torch.train",
                      "ray_tpu_torch.train.sklearn_trainer", "ray_tpu_torch.autoscaler.gcp_gpu",
                      "ray_tpu_torch.devtools.raylint", "ray_tpu_torch.devtools.raylint.core",
                      "ray_tpu_torch.devtools.raylint.runner",
                      "ray_tpu_torch.devtools.raylint.lockwitness",
                      "ray_tpu_torch.scripts.cli")

# JAX module -> the port's counterpart, where the name differs
RENAMED = {"train/jax_utils.py": "train/torch_utils.py",
           "protocol/ray_tpu_pb2.py": "protocol/ray_tpu_torch_pb2.py",
           "autoscaler/gcp_tpu.py": "autoscaler/gcp_gpu.py"}


def test_every_jax_module_has_a_counterpart():
    """Comparing the two packages' ``*.py`` lists leaves only the three
    JAX modules whose counterparts have other names."""
    def rel(pkg):
        return {p.relative_to(ROOT / pkg).as_posix() for p in (ROOT / pkg).rglob("*.py")
                if "_build" not in p.parts}

    jax_mods, ours = rel("ray_tpu"), rel("ray_tpu_torch")
    assert sorted(jax_mods - ours) == sorted(RENAMED)
    assert set(RENAMED.values()) <= ours


def test_last_slice_loads_nothing_and_starts_nothing(tmp_path):
    """The microbenchmark harness, the sklearn trainer, the card-host
    provider and raylint import no JAX, nothing of ``ray_tpu`` and no
    scikit-learn (``import ray_tpu_torch.train`` works where it is
    missing); importing them, the lock witness included, starts no
    thread, makes no CUDA context and writes no file."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    code = (
        "import sys, threading, torch\n"
        "import %s\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r + ('sklearn',)]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        % (", ".join(LAST_SLICE_MODULES), FORBIDDEN))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "TMPDIR": str(tmp)})
    assert list(tmp.iterdir()) == []
