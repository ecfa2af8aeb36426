"""The port's boundaries: it imports neither JAX nor ray_tpu, its entry
points run on the card unless asked for the CPU, and a CPU call never
counts as a kernel launch."""

import ast
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
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


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


def test_rl_entry_points_raise_without_a_card(no_cuda):
    from ray_tpu_torch import convert
    from ray_tpu_torch.rllib import DQNPolicy, RolloutWorker, SACPolicy, TorchPolicy, models
    from ray_tpu_torch.rllib import DefaultActorCriticModule, synthetic_atari_creator

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
             lambda: convert.from_jax_rl_state({"weights": {}})]
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
