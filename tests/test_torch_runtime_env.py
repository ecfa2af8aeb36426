"""The port's runtime environments against the JAX package's: ``env_vars``,
``working_dir`` and ``py_modules`` packages shipped through the head's KV
(``_private/runtime_env_packaging.py``), ``pip`` venvs and ``conda``
envs built by the worker's bootstrap shim (``_private/runtime_env_setup.py``),
their validation (``_private/ray_option_utils.py``) and the spawn
breaker.

The cases are ``tests/test_runtime_env.py``'s, by name, on a port head.
Nothing is downloaded: ``pip`` installs a wheel built offline with
``--no-index``, and ``conda`` runs through a fake binary.  Beside them,
the functions that start nothing are held to the JAX package's on the
same inputs: ``zip_directory``'s bytes and so the package URI,
``prepare_runtime_env``'s rewrite, ``pip_env_key``, ``conda_env_key``,
``worker_argv`` (equal but for the package's name) and the validation's
errors.  One difference is named: the port's default excludes also drop
``_build``, where it builds its kernels for the local card.

No JAX head starts.  One port head (``num_cpus=4``) serves the module
under a private ``TMPDIR``, so its package cache and venvs live under
that directory's ``ray_tpu_torch/runtime_envs``; one case adds a real
node agent.  Every test has its own time limit and every wait is
bounded.
"""

import io
import os
import signal
import stat
import subprocess
import sys
import tempfile
import time
import zipfile

import pytest

import ray_tpu_torch as rt
from ray_tpu._private import ray_option_utils as jax_opts
from ray_tpu._private import runtime_env_packaging as jax_pkg
from ray_tpu._private import runtime_env_setup as jax_setup
from ray_tpu_torch._private import ray_option_utils as opts
from ray_tpu_torch._private import runtime_env_packaging as pkg
from ray_tpu_torch._private import runtime_env_setup as setup
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

T = 120  # seconds: every get in this file
LIMIT = 150  # seconds: each test's own limit


@pytest.fixture(autouse=True)
def time_limit(request):
    def expired(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old if old is not None else signal.SIG_DFL)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from ray_tpu_torch.cluster_utils import Cluster

    tmp_path_factory.getbasetemp()  # pytest's temp root stays outside the private TMPDIR
    with tempfile.TemporaryDirectory(prefix="renv_") as d, pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", d)
        mp.setattr(tempfile, "tempdir", d)
        c = Cluster(initialize_head=True, real_processes=True,
                    head_node_args={"num_cpus": 4})
        try:
            yield c
        finally:
            c.shutdown()


def _tree(root, files):
    for rel, body in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb" if isinstance(body, bytes) else "w") as f:
            f.write(body)
    return root


# -- test_runtime_env.py's cases ---------------------------------------------


def test_task_sees_env_vars(cluster):
    @rt.remote(runtime_env={"env_vars": {"RTPT_TEST_FLAG": "hello42"}})
    def read_env():
        return os.environ.get("RTPT_TEST_FLAG")

    assert rt.get(read_env.remote(), timeout=T) == "hello42"


def test_task_sees_working_dir(cluster, tmp_path):
    """working_dir is a SNAPSHOT: the tree is packaged, shipped through
    the head's KV, and the worker chdirs into its extracted copy."""
    wd = _tree(str(tmp_path / "wd"), {"data.txt": "snapshot-payload"})

    @rt.remote(runtime_env={"working_dir": wd})
    def read_rel():
        with open("data.txt") as f:
            return f.read(), os.path.realpath(os.getcwd())

    content, cwd = rt.get(read_rel.remote(), timeout=T)
    assert content == "snapshot-payload"
    assert cwd != os.path.realpath(wd)  # the extracted copy, not the live dir
    # the extracted copy sits in the port's cache under this TMPDIR
    assert cwd.startswith(os.path.realpath(pkg.default_base_dir()))


def test_plain_task_not_polluted(cluster):
    """A worker spawned for a runtime_env never serves plain tasks."""
    @rt.remote(runtime_env={"env_vars": {"RTPT_POLLUTION": "yes"}})
    def with_env():
        return os.environ.get("RTPT_POLLUTION")

    @rt.remote
    def plain():
        return os.environ.get("RTPT_POLLUTION")

    assert rt.get(with_env.remote(), timeout=T) == "yes"
    assert rt.get(plain.remote(), timeout=T) is None


def test_actor_runtime_env(cluster, tmp_path):
    wd = _tree(str(tmp_path / "awd"), {"marker.txt": "actor-snapshot"})

    @rt.remote
    class EnvActor:
        def probe(self):
            with open("marker.txt") as f:
                return os.environ.get("RTPT_ACTOR_FLAG"), f.read()

    a = EnvActor.options(runtime_env={"env_vars": {"RTPT_ACTOR_FLAG": "actorenv"},
                                      "working_dir": wd}).remote()
    try:
        assert rt.get(a.probe.remote(), timeout=T) == ("actorenv", "actor-snapshot")
    finally:
        rt.kill(a)


def test_unsupported_runtime_env_key_errors(cluster):
    with pytest.raises(ValueError, match="container"):
        @rt.remote(runtime_env={"container": {"image": "x"}})
        def f():
            pass

    with pytest.raises(TypeError):
        @rt.remote(runtime_env={"env_vars": {"A": 1}})
        def g():
            pass

    with pytest.raises(TypeError):
        @rt.remote(runtime_env={"pip": "requests"})  # not a list
        def h():
            pass


def test_missing_working_dir_errors(cluster):
    with pytest.raises(ValueError, match="working_dir"):
        @rt.remote(runtime_env={"working_dir": "/nonexistent/dir/xyz"})
        def f():
            pass


def test_user_pythonpath_merged_not_clobbered(cluster, tmp_path):
    """A user PYTHONPATH must not break worker boot (merged, not replaced)."""
    wd = _tree(str(tmp_path / "pp"), {"rtpt_pp_probe.py": "VALUE = 'from-user-path'\n"})

    @rt.remote(runtime_env={"env_vars": {"PYTHONPATH": wd}})
    def read():
        import rtpt_pp_probe
        return rtpt_pp_probe.VALUE

    assert rt.get(read.remote(), timeout=T) == "from-user-path"


def test_unspawnable_env_surfaces_error(cluster, tmp_path):
    """A working_dir deleted between validation and submission raises a
    clear error at packaging time, not a task deferred forever."""
    import shutil

    wd = _tree(str(tmp_path / "gone"), {"x": "x"})

    @rt.remote(runtime_env={"working_dir": wd})
    def f():
        return 1

    shutil.rmtree(wd)  # dies between validation and packaging
    with pytest.raises(Exception, match="runtime_env|does not exist"):
        rt.get(f.remote(), timeout=T)


def test_actor_unspawnable_env_surfaces_error(cluster, tmp_path):
    """An actor whose env cannot be packaged raises on creation or its
    first method, and the node keeps running plain tasks."""
    import shutil

    wd = _tree(str(tmp_path / "agone"), {"x": "x"})

    @rt.remote
    class A:
        def ping(self):
            return "up"

    handle = A.options(runtime_env={"working_dir": wd})
    shutil.rmtree(wd)
    with pytest.raises(Exception, match="spawn|died|Actor|does not exist"):
        a = handle.remote()
        rt.get(a.ping.remote(), timeout=T)

    @rt.remote
    def ok():
        return 1

    assert rt.get(ok.remote(), timeout=T) == 1


# -- pip: hash-keyed cached venvs, offline from a local wheel ------------------


@pytest.fixture(scope="module")
def local_wheel(cluster):
    """A tiny wheel built offline, so pip installs a package that is NOT
    in the base environment."""
    src = tempfile.mkdtemp(prefix="rtpt_pkg_")
    _tree(src, {"rtpt_testpkg/__init__.py": "MAGIC = 42\n",
                "pyproject.toml": '[build-system]\nrequires = ["setuptools"]\n'
                                  'build-backend = "setuptools.build_meta"\n'
                                  '[project]\nname = "rtpt-testpkg"\nversion = "1.0"\n'})
    wheels = tempfile.mkdtemp(prefix="rtpt_whl_")
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-index",
                    "--no-build-isolation", "-w", wheels, src],
                   check=True, capture_output=True, timeout=120)
    return wheels


def _pip_env(wheels):
    return {"pip": {"packages": ["rtpt-testpkg"],
                    "pip_install_options": ["--no-index", "--find-links", wheels]}}


def test_pip_runtime_env_installs_package(cluster, local_wheel):
    """The venv's worker imports the wheel's package, and torch and the
    port through the head's PYTHONPATH."""
    with pytest.raises(ImportError):
        import rtpt_testpkg  # noqa: F401 — must be absent from the base env

    @rt.remote(runtime_env=_pip_env(local_wheel))
    def probe():
        import torch

        import rtpt_testpkg

        return rtpt_testpkg.MAGIC, sys.prefix, float(torch.ones(3).sum())

    magic, prefix, total = rt.get(probe.remote(), timeout=T)
    key = setup.pip_env_key(_pip_env(local_wheel)["pip"])
    assert (magic, total) == (42, 3.0)
    assert prefix == os.path.join(pkg.default_base_dir(), f"pip-{key}")


def test_pip_runtime_env_cache_hit(cluster, local_wheel):
    """The same pip spec under a different env key reuses the venv (the
    ready marker is not rebuilt)."""
    env = _pip_env(local_wheel)

    @rt.remote(runtime_env=env)
    def first():
        import rtpt_testpkg

        return rtpt_testpkg.MAGIC

    assert rt.get(first.remote(), timeout=T) == 42
    marker = os.path.join(pkg.default_base_dir(), f"pip-{setup.pip_env_key(env['pip'])}",
                          ".ready")
    assert os.path.exists(marker)
    mtime = os.path.getmtime(marker)

    # different env_vars -> a different worker pool key, the SAME venv
    @rt.remote(runtime_env=dict(env, env_vars={"RTPT_MARK": "two"}))
    def second():
        import rtpt_testpkg

        return rtpt_testpkg.MAGIC, os.environ.get("RTPT_MARK")

    t0 = time.time()
    assert rt.get(second.remote(), timeout=T) == (42, "two")
    assert os.path.getmtime(marker) == mtime, "venv was rebuilt, not reused"
    assert time.time() - t0 < 60, "cache hit should skip the install"


def test_pip_runtime_env_bad_package_fails(cluster):
    @rt.remote(runtime_env={"pip": {"packages": ["definitely-not-a-real-pkg-xyz"],
                                    "pip_install_options": ["--no-index"]}},
               max_retries=0)
    def doomed():
        return 1

    with pytest.raises(Exception, match="runtime_env|died|setup"):
        rt.get(doomed.remote(), timeout=T)


# -- URI packaging (py_modules / working_dir snapshots) and conda --------------


def _module_dir(tmp, name, magic):
    return os.path.dirname(_tree(os.path.join(tmp, name),
                                 {"__init__.py": f"MAGIC = {magic}\n"}) + "/__init__.py")


def test_py_modules_importable(cluster, tmp_path):
    a = _module_dir(str(tmp_path), "rtpt_pymod_a", 7)
    b = _module_dir(str(tmp_path), "rtpt_pymod_b", 8)

    @rt.remote(runtime_env={"py_modules": [a, b]})
    def use_modules():
        import rtpt_pymod_a
        import rtpt_pymod_b

        return rtpt_pymod_a.MAGIC + rtpt_pymod_b.MAGIC

    assert rt.get(use_modules.remote(), timeout=T) == 15


def test_py_modules_snapshot_shipped_via_kv(cluster, tmp_path):
    """The module tree travels as a content-addressed package through the
    head's KV: deleting the source after submission breaks no later
    task (the worker extracts from the KV, not the driver's disk)."""
    import shutil

    env = {"py_modules": [_module_dir(str(tmp_path), "rtpt_pymod_gone", 21)]}

    @rt.remote(runtime_env=env)
    def one():
        import rtpt_pymod_gone

        return rtpt_pymod_gone.MAGIC

    assert rt.get(one.remote(), timeout=T) == 21

    # the identical env after the source is gone hits the driver's
    # prepared-env cache, and the worker still serves it from the KV
    @rt.remote(runtime_env=env)
    def two():
        import rtpt_pymod_gone

        return rtpt_pymod_gone.MAGIC * 2

    shutil.rmtree(str(tmp_path / "rtpt_pymod_gone"))
    assert rt.get(two.remote(), timeout=T) == 42


def test_working_dir_excludes(cluster, tmp_path):
    wd = _tree(str(tmp_path / "wdx"), {"keep.txt": "k", "big_data/blob.bin": "x" * 1000,
                                       "_build/libkernel.so": b"\x7fELF"})

    @rt.remote(runtime_env={"working_dir": wd, "excludes": ["big_data"]})
    def listing():
        return sorted(os.listdir("."))

    names = rt.get(listing.remote(), timeout=T)
    assert "keep.txt" in names and "big_data" not in names and "_build" not in names


def test_packaging_determinism_and_cache(tmp_path):
    src = _tree(str(tmp_path / "src"), {"a.py": "A = 1\n", "__pycache__/junk.pyc": "junk"})
    z1 = pkg.zip_directory(src, top_level=False)
    z2 = pkg.zip_directory(src, top_level=False)
    assert z1 == z2, "zips must be deterministic for content addressing"
    assert pkg.package_uri(z1) == pkg.package_uri(z2)
    assert zipfile.ZipFile(io.BytesIO(z1)).namelist() == ["a.py"]

    calls = []

    def fetch(uri):
        calls.append(uri)
        return z1

    base = str(tmp_path / "cache")
    d1 = pkg.ensure_package_local(fetch, pkg.package_uri(z1), base)
    d2 = pkg.ensure_package_local(fetch, pkg.package_uri(z1), base)
    assert d1 == d2 and len(calls) == 1, "second ensure must hit the cache"
    with open(os.path.join(d1, "a.py")) as f:
        assert f.read() == "A = 1\n"


def test_package_size_limit(tmp_path, monkeypatch):
    src = _tree(str(tmp_path / "big"), {"blob": b"x" * 4096})
    monkeypatch.setattr(pkg, "_SIZE_LIMIT", 1024)
    with pytest.raises(ValueError, match="exceeds"):
        pkg.zip_directory(src, top_level=False)


def test_conda_named_env_with_fake_binary(cluster, tmp_path, monkeypatch):
    """conda resolves an env's python through the conda binary; a fake
    conda (it prints this interpreter) proves the whole spawn path."""
    fake = tmp_path / "conda"
    fake.write_text(f"#!/bin/sh\necho {sys.executable}\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("RAY_TPU_TORCH_CONDA_EXE", str(fake))

    @rt.remote(runtime_env={"conda": "base",
                            "env_vars": {"RAY_TPU_TORCH_CONDA_EXE": str(fake)}})
    def in_conda():
        return os.environ.get("RAY_TPU_TORCH_CONDA_EXE") is not None

    assert rt.get(in_conda.remote(), timeout=T) is True


def test_conda_missing_binary_fails_loudly(monkeypatch):
    monkeypatch.delenv("RAY_TPU_TORCH_CONDA_EXE", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="conda binary"):
        setup.ensure_conda_env("whatever")


def test_conda_plus_pip_rejected(cluster):
    with pytest.raises(ValueError, match="both 'pip' and 'conda'"):
        @rt.remote(runtime_env={"conda": "base", "pip": ["x"]})
        def nope():
            return 1


def test_container_rejected_with_hint(cluster):
    with pytest.raises(ValueError, match="container"):
        @rt.remote(runtime_env={"container": {"image": "img"}})
        def nope():
            return 1


def test_package_setup_failure_trips_breaker(cluster):
    """A worker that cannot materialise its packages dies BEFORE it
    registers (exit 77), so the spawn breaker fails the task instead of
    respawning forever.  Its package is missing from the head's KV, so
    every respawn fails to extract it."""
    missing = pkg.package_uri(b"a package no driver uploaded")

    @rt.remote(runtime_env={"working_dir": missing}, max_retries=0)
    def doomed():
        return 1

    with pytest.raises(Exception, match="runtime_env|died|setup|spawn"):
        rt.get(doomed.remote(), timeout=T)


# -- the same envs on a node agent ---------------------------------------------


def test_an_agent_worker_gets_the_same_envs(cluster, local_wheel, tmp_path):
    """A node agent starts a pip env's worker through the same shim and
    PYTHONPATH as the head (it imports the wheel and torch), and a
    working_dir worker extracts its package from the head's KV."""
    node = cluster.add_node(num_cpus=2)
    try:
        on_agent = NodeAffinitySchedulingStrategy(node)
        wd = _tree(str(tmp_path / "agent_wd"), {"data.txt": "agent-payload"})

        @rt.remote(runtime_env=_pip_env(local_wheel), scheduling_strategy=on_agent)
        def pip_probe():
            import torch

            import rtpt_testpkg

            return (rt.get_runtime_context().node_id, rtpt_testpkg.MAGIC,
                    float(torch.ones(2).sum()))

        @rt.remote(runtime_env={"working_dir": wd}, scheduling_strategy=on_agent)
        def wd_probe():
            with open("data.txt") as f:
                return rt.get_runtime_context().node_id, f.read()

        assert rt.get(pip_probe.remote(), timeout=T) == (node, 42, 2.0)
        assert rt.get(wd_probe.remote(), timeout=T) == (node, "agent-payload")
    finally:
        cluster.remove_node(node)


# -- parity with the JAX package's functions that start nothing -----------------


class _KV:
    """A head's KV as ``prepare_runtime_env`` sees it (the client's
    ``kv_get``/``kv_put``)."""

    def __init__(self):
        self.data = {}

    def kv_get(self, ns, key, timeout=None):
        return self.data.get((ns, key))

    def kv_put(self, ns, key, value):
        self.data[(ns, key)] = value


_TREE = {"a.py": "A = 1\n", "pkg/__init__.py": "", "pkg/mod.py": "B = [1, 2]\n",
         "data/rows.csv": "x,y\n1,2\n", "run.sh": "#!/bin/sh\necho hi\n",
         "__pycache__/a.cpython-312.pyc": b"\x00junk", ".git/HEAD": "ref: main\n",
         "notes.pyc": b"\x01"}


@pytest.mark.parametrize("top_level,excludes", [(False, ()), (True, ()), (False, ("data",)),
                                                (True, ("*.sh", "pkg/mod.py"))])
def test_zip_directory_gives_the_jax_bytes_and_uri(tmp_path, top_level, excludes):
    src = _tree(str(tmp_path / "tree"), _TREE)
    os.chmod(os.path.join(src, "run.sh"), 0o755)
    port = pkg.zip_directory(src, top_level=top_level, excludes=excludes)
    ref = jax_pkg.zip_directory(src, top_level=top_level, excludes=excludes)
    assert port == ref
    assert pkg.package_uri(port) == jax_pkg.package_uri(ref)


def test_the_build_directory_is_the_one_difference_in_the_default_excludes(tmp_path):
    """The port also leaves ``_build`` out of a package, where the JAX
    package would ship it: on a tree with one, the port's zip equals the
    JAX zip with ``_build`` excluded by hand."""
    src = _tree(str(tmp_path / "ray_tpu_torch"),
                {"__init__.py": "", "_build/libflash_fwd.so": b"\x7fELF" * 64,
                 "ops/__init__.py": "", "ops/__pycache__/x.pyc": b"\x00"})
    port = pkg.zip_directory(src, top_level=True)
    assert "ray_tpu_torch/_build/libflash_fwd.so" in zipfile.ZipFile(
        io.BytesIO(jax_pkg.zip_directory(src, top_level=True))).namelist()
    assert port == jax_pkg.zip_directory(src, top_level=True, excludes=("_build",))
    assert zipfile.ZipFile(io.BytesIO(port)).namelist() == [
        "ray_tpu_torch/__init__.py", "ray_tpu_torch/ops/__init__.py"]


def test_prepare_runtime_env_rewrites_as_the_jax_function_does(tmp_path):
    wd = _tree(str(tmp_path / "wd"), {"main.py": "print(1)\n", "big.bin": b"x" * 100})
    mod = _tree(str(tmp_path / "helper_mod"), {"__init__.py": "H = 3\n"})
    env = {"working_dir": wd, "py_modules": [mod, "gcs://pkg-already.zip"],
           "excludes": ["big.bin"], "env_vars": {"A": "1"}}
    port_kv, jax_kv = _KV(), _KV()
    port = pkg.prepare_runtime_env(env, port_kv)
    ref = jax_pkg.prepare_runtime_env(env, jax_kv)
    assert port == ref and port_kv.data == jax_kv.data
    assert port["py_modules"][1] == "gcs://pkg-already.zip" and port["env_vars"] == {"A": "1"}
    # the same tree again uploads nothing new
    before = dict(port_kv.data)
    assert pkg.prepare_runtime_env(env, port_kv) == port and port_kv.data == before


@pytest.mark.parametrize("spec", [["requests==2.0"], ["b", "a"],
                                  {"packages": ["x"], "pip_install_options": ["--no-index"]},
                                  {"packages": []}])
def test_pip_env_key_matches_jax(spec):
    assert setup.pip_env_key(spec) == jax_setup.pip_env_key(spec)
    assert setup.parse_pip_spec(spec) == jax_setup.parse_pip_spec(spec)


@pytest.mark.parametrize("spec", ["base", {"dependencies": ["python=3.12", "numpy"]},
                                  {"name": "e", "channels": ["c"]}])
def test_conda_env_key_matches_jax(spec):
    assert setup.conda_env_key(spec) == jax_setup.conda_env_key(spec)


@pytest.mark.parametrize("pip,conda", [(None, None), (["x"], None), (None, "base"),
                                       ({"packages": ["y"]}, None),
                                       (None, {"dependencies": ["numpy"]})])
def test_worker_argv_matches_jax_but_for_the_package_name(pip, conda):
    ref = [a.replace("ray_tpu._private.", "ray_tpu_torch._private.")
           for a in jax_setup.worker_argv(pip, conda)]
    assert setup.worker_argv(pip, conda) == ref


@pytest.mark.parametrize("env", [
    {"container": {"image": "x"}}, {"env_vars": {"A": 1}}, {"pip": "requests"},
    {"working_dir": "/nonexistent/xyz"}, {"py_modules": "not-a-list"},
    {"py_modules": ["/nonexistent/m"]}, {"excludes": "x"}, {"conda": "base", "pip": ["x"]},
    {"conda": 3}, {"pip": {"packages": ["x"], "bogus": 1}}, {"pip": {"packages": "x"}},
    {"env_vars": {"A": "1"}, "pip": ["x"], "excludes": ["*.bin"]},
    {"py_modules": ["gcs://pkg-abc.zip"], "working_dir": "gcs://pkg-def.zip"}])
def test_validation_matches_jax(env):
    def outcome(fn):
        try:
            return ("ok", fn(env))
        except (TypeError, ValueError) as e:
            return (type(e).__name__, str(e).replace("TPU image", "card hosts"))
    port, ref = outcome(opts.validate_runtime_env), outcome(jax_opts.validate_runtime_env)
    assert port[0] == ref[0], (port, ref)
    if port[0] == "ok":
        assert port == ref


def test_pins_keep_a_package_from_the_cache_gc_until_their_process_ends(tmp_path):
    """``ensure_package_local`` pins the extracted dir to this process;
    the cache's GC evicts only unpinned packages, and a pin moved to a
    process (``repin``) lasts as long as that process."""
    blobs = [pkg.zip_directory(_tree(str(tmp_path / f"s{i}"), {"f": str(i) * 2000}),
                               top_level=False) for i in range(2)]
    base = str(tmp_path / "cache")
    dirs = [pkg.ensure_package_local(lambda u, b=b: b, pkg.package_uri(b), base,
                                     pin_suffix="job")
            for b in blobs]
    pkg._gc_cache(base, limit=1)
    assert all(os.path.isdir(d) for d in dirs)  # both pinned by this process
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        pkg.repin(dirs[0], child.pid, suffix="job")
        pkg.unpin(dirs[1], suffix="job")
        pkg._gc_cache(base, limit=1)
        assert os.path.isdir(dirs[0]) and not os.path.exists(dirs[1])
    finally:
        child.kill()
        child.wait()
    pkg._gc_cache(base, limit=1)  # the pinning process is gone
    assert not os.path.exists(dirs[0])
