"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` into ``ray_tpu_torch/_build/lib<name>_<hash>.so`` at first use,
then loaded with ``ctypes``.  The hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header builds
anew and an unchanged one is reused.  Nothing
is built or loaded when this module is imported: the CPU tests import
every module on a host with no ``nvcc``.

Every kernel wrapper adds one to ``launches[name]`` where it launches its
kernel and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    for name in list(launches):
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    every header under ``csrc/`` (a source may include any of them) and
    the flags, so an edit to any of them builds anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str], *, ptxas_verbose: bool = False
          ) -> Dict[str, Dict[str, object]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: {"seconds",
    "log"}}`` (``seconds`` 0.0 and ``log`` "" for a library already
    built).  Raises ``RuntimeError`` with the compiler's output on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out: Dict[str, Dict[str, object]] = {}
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
