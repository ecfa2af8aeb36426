"""runtime_env URI packaging: ship local code to every node.

Reference counterpart: ``python/ray/_private/runtime_env/packaging.py``
(zip local dirs into content-addressed packages, upload to the GCS KV,
download+extract into a node-local cache) and ``uri_cache.py`` (the
size-capped cache GC).

Flow:

- driver: ``prepare_runtime_env`` rewrites ``working_dir``/``py_modules``
  local paths into ``gcs://pkg-<sha1>.zip`` URIs, uploading each zip to
  the head KV (namespace ``pkg``) once — content addressing dedups
  re-submits of the same tree.
- worker: ``ensure_package_local`` downloads + extracts a URI into
  ``default_base_dir()/pkg-<sha1>/`` (under the port's session root)
  exactly once per node
  (fcntl-serialized, ``.ready``-marked, same pattern as the pip venv
  cache), then the worker chdirs into it (working_dir) or prepends it to
  ``sys.path`` (py_modules).

Zips are deterministic (sorted entries, zeroed timestamps) so the same
tree always produces the same URI.
"""

from __future__ import annotations

import fcntl
import fnmatch
import hashlib
import io
import os
import shutil
import time
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import session_root

PKG_URI_PREFIX = "gcs://"
PKG_KV_NAMESPACE = "pkg"

# Always excluded from packages, on top of runtime_env["excludes"]: the
# JAX package's list, and ``_build``, where the port builds its kernels
# for the card it runs on (``ops/_build.py``) — host-specific binaries
# that never belong in a shipped package.
_DEFAULT_EXCLUDES = ("__pycache__", "*.pyc", ".git", ".hg", ".DS_Store",
                     "_build")

_SIZE_LIMIT = 256 * 1024 * 1024
_CACHE_LIMIT = 10 * 1024 * 1024 * 1024


def default_base_dir() -> str:
    """The node-local cache of extracted packages (and of pip/conda envs,
    ``runtime_env_setup.py``): under the port's session root, never the
    JAX package's ``/tmp/ray_tpu``."""
    return os.path.join(session_root(), "runtime_envs")


def is_package_uri(s: object) -> bool:
    return isinstance(s, str) and s.startswith(PKG_URI_PREFIX)


def _excluded(rel: str, patterns: Tuple[str, ...]) -> bool:
    parts = rel.split(os.sep)
    for pat in patterns:
        if any(fnmatch.fnmatch(p, pat) for p in parts):
            return True
        if fnmatch.fnmatch(rel, pat):
            return True
    return False


def zip_directory(path: str, *, top_level: bool,
                  excludes: Tuple[str, ...] = ()) -> bytes:
    """Deterministically zip ``path``.  ``top_level=False`` puts the
    directory's CONTENTS at the zip root (working_dir semantics: extract
    and chdir in); ``top_level=True`` keeps ``basename(path)/`` as the
    root (py_modules semantics: the extract dir goes on sys.path and
    ``import basename`` works)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(
            f"runtime_env package path {path!r} does not exist "
            f"(deleted between validation and submission?)")
    patterns = _DEFAULT_EXCLUDES + tuple(excludes)
    prefix = os.path.basename(path.rstrip(os.sep)) if top_level else ""
    entries: List[Tuple[str, str]] = []  # (arcname, fs path)
    total = 0
    for root, dirs, files in os.walk(path):
        rel_root = os.path.relpath(root, path)
        rel_root = "" if rel_root == "." else rel_root
        dirs[:] = sorted(d for d in dirs
                         if not _excluded(os.path.join(rel_root, d), patterns))
        for f in sorted(files):
            rel = os.path.join(rel_root, f) if rel_root else f
            if _excluded(rel, patterns):
                continue
            fs = os.path.join(root, f)
            if not os.path.isfile(fs):
                continue  # sockets/fifos/broken symlinks don't package
            total += os.path.getsize(fs)
            if total > _SIZE_LIMIT:
                raise ValueError(
                    f"runtime_env package {path!r} exceeds the "
                    f"{_SIZE_LIMIT >> 20} MiB limit; add 'excludes' "
                    f"patterns for data/checkpoint directories")
            entries.append((os.path.join(prefix, rel) if prefix else rel, fs))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for arc, fs in entries:
            info = zipfile.ZipInfo(arc, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(fs).st_mode & 0o777) << 16
            info.compress_type = zipfile.ZIP_DEFLATED
            with open(fs, "rb") as f:
                zf.writestr(info, f.read())
    return buf.getvalue()


def package_uri(blob: bytes) -> str:
    return f"{PKG_URI_PREFIX}pkg-{hashlib.sha1(blob).hexdigest()[:20]}.zip"


def upload_package_if_needed(client, path_or_zip: str, *, top_level: bool,
                             excludes: Tuple[str, ...] = ()) -> str:
    """Zip (or read) a local path, upload to the head KV once, return the
    content-addressed URI."""
    if os.path.isfile(path_or_zip) and path_or_zip.endswith(".zip"):
        with open(path_or_zip, "rb") as f:
            blob = f.read()
        if len(blob) > _SIZE_LIMIT:
            raise ValueError(
                f"{path_or_zip!r} exceeds the {_SIZE_LIMIT >> 20} MiB "
                f"package limit")
    else:
        blob = zip_directory(path_or_zip, top_level=top_level,
                             excludes=excludes)
    uri = package_uri(blob)
    key = uri.encode()
    # probe a tiny side marker, not the blob itself — the dedup check for
    # an already-uploaded 100+ MiB package must not pull it back over the
    # control socket just to discard it
    meta_key = key + b".meta"
    if client.kv_get(PKG_KV_NAMESPACE, meta_key, timeout=60) is None:
        client.kv_put(PKG_KV_NAMESPACE, key, blob)
        client.kv_put(PKG_KV_NAMESPACE, meta_key,
                      str(len(blob)).encode())  # blob first: meta implies blob
    return uri


def _pin_name(pid: Optional[int], suffix: Optional[str]) -> str:
    # name shape: .pin-<pid>[-<suffix>] — the pid governs liveness; the
    # suffix distinguishes concurrent consumers INSIDE one process (two
    # job submits in the head sharing a package must not share one pin
    # file, or the first unpin strips the other's protection)
    name = f".pin-{pid or os.getpid()}"
    return f"{name}-{suffix}" if suffix else name


def _pin(dest: str, pid: Optional[int] = None,
         suffix: Optional[str] = None) -> None:
    """Mark ``dest`` in use by ``pid`` (default: this process).  GC
    skips packages with any live pin, so a long-lived worker's
    cwd/sys.path entry can't be evicted out from under it.  Pins are
    pid-named: a dead process's pin is ignored (checked against
    /proc)."""
    try:
        open(os.path.join(dest, _pin_name(pid, suffix)), "w").close()
    except OSError:
        pass


def repin(dest: str, pid: int, suffix: Optional[str] = None) -> None:
    """Transfer this process's pin (``suffix``-scoped) to ``pid`` — used
    by the head after launching a job driver whose cwd/PYTHONPATH is the
    package: the package then lives exactly as long as the job
    process."""
    _pin(dest, pid)
    unpin(dest, suffix=suffix)


def unpin(dest: str, pid: Optional[int] = None,
          suffix: Optional[str] = None) -> None:
    try:
        os.unlink(os.path.join(dest, _pin_name(pid, suffix)))
    except OSError:
        pass


def ensure_package_local(fetch: Callable[[str], Optional[bytes]], uri: str,
                         base_dir: Optional[str] = None, *,
                         pin_suffix: Optional[str] = None) -> str:
    """Download + extract ``uri`` into the node-local cache; returns the
    extracted directory, pinned for this process (``pin_suffix`` scopes
    the pin when one process holds several concurrent consumers).  Safe
    under concurrent workers (flock + .ready, the pip-venv cache
    pattern)."""
    base_dir = base_dir or default_base_dir()
    name = uri[len(PKG_URI_PREFIX):].removesuffix(".zip")
    dest = os.path.join(base_dir, name)
    ready = os.path.join(dest, ".ready")
    os.makedirs(base_dir, exist_ok=True)
    # pin + check happen UNDER the per-package flock — GC deletes under
    # the same lock after re-verifying pins, so a package can never
    # vanish between this check and a consumer using it.  ensure runs
    # once per worker boot; the serialization is noise next to spawn.
    with open(os.path.join(base_dir, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):
                _pin(dest, suffix=pin_suffix)
                os.utime(ready)  # LRU touch
                return dest
            blob = fetch(uri)
            if blob is None:
                raise RuntimeError(
                    f"runtime_env package {uri} not found in the cluster KV "
                    f"(head restarted since the driver uploaded it?)")
            shutil.rmtree(dest, ignore_errors=True)  # partial extract
            extracted_size = 0
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(dest)
                # zipfile.extractall drops external_attr: restore modes
                # so executables keep their exec bit on the worker
                for info in zf.infolist():
                    extracted_size += info.file_size
                    mode = (info.external_attr >> 16) & 0o777
                    if mode:
                        try:
                            os.chmod(os.path.join(dest, info.filename), mode)
                        except OSError:
                            pass
            os.makedirs(dest, exist_ok=True)  # empty package: no entries
            _pin(dest, suffix=pin_suffix)
            with open(ready, "w") as f:
                # EXTRACTED size (what the cache cap governs), not the
                # compressed blob size — cheap GC accounting
                f.write(str(extracted_size))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _gc_cache(base_dir)
    return dest


def _is_pinned(full: str) -> bool:
    """A package is pinned while any pinning process is still alive."""
    try:
        for f in os.listdir(full):
            if f.startswith(".pin-"):
                pid = f[len(".pin-"):].split("-", 1)[0]
                if pid.isdigit() and os.path.exists(f"/proc/{pid}"):
                    return True
                try:  # stale pin from a dead process: clean it up
                    os.unlink(os.path.join(full, f))
                except OSError:
                    pass
    except OSError:
        pass
    return False


def _gc_cache(base_dir: str, limit: int = 0) -> None:
    """Evict least-recently-used extracted packages beyond the cache cap
    (reference uri_cache.py).  Only unpinned ``pkg-*`` dirs with a
    ``.ready`` marker are candidates — in-flight extractions hold the
    lock, live consumers hold pid pins."""
    limit = limit or _CACHE_LIMIT
    try:
        cands = []
        total = 0
        for d in os.listdir(base_dir):
            if not d.startswith("pkg-"):
                continue
            full = os.path.join(base_dir, d)
            ready = os.path.join(full, ".ready")
            if not os.path.exists(ready):
                continue
            try:  # extract-time size lives in .ready — no tree walk
                size = int(open(ready).read() or 0)
            except (OSError, ValueError):
                size = sum(
                    os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(full) for f in fs
                    if os.path.isfile(os.path.join(r, f)))
            total += size
            if _is_pinned(full):
                continue
            cands.append((os.path.getmtime(ready), full, size))
        cands.sort()
        while total > limit and cands:
            _, victim, size = cands.pop(0)
            # take the same per-package flock ensure_package_local holds
            # and RE-verify pins under it: a worker on the fast path pins
            # then re-checks .ready, so deleting only unpinned packages
            # while holding the lock closes the pin/scan race
            lock_path = os.path.join(base_dir,
                                     os.path.basename(victim) + ".lock")
            try:
                with open(lock_path, "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    try:
                        if _is_pinned(victim):
                            continue
                        shutil.rmtree(victim, ignore_errors=True)
                    finally:
                        fcntl.flock(lock, fcntl.LOCK_UN)
            except OSError:
                continue
            total -= size
    except OSError:
        pass  # cache GC is best-effort


# ---------------------------------------------------------------------------
# driver-side rewrite

def prepare_runtime_env(runtime_env: Optional[dict],
                        client) -> Optional[dict]:
    """Rewrite local ``working_dir``/``py_modules`` paths to uploaded
    package URIs (reference ``upload_package_if_needed`` call sites in
    ``runtime_env/working_dir.py`` / ``py_modules.py``).  Already-URI
    values pass through, so specs survive resubmission (retries, Tune
    trials) without re-uploading."""
    if not runtime_env:
        return runtime_env
    wd = runtime_env.get("working_dir")
    mods = runtime_env.get("py_modules")
    if not (isinstance(wd, str) and not is_package_uri(wd)) and not any(
            isinstance(m, str) and not is_package_uri(m)
            for m in (mods or ())):
        return runtime_env
    excludes = tuple(runtime_env.get("excludes") or ())
    out: Dict[str, object] = dict(runtime_env)
    if isinstance(wd, str) and not is_package_uri(wd):
        out["working_dir"] = upload_package_if_needed(
            client, wd, top_level=False, excludes=excludes)
    if mods:
        out["py_modules"] = [
            m if is_package_uri(m) else upload_package_if_needed(
                client, m, top_level=True, excludes=excludes)
            for m in mods
        ]
    return out


# ---------------------------------------------------------------------------
# worker-side resolution

def apply_packages_in_worker(client) -> None:
    """Materialize this worker's package URIs (``RAY_TPU_TORCH_RUNTIME_ENV``,
    set at spawn): extract + chdir for working_dir, extract + sys.path
    prepend for py_modules.  Runs in worker main right after
    registration, before any task executes."""
    import json
    import sys

    blob = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if not blob:
        return
    try:
        env = json.loads(blob)
    except ValueError:
        return

    def fetch(uri: str) -> Optional[bytes]:
        return client.kv_get(PKG_KV_NAMESPACE, uri.encode(), timeout=120)

    for m in reversed(env.get("py_modules") or []):
        if is_package_uri(m):
            p = ensure_package_local(fetch, m)
            if p not in sys.path:
                sys.path.insert(0, p)
    wd = env.get("working_dir")
    if is_package_uri(wd):
        p = ensure_package_local(fetch, wd)
        os.chdir(p)
        if p not in sys.path:
            sys.path.insert(0, p)  # reference working_dir is importable
