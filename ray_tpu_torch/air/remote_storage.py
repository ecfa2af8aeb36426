"""Remote-storage seam for checkpoints/experiments (reference
``python/ray/air/_internal/remote_storage.py`` + ``tune/syncer.py``).

A tiny filesystem registry keyed by URI scheme: ``file://`` ships in-tree;
cloud schemes (s3/gs/...) plug in through :func:`register_filesystem` — in
this zero-egress build they error actionably instead of importing cloud
SDKs.  Tune syncs experiment state through this module whenever
``RunConfig.storage_path`` is a URI.

The port's own copy of ``ray_tpu/air/remote_storage.py``.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict
from urllib.parse import urlparse


class StorageFilesystem:
    """Minimal fs interface: recursive dir upload/download + existence."""

    def upload_dir(self, local_dir: str, uri: str) -> None:
        raise NotImplementedError

    def download_dir(self, uri: str, local_dir: str) -> None:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError


class _LocalFilesystem(StorageFilesystem):
    """``file://`` — also the template for dir-backed mock 'clouds'."""

    def _path(self, uri: str) -> str:
        p = urlparse(uri)
        return os.path.join("/", p.netloc, p.path.lstrip("/")) if p.netloc \
            else p.path

    def upload_dir(self, local_dir: str, uri: str) -> None:
        dst = self._path(uri)
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(local_dir, dst, dirs_exist_ok=True)

    def download_dir(self, uri: str, local_dir: str) -> None:
        src = self._path(uri)
        if not os.path.isdir(src):
            raise FileNotFoundError(uri)
        os.makedirs(local_dir, exist_ok=True)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))


class DirBackedFilesystem(_LocalFilesystem):
    """A 'cloud' rooted at a local directory — the hermetic test double for
    s3/gs (the reference tests with moto/fake-gcs the same way)."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, uri: str) -> str:
        p = urlparse(uri)
        return os.path.join(self.root, p.netloc, p.path.lstrip("/"))


_FILESYSTEMS: Dict[str, StorageFilesystem] = {"file": _LocalFilesystem()}


def register_filesystem(scheme: str, fs: StorageFilesystem) -> None:
    _FILESYSTEMS[scheme] = fs


def is_uri(path: str) -> bool:
    return isinstance(path, str) and "://" in path


def _fs_for(uri: str) -> StorageFilesystem:
    scheme = urlparse(uri).scheme
    fs = _FILESYSTEMS.get(scheme)
    if fs is None:
        raise ValueError(
            f"no storage backend for {scheme!r} URIs; this build ships "
            f"'file://' — register one with "
            f"ray_tpu_torch.air.remote_storage.register_filesystem({scheme!r}, fs) "
            f"(cloud SDKs are not bundled in this environment)")
    return fs


def upload_dir(local_dir: str, uri: str) -> None:
    _fs_for(uri).upload_dir(local_dir, uri)


def download_dir(uri: str, local_dir: str) -> None:
    _fs_for(uri).download_dir(uri, local_dir)


def exists(uri: str) -> bool:
    return _fs_for(uri).exists(uri)
