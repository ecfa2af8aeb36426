"""Checkpoint: one object that converts losslessly among a dict, a local
directory and a URI.

The port's own copy of ``ray_tpu/air/checkpoint.py`` (which imports no
JAX, but the port imports nothing of ``ray_tpu``).  A dict is written as
``checkpoint.pkl`` in the directory, the same layout, so a directory the
JAX package's ``Checkpoint`` wrote with numpy leaves reads here.  The
object-store forms (``from_object_ref``, ``to_object_ref``) need the
runtime, which the port does not have yet, and raise.  The JAX package's
orbax pair ``save_jax``/``load_jax`` becomes :meth:`Checkpoint.save_torch`
/ :meth:`Checkpoint.load_torch`: ``torch.save`` of the whole tree as one
file in the directory.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Optional

import torch

_DICT_FILE = "checkpoint.pkl"
_TORCH_FILE = "torch_state.pt"
_NO_OBJECT_STORE = ("object-store checkpoints need the runtime, which the port does "
                    "not have yet (ROADMAP A3/A4)")


class Checkpoint:
    """Exactly one of ``_data`` (a dict) and ``_local_path`` is set."""

    def __init__(self, data: Optional[Dict] = None, local_path: Optional[str] = None):
        if (data is None) == (local_path is None):
            raise ValueError("Checkpoint takes exactly one of data/local_path")
        self._data = data
        self._local_path = local_path
        self._uuid = uuid.uuid4().hex

    # -- constructors -------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(local_path=os.path.abspath(path))

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """A local path or a ``file://`` URI."""
        return cls.from_directory(_uri_path(uri))

    @classmethod
    def from_object_ref(cls, ref) -> "Checkpoint":
        raise NotImplementedError(_NO_OBJECT_STORE)

    # -- conversions --------------------------------------------------
    def to_dict(self) -> Dict:
        """The dict (a copy of its top level).  A directory without a
        dict payload gives its files' bytes by name."""
        if self._data is not None:
            return dict(self._data)
        fp = os.path.join(self._local_path, _DICT_FILE)
        if os.path.exists(fp):
            with open(fp, "rb") as f:
                return pickle.load(f)
        out: Dict[str, Any] = {}
        for name in os.listdir(self._local_path):
            p = os.path.join(self._local_path, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    out[name] = f.read()
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        """Write the checkpoint to ``path`` (a new directory under the
        temporary directory when None) and return the path."""
        path = path or os.path.join(tempfile.gettempdir(), f"ckpt_{self._uuid}")
        os.makedirs(path, exist_ok=True)
        if self._local_path is not None:
            if os.path.abspath(path) != self._local_path:
                shutil.copytree(self._local_path, path, dirs_exist_ok=True)
        else:
            with open(os.path.join(path, _DICT_FILE), "wb") as f:
                pickle.dump(self.to_dict(), f, protocol=5)
        return path

    def to_uri(self, uri: str) -> str:
        self.to_directory(_uri_path(uri))
        return uri

    def to_object_ref(self):
        raise NotImplementedError(_NO_OBJECT_STORE)

    # -- torch state --------------------------------------------------
    @classmethod
    def save_torch(cls, state: Any, path: str) -> "Checkpoint":
        """``torch.save`` a tree of tensors into the directory ``path``."""
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        torch.save(state, os.path.join(path, _TORCH_FILE))
        return cls.from_directory(path)

    def load_torch(self, map_location=None) -> Any:
        """The tree :meth:`save_torch` wrote, its tensors on
        ``map_location`` (where they were saved when None)."""
        if self._local_path is None:
            raise ValueError("load_torch requires a directory checkpoint")
        return torch.load(os.path.join(self._local_path, _TORCH_FILE),
                          map_location=map_location, weights_only=True)

    def __repr__(self):
        return f"Checkpoint({'dict' if self._data is not None else 'dir'})"


def _uri_path(uri: str) -> str:
    return uri[len("file://"):] if uri.startswith("file://") else uri
