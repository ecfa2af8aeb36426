"""joblib backend: ``with joblib.parallel_backend("ray_tpu_torch"): ...``.

Reference: ``python/ray/util/joblib/ray_backend.py`` (a
``MultiprocessingBackend`` whose pool is the cluster-actor Pool, so
scikit-learn et al. fan out over the cluster unchanged).  The reference
rebinds ``PicklingPool.__bases__`` to swap its pool class in; here the
backend just constructs :class:`ray_tpu_torch.util.multiprocessing.Pool`
directly — same effect without patching joblib internals.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.util.multiprocessing import Pool


def register_ray_tpu_torch() -> None:
    """Register the backend under both ``"ray_tpu_torch"`` and ``"ray"``."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", RayTpuTorchBackend)
    register_parallel_backend("ray", RayTpuTorchBackend)


# keep the reference's function name importable too
register_ray = register_ray_tpu_torch


def _backend_base():
    from joblib._parallel_backends import MultiprocessingBackend

    return MultiprocessingBackend


class RayTpuTorchBackend(_backend_base()):
    """joblib executes batches via ``self._pool.apply_async(batch, cb)``
    (PoolManagerMixin); our Pool speaks that exact surface."""

    def __init__(self, nesting_level: Optional[int] = None,
                 inner_max_num_threads: Optional[int] = None,
                 ray_remote_args: Optional[Dict[str, Any]] = None, **kwargs):
        from ray_tpu_torch._private.usage import record_feature

        record_feature("util.joblib")
        self.ray_remote_args = ray_remote_args
        super().__init__(nesting_level=nesting_level,
                         inner_max_num_threads=inner_max_num_threads,
                         **kwargs)

    def effective_n_jobs(self, n_jobs):
        import ray_tpu_torch

        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        if n_jobs is None:
            return 1
        if n_jobs < 0:
            # joblib semantics: -1 = all cluster CPUs, -2 = all but one, …
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            return max(1, total + 1 + n_jobs)
        return n_jobs

    def configure(self, n_jobs=1, parallel=None, prefer=None, require=None,
                  ray_remote_args: Optional[Dict[str, Any]] = None,
                  **memmappingpool_args):
        n_jobs = self.effective_n_jobs(n_jobs)
        self._pool = Pool(
            processes=n_jobs,
            ray_remote_args=ray_remote_args or self.ray_remote_args,
        )
        self.parallel = parallel
        return n_jobs

    def terminate(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool = None


__all__ = ["register_ray_tpu_torch", "register_ray", "RayTpuTorchBackend"]
