"""Public exception types (analog of ``python/ray/exceptions.py``)."""

from __future__ import annotations


class RayError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayError):
    """Wraps an exception raised by user code in a task/actor method.

    Like the reference's RayTaskError, it is stored as the task's return
    object and re-raised on ``get`` with the remote traceback in the message.
    """

    def __init__(self, message: str, cause: BaseException | None = None):
        super().__init__(message)
        self.cause = cause


class RayActorError(RayError):
    """The actor died before or while executing the method."""


class WorkerCrashedError(RayError):
    """The worker process executing the task died unexpectedly."""


class GetTimeoutError(RayError, TimeoutError):
    """``get`` exceeded its timeout."""


class ObjectLostError(RayError):
    """The object's value was lost and could not be recovered."""


class ActorDiedError(RayActorError):
    pass


class TaskCancelledError(RayError):
    """The task was cancelled via ``ray_tpu_torch.cancel`` (reference
    ``python/ray/exceptions.py`` TaskCancelledError; cancel path
    ``python/ray/_private/worker.py:2573``).  Raised by ``get`` on the
    cancelled task's returns."""
