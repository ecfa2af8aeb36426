"""Durable workflows — the ``ray.workflow`` analog.

Reference: ``python/ray/workflow/`` (``workflow_executor.py``,
``workflow_state_from_dag.py``, ``workflow_storage.py``): a task DAG runs
with every step's result checkpointed to storage, so a crashed run
resumes from the last completed step instead of starting over.

    from ray_tpu_torch import workflow

    @ray_tpu_torch.remote
    def a(): ...
    @ray_tpu_torch.remote
    def b(x): ...

    result = workflow.run(b.bind(a.bind()), workflow_id="my-flow")
    # after a crash:
    result = workflow.resume("my-flow")
"""

from ray_tpu_torch.workflow.api import (
    EventListener,
    TimerListener,
    WorkflowCancellationError,
    WorkflowError,
    WorkflowExecutionError,
    cancel,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_status,
    list_all,
    options,
    resume,
    resume_all,
    run,
    run_async,
    sleep,
    wait_for_event,
)

__all__ = [
    "run", "run_async", "resume", "resume_all", "get_status", "get_output",
    "get_metadata", "list_all", "delete", "cancel", "options",
    "continuation", "sleep", "wait_for_event", "EventListener",
    "TimerListener", "WorkflowError", "WorkflowExecutionError",
    "WorkflowCancellationError",
]
