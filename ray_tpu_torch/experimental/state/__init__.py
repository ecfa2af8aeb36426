from ray_tpu_torch.experimental.state.api import (
    get_trace,
    list_actors,
    list_events,
    list_jobs,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_state_page,
    list_tasks,
    list_traces,
    list_workers,
    summarize_actors,
    summarize_events,
    summarize_state,
    summarize_tasks,
    summarize_traces,
)

__all__ = [
    "list_actors", "list_nodes", "list_tasks", "list_objects",
    "list_placement_groups", "list_workers", "list_jobs", "list_events",
    "list_traces", "get_trace", "summarize_tasks", "summarize_actors",
    "summarize_events", "summarize_traces", "summarize_state",
    "list_state_page",
]
