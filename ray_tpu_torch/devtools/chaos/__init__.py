"""Seeded, schedulable fault injection for emulated multi-node clusters.

The slice failure domain can only be *proven* by killing things on
purpose: this package injects host-level faults (SIGKILL, SIGSTOP pause,
outbound message drop, duty-cycled slow node) into real node-agent
processes, targeted by node id or by slice membership, on a reproducible
seeded schedule — and emits every injection to the flight recorder
(source ``chaos``) so ``ray_tpu_torch doctor``, ``ray_tpu_torch events``
and the timeline can correlate cause with symptom.

Reference analog: ``python/ray/_private/test_utils.py`` NodeKillerActor
family, grown into a harness (``get_and_run_resource_killer``).
"""

from ray_tpu_torch.devtools.chaos.harness import (  # noqa: F401
    ChaosMonkey,
    Injection,
)

__all__ = ["ChaosMonkey", "Injection"]
