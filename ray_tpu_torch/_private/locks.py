"""Named locks of the runtime.

The port's copy of ``ray_tpu/_private/locks.py`` keeps its one entry
point, ``make_lock(name)``, so every lock of the head still carries the
name that says what it guards.  The JAX package's timing proxy (the
duty-cycle wait/hold attribution the continuous profiler ships to its
profile store) is left out of the port's runtime core with that plane:
a lock here is a plain ``threading.Lock`` or ``RLock``.
"""

from __future__ import annotations

import threading


def make_lock(name: str, *, rlock: bool = False):
    """A ``threading.RLock`` (``rlock=True``) or ``threading.Lock`` for the
    state ``name`` guards."""
    del name  # documentation at the call site
    return threading.RLock() if rlock else threading.Lock()
