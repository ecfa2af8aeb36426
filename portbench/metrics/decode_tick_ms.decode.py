"""The engine's milliseconds a decode step, from its tick meter (program counter)."""

from portbench.readers import decode_tick_ms as read  # noqa: F401
