"""Model operations of the served tokens over the window, percent of the bf16 peak."""

from portbench.readers import mfu_decode as read  # noqa: F401
