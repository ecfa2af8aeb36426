"""The encoder's operations on the window's sequences, percent of the bf16 peak."""

from portbench.readers import mfu_score as read  # noqa: F401
