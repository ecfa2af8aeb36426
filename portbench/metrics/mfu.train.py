"""Model operations of the finished training steps over the window, percent of the bf16 peak."""

from portbench.readers import mfu_train as read  # noqa: F401
