"""Tokens of the training steps finished in the window, per second (host clock)."""

from portbench.readers import train_tokens_per_s as read  # noqa: F401
