"""Sequences whose logits reached the driver in the window, per second (host clock)."""

from portbench.readers import score_seqs_per_s as read  # noqa: F401
