"""Set-up seconds: process start to the window's opening, compilation included (host clock)."""

from portbench.readers import setup_s as read  # noqa: F401
