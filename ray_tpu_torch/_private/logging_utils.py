"""Logging setup for ``ray_tpu_torch.*`` loggers.

Workers do NOT inherit the driver's stdout/stderr: every worker dup2s
fds 1/2 into its per-process capture file at boot
(``worker.py:_redirect_output_to_log``), and the log plane — a per-node
:class:`~ray_tpu_torch._private.log_plane.LogMonitor` tailing those files into
the head's :class:`~ray_tpu_torch.util.log_store.LogStore` — is what carries
output to the driver and ``ray_tpu_torch logs`` (the reference's
``python/ray/_private/log_monitor.py:100`` + GCS pubsub path).

The handler here resolves ``sys.stderr`` at emit time (never captures it
at setup — redirection may install the stamping stream later) and, when
stderr IS a capture stream, writes the record through
``write_record(level, ...)`` so logger output carries the same
job/task/actor/trace stamp as plain ``print()``.  On a plain tty it
stays human-readable with no stamp bytes.
"""

from __future__ import annotations

import logging
import os
import sys


class _ContextStreamHandler(logging.StreamHandler):
    """Emit-time stderr resolution + context stamping.

    ``logging.StreamHandler(sys.stderr)`` freezes whichever object
    ``sys.stderr`` was at import; a worker that redirects afterwards
    would keep logging to the dead inherited fd and its records would
    never reach the capture file."""

    # logging level -> one-char record src (log_plane protocol)
    _LEVEL_SRC = {"DEBUG": "D", "INFO": "I", "WARNING": "W",
                  "ERROR": "E", "CRITICAL": "C"}

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # base __init__ assigns; always re-resolve
        pass

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
            out = sys.stderr
            writer = getattr(out, "write_record", None)
            if writer is not None and getattr(out, "_rt_log_plane", False):
                writer(self._LEVEL_SRC.get(record.levelname, "I"), msg)
            else:
                out.write(msg + "\n")
        except Exception:
            self.handleError(record)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    root = logging.getLogger("ray_tpu_torch")
    if not root.handlers:
        h = _ContextStreamHandler()
        h.setFormatter(logging.Formatter(
            "[ray_tpu_torch %(levelname)s %(name)s] %(message)s"))
        root.addHandler(h)
        root.setLevel(os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"))
    return logger
