"""Versioned wire IDL for the control plane (reference:
``src/ray/protobuf/`` — SURVEY L0).

``ray_tpu_torch.proto`` defines the Envelope every control-plane frame
serializes to; ``ray_tpu_torch_pb2.py`` is the checked-in protoc output
(regenerate with ``make``).  The dict<->proto translation and the
connection wrapper live in ``ray_tpu_torch._private.wire``.
"""

from ray_tpu_torch.protocol import ray_tpu_torch_pb2  # noqa: F401
