"""Host-side helpers of the port: ``flops`` (the MFU arithmetic) and
``tree`` (maps over trees of dicts, lists and tuples of arrays), and the
runtime's util libraries (``ActorPool``, ``queue``, ``multiprocessing``,
``joblib``, ``pubsub``), the metrics store (``tsdb``) and ``doctor``.
``ActorPool`` loads on first use, so importing this package loads no
runtime module."""


def __getattr__(name):
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool

        return ActorPool
    raise AttributeError(f"module 'ray_tpu_torch.util' has no attribute {name!r}")
