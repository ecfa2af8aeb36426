"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``'s model path.

The package mirrors ``ray_tpu``'s module names (``ops/layers.py``,
``ops/attention.py``, ``models/gpt2.py``, ``models/generate.py``,
``serve/llm.py``, ``util/flops.py``) so each module's counterpart is easy
to find.  It imports torch and numpy only: nothing of JAX and nothing of
``ray_tpu``.  It serves (``serve.llm.GenerationEngine``) and trains
(``models.*.init_state``, ``make_optimizer``, ``make_train_step``).

Entry points (``models.*.init`` and ``init_state``,
``models.generate.init_cache``, ``convert.from_jax_params`` and
``from_jax_train_state``, ``serve.llm.GenerationEngine``) take a
``device`` argument that defaults to the CUDA card and raise when no card
is present; pass ``device="cpu"`` to run on the CPU.  Kernels written by
hand for Hopper live under ``ops/csrc`` and are built with ``nvcc`` at
first use (``ops/_build.py``).
"""

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
