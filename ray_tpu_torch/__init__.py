"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``'s model path.

The package mirrors ``ray_tpu``'s module names (``ops/layers.py``,
``ops/attention.py``, ``ops/moe.py``, ``models/gpt2.py``,
``models/bert.py``, ``models/mlp.py``, ``models/generate.py``,
``serve/llm.py``, ``air/checkpoint.py``, ``train/predictor.py``,
``util/flops.py``, ``rllib/*``) so each module's counterpart is easy to
find.  It imports torch and numpy only: nothing of JAX and nothing of
``ray_tpu``.  It serves (``serve.llm.GenerationEngine``), trains
(``models.*.init_state``, ``make_optimizer``, ``make_train_step``; GPT-2
dense or with Switch experts), predicts from a checkpoint
(``train.TorchPredictor``) and learns RL policies without the runtime
(``rllib.RolloutWorker``, ``TorchPolicy``, ``train_one_step``).

Entry points (``models.*.init`` and ``init_state``,
``models.generate.init_cache``, ``ops.moe.init_moe_params``,
``convert.from_jax_params``, ``from_jax_train_state``,
``from_jax_rl_params`` and ``from_jax_rl_state``,
``serve.llm.GenerationEngine``, ``train.TorchPredictor``, the RL
policies, ``rllib.RolloutWorker`` and the RL models' ``init_*``) take a
``device`` argument that defaults to the CUDA card and raise when no card
is present; pass ``device="cpu"`` to run on the CPU.  Kernels written by
hand for Hopper live under ``ops/csrc`` and are built with ``nvcc`` at
first use (``ops/_build.py``).
"""

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
