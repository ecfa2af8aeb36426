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
(``train.TorchPredictor``) and learns RL policies (``rllib.RolloutWorker``,
``TorchPolicy``, ``train_one_step``).

It also carries its own copy of the runtime core (``_private/``,
``actor.py``, ``remote_function.py``, ``runtime_context.py``), with the
GPU as a first-class resource: ``init(num_gpus=...)``,
``@remote(num_gpus=1)``, ``get``, ``put``, ``wait``, ``kill``,
``get_actor`` (``_api.py``), and Ray Train's seat on it
(``train.TorchTrainer``, ``TorchConfig``, ``train.torch_utils``,
``util.perf.StepProfiler``, ``util.collective``), Ray Serve's
(``serve``: deployments whose replicas hold a card or a share of one,
the HTTP proxy, ``serve.llm.llm_deployment``), compiled actor graphs
(``dag``, ``serve.llm.prefill_decode_graph``) and Ray Data's (``data``:
Datasets over object-store blocks, the streaming executor, actor pools on
cards, which feed ``TorchTrainer(datasets=...)`` and
``train.BatchPredictor``) and RLlib's (``rllib``: ``PPO``, ``A2C``,
``Impala``, ``DQN``, ``SAC`` as ``tune.Trainable``s over remote rollout
workers, ``rllib.serve_policy``'s PolicyServer on a card).  A cluster grows past
the head's host through node agents (``_private/node_agent.py``, started
by ``cluster_utils.Cluster`` or ``autoscaler.LocalNodeProvider``), which
gossip over the syncer mesh (``_private/syncer.py``); stage actors on
them run ``parallel.pipeline.MicrobatchPipeline``.  An operator starts,
inspects and stops a cluster with ``python -m ray_tpu_torch``
(``scripts/cli.py``: ``start``, ``up``/``down``, ``submit`` to the head's
job manager, ``list``, ``timeline``), or from Python with
``job_submission.JobSubmissionClient``, ``experimental.state`` and
``util.timeline``.  Those names load on first use, so importing the
package starts no thread or process.

Entry points (``models.*.init`` and ``init_state``,
``models.generate.init_cache``, ``ops.moe.init_moe_params``,
``convert.from_jax_params``, ``from_jax_train_state``,
``from_jax_rl_params`` and ``from_jax_rl_state``,
``serve.llm.GenerationEngine``, ``train.TorchPredictor``, the RL
policies, ``rllib.RolloutWorker`` and the RL models' ``init_*``) take a
``device`` argument that defaults to the CUDA card and raise when no card
is present; pass ``device="cpu"`` to run on the CPU (an RL algorithm's
learner: ``resources(device="cpu")``; ``serve_policy``: ``num_gpus=0``).  Kernels written by
hand for Hopper live under ``ops/csrc`` and are built with ``nvcc`` at
first use (``ops/_build.py``).
"""

# the core API, loaded from ``_api.py`` on first use
_API = ("init", "shutdown", "is_initialized", "remote", "put", "get", "wait",
        "kill", "cancel", "get_actor", "get_runtime_context",
        "cluster_resources", "available_resources", "nodes",
        "placement_group", "remove_placement_group", "exceptions",
        "ObjectRef", "ActorClass", "ActorHandle", "RemoteFunction")

__all__ = ["resolve_device", *_API]


def __getattr__(name):
    if name == "resolve_device":
        # on first use, like the rest: a process that imports only the
        # runtime's light modules (a pip env's bootstrap shim) loads no torch
        from ray_tpu_torch._device import resolve_device

        return resolve_device
    if name in _API:
        from ray_tpu_torch import _api

        return getattr(_api, name)
    if name == "cluster_utils":  # the multi-node test harness, on first use
        import importlib

        return importlib.import_module("ray_tpu_torch.cluster_utils")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
