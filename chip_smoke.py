#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each (``kernel_case`` lines too, one per shape of
the backward kernels):

1. ``device``: the card, its power limit, the kernels' build time
   (``nvcc``, one process per source, all started together), and each
   kernel's count of tensor-core instructions (``HGMMA``, ``HMMA``) in
   ``cuobjdump -sass`` of the built libraries.
2. ``kernels``: every hand-written kernel against its plain PyTorch
   version on the card, within stated tolerances: the forward at the
   serving shapes, at small f32 shapes, at the tensor-core design's
   edges (bf16 at D 64 and 128: ragged 97 x 131, causal 128 x 256 with
   the diagonal at the bottom right, one query row, the fused-projection
   layout; ragged and fused non-causal at D 64), at both training paths'
   shapes and layouts (GPT-2 B 6 x T 1024; Llama's GQA, B 2 x T 2048)
   and non-causal at BERT's (16 x 128 and 4 x 512), the two backward
   kernels at those training shapes and edges and at small f32,
   rectangular and ragged shapes (dQ, dK and dV bit-identical across two
   calls); each kernel's time beside the plain version's, one library
   call's and the bound the card sets, at the shapes the main paths give
   it.  ``decode_kernel``: ``decode_attend`` at the ``decode-long``
   cell's shape (257 slots x 12 heads x 912 positions x 64, bf16) against
   its plain version, with its time beside its bytes bound, the plain
   version's and SDPA's.
3. ``parity``: tiny GPT-2 and Llama in f32 (and GPT-2 at full width, two
   layers) with the same weights on the CPU and on the card: the prefill
   logits agree and the greedy token streams are equal.
4. ``bert_parity``: tiny BERT and BERT-base's width with two layers, f32,
   CPU and card, with and without token types: logits and labels.
5. ``train_parity``: tiny GPT-2, Llama and GPT-2 with 4 experts in f32,
   5 train steps from the same weights on the CPU and on the card (remat
   "dots" on the card): per-step losses and final params agree; GPT-2 at
   full width with two layers: the loss and every gradient leaf agree.
6. ``mlp``: the MNIST MLP in f32, CPU and card: loss, gradients,
   accuracy, and ``TorchPredictor`` labels of 10,000 inputs.
7. ``rl_parity``: the RL learner stack in f32 (TF32 off for matmul and
   cuDNN), the same weights on the CPU and the card: the Nature-CNN
   actor-critic's logits and values at 84 x 84 x 4 uint8, the PPO, A2C,
   IMPALA and DQN losses and every gradient leaf, one PPO
   ``learn_on_minibatch``, DQN's TD targets and one SAC update given the
   same noise.
8. ``rl_ppo_atari``: BASELINE config 4's shape (``bench.py``'s RL row):
   PPO on ``SyntheticAtariEnv`` through a ``RolloutWorker`` (64 envs,
   fragments of 16, 4 fragments an iteration) and ``train_one_step``
   (minibatches of 256, 4 epochs); 1 warm-up and 3 timed iterations:
   env-steps/s, sample/GAE/learn seconds, one SGD minibatch and one
   64-frame ``compute_actions`` under the profiler.  No kernel of the
   repo lies on this path; its launch counts are set to 0 just before
   the first iteration and read just after the last.
9. ``serve_gpt2``: GPT-2 125M in bf16 through ``GenerationEngine``: 16
   slots, 32 requests of 16-99 random prompt tokens (numpy
   ``default_rng(0)``), 128 new tokens each.  Launch counts are set to 0
   just before the requests and read just after.
10. ``decode_profile``: one eager decode step of GPT-2 125M at 17 slots:
    host enqueue time, device time and kernels per step.
11. ``serve_llama``: Llama 125M, the same traffic.
12. ``serve_bert``: BERT-base in bf16 through ``Checkpoint`` and
    ``TorchPredictor``, ``bench.py``'s config-5 traffic (768 sequences
    of 128 ids in batches of 16): sequences/s, batch latency, device
    work and idle share of one profiled batch.  Launch counts are set to
    0 just before the batches and read just after.
13. ``train_gpt2``: the training path, GPT-2 125M at full width (bf16
    compute over f32 master weights, remat "dots"), B 6 x T 1024,
    ``make_optimizer(lr=3e-4)``: 3 warm-up steps, then 20 timed steps in
    3 windows (the shape of ``bench.py``'s train loop).  Launch counts are
    set to 0 just before the first step and read just after the last.
14. ``train_profile``: one such step under ``torch.profiler``: device busy
    and idle share, the three kernels' share of the step, time by kind,
    top kernels.
15. ``train_llama``: Llama 125M, B 2 x T 2048, 2 warm-up and 5 timed steps.
16. ``train_gpt2_moe``: GPT-2 125M's width with 4 Switch experts, B 6 x
    T 1024, 2 warm-up and 5 timed steps; ``train_gpt2_moe_profile``, one
    step under the profiler; ``train_gpt2_moe_layer``, one layer's MoE
    FFN against the dense FFN (device time) and the MoE's share of the
    step.
17. ``train_gpt2_sharded``: the parallelism layer on the card, a world of
    one over NCCL (``parallel.init_world``) and a mesh of all six axes
    at size 1 (``create_mesh(MeshSpec(), keep_unit_axes=True)``): GPT-2
    125M at ``train_gpt2``'s recipe, its params made DTensors by
    ``shard_params``; from the same init, 3 sharded steps against 3
    unsharded steps: the largest loss difference, the flash launches per
    step (equal to the unsharded step's, all on the tensor cores), ms per
    step and device work per step of both, and each run's peak memory
    above what was allocated before its state was built (the runs build
    their states in turn, each after the other's is freed).  Launch
    counts are set to 0 just before each run of steps and read just
    after.  ``pp``, ``ep``, ``sp`` > 1 and a ``tp`` over several ranks
    need more cards: they run on gloo ranks on the CPU in the tests.
18. ``ring_attention_card``: ``ops.ring_attention.ring_attention`` over
    that world's ``sp`` axis of 1 at GPT-2's training shape (6 x 12 x
    1024 x 1024 x 64 bf16, causal) against ``flash_attn``, and the time
    of both by CUDA events over 20 calls, with ``flash_fwd``'s profiler
    time at that shape beside them.
19. ``core_gpu_actor`` (BASELINE config 1): the port's runtime, its head
    in this process (``ray_tpu_torch.init(num_cpus=4)``), finds the card;
    a ``@remote(num_gpus=1)`` actor sees ``CUDA_VISIBLE_DEVICES`` equal
    to its grant and ``get_gpu_ids() == [0]``, runs a 1024^2 bf16 matmul
    whose sum is exact; a second such actor pends until the first is
    killed, then runs.  The head's spawn-to-ready time (its actor events)
    and the driver's to the first reply; both processes' peaks.
20. ``train_mlp_trainer`` (BASELINE config 2's shape on one card):
    ``TorchTrainer``, 1 worker with ``use_gpu=True``, the MNIST MLP in
    f32 (TF32 off), 10 SGD steps with ``torch_utils.allreduce_grads``
    through the ``shm`` group; per-step losses equal the same loop's in
    this process within 1e-5; ``CheckpointConfig(num_to_keep=2)``.
21. ``train_gpt2_trainer`` (BASELINE config 3's model on one card):
    ``TorchTrainer``, 1 worker, ``TorchConfig(use_torch_distributed=True)``
    (an NCCL world of one), GPT-2 125M at ``train_gpt2``'s recipe, 2
    warm-up and 5 timed steps, the gradients all-reduced over the
    ``torch`` group: each step's ``StepProfiler`` phases and live MFU, the
    flash launches per step counted in the worker (24 / 12 / 12, all on
    the tensor cores), the worker's peak memory, tokens/s beside
    ``train_gpt2``'s; all 7 losses against the in-process step's from
    the same seed and batch within ``TRAINER_LOSS_TOL``, and each leaf's
    update over the 7 steps within ``TRAINER_UPDATE_TOL`` of the
    in-process update's norm (the first update runs at lr 0 and the
    losses barely move, so the update is what sees the step).  Every step
    runs in ``util.profiling.timed("train_step")``, whose histogram must
    count the 7; then ``profiling.profile_step(dir)`` arms one more step's
    trace: it lands under ``dir``, names ``flash_fwd_kernel_tc`` among its
    device events, and the step after it leaves ``dir`` as it was.  The
    worker's counts stand for this path in ``launches_by_path``.
22. ``data_ingest`` (``bench.py``'s ``streaming_ingest`` row): Ray Data on
    the port, ``from_numpy`` of 512 MiB of f64 (``default_rng(3)``) in 16
    blocks, ``.map_batches(x * 2.0)``, fed by ``datasets={"train": ds}``
    to a ``TorchTrainer`` worker holding the card, which iterates
    ``iter_batches(batch_size=2**14, prefetch_blocks=4)`` and copies each
    batch to its card: GiB/s, batch p50/p99, the worker's streaming stall,
    starved and ingest-wait counters, and the ``/dev/shm`` mount under the
    object store.  Gate: the bytes seen are 512 MiB and the card-side sum
    is ``2 * arr.sum()`` within 1e-9 relative.
23. ``train_gpt2_dataset``: ``train_gpt2_trainer`` with its batches from a
    Dataset: ``from_numpy`` of 42 x 1025 int32 ids (``default_rng(0)``),
    each step reading ``TRAIN_BATCH`` rows from
    ``session.get_dataset_shard("train")`` (inputs ``[:, :-1]``, targets
    ``[:, 1:]``); the same checks against the in-process step over the
    same rows, the worker's wait for each batch, tokens/s beside
    ``train_gpt2_trainer``'s.
24. ``batch_predict_bert``: BERT-base bf16 from ``serve_bert``'s directory
    checkpoint, ``BatchPredictor.predict(batch_size=16)`` over a Dataset of
    16 copies of ``serve_bert``'s 768 x 128 ids (12,288 sequences) in
    blocks of 16, by a pool of 1 actor at ``num_gpus_per_worker=1`` and
    then 2 actors at 0.5 sharing card 0: the wall to the first batch
    (actor start included), sequences/s over the whole run and over the
    window after the first batch, beside ``serve_bert``'s.  Gate: the
    labels equal ``serve_bert``'s row for row, in every copy; the actors'
    ``flash_fwd`` launches, read through a
    ``TorchPredictor`` subclass that adds each batch's counter delta as a
    column, are 12 a batch, all on the tensor cores; each pool's card is
    free again after its last block.
25. ``rl_ppo_atari_runtime`` (``bench.py``'s RL row): PPO with 4 remote
    rollout workers and ``serve_policy`` holding the policy on the card
    (see the phase's doc).
26. ``tune_gpt2_trainer`` (this slice's main path): ``Tuner(TorchTrainer(
    _gpt2_train_loop, ScalingConfig(num_workers=1, use_gpu=True,
    resources_per_worker={"GPU": 0.5})), param_space={"lr":
    grid_search([3e-4, 1e-4])}, TuneConfig(metric="loss", mode="min"))``:
    two trials at once, each a Train worker on half the card, GPT-2 125M at
    ``train_gpt2_trainer``'s recipe for 7 steps; the trial hosts hold half
    a CPU each.  Gates: each trial's losses against an in-process
    ``make_train_step`` at its learning rate (``TRAINER_LOSS_TOL``) and its
    update against that run's (``TRAINER_UPDATE_TOL``); 24 / 12 / 12 flash
    launches a step, all on the tensor cores; both Train workers alive at
    once (the head's actor events); a storage directory for each trial;
    ``get_best_result()`` names the lower last loss; the best checkpoint,
    loaded here onto the card, gives its reported loss on the same batch.
    Prints the fit's wall split into the trial hosts' start, the trainers'
    start and the run loop, each trial's tokens/s beside
    ``train_gpt2_trainer``'s and each worker's peak memory.
27. ``rl_appo_atari_runtime``: APPO at ``rl_ppo_atari_runtime``'s sizes,
    each remote worker's policy on a quarter of the card, the learner on
    the card: env-steps/s beside PPO's, the learner's share of the wall,
    the samples in flight as each step begins, the bytes of the weights
    put a step; one update card against CPU at ``RL_TOL``; ``cleanup``
    frees every share.
28. ``rl_multiagent_offline``: ``MultiAgentPPO`` (two policies on the card)
    and DQN trained offline from a PPO worker's ``output=`` files, each
    against the same steps on a CPU learner at ``RL_TOL``.
29. ``serve_bert_http`` (BASELINE config 5, ``bench.py``'s serve row):
    Serve on the same runtime (controller, asyncio proxy), BERT-base bf16
    from ``serve_bert``'s checkpoint in one ``num_gpus=1`` replica with
    ``@serve.batch(max_batch_size=16, batch_wait_timeout_s=0.005,
    max_concurrent_batches=8)``, padded to 16 x 128; warm-up 16 threads x
    3 requests, then 64 keep-alive clients x 12 requests of 128 ids:
    requests/s, p50, p99, the light-load p50 (1 client x 15), the ingress
    mode, one batch's device work in the replica (profiler).  Gate: 16
    fixed sequences sent at once get the labels of an in-process
    ``TorchPredictor`` from the same checkpoint.
30. ``serve_llm_deployment``: GPT-2 125M through ``llm_deployment`` (a
    ``num_gpus=1`` replica, the ``SERVE`` settings, seed 0).  Gate in f32
    first: GPT-2's width with two layers, 8 of ``serve_gpt2``'s prompts,
    greedy streams through the replica equal to an in-process engine's.
    Then bf16: ``serve_gpt2``'s 32 requests through the handle and 8 of
    them again as HTTP token streams; tokens/s beside ``serve_gpt2``'s,
    request p50/p99, the replica's TTFT and ITL, and the share of streams
    equal to ``serve_gpt2``'s (recorded, no gate).
31. ``prefill_decode_graph``: GPT-2 125M bf16, prompt bucket 128, 32 new
    tokens, the two stages at ``num_gpus=0.5`` on card 0; 16 prompts one
    at a time, each request's wall split into prefill, channel hop and
    decode from the stages' ``compiled_dag`` spans, with the cache's
    bytes and whether the channel spilled it (its in-process cost beside
    it), then the 16 pipelined.  Gate: every stream equals the in-process
    ``prefill`` + greedy ``decode_chunk`` on the same weights.
32. ``util_pool_bert_accounting`` (after the runtime's shutdown, on a
    fresh ``ray_tpu_torch.init(num_cpus=4)`` with
    ``RAY_TPU_TORCH_METRICS_PUSH_S=0.5`` and the ``/proc`` sampler on):
    ``serve_bert``'s 768 x 128 ids in 48 batches of 16 (put by the
    driver), scored by BERT-base bf16 from its directory checkpoint in
    two ``num_gpus=0.5`` actors.  (1) ``ActorPool.map``: the labels equal
    ``serve_bert``'s; 12 ``flash_fwd`` launches a batch in the actors, all
    on the tensor cores (their counts set to 0 just before the map and
    read just after); sequences/s beside ``batch_predict_bert``'s pools
    and the pool's start.  (2) A producer task puts the 48 batches into a
    ``Queue(maxsize=8)`` and one of the actors drains it: the labels again,
    batches/s and the producer's seconds blocked on ``Full``.  (3)
    ``multiprocessing.Pool(4)``: each batch's non-pad count and an id
    checksum equal the driver's, by ``map`` and in order by ``imap``.  (4)
    Each scored batch is published on a channel the driver subscribes to:
    exactly 48 from the map and 48 from the queue, in each actor's order.  (5) With the
    actors idle, after two push intervals: ``query_metric(
    "ray_tpu_hbm_bytes_in_use")`` holds one card series per actor whose
    last value equals the actor's ``allocated_bytes.all.current``;
    ``top_snapshot()`` lists both actors' workers with RSS and CPU from
    the sampler and a card row each; ``memory_summary()`` gives the driver
    at least the batches' bytes; ``doctor_report()`` has no trend finding
    but ``gil_saturation`` on a scorer (its GIL lateness while it enqueued
    BERT's kernels from Python, printed by origin with the head's lock
    rows);
    ``python -m ray_tpu_torch metrics``, ``top --iterations 1``,
    ``memory``, ``perf`` and ``doctor --json`` exit 0 (``doctor`` 1 with
    only that finding).  Prints the TSDB's series,
    the bytes of each actor's push and the head's median fold time a
    report, and the median ms of one push's snapshot and pickle in each
    actor.  (6) The push's cost: the pool's rate over as many more maps as
    span 20 pushes at 0.5 s, then, on another fresh init at the default 5 s
    push, over the same number of maps: both rates from this call.
33. ``multinode_pipeline_gpt2`` (after 32): the
    multi-node runtime.  A ``Cluster`` of real agents whose head holds no
    card, a ``StandardAutoscaler`` under a ``Monitor`` over a
    ``LocalNodeProvider`` (at most one node of 4 CPUs and the card, idle
    timeout 5 s), and a ``MicrobatchPipeline`` of two GPT-2 125M
    ``GPT2Stage`` actors at ``num_gpus=0.5``, which only the node the
    autoscaler adds can place: stage 0 holds ``wte``/``wpe`` and blocks
    0-5, stage 1 blocks 6-11, ``ln_f`` and the tied head, each from the
    seed-0 init in bf16 over f32.  8 microbatches of 4 x 1025 ids
    (``default_rng(0)``, ``[0, 50257)``), pipelined, then one at a time.
    Gates: each microbatch's mean next-token NLL within 2e-3 of the
    unsplit ``gpt2.apply`` here; the driver's edges are streams and the
    stages' edge a shm ring, across which stage 0's card tensors reach
    stage 1 on its card; both stages on the agent's node with
    ``CUDA_VISIBLE_DEVICES`` "0"; 12 ``flash_fwd`` launches a microbatch,
    all on the tensor cores; a ``syncer_report`` folded at the head; after
    the teardown the node is reaped and the cluster holds no ``"GPU"``.
    Prints the agent's import time, the seconds from the first submit to
    the launch, the agent's registration and both stages ``ALIVE``, the
    pipeline's wall beside the serial sum and the bubble model, each
    stage's exec spans (pipelined and alone), the in-process forward of
    the same tokens, the hop's bytes and its (de)serialization here, one
    512 MiB array returned across the nodes in GiB/s, and the reap time.
    In 29-31 and 33 each replica's or stage's own launch counts (read in its
    process through the compiled-graph control lane) are set to 0 just
    before the traffic and read just after.
34. ``watch_pipeline_gpt2`` (after 33): 33's two GPT-2 125M stages
    (``WatchStage``: stage 1 writes a marker line to stderr a call) at
    ``num_gpus=0.5``, pinned to one agent node of 4 CPUs and the card that
    ``Cluster.add_node`` adds to a card-less head, 8 microbatches of 4 x
    1025 ids, under the observability stores: the continuous profiler in
    the head, the agent and both stages, the push at 0.5 s, the log plane,
    the watchdog at a 1 s cadence with a command sink appending each
    incident transition to a file.  Two runtimes: the profiler off
    (``RAY_TPU_TORCH_CONT_PROFILE=0``), repeating the 8 microbatches for
    12 s, then on, for 20 s.  Gates: 12 ``flash_fwd`` launches a
    microbatch, all on the tensor cores (the stages' counts set to 0 just
    before each run's repetitions and read just after); the first
    repetition's mean NLL per microbatch within 2e-3 of the unsplit
    forward; ``list_profiles`` holds the head, the agent and both stages,
    and each shipped a burst in the 20 s; one traced request's
    ``analyze`` phases sum to its wall within 1e-6 relative and its
    critical path is not empty (the gap within 1e-6 relative plus half a
    microsecond for each number ``analyze`` rounds; ``trace <id>`` renders
    it), and its trace spans at most 1.5 times the request's own span; an
    SLO on the
    stages' ``ray_tpu_proc_rss_mb`` below their RSS (windows 2 s and 6 s)
    burns and opens an incident whose bundle holds ``incident.json``,
    ``events.json``, ``logs/``, ``tsdb/`` (with the metric's slice), the
    trace trees, the collapsed profile and the memory audit; ``incidents``
    lists it, ``incidents --ack`` acknowledges it, after ``remove_slo`` it
    resolves within its resolve ticks, and the sink's file shows open, ack
    and resolve in that order; no ``rss_growth`` and no
    ``log_error_burst`` incident opens at any point, the stages' start-up
    included; ``logs --actor`` returns every marker line
    of stage 1, which, SIGKILL'd, keeps its last marker readable from the
    head (``tail_log``) with its stream ``retired``; the node removed, no
    ``"GPU"`` is left.  Prints each origin's class shares of its busy
    samples over the run, its busy share and duty cycle, the top leaf
    frames of stage 0's ``serialize`` and ``other`` samples beside its
    ``torch.save`` share of the exec span (span less compute, 33's
    method), the profile ledger's columns and ``sum_over_wall``, the
    repetitions' wall with the profiler on and off (the two runtimes, and
    three pairs of 2.5 s blocks in the second with the head's and the
    stages' profilers stopped and restarted in turn), the trace's phases
    and critical path, the other incidents with when they opened, the
    watchdog's tick cost, and each stage's RSS from its constructor's end
    through the run: its growth to its peak and the seconds until it came
    within the ``rss_growth`` rule's 64 MB of it (the head's warm-up,
    ``Node.WORKER_WARMUP_S``, stands against this reading).
35. ``operator_job_gpt2`` (after 34, with no head in this process): the
    operator plane.  ``autoscaler.commands.up`` with the local runner
    starts ``python -m ray_tpu_torch start --head`` (2 CPUs, no card) and
    one node agent (4 CPUs, ``--num-gpus 1``); ``python -m ray_tpu_torch
    status`` sees 2 nodes and 1 GPU; ``JobSubmissionClient`` submits a
    driver script whose ``num_gpus=1`` actor runs GPT-2 125M bf16 (seed
    0) greedy over 8 prompts (``default_rng(0)``) x 32 new tokens, every
    prompt queued before the engine starts.  Gates: SUCCEEDED; the streams
    equal an engine's of the same settings here; 12 ``flash_fwd`` launches
    (one prefill of all 8), all on the tensor cores, counted in the actor;
    the actor on the agent's node under ``CUDA_VISIBLE_DEVICES`` "0";
    ``list_nodes``, ``list_actors``, ``list_jobs``, ``summarize_tasks``,
    ``list_events`` and ``timeline_dump`` show the card, the actor, the
    job and its method's slice; a second job holding the card, stopped by
    ``python -m ray_tpu_torch job-stop``, is STOPPED and the grant is back
    within 30 s; after ``commands.down`` no head, agent or actor process
    runs and ``nvidia-smi --query-compute-apps=pid`` lists none of them.
    Prints ``up``'s seconds to the session record and to the agent's
    registration, submit to RUNNING and to SUCCEEDED, ``job-stop`` to the
    grant freed, ``down`` to every process gone, and the card's name and
    power limit.
36. ``durable_job_gpt2`` (after 35): runtime envs, GCS persistence, the
    usage report and workflows, GPT-2 125M bf16 (seed 0) on a head in this
    process started with ``_gcs_persistence_path``.  (a) A job submitted
    with a ``working_dir`` (its driver, its args and a 50 MB file its
    ``excludes`` leave out) and one ``py_modules`` package: its
    ``num_gpus=1`` actor, in the same packages, generates 35's 8 x 32
    greedy tokens; SUCCEEDED, the streams equal an engine's here, 12
    ``flash_fwd`` launches all on the tensor cores, the driver's and the
    actor's cwd the extracted package without the excluded file, the same
    tree submitted again adds no ``pkg`` entry to the KV, no live pin left
    once the jobs end.  (b) A ``num_gpus=1`` task with a ``pip`` env (a
    wheel built offline with ``--no-index``) imports it and torch from its
    venv and runs one forward of 2 x 64 ids: its logits equal this
    process's within 1e-3; a second (CPU) task hits the venv's cache.  (c) A
    workflow (``wf_generate``, ``wf_score`` on the card, ``wf_finalize``
    failing once) ends FAILED; a second head over the same SQLite file
    replays the job's KV key, every actor DEAD ("head restarted" for one
    still alive at the shutdown), the finished tasks FINISHED;
    ``workflow.resume`` runs only the last step and equals an
    uninterrupted run of the same DAG on that head.  (d) Each head's
    ``usage_report.json`` lists ``workflow`` and counts at least the tasks
    the phase submitted to it, counted here (the second head's past the
    tasks it replayed; the replayed usage flags are cleared at its start,
    so its ``workflow`` is its own record).  Prints the upload's bytes and seconds, submit to SUCCEEDED,
    the venv's build and cache hit, the replay's seconds, the resume's
    wall against the first run's, the launches, the phase's wall, and the
    card's name and power limit.
37. ``tenant_front_doors_gpt2`` (after 36): GPT-2 125M bf16 (seed 0)
    behind the cluster's remote front doors, on a head in this process
    with its dashboard and a proxy process started with ``--head auto``.
    (a) Two client processes with no card join through the proxy
    (``ray_tpu_torch://``, namespaces "a" and "b"); each starts a named
    ``"engine"`` actor on a quarter of the card and generates 35's 8 x 32
    greedy tokens: equal to an engine's here, 12 ``flash_fwd`` launches
    each on the tensor cores, the names apart (each lookup finds its own,
    the default namespace neither), both tenants proxied in
    ``list_tenants`` and ``python -m ray_tpu_torch list tenants``, and
    the clients free of torch.  (b) A ``client://`` process with no card
    puts 64 MiB of ids; a quarter-card task reads them onto the card and
    returns GPT-2's logits of the first 16 as a card tensor, which the
    client gets as an equal CPU tensor; its ``experimental_compile``
    raises the thin-client error.  (e) The dashboard: the card's
    ``"GPU"`` in ``/api/cluster_status``, the engines' pushed series in
    ``/metrics``, a card row for each engine in ``/api/top``, and
    ``/api/profile`` of tenant b's engine finding its decode loop while
    it generates 40 times.  (c) ``ChaosMonkey.kill_tenant_driver`` while
    tenant a generates: its actor DEAD and its share back within 10 s,
    b's streams unchanged, the kill on record, and after b's
    ``shutdown()`` the doctor's ``tenant_killed`` naming a alone.  (d)
    ``serve-deploy`` PUTs a config to the dashboard: an app module
    written here, ``llm_deployment`` with 2 replicas on a quarter of the
    card each; 16 keep-alive clients x 8 requests of 32 greedy tokens,
    ``kill_serve_replica`` after the 20th reply, then 16 x 8 again: no
    request lost, no transport error, every reply equal to (a)'s
    reference, the replica replaced on the freed share, the ingress's
    deaths and retries grown, p99 under 10 s, no ``ingress_shedding`` or
    ``drain_stuck``; the config scaled to 1 replica, then deleted.
    Prints the put's and the get's seconds and bytes, the recovery's
    seconds, p50/p99 before, during and after it, the launches and the
    phase's wall.
38. ``core_perf_witness_gpt2`` (after 37): (a) the core microbenchmarks
    (``ray_tpu_torch._private.ray_perf.main(quick=True)``, a head with
    ``num_gpus=0`` on the card's host, then two real-agent clusters for
    the broadcast rows), each row printed; every value above 0,
    ``task_round_trip`` above 20 and ``actor_call_round_trip`` above 40
    ops/s (the floors of ``tests/test_perf_smoke.py``).  (b) A process
    started with ``RAY_TPU_TORCH_LOCKWITNESS=1`` and a private
    ``RAY_TPU_TORCH_LOCKWITNESS_DIR`` in its environment (so every named
    lock, the module-level ones made at import too, is a raylint
    ``WitnessLock`` in it and in every process of its cluster): a port
    head serving GPT-2 125M bf16 (seed 0) through ``llm_deployment``
    (one ``num_gpus=1`` replica) answers 8 greedy requests of 32 tokens
    while tasks run, an actor is killed and an array is put and read
    back; the streams equal an unwitnessed engine's in this process, the
    witness saw nested acquisitions with one on a ``node.shard`` lock,
    the report directory stays empty (no lock-order cycle in the head,
    its workers or the replica), and the replica's ``flash_fwd``
    launches are 12 a prefill, all on the tensor cores; ``doctor
    --static`` against that live head names no ``raylint/`` finding.
    (c) ``python -m ray_tpu_torch lint --json`` exits 0 against the
    port's baseline.  Prints the rows, the edges, the launches, each
    part's seconds, the phase's wall, and the card's name and power
    limit.

Every bf16 launch of ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
on the serving and training paths has to run the tensor-core design
(their ``_tc`` launch counts equal their totals; the profiled steps find
only the ``_tc`` kernels by name). Then a ``{"kernels": [...]}`` line (launches
summed over the serving, training, Tune, RL, Data, Serve, graph,
util-pool, multi-node pipeline, watched pipeline, operator-job, durable-job,
front-door and witnessed-serving runs, and per run), the card's name
and power limit as ``nvidia-smi`` prints them, and last ``{"ok": true,
"device": {...}}``.  Exits non-zero,
printing no result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import gc
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (the dense bf16 tensor-core
# peak is ray_tpu_torch.util.flops.peak_flops)
PEAK_BYTES_PER_S = 3.35e12

# H100 SXM data sheet: float32 outside the tensor cores (the f32 kernels'
# and plain versions' rate with TF32 off)
PEAK_F32_FLOPS = 67e12

N_REQUESTS = 32
NEW_TOKENS = 128
SERVE = dict(n_slots=16, max_new_tokens=NEW_TOKENS, decode_chunk_steps=64,
             prefill_buckets=(128,))

# bench.py's train loop: B 6, T 1024, N_STEPS 20 timed after 3 warm-up steps
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_WINDOWS = 6, 3, (7, 7, 6)
# Llama 125M at its T 2048: B 2, 2 warm-up and 5 timed steps
LLAMA_BATCH, LLAMA_WARMUP, LLAMA_WINDOWS = 2, 2, (5,)
# GPT-2 125M's width with 4 Switch experts (cf 2.0, aux 0.01), GPT-2's
# batch: 2 warm-up and 5 timed steps
MOE_EXPERTS, MOE_WARMUP, MOE_WINDOWS = 4, 2, (5,)
# bench.py's serve_bert traffic (BASELINE config 5): 64 clients x 12
# requests of 128 token ids in [1, 30522), @serve.batch(max_batch_size=16)
# batches padded to 16; 3 warm-up batches first
BERT_REQUESTS, BERT_SEQ, BERT_BATCH, BERT_WARMUP, BERT_ID_HIGH = 64 * 12, 128, 16, 3, 30522


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "elapsed_s": time.perf_counter() - _T0}),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """SM clock, its maximum and the power draw now, as nvidia-smi prints
    them: a slow card shows here, not as a slow kernel."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, calls: int = 10, warmup: int = 3, tries: int = 6, counts=None) -> float:
    """Device time of one call of ``fn`` in ms as the sum of its kernels'
    own durations under torch.profiler (user annotations excluded), over
    ``calls`` calls after a warm-up (a warm L2).  Host time between
    launches does not count: CUDA events around back-to-back calls time a
    short call at the host's pace when its host cost (Python checks,
    autograd, dispatch) exceeds its device work, and the host's speed
    differs from call to call of this script.  Every kernel, plain and
    library time this script prints is taken this way.

    Each call launches the same kernels, so a session whose kernel count
    is not a positive multiple of ``calls`` lost records (on an H100,
    sessions have come back with none, and three in a row with 0, 0 and
    9 events for 10 calls of one kernel); it is run again, up to
    ``tries`` times.  Given a list ``counts``, ``fn`` may launch a number
    of kernels that is no multiple of ``calls`` or varies (on an H100: the
    MoE's forward, 405-427 in 10 calls from session to session; the dense
    FFN's forward and backward, 237 in every session): all ``tries``
    sessions run, their counts go into ``counts``, and the session with
    the most events is taken, as a lost record can only lower the count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    varying, sessions = counts is not None, []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
        if kernels and len(kernels) % calls == 0 and not varying:
            return ms
        sessions.append((len(kernels), ms))
    if varying and max(sessions)[0]:
        counts.extend(n for n, _ in sessions)
        return max(sessions)[1]
    raise RuntimeError(f"device_ms: the profiler recorded {[n for n, _ in sessions]} device "
                       f"events for {calls} calls in {tries} sessions")


def profiled_events(fn, what: str, tries: int = 3) -> list:
    """The device events (kernels and copies, user annotations excluded)
    of one call of ``fn`` under torch.profiler, the call ending in a
    synchronize.  On an H100 a session has come back with no device event
    (``device_ms``), so a session without one runs ``fn`` again, up to
    ``tries`` times; after that ``what`` fails."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if dev:
            return dev
    check(False, f"{what}: the profiler saw no device time in {tries} sessions")


def num_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(num_params(v) for v in tree.values())
    return tree.numel()


def pct(vals, q: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(len(vals) * q))]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def sass_mma_counts(lib_path) -> dict:
    """``{kernel<dtype,D>: {"HGMMA": n, "HMMA": m}}``: the tensor-core
    instructions in each kernel of a built library, from ``cuobjdump
    -sass`` (next to ``nvcc``)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?\d+(flash_\w+?_kernel(?:_tc)?)I(\S*)", line)
        if m:  # template args: "ILi64E" (bf16 only), "I13__nv_bfloat16Li32E", "IfLi128E"
            dtype = "f32" if m.group(2).startswith("f") else "bf16"
            d = re.search(r"Li(\d+)E", m.group(2)).group(1)
            fn = f"{m.group(1)}<{dtype},{d}>"
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += bool(re.search(rf"\b{op}\.", line))
    return counts


def phase_device(build):
    t0 = time.perf_counter()
    builds = build.build([attn.KERNEL, attn.BWD_SOURCE, attn.DECODE_KERNEL],
                         ptxas_verbose=True)
    for name, b in builds.items():
        print(f"--- nvcc {name}.cu ---\n{b['log']}", file=sys.stderr, flush=True)
    build_wall_s = time.perf_counter() - t0
    sass = {}
    for name in builds:
        sass.update(sass_mma_counts(build.library_path(name)))
    for kern in ("flash_fwd_kernel_tc", "flash_bwd_dq_kernel_tc", "flash_bwd_dkv_kernel_tc"):
        for d in attn._TC_HEAD_DIMS:
            check(sass.get(f"{kern}<bf16,{d}>", {}).get("HGMMA", 0) > 0,
                  f"{kern}<{d}> has no HGMMA instruction: {sass}")
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s={n: b["seconds"] for n, b in builds.items()}, build_wall_s=build_wall_s,
         sass_tensor_core_instructions=sass)


def _qkv(b, h, tq, tk, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda t: torch.randn(b, h, t, d, generator=g, device="cuda", dtype=torch.float32).to(dtype)
    return mk(tq), mk(tk), mk(tk)


def train_attn_shapes():
    """What each training path gives the three kernels per attention call,
    ``{path: (B, H, KV heads, T, D)}``, from the configs ``main`` trains."""
    from ray_tpu_torch.models import gpt2, llama

    g, lc = gpt2.GPT2Config.gpt2_small(), llama.LlamaConfig.llama_125m()
    return {"train_gpt2": (TRAIN_BATCH, g.n_heads, g.n_heads, g.max_seq_len, g.head_dim),
            "train_llama": (LLAMA_BATCH, lc.n_heads, lc.n_kv_heads, lc.max_seq_len, lc.head_dim)}


def _model_qkv(b, h, kv, t, d, seed, dtype=torch.bfloat16):
    """(q, k, v, dO) laid out as a train step hands them to the kernels:
    head-split views ``[B, T, heads, D] -> [B, heads, T, D]`` of one fused
    projection (unit stride on D only), k and v repeated to H heads by
    ``repeat_interleave`` when KV < H (GQA), dO a strided view as well."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn(b, t, n, d, generator=g, device="cuda").to(dtype)
    fused = mk(h + 2 * kv)
    q, k, v = (fused[:, :, a:a + n].transpose(1, 2)
               for a, n in ((0, h), (h, kv), (h + kv, kv)))
    if kv != h:
        k, v = (x.repeat_interleave(h // kv, dim=1) for x in (k, v))
    return q, k, v, mk(h).transpose(1, 2)


# the design each kernel runs at the main paths' bf16, D 64 inputs
DESIGN = {"flash_fwd": "flash_fwd_kernel_tc: wgmma tensor cores, cp.async K/V ring",
          "flash_bwd_dq": "flash_bwd_dq_kernel_tc: wgmma tensor cores, cp.async K/V ring",
          "flash_bwd_dkv": "flash_bwd_dkv_kernel_tc: wgmma tensor cores on the transposed "
                           "scores, cp.async Q/dO ring"}

# per kernel: [B,H,Tq,D] tensors moved, [B,H,Tk,D] tensors moved, f32 [B,H,Tq]
# rows moved, products over the visible pairs
_FLASH_WORK = {
    "flash_fwd": (2, 2, 1, 2),      # q, o | k, v | lse | S, P·V
    "flash_bwd_dq": (3, 2, 2, 3),   # q, dO, dq | k, v | lse, Δ | S, dP, dS·K
    "flash_bwd_dkv": (2, 4, 2, 4),  # q, dO | k, v, dk, dv | lse, Δ | S, Pᵀ·dO, dP, dSᵀ·Q
}


def flash_bound_ms(kernel, b, h, tq, tk, d, causal, dtype=torch.bfloat16):
    """The least time the card could take for a flash kernel's work: each
    input read once and each output written once over HBM bandwidth,
    against the products of the visible pairs (2·D operations each) over
    the card's peak for the dtype (the tensor-core bf16 peak; for f32, the
    non-tensor-core f32 peak, TF32 being off).  Returns (ms, bound_by)."""
    from ray_tpu_torch.util.flops import peak_flops

    n_q, n_k, n_rows, n_products = _FLASH_WORK[kernel]
    elt = torch.finfo(dtype).bits // 8
    nbytes = b * h * ((n_q * tq + n_k * tk) * d * elt + n_rows * tq * 4)
    if causal:
        off = tk - tq
        pairs = sum(min(tk, off + i + 1) for i in range(tq))
    else:
        pairs = tq * tk
    flops = n_products * 2 * d * pairs * b * h
    peak = (peak_flops(torch.cuda.get_device_name(0)) if dtype == torch.bfloat16
            else PEAK_F32_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# bf16 cases at the edges of the tensor-core design (D 64 and 128): ragged
# tiles, the causal diagonal at the bottom right with Tq < Tk, one query
# row, and (a 9th field) the fused projection's strided layout
TC_EDGE_CASES = [(2, 3, 97, 131, 64, True, torch.bfloat16), (2, 3, 97, 131, 128, True, torch.bfloat16),
                 (2, 3, 128, 256, 64, True, torch.bfloat16), (2, 3, 1, 77, 64, True, torch.bfloat16),
                 (2, 4, 150, 150, 64, True, torch.bfloat16, "fused"),
                 # non-causal (BERT): ragged at D 64, and the fused layout
                 (2, 3, 97, 131, 64, False, torch.bfloat16),
                 (2, 4, 150, 150, 64, False, torch.bfloat16, "fused")]

# the Serve paths' own shapes, on the model's fused qkv layout: the
# prefill stage of prefill_decode_graph (one request, bucket 128, bf16,
# tensor cores), the f32 gate of serve_llm_deployment (an admission of
# 16 slots at 128, f32, CUDA cores), operator_job_gpt2's job (one
# prefill of 8 slots at 128, bf16, tensor cores) and a pipeline stage's
# microbatch of 4 x 1024 (multinode_pipeline_gpt2, watch_pipeline_gpt2)
SERVE_PATH_CASES = [(1, 12, 128, 128, 64, True, torch.bfloat16, "fused"),
                    (16, 12, 128, 128, 64, True, torch.float32, "fused"),
                    (8, 12, 128, 128, 64, True, torch.bfloat16, "fused"),
                    (4, 12, 1024, 1024, 64, True, torch.bfloat16, "fused")]

# BERT-base's attention (non-causal, bf16, D 64, q/k/v views of one fused
# projection): serve_bert's 16 x 128 batch, and a 4 x 512 one at the
# model's longest sequence
BERT_ATTN_SHAPES = {"serve_bert 16x128": (16, 12, 128, 64), "bert 4x512": (4, 12, 512, 64)}


def phase_kernels():
    """flash_fwd against flash_attention_reference, out and lse.
    Tolerances: f32 |err| <= 1e-5 + 1e-5|ref| (only the summation order
    differs); bf16 |err| <= 1e-2 + 1e-2|ref| (one bf16 ulp is 2^-8
    relative, and the kernel rounds P to bf16 before normalising where the
    plain version rounds after); lse |err| <= 1e-4 in both (f32 on both
    sides)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(16, 12, t, t, 64, True, torch.bfloat16) for t in (32, 64, 128, 256)]
    cases += [(2, 4, 128, 128, d, c, torch.float32) for d in (16, 64) for c in (False, True)]
    cases += [(2, 4, 128, 256, 64, c, torch.float32) for c in (False, True)]
    cases += [(2, 3, 97, 97, 32, True, torch.float32), (2, 3, 97, 131, 128, False, torch.bfloat16)]
    cases += TC_EDGE_CASES + SERVE_PATH_CASES
    results = []
    for i, (b, h, tq, tk, d, causal, dtype, *fused) in enumerate(cases):
        if fused:  # head-split views of one fused projection (tq == tk)
            q, k, v, _ = _model_qkv(b, h, h, tq, d, seed=i, dtype=dtype)
        else:
            q, k, v = _qkv(b, h, tq, tk, d, dtype, seed=i)
        build.reset_launches()
        out, lse = attn.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        tc = int(attn.uses_tensor_cores(dtype, d))
        launched = (build.launches.get(attn.KERNEL, 0), build.launches.get(attn.FWD_TC, 0))
        check(launched == (1, tc), f"flash_fwd launches (all, tensor-core) {launched}, want (1, {tc})")
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, causal)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        diff = (out.float() - ref_out.float()).abs()
        err_out = diff.max().item()
        excess = (diff - (tol + tol * ref_out.float().abs())).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        shape = f"{b}x{h}x{tq}x{tk}x{d}" + (", fused qkv" if fused else "")
        check(bool(torch.isfinite(out).all()), f"flash_fwd non-finite output at {shape}")
        check(excess <= 0, f"flash_fwd out disagrees at {shape} {dtype}: max err {err_out}")
        check(err_lse <= 1e-4, f"flash_fwd lse disagrees at {shape} {dtype}: max err {err_lse}")
        results.append({"shape": shape, "causal": causal, "dtype": str(dtype).split(".")[-1],
                        "design": "tensor cores" if tc else "CUDA cores",
                        "max_abs_err_out": err_out, "max_abs_err_lse": err_lse})

    # the serving shape: one admission of 16 slots x 12 heads x 128 tokens
    b, h, t, d, dtype = 16, 12, 128, 64, torch.bfloat16
    q, k, v = _qkv(b, h, t, t, d, dtype, seed=100)
    out, lse = attn.flash_attention(q, k, v, True)
    ref_out, _ = attn.flash_attention_reference(q, k, v, True)
    main_err = (out.float() - ref_out.float()).abs().max().item()
    sdpa = torch.nn.functional.scaled_dot_product_attention  # a yardstick: the port never calls it
    timed = {"kernel": device_ms(lambda: attn.flash_attention(q, k, v, True)),
             "plain": device_ms(lambda: attn.flash_attention_reference(q, k, v, True)),
             "library": device_ms(lambda: sdpa(q, k, v, is_causal=True))}
    clocks = gpu_clocks()
    bound_ms, bound_by = flash_bound_ms(attn.KERNEL, b, h, t, t, d, True)
    main = {"name": attn.KERNEL, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/attention.py:161", "design": DESIGN[attn.KERNEL],
            "max_abs_err": main_err, "ms": timed["kernel"], "plain_ms": timed["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": timed["library"]}
    # the training paths' shapes and layouts, where the forward runs 24
    # times a step
    main["at_train_shapes"] = {}
    for i, (path, (b, h, kv, t, d)) in enumerate(train_attn_shapes().items()):
        q, k, v, _ = _model_qkv(b, h, kv, t, d, seed=101 + i)
        out, _ = attn.flash_attention(q, k, v, True)
        train_err = (out.float() - attn.flash_attention_reference(q, k, v, True)[0].float()
                     ).abs().max().item()
        check(train_err <= 2e-2, f"flash_fwd at the {path} shape: max err {train_err}")
        train = {"kernel": device_ms(lambda: attn.flash_attention(q, k, v, True)),
                 "plain": device_ms(lambda: attn.flash_attention_reference(q, k, v, True)),
                 "library": device_ms(lambda: sdpa(q, k, v, is_causal=True))}
        t_bound, t_by = flash_bound_ms(attn.KERNEL, b, h, t, t, d, True)
        main["at_train_shapes"][path] = {
            "shape": f"{b}x{h}x{t}x{t}x{d} bf16 causal, {kv} KV heads",
            "max_abs_err": train_err, "ms": train["kernel"], "plain_ms": train["plain"],
            "bound_ms": t_bound, "bound_by": t_by, "library_ms": train["library"]}
    # BERT's shapes, non-causal: the serving path of bert runs it 12 times a
    # batch
    main["at_bert_shapes"] = {}
    for i, (name, (b, h, t, d)) in enumerate(BERT_ATTN_SHAPES.items()):
        q, k, v, _ = _model_qkv(b, h, h, t, d, seed=111 + i)
        build.reset_launches()
        out, lse = attn.flash_attention(q, k, v, False)
        torch.cuda.synchronize()
        check(build.launches.get(attn.FWD_TC, 0) == 1, f"flash_fwd at {name}: not on the tensor cores")
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, False)
        err, excess = _excess(out, ref_out, 1e-2)
        err_lse = (lse - ref_lse).abs().max().item()
        check(excess <= 0 and err_lse <= 1e-4,
              f"flash_fwd non-causal at {name}: max err {err}, lse {err_lse}")
        timed = {"kernel": device_ms(lambda: attn.flash_attention(q, k, v, False)),
                 "plain": device_ms(lambda: attn.flash_attention_reference(q, k, v, False)),
                 "library": device_ms(lambda: sdpa(q, k, v, is_causal=False))}
        t_bound, t_by = flash_bound_ms(attn.KERNEL, b, h, t, t, d, False)
        main["at_bert_shapes"][name] = {
            "shape": f"{b}x{h}x{t}x{t}x{d} bf16 non-causal, fused qkv views",
            "max_abs_err": err, "max_abs_err_lse": err_lse, "ms": timed["kernel"],
            "plain_ms": timed["plain"], "bound_ms": t_bound, "bound_by": t_by,
            "library_ms": timed["library"]}
    emit("kernels", cases=results, main_shape="16x12x128x128x64 bf16 causal",
         tolerance={"f32_out": "1e-5 + 1e-5|ref|", "bf16_out": "1e-2 + 1e-2|ref|",
                    "bf16_out_train_shapes": "2e-2 (one bf16 ulp below |out| 4)",
                    "bf16_out_bert_shapes": "1e-2 + 1e-2|ref|",
                    "lse": 1e-4},
         kernel_ms=main["ms"], bound_us=bound_ms * 1e3,
         clocks_sm_max_power_after_timing=clocks, **main)
    return main


# the backward kernels' tolerances against their plain versions: f32, each
# gradient sums up to Tk (dQ) or Tq (dK, dV) products in another order and
# dS = P·(dP − Δ) cancels; bf16, both sides round P and dS to bf16 at the
# same places, and an f32 ulp of difference before a rounding moves it by
# one bf16 ulp (2^-8 relative)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _bwd_inputs(b, h, tq, tk, d, causal, dtype, seed, kv=None):
    """(q, k, v, dO, lse, Δ): contiguous heads, or with ``kv`` KV heads the
    layout a train step gives (``_model_qkv``; bf16, Tq = Tk)."""
    if kv is None:
        q, k, v = _qkv(b, h, tq, tk, d, dtype, seed)
        do = _qkv(b, h, tq, tq, d, dtype, seed + 1000)[0]
    else:
        q, k, v, do = _model_qkv(b, h, kv, tq, d, seed)
    out, lse = attn.flash_attention(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


def _excess(got, ref, tol):
    """(max |err|, the most it exceeds tol + tol·|ref| by, ≤ 0 when within)."""
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff - (tol + tol * ref.float().abs())).max().item()


# the decode-long cell's attention: its 256 slots and the engine's scratch
# one, GPT-2 125M's 12 heads x 64, a 912-position bf16 cache; positions
# drawn from 32-736, 384 on average as the cell's slots' are
DECODE_CELL = (257, 12, 12, 912, 64)
DECODE_POS = (32, 736)


def decode_bound_ms(pos, h, kv, d, elt=2) -> float:
    """The least time for ``decode_attend``'s work: the K and V rows of
    the attended positions (``pos + 1`` a slot and KV head), q, the
    output and ``pos``, each moved once over HBM bandwidth (bytes bound it:
    half an operation a byte)."""
    b = pos.numel()
    rows = int((pos + 1).sum()) * kv
    nbytes = 2 * rows * d * elt + 2 * b * h * d * elt + 8 * b
    return nbytes / PEAK_BYTES_PER_S * 1e3


def phase_decode_kernel():
    """``decode_attend`` at the decode-long cell's shape against its plain
    version (1e-2 absolute and relative: the plain version rounds the
    weights to bf16 before P·V, the kernel rounds its f32 result once),
    then its device time, the plain version's and SDPA's with the same mask
    (a yardstick the port never calls), beside its bytes bound; warm L2 (it
    holds 50 of the ~300 MB a call reads)."""
    b, h, kv, s, d = DECODE_CELL
    g = torch.Generator(device="cuda").manual_seed(200)
    q = torch.randn(b, h, 1, d, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, kv, s, d, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    pos = torch.randint(DECODE_POS[0], DECODE_POS[1] + 1, (b,), generator=g, device="cuda")
    build.reset_launches()
    out = attn.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    check(build.launches.get(attn.DECODE_KERNEL, 0) == 1,
          f"decode_kernel: {build.launches.get(attn.DECODE_KERNEL, 0)} launches for one call")
    plain = lambda: attn.decode_attention_reference(q, k, v, pos)
    err, excess = _excess(out, plain().transpose(1, 2).reshape(b, 1, h * d), 1e-2)
    check(excess <= 0, f"decode_kernel: max err {err} against the plain version")
    mask = (torch.arange(s, device="cuda") <= pos[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {"kernel": device_ms(lambda: attn.decode_attention(q, k, v, pos)),
             "plain": device_ms(plain),
             "library": device_ms(lambda: sdpa(q, k, v, attn_mask=mask))}
    clocks = gpu_clocks()
    bound_ms = decode_bound_ms(pos, h, kv, d)
    row = {"name": attn.DECODE_KERNEL, "route": "cuda",
           "source": "ray_tpu_torch/ops/csrc/decode_attend.cu", "replaces": "none, added",
           "design": "a block per (slot, KV head) over 0..pos, 16-byte loads of the bf16 "
                     "cache, f32 online softmax",
           "shape": f"{b}x{h}x{s}x{d} bf16, positions {DECODE_POS[0]}-{DECODE_POS[1]} "
                    f"(mean {float(pos.float().mean()):.1f})",
           "max_abs_err": err, "ms": timed["kernel"], "plain_ms": timed["plain"],
           "library_ms": timed["library"],
           "bound_ms": bound_ms, "bound_by": "bytes",
           "roofline_pct": 100 * bound_ms / timed["kernel"]}
    emit("decode_kernel", kernel_ms=row["ms"], bound_us=bound_ms * 1e3,
         clocks_sm_max_power_after_timing=clocks, **row)
    return row


def phase_bwd_kernels():
    """flash_bwd_dq and flash_bwd_dkv against flash_dq_reference and
    flash_dkv_reference, given the same lse and Δ (from the forward
    kernel), at the training paths' shapes and layouts (bf16: GPT-2 at
    T 256 and 1024, Llama's GQA at T 2048) and at small f32 (TF32 off),
    rectangular and ragged shapes.  One ``kernel_case`` line per shape
    with errors, times, bounds and launch counts; returns the two kernels'
    rows at the GPT-2 training shape."""
    shapes = train_attn_shapes()
    b, h, kv, t, d = shapes["train_gpt2"]
    main_case = (b, h, t, t, d, True, torch.bfloat16, kv)
    cases = [(b, h, 256, 256, d, True, torch.bfloat16, kv), main_case]
    lb, lh, lkv, lt, ld = shapes["train_llama"]
    llama_case = (lb, lh, lt, lt, ld, True, torch.bfloat16, lkv)
    cases.append(llama_case)
    cases += [(2, 4, 128, 128, dd, c, torch.float32, None) for dd in (16, 64) for c in (False, True)]
    cases += [(2, 4, 128, 256, 64, c, torch.float32, None) for c in (False, True)]
    cases += [(2, 3, 97, 97, 32, True, torch.float32, None),
              (2, 3, 97, 131, 128, False, torch.bfloat16, None)]
    cases += [(*c[:7], c[1] if len(c) > 7 else None) for c in TC_EDGE_CASES]  # fused: KV = H
    rows = {}
    for i, case in enumerate(cases):
        b_, h_, tq, tk, d_, causal, dtype, kv_ = case
        args = _bwd_inputs(b_, h_, tq, tk, d_, causal, dtype, seed=200 + i, kv=kv_)
        build.reset_launches()
        dq = attn.flash_bwd_dq(*args, causal)
        dk, dv = attn.flash_bwd_dkv(*args, causal)
        torch.cuda.synchronize()
        tc = int(attn.uses_tensor_cores(dtype, d_))
        want = {attn.DQ_KERNEL: 1, attn.DQ_TC: tc, attn.DKV_KERNEL: 1, attn.DKV_TC: tc}
        launches = {n: build.launches.get(n, 0) for n in want}
        check(launches == want, f"backward launches {launches}, want {want}")
        check(torch.equal(dq, attn.flash_bwd_dq(*args, causal)),
              f"flash_bwd_dq gave other bits on a second call at {case}")
        dk2, dv2 = attn.flash_bwd_dkv(*args, causal)
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash_bwd_dkv gave other bits on a second call at {case}")
        ref_dq = attn.flash_dq_reference(*args, causal)
        ref_dk, ref_dv = attn.flash_dkv_reference(*args, causal)
        tol = BWD_TOL[dtype]
        shape = f"{b_}x{h_}x{tq}x{tk}x{d_}" + (f", {kv_} KV heads" if kv_ else "")
        errs = {}
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            check(bool(torch.isfinite(got).all()), f"{name} non-finite at {shape}")
            errs[name], excess = _excess(got, ref, tol)
            check(excess <= 0, f"{name} disagrees at {shape} {dtype}: max err {errs[name]}")
        main = case == main_case
        timed = {name: device_ms(fn) for name, fn in (
            (attn.DQ_KERNEL, lambda: attn.flash_bwd_dq(*args, causal)),
            ("plain_dq", lambda: attn.flash_dq_reference(*args, causal)),
            (attn.DKV_KERNEL, lambda: attn.flash_bwd_dkv(*args, causal)),
            ("plain_dkv", lambda: attn.flash_dkv_reference(*args, causal)))}
        row = {"shape": shape, "causal": causal, "dtype": str(dtype).split(".")[-1],
               "tolerance": f"{tol} + {tol}|ref|", "max_abs_err": errs, "launches": launches,
               "dq_dk_dv_bit_identical_on_a_second_call": True}
        for kern, plain, err in ((attn.DQ_KERNEL, "plain_dq", errs["dq"]),
                                 (attn.DKV_KERNEL, "plain_dkv", max(errs["dk"], errs["dv"]))):
            bound_ms, bound_by = flash_bound_ms(kern, b_, h_, tq, tk, d_, causal, dtype)
            row[kern] = {"kernel_ms": timed[kern], "plain_ms": timed[plain],
                         "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            if main:
                rows[kern] = {"name": kern, "route": "cuda", "design": DESIGN[kern],
                              "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                              "replaces": ("ray_tpu/ops/attention.py:250" if kern == attn.DQ_KERNEL
                                           else "ray_tpu/ops/attention.py:292"),
                              "max_abs_err": err, "ms": timed[kern], "plain_ms": timed[plain],
                              "bound_ms": bound_ms, "bound_by": bound_by}
        if case in (main_case, llama_case):
            row["library_dq_dk_dv_ms"] = library_backward_ms(*args[:4])
            row["kernels_dq_plus_dkv_ms"] = timed[attn.DQ_KERNEL] + timed[attn.DKV_KERNEL]
        if main:
            for kern in rows:
                rows[kern]["library_ms"] = row["library_dq_dk_dv_ms"]
        emit("kernel_case", **row)
    check(set(rows) == {attn.DQ_KERNEL, attn.DKV_KERNEL}, "no training-shape backward rows")
    emit("kernels_bwd", main_shape=f"{b}x{h}x{t}x{t}x{d} bf16 causal",
         library_note="library_ms is F.scaled_dot_product_attention's backward "
                      "(the kernels of forward+backward minus those of the forward, "
                      "profiler device time): dQ, dK and dV together, on both rows; "
                      "the port never calls it",
         clocks_sm_max_power_after_timing=gpu_clocks(), rows=list(rows.values()))
    return rows


def library_backward_ms(q, k, v, do):
    """The device time of ``F.scaled_dot_product_attention``'s backward
    (dQ, dK and dV together) at these inputs: the kernels of forward plus
    backward, minus those of the forward (``device_ms``).  A yardstick
    only."""
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_bwd = device_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True),
                                                    (qg, kg, vg), do))
    return fwd_bwd - device_ms(lambda: sdpa(qg, kg, vg, is_causal=True))


def _to(params, device):
    """A copy of a params tree on ``device``."""
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device, copy=True)
            for k, v in params.items()}


def phase_parity():
    """The same weights on the CPU and on the card (f32, TF32 off)."""
    from ray_tpu_torch.models import generate as gen, gpt2, llama

    rows = []
    specs = [("gpt2_tiny", gpt2, gpt2.GPT2Config.tiny(dtype=torch.float32), 1e-4),
             ("llama_tiny", llama, llama.LlamaConfig.tiny(dtype=torch.float32), 1e-4),
             ("gpt2_125m_2layers", gpt2,
              gpt2.GPT2Config.gpt2_small(n_layers=2, dtype=torch.float32), 1e-3)]
    rng = np.random.default_rng(0)
    for name, mod, cfg, atol in specs:
        p_cpu = mod.init(cfg, torch.Generator().manual_seed(1), device="cpu")
        p_gpu = _to(p_cpu, "cuda")
        lengths = [5, 11, 8]
        prompts = np.zeros((3, max(lengths)), np.int64)
        for j, n in enumerate(lengths):
            prompts[j, :n] = rng.integers(1, cfg.vocab_size, n)
        streams, logits = {}, {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            toks = torch.from_numpy(prompts).to(dev)
            lens = torch.tensor(lengths, device=dev)
            cache = gen.init_cache(cfg, 3, max(lengths), device=dev)
            before = build.launches.get(attn.KERNEL, 0)
            with torch.inference_mode():
                logits[dev], _ = gen.prefill(params, cfg, toks, lens, cache, 0)
                streams[dev] = gen.generate(params, cfg, toks, lens, max_new_tokens=16).tolist()
            grew = build.launches.get(attn.KERNEL, 0) - before
            if dev == "cuda":
                check(grew == 2 * cfg.n_layers,
                      f"{name}: {grew} flash launches on the card, want {2 * cfg.n_layers}")
        err = (logits["cpu"] - logits["cuda"].cpu()).abs().max().item()
        check(err <= atol, f"{name}: prefill logits differ by {err} > {atol}")
        check(streams["cpu"] == streams["cuda"], f"{name}: greedy streams differ\n"
              f"cpu  {streams['cpu']}\ncuda {streams['cuda']}")
        rows.append({"model": name, "logits_max_abs_err": err, "atol": atol,
                     "streams_equal": True, "tokens": len(streams["cuda"][0])})
    emit("parity", models=rows)


def phase_train_parity():
    """The same weights and batches on the CPU and on the card, f32 with
    TF32 off.  Tiny GPT-2, Llama and GPT-2 with 4 Switch experts: 5 train
    steps of
    ``make_optimizer(lr=1e-3, warmup=2, total_steps=10)``, remat "dots" on
    the card and none on the CPU; per-step losses within 1e-4 and final
    params within 2e-4 (a fifth of one Adam step at lr 1e-3).  The sums
    run in another order on the card, and the embedding backward
    accumulates with atomics there, in an order that changes from run to
    run; Adam divides whatever differs by sqrt(v) + eps.  GPT-2 at full
    width, two layers: the loss within 1e-5 and every gradient leaf within
    1e-4 of that leaf's largest entry."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.models.transformer import named_leaves, train_state

    rows = []
    rng = np.random.default_rng(1)
    moe_tiny = lambda **kw: gpt2.GPT2Config.tiny(n_experts=MOE_EXPERTS, **kw)
    for name, mod, cfg_fn in (("gpt2_tiny", gpt2, gpt2.GPT2Config.tiny),
                              ("llama_tiny", llama, llama.LlamaConfig.tiny),
                              ("gpt2_moe_tiny", gpt2, moe_tiny)):
        cfgs = {"cpu": cfg_fn(dtype=torch.float32),
                "cuda": cfg_fn(dtype=torch.float32, remat=True, remat_policy="dots")}
        params = mod.init(cfgs["cpu"], torch.Generator().manual_seed(2), device="cpu")
        toks = torch.from_numpy(rng.integers(0, cfgs["cpu"].vocab_size, (4, 65)))
        losses, finals = {}, {}
        for dev, cfg in cfgs.items():
            opt = mod.make_optimizer(lr=1e-3, warmup=2, total_steps=10)
            state, step = train_state(_to(params, dev), opt), mod.make_train_step(cfg, opt)
            build.reset_launches()
            ls = []
            for _ in range(5):
                state, m = step(state, {"tokens": toks.to(dev)})
                ls.append(m["loss"])
            losses[dev] = [x.item() for x in ls]
            finals[dev] = dict(named_leaves(state["params"]))
            launches = dict(build.launches)
        per_step = 5 * cfgs["cuda"].n_layers
        check(launches.get(attn.DQ_KERNEL) == per_step and launches.get(attn.DKV_KERNEL) == per_step,
              f"{name}: backward launches {launches} on the card, want {per_step} each")
        loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        param_err = max((finals["cuda"][n].detach().cpu() - t.detach()).abs().max().item()
                        for n, t in finals["cpu"].items())
        check(loss_err <= 1e-4, f"{name}: losses differ by {loss_err}")
        check(param_err <= 2e-4, f"{name}: params differ by {param_err} after 5 steps")
        rows.append({"model": name, "steps": 5, "losses_cpu": losses["cpu"],
                     "losses_cuda": losses["cuda"], "loss_max_abs_err": loss_err,
                     "param_max_abs_err": param_err, "launches_cuda": launches})

    cfgs = {"cpu": gpt2.GPT2Config.gpt2_small(n_layers=2, dtype=torch.float32, remat=False),
            "cuda": gpt2.GPT2Config.gpt2_small(n_layers=2, dtype=torch.float32)}
    params = gpt2.init(cfgs["cpu"], torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(rng.integers(0, 50257, (2, 129)))
    loss, grads = {}, {}
    for dev, cfg in cfgs.items():
        p = _to(params, dev)
        for _, t in named_leaves(p):
            t.requires_grad_(True)
        out = gpt2.loss_fn(p, {"tokens": toks.to(dev)}, cfg)
        out.backward()
        loss[dev] = out.item()
        grads[dev] = {n: t.grad.cpu() for n, t in named_leaves(p)}
    loss_err = abs(loss["cpu"] - loss["cuda"])
    check(loss_err <= 1e-5, f"gpt2_125m_2layers: loss differs by {loss_err}")
    worst = 0.0
    for n, g in grads["cpu"].items():
        rel = (grads["cuda"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        check(rel <= 1e-4, f"gpt2_125m_2layers: grad {n} differs by {rel} of its largest entry")
        worst = max(worst, rel)
    rows.append({"model": "gpt2_125m_2layers", "loss_cpu": loss["cpu"], "loss_cuda": loss["cuda"],
                 "loss_abs_err": loss_err, "grad_max_err_over_leaf_max": worst,
                 "leaves": len(grads["cpu"])})
    emit("train_parity", models=rows)


def _train_batch(vocab, b, t):
    """Inputs and targets as ``bench.py`` makes them (numpy default_rng(0))."""
    rng = np.random.default_rng(0)
    return {"inputs": torch.from_numpy(rng.integers(0, vocab, (b, t), np.int32)).long().cuda(),
            "targets": torch.from_numpy(rng.integers(0, vocab, (b, t), np.int32)).long().cuda()}


def train(family: str, cfg, batch_size: int, warmup: int, windows, phase: str = None):
    """The training path through the port's entry points: ``init_state``,
    ``make_optimizer(lr=3e-4)``, ``make_train_step``; ``warmup`` steps,
    then timed windows of steps (host clock, each ending in a loss read).
    Launch counts are set to 0 just before the first step and read just
    after the last.  Emits ``phase`` (``train_<family>`` when None)."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.util import flops

    mod = {"gpt2": gpt2, "llama": llama}[family]
    opt = mod.make_optimizer(lr=3e-4)
    t0 = time.perf_counter()
    state = mod.init_state(cfg, torch.Generator().manual_seed(0), opt, device="cuda")
    step = mod.make_train_step(cfg, opt)
    batch = _train_batch(cfg.vocab_size, batch_size, cfg.max_seq_len)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(warmup):
        state, m = step(state, batch)
    first_loss = m["loss"].item() if warmup else None
    warmup_s = time.perf_counter() - t0
    ms_per_step, losses = [], []
    for n in windows:
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
        losses.append(m["loss"].item())
        ms_per_step.append((time.perf_counter() - t0) * 1e3 / n)
    launches = dict(build.launches)
    n_steps = warmup + sum(windows)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(x) for x in [first_loss or 0.0] + losses), f"{family}: non-finite loss")
    per_step = {n: launches.get(n, 0) / n_steps
                for n in (attn.KERNEL, attn.DQ_KERNEL, attn.DKV_KERNEL)}
    want = {attn.KERNEL: (2 if cfg.remat else 1) * cfg.n_layers,  # remat recomputes it
            attn.DQ_KERNEL: cfg.n_layers, attn.DKV_KERNEL: cfg.n_layers}
    check(per_step == want, f"{family}: {per_step} launches per step, want {want}")
    tc = {c: launches.get(c, 0) for c in attn.TENSOR_CORE_COUNTER.values()}
    check(tc == {c: launches[k] for k, c in attn.TENSOR_CORE_COUNTER.items()},
          f"{family}: tensor-core launches {tc} of {launches}: every bf16 one should be")
    tokens = batch_size * cfg.max_seq_len
    tok_s = sorted(tokens / (ms / 1e3) for ms in ms_per_step)
    n_params = mod.num_params(state["params"])
    fpt = flops.model_flops_per_token(cfg, n_params)
    kind = torch.cuda.get_device_name(0)
    experts = (f", {cfg.n_experts} experts (cf {cfg.capacity_factor}, aux "
               f"{cfg.moe_aux_weight})" if getattr(cfg, "n_experts", 0) else "")
    row = {"model": f"{family} 125M{experts} bf16 (f32 master weights), remat {cfg.remat_policy}",
           "params": n_params, "batch": batch_size, "seq_len": cfg.max_seq_len,
           "steps": n_steps, "warmup_steps": warmup, "windows": list(windows),
           "setup_s": setup_s, "warmup_s": warmup_s, "ms_per_step_by_window": ms_per_step,
           "tokens_per_s_median": tok_s[len(tok_s) // 2], "tokens_per_s_best": tok_s[-1],
           "flops_per_token": fpt, "peak_flops": flops.peak_flops(kind),
           "mfu_median": flops.mfu(tok_s[len(tok_s) // 2], fpt, kind),
           "mfu_best": flops.mfu(tok_s[-1], fpt, kind),
           "peak_mem_bytes": peak, "first_loss": first_loss, "window_last_losses": losses,
           "launches": launches, "launches_per_step": per_step}
    emit(phase or f"train_{family}", **row)
    return state, step, batch, launches, row


# the device work of a step by kind, matched on the kernel's name in order
_KINDS = (("flash attention", ("flash_fwd_kernel", "flash_bwd_")),
          ("matrix products", ("nvjet", "gemm", "cutlass", "xmma")),
          ("indexing and scans (MoE routing, embeddings)",
           ("index", "Index", "gather", "scatter", "scan", "embedding")),
          ("optimizer (foreach)", ("multi_tensor_apply",)),
          ("reductions", ("reduce_kernel",)),
          ("copies and casts", ("copy", "Memcpy", "Memset")),
          ("elementwise", ("elementwise",)))


def phase_train_profile(state, step, batch, ms_per_step, phase="train_profile",
                        model="gpt2 125M bf16, B 6 x T 1024, remat dots"):
    """Where one training step's device time goes.  Device wall per step
    from CUDA events around 3 unprofiled steps; then one step under
    torch.profiler: kernel time (user annotations excluded, they overlap
    the kernels), the three flash kernels' time and share, the time by
    kind of kernel, and the top kernels.  The profiler slows the host, so
    the idle share is taken against the unprofiled device wall; the
    profiled step's own wall is printed beside it.  Returns the step's
    device work in ms."""
    ev = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start, end = ev(), ev()
    start.record()
    for _ in range(3):
        state, _ = step(state, batch)
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / 3
    start, end = ev(), ev()

    profiled = {}

    def profiled_step():
        start.record()
        profiled["metrics"] = step(state, batch)[1]  # the state in place
        end.record()

    dev_events = profiled_events(profiled_step, phase)
    profiled_ms = start.elapsed_time(end)
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    flash = {}
    for kern in (attn.KERNEL, attn.DQ_KERNEL, attn.DKV_KERNEL):
        hits = [(n, c, us) for n, (c, us) in by_name.items() if f"{kern}_kernel" in n]
        flash[kern] = {"launches": sum(c for _, c, _ in hits),
                       "tensor_core_launches": sum(c for n, c, _ in hits if f"{kern}_kernel_tc" in n),
                       "device_ms": sum(us for _, _, us in hits) / 1e3}
        flash[kern]["share_of_step"] = flash[kern]["device_ms"] / wall_ms
    for kern in flash:
        check(flash[kern]["launches"] > 0
              and flash[kern]["tensor_core_launches"] == flash[kern]["launches"],
              f"{phase}: {kern} ran other kernels than the tensor-core design: {flash}")
    kinds = {}
    for n, (c, us) in by_name.items():
        kind = next((k for k, keys in _KINDS if any(key in n for key in keys)), "other")
        kc, kms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (kc + c, kms + us / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    emit(phase, model=model, step_device_wall_ms=wall_ms, host_ms_per_step=ms_per_step,
         profiled_step_device_wall_ms=profiled_ms, device_busy_ms=busy_ms,
         busy_share=busy_ms / wall_ms, idle_share=1 - busy_ms / wall_ms,
         kernels_in_step=len(dev_events), flash=flash,
         flash_share_of_step=sum(f["share_of_step"] for f in flash.values()),
         by_kind=[{"kind": k, "kernels": c, "ms": ms, "share_of_step": ms / wall_ms}
                  for k, (c, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1])],
         top_kernels=[{"name": n[:100], "count": c, "ms": us / 1e3, "share_of_step": us / 1e3 / wall_ms}
                      for n, (c, us) in top],
         loss=profiled["metrics"]["loss"].item())
    return busy_ms


def serve(family: str):
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config

    cfg = make_config(family, "125m")
    t0 = time.perf_counter()
    warm = GenerationEngine(cfg, seed=0, device="cuda", **SERVE).start()
    try:  # first calls of every shape, on an engine whose numbers are dropped
        warm.generate([1] * 8, 4, timeout=600)
    finally:
        warm.stop()
    params = warm.params
    del warm
    setup_s = time.perf_counter() - t0
    eng = GenerationEngine(cfg, params, device="cuda", **SERVE).start()
    rng = np.random.default_rng(0)
    vocab = min(50000, cfg.vocab_size)
    prompts = [rng.integers(1, vocab, rng.integers(16, 100)).tolist()
               for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    done_at = {}
    try:
        build.reset_launches()
        t_start = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            f = eng.submit(p, NEW_TOKENS)
            f.add_done_callback(lambda _f, i=i: done_at.__setitem__(i, time.perf_counter()))
            futs.append(f)
        outs = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t_start
        launches = dict(build.launches)
    finally:
        eng.stop()
    peak = torch.cuda.max_memory_allocated()
    for i, o in enumerate(outs):
        check(len(o) == NEW_TOKENS, f"{family}: request {i} returned {len(o)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o), f"{family}: token out of range")
    stats, perf = eng.stats(), eng.perf_stats()
    flash = launches.get(attn.KERNEL, 0)
    check(flash > 0, f"{family}: the serving run launched no flash_fwd kernel")
    check(flash == cfg.n_layers * stats["prefills"],
          f"{family}: {flash} flash launches for {stats['prefills']} admissions")
    check(launches.get(attn.FWD_TC, 0) == flash,
          f"{family}: {launches.get(attn.FWD_TC, 0)} of {flash} prefill launches on the tensor cores")
    check(launches.get(attn.DECODE_KERNEL, 0) == cfg.n_layers * stats["decode_steps"],
          f"{family}: {launches.get(attn.DECODE_KERNEL, 0)} decode_attend launches for "
          f"{stats['decode_steps']} decode steps")
    lats = [done_at[i] - t_start for i in range(N_REQUESTS)]
    ms = lambda s: None if s is None else s * 1e3
    row = {
        "model": f"{family} 125M bf16", "params": num_params(params),
        "requests": N_REQUESTS, "new_tokens_per_req": NEW_TOKENS, "setup_s": setup_s,
        "wall_s": wall, "tokens_per_s": sum(len(o) for o in outs) / wall,
        "req_p50_ms": pct(lats, 0.5) * 1e3, "req_p99_ms": pct(lats, 0.99) * 1e3,
        "ttft_p50_ms": ms(perf["ttft"]["p50_s"]), "ttft_p99_ms": ms(perf["ttft"]["p99_s"]),
        "itl_p50_ms": ms(perf["itl"]["p50_s"]), "itl_p99_ms": ms(perf["itl"]["p99_s"]),
        "itl_samples": perf["itl"]["count"], "itl_tokens_per_sample": perf["itl"]["tokens_per_sample"],
        "itl_back_to_back": perf["itl"]["back_to_back"],
        "peak_mem_bytes": peak, "flash_launches": flash,
        "decode_attend_launches": launches.get(attn.DECODE_KERNEL, 0),
        "flash_launches_tensor_core": launches.get(attn.FWD_TC, 0), "admissions": stats["prefills"],
        "ticks": perf["ticks"], "decode_tick_baseline_ms": ms(perf["decode_tick_baseline_s"]),
        "interference_frac": perf["interference_frac"], **{k: v for k, v in SERVE.items()
                                                          if k != "prefill_buckets"},
    }
    emit(f"serve_{family}", **row)
    return launches, params, cfg, row, dict(zip(map(tuple, prompts), outs))


def phase_decode_profile(params, cfg, n_slots: int, max_len: int):
    """Where a decode step's time goes: host enqueue time against device
    time, and kernels launched per step (torch.profiler)."""
    from ray_tpu_torch.models import generate as gen

    steps = 20
    cache = gen.init_cache(cfg, n_slots, max_len, device="cuda")
    toks = torch.ones(n_slots, dtype=torch.long, device="cuda")
    active = torch.zeros(n_slots, dtype=torch.bool, device="cuda")  # pos stays 0
    with torch.inference_mode():
        for _ in range(3):
            gen.decode_step(params, cfg, cache, toks, active)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            gen.decode_step(params, cfg, cache, toks, active)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        device_ms = start.elapsed_time(end) / steps
        # a whole chunk as the engine runs it (sampling included), from
        # this thread: tells the chunk's own cost from the engine's
        t0 = time.perf_counter()
        gen.decode_chunk(params, cfg, cache, toks, active, steps=steps)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3 / steps

    def in_thread(out):  # the same steps from a second thread, as the engine runs them
        with torch.inference_mode():
            t1 = time.perf_counter()
            for _ in range(steps):
                gen.decode_step(params, cfg, cache, toks, active)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t1) * 1e3 / steps)

    thread_ms = []
    worker = threading.Thread(target=in_thread, args=(thread_ms,))
    worker.start()
    worker.join()
    check(len(thread_ms) == 1, "decode_profile: the threaded run failed")
    with torch.inference_mode():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                gen.decode_step(params, cfg, cache, toks, active)
            torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / 5
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("decode_profile", model="gpt2 125M bf16", slots=n_slots, cache_len=max_len,
         host_enqueue_ms_per_step=host_ms, wall_ms_per_step=wall_ms,
         device_ms_per_step=device_ms, decode_chunk_ms_per_step=chunk_ms,
         thread_ms_per_step=thread_ms[0],
         device_kernels_per_step=len(dev_events) / 5,
         device_busy_ms_per_step=busy_ms if dev_events else None,
         idle_share=(1 - busy_ms / device_ms) if dev_events else None,
         kernels_per_step_by_name=[{"name": n[:80], "per_step": c / 5, "us_per_step": us / 5}
                                   for n, (c, us) in top])


def phase_bert_parity():
    """Tiny BERT, and BERT-base's width with two layers, in f32 (TF32 off):
    the same weights and tokens on the CPU and on the card, with and
    without token types.  The logits agree within 1e-4 (post-LN keeps
    them small: the pooler's tanh, then a 0.02-scale classifier) and the
    argmax labels are equal.  The card runs the non-causal CUDA-core
    forward (f32), once per layer per call."""
    from ray_tpu_torch.models import bert

    rows, atol = [], 1e-4
    rng = np.random.default_rng(3)
    for name, cfg in (("bert_tiny", bert.BertConfig.tiny(dtype=torch.float32)),
                      ("bert_base_2layers", bert.BertConfig.base(n_layers=2, dtype=torch.float32))):
        params = bert.init(cfg, torch.Generator().manual_seed(4), device="cpu")
        toks = rng.integers(0, cfg.vocab_size, (4, 96))
        types = rng.integers(0, cfg.type_vocab_size, (4, 96))
        bert.check_tokens(toks, cfg, types)
        out = {}
        for dev, p in (("cpu", params), ("cuda", _to(params, "cuda"))):
            build.reset_launches()
            with torch.inference_mode():
                for with_types in (False, True):
                    tt = torch.from_numpy(types).to(dev) if with_types else None
                    out[dev, with_types] = bert.apply(p, torch.from_numpy(toks).to(dev), cfg,
                                                      tt).cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                check(build.launches.get(attn.KERNEL, 0) == 2 * cfg.n_layers,
                      f"{name}: {dict(build.launches)} flash launches, want {2 * cfg.n_layers}")
        errs = {}
        for with_types in (False, True):
            cpu, card = out["cpu", with_types], out["cuda", with_types]
            check(bool(torch.isfinite(card).all()), f"{name}: non-finite logits on the card")
            errs[with_types] = (card - cpu).abs().max().item()
            check(errs[with_types] <= atol, f"{name}: logits differ by {errs[with_types]}")
            check(torch.equal(card.argmax(-1), cpu.argmax(-1)), f"{name}: labels differ")
        rows.append({"model": name, "batch": "4 x 96", "atol": atol,
                     "logits_max_abs_err": errs[False],
                     "logits_max_abs_err_with_token_types": errs[True], "labels_equal": True})
    emit("bert_parity", models=rows)


def serve_bert(root: str):
    """BASELINE config 5's replica body (``bench.py`` ``run_serve_bench``'s
    ``Bert``) without the Serve runtime: BERT-base at full width in bf16,
    random weights from seed 0, loaded as a user would,
    ``Checkpoint.from_dict`` -> ``to_directory`` -> ``from_directory`` ->
    ``TorchPredictor.from_checkpoint``.  The blocks are cast to bf16 once
    before the checkpoint is written (``serve/llm.py``'s ``_cast_params``);
    the embeddings, their norm, the pooler and the classifier stay f32, as
    ``bert.apply`` reads them.  Traffic: ``BERT_REQUESTS`` sequences of
    ``BERT_SEQ`` ids in batches of ``BERT_BATCH`` (a short batch padded
    with zeros), each batch checked on the host, predicted, labels read
    back; ``BERT_WARMUP`` batches first.  Launch counts are set to 0 just
    before the batches and read just after: ``flash_fwd`` runs once per
    layer per batch, on the tensor cores.  Then one batch under
    torch.profiler (device work, kernels per batch, idle share against
    the median batch's host wall), and batch 0's logits against the same
    weights in f32 on the card (CUDA-core attention), within 5e-2 (bf16
    through 12 blocks), with equal labels wherever the f32 logits' margin
    exceeds twice that.  The checkpoint is written under ``root``, which
    the caller removes after ``batch_predict_bert`` has read it.  Returns
    the launches, and the checkpoint's directory, the labels and
    sequences/s."""
    import dataclasses

    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train import TorchPredictor

    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    served = dict(params, blocks={k: v.to(cfg.dtype) for k, v in params["blocks"].items()})
    path = Checkpoint.from_dict({"params": served}).to_directory(
        os.path.join(root, "bert"))
    ckpt_bytes = sum(e.stat().st_size for e in os.scandir(path))
    pred = TorchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                          lambda p, toks: bert.apply(p, toks, cfg),
                                          device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def replica(toks):  # bench.py's Bert.__call__
        n = len(toks)
        if n < BERT_BATCH:  # one static batch shape for every arrival pattern
            toks = np.concatenate([toks, np.zeros((BERT_BATCH - n, toks.shape[1]), toks.dtype)])
        bert.check_tokens(toks, cfg)
        logits = pred.predict(toks)
        return logits[:n].argmax(-1), logits[:n]

    requests = np.random.default_rng(0).integers(1, BERT_ID_HIGH, (BERT_REQUESTS, BERT_SEQ))
    batches = [requests[i:i + BERT_BATCH] for i in range(0, BERT_REQUESTS, BERT_BATCH)]
    for b in batches[:BERT_WARMUP]:
        replica(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, labels, logits = [], [], []
    build.reset_launches()
    t_start = time.perf_counter()
    for b in batches:
        t0 = time.perf_counter()
        lab, lg = replica(b)
        lat.append(time.perf_counter() - t0)
        labels.append(lab)
        logits.append(lg)
    wall = time.perf_counter() - t_start
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * len(batches)
    got = (launches.get(attn.KERNEL, 0), launches.get(attn.FWD_TC, 0))
    check(got == (want, want), f"serve_bert: flash_fwd launches (all, tensor-core) {got}, "
                               f"want {want} each")
    logits = np.concatenate(logits)
    check(logits.shape == (BERT_REQUESTS, cfg.num_classes) and bool(np.isfinite(logits).all()),
          f"serve_bert: logits of shape {logits.shape}, finite {np.isfinite(logits).all()}")

    dev_events = profiled_events(lambda: replica(batches[0]), "serve_bert")
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    flash_ms = sum(us for n, (_, us) in by_name.items() if "flash_fwd_kernel" in n) / 1e3

    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.inference_mode():
        ref = bert.apply(_to(params, "cuda"), torch.from_numpy(batches[0]).cuda(), ref_cfg).cpu().numpy()
    tol = 5e-2
    err = float(np.abs(logits[:BERT_BATCH] - ref).max())
    check(err <= tol, f"serve_bert: bf16 logits differ from f32 by {err}")
    sure = np.abs(ref[:, 0] - ref[:, 1]) > 2 * tol
    check(bool((labels[0][sure] == ref.argmax(-1)[sure]).all()),
          "serve_bert: a bf16 label differs from f32 where the margin is clear")
    p50 = pct(lat, 0.5) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit("serve_bert", model="bert-base bf16 (blocks bf16; embeddings, pooler, classifier f32)",
         params=num_params(params), checkpoint_bytes=ckpt_bytes, load_s=load_s,
         requests=BERT_REQUESTS, seq_len=BERT_SEQ, batch=BERT_BATCH, batches=len(batches),
         warmup_batches=BERT_WARMUP, wall_s=wall, sequences_per_s=BERT_REQUESTS / wall,
         batch_p50_ms=p50, batch_p99_ms=pct(lat, 0.99) * 1e3, batch_max_ms=max(lat) * 1e3,
         device_ms_per_batch=busy_ms, kernels_per_batch=len(dev_events),
         flash_ms_per_batch=flash_ms, idle_share_vs_p50=1 - busy_ms / p50,
         peak_mem_bytes=peak, launches=launches, flash_launches_per_batch=want / len(batches),
         label_counts=np.bincount(np.concatenate(labels), minlength=cfg.num_classes).tolist(),
         batch0_logits_max_abs_err_vs_f32=err, tolerance_vs_f32=tol,
         batch0_labels_checked=int(sure.sum()),
         top_kernels=[{"name": n[:100], "count": c, "ms": us / 1e3} for n, (c, us) in top])
    return launches, {"checkpoint": path, "labels": np.concatenate(labels),
                      "sequences_per_s": BERT_REQUESTS / wall}


def moe_layer_ms(cfg, b: int, t: int) -> dict:
    """The device time of one layer's FFN at a train step's shape, as the
    step runs it (f32 master weights cast to bf16 inside, the router f32):
    the Switch MoE and, beside it, the dense FFN of the same width;
    forward, and forward with backward (``device_ms``, each session's
    kernel count beside it)."""
    from ray_tpu_torch.ops import moe

    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator().manual_seed(5)
    mp = {k: v[0].clone().requires_grad_(True)
          for k, v in moe.init_moe_params(g, 1, D, Fd, E, device="cuda").items()}
    dp = {"w1": (torch.randn(D, Fd, generator=g) * 0.02).cuda().requires_grad_(True),
          "b1": torch.zeros(Fd, device="cuda", requires_grad=True),
          "w2": (torch.randn(Fd, D, generator=g) * 0.02).cuda().requires_grad_(True),
          "b2": torch.zeros(D, device="cuda", requires_grad=True)}
    x = torch.randn(b, t, D, device="cuda").to(cfg.dtype).requires_grad_(True)
    dy = torch.randn(b, t, D, device="cuda").to(cfg.dtype)
    c = lambda w: w.to(cfg.dtype)

    def moe_fwd():
        return moe.moe_ffn(x, mp["router"], c(mp["ew1"]), c(mp["eb1"]), c(mp["ew2"]),
                           c(mp["eb2"]), capacity_factor=cfg.capacity_factor)

    def dense_fwd():
        h = torch.nn.functional.gelu(x @ c(dp["w1"]) + c(dp["b1"]), approximate="tanh")
        return h @ c(dp["w2"]) + c(dp["b2"])

    def moe_fwd_bwd():
        y, aux = moe_fwd()
        torch.autograd.grad((y, aux), [x, *mp.values()], (dy, torch.ones_like(aux)))

    def dense_fwd_bwd():
        torch.autograd.grad(dense_fwd(), [x, *dp.values()], dy)

    fns = {"moe_fwd": moe_fwd, "moe_fwd_bwd": moe_fwd_bwd, "dense_fwd": dense_fwd,
           "dense_fwd_bwd": dense_fwd_bwd}
    counts = {name: [] for name in fns}
    out = {f"{name}_ms": device_ms(fn, counts=counts[name]) for name, fn in fns.items()}
    return {**out, "kernels_in_10_calls_by_session": counts}


def phase_mlp():
    """BASELINE config 2's MLP (784-512-256-10) in f32, TF32 off: the same
    weights and batch on the CPU and on the card.  The loss within 1e-5,
    every gradient leaf within 1e-4 of its largest entry, accuracy equal;
    then ``TorchPredictor`` labels of 10,000 synthetic inputs on the card
    equal the CPU's."""
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.train import TorchPredictor

    cfg = mlp.MLPConfig()
    params = mlp.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, cfg.in_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 256)
    res = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev, copy=True).requires_grad_(True) for k, v in params.items()}
        batch = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
        loss = mlp.loss_fn(p, batch, cfg)
        loss.backward()
        res[dev] = (loss.item(), {k: t.grad.cpu() for k, t in p.items()},
                    mlp.accuracy(p, batch, cfg).item())
    loss_err = abs(res["cpu"][0] - res["cuda"][0])
    check(loss_err <= 1e-5, f"mlp: loss differs by {loss_err}")
    worst = max((res["cuda"][1][k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for k, g in res["cpu"][1].items())
    check(worst <= 1e-4, f"mlp: a gradient differs by {worst} of its largest entry")
    check(res["cpu"][2] == res["cuda"][2], f"mlp: accuracy {res['cpu'][2]} vs {res['cuda'][2]}")
    images = rng.standard_normal((10_000, cfg.in_dim)).astype(np.float32)
    apply = lambda p, xb: mlp.apply(p, xb, cfg)
    labels = {dev: TorchPredictor(params, apply, device=dev).predict(images).argmax(-1)
              for dev in ("cpu", "cuda")}
    check(bool((labels["cpu"] == labels["cuda"]).all()), "mlp: predictor labels differ")
    emit("mlp", model="mlp 784-512-256-10 f32", batch=256, loss_cpu=res["cpu"][0],
         loss_cuda=res["cuda"][0], loss_abs_err=loss_err, grad_max_err_over_leaf_max=worst,
         accuracy=res["cuda"][2], predictor_inputs=len(images), predictor_labels_equal=True,
         label_counts=np.bincount(labels["cuda"], minlength=cfg.num_classes).tolist())


# BASELINE config 4 as bench.py runs it on a chip (run_rl_bench): PPO on
# SyntheticAtariEnv(episode_len=400), 64 envs a worker, fragments of 16,
# a train batch of 4 workers' fragments (4,096 env steps), minibatches of
# 256, 4 SGD epochs, fcnet_hiddens (256,), entropy 0.01, seed 0; 1 warm-up
# iteration, then 3 timed.  rl_ppo_atari samples the 4 fragments in turn
# on one local worker; rl_ppo_atari_runtime runs bench.py's 4 remote
# workers with the PolicyServer on a card.
RL_OBS, RL_ACTIONS, RL_HIDDENS = (84, 84, 4), 6, (256,)
RL_ENVS, RL_FRAGMENT, RL_FRAGMENTS = 64, 16, 4
RL_MINIBATCH, RL_SGD_ITERS, RL_WARMUP, RL_ITERS = 256, 4, 1, 3
# rl_parity's tolerances, CPU against card in f32 (TF32 off): forwards,
# losses and TD targets absolute; gradients of each leaf's largest entry;
# weights after one update absolute, a tenth of one Adam step (lr 3e-4)
RL_TOL = {"forward": 1e-4, "loss": 1e-4, "grad": 1e-3, "weights": 3e-5}


def _ppo_columns(rng, n):
    """PPO's train columns over ``n`` random frames (numpy default_rng)."""
    from ray_tpu_torch.rllib import SampleBatch

    return {SampleBatch.OBS: rng.integers(0, 256, (n, *RL_OBS), dtype=np.uint8),
            SampleBatch.ACTIONS: rng.integers(0, RL_ACTIONS, n),
            SampleBatch.ACTION_LOGP: (np.log(1 / RL_ACTIONS)
                                      + rng.normal(0, 0.2, n)).astype(np.float32),
            SampleBatch.ADVANTAGES: rng.normal(0.3, 1.5, n).astype(np.float32),
            SampleBatch.VALUE_TARGETS: rng.normal(0, 1.5, n).astype(np.float32)}


def _tree_err(a, b) -> float:
    """The largest absolute difference between two trees of arrays."""
    from ray_tpu_torch.util.tree import tree_map

    errs = []
    tree_map(lambda x, y: errs.append(float(np.abs(np.asarray(x) - y).max())), a, b)
    return max(errs)


def phase_rl_parity():
    """The RL learner stack with the same weights on the CPU and on the
    card, f32 with TF32 off for matmul and cuDNN: the Nature-CNN
    actor-critic (84 x 84 x 4 uint8, hiddens (256,), 6 actions) logits and
    values; the PPO, A2C, IMPALA and DQN losses, their metrics and every
    gradient leaf; one ``TorchPolicy.learn_on_minibatch`` (weights after
    it); ``DQNPolicy.compute_td_targets``; one ``SACPolicy`` update at its
    default (64, 64) with the same noise on both devices; and, on the card,
    the log-prob of drawn actions against ``action_logp``.  Tolerances:
    ``RL_TOL``."""
    from ray_tpu_torch.rllib import (DQNPolicy, SACPolicy, SampleBatch, TorchPolicy, a2c, dqn,
                                     impala, ppo)
    from ray_tpu_torch.rllib.models import apply_model
    from ray_tpu_torch.rllib.policy import to_device
    from ray_tpu_torch.util.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n, devs = 64, ("cpu", "cuda")
    cols = _ppo_columns(rng, n)
    kw = dict(hiddens=RL_HIDDENS, obs_shape=RL_OBS, lr=3e-4, seed=0,
              loss_fn=ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01))
    pol = {dev: TorchPolicy(int(np.prod(RL_OBS)), RL_ACTIONS, device=dev, **kw) for dev in devs}
    pol["cuda"].set_weights(pol["cpu"].get_weights())
    errs = {}
    with torch.no_grad():
        fwd = {dev: [t.cpu() for t in apply_model(p.params, to_device(cols[SampleBatch.OBS], dev))]
               for dev, p in pol.items()}
    errs["logits"], errs["values"] = [(c - g).abs().max().item()
                                      for c, g in zip(fwd["cpu"], fwd["cuda"])]
    check(max(errs["logits"], errs["values"]) <= RL_TOL["forward"], f"rl_parity: forward {errs}")
    losses = {"ppo": ppo.make_ppo_loss(0.2, 10.0, 0.5, 0.01), "a2c": a2c.make_a2c_loss(0.5, 0.01),
              "impala": impala.make_impala_loss(0.5, 0.01), "dqn": dqn.make_dqn_loss()}
    for name, loss in losses.items():
        res = {}
        for dev, p in pol.items():
            p.optimizer.zero_grad(set_to_none=True)
            total, metrics = loss(p.module, p.params, {k: to_device(v, dev) for k, v in cols.items()})
            total.backward()
            res[dev] = ({"total": total.item(), **{k: v.item() for k, v in metrics.items()}},
                        [t.grad.cpu() if t.grad is not None else torch.zeros(t.shape)
                         for t in tree_leaves(p.params)])
        errs[f"{name}_loss"] = max(abs(res["cpu"][0][k] - res["cuda"][0][k]) for k in res["cpu"][0])
        errs[f"{name}_grad_over_leaf_max"] = max(
            (g - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
            for c, g in zip(res["cpu"][1], res["cuda"][1]))
        check(errs[f"{name}_loss"] <= RL_TOL["loss"]
              and errs[f"{name}_grad_over_leaf_max"] <= RL_TOL["grad"], f"rl_parity {name}: {errs}")
    learn = {dev: p.learn_on_minibatch(cols) for dev, p in pol.items()}
    errs["learn_metrics"] = max(abs(learn["cpu"][k] - learn["cuda"][k]) for k in learn["cpu"])
    errs["weights_after_update"] = _tree_err(pol["cuda"].get_weights(), pol["cpu"].get_weights())
    check(errs["learn_metrics"] <= RL_TOL["loss"]
          and errs["weights_after_update"] <= RL_TOL["weights"], f"rl_parity learn: {errs}")
    a, logp, _ = pol["cuda"].compute_actions(cols[SampleBatch.OBS])
    errs["sampled_logp"] = float(np.abs(logp - pol["cuda"].action_logp(cols[SampleBatch.OBS], a)).max())
    check(a.dtype == np.int64 and 0 <= a.min() and a.max() < RL_ACTIONS
          and errs["sampled_logp"] <= RL_TOL["forward"], f"rl_parity: sampled actions {errs}")

    q = {dev: DQNPolicy(int(np.prod(RL_OBS)), RL_ACTIONS, hiddens=RL_HIDDENS, obs_shape=RL_OBS,
                        seed=0, device=dev) for dev in devs}
    q["cuda"].set_weights(q["cpu"].get_weights())
    q["cuda"].update_target()
    mb = SampleBatch({SampleBatch.NEXT_OBS: cols[SampleBatch.OBS],
                      SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
                      SampleBatch.TERMINATEDS: rng.random(n) < 0.2})
    td = {dev: p.compute_td_targets(mb, 0.99) for dev, p in q.items()}
    errs["dqn_td_targets"] = float(np.abs(td["cpu"] - td["cuda"]).max())
    check(errs["dqn_td_targets"] <= RL_TOL["forward"], f"rl_parity dqn: {errs}")

    obs_dim, act_dim, b = 17, 6, 256  # HalfCheetah's shapes, SACConfig's batch
    sac = {dev: SACPolicy(obs_dim, act_dim, seed=0, device=dev) for dev in devs}
    sac["cuda"].set_state(sac["cpu"].get_state())
    batch = {SampleBatch.OBS: rng.standard_normal((b, obs_dim)).astype(np.float32),
             SampleBatch.ACTIONS: rng.uniform(-1, 1, (b, act_dim)).astype(np.float32),
             SampleBatch.REWARDS: rng.normal(size=b).astype(np.float32),
             SampleBatch.TERMINATEDS: rng.random(b) < 0.1,
             SampleBatch.NEXT_OBS: rng.standard_normal((b, obs_dim)).astype(np.float32)}
    noise = tuple(rng.standard_normal((b, act_dim)).astype(np.float32) for _ in range(2))
    upd = {dev: p.learn_on_minibatch(batch, noise=noise) for dev, p in sac.items()}
    errs["sac_metrics"] = max(abs(upd["cpu"][k] - upd["cuda"][k]) for k in upd["cpu"])
    errs["sac_weights_after_update"] = _tree_err(sac["cuda"].get_weights(), sac["cpu"].get_weights())
    errs["sac_target_q"] = _tree_err(sac["cuda"].get_state()["target_q"],
                                     sac["cpu"].get_state()["target_q"])
    check(errs["sac_metrics"] <= RL_TOL["loss"]
          and max(errs["sac_weights_after_update"], errs["sac_target_q"]) <= RL_TOL["weights"],
          f"rl_parity sac: {errs}")
    emit("rl_parity", model=f"nature-cnn actor-critic {RL_OBS} uint8, hiddens {RL_HIDDENS}, "
         f"{RL_ACTIONS} actions, batch {n}; SAC ({obs_dim}, {act_dim}) hiddens (64, 64), batch {b}",
         params=sum(t.numel() for t in tree_leaves(pol["cuda"].params)),
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         tolerances=RL_TOL, max_abs_err=errs)


def profile_call(fn, reps: int = 20, top_n: int = 8) -> dict:
    """One call of ``fn`` (which reads its result back): its host wall
    (median of ``reps`` calls, each ending in a synchronize), then one
    call under torch.profiler: device work (kernels and copies, user
    annotations excluded), kernel and copy counts, the idle share of the
    median wall, and the ``top_n`` kernels by device time."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev = profiled_events(fn, "profile_call")
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    wall = pct(walls, 0.5)
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    return {"host_wall_ms_p50": wall, "host_wall_ms_min": min(walls), "device_ms": busy,
            "kernels": len(dev) - len(copies), "copies": len(copies),
            "copy_ms": sum(e.time_range.elapsed_us() for e in copies) / 1e3,
            "idle_share": 1 - busy / wall,
            "top_kernels": [{"name": n[:100], "count": c, "ms": us / 1e3} for n, (c, us) in top]}


def phase_rl_ppo_atari():
    """BASELINE config 4's main path on the card: a ``RolloutWorker`` on
    ``SyntheticAtariEnv`` with a ``TorchPolicy`` carrying PPO's loss
    (``PPOConfig``'s defaults, entropy 0.01), sampling 4 fragments of 64
    envs x 16 steps in turn, then ``train_one_step`` (4 epochs of 256-row
    minibatches); 1 warm-up and 3 timed iterations.  Launch counts are set
    to 0 just before the first iteration and read just after the last.
    Prints env-steps/s, each iteration's seconds split into sample (env
    steps, inference, connectors), GAE and learn, one SGD minibatch and one
    64-observation ``compute_actions`` under the profiler, peak memory and
    the mean loss terms."""
    from ray_tpu_torch.rllib import RolloutWorker, SampleBatch, ppo, synthetic_atari_creator
    from ray_tpu_torch.rllib import train_one_step
    from ray_tpu_torch.rllib.policy import to_device
    from ray_tpu_torch.util.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch_size = RL_ENVS * RL_FRAGMENT * RL_FRAGMENTS
    cfg = dict(ppo.PPO_DEFAULTS, env_creator=synthetic_atari_creator,
               env_config={"episode_len": 400}, num_envs_per_worker=RL_ENVS,
               rollout_fragment_length=RL_FRAGMENT, train_batch_size=batch_size,
               sgd_minibatch_size=RL_MINIBATCH, num_sgd_iter=RL_SGD_ITERS,
               fcnet_hiddens=RL_HIDDENS, entropy_coeff=0.01, gamma=0.99, seed=0,
               _loss_factory=ppo._ppo_loss_factory)
    t0 = time.perf_counter()
    worker = RolloutWorker(cfg)  # the card: the entry point's default
    policy = worker.policy
    sgd_rng = np.random.default_rng(cfg["seed"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    iters = []
    for _ in range(RL_WARMUP + RL_ITERS):
        t0 = time.perf_counter()
        fragments, phases = [], {}
        for _ in range(RL_FRAGMENTS):
            fragments.append(worker.sample())
            for k, v in worker.last_sample_phases.items():
                phases[k] = phases.get(k, 0.0) + v
        batch = SampleBatch.concat_samples(fragments)
        t1 = time.perf_counter()
        metrics = train_one_step(policy, batch, num_sgd_iter=RL_SGD_ITERS,
                                 sgd_minibatch_size=RL_MINIBATCH, rng=sgd_rng,
                                 required_keys=ppo.PPO_KEYS)
        t2 = time.perf_counter()
        iters.append({"wall_s": t2 - t0, "sample_s": t1 - t0 - phases["postprocess_s"],
                      "gae_s": phases["postprocess_s"], "learn_s": t2 - t1,
                      "env_s": phases["env_s"], "infer_s": phases["infer_s"],
                      "connector_s": phases["connector_s"], "env_steps": batch.count,
                      "loss_terms": metrics})
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    timed = iters[RL_WARMUP:]
    wall = sum(r["wall_s"] for r in timed)
    steps = sum(r["env_steps"] for r in timed)
    check(all(r["env_steps"] == batch_size for r in iters), f"rl_ppo_atari: {iters}")
    terms = {k: float(np.mean([r["loss_terms"][k] for r in timed])) for k in timed[0]["loss_terms"]}
    check(set(terms) == {"total_loss", "policy_loss", "vf_loss", "entropy", "kl"}
          and all(np.isfinite(v) for r in iters for v in r["loss_terms"].values()),
          f"rl_ppo_atari: loss terms {[r['loss_terms'] for r in iters]}")
    tensors = tree_leaves(policy.params) + [v for st in policy.optimizer.state.values()
                                            for k, v in st.items() if k != "step"]
    check(all(t.is_cuda for t in tensors) and len(policy.optimizer.state) == 14,
          "rl_ppo_atari: a policy tensor is not on the card")
    check(not any(launches.values()), f"rl_ppo_atari: kernel launches {launches}")
    mb = {k: to_device(batch[k][:RL_MINIBATCH], policy.device) for k in ppo.PPO_KEYS}
    sgd = profile_call(lambda: policy.learn_on_minibatch(mb))
    obs = batch[SampleBatch.OBS][:RL_ENVS]
    act = profile_call(lambda: policy.compute_actions(obs))
    act["bytes_to_card"] = obs.nbytes
    act["bytes_from_card"] = 3 * RL_ENVS * 4
    emit("rl_ppo_atari",
         model=f"PPO, nature-cnn actor-critic {RL_OBS} uint8, hiddens {RL_HIDDENS}, "
               f"{RL_ACTIONS} actions, f32",
         cut=f"bench.py's {RL_FRAGMENTS} remote rollout workers are one local RolloutWorker "
             f"sampling {RL_FRAGMENTS} fragments in turn (rl_ppo_atari_runtime runs them)",
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         params=sum(t.numel() for t in tree_leaves(policy.params)),
         envs=RL_ENVS, fragment=RL_FRAGMENT, fragments_per_iter=RL_FRAGMENTS,
         train_batch=batch_size, minibatch=RL_MINIBATCH, sgd_iters=RL_SGD_ITERS,
         minibatches_per_iter=RL_SGD_ITERS * (batch_size // RL_MINIBATCH),
         warmup_iters=RL_WARMUP, timed_iters=RL_ITERS, setup_s=setup_s,
         env_steps_per_s=steps / wall, wall_s=wall,
         s_per_iter={k: float(np.mean([r[k] for r in timed]))
                     for k in ("wall_s", "sample_s", "gae_s", "learn_s", "env_s", "infer_s",
                               "connector_s")},
         iters=[{k: v for k, v in r.items() if k != "loss_terms"} for r in iters],
         sgd_minibatch=sgd, compute_actions=act, peak_mem_bytes=peak,
         mean_loss_terms=terms, loss_terms_finite=True, policy_tensors_on="cuda",
         episodes_total=worker.get_metrics()["episodes_total"], launches=launches)
    return launches, steps / wall


def _rllib_spans(instance, t0, t1):
    """Run in an actor's process: its ``rllib`` spans that ended in
    ``[t0, t1]`` (wall-clock seconds), each span's data among its keys."""
    from ray_tpu_torch._private import events

    return [{**e.get("data", {}), **{k: v for k, v in e.items() if k != "data"}}
            for e in events.local_events() if e["source"] == "rllib" and t0 <= e["ts"] <= t1]


def _policy_on_card(instance):
    """Run in the PolicyServer's process: whether its policy's params and
    Adam state all lie on the card, and how many Adam states it has."""
    from ray_tpu_torch.util.tree import tree_leaves

    pol = instance.policy
    tensors = tree_leaves(pol.params) + [v for st in pol.optimizer.state.values()
                                         for k, v in st.items() if k != "step"]
    return all(t.is_cuda for t in tensors), len(pol.optimizer.state)


def _tf32_off(instance):
    """Run in an actor's process: TF32 off for matmul and cuDNN (imported
    here: a function pickled by value cannot carry ``torch.backends``'
    module objects)."""
    import torch.backends.cuda as cuda_backend
    import torch.backends.cudnn as cudnn_backend

    cuda_backend.matmul.allow_tf32 = False
    cudnn_backend.allow_tf32 = False
    return True


def phase_rl_ppo_atari_runtime(rt, local_steps_per_s):
    """``bench.py``'s RL row (``run_rl_bench``) on the port's runtime:
    ``PPOConfig`` -> ``PPO`` with 4 remote rollout workers of 64
    ``SyntheticAtariEnv``s x fragments of 16 (a train batch of 4,096),
    minibatches of 256 x 4 epochs, ``serve_policy(num_gpus=1,
    max_concurrency=16, frame_stack_transport=True)`` holding the policy
    and Adam on the card; 1 warm-up ``algo.step()``, then 3 timed.
    env-steps/s is ``bench.py``'s (``_timesteps_total`` delta / wall),
    printed beside ``rl_ppo_atari``'s local worker from this call.  Checks
    4,096 env steps an iteration, finite loss terms, the server's policy
    and Adam state on the card with none of the policy's tensors in the
    driver, and no flash launch in any process of the path (counts zeroed
    just before the first step and read just after the last).  Prints the
    bytes shipped to the server an iteration by call, and its seconds in
    inference and in ``train_on_batch`` from its events spans.  Then holds
    the server's ``train_on_batch`` (one 256-row update, seed 0) to the
    same call on a CPU ``PolicyServer`` from the same state, f32 with TF32
    off, at ``RL_TOL``."""
    from ray_tpu_torch.rllib import (PolicyServer, PPOConfig, RemotePolicy, serve_policy,
                                     synthetic_atari_creator)

    workers = RL_FRAGMENTS
    batch_size = workers * RL_ENVS * RL_FRAGMENT
    base = (PPOConfig()
            .environment(env_creator=synthetic_atari_creator, env_config={"episode_len": 400})
            .rollouts(num_rollout_workers=workers, num_envs_per_worker=RL_ENVS,
                      rollout_fragment_length=RL_FRAGMENT)
            .training(train_batch_size=batch_size, sgd_minibatch_size=RL_MINIBATCH,
                      num_sgd_iter=RL_SGD_ITERS, fcnet_hiddens=RL_HIDDENS, entropy_coeff=0.01)
            # the runtime has 4 CPUs (core_gpu_actor): the server's 1 and the
            # workers' 0.75 each fit it
            .resources(num_cpus_per_worker=0.75)
            .debugging(seed=0)).to_dict()
    gc.collect()
    torch.cuda.empty_cache()
    driver_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server, overrides = serve_policy(base, obs_dim=int(np.prod(RL_OBS)), num_actions=RL_ACTIONS,
                                     obs_shape=RL_OBS, max_concurrency=16,
                                     frame_stack_transport=True)
    cfg = dict(base, **overrides)
    algo = cfg.pop("_algo_class")(config=cfg)
    try:
        procs = [server, *algo.workers.remote_workers]
        rt.get(server._submit_compiled_task(_tf32_off, (), name="tf32"), timeout=60)
        setup_s = time.perf_counter() - t0
        warm = algo.step()
        actor_launches(rt, procs, reset=True)
        build.reset_launches()
        w0, steps0 = time.time(), algo._timesteps_total
        t_start = time.perf_counter()
        iters = []
        for _ in range(RL_ITERS):
            t1 = time.perf_counter()
            r = algo.step()
            iters.append({"wall_s": time.perf_counter() - t1,
                          "env_steps": r["timesteps_total"] - (iters[-1]["total"] if iters
                                                               else steps0),
                          "total": r["timesteps_total"], "loss_terms": r["info"]["learner"]})
        wall = time.perf_counter() - t_start
        w1 = time.time()
        launches = dict(build.launches)
        for k, n in actor_launches(rt, procs).items():
            launches[k] = launches.get(k, 0) + n
        steps = algo._timesteps_total - steps0
        check(warm["timesteps_total"] == batch_size
              and all(r["env_steps"] == batch_size for r in iters),
              f"rl_ppo_atari_runtime: env steps {warm['timesteps_total']}, {iters}")
        terms = {k: float(np.mean([r["loss_terms"][k] for r in iters]))
                 for k in iters[0]["loss_terms"]}
        check(set(terms) == {"total_loss", "policy_loss", "vf_loss", "entropy", "kl"}
              and all(np.isfinite(v) for r in iters for v in r["loss_terms"].values())
              and all(np.isfinite(v) for v in warm["info"]["learner"].values()),
              f"rl_ppo_atari_runtime: loss terms {[r['loss_terms'] for r in iters]}")
        on_card, n_adam = rt.get(server._submit_compiled_task(_policy_on_card, (), name="card"),
                                 timeout=60)
        check(on_card and n_adam == 14,
              f"rl_ppo_atari_runtime: server policy on the card {on_card}, {n_adam} Adam states")
        check(isinstance(algo.get_policy(), RemotePolicy)
              and torch.cuda.memory_allocated() == driver_bytes,
              "rl_ppo_atari_runtime: the driver holds CUDA tensors of the policy")
        check(not any(launches.values()), f"rl_ppo_atari_runtime: kernel launches {launches}")
        spans = {"server": rt.get(server._submit_compiled_task(_rllib_spans, (w0, w1),
                                                               name="spans"), timeout=60),
                 "workers": [e for part in rt.get(
                     [w._submit_compiled_task(_rllib_spans, (w0, w1), name="spans")
                      for w in algo.workers.remote_workers], timeout=60) for e in part],
                 "driver": _rllib_spans(None, w0, w1)}
        by = lambda rows, msg, **kw: [e for e in rows if e["message"] == msg and all(
            e.get(k) == v for k, v in kw.items())]
        infer = by(spans["server"], "policy inference")
        stacked = by(spans["server"], "policy inference", stacked=True)
        boot = [e for e in infer if not e.get("stacked")]
        train_spans = by(spans["server"], "policy train")
        samples = by(spans["workers"], "rollout sample")
        learner = by(spans["driver"], "learner train")
        check(len(stacked) == RL_ITERS * workers * RL_FRAGMENT and len(train_spans) == RL_ITERS
              and len(samples) == RL_ITERS * workers and len(learner) == RL_ITERS
              and all(e["cached"] for e in train_spans),
              f"rl_ppo_atari_runtime: spans {len(stacked)} stacked, {len(train_spans)} train, "
              f"{len(samples)} samples, {len(learner)} learner")
        per_iter = lambda rows, key="span_dur": sum(e[key] for e in rows) / RL_ITERS
        frames_b = per_iter(stacked, "bytes_in")
        # parity: the card server's train_on_batch against a CPU server's
        # from the same state, on one 256-row batch
        cpu_server = PolicyServer(int(np.prod(RL_OBS)), RL_ACTIONS, {"obs_shape": RL_OBS},
                                  base, device="cpu")
        cpu_server.set_state(rt.get(server.get_state.remote(), timeout=120))
        cols = _ppo_columns(np.random.default_rng(7), RL_MINIBATCH)
        kw = dict(num_sgd_iter=1, sgd_minibatch_size=RL_MINIBATCH, seed=0)
        got = rt.get(server.train_on_batch.remote(cols, **kw), timeout=120)
        want = cpu_server.train_on_batch(cols, **kw)
        loss_err = max(abs(got[k] - want[k]) for k in want)
        weights_err = _tree_err(rt.get(server.get_weights.remote(), timeout=120),
                                cpu_server.get_weights())
        check(set(got) == set(want) and loss_err <= RL_TOL["loss"]
              and weights_err <= RL_TOL["weights"],
              f"rl_ppo_atari_runtime: train_on_batch card vs CPU: loss {loss_err}, "
              f"weights {weights_err}")
        emit("rl_ppo_atari_runtime",
             model=f"PPO, nature-cnn actor-critic {RL_OBS} uint8, hiddens {RL_HIDDENS}, "
                   f"{RL_ACTIONS} actions, f32, TF32 off",
             path=f"PPOConfig -> PPO, {workers} remote RolloutWorkers x {RL_ENVS} envs x "
                  f"{RL_FRAGMENT}, serve_policy(num_gpus=1, max_concurrency=16, "
                  "frame_stack_transport=True)",
             cut="the workers ask for 0.75 CPU each (bench.py's runtime has 12 CPUs, "
                 "core_gpu_actor's 4)",
             train_batch=batch_size, minibatch=RL_MINIBATCH, sgd_iters=RL_SGD_ITERS,
             warmup_iters=RL_WARMUP, timed_iters=RL_ITERS, setup_s=setup_s,
             env_steps_per_s=steps / wall, local_worker_env_steps_per_s=local_steps_per_s,
             ratio_to_local_worker=steps / wall / local_steps_per_s, wall_s=wall,
             iters=[{k: v for k, v in r.items() if k != "loss_terms"} for r in iters],
             mean_loss_terms=terms, loss_terms_finite=True,
             bytes_to_server_per_iter={
                 "frames": frames_b, "bootstrap_stacks": per_iter(boot, "bytes_in"),
                 "train_batch": per_iter(train_spans, "bytes_in"),
                 "frames_per_env_step": frames_b / batch_size,
                 "stacks_without_transport": batch_size * int(np.prod(RL_OBS)),
                 "train_pixels_without_transport": batch_size * int(np.prod(RL_OBS))},
             server_s_per_iter={"inference": per_iter(infer), "train_on_batch":
                                per_iter(train_spans), "inference_calls": len(infer) / RL_ITERS},
             worker_s_per_iter={k: sum(e[k] for e in samples) / (RL_ITERS * workers)
                                for k in ("span_dur", "env_s", "infer_s", "connector_s",
                                          "postprocess_s")},
             learner_round_trip_s_per_iter=per_iter(learner),
             server_policy_on="cuda", server_adam_states=n_adam, driver_policy="RemotePolicy",
             train_on_batch_vs_cpu={"loss_max_abs_err": loss_err,
                                    "weights_max_abs_err": weights_err, "tol": RL_TOL,
                                    "card": got, "cpu": want},
             launches=launches)
    finally:
        algo.cleanup()
        rt.kill(server)
    return launches, steps / wall


# rl_appo_atari_runtime: APPO at rl_ppo_atari_runtime's sizes, each remote
# worker's policy on this share of the card, the learner on the card
APPO_GPU_SHARE = 0.25


def _policy_device(instance):
    """Run in a rollout worker's process: its policy's device and its grant."""
    return str(instance.policy.device), os.environ.get("CUDA_VISIBLE_DEVICES")


def phase_rl_appo_atari_runtime(rt, ppo_steps_per_s):
    """APPO (IMPALA's async sampling, PPO's clipped surrogate over V-trace)
    at ``rl_ppo_atari_runtime``'s sizes: 4 remote workers of 64
    ``SyntheticAtariEnv``s x fragments of 16, each on ``APPO_GPU_SHARE`` of
    the card, ``batches_per_step=4`` (a PPO train batch of 4,096),
    minibatches of 256 (APPO's one epoch), entropy 0.01, seed 0, the
    learner on the card; 1 warm-up ``algo.train()`` and 3 timed.  Prints
    env-steps/s beside ``rl_ppo_atari_runtime``'s, the learner's share of
    the wall in ``train_one_step`` (its ``learner train`` spans), the
    samples in flight and already landed as each step began, and the bytes
    of the weights put once a step.  Gates: 4 samples in flight after every
    step, finite loss terms, every worker's policy on its card share, no
    flash launch, one update from a fixed 256-row batch on the card against
    the same update on a CPU learner from the same state at ``RL_TOL``, and
    after ``cleanup`` nothing in flight and the shares free again."""
    from ray_tpu_torch.rllib import APPOConfig, SampleBatch, synthetic_atari_creator
    from ray_tpu_torch.rllib import train_one_step
    from ray_tpu_torch.rllib.appo import APPO_KEYS
    from ray_tpu_torch.util.tree import tree_leaves

    workers = RL_FRAGMENTS
    batch_size = workers * RL_ENVS * RL_FRAGMENT
    cfg = (APPOConfig()
           .environment(env_creator=synthetic_atari_creator, env_config={"episode_len": 400})
           .rollouts(num_rollout_workers=workers, num_envs_per_worker=RL_ENVS,
                     rollout_fragment_length=RL_FRAGMENT)
           .training(train_batch_size=batch_size, batches_per_step=workers,
                     minibatch_size=RL_MINIBATCH, fcnet_hiddens=RL_HIDDENS, entropy_coeff=0.01)
           .resources(num_cpus_per_worker=0.75, num_gpus_per_worker=APPO_GPU_SHARE)
           .debugging(seed=0))
    free_gpu = rt.available_resources().get("GPU", 0.0)
    t0 = time.perf_counter()
    algo = cfg.build()  # the learner on the card: the config's default
    try:
        procs = algo.workers.remote_workers
        rt.get([w._submit_compiled_task(_tf32_off, (), name="tf32") for w in procs], timeout=120)
        devices = rt.get([w._submit_compiled_task(_policy_device, (), name="device")
                          for w in procs], timeout=60)
        check(all(d == ("cuda", "0") for d in devices)
              and abs(rt.available_resources().get("GPU", 0.0)
                      - (free_gpu - workers * APPO_GPU_SHARE)) < 1e-9,
              f"rl_appo_atari_runtime: workers' devices {devices}, "
              f"{rt.available_resources().get('GPU')} GPU free")
        setup_s = time.perf_counter() - t0
        warm = algo.train()
        check(len(algo._inflight) == workers, f"rl_appo_atari_runtime: {len(algo._inflight)} "
              "samples in flight after the warm-up step")
        actor_launches(rt, procs, reset=True)
        build.reset_launches()
        # the seconds of each step's training_step and V-trace batch (the
        # rest of an iteration is Algorithm.step's metrics call, which
        # waits for the re-armed samples)
        spent = {"training_step": [], "vtrace": []}

        def timed(name, fn):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                spent[name].append(time.perf_counter() - t)
                return out
            return call

        algo.training_step = timed("training_step", algo.training_step)
        algo._vtrace_batch = timed("vtrace", algo._vtrace_batch)
        w0, steps0 = time.time(), algo._timesteps_total
        t_start = time.perf_counter()
        iters = []
        for _ in range(RL_ITERS):
            refs = list(algo._inflight)
            landed, _ = rt.wait(refs, num_returns=len(refs), timeout=0)
            t1 = time.perf_counter()
            r = algo.train()
            iters.append({"wall_s": time.perf_counter() - t1,
                          "env_steps": r["timesteps_total"] - (iters[-1]["total"] if iters
                                                               else steps0),
                          "total": r["timesteps_total"], "in_flight_at_start": len(refs),
                          "landed_at_start": len(landed), "in_flight_after": len(algo._inflight),
                          "loss_terms": r["info"]["learner"]})
            check(len(algo._inflight) == workers,
                  f"rl_appo_atari_runtime: {len(algo._inflight)} samples in flight after a step")
        wall = time.perf_counter() - t_start
        w1 = time.time()
        step_s, vtrace_s = sum(spent["training_step"]), sum(spent["vtrace"])
        launches = dict(build.launches)
        for k, n in actor_launches(rt, procs).items():
            launches[k] = launches.get(k, 0) + n
        steps = algo._timesteps_total - steps0
        check(warm["timesteps_total"] == batch_size
              and all(r["env_steps"] == batch_size for r in iters),
              f"rl_appo_atari_runtime: env steps {warm['timesteps_total']}, {iters}")
        check(all(np.isfinite(v) for r in iters for v in r["loss_terms"].values())
              and set(iters[0]["loss_terms"]) == {"total_loss", "policy_loss", "vf_loss",
                                                   "entropy", "kl"},
              f"rl_appo_atari_runtime: loss terms {[r['loss_terms'] for r in iters]}")
        check(not any(launches.values()), f"rl_appo_atari_runtime: kernel launches {launches}")
        learner = [e for e in _rllib_spans(None, w0, w1) if e["message"] == "learner train"]
        samples = [e for part in rt.get([w._submit_compiled_task(_rllib_spans, (w0, w1),
                                                                 name="spans")
                                         for w in procs], timeout=60)
                   for e in part if e["message"] == "rollout sample"]
        check(len(learner) == RL_ITERS and len(spent["training_step"]) == RL_ITERS,
              f"rl_appo_atari_runtime: {len(learner)} learner spans, {spent}")
        weights_bytes = sum(a.nbytes for a in tree_leaves(algo.workers.local_worker.get_weights()))
        # parity: one update from a fixed 256-row batch (the local worker's
        # fragment), on the card and on a CPU learner from the same state
        policy = algo.get_policy()
        fixed = algo.workers.local_worker.sample()
        fixed = SampleBatch({k: v[:RL_MINIBATCH] for k, v in fixed.items()})
        cpu = (APPOConfig().environment(env_creator=synthetic_atari_creator,
                                        env_config={"episode_len": 400})
               .training(minibatch_size=RL_MINIBATCH, fcnet_hiddens=RL_HIDDENS,
                         entropy_coeff=0.01)
               .resources(device="cpu").debugging(seed=0).build())
        cpu.get_policy().set_state(policy.get_state())
        kw = dict(num_sgd_iter=1, sgd_minibatch_size=RL_MINIBATCH, required_keys=APPO_KEYS)
        got = train_one_step(policy, algo._vtrace_batch(fixed), rng=np.random.default_rng(0),
                             **kw)
        want = train_one_step(cpu.get_policy(), cpu._vtrace_batch(fixed),
                              rng=np.random.default_rng(0), **kw)
        loss_err = max(abs(got[k] - want[k]) for k in want)
        weights_err = _tree_err(policy.get_weights(), cpu.get_policy().get_weights())
        cpu.cleanup()
        check(set(got) == set(want) and loss_err <= RL_TOL["loss"]
              and weights_err <= RL_TOL["weights"],
              f"rl_appo_atari_runtime: one update card vs CPU: loss {loss_err}, "
              f"weights {weights_err}")
    finally:
        algo.cleanup()
    deadline = time.monotonic() + 30
    while abs(rt.available_resources().get("GPU", 0.0) - free_gpu) > 1e-9:
        check(time.monotonic() < deadline, "rl_appo_atari_runtime: the workers' card shares "
              f"are not free after cleanup: {rt.available_resources()}")
        time.sleep(0.1)
    check(not algo._inflight, "rl_appo_atari_runtime: samples in flight after cleanup")
    learn_s = sum(e["span_dur"] for e in learner)
    emit("rl_appo_atari_runtime",
         model=f"APPO, nature-cnn actor-critic {RL_OBS} uint8, hiddens {RL_HIDDENS}, "
               f"{RL_ACTIONS} actions, f32, TF32 off",
         path=f"APPOConfig -> APPO, {workers} remote RolloutWorkers x {RL_ENVS} envs x "
              f"{RL_FRAGMENT} at num_gpus_per_worker={APPO_GPU_SHARE}, batches_per_step="
              f"{workers}, the learner on the card",
         train_batch=batch_size, minibatch=RL_MINIBATCH, sgd_iters=1,
         warmup_iters=RL_WARMUP, timed_iters=RL_ITERS, setup_s=setup_s,
         env_steps_per_s=steps / wall, ppo_runtime_env_steps_per_s=ppo_steps_per_s,
         ratio_to_ppo_runtime=steps / wall / ppo_steps_per_s, wall_s=wall,
         learner_train_s=learn_s, learner_share_of_wall=learn_s / wall,
         s_per_iter={"training_step": step_s / RL_ITERS, "vtrace": vtrace_s / RL_ITERS,
                     "train_one_step": learn_s / RL_ITERS,
                     "gather": (step_s - vtrace_s - learn_s) / RL_ITERS,
                     "metrics_wait": (wall - step_s) / RL_ITERS},
         worker_sample_s_mean=sum(e["span_dur"] for e in samples) / len(samples),
         worker_samples=len(samples),
         iters=[{k: v for k, v in r.items() if k != "loss_terms"} for r in iters],
         mean_loss_terms={k: float(np.mean([r["loss_terms"][k] for r in iters]))
                          for k in iters[0]["loss_terms"]},
         weights_put_bytes_per_step=weights_bytes, weights_put_readers=workers,
         worker_devices=devices, update_vs_cpu={"loss_max_abs_err": loss_err,
                                                "weights_max_abs_err": weights_err,
                                                "tol": RL_TOL, "card": got, "cpu": want},
         shares_free_after_cleanup=True, launches=launches)
    return launches


class _CartPole:
    """CartPole-v1's dynamics, limits and 500-step truncation in numpy
    (gymnasium's equations; the card's machine has no gymnasium), with
    the observation and action spaces a worker reads."""

    def __init__(self, config=None):
        from ray_tpu_torch.rllib.envs import _Box, _Discrete

        self.observation_space, self.action_space = _Box((4,), np.float32), _Discrete(2)
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._s, self._t = self._rng.uniform(-0.05, 0.05, 4), 0
        return self._s.astype(np.float32), {}

    def step(self, action):
        x, x_dot, th, th_dot = self._s
        force = 10.0 if int(action) == 1 else -10.0
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sin) / 1.1
        th_acc = (9.8 * sin - cos * temp) / (0.5 * (4.0 / 3.0 - 0.1 * cos ** 2 / 1.1))
        x_acc = temp - 0.05 * th_acc * cos / 1.1
        self._s = np.array([x + 0.02 * x_dot, x_dot + 0.02 * x_acc,
                            th + 0.02 * th_dot, th_dot + 0.02 * th_acc])
        self._t += 1
        term = bool(abs(self._s[0]) > 2.4 or abs(self._s[2]) > 12 * 2 * np.pi / 360)
        return self._s.astype(np.float32), 1.0, term, self._t >= 500, {}


def _dual_cartpole(config):
    """Two ``_CartPole``s in one ``MultiAgentEnv``; the episode ends when
    both are done."""
    from ray_tpu_torch.rllib import MultiAgentEnv

    class DualCartPole(MultiAgentEnv):
        agents = ["cart_0", "cart_1"]

        def __init__(self):
            self._envs = {a: _CartPole() for a in self.agents}
            self._done = dict.fromkeys(self.agents, False)

        def observation_space(self, agent_id):
            return self._envs[agent_id].observation_space

        def action_space(self, agent_id):
            return self._envs[agent_id].action_space

        def reset(self, *, seed=None, options=None):
            self._done = dict.fromkeys(self.agents, False)
            return {a: env.reset(seed=None if seed is None else seed + i)[0]
                    for i, (a, env) in enumerate(self._envs.items())}, {}

        def step(self, actions):
            obs, rew, terms, truncs = {}, {}, {}, {}
            for a, act in actions.items():
                o, rew[a], terms[a], truncs[a], _ = self._envs[a].step(act)
                self._done[a] = terms[a] or truncs[a]
                if not self._done[a]:
                    obs[a] = o
            terms["__all__"], truncs["__all__"] = all(self._done.values()), False
            return obs, rew, terms, truncs, {}

    return DualCartPole()


def phase_rl_multiagent_offline():
    """A short card check of multi-agent PPO and offline IO, f32 with TF32
    off, no runtime.  ``MultiAgentPPO`` on a two-agent CartPole, a policy
    for each agent on the card, 2 training steps; a CPU learner from the
    same weights is fed the same ``MultiAgentBatch``es: each step's
    per-policy learner metrics and weights agree at ``RL_TOL``.  A PPO
    ``RolloutWorker`` on the card (keeping ``next_obs``, which DQN's TD
    targets read) writes 2 fragments with ``output=``; ``DQN`` with
    ``offline_data(input_=...)`` takes one step on the card from those
    files and one on the CPU from the same weights: learner metrics and
    weights at ``RL_TOL``.  Returns the launch counts of both (none
    expected)."""
    import tempfile

    from ray_tpu_torch.rllib import (DQNConfig, JsonReader, MultiAgentPPOConfig,
                                     RolloutWorker, ppo)

    t0 = time.perf_counter()
    build.reset_launches()

    def ma_config():
        return (MultiAgentPPOConfig().environment(env_creator=_dual_cartpole)
                .rollouts(rollout_fragment_length=100)
                .training(train_batch_size=400, sgd_minibatch_size=128, num_sgd_iter=2,
                          entropy_coeff=0.01)
                .multi_agent(policies=["p0", "p1"], policy_mapping_fn=_agent_policy)
                .debugging(seed=0))

    card, cpu = ma_config().build(), ma_config().resources(device="cpu").build()
    cpols, hpols = card.workers.local_worker.policies, cpu.workers.local_worker.policies
    check(all(p.device.type == "cuda" for p in cpols.values()),
          "rl_multiagent_offline: a policy is not on the card")
    for pid, p in cpols.items():
        hpols[pid].set_state(p.get_state())
    drawn, sample = [], card.workers.synchronous_parallel_sample

    def record():
        drawn.append(sample())
        return drawn[-1]

    card.workers.synchronous_parallel_sample = record
    cpu.workers.synchronous_parallel_sample = lambda: drawn.pop(0)
    ma_err = {"loss": 0.0, "weights": 0.0}
    counts = []
    for _ in range(2):
        got = card.training_step()["info"]["learner"]
        want = cpu.training_step()["info"]["learner"]
        check(set(got) == set(want) == {"p0", "p1"} and not drawn
              and card._timesteps_total == cpu._timesteps_total,
              f"rl_multiagent_offline: learner {set(got)} / {set(want)}")
        counts.append(card._timesteps_total)
        for pid in want:
            ma_err["loss"] = max(ma_err["loss"], *(abs(got[pid][k] - want[pid][k])
                                                   for k in want[pid]))
            ma_err["weights"] = max(ma_err["weights"], _tree_err(cpols[pid].get_weights(),
                                                                 hpols[pid].get_weights()))
    card.cleanup()
    cpu.cleanup()
    check(ma_err["loss"] <= RL_TOL["loss"] and ma_err["weights"] <= RL_TOL["weights"],
          f"rl_multiagent_offline: multi-agent card vs CPU {ma_err}")

    with tempfile.TemporaryDirectory() as out:
        worker = RolloutWorker(dict(ppo.PPO_DEFAULTS, env_creator=_CartPole, output=out,
                                    rollout_fragment_length=200, _store_next_obs=True,
                                    _postprocess_gae=True, seed=0,
                                    _loss_factory=ppo._ppo_loss_factory))
        check(worker.policy.device.type == "cuda", "rl_multiagent_offline: PPO worker device")
        written = sum(worker.sample().count for _ in range(2))
        files = sorted(os.listdir(out))
        check(files == ["output-worker_0-0.json"] and JsonReader(out).read_all().count == written,
              f"rl_multiagent_offline: offline files {files}")

        def dqn(device=None):
            return (DQNConfig().environment(env_creator=_CartPole).offline_data(input_=out)
                    .training(timesteps_per_iteration=written, learning_starts=100,
                              updates_per_iteration=8, train_batch_size=64)
                    .resources(device=device).debugging(seed=0).build())

        dcard, dcpu = dqn(), dqn("cpu")
        dcpu.get_policy().set_state(dcard.get_policy().get_state())
        dcpu.get_policy().update_target()
        dcard.get_policy().update_target()
        got = dcard.training_step()["info"]["learner"]
        want = dcpu.training_step()["info"]["learner"]
        dqn_err = {"loss": max(abs(got[k] - want[k]) for k in want),
                   "weights": _tree_err(dcard.get_policy().get_weights(),
                                        dcpu.get_policy().get_weights())}
        dcard.cleanup()
        dcpu.cleanup()
    check(set(got) == set(want) and "total_loss" in got and dqn_err["loss"] <= RL_TOL["loss"]
          and dqn_err["weights"] <= RL_TOL["weights"],
          f"rl_multiagent_offline: offline DQN card vs CPU {dqn_err}, {got} / {want}")
    launches = dict(build.launches)
    check(not any(launches.values()), f"rl_multiagent_offline: kernel launches {launches}")
    emit("rl_multiagent_offline",
         multi_agent="MultiAgentPPO, two-agent CartPole (numpy), policies p0 and p1 on the "
                     "card, 2 training steps of at least 400 agent steps, minibatches of 128 x "
                     "2 epochs",
         multi_agent_agent_steps=counts, multi_agent_vs_cpu=ma_err,
         offline=f"PPO RolloutWorker on the card, output= 2 fragments of 200 ({written} "
                 "transitions, next_obs kept); DQN offline_data(input_=...), one step of 8 "
                 "updates of 64 rows",
         offline_dqn_vs_cpu=dqn_err, offline_dqn_card=got, tol=RL_TOL,
         wall_s=time.perf_counter() - t0, launches=launches)
    return launches


def _agent_policy(agent_id):
    return f"p{agent_id[-1]}"


def phase_train_gpt2_sharded():
    """The sharded train step on a world of one (see the module doc).
    Returns the sharded run's launch counts."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import train_state
    from ray_tpu_torch.parallel import (MeshSpec, create_mesh, get_abstract_mesh, init_world,
                                        shard_params)
    from ray_tpu_torch.parallel.sharding import rules_for_mesh

    rdv = tempfile.mkdtemp()
    init_world("nccl", 0, 1, "file://" + os.path.join(rdv, "rendezvous"))
    try:
        mesh = create_mesh(MeshSpec(), keep_unit_axes=True)
        cfg = gpt2.GPT2Config.gpt2_small()
        opt = gpt2.make_optimizer(lr=3e-4)
        batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, cfg.max_seq_len)

        def build_run(name):
            # the same seed for both runs; each builds its state only once
            # the other's is freed, so a run's peak holds no tensor of the other
            params = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cuda")
            if name == "sharded":
                return (train_state(shard_params(params, mesh, rules_for_mesh(mesh),
                                                 gpt2.logical_axes(cfg)), opt),
                        gpt2.make_train_step(cfg, opt, mesh))
            return train_state(params, opt), gpt2.make_train_step(cfg, opt)

        want = {attn.KERNEL: 2 * cfg.n_layers, attn.DQ_KERNEL: cfg.n_layers,
                attn.DKV_KERNEL: cfg.n_layers}
        out, launches_sharded = {}, None
        for name in ("sharded", "unsharded"):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, step = build_run(name)
            build.reset_launches()
            losses, ms = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(m["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(build.launches)
            per_step = {k: launches.get(k, 0) / 3 for k in want}
            check(per_step == want, f"{name} step: {per_step} flash launches per step, want {want}")
            check(all(launches.get(c, 0) == launches[k]
                      for k, c in attn.TENSOR_CORE_COUNTER.items()),
                  f"{name} step: not every flash launch ran on the tensor cores: {launches}")
            check(all(np.isfinite(losses)), f"{name} step: non-finite loss {losses}")
            peak = torch.cuda.max_memory_allocated() - base
            busy_ms = phase_train_profile(state, step, batch, ms[-1],
                                          phase=f"train_gpt2_{name}_profile",
                                          model=f"gpt2 125M bf16, B {TRAIN_BATCH} x T "
                                                f"{cfg.max_seq_len}, remat dots, {name} step")
            out[name] = {"losses": losses, "ms_per_step": ms, "host_ms_per_step_after_first":
                         sum(ms[1:]) / 2, "device_work_ms_per_step": busy_ms,
                         "launches_per_step": per_step, "peak_mem_bytes": peak,
                         "mem_before_bytes": base}
            if name == "sharded":
                launches_sharded = launches
            del state, step
        diff = max(abs(a - b) for a, b in zip(out["sharded"]["losses"],
                                              out["unsharded"]["losses"]))
        check(diff <= 2e-3, f"sharded losses {out['sharded']['losses']} against unsharded "
                            f"{out['unsharded']['losses']}")
        emit("train_gpt2_sharded", mesh=get_abstract_mesh(mesh), backend=dist.get_backend(),
             world_size=dist.get_world_size(), model="gpt2 125M bf16 (f32 master weights), "
             f"remat dots, B {TRAIN_BATCH} x T {cfg.max_seq_len}",
             max_loss_diff=diff, loss_tolerance=2e-3, **out)
        return launches_sharded, mesh
    except BaseException:
        dist.destroy_process_group()
        raise


def events_ms(fn, warmup=3, iters=20):
    """Mean ms of ``iters`` back-to-back calls of ``fn`` between two CUDA
    events, after ``warmup`` calls: device time plus whatever host gaps
    the calls leave on the card."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_ring_attention_card(mesh, fwd):
    """Ring attention over the world of one's sp axis at GPT-2's training
    shape, held to flash_attn within phase_kernels' tolerance at the
    training shapes (2e-2).  Both it and flash_attn on the same inputs are
    timed with CUDA events over 20 back-to-back calls (the profiler lost
    the last 3 kernel records of every session of the ring on an H100, 317
    of 320), so their ratio compares one method; flash_fwd's profiler time
    at the same shape from phase_kernels (``fwd``) is printed beside them
    under its own name.  Ends the world."""
    import torch.distributed as dist

    from ray_tpu_torch.ops.ring_attention import ring_attention

    try:
        b, h, _, t, d = train_attn_shapes()["train_gpt2"]
        q, k, v = _qkv(b, h, t, t, d, torch.bfloat16, seed=120)
        ring = lambda: ring_attention(q, k, v, mesh, axis_name="sp", causal=True)
        err = (ring().float() - attn.flash_attn(q, k, v, True).float()).abs().max().item()
        check(bool(torch.isfinite(ring()).all()) and err <= 2e-2,
              f"ring attention against flash_attn: max err {err}")
        ring_ms = events_ms(ring)
        flash_ms = events_ms(lambda: attn.flash_attn(q, k, v, True))
        emit("ring_attention_card", shape=f"{b}x{h}x{t}x{t}x{d} bf16 causal", sp=1,
             max_abs_err_vs_flash_attn=err, tolerance=2e-2,
             ring_ms_cuda_events=ring_ms, flash_attn_ms_cuda_events=flash_ms,
             ring_over_flash_attn=ring_ms / flash_ms,
             flash_fwd_ms_profiler=fwd["at_train_shapes"]["train_gpt2"]["ms"])
    finally:
        dist.destroy_process_group()


# The runtime phases (BASELINE configs 1-3's shapes on one card): the
# MLP's 10 SGD steps (lr 0.1, batch 128 from default_rng(0)) and GPT-2's
# train_gpt2 recipe with 2 warm-up and 5 timed steps in a Train worker
MLP_STEPS, MLP_LR, MLP_BATCH = 10, 0.1, 128
TRAINER_WARMUP, TRAINER_STEPS = 2, 5
# the trainer's losses against the in-process steps from the same seed and
# batch: train_gpt2_sharded's bf16 loss tolerance
TRAINER_LOSS_TOL = 2e-3
# ... and after its last step, each leaf's update (the params less their
# init) against the in-process one: |u - u_ref| / |u_ref| at most this
TRAINER_UPDATE_TOL = 1e-2


def _head_spawn_to_ready_s(actor) -> float:
    """The head's own record of an actor's start: from its
    ``PENDING_CREATION`` to its ``ALIVE`` flight-recorder event (the head
    runs in this process, so its ring is readable here)."""
    from ray_tpu_torch._private import events

    ts = {r["message"].rsplit(" -> ", 1)[-1]: r["ts"] for r in events.buffer().snapshot()
          if r.get("source") == "actor" and r.get("entity_id") == actor._actor_id.hex()}
    check({"PENDING_CREATION", "ALIVE"} <= set(ts), f"core_gpu_actor: head events {ts}")
    return ts["ALIVE"] - ts["PENDING_CREATION"]


def phase_core_gpu_actor(rt):
    """BASELINE config 1: the runtime's head in this process autodetects
    the card; a ``num_gpus=1`` actor sees its grant and runs a 1024^2 bf16
    matmul (f32 accumulation) whose sum is exact; a second such actor
    pends until the first is killed, then runs."""
    gc.collect()
    torch.cuda.empty_cache()
    driver_held = {"allocated_bytes": torch.cuda.memory_allocated(),
                   "reserved_bytes": torch.cuda.memory_reserved()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    gpus = rt.cluster_resources().get("GPU", 0)
    check(gpus == torch.cuda.device_count(),
          f"core_gpu_actor: the head found {gpus} GPU, torch sees {torch.cuda.device_count()}")

    @rt.remote(num_gpus=1)
    class GpuMatmul:
        def info(self):
            import os

            return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "gpu_ids": rt.get_runtime_context().get_gpu_ids(),
                    "device_count": torch.cuda.device_count(), "pid": os.getpid()}

        def matmul(self, n):
            x = torch.ones(n, n, dtype=torch.bfloat16, device="cuda")
            out = x @ x  # bf16 inputs, f32 accumulation in the tensor cores
            torch.cuda.synchronize()
            return float(out.float().sum().item()), torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    a = GpuMatmul.remote()
    info_a = rt.get(a.info.remote(), timeout=120)
    first_reply_s = time.perf_counter() - t0
    grant = ",".join(str(i) for i in info_a["gpu_ids"])
    check(info_a["gpu_ids"] == [0] and info_a["cuda_visible_devices"] == grant
          and info_a["device_count"] == 1, f"core_gpu_actor: grant {info_a}")
    t0 = time.perf_counter()
    total, peak_a = rt.get(a.matmul.remote(1024), timeout=120)
    matmul_s = time.perf_counter() - t0
    check(total == 1024.0 ** 3, f"core_gpu_actor: sum {total}, want {1024.0 ** 3}")
    b = GpuMatmul.remote()
    info_b_ref = b.info.remote()
    ready, _ = rt.wait([info_b_ref], timeout=5)
    check(not ready, "core_gpu_actor: a second num_gpus=1 actor ran while the card was held")
    rt.kill(a)
    t0 = time.perf_counter()
    info_b = rt.get(info_b_ref, timeout=120)
    after_kill_s = time.perf_counter() - t0
    check(info_b["gpu_ids"] == [0] and info_b["pid"] != info_a["pid"],
          f"core_gpu_actor: second actor {info_b}")
    total_b, _ = rt.get(b.matmul.remote(1024), timeout=120)
    check(total_b == 1024.0 ** 3, f"core_gpu_actor: second actor's sum {total_b}")
    rt.kill(b)
    emit("core_gpu_actor", cluster_gpus=gpus, init_s=init_s, actor=info_a,
         second_actor=info_b, head_spawn_to_ready_s=_head_spawn_to_ready_s(a),
         driver_spawn_to_first_reply_s=first_reply_s,
         first_matmul_s=matmul_s, matmul_sum=total, second_actor_pending_until_kill=True,
         second_actor_ready_after_kill_s=after_kill_s, worker_peak_mem_bytes=peak_a,
         driver_peak_mem_bytes=torch.cuda.max_memory_allocated(),
         driver_held_at_start=driver_held)


def _mlp_batches(steps, batch, in_dim, classes):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((batch, in_dim)).astype(np.float32),
             rng.integers(0, classes, batch)) for _ in range(steps)]


def _mlp_steps(device, batches, lr, report=None):
    """The MNIST MLP (784-512-256-10, f32, TF32 off) by SGD, its gradients
    mean-all-reduced over the gang's group when ``report`` is set (a Train
    worker), else plain (the driver).  Returns the per-step losses."""
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.train import torch_utils

    torch.set_float32_matmul_precision("highest")  # TF32 off
    cfg = mlp.MLPConfig()
    params = mlp.init(cfg, torch.Generator().manual_seed(0), device=device)
    losses = []
    for i, (x, y) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        batch = {"x": torch.tensor(x, device=device), "y": torch.tensor(y, device=device)}
        loss = mlp.loss_fn(leaves, batch, cfg)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if report is not None:
            grads = torch_utils.allreduce_grads(grads)
        params = {k: leaves[k].detach() - lr * grads[k] for k in params}
        losses.append(loss.item())
        if report is not None:
            report(i, losses[-1], params)
    return losses


def _mlp_train_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.train import torch_utils

    from ray_tpu_torch.util import collective

    dev = torch_utils.get_device()
    group = collective.get_group_backend(os.environ["RAY_TRAIN_COLLECTIVE_GROUP"])
    check(group == "shm", f"train_mlp_trainer: group {group}")
    ckpt_every = config["checkpoint_every"]

    def report(i, loss, params):
        ckpt = (Checkpoint.from_dict({"step": i, "params": {k: v.cpu().numpy()
                                                           for k, v in params.items()}})
                if (i + 1) % ckpt_every == 0 else None)
        session.report({"step": i, "loss": loss, "device": str(dev),
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)},
                       checkpoint=ckpt)

    losses = _mlp_steps(dev, config["batches"], config["lr"], report)
    session.report({"final": True, "losses": losses, "device": str(dev),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})


def phase_train_mlp_trainer(rt):
    """BASELINE config 2's shape on one card: ``TorchTrainer``, 1 worker
    with ``use_gpu=True``, the MLP's gradients all-reduced through the
    ``shm`` group; per-step losses equal the same loop's in this process
    within 1e-5; ``CheckpointConfig(num_to_keep=2)`` keeps two."""
    import tempfile

    from ray_tpu_torch.air import CheckpointConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    cfg = mlp.MLPConfig()
    batches = _mlp_batches(MLP_STEPS, MLP_BATCH, cfg.in_dim, cfg.num_classes)
    want = _mlp_steps("cuda", batches, MLP_LR)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as storage:
        t0 = time.perf_counter()
        result = TorchTrainer(
            _mlp_train_loop,
            train_loop_config={"batches": batches, "lr": MLP_LR, "checkpoint_every": 2},
            # the shm group on a GPU worker, asked for by name (the default
            # there is the torch group): each step's gradients cross the host
            torch_config=TorchConfig(use_torch_distributed=False),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="mlp", storage_path=storage,
                                 checkpoint_config=CheckpointConfig(num_to_keep=2)),
        ).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"train_mlp_trainer: {result.error}")
        kept = sorted(d for d in os.listdir(os.path.join(storage, "mlp"))
                      if d.startswith("checkpoint_"))
        best_step = result.checkpoint.to_dict()["step"]
    check(len(kept) == 2, f"train_mlp_trainer: kept {kept}, want 2")
    check(best_step == MLP_STEPS - 1, f"train_mlp_trainer: latest checkpoint at step {best_step}")
    got = result.metrics
    check(got.get("final") and got["device"] == "cuda:0", f"train_mlp_trainer: last report {got}")
    diff = max(abs(a - b) for a, b in zip(got["losses"], want))
    check(len(got["losses"]) == MLP_STEPS and diff <= 1e-5,
          f"train_mlp_trainer: losses {got['losses']} against the driver's {want}")
    emit("train_mlp_trainer", model="mlp 784-512-256-10 f32, TF32 off", steps=MLP_STEPS,
         batch=MLP_BATCH, lr=MLP_LR, group="shm", worker_device=got["device"],
         losses=got["losses"], driver_losses=want, max_loss_diff=diff, tolerance=1e-5,
         checkpoints_kept=kept, fit_s=fit_s, worker_peak_mem_bytes=got["peak_mem_bytes"],
         driver_peak_mem_bytes=torch.cuda.max_memory_allocated())


def _gpt2_train_loop(config):
    """GPT-2 125M at train_gpt2's recipe in a Train worker on its granted
    card: the step's forward and backward (wrapped: its first call is
    billed to ``compile``), the gradients all-reduced in one round over the
    gang's ``torch`` group (NCCL), AdamW; every step reports its loss, its
    StepProfiler phases, the live MFU and the flash launches it made.  The
    last report holds the update of all its steps against the in-process
    one saved at ``config["reference_update"]`` (a dict by learning rate
    under Tune, whose trials set ``config["lr"]``; 3e-4 when unset).  With
    ``config["checkpoint"]`` it also holds the loss of the final params on
    the step's batch as ``loss`` (Tune's metric), with those params as its
    checkpoint, the trial's name and the wall-clock times the loop and its
    first step began; ``config["device_work"]`` False skips the profiled
    steps after the last report's update.  With ``config["dataset"]``
    each step's batch is the next ``[B, T + 1]`` id rows of the worker's
    shard (``session.get_dataset_shard("train")``), inputs and targets the
    rows less their last and first id, billed to the ``ingest`` (the wait
    for the rows) and ``h2d`` (the copy to the card) phases; each report
    then holds the step's wait for its rows.  Every step runs inside
    ``profiling.timed("train_step")``, and the last report holds that
    histogram's count and sum; with ``config["profile_dir"]`` it also
    holds ``_one_step_trace``'s record of one more step traced by
    ``profiling.profile_step``."""
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import named_leaves
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn_mod
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.util import collective, metrics, profiling
    from ray_tpu_torch.util.tree import tree_map

    loop_began = time.time()
    dev = torch_utils.get_device()
    group = os.environ["RAY_TRAIN_COLLECTIVE_GROUP"]
    check(collective.get_group_backend(group) == "torch"
          and torch.distributed.get_backend() == "nccl",
          f"train_gpt2_trainer: group {collective.get_group_backend(group)}")
    cfg = gpt2.GPT2Config.gpt2_small()
    lr = config.get("lr", 3e-4)
    opt = gpt2.make_optimizer(lr=lr)
    state = gpt2.init_state(cfg, torch.Generator().manual_seed(0), opt, device=dev)
    init = {k: p.detach().clone() for k, p in named_leaves(state["params"])}
    b, t = config["batch"], cfg.max_seq_len
    if config.get("dataset"):
        rows_iter = iter(session.get_dataset_shard("train").iter_batches(batch_size=b))
    else:
        rng = np.random.default_rng(0)
        batch = {"inputs": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t), np.int32)).long().to(dev),
                 "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t), np.int32)).long().to(dev)}
    n_params = gpt2.num_params(state["params"])
    prof = torch_utils.step_profiler(cfg=cfg, n_params=n_params, tokens_per_step=b * t,
                                     device=dev)

    def forward_backward(params, batch):
        loss = gpt2.loss_fn(params, batch, cfg)
        loss.backward()
        return loss.detach()

    step_fn = prof.wrap_jit(forward_backward, name="gpt2_forward_backward")

    def next_batch():
        with prof.phase("ingest"):
            t0 = time.perf_counter()
            rows = next(rows_iter)
            wait = time.perf_counter() - t0
        with prof.phase("h2d"):
            rows = torch.from_numpy(rows).to(dev).long()
        return {"inputs": rows[:, :-1].contiguous(), "targets": rows[:, 1:].contiguous()}, wait

    def train_step(fwd_bwd):
        gpt2.AdamW.zero_grad(state["opt_state"])
        loss = fwd_bwd(state["params"], batch)
        grads = torch_utils.allreduce_grads(tree_map(lambda p: p.grad, state["params"]))
        tree_map(lambda p, g: setattr(p, "grad", g), state["params"], grads)
        with prof.phase("compute"):
            gpt2.AdamW.update(state["opt_state"])
        state["step"] += 1
        return loss

    torch.cuda.reset_peak_memory_stats(dev)
    history = []
    first_step_began = time.time()
    for i in range(config["warmup"] + config["steps"]):
        _build.reset_launches()
        wait = None
        with profiling.timed("train_step"), prof.step():
            if config.get("dataset"):
                batch, wait = next_batch()
            loss = train_step(step_fn)
        launches = {k: _build.launches.get(k, 0) for k in (
            attn_mod.KERNEL, attn_mod.DQ_KERNEL, attn_mod.DKV_KERNEL,
            *attn_mod.TENSOR_CORE_COUNTER.values())}
        s = prof.steps[-1]
        history.append({"step": i, "loss": loss.item(), "wall_s": s["wall_s"],
                        "phases": s["phases"], "mfu": s["mfu"], "launches": launches,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                        "device": str(dev), "batch_wait_s": wait})
        session.report(history[-1])
    reference = config["reference_update"]
    update = _update_error(state["params"], init,
                           reference[lr] if isinstance(reference, dict) else reference)
    del init
    (timed,) = metrics.registry().snapshot()[
        "ray_tpu_torch_timed_train_step_seconds"]["values"].values()
    last = {"final": True, "summary": prof.summary(), "history": history,
            "n_params": n_params, "update": update,
            "timed_train_step": {"count": timed["count"], "sum_s": timed["sum"]}}
    if config.get("profile_dir"):
        last["one_step_trace"] = _one_step_trace(prof, lambda: train_step(forward_backward),
                                                 config["profile_dir"])
    checkpoint = None
    if config.get("checkpoint"):
        with torch.no_grad():
            last["loss"] = gpt2.loss_fn(state["params"], batch, cfg).item()
        # the card's tensors: the checkpoint keeps host copies
        checkpoint = Checkpoint.from_dict({"params": state["params"]})
        last.update(trial=session.get_trial_name(), loop_began=loop_began,
                    first_step_began=first_step_began)
    if config.get("device_work", True):
        last["device_work"] = _step_device_work(lambda: train_step(forward_backward))
    session.report(last, checkpoint=checkpoint)


def _trace_files(logdir):
    """``{name: (mtime_ns, size)}`` of the files in ``logdir``."""
    if not os.path.isdir(logdir):
        return {}
    return {n: (st.st_mtime_ns, st.st_size) for n in sorted(os.listdir(logdir))
            for st in [os.stat(os.path.join(logdir, n))]}


def _one_step_trace(prof, step, logdir, tries=3):
    """``profiling.profile_step(logdir)``, then one ``prof.step()`` of
    ``step``: the files the trace wrote under ``logdir`` and the
    ``flash_fwd`` kernels its device events name; then one more step, after
    which ``logdir`` must be as it was (one step traced, the next not).  An
    H100 profiler session has come back without device events
    (``device_ms``), so a trace that names no flash kernel is taken again,
    up to ``tries`` times."""
    from ray_tpu_torch.util import profiling

    for attempt in range(1, tries + 1):
        armed = profiling.profile_step(logdir)
        with prof.step():
            step()
        files = _trace_files(logdir)
        kernels = set()
        for name in files:
            with open(os.path.join(logdir, name)) as f:
                kernels |= {m for e in json.load(f).get("traceEvents", [])
                            for m in re.findall(r"flash_fwd_kernel\w*", str(e.get("name", "")))}
        if kernels:
            break
    with prof.step():
        step()
    return {"armed": armed, "attempts": attempt, "files": files,
            "flash_kernels": sorted(kernels),
            "next_step_untraced": _trace_files(logdir) == files}


def _update_error(params, init, path):
    """This run's update (``params`` less ``init``) against the one saved
    at ``path``: the worst leaf's ``|u - u_ref| / |u_ref|`` (Frobenius
    norms), that leaf, and the smallest ``|u_ref|`` of any leaf."""
    from ray_tpu_torch.models.transformer import named_leaves

    ref = torch.load(path)
    worst, leaf, smallest = -1.0, None, float("inf")
    for k, p in named_leaves(params):
        u, u_ref = p.detach() - init[k], ref[k].to(p.device)
        norm_ref = torch.linalg.vector_norm(u_ref).item()
        rel = torch.linalg.vector_norm(u - u_ref).item() / max(norm_ref, 1e-30)
        smallest = min(smallest, norm_ref)
        if rel > worst:
            worst, leaf = rel, k
    return {"max_rel_err": worst, "worst_leaf": leaf, "min_ref_norm": smallest,
            "leaves": len(ref)}


def _step_device_work(step, reps=3):
    """A step's device work, outside the StepProfiler (which syncs every
    phase): the device wall of ``reps`` unsynchronised steps by CUDA
    events, then one step under ``torch.profiler``: kernel time, kernels,
    the collective's kernels (NCCL) and the card's idle share."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / reps
    kernels = profiled_events(step, "train_gpt2_trainer (in the worker)")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return {"step_device_wall_ms": wall_ms, "device_busy_ms": busy, "kernels": len(kernels),
            "idle_share": 1 - busy / wall_ms, "nccl_kernels": len(nccl),
            "nccl_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3}


def _gpt2_reference(n, update_path, rows=None, lr=3e-4):
    """``n`` steps of the in-process step (make_train_step at ``lr``) from
    the same seed and batch (or, given ``rows``, over its ``[B, T + 1]`` id
    rows in turn, as ``_gpt2_train_loop`` reads a dataset): their losses;
    each leaf's update over them (the params less their init) is saved to
    ``update_path`` on the host."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.transformer import named_leaves

    cfg = gpt2.GPT2Config.gpt2_small()
    opt = gpt2.make_optimizer(lr=lr)
    state = gpt2.init_state(cfg, torch.Generator().manual_seed(0), opt, device="cuda")
    init = {k: p.detach().clone() for k, p in named_leaves(state["params"])}
    step = gpt2.make_train_step(cfg, opt)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, cfg.max_seq_len)
    losses = []
    for i in range(n):
        if rows is not None:
            r = torch.from_numpy(rows[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).cuda().long()
            batch = {"inputs": r[:, :-1].contiguous(), "targets": r[:, 1:].contiguous()}
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    torch.save({k: (p.detach() - init[k]).cpu() for k, p in named_leaves(state["params"])},
               update_path)
    del state, step, batch, init
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def phase_train_gpt2_trainer(rt, in_process_row, phase="train_gpt2_trainer", rows=None,
                             trainer_row=None):
    """BASELINE config 3's model on one card (see the module doc); with
    ``rows`` (``train_gpt2_dataset``) the worker reads each step's batch
    from ``datasets={"train": from_numpy(rows)}`` and the in-process
    reference steps over the same rows.  Returns the flash launches the
    Train worker made over all its steps, and its row."""
    import tempfile

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    n_steps = TRAINER_WARMUP + TRAINER_STEPS
    with tempfile.TemporaryDirectory() as storage:
        update_path = os.path.join(storage, "reference_update.pt")
        profile_dir = os.path.join(storage, "profile_step") if rows is None else None
        want_losses = _gpt2_reference(n_steps, update_path, rows)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = TorchTrainer(
            _gpt2_train_loop,
            train_loop_config={"batch": TRAIN_BATCH, "warmup": TRAINER_WARMUP,
                               "steps": TRAINER_STEPS, "reference_update": update_path,
                               "dataset": rows is not None, "profile_dir": profile_dir},
            torch_config=TorchConfig(use_torch_distributed=True),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            datasets=None if rows is None else {"train": rd.from_numpy(rows)},
            run_config=RunConfig(name="gpt2", storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
    check(result.error is None, f"{phase}: {result.error}")
    final = result.metrics
    check(bool(final.get("final")), f"{phase}: last report {final}")
    steps = final["history"]
    check(len(steps) == n_steps, f"{phase}: {len(steps)} steps")
    losses = [r["loss"] for r in steps]
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss {losses}")
    diff = max(abs(a - b) for a, b in zip(losses, want_losses))
    check(diff <= TRAINER_LOSS_TOL, f"{phase}: losses {losses} against the "
          f"in-process {want_losses}")
    check(final["timed_train_step"]["count"] == n_steps,
          f"{phase}: timed('train_step') counted {final['timed_train_step']}")
    trace = final.get("one_step_trace")
    if profile_dir is not None:
        check(trace["armed"] and trace["files"] and trace["next_step_untraced"]
              and "flash_fwd_kernel_tc" in trace["flash_kernels"],
              f"{phase}: profile_step's one-step trace {trace}")
    update = final["update"]
    check(update["max_rel_err"] <= TRAINER_UPDATE_TOL,
          f"{phase}: the update of leaf {update['worst_leaf']} differs from the "
          f"in-process one by {update['max_rel_err']} of its norm ({update})")
    n_layers = gpt2.GPT2Config.gpt2_small().n_layers
    want = {attn.KERNEL: 2 * n_layers, attn.DQ_KERNEL: n_layers, attn.DKV_KERNEL: n_layers}
    for r in steps:
        got = {k: r["launches"][k] for k in want}
        check(got == want, f"{phase}: step {r['step']} launched {got}, want {want}")
        check(all(r["launches"][c] == r["launches"][k]
                  for k, c in attn.TENSOR_CORE_COUNTER.items()),
              f"{phase}: not every flash launch ran on the tensor cores: {r['launches']}")
    timed = steps[TRAINER_WARMUP:]
    tokens = TRAIN_BATCH * gpt2.GPT2Config.gpt2_small().max_seq_len
    tok_s = sorted(tokens / r["wall_s"] for r in timed)
    launches = {}
    for r in steps:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    extra = {}
    if rows is not None:
        waits = [r["batch_wait_s"] for r in steps]
        extra = {"dataset": f"from_numpy of {rows.shape[0]} x {rows.shape[1]} int32 id rows "
                            "(default_rng(0)), iter_batches(batch_size="
                            f"{TRAIN_BATCH}); inputs rows[:, :-1], targets rows[:, 1:]",
                 "batch_wait_ms_by_step": [w * 1e3 for w in waits],
                 "batch_wait_ms_timed_median": sorted(waits[TRAINER_WARMUP:])[
                     len(timed) // 2] * 1e3,
                 "trainer_fixed_batch_tokens_per_s_median": trainer_row["tokens_per_s_median"]}
    row = dict(model="gpt2 125M bf16 (f32 master weights), remat dots, "
               f"B {TRAIN_BATCH} x T 1024, TorchTrainer 1 worker, "
               "TorchConfig(use_torch_distributed=True)",
               worker_device=steps[0]["device"], fit_s=fit_s, losses=losses,
               in_process_losses=want_losses, max_loss_diff=diff,
               loss_tolerance=TRAINER_LOSS_TOL, update_vs_in_process=update,
               update_tolerance=TRAINER_UPDATE_TOL, **extra,
               timed_train_step=final["timed_train_step"], one_step_trace=trace,
               phases_by_step=[{"step": r["step"], "wall_ms": r["wall_s"] * 1e3,
                                "phases_ms": {k: v * 1e3 for k, v in r["phases"].items()},
                                "mfu": r["mfu"]} for r in steps],
               tokens_per_s_median=tok_s[len(tok_s) // 2], tokens_per_s_best=tok_s[-1],
               in_process_train_gpt2_tokens_per_s_median=in_process_row["tokens_per_s_median"],
               mfu_live_timed_median=sorted(r["mfu"] for r in timed)[len(timed) // 2],
               mfu_live_mean_all_steps=final["summary"]["mfu"]["mean"],
               profiler_summary=final["summary"], worker_step_device_work=final["device_work"],
               flash_launches_per_step={k: v / len(steps) for k, v in launches.items()},
               worker_peak_mem_bytes=steps[-1]["peak_mem_bytes"],
               driver_peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit(phase, **row)
    return launches, row


def phase_train_gpt2_dataset(rt, in_process_row, trainer_row):
    """``train_gpt2_trainer`` with its batches from a Dataset: ``TRAIN_BATCH``
    rows of ``T + 1`` ids a step, ``default_rng(0)``; see the module doc."""
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.gpt2_small()
    n_rows = TRAIN_BATCH * (TRAINER_WARMUP + TRAINER_STEPS)
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size, (n_rows, cfg.max_seq_len + 1),
                                             np.int32)
    return phase_train_gpt2_trainer(rt, in_process_row, "train_gpt2_dataset", rows,
                                    trainer_row)[0]


# tune_gpt2_trainer: a grid of two learning rates, each trial a TorchTrainer
# worker on half the card; the trial hosts hold half a CPU each, so the two
# hosts and the two Train workers (1 CPU each) take 3 of the runtime's 4
TUNE_LRS = (3e-4, 1e-4)
TUNE_TRIAL_RESOURCES = {"CPU": 0.5}


def _actor_lives(w0):
    """The head's actor events since ``w0`` (wall-clock): for each actor, its
    class and the times of its first ``PENDING_CREATION``, ``ALIVE`` and
    ``DEAD`` events (the head runs in this process)."""
    from ray_tpu_torch._private import events

    lives = {}
    for r in events.buffer().snapshot():
        if r.get("source") != "actor" or r["ts"] < w0:
            continue
        cls, _, state = r["message"].partition(" -> ")
        life = lives.setdefault(r["entity_id"], {"class": cls})
        life.setdefault(state.split(" ")[0], r["ts"])
    return lives


def phase_tune_gpt2_trainer(rt, trainer_row):
    """This slice's main path: ``Tuner(TorchTrainer(_gpt2_train_loop, ...))``
    over ``lr`` in ``TUNE_LRS``, two trials at once, each a Train worker on
    half the card (see the module doc).  Returns the flash launches of both
    trials' workers over all their steps."""
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.util.tree import tree_map

    cfg = gpt2.GPT2Config.gpt2_small()
    n_steps = TRAINER_WARMUP + TRAINER_STEPS
    with tempfile.TemporaryDirectory() as storage:
        paths = {lr: os.path.join(storage, f"reference_update_{i}.pt")
                 for i, lr in enumerate(TUNE_LRS)}
        want_losses = {lr: _gpt2_reference(n_steps, paths[lr], lr=lr) for lr in TUNE_LRS}
        trainer = TorchTrainer(
            _gpt2_train_loop,
            train_loop_config={"batch": TRAIN_BATCH, "warmup": TRAINER_WARMUP,
                               "steps": TRAINER_STEPS, "reference_update": paths,
                               "checkpoint": True, "device_work": False},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         resources_per_worker={"GPU": 0.5}),
            run_config=RunConfig(name="gpt2", storage_path=storage))
        tuner = tune.Tuner(trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
                           tune_config=tune.TuneConfig(
                               metric="loss", mode="min", max_concurrent_trials=len(TUNE_LRS),
                               resources_per_trial=TUNE_TRIAL_RESOURCES),
                           run_config=RunConfig(name="tune_gpt2", storage_path=storage))
        w0, t0 = time.time(), time.perf_counter()
        grid = tuner.fit()
        fit_s = time.perf_counter() - t0
        check(not grid.errors and len(grid) == len(TUNE_LRS), f"tune_gpt2_trainer: {grid.errors}")
        trials = {grid[i].metrics["config"]["lr"]: grid[i] for i in range(len(grid))}
        check(sorted(trials) == sorted(TUNE_LRS), f"tune_gpt2_trainer: trials {sorted(trials)}")
        names = {lr: r.metrics["trial"] for lr, r in trials.items()}
        check(len(set(names.values())) == len(TUNE_LRS)
              and all(os.path.isdir(os.path.join(storage, n)) for n in names.values()),
              f"tune_gpt2_trainer: trial storage {names}")
        best = grid.get_best_result()
        last = {lr: r.metrics["loss"] for lr, r in trials.items()}
        check(best.metrics["config"]["lr"] == min(last, key=last.get),
              f"tune_gpt2_trainer: best {best.metrics['config']} of last losses {last}")
        params = tree_map(lambda x: x.cuda(), best.checkpoint.to_dict()["params"])
        with torch.no_grad():
            ckpt_loss = gpt2.loss_fn(params, _train_batch(cfg.vocab_size, TRAIN_BATCH,
                                                          cfg.max_seq_len), cfg).item()
        del params
        torch.cuda.empty_cache()
        check(abs(ckpt_loss - best.metrics["loss"]) <= TRAINER_LOSS_TOL,
              f"tune_gpt2_trainer: the best checkpoint's loss {ckpt_loss} against the "
              f"reported {best.metrics['loss']}")

    lives = _actor_lives(w0)
    workers = [v for v in lives.values() if v["class"] == "TrainWorker"]
    hosts = [v for v in lives.values() if v["class"] == "_TrialHost"]
    check(len(workers) == len(hosts) == len(TUNE_LRS)
          and all({"PENDING_CREATION", "ALIVE"} <= set(v) for v in workers + hosts)
          and all("DEAD" in v for v in workers)
          and max(v["ALIVE"] for v in workers) < min(v["DEAD"] for v in workers),
          f"tune_gpt2_trainer: the Train workers were not alive at once: {lives}")
    n_layers = cfg.n_layers
    want = {attn.KERNEL: 2 * n_layers, attn.DQ_KERNEL: n_layers, attn.DKV_KERNEL: n_layers}
    tokens = TRAIN_BATCH * cfg.max_seq_len
    launches, rows = {}, {}
    for lr, r in trials.items():
        m = r.metrics
        steps = m["history"]
        losses = [s["loss"] for s in steps]
        diff = max(abs(a - b) for a, b in zip(losses, want_losses[lr]))
        check(len(steps) == n_steps and all(np.isfinite(losses)) and diff <= TRAINER_LOSS_TOL,
              f"tune_gpt2_trainer: lr {lr}: losses {losses} against the in-process "
              f"{want_losses[lr]}")
        check(m["update"]["max_rel_err"] <= TRAINER_UPDATE_TOL,
              f"tune_gpt2_trainer: lr {lr}: update {m['update']}")
        for s in steps:
            got = {k: s["launches"][k] for k in want}
            check(got == want, f"tune_gpt2_trainer: lr {lr} step {s['step']} launched {got}")
            check(all(s["launches"][c] == s["launches"][k]
                      for k, c in attn.TENSOR_CORE_COUNTER.items()),
                  f"tune_gpt2_trainer: not every flash launch ran on the tensor cores: "
                  f"{s['launches']}")
            for k, n in s["launches"].items():
                launches[k] = launches.get(k, 0) + n
        steps_s = sum(s["wall_s"] for s in steps)
        tok_s = sorted(tokens / s["wall_s"] for s in steps[TRAINER_WARMUP:])
        rows[lr] = {
            "trial": m["trial"], "device": steps[0]["device"], "losses": losses,
            "in_process_losses": want_losses[lr], "max_loss_diff": diff,
            "update_vs_in_process": m["update"], "last_loss": m["loss"],
            "tokens_per_s_median": tok_s[len(tok_s) // 2], "tokens_per_s_best": tok_s[-1],
            "worker_peak_mem_bytes": steps[-1]["peak_mem_bytes"],
            "steps_s": steps_s, "loop_began_s": m["loop_began"] - w0,
            "first_step_began_s": m["first_step_began"] - w0}
    # the fit's wall less the longer trial's steps (the trials run at once):
    # until both hosts are up, then until both trials' first steps, then the
    # rest (the slower trial's end, its reports, checkpoints, saves and stops)
    hosts_up = max(v["ALIVE"] for v in hosts) - w0
    first_steps = max(r["first_step_began_s"] for r in rows.values())
    longest = max(r["steps_s"] for r in rows.values())
    overhead = {"trial_hosts_start": hosts_up, "trainers_start": first_steps - hosts_up,
                "run_loop": fit_s - first_steps - longest, "total": fit_s - longest}
    spawn = {c: [v["ALIVE"] - v["PENDING_CREATION"] for v in lives.values() if v["class"] == c]
             for c in ("_TrialHost", "TrainWorker")}
    emit("tune_gpt2_trainer",
         model=f"gpt2 125M bf16 (f32 master weights), remat dots, B {TRAIN_BATCH} x T 1024",
         path=f"Tuner(TorchTrainer(num_workers=1, use_gpu=True, resources_per_worker="
              f"{{'GPU': 0.5}})), lr grid {list(TUNE_LRS)}, max_concurrent_trials "
              f"{len(TUNE_LRS)}, resources_per_trial {TUNE_TRIAL_RESOURCES}",
         fit_s=fit_s, wall_s_less_longest_trial_steps=overhead,
         head_spawn_to_ready_s=spawn, trials=rows, best_lr=best.metrics["config"]["lr"],
         best_checkpoint_loss=ckpt_loss, loss_tolerance=TRAINER_LOSS_TOL,
         summed_step_s=sum(r["steps_s"] for r in rows.values()),
         train_gpt2_trainer_tokens_per_s_median=trainer_row["tokens_per_s_median"],
         both_trials_tokens_per_s_median=sum(r["tokens_per_s_median"] for r in rows.values()),
         workers_alive_together=True,
         flash_launches_per_step={k: v / (len(TUNE_LRS) * n_steps) for k, v in launches.items()})
    return launches


# data_ingest (bench.py's streaming_ingest row): 512 MiB of f64 from
# default_rng(3) in 16 blocks, map_batches(x * 2.0), batches of 2^14 rows
# with 4 blocks prefetched
INGEST_MB, INGEST_BLOCKS, INGEST_BATCH, INGEST_PREFETCH = 512, 16, 1 << 14, 4
# batch_predict_bert: the pools scored in turn, (actors, share of a card each),
# and the copies of serve_bert's requests each pool scores, so that the
# window after the first batch lasts seconds
PREDICT_POOLS = ((1, 1), (2, 0.5))
PREDICT_REPEAT = 16


def _ingest_loop(config=None):
    """The Train worker's side of ``data_ingest`` (``bench.py``
    ``_ingest_loop``): iterate the shard, copy each batch to the card and
    sum it there; report GiB/s, each batch's wait, the bytes seen, the
    card-side sum and this process's streaming counters."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.util import metrics

    dev = torch_utils.get_device()
    total = torch.zeros((), dtype=torch.float64, device=dev)
    lats, seen = [], 0
    t0 = tb = time.perf_counter()
    for batch in session.get_dataset_shard("train").iter_batches(
            batch_size=INGEST_BATCH, prefetch_blocks=INGEST_PREFETCH):
        lats.append(time.perf_counter() - tb)
        seen += batch.nbytes
        total += torch.from_numpy(batch).to(dev).sum()
        tb = time.perf_counter()
    total = total.item()  # waits for the last copy and sum
    dt = time.perf_counter() - t0
    counters = {name: sum(m["values"].values())
                for name, m in metrics.registry().snapshot().items()
                if name.startswith(("ray_tpu_torch_streaming_", "ray_tpu_torch_data_"))}
    session.report({"gib_per_s": seen / (1 << 30) / dt, "bytes": seen, "wall_s": dt,
                    "batches": len(lats), "card_sum": total, "device": str(dev),
                    "batch_p50_ms": pct(lats, 0.5) * 1e3, "batch_p99_ms": pct(lats, 0.99) * 1e3,
                    "batch_max_ms": max(lats) * 1e3, "counters": counters})


def phase_data_ingest(rt):
    """``bench.py``'s ``streaming_ingest`` row on the port: a ``TorchTrainer``
    worker holding the card iterates its Dataset shard while the streaming
    executor produces it (see the module doc).  Checks the bytes seen and
    the card-side sum against ``2 * arr.sum()``; reports the ``/dev/shm``
    mount the object store lives on."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch._private.config import resolve_object_store_memory
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    shm = os.statvfs("/dev/shm")
    arr = np.random.default_rng(3).standard_normal((INGEST_MB << 20) // 8)
    want = 2.0 * arr.sum()
    t0 = time.perf_counter()
    ds = rd.from_numpy(arr, parallelism=INGEST_BLOCKS).map_batches(lambda b: b * 2.0)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = TorchTrainer(_ingest_loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                          datasets={"train": ds}).fit()
    fit_s = time.perf_counter() - t0
    check(result.error is None, f"data_ingest: {result.error}")
    m = result.metrics
    check(m["bytes"] == arr.nbytes == INGEST_MB << 20,
          f"data_ingest: the worker saw {m['bytes']} bytes, want {INGEST_MB << 20}")
    rel = abs(m["card_sum"] - want) / abs(want)
    check(rel <= 1e-9, f"data_ingest: card-side sum {m['card_sum']}, want {want} ({rel})")
    emit("data_ingest", dataset=f"from_numpy({INGEST_MB} MiB f64, parallelism={INGEST_BLOCKS})"
         ".map_batches(x * 2.0)", batch_rows=INGEST_BATCH, prefetch_blocks=INGEST_PREFETCH,
         worker_device=m["device"], put_s=put_s, fit_s=fit_s, gib_per_s=m["gib_per_s"],
         ingest_wall_s=m["wall_s"], batches=m["batches"], batch_p50_ms=m["batch_p50_ms"],
         batch_p99_ms=m["batch_p99_ms"], batch_max_ms=m["batch_max_ms"], bytes=m["bytes"],
         card_sum=m["card_sum"], want_sum=want, sum_rel_err=rel, sum_tolerance=1e-9,
         worker_counters=m["counters"], dev_shm_bytes=shm.f_frsize * shm.f_blocks,
         dev_shm_free_bytes=shm.f_frsize * shm.f_bavail,
         object_store_bytes=resolve_object_store_memory())


def phase_batch_predict_bert(rt, served):
    """BERT-base bf16 from ``serve_bert``'s directory checkpoint, scored over
    a Dataset of ``PREDICT_REPEAT`` copies of its ``BERT_REQUESTS`` x 128
    ids (blocks of ``BERT_BATCH`` rows) by
    ``BatchPredictor.predict(batch_size=BERT_BATCH)``, once per
    pool of ``PREDICT_POOLS``; see the module doc.  Returns the flash
    launches the actors made, summed over both pools."""
    import functools

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    class LaunchCountingPredictor(TorchPredictor):
        """TorchPredictor whose batch also carries, as columns, the flash
        launches this actor made for it (all and tensor-core, on its first
        row), the actor's grant and its pid."""

        def predict(self, batch, **kwargs):
            from ray_tpu_torch.ops import _build
            from ray_tpu_torch.ops import attention as attn_mod

            bert.check_tokens(batch, bert.BertConfig.base())
            before = [_build.launches.get(k, 0) for k in (attn_mod.KERNEL, attn_mod.FWD_TC)]
            out = {"predictions": super().predict(batch)}
            n = len(batch)
            for col, k, b in zip(("flash", "flash_tc"), (attn_mod.KERNEL, attn_mod.FWD_TC), before):
                out[col] = np.zeros(n, np.int64)
                out[col][0] = _build.launches.get(k, 0) - b
            out["grant"] = np.asarray([os.environ.get("CUDA_VISIBLE_DEVICES")] * n)
            out["pid"] = np.full(n, os.getpid())
            return out

    cfg = bert.BertConfig.base()
    requests = np.tile(
        np.random.default_rng(0).integers(1, BERT_ID_HIGH, (BERT_REQUESTS, BERT_SEQ)),
        (PREDICT_REPEAT, 1))
    want_labels = np.tile(served["labels"], PREDICT_REPEAT)
    n_rows = len(requests)
    n_batches = n_rows // BERT_BATCH
    want = cfg.n_layers * n_batches
    pools, launches = [], {}
    for workers, share in PREDICT_POOLS:
        ds = rd.from_numpy(requests, parallelism=n_batches)
        t0 = time.perf_counter()
        out = BatchPredictor.from_checkpoint(
            Checkpoint.from_directory(served["checkpoint"]), LaunchCountingPredictor,
            apply_fn=functools.partial(bert.apply, cfg=cfg),
        ).predict(ds, batch_size=BERT_BATCH, min_scoring_workers=workers,
                  max_scoring_workers=workers, num_gpus_per_worker=share)
        batches, first_s = [], None
        for b in out.iter_batches(batch_size=BERT_BATCH):
            first_s = first_s or time.perf_counter() - t0
            batches.append(b)
        wall = time.perf_counter() - t0
        cols = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
        phase = f"batch_predict_bert ({workers} x {share} card)"
        labels = cols["predictions"].argmax(-1)
        check(labels.shape == want_labels.shape and bool((labels == want_labels).all()),
              f"{phase}: {int((labels != want_labels).sum())} labels differ from serve_bert's")
        got = {"all": int(cols["flash"].sum()), "tensor_core": int(cols["flash_tc"].sum())}
        check(got == {"all": want, "tensor_core": want},
              f"{phase}: flash_fwd launches in the actors {got}, want {want} each")
        check(set(cols["grant"].tolist()) == {"0"} and len(set(cols["pid"].tolist())) == workers,
              f"{phase}: grants {set(cols['grant'].tolist())}, pids {set(cols['pid'].tolist())}")
        deadline = time.time() + 60  # the pool is killed once its last block is sealed
        while rt.available_resources().get("GPU") != rt.cluster_resources().get("GPU") \
                and time.time() < deadline:
            time.sleep(0.1)
        check(rt.available_resources().get("GPU") == rt.cluster_resources().get("GPU"),
              f"{phase}: the pool kept its card: {rt.available_resources()}")
        for k, n in (("flash_fwd", got["all"]), ("flash_fwd_tc", got["tensor_core"])):
            launches[k] = launches.get(k, 0) + n
        pools.append({"actors": workers, "num_gpus_per_worker": share, "wall_s": wall,
                      "first_batch_s": first_s, "sequences_per_s": n_rows / wall,
                      "window_after_first_batch_s": wall - first_s,
                      "sequences_per_s_after_first_batch":
                          (n_rows - BERT_BATCH) / (wall - first_s),
                      "flash_launches": got, "flash_launches_per_batch": got["all"] / n_batches,
                      "labels_equal_serve_bert": True})
    emit("batch_predict_bert", model="bert-base bf16 (blocks bf16; embeddings, pooler, "
         "classifier f32), serve_bert's directory checkpoint",
         dataset=f"from_numpy({PREDICT_REPEAT} copies of {BERT_REQUESTS} x {BERT_SEQ} ids, "
                 f"parallelism={n_batches})",
         batch_size=BERT_BATCH, pools=pools,
         serve_bert_in_process_sequences_per_s=served["sequences_per_s"])
    return ({attn.KERNEL: launches["flash_fwd"], attn.FWD_TC: launches["flash_fwd_tc"]},
            {f"{w}x{share}": {k: row[k] for k in ("sequences_per_s",
                                                 "sequences_per_s_after_first_batch")}
             for (w, share), row in zip(PREDICT_POOLS, pools)})


# util_pool_bert_accounting: serve_bert's 768 x 128 ids in 48 batches of
# 16 through an ActorPool of two half-card BERT-base actors, a Queue of 8
# drained by one of them, and a multiprocessing Pool of 4 CPU workers; the
# metrics push at 0.5 s, then at its 5 s default for the push-cost rerun,
# each rate over enough maps to span 20 pushes at 0.5 s
POOL_ACTORS, POOL_SHARE, POOL_PUSH_S, POOL_QUEUE, POOL_CPU_WORKERS = 2, 0.5, 0.5, 8, 4
POOL_RATE_PUSHES = 20
POOL_CHANNEL = "util_pool_bert"
POOL_CLI = (["metrics"], ["top", "--iterations", "1"], ["memory"], ["perf"],
            ["doctor", "--json"])


class BertScorer:
    """One half-card actor of ``util_pool_bert_accounting``: BERT-base bf16
    from ``serve_bert``'s directory checkpoint through ``TorchPredictor``,
    warmed up on one batch.  Each batch it scores is published on
    ``POOL_CHANNEL`` with its run's tag, this actor's pid and its own
    count in that run, and ends
    with ``util/perf.py``'s device-memory gauges set from the allocator,
    as a serving process sets them."""

    def __init__(self, checkpoint):
        from ray_tpu_torch.air import Checkpoint
        from ray_tpu_torch.models import bert
        from ray_tpu_torch.train import TorchPredictor

        self.cfg = bert.BertConfig.base()
        self.pred = TorchPredictor.from_checkpoint(
            Checkpoint.from_directory(checkpoint),
            lambda p, toks: bert.apply(p, toks, self.cfg), device="cuda")
        self.n = {}
        self._score(np.ones((BERT_BATCH, BERT_SEQ), np.int64))
        torch.cuda.synchronize()

    def _score(self, toks):
        from ray_tpu_torch.models import bert

        bert.check_tokens(toks, self.cfg)
        return self.pred.predict(toks).argmax(-1)

    def ready(self):
        return os.environ["RAY_TPU_TORCH_WORKER_ID"], os.getpid()

    def score(self, toks, tag="map"):
        from ray_tpu_torch.util import perf, pubsub

        labels = self._score(toks)
        n = self.n.get(tag, 0)
        pubsub.publish(POOL_CHANNEL, (tag, os.getpid(), n))
        self.n[tag] = n + 1
        perf.publish_device_memory()
        return labels

    def drain(self, q, n):
        """Score ``n`` (index, batch) items from ``q`` in arrival order."""
        out = []
        for _ in range(n):
            i, toks = q.get(timeout=120)
            out.append((i, self.score(toks, "queue")))
        return out

    def allocated(self):
        return int(torch.cuda.memory_stats()["allocated_bytes.all.current"])

    def push_ms(self, n=200):
        """The median ms of what one metrics push costs this process
        before its socket write: the registry's snapshot and the frame's
        pickle."""
        import pickle

        from ray_tpu_torch.util.metrics import registry

        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            pickle.dumps({"type": "metrics_report", "origin": "", "metrics": registry().snapshot()})
            times.append(time.perf_counter() - t0)
        return sorted(times)[n // 2] * 1e3


def _batch_stats(toks):
    """A batch's non-pad count and an id checksum (the Pool's work)."""
    ids = np.asarray(toks, np.int64)
    return int((ids != 0).sum()), int((ids * (np.arange(ids.size) % 7 + 1).reshape(ids.shape)).sum())


def _pool_producer(q, refs):
    """Put the batches into the Queue in order; the seconds spent blocked
    on ``Full`` (a ``put_nowait`` that found it full, then the blocking
    ``put``'s wait)."""
    import ray_tpu_torch
    from ray_tpu_torch.util.queue import Full

    blocked = 0.0
    for i, ref in enumerate(refs):
        item = (i, ray_tpu_torch.get(ref, timeout=120))
        try:
            q.put_nowait(item)
        except Full:
            t0 = time.perf_counter()
            q.put(item, timeout=120)
            blocked += time.perf_counter() - t0
    return blocked


def _pool_map(rt, checkpoint, refs):
    """Two ``BertScorer`` actors at ``POOL_SHARE`` of the card, ready, then
    ``ActorPool.map`` over ``refs``: the actors, their (worker id, pid),
    the seconds to ready, the labels in order, the map's wall, and the
    flash launches the actors made in the map (their counts set to 0 just
    before it)."""
    from ray_tpu_torch.util import ActorPool

    t0 = time.perf_counter()
    actors = [rt.remote(num_gpus=POOL_SHARE)(BertScorer).remote(checkpoint)
              for _ in range(POOL_ACTORS)]
    ids = rt.get([a.ready.remote() for a in actors], timeout=300)
    start_s = time.perf_counter() - t0
    actor_launches(rt, actors, reset=True)
    t0 = time.perf_counter()
    labels = list(ActorPool(actors).map(lambda a, r: a.score.remote(r), refs))
    wall = time.perf_counter() - t0
    return actors, ids, start_s, np.concatenate(labels), wall, actor_launches(rt, actors)


def _pool_rate(rt, actors, refs, maps, want):
    """``maps`` more ``ActorPool.map`` calls over ``refs``, each held to
    ``want``: the sequences per second over all of them, and their flash
    launches (the counts set to 0 just before)."""
    from ray_tpu_torch.util import ActorPool

    actor_launches(rt, actors, reset=True)
    pool = ActorPool(actors)
    t0 = time.perf_counter()
    for _ in range(maps):
        labels = np.concatenate(list(pool.map(lambda a, r: a.score.remote(r, "rate"), refs)))
        check(bool((labels == want).all()),
              f"util_pool_bert_accounting: {int((labels != want).sum())} labels of a rate map differ")
    wall = time.perf_counter() - t0
    return maps * BERT_REQUESTS / wall, actor_launches(rt, actors)


def _wrap_folds(node):
    """Time the head's fold of every ``metrics_report`` frame (merge into
    the registry, the TSDB ingest, the top cache) on its connection
    threads, and keep the pickled size of each frame a worker pushed."""
    import pickle

    folds, sizes, orig = [], {}, node._handle_message

    def handle(conn, worker, msg):
        if msg.get("type") != "metrics_report":
            return orig(conn, worker, msg)
        t0 = time.perf_counter()
        try:
            return orig(conn, worker, msg)
        finally:
            folds.append(time.perf_counter() - t0)
            sizes[msg["origin"]] = len(pickle.dumps(msg))

    node._handle_message = handle
    return folds, sizes


def _gil_lateness(state, wids):
    """Each origin's ``ray_tpu_gil_lateness_frac`` in the head's TSDB: its
    role (a scorer in ``wids``, the head, or another worker), what it
    runs (its actor's class, else the names and counts of the tasks its
    pid ran, else "idle"), its CPU share in ``top``, its highest point and
    its last four, which the doctor's ``gil_saturation`` reads."""
    import collections

    pids = {w["worker_id"]: w.get("pid") for w in state.list_workers(limit=100000)}
    classes = {a["worker_id"]: a["class_name"] for a in state.list_actors(limit=100000)
               if a.get("worker_id")}
    ran = collections.defaultdict(collections.Counter)
    for t in state.list_tasks(limit=100000):
        if t.get("worker_pid") is not None:
            ran[t["worker_pid"]][t["name"]] += 1
    cpu = {w["worker_id"]: w.get("cpu_pct") for w in state.top_snapshot()["workers"]}
    out = {}
    for s in state.query_metric("ray_tpu_gil_lateness_frac", window_s=600)["series"]:
        o, pts = s["tags"].get("origin"), [v for _, v in s["points"]]
        if pts:
            runs = classes.get(o) or dict(ran.get(pids.get(o), {})) or "idle"
            out[o] = {"role": "scorer" if o in wids else "head" if o == "head" else "other",
                      "runs": runs, "pid": pids.get(o), "cpu_pct": cpu.get(o),
                      "max": max(pts), "last4": pts[-4:], "points": len(pts)}
    return out


def _lock_rows(n=5):
    """This process's (the head's) named locks with the most estimated
    wait: ``lock_stats``' rows, the wait and hold scaled from the armed
    windows, their largest single wait and hold whole."""
    from ray_tpu_torch._private import locks

    rows = sorted(locks.lock_stats().items(), key=lambda kv: -kv[1]["wait_s"])[:n]
    return {k: {f: round(v, 6) for f, v in r.items()} for k, r in rows}


def phase_util_pool_bert_accounting(served, predict_rates):
    """The util libraries and the resource-accounting plane on the card
    (see the module doc).  Returns the flash launches of every map and
    the queue's drain."""
    import math
    import subprocess as sp

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import events as events_mod
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.util import doctor, pubsub
    from ray_tpu_torch.util.multiprocessing import Pool
    from ray_tpu_torch.util.queue import Queue

    phase, card = "util_pool_bert_accounting", nvidia_smi()
    want_labels = served["labels"]
    requests = np.random.default_rng(0).integers(1, BERT_ID_HIGH, (BERT_REQUESTS, BERT_SEQ))
    batches = [requests[i:i + BERT_BATCH] for i in range(0, BERT_REQUESTS, BERT_BATCH)]
    from ray_tpu_torch.models import bert

    bert_layers = bert.BertConfig.base().n_layers
    want_flash = bert_layers * len(batches)
    os.environ["RAY_TPU_TORCH_METRICS_PUSH_S"] = str(POOL_PUSH_S)
    rt.init(num_cpus=4)
    node = global_worker.node
    try:
        folds, push_bytes = _wrap_folds(node)
        got = []
        pubsub.subscribe(POOL_CHANNEL, got.append)
        refs = [rt.put(b) for b in batches]

        # 1. ActorPool
        actors, ids, start_s, labels, wall, launches = _pool_map(rt, served["checkpoint"], refs)
        check(labels.shape == want_labels.shape and bool((labels == want_labels).all()),
              f"{phase}: {int((labels != want_labels).sum())} pool labels differ from serve_bert's")
        check_tensor_cores(phase, launches, want_flash)
        total = dict(launches)
        pool_row = {"actors": POOL_ACTORS, "num_gpus": POOL_SHARE, "start_s": start_s,
                    "wall_s": wall, "sequences_per_s": BERT_REQUESTS / wall,
                    "flash_launches": launches.get(attn.KERNEL, 0)}

        # 2. Queue: a producer task and one half-card actor draining it
        q = Queue(maxsize=POOL_QUEUE)
        actor_launches(rt, actors[:1], reset=True)
        t0 = time.perf_counter()
        producer = rt.remote(num_cpus=1)(_pool_producer).remote(q, refs)
        drained = actors[0].drain.remote(q, len(batches))
        items, blocked = rt.get([drained, producer], timeout=300)
        q_wall = time.perf_counter() - t0
        q_launches = actor_launches(rt, actors[:1])
        check([i for i, _ in items] == list(range(len(batches))),
              f"{phase}: the queue delivered {[i for i, _ in items]}")
        q_labels = np.concatenate([lab for _, lab in items])
        check(bool((q_labels == want_labels).all()),
              f"{phase}: {int((q_labels != want_labels).sum())} queue labels differ")
        check_tensor_cores(f"{phase} (queue)", q_launches, want_flash)
        for k, n in q_launches.items():
            total[k] = total.get(k, 0) + n

        # 3. multiprocessing Pool of CPU workers
        want_stats = [_batch_stats(b) for b in batches]
        mp = Pool(POOL_CPU_WORKERS)
        t0 = time.perf_counter()
        stats = mp.map(_batch_stats, batches)
        mp_wall = time.perf_counter() - t0
        ordered = list(mp.imap(_batch_stats, batches))
        check(stats == ordered == want_stats, f"{phase}: Pool stats differ from the driver's")
        mp.close()
        mp.join()

        # 4. pubsub: one message per batch scored, in each actor's order
        deadline = time.monotonic() + 30
        while len(got) < 2 * len(batches) and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(2 * POOL_PUSH_S)  # nothing more arrives
        per_actor = {}
        for tag, pid, n in got:
            per_actor.setdefault((tag, pid), []).append(n)
        counts = {f"{tag}:{pid}": len(ns) for (tag, pid), ns in per_actor.items()}
        for tag in ("map", "queue"):
            n_tag = sum(len(ns) for (t, _), ns in per_actor.items() if t == tag)
            check(n_tag == len(batches), f"{phase}: pubsub got {n_tag} '{tag}' messages, "
                                         f"want {len(batches)}: {counts}")
        check(all(ns == list(range(len(ns))) for ns in per_actor.values()),
              f"{phase}: pubsub messages out of an actor's order: {per_actor}")

        # 5. accounting, read while the actors are idle
        time.sleep(2 * POOL_PUSH_S)
        allocated = rt.get([a.allocated.remote() for a in actors], timeout=60)
        wids = [w for w, _ in ids]
        q_hbm = state.query_metric("ray_tpu_hbm_bytes_in_use", window_s=600)
        series = {}
        for row in q_hbm["series"]:
            if row["tags"].get("kind") == "hbm" and row["points"]:
                series.setdefault(row["tags"]["origin"], []).append(row["points"][-1][1])
        check(all(len(series.get(w, [])) == 1 for w in wids),
              f"{phase}: card-memory series by worker {series}, want one per actor {wids}")
        check([series[w][0] for w in wids] == [float(b) for b in allocated],
              f"{phase}: pushed card memory {[series[w][0] for w in wids]} != the actors' "
              f"allocator readings {allocated}")
        def top_misses():
            """Each actor's fields that top lacks: its sampled RSS or CPU,
            its worker row, or its card row."""
            top = state.top_snapshot()
            rows = {w["worker_id"]: w for w in top["workers"]}
            hbm_rows = {r["tags"].get("origin") for r in top["hbm"]
                        if r["tags"].get("kind") == "hbm"}
            misses = {}
            for w in wids:
                lack = [f for f in ("rss_mb", "cpu_pct") if rows.get(w, {}).get(f) is None]
                lack += [] if w in rows else ["worker_row"]
                lack += [] if w in hbm_rows else ["card_row"]
                if lack:
                    misses[w] = lack
            return misses

        # an origin whose frame reached the head late is expired from the
        # merged registry (and its card row from top) until its next push
        top_polls, deadline = 1, time.monotonic() + 10 * POOL_PUSH_S
        first_misses = misses = top_misses()
        while misses and time.monotonic() < deadline:
            time.sleep(POOL_PUSH_S / 2)
            top_polls += 1
            misses = top_misses()
        expiries = {w: sum(1 for e in events_mod.local_events()
                           if e["message"] == "metrics origin expired" and e.get("entity_id") == w)
                    for w in wids}
        check(not misses, f"{phase}: top lacks {misses} after {top_polls} reads (first read "
                          f"{first_misses}; the actors' origin expiries {expiries})")
        audit = state.memory_summary(limit=0)
        batch_bytes = sum(b.nbytes for b in batches)
        driver = sum(o["bytes"] for o in audit["by_owner"] if o["owner_kind"] == "driver")
        check(driver >= batch_bytes, f"{phase}: the driver owns {driver} bytes, want at least "
                                     f"the batches' {batch_bytes}")
        event_rules = {r.__name__[len("_rule_"):] for r in doctor.RULES}

        def excused(f):
            """``gil_saturation`` on a scorer: its own lateness while it
            enqueued BERT's kernels from Python (``gil_lateness_by_origin``
            prints it), the one finding a healthy pool shows."""
            return (f["rule"] == "gil_saturation"
                    and f["evidence"][0]["tags"].get("origin") in wids)
        # the doctor and the CLI read the head first: the diagnostics'
        # table reads (``_gil_lateness``) come after them, or in a failure's
        # message, so they add no wait to the locks the doctor judges
        findings = state.doctor_report()
        trends = [f for f in findings if f["rule"] not in event_rules and not excused(f)]
        check(not trends, f"{phase}: the doctor reports trend findings {trends}; GIL "
                          f"lateness by origin {_gil_lateness(state, wids) if trends else None}; "
                          f"head locks {_lock_rows()}")
        host, port = node.tcp_address
        env = {**os.environ, "RAY_TPU_TORCH_ADDRESS": f"tcp://{host}:{port}",
               "RAY_TPU_TORCH_AUTHKEY": node.authkey.hex()}
        t0 = time.perf_counter()
        procs = [sp.Popen([sys.executable, "-m", "ray_tpu_torch", *argv], env=env, text=True,
                          stdout=sp.PIPE, stderr=sp.PIPE) for argv in POOL_CLI]
        outs = [p.communicate(timeout=120) for p in procs]
        cli_s = time.perf_counter() - t0
        # `doctor` exits 1 on any finding: here only a scorer's GIL lateness
        bad = [(argv, p.returncode, out[-1500:], err[-800:])
               for argv, p, (out, err) in zip(POOL_CLI, procs, outs) if p.returncode != 0
               and not (argv[0] == "doctor" and p.returncode == 1
                        and all(excused(f) for f in json.loads(out)))]
        check(not bad, f"{phase}: CLI commands failed: {bad}; GIL lateness by origin "
                       f"{_gil_lateness(state, wids) if bad else None}")
        scorer_gil = _gil_lateness(state, wids)
        tsdb_stats = node.tsdb.stats()
        fold_ms = sorted(folds)[len(folds) // 2] * 1e3 if folds else None
        worker_push_bytes = {w: push_bytes.get(w) for w in wids}
        push_ms = dict(zip(wids, rt.get([a.push_ms.remote() for a in actors], timeout=60)))
        pubsub.unsubscribe(POOL_CHANNEL)

        # 6. the push's cost: the pool's rate over maps that span
        # POOL_RATE_PUSHES pushes here, then over as many at the 5 s default
        rate_maps = math.ceil(POOL_RATE_PUSHES * POOL_PUSH_S / wall)
        rate, rate_launches = _pool_rate(rt, actors, refs, rate_maps, want_labels)
        check_tensor_cores(f"{phase} (rate maps)", rate_launches, want_flash * rate_maps)
        for a in actors:
            rt.kill(a)
        q.shutdown()
        mp.terminate()
    finally:
        rt.shutdown()
        os.environ.pop("RAY_TPU_TORCH_METRICS_PUSH_S", None)

    rt.init(num_cpus=4)
    try:
        refs = [rt.put(b) for b in batches]
        actors, _, start5, labels5, _, launches5 = _pool_map(rt, served["checkpoint"], refs)
        check(bool((labels5 == want_labels).all()), f"{phase}: labels at the 5 s push differ")
        check_tensor_cores(f"{phase} (5 s push)", launches5, want_flash)
        rate5, rate5_launches = _pool_rate(rt, actors, refs, rate_maps, want_labels)
        check_tensor_cores(f"{phase} (rate maps, 5 s push)", rate5_launches, want_flash * rate_maps)
    finally:
        rt.shutdown()
    for launched in (rate_launches, launches5, rate5_launches):
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
    emit(phase, card=card, model="bert-base bf16, serve_bert's directory checkpoint",
         batches=len(batches), batch=BERT_BATCH, seq_len=BERT_SEQ, push_s=POOL_PUSH_S,
         actor_pool=pool_row,
         rate_maps=rate_maps, rate_pushes_at_0_5s=POOL_RATE_PUSHES,
         actor_pool_sequences_per_s_over_rate_maps={"push_0.5s": rate, "push_5s": rate5},
         actor_pool_start_s_at_5s_push=start5,
         batch_predict_bert_sequences_per_s=predict_rates,
         serve_bert_in_process_sequences_per_s=served["sequences_per_s"],
         queue={"maxsize": POOL_QUEUE, "wall_s": q_wall,
                "batches_per_s": len(batches) / q_wall, "producer_blocked_on_full_s": blocked,
                "flash_launches": q_launches.get(attn.KERNEL, 0)},
         mp_pool={"workers": POOL_CPU_WORKERS, "map_s": mp_wall},
         pubsub_messages=len(got), pubsub_per_actor=counts,
         card_memory_bytes=dict(zip(wids, allocated)), tsdb=tsdb_stats,
         tsdb_series=tsdb_stats["num_series"], worker_push_bytes=worker_push_bytes,
         fold_ms_median=fold_ms, folds=len(folds), worker_push_ms_median=push_ms,
         driver_owned_bytes=driver, batch_bytes=batch_bytes,
         doctor_findings=[(f["rule"], f["summary"]) for f in findings],
         gil_lateness_by_origin=scorer_gil, head_locks=_lock_rows(), top_reads=top_polls,
         top_first_read_misses=first_misses, origin_expiries=expiries, cli_s=cli_s,
         flash_launches_per_batch=bert_layers)
    return total


# BASELINE config 5 behind HTTP (bench.py run_serve_bench): the replica's
# @serve.batch settings, the warm-up (threads x requests), the load
# (keep-alive clients x requests) and the light load (1 client)
HTTP_BATCH = dict(max_batch_size=BERT_BATCH, batch_wait_timeout_s=0.005, max_concurrent_batches=8)
HTTP_WARMUP, HTTP_CLIENTS, HTTP_PER_CLIENT, HTTP_LIGHT = (16, 3), 64, 12, 15
# serve_llm_deployment: the f32 gate's prompts (of serve_gpt2's 32) and
# the HTTP token streams after the handle's requests
LLM_F32_PROMPTS, LLM_HTTP_STREAMS = 8, 8
# prefill_decode_graph: GPT-2 125M bf16, one prompt bucket, 32 new tokens,
# 16 prompts, each stage on half of card 0
GRAPH_BUCKET, GRAPH_NEW_TOKENS, GRAPH_PROMPTS, GRAPH_GPUS = 128, 32, 16, 0.5


def _launch_counts(instance, reset):
    """Run in an actor's process (the compiled-graph control lane): that
    process's kernel launch counts, zeroed afterwards when ``reset``."""
    from ray_tpu_torch.ops import _build

    counts = dict(_build.launches)
    if reset:
        _build.reset_launches()
    return counts


def _card_grant(instance):
    import os

    import ray_tpu_torch

    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            ray_tpu_torch.get_runtime_context().get_gpu_ids())


def actor_launches(rt, actors, reset=False) -> dict:
    """The launch counts of the processes of ``actors``, summed."""
    total = {}
    for counts in rt.get([a._submit_compiled_task(_launch_counts, (reset,), name="launches")
                          for a in actors], timeout=120):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def replica_actors(rt, rt_serve, name):
    info = rt.get(rt_serve.api._get_client().controller.get_routing_info.remote(name),
                  timeout=60)
    return [h for _, h in info["replicas"]]


def check_tensor_cores(phase, launches, want=None):
    flash, tc = launches.get(attn.KERNEL, 0), launches.get(attn.FWD_TC, 0)
    check(flash > 0, f"{phase}: no flash_fwd launch on the main path")
    check(tc == flash, f"{phase}: {tc} of {flash} flash_fwd launches on the tensor cores")
    if want is not None:
        check(flash == want, f"{phase}: {flash} flash_fwd launches, want {want}")


def _http_post(conn, path, payload):
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    check(resp.status == 200, f"HTTP {path}: {resp.status} {data[:200]!r}")
    return time.perf_counter() - t0, data


def phase_serve_bert_http(rt, rt_serve):
    """BASELINE config 5 in the shape of ``bench.py`` ``run_serve_bench``:
    BERT-base bf16 (``serve_bert``'s weights and checkpoint) in one
    ``num_gpus=1`` replica with ``@serve.batch(max_batch_size=16,
    batch_wait_timeout_s=0.005, max_concurrent_batches=8)``, padded to
    16 x 128, behind the asyncio proxy.  Returns the replica's launches
    over the load."""
    import http.client
    import tempfile

    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import bert
    from ray_tpu_torch.train import TorchPredictor

    cfg = bert.BertConfig.base()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    served = dict(params, blocks={k: v.to(cfg.dtype) for k, v in params["blocks"].items()})
    del params
    tmp = tempfile.mkdtemp(prefix="serve_bert_http_")
    path = Checkpoint.from_dict({"params": served}).to_directory(os.path.join(tmp, "bert"))
    del served

    @rt_serve.deployment(ray_actor_options={"num_gpus": 1, "max_concurrency": 256},
                         max_concurrent_queries=256)
    class Bert:
        def __init__(self, ckpt_path):
            # the grant is this process's CUDA_VISIBLE_DEVICES by now
            self.cfg = bert.BertConfig.base()
            self.pred = TorchPredictor.from_checkpoint(
                Checkpoint.from_directory(ckpt_path),
                lambda p, toks: bert.apply(p, toks, self.cfg), device="cuda")
            self.batch_s = []  # each batch's wall in the replica

        def _batch(self, toks):
            n = len(toks)
            if n < BERT_BATCH:  # one static batch shape for every arrival pattern
                toks = np.concatenate([toks, np.zeros((BERT_BATCH - n, toks.shape[1]),
                                                      toks.dtype)])
            bert.check_tokens(toks, self.cfg)
            # predict runs under inference_mode (grad mode is per thread);
            # its numpy result is the batch's one sync
            return self.pred.predict(toks)[:n].argmax(-1)

        @rt_serve.batch(**HTTP_BATCH)
        def __call__(self, requests):
            t0 = time.perf_counter()
            labels = self._batch(np.stack([r.json()["tokens"] for r in requests]))
            self.batch_s.append(time.perf_counter() - t0)  # list.append is atomic
            return [{"label": int(l)} for l in labels]

        def batch_walls(self):
            return list(self.batch_s)

        def profile_batch(self, toks):
            """One padded batch under torch.profiler: device ms, kernels."""
            toks = np.asarray(toks)
            self._batch(toks)
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=acts) as prof:
                self._batch(toks)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
            return {"device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
                    "kernels": len(dev), "profiled_wall_ms": wall_ms,
                    "flash_ms": sum(e.time_range.elapsed_us() for e in dev
                                    if "flash_fwd_kernel" in e.name) / 1e3}

    t0 = time.perf_counter()
    handle = rt_serve.run(Bert.bind(path), host="127.0.0.1", port=0, timeout_s=600)
    deploy_s = time.perf_counter() - t0
    host, port = rt_serve.get_http_address()
    (replica,) = replica_actors(rt, rt_serve, "Bert")
    grant = rt.get(replica._submit_compiled_task(_card_grant, (), name="grant"), timeout=60)
    check(grant == ("0", [0]), f"serve_bert_http: replica grant {grant}")
    rng = np.random.default_rng(0)
    body = {"tokens": rng.integers(1, BERT_ID_HIGH, BERT_SEQ).tolist()}

    def clients(n_threads, per_thread, lats=None, path="/Bert"):
        def loop():
            conn = http.client.HTTPConnection(host, port, timeout=600)
            mine = [_http_post(conn, path, body)[0] for _ in range(per_thread)]
            conn.close()
            if lats is not None:
                lats.extend(mine)  # list.extend is atomic

        threads = [threading.Thread(target=loop) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # warm CONCURRENTLY: every batch size up to 16 meets the first calls of
    # its padded shape here, not inside the measured window
    clients(*HTTP_WARMUP)
    actor_launches(rt, [replica], reset=True)
    batches0 = len(rt.get(handle.batch_walls.remote(), timeout=60))
    lats = []
    t0 = time.perf_counter()
    clients(HTTP_CLIENTS, HTTP_PER_CLIENT, lats)
    wall = time.perf_counter() - t0
    launches = actor_launches(rt, [replica])
    batch_s = rt.get(handle.batch_walls.remote(), timeout=60)[batches0:]
    batches = len(batch_s)
    n = len(lats)
    check(n == HTTP_CLIENTS * HTTP_PER_CLIENT, f"serve_bert_http: {n} replies")
    check_tensor_cores("serve_bert_http", launches, cfg.n_layers * batches)
    conn = http.client.HTTPConnection(host, port, timeout=600)
    light = [_http_post(conn, "/Bert", body)[0] for _ in range(HTTP_LIGHT)]
    conn.close()
    # the gate: one fixed set of 16 sequences, sent at once over HTTP,
    # against an in-process TorchPredictor from the same checkpoint
    gate = np.random.default_rng(1).integers(1, BERT_ID_HIGH, (BERT_BATCH, BERT_SEQ))
    got = [None] * BERT_BATCH

    def one(i):
        c = http.client.HTTPConnection(host, port, timeout=600)
        got[i] = json.loads(_http_post(c, "/Bert", {"tokens": gate[i].tolist()})[1])["label"]
        c.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(BERT_BATCH)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pred = TorchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                          lambda p, toks: bert.apply(p, toks, cfg), device="cuda")
    want = pred.predict(gate).argmax(-1).tolist()
    del pred
    check(got == want, f"serve_bert_http: labels over HTTP {got}, in-process {want}")
    prof = rt.get(handle.profile_batch.remote(gate.tolist()), timeout=120)
    stats = rt.get(rt_serve.api._get_client().proxy.ingress_stats.remote(), timeout=60)
    rt_serve.delete("Bert")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)

    # the serving plane alone: the same load against a replica that
    # batches the same way and runs no model (what the proxy, router and
    # actor calls allow)
    @rt_serve.deployment(ray_actor_options={"max_concurrency": 256},
                         max_concurrent_queries=256)
    class Echo:
        @rt_serve.batch(**HTTP_BATCH)
        def __call__(self, requests):
            return [{"label": len(r.json()["tokens"])} for r in requests]

    rt_serve.run(Echo.bind(), host="127.0.0.1", port=0, timeout_s=600)
    clients(*HTTP_WARMUP, path="/Echo")
    plane_lats = []
    t0 = time.perf_counter()
    clients(HTTP_CLIENTS, HTTP_PER_CLIENT, plane_lats, path="/Echo")
    plane_wall = time.perf_counter() - t0
    rt_serve.delete("Echo")
    check(len(plane_lats) == n, f"serve_bert_http: {len(plane_lats)} replies from Echo")
    lats.sort()
    emit("serve_bert_http", model="bert-base bf16 (blocks bf16; embeddings, pooler, classifier "
         "f32), one num_gpus=1 replica", batch=HTTP_BATCH, seq_len=BERT_SEQ,
         ingress_mode=stats["mode"], deploy_s=deploy_s, clients=HTTP_CLIENTS,
         requests_per_client=HTTP_PER_CLIENT, requests=n, wall_s=wall, requests_per_s=n / wall,
         req_p50_ms=pct(lats, 0.5) * 1e3, req_p99_ms=pct(lats, 0.99) * 1e3,
         req_max_ms=lats[-1] * 1e3, light_load_p50_ms=pct(light, 0.5) * 1e3,
         batches=batches, mean_batch_size=n / batches,
         replica_batch_wall_p50_ms=pct(batch_s, 0.5) * 1e3,
         replica_batch_wall_sum_s=sum(batch_s),
         serving_plane_requests_per_s=len(plane_lats) / plane_wall,
         serving_plane_req_p50_ms=pct(plane_lats, 0.5) * 1e3,
         replica_batch_device_ms=prof["device_ms"], replica_batch_kernels=prof["kernels"],
         replica_batch_flash_ms=prof["flash_ms"],
         replica_batch_profiled_wall_ms=prof["profiled_wall_ms"],
         flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0),
         labels_equal_in_process_predictor=True, ingress_stats=stats)
    return launches


def _llm_requests(rt, handle, prompts, max_new):
    """All requests through the handle at once; (outputs, per-request
    latencies, wall)."""
    t0 = time.perf_counter()
    refs = [handle.remote({"tokens": p, "max_new_tokens": max_new}) for p in prompts]
    index = {r: i for i, r in enumerate(refs)}  # ObjectRef hashes by id
    done_at, pending = {}, list(refs)
    while pending:
        ready, pending = rt.wait(pending, num_returns=1, timeout=900)
        check(bool(ready), "serve_llm_deployment: no reply within 900 s")
        for r in ready:
            done_at[index[r]] = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    outs = [o["tokens"] for o in rt.get(refs, timeout=60)]
    return outs, [done_at[i] for i in range(len(prompts))], wall


def phase_serve_llm_deployment(rt, rt_serve, gpt2_row, gpt2_outs):
    """GPT-2 125M through ``llm_deployment`` (a ``num_gpus=1`` replica).
    Gate first, in f32: ``parity``'s GPT-2 at full width with two layers,
    the first ``LLM_F32_PROMPTS`` of ``serve_gpt2``'s prompts, greedy
    streams through the replica equal to an in-process engine's of the
    same settings and seed.  Then bf16 with the ``SERVE`` settings, seed
    0: ``serve_gpt2``'s 32 requests through the handle and
    ``LLM_HTTP_STREAMS`` of them again as HTTP token streams.  Returns the
    replica's launches over those."""
    import http.client

    from ray_tpu_torch.serve.llm import GenerationEngine, llm_deployment, make_config

    prompts = [list(p) for p in gpt2_outs]
    f32 = dict(n_layers=2, dtype=torch.float32)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # the replica's default: TF32 off
    try:
        dep = llm_deployment("gpt2", "125m", name="llm_f32", config_kwargs=f32,
                             engine_kwargs=dict(SERVE, seed=0))
        handle = rt_serve.run(dep.bind(), host="127.0.0.1", port=0, timeout_s=600)
        got, _, _ = _llm_requests(rt, handle, prompts[:LLM_F32_PROMPTS], NEW_TOKENS)
        rt_serve.delete("llm_f32")
        ref = GenerationEngine(make_config("gpt2", "125m", **f32), seed=0, device="cuda",
                               **SERVE).start()
        try:
            want = [f.result(timeout=900) for f in
                    [ref.submit(p, NEW_TOKENS) for p in prompts[:LLM_F32_PROMPTS]]]
        finally:
            ref.stop()
        del ref
    finally:
        torch.set_float32_matmul_precision(precision)
    torch.cuda.empty_cache()
    check(got == want, "serve_llm_deployment: f32 streams through the replica differ from "
                       "the in-process engine's")

    cfg = make_config("gpt2", "125m")
    t0 = time.perf_counter()
    handle = rt_serve.run(llm_deployment("gpt2", "125m", engine_kwargs=dict(SERVE, seed=0)).bind(),
                          host="127.0.0.1", port=0, timeout_s=600)
    deploy_s = time.perf_counter() - t0
    (replica,) = replica_actors(rt, rt_serve, "llm")
    grant = rt.get(replica._submit_compiled_task(_card_grant, (), name="grant"), timeout=60)
    check(grant == ("0", [0]), f"serve_llm_deployment: replica grant {grant}")
    rt.get(handle.remote({"tokens": [1] * 8, "max_new_tokens": 4}), timeout=600)  # first calls
    actor_launches(rt, [replica], reset=True)
    prefills0 = rt.get(handle.stats.remote(), timeout=60)["prefills"]
    outs, lats, wall = _llm_requests(rt, handle, prompts, NEW_TOKENS)
    host, port = rt_serve.get_http_address()
    streams = [None] * LLM_HTTP_STREAMS

    def stream(i):
        conn = http.client.HTTPConnection(host, port, timeout=900)
        _, data = _http_post(conn, "/llm", {"tokens": prompts[i], "max_new_tokens": NEW_TOKENS,
                                            "stream": True})
        conn.close()
        streams[i] = [int(t) for t in data.decode().split()]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=stream, args=(i,)) for i in range(LLM_HTTP_STREAMS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stream_wall = time.perf_counter() - t0
    launches = actor_launches(rt, [replica])
    stats = rt.get(handle.stats.remote(), timeout=60)
    perf = rt.get(handle.perf_stats.remote(), timeout=60)
    rt_serve.delete("llm")
    for i, o in enumerate(outs + streams):
        check(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o),
              f"serve_llm_deployment: reply {i} holds {len(o)} tokens or one out of range")
    check_tensor_cores("serve_llm_deployment", launches,
                       cfg.n_layers * (stats["prefills"] - prefills0))
    ms = lambda s: None if s is None else s * 1e3
    same_as_engine = sum(o == gpt2_outs[tuple(p)] for o, p in zip(outs, prompts))
    emit("serve_llm_deployment", model="gpt2 125M bf16, one num_gpus=1 replica",
         engine={k: v for k, v in SERVE.items() if k != "prefill_buckets"},
         prefill_bucket=SERVE["prefill_buckets"][-1], deploy_s=deploy_s, requests=len(prompts),
         new_tokens_per_req=NEW_TOKENS, wall_s=wall,
         tokens_per_s=sum(map(len, outs)) / wall,
         in_process_serve_gpt2_tokens_per_s=gpt2_row["tokens_per_s"],
         req_p50_ms=pct(lats, 0.5) * 1e3, req_p99_ms=pct(lats, 0.99) * 1e3,
         replica_ttft_p50_ms=ms(perf["ttft"]["p50_s"]), replica_ttft_p99_ms=ms(perf["ttft"]["p99_s"]),
         replica_itl_p50_ms=ms(perf["itl"]["p50_s"]), replica_itl_p99_ms=ms(perf["itl"]["p99_s"]),
         replica_itl_samples=perf["itl"]["count"],
         replica_itl_tokens_per_sample=perf["itl"]["tokens_per_sample"],
         replica_itl_back_to_back=perf["itl"]["back_to_back"],
         replica_decode_tick_baseline_ms=ms(perf["decode_tick_baseline_s"]),
         serve_gpt2_itl={k: gpt2_row[k] for k in (
             "itl_p50_ms", "itl_samples", "itl_tokens_per_sample", "itl_back_to_back",
             "decode_tick_baseline_ms")},
         http_streams=LLM_HTTP_STREAMS, http_streams_wall_s=stream_wall,
         http_streams_equal_handle_replies=sum(s == o for s, o in zip(streams, outs)),
         bf16_streams_equal_serve_gpt2=same_as_engine,
         bf16_share_equal_serve_gpt2=same_as_engine / len(outs),
         f32_gate={"model": "gpt2 125M width, 2 layers, f32", "prompts": LLM_F32_PROMPTS,
                   "streams_equal_in_process_engine": True},
         admissions=stats["prefills"] - prefills0, flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0))
    return launches


def _graph_spans(rt, gid, n_seq):
    """The stages' exec spans by (label, seq) from the head's event table
    (shipped by each stage's worker)."""
    from ray_tpu_torch._private.worker import global_worker

    deadline = time.monotonic() + 60
    while True:
        spans = {(r["message"], r["data"]["seq"]): r["span_dur"]
                 for r in global_worker.node.events.list(limit=100_000, source="compiled_dag")
                 if (r.get("entity_id") or "").startswith(gid)
                 and r["message"].split(":")[0] in ("prefill", "decode")}
        if len(spans) >= 2 * n_seq or time.monotonic() > deadline:
            return spans
        time.sleep(0.25)


def _spill_hop_ms(payload: bytes, slot_bytes: int, reps: int = 10) -> float:
    """One put + get of ``payload`` through a shm ring of ``slot_bytes``
    slots in this process (the overflow spill when it is larger)."""
    from ray_tpu_torch._private.shm import session_shm_name
    from ray_tpu_torch.dag.channel import ShmChannel

    name = session_shm_name(f"spillprobe{os.getpid()}")
    w = ShmChannel.create(name, 2, slot_bytes)
    r = ShmChannel.attach(name)
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            w.put(payload)
            r.get(timeout=60)
        return (time.perf_counter() - t0) / reps * 1e3
    finally:
        r.close()
        w.close(unlink=True)


def phase_prefill_decode_graph(rt):
    """``prefill_decode_graph``: GPT-2 125M bf16, ``prefill_bucket`` 128,
    32 new tokens, both stages at ``num_gpus=0.5`` on card 0.  16 prompts
    one at a time (the per-request split), then the same 16 pipelined.
    Gate: each stream equals the in-process ``prefill`` + greedy
    ``decode_chunk`` on ``_default_init(cfg, 0)`` cast as the stages cast
    it.  Returns both stages' launches over the 32 executions."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.serve.llm import (_cache_to_host, _cast_params, _default_init,
                                         make_config, prefill_decode_graph)

    cfg = make_config("gpt2", "125m")
    t0 = time.perf_counter()
    g = prefill_decode_graph("gpt2", "125m", max_new_tokens=GRAPH_NEW_TOKENS,
                             prefill_bucket=GRAPH_BUCKET, num_gpus=GRAPH_GPUS, seed=0)
    compile_s = time.perf_counter() - t0
    try:
        grants = rt.get([a._submit_compiled_task(_card_grant, (), name="grant")
                         for a in g.actors], timeout=60)
        check(grants == [("0", [0])] * 2, f"prefill_decode_graph: stage grants {grants}")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, min(50000, cfg.vocab_size), rng.integers(16, 100)).tolist()
                   for _ in range(GRAPH_PROMPTS)]
        g.execute(prompts[0]).get(timeout=600)  # first calls of every shape
        actor_launches(rt, g.actors, reset=True)
        seq0 = g._seq
        outs, walls = [], []
        for p in prompts:
            t1 = time.perf_counter()
            outs.append(g.execute(p).get(timeout=600))
            walls.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        piped = rt.get([g.execute(p) for p in prompts], timeout=600)
        piped_wall = time.perf_counter() - t1
        launches = actor_launches(rt, g.actors)
        spans = _graph_spans(rt, g._gid, seq0 + 2 * GRAPH_PROMPTS)
        slot_bytes = g._slot_bytes
    finally:
        g.teardown()
    check(piped == outs, "prefill_decode_graph: pipelined streams differ from one-at-a-time")
    check_tensor_cores("prefill_decode_graph", launches, 2 * GRAPH_PROMPTS * cfg.n_layers)
    # the in-process reference: the same weights, shapes and steps
    params = _cast_params(_default_init(cfg, 0, torch.device("cuda")), cfg.dtype,
                          torch.device("cuda"))
    want, payload_bytes = [], None
    with torch.inference_mode():
        for p in prompts:
            toks = torch.zeros(1, GRAPH_BUCKET, dtype=torch.long, device="cuda")
            toks[0, :len(p)] = torch.tensor(p)
            cache = gen.init_cache(cfg, 1, GRAPH_BUCKET + GRAPH_NEW_TOKENS + 1, "cuda")
            last, cache = gen.prefill(params, cfg, toks, torch.tensor([len(p)], device="cuda"),
                                      cache, 0)
            first = int(torch.argmax(last[0]))
            if payload_bytes is None:  # what the prefill stage ships
                state = {"cache": _cache_to_host(cache), "first": first,
                         "max_new": GRAPH_NEW_TOKENS}
                payload = serialization.to_bytes(*serialization.serialize(state)[:2])
                payload_bytes = len(payload)
            emitted, _, _ = gen.decode_chunk(params, cfg, cache,
                                             torch.tensor([first], device="cuda"),
                                             torch.ones(1, dtype=torch.bool, device="cuda"),
                                             None, steps=GRAPH_NEW_TOKENS - 1, temperature=0.0)
            want.append([first] + emitted[0].tolist())
    del params
    torch.cuda.empty_cache()
    check(outs == want, "prefill_decode_graph: streams differ from in-process prefill + "
                        "decode_chunk")
    split = []
    for k, wall in enumerate(walls):
        seq = seq0 + k
        pre, dec = spans.get(("prefill:0", seq)), spans.get(("decode:1", seq))
        check(pre is not None and dec is not None,
              f"prefill_decode_graph: no exec span of execution {seq}")
        split.append({"wall_ms": wall * 1e3, "prefill_ms": pre * 1e3, "decode_ms": dec * 1e3,
                      "channel_hop_ms": (wall - pre - dec) * 1e3})
    med = lambda key: pct([r[key] for r in split], 0.5)
    cache_bytes = 2 * cfg.n_layers * cfg.n_heads * (GRAPH_BUCKET + GRAPH_NEW_TOKENS + 1) \
        * cfg.head_dim * torch.finfo(cfg.dtype).bits // 8
    emit("prefill_decode_graph", model="gpt2 125M bf16, 2 stages at num_gpus=0.5 on card 0",
         compile_s=compile_s, prompts=GRAPH_PROMPTS, prefill_bucket=GRAPH_BUCKET,
         new_tokens=GRAPH_NEW_TOKENS, per_request=split, wall_p50_ms=med("wall_ms"),
         prefill_p50_ms=med("prefill_ms"), decode_p50_ms=med("decode_ms"),
         channel_hop_p50_ms=med("channel_hop_ms"), kv_cache_bytes=cache_bytes,
         channel_payload_bytes=payload_bytes, slot_bytes=slot_bytes,
         spilled=payload_bytes > slot_bytes,
         spill_hop_ms_in_process=_spill_hop_ms(payload, slot_bytes),
         pipelined_requests_per_s=GRAPH_PROMPTS / piped_wall,
         one_at_a_time_requests_per_s=GRAPH_PROMPTS / sum(walls),
         streams_equal_in_process=True, flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0))
    return launches


# multinode_pipeline_gpt2: M microbatches of B x (T + 1) ids through two
# GPT-2 125M stages on half a card each, on a node the autoscaler adds;
# the mean NLL of each microbatch against the unsplit forward within
# PIPE_NLL_TOL (Train's parity tolerance); one 512 MiB array back across
# the nodes; the node reaped after PIPE_IDLE_S idle seconds
PIPE_MICROBATCHES, PIPE_BATCH, PIPE_STAGE_GPUS, PIPE_NLL_TOL = 8, 4, 0.5, 2e-3
PIPE_SLOT_BYTES, PIPE_XFER_BYTES, PIPE_IDLE_S = 8 << 20, 512 << 20, 5.0


def token_nll(logits, targets):
    """Each token's next-token NLL (f32 ``[B, T]``): logsumexp less the
    target's logit, as ``cross_entropy_loss`` computes before its mean."""
    logits = logits.float()
    return torch.logsumexp(logits, -1) - torch.gather(logits, -1, targets[..., None])[..., 0]


class GPT2Stage:
    """One stage of GPT-2 cut at block boundaries, an actor of
    ``MicrobatchPipeline``: blocks ``lo``..``hi - 1`` of ``cfg``, from
    ``params`` (the JAX package's layout as numpy, carried by
    ``convert.from_jax_params``) or, when None, from the seed-0 ``init``;
    f32 master weights, compute in ``cfg.dtype`` as ``gpt2.apply`` does.
    The first stage holds ``wte``/``wpe`` and takes ``[B, T + 1]`` ids; the
    last holds ``ln_f`` and the tied head and returns each token's
    next-token NLL ``[B, T]`` as a host array.  Between stages the hidden
    state and the targets cross as the tensors they are: the port's
    serialization pickles a card tensor through torch's own reducer, which
    copies its storage to the host (``torch.save``), and ``torch.load``
    puts it back on ``cuda:0`` of the reader, the card its grant names (a
    reader without one raises).  Each stage records the devices its
    inputs arrived on (``arrived``) and the host ms of each call up to its
    last kernel's end (``compute_ms``; the serialization of its result
    follows in the graph's exec span), and runs on its own device: the
    card unless ``device`` says otherwise (a stage granted no card
    raises)."""

    def __init__(self, cfg, lo, hi, params=None, device=None):
        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.convert import from_jax_params
        from ray_tpu_torch.models import gpt2

        self.dev = resolve_device(device)
        if params is None:
            params = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        else:
            params = from_jax_params(params, cfg, device="cpu")
        self.cfg, self.first, self.last = cfg, lo == 0, hi == cfg.n_layers
        self.arrived, self.compute_ms = set(), []
        keep = {"blocks": {k: v[lo:hi] for k, v in params["blocks"].items()}}
        names = (["wte", "wpe"] if self.first else []) + (
            ["wte", "lnf_w", "lnf_b"] if self.last else [])
        keep.update({k: params[k] for k in names})
        self.params = {k: ({n: t.to(self.dev) for n, t in v.items()} if k == "blocks"
                           else v.to(self.dev)) for k, v in keep.items()}

    def run(self, x):
        from ray_tpu_torch.models.transformer import apply_stack
        from ray_tpu_torch.ops.layers import layernorm

        p, dtype = self.params, self.cfg.dtype
        t0 = time.perf_counter()
        with torch.inference_mode():
            if self.first:
                ids = torch.from_numpy(np.array(x)).to(self.dev).long()
                inputs, targets = ids[:, :-1], ids[:, 1:]
                h = (p["wte"][inputs] + p["wpe"][:inputs.shape[1]]).to(dtype)
            else:
                self.arrived.update(str(t.device) for t in x)
                h, targets = (t.to(self.dev) for t in x)
            h, _ = apply_stack(h, p["blocks"], self.cfg)
            if self.last:
                h = layernorm(h, p["lnf_w"].to(dtype), p["lnf_b"].to(dtype))
                h = token_nll(h @ p["wte"].T.to(dtype), targets).cpu().numpy()
            elif self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        self.compute_ms.append((time.perf_counter() - t0) * 1e3)
        return h if self.last else (h, targets)


def _stage_record(instance):
    return sorted(instance.arrived), list(instance.compute_ms)


def _stage_place(instance):
    import os

    import ray_tpu_torch

    return (ray_tpu_torch.get_runtime_context().node_id,
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def _head_events(source, w0):
    """The head's flight-recorder events of ``source`` since ``w0``
    (wall-clock; the head runs in this process)."""
    from ray_tpu_torch._private import events

    return [r for r in events.buffer().snapshot()
            if r.get("source") == source and r["ts"] >= w0]


def _pipe_spans(gid, seqs):
    """The stages' exec spans ``{(label, seq): seconds}`` of ``seqs`` from
    the head's event table (each stage's worker ships them)."""
    from ray_tpu_torch._private.worker import global_worker

    want = {(f"run:{k}", q) for k in (0, 1) for q in seqs}
    deadline = time.monotonic() + 60
    while True:
        spans = {(r["message"], r["data"]["seq"]): r["span_dur"]
                 for r in global_worker.node.events.list(limit=100_000, source="compiled_dag")
                 if (r.get("entity_id") or "").startswith(gid) and r.get("span_dur")
                 and r["message"].startswith("run:")}
        if want <= set(spans) or time.monotonic() > deadline:
            return spans
        time.sleep(0.25)


def _wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"multinode_pipeline_gpt2: timed out on {what}")
        time.sleep(0.1)


def phase_multinode_pipeline_gpt2():
    """The multi-node runtime's path: a ``Cluster`` whose head holds no
    card, a ``StandardAutoscaler`` over a ``LocalNodeProvider`` (at most one
    node of 4 CPUs and the card, reaped after ``PIPE_IDLE_S`` idle
    seconds), and a ``MicrobatchPipeline`` of two ``GPT2Stage`` actors at
    ``num_gpus=PIPE_STAGE_GPUS``, which only the autoscaled node can place.
    Stage 0 holds ``wte``/``wpe`` and blocks 0-5, stage 1 blocks 6-11,
    ``ln_f`` and the tied head.  ``PIPE_MICROBATCHES`` microbatches of
    ``PIPE_BATCH`` x 1025 ids (``default_rng(0)``, ``[0, 50257)``).  Gates:
    each microbatch's mean NLL within ``PIPE_NLL_TOL`` of the unsplit
    ``gpt2.apply`` here; the driver's edges are streams and the stages'
    edge a shm ring, over which stage 1's inputs arrive on its card; both
    stages on the agent's node with ``CUDA_VISIBLE_DEVICES`` "0"; 12
    ``flash_fwd`` launches a microbatch, all on the tensor cores; a
    ``syncer_report`` folded at the head; the node reaped and the GPU gone
    after the teardown.  Returns the stages' launches over the timed run."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.autoscaler import (AutoscalingConfig, LocalNodeProvider, Monitor,
                                          StandardAutoscaler)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dag.compiled import DRIVER, _deser, _ser
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.pipeline import MicrobatchPipeline
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    cfg = gpt2.GPT2Config.gpt2_small()
    n_mb, n_stages = PIPE_MICROBATCHES, 2
    half = cfg.n_layers // n_stages
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, 50257, (PIPE_BATCH, cfg.max_seq_len + 1), np.int32)
           for _ in range(n_mb)]
    t0 = time.perf_counter()
    import_s = float(subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); import ray_tpu_torch._private"
         ".node_agent; print(time.perf_counter() - t)"], capture_output=True, text=True,
        check=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__))).stdout)
    cluster = Cluster(initialize_head=True, real_processes=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    init_s = time.perf_counter() - t0
    head = global_worker.node
    provider, monitor = LocalNodeProvider(head), None
    pipe = None
    try:
        check(rt.cluster_resources().get("GPU", 0) == 0, "multinode_pipeline_gpt2: the head "
              f"holds cards: {rt.cluster_resources()}")
        scaler = StandardAutoscaler(head, provider, AutoscalingConfig(
            min_workers=0, max_workers=1, idle_timeout_s=PIPE_IDLE_S,
            worker_node={"num_cpus": 4, "num_gpus": 1}))
        monitor = Monitor(scaler, interval_s=0.5).start()
        try:
            stage = rt.remote(GPT2Stage).options(num_gpus=PIPE_STAGE_GPUS)
            w0 = time.time()
            pipe = MicrobatchPipeline(
                [stage.bind(cfg, 0, half), stage.bind(cfg, half, cfg.n_layers)],
                n_microbatches=n_mb, slot_bytes=PIPE_SLOT_BYTES)
            compile_s = time.time() - w0
            nodes = provider.non_terminated_nodes()
            check(len(nodes) == 1, f"multinode_pipeline_gpt2: provider nodes {nodes}")
            agent = nodes[0]
            joined = [r["ts"] for r in _head_events("node", w0)
                      if r["message"] == "node joined" and r.get("entity_id") == agent]
            launched = [r["ts"] for r in _head_events("autoscaler", w0)
                        if r["message"].startswith("scale up")]
            lives = _actor_lives(w0)
            alive = [lives[a._actor_id.hex()].get("ALIVE") for a in pipe.actors]
            check(joined and launched and all(alive),
                  f"multinode_pipeline_gpt2: joined {joined}, launched {launched}, lives {lives}")
            places = rt.get([a._submit_compiled_task(_stage_place, (), name="place")
                             for a in pipe.actors], timeout=60)
            check(places == [(agent, "0")] * n_stages,
                  f"multinode_pipeline_gpt2: stages at {places}, want {agent} with card 0")
            edges = pipe._dag._edges
            kinds = {("driver" if e["writer"] == DRIVER else e["writer"],
                      "driver" if e["reader"] == DRIVER else e["reader"]): e["kind"] for e in edges}
            check(kinds == {("driver", 0): "stream", (0, 1): "shm", (1, "driver"): "stream"},
                  f"multinode_pipeline_gpt2: edges {kinds}")
            pipe.run(mbs[:1], timeout=600)  # the stages' first calls
            actor_launches(rt, pipe.actors, reset=True)
            seq0 = pipe._dag._seq
            t1 = time.perf_counter()
            outs = pipe.run(mbs, timeout=600)
            wall = time.perf_counter() - t1
            launches = actor_launches(rt, pipe.actors)
            arrived = [r[0] for r in rt.get([a._submit_compiled_task(_stage_record, (), name="rec")
                                             for a in pipe.actors], timeout=60)]
            check(arrived == [[], ["cuda:0"]], f"multinode_pipeline_gpt2: stage inputs arrived "
                  f"on {arrived}, want stage 1's on its card")
            # the same microbatches one at a time: each stage's span without
            # the other stage's work beside it on the card
            walls_one = []
            for mb in mbs:
                t1 = time.perf_counter()
                pipe.run([mb], timeout=600)
                walls_one.append(time.perf_counter() - t1)
            spans = _pipe_spans(pipe._dag._gid, range(seq0, seq0 + 2 * n_mb))
            # each call's compute: the warm-up's, the pipelined, one at a time
            compute = [r[1][1:] for r in rt.get([a._submit_compiled_task(_stage_record, (),
                                                                         name="rec")
                                                 for a in pipe.actors], timeout=60)]
            folded = head._syncer_versions.get(agent, 0)
            check(folded >= 1, f"multinode_pipeline_gpt2: no syncer_report of {agent} folded "
                  f"({head._syncer_versions})")

            @rt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(agent))
            def produce(n):
                return np.arange(n, dtype=np.float64)

            n = PIPE_XFER_BYTES // 8
            ref = produce.remote(n)
            rt.wait([ref], timeout=300)
            t1 = time.perf_counter()
            arr = rt.get(ref, timeout=300)
            xfer_s = time.perf_counter() - t1
            check(arr.shape == (n,) and arr[-1] == n - 1, "multinode_pipeline_gpt2: the "
                  f"array from {agent} came back as {arr.shape}, last {arr[-1]}")
            del arr, ref
        finally:
            if pipe is not None:
                pipe.teardown()
                for a in pipe.actors:
                    rt.kill(a)
        t1 = time.perf_counter()
        _wait_for(lambda: not provider.non_terminated_nodes()
                  and not rt.cluster_resources().get("GPU", 0), 120, "the idle node's reaping")
        reap_s = time.perf_counter() - t1
    finally:
        if monitor is not None:
            monitor.stop()
        provider.shutdown()
        cluster.shutdown()
    check_tensor_cores("multinode_pipeline_gpt2", launches, cfg.n_layers * n_mb)
    # the unsplit forward on the same weights and tokens, in this process
    params = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cuda")

    def forward():
        with torch.inference_mode():
            return [token_nll(gpt2.apply(params, ids[:, :-1], cfg), ids[:, 1:]).cpu().numpy()
                    for ids in (torch.from_numpy(mb).cuda().long() for mb in mbs)]

    want = forward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    in_process_s = time.perf_counter() - t1
    del params
    torch.cuda.empty_cache()
    mean_diff = [abs(float(g.mean()) - float(w.mean())) for g, w in zip(outs, want)]
    check(all(o.shape == (PIPE_BATCH, cfg.max_seq_len) and np.isfinite(o).all() for o in outs),
          "multinode_pipeline_gpt2: NLL shapes or values")
    check(max(mean_diff) <= PIPE_NLL_TOL, f"multinode_pipeline_gpt2: mean NLL differs from the "
          f"unsplit forward by {mean_diff}")
    stage_ms, stage_one_ms = [], []
    for k in range(n_stages):
        got = [spans.get((f"run:{k}", q)) for q in range(seq0, seq0 + 2 * n_mb)]
        check(all(d is not None for d in got), f"multinode_pipeline_gpt2: stage {k} spans {got}")
        stage_ms.append([d * 1e3 for d in got[:n_mb]])
        stage_one_ms.append([d * 1e3 for d in got[n_mb:]])
    stage_p50 = [pct(v, 0.5) for v in stage_ms]
    one = [{"wall_ms": w * 1e3, "stage_ms": [v[i] for v in stage_one_ms],
            "hops_ms": w * 1e3 - sum(v[i] for v in stage_one_ms)}
           for i, w in enumerate(walls_one)]
    # the hop's payload, and its serialization and deserialization here
    hidden = torch.empty(PIPE_BATCH, cfg.max_seq_len, cfg.d_model, dtype=cfg.dtype, device="cuda")
    targets = torch.empty(PIPE_BATCH, cfg.max_seq_len, dtype=torch.long, device="cuda")
    ser_ms, deser_ms = [], []
    for _ in range(5):
        t1 = time.perf_counter()
        payload = _ser((hidden, targets))
        ser_ms.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        back = _deser(payload)
        torch.cuda.synchronize()
        deser_ms.append((time.perf_counter() - t1) * 1e3)
    check(back[0].device.type == "cuda" and back[0].shape == hidden.shape,
          f"multinode_pipeline_gpt2: the hop's payload came back as {back[0].device}")
    tokens = n_mb * PIPE_BATCH * cfg.max_seq_len
    emit("multinode_pipeline_gpt2",
         model=f"gpt2 125M bf16 (f32 master weights), 2 stages of {half} blocks at "
               f"num_gpus={PIPE_STAGE_GPUS}, {n_mb} microbatches of {PIPE_BATCH} x "
               f"{cfg.max_seq_len + 1} ids", agent_node=agent, stage_places=places,
         edges={f"{w}->{r}": k for (w, r), k in kinds.items()},
         agent_import_s=import_s, head_init_s=init_s, compile_s=compile_s,
         submit_to_scale_up_s=launched[0] - w0, submit_to_agent_registered_s=joined[0] - w0,
         submit_to_stages_alive_s=max(alive) - w0,
         pipeline_wall_ms=wall * 1e3, tokens_per_s=tokens / wall,
         stage_exec_ms_by_microbatch=stage_ms, stage_exec_ms_p50=stage_p50,
         one_at_a_time=one, one_at_a_time_wall_ms_p50=pct([r["wall_ms"] for r in one], 0.5),
         one_at_a_time_stage_ms_p50=[pct(v, 0.5) for v in stage_one_ms],
         one_at_a_time_hops_ms_p50=pct([r["hops_ms"] for r in one], 0.5),
         stage_compute_ms_p50=[pct(c[:n_mb], 0.5) for c in compute],
         one_at_a_time_stage_compute_ms_p50=[pct(c[n_mb:], 0.5) for c in compute],
         serial_sum_ms=n_stages * n_mb * max(stage_p50),
         bubble_fraction_model=(n_stages - 1) / (n_mb + n_stages - 1),
         bubble_model_wall_ms=(n_mb + n_stages - 1) * max(stage_p50),
         in_process_forward_ms=in_process_s * 1e3,
         hop_hidden_bytes=hidden.numel() * hidden.element_size(),
         hop_payload_bytes=len(payload), slot_bytes=PIPE_SLOT_BYTES,
         hop_ser_ms_in_process=pct(ser_ms, 0.5), hop_deser_ms_in_process=pct(deser_ms, 0.5),
         stage_inputs_arrived_on=arrived,
         mean_nll=[float(o.mean()) for o in outs], mean_nll_diff=mean_diff,
         max_token_nll_diff=max(float(np.abs(g - w).max()) for g, w in zip(outs, want)),
         nll_tolerance=PIPE_NLL_TOL, syncer_versions_folded=folded,
         cross_node_bytes=PIPE_XFER_BYTES, cross_node_s=xfer_s,
         cross_node_gib_per_s=PIPE_XFER_BYTES / 2**30 / xfer_s, reap_s=reap_s,
         idle_timeout_s=PIPE_IDLE_S, flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0))
    return launches


# watch_pipeline_gpt2: multinode_pipeline_gpt2's two GPT-2 stages on one
# agent node added to a card-less head, watched by the observability
# stores: the continuous profiler in every process, the log store, the
# trace analysis and the watchdog at a 1 s cadence
WATCH_S, WATCH_OFF_S, WATCH_PUSH_S, WATCH_CADENCE_S = 20.0, 12.0, 0.5, 1.0
# the profiler's cost in the gated runtime: pairs of blocks with the
# head's and the stages' profilers off and on, in turn
WATCH_PAIRS, WATCH_BLOCK_S = 3, 2.5
# a request's trace spans at most this many times the request's own span
WATCH_TRACE_FACTOR = 1.5
WATCH_SLO_RSS_MB, WATCH_SLO_WINDOWS_S = 100.0, (2.0, 6.0)
WATCH_MARKER = "watch-marker"
WATCH_BUNDLE = ("incident.json", "events.json", "logs", "tsdb", "traces.json",
                "profile_collapsed.txt", "memory.json")


class WatchStage(GPT2Stage):
    """A ``GPT2Stage`` whose last stage writes one marker line to stderr a
    call (``watch-marker <n>``), as a stage's own logging would."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = 0

    def run(self, x):
        out = super().run(x)
        if self.last:
            self.calls += 1
            print(f"{WATCH_MARKER} {self.calls}", file=sys.stderr, flush=True)
        return out


def _profiler_switch(instance, on):
    """Stop or restart this process's continuous profiler; whether it has
    one."""
    from ray_tpu_torch._private import sampling_profiler

    prof = sampling_profiler.current()
    if prof is not None:
        if on:
            prof.start()
        else:
            prof.stop()
    return prof is not None


def _stage_calls(instance):
    return instance.calls


def _stage_ident(instance):
    import os

    return os.environ["RAY_TPU_TORCH_WORKER_ID"], os.getpid()


def _rss_trace(pids, stop, trace):
    """Append ``(s, [VmRSS MB of each of pids])`` to ``trace`` every 0.1 s
    until ``stop`` is set."""
    t0 = time.monotonic()
    while not stop.is_set():
        row = []
        for pid in pids:
            with open(f"/proc/{pid}/status") as f:
                row.append(next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:")) / 1024)
        trace.append((time.monotonic() - t0, row))
        stop.wait(0.1)


def _rss_settle(trace, i, within_mb):
    """Process ``i`` of an ``_rss_trace``: its RSS at the start, its growth
    to its peak, the seconds from the start until it came within
    ``within_mb`` of that peak, and its growth over the start at each
    whole second."""
    peak = max(r[i] for _, r in trace)
    by_s = {}
    for t, r in trace:
        by_s.setdefault(int(t), r[i] - trace[0][1][i])
    return {"rss_at_start_mb": trace[0][1][i], "growth_to_peak_mb": peak - trace[0][1][i],
            "s_to_within_floor_of_peak": next(t for t, r in trace if r[i] >= peak - within_mb),
            "growth_mb_by_s": list(by_s.values())}


def _watch_wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        check(time.monotonic() < deadline, f"watch_pipeline_gpt2: timed out on {what}")
        time.sleep(0.1)


def _in_process_cli(*argv):
    """``python -m ray_tpu_torch <argv>`` against this process's head:
    its exit code and standard output."""
    import contextlib
    import io

    from ray_tpu_torch.scripts import cli

    buf, code = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(list(argv))
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def _profile_counts(store, origins):
    """Per origin: its folded stacks and duty ticks in the head's profile
    store, all buckets merged."""
    out = {}
    for o in origins:
        q = store.query(1e9, origin=o)
        out[o] = (dict(q["folded"]), q["ticks"], q["busy_ticks"])
    return out


def _profile_delta(before, after):
    """What each origin's profiler shipped between two reads: class
    shares of its busy samples, the busy ticks over the ticks, and the
    top leaf frames of its ``serialize``, ``lock_wait`` and ``other``
    samples."""
    from ray_tpu_torch.util.profile_store import BUSY_CLASSES, classify_stack

    out = {}
    for o, (folded, ticks, busy_ticks) in after.items():
        f0, t0, b0 = before.get(o, ({}, 0.0, 0.0))
        classes = {c: 0 for c in BUSY_CLASSES + ("idle",)}
        leaves = {"serialize": {}, "lock_wait": {}, "other": {}}
        for stack, n in folded.items():
            n -= f0.get(stack, 0)
            if n <= 0:
                continue
            cls = classify_stack(stack)
            classes[cls] += n
            if cls in leaves:
                leaf = "|".join(stack.split("|")[-2:])
                leaves[cls][leaf] = leaves[cls].get(leaf, 0) + n
        busy = sum(n for c, n in classes.items() if c != "idle")
        out[o] = {"samples": busy + classes["idle"], "busy_samples": busy,
                  "ticks": ticks - t0, "busy_ticks": busy_ticks - b0,
                  "util": (busy_ticks - b0) / max(ticks - t0, 1e-9),
                  "class_share_of_busy": {c: n / max(busy, 1) for c, n in classes.items()
                                          if c != "idle"},
                  "top_leaves": {c: sorted(v.items(), key=lambda kv: -kv[1])[:6]
                                 for c, v in leaves.items()}}
    return out


def _watch_run(cfg, mbs, device, watch_s, gated):
    """One runtime: a ``Cluster`` whose head holds no card and one agent
    node of 4 CPUs and the card, two ``WatchStage`` actors at
    ``num_gpus=PIPE_STAGE_GPUS`` pinned to it, and a ``MicrobatchPipeline``
    of ``mbs`` run again and again for ``watch_s`` seconds.  With
    ``gated``, the stores' gates run on it too.  Returns the repetitions'
    walls, the first one's outputs, the launches over the timed
    repetitions and the measurements."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.parallel.pipeline import MicrobatchPipeline
    from ray_tpu_torch.util import incidents, tracing
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.util.doctor import RSS_GROWTH_MIN_MB
    from ray_tpu_torch.util.trace_analysis import analyze

    phase, half, row = "watch_pipeline_gpt2", cfg.n_layers // 2, {}
    t0 = time.perf_counter()
    cluster = Cluster(initialize_head=True, real_processes=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    pipe = None
    try:
        head = global_worker.node
        agent = cluster.add_node(num_cpus=4, num_gpus=1)
        row["node_up_s"] = time.perf_counter() - t0
        stage = rt.remote(WatchStage).options(
            num_gpus=PIPE_STAGE_GPUS,
            scheduling_strategy=NodeAffinitySchedulingStrategy(agent, soft=False))
        pipe = MicrobatchPipeline(
            [stage.bind(cfg, 0, half, device=device),
             stage.bind(cfg, half, cfg.n_layers, device=device)],
            n_microbatches=len(mbs), slot_bytes=PIPE_SLOT_BYTES)
        idents = rt.get([a._submit_compiled_task(_stage_ident, (), name="ident")
                         for a in pipe.actors], timeout=120)
        wids = [w for w, _ in idents]
        # the stages' RSS from their constructors' end (the start of the
        # head's warm-up, Node.WORKER_WARMUP_S) through the timed run
        rss_stop, rss = threading.Event(), []
        rss_thread = threading.Thread(target=_rss_trace, args=([p for _, p in idents],
                                                              rss_stop, rss), daemon=True)
        rss_thread.start()
        pipe.run(mbs[:1], timeout=600)  # the stages' first calls
        row["stages_ready_s"] = time.perf_counter() - t0
        ready_ts = time.time()
        time.sleep(2 * WATCH_PUSH_S)  # the warm-up's profile bursts ship
        origins = ["head", f"agent:{agent}", *wids]
        before = _profile_counts(head.profile_store, origins)
        actor_launches(rt, pipe.actors, reset=True)
        seq0 = pipe._dag._seq
        walls, outs0, t_run = [], None, time.perf_counter()
        while time.perf_counter() - t_run < watch_s:
            t1 = time.perf_counter()
            outs = pipe.run(mbs, timeout=600)
            walls.append(time.perf_counter() - t1)
            outs0 = outs if outs0 is None else outs0
        run_s = time.perf_counter() - t_run
        rss_stop.set()
        rss_thread.join()
        launches = actor_launches(rt, pipe.actors)
        # the doctor's rss_growth needs RSS_GROWTH_MIN_MB of growth: a
        # stage within that of its peak no longer reads as a leak
        row.update(reps=len(walls), run_s=run_s, rep_wall_ms=[w * 1e3 for w in walls],
                   rep_wall_ms_p50=pct([w * 1e3 for w in walls], 0.5),
                   stage_rss_after_constructor=[_rss_settle(rss, i, RSS_GROWTH_MIN_MB)
                                                for i in range(len(idents))],
                   stage_rss_trace_s=rss[-1][0])
        if not gated:
            return walls, outs0, launches, row

        # -- the profiler: every origin shipped; stage 0's serialize share
        time.sleep(2 * WATCH_PUSH_S)
        after = _profile_counts(head.profile_store, origins)
        listed = {r["origin"] for r in state.list_profiles()}
        check(set(origins) <= listed, f"{phase}: list_profiles holds {sorted(listed)}, want "
                                      f"{origins}")
        delta = _profile_delta(before, after)
        silent = [o for o in origins if delta[o]["ticks"] <= 0]
        check(not silent, f"{phase}: {silent} shipped no burst in the {run_s:.1f} s run")
        check(delta[wids[0]]["busy_samples"] > 0, f"{phase}: no busy sample of stage 0 in the "
                                                  f"run: {delta[wids[0]]}")
        n_run = len(walls) * len(mbs)
        spans = _pipe_spans(pipe._dag._gid, range(seq0, seq0 + n_run))
        records = rt.get([a._submit_compiled_task(_stage_record, (), name="rec")
                          for a in pipe.actors], timeout=60)
        stage0_span = [spans[("run:0", q)] * 1e3 for q in range(seq0, seq0 + n_run)
                       if ("run:0", q) in spans]
        stage0_compute = records[0][1][1:1 + n_run]
        duty = {}
        for s in state.query_metric("ray_tpu_profiler_duty_frac", window_s=120)["series"]:
            if s["points"]:
                duty[s["tags"].get("origin")] = s["points"][-1][1]
        ledger = state.profile_ledger(window_s=run_s, tasks=n_run)
        row.update(profile_origins=sorted(listed), profile_by_origin=delta,
                   profiler_duty_frac=duty,
                   stage0_serialize_share_of_busy=delta[wids[0]]["class_share_of_busy"][
                       "serialize"],
                   stage0_exec_span_ms_p50=pct(stage0_span, 0.5),
                   stage0_compute_ms_p50=pct(stage0_compute, 0.5),
                   stage0_save_share_of_span=1 - sum(stage0_compute) / max(sum(stage0_span),
                                                                           1e-9),
                   stage0_spans=len(stage0_span),
                   ledger_columns_us=ledger["columns"], ledger_sum_over_wall=ledger["sum_over_wall"],
                   ledger_per_microbatch_wall_us=ledger["per_task_wall_us"])

        # -- the profiler's cost: the head's and the stages' profilers off
        # and on in turn, a block of repetitions each, order swapped a pair
        def switch(on):
            had = rt.get([a._submit_compiled_task(_profiler_switch, (on,), name="prof")
                          for a in pipe.actors], timeout=60)
            check(all(had) and _profiler_switch(None, on),
                  f"{phase}: a stage or the head has no profiler to switch")
        pairs = []
        for k in range(WATCH_PAIRS):
            pair = {}
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                switch(on)
                ws, tb = [], time.perf_counter()
                while time.perf_counter() - tb < WATCH_BLOCK_S:
                    t1 = time.perf_counter()
                    pipe.run(mbs, timeout=600)
                    ws.append((time.perf_counter() - t1) * 1e3)
                pair["on" if on else "off"] = {"reps": len(ws), "rep_wall_ms_p50": pct(ws, 0.5)}
            pair["on_over_off"] = pair["on"]["rep_wall_ms_p50"] / pair["off"]["rep_wall_ms_p50"]
            pairs.append(pair)
        switch(True)
        ratios = [p["on_over_off"] for p in pairs]
        row.update(profiler_pairs=pairs, profiler_pairs_on_over_off=ratios,
                   profiler_pairs_spread=[min(ratios), max(ratios)])

        # -- the trace of one pipeline request
        t1 = time.perf_counter()
        with tracing.trace("watch_pipeline_request") as ctx:
            pipe.run(mbs[:1], timeout=600)
        request_s = time.perf_counter() - t1
        trace = _watch_wait(lambda: (lambda t: t if t and any(
            s["name"].startswith("run:1") for s in t["spans"]) else None)(
            state.get_trace(ctx["trace_id"])), 60, "the request's trace")
        a = analyze(trace)
        # analyze rounds the wall and each phase to 1 us: half a us each
        # beside the 1e-6 relative
        gap = abs(sum(a["phases"].values()) - a["wall_s"])
        check(gap <= 1e-6 * a["wall_s"] + 5e-7 * (len(a["phases"]) + 1),
              f"{phase}: the trace's phases {a['phases']} do not sum to its wall {a['wall_s']}")
        check(a["critical_path"], f"{phase}: the trace's critical path is empty")
        root = next(s for s in trace["spans"] if s["name"] == "watch_pipeline_request")
        root_s = root["end"] - root["start"]
        check(a["wall_s"] <= WATCH_TRACE_FACTOR * root_s,
              f"{phase}: the request's span lasts {root_s * 1e3:.2f} ms, its trace spans "
              f"{a['wall_s'] * 1e3:.2f} ms")
        code, rendered = _in_process_cli("trace", ctx["trace_id"])
        check(code == 0 and "critical path:" in rendered, f"{phase}: trace rendered {rendered}")
        row.update(request_ms=request_s * 1e3, request_span_ms=root_s * 1e3,
                   trace_wall_ms=a["wall_s"] * 1e3,
                   trace_phase_sum_gap_s=gap, trace_phases_ms={
            k: v * 1e3 for k, v in a["phases"].items()}, trace_spans=a["num_spans"],
            trace_critical_path=[(s["name"], s["phase"]) for s in a["critical_path"]][:12],
            trace_render=rendered.splitlines()[:30])

        # -- the watchdog: an SLO on the stages' RSS burns, opens, resolves
        top = state.top_snapshot()
        rss = {w["worker_id"]: w["rss_mb"] for w in top["workers"] if w["worker_id"] in wids}
        check(all(v is not None and v > WATCH_SLO_RSS_MB for v in rss.values()) and len(rss) == 2,
              f"{phase}: the stages' RSS {rss} is not above the SLO's {WATCH_SLO_RSS_MB} MB")
        wd = head.watchdog
        iid = incidents.incident_id("slo:stage_rss", "stage_rss")
        t1 = time.perf_counter()
        wd.add_slo("stage_rss", "ray_tpu_proc_rss_mb", WATCH_SLO_RSS_MB, op="<=", agg="avg",
                   tags={"node": agent, "entity": "worker"},
                   fast_window_s=WATCH_SLO_WINDOWS_S[0], slow_window_s=WATCH_SLO_WINDOWS_S[1],
                   severity="WARNING", description="stage RSS stays under the SLO")
        opened = _watch_wait(lambda: next((i for i in state.list_incidents()
                                           if i["id"] == iid and i["bundle_dir"]), None),
                             30, "the SLO's incident and its bundle")
        open_s = time.perf_counter() - t1
        bundle = sorted(os.listdir(opened["bundle_dir"]))
        missing = [f for f in WATCH_BUNDLE if f not in bundle]
        check(not missing and any(f.startswith("trace-") for f in bundle)
              and "ray_tpu_proc_rss_mb.json" in os.listdir(os.path.join(opened["bundle_dir"],
                                                                         "tsdb")),
              f"{phase}: the bundle holds {bundle}, lacks {missing}")
        code, out = _in_process_cli("incidents", "--json")
        check(code == 0 and iid in {r["id"] for r in json.loads(out)},
              f"{phase}: `incidents` lacks {iid}")
        code, out = _in_process_cli("incidents", "--ack", iid)
        check(code == 0 and out.startswith(f"acked {iid}"), f"{phase}: ack printed {out}")
        check(state.get_incident(iid)["state"] == "ack", f"{phase}: not acked")
        check(wd.remove_slo("stage_rss"), f"{phase}: remove_slo found no SLO")
        t1 = time.perf_counter()
        _watch_wait(lambda: state.get_incident(iid)["state"] == "resolved",
                    (wd.incidents.resolve_ticks + 3) * WATCH_CADENCE_S + 5, "the resolve")
        resolve_s = time.perf_counter() - t1
        sink = os.environ["RAY_TPU_TORCH_INCIDENT_CMD"].split(">>")[1].split(";")[0].strip()

        def sunk():
            with open(sink) as f:
                got = [json.loads(ln) for ln in f if ln.strip()]
            trs = [p["transition"] for p in got if p["incident"]["id"] == iid]
            return trs if trs[-1:] == ["resolve"] else None
        transitions = _watch_wait(sunk, 15, "the sink's resolve line")
        check(transitions == ["open", "ack", "resolve"],
              f"{phase}: the sink saw {transitions}, want open, ack, resolve")
        # a healthy pipeline opens no leak and no error burst at any point,
        # its stages' start-up included: a worker's RSS history starts at
        # its constructor's end (C12), and stage 1's stderr markers carry
        # no error marker (C13)
        unhealthy = [(i["id"], h["transition"], round(h["ts"] - ready_ts, 3))
                     for i in state.list_incidents()
                     if i["id"].startswith(("rss_growth", "log_error_burst"))
                     for h in i["history"] if h["transition"] in ("open", "reopen")]
        check(not unhealthy, f"{phase}: incidents opened (s after the stages were ready): "
                             f"{unhealthy}")
        row.update(stage_rss_mb=rss, slo_open_s=open_s, slo_resolve_s=resolve_s,
                   bundle_files=bundle, bundle_log_files=len(os.listdir(
                       os.path.join(opened["bundle_dir"], "logs"))),
                   sink_transitions=transitions, watchdog=wd.stats(),
                   other_incidents=[(i["id"], i["state"], [  # opened, s after ready
                       round(h["ts"] - ready_ts, 3) for h in i["history"]
                       if h["transition"] in ("open", "reopen")]) for i in state.list_incidents()
                                    if i["id"] != iid])

        # -- the logs: stage 1's markers, then its death tail
        calls = rt.get(pipe.actors[1]._submit_compiled_task(_stage_calls, (), name="calls"),
                       timeout=60)
        actor1 = pipe.actors[1]._actor_id.hex()

        def markers():
            code, out = _in_process_cli("logs", "--actor", actor1, "--tail", "100000")
            got = {int(ln.rsplit(" ", 1)[1]) for ln in out.splitlines()
                   if f") {WATCH_MARKER} " in ln}
            return got if code == 0 and got >= set(range(1, calls + 1)) else None
        _watch_wait(markers, 30, f"stage 1's {calls} marker lines through `logs --actor`")
        stream = f"worker-{wids[1]}"
        os.kill(idents[1][1], signal.SIGKILL)
        t1 = time.perf_counter()
        _watch_wait(lambda: any(r["stream"] == stream and r["retired"]
                                for r in state.list_logs()), 30, f"{stream} retired")
        tail = state.tail_log(stream, n=5)
        check(tail and tail[-1] == f"{WATCH_MARKER} {calls}",
              f"{phase}: stage 1's tail after its death is {tail}, want its last marker")
        row.update(markers=calls, retired_s=time.perf_counter() - t1, death_tail=tail)

        # -- wind-down: the node goes, and its card with it
        pipe.teardown()
        for a in pipe.actors:
            rt.kill(a)
        pipe = None
        cluster.remove_node(agent)
        _watch_wait(lambda: not rt.cluster_resources().get("GPU", 0), 30,
                    "no GPU left in the cluster")
        return walls, outs0, launches, row
    finally:
        if pipe is not None:
            pipe.teardown()
            for a in pipe.actors:
                rt.kill(a)
        cluster.shutdown()


def phase_watch_pipeline_gpt2(cfg=None, device=None):
    """``multinode_pipeline_gpt2``'s stages under the observability stores
    (see the module doc, 34).  Two runtimes in this call, each repeating
    the 8 microbatches for ``WATCH_S`` seconds: the profiler off, then on
    with every gate.  Returns the launches of both runs' timed
    repetitions."""
    import tempfile

    from ray_tpu_torch.models import gpt2

    cfg = cfg or gpt2.GPT2Config.gpt2_small()
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, min(50257, cfg.vocab_size), (PIPE_BATCH, cfg.max_seq_len + 1),
                        np.int32) for _ in range(PIPE_MICROBATCHES)]
    t0 = time.perf_counter()
    sink_dir = tempfile.mkdtemp(prefix="watch_sink_")
    sink = os.path.join(sink_dir, "transitions.jsonl")
    env = {"RAY_TPU_TORCH_METRICS_PUSH_S": str(WATCH_PUSH_S),
           "RAY_TPU_TORCH_WATCHDOG_S": str(WATCH_CADENCE_S),
           "RAY_TPU_TORCH_LOG_SHIP_S": "0.2",
           # stage 1's markers stay in the log store, not on this output
           "RAY_TPU_TORCH_LOG_TO_DRIVER": "0",
           "RAY_TPU_TORCH_INCIDENT_CMD": f"cat >> {sink}; echo >> {sink}"}
    saved = {k: os.environ.get(k) for k in (*env, "RAY_TPU_TORCH_CONT_PROFILE")}
    os.environ.update(env)
    try:
        os.environ["RAY_TPU_TORCH_CONT_PROFILE"] = "0"
        off_walls, _, off_launches, off_row = _watch_run(cfg, mbs, device, WATCH_OFF_S,
                                                         gated=False)
        os.environ.pop("RAY_TPU_TORCH_CONT_PROFILE")
        walls, outs, launches, row = _watch_run(cfg, mbs, device, WATCH_S, gated=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    n_mb = len(mbs)
    check_tensor_cores("watch_pipeline_gpt2", launches, cfg.n_layers * n_mb * len(walls))
    check_tensor_cores("watch_pipeline_gpt2", off_launches, cfg.n_layers * n_mb * len(off_walls))
    # the unsplit forward on the same weights and tokens, in this process
    dev = device or "cuda"
    params = gpt2.init(cfg, torch.Generator().manual_seed(0), device=dev)
    with torch.inference_mode():
        want = [token_nll(gpt2.apply(params, ids[:, :-1], cfg), ids[:, 1:]).cpu().numpy()
                for ids in (torch.from_numpy(mb).to(dev).long() for mb in mbs)]
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    mean_diff = [abs(float(g.mean()) - float(w.mean())) for g, w in zip(outs, want)]
    check(all(o.shape == (PIPE_BATCH, cfg.max_seq_len) and np.isfinite(o).all() for o in outs)
          and max(mean_diff) <= PIPE_NLL_TOL,
          f"watch_pipeline_gpt2: mean NLL differs from the unsplit forward by {mean_diff}")
    with open(sink) as f:
        sink_lines = sum(1 for ln in f if ln.strip())
    emit("watch_pipeline_gpt2",
         model=f"gpt2 125M bf16 (f32 master weights), 2 stages of {cfg.n_layers // 2} blocks at "
               f"num_gpus={PIPE_STAGE_GPUS} on one agent node, {n_mb} microbatches of "
               f"{PIPE_BATCH} x {cfg.max_seq_len + 1} ids",
         push_s=WATCH_PUSH_S, watchdog_cadence_s=WATCH_CADENCE_S, **row,
         profiler_off=off_row, rep_wall_ms_p50_profiler_on=row["rep_wall_ms_p50"],
         rep_wall_ms_p50_profiler_off=off_row["rep_wall_ms_p50"],
         profiler_on_over_off=row["rep_wall_ms_p50"] / off_row["rep_wall_ms_p50"],
         mean_nll_diff=mean_diff, nll_tolerance=PIPE_NLL_TOL, sink_lines=sink_lines,
         flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0),
         flash_launches_profiler_off=off_launches.get(attn.KERNEL, 0),
         phase_s=time.perf_counter() - t0)
    total = dict(launches)
    for k, n in off_launches.items():
        total[k] = total.get(k, 0) + n
    return total


# operator_job_gpt2: 8 fixed prompts (numpy default_rng(0), 16-99 ids in
# [1, 50000)) x 32 new greedy tokens through GPT-2 125M bf16 (seed 0) in a
# submitted job's num_gpus=1 actor; every prompt is queued before the
# engine starts, so one prefill admits all 8 (12 flash_fwd launches)
OP_PROMPTS, OP_NEW_TOKENS = 8, 32
OP_ENGINE = dict(n_slots=8, max_new_tokens=32, decode_chunk_steps=16, prefill_buckets=(128,))
OP_CLUSTER = {"cluster_name": "smoke", "provider": {"type": "local"},
              "head_node": {"address": "127.0.0.1", "num_cpus": 2, "num_gpus": 0},
              "worker_nodes": [{"address": "127.0.0.1", "num_cpus": 4, "num_gpus": 1}]}
# seconds: the agent's registration, each job, the grant's release after
# job-stop, and the cluster's exit after down
OP_JOIN_S, OP_JOB_S, OP_FREE_S, OP_DOWN_S = 120, 600, 30, 60

# The submitted job's driver: ``python3 <this file> <args.json> run|hold``.
# It joins through RAY_TPU_TORCH_ADDRESS (the head puts it in the job's
# env) and starts a num_gpus=1 actor.  "run": the actor builds the
# engine on its card, zeroes its launch counts, generates, reads them and
# the driver prints one OPERATOR_RESULT line.  "hold": the actor holds
# its grant, the driver prints OPERATOR_HOLDING and sleeps until stopped.
OPERATOR_DRIVER = r'''
import json, os, sys, time

import ray_tpu_torch as rt

args = json.load(open(sys.argv[1]))
rt.init()


@rt.remote(num_gpus=1)
class Generator:
    def place(self):
        return {"node_id": rt.get_runtime_context().node_id, "pid": os.getpid(),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def run(self, prompts, new_tokens, engine):
        import torch
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.serve.llm import GenerationEngine, make_config

        t0 = time.perf_counter()
        eng = GenerationEngine(make_config("gpt2", "125m"), seed=0, device="cuda",
                               **dict(engine, prefill_buckets=tuple(engine["prefill_buckets"])))
        build_s = time.perf_counter() - t0
        futs = [eng.submit(p, new_tokens) for p in prompts]
        _build.reset_launches()
        t0 = time.perf_counter()
        eng.start()
        try:
            streams = [f.result(timeout=600) for f in futs]
        finally:
            eng.stop()
        generate_s = time.perf_counter() - t0
        launches = dict(_build.launches)
        return dict(self.place(), streams=streams, engine_build_s=build_s,
                    generate_s=generate_s, prefills=eng.prefills,
                    flash_fwd=launches.get(attn.KERNEL, 0),
                    flash_fwd_tc=launches.get(attn.FWD_TC, 0),
                    peak_mem_bytes=torch.cuda.max_memory_allocated())


actor = Generator.remote()
if sys.argv[2] == "run":
    out = rt.get(actor.run.remote(args["prompts"], args["new_tokens"], args["engine"]),
                 timeout=600)
    print("OPERATOR_RESULT " + json.dumps(dict(out, driver_pid=os.getpid())), flush=True)
else:
    held = rt.get(actor.place.remote(), timeout=600)
    print("OPERATOR_HOLDING " + json.dumps(dict(held, driver_pid=os.getpid())), flush=True)
    time.sleep(3600)
'''


def _running(pid) -> bool:
    """True while ``pid`` runs (a zombie awaiting its reaper has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _descendants(roots) -> list:
    """Every live process whose chain of parents reaches one of ``roots``."""
    parent = {}
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError):
            continue
    out, todo = [], list(roots)
    while todo:
        root = todo.pop()
        kids = [p for p, pp in parent.items() if pp == root]
        out += kids
        todo += kids
    return sorted(out)


def _card_pids() -> list:
    """The pids ``nvidia-smi`` lists as holding a context on a card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return [int(p) for p in out.stdout.split() if p.strip().isdigit()]


def _op_wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        out = cond()
        if out:
            return out
        check(time.monotonic() < deadline, f"operator_job_gpt2: timed out on {what}")
        time.sleep(0.1)


def _job_line(client, job_id, tag):
    for line in client.get_job_logs(job_id).splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    return None


def _cli(args, env):
    """``python -m ray_tpu_torch <args>`` started from the repo root,
    talking to the cluster in ``env``."""
    return subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **env})


def phase_operator_job_gpt2():
    """The operator plane: ``autoscaler.commands.up`` with the local
    runner brings up a head of 2 CPUs and no card and one node of 4 CPUs
    holding the card; ``python -m ray_tpu_torch status`` sees 2 nodes and
    1 GPU; ``JobSubmissionClient.submit_job`` runs ``OPERATOR_DRIVER``,
    whose ``num_gpus=1`` actor generates ``OP_NEW_TOKENS`` greedy tokens
    for each of ``OP_PROMPTS`` prompts with GPT-2 125M bf16 (seed 0).
    Gates: the job SUCCEEDED; its streams equal an engine's of the same
    settings in this process; its 12 ``flash_fwd`` launches all on the
    tensor cores; the actor on the agent's node under
    ``CUDA_VISIBLE_DEVICES`` "0"; the state API (nodes, actors, jobs,
    task summary, events) and ``timeline_dump`` show the job, its actor
    and the card; a second job holding the card, stopped by ``python -m
    ray_tpu_torch job-stop``, ends STOPPED and the grant is back within
    ``OP_FREE_S``; after ``down`` none of these runs (read in ``/proc``):
    the head, the agent, each job's driver and actor, and every process
    the head or the agent ran just before ``down``; ``nvidia-smi`` lists
    none of them (it lists pids of its own namespace).  Returns the actor's
    launch counts (zeroed in its process just before the generation and
    read just after)."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import commands
    from ray_tpu_torch.experimental import state
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config
    from ray_tpu_torch.util.timeline import timeline_dump

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50000, rng.integers(16, 100)).tolist() for _ in range(OP_PROMPTS)]
    # the reference streams: the same engine settings and queue order here
    cfg = make_config("gpt2", "125m")
    ref = GenerationEngine(cfg, seed=0, device="cuda", **OP_ENGINE)
    futs = [ref.submit(p, OP_NEW_TOKENS) for p in prompts]
    ref.start()
    try:
        want = [f.result(timeout=600) for f in futs]
    finally:
        ref.stop()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    smoke_listed = os.getpid() in _card_pids()

    pids, client, clis = {}, None, []
    with tempfile.TemporaryDirectory(prefix="operator_job_") as tmp:
        script, args_path = os.path.join(tmp, "driver.py"), os.path.join(tmp, "args.json")
        with open(script, "w") as f:
            f.write(OPERATOR_DRIVER)
        with open(args_path, "w") as f:
            json.dump({"prompts": prompts, "new_tokens": OP_NEW_TOKENS, "engine": OP_ENGINE}, f)
        t0 = time.perf_counter()
        try:
            out = commands.up(OP_CLUSTER)
            up_s = time.perf_counter() - t0
            from ray_tpu_torch._private.config import session_root

            with open(os.path.join(session_root(), "last_session.json")) as f:
                pids["head"] = json.load(f)["pid"]
            env = {"RAY_TPU_TORCH_ADDRESS": out["address"], "RAY_TPU_TORCH_AUTHKEY": out["authkey"]}
            rt.init(address=out["address"], _authkey=bytes.fromhex(out["authkey"]))
            agent = out["workers"][0]["node_id"]
            _op_wait(lambda: rt.cluster_resources().get("GPU") == 1.0, OP_JOIN_S,
                     "the agent's registration")
            registered_s = time.perf_counter() - t0
            pids["agent"] = next(iter(_pids_of("ray_tpu_torch._private.node_agent", agent)), None)
            # `status` runs beside the first job (its own start is mostly
            # torch's import)
            status_proc = _cli(["status"], env)
            clis.append(status_proc)
            client = JobSubmissionClient(out["address"], bytes.fromhex(out["authkey"]))
            t1 = time.perf_counter()
            job = client.submit_job(entrypoint=f"{sys.executable} {script} {args_path} run",
                                    metadata={"phase": "operator_job_gpt2"})
            _op_wait(lambda: client.get_job_status(job) != "PENDING", 60, "RUNNING")
            running_s = time.perf_counter() - t1
            status_1 = client.wait_until_finish(job, timeout=OP_JOB_S, poll_s=0.1)
            job_s = time.perf_counter() - t1
            result = _job_line(client, job, "OPERATOR_RESULT")
            check(status_1 == "SUCCEEDED" and result is not None,
                  f"operator_job_gpt2: job {status_1}; its log:\n{client.get_job_logs(job)[-4000:]}")
            pids["actor_run"], pids["driver_run"] = result["pid"], result["driver_pid"]
            stdout, stderr = status_proc.communicate(timeout=120)
            check(status_proc.returncode == 0, f"operator_job_gpt2: status failed: {stderr}")
            status = json.loads(stdout)
            status_gpus = sum(r.get("GPU", 0) for r in status["cluster_resources"].values())
            check(status["nodes"] == 2 and status_gpus == 1.0,
                  f"operator_job_gpt2: status {status}")
            check(result["streams"] == want, "operator_job_gpt2: the job's greedy streams differ "
                  "from the in-process engine's")
            check(result["node_id"] == agent and result["cuda_visible_devices"] == "0",
                  f"operator_job_gpt2: the actor ran on {result['node_id']} under "
                  f"CUDA_VISIBLE_DEVICES {result['cuda_visible_devices']!r}, want {agent} and '0'")
            launches = {attn.KERNEL: result["flash_fwd"], attn.FWD_TC: result["flash_fwd_tc"]}
            # the job's driver is gone: its actor is reaped and the card is free
            _op_wait(lambda: rt.available_resources().get("GPU") == 1.0, OP_FREE_S,
                     "the first job's grant")

            # the state API and the timeline, from this driver
            nodes = {r["node_id"]: r for r in state.list_nodes()}
            check(sum(r["alive"] for r in nodes.values()) == 2
                  and nodes[agent]["resources"].get("GPU") == 1.0
                  and nodes[agent]["available"].get("GPU") == 1.0
                  and nodes["node-head"]["resources"].get("GPU") == 0.0,
                  f"operator_job_gpt2: list_nodes {nodes}")
            actors = [a for a in state.list_actors() if a["class_name"] == "Generator"]
            check(len(actors) == 1 and actors[0]["node_id"] == agent,
                  f"operator_job_gpt2: list_actors {actors}")
            jobs = {j["job_id"]: j for j in state.list_jobs()}
            check(jobs[job]["status"] == "SUCCEEDED" and jobs[job]["returncode"] == 0,
                  f"operator_job_gpt2: list_jobs {jobs}")
            tasks = state.summarize_tasks()
            events = state.list_events(limit=100)
            check(tasks.get("Generator.run") == {"FINISHED": 1} and events,
                  f"operator_job_gpt2: summarize_tasks {tasks}, {len(events)} events")
            trace_path = timeline_dump(os.path.join(tmp, "timeline.json"))
            with open(trace_path) as f:
                slices = [e for e in json.load(f)
                          if e.get("name") == "Generator.run" and e.get("ph") == "X"]
            check(len(slices) == 1 and slices[0]["pid"] == agent,
                  f"operator_job_gpt2: timeline slices of Generator.run {slices}")

            # a second job holds the card; job-stop frees it
            hold = client.submit_job(entrypoint=f"{sys.executable} {script} {args_path} hold")
            held = _op_wait(lambda: _job_line(client, hold, "OPERATOR_HOLDING"), OP_JOB_S,
                            "the second job's actor")
            pids["actor_hold"], pids["driver_hold"] = held["pid"], held["driver_pid"]
            check(held["node_id"] == agent and rt.available_resources().get("GPU", 0) == 0,
                  f"operator_job_gpt2: second job's actor {held}, free "
                  f"{rt.available_resources()}")
            t1 = time.perf_counter()
            stop = _cli(["job-stop", hold], env)
            clis.append(stop)
            stdout, stderr = stop.communicate(timeout=120)
            stop_cmd_s = time.perf_counter() - t1
            check(stop.returncode == 0 and stdout.strip() == "stopped",
                  f"operator_job_gpt2: job-stop {stop.returncode} {stdout!r} {stderr}")
            status_2 = client.wait_until_finish(hold, timeout=60, poll_s=0.1)
            _op_wait(lambda: rt.available_resources().get("GPU") == 1.0, OP_FREE_S,
                     "the stopped job's grant")
            freed_s = time.perf_counter() - t1
            check(status_2 == "STOPPED", f"operator_job_gpt2: the stopped job is {status_2}")
        finally:
            for proc in clis:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
            if client is not None:
                client.close()
            rt.shutdown()
            # every process the head and the agent started and still run
            # (the head is the subreaper of its forked workers)
            tree = _descendants([p for p in (pids.get("head"), pids.get("agent")) if p])
            t1 = time.perf_counter()
            commands.down(OP_CLUSTER)
    pids.update({f"child_{p}": p for p in tree if p not in pids.values()})
    left = lambda: [k for k, p in pids.items() if p is not None and _running(p)]
    _op_wait(lambda: not left(), OP_DOWN_S, f"the cluster's exit ({left()} still run)")
    down_s = time.perf_counter() - t1
    for p in pids.values():
        try:  # a zombie reparented to this process
            os.waitpid(p, os.WNOHANG)
        except (ChildProcessError, TypeError):
            pass
    listed = _card_pids()
    on_card = sorted(set(listed) & {p for p in pids.values() if p})
    check(pids.get("agent") is not None and not on_card,
          f"operator_job_gpt2: agent pid {pids.get('agent')}; cluster pids on the card {on_card}")
    check_tensor_cores("operator_job_gpt2", launches, cfg.n_layers)
    emit("operator_job_gpt2",
         model="gpt2 125m bf16, seed 0, one num_gpus=1 actor in a submitted job",
         engine={k: v for k, v in OP_ENGINE.items() if k != "prefill_buckets"},
         prompts=OP_PROMPTS, new_tokens=OP_NEW_TOKENS, agent_node=agent,
         actor_cuda_visible_devices=result["cuda_visible_devices"],
         up_to_session_record_s=up_s, up_to_agent_registered_s=registered_s,
         submit_to_running_s=running_s, submit_to_succeeded_s=job_s,
         actor_engine_build_s=result["engine_build_s"], actor_generate_s=result["generate_s"],
         actor_peak_mem_bytes=result["peak_mem_bytes"], streams_equal_in_process=True,
         job_stop_command_s=stop_cmd_s, job_stop_to_grant_freed_s=freed_s,
         grant_free_limit_s=OP_FREE_S, down_to_all_exited_s=down_s,
         cluster_pids=pids, cluster_pids_on_card=on_card, card_pids_listed=listed,
         nvidia_smi_lists_this_process=smoke_listed,
         timeline_method_slice_ms=slices[0]["dur"] / 1e3,
         tasks_by_name=tasks, events_listed=len(events),
         flash_launches=launches[attn.KERNEL], flash_launches_tensor_core=launches[attn.FWD_TC],
         card=nvidia_smi())
    return launches


# durable_job_gpt2: operator_job_gpt2's prompts and engine; a working_dir
# with a 50 MB file its excludes leave out; the pip task's forward of 2 x
# 64 ids (numpy default_rng(1), [1, 50000)); seconds for each job
DJ_EXCLUDED_MB, DJ_PIP_SHAPE, DJ_JOB_S = 50, (2, 64), 600
# the pip task's logits against this process's, the workflow's NLLs
# against the uninterrupted run's
DJ_LOGITS_TOL, DJ_NLL_TOL = 1e-3, 1e-4
DJ_NS = "durable_job_gpt2"  # the KV namespace the job writes its streams to

# The job's driver, ``python3 driver.py`` in its extracted working_dir: it
# imports its py_modules helper, joins through RAY_TPU_TORCH_ADDRESS, and
# starts a num_gpus=1 actor in the same two packages (their gcs:// URIs in
# DJ_ACTOR_ENV), which builds GPT-2 125M's engine on its card, zeroes its
# launch counts, generates, reads them; the driver writes the streams to
# the head's KV and prints one DURABLE_RESULT line.
DURABLE_DRIVER = r'''
import json, os, time

import dj_helper
import ray_tpu_torch as rt
from ray_tpu_torch._private.worker import global_worker

args = dj_helper.load_args("args.json")
rt.init()


@rt.remote(num_gpus=1)
class Generator:
    def run(self, prompts, new_tokens, engine):
        import dj_helper  # from the actor's own py_modules package
        import torch
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.serve.llm import GenerationEngine, make_config

        eng = GenerationEngine(make_config("gpt2", "125m"), seed=0, device="cuda",
                               **dict(engine, prefill_buckets=tuple(engine["prefill_buckets"])))
        futs = [eng.submit(p, new_tokens) for p in prompts]
        _build.reset_launches()
        eng.start()
        try:
            streams = [f.result(timeout=600) for f in futs]
        finally:
            eng.stop()
        launches = dict(_build.launches)
        return {"streams": streams, "cwd": os.getcwd(), "files": dj_helper.listing("."),
                "pid": os.getpid(), "flash_fwd": launches.get(attn.KERNEL, 0),
                "flash_fwd_tc": launches.get(attn.FWD_TC, 0)}


actor = Generator.options(runtime_env=json.loads(os.environ["DJ_ACTOR_ENV"])).remote()
out = rt.get(actor.run.remote(args["prompts"], args["new_tokens"], args["engine"]), timeout=600)
global_worker.client.kv_put(args["kv_ns"], b"streams", json.dumps(out["streams"]).encode())
print("DURABLE_RESULT " + json.dumps(dict(out, driver_cwd=os.getcwd(),
                                          driver_files=dj_helper.listing("."))), flush=True)
'''

DJ_HELPER = '''import json
import os


def load_args(path):
    with open(path) as f:
        return json.load(f)


def listing(path):
    """The package's files, less the cache's .ready and .pin-<pid> marks."""
    return sorted(f for f in os.listdir(path) if not f.startswith("."))
'''


def _dj_gpt2():
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm import make_config

    cfg = make_config("gpt2", "125m")
    return cfg, gpt2.init(cfg, torch.Generator().manual_seed(0), device="cuda")


def _gpt2_logits(tokens):
    """GPT-2 125M bf16 (seed 0) logits of ``tokens`` on the card, f32 on
    the host, with the flash launches (all, on the tensor cores) they
    took."""
    from ray_tpu_torch.models import gpt2

    cfg, params = _dj_gpt2()
    build.reset_launches()
    with torch.inference_mode():
        logits = gpt2.apply(params, torch.as_tensor(tokens, device="cuda"), cfg).cpu()
    return logits, {attn.KERNEL: build.launches.get(attn.KERNEL, 0),
                    attn.FWD_TC: build.launches.get(attn.FWD_TC, 0)}


def wf_generate(prompts):
    """Workflow step 1: the greedy streams of ``OP_ENGINE`` on the card."""
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config

    eng = GenerationEngine(make_config("gpt2", "125m"), seed=0, device="cuda", **OP_ENGINE)
    futs = [eng.submit(p, OP_NEW_TOKENS) for p in prompts]
    build.reset_launches()
    eng.start()
    try:
        streams = [f.result(timeout=600) for f in futs]
    finally:
        eng.stop()
    return {"streams": streams, "flash_fwd": build.launches.get(attn.KERNEL, 0),
            "flash_fwd_tc": build.launches.get(attn.FWD_TC, 0)}


def wf_score(generated, prompts):
    """Workflow step 2: each stream's mean next-token NLL under GPT-2 125M
    (seed 0), its prompt as context."""
    from ray_tpu_torch.models import gpt2

    cfg, params = _dj_gpt2()
    build.reset_launches()
    nll = []
    with torch.inference_mode():
        for p, s in zip(prompts, generated["streams"]):
            ids = torch.tensor([p + s], device="cuda")
            per_token = token_nll(gpt2.apply(params, ids[:, :-1], cfg), ids[:, 1:])
            nll.append(per_token[0, len(p) - 1:].mean().item())
    return {"nll": nll, "flash_fwd": build.launches.get(attn.KERNEL, 0),
            "flash_fwd_tc": build.launches.get(attn.FWD_TC, 0)}


def wf_finalize(generated, scored, marker):
    """Workflow step 3: fails on its first attempt only (it removes
    ``marker`` and raises), then returns the streams and their NLLs."""
    if os.path.exists(marker):
        os.unlink(marker)
        raise RuntimeError("transient failure of the last step")
    return {"streams": generated["streams"], "nll": scored["nll"]}


def _pkg_entries(node):
    from ray_tpu_torch._private.runtime_env_packaging import PKG_KV_NAMESPACE

    return sorted(k for k in node.gcs.kv_keys(PKG_KV_NAMESPACE) if not k.endswith(b".meta"))


def _offline_wheel(root):
    """A tiny wheel built offline, as ``tests/test_torch_runtime_env.py``
    builds it: the package ``rtpt_smoke_pkg`` is in no base environment."""
    src, wheels = os.path.join(root, "pkg_src"), os.path.join(root, "wheels")
    os.makedirs(os.path.join(src, "rtpt_smoke_pkg"))
    with open(os.path.join(src, "rtpt_smoke_pkg", "__init__.py"), "w") as f:
        f.write("MAGIC = 42\n")
    with open(os.path.join(src, "pyproject.toml"), "w") as f:
        f.write('[build-system]\nrequires = ["setuptools"]\n'
                'build-backend = "setuptools.build_meta"\n'
                '[project]\nname = "rtpt-smoke-pkg"\nversion = "1.0"\n')
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-index",
                    "--no-build-isolation", "-w", wheels, src],
                   check=True, capture_output=True, timeout=300)
    return {"pip": {"packages": ["rtpt-smoke-pkg"],
                    "pip_install_options": ["--no-index", "--find-links", wheels]}}


def _pip_probe():
    """What a pip env's worker imports: the wheel's package from its venv,
    and torch through the head's ``PYTHONPATH``."""
    import rtpt_smoke_pkg

    return {"magic": rtpt_smoke_pkg.MAGIC, "prefix": sys.prefix, "torch": torch.__version__}


def _pip_forward(tokens):
    """The pip env's card task: ``_pip_probe``, and GPT-2 125M's forward
    on its card."""
    logits, launches = _gpt2_logits(tokens)
    return dict(_pip_probe(), logits=logits, launches=launches)


def _dj_wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"durable_job_gpt2: timed out waiting for {what}")
        time.sleep(0.1)


def _tasks_named(state, *names):
    return {n: dict(state.summarize_tasks().get(n, {})) for n in names}


def phase_durable_job_gpt2():
    """Runtime envs, GCS persistence, the usage report and durable
    workflows on the card, GPT-2 125M bf16 (seed 0) at full width.  A head
    in this process started with ``_gcs_persistence_path`` (a SQLite
    file):
    (a) ``JobSubmissionClient`` submits ``DURABLE_DRIVER`` with a
    ``working_dir`` (the driver, its args, a ``DJ_EXCLUDED_MB`` MB file the
    ``excludes`` leave out) and one ``py_modules`` package (``dj_helper``);
    its ``num_gpus=1`` actor, in the same packages, generates
    ``OP_NEW_TOKENS`` greedy tokens for each of ``OP_PROMPTS`` prompts.
    Gates: SUCCEEDED; the streams equal an engine's of the same settings
    here; 12 ``flash_fwd`` launches, all on the tensor cores; the driver's
    and the actor's cwd is the extracted package under the head's cache,
    without the excluded file; submitting the same tree again adds no
    ``pkg`` entry to the KV; no live pin is left on either package once
    the jobs end.
    (b) a ``num_gpus=1`` task with ``runtime_env={"pip": ...}`` (a wheel
    built offline) imports that package and torch from its venv and runs
    one forward: its logits equal this process's within
    ``DJ_LOGITS_TOL``; a second pip task (on the CPU, in another env of
    the same spec) hits the venv's cache.
    (c) a workflow of three steps, ``wf_generate`` and ``wf_score``
    (``num_gpus=1``) and ``wf_finalize`` (fails once, through a marker
    file), ends FAILED; the head shuts down (its usage report written)
    and a second head starts over the same SQLite file.  Gates: the job's
    KV key is back, every first-head actor is DEAD (a live one "head
    restarted"), its finished tasks FINISHED; ``workflow.resume`` runs
    only the last step (no new ``wf_generate``/``wf_score`` task in the
    state API) and its output equals an uninterrupted ``workflow.run`` of
    the same DAG on this head, whose streams equal (a)'s reference.
    (d) each head's ``usage_report.json`` lists ``workflow`` and counts at
    least the tasks the phase submitted to it (the second head's past the
    tasks it replayed; the replayed usage flags, ``workflow`` among them,
    are cleared at its start, so its features are its own).  Prints the upload bytes and seconds, submit
    to SUCCEEDED, the venv's build and cache hit, the replay's seconds,
    the resume's wall against the first run's, the launch counts.
    Returns the launches of every card process of the phase."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import runtime_env_packaging as pkg
    from ray_tpu_torch._private import runtime_env_setup as renv
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental import state
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config
    from ray_tpu_torch.workflow.api import WorkflowStorage

    phase = "durable_job_gpt2"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50000, rng.integers(16, 100)).tolist() for _ in range(OP_PROMPTS)]
    pip_tokens = np.random.default_rng(1).integers(1, 50000, DJ_PIP_SHAPE).tolist()
    cfg = make_config("gpt2", "125m")
    ref = GenerationEngine(cfg, seed=0, device="cuda", **OP_ENGINE)
    futs = [ref.submit(p, OP_NEW_TOKENS) for p in prompts]
    ref.start()
    try:
        want = [f.result(timeout=600) for f in futs]
    finally:
        ref.stop()
    del ref
    want_logits, _ = _gpt2_logits(pip_tokens)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {attn.KERNEL: 0, attn.FWD_TC: 0}

    def count(row):
        launches[attn.KERNEL] += row["flash_fwd"]
        launches[attn.FWD_TC] += row["flash_fwd_tc"]

    row = {}
    with tempfile.TemporaryDirectory(prefix="durable_job_") as tmp:
        db = os.path.join(tmp, "gcs.db")
        os.environ["RAY_TPU_TORCH_WORKFLOW_STORAGE"] = os.path.join(tmp, "workflows")
        wd, mods = os.path.join(tmp, "job"), os.path.join(tmp, "modules", "dj_helper")
        os.makedirs(wd)
        os.makedirs(mods)
        with open(os.path.join(wd, "driver.py"), "w") as f:
            f.write(DURABLE_DRIVER)
        with open(os.path.join(wd, "args.json"), "w") as f:
            json.dump({"prompts": prompts, "new_tokens": OP_NEW_TOKENS, "engine": OP_ENGINE,
                       "kv_ns": DJ_NS}, f)
        with open(os.path.join(wd, "weights.bin"), "wb") as f:
            f.write(os.urandom(DJ_EXCLUDED_MB << 20))
        with open(os.path.join(mods, "__init__.py"), "w") as f:
            f.write(DJ_HELPER)
        job_env = {"working_dir": wd, "py_modules": [mods], "excludes": ["weights.bin"]}
        marker = os.path.join(tmp, "fail-once")
        try:
            # -- (a) a job with shipped code, on a persisting head
            rt.init(num_cpus=4, _gcs_persistence_path=db)
            node = global_worker.node
            head1_dir = node.session_dir
            client = JobSubmissionClient()
            t0 = time.perf_counter()
            uris = pkg.prepare_runtime_env(job_env, global_worker.client)
            upload_s = time.perf_counter() - t0
            actor_env = {k: uris[k] for k in ("working_dir", "py_modules", "excludes")}
            t0 = time.perf_counter()
            job = client.submit_job(
                entrypoint=f"{sys.executable} driver.py",
                runtime_env=dict(job_env, env_vars={"DJ_ACTOR_ENV": json.dumps(actor_env)}),
                metadata={"phase": phase})
            status = client.wait_until_finish(job, timeout=DJ_JOB_S, poll_s=0.1)
            job_s = time.perf_counter() - t0
            result = _job_line(client, job, "DURABLE_RESULT")
            check(status == "SUCCEEDED" and result is not None,
                  f"{phase}: job {status}; its log:\n{client.get_job_logs(job)[-4000:]}")
            check(result["streams"] == want,
                  f"{phase}: the job's greedy streams differ from the in-process engine's")
            count(result)
            check(result["flash_fwd"] == cfg.n_layers, f"{phase}: the job's actor launched "
                  f"flash_fwd {result['flash_fwd']} times, want {cfg.n_layers}")
            wd_dir = os.path.join(pkg.default_base_dir(),
                                  uris["working_dir"][len(pkg.PKG_URI_PREFIX):-len(".zip")])
            mod_dir = os.path.join(pkg.default_base_dir(),
                                   uris["py_modules"][0][len(pkg.PKG_URI_PREFIX):-len(".zip")])
            shipped = ["args.json", "driver.py"]
            check(result["cwd"] == result["driver_cwd"] == wd_dir
                  and result["files"] == result["driver_files"] == shipped,
                  f"{phase}: the actor ran in {result['cwd']} holding {result['files']}, the "
                  f"driver in {result['driver_cwd']}; want {wd_dir} holding {shipped}")
            # the uploads' puts are in the head's KV: the job's driver ran in both
            entries = _pkg_entries(node)
            upload_bytes = {k.decode(): len(node.gcs.kv_get(pkg.PKG_KV_NAMESPACE, k))
                            for k in entries}
            check(len(entries) == 2, f"{phase}: the KV holds packages {entries}, want 2")
            again = client.submit_job(entrypoint="true", runtime_env=job_env)
            check(client.wait_until_finish(again, timeout=60, poll_s=0.1) == "SUCCEEDED",
                  f"{phase}: the resubmitted tree's job failed: {client.get_job_logs(again)}")
            check(_pkg_entries(node) == entries,
                  f"{phase}: resubmitting the tree left packages {_pkg_entries(node)}")
            t0 = time.perf_counter()
            _dj_wait(lambda: not any(pkg._is_pinned(d) for d in (wd_dir, mod_dir)), 60,
                     "the jobs' pins to drop")
            pins_s = time.perf_counter() - t0
            left = [f for d in (wd_dir, mod_dir) for f in os.listdir(d) if f.startswith(".pin-")]
            check(not left, f"{phase}: pins left after the jobs ended: {left}")
            row.update(upload_bytes=upload_bytes, upload_s=upload_s, submit_to_succeeded_s=job_s,
                       package_dir=wd_dir, package_files=result["files"],
                       excluded_mb=DJ_EXCLUDED_MB, pins_dropped_s=pins_s)

            # -- (b) a pip env's task on the card
            t0 = time.perf_counter()
            pip_env = _offline_wheel(tmp)
            wheel_s = time.perf_counter() - t0
            env_dir = os.path.join(renv.default_base_dir(), f"pip-{renv.pip_env_key(pip_env['pip'])}")
            pip_task = rt.remote(num_gpus=1, runtime_env=pip_env)(_pip_forward)
            t0 = time.perf_counter()
            first = rt.get(pip_task.remote(pip_tokens), timeout=DJ_JOB_S)
            first_s = time.perf_counter() - t0
            build_s = (os.path.getmtime(os.path.join(env_dir, ".ready"))
                       - os.path.getmtime(os.path.join(env_dir, "pyvenv.cfg")))
            # the same pip spec in another env (so another worker): the
            # venv's cache serves it
            hit = rt.remote(num_cpus=1, runtime_env=dict(pip_env, env_vars={"DJ_HIT": "1"}))(
                _pip_probe)
            ready_mtime = os.path.getmtime(os.path.join(env_dir, ".ready"))
            t0 = time.perf_counter()
            second = rt.get(hit.remote(), timeout=DJ_JOB_S)
            hit_s = time.perf_counter() - t0
            for out in (first, second):
                check(out["magic"] == 42 and out["prefix"] == env_dir,
                      f"{phase}: the pip task ran in {out['prefix']} (magic {out['magic']}), "
                      f"want {env_dir}")
            err = (first["logits"] - want_logits).abs().max().item()
            count({"flash_fwd": first["launches"][attn.KERNEL],
                   "flash_fwd_tc": first["launches"][attn.FWD_TC]})
            check(first["launches"][attn.KERNEL] == cfg.n_layers,
                  f"{phase}: the pip task launched flash_fwd {first['launches']}")
            check(err <= DJ_LOGITS_TOL,
                  f"{phase}: the pip task's logits differ by {err} > {DJ_LOGITS_TOL}")
            check(os.path.getmtime(os.path.join(env_dir, ".ready")) == ready_mtime,
                  f"{phase}: the second pip task rebuilt the venv")
            row.update(wheel_build_s=wheel_s, pip_first_task_s=first_s, venv_build_s=build_s,
                       pip_cache_hit_task_s=hit_s, pip_logits_max_abs_err=err,
                       pip_logits_bitwise_equal=bool(torch.equal(first["logits"], want_logits)),
                       pip_torch=first["torch"], venv=env_dir)

            # -- (c) a workflow that fails on its last step, then a head restart
            steps = {f.__name__: rt.remote(num_gpus=1)(f) for f in (wf_generate, wf_score)}
            steps["wf_finalize"] = rt.remote(num_cpus=1)(wf_finalize)
            gen_node = steps["wf_generate"].bind(prompts)
            dag = steps["wf_finalize"].bind(gen_node, steps["wf_score"].bind(gen_node, prompts),
                                            marker)
            with open(marker, "w") as f:
                f.write("arm")

            @rt.remote(num_cpus=0)
            class Keeper:
                def ping(self):
                    return os.getpid()

            keeper = Keeper.remote()
            rt.get(keeper.ping.remote(), timeout=60)
            t0 = time.perf_counter()
            try:
                workflow.run(dag, workflow_id="durable-gpt2")
                failed = None
            except Exception as e:  # noqa: BLE001 — the step's designed failure
                failed = str(e).strip().splitlines()[-1]
            first_run_s = time.perf_counter() - t0
            check(failed is not None and workflow.get_status("durable-gpt2") == "FAILED",
                  f"{phase}: the first run ended {workflow.get_status('durable-gpt2')} ({failed})")
            with node.gcs.lock:
                finished = {t.task_id: t.name for t in node.gcs.tasks.values()
                            if t.state == "FINISHED"}
            # the tasks the phase submitted to the first head: the job's
            # actor's run, the two pip tasks, the keeper's ping, the three
            # steps of the first run
            head1_tasks = 1 + 2 + 1 + 3
            rt.shutdown()
            with open(os.path.join(head1_dir, "usage_report.json")) as f:
                usage1 = json.load(f)

            t0 = time.perf_counter()
            rt.init(num_cpus=4, _gcs_persistence_path=db)
            init_s = time.perf_counter() - t0
            node = global_worker.node
            head2_dir = node.session_dir
            check(node.gcs.kv_get(DJ_NS, b"streams") == json.dumps(want).encode(),
                  f"{phase}: the job's KV key did not come back")
            # the replay brings the first head's tasks and its workers'
            # usage flags back, so the second head's report would hold
            # them too: its tasks are counted past the replayed ones, and
            # the replayed flags go, so its features are its own
            replayed_tasks = len(node.gcs.tasks)
            replayed_usage = sorted(k.decode() for k in node.gcs.kv_keys("usage"))
            check("workflow" in replayed_usage,
                  f"{phase}: the replayed usage flags {replayed_usage} lack workflow")
            for k in list(node.gcs.kv_keys("usage")):
                node.gcs.kv_del("usage", k)
            actors = list(node.gcs.actors.values())
            check(actors and all(a.state == "DEAD" for a in actors)
                  and [a.death_cause for a in actors if a.class_name == "Keeper"]
                  == ["head restarted"],
                  f"{phase}: replayed actors {[(a.class_name, a.state, a.death_cause) for a in actors]}")
            replayed = {tid: t.state for tid, t in node.gcs.tasks.items() if tid in finished}
            check(replayed == {tid: "FINISHED" for tid in finished},
                  f"{phase}: {len(replayed)} of {len(finished)} finished tasks replayed, states "
                  f"{sorted(set(replayed.values()))}")
            before = _tasks_named(state, "wf_generate", "wf_score", "wf_finalize")
            t0 = time.perf_counter()
            resumed = workflow.resume("durable-gpt2")
            resume_s = time.perf_counter() - t0
            after = _tasks_named(state, "wf_generate", "wf_score", "wf_finalize")
            check(after["wf_generate"] == before["wf_generate"]
                  and after["wf_score"] == before["wf_score"]
                  and after["wf_finalize"].get("FINISHED", 0)
                  == before["wf_finalize"].get("FINISHED", 0) + 1,
                  f"{phase}: tasks before the resume {before}, after {after}")
            check(workflow.get_status("durable-gpt2") == "SUCCEEDED",
                  f"{phase}: the resumed workflow is {workflow.get_status('durable-gpt2')}")
            t0 = time.perf_counter()
            whole = workflow.run(dag, workflow_id="durable-gpt2-whole")
            whole_s = time.perf_counter() - t0
            check(resumed["streams"] == whole["streams"] == want,
                  f"{phase}: the resumed streams differ from the uninterrupted run's or (a)'s")
            nll_err = max(abs(a - b) for a, b in zip(resumed["nll"], whole["nll"]))
            check(nll_err <= DJ_NLL_TOL,
                  f"{phase}: the resumed NLLs differ from the uninterrupted run's by {nll_err}")
            # each card step ran once a workflow; its checkpoint holds the
            # launches counted in its worker
            for wid in ("durable-gpt2", "durable-gpt2-whole"):
                store = WorkflowStorage(wid)
                for sid in sorted(store.load_step_metas()):
                    if sid.endswith(("-wf_generate", "-wf_score")):
                        out = store.load_step(sid)
                        want_n = cfg.n_layers * (1 if sid.endswith("generate") else OP_PROMPTS)
                        check(out["flash_fwd"] == want_n, f"{phase}: step {sid} of {wid} "
                              f"launched flash_fwd {out['flash_fwd']} times, want {want_n}")
                        count(out)
            # the tasks the phase submitted to the second head: the
            # resumed last step, the uninterrupted run's three
            head2_tasks = 1 + 3
            replay_s = node.gcs_replay_s
            rt.shutdown()
            with open(os.path.join(head2_dir, "usage_report.json")) as f:
                usage2 = json.load(f)
            for name, rep, before_s, ran in (("first", usage1, 0, head1_tasks),
                                             ("second", usage2, replayed_tasks, head2_tasks)):
                check("workflow" in rep["features_used"]
                      and rep["counters"]["tasks_total"] - before_s >= ran,
                      f"{phase}: the {name} head's usage report {rep}, want workflow and "
                      f"tasks_total >= {before_s} replayed + {ran} submitted")
            row.update(replay_s=replay_s, second_head_init_s=init_s, first_run_s=first_run_s,
                       first_run_error=failed, resume_s=resume_s,
                       uninterrupted_run_s=whole_s, resume_over_first_run=resume_s / first_run_s,
                       nll=resumed["nll"], nll_max_abs_err=nll_err,
                       replayed_actors=len(actors), replayed_finished_tasks=len(replayed),
                       replayed_tasks=replayed_tasks, replayed_usage_features=replayed_usage,
                       tasks_before_resume=before, tasks_after_resume=after,
                       usage_first_head={k: usage1[k] for k in ("features_used", "counters")},
                       usage_second_head={k: usage2[k] for k in ("features_used", "counters")})
        finally:
            os.environ.pop("RAY_TPU_TORCH_WORKFLOW_STORAGE", None)
            if rt.is_initialized():
                rt.shutdown()
    check(launches[attn.KERNEL] == launches[attn.FWD_TC],
          f"{phase}: {launches[attn.FWD_TC]} of {launches[attn.KERNEL]} flash_fwd launches "
          f"on the tensor cores")
    emit(phase, model="gpt2 125m bf16, seed 0", prompts=OP_PROMPTS, new_tokens=OP_NEW_TOKENS,
         **row, flash_launches=launches[attn.KERNEL],
         flash_launches_tensor_core=launches[attn.FWD_TC],
         phase_s=time.perf_counter() - t_phase, card=nvidia_smi())
    return launches


def _pids_of(*needles):
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if all(n in cmd for n in needles) and _running(int(d)):
            out.append(int(d))
    return out



# tenant_front_doors_gpt2: GPT-2 125M bf16 (seed 0) behind the cluster's
# remote front doors.  Two tenants through a proxy process each hold a
# named "engine" actor on TFD_SHARE of the card and generate
# operator_job_gpt2's 8 prompts x 32 greedy tokens (every prompt queued
# before the engine starts, as there); a client:// process with no card
# puts TFD_THIN_IDS int64 ids (64 MiB) that a TFD_SHARE task reads onto
# the card for GPT-2's logits of its first TFD_THIN_PROMPT ids; a Serve
# app of 2 llm_deployment replicas at TFD_SHARE, with the tenants'
# engine settings, is deployed over the dashboard's REST API and served
# to TFD_HTTP_CLIENTS keep-alive clients x TFD_HTTP_PER_CLIENT requests,
# one replica SIGKILLed after reply TFD_KILL_AFTER, then as many again
# once the replica is replaced.  One prefill bucket makes every prefill
# n_slots x 128 and every decode step n_slots rows, so a request's tokens
# do not depend on what shares its batch, and each reply equals the
# in-process engine's stream whatever the arrival order.
TFD_ENGINE = dict(n_slots=8, max_new_tokens=32, decode_chunk_steps=16, prefill_buckets=(128,))
TFD_SHARE, TFD_THIN_IDS, TFD_THIN_PROMPT = 0.25, 8 << 20, 16
TFD_HTTP_CLIENTS, TFD_HTTP_PER_CLIENT, TFD_KILL_AFTER = 16, 8, 20
# seconds: a share's return after a tenant's kill, a reply's p99 under
# chaos, the wait for any one step of the phase
TFD_FREE_S, TFD_P99_S, TFD_WAIT_S = 10.0, 10.0, 600

# A tenant's client, "a laptop": ``python3 -c TENANT_CLIENT ARGS_JSON``
# with no card.  It joins through the proxy, starts its named engine
# actor and answers on stdin: "generate [N]" (N generations back to
# back, the last one's RESULT line), "loop" (until killed), "exit".
TENANT_CLIENT = r'''
import json, os, sys, time

import ray_tpu_torch as rt

args = json.loads(sys.argv[1])
rt.init(args["address"], namespace=args["namespace"])


class TenantEngine:
    """GPT-2 (seed 0) on this actor's grant; each generate builds an
    engine over the same weights with every prompt queued before it
    starts, so one prefill admits them all."""

    def __init__(self):
        import torch
        from ray_tpu_torch.serve.llm import _default_init, make_config

        self.cfg = make_config("gpt2", "125m")
        self.device = torch.device("cuda")
        self.params = _default_init(self.cfg, 0, self.device)

    def ident(self):
        return {"pid": os.getpid(), "worker_id": os.environ["RAY_TPU_TORCH_WORKER_ID"],
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def generate(self, prompts, new_tokens, engine, reps=1):
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.serve.llm import GenerationEngine

        engine = dict(engine, prefill_buckets=tuple(engine["prefill_buckets"]))
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng = GenerationEngine(self.cfg, params=self.params, device=self.device, **engine)
            futs = [eng.submit(p, new_tokens) for p in prompts]
            eng.start()
            try:
                streams = [f.result(timeout=600) for f in futs]
            finally:
                eng.stop()
        return {"streams": streams, "generate_s": time.perf_counter() - t0,
                "flash_fwd": _build.launches.get(attn.KERNEL, 0),
                "flash_fwd_tc": _build.launches.get(attn.FWD_TC, 0)}


eng = rt.remote(num_gpus=args["num_gpus"])(TenantEngine).options(name="engine").remote()
ident = rt.get(eng.ident.remote(), timeout=600)
ctx = rt.get_runtime_context()
print("READY " + json.dumps(dict(ident, job_id=ctx.job_id, namespace=ctx.namespace,
                                 actor_id=eng._actor_id.hex(), client_pid=os.getpid(),
                                 lookup_actor_id=rt.get_actor("engine")._actor_id.hex(),
                                 torch_in_client="torch" in sys.modules)), flush=True)
work = (args["prompts"], args["new_tokens"], args["engine"])
for line in sys.stdin:
    cmd, _, n = line.strip().partition(" ")
    if cmd == "generate":
        out = rt.get(eng.generate.remote(*work, int(n or 1)), timeout=900)
        print("RESULT " + json.dumps(out), flush=True)
    elif cmd == "loop":
        print("LOOPING", flush=True)
        while True:
            rt.get(eng.generate.remote(*work), timeout=900)
    elif cmd == "exit":
        break
rt.shutdown()
print("BYE", flush=True)
'''

# The thin client, with no card: ``python3 -c THIN_CLIENT ARGS_JSON``.
THIN_CLIENT = r'''
import json, os, sys, time

import numpy as np
import ray_tpu_torch as rt

args = json.loads(sys.argv[1])
rt.init(args["address"])
ids = np.random.default_rng(0).integers(1, 50000, args["n_ids"], dtype=np.int64)
t0 = time.perf_counter()
ref = rt.put(ids)
put_s = time.perf_counter() - t0


@rt.remote(num_gpus=args["num_gpus"])
def logits_of(ids, prompt_len):
    """GPT-2 125M's logits (seed 0) of the first prompt_len ids, all
    ids read onto the card first: a tensor on the card."""
    import torch
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.serve.llm import _default_init, make_config

    cfg = make_config("gpt2", "125m")
    x = torch.from_numpy(ids).to("cuda")
    params = _default_init(cfg, 0, torch.device("cuda"))
    _build.reset_launches()
    with torch.inference_mode():
        logits = gpt2.apply(params, x[:prompt_len][None], cfg)[0].float()
    return {"logits": logits, "ids_sum": int(x.sum()), "ids_device": str(x.device),
            "flash_fwd": _build.launches.get(attn.KERNEL, 0),
            "flash_fwd_tc": _build.launches.get(attn.FWD_TC, 0)}


out_ref = logits_of.remote(ref, args["prompt_len"])
rt.wait([out_ref], timeout=600)
import torch  # the get below unpickles a tensor; its import is not the get's

t0 = time.perf_counter()
out = rt.get(out_ref, timeout=600)
get_s = time.perf_counter() - t0
logits = out.pop("logits")
torch.save(logits, args["out"])

from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag.compiled import CompiledGraphError


@rt.remote
class Echo:
    def f(self, x):
        return x


with InputNode() as inp:
    dag = Echo.bind().f.bind(inp)
try:
    dag.experimental_compile()
    refused = None
except CompiledGraphError as e:
    refused = str(e)
from ray_tpu_torch._private.worker import global_worker

print("THIN_RESULT " + json.dumps(dict(
    out, put_s=put_s, put_bytes=int(ids.nbytes), get_s=get_s,
    get_bytes=int(logits.numel() * logits.element_size()), logits_device=str(logits.device),
    logits_shape=list(logits.shape), ids_sum_here=int(ids.sum()),
    card_here=torch.cuda.is_available(), thin=global_worker.thin_client,
    compile_refused=refused)), flush=True)
rt.shutdown()
'''

TFD_APP = """from ray_tpu_torch.serve.llm import llm_deployment

app = llm_deployment("gpt2", "125m", name="tenant_llm", num_replicas=2,
                     num_gpus={share!r}, engine_kwargs={engine!r}).bind()
"""


def _tfd_line(proc, token, timeout=TFD_WAIT_S):
    """The first stdout line of ``proc`` that starts with ``token``, its
    JSON tail parsed (fails on the process's exit or the timeout)."""
    box = {}

    def read():
        for line in proc.stdout:
            if line.startswith(token):
                box["line"] = line[len(token):].strip()
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    check("line" in box, f"tenant_front_doors_gpt2: no {token!r} line within {timeout} s "
                         f"(exit {proc.poll()})")
    return json.loads(box["line"]) if box["line"] else None


def _tfd_send(proc, cmd):
    proc.stdin.write(cmd + "\n")
    proc.stdin.flush()


def _tfd_soak(host, port, prompts, kill, clients=TFD_HTTP_CLIENTS, per=TFD_HTTP_PER_CLIENT):
    """``clients`` keep-alive clients x ``per`` POSTs of 32 greedy tokens
    each (idempotency keys, so the ingress retries a dead replica's
    requests); ``kill()`` runs once, after reply ``TFD_KILL_AFTER``.
    Returns each reply's (end, latency, prompt index, tokens), the lost
    requests (accepted, then failed), the transport errors, the kill's
    record and its monotonic time (``kill`` None: no kill, None, None)."""
    import http.client
    import uuid

    lock, replies, lost, errors, box = threading.Lock(), [], [], [], {}
    fire = threading.Event()

    def client(c):
        conn = http.client.HTTPConnection(host, port, timeout=TFD_WAIT_S)
        try:
            for r in range(per):
                i = (c * per + r) % len(prompts)
                body = json.dumps({"tokens": prompts[i], "max_new_tokens": OP_NEW_TOKENS})
                key, deadline = uuid.uuid4().hex, time.monotonic() + 120
                while True:
                    t0 = time.monotonic()
                    try:
                        conn.request("POST", "/gpt2", body=body, headers={
                            "Content-Type": "application/json", "X-Idempotency-Key": key})
                        resp = conn.getresponse()
                        data, status = resp.read(), resp.status
                    except (OSError, http.client.HTTPException) as e:
                        conn.close()
                        conn = http.client.HTTPConnection(host, port, timeout=TFD_WAIT_S)
                        if time.monotonic() < deadline:
                            continue
                        with lock:
                            errors.append(repr(e))
                        break
                    if status == 503 and time.monotonic() < deadline:
                        time.sleep(min(float(resp.headers.get("Retry-After") or 0.2), 0.5))
                        continue
                    with lock:
                        if status == 200:
                            replies.append((time.monotonic(), time.monotonic() - t0, i,
                                            json.loads(data)["tokens"]))
                            if len(replies) == TFD_KILL_AFTER:
                                fire.set()
                        else:
                            lost.append((status, data[:200]))
                    break
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    if kill is not None:
        check(fire.wait(TFD_WAIT_S), "tenant_front_doors_gpt2: the soak never reached its kill")
        box["t_kill"] = time.monotonic()
        box["rec"] = kill()
    for t in threads:
        t.join(TFD_WAIT_S)
    check(not any(t.is_alive() for t in threads), "tenant_front_doors_gpt2: soak clients wedged")
    return replies, lost, errors, box.get("rec"), box.get("t_kill")


def phase_tenant_front_doors_gpt2():
    """The thin client, the multi-tenant proxy, the chaos harness and the
    dashboard over GPT-2 125M on the card (see the module doc).  Returns
    the flash_fwd launches of the tenants' engines, the thin client's
    task and the Serve replicas that lived to the end."""
    import http.client
    import subprocess as sp
    import tempfile
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.devtools.chaos import ChaosMonkey
    from ray_tpu_torch.experimental.state import api as state
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.llm import GenerationEngine, _default_init, make_config

    phase, t_phase, card = "tenant_front_doors_gpt2", time.perf_counter(), nvidia_smi()
    cfg = make_config("gpt2", "125m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50000, int(rng.integers(16, 100))).tolist()
               for _ in range(OP_PROMPTS)]
    root = tempfile.mkdtemp(prefix="tfd_")
    with open(os.path.join(root, "tfd_serve_app.py"), "w") as f:
        f.write(TFD_APP.format(share=TFD_SHARE, engine=dict(TFD_ENGINE, seed=0)))
    repo = os.path.dirname(os.path.abspath(__file__))
    pythonpath = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, repo, os.environ.get("PYTHONPATH")) if p)
    sys.path.insert(0, root)
    os.environ["RAY_TPU_TORCH_METRICS_PUSH_S"] = "0.5"
    procs, launches, row, laptop = [], {}, {}, {}

    def count(out):
        for k, n in ((attn.KERNEL, out["flash_fwd"]), (attn.FWD_TC, out["flash_fwd_tc"])):
            launches[k] = launches.get(k, 0) + n

    def start(args, script):
        p = sp.Popen([sys.executable, "-c", script, json.dumps(args)], env=laptop, cwd=repo,
                     stdin=sp.PIPE, stdout=sp.PIPE, text=True, bufsize=1)
        procs.append(p)
        return p

    t0 = time.perf_counter()
    rt.init(num_cpus=8, num_gpus=1)
    node = global_worker.node
    head = node._head_node_id
    # the tenants' and the thin client's processes: no card, the key
    laptop.update(os.environ, CUDA_VISIBLE_DEVICES="", RAY_TPU_TORCH_AUTHKEY=node.authkey.hex())
    try:
        row["head_up_s"] = time.perf_counter() - t0
        check(node.dashboard is not None, f"{phase}: the head started no dashboard")
        dash = "http://%s:%d" % tuple(node.dashboard.address)

        def get(path, raw=False):
            with urllib.request.urlopen(dash + path, timeout=TFD_WAIT_S) as r:
                body = r.read().decode()
            return body if raw else json.loads(body)

        # the proxy, a process of its own, finds the head by its record
        t0 = time.perf_counter()
        proxy = sp.Popen([sys.executable, "-m", "ray_tpu_torch.util.client.proxier", "--head",
                          "auto", "--port", "0"], cwd=repo, stdout=sp.PIPE, text=True)
        procs.append(proxy)
        line = proxy.stdout.readline()
        m = re.search(r"proxy on ([\d.]+):(\d+) -> (\S+)", line)
        check(m is not None and m.group(3) == "tcp://%s:%d" % node.tcp_address,
              f"{phase}: the proxy printed {line!r}")
        row["proxy_up_s"] = time.perf_counter() - t0
        proxied = f"ray_tpu_torch://{m.group(1)}:{m.group(2)}"

        # (a) two tenants through the proxy
        base = {"address": proxied, "num_gpus": TFD_SHARE, "prompts": prompts, "new_tokens": OP_NEW_TOKENS, "engine": TFD_ENGINE}
        t0 = time.perf_counter()
        tenants = {ns: start(dict(base, namespace=ns), TENANT_CLIENT) for ns in ("a", "b")}
        ready = {ns: _tfd_line(p, "READY ") for ns, p in tenants.items()}
        row["tenants_ready_s"] = time.perf_counter() - t0
        for p in tenants.values():
            _tfd_send(p, "generate")
        first = {ns: _tfd_line(p, "RESULT ") for ns, p in tenants.items()}
        ref = GenerationEngine(cfg, seed=0, device="cuda", **TFD_ENGINE)
        futs = [ref.submit(p, OP_NEW_TOKENS) for p in prompts]
        ref.start()
        try:
            want = [f.result(timeout=TFD_WAIT_S) for f in futs]
        finally:
            ref.stop()
        for ns, out in first.items():
            check(out["streams"] == want, f"{phase}: tenant {ns}'s streams differ from the "
                                          "engine's in this process")
            check_tensor_cores(f"{phase} (tenant {ns})", out, cfg.n_layers)
            count(out)
        a, b = ready["a"], ready["b"]
        check(a["actor_id"] != b["actor_id"] and all(
            r["lookup_actor_id"] == r["actor_id"] for r in (a, b)),
              f"{phase}: the tenants' engines collide: {a} {b}")
        try:
            rt.get_actor("engine")
            check(False, f"{phase}: the default namespace sees a tenant's engine")
        except ValueError:
            pass
        check(not (a["torch_in_client"] or b["torch_in_client"]),
              f"{phase}: a tenant's client imported torch")
        check({r["cuda_visible_devices"] for r in (a, b)} == {"0"},
              f"{phase}: the engines' grants {a['cuda_visible_devices']}, "
              f"{b['cuda_visible_devices']}")
        rows = {r["job_id"]: r for r in state.list_tenants()}
        for r in (a, b):
            t = rows.get(r["job_id"], {})
            check(t.get("proxied") and t.get("alive") and t.get("namespace") == r["namespace"]
                  and t.get("pid") and t.get("actors") == 1,
                  f"{phase}: list_tenants row {t} for {r['job_id']}")
        host, port = node.tcp_address
        cli_env = dict(os.environ, RAY_TPU_TORCH_ADDRESS=f"tcp://{host}:{port}",
                       RAY_TPU_TORCH_AUTHKEY=node.authkey.hex())
        listed = sp.run([sys.executable, "-m", "ray_tpu_torch", "list", "tenants"], cwd=repo,
                        env=cli_env, capture_output=True, text=True, timeout=TFD_WAIT_S)
        check(listed.returncode == 0 and all(
            r["job_id"] in listed.stdout and str(rows[r["job_id"]]["pid"]) in listed.stdout
            for r in (a, b)), f"{phase}: `list tenants` printed {listed.stdout[-2000:]}")
        row["tenants"] = {ns: {"job_id": r["job_id"], "driver_pid": rows[r["job_id"]]["pid"],
                               "engine_pid": r["pid"], "engine_worker_id": r["worker_id"],
                               "generate_s": first[ns]["generate_s"]}
                          for ns, r in ready.items()}

        # (b) a thin client with no card
        want_logits = None
        with torch.inference_mode():
            ids = np.random.default_rng(0).integers(1, 50000, TFD_THIN_IDS, dtype=np.int64)
            params = _default_init(cfg, 0, torch.device("cuda"))
            want_logits = gpt2.apply(params, torch.from_numpy(ids[:TFD_THIN_PROMPT]).to(
                "cuda")[None], cfg)[0].float().cpu()
            del params
        out_path = os.path.join(root, "thin_logits.pt")
        t0 = time.perf_counter()
        thin = start({"address": "client://%s:%d" % node.tcp_address,
                      "num_gpus": TFD_SHARE, "n_ids": TFD_THIN_IDS,
                      "prompt_len": TFD_THIN_PROMPT, "out": out_path}, THIN_CLIENT)
        tr = _tfd_line(thin, "THIN_RESULT ")
        thin.wait(TFD_WAIT_S)
        row["thin_client_s"] = time.perf_counter() - t0
        got = torch.load(out_path)
        check(tr["thin"] and not tr["card_here"] and tr["logits_device"] == "cpu",
              f"{phase}: the thin client's result {tr}")
        check(tr["ids_sum"] == tr["ids_sum_here"] == int(ids.sum())
              and tr["ids_device"].startswith("cuda"),
              f"{phase}: the task read {tr['ids_sum']} on {tr['ids_device']}")
        err = float((got - want_logits).abs().max())
        check(got.shape == want_logits.shape and torch.equal(got, want_logits),
              f"{phase}: the thin client's logits differ from this process's by {err}")
        check(tr["compile_refused"] is not None and "client://" in tr["compile_refused"],
              f"{phase}: a thin client compiled a graph ({tr['compile_refused']})")
        check_tensor_cores(f"{phase} (thin task)", tr, cfg.n_layers)
        count(tr)
        row["thin_client"] = {k: tr[k] for k in ("put_s", "put_bytes", "get_s", "get_bytes",
                                                 "logits_shape")}
        row["thin_client"]["max_abs_err"] = err
        del want_logits, got

        # (e) the dashboard's reads, both tenants' engines alive
        status = get("/api/cluster_status")
        check(status["cluster_resources"][head].get("GPU") == 1.0,
              f"{phase}: /api/cluster_status {status['cluster_resources']}")
        wids = {r["worker_id"] for r in (a, b)}
        deadline = time.monotonic() + 30
        while True:
            metrics = get("/metrics", raw=True)
            top = get("/api/top")
            cards = {r["tags"].get("origin") for r in top["hbm"]
                     if r["tags"].get("kind") == "hbm"}
            if ("ray_tpu_llm_ttft_s_bucket" in metrics and wids <= cards
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)
        check("ray_tpu_llm_ttft_s_bucket" in metrics and "ray_tpu_hbm_bytes_in_use" in metrics,
              f"{phase}: /metrics lacks the engines' pushed series")
        check(wids <= cards, f"{phase}: /api/top card rows of {cards}, want {sorted(wids)}: "
                             f"{top['hbm']}")
        _tfd_send(tenants["b"], "generate 40")
        time.sleep(1.0)
        prof = get(f"/api/profile?duration=2&worker_id={b['worker_id']}")
        loop = sum(r["samples"] for r in prof.get("report") or []
                   if re.search(r"decode|generate|_loop", r["stack"]))
        check(prof.get("target") == b["worker_id"] and loop > 0,
              f"{phase}: /api/profile of tenant b's engine {str(prof)[:1500]}")
        again = _tfd_line(tenants["b"], "RESULT ")
        check(again["streams"] == want, f"{phase}: tenant b's repeated streams differ")
        check_tensor_cores(f"{phase} (tenant b, profiled)", again, 40 * cfg.n_layers)
        count(again)
        row["dashboard"] = {"profile_decode_samples": loop,
                            "profile_samples": sum(r["samples"] for r in prof["report"]),
                            "top_card_rows": len(cards), "metrics_bytes": len(metrics)}

        # (c) chaos on tenant a while it generates
        gpu0 = node.nodes[head].available.get("GPU", 0.0)
        _tfd_send(tenants["a"], "loop")
        _tfd_line(tenants["a"], "LOOPING")
        time.sleep(1.0)
        t0 = time.perf_counter()
        rec = ChaosMonkey(node=node).kill_tenant_driver(namespace="a")
        check(rec["pid"] == rows[a["job_id"]]["pid"], f"{phase}: chaos killed {rec}")

        def a_freed():
            with node.gcs.lock:
                info = [x for x in node.gcs.actors.values() if x.actor_id.hex() == a["actor_id"]]
            return (info and info[0].state == "DEAD"
                    and node.nodes[head].available.get("GPU", 0.0) >= gpu0 + TFD_SHARE - 1e-9)
        while not a_freed() and time.perf_counter() - t0 < TFD_FREE_S:
            time.sleep(0.05)
        free_s = time.perf_counter() - t0
        check(a_freed(), f"{phase}: tenant a's engine or its share not back in {TFD_FREE_S} s "
                         f"(GPU available {node.nodes[head].available.get('GPU')}, was {gpu0})")
        _tfd_send(tenants["b"], "generate")
        after = _tfd_line(tenants["b"], "RESULT ")
        check(after["streams"] == want, f"{phase}: tenant b's streams changed after a's kill")
        count(after)
        events = state.list_events(limit=100_000, source="chaos")
        check(any(e.get("message") == "inject kill_tenant_driver"
                  and e.get("entity_id") == a["job_id"] for e in events),
              f"{phase}: the kill is not on record")
        _tfd_send(tenants["b"], "exit")
        _tfd_line(tenants["b"], "BYE")
        check(tenants["b"].wait(TFD_WAIT_S) == 0, f"{phase}: tenant b exited non-zero")
        tenants["a"].kill()
        tenants["a"].wait(TFD_WAIT_S)
        deadline = time.monotonic() + 30
        while not [r for r in state.list_tenants()
                   if r["job_id"] == b["job_id"] and not r["alive"]]:
            check(time.monotonic() < deadline, f"{phase}: tenant b's exit not seen")
            time.sleep(0.1)
        killed = [f for f in state.doctor_report() if f["rule"] == "tenant_killed"]
        check(len(killed) == 1 and a["job_id"] in killed[0]["summary"]
              and b["job_id"] not in killed[0]["summary"],
              f"{phase}: the doctor's tenant_killed {killed}")
        row["chaos_tenant"] = {"share_back_s": free_s, "killed_driver_pid": rec["pid"],
                               "doctor": killed[0]["summary"]}

        # (d) a Serve app deployed over REST, under chaos
        rt_serve.start(rt_serve.HTTPOptions(host="127.0.0.1", port=0))
        sclient = rt_serve.api._get_client()
        config = {"applications": [{
            "name": "gpt2_app", "import_path": "tfd_serve_app:app", "route_prefix": "/gpt2",
            "deployments": [{"name": "tenant_llm", "num_replicas": 2}]}]}
        cfg_path = os.path.join(root, "serve_config.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        t0 = time.perf_counter()
        dep = sp.run([sys.executable, "-m", "ray_tpu_torch", "serve-deploy", cfg_path], cwd=repo,
                     env=cli_env, capture_output=True, text=True, timeout=TFD_WAIT_S)
        check(dep.returncode == 0 and json.loads(dep.stdout)["deployed"] == ["tenant_llm"],
              f"{phase}: serve-deploy {dep.returncode} {dep.stdout[-800:]} {dep.stderr[-800:]}")
        row["serve_deploy_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + TFD_WAIT_S
        while len(replicas := replica_actors(rt, rt_serve, "tenant_llm")) < 2:
            check(time.monotonic() < deadline, f"{phase}: {len(replicas)} replicas running")
            time.sleep(0.25)
        row["serve_ready_s"] = time.perf_counter() - t0
        grants = rt.get([r._submit_compiled_task(_card_grant, (), name="grant") for r in replicas],
                        timeout=60)
        check(all(g == ("0", [0]) for g in grants), f"{phase}: the replicas' grants {grants}")
        want_serve = want  # the tenants' engine settings: (a)'s reference streams
        shost, sport = rt_serve.get_http_address()
        conn = http.client.HTTPConnection(shost, sport, timeout=TFD_WAIT_S)
        conn.request("POST", "/gpt2", body=json.dumps({"tokens": prompts[0],
                                                       "max_new_tokens": OP_NEW_TOKENS}))
        warm = json.loads(conn.getresponse().read())["tokens"]
        conn.close()
        check(warm == want_serve[0], f"{phase}: the app's first reply differs")
        actor_launches(rt, replicas, reset=True)
        stats0 = rt.get(sclient.proxy.ingress_stats.remote(), timeout=60)
        gpu1 = node.nodes[head].available.get("GPU", 0.0)
        replies, lost, errors, krec, t_kill = _tfd_soak(
            shost, sport, prompts,
            lambda: ChaosMonkey(node=node).kill_serve_replica("tenant_llm",
                                                              controller=sclient.controller))
        dead = krec["target"]
        recovery_s = None
        while recovery_s is None and time.monotonic() - t_kill < TFD_WAIT_S:
            info = rt.get(sclient.controller.get_routing_info.remote("tenant_llm"), timeout=60)
            if dead not in {t for t, _ in info["replicas"]} and len(info["replicas"]) >= 2:
                recovery_s = time.monotonic() - t_kill
            else:
                time.sleep(0.25)
        check(recovery_s is not None, f"{phase}: the killed replica was never replaced")
        after, lost2, errors2, _, _ = _tfd_soak(shost, sport, prompts, None)
        check(not (lost or errors or lost2 or errors2),
              f"{phase}: lost {(lost + lost2)[:5]}, transport errors {(errors + errors2)[:5]}")
        check(len(replies) == len(after) == TFD_HTTP_CLIENTS * TFD_HTTP_PER_CLIENT,
              f"{phase}: {len(replies)} replies under the kill, {len(after)} after it")
        bad = [(i, toks) for _, _, i, toks in replies + after if toks != want_serve[i]]
        check(not bad, f"{phase}: {len(bad)} replies differ from the in-process engine's")
        replicas = replica_actors(rt, rt_serve, "tenant_llm")
        grants = rt.get([r._submit_compiled_task(_card_grant, (), name="grant") for r in replicas],
                        timeout=60)
        check(len(replicas) == 2 and all(g == ("0", [0]) for g in grants)
              and abs(node.nodes[head].available.get("GPU", 0.0) - gpu1) < 1e-9,
              f"{phase}: after recovery {len(replicas)} replicas, grants {grants}, GPU available "
              f"{node.nodes[head].available.get('GPU')} (was {gpu1})")
        stats1 = rt.get(sclient.proxy.ingress_stats.remote(), timeout=60)
        check(stats1["replica_deaths"] > stats0["replica_deaths"]
              and stats1["retries"] > stats0["retries"],
              f"{phase}: ingress stats {stats0} -> {stats1}")
        lat = lambda sel: [l for e, l, _, _ in replies if sel(e - t_kill)]
        before = lat(lambda d: d < 0)
        during = lat(lambda d: 0 <= d <= recovery_s)
        after_r = lat(lambda d: d > recovery_s) + [l for _, l, _, _ in after]
        p99 = pct([l for _, l, _, _ in replies + after], 0.99)
        check(p99 < TFD_P99_S, f"{phase}: reply p99 {p99} s")
        found = {f["rule"] for f in state.doctor_report()}
        check(not found & {"ingress_shedding", "drain_stuck"}, f"{phase}: the doctor's {found}")
        serve_launches = actor_launches(rt, replicas)
        check_tensor_cores(f"{phase} (serve replicas)", serve_launches)
        for k, n in serve_launches.items():
            if k in (attn.KERNEL, attn.FWD_TC):
                launches[k] = launches.get(k, 0) + n
        apps = get("/api/serve/applications")
        check(apps["tenant_llm"]["num_replicas_goal"] == 2, f"{phase}: {apps}")
        config["applications"][0]["deployments"][0]["num_replicas"] = 1

        def put(cfg_):
            req = urllib.request.Request(dash + "/api/serve/applications", method="PUT",
                                         data=json.dumps(cfg_).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TFD_WAIT_S) as r:
                return json.loads(r.read())
        put(config)
        deadline = time.monotonic() + TFD_WAIT_S
        while len(replica_actors(rt, rt_serve, "tenant_llm")) != 1:
            check(time.monotonic() < deadline, f"{phase}: the app never scaled to 1 replica")
            time.sleep(0.25)
        put({"applications": []})
        while "tenant_llm" in rt_serve.status():
            check(time.monotonic() < deadline, f"{phase}: the app was never deleted")
            time.sleep(0.25)
        windows = (("before", before), ("during", during), ("after", after_r))
        row["serve_chaos"] = {
            "replies": len(replies) + len(after), "recovery_s": recovery_s,
            "killed_replica": dead,
            "p50_ms": {k: pct(v, 0.5) * 1e3 if v else None for k, v in windows},
            "p99_ms": {k: pct(v, 0.99) * 1e3 if v else None for k, v in windows},
            "ingress": {k: stats1[k] - stats0[k] for k in ("replica_deaths", "retries")},
            "replicas_share": TFD_SHARE}
        rt_serve.shutdown()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(TFD_WAIT_S)
        rt.shutdown()
        os.environ.pop("RAY_TPU_TORCH_METRICS_PUSH_S", None)
        if pythonpath is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = pythonpath
        sys.path.remove(root)
    for r in row.get("tenants", {}).values():
        check(not _running(r["driver_pid"]) and not _running(r["engine_pid"]),
              f"{phase}: a tenant's process outlived the phase: {r}")
    emit(phase, card=card, model="gpt2 125m bf16 (seed 0)", engine=TFD_ENGINE,
         share=TFD_SHARE, **row,
         flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0),
         phase_s=time.perf_counter() - t_phase)
    return launches


WITNESS_ENGINE = dict(n_slots=8, max_new_tokens=32, decode_chunk_steps=16, prefill_buckets=(128,))
WITNESS_REQUESTS, WITNESS_NEW_TOKENS, WITNESS_WAIT_S = 8, 32, 600
# the floors of tests/test_perf_smoke.py (ops/s)
PERF_FLOORS = {"task_round_trip": 20, "actor_call_round_trip": 40}

# The witnessed head's driver: a process of its own, so that
# RAY_TPU_TORCH_LOCKWITNESS is in its environment before the interpreter
# starts and the locks made at import are witnessed too.  argv[1] is the
# JSON spec; the last line it prints is "WITNESSED {...}".
WITNESS_DRIVER = r'''
import contextlib, io, json, os, sys, time
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private import object_store
from ray_tpu_torch.devtools.raylint.lockwitness import WITNESS, WitnessLock
from ray_tpu_torch.scripts import cli
from ray_tpu_torch.serve.llm import llm_deployment
from ray_tpu_torch.util import metrics

spec = json.loads(sys.argv[1])
out = {"wrapped": {"metrics.registry": isinstance(metrics._global.lock, WitnessLock),
                   "object_store.attached": isinstance(object_store._ATTACHED_LOCK, WitnessLock),
                   "object_store.arena_maps": isinstance(object_store._ARENA_MAPS_LOCK,
                                                         WitnessLock)}}
assert all(out["wrapped"].values()), out["wrapped"]


def launch_counts(instance, reset):
    from ray_tpu_torch.ops import _build
    counts = dict(_build.launches)
    if reset:
        _build.reset_launches()
    return counts


def grant(instance):
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def square(i):
    return i * i


@rt.remote
class Counter:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n


wait = spec["wait_s"]
t0 = time.perf_counter()
rt.init(num_cpus=4)
try:
    out["head_up_s"] = time.perf_counter() - t0
    serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
    t0 = time.perf_counter()
    handle = serve.run(llm_deployment("gpt2", "125m", engine_kwargs=spec["engine"]).bind(),
                       host="127.0.0.1", port=0, timeout_s=wait)
    out["deploy_s"] = time.perf_counter() - t0
    info = rt.get(serve.api._get_client().controller.get_routing_info.remote("llm"), timeout=60)
    (replica,) = [h for _, h in info["replicas"]]
    out["grant"] = rt.get(replica._submit_compiled_task(grant, (), name="grant"), timeout=60)
    rt.get(handle.remote({"tokens": [1] * 8, "max_new_tokens": 4}), timeout=wait)
    rt.get(replica._submit_compiled_task(launch_counts, (True,), name="launches"), timeout=60)
    prefills0 = rt.get(handle.stats.remote(), timeout=60)["prefills"]
    t0 = time.perf_counter()
    refs = [handle.remote({"tokens": p, "max_new_tokens": spec["new_tokens"]})
            for p in spec["prompts"]]
    # alongside the requests: tasks, actors and a kill, a put
    assert rt.get([square.remote(i) for i in range(32)], timeout=wait) == \
        [i * i for i in range(32)]
    actors = [Counter.remote() for _ in range(3)]
    for c in actors:
        assert rt.get([c.inc.remote() for _ in range(5)], timeout=wait)[-1] == 5
    rt.kill(actors[0])
    arr = np.arange(1 << 22, dtype=np.float32)
    assert np.array_equal(rt.get(rt.put(arr), timeout=60), arr)
    out["outs"] = [o["tokens"] for o in rt.get(refs, timeout=wait)]
    out["requests_wall_s"] = time.perf_counter() - t0
    out["launches"] = rt.get(replica._submit_compiled_task(launch_counts, (False,),
                                                           name="launches"), timeout=60)
    out["admissions"] = rt.get(handle.stats.remote(), timeout=60)["prefills"] - prefills0
    # doctor --static against this live head, in-process
    t0 = time.perf_counter()
    buf, rc = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(["doctor", "--static", "--json"])
        except SystemExit as e:
            rc = e.code
    out["doctor_rc"], out["doctor_s"] = rc, time.perf_counter() - t0
    out["doctor_rules"] = sorted({f["rule"] for f in json.loads(buf.getvalue())})
    serve.shutdown()
finally:
    rt.shutdown()
snap = WITNESS.snapshot()
out["edges"], out["cycles"] = snap["edges"], len(snap["cycles"])
print("WITNESSED " + json.dumps(out), flush=True)
'''


def phase_core_perf_witness_gpt2():
    """The core microbenchmarks on the card's host, GPT-2 125M served on
    the card under the lock witness, and the raylint gate (see the module
    doc).  Returns the witnessed replica's launches."""
    import glob
    import tempfile

    from ray_tpu_torch._private import ray_perf
    from ray_tpu_torch.serve.llm import GenerationEngine, make_config

    phase, t_phase, card = "core_perf_witness_gpt2", time.perf_counter(), nvidia_smi()
    repo = os.path.dirname(os.path.abspath(__file__))
    row = {}

    # (a) the core microbenchmarks
    t0 = time.perf_counter()
    rows = ray_perf.main(quick=True)
    row["perf_s"] = time.perf_counter() - t0
    perf = {r["metric"]: r["value"] for r in rows}
    check(len(rows) >= 9 and all(v > 0 for v in perf.values()),
          f"{phase}: a ray_perf row is not above 0: {perf}")
    for metric, floor in PERF_FLOORS.items():
        check(perf[metric] > floor, f"{phase}: {metric} {perf[metric]} ops/s, floor {floor}")

    # the unwitnessed reference: the same engine in this process
    cfg = make_config("gpt2", "125m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50000, int(rng.integers(16, 100))).tolist()
               for _ in range(WITNESS_REQUESTS)]
    engine = dict(WITNESS_ENGINE, seed=0)
    ref = GenerationEngine(cfg, device="cuda", **engine)
    futs = [ref.submit(p, WITNESS_NEW_TOKENS) for p in prompts]
    ref.start()
    try:
        want = [f.result(timeout=WITNESS_WAIT_S) for f in futs]
    finally:
        ref.stop()
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the witnessed head, its replica and its workers
    with tempfile.TemporaryDirectory(prefix="witness_") as d:
        report_dir = os.path.join(d, "reports")
        env = dict(os.environ, RAY_TPU_TORCH_LOCKWITNESS="1",
                   RAY_TPU_TORCH_LOCKWITNESS_DIR=report_dir,
                   PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        spec = {"engine": engine, "prompts": prompts, "new_tokens": WITNESS_NEW_TOKENS,
                "wait_s": WITNESS_WAIT_S}
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", WITNESS_DRIVER, json.dumps(spec)],
                                cwd=repo, env=env, stdout=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, _ = proc.communicate(timeout=3 * WITNESS_WAIT_S)
        finally:
            try:  # whatever of its session is left
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        row["witnessed_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"{phase}: the witnessed drive exited {proc.returncode}")
        reports = [open(p).read() for p in sorted(glob.glob(os.path.join(report_dir, "*.json")))]
    lines = [ln for ln in stdout.splitlines() if ln.startswith("WITNESSED ")]
    check(bool(lines), f"{phase}: the witnessed drive printed no result")
    got = json.loads(lines[-1].split(" ", 1)[1])
    check(not reports and got["cycles"] == 0,
          f"{phase}: lock-order cycles reported: {reports[:2]}")
    check(any("node.shard" in e for e in got["edges"]),
          f"{phase}: no nested acquisition on a node.shard lock: {got['edges']}")
    check(got["grant"] == "0", f"{phase}: replica grant {got['grant']!r}")
    check(got["outs"] == want, f"{phase}: the witnessed replica's streams differ from the "
                               "unwitnessed engine's")
    launches = got["launches"]
    check_tensor_cores(phase, launches, cfg.n_layers * got["admissions"])
    raylint_rows = [r for r in got["doctor_rules"] if r.startswith("raylint/")]
    check(not raylint_rows, f"{phase}: doctor --static names {raylint_rows}")

    # (c) the raylint gate over the checkout
    t0 = time.perf_counter()
    lint = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "lint", "--json"], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    row["lint_s"] = time.perf_counter() - t0
    check(lint.returncode == 0, f"{phase}: lint exited {lint.returncode}: {lint.stdout[-2000:]}")
    gate = json.loads(lint.stdout)
    emit(phase, perf_rows=perf, perf_floors=PERF_FLOORS,
         witness={"wrapped_at_import": got["wrapped"], "edges": len(got["edges"]),
                  "node_shard_edges": sorted(e for e in got["edges"] if "node.shard" in e),
                  "cycles": got["cycles"], "reports": len(reports)},
         model="gpt2 125M bf16, one num_gpus=1 replica, witnessed",
         engine={k: v for k, v in WITNESS_ENGINE.items() if k != "prefill_buckets"},
         requests=len(prompts), new_tokens_per_req=WITNESS_NEW_TOKENS,
         streams_equal_unwitnessed_engine=True, admissions=got["admissions"],
         flash_launches=launches.get(attn.KERNEL, 0),
         flash_launches_tensor_core=launches.get(attn.FWD_TC, 0),
         head_up_s=got["head_up_s"], deploy_s=got["deploy_s"],
         requests_wall_s=got["requests_wall_s"], doctor_static_s=got["doctor_s"],
         doctor_rules=got["doctor_rules"], lint_ok=gate["ok"],
         lint_baselined=len(gate["baselined"]), **row,
         phase_s=time.perf_counter() - t_phase, card=card)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 2
    global attn, build
    from ray_tpu_torch.ops import _build as build
    from ray_tpu_torch.ops import attention as attn

    phase_device(build)
    fwd = phase_kernels()
    bwd = phase_bwd_kernels()
    dec = phase_decode_kernel()
    phase_parity()
    phase_bert_parity()
    phase_train_parity()
    phase_mlp()
    build.reset_launches()
    phase_rl_parity()
    rl_parity_launches = dict(build.launches)
    rl_launches, rl_local_steps_per_s = phase_rl_ppo_atari()
    torch.cuda.empty_cache()
    serve_gpt2, params, cfg, serve_gpt2_row, serve_gpt2_outs = serve("gpt2")
    n_slots = SERVE["n_slots"] + 1
    max_len = SERVE["prefill_buckets"][-1] + NEW_TOKENS + SERVE["decode_chunk_steps"]
    phase_decode_profile(params, cfg, n_slots, max_len)
    del params
    serve_llama = serve("llama")[0]
    import tempfile

    # serve_bert's checkpoint is read again by batch_predict_bert; it goes
    # with this block, whichever phase in it fails
    with tempfile.TemporaryDirectory(prefix="serve_bert_") as bert_root:
        bert_launches, served_bert = serve_bert(bert_root)
        torch.cuda.empty_cache()

        from ray_tpu_torch.models import gpt2, llama
        state, step, batch, train_launches, gpt2_row = train(
            "gpt2", gpt2.GPT2Config.gpt2_small(), TRAIN_BATCH, TRAIN_WARMUP, TRAIN_WINDOWS)
        phase_train_profile(state, step, batch, sorted(gpt2_row["ms_per_step_by_window"])[1])
        del state, step, batch
        torch.cuda.empty_cache()
        _, _, _, llama_launches, _ = train("llama", llama.LlamaConfig.llama_125m(), LLAMA_BATCH,
                                           LLAMA_WARMUP, LLAMA_WINDOWS)
        torch.cuda.empty_cache()
        moe_cfg = gpt2.GPT2Config.gpt2_small(n_experts=MOE_EXPERTS)
        state, step, batch, moe_launches, row = train(
            "gpt2", moe_cfg, TRAIN_BATCH, MOE_WARMUP, MOE_WINDOWS, phase="train_gpt2_moe")
        busy_ms = phase_train_profile(state, step, batch, row["ms_per_step_by_window"][0],
                                      phase="train_gpt2_moe_profile",
                                      model=f"{row['model']}, B {TRAIN_BATCH} x T {moe_cfg.max_seq_len}")
        del state, step, batch
        torch.cuda.empty_cache()
        layer = moe_layer_ms(moe_cfg, TRAIN_BATCH, moe_cfg.max_seq_len)
        # under remat "dots" each layer's MoE FFN runs forward, then forward
        # again and backward (its bmm outputs are not saved); the dense FFN's
        # mm outputs are saved, so the same sum is an upper bound for it
        per_step = {k: moe_cfg.n_layers * (layer[f"{k}_fwd_bwd_ms"] + layer[f"{k}_fwd_ms"])
                    for k in ("moe", "dense")}
        emit("train_gpt2_moe_layer", shape=f"B {TRAIN_BATCH} x T {moe_cfg.max_seq_len} x D "
             f"{moe_cfg.d_model}, {moe_cfg.n_experts} experts of d_ff {moe_cfg.d_ff}", **layer,
             moe_ms_per_step=per_step["moe"], dense_ffn_ms_per_step=per_step["dense"],
             moe_share_of_step_device_work=per_step["moe"] / busy_ms,
             step_device_work_ms=busy_ms)
        torch.cuda.empty_cache()
        sharded_launches, mesh = phase_train_gpt2_sharded()
        torch.cuda.empty_cache()
        phase_ring_attention_card(mesh, fwd)
        del mesh
        gc.collect()
        torch.cuda.empty_cache()

        import ray_tpu_torch as rt

        # the compiled graph's spans reach the head's table within a flush
        os.environ.setdefault("RAY_TPU_TORCH_EVENTS_FLUSH_S", "0.5")
        try:
            phase_core_gpu_actor(rt)
            phase_train_mlp_trainer(rt)
            trainer_launches, trainer_row = phase_train_gpt2_trainer(rt, gpt2_row)
            phase_data_ingest(rt)
            dataset_launches = phase_train_gpt2_dataset(rt, gpt2_row, trainer_row)
            predict_launches, predict_rates = phase_batch_predict_bert(rt, served_bert)
            rl_runtime_launches, ppo_runtime_steps_per_s = phase_rl_ppo_atari_runtime(
                rt, rl_local_steps_per_s)
            tune_launches = phase_tune_gpt2_trainer(rt, trainer_row)
            appo_launches = phase_rl_appo_atari_runtime(rt, ppo_runtime_steps_per_s)
            multiagent_offline_launches = phase_rl_multiagent_offline()
            from ray_tpu_torch import serve as rt_serve

            try:
                rt_serve.start(rt_serve.HTTPOptions(host="127.0.0.1", port=0))
                bert_http_launches = phase_serve_bert_http(rt, rt_serve)
                llm_launches = phase_serve_llm_deployment(rt, rt_serve, serve_gpt2_row,
                                                          serve_gpt2_outs)
            finally:
                rt_serve.shutdown()
            graph_launches = phase_prefill_decode_graph(rt)
        finally:
            rt.shutdown()
        pool_launches = phase_util_pool_bert_accounting(served_bert, predict_rates)
    pipeline_launches = phase_multinode_pipeline_gpt2()
    gc.collect()
    torch.cuda.empty_cache()
    watch_launches = phase_watch_pipeline_gpt2()
    gc.collect()
    torch.cuda.empty_cache()
    operator_launches = phase_operator_job_gpt2()
    gc.collect()
    torch.cuda.empty_cache()
    durable_launches = phase_durable_job_gpt2()
    gc.collect()
    torch.cuda.empty_cache()
    front_door_launches = phase_tenant_front_doors_gpt2()
    gc.collect()
    torch.cuda.empty_cache()
    witness_launches = phase_core_perf_witness_gpt2()

    runs = {"serve_gpt2": serve_gpt2, "serve_llama": serve_llama, "serve_bert": bert_launches,
            "train_gpt2": train_launches, "train_llama": llama_launches,
            "train_gpt2_moe": moe_launches, "train_gpt2_sharded": sharded_launches,
            "train_gpt2_trainer": trainer_launches,
            "train_gpt2_dataset": dataset_launches, "batch_predict_bert": predict_launches,
            "serve_bert_http": bert_http_launches, "serve_llm_deployment": llm_launches,
            "prefill_decode_graph": graph_launches,
            "multinode_pipeline_gpt2": pipeline_launches,
            "watch_pipeline_gpt2": watch_launches,
            "operator_job_gpt2": operator_launches,
            "durable_job_gpt2": durable_launches,
            "tenant_front_doors_gpt2": front_door_launches,
            "core_perf_witness_gpt2": witness_launches,
            "util_pool_bert_accounting": pool_launches,
            "rl_parity": rl_parity_launches,
            "rl_ppo_atari": rl_launches, "rl_ppo_atari_runtime": rl_runtime_launches,
            "tune_gpt2_trainer": tune_launches, "rl_appo_atari_runtime": appo_launches,
            "rl_multiagent_offline": multiagent_offline_launches}
    for r in (fwd, *bwd.values()):
        kern = r["name"]
        r["launches_by_path"] = {path: n.get(kern, 0) for path, n in runs.items()
                                 if kern == attn.KERNEL
                                 or path.startswith(("train", "tune", "rl_"))}
        r["launches"] = sum(r["launches_by_path"].values())
        # equal to launches: train() and serve() checked it
        tc = attn.TENSOR_CORE_COUNTER[kern]
        r["launches_tensor_core"] = sum(n.get(tc, 0) for n in runs.values())
    dec["launches_by_path"] = {path: n[attn.DECODE_KERNEL] for path, n in runs.items()
                               if n.get(attn.DECODE_KERNEL)}
    dec["launches"] = sum(dec["launches_by_path"].values())
    print(json.dumps({"kernels": [fwd, *bwd.values(), dec]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
