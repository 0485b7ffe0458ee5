#!/usr/bin/env python
"""Chip smoke for the PyTorch/CUDA port (``skycomputing_tpu_torch``).

Runs on one NVIDIA GPU (built for an H100, ``sm_90a``) and fails without
one.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``skycomputing_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, started together), one ``ptxas`` line per
   kernel instantiation (registers, spill bytes, static shared memory);
   the tensor-core (bf16 and 3xTF32), decode and register-tile bodies
   must not spill;
3. each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, with kernel / plain / library times and the
   bound: paged attention at GPT-2 small's shapes (decode waves,
   speculative-verify waves, prefill waves at R=4 and Lq 32, 128 and 256,
   a chunked-prefill wave at Lq=64 with every row past index 0) over
   fp pages (kernel B2) and over int8 pages with per-page-per-head
   scales (kernel B3), and B2 in float32 at phase 33 (a)'s geometry
   (pages of 8 in tables of 16 pages: the decode specialist's decode
   wave of 16 rows over its 128-page pool, a 32-page replica's decode
   wave of 8 rows and its prefill wave of one row at Lq=96) and at
   phase 34 (b)'s (pages of 16 in tables of 8 pages over a 32-page
   pool: a decode wave of 8 rows, and a prefill wave of one row at
   each bucket, Lq=16 on the decode body, 32, 48 and 112 on the
   register-tile body); flash
   attention (kernel B1) at BERT-large's
   microbatch (B=8, L=128, H=16, D=64, a padded tail of 32 keys), at
   L=512, at L=100 and at phases 27-28's dp shard (B=4, L=128), float32
   on the 3xTF32 tensor-core body, whose rows add its bound at the TF32
   peak beside the FFMA bound; then, checked but not timed, each kernel
   body's edges (B1 at L=7, 64 and 65, head_dim 32, 36, 40 and 128,
   B=1, every key masked, float32 against the plain version evaluated
   in float64; B2 and B3 with a row at index 0, a row filling its whole
   table, a row at index 20 and an all-sentinel pad row, head_dim 64
   and 128, pages of 16 at Lq 1, 5, 16, 17, 63, 64, 65 and 256, pages of
   4 and 8 at Lq 17, 33 and 64).  Every row names the body that served
   it and what ``ptxas -v`` reported for that body (registers, spills,
   shared memory) beside its dynamic shared memory.  At each float32
   prefill and chunk row (the register-tile body) the query-tile body it
   replaced runs the same call too: its error, its ``ptxas`` figures and
   its time, the two bodies timed in turns, the register-tile body
   required to be the faster; and B1's CUDA-core body timed at its own
   head_dims (float32 at 36, bf16 at 40; B=4, L=128, H=16) beside its
   bound (``flash_bound``: bf16 at the tensor cores' peak, float32 at
   the 3xTF32 bound with the FFMA bound beside it) and SDPA's time;
4. the serving path: GPT-2 small (full width, 12 layers, random weights
   from a seed) served by the paged ``ServingEngine`` — 16 requests,
   four sharing a 64-token prefix — with every kernel's launch count
   read from that run alone, by body too: every prefill wave on the
   tensor-core body, every decode tick on the decode body (likewise
   in phases 5-7);
5. the same workload with ``kv_dtype="int8"`` (kernel B3 in every
   layer of every step, B2 never), beside the fp run's numbers;
6. speculative decoding (``spec_k=4``, ``draft_blocks=2``) over fp
   pages and over int8 pages (B2 / B3 at ``Lq = 5``);
7. chunked prefill (``prefill_chunk=64``), and a swap preemption under
   int8;
8. card against CPU: the same port at full width, depth 2, float32,
   greedy, must give identical token streams on ``cuda`` and ``cpu``;
   over int8 pages, run in lockstep with the CPU's tokens fed to both,
   the card must choose the CPU's token at at least 95% of positions
   (the free-running streams' agreement is reported); speculative
   streams on the card must equal the card's plain streams;
9. a profiler breakdown of one prefill wave and of a few decode ticks,
   fp and int8 (device time by kernel, the card's idle share), and what
   the KV write (the int8 quantize-on-write, the fp scatter) costs per
   tick;
10. bf16 flash on against off: BERT-large's width at depth 2, two
    steps in bfloat16 with ``use_flash_attention`` on (B1's
    tensor-core body inside the model) and off (the einsum path) from
    the same weights: losses within 2e-2 relative;
11. the training path: BERT-large (24 encoder layers as 75 units, seq
    128, batch 32, bf16 compute, flash attention, random weights from a
    seed) over 4 workers on the card, even allocation, GPipe with 4
    microbatches, SGD 1e-3, ``Runner.train`` for 5 steps: finite
    losses, step time, tokens/s, MFU, peak memory, and B1 launched
    exactly 2 x 24 x 4 = 192 times per step (forward and
    rematerialized forward), read from that run alone;
12. trainer card against CPU: the same pipeline at depth 2 in float32,
    two steps on ``cuda`` and on ``cpu`` from the same weights and
    batch: losses within 1e-4 relative, parameters within 1e-5, every
    B1 launch on the card on the float32 tensor-core body;
13. a profiler breakdown of one train step (device time by kernel, the
    card's idle share, B1's share, the weight casts' launches);
14. the profilers: the static (FLOPs on the ``meta`` device) and the
    timed (forward + backward seconds on the card) ``ModelBenchmarker``
    over BERT-large's 75 units at batch 32, seq 128 — six distinct
    units, none at 0, equal memory estimates, B1 launched while timing —
    and the ``DeviceBenchmarker`` over four workers on the card
    (``MatmulStack`` 1024 x 4 on (256, 1024): timed once, free memory
    from ``mem_get_info``);
15. the launcher's path: ``launch.run`` on
    ``skycomputing_tpu_torch/configs/bert_pipeline.py`` — BERT-large at
    24 layers, seq 128, batch 32, flash on, on the config's GLUE
    dataset (its seeded synthetic MNLI corpus: lengths 8-128, padded
    tails), 4 workers on the card with
    the stimulator, ``optimal`` allocation from the static profile, 1F1B
    with 4 microbatches, 5 steps, with the stop, timer and checkpoint
    hooks: the runner's pre-flight verified the plan once before the
    first step (an ``ok`` report over coverage, shapes, memory and
    donation; its seconds printed), the partition is the solver's,
    contiguous and not the even split, every loss finite, B1 launched
    exactly 192 times per step;
    the checkpoint restores its parameters under ``even_allocate``
    (equal) and its optimizer state is refused there; step time,
    tokens/s, MFU and peak memory beside the GPipe phase's;
16. the headline pass as ``bench.py`` runs it at this scale
    (``dynamics/headline.py:headline_pass``): four workers with the
    paper's slowdowns (3, 5, 3, 6), even allocation and
    ``measure_stage_times``, ``calibrate_costs_by_group`` from the even
    pass (one scale each for the encoder stack, the embeddings and the
    two end units), ``optimal_allocate`` and ``measure_stage_times``
    again; each
    raw stage time times its worker's slowdown gives the emulated step
    time (``schedule_step_time``) at 4 and 16 microbatches; the even
    allocation is measured in the order even, optimal, optimal, even
    and each side's step is the mean of its two; the optimal step must
    be below the even one at both;
17. the GLUE path: a vocabulary and MNLI ``train.tsv`` /
    ``dev_matched.tsv`` written from a seed under ``build/``, then
    ``launch.run`` on the port's config pointed at them
    (``SKYTPU_GLUE_DIR``, ``SKYTPU_VOCAB_FILE``) with ``EvalHook``,
    ``MetricsHook`` and ``NanGuardHook``: 5 steps, one evaluation at the
    epoch's end, a metrics JSONL of a ``run_start`` header and one line
    per step, the pre-flight checked as in phase 15; then ``Runner.evaluate(dev, task="mnli")`` over the 100
    dev rows (3 batches of 32 and one of 4): a finite loss, accuracy in
    [0, 1], every row counted, and B1 launched exactly 24 times per
    batch (an eval-mode forward, no rematerialization), read from that
    window alone; a profile of one eval batch (the card's idle share,
    B1's share); and, at BERT-large's width, depth 2, float32, the same
    evaluation on the card and on the CPU from the same weights: losses
    within 1e-4 relative, equal predictions, every B1 launch on the card
    on the float32 tensor-core body;
18. the bench: ``python -m skycomputing_tpu_torch.bench`` as a
    subprocess at its defaults (64 workers with the paper's slowdowns,
    BERT-large at 53 encoder layers as 215 units at ffn/2, M=256) under
    a 300 s deadline: exactly one JSON line on stdout, a complete run on
    the card
    (``partial`` null, a finite value) whose even and optimal
    partitions each cover every unit; its fields are printed, and how
    many pre-flight reports (one per allocation built) it wrote to
    stderr, the slowest of them;
19. pre-flight, tracing and self-heal: the trainer's BERT-large (75
    units, flash on, dropouts 0) evenly over 4 workers by an
    ``Allocator`` over the static profile, GPipe M=4.  A plan tampered
    after the build (worker 0's last unit dropped) is refused by
    ``Runner.train`` with ``PlanError`` (coverage) at iteration 0 and
    no B1 launch; then a fresh ``Runner`` trains 20 steps with
    ``TraceHook``, ``FaultInjectionHook`` (worker 0 6x slower from
    iteration 4) and ``SelfHealHook`` on real clocks: pre-flight runs
    before step 1 and again after the heal (both ``ok``), one heal whose
    largest divergence is worker 0's, worker 0 sheds units and the cover
    stays whole, every loss finite, B1 launched 192 times in every step
    on both sides of the heal, the post-heal steps faster than the
    straggler era's; the trace is strict JSON, holds 4 stage lanes
    before the heal, M x stages ``fwd`` and ``bwd`` and one ``update``
    per stage in every ``iter`` span, a ``self_heal`` arc closed as
    ``healed`` and one ``host_dispatch`` span per step.  Printed: step
    medians (baseline, straggler, after the heal), the heal's cost
    (measure, solve, rebuild), the partitions, the pre-flight seconds,
    bubble fraction and dispatch share, peak memory, and the step with
    tracing on against 5 untraced steps.  The trace is written to
    ``chiprun_out/selfheal_trace.json``;
20. serving allocation and multi-stage serving: GPT-2 small (26 units,
    bf16) profiled for decode by ``DecodeModelBenchmarker`` at the
    serving phases' operating point (16 rows, 512-token span, 512 pages
    of 16; fp and int8) and partitioned by ``Allocator.serving_allocate``
    over four workers with the launcher phase's stimulated speeds and
    budgets of 1,000 MB over the stimulator's memory draws (they bind:
    the partition is printed with each stage's charged MB against its
    budget, and the fp and int8 pages must give different partitions);
    ``ServingEngine(worker_manager=wm)`` serves the 16-request workload
    as those stages on the card (the pre-flight passing first), with
    streams, scheduling and each body's launches equal to phases 4 and
    5; speculation (``spec_k=4, draft_blocks=2``) over ``partition=[7, 7,
    6, 6]`` (the draft inside stage 0) equal to phase 6's fp run; a
    ``reconfigure`` to 384 pages at tick 3 (every running request
    re-seated by recomputation, every stage's slabs rebuilt; the card's
    memory before, at its peak during and after) and to buckets up to
    512 at tick 10 (no eviction), at four stages and at one, on equal
    streams and launches; and a worker manager whose stage with the
    most pages gets its units' MB plus half its pages is refused by the
    pre-flight with ``torch.cuda.memory_allocated`` unchanged.  Printed:
    tokens/s, TTFT and TPOT p50/p95 and peak memory, stages against one
    in turns (4, 1, 1, 4 stages, fp and int8; a process's later phases
    run slower than its first, so phases 4-5 are no baseline for these).

21. the serving bench (``skycomputing_tpu_torch/bench_serving.py``): its
    six sections called in-process at its full-run operating points on
    GPT-2 small (12 layers, hidden 768, vocabulary 50,257; the spec
    section on its own 1,024-token vocabulary), float32, random weights
    from the seed — continuous against static batching (slot layout),
    paged against slot at equal pool MB with shared-prefix TTFT, the
    chunked backlog, speculative decoding (draft exact), the live table
    width against the full one and int8 pages — and the kernel section
    again in bf16 (the tensor-core prefill bodies); one JSON line per
    section (gates, headline numbers, B2/B3 launches by body, counted
    from 0 per section).  Every mechanics gate is asserted (token
    identity with the one-shot ``generate``, equal pool MB, counters, no
    kernel library built in a measured window); the timing and int8
    fidelity gates (and the bf16 rerun's identity gates) are printed
    with their values.  Every float32 prefill and chunk wave runs on the
    register-tile body and none on the query-tile body (asserted per
    section).  Then the kernel against its plain version on the bench's
    tiny instance (``kernel_matches_plain``, asserted; its launches not
    counted);
22. the launcher under ``SKYTPU_MODEL=gpt`` (``launch.run`` on the
    port's config): GPT at BERT-large's width (hidden 1,024, 16 heads,
    bf16), 10 blocks, vocabulary 50,257, ``RandomLmDataset`` rows of 128
    in batches of 32, 4 stimulated workers, ``optimal`` over the static
    profile (the ``DataloaderGenerator`` probe), 1F1B with 4
    microbatches, 5 steps of the config's SGD, ``CausalLmLoss``: the
    pre-flight ``ok``, the partition the solver's, no kernel launched
    (dense attention, as in JAX), 5 finite losses, and the run's first
    batch's loss (``Runner.evaluate``, before the first step and after
    the last) falling.  Printed: the partition, each step's time, the
    median of steps 2-5, tokens/s, MFU, peak memory and the losses;
23. long-context BERT through B1: first B1 against its plain version at
    B=1, H=16, D=64 with the last tenth of the keys padded, bf16 at L =
    1,024, 2,048 and 4,096 (the tensor-core body, within 2e-2) and
    float32 at 2,048 and 4,096 (the 3xTF32 body, within 1e-4; 4,096
    is phase 26's single-device baseline), each timed as in
    phase 3 beside its bound and SDPA's time; then ``launch.run`` on a
    config of ``long_bert_layer_configs`` at BERT-large's width (hidden
    1,024, 16 heads, intermediate 4,096, bf16), rows and positions of
    4,096 (``RandomBertDataset``, padded tails), hidden dropout 0.1,
    attention dropout 0, 4 encoder units (15 units), batch 2, GPipe
    M=2, 4 stimulated workers, ``optimal`` on the static profile, 3
    steps of SGD at 1e-3: B1 launched 16 times in every step (4 heads x
    2 microbatches, forward and rematerialized forward), the first
    batch's loss (``Runner.evaluate`` before the first step and after
    the last) finite.  Printed: step times, tokens/s, MFU, peak memory,
    the partition and the losses;
24. MoE GPT: ``launch.run`` on GPT-2 small's width (hidden 768, 12
    heads, intermediate 3,072, vocabulary 50,257, bf16), 12 blocks with
    every second MLP a ``GptBlock_MoeMlp`` of 8 experts (top-2,
    capacity 1.25), ``RandomLmDataset`` rows of 128 in batches of 32, 4
    stimulated workers, ``optimal`` on the static profile, 1F1B M=4, 5
    steps of SGD at 1e-3: no kernel, the first batch's loss falling.
    Printed: step times, tokens/s, peak memory, the share of routed
    choices dropped over capacity in step 1, the losses;
25. ResNet-50 on CIFAR-10's shapes: ``launch.run`` on
    ``resnet_layer_configs("BottleNeck", [3, 4, 6, 3])`` (float32),
    ``CIFAR10Dataset``'s synthetic fallback in batches of 128, 4
    stimulated workers, ``optimal`` on the static profile, GPipe M=4, 5
    steps of SGD at 1e-3: no kernel, the first batch's loss falling.
    Printed: step times, images/s, peak memory, the losses;
26. sequence parallelism, with a mesh of 4 positions all on the card
    (so its moves are copies on one device, and no link is measured):
    ring attention and Ulysses at B=1, L=4,096, 16 heads of 64, the
    last tenth of the keys padded, in float32 against
    ``full_attention_reference`` (max abs error <= 1e-4) and in bf16
    against B1 (``BF16_LONG_TOL``), each timed with its peak memory;
    then long BERT at BERT-large's width, L=4,096, 4 encoder units,
    float32, batch 2, GPipe M=2, 3 SGD steps with every head on the
    ring, against the same steps through B1 (``mesh=None``) from the
    same weights (losses within 1e-4 relative; B1 16 a step in the
    baseline, never on the ring); GPT-2 small's width (float32, 2
    blocks) at L=1,024 with causal ring attention against the dense
    stack (logits within 1e-4).  Printed: step times, peak memory, B1's
    launches, by body (all float32 ones on the 3xTF32 body, here and
    in phases 27-28);
27. data-parallel replicas: ``DataParallelPipeline`` with 2 replicas
    of the launcher's BERT-large pipeline (24 layers as 75 units, flash
    on, float32, 4 workers each, every position on the card), batch 32
    x 128, 1F1B M=4, 3 SGD steps, against one ``PipelineModel`` on the
    whole batch from the same weights: losses within 1e-4 relative,
    parameters within 1e-5, the replicas bitwise identical, B1 384
    times a step.  Printed: step times, B1 launches, peak memory;
28. mesh-native stages: ``Allocator.mesh_allocate`` over 4 stimulated
    workers and 8 positions on the card (at most 4 stages of 2), the
    plan held by ``verify_mesh_payload`` and a broken payload refused;
    ``MeshPipelineModel`` on that plan (each stage's microbatch rows
    split over its 2 positions), 1F1B M=4, 3 SGD steps; then at one
    position per stage against ``PipelineModel`` on the same allocation,
    2 steps each in turns: whether the parameters are bitwise equal,
    and their largest difference (within 1e-5);
29. the compiled SPMD pipelines (``parallel/spmd.py``,
    ``parallel/spmd_gpt.py``), every mesh position on the card, SGD at
    1e-3 on a fixed seeded batch of 32 x 128: (a) BERT-large's width
    (24 encoder units, bf16, flash on) under GPipe on dp=2 x pp=4, 6
    units a stage, M=4, 5 steps at 1e-4 (at 1e-3 the fixed batch's loss
    rises, as in phases 27-28) — B1 exactly 24 x 4 x 2 x 2 = 384 times
    a step (units x microbatches x dp x forward and remat), all on the
    tensor-core body, the loss falling; (b) interleaved, V=2 on pp=4 (3
    units a chunk) at M=4 (the wavefront) and M=8 (the grouped
    schedule), 3 steps each, B1 24 x M x 2 a step; (c) ZeRO-3 with Adam
    on (a)'s mesh, 3 steps, each position's parameter and state bytes
    against the replicated layout's; (d) tensor parallelism on dp=2 x
    pp=2 x tp=2, 3 steps, no B1 launch (einsum attention, as JAX's TP
    stage); (e) GPT-2 small's width, 12 blocks: dense on pp=4, MoE
    (every second block of 8 experts, top-2) on pp=2 and on pp=2 x tp=2
    (a stage's blocks must be a multiple of the MoE period), 3 steps
    each; (f) depth 2, float32, dp=2 x pp=2: one step on the card and on
    the CPU from the same weights, loss and every parameter within 1e-5,
    and each leaf's reduced gradient within 1e-3 of the CPU's in norm,
    B1 on the 3xTF32 body; (g) (a)'s weights in float32 at pp=4 against
    ``PipelineModel`` (GPipe, M=4) on the same per-layer weights: each
    layer's gradient within 1e-3 of the stages' in norm, loss and
    parameters after one step within 1e-5, three steps of each timed in
    turns.  Printed: each run's step times (median of steps 2 on),
    tokens/s, peak memory, losses and B1's launches by body, beside
    phases 27-28's steps.
30. multihost, heartbeat and elastic (``parallel/multihost.py``,
    ``heartbeat.py``, ``elastic.py``, ``HeartbeatHook``,
    ``SelfHealHook(mode="exit")``), each run in processes of its own
    that this script starts (``--elastic-child ROLE``, below) and
    kills at the end: (a) a world of one under NCCL on the card
    (``initialize_from_env`` through ``SKYTPU_COORDINATOR``), its
    ``global_mesh(("dp",), (1,))``, 50 ``PeerHeartbeat`` beats (median
    and p95 in ms), and a ``HeartbeatHook`` beat dropped by a
    ``drop_beat`` fault; (b) peer death under gloo (NCCL puts no two
    ranks of one communicator on one card): two processes beat, rank 1
    exits, the survivor's next beat detects it (the seconds printed);
    (c) an ``ElasticSupervisor`` over a trainer of BERT-large's width
    (bf16, flash on) cut to 8 layers (27 units), 4 stimulated workers
    on the card, under ``Runner`` with ``HeartbeatHook(interval=1)``
    (a world of one, NCCL), worker 0 6x slower from iteration 3 and
    ``SelfHealHook(mode="exit")`` (stage times the median of 3
    samples; worker 0 must read the largest divergence): the trainer
    exits ``REALLOC_RC``,
    the supervisor re-forms generation 1 with the staged payload, and
    the relaunched trainer validates it, applies the device scales,
    solves ``optimal_allocate`` (worker 0 must shed units), loads the
    snapshot (every parameter bitwise) and trains on to iteration 11;
    the iterations continuous, B1 on the tensor-core body in every
    step of both generations, no kernel library loaded inside the
    steps, and the seconds from the exit to generation 1's first
    step; (d) JAX's ``test_elastic_reform.py`` scenario with its trainer
    on the card: two supervisors under gloo, node 1's trainer dies at
    iteration 2, the survivor re-forms as ``[0]`` and resumes from the
    checkpoint, the losses falling across the boundary.  The
    children's logs and JSON go to ``chiprun_out/elastic/``.
31. the measuring tools (``skycomputing_tpu_torch/tools/``): their
    commands' ``main`` in a process of their own on the card
    (``--tools-child OUT``, below; the ladder as ``python -m
    skycomputing_tpu_torch.tools.run_ladder``, which starts its rungs'
    processes), their output under ``chiprun_out/tools/``: (a)
    ``bench_step_overhead`` (its module constants ``STEPS=3,
    ROUNDS=2``: dispatch against device wait under both schedules,
    tracing's cost, a traced window kept), then ``--mesh``: held, the
    bitwise equivalence leg; printed, every other gate and its verdict;
    (b) ``validate_schedule_model`` at BERT-base (the composition and
    fill-drain deltas, printed); (c) ``bench_kv_cache`` at GPT-2 small:
    the tokens identical (held), ms per token both ways; (d) in this
    process, ``utils.profiling.trace`` of 3 rounds of one B1 bf16 call
    and one decode tick of the paged engine at GPT-2 small: the trace's
    kernels include ``flash_attention_kernel_mma`` and
    ``paged_attention_kernel_decode``, 3 B1 launches and 36 decode
    launches (held); ``trace_report``'s ``main`` (a file, no device)
    over (a)'s window (``--json``, then ``--baseline`` against its own
    JSON, exit 0); (e) ``bench_mfu`` at its defaults (BERT-large, 32 x
    128, bf16); (f) ``profile_allocation`` over the launcher config
    with ``SKYTPU_FLASH=1 SKYTPU_PROFILE=timed STIMULATE=1``, B1's
    launches in the timed profile all on the tensor-core body; (g)
    ``run_ladder --only even_4 optimal_8`` at ``SKYTPU_FLASH=1``, 2
    iterations (BERT-large's width, 10 layers): each rung exits 0 with
    finite losses, B1 on the tensor-core body in every step, the
    optimal rung's 8 stages covering all 33 units; (h) a
    reference-style checkpoint at BERT-large's width (2 layers, 9 units)
    from a seed: converted by ``convert_torch_checkpoint``'s ``main``,
    loaded, its logits on the card within 1e-4 of the CPU's (float32),
    and written back to the reference's layout bitwise;
32. the serving fleet (``python -m
    skycomputing_tpu_torch.tools.bench_fleet``'s kill-and-spike
    scenario) at GPT-2 small's width and depth, float32, three replicas
    over paged KV at page 16, each on the card, at the bench's own
    operating point (2 decode rows a replica, buckets 32/64/96,
    ``max_len`` 128, ``max_pending`` 12, bursts of 8 every 32 ticks,
    replica 0 crashed mid-run, then the 2x spike): (a) every accepted
    request token-identical to the one-shot ``generate`` on the card
    (a mismatch printed with its position and both logits), none
    failed, at least one migration and one re-form, every spike
    rejection counted by reason with a Retry-After, B2's decode and
    register-tile bodies launched in the fleet run and its plain
    version never called on the card (held); TTFT p95 before and after
    the kill, TPOT p95 steady and under the spike, tokens/s, the
    re-form's seconds (its ``fleet.reform`` span) and sheds by reason
    (printed: JAX's timing gates are 2x and 1.25x); (b) on the same run
    the flight recorder and the bench's two SLO targets: the crash
    opens a replica-outage incident whose bundle's cause chain is
    non-empty and whose digest verifies, and ``/metrics``,
    ``/metrics.json`` and ``/healthz`` scraped once mid-run on
    ``127.0.0.1`` show the fleet counters equal to ``fleet.stats``; (c)
    one replica at GPT-2 small's width, 2 blocks, under a TTFT target
    that burns: a verified ADD, then a drain-then-REMOVE, the accepted
    streams (the added replica's among them) token-identical to the
    reference;
33. disaggregated serving, the chaos plane and the workload player,
    every replica on the card, float32: (a) ``python -m
    skycomputing_tpu_torch.tools.bench_disagg``'s two topologies at
    GPT-2 small's width and depth and the bench's own operating point
    (buckets 32/64/96, ``max_len`` 128, ``prefill_batch`` 1, paged KV
    at page 8; 4 monolithic replicas against 3 prefill and 1 decode
    specialist of 4 slots and 128 pages) over ``disagg_mix`` at rate
    2.5, one replay each after its warm-up: every admitted request
    finished, every stream token-identical to the one-shot ``generate``
    on the card and the disagg streams equal to the monolith's (a
    mismatch printed with its position and both logits), each finished
    disagg request handed off once, the ledger conserved, one trace
    digest, ``handoff_bytes`` equal to the exported records' host
    bytes, B2's register-tile body launched on the prefill replicas and
    its decode body on the decode replica, each at a geometry phase 3
    held against the plain version, its plain version never called on
    the card (held); TTFT and TPOT p95 of both topologies
    beside JAX's "both improve" verdict, tokens/s, handoffs and their
    bytes, the export and import seconds a record (printed); (b)
    ``bench_chaos``'s ``prefill_kill_mid_handoff`` (a corrupted
    handoff, the prefill specialist killed with records in flight) on
    a disaggregated fleet at GPT-2 small's width, 2 blocks: faults
    applied, a poisoned record refused at import and recomputed, the
    audit passing every check against the fault-free run within the
    plan's recovery budget, both same-seed runs' logs and audit digests
    equal; (c) its ``swap_corruption`` on a monolithic fleet at the
    same size: corrupt swap records caught and recomputed, the same
    audit and determinism; (d) ``bench_scenarios``' ``diurnal_ramp``,
    autoscaled against fixed, at the same size: a scale-up, the run
    ending at ``min_replicas``, token identity, one trace digest
    (held), SLO burn per request served on both sides (printed).
34. the closed tuning loop: (a) ``Runner.train`` with ``AutotuneHook``
    (and its own tracer) on a BERT pipeline at BERT-large's width (bf16,
    flash on, 8 encoder units), 3 workers on the card, worker 0 at
    ``slowdown`` 3, from homogeneous profiles: the trace's straggler
    signature becomes an ``allocation`` proposal, verified, applied
    through the rebuild path and settled on the next window (held); the
    partition before and after, the pre- and post-tune step p50 and B1's
    launches a step by body (printed; every launch on the tensor-core
    body, held); every rebuilt plan pre-flighted before its first step
    (held); (b) ``ServingAutotuner`` on a traced GPT-2 small engine
    (float32, 12 layers, paged) with a skewed bucket set under 40
    arriving requests: a proposal applied through ``reconfigure`` and
    settled, every stream token-identical to the one-shot ``generate``
    across it, B2 by body, its plain version never called on the card,
    every call's geometry one that phase 3 held against the plain
    version, and each of those rows called (held); (c) ``bench_flight``'s
    four gates at GPT-2 small's width, 2 blocks: detection, silence and
    determinism (held), the overhead gate (at most 2%, each mode's least
    wall over replays in turns) with the recorder's share of a replay
    beside it (printed, not held: the host's speed moves a replay by
    more than 2%), each cut printed; (d)
    ``trace_report --request`` on (b)'s trace: one request's waterfall
    across the reconfigure, exit code 0 (held).

The line before last is ``{"kernels": [...]}``, one entry per kernel
and body (B2's and B3's launches from their serving phases, phase 20
and phase 21; their register-tile entries from phase 21's float32
prefill and chunk waves; B1's from its BERT paths, at L=4,096 from
phase 23, and its float32 tensor-core body's, by body, from phases
27-28, beside its time at their 4 rows of 128, and from phase 26's
baseline, beside its time at 1 row of 4,096; its tensor-core body's in
phase 29's bf16 BERT runs, beside its time at (a)'s 4 rows of 128,
and in phase 30's supervised trainer, beside its time at 8 rows of 128;
phase 31's B1 tensor-core and B2 decode launches; phase 32's B2 decode
and register-tile launches, beside its float32 decode and prefill
times; phase 33's, by role, beside its float32 times at the geometry of
each of that phase's calls; phase 34's B1 tensor-core launches beside
its time at 8 rows of 128, and B2's launches at each of (b)'s call
geometries beside its float32 time at that geometry);
the last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Usage::

    python3 chip_smoke.py
    # phase 30 (c)'s heal measurement alone, repeated; --tree compares
    # another checkout of the port on the same card
    python3 chip_smoke.py --heal-probe [--tree DIR] [--tag TAG]
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
SEED = 0
LAYERS = 12
B1, B2, B3 = "flash_attention", "paged_attention", "paged_attention_int8"
F32_BODY = "tensor_core_f32"  # B1's float32 body on every main path


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        yield
    except Exception:  # every phase is fatal: report and stop
        traceback.print_exc()
        log(f"FAIL: phase '{name}'")
        sys.exit(1)
    log(f"   {name}: {time.perf_counter() - t0:.3f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)
    log(f"   ok: {msg}")


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


# a spinning kernel of ~2 ms at the H100's clock, queued ahead of a timed
# call so that the card is still busy while the host enqueues it
SPIN_CYCLES = 4_000_000


def time_ms(torch, fn, iters: int = 30, warmup: int = 3,
            host_ahead: bool = True) -> float:
    """Median time of ``fn`` on the card's clock in ms, each call timed
    alone with CUDA events after a 64 MiB write evicts the 50 MB L2 (a
    layer's pages come from device memory, not from the previous layer's
    L2).

    ``host_ahead`` (the default) queues the spin kernel before the start
    event, so the host has enqueued the whole call before the card
    reaches it: the span is the call's device time, not the host's time
    to launch it (a short kernel behind a Python wrapper would otherwise
    time the wrapper).  ``host_ahead=False`` times the span as a caller
    meets it, host launch time included."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if host_ahead:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_ms(torch, fn, iters: int = 30) -> float:
    """Median host time to issue ``fn`` in ms (the card kept busy by the
    spin kernel, so no call blocks); where it exceeds the device time,
    a caller issuing one call at a time waits on the host."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def spin_ms(torch) -> float:
    """The spin kernel's own time: ``host_ahead`` timing holds while the
    host issues a call in less."""
    return time_ms(torch, lambda: torch.cuda._sleep(SPIN_CYCLES), iters=5,
                   warmup=1, host_ahead=False)


# --------------------------------------------------------------------------
# kernel bodies and what ptxas said about them
# --------------------------------------------------------------------------

# template arguments as the compiler mangles them
_MANGLED_ARGS = (("13__nv_bfloat16", "bf16"), ("f", "f32"), ("a", "int8"))


def kernel_label(mangled: str) -> str:
    """``paged_attention_kernel_decode<bf16, int8, 1>`` for a mangled
    kernel name of the port (the mangled name where it is not one)."""
    found = re.search(r"\d+((?:flash|paged)_attention_kernel\w*?)I(.+?)EEv",
                      mangled)
    if not found:
        return mangled
    name, args = found.groups()
    out, i = [], 0
    while i < len(args):
        if args.startswith("S1_", i):  # the first type argument again
            out.append(out[0])
            i += 3
        elif args[i] == "L":  # an integer: Li<digits>E
            end = args.index("E", i)
            out.append(args[i + 2:end])
            i = end + 1
        else:
            for code, label in _MANGLED_ARGS:
                if args.startswith(code, i):
                    out.append(label)
                    i += len(code)
                    break
            else:
                return mangled
    return f"{name}<{', '.join(out)}>"


def ptxas_by_label(_build):
    """Every kernel instantiation's ``ptxas -v`` figures, by label."""
    return {kernel_label(fn): info
            for stem in sorted(p.stem for p in _build.CSRC.glob("*.cu"))
            for fn, info in _build.ptxas_report(stem).items()}


_SHORT = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}


def body_fields(ptxas, body, label, smem_bytes):
    """A kernel row's body: its name, the instantiation that ran, what
    ptxas reported for it and its dynamic shared memory per block."""
    info = ptxas.get(label, {})
    return dict(body=body, kernel_function=label,
                registers=info.get("registers"),
                spill_store_bytes=info.get("spill_store_bytes"),
                spill_load_bytes=info.get("spill_load_bytes"),
                static_smem_bytes=info.get("static_smem_bytes", 0),
                dynamic_smem_bytes=smem_bytes)


def paged_body(ptxas, q, page_dtype, table, page_size=16):
    """Which body of B2/B3 serves ``q`` over pages of ``page_dtype``."""
    from skycomputing_tpu_torch.ops.paged_attention import (
        kernel_plan,
        kernel_smem_bytes,
    )

    R, Lq, H, D = q.shape
    body = kernel_plan(q.dtype, page_dtype, Lq, D, page_size)
    kv = _SHORT[str(page_dtype).replace("torch.", "")]
    t = _SHORT[str(q.dtype).replace("torch.", "")]
    if body == "decode":
        max_q = 1 if Lq == 1 else (8 if Lq <= 8 else 16)
        label = f"paged_attention_kernel_decode<{t}, {kv}, {max_q}>"
    elif body == "tensor_core":
        label = f"paged_attention_kernel_mma<{kv}, {D}>"
    elif body == "register_tile":
        # the head-dim bound, and whether it is the head dim (1) or not
        d_max = 32 if D <= 32 else (64 if D <= 64 else 128)
        label = (f"paged_attention_kernel_tile<{t}, {kv}, {d_max}, "
                 f"{int(D == d_max)}>")
    else:
        label = f"paged_attention_kernel<{t}, {kv}>"
    return body_fields(ptxas, body, label, kernel_smem_bytes(
        body, page_dtype, Lq, D, page_size, table.shape[1]))


def flash_body(torch, ptxas, q):
    """Which body of B1 serves ``q``."""
    from skycomputing_tpu_torch.ops.flash_attention import (
        kernel_plan,
        kernel_smem_bytes,
    )

    B, L, H, D = q.shape
    plan = kernel_plan(q.dtype, B, L, H, D, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    if plan["body"] == "tensor_core":
        label = f"flash_attention_kernel_mma<{D}>"
    elif plan["body"] == "tensor_core_f32":
        label = f"flash_attention_kernel_tf32x3<{D}>"
    else:
        t = _SHORT[str(q.dtype).replace("torch.", "")]
        label = f"flash_attention_kernel<{t}, {4 if D <= 64 else 8}>"
    out = body_fields(ptxas, plan["body"], label, kernel_smem_bytes(plan, D))
    out["warps"] = plan["warps"]
    return out


# --------------------------------------------------------------------------
# phase 3: paged attention against its plain version
# --------------------------------------------------------------------------


# (case, R, Lq): decode and speculative-verify waves (the decode body),
# prefill waves at buckets 128, 256 and 32 and a chunked-prefill wave of
# 64 (bf16: the tensor-core body; float32: the register-tile body)
PAGED_CASES = (("decode", 16, 1), ("prefill", 4, 128), ("verify", 16, 5),
               ("prefill_256", 4, 256), ("chunk", 4, 64),
               ("prefill_32", 4, 32))
#: (page size, pool pages, table width) of the cases above
PAGES_16 = (16, 512, 32)


def disagg_cases():
    """B2's calls in phase 33 (a), at ``bench_disagg``'s operating point:
    (case, R, Lq, (page size, pool pages, table width), the roles whose
    replicas launch it).  Every engine's tables are 16 pages of 8 wide
    (the largest bucket's 12 pages, rounded up to a power of two); a
    decode wave spans the engine's ``max_concurrency`` rows (by default
    the lesser of its pool pages and 4 per slot); a prefill wave is
    ``prefill_batch`` rows at a bucket, the largest here.
    :func:`disagg_against_monolith` holds each geometry against the
    calls the phase makes."""
    from skycomputing_tpu_torch.tools import bench_disagg

    engine, decode = bench_disagg.ENGINE, bench_disagg.DECODE
    ps = engine["page_size"]
    width = engine["max_len"] // ps
    pool = engine["num_slots"] * width  # a replica's default pool
    return (
        ("disagg_decode", min(decode["num_pages"], 4 * decode["num_slots"]),
         1, (ps, decode["num_pages"], width), ("decode",)),
        ("disagg_replica_decode", min(pool, 4 * engine["num_slots"]), 1,
         (ps, pool, width), ("monolithic", "prefill")),
        ("disagg_prefill", engine["prefill_batch"], max(engine["buckets"]),
         (ps, pool, width), ("monolithic", "prefill")))


def attention_case(torch, np, name, R, Lq, dtype, seed, int8=False,
                   geometry=PAGES_16):
    """GPT-2 small heads (H=12, D=64); ``geometry`` is (page size, pool
    pages, table width), by default pages of 16, a 512-page pool and
    32-page tables.  Decode and verify waves (and any case named
    ``*_decode``): every fourth row inactive, the others live at
    positions 1..299, fewer where the pool could not hold every live
    row's pages at that length; prefill: 2 live rows (one appending
    after a 64-token prefix) and 2 pad rows, or one row at index 0
    where R is 1; chunk: 4 live rows, each appending a chunk after 64,
    128, 192 or 256 positions.  ``int8``: pages are N(0, 32) rounded
    and clipped to int8, scales U(0.02, 0.04) per (page, head), so the
    dequantized pages are of unit size like the fp ones."""
    H, D = 12, 64
    PS, P, W = geometry
    rng = np.random.default_rng(seed)
    pages = rng.permutation(P - 1)  # page P-1 is only ever a clamp target
    table = np.full((R, W), P, np.int32)
    index = np.zeros(R, np.int32)
    decode = name in ("decode", "verify") or name.endswith("_decode")
    # live rows' positions such that all their pages fit in the pool
    live = R - R // 4
    top = min(300, W * PS, (P - 1) // live * PS - Lq + 1)
    used = 0
    for r in range(R):
        if decode:
            if r % 4 == 3:
                continue  # inactive row: index 0, all sentinels
            index[r] = rng.integers(1, top)
        elif name == "chunk":
            index[r] = 64 * (r + 1)
        elif r >= 2:
            continue  # prefill pad row: index 0, all sentinels
        else:
            index[r] = 64 * r  # row 1 appends after a 64-token prefix
        n = (int(index[r]) + Lq - 1) // PS + 1
        assert used + n <= P - 1, (name, used, n, P)
        table[r, :n] = pages[used:used + n]
        used += n
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((R, Lq, H, D), np.float32))
    case = dict(q=q.to("cuda", dt), table=torch.from_numpy(table).cuda(),
                index=torch.from_numpy(index).cuda(), table_np=table,
                index_np=index, P=P, PS=PS, H=H, D=D, int8=int8)
    if int8:
        for name_ in ("k", "v"):
            vals = np.clip(np.round(32 * rng.standard_normal((P, PS, H, D))),
                           -127, 127).astype(np.int8)
            case[name_] = torch.from_numpy(vals).cuda()
            case[name_ + "_scale"] = torch.from_numpy(
                rng.uniform(0.02, 0.04, (P, H)).astype(np.float32)).cuda()
    else:
        for name_ in ("k", "v"):
            case[name_] = torch.from_numpy(rng.standard_normal(
                (P, PS, H, D), np.float32)).to("cuda", dt)
    return case


def attention_bound(np, case, dtype):
    """The least time for this call: live K/V bytes (each position a
    row can see, read once; int8 pages 1 byte per element plus 4 bytes
    per live (page, head) for each of the k and v scales) + q + out +
    table + index, against visible-pair flops."""
    P, PS, H, D = case["P"], case["PS"], case["H"], case["D"]
    table, index = case["table_np"], case["index_np"]
    R, Lq = case["q"].shape[0], case["q"].shape[1]
    W = table.shape[1]
    live = set()
    pairs = 0
    for r in range(R):
        last = min(int(index[r]) + Lq, W * PS)  # positions 0..last-1
        for pos in range(last):
            phys = min(max(int(table[r, pos // PS]), 0), P - 1)
            live.add((phys, pos % PS))
        for j in range(Lq):
            pairs += min(int(index[r]) + j + 1, W * PS)
    itemsize = 2 if dtype == "bfloat16" else 4
    kv_itemsize = 1 if case["int8"] else itemsize
    nbytes = len(live) * 2 * H * D * kv_itemsize
    if case["int8"]:
        nbytes += len({p for p, _ in live}) * H * 4 * 2
    nbytes += 2 * R * Lq * H * D * itemsize + table.nbytes + index.nbytes
    flops = 4.0 * D * H * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_args(case):
    """(positional args, keyword args) of ``paged_attention``."""
    args = (case["q"], case["k"], case["v"], case["table"], case["index"])
    if case["int8"]:
        return args, dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    return args, {}


def library_call(torch, case):
    """``scaled_dot_product_attention`` over the gathered views (int8
    pages dequantized in the gather) with the causal/staleness mask: the
    yardstick (the port never calls it).  Returns a zero-argument
    callable; the gather and dequant are done once, outside the timed
    call."""
    from skycomputing_tpu_torch.serving.kv_cache import (
        QuantizedPages,
        decode_visibility,
        gather_kv_pages,
    )
    import torch.nn.functional as F

    q = case["q"]
    k, v = case["k"], case["v"]
    if case["int8"]:
        k = QuantizedPages(k, case["k_scale"])
        v = QuantizedPages(v, case["v_scale"])
    k_virt, v_virt = gather_kv_pages(k, v, case["table"])
    mask = decode_visibility(case["index"], q.shape[1], k_virt.shape[1])
    qh = q.transpose(1, 2)
    kh = k_virt.to(q.dtype).transpose(1, 2).contiguous()
    vh = v_virt.to(q.dtype).transpose(1, 2).contiguous()
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m)


def query_tile_ab(torch, ptxas, case, args, kw, first_ms):
    """The query-tile body, which served float32 prefill and chunk waves
    before the register-tile body, on the same call: its error against
    the plain version, its ``ptxas`` figures and its time, the two bodies
    timed in turns (register-tile, query-tile, query-tile, register-tile;
    ``first_ms`` is the first).  Returns (the register-tile body's mean
    time and its two times, the query-tile body's row)."""
    pa = importlib.import_module(
        "skycomputing_tpu_torch.ops.paged_attention")

    def call():
        return pa.paged_attention(*args, **kw)

    with mock.patch.object(pa, "kernel_plan", lambda *a: "query_tile"):
        out = call()
        torch.cuda.synchronize()
        ref = pa.paged_attention_reference(*args, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        old = [time_ms(torch, call), time_ms(torch, call)]
    again = time_ms(torch, call)
    R, Lq, H, D = case["q"].shape
    t = _SHORT[str(case["q"].dtype).replace("torch.", "")]
    kv = _SHORT[str(case["k"].dtype).replace("torch.", "")]
    row = dict(ms=sum(old) / 2, ms_each=old, max_abs_err=err,
               **body_fields(ptxas, "query_tile",
                             f"paged_attention_kernel<{t}, {kv}>",
                             pa.kernel_smem_bytes(
                                 "query_tile", case["k"].dtype, Lq, D,
                                 case["PS"], case["table"].shape[1])))
    return (first_ms + again) / 2, [first_ms, again], row


PAGED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def paged_row(torch, np, ptxas, kernel, name, R, Lq, dtype, seed,
              int8=False, geometry=PAGES_16, query_tile=True):
    """One case of B2 (or, ``int8``, B3) against its plain version: its
    error (held within :data:`PAGED_TOL`), body, times and bound.  A
    register-tile row is timed beside the query-tile body where
    ``query_tile`` (and must beat it)."""
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    tol = PAGED_TOL[dtype]
    case = attention_case(torch, np, name, R, Lq, dtype, seed=seed,
                          int8=int8, geometry=geometry)
    args, kw = kernel_args(case)
    out = paged_attention(*args, **kw)
    ref = paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    fields = paged_body(ptxas, case["q"], case["k"].dtype, case["table"],
                        page_size=case["PS"])
    ms = time_ms(torch, lambda: paged_attention(*args, **kw))
    ab = {}
    if query_tile and fields["body"] == "register_tile":
        ms, ab["ms_each"], ab["query_tile"] = query_tile_ab(
            torch, ptxas, case, args, kw, ms)
    issue_ms = host_ms(torch, lambda: paged_attention(*args, **kw))
    plain_ms = time_ms(torch, lambda: paged_attention_reference(*args, **kw))
    library_ms = time_ms(torch, library_call(torch, case))
    bound_ms, bound_by = attention_bound(np, case, dtype)
    row = dict(kernel=kernel, case=name, R=R, Lq=Lq, dtype=dtype,
               page_size=case["PS"], pool_pages=case["P"],
               table_width=case["table"].shape[1], max_abs_err=err,
               tol=tol, ms=ms, host_ms=issue_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               **fields, **ab)
    log(f"   {json.dumps(row)}")
    check(finite and err <= tol,
          f"{kernel} {name} {dtype}: max |err| {err:.3g} <= {tol}")
    if ab:
        old = ab["query_tile"]
        check(old["max_abs_err"] <= tol and ms < old["ms"],
              f"{kernel} {name} {dtype}: register-tile body {ms:.4f} ms < "
              f"query-tile body {old['ms']:.4f} ms (its max |err| "
              f"{old['max_abs_err']:.3g})")
    return row


def kernel_checks(torch, np, ptxas):
    results = []
    for ki, (kernel, int8) in enumerate((("paged_attention", False),
                                         ("paged_attention_int8", True))):
        for ci, (name, R, Lq) in enumerate(PAGED_CASES):
            for di, dtype in enumerate(("bfloat16", "float32")):
                # the first three cases keep their earlier seeds
                seed = 6 * ki + 2 * ci + di + (0 if ci < 3 else 100)
                results.append(paged_row(torch, np, ptxas, kernel, name, R,
                                         Lq, dtype, seed, int8=int8))
    # B2 in float32 at the geometry of phase 33 (a)'s calls (no query-tile
    # comparison: that body serves no call there)
    for ci, (name, R, Lq, geometry, _) in enumerate(disagg_cases()):
        results.append(paged_row(torch, np, ptxas, "paged_attention", name,
                                 R, Lq, "float32", 200 + ci,
                                 geometry=geometry, query_tile=False))
    # and at the geometry of each of phase 34 (b)'s calls
    for name, R, Lq, geometry, _, seed in autotune_cases():
        results.append(paged_row(torch, np, ptxas, "paged_attention", name,
                                 R, Lq, "float32", seed,
                                 geometry=geometry, query_tile=False))
    return results


def paged_edge_case(torch, np, D, Lq, dtype, int8, seed, PS=16):
    """Pages of ``PS`` (16 by default), H=12 at head_dim ``D``, four rows:
    one at index 0 (its first query sees one position), one whose last
    query fills its whole table, one at index 20 (mid-page) and one
    inactive (all sentinels).  Pages of 16 up to Lq=17: a 12-page pool
    and tables of 4 pages; else tables of W = (Lq + 63) // PS + 1 pages
    from a pool of 3 W + 2.  ``int8`` pages as in
    :func:`attention_case`."""
    H = 12
    if Lq <= 17 and PS == 16:
        P, W = 12, 4
        rows = [([3, 4], 0), ([5, 1, 7, 9], W * PS - Lq), ([2, 0, 11], 20),
                ([], 0)]
    else:
        W = (Lq + 63) // PS + 1
        P = 3 * W + 2
        pool = iter(np.random.default_rng(Lq).permutation(P - 1).tolist())

        def take(n):
            return [next(pool) for _ in range(n)]

        rows = [(take((Lq + PS - 1) // PS), 0), (take(W), W * PS - Lq),
                (take((20 + Lq + PS - 1) // PS), 20), ([], 0)]
    rng = np.random.default_rng(seed)
    table = np.full((len(rows), W), P, np.int32)
    index = np.zeros(len(rows), np.int32)
    for r, (pages, idx) in enumerate(rows):
        table[r, :len(pages)] = pages
        index[r] = idx
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal(
        (len(rows), Lq, H, D), np.float32)).to("cuda", dt)
    args = [q]
    for _ in ("k", "v"):
        if int8:
            args.append(torch.from_numpy(np.clip(np.round(
                32 * rng.standard_normal((P, PS, H, D))), -127, 127).astype(
                    np.int8)).cuda())
        else:
            args.append(torch.from_numpy(rng.standard_normal(
                (P, PS, H, D), np.float32)).to("cuda", dt))
    args += [torch.from_numpy(table).cuda(), torch.from_numpy(index).cuda()]
    kw = {}
    if int8:
        kw = {name: torch.from_numpy(rng.uniform(0.02, 0.04, (P, H)).astype(
            np.float32)).cuda() for name in ("k_scale", "v_scale")}
    return args, kw


def paged_edge_checks(torch, np, ptxas):
    """B2 and B3 at each body's edges, in both dtypes, against the plain
    version (checked, not timed): pages of 16 at Lq 1, 5 and 16 (the
    decode body), 17, 63, 64, 65 and 256 (bf16: the tensor-core body, one
    query past one warp, around a 64-query block, the largest bucket;
    float32: the register-tile body, one past the decode bound, around
    its 32- and 16-query tiles), head_dim 64 and 128; then pages of 4
    and 8 (the register-tile body in both dtypes) at Lq 17, 33 and 64."""
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    shapes = ([(16, D, Lq) for D in (64, 128)
               for Lq in (1, 5, 16, 17, 63, 64, 65, 256)]
              + [(PS, D, Lq) for PS in (4, 8) for D in (64, 128)
                 for Lq in (17, 33, 64)])
    results = []
    for kernel, int8 in (("paged_attention", False),
                         ("paged_attention_int8", True)):
        for PS, D, Lq in shapes:
            for dtype in ("bfloat16", "float32"):
                args, kw = paged_edge_case(torch, np, D, Lq, dtype, int8,
                                           seed=500 + len(results), PS=PS)
                out = paged_attention(*args, **kw)
                ref = paged_attention_reference(*args, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                finite = bool(torch.isfinite(out).all())
                row = dict(kernel=kernel, case=f"edge_ps{PS}_d{D}_lq{Lq}",
                           page_size=PS, D=D, Lq=Lq, dtype=dtype,
                           max_abs_err=err, tol=tol[dtype],
                           **paged_body(ptxas, args[0], args[1].dtype,
                                        args[3], PS))
                log(f"   {json.dumps(row)}")
                check(finite and err <= tol[dtype],
                      f"{kernel} page {PS} D={D} Lq={Lq} {dtype} "
                      f"({row['body']}): max |err| {err:.3g} "
                      f"<= {tol[dtype]}")
                results.append(row)
    return results


# --------------------------------------------------------------------------
# phases 4-8: the serving engine
# --------------------------------------------------------------------------


def requests_for(np, Request, n=16, new_tokens=32, seed=SEED):
    """Prompt lengths from default_rng(seed) in 24..250.  Requests 0, 5
    and 12 share a 64-token prefix (page-aligned: a radix hit maps whole
    pages); request 15 repeats request 0's prompt (a hit that ends
    mid-page: a copy-on-write clone)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(24, 251, n)
    prefix = rng.integers(1, 50257, 64).astype(np.int32)
    prompts = []
    for i, length in enumerate(lengths):
        if i in (0, 5, 12):
            tail = rng.integers(1, 50257, max(1, int(length) - 64))
            prompts.append(np.concatenate([prefix, tail.astype(np.int32)]))
        else:
            prompts.append(rng.integers(1, 50257, int(length))
                           .astype(np.int32))
    if n > 15:
        if (prompts[0].size - 1) % 16 == 0:  # keep the repeat mid-page
            prompts[0] = np.append(prompts[0], np.int32(7))
        prompts[15] = prompts[0].copy()
    return [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]


_WEIGHTS = {}


def random_weights(cfg_mod, layer_cfgs, key, seed):
    """``random_state_dicts(layer_cfgs, seed)``, drawn once per (``key``,
    seed) in this process: GPT-2 small's draw takes seconds of host time,
    and the serving phases build dozens of engines from the same
    weights.  Each engine copies them into its own modules, so callers
    share the host tensors and never write them."""
    if (key, seed) not in _WEIGHTS:
        _WEIGHTS[key, seed] = cfg_mod.random_state_dicts(layer_cfgs, seed)
    return _WEIGHTS[key, seed]


def build_engine(ServingEngine, cfg_mod, depth, dtype, device, seed=SEED,
                 quiet_after=None, **kw):
    """GPT-2 small's width at ``depth`` blocks, random weights from
    ``seed``.  ``quiet_after=d``: blocks ``d`` and later write 10x less
    into the residual stream (their output projections scaled by 0.1),
    so that a ``d``-block speculative draft agrees with the target often
    enough for acceptance to be exercised — with the plain random
    weights the early-exit draft almost never agrees."""
    cfg = cfg_mod.GptConfig(dropout_prob=0.0, dtype=dtype)
    layer_cfgs = cfg_mod.gpt_layer_configs(cfg, num_blocks=depth)
    params = [dict(sd) for sd in random_weights(cfg_mod, layer_cfgs,
                                                 (dtype, depth), seed)]
    if quiet_after is not None:
        for block in range(quiet_after, depth):
            for layer in (1 + 2 * block, 2 + 2 * block):  # attn, mlp
                params[layer]["c_proj.weight"] = (
                    params[layer]["c_proj.weight"] * 0.1)
    return ServingEngine(
        layer_cfgs, params, kv_layout="paged", page_size=16,
        buckets=(32, 64, 128, 256),
        max_len=512, max_concurrency=16, prefill_batch=4, num_pages=512,
        device=device, **kw,
    )


def serve(torch, np, gpt_mod, ServingEngine, Request, kernels, preempt=None,
          quiet_after=None, reconfigure=(), **kw):
    """One full-width (12-layer, bf16) run of the 16-request workload:
    12 requests arrive, one tick later the last 4 (two of them prefix
    sharers, so their radix hits find the first wave's registered
    prompts).  ``preempt`` = (tick, request position, mode) preempts
    that request before that tick's step; ``reconfigure`` = [(tick,
    knobs), ...] calls ``engine.reconfigure(**knobs)`` before that
    tick's step, recording the card's memory before it, its peak during
    it and after it.  A 4-request warm-up on another engine of the same
    knobs runs first (cuBLAS handles, allocator pools) and is not
    counted.  Every kernel's launch count is set to 0 just before the
    run and read just after it."""
    warm = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16", "cuda",
                        quiet_after=quiet_after, **kw)
    warm.run(requests_for(np, Request, n=4, new_tokens=4, seed=99))
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    engine = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16", "cuda",
                          quiet_after=quiet_after, **kw)
    reqs = requests_for(np, Request)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k["fn"].launches = 0
        for body in getattr(k["fn"], "body_launches", {}):
            k["fn"].body_launches[body] = 0
    changes = dict(reconfigure)
    reconfigured = []
    t0 = time.perf_counter()
    for r in reqs[:12]:
        engine.submit(r)
    tick = 0
    while tick == 0 or engine.has_work():
        if tick == 1:
            for r in reqs[12:]:
                engine.submit(r)
        if preempt is not None and tick == preempt[0]:
            engine.preempt(reqs[preempt[1]].request_id, mode=preempt[2])
        if tick in changes:
            reconfigured.append(reconfigure_on_card(torch, engine, tick,
                                                    changes[tick]))
        engine.step()
        tick += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    bodies = {name: dict(k["fn"].body_launches) for name, k in kernels.items()
              if hasattr(k["fn"], "body_launches")}
    snap = engine.stats.snapshot()
    log(f"   stats: {json.dumps(snap)}")
    check(snap["finished"] == 16 and all(
        r.status == "finished" for r in reqs),
          f"{snap['finished']}/16 requests finished")
    check(all(len(r.tokens) == 32 for r in reqs), "32 new tokens each")
    check(all(int(t) < 50257 for r in reqs for t in r.tokens),
          "tokens inside the vocabulary")
    e2e = dict(
        wall_s=wall, generated_tokens=snap["generated_tokens"],
        tokens_per_s=snap["generated_tokens"] / wall,
        engine_tokens_per_s=snap["tokens_per_s"],
        ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
        tpot_p50_s=snap["tpot_p50_s"], tpot_p95_s=snap["tpot_p95_s"],
        prefill_waves=snap["prefill_waves"],
        decode_ticks=snap["decode_ticks"], spec_ticks=snap["spec_ticks"],
        launches=launches, body_launches=bodies,
        peak_mem_gb=max([torch.cuda.max_memory_allocated() / 1e9]
                        + [max(r["peak_gb"], r["run_peak_gb"])
                           for r in reconfigured]),
        stages=[len(st.modules) for st in engine.stages],
    )
    if reconfigured:
        e2e["reconfigured"] = reconfigured
    log(f"   e2e: {json.dumps(e2e)}")
    return engine, reqs, snap, launches, e2e


def reconfigure_on_card(torch, engine, tick, knobs):
    """``engine.reconfigure(**knobs)``, with the card's allocated memory
    before, the peak during (a geometry change builds every stage's new
    slabs beside the old ones) and after, in GB, the run's peak until
    then, and the seconds it took (the work queued before it
    included)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    run_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.reconfigure(**knobs)
    torch.cuda.synchronize()
    row = dict(tick=tick, knobs={k: list(v) if isinstance(v, tuple) else v
                                 for k, v in knobs.items()},
               seconds=time.perf_counter() - t0,
               before_gb=before / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               after_gb=torch.cuda.memory_allocated() / 1e9,
               run_peak_gb=run_peak / 1e9,
               preemptions=engine.stats.preemptions)
    torch.cuda.reset_peak_memory_stats()
    log(f"   reconfigure: {json.dumps(row)}")
    return row


def agreement(a, b) -> float:
    """Share of positions where two lists of token streams agree."""
    same = total = 0
    for x, y in zip(a, b):
        total += max(len(x), len(y))
        same += sum(int(s == t) for s, t in zip(x, y))
    return same / total if total else 1.0


def lockstep_int8(torch, np, gpt_mod, ServingEngine, Request):
    """int8 pages at depth 2, float32, greedy, on the card and on the CPU
    in lockstep: after every step each new token the card chose is
    compared with the CPU's and then replaced by it (teacher forcing),
    so every position is judged on the same history.  Returns the
    agreement, the (request, position) pairs that differ, and how the
    two int8 pools differ at the end (entries and int8 steps apart,
    largest relative scale difference)."""
    engines, reqs = {}, {}
    for device in ("cuda", "cpu"):
        engines[device] = build_engine(ServingEngine, gpt_mod, 2, "float32",
                                       device, kv_dtype="int8")
        reqs[device] = requests_for(np, Request, n=6, new_tokens=12, seed=7)
        for r in reqs[device]:
            engines[device].submit(r)
    same = total = 0
    diffs = []
    while engines["cpu"].has_work():
        before = [len(r.tokens) for r in reqs["cpu"]]
        for engine in engines.values():
            engine.step()
        for i, (card, host, n) in enumerate(zip(reqs["cuda"], reqs["cpu"],
                                               before)):
            for j in range(n, len(host.tokens)):
                total += 1
                if card.tokens[j] == host.tokens[j]:
                    same += 1
                else:
                    diffs.append((i, j))
                    card.tokens[j] = host.tokens[j]
    entries = steps = 0
    scale_rel = 0.0
    for card_pair, host_pair in zip(engines["cuda"].stages[0].slabs,
                                    engines["cpu"].stages[0].slabs):
        for card, host in zip(card_pair, host_pair):
            d = (card.values.cpu().int() - host.values.int()).abs()
            entries += int((d > 0).sum())
            steps = max(steps, int(d.max()))
            rel = ((card.scale.cpu() - host.scale).abs()
                   / host.scale.abs().clamp_min(1e-30))
            scale_rel = max(scale_rel, float(rel.max()))
    total_entries = sum(2 * k.values.numel()
                        for k, _ in engines["cpu"].stages[0].slabs)
    return dict(agreement=same / total, positions=total, diffs=diffs,
                int8_entries_differing=entries, pool_entries=total_entries,
                max_int8_steps_apart=steps, max_scale_rel_diff=scale_rel)


def zero_counts(kernels):
    """Every kernel's launch count, and each body's, set to 0."""
    for k in kernels.values():
        k["fn"].launches = 0
        for body in getattr(k["fn"], "body_launches", {}):
            k["fn"].body_launches[body] = 0


def check_f32_b1_body(bodies, launches, what):
    """Every float32 B1 launch of a run on the 3xTF32 tensor-core body
    (head_dim 64 everywhere on the main path)."""
    check(launches > 0 and bodies[F32_BODY] == launches,
          f"{what}: all {launches} B1 launches on the float32 tensor-core "
          f"body ({json.dumps(bodies)})")


def check_launches(launches, expect, what):
    """Every kernel's launches equal ``expect`` (0 where it names none)."""
    expect = {name: expect.get(name, 0) for name in launches}
    check(launches == expect,
          f"{what}: launches {json.dumps(launches)} == {json.dumps(expect)}")


def check_bodies(e2e, kernel, prefill, decode):
    """``kernel``'s launches by body in a serving run: every prefill (and
    chunk) wave on the tensor-core body, every decode and verify tick on
    the decode body, none on the query-tile or register-tile body."""
    expect = dict(query_tile=0, decode=decode, tensor_core=prefill,
                  register_tile=0)
    got = e2e["body_launches"][kernel]
    check(got == expect, f"{kernel} by body: {json.dumps(got)} == "
          f"{json.dumps(expect)}")


def kernel_rows(prof):
    """(device us, kernel name, count) per kernel of a profile, largest
    first."""
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue  # kernels only: host ops would count them twice
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    return sorted(rows, reverse=True)


def profile_window(torch, run):
    """``torch.profiler`` over ``run()``: (a summary with the window,
    device busy time, kernel launches, the card's idle share and the top
    12 kernels by device time; every kernel row as (device us, name,
    count))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = kernel_rows(prof)
    total_us = sum(r[0] for r in rows)
    out = dict(window_s=window, device_busy_s=total_us / 1e6,
               kernel_launches=sum(r[2] for r in rows))
    if total_us > 0:
        out["idle_share"] = max(0.0, 1 - total_us / 1e6 / window)
        out["top"] = [dict(kernel=k[:80], device_ms=us / 1e3, count=n,
                           share=us / total_us) for us, k, n in rows[:12]]
        for row in out["top"]:
            log(f"   {row['share']:6.1%} {row['device_ms']:9.3f} ms "
                f"x{row['count']:<5d} {row['kernel']}")
    else:
        log("   the profiler recorded no device time: not measured")
    return out, rows


def profile_prefill_wave(torch, engine, kernel):
    """``torch.profiler`` over the engine's first prefill wave alone
    (the queue head's wave as admission would pick it): device time by
    kernel, the card's idle share, and the paged kernel's launches by
    body, its device time and share of the wave."""
    wave = engine._select_paged_wave()
    bucket = engine.bucketer.bucket_for(
        int(wave[0][0].effective_prompt[wave[0][1].shared_tokens:].size))
    before = dict(kernel.body_launches)
    out, rows = profile_window(
        torch, lambda: engine._prefill_wave_paged(wave))
    kernel_us = sum(us for us, key, _ in rows
                    if "paged_attention_kernel" in key)
    busy_us = sum(us for us, _, _ in rows)
    bodies = {b: n - before[b] for b, n in kernel.body_launches.items()}
    out.update(rows=len(wave), bucket=bucket, body_launches=bodies,
               paged_device_ms=kernel_us / 1e3,
               paged_us_per_launch=kernel_us / max(sum(bodies.values()), 1),
               paged_share=kernel_us / busy_us if busy_us else None,
               paged_kernels=sorted({key[:100] for _, key, _ in rows
                                     if "paged_attention" in key}))
    check(bodies["tensor_core"] == LAYERS and sum(bodies.values()) == LAYERS,
          f"the prefill wave (bucket {bucket}, {len(wave)} requests) ran the "
          f"tensor-core body once per layer: {json.dumps(bodies)}")
    log(f"   profile: "
        f"{json.dumps({k: v for k, v in out.items() if k != 'top'})}")
    return out


def write_cost_per_tick(torch, np, engine, timer=time_ms):
    """What one decode tick's KV write over every layer of ``engine``
    costs (its current rows, random new K/V in the model dtype): the
    int8 pool's quantize-on-write or the fp pool's scatter.  Returns
    (span_ms, device_ms): the write's span on the card's clock by
    ``timer`` — for a sequence of small eager kernels that is the host's
    time to launch them — and the device time of its kernels alone, from
    the profiler.  The write lands in the engine's slabs, so call it
    last."""
    from skycomputing_tpu_torch.serving.kv_cache import (
        scatter_kv,
        slab_device,
        write_plan,
    )

    active = list(engine._running.values())
    _, index, tables = engine._decode_rows(active)
    valid = np.zeros_like(index)
    for r in active:
        valid[r.slot] = r.index + 1
    width = engine._table_width(valid)
    slabs = engine.stages[0].slabs
    k0 = slabs[0][0]
    device = slab_device(k0)
    plan = write_plan(k0, tables[:, :width], index, valid, 1).to(device)
    spec = engine.stages[0].specs[0]
    rng = np.random.default_rng(5)
    new = torch.from_numpy(rng.standard_normal(
        (len(index), 1, spec.num_heads, spec.head_dim), np.float32)).to(
        device, getattr(torch, spec.dtype))

    def write():
        for k, v in slabs:
            scatter_kv(k, v, new, new, plan)

    span_ms = timer(torch, write, iters=10, host_ahead=False)
    if device.type != "cuda":
        return span_ms, None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        write()
        torch.cuda.synchronize()
    return span_ms, sum(r[0] for r in kernel_rows(prof)) / 1e3


# --------------------------------------------------------------------------
# phase 3: flash attention (B1) against its plain version
# --------------------------------------------------------------------------

# (case, B, L, padded tail keys) at BERT-large's heads (H=16, D=64); B=4
# is the microbatch that phases 27 and 28 hand each dp shard
FLASH_CASES = (("bert_large_L128", 8, 128, 32), ("long_L512", 2, 512, 0),
               ("indivisible_L100", 2, 100, 0),
               ("bert_large_L128_B4", 4, 128, 32))


def flash_case(torch, np, B, L, tail, dtype, seed):
    """q/k/v ~ N(0, 1) [B, L, 16, 64] and a bias row of 0 with -10000
    on the last ``tail`` keys, in ``dtype`` on the card."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, 16, 64))
                                .astype(np.float32)).to("cuda", dt)
               for _ in range(3))
    bias = torch.zeros(B, L)
    if tail:
        bias[:, -tail:] = -10000.0
    return q, k, v, bias.to("cuda", dt)


def flash_bound(q, bias, dtype, body=None):
    """The least time for one call: q, k, v read and out written once
    (plus the bias row), against 4 * B * H * L * L * D flops (the two
    products; the softmax's exps are not counted) at the dtype's peak.
    For the float32 tensor-core body (``body="tensor_core_f32"``) the
    operations are its three TF32 products, 3 * 4 * B * H * L * L * D at
    the TF32 peak; the row also keeps the FFMA bound beside it.  Returns
    (bound_ms, bound_by, fields for the row)."""
    B, L, H, D = q.shape
    itemsize = q.element_size()
    nbytes = 4 * B * L * H * D * itemsize + bias.numel() * bias.element_size()
    flops = 4.0 * B * H * L * L * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    extra = {}
    if body == "tensor_core_f32":
        extra = dict(ffma_bound_ms=max(t_bytes, t_ops),
                     bound_basis="3xTF32: 3 x 4BHL^2D at 495 TFLOP/s")
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), extra


def flash_checks(torch, np, ptxas):
    """B1 against its plain version at each case in both dtypes, with
    the kernel's, the plain version's and SDPA's times (SDPA over the
    same inputs transposed to [B, H, L, D] outside the timed call, the
    bias as a broadcast additive mask)."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for name, B, L, tail in FLASH_CASES:
        for dtype in ("bfloat16", "float32"):
            q, k, v, bias = flash_case(torch, np, B, L, tail, dtype,
                                       seed=300 + len(results))
            scale = q.shape[-1] ** -0.5
            out = flash_attention(q, k, v, bias)
            ref = flash_attention_reference(q, k, v, bias, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = bias[:, None, None, :]
            ms = time_ms(torch, lambda: flash_attention(q, k, v, bias))
            issue_ms = host_ms(torch, lambda: flash_attention(q, k, v, bias))
            plain_ms = time_ms(torch, lambda: flash_attention_reference(
                q, k, v, bias, scale))
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask))
            body = flash_body(torch, ptxas, q)
            bound_ms, bound_by, extra = flash_bound(q, bias, dtype,
                                                    body["body"])
            row = dict(kernel="flash_attention", case=name, B=B, L=L,
                       H=16, D=64, padded_keys=tail, dtype=dtype,
                       max_abs_err=err, tol=tol[dtype], ms=ms,
                       host_ms=issue_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, **extra,
                       **body)
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[dtype],
                  f"flash_attention {name} {dtype}: max |err| {err:.3g} "
                  f"<= {tol[dtype]}")
            results.append(row)
    return results


# (case, B, L, H, D, masked tail keys) at the tensor-core bodies' edges;
# head_dim 40 is not a multiple of 16, so bf16 takes the CUDA-core body
# (float32 the float32 tensor-core body, 40 being a multiple of 8), and
# head_dim 36 not a multiple of 8, so both dtypes take the CUDA-core body
FLASH_EDGE_CASES = (("short_L7", 2, 7, 4, 64, 0), ("one_tile_L64", 2, 64, 4,
                                                    64, 0),
                    ("one_past_L65", 2, 65, 4, 64, 0),
                    ("head_dim_32", 2, 96, 4, 32, 8),
                    ("head_dim_128", 2, 130, 4, 128, 8),
                    ("batch_1", 1, 128, 16, 64, 32),
                    ("all_keys_masked", 2, 64, 4, 64, 64),
                    ("head_dim_40", 2, 100, 4, 40, 8),
                    ("head_dim_36", 2, 100, 4, 36, 8))


def flash_edge_checks(torch, np, ptxas):
    """B1 at its bodies' edges in both dtypes against the plain version
    (checked, not timed); in float32 against the plain version evaluated
    in float64, the function itself, because in ``all_keys_masked`` the
    float32 plain version's scores round to a step of 2^-10 at -1e4,
    which moves its output by up to about 4e-4 (each row reports the
    float32 plain version's distance too).  In ``all_keys_masked`` batch
    0's queries are zero, so its softmax must come out uniform: its
    output the mean of v over the keys."""
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for name, B, L, H, D, tail in FLASH_EDGE_CASES:
        for dtype in ("bfloat16", "float32"):
            rng = np.random.default_rng(600 + len(results))
            dt = getattr(torch, dtype)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, L, H, D)).astype(np.float32)).to("cuda", dt)
                for _ in range(3))
            bias = torch.zeros(B, L)
            if tail:
                bias[:, -tail:] = -10000.0
            bias = bias.to("cuda", dt)
            if name == "all_keys_masked":
                q[0] = 0
            out = flash_attention(q, k, v, bias)
            ref = flash_attention_reference(q, k, v, bias, D ** -0.5)
            plain_f32 = None
            if dtype == "float32":
                plain_f32 = (out - ref).abs().max().item()
                ref = flash_attention_reference(
                    q, k, v, bias, D ** -0.5, compute_dtype=torch.float64)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if name == "all_keys_masked":
                mean = v[0].float().mean(dim=0, keepdim=True)
                err = max(err, (out[0].float() - mean).abs().max().item())
            finite = bool(torch.isfinite(out).all())
            row = dict(kernel="flash_attention", case=name, B=B, L=L, H=H,
                       D=D, padded_keys=tail, dtype=dtype, max_abs_err=err,
                       max_abs_err_vs_f32_plain=plain_f32,
                       tol=tol[dtype], **flash_body(torch, ptxas, q))
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[dtype],
                  f"flash_attention {name} {dtype} ({row['body']}): "
                  f"max |err| {err:.3g} <= {tol[dtype]}")
            results.append(row)
    return results


# --------------------------------------------------------------------------
# phases 10-13: the BERT pipeline trainer
# --------------------------------------------------------------------------

BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 5
BERT_WORKERS, BERT_MICROBATCHES, BERT_LR = 4, 4, 1e-3


def bert_batch(np, vocab_size):
    """The reference benchmark's batch: ids from default_rng(0) in
    [5, vocab), token types 0, no padding, 3-way labels."""
    rng = np.random.default_rng(0)
    ids = rng.integers(5, vocab_size,
                       size=(BERT_BATCH, BERT_SEQ)).astype(np.int32)
    labels = rng.integers(0, 3, size=(BERT_BATCH,)).astype(np.int32)
    return (ids, np.zeros_like(ids), np.ones_like(ids)), labels


def build_trainer(torch, model_cfg, devices=None, state_dicts=None):
    """4 workers (device index i % cards), even allocation, the
    parameter server (weights from seed 0 unless given), GPipe with 4
    microbatches and SGD — through the library's entry points."""
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd

    cards = max(torch.cuda.device_count(), 1)
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i % cards))
        for i in range(BERT_WORKERS)
    ])
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(SEED))
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=devices,
                          num_microbatches=BERT_MICROBATCHES)
    return model, ps, wm


def train_bert(torch, np, kernels):
    """BERT-large trained by ``Runner.train`` for 5 steps; every
    kernel's launches are set to 0 just before and read just after."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.runner import Hook, Runner

    cfg = bert_config("large", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=24, num_classes=3,
                                   deterministic=True)
    check(len(model_cfg) == 75 and cfg.hidden_size == 1024
          and cfg.num_attention_heads == 16 and cfg.dtype == "bfloat16",
          "BERT-large: 75 units, hidden 1024, 16 heads, bf16 compute")
    data, labels = bert_batch(np, cfg.vocab_size)
    t0 = time.perf_counter()
    model, ps, wm = build_trainer(torch, model_cfg)
    setup_s = time.perf_counter() - t0
    partition = model.partition_signature()
    check(partition == [19, 19, 19, 18],
          f"even allocation {partition} over 4 workers")
    params = sum(p.numel() for stage in model.stages
                 for p in stage.parameters)

    class Record(Hook):
        def __init__(self):
            self.steps = []

        def after_train_iter(self, runner):
            self.steps.append(runner.model.stats.snapshot())

    runner = Runner(model, ps, wm, max_epochs=1, max_iters=BERT_STEPS)
    record = Record()
    runner.register_hook(record)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    runner.train([(data, labels)] * BERT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    steps = record.steps
    losses = [s["loss"] for s in steps]
    log(f"   losses: {losses}")
    check(len(losses) == BERT_STEPS
          and all(np.isfinite(x) for x in losses),
          f"{len(losses)} finite losses")
    step_s = [s["forward_s"] + s["backward_s"] + s["step_s"] for s in steps]
    median = float(np.median(step_s[1:]))
    tokens = BERT_BATCH * BERT_SEQ
    e2e = dict(
        setup_s=setup_s, wall_s=wall, losses=losses, step_s=step_s,
        step_s_median_2_5=median, tokens_per_step=tokens,
        tokens_per_s=tokens / median, parameters=params,
        mfu=6.0 * params * tokens / median / PEAK_FLOPS["bfloat16"],
        forward_s=[s["forward_s"] for s in steps],
        backward_s=[s["backward_s"] for s in steps],
        update_s=[s["step_s"] for s in steps],
        dispatch_s=[s["dispatch_s"] for s in steps],
        phase_means_s=runner.phase_timer.summary(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        mem_before_gb=mem_before / 1e9,
        partition=partition, launches=launches,
    )
    log(f"   e2e: {json.dumps(e2e)}")
    return model, data, labels, launches, e2e


def trainer_card_vs_cpu(torch, np):
    """The pipeline at BERT-large's width, depth 2, float32: two steps
    on the card and on the CPU from the same weights and batch, with B1's
    launches by body on the card."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.ops.flash_attention import flash_attention

    cfg = bert_config("large", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=2, num_classes=3,
                                   deterministic=True)
    data, labels = bert_batch(np, cfg.vocab_size)
    card, card_ps, _ = build_trainer(torch, model_cfg)
    host, host_ps, _ = build_trainer(torch, model_cfg,
                                     devices=[torch.device("cpu")],
                                     state_dicts=card_ps.params)
    losses = {}
    flash = {B1: dict(fn=flash_attention)}
    for name, model in (("cuda", card), ("cpu", host)):
        t0 = time.perf_counter()
        zero_counts(flash)
        losses[name] = [model.train_step(data, labels) for _ in range(2)]
        if name == "cuda":
            b1 = dict(launches=flash_attention.launches,
                      bodies=dict(flash_attention.body_launches))
        log(f"   {name}: losses {losses[name]} in "
            f"{time.perf_counter() - t0:.1f} s")
        model.sync_to_parameter_server()
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    param_abs = max(
        (a[key] - b[key]).abs().max().item()
        for a, b in zip(card_ps.params, host_ps.params) for key in a
    )
    return dict(losses=losses, max_loss_rel_diff=loss_rel,
                max_param_abs_diff=param_abs, b1=b1)


def flash_on_off_bf16(torch, np, kernels):
    """BERT-large's width at depth 2 in bfloat16: two steps with
    ``use_flash_attention`` on and two with it off, from the same
    weights and batch.  Returns both loss lists, the largest relative
    difference and B1's launches in each run."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

    models = {}
    params = None
    for flash in (True, False):
        cfg = bert_config("large", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0,
                          use_flash_attention=flash)
        model_cfg = bert_layer_configs(cfg, num_encoder_units=2,
                                       num_classes=3, deterministic=True)
        model, ps, _ = build_trainer(torch, model_cfg, state_dicts=params)
        params = params or ps.params
        models[flash] = model
    data, labels = bert_batch(np, cfg.vocab_size)
    losses, launches = {}, {}
    for flash, model in models.items():
        before = kernels["flash_attention"]["fn"].launches
        losses[flash] = [model.train_step(data, labels) for _ in range(2)]
        launches[flash] = kernels["flash_attention"]["fn"].launches - before
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    return dict(losses_flash=losses[True], losses_einsum=losses[False],
                max_loss_rel_diff=rel, flash_launches=launches[True],
                einsum_run_flash_launches=launches[False])


# --------------------------------------------------------------------------
# phases 14-16: the profilers, the launcher and the headline pass
# --------------------------------------------------------------------------

def bert_units(preset="large", layers=24):
    """The trainer's BERT (flash on, both dropouts 0) as unit configs."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

    cfg = bert_config(preset, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    return cfg, bert_layer_configs(cfg, num_encoder_units=layers,
                                   num_classes=3, deterministic=True)


def worker_pool(n):
    """``n`` workers round-robined over the cards (all on one here)."""
    from skycomputing_tpu_torch.dynamics import (
        WorkerManager,
        worker_pool_config,
    )

    wm = WorkerManager()
    wm.load_worker_pool_from_config(worker_pool_config(n, prefix="node"))
    return wm


def profilers(torch, np, kernels, model_cfg, vocab_size, device=None):
    """The static and the timed ``ModelBenchmarker`` over ``model_cfg`` at
    the trainer's batch, and the device benchmarker over four workers.
    Returns (both model benchmarkers, for the headline pass; a report)."""
    from skycomputing_tpu_torch.dataset import RandomTokenGenerator
    from skycomputing_tpu_torch.dynamics import (
        ModelBenchmarker,
        device_available_memory_mb,
        proxy_device_benchmarker,
    )

    def tokens():
        return RandomTokenGenerator(BERT_BATCH, BERT_SEQ, vocab_size)

    static = ModelBenchmarker(model_cfg, tokens())
    t0 = time.perf_counter()
    flops, static_mem = static.benchmark()
    static_s = time.perf_counter() - t0
    timed = ModelBenchmarker(model_cfg, tokens(), device=device, timed=True)
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    seconds, timed_mem = timed.benchmark()
    timed_s = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    per_type = {}
    for cfg, f, s, m in zip(model_cfg, flops, seconds, static_mem):
        row = per_type.setdefault(cfg["layer_type"], dict(
            units=0, flops=f, ms=s * 1e3, mem_mb=m))
        row["units"] += 1
    for name, row in per_type.items():
        log(f"   {name}: {json.dumps(row)}")
    check(min(flops) > 0 and min(seconds) > 0,
          f"no unit of {len(model_cfg)} profiles at 0 (static FLOPs, timed "
          f"seconds)")
    check(static.distinct_units == timed.distinct_units == len(per_type),
          f"{timed.distinct_units} distinct units timed, "
          f"{static.distinct_units} counted, one per unit type")
    check(static_mem == timed_mem,
          f"static and timed memory estimates equal "
          f"({sum(static_mem) / 1024:.3f} GB in all)")
    b1 = launches["flash_attention"]
    check(b1 > 0 and launches == {**{n: 0 for n in launches},
                                  "flash_attention": b1},
          f"B1 launched {b1} times while profiling, B2/B3 never")

    wm = worker_pool(4)
    device_bench = proxy_device_benchmarker(
        wm, devices=[device] if device is not None else None)
    t0 = time.perf_counter()
    results = device_bench.benchmark()
    device_s = time.perf_counter() - t0
    probe = torch.device(device) if device is not None else torch.device(
        "cuda", 0)
    free_mb = device_available_memory_mb(probe)
    log(f"   device benchmark: {json.dumps(results)}")
    times = {r["time"] for r in results.values()}
    check(len(results) == 4 and len(times) == 1,
          f"4 workers on one device timed once: {times}")
    mems = [r["avai_mem"] for r in results.values()]
    check(all(0 < m and abs(m - free_mb) <= 1024 for m in mems),
          f"free memory {mems[0]:.0f} MB per worker, as read now "
          f"({free_mb:.0f} MB)")
    return static, timed, dict(
        units=len(model_cfg), distinct_units=timed.distinct_units,
        per_type=per_type, static_s=static_s, timed_s=timed_s,
        flops_total=sum(flops), timed_seconds_total=sum(seconds),
        mem_total_gb=sum(static_mem) / 1024, launches=launches,
        device_benchmark=results, device_benchmark_s=device_s,
        free_mb=free_mb)


def launcher_env(workdir, preset="large", layers=24):
    """The knobs of ``configs/bert_pipeline.py`` for the launcher phase."""
    return dict(
        SKYTPU_PRESET=preset, SKYTPU_LAYER_NUM=str(layers),
        SKYTPU_SEQ_LEN=str(BERT_SEQ), SKYTPU_BATCH_SIZE=str(BERT_BATCH),
        SKYTPU_FLASH="1", SKYTPU_CORE_NUM=str(BERT_WORKERS), STIMULATE="1",
        SKYTPU_ALLOCATE_TYPE="optimal", SKYTPU_SCHEDULE="1f1b",
        SKYTPU_MICROBATCHES=str(BERT_MICROBATCHES),
        SKYTPU_MAX_ITERS=str(BERT_STEPS), SKYTPU_PROFILE="static",
        SKYTPU_CKPT_DIR=str(workdir / "ckpt"),
        SKYTPU_LOG_ROOT=str(workdir / "logs"))


def launcher_path(torch, np, kernels, workdir, layers=24, preset="large",
                  device=None):
    """``launch.run`` on the port's config: BERT at ``layers`` encoder
    layers, 4 stimulated workers, ``optimal``, 1F1B with 4 microbatches,
    5 steps, with the stop, timer and checkpoint hooks.  Every kernel's
    launches are set to 0 just before and read just after.  Then the
    checkpoint is restored under ``even_allocate``."""
    import os

    from skycomputing_tpu_torch import launch
    from skycomputing_tpu_torch.config import load_config
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.ops import build_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, build_optimizer
    from skycomputing_tpu_torch.runner import CheckpointHook, Hook
    from skycomputing_tpu_torch.utils import Logger

    env = launcher_env(workdir, preset, layers)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config(str(
            ROOT / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py"))
        n_units = len(cfg.model_config)

        class Record(Hook):
            def __init__(self):
                self.steps = []

            def after_train_iter(self, runner):
                self.steps.append(runner.model.stats.snapshot())

        record = Record()
        logger = Logger(**cfg.logging_config)
        if device is None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k["fn"].launches = 0
        t0 = time.perf_counter()
        run = launch.run(cfg, logger, device=device, hooks=[record])
        if device is None:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k["fn"].launches for name, k in kernels.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(run is not None, "the launcher allocated and trained")
    preflight = check_preflight(run.runner)
    solved = run.allocator.last_result
    ranges = solved.as_ranges(len(solved.device_order))
    slices = [ranges[d] for d in solved.device_order]
    partition = run.model.partition_signature()
    check(partition == [b - a for a, b in slices]
          and [a for a, _ in slices] == [0] + [b for _, b in slices[:-1]]
          and slices[-1][1] == n_units,
          f"partition {partition} is the solver's ({solved.path}, gap "
          f"{solved.optimality_gap:.3g}): slices {slices} cover the "
          f"{n_units} units contiguously")
    even = [len(w.model_config) for w in Allocator(
        cfg.model_config, worker_pool(BERT_WORKERS)).even_allocate()
        .worker_pool]
    check(partition != even, f"not the even split {even}")
    steps = record.steps
    losses = [s["loss"] for s in steps]
    check(len(losses) == BERT_STEPS and all(np.isfinite(x) for x in losses)
          and all(s["interleaved"] for s in steps),
          f"{len(losses)} finite losses under 1F1B: {losses}")
    per_step = 2 * layers * BERT_MICROBATCHES
    check_launches(launches, {"flash_attention": per_step * BERT_STEPS},
                   f"{per_step} B1 launches per step (2 x {layers} layers "
                   f"x {BERT_MICROBATCHES} microbatches) x {BERT_STEPS} "
                   f"steps, none while profiling")
    step_s = [s["forward_s"] + s["backward_s"] + s["step_s"] for s in steps]
    median = float(np.median(step_s[1:]))
    params = sum(p.numel() for stage in run.model.stages
                 for p in stage.parameters)
    tokens = BERT_BATCH * BERT_SEQ
    e2e = dict(
        wall_s=wall, losses=losses, step_s=step_s,
        step_s_median_2_5=median, tokens_per_s=tokens / median,
        mfu=6.0 * params * tokens / median / PEAK_FLOPS["bfloat16"],
        dispatch_s=[s["dispatch_s"] for s in steps],
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if device is None else None),
        partition=partition, even_partition=even,
        device_order=solved.device_order, solver_path=solved.path,
        solver_gap=solved.optimality_gap,
        device_time=[r["time"] for r in
                     run.device_benchmarker.benchmark().values()],
        launches=launches, preflight=preflight)

    # the checkpoint restores its parameters under another allocation and
    # refuses its optimizer state there
    hook = next(h for h in run.runner.hooks if isinstance(h, CheckpointHook))
    check(hook.last_saved is not None, f"checkpoint {hook.last_saved}")
    wm = WorkerManager()
    wm.load_worker_pool_from_config(cfg.worker_config)
    Allocator(cfg.model_config, wm).even_allocate()
    ps = ParameterServer(cfg.model_config,
                         generator=torch.Generator().manual_seed(SEED + 1))
    ps.load_weights_from_file(hook.last_saved)
    restored = PipelineModel(
        wm, ps, build_optimizer(cfg.train_config["optim_cfg"]),
        build_loss(cfg.train_config["loss_cfg"]),
        devices=[torch.device(device)] if device is not None else None,
        num_microbatches=BERT_MICROBATCHES, schedule="1f1b")
    restored.sync_to_parameter_server()  # the stages' weights, read back
    diff = max((a[key] - b[key]).abs().max().item()
               for a, b in zip(ps.params, run.parameter_server.params)
               for key in a)
    check(restored.partition_signature() == even and diff == 0.0,
          f"restored under {restored.partition_signature()}: parameters "
          f"equal (max |diff| {diff})")
    try:
        restored.load_optimizer_state(run.model.get_optimizer_state())
        refused = False
    except ValueError:
        refused = True
    check(refused, "its optimizer state is refused under the even split")
    e2e["checkpoint"] = Path(hook.last_saved).name
    log(f"   e2e: {json.dumps(e2e)}")
    del run, restored, ps
    return launches, e2e


GPT_BLOCKS = 10  # experiment/config.py's LAYER_NUM default


def gpt_launcher_path(torch, np, kernels, workdir, preset="large",
                      blocks=GPT_BLOCKS):
    """Phase 22.  ``launch.run`` on the port's config under
    ``SKYTPU_MODEL=gpt`` at the launcher's full width: GPT at BERT-large's
    preset (hidden 1,024, 16 heads, bf16), 10 blocks, vocabulary 50,257,
    ``RandomLmDataset`` rows of 128, batch 32, 4 stimulated workers,
    ``optimal`` on the static profile (the ``DataloaderGenerator`` probe),
    1F1B with 4 microbatches, 5 steps, ``CausalLmLoss``, the config's SGD
    at 1e-3, through :func:`launcher_run`: dense attention, as in JAX, so
    no kernel.  Each step trains on fresh random n-gram rows, whose loss
    moves by more from batch to batch than five steps lower it; so the
    loss that must fall is the run's first batch's.  Returns a report."""
    import os

    from skycomputing_tpu_torch.config import load_config
    from skycomputing_tpu_torch.models import bert_config

    env = dict(
        SKYTPU_MODEL="gpt", SKYTPU_PRESET=preset,
        SKYTPU_LAYER_NUM=str(blocks), SKYTPU_SEQ_LEN=str(BERT_SEQ),
        SKYTPU_BATCH_SIZE=str(BERT_BATCH), SKYTPU_CORE_NUM=str(BERT_WORKERS),
        SKYTPU_ALLOCATE_TYPE="optimal", SKYTPU_SCHEDULE="1f1b",
        SKYTPU_MICROBATCHES=str(BERT_MICROBATCHES),
        SKYTPU_MAX_ITERS=str(BERT_STEPS), SKYTPU_PROFILE="static",
        SKYTPU_LOG_ROOT=str(workdir / "logs"))
    saved = {k: os.environ.get(k) for k in [*env, "SKYTPU_FLASH",
                                            "SKYTPU_CKPT_DIR"]}
    for k in ("SKYTPU_FLASH", "SKYTPU_CKPT_DIR"):
        os.environ.pop(k, None)
    os.environ.update(env)
    try:  # the config reads its environment when it is loaded
        cfg = load_config(str(
            ROOT / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    units = cfg.model_config
    gcfg = units[0]["config"]
    width = bert_config(preset)
    check([u["layer_type"] for u in units] == (
        ["GptEmbeddings"] + ["GptBlock_Attn", "GptBlock_Mlp"] * blocks
        + ["GptLmHead"]) and gcfg["hidden_size"] == width.hidden_size
        and gcfg["num_attention_heads"] == width.num_attention_heads
        and gcfg["vocab_size"] == 50257 and gcfg["dtype"] == width.dtype
        and cfg.train_config["loss_cfg"] == dict(type="CausalLmLoss"),
        f"the config under SKYTPU_MODEL=gpt: {len(units)} GPT units at "
        f"hidden {gcfg['hidden_size']}, {gcfg['num_attention_heads']} "
        f"heads, vocabulary {gcfg['vocab_size']}, {gcfg['dtype']}, "
        f"{cfg.train_config['loss_cfg']['type']}")
    run, record, launches, wall, facts = launcher_run(
        torch, np, kernels, "gpt_launcher", cfg)
    check_launches(launches, {}, "GPT's dense attention: no kernel")
    check(all(s["interleaved"] for s in record.steps),
          "every step ran under 1F1B")
    before, after = facts["first_batch_loss"]
    check(after < before, f"the first batch's causal-LM loss falls over "
          f"the run: {before:.5f} -> {after:.5f}")
    e2e = launcher_e2e(torch, np, run, record, launches, wall,
                       BERT_BATCH * BERT_SEQ, facts)
    log(f"   partition {e2e['partition']} (device order "
        f"{e2e['device_order']}), {e2e['parameters'] / 1e6:.1f} M "
        f"parameters; steps {[round(x * 1e3, 1) for x in e2e['step_s']]} "
        f"ms, median of 2-5 {e2e['step_s_median_2_on'] * 1e3:.1f} ms, "
        f"{e2e['items_per_s']:.0f} tokens/s, MFU {e2e['mfu']:.2%}, peak "
        f"{e2e['peak_mem_gb']:.2f} GB; losses "
        f"{[round(x, 5) for x in e2e['losses']]}, first batch "
        f"{before:.5f} -> {after:.5f}")
    log(f"   e2e: {json.dumps(e2e)}")
    del run
    return e2e


def check_preflight(runner):
    """The runner verified its plan once, before its first step: an
    ``ok`` report over coverage, shapes, memory and donation."""
    reports = runner.preflight_reports
    check(len(reports) == 1 and reports[0].ok and reports[0].checks
          == ["coverage", "shapes", "memory", "donation"],
          f"pre-flight: {[r.summary() for r in reports]}")
    log(f"   pre-flight {reports[0].elapsed_s:.3f} s over "
        f"{reports[0].layers} units, {reports[0].stages} stages")
    return dict(seconds=reports[0].elapsed_s, summary=reports[0].summary())


def headline(np, model_cfg, static_bench, model_bench, vocab_size,
             devices=None):
    """The package's headline pass (``dynamics/headline.py``) on the
    trainer's model and batch, under the paper's slowdowns, with the
    static model's prediction beside it.  Optimal must beat even at
    every microbatch count."""
    from skycomputing_tpu_torch.dynamics.headline import (
        HEADLINE_MICROBATCHES,
        headline_pass,
        worker_slowdowns,
    )

    data, _ = bert_batch(np, vocab_size)
    head = headline_pass(
        model_cfg, model_bench, data, worker_slowdowns(BERT_WORKERS, "paper"),
        static_bench.benchmark()[0], devices=devices,
        log=lambda line: log(f"   {line}"))
    for m in HEADLINE_MICROBATCHES:
        even, opt = head["even_step_s"][m], head["optimal_step_s"][m]
        check(opt < even,
              f"M={m}: optimal {opt * 1e3:.1f} ms < even {even * 1e3:.1f} "
              f"ms (means of {head['optimal']['step_s'][m] * 1e3:.1f}, "
              f"{head['optimal_again']['step_s'][m] * 1e3:.1f} and "
              f"{head['even']['step_s'][m] * 1e3:.1f}, "
              f"{head['even_again']['step_s'][m] * 1e3:.1f}; "
              f"{head['speedup'][m]:.1%} faster)")
    return head



# --------------------------------------------------------------------------
# phases 17-18: the GLUE path with evaluation, and the bench
# --------------------------------------------------------------------------

GLUE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "movie", "was", "great", "terrible", "fine",
    "a", "film", "it", "truly", "##ly", "good", "bad",
]
GLUE_TRAIN_ROWS = BERT_BATCH * BERT_STEPS  # one epoch of the run's steps
GLUE_DEV_ROWS = 100  # three full batches and a ragged one of 4
# the bench at its defaults (64 workers, 53 encoder layers at ffn/2:
# about half a minute on an H100), under a deadline well inside the
# smoke's time
BENCH_SMOKE_ENV = dict(SKYTPU_BENCH_DEADLINE_S="300")


def write_glue(np, root):
    """A WordPiece vocabulary and MNLI-format ``train.tsv`` and
    ``dev_matched.tsv`` (text_a in column 8, text_b in 9, the label
    last) written from a seed: the label is set by a keyword, as in
    ``tests/test_glue_real_data.py``.  Returns (data dir, vocab file)."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(GLUE_VOCAB) + "\n")
    labels = ["contradiction", "entailment", "neutral"]
    keyword = dict(contradiction="terrible", entailment="great",
                   neutral="fine")
    header = "\t".join(f"col{i}" for i in range(12))
    rows = []
    for i in range(GLUE_TRAIN_ROWS + GLUE_DEV_ROWS):
        label = labels[int(rng.integers(0, 3))]
        text_a = f"the movie was {keyword[label]}"
        text_b = "it was a film truly " + " ".join(
            rng.choice(["good", "bad", "fine"], size=int(rng.integers(1, 6))))
        rows.append("\t".join([str(i)] + ["x"] * 7
                              + [text_a, text_b, "x", label]))
    (root / "train.tsv").write_text(
        "\n".join([header] + rows[:GLUE_TRAIN_ROWS]) + "\n")
    (root / "dev_matched.tsv").write_text(
        "\n".join([header] + rows[GLUE_TRAIN_ROWS:]) + "\n")
    return str(root), str(vocab)


def glue_loader(data_cfg, split, batch):
    """The config's GLUE dataset at ``split``, batched in the order the
    model takes, the last batch kept however short."""
    from skycomputing_tpu_torch.builder import build_dataloader_from_cfg
    from skycomputing_tpu_torch.launch import BatchAdapter

    return BatchAdapter(build_dataloader_from_cfg(dict(
        dataset_cfg=dict(data_cfg["dataset_cfg"], split=split),
        dataloader_cfg=dict(batch_size=batch, drop_last=False))))


def glue_path(torch, np, kernels, workdir, layers=24, preset="large",
              device=None, ptxas=None):
    """``launch.run`` on the port's config over MNLI TSVs written from a
    seed (``SKYTPU_GLUE_DIR``, ``SKYTPU_VOCAB_FILE``), with ``EvalHook``,
    ``MetricsHook`` and ``NanGuardHook``; then ``Runner.evaluate`` on the
    dev split with every kernel's launches set to 0 just before and read
    just after: a forward without rematerialization, one B1 launch per
    encoder layer per batch.  On the card, a profile of one eval batch
    and B1 against its plain version at the eval path's own calls."""
    import os

    from skycomputing_tpu_torch import launch
    from skycomputing_tpu_torch.builder import build_hook
    from skycomputing_tpu_torch.config import load_config
    from skycomputing_tpu_torch.runner import EvalHook, NanGuardHook
    from skycomputing_tpu_torch.utils import Logger

    data_dir, vocab_file = write_glue(np, workdir / "mnli")
    env = dict(launcher_env(workdir, preset, layers), SKYTPU_CKPT_DIR="",
               SKYTPU_GLUE_DIR=data_dir, SKYTPU_VOCAB_FILE=vocab_file)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config(str(
            ROOT / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dev = glue_loader(cfg.data_config, "dev", BERT_BATCH)
    check(not dev._loader.dataset.synthetic
          and len(dev._loader.dataset) == GLUE_DEV_ROWS,
          f"the dev split read from the TSVs: {GLUE_DEV_ROWS} rows, "
          f"{len(dev)} batches")
    metrics_path = workdir / "metrics.jsonl"
    hooks = [EvalHook(dev, interval=1, max_batches=1),
             build_hook(dict(type="MetricsHook", path=str(metrics_path))),
             build_hook(dict(type="NanGuardHook", action="raise"))]
    check(isinstance(hooks[2], NanGuardHook), "the hooks build by name")
    run = launch.run(cfg, Logger(**cfg.logging_config), device=device,
                     hooks=hooks)
    check(run is not None, "the launcher allocated and trained on MNLI")
    train_ds = run.runner.data_loader._loader.dataset
    mask = train_ds.input_mask
    check(not train_ds.synthetic and len(train_ds) == GLUE_TRAIN_ROWS,
          f"trained on the TSVs: {len(train_ds)} rows, real lengths "
          f"{int(mask.sum(1).min())}-{int(mask.sum(1).max())} of "
          f"{mask.shape[1]}")
    preflight = check_preflight(run.runner)
    check(run.runner.iter == BERT_STEPS
          and len(run.runner.eval_history) == 1,
          f"{run.runner.iter} steps, then EvalHook at the epoch's end: "
          f"{json.dumps(run.runner.eval_history)}")
    records = [json.loads(line)
               for line in metrics_path.read_text().splitlines()]
    check(records[0]["event"] == "run_start"
          and len(records) == 1 + BERT_STEPS
          and all(r["run_id"] == records[0]["run_id"]
                  and np.isfinite(r["loss"]) for r in records[1:]),
          f"metrics JSONL: a run_start header (config_hash "
          f"{records[0]['config_hash']}) and {len(records) - 1} finite "
          f"iteration records")

    for k in kernels.values():
        k["fn"].launches = 0
    if device is None:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run.runner.evaluate(dev, task="mnli")
    if device is None:
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    check(np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0
          and metrics["num_examples"] == GLUE_DEV_ROWS,
          f"evaluate: {json.dumps(metrics)}")
    check_launches(launches, {"flash_attention": layers * len(dev)},
                   f"B1 {layers} x {len(dev)} eval batches (a forward, no "
                   f"remat)")
    out = dict(eval=metrics, eval_s=eval_s, eval_s_per_batch=eval_s
               / len(dev), launches=launches,
               train_losses=[r["loss"] for r in records[1:]],
               partition=run.model.partition_signature(),
               preflight=preflight)
    if device is None:
        flash = kernels["flash_attention"]["fn"]
        before = flash.launches
        prof, rows = profile_window(
            torch, lambda: run.runner.evaluate(dev, max_batches=1))
        b1_us = sum(us for us, key, _ in rows
                    if "flash_attention_kernel" in key)
        total_us = sum(us for us, _, _ in rows)
        prof.update(flash_launches=flash.launches - before,
                    flash_device_ms=b1_us / 1e3,
                    flash_share=b1_us / total_us if total_us else None)
        out["profile_eval_batch"] = {k: v for k, v in prof.items()
                                     if k != "top"}
        log(f"   profile one eval batch: "
            f"{json.dumps(out['profile_eval_batch'])}")
        out["flash_eval_shapes"] = flash_eval_checks(torch, np, ptxas, run,
                                                     dev)
    log(f"   glue: {json.dumps(out)}")
    del run
    return launches, dev, out


def flash_eval_checks(torch, np, ptxas, run, dev):
    """B1 at the calls the eval path makes: ``Runner.evaluate`` feeds the
    whole dev batch (32 rows, and the ragged last 4) through each layer
    in the model's dtype, with a bias row of -10000 on all but the 13-17
    live keys of 128.  One more evaluation records the first layer's
    (q, k, v, bias) for each batch size; the kernel is then held against
    the plain version on those tensors, and on q/k/v ~ N(0, 1) of the
    same shape and dtype under the same bias, and timed beside the plain
    version and SDPA on the recorded ones."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.models import bert as bert_mod
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    seen = {}
    real = bert_mod.flash_attention

    def record(q, k, v, bias):
        seen.setdefault(q.shape[0], tuple(t.detach().clone()
                                          for t in (q, k, v, bias)))
        return real(q, k, v, bias)

    bert_mod.flash_attention = record
    try:
        run.runner.evaluate(dev)
    finally:
        bert_mod.flash_attention = real
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rows = []
    for B in sorted(seen, reverse=True):
        q, k, v, bias = seen[B]
        rng = np.random.default_rng(700 + B)
        normal = tuple(torch.from_numpy(rng.standard_normal(tuple(q.shape))
                                        .astype(np.float32)).to(q)
                       for _ in range(3))
        live = (bias == 0).sum(-1)
        for inputs, what in (((q, k, v), "activations"),
                             (normal, "normal")):
            scale = q.shape[-1] ** -0.5
            out = flash_attention(*inputs, bias)
            ref = flash_attention_reference(*inputs, bias, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            row = dict(kernel="flash_attention", case=f"eval_B{B}_{what}",
                       B=B, L=q.shape[1], H=q.shape[2], D=q.shape[3],
                       live_keys=[int(live.min()), int(live.max())],
                       dtype=str(q.dtype).replace("torch.", ""),
                       max_abs_err=err, tol=tol[q.dtype],
                       out_abs_max=out.float().abs().max().item(),
                       **flash_body(torch, ptxas, q))
            if what == "activations":
                qh, kh, vh = (t.transpose(1, 2).contiguous()
                              for t in inputs)
                mask = bias[:, None, None, :]
                row.update(
                    ms=time_ms(torch, lambda: flash_attention(*inputs, bias)),
                    plain_ms=time_ms(torch, lambda: flash_attention_reference(
                        *inputs, bias, scale)),
                    library_ms=time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask)))
                row["bound_ms"], row["bound_by"], extra = flash_bound(
                    q, bias, row["dtype"], row["body"])
                row.update(extra)
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[q.dtype],
                  f"flash_attention eval B={B} {what} {row['dtype']} "
                  f"({row['body']}): max |err| {err:.3g} <= "
                  f"{tol[q.dtype]}")
            rows.append(row)
    check(sorted(seen) == sorted({len(labels) for _, labels in dev}),
          f"B1 checked at every eval batch size: {sorted(seen)}")
    return rows


def eval_card_vs_cpu(torch, np, dev):
    """``Runner.evaluate`` at BERT-large's width, depth 2, float32, flash
    on, on the card and on the CPU from the same weights, over the dev
    loader's first two batches: the losses and every prediction."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.ops.flash_attention import flash_attention
    from skycomputing_tpu_torch.runner import Runner

    cfg = bert_config("large", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=2, num_classes=3,
                                   deterministic=True)
    card, card_ps, wm = build_trainer(torch, model_cfg)
    host, host_ps, host_wm = build_trainer(
        torch, model_cfg, devices=[torch.device("cpu")],
        state_dicts=card_ps.params)
    batches = [batch for _, batch in zip(range(2), dev)]
    out = {}
    for name, model, ps, pool in (("cuda", card, card_ps, wm),
                                  ("cpu", host, host_ps, host_wm)):
        runner = Runner(model, ps, pool, max_epochs=0, max_iters=0)
        zero_counts({B1: dict(fn=flash_attention)})
        metrics = runner.evaluate(batches, task="mnli")
        model.train(False)
        preds = [model.forward(data).float().argmax(-1).cpu().numpy()
                 for data, _ in batches]
        model.train(True)
        out[name] = dict(metrics=metrics,
                         predictions=np.concatenate(preds).tolist(),
                         b1=dict(launches=flash_attention.launches,
                                 bodies=dict(flash_attention.body_launches)))
    out["loss_rel_diff"] = (abs(out["cuda"]["metrics"]["loss"]
                                - out["cpu"]["metrics"]["loss"])
                            / abs(out["cpu"]["metrics"]["loss"]))
    return out


def bench_run(np, env_extra, timeout_s):
    """``python -m skycomputing_tpu_torch.bench`` in a subprocess; its
    stdout must be exactly one JSON line, a complete run on the card
    whose even and optimal partitions each cover every unit."""
    import os

    env = dict(os.environ, **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "skycomputing_tpu_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-40:]:
        log(f"   | {line}")
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"the bench exited {proc.returncode} after {wall:.1f} s with "
          f"{len(lines)} stdout line(s)")
    line = json.loads(lines[0])
    # one "{label}: pre-flight plan-check ..." summary per allocation built
    seconds = [float(m.group(1)) for m in re.finditer(
        r": pre-flight plan-check ok: .*, ([0-9.]+)s$", proc.stderr,
        re.MULTILINE)]
    check(len(seconds) > 0, f"{len(seconds)} pre-flight reports, all ok")
    line["preflight_reports"] = len(seconds)
    line["preflight_slowest_s"] = max(seconds)
    log(f"   bench pre-flight: {len(seconds)} reports, slowest "
        f"{max(seconds):.3f} s, total {sum(seconds):.3f} s")
    for key in ("metric", "value", "vs_baseline", "platform", "device_kind",
                "units", "even_partition", "optimal_partition", "solver_gap",
                "refine_steps", "even_steps", "polish_moves",
                "final_remeasure", "calibration", "value_ffn1_model",
                "phases_skipped", "partial", "pass_s", "elapsed_s"):
        log(f"   bench {key}: {json.dumps(line.get(key))}")
    check(line["platform"] == "gpu" and line["partial"] is None
          and line["value"] is not None and np.isfinite(line["value"]),
          f"a complete run on the card: {line['value']}% "
          f"(vs_baseline {line['vs_baseline']})")
    for side in ("even_partition", "optimal_partition"):
        counts = line[side]
        check(sum(counts) == line["units"] and min(counts) > 0,
              f"{side} {counts} covers the {line['units']} units")
    line["wall_s"] = wall
    return line

# --------------------------------------------------------------------------
# phase 19: pre-flight, tracing and self-heal
# --------------------------------------------------------------------------

# a 6x stage: at 4x a fast host's straggler era can read 1.55x its
# baseline, where SelfHealHook's EWMA and its baseline's upward drift
# (alpha 0.4) meet its 1.35 threshold and no heal fires (selfheal_ab.py)
HEAL_STEPS, HEAL_FAULT_ITER, HEAL_FACTOR, UNTRACED_STEPS = 20, 4, 6.0, 5


def strict_json(text):
    """``json.loads`` that refuses NaN and Infinity."""
    def refuse(token):
        raise ValueError(f"non-standard JSON constant {token}")
    return json.loads(text, parse_constant=refuse)


def selfheal_path(torch, np, kernels, model_cfg, vocab_size, static_bench,
                  workdir, device=None):
    """BERT-large (75 units, flash on) evenly over 4 workers on the card,
    GPipe M=4, from an ``Allocator`` over the static profile.  First a
    tampered plan (worker 0's last unit dropped) must be refused by the
    pre-flight before any step; then ``Runner.train`` for 20 steps with
    ``TraceHook``, a 6x slowdown of worker 0 at iteration 4 and
    ``SelfHealHook`` on real clocks: one heal away from worker 0,
    verified again before the next step; then 5 untraced steps.  Every
    kernel's launches are set to 0 just before the run and read just
    after."""
    from skycomputing_tpu_torch.analysis import PlanError
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        FaultInjectionHook,
        FaultPlan,
        ParameterServer,
        WorkerManager,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd
    from skycomputing_tpu_torch.runner import (
        Hook,
        Runner,
        SelfHealHook,
        TraceHook,
    )
    from skycomputing_tpu_torch.telemetry import analysis

    flash = kernels["flash_attention"]["fn"]
    data, labels = bert_batch(np, vocab_size)
    loader = [(data, labels)] * HEAL_STEPS
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=0))
        for i in range(BERT_WORKERS)])
    devices = [torch.device(device)] if device is not None else None
    on_card = device is None

    def sync():
        if on_card:
            torch.cuda.synchronize()

    allocator = Allocator(model_cfg, wm, static_bench,
                          proxy_device_benchmarker(wm, devices=devices))
    allocator.even_allocate()
    even = [len(w.model_config) for w in wm.worker_pool]
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(SEED))
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=devices,
                          num_microbatches=BERT_MICROBATCHES)
    M, S = BERT_MICROBATCHES, len(model.stages)
    layers = sum(u["layer_type"] == "BertLayer_Head" for u in model_cfg)

    # 1. the tamper: refused before the first step, no B1 launch
    first = wm.get_by_rank(0)
    kept = first.model_config
    first.model_config = kept[:-1]
    tampered = Runner(model, ps, wm, max_epochs=1, max_iters=HEAL_STEPS)
    flash.launches = 0
    try:
        tampered.train(loader)
        refused = None
    except PlanError as exc:
        refused = exc
    check(refused is not None and "coverage" in str(refused)
          and tampered.iter == 0 and flash.launches == 0,
          f"the tampered plan is refused at iteration {tampered.iter} with "
          f"{[i.code for i in getattr(refused, 'issues', [])]}, "
          f"{flash.launches} B1 launches")
    first.model_config = kept

    # 2. the run: trace, fault, heal, and clocks around each step
    class Clock(Hook):
        """Registered last: its before_iter is the last before the step,
        its after_iter the last after it (the heal's cost included)."""

        def __init__(self):
            self.times, self.launches0 = [], 0
            self._t0 = None

        def before_iter(self, runner):
            self.launches0 = flash.launches
            self._t0 = time.perf_counter()

        def after_iter(self, runner):
            sync()
            self.times.append(time.perf_counter() - self._t0)

    class StepLaunches(Hook):
        """Registered first: B1's launches of the step alone."""

        def __init__(self, clock):
            self.clock, self.per_step, self.losses = clock, [], []

        def after_iter(self, runner):
            self.per_step.append(flash.launches - self.clock.launches0)
            self.losses.append(runner.model.stats.loss)

    trace_path = workdir / "selfheal_trace.json"
    clock = Clock()
    steps = StepLaunches(clock)
    heal = SelfHealHook(allocator, window=2, k_windows=2, threshold=1.35,
                        grace_iters=1, baseline_windows=1, max_heals=1,
                        measure_repeats=1, measure_inner=1,
                        solver_time_s=5.0)
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=HEAL_STEPS)
    for hook in (steps, TraceHook(str(trace_path)), FaultInjectionHook(
            FaultPlan([dict(iter=HEAL_FAULT_ITER, kind="slowdown", worker=0,
                            factor=HEAL_FACTOR)])), heal, clock):
        runner.register_hook(hook)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    runner.train(loader)
    sync()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    # 3. the checks
    reports = runner.preflight_reports
    check(len(reports) == 2 and all(r.ok for r in reports),
          f"pre-flight ran {len(reports)} times in the run (before step 1 "
          f"and after the heal): {[r.summary() for r in reports]}")
    heals = [e for e in heal.events if e["kind"] == "heal"]
    check(len(heals) == 1 and heal.heals == 1,
          f"one heal: {[(e['kind'], e['iter']) for e in heal.events]}")
    ev = heals[0]
    div = ev["divergence"]
    worst = max(div, key=div.get)
    check(worst == 0 and div[0] > 1.3,
          f"the largest divergence is worker 0's: "
          f"{ {k: round(v, 3) for k, v in div.items()} }")
    slow = next(w for w in wm.worker_pool if w.stim_index == 0)
    cover = [u for w in sorted(wm.worker_pool, key=lambda w: w.rank)
             for u in (w.model_config or [])]
    check(len(slow.model_config or []) < even[0]
          and [id(u) for u in cover] == [id(u) for u in model_cfg],
          f"worker 0 holds {len(slow.model_config or [])} units (even "
          f"{even[0]}); partition {ev['old_partition']} -> "
          f"{ev['new_partition']}, a contiguous cover of "
          f"{len(model_cfg)} units")
    check(runner.iter == HEAL_STEPS and len(steps.losses) == HEAL_STEPS
          and all(np.isfinite(x) for x in steps.losses),
          f"{runner.iter} steps, every loss finite")
    per_step = 2 * layers * M if on_card else 0
    check(steps.per_step == [per_step] * HEAL_STEPS,
          f"B1 {per_step} launches in each step, before and after the heal: "
          f"{sorted(set(steps.per_step))}")
    heal_at = ev["iter"]
    times = clock.times
    baseline = times[1:HEAL_FAULT_ITER]
    # the slowed steps before the heal's own (whose window holds the
    # heal's cost)
    straggler = times[HEAL_FAULT_ITER:heal_at - 1]
    post = times[heal_at + 2:]
    check(len(straggler) >= 2 and len(post) >= 4
          and np.mean(post) < np.mean(straggler),
          f"post-heal mean step {np.mean(post) * 1e3:.1f} ms below the "
          f"straggler era's {np.mean(straggler) * 1e3:.1f} ms")

    # the trace
    trace = strict_json(trace_path.read_text())
    events = trace["traceEvents"]
    procs = analysis.lane_processes(events)
    stage_pids = {pid for pid, name in procs.items()
                  if analysis.STAGE_RE.match(name)}
    iters = sorted((e for e in events
                    if e["ph"] == "X" and e["name"] == "iter"),
                   key=lambda e: e["ts"])
    arc = [e for e in events if e["name"] == "self_heal"]
    check([e["ph"] for e in arc] == ["b", "e"]
          and arc[1]["args"]["outcome"] == "healed",
          f"the self_heal arc opens and closes: "
          f"{[(e['ph'], e.get('args')) for e in arc]}")
    heal_ts = arc[0]["ts"]
    before = analysis.analyze(
        [e for e in events if e["ph"] == "M" or e["ts"] < heal_ts])
    check(before["num_stages"] == S,
          f"{before['num_stages']} stage lanes before the heal")
    stages_after = len(ev["new_partition"])
    bad = []
    for i, it in enumerate(iters):
        t0_, t1_ = it["ts"], it["ts"] + it["dur"]
        n_stages = S if it["args"]["iter"] < heal_at else stages_after
        got = {name: sum(1 for e in events if e["ph"] == "X"
                         and e["name"] == name and e["pid"] in stage_pids
                         and t0_ <= e["ts"] < t1_)
               for name in ("fwd", "bwd", "update")}
        if got != dict(fwd=M * n_stages, bwd=M * n_stages, update=n_stages):
            bad.append((it["args"]["iter"], got))
    check(len(iters) == HEAL_STEPS and not bad,
          f"{len(iters)} iter spans, each with M x stages fwd and bwd and "
          f"one update per stage (mismatches: {bad})")
    report = analysis.analyze(events)
    check(report["dispatch"]["steps"] == HEAL_STEPS,
          f"{report['dispatch']['steps']} host_dispatch spans")

    def span_s(name):
        return sum(analysis.named_durations(events, name)) / 1e6

    heal_cost = dict(
        measure_s=span_s("selfheal.measure"),
        solve_s=span_s("allocator.solve"),
        profiles_and_calibrate_s=(span_s("allocator.profiles")
                                  + span_s("allocator.calibrate")),
        rebuild_s=span_s("selfheal.rebuild"),
        heal_iteration_s=times[heal_at - 1])

    # tracing off: 5 more steps on the healed partition
    off = Runner(model, ps, wm, max_epochs=1, max_iters=UNTRACED_STEPS)
    off_clock = Clock()
    off.register_hook(off_clock)
    off.train([(data, labels)] * UNTRACED_STEPS)
    out = dict(
        wall_s=wall, even_partition=even,
        partition_before=ev["old_partition"],
        partition_after=ev["new_partition"],
        heal_iter=heal_at, divergence=div, measured_s=ev["measured"],
        step_ms=[t * 1e3 for t in times],
        baseline_median_ms=float(np.median(baseline)) * 1e3,
        straggler_median_ms=float(np.median(straggler)) * 1e3,
        post_heal_median_ms=float(np.median(post)) * 1e3,
        straggler_over_baseline=float(np.median(straggler)
                                      / np.median(baseline)),
        post_over_baseline=float(np.median(post) / np.median(baseline)),
        heal_cost=heal_cost,
        preflight_s=[r.elapsed_s for r in reports],
        bubble_fraction=report["bubble_fraction"],
        dispatch_share=report["dispatch"]["share"],
        stage_utilization=report["stage_utilization"],
        peak_mem_gb=peak_gb, b1_per_step=per_step,
        traced_post_heal_median_ms=float(np.median(post)) * 1e3,
        untraced_median_ms=float(np.median(off_clock.times[1:])) * 1e3,
        trace_events=len(events), launches=launches)
    log(f"   selfheal: {json.dumps(out)}")
    del runner, off, tampered, model, ps
    return launches, out


# --------------------------------------------------------------------------
# phase 20: serving allocation and multi-stage serving
# --------------------------------------------------------------------------

SERVE_MEM_LIMIT_MB = 1000.0  # per worker: GPT-2 small's units need 1,542 MB


def serving_allocation(torch, np, gpt_mod, kv_dtype):
    """``Allocator.serving_allocate`` over GPT-2 small's 26 units (bf16)
    at the serving phases' operating point: ``DecodeModelBenchmarker``
    (16 rows, 512-token span, 512 pages of 16, ``kv_dtype``), four
    workers with the launcher phase's stimulated speeds (the proxy model
    timed on the card, times the stimulator's draws) and memory
    (``mem_limit`` over the stimulator's memory draws: budgets that
    bind, so the pages' size moves the partition).  Returns (the worker
    manager, a report)."""
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.serving import (
        DecodeModelBenchmarker,
        paged_kv_mb_per_layer,
    )
    from skycomputing_tpu_torch.stimulator import Stimulator

    layer_cfgs = gpt_mod.gpt_layer_configs(
        gpt_mod.GptConfig(dropout_prob=0.0, dtype="bfloat16"),
        num_blocks=LAYERS)
    wm = worker_pool(4)
    for w in wm.worker_pool:
        w.extra_config["mem_limit"] = SERVE_MEM_LIMIT_MB
    devices = proxy_device_benchmarker(wm, stimulator=Stimulator(4))
    decode = DecodeModelBenchmarker(layer_cfgs, slots=16, max_len=512,
                                    num_pages=512, page_size=16,
                                    kv_dtype=kv_dtype)
    t0 = time.perf_counter()
    flops, mem = decode.benchmark()
    profile_s = time.perf_counter() - t0
    alloc = Allocator(layer_cfgs, wm, None, devices)
    t0 = time.perf_counter()
    alloc.serving_allocate(decode, max_time=5)
    solve_s = time.perf_counter() - t0
    budgets = {name: r["avai_mem"]
               for name, r in devices.benchmark().items()}
    kv_mb = paged_kv_mb_per_layer(layer_cfgs, 512, 16, kv_dtype=kv_dtype)
    stages, cursor = [], 0
    for w in sorted((w for w in wm.worker_pool if w.model_config),
                    key=lambda w: w.rank):
        n = len(w.model_config)
        stages.append(dict(
            worker=w.name, rank=w.rank, units=n,
            charged_mb=float(sum(mem[cursor:cursor + n])),
            kv_mb=float(sum(kv_mb[cursor:cursor + n])),
            solver_budget_mb=budgets[f"worker{w.rank}"],
            verifier_budget_mb=w.extra_config["mem_limit"]))
        cursor += n
    for row in stages:
        log(f"   {kv_dtype or 'fp'} stage {json.dumps(row)}")
    check(cursor == len(layer_cfgs) and len(stages) > 1 and all(
        r["charged_mb"] <= r["solver_budget_mb"] for r in stages),
          f"{kv_dtype or 'fp'} pages: partition "
          f"{[r['units'] for r in stages]} covers the "
          f"{len(layer_cfgs)} units over {len(stages)} stages, each "
          f"stage's charged MB within its budget")
    return wm, dict(partition=[r["units"] for r in stages], stages=stages,
                    profile_s=profile_s, solve_s=solve_s,
                    operating_point=decode.operating_point,
                    bottleneck=alloc.last_result.bottleneck,
                    gap=alloc.last_result.optimality_gap)


def same_run(what, e2e, one, kernel, streams, one_streams):
    """A multi-stage run against its one-stage twin: equal token streams,
    equal scheduling, and ``kernel``'s launches equal by body."""
    check(streams == one_streams,
          f"{what}: greedy streams equal the one-stage engine's "
          f"({len(streams)} requests x {len(streams[0])} tokens)")
    for key in ("prefill_waves", "decode_ticks", "spec_ticks"):
        check(e2e[key] == one[key], f"{what}: {key} {e2e[key]} == "
              f"{one[key]} at one stage")
    check(e2e["body_launches"][kernel] == one["body_launches"][kernel]
          and e2e["launches"] == one["launches"],
          f"{what}: {kernel} launches by body "
          f"{json.dumps(e2e['body_launches'][kernel])} equal the "
          f"one-stage engine's")


def stage_line(stage_runs, one_runs):
    """End-to-end numbers of runs at several stages against runs at one,
    taken in turns in one phase (a process's later phases run slower
    than its earlier ones, so only runs side by side compare): each
    run's value, then each side's mean."""
    keys = ("tokens_per_s", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s",
            "tpot_p95_s", "peak_mem_gb")
    out = {}
    for key in keys:
        a = [e[key] for e in stage_runs]
        b = [e[key] for e in one_runs]
        ratio = (sum(a) * len(b)) / (sum(b) * len(a)) if sum(b) else None
        out[key] = dict(stages=a, one=b, ratio=ratio)
        log(f"   {key}: {len(stage_runs[0]['stages'])} stages "
            f"{', '.join(f'{v:.6g}' for v in a)}; 1 stage "
            f"{', '.join(f'{v:.6g}' for v in b)}; ratio of the means "
            f"{ratio}")
    return out


SPEC_PARTITION = (7, 7, 6, 6)  # stage 0 holds the draft's 5 units


def serving_stages_path(torch, serve_args, one_stage):
    """Phase 20.  ``one_stage``: the one-stage runs to hold the stages
    against, ``{"fp" | "int8" | "spec": (e2e, token streams)}``.  Returns
    (a report, the phase's launches by kernel, its tensor-core prefill
    launches by kernel)."""
    _, np, gpt_mod, ServingEngine, _, _ = serve_args
    from skycomputing_tpu_torch.analysis import PlanError

    stages_report, stage_launches = {}, {B1: 0, B2: 0, B3: 0}
    stage_prefill = {B2: 0, B3: 0}

    def count(e2e):
        for name, n in e2e["launches"].items():
            stage_launches[name] += n
        for name in stage_prefill:
            stage_prefill[name] += e2e["body_launches"][name][
                "tensor_core"]

    # 1-3: a serving allocation over four workers, fp and int8 pages,
    # served as stages of one engine on the card
    for kv_dtype, kernel, (one, one_streams) in (
            (None, B2, one_stage["fp"]), ("int8", B3, one_stage["int8"])):
        label = kv_dtype or "fp"
        wm, alloc = serving_allocation(torch, np, gpt_mod, kv_dtype)
        engine, reqs, snap, launches, e2e = serve(
            *serve_args, worker_manager=wm, kv_dtype=kv_dtype)
        count(e2e)
        check(e2e["stages"] == alloc["partition"],
              f"{label}: the engine's stages {e2e['stages']} are the "
              f"allocation's")
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        check_launches(launches, {kernel: LAYERS * steps},
                       f"{label}, {len(e2e['stages'])} stages: 12 x "
                       f"{steps} steps of {kernel}")
        # 4: the same tokens and the same launches as one stage
        same_run(f"{label}, {len(e2e['stages'])} stages", e2e, one,
                 kernel, [list(r.tokens) for r in reqs], one_streams)
        del engine
        # 8: end-to-end at four stages against one, in turns (4, 1, 1, 4)
        turns = {"stages": [e2e], "one": []}
        for side, kw in (("one", {}), ("one", {}),
                         ("stages", dict(worker_manager=wm))):
            engine, _, _, _, again = serve(*serve_args, kv_dtype=kv_dtype,
                                           **kw)
            count(again)
            turns[side].append(again)
            del engine
        alloc.update(e2e=e2e, in_turns=stage_line(turns["stages"],
                                                  turns["one"]))
        stages_report[label] = alloc
        if kv_dtype is None:
            fp_wm = wm
    check(stages_report["fp"]["partition"]
          != stages_report["int8"]["partition"],
          f"the KV pages' size moves the partition: fp "
          f"{stages_report['fp']['partition']}, int8 "
          f"{stages_report['int8']['partition']}")

    # 5: speculation over an explicit partition whose stage 0 holds
    # the draft (embeddings and 2 blocks: 5 units)
    k, d, partition = 4, 2, list(SPEC_PARTITION)
    engine, reqs, snap, launches, e2e = serve(
        *serve_args, partition=partition, spec_k=k, draft_blocks=d,
        quiet_after=d)
    count(e2e)
    check(e2e["stages"] == partition and engine._draft_mb > 0,
          f"speculation over {partition}, the draft in stage 0, its "
          f"head charged {engine._draft_mb:.3f} MB there")
    one, one_streams = one_stage["spec"]
    same_run(f"speculative, {len(partition)} stages", e2e, one, B2,
             [list(r.tokens) for r in reqs], one_streams)
    stages_report["spec"] = dict(partition=partition, e2e=e2e,
                                 draft_mb=engine._draft_mb)
    del engine

    # 6: reconfigure mid-run (a page-count change, then a larger
    # bucket), at four stages and at one, on the same schedule
    changes = [(3, dict(num_pages=384)),
               (10, dict(buckets=(32, 64, 128, 256, 512)))]
    runs = {}
    for name, kw in (("stages", dict(worker_manager=fp_wm)),
                     ("one", {})):
        engine, reqs, snap, launches, e2e = serve(
            *serve_args, reconfigure=changes, **kw)
        count(e2e)
        check(engine.num_pages == 384
              and engine.bucketer.max_bucket == 512
              and all(len(st.slabs) == 0 or st.slabs[0][0].shape[0]
                      == 384 for st in engine.stages),
              f"{name}: 384 pages in every stage's slabs, buckets to "
              f"512")
        check(snap["preemptions"] == e2e["reconfigured"][0][
            "preemptions"] > 0 and e2e["reconfigured"][1][
            "preemptions"] == snap["preemptions"],
              f"{name}: the page-count change re-seated "
              f"{snap['preemptions']} running requests, the bucket "
              f"change none")
        runs[name] = (e2e, [list(r.tokens) for r in reqs])
        del engine
    same_run("reconfigured, 4 stages", runs["stages"][0], runs["one"][0],
             B2, runs["stages"][1], runs["one"][1])
    stages_report["reconfigure"] = dict(
        changes=[dict(tick=t, knobs={n: list(v) if isinstance(v, tuple)
                                     else v for n, v in c.items()})
                 for t, c in changes],
        stages=runs["stages"][0], one=runs["one"][0],
        in_turns=stage_line([runs["stages"][0]], [runs["one"][0]]),
        agreement_with_unreconfigured=agreement(runs["stages"][1],
                                                one_stage["fp"][1]))
    log(f"   reconfigured streams agree with the unreconfigured fp "
        f"run at {stages_report['reconfigure']['agreement_with_unreconfigured']:.3f}"
        f" of positions (reported: recomputed KV of evicted requests)")

    # 7: a plan over budget is refused before any slab is allocated: the
    # stage with the most KV pages gets a budget that holds its units
    # but not half its pages
    row = max(stages_report["fp"]["stages"], key=lambda r: r["kv_mb"])
    budget = row["charged_mb"] - row["kv_mb"] / 2
    next(w for w in fp_wm.worker_pool
         if w.name == row["worker"]).extra_config["mem_limit"] = budget
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16", "cuda",
                     worker_manager=fp_wm)
    except PlanError as exc:
        refused = str(exc)
    else:
        raise AssertionError("an over-budget plan was not refused")
    after = torch.cuda.memory_allocated()
    log(f"   refused: {refused.splitlines()[1].strip()}")
    check(after == before and "KV pages" in refused
          and f"KV slabs are {row['kv_mb']:.6g} MB" in refused,
          f"the pre-flight refused {row['worker']} at {budget:.1f} MB (its "
          f"units and half its {row['kv_mb']:.1f} MB of pages), naming the "
          f"KV pages; card memory {before} B before, {after} B after")
    stages_report["refused"] = refused
    stages_report["launches"] = stage_launches
    return stages_report, stage_launches, stage_prefill


# --------------------------------------------------------------------------
# phase 21: the serving bench
# --------------------------------------------------------------------------

# GPT-2 small's width and depth in the bench's own dtype (float32, so the
# identity gates mean what they mean in the reference's bench)
BENCH_MODEL = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=LAYERS,
                   num_attention_heads=12, max_position_embeddings=1024,
                   dropout_prob=0.0, dtype="float32")
# the bf16 rerun's identity gates are findings: a bf16 one-shot forward
# and the kernel round in different places
BF16_REPORTED = frozenset({"live_token_identical",
                           "live_matches_full_gather"})


def bench_section(torch, kernels, name, run, reported=frozenset()):
    """One section of the serving bench with every paged kernel's count
    set to 0 just before it and read just after: its report, launches
    and launches by body.  Prints one JSON line (the gates, the section's
    headline numbers, its launches) and asserts every mechanics gate;
    the timing and int8-fidelity gates (and ``reported``) are printed
    with their values, not asserted."""
    from skycomputing_tpu_torch import bench_serving as bench

    paged = {k: v for k, v in kernels.items() if k != B1}
    for k in paged.values():
        k["fn"].launches = 0
        for body in k["fn"].body_launches:
            k["fn"].body_launches[body] = 0
    t0 = time.perf_counter()
    section = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v["fn"].launches for k, v in paged.items()}
    bodies = {k: dict(v["fn"].body_launches) for k, v in paged.items()}
    soft = bench.TIMING_GATES | bench.FIDELITY_GATES | reported
    findings = {g: v for g, v in section["gates"].items() if g in soft}
    numbers = {
        key: section[key] for key in (
            "throughput_speedup", "concurrency_gain",
            "itl_tail_ratio_unchunked", "itl_tail_ratio_chunked",
            "tokens_per_s_speedup", "accept_rate", "decode_per_token_speedup",
            "pages_per_mb_gain", "int8_agreement",
            "int8_first_token_agreement") if key in section}
    if "shared_prefix" in section:
        numbers["ttft_warm_over_cold"] = section["shared_prefix"][
            "ttft_warm_over_cold"]
    if "chunked" in section:
        for key in ("tpot_tail_ratio", "itl_p95_s", "ttft_p95_s"):
            numbers[f"chunked_{key}"] = section["chunked"][key]
        numbers["unchunked_itl_p95_s"] = section["unchunked"]["itl_p95_s"]
    print(json.dumps(dict(bench_section=name, seconds=seconds,
                          gates=section["gates"], numbers=numbers,
                          launches=launches, body_launches=bodies,
                          identity_findings=section.get(
                              "identity_findings", []))), flush=True)
    for gate, value in section["gates"].items():
        if gate in soft:
            log(f"   finding {name}.{gate}: {value}")
        else:
            check(value, f"{name}: mechanics gate {gate}")
    section.update(seconds=seconds, launches=launches, body_launches=bodies,
                   findings=findings)
    return section


def serving_bench_path(torch, np, kernels, gpt_mod):
    """Phase 21.  The serving bench's sections (``bench_serving.py``) at
    its full-run operating points on GPT-2 small (12 layers, hidden 768,
    vocabulary 50,257, float32, random weights from the seed), one card;
    the kernel section once more in bf16; then the kernel against its
    plain version on the bench's own tiny instance, uncounted.  Returns
    (a report, the phase's launches by kernel, its tensor-core prefill
    launches by kernel, its register-tile launches by kernel)."""
    from skycomputing_tpu_torch import bench_serving as bench

    dev = torch.device("cuda")
    _, bench_cfg, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg = (
        bench.operating_points(smoke=False))
    for op in (bench_cfg, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg):
        op.update(partition=None, device=dev)
    layer_cfgs = gpt_mod.gpt_layer_configs(
        gpt_mod.GptConfig(**BENCH_MODEL), deterministic=True)
    bf16_cfgs = gpt_mod.gpt_layer_configs(
        gpt_mod.GptConfig(**dict(BENCH_MODEL, dtype="bfloat16")),
        deterministic=True)
    params = gpt_mod.random_state_dicts(layer_cfgs, SEED)
    specs = bench.build_workload(
        np.random.default_rng(SEED), bench_cfg["n_requests"],
        list(bench_cfg["buckets"]), bench_cfg["max_len"],
        bench_cfg["lo_new"], bench_cfg["hi_new"])
    runs = (
        ("continuous_vs_static", lambda: bench.continuous_vs_static(
            layer_cfgs, params, specs, bench_cfg), frozenset()),
        ("paged_vs_slot", lambda: bench.paged_vs_slot(
            layer_cfgs, params, paged_cfg, SEED, False), frozenset()),
        ("chunked_backlog", lambda: bench.chunked_backlog(
            layer_cfgs, params, chunk_cfg, SEED, False), frozenset()),
        ("speculative", lambda: bench.speculative(
            dict(BENCH_MODEL), spec_cfg, SEED, False), frozenset()),
        ("kernel_quant", lambda: bench.kernel_quant(
            layer_cfgs, params, kernel_cfg, SEED, False), frozenset()),
        ("kernel_quant_bf16", lambda: bench.kernel_quant(
            bf16_cfgs, params, kernel_cfg, SEED, False), BF16_REPORTED),
    )
    report, launches = {}, {B2: 0, B3: 0}
    prefill, tile = {B2: 0, B3: 0}, {B2: 0, B3: 0}
    for name, run, reported in runs:
        section = bench_section(torch, kernels, name, run, reported)
        report[name] = section
        for kernel in (B2, B3):
            bodies = section["body_launches"][kernel]
            launches[kernel] += section["launches"][kernel]
            prefill[kernel] += bodies["tensor_core"]
            tile[kernel] += bodies["register_tile"]
            check(bodies["query_tile"] == 0,
                  f"{name}: {kernel} never on the query-tile body "
                  f"({json.dumps(bodies)})")
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("paged_vs_slot", "chunked_backlog", "speculative",
                 "kernel_quant"):
        check(report[name]["launches"][B2] > 0,
              f"{name}: B2 launched {report[name]['launches'][B2]} times")
    bf16 = report["kernel_quant_bf16"]["body_launches"]
    f32 = report["kernel_quant"]["body_launches"]
    check(bf16[B2]["tensor_core"] > 0 and bf16[B3]["tensor_core"] > 0
          and bf16[B2]["register_tile"] == bf16[B3]["register_tile"] == 0
          and f32[B2]["register_tile"] > 0 and f32[B3]["register_tile"] > 0
          and f32[B2]["tensor_core"] == f32[B3]["tensor_core"] == 0
          and f32[B2]["decode"] > 0 and f32[B3]["decode"] > 0,
          f"kernel section prefill on the tensor-core body in bf16 "
          f"(B2 {bf16[B2]['tensor_core']}, B3 {bf16[B3]['tensor_core']}) "
          f"and the register-tile body in float32 (B2 "
          f"{f32[B2]['register_tile']}, B3 {f32[B3]['register_tile']}); "
          f"decode on the decode body")
    # the kernel against its plain version: a comparison, so run after
    # the counts were read and not added to them
    leg = bench.kernel_leg(SEED, dev)
    log(f"   kernel leg: {json.dumps(leg['gates'])}; kernel launches "
        f"{json.dumps(leg['kernel']['kernel_launches'])}")
    for gate, value in leg["gates"].items():
        check(value, f"kernel leg: mechanics gate {gate}")
    report["kernel_leg"] = leg
    return report, launches, prefill, tile



# --------------------------------------------------------------------------
# phases 23-25: the rest of the model zoo (long-context BERT through B1,
# GPT's mixture-of-experts block, ResNet-50 on CIFAR-10 shapes)
# --------------------------------------------------------------------------

# (case, B, L, padded tail keys: the last tenth) at BERT-large's heads
LONG_FLASH_CASES = (("long_L1024", 1, 1024, 102), ("long_L2048", 1, 2048, 204),
                    ("long_L4096", 1, 4096, 409))


def flash_long_checks(torch, np, ptxas):
    """Phase 23's kernel rows: B1 against its plain version at long
    BERT's lengths, bf16 (the tensor-core body) at L = 1,024, 2,048 and
    4,096 and float32 (the 3xTF32 body) at 2,048 and at 4,096 (phase
    26's single-device baseline), with the kernel's,
    the plain version's and SDPA's times and the bound, timed as
    :func:`flash_checks` times them.  Outputs shrink as L grows, so bf16
    is also held to ``BF16_LONG_TOL``'s ratios to the plain version's
    scale (what a fault in one key tile breaks:
    ``tests/test_torch_long_bert.py``)."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.ops.flash_attention import (
        BF16_LONG_TOL,
        agreement,
        flash_attention,
        flash_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    cases = [(c, "bfloat16") for c in LONG_FLASH_CASES] + [
        (LONG_FLASH_CASES[1], "float32"), (LONG_FLASH_CASES[2], "float32")]
    results = []
    for (name, B, L, tail), dtype in cases:
        q, k, v, bias = flash_case(torch, np, B, L, tail, dtype,
                                   seed=700 + len(results))
        scale = q.shape[-1] ** -0.5
        out = flash_attention(q, k, v, bias)
        ref = flash_attention_reference(q, k, v, bias, scale)
        torch.cuda.synchronize()
        got = agreement(out, ref)
        err = got["max_abs_err"]
        finite = bool(torch.isfinite(out).all())
        del ref
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = bias[:, None, None, :]
        ms = time_ms(torch, lambda: flash_attention(q, k, v, bias))
        plain_ms = time_ms(torch, lambda: flash_attention_reference(
            q, k, v, bias, scale))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        body = flash_body(torch, ptxas, q)
        bound_ms, bound_by, extra = flash_bound(q, bias, dtype, body["body"])
        row = dict(kernel="flash_attention", case=name, B=B, L=L, H=16,
                   D=64, padded_keys=tail, dtype=dtype, **got,
                   tol=tol[dtype], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, **extra, **body)
        log(f"   {json.dumps(row)}")
        scaled = dtype == "float32" or all(
            got[key] <= bound for key, bound in BF16_LONG_TOL.items())
        check(finite and err <= tol[dtype] and scaled,
              f"flash_attention {name} {dtype} ({row['body']}): max |err| "
              f"{err:.3g} <= {tol[dtype]}, over max |ref| "
              f"{got['max_rel_err']:.3g}, RMS over RMS "
              f"{got['rms_rel_err']:.3g} (bf16 bounds {BF16_LONG_TOL}); "
              f"{ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms")
        results.append(row)
        del q, k, v, bias, qh, kh, vh, out
        torch.cuda.empty_cache()
    return results


def zoo_config(workdir, name, model_cfg, data_cfg, probe_cfg, loss,
               schedule, microbatches, steps, lr):
    """A launcher config built here as ``configs/bert_pipeline.py``
    builds its own: 4 workers, ``optimal`` on the static profile
    (``probe_cfg``), ``schedule`` with ``microbatches``, ``steps`` steps
    of SGD at ``lr``, logs under ``workdir / name``."""
    import os

    from skycomputing_tpu_torch.config import Config
    from skycomputing_tpu_torch.dynamics import worker_pool_config
    from skycomputing_tpu_torch.dynamics.benchmarker import (
        PROXY_INPUT_SIZE,
        PROXY_MODEL_CONFIG,
    )

    log_root = str(workdir / name)
    return Config.from_dict(dict(
        model_config=model_cfg, worker_config=worker_pool_config(
            BERT_WORKERS), data_config=data_cfg,
        NUM_MICROBATCHES=microbatches, SCHEDULE=schedule,
        logging_config=dict(filename=os.path.join(log_root, "run.log")),
        allocator_config=dict(type="optimal", benchmark_config=dict(
            model=dict(param_scale=2, timed=False,
                       data_generator_cfg=probe_cfg),
            device=dict(model_config=PROXY_MODEL_CONFIG, iterations=10,
                        data_generator_cfg=dict(
                            generator_type="RandomTensorGenerator",
                            generator_cfg=dict(size=PROXY_INPUT_SIZE))))),
        train_config=dict(
            optim_cfg=dict(optim_type="sgd", learning_rate=lr),
            loss_cfg=dict(type=loss),
            runner_cfg=dict(max_epochs=steps, max_iters=steps),
            hook_config=[dict(type="StopHook", root=log_root)],
            timer_config=dict(root=log_root))))


def launcher_run(torch, np, kernels, name, cfg, on_first_step=None):
    """``launch.run`` on ``cfg`` over stimulated workers (``STIMULATE``):
    the harness of every launcher phase from 22 on.  Every kernel's
    launches are set to 0 just before and read just after, and B1's per
    step.  Checks the pre-flight, that the partition is the solver's
    contiguous cover of the units, and one finite loss per step; scores
    the run's first batch (``Runner.evaluate``, eval mode) before the
    first step and after the last; then profiles one more step on it
    (its launches are not the run's).  ``on_first_step(runner)`` may
    return an undo, called after step 1.  Returns (the launch, its
    record, the launches, the wall seconds, facts for the report)."""
    import os

    from skycomputing_tpu_torch import launch
    from skycomputing_tpu_torch.builder import build_dataloader_from_cfg
    from skycomputing_tpu_torch.runner import Hook
    from skycomputing_tpu_torch.utils import Logger

    steps = cfg.train_config["runner_cfg"]["max_iters"]
    first = [next(iter(launch.BatchAdapter(
        build_dataloader_from_cfg(cfg.data_config))))]
    flash = kernels[B1]["fn"]

    class Record(Hook):
        """The first batch, its loss before the first step, each step's
        stats and B1 launches."""

        def __init__(self):
            self.first = first
            self.steps, self.step_launches = [], []
            self.first_loss_before = self.undo = None
            self.launches_at = 0

        def before_train_iter(self, runner):
            if self.first_loss_before is None:
                self.first_loss_before = runner.evaluate(first)["loss"]
                if on_first_step is not None:
                    self.undo = on_first_step(runner)
            self.launches_at = flash.launches

        def after_train_iter(self, runner):
            self.steps.append(runner.model.stats.snapshot())
            self.step_launches.append(flash.launches - self.launches_at)
            if self.undo is not None:
                self.undo()
                self.undo = None

    record = Record()
    saved = os.environ.get("STIMULATE")
    os.environ["STIMULATE"] = "1"
    try:
        logger = Logger(**cfg.logging_config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k["fn"].launches = 0
        t0 = time.perf_counter()
        run = launch.run(cfg, logger, hooks=[record])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k["fn"].launches for n, k in kernels.items()}
    finally:
        if saved is None:
            os.environ.pop("STIMULATE", None)
        else:
            os.environ["STIMULATE"] = saved
    check(run is not None, f"{name}: the launcher allocated and trained")
    preflight = check_preflight(run.runner)
    solved = run.allocator.last_result
    ranges = solved.as_ranges(len(solved.device_order))
    slices = [ranges[d] for d in solved.device_order]
    partition = run.model.partition_signature()
    n_units = len(cfg.model_config)
    check(partition == [b - a for a, b in slices]
          and [a for a, _ in slices] == [0] + [b for _, b in slices[:-1]]
          and slices[-1][1] == n_units,
          f"{name}: partition {partition} is the solver's ({solved.path}, "
          f"gap {solved.optimality_gap:.3g}): slices {slices} cover the "
          f"{n_units} units contiguously")
    losses = [s["loss"] for s in record.steps]
    check(len(losses) == steps and all(np.isfinite(x) for x in losses),
          f"{name}: {len(losses)} finite losses {losses}")
    first_after = run.runner.evaluate(first)["loss"]
    check(np.isfinite(record.first_loss_before) and np.isfinite(first_after),
          f"{name}: the first batch's loss is finite: "
          f"{record.first_loss_before:.5f} -> {first_after:.5f}")
    # where a step's device time goes: one more step on the first batch,
    # profiled after the run (its launches are not the run's)
    data, labels = first[0]
    profile, rows = profile_window(
        torch, lambda: run.model.train_step(data, labels))
    total_us = sum(us for us, _, _ in rows)
    b1_us = sum(us for us, key, _ in rows
                if "flash_attention_kernel" in key)
    profile.update(flash_device_ms=b1_us / 1e3,
                   flash_share=b1_us / total_us if total_us else None)
    log(f"   profile of one step: "
        f"{json.dumps({k: v for k, v in profile.items() if k != 'top'})}")
    return run, record, launches, wall, dict(
        partition=partition, device_order=solved.device_order,
        solver_path=solved.path, solver_gap=solved.optimality_gap,
        device_time=[r["time"] for r in
                     run.device_benchmarker.benchmark().values()],
        preflight=preflight, first_batch_loss=[record.first_loss_before,
                                               first_after],
        profile_step=profile)


def launcher_e2e(torch, np, run, record, launches, wall, items_per_step,
                 facts):
    """A launcher phase's step times, their median from step 2 on,
    throughput, MFU (6 x parameters x tokens / step / dense bf16 peak, as
    ``PERF.md`` reckons it), peak memory, losses."""
    steps = record.steps
    step_s = [s["forward_s"] + s["backward_s"] + s["step_s"] for s in steps]
    median = float(np.median(step_s[1:]))
    params = sum(p.numel() for stage in run.model.stages
                 for p in stage.parameters)
    return dict(
        wall_s=wall, step_s=step_s, step_s_median_2_on=median,
        items_per_step=items_per_step, items_per_s=items_per_step / median,
        parameters=params,
        mfu=6.0 * params * items_per_step / median / PEAK_FLOPS["bfloat16"],
        losses=[s["loss"] for s in steps],
        dispatch_s=[s["dispatch_s"] for s in steps],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, step_launches=record.step_launches, **facts)


LONG_L, LONG_UNITS, LONG_BATCH, LONG_M, LONG_STEPS = 4096, 4, 2, 2, 3


def long_bert_path(torch, np, kernels, workdir):
    """Phase 23's training: ``long_bert_layer_configs`` at BERT-large's
    width (hidden 1,024, 16 heads, intermediate 4,096, bf16), positions
    and rows of 4,096, hidden dropout 0.1, attention dropout 0, 4
    encoder units (15 pipeline units), batch 2 of ``RandomBertDataset``
    rows (padded tails), GPipe M=2, ``optimal`` over 4 stimulated
    workers, 3 steps of SGD at 1e-3.  B1 must launch 4 x M times in
    each step's forward and as many in its rematerialized forward."""
    from skycomputing_tpu_torch.models import (
        bert_config,
        long_bert_layer_configs,
    )

    cfg = bert_config("large", hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.0,
                      max_position_embeddings=LONG_L)
    units = long_bert_layer_configs(cfg, LONG_UNITS, num_classes=3)
    check(len(units) == 15 and cfg.hidden_size == 1024
          and cfg.num_attention_heads == 16
          and cfg.intermediate_size == 4096 and cfg.dtype == "bfloat16",
          "long BERT at BERT-large's width: 15 units, hidden 1,024, 16 "
          "heads, intermediate 4,096, bf16")
    data_cfg = dict(dataset_cfg=dict(
        type="RandomBertDataset", num_samples=16, max_seq_length=LONG_L,
        vocab_size=cfg.vocab_size), dataloader_cfg=dict(
            batch_size=LONG_BATCH, shuffle=True))
    probe = dict(generator_type="RandomTokenGenerator", generator_cfg=dict(
        batch_size=LONG_BATCH, seq_length=LONG_L,
        vocab_size=cfg.vocab_size))
    run, record, launches, wall, facts = launcher_run(
        torch, np, kernels, "long_bert", zoo_config(
            workdir, "long_bert", units, data_cfg, probe,
            "CrossEntropyLoss", "gpipe", LONG_M, LONG_STEPS, 1e-3))
    per_step = 2 * LONG_UNITS * LONG_M
    check(record.step_launches == [per_step] * LONG_STEPS,
          f"B1 launched {record.step_launches} times per step (4 heads x "
          f"M={LONG_M}, forward and rematerialized forward: {per_step})")
    before, after = facts["first_batch_loss"]
    e2e = launcher_e2e(torch, np, run, record, launches, wall,
                       LONG_BATCH * LONG_L, facts)
    e2e["c5_cost"] = c5_cost(torch, np, run, record, units, probe)
    log(f"   partition {e2e['partition']}; steps "
        f"{[round(x * 1e3, 1) for x in e2e['step_s']]} ms, median "
        f"{e2e['step_s_median_2_on'] * 1e3:.1f} ms, "
        f"{e2e['items_per_s']:.0f} tokens/s, MFU {e2e['mfu']:.2%}, peak "
        f"{e2e['peak_mem_gb']:.2f} GB; first batch {before:.5f} -> "
        f"{after:.5f}")
    log(f"   e2e: {json.dumps(e2e)}")
    del run
    return e2e


def c5_cost(torch, np, run, record, units, probe):
    """What fault C5's count costs the allocation here.  On ``meta`` B1
    is charged one grid cell of the JAX kernel (the count XLA gives its
    interpret-mode loop), not the attention it computes, so the static
    profile leaves most of a head's work out.  Solve again over a count
    of the whole attention (the heads' einsum path, ``use_flash=False``,
    counted on ``meta``), then time both partitions' stages on the card
    (``measure_stage_times`` on the run's first batch) in the order
    static, full, full, static, each stage's time multiplied by its
    stimulated worker's slowdown, and take GPipe's step time at M from
    each side's mean (``dynamics/headline.py``'s emulation)."""
    from skycomputing_tpu_torch.builder import build_data_generator
    from skycomputing_tpu_torch.dynamics import ModelBenchmarker
    from skycomputing_tpu_torch.dynamics.headline import (
        schedule_step_time,
        worker_slowdowns,
    )
    from skycomputing_tpu_torch.ops import build_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd

    wm, allocator = run.worker_manager, run.allocator
    slowdown = worker_slowdowns(BERT_WORKERS, "stimulator")
    data = record.first[0][0]

    def stages():
        return [w for w in sorted(wm.worker_pool, key=lambda w: w.rank)
                if w.model_config]

    def timed(model, workers):
        raw = model.measure_stage_times(data, repeats=5)
        return [t * float(slowdown[w.stim_index])
                for t, w in zip(raw, workers)]

    full_units = [dict(u, use_flash=False)
                  if u["layer_type"] == "LongBertLayer_Head" else u
                  for u in units]
    full_flops, _ = ModelBenchmarker(
        full_units, build_data_generator(**probe)).benchmark()
    static_flops, _ = run.model_benchmarker.benchmark()
    head = next(i for i, u in enumerate(units)
                if u["layer_type"] == "LongBertLayer_Head")
    static_workers = stages()
    static_partition = [len(w.model_config) for w in static_workers]
    calibration = allocator.snapshot_calibration()
    allocator.restore_calibration(dict(calibration, cost=full_flops))
    allocator.optimal_allocate(max_time=30)
    allocator.restore_calibration(calibration)
    full_workers = stages()
    full_partition = [len(w.model_config) for w in full_workers]
    out = dict(static_partition=static_partition,
               full_partition=full_partition,
               head_flops=dict(static=static_flops[head],
                               full=full_flops[head]))
    if full_partition != static_partition:
        full_model = PipelineModel(
            wm, run.parameter_server, sgd(1e-3),
            build_loss(dict(type="CrossEntropyLoss")),
            devices=[run.model.stages[0].device], num_microbatches=LONG_M)
        static_s = timed(run.model, static_workers)
        full_s = timed(full_model, full_workers)
        full_again = timed(full_model, full_workers)
        static_again = timed(run.model, static_workers)
        del full_model
        side = {}
        for name, a, b in (("static", static_s, static_again),
                           ("full", full_s, full_again)):
            taus = [(x + y) / 2 for x, y in zip(a, b)]
            side[name] = dict(emulated_stage_s=[a, b],
                              step_s=schedule_step_time(taus, LONG_M))
        out.update(side, full_over_static=(side["full"]["step_s"]
                                           / side["static"]["step_s"]))
    log(f"   fault C5's cost: {json.dumps(out)}")
    return out


MOE_BLOCKS, MOE_EXPERTS, MOE_BATCH, MOE_SEQ = 12, 8, 32, 128


def moe_gpt_path(torch, np, kernels, workdir):
    """Phase 24: GPT-2 small's width (hidden 768, 12 heads, intermediate
    3,072, vocabulary 50,257, bf16), 12 blocks with every second MLP a
    ``GptBlock_MoeMlp`` of 8 experts (top-2, capacity 1.25),
    ``RandomLmDataset`` rows of 128 in batches of 32, ``optimal`` over 4
    stimulated workers, 1F1B M=4, 5 steps of SGD at 1e-3; no kernel.
    The share of routed choices dropped over capacity is read in step 1
    (a forward hook on each MoE block replays its routing)."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.models import gpt as gpt_mod
    from skycomputing_tpu_torch.ops.moe import moe_route

    cfg = gpt_mod.GptConfig(vocab_size=50257, hidden_size=768,
                            num_attention_heads=12, intermediate_size=3072,
                            num_hidden_layers=MOE_BLOCKS,
                            max_position_embeddings=1024, dtype="bfloat16")
    units = gpt_mod.gpt_layer_configs(cfg, moe_every=2,
                                      num_experts=MOE_EXPERTS, moe_top_k=2,
                                      moe_capacity_factor=1.25)
    check(sum(u["layer_type"] == "GptBlock_MoeMlp" for u in units) == 6
          and len(units) == 2 + 2 * MOE_BLOCKS,
          "GPT-2 small with 6 MoE blocks of 8 experts (top-2)")
    data_cfg = dict(dataset_cfg=dict(type="RandomLmDataset", num_samples=512,
                                     seq_length=MOE_SEQ, vocab_size=50257),
                    dataloader_cfg=dict(batch_size=MOE_BATCH, shuffle=True))
    probe = dict(generator_type="DataloaderGenerator",
                 generator_cfg=dict(generator_cfg=data_cfg))
    dropped = []

    def share(module, inputs, output):
        with torch.no_grad():
            h = inputs[0]
            H = h.shape[-1]
            x = F.layer_norm(h.float(), (H,), module.ln_2.weight,
                             module.ln_2.bias, module.ln_2.eps).to(h.dtype)
            tokens, dispatch, _, _ = moe_route(
                x, module.router, module.num_experts, module.top_k,
                module.capacity_factor)
            dropped.append(1.0 - float(dispatch.sum())
                           / (tokens.shape[0] * module.top_k))

    def hook_moe_blocks(runner):
        handles = [m.register_forward_hook(share)
                   for stage in runner.model.stages
                   for m in stage.stack.modules()
                   if isinstance(m, gpt_mod.GptBlock_MoeMlp)]
        return lambda: [h.remove() for h in handles]

    run, record, launches, wall, facts = launcher_run(
        torch, np, kernels, "moe_gpt", zoo_config(
            workdir, "moe_gpt", units, data_cfg, probe, "CausalLmLoss",
            "1f1b", 4, BERT_STEPS, 1e-3), on_first_step=hook_moe_blocks)
    check_launches(launches, {}, "MoE GPT: no kernel")
    check(len(dropped) > 0, f"step 1 routed {len(dropped)} MoE calls")
    before, after = facts["first_batch_loss"]
    check(np.isfinite(after) and after < before,
          f"the first batch's causal-LM loss falls: {before:.5f} -> "
          f"{after:.5f}")
    e2e = launcher_e2e(torch, np, run, record, launches, wall,
                       MOE_BATCH * MOE_SEQ, facts)
    e2e["dropped_share_step1"] = float(np.mean(dropped))
    log(f"   partition {e2e['partition']}; steps "
        f"{[round(x * 1e3, 1) for x in e2e['step_s']]} ms, median "
        f"{e2e['step_s_median_2_on'] * 1e3:.1f} ms, "
        f"{e2e['items_per_s']:.0f} tokens/s, peak "
        f"{e2e['peak_mem_gb']:.2f} GB, dropped in step 1 "
        f"{e2e['dropped_share_step1']:.2%}; first batch {before:.5f} -> "
        f"{after:.5f}")
    log(f"   e2e: {json.dumps(e2e)}")
    del run
    return e2e


RESNET_BATCH = 128


def resnet_path(torch, np, kernels, workdir):
    """Phase 25: ResNet-50 (``resnet_layer_configs("BottleNeck", [3, 4, 6,
    3])``, float32 as in JAX) on ``CIFAR10Dataset``'s synthetic fallback
    in batches of 128, ``optimal`` over 4 stimulated workers, GPipe M=4,
    5 steps of SGD at 1e-3; no kernel.  (At 1e-2, the rate of the JAX
    package's ResNet tests on a one-block stack, ResNet-50 diverges: on
    the CPU at batch 32 the first batch's loss went 2.762 -> 27.27.)"""
    from skycomputing_tpu_torch.models import resnet_layer_configs

    units = resnet_layer_configs("BottleNeck", [3, 4, 6, 3])
    data_cfg = dict(dataset_cfg=dict(type="CIFAR10Dataset", data_dir=""),
                    dataloader_cfg=dict(batch_size=RESNET_BATCH,
                                        shuffle=True))
    probe = dict(generator_type="DataloaderGenerator",
                 generator_cfg=dict(generator_cfg=data_cfg))
    run, record, launches, wall, facts = launcher_run(
        torch, np, kernels, "resnet50", zoo_config(
            workdir, "resnet50", units, data_cfg, probe, "CrossEntropyLoss",
            "gpipe", 4, BERT_STEPS, 1e-3))
    check_launches(launches, {}, "ResNet-50: no kernel")
    before, after = facts["first_batch_loss"]
    check(np.isfinite(after) and after < before,
          f"the first batch's loss falls: {before:.5f} -> {after:.5f}")
    e2e = launcher_e2e(torch, np, run, record, launches, wall,
                       RESNET_BATCH, facts)
    e2e.pop("mfu")  # float32 convolutions: the bf16 peak does not apply
    log(f"   partition {e2e['partition']}; steps "
        f"{[round(x * 1e3, 1) for x in e2e['step_s']]} ms, median "
        f"{e2e['step_s_median_2_on'] * 1e3:.1f} ms, "
        f"{e2e['items_per_s']:.0f} images/s, peak "
        f"{e2e['peak_mem_gb']:.2f} GB; first batch {before:.5f} -> "
        f"{after:.5f}")
    log(f"   e2e: {json.dumps(e2e)}")
    del run
    return e2e


# --------------------------------------------------------------------------
# phases 26-28: sequence parallelism, data-parallel replicas and
# mesh-native stages, every position on the one card
# --------------------------------------------------------------------------

SP_POSITIONS = 4  # sequence-parallel positions, all on one device
SP_L, SP_UNITS, SP_BATCH, SP_MICRO = 4096, 4, 2, 2
SP_GPT_L, SP_GPT_BLOCKS = 1024, 2
PAR_STEPS, PAR_MICRO, PAR_LR = 3, 4, 1e-3


def _peak_reset(torch, dev):
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(torch, dev):
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def sp_attention_checks(torch, np, dev, L=SP_L, H=16, D=64):
    """Ring attention and Ulysses over ``SP_POSITIONS`` positions of one
    device at B=1, L tokens, H heads of D (BERT-large's), the last tenth
    of the keys padded: float32 against ``full_attention_reference``
    (max abs error <= 1e-4), bf16 against B1 (held to
    ``BF16_LONG_TOL``), each timed on the card with its peak memory."""
    from skycomputing_tpu_torch.ops.flash_attention import (
        BF16_LONG_TOL,
        agreement,
        flash_attention,
    )
    from skycomputing_tpu_torch.parallel import (
        full_attention_reference,
        make_1d_mesh,
        ring_attention,
        ulysses_attention,
    )

    mesh = make_1d_mesh(SP_POSITIONS, "sp", [dev] * SP_POSITIONS)
    rng = np.random.default_rng(SEED + 26)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, H, D)).astype(
        np.float32)).to(dev) for _ in range(3))
    bias = torch.zeros(1, L, device=dev)
    bias[:, L - L // 10:] = -10000.0
    ref = full_attention_reference(q, k, v, bias=bias)
    qb, kb, vb, bb = (t.bfloat16() for t in (q, k, v, bias))
    b1 = flash_attention(qb, kb, vb, bb)
    rows = []
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        _peak_reset(torch, dev)
        out = fn(q, k, v, mesh, bias=bias)
        peak = _peak_gb(torch, dev)
        err = (out - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        bf16 = agreement(fn(qb, kb, vb, mesh, bias=bb), b1)
        row = dict(strategy=name, positions=SP_POSITIONS, B=1, L=L, H=H,
                   D=D, f32_max_abs_err=err, f32_peak_mem_gb=peak,
                   bf16_vs_b1=bf16,
                   f32_ms=time_ms(torch, lambda: fn(q, k, v, mesh,
                                                    bias=bias),
                                  iters=5, warmup=1, host_ahead=False),
                   bf16_ms=time_ms(torch, lambda: fn(qb, kb, vb, mesh,
                                                     bias=bb),
                                   iters=5, warmup=1, host_ahead=False))
        log(f"   {json.dumps(row)}")
        check(finite and err <= 1e-4,
              f"{name} float32 against the full reference: max |err| "
              f"{err:.3g} <= 1e-4")
        check(all(bf16[key] <= bound for key, bound in BF16_LONG_TOL.items()),
              f"{name} bf16 against B1: over max |ref| "
              f"{bf16['max_rel_err']:.3g}, RMS over RMS "
              f"{bf16['rms_rel_err']:.3g} (bounds {BF16_LONG_TOL})")
        rows.append(row)
        del out
    ref_ms = time_ms(torch, lambda: full_attention_reference(
        q, k, v, bias=bias), iters=5, warmup=1, host_ahead=False)
    log(f"   full_attention_reference float32: {ref_ms:.3f} ms")
    rows.append(dict(strategy="full_attention_reference", f32_ms=ref_ms))
    return rows


def _long_bert_data(np, vocab_size, L):
    rng = np.random.default_rng(SEED + 27)
    ids = rng.integers(5, vocab_size, size=(SP_BATCH, L)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1:, L - L // 10:] = 0
    labels = rng.integers(0, 3, size=(SP_BATCH,)).astype(np.int32)
    return (ids, np.zeros_like(ids), mask), labels


def _clone_params(params):
    return [{k: v.clone() for k, v in sd.items()} for sd in params]


def _train_steps(torch, model, data, labels, dev, steps):
    """``steps`` train steps, each from its own seeded generator: the
    losses, each step's wall time (a step ends in a device barrier) and
    the peak memory."""
    _peak_reset(torch, dev)
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(model.train_step(
            data, labels, generator=torch.Generator().manual_seed(i)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, _peak_gb(torch, dev)


def sp_long_bert_steps(torch, np, kernels, dev, preset="large",
                       units=SP_UNITS, L=SP_L, steps=PAR_STEPS):
    """Long BERT at ``preset``'s width, ``units`` encoder units, rows of
    L, float32, dropouts 0, 4 workers on one device, GPipe M=2, SGD: the
    heads' attention by ring attention over ``SP_POSITIONS`` positions,
    then by B1 (``mesh=None``) from the same weights.  Losses within
    1e-4 relative; B1 launched only in the second run."""
    from skycomputing_tpu_torch.dynamics import Allocator, ParameterServer
    from skycomputing_tpu_torch.models import (
        bert_config,
        long_bert_layer_configs,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import (
        PipelineModel,
        make_1d_mesh,
        sgd,
    )

    cfg = bert_config(preset, dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      max_position_embeddings=L)
    mesh = make_1d_mesh(SP_POSITIONS, "sp", [dev] * SP_POSITIONS)
    data, labels = _long_bert_data(np, cfg.vocab_size, L)
    runs, init = {}, None
    for name, run_mesh in (("ring", mesh), ("b1", None)):
        model_cfg = long_bert_layer_configs(cfg, units, run_mesh,
                                            deterministic=True)
        wm = worker_pool(4)
        Allocator(model_cfg, wm).even_allocate()
        ps = ParameterServer(
            model_cfg, state_dicts=None if init is None else
            _clone_params(init),
            generator=torch.Generator().manual_seed(SEED))
        init = init or _clone_params(ps.params)
        model = PipelineModel(wm, ps, sgd(PAR_LR), cross_entropy_loss,
                              devices=[dev], num_microbatches=SP_MICRO)
        zero_counts(kernels)
        losses, step_ms, peak = _train_steps(torch, model, data, labels,
                                             dev, steps)
        runs[name] = dict(
            losses=losses, step_ms=step_ms, peak_mem_gb=peak,
            partition=model.partition_signature(),
            launches={n: k["fn"].launches for n, k in kernels.items()},
            b1_bodies=dict(kernels[B1]["fn"].body_launches))
        log(f"   long BERT, {name}: {json.dumps(runs[name])}")
        del model, ps
        _free(torch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["ring"]["losses"],
                                                  runs["b1"]["losses"]))
    check(all(np.isfinite(runs["ring"]["losses"])) and rel <= 1e-4,
          f"{steps} GPipe steps with ring attention against B1: losses "
          f"within {rel:.3g} <= 1e-4 relative")
    per_step = units * SP_MICRO * 2
    check(runs["ring"]["launches"][B1] == 0
          and runs["b1"]["launches"][B1] == per_step * steps,
          f"B1 launched {runs['b1']['launches'][B1]} times in the "
          f"baseline ({units} heads x {SP_MICRO} microbatches x forward "
          f"and remat x {steps} steps), never with the ring")
    check_f32_b1_body(runs["b1"]["b1_bodies"], runs["b1"]["launches"][B1],
                      "long BERT's B1 baseline")
    return dict(runs=runs, loss_rel_diff=rel)


def sp_gpt_logits(torch, np, dev, L=SP_GPT_L, blocks=SP_GPT_BLOCKS):
    """GPT-2 small's width (float32, ``blocks`` blocks) at L tokens:
    causal ring attention over ``SP_POSITIONS`` positions against the
    dense stack on the same weights; logits within 1e-4."""
    from skycomputing_tpu_torch import build_layer_stack
    from skycomputing_tpu_torch.models import gpt as gpt_mod
    from skycomputing_tpu_torch.parallel import make_1d_mesh

    cfg = gpt_mod.GptConfig(dtype="float32", dropout_prob=0.0,
                            max_position_embeddings=max(L, 1024))
    mesh = make_1d_mesh(SP_POSITIONS, "sp", [dev] * SP_POSITIONS)
    # the dense stack's initialization draws from a seeded fork, not the
    # process-global generator
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        dense = build_layer_stack(gpt_mod.gpt_layer_configs(
            cfg, num_blocks=blocks, deterministic=True)).to(dev)
    ring = build_layer_stack(gpt_mod.gpt_layer_configs(
        cfg, num_blocks=blocks, deterministic=True, mesh=mesh)).to(dev)
    ring.load_state_dict(dense.state_dict())
    ids = torch.from_numpy(np.random.default_rng(SEED + 28).integers(
        0, cfg.vocab_size, (1, L))).to(dev)
    with torch.no_grad():
        err = (ring(ids) - dense(ids)).abs().max().item()
        row = dict(hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
                   blocks=blocks, L=L, max_abs_err=err,
                   ring_ms=time_ms(torch, lambda: ring(ids), iters=5,
                                   warmup=1, host_ahead=False),
                   dense_ms=time_ms(torch, lambda: dense(ids), iters=5,
                                    warmup=1, host_ahead=False))
    log(f"   {json.dumps(row)}")
    check(err <= 1e-4, f"GPT ring logits against dense: max |err| "
          f"{err:.3g} <= 1e-4")
    return row


def parallel_units(preset="large", layers=24):
    """The launcher's BERT (flash on, dropouts 0) in float32."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

    cfg = bert_config(preset, dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    return cfg, bert_layer_configs(cfg, num_encoder_units=layers,
                                   num_classes=3, deterministic=True)


def _max_param_diff(a, b):
    return max((x - y).abs().max().item() for sa, sb in zip(a, b)
               for x, y in ((sa[key], sb[key]) for key in sa))


def data_parallel_path(torch, np, kernels, dev, units, vocab_size,
                       batch=BERT_BATCH, seq=BERT_SEQ, steps=PAR_STEPS):
    """``DataParallelPipeline``: 2 replicas of the 4-worker pipeline
    over ``units`` on one device, 1F1B M=4, SGD, against one
    ``PipelineModel`` on the whole batch from the same weights: losses
    within 1e-4 relative, parameters within 1e-5.  The replicas' steps
    are the phase's main path: every kernel's count is set to 0 just
    before them and read just after."""
    from skycomputing_tpu_torch.dynamics import Allocator, ParameterServer
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import (
        DataParallelPipeline,
        PipelineModel,
        sgd,
    )

    rng = np.random.default_rng(SEED + 29)
    ids = rng.integers(5, vocab_size, size=(batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[::4, seq - seq // 4:] = 0
    data = (ids, np.zeros_like(ids), mask)
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    wm = worker_pool(4)
    Allocator(units, wm).even_allocate()
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(SEED))
    ps_one = ParameterServer(units, state_dicts=_clone_params(ps.params))
    dp = DataParallelPipeline(wm, ps, sgd(PAR_LR), cross_entropy_loss,
                              num_replicas=2, devices=[dev] * 8,
                              num_microbatches=PAR_MICRO, schedule="1f1b")
    zero_counts(kernels)
    losses, step_ms, peak = _train_steps(torch, dp, data, labels, dev, steps)
    launches = {n: k["fn"].launches for n, k in kernels.items()}
    b1_bodies = dict(kernels[B1]["fn"].body_launches)
    identical = all(
        torch.equal(a, b) for s0, s1 in zip(dp.replicas[0].stages,
                                            dp.replicas[1].stages)
        for a, b in zip(s0.parameters, s1.parameters))
    dp.sync_to_parameter_server()
    del dp
    _free(torch)
    one = PipelineModel(wm, ps_one, sgd(PAR_LR), cross_entropy_loss,
                        devices=[dev] * 4, num_microbatches=PAR_MICRO,
                        schedule="1f1b")
    one_losses, one_ms, one_peak = _train_steps(torch, one, data, labels,
                                                dev, steps)
    one.sync_to_parameter_server()
    del one
    _free(torch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    diff = _max_param_diff(ps.params, ps_one.params)
    out = dict(replicas=2, batch=batch, seq=seq, microbatches=PAR_MICRO,
               losses=losses, step_ms=step_ms, peak_mem_gb=peak,
               launches=launches, b1_bodies=b1_bodies,
               single_losses=one_losses,
               single_step_ms=one_ms, single_peak_mem_gb=one_peak,
               loss_rel_diff=rel, max_param_abs_diff=diff,
               replicas_bitwise_identical=identical)
    log(f"   {json.dumps(out)}")
    heads = sum(u["layer_type"] == "BertLayer_Head" for u in units)
    check(launches[B1] == heads * 2 * PAR_MICRO * 2 * steps,
          f"B1 launched {launches[B1]} times: {heads} layers x 2 replicas "
          f"x {PAR_MICRO} microbatches x forward and remat x {steps} steps")
    check_f32_b1_body(b1_bodies, launches[B1], "data-parallel replicas")
    check(rel <= 1e-4, f"losses of 2 replicas against one pipeline within "
          f"{rel:.3g} <= 1e-4 relative")
    check(diff <= 1e-5, f"parameters after {steps} steps within {diff:.3g} "
          f"<= 1e-5")
    check(identical, "the two replicas' parameters bitwise identical")
    return out


def mesh_pipeline_path(torch, np, kernels, dev, units, vocab_size,
                       batch=BERT_BATCH, seq=BERT_SEQ, steps=PAR_STEPS):
    """``Allocator.mesh_allocate`` over 4 stimulated workers and 8
    positions of one device (at most 4 stages of 2); its payload
    verified and a broken one refused; ``MeshPipelineModel`` on that
    plan, 1F1B M=4, ``steps`` SGD steps (the phase's main path); then at
    one position per stage against ``PipelineModel`` on the same
    allocation and weights, 2 steps each, in turns: whether the
    parameters are bitwise equal, and their largest difference."""
    from skycomputing_tpu_torch.analysis import verify_mesh_payload
    from skycomputing_tpu_torch.dataset import RandomTokenGenerator
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ModelBenchmarker,
        ParameterServer,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import (
        MeshPipelineModel,
        PipelineModel,
        sgd,
    )
    from skycomputing_tpu_torch.stimulator import Stimulator

    rng = np.random.default_rng(SEED + 30)
    ids = rng.integers(5, vocab_size, size=(batch, seq)).astype(np.int32)
    data = (ids, np.zeros_like(ids), np.ones_like(ids))
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    wm = worker_pool(4)
    alloc = Allocator(
        units, wm,
        ModelBenchmarker(units, RandomTokenGenerator(batch, seq, vocab_size)),
        proxy_device_benchmarker(wm, devices=[dev], stimulator=Stimulator(4)))
    t0 = time.perf_counter()
    alloc.mesh_allocate(num_devices=8, max_stages=4, max_chips_per_stage=2)
    allocate_s = time.perf_counter() - t0
    plan = alloc.last_mesh
    payload = dict(chips_per_stage=list(plan.chips), num_devices=8, tp=1,
                   microbatch_rows=batch // PAR_MICRO)
    problems = verify_mesh_payload(payload)
    broken = verify_mesh_payload(dict(payload, chips_per_stage=[4, 4, 4],
                                      microbatch_rows=batch // PAR_MICRO))
    check(problems == [] and broken,
          f"mesh plan {payload} verified; a broken one refused: {broken}")
    ps = ParameterServer(units, generator=torch.Generator().manual_seed(SEED))
    model = MeshPipelineModel(wm, ps, sgd(PAR_LR), cross_entropy_loss,
                              devices=[dev] * 8, num_microbatches=PAR_MICRO,
                              schedule="1f1b")
    check(model.chips_per_stage == list(plan.chips),
          f"stages of {model.partition_signature()} units on "
          f"{model.chips_per_stage} positions, as allocated")
    zero_counts(kernels)
    losses, step_ms, peak = _train_steps(torch, model, data, labels, dev,
                                         steps)
    launches = {n: k["fn"].launches for n, k in kernels.items()}
    b1_bodies = dict(kernels[B1]["fn"].body_launches)
    lanes = [s.lane_name for s in model.stages]
    del model
    _free(torch)
    heads = sum(u["layer_type"] == "BertLayer_Head" for u in units)
    stage_heads = [sum(u["layer_type"] == "BertLayer_Head" for u in
                       units[s:e]) for s, e in plan.slices]
    expect = sum(h * k for h, k in zip(stage_heads, plan.chips)) * (
        PAR_MICRO * 2 * steps)
    check(all(np.isfinite(losses)) and launches[B1] == expect,
          f"{steps} steps on the mesh plan, losses {losses}; B1 launched "
          f"{launches[B1]} times: each of {heads} layers once per dp row "
          f"of its stage x {PAR_MICRO} microbatches x forward and remat")
    check_f32_b1_body(b1_bodies, launches[B1], "mesh-native stages")

    # one position per stage against the MPMD engine, in turns
    models = []
    init = None
    for cls in (PipelineModel, MeshPipelineModel):
        wm1 = worker_pool(4)
        Allocator(units, wm1).even_allocate()
        ps1 = ParameterServer(units, state_dicts=None if init is None else
                              _clone_params(init),
                              generator=torch.Generator().manual_seed(SEED))
        init = init or _clone_params(ps1.params)
        models.append((cls(wm1, ps1, sgd(PAR_LR), cross_entropy_loss,
                           devices=[dev] * 4, num_microbatches=PAR_MICRO,
                           schedule="1f1b"), ps1))
    pair_losses = [[], []]
    for i in range(2):
        for j, (m, _) in enumerate(models):
            pair_losses[j].append(m.train_step(
                data, labels, generator=torch.Generator().manual_seed(i)))
    for m, ps1 in models:
        m.sync_to_parameter_server()
    diff = _max_param_diff(models[0][1].params, models[1][1].params)
    bitwise = diff == 0.0 and pair_losses[0] == pair_losses[1]
    del models
    _free(torch)
    out = dict(plan=dict(partition=[e - s for s, e in plan.slices],
                         chips=list(plan.chips),
                         bottleneck=plan.bottleneck),
               allocate_s=allocate_s, payload=payload,
               broken_payload_problems=broken, losses=losses,
               step_ms=step_ms, peak_mem_gb=peak, launches=launches,
               b1_bodies=b1_bodies, lanes=lanes,
               one_position_losses=pair_losses,
               one_position_bitwise_equal=bitwise,
               one_position_max_param_abs_diff=diff)
    log(f"   {json.dumps(out)}")
    log(f"   finding: at one position per stage the mesh engine's "
        f"parameters {'are' if bitwise else 'are NOT'} bitwise equal to "
        f"PipelineModel's (largest difference {diff:.3g})")
    check(diff <= 1e-5, f"one position per stage against PipelineModel: "
          f"parameters within {diff:.3g} <= 1e-5")
    return out



# --------------------------------------------------------------------------
# phase 29: the compiled SPMD pipelines, every mesh position on the card
# --------------------------------------------------------------------------

SPMD_MICRO, SPMD_LR = 4, 1e-3
# (a)'s SGD step: at 1e-3 the fixed batch's loss of BERT-large rises
# under every engine (phases 27-28 too: 1.08, 1.13, 1.47), so the run
# that checks it falls trains at 1e-4
SPMD_LR_A = 1e-4
SPMD_CHECK_BATCH = 8  # (f): batch of the card-against-CPU step
GRAD_RTOL = 1e-3  # (f), (g): a leaf's gradient error over its norm
GRAD_FLOOR = 1e-4  # ... or over this share of the whole gradient's norm


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spmd_bert_cfg(dtype, preset="large"):
    """BERT-large's width (``experiment/config.py``): hidden 1,024, 16
    heads of 64, FFN 4,096; flash on, dropouts 0."""
    from skycomputing_tpu_torch.models import bert_config

    return bert_config(preset, dtype=dtype, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0,
                       use_flash_attention=True)


def spmd_bert_data(np, vocab_size, batch=BERT_BATCH, seq=BERT_SEQ,
                   seed=SEED + 31):
    """Seeded rows, every fourth with its last quarter padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, size=(batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[::4, seq - seq // 4:] = 0
    labels = rng.integers(0, 3, size=(batch,)).astype(np.int32)
    return (ids, np.zeros_like(ids), mask), labels


def spmd_steps(torch, engine, params, opt, data, labels, dev, steps,
               b1=None):
    """``steps`` train steps on a fixed batch: the losses, each step's
    wall time (ending in a device barrier), B1's launches in each step
    and the peak memory."""
    if dev.type == "cuda":
        _peak_reset(torch, dev)
    losses, step_ms, per_step = [], [], []
    for _ in range(steps):
        before = b1.launches if b1 is not None else 0
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, loss = engine.train_step(params, opt, data, labels)
        _sync(torch, dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append((b1.launches - before) if b1 is not None else 0)
    peak = _peak_gb(torch, dev) if dev.type == "cuda" else None
    return params, opt, dict(losses=losses, step_ms=step_ms,
                             b1_per_step=per_step, peak_mem_gb=peak)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def _bytes_by_position(tree):
    from skycomputing_tpu_torch.parallel.sharded import leaves_of

    out = {}
    for leaf in leaves_of(tree):
        for pos in leaf.shards:
            out[pos] = out.get(pos, 0) + leaf.nbytes(pos)
    return {str(list(pos)): n for pos, n in sorted(out.items())}


def _tree_max_diff(a, b):
    return max((a[g][n] - b[g][n]).abs().max().item()
               for g in a for n in a[g])


def _grad_rel_diff(ours, ref):
    """The largest per-leaf ``||ours - ref|| / max(||ref||, floor)`` over
    two trees of gradients (dicts of dicts, or lists of dicts, of
    tensors), on the CPU in float64.  ``floor`` is ``GRAD_FLOOR`` of the
    whole reference gradient's norm: a leaf whose gradient is zero but
    for rounding (a key bias: softmax ignores a shift shared by every
    key) is held to that, not to its own rounding."""
    keys = [(i, name) for i in (ref if isinstance(ref, dict)
                                else range(len(ref)))
            for name in ref[i]]
    pairs = [(ours[i][n].detach().cpu().double(),
              ref[i][n].detach().cpu().double()) for i, n in keys]
    floor = GRAD_FLOOR * sum(r.norm().item() ** 2 for _, r in pairs) ** 0.5
    return max((o - r).norm().item() / max(r.norm().item(), floor)
               for o, r in pairs)


def spmd_path(torch, np, kernels, dev, preset="large", units=24,
              gpt_layers=LAYERS, batch=BERT_BATCH, seq=BERT_SEQ,
              steps=BERT_STEPS, check_batch=SPMD_CHECK_BATCH, gpt_kw=None):
    """Phase 29: ``CompiledBertPipeline`` and ``CompiledGptPipeline`` with
    every mesh position on ``dev`` (runs (a)-(g) of the docstring).
    Each run's B1 counts are set to 0 just before its steps and read
    just after."""
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
    )
    from skycomputing_tpu_torch.models import bert_layer_configs
    from skycomputing_tpu_torch.models.gpt import GptConfig
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import (
        Adam,
        CompiledBertPipeline,
        CompiledGptPipeline,
        PipelineModel,
        make_dp_pp_mesh,
        make_dp_pp_tp_mesh,
        make_pipeline_mesh,
        sgd,
    )

    b1 = kernels[B1]["fn"]
    report = {}
    cfg = spmd_bert_cfg("bfloat16", preset)
    data, labels = spmd_bert_data(np, cfg.vocab_size, batch, seq)
    tokens = batch * seq
    per_stage = units // 4

    def bert(mesh, units_per_stage, c=cfg, **kw):
        kw.setdefault("num_microbatches", SPMD_MICRO)
        kw.setdefault("learning_rate", SPMD_LR)
        return CompiledBertPipeline(c, mesh, units_per_stage=units_per_stage,
                                    num_classes=3, **kw)

    def summary(name, run, expect_b1=None, body=None):
        run = dict(run)
        run["step_ms_median_2_on"] = _median(run["step_ms"][1:])
        run["tokens_per_s"] = tokens / (run["step_ms_median_2_on"] / 1e3)
        run["b1_bodies"] = dict(b1.body_launches)
        log(f"   {name}: {json.dumps(run)}")
        check(all(np.isfinite(run["losses"])),
              f"{name}: losses finite {run['losses']}")
        if expect_b1 is not None:
            check(all(n == expect_b1 for n in run["b1_per_step"]),
                  f"{name}: B1 launched {run['b1_per_step']} times a step, "
                  f"{expect_b1} expected")
        if body is not None:
            total = sum(run["b1_per_step"])
            check(run["b1_bodies"][body] == total,
                  f"{name}: all {total} B1 launches on the {body} body "
                  f"({json.dumps(run['b1_bodies'])})")
        report[name] = run
        return run

    # (a) GPipe on dp=2 x pp=4
    eng = bert(make_dp_pp_mesh(2, 4, [dev] * 8), per_stage,
               learning_rate=SPMD_LR_A)
    tree_a = eng.init_tree(SEED)
    params = eng.place(tree_a)
    opt = eng.init_opt_state(params)
    zero_counts(kernels)
    params, opt, run = spmd_steps(torch, eng, params, opt, data, labels,
                                  dev, steps, b1)
    summary("a_gpipe_dp2_pp4", run, units * SPMD_MICRO * 2 * 2,
            "tensor_core")
    check(run["losses"][-1] < run["losses"][0],
          f"(a) the fixed batch's loss falls over {steps} steps of SGD at "
          f"{SPMD_LR_A}: {run['losses']}")
    del eng, params, opt
    _free(torch)

    # (b) interleaved, V=2 on pp=4: the wavefront (M=4), then grouped (M=8)
    tree_b = None
    for M in (4, 8):
        eng = bert(make_pipeline_mesh(4, [dev] * 4), units // 8,
                   virtual_stages=2, num_microbatches=M)
        tree_b = tree_b or eng.init_tree(SEED + 1)
        params = eng.place(tree_b)
        opt = eng.init_opt_state(params)
        zero_counts(kernels)
        params, opt, run = spmd_steps(torch, eng, params, opt, data, labels,
                                      dev, 3, b1)
        summary(f"b_interleaved_V2_M{M}", run, units * M * 2, "tensor_core")
        del eng, params, opt
        _free(torch)
    del tree_b

    # (c) ZeRO-3 with Adam on (a)'s mesh, against the replicated layout
    mesh_a = make_dp_pp_mesh(2, 4, [dev] * 8)
    rep = bert(mesh_a, per_stage, optimizer=Adam(SPMD_LR))
    rep_params = rep.place(tree_a)
    rep_opt = rep.init_opt_state(rep_params)
    rep_bytes = dict(params=_bytes_by_position(rep_params),
                     state=_bytes_by_position({k: v for k, v in
                                               rep_opt.items()
                                               if k != "count"}))
    del rep, rep_params, rep_opt
    _free(torch)
    eng = bert(mesh_a, per_stage, optimizer=Adam(SPMD_LR), zero3=True)
    params = eng.place(tree_a)
    opt = eng.init_opt_state(params)
    z_bytes = dict(params=_bytes_by_position(params),
                   state=_bytes_by_position({k: v for k, v in opt.items()
                                             if k != "count"}))
    zero_counts(kernels)
    params, opt, run = spmd_steps(torch, eng, params, opt, data, labels,
                                  dev, 3, b1)
    run = summary("c_zero3_adam_dp2_pp4", run, units * SPMD_MICRO * 2 * 2,
                  "tensor_core")
    report["c_zero3_adam_dp2_pp4"]["bytes_by_position"] = dict(
        zero3=z_bytes, replicated=rep_bytes)
    log(f"   (c) bytes by position: zero3 {json.dumps(z_bytes)}; "
        f"replicated {json.dumps(rep_bytes)}")
    check(all(z_bytes[k][p] < rep_bytes[k][p] for k in z_bytes
              for p in z_bytes[k]),
          "(c) ZeRO-3 holds fewer parameter and state bytes than the "
          "replicated layout at every position")
    del eng, params, opt
    _free(torch)

    # (d) tensor parallelism on dp=2 x pp=2 x tp=2: einsum attention, no B1
    eng = bert(make_dp_pp_tp_mesh(2, 2, 2, [dev] * 8), units // 2,
               num_microbatches=SPMD_MICRO)
    params = eng.init(SEED + 2)
    opt = eng.init_opt_state(params)
    zero_counts(kernels)
    params, opt, run = spmd_steps(torch, eng, params, opt, data, labels,
                                  dev, 3, b1)
    summary("d_tp_dp2_pp2_tp2", run, 0)
    del eng, params, opt
    _free(torch)

    # (e) GPT-2 small's width: dense on pp=4; MoE (every second block of
    # 8 experts, top-2) on pp=2 and on pp=2 x tp=2 (moe_every must divide
    # a stage's blocks: 12 blocks over 4 stages leave 3)
    gcfg = GptConfig(num_hidden_layers=gpt_layers, **(gpt_kw or {}))
    rng = np.random.default_rng(SEED + 32)
    ids = rng.integers(0, gcfg.vocab_size, size=(batch, seq)).astype(
        np.int32)
    moe = dict(moe_every=2, num_experts=8, moe_top_k=2)
    for name, mesh, per, kw in (
            ("e_gpt_dense_pp4", make_pipeline_mesh(4, [dev] * 4),
             gpt_layers // 4, {}),
            ("e_gpt_moe_pp2", make_pipeline_mesh(2, [dev] * 2),
             gpt_layers // 2, moe),
            ("e_gpt_moe_pp2_tp2", make_dp_pp_tp_mesh(1, 2, 2, [dev] * 4),
             gpt_layers // 2, moe)):
        eng = CompiledGptPipeline(gcfg, mesh, units_per_stage=per,
                                  num_microbatches=SPMD_MICRO,
                                  learning_rate=SPMD_LR, **kw)
        params = eng.init(SEED + 3)
        opt = eng.init_opt_state(params)
        zero_counts(kernels)
        params, opt, run = spmd_steps(torch, eng, params, opt, (ids,), ids,
                                      dev, 3, b1)
        summary(name, run, 0)
        del eng, params, opt
        _free(torch)

    # (f) card against CPU: depth 2, float32, TF32 off, dp=2 x pp=2
    f32 = spmd_bert_cfg("float32", preset)
    small, small_labels = spmd_bert_data(np, f32.vocab_size, check_batch,
                                         seq, seed=SEED + 33)
    trees, losses, grads = {}, {}, {}
    tree_f = None
    for where, devs in (("cuda", [dev] * 4),
                        ("cpu", [torch.device("cpu")] * 4)):
        eng = bert(make_dp_pp_mesh(2, 2, devs), 1, c=f32,
                   num_microbatches=2)
        tree_f = tree_f or eng.init_tree(SEED + 4)
        params = eng.place(tree_f)
        opt = eng.init_opt_state(params)
        _, grads[where] = eng.value_and_grad(params, small, small_labels)
        zero_counts(kernels)
        params, opt, loss = eng.train_step(params, opt, small, small_labels)
        losses[where] = float(loss)
        trees[where] = eng.gather(params)
        if where == "cuda":
            f_launches, f_bodies = b1.launches, dict(b1.body_launches)
        del eng, params, opt
    _free(torch)
    f_loss = abs(losses["cuda"] - losses["cpu"])
    f_diff = _tree_max_diff(trees["cuda"], trees["cpu"])
    f_grad = _grad_rel_diff(grads["cuda"], grads["cpu"])
    report["f_card_vs_cpu"] = dict(losses=losses, loss_abs_diff=f_loss,
                                   max_param_abs_diff=f_diff,
                                   max_grad_rel_diff=f_grad,
                                   b1_launches=f_launches,
                                   b1_bodies=f_bodies)
    log(f"   (f) card against CPU: {json.dumps(report['f_card_vs_cpu'])}")
    check(f_loss <= 1e-5 and f_diff <= 1e-5,
          f"(f) loss {f_loss:.3g} and parameters {f_diff:.3g} after one "
          f"step within 1e-5 of the CPU's")
    # one step at 1e-3 moves most leaves by less than 1e-5: the reduced
    # gradient itself is held, leaf by leaf, against the CPU's
    check(f_grad <= GRAD_RTOL,
          f"(f) every leaf's gradient within {GRAD_RTOL} of the CPU's in "
          f"norm (worst {f_grad:.3g})")
    del grads
    if dev.type == "cuda":
        check(f_launches == 2 * 2 * 2 * 2,
              f"(f) B1 launched {f_launches} times: 2 units x 2 "
              f"microbatches x 2 dp x forward and remat")
        check_f32_b1_body(f_bodies, f_launches, "(f) card against CPU")
    del trees

    # (g) engine against engine: (a)'s weights in float32 at pp=4, dp=1
    # against PipelineModel (GPipe, M=4) on the same per-layer weights
    eng = bert(make_pipeline_mesh(4, [dev] * 4), per_stage, c=f32)
    params = eng.place(tree_a)
    opt = eng.init_opt_state(params)
    layer_cfgs = bert_layer_configs(f32, num_encoder_units=units,
                                    num_classes=3, deterministic=True)
    wm = worker_pool(4)
    Allocator(layer_cfgs, wm).even_allocate()
    ps = ParameterServer(layer_cfgs,
                         state_dicts=eng.layer_state_dicts(tree_a))
    pm = PipelineModel(wm, ps, sgd(SPMD_LR), cross_entropy_loss,
                       devices=[dev] * 4, num_microbatches=SPMD_MICRO)
    del tree_a
    # the gradients of the first batch: the engine's reduced gradient
    # against the stages' accumulated ``.grad``, layer by layer
    _, g_tree = eng.value_and_grad(params, data, labels)
    g_spmd = eng.layer_state_dicts(g_tree)
    pm.compute_gradients(data, labels, generator=torch.Generator())
    g_pipe = [{n: p.grad if p.grad is not None else torch.zeros_like(p)
               for n, p in module.named_parameters()}
              for stage in pm.stages for module in stage.stack.layers]
    g_grad = _grad_rel_diff(g_spmd, g_pipe)
    for stage in pm.stages:
        stage.optimizer.zero_grad(set_to_none=True)
    del g_tree, g_spmd, g_pipe
    g_ms = dict(spmd=[], pipeline=[])
    g_loss = {}
    for i in range(3):
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, loss = eng.train_step(params, opt, data, labels)
        _sync(torch, dev)
        g_ms["spmd"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pm_loss = pm.train_step(data, labels,
                                generator=torch.Generator().manual_seed(i))
        _sync(torch, dev)
        g_ms["pipeline"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            g_loss = dict(spmd=float(loss), pipeline=float(pm_loss))
            pm.sync_to_parameter_server()
            ours = eng.layer_state_dicts(eng.gather(params))
            g_diff = max((a[k].cpu() - b[k].cpu()).abs().max().item()
                         for a, b in zip(ours, ps.params) for k in a)
    del eng, params, opt, pm
    _free(torch)
    g_loss_diff = abs(g_loss["spmd"] - g_loss["pipeline"])
    report["g_engine_vs_pipeline"] = dict(
        losses=g_loss, loss_abs_diff=g_loss_diff, max_param_abs_diff=g_diff,
        max_grad_rel_diff=g_grad, step_ms=g_ms)
    log(f"   (g) against PipelineModel: "
        f"{json.dumps(report['g_engine_vs_pipeline'])}")
    check(g_loss_diff <= 1e-5 and g_diff <= 1e-5,
          f"(g) loss {g_loss_diff:.3g} and parameters {g_diff:.3g} after "
          f"one step within 1e-5 of PipelineModel's")
    check(g_grad <= GRAD_RTOL,
          f"(g) every layer's gradient within {GRAD_RTOL} of "
          f"PipelineModel's in norm (worst {g_grad:.3g})")
    return report


def flash_cuda_core_checks(torch, np, ptxas):
    """B1's CUDA-core body at its own head_dims (float32 at D=36, bf16
    at D=40; B=4, L=128, H=16, 32 keys padded), against its plain version
    and timed as phase 3 times, with its bound as :func:`flash_bound`
    reckons it (bf16 at the tensor cores' peak; float32 at the
    float32-accurate 3xTF32 bound, the FFMA bound beside it) and SDPA's
    time."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    rows = []
    for dtype, D, tol in (("float32", 36, 1e-4), ("bfloat16", 40, 2e-2)):
        rng = np.random.default_rng(400 + D)
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal((4, 128, 16, D))
                                    .astype(np.float32)).to("cuda", dt)
                   for _ in range(3))
        bias = torch.zeros(4, 128)
        bias[:, -32:] = -10000.0
        bias = bias.to("cuda", dt)
        scale = D ** -0.5
        err = (flash_attention(q, k, v, bias).float()
               - flash_attention_reference(q, k, v, bias, scale).float()
               ).abs().max().item()
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        body = flash_body(torch, ptxas, q)
        B, L, H, _ = q.shape
        bound_ms, bound_by, extra = flash_bound(
            q, bias, dtype, "tensor_core_f32" if dtype == "float32" else None)
        row = dict(
            kernel="flash_attention", case=f"cuda_core_D{D}", B=B, L=L, H=H,
            D=D, padded_keys=32, dtype=dtype, max_abs_err=err, tol=tol,
            ms=time_ms(torch, lambda: flash_attention(q, k, v, bias)),
            plain_ms=time_ms(torch, lambda: flash_attention_reference(
                q, k, v, bias, scale)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias[:, None, None, :])),
            bound_ms=bound_ms, bound_by=bound_by, **extra, **body)
        log(f"   {json.dumps(row)}")
        check(body["body"] == "cuda_core" and err <= tol,
              f"flash_attention cuda_core D={D} {dtype}: max |err| "
              f"{err:.3g} <= {tol}")
        rows.append(row)
    return rows



# --------------------------------------------------------------------------
# phase 30: multihost, heartbeat and elastic on the card
# --------------------------------------------------------------------------

# phase 30 starts its processes as ``python3 chip_smoke.py --elastic-child
# ROLE ...``; each writes what it found as JSON under ``--work``
ELASTIC_CHILD = "--elastic-child"
ELASTIC_LAYERS, ELASTIC_STEPS = 8, 12  # BERT-large's width, cut in depth
ELASTIC_FAULT_ITER, ELASTIC_FACTOR = 3, 6.0
ELASTIC_BEATS = 50
CRASH_ITERS = 8  # (d): JAX's test_elastic_reform.py trainer
CHILD_TIMEOUT_S = dict(a=120.0, b=90.0, c=420.0, d=240.0)


def _write_json(work, name, obj):
    (Path(work) / name).write_text(json.dumps(obj, indent=1))


def _read_json(work, name):
    return json.loads((Path(work) / name).read_text())


def _drop_beat_run(torch, np, dev, dev_arg):
    """A ``Runner`` over a 4-unit ``MatmulStack`` pipeline (2 workers on
    ``dev``) for 3 steps with ``HeartbeatHook(interval=1)`` and a
    ``drop_beat`` fault at iteration 1: 2 beats, the drop consumed."""
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        FaultInjectionHook,
        FaultPlan,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd
    from skycomputing_tpu_torch.runner import HeartbeatHook, Runner

    features = 256
    mc = [dict(layer_type="MatmulStack", features=features, depth=1,
               dtype="float32") for _ in range(4)]
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=0))
        for i in range(2)])
    Allocator(mc, wm).even_allocate()
    ps = ParameterServer(mc, generator=torch.Generator().manual_seed(SEED))
    model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                          devices=[dev])
    rng = np.random.default_rng(SEED)
    batch = (rng.normal(size=(8, features)).astype(np.float32),
             rng.integers(0, features, size=(8,)).astype(np.int32))
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=3)
    faults = FaultInjectionHook(FaultPlan([dict(iter=1, kind="drop_beat")]))
    hook = HeartbeatHook(interval=1, timeout_s=60.0, action="stop",
                         device=dev_arg)
    runner.register_hook(faults)
    runner.register_hook(hook)
    runner.train([batch] * 3)
    return dict(hook_iters=runner.iter, hook_beats=hook.heartbeat.beats,
                hook_failed=hook.heartbeat.failed,
                drops_consumed=[e.get("consumed", True)
                                for e in faults.applied
                                if e["kind"] == "drop_beat"])


def elastic_world_of_one(torch, np, args, started):
    """(a): a world of one (NCCL on the card), its global mesh, 50 timed
    beats and a beat dropped by the fault harness."""
    import torch.distributed as dist
    from skycomputing_tpu_torch.parallel import (
        PeerHeartbeat,
        global_mesh,
        initialize_from_env,
        is_coordinator,
    )

    on_card = args.device != "cpu"
    dev_arg = None if on_card else "cpu"
    t0 = time.perf_counter()
    joined = initialize_from_env(device=dev_arg)
    init_s = time.perf_counter() - t0
    mesh = global_mesh(("dp",), (1,),
                       devices=None if on_card else [torch.device("cpu")])
    hb = PeerHeartbeat(timeout_s=60.0, device=dev_arg)
    oks = [hb.beat()]
    first_ms = hb.last_beat_s * 1e3  # communicator set-up included
    ms = []
    for _ in range(ELASTIC_BEATS):
        oks.append(hb.beat())
        ms.append(hb.last_beat_s * 1e3)
    # the same beat with no collective (clone, sum, .item()): what the
    # all-reduce adds to a beat
    local_ms = []
    for _ in range(ELASTIC_BEATS):
        t1 = time.perf_counter()
        hb._ones.clone().sum().item()
        local_ms.append((time.perf_counter() - t1) * 1e3)
    out = dict(joined=joined, backend=dist.get_backend(),
               world=dist.get_world_size(), rank=dist.get_rank(),
               coordinator=is_coordinator(), mesh_shape=dict(mesh.shape),
               mesh_devices=[str(d) for d in mesh.devices.flatten()],
               mesh_owners=mesh.owners.flatten().tolist(), init_s=init_s,
               all_ok=all(oks), failed=hb.failed, beats=hb.beats,
               first_beat_ms=first_ms, beat_ms=ms,
               beat_ms_median=float(np.median(ms)),
               beat_ms_p95=float(np.percentile(ms, 95)),
               local_ms_median=float(np.median(local_ms)),
               start_to_ready_s=time.time() - started)
    out.update(_drop_beat_run(torch, np, mesh.devices.flat[0], dev_arg))
    dist.destroy_process_group()
    _write_json(args.work, "a.json", out)
    return 0


def elastic_peer_death(torch, np, args, started):
    """(b): one process of a two-process gloo world; both beat once,
    rank 1 exits, rank 0's next beat must detect it."""
    from skycomputing_tpu_torch.parallel import (
        PeerHeartbeat,
        initialize_from_env,
    )

    initialize_from_env(device="cpu")
    rank = int(os.environ["SKYTPU_PROCESS_ID"])
    state = {}

    def detected(reason):
        _write_json(args.work, "b.json", dict(
            detected=True, detect_s=time.perf_counter() - state["t0"],
            by="exception" if "raised" in reason else "watchdog",
            reason=reason))
        os._exit(0)

    hb = PeerHeartbeat(timeout_s=20.0, on_failure=detected, device="cpu")
    if not hb.beat():
        return 1
    if rank == 1:
        os._exit(0)  # the peer dies without leaving the world
    state["t0"] = time.perf_counter()
    hb.beat()
    _write_json(args.work, "b.json", dict(detected=False))
    return 1


def elastic_bert_trainer(torch, np, args, started):
    """(c): the supervised trainer.  Generation 0: BERT-large's width
    (bf16, flash on), ``args.layers`` layers, evenly over 4 stimulated
    workers on the card, under ``Runner`` with ``HeartbeatHook`` (a
    world of one), a slowdown of worker 0 and ``SelfHealHook(mode=
    "exit")``, which exits ``REALLOC_RC``.  Generation 1: the payload
    from ``SKYTPU_ALLOCATION`` validated and applied, ``optimal_allocate``,
    the snapshot loaded, and training on to the last iteration."""
    import torch.distributed as dist
    from skycomputing_tpu_torch.analysis import verify_allocation_payload
    from skycomputing_tpu_torch.dataset import RandomTokenGenerator
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        FaultInjectionHook,
        FaultPlan,
        ModelBenchmarker,
        ParameterServer,
        WorkerManager,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.ops import _build, cross_entropy_loss
    from skycomputing_tpu_torch.ops.flash_attention import flash_attention
    from skycomputing_tpu_torch.parallel import (
        PipelineModel,
        initialize_from_env,
        sgd,
    )
    from skycomputing_tpu_torch.runner import (
        HeartbeatHook,
        Hook,
        Runner,
        SelfHealHook,
    )

    on_card = args.device != "cpu"
    dev_arg = None if on_card else "cpu"
    devices = None if on_card else [torch.device("cpu")]
    gen = int(os.environ["SKYTPU_GENERATION"])
    snapshot = str(Path(args.work) / "snapshot.pt")
    rec = dict(gen=gen, started_wall=started,
               lib_on_disk=on_card and _build.library_path(
                   "flash_attention").exists(),
               stamps=[("imported", time.time())])
    rec["joined"] = initialize_from_env(device=dev_arg)
    rec.update(backend=dist.get_backend(), world=dist.get_world_size())
    rec["stamps"].append(("joined", time.time()))

    cfg, model_cfg = bert_units(args.preset, args.layers)
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=0))
        for i in range(BERT_WORKERS)])
    allocator = Allocator(
        model_cfg, wm,
        ModelBenchmarker(model_cfg, RandomTokenGenerator(
            BERT_BATCH, BERT_SEQ, cfg.vocab_size)),
        proxy_device_benchmarker(wm, devices=devices))
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(SEED))
    rec["stamps"].append(("initialized", time.time()))
    start = 0
    if gen == 0:
        allocator.even_allocate()
        rec["stamps"].append(("allocated", time.time()))
    else:
        payload = json.loads(os.environ["SKYTPU_ALLOCATION"])
        problems = verify_allocation_payload(payload)
        if problems:
            raise ValueError(f"SKYTPU_ALLOCATION refused: {problems}")
        allocator.apply_device_scales(payload["device_scale"])
        allocator.optimal_allocate(max_time=5.0)
        rec["stamps"].append(("allocated", time.time()))
        ps.load_weights_from_file(snapshot)
        rec["stamps"].append(("loaded", time.time()))
        start = int(payload["iter"])
        rec["payload"] = payload
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=devices,
                          num_microbatches=BERT_MICROBATCHES)
    rec["stamps"].append(("built", time.time()))
    if gen > 0:
        # the stages' weights, gathered back, against the file
        saved = torch.load(snapshot, map_location="cpu",
                           weights_only=True)["layers"]
        model.sync_to_parameter_server()
        rec["bitwise_equal_to_snapshot"] = len(saved) == len(ps.params) \
            and all(a.keys() == b.keys() and all(
                torch.equal(a[k].cpu(), b[k]) for k in b)
                for a, b in zip(ps.params, saved))
    rec["units_by_worker"] = {str(w.stim_index): len(w.model_config or [])
                              for w in wm.worker_pool}
    rec["partition"] = model.partition_signature()
    if on_card:
        _build.load("flash_attention")  # before the steps, not in them
    loads0 = _build.load.count
    bodies0 = dict(flash_attention.body_launches)
    launches0 = flash_attention.launches
    rec.update(start_iter=start, iters=[], step_ms=[], b1_per_step=[],
               losses=[])

    class Record(Hook):
        """Registered first: its before_iter opens the step's window,
        its after_iter closes it before the beat and the heal."""

        def before_iter(self, runner):
            self.launches = flash_attention.launches
            self.t0 = time.perf_counter()

        def after_iter(self, runner):
            if on_card:
                torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - self.t0) * 1e3)
            rec["iters"].append(runner.iter - 1)
            rec["b1_per_step"].append(flash_attention.launches
                                      - self.launches)
            rec["losses"].append(float(runner.model.stats.loss))
            rec.setdefault("first_step_end_wall", time.time())

        def after_run(self, runner):
            rec["exit_wall"] = time.time()
            rec["aborted"] = runner.aborted
            rec["loads_in_steps"] = _build.load.count - loads0
            rec["b1_launches"] = flash_attention.launches - launches0
            rec["b1_bodies"] = {b: n - bodies0[b] for b, n in
                                flash_attention.body_launches.items()}
            rec["beats"] = beat.heartbeat.beats
            rec["beat_failed"] = beat.heartbeat.failed
            rec["heal_events"] = [
                dict(kind=e["kind"], iter=e["iter"],
                     divergence={str(k): v for k, v in
                                 e.get("divergence", {}).items()})
                for e in heal.events]
            _write_json(args.work, f"gen_{gen}.json", rec)

    beat = HeartbeatHook(interval=1, timeout_s=60.0, device=dev_arg)
    # the heal's stage times: the median of 3 round-robin samples.  One
    # sample a stage let a disturbed sample decide the straggler (healthy
    # stages 0.48-1.35 of the median with worker 0 at 2.70, where a quiet
    # process reads them within 1.3 and worker 0 at 3.5-7.3)
    heal = SelfHealHook(allocator, window=2, k_windows=2, threshold=1.35,
                        grace_iters=1, baseline_windows=1, max_heals=1,
                        measure_repeats=3, measure_inner=1,
                        solver_time_s=5.0, mode="exit",
                        snapshot_path=snapshot)
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=args.steps)
    runner.iter = start
    # a degraded node stays degraded: the slowdown holds in every
    # generation from its iteration on
    fault = FaultPlan([dict(iter=max(ELASTIC_FAULT_ITER, start),
                            kind="slowdown", worker=0,
                            factor=ELASTIC_FACTOR)])
    for hook in (Record(), beat, FaultInjectionHook(fault), heal):
        runner.register_hook(hook)
    data, labels = bert_batch(np, cfg.vocab_size)
    rec["stamps"].append(("checked", time.time()))
    rec["ready_wall"] = time.time()
    try:
        runner.train([(data, labels)] * (args.steps - start))
    finally:
        dist.destroy_process_group()
    return 0


def elastic_crash_trainer(torch, np, args, started):
    """(d): JAX's ``test_elastic_reform.py`` trainer on the card: a
    least-squares fit of a 16 x 4 weight over 8 rows, each rank's rows
    on ``cuda:0``, their gradient summed over gloo; rank 0 logs and
    checkpoints every iteration; node 1's trainer dies at iteration 2 of
    generation 0."""
    import torch.distributed as dist
    from skycomputing_tpu_torch.parallel import initialize_from_env
    from skycomputing_tpu_torch.utils import atomic_torch_save

    node_id = int(os.environ["ELASTIC_NODE_ID"])
    gen = int(os.environ["SKYTPU_GENERATION"])
    dev = torch.device("cuda", 0) if args.device != "cpu" else (
        torch.device("cpu"))
    initialize_from_env(device="cpu")  # gloo: two ranks share one card
    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
    xs, ys = X[rows].to(dev), y[rows].to(dev)
    ckpt = os.path.join(args.work, "ckpt.pt")
    if os.path.exists(ckpt):
        blob = torch.load(ckpt, weights_only=True)
        W, start = blob["W"].to(dev), int(blob["it"])
    else:
        W, start = torch.zeros(16, 4, device=dev), 0
    for it in range(start, CRASH_ITERS):
        err = xs @ W - ys
        buf = torch.cat([(2.0 / 32) * (xs.T @ err).reshape(-1),
                         ((err ** 2).sum() / 32).reshape(1)]).cpu()
        dist.all_reduce(buf)
        W = W - 0.02 * buf[:-1].reshape(16, 4).to(dev)
        if rank == 0:
            with open(os.path.join(args.work, "losses.log"), "a") as fh:
                fh.write(f"{gen} {it} {float(buf[-1]):.8f} "
                         f"{time.time():.6f}\n")
            atomic_torch_save({"W": W.cpu(), "it": it + 1}, ckpt)
        if node_id == 1 and gen == 0 and it == 2:
            os._exit(3)  # node 1 is lost: its trainer dies here
    dist.destroy_process_group()
    return 0


def elastic_supervise(torch, np, args, started):
    """(c), (d): one node's ``ElasticSupervisor`` over this script's
    ``args.trainer`` role."""
    from skycomputing_tpu_torch.parallel import ElasticSupervisor

    env = dict(os.environ)
    env["ELASTIC_NODE_ID"] = str(args.node)
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), ELASTIC_CHILD,
           args.trainer, "--work", args.work, "--device", args.device,
           "--preset", args.preset, "--layers", str(args.layers),
           "--steps", str(args.steps)]
    sup = ElasticSupervisor(
        args.node, str(Path(args.work) / "rdv"),
        trainer_cmd=lambda spec, rank: cmd, expect=args.expect,
        max_reforms=args.max_reforms, max_reallocs=args.max_reallocs,
        env=env, stale_s=args.stale, settle_s=args.settle, timeout_s=60.0)
    rc = sup.run()
    _write_json(args.work, f"supervisor_{args.node}.json", dict(
        rc=rc, generations=[s["members"] for s in sup.generations],
        specs=sup.generations, end_wall=time.time()))
    return 0 if rc == 0 else 1


def elastic_child(argv) -> int:
    """The entry of phase 30's processes (``ELASTIC_CHILD ROLE ...``)."""
    started = time.time()
    import argparse

    parser = argparse.ArgumentParser(prog=f"chip_smoke.py {ELASTIC_CHILD}")
    parser.add_argument("role", choices=sorted(ELASTIC_ROLES))
    parser.add_argument("--work", required=True)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--preset", default="large")
    parser.add_argument("--layers", type=int, default=ELASTIC_LAYERS)
    parser.add_argument("--steps", type=int, default=ELASTIC_STEPS)
    parser.add_argument("--trainer", default="bert")
    parser.add_argument("--node", type=int, default=0)
    parser.add_argument("--expect", type=int, default=1)
    parser.add_argument("--max-reforms", type=int, default=0)
    parser.add_argument("--max-reallocs", type=int, default=0)
    parser.add_argument("--stale", type=float, default=6.0)
    parser.add_argument("--settle", type=float, default=0.5)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    return ELASTIC_ROLES[args.role](torch, np, args, started)


ELASTIC_ROLES = dict(world_of_one=elastic_world_of_one,
                     peer_death=elastic_peer_death,
                     bert=elastic_bert_trainer, crash=elastic_crash_trainer,
                     supervise=elastic_supervise)


def run_children(runs, timeout_s):
    """Start each ``(args, env, log path)`` as ``chip_smoke.py
    ELASTIC_CHILD *args`` in a session of its own, wait for all within
    ``timeout_s``, then kill what is left of every session (a
    supervisor's trainers too).  Returns the exit codes, None where the
    deadline passed."""
    procs = []
    try:
        for argv, env, log_path in runs:
            fh = open(log_path, "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), ELASTIC_CHILD,
                 *argv], env=env, stdout=fh, stderr=subprocess.STDOUT,
                start_new_session=True), fh))
        deadline = time.monotonic() + timeout_s
        rcs = []
        for p, _ in procs:
            try:
                rcs.append(p.wait(
                    timeout=max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        return rcs
    finally:
        for p, fh in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
            fh.close()


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _check_children(what, rcs, logs, want=None):
    want = want if want is not None else [0] * len(rcs)
    if rcs != want:
        for log_path in logs:
            tail = Path(log_path).read_text()[-3000:]
            log(f"   --- {log_path.name} (tail) ---\n{tail}")
    check(rcs == want, f"{what}: exit codes {rcs} (want {want})")


def elastic_path(torch, np, dev, workdir, preset="large",
                 layers=ELASTIC_LAYERS, steps=ELASTIC_STEPS):
    """Phase 30 (a)-(d); every sub-run is fatal on failure.  ``dev`` is
    the card (the CPU only to rehearse the phase: gloo then stands in
    for NCCL and B1 runs its plain version)."""
    from skycomputing_tpu_torch.parallel.elastic import _free_port

    on_card = dev.type == "cuda"
    device = "cuda" if on_card else "cpu"
    common = ["--device", device, "--preset", preset, "--layers",
              str(layers), "--steps", str(steps)]
    report = {}

    # (a) a world of one
    work = workdir / "a"
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    logs = [work / "a.log"]
    rcs = run_children([(["world_of_one", "--work", str(work), *common],
                         _child_env(SKYTPU_COORDINATOR=f"127.0.0.1:"
                                    f"{_free_port()}",
                                    SKYTPU_NUM_PROCESSES=1,
                                    SKYTPU_PROCESS_ID=0,
                                    SKYTPU_PEER_TIMEOUT_S=20), logs[0])],
                       CHILD_TIMEOUT_S["a"])
    _check_children("(a) world of one", rcs, logs)
    a = report["a_world_of_one"] = _read_json(work, "a.json")
    a["command_s"] = time.perf_counter() - t0
    check(a["joined"] and a["world"] == 1 and a["coordinator"]
          and a["backend"] == ("nccl" if on_card else "gloo")
          and a["mesh_shape"] == {"dp": 1} and a["mesh_owners"] == [0],
          f"(a) a world of one under {a['backend']}, mesh "
          f"{a['mesh_shape']} on {a['mesh_devices']}, rank 0 the "
          f"coordinator")
    check(a["all_ok"] and not a["failed"]
          and a["beats"] == ELASTIC_BEATS + 1,
          f"(a) {a['beats']} beats, every one whole: median "
          f"{a['beat_ms_median']:.3f} ms, p95 {a['beat_ms_p95']:.3f} ms "
          f"(the first, with the communicator's set-up, "
          f"{a['first_beat_ms']:.1f} ms; the same beat without the "
          f"all-reduce {a['local_ms_median']:.3f} ms)")
    check(a["hook_iters"] == 3 and a["hook_beats"] == 2
          and not a["hook_failed"] and a["drops_consumed"] == [True],
          f"(a) HeartbeatHook over 3 steps: {a['hook_beats']} beats, the "
          f"drop_beat at iteration 1 consumed")

    # (b) peer death under gloo
    work = workdir / "b"
    work.mkdir()
    t0 = time.perf_counter()
    port = _free_port()
    logs = [work / f"b{r}.log" for r in range(2)]
    rcs = run_children([(["peer_death", "--work", str(work), *common],
                         _child_env(SKYTPU_COORDINATOR=f"127.0.0.1:{port}",
                                    SKYTPU_NUM_PROCESSES=2,
                                    SKYTPU_PROCESS_ID=r,
                                    SKYTPU_PEER_TIMEOUT_S=20), logs[r])
                        for r in range(2)], CHILD_TIMEOUT_S["b"])
    _check_children("(b) peer death", rcs, logs)
    b = report["b_peer_death"] = _read_json(work, "b.json")
    b["command_s"] = time.perf_counter() - t0
    check(b["detected"] and b["detect_s"] < 20.0,
          f"(b) the survivor detected its dead peer by {b['by']} in "
          f"{b['detect_s']:.4f} s")

    # (c) a supervised planned re-form through B1
    work = workdir / "c"
    work.mkdir()
    t0 = time.perf_counter()
    logs = [work / "supervisor.log"]
    rcs = run_children([(["supervise", "--work", str(work), *common,
                          "--trainer", "bert", "--expect", "1",
                          "--max-reforms", "0", "--max-reallocs", "1",
                          "--settle", "0.5"], _child_env(), logs[0])],
                       CHILD_TIMEOUT_S["c"])
    _check_children("(c) supervised re-form", rcs, logs)
    sup = _read_json(work, "supervisor_0.json")
    g0, g1 = (_read_json(work, f"gen_{g}.json") for g in (0, 1))
    c = report["c_planned_reform"] = dict(supervisor=sup, gen_0=g0,
                                          gen_1=g1)
    c["command_s"] = time.perf_counter() - t0
    check(sup["rc"] == 0 and sup["generations"] == [[0], [0]]
          and (work / "rdv" / "planned_gen_1.json").exists(),
          f"(c) the trainer exited REALLOC_RC and the supervisor re-formed "
          f"{sup['generations']} as a planned re-form")
    exits = [e for e in g0["heal_events"] if e["kind"] == "heal_exit"]
    div = exits[0]["divergence"] if exits else {}
    check(len(exits) == 1 and not g0["aborted"]
          and max(div, key=div.get) == "0",
          f"(c) generation 0: one heal_exit after "
          f"{exits[0]['iter'] if exits else None} steps, worker 0 the "
          f"straggler "
          f"({ {k: round(v, 3) for k, v in div.items()} }), not aborted")
    check(g0["beats"] == len(g0["iters"]) and g1["beats"] == len(
        g1["iters"]) and not g0["beat_failed"] and not g1["beat_failed"],
          f"(c) a heartbeat after every step under {g0['backend']}: "
          f"{g0['beats']} + {g1['beats']} beats")
    payload = g1["payload"]
    check(g1["start_iter"] == payload["iter"] == g0["iters"][-1] + 1
          and payload["device_scale"]["0"] > 1.3
          and g1["bitwise_equal_to_snapshot"],
          f"(c) generation 1 validated the payload (worker 0's scale "
          f"{payload['device_scale']['0']:.3f}), resumed at iteration "
          f"{g1['start_iter']}, every parameter bitwise the snapshot's")
    check(g1["units_by_worker"]["0"] < g0["units_by_worker"]["0"],
          f"(c) partition {g0['partition']} -> {g1['partition']}: worker 0 "
          f"sheds {g0['units_by_worker']['0']} -> "
          f"{g1['units_by_worker']['0']} units")
    check(g0["iters"] + g1["iters"] == list(range(steps))
          and all(np.isfinite(x) for x in g0["losses"] + g1["losses"]),
          f"(c) iterations {g0['iters']} then {g1['iters']}: continuous, "
          f"none repeated, every loss finite")
    per_step = 2 * layers * BERT_MICROBATCHES if on_card else 0
    for g in (g0, g1):
        check(g["b1_per_step"] == [per_step] * len(g["iters"])
              and g["b1_bodies"].get("tensor_core", 0) == g["b1_launches"]
              and (g["b1_launches"] > 0) == on_card,
              f"(c) generation {g['gen']}: B1 {per_step} launches a step, "
              f"{g['b1_launches']} in all ({json.dumps(g['b1_bodies'])}); "
              f"step ms {[round(t, 1) for t in g['step_ms']]}")
    check(g1["lib_on_disk"] == on_card and g1["loads_in_steps"] == 0
          and g0["loads_in_steps"] == 0,
          f"(c) no kernel built or loaded inside the steps "
          f"(library on disk at generation 1's start: {g1['lib_on_disk']})")
    c["reform_s"] = g1["first_step_end_wall"] - g0["exit_wall"]
    # the re-form by part: the supervisor (exit to the relaunched
    # interpreter), then the trainer's stamps, then its first step
    c["reform_parts_s"] = parts = dict(
        exit_to_relaunch=g1["started_wall"] - g0["exit_wall"])
    last = g1["started_wall"]
    for name, wall in g1["stamps"]:
        parts[f"to_{name}"] = wall - last
        last = wall
    parts["first_step"] = g1["first_step_end_wall"] - g1["ready_wall"]
    log(f"   (c) REALLOC_RC exit to generation 1's first step done: "
        f"{c['reform_s']:.3f} s "
        f"({json.dumps({k: round(v, 3) for k, v in c['reform_parts_s'].items()})})")
    c["b1_launches"] = g0["b1_launches"] + g1["b1_launches"]

    # (d) a crash re-form under gloo
    work = workdir / "d"
    work.mkdir()
    t0 = time.perf_counter()
    logs = [work / f"supervisor{n}.log" for n in range(2)]
    # gloo reports the lost peer at once, so the lost node's beacon must
    # be stale (3 s) by the end of the survivor's settle (4 s)
    rcs = run_children([(["supervise", "--work", str(work), *common,
                          "--trainer", "crash", "--node", str(n),
                          "--expect", "2", "--max-reforms", str(mr),
                          "--stale", "3", "--settle", "4"], _child_env(),
                         logs[n]) for n, mr in ((0, 3), (1, 0))],
                       CHILD_TIMEOUT_S["d"])
    _check_children("(d) crash re-form", rcs, logs, want=[0, 1])
    sups = [_read_json(work, f"supervisor_{n}.json") for n in range(2)]
    rows = [ln.split() for ln in
            (work / "losses.log").read_text().splitlines()]
    by_iter = {int(it): (int(g), float(l), float(w))
               for g, it, l, w in rows}
    losses = [by_iter[i][1] for i in sorted(by_iter)]
    d = report["d_crash_reform"] = dict(
        generations=sups[0]["generations"], rows=rows,
        command_s=time.perf_counter() - t0)
    check(sups[0]["generations"] == [[0, 1], [0]] and sups[1]["rc"] != 0,
          f"(d) the survivor re-formed {sups[0]['generations']}; the lost "
          f"node's supervisor gave up (rc {sups[1]['rc']})")
    check(len(rows) == CRASH_ITERS
          and sorted(by_iter) == list(range(CRASH_ITERS))
          and {g for g, _, _ in by_iter.values()} == {0, 1}
          and losses[-1] < losses[3] < losses[0]
          and max(l for g, l, _ in by_iter.values() if g == 1)
          < min(l for g, l, _ in by_iter.values() if g == 0),
          f"(d) iterations 0-{CRASH_ITERS - 1} once each, the losses "
          f"falling across the boundary: "
          f"{[round(x, 4) for x in losses]}")
    d["reform_s"] = min(w for g, _, w in by_iter.values() if g == 1) - max(
        w for g, _, w in by_iter.values() if g == 0)
    log(f"   (d) last step of generation 0 to the first of generation 1: "
        f"{d['reform_s']:.3f} s")
    return report


HEAL_PROBE = "--heal-probe"
# (samples a stage, chained iterations a sample, measurements) of the probe
HEAL_PROBE_SETTINGS = ((1, 1, 8), (3, 1, 8), (5, 2, 4))


def heal_probe(argv) -> int:
    """Phase 30 (c)'s heal measurement, repeated (``HEAL_PROBE [--tree
    DIR] [--tag TAG] [--device cpu]``): BERT-large's width, 8 layers,
    evenly over 4 workers, worker 0 6x slower from iteration 3 of 7,
    then ``measure_stage_times`` at each of ``HEAL_PROBE_SETTINGS`` and
    ``Allocator.stage_divergence`` of each measurement, with the static
    profile's FLOPs a stage.  ``--tree`` imports the port from another
    checkout (a parent commit, unpacked), so two commits are compared on
    one card; one JSON line to stdout."""
    import argparse

    parser = argparse.ArgumentParser(prog=f"chip_smoke.py {HEAL_PROBE}")
    parser.add_argument("--tree", default=str(ROOT))
    parser.add_argument("--tag", default="probe")
    parser.add_argument("--device", default=None)
    parser.add_argument("--preset", default="large")
    parser.add_argument("--layers", type=int, default=ELASTIC_LAYERS)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch
    from skycomputing_tpu_torch.dataset import RandomTokenGenerator
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ModelBenchmarker,
        ParameterServer,
        WorkerManager,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd

    on_card = args.device != "cpu"
    devices = None if on_card else [torch.device("cpu")]
    cfg, model_cfg = bert_units(args.preset, args.layers)
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=0))
        for i in range(BERT_WORKERS)])
    allocator = Allocator(
        model_cfg, wm,
        ModelBenchmarker(model_cfg, RandomTokenGenerator(
            BERT_BATCH, BERT_SEQ, cfg.vocab_size)),
        proxy_device_benchmarker(wm, devices=devices))
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(SEED))
    allocator.even_allocate()
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=devices,
                          num_microbatches=BERT_MICROBATCHES)
    data, labels = bert_batch(np, cfg.vocab_size)
    occupied = [w for w in sorted(wm.worker_pool, key=lambda w: w.rank)
                if w.model_config]
    worker0 = next(w for w in occupied if w.stim_index == 0)
    for it in range(7):
        if it == ELASTIC_FAULT_ITER:  # as FaultInjectionHook's slowdown
            worker0.extra_config["slowdown"] = ELASTIC_FACTOR
            model.stages[occupied.index(worker0)].slowdown = ELASTIC_FACTOR
        model.train_step(data, labels)
    flops = allocator._profiles()[3]
    sums, pos = [], 0
    for w in occupied:
        sums.append(float(sum(flops[pos:pos + len(w.model_config)])))
        pos += len(w.model_config)
    import skycomputing_tpu_torch

    out = dict(tag=args.tag, port=skycomputing_tpu_torch.__file__,
               partition=[
        len(w.model_config) for w in occupied], stage_flops=sums, runs={})
    for repeats, inner, n in HEAL_PROBE_SETTINGS:
        out["runs"][f"{repeats}x{inner}"] = [
            {str(k): v for k, v in allocator.stage_divergence(
                model.measure_stage_times(data, repeats=repeats,
                                          inner_iters=inner)).items()}
            for _ in range(n)]
    print(json.dumps(out))
    return 0


# --------------------------------------------------------------------------
# phase 31: the measuring tools (``skycomputing_tpu_torch/tools/``) on the
# card, each a subprocess; output under ``chiprun_out/tools/``
# --------------------------------------------------------------------------

TOOLS_OUT = ROOT / "chiprun_out" / "tools"


TOOLS_CHILD = "--tools-child"
TOOLS_CHILD_TIMEOUT_S = 600
# the step-overhead tool's module constants in phase 31 (its own: 6, 4)
TOOLS_STEPS, TOOLS_ROUNDS = 3, 2
TRACE_ROUNDS = 3  # B1 calls and decode ticks in phase 31's traced window


def tool_runs(out_dir):
    """Phase 31's commands that run in one process of their own: (log
    name, tool module, argv, environment for its run)."""
    from skycomputing_tpu_torch.tools import (
        bench_kv_cache,
        bench_mfu,
        bench_step_overhead,
        profile_allocation,
        validate_schedule_model,
    )

    bench_step_overhead.STEPS = TOOLS_STEPS
    bench_step_overhead.ROUNDS = TOOLS_ROUNDS
    return [
        ("bench_step_overhead", bench_step_overhead,
         ["--trace-out", str(out_dir / "step_overhead_trace.json")], {}),
        ("bench_step_overhead_mesh", bench_step_overhead,
         ["--mesh", "--out", str(out_dir / "bench_mesh_pipeline.json")], {}),
        ("validate_schedule_model", validate_schedule_model, [], {}),
        ("bench_kv_cache", bench_kv_cache, [], {}),
        ("bench_mfu", bench_mfu, [], {}),
        ("profile_allocation", profile_allocation,
         ["-c", "skycomputing_tpu_torch/configs/bert_pipeline.py", "--json",
          str(out_dir / "profile_allocation.json")],
         dict(SKYTPU_FLASH="1", SKYTPU_PROFILE="timed", STIMULATE="1")),
    ]


def tools_child(argv) -> int:
    """The entry of phase 31's tools process (``TOOLS_CHILD OUT_DIR``):
    each command's ``main`` in turn, in a fresh process on the card, its
    output to ``OUT_DIR/<log name>.log`` and its exit code, seconds and
    JSON line to ``OUT_DIR/child.json``.  A command that raises ends the
    process with its traceback."""
    out_dir = Path(argv[0])
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    results = {}
    for name, tool, args, env in tool_runs(out_dir):
        saved = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = tool.main(args)
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
            (out_dir / f"{name}.log").write_text(buf.getvalue())
        lines = [x for x in buf.getvalue().splitlines() if x.startswith("{")]
        results[name] = dict(rc=rc, seconds=time.perf_counter() - t0,
                             json=json.loads(lines[0]) if lines else None)
        print(f"{name}: exit {rc} in {results[name]['seconds']:.1f} s",
              flush=True)
    (out_dir / "child.json").write_text(json.dumps(results, indent=1))
    return 0


def first_json(text):
    return next(json.loads(line) for line in text.splitlines()
                if line.startswith("{"))


def reference_state_dict(torch, cfg, n_units, n_classes, seed):
    """A reference-style checkpoint: the ``nn.ModuleList`` state dict
    the reference's ParameterServer saves, ``"{idx}.{path}"`` keys, its
    weights drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size
    state = {}

    def lin(prefix, din, dout):
        state[f"{prefix}.weight"] = torch.randn(dout, din, generator=g) * .02
        state[f"{prefix}.bias"] = torch.randn(dout, generator=g) * .02

    def ln(prefix, dim):
        state[f"{prefix}.weight"] = 1 + torch.randn(dim, generator=g) * .02
        state[f"{prefix}.bias"] = torch.randn(dim, generator=g) * .02

    for name, rows in (("word_embeddings", cfg.vocab_size),
                       ("position_embeddings", cfg.max_position_embeddings),
                       ("token_type_embeddings", cfg.type_vocab_size)):
        state[f"0.{name}.weight"] = torch.randn(rows, H, generator=g) * .02
    ln("0.LayerNorm", H)
    idx = 1
    for _ in range(n_units):
        for name in ("query", "key", "value"):
            lin(f"{idx}.attention.self.{name}", H, H)
        lin(f"{idx}.attention.output.dense", H, H)
        ln(f"{idx}.attention.output.LayerNorm", H)
        lin(f"{idx + 1}.intermediate.dense_act", H, I)
        lin(f"{idx + 2}.output.dense", I, H)
        ln(f"{idx + 2}.output.LayerNorm", H)
        idx += 3
    lin(f"{idx}.dense_act", H, H)
    lin(f"{idx + 1}.classifier", H, n_classes)
    return state


def profiler_check(torch, np, kernels, gpt_mod, ServingEngine, Request):
    """Phase 31 (d): ``utils.profiling.trace`` of one B1 bf16 call and
    one decode tick of the paged engine at GPT-2 small: (the trace's
    kernel names, the launches by body inside it)."""
    from skycomputing_tpu_torch.utils.profiling import kernel_names, trace

    engine = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16",
                          "cuda")
    rng = np.random.default_rng(7)
    for _ in range(4):
        engine.submit(Request(prompt=rng.integers(1, 50257, 24).astype(
            np.int32), max_new_tokens=8))
    engine.step()  # the prefill wave: 4 prompts of one bucket
    q, k, v, bias = flash_case(torch, np, 8, 128, 0, "bfloat16", SEED)
    flash_attention = kernels[B1]["fn"]
    flash_attention(q, k, v, bias)  # warm
    torch.cuda.synchronize()
    launches0 = {n: dict(kernels[n]["fn"].body_launches) for n in (B1, B2)}
    # three rounds in the window: after earlier profiler sessions in the
    # process a window's first kernels can go unrecorded (seen on the
    # card: the first several of a window lost, at random)
    with trace(str(TOOLS_OUT / "profiler")) as prof:
        for _ in range(TRACE_ROUNDS):
            flash_attention(q, k, v, bias)
            engine.step()  # a decode tick
    names = kernel_names(prof)
    profiled = {n: {b: c - launches0[n].get(b, 0) for b, c in
                    kernels[n]["fn"].body_launches.items()
                    if c != launches0[n].get(b, 0)} for n in (B1, B2)}
    check(profiled == {B1: {"tensor_core": TRACE_ROUNDS},
                       B2: {"decode": LAYERS * TRACE_ROUNDS}},
          f"traced: {TRACE_ROUNDS} B1 calls and decode ticks "
          f"({json.dumps(profiled)})")
    check(any("flash_attention_kernel_mma" in n for n in names)
          and any("paged_attention_kernel_decode" in n for n in names),
          f"the trace's kernels include B1's tensor-core body and B2's "
          f"decode body ({len(names)} kernel names; attention's: "
          f"{[n[:48] for n in names if 'attention' in n]})")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return names, profiled


def tools_path(torch, np, kernels, gpt_mod, ServingEngine, Request):
    """Phase 31: each measuring tool as a user runs it on the card."""
    from skycomputing_tpu_torch.builder import build_layer_stack
    from skycomputing_tpu_torch.dynamics import ParameterServer
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.tools import (
        convert_torch_checkpoint,
        trace_report,
    )
    from skycomputing_tpu_torch.utils.torch_convert import (
        to_torch_state_dict,
    )

    shutil.rmtree(TOOLS_OUT, ignore_errors=True)
    TOOLS_OUT.mkdir(parents=True)
    out = {}

    # (a)-(c), (e), (f): each command's main in one process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), TOOLS_CHILD,
         str(TOOLS_OUT)], cwd=ROOT, capture_output=True, text=True,
        timeout=TOOLS_CHILD_TIMEOUT_S)
    (TOOLS_OUT / "child.log").write_text(
        proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    log(f"   tools process: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0, "the tools process ran every command"
          + ("" if proc.returncode == 0 else
             f" (stderr tail: {proc.stderr[-600:]})"))
    runs = json.loads((TOOLS_OUT / "child.json").read_text())
    for name, r in runs.items():
        log(f"   {name}: exit {r['rc']} in {r['seconds']:.1f} s")

    # (a) step overhead: the default mode (its traced window kept for
    # (d)), then --mesh; only the equivalence gate is held
    window = TOOLS_OUT / "step_overhead_trace.json"
    check(runs["bench_step_overhead"]["rc"] == 0, "bench_step_overhead ran")
    res = runs["bench_step_overhead"]["json"]
    for schedule, by in res["schedules"].items():
        s = by["hotpath"]
        log(f"   {schedule}: step {s['step_wall_s'] * 1e3:.3f} ms, dispatch "
            f"{s['dispatch_s'] * 1e3:.3f} ms ({s['dispatch_fraction']:.4f}"
            f" of the step), device wait {s['compute_wait_s'] * 1e3:.3f} ms")
    tr = res["tracing"]
    log(f"   tracing: {tr['step_wall_s_tracing_off'] * 1e3:.3f} -> "
        f"{tr['step_wall_s_tracing_on'] * 1e3:.3f} ms, "
        f"{tr['events_per_step']} events a step x "
        f"{tr['cost_per_event_us']:.3f} us = "
        f"{tr['modeled_overhead_pct']:.4f}% modeled")
    out["step_overhead"] = res
    rc = runs["bench_step_overhead_mesh"]["rc"]
    check(rc in (0, 1), f"bench_step_overhead --mesh ran (exit {rc}: 1 "
          f"is a gate missed)")
    mesh = json.loads((TOOLS_OUT / "bench_mesh_pipeline.json").read_text())
    gates = mesh["gates"]
    check(gates["params_bitwise_equal"]["ok"],
          f"mesh against per-device bitwise: "
          f"{json.dumps(gates['params_bitwise_equal']['value'])}")
    for name, g in gates.items():
        if name != "params_bitwise_equal":
            log(f"   finding: gate {name} = {json.dumps(g['value'])} "
                f"(target {g['target']}): "
                f"{'held' if g['ok'] else 'missed'}")
    for mode, m in mesh["modes"].items():
        log(f"   {mode}: {m['stages']} stages, step "
            f"{m['step_wall_s'] * 1e3:.3f} ms, dispatch share "
            f"{m['dispatch_fraction']:.4f}, {m['ops_per_step']} host ops "
            f"and {m['kernels_per_step']} kernels a step")
    out["mesh"] = mesh

    # (b) the schedule model at BERT-base (exit 1: a delta >= 15%)
    rc = runs["validate_schedule_model"]["rc"]
    check(rc in (0, 1), f"validate_schedule_model ran (exit {rc})")
    res = runs["validate_schedule_model"]["json"]
    log(f"   composition delta {res['composition_delta_pct']:.3f}%, "
        f"fill-drain {json.dumps(res['fill_drain_delta_pct'])} %, "
        f"concurrency ratio {res['concurrency_ratio']:.3f} (serial "
        f"{res['serial_devices']})")
    out["schedule_model"] = res

    # (c) cached against full decoding at GPT-2 small
    res = runs["bench_kv_cache"]["json"]
    check(runs["bench_kv_cache"]["rc"] == 0 and res["identical"],
          f"cached and full tokens identical: {res['identical']}")
    log(f"   cached {res['cached_ms_per_token']:.3f} ms/token, full "
        f"{res['full_ms_per_token']:.3f} ms/token "
        f"({res['speedup']:.3f}x)")
    out["kv_cache"] = res

    # (d) the profiler: one B1 bf16 call and one decode tick of the paged
    # engine at GPT-2 small, then trace_report over (a)'s window
    names, profiled = profiler_check(torch, np, kernels, gpt_mod,
                                     ServingEngine, Request)
    # trace_report reads a file and no device: its main, in this process
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_report.main([str(window), "--json"])
    check(rc == 0, "trace_report --json over (a)'s traced window")
    report_json = TOOLS_OUT / "trace_report.json"
    report_json.write_text(buf.getvalue())
    rep = first_json(buf.getvalue())
    log(f"   window: bubble {rep['bubble_fraction']}, dispatch share "
        f"{rep['dispatch']['share']}, step p50 {rep['steps']['p50_ms']} ms")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = trace_report.main([str(window), "--baseline",
                                str(report_json)])
    check(rc == 0, "trace_report --baseline against its own JSON: exit 0")
    out["profiler"] = dict(kernel_names=names, launches=profiled,
                           window=rep)

    # (e) MFU of the monolithic BERT-large train step at its defaults
    check(runs["bench_mfu"]["rc"] == 0, "bench_mfu ran")
    res = runs["bench_mfu"]["json"]
    log(f"   BERT-large step {res['step_time_ms']:.3f} ms, "
        f"{res['flops_per_step'] / 1e12:.4f} TFLOP counted (6 x params x "
        f"tokens {res['six_n_tokens'] / 1e12:.4f}), MFU {res['mfu']:.4f}; "
        f"trio fwd+bwd {res['unit_fwd_bwd_ms']:.3f} ms")
    out["mfu"] = res

    # (f) the launcher config's profiles and partitions, timed through B1
    check(runs["profile_allocation"]["rc"] == 0, "profile_allocation ran")
    res = json.loads((TOOLS_OUT / "profile_allocation.json").read_text())
    flash_prof = res["flash_launches"]
    check(flash_prof.get("tensor_core", 0) > 0
          and set(flash_prof) == {"tensor_core"},
          f"the timed profile's B1 launches by body: "
          f"{json.dumps(flash_prof)}")
    log(f"   partitions: {json.dumps(res['partitions'])}")
    out["profile_allocation"] = res

    # (g) the ladder's first two rungs at BERT-large's width, 10 layers
    ladder_json = TOOLS_OUT / "ladder.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "skycomputing_tpu_torch.tools.run_ladder",
         "--only", "even_4", "optimal_8", "--max-iters", "2", "--timeout",
         "300", "--log-root", str(ROOT / "build" / "ladder"), "--json",
         str(ladder_json)], cwd=ROOT, capture_output=True, text=True,
        timeout=700, env=dict(os.environ, PYTHONPATH=str(ROOT),
                              SKYTPU_FLASH="1"))
    (TOOLS_OUT / "run_ladder.log").write_text(
        proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    rc = proc.returncode
    log(f"   run_ladder: exit {rc} in {time.perf_counter() - t0:.1f} s")
    rungs = {r["config"]: r for r in
             json.loads(ladder_json.read_text())["rungs"]}
    ladder_b1 = 0
    for name, r in rungs.items():
        check(r["exit"] == 0 and len(r["losses"]) == 2
              and all(x is not None and np.isfinite(x) for x in r["losses"]),
              f"{name}: exit {r['exit']}, losses {r['losses']}")
        steps = r["flash_launches"]
        check(len(steps) == 2 and all(
            set(s) == {"tensor_core"} and s["tensor_core"] > 0
            for s in steps),
              f"{name}: B1 on the tensor-core body in every step "
              f"({json.dumps(steps)})")
        ladder_b1 += sum(s["tensor_core"] for s in steps)
        log(f"   {name}: step 2: forward {r['fwd_s'] * 1e3:.3f} ms, "
            f"backward {r['bwd_s'] * 1e3:.3f} ms, update "
            f"{r['step_s'] * 1e3:.3f} ms")
    check(rc == 0, "run_ladder: every rung exit 0")
    alloc = rungs["optimal_8"].get("allocation", [])
    check(len(alloc) == 8 and sum(alloc) == 33,
          f"optimal_8 covers every unit: {alloc}")
    out["ladder"] = rungs
    shutil.rmtree(ROOT / "build" / "ladder", ignore_errors=True)

    # (h) a reference checkpoint at BERT-large's width (2 layers, 9
    # units) converted, loaded, run on the card against the CPU, and
    # written back to the reference's layout bitwise
    work = ROOT / "build" / "tools_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        cfg = bert_config("large", dtype="float32",
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
        units = bert_layer_configs(cfg, num_encoder_units=2, num_classes=3,
                                   deterministic=True)
        state = reference_state_dict(torch, cfg, 2, 3, SEED)
        torch.save(state, work / "reference.pth")
        # a file conversion on the CPU: the command's main, here
        with contextlib.redirect_stdout(io.StringIO()):
            rc = convert_torch_checkpoint.main(
                ["--checkpoint", str(work / "reference.pth"), "--out",
                 str(work / "port.pt"), "--preset", "large",
                 "--layer-num", "2"])
        check(rc == 0, "convert_torch_checkpoint ran")
        ps = ParameterServer(units,
                             generator=torch.Generator().manual_seed(1))
        ps.load_weights_from_file(str(work / "port.pt"))
        ids, types, mask = (torch.from_numpy(x) for x in
                            bert_batch(np, cfg.vocab_size)[0])
        logits = {}
        for where in ("cuda", "cpu"):
            stack = build_layer_stack(units)
            for module, sd in zip(stack.layers, ps.params):
                module.load_state_dict(sd, strict=True)
            stack = stack.to(where).eval()
            with torch.no_grad():
                logits[where] = stack(ids.to(where), types.to(where),
                                      mask.to(where)).float().cpu()
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        check(bool(torch.isfinite(logits["cuda"]).all()) and err <= 1e-4,
              f"converted weights: card against CPU logits {err:.3e} "
              f"(<= 1e-4)")
        back = to_torch_state_dict(ps.params, units)
        check(set(back) == set(state) and all(
            torch.equal(back[key], state[key]) for key in state),
              f"round trip to the reference layout bitwise "
              f"({len(state)} tensors)")
        out["convert"] = dict(units=len(units), card_vs_cpu=err)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["b1_tensor_core"] = (profiled[B1].get("tensor_core", 0)
                             + flash_prof["tensor_core"] + ladder_b1)
    out["b2_decode"] = profiled[B2].get("decode", 0)
    return out


# --------------------------------------------------------------------------
# phase 32: the serving fleet and its observability
# --------------------------------------------------------------------------

#: phase 32's model: GPT-2 small's width and depth, float32, positions
#: enough for the bench's 59-token prompts and 27 new tokens
FLEET_MODEL = dict(vocab_size=50257, hidden_size=768,
                   num_hidden_layers=LAYERS, num_attention_heads=12,
                   max_position_embeddings=160, dropout_prob=0.0,
                   dtype="float32")
#: the bench's operating point over paged KV at page 16: 2 decode rows a
#: replica (the bench's 2 slots), 16 pages each
FLEET_ENGINE = dict(num_slots=2, max_concurrency=2, max_len=128,
                    buckets=(32, 64, 96), prefill_batch=1,
                    kv_layout="paged", page_size=16)


def _scrape(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as response:
        return response.read().decode()


def count_plain(gpt_mod):
    """(a patch of B2's plain version, as the GPT blocks call it, that
    counts its calls on the card; the count)."""
    calls = {"card": 0}
    plain = gpt_mod.paged_attention_reference

    def counted(q, *args, **kw):
        if q.device.type == "cuda":
            calls["card"] += 1
        return plain(q, *args, **kw)

    return mock.patch.object(gpt_mod, "paged_attention_reference",
                             counted), calls


def fleet_kill_and_spike(torch, np, kernels, gpt_mod, dev, model):
    """Phase 32 (a) and (b): ``bench_fleet``'s kill-and-spike scenario
    over three paged replicas on ``dev``, traced, with the flight
    recorder attached and the exporter scraped once mid-run.  Returns
    (a report, B2's launches by body in the fleet run)."""
    from skycomputing_tpu_torch import telemetry
    from skycomputing_tpu_torch.telemetry import incidents
    from skycomputing_tpu_torch.tools import bench_fleet

    on_card = dev.type == "cuda"
    scrape = {}

    def setup(fleet):
        fleet.attach_flight()
        scrape["exporter"] = fleet.start_exporter(host="127.0.0.1", port=0)

    def on_tick(fleet):
        # once, a few ticks after the kill: the heal's counters are in
        if "metrics" in scrape or fleet.stats.reforms < 1:
            return
        url = scrape["exporter"].url
        scrape["metrics"] = _scrape(f"{url}/metrics")
        scrape["metrics_json"] = json.loads(_scrape(f"{url}/metrics.json"))
        scrape["healthz"] = json.loads(_scrape(f"{url}/healthz"))
        scrape["stats"] = fleet.stats.snapshot()
        scrape["tick"] = fleet.tick

    # the plain version of B2 is counted wherever the fleet reaches it
    patch, plain_calls = count_plain(gpt_mod)
    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    zero_counts(kernels)
    tracer = telemetry.enable_tracing()
    try:
        with patch:
            t0 = time.perf_counter()
            report, fleet, accepted = bench_fleet.run_scenario(
                device=dev, seed=SEED, model=model, params=params,
                engine_kwargs=dict(FLEET_ENGINE), setup=setup,
                on_tick=on_tick)
            run_s = time.perf_counter() - t0
        bodies = dict(kernels[B2]["fn"].body_launches)
        launches = {name: k["fn"].launches for name, k in kernels.items()}
        events = tracer.to_chrome()["traceEvents"]
    finally:
        telemetry.disable_tracing()
        if scrape.get("exporter") is not None:
            scrape["exporter"].stop()
    for f in report["identity_findings"]:
        log(f"   identity finding: {json.dumps(f)}")
    stats = report["fleet_stats"]
    check(report["gates"]["token_identical"],
          f"all {len(accepted)} accepted requests token-identical to the "
          f"one-shot generate on {dev.type} (migrated ones included)")
    check(stats["failed"] == 0 and all(r.status == "finished"
                                       for r in accepted),
          f"failed {stats['failed']}, every accepted request finished")
    check(stats["reforms"] >= 1 and stats["migrations"] >= 1,
          f"the kill of replica 0 migrated {stats['migrations']} "
          f"request(s) and re-formed {stats['reforms']} time(s)")
    spike = report["spike"]
    check(spike["rejected"] == sum(spike["rejected_by_reason"].values())
          and stats["rejected"] == sum(stats["rejected_by_reason"].values())
          and report["gates"]["shedding_visible"] == (spike["rejected"] > 0),
          f"the spike's {spike['rejected']} rejections counted by reason "
          f"{spike['rejected_by_reason']}, each with a Retry-After")
    if on_card:
        check(bodies["decode"] > 0 and bodies["register_tile"] > 0
              and plain_calls["card"] == 0,
              f"B2 by body in the fleet run {json.dumps(bodies)}: decode "
              f"and register-tile launched, the plain version called "
              f"{plain_calls['card']} times on the card")
    # (b) observability on the same run
    outage = [b for b in fleet.bundles
              if b["incident"]["rule"] == "replica_outage"]
    chain = incidents.cause_chain(outage[0]["flight_log"]) if outage else []
    stages = incidents.chain_stages(chain)
    check(outage and chain and stages
          and outage[0]["digest"] == incidents.bundle_digest(outage[0]),
          f"the crash opened a replica-outage incident "
          f"({outage[0]['incident']['incident_id'] if outage else None}), "
          f"its bundle's cause chain {stages} ({len(chain)} links), "
          f"digest verified")
    body, snap = scrape.get("metrics", ""), scrape.get("stats", {})
    counters = [k for k, v in snap.items() if isinstance(v, int)]
    check(snap and all(f"skytpu_fleet_{k} {snap[k]}\n" in body
                       for k in counters)
          and scrape["metrics_json"]["snapshot"]["fleet"]["reforms"]
          == snap["reforms"]
          and set(scrape["healthz"]["replicas"]) == {
              "replica0", "replica1", "replica2"},
          f"/metrics, /metrics.json and /healthz scraped at tick "
          f"{scrape.get('tick')} on 127.0.0.1: {len(counters)} fleet "
          f"counters equal fleet.stats")
    reform_ms = [e["dur"] / 1e3 for e in events
                 if e.get("ph") == "X" and e.get("name") == "fleet.reform"]
    st = report["steady"]
    out = dict(
        run_s=run_s, wall_s=report["wall_s"],
        tokens_per_s=report["tokens_per_s"],
        generated_tokens=report["generated_tokens"],
        ttft_p95_pre_kill_s=st["ttft_p95_pre_kill_s"],
        ttft_p95_post_kill_s=st["ttft_p95_post_kill_s"],
        ttft_ratio=st["ttft_degradation"], tpot_p95_steady_s=st["tpot_p95_s"],
        tpot_p95_spike_s=spike["tpot_p95_s"],
        tpot_ratio=spike["tpot_vs_envelope"], reform_ms=reform_ms,
        sheds_by_reason=stats["rejected_by_reason"],
        spike=spike, fleet_stats=stats, gates=report["gates"],
        supervisor_events=[(e["kind"], e["replica"], e["tick"])
                           for e in report["supervisor_events"]],
        slo=report["slo"], b2_bodies=bodies, launches=launches,
        plain_calls_on_card=plain_calls["card"],
        incident=outage[0]["incident"], cause_chain=stages,
        scrape_tick=scrape["tick"], healthz=scrape["healthz"])
    log(f"   (a) {report['generated_tokens']} tokens in "
        f"{report['wall_s']:.2f} s ({report['tokens_per_s']:.1f} tok/s); "
        f"TTFT p95 {st['ttft_p95_pre_kill_s']} -> "
        f"{st['ttft_p95_post_kill_s']} s (ratio {st['ttft_degradation']}, "
        f"JAX's gate 2x), TPOT p95 {st['tpot_p95_s']} -> "
        f"{spike['tpot_p95_s']} s (ratio {spike['tpot_vs_envelope']}, "
        f"JAX's gate 1.25x); re-form {reform_ms} ms; sheds "
        f"{stats['rejected_by_reason']}; timing gates (reported) "
        f"{json.dumps(report['gates'])}")
    return out, bodies


def fleet_autoscale(torch, np, kernels, gpt_mod, dev, model):
    """Phase 32 (c): one replica at ``model``'s width (depth cut) under a
    TTFT target that burns: a verified ADD, then, the target relaxed and
    the load gone, a drain-then-REMOVE; every stream, the added
    replica's included, token-identical to the one-shot reference."""
    from skycomputing_tpu_torch.bench_serving import _identical, _one_shot
    from skycomputing_tpu_torch.fleet import (
        FleetAutoscaler,
        FleetSupervisor,
        ServingFleet,
    )
    from skycomputing_tpu_torch.serving import Request
    from skycomputing_tpu_torch.telemetry import SloMonitor, SloTarget
    from skycomputing_tpu_torch.workload.mixes import fleet_request_spec

    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    auto = FleetAutoscaler(min_replicas=1, max_replicas=2, up_streak=2,
                           down_streak=4, cooldown_ticks=3,
                           slack_utilization=0.3)
    fleet = ServingFleet(
        layer_cfgs, params, replicas=1, engine_kwargs=dict(FLEET_ENGINE),
        supervisor=FleetSupervisor(check_every=1, heartbeat_misses=1,
                                   sick_threshold=float("inf")),
        autoscaler=auto, devices=[dev] * 2)
    # any first token slower than a microsecond burns it
    fleet.attach_slo(SloMonitor([SloTarget(
        name="ttft_p95", metric="fleet.ttft_p95_s", threshold=1e-6,
        budget=0.25, fast_window=1, slow_window=2)]))
    rng = np.random.default_rng(SEED + 32)
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in
            (fleet_request_spec(rng) for _ in range(12))]
    placed = []
    zero_counts(kernels)
    t0 = time.perf_counter()
    for r in reqs[:4]:
        placed.append(fleet.submit(r).replica)
    while fleet.stats.scale_ups < 1 and fleet.tick < 64:
        fleet.step()
    up_tick = fleet.tick
    # the burn is over: the target's threshold back to a bound no first
    # token reaches, so slack can build once the load drains
    fleet.slo.targets[0].threshold = float("inf")
    for r in reqs[4:]:
        placed.append(fleet.submit(r).replica)
    while fleet.has_work():
        fleet.step()
    for _ in range(16):
        if fleet.stats.scale_downs:
            break
        fleet.step()
    wall_s = time.perf_counter() - t0
    bodies = dict(kernels[B2]["fn"].body_launches)
    kinds = [(e["kind"], e["tick"], e.get("replica")) for e in auto.events]
    accepted = [r for r, name in zip(reqs, placed) if name is not None]
    check(fleet.stats.scale_ups >= 1 and fleet.stats.scale_downs == 1
          and [k for k, _, _ in kinds][:2] == ["scale_up", "scale_down"]
          and len(fleet.replicas) == 1,
          f"(c) a verified ADD at tick {up_tick} under the burning TTFT "
          f"target, then a drain-then-REMOVE: {kinds}")
    added = kinds[0][2]
    served = [r for r, name in zip(reqs, placed) if name == added]
    findings = []
    finished = all(r.status == "finished" for r in accepted)
    identical = finished and _identical(
        {r.request_id: r.output() for r in accepted}, accepted,
        _one_shot(layer_cfgs, params, dev,
                  model["max_position_embeddings"]), findings)
    for f in findings:
        log(f"   identity finding: {json.dumps(f)}")
    check(identical and served and fleet.stats.failed == 0,
          f"(c) all {len(accepted)} accepted streams token-identical "
          f"({len(reqs) - len(accepted)} shed, by reason "
          f"{fleet.stats.rejected_by_reason}), {len(served)} of them "
          f"routed to the added {added}")
    return dict(events=kinds, served_by_added=len(served), wall_s=wall_s,
                fleet_stats=fleet.stats.snapshot(), b2_bodies=bodies)


def fleet_path(torch, np, kernels, gpt_mod, dev, preset="gpt2"):
    """Phase 32.  ``preset="tiny"`` rehearses it on the CPU (hidden 64,
    2 blocks).  Returns (a report, B2's launches by body in (a))."""
    model = dict(FLEET_MODEL)
    if preset == "tiny":
        model.update(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=2)
    report, bodies = fleet_kill_and_spike(torch, np, kernels, gpt_mod,
                                          dev, model)
    report["autoscale"] = fleet_autoscale(
        torch, np, kernels, gpt_mod, dev,
        dict(model, num_hidden_layers=2))
    return report, bodies


# --------------------------------------------------------------------------
# phase 33: disaggregated serving, the chaos plane and the workload player
# --------------------------------------------------------------------------

def _bodies_by_role(fn, fleet, mode, sink, state):
    """Wrap each replica engine's ``step`` so B2's launches by body add up
    under the replica's role (``mode`` for a role-less fleet), with
    ``state["role"]`` that role while the step runs."""
    for replica in fleet.replicas:
        engine = replica.engine
        role = replica.role or mode
        step = engine.step

        def counted(_step=step, _role=role):
            before = dict(fn.body_launches)
            state["role"] = _role
            try:
                return _step()
            finally:
                state["role"] = None
                got = sink.setdefault(_role, {})
                for body, n in fn.body_launches.items():
                    got[body] = got.get(body, 0) + n - before.get(body, 0)

        engine.step = counted


def record_geometry(gpt_mod, state):
    """A patch of B2's wrapper, as the GPT blocks call it, that adds each
    call's (R, Lq, page size, pool pages, table width) to
    ``state["seen"]`` under ``state["role"]`` and counts the calls at it
    in ``state["calls"]`` by (role, geometry) (calls outside a wrapped
    step are not recorded)."""
    wrapper = gpt_mod.paged_attention
    calls = state.setdefault("calls", {})

    def recorded(q, k, v, table, index, **kw):
        if state["role"] is not None:
            geometry = (q.shape[0], q.shape[1], k.shape[1], k.shape[0],
                        table.shape[1])
            state["seen"].setdefault(state["role"], set()).add(geometry)
            key = (state["role"], geometry)
            calls[key] = calls.get(key, 0) + 1
        return wrapper(q, k, v, table, index, **kw)

    return mock.patch.object(gpt_mod, "paged_attention", recorded)


def disagg_against_monolith(torch, np, kernels, gpt_mod, dev, model):
    """Phase 33 (a): ``bench_disagg``'s two topologies, one replay each
    after its warm-up, every replica on ``dev``.  Returns (a report,
    B2's launches by body in the run)."""
    from skycomputing_tpu_torch.tools import bench_disagg

    on_card = dev.type == "cuda"
    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    by_role = {}
    state = dict(role=None, seen={})
    fn = kernels[B2]["fn"]
    patch, plain_calls = count_plain(gpt_mod)
    zero_counts(kernels)
    with patch, record_geometry(gpt_mod, state):
        t0 = time.perf_counter()
        report, replays = bench_disagg.run_bench(
            device=dev, seed=SEED, model=model, params=params, replays=1,
            throwaway=False,
            setup=lambda fleet, mode: _bodies_by_role(fn, fleet, mode,
                                                      by_role, state))
        run_s = time.perf_counter() - t0
    bodies = dict(fn.body_launches)
    gates = report["gates"]
    for f in report["identity_findings"]:
        log(f"   identity finding: {json.dumps(f)}")
    mono, dis = report["runs"]["monolithic"], report["runs"]["disagg"]
    dis_fleet, dis_rep = replays["disagg"][0]
    finished = len(dis_rep.finished)
    check(gates["zero_lost_tokens"],
          f"(a) every admitted request finished in both topologies "
          f"({finished} of {len(dis_rep.verdicts)} arrivals)")
    check(gates["token_identical"],
          f"(a) every stream token-identical to the one-shot generate on "
          f"{dev.type}, the disagg streams equal to the monolith's request "
          f"for request")
    ledger, counters = dis["ledger"], dis["handoff_counters"]
    check(gates["every_request_handed_off"]
          and counters["handoffs_out"] == counters["handoffs_in"]
          == finished,
          f"(a) each of the {finished} finished disagg requests crossed the "
          f"handoff plane once: {json.dumps(counters)}")
    check(gates["ledger_conserved"],
          f"(a) the ledger conserved, nothing stranded: {json.dumps(ledger)}")
    check(gates["workload_replayable"],
          f"(a) both topologies replayed trace {report['digest'][:16]}")
    rep = dis["replays"][0]
    check(counters["handoff_bytes"] == rep["exported_record_bytes"] > 0
          and rep["exported_records"] == counters["handoffs_out"],
          f"(a) handoff_bytes {counters['handoff_bytes']} == the "
          f"{rep['exported_records']} exported records' host bytes")
    if on_card:
        pre, dec = by_role.get("prefill", {}), by_role.get("decode", {})
        check(pre.get("register_tile", 0) > 0 and dec.get("decode", 0) > 0
              and plain_calls["card"] == 0,
              f"(a) B2 by role {json.dumps(by_role)}: register-tile on the "
              f"prefill replicas, decode on the decode replica, the plain "
              f"version called {plain_calls['card']} times on the card")
    seen = {role: sorted(shapes) for role, shapes in state["seen"].items()}
    for name, R, Lq, (ps, pool, width), roles in disagg_cases():
        check(all((R, Lq, ps, pool, width) in seen.get(role, ())
                  for role in roles),
              f"(a) phase 3's {name} row (R={R}, Lq={Lq}, pages of {ps}, "
              f"a {pool}-page pool, tables of {width}) is a call the "
              f"{'/'.join(roles)} replicas made; B2's calls by role as "
              f"(R, Lq, page size, pool pages, table width): "
              f"{json.dumps(seen)}")
    out = dict(run_s=run_s, report=report, bodies=bodies, by_role=by_role,
               plain_calls_on_card=plain_calls["card"], geometry=seen)
    for mode, doc in (("monolithic", mono), ("disagg", dis)):
        r = doc["replays"][0]
        log(f"   (a) {mode}: TTFT p95 {doc['ttft_p95_s_floor']:.4f} s, TPOT "
            f"p95 {doc['tpot_p95_s_floor']:.4f} s, {r['tokens_per_s']:.1f} "
            f"tok/s ({r['generated_tokens']} tokens in {r['wall_s']:.2f} s)")
    log(f"   (a) JAX's verdicts (printed, not held): ttft_p95_improved="
        f"{gates['ttft_p95_improved']}, tpot_p95_improved="
        f"{gates['tpot_p95_improved']}; {counters['handoffs_out']} "
        f"handoffs, {counters['handoff_bytes']} bytes, export "
        f"{rep['export_s_per_record'] * 1e3:.3f} ms and import "
        f"{rep['import_s_per_record'] * 1e3:.3f} ms a record; B2 by body "
        f"{json.dumps(bodies)}")
    return out, bodies


def chaos_campaign(torch, np, gpt_mod, dev, model, name):
    """Phase 33 (b) and (c): one catalog plan through ``bench_chaos``'s
    harness (a fault-free reference, the faulted run, the same seed
    again) on ``dev``, under ``bench_disagg``'s supervisor (latency
    parked, so the plan's faults are the only heals)."""
    from skycomputing_tpu_torch.tools import bench_chaos, bench_disagg

    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    t0 = time.perf_counter()
    report, runs = bench_chaos.run_bench(
        [name], device=dev, seed=SEED, model=model, params=params,
        supervisor_kwargs=dict(bench_disagg.SUPERVISOR))
    wall_s = time.perf_counter() - t0
    doc = report["plans"][name]
    fleet, _, inj, audit = runs[name]["faulted"]
    applied = [e for e in inj.event_log() if e["ok"]]
    check(applied and doc["gates"]["faults_applied"],
          f"{name}: {len(applied)} of {len(inj.event_log())} faults applied "
          f"with ok: {[(e['tick'], e['kind']) for e in applied]}")
    check(audit.ok, f"{name}: the audit against the fault-free reference "
          f"on {dev.type} passes every check: "
          + "; ".join(f"{c.name}: {c.detail}" for c in audit.checks))
    check(doc["gates"]["workload_replayable"]
          and doc["gates"]["event_log_deterministic"],
          f"{name}: both faulted runs' deterministic logs and audit digests "
          f"equal ({doc['audit_digest'][:16]}), one trace")
    return dict(wall_s=wall_s, doc=doc, fleet=fleet, injector=inj)


def scenarios_autoscaled(torch, np, gpt_mod, dev, model):
    """Phase 33 (d): ``bench_scenarios``'s ``diurnal_ramp``, autoscaled
    against fixed, on ``dev``, under ``bench_disagg``'s supervisor."""
    from skycomputing_tpu_torch.tools import bench_disagg, bench_scenarios

    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    t0 = time.perf_counter()
    report, measured = bench_scenarios.run_bench(
        "diurnal_ramp", device=dev, seed=SEED, model=model, params=params,
        supervisor_kwargs=dict(bench_disagg.SUPERVISOR))
    wall_s = time.perf_counter() - t0
    auto_fleet, _, auto, _ = measured["autoscaled"]
    runs, gates = report["runs"], report["gates"]
    for f in report["identity_findings"]:
        log(f"   identity finding: {json.dumps(f)}")
    events = [(e["kind"], e["tick"]) for e in auto.events]
    check(auto_fleet.stats.scale_ups >= 1
          and runs["autoscaled"]["final_replicas"] == auto.min_replicas,
          f"(d) scale events {events}: at least one ADD, the run ending at "
          f"min_replicas={auto.min_replicas}")
    check(gates["token_identical"] and gates["zero_lost_tokens"],
          f"(d) every admitted stream in both runs token-identical to the "
          f"one-shot generate on {dev.type}")
    check(gates["workload_replayable"],
          f"(d) both runs replayed trace {report['digest'][:16]}")
    log(f"   (d) SLO burn per request served: autoscaled "
        f"{runs['autoscaled']['burn_per_served']} "
        f"({runs['autoscaled']['burn_ticks']} ticks / "
        f"{runs['autoscaled']['summary']['total']['finished']}), fixed "
        f"{runs['fixed']['burn_per_served']} ({runs['fixed']['burn_ticks']}"
        f" / {runs['fixed']['summary']['total']['finished']}); gates "
        f"(reported) {json.dumps(gates)}")
    return dict(wall_s=wall_s, report=report, events=events)


def disagg_chaos_path(torch, np, kernels, gpt_mod, dev, preset="gpt2"):
    """Phase 33.  ``preset="tiny"`` rehearses it on the CPU (hidden 64).
    Returns (a report, B2's launches by role and body in (a)'s measured
    replays)."""
    model = dict(FLEET_MODEL)
    if preset == "tiny":
        model.update(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=2)
    small = dict(model, num_hidden_layers=2)
    t0 = time.perf_counter()
    a, bodies = disagg_against_monolith(torch, np, kernels, gpt_mod, dev,
                                        model)
    b = chaos_campaign(torch, np, gpt_mod, dev, small,
                       "prefill_kill_mid_handoff")
    failures = sum(r.engine.stats.handoff_failures
                   for r in b["fleet"].replicas if r.engine is not None)
    reasons = b["fleet"].ledger.audit()["failed_reasons"]
    recomputed = reasons.get(
        "checksum mismatch at import; recomputing from prompt", 0)
    check(failures >= 1 and recomputed >= 1,
          f"(b) {failures} poisoned record(s) refused at import, "
          f"{recomputed} recomputed from the prompt: ledger reasons "
          f"{json.dumps(reasons)}")
    c = chaos_campaign(torch, np, gpt_mod, dev, small, "swap_corruption")
    corruptions = sum(r.engine.stats.swap_corruptions
                      for r in c["fleet"].replicas if r.engine is not None)
    check(corruptions >= 1 and c["fleet"].stats.failed == 0,
          f"(c) {corruptions} corrupt swap record(s) caught at swap-in, "
          f"each victim recomputed, none failed")
    d = scenarios_autoscaled(torch, np, gpt_mod, dev, small)
    seconds = time.perf_counter() - t0
    log(f"   phase 33: (a) {a['run_s']:.1f} s, (b) {b['wall_s']:.1f} s, "
        f"(c) {c['wall_s']:.1f} s, (d) {d['wall_s']:.1f} s; "
        f"{seconds:.1f} s in all")
    report = dict(
        seconds=seconds,
        a=dict(run_s=a["run_s"], gates=a["report"]["gates"],
               runs=a["report"]["runs"], digest=a["report"]["digest"],
               b2_bodies=a["bodies"], b2_by_role=a["by_role"],
               b2_geometry=a["geometry"],
               plain_calls_on_card=a["plain_calls_on_card"]),
        b=dict(b["doc"], wall_s=b["wall_s"], handoff_failures=failures,
               recomputed=recomputed),
        c=dict(c["doc"], wall_s=c["wall_s"], swap_corruptions=corruptions),
        d=dict(wall_s=d["wall_s"], events=d["events"],
               gates=d["report"]["gates"], runs=d["report"]["runs"]))
    return report, a["by_role"]


# --------------------------------------------------------------------------
# phase 34: the closed tuning loop, the flight bench, the request waterfall
# --------------------------------------------------------------------------

#: (a): BERT-large's width (bf16, flash on) cut to this many encoder units
#: over 3 workers on the card, worker 0 emulated 3x slower; 16 rows of 128
#: in 2 microbatches, so B1 runs at phase 3's 8 rows of 128
AUTOTUNE_UNITS, AUTOTUNE_WORKERS, AUTOTUNE_SLOWDOWN = 8, 3, 3.0
AUTOTUNE_BATCH, AUTOTUNE_MICRO = 16, 2
#: 6 warm-up steps, a window read at step 12 (the proposal applied), the
#: next judged at 18 (committed or rolled back), 2 steps on the result
AUTOTUNE_ITERS, AUTOTUNE_EVERY = 20, 6
#: (b): GPT-2 small served over paged KV with a skewed bucket set (the
#: reference's tests/test_tuning.py:656 skew: most prompts far below the
#: big bucket); every table 8 pages wide (the big bucket's 7, rounded up
#: to a power of two), decode waves of 8 rows over a 32-page pool
TUNE_ENGINE = dict(num_slots=4, max_concurrency=8, max_len=128,
                   buckets=(16, 112), prefill_batch=1, kv_layout="paged",
                   page_size=16)
TUNE_REQUESTS, TUNE_ARRIVALS, TUNE_EVERY = 40, 4, 8
#: the buckets the tuner adds under (b)'s workload: its two skewed-bucket
#: proposals (the big bucket's prompts average 31, then 41 tokens), which
#: count prompts, not time, so every run makes them
TUNE_ADDED_BUCKETS = (32, 48)
#: (c): bench_flight's overhead repeats here (the reference's: 4; more
#: here, for each mode's least wall, as the time limit allows)
FLIGHT_REPEATS = 8


def autotune_cases():
    """B2's calls in phase 34 (b): (case, R, Lq, (page size, pool pages,
    table width), the body that serves it, seed).  A decode wave spans
    ``max_concurrency`` rows; a prefill wave is ``prefill_batch`` rows at
    one of the buckets, the engine's and those the tuner adds, on the
    decode body up to 16 queries and the register-tile body past that
    (float32, head_dim 64); the tables' floor is the big bucket's pages,
    so every call is 8 pages wide.  :func:`autotune_serving` fails
    unless every call's geometry is one of these and each of these is
    called."""
    e = TUNE_ENGINE
    ps = e["page_size"]
    width = e["max_len"] // ps
    pool = e["num_slots"] * width
    buckets = sorted(set(e["buckets"]) | set(TUNE_ADDED_BUCKETS))
    # the first two keep their earlier seeds
    seeds = {1: 210, max(buckets): 211}
    return (("autotune_decode", e["max_concurrency"], 1, (ps, pool, width),
             "decode", seeds[1]),) + tuple(
        (f"autotune_prefill_{b}", e["prefill_batch"], b, (ps, pool, width),
         "decode" if b <= 16 else "register_tile", seeds.get(b, 212 + i))
        for i, b in enumerate(buckets))


def autotune_trainer(torch, np, kernels, dev, preset="large",
                     units=AUTOTUNE_UNITS):
    """Phase 34 (a): ``Runner.train`` with ``AutotuneHook`` (and the
    hook's own tracer) on a BERT pipeline of 3 workers on ``dev``, worker
    0 at ``slowdown`` 3 — the profiles the allocator starts from are
    homogeneous, so only the trace can see the straggler.  Returns a
    report."""
    from skycomputing_tpu_torch import telemetry
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd
    from skycomputing_tpu_torch.runner import AutotuneHook, Hook, Runner

    on_card = dev.type == "cuda"
    cfg, model_cfg = bert_units(preset, units)
    if on_card:
        check(cfg.hidden_size == 1024 and cfg.num_attention_heads == 16
              and cfg.dtype == "bfloat16" and cfg.use_flash_attention,
              f"(a) BERT-large's width: hidden {cfg.hidden_size}, "
              f"{cfg.num_attention_heads} heads, {cfg.dtype}, flash on, "
              f"{len(model_cfg)} units ({units} encoder units)")
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=0),
             extra_config=dict(slowdown=AUTOTUNE_SLOWDOWN if i == 0
                               else 1.0))
        for i in range(AUTOTUNE_WORKERS)])

    class _Dev:
        def benchmark(self):
            return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e12)
                    for w in wm.worker_pool}

    class _Mod:
        def benchmark(self):
            return [1.0] * len(model_cfg), [0.1] * len(model_cfg)

    allocator = Allocator(model_cfg, wm, _Mod(), _Dev())
    allocator.even_allocate()
    rng = np.random.default_rng(SEED + 34)
    ids = rng.integers(5, cfg.vocab_size,
                       size=(AUTOTUNE_BATCH, BERT_SEQ)).astype(np.int64)
    data = (ids, np.zeros_like(ids), np.ones_like(ids))
    labels = rng.integers(0, 3, size=(AUTOTUNE_BATCH,)).astype(np.int64)
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(SEED))
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=[dev], num_microbatches=AUTOTUNE_MICRO)
    before = model.partition_signature()
    fn = kernels[B1]["fn"]

    class Record(Hook):
        def __init__(self):
            self.steps = []

        def before_train_iter(self, runner):
            self._launches = fn.launches
            self._bodies = dict(fn.body_launches)

        def after_train_iter(self, runner):
            self.steps.append(dict(
                loss=runner.model.stats.loss,
                partition=runner.model.partition_signature(),
                b1=fn.launches - self._launches,
                b1_bodies={b: n - self._bodies.get(b, 0)
                           for b, n in fn.body_launches.items()}))

    hook = AutotuneHook(allocator=allocator, tune_every=AUTOTUNE_EVERY,
                        solver_time_s=2.0)
    record = Record()
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=AUTOTUNE_ITERS)
    runner.register_hook(hook)
    runner.register_hook(record)
    telemetry.disable_tracing()  # the hook enables and owns its tracer
    zero_counts(kernels)
    t0 = time.perf_counter()
    runner.train([(data, labels)] * AUTOTUNE_ITERS)
    _sync(torch, dev)
    wall_s = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    bodies = dict(fn.body_launches)
    events = hook.events
    for e in events:
        log(f"   (a) autotune event: {json.dumps(e, default=str)}")
    applied = [i for i, e in enumerate(events) if e["outcome"] == "applied"]
    check(applied and events[applied[0]]["proposal"]["knob"] == "allocation"
          and events[applied[0]]["proposal"]["signature"] == "straggler",
          f"(a) the trace's straggler signature became an allocation "
          f"proposal, verified and applied: "
          f"{[e['outcome'] for e in events]}")
    settled = events[applied[0] + 1]["outcome"] \
        if applied[0] + 1 < len(events) else None
    check(settled in ("committed", "rolled_back"),
          f"(a) the applied proposal settled on the next window: "
          f"{settled}")
    first, nxt = events[applied[0]], events[applied[0] + 1]
    pre_ms, post_ms = first["base_ms"], nxt["new_ms"]
    parts = [s["partition"] for s in record.steps]
    losses = [s["loss"] for s in record.steps]
    check(all(np.isfinite(x) for x in losses) and len(losses)
          == AUTOTUNE_ITERS,
          f"(a) {len(losses)} finite losses, the world re-allocated at "
          f"iteration {first['iter']} training to the end")
    if settled == "committed":
        check(parts[nxt["iter"] - 1] != before,
              f"(a) the committed world keeps its new partition "
              f"{parts[nxt['iter'] - 1]} (from {before})")
    # every rebuild (an applied or rolled-back allocation) re-armed the
    # Runner's pre-flight, verified before the next step
    rebuilds = [e for e in events
                if e["outcome"] in ("applied", "rolled_back")
                and e.get("proposal", {}).get("knob") == "allocation"
                and e["iter"] < AUTOTUNE_ITERS]
    reports = runner.preflight_reports
    check(len(reports) == 1 + len(rebuilds)
          and all(r.ok for r in reports),
          f"(a) {len(reports)} pre-flight reports, all ok: the first plan "
          f"and each of the {len(rebuilds)} rebuilt ones before its first "
          f"step")
    per_step = 2 * units * AUTOTUNE_MICRO
    b1_steps = [s["b1"] for s in record.steps]
    if on_card:
        check(b1_steps == [per_step] * AUTOTUNE_ITERS
              and bodies["tensor_core"] == launches[B1]
              == per_step * AUTOTUNE_ITERS,
              f"(a) B1 {per_step} launches a step ({units} layers x "
              f"{AUTOTUNE_MICRO} microbatches x forward and remat), all "
              f"on the tensor-core body: {json.dumps(bodies)}")
    out = dict(wall_s=wall_s, partition_before=before,
               partition_after=parts[-1], partitions=parts,
               events=[{k: v for k, v in e.items()} for e in events],
               settled=settled, pre_tune_ms=pre_ms, post_tune_ms=post_ms,
               losses=losses, b1_per_step=b1_steps, b1_bodies=bodies,
               launches=launches, tunes=hook.tunes,
               preflight=[r.ok for r in reports])
    log(f"   (a) partition {before} -> {parts[-1]}; step p50 pre-tune "
        f"{pre_ms:.2f} ms, post-tune {post_ms:.2f} ms ({settled}); B1 "
        f"{b1_steps[0]} launches a step by body "
        f"{json.dumps(record.steps[0]['b1_bodies'])}; {wall_s:.1f} s")
    return out


def _tune_requests(np, Request, vocab):
    """(b)'s workload: 40 requests, three in five with 20-48-token prompts
    (the big bucket's, padded to 112), the rest 4-12 tokens; 10-16 new
    tokens each."""
    rng = np.random.default_rng(SEED + 341)
    out = []
    for i in range(TUNE_REQUESTS):
        n = int(rng.integers(20, 49) if i % 5 < 3 else rng.integers(4, 13))
        out.append(Request(
            prompt=rng.integers(1, vocab, (n,)).astype(np.int32),
            max_new_tokens=int(rng.integers(10, 17))))
    return out


def autotune_serving(torch, np, kernels, gpt_mod, dev, model, trace_path):
    """Phase 34 (b): ``ServingAutotuner`` attached to a traced paged
    engine at ``model``'s size on ``dev``; requests arrive 4 a step.
    Returns a report."""
    from skycomputing_tpu_torch import telemetry
    from skycomputing_tpu_torch.bench_serving import _identical, _one_shot
    from skycomputing_tpu_torch.serving import Request, ServingEngine
    from skycomputing_tpu_torch.tuning import ServingAutotuner

    on_card = dev.type == "cuda"
    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    engine = ServingEngine(layer_cfgs, params, device=dev, **TUNE_ENGINE)
    tuner = ServingAutotuner(engine, tune_every=TUNE_EVERY, max_tunes=2,
                             min_improvement=0.05)
    reqs = _tune_requests(np, Request, model["vocab_size"])
    state = dict(role="serving", seen={})
    fn = kernels[B2]["fn"]
    patch, plain_calls = count_plain(gpt_mod)
    zero_counts(kernels)
    tracer = telemetry.enable_tracing()
    try:
        with patch, record_geometry(gpt_mod, state):
            pending = list(reqs)
            t0 = time.perf_counter()
            while pending or engine.has_work():
                for _ in range(TUNE_ARRIVALS):
                    if pending:
                        engine.submit(pending.pop(0))
                engine.step()
            _sync(torch, dev)
            run_s = time.perf_counter() - t0
        trace = tracer.to_chrome()
    finally:
        telemetry.disable_tracing()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    trace_path.write_text(json.dumps(trace))
    bodies = dict(fn.body_launches)
    events = tuner.events
    for e in events:
        log(f"   (b) autotune event: {json.dumps(e, default=str)}")
    applied = [i for i, e in enumerate(events) if e["outcome"] == "applied"]
    check(applied, f"(b) a proposal applied through reconfigure: "
          f"{[e['outcome'] for e in events]}")
    first = events[applied[0]]
    settled = next((e["outcome"] for e in events[applied[0] + 1:]
                    if e["outcome"] in ("committed", "rolled_back",
                                        "rollback_infeasible")), None)
    check(settled is not None,
          f"(b) the {first['proposal']['signature']} proposal "
          f"({first['proposal']['knob']} -> {first['proposal']['value']}) "
          f"settled: {settled}")
    finished = all(r.status == "finished" for r in reqs)
    findings = []
    identical = finished and _identical(
        {r.request_id: r.output() for r in reqs}, reqs,
        _one_shot(layer_cfgs, params, dev, model["max_position_embeddings"]),
        findings)
    for f in findings:
        log(f"   (b) identity finding: {json.dumps(f)}")
    check(identical, f"(b) all {len(reqs)} streams token-identical to the "
          f"one-shot generate on {dev.type} across the reconfigure")
    names = {ev["name"] for ev in trace["traceEvents"]
             if ev.get("ph") in ("X", "i")}
    check({"autotune.analyze", "autotune.apply", "reconfigure"} <= names,
          "(b) the loop's analyze and apply spans and the engine's "
          "reconfigure instant on the timeline")
    seen = sorted(state["seen"].get("serving", ()))
    calls = {g: n for (role, g), n in state["calls"].items()
             if role == "serving"}
    rows = {(R, Lq) + geometry: (name, body)
            for name, R, Lq, geometry, body, _ in autotune_cases()}
    check(set(seen) <= set(rows),
          f"(b) every B2 call's geometry is one phase 3 held against the "
          f"plain version: calls as (R, Lq, page size, pool pages, table "
          f"width) {json.dumps(seen)}, not held "
          f"{json.dumps(sorted(set(seen) - set(rows)))}")
    check(set(rows) <= set(seen),
          f"(b) each of phase 3's rows for this phase ("
          f"{', '.join(n for n, _ in rows.values())}) is a call the engine "
          f"made: {json.dumps(sorted(set(rows) - set(seen)))} missing")
    launches = {name: calls.get(g, 0) for g, (name, _) in rows.items()}
    log(f"   (b) B2 calls by geometry: {json.dumps(launches)}")
    if on_card:
        by_body = {}
        for g, (_, body) in rows.items():
            by_body[body] = by_body.get(body, 0) + calls.get(g, 0)
        check(bodies["decode"] == by_body["decode"]
              and bodies["register_tile"] == by_body["register_tile"]
              and bodies["query_tile"] == 0 and bodies["tensor_core"] == 0
              and plain_calls["card"] == 0,
              f"(b) B2 by body {json.dumps(bodies)}: decode and "
              f"register-tile, each the sum of its geometries' calls "
              f"{json.dumps(by_body)}, the plain version called "
              f"{plain_calls['card']} times on the card")
    snap = engine.stats.snapshot()
    out = dict(run_s=run_s, events=events, settled=settled,
               signature=first["proposal"]["signature"],
               proposal=first["proposal"],
               buckets_after=list(engine.bucketer.buckets),
               prefill_chunk_after=engine.prefill_chunk,
               b2_bodies=bodies, plain_calls_on_card=plain_calls["card"],
               geometry=seen, launches_by_case=launches,
               trace=str(trace_path),
               ttft_p95_s=snap.get("ttft_p95_s"),
               tpot_p50_s=snap.get("tpot_p50_s"),
               tpot_p95_s=snap.get("tpot_p95_s"),
               prefill_waves=snap["prefill_waves"],
               decode_ticks=snap["decode_ticks"],
               request_ids=[r.request_id for r in reqs])
    tail = (snap["tpot_p95_s"] / snap["tpot_p50_s"]
            if snap.get("tpot_p50_s") else None)
    out["tpot_tail_ratio"] = tail
    log(f"   (b) {first['proposal']['signature']} -> "
        f"{first['proposal']['knob']} {first['proposal']['value']} "
        f"({first['proposal']['reason']}), {settled}; buckets now "
        f"{out['buckets_after']}, prefill_chunk {out['prefill_chunk_after']}"
        f"; TPOT p95/p50 over the run {tail} (the decode-tail signature "
        f"reads it per window, against 3); B2 by body {json.dumps(bodies)}"
        f"; {run_s:.2f} s")
    return out


def flight_gates(torch, np, gpt_mod, dev, model):
    """Phase 34 (c): ``bench_flight``'s four gates over the port's fleet,
    disagg, chaos and flight planes at ``model``'s size on ``dev``: the
    campaigns' detection, silence and determinism held, the overhead
    gate's verdict printed."""
    from skycomputing_tpu_torch.tools import bench_flight

    layer_cfgs = gpt_mod.gpt_layer_configs(gpt_mod.GptConfig(**model),
                                           deterministic=True)
    params = random_weights(gpt_mod, layer_cfgs,
                            ("fleet", model["num_hidden_layers"]), SEED)
    log(f"   (c) overhead repeats {FLIGHT_REPEATS} (the reference's "
        f"{bench_flight.OVERHEAD_REPEATS}), ticks_scale "
        f"{bench_flight.OVERHEAD_TICKS_SCALE} (the reference's), "
        f"{model['num_hidden_layers']} blocks at hidden "
        f"{model['hidden_size']} (the reference: 2 blocks at hidden 64)")
    t0 = time.perf_counter()
    report = bench_flight.run_bench(device=dev, seed=SEED, model=model,
                                    params=params,
                                    overhead_repeats=FLIGHT_REPEATS)
    wall_s = time.perf_counter() - t0
    over = report["overhead"]
    gates = report["gates"]
    spread = max(over["thread_cpu_s_off"]) / min(over["thread_cpu_s_off"])
    # the overhead gate reads each mode's least wall over replays in
    # turns; on the card's shared host one replay's own CPU time varies
    # by a quarter from the next, more than the 2% it judges, so its
    # verdict is printed beside the recorder's share and not held
    log(f"   (c) overhead gate (the reference's reading, printed, not "
        f"held): {over['overhead_frac'] * 100:+.3f}% -> "
        f"{'PASS' if gates['recorder_overhead'] else 'FAIL'} (least walls "
        f"over {over['repeats']} repeats: on {over['min_wall_s_on']:.4f} s, "
        f"off {over['min_wall_s_off']:.4f} s); the repeats' pairs' median "
        f"{over['pair_median_overhead_frac'] * 100:+.3f}%; the recorder's "
        f"tap and detector pass {over['recorder_share_median'] * 100:.3f}% "
        f"of an attached replay (median); detached replays' thread CPU "
        f"time max/min {spread:.3f}; {wall_s:.1f} s")
    failed = [g for g, ok in gates.items()
              if not ok and g != "recorder_overhead"]
    check(not failed, f"(c) bench_flight's campaign gates all hold on "
          f"{dev.type}: detection, silence, determinism in "
          f"{', '.join(bench_flight.CAMPAIGNS)} "
          f"({json.dumps({g: ok for g, ok in gates.items() if '.' in g})})")
    return dict(report, wall_s=wall_s)


def request_waterfall(trace_path, request_ids):
    """Phase 34 (d): ``trace_report --request`` on (b)'s trace, for the
    request whose story spans the autotuner's reconfigure (else the
    first).  Returns a report."""
    from skycomputing_tpu_torch.telemetry import analysis
    from skycomputing_tpu_torch.tools import trace_report

    events = analysis.load_events(str(trace_path))
    marks = [float(ev["ts"]) / 1e3 for ev in events
             if ev.get("ph") == "i" and ev.get("name") == "reconfigure"]
    rid = request_ids[0]
    for r in request_ids:
        t = analysis.request_timeline(events, r)
        if marks and t["start_ms"] < marks[0] < t["end_ms"]:
            rid = r
            break
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_report.main([str(trace_path), "--request", str(rid)])
    text = buf.getvalue()
    timeline = analysis.request_timeline(events, rid)
    names = {s["name"] for s in timeline["segments"]}
    for line in text.splitlines():
        log(f"   (d) {line}")
    check(rc == 0 and timeline["complete"]
          and {"queue_wait", "prefill", "decode"} <= names
          and timeline["orphan_spans"] == 0,
          f"(d) trace_report --request {rid} exits {rc}: the waterfall of "
          f"{len(timeline['segments'])} segments ({sorted(names)}), "
          f"complete ({timeline['terminal']}), no orphan span")
    return dict(request=rid, rc=rc, segments=len(timeline["segments"]),
                terminal=timeline["terminal"], replicas=timeline["replicas"],
                spans_reconfigure=bool(
                    marks and timeline["start_ms"] < marks[0]
                    < timeline["end_ms"]),
                max_gap_ms=timeline["max_gap_ms"])


def autotune_path(torch, np, kernels, gpt_mod, dev, preset="gpt2"):
    """Phase 34.  ``preset="tiny"`` rehearses it on the CPU (BERT tiny,
    GPT hidden 64).  Returns (a report, B1's launches by body in (a),
    B2's launches in (b) by the case of :func:`autotune_cases`)."""
    model = dict(FLEET_MODEL)
    bert = "large"
    if preset == "tiny":
        model.update(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=2)
        bert = "tiny"
    t0 = time.perf_counter()
    a = autotune_trainer(torch, np, kernels, dev, preset=bert)
    _free(torch)
    trace_path = ROOT / "chiprun_out" / "autotune_serving.trace.json"
    b = autotune_serving(torch, np, kernels, gpt_mod, dev, model,
                         trace_path)
    c = flight_gates(torch, np, gpt_mod, dev,
                     dict(model, num_hidden_layers=2))
    d = request_waterfall(trace_path, b["request_ids"])
    seconds = time.perf_counter() - t0
    log(f"   phase 34: (a) {a['wall_s']:.1f} s, (b) {b['run_s']:.1f} s, "
        f"(c) {c['wall_s']:.1f} s; {seconds:.1f} s in all")
    report = dict(seconds=seconds, a=a, b=b, c=c, d=d)
    return report, a["b1_bodies"], b["launches_by_case"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np
        from skycomputing_tpu_torch.models import gpt as gpt_mod
        from skycomputing_tpu_torch.ops import _build
        from skycomputing_tpu_torch.ops.flash_attention import flash_attention
        from skycomputing_tpu_torch.ops.paged_attention import (
            paged_attention,
            paged_attention_int8,
        )
        from skycomputing_tpu_torch.serving import Request, ServingEngine
    except ImportError as exc:
        print(f"FAIL: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    report = dict(device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda)
    source = "skycomputing_tpu_torch/ops/csrc/paged_attention.cu"
    # every kernel wrapper of the port, by name
    kernels = {
        "paged_attention": dict(
            fn=paged_attention, route="cuda", source=source,
            replaces="skycomputing_tpu/ops/paged_attention.py:73"),
        "paged_attention_int8": dict(
            fn=paged_attention_int8, route="cuda", source=source,
            replaces="skycomputing_tpu/ops/paged_attention.py:108"),
        "flash_attention": dict(
            fn=flash_attention, route="cuda",
            source="skycomputing_tpu_torch/ops/csrc/flash_attention.cu",
            replaces="skycomputing_tpu/ops/flash_attention.py:26"),
    }
    serve_args = (torch, np, gpt_mod, ServingEngine, Request, kernels)

    with phase("card"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
        log(card)
        report["nvidia_smi"] = card
        log(f"   torch {torch.__version__}, CUDA {torch.version.cuda}")

    with phase("build"):
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            built = list(pool.map(_build.build, sources))
        report["build_s"] = time.perf_counter() - t0
        log(f"   built {sources} in {report['build_s']:.2f} s")
        ptxas = ptxas_by_label(_build)
        report["ptxas"] = ptxas
        for label, info in ptxas.items():
            log(f"   ptxas {label}: {json.dumps(info)}")
        new_bodies = {label: info for label, info in ptxas.items()
                      if "_kernel_mma<" in label or "_kernel_decode<" in label
                      or "_kernel_tile<" in label
                      or "_kernel_tf32x3<" in label}
        check(len(new_bodies) > 0 and all(
            info.get("spill_store_bytes", 1) == 0
            and info.get("spill_load_bytes", 1) == 0
            for info in new_bodies.values()),
              f"{len(new_bodies)} instantiations of the tensor-core (bf16 "
              f"and 3xTF32), decode and register-tile bodies, none "
              f"spilling")

    with phase("kernels against plain versions"):
        report["spin_ms"] = spin_ms(torch)
        log(f"   spin kernel ahead of each timed call: "
            f"{report['spin_ms']:.3f} ms")
        attn = kernel_checks(torch, np, ptxas)
        report["kernels"] = attn
        report["kernel_edges"] = paged_edge_checks(torch, np, ptxas)

    with phase("flash attention (B1) against its plain version"):
        flash = flash_checks(torch, np, ptxas)
        report["flash_kernel"] = flash
        report["flash_edges"] = flash_edge_checks(torch, np, ptxas)
        report["flash_cuda_core"] = flash_cuda_core_checks(torch, np, ptxas)

    with phase("main path: GPT-2 small paged serving"):
        cfg = gpt_mod.GptConfig()
        check(cfg.hidden_size == 768 and cfg.num_hidden_layers == LAYERS
              and cfg.vocab_size == 50257 and cfg.dtype == "bfloat16",
              "GPT-2 small defaults")
        engine, fp_reqs, snap, launches, e2e = serve(*serve_args)
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        check_launches(launches, {B2: LAYERS * steps, B3: 0},
                       f"12 x ({snap['prefill_waves']} prefill waves + "
                       f"{snap['decode_ticks']} decode ticks) of B2")
        check_bodies(e2e, B2, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
        check(snap["prefix_hits"] >= 2 and snap["cow_copies"] >= 1,
              f"radix hits {snap['prefix_hits']}, COW clones "
              f"{snap['cow_copies']}")
        report["e2e"] = e2e
        main_launches = launches
        fp_streams = [list(r.tokens) for r in fp_reqs]
        del engine

    with phase("int8 path: GPT-2 small over int8 pages"):
        engine, reqs, snap, launches, e2e = serve(*serve_args,
                                                  kv_dtype="int8")
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        check_launches(launches, {B2: 0, B3: LAYERS * steps},
                       f"12 x ({snap['prefill_waves']} prefill waves + "
                       f"{snap['decode_ticks']} decode ticks) of B3")
        check_bodies(e2e, B3, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
        check(snap["quantized_pages"] > 0 and snap["dequant_blocks"] > 0,
              f"quantized pages {snap['quantized_pages']}, dequantized "
              f"blocks {snap['dequant_blocks']}")
        check(snap["prefix_hits"] >= 2 and snap["cow_copies"] >= 1,
              f"radix hits {snap['prefix_hits']}, COW clones "
              f"{snap['cow_copies']}")
        int8_streams = [list(r.tokens) for r in reqs]
        e2e["agreement_with_fp"] = agreement(int8_streams, fp_streams)
        e2e["first_token_agreement_with_fp"] = float(np.mean(
            [a[0] == b[0] for a, b in zip(int8_streams, fp_streams)]))
        fp_e2e = report["e2e"]
        for key in ("tokens_per_s", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s",
                    "tpot_p95_s", "peak_mem_gb"):
            log(f"   {key}: int8 {e2e[key]:.6g}, fp {fp_e2e[key]:.6g}")
        log(f"   positional agreement with the fp run "
            f"{e2e['agreement_with_fp']:.3f} (first tokens "
            f"{e2e['first_token_agreement_with_fp']:.3f}; reported, not "
            f"gated: random weights make near-ties common)")
        report["e2e_int8"] = e2e
        int8_launches = launches
        del engine

    with phase("speculative path: spec_k=4, draft_blocks=2"):
        k, d = 4, 2
        spec, spec_streams = {}, {}
        for kv_dtype, kernel in ((None, B2), ("int8", B3)):
            engine, reqs, snap, launches, e2e = serve(
                *serve_args, spec_k=k, draft_blocks=d, kv_dtype=kv_dtype,
                quiet_after=d)
            expect = {B2: 0, B3: 0}
            expect[kernel] = (
                LAYERS * (snap["prefill_waves"] + snap["decode_ticks"])
                + snap["spec_ticks"] * (k * d + LAYERS))
            check_launches(
                launches, expect,
                f"{kernel}: 12 x {snap['prefill_waves']} prefill waves + "
                f"{snap['spec_ticks']} spec ticks x ({k} x {d} + 12)")
            prefill = LAYERS * snap["prefill_waves"]
            check_bodies(e2e, kernel, prefill, expect[kernel] - prefill)
            check(snap["spec_ticks"] > 0
                  and snap["accepted_draft_tokens"] > 0,
                  f"{snap['accepted_draft_tokens']} of "
                  f"{snap['draft_tokens']} draft tokens accepted")
            e2e["accept_rate"] = (snap["accepted_draft_tokens"]
                                  / snap["draft_tokens"])
            e2e["spec_rollbacks"] = snap["spec_rollbacks"]
            log(f"   {kv_dtype or 'fp'} pages: accept rate "
                f"{e2e['accept_rate']:.3f}, tokens/s "
                f"{e2e['tokens_per_s']:.1f}, TPOT p50 "
                f"{e2e['tpot_p50_s'] * 1e3:.2f} ms")
            spec[kv_dtype or "fp"] = e2e
            spec_streams[kv_dtype or "fp"] = [list(r.tokens) for r in reqs]
            del engine
        report["e2e_spec"] = spec

    with phase("chunked prefill and swap preemption"):
        engine, reqs, snap, launches, e2e = serve(*serve_args,
                                                  prefill_chunk=64)
        check(snap["prefill_chunks"] > 0,
              f"{snap['prefill_chunks']} prefill chunks in "
              f"{snap['prefill_waves']} chunk waves")
        check_launches(launches, {
            B2: LAYERS * (snap["prefill_waves"] + snap["decode_ticks"]),
            B3: 0}, f"12 x ({snap['prefill_waves']} chunk waves + "
                    f"{snap['decode_ticks']} decode ticks) of B2")
        check_bodies(e2e, B2, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
        e2e["agreement_with_fp"] = agreement(
            [list(r.tokens) for r in reqs], fp_streams)
        report["e2e_chunked"] = e2e
        del engine
        victim = 1
        engine, reqs, snap, launches, e2e = serve(
            *serve_args, preempt=(8, victim, "swap"), kv_dtype="int8")
        check(snap["preemptions"] == snap["swap_outs"] == 1
              and snap["swap_ins"] == 1 and snap["swap_corruptions"] == 0,
              f"swap out {snap['swap_outs']}, in {snap['swap_ins']}, "
              f"corrupt {snap['swap_corruptions']}")
        check(reqs[victim].status == "finished"
              and len(reqs[victim].tokens) == 32,
              "the swapped request resumed and finished with 32 tokens")
        check_launches(launches, {
            B2: 0, B3: LAYERS * (snap["prefill_waves"]
                                 + snap["decode_ticks"])},
            "swap run: 12 x (prefill waves + decode ticks) of B3")
        check_bodies(e2e, B3, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
        e2e["victim_agreement_with_unpreempted"] = agreement(
            [list(reqs[victim].tokens)], [int8_streams[victim]])
        log(f"   the victim's stream agrees with the un-preempted int8 "
            f"run at {e2e['victim_agreement_with_unpreempted']:.3f} of "
            f"positions (reported: other rows' batch changes)")
        report["e2e_swap"] = e2e
        del engine

    with phase("card against CPU: depth 2, float32, greedy"):
        streams = {}
        for name, device, kw in (
                ("fp", "cuda", {}), ("fp", "cpu", {}),
                ("int8", "cuda", dict(kv_dtype="int8")),
                ("int8", "cpu", dict(kv_dtype="int8")),
                ("spec", "cuda", dict(spec_k=3, draft_blocks=1))):
            eng = build_engine(ServingEngine, gpt_mod, 2, "float32", device,
                               **kw)
            reqs = requests_for(np, Request, n=6, new_tokens=12, seed=7)
            eng.run(reqs)
            streams[name, device] = [list(r.tokens) for r in reqs]
        agree = sum(a == b for a, b in zip(streams["fp", "cuda"],
                                           streams["fp", "cpu"]))
        check(streams["fp", "cuda"] == streams["fp", "cpu"],
              f"card and CPU token streams identical ({agree}/6 requests)")
        free_agree = agreement(streams["int8", "cuda"],
                               streams["int8", "cpu"])
        free_diffs = [(i, j) for i, (a, b) in enumerate(
            zip(streams["int8", "cuda"], streams["int8", "cpu"]))
            for j, (s, t) in enumerate(zip(a, b)) if s != t]
        log(f"   int8 free-running streams agree at {free_agree:.3f} of "
            f"positions; (request, position) that differ: {free_diffs} — "
            f"after a first difference the two histories differ, so the "
            f"rest of that request differs too")
        forced = lockstep_int8(torch, np, gpt_mod, ServingEngine, Request)
        log(f"   int8 lockstep: {json.dumps(forced)}")
        check(forced["agreement"] >= 0.95,
              f"int8 card and CPU choose the same token at "
              f"{forced['agreement']:.3f} of positions given the same "
              f"history (>= 0.95)")
        check(streams["spec", "cuda"] == streams["fp", "cuda"],
              "speculative streams on the card equal plain decoding's")
        report["card_vs_cpu"] = dict(
            fp_identical_requests=agree, int8_free_agreement=free_agree,
            int8_free_diffs=free_diffs, int8_lockstep=forced)

    with phase("profile: device time by kernel over a prefill wave and "
               "decode ticks"):
        prof_report = {}
        for label, kw, kernel in (("fp", {}, B2),
                                  ("int8", dict(kv_dtype="int8"), B3)):
            engine = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16",
                                  "cuda", **kw)
            for r in requests_for(np, Request, n=16, new_tokens=8, seed=3):
                engine.submit(r)
            log(f"   {label} pages, one prefill wave:")
            prof_report[label + "_prefill"] = profile_prefill_wave(
                torch, engine, kernels[kernel]["fn"])
            engine.step()  # admission + prefill waves + a first decode tick
            ticks0 = engine.stats.decode_ticks
            launches0 = kernels[kernel]["fn"].launches
            log(f"   {label} pages:")
            out, rows = profile_window(
                torch, lambda: [engine.step() for _ in range(4)])
            kernel_us = sum(us for us, key, _ in rows
                            if "paged_attention_kernel" in key)
            busy_us = sum(us for us, _, _ in rows)
            out.update(paged_device_ms=kernel_us / 1e3,
                       paged_share=kernel_us / busy_us if busy_us else None,
                       paged_kernels=sorted({key[:100] for _, key, _ in rows
                                             if "paged_attention" in key}))
            ticks = engine.stats.decode_ticks - ticks0
            per_tick = (kernels[kernel]["fn"].launches - launches0) / max(
                ticks, 1)
            check(per_tick == LAYERS, f"{per_tick} {kernel} launches per "
                  f"decode tick (one per layer)")
            out.update(decode_ticks=ticks, launches_per_decode_tick=per_tick)
            span_ms, device_ms = write_cost_per_tick(torch, np, engine)
            out.update(write_span_ms_per_tick=span_ms,
                       write_device_ms_per_tick=device_ms,
                       write_span_share_of_tick=span_ms / 1e3
                       / (out["window_s"] / ticks))
            if out["device_busy_s"] > 0:
                out["write_device_share_of_tick"] = (
                    device_ms / 1e3 / (out["device_busy_s"] / ticks))
            log(f"   profile {label}: "
                f"{json.dumps({k: v for k, v in out.items() if k != 'top'})}")
            prof_report[label] = out
            del engine
        report["profile"] = prof_report

    with phase("bf16 flash on against off: BERT-large width, depth 2"):
        cmp = flash_on_off_bf16(torch, np, kernels)
        log(f"   {json.dumps(cmp)}")
        check(cmp["flash_launches"] == 2 * 2 * 2 * BERT_MICROBATCHES
              and cmp["einsum_run_flash_launches"] == 0,
              f"B1 launched {cmp['flash_launches']} times with the flag on "
              f"(2 steps x 2 layers x {BERT_MICROBATCHES} microbatches x "
              f"forward and remat), {cmp['einsum_run_flash_launches']} off")
        check(cmp["max_loss_rel_diff"] <= 2e-2,
              f"bf16 losses with flash on and off within "
              f"{cmp['max_loss_rel_diff']:.3g} <= 2e-2 relative")
        report["flash_on_off_bf16"] = cmp
        gc.collect()
        torch.cuda.empty_cache()

    with phase("training path: BERT-large pipeline, 4 stages, GPipe M=4"):
        model, data, labels, launches, e2e = train_bert(torch, np, kernels)
        per_step = 2 * 24 * BERT_MICROBATCHES
        check_launches(launches, {B1: per_step * BERT_STEPS},
                       f"{per_step} B1 launches per step (24 layers x "
                       f"{BERT_MICROBATCHES} microbatches x forward and "
                       f"rematerialized forward) x {BERT_STEPS} steps")
        log(f"   step {e2e['step_s_median_2_5'] * 1e3:.1f} ms (median of "
            f"steps 2-{BERT_STEPS}), {e2e['tokens_per_s']:.0f} tokens/s, "
            f"MFU {e2e['mfu']:.2%}, peak {e2e['peak_mem_gb']:.2f} GB")
        report["e2e_train"] = e2e

    with phase("profile: device time by kernel over one train step"):
        b1_before = flash_attention.launches
        out, rows = profile_window(
            torch, lambda: model.train_step(data, labels))
        b1_us = sum(us for us, key, _ in rows
                    if "flash_attention_kernel" in key)
        total_us = sum(us for us, _, _ in rows)
        b1_launches = flash_attention.launches - b1_before
        out.update(flash_launches=b1_launches,
                   flash_device_ms=b1_us / 1e3,
                   flash_us_per_launch=b1_us / max(b1_launches, 1),
                   flash_share=b1_us / total_us if total_us else None,
                   copy_launches=sum(n for _, key, n in rows
                                     if "copy" in key))
        log(f"   profile train step: "
            f"{json.dumps({k: v for k, v in out.items() if k != 'top'})}")
        report["profile_train"] = out
        del model
        gc.collect()
        torch.cuda.empty_cache()

    with phase("trainer card against CPU: depth 2, float32"):
        cmp = trainer_card_vs_cpu(torch, np)
        log(f"   {json.dumps(cmp)}")
        check(cmp["max_loss_rel_diff"] <= 1e-4,
              f"card and CPU losses within {cmp['max_loss_rel_diff']:.3g} "
              f"<= 1e-4 relative")
        check(cmp["max_param_abs_diff"] <= 1e-5,
              f"card and CPU parameters within "
              f"{cmp['max_param_abs_diff']:.3g} <= 1e-5 after two steps")
        check_f32_b1_body(cmp["b1"]["bodies"], cmp["b1"]["launches"],
                          "trainer card against CPU")
        report["trainer_card_vs_cpu"] = cmp
        gc.collect()
        torch.cuda.empty_cache()

    bert_cfg, bert_cfgs = bert_units()
    with phase("profilers: BERT-large's 75 units and 4 workers"):
        static_bench, timed_bench, prof = profilers(
            torch, np, kernels, bert_cfgs, bert_cfg.vocab_size)
        log(f"   {prof['distinct_units']} distinct units timed in "
            f"{prof['timed_s']:.2f} s, counted in {prof['static_s']:.2f} s; "
            f"memory estimate {prof['mem_total_gb']:.3f} GB; B1 launched "
            f"{prof['launches'][B1]} times")
        report["profilers"] = prof
        gc.collect()
        torch.cuda.empty_cache()

    with phase("launcher: optimal allocation, 1F1B M=4, BERT-large"):
        workdir = ROOT / "build" / "chip_smoke"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            launcher_launches, e2e = launcher_path(torch, np, kernels,
                                                   workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gpipe = report["e2e_train"]
        for key in ("step_s_median_2_5", "tokens_per_s", "mfu",
                    "peak_mem_gb"):
            log(f"   {key}: 1F1B optimal {e2e[key]:.6g}, GPipe even "
                f"{gpipe[key]:.6g}")
        report["e2e_launcher"] = e2e
        gc.collect()
        torch.cuda.empty_cache()

    with phase("headline pass: even, calibration, optimal (paper slowdowns)"):
        head = headline(np, bert_cfgs, static_bench, timed_bench,
                        bert_cfg.vocab_size)
        log(f"   partitions: even {head['even']['partition']}, optimal "
            f"{head['optimal']['partition']} (solver gap "
            f"{head['solver_gap']:.3g}); speedup "
            f"{json.dumps(head['speedup'])}")
        report["headline"] = head
        gc.collect()
        torch.cuda.empty_cache()

    with phase("GLUE path: MNLI from TSVs, the launcher with eval, metrics "
               "and NaN-guard hooks, then Runner.evaluate"):
        workdir = ROOT / "build" / "chip_smoke_glue"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            eval_launches, dev, glue = glue_path(torch, np, kernels, workdir,
                                                 ptxas=ptxas)
            cmp = eval_card_vs_cpu(torch, np, dev)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"   card against CPU: {json.dumps(cmp)}")
        check(cmp["loss_rel_diff"] <= 1e-4,
              f"eval losses on the card and the CPU (depth 2, float32) "
              f"within {cmp['loss_rel_diff']:.3g} <= 1e-4 relative")
        check(cmp["cuda"]["predictions"] == cmp["cpu"]["predictions"],
              f"equal predictions on the card and the CPU "
              f"({len(cmp['cpu']['predictions'])} examples)")
        check_f32_b1_body(cmp["cuda"]["b1"]["bodies"],
                          cmp["cuda"]["b1"]["launches"],
                          "eval card against CPU")
        report["glue"] = glue
        report["eval_card_vs_cpu"] = cmp
        gc.collect()
        torch.cuda.empty_cache()

    with phase("bench: python -m skycomputing_tpu_torch.bench"):
        report["bench"] = bench_run(np, BENCH_SMOKE_ENV, timeout_s=420)

    with phase("pre-flight, tracing and self-heal: BERT-large, 4 workers, "
               "B1 on"):
        workdir = ROOT / "chiprun_out"
        workdir.mkdir(exist_ok=True)
        heal_launches, heal = selfheal_path(
            torch, np, kernels, bert_cfgs, bert_cfg.vocab_size, static_bench,
            workdir)
        log(f"   step medians: baseline {heal['baseline_median_ms']:.1f} "
            f"ms, straggler {heal['straggler_median_ms']:.1f} ms "
            f"({heal['straggler_over_baseline']:.3f}x), after the heal "
            f"{heal['post_heal_median_ms']:.1f} ms "
            f"({heal['post_over_baseline']:.3f}x); partitions "
            f"{heal['partition_before']} -> {heal['partition_after']}")
        log(f"   heal cost: {json.dumps(heal['heal_cost'])}; pre-flight "
            f"{heal['preflight_s']} s; bubble fraction "
            f"{heal['bubble_fraction']}, dispatch share "
            f"{heal['dispatch_share']}; peak {heal['peak_mem_gb']:.2f} GB "
            f"(GPipe phase {report['e2e_train']['peak_mem_gb']:.2f} GB); "
            f"tracing on {heal['traced_post_heal_median_ms']:.1f} ms, off "
            f"{heal['untraced_median_ms']:.1f} ms")
        report["selfheal"] = heal
        gc.collect()
        torch.cuda.empty_cache()

    with phase("serving allocation and multi-stage serving: GPT-2 small, "
               "4 workers"):
        stages_report, stage_launches, stage_prefill = serving_stages_path(
            torch, serve_args, dict(
                fp=(report["e2e"], fp_streams),
                int8=(report["e2e_int8"], int8_streams),
                spec=(report["e2e_spec"]["fp"], spec_streams["fp"])))
        report["serving_stages"] = stages_report
        gc.collect()
        torch.cuda.empty_cache()

    with phase("serving bench: its six sections at GPT-2 small, float32, "
               "the kernel section again in bf16"):
        bench_report, bench_launches, bench_prefill, bench_tile = (
            serving_bench_path(torch, np, kernels, gpt_mod))
        report["serving_bench"] = bench_report
        gc.collect()
        torch.cuda.empty_cache()

    with phase("GPT launcher: SKYTPU_MODEL=gpt at BERT-large's width, 10 "
               "blocks, optimal, 1F1B M=4"):
        workdir = ROOT / "build" / "chip_smoke_gpt"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            report["e2e_gpt_launcher"] = gpt_launcher_path(
                torch, np, kernels, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    with phase("long BERT through B1: B1 at L = 1,024-4,096, then "
               "BERT-large's width at L=4,096, optimal, GPipe M=2"):
        report["flash_long"] = flash_long_checks(torch, np, ptxas)
        workdir = ROOT / "build" / "chip_smoke_zoo"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            report["e2e_long_bert"] = long_bert_path(torch, np, kernels,
                                                     workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    with phase("MoE GPT: GPT-2 small's width, 6 MoE blocks of 8 experts, "
               "optimal, 1F1B M=4"):
        try:
            report["e2e_moe_gpt"] = moe_gpt_path(torch, np, kernels, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    with phase("ResNet-50 on CIFAR-10 shapes: optimal, GPipe M=4"):
        try:
            report["e2e_resnet50"] = resnet_path(torch, np, kernels, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    with phase("sequence parallelism: ring and Ulysses over 4 positions "
               "of the card, long BERT and GPT-2 small on a ring"):
        dev = torch.device("cuda", 0)
        report["sequence_parallel"] = dict(
            attention=sp_attention_checks(torch, np, dev))
        _free(torch)
        report["sequence_parallel"]["long_bert"] = sp_long_bert_steps(
            torch, np, kernels, dev)
        report["sequence_parallel"]["gpt"] = sp_gpt_logits(torch, np, dev)
        _free(torch)

    par_cfg, par_units = parallel_units()
    with phase("data-parallel replicas: 2 x BERT-large's pipeline, "
               "float32, 1F1B M=4"):
        report["data_parallel"] = data_parallel_path(
            torch, np, kernels, dev, par_units, par_cfg.vocab_size)
        _free(torch)

    with phase("mesh-native stages: mesh_allocate over 4 workers and 8 "
               "positions, MeshPipelineModel"):
        report["mesh_pipeline"] = mesh_pipeline_path(
            torch, np, kernels, dev, par_units, par_cfg.vocab_size)
        _free(torch)

    with phase("compiled SPMD pipelines: BERT-large's width on 8, 4 and "
               "8 positions (GPipe, interleaved, ZeRO-3, TP), GPT-2 small's "
               "(dense, MoE, MoE with TP), card against CPU, against "
               "PipelineModel"):
        report["spmd"] = spmd_path(torch, np, kernels, dev)
        spmd = report["spmd"]
        for name in ("a_gpipe_dp2_pp4", "b_interleaved_V2_M4",
                     "b_interleaved_V2_M8", "c_zero3_adam_dp2_pp4",
                     "d_tp_dp2_pp2_tp2", "e_gpt_dense_pp4", "e_gpt_moe_pp2",
                     "e_gpt_moe_pp2_tp2"):
            log(f"   {name}: step {spmd[name]['step_ms_median_2_on']:.1f} "
                f"ms (median of steps 2 on), peak "
                f"{spmd[name]['peak_mem_gb']:.2f} GB; beside phase 27's "
                f"replicas {_median(report['data_parallel']['step_ms']):.1f}"
                f" ms and phase 28's mesh engine "
                f"{_median(report['mesh_pipeline']['step_ms']):.1f} ms")
        _free(torch)

    with phase("multihost, heartbeat and elastic: a world of one under "
               "NCCL, peer death under gloo, a supervised planned re-form "
               "of BERT-large's width through B1, a crash re-form"):
        workdir = ROOT / "build" / "chip_smoke_elastic"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            report["elastic"] = elastic_path(torch, np, dev, workdir)
        finally:
            keep = ROOT / "chiprun_out" / "elastic"
            shutil.rmtree(keep, ignore_errors=True)
            if workdir.exists():
                shutil.copytree(workdir, keep,
                                ignore=shutil.ignore_patterns("*.pt"))
            shutil.rmtree(workdir, ignore_errors=True)
        _free(torch)

    with phase("measuring tools: step overhead, schedule model, KV-cache "
               "decode, the profiler and trace report, MFU, allocation "
               "preview, the ladder's first rungs, checkpoint conversion"):
        report["tools"] = tools_path(torch, np, kernels, gpt_mod,
                                     ServingEngine, Request)
        _free(torch)

    with phase("serving fleet: bench_fleet's kill-and-spike at GPT-2 "
               "small, float32, 3 paged replicas, flight recorder, SLO, "
               "exporter; then the autoscaler"):
        report["fleet"], fleet_bodies = fleet_path(
            torch, np, kernels, gpt_mod, torch.device("cuda"))
        _free(torch)

    with phase("disaggregated serving, the chaos plane and the workload "
               "player: bench_disagg at GPT-2 small, bench_chaos's "
               "prefill_kill_mid_handoff and swap_corruption, "
               "bench_scenarios' diurnal_ramp"):
        report["disagg"], disagg_roles = disagg_chaos_path(
            torch, np, kernels, gpt_mod, torch.device("cuda"))
        _free(torch)

    with phase("the closed tuning loop: AutotuneHook on BERT-large's "
               "width with a straggler, ServingAutotuner on GPT-2 small, "
               "bench_flight's four gates, trace_report --request"):
        report["autotune"], tune_b1, tune_b2 = autotune_path(
            torch, np, kernels, gpt_mod, torch.device("cuda"))
        _free(torch)

    def entry(name, kernel_launches, rows=attn, case="decode", label=None,
              dtype="bfloat16", body=None):
        row = next(r for r in rows if r["kernel"] == name
                   and r["case"] == case and r["dtype"] == dtype)
        k = kernels[name]
        out = dict(name=label or name, route=k["route"], source=k["source"],
                   replaces=k["replaces"], launches=kernel_launches,
                   max_abs_err=row["max_abs_err"], ms=row["ms"],
                   plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                   bound_by=row["bound_by"], library_ms=row["library_ms"])
        if body is not None:
            check(row["body"] == body, f"{out['name']}: timed on {body}")
            out["body"] = body
            if "ffma_bound_ms" in row:
                out["ffma_bound_ms"] = row["ffma_bound_ms"]
        return out

    # each kernel's launches from the paths that are its own: B2 from the
    # fp serving path, the multi-stage phase and the serving bench, B3
    # from the int8 path, the multi-stage phase and the serving bench, B1
    # from the launcher's run, the GLUE path's evaluation and the
    # self-heal run; the prefill entries are the tensor-core body's
    # launches in those runs, beside its time at the prefill wave's shape,
    # and the register-tile entries the float32 prefill and chunk waves'
    # (the serving bench's), beside its float32 time at that shape
    fp_bodies = report["e2e"]["body_launches"][B2]
    int8_bodies = report["e2e_int8"]["body_launches"][B3]
    line = {"kernels": [
        entry(B2, main_launches[B2] + stage_launches[B2]
              + bench_launches[B2]),
        entry(B2, fp_bodies["tensor_core"] + stage_prefill[B2]
              + bench_prefill[B2], case="prefill", label=f"{B2}:prefill"),
        entry(B3, int8_launches[B3] + stage_launches[B3]
              + bench_launches[B3]),
        entry(B3, int8_bodies["tensor_core"] + stage_prefill[B3]
              + bench_prefill[B3], case="prefill", label=f"{B3}:prefill"),
        entry(B2, bench_tile[B2], case="prefill", dtype="float32",
              label=f"{B2}:register_tile"),
        entry(B3, bench_tile[B3], case="prefill", dtype="float32",
              label=f"{B3}:register_tile"),
        entry(B1, launcher_launches[B1] + eval_launches[B1]
              + heal_launches[B1], flash, "bert_large_L128"),
        # long BERT's path (phase 23), beside B1's time at L=4,096
        entry(B1, report["e2e_long_bert"]["launches"][B1],
              report["flash_long"], "long_L4096",
              label=f"{B1}:long_L4096"),
        # the float32 tensor-core (3xTF32) body on the data-parallel and
        # mesh phases' paths, beside its time at their dp shard's 4 rows
        # of 128
        entry(B1, report["data_parallel"]["b1_bodies"][F32_BODY]
              + report["mesh_pipeline"]["b1_bodies"][F32_BODY], flash,
              "bert_large_L128_B4", dtype="float32",
              label=f"{B1}:f32_B4_L128", body=F32_BODY),
        # the same body in phase 26's single-device baseline, beside its
        # time at that baseline's microbatch, 1 row of 4,096
        entry(B1, report["sequence_parallel"]["long_bert"]["runs"]["b1"][
            "b1_bodies"][F32_BODY], report["flash_long"], "long_L4096",
              dtype="float32", label=f"{B1}:f32_L4096", body=F32_BODY),
        # the compiled SPMD BERT pipeline's bf16 runs (phase 29 (a)-(c)),
        # beside B1's time at (a)'s dp shard, 4 rows of 128
        entry(B1, sum(sum(spmd[r]["b1_per_step"]) for r in (
            "a_gpipe_dp2_pp4", "b_interleaved_V2_M4", "b_interleaved_V2_M8",
            "c_zero3_adam_dp2_pp4")), flash, "bert_large_L128_B4",
              label=f"{B1}:spmd_bf16", body="tensor_core"),
        # the supervised trainer's two generations (phase 30 (c)), beside
        # B1's time at their microbatch, 8 rows of 128
        entry(B1, report["elastic"]["c_planned_reform"]["b1_launches"],
              flash, "bert_large_L128", label=f"{B1}:elastic",
              body="tensor_core"),
        # the measuring tools (phase 31): B1's tensor-core body in the
        # traced call, the timed profile and the ladder's rungs, beside
        # its time at 8 rows of 128; B2's decode body in the traced tick
        entry(B1, report["tools"]["b1_tensor_core"], flash,
              "bert_large_L128", label=f"{B1}:tools", body="tensor_core"),
        entry(B2, report["tools"]["b2_decode"], label=f"{B2}:tools",
              body="decode"),
        # the serving fleet (phase 32 (a)): B2's decode body in every
        # replica's decode ticks, its register-tile body in their float32
        # prefill waves, beside the decode and float32 prefill times
        entry(B2, fleet_bodies["decode"], dtype="float32",
              label=f"{B2}:fleet", body="decode"),
        entry(B2, fleet_bodies["register_tile"], case="prefill",
              dtype="float32", label=f"{B2}:fleet_register_tile",
              body="register_tile"),
        # disaggregated serving (phase 33 (a)'s measured replays), each
        # beside B2's float32 time at that call's geometry: the decode
        # body in the decode specialist's ticks, the decode body in the
        # other replicas' ticks (the monolith's and the prefill
        # specialists'), the register-tile body in their prefill waves
        entry(B2, disagg_roles["decode"]["decode"], case="disagg_decode",
              dtype="float32", label=f"{B2}:disagg", body="decode"),
        entry(B2, disagg_roles["monolithic"]["decode"]
              + disagg_roles["prefill"]["decode"],
              case="disagg_replica_decode", dtype="float32",
              label=f"{B2}:disagg_replica", body="decode"),
        entry(B2, disagg_roles["monolithic"]["register_tile"]
              + disagg_roles["prefill"]["register_tile"],
              case="disagg_prefill", dtype="float32",
              label=f"{B2}:disagg_register_tile", body="register_tile"),
        # the closed tuning loop (phase 34): B1's tensor-core body in the
        # tuned trainer, beside its time at that trainer's 8 rows of 128;
        # B2 in the tuned engine, one entry per call geometry (the decode
        # wave and a prefill wave at each bucket), beside its float32 time
        # at that geometry
        entry(B1, tune_b1["tensor_core"], flash, "bert_large_L128",
              label=f"{B1}:autotune", body="tensor_core")] + [
        entry(B2, tune_b2[name], case=name, dtype="float32",
              label=f"{B2}:{name}", body=body)
        for name, _, _, _, body, _ in autotune_cases()]}
    # B1's error: the worst over its main case and the eval path's calls
    b1_main = next(k for k in line["kernels"] if k["name"] == B1)
    b1_main["max_abs_err"] = max(
        [b1_main["max_abs_err"]]
        + [r["max_abs_err"] for r in report["glue"]["flash_eval_shapes"]])
    check(all(k["launches"] > 0 for k in line["kernels"]),
          "every kernel of the line launched on its path")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [ELASTIC_CHILD]:
        sys.exit(elastic_child(sys.argv[2:]))
    if sys.argv[1:2] == [TOOLS_CHILD]:
        sys.exit(tools_child(sys.argv[2:]))
    if sys.argv[1:2] == [HEAL_PROBE]:
        sys.exit(heal_probe(sys.argv[2:]))
    sys.exit(main())
