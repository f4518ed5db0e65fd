#!/usr/bin/env python3
"""Drive the PyTorch port of HiStore on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--keys 8388608]

1. Prints the card (torch and nvidia-smi).
2. Builds the CUDA kernels of src/repro_torch/kernels/csrc with nvcc.
3. The main path: HiStoreClient(LocalBackend(2**24, DEFAULT)) on the
   card with the paper's shapes, loaded with ``--keys`` distinct int32
   keys, then 8 mixed rounds of one client chunk (16384 keys) each: GETs
   (hits and misses), overwriting and fresh PUTs, DELETEs, an async
   apply and 4 SCANs (limit 128).  Every
   answer is checked against a sorted-array model kept here: every
   acknowledged write reads back with its value, deleted keys are not
   found, every SCAN equals the model's range.  The kernels' launch
   counts are set to 0 just before this phase, and the probe's, the
   search's and the merge's must be > 0 after.
4. Each of those kernels against its plain PyTorch version on the card,
   on the loaded state at the main path's shapes (equality of every
   output), with its time per call (CUDA events), its device time
   (launches queued behind a GPU sleep, so host time is hidden), its
   plain version's time, its bound (bytes over 3.35 TB/s; for the search
   also the latency of the dependent rounds it needs, beside the
   parent's levels x the slope a level) and, for the search,
   torch.searchsorted (per call and on the device, at Q = 1 and at Q),
   and the device time of the same function in PyTorch calls
   (searchsorted, then the gathers and the compare that give addr and
   found).  The SCAN's range at Q = 1, routed (``ops.range_query``: one
   launch, lo and hi read on the card) against ``six.range_query``, per
   call and on the device.  The hash probe takes the keys and hashes them
   on the card: it is also timed routed (``ops.probe``), against
   ``hix.lookup``, its bound given with the key in and with the three
   descriptors the kernel took before.  One merge call runs under torch.profiler (CUDA
   activity) and the device time of each of its kernels is logged by name.
4b. The rest of the dispatch surface on the same loaded store, launch
   counts set to 0 before it and the four new ones > 0 after:
   ``ops.hash_probe`` (the legacy probe: the keys in, hashed on the card,
   one launch) on one client chunk of GET keys,
   ``ops.sorted_search`` (the legacy search) on replica 0 with misses,
   -1 and 2**31 - 1, ``ops.sort`` and ``ops.sort_pairs`` at [16, 4096],
   [1, 16384] and [1, 65536] (keys in [0, 1024), distinct payloads), and
   ``ops.merge`` with a 65536-entry batch (split by kernel as in 4).
   Each against its plain
   version (the probe and search also against ``ops.probe`` and
   ``ops.search``, the probe also against its descriptor-in entry, both
   entries timed, routed too, the bound counted with the key in beside
   the descriptors in, its lanes a query logged), ``ops.sort`` once on
   int16 keys (no launch, the plain version's answer), timed as in 4, with torch.sort(stable) +
   gather and searchsorted + index as the library calls (the sorts' also
   on the device); the sorts' bound also counts their compare-exchanges at
   67e12/s; the legacy search's same-function library call also timed on
   the device; the bitonic sort split by kernel under torch.profiler.
4c. Programmatic dependent launch on and off: merge.cu and sort_stable.cu
   built again with pdl.cuh's launch attribute off (into build/no_pdl),
   then the merge (cap 2**24 at m = 4096 and 65536, and the replica's
   first 2**21 entries at m = 4096) and the stable sort at each sort
   shape, device time as in 4, in the order on, off, on, off; the two
   builds' outputs must be equal.
5. The failure and recovery path on the same store, launch counts set
   to 0 before it and all four > 0 after: a pending window of 2 chunks
   that straddles the end of the 65536-entry backup-log ring, then the
   primary fails (its hash is wiped); a degraded read-back of every key
   (timed) and 4 degraded mixed rounds; the primary rebuilt online
   (timed) and every key read back; backup 0 fails, PUTs report one
   replica fewer and SCANs come from replica 1; backup 0 re-cloned
   (timed); a drain, then the parity audit: every replica holds exactly
   the hash's live items with equal addrs, the slot bitmap one slot per
   live item.  Every answer is checked against the model.
6. The backup probe against its plain version on the group as the
   primary's failure left it (Q = 16384, R = 2, the wrapped window), timed
   as in 4 and split by kernel (the window lookup against the finish) as
   the merge is; its bound also counts the window's hash inserts, the
   lanes' probes and the descent's compares at 67e12/s.
7. The distributed store: HiStoreClient(DistributedBackend(8, ...)), 8
   index groups of 2**21 slots on the card (2**24 in all) with the
   paper's config and lease detection off, launch counts set to 0 before
   it: 2**22 distinct keys loaded in 16384-key chunks (timed, retries
   counted), 8 mixed rounds (overwriting and fresh PUTs, DELETEs, GETs
   that meet the pending log windows, an apply, a GC round, 4 SCANs), a
   timed read-back of every key, a drain, then ``parity_report`` with
   its value-slot audit.  Every answer is checked against a model of its
   own; the group probe, hash probe, merge and search must each have
   been launched, the search once a SCAN (the stacked range query); the
   SCANs' host time per op is logged.
8. The hash probe, search and merge against their plain versions at the
   distributed path's shapes (one group: a 2**21-slot hash and replica,
   Q = 8 x 1024, the exchange buffer's width), timed, bounded and the
   merge split by kernel as in 4.  Then the distributed SCAN's one
   launch, ``ops.range_query_stacked``, on the live store's [R, G, 2**21]
   leaves read by strides, against ``range_query_stacked_plain``: every
   (group, replica) row's keys, addrs and count equal, at the 0-d bounds
   the client expands to [G] and at bounds of each group's own (the int32
   edges, lo > hi, lo past the last key); timed per call and on the device.
9. The group probe against its plain version as the distributed GET
   calls it: the last round's GET chunk routed as that GET routed it,
   one stacked call for the 8 servers' exchange buffers (8 x 8192 lanes,
   mostly key_inf padding, hashed on the card) against the state that
   GET read, each server's six halves equal to its per-server plain
   result; timed per call, on the device, routed (from the exchange
   buffers to the halves) and by kernel, with the share of the device
   time the split covers.  Then one group at
   Q = 16384 with replicas selected for about half the lanes, pending
   windows set to wrap the ring, q = 2**31 - 1 among the queries, timed
   as in 6 and split by kernel.
9b. The distributed store's failure handling (the phase 7 store has left
   the card): HiStoreClient(DistributedBackend(8, DEFAULT, 2**21,
   capacity_q=1024)), the paper's config as users run it (leases on,
   wall clock, 1.0 s), 2**21 keys loaded as in 7 (half of phase 7's
   load: 2**22 made the phase 45 s longer, 17-22 s of it a second load
   of phase 7's shape), launch counts set to 0 after the load, every
   answer checked against a model of its own.
   (1) Index server 3 fails (oracle): FailResult(3, True); a PUT chunk
   reports one replica fewer for groups 1 and 2 and full replication for
   the groups server 3 holds nothing of; a degraded read-back of every
   key (GET/s, the share with hops == 2); 4 degraded mixed rounds as in
   7, every SCAN complete; each degraded PUT and DELETE chunk launches
   the group probe exactly once per attempt.  (2) The group probe against
   its plain version on the last degraded GET chunk as routed (lanes of
   group 3 at server 4 selecting replica 0), every server's six halves
   equal, timed per call, on the device and routed (row 5's ``degraded``
   record; run before the recoveries, so the captured store leaves the
   card at once, its launches not counted and its seconds kept out of
   the phase's).  (3) recover_server(3) online, the rebuild, the
   re-replication pass and the migration timed apart (the client
   migrates only when told to in this phase); strays move home (moved >
   0) and a read-back finds every key in one hop.  (4) Data server 5
   fails: GETs of its shard come from the mirror (hops 2), PUTs to group
   5 land one hop on (shard 6); recover_data_server(5) with its sweep and
   the migration timed; a one-hop read-back.  (5) Adjacent servers 3 and
   4 fail: a SCAN reports group 2 missing (complete False) and returns
   the other groups' keys of its range; recover_server(3) rebuilds group
   2's copy from its hash and the data items' keys (the multi-failure
   fallback, its log left empty), then 4; a read-back; then replica 1 of
   group 2 on server 4 is set back to its copy from before the double
   failure (a stale copy: the protocol's own recoveries leave none), and
   recover_server(4) on the live server must re-replicate it (>= 1
   copy).  (6) sever_server(6) under continued GET traffic, no oracle
   call, severed right after a GET round: demoted by the wall-clock
   lease (the seconds from the sever and from the last heartbeat the
   client saw logged, the latter at least lease_timeout_s), detected ==
   [6], recovered; then sever_data_server(1) likewise, detected_data ==
   [1] and still detected == [6], a displaced PUT chunk, recovered.  (7)
   A drain and ``parity_report``: every entry and the value-slot audit
   agree, the live count equals the model's; a one-hop read-back.  The
   group probe, hash probe, merge and search must each have launched;
   the phase's seconds and peak memory are logged; every kernel record
   gets ``launches_dist_faults``.
9c. The distributed store over ranks, one process a rank
   (``repro_torch.launch.ranks.spawn``, ``core/comm.py``), at phase 7's
   config (8 groups of 2**21 slots, capacity_q 1024, leases off), its
   workload drawn from ``--seed``: a load of 2**21 keys (half phase 7's,
   to keep the script inside its time), 4
   mixed rounds (PUT, DELETE with absent keys, GET, apply, GC, 4 SCANs),
   a read-back, drain and ``parity_report``, index server 3 failed, 4
   degraded rounds, ``recover_server(3)`` (with the migration), a
   read-back, drain and ``parity_report``; every answer checked against
   the run's live set.  It runs first on one process (no process group),
   then over W ranks of NCCL, W the largest of 1, 2, 4, 8 no more than
   the cards (rank r on cuda:r; the kernels built once before the
   spawn); then, gloo taking CUDA tensors, over 4 gloo ranks sharing the
   card at a quarter of the load, against a one-process run of that
   load.  On every rank the sha256 of every answer, and on rank 0 of
   every leaf of the store gathered over the ranks, must equal the
   one-process run's; the hash probe, search, group probe and merge
   must launch on every rank.  Logged a rank: PUT/s, GET/s, SCAN ms,
   the collectives a PUT chunk, GET chunk and SCAN with their bytes,
   the host ms of one exchange, shift, all_gather and all-reduce call
   (synchronized), peak memory.  Every kernel record gets
   ``launches_dist_ranks`` (NCCL rank 0's).  Then, in the same spawns
   and against the same one-process runs, the data-plane and ticker
   segment on a store of its own (phase 7's groups, 2**19 keys, a
   quarter in the gloo run; leases on the rounds clock): data server 5
   fails (wiped), 2 degraded mixed rounds, ``recover_data_server(5)``
   (its shard from the mirror, the allocator's sweep, the migration), a
   read-back one hop a key; data server 2 severed, found by the
   detector, recovered; a read, then no foreground op while the
   wall-clock ticker finds index server 6 severed (within the lease
   timeout, an interval and 5 s of slack, no sooner than the timeout by
   each rank's clock), ``recover_server(6)``, a read-back, drain and
   ``parity_report``.  The answers, the detector's lists and the
   gathered leaves (but the heartbeat counters, which count the
   ticker's rounds) equal the one-process run's, and the four kernels
   launch on every rank.  Logged a rank: each recovery's seconds and
   collectives by kind with their bytes (``move`` the shard copies,
   ``to_owners`` the sweep's addresses), the ticker's detection seconds
   and rounds, peak memory; every kernel record gets
   ``launches_dist_ranks_faults`` (NCCL rank 0's).
10. The serving path of falcon-mamba-7b (configs/falcon_mamba_7b.py) at
    full width and depth in bf16, the weights drawn on the card from
    ``--seed`` (parameter count and peak memory logged): a warm-up
    prefill and the chunked ``ssm_impl="jnp"`` scan at S = 2048 (timed,
    information only); one sequence of prefill_32k (B = 1, S = 32768)
    through ``prefill`` with ``ssm_impl="pallas"``, the scan's launch
    count set to 0 before it and 64 after, finite logits, seconds and
    tokens/s; the scan kernel against its plain version on layer 0's
    inputs of that prefill (within one bf16 ulp of the plain value plus
    2e-5), timed as in 4, its bound the larger of its bytes and its
    exponentials at the SFU's rate (SMs x 16 a clock x the SM's maximum
    clock); one full-width Mamba1Block (layer 0) on the prefill's tokens
    under torch.profiler, its device time by operator;
    ``ServingEngine(4 slots, max_len 256, page 16)`` over 8 prompts of
    16-48 tokens and 2 of them again, 32 new tokens each, the
    directory's launch counts set to 0 before it: every request
    completes, prefix hits >= 2, every registered page freed by the
    release SCANs, the free list whole, the hash holding at most the
    prefix keys, the hash probe, search and merge launched; decode
    steps/s and tokens/s, and the seconds of the model's decode steps
    against the rest (the directory and the engine's bookkeeping).  Then prefill's last-position logits against
    the engine's decode logits after each first-wave prompt (fresh
    slots): logged at bf16 over 64 layers, checked within 5e-4 at
    float32 on a 4-layer model of the same widths.
11. Dense serving, the GQA family (phases 1-10 have left the card; the
    bytes they still hold are logged).
    (a) mistral-nemo-12b (configs/mistral_nemo_12b.py) at full width and
    depth in bf16, the weights drawn on the card from ``--seed``, its
    parameter count held to the one the config gives (12247782400) and
    the peak memory logged; a warm-up prefill at S = 2048; one sequence
    of prefill_32k (B = 1, S = 32768, the batch cut from 32 to 1)
    through ``prefill``: finite logits, seconds and tokens/s; one
    full-width AttnBlock (layer 0) on the prefill's tokens under
    torch.profiler, its device time by operator; the ServingEngine of
    phase 10 (4 slots, max_len 256, page 16) over phase 10's prompt set,
    held to phase 10's checks, the launch counts set to 0 before it: the
    directory must launch the hash probe, search and merge (every kernel
    record gets ``launches_serving_dense``), the scan none; decode
    steps/s and the model's share of the engine's time; prefill against
    the engine's decode logits at bf16 (information).  (b) gemma3-27b at
    full width, tied embeddings, the depth cut from 62 to 12 layers (two
    (local x 5, attn) periods): the same prefill of 32768 tokens, the
    local layers' sliding window at the published 1024: finite logits,
    seconds.  (c) float32, TF32 off: mistral-nemo at full width on 4
    layers in the engine over phase 10's prompts, the decode logits after
    each fresh-slot prompt against prefill's; gemma3 at full width on 6
    layers (5 local, 1 global), one 1280-token sequence decoded step by
    step through ``decode_step`` (every local ring of 1024 wraps; q and kv
    blocks of 256, since 1280 is not a multiple of 512), the decode
    logits at the last 8 positions against the prefill's there; both
    within CROSS_TOL.  Each model leaves the card before the next.
12. The hybrid and MoE families (the earlier phases have left the card;
    the bytes they still hold are logged), bf16, the weights drawn on the
    card from ``--seed``, each model off the card before the next.
    (a) zamba2-7b (Mamba-2 with the weight-tied shared block after every
    6th layer) and (b) deepseek-v2-lite-16b (MLA, 64 routed experts
    top-6 and 2 shared) at full width and depth, their parameter counts
    held to JAX's (7309292112 and 15708450304): a warm-up prefill at
    S = 2048, one sequence of prefill_32k (B = 1, S = 32768): finite
    logits, seconds, tokens/s, peak memory and the routed slots the MoE
    capacity drops; zamba2's first Mamba2Block and first shared layer,
    deepseek's first MoE layer, by operator (torch.profiler); phase 10's
    engine run over phase 10's prompt set, held to phase 10's checks (the
    directory must launch the hash probe, search and merge: every kernel
    record gets ``launches_serving_hybrid`` and ``launches_serving_moe``;
    the scan none), decode steps/s and the model's share of the engine's
    time.  (c) kimi-k2-1t-a32b at full width on 2 of 61 layers (the
    dense layer 0 and one MoE layer of 384 experts, top-8; 19923635200
    parameters): the same prefill (16384 tokens if 32768 do not fit).
    (d) float32, TF32 off: the engine's decode logits after each
    fresh-slot prompt against prefill's within CROSS_TOL, zamba2 on 6
    layers (five mamba2, one mamba2+shared) and deepseek on 3 (the dense
    MLA layer and two MoE layers, capacity_factor n_experts / top_k, so
    that prefill drops no slot).
13. Training (the earlier phases have left the card), TF32 off.  (a)
    musicgen-large at full width and depth in bf16 (3229812736
    parameters, held to JAX's count), weights drawn on the card from
    ``--seed``, ``SyntheticLM(2048, 4096, 8, seed)``: train_4k's batch of
    256 cut to 8, the largest that fits; 3 steps of ``train_step`` at lr
    3e-4, the kernels' launch counts set to 0 before them (no kernel
    lies on the training path: every record gets ``launches_training``);
    loss and grad norm finite at every step, step 0's loss within 1.5 of
    ln 2048; seconds a step, tokens/s, the model-FLOPs share of 989.4
    TFLOP/s and the peak memory beside the 38.8 GB of state; whether a
    batch of 9 would fit (one forward and backward, logged); the last
    step split into the forward, the backward (with each layer's
    recompute) and the AdamW update, by CUDA events, with each part's
    top operators (torch.profiler).  (b) tiny musicgen-large in float32,
    the same weights and batches on the CPU and the card, 2 steps: loss
    and grad norm within 1e-4, every parameter within ``params_agree``.
    (c) examples/train_lm_torch.py's default size: a crash at step 3
    after a checkpoint at 2, the resume to 6 (its history from step 2),
    the parameters against an uninterrupted run's, whose loss must fall
    below step 0's; the checkpoints in a temporary directory.
14. The tools (TF32 off; the kernels' launch counts set to 0 before it:
    every record gets ``launches_tools``, expected 0).  (a) The dry run,
    ``repro_torch.launch.dryrun`` over every (arch x shape) cell on the
    one-card mesh, on the meta device (nothing allocated), a worker
    process a CPU core: 33 cells ok, 7 skipped, 0 errors; a line a cell
    (compute_s, memory_s, dominant, state GiB, fits) and the wall time.
    (b) Phase 13's measured musicgen-large step beside the dry run's
    compute term for the same cell cut to batch 8 (GEMM FLOPs over
    989.4 TFLOP/s), the measured step over it, and phase 13's model-FLOPs
    share (``model_flops``).  (c) The GPipe pipeline
    (``train/pipeline.py``) at full width: S = 4 stages, each one
    musicgen-large AttnBlock (d_model 2048, 32 heads, d_ff 8192), M = 8
    microbatches of one sequence of PIPE_SEQ tokens; in float32 the
    pipelined output and every parameter gradient against serial
    application within PIPE_RTOL (relative to each tensor's largest
    magnitude); in bf16 the max abs error logged; the pipelined and the
    serial step (forward and backward) timed by CUDA events at both
    dtypes, the peak memory logged.  (d) ``train/elastic_selftest.py``
    on the card (ELASTIC-SELFTEST-OK).
15. Training over ranks (``train/dp.py``: one process a rank over
    ``torch.distributed``; TF32 off; the kernels' launch counts set to 0
    in every rank process and here: every record gets
    ``launches_training_ranks``, expected 0).  First, here: (a)'s, (b)'s
    and (b')'s one-process references and (d)'s stacked reference.  Then
    4 gloo ranks sharing the card (``rank_gloo``):
    (b) musicgen-large at full width on 4 of 48 layers (cut:
    276842496 parameters, about 2.8 GB of checkpointed state), global
    batch 2 x 4096 (train_4k's 256 cut to 2), 3 steps over ranks 0-1
    from ``--seed`` with a checkpoint at step 2: each step's loss and
    grad norm within 1e-3 (relative) of the one-process run of the same
    batch; each rank's m and v bytes as ``opt_pspecs`` plans, at most
    half of the one-process run's plus the leaves that fall back to
    whole.  (b') At the same time over ranks 2-3, deepseek-v2-lite-16b
    at full width on 2 of 27 layers (cut: the dense first layer and one
    MoE layer of 64 experts, top 6), float32 (cut from bf16, so that the
    ranks and one process route the same tokens), global batch 2 x 1024
    (a row a rank), 2 steps: the MoE's global statistics, capacity and
    slot ranks over gloo on CUDA tensors, where autograd runs the
    backward, and so each checkpointed layer's recompute with its
    collectives, on a thread of its own; each step's loss and grad norm
    within 1e-4 of one process.  (c) The pipeline with one stage a rank
    at phase 14's width (4 musicgen-large AttnBlocks, 8 microbatches of
    1024 tokens, float32): rank 0 runs the stacked ``pipeline_apply``
    and broadcasts each stage's reference; every rank's outputs,
    gradients and one SGD step's parameters within phase 14's PIPE_RTOL;
    seconds beside the stacked step's.  (d) The compressed all-reduce, one AttnBlock's
    gradients a rank (67112960 elements): bit-equal (sha256) to the
    stacked version; seconds and bytes (the int32 payload).  (The
    elastic self-test over the 4 ranks is phase 16's (d), in the same
    spawn.)  Then W = the card count NCCL ranks (``rank_nccl``; 1 here):
    (a) musicgen-large at full width on RANKS_FULL_LAYERS (8) of its 48
    layers, bf16, batch 8 x 4096 from ``--seed``, 2 steps: losses and
    grad norms bit-equal to the one-process run of the same depth at
    W = 1 (within 2e-3 relative over more cards), peak under 79 GiB,
    seconds a step, the gradient all-reduce's bytes and seconds a step;
    then (b)'s step-2 checkpoint resumed on rank 0 alone (the elastic
    move 2 -> 1): its step within 1e-3 of the gloo run's.
16. The mesh's model axis over ranks (``train/dp.Ranks``: rank r at data
    index r // m and model index r % m; tensor parallelism,
    ``sharding/tp.py``), on the same 4 gloo ranks after phase 15's parts
    (TF32 off; the kernels' counts set to 0 there and here: every record
    gets ``launches_model_axis``, expected 0; phase 16 takes at most
    MA_BUDGET_S seconds, its one-process reference included).  Its lines
    start "ranks-model:".  (a) musicgen-large at full width on 4 layers,
    float32, batch 2 x 1024, 2 steps on (2 data x 2 model) and (1 x 2):
    each step's loss and grad norm within 1e-4 (relative) of one process
    on the card; each rank's parameter bytes against the whole's; the
    model group's all-reduces.  (b) deepseek-v2-lite-16b at full width on
    2 layers (phase 15's (b')) on (2 x 2), the experts cut over model:
    within 1e-4 of one process (phase 15's reference), the kept slots of
    every dispatch plan equal to one process's.  (c) Under ``use_mesh`` on
    (2 x 2): deepseek's ``moe_impl="smap"`` ``moe_apply`` at full width
    within 1e-5 (relative) of ``smap_stacked``; mistral-nemo-12b at full
    width on 2 layers, float32, 4 decode steps of batch 4 with
    ``decode_cache_hint`` (each GQA cache's 64 slots cut to 32 a rank)
    within 2e-4 + 2e-4 x |plain| of the whole model's plain decode.  (d)
    The elastic self-test's checks over the 4 ranks (``run_ranks``, what
    ``elastic_selftest --ranks 4 --backend gloo`` runs: (2 x 2) -> (1 x 4),
    smap and the hint on (2 x 2)).
17. The rest of the mesh's data axis over ranks (FSDP,
    ``sharding/fsdp.py``: the parameters cut over data beside the model
    cut and gathered a layer at a time; the sequence cut over data at a
    global batch of 1), on the same 4 gloo ranks after phase 16 (TF32
    off; the kernels' counts set to 0 there and here: every record gets
    ``launches_data_axis``, expected 0; phase 17 takes at most
    DA_BUDGET_S seconds, its one-process references included, which
    run here first, each freed before the spawn).  Its lines start
    "ranks-data:".  (a) kimi-k2-1t-a32b at full width on its dense
    layer 0 (2833273856 parameters; its MoE layer cannot hold a training
    state on one card), bf16, fsdp from its config, batch 1 x 4096 on
    (2 data x 2 model): FSDP, the tensor cut and the sequence cut at
    once; 2 steps, each loss and grad norm within 1e-3 (relative) of
    one process; each rank's held parameter bytes against the whole,
    its peak, the data group's gathered and reduce-scattered bytes a
    step (``DP.stats``).  (b) The sequence cut of the Mamba families,
    float32, batch 1 x 4096 on (4 x 1): falcon-mamba-7b on 2 of 64
    layers and zamba2-7b on 6 (five Mamba-2 layers and the shared block
    once), each within 1e-4 of one process.  (c) Phase 16 (b)'s
    deepseek run again with fsdp=True: within 1e-5 of 16 (b)'s history
    (the same global step), the kept slots equal, each rank's parameter
    bytes below 16 (b)'s.
18. The store on int64 keys (the JAX package's x64 deployment), a
    generator of its own from ``--seed``: HiStoreClient(LocalBackend(
    2**24, DEFAULT, key_dtype=torch.int64)) on the card, ``--keys``
    distinct keys from [0, 2**62) loaded, phase 3's 8 mixed rounds (4
    SCANs of limit 128 each, spans drawn below 2**47, which holds about
    256 of the keys), a
    read-back; 2 chunks written and left pending, the primary failed,
    a degraded read-back of every key, 2 degraded rounds, the online
    rebuild, a read-back; every answer checked against a sorted-array
    model.  The launch counts are set to 0 before it, and the four int64
    entries' (``hash_probe_i64``, ``sorted_search_i64``, ``merge_i64``,
    ``backup_probe_i64``) must be > 0 after, the int32 ones' 0.  Each
    int64 entry against its plain version on the loaded state (and the
    backup probe on the group as the failure left it), timed and bounded
    at 8 B keys as in 4 and 6, beside the int32 entry's figures of this
    run.  Then falcon-mamba-7b at full width on 2 of 64 layers (bf16) in
    a ServingEngine with int32 keys and one with int64 keys over phase
    10's kind of prompt set: equal stats and tokens, the int64
    directory launching only the int64 entries and holding a key past
    2**31.  Its lines start "keys64:".
19. The last two lines: the kernels as JSON (the ten records in the
    order of PERF.md's kernel table, then the four int64 entries'), then
    the device as JSON.

Exits nonzero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline.analysis import HW  # noqa: E402

HBM_BYTES_PER_S = HW.hbm_bw      # H100 SXM HBM3, NVIDIA's data sheet
# the data sheet's float32 rate outside the tensor cores; it has no int32
# row, and the card's int32 rate is not above it, so the compare bound it
# gives is a lower bound on the time
SCALAR_OPS_PER_S = 67e12
CAPACITY = 1 << 24
ROUNDS = 8                       # mixed rounds after the load
DEGRADED_ROUNDS = 4              # mixed rounds with the primary dead
CHUNK = 16384                    # the client's max_batch: one chunk per op
SCANS = 4                        # SCANs per mixed round
FAIL_FRESH = 4 * CHUNK           # fresh keys the fail/recover phase writes
MAIN_KERNELS = ("hash_probe", "sorted_search", "merge")
FAIL_KERNELS = MAIN_KERNELS + ("backup_probe",)
DIST_GROUPS = 8                  # index groups of the distributed phase
DIST_CAPACITY = CAPACITY // DIST_GROUPS   # slots per group
DIST_CAPACITY_Q = 1024           # exchange slots per destination: a
#                                  16384-key chunk sends ~256 per pair
DIST_KEYS = 1 << 22               # distinct keys the distributed store loads
DIST_KERNELS = ("group_probe", "hash_probe", "merge", "sorted_search")
FAULT_KEYS = 1 << 21             # distinct keys the phase 9b store loads
FAULT_DIST_FRESH = 8 * CHUNK     # fresh keys phase 9b writes after the load
FUSED = "src/repro/kernels/_fused.py"
LEGACY = "src/repro/kernels"
DISPATCH_KERNELS = ("legacy_hash_probe", "legacy_sorted_search",
                    "sort_stable", "bitonic_sort")
# [R, T] of the sorts: the distributed store's 8 groups x 2 replicas of one
# 4096-entry apply batch; one client chunk (the largest shared-memory
# row); one 65536-entry backup-log ring (the global passes)
SORT_SHAPES = ((16, 4096), (1, 16384), (1, 65536))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg):
    print(msg, flush=True)


class Model:
    """The reference: a sorted array of every key the run may touch,
    with a live mask and the values — a dict + sorted list in arrays."""

    def __init__(self, keys, words):
        self.keys = np.sort(keys)
        self.live = np.zeros(len(self.keys), bool)
        self.vals = np.zeros((len(self.keys), words), np.int32)

    def at(self, keys):
        i = np.searchsorted(self.keys, keys)
        check(np.array_equal(self.keys[i], keys), "model key lookup")
        return i

    def put(self, keys, vals):
        i = self.at(keys)
        self.live[i] = True
        self.vals[i] = vals

    def delete(self, keys):
        self.live[self.at(keys)] = False

    def _find(self, keys):
        i = np.minimum(np.searchsorted(self.keys, keys), len(self.keys) - 1)
        return self.keys[i] == keys, i

    def known(self, keys):
        return self._find(keys)[0]

    def is_live(self, keys):
        hit, i = self._find(keys)
        return hit & self.live[i], i

    def scan(self, lo, hi, limit):
        a = np.searchsorted(self.keys, lo, side="left")
        b = np.searchsorted(self.keys, hi, side="right")
        ks = self.keys[a:b][self.live[a:b]]
        return ks[:limit]


def time_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters, sleep_cycles=int(3e8)):
    """Device time per call of ``fn``: its launches are queued behind a
    GPU sleep, so they run back to back and the host's time between them
    is hidden.  Checks that the host queued them all within the sleep."""
    fn()
    torch.cuda.synchronize()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    torch.cuda._sleep(sleep_cycles)
    e[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    e[2].record()
    torch.cuda.synchronize()
    check(host_ms < e[0].elapsed_time(e[1]),
          f"device_ms: queueing took {host_ms:.3f} ms, longer than the sleep")
    return e[1].elapsed_time(e[2]) / iters


def kernel_split(torch, fn, label, iters=5):
    """The device time of each kernel that one call of ``fn`` launches, by
    name: ``fn`` runs ``iters`` times under torch.profiler (CUDA activity)
    after a warm-up.  Returns {kernel: ms per call} and logs it; {} when
    the profiler records no device time in 3 tries (then the caller's
    whole-call device time is all there is).  A kernel launched with
    programmatic dependent launch starts before the one before it ends
    and waits, so its time includes that wait and the split can sum to
    more than the call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    split = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].split("::")[-1]
                split[name] = split.get(name, 0.0) + us / 1e3 / iters
        if split:
            break
    if split:
        log(f"{label} by kernel (torch.profiler, ms per call): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; sum {sum(split.values()):.4f}")
    else:
        log(f"{label}: torch.profiler recorded no device time in 3 tries; "
            f"the call is timed whole")
    return split


def max_abs_err(torch, got, want, label):
    err = 0
    for i, (x, y) in enumerate(zip(got, want)):
        check(x.shape == y.shape, f"{label}: output {i} shape")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        e = int(d.max()) if d.numel() else 0
        check(e == 0, f"{label}: output {i} differs from the plain version "
                      f"(max abs err {e})")
        err = max(err, e)
    return float(err)


class Workload:
    """The client under test, the model it is checked against, and the
    seeded draws of keys and values both phases use."""

    def __init__(self, torch, client, model, rng, fresh, key_hi=2 ** 31 - 1,
                 scan_span=2 ** 16):
        self.torch = torch
        self.client = client
        self.model = model
        self.rng = rng
        self.fresh = fresh           # drawn keys not yet written
        self.W = model.vals.shape[1]
        self.key_hi = key_hi         # keys are drawn from [0, key_hi)
        self.scan_span = scan_span   # a SCAN's hi - lo is below it

    def take_fresh(self, n):
        check(len(self.fresh) >= n, "out of fresh keys")
        out, self.fresh = self.fresh[:n], self.fresh[n:]
        return out

    def absent(self, n):
        kd = self.model.keys.dtype
        out = np.empty(0, kd)
        while len(out) < n:
            c = self.rng.integers(0, self.key_hi, 2 * n).astype(kd)
            out = np.concatenate([out, c[~self.model.known(c)]])
        return out[:n]

    def sample(self, keys, n):
        """n distinct entries of ``keys`` (a full permutation of 8 M keys,
        as rng.choice(replace=False) makes, costs about a second)."""
        i = np.unique(self.rng.integers(0, len(keys), 2 * n))
        check(len(i) >= n, "sample: not enough distinct draws")
        return keys[self.rng.permutation(i)[:n]]

    def new_vals(self, n):
        return self.rng.integers(1, 2 ** 31 - 1, (n, self.W)).astype(np.int32)

    def live_keys(self):
        return self.model.keys[self.model.live]

    def get_mix(self, B, extra=None):
        """B GET keys: live, deleted and never-written keys (and
        ``extra`` keys, a quarter, when given), shuffled."""
        m = self.model
        dead_keys = m.keys[~m.live]
        parts = [self.rng.choice(self.live_keys(), B // 2 if extra is None
                                 else B // 4)]
        if extra is not None:
            parts.append(self.rng.choice(extra, B // 4))
        parts.append(self.rng.choice(dead_keys, B // 4) if len(dead_keys)
                     else self.absent(B // 4))
        g = np.concatenate(parts)
        g = np.concatenate([g, self.absent(B - len(g))])
        self.rng.shuffle(g)
        return g

    def check_get(self, keys, label):
        return self.check_answers(self.client.get(keys), keys, label)

    def check_answers(self, r, keys, label):
        """Hold a GetResult for ``keys`` to the model; returns the live
        hits."""
        want_found, i = self.model.is_live(keys)
        found = r.found.cpu().numpy()
        check(np.array_equal(found, want_found),
              f"{label}: found differs on {(found != want_found).sum()} keys")
        vals = r.values.cpu().numpy()
        check(np.array_equal(vals[found], self.model.vals[i[found]]),
              f"{label}: values differ")
        check(not vals[~found].any(), f"{label}: values on a miss")
        return int(found.sum())

    def put(self, keys, label, replicas=None):
        vals = self.new_vals(len(keys))
        r = self.client.put(keys, vals)
        check(bool(r.ok.all()), f"{label}: PUT not acknowledged")
        if replicas is not None:
            check(bool((r.replicas == replicas).all()),
                  f"{label}: PUT replicas != {replicas}")
        self.model.put(keys, vals)

    def delete(self, keys, label):
        want, _ = self.model.is_live(keys)
        r = self.client.delete(keys)
        check(bool(r.ok.all()), f"{label}: DELETE not acknowledged")
        check(np.array_equal(r.found.cpu().numpy(), want),
              f"{label}: DELETE found differs")
        self.model.delete(keys[want])
        return int(want.sum())

    def scan(self, label):
        lo = int(self.rng.choice(self.model.keys))
        hi = lo + int(self.rng.integers(1, self.scan_span))
        s = self.client.scan(lo, hi, 128)
        check(s.complete is not False, f"{label}: SCAN missed groups "
              f"{s.missing_groups}")
        n = int(s.count)
        want_keys = self.model.scan(lo, hi, 128)
        check(n == len(want_keys) and np.array_equal(
            s.keys[:n].cpu().numpy(), want_keys),
            f"{label}: SCAN [{lo}, {hi}] differs")
        return n

    def read_back(self, label):
        """GET every key the run drew; returns (live hits, seconds)."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = self.check_get(self.model.keys, label)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        check(hits == int(self.model.live.sum()), f"{label}: hit count")
        return hits, t


def zero_launches(ops):
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0


def main_path(torch, args, cfg, rng):
    from repro_torch.core.client import HiStoreClient, LocalBackend
    from repro_torch.kernels import ops

    n_load = args.keys
    n_fresh = ROUNDS * CHUNK // 2 + FAIL_FRESH
    need = n_load + n_fresh
    uniq = np.unique(rng.integers(0, 2 ** 31 - 1, int(need * 1.02) + 1024))
    check(len(uniq) >= need, "not enough distinct keys drawn")
    keys_all = uniq[rng.permutation(len(uniq))[:need]].astype(np.int32)
    load_keys = keys_all[:n_load]
    model = Model(keys_all, cfg.value_words)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = LocalBackend(CAPACITY, cfg, device="cuda")
    client = HiStoreClient(backend)
    torch.cuda.synchronize()
    log(f"main: LocalBackend({CAPACITY}) created in "
        f"{time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated")
    wl = Workload(torch, client, model, rng, keys_all[n_load:])
    zero_launches(ops)

    # -- load ------------------------------------------------------------
    t0 = time.perf_counter()
    vals = wl.new_vals(n_load)
    r = client.put(load_keys, vals)
    ok = r.ok.cpu().numpy()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(ok.all(), f"load: {(~ok).sum()} PUTs not acknowledged")
    model.put(load_keys, vals)
    log(f"main: loaded {n_load} keys in {t_load:.3f} s "
        f"({n_load / t_load:.0f} PUT/s, retries {r.retries})")

    # -- mixed rounds: one client chunk of each op per round ---------------
    B = CHUNK
    check(client.max_batch == B, f"client chunk {client.max_batch}")
    t0 = time.perf_counter()
    stats = mixed_rounds(wl, ROUNDS, "round")
    torch.cuda.synchronize()
    t_mixed = time.perf_counter() - t0

    # -- every acknowledged write reads back -------------------------------
    hits, t_read = wl.read_back("final read-back")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"main: {ROUNDS} mixed rounds in {t_mixed:.3f} s: {stats}")
    log(f"main: read back {len(model.keys)} keys ({hits} live) in "
        f"{t_read:.3f} s ({len(model.keys) / t_read:.0f} GET/s)")
    log(f"main: launches {launches}")
    log(f"main: torch.cuda.max_memory_allocated() = {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    for k in MAIN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
    log_metrics(client, "main")
    return wl, launches


def mixed_rounds(wl, rounds, label):
    """``rounds`` mixed rounds of one client chunk of each op: GETs (hits,
    deleted keys and misses), overwriting and fresh PUTs, DELETEs (a
    quarter of them misses), an async apply and SCANS SCANs, every answer
    checked against the model.  Returns the counts."""
    B = CHUNK
    stats = {"get_hits": 0, "gets": 0, "puts": 0, "deletes": 0,
             "deleted_found": 0, "scans": 0, "scanned": 0}
    for rnd in range(rounds):
        g = wl.get_mix(B)
        stats["get_hits"] += wl.check_get(g, f"{label} {rnd} GET")
        stats["gets"] += len(g)
        p = np.concatenate([wl.sample(wl.live_keys(), B // 2),
                            wl.take_fresh(B // 2)])
        wl.put(p, f"{label} {rnd}")
        stats["puts"] += len(p)
        d = np.concatenate([wl.sample(wl.live_keys(), 3 * B // 16),
                            wl.absent(B // 16)])
        wl.rng.shuffle(d)
        stats["deleted_found"] += wl.delete(d, f"{label} {rnd}")
        stats["deletes"] += len(d)
        wl.client.apply()
        for _ in range(SCANS):
            stats["scanned"] += wl.scan(f"{label} {rnd}")
            stats["scans"] += 1
        wl.check_get(d, f"{label} {rnd} GET after DELETE")
    return stats


def degraded_rounds(wl, rounds, label):
    """``rounds`` mixed rounds while the primary is down: PUTs, DELETEs,
    GETs that meet this round's writes, an apply and SCANS SCANs."""
    B = CHUNK
    for rnd in range(rounds):
        p = np.concatenate([wl.sample(wl.live_keys(), B // 2),
                            wl.take_fresh(B // 2)])
        wl.put(p, f"{label} {rnd}")
        d = np.concatenate([wl.sample(wl.live_keys(), 3 * B // 16),
                            wl.absent(B // 16)])
        wl.rng.shuffle(d)
        wl.delete(d, f"{label} {rnd}")
        wl.check_get(wl.get_mix(B, extra=np.concatenate([p, d])),
                     f"{label} {rnd} GET")
        wl.client.apply()
        for _ in range(SCANS):
            wl.scan(f"{label} {rnd}")
        wl.check_get(d, f"{label} {rnd} GET after DELETE")


def log_metrics(client, label):
    m = client.metrics()
    log(f"{label}: telemetry {json.dumps(m.counters, sort_keys=True)} "
        f"gauges {json.dumps(m.gauges, sort_keys=True)}")
    for op, lat in sorted(m.latency.items()):
        log(f"{label}: latency {op}: {lat.count} calls, mean "
            f"{lat.mean * 1e3:.3f} ms, p50 <= {lat.p50 * 1e3:.3f} ms, "
            f"p99 <= {lat.p99 * 1e3:.3f} ms, max {lat.max * 1e3:.3f} ms")


def fail_recover(torch, wl, cfg):
    """The failure and recovery path on the loaded store: the primary
    dies with a wrapped pending window, degraded rounds, online rebuild;
    a backup dies, degraded writes and SCANs, re-clone; then the parity
    audit.  Returns (the group right after the primary failed, the keys
    of its pending window, launches, timings)."""
    from repro_torch.core import hash_index as hix
    from repro_torch.core import index_group as ig
    from repro_torch.core import log as lg
    from repro_torch.core import sorted_index as six
    from repro_torch.kernels import ops

    client, model, rng = wl.client, wl.model, wl.rng
    backend = client.backend
    B = CHUNK
    lcap = cfg.log_capacity
    nb = cfg.n_backups
    zero_launches(ops)
    t_phase = time.perf_counter()

    # 1. a pending window of 2 chunks that straddles the end of the ring
    client.drain()
    while int(backend.group.blogs[0].applied) % lcap <= lcap - 2 * B:
        wl.put(wl.sample(wl.live_keys(), B), "align the ring")
        client.drain()
    window = np.concatenate([wl.sample(wl.live_keys(), B // 2),
                             wl.take_fresh(B // 2),
                             wl.sample(wl.live_keys(), B // 2),
                             wl.take_fresh(B // 2)])
    wl.put(window[:B], "window chunk 0")
    wl.put(window[B:], "window chunk 1")
    blog = backend.group.blogs[0]
    applied, tail = int(blog.applied), int(blog.tail)
    check(tail - applied == 2 * B and applied % lcap + 2 * B > lcap,
          f"window [{applied}, {tail}) does not wrap the ring of {lcap}")
    client.fail_server(0)
    failed_group = backend.group
    gauges = client.metrics().gauges
    check(gauges["live_index_servers"] == nb, f"gauges {gauges}")
    log(f"fail: primary failed with backup window [{applied}, {tail}) "
        f"in a ring of {lcap}")

    # 2. degraded: read-back of every key, then mixed rounds
    hits, t_deg = wl.read_back("degraded read-back")
    log(f"fail: degraded read-back of {len(model.keys)} keys ({hits} live)"
        f" in {t_deg:.3f} s ({len(model.keys) / t_deg:.0f} GET/s)")
    t0 = time.perf_counter()
    degraded_rounds(wl, DEGRADED_ROUNDS, "degraded round")
    # a pending window for the online rebuild to replay
    wl.put(np.concatenate([wl.sample(wl.live_keys(), B // 2),
                           wl.take_fresh(B // 2)]), "before recovery")
    wl.delete(wl.sample(wl.live_keys(), B // 8), "before recovery")
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t0
    pend = ig.pending_max(backend.group)
    check(pend > 0, "no pending window before the rebuild")

    # 3. online rebuild of the primary
    t0 = time.perf_counter()
    client.recover_server(0)
    torch.cuda.synchronize()
    t_rec0 = time.perf_counter() - t0
    hits, t_read0 = wl.read_back("read-back after the rebuild")
    log(f"recover: primary rebuilt online in {t_rec0:.3f} s "
        f"({int(hix.n_items(backend.group.hash))} items, {pend} pending "
        f"replayed); read back {len(model.keys)} keys in {t_read0:.3f} s")

    # 4. backup 0 dies: PUTs reach one replica fewer, SCANs use replica 1
    client.fail_server(1)
    p = np.concatenate([wl.sample(wl.live_keys(), B // 2),
                        wl.take_fresh(B // 2)])
    wl.put(p, "backup 0 down", replicas=nb - 1)
    d = wl.sample(wl.live_keys(), B // 4)
    wl.delete(d, "backup 0 down")
    for _ in range(SCANS):
        wl.scan("backup 0 down")
    wl.check_get(wl.get_mix(B, extra=np.concatenate([p, d])),
                 "backup 0 down GET")

    # 5. re-clone backup 0, then drain
    t0 = time.perf_counter()
    client.recover_server(1)
    torch.cuda.synchronize()
    t_rec1 = time.perf_counter() - t0
    client.drain()
    torch.cuda.synchronize()
    t_phase = time.perf_counter() - t_phase
    launches = dict(ops.LAUNCHES)
    log(f"recover: backup 0 re-cloned online in {t_rec1:.3f} s; "
        f"{DEGRADED_ROUNDS} degraded rounds in {t_rounds:.3f} s; "
        f"phase {t_phase:.3f} s; launches {launches}")
    for k in FAIL_KERNELS:
        check(launches[k] > 0,
              f"kernel {k} was not launched on the fail/recover path")
    log_metrics(client, "fail")

    # 6. parity: every replica holds exactly the hash's live items with
    # equal addrs; the slot bitmap holds one slot per live item
    g = backend.group
    mask = hix.valid_mask(g.hash)
    n_hash = int(mask.sum())
    for r, srt in enumerate(g.sorted):
        keys, addrs, valid = six.items(srt)
        n = int(valid.sum())
        check(n == n_hash, f"parity: replica {r} holds {n}, hash {n_hash}")
        a_h, f_h, _ = ops.probe(cfg, g.hash, keys[valid])
        check(bool(f_h.all()) and torch.equal(a_h, addrs[valid]),
              f"parity: replica {r} disagrees with the hash")
        check(int(lg.pending_count(g.blogs[r])) == 0, "parity: not drained")
    addrs = g.hash.addr[mask]
    used = backend.used
    check(int(used.sum()) == n_hash
          and int(torch.unique(addrs).numel()) == n_hash
          and bool(used[addrs.long()].all()),
          "parity: the slot bitmap disagrees with the live items")
    check(n_hash == int(model.live.sum()), "parity: live count != model")
    log(f"parity: {nb} replicas and the slot bitmap agree with the hash "
        f"({n_hash} live items)")
    times = dict(degraded_get_per_s=len(model.keys) / t_deg,
                 degraded_read_s=t_deg, recover_primary_s=t_rec0,
                 recover_backup_s=t_rec1, degraded_rounds_s=t_rounds)
    return failed_group, window, launches, times


def key_width(torch, keys):
    """(numpy dtype, bytes a key, the launch-count suffix, key_inf) of a
    state's key tensor: int32 or int64 (phase 18)."""
    if keys.dtype == torch.int64:
        return np.int64, 8, "_i64", 2 ** 63 - 1
    return np.int32, 4, "", 2 ** 31 - 1


def compare_kernels(torch, cfg, hidx, srt, live, dead, rng, Q, label,
                    key_hi=2 ** 31 - 1):
    """The hash probe, the search and the merge against their plain
    versions on one group's hash ``hidx`` and sorted replica ``srt`` (the
    probe at Q queries: live, dead and random keys from [0, key_hi); the
    search at Q = 1, a SCAN's lower bound, and at Q; the merge of one
    4096-entry apply batch), each timed, at the width of ``srt``'s keys
    (the int64 entries' records are named with ``_i64``).  Returns one
    record per kernel."""
    from repro_torch.core import hash_index as hix
    from repro_torch.core import sorted_index as six
    from repro_torch.kernels import ops

    dev = hidx.sig.device
    npk, kb, sfx, _ = key_width(torch, srt.keys)
    out = []

    # -- hash probe: the kernel takes the keys and hashes them --------------
    q = np.concatenate([rng.choice(live, Q // 2), rng.choice(dead, Q // 4),
                        rng.integers(0, key_hi, Q - Q // 2 - Q // 4)])
    qt = torch.as_tensor(q.astype(npk), device=dev)
    tomb = int((hidx.sig == hix.TOMBSTONE).sum())
    want = hix.lookup(hidx, qt, cfg)
    err = max_abs_err(torch, ops.probe(cfg, hidx, qt), want,
                      f"{label} hash_probe routed")

    def kern():
        return ops.hash_probe_cuda(qt, *hidx, cfg.slots_per_bucket)

    got = kern()
    err = max(err, max_abs_err(torch, (got[0], got[1].bool(), got[2]), want,
                               f"{label} hash_probe"))
    ms = time_ms(torch, kern, 200)
    dev_ms = device_ms(torch, kern, 200)
    plain = time_ms(torch, lambda: hix.lookup(hidx, qt, cfg), 50)
    routed = time_ms(torch, lambda: ops.probe(cfg, hidx, qt), 200)
    routed_dev = device_ms(torch, lambda: ops.probe(cfg, hidx, qt), 200)
    cs = hidx.sig.shape[1]
    # the key in, 3 outputs, the sig and fp rows, one addr, one fill; the
    # kernel before took 3 descriptors (12 B) in place of the key
    nbytes = Q * (kb + 12 + 2 * cs * 4 + 8)
    nbytes_desc = Q * (12 + 12 + 2 * cs * 4 + 8)
    log(f"kernel hash_probe{sfx} ({label}): Q={Q}, table "
        f"[{hidx.sig.shape[0]}, "
        f"{cs}] with {tomb} tombstones, keys hashed on the card: equal; "
        f"kernel {ms:.4f} ms per call, device {dev_ms:.4f} ms; routed "
        f"ops.probe {routed:.4f} ms per call, device {routed_dev:.4f} ms; "
        f"plain (hix.lookup, hashing included) {plain:.4f} ms; bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} B; with "
        f"descriptors in, as the kernel took them before, "
        f"{nbytes_desc / HBM_BYTES_PER_S * 1e3:.6f} ms for {nbytes_desc} B)")
    out.append(dict(name="hash_probe" + sfx, route="cuda",
                    source="src/repro_torch/kernels/csrc/hash_probe.cu",
                    replaces=f"{FUSED}:204", max_abs_err=err, ms=ms,
                    plain_ms=plain,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, device_ms=dev_ms,
                    routed_ms=routed, routed_device_ms=routed_dev,
                    bound_descriptors_in_ms=nbytes_desc / HBM_BYTES_PER_S
                    * 1e3, Q=Q))

    # -- sorted search: Q = 1 and Q; the SCAN's range at Q = 1 --------------
    # Latency: the dependent rounds the function needs (search_rounds) x
    # one round's device time (round_slope).  Beside it, the parent's
    # figure: levels x the slope a level between this index and a
    # one-level index (its first fanout keys).
    cap = srt.keys.shape[0]
    levels = six.directory_levels(cap, cfg.fanout)
    rounds = search_rounds(cap, cfg.fanout)
    res = {}
    for QS in (1, Q):
        sq = np.concatenate([rng.choice(live, QS - QS // 2),
                             rng.integers(0, key_hi, QS // 2)])
        sqt = torch.as_tensor(sq.astype(npk), device=dev)
        got = ops.sorted_search_cuda(sqt, srt.keys, srt.addrs, cfg.fanout)
        want_lb = torch.searchsorted(srt.keys, sqt).to(torch.int32)
        err = max_abs_err(torch, (got[0], got[1].bool(), got[2], got[4]),
                          (*six.search(srt, sqt, cfg.fanout), want_lb),
                          f"{label} sorted_search{sfx} Q={QS}")
        iters = 500 if QS == 1 else 100

        def kern(keys=srt.keys, addrs=srt.addrs):
            return ops.sorted_search_cuda(sqt, keys, addrs, cfg.fanout)

        ms = time_ms(torch, kern, iters)
        dev_ms = device_ms(torch, kern, iters)
        plain = time_ms(torch, lambda: six.search(srt, sqt, cfg.fanout),
                        iters // 5)
        lib = time_ms(torch, lambda: torch.searchsorted(srt.keys, sqt), iters)
        lib_dev = device_ms(torch, lambda: torch.searchsorted(srt.keys, sqt),
                            iters)
        # 7 launches a call: fewer calls, so that all are queued within
        # device_ms's GPU sleep
        lib_same = device_ms(torch, lambda: search_library(torch, srt, sqt),
                             iters // 10)
        nbytes, cmps = search_work(torch, srt.keys, sqt, cfg.fanout, 5)
        bound, b_bytes, b_ops = bound_of(nbytes, cmps)
        lat = lat_old = None
        if QS == 1:
            rnd, d_one = round_slope(torch, kern, srt, cfg.fanout, iters)
            lat = rounds * rnd
            lat_old = levels * (dev_ms - d_one) / (levels - 1)
        res[QS] = dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
                       library_ms=lib, library_device_ms=lib_dev,
                       bound_ms=bound,
                       bound_by="bytes" if b_bytes >= b_ops else "operations",
                       latency_bound_ms=lat, latency_bound_levels_ms=lat_old,
                       library_same_function_device_ms=lib_same)
        log(f"kernel sorted_search{sfx} ({label}): Q={QS}, cap {cap}, "
            f"{levels} "
            f"levels: equal; {ms:.4f} ms per call, device {dev_ms:.4f} ms, "
            f"plain {plain:.4f} ms, torch.searchsorted {lib:.4f} ms (device "
            f"{lib_dev:.4f} ms), the same function (searchsorted, gathers, "
            f"compare) device {lib_same:.4f} ms, bound "
            f"{bound:.6f} ms (bytes {b_bytes:.6f} ms for {nbytes} B, "
            f"compares {b_ops:.6f} ms)"
            + ("" if lat is None else
               f", latency bound {lat:.6f} ms ({rounds} dependent rounds; "
               f"{levels} levels x the slope a level: {lat_old:.6f} ms)"))

    # the SCAN's range at Q = 1, routed (one launch: lo and hi read on the
    # card) against six.range_query (searchsorted and the take's gathers);
    # its bounds from a generator of its own, so that the phases after
    # this one draw what they drew before it was added
    own = np.random.default_rng(cap)
    lo_t = torch.tensor(int(own.choice(live)), dtype=srt.keys.dtype,
                        device=dev)
    hi_t = lo_t + int(own.integers(1, 2 ** 16 if key_hi < 2 ** 31 else
                                   key_hi >> 16))
    lim = 128
    got = ops.range_query(cfg, srt, lo_t, hi_t, lim)
    err = max(max_abs_err(torch, got, six.range_query(srt, lo_t, hi_t, lim),
                          f"{label} range_query"),
              max(r["err"] for r in res.values()))
    rq = lambda: ops.range_query(cfg, srt, lo_t, hi_t, lim)  # noqa: E731
    rq_plain = lambda: six.range_query(srt, lo_t, hi_t, lim)  # noqa: E731
    r_ms = time_ms(torch, rq, 500)
    r_dev = device_ms(torch, rq, 500)
    rp_ms = time_ms(torch, rq_plain, 500)
    rp_dev = device_ms(torch, rq_plain, 50)
    log(f"kernel sorted_search{sfx} ({label}): the SCAN's range at limit "
        f"{lim}, "
        f"count {int(got[2])}: equal to six.range_query; routed "
        f"ops.range_query {r_ms:.4f} ms per call, device {r_dev:.4f} ms; "
        f"six.range_query {rp_ms:.4f} ms per call, device {rp_dev:.4f} ms")
    one, big = res[1], res[Q]
    out.append(dict(name="sorted_search" + sfx, route="cuda",
                    source="src/repro_torch/kernels/csrc/sorted_search.cu",
                    replaces=f"{FUSED}:246", max_abs_err=err,
                    **{x: one[x] for x in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "device_ms", "library_device_ms",
                        "latency_bound_ms", "latency_bound_levels_ms",
                        "library_same_function_device_ms")},
                    cap=cap, rounds=rounds,
                    range_ms=r_ms, range_device_ms=r_dev,
                    range_plain_ms=rp_ms, range_plain_device_ms=rp_dev,
                    at_Q={"Q": Q, **{x: big[x] for x in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "library_device_ms",
                        "library_same_function_device_ms")}}))

    # -- merge: one apply batch into the replica ----------------------------
    m = cfg.async_apply_batch
    bk = np.concatenate([rng.choice(live, m // 2),
                         rng.integers(0, key_hi, m - m // 2)])
    bk[: m // 8] = bk[m // 8: m // 4]                  # duplicate keys
    rng.shuffle(bk)
    bo = rng.choice([0, 1, 1, 2], m).astype(np.int8)   # PUT, DEL, op 0
    bkt = torch.as_tensor(bk.astype(npk), device=dev)
    bat = torch.as_tensor(rng.integers(0, cap, m).astype(np.int32),
                          device=dev)
    bot = torch.as_tensor(bo, device=dev)
    got = ops.merge(cfg, srt, bkt, bat, bot)
    want = six.merge(srt, bkt, bat, bot)
    err = max_abs_err(torch, tuple(got), tuple(want),
                      f"{label} merge{sfx}")
    ms = time_ms(torch, lambda: ops.merge(cfg, srt, bkt, bat, bot), 20)
    dev_ms = device_ms(torch, lambda: ops.merge(cfg, srt, bkt, bat, bot), 20)
    plain = time_ms(torch, lambda: six.merge(srt, bkt, bat, bot), 5)
    split = kernel_split(torch, lambda: ops.merge(cfg, srt, bkt, bat, bot),
                         f"kernel merge{sfx} ({label}): cap {cap}, m={m}")
    # the replica's keys and addrs read and the new ones written, the
    # batch's keys, addrs (int32) and ops (int8) read, the size written
    nbytes = 2 * cap * (kb + 4) + m * (kb + 5) + 4
    log(f"kernel merge{sfx} ({label}): cap {cap} (size {int(srt.size)} -> "
        f"{int(got.size)}), m={m}: equal; {ms:.4f} ms per call, device "
        f"{dev_ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} B)")
    out.append(dict(name="merge" + sfx, route="cuda",
                    source="src/repro_torch/kernels/csrc/merge.cu",
                    replaces=f"{FUSED}:404", max_abs_err=err, ms=ms,
                    plain_ms=plain,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, device_ms=dev_ms,
                    device_ms_by_kernel=split, cap=cap))
    return out


def sort_bound(R, T):
    """(bound ms, bytes ms, compares ms) of a [R, T] int32 pair sort: each
    key and payload read and written once, 16 B an entry; the network's
    R T / 2 log2 T (log2 T + 1) / 2 compare-exchanges at 67e12/s."""
    L = max(T.bit_length() - 1, 0)
    return bound_of(R * T * 16, R * (T // 2) * L * (L + 1) // 2)


def dispatch_path(torch, cfg, wl, rng):
    """Phase 4b: the rest of the kernel dispatch surface, through its
    public calls, on the loaded store: ``ops.hash_probe`` on the hash
    (one client chunk of GET keys, hashed on the card),
    ``ops.sorted_search`` on replica 0,
    ``ops.sort`` and ``ops.sort_pairs`` at three shapes (the distributed
    store's 16 apply rows, one client chunk, one backup-log ring), and
    ``ops.merge`` with a 65536-entry batch (a batch the merge took only
    up to 16384 before).  The launch counts are set to 0 just before and
    read just after; then each output against its plain version and the
    cross-checks, and each kernel timed.  Returns (one record per kernel,
    the 65536-entry merge's numbers)."""
    from repro_torch.core import hash_index as hix
    from repro_torch.core import sorted_index as six
    from repro_torch.kernels import ops

    group = wl.client.backend.group
    hidx, srt = group.hash, group.sorted[0]
    dev = hidx.sig.device
    Q, S, fo = CHUNK, cfg.slots_per_bucket, cfg.fanout
    live = wl.live_keys()
    qh = torch.as_tensor(wl.get_mix(Q), device=dev)
    qs = np.concatenate([rng.choice(live, Q // 2),
                         rng.choice(live, Q // 4).astype(np.int64) + 1,
                         rng.integers(0, 2 ** 31 - 1, Q - Q // 2 - Q // 4 - 3),
                         [-1, 2 ** 31 - 1, 0]]).astype(np.int32)
    rng.shuffle(qs)
    qs = torch.as_tensor(qs, device=dev)
    pairs = {}
    for R, T in SORT_SHAPES:
        pairs[(R, T)] = (
            torch.as_tensor(rng.integers(0, 1024, (R, T)).astype(np.int32),
                            device=dev),
            torch.as_tensor(rng.permutation(R * T).astype(np.int32)
                            .reshape(R, T), device=dev))
    m = cfg.log_capacity
    bk = np.concatenate([rng.choice(live, m // 2),
                         rng.integers(0, 2 ** 31 - 1, m - m // 2)])
    bk[: m // 8] = bk[m // 8: m // 4]                  # duplicate keys
    rng.shuffle(bk)
    bkt = torch.as_tensor(bk.astype(np.int32), device=dev)
    bat = torch.as_tensor(rng.integers(0, 1 << 24, m).astype(np.int32),
                          device=dev)
    bot = torch.as_tensor(rng.choice([0, 1, 1, 2], m).astype(np.int8),
                          device=dev)

    # -- the path: the public calls, counted ---------------------------------
    torch.cuda.synchronize()
    zero_launches(ops)
    t0 = time.perf_counter()
    h = ops.hash_probe(hidx, qh, cfg)
    srch = ops.sorted_search(srt, qs, fanout=fo)
    sorted_ = {sh: (ops.sort(cfg, k, v), ops.sort_pairs(k, v))
               for sh, (k, v) in pairs.items()}
    merged = ops.merge(cfg, srt, bkt, bat, bot)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"dispatch: the public calls in {t_path:.3f} s; launches "
        f"{launches}")
    for k in DISPATCH_KERNELS + ("merge",):
        check(launches[k] > 0, f"kernel {k} was not launched on the "
                               f"dispatch path")

    # -- each output against its plain version, and the cross-checks --------
    b, sg, fp = hix.descriptors(hidx, qh)
    tab = (hidx.sig, hidx.fp, hidx.addr)
    want_h = ops.legacy_hash_probe_plain(b, sg, fp, *tab, slots_per_bucket=S)
    err_h = max_abs_err(torch, (h[0], h[1].int(), h[2]), want_h,
                        "legacy hash_probe, keys in")
    check(h[1].dtype == torch.bool, "legacy hash_probe: found is not bool")
    err_h = max(err_h, max_abs_err(
        torch, ops.legacy_hash_probe_cuda(b, sg, fp, *tab, S), want_h,
        "legacy hash_probe, descriptors in"))
    pa, pf, pc = ops.probe(cfg, hidx, qh)
    max_abs_err(torch, (h[0], h[1]), (pa, pf), "legacy hash_probe vs probe")
    occ = (hidx.sig != 0).sum(1, dtype=torch.int32)
    rows_off = int((occ != hidx.fill).sum())
    same = occ[b.long()] == hidx.fill[b.long()]
    max_abs_err(torch, (h[2][same],), (pc[same],),
                "legacy hash_probe acc vs probe where occ == fill")
    log(f"dispatch: legacy hash_probe Q={Q}: the keys-in entry (the path's "
        f"call) and the descriptor-in entry equal to the plain version; "
        f"addr and found equal to ops.probe's, acc too on the "
        f"{int(same.sum())} queries whose row has occ == fill; "
        f"{rows_off} of {hidx.sig.shape[0]} rows have occ != fill")
    err_s = max_abs_err(torch, (srch[0], srch[1].int(), srch[2]),
                        ops.legacy_sorted_search_plain(qs, srt.keys,
                                                       srt.addrs, fanout=fo),
                        "legacy sorted_search")
    max_abs_err(torch, srch, ops.search(cfg, srt, qs),
                "legacy sorted_search vs search")
    max_abs_err(torch, srch, ops.sorted_search_cuda(
        qs, srt.keys, srt.addrs, fo)[:3], "legacy vs block sorted_search")
    err_sort = {}
    for sh, (k, v) in pairs.items():
        got_st, got_bi = sorted_[sh]
        err_sort[sh] = (
            max_abs_err(torch, got_st, ops.sort_stable_plain(k, v),
                        f"sort {list(sh)}"),
            max_abs_err(torch, got_bi, ops.bitonic_sort_plain(k, v),
                        f"sort_pairs {list(sh)}"))
        ties = int((got_bi[1] != got_st[1]).sum())
        log(f"dispatch: sort and sort_pairs {list(sh)}: equal to their "
            f"plain versions ({ties} payloads where the network's order of "
            f"tied keys differs from the stable sort's)")
    k, v = pairs[SORT_SHAPES[0]]
    k16, v16 = k.to(torch.int16), v.to(torch.int16)
    n0 = ops.LAUNCHES["sort_stable"]
    got16 = ops.sort(cfg, k16, v16)
    check(ops.LAUNCHES["sort_stable"] == n0 and got16[1].dtype == v16.dtype,
          "sort on int16 keys launched the kernel or cast the payload")
    max_abs_err(torch, got16, ops.sort_stable_plain(k16, v16),
                "sort int16 keys")
    log(f"dispatch: sort {list(SORT_SHAPES[0])} on int16 keys: the stable "
        f"sort + gather, as JAX's per-dtype rule takes it, equal to the "
        f"plain version; no launch, the int16 payload kept")
    want = six.merge(srt, bkt, bat, bot)
    err_m = max_abs_err(torch, tuple(merged), tuple(want), "merge m=65536")

    # -- timing --------------------------------------------------------------
    out = []
    kern_k = lambda: ops.legacy_hash_probe_keys_cuda(qh, *tab, S)  # noqa
    kern_d = lambda: ops.legacy_hash_probe_cuda(b, sg, fp, *tab, S)  # noqa
    route = lambda: ops.hash_probe(hidx, qh, cfg)  # noqa: E731
    ms, ms_d, routed = (time_ms(torch, f, 200) for f in (kern_k, kern_d,
                                                         route))
    dev_ms, dev_d, routed_dev = (device_ms(torch, f, 200)
                                 for f in (kern_k, kern_d, route))
    plain = time_ms(torch, lambda: ops.legacy_hash_probe_plain(
        *hix.descriptors(hidx, qh), *tab, slots_per_bucket=S), 50)
    plain_d = time_ms(torch, lambda: ops.legacy_hash_probe_plain(
        b, sg, fp, *tab, slots_per_bucket=S), 50)
    nbytes, nbytes_d, hits = legacy_probe_work(torch, hidx, b, sg, fp, h)
    bound, bound_d = (n / HBM_BYTES_PER_S * 1e3 for n in (nbytes, nbytes_d))
    log(f"kernel legacy_hash_probe: Q={Q} ({hits} hits), keys in, hashed on "
        f"the card: {ms:.4f} ms per call, device {dev_ms:.4f} ms, routed "
        f"ops.hash_probe {routed:.4f} ms (device {routed_dev:.4f} ms), plain "
        f"(descriptors + ref_hash_probe) {plain:.4f} ms; descriptors in: "
        f"{ms_d:.4f} ms per call, device {dev_d:.4f} ms, plain "
        f"{plain_d:.4f} ms; bound {bound:.6f} ms ({nbytes} B; descriptors "
        f"in {bound_d:.6f} ms for {nbytes_d} B)")
    lanes = re.findall(r"constexpr int W = (\d+);", (
        ROOT / "src/repro_torch/kernels/csrc/legacy_hash_probe.cu").read_text())
    check(len(lanes) == 1, "legacy_hash_probe.cu: its lanes a query")
    log(f"kernel legacy_hash_probe: W = {lanes[0]} lanes a query, the "
        f"faster of 4 and 8 on the H100 (PERF.md, section 6, row 7)")
    out.append(dict(name="legacy_hash_probe", route="cuda",
                    source="src/repro_torch/kernels/csrc/legacy_hash_probe.cu",
                    replaces=f"{LEGACY}/_hash_probe.py:77",
                    launches=launches["legacy_hash_probe"], max_abs_err=err_h,
                    ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                    library_ms=None, device_ms=dev_ms, routed_ms=routed,
                    routed_device_ms=routed_dev, descriptors_in_ms=ms_d,
                    descriptors_in_device_ms=dev_d,
                    descriptors_in_plain_ms=plain_d,
                    bound_descriptors_in_ms=bound_d, Q=Q,
                    rows_occ_ne_fill=rows_off))

    # the search: the bound is the larger of the bytes of the distinct
    # sectors this run's queries read and their compares (search_work);
    # beside it, the latency of the dependent rounds a search needs
    # (search_rounds, row 2's method), and the parent's levels + 1 reads
    # x the slope a level
    cap = srt.keys.shape[0]
    levels = six.directory_levels(cap, fo)
    q1 = qs[:1].clone()

    def kern_s(q=qs, keys=srt.keys, addrs=srt.addrs):
        return ops.legacy_sorted_search_cuda(q, keys, addrs, fo)

    ms = time_ms(torch, kern_s, 100)
    dev_ms = device_ms(torch, kern_s, 100)
    d1 = device_ms(torch, lambda: kern_s(q1), 500)
    rnd, d1_top = round_slope(
        torch, lambda keys, addrs: kern_s(q1, keys, addrs), srt, fo, 500)
    rounds = search_rounds(cap, fo)
    lat = rounds * rnd
    lat_old = (levels + 1) * (d1 - d1_top) / (levels - 1)
    plain = time_ms(torch, lambda: ops.legacy_sorted_search_plain(
        qs, srt.keys, srt.addrs, fanout=fo), 20)

    def lib_s():
        return search_library(torch, srt, qs)

    lib = time_ms(torch, lib_s, 100)
    lib_dev = device_ms(torch, lib_s, 20)
    routed = time_ms(torch, lambda: ops.sorted_search(srt, qs, fanout=fo),
                     100)
    nbytes, cmps = search_work(torch, srt.keys, qs, fo, 3)
    bound, b_bytes, b_ops = bound_of(nbytes, cmps)
    log(f"kernel legacy_sorted_search: Q={Q}, cap {cap}, {levels} levels: "
        f"{ms:.4f} ms per call, device {dev_ms:.4f} ms (Q = 1: {d1:.4f} "
        f"ms, one level {d1_top:.4f} ms), plain {plain:.4f} ms, "
        f"searchsorted + index {lib:.4f} ms (device {lib_dev:.4f} ms), "
        f"routed {routed:.4f} ms; bound "
        f"{bound:.6f} ms (bytes {b_bytes:.6f} ms for {nbytes} B, compares "
        f"{b_ops:.6f} ms); latency of {rounds} dependent rounds "
        f"{lat:.6f} ms ({levels + 1} reads x the slope a level: "
        f"{lat_old:.6f} ms)")
    out.append(dict(name="legacy_sorted_search", route="cuda",
                    source="src/repro_torch/kernels/csrc/"
                           "legacy_sorted_search.cu",
                    replaces=f"{LEGACY}/_sorted_search.py:82",
                    launches=launches["legacy_sorted_search"],
                    max_abs_err=err_s, ms=ms, plain_ms=plain,
                    bound_ms=bound,
                    bound_by="bytes" if b_bytes >= b_ops else "operations",
                    library_ms=lib, device_ms=dev_ms, routed_ms=routed,
                    latency_bound_ms=lat, latency_bound_levels_ms=lat_old,
                    rounds=rounds, device_ms_q1=d1, cap=cap, Q=Q,
                    library_same_function_device_ms=lib_dev))

    # the two sorts at each shape; the record's own numbers are the first
    # shape's
    for name, src, rep, call, plain_fn, i in (
            ("sort_stable", "sort_stable.cu", f"{FUSED}:442",
             ops.sort_stable_cuda, ops.sort_stable_plain, 0),
            ("bitonic_sort", "bitonic_sort.cu",
             f"{LEGACY}/_bitonic_sort.py:60", ops.bitonic_sort_cuda,
             ops.bitonic_sort_plain, 1)):
        shapes = {}
        for (R, T), (k, v) in pairs.items():
            it = 50 if R * T <= 1 << 16 else 20
            ms = time_ms(torch, lambda: call(k, v), it)
            dev_ms = device_ms(torch, lambda: call(k, v), it)
            plain = time_ms(torch, lambda: plain_fn(k, v), 10)

            def lib_fn(k=k, v=v):
                return torch.gather(
                    v, 1, torch.sort(k, dim=1, stable=True).indices)

            lib = time_ms(torch, lib_fn, it)
            lib_dev = device_ms(torch, lib_fn, it)
            split = {}
            if name == "bitonic_sort":
                split = kernel_split(torch, lambda: call(k, v),
                                     f"kernel {name} [{R}, {T}]")
            bound, b_bytes, b_ops = sort_bound(R, T)
            shapes[f"{R}x{T}"] = dict(
                max_abs_err=err_sort[(R, T)][i], ms=ms, device_ms=dev_ms,
                plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                bound_ms=bound,
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                **({"device_ms_by_kernel": split} if split else {}))
            log(f"kernel {name} [{R}, {T}]: {ms:.4f} ms per call, device "
                f"{dev_ms:.4f} ms, plain {plain:.4f} ms, torch.sort(stable) "
                f"+ gather {lib:.4f} ms (device {lib_dev:.4f} ms); bound "
                f"{bound:.6f} ms (bytes {b_bytes:.6f} ms, compares "
                f"{b_ops:.6f} ms)")
        first = shapes[f"{SORT_SHAPES[0][0]}x{SORT_SHAPES[0][1]}"]
        out.append(dict(name=name, route="cuda",
                        source=f"src/repro_torch/kernels/csrc/{src}",
                        replaces=rep, launches=launches[name],
                        **{x: first[x] for x in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "device_ms", "library_device_ms")},
                        max_abs_err=max(x["max_abs_err"]
                                        for x in shapes.values()),
                        shapes=shapes))

    # the 65536-entry merge (its kernel's time, information)
    mk = lambda: ops.merge(cfg, srt, bkt, bat, bot)  # noqa: E731
    m_ms = time_ms(torch, mk, 20)
    m_dev = device_ms(torch, mk, 20)
    m_split = kernel_split(torch, mk, f"kernel merge: m={m} into cap {cap}")
    m_bytes = cap * 16 + m * 9 + 4
    log(f"kernel merge: m={m} into cap {cap}: equal to six.merge; {m_ms:.4f}"
        f" ms per call, device {m_dev:.4f} ms, bound "
        f"{m_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({m_bytes} B)")
    pdl_on_off(torch, cfg, srt, pairs, (bkt, bat, bot))
    return out, dict(m=m, max_abs_err=err_m, ms=m_ms, device_ms=m_dev,
                     bound_ms=m_bytes / HBM_BYTES_PER_S * 1e3,
                     device_ms_by_kernel=m_split)


def no_pdl_libs():
    """merge.cu and sort_stable.cu built from a copy of csrc whose
    pdl.cuh launches without the programmatic-serialization attribute
    (pdl_wait() then returns at once), into build/no_pdl; {name: CDLL}."""
    import ctypes
    import shutil

    from repro_torch.kernels import _build

    out = ROOT / "build" / "no_pdl"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    on = "programmaticStreamSerializationAllowed = 1;"
    text = (out / "pdl.cuh").read_text()
    check(text.count(on) == 1, "pdl.cuh: the launch attribute to turn off")
    (out / "pdl.cuh").write_text(text.replace(on, on.replace("1", "0")))
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
         str(out / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in ("merge", "sort_stable")}
    libs = {}
    for n, proc in procs.items():
        msg, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc {n}.cu with PDL off:\n{msg}")
        libs[n] = ctypes.CDLL(str(out / f"{n}.so"))
        for fn, (argtypes, restype) in _build.SIGNATURES[n].items():
            getattr(libs[n], fn).argtypes = argtypes
            getattr(libs[n], fn).restype = restype
    return libs


def legacy_probe_work(torch, hidx, b, sg, fp, h):
    """The bytes the legacy probe must move on this run's queries: each
    query's key in (4 B; 12 B of descriptors) and its outputs out (addr
    and acc int32, found bool: 9 B; 12 B with found int32), and the
    distinct 32 B sectors of the tables that the queries need: the sig
    row up to the first match (the whole row on a miss, whose occ counts
    it), the fp word of each slot up to there whose sig matches, and the
    addr word of a hit.  Returns (keys in, descriptors in, hits)."""
    Q = b.shape[0]
    cs = hidx.sig.shape[1]
    bl = b.long()
    sig_m = hidx.sig[bl] == sg[:, None]
    first = torch.argmax((sig_m & (hidx.fp[bl] == fp[:, None])).to(
        torch.uint8), dim=1)
    end = torch.where(h[1], first, cs - 1)
    cols = torch.arange(cs, device=b.device)
    upto = cols[None] <= end[:, None]
    word = bl[:, None] * cs + cols[None]  # the slot's 4 B word in a table

    def sectors(m):
        return int(torch.unique(word[m] // 8).numel()) * 32

    hit_at = h[1][:, None] & (cols[None] == end[:, None])
    rows = sectors(upto) + sectors(sig_m & upto) + sectors(hit_at)
    return Q * (4 + 9) + rows, Q * (12 + 12) + rows, int(h[1].sum())


def pdl_on_off(torch, cfg, srt, pairs, batch):
    """Phase 4c: the device time of the merge and of the stable sort with
    programmatic dependent launch on (the libraries in use) and off
    (no_pdl_libs), in the order on, off, on, off, through the same
    wrappers; the outputs of the two builds must be equal."""
    from repro_torch.core import sorted_index as six
    from repro_torch.kernels import _build, ops

    off = no_pdl_libs()
    on = {n: _build.lib(n) for n in off}
    c = 1 << 21
    small = six.SortedIndex(srt.keys[:c], srt.addrs[:c],
                            torch.clamp(srt.size, max=c))
    cases = {}
    for label, idx, m in ((f"merge cap {srt.keys.shape[0]} m=4096", srt,
                           4096),
                          (f"merge cap {srt.keys.shape[0]} m=65536", srt,
                           65536),
                          (f"merge cap {c} m=4096", small, 4096)):
        b = [x[:m] for x in batch]
        cases[label] = lambda idx=idx, b=b: ops.merge(cfg, idx, *b)
    for (R, T), (k, v) in pairs.items():
        cases[f"sort_stable [{R}, {T}]"] = \
            lambda k=k, v=v: ops.sort_stable_cuda(k, v)
    times, outs = {}, {}
    try:
        for turn in ("on", "off", "on", "off"):
            _build._libs.update(on if turn == "on" else off)
            for label, fn in cases.items():
                if (label, turn) not in outs:
                    outs[(label, turn)] = fn()
                times.setdefault(label, {}).setdefault(turn, []).append(
                    device_ms(torch, fn, 20))
    finally:
        _build._libs.update(on)
    for label in cases:
        for a, b in zip(outs[(label, "on")], outs[(label, "off")]):
            check(torch.equal(a, b), f"{label}: PDL on and off differ")
        t = times[label]
        log(f"pdl {label}: device on " + ", ".join(
            f"{x:.4f}" for x in t["on"]) + " ms, off " + ", ".join(
            f"{x:.4f}" for x in t["off"]) + " ms; outputs equal")


def backup_work(torch, q, sel, srt, blogs, cfg):
    """Bytes and operations the backup probe needs for this run's data:
    the queries and selects read once; for each replica some lane
    decides on (its last selected one), the window's keys and its two
    bounds, then per such lane the log entry's op and addr on a log hit,
    else the descent of that replica as descent_work replays it over the
    lanes that miss (distinct 32 B sectors: the lanes share the
    directory's nodes).  Operations: one hash insert per window entry,
    one probe per lane that looks the window up (none for q = 2**31 - 1
    with a window shorter than the ring: the finish answers it from a
    ring slot), and the descent's compares.  Returns (bytes, operations,
    lanes found in a log)."""
    from repro_torch.core import log as lg

    _, kb, _, inf = key_width(torch, srt[0].keys)
    Q, R = sel.shape
    chosen = np.where(sel.any(1), R - 1 - np.argmax(sel[:, ::-1] != 0, 1), -1)
    nbytes, ops, in_logs = Q * kb + Q * R * 4, 0, 0
    for r in range(R):
        lanes = q[chosen == r]
        if not len(lanes):
            continue
        lkeys, _, _ = lg.pending_entries_np(blogs[r])
        n_win = len(lkeys)
        window = set(lkeys.tolist())
        in_log = np.array([k in window for k in lanes.tolist()], bool)
        quirk = (lanes == inf) & (n_win < cfg.log_capacity)
        hit = in_log | quirk
        in_logs += int(in_log.sum())
        ops += n_win + int((~quirk).sum())
        nbytes += n_win * kb + 8 + int(hit.sum()) * 5
        miss = lanes[~hit]
        if len(miss):
            keys = srt[r].keys
            d_bytes, d_ops = descent_work(
                torch, keys, torch.as_tensor(miss, device=keys.device),
                cfg.fanout)
            nbytes += d_bytes
            ops += d_ops
    return nbytes, ops, in_logs


def compare_backup_probe(torch, wl, cfg, group, window, launches):
    """The backup probe against its plain version on the group as the
    primary's failure left it (the window of 2 chunks pending; it wraps
    the ring in phase 5), Q = 16384, R = 2, cap 2^24: random replica
    selects, then the path's select (the first live replica for every
    lane), timed, at the width of the group's keys."""
    from repro_torch.core import index_group as ig
    from repro_torch.core import log as lg
    from repro_torch.kernels import ops

    dev = wl.client.backend.device
    model, rng = wl.model, wl.rng
    npk, _, sfx, inf = key_width(torch, group.sorted[0].keys)
    Q = CHUNK
    R = len(group.sorted)
    q = np.concatenate([rng.choice(window, Q // 4),
                        rng.choice(model.keys, Q // 2),
                        rng.integers(0, wl.key_hi, Q // 4 - 2),
                        [inf, 0]]).astype(npk)
    rng.shuffle(q)
    qt = torch.as_tensor(q, device=dev)
    srt, blogs = group.sorted, group.blogs
    err = 0.0
    sel_rand = torch.as_tensor(rng.integers(0, 2, (Q, R)).astype(np.int32),
                               device=dev)
    sel_path = (torch.arange(R, device=dev) == 0).to(torch.int32
                                                       ).expand(Q, R)
    sel_path = sel_path.contiguous()
    for label, sel in (("random selects", sel_rand), ("path", sel_path)):
        got = ops.backup_probe_cuda(qt, sel, srt, blogs, cfg.fanout)
        want = ops.backup_probe_plain(cfg, srt, blogs, qt, sel)
        err = max(err, max_abs_err(
            torch, (got[0], got[1].bool(), got[2]), want,
            f"backup_probe{sfx} {label}"))

    def kern():
        return ops.backup_probe_cuda(qt, sel_path, srt, blogs, cfg.fanout)

    ms = time_ms(torch, kern, 100)
    dev_ms = device_ms(torch, kern, 100)
    plain = time_ms(torch, lambda: ops.backup_probe_plain(
        cfg, srt, blogs, qt, sel_path), 5, warmup=1)
    routed = time_ms(torch, lambda: ig.replica_probe(group, qt, cfg), 100)
    split = kernel_split(torch, kern,
                         f"kernel backup_probe{sfx}: Q={Q}, R={R}")

    # the bound, from this run's data (backup_work): the path selects
    # replica 0 for every lane, plus the three outputs
    n_win = int(lg.pending_count(blogs[0]))
    cap = srt[0].keys.shape[0]
    nbytes, n_ops, in_log = backup_work(torch, q, sel_path.cpu().numpy(),
                                        srt, blogs, cfg)
    nbytes += Q * 12
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    bound = max(b_bytes, b_ops)
    log(f"kernel backup_probe{sfx}: Q={Q}, R={R}, cap {cap}, window {n_win} "
        f"of "
        f"{cfg.log_capacity} ({in_log} lanes in it): equal; "
        f"{ms:.4f} ms per call, device {dev_ms:.4f} ms, plain {plain:.4f} "
        f"ms, routed ig.replica_probe {routed:.4f} ms; bound "
        f"{bound:.6f} ms (bytes {b_bytes:.6f} ms for {nbytes} B, "
        f"operations {b_ops:.6f} ms for {n_ops}); the split's spans "
        f"{sum(split.values()) / dev_ms:.0%} of the device time")
    return dict(name="backup_probe" + sfx, route="cuda",
                source="src/repro_torch/kernels/csrc/backup_probe.cu",
                replaces=f"{FUSED}:283",
                launches=launches["backup_probe" + sfx],
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=None, device_ms=dev_ms, routed_ms=routed,
                window=n_win, operations=n_ops, device_ms_by_kernel=split)


def distributed(torch, cfg, rng):
    """The distributed store on the card: load, mixed rounds with an
    apply, a GC round and SCANs, a read-back, then the drain and the
    parity audit.  Returns (workload, launches, timings, (the store as
    the last round's GET chunk read it, that chunk's keys))."""
    from repro_torch.core import kvstore as kv
    from repro_torch.core.client import DistributedBackend, HiStoreClient
    from repro_torch.kernels import ops

    n_load = DIST_KEYS
    need = n_load + ROUNDS * CHUNK // 2
    uniq = np.unique(rng.integers(0, 2 ** 31 - 1, int(need * 1.02) + 1024))
    check(len(uniq) >= need, "not enough distinct keys drawn")
    keys_all = uniq[rng.permutation(len(uniq))[:need]].astype(np.int32)
    load_keys = keys_all[:n_load]
    model = Model(keys_all, cfg.value_words)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = DistributedBackend(DIST_GROUPS, cfg, DIST_CAPACITY,
                                 capacity_q=DIST_CAPACITY_Q, device="cuda")
    client = HiStoreClient(backend)
    torch.cuda.synchronize()
    log(f"dist: DistributedBackend({DIST_GROUPS} groups x {DIST_CAPACITY}, "
        f"capacity_q {DIST_CAPACITY_Q}) created in "
        f"{time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated")
    wl = Workload(torch, client, model, rng, keys_all[n_load:])
    B = CHUNK
    check(client.max_batch == B, f"client chunk {client.max_batch}")
    zero_launches(ops)

    # -- load ------------------------------------------------------------
    t0 = time.perf_counter()
    vals = wl.new_vals(n_load)
    r = client.put(load_keys, vals)
    ok = r.ok.cpu().numpy()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(ok.all(), f"dist load: {(~ok).sum()} PUTs not acknowledged")
    model.put(load_keys, vals)
    load_retries = client.stats["retries"]
    log(f"dist: loaded {n_load} keys in {t_load:.3f} s "
        f"({n_load / t_load:.0f} PUT/s, {load_retries} retries)")

    # -- mixed rounds ------------------------------------------------------
    stats = {"get_hits": 0, "gets": 0, "puts": 0, "deletes": 0,
             "deleted_found": 0, "scans": 0, "scanned": 0}
    t0 = time.perf_counter()
    for rnd in range(ROUNDS):
        p = np.concatenate([wl.sample(wl.live_keys(), B // 2),
                            wl.take_fresh(B // 2)])
        wl.put(p, f"dist round {rnd}", replicas=cfg.n_backups)
        stats["puts"] += len(p)
        d = np.concatenate([wl.sample(wl.live_keys(), 3 * B // 16),
                            wl.absent(B // 16)])
        rng.shuffle(d)
        stats["deleted_found"] += wl.delete(d, f"dist round {rnd}")
        stats["deletes"] += len(d)
        # the GETs follow the writes, so they meet pending log windows;
        # the last round's GET chunk and the state it reads are kept for
        # the group probe's check (the state is never written in place)
        g = wl.get_mix(B)
        if rnd == ROUNDS - 1:
            probe_at = (backend.store, g)
        stats["get_hits"] += wl.check_get(g, f"dist round {rnd} GET")
        stats["gets"] += len(g)
        client.apply()
        backend.gc_round()
        for _ in range(SCANS):
            stats["scanned"] += wl.scan(f"dist round {rnd}")
            stats["scans"] += 1
        wl.check_get(d, f"dist round {rnd} GET after DELETE")
    torch.cuda.synchronize()
    t_mixed = time.perf_counter() - t0

    # -- every acknowledged write reads back -------------------------------
    hits, t_read = wl.read_back("dist read-back")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"dist: {ROUNDS} mixed rounds in {t_mixed:.3f} s: {stats}")
    log(f"dist: read back {len(model.keys)} keys ({hits} live) in "
        f"{t_read:.3f} s ({len(model.keys) / t_read:.0f} GET/s)")
    log(f"dist: launches {launches}; retries {client.stats['retries']}")
    log(f"dist: torch.cuda.max_memory_allocated() = {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    for k in DIST_KERNELS:
        check(launches[k] > 0,
              f"kernel {k} was not launched on the distributed path")
    check(launches["sorted_search"] == stats["scans"],
          f"dist: {launches['sorted_search']} search launches for "
          f"{stats['scans']} SCANs (one stacked range query a SCAN)")
    scan_lat = client.metrics().latency["scan"]
    log(f"dist: SCAN (limit 128) {scan_lat.mean * 1e3:.3f} ms per op (the "
        f"client's latency, host clock to the coverage on the host; mean "
        f"of {scan_lat.count}); {launches['sorted_search']} search launches "
        f"for {stats['scans']} SCANs")
    log_metrics(client, "dist")

    # -- drain, then the parity audit --------------------------------------
    t0 = time.perf_counter()
    client.drain()
    report = kv.parity_report(backend.store, cfg)
    t_audit = time.perf_counter() - t0
    slots = report[-1]
    check(slots["kind"] == "value_slots" and slots["agree"]
          and slots["fq_spill"] == 0, f"dist value-slot audit: {slots}")
    bad = [e for e in report[:-1] if not e["agree"]]
    check(not bad, f"dist parity: {bad[:3]}")
    n_live = sum(e["n_hash"] for e in report[:-1] if e["replica"] == 0)
    check(n_live == int(model.live.sum()) == slots["live"],
          f"dist parity: {n_live} live items, model {int(model.live.sum())}")
    log(f"dist: drain + parity_report in {t_audit:.3f} s: {len(report) - 1} "
        f"(group, replica) entries agree with the hashes; value slots "
        f"{json.dumps(slots)}")
    times = dict(load_s=t_load, put_per_s=n_load / t_load,
                 load_retries=load_retries, mixed_rounds_s=t_mixed,
                 scan_ms=scan_lat.mean * 1e3,
                 read_s=t_read, get_per_s=len(model.keys) / t_read,
                 audit_s=t_audit, peak_bytes=peak,
                 retries=client.stats["retries"])
    return wl, launches, times, probe_at


def group_work(torch, q, sel, hidx, srt, blogs, cfg, selects_in=True,
               n_out=6):
    """Bytes and operations one group probe call needs for this run's
    data: the hash half (the sig and fp chain rows, one addr, one fill a
    query; the key is hashed on the card, read once with the backup
    half), the backup half as backup_work counts it (less the selects
    where the call computes them from the keys), and n_out outputs.
    Returns (bytes, operations, lanes found in a log)."""
    bbytes, n_ops, in_log = backup_work(torch, q, sel, srt, blogs, cfg)
    if not selects_in:
        bbytes -= sel.size * 4
    nbytes = len(q) * (2 * hidx.sig.shape[1] * 4 + 8) + bbytes
    return nbytes + len(q) * 4 * n_out, n_ops, in_log


def search_library(torch, srt, q):
    """The searches' function in PyTorch calls (timed beside the kernels,
    never used by the port): the last key <= q by torch.searchsorted,
    then the gathers and the compare that give addr (or -1) and found."""
    p = torch.clamp(torch.searchsorted(srt.keys, q, right=True) - 1, min=0)
    f = srt.keys[p] == q
    return torch.where(f, srt.addrs[p], -1), f


def bound_of(nbytes, compares):
    """(bound ms, bytes ms, compares ms)."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = compares / SCALAR_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), b_bytes, b_ops


def search_rounds(cap, fanout):
    """The dependent rounds of reads a search or a SCAN needs at Q = 1:
    the query (or lo) with the top grid (the levels whose multiples below
    cap number at most 1024, read together), one a level below it down
    to level 1, then level 0's node with the take's entries (or the hit's
    addr).  A one-level index: the query, then its node."""
    levels = 1
    while fanout ** levels < cap:
        levels += 1
    if levels == 1:
        return 2
    top = levels - 1
    while top > 1 and -(-cap // fanout ** (top - 1)) <= 1024:
        top -= 1
    return top + 1


def round_slope(torch, kern, srt, fanout, iters):
    """(one dependent round's device ms, the device ms on a one-level
    index): kern(keys, addrs) at Q = 1 on the replica's first fanout**3
    and first fanout**2 entries (3 and 2 rounds, each first round the
    query with at most fanout keys) and on its first fanout entries; the
    nodes sit in L2 after the warm-up."""
    d = {lv: device_ms(torch, lambda n=fanout ** lv: kern(srt.keys[:n],
                                                           srt.addrs[:n]),
                       iters) for lv in (1, 2, 3)}
    return d[3] - d[2], d[1]


def search_work(torch, keys, queries, fanout, n_out):
    """(bytes, compares) a search must do on this run's data: each query
    read once, n_out int32 outputs written, and the descent as
    descent_work counts it."""
    nbytes, compares = descent_work(torch, keys, queries, fanout)
    kb = keys.element_size()
    return queries.shape[0] * (kb + 4 * n_out) + nbytes, compares


def descent_work(torch, keys, queries, fanout):
    """(bytes, compares) the directory descent must do on this run's data.
    Bytes: at each level the distinct 32 B sectors of the node keys the
    queries read (they share the top levels' nodes, and no key past cap
    is read), then the sectors of the final key read and of the addr
    read of each hit.  Compares: one per node key read."""
    cap = keys.shape[0]
    Q = queries.shape[0]
    per_sector = 32 // keys.element_size()
    inf = torch.iinfo(keys.dtype).max
    offs = torch.arange(fanout, device=keys.device)
    pos = torch.zeros((Q,), dtype=torch.int64, device=keys.device)
    stride = 1
    while stride * fanout < cap:
        stride *= fanout
    sectors = compares = 0
    while stride >= 1:
        gi = torch.unique(pos)[:, None] + offs[None, :] * stride
        sectors += int(torch.unique(gi[gi < cap] // per_sector).numel())
        gq = pos[:, None] + offs[None, :] * stride
        compares += int((gq < cap).sum())
        node = torch.where(gq < cap, keys[gq.clamp(max=cap - 1)], inf)
        cnt = (node <= queries[:, None]).sum(1)
        pos = pos + (cnt - 1).clamp(min=0) * stride
        stride //= fanout
    at = pos.clamp(max=cap - 1)
    hit = keys[at] == queries
    sectors += int(torch.unique(at // per_sector).numel())
    sectors += int(torch.unique(at[hit] // 8).numel())
    return sectors * 32, compares


def pad_server(torch, G, dev):
    """The server whose exchange padding (q = 2**31 - 1) selects its
    replica 0: the one after key_inf's owner group."""
    from repro_torch.core import kvstore as kv
    inf = torch.tensor([2 ** 31 - 1], dtype=torch.int32, device=dev)
    return (int(kv.owner_group(inf, G)[0]) + 1) % G


def dist_kernels(torch, wl, cfg):
    """The hash probe, search and merge at the distributed path's
    shapes: the pad server's group (its hash, and its replica 0 on the
    next server, cap 2^21), Q = G * capacity_q, the exchange buffer's
    width."""
    from repro_torch.core import kvstore as kv
    from repro_torch.core import tree

    store, model = wl.client.backend.store, wl.model
    G = DIST_GROUPS
    gp = pad_server(torch, G, store.hb.device)
    own = kv.owner_group(torch.as_tensor(model.keys, device=store.hb.device),
                         G).cpu().numpy() == gp
    return compare_kernels(
        torch, cfg, tree.at(store.hash, gp),
        tree.at(store.bsorted, 0, (gp + 1) % G), model.keys[own & model.live],
        model.keys[own & ~model.live], wl.rng, G * DIST_CAPACITY_Q,
        f"dist group {gp}")


def compare_range_stacked(torch, wl, cfg):
    """The distributed SCAN's one launch, ops.range_query_stacked, against
    range_query_stacked_plain on the live store's [R, G, 2^21] leaves read
    by strides: every (group, replica) row's keys, addrs and count, at the
    bounds the client passes (0-d, expanded to [G]) and at bounds of each
    group's own (lo = -2**31, hi = 2**31 - 1, lo > hi, lo past the last
    key, wide and narrow ranges); timed per call and on the device."""
    from repro_torch.kernels import ops

    store, model = wl.client.backend.store, wl.model
    G, dev = DIST_GROUPS, store.hb.device
    R = store.bsorted.keys.shape[0]
    lim = wl.client.backend.scan_limit
    # a generator of its own, so that the phases after this one draw what
    # they drew before it was added
    own = np.random.default_rng(G)
    live = model.keys[model.live]
    lo0 = int(own.choice(live))
    top = int(live.max())
    lo = [-2 ** 31, 5, top + 1, lo0, int(own.choice(live)),
          int(own.choice(live)), top, 0][:G]
    hi = [2 ** 31 - 1, 4, 2 ** 31 - 1, lo0 + (1 << 24), lo[4] + (1 << 16),
          lo[5] + 64, 2 ** 31 - 1, 2 ** 31 - 1][:G]
    t32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    cases = {"client bounds (0-d, expanded)": (
        t32(lo0).reshape(1).expand(G), t32(lo0 + (1 << 16)).reshape(1)
        .expand(G)), "bounds per group": (t32(lo), t32(hi))}
    err, rec = 0, {}
    for label, (lo_t, hi_t) in cases.items():
        got = ops.range_query_stacked(cfg, store.bsorted, lo_t, hi_t, lim)
        want = ops.range_query_stacked_plain(cfg, store.bsorted, lo_t, hi_t,
                                             lim)
        e = max_abs_err(torch, got, want, f"dist range_query_stacked, "
                        f"{label}")
        err = max(err, e)
        n = want[2]
        check(bool((n[:, 0] > 0).any()), f"dist range_query_stacked, "
              f"{label}: every replica-0 row empty")
        fn = lambda lo_t=lo_t, hi_t=hi_t: ops.range_query_stacked(  # noqa
            cfg, store.bsorted, lo_t, hi_t, lim)
        ms = time_ms(torch, fn, 200)
        dev_ms = device_ms(torch, fn, 200)
        plain = time_ms(torch, lambda lo_t=lo_t, hi_t=hi_t:
                        ops.range_query_stacked_plain(
                            cfg, store.bsorted, lo_t, hi_t, lim), 20)
        rec[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                          max_abs_err=e, counts=n.tolist())
        log(f"kernel sorted_search (dist range_query_stacked, {label}): "
            f"[G, R] = [{G}, {R}] rows of cap {store.bsorted.keys.shape[2]},"
            f" limit {lim}, counts {n.tolist()}: keys, addrs and counts "
            f"equal to range_query_stacked_plain (max_abs_err {e}); "
            f"{ms:.4f} ms per call, device {dev_ms:.4f} ms, plain "
            f"{plain:.4f} ms")
    return err, rec


def compare_group_probe(torch, wl, cfg, launches, probe_at):
    """The group probe against its plain version, as the distributed GET
    calls it: the last mixed round's GET chunk routed as that GET routed
    it, one stacked call for the G servers' exchange buffers (Q = G *
    capacity_q each, mostly key_inf padding) against the state that GET
    read, each server's six halves equal to its per-server plain result;
    timed per call, on the device, routed (from the buffers to the
    halves) and split by kernel.  Then one group's state at Q = 16384
    (the stacked kernel at G = 1 with rep_sel given) with replicas
    selected for about half the lanes, the pending windows set back over
    real past entries so that each holds 16384 entries and wraps the end
    of the ring, q = 2**31 - 1 among the queries; timed, also with no
    lane selected."""
    from repro_torch.core import kvstore as kv
    from repro_torch.core import log as lg
    from repro_torch.core import tree
    from repro_torch.kernels import ops

    model, rng = wl.model, wl.rng
    G, lcap = DIST_GROUPS, cfg.log_capacity
    S, fo = cfg.slots_per_bucket, cfg.fanout
    dev = probe_at[0].hb.device
    gp = pad_server(torch, G, dev)

    # -- the GET chunk: one call for the G servers --------------------------
    err, c, kern = probe_get_chunk(torch, cfg, probe_at, "GET chunk")
    split = kernel_split(torch, kern, "kernel group_probe: GET chunk")
    log(f"kernel group_probe: a GET chunk of {len(probe_at[1])} keys, one "
        f"call for {G} servers of Q={c['Q']}, every server equal to its "
        f"plain result; {c['padding_lanes']} padding lanes, "
        f"{c['selecting_lanes']} selecting a replica: {c['ms']:.4f} ms per "
        f"call, device {c['device_ms']:.4f} ms, routed (from the exchange "
        f"buffers, hashing on the card) {c['routed_ms']:.4f} ms, plain "
        f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.6f} ms (bytes "
        f"{c['bound_bytes_ms']:.6f} ms for {c['bytes']} B, operations "
        f"{c['bound_ops_ms']:.6f} ms for {c['operations']}); the split's "
        f"spans {sum(split.values()) / c['device_ms']:.0%} of the call's "
        f"device time")

    # -- one group at Q = 16384, half the lanes selecting, wrapped windows --
    store = wl.client.backend.store
    QM, R = CHUNK, cfg.n_backups
    one = slice(gp, gp + 1)
    h1 = type(store.hash)(*[a[one] for a in store.hash])
    s1 = type(store.bsorted)(*[a[:, one] for a in store.bsorted])
    starts = []
    for r in range(R):
        T = int(store.blog.tail[r, gp])
        check(T >= lcap, f"group_probe: log {r} holds {T} < {lcap} entries")
        # the ring still holds positions [T - lcap, T); a window there
        # that crosses a multiple of lcap wraps
        starts.append(next(a for a in range(T - QM, T - lcap - 1, -1)
                           if a % lcap + QM > lcap))
    A = torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
    l1 = type(store.blog)(*[a[:, one] for a in store.blog])._replace(
        applied=A, tail=A + QM)
    hidx = tree.at(h1, 0)
    srt = tuple(tree.at(s1, r, 0) for r in range(R))
    blogs = tuple(tree.at(l1, r, 0) for r in range(R))
    own = kv.owner_group(torch.as_tensor(model.keys, device=dev),
                         G).cpu().numpy()
    mine = model.keys[model.live & (own == gp)]
    wkeys = np.concatenate([lg.pending_entries_np(b)[0] for b in blogs])
    q = np.concatenate([rng.choice(mine, QM // 4), rng.choice(wkeys, QM // 4),
                        rng.choice(model.keys, QM // 4),
                        rng.integers(0, 2 ** 31 - 1, QM // 4 - 2),
                        [2 ** 31 - 1, 0]]).astype(np.int32)
    rng.shuffle(q)
    msel = rng.integers(0, 2, (QM, R)).astype(np.int32)
    msel[msel.sum(1) == 0, R - 1] = 1
    msel[rng.random(QM) < 0.5] = 0
    msel[q == 2 ** 31 - 1] = 1
    qt = torch.as_tensor(q, device=dev)
    selt = torch.as_tensor(msel, device=dev)
    none = torch.zeros_like(selt)

    def call(sel):
        return lambda: ops.group_probe_cuda(qt[None], sel[None], h1, s1, l1,
                                            S, fo)

    for label, s_ in (("half selected", selt), ("none selected", none)):
        want = ops.group_probe_plain(cfg, hidx, srt, blogs, qt, s_)
        err = max(err, max_abs_err(
            torch, ops.group_probe(cfg, hidx, srt, blogs, qt, s_), want,
            f"group_probe {label}"))
        err = max(err, max_abs_err(torch, [t[0] for t in call(s_)()[:6]],
                                   want, f"group_probe {label}, in place"))
    m_ms = time_ms(torch, call(selt), 100)
    m_dev = device_ms(torch, call(selt), 100)
    m_none = device_ms(torch, call(none), 100)
    m_plain = time_ms(torch, lambda: ops.group_probe_plain(
        cfg, hidx, srt, blogs, qt, selt), 5, warmup=1)
    m_split = kernel_split(torch, call(selt),
                           f"kernel group_probe: Q={QM}, half selecting")
    nbytes, n_ops, in_log = group_work(torch, q, msel, hidx, srt, blogs, cfg)
    m_bound, mb_bytes, mb_ops = bound_of(nbytes, n_ops)
    log(f"kernel group_probe: group {gp}, Q={QM}, R={R}, windows of {QM} "
        f"wrapping the ring of {lcap}, {int((msel != 0).any(1).sum())} lanes "
        f"selecting a replica ({in_log} found in a log): equal; {m_ms:.4f} "
        f"ms per call, device {m_dev:.4f} ms ({m_none:.4f} ms with none "
        f"selected), plain {m_plain:.4f} ms; bound {m_bound:.6f} ms (bytes "
        f"{mb_bytes:.6f} ms for {nbytes} B, operations {mb_ops:.6f} ms for "
        f"{n_ops}); the split's spans {sum(m_split.values()) / m_dev:.0%} "
        f"of the device time")
    return dict(name="group_probe", route="cuda",
                source="src/repro_torch/kernels/csrc/group_probe.cu",
                replaces=f"{FUSED}:332", launches=launches["group_probe"],
                max_abs_err=err, ms=c["ms"], plain_ms=c["plain_ms"],
                bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                library_ms=None, device_ms=c["device_ms"],
                routed_ms=c["routed_ms"], G=G, Q=c["Q"],
                padding_lanes=c["padding_lanes"],
                selecting_lanes=c["selecting_lanes"],
                device_ms_by_kernel=split,
                mixed_device_ms_by_kernel=m_split,
                mixed_Q=QM, mixed_ms=m_ms,
                mixed_device_ms=m_dev, mixed_device_ms_none_selected=m_none,
                mixed_plain_ms=m_plain, mixed_bound_ms=m_bound,
                mixed_operations=n_ops)


def counted_write(torch, client, ops, fn, label):
    """Run one degraded PUT or DELETE chunk; the group probe must launch
    exactly once for each attempt (the first and each retry)."""
    n0, r0 = ops.LAUNCHES["group_probe"], client.stats["retries"]
    out = fn()
    n, tries = ops.LAUNCHES["group_probe"] - n0, client.stats["retries"] - r0
    check(n == 1 + tries, f"{label}: {n} group probe launches for "
          f"{1 + tries} attempts")
    return out


def dist_faults(torch, cfg, rng):
    """Phase 9b: the distributed store's failure handling on the card,
    with the paper's config as users run it (leases on, wall clock).
    Returns (launches, timings, the group probe's max abs error and its
    ``degraded`` record)."""
    from repro_torch.core import kvstore as kv
    from repro_torch.core import log as lg
    from repro_torch.core import tree
    from repro_torch.core.client import DistributedBackend, HiStoreClient
    from repro_torch.kernels import mamba_scan as mscan
    from repro_torch.kernels import ops

    G, B, R = DIST_GROUPS, CHUNK, cfg.n_backups
    n_load = FAULT_KEYS
    need = n_load + FAULT_DIST_FRESH
    uniq = np.unique(rng.integers(0, 2 ** 31 - 1, int(need * 1.02) + 1024))
    check(len(uniq) >= need, "not enough distinct keys drawn")
    keys_all = uniq[rng.permutation(len(uniq))[:need]].astype(np.int32)
    load_keys = keys_all[:n_load]
    model = Model(keys_all, cfg.value_words)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    backend = DistributedBackend(G, cfg, DIST_CAPACITY,
                                 capacity_q=DIST_CAPACITY_Q, device="cuda")
    # the phase times recovery, re-replication and migration apart, so
    # the client migrates when told to (client.migrate()), not on recovery
    client = HiStoreClient(backend, migrate_on_recover=False)
    dev = backend.device
    wl = Workload(torch, client, model, rng, keys_all[n_load:])
    own_all = kv.owner_group(torch.as_tensor(model.keys, device=dev),
                             G).cpu().numpy()

    def own(keys):
        return own_all[model.at(keys)]

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def chunk_put(label, keys=None):
        p = keys if keys is not None else np.concatenate(
            [wl.sample(wl.live_keys(), B // 2), wl.take_fresh(B // 2)])
        vals = wl.new_vals(len(p))
        r = counted_write(torch, client, ops,
                          lambda: client.put(p, vals), label)
        check(bool(r.ok.all()), f"{label}: PUT not acknowledged")
        model.put(p, vals)
        return p, r

    def chunk_delete(label):
        d = np.concatenate([wl.sample(wl.live_keys(), 3 * B // 16),
                            wl.absent(B // 16)])
        rng.shuffle(d)
        return counted_write(torch, client, ops,
                             lambda: wl.delete(d, label), label), d

    def read_back(label, hops=None):
        """Workload.read_back, keeping the GetResult for its hops."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = client.get(model.keys)
        hits = wl.check_answers(r, model.keys, label)
        t = sync_s(t0)
        check(hits == int(model.live.sum()), f"{label}: hit count")
        h, f = r.hops.cpu().numpy(), r.found.cpu().numpy()
        n2 = int((h[f] == 2).sum())
        if hops is not None:
            check(bool((h[f] == hops).all()), f"{label}: hops != {hops} on "
                  f"{int((h[f] != hops).sum())} keys")
        log(f"dist-faults: {label}: {len(model.keys)} keys ({hits} live) in "
            f"{t:.3f} s ({len(model.keys) / t:.0f} GET/s), {n2} of {hits} "
            f"found with hops == 2 ({n2 / max(hits, 1):.1%})")
        return len(model.keys) / t, n2

    log(f"dist-faults: DistributedBackend({G} groups x {DIST_CAPACITY}, "
        f"capacity_q {DIST_CAPACITY_Q}), lease_misses {backend.lease_misses}"
        f", {backend.lease_clock} clock, lease_timeout_s "
        f"{backend.lease_timeout_s}")
    t0 = time.perf_counter()
    vals = wl.new_vals(n_load)
    r = client.put(load_keys, vals)
    ok = r.ok.cpu().numpy()
    t_load = sync_s(t0)
    check(ok.all(), f"dist-faults load: {(~ok).sum()} PUTs not acknowledged")
    model.put(load_keys, vals)
    log(f"dist-faults: loaded {n_load} keys in {t_load:.3f} s "
        f"({n_load / t_load:.0f} PUT/s, leases on)")
    times = dict(load_s=t_load, put_per_s=n_load / t_load)
    zero_launches(ops)
    zero_launches(mscan)

    # -- 1. index server 3 fails (oracle) ----------------------------------
    fr = client.fail_server(3)
    check(tuple(fr) == (3, True), f"fail_server(3) answered {fr}")
    p, r = chunk_put("dist-faults PUT, server 3 down")
    o, rep = own(p), r.replicas.cpu().numpy()
    held = np.isin(o, [1, 2])
    check(bool((rep[held] == R - 1).all()),
          "groups 1 and 2 (server 3 holds a replica) must report "
          f"{R - 1} replicas")
    check(bool((rep[~held & (o != 3)] == R).all()),
          f"the groups server 3 holds nothing of must report {R}")
    log(f"dist-faults: server 3 down ({fr}): PUT replicas {R - 1} for "
        f"groups 1, 2 ({int(held.sum())} keys), {R} for groups 0, 4-7, "
        f"{sorted(set(rep[o == 3].tolist()))} for group 3 at its temporary "
        f"primary")
    times["degraded_get_per_s"], times["degraded_hops2"] = read_back(
        "degraded read-back, server 3 down")
    t0 = time.perf_counter()
    scans = 0
    for rnd in range(DEGRADED_ROUNDS):
        chunk_put(f"dist-faults degraded round {rnd}")
        _, d = chunk_delete(f"dist-faults degraded round {rnd}")
        g = wl.get_mix(B)
        if rnd == DEGRADED_ROUNDS - 1:
            probe_at = (backend.store, g)
        wl.check_get(g, f"dist-faults degraded round {rnd} GET")
        client.apply()
        backend.gc_round()
        for _ in range(SCANS):
            wl.scan(f"dist-faults degraded round {rnd}")
            scans += 1
        wl.check_get(d, f"dist-faults degraded round {rnd} GET after DELETE")
    times["degraded_rounds_s"] = sync_s(t0)
    log(f"dist-faults: {DEGRADED_ROUNDS} degraded rounds in "
        f"{times['degraded_rounds_s']:.3f} s ({scans} SCANs complete, group "
        f"2's served by its replica 1; one group probe launch per attempt "
        f"of each PUT and DELETE chunk)")

    # -- 2. the group probe against its plain version, on that GET chunk ---
    # (its launches are not the phase's; the captured store leaves the card
    # before the recoveries, and the comparison's seconds and peak are kept
    # out of the phase's)
    counts, peak = dict(ops.LAUNCHES), torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    err, degraded = compare_group_probe_degraded(torch, cfg, probe_at)
    del probe_at
    torch.cuda.empty_cache()
    t_cmp = sync_s(t0)
    ops.LAUNCHES.update(counts)
    torch.cuda.reset_peak_memory_stats()

    # -- 3. server 3 recovers online; then the migration --------------------
    t0 = time.perf_counter()
    rr = client.recover_server(3, re_replicate=False)
    times["recover_rebuild_s"] = sync_s(t0)
    t0 = time.perf_counter()
    rv = client.recover_server(3)       # alive: the re-replication pass
    times["recover_re_replicate_s"] = sync_s(t0)
    t0 = time.perf_counter()
    moved = client.migrate()
    times["migrate_s"] = sync_s(t0)
    check(moved > 0, "no stray written at the temporary primary moved home")
    log(f"dist-faults: recover_server(3) online {rr} in "
        f"{times['recover_rebuild_s']:.3f} s; re-replication {rv} in "
        f"{times['recover_re_replicate_s']:.3f} s; migrate moved {moved} "
        f"values home in {times['migrate_s']:.3f} s")
    times["recovered_get_per_s"], _ = read_back(
        "read-back after recovery and migration", hops=1)

    # -- 4. data server 5 fails --------------------------------------------
    fd = client.fail_data_server(5)
    check(tuple(fd) == (5, True), f"fail_data_server(5) answered {fd}")
    live = wl.live_keys()
    k5 = live[own(live) == 5]
    k5 = k5[wl.rng.permutation(len(k5))[:B]]
    r = client.get(k5)
    wl.check_answers(r, k5, "dist-faults GET of shard 5, data server 5 down")
    h = r.hops.cpu().numpy()
    check(bool((h == 2).all()), "shard 5's values must come from the mirror "
          "(hops == 2)")
    fresh5 = wl.fresh[own(wl.fresh) == 5][:B // 4]
    wl.fresh = wl.fresh[~np.isin(wl.fresh, fresh5)]
    p5 = np.concatenate([k5[:B // 4], fresh5])
    _, r = chunk_put("dist-faults PUT to group 5, data server 5 down", p5)
    sh = (r.addrs.cpu().numpy() // DIST_CAPACITY)
    check(bool((sh == 6).all()), "group 5's PUTs must be displaced one hop "
          f"(shards {sorted(set(sh.tolist()))})")
    t0 = time.perf_counter()
    client.recover_data_server(5)
    times["recover_data_s"] = sync_s(t0)
    t0 = time.perf_counter()
    moved5 = client.migrate()
    times["migrate_data_s"] = sync_s(t0)
    check(moved5 > 0, "the displaced values did not move home")
    log(f"dist-faults: data server 5 down ({fd}): {len(k5)} GETs of its "
        f"shard served by the mirror (hops 2), {len(p5)} PUTs to group 5 "
        f"displaced to shard 6; recover_data_server(5) with its sweep in "
        f"{times['recover_data_s']:.3f} s; migrate moved {moved5} in "
        f"{times['migrate_data_s']:.3f} s")
    read_back("read-back after data recovery", hops=1)

    # -- 5. adjacent servers 3 and 4 fail ----------------------------------
    client.drain()
    stale = tree.at(backend.store.bsorted, 1, 4)   # replica 1 of group 2
    for s_ in (3, 4):
        check(tuple(client.fail_server(s_)) == (s_, True), f"fail {s_}")
    chunk_put("dist-faults PUT, servers 3 and 4 down")
    chunk_delete("dist-faults DELETE, servers 3 and 4 down")
    m_live = wl.live_keys()
    lo = int(wl.rng.choice(m_live))
    hi = lo + (1 << 24)
    sres = client.scan(lo, hi, 128)
    check(sres.complete is False and sres.missing_groups == (2,),
          f"SCAN with group 2's holders down: complete {sres.complete}, "
          f"missing {sres.missing_groups}")
    in_range = model.scan(lo, hi, 1 << 30)
    want = in_range[own(in_range) != 2][:128]
    n = int(sres.count)
    check(n == len(want) and np.array_equal(sres.keys[:n].cpu().numpy(),
                                            want),
          "SCAN with group 2 missing: the other groups' keys differ")
    check(bool((own(in_range[:256]) == 2).any()), "the SCAN's range holds "
          "no key of group 2")
    t0 = time.perf_counter()
    r3 = client.recover_server(3)
    t3 = sync_s(t0)
    fallback = int(backend.store.blog.tail[0, 3])
    check(fallback == 0, "group 2's copy on server 3 was not rebuilt from "
          "its authority (the multi-failure fallback)")
    t0 = time.perf_counter()
    r4 = client.recover_server(4)
    t4 = sync_s(t0)
    moved34 = client.migrate()
    read_back("read-back after the double recovery")
    # a stale copy: replica 1 of group 2 on server 4 as it stood before the
    # double failure (what a server restored from an old image holds); the
    # protocol's own recoveries leave no divergent copy, so re_replicate
    # is held to rebuilding this one
    with backend._mu:
        empty = lg.create(cfg.log_capacity, dev)
        backend.store = backend.store._replace(
            bsorted=tree.put(backend.store.bsorted, stale, 1, 4),
            blog=tree.put(backend.store.blog, empty, 1, 4))
    t0 = time.perf_counter()
    rs = client.recover_server(4)
    times["re_replicate_stale_s"] = sync_s(t0)
    check(rs.re_replicated >= 1, f"re_replicate rebuilt no copy: {rs}")
    times.update(recover_3_of_pair_s=t3, recover_4_of_pair_s=t4)
    log(f"dist-faults: servers 3 and 4 down: SCAN complete=False, missing "
        f"{sres.missing_groups}, {n} keys of the other groups equal to the "
        f"model; recover_server(3) {r3} in {t3:.3f} s (group 2's replica 0 "
        f"rebuilt from its hash + the data items' keys), recover_server(4) "
        f"{r4} in {t4:.3f} s; migrate moved {moved34}; a stale replica 1 of "
        f"group 2 on server 4: recover_server(4) {rs}, "
        f"{times['re_replicate_stale_s']:.3f} s")

    # -- 6. severed servers, found by the wall-clock lease ------------------
    def until(cond, label):
        t0, n = time.monotonic(), 0
        while not cond():
            check(time.monotonic() - t0 < 30, f"{label}: not detected")
            wl.check_get(wl.get_mix(B), f"dist-faults {label}, traffic")
            n += 1
        return time.monotonic(), n

    def severed(sever, dead, hb_t, s_, label):
        """Sever server s_ right after an observation round (a GET chunk),
        then GET traffic until the lease demotes it.  The lease runs from
        the last heartbeat the client saw, that round's; returns (seconds
        from the sever, from that heartbeat, between the two, chunks)."""
        wl.check_get(wl.get_mix(B), f"dist-faults before {label}")
        t_hb = float(hb_t()[s_])
        t_sev = time.monotonic()
        sever(s_)
        t_det, n = until(lambda: s_ in dead(), label)
        check(t_det - t_hb >= backend.lease_timeout_s,
              f"{label}: demoted {t_det - t_hb:.3f} s after the last "
              f"heartbeat seen, before the lease ran out")
        return t_det - t_sev, t_det - t_hb, t_sev - t_hb, n

    sev = severed(client.sever_server, lambda: backend._dead,
                  lambda: backend._hb_t, 6, "sever_server(6)")
    check(backend.detected == [6], f"detected {backend.detected}")
    times["sever_index_detect_s"], times["sever_index_lease_s"] = sev[:2]
    client.recover_server(6)
    client.migrate()
    dsev = severed(client.sever_data_server, lambda: backend._data_dead,
                   lambda: backend._data_hb_t, 1, "sever_data_server(1)")
    check(backend.detected_data == [1], f"detected {backend.detected_data}")
    check(backend.detected == [6], f"index demotions {backend.detected}")
    times["sever_data_detect_s"], times["sever_data_lease_s"] = dsev[:2]
    chunk_put("dist-faults PUT, data server 1 detected down")
    client.recover_data_server(1)
    client.migrate()
    log(f"dist-faults: sever_server(6) demoted by the lease {sev[0]:.3f} s "
        f"after the sever ({sev[1]:.3f} s after the last heartbeat seen, "
        f"{sev[2]:.4f} s before the sever; {sev[3]} GET chunks, every "
        f"answer right); sever_data_server(1) {dsev[0]:.3f} s after the "
        f"sever ({dsev[1]:.3f} s, {dsev[2]:.4f} s; {dsev[3]} chunks); "
        f"detected {backend.detected}, detected_data "
        f"{backend.detected_data}; no oracle call")

    # -- 7. drain, then the parity audit -----------------------------------
    t0 = time.perf_counter()
    client.drain()
    report = kv.parity_report(backend.store, cfg)
    times["audit_s"] = sync_s(t0)
    slots = report[-1]
    check(slots["kind"] == "value_slots" and slots["agree"]
          and slots["fq_spill"] == 0, f"dist-faults value slots: {slots}")
    bad = [e for e in report[:-1] if not e["agree"]]
    check(not bad, f"dist-faults parity: {bad[:3]}")
    n_live = sum(e["n_hash"] for e in report[:-1] if e["replica"] == 0)
    check(n_live == int(model.live.sum()) == slots["live"],
          f"dist-faults parity: {n_live} live items, model "
          f"{int(model.live.sum())}")
    read_back("final read-back", hops=1)
    launches = {**ops.LAUNCHES, **mscan.LAUNCHES}
    for k in DIST_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched in phase 9b")
    times["phase_s"] = time.perf_counter() - t_phase - t_cmp
    times["probe_compare_s"] = t_cmp
    times["peak_bytes"] = max(peak, torch.cuda.max_memory_allocated())
    times["retries"] = client.stats["retries"]
    times["migrated"] = client.stats["migrated"]
    log(f"dist-faults: parity_report agrees ({len(report) - 1} entries, "
        f"value slots {json.dumps(slots)}); launches {launches}; phase "
        f"{times['phase_s']:.3f} s, peak {times['peak_bytes']} B "
        f"({times['peak_bytes'] / 2**30:.3f} GiB)")
    log_metrics(client, "dist-faults")
    return launches, times, err, degraded


def probe_get_chunk(torch, cfg, probe_at, label):
    """The group probe against its plain version as a distributed GET
    calls it: a GET chunk routed as that GET routed it, one stacked call
    for the G servers' exchange buffers (Q = G * capacity_q each, mostly
    key_inf padding) against the state that GET read, each server's six
    halves equal to its per-server plain result; timed per call, on the
    device and routed (from the buffers to the halves).  Returns (max
    abs err, the record, the kernel's launch as a closure)."""
    from repro_torch.core import kvstore as kv
    from repro_torch.kernels import ops

    G = DIST_GROUPS
    st, gkeys = probe_at
    dev = st.hb.device
    kt = torch.as_tensor(gkeys, device=dev).reshape(G, -1)
    rk, _, _ = kv.get_exchange(st, kt, torch.ones_like(kt, dtype=torch.bool),
                               G, DIST_CAPACITY_Q)
    state = (st.hash, st.bsorted, st.blog)
    got = ops.group_probe_stacked(cfg, *state, rk)
    err = max_abs_err(torch, got, ops.group_probe_stacked_plain(
        cfg, *state, rk), f"group_probe {label}")
    work = []
    for g in range(G):
        hidx, srt, blogs, sel = ops.server_inputs(*state, rk[g], g)
        err = max(err, max_abs_err(
            torch, [t[g] for t in got[:6]],
            ops.group_probe_plain(cfg, hidx, srt, blogs, rk[g], sel),
            f"group_probe {label}, server {g}"))
        work.append(group_work(torch, rk[g].cpu().numpy(), sel.cpu().numpy(),
                               hidx, srt, blogs, cfg, selects_in=False,
                               n_out=7))

    def kern():
        return ops.group_probe_cuda(rk, None, *state, cfg.slots_per_bucket,
                                    cfg.fanout)

    # lanes selecting a replica, padding among them (key_inf's lanes at
    # the pad server select its replica 0), and those that are keys
    pad = rk == 2 ** 31 - 1
    sel_lanes = torch.stack([(ops.replica_select(got[6][g], g, G,
                                                 cfg.n_backups) != 0).any(1)
                             for g in range(G)])
    sel_keys = sel_lanes & ~pad
    b_bytes, b_n = sum(w[0] for w in work), sum(w[1] for w in work)
    bound, bb_ms, bo_ms = bound_of(b_bytes, b_n)
    return err, dict(
        ms=time_ms(torch, kern, 200), device_ms=device_ms(torch, kern, 200),
        routed_ms=time_ms(torch, lambda: ops.group_probe_stacked(
            cfg, *state, rk), 200),
        plain_ms=time_ms(torch, lambda: ops.group_probe_stacked_plain(
            cfg, *state, rk), 3, warmup=1),
        bound_ms=bound, bound_by="bytes" if bb_ms >= bo_ms else "operations",
        bound_bytes_ms=bb_ms, bound_ops_ms=bo_ms, bytes=b_bytes,
        operations=b_n, Q=rk.shape[1], padding_lanes=int(pad.sum()),
        selecting_lanes=int(sel_lanes.sum()),
        selecting_keys=int(sel_keys.sum()),
        selecting_found=int((sel_keys & got[4]).sum()),
        max_abs_err=err), kern


def compare_group_probe_degraded(torch, cfg, probe_at):
    """The group probe on the degraded store: the last degraded round's
    GET chunk (server 3 dead, its group's lanes at server 4 selecting
    replica 0), as ``probe_get_chunk`` holds and times it."""
    err, c, _ = probe_get_chunk(torch, cfg, probe_at, "degraded GET chunk")
    check(c["selecting_keys"] > 0 and c["selecting_found"] > 0,
          "degraded GET chunk: no lane selected a replica and found its key "
          "there")
    log(f"kernel group_probe (degraded): a GET chunk of {len(probe_at[1])} "
        f"keys with server 3 down, one call for {DIST_GROUPS} servers of "
        f"Q={c['Q']}, every server equal to its plain result; "
        f"{c['padding_lanes']} padding lanes, {c['selecting_keys']} keys "
        f"selecting a replica ({c['selecting_found']} found there): "
        f"{c['ms']:.4f} ms per call, device {c['device_ms']:.4f} ms, routed "
        f"{c['routed_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
        f"{c['bound_ms']:.6f} ms (bytes {c['bound_bytes_ms']:.6f} ms for "
        f"{c['bytes']} B, operations {c['bound_ops_ms']:.6f} ms for "
        f"{c['operations']})")
    return err, c


RANK_WORLDS = (1, 2, 4, 8)         # phase 9c: the largest <= the cards
RANK_ROUNDS = 4                   # 9c's mixed rounds, healthy and degraded
RANK_TIMEOUT_S = 420              # each spawn of 9c, its process groups too
RANK_FAIL = 3                     # the index server 9c fails and recovers
# gloo's all_to_all_single and all_gather take CUDA tensors (checked on the
# card: the PR 27 entry of PERF.md), so 9c also runs 4 ranks over gloo
# sharing the one card, at a quarter of the load: at the full load that
# run took 105 s of the phase's 182
GLOO_CUDA = True
GLOO_LOAD_CUT = 4
RANK_KERNELS = ("hash_probe", "sorted_search", "group_probe", "merge")
# phase 7's groups at half its keys (the gloo run cuts the load more)
# and the keys of 9c's data-plane and ticker segment (``rank_faults``):
# its own store of phase 7's size at 2^19 keys (the gloo run cuts them
# too), leases on the rounds clock, the ticker on the wall clock
RANK_SIZES = {"keys": DIST_KEYS // 2, "capacity": DIST_CAPACITY,
              "capacity_q": DIST_CAPACITY_Q, "chunk": CHUNK,
              "fault_keys": 1 << 19}
FAULT_DATA = 5                   # the data server failed (wiped)
FAULT_ROUNDS = 2                 # degraded mixed rounds while it is down
FAULT_SEVER_DATA = 2             # the data server severed, then detected
FAULT_SEVER_INDEX = 6            # the index server severed under the ticker
TICKER_SLACK_S = 5.0             # detection within timeout + interval + this


def _digest(*xs):
    """sha256 of arrays or tensors, their dtypes and shapes included."""
    h = hashlib.sha256()
    for x in xs:
        a = np.ascontiguousarray(x.cpu().numpy() if hasattr(x, "cpu")
                                 else np.asarray(x))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def rank_client(cfg, sizes, device, comm=None):
    from repro_torch.core.client import DistributedBackend, HiStoreClient

    be = DistributedBackend(DIST_GROUPS, cfg, sizes["capacity"],
                            capacity_q=sizes["capacity_q"], device=device,
                            comm=comm)
    return HiStoreClient(be, max_batch=sizes["chunk"])


class _RankRun:
    """The calls phase 9c makes on a client (a DistributedBackend on one
    process or over ranks), drawn from ``seed`` so that they are the
    same wherever they run: a key pool with its values and live mask,
    the sha256 of every answer in order, and figures."""

    def __init__(self, torch, client, cfg, seed, n_load, extra):
        self.torch, self.client, self.cfg = torch, client, cfg
        self.be = client.backend
        self.comm, self.dev = self.be.comm, self.be.device
        self.CH = client.max_batch
        self.rng = np.random.default_rng(seed)
        need = n_load + extra
        uniq = np.unique(self.rng.integers(0, 2 ** 31 - 1,
                                           int(need * 1.02) + 1024))
        check(len(uniq) >= need, "9c: not enough distinct keys drawn")
        self.keys = uniq[self.rng.permutation(len(uniq))[:need]].astype(
            np.int32)
        self.live = np.zeros(need, bool)
        self.vals = (self.keys.astype(np.int64)[:, None]
                     * np.arange(1, cfg.value_words + 1)
                     % (2 ** 31 - 1)).astype(np.int32)
        self.answers, self.fig = [], {}
        self.n_put = n_load

    def sync(self):
        self.torch.cuda.synchronize(self.dev)

    def per_op(self, n_ops):
        st = self.comm.stats
        return {k: {"calls": st["calls"][k] / n_ops,
                    "bytes": st["bytes"][k] / n_ops} for k in st["calls"]}

    def load(self):
        n = self.n_put
        self.comm.reset_stats()
        t0 = time.perf_counter()
        r = self.client.put(self.keys[:n], self.vals[:n])
        ok = r.ok.cpu().numpy()
        self.sync()
        self.fig["load_s"] = time.perf_counter() - t0
        self.answers.append(_digest(r.ok, r.addrs, r.replicas))
        check(ok.all(), f"9c load: {(~ok).sum()} PUTs not acknowledged")
        self.live[:n] = True
        self.fig["put_per_s"] = n / self.fig["load_s"]
        self.fig["collectives_per_put_chunk"] = self.per_op(n // self.CH)

    def read_back(self, label):
        idx = np.arange(self.n_put)
        self.comm.reset_stats()
        t0 = time.perf_counter()
        r = self.client.get(self.keys[idx])
        found = r.found.cpu().numpy()
        self.sync()
        t = time.perf_counter() - t0
        self.answers.append(_digest(r.addrs, r.found, r.values, r.routed,
                                    r.hops))
        check(np.array_equal(found, self.live[idx]), f"9c {label}: found")
        check(np.array_equal(r.values.cpu().numpy()[found],
                             self.vals[idx][found]), f"9c {label}: values")
        self.fig[f"{label}_get_per_s"] = len(idx) / t
        self.fig[f"{label}_collectives_per_get_chunk"] = self.per_op(
            -(-len(idx) // self.CH))
        return r

    def rounds(self, label, n_rounds):
        client, rng, CH = self.client, self.rng, self.CH
        keys, vals, live = self.keys, self.vals, self.live
        for rnd in range(n_rounds):
            p = np.concatenate([
                rng.choice(np.nonzero(live)[0], CH // 2, replace=False),
                np.arange(self.n_put, self.n_put + CH // 2)])
            self.n_put += CH // 2
            vals[p] += 1
            r = client.put(keys[p], vals[p])
            self.answers.append(_digest(r.ok, r.addrs, r.replicas))
            check(r.all_ok, f"9c {label} round {rnd}: PUT not acked")
            live[p] = True
            d = rng.choice(np.nonzero(live)[0], 3 * CH // 16,
                           replace=False)
            r = client.delete(np.concatenate([keys[d],
                                              -keys[d[:CH // 16]] - 1]))
            self.answers.append(_digest(r.ok, r.found, r.replicas))
            check(r.found.cpu().numpy()[:len(d)].all(),
                  f"9c {label} round {rnd}: DELETE found")
            live[d] = False
            g = rng.choice(self.n_put, CH, replace=False)
            r = client.get(keys[g])
            self.answers.append(_digest(r.addrs, r.found, r.values,
                                        r.routed, r.hops))
            check(np.array_equal(r.found.cpu().numpy(), live[g]),
                  f"9c {label} round {rnd}: GET")
            client.apply()
            self.be.gc_round()
            for _ in range(SCANS):
                lo = int(rng.integers(0, 2 ** 31 - 2 ** 25))
                r = client.scan(lo, lo + 2 ** 24)
                self.answers.append(_digest(r.keys, r.addrs, r.count))
                n = int(r.count)
                want = np.sort(keys[live & (keys >= lo)
                                    & (keys <= lo + 2 ** 24)])[:128]
                check(n == len(want) and np.array_equal(
                    r.keys.cpu().numpy()[:n], want),
                    f"9c {label} round {rnd}: SCAN")

    def parity(self, label):
        from repro_torch.core import kvstore as kv

        self.client.drain()
        report = kv.parity_report(self.be.store, self.cfg, comm=self.comm)
        self.answers.append(_digest(np.frombuffer(
            json.dumps(report).encode(), np.uint8)))
        check(all(e["agree"] for e in report), f"9c {label}: parity")
        check(report[-1]["live"] == int(self.live.sum()),
              f"9c {label}: {report[-1]['live']} live slots")

    def leaves(self, skip=()):
        """sha256 of each leaf of the gathered store (rank 0 only), those
        named in ``skip`` left out."""
        from repro_torch.core import kvstore as kv

        whole = kv.gathered(self.be.store, self.comm)
        if self.comm.rank != 0:
            return {}
        return {path: _digest(leaf) for path, leaf in _store_leaves(whole)
                if path not in skip}


def rank_workload(torch, client, cfg, seed, sizes):
    """Phase 9c's workload on ``client`` (a DistributedBackend of phase
    7's size, on one process or over ranks): the same calls from
    ``seed`` wherever it runs.  Returns (the sha256 of every answer in
    order, the gathered store's leaves by path, figures)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    run = _RankRun(torch, client, cfg, seed, sizes["keys"],
                   2 * RANK_ROUNDS * sizes["chunk"] // 2)
    fig = run.fig
    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0
    run.load()
    t0 = time.perf_counter()
    run.rounds("healthy", RANK_ROUNDS)
    run.sync()
    fig["healthy_rounds_s"] = time.perf_counter() - t0
    run.read_back("read_back")
    scan = client.metrics().latency["scan"]
    fig["scan_ms"] = scan.mean * 1e3
    run.comm.reset_stats()
    client.scan(0, 2 ** 31 - 2)
    fig["collectives_per_scan"] = run.per_op(1)
    run.parity("healthy")
    client.fail_server(RANK_FAIL)
    t0 = time.perf_counter()
    run.rounds("degraded", RANK_ROUNDS)
    run.sync()
    fig["degraded_rounds_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = client.recover_server(RANK_FAIL)
    run.sync()
    fig["recover_s"] = time.perf_counter() - t0
    run.answers.append(_digest(np.array([
        rr.server, rr.online, rr.re_replicated, rr.catch_up_pending,
        client.stats["migrated"]])))
    run.read_back("recovered")
    run.parity("recovered")
    fig["launches"] = dict(ops.LAUNCHES, mamba_scan=ms.LAUNCHES["mamba_scan"])
    fig["ops"] = {k: client.stats[k] for k in ("puts", "gets", "deletes",
                                               "scans", "retries",
                                               "migrated")}
    return run.answers, run.leaves(), fig


def rank_faults(torch, client, cfg, seed, n_keys):
    """Phase 9c's data-plane and ticker segment on ``client`` (its own
    store, leases on the rounds clock), the same calls wherever it runs:
    data server 5 fails (wiped), two degraded mixed rounds, its recovery
    (the shard from its mirror, the allocator's sweep, the migration);
    data server 2 severed, found by the detector, recovered; then, with
    no foreground op, index server 6 severed under the wall-clock ticker,
    which must demote it within the lease timeout and an interval plus
    slack, then its recovery and a read-back.  Returns (the answers'
    sha256 with the detector's lists, the gathered leaves' sha256 but
    the heartbeat counters, which count the ticker's rounds, figures)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops

    be = client.backend
    run = _RankRun(torch, client, cfg, seed + 1, n_keys,
                   FAULT_ROUNDS * client.max_batch // 2)
    fig, comm = run.fig, run.comm

    def timed(label, call):
        comm.reset_stats()
        t0 = time.perf_counter()
        out = call()
        run.sync()
        fig[f"{label}_s"] = time.perf_counter() - t0
        fig[f"{label}_collectives"] = {
            k: {"calls": comm.stats["calls"][k],
                "bytes": comm.stats["bytes"][k]} for k in comm.stats["calls"]}
        return out

    def note(*xs):
        run.answers.append(_digest(np.frombuffer(json.dumps(
            [list(x) if isinstance(x, (set, tuple)) else x for x in xs],
            default=int).encode(), np.uint8)))

    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0
    run.load()
    note(client.fail_data_server(FAULT_DATA))
    t0 = time.perf_counter()
    run.rounds("data_degraded", FAULT_ROUNDS)
    run.sync()
    fig["data_degraded_rounds_s"] = time.perf_counter() - t0
    timed("data_recover", lambda: client.recover_data_server(FAULT_DATA))
    note(client.stats["migrated"], be.detected, be.detected_data)
    r = run.read_back("data_recovered")
    check(bool((r.hops == 1).all()), "9c faults: GETs one hop again")
    note(client.sever_data_server(FAULT_SEVER_DATA))
    probe = run.keys[:client.max_batch]
    n = 0
    while FAULT_SEVER_DATA not in be._data_dead:
        r = client.get(probe)
        run.answers.append(_digest(r.addrs, r.found, r.values, r.hops))
        n += 1
        check(n <= 2 * cfg.lease_misses, "9c faults: data lease not found")
    fig["data_detect_rounds"] = n
    check(be.detected_data == [FAULT_SEVER_DATA], "9c faults: detected")
    timed("data_sever_recover",
          lambda: client.recover_data_server(FAULT_SEVER_DATA))
    note(client.stats["migrated"], be.detected, be.detected_data)
    # the wall-clock ticker: a read renews every lease, then no
    # foreground op runs until the ticker demotes the severed server
    be.lease_clock = "wall"
    r = client.get(probe)
    run.answers.append(_digest(r.addrs, r.found, r.values, r.hops))
    check(client.start_ticker(), "9c faults: ticker")
    try:
        stats0 = dict(client.stats)
        client.sever_server(FAULT_SEVER_INDEX)
        t0 = time.monotonic()
        t_hb = float(be._hb_t[FAULT_SEVER_INDEX])   # its last advance
        budget = be.lease_timeout_s + be.lease_interval_s + TICKER_SLACK_S
        while FAULT_SEVER_INDEX not in be._dead:
            time.sleep(0.005)
            check(time.monotonic() - t0 <= budget,
                  "9c faults: the ticker found no idle sever in time")
        fig["ticker_detect_s"] = time.monotonic() - t0
        check(time.monotonic() - t_hb >= be.lease_timeout_s,
              "9c faults: demoted before the lease ran out")
        check(dict(client.stats) == stats0, "9c faults: a foreground op")
        fig["ticker_rounds"] = client.metrics().counters.get(
            "ticker_rounds", 0)
    finally:
        client.stop_ticker()
        be.lease_clock = "rounds"
    note(be.detected, be.detected_data, sorted(be._dead))
    rr = timed("index_recover",
               lambda: client.recover_server(FAULT_SEVER_INDEX))
    note(rr.server, rr.online, rr.re_replicated, rr.catch_up_pending,
         client.stats["migrated"])
    r = run.read_back("faults_final")
    check(bool((r.hops == 1).all()), "9c faults: final GETs one hop")
    run.parity("faults_final")
    fig["launches"] = dict(ops.LAUNCHES, mamba_scan=ms.LAUNCHES["mamba_scan"])
    fig["ops"] = {k: client.stats[k] for k in ("puts", "gets", "deletes",
                                               "scans", "retries",
                                               "migrated")}
    return run.answers, run.leaves(skip=("hb", "data.hb")), fig


def _store_leaves(x, path=""):
    if hasattr(x, "_fields"):
        for f in x._fields:
            yield from _store_leaves(getattr(x, f),
                                     f"{path}.{f}" if path else f)
    else:
        yield path, x


def collective_ms(torch, comm, sizes, iters=50):
    """Host milliseconds a call (synchronized) of the Comm's collectives
    at the workload's shapes: a GET chunk's key exchange, a PUT's shift
    of its lanes, a SCAN's all_gather."""
    dev = comm.device
    L, G, CH = comm.L, comm.G, sizes["chunk"]
    x = {"k": torch.zeros((L, G * sizes["capacity_q"]), dtype=torch.int32,
                          device=dev)}
    lanes = torch.zeros((L, CH // G), dtype=torch.int32, device=dev)
    scan = torch.zeros((L, 2, 128), dtype=torch.int32, device=dev)
    out = {}
    one = torch.ones((), dtype=torch.int64, device=dev)
    for name, fn in (("exchange", lambda: comm.exchange(x)),
                     ("shift", lambda: comm.shift(lanes, 1)),
                     ("all_gather", lambda: comm.all_gather(scan)),
                     ("agree", lambda: comm.agree(one))):
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    return out


def rank_phase(rank, world, device, seed, sizes):
    """One rank of phase 9c (run by ``launch/ranks.spawn``): the workload,
    then the data-plane and ticker segment on a store of its own."""
    import torch

    from repro_torch.configs.histore import scaled
    from repro_torch.launch import ranks

    cfg = scaled(lease_misses=0)
    torch.cuda.reset_peak_memory_stats(device)
    comm = ranks.comm(DIST_GROUPS, device)
    client = rank_client(cfg, sizes, device, comm)
    answers, leaves, fig = rank_workload(torch, client, cfg, seed, sizes)
    fig["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    fig["collective_ms"] = collective_ms(torch, comm, sizes)
    fig["device"] = str(device)
    del client
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    fcfg = scaled(lease_clock="rounds")
    comm.reset_stats()
    client = rank_client(fcfg, sizes, device, comm)
    faults = rank_faults(torch, client, fcfg, seed, sizes["fault_keys"])
    faults[2]["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return answers, leaves, fig, faults


def _same_answers(got, want, what):
    first = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
    check(got == want, f"{what}: answers differ from the one-process run "
          f"from call {first}")


def dist_ranks(torch, seed):
    """Phase 9c: the distributed store over ranks, one process a rank,
    held bit for bit against the one-process backend on the same
    workload, then the data-plane and ticker segment likewise.  Returns
    (figures, rank 0's launches over NCCL in the workload and in the
    segment)."""
    from repro_torch.configs.histore import scaled
    from repro_torch.launch import ranks

    cfg, fcfg = scaled(lease_misses=0), scaled(lease_clock="rounds")
    W = max(w for w in RANK_WORLDS if w <= torch.cuda.device_count())
    t_phase = time.perf_counter()
    out = {}

    def one_process(sz):
        torch.cuda.reset_peak_memory_stats()
        client = rank_client(cfg, sz, torch.device("cuda"))
        answers, leaves, fig = rank_workload(torch, client, cfg, seed, sz)
        fig["peak_bytes"] = torch.cuda.max_memory_allocated()
        del client
        torch.cuda.empty_cache()
        log(f"ranks: one process at {sz['keys']} keys, {len(answers)} "
            f"answers, {len(leaves)} leaves: {json.dumps(fig)}")
        out[f"one_process_{sz['keys']}"] = fig
        torch.cuda.reset_peak_memory_stats()
        client = rank_client(fcfg, sz, torch.device("cuda"))
        faults = rank_faults(torch, client, fcfg, seed, sz["fault_keys"])
        faults[2]["peak_bytes"] = torch.cuda.max_memory_allocated()
        del client
        torch.cuda.empty_cache()
        log(f"ranks: faults, one process at {sz['fault_keys']} keys, "
            f"{len(faults[0])} answers, {len(faults[1])} leaves: "
            f"{json.dumps(faults[2])}")
        out[f"one_process_faults_{sz['fault_keys']}"] = faults[2]
        return answers, leaves, faults

    runs = [("nccl", W, "nccl", RANK_SIZES)]
    if GLOO_CUDA:
        runs.append(("gloo4", 4, "gloo", {
            **RANK_SIZES, "keys": RANK_SIZES["keys"] // GLOO_LOAD_CUT,
            "fault_keys": RANK_SIZES["fault_keys"] // GLOO_LOAD_CUT}))
    launches = faults_launches = None
    for name, world, backend, sz in runs:
        answers, leaves, faults = one_process(sz)
        t0 = time.perf_counter()
        res = ranks.spawn(rank_phase, world, device="cuda", backend=backend,
                          timeout_s=RANK_TIMEOUT_S, args=(seed, sz))
        wall = time.perf_counter() - t0
        for r, (a, _, f, (fa, _, ff)) in enumerate(res):
            _same_answers(a, answers, f"9c {name} rank {r}")
            _same_answers(fa, faults[0], f"9c {name} faults rank {r}")
            for k in RANK_KERNELS:
                check(f["launches"][k] > 0,
                      f"9c {name} rank {r}: kernel {k} was not launched")
                check(ff["launches"][k] > 0, f"9c {name} faults rank {r}: "
                      f"kernel {k} was not launched")
        for what, got, want in (("", res[0][1], leaves),
                                (" faults", res[0][3][1], faults[1])):
            check(got == want, f"9c {name}{what}: gathered leaves differ: "
                  f"{[k for k in want if got.get(k) != want[k]][:5]}")
        figs = [f for _, _, f, _ in res]
        ffigs = [x[2] for _, _, _, x in res]
        out[name] = {"world": world, "backend": backend, "keys": sz["keys"],
                     "fault_keys": sz["fault_keys"], "wall_s": wall,
                     "ranks": figs, "faults": ffigs}
        log(f"ranks: {name}: W = {world} over {backend} at {sz['keys']} "
            f"keys, answers and the gathered leaves bit-equal to one "
            f"process; {wall:.1f} s with the processes' start; "
            + json.dumps(figs))
        log(f"ranks: {name} faults at {sz['fault_keys']} keys: answers, "
            f"detector lists and the gathered leaves bit-equal to one "
            f"process; " + json.dumps([{
                k: f[k] for k in ("data_recover_s", "data_recover_collectives",
                                  "data_sever_recover_s", "ticker_detect_s",
                                  "ticker_rounds", "index_recover_s",
                                  "peak_bytes")} for f in ffigs]))
        if launches is None:
            launches, faults_launches = figs[0]["launches"], \
                ffigs[0]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ranks: phase 9c in {out['phase_s']:.1f} s")
    return out, launches, faults_launches


SERVE_ARCH = "falcon-mamba-7b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE = 4, 256, 16
SERVE_REQUESTS = 8               # first run: two waves over the 4 slots
SERVE_REPEATS = 2                # prompts of the first wave sent again
SERVE_MAX_NEW = 32
INFO_S = 2048                    # the chunked jnp scan's length (info only)
CROSS_LAYERS = 4                 # depth of the float32 cross-check model
CROSS_TOL = 5e-4                 # rtol and atol of that cross-check
DENSE_ARCH = "mistral-nemo-12b"  # phase 11 (a): full width and depth
LOCAL_ARCH = "gemma3-27b"        # phase 11 (b): full width, depth cut
LOCAL_LAYERS = 12                # two (local x 5, attn) periods of 62
CROSS_LOCAL_LAYERS = 6           # (c): one period, 5 local and 1 global
CROSS_LOCAL_S = 1280             # (c): every local ring of 1024 wraps
CROSS_LOCAL_BLOCK = 256          # (c): q and kv blocks that divide 1280
CROSS_LOCAL_LAST = 8             # (c): positions compared
HYBRID_ARCH = "zamba2-7b"        # phase 12 (a): full width and depth
MLA_ARCH = "deepseek-v2-lite-16b"  # (b): full width and depth
WIDE_MOE_ARCH = "kimi-k2-1t-a32b"  # (c): full width, depth cut
WIDE_MOE_LAYERS = 2              # (c): the dense layer 0 and one MoE layer
CROSS_HYBRID_LAYERS = 6          # (d): five mamba2 layers, one mamba2+shared
CROSS_MOE_LAYERS = 3             # (d): the dense MLA layer, two MoE layers
# the parameter counts jax.eval_shape gives over the JAX package's
# init_params for these configs (kimi-k2 on WIDE_MOE_LAYERS layers);
# tests/test_torch_moe.py::test_full_param_counts_match_jax holds the
# port's Model to them
FAMILY_PARAMS = {HYBRID_ARCH: 7309292112, MLA_ARCH: 15708450304,
                 WIDE_MOE_ARCH: 19923635200}
# the SFU's exponentials per clock per SM, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table)
SFU_PER_CLOCK_PER_SM = 16


def bf16_ulp(torch, a):
    """One bf16 ulp at each value of ``a`` (float32)."""
    e = torch.floor(torch.log2(a.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def sfu_exp_per_s(torch):
    """The card's exponentials per second: SMs x 16 a clock x the SM's
    maximum clock (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_CLOCK_PER_SM * mhz * 1e6, sms, mhz


def scan_bound(torch, x, B_ssm, sfu_rate):
    """(bound ms, bytes ms, exps ms, bytes, exps) of one mamba_scan call:
    x, dt and y read or written once, B and C, A; one exponential per
    (b, t, d, n)."""
    Bsz, S, di = x.shape
    N = B_ssm.shape[-1]
    xb = x.element_size()
    nbytes = Bsz * S * di * (xb + 4 + xb) + 2 * Bsz * S * N * xb + di * N * 4
    exps = Bsz * S * di * N
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_exp = exps / sfu_rate * 1e3
    return max(b_bytes, b_exp), b_bytes, b_exp, nbytes, exps


def block_split(torch, cfg, model, tok, layer=0):
    """The device time of one full-width block of the prefill (``layer``,
    on the prefill's tokens) by operator: the block runs once under
    torch.profiler (CPU and CUDA activity) after a warm-up; each
    operator's self device time (the kernels it launched itself), and the
    kernels no operator launched (the scan, launched through ctypes) by
    name.  Returns ({name: ms}, the block's device ms)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import _frontend

    with torch.no_grad():
        x = _frontend(cfg, model, {"tokens": tok})
        positions = torch.arange(x.shape[1], device=x.device)[None]
        block = model.layers[layer]
        block(cfg, x, positions, model.shared)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            block(cfg, x, positions, model.shared)
            torch.cuda.synchronize()
    ops, total, attributed = {}, 0.0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        if str(e.device_type).endswith("CPU"):
            if not e.key.startswith("aten::"):
                continue        # the profiler's own records (buffer waits)
            ops[e.key] = ops.get(e.key, 0.0) + us / 1e3
            attributed += us / 1e3
        else:
            total += us / 1e3
            if "mamba_scan" in e.key:
                ops["mamba_scan.cu"] = us / 1e3
    ops["other kernels no operator launched"] = max(
        total - attributed - ops.get("mamba_scan.cu", 0.0), 0.0)
    ops = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    log(f"serve: one {type(block).__name__} (layer {layer}, "
        f"{cfg.layer_specs()[layer]}) of {cfg.name}'s "
        f"{tok.shape[1]}-token prefill by "
        f"operator (torch.profiler, device ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ops.items())
        + f"; all kernels {total:.3f} ms")
    return ops, total


def prompt_set(rng, vocab):
    """The engine's requests: SERVE_REQUESTS prompts of 16-48 tokens, then
    SERVE_REPEATS of the first wave's prompts again."""
    first = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(16, 49, SERVE_REQUESTS)]
    return first, first[:SERVE_REPEATS]


def drive_engine(torch, e, first, again):
    """Run the first set, then the repeats; returns (requests, per-step
    (slot -> (rid, pos), logits) log, seconds, seconds in the model's
    decode steps).  A step is timed to a synchronize after it, which the
    engine's argmax(...).cpu() right after would wait for anyway."""
    log, step, model_s = [], e._step, [0.0]

    def recorded(m, c, i):
        who = {s: (r.rid, r.pos) for s, r in enumerate(e.slots)
               if r is not None}
        t = time.perf_counter()
        logits, c = step(m, c, i)
        torch.cuda.synchronize()
        model_s[0] += time.perf_counter() - t
        log.append((who, logits))
        return logits, c

    e._step = recorded
    reqs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for batch in (first, again):
            for prompt in batch:
                e.submit(prompt, max_new=SERVE_MAX_NEW)
                reqs.append(e.queue[-1])
            e.run()
        torch.cuda.synchronize()
    finally:
        # the wrapper refers to the engine: unwrap, so that dropping the
        # engine frees its model at once, not at the next cycle collection
        e._step = step
    return reqs, log, time.perf_counter() - t0, model_s[0]


def prompt_end_logits(log, rid, n):
    for who, logits in log:
        for slot, (r, pos) in who.items():
            if r == rid and pos == n - 1:
                return logits[slot]
    raise RuntimeError(f"request {rid} never fed its prompt's end")


def check_engine(e, reqs, label):
    s = e.stats
    for r in reqs:
        check(r.done and (len(r.tokens) >= r.max_new
                          or r.pos >= e.max_len - 1),
              f"{label}: request {r.rid} did not complete")
    check(not e.queue and all(r is None for r in e.slots),
          f"{label}: requests left in the engine")
    check(s["prefix_hits"] >= SERVE_REPEATS,
          f"{label}: prefix hits {s['prefix_hits']}")
    # the directory drains: every registered page freed by the release
    # SCANs, the free list whole, the hash at most the prefix keys
    from repro_torch.core import hash_index as hix
    n_prefix = len({tuple(r.prompt) for r in reqs})
    n_hash = int(hix.n_items(e.directory.hash))
    check(s["pages_freed"] >= s["pages_registered"] > 0
          and len(e.free_pages) == e.n_pages and n_hash <= n_prefix,
          f"{label}: directory did not drain: {s}, {len(e.free_pages)} "
          f"free of {e.n_pages}, {n_hash} hash items > {n_prefix} prefixes")
    return n_hash


def engine_run(torch, cfg, model, dev, first, again, label):
    """Phase 10's ServingEngine over ``first`` and ``again``, the launch
    counts set to 0 before it, held to phase 10's checks: the directory
    launched the hash probe, search and merge, the scan none.  Returns
    (metrics, the launches, the per-step log)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine

    e = ServingEngine(cfg, model, batch_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                      device=dev)
    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0
    reqs, steps, t_eng, t_model = drive_engine(torch, e, first, again)
    launches = dict(ops.LAUNCHES, mamba_scan=ms.LAUNCHES["mamba_scan"])
    n_hash = check_engine(e, reqs, f"{label} engine")
    n_tok = sum(len(r.tokens) for r in reqs)
    n_steps = e.stats["decode_steps"]
    log(f"{label}: ServingEngine({SERVE_SLOTS} slots, max_len "
        f"{SERVE_MAX_LEN}, page {SERVE_PAGE}) answered {len(reqs)} requests "
        f"in {t_eng:.3f} s: {n_steps} decode steps ({n_steps / t_eng:.2f} "
        f"steps/s), {n_tok} tokens generated ({n_tok / t_eng:.1f} "
        f"tokens/s), {sum(len(r.prompt) for r in reqs)} prompt tokens; the "
        f"model's decode steps {t_model:.3f} s of it ({t_model / t_eng:.1%})"
        f", the directory and the engine's bookkeeping {t_eng - t_model:.3f}"
        f" s; stats {json.dumps(e.stats)}; directory launches {launches}; "
        f"{n_hash} prefix keys left in the hash")
    for k in ("hash_probe", "sorted_search", "merge"):
        check(launches[k] > 0, f"{label}: the directory never ran {k}")
    check(launches["mamba_scan"] == 0, f"{label}: the engine ran the scan")
    out = dict(engine_s=t_eng, engine_model_s=t_model,
               engine_model_share=t_model / t_eng, requests=len(reqs),
               decode_steps=n_steps, decode_steps_per_s=n_steps / t_eng,
               tokens=n_tok, tokens_per_s=n_tok / t_eng, stats=dict(e.stats))
    return out, launches, steps


def prefill_gaps(torch, cfg, model, dev, first, steps, label):
    """Prefill's last-position logits against the engine's decode logits
    after each first-wave prompt (fresh slots), max abs gap over max
    |logit| (information at bf16)."""
    from repro_torch.serving.serve_step import prefill

    gaps = []
    for rid in range(SERVE_SLOTS):          # the first wave: fresh slots
        p = first[rid]
        want = prefill(cfg, model, {"tokens": torch.tensor([p], device=dev)})
        got = prompt_end_logits(steps, rid, len(p))
        gaps.append(float((got - want[0]).abs().max() / want.abs().max()))
    log(f"{label}: {cfg.dtype}, {cfg.n_layers} layers: decode logits after "
        f"each first-wave prompt against prefill's, max abs gap over max "
        f"|logit| {[round(g, 5) for g in gaps]} (information)")
    return gaps


def cross_check(torch, cfg, model, dev, first, again, label):
    """The engine (float32) over ``first`` and ``again``: the decode
    logits after each fresh-slot prompt equal prefill's within
    CROSS_TOL.  Returns the largest gap."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.serve_step import prefill

    e = ServingEngine(cfg, model, batch_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                      device=dev)
    reqs, steps, _, _ = drive_engine(torch, e, first, again)
    check_engine(e, reqs, f"{label} cross-check engine")
    del e
    cross = 0.0
    for rid in range(SERVE_SLOTS):
        p = first[rid]
        want = prefill(cfg, model, {"tokens": torch.tensor([p],
                                                           device=dev)})[0]
        got = prompt_end_logits(steps, rid, len(p))
        gap = (got - want).abs()
        check(bool((gap <= CROSS_TOL + CROSS_TOL * want.abs()).all()),
              f"{label}: request {rid}: decode logits differ from prefill's "
              f"by {float(gap.max()):.4g} ({cfg.dtype}, {cfg.n_layers} "
              f"layers)")
        cross = max(cross, float(gap.max()))
    log(f"{label}: {cfg.dtype}, {cfg.n_layers} layers of full width: decode "
        f"logits after each of the {SERVE_SLOTS} first-wave prompts equal "
        f"prefill's within {CROSS_TOL} (max abs gap {cross:.4g})")
    return cross


def serving(torch, seed):
    """The serving path of falcon-mamba-7b at full width and depth, bf16,
    weights drawn on the card from ``seed``: a warm-up prefill and the
    chunked jnp scan at S = 2048 (info), the 32768-token prefill through
    the CUDA scan (64 launches), the kernel against its plain version on
    layer 0's inputs of that prefill, the ServingEngine over its HiStore
    page directory, and the cross-check of prefill against decode.
    Returns (the mamba_scan record, timings, the directory's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tr
    from repro_torch.serving.serve_step import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(SERVE_ARCH).scaled(ssm_impl="pallas")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = tr.count_params(model)
    p_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    check(6e9 <= n_params <= 9e9 and len(model.layers) == cfg.n_layers,
          f"serve: {n_params} parameters, {len(model.layers)} layers")
    log(f"serve: {SERVE_ARCH} built on the card in {t_init:.3f} s: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params} parameters, {p_bytes} B "
        f"({cfg.dtype}); peak {torch.cuda.max_memory_allocated()} B")

    # -- warm-up and the chunked jnp scan at S = INFO_S (information) ------
    tok = torch.randint(0, cfg.vocab_size, (1, INFO_S), generator=gen,
                        device=dev)
    info = {}
    for impl in ("pallas", "jnp", "pallas"):
        c = cfg.scaled(ssm_impl=impl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(c, model, {"tokens": tok})
        torch.cuda.synchronize()
        info[impl] = (time.perf_counter() - t0, out)
    d_info = float((info["jnp"][1] - info["pallas"][1]).abs().max())
    log(f"serve: prefill at S = {INFO_S} (info): pallas {info['pallas'][0]:.3f}"
        f" s, jnp (chunked scan, {cfg.ssm_chunk}-step chunks) "
        f"{info['jnp'][0]:.3f} s; logits differ by at most {d_info:.4g}")
    del info, out

    # -- the prefill: one sequence of prefill_32k --------------------------
    shape = SHAPES["prefill_32k"]
    S = shape.seq_len
    tok = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=dev)
    captured = []
    scan = ssm.mamba_scan

    def capture(*args):
        if not captured:
            captured.extend(args)        # layer 0's inputs, as passed
        return scan(*args)

    ssm.mamba_scan = capture
    torch.cuda.reset_peak_memory_stats()
    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(cfg, model, {"tokens": tok})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    finally:
        ssm.mamba_scan = scan
    n_scan = ms.LAUNCHES["mamba_scan"]
    peak_prefill = torch.cuda.max_memory_allocated()
    check(n_scan == cfg.n_layers,
          f"serve: mamba_scan launched {n_scan} times, not {cfg.n_layers}")
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "serve: prefill logits")
    log(f"serve: prefill of B = 1 x S = {S} (prefill_32k cut from batch "
        f"{shape.global_batch} to 1) in {t_prefill:.3f} s "
        f"({S / t_prefill:.0f} tokens/s), mamba_scan launched {n_scan} times,"
        f" peak {peak_prefill} B ({peak_prefill / 2**30:.3f} GiB)")

    # -- the kernel against its plain version on layer 0's inputs ----------
    x, dt, B_ssm, C_ssm, A = captured
    del captured
    got = ms.mamba_scan_cuda(x, dt, B_ssm, C_ssm, A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ms.mamba_scan_plain(x, dt, B_ssm, C_ssm, A)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    g32, w32 = got.float(), want.float()
    diff = (g32 - w32).abs()
    tol = bf16_ulp(torch, w32) + 2e-5
    n_off = int((diff > 0).sum())
    check(got.dtype == x.dtype == torch.bfloat16 and got.shape == x.shape,
          "serve: mamba_scan output type or shape")
    check(bool((diff <= tol).all()),
          f"serve: mamba_scan differs from its plain version beyond one "
          f"bf16 ulp: max abs err {float(diff.max()):.4g}")
    err = float(diff.max())
    del got, want, g32, w32, diff, tol

    def kern():
        return ms.mamba_scan_cuda(x, dt, B_ssm, C_ssm, A)

    k_ms = time_ms(torch, kern, 10, warmup=1)
    k_dev = device_ms(torch, kern, 10)
    rate, sms, mhz = sfu_exp_per_s(torch)
    bound, b_bytes, b_exp, nbytes, exps = scan_bound(torch, x, B_ssm, rate)
    log(f"kernel mamba_scan: layer 0 of the prefill, x {tuple(x.shape)} "
        f"{x.dtype}, N = {B_ssm.shape[-1]}: within one bf16 ulp of the plain "
        f"version ({n_off} of {x.numel()} outputs differ, max abs err "
        f"{err:.4g}); {k_ms:.4f} ms per call, device {k_dev:.4f} ms, plain "
        f"{plain:.1f} ms; bound {bound:.4f} ms (exponentials {b_exp:.4f} ms "
        f"for {exps} at {rate:.4g}/s: {sms} SMs x {SFU_PER_CLOCK_PER_SM} a "
        f"clock x {mhz:.0f} MHz; bytes {b_bytes:.4f} ms for {nbytes} B); "
        f"library: none (no PyTorch call computes a selective scan)")
    record = dict(name="mamba_scan", route="cuda",
                  source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                  replaces="src/repro/kernels/mamba_scan.py:53",
                  launches=n_scan, max_abs_err=err, ms=k_ms, plain_ms=plain,
                  bound_ms=bound,
                  bound_by="bytes" if b_bytes >= b_exp else "operations",
                  library_ms=None, device_ms=k_dev, shape=list(x.shape),
                  N=B_ssm.shape[-1], outputs_differing=n_off,
                  bound_bytes_ms=b_bytes, bound_exp_ms=b_exp)
    del x, dt, B_ssm, C_ssm, A, kern
    split, block_ms = block_split(torch, cfg, model, tok)
    record["prefill_block_device_ms_by_op"] = split
    record["prefill_block_device_ms"] = block_ms

    # -- the engine over its HiStore page directory ------------------------
    rng = np.random.default_rng(seed)
    first, again = prompt_set(rng, cfg.vocab_size)
    eng, d_launches, steps = engine_run(torch, cfg, model, dev, first, again,
                                        "serve")
    # -- prefill against decode, bf16 at full depth (information) ----------
    gaps = prefill_gaps(torch, cfg, model, dev, first, steps, "serve")
    peak = torch.cuda.max_memory_allocated()
    del steps, model
    torch.cuda.empty_cache()

    # -- the cross-check at float32, CROSS_LAYERS layers of full width ----
    ccfg = cfg.scaled(n_layers=CROSS_LAYERS, dtype="float32")
    cmodel = tr.init_params(ccfg, gen, device=dev)
    cross = cross_check(torch, ccfg, cmodel, dev, first, again, "serve")
    del cmodel
    torch.cuda.empty_cache()
    times = dict(init_s=t_init, params=n_params, param_bytes=p_bytes,
                 prefill_s=t_prefill, prefill_tokens_per_s=S / t_prefill,
                 prefill_peak_bytes=peak_prefill, peak_bytes=peak,
                 bf16_gaps=gaps, f32_cross_max_abs=cross, **eng)
    return record, times, d_launches


def dense_param_count(cfg):
    """The parameters a dense GQA config gives: the embedding (and an
    untied head), the final norm, and a layer's two norms, q/k/v/o and
    the SwiGLU MLP."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * D + 2 * D * H * hd + 2 * D * Hkv * hd
             + 3 * D * cfg.d_ff)
    tables = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)
    return tables + D + cfg.n_layers * layer


def build_model(torch, cfg, gen, dev, label, count=None):
    """A Model with random weights drawn on the card, its parameter count
    held to ``count`` (by default the one a dense config gives); returns
    (model, seconds, parameters, bytes)."""
    from repro_torch.models import transformer as tr

    count = dense_param_count(cfg) if count is None else count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tr.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    n = tr.count_params(model)
    check(n == count and len(model.layers) == cfg.n_layers,
          f"{label}: {n} parameters, {len(model.layers)} layers; the config "
          f"gives {count}")
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"{label}: {cfg.name} built on the card in {t:.3f} s: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads"
        f" ({cfg.n_kv_heads} kv), window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}, {n} parameters (the config's count), {nbytes} B"
        f" ({cfg.dtype}); peak {torch.cuda.max_memory_allocated()} B")
    return model, t, n, nbytes


def timed_prefill(torch, cfg, model, tok):
    from repro_torch.serving.serve_step import prefill

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(cfg, model, {"tokens": tok})
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


class DropCounter:
    """Counts, on the card, the routed (token, expert) slots the MoE's
    capacity drops while it is entered: it wraps ``moe.dispatch_plan``,
    whose ``keep`` marks the slots kept."""

    def __init__(self, moe):
        self.moe, self.plan = moe, moe.dispatch_plan
        self.dropped, self.slots, self.calls = [], 0, 0

    def __enter__(self):
        def plan(cfg, eidx, C, base=None):
            out = self.plan(cfg, eidx, C, base)
            self.dropped.append((~out[3]).sum())
            self.slots += out[3].numel()
            self.calls += 1
            return out

        self.moe.dispatch_plan = plan
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_plan = self.plan

    def summary(self):
        d = [int(x) for x in self.dropped]
        return dict(dropped_slots=sum(d), routed_slots=self.slots,
                    moe_layers=self.calls,
                    dropped_share=sum(d) / max(self.slots, 1),
                    dropped_max_layer=max(d, default=0))


def family_prefill(torch, cfg, model, gen, dev, S, label):
    """A warm-up prefill at INFO_S, then one sequence of S tokens: finite
    logits, seconds, tokens/s, peak memory and the slots the MoE layers'
    capacity dropped.  Returns (metrics, the tokens)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import moe

    tok = torch.randint(0, cfg.vocab_size, (1, INFO_S), generator=gen,
                        device=dev)
    _, t_warm = timed_prefill(torch, cfg, model, tok)
    tok = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with DropCounter(moe) as drops:
        logits, t_pre = timed_prefill(torch, cfg, model, tok)
    peak = torch.cuda.max_memory_allocated()
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{label}: prefill logits")
    d = drops.summary()
    log(f"{label}: warm-up prefill at S = {INFO_S} in {t_warm:.3f} s; "
        f"prefill of B = 1 x S = {S} (prefill_32k cut from batch "
        f"{SHAPES['prefill_32k'].global_batch} to 1) in {t_pre:.3f} s "
        f"({S / t_pre:.0f} tokens/s), peak {peak} B "
        f"({peak / 2**30:.3f} GiB)" + (
            f"; the MoE capacity dropped {d['dropped_slots']} of "
            f"{d['routed_slots']} routed slots over {d['moe_layers']} layers"
            f" (at most {d['dropped_max_layer']} in a layer)"
            if d["moe_layers"] else ""))
    return dict(prefill_s=t_pre, prefill_tokens_per_s=S / t_pre,
                prefill_peak_bytes=peak, warmup_prefill_s=t_warm,
                prefill_S=S, **d), tok


def dense_serving(torch, seed):
    """Phase 11, the dense GQA family: (a) mistral-nemo-12b at full width
    and depth in bf16 (the 32768-token prefill, one block by operator,
    the ServingEngine over its page directory), (b) gemma3-27b at full
    width on 12 layers (the sliding-window prefill), (c) prefill against
    decode at float32 on full-width layers, the local rings wrapped.
    Returns (timings, the directory's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import transformer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t_phase = time.perf_counter()
    S = SHAPES["prefill_32k"].seq_len
    out = {"held_bytes": torch.cuda.memory_allocated()}
    log(f"dense: {out['held_bytes']} B on the card from earlier phases")

    # -- (a) mistral-nemo-12b at full width and depth, bf16 ----------------
    cfg = get_config(DENSE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model, out["init_s"], out["params"], out["param_bytes"] = build_model(
        torch, cfg, gen, dev, "dense")
    res, tok = family_prefill(torch, cfg, model, gen, dev, S, "dense")
    out.update(res)
    split, block_ms = block_split(torch, cfg, model, tok)
    out["prefill_block_device_ms_by_op"] = split
    out["prefill_block_device_ms"] = block_ms
    del tok

    rng = np.random.default_rng(seed)
    first, again = prompt_set(rng, cfg.vocab_size)
    eng, launches, steps = engine_run(torch, cfg, model, dev, first, again,
                                      "dense")
    gaps = prefill_gaps(torch, cfg, model, dev, first, steps, "dense")
    out.update(eng, bf16_gaps=gaps,
               peak_bytes=torch.cuda.max_memory_allocated())
    del steps, model
    torch.cuda.empty_cache()

    # -- (b) gemma3-27b at full width, depth cut: the sliding window -------
    lcfg = get_config(LOCAL_ARCH).scaled(n_layers=LOCAL_LAYERS)
    log(f"local: {LOCAL_ARCH}'s depth cut from "
        f"{get_config(LOCAL_ARCH).n_layers} to {LOCAL_LAYERS} layers "
        f"({LOCAL_LAYERS // (lcfg.local_global_pattern + 1)} periods of "
        f"{lcfg.local_global_pattern} local + 1 global); width, window "
        f"{lcfg.sliding_window} and tied embeddings as published")
    torch.cuda.reset_peak_memory_stats()
    model, out["local_init_s"], out["local_params"], _ = build_model(
        torch, lcfg, gen, dev, "local")
    tok = torch.randint(0, lcfg.vocab_size, (1, S), generator=gen,
                        device=dev)
    logits, t_loc = timed_prefill(torch, lcfg, model, tok)
    peak_loc = torch.cuda.max_memory_allocated()
    check(logits.shape == (1, lcfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "local: prefill logits")
    log(f"local: prefill of B = 1 x S = {S} in {t_loc:.3f} s "
        f"({S / t_loc:.0f} tokens/s), peak {peak_loc} B "
        f"({peak_loc / 2**30:.3f} GiB)")
    out.update(local_prefill_s=t_loc, local_prefill_tokens_per_s=S / t_loc,
               local_peak_bytes=peak_loc)
    del model, logits, tok
    torch.cuda.empty_cache()

    # -- (c) prefill against decode at float32, TF32 off --------------------
    ccfg = cfg.scaled(n_layers=CROSS_LAYERS, dtype="float32")
    cmodel = build_model(torch, ccfg, gen, dev, "dense cross-check")[0]
    cross = cross_check(torch, ccfg, cmodel, dev, first, again, "dense")
    del cmodel
    torch.cuda.empty_cache()

    gcfg = get_config(LOCAL_ARCH).scaled(
        n_layers=CROSS_LOCAL_LAYERS, dtype="float32",
        attn_q_block=CROSS_LOCAL_BLOCK, attn_kv_block=CROSS_LOCAL_BLOCK)
    gmodel = build_model(torch, gcfg, gen, dev, "local cross-check")[0]
    Sx = CROSS_LOCAL_S
    tok = torch.randint(0, gcfg.vocab_size, (1, Sx), generator=gen,
                        device=dev)
    with torch.no_grad():
        hidden, _ = tr.apply_model(gcfg, gmodel, {"tokens": tok})
        want = tr.hidden_to_logits(gcfg, gmodel,
                                   hidden[:, -CROSS_LOCAL_LAST:])[0]
    del hidden
    cache = tr.init_cache(gcfg, 1, Sx, device=dev)
    caps = sorted({c["pos"].shape[1] for c in cache})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = []
    for t in range(Sx):
        lg, cache = tr.decode_step(gcfg, gmodel, cache, {
            "tokens": tok[:, t:t + 1],
            "pos": torch.full((1,), t, dtype=torch.int32, device=dev)})
        if t >= Sx - CROSS_LOCAL_LAST:
            got.append(lg[0])
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    got = torch.stack(got)
    gap = (got - want).abs()
    ring_min = min(int(c["pos"].min()) for c in cache if
                   c["pos"].shape[1] < Sx)
    check(ring_min > 0, f"local: a local ring did not wrap ({ring_min})")
    check(bool((gap <= CROSS_TOL + CROSS_TOL * want.abs()).all()),
          f"local: decode logits at the last {CROSS_LOCAL_LAST} positions "
          f"differ from prefill's by {float(gap.max()):.4g} (float32)")
    log(f"local: float32, {CROSS_LOCAL_LAYERS} layers of full width "
        f"({gcfg.layer_specs().count(('local', 'mlp'))} local), cache "
        f"slots {caps}: {Sx} decode steps in {t_dec:.3f} s "
        f"({Sx / t_dec:.1f} steps/s), every local ring wrapped (its oldest "
        f"position {ring_min}); the logits at the last {CROSS_LOCAL_LAST} "
        f"positions equal prefill's within {CROSS_TOL} (max abs gap "
        f"{float(gap.max()):.4g})")
    out.update(f32_cross_max_abs=cross,
               local_f32_cross_max_abs=float(gap.max()),
               local_decode_steps_per_s=Sx / t_dec)
    del gmodel, cache, got, want, tok
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dense: phase 11 in {out['phase_s']:.1f} s")
    return out, launches


def family_serving(torch, seed):
    """Phase 12, the hybrid and MoE families: (a) zamba2-7b and (b)
    deepseek-v2-lite-16b at full width and depth in bf16 (the
    32768-token prefill, blocks by operator, the ServingEngine over its
    page directory), (c) kimi-k2 at full width on 2 layers (the prefill),
    (d) prefill against decode at float32 on full-width layers.  Returns
    (timings, the hybrid engine's launches, the MoE engine's)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import transformer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t_phase = time.perf_counter()
    S = SHAPES["prefill_32k"].seq_len
    out = {"held_bytes": torch.cuda.memory_allocated()}
    log(f"families: {out['held_bytes']} B on the card from earlier phases")
    rng = np.random.default_rng(seed)
    launches = {}

    # -- (a) zamba2-7b, (b) deepseek-v2-lite-16b: full width and depth -----
    for key, arch in (("hybrid", HYBRID_ARCH), ("moe", MLA_ARCH)):
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        model, t_init, n, nbytes = build_model(torch, cfg, gen, dev, key,
                                               FAMILY_PARAMS[arch])
        res, tok = family_prefill(torch, cfg, model, gen, dev, S, key)
        res.update(init_s=t_init, params=n, param_bytes=nbytes)
        # the first Mamba2Block and the first shared layer; the first MoE
        # layer
        layers = ([0, cfg.shared_attn_every - 1] if key == "hybrid"
                  else [cfg.first_k_dense])
        for i in layers:
            split, block_ms = block_split(torch, cfg, model, tok, i)
            res[f"layer{i}_device_ms_by_op"] = split
            res[f"layer{i}_device_ms"] = block_ms
        del tok
        first, again = prompt_set(rng, cfg.vocab_size)
        eng, launches[key], steps = engine_run(torch, cfg, model, dev,
                                               first, again, key)
        res.update(eng, bf16_gaps=prefill_gaps(torch, cfg, model, dev, first,
                                               steps, key),
                   peak_bytes=torch.cuda.max_memory_allocated())
        out[key] = res
        del steps, model
        torch.cuda.empty_cache()

        # -- (d) prefill against decode at float32, TF32 off ---------------
        # the MoE model's capacity_factor is n_experts / top_k, so that
        # its prefill drops no slot: decode (4 tokens, capacity 8) never
        # drops one, and with drops prefill and decode compute different
        # functions, in the JAX package too
        ccfg = cfg.scaled(
            n_layers=CROSS_HYBRID_LAYERS if key == "hybrid"
            else CROSS_MOE_LAYERS, dtype="float32",
            capacity_factor=(cfg.n_experts / cfg.top_k if cfg.n_experts
                             else cfg.capacity_factor))
        cmodel = tr.init_params(ccfg, gen, device=dev)
        log(f"{key} cross-check: {ccfg.n_layers} layers "
            f"{ccfg.layer_specs()}, capacity_factor {ccfg.capacity_factor}")
        out[key]["f32_cross_max_abs"] = cross_check(
            torch, ccfg, cmodel, dev, first, again, f"{key} cross-check")
        del cmodel
        torch.cuda.empty_cache()

    # -- (c) kimi-k2 at full width on its first 2 of 61 layers -------------
    kcfg = get_config(WIDE_MOE_ARCH).scaled(n_layers=WIDE_MOE_LAYERS)
    log(f"wide-moe: {WIDE_MOE_ARCH}'s depth cut from "
        f"{get_config(WIDE_MOE_ARCH).n_layers} to {WIDE_MOE_LAYERS} layers "
        f"{kcfg.layer_specs()}; width, {kcfg.n_experts} experts, top-"
        f"{kcfg.top_k} as published")
    torch.cuda.reset_peak_memory_stats()
    model, t_init, n, nbytes = build_model(torch, kcfg, gen, dev, "wide-moe",
                                           FAMILY_PARAMS[WIDE_MOE_ARCH])
    for Sk in (S, S // 2):
        try:
            res, tok = family_prefill(torch, kcfg, model, gen, dev, Sk,
                                      "wide-moe")
            break
        except torch.cuda.OutOfMemoryError:
            if Sk != S:
                raise
            log(f"wide-moe: a prefill of {Sk} tokens does not fit; cut to "
                f"{Sk // 2}")
            torch.cuda.empty_cache()
    res.update(init_s=t_init, params=n, param_bytes=nbytes)
    out["wide_moe"] = res
    del model, tok
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"families: phase 12 in {out['phase_s']:.1f} s")
    return out, launches["hybrid"], launches["moe"]


# ---------------------------------------------------------------------------
# Phase 13: training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "musicgen-large"     # (a): full width and depth
TRAIN_PARAMS = 3229812736         # jax.eval_shape over JAX's init_params
# (a): SHAPES["train_4k"]'s 256 cut to the largest batch that fits on an
# 80 GB H100 (``fits`` probes one sequence more)
TRAIN_BATCH = 8
TRAIN_STEPS = 3                   # (a): steps; the last one split
TRAIN_LR = 3e-4
# (a): step 0's loss within this of ln V.  Logits of unit variance give
# ln V + 0.5 on average; at one batch a random 48-layer stack's logits
# lean toward or away from its targets by up to about 1 more
LOSS0_MARGIN = 1.5
BF16_PEAK = HW.peak_flops         # H100 SXM dense bf16 FLOP/s, data sheet
TINY_STEPS, TINY_LR = 2, 3e-3     # (b): the card against the CPU
METRIC_RTOL = 1e-4                # (b): loss and grad norm
PARAM_ATOL, PARAM_OUTLIERS = 1e-5, 1e-3   # (b), (c): see params_agree
CRASH_AT, CRASH_CKPT, CRASH_STEPS = 3, 2, 6  # (c)


def params_agree(torch, a, b, lr, steps, label):
    """Two trees of parameters (stacked, any devices) after ``steps``
    AdamW steps at ``lr`` from the same start: every element within
    2 * lr * steps (AdamW moves an element by about lr * sign(gradient)
    however small the gradient, so one whose gradient is within float32
    noise of zero may step the other way: at most 2 * lr a step) and
    all but PARAM_OUTLIERS of them within PARAM_ATOL.  Returns (the
    largest gap, the share beyond PARAM_ATOL)."""
    from repro_torch.pytree import leaves

    d = torch.cat([(x.float().cpu() - y.float().cpu()).abs().ravel()
                   for x, y in zip(leaves(a), leaves(b))])
    worst, share = float(d.max()), float((d > PARAM_ATOL).float().mean())
    check(worst <= 2 * lr * steps and share <= PARAM_OUTLIERS,
          f"{label}: parameters {worst} apart, {share:.2e} beyond "
          f"{PARAM_ATOL}")
    return worst, share


def top_ops(prof, n=6):
    """The ``n`` operators with the most self device time (ms)."""
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CPU") and \
                e.key.startswith("aten::"):
            ops[e.key] = round(us / 1e3, 3)
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:n])


def step_split(torch, cfg, model, opt, batch):
    """One train step in its three parts, as ``train_step`` runs them:
    the forward (each layer's input saved, nothing inside it, under
    remat), the backward (each layer's forward recomputed, then its
    gradients) and the AdamW update, each under its own torch.profiler
    and between CUDA events.  Returns (loss, grad norm, {part: device
    ms}, {part: its top operators})."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import param_tree
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.train.step import loss_fn

    names = ("forward", "backward with the recompute", "adamw")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * 3)]
    profs = [profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) for _ in names]

    class Part:
        def __init__(self, i):
            self.i = i

        def __enter__(self):
            profs[self.i].__enter__()
            ev[2 * self.i].record()

        def __exit__(self, *exc):
            ev[2 * self.i + 1].record()
            torch.cuda.synchronize()
            profs[self.i].__exit__(*exc)

    params = param_tree(model, cfg)
    flat = leaves(params)
    with Part(0), torch.enable_grad():
        loss, _ = loss_fn(cfg, model, batch)
    with Part(1):
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    with Part(2):
        _, _, gnorm = adamw_update(params, unflatten(params, grads), opt,
                                   lr=TRAIN_LR)
    split = {k: ev[2 * i].elapsed_time(ev[2 * i + 1])
             for i, k in enumerate(names)}
    return (float(loss.detach()), float(gnorm), split,
            {k: top_ops(p) for k, p in zip(names, profs)})


def fits(torch, cfg, model, batch):
    """Whether one forward and backward of ``batch`` fits on the card
    beside the model and its AdamW state (the batch-size probe: an
    out-of-memory error is the answer, not a failure)."""
    import gc

    from repro_torch.train.step import value_and_grad

    try:
        value_and_grad(cfg, model, batch)
        return True
    except torch.cuda.OutOfMemoryError:
        return False
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def train_full(torch, seed, dev, batch=TRAIN_BATCH):
    """(a) musicgen-large at full width and depth, bf16, seq 4096:
    TRAIN_STEPS steps of ``train_step``, the last one split, then whether
    one sequence more would fit.  Returns (figures, the kernels' launches
    over the measured steps)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.convert import param_tree
    from repro_torch.data.pipeline import SyntheticLM, make_batch
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline.analysis import active_params, model_flops
    from repro_torch.train.step import train_step

    cfg = get_config(TRAIN_ARCH)
    S = SHAPES["train_4k"].seq_len
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    model, t_init, n, nbytes = build_model(torch, cfg, gen, dev, "train",
                                           TRAIN_PARAMS)
    opt = adamw_init(param_tree(model, cfg))
    # the state a step holds: weights, their gradients (the weights'
    # dtype), float32 m and v
    state = 2 * nbytes + 8 * n
    held = torch.cuda.memory_allocated()
    log(f"train: {TRAIN_ARCH}, global batch {batch} (train_4k's "
        f"{SHAPES['train_4k'].global_batch} cut to {batch}), seq {S}, "
        f"remat {cfg.remat!r}, lr {TRAIN_LR}; state {state} B (weights, "
        f"bf16 gradients, float32 m and v), {held} B held before the "
        f"first step")
    ds = SyntheticLM(cfg.vocab_size, S, batch, seed=seed)
    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0
    losses, gnorms, secs = [], [], []
    for step in range(TRAIN_STEPS):
        b = make_batch(ds, step, device=dev, dtype=cfg.param_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step < TRAIN_STEPS - 1:
            model, opt, m = train_step(cfg, model, opt, b, lr=TRAIN_LR)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        else:       # the last step, its parts timed and profiled apart
            loss, gnorm, split_ms, split_ops = step_split(torch, cfg, model,
                                                          opt, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        log(f"train: step {step} loss {loss:.4f} grad_norm {gnorm:.4f} in "
            f"{secs[-1]:.3f} s")
    launches = dict(ops.LAUNCHES, mamba_scan=ms.LAUNCHES["mamba_scan"])
    peak = torch.cuda.max_memory_allocated()
    ln_v = float(np.log(cfg.vocab_size))
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: a loss or grad norm is not finite: {losses} {gnorms}")
    check(abs(losses[0] - ln_v) < LOSS0_MARGIN,
          f"train: step 0's loss {losses[0]} is not within {LOSS0_MARGIN} "
          f"of ln {cfg.vocab_size} = {ln_v:.4f}")
    # no check that the loss falls: AdamW's first steps, as the JAX
    # package takes them (no warm-up, every element moved by about lr),
    # raise it at this width; (c) checks the fall
    # the steps between the first and the profiled last
    steady = float(np.mean(secs[1:-1]))
    tok_s = batch * S / steady
    mfu = model_flops(cfg, *active_params(cfg, param_tree(model, cfg)),
                      ShapeSpec("train_4k", S, batch, "train")
                      ) / steady / BF16_PEAK
    per_seq = (peak - held - nbytes) / batch
    log(f"train: steady {steady:.3f} s a step ({tok_s:.0f} tokens/s, model "
        f"FLOPs share {mfu:.4f} of {BF16_PEAK:.4g}); peak {peak} B "
        f"({peak / 2**30:.3f} GiB) against {state} B of state; about "
        f"{per_seq / 2**30:.3f} GiB a sequence above the weights, their "
        f"gradients and m and v; launches {launches}")
    log(f"train: step {TRAIN_STEPS - 1} split (CUDA events, ms, "
        f"{sum(split_ms.values()) / 1e3:.3f} s in all) "
        f"{json.dumps(split_ms)}; its top operators (torch.profiler, self "
        f"device ms) {json.dumps(split_ops)}")
    b = make_batch(SyntheticLM(cfg.vocab_size, S, batch + 1, seed=seed), 0,
                   device=dev, dtype=cfg.param_dtype)
    more = fits(torch, cfg, model, b)
    log(f"train: a batch of {batch + 1}, one forward and backward beside "
        f"the state: {'fits' if more else 'out of memory'}")
    out = dict(arch=TRAIN_ARCH, params=n, param_bytes=nbytes,
               state_bytes=state, batch=batch, seq=S, init_s=t_init,
               losses=losses, grad_norms=gnorms, step_s=secs,
               steady_step_s=steady, tokens_per_s=tok_s, mfu=mfu,
               peak_bytes=peak, per_sequence_bytes=per_seq,
               next_batch_fits=more, split_ms=split_ms, split_ops=split_ops)
    del model, opt, b
    torch.cuda.empty_cache()
    return out, launches


def train_card_vs_cpu(torch, seed, dev):
    """(b) tiny musicgen-large in float32, the same weights and batches
    on the CPU and the card, TINY_STEPS train steps: loss and grad norm
    within METRIC_RTOL, every parameter by ``params_agree``."""
    import copy

    from repro_torch.configs.tiny import tiny_config
    from repro_torch.convert import param_tree, stack_tree
    from repro_torch.data.pipeline import SyntheticLM, make_batch
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import train_step

    cfg = tiny_config(TRAIN_ARCH)
    cpu = tr.Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    gpu = copy.deepcopy(cpu).to(dev)
    ds = SyntheticLM(cfg.vocab_size, 32, 4, seed=seed)
    sides = [[cpu, adamw_init(param_tree(cpu, cfg)), "cpu"],
             [gpu, adamw_init(param_tree(gpu, cfg)), dev]]
    gaps = {"loss": 0.0, "grad_norm": 0.0}
    for step in range(TINY_STEPS):
        ms = []
        for side in sides:
            side[0], side[1], m = train_step(
                cfg, side[0], side[1],
                make_batch(ds, step, device=side[2]), lr=TINY_LR)
            ms.append(m)
        for k in gaps:
            a, b = float(ms[0][k]), float(ms[1][k])
            check(abs(a - b) <= METRIC_RTOL * abs(a),
                  f"train card vs cpu: step {step} {k} {b} against {a}")
            gaps[k] = max(gaps[k], abs(a - b) / abs(a))
    worst, share = params_agree(
        torch, stack_tree(param_tree(sides[0][0], cfg)),
        stack_tree(param_tree(sides[1][0], cfg)), TINY_LR, TINY_STEPS,
        "train card vs cpu")
    log(f"train: tiny {TRAIN_ARCH} float32, {TINY_STEPS} steps, card "
        f"against CPU: loss and grad norm within {json.dumps(gaps)} "
        f"(relative), parameters within {worst:.3e} ({share:.2e} beyond "
        f"{PARAM_ATOL})")
    return dict(metric_gaps=gaps, param_max_gap=worst,
                param_share_beyond=share)


def train_crash_resume(torch, seed, dev):
    """(c) examples/train_lm_torch.py's default size on the card: a crash
    at CRASH_AT after a checkpoint at CRASH_CKPT, the resume to
    CRASH_STEPS, against an uninterrupted run (``params_agree``: the
    card's backward sums in no fixed order), whose loss must fall below
    step 0's.  The checkpoint directory
    is a temporary one, removed after."""
    import importlib.util
    import tempfile

    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import param_tree, stack_tree
    from repro_torch.train.trainer import train

    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = ex.demo_config()
    shape = ShapeSpec("demo", 128, 8, "train")
    lr = 1e-3
    kw = dict(lr=lr, seed=seed, device=dev)
    with tempfile.TemporaryDirectory() as d:
        try:
            train(cfg, shape, steps=2 * CRASH_STEPS, ckpt_dir=d,
                  ckpt_every=CRASH_CKPT, fail_at=CRASH_AT, log_every=1, **kw)
            crashed = ""
        except RuntimeError as e:
            crashed = str(e)
        check(crashed == f"injected failure at step {CRASH_AT}",
              f"train crash: {crashed!r}")
        check(latest_step(d) == CRASH_CKPT, "train crash: no checkpoint at "
              f"{CRASH_CKPT}")
        res = train(cfg, shape, steps=CRASH_STEPS, ckpt_dir=d,
                    ckpt_every=CRASH_CKPT, log_every=1, **kw)
    hist = res["history"]
    check(hist[0]["step"] == CRASH_CKPT, f"train resume: history starts at "
          f"{hist[0]['step']}")
    ref = train(cfg, shape, steps=CRASH_STEPS, log_every=1, **kw)
    losses = [h["loss"] for h in ref["history"]]
    check(min(losses[1:]) < losses[0], f"train: no step beat step 0's "
          f"loss: {losses}")
    worst, share = params_agree(
        torch, stack_tree(param_tree(res["model"], cfg)),
        stack_tree(param_tree(ref["model"], cfg)), lr, CRASH_STEPS,
        "train resume")
    log(f"train: crash at {CRASH_AT}, resume from {CRASH_CKPT} to "
        f"{CRASH_STEPS} on {cfg.name} ({cfg.d_model} wide, {cfg.n_layers} "
        f"layers, seq {shape.seq_len}, batch {shape.global_batch}): last "
        f"loss {hist[-1]['loss']:.6f} against {ref['history'][-1]['loss']:.6f}"
        f" uninterrupted, parameters within {worst:.3e} ({share:.2e} "
        f"beyond {PARAM_ATOL})")
    return dict(uninterrupted_losses=losses, resumed_loss=hist[-1]["loss"],
                uninterrupted_loss=ref["history"][-1]["loss"],
                param_max_gap=worst, param_share_beyond=share)


def training(torch, seed):
    """Phase 13: (a) musicgen-large trained at full width and depth, (b)
    the card against the CPU, (c) crash and resume.  Returns (figures,
    the kernels' launches over (a)'s steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {"held_bytes": torch.cuda.memory_allocated()}
    log(f"train: {out['held_bytes']} B on the card from earlier phases")
    out["full"], launches = train_full(torch, seed, dev)
    out["card_vs_cpu"] = train_card_vs_cpu(torch, seed, dev)
    out["crash_resume"] = train_crash_resume(torch, seed, dev)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train: phase 13 in {out['phase_s']:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 14: the tools (dry run, roofline, pipeline, elastic self-test)
# ---------------------------------------------------------------------------
PIPE_STAGES, PIPE_MICRO = 4, 8    # (c): S stages, M microbatches
PIPE_SEQ = 1024                   # (c): tokens a microbatch (one sequence)
# (c): float32, TF32 off: the pipelined output and gradients against
# serial application, relative to each tensor's largest magnitude (the
# stages' batched GEMMs under vmap sum in another order than the serial
# ones)
PIPE_RTOL = 1e-4
DRY_CELLS = (33, 7)               # (a): cells ok and skipped, one card


def dry_run_all(torch):
    """(a) The dry run over every cell on the one-card mesh.  Returns
    (the records, seconds)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import local_mesh

    t0 = time.perf_counter()
    recs = dryrun.run(dryrun.all_cells(), local_mesh(),
                      ROOT / "chiprun_out" / "dryrun_torch")
    secs = time.perf_counter() - t0
    n = {k: sum(r["status"] == k for r in recs)
         for k in ("ok", "skipped", "error")}
    check((n["ok"], n["skipped"], n["error"]) == DRY_CELLS + (0,),
          f"dry run: {n}, want {DRY_CELLS[0]} ok and {DRY_CELLS[1]} "
          f"skipped")
    check(all(r["card_bytes"] == torch.cuda.get_device_properties(0)
              .total_memory for r in recs if r["status"] == "ok"),
          "dry run: a cell did not read the card's memory")
    log(f"tools: dry run of {len(recs)} cells on the one-card mesh in "
        f"{secs:.2f} s: {json.dumps(n)}")
    return recs, secs


def step_vs_compute(torch, train_full_out):
    """(b) Phase 13's measured step beside the dry run's compute term for
    the same cell cut to its batch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import tune_for_shape
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.roofline.compositional import compositional_cost

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k", train_full_out["seq"],
                      train_full_out["batch"], "train")
    tuned = compositional_cost(tune_for_shape(cfg, shape), shape)
    run = compositional_cost(cfg, shape)       # phase 13's blocks of 512
    terms = roofline_terms(tuned["flops"], tuned["bytes_unfused"], 0.0)
    step = train_full_out["steady_step_s"]
    out = dict(flops_dry_run=tuned["flops"], flops_phase13_blocks=run["flops"],
               bytes_unfused=tuned["bytes_unfused"], roofline=terms,
               step_s=step, step_over_compute=step / terms["compute_s"],
               model_flops_share=train_full_out["mfu"])
    log(f"tools: {TRAIN_ARCH} train at batch {shape.global_batch} x "
        f"{shape.seq_len}: the dry run's compute term {terms['compute_s']:.4f}"
        f" s ({tuned['flops']:.6g} GEMM FLOPs at attention blocks of 1024; "
        f"{run['flops']:.6g} at phase 13's 512), memory term "
        f"{terms['memory_s']:.4f} s (unfused bytes); phase 13's step "
        f"{step:.4f} s = {out['step_over_compute']:.3f} x the compute term; "
        f"model-FLOPs share {out['model_flops_share']:.4f}")
    return out


def pipeline_stages(torch, cfg, dev, dtype, seed):
    """(c) PIPE_STAGES musicgen-large AttnBlocks on the card, their
    parameters stacked [S, ...] by name, and the stage function (one
    block by ``torch.func.functional_call``) with its positions."""
    from repro_torch.models.transformer import AttnBlock

    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = [AttnBlock(cfg, ("attn", "mlp"), gen, dev)
              for _ in range(PIPE_STAGES)]
    stacked = {k: torch.stack([dict(b.named_parameters())[k].detach()
                               for b in blocks]).to(dtype)
               for k, _ in blocks[0].named_parameters()}
    block = blocks[0].to(dtype)
    positions = torch.arange(PIPE_SEQ, device=dev)[None]

    def stage_fn(p, x):
        return torch.func.functional_call(block, p,
                                          (cfg, x, positions))[0]
    return stacked, stage_fn


def pipeline_step(torch, run, params, x, tgt):
    """Forward and backward of ``run(params, x)``'s mean squared error
    against ``tgt``: (outputs, the parameters' gradients by name)."""
    flat = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        out = run(flat, x)
        loss = torch.mean((out.float() - tgt) ** 2)
        grads = torch.autograd.grad(loss, list(flat.values()))
    return out.detach(), dict(zip(flat, grads))


def pipeline_full(torch, seed, dev):
    """(c) The pipeline at musicgen-large's width against serial
    application, float32 then bf16."""
    from repro_torch.configs import get_config
    from repro_torch.train.pipeline import pipeline_apply

    cfg = get_config(TRAIN_ARCH)
    out = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
           "seq": PIPE_SEQ}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, stage_fn = pipeline_stages(torch, cfg, dev, dtype, seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        x = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model),
                        generator=gen, device=dev).to(dtype)
        tgt = torch.randn(x.shape, generator=gen, device=dev)

        def piped(p, xs):
            return pipeline_apply(stage_fn, p, xs)

        def serial(p, xs):
            ys = []
            for m in range(PIPE_MICRO):
                h = xs[m]
                for s in range(PIPE_STAGES):
                    h = stage_fn({k: v[s] for k, v in p.items()}, h)
                ys.append(h)
            return torch.stack(ys)

        res, ms_ = {}, {}
        for label, run in (("pipelined", piped), ("serial", serial)):
            pipeline_step(torch, run, params, x, tgt)        # warm-up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res[label] = pipeline_step(torch, run, params, x, tgt)
            ev[1].record()
            torch.cuda.synchronize()
            ms_[label] = ev[0].elapsed_time(ev[1])
        (y_p, g_p), (y_s, g_s) = res["pipelined"], res["serial"]
        check(bool(torch.isfinite(y_p.float()).all()),
              f"pipeline {name}: outputs not finite")
        errs = {"output": float((y_p.float() - y_s.float()).abs().max())}
        scale = {"output": float(y_s.float().abs().max())}
        for k in g_s:
            errs[k] = float((g_p[k].float() - g_s[k].float()).abs().max())
            scale[k] = float(g_s[k].float().abs().max())
        worst = max(errs[k] / max(scale[k], 1e-30) for k in errs)
        if dtype == torch.float32:
            check(worst <= PIPE_RTOL, f"pipeline float32: pipelined against "
                  f"serial {worst:.3e} > {PIPE_RTOL} (relative): "
                  f"{json.dumps(errs)}")
        peak = torch.cuda.max_memory_allocated()
        out[name] = dict(step_ms=ms_, max_abs_err=errs["output"],
                         max_rel_err=worst, grad_max_abs_err=max(
                             v for k, v in errs.items() if k != "output"),
                         peak_bytes=peak)
        log(f"tools: pipeline {name}, {PIPE_STAGES} stages of a "
            f"{cfg.name} AttnBlock (d_model {cfg.d_model}, {cfg.n_heads} "
            f"heads, d_ff {cfg.d_ff}), {PIPE_MICRO} microbatches of one "
            f"{PIPE_SEQ}-token sequence, {PIPE_STAGES + PIPE_MICRO - 1} "
            f"ticks: step (forward + backward, CUDA events) pipelined "
            f"{ms_['pipelined']:.3f} ms, serial {ms_['serial']:.3f} ms; "
            f"pipelined against serial: output max abs err "
            f"{errs['output']:.3e}, worst relative (output and every "
            f"gradient) {worst:.3e}; peak {peak} B "
            f"({peak / 2**30:.3f} GiB)")
        del params, stage_fn, piped, serial, x, tgt, res, y_p, y_s, g_p, g_s
    torch.cuda.empty_cache()
    return out


def tools(torch, seed, train_full_out):
    """Phase 14: (a) the dry run, (b) phase 13's step beside its compute
    term, (c) the pipeline at full width, (d) the elastic self-test.
    Returns (figures, the kernels' launches over the phase)."""
    import contextlib
    import io

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.train import elastic_selftest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0
    out = {}
    recs, out["dry_run_s"] = dry_run_all(torch)
    out["dry_run"] = {f"{r['arch']}/{r['shape']}": {
        k: r[k] for k in ("status", "roofline", "fits_one_card", "flops",
                          "bytes_unfused", "model_flops_global")
        if k in r} for r in recs}
    out["step_vs_compute"] = step_vs_compute(torch, train_full_out)
    out["pipeline"] = pipeline_full(torch, seed, dev)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = elastic_selftest.main(["--device", "cuda"])
    check(rc == 0 and "ELASTIC-SELFTEST-OK" in buf.getvalue(),
          f"elastic self-test: {buf.getvalue()[-2000:]}")
    out["selftest_s"] = time.perf_counter() - t0
    log(f"tools: elastic self-test on the card in {out['selftest_s']:.2f} s: "
        f"{' / '.join(ln for ln in buf.getvalue().splitlines() if ' ok' in ln)}"
        f"; ELASTIC-SELFTEST-OK")
    launches = dict(ops.LAUNCHES, mamba_scan=ms.LAUNCHES["mamba_scan"])
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tools: phase 14 in {out['phase_s']:.1f} s; launches {launches}")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 15: training over ranks (torch.distributed, one process a rank)
# ---------------------------------------------------------------------------
RANKS_TRAIN_STEPS = 2             # (a): steps
RANKS_FULL_LAYERS = 8             # (a): of musicgen-large's 48
RANKS_EQUAL_RTOL = 2e-3           # (a) over more than one card
CUT_LAYERS = 4                    # (b): of musicgen-large's 48
CUT_BATCH, CUT_STEPS, CUT_CKPT = 2, 3, 2   # (b): global batch, steps, ckpt
CUT_RTOL = 1e-3                   # (b): each step against one process
MOE_ARCH = "deepseek-v2-lite-16b"  # (b'): the MoE over 2 gloo ranks
MOE_LAYERS = 2                    # (b'): the dense first layer, one MoE
MOE_SEQ, MOE_BATCH, MOE_STEPS = 1024, 2, 2   # (b'): a row a rank
MOE_RTOL = 1e-4                   # (b'): float32, TF32 off
PIPE_RANKS = 4                    # (c): stages, one a gloo rank
COMP_RANKS = 4                    # (d): gloo ranks
CARD_BYTES = 79 * 2 ** 30         # (a): the peak must stay under this
TRAIN_SEQ = 4096                  # SHAPES["train_4k"]'s sequence
RANKS_TIMEOUT_S = 600             # each spawn of phase 15


def kernel_launches():
    """The kernels' launch counts in this process."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    return dict(ops.LAUNCHES, mamba_scan=ms.LAUNCHES["mamba_scan"])


def zero_kernel_launches():
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    zero_launches(ops)
    ms.LAUNCHES["mamba_scan"] = 0


def _no_tf32(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def full_cut_config():
    """(a): musicgen-large at full width on RANKS_FULL_LAYERS layers."""
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).scaled(n_layers=RANKS_FULL_LAYERS)


def cut_config():
    """(b): musicgen-large at full width on CUT_LAYERS layers."""
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).scaled(n_layers=CUT_LAYERS)


def moe_config():
    """(b'): deepseek-v2-lite-16b at full width on MOE_LAYERS layers, in
    float32 so that the ranks and one process route the same tokens."""
    from repro_torch.configs import get_config
    return get_config(MOE_ARCH).scaled(n_layers=MOE_LAYERS, dtype="float32")


def zero_plan_bytes(torch, cfg, world):
    """(whole m bytes, the bytes opt_pspecs plans for one rank of
    {"data": world, "model": 1}, the bytes of the leaves that fall back
    to whole)."""
    from repro_torch.convert import param_tree, stack_like
    from repro_torch.models.transformer import Model
    from repro_torch.pytree import leaves, leaves_with_path, tree_map
    from repro_torch.sharding.partition import (opt_pspecs, per_device_bytes,
                                                spec_at)

    like = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                          device="meta"),
                    stack_like(param_tree(Model(cfg, device="meta",
                                                generator=torch.Generator()),
                                          cfg)))
    mesh = {"data": world, "model": 1}
    plan = opt_pspecs(cfg, {"m": like}, mesh)["m"]
    whole = sum(4 * x.numel() for x in leaves(like))
    fallback = sum(4 * x.numel() for p, x in leaves_with_path(like)
                   if "data" not in spec_at(plan, p))
    return whole, per_device_bytes(like, plan, mesh), fallback


def train_over(torch, dp, seed, cfg, seq, batch, steps, ckpt_dir,
               ckpt_every):
    """(a), (b) and its resume, or (b'): ``train`` of ``cfg`` over ``dp``
    from ``seed``, the gradient all-reduce timed apart (CUDA synchronised
    around it).  Returns the history, the all-reduce's seconds and bytes a
    step, the peak memory and this rank's m and v bytes."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import step as st
    from repro_torch.train.trainer import train

    device = dp.device
    red_s, red_b = [], []
    inner = st.reduce_grads

    def timed(group, grads):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        inner(group, grads)
        torch.cuda.synchronize(device)
        red_s.append(time.perf_counter() - t0)
        red_b.append(sum(g.numel() * g.element_size() for g in grads))

    st.reduce_grads = timed
    dp.reset_stats()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        out = train(cfg, ShapeSpec("train", seq, batch, "train"),
                    steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                    lr=TRAIN_LR, seed=seed, log_every=1, dp=dp)
    finally:
        st.reduce_grads = inner
    torch.cuda.synchronize(device)
    h = out["history"]
    res = dict(steps=[x["step"] for x in h], losses=[x["loss"] for x in h],
               grad_norms=[x["grad_norm"] for x in h],
               wall_s=[x["wall_s"] for x in h],
               run_s=time.perf_counter() - t0, reduce_s=red_s,
               reduce_bytes=red_b,
               peak_bytes=torch.cuda.max_memory_allocated(device),
               m_bytes=out["zero"].nbytes(out["opt"]["m"]),
               v_bytes=out["zero"].nbytes(out["opt"]["v"]),
               collective_bytes=dict(dp.stats["bytes"]))
    del out
    torch.cuda.empty_cache()
    return res


def step_seconds(wall):
    """Seconds of each step from the history's cumulative wall clock."""
    return [b - a for a, b in zip([0.0] + wall[:-1], wall)]


def rank_nccl(rank, world, device, seed, resume_dir):
    """The NCCL ranks of phase 15 (one a card): (a) at full width on
    RANKS_FULL_LAYERS layers, then (b)'s elastic move, the 2-rank
    checkpoint resumed on rank 0 alone."""
    import torch
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    _no_tf32(torch)
    zero_kernel_launches()
    one = dist.new_group([0])            # every rank makes it
    full = train_over(torch, DP(dist.group.WORLD, device), seed,
                      full_cut_config(), TRAIN_SEQ, TRAIN_BATCH,
                      RANKS_TRAIN_STEPS, None, 50)
    moved = None
    if rank == 0:
        t0 = time.perf_counter()
        moved = train_over(torch, DP(one, device), seed, cut_config(),
                           TRAIN_SEQ, CUT_BATCH, CUT_STEPS, resume_dir,
                           CUT_CKPT)
        moved["wall_s_all"] = time.perf_counter() - t0
    dist.barrier()
    return dict(full=full, moved=moved, launches=kernel_launches())


def rank_gloo(rank, world, device, seed, ckpt_dir, want_comp):
    """The 4 gloo ranks of phases 15-17, sharing the card: (b) over
    ranks 0-1 while (b') runs over ranks 2-3, (c) the pipeline, (d) the
    compressed all-reduce (phase 15's launches read here); then phase 16
    (``model_axis_ranks``, whose (d) is the elastic self-test over the 4
    ranks) and phase 17 (``data_axis_ranks``).  Returns each part's
    figures and each phase's launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    _no_tf32(torch)
    zero_kernel_launches()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]   # every rank
    dp = DP(dist.group.WORLD, device)
    out = {}
    t0 = time.perf_counter()
    pair = DP(pairs[rank // 2], device)
    if rank < 2:
        out["cut"] = train_over(torch, pair, seed, cut_config(), TRAIN_SEQ,
                                CUT_BATCH, CUT_STEPS, ckpt_dir, CUT_CKPT)
    else:
        out["moe"] = train_over(torch, pair, seed, moe_config(), MOE_SEQ,
                                MOE_BATCH, MOE_STEPS, None, 50)
    out["pair_s"] = time.perf_counter() - t0
    dp.barrier()
    t0 = time.perf_counter()
    out["pipeline"] = pipeline_over(torch, dp, seed)
    out["pipeline_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["compressed"] = compressed_over(torch, dp, seed, want_comp[rank])
    out["compressed_s"] = time.perf_counter() - t0
    out["launches"] = kernel_launches()
    out["model_axis"] = model_axis_ranks(torch, dp, pair, seed)
    out["data_axis"] = data_axis_ranks(torch, dp, seed)
    return out


def pipeline_over(torch, dp, seed, lr=1e-2):
    """(c) on ``dp``'s PIPE_RANKS ranks: rank 0 runs the stacked
    pipeline over phase 14's 4 AttnBlocks at float32 (the reference) and
    broadcasts each stage's gradients and one SGD step's parameters; then
    every rank runs its stage of the pipeline over ranks on the same
    inputs and holds its outputs, gradients and stepped parameters within
    PIPE_RTOL (relative to each tensor's largest magnitude).  Returns the
    worst errors and the step's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.train.pipeline import pipeline_apply

    cfg = get_config(TRAIN_ARCH)
    dev = dp.device
    params, stage_fn = pipeline_stages(torch, cfg, dev, torch.float32, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=gen,
                    device=dev)
    tgt = torch.randn(x.shape, generator=gen, device=dev)
    y_ref = torch.empty_like(x)
    mine = {k: v[dp.rank].clone() for k, v in params.items()}
    ref = {k: torch.empty_like(v) for k, v in mine.items()}
    stacked_s = None
    if dp.rank == 0:
        def piped(p, xs):
            return pipeline_apply(stage_fn, p, xs)

        pipeline_step(torch, piped, params, x, tgt)     # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y, g_ref = pipeline_step(torch, piped, params, x, tgt)
        torch.cuda.synchronize(dev)
        stacked_s = time.perf_counter() - t0
        y_ref.copy_(y)
        del y
    dp.broadcast(y_ref, 0)
    refs = {}
    for s in range(dp.world):
        for k in ref:
            buf = g_ref[k][s].contiguous() if dp.rank == 0 else ref[k]
            dp.broadcast(buf, 0)
            if s == dp.rank:
                refs[k] = buf.clone()
    if dp.rank == 0:
        del g_ref
    del params
    torch.cuda.empty_cache()

    def run(p, xs):
        return pipeline_apply(stage_fn, p, xs, dp)

    pipeline_step(torch, run, mine, x, tgt)             # warm-up
    dp.reset_stats()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    y, grads = pipeline_step(torch, run, mine, x, tgt)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0

    def rel(a, b):
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

    errs = {"output": rel(y, y_ref)}
    for k, g in grads.items():
        errs[f"grad {k}"] = rel(g, refs[k])
        errs[f"param {k}"] = rel(mine[k] - lr * g, mine[k] - lr * refs[k])
    worst = max(errs.values())
    check(worst <= PIPE_RTOL, f"15c rank {dp.rank}: one stage a rank against"
          f" the stacked pipeline {worst:.3e} > {PIPE_RTOL}: "
          f"{json.dumps(errs)}")
    return dict(max_rel_err=worst, output_rel_err=errs["output"],
                step_s=secs, stacked_step_s=stacked_s,
                shift_bytes=dp.stats["bytes"]["shift"])


def block_grads(torch, cfg, device, seed, rank):
    """(d): one AttnBlock's gradient shapes, random (0.01 x normal) from
    ``seed`` and ``rank``."""
    from repro_torch.models.transformer import AttnBlock

    shapes = {k: v.shape for k, v in AttnBlock(
        cfg, ("attn", "mlp"), torch.Generator(), "meta").named_parameters()}
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + rank)
    return {k: torch.randn(s, generator=gen, device=device) * 0.01
            for k, s in sorted(shapes.items())}


def _digest_tree(torch, tree):
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(tree[k].contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def compressed_want(torch, seed):
    """(d)'s stacked version on this process: each rank's (mean, new
    error state) digests."""
    from repro_torch.configs import get_config
    from repro_torch.optim.compression import dp_allreduce_compressed

    cfg = get_config(TRAIN_ARCH)
    dev = torch.device("cuda")
    gs = [block_grads(torch, cfg, dev, seed, r) for r in range(COMP_RANKS)]
    stacked = {k: torch.stack([g[k] for g in gs]) for k in gs[0]}
    del gs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, new_e = dp_allreduce_compressed(
        stacked, {k: torch.zeros_like(v) for k, v in stacked.items()})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = [(_digest_tree(torch, {k: v[r] for k, v in out.items()}),
             _digest_tree(torch, {k: v[r] for k, v in new_e.items()}))
            for r in range(COMP_RANKS)]
    del stacked, out, new_e
    torch.cuda.empty_cache()
    return want, secs


def compressed_over(torch, dp, seed, want):
    """(d) on this rank: its AttnBlock-sized gradients through
    ``dp_allreduce_compressed`` over ``dp``, bit-equal to the stacked
    version's row (``want``: its digests)."""
    from repro_torch.configs import get_config
    from repro_torch.optim.compression import dp_allreduce_compressed

    g = block_grads(torch, get_config(TRAIN_ARCH), dp.device, seed, dp.rank)
    err = {k: torch.zeros_like(v) for k, v in g.items()}
    dp_allreduce_compressed(g, err, dp)                 # warm-up
    dp.reset_stats()
    torch.cuda.synchronize(dp.device)
    t0 = time.perf_counter()
    out, new_e = dp_allreduce_compressed(g, err, dp)
    torch.cuda.synchronize(dp.device)
    secs = time.perf_counter() - t0
    got = (_digest_tree(torch, out), _digest_tree(torch, new_e))
    check(got == tuple(want), f"15d rank {dp.rank}: the mean or the error "
          f"state differs from the stacked version's")
    return dict(seconds=secs, elements=sum(v.numel() for v in g.values()),
                bytes=dict(dp.stats["bytes"]))


def training_ranks(torch, seed, train13):
    """Phase 15: training over ranks.  (b) one process; the 4 gloo ranks
    ((b) over 2 of them, (c), (d), (e)); the NCCL ranks ((a), (b)'s
    resume).  Returns (figures, the kernels' launches summed over every
    rank and this process)."""
    import shutil
    import tempfile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import ranks
    from repro_torch.models.transformer import count_params
    from repro_torch.train.trainer import train

    _no_tf32(torch)
    t_phase = time.perf_counter()
    zero_kernel_launches()
    torch.cuda.empty_cache()
    out = {"held_bytes": torch.cuda.memory_allocated()}
    log(f"ranks-train: {out['held_bytes']} B on the card from earlier "
        f"phases")
    cfg = cut_config()
    whole, planned, fallback = zero_plan_bytes(torch, cfg, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = train(cfg, ShapeSpec("train_4k", TRAIN_SEQ, CUT_BATCH, "train"),
                steps=CUT_STEPS, lr=TRAIN_LR, seed=seed, log_every=1,
                device="cuda")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    n_cut = count_params(one["model"])
    ref = one["history"]
    del one
    moe_cfg = moe_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with KeptSlots() as spy:
        one = train(moe_cfg, ShapeSpec("train", MOE_SEQ, MOE_BATCH, "train"),
                    steps=MOE_STEPS, lr=TRAIN_LR, seed=seed, log_every=1,
                    device="cuda")
    torch.cuda.synchronize()
    moe_one = dict(s=time.perf_counter() - t0,
                   n=count_params(one["model"]), history=one["history"],
                   kept=spy.kept)
    del one
    torch.cuda.empty_cache()
    full_cfg = full_cut_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = train(full_cfg, ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH,
                                    "train"),
                steps=RANKS_TRAIN_STEPS, lr=TRAIN_LR, seed=seed,
                log_every=1, device="cuda")
    torch.cuda.synchronize()
    full_one = dict(s=time.perf_counter() - t0, history=one["history"],
                    n=count_params(one["model"]))
    del one
    torch.cuda.empty_cache()
    want_comp, comp_stacked_s = compressed_want(torch, seed)
    main15 = kernel_launches()
    zero_kernel_launches()             # phase 16 from here
    t16 = time.perf_counter()
    ma_ref = ma_reference(torch, seed)
    ma_ref_s = time.perf_counter() - t16
    main16 = kernel_launches()
    zero_kernel_launches()             # phase 17 from here
    t17 = time.perf_counter()
    da_ref = da_reference(torch, seed)
    da_ref_s = time.perf_counter() - t17
    main17 = kernel_launches()
    W = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="phase15-") as d:
        a, b = Path(d) / "gloo", Path(d) / "resume"
        t0 = time.perf_counter()
        gl = ranks.spawn(rank_gloo, 4, device="cuda", backend="gloo",
                         timeout_s=RANKS_TIMEOUT_S,
                         args=(seed, str(a), want_comp))
        gloo_wall = time.perf_counter() - t0
        ckpt_bytes = (a / f"step_{CUT_CKPT:08d}.npz").stat().st_size
        b.mkdir()
        for name in (f"step_{CUT_CKPT:08d}.npz",
                     f"manifest_{CUT_CKPT:08d}.json"):
            shutil.copy(a / name, b / name)
        t0 = time.perf_counter()
        nc = ranks.spawn(rank_nccl, W, device="cuda", backend="nccl",
                         timeout_s=RANKS_TIMEOUT_S, args=(seed, str(b)))
        nccl_wall = time.perf_counter() - t0
    out["gloo_wall_s"], out["nccl_wall_s"] = gloo_wall, nccl_wall
    out["full"] = ranks_full_report(nc, full_one, train13, W)
    out["cut"] = ranks_cut_report(gl, nc[0]["moved"], ref, one_s, n_cut,
                                  whole, planned, fallback, ckpt_bytes)
    out["moe"] = ranks_moe_report(gl, moe_one)
    out["pipeline"] = ranks_pipeline_report(gl)
    out["compressed"] = ranks_compressed_report(gl, comp_stacked_s)
    log(f"ranks-train: the gloo ranks {gloo_wall:.1f} s (phase 16's part "
        f"in it) and the NCCL rank(s) {nccl_wall:.1f} s with the processes' "
        f"start")
    counts = [x["launches"] for x in gl + nc] + [main15]
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    ma_out, ma_launches = model_axis_report(gl, ma_ref, moe_one)
    ma_launches = {k: v + main16[k] for k, v in ma_launches.items()}
    ma_out["phase_s"] += ma_ref_s
    ma_out["reference_s"] = ma_ref_s
    log(f"ranks-model: phase 16 with its one-process reference "
        f"({ma_ref_s:.1f} s) in {ma_out['phase_s']:.1f} s; launches "
        f"{ma_launches}")
    check(ma_out["phase_s"] <= MA_BUDGET_S, f"16: {ma_out['phase_s']:.1f} s "
          f"past its {MA_BUDGET_S} s")
    da_out, da_launches = data_axis_report(gl, da_ref)
    da_launches = {k: v + main17[k] for k, v in da_launches.items()}
    da_out["phase_s"] += da_ref_s
    da_out["reference_s"] = da_ref_s
    log(f"ranks-data: phase 17 with its one-process references "
        f"({da_ref_s:.1f} s) in {da_out['phase_s']:.1f} s; launches "
        f"{da_launches}")
    check(da_out["phase_s"] <= DA_BUDGET_S, f"17: {da_out['phase_s']:.1f} s "
          f"past its {DA_BUDGET_S} s")
    out["phase_s"] = (time.perf_counter() - t_phase - ma_out["phase_s"]
                      - da_out["phase_s"])
    log(f"ranks-train: phase 15 in {out['phase_s']:.1f} s (phases 16's "
        f"{ma_out['phase_s']:.1f} s and 17's {da_out['phase_s']:.1f} s "
        f"apart); launches {launches}")
    return out, launches, ma_out, ma_launches, da_out, da_launches


def ranks_full_report(nc, full_one, train13, W):
    """(a): the NCCL ranks against one process at the same depth."""
    fulls = [x["full"] for x in nc]
    r0 = fulls[0]
    want_l = [h["loss"] for h in full_one["history"]]
    want_g = [h["grad_norm"] for h in full_one["history"]]
    for r, x in enumerate(fulls):
        check(x["losses"] == r0["losses"], f"15a: rank {r}'s losses differ")
    if W == 1:
        check(r0["losses"] == want_l and r0["grad_norms"] == want_g,
              f"15a: W = 1 is not bit-equal to one process: {r0['losses']} "
              f"{r0['grad_norms']} against {want_l} {want_g}")
        how = "bit-equal to"
    else:
        gap = max(abs(a - b) / abs(b) for a, b in zip(
            r0["losses"] + r0["grad_norms"], want_l + want_g))
        check(gap <= RANKS_EQUAL_RTOL, f"15a: {gap} from one process")
        how = f"within {gap:.3e} of"
    peak = max(x["peak_bytes"] for x in fulls)
    check(peak < CARD_BYTES, f"15a: peak {peak} B")
    secs = step_seconds(r0["wall_s"])
    log(f"ranks-train: (a) {TRAIN_ARCH} full width on {RANKS_FULL_LAYERS} of "
        f"48 layers ({full_one['n']} parameters, bf16) over {W} NCCL "
        f"rank(s), batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
        f"{r0['losses']} grad norms {r0['grad_norms']} ({how} one process "
        f"at the same depth, {full_one['s']:.2f} s); seconds a step {secs} "
        f"(phase 13's 48 layers: {train13['step_s'][:RANKS_TRAIN_STEPS]}); "
        f"gradient all-reduce {r0['reduce_bytes']} B in {r0['reduce_s']} s "
        f"a step; peak {peak} B ({peak / 2**30:.3f} GiB); m bytes a rank "
        f"{r0['m_bytes']}; collectives {r0['collective_bytes']} B")
    return dict(world=W, layers=RANKS_FULL_LAYERS, losses=r0["losses"],
                grad_norms=r0["grad_norms"], one_losses=want_l,
                step_s=secs, phase13_step_s=train13["step_s"][
                    :RANKS_TRAIN_STEPS], reduce_s=r0["reduce_s"],
                reduce_bytes=r0["reduce_bytes"], peak_bytes=peak,
                m_bytes=r0["m_bytes"], run_s=r0["run_s"],
                collective_bytes=r0["collective_bytes"])


def ranks_moe_report(gl, one):
    """(b'): the MoE over gloo ranks 2-3 against one process."""
    runs = [x["moe"] for x in gl[2:]]
    g = runs[0]
    check(runs[1]["losses"] == g["losses"], "15b': rank 3's losses differ")
    check(g["steps"] == [h["step"] for h in one["history"]],
          f"15b': steps {g['steps']}")
    gaps = []
    for i, h in enumerate(one["history"]):
        for k, key in (("losses", "loss"), ("grad_norms", "grad_norm")):
            gap = abs(g[k][i] - h[key]) / abs(h[key])
            check(gap <= MOE_RTOL, f"15b': step {i} {key} {g[k][i]} against "
                  f"one process's {h[key]}")
            gaps.append(gap)
    secs = step_seconds(g["wall_s"])
    log(f"ranks-train: (b') {MOE_ARCH} full width on {MOE_LAYERS} layers "
        f"(cut; {one['n']} parameters; float32, TF32 off), batch "
        f"{MOE_BATCH} x {MOE_SEQ}, over 2 gloo ranks on the card (remat "
        f"'unit': the MoE's collectives run again in the backward's "
        f"recompute, on autograd's device thread): losses {g['losses']} "
        f"grad norms {g['grad_norms']}, within {max(gaps):.3e} of one "
        f"process ({[h['loss'] for h in one['history']]}; "
        f"{one['s']:.2f} s); seconds a step {secs}; the gradient "
        f"all-reduce {g['reduce_bytes']} B in {g['reduce_s']} s a step; m "
        f"bytes a rank {g['m_bytes']}; peak {g['peak_bytes']} B; "
        f"{gl[2]['pair_s']:.2f} s beside (b)'s {gl[0]['pair_s']:.2f}")
    return dict(losses=g["losses"], grad_norms=g["grad_norms"],
                one_losses=[h["loss"] for h in one["history"]],
                one_grad_norms=[h["grad_norm"] for h in one["history"]],
                max_rel_gap=max(gaps), step_s=secs, one_s=one["s"],
                params=one["n"], reduce_s=g["reduce_s"],
                reduce_bytes=g["reduce_bytes"], m_bytes=g["m_bytes"],
                peak_bytes=g["peak_bytes"], pair_s=gl[2]["pair_s"])


def ranks_cut_report(gl, moved, ref, one_s, n, whole, planned, fallback,
                     ckpt_bytes):
    """(b): the 2 gloo ranks against one process, ZeRO-1's bytes, the
    resume on one NCCL rank."""
    runs = [x["cut"] for x in gl[:2]]
    g = runs[0]
    gaps = []
    for i, h in enumerate(ref):
        for k, key in (("losses", "loss"), ("grad_norms", "grad_norm")):
            gap = abs(g[k][i] - h[key]) / abs(h[key])
            check(gap <= CUT_RTOL, f"15b: step {i} {key} {g[k][i]} against "
                  f"one process's {h[key]}")
            gaps.append(gap)
    for r, x in enumerate(runs):
        check(x["losses"] == g["losses"], f"15b: rank {r}'s losses differ")
        check(x["m_bytes"] == x["v_bytes"] == planned
              and planned <= whole / 2 + fallback,
              f"15b: rank {r} holds {x['m_bytes']} B of m, the plan "
              f"{planned} (whole {whole}, fallback {fallback})")
    check(moved["steps"] == [CUT_CKPT], f"15b: the resume ran "
          f"{moved['steps']}")
    moved_gap = abs(moved["losses"][0] - g["losses"][CUT_CKPT]) / abs(
        g["losses"][CUT_CKPT])
    check(moved_gap <= CUT_RTOL, f"15b: the resumed step {CUT_CKPT} loss "
          f"{moved['losses'][0]} against {g['losses'][CUT_CKPT]}")
    log(f"ranks-train: (b) {TRAIN_ARCH} at full width on {CUT_LAYERS} of 48 "
        f"layers ({n} parameters), global batch {CUT_BATCH} x {TRAIN_SEQ}, "
        f"{CUT_STEPS} steps over 2 gloo ranks on the card, a checkpoint at "
        f"{CUT_CKPT} ({ckpt_bytes} B): losses {g['losses']} grad norms "
        f"{g['grad_norms']}, within {max(gaps):.3e} (relative) of one "
        f"process's {[h['loss'] for h in ref]}; m and v a rank "
        f"{g['m_bytes']} B each (one process {whole}, the plan {planned}, "
        f"{fallback} B of leaves whole); seconds a step "
        f"{step_seconds(g['wall_s'])}, {g['run_s']:.2f} s in all with the "
        f"checkpoints (one process {one_s:.2f} s for {CUT_STEPS} steps), "
        f"gradient all-reduce {g['reduce_bytes']} B in {g['reduce_s']} s a "
        f"step; the step-{CUT_CKPT} checkpoint resumed on one NCCL rank: "
        f"step {CUT_CKPT} loss {moved['losses'][0]} against the gloo run's "
        f"{g['losses'][CUT_CKPT]} ({moved_gap:.3e}), {moved['run_s']:.2f} s")
    return dict(layers=CUT_LAYERS, params=n, losses=g["losses"],
                grad_norms=g["grad_norms"],
                one_process_losses=[h["loss"] for h in ref],
                max_rel_gap=max(gaps), m_bytes=g["m_bytes"],
                whole_m_bytes=whole, planned_m_bytes=planned,
                fallback_m_bytes=fallback, step_s=step_seconds(g["wall_s"]),
                run_s=g["run_s"], reduce_s=g["reduce_s"],
                reduce_bytes=g["reduce_bytes"], checkpoint_bytes=ckpt_bytes,
                one_process_s=one_s, resumed_loss=moved["losses"][0],
                resumed_gap=moved_gap, resume_run_s=moved["run_s"])


def ranks_pipeline_report(gl):
    """(c): the pipeline's errors and seconds over the gloo ranks."""
    p = [x["pipeline"] for x in gl]
    worst = max(x["max_rel_err"] for x in p)
    secs = [x["step_s"] for x in p]
    log(f"ranks-train: (c) the pipeline, {PIPE_RANKS} stages of a "
        f"{TRAIN_ARCH} AttnBlock, one a gloo rank on the card, "
        f"{PIPE_MICRO} microbatches of {PIPE_SEQ} tokens, float32: outputs,"
        f" gradients and one SGD step's parameters within {worst:.3e} "
        f"(relative) of the stacked pipeline; a step (forward and backward) "
        f"{max(secs):.3f} s over ranks (handoffs {p[0]['shift_bytes']} B a "
        f"rank), {p[0]['stacked_step_s']:.3f} s stacked on rank 0; "
        f"{gl[0]['pipeline_s']:.1f} s with the reference")
    return dict(max_rel_err=worst, output_rel_err=max(
        x["output_rel_err"] for x in p), step_s=secs,
        stacked_step_s=p[0]["stacked_step_s"],
        shift_bytes=p[0]["shift_bytes"], part_s=gl[0]["pipeline_s"])


def ranks_compressed_report(gl, stacked_s):
    """(d): the compressed all-reduce's seconds and bytes."""
    c = [x["compressed"] for x in gl]
    n = c[0]["elements"]
    log(f"ranks-train: (d) the compressed all-reduce over {COMP_RANKS} gloo "
        f"ranks on the card, one {TRAIN_ARCH} AttnBlock's gradients a rank "
        f"({n} elements): bit-equal to the stacked version; "
        f"{max(x['seconds'] for x in c):.3f} s over ranks, {stacked_s:.3f} "
        f"s stacked; bytes a rank {c[0]['bytes']} (the int32 payload, "
        f"{4 * n} B, as large as float32's)")
    return dict(elements=n, seconds=[x["seconds"] for x in c],
                stacked_s=stacked_s, bytes=c[0]["bytes"],
                part_s=gl[0]["compressed_s"])


# ---------------------------------------------------------------------------
# Phase 16: the mesh's model axis over ranks (tensor parallelism)
# ---------------------------------------------------------------------------
MA_LAYERS = 4                     # (a): of musicgen-large's 48
MA_SEQ, MA_BATCH, MA_STEPS = 1024, 2, 2     # (a): float32
MA_MESHES = ({"data": 1, "model": 2}, {"data": 2, "model": 2})
MA_RTOL = 1e-4                    # (a), (b): each step against one process
MA_MESH = {"data": 2, "model": 2}  # (b), (c)
MA_SMAP_RTOL = 1e-5               # (c): smap against its stacked form
MA_DECODE_ARCH = "mistral-nemo-12b"
MA_DECODE_LAYERS, MA_DECODE_B, MA_DECODE_S = 2, 4, 64
MA_DECODE_STEPS, MA_DECODE_TOL = 4, 2e-4
MA_BUDGET_S = 150                 # phase 16's seconds, its reference included


def ma_train_config():
    """(a): musicgen-large at full width on MA_LAYERS layers, float32."""
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).scaled(n_layers=MA_LAYERS,
                                         dtype="float32")


class KeptSlots:
    """The MoE's kept slots a dispatch plan (``moe.dispatch_plan``), in
    call order, while installed."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.inner, self.kept = moe, moe.dispatch_plan, []

    def __enter__(self):
        def spy(cfg, eidx, C, base=None):
            res = self.inner(cfg, eidx, C, base)
            self.kept.append(int(res[3].sum()))
            return res
        self.moe.dispatch_plan = spy
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_plan = self.inner


def ma_train(torch, dp, seed, cfg, mesh, seq, batch, steps):
    """(a) or (b) on this rank: ``train`` over ``dp``'s ranks on ``mesh``
    from ``seed``.  Returns the history, this rank's parameter bytes,
    the model group's collectives and the MoE's kept slots a plan."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import param_tree
    from repro_torch.pytree import leaves
    from repro_torch.train.trainer import train

    device = dp.device
    dp.reset_stats()                  # the data group may be dp itself
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with KeptSlots() as spy:
        out = train(cfg, ShapeSpec("train", seq, batch, "train"),
                    steps=steps, lr=TRAIN_LR, seed=seed, log_every=1,
                    dp=dp, mesh=mesh)
    torch.cuda.synchronize(device)
    h = out["history"]
    r = out["ranks"]
    res = dict(losses=[x["loss"] for x in h],
               grad_norms=[x["grad_norm"] for x in h],
               wall_s=[x["wall_s"] for x in h],
               run_s=time.perf_counter() - t0,
               param_bytes=sum(p.numel() * p.element_size() for p in
                               leaves(param_tree(out["model"], cfg))),
               m_bytes=out["zero"].nbytes(out["opt"]["m"]),
               model_calls=dict(r.model.stats["calls"]),
               model_bytes=dict(r.model.stats["bytes"]),
               data_calls=dict(r.data.stats["calls"]),
               data_bytes=dict(r.data.stats["bytes"]),
               peak_bytes=torch.cuda.max_memory_allocated(device),
               coords=r.coords, kept=spy.kept)
    del out
    torch.cuda.empty_cache()
    return res


def ma_smap(torch, dp, seed):
    """(c): deepseek-v2-lite-16b's MoE at full width, float32, with
    moe_impl="smap" under use_mesh on MA_MESH (each rank its data shard's
    rows and expert shard) against ``smap_stacked`` on the same inputs.
    Returns the worst relative gap and the aux loss's."""
    from repro_torch.models.layers import mlp_apply
    from repro_torch.models.moe import (moe_apply, moe_init, route,
                                        smap_stacked)
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.dp import Ranks

    cfg = moe_config().scaled(moe_impl="smap")
    dev = dp.device
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    with torch.no_grad():
        params = moe_init(cfg, gen, dev)
        x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=gen,
                        device=dev)
        ranks = Ranks(dp, MA_MESH)
        E_l = cfg.n_experts // MA_MESH["model"]
        j = ranks.model.rank
        mine = {k: (v[j * E_l:(j + 1) * E_l] if k.startswith("e_") else v)
                for k, v in params.items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with use_mesh(ranks):
            y, aux = moe_apply(cfg, mine, x[ranks.data.rows(MOE_BATCH)])
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        y = ranks.data.all_gather(y.contiguous(), 0)
        aux = ranks.data.sum_(aux.clone())
        xf = x.reshape(-1, cfg.d_model)
        _, _, eidx, gate = route(cfg, params, xf)
        t0 = time.perf_counter()
        want, keep = smap_stacked(cfg, params, xf, eidx, gate,
                                  MA_MESH["data"], MA_MESH["model"])
        want = want + mlp_apply(params["shared"], xf)
        torch.cuda.synchronize(dev)
        stacked_s = time.perf_counter() - t0
        gap = float((y.reshape(want.shape) - want).abs().max()
                    / want.abs().max())
        check(gap <= MA_SMAP_RTOL, f"16c rank {dp.rank}: smap {gap:.3e} "
              f"from its stacked form")
    return dict(rel_gap=gap, aux=float(aux), seconds=secs,
                stacked_s=stacked_s, kept=int(keep.sum()),
                slots=int(eidx.numel()))


def ma_decode(torch, dp, seed):
    """(c): mistral-nemo-12b at full width on MA_DECODE_LAYERS layers,
    float32: MA_DECODE_STEPS decode steps of the whole model (plain) on
    every rank, then of the model cut to each rank's shard under use_mesh
    with decode_cache_hint on MA_MESH, each GQA cache's slots cut over
    the model axis.  Returns the worst gap, the seconds a step both ways
    and the cache's slots a rank."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.dp import Ranks

    cfg = get_config(MA_DECODE_ARCH).scaled(
        n_layers=MA_DECODE_LAYERS, dtype="float32", decode_cache_hint=True)
    dev = dp.device
    B, S = MA_DECODE_B, MA_DECODE_S

    def inputs(t, rows=slice(None)):
        return {"tokens": torch.full((B, 1), 3 + t, dtype=torch.int32,
                                     device=dev)[rows],
                "pos": torch.full((B,), t, dtype=torch.int32,
                                  device=dev)[rows]}

    with torch.no_grad():
        model = tr.Model(cfg, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 17))
        cache = tr.init_cache(cfg, B, S, device=dev)
        ref, plain_s = [], []
        for t in range(MA_DECODE_STEPS):
            t0 = time.perf_counter()
            lg, cache = tr.decode_step(cfg, model, cache, inputs(t))
            torch.cuda.synchronize(dev)
            plain_s.append(time.perf_counter() - t0)
            ref.append(lg)
        del cache
        ranks = Ranks(dp, MA_MESH)
        model.cut_to(ranks)
        torch.cuda.empty_cache()
        rows = ranks.data.rows(B)
        gaps, hint_s = [], []
        with use_mesh(ranks):
            cache = tr.init_cache(cfg, B, S, device=dev, ranks=ranks)
            slots = cache[0]["k"].shape[1]
            for t in range(MA_DECODE_STEPS):
                t0 = time.perf_counter()
                lg, cache = tr.decode_step(cfg, model, cache, inputs(t, rows))
                torch.cuda.synchronize(dev)
                hint_s.append(time.perf_counter() - t0)
                lg = ranks.data.all_gather(lg.contiguous(), 0)
                gaps.append(float(((lg - ref[t]).abs()
                                   - MA_DECODE_TOL * ref[t].abs()).max()))
        worst = max(gaps)
        check(worst <= MA_DECODE_TOL, f"16c rank {dp.rank}: decode with the "
              f"hint {worst:.3e} past {MA_DECODE_TOL} + {MA_DECODE_TOL} x "
              f"|plain|")
        del model, cache, ref
    torch.cuda.empty_cache()
    return dict(worst=worst, plain_s=plain_s, hint_s=hint_s, slots=slots,
                whole_slots=S)


def model_axis_ranks(torch, dp, pair, seed):
    """Phase 16 on the 4 gloo ranks (the kernels' counts set to 0 first):
    (a) on (2 x 2) over all 4, then on (1 x 2) over ranks 0-1; (b) on
    (2 x 2); (c) smap and the decode hint on (2 x 2); (d) the elastic
    self-test's checks over the 4 ranks (``run_ranks``: what
    ``elastic_selftest --ranks 4 --backend gloo`` runs).  Returns each
    part's figures, its seconds and the kernels' launches."""
    from repro_torch.train import elastic_selftest

    zero_kernel_launches()
    dp.barrier()
    t_phase = time.perf_counter()
    out = {"a": {}}
    cfg = ma_train_config()
    t0 = time.perf_counter()
    out["a"]["2x2"] = ma_train(torch, dp, seed, cfg, MA_MESHES[1], MA_SEQ,
                               MA_BATCH, MA_STEPS)
    if dp.rank < 2:
        out["a"]["1x2"] = ma_train(torch, pair, seed, cfg, MA_MESHES[0],
                                   MA_SEQ, MA_BATCH, MA_STEPS)
    dp.barrier()
    out["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = ma_train(torch, dp, seed, moe_config(), MA_MESH, MOE_SEQ,
                        MOE_BATCH, MOE_STEPS)
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["smap"] = ma_smap(torch, dp, seed)
    out["decode"] = ma_decode(torch, dp, seed)
    out["c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    elastic_selftest.run_ranks(dp)
    out["d_s"] = time.perf_counter() - t0
    out["launches"] = kernel_launches()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def ma_reference(torch, seed):
    """(a)'s one-process run on the card (TF32 off), and its parameter
    count."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.transformer import count_params
    from repro_torch.train.trainer import train

    cfg = ma_train_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = train(cfg, ShapeSpec("train", MA_SEQ, MA_BATCH, "train"),
                steps=MA_STEPS, lr=TRAIN_LR, seed=seed, log_every=1,
                device="cuda")
    torch.cuda.synchronize()
    res = dict(history=one["history"], s=time.perf_counter() - t0,
               n=count_params(one["model"]))
    del one
    torch.cuda.empty_cache()
    return res


def _gaps(got, history, what):
    gaps = []
    for i, h in enumerate(history):
        for k, key in (("losses", "loss"), ("grad_norms", "grad_norm")):
            gap = abs(got[k][i] - h[key]) / abs(h[key])
            check(gap <= MA_RTOL, f"{what}: step {i} {key} {got[k][i]} "
                  f"against one process's {h[key]}")
            gaps.append(gap)
    return max(gaps)


def model_axis_report(gl, ref, moe_one):
    """Phase 16's lines: (a) against one process with each rank's bytes,
    (b) with the drops, (c), (d)."""
    ma = [x["model_axis"] for x in gl]
    out = {"phase_s": max(x["phase_s"] for x in ma)}
    whole = 4 * ref["n"]
    for name in ("2x2", "1x2"):
        runs = [x["a"][name] for x in ma if name in x["a"]]
        g = runs[0]
        for r, x in enumerate(runs):
            check(x["losses"] == g["losses"], f"16a {name}: rank {r}'s "
                  f"losses differ")
        gap = _gaps(g, ref["history"], f"16a {name}")
        per = [x["param_bytes"] for x in runs]
        steps = MA_STEPS
        log(f"ranks-model: (a) {TRAIN_ARCH} full width on {MA_LAYERS} layers "
            f"({ref['n']} parameters, float32, TF32 off), batch {MA_BATCH} x "
            f"{MA_SEQ}, {steps} steps on ({name.replace('x', ' data x ')} "
            f"model) gloo ranks on the card: losses {g['losses']} grad norms "
            f"{g['grad_norms']}, within {gap:.3e} (relative) of one process "
            f"({[h['loss'] for h in ref['history']]}, {ref['s']:.2f} s); "
            f"parameter bytes a rank {per} against the whole's {whole}; m "
            f"bytes a rank {g['m_bytes']}; seconds a step "
            f"{step_seconds(g['wall_s'])}; the model group's collectives "
            f"{g['model_calls']} ({g['model_bytes']} B) over {steps} steps")
        out[f"a_{name}"] = dict(losses=g["losses"], grad_norms=g["grad_norms"],
                                max_rel_gap=gap, param_bytes=per,
                                whole_bytes=whole, m_bytes=g["m_bytes"],
                                step_s=step_seconds(g["wall_s"]),
                                model_calls=g["model_calls"],
                                model_bytes=g["model_bytes"])
    b = [x["b"] for x in ma]
    g = b[0]
    gap = _gaps(g, moe_one["history"], "16b")
    by = {x["coords"]: x["kept"] for x in b}
    kept = [sum(by[(d, 0)][i] for d in range(MA_MESH["data"]))
            for i in range(len(by[(0, 0)]))]
    check(kept == moe_one["kept"], f"16b: kept slots {kept} against one "
          f"process's {moe_one['kept']}")
    log(f"ranks-model: (b) {MOE_ARCH} full width on {MOE_LAYERS} layers "
        f"(float32), batch {MOE_BATCH} x {MOE_SEQ}, {MOE_STEPS} steps on (2 "
        f"data x 2 model) gloo ranks, the experts cut over model: losses "
        f"{g['losses']} grad norms {g['grad_norms']}, within {gap:.3e} of "
        f"one process; kept slots a plan {kept} equal to one process's; "
        f"parameter bytes a rank {[x['param_bytes'] for x in b]}; seconds a "
        f"step {step_seconds(g['wall_s'])}; the model group's collectives "
        f"{g['model_calls']}")
    out["b"] = dict(losses=g["losses"], max_rel_gap=gap, kept=kept,
                    param_bytes=[x["param_bytes"] for x in b],
                    step_s=step_seconds(g["wall_s"]),
                    model_calls=g["model_calls"])
    sm = [x["smap"] for x in ma]
    dec = [x["decode"] for x in ma]
    log(f"ranks-model: (c) under use_mesh on (2 x 2): {MOE_ARCH}'s smap "
        f"moe_apply at full width (float32, {MOE_BATCH} x {MOE_SEQ} tokens) "
        f"within {max(x['rel_gap'] for x in sm):.3e} (relative) of its "
        f"stacked form, {sm[0]['kept']} of {sm[0]['slots']} slots kept, "
        f"{max(x['seconds'] for x in sm):.3f} s over ranks, "
        f"{sm[0]['stacked_s']:.3f} s stacked; {MA_DECODE_ARCH} full width on "
        f"{MA_DECODE_LAYERS} layers (float32), {MA_DECODE_STEPS} decode "
        f"steps of batch {MA_DECODE_B} with decode_cache_hint, {dec[0]['slots']}"
        f" of {dec[0]['whole_slots']} cache slots a rank: the logits within "
        f"{MA_DECODE_TOL} + {MA_DECODE_TOL} x |plain| (worst margin "
        f"{max(x['worst'] for x in dec):.3e}); seconds a step "
        f"{dec[0]['hint_s']} (plain {dec[0]['plain_s']})")
    out["c"] = dict(smap_rel_gap=max(x["rel_gap"] for x in sm),
                    smap_s=[x["seconds"] for x in sm],
                    stacked_s=sm[0]["stacked_s"], kept=sm[0]["kept"],
                    slots=sm[0]["slots"],
                    decode_worst=max(x["worst"] for x in dec),
                    decode_s=dec[0]["hint_s"], plain_s=dec[0]["plain_s"],
                    cache_slots=dec[0]["slots"])
    out["parts_s"] = {k: ma[0][f"{k}_s"] for k in ("a", "b", "c", "d")}
    log(f"ranks-model: (d) the elastic self-test over the 4 gloo ranks (its "
        f"lines above: (2 x 2) -> (1 x 4), smap and the hint on (2 x 2)) in "
        f"{ma[0]['d_s']:.2f} s; ELASTIC-SELFTEST-OK")
    counts = [x["launches"] for x in ma]
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    log(f"ranks-model: phase 16 in {out['phase_s']:.1f} s (parts "
        f"{json.dumps(out['parts_s'])}); launches {launches}")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 17: the rest of the mesh's data axis over ranks
# ---------------------------------------------------------------------------
DA_ARCH = "kimi-k2-1t-a32b"       # (a): full width, its dense layer 0
DA_PARAMS = 2833273856            # (a): the embedding, the head, layer 0
DA_SEQ, DA_STEPS = 4096, 2        # (a), (b): batch 1 x 4096
DA_MESH = {"data": 2, "model": 2}  # (a), (c)
DA_RTOL_BF16 = 1e-3               # (a): phase 15 (b)'s bf16 tolerance
DA_MAMBA = (("falcon-mamba-7b", 2), ("zamba2-7b", 6))   # (b): layers
DA_MAMBA_MESH = {"data": 4, "model": 1}
DA_RTOL = 1e-4                    # (b): float32, TF32 off
DA_FSDP_RTOL = 1e-5               # (c): the same global step as 16 (b)
DA_BUDGET_S = 200                 # phase 17's seconds, its references included


def da_kimi_config():
    """(a): kimi-k2-1t-a32b at full width on its dense layer 0 (its MoE
    layer cannot hold a training state on one card), bf16, fsdp from its
    own config."""
    from repro_torch.configs import get_config
    return get_config(DA_ARCH).scaled(n_layers=1, first_k_dense=1)


def da_mamba_config(arch, layers):
    """(b): ``arch`` at full width on ``layers`` layers, float32, the
    chunked scan (the fused one is forward-only)."""
    from repro_torch.configs import get_config
    return get_config(arch).scaled(n_layers=layers, dtype="float32",
                                   ssm_impl="jnp")


def da_reference(torch, seed):
    """Phase 17's one-process runs on the card (TF32 off), each freed
    before the next: (a), then (b)'s two configs, batch 1 x DA_SEQ.
    Returns {key: history, seconds, parameter count, peak}."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.transformer import count_params
    from repro_torch.train.trainer import train

    runs = [("a", da_kimi_config())] + [
        (arch, da_mamba_config(arch, n)) for arch, n in DA_MAMBA]
    res = {}
    for key, cfg in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one = train(cfg, ShapeSpec("train", DA_SEQ, 1, "train"),
                    steps=DA_STEPS, lr=TRAIN_LR, seed=seed, log_every=1,
                    device="cuda")
        torch.cuda.synchronize()
        res[key] = dict(history=one["history"], s=time.perf_counter() - t0,
                        n=count_params(one["model"]),
                        peak=torch.cuda.max_memory_allocated())
        del one
        torch.cuda.empty_cache()
    check(res["a"]["n"] == DA_PARAMS, f"17a: {res['a']['n']} parameters, "
          f"the config gives {DA_PARAMS}")
    return res


def data_axis_ranks(torch, dp, seed):
    """Phase 17 on the 4 gloo ranks (the kernels' counts set to 0 first):
    (a) kimi-k2 on DA_MESH at batch 1 x DA_SEQ (FSDP, the tensor cut and
    the sequence cut at once); (b) the Mamba configs on DA_MAMBA_MESH at
    batch 1 x DA_SEQ (the sequence cut over 4); (c) phase 16 (b)'s
    deepseek run again with fsdp=True.  Returns each part's figures, its
    seconds and the kernels' launches."""
    zero_kernel_launches()
    dp.barrier()
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["a"] = ma_train(torch, dp, seed, da_kimi_config(), DA_MESH, DA_SEQ,
                        1, DA_STEPS)
    out["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = {arch: ma_train(torch, dp, seed, da_mamba_config(arch, n),
                               DA_MAMBA_MESH, DA_SEQ, 1, DA_STEPS)
                for arch, n in DA_MAMBA}
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["c"] = ma_train(torch, dp, seed, moe_config().scaled(fsdp=True),
                        MA_MESH, MOE_SEQ, MOE_BATCH, MOE_STEPS)
    out["c_s"] = time.perf_counter() - t0
    out["launches"] = kernel_launches()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _rel_gaps(got, history, rtol, what):
    gaps = []
    for i, h in enumerate(history):
        for k, key in (("losses", "loss"), ("grad_norms", "grad_norm")):
            gap = abs(got[k][i] - h[key]) / abs(h[key])
            check(gap <= rtol, f"{what}: step {i} {key} {got[k][i]} "
                  f"against {h[key]}")
            gaps.append(gap)
    return max(gaps)


def _per_step(stats, steps):
    return {k: v / steps for k, v in sorted(stats.items())}


def data_axis_report(gl, ref):
    """Phase 17's lines: (a) against one process, each rank's held bytes,
    peak and data-group traffic; (b) each Mamba config against one
    process; (c) against phase 16 (b), the kept slots equal."""
    da = [x["data_axis"] for x in gl]
    out = {"phase_s": max(x["phase_s"] for x in da)}
    a = [x["a"] for x in da]
    for r, x in enumerate(a):
        check(x["losses"] == a[0]["losses"], f"17a: rank {r}'s losses "
              f"differ")
    gap = _rel_gaps(a[0], ref["a"]["history"], DA_RTOL_BF16, "17a")
    whole = 2 * ref["a"]["n"]
    held = [x["param_bytes"] for x in a]
    check(max(held) < whole // 2, f"17a: {held} B held a rank against "
          f"{whole} whole")
    moved = _per_step(a[0]["data_bytes"], DA_STEPS)
    log(f"ranks-data: (a) {DA_ARCH} full width on its dense layer 0 "
        f"({ref['a']['n']} parameters, bf16, fsdp), batch 1 x {DA_SEQ} on "
        f"(2 data x 2 model) gloo ranks, the sequence cut over data: losses "
        f"{a[0]['losses']} grad norms {a[0]['grad_norms']}, within "
        f"{gap:.3e} (relative) of one process "
        f"({[h['loss'] for h in ref['a']['history']]}, {ref['a']['s']:.2f} "
        f"s, peak {ref['a']['peak']} B); parameter bytes a rank {held} "
        f"against the whole's {whole}; m bytes a rank "
        f"{[x['m_bytes'] for x in a]}; peak a rank "
        f"{[x['peak_bytes'] for x in a]} B; the data group's bytes a step "
        f"{moved} (calls {_per_step(a[0]['data_calls'], DA_STEPS)}); "
        f"seconds a step {step_seconds(a[0]['wall_s'])}")
    out["a"] = dict(losses=a[0]["losses"], grad_norms=a[0]["grad_norms"],
                    max_rel_gap=gap, param_bytes=held, whole_bytes=whole,
                    m_bytes=[x["m_bytes"] for x in a],
                    peak_bytes=[x["peak_bytes"] for x in a],
                    one_peak=ref["a"]["peak"], data_bytes_step=moved,
                    step_s=step_seconds(a[0]["wall_s"]))
    out["b"] = {}
    for arch, n in DA_MAMBA:
        b = [x["b"][arch] for x in da]
        for r, x in enumerate(b):
            check(x["losses"] == b[0]["losses"], f"17b {arch}: rank {r}'s "
                  f"losses differ")
        gap = _rel_gaps(b[0], ref[arch]["history"], DA_RTOL, f"17b {arch}")
        log(f"ranks-data: (b) {arch} full width on {n} layers "
            f"({ref[arch]['n']} parameters, float32, TF32 off), batch 1 x "
            f"{DA_SEQ}, the sequence cut over 4 gloo ranks (4 data x 1 "
            f"model): losses {b[0]['losses']} grad norms "
            f"{b[0]['grad_norms']}, within {gap:.3e} of one process "
            f"({ref[arch]['s']:.2f} s, peak {ref[arch]['peak']} B); peak a "
            f"rank {[x['peak_bytes'] for x in b]} B; seconds a step "
            f"{step_seconds(b[0]['wall_s'])}; the data group's calls a step "
            f"{_per_step(b[0]['data_calls'], DA_STEPS)}")
        out["b"][arch] = dict(losses=b[0]["losses"], max_rel_gap=gap,
                              peak_bytes=[x["peak_bytes"] for x in b],
                              one_peak=ref[arch]["peak"],
                              step_s=step_seconds(b[0]["wall_s"]))
    c = [x["c"] for x in da]
    plain = [x["model_axis"]["b"] for x in gl]
    gap = max(_rel_gaps(x, [dict(loss=l, grad_norm=g) for l, g in
                            zip(y["losses"], y["grad_norms"])],
                        DA_FSDP_RTOL, "17c")
              for x, y in zip(c, plain))
    by = {x["coords"]: x["kept"] for x in c}
    kept = [sum(by[(d, 0)][i] for d in range(MA_MESH["data"]))
            for i in range(len(by[(0, 0)]))]
    by16 = {x["coords"]: x["kept"] for x in plain}
    kept16 = [sum(by16[(d, 0)][i] for d in range(MA_MESH["data"]))
              for i in range(len(by16[(0, 0)]))]
    check(kept == kept16, f"17c: kept slots {kept} against 16 (b)'s "
          f"{kept16}")
    held = [x["param_bytes"] for x in c]
    held16 = [x["param_bytes"] for x in plain]
    check(max(held) < min(held16), f"17c: {held} B a rank against 16 (b)'s "
          f"{held16}")
    log(f"ranks-data: (c) {MOE_ARCH} on {MOE_LAYERS} layers (float32) with "
        f"fsdp=True, batch {MOE_BATCH} x {MOE_SEQ}, {MOE_STEPS} steps on (2 "
        f"data x 2 model): losses {c[0]['losses']}, within {gap:.3e} of phase "
        f"16 (b)'s; kept slots a plan {kept} equal to 16 (b)'s; parameter "
        f"bytes a rank {held} against 16 (b)'s {held16}; peak a rank "
        f"{[x['peak_bytes'] for x in c]} B; seconds a step "
        f"{step_seconds(c[0]['wall_s'])}; the data group's bytes a step "
        f"{_per_step(c[0]['data_bytes'], MOE_STEPS)}")
    out["c"] = dict(losses=c[0]["losses"], max_rel_gap=gap, kept=kept,
                    param_bytes=held, param_bytes_16b=held16,
                    peak_bytes=[x["peak_bytes"] for x in c],
                    step_s=step_seconds(c[0]["wall_s"]))
    out["parts_s"] = {k: da[0][f"{k}_s"] for k in ("a", "b", "c")}
    counts = [x["launches"] for x in da]
    launches = {k: sum(c_[k] for c_ in counts) for k in counts[0]}
    log(f"ranks-data: phase 17 in {out['phase_s']:.1f} s (parts "
        f"{json.dumps(out['parts_s'])}); launches {launches}")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 18: the store on int64 keys (the JAX package's x64 deployment)
# ---------------------------------------------------------------------------
K64_UNIVERSE = 2 ** 62            # keys drawn from [0, 2^62)
K64_SPAN = 2 ** 47                # a SCAN's span is below it: 2^47 holds
#                                   about 256 of the 2^23 keys
K64_DEGRADED_ROUNDS = 2
K64_KERNELS = ("hash_probe_i64", "sorted_search_i64", "merge_i64",
               "backup_probe_i64")
K64_LAYERS = 2                    # the engine's falcon-mamba-7b, 2 of 64


def keys64(torch, args, cfg):
    """Phase 18: HiStoreClient(LocalBackend(2**24, cfg, key_dtype=int64))
    on the card, ``args.keys`` distinct keys from [0, 2**62) (a generator
    of its own), the main path's mixed rounds, a pending window of 2
    chunks, the primary's failure with a degraded read-back and degraded
    rounds, the online rebuild and a read-back, every answer checked
    against a sorted-array model; the launch counts set to 0 before it
    and the four int64 entries' > 0 after, the int32 ones' 0.  Then each
    int64 kernel against its plain version on the loaded state.  Returns
    (the four kernel records, timings)."""
    from repro_torch.core.client import HiStoreClient, LocalBackend
    from repro_torch.kernels import ops

    rng = np.random.default_rng([args.seed, 18])
    B = CHUNK
    n_load = args.keys
    n_fresh = (ROUNDS + K64_DEGRADED_ROUNDS) * B // 2 + B
    need = n_load + n_fresh
    uniq = np.unique(rng.integers(0, K64_UNIVERSE, int(need * 1.001) + 1024,
                                  dtype=np.int64))
    check(len(uniq) >= need, "18: not enough distinct keys drawn")
    keys_all = uniq[rng.permutation(len(uniq))[:need]]
    model = Model(keys_all, cfg.value_words)
    t_phase = time.perf_counter()
    client = HiStoreClient(LocalBackend(CAPACITY, cfg, device="cuda",
                                        key_dtype=torch.int64))
    backend = client.backend
    wl = Workload(torch, client, model, rng, keys_all[n_load:],
                  key_hi=K64_UNIVERSE, scan_span=K64_SPAN)
    zero_launches(ops)
    t0 = time.perf_counter()
    vals = wl.new_vals(n_load)
    r = client.put(keys_all[:n_load], vals)
    check(bool(r.ok.all()), "18: load not acknowledged")
    model.put(keys_all[:n_load], vals)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = mixed_rounds(wl, ROUNDS, "18 round")
    torch.cuda.synchronize()
    t_mixed = time.perf_counter() - t0
    _, t_read = wl.read_back("18 read-back")
    log(f"keys64: LocalBackend({CAPACITY}, key_dtype=torch.int64) loaded "
        f"{n_load} keys from [0, 2^62) in {t_load:.3f} s ({n_load / t_load:.0f}"
        f" PUT/s); {ROUNDS} mixed rounds in {t_mixed:.3f} s: {stats}; read "
        f"back {len(model.keys)} keys in {t_read:.3f} s "
        f"({len(model.keys) / t_read:.0f} GET/s)")

    # the primary fails with 2 chunks pending; degraded reads and rounds
    client.drain()
    window = np.concatenate([wl.sample(wl.live_keys(), B // 2),
                             wl.take_fresh(B // 2),
                             wl.sample(wl.live_keys(), B // 2),
                             wl.take_fresh(B // 2)])
    wl.put(window[:B], "18 window chunk 0")
    wl.put(window[B:], "18 window chunk 1")
    client.fail_server(0)
    failed = backend.group
    _, t_deg = wl.read_back("18 degraded read-back")
    t0 = time.perf_counter()
    degraded_rounds(wl, K64_DEGRADED_ROUNDS, "18 degraded round")
    torch.cuda.synchronize()
    t_rounds = time.perf_counter() - t0
    t0 = time.perf_counter()
    client.recover_server(0)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    hits, t_read0 = wl.read_back("18 read-back after the rebuild")
    launches = dict(ops.LAUNCHES)
    t_path = time.perf_counter() - t_phase
    log(f"keys64: primary failed with 2 chunks pending; degraded read-back "
        f"of {len(model.keys)} keys in {t_deg:.3f} s "
        f"({len(model.keys) / t_deg:.0f} GET/s); {K64_DEGRADED_ROUNDS} "
        f"degraded rounds in {t_rounds:.3f} s; rebuilt online in "
        f"{t_rec:.3f} s; read back {len(model.keys)} keys ({hits} live) in "
        f"{t_read0:.3f} s; the path {t_path:.1f} s; launches {launches}")
    for k in K64_KERNELS:
        check(launches[k] > 0, f"18: kernel {k} was not launched")
        check(launches[k[:-4]] == 0, f"18: the int32 {k[:-4]} was launched")

    # each int64 kernel against its plain version on the loaded state
    g = backend.group
    recs = compare_kernels(torch, cfg, g.hash, g.sorted[0],
                           model.keys[model.live], model.keys[~model.live],
                           rng, CHUNK, "keys64", key_hi=K64_UNIVERSE)
    recs.append(compare_backup_probe(torch, wl, cfg, failed, window,
                                     launches))
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
    times = dict(load_s=t_load, put_per_s=n_load / t_load,
                 mixed_rounds_s=t_mixed, read_back_s=t_read,
                 get_per_s=len(model.keys) / t_read,
                 degraded_read_s=t_deg, degraded_rounds_s=t_rounds,
                 recover_primary_s=t_rec, path_s=t_path)
    return recs, times


def keys64_engine(torch, seed):
    """Phase 18's engine: falcon-mamba-7b at full width on K64_LAYERS
    layers (bf16, weights drawn on the card from ``seed``), a
    ServingEngine with int32 keys and one with int64 keys over the same
    requests, each launch count set to 0 before it: the int64 engine's
    stats and tokens equal the int32 one's, its directory launched only
    int64 entries and holds keys past the int32 range.  Returns
    timings."""
    from repro_torch.configs import get_config
    from repro_torch.core import sorted_index as six
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(SERVE_ARCH).scaled(ssm_impl="pallas",
                                        n_layers=K64_LAYERS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = tr.init_params(cfg, gen, device=dev)
    first, again = prompt_set(np.random.default_rng([seed, 18]),
                              cfg.vocab_size)
    runs = {}
    for kd in (torch.int32, torch.int64):
        e = ServingEngine(cfg, model, batch_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                          device=dev, key_dtype=kd)
        zero_launches(ops)
        reqs, _, t_eng, _ = drive_engine(torch, e, first, again)
        launches = dict(ops.LAUNCHES)
        check_engine(e, reqs, f"18 engine {kd}")
        e.client.drain()
        keys, _, valid = six.items(e.directory.sorted[0])
        runs[kd] = dict(stats=dict(e.stats), s=t_eng, launches=launches,
                        tokens=[list(r.tokens) for r in reqs],
                        top_key=int(keys[valid].max()))
    a, b = runs[torch.int32], runs[torch.int64]
    check(a["stats"] == b["stats"], f"18 engine: stats {b['stats']} against "
          f"the int32 engine's {a['stats']}")
    check(a["tokens"] == b["tokens"], "18 engine: tokens differ")
    check(b["top_key"] >= 2 ** 31, f"18 engine: its top key {b['top_key']}")
    for k in ("hash_probe", "sorted_search", "merge"):
        check(a["launches"][k] > 0 and a["launches"][k + "_i64"] == 0
              and b["launches"][k + "_i64"] > 0 and b["launches"][k] == 0,
              f"18 engine: {k} launches {a['launches']} {b['launches']}")
    log(f"keys64: ServingEngine({SERVE_SLOTS} slots, max_len "
        f"{SERVE_MAX_LEN}, page {SERVE_PAGE}) on {SERVE_ARCH} at {K64_LAYERS} "
        f"layers, int32 keys {a['s']:.3f} s and int64 keys {b['s']:.3f} s "
        f"over the same {len(a['tokens'])} requests: stats equal "
        f"({json.dumps(b['stats'])}), tokens equal, the int64 directory's "
        f"top key {b['top_key']} (page bits 20, prefix modulus 2^40); "
        f"launches {({k: v for k, v in b['launches'].items() if v})}")
    return dict(engine_int32_s=a["s"], engine_int64_s=b["s"],
                launches_int64=b["launches"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=1 << 23,
                    help="distinct keys loaded before the mixed rounds")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs.histore import DEFAULT, scaled
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"device: {name}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    _build.build()
    log(f"build: {_build.BUILD_INFO['seconds']:.2f} s, compiled "
        f"{_build.BUILD_INFO['compiled']} into {_build.BUILD_INFO['dir']}")

    cfg = DEFAULT
    log(f"config: {cfg}")
    rng = np.random.default_rng(args.seed)
    wl, launches = main_path(torch, args, cfg, rng)
    m = wl.model
    kernels = compare_kernels(
        torch, cfg, wl.client.backend.group.hash,
        wl.client.backend.group.sorted[0], m.keys[m.live], m.keys[~m.live],
        rng, CHUNK, "main")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    dispatch, merge_big = dispatch_path(torch, cfg, wl, rng)
    kernels[2]["batch_65536"] = merge_big
    group, window, fr_launches, times = fail_recover(torch, wl, cfg)
    log(f"fail: {json.dumps(times)}")
    kernels.append(compare_backup_probe(torch, wl, cfg, group, window,
                                        fr_launches))
    del wl, group                    # the single-node store leaves the card
    torch.cuda.empty_cache()
    dist_cfg = scaled(lease_misses=0)
    log(f"dist config: {dist_cfg}")
    dwl, d_launches, d_times, probe_at = distributed(torch, dist_cfg, rng)
    log(f"dist: {json.dumps(d_times)}")
    for k, dk in zip(kernels, dist_kernels(torch, dwl, dist_cfg)):
        k["max_abs_err"] = max(k["max_abs_err"], dk["max_abs_err"])
        k["distributed_shapes"] = {
            x: v for x, v in dk.items()
            if x not in ("name", "route", "source", "replaces")}
    err, stacked = compare_range_stacked(torch, dwl, dist_cfg)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err)
    kernels[1]["distributed_stacked"] = stacked
    kernels.append(compare_group_probe(torch, dwl, dist_cfg, d_launches,
                                       probe_at))
    kernels.extend(dispatch)
    del dwl, probe_at               # the distributed store leaves the card
    torch.cuda.empty_cache()
    log(f"dist-faults config: {cfg}")
    f_launches, f_times, err, degraded = dist_faults(torch, cfg, rng)
    log(f"dist-faults: {json.dumps(f_times)}")
    gp_rec = next(k for k in kernels if k["name"] == "group_probe")
    gp_rec["max_abs_err"] = max(gp_rec["max_abs_err"], err)
    gp_rec["degraded"] = degraded
    torch.cuda.empty_cache()
    rank_times, rank_launches, rank_f_launches = dist_ranks(torch,
                                                            args.seed)
    log(f"ranks: {json.dumps(rank_times)}")
    torch.cuda.empty_cache()
    scan_rec, s_times, s_launches = serving(torch, args.seed)
    log(f"serve: {json.dumps(s_times)}")
    for k in kernels:
        k["launches_fail_recover"] = fr_launches[k["name"]]
        k["launches_distributed"] = d_launches[k["name"]]
        k["launches_dist_faults"] = f_launches[k["name"]]
        k["launches_dist_ranks"] = rank_launches[k["name"]]
        k["launches_dist_ranks_faults"] = rank_f_launches[k["name"]]
        k["launches_serving"] = s_launches[k["name"]]
    scan_rec["launches_dist_faults"] = f_launches["mamba_scan"]
    scan_rec["launches_dist_ranks"] = rank_launches["mamba_scan"]
    scan_rec["launches_dist_ranks_faults"] = rank_f_launches["mamba_scan"]
    kernels.append(scan_rec)
    torch.cuda.empty_cache()
    dense_times, dense_launches = dense_serving(torch, args.seed)
    log(f"dense: {json.dumps(dense_times)}")
    for k in kernels:
        k["launches_serving_dense"] = dense_launches[k["name"]]
    torch.cuda.empty_cache()
    fam_times, hyb_launches, moe_launches = family_serving(torch, args.seed)
    log(f"families: {json.dumps(fam_times)}")
    for k in kernels:
        k["launches_serving_hybrid"] = hyb_launches[k["name"]]
        k["launches_serving_moe"] = moe_launches[k["name"]]
    torch.cuda.empty_cache()
    train_times, train_launches = training(torch, args.seed)
    log(f"training: {json.dumps(train_times)}")
    for k in kernels:
        k["launches_training"] = train_launches[k["name"]]
    torch.cuda.empty_cache()
    tool_times, tool_launches = tools(torch, args.seed, train_times["full"])
    log(f"tools: {json.dumps(tool_times)}")
    for k in kernels:
        k["launches_tools"] = tool_launches[k["name"]]
    torch.cuda.empty_cache()
    (rank_train_times, rank_train_launches, model_axis_times,
     model_axis_launches, data_axis_times,
     data_axis_launches) = training_ranks(torch, args.seed,
                                          train_times["full"])
    log(f"ranks-train: {json.dumps(rank_train_times)}")
    log(f"ranks-model: {json.dumps(model_axis_times)}")
    log(f"ranks-data: {json.dumps(data_axis_times)}")
    for k in kernels:
        k["launches_training_ranks"] = rank_train_launches[k["name"]]
        k["launches_model_axis"] = model_axis_launches[k["name"]]
        k["launches_data_axis"] = data_axis_launches[k["name"]]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs64, k64_times = keys64(torch, args, cfg)
    k64_times.update(keys64_engine(torch, args.seed))
    k64_times["phase_s"] = time.perf_counter() - t0
    by_name = {k["name"]: k for k in kernels}
    for rec in recs64:
        base = by_name[rec["name"][:-len("_i64")]]
        for x in ("ms", "device_ms", "bound_ms"):
            rec["int32_" + x] = base[x]
        log(f"keys64: {rec['name']}: {rec['ms']:.4f} ms per call, device "
            f"{rec['device_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms at 8 "
            f"B keys; the int32 entry in this run {base['ms']:.4f} ms, device "
            f"{base['device_ms']:.4f} ms, bound {base['bound_ms']:.6f} ms")
    kernels.extend(recs64)
    log(f"keys64: {json.dumps(k64_times)}")
    torch.cuda.synchronize()
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
